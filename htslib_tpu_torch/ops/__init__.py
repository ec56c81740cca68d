"""Device operations of the port: plain PyTorch, plus the hand-written
Hopper kernels (csrc/) that replace the JAX package's Pallas kernels."""
