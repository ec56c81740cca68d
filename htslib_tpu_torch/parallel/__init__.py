"""Scale-out over torch.distributed: the device mesh (mesh.py), BAM and
CRAM shard plans and their per-rank work (distributed.py), and a launcher
of rank processes (launch.py)."""
