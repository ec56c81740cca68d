"""htslib_tpu_torch: the device layer of htslib_tpu in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (H100).

A port beside the JAX package, which stays the reference: each function
here takes the inputs of its JAX counterpart (same module path under
htslib_tpu/) and returns the same bytes and counts.  The port imports
torch, numpy and the standard library, never jax or htslib_tpu; the host
modules it needs are its own copies (codecs/, cram/, sam/ with
sam/indexing.py, sam/samtext.py, sam/fastq.py, sam/mods.py,
sam/batch.py and sam/hts_open.py, vcf/ with vcf/merge.py, bgzf.py,
faidx.py, format.py, hfile.py and remote/, hts.py, opts.py, pipeline.py,
hts_expr.py, index.py, tbx.py, regidx.py, util/log.py, pileup.py with
parallel/pileup_shard.py, errmod.py, kfunc.py, synced_reader.py,
vcfutils.py, vcf_sweep.py).

Entry points run on the card (`device="cuda"`) and raise when there is
none, unless the caller passes `device="cpu"`, which runs each kernel's
plain PyTorch version.  Kernels are built from csrc/ by nvcc at first use
(_build.py).
"""
