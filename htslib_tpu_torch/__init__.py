"""htslib_tpu_torch: the device layer of htslib_tpu in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (H100).

A port beside the JAX package, which stays the reference: each function
here takes the inputs of its JAX counterpart (same module path under
htslib_tpu/) and returns the same bytes and counts.  The port imports
torch, numpy and the standard library, never jax or htslib_tpu; the host
modules it needs are its own copies: codecs/; cram/; sam/ (with
indexing.py, samtext.py, fastq.py, mods.py, batch.py and hts_open.py);
vcf/ (with merge.py); bgzf.py, faidx.py, format.py, hfile.py and
remote/, hts.py, opts.py, pipeline.py, hts_expr.py, index.py, tbx.py,
regidx.py; util/log.py and util/memory.py; pileup.py with
parallel/pileup_shard.py, errmod.py, kfunc.py, synced_reader.py,
vcfutils.py, vcf_sweep.py; realn.py; refcache.py (the reference cache
server, `python -m htslib_tpu_torch.refcache`); cli/ (bgzip, tabix,
htsfile and annot_tsv, each `python -m htslib_tpu_torch.cli.<tool>`);
and native/, the C++ host engine (BGZF inflate and deflate, record
scans, SAM/BAM/VCF/BCF formatting and parsing, mpileup, CRAM slice
decode and encode, the CRAM 3.1 codecs), which the host modules call
where the JAX package calls its own, unless `htslib_tpu_torch.native.
native` is set to None.

Entry points run on the card (`device="cuda"`) and raise when there is
none, unless the caller passes `device="cpu"`, which runs each kernel's
plain PyTorch version.  Kernels are built from csrc/ by nvcc at first use
(_build.py), the native library from native/ by g++ and gcc at first use
(native/__init__.py), both into build/.
"""

__version__ = "0.1.0"

# HTS_VERSION-alike integer for feature tests (major*10^5 + minor*10^3 +
# patch*10), the JAX package's
HTS_VERSION = 100  # 0.1.0

from htslib_tpu_torch.util.log import (  # noqa: F401,E402
    hts_log, hts_set_log_level, hts_get_log_level,
    log_error, log_warning, log_info, log_debug, log_trace,
)


def hts_features() -> int:
    """Build-feature bitmask (hts_features, hts.c:89; the HTS_FEATURE_*
    bits of htslib/hts.h) of what this environment provides: LIBDEFLATE
    (32) where the native library loads (built here where it is not), as
    the JAX package sets it."""
    S3, GCS, LIBDEFLATE, LZMA, BZIP2, HTSCODECS = (8, 16, 32, 64, 128,
                                                   1 << 27)
    feats = S3 | GCS                  # s3/gs signing built in
    try:
        from htslib_tpu_torch.native import native
        if native is not None:
            native.load()
            feats |= LIBDEFLATE
    except (OSError, RuntimeError):     # a library that fails to build
        pass
    try:
        import lzma  # noqa: F401
        feats |= LZMA
    except ImportError:
        pass
    try:
        import bz2  # noqa: F401
        feats |= BZIP2
    except ImportError:
        pass
    return feats | HTSCODECS          # the CRAM codecs in-tree


def hts_feature_string() -> str:
    """Human-readable feature summary (hts_feature_string, hts.c:240)."""
    f = hts_features()

    def yn(bit):
        return "yes" if f & bit else "no"
    return (f"libdeflate={yn(32)} lzma={yn(64)} bzip2={yn(128)} "
            f"s3={yn(8)} gcs={yn(16)} htscodecs={yn(1 << 27)}")
