"""The port's copy of htslib_tpu/sam: CIGAR constants, text and lengths,
the SAM header with its lines, the BAM record with its SAM text and aux
CRUD, the BAM container and its index, SAM text, FASTA/FASTQ, base
modifications, the columnar batch formatter with the file-level
BAM <-> SAM entry points (batch.py), and `hts_open_sam`, exported here
as the JAX package does (on first use: index.py and hts_expr.py import
this package's record modules, so it imports nothing eagerly)."""


def __getattr__(name):
    if name == "hts_open_sam":
        from htslib_tpu_torch.sam.hts_open import hts_open_sam
        return hts_open_sam
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
