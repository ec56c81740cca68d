"""Generic open, the htsFile facade (the port's copy of htslib_tpu/hts.py;
reference hts_open, hts.c:891; dispatch switch hts.c:1571-1607).

``hts_open(name, mode)`` auto-detects and returns the right reader
(SAM/BAM/CRAM/VCF/BCF/FASTA/FASTQ/BGZF text) or constructs a writer from
mode letters as in the reference's mode-string scheme
(htslib/hts.h:588-613): [rwa] + b(am)/c(ram)/v? + z/u + 0-9.
"""
from __future__ import annotations

from typing import Optional

from htslib_tpu_torch.format import Category, Format, detect_format
from htslib_tpu_torch.hfile import hopen


def hts_open(name: str, mode: str = "r", header=None,
             ref: Optional[str] = None, opts=None):
    """opts: iterable of ``key[=value]`` strings (hts_opt_add grammar) or
    a pre-parsed option list; applied to the constructed reader/writer
    (hts_process_opts, hts.c:1407)."""
    obj = _hts_open(name, mode, header, ref)
    if opts:
        from htslib_tpu_torch.opts import hts_opt_add, hts_opt_apply
        if isinstance(opts, (list, tuple)) and opts and isinstance(opts[0], str):
            parsed = []
            for o in opts:
                hts_opt_add(parsed, o)
        else:
            parsed = list(opts)
        hts_opt_apply(obj, parsed)
    return obj


def _hts_open(name: str, mode: str, header, ref: Optional[str]):
    if "r" in mode:
        fp = hopen(name, "rb")
        fmt = detect_format(fp.peek(1 << 16))
        if fmt.format == Format.hts_crypt4gh_format:
            # hts_crypt4gh_redirect (hts.c:1430): re-dispatch through a
            # plugin-provided decrypting byte stream (HTS_PATH plugin
            # registering the "crypt4gh" scheme)
            from htslib_tpu_torch.hfile import _scheme_handlers, _load_remote_handlers
            _load_remote_handlers()
            handler = _scheme_handlers.get("crypt4gh")
            if handler is None:
                raise IOError(
                    "crypt4gh input but no crypt4gh scheme plugin is "
                    "registered (set HTS_PATH)")
            fp.close()
            fp = handler("crypt4gh:" + name, "rb")
            fmt = detect_format(fp.peek(1 << 16))
        if fmt.category == Category.VARIANT_DATA:
            from htslib_tpu_torch.vcf.io import BcfReader, VcfReader
            return BcfReader(fp) if fmt.format == Format.bcf else VcfReader(fp)
        if fmt.format == Format.bam:
            from htslib_tpu_torch.sam.bam import BamReader
            return BamReader(fp)
        if fmt.format == Format.cram:
            from htslib_tpu_torch.cram import CramReader
            return CramReader(fp, ref=ref)
        if fmt.format in (Format.fasta_format, Format.fastq_format):
            from htslib_tpu_torch.sam.fastq import FastxReader
            return FastxReader(fp, fasta=fmt.format == Format.fasta_format)
        from htslib_tpu_torch.sam.samtext import SamReader
        return SamReader(fp)
    # writer dispatch on mode letters
    from htslib_tpu_torch.vcf.header import BcfHeader
    if isinstance(header, BcfHeader):
        from htslib_tpu_torch.vcf.io import open_vcf
        return open_vcf(name, mode, header)
    from htslib_tpu_torch.sam.hts_open import hts_open_sam
    return hts_open_sam(name, mode, header, ref=ref)
