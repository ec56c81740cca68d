"""Unified open for sequence files (the port's copy of
htslib_tpu/sam/hts_open.py; hts_open dispatch, hts.c:891/1571).

``hts_open_sam(name, mode)`` returns a reader or writer for SAM/BAM/CRAM
based on format detection (read) or mode letters (write):
  r      auto-detect
  w      SAM text        wb    BAM        wc    CRAM
  wz     bgzf SAM        w0-9  compression level
"""
from __future__ import annotations

from typing import Optional

from htslib_tpu_torch.format import Format, detect_format
from htslib_tpu_torch.hfile import hopen
from htslib_tpu_torch.sam.bam import BamReader, BamWriter
from htslib_tpu_torch.sam.header import SamHeader
from htslib_tpu_torch.sam.samtext import SamReader, SamWriter


def hts_open_sam(name: str, mode: str = "r", header: Optional[SamHeader] = None,
                 ref: Optional[str] = None):
    if "r" in mode:
        fp = hopen(name, "rb")
        fmt = detect_format(fp.peek(1 << 16))
        if fmt.format == Format.bam:
            return BamReader(fp)
        if fmt.format == Format.cram:
            from htslib_tpu_torch.cram import CramReader
            return CramReader(fp, ref=ref)
        if fmt.format in (Format.sam, Format.text_format, Format.empty_format):
            return SamReader(fp)
        if fmt.format in (Format.fastq_format, Format.fasta_format):
            from htslib_tpu_torch.sam.fastq import FastxReader
            return FastxReader(fp, fasta=fmt.format == Format.fasta_format)
        raise IOError(f"cannot read {name}: not sequence data ({fmt.description()})")
    if header is None:
        raise ValueError("writing requires a header")
    level = -1
    for ch in mode:
        if ch.isdigit():
            level = int(ch)
    if "b" in mode:
        return BamWriter(name, header, level=level)
    if "c" in mode:
        from htslib_tpu_torch.cram import CramWriter
        return CramWriter(name, header, ref=ref)
    return SamWriter(name, header, compress="z" in mode, level=level)
