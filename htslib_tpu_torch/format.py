"""File-format detection and description.

Equivalent of the reference's htsFormat / hts_detect_format2 machinery
(hts.c:556-890): peek leading bytes, recognise magic numbers, and for
gzip/bgzf streams decompress a small prefix to identify the inner format
(decompress_peek_gz, hts.c:314).

Categories and enum values mirror htslib/hts.h:134-200 so that mode
dispatch and user code can be written against familiar names.

The port's copy of htslib_tpu/format.py: `detect_format` over leading
bytes (the whole classifier, so that it refuses what the JAX function
refuses), and `detect_format_file` / `detect_format_hfile` over a name
that hfile.py `hopen` opens or an open `HFile`, which hts.py and
vcf/io.py `open_vcf` dispatch on.
"""
from __future__ import annotations

import enum
import re
import zlib
from dataclasses import dataclass, field
from typing import Optional

from htslib_tpu_torch.hfile import HFile, hopen


class Category(enum.Enum):
    UNKNOWN_CATEGORY = 0
    SEQUENCE_DATA = 1    # sequencing reads: SAM/BAM/CRAM/FASTA/FASTQ
    VARIANT_DATA = 2     # VCF/BCF
    INDEX_FILE = 3       # BAI/CSI/TBI/CRAI/FAI/GZI
    REGION_LIST = 4      # BED
    CATEGORY_MAXIMUM = 32767


class Format(enum.Enum):
    unknown_format = 0
    binary_format = 1
    text_format = 2
    sam = 3
    bam = 4
    bai = 5
    cram = 6
    crai = 7
    vcf = 8
    bcf = 9
    csi = 10
    gzi = 11
    tbi = 12
    bed = 13
    htsget = 14
    json = 14  # alias (reference hts.h:156)
    empty_format = 15
    fasta_format = 16
    fastq_format = 17
    fai_format = 18
    fqi_format = 19
    hts_crypt4gh_format = 20
    d4_format = 21
    format_maximum = 32767


class Compression(enum.Enum):
    no_compression = 0
    gzip = 1
    bgzf = 2
    custom = 3
    bzip2_compression = 4
    razf_compression = 5
    xz_compression = 6
    zstd_compression = 7
    compression_maximum = 32767


@dataclass
class HtsFormat:
    """Mirror of htsFormat (htslib/hts.h:224-233)."""
    category: Category = Category.UNKNOWN_CATEGORY
    format: Format = Format.unknown_format
    version_major: int = 0
    version_minor: int = 0
    compression: Compression = Compression.no_compression
    compression_level: int = -1
    options: dict = field(default_factory=dict)

    def description(self) -> str:
        """Human-readable like hts_format_description (hts.c:840-890)."""
        parts = []
        name = {
            Format.sam: "SAM", Format.bam: "BAM", Format.cram: "CRAM",
            Format.vcf: "VCF", Format.bcf: "BCF", Format.bai: "BAI",
            Format.crai: "CRAI", Format.csi: "CSI", Format.gzi: "GZI",
            Format.tbi: "Tabix", Format.bed: "BED",
            Format.fasta_format: "FASTA", Format.fastq_format: "FASTQ",
            Format.fai_format: "FASTA-IDX", Format.fqi_format: "FASTQ-IDX",
            Format.empty_format: "empty", Format.htsget: "htsget",
            Format.hts_crypt4gh_format: "crypt4gh", Format.d4_format: "D4",
        }.get(self.format)
        if name:
            parts.append(name)
        elif self.format == Format.text_format:
            parts.append("unknown text")
        elif self.format == Format.binary_format:
            parts.append("unknown binary")
        else:
            parts.append("unknown")
        if self.version_major > 0:
            v = f"version {self.version_major}"
            if self.version_minor >= 0:
                v += f".{self.version_minor}"
            parts.append(v)
        if self.compression == Compression.bgzf:
            parts.append("BGZF-compressed")
        elif self.compression == Compression.gzip:
            parts.append("gzip-compressed")
        elif self.compression == Compression.bzip2_compression:
            parts.append("bzip2-compressed")
        elif self.compression == Compression.xz_compression:
            parts.append("xz-compressed")
        elif self.compression == Compression.zstd_compression:
            parts.append("zstd-compressed")
        cat = {
            Category.SEQUENCE_DATA: "sequence data",
            Category.VARIANT_DATA: "variant calling data",
            Category.INDEX_FILE: "index file",
            Category.REGION_LIST: "genomic region data",
        }.get(self.category, "data")
        return " ".join(parts[:1] + parts[1:]) + " " + cat


def _is_bgzf_header(b: bytes) -> bool:
    """BGZF magic: gzip with FEXTRA and a 'BC' subfield (bgzf.c check,
    also hts.c:573-585)."""
    if len(b) < 18:
        return False
    if b[0] != 0x1F or b[1] != 0x8B or not (b[3] & 0x04):
        return False
    xlen = b[10] | (b[11] << 8)
    # walk extra subfields looking for BC/2
    pos, end = 12, min(12 + xlen, len(b))
    while pos + 4 <= end:
        si1, si2 = b[pos], b[pos + 1]
        slen = b[pos + 2] | (b[pos + 3] << 8)
        if si1 == 0x42 and si2 == 0x43 and slen == 2:
            return True
        pos += 4 + slen
    return False


def _decompress_peek_gz(data: bytes, want: int = 4096) -> bytes:
    """Decompress a small prefix of a gzip stream (hts.c:314-377)."""
    try:
        d = zlib.decompressobj(wbits=31)
        return d.decompress(data, want)
    except zlib.error:
        return b""


_SAM_HDR_RE = re.compile(rb"^@(HD|SQ|RG|PG|CO)\t")
_VCF_MAGIC = b"##fileformat=VCF"


def _looks_like_sam_body(text: bytes) -> bool:
    """Heuristic record check like hts.c:489-554 (secondclass columns)."""
    line = text.split(b"\n", 1)[0]
    cols = line.split(b"\t")
    if len(cols) < 11:
        return False
    try:
        flag = int(cols[1]); pos = int(cols[3]); mapq = int(cols[4])
    except ValueError:
        return False
    return 0 <= flag <= 0xFFFF and pos >= 0 and 0 <= mapq <= 255


def _detect_text(data: bytes, fmt: HtsFormat) -> None:
    if data.startswith(_VCF_MAGIC):
        fmt.category, fmt.format = Category.VARIANT_DATA, Format.vcf
        m = re.match(rb"##fileformat=VCFv(\d+)\.(\d+)", data)
        if m:
            fmt.version_major, fmt.version_minor = int(m.group(1)), int(m.group(2))
        return
    if data.startswith(b"##FASTA") :
        fmt.category, fmt.format = Category.SEQUENCE_DATA, Format.fasta_format
        return
    if _SAM_HDR_RE.match(data):
        fmt.category, fmt.format = Category.SEQUENCE_DATA, Format.sam
        fmt.version_major, fmt.version_minor = 1, -1
        return
    if data.startswith(b">"):
        fmt.category, fmt.format = Category.SEQUENCE_DATA, Format.fasta_format
        return
    if data.startswith(b"@") and not _SAM_HDR_RE.match(data):
        # FASTQ vs headerless SAM: FASTQ 2nd line is sequence letters
        lines = data.split(b"\n")
        if len(lines) >= 2 and re.fullmatch(rb"[A-Za-z=.*]*", lines[1] or b"X"):
            if len(lines) >= 3 and lines[2][:1] == b"+":
                fmt.category, fmt.format = Category.SEQUENCE_DATA, Format.fastq_format
                return
            fmt.category, fmt.format = Category.SEQUENCE_DATA, Format.fastq_format
            return
    if _looks_like_sam_body(data):
        fmt.category, fmt.format = Category.SEQUENCE_DATA, Format.sam
        fmt.version_major, fmt.version_minor = 1, -1
        return
    # FAI: name <tab> 5 ints? (fai: 5 cols, fqi: 6 cols)
    line = data.split(b"\n", 1)[0]
    cols = line.split(b"\t")
    if len(cols) in (5, 6):
        try:
            [int(c) for c in cols[1:]]
            fmt.category = Category.INDEX_FILE
            fmt.format = Format.fai_format if len(cols) == 5 else Format.fqi_format
            return
        except ValueError:
            pass
    if len(cols) >= 3 and cols and not data.startswith(b"#"):
        try:
            int(cols[1]); int(cols[2])
            fmt.category, fmt.format = Category.REGION_LIST, Format.bed
            return
        except (ValueError, IndexError):
            pass
    fmt.format = Format.text_format


def detect_format(data: bytes) -> HtsFormat:
    """Classify leading bytes of a stream (hts_detect_format2, hts.c:556)."""
    fmt = HtsFormat()
    if len(data) == 0:
        fmt.format = Format.empty_format
        return fmt

    compressed_prefix: Optional[bytes] = None
    if len(data) >= 2 and data[0] == 0x1F and data[1] == 0x8B:
        fmt.compression = Compression.bgzf if _is_bgzf_header(data) else Compression.gzip
        compressed_prefix = _decompress_peek_gz(data)
        inner = compressed_prefix
    elif data.startswith(b"BZh"):
        fmt.compression = Compression.bzip2_compression
        fmt.format = Format.binary_format
        return fmt
    elif data.startswith(b"\xfd7zXZ\x00"):
        fmt.compression = Compression.xz_compression
        fmt.format = Format.binary_format
        return fmt
    elif data.startswith(b"\x28\xb5\x2f\xfd"):
        fmt.compression = Compression.zstd_compression
        fmt.format = Format.binary_format
        return fmt
    else:
        inner = data

    if inner.startswith(b"BAM\x01"):
        fmt.category, fmt.format = Category.SEQUENCE_DATA, Format.bam
        fmt.version_major, fmt.version_minor = 1, -1
        return fmt
    if inner.startswith(b"BAI\x01"):
        fmt.category, fmt.format = Category.INDEX_FILE, Format.bai
        return fmt
    if inner.startswith(b"BCF\x04"):
        # legacy BCF1
        fmt.category, fmt.format = Category.VARIANT_DATA, Format.bcf
        fmt.version_major, fmt.version_minor = 1, -1
        return fmt
    if inner.startswith(b"BCF\x02"):
        fmt.category, fmt.format = Category.VARIANT_DATA, Format.bcf
        fmt.version_major = 2
        fmt.version_minor = inner[4] if len(inner) > 4 else -1
        return fmt
    if inner.startswith(b"CSI\x01"):
        fmt.category, fmt.format = Category.INDEX_FILE, Format.csi
        return fmt
    if inner.startswith(b"TBI\x01"):
        fmt.category, fmt.format = Category.INDEX_FILE, Format.tbi
        return fmt
    if data.startswith(b"CRAM") and len(data) >= 6:
        fmt.category, fmt.format = Category.SEQUENCE_DATA, Format.cram
        fmt.version_major, fmt.version_minor = data[4], data[5]
        return fmt
    if data.startswith(b"crypt4gh"):
        fmt.format = Format.hts_crypt4gh_format
        return fmt
    if data.startswith(b"d4\xdd\xdd"):
        fmt.format = Format.d4_format
        return fmt
    # CRAI: gzipped text of 6 tab/; separated ints
    if fmt.compression != Compression.no_compression and compressed_prefix:
        line = compressed_prefix.split(b"\n", 1)[0]
        cols = line.split(b"\t")
        if len(cols) == 6:
            try:
                [int(c) for c in cols]
                fmt.category, fmt.format = Category.INDEX_FILE, Format.crai
                return fmt
            except ValueError:
                pass
        _detect_text(compressed_prefix, fmt)
        return fmt
    if inner.startswith(b"{"):
        fmt.format = Format.json
        return fmt

    # plain text classification
    printable = all(c == 9 or c == 10 or c == 13 or 32 <= c < 127 or c >= 128 for c in inner[:512])
    if printable:
        _detect_text(inner, fmt)
    else:
        fmt.format = Format.binary_format
    return fmt


def detect_format_file(fname: str) -> HtsFormat:
    """The format of the stream that `hopen(fname)` opens, from its
    first 64 KiB."""
    with hopen(fname, "rb") as fp:
        data = fp.peek(1 << 16)
        if not data:
            data = fp.read(1 << 16)
    return detect_format(data)


def detect_format_hfile(fp: HFile) -> HtsFormat:
    """The format of an open stream, from its next 64 KiB, not consumed."""
    return detect_format(fp.peek(1 << 16))
