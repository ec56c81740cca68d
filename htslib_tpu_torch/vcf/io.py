"""VCF/BCF file I/O (reference vcf.c:1349 bcf_hdr_read, :2256 bcf_read,
:2510 bcf_write, :4699 vcf_hdr_read/vcf_read).

The port's copy of htslib_tpu/vcf/io.py, its pure-Python paths (no
native branches), over the port's `BgzfReader` and `BgzfWriter`; a
file is a name that hfile.py `hopen` opens (a path, `-` or a URL) or a
binary file object.
`bcf_file_to_vcf` inflates a BGZF body's members on the device
(bgzf.py `inflate_range`: kernel X4 on the card), then frames and formats
the records on the host.  The CSI index of a BCF is index.py's
`HtsIndex`: `bcf_index_build` writes it from a file, `BcfWriter(
build_index=True)` as it writes, and `BcfReader.fetch` queries it.
"""
from __future__ import annotations

import gzip
import struct
from typing import BinaryIO, Iterator, Optional, Tuple, Union

import numpy as np

from htslib_tpu_torch import _build
from htslib_tpu_torch.bgzf import (BgzfReader, BgzfWriter, inflate_range,
                                   read_file, scan_blocks)
from htslib_tpu_torch.format import Format, detect_format_hfile
from htslib_tpu_torch.hfile import hopen
from htslib_tpu_torch.index import HTS_FMT_CSI, HtsIndex
from htslib_tpu_torch.vcf.header import BcfHeader
from htslib_tpu_torch.vcf.record import BcfRecord

BCF_MAGIC = b"BCF\x02\x02"


class VcfReader:
    """Text VCF (plain/gzip/BGZF)."""

    def __init__(self, src: Union[str, BinaryIO, BgzfReader]):
        self.fp = src if isinstance(src, BgzfReader) else BgzfReader(src)
        lines = []
        self._pending: Optional[bytes] = None
        while True:
            line = self.fp.readline()
            if not line:
                break
            if line.startswith(b"#"):
                lines.append(line.decode("utf-8", "replace").rstrip("\n"))
                if line.startswith(b"#CHROM"):
                    break
            else:
                self._pending = line
                break
        self.header = BcfHeader("\n".join(lines) + "\n" if lines else "")

    def __iter__(self) -> Iterator[BcfRecord]:
        return self

    def __next__(self) -> BcfRecord:
        rec = self.read1()
        if rec is None:
            raise StopIteration
        return rec

    def read1(self) -> Optional[BcfRecord]:
        if self._pending is not None:
            line, self._pending = self._pending, None
        else:
            line = self.fp.readline()
        while line in (b"\n", b"\r\n"):
            line = self.fp.readline()
        if not line:
            return None
        return BcfRecord.from_vcf(line.decode("utf-8"), self.header)

    def tell(self) -> int:
        return self.fp.tell()

    def seek(self, voffset: int) -> None:
        self.fp.seek(voffset)

    def close(self) -> None:
        self.fp.close()

    def __enter__(self):
        return self

    def __exit__(self, *e):
        self.close()


class BcfReader:
    def __init__(self, src: Union[str, BinaryIO, BgzfReader]):
        self.name = src if isinstance(src, str) else getattr(src, "name", "?")
        self.fp = src if isinstance(src, BgzfReader) else BgzfReader(src)
        magic = self.fp.read(5)
        if magic[:3] != b"BCF" or magic[3] != 2:
            raise IOError("invalid BCF2 magic")
        self.minor = magic[4]
        (l_text,) = struct.unpack("<I", self.fp.read(4))
        text = self.fp.read(l_text).rstrip(b"\0").decode("utf-8", "replace")
        self.header = BcfHeader(text)

    def __iter__(self) -> Iterator[BcfRecord]:
        return self

    def __next__(self) -> BcfRecord:
        rec = self.read1()
        if rec is None:
            raise StopIteration
        return rec

    def read1(self) -> Optional[BcfRecord]:
        head = self.fp.read(8)
        if len(head) == 0:
            return None
        if len(head) < 8:
            raise IOError("truncated BCF record")
        l_shared, l_indiv = struct.unpack("<II", head)
        shared = self.fp.read(l_shared)
        indiv = self.fp.read(l_indiv)
        if len(shared) != l_shared or len(indiv) != l_indiv:
            raise IOError("truncated BCF record")
        return BcfRecord.from_bcf(shared, indiv, self.header)

    def tell(self) -> int:
        return self.fp.tell()

    def seek(self, voffset: int) -> None:
        self.fp.seek(voffset)

    def fetch(self, rid: int, beg: int, end: int,
              index: Optional[HtsIndex] = None) -> Iterator[BcfRecord]:
        """Indexed region query over a CSI index (bcf_itr_queryi; the
        shared hts_itr machinery, hts.c:3426), by default the file's
        name + ".csi", loaded once.  beg/end 0-based half-open."""
        if index is None:
            index = getattr(self, "_index", None)
        if index is None:
            index = HtsIndex.load(self.name + ".csi")
            self._index = index
        for u, v in index.query_chunks(rid, beg, end):
            self.fp.seek(u)
            while True:
                if v and self.fp.tell() >= v:
                    break
                rec = self.read1()
                if rec is None:
                    break
                if rec.rid != rid or rec.pos >= end:
                    break
                if rec.pos + max(rec.rlen, 1) > beg:
                    yield rec

    def close(self) -> None:
        self.fp.close()

    def __enter__(self):
        return self

    def __exit__(self, *e):
        self.close()


class VcfWriter:
    def __init__(self, dst: Union[str, BinaryIO, BgzfWriter],
                 header: BcfHeader, compress: bool = False, level: int = -1):
        if compress:
            self.fp = (dst if isinstance(dst, BgzfWriter)
                       else BgzfWriter(dst, level=level))
        elif isinstance(dst, str):
            self.fp = hopen(dst, "wb")
        else:
            self.fp = dst
        self.header = header
        self.fp.write(header.text().encode("utf-8"))

    def write(self, rec: BcfRecord) -> None:
        self.fp.write(rec.to_vcf(self.header).encode("utf-8") + b"\n")

    def close(self) -> None:
        if isinstance(self.fp, BgzfWriter):
            self.fp.close()
        else:
            self.fp.flush()
            self.fp.close()

    def __enter__(self):
        return self

    def __exit__(self, *e):
        self.close()


class BcfWriter:
    def __init__(self, dst: Union[str, BinaryIO, BgzfWriter],
                 header: BcfHeader, level: int = -1,
                 build_index: bool = False):
        self._name = dst if isinstance(dst, str) else None
        self.fp = (dst if isinstance(dst, BgzfWriter)
                   else BgzfWriter(dst, level=level))
        self.header = header
        # BCF headers carry IDX= on every dictionary line (the
        # reference attaches them at hrec registration and strips them
        # only for text VCF output, vcf.c:2722) — required so dictionary
        # ids survive header-edit reordering
        text = header.text(with_idx=True).encode("utf-8") + b"\0"
        self.fp.write(BCF_MAGIC)
        self.fp.write(struct.pack("<I", len(text)))
        self.fp.write(text)
        # on-the-fly CSI (bcf_idx_init/bcf_idx_save, the --write-index
        # path): record uncompressed end offsets, map to virtual offsets
        # through the writer's block table at close
        self._index_recs = [] if build_index else None
        self._uheader_end = self.fp.utell() if build_index else None

    def write(self, rec: BcfRecord) -> None:
        shared, indiv = rec.to_bcf()
        self.fp.write(struct.pack("<II", len(shared), len(indiv)))
        self.fp.write(shared)
        self.fp.write(indiv)
        if self._index_recs is not None:
            self._index_recs.append((rec.rid, rec.pos,
                                     rec.pos + max(rec.rlen, 1),
                                     self.fp.utell()))

    def tell(self) -> int:
        return self.fp.tell()

    def close(self) -> None:
        if self._index_recs is not None:
            self.fp.flush()
            u2v = self.fp.virtual_offset
            idx = HtsIndex(len(self.header.ctg_names), HTS_FMT_CSI, 14, 5)
            off0 = u2v(self._uheader_end or 0)
            idx._last_off = idx._save_off = off0
            idx._off_beg = idx._off_end = off0
            last = off0
            for rid, beg, end, uend in self._index_recs:
                last = u2v(uend)
                idx.push(rid, beg, end, last, True)
            idx.finish(last)
            if self._name:
                idx.save(self._name + ".csi")
            self.index = idx
        self.fp.close()

    def __enter__(self):
        return self

    def __exit__(self, *e):
        self.close()


def open_vcf(name: str, mode: str = "r", header: Optional[BcfHeader] = None):
    """hts_open for variant data: r auto-detects VCF vs BCF; modes
    w / wz / wb mirror the reference's letters."""
    if "r" in mode:
        fp = hopen(name, "rb")
        fmt = detect_format_hfile(fp)
        if fmt.format == Format.bcf:
            return BcfReader(fp)
        if fmt.format in (Format.vcf, Format.text_format, Format.empty_format):
            return VcfReader(fp)
        fp.close()
        raise IOError(f"cannot read {name}: not variant data "
                      f"({fmt.description()})")
    if header is None:
        raise ValueError("writing requires a header")
    level = -1
    for ch in mode:
        if ch.isdigit():
            level = int(ch)
    if "b" in mode and "u" not in mode:
        return BcfWriter(name, header, level=level)
    return VcfWriter(name, header, compress="z" in mode, level=level)


def bcf_index_build(path: str, min_shift: int = 14,
                    out: Optional[str] = None) -> HtsIndex:
    """Build a CSI index for a BCF (bcf_index_build, vcf.c; the binning
    of BAM).  Returns the HtsIndex and writes `out` (by default the
    file's name + ".csi")."""
    with BcfReader(path) as r:
        idx = HtsIndex(len(r.header.ctg_names), HTS_FMT_CSI, min_shift, 5)
        last = r.tell()
        idx._last_off = idx._save_off = last
        idx._off_beg = idx._off_end = last
        while True:
            rec = r.read1()
            if rec is None:
                break
            last = r.tell()
            idx.push(rec.rid, rec.pos, rec.pos + max(rec.rlen, 1), last,
                     True)
        idx.finish(last)
    idx.save(out or path + ".csi")
    return idx


def bcf_members(raw: np.ndarray):
    """The members of a BCF file's bytes `raw`: (compressed offsets,
    whole sizes, uncompressed starts, ISIZEs, the stream's length).  A
    file that is not gzip has no members and is its own stream; a gzip
    file that is not BGZF raises IOError (its members cannot be found
    without inflating them)."""
    if len(raw) >= 2 and raw[0] == 0x1F and raw[1] == 0x8B:
        try:
            bt = scan_blocks(raw)
        except ValueError as e:
            raise IOError(f"BCF is gzip but not BGZF: {e}") from None
        co, cs, us = bt.coffsets, bt.csizes, bt.usizes
    else:
        co = np.zeros(0, np.uint64)
        cs = us = np.zeros(0, np.uint32)
    ustarts = np.zeros(len(us), np.uint64)
    np.cumsum(us[:-1].astype(np.uint64), out=ustarts[1:])
    total = int(us.sum(dtype=np.uint64)) if len(us) else len(raw)
    return co, cs, ustarts, us, total


def split_frames(buf: bytes, lo: int = 0,
                 hi: Optional[int] = None) -> Tuple[list, list]:
    """The BCF record frames of buf[lo:hi]: each one's (shared, indiv)
    blobs, walked by their two length words as the JAX loop walks them
    (a tail shorter than 8 bytes ends the walk; a frame that overruns
    gives short blobs, which the decoder refuses)."""
    hi = len(buf) if hi is None else hi
    shared, indiv = [], []
    p = lo
    while p + 8 <= hi:
        l_shared, l_indiv = struct.unpack_from("<II", buf, p)
        shared.append(buf[p + 8:p + 8 + l_shared])
        indiv.append(buf[p + 8 + l_shared:p + 8 + l_shared + l_indiv])
        p += 8 + l_shared + l_indiv
    return shared, indiv


def format_frames(shared: list, indiv: list, header: BcfHeader) -> bytes:
    """VCF text of the records framed by `split_frames`, one line each
    (BcfRecord.from_bcf(...).to_vcf)."""
    lines = [BcfRecord.from_bcf(s, i, header).to_vcf(header)
             for s, i in zip(shared, indiv)]
    return ("\n".join(lines) + ("\n" if lines else "")).encode()


def bcf_file_to_vcf(src: Union[str, BinaryIO], device="cuda",
                    timing: Optional[dict] = None) -> tuple:
    """Whole-file BCF -> VCF text: the file's members inflated in one
    `inflate_range` call on `device` (X4 on the card), the header parsed
    from the stream, the body's records framed and formatted on the host
    (vcf_format port, vcf.c:4304).  `src` is a path, a URL or a binary
    file object (bgzf.py `read_file`).  Returns (header, vcf_body_bytes).  `timing`, where given,
    gets read_s, inflate_s, frame_s and format_s."""
    dev = _build.resolve_device(device)
    timing = {} if timing is None else timing
    t0 = _build.clock(dev)
    raw = read_file(src)
    co, cs, ustarts, us, total = bcf_members(raw)
    timing["read_s"] = _build.clock(dev) - t0
    stream = inflate_range(raw, co, cs, ustarts, us, 0, total, dev, timing)
    t0 = _build.clock(dev)
    if stream[:3] != b"BCF" or len(stream) < 9 or stream[3] != 2:
        raise IOError("invalid BCF2 magic")
    (l_text,) = struct.unpack_from("<I", stream, 5)
    header = BcfHeader(stream[9:9 + l_text].rstrip(b"\0")
                       .decode("utf-8", "replace"))
    shared, indiv = split_frames(stream, 9 + l_text)
    t1 = _build.clock(dev)
    body = format_frames(shared, indiv, header)
    timing["frame_s"] = t1 - t0
    timing["format_s"] = _build.clock(dev) - t1
    return header, body


def vcf_body_to_bcf_frames(body: bytes, header: BcfHeader) -> bytes:
    """VCF body text -> concatenated BCF record frames, a line at a
    time (from_vcf, to_bcf); blank lines are skipped."""
    frames = bytearray()
    for line in body.splitlines():
        if not line.strip():
            continue
        rec = BcfRecord.from_vcf(line.decode("utf-8"), header)
        shared, indiv = rec.to_bcf()
        frames += struct.pack("<II", len(shared), len(indiv))
        frames += shared + indiv
    return bytes(frames)


def vcf_file_to_bcf(src: str, dst: str) -> int:
    """Whole-file VCF -> BCF: header parse, body parse a line at a time,
    BGZF write.  Returns the record count."""
    with hopen(src, "rb") as f:
        raw = f.read(-1)
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    # split header from body
    pos = 0
    while pos < len(raw) and raw[pos:pos + 1] == b"#":
        nl = raw.find(b"\n", pos)
        if nl < 0:
            pos = len(raw)
            break
        pos = nl + 1
    header = BcfHeader(raw[:pos].decode("utf-8", "replace"))
    frames = vcf_body_to_bcf_frames(raw[pos:], header)
    n = 0
    p = 0
    while p < len(frames):
        l_shared, l_indiv = struct.unpack_from("<II", frames, p)
        p += 8 + l_shared + l_indiv
        n += 1
    w = BcfWriter(dst, header)
    try:
        w.fp.write(frames)
    finally:
        w.close()
    return n
