"""SAM text I/O: the port's copy of htslib_tpu/sam/samtext.py (reference
sam.c:2662 sam_parse1 / sam.c:4324 sam_format1).  Files are local paths
or binary file objects (the JAX package's HFile back ends are not
ported)."""
from __future__ import annotations

import os
from typing import BinaryIO, Iterator, Optional, Union

from htslib_tpu_torch.bgzf import BgzfReader, BgzfWriter
from htslib_tpu_torch.hts_expr import HtsFilter, sam_passes_filter
from htslib_tpu_torch.sam.header import SamHeader
from htslib_tpu_torch.sam.record import BamRecord


class SamReader:
    """Reads SAM text (plain, gzip or BGZF)."""

    def __init__(self, src: Union[str, os.PathLike, BinaryIO, BgzfReader]):
        self.fp = src if isinstance(src, BgzfReader) else BgzfReader(src)
        self._filter = None
        lines = []
        self._pending: Optional[bytes] = None
        while True:
            line = self.fp.readline()
            if not line:
                break
            if line.startswith(b"@"):
                lines.append(line.decode("utf-8", "replace").rstrip("\n"))
            else:
                self._pending = line
                break
        self.header = SamHeader("\n".join(lines) + ("\n" if lines else ""))

    def __iter__(self) -> Iterator[BamRecord]:
        return self

    def set_filter(self, expr: Optional[str]) -> None:
        """hts_set_filter_expression (hts.c:1967): the iterator skips
        records failing the expression (sam_passes_filter, sam.c:1535)."""
        self._filter = HtsFilter(expr) if expr else None

    def __next__(self) -> BamRecord:
        while True:
            rec = self.read1()
            if rec is None:
                raise StopIteration
            if self._filter is None or sam_passes_filter(
                    rec, self.header, self._filter):
                return rec

    def read1(self) -> Optional[BamRecord]:
        if self._pending is not None:
            line, self._pending = self._pending, None
        else:
            line = self.fp.readline()
        while line in (b"\n", b"\r\n"):
            line = self.fp.readline()
        if not line:
            return None
        return BamRecord.from_sam(line.decode("utf-8"), self.header)

    def close(self) -> None:
        self.fp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class SamWriter:
    """Writes SAM text; optionally BGZF-compressed ('z' mode)."""

    def __init__(self, dst: Union[str, BinaryIO, BgzfWriter],
                 header: SamHeader, write_header: bool = True,
                 compress: bool = False, level: int = -1):
        if compress:
            self.fp = (dst if isinstance(dst, BgzfWriter)
                       else BgzfWriter(dst, level=level))
        elif isinstance(dst, str):
            self.fp = open(dst, "wb")
        else:
            self.fp = dst
        self.header = header
        if write_header:
            text = header.full_text_with_refs()
            if text:
                self.fp.write(text.encode("utf-8"))

    def write(self, rec: BamRecord) -> None:
        self.fp.write(rec.to_sam(self.header).encode("utf-8") + b"\n")

    def write_line(self, line: str) -> None:
        self.fp.write(line.encode("utf-8") + b"\n")

    def close(self) -> None:
        if isinstance(self.fp, BgzfWriter):
            self.fp.close()
        else:
            self.fp.flush()
            self.fp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
