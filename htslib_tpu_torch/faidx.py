"""FASTA random access for the CRAM reference (the port's minimal copy of
htslib_tpu/faidx.py; reference faidx.c).

A `.fai` row holds a sequence's name, length, the file offset of its
first base, its bases a line and its bytes a line (fai_build_core,
faidx.c:132).  `Faidx.load` reads the index beside a plain FASTA file,
or builds and writes it (by a rename, so processes that build it at once
leave one whole file), and `fetch_seq` reads [beg, end) of a sequence
through that line geometry (fai_retrieve, faidx.c:716).  Compressed
FASTA (BGZF with its `.gzi`) and FASTQ are not ported.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import BinaryIO, Dict, List, Optional

HTS_POS_MAX = (1 << 63) - 1


@dataclass
class FaiEntry:
    name: str
    length: int
    offset: int
    line_blen: int   # bases a line
    line_len: int    # bytes a line, with its newline


class Faidx:
    def __init__(self, fname: str, entries: List[FaiEntry]):
        self.fname = fname
        self.entries = entries
        self._byname: Dict[str, FaiEntry] = {e.name: e for e in entries}
        self._fp: Optional[BinaryIO] = None

    @classmethod
    def build(cls, fname: str, save: bool = True) -> "Faidx":
        """One scan recording each sequence's line geometry; raises on
        lines of differing length inside a sequence but its last."""
        entries: List[FaiEntry] = []
        name: Optional[str] = None
        length = offset = 0
        line_blen = line_len = last_blen = -1

        def close_seq():
            if name is not None:
                entries.append(FaiEntry(name, length, offset,
                                        max(line_blen, 0), max(line_len, 0)))

        with open(fname, "rb") as fp:
            pos = 0
            for line in fp:
                pos += len(line)
                if line.startswith(b">"):
                    close_seq()
                    parts = line[1:].split()
                    name = parts[0].decode() if parts else ""
                    length, offset = 0, pos
                    line_blen = line_len = last_blen = -1
                    continue
                if name is None:
                    raise IOError(f"{fname}: not a FASTA file "
                                  "(data before '>')")
                blen = len(line.rstrip(b"\r\n"))
                if blen == 0:
                    last_blen = 0
                    continue
                if last_blen == 0:
                    raise IOError("FASTA sequence has blank line inside")
                if line_blen < 0:
                    line_blen, line_len = blen, len(line)
                elif blen > line_blen or (last_blen >= 0
                                          and last_blen != line_blen):
                    raise IOError(f"{fname}: different line length in "
                                  f"sequence {name!r}")
                last_blen = blen
                length += blen
            close_seq()
        fai = cls(fname, entries)
        if save:
            fai.save()
        return fai

    def save(self, path: Optional[str] = None) -> None:
        path = path or self.fname + ".fai"
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            for e in self.entries:
                f.write(f"{e.name}\t{e.length}\t{e.offset}\t"
                        f"{e.line_blen}\t{e.line_len}\n")
        os.replace(tmp, path)

    @classmethod
    def load(cls, fname: str) -> "Faidx":
        """fai_load3 (faidx.c:590): the `.fai` beside `fname`, built and
        written where it is absent."""
        path = fname + ".fai"
        if not os.path.exists(path):
            return cls.build(fname)
        entries = []
        with open(path) as f:
            for line in f:
                cols = line.rstrip("\n").split("\t")
                if len(cols) < 5:
                    raise IOError(f"malformed index line in {path}")
                entries.append(FaiEntry(cols[0], *map(int, cols[1:5])))
        return cls(fname, entries)

    def has_seq(self, name: str) -> bool:
        return name in self._byname

    def fetch_seq(self, name: str, beg: int = 0,
                  end: int = HTS_POS_MAX) -> str:
        """faidx_fetch_seq64 (faidx.c:972): the bases of 0-based
        [beg, end), clamped to the sequence."""
        e = self._byname.get(name)
        if e is None:
            raise KeyError(f"unknown sequence {name!r}")
        beg, end = max(beg, 0), min(end, e.length)
        if beg >= end or e.line_blen == 0:
            return ""
        if self._fp is None:
            self._fp = open(self.fname, "rb")
        first = beg // e.line_blen
        last = (end - 1) // e.line_blen
        self._fp.seek(e.offset + first * e.line_len)
        lines = self._fp.read((last - first + 1) * e.line_len)
        out = b"".join(lines[i:i + e.line_blen] for i in
                       range(0, len(lines), e.line_len))
        skip = beg - first * e.line_blen
        seq = out[skip:skip + end - beg]
        if len(seq) < end - beg:
            raise IOError("truncated sequence data")
        return seq.decode("ascii")

    def close(self) -> None:
        if self._fp is not None:
            self._fp.close()
            self._fp = None
