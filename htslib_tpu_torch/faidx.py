"""FASTA/FASTQ indexing and random access: the port's copy of
htslib_tpu/faidx.py (reference faidx.c:1-1066).

A `.fai` row holds a sequence's name, length, the offset of its first
base, its bases a line and its bytes a line; a `.fqi` row adds the offset
of its qualities (fai_build_core, faidx.c:132).  Offsets are in the
uncompressed stream, so a BGZF-compressed file is read through its
`.gzi` block index, or a block map built in memory where it has none
(faidx.c:716); a gzip file that is not BGZF is refused at the first
fetch.  `Faidx.load` reads the index beside the file, or builds it and
writes it by a rename (processes that build it at once leave one whole
file), and `fetch_seq` reads [beg, end) of a sequence through its line
geometry (fai_retrieve, faidx.c:716).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from htslib_tpu_torch.bgzf import BgzfReader, GziIndex, scan_blocks
from htslib_tpu_torch.index import (HTS_PARSE_ONE_COORD, HTS_POS_MAX,
                                    parse_region)

FAI_FASTA = 0
FAI_FASTQ = 1


@dataclass
class FaiEntry:
    name: str
    length: int
    offset: int
    line_blen: int   # bases a line
    line_len: int    # bytes a line, with its newline
    qual_offset: int = -1  # FASTQ only


class Faidx:
    def __init__(self, fname: str, entries: List[FaiEntry],
                 fmt: int = FAI_FASTA):
        self.fname = fname
        self.entries = entries
        self.fmt = fmt
        self._byname: Dict[str, FaiEntry] = {e.name: e for e in entries}
        self._fp: Optional[BgzfReader] = None

    @classmethod
    def build(cls, fname: str, fmt: Optional[int] = None,
              save: bool = True) -> "Faidx":
        """fai_build_core (faidx.c:132): one scan recording each
        sequence's line geometry; raises on lines of differing length
        inside a sequence but its last."""
        fp = BgzfReader(fname)
        if fmt is None:
            fmt = FAI_FASTQ if fp.peek(1) == b"@" else FAI_FASTA
        entries: List[FaiEntry] = []
        try:
            if fmt == FAI_FASTA:
                _scan_fasta(fp, fname, entries)
            else:
                _scan_fastq(fp, entries)
        finally:
            fp.close()
        fai = cls(fname, entries, fmt)
        if save:
            fai.save()
        return fai

    def save(self, path: Optional[str] = None) -> None:
        path = path or self.fname + (".fai" if self.fmt == FAI_FASTA
                                     else ".fqi")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            for e in self.entries:
                row = (f"{e.name}\t{e.length}\t{e.offset}\t{e.line_blen}\t"
                       f"{e.line_len}")
                if self.fmt != FAI_FASTA:
                    row += f"\t{e.qual_offset}"
                f.write(row + "\n")
        os.replace(tmp, path)

    @classmethod
    def load(cls, fname: str, fai_path: Optional[str] = None,
             build_missing: bool = True) -> "Faidx":
        """fai_load3 (faidx.c:590): the `.fai` or `.fqi` beside `fname`
        (or `fai_path`), built and written where it is absent."""
        for ext, fmt in ((".fai", FAI_FASTA), (".fqi", FAI_FASTQ)):
            p = fai_path or fname + ext
            if os.path.exists(p):
                entries = []
                with open(p) as f:
                    for line in f:
                        cols = line.rstrip("\n").split("\t")
                        if len(cols) < 5:
                            raise IOError(f"malformed index line in {p}")
                        entries.append(FaiEntry(
                            cols[0], int(cols[1]), int(cols[2]),
                            int(cols[3]), int(cols[4]),
                            int(cols[5]) if len(cols) > 5 else -1))
                return cls(fname, entries,
                           FAI_FASTQ if (entries
                                         and entries[0].qual_offset >= 0)
                           else fmt)
            if fai_path:
                break
        if build_missing:
            return cls.build(fname)
        raise FileNotFoundError(f"no index for {fname}")

    @property
    def nseq(self) -> int:
        return len(self.entries)

    def seq_names(self) -> List[str]:
        return [e.name for e in self.entries]

    def seq_len(self, name: str) -> int:
        e = self._byname.get(name)
        return e.length if e else -1

    def has_seq(self, name: str) -> bool:
        return name in self._byname

    def _file(self) -> BgzfReader:
        if self._fp is None:
            self._fp = BgzfReader(self.fname)
            if self._fp.is_bgzf:
                if os.path.exists(self.fname + ".gzi"):
                    self._fp.load_index(self.fname + ".gzi")
                else:
                    self._fp.idx = GziIndex.from_table(scan_blocks(
                        np.fromfile(self.fname, np.uint8)))
            elif self._fp.is_gzip:
                raise IOError(f"{self.fname} is gzip (not bgzip) "
                              "compressed; random access is not possible")
        return self._fp

    def _retrieve(self, e: FaiEntry, base_offset: int, beg: int,
                  end: int) -> str:
        """fai_retrieve (faidx.c:716): [beg, end) clamped to the
        sequence, its whole lines read at once and their line ends
        dropped."""
        beg, end = max(beg, 0), min(end, e.length)
        if beg >= end or e.line_blen == 0:
            return ""
        fp = self._file()
        first = beg // e.line_blen
        last = (end - 1) // e.line_blen
        fp.useek(base_offset + first * e.line_len)
        lines = fp.read((last - first + 1) * e.line_len)
        out = b"".join(lines[i:i + e.line_blen] for i in
                       range(0, len(lines), e.line_len))
        skip = beg - first * e.line_blen
        seq = out[skip:skip + end - beg]
        if len(seq) < end - beg:
            raise IOError("truncated sequence data")
        return seq.decode("ascii")

    def fetch_seq(self, name: str, beg: int = 0,
                  end: int = HTS_POS_MAX) -> str:
        """faidx_fetch_seq64 (faidx.c:972): 0-based [beg, end)."""
        e = self._byname.get(name)
        if e is None:
            raise KeyError(f"unknown sequence {name!r}")
        return self._retrieve(e, e.offset, beg, end)

    def fetch_qual(self, name: str, beg: int = 0,
                   end: int = HTS_POS_MAX) -> str:
        """faidx_fetch_qual64 (faidx.c:1003): a FASTQ record's qualities
        over 0-based [beg, end)."""
        e = self._byname.get(name)
        if e is None or e.qual_offset < 0:
            raise KeyError(f"no qualities for {name!r}")
        return self._retrieve(e, e.qual_offset, beg, end)

    def fetch(self, region: str) -> Tuple[str, str]:
        """fai_fetch64 (faidx.c:846): a region string's (name, bases)."""
        def n2i(s: str) -> int:
            return self.seq_names().index(s) if s in self._byname else -1
        res = parse_region(region, n2i, HTS_PARSE_ONE_COORD)
        if res is None:
            raise ValueError(f"could not parse region {region!r}")
        tid, beg, end, _ = res
        name = self.entries[tid].name
        return name, self.fetch_seq(name, beg, end)

    def adjust_region(self, name: str, beg: int,
                      end: int) -> Tuple[int, int]:
        """fai_adjust_region (faidx.c:952): clamp to the sequence; (-1,
        -1) for an unknown name."""
        e = self._byname.get(name)
        if e is None:
            return -1, -1
        if beg < 0:
            beg = 0
        if end < 0 or end > e.length:
            end = e.length
        if beg > e.length:
            beg = e.length
        return beg, end

    def close(self) -> None:
        if self._fp is not None:
            self._fp.close()
            self._fp = None


def _scan_fasta(fp: BgzfReader, fname: str, entries: List[FaiEntry]) -> None:
    name: Optional[str] = None
    length = offset = 0
    line_blen = line_len = last_blen = -1

    def close_seq():
        if name is not None:
            entries.append(FaiEntry(name, length, offset, max(line_blen, 0),
                                    max(line_len, 0)))

    while True:
        line = fp.readline()
        if not line:
            break
        if line.startswith(b">"):
            close_seq()
            parts = line[1:].split()
            # an empty name is kept as it is (a bare '>')
            name = parts[0].decode() if parts else ""
            length, offset = 0, fp.utell()
            line_blen = line_len = last_blen = -1
            continue
        if name is None:
            raise IOError(f"{fname}: not a FASTA file (data before '>')")
        blen = len(line.rstrip(b"\r\n"))
        if blen == 0:
            # a blank line ends the sequence (trailing blanks allowed)
            last_blen = 0
            continue
        if last_blen == 0:
            raise IOError("FASTA sequence has blank line inside")
        if line_blen < 0:
            line_blen, line_len = blen, len(line)
        elif blen > line_blen or (last_blen >= 0 and last_blen != line_blen):
            raise IOError(f"{fname}: different line length in "
                          f"sequence {name!r}")
        last_blen = blen
        length += blen
    close_seq()


def _scan_fastq(fp: BgzfReader, entries: List[FaiEntry]) -> None:
    while True:
        line = fp.readline()
        if not line:
            break
        if not line.startswith(b"@"):
            raise IOError(f"{fp.name}: malformed FASTQ header")
        name = line[1:].split()[0].decode()
        length = 0
        line_blen = line_len = -1
        offset = fp.utell()
        # sequence lines until '+'
        while True:
            l2 = fp.readline()
            if not l2 or l2.startswith(b"+"):
                break
            blen = len(l2.rstrip(b"\r\n"))
            if line_blen < 0:
                line_blen, line_len = blen, len(l2)
            length += blen
        qual_offset = fp.utell()
        got = 0
        while got < length:
            l3 = fp.readline()
            if not l3:
                raise IOError("truncated FASTQ quality")
            got += len(l3.rstrip(b"\r\n"))
        entries.append(FaiEntry(name, length, offset, max(line_blen, 0),
                                max(line_len, 0), qual_offset))
