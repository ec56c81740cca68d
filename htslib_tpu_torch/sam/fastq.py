"""FASTA and FASTQ records as unmapped reads (the port's copy of
htslib_tpu/sam/fastq.py; reference sam.c:3927 fastq_parse1, sam.c:4413
fastq_format1, options sam.c:3830-3925).

`FastxReader` reads FASTA or FASTQ (plain, gzip or BGZF, from a name
that hfile.py `hopen` opens, an `HFile` or a `BgzfReader`) into
`BamRecord`s: /1 /2 read-number suffixes, Illumina CASAVA comments
(read:filter:control:barcode -> flags and a BC tag), SAM aux tags in
comments (optionally a whitelist), UMIs taken from read names and
SRA-style name2 swaps.  `fastq_format1` writes a record back.
"""
from __future__ import annotations

import re
from typing import Iterator, List, Optional, Union

from htslib_tpu_torch.bgzf import BgzfReader
from htslib_tpu_torch.hfile import HFile
from htslib_tpu_torch.sam.header import SamHeader
from htslib_tpu_torch.sam.record import (FMUNMAP, FPAIRED, FQCFAIL, FREAD1,
                                         FREAD2, FREVERSE, FUNMAP, BamRecord,
                                         format_aux_blob, parse_aux_field)

_DEFAULT_UMI_RE = r"^[^:]+:[^:]+:[^:]+:[^:]+:[^:]+:[^:]+:[^:]+:([^:#/]+)"

_REVCOMP = "!TGKCYSBAWRDMHVN"


class FastqState:
    def __init__(self, fasta: bool = False, casava: bool = False,
                 aux: Union[bool, str] = False, barcode: str = "BC",
                 umi: Optional[str] = None, rnum: bool = False,
                 name2: bool = False, umi_regex: Optional[str] = None):
        self.nprefix = ">" if fasta else "@"
        self.fasta = fasta
        self.casava = casava
        self.aux = bool(aux)
        self.tags: Optional[set] = None
        if isinstance(aux, str) and aux not in ("", "1"):
            self.tags = set(aux.split(","))
        self.BC = barcode[:2]
        if umi is not None and umi == "1":
            umi = "RX"
        self.UMI: List[str] = []
        if umi:
            self.UMI = [t for t in umi.split(",") if len(t) == 2]
        self.rnum = rnum
        self.sra_names = name2
        self.regex = re.compile(umi_regex or _DEFAULT_UMI_RE)


class FastxReader:
    """Reads FASTA/FASTQ as BamRecords (unmapped)."""

    def __init__(self, src: Union[str, HFile, BgzfReader], fasta: bool = False,
                 state: Optional[FastqState] = None):
        self.fp = src if isinstance(src, BgzfReader) else BgzfReader(src)
        self.state = state or FastqState(fasta=fasta)
        self.state.nprefix = ">" if fasta else "@"
        self.state.fasta = fasta
        self.header = SamHeader("")
        self._pending_name: Optional[str] = None

    def __iter__(self) -> Iterator[BamRecord]:
        return self

    def __next__(self) -> BamRecord:
        rec = self.read1()
        if rec is None:
            raise StopIteration
        return rec

    def read1(self) -> Optional[BamRecord]:
        x = self.state
        if self._pending_name is not None:
            nameline = self._pending_name
            self._pending_name = None
        else:
            raw = self.fp.readline()
            if not raw:
                return None
            nameline = raw.decode().rstrip("\n")
        if not nameline or nameline[0] != x.nprefix:
            raise IOError(f"malformed FASTX record near {nameline[:40]!r}")
        # SRA name2: swap "run.number name" ordering
        name_s = nameline
        if x.sra_names:
            m = re.search(r"[ \t]+", nameline)
            if m:
                name_s = x.nprefix + nameline[m.end():]
        body = name_s[1:]
        sp = re.search(r"\s", body)
        if sp:
            name = body[:sp.start()]
            comment = body[sp.start():].lstrip(" \t")
        else:
            name = body
            comment = ""
        # sequence lines
        seq_parts: List[str] = []
        qual: Optional[bytes] = None
        if x.fasta:
            while True:
                raw = self.fp.readline()
                if not raw:
                    break
                line = raw.decode().rstrip("\n")
                if line.startswith(">"):
                    self._pending_name = line
                    break
                seq_parts.append(line)
        else:
            while True:
                raw = self.fp.readline()
                if not raw:
                    raise IOError("truncated FASTQ record")
                line = raw.decode().rstrip("\n")
                if line.startswith("+"):
                    break
                seq_parts.append(line)
            seq = "".join(seq_parts)
            remainder = len(seq)
            qparts: List[str] = []
            while remainder > 0:
                raw = self.fp.readline()
                if not raw:
                    raise IOError("truncated FASTQ quality")
                line = raw.decode().rstrip("\n")
                if len(line) > remainder:
                    raise IOError("FASTQ quality longer than sequence")
                qparts.append(line)
                remainder -= len(line)
            qual = bytes(ord(c) - 33 for c in "".join(qparts))
        seq = "".join(seq_parts)

        flag = FUNMAP
        pflag = FMUNMAP | FPAIRED
        if len(name) > 2 and name[-2] == "/" and name[-1].isdigit():
            if name[-1] == "1":
                flag |= FREAD1 | pflag
            elif name[-1] == "2":
                flag |= FREAD2 | pflag
            else:
                flag |= FREAD1 | FREAD2 | pflag
            name = name[:-2]

        umi_val = None
        if x.UMI:
            m = x.regex.match(name)
            if m and m.group(1):
                umi_val = "".join(c if c.isalpha() else "-"
                                  for c in m.group(1))
                pre = name[:m.start(1)]
                if pre.endswith(":"):
                    pre = pre[:-1]
                name = pre + name[m.end(1):]

        rec = BamRecord()
        rec.qname = name.encode()
        rec.flag = flag
        rec.set_seq(seq if seq else "*", qual)
        if umi_val is not None:
            rec.set_aux(x.UMI[0], "Z", umi_val)

        barcode_len = 0
        if (x.casava and len(comment) > 6 and comment[1] == ":"
                and comment[3] == ":" and comment[0].isdigit()):
            mnum = re.match(r"^(\d):([YN]):(\d+):", comment)
            if mnum:
                rnum_c = comment[0]
                if rnum_c == "1":
                    rec.flag |= FREAD1 | pflag
                elif rnum_c == "2":
                    rec.flag |= FREAD2 | pflag
                else:
                    rec.flag |= FREAD1 | FREAD2 | pflag
                if comment[2] == "Y":
                    rec.flag |= FQCFAIL
                rest = comment[mnum.end():]
                if rest and not rest[0].isdigit():
                    wsp = re.search(r"\s", rest)
                    barcode = rest[:wsp.start()] if wsp else rest
                    rec.set_aux(x.BC, "Z", barcode)
                    barcode_len = mnum.end() + len(barcode) + 1
        if x.aux and comment:
            tail = comment[barcode_len:]
            parts = []
            for col in re.split(r"\t", tail):
                col = col.strip()
                if not col:
                    continue
                if len(col) >= 5 and col[2] == ":" and col[4] == ":":
                    if x.tags is not None and col[:2] not in x.tags:
                        continue
                    try:
                        parts.append(parse_aux_field(col))
                    except ValueError:
                        pass
            rec.aux += b"".join(parts)
        return rec

    def close(self) -> None:
        self.fp.close()

    def __enter__(self):
        return self

    def __exit__(self, *e):
        self.close()


def fastq_format1(x: FastqState, b: BamRecord) -> str:
    """sam_format1 for FASTQ/FASTA output (sam.c:4413)."""
    out = [x.nprefix + b.qname.decode()]
    if x.UMI:
        # move any '#num' suffix after the UMI
        s = out[0]
        plex = ""
        idx = len(s) - 1
        while idx > 0 and s[idx] not in ":#":
            idx -= 1
        if idx > 0 and s[idx] == "#":
            plex = s[idx:]
            s = s[:idx]
        umi = None
        for t in x.UMI:
            v = b.get_aux(t)
            if isinstance(v, str):
                umi = v
                break
        if umi is not None:
            s += ":" + "".join(c.upper() if c.isalpha() else "+" for c in umi)
        out[0] = s + plex
    if x.rnum and (b.flag & FPAIRED):
        r12 = b.flag & (FREAD1 | FREAD2)
        if r12 == FREAD1:
            out[0] += "/1"
        elif r12 == FREAD2:
            out[0] += "/2"
    if x.casava:
        rnum = 1 if b.flag & FREAD1 else 2 if b.flag & FREAD2 else 0
        filt = "Y" if b.flag & FQCFAIL else "N"
        bc = b.get_aux(x.BC)
        if isinstance(bc, str) and bc and bc[0].isalpha():
            bc_s = "".join(c.upper() if c.isalpha() else "+" for c in bc)
        elif bc is not None:
            bc_s = "0"
        else:
            bc_s = "0"
        out[0] += f" {rnum}:{filt}:0:{bc_s}"
    if x.aux:
        txt = format_aux_blob(b.aux)
        if txt:
            for fld in txt.split("\t"):
                if x.tags is not None and fld[:2] not in x.tags:
                    continue
                out[0] += "\t" + fld
    seq = b.seq if b.l_qseq else ""
    if b.flag & FREVERSE:
        # reverse complement via nt16 complement string
        packed = b.seq4
        comp = []
        for i in range(b.l_qseq - 1, -1, -1):
            nib = (packed[i >> 1] >> 4) if (i & 1) == 0 else (packed[i >> 1] & 0xF)
            comp.append(_REVCOMP[nib])
        seq = "".join(comp)
    lines = [out[0], seq]
    if x.nprefix == "@":
        if b.qual and b.qual[0] == 0xFF:
            q = "B" * b.l_qseq
        elif b.flag & FREVERSE:
            q = "".join(chr(33 + c) for c in reversed(b.qual))
        else:
            q = "".join(chr(33 + c) for c in b.qual)
        lines += ["+", q]
    return "\n".join(lines) + "\n"
