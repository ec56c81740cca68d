"""annot-tsv CLI (reference annot-tsv.c:956): transfer annotations between
TSV interval files via regidx overlaps; grep/drop modes, value transfer
with match conditions, nbp/frac/cnt annotations, overlap thresholds.  The
port's copy of htslib_tpu/cli/annot_tsv.py over its own regidx.py and BGZF
reader, on the host:

    python -m htslib_tpu_torch.cli.annot_tsv -s src.tsv -t tgt.tsv -f 4:5
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Tuple

from htslib_tpu_torch.bgzf import BGZFReader
from htslib_tpu_torch.regidx import RegIdx


def _split_pair(spec: str, default_same: bool = True) -> Tuple[str, str]:
    if ":" in spec:
        s, t = spec.split(":", 1)
        return s, t
    return spec, spec


class TsvFile:
    def __init__(self, path: str, delim: Optional[str], hdr_line: int):
        self.delim = delim or "\t"
        raw = BGZFReader(path).read(-1).decode() if path != "-" \
            else sys.stdin.read()
        lines = raw.split("\n")
        if lines and lines[-1] == "":
            lines.pop()
        self.comments: List[str] = []
        i = 0
        while i < len(lines) and lines[i].startswith("#"):
            self.comments.append(lines[i])
            i += 1
        self.rows: List[List[str]] = [l.split(self.delim) for l in lines[i:]
                                      if l != ""]
        # header selection within the comment block
        self.header: Optional[List[str]] = None
        if hdr_line != 0 and self.comments:
            idx = hdr_line - 1 if hdr_line > 0 else len(self.comments) + hdr_line
            if 0 <= idx < len(self.comments):
                h = self.comments[idx]
                self.header = h.lstrip("#").split(self.delim)

    def colidx(self, name: str) -> Optional[int]:
        """1-based index or header name -> 0-based index; None if the
        column does not exist."""
        if self.header is not None and name in self.header:
            return self.header.index(name)
        if name.isdigit():
            i = int(name) - 1
            return i
        return None


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="annot-tsv", add_help=False)
    p.add_argument("--help", action="help")
    p.add_argument("-c", "--core", default="chr,beg,end")
    p.add_argument("-f", "--transfer")
    p.add_argument("-m", "--match")
    p.add_argument("-o", "--output", default="-")
    p.add_argument("-s", "--source-file", dest="src", default="-")
    p.add_argument("-t", "--target-file", dest="tgt", default="-")
    p.add_argument("--allow-dups", action="store_true")
    p.add_argument("--max-annots", type=int, default=0)
    p.add_argument("-a", "--annotate", default="")
    p.add_argument("-C", "--coords", default="11")
    p.add_argument("-d", "--delim")
    p.add_argument("-h", "--headers", default="1:1")
    p.add_argument("-H", "--ignore-headers", action="store_true")
    p.add_argument("-I", "--no-header-idx", action="count", default=0)
    p.add_argument("-O", "--overlap")
    p.add_argument("-r", "--reciprocal", action="store_true")
    p.add_argument("-x", "--drop-overlaps", action="store_true")
    a = p.parse_args(argv)

    sd, td = _split_pair(a.delim) if a.delim else (None, None)
    hs, ht = _split_pair(a.headers)
    hs_i, ht_i = int(hs), int(ht)
    if a.ignore_headers:
        hs_i = ht_i = 0
    src = TsvFile(a.src, sd, hs_i)
    tgt = TsvFile(a.tgt, td, ht_i)
    if a.ignore_headers:
        src.header = tgt.header = None

    c_src, c_tgt = _split_pair(a.core)
    s_chr, s_beg, s_end = [src.colidx(x) for x in c_src.split(",")]
    t_chr, t_beg, t_end = [tgt.colidx(x) for x in c_tgt.split(",")]
    if None in (s_chr, s_beg, s_end) or None in (t_chr, t_beg, t_end):
        print("annot-tsv: cannot resolve core columns", file=sys.stderr)
        return 1

    coords_s, coords_t = a.coords[0], a.coords[-1]
    off_s = 0 if coords_s == "0" else 1
    off_t = 0 if coords_t == "0" else 1

    m_pairs: List[Tuple[int, int]] = []
    if a.match:
        ms, mt = _split_pair(a.match)
        for sname, tname in zip(ms.split(","), mt.split(",")):
            si, ti = src.colidx(sname), tgt.colidx(tname)
            if si is None or ti is None:
                print("annot-tsv: cannot resolve match columns",
                      file=sys.stderr)
                return 1
            m_pairs.append((si, ti))

    # transfer columns: (src index or literal, tgt index or new name)
    transfers: List[Tuple[Optional[int], Optional[str], Optional[int], str]] = []
    if a.transfer:
        fs, ft = _split_pair(a.transfer)
        for sname, tname in zip(fs.split(","), ft.split(",")):
            si = src.colidx(sname)
            if si is not None and si >= (len(src.rows[0]) if src.rows else 0):
                si = None
            literal = sname if si is None else None
            ti = tgt.colidx(tname)
            if ti is not None and ti >= (len(tgt.rows[0]) if tgt.rows else 0):
                ti = None
            transfers.append((si, literal, ti, tname))
    annots = [x for x in a.annotate.split(",") if x]

    # overlap thresholds
    o_src = o_tgt = 0.0
    single_o = None
    if a.overlap:
        parts = a.overlap.split(",")
        if len(parts) == 1:
            single_o = float(parts[0])
        else:
            o_src, o_tgt = float(parts[0]), float(parts[1])

    # build source index (0-based inclusive internal coords)
    idx = RegIdx()
    for row in src.rows:
        try:
            beg = int(row[s_beg]) - off_s
            end = int(row[s_end]) - off_s
        except (ValueError, IndexError):
            continue
        if end < beg:
            end = beg
        idx.push(row[s_chr], beg, end, row)

    grep_mode = not transfers and not annots

    out_lines: List[str] = []
    # header
    if tgt.header is not None and a.no_header_idx < 2:
        hdr = list(tgt.header)
        for si, literal, ti, tname in transfers:
            if ti is None:
                hdr.append(tname)
        for an in annots:
            hdr.append(an)
        if a.no_header_idx == 1:
            out_lines.append("#" + tgt.delim.join(hdr))
        else:
            out_lines.append("#" + tgt.delim.join(
                f"[{i + 1}]{h}" for i, h in enumerate(hdr)))

    for row in tgt.rows:
        try:
            beg = int(row[t_beg]) - off_t
            end = int(row[t_end]) - off_t
        except (ValueError, IndexError):
            out_lines.append(tgt.delim.join(row))
            continue
        if end < beg:
            end = beg
        tlen = end - beg + 1
        hits = []
        for sb, se, srow in idx.overlap(row[t_chr], beg, end):
            if m_pairs and any(srow[si] != row[ti] for si, ti in m_pairs):
                continue
            ov = min(se, end) - max(sb, beg) + 1
            slen = se - sb + 1
            fs = ov / slen
            ft_ = ov / tlen
            if single_o is not None:
                if a.reciprocal:
                    if min(fs, ft_) < single_o:
                        continue
                elif max(fs, ft_) < single_o:
                    continue
            else:
                if fs < o_src or ft_ < o_tgt:
                    continue
            hits.append((sb, se, srow))
        has = bool(hits)
        if grep_mode:
            if a.drop_overlaps != (not has):
                continue
            out_lines.append(tgt.delim.join(row))
            continue
        newrow = list(row)
        extra: List[str] = []
        for si, literal, ti, tname in transfers:
            if has:
                if literal is not None:
                    vals = [literal]
                else:
                    vals = [h[2][si] for h in hits]
                    if not a.allow_dups:
                        seen = []
                        for v in vals:
                            if v not in seen:
                                seen.append(v)
                        vals = seen
                    if a.max_annots:
                        vals = vals[:a.max_annots]
                val = ",".join(vals)
                if ti is None:
                    extra.append(val)
                else:
                    newrow[ti] = val
            else:
                if ti is None:
                    extra.append(".")
        for an in annots:
            if an == "cnt":
                extra.append(str(len(hits)))
            elif an in ("nbp", "frac"):
                segs = sorted((max(sb, beg), min(se, end))
                              for sb, se, _ in hits)
                nbp = 0
                last = None
                for s0, e0 in segs:
                    if last is None or s0 > last:
                        nbp += e0 - s0 + 1
                        last = e0
                    elif e0 > last:
                        nbp += e0 - last
                        last = e0
                if an == "nbp":
                    extra.append(str(nbp))
                else:
                    extra.append("%g" % (nbp / tlen))
            else:
                print(f"annot-tsv: unknown annotation {an!r}", file=sys.stderr)
                return 1
        # empty fields render as '.' (annot-tsv.c write_string)
        cells = [c if c != "" else "." for c in newrow + extra]
        out_lines.append(tgt.delim.join(cells))

    sink = sys.stdout if a.output == "-" else open(a.output, "w")
    for l in out_lines:
        print(l, file=sink)
    if a.output != "-":
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
