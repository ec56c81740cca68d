"""The port's binning index (htslib_tpu_torch/index.py) against the JAX
package's (htslib_tpu/index.py): the bin arithmetic and
`adjust_csi_settings`, `parse_decimal`, the `parse_region` battery of
tests/test_index.py (test/test-parse-reg.c), and `HtsIndex` built from
seeded intervals as BAI, as CSI (min_shift 14, and 12 with a reference
past 2^29) and as TBI: the saved files, the loaded indexes, and
`query_chunks` on 200 seeded regions, with `get_stat`, `nocoor_offset`
and `n_no_coor`.

The intervals are records of sorted references with ends 1-5,000 bases
past their starts, a few unmapped but placed, then unplaced reads; their
virtual offsets walk seeded member sizes, so chunks cross members and
some end in the (next member, 0) form.  CSI and TBI files are BGZF: they
are compared with the JAX writer on its pure-Python path
(`htslib_tpu.native.native` None).  Equality is exact."""
import struct

import numpy as np
import pytest

from htslib_tpu import index as jidx
from htslib_tpu_torch import index as tidx
from htslib_tpu_torch.sam import cigar as tcigar

# -- bin arithmetic ----------------------------------------------------------


def test_bin_arithmetic_matches_jax():
    rng = np.random.default_rng(1)
    for lvl in range(10):
        assert tidx.bin_first(lvl) == jidx.bin_first(lvl)
    for b in list(range(0, 4681 + 32768, 97)) + [0, 1, 8, 9, 72, 73, 584]:
        assert tidx.bin_parent(b) == jidx.bin_parent(b)
        assert tidx.bin_level(b) == jidx.bin_level(b)
        assert tidx.bin_bot(b, 5) == jidx.bin_bot(b, 5)
    for ms, nl in ((14, 5), (12, 6), (14, 7), (16, 9)):
        assert tidx.bin_maxpos(ms, nl) == jidx.bin_maxpos(ms, nl)
        top = tidx.bin_maxpos(ms, nl)
        for _ in range(200):
            beg = int(rng.integers(0, top))
            end = beg + int(rng.integers(1, 1 << int(rng.integers(1, 24))))
            assert tcigar.reg2bin(beg, end, ms, nl) == jidx.reg2bin(
                beg, end, ms, nl)
            assert tidx.reg2bins(beg, end, ms, nl) == jidx.reg2bins(
                beg, end, ms, nl)
    # the index's reg2bin is sam/cigar.py's
    assert tidx.reg2bin is tcigar.reg2bin


@pytest.mark.parametrize("max_len,ms,nl", [
    (100_000, 14, 5), (2_000_000_000, 14, 5), (1 << 43, 14, 5),
    ((1 << 29) - 256, 14, 5), ((1 << 29) - 255, 14, 5), (1 << 31, 12, 5),
    (1 << 50, 18, 3), (0, 14, 5)])
def test_adjust_csi_settings_matches_jax(max_len, ms, nl, capsys):
    got = tidx.adjust_csi_settings(max_len, ms, nl)
    t_err = capsys.readouterr().err
    assert got == jidx.adjust_csi_settings(max_len, ms, nl)
    assert t_err == capsys.readouterr().err


def test_parse_decimal_matches_jax():
    cases = ["0", "12", " 42x", "-7", "+9", "1,000,000", "1.5k", "2.25M",
             "3G", "1e3", "15e2", "1.5e3", "1E-2", "7.", ".5k", "abc", "",
             "12,3", "1k5", "9e", "-1,234.5e1", "4m", "0.000001G"]
    for s in cases:
        for flags in (0, tidx.HTS_PARSE_THOUSANDS_SEP):
            assert tidx.parse_decimal(s, flags) == jidx.parse_decimal(
                s, flags), (s, flags)


NAMES = ["chr1", "chr1:100", "chr1:100-200", "chr2:100-200", "chr3",
         "chr1,chr3"]
M = tidx.HTS_POS_MAX
L, OC = tidx.HTS_PARSE_LIST, tidx.HTS_PARSE_ONE_COORD
REGIONS = [
    ("chr1", 0, (0, 0, M)), ("chr1:50", 0, (0, 49, M)),
    ("chr1:50", OC, (0, 49, 50)), ("chr1:50-100", 0, (0, 49, 100)),
    ("chr1:50-", 0, (0, 49, M)), ("chr1:-50", 0, (0, 0, 50)),
    ("chr1:100-200", 0, None),
    ("{chr1}:100-200", 0, (0, 99, 200)),
    ("{chr1:100-200}", 0, (2, 0, M)),
    ("{chr1:100-200}:100-200", 0, (2, 99, 200)),
    ("{chr2:100-200}:100-200", 0, (3, 99, 200)),
    ("chr2:100-200:100-200", 0, (3, 99, 200)),
    ("chr2:100-200", 0, (3, 0, M)),
    ("chr3", 0, (4, 0, M)), ("chr3:", 0, (4, 0, M)),
    ("chr3:1000-1500", 0, (4, 999, 1500)),
    ("chr3:1,000-1,500", 0, (4, 999, 1500)),
    ("chr3:1k-1.5K", 0, (4, 999, 1500)),
    ("chr3:1e3-1.5e3", 0, (4, 999, 1500)),
    ("chr3:1e3-15e2", 0, (4, 999, 1500)),
    ("chr1,chr3", L, (0, 0, M)),
    ("chr1:100-200,chr3", L, None),
    ("{chr1,chr3}", L, (5, 0, M)),
    ("{chr1,chr3},chr1", L, (5, 0, M)),
    ("chr3:1,000-1,500", L | OC, (4, 0, 1)),
    ("chr2", 0, None), ("chr1,", 0, None), ("{chr1", 0, None),
    ("chr1:10-10", 0, (0, 9, 10)),
    ("chr1:10-9", 0, None),
    ("chr1:x", 0, None), ("chr1:1-y", 0, None),
    ("chr1:1,chr3", 0, None),
    ("*", 0, (tidx.HTS_IDX_NOCOOR, 0, 0)), (".", 0, (tidx.HTS_IDX_REST, 0, 0)),
]


def _n2i(s):
    try:
        return NAMES.index(s)
    except ValueError:
        return -1


@pytest.mark.parametrize("reg,flags,want", REGIONS,
                         ids=[f"{r}|{f}" for r, f, _ in REGIONS])
def test_parse_region_matches_jax(reg, flags, want):
    got = tidx.parse_region(reg, _n2i, flags)
    assert got == jidx.parse_region(reg, _n2i, flags)
    if want is None:
        assert got is None
    else:
        assert got is not None and got[:3] == want


# -- HtsIndex --------------------------------------------------------------


def intervals(seed, lens, n=3000, nocoor=40):
    """Seeded records (tid, beg, end, voffset after it, mapped): sorted
    references and starts, spans of 1-5,000, every 17th unmapped but
    placed, then `nocoor` unplaced ones; the offsets walk seeded member
    sizes of 40-200 records' bytes."""
    rng = np.random.default_rng(seed)
    per = rng.multinomial(n, np.asarray(lens, float) / sum(lens))
    recs = []
    for tid, (k, ln) in enumerate(zip(per, lens)):
        starts = np.sort(rng.integers(0, max(ln - 5000, 1), k))
        for i, s in enumerate(starts.tolist()):
            span = int(rng.integers(1, 5001))
            recs.append((tid, s, s + span, i % 17 != 5))
    recs += [(-1, -1, 0, False)] * nocoor
    caddr, inblock, out = 0, 0, []
    for i, (tid, beg, end, mapped) in enumerate(recs):
        inblock += int(rng.integers(150, 400))
        if inblock >= 0xFF00:
            caddr += int(rng.integers(8_000, 30_000))
            # a record ending a member is offset (next member, 0)
            inblock = 0 if rng.random() < 0.5 else inblock - 0xFF00
        out.append((tid, beg, end, (caddr << 16) | inblock, mapped))
    return out


def build(mod, recs, fmt, ms, nl, nref, meta=b"", start=0x1234):
    idx = mod.HtsIndex(nref, fmt, ms, nl)
    idx._last_off = idx._save_off = idx._off_beg = idx._off_end = start
    last = start
    for tid, beg, end, off, mapped in recs:
        idx.push(tid, beg, end, off, mapped)
        last = off
    idx.finish(last)
    if meta:
        idx.meta = meta
    return idx


TBI_META = struct.pack("<6i", 2, 1, 2, 0, ord("#"), 0)
CASES = {
    "bai": (tidx.HTS_FMT_BAI, 14, 5, [200_000_000, 5_000_000, 80_000], b""),
    "csi14": (tidx.HTS_FMT_CSI, 14, 5, [200_000_000, 5_000_000, 80_000],
              b""),
    "csi12_long": (tidx.HTS_FMT_CSI, 12, None, [(1 << 29) + 7_000_000,
                                                3_000_000], b"meta!"),
    "tbi": (tidx.HTS_FMT_TBI, 14, 5, [60_000_000, 250_000],
            TBI_META + struct.pack("<I", 8) + b"c1\0c2\0\0\0"),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def built(request, tmp_path_factory):
    name = request.param
    fmt, ms, nl, lens, meta = CASES[name]
    if nl is None:
        ms, nl = tidx.adjust_csi_settings(max(lens), ms, 5)
        assert nl > 5
    recs = intervals(len(name) * 7 + fmt, lens,
                     nocoor=0 if fmt == tidx.HTS_FMT_TBI else 40)
    d = tmp_path_factory.mktemp(name)
    mp = pytest.MonkeyPatch()
    mp.setattr("htslib_tpu.native.native", None)
    mp.setattr("htslib_tpu_torch.native.native", None)
    try:
        t = build(tidx, recs, fmt, ms, nl, len(lens), meta)
        j = build(jidx, recs, fmt, ms, nl, len(lens), meta)
        t.save(str(d / "t.idx"))
        j.save(str(d / "j.idx"))
    finally:
        mp.undo()
    return {"name": name, "lens": lens, "recs": recs, "t": t, "j": j,
            "dir": d}


def _same_index(a, b, loff=True):
    assert (a.fmt, a.min_shift, a.n_lvls, a.n, a.meta, a.n_no_coor) == (
        b.fmt, b.min_shift, b.n_lvls, b.n, b.meta, b.n_no_coor)
    assert a.lidx == b.lidx
    for x, y in zip(a.bidx, b.bidx):
        assert (x is None) == (y is None)
        if x is not None:
            assert list(x) == list(y)
            assert [(e.loff if loff else 0, e.chunks) for e in x.values()
                    ] == [(e.loff if loff else 0, e.chunks)
                          for e in y.values()]


def test_index_file_matches_jax(built):
    d = built["dir"]
    with open(d / "t.idx", "rb") as a, open(d / "j.idx", "rb") as b:
        assert a.read() == b.read()
    _same_index(built["t"], built["j"])
    # each side loads the other's file as its own (a BAI or TBI keeps no
    # bin's loff on disk)
    t2 = tidx.HtsIndex.load(str(d / "j.idx"))
    j2 = jidx.HtsIndex.load(str(d / "t.idx"))
    _same_index(t2, j2)
    _same_index(t2, built["j"], loff=built["t"].fmt == tidx.HTS_FMT_CSI)


def regions(seed, recs, lens, n=200):
    """Seeded regions (tid, beg, end), half near a record's start, half
    anywhere, references -1 to len(lens) (the ends unknown), 1 base to
    3 Mbp long."""
    rng = np.random.default_rng(seed)
    placed = [r for r in recs if r[0] >= 0]
    out = []
    for k in range(n):
        if k % 2:
            tid, b = placed[int(rng.integers(0, len(placed)))][:2]
            beg = b - int(rng.integers(0, 5000))
        else:
            tid = int(rng.integers(-1, len(lens) + 1))
            ln = lens[tid] if 0 <= tid < len(lens) else 1000
            beg = int(rng.integers(-10, ln + 10_000))
        out.append((tid, beg, beg + int(np.exp(rng.uniform(
            0, np.log(3_000_000))))))
    return out


def test_query_chunks_match_jax(built):
    d = built["dir"]
    t = tidx.HtsIndex.load(str(d / "t.idx"))
    j = jidx.HtsIndex.load(str(d / "j.idx"))
    hits = 0
    for tid, beg, end in regions(5, built["recs"], built["lens"]):
        got = t.query_chunks(tid, beg, end)
        assert got == j.query_chunks(tid, beg, end)
        assert built["t"].query_chunks(tid, beg, end) == built[
            "j"].query_chunks(tid, beg, end)
        hits += bool(got)
    assert hits > 100
    for a, b in ((t, j), (built["t"], built["j"])):
        for tid in range(-1, len(built["lens"]) + 1):
            try:
                want = b.get_stat(tid)
            except KeyError:
                with pytest.raises(KeyError):
                    a.get_stat(tid)
                continue
            assert a.get_stat(tid) == want
        assert a.nocoor_offset() == b.nocoor_offset()
        assert a.get_n_no_coor() == b.get_n_no_coor() == sum(
            r[0] < 0 for r in built["recs"])


def test_stats_count_mapped_and_placed_unmapped(built):
    recs = built["recs"]
    for tid in range(len(built["lens"])):
        mine = [r for r in recs if r[0] == tid]
        if not mine:
            with pytest.raises(KeyError):
                built["t"].get_stat(tid)
            continue
        assert built["t"].get_stat(tid) == (sum(r[4] for r in mine),
                                            sum(not r[4] for r in mine))


def test_load_without_n_no_coor(tmp_path):
    """The trailing n_no_coor word is optional on load."""
    recs = intervals(3, [100_000], n=200, nocoor=0)
    t = build(tidx, recs, tidx.HTS_FMT_BAI, 14, 5, 1)
    t.save(str(tmp_path / "a.bai"))
    raw = open(tmp_path / "a.bai", "rb").read()
    open(tmp_path / "b.bai", "wb").write(raw[:-8])
    a = tidx.HtsIndex.load(str(tmp_path / "b.bai"))
    b = jidx.HtsIndex.load(str(tmp_path / "b.bai"))
    assert a.n_no_coor == b.n_no_coor == 0
    assert a.query_chunks(0, 0, 50_000) == b.query_chunks(0, 0, 50_000)


@pytest.mark.parametrize("bad", ["unsorted", "gap", "nocoor_middle",
                                 "end_before_beg", "too_far"])
def test_push_refuses_as_jax(bad):
    recs = {
        "unsorted": [(0, 100, 200), (0, 50, 60)],
        "gap": [(0, 1, 2), (1, 1, 2), (0, 5, 6)],
        "nocoor_middle": [(0, 1, 2), (-1, -1, 0), (1, 5, 6)],
        "end_before_beg": [(0, 100, 50)],
        "too_far": [(0, 1 << 30, (1 << 30) + 5)],
    }[bad]
    msgs = []
    for mod in (tidx, jidx):
        idx = mod.HtsIndex(2, mod.HTS_FMT_BAI, 14, 5)
        with pytest.raises(ValueError) as e:
            for i, (tid, beg, end) in enumerate(recs):
                idx.push(tid, beg, end, (i + 1) << 16, True)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_iterator_matches_jax():
    """HtsIterator over a list of (voffset, record) lines: the chunks'
    records that overlap the region, stopping past its end."""
    recs = [(0, b, b + 30) for b in range(0, 3000, 7)]

    class Fp:
        def __init__(self):
            self.i = 0

        def seek(self, v):
            self.i = v >> 16

        def tell(self):
            return self.i << 16

    def readrec(fp):
        if fp.i >= len(recs):
            return None
        tid, b, e = recs[fp.i]
        fp.i += 1
        return (fp.i - 1, tid, b, e)

    chunks = [(10 << 16, 40 << 16), (60 << 16, 200 << 16)]
    out = []
    for mod in (tidx, jidx):
        it = mod.HtsIterator(chunks, 0, 500, 900, readrec, Fp())
        out.append(list(it))
        rest = mod.HtsIterator([], -4, 0, 0, readrec, Fp(), read_rest=True,
                               curr_off=400 << 16)
        out.append(list(rest))
    assert out[0] == out[2] and out[1] == out[3]
    assert out[0] and out[1] == list(range(400, len(recs)))
