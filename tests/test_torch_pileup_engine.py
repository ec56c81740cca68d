"""The port's pileup engine and mpileup entry points against the JAX
package's on the CPU: `mpileup_text(device="cpu")` and
`mpileup_text_parallel(..., nthreads=1-8)` (the plain versions of X4, X5
and B1; the tiles in spawned processes) give the JAX `mpileup_text`'s
bytes, with the JAX native library on and off, on seeded SAM and BAM
files (dense overlapping pairs, multi-contig indel-heavy reads, CG-tag
CIGARs, =/X ops, empty and all-unmapped files, leg 16's mix); and
`Pileup`, `MultiPileup` and `plp_insertion` (with base modifications)
column by column.  BAMs are stored BGZF (level 0): the CPU's plain
inflate takes seconds a deflated member."""
import os
import random
import struct

import numpy as np
import pytest

import htslib_tpu.native
from htslib_tpu import pileup as jp
from htslib_tpu.sam import SamReader as JSamReader
from htslib_tpu.sam.mods import BaseModState as JMods
from htslib_tpu_torch import pileup as tp
from htslib_tpu_torch.bgzf import BgzfWriter
from htslib_tpu_torch.sam.bam import BamWriter, write_bam_header
from htslib_tpu_torch.sam.header import SamHeader
from htslib_tpu_torch.sam.mods import BaseModState as TMods
from htslib_tpu_torch.sam.record import BamRecord, encode_aux
from htslib_tpu_torch.sam.samtext import SamReader as TSamReader
from tests.test_distributed import _synth_paired_sam

THREADS = (1, 2, 3, 5, 8)


@pytest.fixture(scope="module", autouse=True)
def pool():
    """The tiles' process pool at its largest size once for the module,
    stopped at its end."""
    tp.tile_pool(max(THREADS))
    yield
    tp.shutdown_pool()


def multicontig_sam(path, seed=17, contigs=5, lo=30, hi=120):
    """tests/test_pileup.py:223's generator at fewer reads: contigs of
    1 Mbp, reads 20-120 bp, 30% with a 1-4 bp insertion, 20% a 1-8 bp
    deletion."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        f.write("@HD\tVN:1.6\tSO:coordinate\n")
        for c in range(contigs):
            f.write(f"@SQ\tSN:ctg{c}\tLN:1000000\n")
        i = 0
        for c in range(contigs):
            n = int(rng.integers(lo, hi))
            for p in np.sort(rng.integers(1, 2000, n)):
                L = int(rng.integers(20, 120))
                r = rng.random()
                if r < 0.3:
                    a = int(rng.integers(1, L))
                    ins = int(rng.integers(1, 5))
                    cig, qlen = f"{a}M{ins}I{L - a}M", L + ins
                elif r < 0.5:
                    a = int(rng.integers(1, L))
                    d = int(rng.integers(1, 9))
                    cig, qlen = f"{a}M{d}D{L - a}M", L
                else:
                    cig, qlen = f"{L}M", L
                seq = "".join(rng.choice(list("ACGT"), qlen))
                qual = "".join(chr(33 + int(q))
                               for q in rng.integers(5, 40, qlen))
                flag = 16 if rng.random() < 0.4 else 0
                f.write(f"r{i}\t{flag}\tctg{c}\t{p}\t{int(rng.integers(0, 99))}"
                        f"\t{cig}\t*\t0\t0\t{seq}\t{qual}\n")
                i += 1


def edge_ops_sam(path, seed=3):
    """Reads with =/X ops, soft and hard clips, pads, ref skips,
    insertions beside deletions and at a read's ends, MAPQ past 93,
    missing qualities, overlapping proper pairs, and the flags mpileup
    skips (unmapped, secondary, QC-fail, duplicate)."""
    rng = random.Random(seed)
    cigars = [("5=1X4=", 10), ("3S7M", 10), ("2H8M2H", 8), ("4M1P2I4M", 10),
              ("3M50N7M", 10), ("4M2I3D4M", 10), ("2I8M", 10), ("8M2I", 10),
              ("3M2D1P1I3M", 7), ("4M3D", 4), ("1X1=1X1=1X1=", 6),
              ("5M1I1P1I5M", 12), ("6M4N2D4M", 10), ("10M", 10)]
    body = []
    for i in range(160):
        cig, qlen = cigars[i % len(cigars)]
        pos = rng.randrange(1, 400)
        seq = "".join(rng.choice("ACGTN") for _ in range(qlen))
        qual = ("*" if i % 23 == 5 else
                "".join(chr(33 + rng.randrange(0, 45)) for _ in range(qlen)))
        flag = rng.choice([0, 16, 0, 16, 4, 256, 512, 1024, 0])
        mapq = rng.choice([0, 20, 60, 93, 120, 255])
        body.append((pos, f"e{i}\t{flag}\tc1\t{pos}\t{mapq}\t{cig}\t*\t0\t0"
                     f"\t{seq}\t{qual}"))
    for i in range(30):
        pos = rng.randrange(1, 380)
        mpos = pos + rng.randrange(0, 15)
        s1 = "".join(rng.choice("ACGT") for _ in range(20))
        s2 = "".join(rng.choice("ACGT") for _ in range(20))
        q1 = "".join(chr(33 + rng.randrange(0, 40)) for _ in range(20))
        q2 = "".join(chr(33 + rng.randrange(0, 40)) for _ in range(20))
        body.append((pos, f"p{i}\t99\tc1\t{pos}\t60\t8M1D12M\t=\t{mpos}\t"
                     f"{mpos - pos + 20}\t{s1}\t{q1}"))
        body.append((mpos, f"p{i}\t147\tc1\t{mpos}\t60\t10M2I8M\t=\t{pos}\t"
                     f"{pos - mpos - 20}\t{s2}\t{q2}"))
    body.sort(key=lambda x: x[0])
    with open(path, "w") as f:
        f.write("@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:c1\tLN:1000\n")
        f.write("".join(line + "\n" for _, line in body))


def unmapped_sam(path, n=40):
    with open(path, "w") as f:
        f.write("@SQ\tSN:c1\tLN:1000\n")
        for i in range(n):
            f.write(f"u{i}\t4\t*\t0\t0\t*\t*\t0\t0\tACGT\tIIII\n")


def empty_sam(path):
    with open(path, "w") as f:
        f.write("@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:c1\tLN:1000\n")


def leg16_sam(path):
    """chip_smoke's leg 16 reads over 3 kb and 600 bp at 30x."""
    from chip_smoke import leg16_records
    header, recs = leg16_records([("chr1", 3000), ("chr2", 600)])
    with open(path, "w") as f:
        f.write(header.text)
        f.write("".join(b.to_sam(header) + "\n" for b in recs))


def sam_to_bam(sam, bam):
    """A SAM file rewritten as a stored-BGZF BAM by the port's writer."""
    r = TSamReader(sam)
    with BamWriter(bam, r.header, level=0) as w:
        for rec in iter(r.read1, None):
            w.write(rec)
    r.fp.close()


def cg_bam(path, sam_path=None):
    """A BAM (stored BGZF) whose records include one whose CIGAR sits in
    a CG tag (a 10S2006N placeholder; bam_tag2cigar promotes
    4M2000N6M), among dense pairs; its SAM twin at `sam_path`."""
    from htslib_tpu_torch.sam.bam import BamReader
    tmp = path + ".src.sam"
    _synth_paired_sam(tmp, n_pairs=60, seed=5)
    r = TSamReader(tmp)
    hdr = r.header
    recs = list(iter(r.read1, None))
    cg = BamRecord()
    cg.qname, cg.tid, cg.pos, cg.flag, cg.mapq = b"cg", 0, 99, 0, 40
    cg.set_seq("ACGTACGTAC", bytes(range(10, 20)))
    cg.cigar = np.array([(10 << 4) | 4, (2006 << 4) | 3], np.uint32)
    cg.aux = encode_aux(b"CG", "B", ("I", np.array(
        [(4 << 4) | 0, (2000 << 4) | 3, (6 << 4) | 0], np.uint32)))
    recs.append(cg)
    recs.sort(key=lambda b: b.pos)
    with BgzfWriter(path, level=0) as w:
        write_bam_header(w, hdr)
        for b in recs:
            body = b.to_bam_buffer()
            w.write(struct.pack("<I", len(body)) + body)
    if sam_path:
        with BamReader(path) as br, open(sam_path, "w") as f:
            f.write(hdr.text)
            for b in iter(br.read1, None):
                f.write(b.to_sam(hdr) + "\n")


def _make(kind, tmp):
    sam = os.path.join(tmp, kind + ".sam")
    bam = os.path.join(tmp, kind + ".bam")
    if kind == "cg":
        cg_bam(bam, sam)
        return sam, bam
    {"dense": lambda p: _synth_paired_sam(p, n_pairs=200, seed=11),
     "multicontig": multicontig_sam, "edge_ops": edge_ops_sam,
     "unmapped": unmapped_sam, "empty": empty_sam,
     "leg16": leg16_sam}[kind](sam)
    sam_to_bam(sam, bam)
    return sam, bam


KINDS = ["dense", "multicontig", "edge_ops", "cg", "unmapped", "empty",
         "leg16"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("plp"))
    return {k: _make(k, tmp) for k in KINDS}


def _jax_text(path, native_on):
    if native_on:
        return jp.mpileup_text(path)[1]
    saved = htslib_tpu.native.native
    htslib_tpu.native.native = None
    try:
        return jp.mpileup_text(path)[1]
    finally:
        htslib_tpu.native.native = saved


@pytest.fixture(scope="module")
def jax_texts(files):
    """The JAX mpileup_text of every file, native on and off."""
    return {(k, fmt, on): _jax_text(files[k][fmt == "bam"], on)
            for k in KINDS for fmt in ("sam", "bam") for on in (True, False)}


@pytest.mark.parametrize("fmt", ["sam", "bam"])
@pytest.mark.parametrize("kind", KINDS)
def test_mpileup_text_matches_jax(files, jax_texts, kind, fmt):
    path = files[kind][fmt == "bam"]
    timing = {}
    _, got = tp.mpileup_text(path, device="cpu", timing=timing)
    on, off = jax_texts[(kind, fmt, True)], jax_texts[(kind, fmt, False)]
    if kind == "cg" and fmt == "bam":
        # the JAX native path bails on the CG record after its reader has
        # read the stream whole: its Python engine then reads nothing
        # (ROADMAP queue C); the port gives the Python path's text
        assert on == b"" and off != b""
    else:
        assert on == off
    assert got == off
    assert timing["entries"] == sum(int(ln.split(b"\t")[2])
                                    for ln in got.split(b"\n") if ln)
    if kind not in ("empty", "unmapped"):
        assert got and timing["columns"] == got.count(b"\n")


@pytest.mark.parametrize("nthreads", THREADS)
@pytest.mark.parametrize("kind", KINDS)
def test_mpileup_text_parallel_matches_jax(files, jax_texts, kind,
                                           nthreads):
    for fmt in ("bam", "sam"):
        timing, stages = {}, {}
        _, got = tp.mpileup_text_parallel(files[kind][fmt == "bam"],
                                          nthreads, device="cpu",
                                          timing=timing, stages=stages)
        assert got == jax_texts[(kind, fmt, False)], fmt
        if kind == "cg" and fmt == "bam":
            continue
        assert got == jax_texts[(kind, fmt, True)], fmt
    mapped = ((stages["flag"] & tp.DEFAULT_SKIP) == 0) & (
        stages["tid"] >= 0) & ((stages["flag"] & 4) == 0)
    if nthreads > 1 and mapped.any():
        assert timing["tiles"] == len(stages["tiles"])
        assert timing["processes"] == nthreads and "pool_s" in timing


def test_jax_parallel_raises_on_cg_where_port_answers(files, jax_texts):
    """The JAX mpileup_text_parallel hands a stream with a CG-tag record
    to its native engine, which bails: BlockingIOError (ROADMAP queue C).
    The port has no native engine and reads the record through
    bam_tag2cigar."""
    with pytest.raises(BlockingIOError):
        jp.mpileup_text_parallel(files["cg"][1], nthreads=3)
    _, got = tp.mpileup_text_parallel(files["cg"][1], 3, device="cpu")
    assert got == jax_texts[("cg", "bam", False)] and b">" in got


def test_plan_tiles_cover_the_key_space(files):
    """The tile plan from the decoded fields: every tile's window is
    contiguous and the windows cover the key space in order."""
    stages = {}
    tp.mpileup_text_parallel(files["multicontig"][1], 5, device="cpu",
                             stages=stages)
    tiles = stages["tiles"]
    assert tiles[0][0][0] == tp._KEY_LO and tiles[-1][0][1] == tp._KEY_HI
    for (w0, _), (w1, _) in zip(tiles, tiles[1:]):
        assert w0[1] == w1[0]
    assert all(r is not None and r[0] <= r[1] for _, r in tiles)


def test_cuda_without_a_card_raises(files):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.mpileup_text(files["dense"][1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.mpileup_text_parallel(files["dense"][1], 2)


def test_truncated_stream_raises(tmp_path, files):
    from htslib_tpu_torch.sam.batch import read_bam_stream
    _, stream = read_bam_stream(files["dense"][1], "cpu")
    with pytest.raises(IOError, match="truncated"):
        tp.decode_records(stream[:-7], "cpu")
    rs = tp.decode_records(stream, "cpu")
    assert rs["offs"][0] == 0 and len(rs["offs"]) == 400


def test_decoded_bases_equal_the_host_decode(files):
    """B1's plain version over every record's packed bases equals
    BamRecord.seq (the pad nibble of an odd length included)."""
    from htslib_tpu_torch.sam.batch import read_bam_stream
    for kind in ("edge_ops", "leg16", "multicontig"):
        _, stream = read_bam_stream(files[kind][1], "cpu")
        rs = tp.decode_records(stream, "cpu")
        mv = memoryview(stream)
        for i in range(len(rs["offs"])):
            b = BamRecord.from_bam_buffer(mv, int(rs["offs"][i]) + 4,
                                          int(rs["sizes"][i]))
            at = int(rs["base_offs"][i])
            got = rs["bases"][at:at + b.l_qseq].decode()
            assert got == (b.seq if b.l_qseq else ""), (kind, i)
            assert (rs["tid"][i], rs["pos"][i], rs["flag"][i]) == (
                b.tid, b.pos, b.flag)
            assert rs["end"][i] == b.endpos()


def _signature(col, ins_fn, mods=None):
    """A pileup column as comparable values: each read's name, cursor,
    flags, indel, CIGAR index, base, (tweaked) quality and insertion."""
    tid, pos, plp = col
    out = []
    for p in plp:
        q = p.b.qual[p.qpos] if p.qpos < p.b.l_qseq else None
        base = p.b.seq[p.qpos] if not p.is_del else None
        out.append((p.b.qname, p.qpos, p.is_del, p.is_refskip, p.is_head,
                    p.is_tail, p.indel, p.cigar_ind, base, q,
                    ins_fn(p, mods)))
    return tid, pos, out


def _reads(path, reader_cls, skip=tp.DEFAULT_SKIP):
    r = reader_cls(path)
    recs = [b for b in iter(r.read1, None) if not b.flag & skip]
    return recs


@pytest.mark.parametrize("overlaps", [False, True])
@pytest.mark.parametrize("kind", ["dense", "edge_ops", "multicontig",
                                  "leg16"])
def test_pileup_columns_match_jax(files, kind, overlaps):
    sam = files[kind][0]
    mine = iter(_reads(sam, TSamReader) + [None])
    theirs = iter(_reads(sam, JSamReader) + [None])
    got = [_signature(c, tp.plp_insertion)
           for c in tp.Pileup(lambda: next(mine), overlaps=overlaps)]
    want = [_signature(c, jp.plp_insertion)
            for c in jp.Pileup(lambda: next(theirs), overlaps=overlaps)]
    assert got == want and len(got) > 10


def test_multipileup_matches_jax(files):
    """Three samples in locus lock-step (bam_mplp), overlaps on."""
    paths = [files[k][0] for k in ("dense", "edge_ops", "leg16")]

    def funcs(reader_cls):
        its = [iter(_reads(p, reader_cls) + [None]) for p in paths]
        return [lambda it=it: next(it) for it in its]

    mp_t = tp.MultiPileup(funcs(TSamReader), overlaps=True)
    mp_j = jp.MultiPileup(funcs(JSamReader), overlaps=True)
    n = 0
    while True:
        a, b = mp_t.auto(), mp_j.auto()
        if a is None or b is None:
            assert a is None and b is None
            break
        assert a[:2] == b[:2]
        for pa, pb in zip(a[2], b[2]):
            assert (pa is None) == (pb is None)
            if pa is not None:
                sa = _signature((a[0], a[1], pa), tp.plp_insertion)
                sb = _signature((b[0], b[1], pb), jp.plp_insertion)
                assert sa == sb
        n += 1
    assert n > 100


def test_plp_insertion_with_mods_matches_jax(tmp_path):
    """Insertions of reads carrying MM/ML base modifications, each
    package given its own BaseModState: the same strings (neither writes
    the modifications)."""
    sam = str(tmp_path / "mods.sam")
    rng = random.Random(9)
    with open(sam, "w") as f:
        f.write("@SQ\tSN:c1\tLN:1000\n")
        for i in range(40):
            pos = 10 + i
            seq = "".join(rng.choice("ACGT") for _ in range(20))
            ncs = seq.count("C")
            ml = ",".join(str(rng.randrange(256)) for _ in range(ncs))
            tags = (f"\tMM:Z:C+m,{','.join(['0'] * ncs)};\tML:B:C,{ml}"
                    if ncs else "")
            f.write(f"m{i}\t{16 if i % 3 == 0 else 0}\tc1\t{pos}\t60\t"
                    f"6M4I4M2D6M\t*\t0\t0\t{seq}\t{'I' * 20}{tags}\n")

    def ins_with(mods_cls):
        def fn(p, _):
            st = mods_cls()
            st.parse(p.b)
            return tp.plp_insertion(p, st) if mods_cls is TMods else \
                jp.plp_insertion(p, st)
        return fn

    mine = iter(_reads(sam, TSamReader) + [None])
    theirs = iter(_reads(sam, JSamReader) + [None])
    got = [_signature(c, ins_with(TMods))
           for c in tp.Pileup(lambda: next(mine))]
    want = [_signature(c, ins_with(JMods))
            for c in jp.Pileup(lambda: next(theirs))]
    assert got == want
    assert any(s[-1][0] for _, _, col in got for s in col)


def test_seq_text_cache_follows_seq4():
    """A record's cached bases: seq returns them, copy() keeps them, and
    setting seq4 (set_seq too) clears them."""
    b = BamRecord()
    b.set_seq("ACGTN", b"\x10" * 5)
    assert b.seq == "ACGTN" and b.seq_text is None
    b.seq_text = "ACGTN"
    c = b.copy()
    assert c.seq_text == "ACGTN" and c.seq == "ACGTN"
    c.seq4 = bytes([0x88, 0x42, 0x10])
    assert c.seq_text is None and c.seq == "TTGCA"
    assert b.seq == "ACGTN"
    b.set_seq("GG")
    assert b.seq_text is None and b.seq == "GG"


def test_smallest_cg_bam_of_the_jax_paths(tmp_path):
    """The smallest input on which the JAX package's two mpileup paths
    differ (ROADMAP queue C): a BAM of one record whose CIGAR (4M1N6M)
    sits in a CG tag behind a 10S7N placeholder.  The JAX native path
    bails after its reader has read the stream, so its Python engine
    reads no record and the text is empty; its Python path, and the
    port, give the 11 columns."""
    path = str(tmp_path / "cg1.bam")
    cg = BamRecord()
    cg.qname, cg.tid, cg.pos, cg.flag, cg.mapq = b"cg", 0, 9, 0, 40
    cg.set_seq("ACGTACGTAC", bytes(range(10, 20)))
    cg.cigar = np.array([(10 << 4) | 4, (7 << 4) | 3], np.uint32)
    cg.aux = encode_aux(b"CG", "B", ("I", np.array(
        [(4 << 4) | 0, (1 << 4) | 3, (6 << 4) | 0], np.uint32)))
    with BgzfWriter(path, level=0) as w:
        write_bam_header(w, SamHeader("@SQ\tSN:c1\tLN:100\n"))
        body = cg.to_bam_buffer()
        w.write(struct.pack("<I", len(body)) + body)
    assert _jax_text(path, True) == b""
    want = _jax_text(path, False)
    assert want.count(b"\n") == 11 and b"\t>\t" in want
    assert tp.mpileup_text(path, device="cpu")[1] == want
    assert tp.mpileup_text_parallel(path, 2, device="cpu")[1] == want
