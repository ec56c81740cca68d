"""The port's coordinate-sharded mpileup (htslib_tpu_torch/parallel/
pileup_shard.py) against the JAX package's: tile plans at 1-8 shards
compared tile by tile, `mpileup_one_tile` on tiles the JAX function
planned (`carry.from_jax_pileup_tiles`) line for line, `sharded_mpileup`
whose concatenated tiles equal the JAX single engine, and two gloo ranks
(tests/torch_ranks.py) each running one tile.  Records are read as the
port's mpileup reads them, on the CPU (the plain versions of X4, X5 and
B1); BAMs are stored BGZF."""
import os

import pytest

from htslib_tpu import pileup as jp
from htslib_tpu.parallel import pileup_shard as js
from htslib_tpu_torch import carry
from htslib_tpu_torch.parallel import pileup_shard as ts
from htslib_tpu_torch.parallel.launch import run_ranks
from htslib_tpu_torch.pileup import _format_plp_column
from tests import torch_ranks
from tests.test_distributed import _synth_paired_sam
from tests.test_pileup import format_column
from tests.test_torch_pileup_engine import (leg16_sam, multicontig_sam,
                                            sam_to_bam)

NS = (1, 2, 3, 4, 5, 8)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("plp_shard"))
    out = {}
    for name, make in (("dense", lambda p: _synth_paired_sam(
            p, n_pairs=150, seed=7)), ("multicontig", multicontig_sam),
            ("leg16", leg16_sam)):
        sam = os.path.join(d, name + ".sam")
        make(sam)
        out[name + ".sam"] = sam
        if name != "dense":
            sam_to_bam(sam, os.path.join(d, name + ".bam"))
            out[name + ".bam"] = os.path.join(d, name + ".bam")
    return out


@pytest.fixture(scope="module")
def wants(files):
    """The JAX single engine's text (MultiPileup order = Pileup order,
    overlaps on) of every file, through its Python path."""
    import htslib_tpu.native
    saved = htslib_tpu.native.native
    htslib_tpu.native.native = None
    try:
        return {k: jp.mpileup_text(p)[1] for k, p in files.items()}
    finally:
        htslib_tpu.native.native = saved


FILES = ["dense.sam", "multicontig.sam", "multicontig.bam", "leg16.sam",
         "leg16.bam"]


def _same_tiles(mine, theirs):
    assert [(t.index, t.lo, t.hi) for t in mine] == [
        (t.index, tuple(t.lo), tuple(t.hi)) for t in theirs]


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("name", FILES)
def test_tile_plans_match_jax(files, name, n):
    path = files[name]
    _, mine = ts._load_records(path, device="cpu")
    _, theirs = js._load_records(path)
    _same_tiles(ts.plan_pileup_tiles(mine, n),
                js.plan_pileup_tiles(theirs, n))
    assert [(r.qname, r.pos, r.flag) for r in mine] == [
        (r.qname, r.pos, r.flag) for r in theirs]


@pytest.mark.parametrize("n", [2, 5])
@pytest.mark.parametrize("name", ["dense.sam", "multicontig.bam",
                                  "leg16.bam"])
def test_one_tile_on_jax_plans(files, wants, name, n):
    """Each tile of the JAX plan, run by the port's mpileup_one_tile,
    equals the JAX function's tile; together they are the single
    engine's text."""
    path = files[name]
    _, theirs = js._load_records(path)
    tiles = js.plan_pileup_tiles(theirs, n)
    parts = []
    for t, mine in zip(tiles, carry.from_jax_pileup_tiles(tiles)):
        got = ts.mpileup_one_tile(path, mine, _format_plp_column, "cpu")
        assert got == js.mpileup_one_tile(path, t, format_column)
        parts += got
    assert ("\n".join(parts) + "\n" if parts else "").encode() == \
        wants[name]


@pytest.mark.parametrize("n", NS)
def test_sharded_mpileup_equals_single_engine(files, wants, n):
    for name in FILES:
        parts = ts.sharded_mpileup(files[name], n, _format_plp_column,
                                   "cpu")
        got = "\n".join(ln for part in parts for ln in part)
        assert (got + "\n" if got else "").encode() == wants[name], name
        _, recs = ts._load_records(files[name], device="cpu")
        assert len(parts) == len(ts.plan_pileup_tiles(recs, n))


def test_tiles_keep_the_halo_reads(files):
    """A read spanning a tile boundary is in both tiles' read sets, and
    each tile gets fresh records (the tweak mutates the copies the engine
    makes, never the loaded records)."""
    header, recs = ts._load_records(files["leg16.bam"], device="cpu")
    tiles = ts.plan_pileup_tiles(recs, 4)
    quals = [r.qual for r in recs]
    sets = [ts.reads_for_tile(recs, t) for t in tiles]
    spanning = [r for r in recs if any(
        (r.tid, r.pos) < t.lo < (r.tid, ts.record_endpos(r))
        for t in tiles[1:])]
    assert spanning
    for r in spanning:
        assert sum(any(x is r for x in s) for s in sets) >= 2
    for s, t in zip(sets, tiles):
        ts.pileup_tile_columns(s, t, _format_plp_column, header)
    assert [r.qual for r in recs] == quals


def test_two_gloo_ranks_one_tile_each(files, wants):
    out = run_ranks(torch_ranks.pileup_tile, 2,
                    args=(files["leg16.bam"],), timeout=240)
    lines = out[0][0] + out[1][0]
    assert out[0][1] == out[1][1] == len(lines)
    assert ("\n".join(lines) + "\n").encode() == wants["leg16.bam"]
