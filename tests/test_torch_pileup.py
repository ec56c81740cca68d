"""The port's pileup tiles (htslib_tpu_torch/ops/pileup_kernel.py) against
the JAX package's pileup_kernel and brute force.  Integer counts:
equality is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htslib_tpu.ops import pileup_kernel as jpk
from htslib_tpu.sam.cigar import parse_cigar
from htslib_tpu.sam.record import BamRecord
from htslib_tpu_torch.ops import pileup_kernel as tpk


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX reference runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("tile_start", [0, 300])
def test_coverage_tile_matches_jax_and_brute(tile_start):
    rng = np.random.default_rng(0)
    tile_len = 1024
    starts = rng.integers(-50, 1400, 200).astype(np.int32)
    ends = (starts + rng.integers(1, 150, 200)).astype(np.int32)
    valid = rng.random(200) > 0.2
    got = tpk.coverage_tile(torch.from_numpy(starts), torch.from_numpy(ends),
                            torch.from_numpy(valid), tile_start, tile_len)
    want = np.asarray(jpk.coverage_tile(jnp.asarray(starts),
                                        jnp.asarray(ends),
                                        jnp.asarray(valid),
                                        jnp.int32(tile_start), tile_len))
    brute = np.zeros(tile_len, np.int64)
    for s, e, v in zip(starts, ends, valid):
        if v:
            lo = min(max(s - tile_start, 0), tile_len)
            hi = min(max(e - tile_start, 0), tile_len)
            brute[lo:hi] += 1
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), brute)


def test_basecount_tile_matches_jax_and_brute():
    rng = np.random.default_rng(1)
    tile_start, tile_len = 100, 500
    pos = rng.integers(0, 700, 3000).astype(np.int32)
    codes = rng.integers(0, 16, 3000).astype(np.int32)
    valid = rng.random(3000) > 0.1
    got = tpk.basecount_tile(torch.from_numpy(pos), torch.from_numpy(codes),
                             torch.from_numpy(valid), tile_start, tile_len)
    want = np.asarray(jpk.basecount_tile(jnp.asarray(pos), jnp.asarray(codes),
                                         jnp.asarray(valid),
                                         jnp.int32(tile_start), tile_len))
    brute = np.zeros((tile_len, 16), np.int64)
    for p, c, v in zip(pos, codes, valid):
        if v and tile_start <= p < tile_start + tile_len:
            brute[p - tile_start, c] += 1
    assert got.shape == (tile_len, 16) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(got.numpy(), brute)


def _records(seed=2, n=60):
    rng = np.random.default_rng(seed)
    cigars = ["50M", "10M5I35M", "20M10D30M", "5S40M5S", "15M100N35M",
              "25M2D10M3I12M", "50="]
    recs = []
    for i in range(n):
        r = BamRecord()
        r.qname = f"p{i}".encode()
        r.tid = 0 if i % 11 else -1
        r.flag = 4 if i % 13 == 0 else 0
        r.pos = int(rng.integers(0, 400))
        r.cigar = parse_cigar(cigars[i % len(cigars)])
        r.set_seq("".join(rng.choice(list("ACGTN"), 50)),
                  bytes(rng.integers(0, 41, 50, dtype=np.uint8)))
        recs.append(r)
    return recs


def _brute_pileup(recs, tile_start, tile_len, min_qual):
    depth = np.zeros(tile_len, np.int64)
    counts = np.zeros((tile_len, 16), np.int64)
    for r in recs:
        if r.flag & 4 or r.tid < 0:
            continue
        seq4 = np.frombuffer(r.seq4, np.uint8)
        end = max(r.endpos(), r.pos + 1)
        for p in range(r.pos, end):
            if tile_start <= p < tile_start + tile_len:
                depth[p - tile_start] += 1
        rp, q = r.pos, 0
        for c in r.cigar:
            op, ln = int(c) & 0xF, int(c) >> 4
            if op in (0, 7, 8):
                for k in range(ln):
                    nib = (seq4[(q + k) // 2] >> (4 * (1 - (q + k) % 2))) & 15
                    ok = r.qual[q + k] >= min_qual if min_qual else True
                    if ok and tile_start <= rp + k < tile_start + tile_len:
                        counts[rp + k - tile_start, nib] += 1
                rp += ln
                q += ln
            elif op in (1, 4):
                q += ln
            elif op in (2, 3):
                rp += ln
    return depth, counts


@pytest.mark.parametrize("min_qual", [0, 20])
def test_device_pileup_counts_matches_jax_and_brute(min_qual):
    recs = _records()
    tile_start, tile_len = 50, 512
    depth, counts = tpk.device_pileup_counts(recs, tile_start, tile_len,
                                             min_qual=min_qual, device="cpu")
    jd, jc = jpk.device_pileup_counts(recs, tile_start, tile_len,
                                      min_qual=min_qual)
    bd, bc = _brute_pileup(recs, tile_start, tile_len, min_qual)
    assert np.array_equal(depth, jd) and np.array_equal(counts, jc)
    assert np.array_equal(depth, bd) and np.array_equal(counts, bc)


def test_device_pileup_counts_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpk.device_pileup_counts(_records(), 0, 128)



@pytest.mark.parametrize("op", range(10))
def test_expand_cigar_events_matches_jax(op):
    """Every CIGAR op code, alone and between match runs, at two
    positions."""
    for ops in ([(7, op)], [(5, 0), (4, op), (3, 8)], [(3, 4), (6, op),
                                                       (2, 1), (5, 7)]):
        cigar = np.array([(ln << 4) | o for ln, o in ops], np.uint32)
        for pos in (0, 1234):
            want = jpk.expand_cigar_events(cigar, pos)
            got = tpk.expand_cigar_events(cigar, pos)
            assert len(got) == 2
            for g, w in zip(got, want):
                assert g.dtype == np.int64
                assert np.array_equal(g, w)
