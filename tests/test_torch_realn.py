"""The port's BAQ (htslib_tpu_torch/realn.py, its HMM through
ops/probaln.py's plain version) against the JAX package's
sam_prob_realn_batch (htslib_tpu/realn.py, HMM by XLA on the CPU in
float64): every return code and every record (qualities, BQ/ZQ tags)
after the call, for each flag combination, over reads that reach every
exit of the tag bookkeeping.  Codes and bytes: equality is exact."""
import jax
import numpy as np
import pytest

from chip_smoke import baq_case
from htslib_tpu import realn as jrealn
from htslib_tpu.sam.record import BamRecord as JRecord
from htslib_tpu_torch import realn as trealn
from htslib_tpu_torch.sam.record import encode_aux


@pytest.fixture(autouse=True, scope="module")
def _jax_64bit():
    """The JAX reference runs in float64 here; the setting is put back
    after the module, so other modules in the worker keep theirs."""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", was)


def tagged_case(seed=12):
    """baq_case's reads on a 20 kbp reference, with the tag exits forced
    on the first records: a BQ of the read's length, one a base short, a
    ZQ, one a base short, both, a reference skip (N) and a missing
    quality."""
    ref, recs = baq_case(70, seed=seed, ref_len=20_000, n_long=2)
    mapped = [r for r in recs if not r.flag & 4 and r.l_qseq <= 1000]
    rng = np.random.default_rng(seed)
    for k, b in enumerate(mapped[:7]):
        txt = rng.integers(64, 90, b.l_qseq, dtype=np.uint8).tobytes()
        b.aux = b""
        if k in (0, 4):
            b.aux += encode_aux(b"BQ", "Z", txt)
        if k == 1:
            b.aux += encode_aux(b"BQ", "Z", txt[:-1])
        if k in (2, 4):
            b.aux += encode_aux(b"ZQ", "Z", txt)
        if k == 3:
            b.aux += encode_aux(b"ZQ", "Z", txt[:-1])
        if k == 5:
            n = int(b.cigar[0]) >> 4
            b.cigar = np.array([(n // 2) << 4, (30 << 4) | 3,
                                ((n - n // 2) << 4)], np.uint32)
        if k == 6:
            b.qual = b"\xff" * b.l_qseq
    return ref, recs


@pytest.mark.parametrize("flag", [0, 1, 2, 3, 5, 6])
def test_realn_batch_matches_jax(flag):
    ref, recs = tagged_case()
    mine = [r.copy() for r in recs]
    theirs = [JRecord.from_bam_buffer(r.to_bam_buffer()) for r in recs]
    timing = {}
    got = trealn.sam_prob_realn_batch(mine, ref, flag, device="cpu",
                                      timing=timing)
    want = jrealn.sam_prob_realn_batch(theirs, ref, flag)
    assert got == want
    assert {-1, 0} <= set(got)
    assert [r.to_bam_buffer() for r in mine] == \
        [r.to_bam_buffer() for r in theirs]
    assert timing["runs"] > 50 and set(timing["groups"]) == {"0.001,0.1",
                                                             "1e-07,0.1"}


def test_realn_tag_exits():
    """-3 (a tag the flag forbids) and -4 (a ZQ of the wrong length) come
    back where the JAX function gives them."""
    ref, recs = tagged_case(13)
    codes = {f: trealn.sam_prob_realn_batch([r.copy() for r in recs], ref,
                                            f, device="cpu")
             for f in (0, 1)}
    assert -4 in codes[0] and -4 in codes[1]
    assert -3 in codes[0] and -3 in codes[1]


def test_realn_single_record_is_a_batch_of_one():
    ref, recs = tagged_case(14)
    for b in recs[7:14]:
        a, c = b.copy(), JRecord.from_bam_buffer(b.to_bam_buffer())
        assert trealn.sam_prob_realn(a, ref, 1, device="cpu") == \
            jrealn.sam_prob_realn_batch([c], ref, 1)[0]
        assert a.to_bam_buffer() == c.to_bam_buffer()
