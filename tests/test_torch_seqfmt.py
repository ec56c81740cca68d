"""The port's record unpack and SAM staging (htslib_tpu_torch/ops/
seqfmt.py, kernel B1's plain version on the CPU) against the JAX
package's seqfmt, BamRecord parsing and the host dec_len.  Bytes and
integers: equality is exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htslib_tpu.ops import seqfmt as jsf
from htslib_tpu.sam.batch import dec_len
from htslib_tpu.sam.record import BamRecord
from htslib_tpu_torch.ops import seqfmt as tsf


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX reference runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    jax.config.update("jax_enable_x64", False)


def _records(n=16, seed=0):
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        rec = BamRecord()
        rec.qname = f"r{i}".encode()
        rec.tid = int(rng.integers(-1, 3))
        rec.pos = int(rng.integers(0, 1000000))
        rec.flag = int(rng.integers(0, 4096))
        rec.mapq = int(rng.integers(0, 255))
        rec.set_seq("".join(rng.choice(list("ACGTN"), 32)))
        recs.append(rec)
    return recs


def test_unpack_core_fields_matches_jax_and_records():
    recs = _records()
    cores = np.stack([np.frombuffer(r.to_bam_buffer()[:32], np.uint8)
                      for r in recs])
    # random cores reach the sign bit of every field
    cores = np.concatenate([cores, np.random.default_rng(1).integers(
        0, 256, (64, 32), dtype=np.uint8)])
    got = tsf.unpack_core_fields(torch.from_numpy(cores))
    ref = jsf.unpack_core_fields(jnp.asarray(cores))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == torch.int32
        assert np.array_equal(got[k].numpy(), np.asarray(ref[k])), k
    n = len(recs)
    assert got["pos"][:n].tolist() == [r.pos for r in recs]
    assert got["flag"][:n].tolist() == [r.flag for r in recs]
    assert got["tid"][:n].tolist() == [r.tid for r in recs]
    assert got["l_qseq"][:n].tolist() == [32] * n


@pytest.mark.parametrize("ref", ["xla", "pallas_interpret"])
def test_nibble_plain_matches_jax(ref):
    recs = _records()
    packed = np.stack([np.frombuffer(r.seq4, np.uint8) for r in recs])
    packed = np.concatenate([packed, np.random.default_rng(2).integers(
        0, 256, (40, 16), dtype=np.uint8)])
    got = tsf.nibble_to_base(torch.from_numpy(packed))
    assert torch.equal(got, tsf.nibble_to_base_plain(torch.from_numpy(packed)))
    if ref == "xla":
        want = np.asarray(jsf.nibble_to_base(jnp.asarray(packed)))
    else:
        want = np.asarray(jsf.nibble_to_base_pallas(jnp.asarray(packed),
                                                    interpret=True))
    assert got.dtype == torch.uint8 and got.shape == (len(packed), 32)
    assert np.array_equal(got.numpy(), want)
    assert bytes(got[0].numpy()).decode() == recs[0].seq


def test_qual_to_ascii_matches_jax():
    rng = np.random.default_rng(3)
    qual = rng.integers(0, 256, (20, 50), dtype=np.uint8)
    mask = rng.random((20, 50)) > 0.3
    got = tsf.qual_to_ascii(torch.from_numpy(qual), torch.from_numpy(mask))
    want = np.asarray(jsf.qual_to_ascii(jnp.asarray(qual), jnp.asarray(mask)))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("max_digits", [11, 12])
def test_dec_len_and_itoa_match_jax(max_digits):
    vals = np.array([0, 1, -1, 9, 10, 99, -100, 12345, 2**31 - 1,
                     -(2**31) + 1, 1000000000, -999999999], np.int64)
    dl = tsf.dec_len_device(torch.from_numpy(vals))
    assert dl.tolist() == list(dec_len(vals))
    assert dl.tolist() == np.asarray(
        jsf.dec_len_device(jnp.asarray(vals))).tolist()
    buf = tsf.itoa_fixed(torch.from_numpy(vals), max_digits=max_digits)
    want = np.asarray(jsf.itoa_fixed(jnp.asarray(vals),
                                     max_digits=max_digits))
    assert np.array_equal(buf.numpy(), want)
    if max_digits == 12:
        for i, v in enumerate(vals):
            assert bytes(buf[i].numpy()).replace(b"\x00", b"").decode() \
                == str(v)


def test_nibble_rejects_other_devices():
    with pytest.raises(ValueError, match="CUDA tensor"):
        tsf.nibble_to_base_cuda(torch.zeros((2, 2), dtype=torch.uint8))

