"""The port's order-1 quality lane (htslib_tpu_torch/ops/device_stats.py
`qualstats_device_o1`, kernel B6's plain version on the CPU) against the
JAX package's in Pallas interpret mode and the host histogram, and the
committed CRAM 3.1 order-1 fixture through `cram_qual_hist`.  Counts are
integers: equality is exact.  The cases share one JAX table shape, so
each bin count compiles its JAX run once."""
import os

import jax
import numpy as np
import pytest

from htslib_tpu.codecs.rans4x16 import compress
from htslib_tpu.ops import device_stats as jds
from htslib_tpu_torch.ops import device_stats as tds
from test_torch_device_stats import check_committed_fixture, write_o1_cram
from test_torch_device_stats import read_walks as _walk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
O1_FIXTURE = os.path.join(REPO, "htslib_tpu_torch", "testdata",
                          "qual_o1.cram")


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX reference runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    jax.config.update("jax_enable_x64", False)


def _datas():
    rng = np.random.default_rng(41)
    return [_walk(rng, 30000), _walk(rng, 1007), _walk(rng, 13),
            bytes([30]) * 999, _walk(rng, 64),
            rng.integers(20, 41, 3001, dtype=np.uint8).tobytes()]


DATAS = _datas()
# with these, more than 32 streams: the JAX lane takes two groups
FILLERS = [_walk(np.random.default_rng(42), 40 + 37 * i) for i in range(27)]


@pytest.mark.parametrize("qbins", [64, 256])
def test_qualstats_device_o1_matches_jax(qbins):
    datas = DATAS + (FILLERS if qbins == 64 else [])
    encs = [compress(d, 0x05) for d in datas]
    got, timing = tds.qualstats_device_o1(encs, device="cpu", qbins=qbins)
    ref, _ = jds.qualstats_device_o1(encs, interpret=True, qbins=qbins)
    truth = np.stack([np.bincount(np.minimum(np.frombuffer(d, np.uint8),
                                             qbins - 1), minlength=qbins)
                      for d in datas])
    assert got.dtype == np.int64 and got.shape == (len(datas), qbins)
    assert np.array_equal(got, truth)
    assert np.array_equal(got, ref)
    assert timing["uncompressed_bytes"] == sum(len(d) for d in datas)


def test_qualstats_device_o1_rejects_other_wires():
    for flags in (0x04, 0x01):
        enc = compress(DATAS[1], flags)
        with pytest.raises(ValueError) as port_err:
            tds.qualstats_device_o1([enc], device="cpu")
        with pytest.raises(ValueError) as jax_err:
            jds.qualstats_device_o1([enc], interpret=True)
        assert str(port_err.value) == str(jax_err.value)


def test_committed_o1_fixture(tmp_path):
    check_committed_fixture(tmp_path, O1_FIXTURE, write_o1_cram,
                            ["nx16_o1", None])
