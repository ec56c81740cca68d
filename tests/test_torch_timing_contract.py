"""The timing dict of the port's quality lane (htslib_tpu_torch/ops/
device_stats.py qualstats_device and qualstats_device_4x8) has the JAX
package's keys on the same streams: for reps=1 the collect-wall rate, for
reps > 1 the best of `reps` device-resident re-runs and the resident
rate.  The times differ by nature; the histograms and byte counts are
exact.  The order-1 lane is in test_torch_rans_dense.py, beside the
other cases that compile it: its interpret-mode JAX runs take the
longest."""
import jax
import numpy as np
import pytest

from htslib_tpu.codecs import rans4x8
from htslib_tpu.codecs.rans4x16 import compress
from htslib_tpu.ops import device_stats as jds
from htslib_tpu_torch.ops import device_stats as tds


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX reference runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    jax.config.update("jax_enable_x64", False)


def quality_streams(seed=1):
    """Two short streams over three quality values: the interpret-mode
    JAX kernels' cost grows with the tables, so the alphabet is small."""
    rng = np.random.default_rng(seed)
    return [rng.integers(20, 23, n, dtype=np.uint8).tobytes()
            for n in (100, 1000)]


def check_timing_contract(port, ref):
    """(hist, timing) of the port and of the JAX function."""
    assert np.array_equal(port[0], ref[0])
    assert set(port[1]) == set(ref[1])
    for key in ("uncompressed_bytes", "compressed_bytes"):
        assert port[1][key] == ref[1][key]
    rate = [k for k in port[1] if k.startswith("MBps_")]
    assert len(rate) == 1
    assert port[1][rate[0]] == round(port[1]["uncompressed_bytes"]
                                     / port[1]["decode_s"] / 1e6, 2)


LANES = {
    "nx16_o0": (lambda d: compress(d, 0x04), tds.qualstats_device,
                jds.qualstats_device),
    "4x8_o0": (lambda d: rans4x8.compress(d, 0), tds.qualstats_device_4x8,
               jds.qualstats_device_4x8),
}


@pytest.mark.parametrize("reps", [1, 2])
@pytest.mark.parametrize("lane", list(LANES))
def test_timing_keys_match_jax(lane, reps):
    enc, port_fn, jax_fn = LANES[lane]
    encs = [enc(d) for d in quality_streams()]
    port = port_fn(encs, device="cpu", reps=reps)
    check_timing_contract(port, jax_fn(encs, interpret=True, reps=reps))
    key = ("MBps_uncompressed_resident" if reps > 1
           else "MBps_uncompressed_collect_wall")
    assert key in port[1]
