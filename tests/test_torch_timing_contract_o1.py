"""The timing dict of the port's order-1 quality lane (htslib_tpu_torch/
ops/device_stats.py qualstats_device_o1) has the JAX package's keys on
the same streams, for reps=1 and reps=2 (see
test_torch_timing_contract.py)."""
import jax
import pytest

from htslib_tpu.codecs.rans4x16 import compress
from htslib_tpu.ops import device_stats as jds
from htslib_tpu_torch.ops import device_stats as tds
from tests.test_torch_timing_contract import (check_timing_contract,
                                              quality_streams)


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX reference runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("reps", [1, 2])
def test_o1_timing_keys_match_jax(reps):
    encs = [compress(d, 0x05) for d in quality_streams()]
    check_timing_contract(tds.qualstats_device_o1(encs, device="cpu",
                                                  reps=reps),
                          jds.qualstats_device_o1(encs, interpret=True,
                                                  reps=reps))
