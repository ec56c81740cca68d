"""The port's order-1 lane on a 256-context table that still passes the
A2_MAX gate (every context used, 443 rows): `qualstats_device_o1` and
`decode_nx16_o1_batch` (kernels B6/B5's plain versions on the CPU)
against the JAX package's histogram in Pallas interpret mode and the host
codec.  The table needs a 256-symbol JAX alphabet select, the costliest
JAX configuration of the lane, so it compiles here once, alone."""
import jax
import numpy as np
import pytest

from htslib_tpu.codecs.rans4x16 import compress, uncompress
from htslib_tpu.ops import device_stats as jds
from htslib_tpu_torch.ops import device_stats as tds
from htslib_tpu_torch.ops import rans_nx16_o1 as to1
from test_torch_rans_nx16_o1 import CTX256


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX reference runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    jax.config.update("jax_enable_x64", False)


def test_table_has_256_contexts_under_the_gate():
    F = to1._parse_nx16_header(compress(CTX256, 0x05))[1]
    assert (F.sum(axis=1) > 0).sum() == 256
    assert (F > 0).sum() <= to1.A2_MAX


def test_ctx256_matches_jax_and_host():
    datas = [CTX256, CTX256[:1007], CTX256[:4000]]
    encs = [compress(d, 0x05) for d in datas]
    assert to1.decode_nx16_o1_batch(encs, device="cpu") \
        == [uncompress(e) for e in encs] == datas
    got, _ = tds.qualstats_device_o1(encs, device="cpu")
    ref, _ = jds.qualstats_device_o1(encs, interpret=True)
    truth = tds.qualstats_host(datas)
    assert np.array_equal(got, truth)
    assert np.array_equal(got, ref)
