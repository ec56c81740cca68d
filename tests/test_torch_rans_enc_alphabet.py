"""The port's rANS Nx16 O0 32-way encode (htslib_tpu_torch/ops/
rans_enc.py, kernel B9's plain version on the CPU) on streams of a full
256-symbol alphabet against the JAX package's Pallas encode in interpret
mode, both host codecs and the port's decode.  The interpret-mode kernel
walks a 256-row table per round here, so this JAX call is the slow one
and has a file of its own.  Bytes: equality is exact."""
import jax
import numpy as np
import pytest

from htslib_tpu.codecs.rans4x16 import compress
from htslib_tpu.ops import rans_enc_pallas as jenc
from htslib_tpu_torch.codecs import rans4x16 as trans
from htslib_tpu_torch.ops import rans_enc as te
from htslib_tpu_torch.ops import rans_nx16 as tr


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX reference runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    jax.config.update("jax_enable_x64", False)


def _cases():
    rng = np.random.RandomState(12)
    return {"full_alphabet": rng.randint(0, 256, 3000).astype(np.uint8)
            .tobytes(),
            "full_alphabet_ulen_mod32": rng.randint(0, 256, 40007).astype(
                np.uint8).tobytes(),
            "every_symbol_once": rng.permutation(256).astype(np.uint8)
            .tobytes()}


CASES = _cases()
NAMES = list(CASES)


@pytest.fixture(scope="module")
def encoded():
    datas = [CASES[k] for k in NAMES]
    return dict(zip(NAMES, zip(
        te.encode_nx16_o0_batch(datas, device="cpu"),
        jenc.encode_nx16_o0_batch(datas, interpret=True))))


@pytest.mark.parametrize("name", NAMES)
def test_full_alphabet_matches_jax_and_host(encoded, name):
    port, jax_out = encoded[name]
    d = CASES[name]
    assert len(set(d)) == 256
    assert port == jax_out == compress(d, 0x04) == trans.compress(d, 0x04)
    assert tr.decode_nx16_o0_batch([port], device="cpu") == [d]
