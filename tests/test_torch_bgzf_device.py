"""The port's BGZF write path (htslib_tpu_torch/ops/bgzf_device.py:
bgzf_stored_device, deflate_uniform_device, crc_device_rate, with
device="cpu") against the JAX package's functions of the same names
(htslib_tpu/ops/bgzf_device.py, XLA on the CPU), zlib and gzip: the same
bytes, `timing` keys and `stats`, every block's CRC zlib's, every output
gzip-decodable.  Outputs are bytes and integers: equality is exact."""
import gzip
import zlib

import jax
import numpy as np
import pytest
import torch

from htslib_tpu.ops import bgzf_device as jb
from htslib_tpu_torch.ops import bgzf_device as tb
from chip_smoke import bgzf_blocks


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX reference runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("n", [0, 5, 65280, 65281, 65280 + 17, 200000])
def test_stored_matches_jax(n):
    """Empty input, a tail block alone, one full block, full blocks with a
    tail: the JAX function's bytes, every CRC zlib's, gzip-decodable."""
    data = np.random.RandomState(9).randint(0, 256, n,
                                            dtype=np.uint8).tobytes()
    t_port, t_jax = {}, {}
    blob = tb.bgzf_stored_device(data, device="cpu", timing=t_port)
    assert blob == jb.bgzf_stored_device(data, timing=t_jax)
    assert set(t_port) == set(t_jax)
    assert t_port.get("crc_blocks") == t_jax.get("crc_blocks")
    assert gzip.decompress(blob) == data
    blocks = list(bgzf_blocks(blob))
    assert len(blocks) == n // tb.CHUNK + (n % tb.CHUNK > 0) + 1
    assert blocks[-1] == (0, 0, b"")        # the BGZF EOF block
    for crc, isize, pl in blocks:
        assert crc == zlib.crc32(pl) and isize == len(pl)


def _deflate_cases():
    """tests/test_device_stats.py's cases: qualities (5-bit codes), ACGT
    (3-bit), 200 symbols and 128 symbols (L = 8: the stored fallback), and
    four, zero and one bytes."""
    rng = np.random.RandomState(3)
    return [rng.randint(20, 41, 200000).astype(np.uint8).tobytes(),
            bytes(rng.choice(list(b"ACGT"), 150000)),
            rng.randint(0, 200, 70000).astype(np.uint8).tobytes(),
            b"AAAA", b"", b"Q", bytes(range(128)) * 600]


@pytest.mark.parametrize("case", range(len(_deflate_cases())))
def test_deflate_uniform_matches_jax(case):
    data = _deflate_cases()[case]
    s_port, s_jax = {}, {}
    blob = tb.deflate_uniform_device(data, device="cpu", stats=s_port)
    assert blob == jb.deflate_uniform_device(data, stats=s_jax)
    assert s_port == s_jax
    assert gzip.decompress(blob) == data
    if case == 0:
        assert len(blob) / len(data) < 0.7     # 5-bit qualities
    if case == 1:
        assert len(blob) / len(data) < 0.45    # ACGT: 3-bit codes
    if case in (2, 6):
        assert s_port == {"huffman_blocks": 0, "stored_blocks": 2}


def test_crc_device_rate_matches_jax():
    got = tb.crc_device_rate(n_blocks=4, reps=1, device="cpu")
    want = jb.crc_device_rate(n_blocks=4, reps=1)
    assert set(got) == set(want)
    assert got["exact"] is True and want["exact"] is True


def test_crc_blocks_chunked_and_edge_rows():
    """Rows of all zeros, all 0xFF, one set bit first or last, and random
    rows, more than one chunk of them, against zlib."""
    n = 100
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 256, (tb.CRC_CHUNK_BLOCKS + 3, n), dtype=np.uint8)
    rows[0] = 0
    rows[1] = 0xFF
    rows[2] = 0
    rows[2, 0] = 1
    rows[3] = 0
    rows[3, -1] = 0x80
    D, crc0 = tb._crc_bit_contrib(n)
    got = tb._crc_blocks(torch.from_numpy(rows), torch.from_numpy(
        D.view(np.int32)), crc0).numpy()
    assert got.tolist() == [zlib.crc32(r.tobytes()) for r in rows]


def test_write_side_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for fn in (lambda: tb.bgzf_stored_device(b"abc"),
               lambda: tb.deflate_uniform_device(b"abc"),
               lambda: tb.crc_device_rate(n_blocks=1, reps=1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
