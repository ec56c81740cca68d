"""The port's record-batch step (htslib_tpu_torch/entry.py) against the
JAX package's entry point on the same example batch."""
import os
import sys

import jax
import numpy as np
import pytest
import torch

from htslib_tpu_torch import entry as tentry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import __graft_entry__ as jentry  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX reference runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    jax.config.update("jax_enable_x64", False)


def test_example_batch_is_the_jax_one():
    for a, b in zip(tentry._example_batch(), jentry._example_batch()):
        assert np.array_equal(a, b)


def test_forward_matches_jax():
    fn, args = tentry.entry(device="cpu")
    jfn, jargs = jentry.entry()
    got = fn(*args)
    assert got.dtype == torch.int32 and got.dim() == 0
    assert int(got) == int(jfn(*jargs))


@pytest.mark.parametrize("n", [1000, 300000])
def test_forward_matches_numpy_truth(n):
    """The total wraps as an int32 sum, as the JAX step's does (300,000
    records carry the base bytes past 2^31)."""
    tile_len = 1 << 14
    batch = tentry._example_batch(n=n, seed=5)
    fn, args = tentry.entry(device="cpu", tile_len=tile_len, batch=batch)
    cores, seq4, starts, ends, valid = batch
    lut = np.frombuffer(b"=ACMGRSVTWYHKDBN", np.uint8)
    flags = cores[:, 14].astype(np.int64) | (cores[:, 15].astype(np.int64)
                                             << 8)
    bases = (lut[seq4 >> 4].astype(np.int64).sum()
             + lut[seq4 & 15].astype(np.int64).sum())
    diff = np.zeros(tile_len + 1, np.int64)
    np.add.at(diff, np.clip(starts, 0, tile_len), valid.astype(np.int64))
    np.add.at(diff, np.clip(ends, 0, tile_len), -valid.astype(np.int64))
    cov = np.cumsum(diff[:-1]).sum()
    total = int(flags.sum() + bases + cov)
    assert int(fn(*args)) == (total + 2**31) % 2**32 - 2**31


def test_entry_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()


def test_entry_rejects_unknown_device():
    with pytest.raises(ValueError, match="unsupported device"):
        tentry.entry(device="meta")

