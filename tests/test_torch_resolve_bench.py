"""The port's rANS resolve chain (htslib_tpu_torch/ops/rans_nx16.py
make_resolve_bench, kernel B4's plain version on the CPU) against the JAX
package's kernel in interpret mode, with the JAX tables carried across
(htslib_tpu_torch/carry.py), and against the port's numpy ref_chain.

The JAX package's own ref_chain cannot serve as the reference: at its
default ns=32 it indexes past the [8, G] states, and it leaves out the
kernel's renormalisation.  So the port is held against the JAX kernel.
States are integers: equality is exact."""
import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from htslib_tpu.ops import rans_pallas
from htslib_tpu_torch import carry
from htslib_tpu_torch.ops import rans_nx16 as tr

G = 128
# (rounds, unroll): 64 // 5 * 5 = 60 steps, as the JAX loop runs
CONFIGS = [(8, 4), (64, 4), (64, 5)]


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX reference runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="module")
def runs():
    """Per configuration: (JAX kernel output, JAX args as numpy)."""
    out = {}
    for rounds, unroll in CONFIGS:
        fn, args, _ = rans_pallas.make_resolve_bench(G=G, rounds=rounds,
                                                     unroll=unroll)
        with pltpu.force_tpu_interpret_mode():
            res = np.asarray(fn(*args))
        out[rounds, unroll] = res, [np.asarray(a) for a in args]
    return out


@pytest.mark.parametrize("rounds,unroll", CONFIGS)
def test_port_matches_jax_kernel(runs, rounds, unroll):
    want, jargs = runs[rounds, unroll]
    fn, args, ref_chain = tr.make_resolve_bench(G=G, rounds=rounds,
                                                unroll=unroll, device="cpu")
    carried = carry.from_jax_resolve_bench(*jargs)
    for a, c in zip(args, carried):
        assert torch.equal(a, c)
    got = fn(*carried)
    assert got.dtype == torch.int32 and tuple(got.shape) == (8, G)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(ref_chain().view(np.int32), want)


def test_renormalisation_reached():
    """x shrinks by about f/4096 a step, so within a few steps some chain
    drops below 2^15 and renormalises; the chain without that step would
    differ from the kernel's."""
    _, (freqs, x0), ref_chain = tr.make_resolve_bench(G=G, rounds=8,
                                                      device="cpu")
    f = freqs.numpy().astype(np.int64)
    cum = np.cumsum(f, 1) - f
    sym_of = np.stack([np.repeat(np.arange(256), row) for row in f])
    gi = np.arange(G)
    x = x0.numpy().astype(np.int64)
    renorms = 0
    for step in range(1, 9):
        m = x & 4095
        s = sym_of[gi, m]
        x = f[gi, s] * (x >> 12) + m - cum[gi, s]
        low = x < 1 << 15
        renorms += int(low.sum())
        x = np.where(low, (x << 16) | 1, x)
        assert np.array_equal(ref_chain(step)[0], x.astype(np.uint32))
    assert renorms > 0


def test_bench_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.make_resolve_bench(G=4, rounds=8)
