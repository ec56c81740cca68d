"""The port's canonical-Huffman resolve (htslib_tpu_torch/ops/huffman.py:
build_tables, resolve_ref and make_huffman_resolve_bench, kernel B10's
plain version on the CPU) against the JAX package's huffman_pallas, its
kernel run in interpret mode with the JAX tables carried across
(htslib_tpu_torch/carry.py); and the kernel's resolve step
(csrc/huffman_step.cuh) compiled for the CPU.  Tables, symbols and
windows are integers: equality is exact."""
import ctypes
import os
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from htslib_tpu.ops import huffman_pallas as jh
from htslib_tpu_torch import carry
from htslib_tpu_torch.ops import huffman as th

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "htslib_tpu_torch", "csrc")
L = 128


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX reference runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    jax.config.update("jax_enable_x64", False)


def _bench_lens(n=L, seed=3):
    """The bench's code lengths: the fixed-Huffman mix, permuted per
    stream."""
    rng = np.random.RandomState(seed)
    lens = np.zeros((n, 288), np.int64)
    lens[:, :144] = 8
    lens[:, 144:256] = 9
    lens[:, 256:280] = 7
    lens[:, 280:288] = 8
    for s in range(n):
        lens[s] = lens[s][rng.permutation(288)]
    return lens


def _skewed_lens(n=6, seed=5):
    """Complete codes over lengths 1..15 (one symbol of each length and
    a second of length 15), scattered over 288 symbols with the rest
    unused."""
    rng = np.random.RandomState(seed)
    lens = np.zeros((n, 288), np.int64)
    for s in range(n):
        pick = rng.choice(288, 16, replace=False)
        lens[s, pick] = list(range(1, 16)) + [15]
    return lens


def _incomplete_lens():
    """Codes that do not fill the 15-bit space: windows past their last
    code reach l* = 16."""
    lens = np.zeros((2, 288), np.int64)
    lens[0, [5, 9]] = 2
    lens[1, [0, 100, 287]] = [3, 3, 4]
    return lens


LENS = {"bench": _bench_lens(), "skewed": _skewed_lens(),
        "incomplete": _incomplete_lens()}


@pytest.mark.parametrize("name", list(LENS))
def test_build_tables_match_jax(name):
    for got, want in zip(th.build_tables(LENS[name]),
                         jh.build_tables(LENS[name])):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("name", ["bench", "skewed", "incomplete"])
def test_resolve_ref_matches_jax(name):
    tables = th.build_tables(LENS[name])
    n = LENS[name].shape[0]
    for v in np.random.RandomState(9).randint(0, 1 << 15, (40, n)):
        assert np.array_equal(th.resolve_ref(v, *tables),
                              jh.resolve_ref(v, *tables))


@pytest.fixture(scope="module")
def runs():
    """Per rounds: (JAX kernel output, JAX args as numpy, JAX v0)."""
    out = {}
    for rounds in (8, 64):
        fn, args, _, v0 = jh.make_huffman_resolve_bench(L=L, rounds=rounds)
        with pltpu.force_tpu_interpret_mode():
            res = np.asarray(fn(*args))
        out[rounds] = res, [np.asarray(a) for a in args], v0
    return out


@pytest.mark.parametrize("rounds", [8, 64])
def test_port_matches_jax_kernel(runs, rounds):
    want, jargs, jv0 = runs[rounds]
    fn, args, ref_step, v0 = th.make_huffman_resolve_bench(
        L=L, rounds=rounds, device="cpu")
    assert np.array_equal(v0, jv0)
    carried = carry.from_jax_huffman_bench(*jargs)
    for a, c in zip(args, carried):
        assert torch.equal(a, c)
    got = fn(*carried)
    assert got.dtype == torch.int32 and tuple(got.shape) == (8, L)
    assert np.array_equal(got.numpy(), want)
    v = v0[0]
    for _ in range(rounds):
        v, _sym = ref_step(v)
    assert np.array_equal(v, want[0])


def test_plain_chain_with_unroll_remainder():
    """rounds // unroll * unroll resolves, as the JAX loop runs."""
    fn, args, ref_step, v0 = th.make_huffman_resolve_bench(
        L=16, rounds=23, unroll=4, device="cpu")
    v = v0[0]
    for _ in range(20):
        v, _sym = ref_step(v)
    assert np.array_equal(fn(*args)[3].numpy(), v)


def test_bench_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        th.make_huffman_resolve_bench(L=4, rounds=8)


_HARNESS = r"""
#include "huffman_step.cuh"

// Resolve n windows of n streams (stream s's tables in column s of
// row-major [entries, n] arrays) and give each next window.
extern "C" void resolve(const uint32_t* v, const int32_t* limits,
                        const int32_t* firsts, const int32_t* bases,
                        const int32_t* order, int n, uint32_t* sym,
                        uint32_t* next) {
  for (int s = 0; s < n; ++s) {
    sym[s] = huff_resolve(v[s], limits + s, firsts + s, bases + s, order + s,
                          n);
    next[s] = huff_next(v[s], sym[s]);
  }
}
"""


@pytest.fixture(scope="module")
def step_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the step harness needs a C++ compiler")
    d = tmp_path_factory.mktemp("huff_step")
    src = d / "harness.cpp"
    src.write_text(_HARNESS)
    lib = d / "libhuffstep.so"
    subprocess.run([gxx, "-x", "c++", "-shared", "-fPIC", "-O2", "-I", CSRC,
                    "-o", str(lib), str(src)], check=True)
    h = ctypes.CDLL(str(lib))
    h.resolve.restype = None
    h.resolve.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] \
        + [ctypes.c_void_p] * 2
    return h


@pytest.mark.parametrize("name,shift", [("bench", 0), ("skewed", 0),
                                        ("incomplete", 0), ("bench", 300),
                                        ("skewed", -200)])
def test_step_header_on_cpu(step_lib, name, shift):
    """The CUDA resolve step, compiled for the host, gives resolve_ref's
    symbols and the chain's next windows.  Shifted bases move idx out of
    the order table, where both give 0."""
    limits, firsts, bases, dord = th.build_tables(LENS[name])
    bases = (bases + shift).astype(np.int32)
    order = th.order_of(dord)
    n = limits.shape[1]
    for v in np.random.RandomState(4).randint(0, 1 << 15, (20, n)):
        v = v.astype(np.uint32)
        sym = np.zeros(n, np.uint32)
        nxt = np.zeros(n, np.uint32)
        step_lib.resolve(v.ctypes.data, limits.ctypes.data,
                         firsts.ctypes.data, bases.ctypes.data,
                         order.ctypes.data, n, sym.ctypes.data,
                         nxt.ctypes.data)
        want = th.resolve_ref(v, limits, firsts, bases, dord)
        if shift:
            assert not want.any()
        assert np.array_equal(sym, want)
        assert np.array_equal(nxt, th.next_window(v.astype(np.int64), want))
