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

// Stream s's prefix table of kbits bits, built by the header's set-up
// code, then every one of the 32,768 windows resolved as the kernel's
// step does (the entry, or on the sentinel the lean resolve over the
// limits, bases - firsts and order).  Returns the sentinel entries.
extern "C" int table_resolve(const int32_t* limits, const int32_t* firsts,
                             const int32_t* bases, const int32_t* order,
                             int n, int s, int kbits, uint32_t sent,
                             uint32_t* sym) {
  int32_t lim[HUFF_ROWS], bmf[HUFF_ROWS], ord[HUFF_NSYM_PAD];
  for (int r = 0; r < HUFF_ROWS; ++r) {
    lim[r] = limits[r * n + s];
    bmf[r] = (int32_t)((uint32_t)bases[r * n + s] -
                       (uint32_t)firsts[r * n + s]);
  }
  for (int e = 0; e < HUFF_NSYM_PAD; ++e) ord[e] = order[e * n + s];
  static uint32_t tab[1 << HUFF_MAXBITS];
  int n_sent = 0;
  for (uint32_t p = 0; p < (1u << kbits); ++p) {
    tab[p] = huff_prefix_entry(p, kbits, limits + s, firsts + s, bases + s,
                               order + s, n, sent);
    n_sent += tab[p] == sent;
  }
  for (uint32_t v = 0; v < (1u << HUFF_MAXBITS); ++v) {
    // the kernel reads the entry at the offset it takes from the mix x,
    // here any x whose window is v (junk above and below it)
    const uint32_t x = v << 7 | (v * 2654435761u & 0xFE00007Fu);
    const uint32_t e = tab[huff_prefix_offset(x, kbits, 2) >> 2];
    sym[v] = e != sent ? e : huff_resolve_lean(v, lim, bmf, ord, 1);
  }
  return n_sent;
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
    h.table_resolve.restype = ctypes.c_int
    h.table_resolve.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
        + [ctypes.c_uint32, ctypes.c_void_p]
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


def _one_symbol_lens():
    """A one-symbol alphabet: one code of length 1, so half the windows
    reach l* = 16."""
    lens = np.zeros((1, 288), np.int64)
    lens[0, 77] = 1
    return lens


def _ten_bit_lens():
    """An incomplete code of 144 8-bit and 144 10-bit codes: prefixes of
    9 bits that hold two 10-bit codes and no length limit."""
    lens = np.zeros((2, 288), np.int64)
    lens[:, :144] = 8
    lens[:, 144:] = 10
    lens[1] = lens[1][np.random.RandomState(8).permutation(288)]
    return lens


def _tables(lens, shift=0, add=0):
    """build_tables(lens), the bases moved by shift and every order value
    by add."""
    limits, firsts, bases, dord = th.build_tables(lens)
    dord = dord.copy()
    dord[0] += add
    return limits, firsts, (bases + shift).astype(np.int32), dord


def _random_tables(n=3, seed=6):
    """Tables no code gives: unsorted limits anywhere in [0, 2^15] (but
    limits[15] = 2^15, as every table has, so l* <= 16), firsts and bases
    that move idx in and out of the order table, random order values;
    resolve_ref still defines the resolve."""
    rng = np.random.RandomState(seed)
    limits = rng.randint(0, (1 << 15) + 1, (16, n)).astype(np.int32)
    limits[15] = 1 << 15
    firsts = rng.randint(-64, 512, (16, n)).astype(np.int32)
    bases = rng.randint(0, 320, (16, n)).astype(np.int32)
    order = rng.randint(-(1 << 31), 1 << 31, (th.NSYM_PAD, n), np.int64)
    dord = np.diff(order, axis=0, prepend=0)
    return limits, firsts, bases, ((dord + (1 << 31)) % (1 << 32)
                                   - (1 << 31)).astype(np.int32)


def _limit_at_prefix_end():
    """One limit on the last window of a 9-bit prefix (383 = 5 * 64 + 63),
    so that prefix's last window alone has l* = 2, each length naming
    another symbol."""
    limits = np.full((16, 1), 1 << 15, np.int32)
    limits[0] = 383
    bases = np.arange(16, dtype=np.int32)[:, None]
    dord = np.full((th.NSYM_PAD, 1), 7, np.int32)
    return limits, np.zeros((16, 1), np.int32), bases, dord


TABLE_CASES = {"bench": lambda: _tables(_bench_lens(4)),
               "skewed": lambda: _tables(LENS["skewed"]),
               "incomplete": lambda: _tables(LENS["incomplete"]),
               "one_symbol": lambda: _tables(_one_symbol_lens()),
               "ten_bit": lambda: _tables(_ten_bit_lens()),
               "bench_idx_out": lambda: _tables(_bench_lens(2), shift=300),
               "bench_wide_order": lambda: _tables(_bench_lens(2),
                                                   add=70000),
               "random_tables": _random_tables,
               "limit_at_prefix_end": _limit_at_prefix_end}


@pytest.mark.parametrize("kbits,sent", [(0, 0xFFFFFFFF), (9, 0xFFFFFFFF),
                                        (15, 0xFFFF)])
@pytest.mark.parametrize("name", list(TABLE_CASES))
def test_prefix_table_resolves_every_window(step_lib, name, kbits, sent):
    """The kernel's table (15 bits: the whole window table of u16
    entries; 9: the prefix table; 0: the lean resolve alone), built by
    the header's set-up code and read as the kernel's step reads it,
    equals resolve_ref over all 32,768 windows of every stream: the
    bench's codes, 15-bit lengths, incomplete codes (l* = 16), a
    one-symbol alphabet, 10-bit codes two to a 9-bit prefix, bases moved
    so idx leaves the order table, order values a u16 entry cannot hold
    (read through the lean resolve), and random tables no code gives
    (limits inside a prefix's windows)."""
    limits, firsts, bases, dord = TABLE_CASES[name]()
    order = th.order_of(dord)
    n = limits.shape[1]
    v = np.arange(1 << th.MAXBITS)
    for s in range(n):
        sym = np.zeros(v.size, np.uint32)
        n_sent = step_lib.table_resolve(
            limits.ctypes.data, firsts.ctypes.data, bases.ctypes.data,
            order.ctypes.data, n, s, kbits, sent, sym.ctypes.data)
        cols = np.full(4096, s)
        want = np.concatenate([th.resolve_ref(
            v[i:i + 4096], limits[:, cols], firsts[:, cols], bases[:, cols],
            dord[:, cols]) for i in range(0, v.size, 4096)])
        assert np.array_equal(sym, want & 0xFFFFFFFF), (name, s)
        if name == "bench_wide_order" and sent == 0xFFFF:
            assert n_sent == 1 << kbits   # no symbol fits a u16 entry
        if name == "bench" and kbits == 9:
            assert n_sent == 0            # lengths <= 9: one load a step
