"""Kernel B4's chain (csrc/rans_resolve_step.cuh: the table, the doubled
step and the loop the kernel runs) compiled for the CPU with g++ and held
against the port's numpy ref_chain (htslib_tpu_torch/ops/rans_nx16.py
make_resolve_bench) and against its plain version, on the bench's tables
and on the edge states the doubled form leaves to the canonical step.
States are integers: equality is exact."""
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from htslib_tpu_torch.ops import rans_nx16 as tr

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "htslib_tpu_torch", "csrc")

_HARNESS = r"""
#include "rans_resolve_step.cuh"

static uint16_t tab[2 * RANS_TOTFREQ];

// G chains of `rounds` steps: each chain's table built by 32 lanes in
// turn, then the kernel's loop (8 steps a loop step) from its x0.
extern "C" void chains(const int32_t* freqs, const uint32_t* x0,
                       uint32_t* x_out, int G, int64_t rounds) {
  for (int g = 0; g < G; ++g) {
    uint16_t f[256];
    for (int s = 0; s < 256; ++s) f[s] = (uint16_t)freqs[g * 256 + s];
    for (int lane = 0; lane < 32; ++lane) rans_resolve_build(f, tab, lane, 32);
    x_out[g] = rans_resolve_chain<8>(x0[g], tab, rounds);
  }
}
"""


def _compile(tmp_path, csrc):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the step harness needs a C++ compiler")
    src = tmp_path / "harness.cpp"
    src.write_text(_HARNESS)
    lib = tmp_path / "libresolve.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-shared", "-fPIC", "-O2",
                    "-I", str(csrc), "-o", str(lib), str(src)], check=True)
    h = ctypes.CDLL(str(lib))
    h.chains.restype = None
    h.chains.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                                 ctypes.c_int64]
    return h


@pytest.fixture(scope="module")
def step_lib(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("resolve"), CSRC)


def _run(h, freqs, x0, rounds):
    f = np.ascontiguousarray(freqs, np.int32)
    x = np.ascontiguousarray(x0, np.uint32)
    out = np.zeros(len(x), np.uint32)
    h.chains(f.ctypes.data, x.ctypes.data, out.ctypes.data, len(x), rounds)
    return out


@pytest.mark.parametrize("rounds", [0, 1, 2, 7, 8, 9, 17, 60, 1000, 4099])
def test_chain_matches_ref_chain(step_lib, rounds):
    """The bench's 128 chains, every step count about the loop's unroll of
    8, against the numpy chain (renormalisation included)."""
    _, (freqs, x0), ref_chain = tr.make_resolve_bench(G=128, rounds=8,
                                                      device="cpu")
    got = _run(step_lib, freqs.numpy(), x0.numpy().view(np.uint32), rounds)
    assert np.array_equal(got, ref_chain(rounds)[0])


def _edge_tables():
    """freqs [G, 256] and x0 [G]: starts at 0, below 2^15, at 2^15 - 1 and
    2^15, about 2^31 and at 2^32 - 1 on a bench table, on a one-symbol
    table (f = 4096: a state there never falls) and on a table of f = 1
    symbols beside one large one (slot 1's entry differs from slot 0's)."""
    rng = np.random.default_rng(5)
    bench = tr.make_resolve_bench(G=1, rounds=8, device="cpu")[1][0].numpy()
    mono = np.zeros(256, np.int64)
    mono[77] = 4096
    ones = np.ones(256, np.int64)
    ones[200] += 4096 - ones.sum()
    rand = rng.integers(1, 64, 256)
    rand = np.maximum(1, rand * 4096 // rand.sum())
    rand[0] += 4096 - rand.sum()
    starts = [0, 1, 4095, 4096, (1 << 15) - 1, 1 << 15, (1 << 31) - 1,
              1 << 31, (1 << 31) + 12345, (1 << 32) - 1]
    freqs, x0 = [], []
    for table in (bench[0], mono, ones, rand):
        for x in starts:
            freqs.append(table)
            x0.append(x)
    return np.array(freqs, np.int64), np.array(x0, np.uint64)


@pytest.mark.parametrize("rounds", [1, 3, 8, 40, 333])
def test_chain_matches_plain_on_edge_states(step_lib, rounds):
    freqs, x0 = _edge_tables()
    got = _run(step_lib, freqs, x0.astype(np.uint32), rounds)
    want = tr.rans_resolve_plain(torch.from_numpy(freqs.astype(np.int32)),
                                 torch.from_numpy(x0.astype(np.uint32)
                                                  .view(np.int32)), rounds)
    assert np.array_equal(got, want.numpy().view(np.uint32))


def test_renormalising_start_reaches_the_doubled_form(step_lib):
    """The bench's chains renormalise every few steps, so the doubled
    form's renormalised step (slot 1's entry, x >> 12 = y << 4) is
    taken."""
    _, (freqs, x0), ref_chain = tr.make_resolve_bench(G=4, rounds=8,
                                                      device="cpu")
    f = freqs.numpy()
    for rounds in range(1, 12):
        got = _run(step_lib, f, x0.numpy().view(np.uint32), rounds)
        assert np.array_equal(got, ref_chain(rounds)[0])
    # a renormalised state is y << 16 | 1
    assert any(((ref_chain(r)[0] & 0xFFFF) == 1).any() for r in range(1, 12))


@pytest.mark.parametrize("mutation", [
    ("  uint32_t next = f1 * (Y << 3) + o1;",
     "  uint32_t next = f1 * (Y << 4) + o1;"),
    ("  uint32_t next = f1 * (Y << 3) + o1;",
     "  uint32_t next = f1 * (Y << 3);"),
    ("  return y < RANS16_L ? (y << 16) | 1u : y;\n}\n\n// `rounds`",
     "  return y < RANS16_L ? (y << 16) : y;\n}\n\n// `rounds`"),
])
def test_mutated_step_fails(tmp_path, mutation):
    """A copy of the header with the renormalisation's shift, slot 1's
    offset or the final unfold wrong differs from the numpy chain."""
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    hdr = csrc / "rans_resolve_step.cuh"
    text = hdr.read_text()
    assert text.count(mutation[0]) == 1
    hdr.write_text(text.replace(*mutation))
    h = _compile(tmp_path, csrc)
    _, (freqs, x0), ref_chain = tr.make_resolve_bench(G=128, rounds=8,
                                                      device="cpu")
    got = [_run(h, freqs.numpy(), x0.numpy().view(np.uint32), r)
           for r in (9, 60)]
    assert not all(np.array_equal(g, ref_chain(r)[0])
                   for g, r in zip(got, (9, 60)))
