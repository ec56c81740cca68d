"""The port's batched BAQ HMM (htslib_tpu_torch/ops/probaln.py, kernel X6's
plain version) against the JAX package's probaln_batch (htslib_tpu/
ops/probaln.py, XLA on the CPU in float64) and the scalar
probaln_glocal (htslib_tpu/realn.py): Pr, MAP states and qualities are
integers and must be equal, with mixed bands and a padded J; float32
runs are held within +/-1 phred of float64 (the output contract of
ops/probaln.py); and X6's per-read routine (csrc/probaln_step.cuh)
compiled with g++ -ffp-contract=off against the same integers."""
import ctypes
import os
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htslib_tpu import realn as jrealn
from htslib_tpu.ops import probaln as jp
from htslib_tpu_torch import carry
from htslib_tpu_torch.ops import probaln as tp
from test_torch_gpu import probaln_batch_args

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "htslib_tpu_torch", "csrc")


@pytest.fixture(autouse=True, scope="module")
def _jax_64bit():
    """The JAX reference runs in float64 here; the setting is put back
    after the module, so other modules in the worker keep theirs."""
    was = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", was)


def _reads(n, seed, max_len=80):
    rng = np.random.default_rng(seed)
    refs, qs, quals, bws = [], [], [], []
    for _ in range(n):
        lq = int(rng.integers(1, max_len))
        lr = max(1, lq + int(rng.integers(-12, 25)))
        ref = rng.integers(0, 4, lr).astype(np.uint8)
        q = ref[:lq].copy() if lq <= lr else rng.integers(0, 4, lq).astype(
            np.uint8)
        mut = rng.random(lq) < 0.1
        q[mut] = rng.integers(0, 5, int(mut.sum()))
        ref[rng.random(lr) < 0.02] = 4
        refs.append(ref.tobytes())
        qs.append(q.tobytes())
        quals.append(rng.integers(0, 45, lq).astype(np.uint8).tobytes())
        bws.append(int(rng.integers(0, 16)))
    return refs, qs, quals, bws


def _as_lists(res):
    return [(int(p), [int(v) for v in s], bytes(q)) for p, s, q in res]


@pytest.mark.parametrize("seed", [0, 1])
def test_probaln_matches_jax_and_scalar(seed):
    refs, qs, quals, bws = _reads(60, seed)
    got = tp.probaln_batch_host(refs, qs, quals, bws=bws, device="cpu")
    want = _as_lists(jp.probaln_batch_host(refs, qs, quals, bws=bws))
    assert got == want
    held = 0
    for g, r, q, iq, b in zip(got, refs, qs, quals, bws):
        sc = _scalar(r, q, iq, b, 0.001)
        if sc is not None:
            assert g == sc
            held += 1
    assert held >= len(got) // 2


def _scalar(r, q, iq, bw, d):
    """probaln_glocal's integers, or None where it fails: where a base's
    MAP mass rounds to 1 it takes log(1 - mx) = log(0) (ROADMAP queue C;
    the JAX function sums the mass off the maximum instead)."""
    try:
        res = jrealn.probaln_glocal(r, q, iq, jrealn.ProbalnParams(d, 0.1,
                                                                   bw))
    except ValueError:
        return None
    return _as_lists([res])[0]


def test_probaln_padded_j_and_d_match_jax():
    """A J past 2 * max(bw) + 2 changes no output, and the long-read
    group's d = 1e-7 is the JAX function's too."""
    arrays, J = probaln_batch_args(80, seed=3)
    for d, extra in ((0.001, 0), (0.001, 9), (1e-7, 4)):
        want = jp.probaln_batch(*[jnp.asarray(a) for a in arrays],
                                J + extra, d=d)
        got = tp.probaln_batch(*[torch.from_numpy(a) for a in arrays],
                               J + extra, d=d)
        for g, w in zip(got, carry.from_jax_probaln(*want)):
            assert torch.equal(g, w)


def test_probaln_float32_within_one_phred():
    refs, qs, quals, bws = _reads(60, 4)
    f64 = tp.probaln_batch_host(refs, qs, quals, bws=bws, device="cpu")
    f32 = tp.probaln_batch_host(refs, qs, quals, bws=bws, device="cpu",
                                dtype=np.float32)
    for (p64, _s64, q64), (p32, _s32, q32) in zip(f64, f32):
        assert abs(p64 - p32) <= 1
        assert np.abs(np.frombuffer(q64, np.uint8).astype(int)
                      - np.frombuffer(q32, np.uint8)).max() <= 1


def test_probaln_refuses_what_it_cannot_band():
    arrays, _ = probaln_batch_args(10, seed=6)
    J = 2 * int(arrays[5].max()) + 2
    args = [torch.from_numpy(a) for a in arrays]
    with pytest.raises(ValueError, match="band wider than J"):
        tp.probaln_batch(*args, J - 1)
    args[1] = torch.zeros_like(args[1])
    with pytest.raises(ValueError):
        tp.probaln_batch(*args, J)


_HARNESS = r"""
#include "probaln_step.cuh"

// Each read of a padded batch through probaln_read<double>, its scratch
// one read's rows (cell stride 1, row stride J).
extern "C" void probaln_reads(const uint8_t* ref, const int32_t* rlen,
                              const uint8_t* query, const int32_t* qlen,
                              const double* qprob, const int32_t* bw, int B,
                              int R, int Q, double d, double e, double* buf,
                              int32_t* pr, int32_t* state, uint8_t* q) {
  for (int b = 0; b < B; ++b) {
    const int J = 2 * bw[b] + 2, lq = qlen[b];
    PbScratch<double> s;
    s.cell = 1;
    s.row = J;
    s.fM = buf;
    s.fI = buf + (int64_t)lq * J;
    s.ring = s.fI + (int64_t)lq * J;
    s.ss = s.ring + 8 * J;
    PbRead<double> r = {ref + (int64_t)b * R, query + (int64_t)b * Q,
                        qprob + (int64_t)b * Q, rlen[b], lq, bw[b], d, e};
    pr[b] = probaln_read<double>(r, s, state + (int64_t)b * Q,
                                 q + (int64_t)b * Q);
  }
}
"""


def _compile(tmp, header_text=None):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the step harness needs a C++ compiler")
    inc = CSRC
    if header_text is not None:
        inc = str(tmp)
        (tmp / "probaln_step.cuh").write_text(header_text)
    src = tmp / "harness.cpp"
    src.write_text(_HARNESS)
    lib = tmp / "libprobaln.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-shared", "-fPIC", "-O2",
                    "-ffp-contract=off", "-I", inc, "-o", str(lib),
                    str(src)], check=True)
    h = ctypes.CDLL(str(lib))
    h.probaln_reads.restype = None
    h.probaln_reads.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
        + [ctypes.c_double] * 2 + [ctypes.c_void_p] * 4
    return h


@pytest.fixture(scope="module")
def step_lib(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("probaln"))


def _step_run(h, arrays, J, d):
    ref, rlen, qry, qlen, qpr, bw = arrays
    B, Q = qry.shape
    buf = np.zeros((2 * Q + 8) * J + Q, np.float64)
    pr = np.zeros(B, np.int32)
    st = np.zeros((B, Q), np.int32)
    qq = np.zeros((B, Q), np.uint8)
    h.probaln_reads(ref.ctypes.data, rlen.ctypes.data, qry.ctypes.data,
                    qlen.ctypes.data, qpr.ctypes.data, bw.ctypes.data, B,
                    ref.shape[1], Q, d, 0.1, buf.ctypes.data, pr.ctypes.data,
                    st.ctypes.data, qq.ctypes.data)
    return pr, st, qq


@pytest.mark.parametrize("seed,d", [(7, 0.001), (8, 1e-7)])
def test_probaln_step_matches_plain_and_scalar(step_lib, seed, d):
    arrays, J = probaln_batch_args(120, seed=seed, long_every=29)
    ref, rlen, qry, qlen, qpr, bw = arrays
    B = qry.shape[0]
    pr, st, qq = _step_run(step_lib, arrays, J, d)
    want = tp.probaln_plain(*[torch.from_numpy(a) for a in arrays], J, d=d)
    assert np.array_equal(pr, want[0].numpy())
    assert np.array_equal(st, want[1].numpy())
    assert np.array_equal(qq, want[2].numpy())
    held = 0
    for b in range(0, B, 3):
        n = int(qlen[b])
        sc = _scalar(ref[b, :rlen[b]].tobytes(), qry[b, :n].tobytes(),
                     np.round(-10 * np.log10(qpr[b, :n])).astype(
                         np.uint8).tobytes(), int(bw[b]), d)
        if sc is not None:
            assert (int(pr[b]), st[b, :n].tolist(), qq[b, :n].tobytes()) \
                == sc
            held += 1
    assert held >= B // 6


def test_probaln_step_mutation_fails(tmp_path):
    """A MAP that sums every product into `rest` (1 - mx / sum's mass,
    the scalar's form) must disagree with the plain version."""
    with open(os.path.join(CSRC, "probaln_step.cuh")) as fp:
        text = fp.read()
    mutated = text.replace("rest = rest + (2 * j == arg ? T(0) : zm);",
                           "rest = rest + zm;")
    assert mutated != text
    h = _compile(tmp_path, mutated)
    arrays, J = probaln_batch_args(60, seed=9)
    got = _step_run(h, arrays, J, 0.001)
    want = tp.probaln_plain(*[torch.from_numpy(a) for a in arrays], J)
    assert not np.array_equal(got[2], want[2].numpy())
