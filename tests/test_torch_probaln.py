"""The port's batched BAQ HMM (htslib_tpu_torch/ops/probaln.py, kernel X6's
plain version) against the JAX package's probaln_batch (htslib_tpu/
ops/probaln.py, XLA on the CPU in float64) and the scalar
probaln_glocal (htslib_tpu/realn.py): Pr, MAP states and qualities are
integers and must be equal, with mixed bands and a padded J; float32
runs are held within +/-1 phred of float64 (the output contract of
ops/probaln.py); and X6's per-read routines (csrc/probaln_step.cuh: a
read a thread, and a read a warp with its 32 lanes run in turn) compiled
with g++ -ffp-contract=off against the same integers, the warp routine's
row sums bit-equal to the thread routine's."""
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

// Each read of a padded batch through probaln_read<T>, its scratch one
// read's rows (cell stride 1, row stride J); ss_out [B, Q] gets each
// read's row sums and flag [B, Q] its MAP flags.
template <typename T>
static void thread_reads(const uint8_t* ref, const int32_t* rlen,
                         const uint8_t* query, const int32_t* qlen,
                         const T* qprob, const int32_t* bw, int B, int R,
                         int Q, double d, double e, T* buf, int32_t* pr,
                         int32_t* state, uint8_t* q, uint8_t* flag,
                         T* ss_out) {
  for (int b = 0; b < B; ++b) {
    const int J = 2 * bw[b] + 2, lq = qlen[b];
    PbScratch<T> s;
    s.cell = 1;
    s.row = J;
    s.fM = buf;
    s.fI = buf + (int64_t)lq * J;
    s.ring = s.fI + (int64_t)lq * J;
    s.ss = s.ring + 8 * J;
    PbRead<T> r = {ref + (int64_t)b * R, query + (int64_t)b * Q,
                   qprob + (int64_t)b * Q, rlen[b], lq, bw[b], d, e};
    pr[b] = probaln_read<T>(r, s, state + (int64_t)b * Q,
                            q + (int64_t)b * Q, flag + (int64_t)b * Q);
    for (int i = 0; i < lq; ++i) ss_out[(int64_t)b * Q + i] = s.ss[i];
  }
}

// The same reads through probaln_read_warp<T>, the warp's 32 lanes run in
// turn: scratch pb_warp_scratch(lq, J) elements at buf, the exchange at x.
template <typename T>
static void warp_reads(const uint8_t* ref, const int32_t* rlen,
                       const uint8_t* query, const int32_t* qlen,
                       const T* qprob, const int32_t* bw, int B, int R,
                       int Q, double d, double e, T* buf, T* x, int32_t* pr,
                       int32_t* state, uint8_t* q, uint8_t* flag,
                       T* ss_out) {
  for (int b = 0; b < B; ++b) {
    const int J = 2 * bw[b] + 2, lq = qlen[b];
    const int64_t cells = (int64_t)lq * J;
    PbWarpScratch<T> s;
    s.fM = buf;
    s.fI = s.fM + cells;
    s.bM = s.fI + cells;
    s.bI = s.bM + cells;
    s.ss = s.bI + cells;
    s.lg = s.ss + lq;
    s.x = x;
    PbRead<T> r = {ref + (int64_t)b * R, query + (int64_t)b * Q,
                   qprob + (int64_t)b * Q, rlen[b], lq, bw[b], d, e};
    pr[b] = probaln_read_warp<T>(r, s, state + (int64_t)b * Q,
                                 q + (int64_t)b * Q, flag + (int64_t)b * Q);
    for (int i = 0; i < lq; ++i) ss_out[(int64_t)b * Q + i] = s.ss[i];
  }
}

#define PB_ARGS(T) const uint8_t *ref, const int32_t *rlen,               \
    const uint8_t *query, const int32_t *qlen, const T *qprob,            \
    const int32_t *bw, int B, int R, int Q, double d, double e, T *buf
#define PB_OUTS int32_t *pr, int32_t *state, uint8_t *q, uint8_t *flag
#define PB_PASS ref, rlen, query, qlen, qprob, bw, B, R, Q, d, e, buf
extern "C" void probaln_reads(PB_ARGS(double), PB_OUTS, double* ss) {
  thread_reads<double>(PB_PASS, pr, state, q, flag, ss);
}
extern "C" void probaln_reads_f32(PB_ARGS(float), PB_OUTS, float* ss) {
  thread_reads<float>(PB_PASS, pr, state, q, flag, ss);
}
extern "C" void probaln_warp_reads(PB_ARGS(double), double* x, PB_OUTS,
                                   double* ss) {
  warp_reads<double>(PB_PASS, x, pr, state, q, flag, ss);
}
extern "C" void probaln_warp_reads_f32(PB_ARGS(float), float* x, PB_OUTS,
                                       float* ss) {
  warp_reads<float>(PB_PASS, x, pr, state, q, flag, ss);
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
    args = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 \
        + [ctypes.c_double] * 2
    for name, n_ptr in (("probaln_reads", 6), ("probaln_reads_f32", 6),
                        ("probaln_warp_reads", 7),
                        ("probaln_warp_reads_f32", 7)):
        getattr(h, name).restype = None
        getattr(h, name).argtypes = args + [ctypes.c_void_p] * n_ptr
    return h


@pytest.fixture(scope="module")
def step_lib(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("probaln"))


def _step_run(h, arrays, J, d, warp=False, with_ss=False, with_flag=False):
    """The thread routine (or with `warp` the warp routine) over a padded
    batch: (Pr, states, q), with `with_ss` the row sums [B, Q] and with
    `with_flag` the MAP flags [B, Q] after them."""
    ref, rlen, qry, qlen, qpr, bw = arrays
    B, Q = qry.shape
    dt = qpr.dtype
    Jr = 2 * int(bw.max()) + 2
    buf = np.zeros((4 * Jr + 8) * Q + 8 * Jr, dt)
    pr = np.zeros(B, np.int32)
    st = np.zeros((B, Q), np.int32)
    qq = np.zeros((B, Q), np.uint8)
    ss = np.zeros((B, Q), dt)
    flag = np.zeros((B, Q), np.uint8)
    name = ("probaln_warp_reads" if warp else "probaln_reads") + (
        "_f32" if dt == np.float32 else "")
    xbuf = np.zeros(6 * ((Jr + 7) & ~7) + 4, dt)
    x = [xbuf.ctypes.data] if warp else []
    getattr(h, name)(ref.ctypes.data, rlen.ctypes.data, qry.ctypes.data,
                     qlen.ctypes.data, qpr.ctypes.data, bw.ctypes.data, B,
                     ref.shape[1], Q, d, 0.1, buf.ctypes.data, *x,
                     pr.ctypes.data, st.ctypes.data, qq.ctypes.data,
                     flag.ctypes.data, ss.ctypes.data)
    return (pr, st, qq) + ((ss,) if with_ss else ()) + (
        (flag,) if with_flag else ())


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


@pytest.mark.parametrize("seed,d", [(7, 0.001), (8, 1e-7)])
def test_probaln_step_flags_match_plain_and_scalar(step_lib, seed, d):
    """The MAP flags of both routines equal the plain version's, and a
    read has one exactly where the JAX scalar raises on it."""
    arrays, J = probaln_batch_args(120, seed=seed, long_every=29)
    ref, rlen, qry, qlen, qpr, bw = arrays
    want = torch.zeros(qry.shape, dtype=torch.uint8)
    tp.probaln_plain(*[torch.from_numpy(a) for a in arrays], J, d=d,
                     flag=want)
    for warp in (False, True):
        got = _step_run(step_lib, arrays, J, d, warp=warp, with_flag=True)
        assert np.array_equal(got[3], want.numpy())
    flagged = 0
    for b in range(qry.shape[0]):
        n = int(qlen[b])
        sc = _scalar(ref[b, :rlen[b]].tobytes(), qry[b, :n].tobytes(),
                     np.round(-10 * np.log10(qpr[b, :n])).astype(
                         np.uint8).tobytes(), int(bw[b]), d)
        assert (sc is None) == bool(want[b].any())
        flagged += sc is None
    assert flagged > 0


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


def _long_reads(bws, seed, lq_range=(1000, 2001), dtype=np.float64):
    """Long reads (lq in lq_range) for the warp routine: each its own
    reference window, 1% substitutions, one 1-12 bp insertion or deletion
    in every other read, qualities 2-41, ambiguous bases; one read a band
    width of `bws` (J = 2 * bw + 2, past 32).  Returns pad_batch's
    (arrays, J)."""
    rng = np.random.default_rng(seed)
    refs, qs, quals = [], [], []
    for k in range(len(bws)):
        lq = int(rng.integers(*lq_range))
        ref = rng.integers(0, 4, lq + 40).astype(np.uint8)
        q = ref[5:5 + lq].copy()
        if k % 2:
            at, n = int(rng.integers(50, lq - 50)), int(rng.integers(1, 13))
            if k % 4 == 1:
                q = np.concatenate([q[:at], rng.integers(0, 4, n).astype(
                    np.uint8), q[at:lq - n]])
            else:
                q = np.concatenate([q[:at], ref[5 + at + n:5 + lq + n]])
        sub = rng.random(lq) < 0.01
        q[sub] = rng.integers(0, 5, int(sub.sum()))
        ref[rng.random(len(ref)) < 0.002] = 4
        refs.append(ref[:lq + int(rng.integers(0, 30))].tobytes())
        qs.append(q[:lq].tobytes())
        quals.append(np.clip(rng.integers(25, 38) + np.cumsum(
            rng.integers(-2, 3, lq)), 2, 41).astype(np.uint8).tobytes())
    return tp.pad_batch(refs, qs, quals, dtype=dtype, bws=list(bws))


@pytest.mark.parametrize("d", [1e-7, 0.001])
def test_probaln_warp_step_matches_plain_and_jax(step_lib, d):
    """The warp routine on long reads (lq 1,000-2,000, J 34-40 with the
    batch's J padded to an odd width): the plain version's and the JAX
    function's Pr, states and q, and the thread routine's row sums bit
    for bit."""
    arrays, J = _long_reads([16, 17, 19, 18], seed=21)
    got = _step_run(step_lib, arrays, J, d, warp=True, with_ss=True)
    thread = _step_run(step_lib, arrays, J, d, with_ss=True)
    want = tp.probaln_plain(*[torch.from_numpy(a) for a in arrays], J + 1,
                            d=d)
    jax_want = carry.from_jax_probaln(*jp.probaln_batch(
        *[jnp.asarray(a) for a in arrays], J + 1, d=d))
    for g, w, jw in zip(got[:3], want, jax_want):
        assert np.array_equal(g, w.numpy())
        assert np.array_equal(g, jw.numpy())
    assert np.array_equal(got[3].view(np.uint64), thread[3].view(np.uint64))


def test_probaln_warp_step_wide_bands_match_jax(step_lib):
    """Bands past 64 cells (each lane takes three) and indels: the JAX
    function's integers and the thread routine's row sums."""
    arrays, J = _long_reads([40, 33, 31, 45], seed=22, lq_range=(1000, 1400))
    assert J > 64
    got = _step_run(step_lib, arrays, J, 1e-7, warp=True, with_ss=True)
    thread = _step_run(step_lib, arrays, J, 1e-7, with_ss=True)
    want = carry.from_jax_probaln(*jp.probaln_batch(
        *[jnp.asarray(a) for a in arrays], J, d=1e-7))
    for g, t, w in zip(got[:3], thread[:3], want):
        assert np.array_equal(g, w.numpy())
        assert np.array_equal(g, t)
    assert np.array_equal(got[3].view(np.uint64), thread[3].view(np.uint64))


def test_probaln_warp_step_float32(step_lib):
    """In float32 the warp routine gives the thread routine's bits and
    stays within +/-1 phred of float64."""
    a64, J = _long_reads([16, 19, 21], seed=23)
    a32, _ = _long_reads([16, 19, 21], seed=23, dtype=np.float32)
    f64 = _step_run(step_lib, a64, J, 1e-7, warp=True)
    f32 = _step_run(step_lib, a32, J, 1e-7, warp=True, with_ss=True)
    t32 = _step_run(step_lib, a32, J, 1e-7, with_ss=True)
    for g, t in zip(f32, t32):
        assert np.array_equal(g, t)
    assert np.abs(f64[0].astype(int) - f32[0]).max() <= 1
    assert np.abs(f64[2].astype(int) - f32[2]).max() <= 1


def test_probaln_warp_step_swapped_sum_fails(tmp_path):
    """A warp routine whose row sum adds a cell's I and D terms before its
    M term (a swapped summation order, as a scan would reorder it) must
    not give the thread routine's row sums."""
    with open(os.path.join(CSRC, "probaln_step.cuh")) as fp:
        text = fp.read()
    old = "rsum = rsum + (mv[u] + iv[u] + dd);"
    assert text.count(old) == 1
    h = _compile(tmp_path, text.replace(old,
                                        "rsum = rsum + (mv[u] + (iv[u] + dd));"))
    arrays, J = _long_reads([16, 17], seed=24)
    got = _step_run(h, arrays, J, 1e-7, warp=True, with_ss=True)
    thread = _step_run(h, arrays, J, 1e-7, with_ss=True)
    assert not np.array_equal(got[3].view(np.uint64),
                              thread[3].view(np.uint64))
