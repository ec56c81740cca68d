"""Kernel X5's segmented walk (csrc/record_scan.cu) on the CPU: the passes'
arithmetic in csrc/record_scan_step.cuh (`rscan_looks`, `rscan_seg_walk`,
`rscan_follow`, and the serial `rscan_walk` the tail takes) compiled with
g++ and run as the three kernels run it (pass 1 a segment at a time, pass
2 over tiles of summaries with segments walked again and the serial tail,
pass 3 the writes and the fill), with small segments so that small
payloads span many of them.  Held against the plain version
(`record_scan_plain`) and the JAX package's `device_record_scan` on the
segmented walk's edge streams (chip_smoke.seg_edge_streams: crafted false
entries, a record longer than three segments, negative, -4 and wrapping
lengths in a segment's middle, max_records in a segment's middle, 0-4
byte payloads, a length not a multiple of 16) and on X5's older edge
streams; mutated copies (verification skipped, the prefix off by one)
must fail.  Outputs are integers: equality is exact."""
import ctypes
import os
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import seg_edge_streams, varied_bam_stream
from htslib_tpu.ops import bam2sam as jb
from htslib_tpu_torch.ops import bam2sam as tb
from test_torch_gpu import scan_payloads

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "htslib_tpu_torch", "csrc")
SEG = 256                          # the harness's segments: 2^8 bytes
GOOD = varied_bam_stream(300, 4)   # about 270 bytes a record
EDGES = seg_edge_streams(GOOD, 300, SEG)


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX reference runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    jax.config.update("jax_enable_x64", False)


_HARNESS = r"""
#include <string.h>
#include <algorithm>
#include <vector>
#include "record_scan_step.cuh"

// Bytes [base, base + n) of the payload, zero past u (the kernels' stage).
static void stage(std::vector<uint8_t>& w, const uint8_t* payload,
                  int64_t base, int64_t n, int32_t u) {
  w.assign(n, 0);
  for (int64_t i = 0; i < n; ++i)
    if (base + i >= 0 && base + i < u) w[i] = payload[base + i];
}

// record_scan.cu's serial_walk from step k at pos: windows of `win` bytes.
static int32_t serial(const uint8_t* payload, int32_t u, int32_t m,
                      int32_t win, int32_t pos, int32_t k, int32_t* offs,
                      int32_t* sizes) {
  std::vector<uint8_t> w;
  int64_t base = u >= 4 ? rscan_at(pos, u) & ~(int64_t)15 : 0;
  bool done = k >= m || !rscan_ok(pos, u);
  while (!done) {
    stage(w, payload, base, win, u);
    done = rscan_walk(w.data(), base, win, u, &pos, &k, m, offs, sizes);
    if (done) break;
    const int64_t next = base + win - 16;
    const int64_t at = rscan_at(pos, u);
    base = at >= next && at + 4 <= next + win ? next : (at & ~(int64_t)15);
  }
  return k;
}

// The segmented scan as the kernels run it: segments of 2^shift bytes,
// pass 2's summaries `tile` segments at a time, at most max_rewalks
// segments walked again.  stats: segments, segments walked again, serial
// tail steps, segments verified.  Returns n.
extern "C" int32_t seg_scan(const uint8_t* payload, int32_t u, int32_t m,
                            int shift, int tile, int max_rewalks,
                            int32_t* offs, int32_t* sizes, int32_t* stats) {
  const int32_t seg = 1 << shift;
  const int32_t n_seg = (int32_t)(((int64_t)u + seg - 1) >> shift);
  std::vector<int32_t> g(n_seg), e(n_seg), c(n_seg), f(n_seg), sk(n_seg);
  std::vector<uint16_t> starts((size_t)n_seg << (shift - 2));
  std::vector<uint8_t> w;
  // pass 1
  for (int32_t s = 0; s < n_seg; ++s) {
    const int32_t lo = s << shift;
    const int32_t hi = std::min<int64_t>((int64_t)lo + seg, u);
    const int64_t wend = std::min<int64_t>((int64_t)lo + seg + 256, u);
    stage(w, payload, lo, seg + 256, u);
    int32_t guess = s == 0 ? 0 : -1;
    for (int32_t p = lo; s != 0 && p < hi; ++p)
      if (rscan_looks(w.data(), lo, wend, u, p)) {
        guess = p;
        break;
      }
    int32_t exit = -1, status = RSCAN_EXIT, cnt = 0;
    if (guess >= 0)
      cnt = rscan_seg_walk(w.data(), lo, u, lo, hi, guess,
                           &starts[(size_t)s << (shift - 2)], &exit,
                           &status);
    g[s] = guess;
    e[s] = exit;
    c[s] = cnt;
    f[s] = status;
    sk[s] = -1;
  }
  // pass 2
  RscanFollow st = {0, 0, 0};
  int32_t s0 = 0, s1 = 0;
  std::vector<int32_t> t(4 * tile);
  int why;
  for (;;) {
    const int32_t s = st.pos >> shift;
    if (rscan_ok(st.pos, u) && st.k < m && s >= s1) {
      s0 = s;
      s1 = std::min(s0 + tile, n_seg);
      for (int32_t i = 0; i < s1 - s0; ++i) {
        t[i] = g[s0 + i];
        t[tile + i] = e[s0 + i];
        t[2 * tile + i] = c[s0 + i];
        t[3 * tile + i] = f[s0 + i];
      }
    }
    why = rscan_follow(t.data(), t.data() + tile, t.data() + 2 * tile,
                       t.data() + 3 * tile, s0, s1, shift, u, m, sk.data(),
                       &st);
    if (why == RSCAN_TILE) continue;
    if (why != RSCAN_MISS || st.rewalks >= max_rewalks) break;
    const int32_t ms = st.pos >> shift;
    const int32_t lo = ms << shift;
    const int32_t hi = std::min<int64_t>((int64_t)lo + seg, u);
    stage(w, payload, lo, seg + 16, u);
    int32_t exit, status;
    const int32_t cnt = rscan_seg_walk(w.data(), lo, u, lo, hi, st.pos,
                                       &starts[(size_t)ms << (shift - 2)],
                                       &exit, &status);
    const int32_t i = ms - s0;
    t[i] = g[ms] = st.pos;
    t[tile + i] = e[ms] = exit;
    t[2 * tile + i] = c[ms] = cnt;
    t[3 * tile + i] = f[ms] = status;
    st.rewalks += 1;
  }
  const int32_t n = why == RSCAN_DONE
                        ? std::min(st.k, m)
                        : serial(payload, u, m, 4096, st.pos, st.k, offs,
                                 sizes);
  // pass 3
  int32_t verified = 0;
  for (int32_t s = 0; s < n_seg; ++s) {
    if (sk[s] < 0) continue;
    ++verified;
    for (int32_t i = 0; i < c[s] && sk[s] + i < n; ++i) {
      const int32_t p = (s << shift) + starts[((size_t)s << (shift - 2)) + i];
      offs[sk[s] + i] = p;
      sizes[sk[s] + i] = rscan_len(payload, p);
    }
  }
  for (int32_t k = n; k < m; ++k) {
    offs[k] = -1;
    sizes[k] = 0;
  }
  stats[0] = n_seg;
  stats[1] = st.rewalks;
  stats[2] = why == RSCAN_DONE ? 0 : n - st.k;
  stats[3] = verified;
  return n;
}
"""


def _compile(tmp_path, header_text=None):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the step harness needs a C++ compiler")
    inc = CSRC
    if header_text is not None:
        inc = str(tmp_path)
        (tmp_path / "record_scan_step.cuh").write_text(header_text)
    src = tmp_path / "harness.cpp"
    src.write_text(_HARNESS)
    lib = tmp_path / "libsegscan.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-shared", "-fPIC", "-O2",
                    "-I", inc, "-o", str(lib), str(src)], check=True)
    h = ctypes.CDLL(str(lib))
    h.seg_scan.restype = ctypes.c_int32
    h.seg_scan.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    return h


@pytest.fixture(scope="module")
def seg_lib(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("segscan"))


def _u8(payload: bytes) -> np.ndarray:
    # one spare byte, so an empty payload still has an address
    return np.frombuffer(payload + b"\0", np.uint8)[:len(payload)].copy()


def _seg_scan(h, payload, n, shift=8, tile=64, rewalks=16):
    pl = _u8(payload)
    offs = np.zeros(max(n, 1), np.int32)
    sizes = np.zeros(max(n, 1), np.int32)
    stats = np.zeros(4, np.int32)
    k = h.seg_scan(pl.ctypes.data, len(pl), n, shift, tile, rewalks,
                   offs.ctypes.data, sizes.ctypes.data, stats.ctypes.data)
    return offs[:n], sizes[:n], k, stats


def _plain(payload, n):
    return tb.record_scan_plain(torch.from_numpy(_u8(payload)), n)


def _same(got, want):
    return (np.array_equal(got[0], want[0].numpy())
            and np.array_equal(got[1], want[1].numpy())
            and got[2] == int(want[2]))


@pytest.mark.parametrize("name", list(EDGES))
def test_seg_scan_matches_plain_and_jax(seg_lib, name):
    """Each edge stream, at 2^8-byte segments, equals the plain version
    and the JAX function (offsets, sizes, n)."""
    payload, n = EDGES[name]
    got = _seg_scan(seg_lib, payload, n)
    assert _same(got, _plain(payload, n))
    if len(payload) >= 4:
        # the JAX function indexes a payload of at least 4 bytes
        want = jb.device_record_scan(jnp.asarray(_u8(payload)), n)
        assert np.array_equal(got[0], np.asarray(want[0]))
        assert np.array_equal(got[1], np.asarray(want[1]))
        assert got[2] == int(want[2])


def test_seg_scan_edges_take_their_paths(seg_lib):
    """At 4 KiB segments, where a segment holds records whole, the edges
    reach what they were made for: the false entries are walked again
    (past the rewalks the serial tail takes over), the stopped walks hand
    the chain to the serial tail, the long record skips segments, and the
    well-framed stream and max_records need neither."""
    edges = seg_edge_streams(GOOD, 300, 1 << 12)
    stats = {k: _seg_scan(seg_lib, p, n, 12)[3] for k, (p, n) in
             edges.items()}
    good = _seg_scan(seg_lib, GOOD, 300, 12)[3]
    assert good[1] == 0 and good[2] == 0 and good[3] == good[0] > 16
    assert stats["false_few"][1] == 3 and stats["false_few"][2] == 0
    few = _seg_scan(seg_lib, *edges["false_all"], 12, 64, 4)
    assert few[3][1] == 4 and few[3][2] > 0
    assert _same(few, _plain(*edges["false_all"]))
    for name in ("neg_mid", "minus4_mid", "wrap_mid"):
        assert stats[name][2] > 0, name
    assert stats["long_record"][3] < stats["long_record"][0] - 2
    assert stats["max_mid"][1] == stats["max_mid"][2] == 0


@pytest.mark.parametrize("shift,tile,rewalks", [(4, 3, 16), (6, 1, 0),
                                                (10, 5, 2), (16, 2048, 16)])
def test_seg_scan_shapes_match_plain(seg_lib, shift, tile, rewalks):
    """Other segment sizes (16 bytes to 64 KiB), tiles of one summary and
    more, and no rewalks at all (every missed segment goes to the serial
    tail) give the plain version's result on every edge stream and on
    X5's older ones."""
    for name, (payload, n) in list(EDGES.items()) + list(
            scan_payloads().items()):
        got = _seg_scan(seg_lib, payload, n, shift, tile, rewalks)
        assert _same(got, _plain(payload, n)), name


@pytest.mark.parametrize("mutation", ["no_verify", "prefix_off_by_one"])
def test_seg_scan_mutation_fails(tmp_path, mutation):
    """A follow that accepts a segment whatever its guess, or gives a
    verified segment the count after its entry's plus one, must disagree
    with the plain version."""
    with open(os.path.join(CSRC, "record_scan_step.cuh")) as fp:
        text = fp.read()
    pat, rep = {
        "no_verify": (r"if \(g\[s - s0\] != st->pos\)",
                      "if (g[s - s0] < 0)"),
        "prefix_off_by_one": (r"seg_k\[s\] = st->k;",
                              "seg_k[s] = st->k + 1;"),
    }[mutation]
    mutated, n_sub = re.subn(pat, rep, text)
    assert n_sub == 1
    h = _compile(tmp_path, mutated)
    bad = sum(not _same(_seg_scan(h, p, n), _plain(p, n))
              for p, n in EDGES.values())
    assert bad > 0
