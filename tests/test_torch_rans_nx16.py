"""The port's rANS Nx16 O0 32-way decode (htslib_tpu_torch/ops/
rans_nx16.py, kernel B2's plain version on the CPU) against the host
codec and the JAX package's Pallas decode in interpret mode; the state
carried across (htslib_tpu_torch/carry.py); and the kernels' per-state
step (csrc/rans_nx16_step.cuh) compiled for the CPU.  Bytes and states:
equality is exact."""
import ctypes
import os
import shutil
import subprocess

import jax
import numpy as np
import pytest
import torch

from htslib_tpu.codecs.rans4x16 import compress, uncompress
from htslib_tpu.ops import rans_pallas
from htslib_tpu.ops.device_stats import _prepare_group
from htslib_tpu_torch import carry
from htslib_tpu_torch.codecs import rans4x16 as trans
from htslib_tpu_torch.ops import rans_nx16 as tr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "htslib_tpu_torch", "csrc")


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX reference runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    jax.config.update("jax_enable_x64", False)


def _cases():
    rng = np.random.RandomState(3)
    cases = {
        "quality": rng.randint(0, 40, 5000).astype(np.uint8).tobytes(),
        "four_base": rng.randint(0, 4, 3000).astype(np.uint8).tobytes(),
        "full_alphabet": rng.randint(0, 256, 2000).astype(np.uint8)
        .tobytes(),
        "tiny": rng.randint(0, 40, 100).astype(np.uint8).tobytes(),
        "constant": bytes(500),
        "sub_round": rng.randint(0, 40, 64).astype(np.uint8).tobytes(),
        "ulen_mod32": rng.randint(0, 40, 1007).astype(np.uint8).tobytes(),
        "ulen_lt32": rng.randint(0, 40, 13).astype(np.uint8).tobytes(),
        "one_symbol": bytes([37]) * 2000,
    }
    # more than 32 streams: the JAX decode takes two groups
    for i in range(26):
        cases[f"filler{i}"] = rng.randint(
            10, 50, 40 + 37 * i).astype(np.uint8).tobytes()
    return cases


CASES = _cases()
NAMES = list(CASES)


@pytest.fixture(scope="module")
def decoded():
    encs = [compress(CASES[k], 0x04) for k in NAMES]
    port = tr.decode_nx16_o0_batch(encs, device="cpu")
    jax = rans_pallas.decode_nx16_o0_batch(encs, interpret=True)
    return dict(zip(NAMES, zip(encs, port, jax)))


@pytest.mark.parametrize("name", NAMES[:9] + ["filler25"])
def test_decode_matches_host_and_jax(decoded, name):
    enc, port, jax = decoded[name]
    assert len(NAMES) > 32
    assert port == CASES[name]
    assert port == uncompress(enc)
    assert port == jax


def test_port_codec_matches_reference_codec():
    """The port's own rans4x16 copy writes and reads the same wire."""
    for name in ("quality", "ulen_mod32", "one_symbol"):
        d = CASES[name]
        for flags in (0x04, 0x00, 0x05, 0x0C, 0x84, 0x44):
            enc = compress(d, flags)
            assert trans.compress(d, flags) == enc
            assert trans.uncompress(enc) == d


@pytest.mark.parametrize("flags", [0x00, 0x05])
def test_flags_raise_as_jax(flags):
    enc = compress(CASES["quality"], flags)
    with pytest.raises(ValueError) as port_err:
        tr.decode_nx16_o0_batch([enc], device="cpu")
    with pytest.raises(ValueError) as jax_err:
        rans_pallas.decode_nx16_o0_batch([enc], interpret=True)
    assert str(port_err.value) == str(jax_err.value)


def test_decode_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tr.decode_nx16_o0_batch([compress(CASES["tiny"], 0x04)])


def test_carry_segment_state_equals_jax():
    """From the JAX front end's arrays, the port's state after 2048
    rounds equals the state one JAX segment call leaves."""
    rng = np.random.default_rng(8)
    datas = [rng.integers(20, 41, 70000 + 5 * i, dtype=np.uint8).tobytes()
             for i in range(2)]
    datas.append(np.clip(np.cumsum(rng.integers(-2, 3, 66000)) + 20, 0,
                         44).astype(np.uint8).tobytes())
    encs = [compress(d, 0x04) for d in datas]
    data_w, lo, dfc, x, out_szs, a_pad, W = _prepare_group(encs)
    run = rans_pallas._compiled_seg(W, a_pad, True)
    syms, x_out, cur_out = run(data_w, lo, dfc, x,
                               np.zeros((1, carry.BLOCKS), np.int32))
    want_x, want_cur = carry.from_jax_segment(x_out, cur_out)

    b = carry.from_jax_group(data_w, lo, dfc, x, out_szs)
    assert b.ulen[:3].tolist() == [len(d) for d in datas]
    out, got_x, got_cur = tr.rans_o0(b, max_rounds=rans_pallas.SEG)
    assert np.array_equal(got_x.numpy().view(np.uint32), want_x)
    assert np.array_equal(got_cur.numpy(), want_cur)
    # the symbols of those rounds are the JAX segment's and the data's
    seg = rans_pallas.SEG * tr.NWAY
    allsym = np.asarray(syms)
    offs = b.out_off.numpy()
    for i, d in enumerate(datas):
        jax_i = allsym[:, i::carry.BLOCKS].reshape(-1).astype(np.uint8)
        assert out[offs[i]:offs[i] + seg].numpy().tobytes() \
            == jax_i.tobytes() == d[:seg]


def test_hist_plain_counts_decoded_symbols():
    encs = [compress(CASES[k], 0x04) for k in NAMES[:9]]
    b = tr.frame_streams(encs, "cpu")
    offs = torch.tensor([0, 1, 2, 3, 4, 5, 6, 7, 200], dtype=torch.int32)
    hist, x_h, cur_h = tr.rans_o0(b, offs=offs, qbins=256)
    syms, x_d, cur_d = tr.rans_o0(b)
    assert torch.equal(x_h, x_d) and torch.equal(cur_h, cur_d)
    for i, o in enumerate(offs.tolist()):
        s = syms[b.out_off[i]:b.out_off[i] + b.ulen[i]].long()
        want = torch.bincount((s - o).clamp(0, 255), minlength=256)
        assert torch.equal(hist[i].long(), want)


_HARNESS = r"""
#include "rans_nx16_step.cuh"

// One stream through the kernels' step code, the 32 lanes of a warp run
// in order: the ballot is the mask of states that need a word, and a
// state's word is cursor + popc(mask & lanes below it).
extern "C" int64_t decode_stream(const int32_t* freq, const uint32_t* x0,
                                 const uint16_t* words, int64_t n_words,
                                 int64_t ulen, uint8_t* out,
                                 uint32_t* x_out) {
  uint16_t f[256];
  uint32_t slot[RANS_TOTFREQ];
  for (int s = 0; s < 256; ++s) f[s] = (uint16_t)freq[s];
  for (int lane = 0; lane < RANS_NWAY; ++lane)
    rans_o0_build_slots(f, slot, lane, RANS_NWAY);
  uint32_t x[RANS_NWAY];
  for (int j = 0; j < RANS_NWAY; ++j) x[j] = x0[j];
  int64_t cur = 0;
  for (int64_t r = 0; r * RANS_NWAY < ulen; ++r) {
    uint32_t mask = 0;
    for (int j = 0; j < RANS_NWAY; ++j) {
      const int64_t pos = r * RANS_NWAY + j;
      if (pos < ulen) {
        out[pos] = (uint8_t)rans_o0_decode(&x[j], slot);
        if (rans_needs_refill(x[j])) mask |= 1u << j;
      }
    }
    for (int j = 0; j < RANS_NWAY; ++j) {
      const uint32_t below = (1u << j) - 1u;
      if (mask >> j & 1u)
        x[j] = rans_refill(
            x[j], rans_word(words, cur + __builtin_popcount(mask & below),
                            n_words));
    }
    cur = rans_advance(cur, __builtin_popcount(mask), n_words);
  }
  for (int j = 0; j < RANS_NWAY; ++j) x_out[j] = x[j];
  return cur;
}

// Slots m of the table of frequencies `freq` (one of 4096, with x = m +
// 4096 * k for a few k) where the kernels' step (rans_o0_fstep, or no
// change for a mono table; rans_o0_fsym) differs from the shared one
// (rans_o0_decode over rans_o0_build_slots).
extern "C" int fslot_mismatches(const int32_t* freq) {
  uint16_t f[256];
  static uint32_t a[RANS_TOTFREQ], b[RANS_TOTFREQ];
  for (int s = 0; s < 256; ++s) f[s] = (uint16_t)freq[s];
  bool mono = false;
  for (int lane = 0; lane < RANS_NWAY; ++lane) {
    rans_o0_build_slots(f, a, lane, RANS_NWAY);
    rans_o0_build_fslots(f, b, lane, RANS_NWAY);
    mono |= rans_o0_mono(f, lane, RANS_NWAY);
  }
  int bad = 0;
  for (uint32_t k = 0; k < 3; ++k)
    for (uint32_t m = 0; m < RANS_TOTFREQ; ++m) {
      const uint32_t x = m + (k == 0 ? 8u : k == 1 ? 91u : 524287u) * 4096u;
      uint32_t xa = x;
      const uint32_t sa = rans_o0_decode(&xa, a);
      const uint32_t e = b[x & (RANS_TOTFREQ - 1)];
      const uint32_t xb = mono ? x : rans_o0_fstep(x, e);
      bad += xa != xb || sa != rans_o0_fsym(e);
    }
  return bad;
}

// One stream as kernels B2/B3 run it (rans_nx16_o0.cu), from the header's
// ring and count functions: the payload reached through a ring that holds
// `lead` words before the stream's first one, chunks copied in when the
// kernel issues them (a chunk at the ring's start into the mirror past its
// end too) but readable only once waited for (until then their slots read
// as poison, so a read before its copy lands decodes wrong),
// blocks of 32 rounds in which every state decodes, then the rounds left
// one at a time; max_rounds >= 0 stops there.  The table is the kernels'
// (rans_o0_build_fslots; a one-symbol table leaves the states as they
// are), each lane's slot taken from its state or, where it refills, from
// the word.  With qbins > 0 the table's symbols are the bins of
// clip(sym - off) and the lanes count into
// u16 column pairs folded every `fold` blocks and at the end (hist gets
// the counts; out is not written), else out gets the symbols.  Returns
// the cursor; *waits gets the blocks that waited for their own copies.
extern "C" int64_t decode_ring(const int32_t* freq, const uint32_t* x0,
                               const uint16_t* words, int64_t n_words,
                               int64_t ulen, int lead, int max_rounds,
                               int qbins, int off, int fold, uint8_t* out,
                               int32_t* hist, uint32_t* x_out,
                               int64_t* waits) {
  uint16_t f[256];
  static uint32_t slot[RANS_TOTFREQ];
  for (int s = 0; s < 256; ++s) f[s] = (uint16_t)freq[s];
  bool mono = false;
  for (int lane = 0; lane < RANS_NWAY; ++lane) {
    mono |= rans_o0_mono(f, lane, RANS_NWAY);
    rans_o0_build_fslots(f, slot, lane, RANS_NWAY);
  }
  if (qbins > 0)
    for (int lane = 0; lane < RANS_NWAY; ++lane)
      rans_o0_bin_fslots(slot, off, qbins, lane, RANS_NWAY);
  static uint16_t ring[RANS_RING_WORDS + RANS_RING_MIRROR];
  for (uint32_t i = 0; i < RANS_RING_WORDS + RANS_RING_MIRROR; ++i)
    ring[i] = 0xBEEF;
  // slot of word k of chunk q, and its mirror slot (or none)
  auto put = [&](uint32_t q, uint32_t k, uint16_t v) {
    const uint32_t at = (q * RANS_RING_CHUNK + k) & (RANS_RING_WORDS - 1);
    ring[at] = v;
    if (at < RANS_RING_MIRROR) ring[RANS_RING_WORDS + at] = v;
  };
  const uint32_t end = (uint32_t)n_words + (uint32_t)lead;
  const uint32_t cap = rans_ring_cap(end);
  uint32_t issued = 0, landed = 0;
  *waits = 0;
  // word i of the ring's numbering: the word before the stream (lead),
  // the stream's words, zeros past its end
  auto land = [&](uint32_t upto) {
    for (; landed < upto; ++landed)
      for (uint32_t k = 0; k < RANS_RING_CHUNK; ++k) {
        const uint32_t i = landed * RANS_RING_CHUNK + k;
        put(landed, k, i < (uint32_t)lead ? 0x5A5A
                       : i < end          ? words[i - lead]
                                          : 0);
      }
  };
  auto stage = [&](uint32_t cur) {
    const uint32_t front = issued;
    for (const uint32_t l = rans_ring_limit(cur, cap); issued < l; ++issued)
      for (uint32_t k = 0; k < RANS_RING_CHUNK; ++k) put(issued, k, 0xDEAD);
    if (rans_ring_ready(front, cur, cap)) {
      land(front);
    } else {
      land(issued);
      ++*waits;
    }
  };
  uint32_t x[RANS_NWAY], m[RANS_NWAY];
  for (int j = 0; j < RANS_NWAY; ++j) {
    x[j] = x0[j];
    m[j] = x[j] & (RANS_TOTFREQ - 1);
  }
  static uint32_t cnt[RANS_NWAY * 128];
  static uint32_t tot[256];
  for (int i = 0; i < RANS_NWAY * 128; ++i) cnt[i] = 0;
  for (int i = 0; i < 256; ++i) tot[i] = 0;
  uint32_t cur = (uint32_t)lead;
  stage(cur);
  const uint32_t n = (uint32_t)ulen;
  uint32_t rounds = (n + RANS_NWAY - 1) / RANS_NWAY;
  if (max_rounds >= 0 && rounds > (uint32_t)max_rounds)
    rounds = (uint32_t)max_rounds;
  const uint32_t full = n / RANS_NWAY < rounds ? n / RANS_NWAY : rounds;
  auto round = [&](uint32_t r, bool all) {
    uint32_t mask = 0, sym[RANS_NWAY];
    bool live[RANS_NWAY];
    for (int j = 0; j < RANS_NWAY; ++j) {
      live[j] = all || r * RANS_NWAY + (uint32_t)j < n;
      const uint32_t e = slot[m[j]];
      sym[j] = rans_o0_fsym(e);
      if (!mono && live[j]) {
        x[j] = rans_o0_fstep(x[j], e);
        m[j] = x[j] & (RANS_TOTFREQ - 1);
      }
      if (live[j] && rans_needs_refill(x[j])) mask |= 1u << j;
    }
    for (int j = 0; j < RANS_NWAY; ++j)
      if (mask >> j & 1u) {
        const uint32_t w = rans_ring_word(
            ring, rans_ring_off(cur),
            __builtin_popcount(mask & ((1u << j) - 1u)));
        x[j] = rans_refill(x[j], w);
        m[j] = w & (RANS_TOTFREQ - 1);
      }
    cur = rans_advance32(cur, __builtin_popcount(mask), end);
    for (int j = 0; j < RANS_NWAY; ++j)
      if (live[j]) {
        if (qbins > 0)
          rans_count(cnt, sym[j], j);
        else
          out[r * RANS_NWAY + j] = (uint8_t)sym[j];
      }
  };
  auto fold_all = [&]() {
    for (int lane = 0; lane < RANS_NWAY; ++lane)
      rans_fold_counts(cnt, tot, qbins, lane, RANS_NWAY);
  };
  uint32_t r = 0;
  int blocks = 0;
  for (; r + RANS_BLOCK_ROUNDS <= full; r += RANS_BLOCK_ROUNDS) {
    for (uint32_t i = 0; i < RANS_BLOCK_ROUNDS; ++i) round(r + i, true);
    if (qbins > 0 && ++blocks == fold) {
      fold_all();
      blocks = 0;
    }
    stage(cur);
  }
  for (; r < rounds; ++r) round(r, false);
  if (qbins > 0) {
    fold_all();
    for (int b = 0; b < qbins; ++b) hist[b] = (int32_t)tot[b];
  }
  for (int j = 0; j < RANS_NWAY; ++j) x_out[j] = x[j];
  return (int64_t)cur - lead;
}
"""


@pytest.fixture(scope="module")
def step_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the step harness needs a C++ compiler")
    d = tmp_path_factory.mktemp("step")
    src = d / "harness.cpp"
    src.write_text(_HARNESS)
    lib = d / "libstep.so"
    subprocess.run([gxx, "-x", "c++", "-shared", "-fPIC", "-O2", "-I", CSRC,
                    "-o", str(lib), str(src)], check=True)
    h = ctypes.CDLL(str(lib))
    h.decode_stream.restype = ctypes.c_int64
    h.decode_stream.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 \
        + [ctypes.c_void_p] * 2
    h.fslot_mismatches.restype = ctypes.c_int
    h.fslot_mismatches.argtypes = [ctypes.c_void_p]
    h.decode_ring.restype = ctypes.c_int64
    h.decode_ring.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
    return h


@pytest.mark.parametrize("name", ["quality", "full_alphabet", "ulen_mod32",
                                  "one_symbol", "ulen_lt32"])
def test_step_header_on_cpu(step_lib, name):
    """The CUDA step code, compiled for the host with the ballot/popc
    refill run in order, decodes byte for byte and leaves the plain
    version's final states and cursor."""
    enc = compress(CASES[name], 0x04)
    b = tr.frame_streams([enc], "cpu")
    words = b.payload.numpy()
    freq = b.freqs.numpy()[0].copy()
    x0 = b.x0.numpy()[0].view(np.uint32).copy()
    ulen = int(b.ulen[0])
    out = np.zeros(max(ulen, 1), np.uint8)
    x_out = np.zeros(32, np.uint32)
    cur = step_lib.decode_stream(freq.ctypes.data, x0.ctypes.data,
                                 words.ctypes.data, int(b.n_words[0]), ulen,
                                 out.ctypes.data, x_out.ctypes.data)
    assert out[:ulen].tobytes() == CASES[name] == uncompress(enc)
    _, px, pcur = tr.rans_o0(b)
    assert np.array_equal(x_out, px.numpy()[0].view(np.uint32))
    assert cur == int(pcur[0])



def _frame_one(enc):
    """(batch, words u16, freqs, x0 u32, ulen) of one encoded stream."""
    b = tr.frame_streams([enc], "cpu")
    return (b, b.payload.numpy().view(np.uint16)[:int(b.n_words[0])].copy(),
            b.freqs.numpy()[0].copy(), b.x0.numpy()[0].view(np.uint32).copy(),
            int(b.ulen[0]))


def _garbage(rng, n_words, ulen):
    """A frame no encoder writes: every initial state and word 0, so every
    state stays 0 and refills in every round (32 words a round, more than
    a block's staging runs ahead of) until the cursor clamps at the end;
    a word read before its copy lands would make a state non-zero."""
    f = rng.multinomial(4096 - 256, np.ones(256) / 256).astype(np.int32) + 1
    words = np.zeros(n_words, np.uint16)
    x0 = np.zeros(32, np.uint32)
    b = tr.Nx16Batch(
        torch.from_numpy(words.view(np.uint8).copy()),
        torch.zeros(1, dtype=torch.int64),
        torch.tensor([n_words], dtype=torch.int32),
        torch.from_numpy(f[None].copy()),
        torch.from_numpy(x0.view(np.int32)[None].copy()),
        torch.tensor([ulen], dtype=torch.int32),
        torch.zeros(1, dtype=torch.int64))
    return b, words, f, x0, ulen


def _ring(step_lib, frame, lead=0, max_rounds=-1, qbins=0, off=0,
          fold=1024):
    _, words, f, x0, ulen = frame
    out = np.zeros(max(ulen, 1), np.uint8)
    hist = np.zeros(max(qbins, 1), np.int32)
    x_out = np.zeros(32, np.uint32)
    waits = np.zeros(1, np.int64)
    cur = step_lib.decode_ring(f.ctypes.data, x0.ctypes.data,
                               words.ctypes.data, len(words), ulen, lead,
                               max_rounds, qbins, off, fold, out.ctypes.data,
                               hist.ctypes.data, x_out.ctypes.data,
                               waits.ctypes.data)
    return out[:ulen], hist[:qbins], x_out, cur, int(waits[0])


def _ring_cases():
    rng = np.random.RandomState(11)
    return {
        # 64 KiB of qualities: the ring wraps about 20 times
        "wraps": rng.randint(0, 40, 1 << 16).astype(np.uint8).tobytes(),
        # long constant runs: every lane in one bin for many rounds
        "walk": np.clip(np.cumsum(rng.randint(-2, 3, 40000)) + 20, 0,
                        44).astype(np.uint8).tobytes(),
        "full_alphabet": CASES["full_alphabet"],
        "ulen_mod32": CASES["ulen_mod32"],
        "one_symbol": CASES["one_symbol"],
        "ulen_lt32": CASES["ulen_lt32"],
        "exact_blocks": rng.randint(0, 40, 32 * 32 * 3).astype(np.uint8)
        .tobytes(),
        "block_tail17": rng.randint(0, 40, 32 * 32 * 2 + 17).astype(np.uint8)
        .tobytes(),
    }


RING_CASES = _ring_cases()


@pytest.mark.parametrize("lead", [0, 1])
@pytest.mark.parametrize("name", list(RING_CASES))
def test_ring_decode_on_cpu(step_lib, name, lead):
    """The kernels' loop over the header's ring (blocks, staging, the
    rounds left) decodes byte for byte and leaves the plain version's
    states and cursor, with the stream's first word on a 4-byte boundary
    or off it."""
    data = RING_CASES[name]
    enc = compress(data, 0x04)
    frame = _frame_one(enc)
    out, _, x_out, cur, _ = _ring(step_lib, frame, lead)
    assert out.tobytes() == data
    _, px, pcur = tr.rans_o0(frame[0])
    assert np.array_equal(x_out, px.numpy()[0].view(np.uint32))
    assert cur == int(pcur[0])


@pytest.mark.parametrize("rounds", [0, 1, 31, 32, 33, 45, 64, 80])
def test_ring_max_rounds_on_cpu(step_lib, rounds):
    """A max_rounds stop inside a block of 32 rounds or on its edge leaves
    the plain version's states, cursor and symbols (the JAX segment's)."""
    frame = _frame_one(compress(RING_CASES["wraps"], 0x04))
    lead = rounds % 2
    out, _, x_out, cur, _ = _ring(step_lib, frame, lead, rounds)
    pout, px, pcur = tr.rans_o0(frame[0], max_rounds=rounds)
    assert np.array_equal(x_out, px.numpy()[0].view(np.uint32))
    assert cur == int(pcur[0])
    assert out[:32 * rounds].tobytes() == pout.numpy()[:32 * rounds].tobytes()


@pytest.mark.parametrize("qbins,off,name", [
    (64, 0, "wraps"), (64, 0, "walk"), (256, 0, "walk"), (64, 7, "walk"),
    (256, 3, "full_alphabet"), (41, 20, "block_tail17"), (1, 0, "wraps")])
def test_ring_hist_on_cpu(step_lib, qbins, off, name):
    """B3's counting: bins in the table, u16 column pairs and their folds
    (every block here, and every 1,024 blocks) give the clipped
    histogram, with the decode's states and cursor."""
    data = RING_CASES[name]
    frame = _frame_one(compress(data, 0x04))
    want = np.bincount(np.clip(np.frombuffer(data, np.uint8).astype(int)
                               - off, 0, qbins - 1), minlength=qbins)
    _, sx, scur, *_ = (None,) + tuple(_ring(step_lib, frame)[2:4])
    for fold in (1, 1024):
        _, hist, x_out, cur, _ = _ring(step_lib, frame, 1, -1, qbins, off,
                                       fold)
        assert np.array_equal(hist, want)
        assert np.array_equal(x_out, sx) and cur == scur


def test_ring_waits_when_staging_falls_behind(step_lib):
    """A frame that takes 32 words every round: blocks wait for their own
    copies, the cursor clamps at the end, and states, cursor and symbols
    are still the plain version's and the old loop's."""
    rng = np.random.default_rng(12)
    frame = _garbage(rng, 5000, 32 * 32 * 7 + 9)
    out, _, x_out, cur, waits = _ring(step_lib, frame, 1)
    assert waits > 0 and cur == 5000
    pout, px, pcur = tr.rans_o0(frame[0])
    assert np.array_equal(x_out, px.numpy()[0].view(np.uint32))
    assert cur == int(pcur[0]) and out.tobytes() == pout.numpy().tobytes()
    _, words, f, x0, ulen = frame
    out2 = np.zeros(ulen, np.uint8)
    x2 = np.zeros(32, np.uint32)
    cur2 = step_lib.decode_stream(f.ctypes.data, x0.ctypes.data,
                                  words.ctypes.data, len(words), ulen,
                                  out2.ctypes.data, x2.ctypes.data)
    assert cur2 == cur and np.array_equal(x2, x_out)
    assert out2.tobytes() == out.tobytes()


def test_ring_folds_a_whole_file_stream(step_lib):
    """A 1 MiB stream plus a tail: 1,024 blocks, so the counts fold inside
    the loop (the u16 halves would overflow at 65,536 rounds), against a
    bincount and the old loop's states."""
    rng = np.random.default_rng(13)
    data = np.clip(np.cumsum(rng.integers(-2, 3, (1 << 20) + 32 * 5 + 3))
                   + 20, 0, 44).astype(np.uint8).tobytes()
    frame = _frame_one(compress(data, 0x04))
    _, words, f, x0, ulen = frame
    _, hist, x_out, cur, _ = _ring(step_lib, frame, 0, -1, 64)
    assert np.array_equal(hist, np.bincount(np.frombuffer(data, np.uint8),
                                            minlength=64))
    out2 = np.zeros(ulen, np.uint8)
    x2 = np.zeros(32, np.uint32)
    cur2 = step_lib.decode_stream(f.ctypes.data, x0.ctypes.data,
                                  words.ctypes.data, len(words), ulen,
                                  out2.ctypes.data, x2.ctypes.data)
    assert cur2 == cur and np.array_equal(x2, x_out)


def test_replicate_copies_every_o0_stream():
    """The batch sweep's replicated Nx16 order-0 batch (its word offsets,
    frequencies and word counts copied) decodes, copy by copy, as the
    batch it was made from (plain version)."""
    from htslib_tpu_torch.bench_rans import replicate
    datas = [CASES["ulen_mod32"], CASES["sub_round"], CASES["full_alphabet"]]
    b = tr.frame_streams([compress(d, 0x04) for d in datas], "cpu")
    copies = replicate(b, 3)
    assert copies.n_streams == 9
    assert tr.rans_o0(copies)[0].numpy().tobytes() == b"".join(datas) * 3
    for g, w in zip(tr.rans_o0(copies, qbins=64), tr.rans_o0(b, qbins=64)):
        assert torch.equal(g, w.repeat(3, *([1] * (w.dim() - 1))))


def test_streams_per_sm_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tr.blocks_per_sm(64)


def test_fslot_step_matches_shared_step(step_lib):
    """The order-0 kernels' table (f, symbol, offset; a table of one
    symbol leaves states as they are) steps every slot as the step the
    other kernels share does, for quality, full-alphabet, skewed and
    one-symbol tables."""
    rng = np.random.default_rng(15)
    tables = [np.zeros(256, np.int32) for _ in range(4)]
    tables[0][20:41] = rng.multinomial(4096 - 21, np.ones(21) / 21) + 1
    tables[1][:] = rng.multinomial(4096 - 256, np.ones(256) / 256) + 1
    tables[2][0], tables[2][1:4] = 4093, 1
    tables[3][255] = 4096
    for f in tables:
        assert f.sum() == 4096
        assert step_lib.fslot_mismatches(f.ctypes.data) == 0
