"""The port's device inflate (htslib_tpu_torch/ops/inflate.py, kernel X4)
against the JAX package's (htslib_tpu/ops/inflate.py, XLA on the CPU) and
zlib: `inflate_batch(device="cpu")`, the plain version (the JAX function's
two passes as tensor ops), on the shapes of tests/test_inflate_device.py
cut to a few KiB, on a BAM-record member, on multi-block members and on
hand-built members at the JAX decoder's edges; and the kernel's decoder
(csrc/inflate_step.cuh) compiled for the CPU with g++, on full-size 64 KiB
members against zlib and on corrupt and edge members against the JAX
function's per-member errors, with a mutated copy that must fail.  Outputs
are bytes: equality is exact."""
import ctypes
import os
import shutil
import subprocess
import zlib

import jax
import numpy as np
import pytest
import torch

from htslib_tpu.ops import inflate as jinf
from htslib_tpu_torch.ops import inflate as tinf
from chip_smoke import (bam_record_stream, deflate_raw, inflate_members,
                        leg1_batch, ring_edge_members)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "htslib_tpu_torch", "csrc")


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX reference runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    jax.config.update("jax_enable_x64", False)


def jax_lanes(payloads, isizes):
    """The JAX function's passes on one batch, as its inflate_batch pads
    it: (outputs, per-member error flags)."""
    B = len(payloads)
    in_max = (max(len(p) for p in payloads) + 8 + 3) & ~3
    buf = np.zeros((B, in_max), np.uint8)
    bits = np.zeros(B, np.int32)
    osz = np.asarray(isizes, np.int32)
    for i, pl in enumerate(payloads):
        buf[i, :len(pl)] = np.frombuffer(pl, np.uint8)
        bits[i] = 8 * len(pl)
    run = jinf._compiled(B, in_max // 4, 512, 512)
    res, err = run(buf.view(np.uint32), bits, buf, osz)
    res = np.asarray(res)
    return [res[i, :osz[i]].tobytes() for i in range(B)], np.asarray(err)


def plain_lanes(payloads, isizes):
    """The plain version on one batch: (outputs, per-member error flags)."""
    b = tinf.frame_members(payloads, isizes, "cpu")
    out, stats = tinf.inflate_plain(b)
    flat = out.numpy()
    offs, caps = b.out_off.numpy(), b.out_cap.numpy()
    return ([flat[o:o + c].tobytes() for o, c in zip(offs, caps)],
            tinf.corrupt(b, stats).numpy())


def _cases():
    """The shapes of tests/test_inflate_device.py, cut to a few KiB."""
    rng = np.random.RandomState(0)
    return [b"", b"x", b"hello world " * 100,
            rng.randint(0, 256, 3000, np.uint8).tobytes(), b"A" * 6000,
            (b"ACGT" * 500) + rng.randint(0, 256, 600, np.uint8).tobytes(),
            bytes(range(256)) * 8, rng.randint(65, 91, 4096,
                                               np.uint8).tobytes()]


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_plain_matches_jax_and_zlib(level):
    cases = _cases()
    payloads = [deflate_raw(d, level) for d in cases]
    sizes = [len(d) for d in cases]
    got = tinf.inflate_batch(payloads, sizes, device="cpu")
    assert got == cases
    assert got == jinf.inflate_batch(payloads, sizes)


def test_inflate_batch_timing_parts():
    """inflate_batch's `timing` dict: its five parts, summed over the
    plain version's passes, and the bytes of a call without it."""
    cases = _cases()[1:4]
    payloads = [deflate_raw(d) for d in cases]
    timing = {}
    got = tinf.inflate_batch(payloads, [len(d) for d in cases], batch=2,
                             device="cpu", timing=timing)
    assert got == cases
    assert set(timing) == {"frame_s", "transfer_s", "decode_s",
                           "check_download_s", "slice_s"}
    assert all(v >= 0 for v in timing.values())
    assert timing["decode_s"] == max(timing.values())


def _bam_and_multi_block():
    """A BAM-record member (4 KiB of leg 1's records as chip_smoke.py's
    leg 7 serialises them) and multi-block members: full flushes between
    parts (empty stored blocks between dynamic ones), and zlib's level 1
    over input larger than one of its blocks."""
    bam = bam_record_stream(leg1_batch(n=40))[:4096]
    rng = np.random.default_rng(3)
    parts = [bam[:700], rng.integers(0, 256, 500, dtype=np.uint8).tobytes(),
             b"ACGT" * 200]
    co = zlib.compressobj(6, zlib.DEFLATED, -15)
    multi = b"".join(co.compress(x) + co.flush(zlib.Z_FULL_FLUSH)
                     for x in parts) + co.flush()
    big = (b"ACGT" * 600 + rng.integers(0, 4, 6000, dtype=np.uint8)
           .tobytes())
    return [(deflate_raw(bam), bam), (multi, b"".join(parts)),
            (deflate_raw(big, 1, zlib.Z_FIXED), big)]


def test_bam_member_and_multi_block_match_jax():
    pairs = _bam_and_multi_block()
    payloads = [p for p, _ in pairs]
    sizes = [len(d) for _, d in pairs]
    got = tinf.inflate_batch(payloads, sizes, device="cpu")
    assert got == [d for _, d in pairs]
    assert got == jinf.inflate_batch(payloads, sizes)


def test_edge_members_match_jax():
    """The hand-built and zlib members of chip_smoke.py's X4 row (the
    step-cap member apart): the same refusals as the JAX function, the
    same bytes where it accepts, and those the expected ones."""
    members = [m for m in inflate_members() if m[0] != "step_cap"]
    payloads = [m[1] for m in members]
    sizes = [m[2] for m in members]
    got, err = plain_lanes(payloads, sizes)
    jgot, jerr = jax_lanes(payloads, sizes)
    assert err.tolist() == jerr.tolist()
    for (name, _, _, want), g, jg, e in zip(members, got, jgot, err):
        assert e == (want is None), name
        if want is not None:
            assert g == jg == want, name


def test_step_cap_member_refused_as_jax(step_lib):
    """600 empty fixed blocks: each waits for a table build, so the member
    is not done after 512 chunks of 512 steps.  (Alone: a JAX batch runs
    as long as its longest member, 262,144 steps here.)"""
    (_, pl, size, _), = [m for m in inflate_members() if m[0] == "step_cap"]
    assert plain_lanes([pl], [size])[1].tolist() == [True]
    assert jax_lanes([pl], [size])[1].tolist() == [True]
    for ring in WINDOWS:
        _, err, stats = step_lanes(step_lib, [pl], [size], ring=ring)
        assert err.tolist() == [True] and stats[0, 0] == 8   # INFL_E_STEPS


def test_member_past_64k_gives_its_first_64k_as_jax(step_lib):
    """A member whose ISIZE (70,000, stored blocks) passes BGZF's 64 KiB:
    accepted, and its first 65,536 bytes given, by the JAX function, the
    plain version and the decoder alike."""
    data = np.random.default_rng(1).integers(0, 256, 70000,
                                             dtype=np.uint8).tobytes()
    pl = deflate_raw(data, 0)
    for got, err in (jax_lanes([pl], [70000]), plain_lanes([pl], [70000]),
                     step_lanes(step_lib, [pl], [70000])[:2],
                     step_lanes(step_lib, [pl], [70000], ring=False)[:2]):
        assert err.tolist() == [False]
        assert got == [data[:tinf.OUT_MAX]]


def test_corrupt_and_wrong_size_raise_as_jax():
    """tests/test_inflate_device.py's corrupt member, and a wrong ISIZE:
    ValueError naming the same member."""
    good = deflate_raw(b"hello world" * 50)
    bad = bytes([good[0] ^ 0xFF]) + good[1:]
    for payloads, sizes in (([bad], [550]), ([good, good], [550, 551])):
        with pytest.raises(ValueError) as port_err:
            tinf.inflate_batch(payloads, sizes, device="cpu")
        with pytest.raises(ValueError) as jax_err:
            jinf.inflate_batch(payloads, sizes)
        assert str(port_err.value) == str(jax_err.value)


def test_small_batches_and_empty_input():
    """`batch` splits the plain version's passes; the error names the
    member in the whole list, as in JAX."""
    payloads = [deflate_raw(b"abc" * k) for k in range(1, 6)]
    sizes = [3 * k for k in range(1, 6)]
    assert tinf.inflate_batch(payloads, sizes, batch=2, device="cpu") == \
        [b"abc" * k for k in range(1, 6)]
    sizes[3] += 1
    with pytest.raises(ValueError, match="corrupt stream 3"):
        tinf.inflate_batch(payloads, sizes, batch=2, device="cpu")
    assert tinf.inflate_batch([], [], device="cpu") == []


def test_inflate_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tinf.inflate_batch([deflate_raw(b"abc")], [3])


# ---------------------------------------------------------------------------
# The kernel's decoder on the CPU
# ---------------------------------------------------------------------------

_HARNESS = r"""
#include <stdlib.h>
#include "inflate_step.cuh"

// n members, as the kernel takes them (one lane here): payloads 4-byte
// aligned at in + in_off[m], outputs at out + out_off[m]; stats [n, 4];
// the output window a shared-memory ring (ring != 0) or the slot.
extern "C" void inflate_members(const uint8_t* in, const int64_t* in_off,
                                const int32_t* in_len, uint8_t* out,
                                const int64_t* out_off,
                                const int32_t* out_cap, int32_t* stats,
                                int n, int ring) {
  InflSmem* sm = (InflSmem*)malloc(sizeof(InflSmem));
  uint8_t* win = (uint8_t*)aligned_alloc(16, INFL_RING);
  for (int m = 0; m < n; ++m) {
    const uint32_t* words = (const uint32_t*)(in + in_off[m]);
    const InflResult r =
        ring ? infl_member<true>(words, (uint32_t)in_len[m],
                                 out + out_off[m], (uint32_t)out_cap[m],
                                 win, sm, 0, 1)
             : infl_member<false>(words, (uint32_t)in_len[m],
                                  out + out_off[m], (uint32_t)out_cap[m],
                                  win, sm, 0, 1);
    stats[4 * m] = r.err;
    stats[4 * m + 1] = r.produced;
    stats[4 * m + 2] = r.tokens;
    stats[4 * m + 3] = r.steps;
  }
  free(win);
  free(sm);
}
"""


def _compile(tmp_path, csrc):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ not found: the step harness needs a C++ compiler")
    src = tmp_path / "harness.cpp"
    src.write_text(_HARNESS)
    lib = tmp_path / "libinflate.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-shared", "-fPIC", "-O2",
                    "-I", str(csrc), "-o", str(lib), str(src)], check=True)
    h = ctypes.CDLL(str(lib))
    h.inflate_members.restype = None
    h.inflate_members.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2
    return h


@pytest.fixture(scope="module")
def step_lib(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("inflate"), CSRC)


# the decoder's output windows: a shared-memory ring, the member's slot
WINDOWS = (True, False)
SLACK = 1 << 17   # bytes past the last slot, where nothing may be written


def step_lanes(h, payloads, isizes, fill=0, with_flat=False, ring=True):
    """The decoder on each member with the output window `ring` (else the
    slot), framed as the kernel takes them: (outputs, per-member error
    flags, stats [n, 4]) and with `with_flat` the whole output buffer,
    which starts as `fill` bytes and runs SLACK bytes past the last
    slot."""
    b = tinf.frame_members(payloads, isizes, "cpu")
    out = np.full(b.total_out + SLACK, fill, np.uint8)
    stats = np.zeros((b.n_members, 4), np.int32)
    h.inflate_members(b.payload.numpy().ctypes.data,
                      b.in_off.numpy().ctypes.data,
                      b.in_len.numpy().ctypes.data, out.ctypes.data,
                      b.out_off.numpy().ctypes.data,
                      b.out_cap.numpy().ctypes.data, stats.ctypes.data,
                      b.n_members, int(ring))
    offs, caps = b.out_off.numpy(), b.out_cap.numpy()
    err = tinf.corrupt(b, torch.from_numpy(stats)).numpy()
    res = [out[o:o + c].tobytes() for o, c in zip(offs, caps)], err, stats
    return res + (out,) if with_flat else res


def full_size_members():
    """64 KiB members: BAM records (leg 7's serialisation), bytes(range(
    256)) * 256, uniform random, one byte repeated, text-like and 2-bit
    symbols."""
    rng = np.random.default_rng(9)
    bam = bam_record_stream(leg1_batch(n=700))[:tinf.OUT_MAX]
    return [bam, bytes(range(256)) * 256,
            rng.integers(0, 256, tinf.OUT_MAX, dtype=np.uint8).tobytes(),
            b"A" * tinf.OUT_MAX,
            rng.integers(65, 91, tinf.OUT_MAX, dtype=np.uint8).tobytes(),
            rng.integers(0, 4, tinf.OUT_MAX, dtype=np.uint8).tobytes()]


@pytest.mark.parametrize("level", range(10))
def test_step_header_full_size_members_match_zlib(step_lib, level):
    datas = full_size_members()
    payloads = [deflate_raw(d, level, s) for d in datas
                for s in (zlib.Z_DEFAULT_STRATEGY, zlib.Z_FIXED,
                          zlib.Z_HUFFMAN_ONLY, zlib.Z_RLE)]
    want = [d for d in datas for _ in range(4)]
    for ring in WINDOWS:
        got, err, _ = step_lanes(step_lib, payloads, [len(d) for d in want],
                                 ring=ring)
        assert not err.any()
        assert got == want


def _fuzzed(n=30, seed=12):
    """Members with flipped bits, cut short, random bytes, wrong ISIZEs,
    a byte replaced or trailing bytes, over a few stream shapes."""
    rng = np.random.default_rng(seed)
    base = [b"hello world " * 40, rng.integers(0, 256, 700,
                                               dtype=np.uint8).tobytes(),
            rng.choice(np.frombuffer(b"ACGT", np.uint8), 1500).tobytes(),
            b"A" * 3000,
            bytes(range(256)) * 4]
    out = []
    for k in range(n):
        d = base[k % len(base)]
        p = bytearray(deflate_raw(d, int(rng.integers(0, 10)),
                                  int(rng.choice([0, 1, 2, 3, 4]))))
        size = len(d)
        kind = k % 6
        if kind == 0:
            for _ in range(int(rng.integers(1, 4))):
                p[int(rng.integers(0, len(p)))] ^= 1 << int(rng.integers(8))
        elif kind == 1:
            p = p[:int(rng.integers(0, len(p) + 1))]
        elif kind == 2:
            p = bytearray(rng.integers(0, 256, int(rng.integers(1, 200)),
                                       dtype=np.uint8).tobytes())
        elif kind == 3:
            size += int(rng.integers(-3, 4))
        elif kind == 4:
            p[int(rng.integers(0, len(p)))] = int(rng.integers(0, 256))
        else:
            p += rng.integers(0, 256, 5, dtype=np.uint8).tobytes()
        out.append((bytes(p), max(size, 0)))
    return out


def test_step_header_errors_match_jax(step_lib):
    """The decoder refuses exactly the members the JAX function refuses,
    and gives its bytes on the others: the edge members (the step-cap one
    apart, above) and fuzzed members."""
    members = [(m[1], m[2]) for m in inflate_members()
               if m[0] != "step_cap"] + _fuzzed()
    payloads = [p for p, _ in members]
    sizes = [s for _, s in members]
    jgot, jerr = jax_lanes(payloads, sizes)
    assert 0 < int(jerr.sum()) < len(members)
    for ring in WINDOWS:
        got, err, _ = step_lanes(step_lib, payloads, sizes, ring=ring)
        assert err.tolist() == jerr.tolist()
        for g, jg, e in zip(got, jgot, err):
            if not e:
                assert g == jg


def test_step_header_token_cap(step_lib):
    """70,000 literals: the JAX function refuses a member at 65,552 tokens
    (htslib_tpu/ops/inflate.py:419, tok_cnt >= MAX_TOK), and so does the
    decoder; 65,536 literals pass.  (The JAX function takes ~70,000 steps
    over it; its rule is held here by the decoder alone.)"""
    rng = np.random.default_rng(13)
    # 16 symbols, no repeats worth a match: Huffman-coded literals
    lits = rng.integers(0, 16, 70000, dtype=np.uint8).tobytes()
    members = [lits, lits[:tinf.OUT_MAX]]
    for ring in WINDOWS:
        got, err, stats = step_lanes(
            step_lib, [deflate_raw(d, 6, zlib.Z_HUFFMAN_ONLY)
                       for d in members], [len(d) for d in members],
            ring=ring)
        assert err.tolist() == [True, False]
        assert stats[0, 0] == 7 and stats[0, 2] == tinf.MAX_TOK  # E_TOKENS
        assert got[1] == members[1]


def test_ring_edge_members_match_jax_and_plain(step_lib):
    """The members at the output ring's edges (distance 32,768, long
    matches over its wraps, stored blocks past it, a match before the
    output's start that crosses position 32,768, a capacity inside a
    match): the decoder, the plain version and the JAX function all give
    the expected bytes, and accept them all."""
    members = ring_edge_members()
    payloads = [m[1] for m in members]
    sizes = [m[2] for m in members]
    want = [m[3] for m in members]
    for ring in WINDOWS:
        got, err, stats = step_lanes(step_lib, payloads, sizes, ring=ring)
        assert not err.any()
        assert got == want
    pgot, perr = plain_lanes(payloads, sizes)
    jgot, jerr = jax_lanes(payloads, sizes)
    assert not perr.any() and not jerr.any()
    assert pgot == want
    assert [g[:len(w)] for g, w in zip(jgot, want)] == want


def _cap_case(h, ring):
    """Members past their 64 KiB capacity after a small one, in a buffer of
    0xAB bytes: the capacity inside a match (cap_in_match), inside stored
    blocks, and inside a run of long matches, the last in the buffer.
    Returns (outputs, expected outputs, error flags, stats, whether the
    SLACK bytes past the last slot are intact)."""
    edge = {m[0]: m for m in ring_edge_members()}["cap_in_match"]
    data = np.random.default_rng(3).integers(0, 256, 70000,
                                             dtype=np.uint8).tobytes()
    small = b"tail bytes " * 9
    runs = b"ACGT" * 35000
    got, err, stats, flat = step_lanes(
        h, [deflate_raw(small), edge[1], deflate_raw(data, 0),
            deflate_raw(runs, 6)], [len(small), edge[2], 70000, len(runs)],
        fill=0xAB, with_flat=True, ring=ring)
    want = [small, edge[3], data[:tinf.OUT_MAX], runs[:tinf.OUT_MAX]]
    intact = bool((flat[len(flat) - SLACK:] == 0xAB).all())
    return got, want, err, stats, intact


@pytest.mark.parametrize("ring", WINDOWS, ids=["ring", "slot"])
def test_step_header_cap_writes_nothing_past_the_slot(step_lib, ring):
    """Members whose capacity (64 KiB) ends inside a match, in a stored
    block or in a long match past the window, last in the buffer: each
    gets its first 64 KiB, and nothing past the last slot is written, in
    either output window."""
    got, want, err, stats, intact = _cap_case(step_lib, ring)
    assert not err.any()
    assert got == want
    assert stats[1, 1] > tinf.OUT_MAX and stats[3, 1] == 140000
    assert intact


# (name, text the copy replaces, replacement): the build's wait for the
# next chunk dropped (the step cap is then out of reach), the length
# codes' extra bits off by one code, the output ring's index wrapped at
# half its size, and the slot window's matches writing past the capacity
_MUTATIONS = [
    ("no_build_wait",
     "step = (step / INFL_STEPS_A_CHUNK + 1u) * INFL_STEPS_A_CHUNK;",
     "step += 1u;"),
    ("length_extra", "c < 8 || c >= 28 ? 0u : (c - 4u) >> 2",
     "c < 8 || c >= 28 ? 0u : (c - 3u) >> 2"),
    ("ring_index", "#define INFL_RING_MASK (INFL_RING - 1)",
     "#define INFL_RING_MASK (INFL_RING / 2 - 1)"),
    ("slot_cap", "const bool put = i < len && (RING || pos + i < cap);",
     "const bool put = i < len;"),
]


@pytest.mark.parametrize("name,old,new", _MUTATIONS,
                         ids=[m[0] for m in _MUTATIONS])
def test_mutated_step_header_fails(tmp_path, name, old, new):
    mut = tmp_path / "csrc"
    mut.mkdir()
    src = open(os.path.join(CSRC, "inflate_step.cuh")).read()
    assert src.count(old) == 1
    (mut / "inflate_step.cuh").write_text(src.replace(old, new))
    h = _compile(tmp_path, mut)
    if name == "no_build_wait":
        (_, pl, size, _), = [m for m in inflate_members()
                             if m[0] == "step_cap"]
        assert step_lanes(h, [pl], [size])[1].tolist() == [False]
    elif name == "ring_index":
        members = ring_edge_members()
        got, err, _ = step_lanes(h, [m[1] for m in members],
                                 [m[2] for m in members])
        assert err.any() or got != [m[3] for m in members]
    elif name == "slot_cap":
        assert _cap_case(h, True)[4]
        assert not _cap_case(h, False)[4]
    else:
        datas = full_size_members()
        got, err, _ = step_lanes(h, [deflate_raw(d) for d in datas],
                                 [len(d) for d in datas])
        assert err.any() or got != datas
