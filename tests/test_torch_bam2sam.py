"""The port's device BAM -> SAM chain (htslib_tpu_torch/ops/bam2sam.py)
against the JAX package's (htslib_tpu/ops/bam2sam.py, XLA on the CPU):
`device_record_scan` (kernel X5's plain version) on streams at the
scan's edges (truncated, overrunning, a length with bit 31 set, a chain
that stands still), `device_format_records`' four outputs, and
`bam_payload_to_sam_device`'s bytes on a varied stream and behind the
port's inflate; and X5's step (csrc/record_scan_step.cuh) compiled with
g++ and run as the kernel runs its windows, with a mutated copy that must
fail.  Outputs are bytes and integers: equality is exact."""
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

from chip_smoke import LEG8_REFS, bgzf_members, varied_bam_stream
from htslib_tpu.ops import bam2sam as jb
from htslib_tpu.sam.header import SamHeader as JHeader
from htslib_tpu_torch import carry
from htslib_tpu_torch.ops import bam2sam as tb
from htslib_tpu_torch.ops import inflate as tinf
from htslib_tpu_torch.sam.header import SamHeader
from htslib_tpu_torch.sam.record import BamRecord
from test_torch_gpu import scan_payloads

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "htslib_tpu_torch", "csrc")
SCANS = scan_payloads()
JHDR = JHeader(refs=[(n, 300_000_000) for n in LEG8_REFS])


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX reference runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    jax.config.update("jax_enable_x64", False)


def _u8(payload: bytes) -> np.ndarray:
    return np.frombuffer(payload, np.uint8).copy()


# "big" is the windows' case (the JAX loop over it takes long); the JAX
# function cannot index an empty output ("none", max_records 0)
@pytest.mark.parametrize("name", [n for n in SCANS if n not in ("big",
                                                                 "none")])
def test_record_scan_matches_jax(name):
    payload, n = SCANS[name]
    want = jb.device_record_scan(jnp.asarray(_u8(payload)), n)
    got = tb.device_record_scan(torch.from_numpy(_u8(payload)), n)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert np.array_equal(g.numpy(), np.asarray(w))


def _maxima(payload: bytes, n: int):
    offs = tb.record_scan_plain(torch.from_numpy(_u8(payload)), n)[0]
    pl = _u8(payload)
    o = offs.numpy().astype(np.int64)
    max_qname = int(pl[o + 12].max())
    max_ops = max(1, int((pl[o + 16] | (pl[o + 17].astype(np.int64) << 8))
                         .max()))
    l_seq = pl[o[:, None] + np.arange(20, 24)].copy().view("<u4")
    return max_qname, max_ops, max(1, int(l_seq.max()))


@pytest.mark.parametrize("extra", [0, 5])
def test_format_records_four_outputs_match_jax(extra):
    """The JAX function's four outputs (lines, lengths, n, sizes), with
    rows past n when max_records is larger."""
    payload = varied_bam_stream(200, 12)
    n = 200 + extra
    max_qname, max_ops, max_len = _maxima(payload, 200)
    tbl = tb._names_table(SamHeader(ref_names=LEG8_REFS))
    name_w = tbl.shape[1]
    out_w = (max_qname + 44 + 2 * name_w + 12 * max_ops + 2 * max_len + 16)
    want = jb.device_format_records(jnp.asarray(_u8(payload)),
                                    jnp.asarray(tbl), n, max_qname, max_ops,
                                    max_len, name_w, out_w)
    got = tb.device_format_records(
        torch.from_numpy(_u8(payload)),
        carry.from_jax_names_table(np.asarray(tbl)), n, max_qname, max_ops,
        max_len, name_w, out_w)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))


def test_bam_payload_to_sam_matches_jax():
    payload = varied_bam_stream(300, 13)
    want = jb.bam_payload_to_sam_device(payload, JHDR)
    timing = {}
    got = tb.bam_payload_to_sam_device(payload, JHDR, device="cpu",
                                       timing=timing)
    assert got == want
    assert timing["records"] == 300 and timing["aux_records"] > 200
    assert set(timing) >= {"framing_s", "upload_s", "check_s", "scan_s",
                           "format_s", "download_s", "aux_s", "splice_s"}
    # aux tails handed in, one a record, as the JAX function takes them
    tails = ["\tXX:i:%d" % i if i % 3 else "" for i in range(300)]
    assert (tb.bam_payload_to_sam_device(payload, JHDR, aux_texts=tails,
                                         device="cpu")
            == jb.bam_payload_to_sam_device(payload, JHDR, aux_texts=tails))


def test_bam_payload_to_sam_errors_match_jax():
    payload = varied_bam_stream(20, 14)
    for bad in (payload[:-3], payload + b"\x05\x00"):
        with pytest.raises(IOError, match="truncated BAM record stream"):
            jb.bam_payload_to_sam_device(bad, JHDR)
        with pytest.raises(IOError, match="truncated BAM record stream"):
            tb.bam_payload_to_sam_device(bad, JHDR, device="cpu")
    assert tb.bam_payload_to_sam_device(b"", JHDR, device="cpu") == b""
    short = (12).to_bytes(4, "little") + bytes(12)
    for run in (lambda: jb.bam_payload_to_sam_device(short, JHDR),
                lambda: tb.bam_payload_to_sam_device(short, JHDR,
                                                     device="cpu")):
        with pytest.raises(ValueError, match="BAM record too short"):
            run()


def _record(i, **fields) -> bytes:
    """A framed BAM record: r<i> at 10 * i on the first reference, 5M,
    ACGTA at quality 30, with `fields` set on the port's record model."""
    b = BamRecord()
    b.qname, b.tid, b.pos, b.flag = b"r%d" % i, 0, 10 * i, 0
    b.cigar = np.array([(5 << 4) | 0], np.uint32)
    b.set_seq("ACGTA", bytes([30] * 5))
    for k, v in fields.items():
        setattr(b, k, v)
    body = b.to_bam_buffer()
    return len(body).to_bytes(4, "little") + body


def _outcome(run):
    try:
        return "text", run()
    except Exception as e:          # the exception is what is compared
        return type(e).__name__, str(e)


BAD_AUX = b"XXq\x01"                # an aux type no formatter knows
C1_CASES = {
    "cigar_op_12": [_record(0), _record(1, cigar=np.array(
        [(5 << 4) | 12], np.uint32)), _record(2)],
    "qname_byte_0x80": [_record(0), _record(1, qname=b"ab\xc3\xa9"),
                        _record(2)],
    "aux_before_qname": [_record(0), _record(1, aux=BAD_AUX),
                         _record(2, qname=b"\x80x")],
    "qname_before_aux": [_record(0), _record(1, qname=b"\x80x"),
                         _record(2, aux=BAD_AUX)],
    "cigar_before_size": [_record(0, cigar=np.array([(3 << 4) | 15],
                                                    np.uint32)),
                          (12).to_bytes(4, "little") + bytes(12)],
    "quality_95": [_record(0, qual=bytes([30, 30, 95, 30, 30]))],
    "quality_223": [_record(0, qual=bytes([30, 30, 223, 30, 30]))],
    "quality_missing": [_record(0, qual=bytes([255, 30, 240, 30, 30]))],
    "qname_tab": [_record(0, qname=b"a\tb", aux=b"NMC\x03"), _record(1)],
}
C1_RAISES = {"cigar_op_12": "IndexError",
             "qname_byte_0x80": "UnicodeDecodeError",
             "aux_before_qname": "ValueError",
             "qname_before_aux": "UnicodeDecodeError",
             "cigar_before_size": "IndexError",
             "quality_95": "UnicodeDecodeError",
             "quality_223": "ValueError"}


@pytest.mark.parametrize("name", list(C1_CASES))
def test_bam_payload_to_sam_refuses_what_jax_refuses(name):
    """With aux_texts None the JAX wrapper formats every record on the
    host, so the port raises its exception, with its message, for the
    record it fails on first (size, QNAME, CIGAR, quality, then aux, in
    record order), and returns its text where it returns."""
    payload = b"".join(C1_CASES[name])
    want = _outcome(lambda: jb.bam_payload_to_sam_device(payload, JHDR))
    got = _outcome(lambda: tb.bam_payload_to_sam_device(payload, JHDR,
                                                        device="cpu"))
    assert got == want
    assert got[0] == C1_RAISES.get(name, "text")


def test_bam_payload_to_sam_with_aux_texts_returns_text():
    """With aux_texts given neither side runs the host formatter: both
    return the device's text, "?" for op code 12 and the QNAME's raw
    bytes."""
    payload = b"".join(C1_CASES["cigar_op_12"] + C1_CASES["qname_byte_0x80"])
    tails = ["\tXX:i:%d" % i for i in range(6)]
    got = tb.bam_payload_to_sam_device(payload, JHDR, aux_texts=tails,
                                       device="cpu")
    assert got == jb.bam_payload_to_sam_device(payload, JHDR,
                                               aux_texts=tails)
    assert b"\t5?\t" in got and b"ab\xc3\xa9\t" in got


def test_zlib_inflate_bam2sam_chain():
    """BGZF members deflated by zlib, inflated by the port (X4's plain
    version), then the port's chain: the JAX function's text of the
    record stream."""
    stream = varied_bam_stream(40, 15)
    members, pieces = bgzf_members(stream, 4000)
    assert len(members) > 1
    out = tinf.inflate_batch(members, [len(p) for p in pieces],
                             device="cpu")
    assert b"".join(out) == stream
    got = tb.bam_payload_to_sam_device(b"".join(out), JHDR, device="cpu")
    assert got == jb.bam_payload_to_sam_device(stream, JHDR)


_HARNESS = r"""
#include <string.h>
#include "record_scan_step.cuh"

// The kernel's loop (record_scan.cu) on the host: windows of `win` bytes
// (zero past u), the next one kStride = win - 16 on, the chain walked in
// the current one; a position outside the next window stages a window at
// it (16-byte aligned).  Fills the steps left with (-1, 0); returns n.
extern "C" int32_t scan(const uint8_t* payload, int32_t u, int32_t max_records,
                        int32_t win, int32_t* offs, int32_t* sizes) {
  static uint8_t w[1 << 16];
  int32_t pos = 0, k = 0;
  int64_t base = 0;
  bool done = max_records <= 0 || !rscan_ok(0, u);
  while (!done) {
    memset(w, 0, win);
    for (int64_t i = 0; i < win && base + i < u; ++i) w[i] = payload[base + i];
    done = rscan_walk(w, base, win, u, &pos, &k, max_records, offs, sizes);
    if (done) break;
    const int64_t next = base + win - 16;
    const int64_t at = rscan_at(pos, u);
    base = at >= next && at + 4 <= next + win ? next : (at & ~(int64_t)15);
  }
  for (int32_t i = k; i < max_records; ++i) {
    offs[i] = -1;
    sizes[i] = 0;
  }
  return k;
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
    lib = tmp_path / "librscan.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-shared", "-fPIC", "-O2",
                    "-I", inc, "-o", str(lib), str(src)], check=True)
    h = ctypes.CDLL(str(lib))
    h.scan.restype = ctypes.c_int32
    h.scan.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
                       ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]
    return h


def _step_scan(h, payload, n, win):
    pl = _u8(payload)
    offs = np.zeros(max(n, 1), np.int32)
    sizes = np.zeros(max(n, 1), np.int32)
    k = h.scan(pl.ctypes.data, len(pl), n, win, offs.ctypes.data,
               sizes.ctypes.data)
    return offs[:n], sizes[:n], k


@pytest.fixture(scope="module")
def step_lib(tmp_path_factory):
    return _compile(tmp_path_factory.mktemp("rscan"))


@pytest.mark.parametrize("win", [64, 4096, 1 << 16])
def test_record_scan_step_matches_plain(step_lib, win):
    for name, (payload, n) in SCANS.items():
        want = tb.record_scan_plain(torch.from_numpy(_u8(payload)), n)
        offs, sizes, k = _step_scan(step_lib, payload, n, win)
        assert np.array_equal(offs, want[0].numpy()), name
        assert np.array_equal(sizes, want[1].numpy()), name
        assert k == int(want[2]), name


def test_record_scan_step_mutation_fails(tmp_path):
    """A step that takes pos + 4 < U for ok (one byte short) must
    disagree with the plain version."""
    with open(os.path.join(CSRC, "record_scan_step.cuh")) as fp:
        text = fp.read()
    mutated, n_sub = re.subn(r"rscan_add\(pos, 4\) <= u",
                             "rscan_add(pos, 4) < u", text)
    assert n_sub == 1
    h = _compile(tmp_path, mutated)
    bad = 0
    for payload, n in SCANS.values():
        want = tb.record_scan_plain(torch.from_numpy(_u8(payload)), n)
        bad += _step_scan(h, payload, n, 4096)[2] != int(want[2])
    assert bad > 0
