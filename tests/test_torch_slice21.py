"""The rest of the port's last slice against the JAX package on the CPU:
realn.py's `probaln_glocal` (a batch of one through ops/probaln, the
plain version here) and `sam_cap_mapq`; cram/batch.py's
`iter_slice_blobs` and `cram_file_to_bam_stream`; bgzf.py's
`inflate_blocks`, `deflate_blocks`, `_compress_block_py` and the names
`BGZFReader`/`BGZFWriter`; the CIGAR and record helpers; util/memory.py;
and the package's `__version__`, `HTS_VERSION`, log re-exports and
feature bits.  Byte comparisons use both packages' pure-Python paths
(`htslib_tpu.native.native` and `htslib_tpu_torch.native.native` None),
and where the native libraries write or report otherwise, both with
their native libraries on."""
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import htslib_tpu
import htslib_tpu_torch
from htslib_tpu import bgzf as jbgzf
from htslib_tpu import realn as jrealn
from htslib_tpu.cram import CramReader as JReader
from htslib_tpu.cram import batch as jbatch
from htslib_tpu.sam import cigar as jcigar
from htslib_tpu.sam.header import SamHeader as JHeader
from htslib_tpu.sam.record import BamRecord as JRecord
from htslib_tpu_torch import bgzf as tbgzf
from htslib_tpu_torch import realn as trealn
from htslib_tpu_torch.cram import CramReader
from htslib_tpu_torch.cram import batch as tbatch
from htslib_tpu_torch.sam import cigar as tcigar
from htslib_tpu_torch.sam.header import SamHeader as THeader
from htslib_tpu_torch.sam.record import BamRecord as TRecord
from htslib_tpu_torch.util import log as tlog
from test_torch_cram import cram_records, write_bam, write_fasta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jax_pure(monkeypatch):
    monkeypatch.setattr("htslib_tpu.native.native", None)
    monkeypatch.setattr("htslib_tpu_torch.native.native", None)


# -- realn ------------------------------------------------------------------

def _reads(n, seed, max_len=70):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lq = int(rng.integers(1, max_len))
        lr = max(1, lq + int(rng.integers(-10, 20)))
        ref = rng.integers(0, 4, lr).astype(np.uint8)
        q = (ref[:lq].copy() if lq <= lr
             else rng.integers(0, 4, lq).astype(np.uint8))
        mut = rng.random(lq) < 0.12
        q[mut] = rng.integers(0, 5, int(mut.sum()))
        ref[rng.random(lr) < 0.02] = 4
        qual = (rng.integers(0, 45, lq).astype(np.uint8).tobytes()
                if rng.random() < 0.8 else None)
        params = (float(rng.choice([0.001, 1e-7])), 0.1,
                  int(rng.integers(0, 14)))
        out.append((ref.tobytes(), q.tobytes(), qual, params))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_probaln_glocal_matches_the_jax_scalar(seed):
    """Pr, MAP states and qualities equal (float64 throughout) wherever
    the JAX scalar returns; where it raises (log(0) at a base whose MAP
    mass rounds to 1), the port raises the same exception type, and
    without the MAP both return the same Pr."""
    held = raised = 0
    for ref, q, qual, (d, e, bw) in _reads(40, seed):
        c = (d, e, bw)
        try:
            want = jrealn.probaln_glocal(ref, q, qual,
                                         jrealn.ProbalnParams(*c))
        except (ValueError, ZeroDivisionError) as err:
            raised += 1
            with pytest.raises(type(err)):
                trealn.probaln_glocal(ref, q, qual, trealn.ProbalnParams(*c),
                                      device="cpu")
            assert trealn.probaln_glocal(
                ref, q, qual, trealn.ProbalnParams(*c), False,
                device="cpu") == jrealn.probaln_glocal(
                    ref, q, qual, jrealn.ProbalnParams(*c), False)
            continue
        got = trealn.probaln_glocal(ref, q, qual, trealn.ProbalnParams(*c),
                                    device="cpu")
        assert (got[0], list(got[1]), got[2]) == (want[0], list(want[1]),
                                                  want[2])
        held += 1
    assert held >= 30 and raised > 0


def test_probaln_glocal_edges_match_jax():
    p = (0.001, 0.1, 10)
    for ref, q, want_map in ((b"", b"\x01", True), (b"\x00\x01", b"", True),
                             (b"\x00\x01\x02\x03", b"\x00\x01\x03", False)):
        got = trealn.probaln_glocal(ref, q, None, trealn.ProbalnParams(*p),
                                    want_map, device="cpu")
        assert got == jrealn.probaln_glocal(ref, q, None,
                                            jrealn.ProbalnParams(*p),
                                            want_map)
    if not torch.cuda.is_available():      # the card is the default
        with pytest.raises(RuntimeError, match="no CUDA device"):
            trealn.probaln_glocal(b"\x00", b"\x00", None,
                                  trealn.ProbalnParams())


def _sam_lines(n, seed, ref):
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        pos = int(rng.integers(0, len(ref) - 150))
        ops, seq, x = [], [], pos
        if rng.random() < 0.3:
            k = int(rng.integers(1, 6))
            ops.append(f"{k}{'SH'[int(rng.integers(2))]}")
            if ops[-1].endswith("S"):
                seq.append("".join(rng.choice(list("ACGTN"), k)))
        for _ in range(int(rng.integers(1, 4))):
            k = int(rng.integers(5, 40))
            bases = list(ref[x:x + k])
            for j in range(k):
                if rng.random() < 0.06:
                    bases[j] = "ACGTN"[int(rng.integers(5))]
            seq.append("".join(bases))
            ops.append(f"{k}{'M=X'[int(rng.integers(3))]}")
            x += k
            r = rng.random()
            if r < 0.25:
                k = int(rng.integers(1, 4))
                ops.append(f"{k}D")
                x += k
            elif r < 0.4:
                k = int(rng.integers(1, 4))
                ops.append(f"{k}I")
                seq.append("".join(rng.choice(list("ACGT"), k)))
            elif r < 0.45:
                ops.append("20N")
                x += 20
        s = "".join(seq)
        qual = "".join(chr(33 + int(v)) for v in rng.integers(2, 41, len(s)))
        flag = int(rng.choice([0, 16, 4, 0]))
        lines.append(f"r{i}\t{flag}\tchr1\t{pos + 1}\t60\t{''.join(ops)}\t*"
                     f"\t0\t0\t{s}\t{qual}")
    return lines


def test_sam_cap_mapq_matches_jax():
    rng = np.random.default_rng(3)
    ref = "".join(rng.choice(list("ACGTN"), 3000, p=[.24, .24, .24, .24,
                                                        .04]))
    text = "@SQ\tSN:chr1\tLN:3000\n"
    jh, th = JHeader(text), THeader(text)
    short = ref[:2000]      # reads past it stop their walk
    caps = []
    for line in _sam_lines(150, 4, ref):
        jr, tr = JRecord.from_sam(line, jh), TRecord.from_sam(line, th)
        for r, thres in ((ref, 40), (ref, -1), (short, 60), (ref, 5)):
            want = jrealn.sam_cap_mapq(jr, r, thres)
            assert trealn.sam_cap_mapq(tr, r, thres) == want
            caps.append(want)
    assert -1 in caps and len(set(caps)) > 10


# -- cram/batch -------------------------------------------------------------

@pytest.fixture(scope="module")
def cram_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("stream")
    fa = str(d / "ref.fa")
    seqs = write_fasta(fa, 41)
    hdr, recs = cram_records(200, 43, seqs)
    bam = write_bam(str(d / "in.bam"), hdr, recs)
    path = str(d / "r.cram")
    tbatch.bam_to_cram_file(bam, path, ref=fa, seqs_per_slice=100)
    return path, fa, recs


def test_cram_file_to_bam_stream_matches_jax(cram_file, jax_pure):
    path, fa, recs = cram_file
    timing = {}
    hdr, blob = tbatch.cram_file_to_bam_stream(path, ref=fa, device="cpu",
                                               timing=timing)
    jhdr, jblob = jbatch.cram_file_to_bam_stream(path, ref=fa)
    assert hdr.text == jhdr.text and blob == jblob
    n, at = 0, 0
    while at < len(blob):                  # u32-framed records, each whole
        at += 4 + struct.unpack_from("<I", blob, at)[0]
        n += 1
    assert at == len(blob) and n == len(recs)
    assert timing["slices"] == 2 and sum(timing["wires"].values()) > 0
    _, nomd = tbatch.cram_file_to_bam_stream(path, ref=fa, decode_md=False,
                                             window=1, device="cpu")
    assert nomd == jbatch.cram_file_to_bam_stream(path, ref=fa,
                                                  decode_md=False,
                                                  window=1)[1]


def test_iter_slice_blobs_matches_jax(cram_file, jax_pure):
    path, fa, _recs = cram_file
    with CramReader(path, ref=fa) as r, JReader(path, ref=fa) as jr:
        got = list(tbatch.iter_slice_blobs(r, window=1, device="cpu"))
        want = list(jbatch.iter_slice_blobs(jr, window=1))
    assert got == want and len(got) == 2


# -- bgzf -------------------------------------------------------------------

def _bgzf_bytes(rng):
    parts = [rng.integers(0, 4, 70000, dtype=np.uint8).tobytes(),
             bytes(rng.integers(65, 70, 3000, dtype=np.uint8)), b""]
    chunks = [parts[0][:0xFF00], parts[0][0xFF00:], parts[1]]
    members = ([tbgzf.compress_block(chunks[0], 0),
                tbgzf.compress_block(chunks[1], 0),
                tbgzf.compress_block(chunks[2], 6)])
    return b"".join(members) + tbgzf.BGZF_EOF, b"".join(chunks)


def test_inflate_blocks_matches_jax(jax_pure):
    data, want = _bgzf_bytes(np.random.default_rng(2))
    out, table = tbgzf.inflate_blocks(data, device="cpu")
    jout, jtable = jbgzf.inflate_blocks(data)
    assert out.tobytes() == jout.tobytes() == want
    for k in ("coffsets", "csizes", "usizes"):
        assert np.array_equal(getattr(table, k), getattr(jtable, k))
    # a range at an offset in a file, its table given
    pre = b"\0" * 100
    sub = jbgzf.scan_blocks(data, base_offset=100)
    got, _ = tbgzf.inflate_blocks(np.frombuffer(pre + data, np.uint8)[100:],
                                  sub, base_offset=100, verify_crc=False,
                                  device="cpu")
    assert got.tobytes() == want


def test_inflate_blocks_checks_like_jax(jax_pure):
    data, _ = _bgzf_bytes(np.random.default_rng(3))
    bad = bytearray(data)
    end = tbgzf.scan_blocks(data).csizes[0]
    bad[end - 8] ^= 1                      # the first member's CRC32
    with pytest.raises(IOError, match="CRC32"):
        tbgzf.inflate_blocks(bytes(bad), device="cpu")
    with pytest.raises(IOError, match="CRC32"):
        jbgzf.inflate_blocks(bytes(bad))
    got, _ = tbgzf.inflate_blocks(bytes(bad), verify_crc=False, device="cpu")
    assert got.tobytes() == tbgzf.inflate_blocks(data, device="cpu")[0] \
        .tobytes()
    with pytest.raises(IOError):
        tbgzf.inflate_blocks(data[:-30], device="cpu")
    with pytest.raises(IOError):
        jbgzf.inflate_blocks(data[:-30])


@pytest.mark.parametrize("level", [-1, 0, 1, 6, 9])
def test_deflate_blocks_bytes_match_jax(jax_pure, level):
    rng = np.random.default_rng(level + 10)
    chunks = [b"", bytes(rng.integers(0, 256, 100, dtype=np.uint8)),
              b"ACGT" * 16000, rng.integers(0, 3, 0xFF00, dtype=np.uint8)
              .tobytes()]
    got = tbgzf.deflate_blocks(chunks, level)
    assert got == jbgzf.deflate_blocks(chunks, level)
    assert [tbgzf._compress_block_py(c, level) for c in chunks] == [
        jbgzf._compress_block_py(c, level) for c in chunks] == got
    assert [tbgzf.decompress_block(m) for m in got] == chunks


def test_deflate_blocks_native_layout_alike():
    """The native deflate's members (libdeflate, both libraries on): the
    port's are the JAX package's bytes, each a whole member the port
    reads."""
    import htslib_tpu.native as jn
    if jn.native is None:
        pytest.skip("the JAX native library does not load here")
    chunks = [b"ACGT" * 16000, b"x" * 7, b""]
    native = jbgzf.deflate_blocks(chunks, 6)
    assert tbgzf.deflate_blocks(chunks, 6) == native
    assert [tbgzf.decompress_block(m) for m in native] == chunks
    assert [tbgzf.parse_block_header(m) for m in native] == [
        len(m) for m in native]


def test_reader_writer_names():
    assert tbgzf.BGZFReader is tbgzf.BgzfReader
    assert tbgzf.BGZFWriter is tbgzf.BgzfWriter


# -- helpers ----------------------------------------------------------------

def test_cigar_helpers_match_jax():
    rng = np.random.default_rng(5)
    words = [int(w) for w in rng.integers(0, 1 << 32, 500, dtype=np.uint64)]
    words += [(n << 4) | op for n in (0, 1, 77) for op in range(16)]
    for fn in ("cigar_op", "cigar_oplen", "cigar_opchr"):
        ok = [w for w in words if fn != "cigar_opchr" or (w & 15) < 10]
        assert [getattr(tcigar, fn)(w) for w in ok] == [
            getattr(jcigar, fn)(w) for w in ok]
    assert [tcigar.cigar_type(op) for op in range(16)] == [
        jcigar.cigar_type(op) for op in range(16)]
    assert tcigar.CIGAR_OPS == jcigar.CIGAR_OPS


def test_record_helpers_match_jax():
    rng = np.random.default_rng(6)
    ref = "".join(rng.choice(list("ACGT"), 1000))
    text = "@SQ\tSN:chr1\tLN:1000\n"
    jh, th = JHeader(text), THeader(text)
    lines = _sam_lines(40, 7, ref)
    for a, b in zip(lines, lines[1:] + lines[:1]):
        j1, t1 = JRecord.from_sam(a, jh), TRecord.from_sam(a, th)
        j2, t2 = JRecord.from_sam(b, jh), TRecord.from_sam(b, th)
        assert (t1.is_reverse(), t1.is_unmapped()) == (j1.is_reverse(),
                                                       j1.is_unmapped())
        assert repr(t1) == repr(j1)
        assert (t1 == TRecord.from_sam(a, th)) and (j1 == JRecord.from_sam(
            a, jh))
        assert (t1 == t2) == (j1 == j2) and t1 != j1


# -- the package ------------------------------------------------------------

def test_version_and_log_exports():
    assert htslib_tpu_torch.__version__ == htslib_tpu.__version__
    assert htslib_tpu_torch.HTS_VERSION == htslib_tpu.HTS_VERSION
    for name in ("hts_log", "hts_set_log_level", "hts_get_log_level",
                 "log_error", "log_warning", "log_info", "log_debug",
                 "log_trace"):
        assert getattr(htslib_tpu_torch, name) is getattr(tlog, name)
        assert hasattr(htslib_tpu, name)


def test_features_match_jax_without_its_native_library(jax_pure):
    assert htslib_tpu_torch.hts_features() == htslib_tpu.hts_features()
    assert (htslib_tpu_torch.hts_feature_string()
            == htslib_tpu.hts_feature_string())
    assert not htslib_tpu_torch.hts_features() & 32


def test_features_leave_out_libdeflate():
    """Both packages set LIBDEFLATE (32) where their native libraries
    load, and leave it out where they are set to None."""
    import htslib_tpu.native as jn
    jax_bits = htslib_tpu.hts_features()
    assert bool(jax_bits & 32) == (jn.native is not None)
    assert htslib_tpu_torch.hts_features() == jax_bits
    mp = pytest.MonkeyPatch()
    mp.setattr("htslib_tpu_torch.native.native", None)
    try:
        assert htslib_tpu_torch.hts_features() == jax_bits & ~32
    finally:
        mp.undo()


def test_tune_host_allocator_matches_jax():
    """Both allocators tuned in a process of their own (mallopt acts on
    the calling process), with and without a prefault."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from htslib_tpu.util.memory import tune_host_allocator as j\n"
            "from htslib_tpu_torch.util.memory import "
            "tune_host_allocator as t\n"
            "print(t(), t(1 << 20), j(), j(1 << 20), t(0))\n" % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True"] * 5
