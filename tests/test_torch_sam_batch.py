"""The port's columnar formatter and file-level BAM <-> SAM entry points
(htslib_tpu_torch/sam/batch.py) against the JAX package's
(htslib_tpu/sam/batch.py): `dec_len`, `write_ints`, the ragged helpers,
`decode_bam_columns` and `format_sam_batch` (numpy) on varied records
and on records at the formatter's edges; `bam_file_to_sam(device="cpu")`
from a path, an http URL and an htsget ticket served on 127.0.0.1
(chip_smoke.RangeServer), on deflated, stored, plain gzip and
uncompressed files; `bam_stream_to_sam`; `sam_text_to_bam` and
`sam_to_bam_file`.  The JAX functions run as they run by default (its
native library where present) and, where that path works, with
`htslib_tpu.native.native` None.  The files are stored BGZF (level 0)
but one, since the CPU's plain inflate takes seconds a deflated member.
Outputs are bytes: equality is exact."""
import gzip
import io
import os
import struct
import zlib

import numpy as np
import pytest

import htslib_tpu.native as jnative
from chip_smoke import LEG8_REFS, RangeServer, htsget_ticket, varied_bam_stream
from htslib_tpu.sam import batch as jb
from htslib_tpu.sam.header import SamHeader as JHeader
from htslib_tpu.sam.record import BamRecord as JRecord
from htslib_tpu_torch.bgzf import BGZF_EOF, BgzfWriter, read_file
from htslib_tpu_torch.sam import batch as tb
from htslib_tpu_torch.sam.bam import write_bam_header
from htslib_tpu_torch.sam.header import SamHeader
from htslib_tpu_torch.sam.record import BamRecord, encode_aux

HDR_TEXT = "@HD\tVN:1.6\n" + "".join(f"@SQ\tSN:{r}\tLN:300000000\n"
                                     for r in LEG8_REFS)
HDR = SamHeader(HDR_TEXT)
JHDR = JHeader(HDR_TEXT)


def edge_stream() -> bytes:
    """Records at the formatter's edges: a CG long-CIGAR escape, every
    integer aux type at its limits, A, H, Z, empty and full B arrays of
    each subtype, floats either side of %g's switches, a double, no SEQ,
    no QUAL (0xFF), an unmapped read placed by its mate, a mate on the
    other reference."""
    recs = []

    def rec(name, **kw):
        b = BamRecord()
        b.qname = name
        for k, v in kw.items():
            setattr(b, k, v)
        recs.append(b)
        return b

    b = rec(b"cg", tid=0, pos=99, mapq=60, flag=0)
    b.set_seq("ACGTACGTAC", bytes(range(10, 20)))
    b.cigar = np.array([(10 << 4) | 4, (500 << 4) | 3], np.uint32)
    b.aux = encode_aux(b"CG", "B", ("I", np.array(
        [(4 << 4) | 0, (70000 << 4) | 3, (6 << 4) | 0], np.uint32)))
    aux = b""
    for tag, t, v in ((b"Xc", "c", -128), (b"XC", "C", 255),
                      (b"Xs", "s", -32768), (b"XS", "S", 65535),
                      (b"Xi", "i", -2 ** 31), (b"XI", "I", 2 ** 32 - 1),
                      (b"XA", "A", "q"), (b"XH", "H", "1AE301"),
                      (b"XZ", "Z", "a b;c=d")):
        aux += encode_aux(tag, t, v)
    for sub, vals in (("c", [-128, 0, 127]), ("C", [0, 255]),
                      ("s", [-32768, 5]), ("S", [65535]),
                      ("i", [-2 ** 31, 7]), ("I", [2 ** 32 - 1]),
                      ("f", [0.5, -1e-5, 1e16]), ("i", [])):
        aux += encode_aux(b"B" + sub.encode(), "B", (sub, np.array(vals)))
    b = rec(b"aux", tid=1, pos=0, mapq=1, flag=1 | 32, mtid=1, mpos=5,
            isize=-6, aux=aux)
    b.set_seq("NNNN", b"\x00\x01\x02\x03")
    b.cigar = np.array([(4 << 4) | 0], np.uint32)
    for i, x in enumerate((0.0001, 0.00001, 123456.0, 1234567.0, 1e-300,
                           -3.25, 65504.0, 0.1)):
        b = rec(b"f%d" % i, tid=0, pos=i, mapq=0, flag=0,
                aux=encode_aux(b"XF", "f", x) + encode_aux(b"XD", "d", x))
        b.set_seq("A", b"\x1e")
        b.cigar = np.array([(1 << 4) | 0], np.uint32)
    b = rec(b"noseq", tid=0, pos=10, flag=0)
    b.set_seq("*")
    b.cigar = np.array([(5 << 4) | 0], np.uint32)
    b = rec(b"noqual", tid=0, pos=11, flag=16)
    b.set_seq("ACGTN")
    b.cigar = np.array([(2 << 4) | 7, (3 << 4) | 8], np.uint32)
    b = rec(b"placed_unmapped", tid=1, pos=500, flag=4 | 1, mtid=1,
            mpos=500)
    b.set_seq("GATTACA", bytes([30] * 7))
    b = rec(b"other_ref_mate", tid=0, pos=7, mapq=9, flag=1 | 2 | 64,
            mtid=1, mpos=99, isize=0)
    b.set_seq("TT", b"\x05\x06")
    b.cigar = np.array([(1 << 4) | 4, (1 << 4) | 0], np.uint32)
    out = []
    for b in recs:
        body = b.to_bam_buffer()
        out.append(struct.pack("<I", len(body)) + body)
    return b"".join(out)


STREAMS = {"varied": varied_bam_stream(1500, seed=21),
           "edges": edge_stream()}


def _frame(payload: bytes):
    offs, p = [], 0
    while p < len(payload):
        offs.append(p)
        p += 4 + int.from_bytes(payload[p:p + 4], "little")
    offs = np.array(offs, np.uint64)
    sizes = np.array([int.from_bytes(payload[o:o + 4], "little") + 4
                      for o in offs], np.uint32)
    return np.frombuffer(payload, np.uint8), offs, sizes


def _bam(path: str, payload: bytes, level: int = 0) -> str:
    with BgzfWriter(path, level=level) as w:
        write_bam_header(w, HDR)
        w.write(payload)
    return path


def _jax_both(fn, *args):
    """The JAX function's result as it runs by default, then with its
    native library off."""
    first = fn(*args)
    saved = jnative.native
    jnative.native = None
    try:
        second = fn(*args)
    finally:
        jnative.native = saved
    return first, second


def test_dec_len_write_ints_ragged_match_jax():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.integers(-2 ** 62, 2 ** 62, 500),
                        [0, -1, 9, 10, -10, 2 ** 31, -2 ** 31]])
    assert np.array_equal(tb.dec_len(x), jb.dec_len(x))
    ends = np.cumsum(tb.dec_len(x) + 1)
    out, jout = np.zeros(int(ends[-1]), np.uint8), np.zeros(int(ends[-1]),
                                                             np.uint8)
    tb.write_ints(out, ends - 1, x)
    jb.write_ints(jout, ends - 1, x)
    assert np.array_equal(out, jout)
    lens = rng.integers(0, 9, 100)
    for a, b in zip(tb.ragged_indices(lens), jb.ragged_indices(lens)):
        assert np.array_equal(a, b)
    data = rng.integers(0, 256, 2000, dtype=np.uint8)
    offs = rng.integers(0, 1900, 100)
    for a, b in zip(tb.ragged_gather(data, offs, lens),
                    jb.ragged_gather(data, offs, lens)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_format_sam_batch_matches_jax(name):
    data, offs, sizes = _frame(STREAMS[name])
    cols = tb.decode_bam_columns(data, offs, sizes)
    jcols = jb.decode_bam_columns(data, offs, sizes)
    for field in ("offs", "sizes", "tid", "pos", "mapq", "bin", "flag",
                  "mtid", "mpos", "tlen", "l_qname", "n_cigar", "l_qseq",
                  "qname_off", "cigar_off", "seq_off", "qual_off",
                  "aux_off", "aux_len"):
        assert np.array_equal(getattr(cols, field), getattr(jcols, field))
    assert cols.record(0).to_bam_buffer() == jcols.record(0).to_bam_buffer()
    got = tb.format_sam_batch(cols, HDR)
    assert got == jb.format_sam_batch(jcols, JHDR)
    native, python = _jax_both(jb.bam_to_sam_bytes, data, offs, sizes, JHDR)
    assert got == native == python
    assert tb.bam_to_sam_bytes(data, offs, sizes, HDR) == got
    # the record path, a line at a time
    assert got == "".join(cols.record(i).to_sam(HDR) + "\n"
                          for i in range(cols.n)).encode()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The varied and edge records as BAM files (stored BGZF), the edge
    records as plain gzip and uncompressed BAM, behind a RangeServer,
    with an htsget ticket of each BGZF file in 3 parts."""
    d = tmp_path_factory.mktemp("bams")
    out = {}
    for name, payload in STREAMS.items():
        out[name] = _bam(str(d / f"{name}.bam"), payload)
    head = io.BytesIO()
    write_bam_header(head, HDR)
    plain = head.getvalue() + STREAMS["edges"]
    out["plain_gzip"] = str(d / "plain_gzip.bam")
    with open(out["plain_gzip"], "wb") as fp:
        fp.write(gzip.compress(plain))
    out["uncompressed"] = str(d / "uncompressed.bam")
    with open(out["uncompressed"], "wb") as fp:
        fp.write(plain)
    with RangeServer(str(d)) as srv:
        for name in STREAMS:
            size = os.path.getsize(out[name])
            with open(out[name], "rb") as fp:
                fp.seek(size - 28)
                tail = fp.read()
            srv.extra[f"/tickets/{name}"] = htsget_ticket(
                srv.url(f"{name}.bam"), size - 28, 3, tail)
        out["server"] = srv
        yield out


def _deflated_payload():
    """Whole records of the varied stream in under 3,000 bytes."""
    data, offs, sizes = _frame(STREAMS["varied"])
    end = max(int(o + s) for o, s in zip(offs, sizes) if o + s <= 3_000)
    return STREAMS["varied"][:end]


@pytest.mark.parametrize("name", ["varied", "edges", "deflated",
                                  "plain_gzip", "uncompressed"])
def test_bam_file_to_sam_from_a_path_matches_jax(files, name, tmp_path):
    if name == "deflated":
        path = _bam(str(tmp_path / "d.bam"), _deflated_payload(), level=6)
    else:
        path = files[name]
    timing = {}
    hdr, text = tb.bam_file_to_sam(path, device="cpu", timing=timing)
    jhdr, jtext = jb.bam_file_to_sam(path)
    assert hdr.text == jhdr.text and hdr.ref_names == jhdr.ref_names
    assert text.dtype == np.uint8 and text.tobytes() == jtext.tobytes()
    _, jpy = _jax_both(jb.bam_file_to_sam, path)
    assert text.tobytes() == jpy[1].tobytes()
    assert {"read_s", "format_s", "format"} <= set(timing)
    with open(path, "rb") as fp:
        assert tb.bam_file_to_sam(fp, device="cpu")[1].tobytes() \
            == text.tobytes()


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_bam_file_to_sam_over_the_network_matches_jax(files, name):
    """From http://127.0.0.1 (one request for the body) and from an
    htsget+http ticket of three Range parts and an inline EOF member."""
    srv = files["server"]
    want = jb.bam_file_to_sam(files[name])[1].tobytes()
    n0 = len(srv.requests)
    _, text = tb.bam_file_to_sam(srv.url(f"{name}.bam"), device="cpu")
    assert text.tobytes() == want
    assert len(srv.requests) - n0 == 1
    url = f"htsget+http://127.0.0.1:{srv.port}/tickets/{name}"
    n0 = len(srv.requests)
    _, text = tb.bam_file_to_sam(url, device="cpu")
    assert text.tobytes() == want
    assert len(srv.requests) - n0 == 4
    assert [r[1] is not None for r in srv.requests[n0 + 1:]] == [True] * 3


@pytest.mark.parametrize("start", [0, 1])
def test_bam_stream_to_sam_matches_jax(start):
    payload = STREAMS["edges"]
    first = 4 + int.from_bytes(payload[:4], "little")
    at = 0 if start == 0 else first
    data = np.frombuffer(payload, np.uint8)
    got = tb.bam_stream_to_sam(data, HDR, at, device="cpu")
    native, python = _jax_both(jb.bam_stream_to_sam, data, JHDR, at)
    assert got.tobytes() == native.tobytes() == python.tobytes()


def test_truncated_stream_raises_ioerror_in_both(tmp_path, monkeypatch):
    """A stream whose last record is cut raises IOError in the port and
    in the JAX function's Python path.  The JAX native scan does not
    return on it (ROADMAP queue C), so the JAX side runs with
    `htslib_tpu.native.native` None."""
    monkeypatch.setattr(jnative, "native", None)
    payload = STREAMS["varied"][:-7]
    data = np.frombuffer(payload, np.uint8)
    path = _bam(str(tmp_path / "t.bam"), payload)
    for run in (lambda: tb.bam_stream_to_sam(data, HDR, device="cpu"),
                lambda: jb.bam_stream_to_sam(data, JHDR),
                lambda: tb.bam_file_to_sam(path, device="cpu"),
                lambda: jb.bam_file_to_sam(path)):
        with pytest.raises(IOError, match="truncated BAM record stream"):
            run()


def test_no_card_and_failed_launch_raise(files, monkeypatch):
    """device="cuda" raises without a card; a device step that raises is
    not caught: nothing falls back to the host formatter."""
    import torch
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tb.bam_file_to_sam(files["varied"])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tb.bam_stream_to_sam(np.zeros(0, np.uint8), HDR)
    calls = []
    monkeypatch.setattr(tb, "format_sam_batch",
                        lambda *a: calls.append(a) or b"")

    def fail(*a, **kw):
        raise RuntimeError("launch failed")

    for target in ("bam_payload_to_sam_device", "inflate_range"):
        with monkeypatch.context() as m:
            m.setattr(tb, target, fail)
            with pytest.raises(RuntimeError, match="launch failed"):
                tb.bam_file_to_sam(files["varied"], device="cpu")
    assert not calls


def _sam_text(name):
    data, offs, sizes = _frame(STREAMS[name])
    return jb.format_sam_batch(jb.decode_bam_columns(data, offs, sizes),
                               JHDR)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_sam_text_to_bam_matches_jax(name):
    text = HDR_TEXT.encode() + _sam_text(name) + b"\n"
    got = tb.sam_text_to_bam(text, HDR)
    native = jb.sam_text_to_bam(text, JHDR)
    record_path = b"".join(
        struct.pack("<I", len(b)) + b for b in (
            JRecord.from_sam(ln, JHDR).to_bam_buffer()
            for ln in text.decode().splitlines()
            if ln and not ln.startswith("@")))
    assert got.tobytes() == native.tobytes() == record_path
    # and the text comes back
    data, offs, sizes = _frame(got.tobytes())
    assert tb.bam_to_sam_bytes(data, offs, sizes, HDR) == _sam_text(name)


def test_jax_python_sam_text_to_bam_raises():
    """The JAX function's Python path uses `struct` without importing it,
    so with its native library off it raises NameError (ROADMAP queue C);
    the port's parses."""
    text = b"r1\t0\tchr1\t5\t60\t4M\t*\t0\t0\tACGT\tFFFF\n"
    saved = jnative.native
    jnative.native = None
    try:
        with pytest.raises(NameError, match="struct"):
            jb.sam_text_to_bam(text, JHDR)
    finally:
        jnative.native = saved
    assert len(tb.sam_text_to_bam(text, HDR)) == 4 + 32 + 3 + 4 + 2 + 4


@pytest.mark.parametrize("chunk", [1 << 12, 8 << 20])
def test_sam_to_bam_file_matches_jax(tmp_path, chunk):
    """The file's uncompressed stream equals the JAX function's (its
    native deflate may write other bytes; the members are compared
    inflated), its members are zlib's at the level (0, stored, so that
    the CPU's plain inflate reads it back quickly), and bam_file_to_sam
    gives the text back."""
    text = _sam_text("varied") + _sam_text("edges")
    out, jout = str(tmp_path / "o.bam"), str(tmp_path / "j.bam")
    n = tb.sam_to_bam_file(text, HDR, out, level=0, chunk_bytes=chunk)
    jn = jb.sam_to_bam_file(text, JHDR, jout, level=0, chunk_bytes=chunk)
    assert n == jn

    def stream(path):
        raw = read_file(path).tobytes()
        return gzip.decompress(raw), raw

    got, raw = stream(out)
    assert got == stream(jout)[0] and raw.endswith(BGZF_EOF)
    assert len(got) == n
    assert tb.bam_file_to_sam(out, device="cpu")[1].tobytes() == text
    # each member is the zlib deflate of its 0xff00-byte piece
    first = zlib.compressobj(0, zlib.DEFLATED, -15)
    body = first.compress(got[:0xFF00]) + first.flush()
    assert raw[18:18 + len(body)] == body
