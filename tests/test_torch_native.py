"""The port's native host engine (htslib_tpu_torch/native/) against the
JAX package's (htslib_tpu/native/) on the CPU.

Each bridge function of the port is held byte for byte against the JAX
bridge on the same inputs, made here from a seed: BAM record streams and
BGZF files of the port's `dryrun_records`, SAM text, the VCF matrix of
tests/test_torch_vcf.py, CRAM slices of the port's writer, and codec
inputs.  Each routed function of the port is then held against its JAX
twin twice: with both native libraries on, and with both set to None
(`route`).  The library's build is checked apart: its name follows every
byte of the sources, a failed build raises with the compiler's report,
and compat/'s stand-ins for libdeflate and liblzma (what a host without
their headers builds with) write zlib's bytes and read what zlib, gzip
and xz write.  On the CPU the device stages run their plain versions;
every comparison is exact."""
import ctypes
import lzma
import os
import shutil
import struct
import subprocess
import zlib

import jax
import numpy as np
import pytest

import htslib_tpu
import htslib_tpu.native as jn
import htslib_tpu_torch
import htslib_tpu_torch.native as tn
from htslib_tpu import bgzf as jbgzf
from htslib_tpu import pileup as jpileup
from htslib_tpu.codecs import rans4x8 as jrans4x8
from htslib_tpu.cram import batch as jbatch
from htslib_tpu.cram.io import CramBlock as JBlock
from htslib_tpu.parallel import distributed as jdist
from htslib_tpu.sam import BamReader as JBamReader
from htslib_tpu.sam import batch as jsb
from htslib_tpu.sam.header import SamHeader as JHeader
from htslib_tpu.vcf import io as jio
from htslib_tpu.vcf.header import BcfHeader as JBcfHeader
from htslib_tpu_torch import bgzf as tbgzf
from htslib_tpu_torch import pileup as tpileup
from htslib_tpu_torch.codecs import rans4x8 as trans4x8
from htslib_tpu_torch.cram import CramReader
from htslib_tpu_torch.cram import batch as tbatch
from htslib_tpu_torch.cram import decode as tdecode
from htslib_tpu_torch.cram.io import CramBlock
from htslib_tpu_torch.cram.structs import (ARITH, CT_CORE, CT_EXTERNAL, FQZ,
                                           RANSPR, TOK3)
from htslib_tpu_torch.entry import dryrun_records
from htslib_tpu_torch.parallel import distributed as tdist
from htslib_tpu_torch.sam import batch as tsb
from htslib_tpu_torch.sam.bam import BamReader, BamWriter
from htslib_tpu_torch.sam.record import BamRecord
from htslib_tpu_torch.vcf import io as tio
from htslib_tpu_torch.vcf.header import BcfHeader
from test_torch_cram import cram_records, write_bam, write_fasta
from test_torch_pileup_engine import _make as make_pileup_files
from test_torch_vcf import matrix_vcf, write_port_bcf

SKIP = 0x704    # mpileup's default: unmapped, secondary, QC-fail, dup


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", before)


@pytest.fixture(scope="module")
def libs():
    """(the JAX bridge, the port's bridge), the port's built here."""
    if jn.native is None:
        pytest.skip("the JAX native library does not load here")
    tn.native.load()
    return jn.native, tn.native


@pytest.fixture(params=["native", "pure"])
def route(request, monkeypatch):
    """Both libraries on, or both set to None."""
    if request.param == "pure":
        monkeypatch.setattr("htslib_tpu.native.native", None)
        monkeypatch.setattr("htslib_tpu_torch.native.native", None)
    elif jn.native is None:
        pytest.skip("the JAX native library does not load here")
    return request.param


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype
        assert np.array_equal(a, b)
    else:
        assert a == b


# -- inputs -----------------------------------------------------------------

def _frames(stream):
    """(offsets, sizes) of a u32-framed record stream, walked here."""
    offs, sizes, p = [], [], 0
    while p + 4 <= len(stream):
        n = int.from_bytes(stream[p:p + 4].tobytes(), "little")
        offs.append(p)
        sizes.append(n + 4)
        p += 4 + n
    return np.array(offs, np.uint64), np.array(sizes, np.uint32)


def _stream(recs):
    parts = []
    for r in recs:
        body = r.to_bam_buffer()
        parts.append(struct.pack("<I", len(body)) + body)
    return np.frombuffer(b"".join(parts), np.uint8)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Seeded inputs shared by the bridge and route tests."""
    tmp = str(tmp_path_factory.mktemp("native"))
    hdr, recs = dryrun_records(300, seed=22)
    # each record as SAM text parses it (bin computed), the stream's form
    recs = [BamRecord.from_sam(r.to_sam(hdr), hdr) for r in recs]
    d = {"tmp": tmp, "hdr": hdr, "recs": recs, "stream": _stream(recs),
         "names": list(hdr.ref_names)}
    d["sam"] = (hdr.text + "".join(r.to_sam(hdr) + "\n" for r in recs)
                ).encode()
    d["body"] = b"".join(r.to_sam(hdr).encode() + b"\n" for r in recs)
    for level in (0, 6):
        path = os.path.join(tmp, f"l{level}.bam")
        with BamWriter(path, hdr, level=level) as w:
            for r in recs:
                w.write(r)
        d[f"bam{level}"] = path
    d["raw"] = np.fromfile(d["bam6"], np.uint8)
    rng = np.random.default_rng(23)
    d["chunks"] = [b"", b"ACGT" * 9000, bytes(rng.integers(
        0, 256, 5000, dtype=np.uint8)), rng.integers(
        0, 4, 0xFF00, dtype=np.uint8).tobytes()]
    return d


@pytest.fixture(scope="module")
def crams(tmp_path_factory):
    """Two CRAMs of 200 records in slices of 100 (3.0 with a reference,
    3.1 without), their BAM, FASTA and path."""
    tmp = str(tmp_path_factory.mktemp("native_cram"))
    fasta = os.path.join(tmp, "ref.fa")
    seqs = write_fasta(fasta, 24)
    hdr, recs = cram_records(200, 25, seqs)
    bam = write_bam(os.path.join(tmp, "in.bam"), hdr, recs)
    out = {"bam": bam, "fasta": fasta, "files": {}}
    for ver, ref in (((3, 0), fasta), ((3, 1), None)):
        path = os.path.join(tmp, f"v{ver[0]}{ver[1]}.cram")
        tbatch.bam_to_cram_file(bam, path, ref=ref, version=ver,
                                seqs_per_slice=100)
        out["files"][ver] = (path, ref)
    return out


def _slices(path, ref):
    """Each slice's native decoder arguments (payloads uncompressed on
    the host) and its fused-call arguments."""
    out = []
    with CramReader(path, ref=ref) as r:
        rg = [ln.get("ID") for ln in r.header.lines if ln.type == "RG"]
        for chdr, sh, blocks in tbatch._slice_jobs(r):
            ref_seq = None
            if sh.ref_seq_id >= 0 and not chdr.no_ref:
                ref_seq = r.refs.get(sh.ref_seq_id, sh.ref_seq_start,
                                     sh.ref_seq_start + sh.ref_seq_span - 1)
            cts, cids, payloads = tdecode._native_payloads(blocks)
            data = [b for b in blocks
                    if b.content_type in (CT_CORE, CT_EXTERNAL)]
            head = (chdr.raw, sh.ref_seq_id, sh.ref_seq_start,
                    sh.ref_seq_span, sh.num_records, sh.record_counter)
            tail = (ref_seq, sh.ref_seq_start,
                    r.header.tid2len(sh.ref_seq_id), rg, True)
            out.append((head + (cts, cids, payloads) + tail,
                        head + (cts, cids, [b.method for b in data],
                                [b.raw_size for b in data],
                                [bytes(b.data) for b in data]) + tail
                        + (list(r.header.ref_names),)))
    return out


def _vcf_inputs():
    text, body = matrix_vcf()
    h = BcfHeader(text)
    flt, info, fmt = tio._header_parse_tables(h)
    n_lines = body.count("\n")
    return h, body.encode(), (h.id_names, flt, info, fmt, h.ctg_names,
                              h.id2int("GT"), h.id2int("END"), h.n_samples,
                              n_lines, h.v44)


# -- the bridges, byte for byte ----------------------------------------------

def _b_scan_inflate(j, t, d):
    co, cs, us = t.bgzf_scan(d["raw"])
    _same(j.bgzf_scan(d["raw"]), (co, cs, us))
    for crc in (True, False):
        _same(j.inflate_batch(d["raw"], co, cs, us, crc),
              t.inflate_batch(d["raw"], co, cs, us, crc))
    with pytest.raises(IOError):
        t.bgzf_scan(d["raw"][:-3])
    with pytest.raises(IOError):
        t.inflate_batch(np.where(np.arange(len(d["raw"])) == 40, 0,
                                 d["raw"]).astype(np.uint8), co, cs, us)


def _b_deflate(j, t, d):
    for level in (-1, 0, 1, 6, 9, 12):
        got = t.deflate_blocks(d["chunks"], level)
        assert got == j.deflate_blocks(d["chunks"], level)
        assert [tbgzf.decompress_block(m) for m in got] == d["chunks"]
    blob = np.frombuffer(b"".join(d["chunks"]), np.uint8)
    lens = np.array([len(c) for c in d["chunks"]], np.uint32)
    offs = np.concatenate([[0], np.cumsum(lens[:-1])]).astype(np.uint64)
    # the members (the arena past each is left unwritten)
    for fn in (j.deflate_batch_np, t.deflate_batch_np):
        out, out_lens = fn(blob, offs, lens, 6)
        assert [out[i * tn.MAX_BLOCK:i * tn.MAX_BLOCK + int(n)].tobytes()
                for i, n in enumerate(out_lens)] == t.deflate_blocks(
                    d["chunks"], 6)


def _b_scans(j, t, d):
    s = d["stream"]
    offs, sizes = t.bam_scan(s, 0)
    _same(j.bam_scan(s, 0), (offs, sizes))
    _same(j.bam_fields(s, offs.astype(np.int64)),
          t.bam_fields(s, offs.astype(np.int64)))
    assert j.crc32(s, 7) == t.crc32(s, 7) == zlib.crc32(s.tobytes(), 7)
    with pytest.raises(IOError):
        t.bam_scan(s[:-5], 0)


def _b_format(j, t, d):
    s, names = d["stream"], d["names"]
    offs, sizes = t.bam_scan(s, 0)
    text = t.bam_to_sam(s, offs, sizes, names)
    assert text == j.bam_to_sam(s, offs, sizes, names) == d["body"]
    assert t.bam_scan_format(s, 0, names).tobytes() == text
    assert j.bam_scan_format(s, 0, names).tobytes() == text
    raw = np.fromfile(d["bam6"], np.uint8)
    with BamReader(d["bam6"]) as r:
        u_skip = r.fp.utell()
    assert (t.bgzf_to_sam(raw, u_skip, names).tobytes()
            == j.bgzf_to_sam(raw, u_skip, names).tobytes() == text)


def _b_parse(j, t, d):
    body = np.frombuffer(d["body"], np.uint8)
    got = t.sam_to_bam(body, d["names"])
    assert got.tobytes() == j.sam_to_bam(body, d["names"]).tobytes()
    assert got.tobytes() == d["stream"].tobytes()
    with pytest.raises(IOError):
        t.sam_to_bam(np.frombuffer(b"r\t0\tchrZ\t1\t0\t1M\t*\t0\t0\tA\tI\n",
                                   np.uint8), [])


def _b_mpileup(j, t, d):
    sam, bam = make_pileup_files("multicontig", d["tmp"])
    with BamReader(bam) as r:
        hdr = r.header
        s = r.raw_records()[0]
    for overlaps in (True, False):
        assert (t.mpileup(s, hdr.ref_names, SKIP, overlaps)
                == j.mpileup(s, hdr.ref_names, SKIP, overlaps))
    window = ((1, 500), (3, 1000))
    got = t.mpileup(s, hdr.ref_names, SKIP, True, window=window)
    assert got == j.mpileup(s, hdr.ref_names, SKIP, True, window=window)
    assert got and got.startswith(b"ctg1\t")


def _b_vcf(j, t, d):
    h, body, args = _vcf_inputs()
    frames, bails = t.vcf_parse(np.frombuffer(body, np.uint8), *args)
    _same(j.vcf_parse(np.frombuffer(body, np.uint8), *args),
          (frames, bails))
    f = np.frombuffer(frames, np.uint8)
    vcf = t.bcf_to_vcf(f, h.ctg_names, h.id_names, h.id2int("GT"), h.v44)
    assert vcf == j.bcf_to_vcf(f, h.ctg_names, h.id_names, h.id2int("GT"),
                               h.v44)
    assert vcf.count(b"\n") == int((bails == 0).sum())


def _b_cram(j, t, d, crams):
    """Every slice through both decoders; a decoder may bail (None) on a
    slice's configuration (a multi-reference slice), and then both
    bail."""
    n = dec_n = fused_n = 0
    for path, ref in crams["files"].values():
        for dec, fused in _slices(path, ref):
            blob = t.cram_decode_slice(*dec)
            assert blob == j.cram_decode_slice(*dec)
            dec_n += blob is not None
            sam, want = t.cram_slice_to_sam(*fused), j.cram_slice_to_sam(
                *fused)
            assert (sam is None) == (want is None)
            if sam is not None:
                assert sam.tobytes() == want.tobytes()
                fused_n += 1
            n += 1
    assert n == 4 and dec_n >= 2 and fused_n >= 1


def _b_cram_encode(j, t, d, crams):
    with BamReader(crams["bam"]) as r:
        recs = [b for b in r if b.tid == 0]      # a slice of one reference
    blob = _stream(recs).tobytes()
    ref = open(crams["fasta"]).read().split(">")[1].split("\n", 1)[1]
    ref = ref.replace("\n", "").encode()
    for use_ref in (True, False):
        got = t.cram_encode_slice(blob, 0, 1, ref, 1, use_ref)
        want = j.cram_encode_slice(blob, 0, 1, ref, 1, use_ref)
        assert got is not None
        _same(got, want)


def _b_codecs(j, t, d):
    rng = np.random.default_rng(26)
    qual = bytes((rng.normal(30, 6, 20000).clip(2, 41) + 33).astype(
        np.uint8))
    names = b"".join(b"read:%d:%d\0" % (i // 7, i) for i in range(400))
    for data in (qual, b"ACGT" * 3000, b"x", b""):
        for order in (0, 1):
            c = t.rans4x8_compress(data, order)
            assert c == j.rans4x8_compress(data, order)
            assert (t.rans4x8_uncompress(c, len(data))
                    == j.rans4x8_uncompress(c, len(data)) == data)
    for flags in (0x00, 0x01, 0x04, 0x05, 0x40, 0x41, 0x80, 0x81, 0xC1):
        c = t.rans4x16_compress(qual, flags)
        assert c == j.rans4x16_compress(qual, flags)
        assert t.rans4x16_uncompress(c) == j.rans4x16_uncompress(c) == qual
    for order in (0, 1, 0x41, 0x81):
        c = t.arith_compress(qual, order)
        assert c == j.arith_compress(qual, order)
        assert t.arith_uncompress(c) == j.arith_uncompress(c) == qual
    lens = [100] * 200
    c = t.fqz_compress(qual, lens)
    assert c == j.fqz_compress(qual, lens)
    assert t.fqz_decompress(c) == j.fqz_decompress(c) == qual
    for arith in (0, 1):
        c = t.tok3_encode(names, arith)
        assert c == j.tok3_encode(names, arith)
        assert t.tok3_decode(c) == j.tok3_decode(c) == names
    for level in (1, 6, 9, 12):
        c = t.gzip_compress(qual, level)
        assert c == j.gzip_compress(qual, level)
        assert zlib.decompress(c, 31) == qual


BRIDGES = {"bgzf_scan+inflate_batch": _b_scan_inflate,
           "deflate_blocks+deflate_batch_np": _b_deflate,
           "bam_scan+bam_fields+crc32": _b_scans,
           "bam_to_sam+bam_scan_format+bgzf_to_sam": _b_format,
           "sam_to_bam": _b_parse, "mpileup": _b_mpileup,
           "vcf_parse+bcf_to_vcf": _b_vcf, "codecs": _b_codecs}


@pytest.mark.parametrize("name", list(BRIDGES))
def test_bridge_matches_jax(libs, data, name):
    tn.reset_calls()
    BRIDGES[name](*libs, data)
    called = [k for k, v in tn.CALLS.items() if v]
    for fn in name.split("+"):
        if fn != "codecs":
            assert fn in called


@pytest.mark.parametrize("name", ["cram_decode_slice+cram_slice_to_sam",
                                  "cram_encode_slice"])
def test_cram_bridge_matches_jax(libs, data, crams, name):
    tn.reset_calls()
    {"cram_decode_slice+cram_slice_to_sam": _b_cram,
     "cram_encode_slice": _b_cram_encode}[name](*libs, data, crams)
    for fn in name.split("+"):
        assert tn.CALLS[fn] > 0


# -- the routed functions against their JAX twins -----------------------------

def _moved(route, *names):
    """The port's bridge calls moved on the native route, and only
    there."""
    for n in names:
        assert (tn.CALLS[n] > 0) == (route == "native"), n


def test_bgzf_routes(route, data):
    tn.reset_calls()
    for level in (-1, 0, 6):
        got = tbgzf.deflate_blocks(data["chunks"], level)
        assert got == jbgzf.deflate_blocks(data["chunks"], level)
        assert [tbgzf.compress_block(c, level) for c in data["chunks"]] == got
    raw = data["raw"]
    t, j = tbgzf.scan_blocks(raw, 100), jbgzf.scan_blocks(raw, 100)
    _same((t.coffsets, t.csizes, t.usizes),
          (j.coffsets, j.csizes, j.usizes))
    with tbgzf.BgzfReader(data["bam6"]) as r:
        r.read(10)
        got = r.read_all()
    with jbgzf.BGZFReader(data["bam6"]) as r:
        r.read(10)
        want = r.read_all()
    assert got.tobytes() == want.tobytes()
    _moved(route, "deflate_blocks", "bgzf_scan", "inflate_batch")


def test_rans4x8_and_block_routes(route, data):
    tn.reset_calls()
    rng = np.random.default_rng(27)
    qual = bytes(rng.integers(33, 75, 6000, dtype=np.uint8))
    for order in (0, 1):
        c = trans4x8.compress(qual, order)
        assert c == jrans4x8.compress(qual, order)
        assert trans4x8.uncompress(c) == jrans4x8.uncompress(c) == qual
    names = b"".join(b"q%d\0" % i for i in range(300))
    from htslib_tpu.codecs import arith, fqzcomp, rans4x16, tok3
    for method, comp, raw in (
            (RANSPR, rans4x16.compress(qual, 0x05), qual),
            (ARITH, arith.compress(qual, 1), qual),
            (FQZ, fqzcomp.compress(qual, [100] * 60), qual),
            (TOK3, tok3.encode_names(names.split(b"\0")[:-1]), names)):
        args = (method, CT_EXTERNAL, 1, len(comp), len(raw), comp)
        assert CramBlock(*args).uncompress() == JBlock(*args).uncompress()
    _moved(route, "rans4x8_compress", "rans4x8_uncompress",
           "rans4x16_uncompress", "arith_uncompress", "fqz_decompress",
           "tok3_decode")


@pytest.mark.parametrize("opts", [{"version": (3, 0), "ref": True},
                                  {"version": (3, 1), "profile": "archive"}],
                         ids=["3.0_ref", "3.1_archive"])
def test_cram_encoder_routes(route, crams, tmp_path, opts):
    """bam_to_cram_file (the whole-file scan and the slice encoder, the
    codecs' trials) writes the JAX function's bytes on either route."""
    opts = dict(opts, seqs_per_slice=100)
    ref = crams["fasta"] if opts.pop("ref", False) else None
    tn.reset_calls()
    t, j = str(tmp_path / "t.cram"), str(tmp_path / "j.cram")
    tbatch.bam_to_cram_file(crams["bam"], t, ref=ref, **opts)
    jbatch.bam_to_cram_file(crams["bam"], j, ref=ref, **opts)
    assert open(t, "rb").read() == open(j, "rb").read()
    _moved(route, "bgzf_scan", "bam_fields", "cram_encode_slice")


def test_cram_decode_routes(route, crams):
    """CRAM -> SAM with the blocks decoded on the device (plain versions
    here) and the slices by the native decoder or the Python loop, the
    reader's records, and the record stream: the JAX functions' bytes."""
    tn.reset_calls()
    for path, ref in crams["files"].values():
        timing = {}
        _, got = tbatch.cram_file_to_sam(path, ref=ref, device="cpu",
                                         timing=timing)
        _, want = jbatch.cram_file_to_sam(path, ref=ref)
        assert got.tobytes() == want.tobytes()
        assert timing["wires"]
        _, s = tbatch.cram_file_to_bam_stream(path, ref=ref, device="cpu")
        assert s == jbatch.cram_file_to_bam_stream(path, ref=ref)[1]
        with CramReader(path, ref=ref) as r:
            recs = [b.to_sam(r.header) for b in r]
        from htslib_tpu.cram import CramReader as JReader
        with JReader(path, ref=ref) as r:
            assert recs == [b.to_sam(r.header) for b in r]
    _moved(route, "cram_decode_slice")


def test_sam_batch_routes(route, data, tmp_path):
    tn.reset_calls()
    s = data["stream"]
    offs, sizes = _frames(s)
    jh = JHeader(data["hdr"].text)
    got = tsb.bam_to_sam_bytes(s, offs, sizes, data["hdr"])
    assert got == jsb.bam_to_sam_bytes(s, offs, sizes, jh) == data["body"]
    parsed = tsb.sam_text_to_bam(data["sam"], data["hdr"])
    assert parsed.tobytes() == s.tobytes()
    if route == "native":
        assert (jsb.sam_text_to_bam(data["sam"], jh).tobytes()
                == s.tobytes())
    # the JAX sam_text_to_bam's Python path raises NameError (ROADMAP
    # queue C), so its file is written on the native route only; on the
    # pure route the port's file reads back as the records
    t, j = str(tmp_path / "t.bam"), str(tmp_path / "j.bam")
    n = tsb.sam_to_bam_file(data["sam"], data["hdr"], t, chunk_bytes=9000)
    if route == "native":
        assert n == jsb.sam_to_bam_file(data["sam"], jh, j, chunk_bytes=9000)
        assert open(t, "rb").read() == open(j, "rb").read()
    with BamReader(t) as r:
        assert r.raw_records()[0].tobytes() == s.tobytes()
    with BamReader(data["bam6"]) as r:
        got = r.raw_records()
    with JBamReader(data["bam6"]) as r:
        want = r.raw_records()
    _same(got, want)
    _moved(route, "bam_to_sam", "sam_to_bam", "bam_scan")


@pytest.mark.parametrize("fmt", ["sam", "bam"])
def test_mpileup_routes(route, data, fmt):
    """mpileup_text and mpileup_text_parallel, their reads on the device
    (plain versions here), the engine native or Python."""
    sam, bam = make_pileup_files("edge_ops", data["tmp"])
    path = sam if fmt == "sam" else bam
    tn.reset_calls()
    _, got = tpileup.mpileup_text(path, device="cpu")
    _, want = jpileup.mpileup_text(path)
    assert got == want and got
    threads = 3 if route == "native" else 1
    _, got = tpileup.mpileup_text_parallel(path, threads, device="cpu")
    _, want = jpileup.mpileup_text_parallel(path, threads)
    assert got == want
    _moved(route, "mpileup")


def test_vcf_routes(route, data, tmp_path):
    tn.reset_calls()
    path = write_port_bcf(str(tmp_path / "m.bcf"), level=0)
    th, got = tio.bcf_file_to_vcf(path, device="cpu")
    jh_, want = jio.bcf_file_to_vcf(path)
    text, body = matrix_vcf()
    assert got == want and got.count(b"\n") == body.count("\n")
    assert (tio.vcf_body_to_bcf_frames(body.encode(), BcfHeader(text))
            == jio.vcf_body_to_bcf_frames(body.encode(), JBcfHeader(text)))
    src = tmp_path / "m.vcf"
    src.write_text(text + body)
    t, j = str(tmp_path / "t.bcf"), str(tmp_path / "j.bcf")
    assert tio.vcf_file_to_bcf(str(src), t) == jio.vcf_file_to_bcf(str(src),
                                                                    j)
    assert open(t, "rb").read() == open(j, "rb").read()
    _moved(route, "bcf_to_vcf", "vcf_parse")


def test_distributed_routes(route, data, tmp_path):
    tn.reset_calls()
    tp, jp = (tdist.plan_bam_shards(data["bam6"], 3),
              jdist.plan_bam_shards(data["bam6"], 3))
    _same((tp.coffsets, tp.csizes, tp.usizes),
          (jp.coffsets, jp.csizes, jp.usizes))
    assert [(s.ustart, s.uend, s.n_records) for s in tp.shards] == [
        (s.ustart, s.uend, s.n_records) for s in jp.shards]
    path = write_port_bcf(str(tmp_path / "m.bcf"), level=0)
    plan = tdist.plan_bcf_shards(path, 3, device="cpu")
    got = b"".join(tdist.decode_bcf_shard_to_vcf(plan, s, device="cpu")
                   for s in plan.shards)
    assert got == jio.bcf_file_to_vcf(path)[1]
    _moved(route, "bgzf_scan", "bam_scan", "bcf_to_vcf")


def test_features_route(route):
    assert htslib_tpu_torch.hts_features() == htslib_tpu.hts_features()
    assert bool(htslib_tpu_torch.hts_features() & 32) == (route == "native")


# -- the build ----------------------------------------------------------------

def _copy_sources(dst):
    for sub in ("src", "htscodecs_shim", "compat"):
        shutil.copytree(os.path.join(tn._DIR, sub), os.path.join(dst, sub))


def test_source_hash_follows_every_byte(tmp_path):
    _copy_sources(tmp_path)
    root = str(tmp_path)
    h0 = tn.source_hash(root, ("g++", "-O3"))
    assert h0 == tn.source_hash(tn._DIR, ("g++", "-O3"))
    for rel in ("src/htstpu.cc", "htscodecs_shim/rANS_static4x16pr.c",
                "htscodecs_shim/varint.h", "compat/libdeflate.h"):
        p = os.path.join(root, rel)
        b = bytearray(open(p, "rb").read())
        b[len(b) // 2] ^= 1
        open(p, "wb").write(bytes(b))
        assert tn.source_hash(root, ("g++", "-O3")) != h0, rel
        b[len(b) // 2] ^= 1
        open(p, "wb").write(bytes(b))
        assert tn.source_hash(root, ("g++", "-O3")) == h0
    assert tn.source_hash(root, ("g++", "-O2")) != h0
    with open(os.path.join(root, "compat", "extra.h"), "w") as fp:
        fp.write("\n")
    assert tn.source_hash(root, ("g++", "-O3")) != h0


def test_built_library_is_named_by_its_sources(libs):
    path = tn.build()                         # found built: no rebuild
    assert os.path.dirname(path) == tn.BUILD
    assert os.path.basename(path).startswith("libhtstpu-")
    assert tn.BUILD_INFO["path"] == path and tn.BUILD_INFO["seconds"] == 0.0


def test_failed_build_raises(tmp_path):
    """A source that does not compile raises RuntimeError with the
    compiler's report, and leaves no library behind."""
    _copy_sources(tmp_path)
    with open(tmp_path / "src" / "htstpu.cc", "a") as fp:
        fp.write("\nthis is not C++;\n")
    out = tmp_path / "build"
    with pytest.raises(RuntimeError, match="native build failed"):
        tn.build(str(tmp_path), str(out))
    assert not [f for f in os.listdir(out) if f.endswith(".so")]


_COMPAT = r"""
#include <libdeflate.h>
#include <lzma.h>
extern "C" {
size_t deflate_raw(int lv, const void* in, size_t n, void* out, size_t a) {
  libdeflate_compressor* c = libdeflate_alloc_compressor(lv);
  size_t r = libdeflate_deflate_compress(c, in, n, out, a);
  libdeflate_free_compressor(c);
  return r;
}
size_t deflate_gz(int lv, const void* in, size_t n, void* out, size_t a) {
  libdeflate_compressor* c = libdeflate_alloc_compressor(lv);
  size_t b = libdeflate_gzip_compress_bound(c, n);
  size_t r = b <= a ? libdeflate_gzip_compress(c, in, n, out, a) : 0;
  libdeflate_free_compressor(c);
  return r;
}
long inflate_any(int kind, const void* in, size_t n, void* out, size_t a,
             int exact) {
  libdeflate_decompressor* d = libdeflate_alloc_decompressor();
  size_t got = 0;
  libdeflate_result r =
      kind == 0 ? libdeflate_deflate_decompress(d, in, n, out, a,
                                                exact ? nullptr : &got)
      : kind == 1 ? libdeflate_zlib_decompress(d, in, n, out, a, &got)
                  : libdeflate_gzip_decompress(d, in, n, out, a, &got);
  libdeflate_free_decompressor(d);
  return r == LIBDEFLATE_SUCCESS ? (long)(exact ? a : got) : -(long)r;
}
unsigned crc(unsigned c, const void* p, size_t n) {
  return libdeflate_crc32(c, p, n);
}
long unxz(const uint8_t* in, size_t n, uint8_t* out, size_t a) {
  uint64_t mem = UINT64_MAX;
  size_t ip = 0, op = 0;
  lzma_ret r = lzma_stream_buffer_decode(&mem, 0, nullptr, in, &ip, n, out,
                                         &op, a);
  return r == LZMA_OK ? (long)op : -1;
}
}
"""


def test_compat_headers_match_zlib_and_xz(tmp_path):
    """compat/ on its own (a harness built with zlib, as a host without
    libdeflate's and liblzma's headers builds the library): deflate and
    gzip at levels 0-9 (-1 and 12 clamped) write Python zlib's bytes,
    which the pure route writes; inflate of each wrapper, CRC32 and the
    xz decode read what zlib and lzma write."""
    src = tmp_path / "h.cc"
    src.write_text(_COMPAT)
    so = tmp_path / "h.so"
    subprocess.run(["g++", "-O1", "-shared", "-fPIC", "-I",
                    os.path.join(tn._DIR, "compat"), "-o", str(so),
                    str(src), "-lz", "-ldl"], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    sz = ctypes.c_size_t
    for fn in (lib.deflate_raw, lib.deflate_gz):
        fn.restype = sz
        fn.argtypes = [ctypes.c_int, ctypes.c_char_p, sz, ctypes.c_char_p,
                       sz]
    lib.inflate_any.restype = ctypes.c_long
    lib.inflate_any.argtypes = [ctypes.c_int, ctypes.c_char_p, sz,
                            ctypes.c_char_p, sz, ctypes.c_int]
    lib.crc.restype = ctypes.c_uint
    lib.crc.argtypes = [ctypes.c_uint, ctypes.c_char_p, sz]
    lib.unxz.restype = ctypes.c_long
    lib.unxz.argtypes = [ctypes.c_char_p, sz, ctypes.c_char_p, sz]
    rng = np.random.default_rng(28)
    inputs = [b"", b"A", rng.integers(0, 256, 40000, dtype=np.uint8)
              .tobytes(), rng.integers(0, 4, 0xFF00, dtype=np.uint8)
              .tobytes(), b"\0" * 70000]
    for data in inputs:
        room = len(data) * 2 + 1024
        out = ctypes.create_string_buffer(room)
        for level in (-1, 0, 1, 5, 6, 9, 12):
            zl = 6 if level == -1 else min(level, 9)
            for fn, wbits in ((lib.deflate_raw, -15), (lib.deflate_gz, 31)):
                co = zlib.compressobj(zl, zlib.DEFLATED, wbits)
                want = co.compress(data) + co.flush()
                k = fn(level, data, len(data), out, room)
                assert out.raw[:k] == want, (len(data), level, wbits)
        if len(data) > 1000:        # no room: 0, as libdeflate
            assert lib.deflate_raw(6, data, len(data), out, 16) == 0
        for kind, wbits in ((0, -15), (1, 15), (2, 31)):
            co = zlib.compressobj(6, zlib.DEFLATED, wbits)
            comp = co.compress(data) + co.flush()
            dst = ctypes.create_string_buffer(len(data) + 16)
            assert lib.inflate_any(kind, comp, len(comp), dst, len(data) + 16,
                               0) == len(data)
            assert dst.raw[:len(data)] == data
        if data:
            co = zlib.compressobj(6, zlib.DEFLATED, -15)
            comp = co.compress(data) + co.flush()
            assert lib.inflate_any(0, comp, len(comp), dst, len(data) - 1,
                               0) == -3    # INSUFFICIENT_SPACE
            assert lib.inflate_any(0, comp, len(comp), dst, len(data) + 1,
                               1) == -2    # SHORT_OUTPUT
            assert lib.inflate_any(0, b"\xff" * 8, 8, dst, 8, 0) == -1
        assert lib.crc(5, data, len(data)) == zlib.crc32(data, 5)
        xz = lzma.compress(data, format=lzma.FORMAT_XZ)
        dst = ctypes.create_string_buffer(len(data) + 1)
        assert lib.unxz(xz, len(xz), dst, len(data)) == len(data)
        assert dst.raw[:len(data)] == data


# -- the counters and the pure route ------------------------------------------

def test_calls_count_each_call_and_none_takes_the_pure_route(libs, data,
                                                            monkeypatch):
    tn.reset_calls()
    tbgzf.deflate_blocks(data["chunks"])
    tbgzf.deflate_blocks(data["chunks"][:1])
    assert tn.CALLS["deflate_blocks"] == 2
    assert sum(tn.CALLS.values()) == 2
    monkeypatch.setattr("htslib_tpu_torch.native.native", None)
    tbgzf.deflate_blocks(data["chunks"])
    tsb.sam_text_to_bam(data["sam"], data["hdr"])
    assert sum(tn.CALLS.values()) == 2
    assert set(tn.CALLS) >= {
        "bgzf_scan", "inflate_batch", "deflate_blocks", "bam_scan",
        "bam_to_sam", "bam_scan_format", "bgzf_to_sam", "sam_to_bam",
        "mpileup", "bcf_to_vcf", "vcf_parse", "cram_decode_slice",
        "cram_slice_to_sam", "cram_encode_slice", "bam_fields",
        "rans4x8_compress", "rans4x16_compress", "arith_compress",
        "fqz_compress", "tok3_encode", "gzip_compress"}
