"""The port's host CRAM writer and reader (htslib_tpu_torch/cram/) and its
CRAM -> SAM with block decode on the device (cram/batch.py) against the
JAX package's (htslib_tpu/cram/).

Inputs are made here from a seed: the port's `dryrun_records` with f and
d aux values and B arrays added, their mapped reads' bases copied from a
seeded FASTA with a few substitutions, written as a BAM.  The JAX
package writes CRAM two ways, through its native library and through its
pure-Python encoder (`htslib_tpu.native.native` set to None; its
functions read it at call time), and the two write different bytes; so
does the port, through its own native library or with
`htslib_tpu_torch.native.native` None.  The port's encoder is held to
the JAX encoder on each route, its decoder to the files of both.  On the CPU the device stages run their plain versions;
outputs are bytes and integers, so every comparison is exact."""
import os
import shutil

import jax
import numpy as np
import pytest

from htslib_tpu.cram import CramReader as JReader
from htslib_tpu.cram import batch as jbatch
from htslib_tpu.cram import decode as jdecode
from htslib_tpu.cram.io import CramIO as JIO
from htslib_tpu.cram.io import read_file_definition as jread_def
from htslib_tpu_torch.codecs import rans4x8, rans4x16
from htslib_tpu_torch.cram import CRAM_EOF_START, CramReader, CramWriter
from htslib_tpu_torch.cram import batch as tbatch
from htslib_tpu_torch.cram import decode as tdecode
from htslib_tpu_torch.cram.io import CramBlock, CramIO, read_file_definition
from htslib_tpu_torch.cram.structs import (CT_CORE, CT_EXTERNAL, GZIP, RANS,
                                           RANSPR, RAW)
from htslib_tpu_torch.entry import DRYRUN_REFS, dryrun_records
from htslib_tpu_torch.faidx import Faidx
from htslib_tpu_torch.sam.bam import BamWriter
from htslib_tpu_torch.sam.record import encode_aux

VERSIONS = [(3, 0), (3, 1)]


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX package runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", before)


def write_fasta(path, seed, refs=DRYRUN_REFS, width=60):
    """A seeded plain FASTA of `refs` (name, length), `width` bases a
    line; returns {name: bases}."""
    rng = np.random.default_rng(seed)
    seqs = {}
    with open(path, "w") as fp:
        for name, ln in refs:
            seqs[name] = "".join(rng.choice(list("ACGT"), ln))
            fp.write(f">{name}\n")
            for i in range(0, ln, width):
                fp.write(seqs[name][i:i + width] + "\n")
    return seqs


def cram_records(n, seed, seqs):
    """`dryrun_records(n, seed)` with their mapped reads' M/=/X bases
    taken from `seqs` (1 in 30 substituted, a few N), and on some records
    XF:f, XD:d and ZB:B (f, s or C) aux values."""
    hdr, recs = dryrun_records(n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    for i, b in enumerate(recs):
        if b.tid >= 0 and b.l_qseq:
            ref = seqs[DRYRUN_REFS[b.tid][0]]
            seq = list(b.seq)
            q = rp = 0
            for c in b.cigar.tolist():
                op, ln = c & 15, c >> 4
                if op in (0, 7, 8):
                    for k in range(ln):
                        base = ref[rp + k] if rp + k < len(ref) else "N"
                        r = rng.random()
                        seq[q + k] = ("N" if r < 0.005 else
                                      "ACGT"[rng.integers(4)] if r < 0.035
                                      else base)
                if op in (0, 1, 4, 7, 8):
                    q += ln
                if op in (0, 2, 3, 7, 8):
                    rp += ln
            qual = b.qual
            b.set_seq("".join(seq), qual)
        if i % 7 == 0:
            b.aux += encode_aux(b"XF", "f", float(rng.normal() * 10.0 ** int(
                rng.integers(-6, 6))))
        if i % 11 == 0:
            b.aux += encode_aux(b"XD", "d", float(rng.exponential(1e5)))
        if i % 13 == 0:
            sub = str(rng.choice(["f", "s", "C"]))
            vals = (rng.normal(size=int(rng.integers(0, 5))) * 100
                    if sub == "f" else rng.integers(0, 200, int(
                        rng.integers(1, 5))))
            b.aux += encode_aux(b"ZB", "B", (sub, vals))
    return hdr, recs


def write_bam(path, hdr, recs):
    with BamWriter(path, hdr, level=1) as w:
        for r in recs:
            w.write(r)
    return path


def jax_cram(bam, path, native_on, monkeypatch, **opts):
    """The JAX package's bam_to_cram_file, native code on or off."""
    if not native_on:
        monkeypatch.setattr("htslib_tpu.native.native", None)
    try:
        jbatch.bam_to_cram_file(bam, path, **opts)
    finally:
        monkeypatch.undo()
    return path


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """The BAM (300 records), its FASTA, and the CRAM files of the three
    encoders (the port's, the JAX Python path's, the JAX native one's)
    for CRAM 3.0 and 3.1, with and without the reference, at 100 records
    a slice: {(encoder, version, with_ref): path}."""
    d = tmp_path_factory.mktemp("cram")
    fa = str(d / "ref.fa")
    seqs = write_fasta(fa, 5)
    hdr, recs = cram_records(300, 31, seqs)
    bam = write_bam(str(d / "in.bam"), hdr, recs)
    mp = pytest.MonkeyPatch()
    files = {}
    for ver in VERSIONS:
        for with_ref in (False, True):
            opts = dict(ref=fa if with_ref else None, version=ver,
                        seqs_per_slice=100)
            tag = f"{ver[0]}{ver[1]}_{'ref' if with_ref else 'noref'}"
            p = str(d / f"port_{tag}.cram")
            tbatch.bam_to_cram_file(bam, p, **opts)
            files[("port", ver, with_ref)] = p
            for enc, on in (("jax_py", False), ("jax_native", True)):
                files[(enc, ver, with_ref)] = jax_cram(
                    bam, str(d / f"{enc}_{tag}.cram"), on, mp, **opts)
    return {"dir": d, "fasta": fa, "seqs": seqs, "bam": bam, "hdr": hdr,
            "recs": recs, "files": files}


FILE_KEYS = [(enc, ver, ref) for enc in ("port", "jax_py", "jax_native")
             for ver in VERSIONS for ref in (False, True)]
FILE_IDS = [f"{e}-{v[0]}.{v[1]}-{'ref' if r else 'noref'}"
            for e, v, r in FILE_KEYS]


def _ref(corpus, key):
    return corpus["fasta"] if key[2] else None


# -- the header model and the FASTA index ---------------------------------

def test_header_text_and_lines_match_jax():
    from htslib_tpu.sam.header import SamHeader as JHeader
    from htslib_tpu_torch.sam.header import SamHeader
    text = ("@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:a\tLN:10\tAN:x,y\n"
            "@SQ\tSN:b\tLN:20\tM5:0123\n@RG\tID:g1\tSM:s\n@RG\tID:g2\n"
            "@PG\tID:p\tPN:prog\n@CO\tfree text\n")
    h, j = SamHeader(text), JHeader(text)
    assert h.text == j.text == text
    assert [ln.format() for ln in h.lines] == [ln.format() for ln in
                                               j.lines]
    assert h.ref_names == j.ref_names and h.ref_lens == j.ref_lens
    for name in ("a", "b", "x", "y", "*", "zz"):
        assert h.name2tid(name) == j.name2tid(name)
    assert [ln.get("ID") for ln in h.lines if ln.type == "RG"] == [
        "g1", "g2"]
    assert h.find_line_id("SQ", "SN", "b").get("M5") == "0123"
    for hh in (h, j):
        hh.find_line_id("SQ", "SN", "a").set("UR", "/x.fa")
        hh._dirty = True
    assert h.text == j.text
    # a binary reference list wins over the text's @SQ lines
    h2 = SamHeader("@SQ\tSN:a\tLN:5\n", ref_names=["c", "d"],
                   ref_lens=[7, 8])
    j2 = JHeader("@SQ\tSN:a\tLN:5\n", [("c", 7), ("d", 8)])
    assert (h2.ref_names, h2.ref_lens) == (j2.ref_names, j2.ref_lens)
    assert h2.full_text_with_refs() == j2.full_text_with_refs()
    assert h2.copy().text == j2.copy().text


def test_faidx_fetch_matches_jax(tmp_path):
    from htslib_tpu.faidx import Faidx as JFaidx
    fa = str(tmp_path / "r.fa")
    seqs = write_fasta(fa, 9, refs=[("s1", 301), ("s2", 60), ("s3", 7)],
                       width=50)
    fai = Faidx.load(fa)
    with open(fa + ".fai") as fp:
        ours = fp.read()
    os.remove(fa + ".fai")
    jfai = JFaidx.load(fa)
    with open(fa + ".fai") as fp:
        assert fp.read() == ours
    for name, s in seqs.items():
        for beg, end in ((0, len(s)), (0, 1), (49, 51), (50, 100),
                         (len(s) - 1, len(s) + 5), (3, 3)):
            assert fai.fetch_seq(name, beg, end) == s[beg:end] == \
                jfai.fetch_seq(name, beg, end)


# -- headers of the containers and slices ---------------------------------

def _containers(path, io_cls, read_def, decode):
    """(compression header, [slice headers]) of every data container."""
    out = []
    with open(path, "rb") as fp:
        ver, _ = read_def(fp)
        io = io_cls(fp, ver)
        c = io.read_container_header()
        fp.seek(c.data_offset + c.length)
        while True:
            c = io.read_container_header()
            if c is None or (c.ref_seq_id == -1
                             and c.ref_seq_start == CRAM_EOF_START):
                break
            end = c.data_offset + c.length
            chdr = decode.decode_compression_header(io.read_block(), ver[0])
            shs = []
            while fp.tell() < end:
                sh = decode.decode_slice_header(io.read_block(), ver[0])
                shs.append(sh)
                for _ in range(sh.num_blocks):
                    io.read_block()
            out.append((chdr, shs))
    return out


def _codec_fields(codec):
    """A codec's class name and its parameters, recursively."""
    if codec is None:
        return None
    out = {"class": type(codec).__name__}
    for k, v in vars(codec).items():
        if k in ("_by_len",):
            continue
        out[k] = (_codec_fields(v) if hasattr(v, "read_int") else v)
    return out


@pytest.mark.parametrize("key", FILE_KEYS, ids=FILE_IDS)
def test_container_and_slice_headers_match_jax(corpus, key):
    path = corpus["files"][key]
    ours = _containers(path, CramIO, read_file_definition, tdecode)
    theirs = _containers(path, JIO, jread_def, jdecode)
    assert len(ours) == len(theirs) == 3
    for (ch, shs), (jch, jshs) in zip(ours, theirs):
        for f in ("read_names_included", "AP_delta", "no_ref",
                  "qs_seq_orient", "sub_matrix", "TD"):
            assert getattr(ch, f) == getattr(jch, f), f
        assert sorted(ch.codecs) == sorted(jch.codecs)
        for k in ch.codecs:
            assert _codec_fields(ch.codecs[k]) == _codec_fields(
                jch.codecs[k]), k
        assert sorted(ch.tag_codecs) == sorted(jch.tag_codecs)
        for k in ch.tag_codecs:
            assert _codec_fields(ch.tag_codecs[k]) == _codec_fields(
                jch.tag_codecs[k])
        assert [vars(s) for s in shs] == [vars(s) for s in jshs]


# -- the encoder -----------------------------------------------------------

@pytest.mark.parametrize("spc", [1, 2])
@pytest.mark.parametrize("with_ref", [False, True], ids=["noref", "ref"])
@pytest.mark.parametrize("ver", VERSIONS, ids=["3.0", "3.1"])
def test_bam_to_cram_file_writes_the_jax_python_bytes(corpus, ver, with_ref,
                                                      spc, tmp_path,
                                                      monkeypatch):
    """The port's bam_to_cram_file writes the JAX function's bytes on
    each route: the JAX Python path's with both native libraries off, the
    JAX native path's with both on."""
    opts = dict(ref=corpus["fasta"] if with_ref else None, version=ver,
                seqs_per_slice=100, slices_per_container=spc)
    for on in (False, True):
        ours = str(tmp_path / f"p{on:d}.cram")
        if not on:
            monkeypatch.setattr("htslib_tpu_torch.native.native", None)
        n = tbatch.bam_to_cram_file(corpus["bam"], ours, **opts)
        monkeypatch.undo()
        theirs = jax_cram(corpus["bam"], str(tmp_path / f"j{on:d}.cram"), on,
                          monkeypatch, **opts)
        assert n == 300
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read(), on


def test_the_two_jax_encoders_write_different_bytes(corpus):
    """The JAX native encoder writes other bytes than the JAX Python path
    (which decode to the same text: test_cram_file_to_sam_matches_jax);
    the port's encoder, on its default native route, writes the JAX
    native encoder's."""
    for ver in VERSIONS:
        for with_ref in (False, True):
            paths = [corpus["files"][(e, ver, with_ref)]
                     for e in ("jax_py", "jax_native", "port")]
            a, b, c = (open(p, "rb").read() for p in paths)
            assert a != b and b == c


def test_cram_writer_records_write_the_jax_python_bytes(corpus, tmp_path,
                                                        monkeypatch):
    """The record path (CramWriter.write), with a profile that turns the
    FQZ and bzip2 challengers on and two slices a container: the JAX
    Python path's bytes with both native libraries off, the JAX native
    path's with both on."""
    from htslib_tpu.cram import CramWriter as JWriter
    from htslib_tpu.sam.header import SamHeader as JHeader
    from htslib_tpu.sam.record import BamRecord as JRecord
    opts = dict(version=(3, 1), seqs_per_slice=100,
                slices_per_container=2, profile="small")
    for on in (True, False):
        ours = str(tmp_path / f"p{on:d}.cram")
        theirs = str(tmp_path / f"j{on:d}.cram")
        if not on:
            monkeypatch.setattr("htslib_tpu.native.native", None)
            monkeypatch.setattr("htslib_tpu_torch.native.native", None)
        with CramWriter(ours, corpus["hdr"], **opts) as w:
            for r in corpus["recs"]:
                w.write(r)
        with JWriter(theirs, JHeader(corpus["hdr"].text), nthreads=1,
                     **opts) as w:
            for r in corpus["recs"]:
                w.write(JRecord.from_bam_buffer(r.to_bam_buffer()))
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read(), on


# -- the decoder -----------------------------------------------------------

@pytest.mark.parametrize("key", FILE_KEYS, ids=FILE_IDS)
def test_cram_reader_records_match_jax(corpus, key):
    path, ref = corpus["files"][key], _ref(corpus, key)
    with CramReader(path, ref=ref) as r:
        ours = [rec.to_bam_buffer() for rec in r]
        text = r.header.text
    with JReader(path, ref=ref) as r:
        theirs = [rec.to_bam_buffer() for rec in r]
        assert text == r.header.text
    assert len(ours) == 300 and ours == theirs


@pytest.mark.parametrize("key", FILE_KEYS, ids=FILE_IDS)
def test_cram_file_to_sam_matches_jax(corpus, key, monkeypatch):
    """Blocks through ops/rans.py's plain versions, records on the host
    (the native slice decoder, or the Python loop with the port's native
    library off), SAM formatting through ops/bam2sam.py's plain versions;
    the JAX text with its native code on and off."""
    path, ref = corpus["files"][key], _ref(corpus, key)
    timing = {}
    hdr, ours = tbatch.cram_file_to_sam(path, ref=ref, device="cpu",
                                        timing=timing)
    _, native = jbatch.cram_file_to_sam(path, ref=ref)
    monkeypatch.setattr("htslib_tpu.native.native", None)
    monkeypatch.setattr("htslib_tpu_torch.native.native", None)
    jhdr, python = jbatch.cram_file_to_sam(path, ref=ref)
    _, pure = tbatch.cram_file_to_sam(path, ref=ref, device="cpu")
    assert ours.dtype == np.uint8
    assert (ours.tobytes() == native.tobytes() == python.tobytes()
            == pure.tobytes())
    assert hdr.text == jhdr.text
    assert timing["records"] == 300 and timing["slices"] == 3
    assert sum(v for k, v in timing["wires"].items() if k != "host") > 0


def test_md_nm_regenerated_against_the_reference(corpus):
    """With the reference, MD and NM come back from the features
    (decode_md); without it, or with decode_md off, they do not."""
    key = ("port", (3, 0), True)
    path, ref = corpus["files"][key], corpus["fasta"]
    _, with_md = tbatch.cram_file_to_sam(path, ref=ref, device="cpu")
    _, without = tbatch.cram_file_to_sam(path, ref=ref, decode_md=False,
                                         device="cpu")
    _, jwithout = jbatch.cram_file_to_sam(path, ref=ref, decode_md=False)
    assert b"\tMD:Z:" in with_md.tobytes()
    assert b"\tMD:Z:" not in without.tobytes()
    assert without.tobytes() == jwithout.tobytes()


# -- the device stage ------------------------------------------------------

def _blk(method, raw, data=None, cid=1):
    data = raw if data is None else data
    return CramBlock(method, CT_EXTERNAL, cid, len(data), len(raw), data)


def _mixed_blocks():
    """(block, wire) over every route: rANS 4x8 order 0 and 1, Nx16
    4-way and 32-way of both orders, Nx16 with PACK and with RLE (host),
    RAW, GZIP, an empty rANS block and an empty Nx16 one (host)."""
    import zlib
    rng = np.random.default_rng(12)
    qual = rng.integers(2, 42, 3000, dtype=np.uint8).tobytes()
    few = rng.integers(0, 4, 2000, dtype=np.uint8).tobytes()
    runs = bytes(np.repeat(rng.integers(0, 5, 300), 7).astype(np.uint8))
    gz = zlib.compressobj(6, zlib.DEFLATED, 31)
    return [
        (_blk(RANS, qual, rans4x8.compress(qual, 0)), "4x8_o0"),
        (_blk(RANS, qual, rans4x8.compress(qual, 1)), "4x8_o1"),
        (_blk(RANSPR, qual, rans4x16.compress(qual, 0x00)), "nx16_4way_o0"),
        (_blk(RANSPR, qual, rans4x16.compress(qual, 0x01)), "nx16_4way_o1"),
        (_blk(RANSPR, qual, rans4x16.compress(qual, 0x04)),
         "nx16_32way_o0"),
        (_blk(RANSPR, qual, rans4x16.compress(qual, 0x05)),
         "nx16_32way_o1"),
        (_blk(RANSPR, few, rans4x16.compress(few, 0x80)), None),
        (_blk(RANSPR, runs, rans4x16.compress(runs, 0x40)), None),
        (_blk(RAW, qual[:100]), None),
        (_blk(GZIP, qual, gz.compress(qual) + gz.flush()), None),
        (_blk(RANS, b"", b""), None),
        (_blk(RANSPR, b"", rans4x16.compress(b"", 0)), None),
    ]


def test_decode_blocks_routes_and_matches_the_host_codecs(monkeypatch):
    pairs = _mixed_blocks()
    blocks = [b for b, _ in pairs]
    assert [tbatch.block_wire(b) for b in blocks] == [w for _, w in pairs]
    calls = []
    for name in ("uncompress_batch", "uncompress_nx16_batch"):
        real = getattr(tbatch, name)

        def spy(datas, device, real=real, name=name):
            calls.append((name, list(datas)))
            return real(datas, device=device)
        monkeypatch.setattr(tbatch, name, spy)
    counts = tbatch.decode_blocks(blocks, device="cpu")
    sent = {d for _, datas in calls for d in datas}
    assert len(calls) == 2
    for b, w in pairs:
        assert (bytes(b.data) in sent) == (w is not None)
        fresh = CramBlock(b.method, b.content_type, b.content_id,
                          b.comp_size, b.raw_size, b.data)
        assert b._uncompressed == fresh.uncompress()
    assert counts == {"4x8_o0": 1, "4x8_o1": 1, "nx16_4way_o0": 1,
                      "nx16_4way_o1": 1, "nx16_32way_o0": 1,
                      "nx16_32way_o1": 1, "host": 6}


def test_routing_is_decided_before_the_launch_and_errors_raise(monkeypatch):
    """Every block is routed before the first launch, and a device error
    raises: no block is decoded again on the host."""
    events = []
    real_wire = tbatch.block_wire
    monkeypatch.setattr(tbatch, "block_wire",
                        lambda b: events.append("route") or real_wire(b))

    def fail(datas, device):
        events.append("launch")
        raise RuntimeError("kernel failed")
    monkeypatch.setattr(tbatch, "uncompress_batch", fail)
    pairs = _mixed_blocks()
    with pytest.raises(RuntimeError, match="kernel failed"):
        tbatch.decode_blocks([b for b, _ in pairs], device="cpu")
    assert events == ["route"] * len(pairs) + ["launch"]
    assert all(b._uncompressed is None for b, w in pairs if w)


def test_decode_blocks_of_files_match_the_host_codecs(corpus, monkeypatch):
    """Every data block of a 3.0 file and a 3.1 file, decoded in one
    call, equals its host codec's bytes.  The files hold rANS 4x8 blocks
    of both orders, 4-way Nx16 of both orders, Nx16 with PACK and empty
    blocks; only the rANS blocks without a transform reach the device
    functions."""
    sent = []
    for name in ("uncompress_batch", "uncompress_nx16_batch"):
        real = getattr(tbatch, name)

        def spy(datas, device, real=real):
            sent.extend(datas)
            return real(datas, device=device)
        monkeypatch.setattr(tbatch, name, spy)
    seen, kinds = {}, set()
    for key in (("port", (3, 0), True), ("port", (3, 1), False)):
        blocks = []
        with open(corpus["files"][key], "rb") as fp:
            ver, _ = read_file_definition(fp)
            io = CramIO(fp, ver)
            c = io.read_container_header()
            fp.seek(c.data_offset + c.length)
            while True:
                c = io.read_container_header()
                if c is None or c.ref_seq_start == CRAM_EOF_START:
                    break
                end = c.data_offset + c.length
                while fp.tell() < end:
                    b = io.read_block()
                    if b.content_type in (CT_CORE, CT_EXTERNAL):
                        blocks.append(b)
        seen.update(tbatch.decode_blocks(blocks, device="cpu"))
        for b in blocks:
            fresh = CramBlock(b.method, b.content_type, b.content_id,
                              b.comp_size, b.raw_size, b.data)
            assert b._uncompressed == fresh.uncompress()
            routed = tbatch.block_wire(b) is not None
            assert (b.data in sent) == routed
            if b.raw_size == 0:
                kinds.add("empty")
            elif b.method == RANSPR and b.data[0] & 0x80:
                kinds.add("pack")
    assert {"4x8_o0", "4x8_o1", "nx16_4way_o0", "nx16_4way_o1",
            "host"} <= set(seen)
    assert kinds == {"empty", "pack"}


# -- errors ----------------------------------------------------------------

def test_wrong_reference_raises_the_slice_md5_error(corpus, tmp_path):
    bad = str(tmp_path / "bad.fa")
    write_fasta(bad, 6)
    path = corpus["files"][("port", (3, 0), True)]
    with pytest.raises(IOError, match="MD5 checksum reference mismatch"):
        tbatch.cram_file_to_sam(path, ref=bad, device="cpu")
    with pytest.raises(IOError, match="MD5 checksum reference mismatch"):
        list(CramReader(path, ref=bad))
    with pytest.raises(IOError, match="MD5 checksum reference mismatch"):
        jbatch.cram_file_to_sam(path, ref=bad)


def test_missing_reference_raises(corpus, tmp_path, monkeypatch):
    """A reference-based file whose FASTA (named by its @SQ UR tags) is
    gone, decoded with no ref=: both sides raise IOError."""
    monkeypatch.delenv("REF_PATH", raising=False)
    monkeypatch.delenv("REF_CACHE", raising=False)
    fa = str(tmp_path / "gone.fa")
    shutil.copy(corpus["fasta"], fa)
    path = str(tmp_path / "r.cram")
    tbatch.bam_to_cram_file(corpus["bam"], path, ref=fa, seqs_per_slice=100)
    os.remove(fa)
    os.remove(fa + ".fai")
    with pytest.raises(IOError, match="unable to load reference"):
        tbatch.cram_file_to_sam(path, device="cpu")
    with pytest.raises(IOError, match="unable to load reference"):
        jbatch.cram_file_to_sam(path)
