"""The port's BCF shard plans (htslib_tpu_torch/parallel/distributed.py
`plan_bcf_shards`, `decode_bcf_shard_to_vcf`) and the BGZF range inflate
under them (bgzf.py `inflate_range`) against the JAX package's
functions.  Plans are compared field by field; each shard's VCF text
byte for byte, decoded by the port on a plan carried from JAX
(`carry.from_jax_bcf_plan`) and by JAX under both of its paths (native,
and `htslib_tpu.native.native` set to None), at n = 1, 2, 3, 5 and 8, on
the files of the port's and the JAX writers.  On the CPU the inflate
runs its plain version, so the files are mostly stored BGZF (level 0),
whose members it decodes in a few steps; one small file has deflated
members.  Outputs are bytes and integers: equality is exact."""
import gzip
import struct
import zlib

import numpy as np
import pytest
import torch

import torch_ranks
from htslib_tpu.parallel import distributed as jd
from htslib_tpu.vcf import io as jio
from htslib_tpu.vcf.header import BcfHeader as JHeader
from htslib_tpu.vcf.record import BcfRecord as JRecord
from htslib_tpu_torch import bgzf as tbgzf
from htslib_tpu_torch import carry
from htslib_tpu_torch.parallel import distributed as td
from htslib_tpu_torch.parallel.launch import run_ranks
from htslib_tpu_torch.vcf import io as tio
from test_torch_vcf import (matrix_lines, matrix_vcf, uncompressed_bcf,
                            write_jax_bcf, write_port_bcf)

NS = [1, 2, 3, 5, 8]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{name: path}: the port's writer at level 0 (720 records, several
    members), the JAX writer's (native, level 0), the JAX Python writer's
    at zlib level 6 over 15 records (one deflated member), and an
    uncompressed BCF."""
    d = tmp_path_factory.mktemp("bcf_shards")
    mp = pytest.MonkeyPatch()
    return {
        "port": write_port_bcf(str(d / "port.bcf"), level=0,
                               groups=range(16), repeat=3),
        "jax_native": write_jax_bcf(str(d / "jax.bcf"), level=0,
                                    groups=range(16)),
        "deflated": write_jax_bcf(str(d / "deflated.bcf"), mp,
                                  groups=[0]),
        "uncompressed": uncompressed_bcf(str(d / "u.bcf"), groups=range(16)),
    }


def _same_plan(got, want):
    assert got.path == want.path
    for key in ("offs", "sizes"):
        g, w = getattr(got, key), getattr(want, key)
        assert g.dtype == np.int64 and np.array_equal(g, w), key
    assert got.shards == [td.BcfShard(int(s.index), int(s.rec_lo),
                                      int(s.rec_hi), int(s.ustart),
                                      int(s.uend)) for s in want.shards]


@pytest.mark.parametrize("name", ["port", "jax_native"])
@pytest.mark.parametrize("n", NS)
def test_plans_match_jax(files, name, n):
    path = files[name]
    plan = td.plan_bcf_shards(path, n, device="cpu")
    jplan = jd.plan_bcf_shards(path, n)
    _same_plan(plan, jplan)
    assert len(plan.shards) == min(n, len(plan.offs))
    assert sum(s.rec_hi - s.rec_lo for s in plan.shards) == len(plan.offs)
    # the member table the plan carries beside JAX's fields
    raw = open(path, "rb").read()
    bt = tbgzf.scan_blocks(raw)
    assert np.array_equal(plan.coffsets, bt.coffsets)
    assert np.array_equal(plan.usizes, bt.usizes)
    head = zlib.decompress(raw[18:], -15)[:9]
    assert plan.body == 9 + struct.unpack_from("<I", head, 5)[0]
    _same_plan(carry.from_jax_bcf_plan(jplan), jplan)


def test_plan_of_an_empty_body(tmp_path):
    path = str(tmp_path / "e.bcf")
    text, _ = matrix_vcf()
    with tio.BcfWriter(path, tio.BcfHeader(text)):
        pass
    for n in (1, 3):
        plan = td.plan_bcf_shards(path, n, device="cpu")
        _same_plan(plan, jd.plan_bcf_shards(path, n))
        assert plan.shards == [] and len(plan.offs) == 0
    assert tio.bcf_file_to_vcf(path, device="cpu")[1] == b""


def test_plan_of_one_record(tmp_path, monkeypatch):
    path = str(tmp_path / "one.bcf")
    text, body = matrix_vcf()
    h = tio.BcfHeader(text)
    with tio.BcfWriter(path, h, level=0) as w:
        w.write(tio.BcfRecord.from_vcf(body.splitlines()[0], h))
    for n in (1, 3):
        plan = td.plan_bcf_shards(path, n, device="cpu")
        jplan = jd.plan_bcf_shards(path, n)
        _same_plan(plan, jplan)
        assert len(plan.shards) == 1
        got = td.decode_bcf_shard_to_vcf(plan, plan.shards[0], device="cpu")
        assert got == jd.decode_bcf_shard_to_vcf(jplan, jplan.shards[0])
        monkeypatch.setattr("htslib_tpu.native.native", None)
        assert got == jd.decode_bcf_shard_to_vcf(jplan, jplan.shards[0])
        monkeypatch.undo()


@pytest.mark.parametrize("compressed", [True, False],
                         ids=["bgzf", "uncompressed"])
def test_trailing_bytes_raise(tmp_path, compressed):
    """Bytes after the last record: IOError with JAX's message on both
    sides."""
    text, body = matrix_vcf([0])
    h = JHeader(text)
    head = h.text(with_idx=True).encode() + b"\0"
    blob = bytearray(tio.BCF_MAGIC + struct.pack("<I", len(head)) + head)
    for line in body.splitlines():
        shared, indiv = JRecord.from_vcf(line, h).to_bcf()
        blob += struct.pack("<II", len(shared), len(indiv)) + shared + indiv
    blob += b"xyz"
    path = str(tmp_path / "t.bcf")
    if compressed:
        with tbgzf.BgzfWriter(path, level=0) as w:
            w.write(bytes(blob))
    else:
        open(path, "wb").write(blob)
    msg = "BCF body: trailing bytes after the last record"
    with pytest.raises(IOError, match=msg):
        jd.plan_bcf_shards(path, 2)
    with pytest.raises(IOError, match=msg):
        td.plan_bcf_shards(path, 2, device="cpu")


@pytest.mark.parametrize("jax_path", ["native", "python"])
@pytest.mark.parametrize("name", ["port", "jax_native"])
@pytest.mark.parametrize("n", NS)
def test_shard_decode_matches_jax(files, monkeypatch, name, n, jax_path):
    """Each shard's text, decoded by the port on the plan carried from
    JAX, is the JAX shard's; the shards in order are JAX's whole-file
    text."""
    path = files[name]
    jplan = jd.plan_bcf_shards(path, n)
    plan = carry.from_jax_bcf_plan(jplan)
    parts = [td.decode_bcf_shard_to_vcf(plan, sh, device="cpu")
             for sh in plan.shards]
    _, whole = jio.bcf_file_to_vcf(path)
    if jax_path == "python":
        monkeypatch.setattr("htslib_tpu.native.native", None)
    assert parts == [jd.decode_bcf_shard_to_vcf(jplan, sh)
                     for sh in jplan.shards]
    assert b"".join(parts) == bytes(whole)


@pytest.mark.parametrize("name", ["deflated", "uncompressed"])
def test_shard_decode_of_other_files(files, monkeypatch, name):
    """Deflated members (Huffman-coded, through the plain inflate) and a
    file without members (read as it is): plans and shard texts equal
    the JAX Python path's."""
    monkeypatch.setattr("htslib_tpu.native.native", None)
    path = files[name]
    plan = td.plan_bcf_shards(path, 2, device="cpu")
    jplan = jd.plan_bcf_shards(path, 2)
    _same_plan(plan, jplan)
    assert (len(plan.coffsets) == 0) == (name == "uncompressed")
    parts = [td.decode_bcf_shard_to_vcf(plan, sh, device="cpu")
             for sh in plan.shards]
    assert parts == [jd.decode_bcf_shard_to_vcf(jplan, sh)
                     for sh in jplan.shards]
    assert b"".join(parts) == bytes(jio.bcf_file_to_vcf(path)[1])


def test_shard_decode_timing_and_header(files):
    path = files["port"]
    plan = td.plan_bcf_shards(path, 3, device="cpu")
    header = tio.BcfReader(path).header
    timing = {}
    got = td.decode_bcf_shard_to_vcf(plan, plan.shards[1], header=header,
                                     device="cpu", timing=timing)
    assert got == td.decode_bcf_shard_to_vcf(plan, plan.shards[1],
                                             device="cpu")
    assert set(timing) == {"read_s", "inflate_s", "frame_s", "format_s"}
    assert all(v >= 0 for v in timing.values())
    assert got.count(b"\n") == plan.shards[1].rec_hi - plan.shards[1].rec_lo


def test_inflate_range_matches_zlib(files):
    """Ranges of the port file's uncompressed stream: within a member,
    across members, at member edges, empty, and the whole stream."""
    path = files["port"]
    raw = np.fromfile(path, np.uint8)
    co, cs, ustarts, us, total = tio.bcf_members(raw)
    assert len(co) > 3
    stream = tbgzf.inflate_host(raw, tbgzf.scan_blocks(raw))
    assert len(stream) == total
    edge = int(ustarts[2])
    rng = np.random.default_rng(4)
    cuts = [(0, total), (edge, edge + 10), (edge - 5, edge + 5),
            (int(ustarts[1]), int(ustarts[3])), (7, 7), (total - 3, total)]
    cuts += [tuple(sorted(rng.integers(0, total, 2).tolist()))
             for _ in range(4)]
    for u0, u1 in cuts:
        for src in (path, raw):
            assert tbgzf.inflate_range(src, co, cs, ustarts, us, u0, u1,
                                       "cpu") == stream[u0:u1]


def test_inflate_range_refuses_a_corrupt_member(files, tmp_path):
    raw = bytearray(open(files["port"], "rb").read())
    co, cs, ustarts, us, total = tio.bcf_members(np.frombuffer(raw,
                                                               np.uint8))
    at = int(co[1]) + int(cs[1]) - 20   # a payload byte of member 1
    raw[at] ^= 0xFF
    path = str(tmp_path / "bad.bcf")
    open(path, "wb").write(raw)
    with pytest.raises(IOError, match="CRC32"):
        tbgzf.inflate_range(path, co, cs, ustarts, us, 0, total, "cpu")
    # a range that avoids member 1 reads
    assert tbgzf.inflate_range(path, co, cs, ustarts, us, 0,
                               int(ustarts[1]), "cpu")


def test_two_gloo_ranks_decode_their_shards(files):
    path = files["port"]
    shards = run_ranks(torch_ranks.bcf_shard, 2, (path,), timeout=240)
    assert len(shards) == 2 and all(shards)
    assert b"".join(shards) == tio.bcf_file_to_vcf(path, device="cpu")[1]


def test_no_card_raises(files, monkeypatch):
    """device="cuda" without a card: every entry point raises, none
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = files["port"]
    plan = td.plan_bcf_shards(path, 2, device="cpu")
    for call in (lambda: td.plan_bcf_shards(path, 2),
                 lambda: td.decode_bcf_shard_to_vcf(plan, plan.shards[0]),
                 lambda: tio.bcf_file_to_vcf(path),
                 lambda: tbgzf.inflate_range(
                     path, plan.coffsets, plan.csizes, plan.ustarts,
                     plan.usizes, 0, 10)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_gzip_bcf_that_is_not_bgzf_raises(tmp_path):
    """A plain-gzip BCF has no member table: the device paths refuse it
    (the JAX Python path reads it through its stream; queue C)."""
    path = uncompressed_bcf(str(tmp_path / "u.bcf"), groups=[0])
    gz = str(tmp_path / "g.bcf")
    open(gz, "wb").write(gzip.compress(open(path, "rb").read()))
    with pytest.raises(IOError, match="not BGZF"):
        tio.bcf_file_to_vcf(gz, device="cpu")
    with pytest.raises(IOError, match="not BGZF"):
        td.plan_bcf_shards(gz, 2, device="cpu")
    with tio.BcfReader(gz) as r:        # the streaming reader reads it
        assert len(list(r)) == len(matrix_lines(0)[1])
