"""The port's multi-process layer against the JAX package's
(htslib_tpu/parallel/distributed.py, htslib_tpu/bgzf.py,
htslib_tpu/sam/bam.py): `initialize`, the host BGZF writer and
`scan_blocks`, the BAM container both ways, BAM shard plans and each
shard's decode and flagstat at n = 1, 3 and 4, and the port's
`dryrun_multichip` (htslib_tpu_torch/entry.py) with each of its gates
shown to raise.  The JAX side reads with its native library; the port's
inflate and record scan run their plain versions on the CPU, so the
files here are mostly stored BGZF (level 0), whose members the plain
inflate decodes in a few steps.  Outputs are bytes and integers:
equality is exact."""
import io
import os
import socket
import struct
import sys
import zlib

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_ranks
from htslib_tpu import bgzf as jbgzf
from htslib_tpu.parallel import distributed as jd
from htslib_tpu.sam.bam import BamReader as JReader
from htslib_tpu.sam.bam import BamWriter as JWriter
from htslib_tpu.sam.header import SamHeader as JHeader
from htslib_tpu.sam.record import BamRecord as JRecord
from htslib_tpu_torch import bgzf as tbgzf
from htslib_tpu_torch import carry
from htslib_tpu_torch.entry import dryrun_multichip, dryrun_records
from htslib_tpu_torch.parallel import distributed as td
from htslib_tpu_torch.parallel import mesh as tm
from htslib_tpu_torch.parallel.launch import run_ranks
from htslib_tpu_torch.sam.bam import (BamReader, BamWriter, read_header,
                                      write_bam_header)

HDR, RECS = dryrun_records(1000, seed=21)


@pytest.fixture(autouse=True, scope="module")
def _jax_32bit():
    """The JAX package runs in its default 32-bit mode; another test
    module in the same worker process may have switched JAX to 64-bit."""
    before = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", before)


def _port_bam(path, recs=RECS, level=0):
    with BamWriter(path, HDR, level=level) as w:
        for r in recs:
            w.write(r)
    return path


def _jax_bam(path, recs=RECS):
    jh = JHeader(HDR.text)
    with JWriter(path, jh) as w:
        for r in recs:
            w.write(JRecord.from_bam_buffer(r.to_bam_buffer()))
    return path


def _small_members_bam(path, size=3000):
    """The port's BAM stream cut into `size`-byte members deflated at
    zlib level 6: Huffman-coded members short enough for the plain
    inflate."""
    buf = io.BytesIO()
    write_bam_header(buf, HDR)
    for r in RECS:
        body = r.to_bam_buffer()
        buf.write(struct.pack("<I", len(body)) + body)
    stream = buf.getvalue()
    with open(path, "wb") as fp:
        for i in range(0, len(stream), size):
            piece = stream[i:i + size]
            co = zlib.compressobj(6, zlib.DEFLATED, -15)
            fp.write(tbgzf.bgzf_member(co.compress(piece) + co.flush(),
                                       piece))
        fp.write(tbgzf.BGZF_EOF)
    return path


def _same_plan(got, want):
    assert got.path == want.path
    for key, dtype in (("coffsets", np.uint64), ("csizes", np.uint32),
                       ("ustarts", np.uint64), ("usizes", np.uint32)):
        g, w = getattr(got, key), getattr(want, key)
        assert g.dtype == dtype and np.array_equal(g, w), key
    assert got.shards == want.shards


def _flag_loop(recs):
    """The counting loop of tests/test_distributed.py's flagstat test."""
    want = np.zeros(11, np.int64)
    for rec in recs:
        f = rec.flag
        want += [1, bool(f & 0x100), bool(f & 0x800), bool(f & 0x400),
                 not (f & 4), bool(f & 1), bool(f & 0x40), bool(f & 0x80),
                 bool(f & 2), bool(f & 1) and not (f & 4) and not (f & 8),
                 bool(f & 1) and not (f & 4) and bool(f & 8)]
    return want


def test_initialize_is_a_noop_without_a_coordinator(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    before = dist.is_initialized()
    assert td.initialize() is None
    assert dist.is_initialized() == before
    with pytest.raises(ValueError):
        td.initialize("127.0.0.1:1")


def test_initialize_world_of_two_over_tcp():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    timing = {}
    got = run_ranks(torch_ranks.world_sum, 2, timeout=120,
                    coordinator=f"127.0.0.1:{port}", timing=timing)
    assert got == [(0, 2, 3), (1, 2, 3)]
    assert set(timing) == {"start_s", "load_s", "join_s", "run_s", "wall_s"}
    assert all(len(timing[k]) == 2
               for k in ("start_s", "load_s", "join_s", "run_s"))
    assert 0 < max(timing["start_s"]) < timing["wall_s"]


def test_run_ranks_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        run_ranks(torch_ranks.fail_on_rank_one, 2, timeout=120)


def test_bgzf_members_and_scan_match_jax(tmp_path):
    assert tbgzf.BGZF_EOF == jbgzf.BGZF_EOF
    data = bytes(range(256)) * 200
    for level in (-1, 0, 1, 9):
        member = tbgzf.compress_block(data, level)
        assert jbgzf.decompress_block(member) == data
    pbam = _port_bam(str(tmp_path / "p.bam"), level=-1)
    jbam = _jax_bam(str(tmp_path / "j.bam"))
    for path in (pbam, jbam, _small_members_bam(str(tmp_path / "s.bam"))):
        raw = np.fromfile(path, np.uint8)
        got, want = tbgzf.scan_blocks(raw), jbgzf.scan_blocks(raw)
        for key in ("coffsets", "csizes", "usizes"):
            assert np.array_equal(getattr(got, key), getattr(want, key))
    raw = np.fromfile(pbam, np.uint8)
    with pytest.raises(IOError):
        tbgzf.scan_blocks(raw[:-5])


def test_bam_container_both_ways(tmp_path):
    pbam = _port_bam(str(tmp_path / "p.bam"), level=-1)
    with JReader(pbam) as r:
        assert r.header.ref_names == HDR.ref_names
        assert r.header.ref_lens == HDR.ref_lens
        got = [rec.to_bam_buffer() for rec in r]
    assert got == [rec.to_bam_buffer() for rec in RECS]
    jbam = _jax_bam(str(tmp_path / "j.bam"))
    with JReader(jbam) as r:
        jdata, joffs, jsizes = r.raw_records()
    for path in (pbam, jbam):
        assert read_header(path).ref_names == HDR.ref_names
        with BamReader(path) as r:
            assert (r.header.ref_names, r.header.ref_lens, r.header.text) \
                == (HDR.ref_names, HDR.ref_lens, HDR.text)
            data, offs, sizes = r.raw_records()
        assert data.tobytes() == np.asarray(jdata).tobytes()
        assert offs.dtype == np.uint64 and sizes.dtype == np.uint32
        assert np.array_equal(offs, joffs) and np.array_equal(sizes, jsizes)


@pytest.mark.parametrize("n", (1, 3, 4))
def test_plans_decode_and_flagstat_match_jax(tmp_path, n):
    bam = _port_bam(str(tmp_path / "p.bam"))
    want = jd.plan_bam_shards(bam, n)
    plan = td.plan_bam_shards(bam, n)
    _same_plan(plan, carry.from_jax_bam_shard_plan(want))
    assert len(plan.shards) == n and plan.shards[0].ustart > 0
    total = np.zeros(11, np.int64)
    for sh, jsh in zip(plan.shards, want.shards):
        assert (td.decode_shard_to_sam(plan, sh, device="cpu")
                == jd.decode_shard_to_sam(want, jsh))
        got = td.flagstat_shard(plan, sh, device="cpu")
        assert got.dtype == np.int64
        assert np.array_equal(got, jd.flagstat_shard(want, jsh))
        total += got
    fs = td.distributed_flagstat(bam, n, device="cpu")
    assert np.array_equal(fs, jd.distributed_flagstat(bam, n))
    assert np.array_equal(fs, total) and np.array_equal(fs, _flag_loop(RECS))


@pytest.mark.parametrize("n", (1, 3, 4))
def test_plans_match_jax_on_the_jax_writers_file(tmp_path, n):
    """The JAX BamWriter's members (libdeflate, the header inside the
    first): the port's plan is the JAX plan."""
    bam = _jax_bam(str(tmp_path / "j.bam"))
    _same_plan(td.plan_bam_shards(bam, n),
               carry.from_jax_bam_shard_plan(jd.plan_bam_shards(bam, n)))


def test_decode_shards_of_huffman_members_match_jax(tmp_path):
    bam = _small_members_bam(str(tmp_path / "s.bam"))
    want = jd.plan_bam_shards(bam, 3)
    plan = td.plan_bam_shards(bam, 3)
    _same_plan(plan, carry.from_jax_bam_shard_plan(want))
    assert plan.coffsets.size > 10
    parts = [td.decode_shard_to_sam(plan, sh, device="cpu")
             for sh in plan.shards]
    assert parts == [jd.decode_shard_to_sam(want, s) for s in want.shards]


def test_plans_with_more_shards_than_records(tmp_path):
    bam = _port_bam(str(tmp_path / "t.bam"), RECS[:3])
    want = jd.plan_bam_shards(bam, 4)
    plan = td.plan_bam_shards(bam, 4)
    _same_plan(plan, carry.from_jax_bam_shard_plan(want))
    assert len(plan.shards) == 3
    assert np.array_equal(td.distributed_flagstat(bam, 4, device="cpu"),
                          jd.distributed_flagstat(bam, 4))


def test_shard_decode_refuses_a_corrupt_member(tmp_path):
    bam = _port_bam(str(tmp_path / "p.bam"))
    plan = td.plan_bam_shards(bam, 2)
    raw = bytearray(open(bam, "rb").read())
    at = int(plan.coffsets[0]) + int(plan.csizes[0]) - 8
    raw[at] ^= 0xFF                       # the first member's CRC32
    open(bam, "wb").write(bytes(raw))
    # the header read refuses the member first: the native inflate on its
    # route, zlib's CRC check with the port's native library off
    with pytest.raises(IOError, match="BGZF inflate failed on block 0"):
        for sh in plan.shards:
            td.decode_shard_to_sam(plan, sh, device="cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr("htslib_tpu_torch.native.native", None)
    try:
        with pytest.raises(IOError, match="CRC32"):
            for sh in plan.shards:
                td.decode_shard_to_sam(plan, sh, device="cpu")
    finally:
        mp.undo()


def test_dryrun_multichip_world_of_one():
    dryrun_multichip(1, device="cpu")


def test_dryrun_multichip_two_ranks():
    assert run_ranks(torch_ranks.dryrun, 2, timeout=240) == [0, 1]


def _break_decode(monkeypatch):
    real = td.decode_shard_to_sam
    monkeypatch.setattr(td, "decode_shard_to_sam",
                        lambda *a, **k: real(*a, **k)[:-1])


def _break_flagstat(monkeypatch):
    real = td.distributed_flagstat
    monkeypatch.setattr(td, "distributed_flagstat",
                        lambda *a, **k: real(*a, **k) + (np.arange(11) == 4))


def _break_step(monkeypatch, name, fix):
    real = getattr(tm, name)

    def make(*a, **k):
        step = real(*a, **k)
        return lambda *x: fix(step(*x))
    monkeypatch.setattr(tm, name, make)


@pytest.mark.parametrize("gate,brk,message", [
    ("decode", _break_decode, "sharded decode != single-host output"),
    ("flagstat", _break_flagstat, "mesh flagstat != shard flagstat"),
    ("pileup", lambda m: _break_step(
        m, "make_decode_pileup_step",
        lambda out: (out[0] + (torch.arange(len(out[0])) == 7),) + out[1:]),
     "mesh pileup != brute force"),
    ("halo", lambda m: _break_step(
        m, "make_coord_sharded_pileup", lambda own: own * 2),
     "halo-exchange pileup != brute force")])
def test_dryrun_gates_raise(monkeypatch, gate, brk, message):
    brk(monkeypatch)
    with pytest.raises(AssertionError, match=message):
        dryrun_multichip(1, device="cpu")


def test_build_loads_once_across_processes(tmp_path, monkeypatch):
    """Four rank processes compiling the same source at once: nvcc runs
    once, and every process gets the one library."""
    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    calls = tmp_path / "calls"
    nvcc = cuda / "bin" / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        f"open({str(calls)!r}, 'a').write('x')\n"
        "time.sleep(1)\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('lib')\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(cuda))
    build = str(tmp_path / "build")
    libs = run_ranks(torch_ranks.compile_once, 4, (build,), timeout=120)
    assert len(set(libs)) == 1 and open(libs[0]).read() == "lib"
    assert calls.read_text() == "x"
    assert [f for f in os.listdir(build) if f.endswith(".tmp")] == []
