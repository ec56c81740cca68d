"""The port's BGZF block map and writer options (htslib_tpu_torch/bgzf.py:
`GziIndex`, `BgzfReader.useek` / `utell` / `load_index` / `check_eof`,
`BgzfWriter(compress=False)`, `flush_try`, `save_index`, `tell`,
`bgzf_open`) against the JAX package's (htslib_tpu/bgzf.py).

Files are seeded bytes.  Compressed bytes are compared with the JAX
writer on its pure-Python path (`htslib_tpu.native.native` None), where
both sides deflate with zlib.  The JAX writer queues up to 64 members
before it deflates them, and its `tell` counts the queued bytes into the
within-member offset; the port deflates each member as it fills, so its
`tell` is the reader's virtual offset (both values are shown by
`test_writer_tell_with_queued_members`, ROADMAP queue C).  The port's
reader keeps a member in its block cache once (`test_reader_cache_repair`:
the JAX reader raises KeyError).  Equality is exact."""
import io
import os

import numpy as np
import pytest

from htslib_tpu import bgzf as jbgzf
from htslib_tpu_torch import bgzf as tbgzf


@pytest.fixture
def pure(monkeypatch):
    monkeypatch.setattr("htslib_tpu.native.native", None)
    monkeypatch.setattr("htslib_tpu_torch.native.native", None)


def chunks(seed, n=24, hi=50_000):
    """Seeded chunks of text-like bytes (repetitive enough to deflate)."""
    rng = np.random.default_rng(seed)
    return [bytes(rng.choice(np.frombuffer(b"ACGT\n\t01", np.uint8),
                             int(k))) for k in rng.integers(1, hi, n)]


def write_both(tmp_path, parts, level=-1, flush_every=0):
    """The same parts through each writer; returns the two paths."""
    paths = []
    for mod, cls, name in ((tbgzf, "BgzfWriter", "t.gz"),
                           (jbgzf, "BGZFWriter", "j.gz")):
        path = str(tmp_path / name)
        w = getattr(mod, cls)(path, level=level)
        for i, c in enumerate(parts):
            w.write(c)
            if flush_every and i % flush_every == 0:
                w.flush()
        w.close()
        w.save_index()
        paths.append(path)
    return paths


@pytest.mark.parametrize("level,flush_every", [(-1, 0), (1, 3), (0, 5)])
def test_writer_file_and_gzi_match_jax(tmp_path, pure, level, flush_every):
    t, j = write_both(tmp_path, chunks(level + 10), level, flush_every)
    for suffix in ("", ".gzi"):
        with open(t + suffix, "rb") as a, open(j + suffix, "rb") as b:
            assert a.read() == b.read(), suffix
    ti, ji = tbgzf.GziIndex.load(t + ".gzi"), jbgzf.GziIndex.load(j + ".gzi")
    assert np.array_equal(ti.coffsets, ji.coffsets)
    assert np.array_equal(ti.uoffsets, ji.uoffsets)
    raw = np.fromfile(t, np.uint8)
    tt, jt = tbgzf.scan_blocks(raw), jbgzf.scan_blocks(raw)
    assert np.array_equal(tt.uoffsets, jt.uoffsets)
    assert tt.total_usize == jt.total_usize
    # the block map of the scan is the written .gzi, its EOF member aside
    ft = tbgzf.GziIndex.from_table(tt)
    assert np.array_equal(ft.coffsets[:-1], ti.coffsets)
    rng = np.random.default_rng(level + 20)
    for u in rng.integers(0, tt.total_usize + 10, 50).tolist():
        assert ti.query(u) == ji.query(u)


@pytest.mark.parametrize("gzi", [True, False])
def test_useek_utell_match_jax(tmp_path, pure, gzi):
    parts = chunks(31)
    t, _ = write_both(tmp_path, parts)
    data = b"".join(parts)
    if not gzi:
        os.remove(t + ".gzi")
    rng = np.random.default_rng(32)
    # the JAX reader without its block cache (test_reader_cache_repair)
    tr, jr = tbgzf.BgzfReader(t), jbgzf.BGZFReader(t, cache_blocks=0)
    for r, mod in ((tr, tbgzf), (jr, jbgzf)):
        if gzi:
            r.load_index()
        else:
            r.idx = mod.GziIndex.from_table(mod.scan_blocks(
                np.fromfile(t, np.uint8)))
    for u in rng.integers(0, len(data), 60).tolist():
        n = int(rng.integers(1, 100_000))
        got = []
        for r in (tr, jr):
            r.useek(u)
            got.append((r.utell(), r.read(n), r.utell(), r.tell(),
                        r.readline(), r.utell()))
        assert got[0] == got[1]
        assert got[0][1] == data[u:u + n]
    tr.close()
    jr.close()


def test_useek_needs_an_index_and_plain_files_seek(tmp_path):
    t = str(tmp_path / "plain.txt")
    data = b"".join(chunks(33, n=4))
    with open(t, "wb") as fp:
        fp.write(data)
    with tbgzf.BgzfReader(t) as r, jbgzf.BGZFReader(t) as j:
        for u in (0, 7, len(data) // 2):
            r.useek(u)
            j.useek(u)
            assert r.read(50) == j.read(50) == data[u:u + 50]
            assert r.utell() == j.utell()
    gz = str(tmp_path / "x.gz")
    with tbgzf.BgzfWriter(gz) as w:
        w.write(data)
    for reader in (tbgzf.BgzfReader, jbgzf.BGZFReader):
        with reader(gz) as r, pytest.raises(IOError, match="gzi"):
            r.useek(5)


def test_check_eof_matches_jax(tmp_path):
    data = b"".join(chunks(34, n=3))
    paths = {}
    for name, eof in (("eof", True), ("noeof", False)):
        paths[name] = str(tmp_path / f"{name}.gz")
        w = tbgzf.BgzfWriter(paths[name])
        w.write(data)
        w.close(write_eof=eof)
    paths["plain"] = str(tmp_path / "plain.txt")
    with open(paths["plain"], "wb") as fp:
        fp.write(data)
    paths["tiny"] = str(tmp_path / "tiny.gz")
    with open(paths["tiny"], "wb") as fp:
        fp.write(tbgzf.compress_block(b"")[:20])
    want = {"eof": 1, "noeof": 0, "plain": 3}
    for name, path in paths.items():
        with tbgzf.BgzfReader(path) as r, jbgzf.BGZFReader(path) as j:
            got = r.check_eof()
            assert got == j.check_eof()
            assert got == want.get(name, 0)
            if name != "tiny":
                # the reader's place is kept
                assert r.read(10) == j.read(10) == data[:10]


def test_uncompressed_writer_matches_jax(tmp_path):
    parts = chunks(35, n=6)
    outs = []
    for mod, cls in ((tbgzf, "BgzfWriter"), (jbgzf, "BGZFWriter")):
        buf = io.BytesIO()
        buf.close = lambda: None
        w = getattr(mod, cls)(buf, compress=False)
        tells = []
        for c in parts:
            w.write(c)
            tells.append(w.tell())
        w.close()
        outs.append((buf.getvalue(), tells))
    assert outs[0] == outs[1]
    assert outs[0][0] == b"".join(parts)
    # bgzf_open's modes
    for mode, compress, level in (("w", True, -1), ("wu", False, -1),
                                  ("w1", True, 1), ("w0", True, 0)):
        p = str(tmp_path / f"o{mode}")
        w = tbgzf.bgzf_open(p, mode)
        j = jbgzf.bgzf_open(p + "j", mode)
        assert (w.compress, w.level) == (j.compress, j.level) == (compress,
                                                                  level)
        w.close()
        j.close()
    with tbgzf.bgzf_open(str(tmp_path / "ow"), "r") as r:
        assert isinstance(r, tbgzf.BgzfReader) and r.is_bgzf


def test_flush_try_and_tell_match_jax(tmp_path, pure):
    """Records of seeded sizes written whole into members by flush_try;
    the JAX writer is drained after each write, so both tells are the
    virtual offset of the next record."""
    rng = np.random.default_rng(36)
    recs = [bytes(rng.integers(0, 4, int(n), dtype=np.uint8))
            for n in rng.integers(1, 9_000, 60)]
    paths, tells = [], []
    for mod, cls in ((tbgzf, "BgzfWriter"), (jbgzf, "BGZFWriter")):
        path = str(tmp_path / cls)
        w = getattr(mod, cls)(path, level=1)
        seen = []
        for r in recs:
            w.flush_try(len(r))
            seen.append(w.tell())
            w.write(r)
            if mod is jbgzf:
                w._drain()
        w.close()
        w.save_index()
        paths.append(path)
        tells.append(seen)
    assert tells[0] == tells[1]
    for suffix in ("", ".gzi"):
        with open(paths[0] + suffix, "rb") as a, \
                open(paths[1] + suffix, "rb") as b:
            assert a.read() == b.read()
    # every record starts where the reader finds it, none split
    with tbgzf.BgzfReader(paths[0]) as r:
        for voff, rec in zip(tells[0], recs):
            r.seek(voff)
            assert r.read(len(rec)) == rec
            assert (voff & 0xFFFF) + len(rec) <= tbgzf.BGZF_BLOCK_SIZE


def test_writer_tell_with_queued_members(tmp_path):
    """Queue C: with members queued (three full members, then 100
    bytes), the JAX writer's `tell` gives the compressed offset of the
    last member written (0) and a within-member offset past 0xFFFF, which
    spills into the compressed offset's bits; the port deflates each
    member when it fills, and its `tell` is the reader's virtual offset
    of the next byte."""
    data = bytes(np.random.default_rng(37).integers(
        0, 4, 3 * tbgzf.BGZF_BLOCK_SIZE + 100, dtype=np.uint8))
    t = tbgzf.BgzfWriter(str(tmp_path / "t.gz"))
    j = jbgzf.BGZFWriter(str(tmp_path / "j.gz"))
    t.write(data)
    j.write(data)
    jt, tt = j.tell(), t.tell()
    assert jt == 3 * tbgzf.BGZF_BLOCK_SIZE + 100      # (0 << 16) | 195,940
    assert jt & 0xFFFF != 100 and jt >> 16 == 2
    t.write(b"x")
    t.close()
    j.close()
    with tbgzf.BgzfReader(str(tmp_path / "t.gz")) as r:
        r.seek(tt)
        assert r.read(1) == b"x"
    assert tt & 0xFFFF == 100 and tt >> 16 == t._idx_co[3]


def test_writer_save_index_with_queued_members(tmp_path, pure):
    """Queue C: `save_index` before the members are flushed writes the
    members deflated so far; the JAX writer has deflated none of its
    queued members, so its .gzi lacks them, where the port's has every
    full member.  After close the two files are the same."""
    parts = chunks(39, n=8)
    out = []
    for mod, cls in ((tbgzf, "BgzfWriter"), (jbgzf, "BGZFWriter")):
        path = str(tmp_path / cls)
        w = getattr(mod, cls)(path)
        for c in parts:
            w.write(c)
        w.save_index(path + ".early.gzi")
        w.close()
        w.save_index()
        out.append([mod.GziIndex.load(path + s) for s in (".early.gzi",
                                                           ".gzi")])
    (t_early, t_late), (j_early, j_late) = out
    assert len(j_early.coffsets) == 1                 # only (0, 0)
    full = sum(map(len, parts)) // tbgzf.BGZF_BLOCK_SIZE
    assert len(t_early.coffsets) == full
    assert np.array_equal(t_late.coffsets, j_late.coffsets)
    assert np.array_equal(t_early.coffsets, t_late.coffsets[:full])


def test_reader_cache_repair(tmp_path):
    """The repair: a member that the reader's block cache holds, read
    again in sequence, was queued a second time, and its eviction then
    raised KeyError.  The JAX reader (the same code) still raises on
    this seeded pattern; the port returns the file's bytes."""
    data = bytes(np.random.default_rng(1).integers(0, 4, 30 * 65280,
                                                   dtype=np.uint8))
    path = str(tmp_path / "c.gz")
    with tbgzf.BgzfWriter(path) as w:
        w.write(data)
    table = tbgzf.scan_blocks(np.fromfile(path, np.uint8))

    def walk(r, idx):
        r.idx = idx
        rng = np.random.default_rng(1)
        for _ in range(40):
            u = int(rng.integers(0, len(data)))
            r.useek(u)
            n = int(rng.integers(1, 300_000))
            assert r.read(n) == data[u:u + n]

    with tbgzf.BgzfReader(path) as r:
        walk(r, tbgzf.GziIndex.from_table(table))
    with jbgzf.BGZFReader(path) as j, pytest.raises(KeyError):
        walk(j, jbgzf.GziIndex(table.coffsets, table.uoffsets))


def test_read_all_sets_the_block_map(tmp_path, pure):
    t, _ = write_both(tmp_path, chunks(38, n=6))
    with tbgzf.BgzfReader(t) as r, jbgzf.BGZFReader(t) as j:
        assert r.read(1000) == j.read(1000)
        a, b = r.read_all(), j.read_all()
        assert np.array_equal(a, b)
        assert np.array_equal(r.idx.coffsets, j.idx.coffsets)
        assert np.array_equal(r.idx.uoffsets, j.idx.uoffsets)
