"""The port's reference cache server (htslib_tpu_torch/refcache.py) against
the JAX package's (htslib_tpu/refcache.py): both servers of each package,
threaded and event-driven, answer the same requests with the same status,
headers, body and cache files: GET, HEAD, Range, keep-alive requests on
one connection, 404 for a missing or malformed M5, a sequence whose
content does not match its M5, and a burst of misses that the upstream
sees once.  Upstreams are second local servers (never the default EBI
registry), every socket has a timeout, and a CRAM decodes through the
port's server by REF_PATH.  `python -m htslib_tpu_torch.refcache` serves
from a process of its own."""
import hashlib
import http.client
import os
import subprocess
import sys
import threading

import pytest

from htslib_tpu import refcache as jrc
from htslib_tpu_torch import refcache as trc
from htslib_tpu_torch.cram import CramReader
from htslib_tpu_torch.cram import batch as tbatch
from test_torch_cram import cram_records, write_bam, write_fasta

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 20
SEQ = b"ACGTTGCA" * 2500 + b"NNACG"
KINDS = ("RefCacheServer", "AsyncRefCacheServer")


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.delenv("REF_PATH", raising=False)
    monkeypatch.delenv("REF_CACHE", raising=False)


def _start(mod, kind, cache, upstream=None, **kw):
    srv = getattr(mod, kind)(cache, upstream=upstream, **kw)
    srv.start()
    return srv


def _stop(srv):
    srv.stop()
    if srv._thread is not None:
        srv._thread.join(timeout=TIMEOUT)


def _requests(port, reqs):
    """The answers to `reqs` ((method, path, headers)) sent in turn on
    one connection, reopened where the server closed it: (status,
    Content-Length, Content-Range, Accept-Ranges, body) each."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    out = []
    try:
        for method, path, hdrs in reqs:
            conn.request(method, path, headers=hdrs)
            r = conn.getresponse()
            body = r.read()
            out.append((r.status, r.getheader("Content-Length"),
                        r.getheader("Content-Range"),
                        r.getheader("Accept-Ranges"), body))
    finally:
        conn.close()
    return out


def _both(tmp_path, kind, reqs, seqs=(SEQ,), **kw):
    """The same requests to the JAX and the port server of `kind`, each
    over its own cache holding `seqs`: (answers, cache files) each."""
    res = []
    for name, mod in (("jax", jrc), ("port", trc)):
        cache = str(tmp_path / name)
        srv = _start(mod, kind, cache, **kw)
        try:
            for s in seqs:
                srv.put(s)
            answers = _requests(srv.port, reqs)
        finally:
            _stop(srv)
        files = {f: open(os.path.join(cache, f), "rb").read()
                 for f in sorted(os.listdir(cache))}
        res.append((answers, files))
    return res


@pytest.mark.parametrize("kind", KINDS)
def test_servers_answer_alike(tmp_path, kind):
    md5 = hashlib.md5(SEQ).hexdigest()
    reqs = [("GET", f"/{md5}", {}),
            ("HEAD", f"/{md5}", {}),
            ("GET", f"/{md5}", {"Range": "bytes=4-11"}),
            ("GET", f"/refs/{md5.upper()}", {"Range": "bytes=19990-"}),
            ("GET", f"/{md5}", {"Range": "bytes=-5"}),
            ("GET", f"/{md5}", {"Range": f"bytes={len(SEQ) + 3}-"}),
            ("GET", "/" + "0" * 32, {}),
            ("GET", "/not-an-md5", {}),
            ("GET", f"/{md5}", {"Connection": "close"})]
    (jax_answers, jax_files), (ours, our_files) = _both(tmp_path, kind, reqs)
    assert ours == jax_answers
    assert our_files == jax_files == {md5: SEQ}
    assert [a[0] for a in ours] == [200, 200, 206, 206, 206, 416, 404, 404,
                                    200]
    assert ours[0][4] == SEQ and ours[1][4] == b""
    assert ours[2][4] == SEQ[4:12] and ours[3][4] == SEQ[19990:]


def test_event_server_keeps_the_connection(tmp_path):
    """HTTP/1.1 keep-alive: every request of the burst on one socket."""
    md5 = hashlib.md5(SEQ).hexdigest()
    for mod in (jrc, trc):
        srv = _start(mod, "AsyncRefCacheServer", str(tmp_path / mod.__name__))
        try:
            srv.put(SEQ)
            conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                              timeout=TIMEOUT)
            conn.connect()
            sock = conn.sock
            for i in range(5):
                conn.request("GET", f"/{md5}",
                             headers={"Range": f"bytes={i}-{i + 9}"})
                r = conn.getresponse()
                assert (r.status, r.read()) == (206, SEQ[i:i + 10])
                assert conn.sock is sock
            conn.close()
        finally:
            _stop(srv)


@pytest.mark.parametrize("kind", KINDS)
def test_coalesced_misses_and_bad_m5(tmp_path, kind):
    """A front server whose upstream is a second local one: 8 concurrent
    misses for one M5 make one upstream fetch and a cache file named by
    its content's MD5; a sequence stored upstream under another MD5 is
    refused (404, nothing cached)."""
    other = b"TTAGGC" * 400
    wrong = "f" * 32
    results = {}
    for name, mod in (("jax", jrc), ("port", trc)):
        up = _start(trc, "RefCacheServer", str(tmp_path / name / "up"))
        md5 = up.put(SEQ)
        with open(os.path.join(up.cache_dir, wrong), "wb") as fp:
            fp.write(other)
        front = _start(mod, kind, str(tmp_path / name / "front"),
                       upstream=up.url_template)
        try:
            got = [None] * 8

            def fetch(i):
                got[i] = _requests(front.port, [("GET", f"/{md5}", {})])[0]

            threads = [threading.Thread(target=fetch, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=TIMEOUT)
            assert not any(t.is_alive() for t in threads)
            fetches = front.upstream_fetches
            bad = _requests(front.port, [("GET", f"/{wrong}", {})])[0][0]
            files = {f: hashlib.md5(open(os.path.join(front.cache_dir, f),
                                         "rb").read()).hexdigest()
                     for f in os.listdir(front.cache_dir)}
        finally:
            _stop(front)
            _stop(up)
        assert all(g[0] == 200 and g[4] == SEQ for g in got)
        results[name] = (fetches, bad, files, front.upstream_fetches)
    assert results["port"] == results["jax"]
    assert results["port"][:3] == (1, 404, {md5: md5})


def test_access_log_rotates_alike(tmp_path):
    """The size-rotated access log: each answer a line, the log moved to
    .1 once it reaches its size, in both packages (times aside)."""
    md5 = hashlib.md5(SEQ).hexdigest()
    logs = []
    for mod in (jrc, trc):
        log = str(tmp_path / f"{mod.__name__}.log")
        srv = _start(mod, "RefCacheServer", str(tmp_path / mod.__name__),
                     log_path=log, log_rotate_bytes=100)
        try:
            srv.put(SEQ)
            _requests(srv.port, [("GET", f"/{md5}", {}),
                                 ("GET", "/x", {}),
                                 ("GET", "/" + "1" * 32, {}),
                                 ("GET", f"/{md5}", {})])
        finally:
            _stop(srv)
        logs.append([[ln.split(" ", 1)[1] for ln in open(p).read()
                      .splitlines()] for p in (log + ".1", log)])
    assert logs[0] == logs[1]
    assert sum(len(part) for part in logs[1]) == 4


def test_cram_decodes_through_the_ports_server(tmp_path, monkeypatch):
    """A CRAM whose FASTA is gone decodes by REF_PATH through the port's
    event server, which fetches each sequence from a threaded upstream
    once and caches it under its M5."""
    fa = str(tmp_path / "ref.fa")
    seqs = write_fasta(fa, 31)
    hdr, recs = cram_records(150, 33, seqs)
    bam = write_bam(str(tmp_path / "in.bam"), hdr, recs)
    path = str(tmp_path / "r.cram")
    tbatch.bam_to_cram_file(bam, path, ref=fa, seqs_per_slice=100)
    with CramReader(path, ref=fa) as r:
        truth = [rec.to_bam_buffer() for rec in r]
    os.remove(fa)
    os.remove(fa + ".fai")
    up = _start(trc, "RefCacheServer", str(tmp_path / "up"))
    front = _start(trc, "AsyncRefCacheServer", str(tmp_path / "front"),
                   upstream=up.url_template)
    try:
        for s in seqs.values():
            up.put(s.encode())
        monkeypatch.setenv("REF_PATH", front.url_template)
        with CramReader(path) as r:
            assert [rec.to_bam_buffer() for rec in r] == truth
        assert front.upstream_fetches == len(seqs)
        for f in os.listdir(front.cache_dir):
            data = open(os.path.join(front.cache_dir, f), "rb").read()
            assert hashlib.md5(data).hexdigest() == f
    finally:
        _stop(front)
        _stop(up)


@pytest.mark.parametrize("threaded", [False, True])
def test_module_serves_from_its_own_process(tmp_path, threaded):
    """`python -m htslib_tpu_torch.refcache -d DIR -p 0 --no-upstream`
    reports its port on standard error and serves the cache."""
    cache = tmp_path / "c"
    cache.mkdir()
    md5 = hashlib.md5(SEQ).hexdigest()
    (cache / md5).write_bytes(SEQ)
    cmd = [sys.executable, "-m", "htslib_tpu_torch.refcache", "-d",
           str(cache), "-p", "0", "--no-upstream"] + (
               ["--threaded"] if threaded else [])
    proc = subprocess.Popen(cmd, cwd=REPO, stderr=subprocess.PIPE,
                            stdout=subprocess.DEVNULL,
                            env={**os.environ, "PYTHONPATH": REPO})
    try:
        line = []
        reader = threading.Thread(
            target=lambda: line.append(proc.stderr.readline()))
        reader.start()
        reader.join(timeout=60)
        assert line and b"on port" in line[0], line
        port = int(line[0].split(b"on port ")[1].split(b",")[0])
        got = _requests(port, [("GET", f"/{md5}", {})])[0]
        assert (got[0], got[4]) == (200, SEQ)
    finally:
        proc.kill()
        proc.wait(timeout=TIMEOUT)
