"""The port's remote streams (htslib_tpu_torch/remote) against the JAX
package's (htslib_tpu/remote): HTTP Range reads, seeks, peeks and sizes
from a server on 127.0.0.1 (chip_smoke.RangeServer), auth callbacks and
header injection, FTP REST seeks against a small FTP server on
127.0.0.1, the S3 V2 and V4 signatures at fixed dates (with AWS's
published examples), credential discovery and refresh, the GCS rewrite,
and htsget tickets of http parts with Range headers and inline `data:`
parts.  Both servers bind port 0 on 127.0.0.1 and stop in their
fixture's teardown; every request has a timeout.  Outputs are compared
byte for byte."""
import base64
import json
import os
import socket
import threading
import time

import numpy as np
import pytest

import htslib_tpu.hfile as jhf
import htslib_tpu.remote as jremote
import htslib_tpu.remote.gcs as jgcs
import htslib_tpu.remote.multipart as jmp
import htslib_tpu.remote.s3 as js3
from chip_smoke import RangeServer, htsget_ticket
from htslib_tpu_torch import hfile as thf
from htslib_tpu_torch import remote as tremote
from htslib_tpu_torch.bgzf import BgzfReader, BgzfWriter
from htslib_tpu_torch.remote import gcs as tgcs
from htslib_tpu_torch.remote import multipart as tmp_
from htslib_tpu_torch.remote import s3 as ts3

DATA = np.random.default_rng(7).integers(0, 256, 300_000,
                                         dtype=np.uint8).tobytes()


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    root = tmp_path_factory.mktemp("www")
    (root / "data.bin").write_bytes(DATA)
    lines = b"".join(b"line %d %s\n" % (i, b"x" * (i % 50))
                     for i in range(3000))
    (root / "lines.txt").write_bytes(lines)
    with RangeServer(str(root)) as srv:
        srv.lines = lines
        yield srv


def _ops(f):
    """A fixed walk of reads, peeks and seeks; what each returned."""
    out = [f.read(10), f.peek(20), f.read(5), f.tell()]
    f.seek(100_000)
    out += [f.read(1000), f.tell()]
    f.seek(50, os.SEEK_CUR)
    out += [f.read(7)]
    f.seek(-100, os.SEEK_END)
    out += [f.read(1000), f.at_eof, f.size()]
    f.seek(3)
    out += [f.read(4), f.read(-1)[-5:]]
    return out


def test_http_ops_match_jax(server):
    url = server.url("data.bin")
    with thf.hopen(url) as f, jhf.hopen(url) as g:
        assert isinstance(f, tremote.HttpFile)
        assert _ops(f) == _ops(g)


def test_http_peek_consumes_nothing_and_asks_once(server):
    """A peek reads ahead into the stream's buffer: the reads after it
    and a seek inside it or to the current offset make no new request."""
    url = server.url("data.bin")
    n0 = len(server.requests)
    with thf.hopen(url) as f:
        assert f.peek(1 << 16) == DATA[:1 << 16]
        assert f.peek(10) == DATA[:10]
        assert f.read(100) == DATA[:100]
        f.seek(1000)
        f.seek(f.tell())
        assert f.read(64_000) == DATA[1000:65_000]
        assert f.read(-1) == DATA[65_000:]
    assert len(server.requests) - n0 == 1
    assert server.requests[-1][1] is None


def test_http_seek_restarts_with_range(server):
    url = server.url("data.bin")
    n0 = len(server.requests)
    with thf.hopen(url) as f:
        f.read(10)
        f.seek(200_000)
        assert f.read(10) == DATA[200_000:200_010]
        f.seek(5)
        assert f.read(5) == DATA[5:10]
    got = [r[1] for r in server.requests[n0:]]
    assert got == [None, "bytes=200000-", "bytes=5-"]


def test_http_readline_matches_jax(server):
    url = server.url("lines.txt")
    with thf.hopen(url) as f, jhf.hopen(url) as g:
        for _ in range(2000):
            assert f.readline() == g.readline()
        f.seek(17)
        g.seek(17)
        assert f.readline() == g.readline()
        assert f.read(-1) == g.read(-1)
        assert f.readline() == g.readline() == b""


def test_http_bgzf_reader(server, tmp_path):
    data = b"".join(b"rec %d\n" % i for i in range(40_000))
    p = os.path.join(server.root, "t.gz")
    with BgzfWriter(p, level=1) as w:
        w.write(data)
    r = BgzfReader(server.url("t.gz"))
    assert r.is_bgzf and r.readline() == b"rec 0\n"
    assert r.read(-1) == data[6:]
    assert r.check_eof() == 1
    r.close()


def test_http_write_refused_and_missing(server):
    for mod in (thf, jhf):
        with pytest.raises(OSError):
            mod.hopen(server.url("data.bin"), "w")
    with pytest.raises(OSError):
        thf.hopen(server.url("missing.bin")).read(1)


def test_auth_callbacks_and_header_injection(server):
    """Headers given to the stream and those of the callbacks reach every
    request; the callbacks run again before each (hfile_libcurl's
    httphdr and auth callbacks); `headers_fn` replaces `headers`."""
    url = server.url("data.bin")
    count = [0]

    def auth(u):
        count[0] += 1
        return {"Authorization": f"Bearer tok{count[0]}"}

    n0 = len(server.requests)
    tremote.register_auth_callback(auth)
    try:
        f = tremote.HttpFile(url, headers={"X-Custom": "yes"})
        assert f.read(100) == DATA[:100]
        f.seek(5000)
        assert f.read(100) == DATA[5000:5100]
        f.close()
        g = tremote.HttpFile(url, headers={"X-Custom": "no"},
                             headers_fn=lambda: {"X-Fn": "fresh"})
        assert g.read(3) == DATA[:3]
        g.close()
    finally:
        tremote.clear_auth_callbacks()
    hdrs = [r[2] for r in server.requests[n0:]]
    assert [h.get("Authorization") for h in hdrs] == [
        "Bearer tok1", "Bearer tok2", "Bearer tok3"]
    assert [h.get("X-Custom") for h in hdrs] == ["yes", "yes", None]
    assert hdrs[2].get("X-Fn") == "fresh"
    assert not tremote._auth_callbacks


class _MiniFtp:
    """Enough FTP for ftplib (USER, PASS, TYPE, SIZE, REST, PASV, RETR,
    QUIT) serving one file from memory on 127.0.0.1."""

    def __init__(self, payload: bytes):
        self.payload = payload
        self.rests = []
        self.srv = socket.socket()
        self.srv.bind(("127.0.0.1", 0))
        self.srv.listen(4)
        self.port = self.srv.getsockname()[1]
        threading.Thread(target=self._serve, daemon=True).start()

    def _serve(self):
        while True:
            try:
                c, _ = self.srv.accept()
            except OSError:
                return
            threading.Thread(target=self._client, args=(c,),
                             daemon=True).start()

    def _client(self, c):
        rest, data_srv = 0, None
        f = c.makefile("rb")
        c.sendall(b"220 mini\r\n")
        while True:
            line = f.readline()
            if not line:
                break
            cmd = line.decode().strip()
            verb = cmd.split(" ")[0].upper()
            reply = {"USER": b"331 pw", "PASS": b"230 ok",
                     "TYPE": b"200 ok"}.get(verb)
            if reply:
                c.sendall(reply + b"\r\n")
            elif verb == "SIZE":
                c.sendall(f"213 {len(self.payload)}\r\n".encode())
            elif verb == "REST":
                rest = int(cmd.split(" ")[1])
                self.rests.append(rest)
                c.sendall(b"350 ok\r\n")
            elif verb == "PASV":
                data_srv = socket.socket()
                data_srv.bind(("127.0.0.1", 0))
                data_srv.listen(1)
                p = data_srv.getsockname()[1]
                c.sendall(f"227 ok (127,0,0,1,{p >> 8},{p & 255})\r\n"
                          .encode())
            elif verb == "RETR":
                c.sendall(b"150 go\r\n")
                d, _ = data_srv.accept()
                try:
                    d.sendall(self.payload[rest:])
                except OSError:
                    pass
                d.close()
                data_srv.close()
                rest = 0
                c.sendall(b"226 done\r\n")
            elif verb == "QUIT":
                c.sendall(b"221 bye\r\n")
                break
            else:
                c.sendall(b"502 no\r\n")
        c.close()

    def close(self):
        self.srv.close()


@pytest.fixture(scope="module")
def ftp():
    srv = _MiniFtp(bytes(range(256)) * 512)
    yield srv
    srv.close()


def test_ftp_rest_seeks_match_jax(ftp):
    url = f"ftp://anonymous:x@127.0.0.1:{ftp.port}/file.bin"
    payload = ftp.payload
    f, g = thf.hopen(url, "rb"), jhf.hopen(url, "rb")
    try:
        assert isinstance(f, tremote.FtpFile)
        assert f.size() == g.size() == len(payload)
        assert f.peek(16) == payload[:16]
        assert f.read(1000) == g.read(1000) == payload[:1000]
        f.seek(100_000)
        g.seek(100_000)
        assert f.read(256) == g.read(256) == payload[100_000:100_256]
        f.seek(-256, os.SEEK_END)
        g.seek(-256, os.SEEK_END)
        assert f.read(1000) == g.read(1000) == payload[-256:]
        f.seek(7)
        assert f.readline() == payload[7:payload.index(b"\n", 7) + 1]
    finally:
        f.close()
        g.close()
    assert 100_000 in ftp.rests and len(payload) - 256 in ftp.rests


# ---------------------------------------------------------------------------
# S3 and GCS

def test_s3_v2_signature_aws_example():
    """AWS's REST authentication example (GET photos/puppy.jpg)."""
    secret = "wJalrXUtnFEMI/K7MDENG/bPxRfiCYEXAMPLEKEY"
    sts = ts3.v2_string_to_sign("GET", "awsexamplebucket1",
                                "photos/puppy.jpg",
                                "Tue, 27 Mar 2007 19:36:42 +0000")
    assert sts == js3.v2_string_to_sign("GET", "awsexamplebucket1",
                                        "photos/puppy.jpg",
                                        "Tue, 27 Mar 2007 19:36:42 +0000")
    assert ts3.sign_v2(secret, sts) == "qgk2+6Sv9/oM7G3qLEjTH1a1l1g="


@pytest.mark.parametrize("token", ["", "FQoGZXIvYXdzEtoken"])
def test_s3_signatures_at_fixed_dates_match_jax(token):
    kw = dict(access_key="AKIDEXAMPLE", secret_key="secret/key+x",
              session_token=token, region="eu-west-2")
    auth, jauth = ts3.S3Auth(**kw), js3.S3Auth(**kw)
    for date in ("20130524T000000Z", "20261018T120102Z"):
        for path, query in (("/test.txt", ""), ("/b/k%20x", "a=1&b=2")):
            got = ts3.v4_sign_request(auth, "GET", "bucket.s3.amazonaws.com",
                                      path, query, amzdate=date,
                                      payload=b"p" if query else b"")
            want = js3.v4_sign_request(jauth, "GET",
                                       "bucket.s3.amazonaws.com", path,
                                       query, amzdate=date,
                                       payload=b"p" if query else b"")
            assert got == want
    assert (ts3.v2_auth_header(auth, "GET", "b", "k", "Thu, 01 Jan 2026")
            == js3.v2_auth_header(jauth, "GET", "b", "k",
                                  "Thu, 01 Jan 2026"))
    # the SigV4 key derivation's documented example
    assert ts3.v4_signing_key(
        "wJalrXUtnFEMI/K7MDENG/bPxRfiCYEXAMPLEKEY", "20150830",
        "us-east-1", "iam").hex() == (
        "2c94c0cf5378ada6887f09bb697df8fc0affdb34ba1cdd5bda32b664bd55b73c")


@pytest.mark.parametrize("url", ["s3://bucket/path/to/file.bam",
                                 "s3://prof@bucket/key",
                                 "s3+https://my.dotted.bucket/a/b",
                                 "s3://b/"])
def test_parse_s3_url_matches_jax(url):
    assert ts3.parse_s3_url(url) == js3.parse_s3_url(url)


def _creds_env(monkeypatch, tmp_path):
    for k in ("AWS_ACCESS_KEY_ID", "AWS_SECRET_ACCESS_KEY",
              "AWS_SESSION_TOKEN", "AWS_DEFAULT_REGION", "AWS_PROFILE",
              "AWS_DEFAULT_PROFILE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.setenv("AWS_SHARED_CREDENTIALS_FILE",
                       str(tmp_path / "credentials"))


def test_load_credentials_matches_jax(monkeypatch, tmp_path):
    _creds_env(monkeypatch, tmp_path)
    (tmp_path / ".s3cfg").write_text(
        "[default]\naccess_key = S3CFGKEY\nsecret_key = s3cfgsecret\n"
        "host_base = objects.example.org\n")
    assert vars(ts3.load_credentials()) == vars(js3.load_credentials())
    (tmp_path / "credentials").write_text(
        "[default]\naws_access_key_id = AKIAFILE\n"
        "aws_secret_access_key = filesecret\nregion = ap-south-1\n"
        "[other]\naws_access_key_id = AKIAOTHER\n"
        "aws_secret_access_key = o\naws_session_token = tok\n"
        "expiry_time = 2030-01-01T00:00:00Z\n")
    for prof in (None, "other", "absent"):
        assert (vars(ts3.load_credentials(prof))
                == vars(js3.load_credentials(prof)))
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "AKIAENV")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "envsecret")
    monkeypatch.setenv("AWS_DEFAULT_REGION", "us-west-1")
    assert vars(ts3.load_credentials()) == vars(js3.load_credentials())


def test_credential_refresh(monkeypatch, tmp_path):
    """Credentials within CREDENTIAL_LIFETIME of their expiry are read
    again (hfile_s3.c:104), so a rotated key is picked up."""
    _creds_env(monkeypatch, tmp_path)
    exp = time.strftime("%Y-%m-%dT%H:%M:%S+00:00",
                        time.gmtime(time.time() + 30))
    cred = tmp_path / "credentials"
    cred.write_text("[default]\naws_access_key_id = AKIAOLD\n"
                    "aws_secret_access_key = old\n"
                    f"expiry_time = {exp}\n")
    prov = ts3.CredentialProvider()
    assert prov.get().access_key == "AKIAOLD" and prov.get().expiry > 0
    cred.write_text("[default]\naws_access_key_id = AKIANEW\n"
                    "aws_secret_access_key = new\n")
    assert prov.get().access_key == "AKIANEW"
    assert prov.get() is prov.get()      # no expiry now: cached


def test_s3_and_gcs_open_match_jax(monkeypatch, tmp_path):
    _creds_env(monkeypatch, tmp_path)
    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "AKIATEST")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "sekrit")
    for url in ("s3://bucket-name/key.bam", "s3://dotted.bucket/a/k.cram"):
        f, g = ts3.s3_open(url), js3.s3_open(url)
        assert isinstance(f, tremote.HttpFile) and f.url == g.url
        h = f.headers_fn()
        assert h["Authorization"].startswith(
            "AWS4-HMAC-SHA256 Credential=AKIATEST/")
        assert sorted(h) == sorted(g.headers_fn())
    monkeypatch.setenv("GCS_OAUTH_TOKEN", "ya29.tok")
    for url in ("gs://bkt/obj/x.bam", "gs+https://proj@bkt/o"):
        f, g = tgcs.gcs_open(url), jgcs.gcs_open(url)
        assert (f.url, f.headers) == (g.url, g.headers)
        assert f.headers == {"Authorization": "Bearer ya29.tok"}
    assert isinstance(thf.hopen("gs://bkt/o"), tremote.HttpFile)


# ---------------------------------------------------------------------------
# htsget tickets

def _b64(b):
    return base64.b64encode(b).decode()


def test_parse_ticket_matches_jax():
    doc = {"htsget": {"format": "BAM", "urls": [
        "data:,abc", {"url": "https://h/x", "headers": {"Range": "bytes=0-9"}},
        {"url": "data:;base64," + _b64(b"z")}]}}
    raw = json.dumps(doc).encode()
    assert tmp_.parse_ticket(raw) == jmp.parse_ticket(raw)
    bare = json.dumps(doc["htsget"]).encode()
    assert tmp_.parse_ticket(bare) == jmp.parse_ticket(bare)
    for mod in (tmp_, jmp):
        with pytest.raises(IOError, match="no urls"):
            mod.parse_ticket(b'{"htsget": {}}')


def _walk(f):
    out = [f.read(4), f.peek(12), f.read(12), f.tell()]
    f.seek(6)
    out += [f.read(9)]
    f.seek(2)
    out += [f.read(-1), f.read(5)]
    return out


def test_multipart_data_parts_match_jax():
    pieces = [b"hello ", b"multipart ", b"", b"world"]
    doc = {"htsget": {"urls": [{"url": "data:;base64," + _b64(p)}
                               for p in pieces]}}
    parts = tmp_.parse_ticket(json.dumps(doc).encode())
    f = tmp_.MultipartFile(parts)
    g = jmp.MultipartFile(jmp.parse_ticket(json.dumps(doc).encode()))
    assert f.has_multiple_parts() and f.size() is None
    assert _walk(f) == _walk(g)
    f.close()
    g.close()


@pytest.mark.parametrize("parts", [1, 4, 9])
def test_htsget_ticket_over_http_matches_jax(server, parts):
    """A ticket whose http parts carry Range headers and whose last part
    is inline: the port's stream gives the JAX stream's bytes, asks for
    each part once, and a BgzfReader reads through it in order."""
    data = b"".join(b"row %d\n" % i for i in range(30_000))
    p = os.path.join(server.root, f"tk{parts}.gz")
    with BgzfWriter(p, level=1) as w:
        w.write(data)
    with open(p, "rb") as fp:
        raw = fp.read()
    server.extra[f"/ticket/{parts}"] = htsget_ticket(
        server.url(f"tk{parts}.gz"), len(raw) - 28, parts, raw[-28:])
    url = f"htsget+http://127.0.0.1:{server.port}/ticket/{parts}"
    n0 = len(server.requests)
    with thf.hopen(url) as f:
        assert isinstance(f, tmp_.MultipartFile)
        assert f.peek(1 << 16) == raw[:1 << 16]
        assert f.read(-1) == raw
    assert len(server.requests) - n0 == 1 + parts
    with jhf.hopen(url) as g:
        assert g.read(-1) == raw
    r = BgzfReader(url)
    assert r.read(-1) == data
    r.close()
