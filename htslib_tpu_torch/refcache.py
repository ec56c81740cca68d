"""Reference-sequence cache server, the port's copy of
htslib_tpu/refcache.py (reference ref_cache/: a standalone
HTTP proxy that caches CRAM reference sequences keyed by MD5 for
REF_PATH clients, ref_cache/ref-cache.1).

``RefCacheServer`` serves GET/HEAD /<md5> from a local cache
directory, fetching misses from an upstream URL template (the EBI ENA
CRAM reference registry by default, as the reference daemon does) and
storing them for subsequent hits.  Range requests are honoured so CRAM
decoders can fetch reference windows.  Daemon behaviours modeled on
ref_cache/server.c: a threaded request loop (concurrent hits),
per-MD5 in-flight locks so a burst of misses triggers ONE upstream
fetch (transaction.c coalescing), chunked streamed responses
(sendfile-equivalent; the file is never slurped), and a size-rotated
access log.

Usage:
    python -m htslib_tpu_torch.refcache -d /path/cache -p 8080
then point clients at REF_PATH=http://localhost:8080/%s
"""
from __future__ import annotations

import argparse
import hashlib
import http.server
import os
import re
import sys
import threading
import urllib.request
from typing import Optional

DEFAULT_UPSTREAM = "https://www.ebi.ac.uk/ena/cram/md5/%s"
_MD5_RE = re.compile(r"^[0-9a-f]{32}$")


class RefCacheServer:
    CHUNK = 1 << 16

    def __init__(self, cache_dir: str, port: int = 0,
                 upstream: Optional[str] = DEFAULT_UPSTREAM,
                 verify_md5: bool = True, log_path: Optional[str] = None,
                 log_rotate_bytes: int = 10 << 20):
        self.cache_dir = cache_dir
        self.upstream = upstream
        self.verify_md5 = verify_md5
        self.log_path = log_path
        self.log_rotate_bytes = log_rotate_bytes
        self._log_lock = threading.Lock()
        self._inflight: dict = {}
        self._inflight_lock = threading.Lock()
        self.upstream_fetches = 0      # observability: distinct fetches
        os.makedirs(cache_dir, exist_ok=True)
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_HEAD(self):
                self.do_GET(head=True)

            def do_GET(self, head=False):
                md5 = self.path.strip("/").split("/")[-1].lower()
                if not _MD5_RE.match(md5):
                    outer.access_log(self.path, 404)
                    self.send_error(404, "not an MD5")
                    return
                path = outer.lookup(md5)
                if path is None:
                    outer.access_log(self.path, 404)
                    self.send_error(404, "reference not found")
                    return
                outer.access_log(self.path, 200)
                size = os.path.getsize(path)
                start, end = 0, size - 1
                rng = self.headers.get("Range")
                if rng and rng.startswith("bytes="):
                    b, _, e = rng[6:].partition("-")
                    if b:
                        start = int(b)
                    if e:
                        end = min(int(e), size - 1)
                    if start > end or start >= size:
                        self.send_error(416, "range not satisfiable")
                        return
                    self.send_response(206)
                    self.send_header("Content-Range",
                                     f"bytes {start}-{end}/{size}")
                else:
                    self.send_response(200)
                length = end - start + 1
                self.send_header("Content-Length", str(length))
                self.send_header("Accept-Ranges", "bytes")
                self.send_header("Content-Type",
                                 "application/octet-stream")
                self.end_headers()
                if head:
                    return
                # sendfile-equivalent: stream in chunks, never slurp
                with open(path, "rb") as f:
                    f.seek(start)
                    left = length
                    while left > 0:
                        chunk = f.read(min(left, RefCacheServer.CHUNK))
                        if not chunk:
                            break
                        try:
                            self.wfile.write(chunk)
                        except (BrokenPipeError, ConnectionResetError):
                            return
                        left -= len(chunk)

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", port),
                                                     Handler)
        self.port = self.httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def access_log(self, path: str, status: int) -> None:
        """Size-rotated access log (ref_cache log-rotation role)."""
        if not self.log_path:
            return
        import time
        line = f"{time.strftime('%Y-%m-%dT%H:%M:%S')} {status} {path}\n"
        with self._log_lock:
            try:
                if (os.path.exists(self.log_path)
                        and os.path.getsize(self.log_path)
                        >= self.log_rotate_bytes):
                    os.replace(self.log_path, self.log_path + ".1")
                with open(self.log_path, "a") as fh:
                    fh.write(line)
            except OSError:
                pass

    def lookup(self, md5: str) -> Optional[str]:
        """Cache path for an MD5, fetching from upstream on miss; a
        burst of concurrent misses for one MD5 performs a single
        upstream fetch (the transaction.c coalescing model)."""
        path = os.path.join(self.cache_dir, md5)
        if os.path.exists(path):
            return path
        if not self.upstream:
            return None
        with self._inflight_lock:
            lock = self._inflight.setdefault(md5, threading.Lock())
        with lock:
            if os.path.exists(path):       # fetched while we waited
                return path
            return self._fetch_upstream(md5, path)

    def _fetch_upstream(self, md5: str, path: str) -> Optional[str]:
        self.upstream_fetches += 1
        url = self.upstream % md5 if "%s" in self.upstream \
            else self.upstream.rstrip("/") + "/" + md5
        assert url
        try:
            with urllib.request.urlopen(url, timeout=60) as resp:
                data = resp.read()
        except Exception:
            return None
        if self.verify_md5 and hashlib.md5(data).hexdigest() != md5:
            return None
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        return path

    def put(self, seq: bytes) -> str:
        """Populate the cache directly (REF_CACHE writer role)."""
        md5 = hashlib.md5(seq).hexdigest()
        path = os.path.join(self.cache_dir, md5)
        if not os.path.exists(path):
            with open(path, "wb") as f:
                f.write(seq)
        return md5

    # ------------------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self.httpd.shutdown()

    @property
    def url_template(self) -> str:
        return f"http://127.0.0.1:{self.port}/%s"


class AsyncRefCacheServer:
    """Daemon-grade event-driven variant (the ref_cache/server.c +
    poll_wrap_epoll.c + sendfile_wrap.c architecture): one epoll-backed
    event loop (asyncio on Linux IS epoll), zero-copy `loop.sendfile`
    responses, HTTP/1.1 keep-alive, per-client idle timeouts, a
    connection cap, and streamed coalesced upstream fetches (misses
    download chunk-by-chunk to a .tmp — never slurped — while every
    concurrent waiter for the same MD5 awaits ONE transaction,
    transaction.c's model)."""

    CHUNK = 1 << 16
    IDLE_TIMEOUT = 30.0
    MAX_CLIENTS = 512

    def __init__(self, cache_dir: str, port: int = 0,
                 upstream: Optional[str] = DEFAULT_UPSTREAM,
                 verify_md5: bool = True, log_path: Optional[str] = None,
                 log_rotate_bytes: int = 10 << 20):
        self.cache_dir = cache_dir
        self.upstream = upstream
        self.verify_md5 = verify_md5
        self.log_path = log_path
        self.log_rotate_bytes = log_rotate_bytes
        self.port = port
        self.upstream_fetches = 0
        self.n_clients = 0
        self._inflight: dict = {}
        os.makedirs(cache_dir, exist_ok=True)
        self._loop = None
        self._thread: Optional[threading.Thread] = None
        self._started = threading.Event()

    # -- request handling ----------------------------------------------
    async def _fetch_upstream_async(self, md5: str, path: str):
        """ONE streamed download per MD5; concurrent misses await it
        (transaction coalescing)."""
        import asyncio
        ev = self._inflight.get(md5)
        if ev is not None:
            await ev.wait()
            return path if os.path.exists(path) else None
        if not self.upstream:
            return None
        ev = asyncio.Event()
        self._inflight[md5] = ev
        try:
            self.upstream_fetches += 1
            url = self.upstream % md5 if "%s" in self.upstream \
                else self.upstream.rstrip("/") + "/" + md5
            loop = asyncio.get_running_loop()

            def stream_to_tmp():
                h = hashlib.md5()
                tmp = path + f".tmp.{os.getpid()}"
                try:
                    with urllib.request.urlopen(url, timeout=60) as resp, \
                            open(tmp, "wb") as f:
                        while True:
                            chunk = resp.read(self.CHUNK)
                            if not chunk:
                                break
                            h.update(chunk)
                            f.write(chunk)
                    if self.verify_md5 and h.hexdigest() != md5:
                        os.unlink(tmp)
                        return False
                    os.replace(tmp, path)
                    return True
                except Exception:
                    try:
                        os.unlink(tmp)
                    except OSError:
                        pass
                    return False

            ok = await loop.run_in_executor(None, stream_to_tmp)
            return path if ok else None
        finally:
            self._inflight.pop(md5, None)
            ev.set()

    async def _handle(self, reader, writer):
        import asyncio
        self.n_clients += 1
        try:
            if self.n_clients > self.MAX_CLIENTS:
                writer.write(b"HTTP/1.1 503 Service Unavailable\r\n"
                             b"Content-Length: 0\r\n\r\n")
                await writer.drain()
                return
            while True:                      # keep-alive request loop
                try:
                    req = await asyncio.wait_for(
                        reader.readuntil(b"\r\n\r\n"), self.IDLE_TIMEOUT)
                except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                        ConnectionError):
                    return
                lines = req.decode("latin-1").split("\r\n")
                parts = lines[0].split()
                if len(parts) != 3 or parts[0] not in ("GET", "HEAD"):
                    writer.write(b"HTTP/1.1 405 Method Not Allowed\r\n"
                                 b"Content-Length: 0\r\n\r\n")
                    await writer.drain()
                    return
                method, target = parts[0], parts[1]
                hdrs = {}
                for ln in lines[1:]:
                    k, _, v = ln.partition(":")
                    if v:
                        hdrs[k.strip().lower()] = v.strip()
                keep = hdrs.get("connection", "keep-alive") != "close"
                if not await self._respond(writer, method, target, hdrs):
                    return
                if not keep:
                    return
        finally:
            self.n_clients -= 1
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _respond(self, writer, method, target, hdrs) -> bool:
        import asyncio
        md5 = target.strip("/").split("/")[-1].lower()

        async def simple(status, reason):
            self.access_log(target, status)
            writer.write(f"HTTP/1.1 {status} {reason}\r\n"
                         f"Content-Length: 0\r\n\r\n".encode())
            await writer.drain()
            return True

        if not _MD5_RE.match(md5):
            return await simple(404, "Not Found")
        path = os.path.join(self.cache_dir, md5)
        if not os.path.exists(path):
            if await self._fetch_upstream_async(md5, path) is None:
                return await simple(404, "Not Found")
        size = os.path.getsize(path)
        start, end = 0, size - 1
        status = 200
        extra = ""
        rng = hdrs.get("range")
        if rng and rng.startswith("bytes="):
            b, _, e = rng[6:].partition("-")
            if b:
                start = int(b)
            if e:
                end = min(int(e), size - 1)
            if start > end or start >= size:
                return await simple(416, "Range Not Satisfiable")
            status = 206
            extra = f"Content-Range: bytes {start}-{end}/{size}\r\n"
        length = end - start + 1
        self.access_log(target, status)
        writer.write(
            (f"HTTP/1.1 {status} {'OK' if status == 200 else 'Partial Content'}\r\n"
             f"Content-Length: {length}\r\n"
             f"Accept-Ranges: bytes\r\n{extra}"
             f"Content-Type: application/octet-stream\r\n\r\n").encode())
        await writer.drain()
        if method == "HEAD":
            return True
        loop = asyncio.get_running_loop()
        with open(path, "rb") as f:
            try:
                # zero-copy where the loop supports it (sendfile_wrap.c)
                await loop.sendfile(writer.transport, f, start, length)
            except (NotImplementedError, RuntimeError):
                f.seek(start)
                left = length
                while left > 0:
                    chunk = f.read(min(left, self.CHUNK))
                    if not chunk:
                        break
                    writer.write(chunk)
                    await writer.drain()
                    left -= len(chunk)
            except (ConnectionError, BrokenPipeError):
                return False
        return True

    access_log = RefCacheServer.access_log
    _log_lock = threading.Lock()
    put = RefCacheServer.put

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        import asyncio

        def run():
            loop = asyncio.new_event_loop()
            self._loop = loop
            asyncio.set_event_loop(loop)

            async def boot():
                server = await asyncio.start_server(
                    self._handle, "127.0.0.1", self.port)
                self.port = server.sockets[0].getsockname()[1]
                self._server = server
                self._started.set()
                async with server:
                    await server.serve_forever()

            try:
                loop.run_until_complete(boot())
            except Exception:
                pass

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        self._started.wait(10)

    def stop(self) -> None:
        if self._loop is not None:
            self._loop.call_soon_threadsafe(
                lambda: self._server.close() if hasattr(self, "_server")
                else None)
            self._loop.call_soon_threadsafe(self._loop.stop)

    @property
    def url_template(self) -> str:
        return f"http://127.0.0.1:{self.port}/%s"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ref-cache", description=__doc__)
    p.add_argument("-d", "--cache-dir", required=True)
    p.add_argument("-p", "--port", type=int, default=8080)
    p.add_argument("-u", "--upstream", default=DEFAULT_UPSTREAM)
    p.add_argument("--no-upstream", action="store_true")
    p.add_argument("--threaded", action="store_true",
                   help="threaded request loop instead of the default "
                        "epoll/sendfile event-driven server")
    a = p.parse_args(argv)
    ups = None if a.no_upstream else a.upstream
    if a.threaded:
        srv = RefCacheServer(a.cache_dir, a.port, ups)
        print(f"ref-cache (threaded) on port {srv.port}, "
              f"cache {a.cache_dir}", file=sys.stderr)
        try:
            srv.httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        return 0
    srv = AsyncRefCacheServer(a.cache_dir, a.port, ups)
    srv.start()
    print(f"ref-cache (event-driven) on port {srv.port}, "
          f"cache {a.cache_dir}", file=sys.stderr)
    try:
        srv._thread.join()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
