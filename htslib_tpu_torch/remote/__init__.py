"""Remote byte streams (the port's copy of htslib_tpu/remote; reference
hfile_libcurl.c, hfile_s3.c, hfile_gcs.c, multipart.c).

`HttpFile` reads http and https URLs with the standard library's
urllib, a seek past what it holds restarting the transfer with a Range
header (hfile_libcurl's restart at an offset); `FtpFile` reads ftp URLs
with RETR and a REST offset.  s3:// and gs:// URLs become signed https
URLs (s3.py, gcs.py), htsget tickets concatenations of parts
(multipart.py).  The schemes are registered in hfile.py's registry
when this package is imported (hfile.c:1054).

Each stream keeps what it has received but not yet handed out in a
lookahead buffer, so `peek` consumes nothing and asks the server for
nothing twice, `readline` reads in chunks, and a seek into the buffer
or to the current offset keeps the transfer open.
"""
from __future__ import annotations

import os
import urllib.request
from typing import Optional

from htslib_tpu_torch.hfile import HFile, add_scheme_handler

# extra headers for every http(s) request (hfile_libcurl's httphdr
# option and auth callbacks): the callbacks run before each request, so
# expiring credentials can refresh (hfile_s3.c CREDENTIAL_LIFETIME)
_auth_callbacks: list = []


def register_auth_callback(fn) -> None:
    """Register fn(url) -> dict of extra headers (or None), evaluated
    before every http(s) request; several merge in registration order."""
    _auth_callbacks.append(fn)


def clear_auth_callbacks() -> None:
    _auth_callbacks.clear()


def _auth_headers(url: str) -> dict:
    out: dict = {}
    for fn in _auth_callbacks:
        extra = fn(url)
        if extra:
            out.update(extra)
    return out


class _StreamFile(HFile):
    """A read-only stream over a forward-only source with a lookahead
    buffer.  `_pos` is the offset of the next byte handed out and
    `_ahead` the bytes received past it.  A subclass gives `_fetch(n)`
    (up to n more bytes of the source, fewer only at its end, all with
    n < 0; opening it at `_pos + len(_ahead)` where it is closed),
    `_restart(offset, src)` (place the source at `offset`, the source
    being at `src`; returns the offset reached) and `_drop()` (close the
    source)."""

    def __init__(self, name: str):
        self.name = name
        self.mode = "r"
        self.at_eof = False
        self._pos = 0
        self._ahead = bytearray()

    def _fetch(self, n: int) -> bytes:
        raise NotImplementedError

    def _drop(self) -> None:
        raise NotImplementedError

    def _restart(self, offset: int, src: int) -> int:
        self._drop()
        return offset

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            data = bytes(self._ahead) + self._fetch(-1)
            self._ahead = bytearray()
        else:
            if len(self._ahead) < n:
                self._ahead += self._fetch(n - len(self._ahead))
            data = bytes(self._ahead[:n])
            del self._ahead[:n]
            if len(data) < n:
                self.at_eof = True
        self._pos += len(data)
        return data

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[:len(data)] = data
        return len(data)

    def peek(self, n: int) -> bytes:
        if len(self._ahead) < n:
            self._ahead += self._fetch(n - len(self._ahead))
        return bytes(self._ahead[:n])

    def readline(self) -> bytes:
        out = bytearray()
        while True:
            i = self._ahead.find(b"\n")
            if i >= 0:
                out += self._ahead[:i + 1]
                del self._ahead[:i + 1]
                break
            out += self._ahead
            self._ahead = bytearray()
            chunk = self._fetch(1 << 16)
            if not chunk:
                break
            self._ahead += chunk
        self._pos += len(out)
        return bytes(out)

    def _end(self) -> int:
        size = self.size()
        if size is None:
            raise OSError(f"{self.name}: size unknown, cannot seek from "
                          "the end")
        return size

    def seek(self, offset: int, whence: int = os.SEEK_SET) -> int:
        if whence == os.SEEK_CUR:
            offset += self._pos
        elif whence == os.SEEK_END:
            offset += self._end()
        if offset < 0:
            raise OSError("negative seek")
        src = self._pos + len(self._ahead)
        if self._pos <= offset <= src:
            del self._ahead[:offset - self._pos]
            self._pos = offset
        else:
            self._ahead = bytearray()
            self._pos = offset
            self._pos = self._restart(offset, src)
        self.at_eof = False
        return self._pos

    def tell(self) -> int:
        return self._pos

    def seekable(self) -> bool:
        return True

    def write(self, data) -> int:
        raise OSError(f"{self.name}: remote streams are read-only")

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self._drop()
        self._ahead = bytearray()


class HttpFile(_StreamFile):
    """An http(s) URL read through one GET, restarted with a Range header
    at a seek outside what it holds.  `headers` go with every request;
    `headers_fn`, where given, gives them instead before each request
    (a signature that must be fresh: hfile_s3.c AUTH_LIFETIME)."""

    def __init__(self, url: str, headers: Optional[dict] = None,
                 headers_fn=None):
        super().__init__(url)
        self.url = url
        self.headers = dict(headers or {})
        self.headers_fn = headers_fn
        self._resp = None
        self._size: Optional[int] = None

    def _open_at(self, offset: int) -> None:
        hdrs = dict(self.headers_fn() if self.headers_fn is not None
                    else self.headers)
        hdrs.update(_auth_headers(self.url))
        req = urllib.request.Request(self.url, headers=hdrs)
        if offset:
            req.add_header("Range", f"bytes={offset}-")
        self._resp = urllib.request.urlopen(req, timeout=60)
        clen = self._resp.headers.get("Content-Length")
        if clen is not None and self._size is None:
            self._size = offset + int(clen)

    def _fetch(self, n: int) -> bytes:
        if self._resp is None:
            self._open_at(self._pos + len(self._ahead))
        return self._resp.read() if n < 0 else self._resp.read(n)

    def _drop(self) -> None:
        if self._resp is not None:
            self._resp.close()
            self._resp = None

    def size(self) -> Optional[int]:
        """The body's size from the first response's Content-Length (a
        request is made where none was); None without one."""
        if self._size is None and self._resp is None:
            self._open_at(self._pos + len(self._ahead))
        return self._size


def _open_http(url: str, mode: str) -> HFile:
    if "r" not in mode:
        raise OSError("remote URLs are read-only")
    return HttpFile(url)


class FtpFile(_StreamFile):
    """An ftp URL read by RETR, a seek outside what it holds restarting
    the transfer with a REST offset (hfile_libcurl's ftp path,
    CURLOPT_RESUME_FROM); its size from SIZE."""

    def __init__(self, url: str):
        import ftplib
        from urllib.parse import urlparse
        super().__init__(url)
        u = urlparse(url)
        self._path = u.path
        self._ftp = ftplib.FTP()
        self._ftp.connect(u.hostname, u.port or 21, timeout=60)
        self._ftp.login(u.username or "anonymous", u.password or "hts@")
        self._ftp.voidcmd("TYPE I")
        try:
            self._size = self._ftp.size(self._path)
        except Exception:
            self._size = None
        self._conn = None

    def _fetch(self, n: int) -> bytes:
        if self._conn is None:
            offset = self._pos + len(self._ahead)
            self._conn = self._ftp.transfercmd(f"RETR {self._path}",
                                               rest=offset or None)
        out = bytearray()
        while n < 0 or len(out) < n:
            c = self._conn.recv(1 << 16 if n < 0
                                else min(1 << 16, n - len(out)))
            if not c:
                break
            out += c
        return bytes(out)

    def _drop(self) -> None:
        if self._conn is not None:
            try:
                self._conn.close()
                self._ftp.voidresp()
            except Exception:
                pass
            self._conn = None

    def size(self) -> Optional[int]:
        return self._size

    def close(self) -> None:
        super().close()
        try:
            self._ftp.quit()
        except Exception:
            pass


def _open_ftp(url: str, mode: str) -> HFile:
    if "r" not in mode:
        raise OSError("remote URLs are read-only")
    return FtpFile(url)


def _open_s3(url: str, mode: str) -> HFile:
    from htslib_tpu_torch.remote.s3 import s3_open
    return s3_open(url, mode)


def _open_gcs(url: str, mode: str) -> HFile:
    from htslib_tpu_torch.remote.gcs import gcs_open
    return gcs_open(url, mode)


for _scheme, _opener in (("http", _open_http), ("https", _open_http),
                         ("ftp", _open_ftp), ("s3", _open_s3),
                         ("s3+http", _open_s3), ("s3+https", _open_s3),
                         ("gs", _open_gcs), ("gs+http", _open_gcs),
                         ("gs+https", _open_gcs)):
    add_scheme_handler(_scheme, _opener)

# htsget tickets (multipart.c with hfile_libcurl's htsget) register
# their schemes on import
from htslib_tpu_torch.remote import multipart as _multipart  # noqa: E402,F401
