"""hfile: a buffered byte stream over back ends chosen by URL scheme (the
port's copy of htslib_tpu/hfile.py; reference hfile.c:1-1465,
hfile_internal.h:66-92).

`hopen(name, mode)` opens a local path (or `-`, standard input or
output) or a URL whose scheme a handler is registered for: `data:`
URIs, `mem:` (a local file read into memory), `preload:` (any URL read
whole into memory, hfile.c:929-1016) and `file:` here; http, https,
ftp, s3, gs and htsget in remote/, registered on the first unknown
scheme; and the schemes that `hfile_*.py` plugins in the directories
of HTS_PATH register (`add_scheme_handler`, hfile.c:1054).  Every back
end is an `HFile`: read, readinto, peek (which does not consume),
readline, write, flush, seek, tell, size and close.

The layer is host only.  The device paths take whole byte ranges
(bgzf.py `inflate_range`), so its per-call cost is off their path.
"""
from __future__ import annotations

import base64
import io
import os
import urllib.parse
from typing import Callable, Dict, Optional

from htslib_tpu_torch.util.log import log_error, log_warning

__all__ = ["hopen", "HFile", "MemFile", "add_scheme_handler",
           "hfile_scheme"]


class HFile:
    """A buffered binary stream over a raw `io` object, with the hFILE
    verbs; `has_multiple_parts` is True for multipart streams
    (multipart.c)."""

    def __init__(self, raw, mode: str, name: str = "?"):
        self.name = name
        self.mode = mode
        self._raw = raw
        writable = (any(c in mode for c in "wa+")
                    and "r" not in mode.replace("r+", "+"))
        if "r" in mode and "+" not in mode:
            self._buf = (io.BufferedReader(raw)
                         if isinstance(raw, io.RawIOBase) else raw)
        elif writable and isinstance(raw, io.RawIOBase):
            self._buf = io.BufferedWriter(raw)
        else:
            self._buf = raw
        self.at_eof = False

    def read(self, n: int = -1) -> bytes:
        data = self._buf.read(n)
        if n is not None and n >= 0 and len(data) < n:
            self.at_eof = True
        return data

    def readinto(self, b) -> int:
        return self._buf.readinto(b)

    def peek(self, n: int) -> bytes:
        """Up to n upcoming bytes, not consumed (hpeek, hfile.c:298)."""
        if hasattr(self._buf, "peek"):
            return self._buf.peek(n)[:n]
        pos = self.tell()
        data = self._buf.read(n)
        self._buf.seek(pos)
        return data

    def readline(self) -> bytes:
        return self._buf.readline()

    def write(self, data) -> int:
        return self._buf.write(data)

    def flush(self) -> None:
        self._buf.flush()

    def seek(self, offset: int, whence: int = os.SEEK_SET) -> int:
        self.at_eof = False
        return self._buf.seek(offset, whence)

    def tell(self) -> int:
        return self._buf.tell()

    def seekable(self) -> bool:
        try:
            return self._buf.seekable()
        except Exception:
            return False

    def size(self) -> Optional[int]:
        """The stream's whole size where a seek can tell it, else None."""
        if not self.seekable():
            return None
        pos = self.tell()
        end = self._buf.seek(0, os.SEEK_END)
        self._buf.seek(pos)
        return end

    def close(self) -> None:
        self._buf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def has_multiple_parts(self) -> bool:
        return False


class MemFile(HFile):
    """The `mem:` back end (hfile.c:835-926): bytes in memory."""

    def __init__(self, data: bytes = b"", mode: str = "r",
                 name: str = "mem:"):
        super().__init__(io.BytesIO(data), mode, name)

    def getvalue(self) -> bytes:
        return self._buf.getvalue()


# ---------------------------------------------------------------------------
# The scheme registry (hfile.c:1018-1100)
# ---------------------------------------------------------------------------

_SchemeOpener = Callable[[str, str], HFile]
_scheme_handlers: Dict[str, _SchemeOpener] = {}


def add_scheme_handler(scheme: str, opener: _SchemeOpener) -> None:
    _scheme_handlers[scheme.lower()] = opener


def hfile_scheme(fname: str) -> Optional[str]:
    """The URL scheme of `fname` by RFC 3986 (find_scheme_string,
    hfile.c:1124-1141): a letter, then letters, digits, '+', '.' or '-',
    then ':'.  A one-letter scheme is a drive letter, so a path."""
    i, n = 0, len(fname)
    while i < n and (fname[i].isalnum() or fname[i] in "+.-"):
        i += 1
    if i >= 2 and i < n and fname[i] == ":" and fname[0].isalpha():
        return fname[:i].lower()
    return None


def _open_data_uri(url: str, mode: str) -> HFile:
    """`data:[<meta>][;base64],<payload>` (hopen's data: URLs,
    hfile.c:1203)."""
    rest = url[len("data:"):]
    if "," not in rest:
        raise FileNotFoundError(f"malformed data: URL {url!r}")
    meta, payload = rest.split(",", 1)
    if meta.endswith(";base64"):
        data = base64.b64decode(payload)
    else:
        data = urllib.parse.unquote_to_bytes(payload)
    return MemFile(data, "r", name=url)


def _open_preload(url: str, mode: str) -> HFile:
    """`preload:<url>`: the URL read whole into memory (hpreload,
    hfile.c:929-1016)."""
    with hopen(url[len("preload:"):], "rb") as fp:
        data = fp.read(-1)
    return MemFile(data, "r", name=url)


def _open_mem(url: str, mode: str) -> HFile:
    """`mem:<path>`: a local file read into memory; for writing, an
    empty memory stream."""
    path = url[len("mem:"):]
    if "r" in mode:
        with open(path, "rb") as f:
            return MemFile(f.read(), mode, name=url)
    return MemFile(b"", mode, name=url)


def _open_file(fname: str, mode: str) -> HFile:
    """A local file, unbuffered below the HFile's own buffer; `-` is
    standard input for reading, standard output for writing."""
    if fname == "-":
        import sys
        stream = sys.stdin.buffer if "r" in mode else sys.stdout.buffer
        return HFile(stream, mode, name="-")
    pymode = mode if "b" in mode else mode + "b"
    return HFile(open(fname, pymode, buffering=0), mode, name=fname)


def _open_file_url(url: str, mode: str) -> HFile:
    skip = len("file://") if url.startswith("file://") else len("file:")
    return _open_file(url[skip:], mode)


add_scheme_handler("data", _open_data_uri)
add_scheme_handler("preload", _open_preload)
add_scheme_handler("mem", _open_mem)
add_scheme_handler("file", _open_file_url)


def _load_remote_handlers() -> None:
    """Register the http, https, ftp, s3, gs and htsget handlers
    (remote/) and the HTS_PATH plugins (plugin loading,
    hfile.c:1111-1166).  A remote module that fails to import leaves
    its schemes unregistered."""
    try:
        from htslib_tpu_torch import remote  # noqa: F401  (registers)
    except Exception:
        pass
    _load_hfile_plugins()


def _load_hfile_plugins() -> None:
    """HTS_PATH plugins (load_hfile_plugins, hfile.c:1111, and
    plugin.c): every `hfile_*.py` in each ':'-separated directory is
    loaded and its `hfile_plugin_init(add)` called with
    `add_scheme_handler`.  An empty element adds nothing."""
    path = os.environ.get("HTS_PATH")
    if not path:
        return
    import glob
    import importlib.util
    for d in path.split(":"):
        if not d:
            continue
        for py in sorted(glob.glob(os.path.join(d, "hfile_*.py"))):
            name = "htslib_tpu_torch._plugin_" + os.path.basename(py)[:-3]
            try:
                spec = importlib.util.spec_from_file_location(name, py)
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                init = getattr(mod, "hfile_plugin_init", None)
                if init is None:
                    log_warning("plugin %s has no hfile_plugin_init", py)
                    continue
                init(add_scheme_handler)
            except Exception as e:
                log_warning("failed to load plugin %s (%s)", py, e)


_remote_loaded = False


def hopen(fname: str, mode: str = "r") -> HFile:
    """Open a byte stream by name, by its URL scheme (hopen,
    hfile.c:1176-1232); a name with no scheme is a local path."""
    scheme = hfile_scheme(fname)
    if scheme is None:
        return _open_file(fname, mode)
    handler = _scheme_handlers.get(scheme)
    if handler is None:
        global _remote_loaded
        if not _remote_loaded:
            _remote_loaded = True
            _load_remote_handlers()
            handler = _scheme_handlers.get(scheme)
    if handler is None:
        log_error("unknown URL scheme %r", scheme)
        raise FileNotFoundError(f"unsupported URL scheme: {fname}")
    return handler(fname, mode)
