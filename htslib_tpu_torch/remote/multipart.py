"""A multipart stream over an htsget ticket (the port's copy of
htslib_tpu/remote/multipart.py; reference multipart.c, with
hfile_libcurl.c's htsget handling).

An htsget server answers a query with a JSON ticket that lists parts,
each an https URL (with optional headers, such as a Range) or an inline
`data:` URI; the payload is the parts' concatenation.  `MultipartFile`
reads it in order, opening each part as it is reached;
`htsget://host/...` and `htsget+http://host/...` fetch the ticket and
return the stream.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from htslib_tpu_torch.hfile import HFile, add_scheme_handler, hopen
from htslib_tpu_torch.remote import HttpFile, _StreamFile

Part = Tuple[str, Optional[Dict[str, str]]]


def parse_ticket(data: bytes) -> List[Part]:
    """An htsget JSON ticket's parts as (url, headers) (the
    hFILE_multipart fields, multipart.c:45-51)."""
    doc = json.loads(data.decode("utf-8"))
    body = doc.get("htsget", doc)
    if "urls" not in body:
        raise IOError("htsget ticket has no urls list")
    parts: List[Part] = []
    for u in body["urls"]:
        if isinstance(u, str):
            parts.append((u, None))
        else:
            parts.append((u["url"], u.get("headers")))
    return parts


def _open_part(url: str, headers: Optional[Dict[str, str]]) -> HFile:
    if headers and url.startswith(("http://", "https://")):
        return HttpFile(url, headers=headers)
    return hopen(url, "rb")


class MultipartFile(_StreamFile):
    """The parts' concatenation, read in order: a part opens when the
    one before it is exhausted (multipart_read).  A forward seek reads
    up to the offset; a backward one starts again from the first part,
    since the parts' sizes are not known before they are read."""

    def __init__(self, parts: List[Part], name: str = "multipart:"):
        super().__init__(name)
        self.mode = "rb"
        self.parts = parts
        self._idx = -1
        self._cur: Optional[HFile] = None

    def _next_part(self) -> bool:
        if self._cur is not None:
            self._cur.close()
            self._cur = None
        self._idx += 1
        if self._idx >= len(self.parts):
            return False
        self._cur = _open_part(*self.parts[self._idx])
        return True

    def _fetch(self, n: int) -> bytes:
        out = bytearray()
        while n < 0 or len(out) < n:
            if self._cur is None and not self._next_part():
                break
            chunk = self._cur.read(-1 if n < 0 else n - len(out))
            if not chunk:
                if not self._next_part():
                    break
                continue
            out += chunk
        return bytes(out)

    def _drop(self) -> None:
        if self._cur is not None:
            self._cur.close()
            self._cur = None

    def _restart(self, offset: int, src: int) -> int:
        if offset < src:
            self._drop()
            self._idx = -1
            src = 0
        while src < offset:
            chunk = self._fetch(min(1 << 16, offset - src))
            if not chunk:
                break
            src += len(chunk)
        return src

    def size(self) -> Optional[int]:
        return None

    def has_multiple_parts(self) -> bool:
        return True


def open_htsget(url: str, mode: str = "rb") -> MultipartFile:
    """Fetch an htsget ticket and open its parts (hfile_libcurl.c's
    htsget:// rewrite to https)."""
    if url.startswith("htsget+http://"):
        ticket_url = "http://" + url[len("htsget+http://"):]
    elif url.startswith("htsget://"):
        ticket_url = "https://" + url[len("htsget://"):]
    else:
        ticket_url = url
    with hopen(ticket_url, "rb") as f:
        data = f.read(-1)
    return MultipartFile(parse_ticket(data), name=url)


add_scheme_handler("htsget", open_htsget)
add_scheme_handler("htsget+http", open_htsget)
