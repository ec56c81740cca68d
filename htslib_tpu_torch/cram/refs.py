"""CRAM reference sequences (the port's copy of htslib_tpu/cram/refs.py;
reference cram/cram_io.c:2541-3409).

A sequence is looked up as cram_populate_ref (cram_io.c:2977) does: in
the supplied FASTA (`ref=`, with its `.fai`), then in the local file
that its @SQ line's UR tag names, then by the line's M5 checksum in
REF_CACHE (a directory, or a template with `%s`) and in each element of
REF_PATH.  It is cached whole, and its MD5 is checked against M5 (a
mismatch logs a warning unless `ignore_md5`).  A REF_PATH element that
is a URL (http:, https:, ftp:) is fetched through hfile.py `hopen` and
the sequence written into REF_CACHE where it is set; a fetch that fails
goes on to the next element.
"""
from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Optional, Tuple

from htslib_tpu_torch.faidx import Faidx
from htslib_tpu_torch.hfile import hopen
from htslib_tpu_torch.sam.header import SamHeader
from htslib_tpu_torch.util.log import log_warning

_URL = ("http:", "https:", "ftp:")


class RefRegistry:
    def __init__(self, header: SamHeader, fasta: Optional[str] = None,
                 ignore_md5: bool = False):
        self.header = header
        self.fai: Optional[Faidx] = Faidx.load(fasta) if fasta else None
        self.ignore_md5 = ignore_md5
        self._cache: Dict[int, bytes] = {}

    @staticmethod
    def _tokenise_ref_path(searchpath: str) -> List[str]:
        """REF_PATH tokeniser (cram/open_trace_file.c:108
        tokenise_search_path): split on ':' with '::' escaping, keeping
        http:/https:/ftp: URL elements (scheme + //host[:port] + path)
        whole."""
        out = []
        cur: List[str] = []
        i, n = 0, len(searchpath)
        while i < n:
            if searchpath.startswith("::", i):
                cur.append(":")
                i += 2
                continue
            if not cur and searchpath.startswith(_URL, i):
                # the scheme, '//', then host[:port] and the path
                while i < n and searchpath[i] != ":":
                    cur.append(searchpath[i])
                    i += 1
                cur.append(":")
                i += 1
                for _ in range(2):
                    if i < n and searchpath[i] == "/":
                        cur.append("/")
                        i += 1
                while i < n and searchpath[i] not in ":/":
                    cur.append(searchpath[i])
                    i += 1
                if i < n:
                    cur.append(searchpath[i])
                    i += 1
                    if i < n and searchpath[i] == ":":
                        i += 1
                continue
            if searchpath[i] == ":":
                if cur:
                    out.append("".join(cur))
                    cur = []
                i += 1
                continue
            cur.append(searchpath[i])
            i += 1
        if cur:
            out.append("".join(cur))
        return out

    @staticmethod
    def _fetch_url(url: str) -> Optional[bytes]:
        """A REF_PATH URL element's body through the hfile layer (the
        find_file_url role, cram/open_trace_file.c:182), or None where
        the fetch fails."""
        try:
            with hopen(url, "rb") as f:
                return bytes(f.read(-1))
        except Exception:
            return None

    def _md5_lookup(self, md5: str) -> Tuple[Optional[str], Optional[bytes]]:
        """(local file, None) or (None, fetched bytes) holding the
        sequence of checksum `md5`, or (None, None): REF_CACHE first,
        then every REF_PATH element, a URL fetched and written back
        into REF_CACHE where it is set (cram_populate_ref,
        cram_io.c:2977-3130)."""
        cache = os.environ.get("REF_CACHE")
        cpath = None
        if cache:
            cpath = (cache % md5 if "%s" in cache
                     else os.path.join(cache, md5))
            if os.path.exists(cpath):
                return cpath, None
        for tmpl in self._tokenise_ref_path(os.environ.get("REF_PATH", "")):
            if tmpl.startswith(_URL):
                url = (tmpl.replace("%s", md5) if "%s" in tmpl
                       else tmpl.rstrip("/") + "/" + md5)
                data = self._fetch_url(url)
                if data is None:
                    continue
                if cpath:
                    try:
                        os.makedirs(os.path.dirname(cpath), exist_ok=True)
                        tmp = cpath + ".tmp.%d" % os.getpid()
                        with open(tmp, "wb") as f:
                            f.write(data)
                        os.replace(tmp, cpath)
                    except OSError:
                        pass
                return None, data
            p = (tmpl.replace("%s", md5) if "%s" in tmpl
                 else os.path.join(tmpl, md5))
            if os.path.exists(p):
                return p, None
        return None, None

    def _load_full(self, tid: int) -> bytes:
        if tid in self._cache:
            return self._cache[tid]
        name = self.header.tid2name(tid)
        sq = self.header.find_line_id("SQ", "SN", name)
        m5 = sq.get("M5") if sq is not None else None
        seq: Optional[bytes] = None
        if self.fai is not None and self.fai.has_seq(name):
            seq = self.fai.fetch_seq(name).encode().upper()
        if seq is None:
            ur = sq.get("UR") if sq is not None else None
            if ur and not ur.startswith(_URL) and os.path.isfile(ur):
                fai = Faidx.load(ur)
                if fai.has_seq(name):
                    seq = fai.fetch_seq(name).encode().upper()
                fai.close()
        if seq is None and m5:
            p, data = self._md5_lookup(m5)
            if p:
                with open(p, "rb") as f:
                    data = f.read()
            if data is not None:
                seq = data.upper()
        if seq is None:
            raise IOError(f"unable to load reference for {name!r}; pass "
                          "ref=FILE or set REF_PATH/REF_CACHE")
        if m5 and not self.ignore_md5:
            got = hashlib.md5(seq).hexdigest()
            if got != m5:
                log_warning("reference MD5 mismatch for %s: %s != %s",
                            name, got, m5)
        self._cache[tid] = seq
        return seq

    def get(self, tid: int, start: int, end: int) -> bytes:
        """1-based inclusive range; end=-1 means the whole sequence
        (cram_get_ref, cram_io.c:3409)."""
        seq = self._load_full(tid)
        if end == -1:
            return seq if start <= 1 else seq[start - 1:]
        return seq[start - 1:end]
