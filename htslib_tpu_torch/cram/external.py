"""Stable introspection/manipulation API over CRAM internals (the port's
copy of htslib_tpu/cram/external.py, with plain files in place of the
hfile layer; reference cram/cram_external.c: the public accessor layer of
htslib/cram.h:826, including cram_transcode_rg).

The Python object model already exposes container/slice/block fields as
attributes; this module adds the file-level walkers and the read-group
transcoder built on them.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

from htslib_tpu_torch.cram import CRAM_EOF_START, CramReader, CramWriter
from htslib_tpu_torch.cram.decode import decode_compression_header
from htslib_tpu_torch.cram.io import (CramContainer, CramIO,
                                      read_file_definition)
from htslib_tpu_torch.cram.structs import (CT_COMPRESSION_HEADER, CT_CORE,
                                           CT_EXTERNAL)
from htslib_tpu_torch.sam.header import SamHeader


def containers(path: str) -> Iterator[Tuple[int, CramContainer]]:
    """Walk (file_offset, container_header) pairs, EOF container
    excluded (cram_container_num_containers / cram_num_containers,
    cram_index.c:851)."""
    with open(path, "rb") as fp:
        version, _ = read_file_definition(fp)
        io = CramIO(fp, version)
        first = True
        while True:
            off = fp.tell()
            c = io.read_container_header()
            if c is None:
                return
            if c.ref_seq_id == -1 and c.ref_seq_start == CRAM_EOF_START:
                return
            if not first:  # first container carries the SAM header
                yield off, c
            first = False
            io.skip_container_data(c)


def num_containers(path: str) -> int:
    """cram_num_containers (cram_external.c)."""
    return sum(1 for _ in containers(path))


def container_stats(path: str) -> List[Dict[str, int]]:
    """Per-container summary: offset, ref, start, span, records, bases,
    blocks (the cram_container_get_* accessor family)."""
    out = []
    for off, c in containers(path):
        out.append({
            "offset": off, "ref_seq_id": c.ref_seq_id,
            "ref_seq_start": c.ref_seq_start, "ref_seq_span": c.ref_seq_span,
            "num_records": c.num_records, "num_blocks": c.num_blocks,
            "length": c.length,
        })
    return out


def transcode_rg(src: str, dst: str, rg_map: Dict[str, str],
                 ref: Optional[str] = None) -> int:
    """Rewrite read-group assignments while copying a CRAM file
    (cram_transcode_rg, cram_external.c; `samtools cat -r`).  Returns
    the number of records written.  Header @RG IDs are renamed per
    rg_map and every record's RG tag follows."""
    with CramReader(src, ref=ref, decode_md=False) as r:
        hdr_text = []
        for line in r.header.text.rstrip("\n").split("\n"):
            if line.startswith("@RG"):
                fields = line.split("\t")
                for i, f in enumerate(fields):
                    if f.startswith("ID:") and f[3:] in rg_map:
                        fields[i] = "ID:" + rg_map[f[3:]]
                line = "\t".join(fields)
            hdr_text.append(line)
        new_hdr = SamHeader("\n".join(hdr_text) + "\n")
        n = 0
        with CramWriter(dst, new_hdr, ref=ref) as w:
            for rec in r:
                rg = rec.get_aux("RG")
                if rg is not None and rg in rg_map:
                    rec.set_aux("RG", "Z", rg_map[rg])
                w.write(rec)
                n += 1
    return n


# ---------------------------------------------------------------------------
# Encoding introspection (cram_external.c cram_cid2ds_t machinery,
# cram_describe_encodings, cram_expand_method)
# ---------------------------------------------------------------------------

_METHOD_NAMES = {0: "raw", 1: "gzip", 2: "bzip2", 3: "lzma", 4: "rans4x8",
                 5: "ransNx16", 6: "arith", 7: "fqzcomp", 8: "tok3"}


def expand_method(data: bytes, method: int) -> Dict[str, object]:
    """cram_expand_method: method byte + stream peek -> details
    (order / level / transform flags)."""
    d: Dict[str, object] = {"method": _METHOD_NAMES.get(method, "?")}
    if method == 4 and data:           # rANS 4x8
        d["order"] = data[0]
    elif method in (5, 6) and data:    # Nx16 / arith flag byte
        fl = data[0]
        d["order"] = fl & 1
        d["x32"] = bool(fl & 0x04)
        d["stripe"] = bool(fl & 0x08)
        d["nosz"] = bool(fl & 0x10)
        d["cat"] = bool(fl & 0x20)
        d["rle"] = bool(fl & 0x40)
        d["pack"] = bool(fl & 0x80)
    elif method == 1 and len(data) > 8:
        d["level"] = "best" if data[8] == 2 else \
            ("fast" if data[8] == 4 else "default")
    return d


def cid2ds(path: str) -> Dict[int, List[str]]:
    """Content-id -> data-series map for a CRAM file's first data
    container (cram_update_cid2ds_map / cram_cid2ds_query)."""
    with open(path, "rb") as fp:
        version, _ = read_file_definition(fp)
        io = CramIO(fp, version)
        first = True
        while True:
            c = io.read_container_header()
            if c is None:
                return {}
            if c.ref_seq_id == -1 and c.ref_seq_start == CRAM_EOF_START:
                return {}
            if first:
                first = False
                io.skip_container_data(c)
                continue
            blk = io.read_block()
            if blk.content_type != CT_COMPRESSION_HEADER:
                return {}
            hdr = decode_compression_header(blk, version[0])
            out: Dict[int, List[str]] = {}
            for key, codec in hdr.codecs.items():
                for cidv in getattr(codec, "block_ids", set)():
                    out.setdefault(cidv, []).append(key)
            for kid, codec in hdr.tag_codecs.items():
                tag = chr((kid >> 16) & 0xFF) + chr((kid >> 8) & 0xFF)
                for cidv in getattr(codec, "block_ids", set)():
                    out.setdefault(cidv, []).append(tag)
            return out


def describe_encodings(path: str) -> List[Dict[str, object]]:
    """Block-level encoding report for the first data container
    (cram_describe_encodings): content id, method details, sizes and
    the data series each block serves."""
    ds_map = cid2ds(path)
    out: List[Dict[str, object]] = []
    with open(path, "rb") as fp:
        version, _ = read_file_definition(fp)
        io = CramIO(fp, version)
        first = True
        while True:
            c = io.read_container_header()
            if c is None or (c.ref_seq_id == -1
                             and c.ref_seq_start == CRAM_EOF_START):
                return out
            if first:
                first = False
                io.skip_container_data(c)
                continue
            end = c.data_offset + c.length
            while fp.tell() < end:
                b = io.read_block()
                if b.content_type not in (CT_CORE, CT_EXTERNAL,
                                          CT_COMPRESSION_HEADER):
                    continue
                rec = {"content_type": b.content_type,
                       "content_id": b.content_id,
                       "comp_size": len(b.data),
                       "uncomp_size": b.raw_size,
                       "series": ds_map.get(b.content_id, [])}
                rec.update(expand_method(bytes(b.data[:16]), b.method))
                out.append(rec)
            return out


def filter_containers(src: str, dst: str, keep) -> int:
    """Byte-level container subsetting (cram_filter_container /
    cram_copy_slice; the cram_filter tool's core): copy the file
    definition, SAM-header container and every data container for which
    keep(index, container_header) is true, then the EOF container.
    Containers are copied verbatim — no re-encode.  Returns the number
    of data containers kept."""
    kept = 0
    with open(src, "rb") as fp, open(dst, "wb") as out:
        version, _ = read_file_definition(fp)
        fp.seek(0)
        out.write(fp.read(26))          # file definition
        io = CramIO(fp, version)
        first = True
        idx = 0
        while True:
            start = fp.tell()
            c = io.read_container_header()
            if c is None:
                return kept
            end = c.data_offset + c.length
            is_eof = (c.ref_seq_id == -1
                      and c.ref_seq_start == CRAM_EOF_START)
            take = first or is_eof or keep(idx, c)
            if not first and not is_eof:
                idx += 1
            fp.seek(start)
            blob = fp.read(end - start)
            if take:
                out.write(blob)
                if not first and not is_eof:
                    kept += 1
            first = False
            if is_eof:
                return kept
