"""CRAM reader and writer on the host (the port's copy of
htslib_tpu/cram/__init__.py; reference cram/, cram_io.c).

`CramReader` walks containers -> slices -> records: the file definition,
the SAM header container, then each data container's compression
header and slices, decoded on the host by cram/decode.py (only the data
series of `required_fields`, where given).  It skips the records that
fail a filter expression (`set_filter`, hts_expr.py) and answers region
queries through the CRAI index (`load_index`, `fetch`; cram/index.py).
`CramWriter` queues records into containers (cram/encode.py), and with
`write_index` writes the `.crai` beside the file.  A file is a name
that hfile.py `hopen` opens (a path or a URL) or a binary file object.
The batch
pipeline that decodes ranges of containers with the rANS blocks on the
device is cram/batch.py.
"""
from __future__ import annotations

import struct
from typing import BinaryIO, Iterator, List, Optional, Union

from htslib_tpu_torch.cram.decode import (decode_compression_header,
                                          decode_slice, decode_slice_header)
from htslib_tpu_torch.cram.encode import CramEncoder
from htslib_tpu_torch.cram.index import CramIndex
from htslib_tpu_torch.cram.io import (CramContainer, CramIO,
                                      read_file_definition)
from htslib_tpu_torch.cram.refs import RefRegistry
from htslib_tpu_torch.cram.structs import (CT_COMPRESSION_HEADER,
                                           CT_FILE_HEADER, CT_MAPPED_SLICE,
                                           CT_UNMAPPED_SLICE)
from htslib_tpu_torch.hfile import hopen
from htslib_tpu_torch.hts_expr import HtsFilter, sam_passes_filter
from htslib_tpu_torch.sam.header import SamHeader
from htslib_tpu_torch.sam.record import BamRecord

CRAM_EOF_START = 0x454F46  # container ref_seq_start magic in EOF block


class CramReader:
    def __init__(self, src: Union[str, BinaryIO], ref: Optional[str] = None,
                 ignore_md5: bool = False, decode_md: bool = True,
                 required_fields: int = 0):
        if isinstance(src, str):
            self.fp = hopen(src, "rb")
            self.name = src
        else:
            self.fp = src
            self.name = getattr(src, "name", "?")
        self.version, self.file_id = read_file_definition(self.fp)
        self.io = CramIO(self.fp, self.version)
        self.header = self._read_sam_header()
        self.refs = RefRegistry(self.header, fasta=ref,
                                ignore_md5=ignore_md5)
        self.decode_md = decode_md
        # CRAM_OPT_REQUIRED_FIELDS (SAM_* bits; 0 = everything): series
        # whose blocks are not needed are never even uncompressed
        self.required_fields = required_fields
        self._rec_queue: List[BamRecord] = []
        self._qi = 0
        self._eof = False
        self._filter: Optional[HtsFilter] = None
        self.index: Optional[CramIndex] = None

    def _read_sam_header(self) -> SamHeader:
        c = self.io.read_container_header()
        if c is None:
            raise IOError("CRAM: missing header container")
        block = self.io.read_block()
        if block.content_type != CT_FILE_HEADER:
            raise IOError("CRAM: first block is not the SAM header")
        data = block.uncompress()
        (l_text,) = struct.unpack_from("<i", data, 0)
        text = data[4:4 + l_text].split(b"\0")[0].decode("utf-8", "replace")
        # skip any remaining blocks of the header container
        self.fp.seek(c.data_offset + c.length)
        return SamHeader(text)

    def _decode_container(self, c: CramContainer) -> List[BamRecord]:
        comp_block = self.io.read_block()
        if comp_block.content_type != CT_COMPRESSION_HEADER:
            raise IOError("CRAM: expected compression header block")
        chdr = decode_compression_header(comp_block, self.version[0])
        out: List[BamRecord] = []
        end = c.data_offset + c.length
        while self.fp.tell() < end:
            hdr_block = self.io.read_block()
            if hdr_block.content_type not in (CT_MAPPED_SLICE,
                                              CT_UNMAPPED_SLICE):
                raise IOError(f"CRAM: unexpected block content type "
                              f"{hdr_block.content_type} in container")
            sh = decode_slice_header(hdr_block, self.version[0])
            blocks = [self.io.read_block() for _ in range(sh.num_blocks)]
            out.extend(decode_slice(chdr, sh, blocks, self.header,
                                    self.refs.get, self.version[0],
                                    decode_md=self.decode_md,
                                    required_fields=self.required_fields))
        return out

    def _next_container(self) -> bool:
        while True:
            c = self.io.read_container_header()
            if c is None:
                return False
            if c.ref_seq_id == -1 and c.ref_seq_start == CRAM_EOF_START:
                return False
            if c.length == 0 or c.num_records == 0:
                self.io.skip_container_data(c)
                continue
            self._rec_queue = self._decode_container(c)
            self._qi = 0
            return True

    def __iter__(self) -> Iterator[BamRecord]:
        return self

    def set_filter(self, expr: Optional[str]) -> None:
        """hts_set_filter_expression (hts.c:1967): the iterator skips
        records failing the expression (sam_passes_filter, sam.c:1535)."""
        self._filter = HtsFilter(expr) if expr else None

    def __next__(self) -> BamRecord:
        while True:
            rec = self.read1()
            if rec is None:
                raise StopIteration
            if (self._filter is None
                    or sam_passes_filter(rec, self.header, self._filter)):
                return rec

    def read1(self) -> Optional[BamRecord]:
        while self._qi >= len(self._rec_queue):
            if self._eof or not self._next_container():
                self._eof = True
                return None
        rec = self._rec_queue[self._qi]
        self._qi += 1
        return rec

    # -- region queries through the .crai --------------------------------
    def load_index(self, path: Optional[str] = None) -> None:
        self.index = CramIndex.load(path or self.name + ".crai")

    def fetch(self, tid: int, beg: int, end: int) -> Iterator[BamRecord]:
        """Records of reference `tid` overlapping [beg, end) (0-based):
        cram_itr_query's semantics (sam.c:1686), a seek to each container
        the index names, then the records filtered by position.  The
        filter expression is not applied here, as in the JAX reader."""
        if self.index is None:
            self.load_index()
        for off in self.index.container_offsets(tid, beg + 1, end):
            self.fp.seek(off)
            c = self.io.read_container_header()
            if c is None:
                break
            for rec in self._decode_container(c):
                if rec.tid == tid and rec.pos < end and rec.endpos() > beg:
                    yield rec

    def close(self) -> None:
        self.fp.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class CramWriter:
    """Writes records as CRAM through cram/encode.py `CramEncoder`; the
    options are the encoder's."""

    def __init__(self, dst, header, ref=None, embed_ref=0, lossy_names=0,
                 version=(3, 0), write_index=False, slices_per_container=1,
                 seqs_per_slice=10000, nthreads=None,
                 device_profile=False, profile=None):
        self._enc = CramEncoder(dst, header, ref=ref, embed_ref=embed_ref,
                                lossy_names=lossy_names, version=version,
                                write_index=write_index,
                                slices_per_container=slices_per_container,
                                seqs_per_slice=seqs_per_slice,
                                nthreads=nthreads,
                                device_profile=device_profile,
                                profile=profile)
        self.header = header

    def write(self, rec: BamRecord) -> None:
        self._enc.write(rec)

    def close(self) -> None:
        self._enc.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
