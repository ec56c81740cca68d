"""CRAM reader and writer on the host (the port's copy of
htslib_tpu/cram/__init__.py; reference cram/, cram_io.c).

`CramReader` walks containers -> slices -> records: the file definition,
the SAM header container, then each data container's compression
header and slices, decoded on the host by cram/decode.py.  `CramWriter`
queues records into containers (cram/encode.py).  Plain Python file
objects take the place of the JAX package's hfile layer; the CRAI index
(`load_index`, `fetch`) and filter expressions (`set_filter`) are not
ported.  The batch pipeline that decodes ranges of containers with the
rANS blocks on the device is cram/batch.py.
"""
from __future__ import annotations

import struct
from typing import BinaryIO, Iterator, List, Optional, Union

from htslib_tpu_torch.cram.decode import (decode_compression_header,
                                          decode_slice, decode_slice_header)
from htslib_tpu_torch.cram.encode import CramEncoder
from htslib_tpu_torch.cram.io import (CramContainer, CramIO,
                                      read_file_definition)
from htslib_tpu_torch.cram.refs import RefRegistry
from htslib_tpu_torch.cram.structs import (CT_COMPRESSION_HEADER,
                                           CT_FILE_HEADER, CT_MAPPED_SLICE,
                                           CT_UNMAPPED_SLICE)
from htslib_tpu_torch.sam.header import SamHeader
from htslib_tpu_torch.sam.record import BamRecord

CRAM_EOF_START = 0x454F46  # container ref_seq_start magic in EOF block


class CramReader:
    def __init__(self, src: Union[str, BinaryIO], ref: Optional[str] = None,
                 decode_md: bool = True):
        self.fp = open(src, "rb") if isinstance(src, str) else src
        self.version, self.file_id = read_file_definition(self.fp)
        self.io = CramIO(self.fp, self.version)
        self.header = self._read_sam_header()
        self.refs = RefRegistry(self.header, fasta=ref)
        self.decode_md = decode_md
        self._rec_queue: List[BamRecord] = []
        self._qi = 0
        self._eof = False

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
                                    decode_md=self.decode_md))
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

    def __next__(self) -> BamRecord:
        rec = self.read1()
        if rec is None:
            raise StopIteration
        return rec

    def read1(self) -> Optional[BamRecord]:
        while self._qi >= len(self._rec_queue):
            if self._eof or not self._next_container():
                self._eof = True
                return None
        rec = self._rec_queue[self._qi]
        self._qi += 1
        return rec

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
                 version=(3, 0), slices_per_container=1,
                 seqs_per_slice=10000, profile=None):
        self._enc = CramEncoder(dst, header, ref=ref, embed_ref=embed_ref,
                                lossy_names=lossy_names, version=version,
                                slices_per_container=slices_per_container,
                                seqs_per_slice=seqs_per_slice,
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
