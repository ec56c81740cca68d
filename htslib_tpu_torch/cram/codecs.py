"""CRAM record-level codecs (the port's copy of htslib_tpu/cram/codecs.py;
reference cram/cram_codecs.c).

Each codec reads either from the CORE block's MSB-first bit stream or from
an EXTERNAL byte stream identified by content id.  The decode state for a
slice is a SliceStreams object holding one cursor per block.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from htslib_tpu_torch.cram.itf8 import itf8_decode
from htslib_tpu_torch.cram.structs import (
    E_BETA, E_BYTE_ARRAY_LEN, E_BYTE_ARRAY_STOP, E_CONST_BYTE, E_CONST_INT,
    E_EXTERNAL, E_GAMMA, E_HUFFMAN, E_NULL,
    E_SUBEXP, E_VARINT_SIGNED, E_VARINT_UNSIGNED, E_XDELTA, E_XPACK, E_XRLE,
)
from htslib_tpu_torch.cram.v4 import (VarintVec, s7_decode, u7_decode,
                                      varint_vec)


class BitReader:
    """MSB-first bit reader over the CORE block
    (cram_codecs.c:73-259 get_bit_MSB/get_bits_MSB)."""

    __slots__ = ("data", "byte", "bit")

    def __init__(self, data: bytes):
        self.data = data
        self.byte = 0
        self.bit = 7

    def get_bit(self) -> int:
        b = (self.data[self.byte] >> self.bit) & 1
        if self.bit == 0:
            self.bit = 7
            self.byte += 1
        else:
            self.bit -= 1
        return b

    def get_bits(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.get_bit()
        return v


class ExternalStream:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def read_itf8(self) -> int:
        v, self.pos = itf8_decode(self.data, self.pos)
        return v

    def read_u7(self) -> int:
        v, self.pos = u7_decode(self.data, self.pos)
        return v

    def read_s7(self) -> int:
        v, self.pos = s7_decode(self.data, self.pos)
        return v

    def read_byte(self) -> int:
        b = self.data[self.pos]
        self.pos += 1
        return b

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        if len(out) < n:
            raise IOError("CRAM external block overrun")
        self.pos += n
        return out

    def read_to(self, stop: int) -> bytes:
        e = self.data.find(bytes([stop]), self.pos)
        if e < 0:
            # htslib tolerates a missing stop byte at end of block
            out = self.data[self.pos:]
            self.pos = len(self.data)
            return out
        out = self.data[self.pos:e]
        self.pos = e + 1
        return out


class SliceStreams:
    """Per-slice decode cursors: the core bit stream plus external byte
    streams keyed by content id."""

    def __init__(self, core: bytes, external: Dict[int, bytes]):
        self.core = BitReader(core)
        self.ext: Dict[int, ExternalStream] = {
            cid: ExternalStream(d) for cid, d in external.items()}
        # per-slice expanded streams of transform codecs (XPACK/XRLE/
        # XDELTA), keyed by codec identity — the slice->block_by_id[512+
        # codec_id] cache of the reference (cram_codecs.c:1376)
        self.expanded: Dict[int, ExternalStream] = {}

    def external(self, cid: int) -> ExternalStream:
        s = self.ext.get(cid)
        if s is None:
            raise IOError(f"CRAM: no external block with content id {cid}")
        return s


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

CORE_ID = -1  # sentinel for the CORE bit stream in block_ids()


class Codec:
    codec_id = E_NULL

    def block_ids(self) -> set:
        """Content ids this codec consumes (CORE_ID for the core bit
        stream) — the input to required-fields pruning
        (cram_dependent_data_series, cram_decode.c:553)."""
        return set()

    def read_int(self, st: SliceStreams) -> int:
        raise IOError(f"codec {type(self).__name__} cannot decode ints")

    def read_byte(self, st: SliceStreams) -> int:
        return self.read_int(st)

    def read_bytes(self, st: SliceStreams, n: int) -> bytes:
        """Read exactly n bytes (for seq fragments of known length)."""
        return bytes(self.read_byte(st) for _ in range(n))

    def read_array(self, st: SliceStreams) -> bytes:
        """Read a length-prefixed/terminated byte array (names, tags)."""
        raise IOError(f"codec {type(self).__name__} cannot decode arrays")


class NullCodec(Codec):
    codec_id = E_NULL

    def read_int(self, st):
        raise IOError("NULL codec used")


class ExternalCodec(Codec):
    codec_id = E_EXTERNAL

    def __init__(self, content_id: int, v4: bool = False):
        self.content_id = content_id
        self.v4 = v4

    def read_int(self, st: SliceStreams) -> int:
        s = st.external(self.content_id)
        return s.read_u7() if self.v4 else s.read_itf8()

    def read_byte(self, st: SliceStreams) -> int:
        return st.external(self.content_id).read_byte()

    def read_bytes(self, st: SliceStreams, n: int) -> bytes:
        return st.external(self.content_id).read(n)

    def get_block(self, st: SliceStreams) -> ExternalStream:
        """Whole-block access for transform codecs wrapping EXTERNAL
        (cram_external_get_block semantics)."""
        return st.external(self.content_id)

    def block_ids(self) -> set:
        return {self.content_id}


class VarintCodec(Codec):
    """E_VARINT_UNSIGNED / E_VARINT_SIGNED (CRAM 4; cram_codecs.c:760
    cram_varint_decode_init): uint7/sint7 varints in an external block,
    plus an offset so e.g. -2..1e6 avoids zigzag entirely."""

    def __init__(self, content_id: int, offset: int, signed: bool):
        self.codec_id = E_VARINT_SIGNED if signed else E_VARINT_UNSIGNED
        self.content_id = content_id
        self.offset = offset
        self.signed = signed

    def read_int(self, st: SliceStreams) -> int:
        s = st.external(self.content_id)
        v = s.read_s7() if self.signed else s.read_u7()
        return v + self.offset

    def get_block(self, st: SliceStreams) -> ExternalStream:
        return st.external(self.content_id)

    def block_ids(self) -> set:
        return {self.content_id}


class ConstCodec(Codec):
    """E_CONST_BYTE / E_CONST_INT (CRAM 4; cram_codecs.c:981): a constant
    decoded from the codec parameters, consuming no stream bytes."""

    def __init__(self, value: int, codec_id: int = E_CONST_INT):
        self.codec_id = codec_id
        self.value = value

    def read_int(self, st) -> int:
        return self.value

    def read_bytes(self, st, n: int) -> bytes:
        return bytes([self.value & 0xFF]) * n


class XPackCodec(Codec):
    """E_XPACK (cram_codecs.c:1453): 1/2/4-bit symbols packed into bytes
    by a sub-codec; expanded en-masse per slice (decode_expand_char)."""
    codec_id = E_XPACK

    def __init__(self, nbits: int, rmap: List[int], sub: Codec):
        self.nbits = nbits
        self.rmap = rmap
        self.sub = sub

    def block_ids(self) -> set:
        return self.sub.block_ids() | ({CORE_ID} if self.nbits else set())

    def _expand(self, st: SliceStreams) -> ExternalStream:
        key = id(self)
        s = st.expanded.get(key)
        if s is None:
            src = self.sub.get_block(st)
            data = src.data[src.pos:]
            if self.nbits == 0:
                out = bytes([self.rmap[0]])
            elif self.nbits == 8:
                out = bytes(data)
            else:
                per = 8 // self.nbits
                mask = (1 << self.nbits) - 1
                outb = bytearray(len(data) * per)
                i = 0
                for b in data:
                    for k in range(per - 1, -1, -1):
                        outb[i] = self.rmap[(b >> (k * self.nbits)) & mask]
                        i += 1
                out = bytes(outb)
            s = st.expanded[key] = ExternalStream(out)
        return s

    def read_byte(self, st: SliceStreams) -> int:
        return self._expand(st).read_byte()

    def read_bytes(self, st: SliceStreams, n: int) -> bytes:
        return self._expand(st).read(n)

    def read_int(self, st: SliceStreams) -> int:
        if self.nbits == 0:
            return self.rmap[0]
        return self.rmap[st.core.get_bits(self.nbits)]

    def get_block(self, st: SliceStreams) -> ExternalStream:
        return self._expand(st)


class XRleCodec(Codec):
    """E_XRLE (cram_codecs.c:2184): literals + run lengths for a declared
    symbol set; the length stream leads with a uint7 total output size."""
    codec_id = E_XRLE

    def __init__(self, rep_syms: set, len_codec: Codec, lit_codec: Codec):
        self.rep_syms = rep_syms
        self.len_codec = len_codec
        self.lit_codec = lit_codec

    def block_ids(self) -> set:
        return self.len_codec.block_ids() | self.lit_codec.block_ids()

    def _expand(self, st: SliceStreams) -> ExternalStream:
        key = id(self)
        s = st.expanded.get(key)
        if s is None:
            lit_s = self.lit_codec.get_block(st)
            lits = lit_s.data[lit_s.pos:]
            len_s = self.len_codec.get_block(st)
            lbuf = len_s.data
            lp = len_s.pos
            out_sz, lp = u7_decode(lbuf, lp)
            out = bytearray()
            for b in lits:
                if b in self.rep_syms:
                    run, lp = u7_decode(lbuf, lp)
                    out += bytes([b]) * (run + 1)
                else:
                    out.append(b)
                if len(out) >= out_sz:
                    break
            s = st.expanded[key] = ExternalStream(bytes(out[:out_sz]))
        return s

    def read_byte(self, st: SliceStreams) -> int:
        return self._expand(st).read_byte()

    def read_bytes(self, st: SliceStreams, n: int) -> bytes:
        return self._expand(st).read(n)

    def get_block(self, st: SliceStreams) -> ExternalStream:
        return self._expand(st)


class XDeltaCodec(Codec):
    """E_XDELTA (cram_codecs.c:1781): word-wise delta + zigzag transform
    stored as uint7 varints; decoded per array with the accumulator reset
    each call, words emitted little-endian and a leading partial word when
    the array length is not word-aligned (cram_xdelta_decode_block)."""
    codec_id = E_XDELTA

    def __init__(self, word_size: int, sub: Codec):
        self.word_size = word_size
        self.sub = sub

    def block_ids(self) -> set:
        return self.sub.block_ids()

    def read_bytes(self, st: SliceStreams, n: int) -> bytes:
        src = self.sub.get_block(st)
        w = self.word_size
        mask = (1 << (8 * w)) - 1
        npad = (w - n % w) % w
        out = bytearray()
        last = 0
        for _ in range(0, n + npad, w):
            z = src.read_u7()
            d = (z >> 1) ^ -(z & 1)
            last = (last + d) & mask
            out += int(last).to_bytes(w, "little")[:w - npad]
            npad = 0
        return bytes(out)

    def read_byte(self, st: SliceStreams) -> int:
        return self.read_bytes(st, 1)[0]


class HuffmanCodec(Codec):
    """Canonical Huffman (cram_codecs.c:2814).  The ubiquitous 0-bit
    single-symbol case decodes to a constant without touching streams."""
    codec_id = E_HUFFMAN

    def __init__(self, symbols: List[int], lengths: List[int]):
        codes = sorted(zip(lengths, symbols))
        self.codes: List[Tuple[int, int, int]] = []  # (len, code, symbol)
        val, last_len = -1, 0
        for ln, sym in codes:
            val += 1
            if ln > last_len:
                val <<= (ln - last_len)
                last_len = ln
            self.codes.append((ln, val, sym))
        self.constant = codes[0][1] if len(codes) == 1 and codes[0][0] == 0 else None
        # decode table: for each length, (first_code, first_index)
        self._by_len: Dict[int, Tuple[int, int]] = {}
        for i, (ln, code, sym) in enumerate(self.codes):
            if ln not in self._by_len:
                self._by_len[ln] = (code, i)

    def block_ids(self) -> set:
        return set() if self.constant is not None else {CORE_ID}

    def read_int(self, st: SliceStreams) -> int:
        if self.constant is not None:
            return self.constant
        length = 0
        val = 0
        while True:
            val = (val << 1) | st.core.get_bit()
            length += 1
            info = self._by_len.get(length)
            if info is not None:
                first_code, first_idx = info
                idx = first_idx + (val - first_code)
                if (idx < len(self.codes) and val >= first_code
                        and self.codes[idx][0] == length):
                    return self.codes[idx][2]
            if length > 31:
                raise IOError("corrupt huffman stream")


class BetaCodec(Codec):
    codec_id = E_BETA

    def __init__(self, offset: int, nbits: int):
        self.offset = offset
        self.nbits = nbits

    def block_ids(self) -> set:
        return {CORE_ID}

    def read_int(self, st: SliceStreams) -> int:
        return st.core.get_bits(self.nbits) - self.offset


class GammaCodec(Codec):
    codec_id = E_GAMMA

    def __init__(self, offset: int):
        self.offset = offset

    def block_ids(self) -> set:
        return {CORE_ID}

    def read_int(self, st: SliceStreams) -> int:
        nz = 0
        while st.core.get_bit() == 0:
            nz += 1
        val = 1
        for _ in range(nz):
            val = (val << 1) | st.core.get_bit()
        return val - 1 - self.offset


class SubexpCodec(Codec):
    codec_id = E_SUBEXP

    def __init__(self, offset: int, k: int):
        self.offset = offset
        self.k = k

    def block_ids(self) -> set:
        return {CORE_ID}

    def read_int(self, st: SliceStreams) -> int:
        i = 0
        while st.core.get_bit() == 1:
            i += 1
        if i == 0:
            n = st.core.get_bits(self.k)
        else:
            b = i + self.k - 1
            n = (1 << b) | st.core.get_bits(b)
        return n - self.offset


class ByteArrayLenCodec(Codec):
    codec_id = E_BYTE_ARRAY_LEN

    def __init__(self, len_codec: Codec, val_codec: Codec):
        self.len_codec = len_codec
        self.val_codec = val_codec

    def block_ids(self) -> set:
        return self.len_codec.block_ids() | self.val_codec.block_ids()

    def read_array(self, st: SliceStreams) -> bytes:
        n = self.len_codec.read_int(st)
        return self.val_codec.read_bytes(st, n)

    def read_bytes(self, st: SliceStreams, n: int) -> bytes:
        # fixed-length reads still honour the stored length
        return self.read_array(st)


class ByteArrayStopCodec(Codec):
    codec_id = E_BYTE_ARRAY_STOP

    def __init__(self, stop: int, content_id: int):
        self.stop = stop
        self.content_id = content_id

    def block_ids(self) -> set:
        return {self.content_id}

    def read_array(self, st: SliceStreams) -> bytes:
        return st.external(self.content_id).read_to(self.stop)

    def read_bytes(self, st: SliceStreams, n: int) -> bytes:
        return self.read_array(st)


def parse_encoding(buf, p: int,
                   vv: Optional[VarintVec] = None) -> Tuple[Optional[Codec], int]:
    """Parse one encoding{id, length, params} (spec section 3;
    cram_decode.c:144 walks these in the compression header).  The varint
    format of the id/length/params follows the file version's vtable
    (cram_decoder_init passes fd->vv through every *_decode_init)."""
    if vv is None:
        vv = varint_vec(3)
    codec_id, p = vv.get32(buf, p)
    nbytes, p = vv.get32(buf, p)
    end = p + nbytes
    if codec_id == E_NULL:
        return NullCodec(), end
    if codec_id == E_EXTERNAL:
        cid, p = vv.get32(buf, p)
        return ExternalCodec(cid, v4=vv.v4), end
    if codec_id == E_HUFFMAN:
        nsym, p = vv.get32(buf, p)
        syms = []
        for _ in range(nsym):
            v, p = vv.get32(buf, p)
            syms.append(v)
        nlen, p = vv.get32(buf, p)
        lens = []
        for _ in range(nlen):
            v, p = vv.get32(buf, p)
            lens.append(v)
        return HuffmanCodec(syms, lens), end
    if codec_id == E_BYTE_ARRAY_LEN:
        len_codec, p = parse_encoding(buf, p, vv)
        val_codec, p = parse_encoding(buf, p, vv)
        return ByteArrayLenCodec(len_codec, val_codec), end
    if codec_id == E_BYTE_ARRAY_STOP:
        stop = buf[p]
        p += 1
        cid, p = vv.get32(buf, p)
        return ByteArrayStopCodec(stop, cid), end
    if codec_id == E_BETA:
        offset, p = vv.get32(buf, p)
        nbits, p = vv.get32(buf, p)
        return BetaCodec(offset, nbits), end
    if codec_id == E_SUBEXP:
        offset, p = vv.get32(buf, p)
        k, p = vv.get32(buf, p)
        return SubexpCodec(offset, k), end
    if codec_id == E_GAMMA:
        offset, p = vv.get32(buf, p)
        return GammaCodec(offset), end
    if codec_id in (E_VARINT_UNSIGNED, E_VARINT_SIGNED):
        cid, p = vv.get32(buf, p)
        offset, p = vv.get64s(buf, p)
        return VarintCodec(cid, offset, codec_id == E_VARINT_SIGNED), end
    if codec_id == E_CONST_BYTE:
        v, p = vv.get64s(buf, p)
        return ConstCodec(v, E_CONST_BYTE), end
    if codec_id == E_CONST_INT:
        v, p = vv.get64s(buf, p)
        return ConstCodec(v, E_CONST_INT), end
    if codec_id == E_XPACK:
        nbits, p = vv.get32(buf, p)
        nval, p = vv.get32(buf, p)
        if not (0 <= nbits <= 8) or not (0 <= nval <= 256):
            raise IOError("malformed XPACK parameters")
        rmap = []
        for _ in range(nval):
            v, p = vv.get32(buf, p)
            rmap.append(v & 0xFF)
        sub, p = parse_encoding(buf, p, vv)
        return XPackCodec(nbits, rmap, sub), end
    if codec_id == E_XRLE:
        nrle, p = vv.get32(buf, p)
        rep = set()
        for _ in range(nrle):
            v, p = vv.get32(buf, p)
            rep.add(v & 0xFF)
        len_codec, p = parse_encoding(buf, p, vv)
        lit_codec, p = parse_encoding(buf, p, vv)
        return XRleCodec(rep, len_codec, lit_codec), end
    if codec_id == E_XDELTA:
        word_size, p = vv.get32(buf, p)
        sub, p = parse_encoding(buf, p, vv)
        return XDeltaCodec(word_size, sub), end
    raise IOError(f"unsupported CRAM encoding id {codec_id}")
