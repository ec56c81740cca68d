"""Device-side BGZF write path: stored blocks whose CRC32 is computed on
the card, and uniform-length dynamic-Huffman DEFLATE blocks whose codes
are packed on the card.

Port of htslib_tpu/ops/bgzf_device.py: `bgzf_stored_device` (:107),
`deflate_uniform_device` (:268) and `crc_device_rate` (:373), with the
same arguments (`interpret` replaced by `device`), outputs and
`timing` / `stats` dicts.  Their two XLA programs are plain torch ops
here (no Pallas kernel stands behind them):

- the CRC (`_crc_kernel`, :72): CRC32 over GF(2) is linear, so a block's
  CRC is crc0(n) XOR the contributions D[i, b] of its set bits (message
  bit b of byte i carried through the remaining zero-byte steps).  One
  masked select, then an XOR reduce; PyTorch has no XOR reduction, so the
  selected words are XOR-halved (padded to a power of two).  The select
  holds 32 bytes per input byte, so blocks go through in chunks
  (`CRC_CHUNK_BLOCKS`), which bounds the memory at a few hundred MB;
- the code packing (`_pack_kernel`, :231): a compare-sum rank of each
  byte in the block's sorted symbol set (its canonical code index), an
  L-bit reversal, and a fixed-stride shift-OR of 32 codes into L words.

What is host code in JAX stays host code: the dynamic-block header, the
bit merge of header, codes and EOB, the BGZF framing, the tail block's
CRC and `deflate_uniform_device`'s per-block `zlib.crc32`.  Every output
is byte-valid BGZF (gzip-decodable), ending in the BGZF EOF block.
"""
from __future__ import annotations

import functools
import struct
import time
import zlib
from typing import List, Tuple

import numpy as np
import torch

from htslib_tpu_torch import _build

CHUNK = 0xff00          # uncompressed bytes per BGZF block (65280)
CRC_CHUNK_BLOCKS = 64   # blocks a CRC pass takes at once (~270 MB)
EOF_BLOCK = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

_CRC_POLY = 0xEDB88320


@functools.lru_cache(maxsize=None)
def _crc_table() -> np.ndarray:
    t = np.zeros(256, np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (_CRC_POLY if c & 1 else 0)
        t[i] = c
    return t


@functools.lru_cache(maxsize=None)
def _crc_bit_contrib(n: int = CHUNK) -> Tuple[np.ndarray, int]:
    """(D [n, 8] uint32, crc0) such that
    crc32(m) == crc0 ^ XOR over set bits (i, b) of D[i, b]: bit b at byte
    i contributes T[1 << b] evolved through the n-1-i zero-byte steps
    r' = r >> 8 ^ T[r & 0xFF] (the table is GF(2)-linear)."""
    T = _crc_table()
    D = np.zeros((n, 8), np.uint32)
    cur = T[1 << np.arange(8)].copy()          # effect at the last byte
    for i in range(n - 1, -1, -1):
        D[i] = cur
        cur = (cur >> 8) ^ T[cur & 0xFF]
    # crc of n zero bytes with the standard init/final inversion
    return D, zlib.crc32(b"\0" * n) & 0xFFFFFFFF


def _crc_blocks(blocks: torch.Tensor, D: torch.Tensor,
                crc0: int) -> torch.Tensor:
    """CRC32 of each row of blocks u8 [N, n] from the contributions D
    int32 [n, 8] (u32 bits): int64 [N].  XOR over the set bits' words, by
    halving, CRC_CHUNK_BLOCKS rows at a time."""
    N, n = blocks.shape
    dev = blocks.device
    width = 1 << (8 * n - 1).bit_length()
    shifts = torch.arange(8, dtype=torch.int32, device=dev)
    out = torch.empty(N, dtype=torch.int64, device=dev)
    for lo in range(0, N, CRC_CHUNK_BLOCKS):
        rows = blocks[lo:lo + CRC_CHUNK_BLOCKS]
        bits = ((rows.int()[:, :, None] >> shifts) & 1) != 0
        acc = torch.zeros((rows.shape[0], width), dtype=torch.int32,
                          device=dev)
        acc[:, :8 * n] = torch.where(bits, D[None], 0).reshape(
            rows.shape[0], -1)
        while acc.shape[1] > 1:
            half = acc.shape[1] // 2
            acc = torch.bitwise_xor(acc[:, :half], acc[:, half:])
        out[lo:lo + rows.shape[0]] = (acc[:, 0].long() & 0xFFFFFFFF) ^ crc0
    return out


def _bgzf_stored_frame(payload: bytes, crc: int) -> bytes:
    """One complete BGZF block around a raw payload (bgzf.c header
    layout + stored DEFLATE)."""
    n = len(payload)
    if n > CHUNK:
        raise ValueError("a BGZF block holds at most 65280 bytes")
    bsize = 18 + 5 + n + 8          # total block size
    hdr = struct.pack(
        "<BBBBIBBHBBHH",
        0x1f, 0x8b, 8, 4,            # gzip magic, DEFLATE, FEXTRA
        0, 0, 0xff,                  # mtime, xfl, os
        6,                           # xlen
        66, 67, 2,                   # 'B' 'C' slen
        bsize - 1)
    deflate = struct.pack("<BHH", 0x01, n, (~n) & 0xFFFF)
    foot = struct.pack("<II", crc & 0xFFFFFFFF, n)
    return hdr + deflate + payload + foot


def bgzf_stored_device(data: bytes, device="cuda",
                       timing: dict = None) -> bytes:
    """Whole-buffer BGZF compress (level-0 stored blocks), CRC32 of the
    full blocks on the device, byte-valid output inflatable by any gzip
    reader; appends the standard BGZF EOF block.  `timing` gets the full
    blocks' count and the seconds of their CRCs (upload, compute and
    download), as in JAX."""
    dev = _build.resolve_device(device)
    n = len(data)
    n_full = n // CHUNK
    out = []
    if n_full:
        D, crc0 = _crc_bit_contrib(CHUNK)
        blocks = np.frombuffer(data, np.uint8,
                               n_full * CHUNK).reshape(n_full, CHUNK)
        t0 = time.time()
        crcs = _crc_blocks(torch.from_numpy(np.array(blocks)).to(dev),
                           torch.from_numpy(D.view(np.int32)).to(dev),
                           crc0).cpu().numpy()
        dt = time.time() - t0
        if timing is not None:
            timing["crc_blocks"] = n_full
            timing["crc_s"] = dt
        for i in range(n_full):
            out.append(_bgzf_stored_frame(blocks[i].tobytes(), int(crcs[i])))
    tail = data[n_full * CHUNK:]
    if tail:
        out.append(_bgzf_stored_frame(tail, zlib.crc32(tail)))
    out.append(EOF_BLOCK)
    return b"".join(out)


# ---------------------------------------------------------------------------
# Uniform-length dynamic-Huffman DEFLATE: every used literal (plus EOB and
# enough padding literals to make the tree complete) gets the same code
# length L = ceil(log2(m)), so packing is a fixed-stride shift pattern and
# the symbol -> code map a rank.  Blocks whose alphabet needs L >= 8 are
# stored.  The header (RFC 1951 section 3.2.7) is built on the host.
# ---------------------------------------------------------------------------

def _bitrev(v, nbits: int):
    """The nbits low bits of each value reversed (numpy or torch)."""
    out = v * 0
    for i in range(nbits):
        out |= ((v >> i) & 1) << (nbits - 1 - i)
    return out


class _BitWriter:
    def __init__(self):
        self.bits: List[int] = []

    def put(self, value: int, n: int):
        for i in range(n):                 # LSB first (RFC 1951 3.1.1)
            self.bits.append((value >> i) & 1)

    def put_code(self, code: int, length: int):
        for i in range(length - 1, -1, -1):    # Huffman codes MSB first
            self.bits.append((code >> i) & 1)

    def tobytes_and_len(self):
        out = bytearray((len(self.bits) + 7) // 8)
        for i, b in enumerate(self.bits):
            out[i >> 3] |= b << (i & 7)
        return bytes(out), len(self.bits)


_CLCIDX = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1,
           15]


def _dyn_header(sorted_syms: np.ndarray, L: int) -> Tuple[bytes, int]:
    """RFC 1951 dynamic-block header for a complete uniform-L litlen
    tree over `sorted_syms` (which includes 256) + one 1-bit distance
    code.  Returns (header bytes, bit length)."""
    nlit = 257 if int(sorted_syms[-1]) == 256 else int(sorted_syms[-1]) + 1
    lit_lens = np.zeros(nlit, np.int32)
    lit_lens[sorted_syms[sorted_syms < nlit]] = L
    if int(sorted_syms[-1]) == 256:
        lit_lens[256] = L
    dist_lens = np.array([1], np.int32)     # single 1-bit distance code
    all_lens = np.concatenate([lit_lens, dist_lens])
    # code-length alphabet: used lengths {0, L, 1}, each of the same
    # length Lc, padded with unused CL symbols to a complete tree
    used_cl = sorted(set(int(x) for x in all_lens))
    mc = len(used_cl)
    Lc = max(1, (mc - 1).bit_length())
    pad_needed = (1 << Lc) - mc
    pool = [s for s in range(19) if s not in used_cl]
    cl_syms = sorted(used_cl + pool[:pad_needed])
    cl_len = {s: Lc for s in cl_syms}
    cl_code = {s: i for i, s in enumerate(cl_syms)}
    # HCLEN covers CL symbols in the permuted order up to the last used
    cl_lens_perm = [cl_len.get(s, 0) for s in _CLCIDX]
    last = max(i for i, l in enumerate(cl_lens_perm) if l) + 1
    hclen = max(last, 4)

    w = _BitWriter()
    w.put(1, 1)                 # BFINAL
    w.put(2, 2)                 # BTYPE = 10 (dynamic)
    w.put(nlit - 257, 5)
    w.put(0, 5)                 # HDIST: 1 distance code
    w.put(hclen - 4, 4)
    for i in range(hclen):
        w.put(cl_lens_perm[i], 3)
    for l in all_lens:          # plain per-symbol lengths, no 16/17/18
        w.put_code(cl_code[int(l)], Lc)
    return w.tobytes_and_len()


def _pack_codes(data: torch.Tensor, sset: torch.Tensor, L: int
                ) -> torch.Tensor:
    """Bytes data [n] (n a multiple of 32) and the sorted symbol set sset
    [2^L - 1] (without EOB) -> packed code words int64 [n * L / 32] (u32
    values: bit i of the code stream at word i >> 5, bit i & 31)."""
    G = 32                         # codes per pack group: G*L bits
    W = G * L // 32                # whole u32 words per group
    rank = (data.long()[:, None] > sset[None, :]).sum(1)
    g = _bitrev(rank, L).reshape(-1, G)
    words = []
    for w in range(W):
        acc = torch.zeros(g.shape[0], dtype=torch.int64, device=g.device)
        for i in range(G):
            lo_bit = i * L - 32 * w
            if lo_bit <= -L or lo_bit >= 32:
                continue
            acc |= (g[:, i] << lo_bit) if lo_bit >= 0 else \
                (g[:, i] >> (-lo_bit))
        words.append(acc & 0xFFFFFFFF)
    return torch.stack(words, 1).reshape(-1)


def deflate_uniform_device(data: bytes, device="cuda",
                           stats: dict = None) -> bytes:
    """BGZF compress with entropy-coded (dynamic-Huffman) DEFLATE blocks
    whose codes are packed on the device: uniform-L complete trees,
    fixed-stride packing.  Blocks whose alphabet needs L >= 8 are stored.
    Output is byte-valid BGZF (gzip-decodable).  `stats` gets the counts
    of Huffman and stored blocks."""
    dev = _build.resolve_device(device)
    out = []
    n_huff = n_stored = 0
    for off in range(0, max(len(data), 1), CHUNK):
        payload = data[off:off + CHUNK]
        if not payload and data:
            break
        arr = np.frombuffer(payload, np.uint8)
        syms = np.unique(arr) if len(arr) else np.array([], np.int64)
        m = len(syms) + 1                  # + EOB
        L = max(1, (m - 1).bit_length())
        crc = zlib.crc32(payload) & 0xFFFFFFFF
        if L >= 8 or len(arr) == 0:
            out.append(_bgzf_stored_frame(payload, crc))
            n_stored += 1
            continue
        # complete tree: pad with unused byte values
        pool = np.setdiff1d(np.arange(256), syms)
        pad = pool[:(1 << L) - m]
        sset = np.sort(np.concatenate(
            [syms, pad, [256]]).astype(np.int64))
        hdr_bits, hdr_nbits = _dyn_header(sset, L)
        # device pack (codes padded to a multiple of 32)
        n_pad = ((len(arr) + 31) // 32) * 32
        padded = np.zeros(n_pad, np.uint8)
        padded[:len(arr)] = arr
        padded[len(arr):] = pad[0] if len(pad) else syms[0]
        words = _pack_codes(torch.from_numpy(padded).to(dev),
                            torch.from_numpy(sset[:-1]).to(dev), L)
        code_bytes = words.cpu().numpy().astype("<u4").tobytes()
        total_code_bits = len(arr) * L
        # assemble the bitstream: header || codes || EOB (host bit-merge),
        # the device code stream shifted by the header's bitpos & 7
        stream = bytearray(hdr_bits)
        bitpos = hdr_nbits
        sh = bitpos & 7
        nbytes_codes = (total_code_bits + 7) // 8
        cb = np.frombuffer(code_bytes, np.uint8)[:nbytes_codes + 1]
        cb = np.concatenate([cb, np.zeros(2, np.uint8)])
        shifted = ((cb.astype(np.uint16) << sh)
                   | (np.concatenate([[0], cb[:-1]]).astype(np.uint16)
                      >> (8 - sh)) if sh else cb.astype(np.uint16))
        shifted = (shifted & 0xFF).astype(np.uint8)
        base = bitpos >> 3
        need = base + (total_code_bits + sh + 7) // 8
        while len(stream) < need:
            stream.append(0)
        np_stream = np.frombuffer(bytes(stream), np.uint8).copy()
        seg_len = (total_code_bits + sh + 7) // 8
        merged = np_stream[base:base + seg_len].copy()
        merged |= shifted[:seg_len]
        # clear stray bits of padding codes past the real code stream
        tail_bits = (sh + total_code_bits) & 7
        if tail_bits:
            merged[-1] &= (1 << tail_bits) - 1
        np_stream[base:base + seg_len] = merged
        stream = bytearray(np_stream.tobytes())
        bitpos = (base * 8) + sh + total_code_bits
        # the EOB code (MSB first = reversed value written LSB-wise)
        for i in range(L - 1, -1, -1):
            if (bitpos >> 3) >= len(stream):
                stream.append(0)
            stream[bitpos >> 3] |= (((1 << L) - 1) >> i & 1) \
                << (bitpos & 7)
            bitpos += 1
        deflate = bytes(stream[:(bitpos + 7) // 8])
        n = len(payload)
        bsize = 18 + len(deflate) + 8
        hdr = struct.pack("<BBBBIBBHBBHH", 0x1f, 0x8b, 8, 4, 0, 0, 0xff, 6,
                          66, 67, 2, bsize - 1)
        out.append(hdr + deflate + struct.pack("<II", crc, n))
        n_huff += 1
    out.append(EOF_BLOCK)
    if stats is not None:
        stats["huffman_blocks"] = n_huff
        stats["stored_blocks"] = n_stored
    return b"".join(out)


def crc_device_rate(n_blocks: int = 64, reps: int = 3,
                    device="cuda") -> dict:
    """Steady-state device CRC32 rate with resident inputs (the compute
    half of the stored-block write path): `exact` (the first four CRCs
    equal zlib's), blocks/s, MB/s and seconds a pass, on the host clock
    around passes that end in their download, as in JAX."""
    dev = _build.resolve_device(device)
    rng = np.random.RandomState(5)
    blocks = rng.randint(0, 256, (n_blocks, CHUNK), dtype=np.uint8)
    D, crc0 = _crc_bit_contrib(CHUNK)
    bd = torch.from_numpy(blocks).to(dev)
    Dd = torch.from_numpy(D.view(np.int32)).to(dev)
    crcs = _crc_blocks(bd, Dd, crc0).cpu().numpy()   # warm + sync
    want = np.array([zlib.crc32(blocks[i].tobytes()) & 0xFFFFFFFF
                     for i in range(min(4, n_blocks))], np.int64)
    exact = bool((crcs[:len(want)] == want).all())
    t0 = time.time()
    for _ in range(reps):
        crcs = _crc_blocks(bd, Dd, crc0).cpu().numpy()
    dt = (time.time() - t0) / reps
    total = n_blocks * CHUNK
    return {"exact": exact, "blocks_per_s": round(n_blocks / dt, 1),
            "MBps": round(total / dt / 1e6, 1), "seconds": round(dt, 4)}
