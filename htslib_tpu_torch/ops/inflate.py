"""DEFLATE inflate of batches of independent members on the card (kernel
X4): the BGZF read side, in front of the BAM record path.

Port of htslib_tpu/ops/inflate.py: `inflate_batch` (:529).  The JAX
function decodes a batch with two jitted XLA passes (`_compiled`, :429):
pass A, a lockstep state machine in which every member advances one
DEFLATE item a step (`lax.while_loop` of 512-step `lax.scan` chunks, the
dynamic code tables rebuilt between chunks), then pass B, which resolves
the token list into bytes by cumsum, scatter and pointer doubling.  Run
eagerly, each of pass A's ~100 elementwise ops a step would be a launch,
tens of thousands of steps a member, so the port hand-writes the decoder
instead: one launch decodes every member serially in one warp each
(csrc/inflate.cu, csrc/inflate_step.cuh), with the JAX function's bytes
and errors, in one of two variants that keep the output window that
matches read in shared memory or in the member's slot (`ring_fits`).

`inflate` launches the kernel for a batch on the card and takes the plain
PyTorch version (`inflate_plain`: the JAX function's two passes as tensor
ops, step for step) for one on the CPU.

Errors are the JAX function's: ValueError("device inflate: corrupt stream
i") for the first member i whose decode JAX marks in error (a step that
begins past the payload's end, block type 3, a code with no entry, a
literal/length symbol of 286 or more, 65,552 tokens, the 512 x 512 step
cap) or whose output is not its ISIZE; see csrc/inflate_step.cuh for what
JAX does not check.  ISIZE is at most 64 KiB (a BGZF member); a larger one
gives its first 64 KiB, as in JAX.  Payloads past 128 KiB are outside the
JAX token format's reach (a stored run's offset has 17 bits); BGZF's are
at most 64 KiB.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from htslib_tpu_torch import _build
from htslib_tpu_torch.ops.bgzf_device import _bitrev
from htslib_tpu_torch.ops.rans_nx16 import exclusive_cumsum, pack_payloads

MAXBITS = 15
TBL = 1 << MAXBITS
OUT_MAX = 1 << 16          # BGZF ISIZE bound
MAX_TOK = OUT_MAX + 16     # literals + stored runs + slack
LENS_MAX = 320             # 288 litlen + 32 dist code lengths
NCODE_MAX = 320
CHUNK = 512                # steps between table builds
MAX_ROUNDS = 512           # chunks before the step cap
_U32 = 0xFFFFFFFF

PH_HDR, PH_PRE, PH_LENS, PH_BUILD, PH_SYM, PH_STORED, PH_DONE = range(7)

# RFC 1951 section 3.2.5 length/distance code tables (as the JAX package's)
LENGTH_BASE = [3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35,
               43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258, 0, 0]
LENGTH_EXTRA = [0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                4, 4, 4, 4, 5, 5, 5, 5, 0, 0, 0]
DIST_BASE = [1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257,
             385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289,
             16385, 24577, 0, 0]
DIST_EXTRA = [0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9,
              9, 10, 10, 11, 11, 12, 12, 13, 13, 0, 0]
# precode length order (section 3.2.7)
CLCIDX = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]
# fixed-Huffman code lengths as (value, repeat) runs (section 3.2.6)
FIXED_CODE_VALS = [8, 9, 7, 8, 5]
FIXED_CODE_REPS = [144, 112, 24, 8, 32]


@dataclass
class InflateBatch:
    """Members framed for inflate, all tensors on one device."""
    payload: torch.Tensor  # u8: payloads back to back, each 4-byte aligned
    in_off: torch.Tensor   # int64 [B]: each payload's first byte
    in_len: torch.Tensor   # int32 [B]: bytes in each payload
    isize: torch.Tensor    # int64 [B]: each member's expected output size
    out_off: torch.Tensor  # int64 [B]: each member's first output byte
    out_cap: torch.Tensor  # int32 [B]: min(ISIZE, 64 KiB), its output slot

    @property
    def n_members(self) -> int:
        return int(self.in_len.shape[0])

    @property
    def total_out(self) -> int:
        return int(self.out_cap.sum())

    def to(self, device) -> "InflateBatch":
        return InflateBatch(*(getattr(self, f.name).to(device)
                              for f in fields(self)))


def frame_members(payloads: Sequence[bytes], isizes: Sequence[int],
                  device) -> InflateBatch:
    """Payloads (raw DEFLATE) and their ISIZEs -> an `InflateBatch`."""
    arrs = [np.frombuffer(p, np.uint8) for p in payloads]
    buf, word_off, _ = pack_payloads(arrs, 4)
    isize = np.asarray(isizes, np.int64).reshape(-1)
    if len(isize) != len(arrs):
        raise ValueError("one ISIZE a payload")
    cap = np.clip(isize, 0, OUT_MAX)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return InflateBatch(dev(buf), dev(4 * word_off),
                        dev(np.array([len(a) for a in arrs], np.int32)),
                        dev(isize), dev(exclusive_cumsum(cap)),
                        dev(cap.astype(np.int32)))


# ---------------------------------------------------------------------------
# The plain version: the JAX function's passes as tensor ops
# ---------------------------------------------------------------------------

def _fetch32(words: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """32 bits of each row's stream from bit p on (LSB-first); the word
    index clamps to the padded end, as in JAX."""
    w = (p >> 5).clamp(0, words.shape[1] - 2)
    o = p & 31
    lo = words.gather(1, w[:, None])[:, 0]
    hi = words.gather(1, (w + 1)[:, None])[:, 0]
    return ((lo >> o) | torch.where(o == 0, 0, hi << (32 - o))) & _U32


def _take(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return tbl.gather(1, idx[:, None])[:, 0]


def _canon(lens: torch.Tensor, nsym: int, maxbits: int,
           rev: torch.Tensor) -> torch.Tensor:
    """Canonical lookup [B, 2^maxbits] of code lengths lens [B, nsym]:
    entries (l << 9) | sym for the shortest length l whose range holds
    the window's first l bits; 0 where none does."""
    B = lens.shape[0]
    dev = lens.device
    cnt = torch.zeros((B, MAXBITS + 1), dtype=torch.long, device=dev)
    cnt.scatter_add_(1, lens, (lens > 0).long())
    first = [torch.zeros(B, dtype=torch.long, device=dev)]
    code = torch.zeros(B, dtype=torch.long, device=dev)
    for l in range(1, maxbits + 1):
        code = (code + cnt[:, l - 1]) << 1
        first.append(code)
    sym_base = torch.cumsum(cnt, 1) - cnt
    s_i = torch.arange(nsym, device=dev)[None, :]
    key = torch.where(lens > 0, lens * 1024 + s_i, 1 << 30)
    order = torch.argsort(key, dim=1, stable=True)
    entry = torch.zeros((B, 1 << maxbits), dtype=torch.long, device=dev)
    chosen = torch.zeros((B, 1 << maxbits), dtype=torch.bool, device=dev)
    for l in range(1, maxbits + 1):
        c = rev[None, :] >> (maxbits - l)
        off = c - first[l][:, None]
        ok = ~chosen & (off >= 0) & (off < cnt[:, l][:, None])
        idx = (sym_base[:, l][:, None] + off).clamp(0, nsym - 1)
        entry = torch.where(ok, (l << 9) | order.gather(1, idx), entry)
        chosen |= ok
    return entry


class _PassA:
    """Pass A's state over a batch (the JAX `st` tuple) and its two
    functions, `build_tables` and `step`, each as in JAX."""

    def __init__(self, words: torch.Tensor, end_bits: torch.Tensor):
        B = words.shape[0]
        dev = words.device

        def z(*shape, dtype=torch.long):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def t(values):
            return torch.tensor(values, dtype=torch.long, device=dev)

        self.words, self.end_bits = words, end_bits
        self.p, self.bfinal, self.hlit, self.hdist = z(B), z(B), z(B), z(B)
        self.phase = torch.full((B,), PH_HDR, dtype=torch.long, device=dev)
        self.code_vals, self.code_reps = z(B, NCODE_MAX), z(B, NCODE_MAX)
        self.ncodes, self.stored_off, self.stored_rem = z(B), z(B), z(B)
        self.tok_cnt = z(B)
        # one spare column takes the writes JAX drops
        self.tokens = z(B, MAX_TOK + 1, dtype=torch.int32)
        self.lit_tbl, self.dst_tbl = z(B, TBL), z(B, TBL)
        self.err = z(B, dtype=torch.bool)
        self.rows = torch.arange(B, device=dev)
        self.rev15 = _bitrev(torch.arange(TBL, device=dev), MAXBITS)
        self.rev7 = self.rev15[:128] >> 8
        self.lb, self.lx = t(LENGTH_BASE), t(LENGTH_EXTRA)
        self.db, self.dx = t(DIST_BASE), t(DIST_EXTRA)
        # the fixed code's runs as JAX records them, in rows of NCODE_MAX
        self.fixed_vals, self.fixed_reps = z(NCODE_MAX), z(NCODE_MAX)
        self.fixed_vals[:5] = t(FIXED_CODE_VALS)
        self.fixed_reps[:5] = t(FIXED_CODE_REPS)

    def fetch(self, p):
        return _fetch32(self.words, p)

    def build_tables(self):
        """Expand the recorded code-length runs and build the tables of
        every member parked in PH_BUILD."""
        mask = self.phase == PH_BUILD
        if not bool(mask.any()):
            return
        B = self.p.shape[0]
        dev = self.p.device
        ci = torch.arange(NCODE_MAX, device=dev)[None, :]
        valid = ci < self.ncodes[:, None]
        reps = torch.where(valid, self.code_reps, 0)
        ends = torch.cumsum(reps, 1)
        starts = ends - reps
        vals = self.code_vals
        base_val = torch.where(vals <= 15, vals, 0)
        non16 = (vals != 16) & valid
        lastn16 = torch.cummax(torch.where(non16, ci, -1), 1).values
        emit = torch.where(lastn16 >= 0,
                           base_val.gather(1, lastn16.clamp(min=0)), 0)
        starts_c = torch.where(valid & (reps > 0), starts, LENS_MAX)
        cover = torch.full((B, LENS_MAX), -1, dtype=torch.long, device=dev)
        cover.scatter_reduce_(1, starts_c.clamp(max=LENS_MAX - 1),
                              torch.where(starts_c < LENS_MAX, ci, -1)
                              .expand(B, -1), "amax")
        cover = torch.cummax(cover, 1).values
        li = torch.arange(LENS_MAX, device=dev)[None, :]
        nlens = (self.hlit + 257) + (self.hdist + 1)
        lens = torch.where((cover >= 0) & (li < nlens[:, None]),
                           emit.gather(1, cover.clamp(min=0)), 0)
        nlit = self.hlit + 257
        lit_lens = torch.where(li[:, :288] < nlit[:, None], lens[:, :288], 0)
        j32 = torch.arange(32, device=dev)[None, :]
        dst_lens = torch.where(
            j32 < (self.hdist + 1)[:, None],
            lens.gather(1, (j32 + nlit[:, None]).clamp(max=LENS_MAX - 1)), 0)
        self.lit_tbl = torch.where(mask[:, None],
                                   _canon(lit_lens, 288, MAXBITS, self.rev15),
                                   self.lit_tbl)
        self.dst_tbl = torch.where(mask[:, None],
                                   _canon(dst_lens, 32, MAXBITS, self.rev15),
                                   self.dst_tbl)
        self.phase = torch.where(mask, PH_SYM, self.phase)

    def step(self):
        """One lockstep step of every member (JAX's `step`); each phase's
        block runs only where some member is in that phase, which changes
        nothing: the JAX block is masked by it."""
        B = self.p.shape[0]
        rows = self.rows
        wini = self.fetch(self.p)
        overrun = self.p > self.end_bits
        self.err |= overrun & (self.phase != PH_DONE)
        self.phase = torch.where(overrun, PH_DONE, self.phase)
        emit = torch.zeros(B, dtype=torch.bool, device=self.p.device)
        emit_tok = torch.zeros(B, dtype=torch.long, device=self.p.device)

        in_hdr = self.phase == PH_HDR
        if bool(in_hdr.any()):
            h_bfinal = wini & 1
            btype = (wini >> 1) & 3
            pb = (self.p + 3 + 7) & ~7
            st_len = self.fetch(pb) & 0xFFFF
            hdr_err = in_hdr & (btype == 3)
            sel_stored = in_hdr & (btype == 0)
            sel_fixed = in_hdr & (btype == 1)
            sel_dyn = in_hdr & (btype == 2)
            self.bfinal = torch.where(in_hdr, h_bfinal, self.bfinal)
            self.phase = torch.where(sel_stored, PH_STORED, self.phase)
            self.stored_off = torch.where(sel_stored, (pb + 32) >> 3,
                                          self.stored_off)
            self.stored_rem = torch.where(sel_stored, st_len, self.stored_rem)
            self.p = torch.where(sel_stored, pb + 32, self.p)
            self.code_vals = torch.where(sel_fixed[:, None],
                                         self.fixed_vals[None, :],
                                         self.code_vals)
            self.code_reps = torch.where(sel_fixed[:, None],
                                         self.fixed_reps[None, :],
                                         self.code_reps)
            self.ncodes = torch.where(sel_fixed, 5, self.ncodes)
            self.hlit = torch.where(sel_fixed, 31, self.hlit)
            self.hdist = torch.where(sel_fixed, 31, self.hdist)
            self.phase = torch.where(sel_fixed, PH_BUILD, self.phase)
            self.p = torch.where(sel_fixed, self.p + 3, self.p)
            self.hlit = torch.where(sel_dyn, (wini >> 3) & 31, self.hlit)
            self.hdist = torch.where(sel_dyn, (wini >> 8) & 31, self.hdist)
            # hclen stashed in stored_rem, as in JAX
            self.stored_rem = torch.where(sel_dyn, (wini >> 13) & 15,
                                          self.stored_rem)
            self.phase = torch.where(sel_dyn, PH_PRE, self.phase)
            self.p = torch.where(sel_dyn, self.p + 17, self.p)
            self.err |= hdr_err
            self.phase = torch.where(hdr_err, PH_DONE, self.phase)

        in_pre = self.phase == PH_PRE
        if bool(in_pre.any()):
            self._pre(in_pre)

        in_lens = self.phase == PH_LENS
        if bool(in_lens.any()):
            wl = self.fetch(self.p)
            pe = _take(self.dst_tbl, wl & 127)
            pe_bits = pe >> 9
            pe_sym = pe & 511
            lens_err = in_lens & (pe_bits == 0)
            after = self.fetch(self.p + pe_bits)
            r16, r17, r18 = pe_sym == 16, pe_sym == 17, pe_sym == 18
            rep = torch.where(r16, 3 + (after & 3), torch.where(
                r17, 3 + (after & 7), torch.where(r18, 11 + (after & 127),
                                                  1)))
            extra = torch.where(r16, 2, torch.where(r17, 3, torch.where(
                r18, 7, 0)))
            nidx = self.ncodes.clamp(max=NCODE_MAX - 1)
            self.code_vals[rows, nidx] = torch.where(
                in_lens, pe_sym, self.code_vals[rows, nidx])
            self.code_reps[rows, nidx] = torch.where(
                in_lens, rep, self.code_reps[rows, nidx])
            self.ncodes = self.ncodes + in_lens.long()
            self.stored_rem = torch.where(in_lens, self.stored_rem + rep,
                                          self.stored_rem)
            self.p = torch.where(in_lens, self.p + pe_bits + extra, self.p)
            done = in_lens & (self.stored_rem >= self.hlit + 257
                              + self.hdist + 1)
            self.phase = torch.where(done, PH_BUILD, self.phase)
            self.err |= lens_err
            self.phase = torch.where(lens_err, PH_DONE, self.phase)

        in_stored = self.phase == PH_STORED
        if bool(in_stored.any()):
            chunk = self.stored_rem.clamp(max=8191)
            stok = -(1 << 31) | (self.stored_off << 13) | chunk
            do_emit = in_stored & (chunk > 0)
            emit_tok = torch.where(do_emit, stok, emit_tok)
            emit |= do_emit
            self.stored_off = torch.where(in_stored, self.stored_off + chunk,
                                          self.stored_off)
            self.stored_rem = torch.where(in_stored, self.stored_rem - chunk,
                                          self.stored_rem)
            self.p = torch.where(in_stored, self.p + (chunk << 3), self.p)
            st_done = in_stored & (self.stored_rem <= 0)
            self.phase = torch.where(st_done & (self.bfinal == 1), PH_DONE,
                                     self.phase)
            self.phase = torch.where(st_done & (self.bfinal == 0), PH_HDR,
                                     self.phase)

        in_sym = self.phase == PH_SYM
        if bool(in_sym.any()):
            le = _take(self.lit_tbl, wini & (TBL - 1))
            le_bits = le >> 9
            le_sym = le & 511
            sym_err = in_sym & (le_bits == 0)
            p1 = self.p + le_bits
            is_lit = in_sym & (le_sym < 256)
            is_eob = in_sym & (le_sym == 256)
            is_len = in_sym & (le_sym > 256) & (le_sym < 286)
            sym_err |= in_sym & (le_sym >= 286)
            emit_tok = torch.where(is_lit, le_sym, emit_tok)
            emit |= is_lit
            lcode = (le_sym - 257).clamp(0, 30)
            lx = self.lx[lcode]
            length = self.lb[lcode] + (self.fetch(p1) & ((1 << lx) - 1))
            p2 = p1 + lx
            de = _take(self.dst_tbl, self.fetch(p2) & (TBL - 1))
            de_bits = de >> 9
            de_sym = (de & 511).clamp(0, 31)
            sym_err |= is_len & (de_bits == 0)
            p3 = p2 + de_bits
            dx = self.dx[de_sym]
            dist = self.db[de_sym] + (self.fetch(p3) & ((1 << dx) - 1))
            p4 = p3 + dx
            mtok = (1 << 30) | ((length - 3) << 15) | (dist - 1)
            emit_tok = torch.where(is_len, mtok, emit_tok)
            emit |= is_len
            self.p = torch.where(is_lit | is_eob, p1,
                                 torch.where(is_len, p4, self.p))
            self.phase = torch.where(is_eob & (self.bfinal == 1), PH_DONE,
                                     self.phase)
            self.phase = torch.where(is_eob & (self.bfinal == 0), PH_HDR,
                                     self.phase)
            self.err |= sym_err
            self.phase = torch.where(sym_err, PH_DONE, self.phase)

        # tokens are int32, as in JAX: the int64 values wrap to their low
        # 32 bits (a stored token's type bit is the sign)
        widx = torch.where(emit, self.tok_cnt, MAX_TOK)
        self.tokens[rows, widx] = emit_tok.to(torch.int32)
        self.tok_cnt = self.tok_cnt + emit.long()
        self.err |= self.tok_cnt >= MAX_TOK

    def _pre(self, in_pre):
        """PH_PRE: read the precode lengths and build its 7-bit table into
        dst_tbl[:, :128] (rebuilt at PH_BUILD anyway), as JAX does."""
        B = self.p.shape[0]
        dev = self.p.device
        hclen4 = self.stored_rem + 4
        w = [self.fetch(self.p), self.fetch(self.p + 24),
             self.fetch(self.p + 48)]
        plens = torch.zeros((B, 19), dtype=torch.long, device=dev)
        for j in range(19):
            sh = 3 * j
            src = w[sh // 24] >> (sh % 24)
            v = torch.where(j < hclen4, src & 7, 0)
            plens[:, CLCIDX[j]] = torch.where(in_pre, v,
                                              plens[:, CLCIDX[j]])
        pre_entry = _canon(plens, 19, 7, self.rev7)
        self.dst_tbl[:, :128] = torch.where(in_pre[:, None], pre_entry,
                                            self.dst_tbl[:, :128])
        self.p = torch.where(in_pre, self.p + hclen4 * 3, self.p)
        self.ncodes = torch.where(in_pre, 0, self.ncodes)
        self.stored_rem = torch.where(in_pre, 0, self.stored_rem)
        self.phase = torch.where(in_pre, PH_LENS, self.phase)

    def run(self, chunk: int = CHUNK, max_rounds: int = MAX_ROUNDS):
        """JAX's while_loop of build + scan chunks.  A chunk stops early
        once every member is done or parked: the steps left would only
        repeat the overrun check of the parked ones, which one step
        does."""
        rounds = 0
        while bool((self.phase != PH_DONE).any()) and rounds < max_rounds:
            self.build_tables()
            for i in range(chunk):
                self.step()
                idle = (self.phase == PH_DONE) | (self.phase == PH_BUILD)
                if bool(idle.all()):
                    if i + 1 < chunk:
                        self.step()
                    break
            rounds += 1
        return self.tokens[:, :MAX_TOK], self.tok_cnt, \
            self.err | (self.phase != PH_DONE)


def _pass_b(tokens, tok_cnt, in_bytes, out_sz):
    """Token resolution (JAX's pass_b): returns (out u8 [B, OUT_MAX],
    produced int64 [B])."""
    B = tokens.shape[0]
    dev = tokens.device
    ttype = (tokens >> 30) & 3
    t64 = tokens.long()
    ti = torch.arange(MAX_TOK, device=dev)[None, :]
    valid = ti < tok_cnt[:, None]
    tlen = torch.where(ttype == 1, ((t64 >> 15) & 0xFF) + 3,
                       torch.where(ttype == 2, t64 & 0x1FFF, 1))
    tlen = torch.where(valid, tlen, 0)
    ends = torch.cumsum(tlen, 1)
    starts = ends - tlen
    produced = torch.where(tok_cnt > 0, ends.gather(
        1, (tok_cnt - 1).clamp(0, MAX_TOK - 1)[:, None])[:, 0], 0)
    sc = torch.where(valid & (tlen > 0) & (starts < OUT_MAX), starts, OUT_MAX)
    cover = torch.zeros((B, OUT_MAX + 1), dtype=torch.long, device=dev)
    cover.scatter_reduce_(1, sc, ti.expand(B, -1), "amax")
    cover = torch.cummax(cover[:, :OUT_MAX], 1).values
    pos = torch.arange(OUT_MAX, device=dev)[None, :]
    ctok = t64.gather(1, cover)
    ctype = (ctok >> 30) & 3
    within = pos - starts.gather(1, cover)
    lit_val = ctok & 0xFF
    soff = ((ctok >> 13) & 0x1FFFF) + within
    stored_val = in_bytes.long().gather(
        1, soff.clamp(0, in_bytes.shape[1] - 1))
    direct = torch.where(ctype == 2, stored_val, lit_val)
    dist = (ctok & 0x7FFF) + 1
    f = torch.where(ctype == 1, (pos - dist).clamp(min=0), pos)
    for _ in range(16):
        f = f.gather(1, f)
    out = direct.gather(1, f)
    out = torch.where(pos < out_sz[:, None], out, 0)
    return out.to(torch.uint8), produced


def inflate_plain(b: InflateBatch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel X4: the JAX function's two passes
    over the batch (rows padded as JAX pads them).  Returns (output u8
    [total_out], stats int32 [B, 4]: error flag, bytes produced, tokens,
    -1 for the steps the kernel counts)."""
    dev = b.payload.device
    B = b.n_members
    n = b.in_len.long()
    in_max = (int(n.max()) + 8 + 3) & ~3 if B else 8
    j = torch.arange(in_max, device=dev)[None, :]
    src = (b.in_off[:, None] + j).clamp(max=b.payload.numel() - 1)
    buf = torch.where(j < n[:, None], b.payload.long()[src], 0)
    w = buf.reshape(B, -1, 4)
    words = w[..., 0] | (w[..., 1] << 8) | (w[..., 2] << 16) | (w[..., 3] << 24)
    tokens, tok_cnt, err = _PassA(words, 8 * n).run()
    out, produced = _pass_b(tokens, tok_cnt, buf, b.isize)
    err = err | (produced != b.isize)
    flat = torch.zeros(b.total_out + 1, dtype=torch.uint8, device=dev)
    k = torch.arange(OUT_MAX, device=dev)[None, :]
    keep = k < b.out_cap.long()[:, None]
    at = torch.where(keep, b.out_off[:, None] + k, b.total_out)
    flat[at.reshape(-1)] = torch.where(keep, out, 0).reshape(-1)
    stats = torch.stack([err.long(), produced, tok_cnt,
                         torch.full_like(tok_cnt, -1)], 1).to(torch.int32)
    return flat[:b.total_out], stats


_RING_WAVE: dict = {}  # members in one wave of the ring variant, a card


def ring_fits(n_members: int, device) -> bool:
    """Whether a batch of n_members runs kernel X4's ring variant: while
    the batch fits one wave of it (its blocks an SM times the card's
    SMs).  A launch lasts about its longest member's steps times a step's
    time times its waves: the ring's step is about half the slot
    variant's, but an SM holds a few members of it against the slot
    variant's many."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev not in _RING_WAVE:
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _RING_WAVE[dev] = blocks_per_sm(ring=True) * sms
    return n_members <= _RING_WAVE[dev]


def inflate_cuda(b: InflateBatch, ring: Optional[bool] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel X4 over the whole batch in one launch; returns (output u8
    [total_out], stats int32 [B, 4]: error code (0: none), bytes
    produced, tokens, steps), the error flag and, where there is no
    error, the rest as in `inflate_plain`.  `ring` picks the variant
    (the output window in shared memory, or the member's slot), by
    default `ring_fits`; both give the same results."""
    B = b.n_members
    req = _build.require_cuda
    req(b.payload, torch.uint8, "payload")
    req(b.in_off, torch.int64, "in_off", (B,))
    req(b.in_len, torch.int32, "in_len", (B,))
    req(b.out_off, torch.int64, "out_off", (B,))
    req(b.out_cap, torch.int32, "out_cap", (B,))
    if b.payload.data_ptr() % 4:
        raise ValueError("payload: expected a 4-byte aligned buffer")
    words_end = b.in_off + 4 * ((b.in_len.long() + 3) // 4)
    bad = ((words_end > b.payload.numel()) | (b.in_off % 4 != 0)
           | (b.in_off < 0) | (b.in_len < 0) | (b.out_cap < 0)
           | (b.out_cap > OUT_MAX) | (b.out_off < 0)
           | (b.out_off + b.out_cap > b.total_out)).any()
    if bool(bad):
        raise ValueError("batch: a member lies outside its buffers")
    dev = b.payload.device
    if ring is None:
        ring = ring_fits(B, dev)
    out = torch.empty(b.total_out, dtype=torch.uint8, device=dev)
    stats = torch.empty((B, 4), dtype=torch.int32, device=dev)
    lib = _build.load("inflate")
    name = "inflate" if ring else "inflate_slot"
    rc = getattr(lib, name + "_launch")(
        b.payload.data_ptr(), b.in_off.data_ptr(), b.in_len.data_ptr(),
        out.data_ptr(), b.out_off.data_ptr(), b.out_cap.data_ptr(),
        stats.data_ptr(), B, _build.stream_handle(b.payload))
    _build.check(lib, rc, name)
    _build.LAUNCHES[name] += 1
    return out, stats


def inflate(b: InflateBatch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inflate a batch: the kernel for a batch on the card, the plain
    version for one on the CPU."""
    if b.payload.is_cuda:
        return inflate_cuda(b)
    if b.payload.device.type != "cpu":
        raise ValueError(f"unsupported device {b.payload.device}")
    return inflate_plain(b)


def smem_bytes(ring: bool = True) -> int:
    """Bytes of shared memory a block (a member) of kernel X4 takes, in
    the ring variant or the slot one."""
    lib = _build.load("inflate")
    return lib.inflate_smem_bytes() if ring else lib.inflate_slot_smem_bytes()


def blocks_per_sm(ring: bool = True) -> int:
    """Members one SM of the card decodes at once in kernel X4, in the
    ring variant or the slot one."""
    lib = _build.load("inflate")
    n = (lib.inflate_blocks_per_sm() if ring
         else lib.inflate_slot_blocks_per_sm())
    _build.check(lib, max(-n, 0), "inflate occupancy")
    return n


def corrupt(b: InflateBatch, stats: torch.Tensor) -> torch.Tensor:
    """Per member, whether the JAX function marks it in error: its decode
    failed or its output is not its ISIZE."""
    return (stats[:, 0] != 0) | (stats[:, 1].long() != b.isize)


def inflate_batch(payloads: Sequence[bytes], isizes: Sequence[int],
                  batch: int = 256, device="cuda",
                  timing: Optional[dict] = None) -> List[bytes]:
    """Inflate independent whole DEFLATE streams on the device.

    payloads: raw DEFLATE bytes (BGZF CDATA, gzip members, zlib bodies
    without the 2-byte header).  isizes: expected output sizes (<= 64
    KiB).  Returns the decoded byte strings; raises ValueError on corrupt
    input.  The card decodes every member in one launch; `batch` bounds
    the members of one pass of the plain version (its [batch, 65,552]
    token lists), as it bounds the JAX function's.  `timing`, where
    given, gets the call's seconds in parts, each ended by a synchronise:
    frame_s (the framing in numpy), transfer_s, decode_s (the launch and
    kernel, or the plain version on the CPU), check_download_s (the error
    check and the output's download), slice_s (the members cut out of
    it)."""
    dev = _build.resolve_device(device)
    if not payloads:
        return []
    n = len(payloads)
    step = n if dev.type == "cuda" else batch
    parts = dict.fromkeys(("frame_s", "transfer_s", "decode_s",
                           "check_download_s", "slice_s"), 0.0)
    last = [_build.clock(dev) if timing is not None else 0.0]

    def mark(key):
        if timing is not None:
            now = _build.clock(dev)
            parts[key] += now - last[0]
            last[0] = now

    res: List[bytes] = []
    for lo in range(0, n, step):
        b = frame_members(payloads[lo:lo + step], isizes[lo:lo + step], "cpu")
        offs, caps = b.out_off.numpy(), b.out_cap.numpy()
        mark("frame_s")
        b = b.to(dev)
        mark("transfer_s")
        out, stats = inflate(b)
        mark("decode_s")
        bad = torch.nonzero(corrupt(b, stats))
        if len(bad):
            raise ValueError(f"device inflate: corrupt stream "
                             f"{lo + int(bad[0, 0])}")
        flat = out.cpu().numpy()
        mark("check_download_s")
        res += [flat[o:o + c].tobytes() for o, c in zip(offs, caps)]
        mark("slice_s")
    if timing is not None:
        timing.update(parts)
    return res
