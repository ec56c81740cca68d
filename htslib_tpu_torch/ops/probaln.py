"""Batched banded glocal-HMM alignment (probaln.c:77 probaln_glocal), the
BAQ hot step, on the card.

Port of htslib_tpu/ops/probaln.py: `probaln_batch` (:50, kernel X6,
csrc/probaln.cu with its arithmetic in csrc/probaln_step.cuh) and
`probaln_batch_host` (:289).  The JAX function scans the query rows with
the band and batch axes vectorised and a serial D-chain scan along the
band; the kernel runs each read over its own band of 2 * bw + 2 cells,
a read a warp, or a read a thread for the short reads of a batch that
holds enough of them to fill the card (`split_reads`).  The plain version
is the JAX formulation in torch ops, the batch axis vectorised: a few ops
per band cell per row.

Outputs mirror probaln_glocal(want_map=True): per-read phred score Pr,
per-base MAP states ((k-1)<<2 | state) and BAQ qualities.  In float64 the
integers are the JAX function's (x64) and, bar the last bit of a log,
the scalar reference's; in float32 they agree to +/-1 phred.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from htslib_tpu_torch import _build

EI = 0.25
EM = 0.33333333333

_QUAL2PROB = np.power(10.0, -np.arange(256) / 10.0)

# The split of a batch between the two kernels (`split_reads`), from
# probe_x4_x6.py's sweep on an H100: a read a warp (probaln_warp_kernel)
# is faster at every length from 100 bp in batches of up to 20,000 reads
# (2.9x at 200 reads of 100 bp, 5.5x at 2,000 bp, 1.25x at 20,000 of
# 100 bp); a read a thread (probaln_kernel) from about 30,000 reads of
# 100-250 bp on (1.03x at 30,000, 1.35x at 100,000), which fill the
# card's threads, while the warp kernel's 118 registers a lane hold 17
# warps an SM.  At 400 bp a warp still wins at 20,000 reads (1.2x).  So
# reads shorter than WARP_QLEN run a thread each where the batch holds
# THREAD_MIN_READS of them or more, and every other read a warp.
WARP_QLEN = 500
THREAD_MIN_READS = 30_000


def _check(ref, rlen, query, qlen, qprob, bw, J: int):
    if qprob.dtype not in (torch.float64, torch.float32):
        raise ValueError("qprob: expected float64 or float32")
    if ref.dim() != 2 or query.dim() != 2 or qprob.shape != query.shape:
        raise ValueError("ref [B, R], query and qprob [B, Q] expected")
    B, R = ref.shape
    Q = query.shape[1]
    bad = ((rlen < 1) | (rlen > R) | (qlen < 1) | (qlen > Q) | (bw < 0)
           | (2 * bw + 2 > J)).any()
    if bool(bad):
        raise ValueError("a read with rlen or qlen outside 1..R or 1..Q, "
                         "or a band wider than J")


def _shift_right(a):
    """a[:, j-1] with 0 fill."""
    return torch.nn.functional.pad(a, (1, 0))[:, :-1]


def _shift_left(a):
    """a[:, j+1] with 0 fill."""
    return torch.nn.functional.pad(a, (0, 1))[:, 1:]


def probaln_plain(ref, rlen, query, qlen, qprob, bw, J: int, d=0.001,
                  e=0.1, flag: Optional[torch.Tensor] = None):
    """Plain PyTorch version of kernel X6: the JAX scans as torch ops over
    [B, J] rows, the band sums and chains cell by cell from cell 0 (the
    kernel's and XLA's order).  Same arguments and results as
    `probaln_batch`."""
    _check(ref, rlen, query, qlen, qprob, bw, J)
    dev = ref.device
    B, R = ref.shape
    Q = query.shape[1]
    dt = qprob.dtype
    ref = ref.long()
    query = query.long()
    lr, lq, bw = rlen.long(), qlen.long(), bw.long()
    jj = torch.arange(J, device=dev)

    lqf = lq.to(dt)
    lrf = lr.to(dt)
    sM = 1.0 / (2.0 * lqf + 2.0)
    sI = sM
    m0 = (1.0 - d - d) * (1 - sM)
    m1 = d * (1 - sM)
    m2 = m1
    m3 = (1.0 - e) * (1 - sI)
    m4 = e * (1 - sI)
    m6 = torch.full_like(sM, 1.0 - e)
    m8 = torch.full_like(sM, e)
    bM = (1.0 - d) / lrf
    bI = d / lrf

    def row_geom(i):
        x = (i - bw).clamp(min=0)
        beg = (i - bw).clamp(min=1)
        end = torch.minimum(lr, i + bw)
        act = ((jj[None, :] >= (beg - x + 1)[:, None])
               & (jj[None, :] <= (end - x + 1)[:, None]))
        k0 = x[:, None] + jj[None, :] - 2
        rc = torch.gather(ref, 1, k0.clamp(0, R - 1))
        rc = torch.where((k0 >= 0) & (k0 < lr[:, None]), rc, 4)
        return x, act, rc

    def emis(qc, qp, rc):
        amb = (rc > 3) | (qc[:, None] > 3)
        match = rc == qc[:, None]
        return torch.where(amb, torch.ones((), dtype=dt, device=dev),
                           torch.where(match, 1.0 - qp[:, None],
                                       qp[:, None] * EM))

    def seq_sum(a):
        """The row sum of a [B, n], cell by cell from cell 0."""
        s = torch.zeros(B, dtype=dt, device=dev)
        for j in range(a.shape[1]):
            s = s + a[:, j]
        return s

    zero = torch.zeros((B, J), dtype=dt, device=dev)
    fMs = torch.zeros((Q, B, J), dtype=dt, device=dev)
    fIs = torch.zeros((Q, B, J), dtype=dt, device=dev)
    ss = torch.ones((Q, B), dtype=dt, device=dev)

    # forward row 1
    _x, act, rc = row_geom(1)
    fM = torch.where(act, emis(query[:, 0], qprob[:, 0], rc) * bM[:, None],
                     zero)
    fI = torch.where(act, (EI * bI)[:, None], zero)
    fD = zero
    fMs[0], fIs[0], ss[0] = fM, fI, seq_sum(fM + fI)
    # forward rows 2..Q, each read's rows past its qlen left as they were
    for i in range(2, Q + 1):
        x, act, rc = row_geom(i)
        sh = (x - (i - 1 - bw).clamp(min=0))[:, None] == 1
        ev = emis(query[:, i - 1], qprob[:, i - 1], rc)
        minv = (1.0 / ss[i - 2])[:, None]
        v11M = torch.where(sh, fM, _shift_right(fM))
        v11I = torch.where(sh, fI, _shift_right(fI))
        v11D = torch.where(sh, fD, _shift_right(fD))
        v10M = torch.where(sh, _shift_left(fM), fM)
        v10I = torch.where(sh, _shift_left(fI), fI)
        fM_n = ev * (m0[:, None] * minv * v11M + m3[:, None] * minv * v11I
                     + m6[:, None] * minv * v11D)
        fI_n = EI * (m1[:, None] * minv * v10M + m4[:, None] * minv * v10I)
        fM_n = torch.where(act, fM_n, zero)
        fI_n = torch.where(act, fI_n, zero)
        actf = act.to(dt)
        fD_n = torch.zeros_like(zero)
        dprev = torch.zeros(B, dtype=dt, device=dev)
        s_n = torch.zeros(B, dtype=dt, device=dev)
        for j in range(J):
            mprev = fM_n[:, j - 1] if j else torch.zeros_like(dprev)
            dprev = (m2 * mprev + m8 * dprev) * actf[:, j]
            fD_n[:, j] = dprev
            s_n = s_n + (fM_n[:, j] + fI_n[:, j] + dprev)
        live = (i <= lq)[:, None]
        fM = torch.where(live, fM_n, fM)
        fI = torch.where(live, fI_n, fI)
        fD = torch.where(live, fD_n, fD)
        fMs[i - 1], fIs[i - 1] = fM, fI
        ss[i - 1] = torch.where(live[:, 0], s_n, ss[i - 1])

    # likelihood: -4.343 * sum(log s) over s[0..lq+1]
    rows = torch.arange(B, device=dev)
    s_lq = ss[lq - 1, rows]
    fM_lq, fI_lq = fMs[lq - 1, rows], fIs[lq - 1, rows]
    s_end = seq_sum(fM_lq * sM[:, None] + fI_lq * sI[:, None]) / s_lq
    logs = torch.zeros(B, dtype=dt, device=dev)
    for i in range(Q):
        logs = logs + torch.where(i < lq, torch.log(ss[i].clamp(min=1e-300)),
                                  torch.zeros((), dtype=dt, device=dev))
    pr = (-4.343 * (logs + torch.log(s_end) + torch.log(lrf * lqf))
          + 0.499).to(torch.int32)

    # backward + MAP
    init_scale = (sM / (s_lq * s_end))[:, None]
    initI_scale = (sI / (s_lq * s_end))[:, None]
    states = torch.zeros((B, Q), dtype=torch.int32, device=dev)
    qs = torch.zeros((B, Q), dtype=torch.uint8, device=dev)
    bM_n = bI_n = zero
    for i in range(Q, 0, -1):
        x, act, _rc = row_geom(i)
        sh = ((i + 1 - bw).clamp(min=0) - x)[:, None] == 1
        qi = min(i, Q - 1)
        k = x[:, None] + jj[None, :] - 1
        valid_k = (k >= 0) & (k < lr[:, None])
        rc_next = torch.where(valid_k, torch.gather(ref, 1, k.clamp(0, R - 1)),
                              4)
        ev = torch.where(valid_k, emis(query[:, qi], qprob[:, qi], rc_next),
                         zero)
        bM_v11 = torch.where(sh, bM_n, _shift_left(bM_n))
        bI_v10 = torch.where(sh, _shift_right(bI_n), bI_n)
        ee = ev * bM_v11
        y = 1.0 if i > 1 else 0.0
        actf = act.to(dt)
        bD_t = torch.zeros_like(zero)
        dnext = torch.zeros(B, dtype=dt, device=dev)
        for j in range(J - 1, -1, -1):
            dnext = (ee[:, j] * m6 + m8 * dnext) * y * actf[:, j]
            bD_t[:, j] = dnext
        bD_right = _shift_left(bD_t)
        bM_t = (ee * m0[:, None] + EI * m1[:, None] * bI_v10
                + m2[:, None] * bD_right)
        bI_t = ee * m3[:, None] + EI * m4[:, None] * bI_v10
        bM_t = torch.where(act, bM_t, zero)
        bI_t = torch.where(act, bI_t, zero)
        s_i = ss[i - 1]
        yscale = (1.0 / s_i)[:, None]
        at_init = (i == lq)[:, None]
        in_body = (i < lq)[:, None]
        bM_row = torch.where(at_init, torch.where(act, init_scale, zero),
                             torch.where(in_body, bM_t * yscale, zero))
        bI_row = torch.where(at_init, torch.where(act, initI_scale, zero),
                             torch.where(in_body, bI_t * yscale, zero))

        # MAP for row i
        minv = (1.0 / s_i)[:, None]
        zM = minv * fMs[i - 1] * bM_row
        zI = minv * fIs[i - 1] * bI_row
        z2 = torch.stack([zM, zI], 2).reshape(B, 2 * J)
        ssum = seq_sum(z2)
        arg = torch.argmax(z2, 1)
        rest = seq_sum(torch.where(torch.arange(2 * J, device=dev)[None, :]
                                   == arg[:, None], 0.0, z2))
        frac = rest / ssum.clamp(min=1e-300)
        kk = (-4.343 * torch.log(frac.clamp(min=1e-30)) + 0.499).to(
            torch.int32)
        qv = torch.where(kk > 100, 99, kk)
        state = ((x + arg // 2 - 1 - 1) << 2 | (arg % 2)).to(torch.int32)
        live = i <= lq
        states[:, i - 1] = torch.where(live, state, 0)
        qs[:, i - 1] = torch.where(live, qv, 0).to(torch.uint8)
        # where the JAX scalar's MAP fails (pb_map)
        if flag is not None:
            mx = torch.gather(z2, 1, arg[:, None])[:, 0]
            one = mx / torch.where(ssum == 0, 1.0, ssum) == 1.0
            flag[:, i - 1] = torch.where(live, torch.where(
                ssum == 0, 2, one.to(torch.uint8)), 0).to(torch.uint8)
        bM_n, bI_n = bM_row, bI_row
    return pr, states, qs


def split_reads(qlen, bw, j_max: int):
    """The reads that run a warp each (a bool mask): those of WARP_QLEN
    bases or more, and the shorter ones too where the batch holds fewer
    than THREAD_MIN_READS of them; never one whose band passes j_max
    cells (the warp kernel's shared exchange)."""
    short = qlen.long() < WARP_QLEN
    warp = ~short | (int(short.sum()) < THREAD_MIN_READS)
    return warp & (2 * bw.long() + 2 <= j_max)


def _warp_layout(qlen, bw, Q: int, sel):
    """The reads `sel` (batch indices), a thread each, sorted by (J, qlen),
    and the scratch of each warp of 32 of them: (order int32, warp_off
    int64, warp_j int32, warp_q int32, scratch elements)."""
    B = sel.shape[0]
    Jr = 2 * bw.long()[sel] + 2
    ql = qlen.long()[sel]
    perm = torch.argsort(Jr * (Q + 1) + ql, stable=True)
    W = (B + 31) // 32
    pad = W * 32 - B
    js = torch.nn.functional.pad(Jr[perm], (0, pad)).reshape(W, 32)
    qs = torch.nn.functional.pad(ql[perm], (0, pad)).reshape(W, 32)
    wj, wq = js.max(1).values, qs.max(1).values
    size = ((2 * wq + 8) * wj + wq) * 32
    off = torch.cumsum(size, 0) - size
    return (sel[perm].to(torch.int32), off, wj.to(torch.int32),
            wq.to(torch.int32), int(size.sum()))


def _long_layout(qlen, bw, sel):
    """The reads `sel`, a warp each, longest first: (order int32, scratch
    offset int64 of each, scratch elements, the largest J)."""
    ql = qlen.long()[sel]
    perm = torch.argsort(-ql, stable=True)
    Jr = 2 * bw.long()[sel][perm] + 2
    size = (4 * Jr + 2) * ql[perm]
    off = torch.cumsum(size, 0) - size
    return (sel[perm].to(torch.int32), off, int(size.sum()),
            int(Jr.max()) if len(Jr) else 0)


def probaln_cuda(ref, rlen, query, qlen, qprob, bw, J: int, d=0.001,
                 e=0.1, layout: Optional[dict] = None,
                 flag: Optional[torch.Tensor] = None):
    """Kernel X6 over the batch: the reads `split_reads` picks in one
    launch of a warp a read, the others in one launch of a thread a read;
    same results as `probaln_plain`.  `layout`, where given, gets the
    reads of each launch (thread_reads, warp_reads)."""
    _check(ref, rlen, query, qlen, qprob, bw, J)
    B = ref.shape[0]
    req = _build.require_cuda
    req(ref, torch.uint8, "ref")
    req(query, torch.uint8, "query")
    req(qprob, qprob.dtype, "qprob")
    for t, name in ((rlen, "rlen"), (qlen, "qlen"), (bw, "bw")):
        req(t, torch.int32, name, (B,))
    if flag is not None:
        req(flag, torch.uint8, "flag", tuple(query.shape))
    j_max = _build.load("probaln").probaln_warp_j_max()
    warp = split_reads(qlen, bw, j_max)
    return launch(ref, rlen, query, qlen, qprob, bw, d, e, warp, layout,
                  flag)


def launch(ref, rlen, query, qlen, qprob, bw, d, e, warp,
           layout: Optional[dict] = None,
           flag: Optional[torch.Tensor] = None):
    """The launches of `probaln_cuda` on checked tensors, with the split
    given: the reads of the bool mask `warp` (each band at most
    `probaln_warp_j_max` cells) a warp each, the others a thread each."""
    lib = _build.load("probaln")
    B, R = ref.shape
    Q = query.shape[1]
    dev = ref.device
    sel_w = torch.nonzero(warp).flatten()
    sel_t = torch.nonzero(~warp).flatten()
    pr = torch.empty(B, dtype=torch.int32, device=dev)
    state = torch.zeros((B, Q), dtype=torch.int32, device=dev)
    q = torch.zeros((B, Q), dtype=torch.uint8, device=dev)
    dbl = int(qprob.dtype == torch.float64)
    flag_ptr = None if flag is None else flag.data_ptr()
    common = (ref.data_ptr(), rlen.data_ptr(), query.data_ptr(),
              qlen.data_ptr(), qprob.data_ptr(), bw.data_ptr())
    stream = _build.stream_handle(ref)
    if len(sel_t):
        order, woff, wj, wq, n_scratch = _warp_layout(qlen, bw, Q, sel_t)
        scratch = torch.empty(max(n_scratch, 1), dtype=qprob.dtype,
                              device=dev)
        rc = lib.probaln_launch(
            *common, order.data_ptr(), woff.data_ptr(), wj.data_ptr(),
            wq.data_ptr(), scratch.data_ptr(), pr.data_ptr(),
            state.data_ptr(), q.data_ptr(), flag_ptr, len(sel_t), R, Q,
            float(d), float(e), dbl, stream)
        _build.check(lib, rc, "probaln")
        _build.LAUNCHES["probaln"] += 1
    if len(sel_w):
        order, off, n_scratch, jmax = _long_layout(qlen, bw, sel_w)
        scratch = torch.empty(max(n_scratch, 1), dtype=qprob.dtype,
                              device=dev)
        rc = lib.probaln_warp_launch(
            *common, order.data_ptr(), off.data_ptr(), scratch.data_ptr(),
            pr.data_ptr(), state.data_ptr(), q.data_ptr(), flag_ptr,
            len(sel_w), R, Q, float(d), float(e), jmax, dbl, stream)
        _build.check(lib, rc, "probaln_warp")
        _build.LAUNCHES["probaln_warp"] += 1
    if layout is not None:
        layout.update(thread_reads=len(sel_t), warp_reads=len(sel_w))
    return pr, state, q


def probaln_batch(ref, rlen, query, qlen, qprob, bw, J: int, d=0.001,
                  e=0.1, flag: Optional[torch.Tensor] = None):
    """Forward/backward/MAP over a padded batch.

    ref:   [B, R] uint8 translated bases (0..3, >=4 ambiguous)
    rlen:  [B] int32 reference window lengths (1..R)
    query: [B, Q] uint8 translated read bases
    qlen:  [B] int32 read lengths (1..Q)
    qprob: [B, Q] float64 or float32 error probabilities (10^(-q/10))
    bw:    [B] int32 per-read band width (already max'd with |lr-lq|)
    J:     band cell count, >= 2*max(bw)+2

    flag:  where given, [B, Q] uint8 on the batch's device, gets each
           base's 2 where its MAP row sums to 0 and 1 where the largest
           product over the row's sum is 1 (where the JAX scalar's
           division or log(1 - mx) fails), else 0; entries past qlen are
           left as they are

    Returns (Pr [B] int32, state [B, Q] int32, q [B, Q] uint8); entries
    past qlen are zero.  Kernel X6 for tensors on the card, the plain
    version for tensors on the CPU."""
    if ref.is_cuda:
        return probaln_cuda(ref, rlen, query, qlen, qprob, bw, J, d, e,
                            flag=flag)
    if ref.device.type != "cpu":
        raise ValueError(f"unsupported device {ref.device}")
    return probaln_plain(ref, rlen, query, qlen, qprob, bw, J, d, e, flag)


def pad_batch(refs, queries, iquals, bw_param=10, dtype=np.float64,
              bws=None):
    """The host side of `probaln_batch_host`: a list of (ref, query, qual)
    byte triples (translated to 0..4 codes) padded into numpy arrays
    (ref, rlen, query, qlen, qprob, bw) and J = 2 * max(bw) + 2.  A
    missing qual reads as phred 30; `bws` gives each read's c.bw, else
    bw_param."""
    B = len(refs)
    rlen = np.array([len(r) for r in refs], np.int32)
    qlen = np.array([len(q) for q in queries], np.int32)

    def padded(seqs, lens, fill, dt=np.uint8):
        out = np.full((B, int(lens.max())), fill, dt)
        row = np.repeat(np.arange(B), lens)
        col = np.arange(len(row)) - np.repeat(np.cumsum(lens) - lens, lens)
        return out, row, col, np.frombuffer(b"".join(seqs), np.uint8)

    ref, row, col, flat = padded(refs, rlen, 4)
    ref[row, col] = flat
    qry, row, col, flat = padded(queries, qlen, 4)
    qry[row, col] = flat
    qpr = np.full(qry.shape, _QUAL2PROB[30], dtype)
    has = np.array([iq is not None for iq in iquals], bool)
    if has.any():
        keep = has[row]
        qual = np.frombuffer(b"".join(iq for iq in iquals if iq is not None),
                             np.uint8)
        qpr[row[keep], col[keep]] = _QUAL2PROB[qual]
    cap = np.asarray(bws if bws is not None else [bw_param] * B, np.int64)
    bw = np.minimum(np.maximum(rlen, qlen), cap)
    bw = np.maximum(bw, np.abs(rlen.astype(np.int64) - qlen)).astype(np.int32)
    return (ref, rlen, qry, qlen, qpr, bw), int(2 * bw.max() + 2)


def probaln_arrays(refs, queries, iquals, bw_param=10, d=0.001, e=0.1,
                   dtype=np.float64, bws: Optional[List[int]] = None,
                   device="cuda", timing: Optional[dict] = None):
    """`probaln_batch_host`'s work with its results left as numpy arrays:
    (Pr int32 [B], states int32 [B, Q], q uint8 [B, Q], qlen int32 [B]).
    `timing`, where given, gets seconds by part, added to what it holds:
    pad_s, upload_s, kernel_s (the call) and download_s."""
    dev = _build.resolve_device(device)
    t0 = _build.clock(dev)
    arrays, J = pad_batch(refs, queries, iquals, bw_param, dtype, bws)
    t1 = _build.clock(dev)
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    t2 = _build.clock(dev)
    pr, st, qq = probaln_batch(*args, J, d=d, e=e)
    t3 = _build.clock(dev)
    out = (pr.cpu().numpy(), st.cpu().numpy(), qq.cpu().numpy(), arrays[3])
    if timing is not None:
        for k, v in (("pad_s", t1 - t0), ("upload_s", t2 - t1),
                     ("kernel_s", t3 - t2),
                     ("download_s", _build.clock(dev) - t3)):
            timing[k] = timing.get(k, 0.0) + v
    return out


def probaln_batch_host(refs, queries, iquals, bw_param=10, d=0.001, e=0.1,
                       dtype=np.float64, bws: Optional[List[int]] = None,
                       device="cuda", timing: Optional[dict] = None):
    """Host wrapper: pads a list of (ref, query, qual) byte triples
    (translated to 0..4 codes) and runs the batch on `device`.  Returns
    a list of (Pr, state list, q bytes) matching probaln_glocal's outputs.
    `timing` as `probaln_arrays` fills it."""
    pr, st, qq, qlen = probaln_arrays(refs, queries, iquals, bw_param, d, e,
                                      dtype, bws, device, timing)
    return [(int(pr[i]), st[i, :n].tolist(), qq[i, :n].tobytes())
            for i, n in enumerate(qlen.tolist())]
