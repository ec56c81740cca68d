"""Revised MAQ error model: the port's copy of htslib_tpu/errmod.py
(reference errmod.c:30-208, API htslib/hts.h:1416-1427).  The tables
are built in float64 in the JAX loop order, so they are bit-equal."""
from __future__ import annotations

import math
from typing import List

import numpy as np

M_LN10 = math.log(10.0)
M_LN2 = math.log(2.0)


class Errmod:
    def __init__(self, depcorr: float, eta: float = 0.03):
        self.depcorr = depcorr
        n_size = 256
        # log binomial table
        lfact = [math.lgamma(i + 1) for i in range(512)]
        lC = np.zeros((256, 256))
        for n in range(1, n_size):
            lfn = lfact[n]
            for k in range(1, n + 1):
                lC[n, k] = lfn - lfact[k] - lfact[n - k]
        # fk
        self.fk = np.zeros(256)
        self.fk[0] = 1.0
        for n in range(1, 256):
            self.fk[n] = (1.0 - depcorr) ** n * (1.0 - eta) + eta
        # beta[q, n, k]
        self.beta = np.zeros((64, 256, 256))
        for q in range(1, 64):
            e = 10.0 ** (-q / 10.0)
            le = math.log(e)
            le1 = math.log(1.0 - e)
            for n in range(1, 256):
                sum1 = lC[n, n] + n * le
                self.beta[q, n, n] = math.inf
                for k in range(n - 1, -1, -1):
                    s = sum1 + math.log1p(
                        math.exp(lC[n, k] + k * le + (n - k) * le1 - sum1))
                    self.beta[q, n, k] = -10.0 / M_LN10 * (sum1 - s)
                    sum1 = s
        # lhet
        self.lhet = np.zeros((256, 256))
        for n in range(256):
            for k in range(256):
                self.lhet[n, k] = lC[n, k] - M_LN2 * n

    def cal(self, m: int, bases: List[int]) -> np.ndarray:
        """errmod_cal (errmod.c:143): bases are
        (qual<<5 | strand<<4 | base); returns q[m, m] float32 phred
        genotype likelihoods.  Inputs beyond 255 entries must be
        pre-downsampled by the caller (the reference shuffles with
        drand48)."""
        q = np.zeros((m, m), np.float32)
        n = len(bases)
        if n == 0:
            return q
        if n > 255:
            bases = bases[:255]
            n = 255
        bases = sorted(bases)
        w = [0] * 32
        fsum = [0.0] * 16
        bsum = [0.0] * 16
        cnt = [0] * 16
        for j in range(n - 1, -1, -1):
            b = bases[j]
            qual = 4 if (b >> 5) < 4 else (b >> 5)
            if qual > 63:
                qual = 63
            basestrand = b & 0x1F
            base = b & 0xF
            fsum[base] += self.fk[w[basestrand]]
            bsum[base] += self.fk[w[basestrand]] * self.beta[qual, n, cnt[base]]
            cnt[base] += 1
            w[basestrand] += 1
        for j in range(m):
            tmp1 = tmp3 = 0.0
            tmp2 = 0
            for k in range(m):
                if k == j:
                    continue
                tmp1 += bsum[k]
                tmp2 += cnt[k]
                tmp3 += fsum[k]
            if tmp2:
                q[j, j] = tmp1
            for k in range(j + 1, m):
                cjk = cnt[j] + cnt[k]
                tmp1 = 0.0
                tmp2 = 0
                for i in range(m):
                    if i == j or i == k:
                        continue
                    tmp1 += bsum[i]
                    tmp2 += cnt[i]
                het = -4.343 * self.lhet[cjk, cnt[k]]
                q[j, k] = q[k, j] = het + tmp1 if tmp2 else het
            for k in range(m):
                if q[j, k] < 0.0:
                    q[j, k] = 0.0
        return q
