"""Special math functions, the port's copy of htslib_tpu/kfunc.py
(reference kfunc.c:39-313, API
htslib/hts.h:1416+): lgamma, erfc, regularized incomplete gamma/beta and
Fisher's exact test — faithful double-precision ports."""
from __future__ import annotations

import math
from typing import Tuple

M_SQRT2 = math.sqrt(2.0)
KF_GAMMA_EPS = 1e-14
KF_TINY = 1e-290


def kf_lgamma(z: float) -> float:
    x = 0.0
    x += 0.1659470187408462e-06 / (z + 7)
    x += 0.9934937113930748e-05 / (z + 6)
    x -= 0.1385710331296526 / (z + 5)
    x += 12.50734324009056 / (z + 4)
    x -= 176.6150291498386 / (z + 3)
    x += 771.3234287757674 / (z + 2)
    x -= 1259.139216722289 / (z + 1)
    x += 676.5203681218835 / z
    x += 0.9999999999995183
    return math.log(x) - 5.58106146679532777 - z + (z - 0.5) * math.log(z + 6.5)


def kf_erfc(x: float) -> float:
    p0, p1, p2, p3 = 220.2068679123761, 221.2135961699311, 112.0792914978709, 33.912866078383
    p4, p5, p6 = 6.37396220353165, 0.7003830644436881, 0.03526249659989109
    q0, q1, q2, q3 = 440.4137358247522, 793.8265125199484, 637.3336333788311, 296.5642487796737
    q4, q5, q6, q7 = 86.78073220294608, 16.06417757920695, 1.755667163182642, 0.08838834764831844
    z = abs(x) * M_SQRT2
    if z > 37.0:
        return 0.0 if x > 0 else 2.0
    expntl = math.exp(z * z * -0.5)
    if z < 10.0 / M_SQRT2:
        p = (expntl * ((((((p6 * z + p5) * z + p4) * z + p3) * z + p2) * z + p1) * z + p0)
             / (((((((q7 * z + q6) * z + q5) * z + q4) * z + q3) * z + q2) * z + q1) * z + q0))
    else:
        p = expntl / 2.506628274631001 / (z + 1.0 / (z + 2.0 / (z + 3.0 / (z + 4.0 / (z + 0.65)))))
    return 2.0 * p if x > 0 else 2.0 * (1.0 - p)


def _kf_gammap(s: float, z: float) -> float:
    ssum = x = 1.0
    for k in range(1, 100):
        x *= z / (s + k)
        ssum += x
        if x / ssum < KF_GAMMA_EPS:
            break
    return math.exp(s * math.log(z) - z - kf_lgamma(s + 1.0) + math.log(ssum))


def _kf_gammaq(s: float, z: float) -> float:
    f = 1.0 + z - s
    C, D = f, 0.0
    for j in range(1, 100):
        a = j * (s - j)
        b = (j << 1) + 1 + z - s
        D = b + a * D
        if D < KF_TINY:
            D = KF_TINY
        C = b + a / C
        if C < KF_TINY:
            C = KF_TINY
        D = 1.0 / D
        d = C * D
        f *= d
        if abs(d - 1.0) < KF_GAMMA_EPS:
            break
    return math.exp(s * math.log(z) - z - kf_lgamma(s) - math.log(f))


def kf_gammap(s: float, z: float) -> float:
    return _kf_gammap(s, z) if (z <= 1.0 or z < s) else 1.0 - _kf_gammaq(s, z)


def kf_gammaq(s: float, z: float) -> float:
    return 1.0 - _kf_gammap(s, z) if (z <= 1.0 or z < s) else _kf_gammaq(s, z)


def _kf_betai_aux(a: float, b: float, x: float) -> float:
    if x == 0.0:
        return 0.0
    if x == 1.0:
        return 1.0
    f = C = 1.0
    D = 0.0
    for j in range(1, 200):
        m = j >> 1
        if j & 1:
            aa = -(a + m) * (a + b + m) * x / ((a + 2 * m) * (a + 2 * m + 1))
        else:
            aa = m * (b - m) * x / ((a + 2 * m - 1) * (a + 2 * m))
        D = 1.0 + aa * D
        if D < KF_TINY:
            D = KF_TINY
        C = 1.0 + aa / C
        if C < KF_TINY:
            C = KF_TINY
        D = 1.0 / D
        d = C * D
        f *= d
        if abs(d - 1.0) < KF_GAMMA_EPS:
            break
    return math.exp(kf_lgamma(a + b) - kf_lgamma(a) - kf_lgamma(b)
                    + a * math.log(x) + b * math.log(1.0 - x)) / a / f


def kf_betai(a: float, b: float, x: float) -> float:
    if x < (a + 1.0) / (a + b + 2.0):
        return _kf_betai_aux(a, b, x)
    return 1.0 - _kf_betai_aux(b, a, 1.0 - x)


# ---------------------------------------------------------------------------
# Fisher's exact test (kfunc.c:245)
# ---------------------------------------------------------------------------

def _lbinom(n: int, k: int) -> float:
    if k == 0 or n == k:
        return 0.0
    return math.lgamma(n + 1) - math.lgamma(k + 1) - math.lgamma(n - k + 1)


def _hypergeo(n11: int, n1_: int, n_1: int, n: int) -> float:
    return math.exp(_lbinom(n1_, n11) + _lbinom(n - n1_, n_1 - n11)
                    - _lbinom(n, n_1))


class _HGAcc:
    __slots__ = ("n11", "n1_", "n_1", "n", "p")

    def __init__(self):
        self.n11 = self.n1_ = self.n_1 = self.n = 0
        self.p = 0.0


def _hypergeo_acc(n11, n1_, n_1, n, aux: _HGAcc) -> float:
    if n1_ or n_1 or n:
        aux.n11, aux.n1_, aux.n_1, aux.n = n11, n1_, n_1, n
    else:
        if n11 % 11 and n11 + aux.n - aux.n1_ - aux.n_1:
            if n11 == aux.n11 + 1:
                aux.p *= ((aux.n1_ - aux.n11) / n11
                          * (aux.n_1 - aux.n11)
                          / (n11 + aux.n - aux.n1_ - aux.n_1))
                aux.n11 = n11
                return aux.p
            if n11 == aux.n11 - 1:
                aux.p *= (aux.n11 / (aux.n1_ - n11)
                          * (aux.n11 + aux.n - aux.n1_ - aux.n_1)
                          / (aux.n_1 - n11))
                aux.n11 = n11
                return aux.p
        aux.n11 = n11
    aux.p = _hypergeo(aux.n11, aux.n1_, aux.n_1, aux.n)
    return aux.p


def kt_fisher_exact(n11: int, n12: int, n21: int, n22: int,
                    ) -> Tuple[float, float, float, float]:
    """Returns (p_of_table, left, right, two)."""
    n1_ = n11 + n12
    n_1 = n11 + n21
    n = n11 + n12 + n21 + n22
    mx = min(n_1, n1_)
    mn = n1_ + n_1 - n
    if mn < 0:
        mn = 0
    if mn == mx:
        return 1.0, 1.0, 1.0, 1.0
    aux = _HGAcc()
    q = _hypergeo_acc(n11, n1_, n_1, n, aux)
    if q == 0.0:
        if n11 * (n + 2) < (n_1 + 1) * (n1_ + 1):
            return 0.0, 0.0, 1.0, 0.0
        return 0.0, 1.0, 0.0, 0.0
    # left tail
    p = _hypergeo_acc(mn, 0, 0, 0, aux)
    left = 0.0
    i = mn + 1
    while p < 0.99999999 * q and i <= mx:
        left += p
        p = _hypergeo_acc(i, 0, 0, 0, aux)
        i += 1
    i -= 1
    if p < 1.00000001 * q:
        left += p
    else:
        i -= 1
    # right tail
    p = _hypergeo_acc(mx, 0, 0, 0, aux)
    right = 0.0
    j = mx - 1
    while p < 0.99999999 * q and j >= 0:
        right += p
        p = _hypergeo_acc(j, 0, 0, 0, aux)
        j -= 1
    j += 1
    if p < 1.00000001 * q:
        right += p
    else:
        j += 1
    two = left + right
    if two > 1.0:
        two = 1.0
    if abs(i - n11) < abs(j - n11):
        right = 1.0 - left + q
    else:
        left = 1.0 - right + q
    return q, left, right, two
