"""The port's kfunc.py and errmod.py against the JAX package's: the
reference's test_kfunc.c cases of tests/test_math.py, a seeded grid of
arguments, and Errmod(depcorr).cal on seeded bases, all bit-equal in
float64 (float32 for cal's output, as the JAX function returns it)."""
import math

import numpy as np
import pytest

from htslib_tpu import errmod as jerr
from htslib_tpu import kfunc as jk
from htslib_tpu_torch import errmod as terr
from htslib_tpu_torch import kfunc as tk
from tests.test_math import FISHER_CASES


def _same(a, b):
    """Bit-equal floats (NaN equal to NaN), or equal values."""
    if isinstance(a, float) or isinstance(b, float):
        return np.float64(a).tobytes() == np.float64(b).tobytes()
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("n11,n12,n21,n22,left,right,two", FISHER_CASES)
def test_fisher_exact_cases(n11, n12, n21, n22, left, right, two):
    got = tk.kt_fisher_exact(n11, n12, n21, n22)
    assert _same(got, jk.kt_fisher_exact(n11, n12, n21, n22))
    _, l, r, t = got
    assert l == pytest.approx(left, abs=1e-9)
    assert r == pytest.approx(right, abs=1e-9)
    assert t == pytest.approx(two, abs=1e-9)


def test_lgamma_erfc_cases():
    for z in [0.5, 1.0, 2.5, 10.0, 100.0]:
        assert _same(tk.kf_lgamma(z), jk.kf_lgamma(z))
        assert tk.kf_lgamma(z) == pytest.approx(math.lgamma(z), rel=1e-10)
    for x in [-3.0, -1.0, 0.0, 0.5, 1.0, 2.0, 5.0]:
        assert _same(tk.kf_erfc(x), jk.kf_erfc(x))
        assert tk.kf_erfc(x) == pytest.approx(math.erfc(x), rel=1e-6)


def test_gamma_beta_cases():
    for s, z in [(1.0, 0.5), (3.0, 5.5), (10.0, 3.0), (0.5, 0.5)]:
        assert _same(tk.kf_gammap(s, z), jk.kf_gammap(s, z))
        assert _same(tk.kf_gammaq(s, z), jk.kf_gammaq(s, z))
        assert tk.kf_gammap(s, z) + tk.kf_gammaq(s, z) == pytest.approx(
            1.0, abs=1e-12)
    assert tk.kf_betai(2, 2, 0.5) == pytest.approx(0.5, abs=1e-12)
    assert tk.kf_betai(2, 3, 0.0) == 0.0 and tk.kf_betai(2, 3, 1.0) == 1.0


@pytest.mark.parametrize("seed", range(4))
def test_kfunc_seeded_grid_bit_equal(seed):
    rng = np.random.default_rng(seed)
    for z in rng.uniform(0.01, 300.0, 60):
        assert _same(tk.kf_lgamma(float(z)), jk.kf_lgamma(float(z)))
    for x in np.concatenate([rng.uniform(-10, 10, 60), [-27.0, 27.0, 0.0]]):
        assert _same(tk.kf_erfc(float(x)), jk.kf_erfc(float(x)))
    for s, z in rng.uniform(0.05, 80.0, (60, 2)):
        assert _same(tk.kf_gammap(float(s), float(z)),
                     jk.kf_gammap(float(s), float(z)))
        assert _same(tk.kf_gammaq(float(s), float(z)),
                     jk.kf_gammaq(float(s), float(z)))
    for a, b in rng.uniform(0.1, 50.0, (60, 2)):
        x = float(rng.uniform(0, 1))
        assert _same(tk.kf_betai(float(a), float(b), x),
                     jk.kf_betai(float(a), float(b), x))
    for n in rng.integers(0, 400, (40, 4)):
        args = [int(v) for v in n]
        assert _same(tk.kt_fisher_exact(*args), jk.kt_fisher_exact(*args))


@pytest.fixture(scope="module")
def models():
    """Errmod at two depcorr values on both sides: each build is about
    four million Python steps, so the module builds them once."""
    return {d: (terr.Errmod(d), jerr.Errmod(d)) for d in (0.17, 0.03)}


def test_errmod_tables_bit_equal(models):
    for mine, theirs in models.values():
        for name in ("fk", "beta", "lhet"):
            a, b = getattr(mine, name), getattr(theirs, name)
            assert a.dtype == b.dtype == np.float64
            assert np.array_equal(a.view(np.uint64), b.view(np.uint64)), name


def _bases(rng, n, n_alleles=4, biased=True):
    """n seeded errmod bases (qual << 5 | strand << 4 | base), qualities
    0-70 (past the clamp at 63) and, where biased, mostly two bases."""
    base = (rng.choice(2, n) if biased else rng.integers(0, n_alleles, n))
    if biased:
        flip = rng.random(n) < 0.1
        base[flip] = rng.integers(0, n_alleles, int(flip.sum()))
    return ((rng.integers(0, 71, n) << 5) | (rng.integers(0, 2, n) << 4)
            | base).tolist()


@pytest.mark.parametrize("depth", [0, 1, 2, 7, 30, 255, 256, 300, 600])
def test_errmod_cal_bit_equal(models, depth):
    rng = np.random.default_rng(depth + 11)
    for d, (mine, theirs) in models.items():
        for m in (2, 4, 5):
            for biased in (True, False):
                bases = _bases(rng, depth, min(m, 4), biased)
                got = mine.cal(m, list(bases))
                want = theirs.cal(m, list(bases))
                assert got.dtype == want.dtype == np.float32
                assert np.array_equal(got.view(np.uint32),
                                      want.view(np.uint32)), (d, m, depth)


def test_errmod_basic_cases(models):
    em = models[0.17][0]
    q = em.cal(4, [(30 << 5) | 0] * 10)
    assert q[0, 0] == 0.0 and q[1, 1] > 100 and q[0, 1] > 0
    q2 = em.cal(4, [(30 << 5) | 0] * 5 + [(30 << 5) | 1] * 5)
    assert q2[0, 1] < q2[0, 0] and q2[0, 1] < q2[1, 1]
