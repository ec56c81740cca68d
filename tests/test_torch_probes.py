"""The port's two probe kernels on the CPU: P1, the gather probe's
slot-resolve chain (htslib_tpu_torch/probe_pallas_gather.py, kernel
csrc/resolve_cmp.cu), and P2, the ablation of the Nx16 order-0 round
(htslib_tpu_torch/probe_rans_ablate.py, kernel csrc/rans_ablate.cu), by
their plain versions.

Oracles: P1 against a numpy transcription of the script's `xla_chain`
(scripts/probe_pallas_gather.py:89-99) on the script's own `make_tables`;
P2's resolve step against the JAX `_resolve8` (ops/rans_pallas.py) on
`pack_tables`' telescoped tables (its two Mosaic primitives, a sublane
roll and a bitcast, given their jnp meanings: the scripts' kernels run
only on a TPU), the full mode against the port's host codec and B2's
plain version, and each other mode against a numpy model of its rule,
state by state."""
import importlib.util
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htslib_tpu.ops import rans_pallas as jrp
from htslib_tpu_torch import probe_pallas_gather as pg
from htslib_tpu_torch import probe_rans_ablate as pa
from htslib_tpu_torch.ops.rans_nx16 import rans_o0_plain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_U32 = 0xFFFFFFFF
ROUNDS = 64


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# -- P1 ---------------------------------------------------------------------

def test_p1_inputs_are_the_scripts():
    script = _script("probe_pallas_gather")
    rng = np.random.RandomState(7)
    cum, freqs, packed = script.make_tables(rng)
    x0 = rng.randint(1 << 23, 1 << 30, (script.G, script.NSTATES)).astype(
        np.int32)
    for got, want in zip(pg.make_inputs(), (cum, freqs, packed, x0)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (pg.G, pg.NSTATES, pg.ROUNDS) == (script.G, script.NSTATES,
                                             script.ROUNDS)


def _xla_chain(packed, x0, rounds):
    """scripts/probe_pallas_gather.py:89-99 in numpy: per round and state
    a gather of the packed slot entry, then the state update."""
    x = x0.astype(np.int64)
    gi = np.arange(packed.shape[0])[:, None]
    tbl = packed.astype(np.int64)
    for _ in range(rounds):
        m = x & (pg.TOTFREQ - 1)
        e = tbl[gi, m]
        x = (((e >> 8) & 0xFFF) + 1) * (x >> 12) + m - (e >> 20)
        x = (x + (1 << 31)) % (1 << 32) - (1 << 31)     # int32 wrap
    return x.astype(np.int32)


def test_p1_plain_matches_the_scripts_chain():
    cum, freqs, packed, x0 = pg.make_inputs()
    got = pg.resolve_cmp(cum, freqs, x0, pg.ROUNDS, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (pg.G, pg.NSTATES)
    assert np.array_equal(got.numpy(), _xla_chain(packed, x0, pg.ROUNDS))


@pytest.mark.parametrize("rounds", [0, 1, 7])
def test_p1_gather_yardstick_matches_plain(rounds):
    cum, freqs, packed, x0 = pg.make_inputs(seed=3)
    want = pg.resolve_cmp_plain(*(torch.from_numpy(a)
                                  for a in (cum, freqs, x0)), rounds)
    got = pg.gather_chain(torch.from_numpy(packed.view(np.int32)),
                          torch.from_numpy(x0), rounds)
    assert torch.equal(got, want)
    assert np.array_equal(got.numpy(), _xla_chain(packed, x0, rounds))


def test_p1_refuses_tables_it_cannot_build():
    cum, freqs, _packed, _x0 = pg.make_inputs()
    c, f = torch.from_numpy(cum), torch.from_numpy(freqs)
    pg.check_tables(c, f)
    bad = f.clone()
    bad[3, 5] += 1
    with pytest.raises(ValueError, match="normalised"):
        pg.check_tables(c, bad)
    with pytest.raises(ValueError, match="CUDA"):
        pg.resolve_cmp_cuda(c, f, torch.zeros((pg.G, 4), dtype=torch.int32))


# -- P2 ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def streams():
    raws = pa.quality_streams(n=6, size=ROUNDS * pa.NWAY, seed=5)
    return raws, pa.make_batch(raws, "cpu")


def _mosaic_as_jnp(monkeypatch):
    """The JAX round's two Mosaic primitives as jnp operations, so that
    `_resolve8` runs outside a TPU kernel: a sublane roll (whose
    direction cannot change a fold over all 8 rows) and a bitcast."""
    monkeypatch.setattr(jrp, "pltpu", types.SimpleNamespace(
        roll=lambda a, s, axis: jnp.roll(a, s, axis),
        bitcast=lambda x, t: jax.lax.bitcast_convert_type(x, t)))


def test_p2_resolve_step_matches_jax_resolve8(monkeypatch):
    _mosaic_as_jnp(monkeypatch)
    rng = np.random.RandomState(7)
    blocks, a = 32, 64
    freqs = rng.randint(1, 64, (blocks, 256)).astype(np.int64)
    freqs[:, a:] = 0
    freqs = np.maximum(freqs * pa.TOTFREQ // freqs.sum(1, keepdims=True), 1)
    freqs[:, a:] = 0
    freqs[:, 0] += pa.TOTFREQ - freqs.sum(1)
    lo, dfc = jrp.pack_tables(freqs, a)
    x = rng.randint(1 << 16, 1 << 31, (blocks, pa.NWAY)).astype(np.int64)
    lanes = x.reshape(1, -1).astype(np.uint32).view(np.int32)
    sym, nxt = jrp._resolve8(jnp.asarray(np.broadcast_to(lanes, (8, 1024))),
                             jnp.asarray(np.repeat(lo, pa.NWAY, axis=1)),
                             jnp.asarray(np.repeat(dfc, pa.NWAY, axis=1)))
    got_s, got_x = pa.resolve_step(torch.from_numpy(freqs.astype(np.int32)),
                                   torch.from_numpy(x))
    assert np.array_equal(np.asarray(sym)[0], got_s.reshape(-1).numpy())
    assert np.array_equal(np.asarray(nxt)[0].view(np.uint32),
                          got_x.reshape(-1).numpy())


def test_p2_full_mode_is_the_host_decode_and_b2(streams):
    raws, b = streams
    syms, x, cur = pa.ablate(b, "full", ROUNDS)
    assert syms.shape == (ROUNDS, 6 * pa.NWAY) and syms.dtype == torch.int32
    assert np.array_equal(syms.numpy(), pa.raw_symbols(raws, ROUNDS))
    _, bx, bcur = rans_o0_plain(b, max_rounds=ROUNDS // 2)
    _s, hx, hcur = pa.ablate(b, "full", ROUNDS // 2)
    assert torch.equal(hx, bx.reshape(-1))
    assert torch.equal(hcur, bcur.repeat_interleave(pa.NWAY))


def _words(b):
    w = (b.payload.view(torch.int16).long() & 0xFFFF).numpy()
    return [w[int(o):int(o) + int(n)] for o, n in zip(b.word_off, b.n_words)]


def _model(b, mode, rounds):
    """Each mode's rule in numpy, stream by stream and state by state in
    the wire's order."""
    words = _words(b)
    S = b.n_streams
    f_all = b.freqs.long().numpy()
    syms = np.zeros((rounds, S, pa.NWAY), np.int64)
    xs = b.x0.long().numpy() & _U32
    curs = np.zeros((S, pa.NWAY), np.int64)
    for i in range(S):
        w, n = words[i], len(words[i])
        f = f_all[i]
        cum = np.cumsum(f) - f
        owner = np.repeat(np.arange(256), f)
        x = xs[i].copy()
        lane_cur = np.zeros(pa.NWAY, np.int64)
        cur = 0
        for r in range(rounds):
            if mode == "only_loop":
                syms[r, i] = x
                x = (x + 1) & _U32
                continue
            if mode == "slice_cost":
                at = cur + np.arange(pa.NWAY)
                syms[r, i] = np.where(at < n, w[np.minimum(at, n - 1)], 0)
                cur = min(cur + pa.NWAY, n)
                continue
            used = 0
            for j in range(pa.NWAY):
                if mode == "no_resolve":
                    syms[r, i, j] = x[j] & 4095
                    x[j] = (x[j] * 5 + 7) & 0x7FFFFFFF
                else:
                    s = owner[x[j] & 4095]
                    syms[r, i, j] = s
                    x[j] = f[s] * (x[j] >> 12) + (x[j] & 4095) - cum[s]
                if x[j] >= 1 << 15:
                    continue
                if mode == "no_scan":
                    at = lane_cur[j]
                    lane_cur[j] = min(at + 1, n)
                else:
                    at = cur + used
                    used += 1
                word = 1 if mode == "no_select" else (w[at] if at < n
                                                      else 0)
                x[j] = ((x[j] << 16) | word) & _U32
            cur = min(cur + used, n)
        xs[i] = x
        curs[i] = lane_cur if mode == "no_scan" else cur
    return (syms.reshape(rounds, -1).astype(np.int32),
            xs.reshape(-1).astype(np.uint32).view(np.int32),
            curs.reshape(-1).astype(np.int32))


@pytest.mark.parametrize("mode", pa.MODES)
def test_p2_mode_follows_its_rule(streams, mode):
    _raws, b = streams
    got = pa.ablate(b, mode, ROUNDS)
    for g, w in zip(got, _model(b, mode, ROUNDS)):
        assert np.array_equal(g.numpy(), w)


def test_p2_modes_differ_from_full(streams):
    """Each ablation removes something the full round computes: no mode
    gives the full round's symbols, states and cursors together."""
    _raws, b = streams
    full = pa.ablate(b, "full", ROUNDS)
    for mode in pa.MODES[1:]:
        got = pa.ablate(b, mode, ROUNDS)
        assert not all(torch.equal(g, f) for g, f in zip(got, full)), mode


def test_p2_refuses_what_the_kernel_cannot_take(streams):
    _raws, b = streams
    with pytest.raises(ValueError, match="unknown mode"):
        pa.ablate(b, "no_such_mode", 4)
    mono = pa.make_batch([bytes([7]) * (4 * pa.NWAY)], "cpu")
    with pytest.raises(ValueError, match="one symbol"):
        pa.check_batch(mono, "full")
    pa.check_batch(mono, "only_loop")
    with pytest.raises(ValueError, match="CUDA"):
        pa.ablate_cuda(b, "full", 4)


def test_probe_mains_need_a_card(capsys):
    """Without a card both probes print an error and fail, and neither
    touches the JAX probe's committed PROBE_RANS_ABLATE.json."""
    if torch.cuda.is_available():
        pytest.skip("runs where there is no CUDA device")
    path = os.path.join(REPO, "PROBE_RANS_ABLATE.json")
    before = open(path, "rb").read()
    assert pg.main() == 1
    assert pa.main() == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln) for ln in lines] == [{"error": "no CUDA device"}] * 2
    assert open(path, "rb").read() == before
