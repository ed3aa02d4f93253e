"""Tucker's device engines in the port (models/tucker.py: the phase loops
``tucker_dt_phase_device``, ``tucker_pp_phase_device``,
``als_tucker_pp_device``; the fused machine ``tucker_fused_init``,
``tucker_fused_chunk``, ``als_tucker_pp_fused``; ``test_als -model Tucker
-pp 1 -device_loop 1`` and ``2``) against the JAX package's, on the CPU,
from the same numpy tensor.

float64: the same sweep counts and decisions, the same logged (iter, pp)
rows, diffV to TOL relative and diffnorm to TOL of the core norm (a
diffnorm is the difference of two core norms, at round-off once the run
settles), factors and cores to TOL (relative max-norm). float32: the same
rows, factors to F32_TOL. The problem, a 6^4 uniform random tensor at
ranks (2, 2, 2, 2) from tol_init 0.05, switches DT -> PP three times or
more in 30 sweeps, so tol_init decays between PP phases. No port kernel
serves Tucker: the engines reach no kernel wrapper.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pairwise_perturbation_tpu import cli as jcli
from pairwise_perturbation_tpu.models import tucker as jtk
from pairwise_perturbation_tpu_torch import cli, config
from pairwise_perturbation_tpu_torch.models import cp as tcp
from pairwise_perturbation_tpu_torch.models import tucker as ttk
from pairwise_perturbation_tpu_torch.ops.kernels import (
    column_sum, coo_mttkrp, last_contract, mid_contract, mttkrp3,
    triple_roots)

from test_torch_device_loop import _rel, _t
from test_torch_partupdate import _csv

torch.set_num_threads(1)

TOL = 1e-8
# float32 factors after 30 sweeps of both phase kinds (eigh and sums in
# other orders; 6e-7 seen).
F32_TOL = 1e-4
SHAPE, RANKS = (6, 6, 6, 6), (2, 2, 2, 2)
CFG = dict(tol=0.0, pp_res_tol=0.05, maxiter=30, resprint=1,
           subspace_iters=0)
ENGINES = ("als_tucker_pp_device", "als_tucker_pp_fused")


def _problem(seed=1):
    return np.random.default_rng(seed).random(SHAPE)


def _hosvd(V):
    _, Ws = jtk.hosvd(jnp.asarray(V), RANKS)
    return [np.array(w) for w in Ws]


def _hist(res):
    return [(h["iter"], h["pp"], h["diffnorm"], h["diffV"])
            for h in res.history]


def _run(name, V, cfg, **kw):
    rj = getattr(jtk, name)(jnp.asarray(V), RANKS, jtk.TuckerConfig(**cfg),
                            **kw)
    tcp.reset_device_loop_counts()
    rt = getattr(ttk, name)(_t(V), RANKS, ttk.TuckerConfig(**cfg), **kw)
    return rt, rj


def _assert_same(rt, rj, tol=TOL, values=True):
    got, want = _hist(rt), _hist(rj)
    assert [h[:2] for h in got] == [h[:2] for h in want]
    if values:
        cn = float(np.linalg.norm(np.asarray(rj.core)))
        for g, w in zip(got, want):
            if np.isfinite(w[2]):
                assert abs(g[2] - w[2]) <= tol * cn, (g, w)
            else:
                assert g[2] == w[2]
            assert abs(g[3] - w[3]) <= tol * w[3], (g, w)
        assert _rel(rt.core, rj.core) <= tol
    for a, b in zip(rt.factors, rj.factors):
        assert _rel(a, b) <= tol
    assert rt.iters == rj.iters


def _pp_phases(res):
    flags = [h["pp"] for h in res.history]
    return sum(1 for a, b in zip(flags, flags[1:]) if (a, b) == (0, 1))


@pytest.mark.parametrize("budget,tol_init,n_want", [
    (31, 0.05, 3),     # every mode quiet after three sweeps
    (5, 1e-9, 5),      # the budget, mid-way through a chunk
])
def test_tucker_dt_phase_device_matches_jax(budget, tol_init, n_want):
    V = _problem()
    W0 = _hosvd(V)
    jo = jtk.tucker_dt_phase_device(
        jnp.asarray(V), [jnp.asarray(w) for w in W0], jnp.asarray(tol_init),
        jnp.asarray(0.0), jnp.asarray(budget), ranks=RANKS, max_sweeps=31)
    tcp.reset_device_loop_counts()
    po = ttk.tucker_dt_phase_device(_t(V), [_t(w) for w in W0], tol_init,
                                    0.0, budget, ranks=RANKS, max_sweeps=31)
    n = int(jo[0])
    assert po[0] == n == n_want and bool(po[5]) == bool(jo[5])
    assert _rel(po[6][:n], np.asarray(jo[6])[:n]) <= TOL
    for a, b in zip(po[1] + po[2], list(jo[1]) + list(jo[2])):
        assert _rel(a, b) <= TOL
    assert _rel(po[3], jo[3]) <= TOL
    assert abs(float(po[4]) - float(jo[4])) <= TOL * float(jo[4])
    c = tcp.DEVICE_LOOP_COUNTS
    assert c["dt_issued"] - c["dt_masked"] == n and c["pp_issued"] == 0


def _warm(V, W0, sweeps=3):
    Ws = [_t(w) for w in W0]
    for _ in range(sweeps):
        Ws, _ = ttk.tucker_dt_sweep(_t(V), Ws, Ws, ranks=RANKS,
                                    use_sign=True)
    return [w.numpy() for w in Ws]


@pytest.mark.parametrize("budget,tol_init,quiet,n_want", [
    (31, 0.05, 0.0, 4),     # a factor drifts past tol_init
    (4, 0.5, 0.0, 4),       # the budget
    (31, 0.05, 0.5, 2),     # every mode quiet-skipped: stationary
])
def test_tucker_pp_phase_device_matches_jax(budget, tol_init, quiet,
                                            n_want):
    V = _problem()
    Wn = _warm(V, _hosvd(V))
    jo = jtk.tucker_pp_phase_device(
        jnp.asarray(V), [jnp.asarray(w) for w in Wn], jnp.asarray(tol_init),
        jnp.asarray(0.0), jnp.asarray(budget), jnp.asarray(3),
        jnp.asarray(quiet * tol_init), ranks=RANKS, max_sweeps=31,
        resprint=2, n_slots=18)
    po = ttk.tucker_pp_phase_device(_t(V), [_t(w) for w in Wn], tol_init,
                                    0.0, budget, 3, quiet * tol_init,
                                    ranks=RANKS, max_sweeps=31, resprint=2,
                                    n_slots=18)
    n = int(jo[0])
    assert po[0] == n == n_want
    assert _rel(po[5][:n], np.asarray(jo[5])[:n]) <= TOL
    for a, b in zip(po[1] + po[2], list(jo[1]) + list(jo[2])):
        assert _rel(a, b) <= TOL
    assert _rel(po[3], jo[3]) <= TOL
    assert po[-1].item() == int(jo[-1])
    assert po[-2].tolist() == np.asarray(jo[-2]).tolist()
    for a, b in zip(po[-3], jo[-3]):
        assert _rel(a, b) <= TOL


@pytest.mark.parametrize("name", ENGINES)
def test_engine_matches_jax(name):
    """The whole engine in float64: the same logged rows (diffV exact on
    every PP row from the ring, diffnorm where exact), factors, core and
    iterations, through three or more DT -> PP switches and the tol_init
    decay between them."""
    V = _problem()
    rt, rj = _run(name, V, CFG)
    _assert_same(rt, rj)
    assert _pp_phases(rj) >= 3
    c = tcp.DEVICE_LOOP_COUNTS
    if name == "als_tucker_pp_fused":
        assert c["fused_dt"] + c["fused_pp"] == CFG["maxiter"] + 1
        assert c["fused_build"] >= 3 and c["pulls"] == 0
        assert c["fused_pulls"] == c["fused_dt"] + c["fused_pp"] \
            + 3 * c["fused_chunks"]
    else:
        assert c["dt_issued"] + c["pp_issued"] - c["dt_masked"] \
            - c["pp_masked"] == CFG["maxiter"] + 1
        assert c["fused_pulls"] == 0


@pytest.mark.parametrize("name", ENGINES)
def test_engine_f32_matches_jax(name):
    """float32 V: the same rows and decisions, factors within F32_TOL."""
    rt, rj = _run(name, _problem().astype(np.float32), CFG)
    assert all(w.dtype == torch.float32 for w in rt.factors)
    _assert_same(rt, rj, F32_TOL, values=False)


@pytest.mark.parametrize("name", ENGINES)
def test_engine_quiet_skip_matches_jax(name):
    """pp_quiet_frac 0.5: PP sweeps skip quiet modes and a stationary
    sweep ends the phase; the same rows and factors as the JAX
    package's."""
    rt, rj = _run(name, _problem(), dict(CFG, pp_quiet_frac=0.5))
    _assert_same(rt, rj)
    assert _pp_phases(rj) >= 3


def test_tucker_fused_chunk_decays_tol_init_as_jax():
    """Chunk by chunk in float64: the same iteration, stop flag, phase,
    history and factors after each chunk, and tol_init, which rides in
    the carry, decays on each PP -> DT transition as the JAX carry's
    does."""
    V = _problem()
    W0 = _hosvd(V)
    dj = {k: jnp.asarray(v) for k, v in dict(
        tol=0.0, decay=0.9, floor=5e-3, quiet=0.0).items()}
    jc = jtk.tucker_fused_init(jnp.asarray(V), [jnp.asarray(w) for w in W0],
                               RANKS, 32, 12) + (jnp.asarray(0.05),)
    pc = ttk.tucker_fused_init(_t(V), [_t(w) for w in W0], RANKS, 32, 12,
                               0.05)
    tols = []
    for _ in range(8):
        jc = jtk.tucker_fused_chunk(
            jnp.asarray(V), jc, dj["tol"], dj["tol"], jnp.asarray(30),
            dj["decay"], dj["floor"], dj["quiet"], ranks=RANKS,
            subspace_iters=0, chunk=6, resprint=1, pp_cap=15, max_hist=32,
            n_slots=12)
        ttk.tucker_fused_chunk(_t(V), pc, 0.0, 30, 0.9, 5e-3, 0.0,
                               ranks=RANKS, chunk=6, resprint=1, n_slots=12)
        it = int(jc[0])
        assert (pc["it"], pc["stop"], pc["phase"]) == (
            it, bool(jc[12]), int(jc[1]))
        assert pc["tol_init"] == float(jc[17])
        tols.append(pc["tol_init"])
        assert _rel(pc["hist"][:it + 1], np.asarray(jc[13])[:it + 1]) <= TOL
        for a, b in zip(pc["Ws"], jc[3]):
            assert _rel(a, b) <= TOL
        assert pc["count"].item() == int(jc[16])
        pc["count"].zero_()
        pc["slot"] = 0
        jc = jc[:16] + (jnp.asarray(0),) + jc[17:]
        if pc["stop"]:
            break
    assert pc["stop"] and len(set(tols)) >= 3 and tols[-1] < 0.05


@pytest.mark.parametrize("name", ENGINES)
def test_engines_launch_no_kernel(monkeypatch, name):
    """Tucker reaches no kernel wrapper, in either engine, with every
    kernel switch on (the JAX package reaches no pl.pallas_call here)."""
    calls = []
    for mod, fn in ((mttkrp3, "mttkrp3_mode"), (mid_contract, "mid_contract"),
                    (last_contract, "last_contract"),
                    (triple_roots, "triple_roots"),
                    (coo_mttkrp, "coo_mttkrp"), (column_sum, "column_sum")):
        monkeypatch.setattr(mod, fn, lambda *a, _fn=fn, **k: calls.append(
            _fn))
    V = _problem().astype(np.float32)
    with config.override(use_kernels=True, use_kernels_first=True,
                         use_kernels_triple=True):
        res = getattr(ttk, name)(_t(V), RANKS, ttk.TuckerConfig(
            **dict(CFG, maxiter=12)))
    assert {h["pp"] for h in res.history} == {0, 1}
    assert calls == []


@pytest.mark.parametrize("loop", ["1", "2"])
def test_cli_tucker_device_loop_matches_jax(tmp_path, loop):
    """test_als -model Tucker -pp 1 -device_loop 1 and 2 through both CLIs
    in float64 (both from HOSVD): the CSVs agree but for [dtime], on
    logged rows of both phase kinds."""
    argv = ["test_als", "-model", "Tucker", "-tensor", "r2", "-dim", "4",
            "-size", "6", "-rank", "2", "-pp", "1", "-device_loop", loop,
            "-maxiter", "14", "-resprint", "1", "-pp_res_tol", "0.05",
            "-tucker_subspace", "0", "-dtype", "float64"]
    got = _csv(cli.main, tmp_path / "port.csv", argv + ["-device", "cpu"])
    want = _csv(jcli.main, tmp_path / "jax.csv", argv)
    assert got[0] == want[0] and len(got) == len(want) > 2
    assert {r[4] for r in want[1:]} == {"0", "1"}
    cn = max(float(r[5]) for r in want[1:])
    for g, w in zip(got[1:], want[1:]):
        assert (g[0], g[1], g[3], g[4]) == (w[0], w[1], w[3], w[4])
        if w[2] == "inf":
            assert g[2] == "inf"
        else:
            assert abs(float(g[2]) - float(w[2])) <= TOL * cn, (g, w)
        assert abs(float(g[5]) - float(w[5])) <= TOL * float(w[5]), (g, w)
