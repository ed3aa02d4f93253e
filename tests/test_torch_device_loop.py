"""The device-resident CP phase loops of the port (models/cp.py:
``dt_phase_device``, ``pp_phase_device``, ``als_cp_pp_device``; ``test_als
-pp 1 -device_loop 1``) against the JAX package's ``lax.while_loop``
engine, on the CPU, from the same numpy tensor and factors.

The port issues each phase's sweeps in chunks of ``DEVICE_LOOP_CHUNK``
with the loop's state on the device, masking the sweeps issued after the
stop; the JAX package runs one while-loop. In float64 the two must agree
on every outcome: the sweep count n, the quiet flag, ``hist[:n]`` (the
per-sweep estimates) and the factors to 1e-8 relative (max-norm), the
snapshot ring's labels and count exactly. The cases stop on the quiet
test, on the restart tolerance, on the gradnorm guard (a reverted sweep)
and on a budget that is not a multiple of the chunk. float32: the same
rows and decisions, factors to F32_TOL.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pairwise_perturbation_tpu import cli as jcli
from pairwise_perturbation_tpu.models import cp as jcp
from pairwise_perturbation_tpu_torch import cli
from pairwise_perturbation_tpu_torch.models import cp as tcp

from test_torch_partupdate import _csv, _jax_factors, assert_same_csv

torch.set_num_threads(1)

TOL = 1e-8
# float32 factors after a 40-sweep run: round-off of sums in other orders
# (and another eigh), grown through the solves of both phase kinds (4.4e-6
# seen on the CPU).
F32_TOL = 1e-4
SHAPE, R = (6, 6, 6, 6), 3
# the phases' static settings, shared by every case so that the JAX
# package compiles each phase once
DT_MAX, PP_MAX, RESPRINT, SLOTS = 40, 15, 2, 8
ENGINE_CFG = dict(tol=0.0, pp_res_tol=0.1, maxiter=39, resprint=2)


def _problem(seed=0):
    """A rank-3 tensor plus 1% noise and the JAX package's initial
    factors for it."""
    rng = np.random.default_rng(seed)
    truth = [rng.random((s, R)) for s in SHAPE]
    V = np.einsum("ar,br,cr,dr->abcd", *truth)
    V = V + 0.01 * np.linalg.norm(V) / np.sqrt(V.size) \
        * rng.standard_normal(SHAPE)
    W0 = [np.array(w) for w in jcp.init_factors(
        SHAPE, R, key=jax.random.PRNGKey(seed), dtype=jnp.float64)]
    return V, W0


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))),
                                              1e-300)


def _same_ring(port, jax_out):
    assert port[-1].item() == int(jax_out[-1])
    assert port[-2].tolist() == np.asarray(jax_out[-2]).tolist()
    for a, b in zip(port[-3], jax_out[-3]):
        assert _rel(a, b) <= TOL


@pytest.mark.parametrize("budget,tol_init,stop", [
    (DT_MAX, 0.05, "quiet"),       # quiet after 5 sweeps: 1 masked
    (DT_MAX, 0.1, "quiet"),        # quiet after 4: two chunks, none masked
    (5, 1e-6, "budget"),           # the budget, 5 = two chunks and a half
])
def test_dt_phase_device_matches_jax(budget, tol_init, stop):
    V, W0 = _problem()
    jo = jcp.dt_phase_device(
        jnp.asarray(V), [jnp.asarray(w) for w in W0], jnp.asarray(0.0),
        jnp.asarray(tol_init), jnp.asarray(0.0), jnp.asarray(budget), None,
        jnp.asarray(3), jnp.asarray(7), solver="svd", max_sweeps=DT_MAX,
        resprint=RESPRINT, n_slots=SLOTS)
    tcp.reset_device_loop_counts()
    po = tcp.dt_phase_device(_t(V), [_t(w) for w in W0], 0.0, tol_init, 0.0,
                             budget, 3, 7, solver="svd", max_sweeps=DT_MAX,
                             resprint=RESPRINT, n_slots=SLOTS)
    n = int(jo[0])
    assert po[0] == n and bool(po[4]) == bool(jo[4]) == (stop == "quiet")
    assert n == budget or stop == "quiet"
    assert _rel(po[5][:n], jo[5][:n]) <= TOL
    for a, b in zip(po[1] + po[2], list(jo[1]) + list(jo[2])):
        assert _rel(a, b) <= TOL
    assert _rel(po[3], jo[3]) <= TOL
    _same_ring(po, jo)
    counts = tcp.DEVICE_LOOP_COUNTS
    chunks = -(-counts["dt_issued"] // tcp.DEVICE_LOOP_CHUNK)
    assert counts["dt_issued"] - counts["dt_masked"] == n
    assert counts["pulls"] == chunks
    assert counts["dt_masked"] < tcp.DEVICE_LOOP_CHUNK
    assert counts["pp_issued"] == 0


def _warm(V, W0, sweeps=6):
    Ws = [_t(w) for w in W0]
    for _ in range(sweeps):
        Ws, _ = tcp.dt_sweep(_t(V), Ws, 0.0, solver="svd")
    return [w.numpy() for w in Ws]


@pytest.mark.parametrize("budget,tol_init,guard,n_want", [
    (PP_MAX, 0.05, 10.0, 3),   # the restart tolerance trips
    (PP_MAX, 0.5, 10.0, 9),    # the guard reverts the ninth sweep
    (PP_MAX, 0.5, 1.0, 2),     # the guard reverts the second: gn rose
    (5, 0.9, 10.0, 5),         # the budget, mid-way through a chunk
])
def test_pp_phase_device_matches_jax(budget, tol_init, guard, n_want):
    V, W0 = _problem()
    Wn = _warm(V, W0)
    jo = jcp.pp_phase_device(
        jnp.asarray(V), [jnp.asarray(w) for w in Wn], jnp.asarray(0.0), 1.0,
        jnp.asarray(tol_init), jnp.asarray(0.0), jnp.asarray(budget),
        jnp.asarray(6), None, jnp.asarray(11), jnp.asarray(guard),
        solver="svd", max_sweeps=PP_MAX, resprint=RESPRINT, n_slots=SLOTS)
    tcp.reset_device_loop_counts()
    po = tcp.pp_phase_device(_t(V), [_t(w) for w in Wn], 0.0, 1.0, tol_init,
                             0.0, budget, 6, 11, guard, solver="svd",
                             max_sweeps=PP_MAX, resprint=RESPRINT,
                             n_slots=SLOTS)
    n = int(jo[0])
    assert po[0] == n == n_want
    h = np.asarray(jo[4])[:n]
    assert _rel(po[4][:n], h) <= TOL
    if guard == 1.0:   # the reverted sweep repeats the row before it
        assert h[1, 0] == h[0, 0]
    for a, b in zip(po[1] + po[2], list(jo[1]) + list(jo[2])):
        assert _rel(a, b) <= TOL
    assert _rel(po[3], jo[3]) <= TOL
    _same_ring(po, jo)
    assert tcp.DEVICE_LOOP_COUNTS["pp_issued"] - \
        tcp.DEVICE_LOOP_COUNTS["pp_masked"] == n


def _hist(res):
    return [(h["iter"], h["pp"], h["gradnorm"], h["diffV"])
            for h in res.history]


def test_als_cp_pp_device_matches_jax():
    """The whole engine in float64: the same logged rows (iter, pp, exact
    gradnorm and diffV on every logged row) and factors to 1e-8, through
    several DT <-> PP switches."""
    V, W0 = _problem()
    rj = jcp.als_cp_pp_device(jnp.asarray(V), [jnp.asarray(w) for w in W0],
                              jcp.CPConfig(**ENGINE_CFG))
    tcp.reset_device_loop_counts()
    rt = tcp.als_cp_pp_device(_t(V), [_t(w) for w in W0],
                              tcp.CPConfig(**ENGINE_CFG))
    want, got = _hist(rj), _hist(rt)
    assert [h[:2] for h in got] == [h[:2] for h in want]
    flags = [h[1] for h in want]
    assert sum(1 for a, b in zip(flags, flags[1:]) if (a, b) == (0, 1)) >= 2
    for g, w in zip(got, want):
        for a, b in zip(g[2:], w[2:]):
            assert abs(a - b) <= TOL * abs(b), (g, w)
    for a, b in zip(rt.factors, rj.factors):
        assert _rel(a, b) <= TOL
    assert rt.iters == rj.iters
    assert abs(rt.gradnorm - rj.gradnorm) <= TOL * abs(rj.gradnorm)
    counts = tcp.DEVICE_LOOP_COUNTS
    assert counts["dt_masked"] + counts["pp_masked"] > 0
    assert counts["dt_issued"] + counts["pp_issued"] - counts["dt_masked"] \
        - counts["pp_masked"] == ENGINE_CFG["maxiter"] + 1


def test_als_cp_pp_device_f32_matches_jax():
    """float32 V and factors: the same rows and decisions, the factors
    within F32_TOL of the JAX package's float32 run."""
    V, W0 = _problem()
    V32, W32 = V.astype(np.float32), [w.astype(np.float32) for w in W0]
    rj = jcp.als_cp_pp_device(jnp.asarray(V32), [jnp.asarray(w) for w in W32],
                              jcp.CPConfig(**ENGINE_CFG))
    rt = tcp.als_cp_pp_device(_t(V32), [_t(w) for w in W32],
                              tcp.CPConfig(**ENGINE_CFG))
    assert [h[:2] for h in _hist(rt)] == [h[:2] for h in _hist(rj)]
    assert all(w.dtype == torch.float32 for w in rt.factors)
    for a, b in zip(rt.factors, rj.factors):
        assert _rel(a, b) <= F32_TOL


@pytest.mark.parametrize("chunk", [1, 3, 16])
def test_chunk_size_changes_no_result(monkeypatch, chunk):
    """Any chunk size gives the same run bit for bit: a masked sweep
    changes no state. Pulls: one a chunk."""
    V, W0 = _problem(1)
    cfg = tcp.CPConfig(**ENGINE_CFG)
    base = tcp.als_cp_pp_device(_t(V), [_t(w) for w in W0], cfg)
    monkeypatch.setattr(tcp, "DEVICE_LOOP_CHUNK", chunk)
    tcp.reset_device_loop_counts()
    other = tcp.als_cp_pp_device(_t(V), [_t(w) for w in W0], cfg)
    assert _hist(other) == _hist(base)
    assert all(torch.equal(a, b) for a, b in zip(other.factors,
                                                 base.factors))
    if chunk == 1:
        assert tcp.DEVICE_LOOP_COUNTS["dt_masked"] == \
            tcp.DEVICE_LOOP_COUNTS["pp_masked"] == 0


def test_device_engine_same_fit_as_host_engine():
    """The port's device engine fits as well as its host engine (JAX
    tests/test_device_loop.py:72-80)."""
    V, W0 = _problem()
    Vn = float(np.linalg.norm(V))
    cfg = tcp.CPConfig(tol=0.0, pp_res_tol=0.1, maxiter=60, resprint=20)
    host = tcp.als_cp_pp(_t(V), [_t(w) for w in W0], cfg)
    dev = tcp.als_cp_pp_device(_t(V), [_t(w) for w in W0], cfg)
    assert any(h["pp"] == 1 for h in dev.history)
    assert dev.diffV < max(10 * host.diffV, 1e-5 * Vn)


def test_cli_device_loop_matches_jax(tmp_path, monkeypatch):
    """test_als -model CP -pp 1 -device_loop 1 through both CLIs in
    float64, the port's handed the JAX package's initial factors: the
    CSVs agree but for [dtime]."""
    monkeypatch.setattr(tcp, "init_factors", _jax_factors)
    argv = ["test_als", "-model", "CP", "-tensor", "r", "-dim", "4",
            "-size", "6", "-rank", "3", "-pp", "1", "-device_loop", "1",
            "-maxiter", "19", "-resprint", "1", "-pp_res_tol", "0.1",
            "-dtype", "float64"]
    got = _csv(cli.main, tmp_path / "port.csv", argv + ["-device", "cpu"])
    want = _csv(jcli.main, tmp_path / "jax.csv", argv)
    assert {r[4] for r in want[1:]} == {"0", "1"}
    assert_same_csv(got, want)
