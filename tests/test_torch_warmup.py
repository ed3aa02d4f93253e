"""The engines' warm-ups (models/cp.warm_run) and what ``dtime`` keeps out:
each engine family runs its sweep functions once before its loop, where
the JAX package runs ``warm_compile``, in the clock's excluded window (the
device engines restart their clocks after), and the host PP engines reuse
the warm cache build as their first.

On the CPU, for every family: the rows other than ``dtime`` and the
factors are bit for bit those of a run whose warm-up is a no-op, the
loops' counters (DEVICE_LOOP_COUNTS) are the same, and no generator is
drawn from; a warm-up that sleeps 0.3 s leaves the first row's ``dtime``
below 0.3 s. The reused build is the very tensors the first PP sweep
reads. warm_run raises what its function raises, records no tracing
scope inside it and leaves the loops' counters as they were.
"""

import time

import numpy as np
import pytest
import torch

from pairwise_perturbation_tpu_torch import cli
from pairwise_perturbation_tpu_torch.models import cp as tcp
from pairwise_perturbation_tpu_torch.models import sparse_cp, sparse_tucker
from pairwise_perturbation_tpu_torch.models import tucker as ttk
from pairwise_perturbation_tpu_torch.ops import sparse as tsp
from pairwise_perturbation_tpu_torch.utils import tracing
from pairwise_perturbation_tpu_torch.utils.metrics import SweepClock

torch.set_num_threads(1)

SLEEP_S = 0.3
CP_SHAPE, CP_R = (6, 5, 7, 6), 3
TK_SHAPE, TK_RANKS = (8, 9, 10), (3, 3, 3)
SP_SHAPE = (6, 7, 5, 6)


def _cp_problem():
    rng = np.random.default_rng(0)
    truth = [rng.random((s, CP_R)) for s in CP_SHAPE]
    V = np.einsum("ar,br,cr,dr->abcd", *truth)
    V = V + 0.01 * np.linalg.norm(V) / np.sqrt(V.size) \
        * rng.standard_normal(CP_SHAPE)
    return (torch.from_numpy(V),
            [torch.from_numpy(rng.random((s, CP_R))) for s in CP_SHAPE])


def _tk_problem():
    rng = np.random.default_rng(1)
    core = rng.standard_normal(TK_RANKS)
    Us = [np.linalg.qr(rng.standard_normal((s, r)))[0]
          for s, r in zip(TK_SHAPE, TK_RANKS)]
    V = np.einsum("abc,ia,jb,kc->ijk", core, *Us)
    return torch.from_numpy(V + 0.01 * rng.standard_normal(TK_SHAPE))


def _sp_problem():
    rng = np.random.default_rng(2)
    V = np.zeros(SP_SHAPE)
    nnz = V.size // 4
    V.ravel()[rng.choice(V.size, nnz, replace=False)] = rng.random(nnz)
    return (tsp.from_dense(V, device="cpu"),
            [torch.from_numpy(rng.random((s, 2))) for s in SP_SHAPE])


CP_CFG = dict(tol=0.0, pp_res_tol=0.1, maxiter=24, resprint=1)
TK_CFG = dict(tol=0.0, pp_res_tol=0.1, maxiter=16, resprint=1,
              subspace_iters=0)
SP_CFG = dict(tol=0.0, pp_res_tol=0.2, maxiter=16, resprint=1)


def _cp(fn, **kw):
    def run():
        V, Ws = _cp_problem()
        return fn(V, Ws, tcp.CPConfig(**CP_CFG), **kw)
    return run


def _tk(fn, **kw):
    def run():
        return fn(_tk_problem(), TK_RANKS, ttk.TuckerConfig(**TK_CFG), **kw)
    return run


def _sparse_cp(fn):
    def run():
        st, Ws = _sp_problem()
        return fn(st, Ws, tcp.CPConfig(**SP_CFG))
    return run


def _sparse_tk(fn):
    def run():
        st, _ = _sp_problem()
        return fn(st, (2, 2, 2, 2), ttk.TuckerConfig(**SP_CFG))
    return run


def _run_cpd(pp):
    def run():
        V, Ws = _cp_problem()
        m = cli.run_cpd(V, Ws, pp, tol=0.0, maxiter=8, resprint=1)
        return m.W, m.history
    return run


FAMILIES = {
    "cp_simple": _cp(tcp.als_cp),
    "cp_dt": _cp(tcp.als_cp_dt),
    "cp_pp": _cp(tcp.als_cp_pp),
    "cp_pp_partupdate": _cp(tcp.als_cp_pp, partial_update=True),
    "cp_phase_engine": _cp(tcp.als_cp_pp_device),
    "cp_fused": _cp(tcp.als_cp_pp_fused),
    "tucker_dt": _tk(ttk.als_tucker),
    "tucker_hooi": _tk(ttk.als_tucker, use_tree=False),
    "tucker_pp": _tk(ttk.als_tucker_pp),
    "tucker_phase_engine": _tk(ttk.als_tucker_pp_device),
    "tucker_fused": _tk(ttk.als_tucker_pp_fused),
    "sparse_cp": _sparse_cp(sparse_cp.als_cp_sparse),
    "sparse_cp_pp": _sparse_cp(sparse_cp.als_cp_pp_sparse),
    "sparse_tucker": _sparse_tk(sparse_tucker.als_tucker_sparse),
    "sparse_tucker_pp": _sparse_tk(sparse_tucker.als_tucker_pp_sparse),
    "run_msdt": _run_cpd(1),
    "run_simple": _run_cpd(4),
}


def _outcome(family):
    """(factors, rows without dtime, DEVICE_LOOP_COUNTS) of one run."""
    tcp.reset_device_loop_counts()
    out = FAMILIES[family]()
    Ws, hist = out if isinstance(out, tuple) else (out.factors, out.history)
    rows = [{k: v for k, v in h.items() if k != "dtime"} for h in hist]
    return list(Ws), rows, dict(tcp.DEVICE_LOOP_COUNTS), hist


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_warm_ups_change_nothing_but_dtime(monkeypatch, family):
    """With the warm-ups and with each replaced by a no-op: the same rows
    but [dtime], bit for bit, the same factors and loop counters; and no
    draw from torch's global generator either way."""
    state = torch.random.get_rng_state()
    Ws, rows, counts, _ = _outcome(family)
    assert torch.equal(torch.random.get_rng_state(), state)
    monkeypatch.setattr(tcp, "warm_run", lambda fn, *a, **k: None)
    Ws0, rows0, counts0, _ = _outcome(family)
    assert len(rows) > 3 and rows == rows0
    assert counts == counts0
    for a, b in zip(Ws, Ws0):
        assert torch.equal(a, b)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_slow_warm_up_stays_out_of_dtime(monkeypatch, family):
    """Each warm-up made 0.3 s slower: the first row's dtime stays below
    0.3 s (excluded time, or a clock restarted after it)."""
    real = tcp.warm_run
    calls = []

    def slow(fn, *a, **k):
        calls.append(fn)
        time.sleep(SLEEP_S)
        return real(fn, *a, **k)

    monkeypatch.setattr(tcp, "warm_run", slow)
    _, _, _, hist = _outcome(family)
    assert calls
    assert hist[0]["dtime"] < SLEEP_S


@pytest.mark.parametrize("engine", ["cp", "tucker"])
def test_warm_build_is_the_first_build(monkeypatch, engine):
    """The host PP engines keep their warm cache build and hand it to the
    first PP sweep: the very tensors (JAX cp.py:584-586, tucker.py:546-
    548); the in-loop builds of the phase scope are the later ones."""
    mod, build, sweep = (tcp, "pp_build_caches", "pp_sweep") \
        if engine == "cp" else (ttk, "tucker_build_caches", "tucker_pp_sweep")
    real_warm, real_sweep = tcp.warm_run, getattr(mod, sweep)
    built, used = [], []

    def warm(fn, *a, **k):
        out = real_warm(fn, *a, **k)
        if fn is getattr(mod, build):
            built.append(out)
        return out

    def spy(single, pair, *a, **k):
        used.append((single, pair))
        return real_sweep(single, pair, *a, **k)

    monkeypatch.setattr(tcp, "warm_run", warm)
    monkeypatch.setattr(mod, sweep, spy)
    tracing.reset()
    tracing.enable()
    try:
        res = FAMILIES[f"{engine}_pp"]()
    finally:
        tracing.enable(False)
    assert len(built) == 1 and any(h["pp"] == 1 for h in res.history)
    # used[0] is the warm sweep, used[1] the loop's first
    assert used[1][0] is built[0][0] and used[1][1] is built[0][1]
    scope = "cp.pp_cache_build" if engine == "cp" else \
        "tucker.pp_cache_build"
    n_phases = sum(1 for a, b in zip(res.history, res.history[1:])
                   if (a["pp"], b["pp"]) == (0, 1))
    assert tracing.stats().get(scope, (0,))[0] <= n_phases - 1


def test_warm_run_raises_and_leaves_the_counters():
    """warm_run lets its function's exception raise (no fallback hides a
    fault), records no tracing scope inside it and restores
    DEVICE_LOOP_COUNTS."""
    def boom():
        raise ValueError("warm-up fault")

    with pytest.raises(ValueError, match="warm-up fault"):
        tcp.warm_run(boom)
    tcp.reset_device_loop_counts()
    tracing.reset()
    tracing.enable()
    try:
        def counted():
            tcp.DEVICE_LOOP_COUNTS["pulls"] += 5
            return tracing.timed("warm.scope", lambda: 7)
        assert tcp.warm_run(counted) == 7
        assert tracing.enabled()
    finally:
        tracing.enable(False)
    assert "warm.scope" not in tracing.stats()
    assert tcp.DEVICE_LOOP_COUNTS["pulls"] == 0


def test_clock_reset_starts_from_now():
    clock = SweepClock()
    time.sleep(0.05)
    assert clock.dtime() >= 0.05
    clock.reset()
    assert clock.dtime() < 0.05
