"""The fused CP machine of the port (models/cp.py: ``pp_fused_init``,
``pp_fused_chunk``, ``als_cp_pp_fused``; ``test_als -pp 1 -device_loop
2``) against the JAX package's, on the CPU, from the same numpy tensor and
factors.

The JAX package runs a chunk of body steps as one ``lax.while_loop`` over
a three-way ``lax.switch``; the port reads the device's phase register
after each DT or PP step and issues the next step itself. The two must
take the same decisions and give the same numbers. float64: the same
logged (iter, pp) rows, exact gradnorm and diffV to TOL relative, factors
to TOL (relative max-norm), the same iteration count; chunk by chunk the
same iteration, stop flag, history and ring. float32: the same rows,
factors to F32_TOL. bf16-stored V (float32 factors): the first rows'
values to BF16_TOL relative, and every row and decision as the port's host
engine's.
"""

import warnings

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pairwise_perturbation_tpu import cli as jcli
from pairwise_perturbation_tpu.models import cp as jcp
from pairwise_perturbation_tpu_torch import cli
from pairwise_perturbation_tpu_torch.models import cp as tcp

from test_torch_device_loop import _problem, _rel, _t
from test_torch_partupdate import _csv, _jax_factors, assert_same_csv

torch.set_num_threads(1)

TOL = 1e-8
# float32 factors after a 40-sweep run through both phase kinds: sums in
# other orders and another eigh (as test_torch_device_loop's F32_TOL).
F32_TOL = 1e-4
# bf16-stored V: the row after one sweep, gradnorm relative, diffV
# relative to ||V|| (the norm identity forms diffV^2 as ||V||^2 less
# near-equal terms, so its float32 error scales with ||V||): 1.2e-7 and
# 3e-6 seen. Within a sweep V's contractions round the factors to bf16,
# so float32 round-off flips roundings and grows ~50x a sweep.
BF16_TOL = 1e-5
CFG = dict(tol=0.0, pp_res_tol=0.1, maxiter=39, resprint=2)
CHUNK = 8


def _hist(res):
    return [(h["iter"], h["pp"], h["gradnorm"], h["diffV"])
            for h in res.history]


def _switches(res):
    flags = [h["pp"] for h in res.history]
    return sum(1 for a, b in zip(flags, flags[1:]) if (a, b) == (0, 1))


def _run_both(V, W0, cfg, chunk=CHUNK):
    rj = jcp.als_cp_pp_fused(jnp.asarray(V), [jnp.asarray(w) for w in W0],
                             jcp.CPConfig(**cfg), chunk=chunk)
    tcp.reset_device_loop_counts()
    rt = tcp.als_cp_pp_fused(_t(V), [_t(w) for w in W0],
                             tcp.CPConfig(**cfg), chunk=chunk)
    return rt, rj


def _assert_same(rt, rj, tol=TOL, values=True):
    got, want = _hist(rt), _hist(rj)
    assert [h[:2] for h in got] == [h[:2] for h in want]
    if values:
        for g, w in zip(got, want):
            for a, b in zip(g[2:], w[2:]):
                assert abs(a - b) <= tol * abs(b), (g, w)
    for a, b in zip(rt.factors, rj.factors):
        assert _rel(a, b) <= tol
    assert rt.iters == rj.iters


def test_pp_fused_chunk_matches_jax():
    """Chunk by chunk in float64: after each chunk the same iteration,
    stop flag, history rows, factors and snapshot ring (count, labels,
    snapshots), through cache builds and both phase kinds."""
    V, W0 = _problem()
    max_hist, slots, maxiter = 26, 8, 24
    jc = jcp.pp_fused_init(jnp.asarray(V), [jnp.asarray(w) for w in W0],
                           max_hist, slots)
    pc = tcp.pp_fused_init(_t(V), [_t(w) for w in W0], max_hist, slots)
    tcp.reset_device_loop_counts()
    for _ in range(6):
        jc = jcp.pp_fused_chunk(
            jnp.asarray(V), jc, jnp.asarray(0.0), jnp.asarray(1.0),
            jnp.asarray(0.1), jnp.asarray(0.0), jnp.asarray(maxiter), None,
            jnp.asarray(10.0), solver="svd", chunk=CHUNK, resprint=3,
            pp_cap=15, max_hist=max_hist, n_slots=slots)
        tcp.pp_fused_chunk(_t(V), pc, 0.0, 1.0, 0.1, 0.0, maxiter, 10.0,
                           solver="svd", chunk=CHUNK, resprint=3, pp_cap=15,
                           n_slots=slots)
        it = int(jc[0])
        assert pc["it"] == it and pc["stop"] == bool(jc[10])
        assert pc["phase"] == int(jc[1]) and pc["age"] == int(jc[2])
        assert _rel(pc["hist"][:it + 1], np.asarray(jc[11])[:it + 1]) <= TOL
        for a, b in zip(pc["Ws"] + pc["dWs"], list(jc[3]) + list(jc[5])):
            assert _rel(a, b) <= TOL
        n = int(jc[14])
        assert pc["count"].item() == n
        assert pc["labels"].tolist() == np.asarray(jc[13]).tolist()
        for a, b in zip(pc["snaps"], jc[12]):
            assert _rel(a[:min(n, slots)], np.asarray(b)[:min(n, slots)]) \
                <= TOL
        if pc["stop"]:
            break
    assert pc["stop"] and pc["it"] == maxiter + 1
    assert set(pc["hist"][1:, 2].tolist()) == {0.0, 1.0}
    assert tcp.DEVICE_LOOP_COUNTS["fused_build"] >= 2


def test_als_cp_pp_fused_matches_jax():
    """The whole engine in float64 at chunk 8: the same logged rows
    (exact gradnorm and diffV), factors and iterations, through several
    DT -> PP switches; pulls: one register a DT or PP step, and history,
    count and labels a chunk."""
    V, W0 = _problem()
    rt, rj = _run_both(V, W0, CFG)
    _assert_same(rt, rj)
    assert _switches(rj) >= 2
    assert abs(rt.gradnorm - rj.gradnorm) <= TOL * abs(rj.gradnorm)
    c = tcp.DEVICE_LOOP_COUNTS
    assert c["fused_dt"] + c["fused_pp"] == CFG["maxiter"] + 1
    assert c["fused_build"] >= 2
    assert c["fused_pulls"] == c["fused_dt"] + c["fused_pp"] \
        + 3 * c["fused_chunks"]
    assert c["pulls"] == c["dt_issued"] == c["pp_issued"] == 0


def test_als_cp_pp_fused_f32_matches_jax():
    """float32 V and factors: the same rows, factors within F32_TOL."""
    V, W0 = _problem()
    rt, rj = _run_both(V.astype(np.float32),
                       [w.astype(np.float32) for w in W0], CFG)
    assert all(w.dtype == torch.float32 for w in rt.factors)
    _assert_same(rt, rj, F32_TOL, values=False)


def _host_shifted(fused, host):
    """The fused engine's row L against the host engine's (resprint 1):
    the same iterate, so the same exact gradnorm and diffV; the fused row
    flags the sweep that made it, the host row the phase about to run, so
    the fused flag at L is the host's at L - 1."""
    by_iter = {h["iter"]: h for h in host.history}
    rows = [h for h in fused.history[1:] if h["iter"] in by_iter]
    assert len(rows) >= len(host.history) - 1
    for h in rows:
        g = by_iter[h["iter"]]
        assert (h["gradnorm"], h["diffV"]) == (g["gradnorm"], g["diffV"])
        assert h["pp"] == by_iter[h["iter"] - 1]["pp"], (h, g)


def test_als_cp_pp_fused_bf16_v_matches_jax():
    """bf16-stored V, float32 factors (JAX tests/test_fused.py:100):
    every logged diffV positive, every gradnorm finite; the same
    decisions and exact rows as the port's host engine; the first rows
    within BF16_TOL of the JAX package's. Later rows part from the JAX
    package's, as the host engines' do (ROADMAP C, not a port fault): V's
    contractions round the factors to bf16, and float32 round-off that
    flips one rounding moves an element by 2^-8."""
    V, W0 = _problem(2)
    Vb = torch.from_numpy(V.astype(np.float32)).to(torch.bfloat16)
    W32 = [w.astype(np.float32) for w in W0]
    cfg = dict(CFG, maxiter=29, resprint=1)
    rj = jcp.als_cp_pp_fused(jnp.asarray(V, dtype=jnp.bfloat16),
                             [jnp.asarray(w) for w in W32],
                             jcp.CPConfig(**cfg), chunk=CHUNK)
    rt = tcp.als_cp_pp_fused(Vb, [_t(w) for w in W32], tcp.CPConfig(**cfg),
                             chunk=CHUNK)
    host = tcp.als_cp_pp(Vb, [_t(w) for w in W32], tcp.CPConfig(**cfg))
    got, want = _hist(rt), _hist(rj)
    assert {h[1] for h in got} == {0, 1}
    for g in got:
        assert g[3] > 0.0 and np.isfinite(g[2])
    _host_shifted(rt, host)
    Vn = float(np.linalg.norm(V))
    for g, w in zip(got[:2], want[:2]):
        assert g[:2] == w[:2]
        assert abs(g[2] - w[2]) <= BF16_TOL * w[2], (g, w)
        assert abs(g[3] - w[3]) <= BF16_TOL * Vn, (g, w)


def test_als_cp_pp_fused_guard_reverts_as_jax():
    """gn_guard 1 at tol_init 0.5: a PP sweep whose gradnorm estimate
    rises is reverted, its history row repeating the previous row's
    estimates, and the machine restarts DT; the same rows and factors as
    the JAX package's."""
    V, W0 = _problem()
    cfg = dict(CFG, pp_res_tol=0.5, gn_guard=1.0, resprint=1, maxiter=25)
    rt, rj = _run_both(V, W0, cfg)
    _assert_same(rt, rj)
    # replay the port's machine to see the reverted rows' estimates
    pc = tcp.pp_fused_init(_t(V), [_t(w) for w in W0], 27, 0)
    tcp.pp_fused_chunk(_t(V), pc, 0.0, 1.0, 0.5, 0.0, 25, 1.0, chunk=64,
                       resprint=1, pp_cap=15)
    h = pc["hist"][:pc["it"] + 1].tolist()
    repeats = [i for i in range(2, len(h))
               if h[i][2] == 1.0 and h[i][:2] == h[i - 1][:2]]
    assert repeats, "the guard reverted no sweep"


def test_ring_drained_across_chunks():
    """resprint 1 at chunk 4: every chunk fills the ring (n_slots = 4 //
    1 + 4) and the host drains and resets it; every logged row is exact,
    as the JAX package's; no overflow warning."""
    V, W0 = _problem(1)
    cfg = dict(CFG, resprint=1, maxiter=21)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        rt, rj = _run_both(V, W0, cfg, chunk=4)
    _assert_same(rt, rj)
    assert tcp.DEVICE_LOOP_COUNTS["fused_chunks"] >= 6
    assert [h["iter"] for h in rt.history] == list(range(23))


def test_ring_overflow_keeps_the_count():
    """A ring too small for a chunk's logged rows overwrites its last slot
    and counts on, as the JAX package's (cp.py:1098-1111); the solver
    warns on such a count. Its own sizing (a chunk's logged rows, plus
    four) never overflows."""
    V, W0 = _problem()
    c = tcp.pp_fused_init(_t(V), [_t(w) for w in W0], 12, 2)
    tcp.pp_fused_chunk(_t(V), c, 0.0, 1.0, 0.1, 0.0, 10, 10.0, chunk=6,
                       resprint=1, n_slots=2)
    # six body steps, one of them a cache build: five logged sweeps, the
    # last slot overwritten
    assert c["it"] == c["count"].item() == 5
    assert c["labels"].tolist() == [1, 5]
    assert torch.equal(c["snaps"][0][1], c["Ws"][0])


@pytest.mark.parametrize("chunk", [3, 16, 64])
def test_chunk_size_changes_no_result(chunk):
    """A chunk size of 2 or more changes no row and no factor: the same
    steps run, read out at other times."""
    V, W0 = _problem(1)
    cfg = tcp.CPConfig(**CFG)
    base = tcp.als_cp_pp_fused(_t(V), [_t(w) for w in W0], cfg, chunk=CHUNK)
    other = tcp.als_cp_pp_fused(_t(V), [_t(w) for w in W0], cfg, chunk=chunk)
    assert _hist(other) == _hist(base)
    assert all(torch.equal(a, b) for a, b in zip(other.factors,
                                                 base.factors))


def test_chunk_of_one_ends_at_the_first_build_as_jax():
    """JAX's quirk, reproduced: with chunks of one step, a chunk holding
    only a cache build makes no progress, and the host loop ends there."""
    V, W0 = _problem()
    rt, rj = _run_both(V, W0, CFG, chunk=1)
    _assert_same(rt, rj)
    assert rt.iters < CFG["maxiter"]
    assert {h["pp"] for h in rt.history} == {0}


def test_fused_same_iterates_as_host_engine():
    """The fused engine takes the host engine's decisions on the same
    iterates (float64, resprint 1), so it fits as well (JAX
    tests/test_fused.py:34-41)."""
    V, W0 = _problem()
    Vn = float(np.linalg.norm(V))
    cfg = tcp.CPConfig(tol=0.0, pp_res_tol=0.1, maxiter=40, resprint=1)
    host = tcp.als_cp_pp(_t(V), [_t(w) for w in W0], cfg)
    fused = tcp.als_cp_pp_fused(_t(V), [_t(w) for w in W0], cfg, chunk=16)
    assert any(h["pp"] == 1 for h in fused.history)
    _host_shifted(fused, host)
    assert all(torch.equal(a, b) for a, b in zip(fused.factors,
                                                 host.factors))
    assert fused.diffV < max(10 * host.diffV, 1e-5 * Vn)


def test_cli_device_loop_2_matches_jax(tmp_path, monkeypatch):
    """test_als -model CP -pp 1 -device_loop 2 through both CLIs in
    float64, the port's handed the JAX package's initial factors: the
    CSVs agree but for [dtime]."""
    monkeypatch.setattr(tcp, "init_factors", _jax_factors)
    argv = ["test_als", "-model", "CP", "-tensor", "r", "-dim", "4",
            "-size", "6", "-rank", "3", "-pp", "1", "-device_loop", "2",
            "-maxiter", "19", "-resprint", "1", "-pp_res_tol", "0.1",
            "-dtype", "float64"]
    got = _csv(cli.main, tmp_path / "port.csv", argv + ["-device", "cpu"])
    want = _csv(jcli.main, tmp_path / "jax.csv", argv)
    assert {r[4] for r in want[1:]} == {"0", "1"}
    assert_same_csv(got, want)
