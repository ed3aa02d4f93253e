"""PP-partupdate (``test_als -pp 2``) of the port against the JAX package,
on the CPU, from the same numpy tensor and initial factors.

In float64 each partial-update sweep must equal the JAX package's to
round-off (rel 1e-10: the sums run in other orders and eigh is another
implementation), with the same modes solved; over a whole run the two
must take the same DT <-> PP decisions, with histories and final factors
equal to rel 1e-8 (as tests/test_torch_cp.py). float32: rel 1e-3 over
five sweeps, round-off compounded through the solves.
"""

import csv

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pairwise_perturbation_tpu import cli as jcli
from pairwise_perturbation_tpu import native as jnative
from pairwise_perturbation_tpu.models import cp as jcp
from pairwise_perturbation_tpu_torch import cli
from pairwise_perturbation_tpu_torch.models import cp as tcp
from pairwise_perturbation_tpu_torch.utils import interop, synth

torch.set_num_threads(1)


def _order3():
    return synth.make_tensor("r", 3, 10, 3, dtype=np.float64), 3


def _order4():
    rng = np.random.default_rng(3)
    Ws = [rng.random((s, 3)) for s in (4, 7, 6, 5)]
    return np.einsum("az,bz,cz,dz->abcd", *Ws), 3


FIXTURES = {"order3": _order3, "order4": _order4}
# (shape, R) of the one-sweep checks, whose tensor is made from known
# factors with 1% noise.
SWEEP_SHAPES = {"order3": ((9, 10, 11), 3), "order4": ((4, 7, 6, 5), 3)}


def _init(V, R, dtype=jnp.float64):
    return [np.asarray(W) for W in jcp.init_factors(
        V.shape, R, key=jax.random.PRNGKey(0), dtype=dtype)]


def _close(t, j, tol):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    scale = max(np.max(np.abs(j)), 1e-300)
    assert np.max(np.abs(t - j)) <= tol * scale, np.max(np.abs(t - j)) / scale


def _sweeps(fixture, update_percentage, n_sweeps, dtype, tol):
    """``n_sweeps`` partial-update sweeps in each package from one cache
    build at factors moved 5% off the tensor's own, from zero dWs and dMs
    (the state _pp_sub starts a phase with), each package fed its own
    state; every output compared after every sweep. Returns the modes
    solved in each sweep."""
    shape, R = SWEEP_SHAPES[fixture]
    rng = np.random.default_rng(5)
    true = [rng.random((s, R)) for s in shape]
    V = np.einsum(",".join("abcd"[i] + "z" for i in range(len(shape)))
                  + "->" + "abcd"[:len(shape)], *true)
    V = (V * (1 + 0.01 * rng.standard_normal(V.shape))).astype(dtype)
    W0 = [(w * (1 + 0.05 * rng.standard_normal(w.shape))).astype(dtype)
          for w in true]
    order = V.ndim
    update_size = max(int(order * update_percentage), 1)
    jV, jW = jnp.asarray(V), [jnp.asarray(w) for w in W0]
    tV, tW = interop.from_numpy(V, W0, device="cpu")
    js, jp = jcp.pp_build_caches(jV, jW)
    ts, tp = tcp.pp_build_caches(tV, tW)
    jstate = (jW, [jnp.zeros_like(w) for w in jW],
              [jnp.zeros_like(w) for w in jW],
              [jnp.zeros_like(w) for w in jW], jnp.zeros(order, bool),
              jnp.zeros(order, jW[0].dtype),
              [jnp.asarray(rng.random(w.shape).astype(dtype)) for w in W0])
    tstate = ([w.clone() for w in tW], [torch.zeros_like(w) for w in tW],
              [torch.zeros_like(w) for w in tW],
              [torch.zeros_like(w) for w in tW], (False,) * order,
              torch.zeros(order, dtype=tW[0].dtype),
              [torch.from_numpy(np.array(g)) for g in jstate[-1]])
    solved = []
    for _ in range(n_sweeps):
        Ws, dWs, dMs, Ms, ms_set, rel, grads = jstate
        before = np.asarray(ms_set).copy()
        jout = jcp.pp_partupdate_sweep(
            js, jp, Ws, jW, dWs, dMs, Ms, ms_set, rel, grads,
            jnp.asarray(0.0, jW[0].dtype), 1.0, update_size=update_size)
        Ws, dWs, dMs, Ms, ms_set, rel, grads = tstate
        tout = tcp.pp_partupdate_sweep(
            ts, tp, Ws, tW, dWs, dMs, Ms, ms_set, rel, grads, 0.0, 1.0,
            update_size=update_size)
        assert tout[4] == tuple(bool(b) for b in np.asarray(jout[4]))
        for k in (0, 1, 2, 3, 6):
            for t, j in zip(tout[k], jout[k]):
                _close(t, j, tol)
        _close(tout[5], jout[5], tol)
        solved.append([i for i in range(order)
                       if not np.array_equal(np.asarray(jout[1][i]),
                                             np.asarray(jstate[1][i]))])
        assert np.asarray(jout[4]).sum() >= before.sum()
        jstate, tstate = jout, tout
    return solved, update_size


@pytest.mark.parametrize("update_percentage", [0.5, 1.0])
@pytest.mark.parametrize("fixture", ["order3", "order4"])
def test_pp_partupdate_sweep_matches_jax(fixture, update_percentage):
    """Four sweeps, f64. The first sweep ranks all-zero perturbations: a
    stable sort solves modes 0..update_size-1 (C9)."""
    solved, update_size = _sweeps(fixture, update_percentage, 4,
                                  np.float64, 1e-10)
    assert solved[0] == list(range(update_size))
    assert all(len(s) == update_size for s in solved)


def test_pp_partupdate_sweep_f32_matches_jax():
    _sweeps("order4", 0.5, 5, np.float32, 1e-3)


def _assert_same_run(rj, rt, tol=1e-8):
    assert [(h["iter"], h["pp"]) for h in rt.history] == \
        [(h["iter"], h["pp"]) for h in rj.history]
    for a, b in zip(rj.history, rt.history):
        for k in ("gradnorm", "diffV"):
            assert abs(a[k] - b[k]) <= tol * max(abs(a[k]), 1e-300), (a, b)
    assert rt.iters == rj.iters and rt.converged == rj.converged
    for t, j in zip(rt.factors, rj.factors):
        _close(t, j, tol)


@pytest.mark.parametrize("update_percentage", [0.5, 1.0])
@pytest.mark.parametrize("fixture", ["order3", "order4"])
def test_als_cp_pp_partial_update_matches_jax(fixture, update_percentage):
    """25 sweeps at pp_res_tol 0.1: DT, then PP-partupdate phases, in
    both packages alike."""
    V, R = FIXTURES[fixture]()
    Ws = _init(V, R)
    split = jnative.plan_tree_split_traffic(V.shape, R)[0]
    kw = dict(tol=0.0, pp_res_tol=0.1, maxiter=25, resprint=1,
              update_percentage=update_percentage,
              tree_split=None if split == (V.ndim - 1) // 2 else split)
    rj = jcp.als_cp_pp(V, Ws, jcp.CPConfig(**kw), partial_update=True)
    tV, tW = interop.from_numpy(V, Ws, device="cpu")
    rt = tcp.als_cp_pp(tV, tW, tcp.CPConfig(**kw), partial_update=True)
    assert any(h["pp"] for h in rt.history)
    _assert_same_run(rj, rt)


def _jax_factors(shape, R, seed=0, dtype=None, device="cpu"):
    """The JAX package's initial factors of its CLI, for the port's CLI."""
    return [torch.from_numpy(np.array(W)).to(dtype).to(device)
            for W in jcp.init_factors(shape, R, key=jax.random.PRNGKey(seed),
                                      dtype=jnp.float64)]


def _csv(main, path, argv):
    assert main(argv + ["-quiet", "-filename", str(path)]) == 0
    with open(path) as fh:
        return list(csv.reader(fh))


def assert_same_csv(got, want, tol=1e-8):
    """Same header and rows; every column but [dtime] equal, gradnorm and
    diffV to ``tol`` relative."""
    assert got[0] == want[0]
    assert len(got) == len(want) > 2
    head = want[0]
    for g, w in zip(got[1:], want[1:]):
        for name, a, b in zip(head, g, w):
            if name == "[dtime]":
                continue
            a, b = float(a), float(b)
            if name in ("[gradnorm]", "[diffV]"):
                assert abs(a - b) <= tol * max(abs(b), 1e-300), (name, g, w)
            else:
                assert a == b, (name, g, w)


@pytest.mark.parametrize("dim,up", [(3, "0.5"), (4, "0.5"), (4, "1.0")])
def test_cli_pp2_csv_matches_jax(tmp_path, monkeypatch, dim, up):
    """``test_als -pp 2`` through both CLIs in float64, the port's CLI
    handed the JAX package's initial factors: the CSVs agree but for
    [dtime], PP-partupdate rows among them."""
    monkeypatch.setattr(tcp, "init_factors", _jax_factors)
    argv = ["test_als", "-model", "CP", "-tensor", "r", "-pp", "2",
            "-update_percentage_pp", up, "-dim", str(dim), "-size", "8",
            "-rank", "3", "-maxiter", "20", "-resprint", "2",
            "-pp_res_tol", "0.1", "-dtype", "float64"]
    got = _csv(cli.main, tmp_path / "port.csv", argv + ["-device", "cpu"])
    want = _csv(jcli.main, tmp_path / "jax.csv", argv)
    assert_same_csv(got, want)
    assert any(float(r[4]) == 1 for r in got[1:])


def test_cli_pp2_runs_f32_with_profile(tmp_path, capsys):
    """-pp 2 in float32 with its tracing scope; no kernel launches on the
    CPU."""
    from pairwise_perturbation_tpu_torch.ops.kernels import mttkrp3
    from pairwise_perturbation_tpu_torch.utils import tracing
    before = dict(mttkrp3.LAUNCHES)
    tracing.reset()
    try:
        rows = _csv(cli.main, tmp_path / "f32.csv",
                    ["test_als", "-tensor", "r", "-pp", "2", "-dim", "4",
                     "-size", "8", "-rank", "3", "-maxiter", "16",
                     "-resprint", "1", "-pp_res_tol", "0.1",
                     "-update_percentage_pp", "0.5", "-profile", "1",
                     "-device", "cpu"])
    finally:
        tracing.enable(False)
    body = [[float(x) for x in r] for r in rows[1:]]
    assert all(np.isfinite(r).all() for r in body)
    assert body[-1][2] < body[0][2]
    assert tracing.stats()["cp.pp_partupdate_sweep"][0] > 0
    assert "cp.pp_sweep" not in tracing.stats()
    assert mttkrp3.LAUNCHES == before
