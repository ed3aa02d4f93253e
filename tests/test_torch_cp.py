"""Whole-slice parity: the port's CP-ALS drivers against the JAX package's,
from identical initial factors (the JAX package's own, handed over as
numpy arrays through utils.interop).

In float64 the two must take the same DT <-> PP decisions — the same
(iter, pp_update) history — with gradnorm, diffV and the final factors
equal to rel 1e-8 (round-off from different contraction orders and eigh
implementations, compounded over 30 sweeps).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pairwise_perturbation_tpu import native as jnative
from pairwise_perturbation_tpu.models import cp as jcp
from pairwise_perturbation_tpu_torch.models import cp as tcp
from pairwise_perturbation_tpu_torch.utils import interop, synth

torch.set_num_threads(1)

TOL = 1e-8


def _order3():
    """Tensor 'r', dim 3, size 16, rank 4: switches DT -> PP -> DT
    several times in 30 sweeps at pp_res_tol 0.1."""
    return synth.make_tensor("r", 3, 16, 4, dtype=np.float64), 4


def _order4():
    rng = np.random.default_rng(3)
    Ws = [rng.random((s, 3)) for s in (4, 10, 12, 14)]
    return np.einsum("az,bz,cz,dz->abcd", *Ws), 3


FIXTURES = {"order3": _order3, "order4": _order4}


def _init(V, R, dtype=jnp.float64):
    return [np.asarray(W) for W in jcp.init_factors(
        V.shape, R, key=jax.random.PRNGKey(0), dtype=dtype)]


def _split(V, R):
    split = jnative.plan_tree_split_traffic(V.shape, R)[0]
    return None if split == (V.ndim - 1) // 2 else split


def _rel(a, b):
    return abs(a - b) / max(abs(a), 1e-300)


def _assert_same_run(rj, rt, tol=TOL):
    hj = [(h["iter"], h["pp"]) for h in rj.history]
    ht = [(h["iter"], h["pp"]) for h in rt.history]
    assert ht == hj
    for a, b in zip(rj.history, rt.history):
        assert _rel(a["gradnorm"], b["gradnorm"]) <= tol, (a, b)
        assert _rel(a["diffV"], b["diffV"]) <= tol, (a, b)
    assert rt.iters == rj.iters and rt.converged == rj.converged
    for Wj, Wt in zip(rj.factors, rt.factors):
        Wj = np.asarray(Wj)
        err = np.max(np.abs(Wt.numpy() - Wj)) / np.max(np.abs(Wj))
        assert err <= tol, err


@pytest.mark.parametrize("gn_guard", [10.0, 1.0])
@pytest.mark.parametrize("fixture", ["order3", "order4"])
def test_als_cp_pp_matches_jax(fixture, gn_guard):
    """gn_guard 1.0 makes the gradnorm guard revert and rewind PP sweeps
    far more often (cp.py:556-575) than the default 10."""
    V, R = FIXTURES[fixture]()
    Ws = _init(V, R)
    kw = dict(tol=0.0, pp_res_tol=0.1, maxiter=30, resprint=1,
              tree_split=_split(V, R), gn_guard=gn_guard)
    rj = jcp.als_cp_pp(V, Ws, jcp.CPConfig(**kw))
    tV, tW = interop.from_numpy(V, Ws, device="cpu")
    rt = tcp.als_cp_pp(tV, tW, tcp.CPConfig(**kw))
    assert any(h["pp"] for h in rt.history) and not all(
        h["pp"] for h in rt.history)
    _assert_same_run(rj, rt)


@pytest.mark.parametrize("fixture", ["order3", "order4"])
def test_als_cp_dt_matches_jax(fixture):
    V, R = FIXTURES[fixture]()
    Ws = _init(V, R)
    kw = dict(tol=0.0, maxiter=20, resprint=3, tree_split=_split(V, R))
    rj = jcp.als_cp_dt(V, Ws, jcp.CPConfig(**kw))
    tV, tW = interop.from_numpy(V, Ws, device="cpu")
    rt = tcp.als_cp_dt(tV, tW, tcp.CPConfig(**kw))
    _assert_same_run(rj, rt)


def test_als_cp_plain_matches_jax():
    V, R = _order3()
    Ws = _init(V, R)
    kw = dict(tol=0.0, maxiter=10, resprint=5, solver="chol")
    rj = jcp.als_cp(V, Ws, jcp.CPConfig(**kw))
    tV, tW = interop.from_numpy(V, Ws, device="cpu")
    rt = tcp.als_cp(tV, tW, tcp.CPConfig(**kw))
    _assert_same_run(rj, rt)


def test_als_cp_dt_f32_matches_jax():
    """float32, 10 DT sweeps: f32 round-off (6e-8) compounded through the
    solves; observed <= 1e-4 relative, held to 1e-3."""
    V, R = _order3()
    V = V.astype(np.float32)
    Ws = _init(V, R, dtype=jnp.float32)
    kw = dict(tol=0.0, maxiter=10, resprint=1, tree_split=_split(V, R))
    rj = jcp.als_cp_dt(V, [jnp.asarray(W) for W in Ws], jcp.CPConfig(**kw))
    tV, tW = interop.from_numpy(V, Ws, device="cpu")
    rt = tcp.als_cp_dt(tV, tW, tcp.CPConfig(**kw))
    assert rt.factors[0].dtype == torch.float32
    _assert_same_run(rj, rt, tol=1e-3)


def test_sweeps_match_jax():
    """One DT sweep, one plain sweep, one PP cache build + PP sweep, and
    the exact diagnostics, each from the same factors."""
    V, R = _order4()
    Ws = _init(V, R)
    jV, jW = jnp.asarray(V), [jnp.asarray(W) for W in Ws]
    tV, tW = interop.from_numpy(V, Ws, device="cpu")

    def close(t, j, tol=1e-10):
        j = np.asarray(j)
        assert np.max(np.abs(t.numpy() - j)) <= tol * np.max(np.abs(j))

    lam = jnp.asarray(0.0)
    for jfn, tfn in ((jcp.dt_sweep, tcp.dt_sweep),
                     (jcp.simple_sweep, tcp.simple_sweep)):
        jo, jg = jfn(jV, jW, lam, solver="svd")
        to, tg = tfn(tV, tW, 0.0, solver="svd")
        for a, b in zip(to + tg, jo + jg):
            close(a, b)
    js_, jp = jcp.pp_build_caches(jV, jW)
    ts_, tp = tcp.pp_build_caches(tV, tW)
    rng = np.random.default_rng(5)
    dWs = [1e-2 * rng.standard_normal(W.shape) for W in Ws]
    jo = jcp.pp_sweep(js_, jp, jW, jW, [jnp.asarray(d) for d in dWs], lam,
                      0.8, solver="svd")
    to = tcp.pp_sweep(ts_, tp, tW, tW, [torch.from_numpy(d) for d in dWs],
                      0.0, 0.8, solver="svd")
    for a, b in zip(to[0] + to[1] + to[2], jo[0] + jo[1] + jo[2]):
        close(a, b)
    close(tcp.ratios_and_gradnorm(tW, to[1], to[2]),
          jcp.ratios_and_gradnorm(jW, jo[1], jo[2]))
    gn_t, dv_t = tcp.cp_diagnostics(tV.square().sum(), tV, tW)
    gn_j, dv_j = jcp.cp_diagnostics(jnp.sum(jV * jV), jV, jW)
    assert _rel(float(gn_j), float(gn_t)) <= 1e-10
    assert _rel(float(dv_j), float(dv_t)) <= 1e-8


def test_init_factors_seeded():
    a = tcp.init_factors((3, 4, 5), 2, seed=7, dtype=torch.float64,
                          device="cpu")
    b = tcp.init_factors((3, 4, 5), 2, seed=7, dtype=torch.float64,
                          device="cpu")
    c = tcp.init_factors((3, 4, 5), 2, seed=8, dtype=torch.float64,
                          device="cpu")
    assert [tuple(W.shape) for W in a] == [(3, 2), (4, 2), (5, 2)]
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert all(((W >= 0) & (W < 1)).all() for W in a)


@pytest.mark.parametrize("ctor", ["init_factors", "from_dense", "from_numpy",
                                  "sparse_from_numpy"])
def test_constructors_default_to_cuda(ctor):
    """Called without ``device=``, the public constructors build on the
    card: where torch has no CUDA they fail asking for it instead of
    quietly building on the CPU."""
    from pairwise_perturbation_tpu_torch.ops import sparse
    V = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    call = {
        "init_factors": lambda: tcp.init_factors((2, 3), 2),
        "from_dense": lambda: sparse.from_dense(V),
        "from_numpy": lambda: interop.from_numpy(V, [V[0]]),
        "sparse_from_numpy": lambda: interop.sparse_from_numpy(
            np.zeros((2, 3), np.int32), np.ones(2, np.float32), (2, 3, 4)),
    }[ctor]
    if torch.cuda.is_available():
        out = call()
        first = out[0] if isinstance(out, (list, tuple)) else out.values
        assert first.device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            call()


def test_interop_round_trip():
    V, R = _order3()
    Ws = _init(V, R)
    tV, tW = interop.from_numpy(V, Ws, device="cpu", dtype=torch.float32)
    assert tV.dtype == torch.float32 and tW[0].dtype == torch.float32
    back = interop.to_numpy([tV] + tW)
    np.testing.assert_allclose(back[0], V.astype(np.float32))
    np.testing.assert_allclose(back[1], Ws[0].astype(np.float32))
