"""The port's ops (contract, solve, dimtree) against the JAX package in
float64 on the same numpy inputs, relative max-norm error 1e-10.

The two sides contract in different pairwise orders (opt_einsum's path
in JAX, the global contraction priority in the port), so results agree
to round-off, not bit for bit.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pairwise_perturbation_tpu import native as jnative
from pairwise_perturbation_tpu.ops import contract as jc, dimtree as jd
from pairwise_perturbation_tpu.ops import solve as js
from pairwise_perturbation_tpu.utils import synth as jsynth
from pairwise_perturbation_tpu_torch import config
from pairwise_perturbation_tpu_torch.ops import contract as tc, dimtree as td
from pairwise_perturbation_tpu_torch.ops import solve as ts

torch.set_num_threads(1)

TOL = 1e-10
SHAPES = {3: (5, 6, 7), 4: (4, 5, 6, 7), 5: (3, 4, 5, 3, 4)}


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.max(np.abs(want)), 1e-300)
    err = np.max(np.abs(got - want)) / scale
    assert err <= tol, err


def _problem(order, R=3, seed=0):
    rng = np.random.default_rng(seed + order)
    shape = SHAPES[order]
    V = rng.random(shape)
    Ws = [rng.random((s, R)) for s in shape]
    return V, Ws


def _j(V, Ws):
    return jnp.asarray(V), [jnp.asarray(W) for W in Ws]


def _t(V, Ws):
    return torch.from_numpy(V.copy()), [torch.from_numpy(W.copy())
                                        for W in Ws]


# ---------------------------------------------------------------------------
# contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", [3, 4, 5])
def test_mttkrp_every_mode(order):
    V, Ws = _problem(order)
    jV, jW = _j(V, Ws)
    tV, tW = _t(V, Ws)
    for mode in range(order):
        _close(tc.mttkrp(tV, tW, mode), jc.mttkrp(jV, jW, mode))


@pytest.mark.parametrize("order", [3, 4, 5])
def test_partial_and_fused_partial_mttkrp(order):
    V, Ws = _problem(order)
    jV, jW = _j(V, Ws)
    tV, tW = _t(V, Ws)
    modes = tuple(range(order - 2, -1, -1))  # all but the last, reversed
    _close(tc.partial_mttkrp(tV, tW, modes),
           jc.partial_mttkrp(jV, jW, modes))
    tT, trem = tc.fused_partial_mttkrp(tV, tW, modes)
    jT, jrem = jc.fused_partial_mttkrp(jV, jW, modes)
    assert trem == jrem
    _close(tT, jT)


@pytest.mark.parametrize("order", [3, 4, 5])
def test_first_contractions(order):
    V, Ws = _problem(order)
    jV, jW = _j(V, Ws)
    tV, tW = _t(V, Ws)
    for mode in range(order):
        tT, trem = tc.first_contraction(tV, tW[mode], mode)
        jT, jrem = jc.first_contraction(jV, None, jW[mode], mode)
        assert trem == jrem
        _close(tT, jT)
        tT, trem = tc._first_contraction_rm(tV, tW[mode], mode)
        jT, jrem = jc._first_contraction_rm(jV, None, jW[mode], mode)
        assert trem == jrem
        _close(tT, jT)
        other = (mode + 1) % order
        t2, trem2 = tc._contract_mode_kr_rm(tT, trem, tW[other], other)
        j2, jrem2 = jc._contract_mode_kr_rm(jT, jrem, jW[other], other)
        assert trem2 == jrem2
        _close(t2, j2)


@pytest.mark.parametrize("shape", [(5, 6, 7), (3, 128, 128, 7200),
                                   (9, 2, 9, 4, 1), (33, 1344, 1024, 9)])
def test_contraction_priority(shape):
    assert tc.contraction_priority(shape) == jc.contraction_priority(shape)
    pr = tc.contraction_priority(shape)
    modes = tuple(range(len(shape)))[::2]
    assert tc.order_by_priority(modes, pr) == jc.order_by_priority(modes, pr)


@pytest.mark.parametrize("order", [3, 4, 5])
def test_build_pp_caches_and_correction(order):
    V, Ws = _problem(order)
    jV, jW = _j(V, Ws)
    tV, tW = _t(V, Ws)
    ts_, tp = tc.build_pp_caches(tV, tW)
    js_, jp = jc.build_pp_caches(jV, jW)
    assert sorted(tp) == sorted(jp) and sorted(ts_) == sorted(js_)
    for k in jp:
        _close(tp[k], jp[k])
    for k in js_:
        _close(ts_[k], js_[k])
    rng = np.random.default_rng(7)
    dWs = [1e-2 * rng.standard_normal(W.shape) for W in Ws]
    for i in range(order):
        _close(tc.pp_correct_mttkrp(ts_[i], tp,
                                    [torch.from_numpy(d) for d in dWs], i),
               jc.pp_correct_mttkrp(js_[i], jp,
                                    [jnp.asarray(d) for d in dWs], i))


@pytest.mark.parametrize("order", [3, 4])
def test_grams_gradient_and_residuals(order):
    V, Ws = _problem(order)
    jV, jW = _j(V, Ws)
    tV, tW = _t(V, Ws)
    _close(tc.gram(tW[0]), jc.gram(jW[0]))
    for skip in (-1, 0, order - 1):
        _close(tc.hadamard_gram(tW, skip), jc.hadamard_gram(jW, skip))
    _close(tc.hadamard_gram(tW, 1, regul=0.3),
           jc.hadamard_gram(jW, 1, regul=jnp.asarray(0.3)))
    for g_t, g_j in zip(tc.cp_gradient(tV, tW, regul=0.1),
                        jc.cp_gradient(jV, jW, regul=jnp.asarray(0.1))):
        _close(g_t, g_j)
    _close(tc.cp_gradnorm(tV, tW), jc.cp_gradnorm(jV, jW))
    M = tc.mttkrp(tV, tW, order - 1)
    _close(tc.cp_residual_norm(tc.norm_sq(tV), M, tW),
           jc.cp_residual_norm(jc.norm_sq(jV), jc.mttkrp(jV, jW, order - 1),
                               jW))
    _close(tc.build_dense(tW), jc.build_dense(jW))
    _close(tc.cp_residual_exact(tV, tW), jc.cp_residual_exact(jV, jW))
    # the norm identity is the exact residual (test oracle)
    _close(tc.cp_residual_norm(tc.norm_sq(tV), M, tW),
           tc.cp_residual_exact(tV, tW), tol=1e-8)
    for a, b in zip(tc.normalize_factors(tW), jc.normalize_factors(jW)):
        _close(a, b)
    _close(tc.gradsubprob(M, tc.hadamard_gram(tW, order - 1), tW[-1]),
           jc.gradsubprob(jc.mttkrp(jV, jW, order - 1),
                          jc.hadamard_gram(jW, order - 1), jW[-1]))


def test_mttkrp_routing():
    """Order-3 f32 with use_kernels goes to the kernel module (its plain
    version on the CPU); float64 and other orders take the einsum chain."""
    from pairwise_perturbation_tpu_torch.ops.kernels import mttkrp3
    V, Ws = _problem(3)
    tV, tW = _t(V.astype(np.float32), [W.astype(np.float32) for W in Ws])
    calls = []
    orig = mttkrp3.mttkrp3_mode

    def spy(*a, **k):
        calls.append(a[2])
        return orig(*a, **k)

    mttkrp3.mttkrp3_mode = spy
    try:
        tc.mttkrp(tV, tW, 1)
        with config.override(use_kernels=False):
            tc.mttkrp(tV, tW, 1)
        tc.mttkrp(tV.double(), [W.double() for W in tW], 2)
    finally:
        mttkrp3.mttkrp3_mode = orig
    assert calls == [1]


def test_mttkrp_hands_the_kernel_contiguous_factors():
    """Factors may arrive as views (a transpose, for example); the routing
    makes them contiguous before the kernel, whose wrapper refuses views."""
    from pairwise_perturbation_tpu_torch.ops.kernels import mttkrp3
    V, Ws = _problem(3)
    tV, tW = _t(V.astype(np.float32), [W.astype(np.float32) for W in Ws])
    tW[0] = tW[0].T.contiguous().T
    assert not tW[0].is_contiguous()
    seen = []
    orig = mttkrp3.mttkrp3_mode

    def spy(V, factors, mode):
        seen.append([W.is_contiguous() for W in factors])
        return orig(V, factors, mode)

    mttkrp3.mttkrp3_mode = spy
    try:
        got = tc.mttkrp(tV, tW, 2)
    finally:
        mttkrp3.mttkrp3_mode = orig
    assert seen == [[True, True, True]]
    _close(got, mttkrp3.mttkrp3_mode_plain(tV, tW, 2), tol=1e-6)


def test_bf16_raises():
    """bf16 V is ported (the mixed-precision rule: every operand rounded to
    bf16, f32 contraction and result); what still raises is a bf16 factor
    handed to a kernel, whose wrappers take f32 factors only."""
    from pairwise_perturbation_tpu_torch.ops.kernels import mid_contract
    V = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4) / 7
    W = torch.ones((2, 3)) / 3
    got = tc._einsum("abc,aZ->bcZ", V.bfloat16(), W)
    assert got.dtype == torch.float32
    want = torch.einsum("abc,aZ->bcZ", V.bfloat16().float(),
                        W.bfloat16().float())
    assert torch.equal(got, want)
    with pytest.raises(TypeError, match="float32"):
        mid_contract.mid_contract(torch.empty((2, 3, 4), device="meta"),
                                  torch.empty((2, 3), device="meta",
                                              dtype=torch.bfloat16), 0)


def _bf16_problem(order, R=3, seed=0):
    V, Ws = _problem(order, R, seed)
    V = V.astype(np.float32)
    Ws = [W.astype(np.float32) for W in Ws]
    return (jnp.asarray(V, jnp.bfloat16), [jnp.asarray(W) for W in Ws],
            torch.tensor(V, dtype=torch.bfloat16),
            [torch.from_numpy(W) for W in Ws])


@pytest.mark.parametrize("order", [3, 4])
def test_bf16_contractions_match_jax(order):
    """bf16-stored V through norm_sq, mttkrp (every factor rounded, as the
    JAX package's single einsum does), fused_partial_mttkrp (only the
    first factor), the PP caches and the tree: f32 results within 1e-6 of
    the JAX package's (the same rounded products summed in another
    order)."""
    jV, jW, tV, tW = _bf16_problem(order)
    # one f32 sum of up to 840 squares, reduced in another order: 1e-5
    _close(tc.norm_sq(tV), jc.norm_sq(jV), tol=1e-5)
    for mode in range(order):
        got = tc.mttkrp(tV, tW, mode)
        assert got.dtype == torch.float32
        _close(got, jc.mttkrp(jV, jW, mode), tol=1e-6)
    modes = tuple(range(order - 2, -1, -1))
    tT, trem = tc.fused_partial_mttkrp(tV, tW, modes)
    jT, jrem = jc.fused_partial_mttkrp(jV, jW, modes)
    assert trem == jrem
    _close(tT, jT, tol=1e-6)
    ts_, tp = tc.build_pp_caches(tV, tW)
    js_, jp = jc.build_pp_caches(jV, jW)
    for k in jp:
        _close(tp[k], jp[k], tol=1e-6)
    for k in js_:
        _close(ts_[k], js_[k], tol=1e-6)
    jt, tt = jd.BinaryTreeSweep(jV, jW), td.BinaryTreeSweep(tV, tW)
    for i in range(order):
        _close(tt.mttkrp(i), jt.mttkrp(i), tol=1e-6)


# ---------------------------------------------------------------------------
# solve
# ---------------------------------------------------------------------------


def _spd(R=5, seed=0):
    rng = np.random.default_rng(seed)
    W = rng.random((3 * R, R))
    return W.T @ W, rng.random((8, R))


@pytest.mark.parametrize("method", ["chol", "auto", "svd"])
def test_solve_methods(method):
    S, M = _spd()
    _close(ts.solve(torch.from_numpy(M), torch.from_numpy(S), method=method),
           js.solve(jnp.asarray(M), jnp.asarray(S), method=method))


def test_psd_pinv_and_solve_mod():
    S, M = _spd(6, seed=1)
    W0 = np.random.default_rng(2).random(M.shape)
    _close(ts._psd_pinv(torch.from_numpy(S)), js._psd_pinv(jnp.asarray(S)))
    _close(ts._psd_pinv(torch.from_numpy(S), rcond=1e-3),
           js._psd_pinv(jnp.asarray(S), rcond=1e-3))
    for a, b in zip(ts.svd_solve_mod(torch.from_numpy(M),
                                     torch.from_numpy(W0),
                                     torch.from_numpy(S), 0.7),
                    js.svd_solve_mod(jnp.asarray(M), jnp.asarray(W0),
                                     jnp.asarray(S), 0.7)):
        _close(a, b)


def test_eps_floor_and_refine_steps():
    for dt_t, dt_j in ((torch.float32, jnp.float32),
                       (torch.float64, jnp.float64)):
        assert ts._eps_floor(dt_t, 10) == js._eps_floor(dt_j, 10)
        assert ts._refine_steps(dt_t, None) == js._refine_steps(dt_j, None)


def test_f32_solves_refine():
    """f32 solves run the refinement passes (f64 skips them): the port and
    JAX agree to f32 round-off amplified by cond(S)."""
    S, M = _spd(5, seed=3)
    S32, M32 = S.astype(np.float32), M.astype(np.float32)
    for method in ("chol", "svd"):
        _close(ts.solve(torch.from_numpy(M32), torch.from_numpy(S32),
                        method=method),
               js.solve(jnp.asarray(M32), jnp.asarray(S32), method=method),
               tol=1e-4)


def _collinear_S(eps):
    """Hadamard-of-Grams S of the collinearity tensor 'c''s factors, with
    one rank column pushed ``eps`` away from its neighbour in every mode."""
    Ws, _ = jsynth.gen_collinearity_factors([8, 8, 8], 5, 0.5, 0.9,
                                            np.random.default_rng(1))
    noise = np.random.default_rng(2).random(8)
    for W in Ws:
        W[:, 4] = W[:, 3] + eps * noise
    return np.asarray(jc.hadamard_gram([jnp.asarray(W) for W in Ws],
                                       skip_mode=0)).copy()


def test_auto_solve_near_singular_collinear():
    """cond(S) ~ 2e5: both pick the Cholesky branch and agree."""
    S = _collinear_S(1e-2)
    assert np.linalg.cond(S) > 1e5
    M = np.random.default_rng(0).random((8, 5))
    j_ok = bool(np.isfinite(np.asarray(jnp.linalg.cholesky(S))).all())
    assert bool(ts._cholesky(torch.from_numpy(S))[1]) == j_ok
    _close(ts.auto_solve(torch.from_numpy(M), torch.from_numpy(S)),
           js.auto_solve(jnp.asarray(M), jnp.asarray(S)))


def test_auto_solve_falls_back_where_cholesky_fails():
    """Indefinite S: torch.linalg.cholesky would raise; the port reads
    cholesky_ex's info, returns NaN from cholesky_solve like JAX, and
    auto_solve takes the pseudo-inverse branch."""
    S = _collinear_S(1e-2)
    lam = np.linalg.eigvalsh(S)
    S -= (lam[0] + 1e-3 * lam[-1]) * np.eye(5)
    assert np.linalg.eigvalsh(S)[0] < 0
    M = np.random.default_rng(0).random((8, 5))
    assert not np.isfinite(np.asarray(jnp.linalg.cholesky(S))).all()
    assert not bool(ts._cholesky(torch.from_numpy(S))[1])
    assert torch.isnan(ts.cholesky_solve(torch.from_numpy(M),
                                         torch.from_numpy(S))).all()
    got = ts.auto_solve(torch.from_numpy(M), torch.from_numpy(S))
    assert torch.isfinite(got).all()
    _close(got, js.auto_solve(jnp.asarray(M), jnp.asarray(S)))
    _close(got, js.svd_solve(jnp.asarray(M), jnp.asarray(S)))


# ---------------------------------------------------------------------------
# dimtree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", [2, 3, 4, 5, 6])
def test_binary_parent_map(order):
    assert td.binary_parent_map(order) == jd.binary_parent_map(order)
    for split in range(order - 1):
        assert (td.binary_parent_map(order, split)
                == jd.binary_parent_map(order, split))
    assert td.binary_children(2, 7) == jd.binary_children(2, 7)


@pytest.mark.parametrize("order", [3, 4, 5])
@pytest.mark.parametrize("split", ["mid", "planner"])
def test_binary_tree_sweep_leaves(order, split):
    V, Ws = _problem(order)
    root = None
    if split == "planner":
        root = jnative.plan_tree_split_traffic(V.shape, 3)[0]
    jV, jW = _j(V, Ws)
    tV, tW = _t(V, Ws)
    jt = jd.BinaryTreeSweep(jV, jW, root_split=root)
    tt = td.BinaryTreeSweep(tV, tW, root_split=root)
    for i in range(order):
        _close(tt.mttkrp(i), jt.mttkrp(i))
        _close(tt.mttkrp(i), jc.mttkrp(jV, jW, i))
    assert sorted(tt._memo) == sorted(jt._memo)
    with pytest.raises(ValueError):
        tt.node(0, order - 1)
