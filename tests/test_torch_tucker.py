"""Dense Tucker in the port against the JAX package, on the same numpy
inputs: the eigenvector helpers of ops/solve.py, the Tucker half of
ops/contract.py, models/tucker.py and the CLI's Tucker branches.

Tolerances. float64: every function to 1e-10 (relative to the largest
entry), the solver histories and factors over many sweeps to 1e-8 (the
sums run in other orders and eigh is another LAPACK path; the differences
compound over the sweeps), as tests/test_torch_cp.py. float32: 1e-4
relative for one function, 2e-3 for a run's diffV. bf16-stored V: the
port and the JAX package round the same operands to bf16, and the
products are exact in float32, so they agree to float32 round-off (1e-5).
Eigenvectors are compared after the sign fix, which every extraction
applies; no test shape has (near-)equal eigenvalues among the ones kept,
except where a test says so and compares projectors.

The ``cuda`` test runs the zero warm start of a DT phase on the card:

    python -m pytest tests/test_torch_tucker.py --noconftest -m cuda
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pairwise_perturbation_tpu import cli as jcli
from pairwise_perturbation_tpu.models import tucker as jtk
from pairwise_perturbation_tpu.ops import contract as jct
from pairwise_perturbation_tpu.ops import solve as jsv
from pairwise_perturbation_tpu.utils import metrics as jmetrics
from pairwise_perturbation_tpu_torch import cli
from pairwise_perturbation_tpu_torch.models import tucker as ttk
from pairwise_perturbation_tpu_torch.ops import contract as tct
from pairwise_perturbation_tpu_torch.ops import solve as tsv
from pairwise_perturbation_tpu_torch.scripts import _bench
from pairwise_perturbation_tpu_torch.utils import metrics as tmetrics
from pairwise_perturbation_tpu_torch.utils import synth, tracing

torch.set_num_threads(1)

F64 = 1e-10
RUN = 1e-8
F32 = 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().float().numpy() \
            if x.dtype == torch.bfloat16 else x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(got, want, tol):
    """max |got - want| <= tol * max(|want|, tiny)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-300) if want.size else 1.0
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= tol * scale, (err, scale)


def _t(x, dtype=None):
    x = np.asarray(x)
    return torch.tensor(x, dtype=dtype) if dtype is not None \
        else torch.from_numpy(x.copy())


def low_rank(rng, shape, ranks, noise=0.0):
    """Core x orthonormal factors (+ noise relative to the tensor's RMS),
    as the JAX package's tests build a low-Tucker-rank tensor."""
    core = rng.standard_normal(ranks)
    Ws = [np.linalg.qr(rng.standard_normal((s, r)))[0]
          for s, r in zip(shape, ranks)]
    V = core
    for m, W in enumerate(Ws):
        V = np.moveaxis(np.tensordot(W, V, axes=([1], [m])), 0, m)
    if noise:
        V = V + noise * np.linalg.norm(V) / np.sqrt(V.size) \
            * rng.standard_normal(shape)
    return V


def orth(rng, s, r):
    return np.linalg.qr(rng.standard_normal((s, r)))[0]


# ---------------------------------------------------------------------------
# ops/solve.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,tol", [(np.float64, F64), (np.float32, F32)])
@pytest.mark.parametrize("k", [1, 4, 9])
def test_truncated_eigh_matches_jax(rng, dtype, tol, k):
    A = rng.standard_normal((9, 30)).astype(dtype)
    G = A @ A.T
    G[0, 1] += dtype(1e-3)  # not symmetric: both symmetrize
    Uj, lj = jsv.truncated_eigh(jnp.asarray(G), k)
    Ut, lt = tsv.truncated_eigh(_t(G), k)
    assert_close(lt, lj, tol)
    # eigenvector signs are arbitrary until fixed
    assert_close(tsv.fix_sign_columns(Ut), jsv.fix_sign_columns(Uj), tol)


def test_fix_sign_columns_matches_jax(rng):
    U = rng.standard_normal((6, 5))
    U[:, 1] = 0.0                      # zero column: left as it is
    U[2, 2], U[4, 2] = -3.0, 3.0       # tie: the first maximum decides
    U[:, 3] = -np.abs(U[:, 3])         # all negative: flipped
    got = tsv.fix_sign_columns(_t(U))
    assert_close(got, jsv.fix_sign_columns(jnp.asarray(U)), 0.0)
    assert got[2, 2] > 0 and torch.all(got[:, 1] == 0)


def test_sign_match_matches_jax(rng):
    U = rng.standard_normal((7, 4))
    ref = rng.standard_normal((7, 4))
    ref[:, 2] = 0.0                    # d == 0 counts as negative
    for r in (ref, np.zeros_like(ref)):
        got = tsv.sign_match(_t(U), _t(r))
        assert_close(got, jsv.sign_match(jnp.asarray(U), jnp.asarray(r)), 0.0)
    # a zero reference negates every column (a DT phase's first sweep)
    assert_close(tsv.sign_match(_t(U), torch.zeros(7, 4)), -U, 0.0)


# ---------------------------------------------------------------------------
# ops/contract.py
# ---------------------------------------------------------------------------


SHAPE4, RANKS4 = (5, 6, 7, 8), (2, 3, 4, 3)


@pytest.mark.parametrize("dtype,tol", [(np.float64, F64), (np.float32, F32)])
@pytest.mark.parametrize("axis", [0, 1, 3])
@pytest.mark.parametrize("transpose", [False, True])
def test_ttmc_contract_mode_matches_jax(rng, dtype, tol, axis, transpose):
    T = rng.standard_normal(SHAPE4).astype(dtype)
    s, r = SHAPE4[axis], RANKS4[axis]
    F = rng.standard_normal((r, s) if transpose else (s, r)).astype(dtype)
    got = tct.ttmc_contract_mode(_t(T), _t(F), axis, transpose)
    want = jct.ttmc_contract_mode(jnp.asarray(T), jnp.asarray(F), axis,
                                  transpose)
    assert_close(got, want, tol)


@pytest.mark.parametrize("dtype,tol", [(np.float64, F64), (np.float32, F32)])
@pytest.mark.parametrize("skip", [-1, 0, 2, 3])
def test_ttmc_matches_jax(rng, dtype, tol, skip):
    V = rng.standard_normal(SHAPE4).astype(dtype)
    Ws = [rng.standard_normal((s, r)).astype(dtype)
          for s, r in zip(SHAPE4, RANKS4)]
    got = tct.ttmc(_t(V), [_t(W) for W in Ws], skip_mode=skip)
    want = jct.ttmc(jnp.asarray(V), [jnp.asarray(W) for W in Ws],
                    skip_mode=skip)
    assert_close(got, want, tol)


def test_ttmc_transpose_reconstructs(rng):
    """transpose=True maps a core back through its factors (the JAX
    package's reconstruction oracle)."""
    core = rng.standard_normal(RANKS4)
    Ws = [orth(rng, s, r) for s, r in zip(SHAPE4, RANKS4)]
    got = tct.ttmc(_t(core), [_t(W) for W in Ws], transpose=True)
    want = jct.ttmc(jnp.asarray(core), [jnp.asarray(W) for W in Ws],
                    transpose=True)
    assert_close(got, want, F64)


@pytest.mark.parametrize("shape,ranks", [(SHAPE4, RANKS4),
                                         ((4, 5, 6), (2, 3, 2)),
                                         ((3, 4, 5, 6, 4), (2, 2, 3, 2, 2))])
def test_build_ttmc_caches_matches_jax(rng, shape, ranks):
    V = rng.standard_normal(shape)
    Ws = [orth(rng, s, r) for s, r in zip(shape, ranks)]
    ts, tp = tct.build_ttmc_caches(_t(V), [_t(W) for W in Ws])
    js, jp = jct.build_ttmc_caches(jnp.asarray(V),
                                   [jnp.asarray(W) for W in Ws])
    assert sorted(tp) == sorted(jp) and sorted(ts) == sorted(js)
    for k in jp:
        assert_close(tp[k], jp[k], F64)
    for k in js:
        assert_close(ts[k], js[k], F64)
    dWs = [1e-2 * rng.standard_normal((s, r)) for s, r in zip(shape, ranks)]
    for i in range(len(shape)):
        got = tct.pp_correct_ttmc(ts[i], tp, [_t(d) for d in dWs], i)
        want = jct.pp_correct_ttmc(js[i], jp, [jnp.asarray(d) for d in dWs],
                                   i)
        assert_close(got, want, F64)


@pytest.mark.parametrize("dtype,tol", [(np.float64, F64), (np.float32, F32)])
@pytest.mark.parametrize("axis", [0, 2, 3])
def test_mode_gram_matches_jax(rng, dtype, tol, axis):
    T = rng.standard_normal(SHAPE4).astype(dtype)
    assert_close(tct.mode_gram(_t(T), axis),
                 jct.mode_gram(jnp.asarray(T), axis), tol)


def test_tucker_residual_norm_and_fold_unfold_match_jax(rng):
    V = rng.standard_normal(SHAPE4)
    Ws = [orth(rng, s, r) for s, r in zip(SHAPE4, RANKS4)]
    core_exact = jct.ttmc(jnp.asarray(V), [jnp.asarray(W) for W in Ws])
    core = np.asarray(core_exact) + 0.1 * rng.standard_normal(RANKS4)
    vn = float(np.sum(V * V))
    got = tct.tucker_residual_norm(torch.tensor(vn, dtype=torch.float64),
                                   _t(np.asarray(core_exact)), _t(core))
    want = jct.tucker_residual_norm(vn, core_exact, jnp.asarray(core))
    assert abs(float(got) - float(want)) <= F64 * float(want)
    assert_close(tct.fold_unfold(_t(V), (30, 56)),
                 jct.fold_unfold(jnp.asarray(V), (30, 56)), 0.0)


def _bf16_inputs(rng):
    V = rng.standard_normal(SHAPE4).astype(np.float32)
    Ws = [rng.standard_normal((s, r)).astype(np.float32)
          for s, r in zip(SHAPE4, RANKS4)]
    tV = torch.tensor(V).to(torch.bfloat16)
    return V, Ws, tV, [_t(W) for W in Ws]


@pytest.mark.parametrize("skip", [-1, 1])
def test_ttmc_bf16_rounds_every_factor(rng, skip):
    """JAX's ttmc is one einsum: with bf16 V it rounds every factor to
    bf16. The port's chain does the same, and so differs from a chain
    that rounds only the first factor by far more than round-off."""
    V, Ws, tV, tWs = _bf16_inputs(rng)
    got = tct.ttmc(tV, tWs, skip_mode=skip)
    assert got.dtype == torch.float32
    want = jct.ttmc(jnp.asarray(V, jnp.bfloat16),
                    [jnp.asarray(W) for W in Ws], skip_mode=skip)
    assert_close(got, want, 1e-5)
    first_only = tV
    modes = [m for m in range(4) if m != skip]
    for m in tct.order_by_priority(modes, tct.contraction_priority(SHAPE4)):
        first_only = tct.ttmc_contract_mode(first_only, tWs[m], m)
    err = float(torch.max(torch.abs(first_only - got)))
    assert err > 100 * 1e-5 * float(torch.max(torch.abs(got)))


def test_ttmc_chains_bf16_round_only_the_first(rng):
    """The cache and tree chains (ttmc_contract_mode step by step) round
    only the factor that meets V, as the JAX package's do."""
    V, Ws, tV, tWs = _bf16_inputs(rng)
    jV = jnp.asarray(V, jnp.bfloat16)
    ts, tp = tct.build_ttmc_caches(tV, tWs)
    js, jp = jct.build_ttmc_caches(jV, [jnp.asarray(W) for W in Ws])
    for k in jp:
        assert_close(tp[k], jp[k], 1e-5)
    for k in js:
        assert_close(ts[k], js[k], 1e-5)
    sweep_t = ttk.TuckerBinaryTreeSweep(tV, tWs)
    sweep_j = jtk.TuckerBinaryTreeSweep(jV, [jnp.asarray(W) for W in Ws])
    for i in range(4):
        assert_close(sweep_t.ttmc(i), sweep_j.ttmc(i), 1e-5)


def test_tucker_header_matches_original():
    assert tmetrics.PlotFile.TUCKER_HEADER == jmetrics.PlotFile.TUCKER_HEADER


# ---------------------------------------------------------------------------
# models/tucker.py: extraction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("iters", [1, 2, 4])
def test_topk_subspace_matches_jax(rng, iters):
    A = rng.standard_normal((40, 60))
    G = A @ A.T
    Q0 = rng.standard_normal((40, 6))
    Wt, lt = ttk._topk_subspace(_t(G), 3, _t(Q0), iters)
    Wj, lj = jtk._topk_subspace(jnp.asarray(G), 3, jnp.asarray(Q0), iters)
    assert_close(lt, lj, F64)
    assert_close(tsv.fix_sign_columns(Wt), jsv.fix_sign_columns(Wj), F64)


def test_topk_subspace_zero_start_is_identity_columns():
    """qr of a zero matrix is the identity's leading columns on the CPU in
    both packages: the zero warm start of a DT phase's first sweep."""
    Q, _ = torch.linalg.qr(torch.zeros(12, 4, dtype=torch.float64))
    Qj, _ = jnp.linalg.qr(jnp.zeros((12, 4)))
    assert_close(Q, Qj, 0.0)
    assert_close(Q, np.eye(12)[:, :4], 0.0)


# (Y shape, rank, mode, subspace_iters, pp, warm, sign_ref): every branch
# of _factor_from_Y.
FACTOR_CASES = {
    "small_side_exact": ((40, 3, 4), 3, 0, 0, False, None, None),
    "small_side_auto_exact": ((300, 4, 4, 4), 5, 0, -1, False, "orth", None),
    "small_side_auto_subspace": ((300, 4, 8, 8), 5, 0, -1, False, "orth",
                                 "orth"),
    "small_side_zero_warm": ((300, 4, 8, 8), 5, 0, -1, False, "zero",
                             "zero"),
    "small_side_pp_auto": ((100, 4, 4, 4), 6, 0, -1, True, "orth", "orth"),
    "small_side_r_equals_m": ((30, 2, 3), 6, 0, 2, False, "orth", None),
    "mode_side_exact": ((9, 5, 6), 3, 0, 0, False, None, "orth"),
    "mode_side_subspace": ((12, 20, 3), 3, 1, 2, False, "orth", None),
    "mode_side_auto": ((4, 256, 16), 4, 1, -1, False, "orth", "orth"),
    "mode_side_zero_warm": ((4, 256, 16), 4, 1, -1, False, "zero", "zero"),
    "mode_side_no_warm": ((12, 20, 3), 3, 1, 2, False, None, None),
    "rank_exceeds_small_side": ((20, 2, 2), 10, 0, 0, False, None, None),
    "rank_exceeds_small_side_auto": ((20, 2, 2), 10, 0, -1, True, "orth",
                                     "orth"),
}


@pytest.mark.parametrize("case", sorted(FACTOR_CASES))
def test_factor_from_y_matches_jax(rng, case):
    shape, r, i, iters, pp, warm, ref = FACTOR_CASES[case]
    Y = rng.standard_normal(shape)
    Y[0] *= 5.0  # a spread spectrum: no near-equal kept eigenvalues
    s = shape[i]

    def basis(kind):
        if kind is None:
            return None
        return np.zeros((s, r)) if kind == "zero" else orth(rng, s, r)

    warm, ref = basis(warm), basis(ref)
    conv_t = (lambda x: None if x is None else _t(x))
    conv_j = (lambda x: None if x is None else jnp.asarray(x))
    got = ttk._factor_from_Y(_t(Y), i, r, conv_t(ref), warm=conv_t(warm),
                             subspace_iters=iters, pp=pp)
    want = jtk._factor_from_Y(jnp.asarray(Y), i, r, conv_j(ref),
                              warm=conv_j(warm), subspace_iters=iters, pp=pp)
    assert got.shape == (s, r)
    assert_close(got.T @ got, np.eye(r), 1e-8)
    m = Y.size // s
    if r <= m:
        assert_close(got, want, F64)
    else:
        # r > m: the columns past m complete a null space of G whose
        # eigenvalues are all equal (zero), so any orthonormal completion
        # is right: the first m columns are compared, the rest checked
        # to lie in the null space
        assert_close(got[:, :m], np.asarray(want)[:, :m], F64)
        A = np.moveaxis(Y, i, 0).reshape(s, m)
        assert np.max(np.abs(A.T @ _np(got)[:, m:])) <= 1e-12 * np.max(
            np.abs(A))


def test_factor_from_y_relative_clamp(rng):
    """A small-side Gram with null directions: 1/sigma is zeroed below
    1e-12 of the largest eigenvalue, so those columns are zero, as in
    the JAX package."""
    A = rng.standard_normal((30, 2)) @ rng.standard_normal((2, 6))
    Y = A.reshape(30, 2, 3)
    got = ttk._factor_from_Y(_t(Y), 0, 4)
    want = jtk._factor_from_Y(jnp.asarray(Y), 0, 4)
    assert_close(got, want, F64)
    assert torch.all(got[:, 2:] == 0)


def test_resolve_subspace_iters_matches_jax():
    for iters in (-1, 0, 3):
        for side in (10, 63, 64, 255, 256, 400):
            for r in (2, 32, 100, 200):
                for pp in (False, True):
                    assert ttk._resolve_subspace_iters(iters, side, r, pp) == \
                        jtk._resolve_subspace_iters(iters, side, r, pp)


# ---------------------------------------------------------------------------
# models/tucker.py: sweeps and HOSVD
# ---------------------------------------------------------------------------


def _pair(V, Ws):
    return (_t(V), [_t(W) for W in Ws]), (jnp.asarray(V),
                                          [jnp.asarray(W) for W in Ws])


def _assert_factors(got, want, tol=F64):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert_close(a, b, tol)


@pytest.mark.parametrize("shape,ranks", [(SHAPE4, RANKS4),
                                         ((6, 7, 8), (2, 3, 3)),
                                         ((4, 5, 6, 5, 4), (2, 2, 3, 2, 2))])
def test_hosvd_exact_matches_jax(rng, shape, ranks):
    V = low_rank(rng, shape, ranks, noise=0.1)
    ct, Wt = ttk.hosvd(_t(V), ranks)
    cj, Wj = jtk.hosvd(jnp.asarray(V), ranks)
    _assert_factors(Wt, Wj)
    assert_close(ct, cj, F64)


def test_hosvd_randomized_matches_jax_composed_by_hand(rng, monkeypatch):
    """A mode above HOSVD_EXACT_EIGH_MAX (lowered here, in the port only)
    takes _topk_subspace (4 iterations) from an (s, 2r) normal draw: here
    JAX's own draw, PRNGKey(17 + i), and the JAX side composed by hand
    from its parts."""
    shape, ranks, exact_max = (40, 6, 30), (3, 2, 4), 16
    V = low_rank(rng, shape, ranks, noise=0.2)
    jV = jnp.asarray(V)
    draws, Wj = [], []
    for i, (s, r) in enumerate(zip(shape, ranks)):
        G = jct.mode_gram(jV, i)
        q = min(2 * r, s)
        if s > exact_max and q < s:
            Q0 = jax.random.normal(jax.random.PRNGKey(17 + i), (s, q),
                                   dtype=G.dtype)
            U, _ = jtk._topk_subspace(G, r, Q0, iters=4)
            U = U[:, :r]
            draws.append(_t(np.asarray(Q0)))
        else:
            U, _ = jsv.truncated_eigh(G, r)
            draws.append(None)
        Wj.append(jsv.fix_sign_columns(U))
    cj = jct.ttmc(jV, Wj, skip_mode=-1)
    assert [d is not None for d in draws] == [True, False, True]
    monkeypatch.setattr(ttk, "HOSVD_EXACT_EIGH_MAX", exact_max)
    ct, Wt = ttk.hosvd(_t(V), ranks, Q0s=draws)
    _assert_factors(Wt, Wj)
    assert_close(ct, cj, F64)


def test_hosvd_randomized_branch_at_the_default_threshold(rng):
    """A mode of 4200 > HOSVD_EXACT_EIGH_MAX through JAX's own hosvd and
    the port's, JAX's draw passed in; the port's own seeded draw gives
    the same subspace (an exactly low-rank mode: the projectors agree)."""
    assert ttk.HOSVD_EXACT_EIGH_MAX == jtk.HOSVD_EXACT_EIGH_MAX == 4096
    shape, ranks = (4200, 3, 4), (3, 2, 2)
    V = low_rank(rng, shape, (3, 3, 4))
    cj, Wj = jtk.hosvd(jnp.asarray(V), ranks)
    Q0 = jax.random.normal(jax.random.PRNGKey(17), (4200, 6),
                           dtype=jnp.float64)
    ct, Wt = ttk.hosvd(_t(V), ranks, Q0s=[_t(np.asarray(Q0)), None, None])
    _assert_factors(Wt, Wj)
    assert_close(ct, cj, F64)
    _, Wown = ttk.hosvd(_t(V), ranks)
    P = Wown[0] @ Wown[0].T
    assert_close(P, np.asarray(Wj[0] @ Wj[0].T), 1e-8)
    d = ttk.hosvd_draw((4200, 6), torch.float64, 0)
    assert torch.equal(d, ttk.hosvd_draw((4200, 6), torch.float64, 0))


@pytest.mark.parametrize("use_sign", [False, True])
@pytest.mark.parametrize("iters", [0, 2, -1])
def test_tucker_dt_sweep_matches_jax(rng, use_sign, iters):
    shape, ranks = (4, 6, 8, 300), (2, 3, 4, 5)
    V = low_rank(rng, shape, ranks, noise=0.3)
    _, W0 = jtk.hosvd(jnp.asarray(V), ranks)
    refs = [np.asarray(W) for W in W0]
    (tV, tW), (jV, jW) = _pair(V, refs)
    Wt, ct = ttk.tucker_dt_sweep(tV, tW, tW, ranks=ranks, use_sign=use_sign,
                                 subspace_iters=iters)
    Wj, cj = jtk.tucker_dt_sweep(jV, jW, jW, ranks=ranks, use_sign=use_sign,
                                 subspace_iters=iters)
    _assert_factors(Wt, Wj)
    assert_close(ct, cj, F64)


def test_tucker_dt_sweep_zero_reference_matches_jax(rng):
    """A DT phase's first sweep: W_prev = 0 as sign reference (every
    column negated) and as the AUTO warm basis (mode 3's side 256 >= 256:
    qr(G @ 0))."""
    shape, ranks = (4, 8, 8, 300), (4, 8, 8, 5)
    V = low_rank(rng, shape, ranks, noise=0.3)
    _, W0 = jtk.hosvd(jnp.asarray(V), ranks)
    (tV, tW), (jV, jW) = _pair(V, [np.asarray(W) for W in W0])
    zt = [torch.zeros_like(W) for W in tW]
    zj = [jnp.zeros_like(W) for W in jW]
    Wt, ct = ttk.tucker_dt_sweep(tV, tW, zt, ranks=ranks, use_sign=True,
                                 subspace_iters=-1)
    Wj, cj = jtk.tucker_dt_sweep(jV, jW, zj, ranks=ranks, use_sign=True,
                                 subspace_iters=-1)
    _assert_factors(Wt, Wj)
    assert_close(ct, cj, F64)


def test_tucker_hooi_sweep_matches_jax_and_dt(rng):
    shape, ranks = (6, 7, 8, 9), (2, 3, 2, 3)
    V = rng.standard_normal(shape)
    _, W0 = jtk.hosvd(jnp.asarray(V), ranks)
    (tV, tW), (jV, jW) = _pair(V, [np.asarray(W) for W in W0])
    Wt, ct = ttk.tucker_hooi_sweep(tV, tW, ranks=ranks)
    Wj, cj = jtk.tucker_hooi_sweep(jV, jW, ranks=ranks)
    _assert_factors(Wt, Wj)
    assert_close(ct, cj, F64)
    Wd, _ = ttk.tucker_dt_sweep(tV, tW, tW, ranks=ranks, use_sign=False,
                                subspace_iters=0)
    _assert_factors(Wd, Wt, 1e-8)


def _pp_inputs(rng, shape=(8, 9, 10, 11), ranks=(3, 3, 3, 3), dtype=None):
    V = rng.standard_normal(shape)
    if dtype is not None:
        V = V.astype(dtype)
    _, W0 = jtk.hosvd(jnp.asarray(V), ranks)
    W0 = [np.asarray(W) for W in W0]
    dW = [1e-3 * rng.standard_normal(W.shape).astype(W.dtype) for W in W0]
    return V, W0, dW, ranks


@pytest.mark.parametrize("quiet_tol,age", [(0.0, 0), (0.0, 3), (1e-3, 0),
                                           (1e-3, 1), (3e-4, 2)])
@pytest.mark.parametrize("iters", [0, -1])
def test_tucker_pp_sweep_matches_jax(rng, quiet_tol, age, iters):
    """quiet_tol 0 (no mode quiet, no device read); above 0 with age 0
    (the first sweep after a build: all extract); 1e-3 with age 1 and
    zero dWs (every mode quiet: stationary, factors kept); 3e-4 with dWs
    of relative size ~1e-3 in one mode (the others quiet)."""
    V, W0, dW, ranks = _pp_inputs(rng)
    (tV, tW), (jV, jW) = _pair(V, W0)
    ts, tp = ttk.tucker_build_caches(tV, tW)
    js, jp = jtk.tucker_build_caches(jV, jW)
    if quiet_tol == 3e-4:
        d = [np.zeros_like(W) for W in W0]
        d[2] = dW[2]
    elif quiet_tol == 1e-3 and age == 1:
        d = [np.zeros_like(W) for W in W0]
    else:
        d = dW
    Wcur = [W + x for W, x in zip(W0, d)]
    Wt, dWt, ct, st = ttk.tucker_pp_sweep(
        ts, tp, [_t(W) for W in Wcur], tW, [_t(x) for x in d], quiet_tol,
        age, ranks=ranks, subspace_iters=iters)
    Wj, dWj, cj, sj = jtk.tucker_pp_sweep(
        js, jp, [jnp.asarray(W) for W in Wcur], jW,
        [jnp.asarray(x) for x in d], quiet_tol, age, ranks=ranks,
        subspace_iters=iters)
    assert isinstance(st, bool) and st == bool(sj)
    _assert_factors(Wt, Wj)
    _assert_factors(dWt, dWj)
    assert_close(ct, cj, F64)
    if quiet_tol == 1e-3 and age == 1:
        assert st
        for a, b in zip(Wt, Wcur):
            assert_close(a, b, 0.0)
    if quiet_tol == 3e-4:
        # mode 2 moved: the other modes extract, mode 2 is quiet
        assert not st
        assert_close(Wt[2], Wcur[2], 0.0)


def test_tucker_pp_sweep_reads_the_device_only_when_a_mode_can_be_quiet(
        rng, monkeypatch):
    V, W0, dW, ranks = _pp_inputs(rng)
    tV, tW = _t(V), [_t(W) for W in W0]
    ts, tp = ttk.tucker_build_caches(tV, tW)
    pulls = []
    real = torch.Tensor.cpu

    def counted(self, *a, **k):
        pulls.append(self.shape)
        return real(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counted)
    for quiet_tol, age, n in ((0.0, 5, 0), (1e-3, 0, 0), (1e-3, 1, 1)):
        pulls.clear()
        ttk.tucker_pp_sweep(ts, tp, tW, tW, [_t(x) for x in dW], quiet_tol,
                            age, ranks=ranks)
        assert len(pulls) == n, (quiet_tol, age, pulls)


def test_tucker_diagnostics_matches_jax(rng):
    V, W0, _, _ = _pp_inputs(rng)
    (tV, tW), (jV, jW) = _pair(V, W0)
    vn = float(np.sum(V * V))
    got = ttk.tucker_diagnostics(torch.tensor(vn, dtype=torch.float64), tV,
                                 tW, 3.0)
    want = jtk.tucker_diagnostics(vn, jV, jW, 3.0)
    for a, b in zip(got, want):
        assert_close(a, b, F64)


@pytest.mark.parametrize("fn", ["dt", "pp"])
def test_sweeps_f32_match_jax(rng, fn):
    V, W0, dW, ranks = _pp_inputs(rng, dtype=np.float32)
    (tV, tW), (jV, jW) = _pair(V, W0)
    if fn == "dt":
        Wt, ct = ttk.tucker_dt_sweep(tV, tW, tW, ranks=ranks, use_sign=True)
        Wj, cj = jtk.tucker_dt_sweep(jV, jW, jW, ranks=ranks, use_sign=True)
    else:
        ts, tp = ttk.tucker_build_caches(tV, tW)
        js, jp = jtk.tucker_build_caches(jV, jW)
        Wt, _, ct, _ = ttk.tucker_pp_sweep(ts, tp, tW, tW,
                                           [_t(x) for x in dW], ranks=ranks)
        Wj, _, cj, _ = jtk.tucker_pp_sweep(js, jp, jW, jW,
                                           [jnp.asarray(x) for x in dW],
                                           ranks=ranks)
    assert Wt[0].dtype == torch.float32
    _assert_factors(Wt, Wj, 1e-3)
    assert_close(ct, cj, 1e-3)


# ---------------------------------------------------------------------------
# models/tucker.py: drivers
# ---------------------------------------------------------------------------


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-300)


def assert_same_run(rt, rj, vnorm, tol=RUN):
    """Same (iter, pp) decisions; diffV to ``tol`` relative, diffnorm (a
    difference of core norms) to ``tol`` of ||V||; same end state."""
    assert [(h["iter"], h["pp"]) for h in rt.history] == \
        [(h["iter"], h["pp"]) for h in rj.history]
    for a, b in zip(rt.history, rj.history):
        assert _rel(a["diffV"], b["diffV"]) <= tol, (a, b)
        assert abs(a["diffnorm"] - b["diffnorm"]) <= tol * vnorm, (a, b)
    assert (rt.iters, rt.converged) == (rj.iters, rj.converged)
    _assert_factors(rt.factors, rj.factors, tol)
    assert_close(rt.core, rj.core, tol)


def _noisy(rng, shape=(8, 8, 8, 8), ranks=(3, 3, 3, 3), noise=0.02):
    return low_rank(rng, shape, ranks, noise=noise), ranks


@pytest.mark.parametrize("use_tree", [True, False])
@pytest.mark.parametrize("iters", [0, -1])
def test_als_tucker_matches_jax(rng, use_tree, iters):
    V, ranks = _noisy(rng, (6, 7, 8, 300), (2, 3, 4, 5), noise=0.5)
    vn = float(np.linalg.norm(V))
    cfg = dict(tol=1e-12 * vn, maxiter=12, resprint=3, subspace_iters=iters)
    rt = ttk.als_tucker(_t(V), ranks, ttk.TuckerConfig(**cfg),
                        use_tree=use_tree)
    rj = jtk.als_tucker(V, ranks, jtk.TuckerConfig(**cfg), use_tree=use_tree)
    assert_same_run(rt, rj, vn)


# (shape, ranks, tensor, config): random tensors, several DT <-> PP
# phases each. auto_zero_warm: mode 3's small side is 256, so every DT
# phase's first sweep starts its subspace iteration from qr(G @ 0), and
# PP sweeps take the PP thresholds.
PP_RUNS = {
    "order4": ((8, 8, 8, 8), (3, 3, 3, 3), "normal",
               dict(pp_res_tol=0.3, maxiter=40, resprint=2)),
    "order3_exact_eigh": ((10, 12, 14), (3, 4, 4), "uniform",
                          dict(pp_res_tol=0.1, maxiter=30, resprint=1,
                               subspace_iters=0)),
    "auto_zero_warm": ((4, 8, 8, 300), (4, 8, 8, 5), "uniform",
                       dict(pp_res_tol=0.2, maxiter=30, resprint=1)),
    "quiet_skip": ((12, 13, 14, 15), (3, 3, 3, 3), "uniform",
                   dict(pp_res_tol=0.1, maxiter=40, resprint=5,
                        pp_quiet_frac=0.2)),
}


def random_tensor(shape, kind, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 1.0, shape) if kind == "uniform" \
        else rng.standard_normal(shape)


@pytest.mark.parametrize("run", sorted(PP_RUNS))
def test_als_tucker_pp_matches_jax(run):
    shape, ranks, kind, kw = PP_RUNS[run]
    V = random_tensor(shape, kind)
    vn = float(np.linalg.norm(V))
    cfg = dict(tol=1e-12 * vn, **kw)
    rt = ttk.als_tucker_pp(_t(V), ranks, ttk.TuckerConfig(**cfg))
    rj = jtk.als_tucker_pp(V, ranks, jtk.TuckerConfig(**cfg))
    assert_same_run(rt, rj, vn)
    flags = [h["pp"] for h in rt.history]
    assert 1 in flags and flags.count(0) > 1, flags
    # at least two PP phases: DT -> PP -> DT -> PP
    assert sum(1 for a, b in zip(flags, flags[1:]) if (a, b) == (0, 1)) >= 2


@pytest.mark.parametrize("pp_res_tol", [0.3, 0.05])
def test_als_tucker_pp_given_factors_match_jax(rng, pp_res_tol):
    V, ranks = _noisy(rng)
    vn = float(np.linalg.norm(V))
    Ws = [orth(rng, s, r) for s, r in zip(V.shape, ranks)]
    cfg = dict(tol=1e-12 * vn, pp_res_tol=pp_res_tol, maxiter=20, resprint=2)
    rt = ttk.als_tucker_pp(_t(V), ranks, ttk.TuckerConfig(**cfg),
                           Ws=[_t(W) for W in Ws])
    rj = jtk.als_tucker_pp(V, ranks, jtk.TuckerConfig(**cfg),
                           Ws=[jnp.asarray(W) for W in Ws])
    assert_same_run(rt, rj, vn)


def test_tol_init_decays_to_its_floor():
    """tol_init x 0.9 after each PP phase while above the 5e-3 floor."""
    assert (ttk.TOL_INIT_DECAY, ttk.TOL_INIT_FLOOR) == (0.9, 5e-3)
    assert (ttk.TOL_INIT_DECAY, ttk.TOL_INIT_FLOOR) == \
        (jtk.TuckerConfig().tol_init_decay, jtk.TuckerConfig().tol_init_floor)


@pytest.mark.parametrize("v_dtype", ["float32", "bfloat16"])
def test_als_tucker_pp_f32_and_bf16_match_jax(rng, v_dtype):
    V, ranks = _noisy(rng, noise=0.05)
    V = V.astype(np.float32)
    vn = float(np.linalg.norm(V))
    cfg = dict(tol=0.0, pp_res_tol=0.3, maxiter=16, resprint=4)
    tV = torch.tensor(V).to(getattr(torch, v_dtype))
    jV = jnp.asarray(V, getattr(jnp, v_dtype))
    rt = ttk.als_tucker_pp(tV, ranks, ttk.TuckerConfig(**cfg))
    rj = jtk.als_tucker_pp(jV, ranks, jtk.TuckerConfig(**cfg))
    assert rt.factors[0].dtype == torch.float32
    assert [h["pp"] for h in rt.history] == [h["pp"] for h in rj.history]
    assert _rel(rt.diffV, rj.diffV) <= 2e-3
    for a, b in zip(rt.history, rj.history):
        assert abs(a["diffV"] - b["diffV"]) <= 2e-3 * vn


# ---------------------------------------------------------------------------
# cli.py
# ---------------------------------------------------------------------------


def _csv(main, path, argv):
    assert main(argv + ["-quiet", "-filename", str(path)]) == 0
    with open(path) as fh:
        return list(csv.reader(fh))


def assert_same_tucker_csv(got, want, vnorm, tol=RUN):
    """Same header and rows; [diffV] to ``tol`` relative, [diffnorm] to
    ``tol`` of ||V||, every other column but [dtime] equal."""
    assert got[0] == want[0] == tmetrics.PlotFile.TUCKER_HEADER.split(",")
    assert len(got) == len(want) > 2
    for g, w in zip(got[1:], want[1:]):
        for name, a, b in zip(want[0], g, w):
            a, b = float(a), float(b)
            if name == "[diffV]":
                assert _rel(a, b) <= tol, (g, w)
            elif name == "[diffnorm]":
                assert abs(a - b) <= tol * vnorm, (g, w)
            elif name != "[dtime]":
                assert a == b, (name, g, w)


TUCKER_ARGV = ["test_als", "-model", "Tucker", "-tensor", "r2", "-dim", "4",
               "-size", "10", "-rank", "3", "-maxiter", "30", "-resprint",
               "2", "-pp_res_tol", "0.1", "-dtype", "float64"]


@pytest.mark.parametrize("pp,extra", [("0", []), ("1", []), ("2", []),
                                      ("1", ["-tucker_subspace", "0"]),
                                      ("1", ["-tucker_pp_skip", "0.2"])])
def test_cli_tucker_csv_matches_jax(tmp_path, pp, extra):
    argv = TUCKER_ARGV + ["-pp", pp] + extra
    got = _csv(cli.main, tmp_path / "port.csv", argv + ["-device", "cpu"])
    want = _csv(jcli.main, tmp_path / "jax.csv", argv)
    V = synth.make_tensor("r2", 4, 10, 3, dtype=np.float64)
    assert_same_tucker_csv(got, want, float(np.linalg.norm(V)))
    flags = {float(r[4]) for r in got[1:]}
    assert flags == ({0.0} if pp == "0" else {0.0, 1.0})


def test_cli_tucker_f32_profile_scopes_and_no_launches(tmp_path, capsys):
    before = _bench.launch_counts()
    tracing.reset()
    try:
        rows = _csv(cli.main, tmp_path / "f32.csv",
                    ["test_als", "-model", "Tucker", "-tensor", "r2", "-pp",
                     "1", "-dim", "3", "-size", "14", "-rank", "3",
                     "-maxiter", "20", "-resprint", "1", "-pp_res_tol",
                     "0.1", "-profile", "1", "-device", "cpu"])
    finally:
        tracing.enable(False)
    body = [[float(x) for x in r] for r in rows[1:]]
    assert all(np.isfinite(r).all() for r in body)
    assert body[-1][5] <= body[0][5]
    stats = tracing.stats()
    out = capsys.readouterr().out
    for name in ("tucker.hosvd", "tucker.dt_sweep", "tucker.pp_cache_build",
                 "tucker.pp_sweep", "tucker.diagnostics"):
        assert stats[name][0] > 0 and name in out, name
    assert _bench.launch_counts() == before


def test_pp_bench_tucker_rows_match_jax(tmp_path):
    argv = ["pp_bench", "-model", "Tucker", "-tensor", "r2", "-dim", "3",
            "-size", "12", "-rank", "3", "-maxiter", "3"]
    got = _csv(cli.main, tmp_path / "port.csv", argv + ["-device", "cpu"])
    want = _csv(jcli.main, tmp_path / "jax.csv", argv)
    assert got[0] == want[0] == ["[timetype]", "[dtime]"]
    assert [r[0] for r in got[1:]] == [r[0] for r in want[1:]] == \
        ["[DTtime]"] * 3 + ["[PPfirst]", "[PPsecond]"] * 3
    assert all(float(r[1]) > 0 for r in got[1:])


def test_pp_bench_tucker_factors_match_jax(rng):
    """The factors each pp_bench row kind ends with, against the JAX
    package's cmd_pp_bench body (cli.py:520-551) run by hand."""
    V, ranks = _noisy(rng, noise=0.3)
    last = cli.pp_bench_tucker(_t(V), ranks, 2)
    jV = jnp.asarray(V)
    _, W0 = jtk.hosvd(jV, ranks)
    Wdt, _ = jtk.tucker_dt_sweep(jV, list(W0), W0, ranks=ranks,
                                 use_sign=True)
    single, pair = jtk.tucker_build_caches(jV, list(W0))
    zeros = [jnp.zeros_like(w) for w in W0]
    W1, dW1, _, _ = jtk.tucker_pp_sweep(single, pair, list(W0), list(W0),
                                        zeros, ranks=ranks)
    W2, _, _, _ = jtk.tucker_pp_sweep(single, pair, W1, list(W0), dW1,
                                      ranks=ranks)
    _assert_factors(last["DTtime"], Wdt)
    _assert_factors(last["PPfirst"], W1)
    _assert_factors(last["PPsecond"], W2)


@pytest.mark.parametrize("argv,step", [
    (["-model", "Tucker", "-pp", "0", "-device_loop", "1", "-mesh", "2"],
     "ignores the flag"),
    (["-model", "Tucker", "-layouts", "1"], "ignores the flag"),
    (["-model", "Tucker", "-resume", "ck.npz"], "reads no checkpoint"),
    (["-model", "Tucker", "-mesh", "4"], "A15"),
    (["-model", "Tucker", "-tensor", "o1", "-tensorfile", "missing.bin"],
     "not a float64 binary"),
    (["pp_bench", "-model", "Tucker", "-device_loop", "1"],
     "ignores the flag"),
])
def test_cli_tucker_refusals_name_their_step(argv, step):
    if argv[0] == "pp_bench":
        argv = argv + ["-device", "cpu"]
    else:
        argv = ["test_als", "-device", "cpu"] + argv
    with pytest.raises(SystemExit, match=step):
        cli.main(argv)


def test_tucker_ranks_match_jax():
    class A:
        rank = 7

    for name, want in (("o1", (3, 10, 10, 70)), ("o2", (10, 100, 100, 5)),
                       ("r", (7, 7, 7))):
        A.tensor = name
        assert cli._tucker_ranks(A, 3) == want
        assert jcli._tucker_ranks(A, np.zeros((1, 1, 1))) == want


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("shape,ranks", [((4, 8, 8, 300), (4, 8, 8, 5)),
                                         ((256, 16, 16), (4, 16, 16))])
def test_cuda_zero_warm_start_trajectory_matches_cpu(shape, ranks):
    """AUTO extraction with a DT phase's zero warm start on the card:
    torch.linalg.qr of a zero matrix is the identity's leading columns
    there too, and the float64 trajectory equals the CPU's to 1e-8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pairwise_perturbation_tpu_torch import config
    config.apply_fp32_pins()
    Q, _ = torch.linalg.qr(torch.zeros(300, 5, dtype=torch.float64,
                                       device="cuda"))
    assert torch.equal(Q.cpu(), torch.eye(300, dtype=torch.float64)[:, :5])
    V = random_tensor(shape, "uniform")
    vn = float(np.linalg.norm(V))
    cfg = ttk.TuckerConfig(tol=1e-12 * vn, pp_res_tol=0.2, maxiter=30,
                           resprint=1)
    rc = ttk.als_tucker_pp(_t(V), ranks, cfg)
    rg = ttk.als_tucker_pp(_t(V).cuda(), ranks, cfg)
    rg.factors = [W.cpu() for W in rg.factors]
    rg.core = rg.core.cpu()
    assert_same_run(rg, rc, vn)
