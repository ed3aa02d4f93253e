"""The sparse PP caches through the COO kernel module (K7): the fused pair
view of ops/sparse.py and ``build_pp_caches``'s kernel route, against the
JAX package's sparse build on the same numpy nonzeros and factors.

On the CPU the kernel route runs K7's plain version (float64 sums of the
float32 products, rounded once); the JAX build sums float32 products of
another order (prefix * mid * suffix) in float32. Singles and pairs agree
to a relative max-norm error of 1e-5, which covers both roundings at
these sizes. The kernels-off route keeps its float64 parity of 1e-9. The
``cuda``-marked test runs the kernel itself and skips without a card:

    python -m pytest tests/test_torch_pp_caches.py --noconftest -m cuda
"""

import math

import numpy as np
import pytest
import torch

from pairwise_perturbation_tpu_torch import config
from pairwise_perturbation_tpu_torch.models import cp as tcp
from pairwise_perturbation_tpu_torch.models import sparse_cp as tsparse_cp
from pairwise_perturbation_tpu_torch.ops import sparse as tsp
from pairwise_perturbation_tpu_torch.ops.kernels import coo_mttkrp
from pairwise_perturbation_tpu_torch.utils import interop

torch.set_num_threads(1)

SHAPES = {2: (9, 7), 3: (9, 8, 7), 4: (7, 6, 8, 5)}
PAIRS = [(order, i, j) for order in (3, 4) for i in range(order)
         for j in range(i + 1, order)]


def _problem(order, dtype=np.float32, density=0.2, R=3, seed=0):
    """Numpy COO (C order, as both packages' from_dense give it) of a
    random sparse tensor of SHAPES[order], and factors."""
    shape = SHAPES[order]
    rng = np.random.default_rng(seed + order)
    V = np.zeros(shape)
    nnz = int(density * V.size)
    V.ravel()[rng.choice(V.size, size=nnz, replace=False)] = \
        rng.standard_normal(nnz)
    idx = np.argwhere(V != 0).astype(np.int32)
    vals = V[tuple(idx.T)].astype(dtype)
    Ws = [rng.standard_normal((s, R)).astype(dtype) for s in shape]
    return idx, vals, shape, Ws


def _port(idx, vals, shape):
    return interop.sparse_from_numpy(idx, vals, shape, device="cpu")


def _jax_caches(idx, vals, shape, Ws):
    import jax.numpy as jnp
    from pairwise_perturbation_tpu.ops import sparse as jsp
    jst = jsp.SparseTensor(jnp.asarray(idx), jnp.asarray(vals), shape)
    return jsp.build_pp_caches(jst, [jnp.asarray(W) for W in Ws])


def _rel(got, want):
    want = np.asarray(want, dtype=np.float64)
    assert tuple(got.shape) == want.shape
    return float(np.max(np.abs(got.numpy() - want)) / np.max(np.abs(want)))


def _spy_coo(monkeypatch):
    calls = []
    orig = coo_mttkrp.coo_mttkrp

    def spy(st, Ws, mode):
        calls.append((st.shape, mode))
        return orig(st, Ws, mode)

    monkeypatch.setattr(coo_mttkrp, "coo_mttkrp", spy)
    return calls


@pytest.mark.parametrize("order,i,j", PAIRS)
def test_pair_view_fuses_modes(order, i, j):
    """Order N - 1: mode i's column is i * s_j + j (int32), mode j's is
    gone, the shape holds s_i * s_j at position i; the values are the
    tensor's own. The factor list has None at i and drops mode j. The
    view is cached on the tensor."""
    idx, vals, shape, Ws = _problem(order)
    st = _port(idx, vals, shape)
    view = tsp.pair_view(st, i, j)
    keep = [m for m in range(order) if m != j]
    want_shape = tuple(shape[i] * shape[j] if m == i else shape[m]
                       for m in keep)
    assert view.shape == want_shape and view.ndim == order - 1
    assert view.indices.dtype == torch.int32
    want_idx = idx[:, keep].astype(np.int64)
    want_idx[:, keep.index(i)] = idx[:, i].astype(np.int64) * shape[j] \
        + idx[:, j]
    np.testing.assert_array_equal(view.indices.numpy(), want_idx)
    assert view.values is st.values
    tW = [torch.from_numpy(W) for W in Ws]
    fs = tsp.pair_factors(tW, i, j)
    assert len(fs) == order - 1 and fs[keep.index(i)] is None
    assert all(fs[k] is tW[m] for k, m in enumerate(keep) if m != i)
    assert tsp.pair_view(st, i, j) is view
    assert st.plans[("pair", i, j)] is view


def test_pair_view_order_2_adds_a_unit_mode():
    """K7 takes order 2 and up: the order-2 view keeps an added mode of
    size 1 (index 0) whose factor is a row of ones."""
    idx, vals, shape, Ws = _problem(2)
    view = tsp.pair_view(_port(idx, vals, shape), 0, 1)
    assert view.shape == (shape[0] * shape[1], 1)
    np.testing.assert_array_equal(view.indices[:, 0].numpy(),
                                  idx[:, 0] * shape[1] + idx[:, 1])
    assert not view.indices[:, 1].any()
    fs = tsp.pair_factors([torch.from_numpy(W) for W in Ws], 0, 1)
    assert fs[0] is None and torch.equal(fs[1], torch.ones((1, 3)))


@pytest.mark.parametrize("order", [2, 3, 4])
def test_kernel_route_matches_jax(monkeypatch, order):
    """float32 under use_kernels: N singles through K7 and one K7 call
    per pair on its fused view (mode i), rel 1e-5 against the JAX build
    for every single and pair; the CPU launches nothing."""
    idx, vals, shape, Ws = _problem(order)
    js, jp = _jax_caches(idx, vals, shape, Ws)
    st = _port(idx, vals, shape)
    calls = _spy_coo(monkeypatch)
    before = dict(coo_mttkrp.LAUNCHES)
    with config.override(use_kernels=True):
        ts, tp = tsp.build_pp_caches(st, [torch.from_numpy(W) for W in Ws])
    assert len(calls) == order + math.comb(order, 2)
    assert calls[:order] == [(shape, m) for m in range(order)]
    assert calls[order:] == [(tsp.pair_view(st, i, j).shape, i)
                             for i, j in sorted(jp)]
    assert coo_mttkrp.LAUNCHES == before
    assert sorted(ts) == sorted(js) and sorted(tp) == sorted(jp)
    for k in js:
        assert ts[k].dtype == torch.float32
        assert _rel(ts[k], js[k]) <= 1e-5, k
    for k in jp:
        assert tp[k].is_contiguous()
        assert _rel(tp[k], jp[k]) <= 1e-5, k


@pytest.mark.parametrize("order", [3, 4])
def test_kernels_off_route_matches_jax(monkeypatch, order):
    """Kernels off (or float64) the prefix/suffix route stays: no K7 call,
    float64 parity with the JAX build at 1e-9; float32 with kernels off
    takes it too."""
    idx, vals, shape, Ws = _problem(order, dtype=np.float64)
    js, jp = _jax_caches(idx, vals, shape, Ws)
    st = _port(idx, vals, shape)
    calls = _spy_coo(monkeypatch)
    ts, tp = tsp.build_pp_caches(st, [torch.from_numpy(W) for W in Ws])
    for k in js:
        assert _rel(ts[k], js[k]) <= 1e-9, k
    for k in jp:
        assert _rel(tp[k], jp[k]) <= 1e-9, k
    st32 = _port(idx, vals.astype(np.float32), shape)
    with config.override(use_kernels=False):
        tsp.build_pp_caches(st32, [torch.from_numpy(W.astype(np.float32))
                                   for W in Ws])
    assert calls == [] and not st.plans and not st32.plans


def test_fused_size_at_2_31_raises(monkeypatch):
    """A fused pair of 2^31 rows or more does not fit K7's int32 indices:
    the kernel route raises before it allocates anything, and does not
    fall back."""
    idx, vals, _, Ws = _problem(3)
    shape = (65536, 32768, 7)                  # s_0 * s_1 = 2^31
    st = _port(idx, vals, shape)
    calls = _spy_coo(monkeypatch)
    with pytest.raises(ValueError, match="2\\^31"):
        tsp.pair_view(st, 0, 1)
    monkeypatch.setattr(tsp, "mttkrp", lambda st, Ws, mode: None)
    tW = [torch.ones((s, 3)) for s in shape]
    with config.override(use_kernels=True), \
            pytest.raises(ValueError, match="fused pair \\(0, 1\\)"):
        tsp.build_pp_caches(st, tW)
    assert calls == []
    ok = _port(idx, vals, (65536, 32767, 7))   # 2^31 - 65536 rows
    assert tsp.pair_view(ok, 0, 1).shape == (65536 * 32767, 7)


def test_sparse_pp_engine_f32_takes_kernel_route(monkeypatch):
    """The sparse PP engine in float32 builds its caches through K7 (N +
    N(N-1)/2 calls per build on top of the exact MTTKRPs), and up to the
    end of its first PP phase makes the phase decisions of the kernels-off
    route. (The float32 trajectories of the two routes part in round-off
    from the first sweep on and diverge in later phases; the caches'
    accuracy is held above.)"""
    from pairwise_perturbation_tpu_torch.utils import synth
    V = synth.make_tensor("p", dim=8, s=5, R=3, seed=3, dtype=np.float32)
    st = tsp.from_dense(V, device="cpu")
    W0 = tcp.init_factors(st.shape, 3, seed=0, device="cpu")
    cfg = tcp.CPConfig(tol=0.0, pp_res_tol=0.1, maxiter=30, resprint=1)
    calls = _spy_coo(monkeypatch)
    builds = []
    orig = tsp.build_pp_caches
    monkeypatch.setattr(tsp, "build_pp_caches",
                        lambda *a: builds.append(1) or orig(*a))
    on = tsparse_cp.als_cp_pp_sparse(st, list(W0), cfg)
    pair_calls = [c for c in calls if len(c[0]) == 3]
    assert builds and len(pair_calls) == 6 * len(builds)
    with config.override(use_kernels=False):
        off = tsparse_cp.als_cp_pp_sparse(st, list(W0), cfg)
    first = next(k for k, h in enumerate(on.history[1:], 1)
                 if h["pp"] == 0 and on.history[k - 1]["pp"] == 1)
    assert first > 3 and all(np.isfinite(h["gradnorm"]) for h in on.history)
    assert [(h["iter"], h["pp"]) for h in on.history[:first + 1]] == \
        [(h["iter"], h["pp"]) for h in off.history[:first + 1]]


@pytest.mark.cuda
def test_cuda_cache_builds_repeat_bitwise():
    """On a card: two kernel-route cache builds are bitwise equal, each
    launches K7 N + N(N-1)/2 times, and they agree with the kernels-off
    route (index_add_) to rel 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for order in (2, 3, 4):
        idx, vals, shape, Ws = _problem(order)
        st = interop.sparse_from_numpy(idx, vals, shape, device="cuda")
        tW = [torch.from_numpy(W).cuda() for W in Ws]
        n0 = coo_mttkrp.LAUNCHES["coo_mttkrp"]
        with config.override(use_kernels=True):
            a = tsp.build_pp_caches(st, tW)
            b = tsp.build_pp_caches(st, tW)
        assert coo_mttkrp.LAUNCHES["coo_mttkrp"] == \
            n0 + 2 * (order + math.comb(order, 2))
        with config.override(use_kernels=False):
            off = tsp.build_pp_caches(st, tW)
        torch.cuda.synchronize()
        for got, again, want in zip(a, b, off):
            for k in want:
                assert torch.equal(got[k], again[k]), (order, k)
                err = (got[k] - want[k]).abs().max() / want[k].abs().max()
                assert float(err) <= 1e-4, (order, k)
