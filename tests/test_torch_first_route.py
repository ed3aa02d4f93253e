"""The card's route for the first contraction of V over a non-minor mode
(ops/contract._kernel_first): on a CUDA V the hand-written mid_contract
kernel takes every such contraction its launch admits, at every site
(``first_contraction``, the first step of every chain on V; the PP cache
roots; the LR refresh), where ``torch.einsum`` would copy V into the
permuted order first.

On the CPU the route is closed, so every path computes what it computed
before, bit for bit. With its device test (``contract._on_card``)
patched to admit the CPU, the kernel module runs its plain version, and
each site's result is held to the einsum chain's in float64 (1e-12
relative, max-norm). The two counters (``contract.first_kernel``,
``contract.first_einsum``) count what they should, and the benchmark's
reader of them (``first_level_kernel_pct``) reads their share. The
``cuda``-marked tests hold the kernel route to the einsum route on a card
at a reduced coil shape, count its launches and check that a DT sweep
makes no copy of V:

    python -m pytest tests/test_torch_first_route.py --noconftest -m cuda
"""

import math
from pathlib import Path

import pytest
import torch

from benchmark import run as brun
from pairwise_perturbation_tpu_torch.models import cp, optimizers
from pairwise_perturbation_tpu_torch.ops import contract as tc
from pairwise_perturbation_tpu_torch.ops.kernels import mid_contract as mc
from pairwise_perturbation_tpu_torch.utils import tracing

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
# Order 4 with coil-100's mode order (priority (3, 1, 2, 0)) and its
# planner split (nodes (0, 2) and (3, 3)).
SHAPE, R, SPLIT = (3, 8, 8, 40), 4, 2
F64 = 1e-12
SITES = ("dt_sweep", "mttkrp", "cp_diagnostics", "build_pp_caches",
         "lr_update_cache")
# (kernel, einsum) counts of one call of each site at SHAPE: the tree's
# node (3, 3) starts its chain (1, 2, 0) with mode 1, node (0, 2)
# contracts the minor mode; of the four MTTKRPs only mode 3's chain
# (1, 2, 0) starts off the minor mode; a diagnostics row's tree (midpoint
# split) starts node (2, 3) over mode 1 and node (0, 1) over the minor
# mode 3; the cache roots are modes 1, 2 and 3; the LR refresh contracts
# hold-out 1.
COUNTS = {"dt_sweep": 1, "mttkrp": 1, "cp_diagnostics": 1,
          "build_pp_caches": 2, "lr_update_cache": 1}


def _inputs(dtype=torch.float64, seed=0):
    gen = torch.Generator().manual_seed(seed)
    V = torch.randn(SHAPE, generator=gen, dtype=dtype)
    Ws = [torch.randn((s, R), generator=gen, dtype=torch.float64).to(
        dtype if dtype != torch.bfloat16 else torch.float32) for s in SHAPE]
    return V, Ws


def _site(name, V, Ws):
    """The site's tensors, flattened to a list."""
    if name == "dt_sweep":
        Ws2, grads = cp.dt_sweep(V, Ws, 0.0, root_split=SPLIT)
        return list(Ws2) + list(grads)
    if name == "mttkrp":
        return [tc.mttkrp(V, Ws, m) for m in range(V.ndim)]
    if name == "cp_diagnostics":
        vn = tc.norm_sq(V)
        return list(cp.cp_diagnostics(vn, V, Ws))
    if name == "build_pp_caches":
        single, pair = tc.build_pp_caches(V, Ws)
        return [single[i] for i in sorted(single)] + \
            [pair[k] for k in sorted(pair)]
    U, s, VT = Ws[1][:, :2], torch.ones(2, dtype=Ws[1].dtype), Ws[0][:2]
    cache = torch.zeros((), dtype=V.dtype)
    return [optimizers.lr_update_cache(V, cache, U, s, VT, left_index=1)]


def _counted(name, V, Ws):
    tracing.reset()
    out = _site(name, V, Ws)
    s = tracing.stats()
    return out, (s.get("contract.first_kernel", (0,))[0],
                 s.get("contract.first_einsum", (0,))[0])


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _open_route(monkeypatch):
    monkeypatch.setattr(tc, "_on_card", lambda V, factor: True)


@pytest.mark.parametrize("site", SITES)
def test_route_matches_einsum_chain(site, monkeypatch):
    """Each site through the kernel module (its plain version) against
    the einsum chain, float64; the counters as reckoned."""
    V, Ws = _inputs()
    want, (k0, e0) = _counted(site, V, Ws)
    assert (k0, e0) == (0, COUNTS[site])
    _open_route(monkeypatch)
    calls = []
    real = mc.mid_contract
    monkeypatch.setattr(mc, "mid_contract",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    got, (k1, e1) = _counted(site, V, Ws)
    assert (k1, e1) == (COUNTS[site], 0) == (len(calls), 0)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert _rel(g, w) <= F64


def test_cache_roots_are_rank_outer_and_contiguous(monkeypatch):
    """The cache roots take the kernel's rank-outer layout, which is the
    (R, remaining...) tensor the chains want, with no copy after it."""
    V, Ws = _inputs()
    _open_route(monkeypatch)
    layouts = []
    real = mc.mid_contract
    monkeypatch.setattr(mc, "mid_contract", lambda V, W, mode, layout:
                        layouts.append((mode, layout)) or
                        real(V, W, mode, layout))
    for mode in (1, 2):
        T, rem = tc._first_contraction_rm(V, Ws[mode], mode)
        assert T.is_contiguous() and T.shape == (R,) + tuple(
            SHAPE[m] for m in rem)
    assert layouts == [(1, "rank_outer"), (2, "rank_outer")]


def test_cpu_paths_unchanged_bit_for_bit():
    """With the route closed (a CPU V), the first step and the chains are
    the einsum steps they were, bit for bit."""
    V, Ws = _inputs(torch.float32)
    for mode in range(4):
        T, rem = tc.first_contraction(V, Ws[mode], mode)
        T0, rem0 = tc.contract_mode_kr(V, (0, 1, 2, 3), False, Ws[mode],
                                       mode)
        assert rem == rem0 and torch.equal(T, T0)
    T = tc.partial_mttkrp(V, Ws, (1, 2, 0))
    T0, rem = tc.contract_mode_kr(V, (0, 1, 2, 3), False, Ws[1], 1)
    for m in (2, 0):
        T0, rem = tc.contract_mode_kr(T0, rem, True, Ws[m], m)
    assert torch.equal(T, T0)
    assert tc.partial_mttkrp(V, Ws, ()) is V


@pytest.mark.parametrize("case", ["cpu", "minor", "strided", "wide_grid"])
def test_route_keeps_the_einsum(case, monkeypatch):
    """An unpatched CPU V, the minor mode, a non-contiguous V and a launch
    the kernel's grid cannot hold keep the einsum; only the first and the
    last two count as einsum calls (the minor mode is a GEMM)."""
    V, Ws = _inputs()
    mode = 1
    if case != "cpu":
        _open_route(monkeypatch)
    if case == "minor":
        mode = 3
    elif case == "strided":
        V = V.transpose(0, 2)
    elif case == "wide_grid":
        monkeypatch.setattr(mc, "plan_for", lambda *a, **k: mc.Plan(
            "fma", 256, 2**31, 4, 0, 64))
    calls = []
    monkeypatch.setattr(mc, "mid_contract",
                        lambda *a, **k: calls.append(a))
    tracing.reset()
    T, rem = tc.first_contraction(V, Ws[mode], mode)
    T0, _ = tc.contract_mode_kr(V, tuple(range(4)), False, Ws[mode], mode)
    assert not calls and torch.equal(T, T0)
    s = tracing.stats()
    assert s.get("contract.first_kernel", (0,))[0] == 0
    assert s.get("contract.first_einsum", (0,))[0] == \
        (0 if case == "minor" else 1)


def test_on_card_refuses_the_cpu_and_other_types():
    V, Ws = _inputs(torch.float32)
    assert not tc._on_card(V, Ws[1])
    assert not tc._on_card(V.double(), Ws[1])
    meta = torch.empty(SHAPE, device="meta")
    assert not tc._on_card(meta, Ws[1])


def test_route_admits_modes_and_grid():
    V = torch.empty(SHAPE)
    assert [mc.route_admits(V, R, m) for m in range(4)] == \
        [True, True, True, False]
    assert mc.route_admits(V, R, 1, "rank_outer")
    assert not mc.route_admits(torch.empty((3, 0, 5)), R, 1)
    assert not mc.route_admits(V, 0, 1)


def test_bf16_route_matches_einsum_chain(monkeypatch):
    """bf16-stored V: the kernel module's plain version and the einsum
    chain round the same operands to bf16 and sum in float32."""
    V, Ws = _inputs(torch.bfloat16)
    want = [tc.mttkrp(V, Ws, m) for m in range(4)]
    _open_route(monkeypatch)
    got = [tc.mttkrp(V, Ws, m) for m in range(4)]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and _rel(g, w) <= 1e-5


def test_engines_count_every_first_contraction_on_the_cpu():
    """A CP-DT fit on the CPU: every non-minor first contraction counted
    as an einsum call, one a DT sweep and one a diagnostics row (the
    sweep's tree, at the same split); none as a kernel call."""
    V, Ws = _inputs(torch.float32)
    tracing.reset()
    tracing.enable()
    try:
        res = cp.als_cp_dt(V, Ws, cp.CPConfig(tol=0.0, maxiter=4,
                                              resprint=2, tree_split=SPLIT))
    finally:
        tracing.enable(False)
    s = tracing.stats()
    sweeps = s["cp.sweep"][0] + 1          # and the warm-up's
    rows = s["cp.diagnostics"][0]
    assert res.iters >= 4 and rows >= 2
    assert s["contract.first_einsum"][0] == sweeps + rows
    assert "contract.first_kernel" not in s


def _reading(stats):
    return brun.Reading(stats={n: (c, 0.0, float("nan"))
                               for n, c in stats.items()})


@pytest.mark.parametrize("stats,want", [
    ({}, None),
    ({"cp.dt_sweep": 30}, None),
    ({"contract.first_kernel": 187}, 100.0),
    ({"contract.first_einsum": 200}, 0.0),
    ({"contract.first_kernel": 3, "contract.first_einsum": 1}, 75.0)])
def test_first_level_kernel_pct_reader(stats, want):
    got = brun.load(REPO, "metrics", "first_level_kernel_pct").read(
        _reading(stats))
    assert got == want if want is None else got == pytest.approx(want)


# ---- on a card

# The cells' shape with mode 3 cut to 720 (V 141.6 MB), rank 10.
CUDA_SHAPE, CUDA_R = (3, 128, 128, 720), 10
# f32 sums of up to 128 products in another order, then the chains'
# further steps: the K4/S2 rows' tolerance.
CUDA_TOL = 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pairwise_perturbation_tpu_torch import config
    config.apply_fp32_pins()
    gen = torch.Generator(device="cuda").manual_seed(25)
    V = torch.rand(CUDA_SHAPE, generator=gen, device="cuda")
    Ws = [torch.rand((s, CUDA_R), generator=gen, device="cuda")
          for s in CUDA_SHAPE]
    return V, Ws


@pytest.mark.cuda
@pytest.mark.parametrize("site,launches", [
    ("dt_sweep", {"rank_minor": 1}),
    ("cp_diagnostics", {"rank_minor": 1}),
    ("build_pp_caches", {"rank_outer": 2})])
def test_cuda_route_against_einsum_route(site, launches, monkeypatch):
    """One DT sweep, one diagnostics row and one cache build through the
    kernel against the einsum route (the device test closed), each
    mid_contract launch counted in its layout as reckoned."""
    V, Ws = _card()
    monkeypatch.setattr(tc, "_on_card", lambda V, factor: False)
    want = _site(site, V, Ws)
    monkeypatch.undo()
    before = dict(mc.LAUNCHES)
    got = _site(site, V, Ws)
    torch.cuda.synchronize()
    assert {k: mc.LAUNCHES[k] - before[k] for k in mc.LAYOUTS} == \
        {k: launches.get(k, 0) for k in mc.LAYOUTS}
    for g, w in zip(got, want):
        assert _rel(g.double(), w.double()) <= CUDA_TOL


@pytest.mark.cuda
def test_cuda_dt_sweep_makes_no_copy_of_v():
    """A DT sweep's peak device memory grows by less than |V|: the kernel
    reads V in place, where the einsum's permuted copy is |V|."""
    V, Ws = _card()
    cp.dt_sweep(V, Ws, 0.0, root_split=SPLIT)      # build and warm
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cp.dt_sweep(V, Ws, 0.0, root_split=SPLIT)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    assert grown < V.numel() * V.element_size(), grown


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["rank_minor", "rank_outer"])
def test_cuda_k4_at_the_cells_mode_2(layout):
    """K4 at the coil cells' mode 2, V viewed as (384, 128, 7200), in both
    layouts the route takes, against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(7)
    V = torch.rand((384, 128, 7200), generator=gen, device="cuda")
    W = torch.rand((128, 10), generator=gen, device="cuda")
    want = mc.mid_contract_plain(V, W, 1, layout)
    got = mc.mid_contract(V, W, 1, layout)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert float((got - want).abs().max() / want.abs().max()) <= CUDA_TOL
    assert math.isfinite(float(got.sum()))
