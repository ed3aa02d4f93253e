"""The card's route for the later steps of a CP contraction chain
(ops/contract._kernel_step): on CUDA float32 operands the hand-written
chain_step kernel (ops/kernels/chain_step.py) takes every Khatri-Rao step
of a rank-carrying intermediate that its launch admits — each
``contract_mode_kr`` step with ``has_rank`` (rank-minor T) and each
rank-major cache-chain step over a middle mode — where ``torch.einsum``
would first copy T into (rank, kept, contracted) order.

On the CPU the route is closed, so every path computes what it computed
before, bit for bit, and counts ``contract.step_einsum``. The kernel
module's plain version is held to the einsum in float64 (1e-12 relative,
max-norm) and float32 (1e-5: sums of at most 40 products in another
order) at tiny shapes covering both load widths and parts, every
position of the contracted axis and R in {1, 6, 10, 17}. With the device
test (``contract._step_on_card``) patched to admit the CPU, every site
runs the plain version and matches the einsum chain. A world of one on a
(1,) mesh still equals one process, bit for bit. CP-DT and CP-PP fits
count every step their scopes reckon. The ``cuda``-marked tests hold the
kernel to the einsum on a card, step by step, site by site and over a
whole DT sweep on well-conditioned operands:

    python -m pytest tests/test_torch_step_route.py --noconftest -m cuda
"""

import itertools
from pathlib import Path

import pytest
import torch

from benchmark import run as brun
from pairwise_perturbation_tpu_torch.models import cp
from pairwise_perturbation_tpu_torch.ops import contract as tc
from pairwise_perturbation_tpu_torch.ops import dimtree
from pairwise_perturbation_tpu_torch.ops.kernels import chain_step as cs
from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
from pairwise_perturbation_tpu_torch.utils import tracing

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
F64, F32 = 1e-12, 1e-5
RANKS = (1, 6, 10, 17)
# Mode shapes of T (the rank axis added by the test): position 0 is the
# first mode, 1 a middle one, 2 the last before the rank axis.
MODE_SHAPES = ((3, 5, 7), (2, 40, 4))
LAYOUTS = ("rank_minor", "rank_major")


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


def _t(modes, R, layout, dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    shape = tuple(modes) + (R,) if layout == "rank_minor" else \
        (R,) + tuple(modes)
    T = torch.randn(shape, generator=gen, dtype=torch.float64).to(dtype)
    return T, gen


def _einsum_step(T, W, pos, layout):
    """The einsum the chain would run: contract_mode_kr (rank-minor) or
    _contract_mode_kr_rm's spec (rank-major), with the route closed."""
    modes = T.ndim - 1
    rem = tuple(range(modes))
    if layout == "rank_minor":
        return torch.einsum(
            f"{tc._MODES[:modes]}Z,{tc._MODES[pos]}Z->"
            f"{tc._MODES[:pos]}{tc._MODES[pos + 1:modes]}Z", T, W), rem
    return torch.einsum(
        f"Z{tc._MODES[:modes]},{tc._MODES[pos]}Z->"
        f"Z{tc._MODES[:pos]}{tc._MODES[pos + 1:modes]}", T, W), rem


@pytest.mark.parametrize("dtype,tol", [(torch.float64, F64),
                                       (torch.float32, F32)])
@pytest.mark.parametrize("R", RANKS)
@pytest.mark.parametrize("modes,pos", [(m, p) for m in MODE_SHAPES
                                       for p in range(3)])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_matches_the_einsum_step(dtype, tol, R, modes, pos, layout):
    """The plain version against the chain's einsum step: same shape and
    dtype, within the dtype's tolerance."""
    T, gen = _t(modes, R, layout, dtype)
    W = torch.randn((modes[pos], R), generator=gen,
                    dtype=torch.float64).to(dtype)
    want, _ = _einsum_step(T, W, pos, layout)
    got = cs.chain_step(T, W, pos, layout)       # CPU: the plain version
    assert got.shape == want.shape and got.dtype == dtype
    assert _rel(got, want) <= tol


def test_the_cases_cover_both_plans_and_parts():
    """The shapes above reach both load widths, a plan with parts and one
    without."""
    seen = set()
    for layout, R, modes, pos in itertools.product(LAYOUTS, RANKS,
                                                   MODE_SHAPES, range(3)):
        T, _ = _t(modes, R, layout, torch.float32)
        p = cs.plan_for(T, R, pos, layout)
        seen |= {f"vec{p.vec}", "parts" if p.parts > 1 else "one"}
    assert seen == {"vec1", "vec4", "parts", "one"}


# (rows, C, N, R, aligned) -> (vec, parts): the cells' steps.
PLAN_CASES = [
    ((1, 50, 50 ** 4 * 6, 6, True), (4, 1)),       # strong6 mode 1
    ((32500, 50, 6, 6, True), (1, 1)),             # strong6 leaf
    ((50, 50, 6, 6, True), (1, 6)),
    ((1, 3, 128 * 7200 * 10, 10, True), (4, 1)),   # coil mode 0
    ((3, 128, 72000, 10, True), (4, 3)),
    ((384, 128, 10, 10, True), (1, 16)),           # coil leaf
    ((3, 128, 72000, 10, False), (1, 1)),          # off alignment
    ((7, 9, 18, 6, True), (1, 1)),                 # N % 4 != 0
    ((1, 100000, 40, 10, True), (4, 527)),
]


@pytest.mark.parametrize("case,want", PLAN_CASES)
def test_plan(case, want):
    """The plan's load width and parts; the parts cover C with the last
    one non-empty, and a part's W fits the block's shared memory."""
    rows, C, N, R, aligned = case
    p = cs.plan(rows, C, N, R, 132, aligned)
    assert (p.vec, p.parts) == want
    assert p.parts * p.part_len >= C > (p.parts - 1) * p.part_len
    assert p.smem == 4 * p.part_len * R <= cs.SMEM
    assert p.blocks == -(-rows * (N // p.vec) // cs.THREADS)


def test_plan_cuts_w_to_shared_memory():
    """A part's rows of W fit 48 KB at any R the kernel takes: C 4096 at
    R 100 is cut into parts of at most 122 rows."""
    p = cs.plan(1, 4096, 100 * 4096, 100, 132, True)
    assert p.part_len * 100 * 4 <= cs.SMEM and p.parts >= 4096 // 122


def test_route_admits():
    T = torch.empty((3, 5, 7, 6))
    assert [cs.route_admits(T, 6, p) for p in range(4)] == \
        [True, True, True, False]
    assert not cs.route_admits(T, 5, 0)                   # R is not T's
    assert not cs.route_admits(torch.empty((3, 0, 7, 6)), 6, 0)
    assert cs.route_admits(torch.empty((6, 3, 5, 7)), 6, 1, "rank_major")
    assert not cs.route_admits(torch.empty((2, 3, 13000)), 13000, 0)
    with pytest.raises(ValueError):
        cs.route_admits(T, 6, 0, "rank_outer")


def test_route_refuses_a_grid_past_the_kernel(monkeypatch):
    """A plan past the grid's limits is refused (the decision is cached
    by shape, so the cache is cleared around the patched plans)."""
    T = torch.empty((3, 5, 7, 6))
    for bad in (cs.Plan(4, 1, 5, 2 ** 31, 120),
                cs.Plan(4, 65536, 1, 1, 120)):
        monkeypatch.setattr(cs, "plan", lambda *a, **k: bad)
        cs._admitted_shape.cache_clear()
        assert not cs.route_admits(T, 6, 1)
    cs._admitted_shape.cache_clear()


def test_kernel_refuses_what_it_does_not_take():
    """CUDA-only checks, raised before any launch: a CPU tensor takes the
    plain version; a meta tensor (no card) is refused with the reason."""
    T = torch.empty((3, 5, 6), device="meta")
    W = torch.empty((3, 6), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        cs.chain_step(T, W, 0)
    with pytest.raises(ValueError, match="layout"):
        cs.chain_step(torch.zeros((3, 5, 6)), torch.zeros((3, 6)), 0,
                      "rank_outer")


# ---- the route in ops/contract.py


def _inputs(shape=(3, 8, 8, 40), R=4, dtype=torch.float64, seed=0):
    gen = torch.Generator().manual_seed(seed)
    V = torch.randn(shape, generator=gen, dtype=dtype)
    Ws = [torch.randn((s, R), generator=gen, dtype=dtype) for s in shape]
    return V, Ws


def _steps():
    s = tracing.stats()
    return (s.get("contract.step_kernel", (0,))[0],
            s.get("contract.step_einsum", (0,))[0])


def test_cpu_route_keeps_the_einsum_bit_for_bit(monkeypatch):
    """An unpatched CPU T: every step is the einsum it was, bit for bit,
    counted as an einsum call; the kernel module is never called. The
    rank-major steps count only over a middle mode, where the einsum
    would copy T."""
    calls = []
    monkeypatch.setattr(cs, "chain_step", lambda *a, **k: calls.append(a))
    for dtype in (torch.float32, torch.float64):
        T, gen = _t((3, 5, 7), 6, "rank_minor", dtype)
        for pos in range(3):
            W = torch.randn((T.shape[pos], 6), generator=gen).to(dtype)
            tracing.reset()
            got, rem = tc.contract_mode_kr(T, (0, 1, 2), True, W, pos)
            want, _ = _einsum_step(T, W, pos, "rank_minor")
            assert torch.equal(got, want) and _steps() == (0, 1)
            assert rem == tuple(m for m in (0, 1, 2) if m != pos)
        T, gen = _t((3, 5, 7), 6, "rank_major", dtype)
        for pos in range(3):
            W = torch.randn((T.shape[pos + 1], 6), generator=gen).to(dtype)
            tracing.reset()
            got, _ = tc._contract_mode_kr_rm(T, (0, 1, 2), W, pos)
            want, _ = _einsum_step(T, W, pos, "rank_major")
            assert torch.equal(got, want)
            assert _steps() == (0, 1 if pos == 1 else 0)
    assert not calls


def test_step_on_card_refuses_the_cpu_and_other_types():
    T = torch.empty((3, 5, 6))
    W = torch.empty((5, 6))
    assert not tc._step_on_card(T, W)
    assert not tc._step_on_card(T.double(), W)
    assert not tc._step_on_card(torch.empty((3, 5, 6), device="meta"), W)


def _open_route(monkeypatch):
    monkeypatch.setattr(tc, "_step_on_card", lambda T, factor: True)


# Sites, and the chain steps of one call of each at (3, 8, 8, 40) R 4
# (priority (3, 1, 2, 0)): a DT sweep's tree nodes make 6 steps (the tree's
# four MTTKRPs at fixed factors the same 6), the four MTTKRPs 8 (the
# mode-3 chain's two with the first level over mode 1), a diagnostics row
# 6 (its four MTTKRPs from the same midpoint tree), a cache build 2
# (rank-major over mode 2's middle).
SITES = {"dt_sweep": 6, "dt_tree": 6, "mttkrp": 8, "cp_diagnostics": 6,
         "build_pp_caches": 2}


def _site(name, V, Ws, layout=None):
    if name == "dt_tree":
        tree = dimtree.BinaryTreeSweep(V, Ws, layout=layout)
        return [tree.mttkrp(i) for i in range(V.ndim)]
    if name == "dt_sweep":
        Ws2, grads = cp.dt_sweep(V, Ws, 0.0, layout=layout)
        return list(Ws2) + list(grads)
    if name == "mttkrp":
        return [tc.mttkrp(V, Ws, m, layout=layout) for m in range(V.ndim)]
    if name == "cp_diagnostics":
        return list(cp.cp_diagnostics(tc.norm_sq(V, layout), V, Ws,
                                      layout=layout))
    single, pair = cp.pp_build_caches(V, Ws, layout)
    return [single[i] for i in sorted(single)] + \
        [pair[k] for k in sorted(pair)]


@pytest.mark.parametrize("site", sorted(SITES))
def test_route_matches_the_einsum_chain(site, monkeypatch):
    """Each site through the kernel module (its plain version) against the
    einsum chain, float64; every step counted, by the path that served
    it."""
    V, Ws = _inputs()
    tracing.reset()
    want = _site(site, V, Ws)
    assert _steps() == (0, SITES[site])
    _open_route(monkeypatch)
    tracing.reset()
    got = _site(site, V, Ws)
    assert _steps() == (SITES[site], 0)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert _rel(g, w) <= F64


def test_route_keeps_the_einsum_for_a_strided_t(monkeypatch):
    """A non-contiguous T (a permuted view) keeps the einsum, counted."""
    _open_route(monkeypatch)
    T, gen = _t((3, 5, 7), 6, "rank_minor", torch.float64)
    T = T.transpose(0, 1)
    W = torch.randn((5, 6), generator=gen, dtype=torch.float64)
    calls = []
    monkeypatch.setattr(cs, "chain_step", lambda *a, **k: calls.append(a))
    tracing.reset()
    got, _ = tc.contract_mode_kr(T, (1, 0, 2), True, W, 1)
    assert not calls and _steps() == (0, 1)
    assert torch.equal(got, torch.einsum("abcZ,aZ->bcZ", T, W))


class _Mesh:
    """What plan_layout and span read of a mesh: a (1,) mesh at 0."""
    shape = (1,)
    mesh_dim_names = ("x",)

    def get_coordinate(self):
        return [0]


@pytest.mark.parametrize("site", sorted(SITES))
def test_world_of_one_equals_one_process(site, monkeypatch):
    """A block-sharded V on a world of one (a (1,) mesh: no mode split,
    every hook the identity) computes each site as one process does, bit
    for bit, with the route open, and makes the same steps."""
    V, Ws = _inputs(shape=(3, 8, 8, 40))
    layout = pmesh.plan_layout(V.shape, _Mesh())
    _open_route(monkeypatch)
    tracing.reset()
    want = _site(site, V, Ws)
    steps = _steps()
    tracing.reset()
    got = _site(site, V, Ws, layout)
    assert _steps() == steps == (SITES[site], 0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_engine_counts_every_step_on_the_cpu():
    """A CP-DT fit on the CPU: every chain step counted as an einsum call,
    6 a DT sweep (the warm-up's too) and 6 a diagnostics row (the same
    midpoint tree)."""
    V, Ws = _inputs(dtype=torch.float32)
    tracing.reset()
    tracing.enable()
    try:
        res = cp.als_cp_dt(V, Ws, cp.CPConfig(tol=0.0, maxiter=4,
                                              resprint=2))
    finally:
        tracing.enable(False)
    s = tracing.stats()
    sweeps = s["cp.sweep"][0] + 1
    rows = s["cp.diagnostics"][0]
    assert res.iters >= 4 and rows >= 2
    assert _steps() == (0, 6 * sweeps + 6 * rows)



def test_pp_engine_counts_every_step_on_the_cpu():
    """A CP-PP fit on the CPU at root split 2 (the planner's at the coil
    shape, planned alike): every chain step counted as an einsum call, 7
    a DT sweep and 7 a diagnostics row (the same tree at the engine's
    split), 2 a cache build, and 7 + 2 in the
    warm-ups (a DT sweep, and the cache build the first PP phase reuses;
    the warm PP sweep makes none)."""
    V, Ws = _inputs(dtype=torch.float32)
    tracing.reset()
    tracing.enable()
    try:
        res = cp.als_cp_pp(V, Ws, cp.CPConfig(
            tol=0.0, pp_res_tol=0.1, maxiter=20, resprint=5, tree_split=2))
    finally:
        tracing.enable(False)
    s = tracing.stats()
    sweeps, rows = s["cp.dt_sweep"][0], s["cp.diagnostics"][0]
    builds = s["cp.pp_cache_build"][0]
    assert res.iters >= 20 and builds >= 1 and s["cp.pp_sweep"][0] >= 1
    assert _steps() == (0, 7 * sweeps + 7 * rows + 2 * builds + 7 + 2)


def _reading(stats):
    return brun.Reading(stats={n: (c, 0.0, float("nan"))
                               for n, c in stats.items()})


@pytest.mark.parametrize("stats,want", [
    ({}, None),
    ({"contract.first_kernel": 30}, None),
    ({"contract.step_kernel": 187}, 100.0),
    ({"contract.step_einsum": 200}, 0.0),
    ({"contract.step_kernel": 3, "contract.step_einsum": 1}, 75.0)])
def test_chain_step_kernel_pct_reader(stats, want):
    got = brun.load(REPO, "metrics", "chain_step_kernel_pct").read(
        _reading(stats))
    assert got == want if want is None else got == pytest.approx(want)


# ---- on a card

# f32 sums of up to 128 products in another order than the einsum's
# GEMV, of uniform [0, 1) operands (no cancellation): 1e-5 relative.
CUDA_TOL = 1e-5
# (mode shape, R, pos, layout): the cells' steps at reduced sizes, parts,
# both load widths.
CUDA_CASES = [
    ((3, 128, 720), 10, 0, "rank_minor"),
    ((3, 128, 720), 10, 1, "rank_minor"),
    ((3, 128, 128), 10, 2, "rank_minor"),
    ((50, 50, 50, 50), 6, 0, "rank_minor"),
    ((13, 50, 50, 50), 6, 3, "rank_minor"),
    ((7, 9, 3), 6, 1, "rank_minor"),
    ((1, 4096, 40), 10, 1, "rank_minor"),
    ((50, 50, 50, 50), 6, 2, "rank_major"),
    ((3, 128, 720), 10, 1, "rank_major"),
    ((5, 17, 3), 17, 1, "rank_major"),
]


def _card_gen(seed=28):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pairwise_perturbation_tpu_torch import config
    config.apply_fp32_pins()
    return torch.Generator(device="cuda").manual_seed(seed)


def _card_case(modes, R, layout, offset=0, seed=28):
    gen = _card_gen(seed)
    shape = tuple(modes) + (R,) if layout == "rank_minor" else \
        (R,) + tuple(modes)
    n = 1
    for s in shape:
        n *= s
    T = torch.rand(n + offset, generator=gen, device="cuda")[offset:] \
        .view(shape)
    return T, gen


@pytest.mark.cuda
@pytest.mark.parametrize("modes,R,pos,layout", CUDA_CASES)
def test_cuda_kernel_against_the_einsum(modes, R, pos, layout):
    """The kernel against the einsum step on the card, to CUDA_TOL, one
    launch counted, and bit for bit across two calls."""
    T, gen = _card_case(modes, R, layout)
    W = torch.rand((modes[pos], R), generator=gen, device="cuda")
    want, _ = _einsum_step(T, W, pos, layout)
    before = cs.LAUNCHES["chain_step"]
    got = cs.chain_step(T, W, pos, layout)
    again = cs.chain_step(T, W, pos, layout)
    torch.cuda.synchronize()
    assert cs.LAUNCHES["chain_step"] - before == 2
    assert got.shape == want.shape and got.is_contiguous()
    assert _rel(got.double(), want.double()) <= CUDA_TOL
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_cuda_kernel_off_alignment():
    """T 4 bytes past a 16-byte boundary takes one column a thread."""
    T, gen = _card_case((3, 128, 720), 10, "rank_minor", offset=1)
    W = torch.rand((128, 10), generator=gen, device="cuda")
    assert cs.plan_for(T, 10, 1).vec == 1
    got = cs.chain_step(T, W, 1)
    torch.cuda.synchronize()
    want, _ = _einsum_step(T, W, 1, "rank_minor")
    assert _rel(got.double(), want.double()) <= CUDA_TOL


@pytest.mark.cuda
def test_cuda_kernel_refuses_what_it_does_not_take():
    T, gen = _card_case((3, 5, 7), 6, "rank_minor")
    W = torch.rand((5, 6), generator=gen, device="cuda")
    with pytest.raises(TypeError):
        cs.chain_step(T.double(), W, 1)
    with pytest.raises(ValueError, match="contiguous"):
        cs.chain_step(T.transpose(0, 2), W, 1)
    with pytest.raises(ValueError, match="shape"):
        cs.chain_step(T, W[:4], 1)
    with pytest.raises(ValueError):
        cs.chain_step(T, W.cpu(), 1)
    assert not cs.route_admits(T, 6, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("site", ["dt_tree", "mttkrp", "cp_diagnostics",
                                  "build_pp_caches"])
def test_cuda_route_against_the_einsum_route(site, monkeypatch):
    """A DT sweep's tree MTTKRPs, the four chain MTTKRPs, a diagnostics
    row and a cache build at the coil shape with mode 3 cut to 720,
    through the kernel against the einsum route (the device test closed),
    every step served by the kernel. No solve: with these all-positive
    operands the last mode's Gram product is conditioned near 3e4, and a
    sweep's solves leave either route 1e-3 off a float64 sweep
    (test_cuda_dt_sweep_against_the_einsum_route solves)."""
    V, gen = _card_case((3, 128, 128, 720), 1, "rank_minor")
    V = V.reshape(3, 128, 128, 720)
    Ws = [torch.rand((s, 10), generator=gen, device="cuda")
          for s in V.shape]
    monkeypatch.setattr(tc, "_step_on_card", lambda T, factor: False)
    want = _site(site, V, Ws)
    monkeypatch.undo()
    tracing.reset()
    got = _site(site, V, Ws)
    torch.cuda.synchronize()
    kernel, einsum = _steps()
    assert kernel > 0 and einsum == 0
    for g, w in zip(got, want):
        assert _rel(g.double(), w.double()) <= 1e-4


# A whole DT sweep on zero-mean V and factors: every Gram product S a
# solve meets is conditioned below GRAM_COND (asserted), so the two
# routes' f32 sums in different orders reach the new factors amplified
# by at most that: an f32 tolerance holds.
GRAM_COND = 1e3
SWEEP_TOL = 1e-4


@pytest.mark.cuda
def test_cuda_dt_sweep_against_the_einsum_route(monkeypatch):
    """A whole DT sweep (tree MTTKRPs, solves, gradients, normalisation)
    at the coil shape with mode 3 cut to 720, kernel route against the
    einsum route, to SWEEP_TOL, every chain step served by the kernel."""
    gen = _card_gen()
    shape = (3, 128, 128, 720)
    V = torch.randn(shape, generator=gen, device="cuda")
    Ws = [torch.randn((s, 10), generator=gen, device="cuda") for s in shape]
    conds = []
    gram = tc.hadamard_gram

    def recorded(*args, **kwargs):
        S = gram(*args, **kwargs)
        conds.append(float(torch.linalg.cond(S.double())))
        return S

    monkeypatch.setattr(tc, "hadamard_gram", recorded)
    on_card = tc._step_on_card
    monkeypatch.setattr(tc, "_step_on_card", lambda T, factor: False)
    want = _site("dt_sweep", V, Ws)
    monkeypatch.setattr(tc, "_step_on_card", on_card)
    tracing.reset()
    got = _site("dt_sweep", V, Ws)
    torch.cuda.synchronize()
    kernel, einsum = _steps()
    assert kernel == SITES["dt_sweep"] and einsum == 0
    assert len(conds) == 2 * len(shape) and max(conds) < GRAM_COND
    for g, w in zip(got, want):
        assert _rel(g.double(), w.double()) <= SWEEP_TOL
