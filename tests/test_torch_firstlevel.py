"""The port's last first-level kernels against the JAX package's Pallas
kernels on the same numpy inputs: ops/kernels/last_contract.py (K5),
mid_contract.py's rank-outer layout (S2) and block widths (S5),
column_sum.py (S4), and the explicit kernel switches of
ops/contract.py (``first_contraction(use_kernels=)``,
``build_pp_caches(use_kernels_first=)``).

On the CPU each wrapper takes its plain version, which is held to the
Pallas kernel in interpret mode. The benchmark-only kernels of
``scripts/bench_rankpos.py`` and ``scripts/bench_midvariants.py`` are
launched as those scripts launch them, minus the TPU memory space. The
``cuda``-marked tests hold the CUDA kernels to the plain versions on a
card:

    python -m pytest tests/test_torch_firstlevel.py --noconftest -m cuda
"""

import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

from pairwise_perturbation_tpu_torch import config
from pairwise_perturbation_tpu_torch.ops import contract as tc
from pairwise_perturbation_tpu_torch.ops.kernels import column_sum as cs
from pairwise_perturbation_tpu_torch.ops.kernels import last_contract as lc
from pairwise_perturbation_tpu_torch.ops.kernels import mid_contract as mc

torch.set_num_threads(1)

# Eligible last_contract shapes and ranks: two order-3, an order-2 and an
# order-4 one, and R above one rank chunk.
LAST_CASES = [((4, 8, 256), 5), ((16, 128), 10), ((2, 4, 8, 384), 7),
              ((8, 2, 256), 40)]
# (P, B, M) and lane tile L of the benchmark-only Pallas calls.
VIEW_CASES = [((3, 16, 512), 256), ((6, 8, 384), 128)]
SCRIPTS = pathlib.Path(__file__).resolve().parents[1] / "scripts"


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _spy(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def spy(*a, **k):
        calls.append(a)
        return orig(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.fixture
def midvariants():
    """scripts/bench_midvariants.py as a module. Importing it sets two JAX
    config values; they are put back afterwards so that nothing leaks into
    the other tests of this worker."""
    import jax
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    old = {k: getattr(jax.config, k) for k in keys}
    spec = importlib.util.spec_from_file_location(
        "bench_midvariants", SCRIPTS / "bench_midvariants.py")
    mod = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(mod)
        yield mod
    finally:
        for k, v in old.items():
            jax.config.update(k, v)


def _pallas_view_call(kernel, V3, W, L, out_layout):
    """A (P, nl) grid over V3 (P, B, M) with (1, B, L) blocks, as the
    scripts launch their kernels, without the VMEM memory space; W (B, R)
    enters transposed, as there. ``out_layout`` is "rank_major" (P, R, M),
    "rank_outer" (R, P, M) or "sum" (P, 1, M)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    P, B, M = V3.shape
    nl = M // L
    v_spec = pl.BlockSpec((1, B, L), lambda p, l: (p, 0, l))
    if out_layout == "sum":
        return pl.pallas_call(
            kernel, grid=(P, nl), in_specs=[v_spec],
            out_specs=pl.BlockSpec((1, 1, L), lambda p, l: (p, 0, l)),
            out_shape=jax.ShapeDtypeStruct((P, 1, M), jnp.float32),
            interpret=True)(jnp.asarray(V3))
    R = W.shape[1]
    out_spec, out_shape = {
        "rank_major": (pl.BlockSpec((1, R, L), lambda p, l: (p, 0, l)),
                       (P, R, M)),
        "rank_outer": (pl.BlockSpec((R, 1, L), lambda p, l: (0, p, l)),
                       (R, P, M))}[out_layout]
    return pl.pallas_call(
        kernel, grid=(P, nl),
        in_specs=[pl.BlockSpec((R, B), lambda p, l: (0, 0)), v_spec],
        out_specs=out_spec,
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        interpret=True)(jnp.asarray(W.T), jnp.asarray(V3))


@pytest.mark.parametrize("shape,R", LAST_CASES)
def test_last_contract_plain_matches_pallas_f32(shape, R):
    """K5's plain version against ``last_contract(interpret=True)`` on
    eligible shapes: f32 sums of up to 384 products in other orders, rel
    max-norm 1e-5."""
    import jax.numpy as jnp
    from pairwise_perturbation_tpu.ops.kernels import mttkrp_pallas
    assert lc.last_contract_eligible(shape, torch.float32, R)
    rng = np.random.default_rng(R)
    V = rng.standard_normal(shape).astype(np.float32)
    W = rng.standard_normal((shape[-1], R)).astype(np.float32)
    want = mttkrp_pallas.last_contract(jnp.asarray(V), jnp.asarray(W),
                                       interpret=True)
    got = lc.last_contract(torch.from_numpy(V), torch.from_numpy(W))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("shape,R", LAST_CASES)
def test_last_contract_plain_bf16_matches_numpy(shape, R):
    """bf16 V (K6's O3 takes K5 on bf16-stored V): float32 output equal
    to numpy's float64 product of the bf16-rounded V and W to rel 1e-6
    (each product is exact in float32; up to 384 of them are summed in
    float32), and no launch on the CPU."""
    rng = np.random.default_rng(R + 1)
    V = torch.tensor(rng.standard_normal(shape), dtype=torch.bfloat16)
    W = torch.from_numpy(rng.standard_normal((shape[-1], R)).astype(
        np.float32))
    before = dict(lc.LAUNCHES)
    got = lc.last_contract(V, W)
    assert lc.LAUNCHES == before
    assert got.dtype == torch.float32 and got.shape == shape[:-1] + (R,)
    want = np.einsum("...b,br->...r", V.double().numpy(),
                     W.to(torch.bfloat16).double().numpy())
    assert _rel(got, want) <= 1e-6


def test_last_contract_plain_f64_matches_numpy():
    """In float64 the plain version equals numpy's product to 1e-10."""
    rng = np.random.default_rng(9)
    V = rng.standard_normal((3, 5, 7, 301))
    W = rng.standard_normal((301, 12))
    got = lc.last_contract(torch.from_numpy(V), torch.from_numpy(W))
    assert got.dtype == torch.float64 and got.shape == (3, 5, 7, 12)
    assert _rel(got, np.einsum("abcd,dr->abcr", V, W)) <= 1e-10


# (N, B, R, V's offset from a 16-byte boundary) for K5's planner, f32 V:
# the coil-100 shape at R 10 and 40, the same with an unaligned V (scalar
# loads), a B below one slice, and ragged B.
PLAN_CASES = [(49152, 7200, 10, 0), (49152, 7200, 40, 0),
              (49152, 7200, 10, 4), (8192, 1000, 10, 0),
              (37, 1001, 7, 0)]


@pytest.mark.parametrize("N,B,R,offset", PLAN_CASES)
def test_last_contract_plan(N, B, R, offset):
    """Equal slices that cover B, whose staged W leaves room for two
    blocks on an SM; 16-byte loads start each slice on a multiple of 4
    columns; the blocks of all slices and rank chunks fit the card at
    once, and each block's run of row tiles covers them all."""
    n_sm = 132
    vec = B % 4 == 0 and offset == 0
    p = lc.plan(N, B, R, n_sm, offset)
    vw = 4 if vec else 1
    assert p.path == "fma"
    assert p.vec == vw and p.rank_chunk == lc.rank_chunk(R)
    assert p.rows == lc.rows_per_warp(p.rank_chunk)
    n_rc = -(-R // p.rank_chunk)
    assert (p.n_slices - 1) * p.slice_cols < B <= p.n_slices * p.slice_cols
    assert p.slice_cols % vw == 0
    assert p.smem == p.slice_cols // vw * lc.group_stride(p.rank_chunk, vw) * 4
    assert 2 * (p.smem + lc.SMEM_RESERVED) <= lc.SMEM_PER_SM
    assert lc.group_stride(p.rank_chunk, vw) % 8 == 4
    tiles = -(-N // (lc.WARPS * p.rows))
    per_block = -(-tiles // p.blocks)
    assert (p.blocks - 1) * per_block < tiles <= p.blocks * per_block
    assert p.blocks * p.n_slices * n_rc <= 2 * n_sm or p.blocks == 1
    if p.n_slices > 1:          # one slice fewer would not fit
        groups = math.ceil(-(-B // vw) / (p.n_slices - 1))
        assert groups * lc.group_stride(p.rank_chunk, vw) * 4 > \
            lc.SMEM_BUDGET
    if (N, B, R, offset) == (49152, 7200, 10, 0):
        # the coil-100 shape: 4 slices of 1800 rows of W, 93.6 KB each
        assert (p.n_slices, p.slice_cols, p.smem, p.rank_chunk) == \
            (4, 1800, 93600, 12)
        assert p.blocks * p.n_slices <= 2 * n_sm
    if B == 1000:
        assert p.n_slices == 1


# (bf16, B, V's offset from a 16-byte boundary) -> (path, values per load):
# the tensor cores take bf16 V with B % 8 == 0 on a 16-byte boundary; bf16
# 8 bytes off, B % 8 == 4 or 2 bytes off, and f32, keep the FMA template.
PATH_CASES = [((True, 7200, 0), ("mma", 8)), ((True, 7200, 8), ("fma", 4)),
              ((True, 7200, 2), ("fma", 1)), ((True, 7204, 0), ("fma", 4)),
              ((True, 1001, 0), ("fma", 1)), ((True, 200, 0), ("mma", 8)),
              ((False, 7200, 0), ("fma", 4)), ((False, 7200, 8), ("fma", 1))]


@pytest.mark.parametrize("case,want", PATH_CASES)
def test_last_contract_plan_path(case, want):
    """plan() names the path from V's type, B % 8 and V's alignment."""
    bf16, B, offset = case
    p = lc.plan(4096, B, 10, 132, offset, bf16)
    assert (p.path, p.vec) == want
    assert lc.path(B, offset, bf16) == want[0]


# (N, B, R) of the mma path's plan: the coil shape (K6's O3), 512^3's
# mode 2 view, R = 40, and a B of one partial step.
MMA_PLAN_CASES = [(49152, 7200, 10), (262144, 512, 10), (49152, 7200, 40),
                  (37, 8, 1)]


@pytest.mark.parametrize("N,B,R", MMA_PLAN_CASES)
def test_last_contract_mma_plan(N, B, R):
    """The mma path stages whole 32-column steps of A fragments (1 KB a
    step) in slices that leave room for two blocks on an SM and cover B;
    8 rows a warp, 16 ranks a chunk; the grid fits the card at once."""
    n_sm = 132
    p = lc.plan(N, B, R, n_sm, 0, True)
    assert (p.path, p.rank_chunk, p.rows) == ("mma", 16, lc.MMA_ROWS)
    assert p.slice_cols % lc.MMA_STEP == 0
    assert p.smem == p.slice_cols // lc.MMA_STEP * lc.MMA_STEP_BYTES
    assert 2 * (p.smem + lc.SMEM_RESERVED) <= lc.SMEM_PER_SM
    assert (p.n_slices - 1) * p.slice_cols < B <= p.n_slices * p.slice_cols
    n_rc = -(-R // 16)
    assert p.blocks * p.n_slices * n_rc <= 2 * n_sm or p.blocks == 1
    tiles = -(-N // (lc.WARPS * lc.MMA_ROWS))
    per_block = -(-tiles // p.blocks)
    assert (p.blocks - 1) * per_block < tiles <= p.blocks * per_block
    if (N, B) == (49152, 7200):
        # two slices of 113 steps, 115.7 KB each: the whole budget
        assert (p.n_slices, p.slice_cols, p.smem) == (2, 3616, 115712)


# (N, B, R, slice_cols) of the mma path's emulation: whole tiles and steps,
# ragged N with a partial last step, R = 40 (three rank chunks), and
# slices (cut smaller than the plan's) whose last step is partial.
MMA_EMULATION_CASES = [(32, 256, 10, None), (37, 200, 10, None),
                       (37, 96, 40, None), (49, 232, 12, 96),
                       (16, 256, 7, 64)]


@pytest.mark.parametrize("N,B,R,slice_cols", MMA_EMULATION_CASES)
def test_last_contract_mma_mapping(N, B, R, slice_cols):
    """csrc/last_contract.cu's fragment mapping, emulated over a whole
    launch (lc.emulate_mma through the PTX fragment layouts): every
    product V[n, b] W[b, r] is summed exactly once, into out[n, r], and
    no product of real elements lands elsewhere; the emulated sums equal
    the plain version to rel 1e-5 (float64 emulation, float32 plain)."""
    rng = np.random.default_rng(N * B + R)
    V = torch.from_numpy(rng.random((N, B), dtype=np.float32)).bfloat16()
    W = rng.random((B, R), dtype=np.float32)
    p = lc.plan(N, B, R, 132, 0, True)
    if slice_cols is not None:
        p = p._replace(slice_cols=slice_cols, n_slices=-(-B // slice_cols))
    out, count, misplaced = lc.emulate_mma(V.double().numpy(), W, p)
    assert misplaced == 0
    assert count.min() == 1 and count.max() == 1
    assert _rel(torch.from_numpy(out),
                lc.last_contract_plain(V, torch.from_numpy(W))) <= 1e-5


def test_last_contract_eligible_matches_jax():
    """The copied predicate equals the JAX package's over a grid of
    shapes, dtypes and ranks, so the routing rule reads the same."""
    import jax.numpy as jnp
    from pairwise_perturbation_tpu.ops.kernels import mttkrp_pallas as mp
    dtypes = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
              (torch.float64, jnp.float64)]
    shapes = [(3, 128, 128, 7200), (4, 8, 256), (16, 128), (7, 128),
              (8, 127), (8, 65536), (8, 65537), (3, 100, 4000),
              (1024, 8192), (24, 300), (2, 2, 2, 512)]
    n_true = 0
    for shape in shapes:
        for t_dt, j_dt in dtypes:
            for r in (1, 10, 256, 257):
                got = lc.last_contract_eligible(shape, t_dt, r)
                assert got == mp.last_contract_eligible(shape, j_dt, r), \
                    (shape, t_dt, r)
                n_true += got
    assert n_true > 0


@pytest.mark.parametrize("shape,L", VIEW_CASES)
def test_rank_outer_plain_matches_mid_kernel_zp(shape, L):
    """S2: the rank-outer plain version, taken physically as (R, P, M),
    against ``_mid_kernel_zp`` launched as bench_rankpos launches it; rel
    max-norm 2e-5 (the JAX kernel test's rtol)."""
    from pairwise_perturbation_tpu.ops.kernels import mttkrp_pallas as mp
    rng = np.random.default_rng(shape[0])
    V3 = rng.standard_normal(shape).astype(np.float32)
    W = rng.standard_normal((shape[1], 10)).astype(np.float32)
    want = _pallas_view_call(mp._mid_kernel_zp, V3, W, L, "rank_outer")
    got = mc.mid_contract(torch.from_numpy(V3), torch.from_numpy(W), 1,
                          layout="rank_outer").movedim(-1, 0)
    assert got.is_contiguous()
    assert _rel(got, want) <= 2e-5


@pytest.mark.parametrize("shape,L", VIEW_CASES)
def test_column_sum_plain_matches_copy_kernel(midvariants, shape, L):
    """S4: the plain column sum against ``_copy_kernel`` (a jnp.sum over
    each (B, L) block), rel max-norm 1e-6 (f32 sums of B terms in other
    orders)."""
    rng = np.random.default_rng(shape[1])
    V3 = rng.standard_normal(shape).astype(np.float32)
    want = _pallas_view_call(midvariants._copy_kernel, V3, None, L, "sum")
    got = cs.column_sum(torch.from_numpy(V3))
    assert got.shape == (shape[0], 1, shape[2])
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("shape,L", VIEW_CASES)
def test_block_widths_plain_matches_mm_kernel(midvariants, shape, L):
    """S5: the rank-major plain version, physically (P, R, M), against
    ``_mm_kernel`` at one of the script's lane tiles, at every block width
    the wrapper takes (on the CPU the width is checked, not used): rel
    max-norm 2e-5."""
    rng = np.random.default_rng(L)
    V3 = rng.standard_normal(shape).astype(np.float32)
    W = rng.standard_normal((shape[1], 10)).astype(np.float32)
    want = _pallas_view_call(midvariants._mm_kernel, V3, W, L, "rank_major")
    for cols in mc.BLOCK_COLS:
        got = mc.mid_contract(torch.from_numpy(V3), torch.from_numpy(W), 1,
                              layout="rank_major", block_cols=cols)
        assert _rel(got.movedim(-1, 1), want) <= 2e-5


@pytest.mark.parametrize("shape,mode", [((3, 16, 24, 50), 1),
                                        ((3, 16, 24, 50), 0),
                                        ((16, 10, 15), 1)])
def test_layouts_agree(shape, mode):
    """The three layouts come back as the same rank-last tensor (f64, to
    round-off); the rank-leading ones are views of a contiguous physical
    tensor of their layout."""
    rng = np.random.default_rng(len(shape))
    V = torch.from_numpy(rng.standard_normal(shape))
    W = torch.from_numpy(rng.standard_normal((shape[mode], 6)))
    minor = mc.mid_contract(V, W, mode)
    major = mc.mid_contract(V, W, mode, layout="rank_major")
    outer = mc.mid_contract(V, W, mode, layout="rank_outer")
    rest = shape[:mode] + shape[mode + 1:]
    assert minor.shape == major.shape == outer.shape == rest + (6,)
    assert minor.is_contiguous()
    assert major.movedim(-1, mode).is_contiguous()
    assert outer.movedim(-1, 0).is_contiguous()
    assert _rel(major, minor.numpy()) <= 1e-12
    assert _rel(outer, minor.numpy()) <= 1e-12


def test_layout_and_width_checks():
    """Unknown layouts and widths are refused, the rank-minor layout runs
    at 256 columns only; a tensor not on the CPU takes the kernel path,
    which refuses anything but CUDA operands; the CPU never launches."""
    V, W = torch.ones((4, 8, 6)), torch.ones((8, 3))
    with pytest.raises(ValueError, match="layout"):
        mc.mid_contract(V, W, 1, layout="rank_last")
    with pytest.raises(ValueError, match="block_cols"):
        mc.mid_contract(V, W, 1, layout="rank_major", block_cols=64)
    with pytest.raises(ValueError, match="256"):
        mc.mid_contract(V, W, 1, block_cols=512)
    meta = torch.empty((4, 8, 6), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        mc.mid_contract(meta, torch.empty((8, 3), device="meta"), 1,
                        layout="rank_outer", block_cols=128)
    with pytest.raises(ValueError, match="CUDA"):
        lc.last_contract(meta, torch.empty((6, 3), device="meta"))
    with pytest.raises(TypeError, match="float32"):
        lc.last_contract(meta.double(), torch.empty((6, 3), device="meta"))
    with pytest.raises(ValueError, match="W has shape"):
        lc.last_contract(meta, torch.empty((5, 3), device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        cs.column_sum(meta)
    with pytest.raises(TypeError, match="float32"):
        cs.column_sum(torch.empty((4, 8, 6), device="meta",
                                  dtype=torch.bfloat16))
    before = (dict(mc.LAUNCHES), dict(lc.LAUNCHES), dict(cs.LAUNCHES))
    for layout in mc.LAYOUTS:
        mc.mid_contract(V, W, 1, layout=layout)
    lc.last_contract(V, torch.ones((6, 3)))
    cs.column_sum(V)
    assert (mc.LAUNCHES, lc.LAUNCHES, cs.LAUNCHES) == before


@pytest.mark.parametrize("bad,exc,match", [
    ("dtype", TypeError, "float32"), ("device", ValueError, "CUDA"),
    ("empty", ValueError, "non-empty"), ("ndim", ValueError, "non-empty")])
def test_column_sum_refusals(bad, exc, match):
    """S4's wrapper refuses, with the reason, what the kernel does not
    take: not float32, not on a CUDA device, empty, not (P, B, M). A
    tensor not on the CPU takes the kernel path, so meta tensors reach
    the refusals; none counts a launch."""
    shape, dtype = {"empty": ((4, 0, 6), torch.float32),
                    "ndim": ((4, 8), torch.float32),
                    "dtype": ((4, 8, 6), torch.bfloat16)}.get(
                        bad, ((4, 8, 6), torch.float32))
    before = dict(cs.LAUNCHES)
    with pytest.raises(exc, match=match):
        cs.column_sum(torch.empty(shape, device="meta", dtype=dtype))
    assert cs.LAUNCHES == before


@pytest.mark.parametrize("shape", [(3, 16, 512), (5, 37, 1001), (1, 1, 1)])
def test_column_sum_cpu_takes_plain_without_launch(shape):
    """A CPU tensor takes the plain version, bit for bit, and counts no
    launch; the plain version sums over b in order, so it equals a float64
    sum to float32 rounding."""
    rng = np.random.default_rng(sum(shape))
    V3 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    before = dict(cs.LAUNCHES)
    got = cs.column_sum(V3)
    assert cs.LAUNCHES == before
    assert torch.equal(got, cs.column_sum_plain(V3))
    assert got.shape == (shape[0], 1, shape[2]) and got.dtype == torch.float32
    want = V3.double().sum(1, keepdim=True)
    assert float((got.double() - want).abs().max()) <= 1e-5 * shape[1]


def _first_problem(R=4):
    # mode 0 of (8, 16, 4096) is mid_contract-eligible: M = 65536 takes the
    # 2048-lane tile
    rng = np.random.default_rng(11)
    shape = (8, 16, 4096)
    V = rng.standard_normal(shape).astype(np.float32)
    Ws = [rng.standard_normal((s, R)).astype(np.float32) for s in shape]
    return V, Ws


def test_first_contraction_use_kernels_argument(monkeypatch):
    """``use_kernels=True`` routes an eligible mode to the kernel module
    whatever the config says, ``False`` never, ``None`` reads
    ``config.use_kernels_first``; held to the JAX interpret-mode route at
    rel 2e-5."""
    import jax.numpy as jnp
    from pairwise_perturbation_tpu.ops import contract as jc
    V, Ws = _first_problem()
    tV, tW = torch.from_numpy(V), torch.from_numpy(Ws[0])
    calls = _spy(monkeypatch, mc, "mid_contract")
    got, rem = tc.first_contraction(tV, tW, 0, use_kernels=True)
    assert len(calls) == 1
    with config.override(use_kernels_first=True):
        tc.first_contraction(tV, tW, 0, use_kernels=False)
        assert len(calls) == 1
        tc.first_contraction(tV, tW, 0)
    assert len(calls) == 2
    tc.first_contraction(tV, tW, 0)
    assert len(calls) == 2
    want, jrem = jc.first_contraction(jnp.asarray(V), None,
                                      jnp.asarray(Ws[0]), 0,
                                      use_pallas=True, interpret=True)
    assert rem == jrem == (1, 2)
    assert _rel(got, want) <= 2e-5


def test_build_pp_caches_use_kernels_first(monkeypatch):
    """``use_kernels_first=True`` sends each chain root through
    ``first_contraction``'s kernel route (only root 0 is eligible here);
    ``config.use_kernels_first`` alone does not reach the roots. Every
    cache equals the JAX ``use_pallas=True, interpret=True`` build to 3e-5
    (the JAX triple test's tolerance)."""
    import jax.numpy as jnp
    from pairwise_perturbation_tpu.ops import contract as jc
    V, Ws = _first_problem()
    tV, tW = torch.from_numpy(V), [torch.from_numpy(W) for W in Ws]
    calls = _spy(monkeypatch, mc, "mid_contract")
    with config.override(use_kernels_first=True):
        tc.build_pp_caches(tV, tW)
    assert calls == []
    ts_, tp = tc.build_pp_caches(tV, tW, use_kernels_first=True)
    assert [a[2] for a in calls] == [0]
    js_, jp = jc.build_pp_caches(jnp.asarray(V), [jnp.asarray(W) for W in Ws],
                                 use_pallas=True, interpret=True)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert _rel(tp[k], jp[k]) <= 3e-5, k
    for k in js_:
        assert _rel(ts_[k], js_[k]) <= 3e-5, k


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _held(got, want):
    torch.cuda.synchronize()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.cuda
def test_cuda_last_contract_matches_plain():
    """On a card: K5 against its plain version, rel max-norm 1e-4 (f32
    sums of up to 7200 products in other orders), two launches bit for bit
    equal; ragged N and B and R above one rank chunk included."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(7)
    for shape, R in [((3, 128, 720), 10), ((37, 1001), 7), ((5, 9, 300), 40),
                     ((1, 64), 1), ((96, 7200), 10), ((50, 7199), 12),
                     ((40, 9000), 40)]:
        V = torch.rand(shape, generator=gen, device="cuda")
        W = torch.rand((shape[-1], R), generator=gen, device="cuda")
        n0 = lc.LAUNCHES["last_contract"]
        got, again = lc.last_contract(V, W), lc.last_contract(V, W)
        assert lc.LAUNCHES["last_contract"] == n0 + 2
        assert _held(got, lc.last_contract_plain(V, W)) <= 1e-4
        assert torch.equal(got, again)


@pytest.mark.cuda
def test_cuda_last_contract_unaligned_v():
    """On a card: V 4 bytes past a 16-byte boundary (a contiguous view of
    buf[1:]) takes the scalar loads, a V with B % 4 != 0 too; both agree
    with the plain version to rel 1e-4 and with the aligned launch on the
    same values to rel 1e-6, and repeat bit for bit."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(10)
    for shape, R in [((64, 7200), 10), ((3, 40, 1001), 7), ((16, 4000), 40)]:
        n = math.prod(shape)
        buf = torch.rand(n + 1, generator=gen, device="cuda")
        V = buf[1:].view(shape)
        assert V.is_contiguous() and V.data_ptr() % 16 == 4
        W = torch.rand((shape[-1], R), generator=gen, device="cuda")
        got, again = lc.last_contract(V, W), lc.last_contract(V, W)
        assert _held(got, lc.last_contract_plain(V, W)) <= 1e-4
        assert torch.equal(got, again)
        assert _held(got, lc.last_contract(V.clone(), W)) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1, 4])
def test_cuda_last_contract_bf16(offset):
    """On a card: K5 with bf16 V, aligned (the tensor cores where B % 8
    == 0), 8 bytes off a 16-byte boundary (the fma path's 8-byte loads of
    4 values) and 2 bytes off (a contiguous view of buf[1:]: scalar
    loads), against its plain version on the same bf16-rounded operands,
    rel 1e-4, two launches bit for bit equal; the coil shape (K6's O3), a
    ragged B and R above one rank chunk."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(13)
    for shape, R in [((3, 128, 128, 7200), 10), ((3, 40, 1001), 7),
                     ((16, 4000), 40)]:
        n = math.prod(shape)
        buf = torch.rand(n + offset, generator=gen,
                         device="cuda").to(torch.bfloat16)
        V = buf[offset:].view(shape)
        assert V.data_ptr() % 16 == 2 * offset
        p = lc.plan_for(V, R)
        if offset == 0 and shape[-1] % 8 == 0:
            assert (p.path, p.vec) == ("mma", 8)
        else:
            assert (p.path, p.vec) == (
                "fma", 4 if offset != 1 and shape[-1] % 4 == 0 else 1)
        W = torch.rand((shape[-1], R), generator=gen, device="cuda")
        got, again = lc.last_contract(V, W), lc.last_contract(V, W)
        assert _held(got, lc.last_contract_plain(V, W)) <= 1e-4
        assert torch.equal(got, again)


# (V shape, R, V's offset in elements, path) of K5 with bf16 V on a card:
# the coil shape (two slices), a ragged N with a last partial step, R = 40,
# a B of one partial step, then B % 8 == 4 and V 2 bytes off alignment,
# which take the fma path.
K5_BF16_PATHS = [((3, 128, 128, 7200), 10, 0, "mma"), ((37, 1000), 7, 0, "mma"),
                 ((5, 9, 232), 40, 0, "mma"), ((3, 8), 1, 0, "mma"),
                 ((64, 1004), 7, 0, "fma"), ((64, 7200), 10, 1, "fma")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,R,offset,path", K5_BF16_PATHS)
def test_cuda_last_contract_bf16_paths(shape, R, offset, path):
    """On a card: K5 with bf16 V on the path its plan names (the tensor
    cores for B % 8 == 0 at a 16-byte boundary, else the FMA template)
    against its plain version on the same bf16-rounded operands, rel
    1e-4, two launches bit for bit equal, one launch counted each."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(14)
    buf = torch.rand(math.prod(shape) + offset, generator=gen,
                     device="cuda").to(torch.bfloat16)
    V = buf[offset:].view(shape)
    W = torch.rand((shape[-1], R), generator=gen, device="cuda")
    assert lc.plan_for(V, R).path == path
    n0 = lc.LAUNCHES["last_contract"]
    got, again = lc.last_contract(V, W), lc.last_contract(V, W)
    assert lc.LAUNCHES["last_contract"] == n0 + 2
    assert _held(got, lc.last_contract_plain(V, W)) <= 1e-4
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_rank_outer_and_widths_match_plain(dtype):
    """On a card: S2 (rank-outer) and S5 (rank-major and rank-outer at
    128, 256 and 512 columns) against the plain versions, rel max-norm
    1e-4, bit for bit across widths' repeats; each call counts one launch
    of its layout."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(8)
    for shape, mode, R in [((3, 128, 1200), 1, 10), ((5, 37, 1001), 1, 7),
                           ((64, 64, 64), 1, 40)]:
        V = torch.rand(shape, generator=gen, device="cuda").to(dtype)
        W = torch.rand((shape[mode], R), generator=gen, device="cuda")
        for layout in ("rank_major", "rank_outer"):
            want = mc.mid_contract_plain(V, W, mode, layout=layout)
            for cols in mc.BLOCK_COLS:
                n0 = mc.LAUNCHES[layout]
                got = mc.mid_contract(V, W, mode, layout=layout,
                                      block_cols=cols)
                again = mc.mid_contract(V, W, mode, layout=layout,
                                        block_cols=cols)
                assert mc.LAUNCHES[layout] == n0 + 2
                assert _held(got, want) <= 1e-4
                assert torch.equal(got, again)


@pytest.mark.cuda
def test_cuda_column_sum_matches_plain():
    """On a card: S4 against its plain version, which sums in the same
    order: equal to rel 1e-6, two launches bit for bit equal."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(9)
    for shape in [(3, 128, 9216), (384, 128, 72), (5, 37, 1001)]:
        V3 = torch.rand(shape, generator=gen, device="cuda")
        n0 = cs.LAUNCHES["column_sum"]
        got, again = cs.column_sum(V3), cs.column_sum(V3)
        assert cs.LAUNCHES["column_sum"] == n0 + 2
        assert got.shape == (shape[0], 1, shape[2])
        assert _held(got, cs.column_sum_plain(V3)) <= 1e-6
        assert torch.equal(got, again)


@pytest.mark.cuda
def test_cuda_column_sum_ragged_and_unaligned():
    """On a card: S4 at a ragged M (5, 37, 1001) and on V 4 bytes past a
    16-byte boundary (a contiguous view of buf[1:]) equals its plain
    version to rel 1e-6 and the aligned launch bit for bit, and repeats
    bit for bit; a non-contiguous V is refused."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(12)
    for shape in [(5, 37, 1001), (3, 128, 9216), (2, 7, 3)]:
        n = math.prod(shape)
        buf = torch.rand(n + 1, generator=gen, device="cuda")
        V3 = buf[1:].view(shape)
        assert V3.is_contiguous() and V3.data_ptr() % 16 == 4
        got, again = cs.column_sum(V3), cs.column_sum(V3)
        assert _held(got, cs.column_sum_plain(V3)) <= 1e-6
        assert torch.equal(got, again)
        assert torch.equal(got, cs.column_sum(V3.clone()))
    with pytest.raises(ValueError, match="contiguous"):
        cs.column_sum(torch.rand((4, 8, 6), device="cuda").transpose(0, 2))


@pytest.mark.cuda
def test_cuda_contract_switches_launch_k4():
    """On a card: ``first_contraction(use_kernels=True)`` and
    ``build_pp_caches(use_kernels_first=True)`` launch K4 for the eligible
    root and agree with the einsum route to rel 1e-4."""
    _cuda_or_skip()
    V, Ws = _first_problem()
    tV = torch.from_numpy(V).cuda()
    tW = [torch.from_numpy(W).cuda() for W in Ws]
    n0 = mc.LAUNCHES["rank_minor"]
    got, _ = tc.first_contraction(tV, tW[0], 0, use_kernels=True)
    want, _ = tc.first_contraction(tV, tW[0], 0, use_kernels=False)
    assert mc.LAUNCHES["rank_minor"] == n0 + 1
    assert _held(got, want) <= 1e-4
    ks, kp = tc.build_pp_caches(tV, tW, use_kernels_first=True)
    ps, pp = tc.build_pp_caches(tV, tW)
    assert mc.LAUNCHES["rank_minor"] == n0 + 2
    for k in pp:
        assert _held(kp[k], pp[k]) <= 1e-4
    for k in ps:
        assert _held(ks[k], ps[k]) <= 1e-4
