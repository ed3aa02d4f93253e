"""The port's chain-root kernel modules (ops/kernels/mid_contract.py, K4 and
K4'; ops/kernels/triple_roots.py, K6), the routes that reach them, and the
dimension-tree repair, against the JAX package on the same numpy inputs.

On the CPU each wrapper takes its plain version, which is held to the JAX
Pallas kernel in interpret mode. JAX's CPU backend has no bf16 x bf16 = f32
dot, so the Pallas ``mid_contract`` cannot run bf16 there; bf16 V is held
to the JAX einsum route it replaces instead (contract._einsum rounds every
operand to bf16 and contracts in f32), which is the same arithmetic. The
``cuda``-marked tests hold the CUDA kernels to the plain versions on a card:

    python -m pytest tests/test_torch_roots.py --noconftest -m cuda
"""

import numpy as np
import pytest
import torch

from pairwise_perturbation_tpu_torch import config
from pairwise_perturbation_tpu_torch.ops import contract as tc, dimtree as td
from pairwise_perturbation_tpu_torch.ops.kernels import last_contract as lc
from pairwise_perturbation_tpu_torch.ops.kernels import mid_contract as mc
from pairwise_perturbation_tpu_torch.ops.kernels import triple_roots as tr

torch.set_num_threads(1)

# The JAX package's mid_contract test shapes (tests/test_pallas_kernels.py)
# and its ragged lane tile.
MID_SHAPES = [((3, 16, 24, 50), 1), ((3, 16, 24, 50), 2), ((3, 16, 24, 50), 0),
              ((16, 24, 50), 0), ((16, 24, 50), 1), ((8, 8, 8, 8, 8, 8), 2),
              ((16, 10, 15), 0)]
TRIPLE_SHAPE = (3, 16, 24, 1200)
# chip_smoke.py TRIPLE_CHECKS: the coil cache build, a ragged column tile,
# and R above one rank chunk.
TRIPLE_CHECKS = [((3, 128, 128, 7200), 10), ((3, 16, 24, 1200), 5),
                 ((3, 64, 64, 2048), 40)]


def _rel(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _jdt(dtype):
    import jax.numpy as jnp
    return {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]


def _layout(rank_minor):
    """The JAX kernel's ``rank_minor`` flag as the port's layout."""
    return "rank_minor" if rank_minor else "rank_major"


def _spy(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def spy(*a, **k):
        calls.append(a)
        return orig(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


@pytest.mark.parametrize("rank_minor", [True, False])
@pytest.mark.parametrize("shape,mode", MID_SHAPES)
def test_mid_contract_plain_matches_pallas_f32(shape, mode, rank_minor):
    """f32, rel max-norm 2e-5 (the JAX kernel test's rtol)."""
    import jax.numpy as jnp
    from pairwise_perturbation_tpu.ops.kernels import mttkrp_pallas
    rng = np.random.default_rng(len(shape) + mode)
    V = rng.standard_normal(shape).astype(np.float32)
    W = rng.standard_normal((shape[mode], 5)).astype(np.float32)
    want = mttkrp_pallas.mid_contract(jnp.asarray(V), jnp.asarray(W), mode,
                                      interpret=True, rank_minor=rank_minor)
    got = mc.mid_contract(torch.from_numpy(V), torch.from_numpy(W), mode,
                          layout=_layout(rank_minor))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 2e-5


@pytest.mark.parametrize("rank_minor", [True, False])
@pytest.mark.parametrize("shape,mode", MID_SHAPES[::2])
def test_mid_contract_plain_bf16(shape, mode, rank_minor):
    """bf16 V: f32 output equal to the JAX bf16 einsum route to 1e-6 (the
    same bf16-rounded products, summed in another order)."""
    import jax.numpy as jnp
    from pairwise_perturbation_tpu.ops import contract as jc
    rng = np.random.default_rng(mode)
    V = rng.standard_normal(shape).astype(np.float32)
    W = rng.standard_normal((shape[mode], 7)).astype(np.float32)
    want, _ = jc.contract_mode_kr(jnp.asarray(V, jnp.bfloat16),
                                  tuple(range(len(shape))), False,
                                  jnp.asarray(W), mode)
    got = mc.mid_contract(torch.tensor(V, dtype=torch.bfloat16),
                          torch.from_numpy(W), mode,
                          layout=_layout(rank_minor))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_triple_roots_plain_matches_pallas(dtype):
    """(3, 16, 24, 1200) R=5: the 1024-lane tile is ragged on the JAX side.
    Rel max-norm 2e-5 per output (up to 1200 terms summed in f32)."""
    import jax.numpy as jnp
    from pairwise_perturbation_tpu.ops.kernels import mttkrp_pallas
    rng = np.random.default_rng(5)
    V = rng.standard_normal(TRIPLE_SHAPE).astype(np.float32)
    Ws = [rng.standard_normal((s, 5)).astype(np.float32)
          for s in TRIPLE_SHAPE[1:]]
    want = mttkrp_pallas.triple_roots(jnp.asarray(V, _jdt(dtype)),
                                      *map(jnp.asarray, Ws), interpret=True)
    got = tr.triple_roots(torch.tensor(V, dtype=dtype),
                          *map(torch.from_numpy, Ws))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert _rel(g, w) <= 2e-5


def test_eligibility_matches_jax():
    """Both predicates equal the JAX package's over a grid of shapes,
    modes, dtypes and ranks, so the port routes the same calls."""
    import jax.numpy as jnp
    from pairwise_perturbation_tpu.ops.kernels import mttkrp_pallas as mp
    dtypes = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
              (torch.float64, jnp.float64)]
    mid_shapes = [(512, 512, 512), (200, 200, 200), (3, 128, 128, 7200),
                  (8, 128, 256), (2, 16, 16, 2048), (16, 4104, 64),
                  (4, 4096, 256), (8, 8200, 4), (12, 3, 40000)]
    n_true = 0
    for shape in mid_shapes:
        for mode in range(-1, len(shape) + 1):
            for t_dt, j_dt in dtypes:
                for r in (1, 10, 256, 257):
                    got = mc.mid_contract_eligible(shape, mode, t_dt, r)
                    assert got == mp.mid_contract_eligible(shape, mode, j_dt,
                                                           r), (shape, mode)
                    n_true += got
    tri_shapes = [(3, 128, 128, 7200), (3, 16, 24, 1200), (3, 16, 24, 1000),
                  (65, 8, 8, 2048), (3, 12, 16, 2048), (3, 520, 8, 2048),
                  (3, 512, 512, 1024), (3, 128, 128), (2, 8, 8, 128, 3)]
    for shape in tri_shapes:
        for t_dt, j_dt in dtypes:
            for r in (5, 128, 129):
                got = tr.triple_roots_eligible(shape, t_dt, r)
                assert got == mp.triple_roots_eligible(shape, j_dt, r), shape
                n_true += got
    assert n_true > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_triple_roots_composed_matches_pallas(dtype):
    """The route a CUDA tensor takes (two rank-outer mid_contract calls
    and last_contract, moved to rank-major), here through the wrappers'
    plain versions: contiguous rank-major outputs equal to the JAX kernel
    in interpret mode at rel 2e-5, as the plain version is."""
    import jax.numpy as jnp
    from pairwise_perturbation_tpu.ops.kernels import mttkrp_pallas
    rng = np.random.default_rng(6)
    V = rng.standard_normal(TRIPLE_SHAPE).astype(np.float32)
    Ws = [rng.standard_normal((s, 5)).astype(np.float32)
          for s in TRIPLE_SHAPE[1:]]
    want = mttkrp_pallas.triple_roots(jnp.asarray(V, _jdt(dtype)),
                                      *map(jnp.asarray, Ws), interpret=True)
    got = tr.composed(torch.tensor(V, dtype=dtype), *map(torch.from_numpy, Ws))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.is_contiguous()
        assert _rel(g, w) <= 2e-5


def test_triple_roots_launch_accounting(monkeypatch):
    """A K6 call on a device tensor is one ``triple_roots`` launch made of
    mid_contract at modes 1 and 2 in the rank-outer layout and one
    last_contract, and never the plain version. Meta tensors stand for
    CUDA ones here: the device check is stubbed, and the inner wrappers
    are spies that run their plain versions, which meta tensors take."""
    mids, lasts = [], []

    def mid(V, W, mode, layout="rank_minor"):
        mids.append((mode, layout))
        return mc.mid_contract_plain(V, W, mode, layout)

    def last(V, W):
        lasts.append(tuple(V.shape))
        return lc.last_contract_plain(V, W)

    def no_plain(*a):
        raise AssertionError("the plain version served a device tensor")

    monkeypatch.setattr(tr, "_check", lambda V, Ws: None)
    monkeypatch.setattr(mc, "mid_contract", mid)
    monkeypatch.setattr(lc, "last_contract", last)
    monkeypatch.setattr(tr, "triple_roots_plain", no_plain)
    P, B1, B2, M, R = 2, 8, 16, 1024, 3
    V = torch.empty((P, B1, B2, M), device="meta")
    Ws = [torch.empty((s, R), device="meta") for s in (B1, B2, M)]
    n0 = tr.LAUNCHES["triple_roots"]
    O1, O2, O3 = tr.triple_roots(V, *Ws)
    assert tr.LAUNCHES["triple_roots"] == n0 + 1
    assert mids == [(1, "rank_outer"), (2, "rank_outer")]
    assert lasts == [(P, B1, B2, M)]
    assert (O1.shape, O2.shape, O3.shape) == ((R, P, B2, M), (R, P, B1, M),
                                              (R, P, B1, B2))


# (P, B, M, R) of mid_contract's mma emulation: whole k and column tiles,
# a ragged B (a last partial k tile) and M (a partial column tile, M % 8
# == 0), R = 40 (three rank chunks), and a small ragged shape.
MID_MMA_CASES = [(2, 32, 128, 10), (2, 40, 200, 10), (1, 32, 128, 40),
                 (3, 17, 72, 5)]


@pytest.mark.parametrize("P,B,M,R", MID_MMA_CASES)
def test_mid_contract_mma_mapping(P, B, M, R):
    """csrc/mid_contract.cu's fragment mapping, emulated over every warp
    tile (mc.emulate_mma through the PTX fragment layouts): every product
    V[p, b, m] W[b, r] is summed exactly once, into out[p, m, r], and no
    product of real elements lands elsewhere; the emulated sums equal the
    plain version to rel 1e-5 (float64 emulation, float32 plain)."""
    rng = np.random.default_rng(P * B * M + R)
    V = torch.from_numpy(rng.random((P, B, M), dtype=np.float32)).bfloat16()
    W = rng.random((B, R), dtype=np.float32)
    out, count, misplaced = mc.emulate_mma(V.double().numpy(), W)
    assert misplaced == 0
    assert count.min() == 1 and count.max() == 1
    assert _rel(torch.from_numpy(out),
                mc.mid_contract_plain(V, torch.from_numpy(W), 1)) <= 1e-5


# (bf16, M, V's offset from a 16-byte boundary) -> path: the tensor cores
# take bf16 V with M % 8 == 0 on a 16-byte boundary; bf16 with M odd, M %
# 8 == 4, 2 or 8 bytes off keep the FMA template; f32 takes the f32v loop
# in the rank-minor layout (None below) and the FMA template in the other
# two.
MID_PATH_CASES = [((True, 921600, 0), "mma"), ((True, 1000, 0), "mma"),
                  ((True, 1001, 0), "fma"), ((True, 1004, 0), "fma"),
                  ((True, 921600, 2), "fma"), ((True, 921600, 8), "fma"),
                  ((False, 921600, 0), None)]


@pytest.mark.parametrize("case,want", MID_PATH_CASES)
@pytest.mark.parametrize("layout", ["rank_minor", "rank_major",
                                    "rank_outer"])
def test_mid_contract_plan_path(case, want, layout):
    """plan() names the path from V's type, M % 8 and V's alignment, in
    every layout; the mma path runs 32 threads per 64 columns, the f32v
    path 128 threads per 512 columns."""
    bf16, M, offset = case
    if want is None:
        want = "f32v" if layout == "rank_minor" else "fma"
    p = mc.plan(3, 128, M, 10, layout, 256, offset, bf16)
    assert p.path == want == mc.path(M, offset, bf16, layout)
    assert p.threads == {"mma": 128, "fma": 256, "f32v": 128}[want]
    assert p.col_tiles == -(-M // (512 if want == "f32v" else 256))


# (P, B, M) of the shared-memory check: the coil view (S3, K6's O1), K6's
# O2 view, and 512^3's mode 0 (K4 in phase 4b).
MID_SMEM_SHAPES = [(3, 128, 921600), (384, 128, 7200), (1, 512, 262144)]


@pytest.mark.parametrize("P,B,M", MID_SMEM_SHAPES)
@pytest.mark.parametrize("R", [10, 40])
def test_mid_contract_plan_smem(P, B, M, R):
    """Every launch's shared memory fits 48 KB: the fma path's staged W
    (64 rows x RC) and rank-minor tile, the mma path's rank-minor tile (64
    columns x 17 a warp), the f32v path's W chunk or output tile (512
    columns x RC), at every layout and block width, f32 and bf16."""
    for layout in mc.LAYOUTS:
        for cols in ((256,) if layout == "rank_minor" else mc.BLOCK_COLS):
            for bf16 in (False, True):
                p = mc.plan(P, B, M, R, layout, cols, 0, bf16)
                assert p.smem <= mc.SMEM_STATIC
                minor = layout == "rank_minor"
                if p.path == "mma":
                    assert (p.rank_chunk, p.threads) == (16, cols // 2)
                    assert p.smem == (cols * 17 * 4 if minor else 0)
                elif p.path == "f32v":
                    assert minor and not bf16
                    rc = p.rank_chunk
                    assert p.smem == 4 * max(
                        p.w_rows * (-(-rc // 4) * 4), 512 * rc)
                else:
                    rc = lc.rank_chunk(R)
                    assert p.smem == 4 * (64 * rc + (cols * (rc + 1)
                                                     if minor else 1))


def test_non_cpu_tensors_without_cuda_raise():
    """A tensor that is not on the CPU takes the kernel path, which refuses
    anything but CUDA operands instead of falling back; a bf16 factor is
    refused by type."""
    V = torch.empty((4, 8, 6), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        mc.mid_contract(V, torch.empty((8, 3), device="meta"), 1)
    with pytest.raises(TypeError, match="float32"):
        mc.mid_contract(V, torch.empty((8, 3), device="meta",
                                       dtype=torch.bfloat16), 1)
    V4 = torch.empty((2, 8, 8, 16), device="meta")
    Ws = [torch.empty((s, 3), device="meta") for s in (8, 8, 16)]
    with pytest.raises(ValueError, match="CUDA"):
        tr.triple_roots(V4, *Ws)
    with pytest.raises(ValueError, match="W2"):
        tr.triple_roots(V4, Ws[0], Ws[2], Ws[2])
    before = (dict(mc.LAUNCHES), dict(tr.LAUNCHES))
    mc.mid_contract(torch.ones((4, 8, 6)), torch.ones((8, 3)), 1)
    tr.triple_roots(torch.ones((2, 8, 8, 16)),
                    *[torch.ones((s, 3)) for s in (8, 8, 16)])
    assert (mc.LAUNCHES, tr.LAUNCHES) == before   # CPU never launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_first_contraction_kernel_route(monkeypatch, dtype):
    """use_kernels_first routes an eligible non-minor mode to the kernel
    module. f32 is held to the JAX interpret-mode route (2e-5); bf16 to the
    JAX einsum route (1e-6); the minor mode never routes."""
    import jax.numpy as jnp
    from pairwise_perturbation_tpu.ops import contract as jc
    shape, R = (2, 16, 16, 2048), 5
    rng = np.random.default_rng(1)
    V = rng.standard_normal(shape).astype(np.float32)
    Ws = [rng.standard_normal((s, R)).astype(np.float32) for s in shape]
    jV = jnp.asarray(V, _jdt(dtype))
    tV = torch.tensor(V, dtype=dtype)
    calls = _spy(monkeypatch, mc, "mid_contract")
    with config.override(use_kernels_first=True):
        got, rem = tc.first_contraction(tV, torch.from_numpy(Ws[1]), 1)
        tc.first_contraction(tV, torch.from_numpy(Ws[3]), 3)
    assert [a[2] for a in calls] == [1]
    if dtype == torch.float32:
        want, jrem = jc.first_contraction(jV, None, jnp.asarray(Ws[1]), 1,
                                          use_pallas=True, interpret=True)
        tol = 2e-5
    else:
        want, jrem = jc.first_contraction(jV, None, jnp.asarray(Ws[1]), 1)
        tol = 1e-6
    assert rem == jrem == (0, 2, 3)
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_build_pp_caches_triple_route(monkeypatch, dtype):
    """use_kernels_triple seeds the memo from one triple_roots call; every
    cache equals the JAX interpret-mode triple route to 3e-5 (the JAX
    test's tolerance)."""
    import jax.numpy as jnp
    from pairwise_perturbation_tpu import config as jconfig
    from pairwise_perturbation_tpu.ops import contract as jc
    R = 4
    rng = np.random.default_rng(2)
    V = rng.standard_normal(TRIPLE_SHAPE).astype(np.float32)
    Ws = [rng.standard_normal((s, R)).astype(np.float32)
          for s in TRIPLE_SHAPE]
    calls = _spy(monkeypatch, tr, "triple_roots")
    with config.override(use_kernels_triple=True):
        ts_, tp = tc.build_pp_caches(torch.tensor(V, dtype=dtype),
                                     [torch.from_numpy(W) for W in Ws])
    assert len(calls) == 1
    with jconfig.override(use_pallas_triple=True):
        js_, jp = jc.build_pp_caches(jnp.asarray(V, _jdt(dtype)),
                                     [jnp.asarray(W) for W in Ws],
                                     interpret=True)
    assert sorted(tp) == sorted(jp)
    for k in jp:
        assert _rel(tp[k], jp[k]) <= 3e-5, k
    for k in js_:
        assert _rel(ts_[k], js_[k]) <= 3e-5, k


def test_dimtree_top_child_goes_through_first_contraction(monkeypatch):
    """The repair of the port's dimension tree: at tree_split 0 on an
    order-3 tensor the top-level child (1, 2) is one mode (0) away from V
    and is built by contract.first_contraction (JAX dimtree.py:104-121),
    which with use_kernels_first reaches the mid_contract module (mode 0
    of (8, 128, 256) is eligible). The leaves equal the JAX tree's to f32
    round-off (rel 1e-5)."""
    import jax.numpy as jnp
    from pairwise_perturbation_tpu.ops import dimtree as jd
    shape, R = (8, 128, 256), 4
    rng = np.random.default_rng(3)
    V = rng.random(shape).astype(np.float32)
    Ws = [rng.random((s, R)).astype(np.float32) for s in shape]
    first = _spy(monkeypatch, tc, "first_contraction")
    kernel = _spy(monkeypatch, mc, "mid_contract")
    jt = jd.BinaryTreeSweep(jnp.asarray(V), [jnp.asarray(W) for W in Ws],
                            root_split=0)
    with config.override(use_kernels_first=True):
        tt = td.BinaryTreeSweep(torch.from_numpy(V),
                                [torch.from_numpy(W) for W in Ws],
                                root_split=0)
        leaves = [tt.mttkrp(i) for i in range(3)]
    assert [a[2] for a in first] == [0]
    assert [a[2] for a in kernel] == [0]
    for i in range(3):
        assert _rel(leaves[i], jt.mttkrp(i)) <= 1e-5


def _low_rank(shape, R, seed, noise=1e-2):
    """A rank-R tensor of Gaussian factors (well-conditioned Grams) with
    ``noise`` relative Gaussian noise."""
    rng = np.random.default_rng(seed)
    Ws = [rng.standard_normal((s, R)) for s in shape]
    letters = "abcd"[:len(shape)]
    V = np.einsum(",".join(c + "z" for c in letters) + "->" + letters, *Ws)
    V = V + noise * np.abs(V).mean() * rng.standard_normal(shape)
    return V.astype(np.float32)


def _jax_init(shape, R):
    import jax
    import jax.numpy as jnp
    from pairwise_perturbation_tpu.models import cp as jcp
    return [np.asarray(W) for W in jcp.init_factors(
        shape, R, key=jax.random.PRNGKey(0), dtype=jnp.float32)]


def _assert_same_history(rj, rt, tol):
    """The same (iter, pp) rows; gradnorm and diffV each within ``tol`` of
    the largest value of the JAX run. Both are differences that cancel
    (M - W S, and the norm identity), and ALS amplifies f32 round-off from
    sweep to sweep, so they are held to the scale of the run: the JAX
    package's own runs move about as far when the initial factors change
    by 1e-7."""
    assert [(h["iter"], h["pp"]) for h in rt.history] == \
        [(h["iter"], h["pp"]) for h in rj.history]
    assert any(h["pp"] for h in rt.history)
    for key in ("gradnorm", "diffV"):
        scale = max(abs(h[key]) for h in rj.history)
        for a, b in zip(rj.history, rt.history):
            assert abs(a[key] - b[key]) <= tol * scale, (key, a, b)


@pytest.mark.parametrize("case", ["first_512_class", "triple_coil_class"])
def test_whole_slice_f32_with_kernel_toggles(monkeypatch, case):
    """10 sweeps of als_cp_pp in f32 with a toggle on against the JAX
    package with both off, from the same numpy tensor and factors: the
    same DT <-> PP history, gradnorm and diffV within 1e-3 of the run's
    scale, and the kernel module reached on every DT sweep or cache
    build."""
    from pairwise_perturbation_tpu.models import cp as jcp
    from pairwise_perturbation_tpu_torch.models import cp as tcp
    from pairwise_perturbation_tpu_torch.utils import interop
    if case == "first_512_class":
        shape, R, toggle, mod, name = ((8, 128, 256), 4, "use_kernels_first",
                                       mc, "mid_contract")
    else:
        shape, R, toggle, mod, name = (TRIPLE_SHAPE, 3, "use_kernels_triple",
                                       tr, "triple_roots")
    V = _low_rank(shape, R, seed=4)
    Ws = _jax_init(shape, R)
    kw = dict(tol=0.0, pp_res_tol=0.1, maxiter=10, resprint=1, tree_split=0)
    rj = jcp.als_cp_pp(V, Ws, jcp.CPConfig(**kw))
    calls = _spy(monkeypatch, mod, name)
    builds = _spy(monkeypatch, tcp, "pp_build_caches")
    sweeps = _spy(monkeypatch, tcp, "dt_sweep")
    with config.override(**{toggle: True}):
        rt = tcp.als_cp_pp(*interop.from_numpy(V, Ws, device="cpu"),
                           tcp.CPConfig(**kw))
    _assert_same_history(rj, rt, 1e-3)
    expected = len(sweeps) if toggle == "use_kernels_first" else len(builds)
    assert len(calls) == expected > 0


def test_als_cp_pp_bf16_matches_jax():
    """Mixed precision on a small order-4 tensor: V stored bf16 (the same
    bits on both sides), factors f32, against the JAX package's bf16 mode
    over 10 sweeps (7 of them PP): the same history, gradnorm and diffV
    within 1e-3 of the run's scale."""
    import jax.numpy as jnp
    from pairwise_perturbation_tpu.models import cp as jcp
    from pairwise_perturbation_tpu_torch.models import cp as tcp
    from pairwise_perturbation_tpu_torch.utils import interop
    shape, R = (4, 10, 12, 14), 3
    V = _low_rank(shape, R, seed=7)
    Ws = _jax_init(shape, R)
    kw = dict(tol=0.0, pp_res_tol=0.1, maxiter=10, resprint=1)
    rj = jcp.als_cp_pp(jnp.asarray(V, jnp.bfloat16),
                       [jnp.asarray(W) for W in Ws], jcp.CPConfig(**kw))
    tV, tW = interop.from_numpy(V, Ws, device="cpu",
                                v_dtype=torch.bfloat16)
    assert tV.dtype == torch.bfloat16 and tW[0].dtype == torch.float32
    rt = tcp.als_cp_pp(tV, tW, tcp.CPConfig(**kw))
    assert rt.factors[0].dtype == torch.float32
    _assert_same_history(rj, rt, 1e-3)


def test_interop_bf16_bits_match_jax():
    import jax.numpy as jnp
    from pairwise_perturbation_tpu_torch.utils import interop
    rng = np.random.default_rng(8)
    V = rng.standard_normal((6, 7, 8)).astype(np.float32) * 1e3
    tV, _ = interop.from_numpy(V, [], device="cpu", v_dtype=torch.bfloat16)
    jbits = np.asarray(jnp.asarray(V, jnp.bfloat16)).view(np.uint16)
    np.testing.assert_array_equal(tV.view(torch.int16).numpy().view(np.uint16),
                                  jbits)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_mid_contract_matches_plain(dtype):
    """On a card: K4 and K4' against the plain version on the same
    (bf16-rounded) operands, rel max-norm 1e-4 (sums of up to 512 exact
    products in another order); each call counts one launch."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(4)
    for shape, mode, R in [((200, 96, 160), 0, 10), ((5, 40, 1000), 1, 7),
                           ((3, 128, 128, 720), 1, 10), ((64, 64, 64), 1, 40)]:
        V = torch.rand(shape, generator=gen, device="cuda").to(dtype)
        W = torch.rand((shape[mode], R), generator=gen, device="cuda")
        want = mc.mid_contract_plain(V, W, mode)
        for key in ("rank_minor", "rank_major"):
            n0 = mc.LAUNCHES[key]
            got = mc.mid_contract(V, W, mode, layout=key)
            torch.cuda.synchronize()
            assert mc.LAUNCHES[key] == n0 + 1
            assert float((got - want).abs().max() / want.abs().max()) <= 1e-4


# (V shape, mode, R, V's offset in elements, path) of mid_contract with
# bf16 V on a card: whole tiles, a ragged B, a partial column tile (M %
# 8 == 0), R = 40, then M odd and V 2 bytes off alignment, which take the
# fma path.
MID_BF16_PATHS = [((3, 128, 1024), 1, 10, 0, "mma"),
                  ((5, 37, 1000), 1, 7, 0, "mma"),
                  ((4, 32, 200), 1, 10, 0, "mma"),
                  ((64, 64, 64), 1, 40, 0, "mma"),
                  ((5, 40, 1001), 1, 7, 0, "fma"),
                  ((3, 128, 1024), 1, 10, 1, "fma")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,mode,R,offset,path", MID_BF16_PATHS)
def test_cuda_mid_contract_bf16_paths(shape, mode, R, offset, path):
    """On a card: mid_contract with bf16 V on the path its plan names, in
    every layout and (rank-major, rank-outer) block width, against the
    plain version on the same bf16-rounded operands, rel 1e-4; two
    launches bit for bit equal, one launch counted each."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(15)
    n = int(np.prod(shape))
    buf = torch.rand(n + offset, generator=gen,
                     device="cuda").to(torch.bfloat16)
    V = buf[offset:].view(shape)
    W = torch.rand((shape[mode], R), generator=gen, device="cuda")
    for layout in mc.LAYOUTS:
        want = mc.mid_contract_plain(V, W, mode, layout=layout)
        for cols in ((256,) if layout == "rank_minor" else mc.BLOCK_COLS):
            assert mc.plan_for(V, R, mode, layout, cols).path == path
            n0 = mc.LAUNCHES[layout]
            got = mc.mid_contract(V, W, mode, layout=layout,
                                  block_cols=cols)
            again = mc.mid_contract(V, W, mode, layout=layout,
                                    block_cols=cols)
            torch.cuda.synchronize()
            assert mc.LAUNCHES[layout] == n0 + 2
            assert float((got - want).abs().max() / want.abs().max()) \
                <= 1e-4
            assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,R", TRIPLE_CHECKS + [((2, 16, 16, 1030), 40)])
def test_cuda_triple_roots_matches_plain(dtype, shape, R):
    """On a card: K6 against the plain version, rel max-norm 1e-4 per
    output (f32 sums of up to 7200 products in other orders), two calls
    bit for bit equal, at every chip_smoke.py check shape and a ragged M;
    each call is one K6 launch of two rank-outer mid_contract launches
    and one last_contract."""
    _cuda_or_skip()
    gen = torch.Generator(device="cuda").manual_seed(5)
    V = torch.rand(shape, generator=gen, device="cuda").to(dtype)
    Ws = [torch.rand((s, R), generator=gen, device="cuda")
          for s in shape[1:]]
    n0 = (tr.LAUNCHES["triple_roots"], mc.LAUNCHES["rank_outer"],
          lc.LAUNCHES["last_contract"])
    got, again = tr.triple_roots(V, *Ws), tr.triple_roots(V, *Ws)
    want = tr.triple_roots_plain(V, *Ws)
    torch.cuda.synchronize()
    assert (tr.LAUNCHES["triple_roots"], mc.LAUNCHES["rank_outer"],
            lc.LAUNCHES["last_contract"]) == (n0[0] + 2, n0[1] + 4, n0[2] + 2)
    for g, a, w in zip(got, again, want):
        assert g.shape == w.shape and g.is_contiguous()
        assert float((g - w).abs().max() / w.abs().max()) <= 1e-4
        assert torch.equal(g, a)
