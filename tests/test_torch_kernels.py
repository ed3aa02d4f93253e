"""The port's fused order-3 MTTKRP module (ops/kernels/mttkrp3.py) against
the JAX package's Pallas kernels, run in interpret mode on the CPU.

The CUDA kernels themselves run only on a card: the ``cuda``-marked test
holds them to the plain version there and skips elsewhere. On the CPU the
module's wrapper takes its plain version, which is what the parity tests
check. JAX is imported inside the tests that use it, so that on a machine
without JAX the ``cuda`` test still runs:

    python -m pytest tests/test_torch_kernels.py --noconftest -m cuda
"""

import numpy as np
import pytest
import torch

from pairwise_perturbation_tpu_torch.ops.kernels import _build, mttkrp3

torch.set_num_threads(1)

SHAPES = [(13, 24, 20), (16, 40, 24), (8, 16, 128)]
RANKS = [1, 5, 10, 17]


def _inputs(shape, R, dtype, seed=0):
    rng = np.random.default_rng(seed)
    V = rng.random(shape).astype(dtype)
    Ws = [rng.random((s, R)).astype(dtype) for s in shape]
    return V, Ws


def _rel_err(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def _pallas_interpret(V, Ws, mode):
    import jax.numpy as jnp
    from pairwise_perturbation_tpu.ops.kernels import mttkrp_pallas
    return np.asarray(mttkrp_pallas.mttkrp3_mode(
        jnp.asarray(V), [jnp.asarray(W) for W in Ws], mode, interpret=True))


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("R", RANKS)
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_matches_pallas_interpret_f32(shape, R, mode):
    """f32 on both sides, different summation orders over <= 3072 terms:
    rel max-norm error 1e-5."""
    V, Ws = _inputs(shape, R, np.float32, seed=R)
    want = _pallas_interpret(V, Ws, mode)
    got = mttkrp3.mttkrp3_mode(torch.from_numpy(V),
                               [torch.from_numpy(W) for W in Ws], mode)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (shape[mode], R)
    assert _rel_err(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_plain_f64_matches_numpy(mode):
    """The Pallas kernels dot in f32 even for f64 inputs, so the f64 plain
    version is held to numpy's einsum instead, at 1e-12."""
    V, Ws = _inputs((13, 24, 20), 5, np.float64)
    specs = {0: "ijk,jr,kr->ir", 1: "ijk,ir,kr->jr", 2: "ijk,ir,jr->kr"}
    want = np.einsum(specs[mode], V, *[W for m, W in enumerate(Ws)
                                       if m != mode])
    got = mttkrp3.mttkrp3_mode(torch.from_numpy(V),
                               [torch.from_numpy(W) for W in Ws], mode)
    assert got.dtype == torch.float64
    assert _rel_err(got.numpy(), want) <= 1e-12


def test_cpu_tensor_never_counts_a_launch():
    V, Ws = _inputs((8, 16, 128), 4, np.float32)
    before = dict(mttkrp3.LAUNCHES)
    for mode in range(3):
        mttkrp3.mttkrp3_mode(torch.from_numpy(V),
                             [torch.from_numpy(W) for W in Ws], mode)
    assert mttkrp3.LAUNCHES == before


def test_non_cpu_tensor_without_cuda_raises():
    """A tensor that is not on the CPU takes the kernel path, which
    refuses anything but CUDA operands instead of falling back."""
    V = torch.empty((4, 5, 6), device="meta")
    Ws = [torch.empty((s, 3), device="meta") for s in (4, 5, 6)]
    with pytest.raises(ValueError, match="CUDA"):
        mttkrp3.mttkrp3_mode(V, Ws, 0)


@pytest.mark.parametrize("bad", ["mode", "factor_shape", "order"])
def test_wrapper_checks_arguments(bad):
    V = torch.empty((4, 5, 6), device="meta")
    Ws = [torch.empty((s, 3), device="meta") for s in (4, 5, 6)]
    mode = 0
    if bad == "mode":
        mode = 3
    elif bad == "factor_shape":
        Ws[1] = torch.empty((7, 3), device="meta")
    else:
        V = torch.empty((4, 5, 6, 2), device="meta")
    with pytest.raises(ValueError):
        mttkrp3.mttkrp3_mode(V, Ws, mode)


MINOR_CASES = [(200, 200, 200, 10, 132), (512, 512, 512, 10, 132),
               (13, 37, 200, 7, 132), (13, 37, 203, 7, 132),
               (1, 1, 5, 3, 132), (96, 96, 96, 40, 8), (96, 96, 96, 40, 132),
               (7, 3, 1000, 1, 1), (20, 20, 100000, 10, 132),
               (200, 200, 200, 33, 132)]
# (I, J, K, R, n_sm, vec): 16-byte loads only where K % 4 == 0
MINOR_PLANS = [c + (vec,) for c in MINOR_CASES for vec in (True, False)
               if not (vec and c[2] % 4)]


@pytest.mark.parametrize("I,J,K,R,n_sm,vec", MINOR_PLANS)
def test_minor_plan_covers_every_fiber_and_k_once(I, J, K, R, n_sm, vec):
    """Mode 2's plan: the slabs partition the I*J fibers, the k chunks
    cover every vector of k once, a block's (rows x kcols) grid fits its
    threads, and the shared memory holds the staged weights and the row
    sums, within what two blocks on an SM may take."""
    p = mttkrp3.minor_plan(I, J, K, R, n_sm, vec)
    n = I * J
    assert p.n_slabs >= 1 and p.slab_len >= 1
    assert (p.n_slabs - 1) * p.slab_len < n <= p.n_slabs * p.slab_len
    kv = -(-K // p.vec)
    assert (p.k_chunks - 1) * p.kcols < kv <= p.k_chunks * p.kcols
    assert p.rows * p.kcols <= p.threads <= mttkrp3.THREADS
    assert p.threads % 32 == 0 and p.rows * p.kcols > p.threads - 32
    assert p.rank_chunk == mttkrp3.rank_chunk(R) and p.rank_chunk >= min(R, 32)
    assert 1 <= p.stage <= p.slab_len
    assert p.smem == 4 * p.rank_chunk * max(p.stage, p.threads)
    assert p.smem <= mttkrp3.STAGE_BYTES


@pytest.mark.parametrize("I,J,K,R,n_sm,vec", MINOR_PLANS)
def test_minor_plan_scratch_is_a_small_share_of_v(I, J, K, R, n_sm, vec):
    """The (n_slabs, K, R) partials take at most SCRATCH_SHARE of V's
    bytes, or one slab's where V has fewer fibers than that allows."""
    p = mttkrp3.minor_plan(I, J, K, R, n_sm, vec)
    assert p.n_slabs * K * R <= max(mttkrp3.SCRATCH_SHARE * I * J * K,
                                    K * R)


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("size", [200, 512])
def test_minor_plan_fills_the_card_at_the_main_shapes(size, vec):
    """At 200^3 and 512^3, rank 10, on 132 SMs: at least two blocks per
    SM, with 16-byte loads or scalar ones."""
    p = mttkrp3.minor_plan(size, size, size, 10, 132, vec)
    assert p.n_slabs * p.k_chunks >= 2 * 132
    assert p.vec == (4 if vec else 1)
    assert p.n_slabs * size * 10 <= 0.04 * size ** 3


ROWS_CASES = [(200, 200, 200, 10, 132), (512, 512, 512, 10, 132),
              (13, 37, 200, 7, 132), (37, 13, 203, 7, 132),
              (1, 1, 5, 3, 132), (96, 96, 96, 40, 8), (3, 5000, 64, 10, 132),
              (5000, 3, 64, 10, 132), (20, 20, 100000, 10, 132),
              (200, 6000, 200, 33, 132), (600, 4096, 64, 10, 132)]
# (nx, ny, K, R, n_sm, vec): 16-byte loads only where K % 4 == 0
ROWS_PLANS = [c + (vec,) for c in ROWS_CASES for vec in (True, False)
              if not (vec and c[2] % 4)]


@pytest.mark.parametrize("nx,ny,K,R,n_sm,vec", ROWS_PLANS)
def test_rows_plan_covers_every_fiber_and_k_once(nx, ny, K, R, n_sm, vec):
    """The rows kernel's plan: the parts partition each output row's ny
    fibers, the k steps cover every vector of k once, a block's (rows x
    kcols) grid fits its threads, and the staged weights fit the shared
    memory that two blocks on an SM may take."""
    p = mttkrp3.rows_plan(nx, ny, K, R, n_sm, vec)
    assert p.parts >= 1 and p.part_len >= 1
    assert (p.parts - 1) * p.part_len < ny <= p.parts * p.part_len
    kv = -(-K // p.vec)
    assert (p.k_chunks - 1) * p.kcols < kv <= p.k_chunks * p.kcols
    assert p.rows * p.kcols <= p.threads <= mttkrp3.THREADS
    assert p.threads % 32 == 0 and p.rows * p.kcols > p.threads - 32
    assert p.rank_chunk == mttkrp3.rank_chunk(R)
    assert p.smem == 4 * p.rank_chunk * max(p.part_len, p.threads // 32)
    assert p.smem <= mttkrp3.STAGE_BYTES
    # the (parts, nx, R) partials are a small share of V's bytes
    assert p.parts * nx * R <= max(0.04 * nx * ny * K, nx * R)


@pytest.mark.parametrize("vec", [True, False])
@pytest.mark.parametrize("size", [200, 512])
def test_rows_plan_fills_the_card_at_the_main_shapes(size, vec):
    """At 200^3 and 512^3, rank 10, on 132 SMs: at least two blocks (one
    per output row and part) per SM."""
    p = mttkrp3.rows_plan(size, size, size, 10, 132, vec)
    assert size * p.parts >= 2 * 132
    assert p.vec == (4 if vec else 1)


def test_plan_of_each_mode_and_its_load_width():
    """``plan`` gives the rows plan of modes 0 (rows i, fibers j) and 1
    (rows j, fibers i) and mode 2's plan, and ``can_vec`` asks for 16-byte
    loads only for K % 4 == 0 and a 16-byte aligned V."""
    assert mttkrp3.plan((30, 500, 64), 10, 0, 132, True) == \
        mttkrp3.rows_plan(30, 500, 64, 10, 132, True)
    assert mttkrp3.plan((30, 500, 64), 10, 1, 132, True) == \
        mttkrp3.rows_plan(500, 30, 64, 10, 132, True)
    assert mttkrp3.plan((200, 200, 200), 10, 2, 132, True) == \
        mttkrp3.minor_plan(200, 200, 200, 10, 132, True)
    buf = torch.zeros(200 * 200 * 200 + 1)
    assert mttkrp3.can_vec(buf[:-1].view(200, 200, 200))
    assert not mttkrp3.can_vec(buf[1:].view(200, 200, 200))
    assert not mttkrp3.can_vec(torch.zeros(13, 37, 203))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """Without the CUDA toolkit the build raises a clear error; there is
    no fallback."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_lib", None)
    assert _build.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()


def test_library_name_follows_sources(monkeypatch):
    """An edited source or flag set gets a new library name, so a stale
    build is never loaded."""
    a = _build.library_path()
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-G"])
    assert _build.library_path() != a


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_cuda_kernel_matches_plain(mode):
    """On a card: the CUDA kernel against the plain version, f32, rel
    max-norm 1e-4 (different summation orders over up to 40,000 terms),
    and two launches equal bit for bit; at 16-byte loads, a ragged K and a
    V 4 bytes off 16-byte alignment (scalar loads), and R above one rank
    chunk. Each call counts exactly one launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(mode)
    for (I, J, K, R, offset) in [(200, 200, 200, 10, 0), (13, 37, 200, 7, 0),
                                 (13, 37, 203, 7, 0), (96, 96, 96, 40, 0),
                                 (40, 50, 64, 10, 1)]:
        buf = torch.rand(I * J * K + offset, generator=gen, device="cuda")
        V = buf[offset:].view(I, J, K)
        assert mttkrp3.can_vec(V) == (K % 4 == 0 and offset == 0)
        Ws = [torch.rand((s, R), generator=gen, device="cuda")
              for s in (I, J, K)]
        n0 = mttkrp3.LAUNCHES[mode]
        got = mttkrp3.mttkrp3_mode(V, Ws, mode)
        again = mttkrp3.mttkrp3_mode(V, Ws, mode)
        want = mttkrp3.mttkrp3_mode_plain(V, Ws, mode)
        torch.cuda.synchronize()
        assert mttkrp3.LAUNCHES[mode] == n0 + 2
        assert torch.equal(got, again), (I, J, K, R, offset)
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= 1e-4, (I, J, K, R, offset, err)


@pytest.mark.cuda
def test_cuda_plans_of_one_instance_in_turns():
    """On a card: modes 0 and 1 of one V share a kernel instance with
    plans of different shared memory; launched in turns, with mode 2 and
    another shape between them, each stays held to the plain version (rel
    1e-4) and to its own first result bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(3)
    cases = []
    for shape in [(40, 50, 60), (60, 40, 200)]:
        V = torch.rand(shape, generator=gen, device="cuda")
        Ws = [torch.rand((s, 5), generator=gen, device="cuda") for s in shape]
        cases.append((V, Ws))
    first = {}
    for _ in range(2):
        for c, (V, Ws) in enumerate(cases):
            for mode in range(3):
                got = mttkrp3.mttkrp3_mode(V, Ws, mode)
                want = mttkrp3.mttkrp3_mode_plain(V, Ws, mode)
                torch.cuda.synchronize()
                err = float((got - want).abs().max() / want.abs().max())
                assert err <= 1e-4, (c, mode, err)
                assert torch.equal(first.setdefault((c, mode), got), got)


@pytest.mark.cuda
@pytest.mark.parametrize("solver", ["chol", "auto"])
def test_cuda_sweep_and_diagnostics_with_cholesky_factors(solver):
    """On a card: a plain ALS sweep with the Cholesky solvers, then the
    exact diagnostics, both through contract.mttkrp. Whatever layout the
    solves leave the factors in, the sweep launches each mode's kernel
    once and the diagnostics agree with the einsum route on the same
    factors (rel 1e-4, f32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pairwise_perturbation_tpu_torch import config
    from pairwise_perturbation_tpu_torch.models import cp
    from pairwise_perturbation_tpu_torch.ops import contract
    gen = torch.Generator(device="cuda").manual_seed(1)
    shape = (40, 50, 60)
    V = torch.rand(shape, generator=gen, device="cuda")
    Ws = cp.init_factors(shape, 5, seed=1, device="cuda")
    n0 = dict(mttkrp3.LAUNCHES)
    Ws, _ = cp.simple_sweep(V, Ws, 0.0, solver=solver)
    torch.cuda.synchronize()
    assert {m: mttkrp3.LAUNCHES[m] - n0[m] for m in range(3)} == \
        {0: 1, 1: 1, 2: 1}
    assert all(bool(torch.isfinite(W).all()) for W in Ws)
    Ws = [W.T.contiguous().T for W in Ws]
    V_norm_sq = contract.norm_sq(V)
    gn, diffV = cp.cp_diagnostics(V_norm_sq, V, Ws)
    with config.override(use_kernels=False):
        gn_ref, diffV_ref = cp.cp_diagnostics(V_norm_sq, V, Ws)
        M_norm = sum(float(contract.norm_sq(contract.mttkrp(V, Ws, m)))
                     for m in range(3)) ** 0.5
    # both are differences that cancel (gradient M - W S, and the norm
    # identity), so each is held to the scale of its operands
    assert abs(float(gn) - float(gn_ref)) <= 1e-4 * M_norm
    assert abs(float(diffV) - float(diffV_ref)) <= \
        1e-4 * float(V_norm_sq) ** 0.5
