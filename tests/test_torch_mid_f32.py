"""K4 with float32 V on its own loop (ops/kernels/mid_contract.py, path
"f32v"; csrc/mid_contract.cu ``mid_contract_f32v_kernel``): where the plan
sends it, its shared memory, and its tiling walked in numpy, against the
plain version and the JAX Pallas kernel in interpret mode. The ``cuda``
tests hold the kernel to the plain version on a card:

    python -m pytest tests/test_torch_mid_f32.py --noconftest -m cuda
"""

import numpy as np
import pytest
import torch

from pairwise_perturbation_tpu_torch.ops.kernels import mid_contract as mc

torch.set_num_threads(1)

# (P, B, M, R, V's offset from a 16-byte boundary in bytes, bf16, layout)
# -> path: f32 V in the rank-minor layout with M % 4 == 0 at a 16-byte
# boundary takes the f32v loop (512^3 mode 0, a ragged column tile, R 40,
# B up to 4096); a ragged M (M % 4 != 0), V 4, 8 or 12 bytes off, the
# other layouts keep the FMA template; bf16 is unchanged.
PATH_CASES = [
    ((1, 512, 262144, 10, 0, False, "rank_minor"), "f32v"),
    ((3, 128, 921600, 10, 0, False, "rank_minor"), "f32v"),
    ((5, 40, 1000, 7, 0, False, "rank_minor"), "f32v"),
    ((200, 200, 200, 40, 0, False, "rank_minor"), "f32v"),
    ((1, 4096, 1024, 10, 0, False, "rank_minor"), "f32v"),
    ((1, 4096, 1024, 256, 0, False, "rank_minor"), "f32v"),
    ((5, 40, 1001, 7, 0, False, "rank_minor"), "fma"),
    ((5, 40, 1002, 7, 0, False, "rank_minor"), "fma"),
    ((1, 512, 262144, 10, 4, False, "rank_minor"), "fma"),
    ((1, 512, 262144, 10, 8, False, "rank_minor"), "fma"),
    ((1, 512, 262144, 10, 12, False, "rank_minor"), "fma"),
    ((1, 512, 262144, 10, 0, False, "rank_major"), "fma"),
    ((3, 128, 921600, 10, 0, False, "rank_outer"), "fma"),
    ((1, 512, 262144, 10, 0, True, "rank_minor"), "mma"),
    ((5, 40, 1001, 7, 0, True, "rank_minor"), "fma"),
]


@pytest.mark.parametrize("case,want", PATH_CASES)
def test_f32v_plan_path(case, want):
    """plan() picks f32v exactly where its preconditions hold; the f32v
    launch has 128 threads of 4 columns, the chunk of ranks R (up to 16)
    or R in ceil(R / 16) near-equal chunks, and W's rows in whole pairs of
    load groups."""
    P, B, M, R, offset, bf16, layout = case
    p = mc.plan(P, B, M, R, layout, 256, offset, bf16)
    assert p.path == want == mc.path(M, offset, bf16, layout)
    if want != "f32v":
        return
    n_chunks = -(-R // 16)
    assert (p.threads, p.col_tiles) == (128, -(-M // 512))
    assert p.rank_chunk <= 16 and n_chunks * p.rank_chunk >= R
    assert -(-R // p.rank_chunk) == n_chunks
    assert p.rank_chunk == R or R > 16
    assert p.w_rows % 8 == 0 and 0 < p.w_rows


def test_f32v_plan_smem_over_admitted_shapes():
    """Over every B and R that mid_contract_eligible admits (B a multiple
    of 8 up to 4096, R up to 256): the f32v launch's dynamic shared memory
    (W's chunk at its float4 row stride, or the 512-column output tile) is
    at most 48 KB, so it needs no opt-in (and stays far under the 227 KB
    a block may take); W is staged whole wherever B x stride fits 48 KB,
    else in ceil(B / w_rows) chunks."""
    for B in range(8, 4097, 8):
        for R in (1, 3, 7, 10, 12, 16, 17, 40, 64, 100, 256):
            p = mc.plan(1, B, 262144, R)
            assert p.path == "f32v"
            stride = -(-p.rank_chunk // 4) * 4  # whole float4s
            assert p.smem == 4 * max(p.w_rows * stride, 512 * p.rank_chunk)
            assert p.smem <= mc.SMEM_STATIC < 227 * 1024
            if 4 * -(-B // 8) * 8 * stride <= mc.SMEM_STATIC:
                assert p.w_rows == -(-B // 8) * 8      # staged once
            else:
                assert p.w_rows < B
                assert 4 * (p.w_rows + 8) * stride > mc.SMEM_STATIC
    # 512^3 mode 0 at R 10: W whole (512 x 12 floats), one pass, no padding
    assert mc.plan(1, 512, 262144, 10)[1:] == (128, 512, 10, 24576, 512)


# (P, B, M, R) of the f32v emulation: a ragged column tile and B not a
# multiple of 8 (a last partial load group), R 40 (3 chunks of 14, the
# last padded), R 16 with B 800 (W in two chunks), a single tile of a few
# columns, and R 1 and 3 (a float, and a float2 + float, a row of W).
EMULATION_CASES = [(2, 17, 1000, 10), (2, 24, 12, 40), (1, 800, 8, 16),
                   (3, 5, 2048, 3), (1, 9, 516, 1), (2, 16, 36, 7)]


@pytest.mark.parametrize("P,B,M,R", EMULATION_CASES)
def test_f32v_tiling_sums_each_product_once(P, B, M, R):
    """csrc/mid_contract.cu's f32v tiling, walked block by block in numpy
    (mc.emulate_f32v): every product V[p, b, m] W[b, r] is summed exactly
    once, into out[p, m, r], and no product of real elements lands
    anywhere else; the emulated sums equal the plain version to rel
    1e-5 (float64 emulation, float32 plain)."""
    rng = np.random.default_rng(P * B * M + R)
    V = rng.random((P, B, M), dtype=np.float32)
    W = rng.random((B, R), dtype=np.float32)
    out, count, misplaced = mc.emulate_f32v(V.astype(np.float64),
                                            W.astype(np.float64))
    assert misplaced == 0
    assert count.min() == 1 and count.max() == 1
    want = mc.mid_contract_plain(torch.from_numpy(V), torch.from_numpy(W), 1)
    assert np.max(np.abs(out - want.numpy())) / float(want.abs().max()) \
        <= 1e-5


@pytest.mark.parametrize("shape,mode,R", [((16, 24, 52), 0, 10),
                                          ((3, 16, 24, 50), 1, 7),
                                          ((4, 40, 36), 1, 40)])
def test_f32v_class_shapes_match_pallas(shape, mode, R):
    """At shapes the f32v path takes on a card, the port's mid_contract on
    the CPU (its plain version) and the emulated f32v tiling both match
    the JAX mid_contract in Pallas interpret mode, rel 2e-5 (the JAX
    kernel test's rtol)."""
    import jax.numpy as jnp
    from pairwise_perturbation_tpu.ops.kernels import mttkrp_pallas
    rng = np.random.default_rng(R)
    V = rng.standard_normal(shape).astype(np.float32)
    W = rng.standard_normal((shape[mode], R)).astype(np.float32)
    P = int(np.prod(shape[:mode]))
    M = V.size // (P * shape[mode])
    assert mc.plan(P, shape[mode], M, R).path == "f32v"
    want = np.asarray(mttkrp_pallas.mid_contract(
        jnp.asarray(V), jnp.asarray(W), mode, interpret=True,
        rank_minor=True), np.float64)
    got = mc.mid_contract(torch.from_numpy(V), torch.from_numpy(W), mode)
    scale = np.max(np.abs(want))
    assert np.max(np.abs(got.numpy() - want)) / scale <= 2e-5
    emulated, _, misplaced = mc.emulate_f32v(
        V.reshape(P, shape[mode], M).astype(np.float64), W.astype(np.float64))
    assert misplaced == 0
    assert np.max(np.abs(emulated.reshape(want.shape) - want)) / scale <= 2e-5


# (V shape, mode, R, V's offset in floats, path) on a card: chip_smoke.py's
# MID_CHECKS (512^3 mode 0, the coil view, a ragged column tile, R 40),
# then V 4 bytes off a 16-byte boundary and a ragged M, which keep the FMA
# template, and B 4096 with R 16 (W staged in chunks).
CUDA_CASES = [((512, 512, 512), 0, 10, 0, "f32v"),
              ((3, 128, 128, 7200), 1, 10, 0, "f32v"),
              ((5, 40, 1000), 1, 7, 0, "f32v"),
              ((200, 200, 200), 1, 40, 0, "f32v"),
              ((512, 512, 512), 0, 10, 1, "fma"),
              ((5, 40, 1001), 1, 7, 0, "fma"),
              ((2, 4096, 1028), 1, 16, 0, "f32v")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,mode,R,offset,path", CUDA_CASES)
def test_cuda_mid_contract_f32_paths(shape, mode, R, offset, path):
    """On a card: K4 in f32 on the path its plan names, against the plain
    version, rel max-norm 1e-4 (f32 sums of up to 4096 products in another
    order); two launches bit for bit equal, each counted once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(13)
    n = int(np.prod(shape))
    V = torch.rand(n + offset, generator=gen, device="cuda")[offset:] \
        .view(shape)
    W = torch.rand((shape[mode], R), generator=gen, device="cuda")
    assert mc.plan_for(V, R, mode).path == path
    want = mc.mid_contract_plain(V, W, mode)
    n0 = mc.LAUNCHES["rank_minor"]
    got, again = mc.mid_contract(V, W, mode), mc.mid_contract(V, W, mode)
    torch.cuda.synchronize()
    assert mc.LAUNCHES["rank_minor"] == n0 + 2
    assert got.shape == want.shape
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4
    assert torch.equal(got, again)
