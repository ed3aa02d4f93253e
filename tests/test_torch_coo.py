"""The port's COO MTTKRP module (ops/kernels/coo_mttkrp.py, K7) against the
JAX package's Pallas kernel (coo_pallas.coo_mttkrp), run in interpret
mode on the CPU, plus the kernel's setup (sort and chunk plan) and build.

The CUDA kernel itself runs only on a card: the ``cuda``-marked tests
hold it to the plain version there and skip elsewhere. JAX is imported
inside the tests that use it, so that on a machine without JAX the
``cuda`` tests still run:

    python -m pytest tests/test_torch_coo.py --noconftest -m cuda
"""

import os
import stat
import sys

import numpy as np
import pytest
import torch

from pairwise_perturbation_tpu_torch import config
from pairwise_perturbation_tpu_torch.ops import sparse
from pairwise_perturbation_tpu_torch.ops.kernels import _build, coo_mttkrp

torch.set_num_threads(1)

# (shape, R, nnz) of tests/test_pallas_kernels.py:199-233.
PALLAS_CASES = [((37, 50, 29, 61), 5, 3000), ((20, 31, 17), 4, 777)]


def _coo(shape, R, nnz, seed=0, dtype=np.float32):
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.integers(0, s, nnz) for s in shape],
                   1).astype(np.int32)
    vals = rng.standard_normal(nnz).astype(dtype)
    Ws = [rng.standard_normal((s, R)).astype(dtype) for s in shape]
    return idx, vals, Ws


def _emulate(p, st, Ws, mode):
    """The kernel's two passes in numpy, from its plan: one partial per
    chunk, then each row's partials in order."""
    R = Ws[0].shape[1]
    prod = p.values.numpy()[:, None].astype(np.float64) * np.ones((1, R))
    for j in range(st.ndim):
        if j != mode:
            prod = prod * Ws[j].numpy()[p.idxT[j].numpy()]
    cp, rcp = p.chunk_ptr.numpy(), p.row_chunk_ptr.numpy()
    partial = np.stack([prod[cp[c]:cp[c + 1]].sum(0)
                        for c in range(len(cp) - 1)])
    return np.stack([partial[rcp[r]:rcp[r + 1]].sum(0)
                     for r in range(st.shape[mode])])


@pytest.mark.parametrize("case,mode", [(c, m) for c, (shape, _, _) in
                                       enumerate(PALLAS_CASES)
                                       for m in range(len(shape))])
def test_plain_matches_pallas_interpret(case, mode):
    """f32, JAX's own tolerance for its kernel (rtol 2e-4, atol 1e-3)."""
    import jax.numpy as jnp
    from pairwise_perturbation_tpu.ops.kernels import coo_pallas
    shape, R, nnz = PALLAS_CASES[case]
    idx, vals, Ws = _coo(shape, R, nnz, seed=case)
    want = np.asarray(coo_pallas.coo_mttkrp(
        jnp.asarray(idx), jnp.asarray(vals), [jnp.asarray(W) for W in Ws],
        mode, block=512, interpret=True))
    st = sparse.SparseTensor(torch.from_numpy(idx), torch.from_numpy(vals),
                             shape)
    got = coo_mttkrp.coo_mttkrp_plain(st, [torch.from_numpy(W) for W in Ws],
                                      mode)
    assert got.dtype == torch.float32
    assert tuple(got.shape) == (shape[mode], R)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=1e-3)


def _check_plan(counts, chunk):
    counts = torch.tensor(counts, dtype=torch.int64)
    chunk_ptr, row_chunk_ptr = coo_mttkrp.chunk_plan(counts, chunk)
    nnz = int(counts.sum())
    row_ptr = np.concatenate([[0], np.cumsum(counts.numpy())])
    cp, rcp = chunk_ptr.numpy(), row_chunk_ptr.numpy()
    # every nonzero lies in exactly one chunk of at most `chunk`
    assert cp[0] == 0 and cp[-1] == nnz
    assert np.all(np.diff(cp) >= 1) and np.all(np.diff(cp) <= chunk)
    # row r's chunks tile exactly its nonzeros: none crosses a row
    assert rcp[0] == 0 and rcp[-1] == len(cp) - 1
    for r in range(len(counts)):
        c0, c1 = rcp[r], rcp[r + 1]
        assert c1 - c0 == -(-int(counts[r]) // chunk)  # none for empty rows
        if c1 > c0:
            assert cp[c0] == row_ptr[r] and cp[c1] == row_ptr[r + 1]


@pytest.mark.parametrize("counts,chunk", [
    ([3], 256), ([0, 3, 600, 0, 256, 257, 0], 256), ([0, 0, 1], 1),
    ([512], 256), ([1000, 0, 0, 0, 7], 32), ([5, 5, 5, 5], 256)])
def test_chunk_plan_tiles_rows(counts, chunk):
    _check_plan(counts, chunk)


def test_chunk_plan_random_rows():
    rng = np.random.default_rng(4)
    for chunk in (1, 7, 256):
        counts = rng.integers(0, 700, 50) * (rng.random(50) < 0.6)
        _check_plan(counts.tolist(), chunk)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_plan_sorts_stably_and_two_passes_give_mttkrp(mode):
    """The sorted copy keeps the nonzeros of a row in their COO order,
    and the kernel's two passes (emulated from the plan) are the MTTKRP,
    with duplicates summed and empty rows zero."""
    shape, R = (9, 40, 6), 3
    idx, vals, Ws = _coo(shape, R, 500, seed=mode, dtype=np.float64)
    idx[:, 1] = np.minimum(idx[:, 1], 20)      # rows 21..39 of mode 1 empty
    idx[7] = idx[3]                            # a duplicate coordinate
    st = sparse.SparseTensor(torch.from_numpy(idx).long(),
                             torch.from_numpy(vals), shape)
    tW = [torch.from_numpy(W) for W in Ws]
    p = coo_mttkrp.plan(st, mode)
    assert coo_mttkrp.plan(st, mode) is p and st.plans[mode] is p
    assert p.idxT.dtype == torch.int32 and p.idxT.is_contiguous()
    order = np.argsort(idx[:, mode], kind="stable")
    np.testing.assert_array_equal(p.idxT.numpy(), idx[order].T)
    np.testing.assert_array_equal(p.values.numpy(), vals[order])
    want = coo_mttkrp.coo_mttkrp_plain(st, tW, mode)
    np.testing.assert_allclose(_emulate(p, st, tW, mode), want.numpy(),
                               rtol=1e-12, atol=1e-12)
    if mode == 1:
        assert not want[21:].any()


def test_plan_rejects_out_of_range_indices():
    idx, vals, _ = _coo((4, 5, 6), 2, 30)
    idx[3, 2] = 6
    st = sparse.SparseTensor(torch.from_numpy(idx), torch.from_numpy(vals),
                             (4, 5, 6))
    with pytest.raises(ValueError, match="out of range"):
        coo_mttkrp.plan(st, 0)


def test_plain_accumulates_in_f64():
    """One row of 20000 f32 products: the plain version's sum is the
    float64 sum rounded once, as no float32 accumulator gives it."""
    rng = np.random.default_rng(1)
    n = 20000
    vals = rng.random(n).astype(np.float32)
    W = [rng.random((1, 2)).astype(np.float32),
         rng.random((3, 2)).astype(np.float32)]
    idx = np.stack([np.zeros(n), rng.integers(0, 3, n)], 1).astype(np.int32)
    st = sparse.SparseTensor(torch.from_numpy(idx), torch.from_numpy(vals),
                             (1, 3))
    got = coo_mttkrp.coo_mttkrp_plain(st, [torch.from_numpy(w) for w in W], 0)
    prod = vals[:, None] * W[1][idx[:, 1]]            # f32 products
    want = prod.astype(np.float64).sum(0).astype(np.float32)
    np.testing.assert_array_equal(got.numpy()[0], want)


def test_cpu_tensor_takes_plain_and_counts_no_launch():
    idx, vals, Ws = _coo((6, 7, 8), 3, 100)
    st = sparse.SparseTensor(torch.from_numpy(idx), torch.from_numpy(vals),
                             (6, 7, 8))
    tW = [torch.from_numpy(W) for W in Ws]
    before = dict(coo_mttkrp.LAUNCHES)
    for mode in range(3):
        got = coo_mttkrp.coo_mttkrp(st, tW, mode)
        want = coo_mttkrp.coo_mttkrp_plain(st, tW, mode)
        assert torch.equal(got, want)
        assert torch.equal(sparse.mttkrp(st, tW, mode), want)
    assert coo_mttkrp.LAUNCHES == before
    assert not st.plans                  # the CPU route builds no plan


def _meta(shape, R, nnz):
    st = sparse.SparseTensor(
        torch.empty((nnz, len(shape)), dtype=torch.int32, device="meta"),
        torch.empty((nnz,), device="meta"), shape)
    return st, [torch.empty((s, R), device="meta") for s in shape]


def test_non_cpu_tensor_without_cuda_raises():
    """A tensor that is not on the CPU takes the kernel path, which
    refuses anything but CUDA operands instead of falling back."""
    st, Ws = _meta((4, 5, 6), 3, 10)
    with pytest.raises(ValueError, match="CUDA"):
        coo_mttkrp.coo_mttkrp(st, Ws, 0)


@pytest.mark.parametrize("bad", ["mode", "factor_shape", "nnz", "order"])
def test_wrapper_checks_arguments(bad):
    shape, mode = (4, 5, 6), 0
    st, Ws = _meta(shape, 3, 10)
    if bad == "mode":
        mode = 3
    elif bad == "factor_shape":
        Ws[1] = torch.empty((7, 3), device="meta")
    elif bad == "nnz":
        st, Ws = _meta(shape, 3, 0)
    else:
        st, Ws = _meta((2,) * 17, 3, 10)
    with pytest.raises(ValueError):
        coo_mttkrp.coo_mttkrp(st, Ws, mode)


@pytest.mark.parametrize("use_kernels", [True, False])
def test_sparse_mttkrp_routes_by_use_kernels(use_kernels):
    """sparse.mttkrp sends float32 to the kernel module under use_kernels
    (on the CPU its plain version, float64 sums) and everything else to
    the engine's own gather + float32 index_add_; the routes agree."""
    idx, vals, Ws = _coo((6, 7, 8), 3, 400)
    st = sparse.SparseTensor(torch.from_numpy(idx), torch.from_numpy(vals),
                             (6, 7, 8))
    tW = [torch.from_numpy(W) for W in Ws]
    plain = coo_mttkrp.coo_mttkrp_plain(st, tW, 2)
    engine = sparse._scatter_rows(sparse._gathered_kr(st, tW, (2,)),
                                  st.indices[:, 2], 8)
    with config.override(use_kernels=use_kernels):
        got = sparse.mttkrp(st, tW, 2)
        st64 = sparse.SparseTensor(st.indices, st.values.double(), st.shape)
        got64 = sparse.mttkrp(st64, [W.double() for W in tW], 2)
    assert torch.equal(got, plain if use_kernels else engine)
    torch.testing.assert_close(plain, engine, rtol=1e-5, atol=1e-5)
    assert got64.dtype == torch.float64
    torch.testing.assert_close(got64, plain.double(), rtol=1e-5, atol=1e-5)


def test_smem_bytes_cap():
    assert coo_mttkrp.smem_bytes((200,) * 4, 10, 0) == 3 * 200 * 10 * 4
    assert coo_mttkrp.smem_bytes((12092, 9184, 28818), 10, 0) == 0
    # every factor but the mode's: 2905 rows of 40 bytes fit, 2906 not
    assert coo_mttkrp.smem_bytes((2904, 7, 1), 10, 1) == 116200
    assert coo_mttkrp.smem_bytes((2905, 7, 1), 10, 1) == 0


def test_build_runs_one_nvcc_per_source_then_links(monkeypatch, tmp_path):
    """The build starts one compiler process per source, all before it
    waits for any, then links the objects into the library."""
    log = tmp_path / "calls.log"
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import sys\n"
        f"open({str(log)!r}, 'a').write(' '.join(sys.argv[1:]) + '\\n')\n"
        "out = sys.argv[sys.argv.index('-o') + 1]\n"
        "open(out, 'w').write('x')\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path / "kernels")
    out = _build.build()
    assert out.exists() and out.parent == tmp_path / "kernels"
    calls = log.read_text().splitlines()
    sources = sorted(p.name for p in _build._CSRC.glob("*.cu"))
    assert "coo_mttkrp.cu" in sources
    compiles = [c for c in calls if " -c " in f" {c} "]
    assert sorted(os.path.basename(c.split(" -c ")[1].split()[0])
                  for c in compiles) == sources
    assert calls[-1].startswith("-shared -o ")
    assert len(calls) == len(sources) + 1
    assert os.listdir(tmp_path / "kernels") == [out.name]  # no objects left


@pytest.mark.cuda
@pytest.mark.parametrize("shape,R,nnz", [
    ((200, 200, 200, 200), 10, 200_000), ((37, 50, 29, 61), 5, 3000),
    ((20, 31, 17), 4, 777), ((50, 60, 70), 40, 20_000),
    ((3000, 20, 30), 7, 5000)])
def test_cuda_kernel_matches_plain_and_repeats(shape, R, nnz):
    """On a card: every mode against the plain version (float64 sums), rel
    max-norm 1e-4; two launches agree bit for bit; each call counts one
    launch. (3000, 20, 30) leaves most mode-0 rows empty."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    idx, vals, Ws = _coo(shape, R, nnz, seed=R)
    st = sparse.SparseTensor(torch.from_numpy(idx).cuda(),
                             torch.from_numpy(vals).cuda(), shape)
    tW = [torch.from_numpy(W).cuda() for W in Ws]
    for mode in range(len(shape)):
        n0 = coo_mttkrp.LAUNCHES["coo_mttkrp"]
        got = coo_mttkrp.coo_mttkrp(st, tW, mode)
        again = coo_mttkrp.coo_mttkrp(st, tW, mode)
        want = coo_mttkrp.coo_mttkrp_plain(st, tW, mode)
        torch.cuda.synchronize()
        assert coo_mttkrp.LAUNCHES["coo_mttkrp"] == n0 + 2
        assert torch.equal(got, again)
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= 1e-4, (shape, R, mode, err)
        empty = torch.bincount(st.indices[:, mode].long(),
                               minlength=shape[mode]) == 0
        assert not got[empty].any()


@pytest.mark.cuda
def test_cuda_sparse_mttkrp_routes_to_kernel():
    """On a card: sparse.mttkrp on float32 launches K7 (also for factors
    that are transposed views), use_kernels=False does not, and the routes
    agree."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    idx, vals, Ws = _coo((30, 40, 50), 6, 4000)
    st = sparse.SparseTensor(torch.from_numpy(idx).cuda(),
                             torch.from_numpy(vals).cuda(), (30, 40, 50))
    tW = [torch.from_numpy(W).cuda().T.contiguous().T for W in Ws]
    n0 = coo_mttkrp.LAUNCHES["coo_mttkrp"]
    got = sparse.mttkrp(st, tW, 1)
    assert coo_mttkrp.LAUNCHES["coo_mttkrp"] == n0 + 1
    with config.override(use_kernels=False):
        off = sparse.mttkrp(st, tW, 1)
    torch.cuda.synchronize()
    assert coo_mttkrp.LAUNCHES["coo_mttkrp"] == n0 + 1
    assert float((got - off).abs().max() / off.abs().max()) <= 1e-4
