"""The port's sparse COO CP engine (ops/sparse.py, models/sparse_cp.py and
the CLI's -issparse 1) against the JAX package's, on the same numpy
nonzeros and factors (the JAX package's own, handed over through
utils.interop), mirroring the CP tests of tests/test_sparse.py.

float64 on the CPU: the MTTKRPs and caches agree to 1e-9, the
diagnostics to 1e-8, and 10-sweep ALS factor trajectories to 1e-6
(round-off from different summation and eigh implementations, compounded
through the solves), the tolerances of the JAX package's own tests.
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pairwise_perturbation_tpu.models import cp as jcp
from pairwise_perturbation_tpu.models import sparse_cp as jsparse_cp
from pairwise_perturbation_tpu.ops import sparse as jsp
from pairwise_perturbation_tpu_torch import cli, config
from pairwise_perturbation_tpu_torch.models import cp as tcp
from pairwise_perturbation_tpu_torch.models import sparse_cp as tsparse_cp
from pairwise_perturbation_tpu_torch.ops import sparse as tsp
from pairwise_perturbation_tpu_torch.ops.kernels import coo_mttkrp
from pairwise_perturbation_tpu_torch.utils import interop, synth

torch.set_num_threads(1)

HEADER = "[dim],[iter],[gradnorm],[tol],[pp_update],[diffV],[dtime]"


def _problem(shape=(7, 6, 8, 5), density=0.15, R=3, seed=0):
    """A random sparse V (numpy), both packages' COO of it, and factors."""
    rng = np.random.default_rng(seed)
    V = np.zeros(shape)
    nnz = int(density * V.size)
    V.ravel()[rng.choice(V.size, size=nnz, replace=False)] = \
        rng.standard_normal(nnz)
    jst = jsp.from_dense(V)
    Ws = [rng.standard_normal((s, R)) for s in shape]
    return V, jst, _port(jst), Ws


def _port(jst):
    return interop.sparse_from_numpy(np.asarray(jst.indices),
                                     np.asarray(jst.values), jst.shape,
                                     device="cpu")


def _t(Ws):
    return [torch.from_numpy(np.array(W)) for W in Ws]


def _close(t, j, rtol):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert np.max(np.abs(t - j)) <= rtol * np.max(np.abs(j)), \
        np.max(np.abs(t - j)) / np.max(np.abs(j))


def test_from_dense_order_and_round_trip():
    """The same nonzeros in the same (C) order as the JAX package, int32
    indices, and to_dense gives V back (duplicates would add)."""
    V, jst, _, _ = _problem()
    st = tsp.from_dense(V, device="cpu")
    assert st.indices.dtype == torch.int32 and st.shape == V.shape
    np.testing.assert_array_equal(st.indices.numpy(), np.asarray(jst.indices))
    np.testing.assert_array_equal(st.values.numpy(), np.asarray(jst.values))
    assert st.ndim == 4 and st.nnz == jst.nnz and st.dtype == torch.float64
    np.testing.assert_array_equal(tsp.to_dense(st).numpy(), V)
    dup = tsp.SparseTensor(torch.tensor([[0, 1], [0, 1]]),
                           torch.tensor([1.5, 2.0]), (2, 3))
    assert float(tsp.to_dense(dup)[0, 1]) == 3.5
    _close(tsp.norm_sq(st), np.sum(V * V), 1e-14)


def test_sparse_from_numpy_copies_as_given():
    idx = np.array([[0, 1], [2, 0]], dtype=np.int32)
    vals = np.array([1.0, 2.0], dtype=np.float32)
    st = interop.sparse_from_numpy(idx, vals, (3, 2), device="cpu")
    idx[0, 0], vals[0] = 9, 9.0
    assert st.indices.dtype == torch.int32 and st.dtype == torch.float32
    assert st.indices.tolist() == [[0, 1], [2, 0]]
    assert st.values.tolist() == [1.0, 2.0] and st.shape == (3, 2)


def test_norm_sq_bf16_accumulates_f32():
    vals = torch.full((4096,), 1.0 + 2.0 ** -7).to(torch.bfloat16)
    st = tsp.SparseTensor(torch.zeros((4096, 2), dtype=torch.int32), vals,
                          (1, 1))
    got = tsp.norm_sq(st)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(4096 * (1.0 + 2.0 ** -7) ** 2,
                                       rel=1e-6)


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_mttkrp_matches_jax(mode):
    _, jst, st, Ws = _problem()
    want = jsp.mttkrp(jst, [jnp.asarray(W) for W in Ws], mode,
                      method="segment")
    for use_kernels in (True, False):
        with config.override(use_kernels=use_kernels):
            got = tsp.mttkrp(st, _t(Ws), mode)
        assert got.dtype == torch.float64
        _close(got, want, 1e-9)


def test_mttkrp_sums_duplicates_and_zeroes_empty_rows():
    idx = np.array([[0, 1, 2], [0, 1, 2], [3, 0, 0]], dtype=np.int32)
    vals = np.array([1.0, 2.0, -1.0])
    shape = (5, 2, 3)
    Ws = [np.arange(s * 2, dtype=np.float64).reshape(s, 2) + 1
          for s in shape]
    jst = jsp.SparseTensor(jnp.asarray(idx), jnp.asarray(vals), shape)
    st = interop.sparse_from_numpy(idx, vals, shape, device="cpu")
    for mode in range(3):
        got = tsp.mttkrp(st, _t(Ws), mode)
        want = np.asarray(jsp.mttkrp(jst, [jnp.asarray(W) for W in Ws],
                                     mode, method="segment"))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-15)
    got0 = tsp.mttkrp(st, _t(Ws), 0).numpy()
    assert not got0[[1, 2, 4]].any()
    np.testing.assert_allclose(got0[0], 3.0 * Ws[1][1] * Ws[2][2])


def test_pp_caches_match_jax():
    """Singles (s_i, R) and rank-major pairs (R, s_i, s_j), as the JAX
    package's sparse build (and the dense one) lay them out."""
    _, jst, st, Ws = _problem()
    js, jp = jsp.build_pp_caches(jst, [jnp.asarray(W) for W in Ws])
    ts, tp = tsp.build_pp_caches(st, _t(Ws))
    assert sorted(ts) == sorted(js) and sorted(tp) == sorted(jp)
    for i in js:
        assert tuple(ts[i].shape) == tuple(js[i].shape)
        _close(ts[i], js[i], 1e-9)
    for k in jp:
        assert tuple(tp[k].shape) == tuple(jp[k].shape)
        _close(tp[k], jp[k], 1e-9)
    _close(tsp.pair_cache(st, _t(Ws), 1, 3),
           jsp.pair_cache(jst, [jnp.asarray(W) for W in Ws], 1, 3), 1e-9)


def test_fused_pair_index_is_int64(monkeypatch):
    """The pair caches' fused index i * s_j + j is formed in int64 (the JAX
    package's int32 wraps once s_i * s_j passes 2^31)."""
    _, _, st, Ws = _problem()
    seen = []
    scatter = tsp._scatter_rows

    def spy(prod, idx, n):
        seen.append((idx.dtype, n))
        return scatter(prod, idx, n)

    monkeypatch.setattr(tsp, "_scatter_rows", spy)
    tsp.build_pp_caches(st, _t(Ws))
    tsp.pair_cache(st, _t(Ws), 0, 2)
    pairs = [d for d, n in seen if n not in st.shape]
    assert len(pairs) == 7 and set(pairs) == {torch.int64}


def test_diagnostics_match_jax():
    _, jst, st, Ws = _problem()
    gn_j, dv_j = jsparse_cp.sparse_diagnostics(
        jsp.norm_sq(jst), jst, [jnp.asarray(W) for W in Ws])
    gn_t, dv_t = tsparse_cp.sparse_diagnostics(tsp.norm_sq(st), st, _t(Ws))
    _close(gn_t, float(gn_j), 1e-8)
    _close(dv_t, float(dv_j), 1e-8)


def _jax_init(shape, R):
    return [np.asarray(W) for W in jcp.init_factors(
        shape, R, key=jax.random.PRNGKey(0), dtype=jnp.float64)]


def test_als_cp_sparse_matches_jax():
    """10 plain sparse ALS sweeps from the same factors: logged rows and
    the factor trajectory agree to 1e-6."""
    _, jst, st, _ = _problem(shape=(6, 7, 5, 6))
    W0 = _jax_init(st.shape, 3)
    cfg = dict(tol=0.0, maxiter=10, resprint=5)
    rj = jsparse_cp.als_cp_sparse(jst, [jnp.array(w) for w in W0],
                                  jcp.CPConfig(**cfg))
    rt = tsparse_cp.als_cp_sparse(st, _t(W0), tcp.CPConfig(**cfg))
    assert [h["iter"] for h in rt.history] == [h["iter"] for h in rj.history]
    for a, b in zip(rt.history, rj.history):
        assert a["gradnorm"] == pytest.approx(b["gradnorm"], rel=1e-6)
        assert a["diffV"] == pytest.approx(b["diffV"], rel=1e-6)
    assert rt.iters == rj.iters
    for a, b in zip(rt.factors, rj.factors):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-9)


def test_als_cp_pp_sparse_on_poisson():
    """The folded Poisson tensor (dim 8, size 5 -> order 4, 25^4): the PP
    phase runs, and diffV is within the JAX test's bound against the
    dense JAX engine (test_sparse.py:75-90), and the DT <-> PP decisions
    are the JAX sparse engine's."""
    V = synth.make_tensor("p", dim=8, s=5, R=3, seed=3, dtype=np.float64)
    assert np.count_nonzero(V) / V.size < 0.3
    st = tsp.from_dense(V, device="cpu")
    Vn = float(np.linalg.norm(V))
    W0 = _jax_init(V.shape, 3)
    kw = dict(tol=0.0, pp_res_tol=0.3, maxiter=40, resprint=10)
    rt = tsparse_cp.als_cp_pp_sparse(st, _t(W0), tcp.CPConfig(**kw))
    rd = jcp.als_cp_pp(jnp.asarray(V), [jnp.array(w) for w in W0],
                       jcp.CPConfig(**kw))
    rj = jsparse_cp.als_cp_pp_sparse(jsp.from_dense(V),
                                     [jnp.array(w) for w in W0],
                                     jcp.CPConfig(**kw))
    assert np.isfinite(rt.diffV)
    assert rt.diffV < max(2.0 * rd.diffV, 1e-6 * Vn)
    assert any(h["pp"] == 1 for h in rt.history), "PP phase never ran"
    assert [(h["iter"], h["pp"]) for h in rt.history] == \
        [(h["iter"], h["pp"]) for h in rj.history]
    # both runs end near the fit's floor, where 40 f64 sweeps leave the
    # residuals apart by a few 1e-8 of ||V||
    assert rt.diffV == pytest.approx(rj.diffV, abs=1e-6 * Vn)


def _cli(tmp_path, *extra, name="s.csv"):
    out = str(tmp_path / name)
    rc = cli.main(["test_als", "-model", "CP", "-tensor", "p", "-dim", "8",
                   "-size", "5", "-rank", "3", "-maxiter", "15",
                   "-resprint", "5", "-issparse", "1", "-device", "cpu",
                   "-quiet", "-filename", out, *extra])
    with open(out) as fh:
        return rc, list(csv.reader(fh))


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("pp", ["0", "1"])
def test_cli_issparse(tmp_path, pp, dtype):
    """The CPU CLI writes the reference CSV and diffV decreases
    (test_sparse.py:93-104); CPU tensors never launch K7."""
    before = dict(coo_mttkrp.LAUNCHES)
    rc, rows = _cli(tmp_path, "-pp", pp, "-dtype", dtype,
                    "-pp_res_tol", "0.1")
    assert rc == 0
    assert ",".join(rows[0]) == HEADER
    body = [[float(x) for x in r] for r in rows[1:]]
    assert len(body) > 2 and all(np.isfinite(r).all() for r in body)
    assert body[-1][5] <= body[0][5]
    assert {r[4] for r in body} == ({0.0} if pp == "0" else {0.0, 1.0})
    assert coo_mttkrp.LAUNCHES == before


def test_cli_issparse_prints_density(tmp_path, capsys):
    out = str(tmp_path / "d.csv")
    assert cli.main(["test_als", "-tensor", "p", "-dim", "8", "-size", "5",
                     "-rank", "3", "-maxiter", "2", "-issparse", "1",
                     "-device", "cpu", "-filename", out]) == 0
    V = synth.make_tensor("p", 8, 5, 3, dtype=np.float32)
    nnz = np.count_nonzero(V)
    assert f"sparse COO: nnz= {nnz}  density= {nnz / V.size:.4f}" in \
        capsys.readouterr().out


def test_cli_issparse_bf16_values_are_rounded(tmp_path, monkeypatch):
    """-dtype bfloat16: the CLI's COO values are V's bf16-rounded values in
    float32, as the JAX package's np.asarray(jnp.asarray(V, bf16), f32)
    gives them, and the factors are float32."""
    seen = {}

    def capture(st, Ws, cfg, plot=None):
        seen["st"], seen["Ws"] = st, Ws
        return tcp.CPResult(Ws, 0.0, 0.0, 0, True, [])

    monkeypatch.setattr(tsparse_cp, "als_cp_sparse", capture)
    _cli(tmp_path, "-pp", "0", "-dtype", "bfloat16", "-seed", "2")
    V = synth.make_tensor("p", 8, 5, 3, seed=2, dtype=np.float32)
    want = np.asarray(jnp.asarray(V, jnp.bfloat16), np.float32)
    st = seen["st"]
    assert st.dtype == torch.float32 and seen["Ws"][0].dtype == torch.float32
    np.testing.assert_array_equal(st.values.numpy(), want[np.nonzero(want)])


@pytest.mark.parametrize("argv,step", [
    (["test_als", "-model", "Tucker"], "A10"),
    (["run"], "A11"),
    (["test_als", "-pp", "2"], "A9"),
    (["test_als", "-mesh", "8"], "A15"),
])
def test_cli_sparse_refusals_name_their_step(argv, step):
    with pytest.raises(SystemExit, match=step):
        cli.main(argv + ["-issparse", "1", "-device", "cpu"])
