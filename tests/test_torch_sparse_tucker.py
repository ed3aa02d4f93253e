"""Sparse Tucker in the port against the JAX package, on the same COO
arrays: the Tucker half of ops/sparse.py, models/sparse_tucker.py and
the CLI's ``-model Tucker -issparse 1`` branch.

The JAX package draws each mode's sketch rows with a fold_in hash of the
nonzero's other indices; the port takes them as an argument, so these
tests pass the JAX package's rows in (``jax_rows``) and then compare in
float64: one function to 1e-10, the solver histories over many sweeps to
1e-8 (diffnorm, a difference of core norms, to 1e-8 of ||V||), as
tests/test_torch_tucker.py. float32: 1e-4 for one function.
"""

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pairwise_perturbation_tpu import cli as jcli
from pairwise_perturbation_tpu.models import sparse_tucker as jst
from pairwise_perturbation_tpu.models import tucker as jtk
from pairwise_perturbation_tpu.ops import sparse as jsp
from pairwise_perturbation_tpu_torch import cli
from pairwise_perturbation_tpu_torch.models import sparse_tucker as tst
from pairwise_perturbation_tpu_torch.models import tucker as ttk
from pairwise_perturbation_tpu_torch.ops import sparse as tsp
from pairwise_perturbation_tpu_torch.scripts import _bench
from pairwise_perturbation_tpu_torch.utils import interop, synth, tracing

from test_torch_tucker import assert_close, assert_same_run, \
    assert_same_tucker_csv

torch.set_num_threads(1)

F64 = 1e-10
F32 = 1e-4


def coo(V, dtype=np.float64):
    """The JAX package's COO of V and the port's copy of the same arrays."""
    st_j = jsp.from_dense(np.asarray(V, dtype))
    st_t = interop.sparse_from_numpy(np.asarray(st_j.indices),
                                     np.asarray(st_j.values), st_j.shape,
                                     device="cpu")
    return st_j, st_t


def random_sparse(rng, shape, density=0.15):
    V = rng.standard_normal(shape)
    V[rng.random(shape) > density] = 0.0
    return V


def poisson(dim=6, size=8):
    return synth.make_tensor("p", dim, size, 3, dtype=np.float64)


def orth(rng, s, r):
    return np.linalg.qr(rng.standard_normal((s, r)))[0]


def jax_rows(st_j, mode, k, key):
    """The JAX package's per-nonzero sketch rows for ``mode``
    (sparse.py:346-352): a uniform(-1, 1) row from the key folded with
    each other mode's index."""
    others = [m for m in range(st_j.ndim) if m != mode]

    def row_omega(idx_row):
        kk = key
        for m in others:
            kk = jax.random.fold_in(kk, idx_row[m])
        return jax.random.uniform(kk, (k,), dtype=st_j.values.dtype,
                                  minval=-1.0, maxval=1.0)

    return torch.tensor(np.asarray(jax.vmap(row_omega)(st_j.indices)))


def jax_hosvd_rows(st_j, ranks, oversample=8, key=None):
    """Every mode's rows as the JAX package's hosvd_sparse draws them
    (jax.random.split of PRNGKey(0))."""
    keys = jax.random.split(jax.random.PRNGKey(0) if key is None else key,
                            st_j.ndim)
    return [jax_rows(st_j, i, min(int(ranks[i]) + oversample,
                                  st_j.shape[i]), keys[i])
            for i in range(st_j.ndim)]


SHAPES = [((9, 10, 11), (3, 2, 4)), ((6, 7, 8, 9), (2, 3, 2, 3))]


@pytest.mark.parametrize("dtype,tol", [(np.float64, F64), (np.float32, F32)])
@pytest.mark.parametrize("shape,ranks", SHAPES)
@pytest.mark.parametrize("rank_last", [False, True])
def test_ttm_dense_matches_jax(rng, dtype, tol, shape, ranks, rank_last):
    st_j, st_t = coo(random_sparse(rng, shape), dtype)
    for mode in range(len(shape)):
        W = rng.standard_normal((shape[mode], ranks[mode])).astype(dtype)
        got = tsp.ttm_dense(st_t, torch.from_numpy(W), mode, rank_last)
        want = jsp.ttm_dense(st_j, jnp.asarray(W), mode, rank_last)
        assert_close(got, want, tol)


@pytest.mark.parametrize("shape,ranks", SHAPES + [((64, 64, 64), (3, 3, 3))])
def test_ttmc_and_caches_match_jax(rng, shape, ranks):
    V = poisson() if shape == (64, 64, 64) else random_sparse(rng, shape)
    st_j, st_t = coo(V)
    Ws = [orth(rng, s, r) for s, r in zip(shape, ranks)]
    tW, jW = [torch.from_numpy(W) for W in Ws], [jnp.asarray(W) for W in Ws]
    for keep in [()] + [(i,) for i in range(len(shape))] + [(0, 1)]:
        assert tsp._best_contract_mode(st_t, ranks, keep) == \
            jsp._best_contract_mode(st_j, ranks, keep)
    for skip in [-1] + list(range(len(shape))):
        assert_close(tsp.ttmc(st_t, tW, skip), jsp.ttmc(st_j, jW, skip), F64)
    ts, tp = tsp.build_ttmc_caches(st_t, tW)
    js, jp = jsp.build_ttmc_caches(st_j, jW)
    assert sorted(tp) == sorted(jp) and sorted(ts) == sorted(js)
    for k in jp:
        assert_close(tp[k], jp[k], F64)
    for k in js:
        assert_close(ts[k], js[k], F64)


@pytest.mark.parametrize("shape", [(9, 10, 11), (6, 7, 8, 9)])
def test_sketch_and_power_iter_match_jax(rng, shape):
    st_j, st_t = coo(random_sparse(rng, shape))
    key = jax.random.PRNGKey(5)
    for mode in range(len(shape)):
        k = min(4, shape[mode])
        rows = jax_rows(st_j, mode, k, key)
        B = tsp.mode_subspace_sketch(st_t, mode, rows)
        assert_close(B, jsp.mode_subspace_sketch(st_j, mode, k, key), F64)
        U = np.linalg.qr(rng.standard_normal((shape[mode], k)))[0]
        assert_close(tsp.mode_power_iter(st_t, mode, torch.from_numpy(U)),
                     jsp.mode_power_iter(st_j, mode, jnp.asarray(U)), F64)


def test_sketch_rows_share_a_column_row(rng):
    """The port's own sketch rows: nonzeros of one unfolding column get
    one row, others (almost surely) another; only the populated columns
    are drawn (no (prod of other modes, k) Omega); the draw repeats."""
    V = random_sparse(rng, (5, 6, 7), density=0.6)
    _, st = coo(V)
    inv, n_cols = tsp._columns(st, 0)
    rows = tsp.sketch_rows(st, 0, 3, seed=4)
    assert rows.shape == (st.nnz, 3) and n_cols < 6 * 7 + 1
    assert bool(torch.all((rows >= -1) & (rows < 1)))
    cols = st.indices[:, 1].long() * 7 + st.indices[:, 2].long()
    for c in torch.unique(cols)[:10]:
        sel = rows[cols == c]
        assert torch.equal(sel, sel[:1].expand_as(sel))
    assert len({tuple(r.tolist()) for r in rows}) == n_cols
    assert torch.equal(rows, tsp.sketch_rows(st, 0, 3, seed=4))
    assert not torch.equal(rows, tsp.sketch_rows(st, 0, 3, seed=5))


@pytest.mark.parametrize("shape,ranks", SHAPES)
def test_hosvd_sparse_matches_jax_with_its_draws(rng, shape, ranks):
    st_j, st_t = coo(random_sparse(rng, shape, density=0.4))
    core_j, Wj = jst.hosvd_sparse(st_j, ranks)
    core_t, Wt = tst.hosvd_sparse(st_t, ranks,
                                  omegas=jax_hosvd_rows(st_j, ranks))
    for a, b in zip(Wt, Wj):
        assert_close(a, b, F64)
    assert_close(core_t, core_j, F64)


def test_hosvd_sparse_own_draw_finds_the_subspace(rng):
    """The port's default rows: on an exactly low-rank tensor every
    mode's subspace is the true one (projectors agree with JAX's)."""
    shape, ranks = (12, 10, 14), (2, 3, 2)
    core = rng.standard_normal(ranks)
    Ws = [orth(rng, s, r) for s, r in zip(shape, ranks)]
    V = np.einsum("PQR,aP,bQ,cR->abc", core, *Ws)
    st_j, st_t = coo(V)
    _, Wt = tst.hosvd_sparse(st_t, ranks)
    _, Wj = jst.hosvd_sparse(st_j, ranks)
    for a, b in zip(Wt, Wj):
        a, b = a.numpy(), np.asarray(b)
        assert_close(a @ a.T, b @ b.T, 1e-8)


def test_sweep_caches_and_diagnostics_match_jax(rng):
    shape, ranks = (8, 9, 10, 7), (2, 3, 3, 2)
    st_j, st_t = coo(random_sparse(rng, shape, density=0.3))
    Ws = [orth(rng, s, r) for s, r in zip(shape, ranks)]
    tW, jW = [torch.from_numpy(W) for W in Ws], [jnp.asarray(W) for W in Ws]
    for use_sign in (False, True):
        Wt, ct = tst.sparse_hooi_sweep(st_t, tW, tW, ranks=ranks,
                                       use_sign=use_sign)
        Wj, cj = jst.sparse_hooi_sweep(st_j, jW, jW, ranks=ranks,
                                       use_sign=use_sign)
        for a, b in zip(Wt, Wj):
            assert_close(a, b, F64)
        assert_close(ct, cj, F64)
    vn = float(np.sum(np.asarray(st_j.values) ** 2))
    got = tst.sparse_tucker_diagnostics(
        torch.tensor(vn, dtype=torch.float64), st_t, tW, 0.5)
    want = jst.sparse_tucker_diagnostics(vn, st_j, jW, jnp.asarray(0.5))
    for a, b in zip(got, want):
        assert_close(a, b, F64)
    ts, tp = tst.sparse_tucker_build_caches(st_t, tW)
    js, jp = jst.sparse_tucker_build_caches(st_j, jW)
    for k in jp:
        assert_close(tp[k], jp[k], F64)


# (tensor, ranks, config, PP phases at least). The folded Poisson tensor
# has multilinear rank 2 in every mode, so it is fitted at rank 1 (at
# rank 2 and up the fit is exact and diffV is round-off).
RUNS = {
    "poisson_64^3_rank1": ("poisson", (1, 1, 1),
                           dict(pp_res_tol=0.1, maxiter=20, resprint=1), 1),
    "random_order3": ("random3", (3, 3, 3),
                      dict(pp_res_tol=0.1, maxiter=30, resprint=1), 2),
    "random_order4": ("random4", (2, 3, 3, 2),
                      dict(pp_res_tol=0.2, maxiter=30, resprint=2), 2),
}


def _run_tensor(name):
    rng = np.random.default_rng(0)
    if name == "poisson":
        return poisson()
    shape = (12, 13, 14) if name == "random3" else (8, 9, 10, 7)
    return random_sparse(rng, shape, density=0.3)


@pytest.mark.parametrize("pp", [False, True])
@pytest.mark.parametrize("run", sorted(RUNS))
def test_als_tucker_sparse_matches_jax(run, pp):
    kind, ranks, kw, phases = RUNS[run]
    V = _run_tensor(kind)
    vn = float(np.linalg.norm(V))
    st_j, st_t = coo(V)
    cfg = dict(tol=1e-12 * vn, **kw)
    jfn = jst.als_tucker_pp_sparse if pp else jst.als_tucker_sparse
    tfn = tst.als_tucker_pp_sparse if pp else tst.als_tucker_sparse
    rj = jfn(st_j, ranks, jtk.TuckerConfig(**cfg))
    rt = tfn(st_t, ranks, ttk.TuckerConfig(**cfg),
             omegas=jax_hosvd_rows(st_j, ranks))
    assert_same_run(rt, rj, vn)
    flags = [h["pp"] for h in rt.history]
    if pp:
        assert sum(1 for a, b in zip(flags, flags[1:]) if (a, b) == (0, 1)) \
            >= phases, flags
    else:
        assert set(flags) == {0}


class _Mesh2D:
    """A 2x2 mesh's axis names and sizes (all the engines read of it
    before they refuse it)."""
    mesh_dim_names, shape = ("x", "x1"), (2, 2)


def test_sparse_tucker_refuses_a_mesh(rng):
    """The nnz-sharded engines take a 1D mesh only, as the JAX package's
    shard_coo does; a 2D one is refused before any collective."""
    _, st = coo(random_sparse(rng, (5, 6, 7)))
    for fn in (tst.als_tucker_sparse, tst.als_tucker_pp_sparse):
        with pytest.raises(ValueError, match="1D mesh"):
            fn(st, (2, 2, 2), ttk.TuckerConfig(), mesh=_Mesh2D())


def _csv(main, path, argv):
    assert main(argv + ["-quiet", "-filename", str(path)]) == 0
    with open(path) as fh:
        return list(csv.reader(fh))


SPARSE_ARGV = ["test_als", "-model", "Tucker", "-maxiter", "20",
               "-resprint", "1", "-pp_res_tol", "0.1", "-issparse", "1",
               "-dtype", "float64"]
# (-tensor, -dim, -size, -rank): the folded Poisson tensor at rank 1 (see
# RUNS), and a dense random one through the COO engine, which switches
# between the phases more often.
CLI_TENSORS = [("p", 6, 8, 1), ("r2", 3, 10, 3)]


def _tensor_argv(name, dim, size, rank):
    return ["-tensor", name, "-dim", str(dim), "-size", str(size), "-rank",
            str(rank)]


@pytest.mark.parametrize("tensor", CLI_TENSORS)
@pytest.mark.parametrize("pp", ["0", "1"])
def test_cli_sparse_tucker_csv_matches_jax(tmp_path, monkeypatch, pp,
                                           tensor):
    """-model Tucker -issparse 1 through both CLIs in float64, the port's
    sketch rows replaced by the JAX package's draw: the CSVs agree but
    for [dtime]."""
    def rows_of_jax(st, mode, k, seed):
        st_j = jsp.SparseTensor(jnp.asarray(st.indices.numpy()),
                                jnp.asarray(st.values.numpy()), st.shape)
        key = jax.random.split(jax.random.PRNGKey(0), st.ndim)[seed]
        return jax_rows(st_j, mode, k, key)

    monkeypatch.setattr(tsp, "sketch_rows", rows_of_jax)
    argv = SPARSE_ARGV + _tensor_argv(*tensor) + ["-pp", pp]
    got = _csv(cli.main, tmp_path / "port.csv", argv + ["-device", "cpu"])
    want = _csv(jcli.main, tmp_path / "jax.csv", argv)
    V = synth.make_tensor(tensor[0], tensor[1], tensor[2], tensor[3],
                          dtype=np.float64)
    assert_same_tucker_csv(got, want, float(np.linalg.norm(V)))
    assert {float(r[4]) for r in got[1:]} == \
        ({0.0} if pp == "0" else {0.0, 1.0})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cli_sparse_tucker_f32_profile_and_no_launches(tmp_path, capsys,
                                                       dtype):
    before = _bench.launch_counts()
    tracing.reset()
    try:
        rows = _csv(cli.main, tmp_path / "s.csv",
                    [a if a != "float64" else dtype for a in SPARSE_ARGV]
                    + _tensor_argv(*CLI_TENSORS[1])
                    + ["-pp", "1", "-profile", "1", "-device", "cpu"])
    finally:
        tracing.enable(False)
    assert rows[0] == "[dim],[iter],[diffnorm],[tol],[pp_update],[diffV]," \
        "[dtime]".split(",")
    body = [[float(x) for x in r] for r in rows[1:]]
    assert all(np.isfinite(r).all() for r in body)
    assert body[-1][5] <= body[0][5]
    assert 1.0 in {r[4] for r in body}
    out = capsys.readouterr().out
    for name in ("sparse_tucker.hosvd", "sparse_tucker.sweep",
                 "sparse_tucker.pp_cache_build", "sparse_tucker.pp_sweep",
                 "sparse_tucker.diagnostics"):
        assert tracing.stats()[name][0] > 0 and name in out, name
    assert _bench.launch_counts() == before


@pytest.mark.parametrize("argv,step", [
    (["-pp", "2"], "no sparse engine"),
    (["-mesh", "4"], "A15"),
    (["-device_loop", "1"], "ignores the flag"),
])
def test_cli_sparse_tucker_refusals(argv, step):
    with pytest.raises(SystemExit, match=step):
        cli.main(["test_als", "-model", "Tucker", "-issparse", "1",
                  "-device", "cpu"] + argv)
