"""The port's parallel layer (parallel/mesh.py, the engines' ``mesh=`` and
the CLI's ``-mesh``) against the JAX package's, on the same numpy inputs.

The port runs one process per mesh device: the clusters here are real
torchrun worlds of gloo ranks on the CPU (scripts/multiprocess_worker.py,
each given 120 s), and the JAX side runs on ``make_mesh`` over the CPU
devices tests/conftest.py provides. Each rank's block is held to the
block of JAX's global array at the same span.

Tolerances: float64 to 1e-12 relative (max-norm) and float32 to 1e-5 for
one function; solver trajectories over many sweeps to 1e-9 (CP) and the
Tucker runs' RUN (tests/test_torch_tucker.py), with identical DT <-> PP
decisions; the CLI under -mesh 2 against the port's own unsharded run to
1e-10. Replicated results are bitwise equal on every rank. The dense
engines' mesh (the sweep functions, CP-PP, Tucker-PP and the CLI) is held
to the JAX package's in tests/test_torch_mesh_dense.py.
"""

import csv
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pairwise_perturbation_tpu.models import cp as jcp
from pairwise_perturbation_tpu.models import sparse_cp as jsparse_cp
from pairwise_perturbation_tpu.models import sparse_tucker as jst
from pairwise_perturbation_tpu.models import tucker as jtk
from pairwise_perturbation_tpu.ops import sparse as jsp
from pairwise_perturbation_tpu.parallel import mesh as jmesh
from pairwise_perturbation_tpu.utils import io as jio
from pairwise_perturbation_tpu_torch import cli
from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
from pairwise_perturbation_tpu_torch.scripts.multiprocess_worker import \
    WORKER, run_cluster
from pairwise_perturbation_tpu_torch.utils import synth

from test_torch_sparse_tucker import jax_hosvd_rows
from test_torch_tucker import RUN, assert_close

torch.set_num_threads(1)

F64 = 1e-12
F32 = 1e-5
TRAJ = 1e-9
CLI_TOL = 1e-10
CLUSTER_S = 120.0

# The sharded sparse problem: a random COO (seeded), JAX's own seeded CP
# factors, orthonormal Tucker factors for the TTMc functions; the engines
# run CP-PP from the CP factors and Tucker-PP from the sketch HOSVD with
# JAX's draws.
SHAPE, DENSITY, R = (7, 6, 8, 5), 0.15, 3
TK_SHAPE, TK_RANKS = (8, 9, 10, 7), (2, 3, 3, 2)
CP_CFG = dict(tol=0.0, pp_res_tol=0.2, maxiter=20, resprint=1)
TK_CFG = dict(pp_res_tol=0.2, maxiter=30, resprint=2)
# The dense layout problem and the file of read_dense_sharded (as
# tests/test_parallel.py:231-256).
DENSE_SHAPE, DENSE_R = (6, 9, 10, 5), 4
FILE_SHAPE, FILE_PERM = (12, 6, 10, 3), (1, 2, 0, 3)


class AxesOnly:
    """What plan_layout reads of a mesh: axis names and sizes."""

    def __init__(self, names, sizes):
        self.mesh_dim_names, self.shape = tuple(names), tuple(sizes)


def jax_mesh(shape):
    return jmesh.make_mesh(shape, devices=jax.devices()[:int(np.prod(shape))])


@pytest.mark.parametrize("mesh_shape,shape,modes", [
    ((2,), (7, 6, 8, 5), None), ((8,), (3, 50, 7, 40), None),
    ((2, 4), (3, 50, 7, 40), None), ((2, 2), (6, 9, 10, 5), None),
    ((4, 2), (5, 5, 5), None), ((3,), (10, 11, 12), None),
    ((2, 4), (6, 9, 10, 5), (2, 1)), ((2, 3), (9, 4), None)])
def test_plan_layout_matches_jax(mesh_shape, shape, modes):
    names = pmesh.default_axis_names(len(mesh_shape))
    got = pmesh.plan_layout(shape, AxesOnly(names, mesh_shape), modes)
    want = jmesh.plan_layout(shape, jax_mesh(mesh_shape), modes)
    assert got.mode_axis == want.mode_axis
    assert got.padded_shape == want.padded_shape
    assert got.orig_shape == want.orig_shape
    assert got.v_spec() == tuple(want.v_spec())
    for m in range(len(shape)):
        assert got.w_spec(m) == tuple(want.w_spec(m))


def test_backend_rule_and_init_outside_torchrun(monkeypatch):
    assert pmesh.backend_for("cuda", 1, 1) == "nccl"
    assert pmesh.backend_for("cuda", 4, 4) == "nccl"
    assert pmesh.backend_for("cuda", 2, 1) == "gloo"
    assert pmesh.backend_for("cpu", 2, 0) == "gloo"
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert not pmesh.launched() and pmesh.world_size() == 1
    assert pmesh.distributed_init("cpu") == torch.device("cpu")
    assert pmesh.rank() == 0 and pmesh.backend() == "none"


def _sparse_problem():
    rng = np.random.default_rng(0)
    V = np.zeros(SHAPE)
    nnz = int(DENSITY * V.size)
    V.ravel()[rng.choice(V.size, size=nnz, replace=False)] = \
        rng.standard_normal(nnz)
    W0 = [np.asarray(W) for W in jcp.init_factors(
        SHAPE, R, key=jax.random.PRNGKey(0), dtype=jnp.float64)]
    Ts = [np.linalg.qr(rng.standard_normal((s, 2)))[0] for s in SHAPE]
    Vt = rng.standard_normal(TK_SHAPE)
    Vt[rng.random(TK_SHAPE) > 0.3] = 0.0
    return jsp.from_dense(V), W0, Ts, jsp.from_dense(Vt)


def _inputs(tmp, st_j, W0, Ts, tk_st, Vd, Wd, vfile):
    d = dict(indices=np.asarray(st_j.indices),
             values=np.asarray(st_j.values), shape=np.asarray(st_j.shape),
             cp_cfg=json.dumps(CP_CFG),
             tk_cfg=json.dumps(dict(tol=1e-12 * _vnorm(tk_st), **TK_CFG)),
             tk_ranks=np.asarray(TK_RANKS), V=Vd,
             mesh_shape=np.asarray([2]), vfile=vfile,
             file_shape=np.asarray(FILE_SHAPE),
             axes_perm=np.asarray(_axes_perm()),
             final_shape=np.asarray(_final_shape()))
    for i, W in enumerate(W0):
        d[f"cp_W{i}"] = W
    for i, T in enumerate(Ts):
        d[f"tk_W{i}"] = T
    # the Tucker engine's own tensor, started from JAX's sketch draws
    d.update(tk_indices=np.asarray(tk_st.indices),
             tk_values=np.asarray(tk_st.values),
             tk_shape=np.asarray(tk_st.shape))
    for i, O in enumerate(jax_hosvd_rows(tk_st, TK_RANKS)):
        d[f"tk_O{i}"] = O.numpy()
    for i, W in enumerate(Wd):
        d[f"d_W{i}"] = W
    path = tmp / "inputs.npz"
    np.savez(path, **d)
    return path


def _vnorm(st_j):
    return float(np.linalg.norm(np.asarray(st_j.values)))


def _axes_perm():
    return tuple(len(FILE_SHAPE) - 1 - FILE_PERM[i]
                 for i in range(len(FILE_SHAPE)))


def _final_shape():
    ctf = tuple(reversed(FILE_SHAPE))
    return tuple(ctf[p] for p in FILE_PERM)


def _dense_problem(tmp):
    rng = np.random.default_rng(5)
    Vd = rng.standard_normal(DENSE_SHAPE)
    Wd = [rng.standard_normal((s, DENSE_R)) for s in DENSE_SHAPE]
    arr = rng.standard_normal(FILE_SHAPE)
    vfile = str(tmp / "v.bin")
    arr.astype("<f8").tofile(vfile)
    return Vd, Wd, vfile


def _load(outdir, n):
    return [dict(np.load(outdir / f"result_{r}.npz")) for r in range(n)]


def _cluster(n, inputs, outdir, tasks):
    rc, out = run_cluster(n, WORKER + [
        "--inputs", inputs, "--outdir", outdir, "--tasks", tasks,
        "--device", "cpu", "--arrays"], timeout=CLUSTER_S)
    assert rc == 0, out[-4000:]
    return _load(outdir, n)


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One 2-rank gloo cluster: the five sharded sparse functions, the
    engines with mesh=, and the dense layout functions on a (2,) mesh,
    with the tucker engine's sketch rows drawn by the JAX package."""
    tmp = tmp_path_factory.mktemp("two_ranks")
    st_j, W0, Ts, tk_st = _sparse_problem()
    Vd, Wd, vfile = _dense_problem(tmp)
    path = _inputs(tmp, st_j, W0, Ts, tk_st, Vd, Wd, vfile)
    out = _cluster(2, path, tmp / "out", "functions,dense,cp,tucker")
    return dict(st=st_j, W0=W0, Ts=Ts, tk_st=tk_st, Vd=Vd, Wd=Wd,
                vfile=vfile, funcs=out, cp=out, tk=out)


def _rel_close(got, want, tol):
    assert_close(np.asarray(got), np.asarray(want), tol)


@functools.partial(jax.jit, static_argnames=("dtype", "mesh"))
def _jax_sharded_functions(sts, Ws, Ts, dtype, mesh):
    """JAX's five sharded sparse functions and ||V||^2, keyed as the
    worker keys them (one jit: eager shard_map calls compile one by
    one)."""
    want = {f"norm_sq/{dtype}": jsp.norm_sq(sts),
            f"gradnorm/{dtype}": jmesh.sharded_sparse_gradnorm(sts, Ws, mesh)}
    for m in range(sts.ndim):
        want[f"mttkrp/{dtype}/{m}"] = jmesh.sharded_sparse_mttkrp(sts, Ws, m,
                                                                  mesh)
    for skip in list(range(sts.ndim)) + [-1]:
        want[f"ttmc/{dtype}/{skip}"] = jmesh.sharded_sparse_ttmc(sts, Ts,
                                                                 skip, mesh)
    for tag, (single, pair) in (
            ("", jmesh.sharded_sparse_pp_caches(sts, Ws, mesh)),
            ("t", jmesh.sharded_sparse_ttmc_caches(sts, Ts, mesh))):
        for i in single:
            want[f"{tag}single/{dtype}/{i}"] = single[i]
        for (i, j) in pair:
            want[f"{tag}pair/{dtype}/{i}_{j}"] = pair[(i, j)]
    return want


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_sharded_sparse_functions_match_jax(two_ranks, dtype):
    """shard_coo's blocks give the JAX package's partials: each sharded
    function, on every rank, against JAX's on a (2,) mesh."""
    tol = F64 if dtype == "float64" else F32
    np_dt = np.float64 if dtype == "float64" else np.float32
    mesh = jax_mesh((2,))
    st = jsp.SparseTensor(two_ranks["st"].indices,
                          jnp.asarray(two_ranks["st"].values, np_dt),
                          two_ranks["st"].shape)
    want = _jax_sharded_functions(
        jmesh.shard_coo(st, mesh), [jnp.asarray(W, np_dt)
                                    for W in two_ranks["W0"]],
        [jnp.asarray(T, np_dt) for T in two_ranks["Ts"]], dtype, mesh)
    for res in two_ranks["funcs"]:
        for key, w in want.items():
            _rel_close(res[key], w, tol)
    a, b = two_ranks["funcs"]
    for key in want:
        assert np.array_equal(a[f"sha/{key}"], b[f"sha/{key}"]), key


def test_sharded_sparse_cp_pp_trajectory_matches_jax(two_ranks):
    """sparse_cp.als_cp_pp_sparse with mesh= against JAX's with its
    (2,) mesh: the same rows and DT <-> PP decisions, gradnorm and diffV
    along the run and the final factors to 1e-9; the ranks' factors
    bitwise equal."""
    mesh = jax_mesh((2,))
    rj = jsparse_cp.als_cp_pp_sparse(
        jmesh.shard_coo(two_ranks["st"], mesh),
        [jnp.array(W) for W in two_ranks["W0"]], jcp.CPConfig(**CP_CFG),
        mesh=mesh)
    want = np.asarray([[h["iter"], h["gradnorm"], h["diffV"], h["pp"]]
                       for h in rj.history])
    assert want[:, 3].sum() > 0, "no PP rows"
    for res in two_ranks["cp"]:
        got = res["cp_hist/float64"]
        assert got.shape == want.shape
        np.testing.assert_array_equal(got[:, [0, 3]], want[:, [0, 3]])
        np.testing.assert_allclose(got[:, 1:3], want[:, 1:3], rtol=TRAJ)
        for i, W in enumerate(rj.factors):
            _rel_close(res[f"cp_W/float64/{i}"], W, TRAJ)
    a, b = two_ranks["cp"]
    for i in range(len(SHAPE)):
        assert np.array_equal(a[f"cp_W/float64/{i}"], b[f"cp_W/float64/{i}"])


def test_sharded_sparse_tucker_pp_trajectory_matches_jax(two_ranks):
    """sparse_tucker.als_tucker_pp_sparse with mesh= and init_st (the
    HOSVD on the unsharded COO, rank 0, with JAX's sketch draws) against
    JAX's on its (2,) mesh: same decisions, diffV to RUN, diffnorm to
    RUN of ||V||, factors and core to RUN."""
    mesh = jax_mesh((2,))
    st = two_ranks["tk_st"]
    vn = _vnorm(st)
    rj = jst.als_tucker_pp_sparse(
        jmesh.shard_coo(st, mesh), TK_RANKS,
        jtk.TuckerConfig(tol=1e-12 * vn, **TK_CFG), mesh=mesh, init_st=st)
    flags = [h["pp"] for h in rj.history]
    assert sum(1 for a, b in zip(flags, flags[1:]) if (a, b) == (0, 1)) >= 2
    for res in two_ranks["tk"]:
        got = res["tk_hist/float64"]
        assert got.shape == (len(rj.history), 4)
        assert [tuple(r) for r in got[:, [0, 3]]] == \
            [(h["iter"], h["pp"]) for h in rj.history]
        for row, h in zip(got, rj.history):
            assert abs(row[2] - h["diffV"]) <= RUN * abs(h["diffV"])
            assert abs(row[1] - h["diffnorm"]) <= RUN * vn
        for i, W in enumerate(rj.factors):
            _rel_close(res[f"tk_W/float64/{i}"], W, RUN)
        _rel_close(res["tk_core/float64"], rj.core, RUN)
    a, b = two_ranks["tk"]
    assert np.array_equal(a["tk_core/float64"], b["tk_core/float64"])


def _block(x, spans):
    return np.asarray(x)[tuple(slice(lo, hi) for lo, hi in spans)]


def _check_dense(results, mesh_shape, Vd, Wd, vfile=None):
    """Every rank's blocks of the dense layout functions against JAX's
    global arrays at the rank's spans; the coordinates cover the mesh."""
    mesh = jax_mesh(mesh_shape)
    layout = jmesh.plan_layout(Vd.shape, mesh)
    Vs = jmesh.shard_tensor(Vd, layout)
    Wss = jmesh.shard_factors(Wd, layout)
    single, pair = jmesh.constrained_pp_caches(Vs, Wss, layout)
    coords = set()
    for res in results:
        coords.add(tuple(int(c) for c in res["coordinate"]))
        sp_ = [tuple(s) for s in res["spans"]]
        np.testing.assert_array_equal(res["V_block"], _block(Vs, sp_))
        for m in range(Vd.ndim):
            rows = [sp_[m], (0, DENSE_R)]
            np.testing.assert_array_equal(res[f"W_block/{m}"],
                                          _block(Wss[m], rows))
            M = jmesh.sharded_mttkrp(Vs, Wss, m, layout)
            _rel_close(res[f"smttkrp/{m}"], _block(M, rows), F64)
            assert float(res[f"err/smttkrp/{m}"]) <= F64
            np.testing.assert_array_equal(res[f"unshard/{m}"], Wd[m])
        for i in single:
            _rel_close(res[f"csingle/{i}"],
                       _block(single[i], [sp_[i], (0, DENSE_R)]), F64)
        for (i, j), x in pair.items():
            _rel_close(res[f"cpair/{i}_{j}"],
                       _block(x, [(0, DENSE_R), sp_[i], sp_[j]]), F64)
        if vfile is not None:
            lay = jmesh.plan_layout(_final_shape(), mesh)
            Vr = jio.read_dense_sharded(vfile, lay, out_dtype=np.float64,
                                        file_shape=FILE_SHAPE,
                                        axes_perm=_axes_perm())
            rs = [tuple(s) for s in res["read_spans"]]
            np.testing.assert_array_equal(res["read_block"], _block(Vr, rs))
            assert res["read_block"].size < int(np.prod(lay.padded_shape))
    assert coords == set(np.ndindex(*mesh_shape))


def test_dense_layout_functions_match_jax_on_2(two_ranks):
    _check_dense(two_ranks["funcs"], (2,), two_ranks["Vd"], two_ranks["Wd"],
                 two_ranks["vfile"])


def test_dense_layout_functions_match_jax_on_2x2(tmp_path):
    """A 4-rank cluster on a 2x2 mesh: V sharded over two modes, partial
    MTTKRPs and caches summed over sub-mesh groups."""
    Vd, Wd, vfile = _dense_problem(tmp_path)
    d = dict(V=Vd, mesh_shape=np.asarray([2, 2]), vfile=vfile,
             file_shape=np.asarray(FILE_SHAPE),
             axes_perm=np.asarray(_axes_perm()),
             final_shape=np.asarray(_final_shape()))
    for i, W in enumerate(Wd):
        d[f"d_W{i}"] = W
    np.savez(tmp_path / "in.npz", **d)
    results = _cluster(4, tmp_path / "in.npz", tmp_path / "out", "dense")
    assert {str(r["backend"]) for r in results} == {"gloo"}
    _check_dense(results, (2, 2), Vd, Wd, vfile)


# -------------------------------------------------------------------------
# The CLI under torchrun
# -------------------------------------------------------------------------

CLI_RUNS = {
    "CP": ["-model", "CP", "-tensor", "p2", "-dim", "8", "-size", "5",
           "-rank", "3", "-maxiter", "15", "-resprint", "1"],
    "Tucker": ["-model", "Tucker", "-tensor", "p", "-dim", "6", "-size",
               "8", "-rank", "1", "-maxiter", "20", "-resprint", "1"],
}


def _csv(path):
    with open(path) as fh:
        return list(csv.reader(fh))


@pytest.mark.parametrize("model", sorted(CLI_RUNS))
def test_cli_mesh_csv_matches_unsharded(tmp_path, model):
    """torchrun, 2 ranks: test_als -issparse 1 -pp 1 -mesh 2 -device cpu
    -dtype float64 writes the CSV of the port's own unsharded run: the
    same rows and [pp_update], [gradnorm] / [diffV] to 1e-10 relative
    ([diffnorm], a difference of core norms, to 1e-10 of ||V||); rank 0
    alone prints and writes."""
    argv = ["test_als", *CLI_RUNS[model], "-issparse", "1", "-pp", "1",
            "-pp_res_tol", "0.1", "-dtype", "float64", "-device", "cpu"]
    rc, out = run_cluster(2, ["-m", "pairwise_perturbation_tpu_torch.cli",
                              *argv, "-mesh", "2", "-filename",
                              tmp_path / "mesh.csv"], timeout=CLUSTER_S)
    assert rc == 0, out[-4000:]
    assert cli.main(argv + ["-quiet", "-filename",
                            str(tmp_path / "one.csv")]) == 0
    got, want = _csv(tmp_path / "mesh.csv"), _csv(tmp_path / "one.csv")
    assert "sharded COO: nnz split over 2 devices" in out
    assert "backend=  gloo" in out
    assert out.count("[iter]=") == len(want) - 1 > 2
    assert got[0] == want[0]
    vn = float(np.linalg.norm(synth.make_tensor(
        argv[4], int(argv[6]), int(argv[8]), int(argv[10]),
        dtype=np.float64)))
    assert {float(r[4]) for r in want[1:]} == {0.0, 1.0}
    assert len(got) == len(want)
    for g, w in zip(got[1:], want[1:]):
        for name, a, b in zip(want[0], g, w):
            a, b = float(a), float(b)
            if name in ("[gradnorm]", "[diffV]"):
                assert abs(a - b) <= CLI_TOL * abs(b), (name, g, w)
            elif name == "[diffnorm]":
                assert abs(a - b) <= CLI_TOL * vn, (name, g, w)
            elif name != "[dtime]":
                assert a == b, (name, g, w)


@pytest.mark.parametrize("argv,match", [
    (["test_als", "-issparse", "1", "-mesh", "2"],
     "torchrun --standalone --nproc_per_node 2"),
    (["test_als", "-model", "Tucker", "-issparse", "1", "-mesh", "3"],
     "world of 1: launch 3 ranks"),
    (["test_als", "-issparse", "1", "-mesh", "2x1"], "on a 1D mesh"),
    (["run", "-issparse", "1", "-mesh", "2"], "on a 1D mesh"),
    (["test_als", "-mesh", "2"], "torchrun --standalone --nproc_per_node 2"),
    (["run", "-mesh", "2"], "torchrun --standalone --nproc_per_node 2"),
    (["pp_bench", "-mesh", "2x2"], "world of 1: launch 4 ranks"),
    (["test_als", "-mesh", "2", "-pp", "1", "-device_loop", "1"],
     "torchrun --standalone --nproc_per_node 2"),
    (["pp_bench", "-mesh", "2", "-device_loop", "2"], "ignores the flag"),
])
def test_cli_mesh_refusals(argv, match):
    """What -mesh refuses, each naming its ROADMAP step or saying that the
    JAX package ignores the flag, and the dense engines' (the device
    engines' too) and run's -mesh outside torchrun, which says how to
    launch it."""
    with pytest.raises(SystemExit, match=match):
        cli.main(argv + ["-device", "cpu"])


@pytest.mark.parametrize("engine", ["cp", "tucker"])
def test_sparse_engines_refuse_a_2d_mesh(engine):
    from pairwise_perturbation_tpu_torch.models import cp as tcp
    from pairwise_perturbation_tpu_torch.models import sparse_cp, \
        sparse_tucker, tucker
    from pairwise_perturbation_tpu_torch.ops import sparse as tsp
    st = tsp.from_dense(np.eye(3)[:, :, None] * np.ones(2), device="cpu")
    mesh = AxesOnly(("x", "x1"), (2, 2))
    with pytest.raises(ValueError, match="1D mesh"):
        if engine == "cp":
            sparse_cp.als_cp_pp_sparse(st, [torch.ones(s, 2)
                                            for s in st.shape],
                                       tcp.CPConfig(), mesh=mesh)
        else:
            sparse_tucker.als_tucker_sparse(st, (1, 1, 1),
                                            tucker.TuckerConfig(), mesh=mesh)
    with pytest.raises(ValueError, match="1D mesh"):
        pmesh.shard_coo(st, mesh)
