"""The dense engines on a block-sharded V (parallel/mesh.py's dense half:
``CPConfig``/``TuckerConfig.mesh_layout``, the sweep functions'
``layout=``, ``test_als`` and ``pp_bench -mesh``) against the JAX
package's GSPMD runs on a CPU mesh of the same shape, on the same numpy
inputs.

Two real torchrun clusters of gloo ranks on the CPU
(scripts/multiprocess_worker.py, 120 s each): two ranks on a (2,) mesh,
and four on a 2x2 mesh. Each rank gathers its blocks whole (padded), so
every result is held to JAX's padded global array and compared bit for
bit across the ranks. The problems pad a sharded mode (11 -> 12, 9 ->
10, 15 -> 16), the function problem takes Tucker's mode-side extraction
and HOSVD's assembled Gram on its sharded modes, the Tucker run the
small side and (HOSVD_EXACT_EIGH_MAX lowered to 12, in both packages)
the matrix-free subspace HOSVD.

Tolerances, as tests/test_torch_parallel.py states them: float64
functions 1e-12 relative (max-norm), float32 1e-5; CP trajectories 1e-9
with identical DT <-> PP decisions; Tucker to RUN; the CLI under -mesh 2
against the port's own unsharded run 1e-10.
"""

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pairwise_perturbation_tpu.models import cp as jcp
from pairwise_perturbation_tpu.models import tucker as jtk
from pairwise_perturbation_tpu.parallel import mesh as jmesh
from pairwise_perturbation_tpu_torch import cli
from pairwise_perturbation_tpu_torch.models import cp as tcp
from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
from pairwise_perturbation_tpu_torch.scripts.multiprocess_worker import \
    WORKER, run_cluster
from pairwise_perturbation_tpu_torch.utils import io as tio

from test_torch_tucker import RUN, assert_close

torch.set_num_threads(1)

F64 = 1e-12
F32 = 1e-5
TRAJ = 1e-9
CLI_TOL = 1e-10
CLUSTER_S = 120.0

# The sweep functions' problem: random V and CP factors; Tucker ranks
# whose mode-2 unfolding (m = 12 >= s_2 = 12 padded) takes the mode side.
FUNC_SHAPE, FUNC_R, FUNC_RANKS = (6, 9, 11, 5), 4, (2, 3, 3, 2)
# CP-PP: a rank-3 tensor plus 1% noise, from uniform factors.
CP_SHAPE, CP_R = (6, 8, 9, 6), 3
CP_CFG = dict(tol=0.0, pp_res_tol=0.1, maxiter=30, resprint=1)
# Tucker-PP: tests/test_torch_tucker.py's exact-eigh run at a padded
# shape; mode 2 (16 padded > TK_EXACT_MAX) takes the subspace HOSVD.
TK_SHAPE, TK_RANKS, TK_EXACT_MAX = (10, 12, 15), (3, 4, 4), 12
TK_CFG = dict(pp_res_tol=0.1, maxiter=30, resprint=1, subspace_iters=0)
MESHES = {2: (2,), 4: (2, 2)}


def jax_mesh(shape):
    return jmesh.make_mesh(shape, devices=jax.devices()[:int(np.prod(shape))])


def _problem():
    rng = np.random.default_rng(7)
    Vf = rng.standard_normal(FUNC_SHAPE)
    Wf = [rng.standard_normal((s, FUNC_R)) for s in FUNC_SHAPE]
    truth = [rng.random((s, CP_R)) for s in CP_SHAPE]
    Vc = np.einsum("ar,br,cr,dr->abcd", *truth)
    Vc = Vc + 0.01 * np.linalg.norm(Vc) / np.sqrt(Vc.size) \
        * rng.standard_normal(CP_SHAPE)
    Wc = [rng.random((s, CP_R)) for s in CP_SHAPE]
    Vt = np.random.default_rng(0).uniform(0.5, 1.0, TK_SHAPE)
    return dict(Vf=Vf, Wf=Wf, Vc=Vc, Wc=Wc, Vt=Vt)


def _tk_draws(mesh_shape):
    """JAX's HOSVD draws (PRNGKey(17 + i), at the padded global sizes)."""
    padded = jmesh.plan_layout(TK_SHAPE, jax_mesh(mesh_shape)).padded_shape
    return [np.asarray(jax.random.normal(
        jax.random.PRNGKey(17 + i), (s, min(2 * r, s)), dtype=jnp.float64))
        for i, (s, r) in enumerate(zip(padded, TK_RANKS))]


# The CLI runs in the 2-rank cluster: each (name, argv), run again here
# without -mesh. o1 and o2 read small files in the datasets' layouts.
COIL_FILE, LAPSE_FILE = (11, 6, 5, 3), (3, 7, 8, 5)
CLI_BASE = ["-rank", "3", "-maxiter", "15", "-resprint", "1",
            "-pp_res_tol", "0.1", "-device", "cpu"]
CLI_RUNS = {
    "cp_pp1": ["test_als", "-model", "CP", "-tensor", "r", "-dim", "3",
               "-size", "9", "-pp", "1", "-dtype", "float64"],
    "cp_pp2": ["test_als", "-model", "CP", "-tensor", "r", "-dim", "4",
               "-size", "5", "-pp", "2", "-dtype", "float64"],
    "cp_f32": ["test_als", "-model", "CP", "-tensor", "r", "-dim", "3",
               "-size", "9", "-pp", "1", "-dtype", "float32"],
    "cp_bf16": ["test_als", "-model", "CP", "-tensor", "r", "-dim", "3",
                "-size", "9", "-pp", "1", "-dtype", "bfloat16"],
    "tucker": ["test_als", "-model", "Tucker", "-tensor", "r2", "-dim", "3",
               "-size", "9", "-pp", "1", "-dtype", "float64"],
    "o1": ["test_als", "-model", "CP", "-tensor", "o1", "-pp", "1",
           "-dtype", "float64"],
    "o2": ["test_als", "-model", "CP", "-tensor", "o2", "-pp", "0",
           "-dtype", "float64"],
    "resume": ["test_als", "-model", "CP", "-tensor", "r", "-dim", "3",
               "-size", "9", "-pp", "1", "-dtype", "float64"],
    "bench_cp": ["pp_bench", "-model", "CP", "-tensor", "r", "-dim", "3",
                 "-size", "9", "-maxiter", "2"],
    "bench_tucker": ["pp_bench", "-model", "Tucker", "-tensor", "r2",
                     "-dim", "3", "-size", "9", "-maxiter", "2"],
}


def _cli_argv(tmp, name, mesh):
    cmd, *rest = CLI_RUNS[name]
    argv = [cmd] + CLI_BASE + rest    # the run's own flags last: they win
    if name in ("o1", "o2"):
        argv += ["-tensorfile", str(tmp / f"{name}.bin")]
    if name == "cp_pp1":
        argv += ["-checkpoint", str(tmp / f"ck_{mesh}")]
    if name == "resume":
        argv += ["-resume", str(tmp / "start.npz")]
    argv += ["-quiet", "-filename", str(tmp / f"{name}_{mesh}.csv")]
    return argv + (["-mesh", "2"] if mesh == "mesh" else [])


def _files(tmp):
    """The small o1/o2 binaries and a checkpoint for -resume."""
    rng = np.random.default_rng(3)
    for name, shape in (("o1", COIL_FILE), ("o2", LAPSE_FILE)):
        rng.standard_normal(shape).astype("<f8").tofile(tmp / f"{name}.bin")
    tio.save_checkpoint(str(tmp / "start.npz"),
                        [rng.random((9, 3)) for _ in range(3)], 4,
                        meta=dict(model="CP", tensor="r"))


def _inputs(tmp, prob, mesh_shape, with_cli):
    d = dict(dd_mesh=np.asarray(mesh_shape), dd_V=prob["Vf"],
             dd_ranks=np.asarray(FUNC_RANKS), dc_V=prob["Vc"],
             dc_cfg=json.dumps(CP_CFG), dc_pp=np.asarray([1, 2]),
             dt_V=prob["Vt"], dt_ranks=np.asarray(TK_RANKS),
             dt_hosvd_max=TK_EXACT_MAX,
             dt_tk_cfg=json.dumps(dict(tol=1e-12 * _vn(prob["Vt"]),
                                       **TK_CFG)))
    for i, W in enumerate(prob["Wf"]):
        d[f"dd_W{i}"] = W
    for i, W in enumerate(prob["Wc"]):
        d[f"dc_W{i}"] = W
    for i, Q in enumerate(_tk_draws(mesh_shape)):
        d[f"dt_Q{i}"] = Q
    if with_cli:
        d["cli_argv"] = json.dumps([_cli_argv(tmp, n, "mesh")
                                    for n in CLI_RUNS])
        d["io_shapes"] = json.dumps(dict(COIL100_FILE_SHAPE=COIL_FILE,
                                         TIME_LAPSE_FILE_SHAPE=LAPSE_FILE))
    path = tmp / f"in_{len(mesh_shape)}.npz"
    np.savez(path, **d)
    return path


def _vn(V):
    return float(np.linalg.norm(V))


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """The 2-rank cluster (the functions in float64 and float32, the
    engines, the CLI runs) and the 2x2 one (float64, no CLI)."""
    tmp = tmp_path_factory.mktemp("mesh_dense")
    prob = _problem()
    _files(tmp)
    out = {}
    for n, shape in MESHES.items():
        tasks = "dfunctions,dcp,dtucker" + (",cli" if n == 2 else "")
        path = _inputs(tmp, prob, shape, n == 2)
        rc, log = run_cluster(n, WORKER + [
            "--inputs", path, "--outdir", tmp / f"out{n}", "--tasks", tasks,
            "--device", "cpu", "--arrays", "--dtypes",
            "float64,float32" if n == 2 else "float64"], timeout=CLUSTER_S)
        assert rc == 0, log[-4000:]
        out[n] = [dict(np.load(tmp / f"out{n}" / f"result_{r}.npz"))
                  for r in range(n)]
    return dict(prob=prob, tmp=tmp, res=out)


def _same_on_ranks(results, keys):
    for res in results[1:]:
        for k in keys:
            assert np.array_equal(res[f"sha/{k}"], results[0][f"sha/{k}"]), k


def _rel_close(got, want, tol):
    assert_close(np.asarray(got), np.asarray(want), tol)


# -------------------------------------------------------------------------
# The sweep functions
# -------------------------------------------------------------------------


def _jax_functions(prob, mesh_shape, dtype):
    """JAX's dt_sweep, constrained caches and two pp_sweeps on its sharded
    arrays (padded global arrays), keyed as the worker keys them."""
    np_dt = getattr(np, dtype)
    mesh = jax_mesh(mesh_shape)
    layout = jmesh.plan_layout(FUNC_SHAPE, mesh)
    Vs = jmesh.shard_tensor(prob["Vf"].astype(np_dt), layout)
    Wss = jmesh.shard_factors([W.astype(np_dt) for W in prob["Wf"]], layout)
    lam = jnp.asarray(0.0, np_dt)
    want = {}
    Ws, grads = jcp.dt_sweep(Vs, list(Wss), lam, solver="svd")
    for m in range(len(FUNC_SHAPE)):
        want[f"dt/W{m}"], want[f"dt/g{m}"] = Ws[m], grads[m]
    single, pair = jmesh.constrained_pp_caches(Vs, list(Wss), layout)
    want.update({f"single/{i}": x for i, x in single.items()})
    want.update({f"pair/{i}_{j}": x for (i, j), x in pair.items()})
    zeros = [jnp.zeros_like(W) for W in Wss]
    W1, dW1, _ = jcp.pp_sweep(single, pair, list(Wss), list(Wss), zeros,
                              lam, 1.0, solver="svd")
    W2, _, _ = jcp.pp_sweep(single, pair, W1, list(Wss), dW1, lam, 1.0,
                            solver="svd")
    for m in range(len(FUNC_SHAPE)):
        want[f"pp1/W{m}"], want[f"pp2/W{m}"] = W1[m], W2[m]
    return layout, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("n,dtype", [(2, "float64"), (2, "float32"),
                                     (4, "float64")])
def test_sweep_functions_match_jax(clusters, n, dtype):
    """cp.dt_sweep, cp.pp_build_caches (constrained) and two cp.pp_sweeps
    with layout=: every rank's gathered result against JAX's sharded run
    and against one process's function on the padded V; padded rows of
    every factor exactly zero; bitwise equal on every rank."""
    tol = F64 if dtype == "float64" else F32
    layout, want = _jax_functions(clusters["prob"], MESHES[n], dtype)
    results = clusters["res"][n]
    for res in results:
        for key, w in want.items():
            got = res[f"{dtype}/{key}"]
            _rel_close(got, w, tol)
            assert float(res[f"err/{dtype}/{key}"]) <= tol, key
            if "/W" in key:
                m = int(key[-1])
                assert not np.any(got[FUNC_SHAPE[m]:]), key
    _same_on_ranks(results, [f"{dtype}/{k}" for k in want])
    assert layout.padded_shape != FUNC_SHAPE


def _jax_tucker_functions(prob, mesh_shape):
    mesh = jax_mesh(mesh_shape)
    layout = jmesh.plan_layout(FUNC_SHAPE, mesh)
    Vs = jmesh.shard_tensor(prob["Vf"], layout)
    core, W0 = jtk.hosvd(Vs, FUNC_RANKS)
    want = {"hosvd/core": core}
    Wd, cd = jtk.tucker_dt_sweep(Vs, list(W0), list(W0), ranks=FUNC_RANKS,
                                 use_sign=True)
    want["tdt/core"] = cd
    single, pair = jtk.tucker_build_caches(Vs, list(W0))
    want.update({f"tsingle/{i}": x for i, x in single.items()})
    want.update({f"tpair/{i}_{j}": x for (i, j), x in pair.items()})
    dW = [a - b for a, b in zip(Wd, W0)]
    Wq, _, cq, _ = jtk.tucker_pp_sweep(single, pair, list(Wd), list(W0), dW,
                                       ranks=FUNC_RANKS)
    want["tpp/core"] = cq
    for m in range(len(FUNC_SHAPE)):
        want[f"hosvd/W{m}"], want[f"tdt/W{m}"] = W0[m], Wd[m]
        want[f"tpp/W{m}"] = Wq[m]
    return {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("n", sorted(MESHES))
def test_tucker_functions_match_jax(clusters, n):
    """tucker.hosvd (the sharded modes' Grams assembled block by block),
    tucker_dt_sweep and tucker_pp_sweep (the sharded mode extracted on the
    mode side from gathered rows), tucker_build_caches (constrained):
    against JAX's sharded run to RUN, one process's to 1e-12; padded rows
    of the factors zero to 1e-12; bitwise equal on every rank."""
    want = _jax_tucker_functions(clusters["prob"], MESHES[n])
    results = clusters["res"][n]
    for res in results:
        for key, w in want.items():
            _rel_close(res[f"float64/{key}"], w, RUN)
            assert float(res[f"err/float64/{key}"]) <= F64, key
            if "/W" in key:
                pad = res[f"float64/{key}"][FUNC_SHAPE[int(key[-1])]:]
                assert np.max(np.abs(pad), initial=0.0) <= F64, key
    _same_on_ranks(results, [f"float64/{k}" for k in want])


# -------------------------------------------------------------------------
# The engines
# -------------------------------------------------------------------------


def _hist(res, keys):
    return np.asarray([[h[k] for k in keys] for h in res.history])


@pytest.mark.parametrize("n", sorted(MESHES))
@pytest.mark.parametrize("pp", [1, 2])
def test_cp_pp_trajectory_matches_jax(clusters, n, pp):
    """cp.als_cp_pp with mesh_layout (-pp 1, and -pp 2's partial updates)
    against JAX's on its sharded arrays with its mesh_layout: the same
    rows and DT <-> PP decisions, gradnorm and diffV along the run and
    the factors to 1e-9; the ranks' histories and factors bitwise
    equal."""
    prob = clusters["prob"]
    layout = jmesh.plan_layout(CP_SHAPE, jax_mesh(MESHES[n]))
    cfg = jcp.CPConfig(**CP_CFG, mesh_layout=layout)
    rj = jcp.als_cp_pp(jmesh.shard_tensor(prob["Vc"], layout),
                       list(jmesh.shard_factors(prob["Wc"], layout)), cfg,
                       partial_update=pp == 2)
    want = _hist(rj, ("iter", "gradnorm", "diffV", "pp"))
    assert want[:, 3].sum() > 0 and 0 in want[:, 3], "no DT <-> PP switch"
    results = clusters["res"][n]
    for res in results:
        got = res[f"dcp{pp}_hist/float64"]
        assert got.shape == want.shape
        np.testing.assert_array_equal(got[:, [0, 3]], want[:, [0, 3]])
        np.testing.assert_allclose(got[:, 1:3], want[:, 1:3], rtol=TRAJ)
        for i in range(len(CP_SHAPE)):
            _rel_close(res[f"dcp{pp}_W/float64/{i}"],
                       np.asarray(rj.factors[i])[:CP_SHAPE[i]], TRAJ)
    keys = [f"dcp{pp}_hist/float64"] + [f"dcp{pp}_W/float64/{i}"
                                        for i in range(len(CP_SHAPE))]
    _same_on_ranks(results, keys)


@pytest.mark.parametrize("n", sorted(MESHES))
def test_tucker_pp_trajectory_matches_jax(clusters, n, monkeypatch):
    """tucker.als_tucker_pp with mesh_layout from the sharded HOSVD with
    JAX's draws (mode 2 by matrix-free subspace iteration; on 2x2 mode 1's
    Gram assembled), against JAX's run on its sharded V with the same
    threshold: the same decisions (two PP phases or more), diffV to RUN,
    diffnorm to RUN of ||V||, factors and core to RUN; bitwise equal on
    every rank."""
    prob = clusters["prob"]
    vn = _vn(prob["Vt"])
    monkeypatch.setattr(jtk, "HOSVD_EXACT_EIGH_MAX", TK_EXACT_MAX)
    layout = jmesh.plan_layout(TK_SHAPE, jax_mesh(MESHES[n]))
    rj = jtk.als_tucker_pp(jmesh.shard_tensor(prob["Vt"], layout), TK_RANKS,
                           jtk.TuckerConfig(tol=1e-12 * vn, **TK_CFG,
                                            mesh_layout=layout))
    flags = [h["pp"] for h in rj.history]
    assert sum(1 for a, b in zip(flags, flags[1:]) if (a, b) == (0, 1)) >= 2
    results = clusters["res"][n]
    for res in results:
        got = res["dtk_hist/float64"]
        assert [tuple(r) for r in got[:, [0, 3]]] == \
            [(h["iter"], h["pp"]) for h in rj.history]
        for row, h in zip(got, rj.history):
            assert abs(row[2] - h["diffV"]) <= RUN * abs(h["diffV"])
            assert abs(row[1] - h["diffnorm"]) <= RUN * vn
        for i in range(len(TK_SHAPE)):
            _rel_close(res[f"dtk_W/float64/{i}"],
                       np.asarray(rj.factors[i])[:TK_SHAPE[i]], RUN)
        _rel_close(res["dtk_core/float64"], rj.core, RUN)
    _same_on_ranks(results, ["dtk_core/float64", "dtk_hist/float64"])


# -------------------------------------------------------------------------
# The CLI under torchrun
# -------------------------------------------------------------------------


def _csv(path):
    with open(path) as fh:
        return list(csv.reader(fh))


@pytest.fixture(scope="module")
def unsharded_cli(clusters, tmp_path_factory):
    """The CLI runs of the 2-rank cluster again in this process, without
    -mesh (the datasets' file shapes shrunk as the ranks shrank them)."""
    tmp = clusters["tmp"]
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(tio, "COIL100_FILE_SHAPE", COIL_FILE)
        mp.setattr(tio, "TIME_LAPSE_FILE_SHAPE", LAPSE_FILE)
        rcs = {n: cli.main(_cli_argv(tmp, n, "one")) for n in CLI_RUNS}
    finally:
        mp.undo()
    return tmp, rcs


def _vnorm_of(name, tmp):
    if name in ("o1", "o2"):
        shape = COIL_FILE if name == "o1" else LAPSE_FILE
        return _vn(np.fromfile(tmp / f"{name}.bin", "<f8").reshape(shape))
    return None


@pytest.mark.parametrize("name", ["cp_pp1", "cp_pp2", "tucker", "o1", "o2",
                                  "resume"])
def test_cli_mesh_csv_matches_unsharded(clusters, unsharded_cli, name):
    """test_als -mesh 2 (dense CP -pp 1 and 2, Tucker -pp 1, o1 and o2 read
    block by block, CP from a -resume checkpoint's factors, zero-padded
    to the blocks) writes the CSV of the port's own unsharded run: the
    same rows and [pp_update], [gradnorm] / [diffV] to 1e-10 relative
    ([diffnorm], a difference of core norms, to 1e-10 of ||V||); rank 0
    alone writes."""
    tmp, rcs = unsharded_cli
    assert rcs[name] == 0
    assert [int(x) for x in clusters["res"][2][0]["cli_rc"]] == \
        [0] * len(CLI_RUNS)
    got, want = _csv(tmp / f"{name}_mesh.csv"), _csv(tmp / f"{name}_one.csv")
    assert got[0] == want[0] and len(got) == len(want) > 3
    if name != "o2":
        assert {float(r[4]) for r in want[1:]} == {0.0, 1.0}
    core_norm = max(float(r[5]) for r in want[1:])
    for g, w in zip(got[1:], want[1:]):
        for col, a, b in zip(want[0], g, w):
            a, b = float(a), float(b)
            if col in ("[gradnorm]", "[diffV]"):
                assert abs(a - b) <= CLI_TOL * abs(b), (col, g, w)
            elif col == "[diffnorm]":
                assert abs(a - b) <= CLI_TOL * core_norm, (col, g, w)
            elif col != "[dtime]":
                assert a == b, (col, g, w)


def test_cli_mesh_checkpoint_is_unsharded(unsharded_cli):
    """-checkpoint under -mesh 2: rank 0 writes the whole factors (padding
    stripped), within 1e-10 of the unsharded run's."""
    tmp, _ = unsharded_cli
    got = tio.load_checkpoint(str(tmp / "ck_mesh.npz"))
    want = tio.load_checkpoint(str(tmp / "ck_one.npz"))
    assert got["iteration"] == want["iteration"]
    assert [W.shape for W in got["factors"]] == [(9, 3)] * 3
    for a, b in zip(got["factors"], want["factors"]):
        _rel_close(a, b, CLI_TOL)


@pytest.mark.parametrize("name", ["cp_f32", "cp_bf16"])
def test_cli_mesh_takes_f32_and_bf16(unsharded_cli, name):
    """-dtype float32 and bfloat16 under -mesh 2 write the unsharded run's
    rows (iterations) with finite values. float32 keeps its decisions,
    [gradnorm] and [diffV] to 1e-3 relative (round-off of float32 sums
    over 9^3 entries, grown over 15 sweeps). bf16-stored V holds row 0 to
    1e-5: the sharded sums round in another order, and the bf16 PP phases
    amplify that (the rows part after a few PP sweeps, as two bf16 runs of
    different summation orders do)."""
    tmp, _ = unsharded_cli
    got, want = _csv(tmp / f"{name}_mesh.csv"), _csv(tmp / f"{name}_one.csv")
    assert len(got) == len(want) > 3
    assert [g[1] for g in got] == [w[1] for w in want]
    assert all(np.isfinite(float(x)) for g in got[1:] for x in g)
    rows = want[1:] if name == "cp_f32" else want[1:2]
    for g, w in zip(got[1:], rows):
        assert g[4] == w[4]
        for k in (2, 5):
            assert abs(float(g[k]) - float(w[k])) <= \
                (1e-3 if name == "cp_f32" else 1e-5) * abs(float(w[k]))


@pytest.mark.parametrize("model", ["cp", "tucker"])
def test_pp_bench_mesh_rows(unsharded_cli, model):
    """pp_bench -mesh 2 writes, from rank 0, the unsharded run's rows:
    -maxiter [DTtime] rows, then [PPfirst]/[PPsecond] pairs."""
    tmp, _ = unsharded_cli
    got = _csv(tmp / f"bench_{model}_mesh.csv")
    want = _csv(tmp / f"bench_{model}_one.csv")
    assert [r[0] for r in got] == [r[0] for r in want] == \
        ["[timetype]"] + ["[DTtime]"] * 2 + ["[PPfirst]", "[PPsecond]"] * 2
    assert all(float(r[1]) > 0 for r in got[1:])


ONE_RANK_RUNS = ("cp_pp1", "cp_pp2", "cp_f32", "tucker")


def test_cli_world_of_one_writes_the_unsharded_csv(clusters, unsharded_cli):
    """torchrun --nproc_per_node 1 with -mesh 1: a mode mapped to an axis
    of one rank is not split (parallel/mesh.is_sharded), so every hook is
    the identity and each CSV is the unsharded run's bit for bit but for
    [dtime] (CP -pp 1, -pp 2, float32, Tucker)."""
    tmp, _ = unsharded_cli
    argv = [[a if a != "2" or argv[k - 1] != "-mesh" else "1"
             for k, a in enumerate(argv)]
            for argv in (_cli_argv(tmp, n, "mesh") for n in ONE_RANK_RUNS)]
    for a, n in zip(argv, ONE_RANK_RUNS):
        a[a.index("-filename") + 1] = str(tmp / f"{n}_world1.csv")
        if "-checkpoint" in a:
            a[a.index("-checkpoint") + 1] = str(tmp / "ck_world1")
    np.savez(tmp / "in_1.npz", cli_argv=json.dumps(argv))
    rc, log = run_cluster(1, WORKER + [
        "--inputs", tmp / "in_1.npz", "--outdir", tmp / "out1", "--tasks",
        "cli", "--device", "cpu"], timeout=CLUSTER_S)
    assert rc == 0, log[-4000:]
    for n in ONE_RANK_RUNS:
        got = _csv(tmp / f"{n}_world1.csv")
        want = _csv(tmp / f"{n}_one.csv")
        assert len(got) == len(want) > 3
        for g, w in zip(got, want):
            assert g[:6] == w[:6], (n, g, w)


# -------------------------------------------------------------------------
# The hooks without a layout
# -------------------------------------------------------------------------


def test_hooks_are_the_identity_without_a_layout():
    xs = [torch.ones(3), torch.zeros(2, 2)]
    for out in (pmesh.reduce_parts([(x, (0,)) for x in xs], None),
                pmesh.reduce_modes(xs, None, (1,)),
                pmesh.row_sum(xs, [0, 1], None)):
        assert all(a is b for a, b in zip(out, xs))
    assert pmesh.gather_rows(xs[0], 0, None) is xs[0]
    assert not pmesh.is_sharded(None, 0)


def test_unsharded_engines_take_no_layout_by_default():
    """CPConfig and TuckerConfig default to no layout: the unsharded path
    is the engines' default."""
    from pairwise_perturbation_tpu_torch.models import tucker
    assert tcp.CPConfig().mesh_layout is None
    assert tucker.TuckerConfig().mesh_layout is None
