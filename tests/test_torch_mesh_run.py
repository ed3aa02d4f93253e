"""``run -mesh``: the five second-gen optimizers on a block-sharded V
(``CPD.init``/``CPOptimizer.configure(..., layout)``, the chain functions'
and the low-rank kit's ``layout=``), against the port's unsharded steps
and the JAX package's unsharded ``msdt_cycle``, on the same numpy inputs.

Three real torchrun clusters of gloo ranks on the CPU
(scripts/multiprocess_worker.py, tasks ``drun`` and ``cli``, 120 s each):
two ranks on a (2,) mesh (float64 and float32), four on a 2x2 mesh
(float64), and a world of one. V's shape (6, 9, 15, 5) pads its sharded
modes (15 -> 16; on 2x2 also 9 -> 10). Each rank gathers its factors
whole (padded), so every result is held to one process's run on the
unpadded V and compared bit for bit across the ranks.

Tolerances: float64 1e-9 relative (max-norm) after every step, as JAX
tests/test_parallel.py:170-186 holds its sharded cycle (there 1e-7
relative, 1e-9 absolute); float32 F32_TOL; the low-rank kit's (U s) VT
1e-10 of its largest entry; the CLI's CSV columns 1e-10 relative, [dtime]
aside; a world of one bit for bit.
"""

import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pairwise_perturbation_tpu.models import optimizers as jopt
from pairwise_perturbation_tpu.ops import solve as jsolve
from pairwise_perturbation_tpu_torch import cli
from pairwise_perturbation_tpu_torch.ops import solve as tsolve
from pairwise_perturbation_tpu_torch.scripts.multiprocess_worker import \
    WORKER, run_cluster

torch.set_num_threads(1)

F64 = 1e-9
# float32 after up to 8 steps: sums over the blocks in another order,
# grown through the Cholesky solves and the low-rank truncations (1.5e-5
# seen on the CPU).
F32_TOL = 1e-4
SVD_TOL = 1e-10
CLI_TOL = 1e-10
# ||V|| summed from the blocks against the host array's norm (float64)
NORM_TOL = 1e-14
CLUSTER_S = 120.0
SHAPE, R = (6, 9, 15, 5), 3
MESHES = {2: (2,), 4: (2, 2)}
# JAX's msdt_cycle(start_left=order - 1) holds out 2, 1, 0, 3 in turn
CYCLE_LEFTS = (2, 1, 0, 3)
# Each optimizer's steps; the LR optimizers take eight, so that their
# cached tops are refreshed by the low-rank update (DT-LR from the fifth
# step, MSDT-LR once every mode is cached); min_holdout_size 7 holds out
# modes 1 and 2 only (padded 10 and 16 on 2x2, still >= 7).
RUNS = [
    dict(tag="dt", pp=0, steps=4),
    dict(tag="msdt", pp=1, steps=4),
    dict(tag="msdt_holdout", pp=1, steps=4, opts=dict(msdt_min_holdout=7)),
    dict(tag="msdt_cycle", pp=1, steps=2, macro=True),
    dict(tag="dtlr", pp=2, steps=8, opts=dict(updaterank=2)),
    dict(tag="dtlr_random", pp=2, steps=8,
         opts=dict(updaterank=2, randomsvd=True, seed=5)),
    dict(tag="msdtlr", pp=3, steps=8, opts=dict(updaterank=2)),
    dict(tag="simple", pp=4, steps=3),
]
# cli.run_cpd (run's ALS loop with its diagnostics rows) on the blocks
ALS_RUNS = [dict(tag="als_msdtlr", pp=3, maxiter=4, resprint=1,
                 opts=dict(updaterank=2)),
            dict(tag="als_cycle", pp=1, maxiter=6, resprint=1, macro=True)]
# (name, rows, columns, r, randomized): mode 2's rows (15, padded 16);
# 16 >= 4n takes the Gram route for n = 3 (the unsharded 15 rows would
# not), and n = 5 the gathered torch.linalg.svd.
SVD_CHECKS = [("tall", 3, 2, False), ("wide", 5, 3, False),
              ("tall_random", 3, 2, True), ("wide_random", 5, 3, True)]
SVD_MODE = 2
CLI_BASE = ["run", "-tensor", "r", "-dim", "4", "-size", "7", "-rank", "3",
            "-maxiter", "8", "-resprint", "1", "-dtype", "float64",
            "-device", "cpu", "-quiet"]
CLI_RUNS = {
    "dt": ["-pp", "0"], "msdt": ["-pp", "1"], "dtlr": ["-pp", "2"],
    "msdtlr": ["-pp", "3"], "simple": ["-pp", "4"],
    "cycle": ["-pp", "1", "-device_loop", "1"],
    "dtlr_random": ["-pp", "2", "-randomsvd", "1", "-updaterank", "2"],
}
ONE_RANK_RUNS = ("dt", "cycle", "dtlr_random", "simple")


def _problem():
    rng = np.random.default_rng(11)
    truth = [rng.random((s, R)) for s in SHAPE]
    V = np.einsum("ar,br,cr,dr->abcd", *truth)
    V = V + 0.01 * np.linalg.norm(V) / np.sqrt(V.size) \
        * rng.standard_normal(SHAPE)
    W0 = [rng.random((s, R)) for s in SHAPE]
    svd = {}
    for name, n, r, random in SVD_CHECKS:
        svd[f"dr_A_{name}"] = rng.standard_normal((SHAPE[SVD_MODE], n))
        if random:
            svd[f"dr_X_{name}"] = np.asarray(jax.random.uniform(
                jax.random.PRNGKey(n + r), (n, r), dtype=jnp.float64))
    return V, W0, svd


def _argv(tmp, name, mesh):
    return CLI_BASE + CLI_RUNS[name] + [
        "-filename", str(tmp / f"{name}_{mesh}.csv")] + \
        ([] if mesh == "one" else ["-mesh", mesh])


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh_run")
    V, W0, svd = _problem()
    checks = [dict(name=name, A=f"dr_A_{name}", mode=SVD_MODE, r=r,
                   X=f"dr_X_{name}" if random else None)
              for name, _, r, random in SVD_CHECKS]
    out = {}
    for n, shape in MESHES.items():
        mesh = "x".join(str(s) for s in shape)
        path = tmp / f"in_{n}.npz"
        np.savez(path, dd_mesh=np.asarray(shape), dr_V=V,
                 dr_runs=json.dumps([dict(r, each=True) for r in RUNS]
                                    + ALS_RUNS),
                 dr_lefts=np.asarray(CYCLE_LEFTS), dr_svd=json.dumps(checks),
                 cli_argv=json.dumps([_argv(tmp, k, mesh)
                                      for k in CLI_RUNS]),
                 **{f"dr_W{i}": W for i, W in enumerate(W0)}, **svd)
        rc, log = run_cluster(n, WORKER + [
            "--inputs", path, "--outdir", tmp / f"out{n}", "--tasks",
            "drun,cli", "--device", "cpu", "--dtypes",
            "float64,float32" if n == 2 else "float64"], timeout=CLUSTER_S)
        assert rc == 0, log[-4000:]
        out[n] = [dict(np.load(tmp / f"out{n}" / f"result_{r}.npz"))
                  for r in range(n)]
    return dict(tmp=tmp, V=V, W0=W0, svd=svd, res=out)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1e-300)


def _same_on_ranks(results, prefix):
    keys = [k for k in results[0] if k.startswith(f"sha/{prefix}")]
    assert keys
    for res in results[1:]:
        for k in keys:
            assert np.array_equal(res[k], results[0][k]), k


def _unsharded(spec, V, W0, dtype):
    """The port's run optimizer of ``spec`` in one process on the
    unpadded V: its factors after each step."""
    o = cli.run_optimizer(spec["pp"], len(SHAPE), R, **spec.get("opts", {}))
    o.configure(torch.from_numpy(V).to(dtype),
                [torch.from_numpy(W).to(dtype) for W in W0], 0.0)
    fn = o.step_cycle if spec.get("macro") else o.step
    out = []
    for _ in range(spec["steps"]):
        fn()
        out.append([W.numpy() for W in o.W])
    return out


@pytest.mark.parametrize("n,dtype", [(2, "float64"), (2, "float32"),
                                     (4, "float64")])
@pytest.mark.parametrize("spec", RUNS, ids=[r["tag"] for r in RUNS])
def test_run_optimizer_steps_match_unsharded(clusters, spec, n, dtype):
    """Every step of the optimizer on the ranks' blocks equals one
    process's step on the whole V; the padded rows stay zero; every rank
    holds the same factors bit for bit."""
    tol = F64 if dtype == "float64" else F32_TOL
    want = _unsharded(spec, clusters["V"], clusters["W0"],
                      getattr(torch, dtype))
    results = clusters["res"][n]
    tag = spec["tag"]
    for res in results:
        for k, Ws in enumerate(want):
            for m, W in enumerate(Ws):
                got = res[f"run/{dtype}/{tag}/{k}/{m}"]
                assert _rel(got[:SHAPE[m]], W) <= tol, (k, m)
                assert not np.any(got[SHAPE[m]:]), (k, m)
    _same_on_ranks(results, f"run/{dtype}/{tag}/")


@pytest.mark.parametrize("n,dtype", [(2, "float64"), (2, "float32"),
                                     (4, "float64")])
@pytest.mark.parametrize("spec", ALS_RUNS, ids=[r["tag"] for r in ALS_RUNS])
def test_run_cpd_history_matches_unsharded(clusters, spec, n, dtype):
    """cli.run_cpd with layout= (CPD.als: diagnostics summed over the
    blocks, rank 0's clock): the unsharded run's rows (the sweep count
    equal, gradnorm and diffV to the step tolerance) and final factors."""
    tol = F64 if dtype == "float64" else F32_TOL
    dt = getattr(torch, dtype)
    model = cli.run_cpd(torch.from_numpy(clusters["V"]).to(dt),
                        [torch.from_numpy(W).to(dt) for W in clusters["W0"]],
                        spec["pp"], tol=0.0, maxiter=spec["maxiter"],
                        resprint=spec["resprint"],
                        macro=spec.get("macro", False), **spec["opts"]
                        if "opts" in spec else {})
    want = np.asarray([[h["sweeps"], h["gradnorm"], h["diffV"]]
                       for h in model.history])
    for res in clusters["res"][n]:
        got = res[f"run_hist/{dtype}/{spec['tag']}"]
        assert got.shape == want.shape and len(want) > 2
        assert np.array_equal(got[:, 0], want[:, 0])
        assert np.all(np.abs(got[:, 1:] - want[:, 1:])
                      <= tol * np.abs(want[:, 1:]))
        for m, W in enumerate(model.W):
            got = res[f"run/{dtype}/{spec['tag']}/W/{m}"]
            assert _rel(got[:SHAPE[m]], W.numpy()) <= tol
    _same_on_ranks(clusters["res"][n], f"run_hist/{dtype}/{spec['tag']}")


@pytest.mark.parametrize("n", sorted(MESHES))
def test_msdt_cycle_matches_jax(clusters, n):
    """optimizers.msdt_cycle on the ranks' blocks against the JAX
    package's unsharded msdt_cycle from the same factors (JAX
    tests/test_parallel.py:170-186's check, on this mesh)."""
    want, _ = jopt.msdt_cycle(jnp.asarray(clusters["V"]),
                              [jnp.asarray(W) for W in clusters["W0"]],
                              jnp.asarray(0.0), start_left=len(SHAPE) - 1)
    for res in clusters["res"][n]:
        for m, W in enumerate(want):
            got = res[f"cycle/float64/{m}"]
            assert _rel(got[:SHAPE[m]], W) <= F64, m
    _same_on_ranks(clusters["res"][n], "cycle/float64/")


def _usv(usv):
    U, s, VT = (np.asarray(x) for x in usv)
    return (U * s) @ VT


@pytest.mark.parametrize("n", sorted(MESHES))
@pytest.mark.parametrize("name,cols,r,random", SVD_CHECKS,
                         ids=[c[0] for c in SVD_CHECKS])
def test_low_rank_kit_on_row_blocks(clusters, n, name, cols, r, random):
    """truncated_svd and randomized_svd of a row-sharded matrix: (U s) VT
    equals the unsharded call's and the JAX package's (randomized: with
    its jax.random draw); the route is the padded global shape's."""
    A = clusters["svd"][f"dr_A_{name}"]
    if random:
        X = clusters["svd"][f"dr_X_{name}"]
        port = tsolve.randomized_svd(torch.from_numpy(A), r,
                                     torch.from_numpy(np.array(X)))
        want = jsolve.randomized_svd(jnp.asarray(A), r,
                                     key=jax.random.PRNGKey(cols + r))
    else:
        port = tsolve.truncated_svd(torch.from_numpy(A), r)
        want = jsolve.truncated_svd(jnp.asarray(A), r)
    want = _usv(want)
    assert _rel(_usv(port), want) <= SVD_TOL
    for res in clusters["res"][n]:
        got = res[f"svd/float64/{name}"]
        assert _rel(got[:SHAPE[SVD_MODE]], want) <= SVD_TOL
        assert np.max(np.abs(got[SHAPE[SVD_MODE]:]), initial=0.0) <= \
            SVD_TOL * np.max(np.abs(want))
    _same_on_ranks(clusters["res"][n], f"svd/float64/{name}")


def _csv(path):
    with open(path) as fh:
        return list(csv.reader(fh))


@pytest.fixture(scope="module")
def unsharded_cli(clusters):
    tmp = clusters["tmp"]
    return {name: cli.main(_argv(tmp, name, "one")) for name in CLI_RUNS}


@pytest.mark.parametrize("n", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(CLI_RUNS))
def test_cli_run_mesh_csv_matches_unsharded(clusters, unsharded_cli, n,
                                            name):
    """run -mesh 2 and -mesh 2x2 (every optimizer, -device_loop 1,
    -randomsvd 1) write the unsharded run's CSV: the same rows, [dim] the
    unsharded tensor's, [gradnorm] and [diffV] to 1e-10 relative, [tol]
    (tol ||V||, under -mesh ||V|| summed from the blocks of r, formed
    block by block) to a few ulps, the rest equal but [dtime]; rank 0
    alone writes."""
    tmp = clusters["tmp"]
    assert unsharded_cli[name] == 0
    assert [int(x) for x in clusters["res"][n][0]["cli_rc"]] == \
        [0] * len(CLI_RUNS)
    mesh = "x".join(str(s) for s in MESHES[n])
    got, want = _csv(tmp / f"{name}_{mesh}.csv"), _csv(tmp / f"{name}_one.csv")
    assert got[0] == want[0] and len(got) == len(want) > 3
    for g, w in zip(got[1:], want[1:]):
        for col, a, b in zip(want[0], g, w):
            if col in ("[gradnorm]", "[diffV]"):
                assert abs(float(a) - float(b)) <= CLI_TOL * abs(float(b)), \
                    (col, g, w)
            elif col == "[tol]":
                assert abs(float(a) - float(b)) <= NORM_TOL * abs(float(b)), \
                    (col, g, w)
            elif col != "[dtime]":
                assert a == b, (col, g, w)


def test_cli_run_world_of_one_writes_the_unsharded_csv(clusters,
                                                       unsharded_cli):
    """torchrun --nproc_per_node 1 with run -mesh 1: no mode is split, so
    each CSV is the unsharded run's bit for bit but for [dtime]."""
    tmp = clusters["tmp"]
    argv = []
    for name in ONE_RANK_RUNS:
        a = _argv(tmp, name, "1")
        a[a.index("-filename") + 1] = str(tmp / f"{name}_world1.csv")
        argv.append(a)
    np.savez(tmp / "in_1.npz", cli_argv=json.dumps(argv))
    rc, log = run_cluster(1, WORKER + [
        "--inputs", tmp / "in_1.npz", "--outdir", tmp / "out1", "--tasks",
        "cli", "--device", "cpu"], timeout=CLUSTER_S)
    assert rc == 0, log[-4000:]
    for name in ONE_RANK_RUNS:
        got = _csv(tmp / f"{name}_world1.csv")
        want = _csv(tmp / f"{name}_one.csv")
        assert len(got) == len(want) > 3
        for g, w in zip(got, want):
            assert g[:6] == w[:6], (name, g, w)


def test_run_issparse_mesh_stays_refused():
    """run -issparse 1 -mesh is refused, as in the JAX package
    (cli.py:584-603)."""
    with pytest.raises(SystemExit, match="-issparse 1 is supported"):
        cli.main(["run", "-tensor", "p", "-issparse", "1", "-mesh", "2",
                  "-device", "cpu"])
