"""The device engines on a block-sharded V (``-mesh`` with ``-device_loop
1`` and ``2``): cp.als_cp_pp_device, cp.als_cp_pp_fused,
tucker.als_tucker_pp_device and tucker.als_tucker_pp_fused with
``mesh_layout``, each rank on its block, held to the port's own
unsharded runs of the same engines (which tests/test_torch_device_loop.py,
test_torch_fused.py and test_torch_tucker_device.py hold to the JAX
package's).

Three real torchrun clusters of gloo ranks on the CPU
(scripts/multiprocess_worker.py, tasks ``dcp`` and ``dtucker`` with
``dc_loops`` / ``dt_loops``): two ranks on a (2,) mesh (float64 and
float32, and the CLI's -mesh 2 runs), four on a 2x2 mesh (float64), and
a world of one on a (1,) mesh. The problems are
tests/test_torch_mesh_dense.py's, whose sharded modes are padded.

Tolerances: float64 rows and factors 1e-9 relative with identical rows and
PP flags (Tucker's diffnorm, a difference of core norms, to 1e-9 of
||V||); float32 by the fit, the last row's diffV to F32_FIT relative (the
sharded sums round in another order, and a float32 phase machine may
then switch phases a sweep apart); every rank bitwise equal; a world of
one bit for bit the unsharded run but for [dtime]; the CLI's CSVs 1e-10
relative, as tests/test_torch_mesh_dense.py holds the host engines'.
"""

import csv
import json

import numpy as np
import pytest
import torch

from pairwise_perturbation_tpu_torch import cli
from pairwise_perturbation_tpu_torch.models import cp as tcp
from pairwise_perturbation_tpu_torch.models import tucker as ttk
from pairwise_perturbation_tpu_torch.scripts.multiprocess_worker import \
    WORKER, run_cluster

from test_torch_mesh_dense import (CP_CFG, CP_SHAPE, TK_CFG, TK_RANKS,
                                   TK_SHAPE, _problem, _vn)
from test_torch_tucker import assert_close

torch.set_num_threads(1)

TRAJ = 1e-9
F32_FIT = 1e-3
CLI_TOL = 1e-10
CLUSTER_S = 120.0
MESHES = {1: (1,), 2: (2,), 4: (2, 2)}
LOOPS = (1, 2)
CP_ENGINES = {1: tcp.als_cp_pp_device, 2: tcp.als_cp_pp_fused}
TK_ENGINES = {1: ttk.als_tucker_pp_device, 2: ttk.als_tucker_pp_fused}

CLI_BASE = ["-rank", "3", "-maxiter", "15", "-resprint", "1",
            "-pp_res_tol", "0.1", "-device", "cpu", "-dtype", "float64"]
CLI_RUNS = {
    "cp_dl1": ["-model", "CP", "-tensor", "r", "-dim", "3", "-size", "9",
               "-pp", "1", "-device_loop", "1"],
    "cp_dl2": ["-model", "CP", "-tensor", "r", "-dim", "3", "-size", "9",
               "-pp", "1", "-device_loop", "2"],
    "cp_dl2_layouts": ["-model", "CP", "-tensor", "r", "-dim", "4", "-size",
                       "5", "-pp", "1", "-device_loop", "2", "-layouts",
                       "1"],
    "cp_dt_layouts": ["-model", "CP", "-tensor", "r", "-dim", "3", "-size",
                      "9", "-pp", "0", "-layouts", "1"],
    "tk_dl1": ["-model", "Tucker", "-tensor", "r2", "-dim", "3", "-size",
               "9", "-pp", "1", "-device_loop", "1"],
    "tk_dl2": ["-model", "Tucker", "-tensor", "r2", "-dim", "3", "-size",
               "9", "-pp", "1", "-device_loop", "2"],
}


def _cli_argv(tmp, name, mesh):
    argv = ["test_als"] + CLI_BASE + CLI_RUNS[name] + [
        "-quiet", "-filename", str(tmp / f"{name}_{mesh}.csv")]
    return argv + (["-mesh", "2"] if mesh == "mesh" else [])


def _inputs(tmp, prob, n):
    d = dict(dd_mesh=np.asarray(MESHES[n]), dc_V=prob["Vc"],
             dc_cfg=json.dumps(CP_CFG), dc_pp=np.asarray([], np.int64),
             dc_loops=np.asarray(LOOPS), dt_V=prob["Vt"],
             dt_ranks=np.asarray(TK_RANKS), dt_host=0,
             dt_loops=np.asarray(LOOPS),
             dt_tk_cfg=json.dumps(dict(tol=1e-12 * _vn(prob["Vt"]),
                                       **TK_CFG)))
    for i, W in enumerate(prob["Wc"]):
        d[f"dc_W{i}"] = W
    if n == 2:
        d["cli_argv"] = json.dumps([_cli_argv(tmp, name, "mesh")
                                    for name in CLI_RUNS])
    path = tmp / f"in_{n}.npz"
    np.savez(path, **d)
    return path


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """The device engines on 1, 2 and 2x2 ranks (float32 too on 2, with
    the CLI runs), each rank's results."""
    tmp = tmp_path_factory.mktemp("mesh_device")
    prob = _problem()
    out = {}
    for n in MESHES:
        rc, log = run_cluster(n, WORKER + [
            "--inputs", _inputs(tmp, prob, n), "--outdir", tmp / f"out{n}",
            "--tasks", "dcp,dtucker" + (",cli" if n == 2 else ""),
            "--device", "cpu", "--dtypes",
            "float64,float32" if n == 2 else "float64"], timeout=CLUSTER_S)
        assert rc == 0, log[-4000:]
        out[n] = [dict(np.load(tmp / f"out{n}" / f"result_{r}.npz"))
                  for r in range(n)]
    return dict(prob=prob, tmp=tmp, res=out)


@pytest.fixture(scope="module")
def unsharded(clusters):
    """The four engines without a layout, in this process, per dtype."""
    prob = clusters["prob"]
    out = {}
    for dtype in (torch.float64, torch.float32):
        V = torch.from_numpy(prob["Vc"]).to(dtype)
        Ws = [torch.from_numpy(W).to(dtype) for W in prob["Wc"]]
        Vt = torch.from_numpy(prob["Vt"]).to(dtype)
        tk_cfg = ttk.TuckerConfig(tol=1e-12 * _vn(prob["Vt"]), **TK_CFG)
        for loop in LOOPS:
            out[("dcl", loop, dtype)] = CP_ENGINES[loop](
                V, list(Ws), tcp.CPConfig(**CP_CFG))
            out[("dtl", loop, dtype)] = TK_ENGINES[loop](Vt, TK_RANKS,
                                                         tk_cfg)
    return out


def _hist(r, metric):
    return np.asarray([[h["iter"], h[metric], h["diffV"], h["pp"]]
                       for h in r.history], np.float64)


@pytest.mark.parametrize("loop", LOOPS)
@pytest.mark.parametrize("n", [2, 4])
def test_cp_device_engines_match_unsharded(clusters, unsharded, n, loop):
    """cp.als_cp_pp_device (1) and cp.als_cp_pp_fused (2) on a (2,) and a
    2x2 mesh, float64: the unsharded run's rows and DT <-> PP decisions,
    gradnorm and diffV to 1e-9, factors to 1e-9."""
    want = unsharded[("dcl", loop, torch.float64)]
    ref = _hist(want, "gradnorm")
    assert 0 in ref[:, 3] and 1 in ref[:, 3], "no DT <-> PP switch"
    for res in clusters["res"][n]:
        got = res[f"dcl{loop}_hist/float64"]
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got[:, [0, 3]], ref[:, [0, 3]])
        np.testing.assert_allclose(got[:, 1:3], ref[:, 1:3], rtol=TRAJ)
        for i in range(len(CP_SHAPE)):
            assert_close(res[f"dcl{loop}_W/float64/{i}"],
                         want.factors[i].numpy(), TRAJ)


@pytest.mark.parametrize("loop", LOOPS)
@pytest.mark.parametrize("n", [2, 4])
def test_tucker_device_engines_match_unsharded(clusters, unsharded, n,
                                               loop):
    """tucker.als_tucker_pp_device (1) and als_tucker_pp_fused (2) from
    the sharded HOSVD on a (2,) and a 2x2 mesh, float64: the unsharded
    run's rows and decisions (PP phases in them), diffV to 1e-9, diffnorm
    to 1e-9 of ||V||, factors and core to 1e-9."""
    want = unsharded[("dtl", loop, torch.float64)]
    ref = _hist(want, "diffnorm")
    assert 1 in ref[:, 3]
    vn = _vn(clusters["prob"]["Vt"])
    for res in clusters["res"][n]:
        got = res[f"dtl{loop}_hist/float64"]
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got[:, [0, 3]], ref[:, [0, 3]])
        np.testing.assert_allclose(got[:, 2], ref[:, 2], rtol=TRAJ)
        fin = np.isfinite(ref[:, 1])
        np.testing.assert_array_equal(np.isfinite(got[:, 1]), fin)
        assert np.all(np.abs(got[fin, 1] - ref[fin, 1]) <= TRAJ * vn)
        for i in range(len(TK_SHAPE)):
            assert_close(res[f"dtl{loop}_W/float64/{i}"],
                         want.factors[i].numpy(), TRAJ)
        assert_close(res[f"dtl{loop}_core/float64"], want.core.numpy(),
                     TRAJ)


@pytest.mark.parametrize("engine", ["dcl1", "dcl2", "dtl1", "dtl2"])
def test_device_engines_f32_by_fit(clusters, unsharded, engine):
    """float32 on the (2,) mesh: finite rows, and the last row's diffV
    within F32_FIT of the unsharded float32 run's (the runs may stop at
    different rows: a float32 diffnorm can reach 0.0, which passes the
    convergence test)."""
    want = unsharded[(engine[:3], int(engine[3]), torch.float32)]
    ref = _hist(want, "gradnorm" if engine[1] == "c" else "diffnorm")
    for res in clusters["res"][2]:
        got = res[f"{engine}_hist/float32"]
        assert len(got) > 3 and len(ref) > 3
        assert np.all(np.isfinite(got[:, 2]))
        assert abs(got[-1, 2] - ref[-1, 2]) <= F32_FIT * abs(ref[-1, 2])


@pytest.mark.parametrize("n", [2, 4])
def test_device_engines_bitwise_on_every_rank(clusters, n):
    """Every rank's histories, factors and cores are the same bits: each
    flag the host read was computed from all-reduced values."""
    results = clusters["res"][n]
    keys = [k for k in results[0] if k.startswith("sha/d")]
    assert len(keys) >= 4 * (len(CP_SHAPE) + 1)
    for res in results[1:]:
        for k in keys:
            assert np.array_equal(res[k], results[0][k]), k


@pytest.mark.parametrize("engine", ["dcl1", "dcl2", "dtl1", "dtl2"])
def test_device_engines_world_of_one_bit_for_bit(clusters, unsharded,
                                                 engine):
    """A world of one on a (1,) mesh: no mode is split, so every hook is
    the identity and the rows (but [dtime]) and factors are the unsharded
    run's bit for bit."""
    want = unsharded[(engine[:3], int(engine[3]), torch.float64)]
    metric = "gradnorm" if engine[1] == "c" else "diffnorm"
    res = clusters["res"][1][0]
    np.testing.assert_array_equal(res[f"{engine}_hist/float64"],
                                  _hist(want, metric))
    for i, W in enumerate(want.factors):
        np.testing.assert_array_equal(res[f"{engine}_W/float64/{i}"],
                                      W.numpy())


def _csv(path):
    with open(path) as fh:
        return list(csv.reader(fh))


@pytest.fixture(scope="module")
def unsharded_cli(clusters):
    tmp = clusters["tmp"]
    return tmp, {n: cli.main(_cli_argv(tmp, n, "one")) for n in CLI_RUNS}


@pytest.mark.parametrize("name", sorted(CLI_RUNS))
def test_cli_mesh_device_loop_csv_matches_unsharded(clusters, unsharded_cli,
                                                    name):
    """test_als -mesh 2 -device_loop 1 and 2 (CP and Tucker; CP's fused
    machine and DT-ALS with -layouts 1 too) writes the CSV of the port's
    own unsharded run: the same rows and [pp_update], [gradnorm] / [diffV]
    to 1e-10 relative ([diffnorm] to 1e-10 of the largest [diffV]); rank
    0 alone writes."""
    tmp, rcs = unsharded_cli
    assert rcs[name] == 0
    assert [int(x) for x in clusters["res"][2][0]["cli_rc"]] == \
        [0] * len(CLI_RUNS)
    got, want = _csv(tmp / f"{name}_mesh.csv"), _csv(tmp / f"{name}_one.csv")
    assert got[0] == want[0] and len(got) == len(want) > 3
    if "dt_" not in name:
        assert {float(r[4]) for r in want[1:]} == {0.0, 1.0}
    scale = max(float(r[5]) for r in want[1:])
    for g, w in zip(got[1:], want[1:]):
        for col, a, b in zip(want[0], g, w):
            a, b = float(a), float(b)
            if col in ("[gradnorm]", "[diffV]"):
                assert abs(a - b) <= CLI_TOL * abs(b), (col, g, w)
            elif col == "[diffnorm]":
                assert a == b or abs(a - b) <= CLI_TOL * scale, (col, g, w)
            elif col != "[dtime]":
                assert a == b, (col, g, w)
