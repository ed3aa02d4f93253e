"""True multi-process parity of the port's nnz-sharded sparse functions:
the port of tests/test_multiprocess.py's sparse claim (fault C6, its
sharded half).

A torchrun world of two gloo ranks (scripts/multiprocess_worker.py, 120 s
a run) shards a seeded COO by nonzeros and runs the five sharded sparse
functions in float64 and float32; the run is made twice. The two ranks
agree bit for bit, the two runs agree bit for bit, and the result matches
one process (the unsharded functions here) to 1e-12 in float64 and 1e-5
in float32. On a card (the ``cuda`` test) the same holds for K7 on every
rank's shard, two ranks sharing the card over gloo.

The dense half of the claim: the same two ranks run the dense engines'
sweep functions on a block-sharded V (SHAPE, R 4, float64): the DT sweep,
the constrained PP caches and two PP sweeps, each gathered whole on
every rank. They agree bit for bit across the ranks and the two runs, and
lie within 1e-12 of one process's functions.
"""

import json

import numpy as np
import pytest
import torch

from pairwise_perturbation_tpu_torch.models import cp
from pairwise_perturbation_tpu_torch.ops import sparse as sp
from pairwise_perturbation_tpu_torch.scripts.multiprocess_worker import \
    WORKER, run_cluster

torch.set_num_threads(1)

SHAPE, R = (6, 8, 10, 12), 4
TOL = {"float64": 1e-12, "float32": 1e-5}


def _problem(shape=SHAPE, R=R, nnz=None, seed=13, tucker=True):
    """A seeded COO (as the root worker draws its sparse tensor), seeded
    CP factors and (with ``tucker``) orthonormal rank-2 Tucker factors, as
    numpy arrays."""
    rng = np.random.default_rng(seed)
    size = int(np.prod(shape))
    nnz = nnz or min(shape[0] * shape[1] * 4, size // 2)
    idx = np.stack(np.unravel_index(
        np.sort(rng.choice(size, size=nnz, replace=False)), shape), 1)
    d = dict(indices=idx.astype(np.int32), values=rng.standard_normal(nnz),
             shape=np.asarray(shape))
    for i, W in enumerate(cp.init_factors(shape, R, seed=3,
                                          dtype=torch.float64, device="cpu")):
        d[f"cp_W{i}"] = W.numpy()
        if tucker:
            d[f"tk_W{i}"] = np.linalg.qr(
                rng.standard_normal((shape[i], 2)))[0]
    return d


def _run(tmp, name, inputs, device="cpu", dtypes="float64,float32",
         arrays=True):
    argv = WORKER + ["--inputs", inputs, "--outdir", tmp / name, "--tasks",
                     "functions", "--device", device, "--dtypes", dtypes]
    rc, out = run_cluster(2, argv + (["--arrays"] if arrays else []),
                          timeout=120.0)
    assert rc == 0, out[-4000:]
    return [dict(np.load(tmp / name / f"result_{r}.npz")) for r in range(2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mp")
    data = _problem()
    np.savez(tmp / "in.npz", **data)
    return data, _run(tmp, "run1", tmp / "in.npz"), \
        _run(tmp, "run2", tmp / "in.npz")


def _shas(res):
    return {k: v for k, v in res.items() if k.startswith("sha/")}


def test_two_rank_cluster_really_spans_processes(runs):
    _, run1, run2 = runs
    for run in (run1, run2):
        assert [int(r["rank"]) for r in run] == [0, 1]
        assert all(int(r["world"]) == 2 and str(r["backend"]) == "gloo"
                   and str(r["device"]) == "cpu" for r in run)


def test_ranks_agree_bitwise(runs):
    _, run1, run2 = runs
    for a, b in (run1, run2):
        sa, sb = _shas(a), _shas(b)
        assert len(sa) == 2 * (1 + 4 + 10 + 5 + 10 + 1)
        for k in sa:
            assert np.array_equal(sa[k], sb[k]), k


def test_runs_agree_bitwise(runs):
    _, run1, run2 = runs
    s1, s2 = _shas(run1[0]), _shas(run2[0])
    assert s1.keys() == s2.keys()
    for k in s1:
        assert np.array_equal(s1[k], s2[k]), k


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_two_ranks_match_one_process(runs, dtype):
    data, run1, _ = runs
    tdt = getattr(torch, dtype)
    st = sp.SparseTensor(torch.from_numpy(data["indices"]),
                         torch.from_numpy(data["values"]).to(tdt), SHAPE)
    Ws = [torch.from_numpy(data[f"cp_W{i}"]).to(tdt) for i in range(4)]
    Ts = [torch.from_numpy(data[f"tk_W{i}"]).to(tdt) for i in range(4)]
    want = {f"norm_sq/{dtype}": sp.norm_sq(st),
            f"gradnorm/{dtype}": sp.cp_gradnorm(st, Ws)}
    for m in range(4):
        want[f"mttkrp/{dtype}/{m}"] = sp.mttkrp(st, Ws, m)
    for skip in (0, 1, 2, 3, -1):
        want[f"ttmc/{dtype}/{skip}"] = sp.ttmc(st, Ts, skip_mode=skip)
    for tag, (single, pair) in (("", sp.build_pp_caches(st, Ws)),
                                ("t", sp.build_ttmc_caches(st, Ts))):
        for i in single:
            want[f"{tag}single/{dtype}/{i}"] = single[i]
        for (i, j) in pair:
            want[f"{tag}pair/{dtype}/{i}_{j}"] = pair[(i, j)]
    res = run1[0]
    for key, w in want.items():
        w = w.numpy()
        err = np.max(np.abs(res[key] - w)) / max(np.max(np.abs(w)), 1e-300)
        assert err <= TOL[dtype], (key, err)
        assert float(res[f"err/{key}"]) <= TOL[dtype], key


@pytest.fixture(scope="module")
def dense_runs(tmp_path_factory):
    """Two runs of a 2-rank cluster of the dense sweep functions
    (scripts/multiprocess_worker.py's ``dfunctions``, float64)."""
    tmp = tmp_path_factory.mktemp("mp_dense")
    rng = np.random.default_rng(17)
    d = dict(dd_V=rng.standard_normal(SHAPE), dd_mesh=np.asarray([2]))
    for i, W in enumerate(cp.init_factors(SHAPE, R, seed=5,
                                          dtype=torch.float64,
                                          device="cpu")):
        d[f"dd_W{i}"] = W.numpy()
    np.savez(tmp / "in.npz", **d)
    runs = []
    for name in ("run1", "run2"):
        rc, out = run_cluster(2, WORKER + [
            "--inputs", tmp / "in.npz", "--outdir", tmp / name, "--tasks",
            "dfunctions", "--device", "cpu", "--dtypes", "float64"],
            timeout=120.0)
        assert rc == 0, out[-4000:]
        runs.append([dict(np.load(tmp / name / f"result_{r}.npz"))
                     for r in range(2)])
    return runs


def test_dense_sweeps_agree_bitwise_across_ranks_and_runs(dense_runs):
    run1, run2 = dense_runs
    keys = _shas(run1[0])
    # 4 DT factors and grads, 4 singles and 6 pairs, 2 x 4 PP factors
    assert len(keys) == 4 + 4 + 4 + 6 + 8
    for res in (run1[1], run2[0], run2[1]):
        assert _shas(res).keys() == keys.keys()
        for k, v in keys.items():
            assert np.array_equal(res[k], v), k


def test_dense_sweeps_match_one_process(dense_runs):
    """Each gathered result within 1e-12 (relative max-norm) of the same
    function on the whole V in one process, on both ranks."""
    for res in dense_runs[0]:
        errs = {k: float(v) for k, v in res.items() if k.startswith("err/")}
        assert len(errs) == 26
        assert max(errs.values()) <= TOL["float64"], errs


@pytest.mark.cuda
def test_sharded_k7_on_the_card_over_gloo(tmp_path):
    """On a card: two ranks share it over gloo (one card) or NCCL (a card
    each); K7 runs on every rank's shard of a 200^4 COO of 200,000
    nonzeros at R 10, float32, within 1e-4 of one process, bitwise equal
    across the ranks and across two runs (no TTMc: its index_add_ adds
    in no fixed order on a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    data = _problem((200, 200, 200, 200), 10, nnz=200_000, tucker=False)
    np.savez(tmp_path / "in.npz", **data)
    run1 = _run(tmp_path, "run1", tmp_path / "in.npz", "cuda", "float32",
                arrays=False)
    run2 = _run(tmp_path, "run2", tmp_path / "in.npz", "cuda", "float32",
                arrays=False)
    want = "gloo" if torch.cuda.device_count() < 2 else "nccl"
    for res in run1:
        assert str(res["backend"]) == want
        assert json.loads(str(res["launches"]))["coo_mttkrp.coo_mttkrp"] > 0
        for k, v in res.items():
            if k.startswith("err/"):
                assert float(v) <= 1e-4, k
    for a, b in ((run1[0], run1[1]), (run1[0], run2[0])):
        for k, v in _shas(a).items():
            assert np.array_equal(v, b[k]), k
