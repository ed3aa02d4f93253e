"""Cells on several cards, rehearsed on the CPU: the launcher and its
ranks over gloo (one process a rank, each its own time limit, all
started at once), the random CP tensor made in blocks, the CP
reference's block form, and the refusals."""

import itertools
import json
import math
import os
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark import engine as eng
from benchmark import run
from benchmark.tests.conftest import REPO, TINY_CP, TINY_RCP6, make_root
from benchmark.tests.test_bench_harness import run_cell
from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh

random_cp = run.load(REPO, "generators", "random_cp")
cp_als = run.load(REPO, "references", "cp_als")

PP = ["-pp", "1", "-pp_res_tol", "0.05", "-resprint", "10"]
# name: (cell, traffic flags, chips, --trace, seconds the run may take)
RUNS = {
    "mesh2-trace0": ("rcp6.m2", PP + ["-mesh", "2"], 2, 0, 50),
    "mesh2-trace1": ("rcp6.m2", PP + ["-mesh", "2"], 2, 1, 55),
    "mesh4-trace0": ("rcp6.m4", PP + ["-mesh", "4"], 4, 0, 50),
    "mesh4-trace1": ("rcp6.m4", PP + ["-mesh", "4"], 4, 1, 55),
    "raises": ("raises.m2", PP + ["-mesh", "2"], 2, 0, 30),
    "mesh-mismatch": ("rcp6.m4on2", PP + ["-mesh", "4"], 2, 0, 30),
}

RAISES_ON_RANK_1 = '''
import os
from benchmark.generators.random_cp import make_block as _block


def make_block(shape, conf, layout, device):
    if os.environ["RANK"] == "1":
        raise RuntimeError("rank 1 fails in set-up")
    return _block(shape, conf, layout, device)
'''


class Launched:
    """One run started as a benchmark run is started, drained by a thread
    that notes when it ended."""

    def __init__(self, root, cell, trace):
        self.started = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "benchmark.run", "--workload", cell,
             "--seed", "3000000019", "--seconds", "1", "--trace",
             str(trace), "--device", "cpu"], cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=dict(os.environ, PYTHONPATH=""))
        self.thread = threading.Thread(target=self._drain, daemon=True)
        self.thread.start()

    def _drain(self):
        self.out, self.err = self.proc.communicate()
        self.ended = time.perf_counter()

    def result(self, limit):
        """(exit code, standard output, standard error), once the run has
        ended within ``limit`` seconds of its start."""
        self.thread.join(max(0.0, self.started + limit - time.perf_counter()))
        if self.thread.is_alive():
            self.proc.kill()
            self.thread.join()
            pytest.fail(f"the run took more than {limit} s")
        assert self.ended - self.started <= limit
        return self.proc.returncode, self.out, self.err


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Every run of RUNS started at once, each from the root of a tree
    of its own; {name: Launched}."""
    runs = {}
    for name, (cell, flags, chips, trace, _) in RUNS.items():
        conf = "raises-rcp6" if name == "raises" else "tiny-rcp6"
        root = make_root(tmp_path_factory.mktemp(name),
                         cells=[(cell, conf, "mix", chips)])
        (root / "benchmark" / "traffic" / "mix.json").write_text(
            json.dumps({"flags": flags}))
        (root / "benchmark" / "generators" / "raises.py").write_text(
            RAISES_ON_RANK_1)
        (root / "benchmark" / "configs" / "raises-rcp6.json").write_text(
            json.dumps(dict(TINY_RCP6, tensor={"generator": "raises",
                                               "data_seed": 1})))
        bench = json.loads((root / "BENCHMARK.json").read_text())
        bench["configs"].append(
            {"name": "raises-rcp6", "source": "tests", "reduced": [],
             "why": "tests", "file": "benchmark/configs/raises-rcp6.json"})
        (root / "BENCHMARK.json").write_text(json.dumps(bench))
        os.symlink(REPO / "pairwise_perturbation_tpu_torch",
                   root / "pairwise_perturbation_tpu_torch")
        runs[name] = Launched(root, cell, trace)
    yield runs
    for r in runs.values():
        if r.proc.poll() is None:
            r.proc.kill()
        r.thread.join()


def finished(launched, name):
    """(exit code, standard output, standard error) of a run, within its
    own limit."""
    return launched[name].result(RUNS[name][4])


@pytest.mark.parametrize("name", ["mesh2-trace0", "mesh2-trace1",
                                  "mesh4-trace0", "mesh4-trace1"])
def test_cell_over_ranks(launched, name):
    """(a) One last line from the launcher, correct, on as many devices
    as the cell's chips, with every rank running the same fits."""
    rc, out, err = finished(launched, name)
    assert rc == 0, err[-3000:]
    lines = out.strip().splitlines()
    res = json.loads(lines[-1])
    chips, trace = RUNS[name][2], RUNS[name][3]
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"] and list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["device"]["count"] == chips
    assert res["checks"]["rank_disagreement"] == {"value": 0, "limit": 0}
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert err.strip().splitlines()[-1].startswith("check gradnorm_ref ")
    if trace:
        assert "fit_s" not in res["metrics"]
        assert res["metrics"]["sweeps_per_fit"]["value"] > 0
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert res["device"]["window_s"] > 0
    else:
        assert set(res["metrics"]) == {"fit_s", "setup_s"}
        # set-up counts from the launcher's start: the ranks' start, their
        # blocks, the engines and the untimed fit
        assert res["metrics"]["setup_s"]["value"] > 1.0
        assert "window_start" not in res


def test_rank_failing_in_setup_ends_the_run(launched):
    """(d) Rank 1 raises while it makes its block: the launcher kills
    rank 0, exits with another code than 0, prints no result, and says
    which rank failed and how."""
    rc, out, err = finished(launched, "raises")
    assert rc != 0
    assert "{" not in out
    assert "rank 1 of 2 ended with code 1" in err
    assert "rank 1 fails in set-up" in err


def test_mesh_of_another_size_refused_by_the_ranks(launched):
    """(e) A 2-card cell whose traffic asks -mesh 4: every rank refuses
    before it joins, and the launcher exits with no result."""
    rc, out, err = finished(launched, "mesh-mismatch")
    assert rc != 0 and "{" not in out
    assert "-mesh 4 has 4 device(s) and the cell asks for 2 card(s)" in err


@pytest.mark.parametrize("mesh,chips", [("4", 2), ("2", 4), ("2x2", 2),
                                        (None, 2), ("2", 1), ("1", 1)])
def test_mesh_size_must_be_the_cells_chips(mesh, chips):
    """(e) -mesh gives one rank a card of the cell, or is absent on one
    card."""
    traffic = {"flags": PP + (["-mesh", mesh] if mesh else [])}
    with pytest.raises(SystemExit, match="the cell asks for"):
        eng.parsed(TINY_RCP6, traffic, "fp32", chips)


@pytest.mark.parametrize("mesh,chips", [("2", 2), ("2x2", 4), (None, 1)])
def test_mesh_of_the_cells_size_accepted(mesh, chips):
    traffic = {"flags": PP + (["-mesh", mesh] if mesh else [])}
    assert eng.parsed(TINY_RCP6, traffic, "fp32", chips).mesh == (mesh or "")


def test_one_card_cell_starts_no_process_and_joins_no_world(tiny_root,
                                                            monkeypatch):
    """With chips 1 the harness runs in its own process: nothing is
    started and no process group is made."""
    def refuse(*a, **kw):
        raise AssertionError("a one-card cell started a process")
    monkeypatch.setattr(subprocess, "Popen", refuse)
    rc, res = run_cell(tiny_root, "tiny-cp.dt")
    assert rc == 0 and res["correct"] is True
    assert "rank_disagreement" not in res["checks"]
    assert not torch.distributed.is_initialized()


def test_one_card_cell_with_mesh_refused(tmp_path):
    root = make_root(tmp_path, cells=[("tiny-cp.m2", "tiny-cp", "m2")])
    (root / "benchmark" / "traffic" / "m2.json").write_text(
        json.dumps({"flags": PP + ["-mesh", "2"]}))
    with pytest.raises(SystemExit, match="runs unsharded"):
        run_cell(root, "tiny-cp.m2")


# ---- (b) the random CP tensor in blocks (test_bench_copies.py pins it
# to the port's)


class FakeMesh:
    """What the layout planner and ``span`` read of a DeviceMesh, at one
    rank's coordinate."""

    def __init__(self, shape, coordinate):
        self.shape = tuple(shape)
        self.mesh_dim_names = pmesh.default_axis_names(len(shape))
        self.coordinate = list(coordinate)

    def get_coordinate(self):
        return self.coordinate


def blocks(shape, mesh_shape):
    """Every rank's layout of ``shape`` on a mesh of ``mesh_shape``."""
    for c in itertools.product(*(range(s) for s in mesh_shape)):
        yield pmesh.plan_layout(shape, FakeMesh(mesh_shape, c))


@pytest.mark.parametrize("mesh_shape", [(1,), (2,), (4,), (2, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_blocks_tile_the_tensor(mesh_shape, dtype):
    shape = (5, 6, 3, 7)
    conf = {"rank": 3, "tensor": {"data_seed": 2 ** 31 + 3}}
    V = random_cp.make(shape, conf, torch.device("cpu"), dtype)
    layouts = list(blocks(shape, mesh_shape))
    padded = torch.zeros(layouts[0].padded_shape, dtype=dtype)
    seen = torch.zeros(layouts[0].padded_shape, dtype=torch.int64)
    for lay in layouts:
        B = random_cp.make_block(shape, conf, lay, torch.device("cpu"),
                                 dtype)
        at = tuple(slice(*lay.span(m)) for m in range(len(shape)))
        padded[at] = B
        seen[at] += 1
    assert bool((seen == 1).all())
    real = tuple(slice(0, s) for s in shape)
    assert torch.equal(padded[real], V)
    padded[real] = 0
    assert not padded.any()


# ---- (c) the CP reference's block form


def fits_of(shape, R, seed, V, offset, moved=0.01):
    """Two converged fits near the tensor's factors (each entry moved by
    up to ``moved`` and twice that), reporting the reference's gradnorm
    and diffV times ``offset``."""
    Ws = random_cp.factors(shape, R, seed)
    g = torch.Generator().manual_seed(seed)
    out = []
    for k in range(2):
        fs = [torch.from_numpy(W) * (1 + moved * (k + 1) * torch.rand(
            W.shape, generator=g, dtype=torch.float64)) for W in Ws]
        f = SimpleNamespace(factors=fs, converged=True, metric=0.0,
                            diffV=0.0)
        (gn, dv), = cp_als.fit_readings(V, [f])[0]
        f.metric, f.diffV = gn * offset, dv * offset
        out.append(f)
    return out


def block_numbers(shape, conf, mesh_shape, fits, drop=None):
    total = None
    for k, lay in enumerate(blocks(shape, mesh_shape)):
        if k == drop:
            continue
        B = random_cp.make_block(shape, conf, lay, torch.device("cpu"),
                                 torch.float64)
        assert B.shape == tuple(hi - lo for lo, hi in map(
            lay.span, range(len(shape))))
        part = cp_als.block_sums(B, [lay.span(m) for m in range(len(shape))],
                                 shape, fits)
        total = part if total is None else total + part
    return cp_als.judge_sums(total, fits, conf)


@pytest.mark.parametrize("mesh_shape", [(1,), (2,), (4,), (2, 2)])
def test_block_judge_is_the_judge(mesh_shape, monkeypatch):
    shape, R, seed = (5, 6, 3, 7), 3, 11
    conf = dict(TINY_CP, rank=R, shape=list(shape),
                tensor={"data_seed": seed})
    V = random_cp.make(shape, conf, torch.device("cpu"), torch.float64)
    fits = fits_of(shape, R, seed, V, 1.25)
    whole = cp_als.judge(V, fits, conf)
    # chunks of a few rows: the block is read in many pieces
    monkeypatch.setattr(cp_als, "BLOCK_ELEMS", 40)
    parts = block_numbers(shape, conf, mesh_shape, fits)
    assert set(parts) == set(whole)
    for name in whole:
        assert parts[name] == pytest.approx(whole[name], rel=1e-12), name


@pytest.mark.parametrize("mesh_shape", [(2,), (4,), (2, 2)])
def test_block_judge_missing_a_block_fails(mesh_shape):
    shape, R, seed = (5, 6, 3, 7), 3, 12
    conf = dict(TINY_CP, rank=R, shape=list(shape),
                tensor={"data_seed": seed})
    V = random_cp.make(shape, conf, torch.device("cpu"), torch.float64)
    fits = fits_of(shape, R, seed, V, 1.0, moved=1e-4)

    def passes(numbers):
        return all(numbers[n] <= lim for n, lim in conf["limits"].items())
    assert passes(block_numbers(shape, conf, mesh_shape, fits))
    for drop in range(math.prod(mesh_shape)):
        assert not passes(block_numbers(shape, conf, mesh_shape, fits,
                                        drop=drop)), drop


def test_judge_block_sums_through_the_ranks():
    """judge_block hands its partials to the ranks' sum, and reads the
    sum it gets back."""
    shape, R, seed = (4, 4, 5), 2, 3
    conf = dict(TINY_CP, rank=R, shape=list(shape),
                tensor={"data_seed": seed})
    V = random_cp.make(shape, conf, torch.device("cpu"), torch.float64)
    fits = fits_of(shape, R, seed, V, 1.1)
    seen = []

    def total(t):
        seen.append(t.dtype)
        return t
    got = cp_als.judge_block(V, [(0, s) for s in shape], fits, conf, total)
    assert seen == [torch.float64]
    want = cp_als.judge(V, fits, conf)
    for name in want:
        assert got[name] == pytest.approx(want[name], rel=1e-12)
