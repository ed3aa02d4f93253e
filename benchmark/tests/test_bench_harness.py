"""The harness end to end on the CPU at tiny shapes: a cell's last line,
cells found by name (a new traffic file and workload entry run with no
existing file edited), the traced run's per-layer metrics, and the
refusals (no program, a JAX module loaded)."""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest

from benchmark import run
from benchmark.tests.conftest import REPO, make_root

KEYS = ("correct", "attempted", "failed", "metrics", "device")


def run_cell(root, workload, *extra, seconds="1"):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = run.main(["--workload", workload, "--seed", "3000000019",
                       "--seconds", seconds, "--root", str(root),
                       "--device", "cpu", *extra])
    lines = buf.getvalue().strip().splitlines()
    return rc, json.loads(lines[-1]) if lines else None


@pytest.mark.parametrize("workload", ["tiny-cp.pp", "tiny-cp.dt",
                                      "tiny-tucker.pp", "tiny-tucker.dt"])
def test_cell_last_line(tiny_root, workload):
    rc, res = run_cell(tiny_root, workload)
    assert rc == 0
    assert list(res)[:5] == list(KEYS) and list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"fit_s", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert res["metrics"]["fit_s"]["unit"] == "s"


@pytest.mark.parametrize("workload", ["tiny-cp.pp", "tiny-tucker.dt"])
def test_traced_cell(tiny_root, workload):
    rc, res = run_cell(tiny_root, workload, "--trace", "1", seconds="5")
    assert rc == 0 and res["correct"] is True
    names = set(res["metrics"])
    assert {"sweeps_per_fit", "exact_sweep_ms"} <= names
    assert "fit_s" not in names
    if workload.endswith(".pp"):
        assert {"pp_sweep_share", "pp_sweep_ms"} <= names
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0


def test_new_traffic_file_and_cell_run_unedited(tmp_path):
    """A later PR adds a traffic file and a workloads entry; the harness,
    a verbatim copy, runs them as a separate process from the tree's
    root, as a benchmark run is started."""
    root = make_root(tmp_path, cells=[("tiny-cp.pp2", "tiny-cp", "pp-new")])
    (root / "benchmark" / "traffic" / "pp-new.json").write_text(json.dumps(
        {"flags": ["-pp", "1", "-pp_res_tol", "0.1", "-resprint", "5"]}))
    os.symlink(REPO / "pairwise_perturbation_tpu_torch",
               root / "pairwise_perturbation_tpu_torch")
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "tiny-cp.pp2",
         "--seed", "77", "--seconds", "1", "--trace", "0", "--device",
         "cpu"], cwd=root, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and "fit_s" in res["metrics"]
    assert out.stderr.strip().splitlines()[-1].startswith("check ")


def test_refuses_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and benchmark/ the
    run exits with another code than 0 and prints no result."""
    make_root(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "tiny-cp.pp",
         "--seed", "1", "--seconds", "1", "--trace", "0", "--device",
         "cpu"], cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert "{" not in out.stdout


def test_refuses_without_a_card(tiny_root):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, res = run_cell(tiny_root, "tiny-cp.pp", "--device", "cuda")
    assert rc != 0 and res is None


def test_refuses_a_loaded_jax_module(tiny_root, monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib", sys.modules["json"])
    rc, res = run_cell(tiny_root, "tiny-cp.dt")
    assert rc != 0 and res is None


@pytest.mark.parametrize("names,found", [
    (["pairwise_perturbation_tpu_torch", "pairwise_perturbation_tpu_torch"
      ".models.cp", "jax_helpers", "flaxen"], []),
    (["pairwise_perturbation_tpu.models.cp"], ["pairwise_perturbation_tpu"]),
    (["jax", "jax.numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
])
def test_top_level_names_compared_whole(monkeypatch, names, found):
    for n in names:
        monkeypatch.setitem(sys.modules, n, sys.modules["json"])
    assert run.forbidden_modules() == found


def test_everything_found_by_name():
    """Every configuration, traffic mix, generator, reference and
    per-layer reader that BENCHMARK.json names is a file of its own."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        conf = json.loads((REPO / c["file"]).read_text())
        run.load(REPO, "generators", conf["tensor"]["generator"]).make
        run.load(REPO, "references", conf["reference"]).judge
        assert set(conf["limits"]) and conf["maxiter"] > 0
    for w in bench["workloads"]:
        assert run.data(REPO, "traffic", w["traffic"])["flags"]
    for m in bench["per_layer"]:
        assert callable(run.load(REPO, "metrics", m["name"]).read)
        assert m["moves"] == "fit_s"


def test_fit_order_is_a_permutation_drawn_from_the_seed():
    a = run.fit_order([1, 2, 3, 4], 2 ** 31 + 5)
    assert sorted(a) == [1, 2, 3, 4]
    assert a == run.fit_order([1, 2, 3, 4], 2 ** 31 + 5)
    assert len({tuple(run.fit_order([1, 2, 3, 4], s))
                for s in range(20)}) > 1
