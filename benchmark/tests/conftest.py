"""Fixtures of the benchmark's tests: a tiny copy of the benchmark's
tree to run cells in, and the ``cuda`` marker's card check (decided in a
fixture, never at import)."""

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

TINY_CP = {
    "model": "CP", "shape": [3, 12, 12, 80], "rank": 4, "dtype": "float32",
    "tensor": {"generator": "collinear_cp", "data_seed": 1, "colmin": 0.5,
               "colmax": 0.9, "rationoise": 0.01},
    "tol": 0.01, "maxiter": 250, "fit_seeds": [1, 2, 3, 4],
    "reference": "cp_als",
    "limits": {"gradnorm_gap": 0.01, "diffV_gap": 0.005,
               "gradnorm_ref": 1.05}}
TINY_TUCKER = {
    "model": "Tucker", "shape": [3, 12, 12, 80], "ranks": [3, 4, 4, 8],
    "dtype": "float32",
    "tensor": {"generator": "tucker_decay", "data_seed": 1, "overfit": 3.0,
               "decay": 1.0, "rationoise": 0.01},
    "tol": 1e-6, "maxiter": 250, "fit_seeds": [0],
    "reference": "tucker_als",
    "limits": {"core_gap": 1e-5, "orth_gap": 1e-5, "diffV_gap": 1e-4,
               "hooi_gain": 1.0}}
# the strong-scaling tensor (-tensor r) at order 6, for cells on several
# ranks
TINY_RCP6 = {
    "model": "CP", "shape": [6] * 6, "rank": 3, "dtype": "float32",
    "tensor": {"generator": "random_cp", "data_seed": 1},
    "tol": 0.05, "maxiter": 250, "fit_seeds": [1, 2],
    "reference": "cp_als",
    "limits": {"gradnorm_gap": 0.01, "diffV_gap": 0.005,
               "gradnorm_ref": 1.05}}
CONFS = {"tiny-cp": TINY_CP, "tiny-tucker": TINY_TUCKER,
         "tiny-rcp6": TINY_RCP6}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def make_root(path: Path, cells=None) -> Path:
    """A checkout-like tree under ``path``: a copy of benchmark/ (no
    tests), the tiny configurations, and a BENCHMARK.json with the real
    metrics and the tiny cells: (name, configuration, traffic) on one
    chip, or (name, configuration, traffic, chips)."""
    shutil.copytree(REPO / "benchmark", path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for name, conf in CONFS.items():
        (path / "benchmark" / "configs" / f"{name}.json").write_text(
            json.dumps(conf))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [
        {"name": n, "source": "tests", "reduced": [], "why": "tests",
         "file": f"benchmark/configs/{n}.json"} for n in CONFS]
    cells = cells or [("tiny-cp.pp", "tiny-cp", "pp-restol0.05"),
                      ("tiny-cp.dt", "tiny-cp", "dt"),
                      ("tiny-tucker.pp", "tiny-tucker", "pp-restol0.1"),
                      ("tiny-tucker.dt", "tiny-tucker", "dt")]
    bench["workloads"] = [{"name": c[0], "config": c[1], "traffic": c[2],
                           "chips": c[3] if len(c) > 3 else 1,
                           "why": "tests"} for c in cells]
    names = [c[0] for c in cells]
    for m in bench["per_layer"]:
        m["workloads"] = [n for n in names
                          if ".pp" in n or "pp_" not in m["name"]]
    (path / "BENCHMARK.json").write_text(json.dumps(bench))
    return path


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
