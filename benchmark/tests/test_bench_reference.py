"""The comparison that decides ``correct``: a lower-precision run fails
it, and so does each fault the cells can have, planted in the timed path
underneath an otherwise whole run; the reference imports nothing of the
program."""

import ast
import subprocess
import sys

import pytest
import torch

from benchmark.tests.conftest import REPO
from benchmark.tests.test_bench_harness import run_cell
from pairwise_perturbation_tpu_torch.models import cp, tucker


def test_lower_precision_fails(tiny_root):
    """V stored in bfloat16 (the port's -dtype bfloat16), the step below
    the float32 the configurations state that a CPU can run."""
    for workload in ("tiny-cp.pp", "tiny-tucker.pp"):
        rc, res = run_cell(tiny_root, workload, "--precision", "bf16v")
        assert rc == 0 and res["correct"] is False, res["checks"]
        rc, res = run_cell(tiny_root, workload)
        assert rc == 0 and res["correct"] is True, res["checks"]


def _unchanged(fn):
    """The sweep returns the factors it was given (argument 1 of a DT
    sweep, 2 of a PP sweep, after the two caches)."""
    i = 2 if fn.__name__.endswith("pp_sweep") else 1

    def f(*a, **kw):
        return (a[i],) + tuple(fn(*a, **kw)[1:])
    return f


def _half_batch(fn):
    """The sweep sees V with the second half of its last mode left out."""
    def f(V, *a, **kw):
        half = V.clone()
        half[..., V.shape[-1] // 2:] = 0
        return fn(half, *a, **kw)
    return f


def _altered(fn):
    """The fit's answer altered where it is produced: one factor entry."""
    def f(*a, **kw):
        res = fn(*a, **kw)
        res.factors = list(res.factors)
        W = res.factors[1].clone()
        W[0, 0] += 0.05 * torch.linalg.vector_norm(W)
        res.factors[1] = W
        return res
    return f


FAULTS = {
    "unchanged": {"CP": [(cp, "dt_sweep"), (cp, "pp_sweep")],
                  "Tucker": [(tucker, "tucker_dt_sweep"),
                             (tucker, "tucker_pp_sweep")]},
    "half_batch": {"CP": [(cp, "dt_sweep")],
                   "Tucker": [(tucker, "tucker_dt_sweep")]},
    "altered": {"CP": [(cp, "als_cp_pp"), (cp, "als_cp_dt")],
                "Tucker": [(tucker, "als_tucker_pp"), (tucker, "als_tucker")]},
}
WRAP = {"unchanged": _unchanged, "half_batch": _half_batch,
        "altered": _altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", ["tiny-cp.pp", "tiny-cp.dt",
                                      "tiny-tucker.pp", "tiny-tucker.dt"])
def test_fault_fails(tiny_root, monkeypatch, fault, workload):
    model = "CP" if workload.startswith("tiny-cp") else "Tucker"
    for mod, name in FAULTS[fault][model]:
        monkeypatch.setattr(mod, name, WRAP[fault](getattr(mod, name)))
    rc, res = run_cell(tiny_root, workload)
    assert rc == 0 and res["correct"] is False, res["checks"]


REFERENCE_FILES = sorted((REPO / "benchmark" / "references").glob("*.py")) \
    + sorted((REPO / "benchmark" / "generators").glob("*.py")) \
    + [REPO / "benchmark" / "peaks.py", REPO / "benchmark" / "trace.py"] \
    + sorted((REPO / "benchmark" / "metrics").glob("*.py"))


@pytest.mark.parametrize("path", REFERENCE_FILES, ids=lambda p: p.name)
def test_yardstick_imports_nothing_of_the_program(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add((node.module or "").split(".")[0])
    assert tops <= {"torch", "numpy", "math", "itertools", "statistics",
                    "bisect", "collections", "typing", "__future__"}, tops


def test_reference_loads_no_program_module():
    code = (
        "import sys; from pathlib import Path; from benchmark import run\n"
        "root = Path('.')\n"
        "for k, n in [('references', 'cp_als'), ('references', 'tucker_als'),"
        " ('generators', 'collinear_cp'), ('generators', 'tucker_decay'),"
        " ('generators', 'random_cp')]:\n"
        "    run.load(root, k, n)\n"
        "import benchmark.trace, benchmark.peaks\n"
        "bad = {m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib',"
        " 'pairwise_perturbation_tpu', 'pairwise_perturbation_tpu_torch'}\n"
        "print(sorted(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.cuda
@pytest.mark.parametrize("precision,correct", [("fp32", True),
                                               ("tf32", False),
                                               ("bf16v", False)])
def test_control_on_the_card(card, tiny_root, precision, correct):
    """On the card: the tiny cells pass in float32 and fail with TF32
    matmuls (the port's float32 pins lifted) and with bf16 V. The cells'
    own sizes are run by the chip calls that PERF.md records."""
    for workload in ("tiny-cp.pp", "tiny-tucker.pp"):
        rc, res = run_cell(tiny_root, workload, "--device", "cuda",
                           "--precision", precision)
        assert rc == 0 and res["correct"] is correct, res["checks"]
