"""The port's copy of the equal-fitness rules
(pairwise_perturbation_tpu_torch/scripts/fitness.py) pinned to the
original, scripts/fitness.py: every function gives the same outputs on
tests/test_fitness.py's trajectories. Then the port's bench_pp_e2e
(DT-ALS against the fused machine from the same factors) on the CPU at a
tiny size: it writes its two files into --out and nothing anywhere else,
and its last line holds every config's entry, with finite rows.
"""

import importlib.util
import json
import math
import os

import pytest
import torch

from pairwise_perturbation_tpu_torch.scripts import bench_pp_e2e
from pairwise_perturbation_tpu_torch.scripts import fitness

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _original():
    spec = importlib.util.spec_from_file_location(
        "scripts_fitness", os.path.join(ROOT, "scripts", "fitness.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ORIGINAL = _original()


def _rows(vals, dt=1.0):
    return [dict(iter=i, diffV=v, dtime=(i + 1) * dt)
            for i, v in enumerate(vals)]


# the trajectories of tests/test_fitness.py, and two edge cases: a run
# with a non-finite row and one that never improves
TRAJECTORIES = {
    "plateau_a": _rows([10, 5, 2, 1, 1, 1, 1, 1]),
    "plateau_b": _rows([10, 8, 6, 4, 2, 1.1, 1.1, 1.1]),
    "dip": _rows([10, 9, 0.5, 8, 7, 5, 5, 5]),
    "floor_a": _rows([10, 5, 3, 2, 1.45, 1.44, 1.43, 1.42, 1.41, 1.37, 1.43,
                      1.41]),
    "floor_b": _rows([100, 80, 60, 40, 20, 10, 5, 2, 1.46, 1.39, 1.44,
                      1.41]),
    "race_a": _rows([100, 40, 20, 12, 11, 11, 11, 11]),
    "race_b": _rows([100, 90, 70, 50, 30, 20, 12, 11]),
    "flat_c": _rows([100.0, 99.99, 99.98, 99.98]),
    "flat_d": _rows([100.0, 99.99, 99.99, 99.98]),
    "nan": _rows([10, float("nan"), 3, 2, 2, 2]),
}
PAIRS = [("plateau_a", "plateau_b"), ("floor_a", "floor_b"),
         ("race_a", "race_b"), ("flat_c", "flat_d"), ("dip", "nan"),
         ("plateau_b", "floor_a")]


def _same(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b and type(a) is type(b)


@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_one_trajectory_functions_match_original(name):
    rows = TRAJECTORIES[name]
    for fn, args in (("sustained_fitness", ()), ("final_row_fitness", ()),
                     ("sustained_fitness", ("diffV", 0.5)),
                     ("first_crossing", (1.42,)), ("first_crossing", (5,)),
                     ("time_to_sustained", (1.45,)),
                     ("time_to_sustained", (5, "diffV", 2))):
        got = getattr(fitness, fn)(rows, *args)
        want = getattr(ORIGINAL, fn)(rows, *args)
        assert _same(got, want), (fn, args, got, want)


@pytest.mark.parametrize("a,b", PAIRS)
def test_pair_functions_match_original(a, b):
    ra, rb = TRAJECTORIES[a], TRAJECTORIES[b]
    for fn, kw in (("equal_fitness_times", {}),
                   ("equal_fitness_times", dict(k=2, slack=1.01)),
                   ("improvement_times", {}),
                   ("improvement_times", dict(frac=0.5, k=1))):
        got = getattr(fitness, fn)(ra, rb, **kw)
        want = getattr(ORIGINAL, fn)(ra, rb, **kw)
        assert _same(got, want), (fn, kw, got, want)


def test_same_functions_as_original():
    names = {n for n in dir(ORIGINAL) if not n.startswith("__")}
    assert names <= set(dir(fitness))


def test_bench_pp_e2e_cpu_writes_only_out(tmp_path, monkeypatch, capsys):
    """--device cpu at a tiny size: rc 0, pp_e2e.json and PP_WINS.md in
    --out and nothing else in the working directory or the checkout's
    results/; the last line is the JSON of every config, with finite DT
    and PP rows and a fitness rule."""
    cwd, out = tmp_path / "cwd", tmp_path / "out"
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    results = os.path.join(ROOT, "results")
    before = sorted(os.listdir(results))
    rc = bench_pp_e2e.main(["--device", "cpu", "--quick", "--s6", "3",
                            "--coil-shape", "3,4,4,10", "--maxiter", "6",
                            "--out", str(out)])
    assert rc == 0
    assert sorted(os.listdir(out)) == ["PP_WINS.md", "pp_e2e.json"]
    assert os.listdir(cwd) == []
    assert sorted(os.listdir(results)) == before
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert sorted(last) == ["coil_shape_f32", "order6_s3_c",
                            "order6_s3_col", "order6_s3_r"]
    for e in last.values():
        assert e["dt_rows_finite"] and e["pp_rows_finite"]
        assert e["fitness_rule"] in ("sustained", "monotone")
        assert e["pp_iters"] == e["dt_iters"] == 7
    with open(out / "pp_e2e.json") as fh:
        assert json.load(fh) == last


def test_bench_pp_e2e_refuses_a_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bench_pp_e2e.main(["--out", str(tmp_path / "out")]) == 2
    assert not (tmp_path / "out").exists()


def test_build_dense_is_the_cp_tensor():
    """Two Khatri-Rao halves and one matmul give the CP tensor."""
    gen = torch.Generator().manual_seed(0)
    Ws = [torch.rand((s, 3), generator=gen, dtype=torch.float64)
          for s in (2, 3, 4, 2, 3)]
    want = torch.einsum("ar,br,cr,dr,er->abcde", *Ws)
    assert torch.allclose(bench_pp_e2e.build_dense(Ws), want, rtol=1e-12,
                          atol=0)
