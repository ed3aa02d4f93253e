"""The port's benchmark scripts (pairwise_perturbation_tpu_torch.scripts)
at a small shape on the CPU, where every kernel wrapper takes its plain
version: each returns 0, prints every row of the JAX script it follows,
reports its error checks under tolerance and launches nothing. Without
``--device cpu`` a script runs on the card, and refuses to run where
there is none.
"""

import importlib
import json

import pytest
import torch

torch.set_num_threads(1)

SMALL = ["--shape", "3,16,16,64", "--rank", "5", "--n", "1"]
# Every timed row and error check of each script, in the JAX script's
# order.
ROWS = {
    "bench_firstpair": (
        ["torch V x_1 W1", "torch V x_2 W2", "torch V x_3 W3",
         "mid_contract mode 1", "mid_contract mode 2",
         "last_contract mode 3", "torch.matmul mode 3 (library call for K5)",
         "mode1 max err", "mode2 max err", "mode3 max err",
         "build_pp_caches", "dt_sweep", "order3 sweep torch",
         "order3 sweep kernels", "order3 MTTKRP max err"],
        ["--order3-size", "12"]),
    "bench_rankpos": (
        ["kernel + rank-pos tail (rank-last out)",
         "kernel + rank-pos tail (rank-major out)", "torch chain einsum",
         "max err", "kernel(Z-major) + tail",
         "kernel(Z-major) + 2 tails -> leaf", "torch chain -> leaf",
         "leaf max err", "bf16 kernel + rank-pos tail", "bf16 torch chain",
         "bf16 max err"], []),
    "bench_midvariants": (
        [f"reduce-pass {v} {w}" for v in ("m1", "m2")
         for w in ("column_sum", "torch.sum", "max err")]
        + [f"matmul {v} {w}" for v in ("m1", "m2")
           for w in ("cols=128", "cols=256", "cols=512", "torch einsum",
                     "cols=128 max err", "cols=256 max err",
                     "cols=512 max err")], []),
}


def _script(name):
    return importlib.import_module(
        f"pairwise_perturbation_tpu_torch.scripts.{name}")


@pytest.mark.parametrize("name", sorted(ROWS))
def test_script_runs_on_cpu(name, capsys):
    names, extra = ROWS[name]
    mod = _script(name)
    assert mod.main(["--device", "cpu", *SMALL, *extra]) == 0
    out = capsys.readouterr().out
    last = json.loads(out.strip().splitlines()[-1])
    assert last["ok"] and last["device"] == "cpu"
    assert [r["name"] for r in last["rows"]] == names
    for row in last["rows"]:
        assert row["launches"] == {}          # the CPU never launches
        if "tol" in row:
            assert row["ok"] and row["rel_err"] <= row["tol"]
        else:
            assert row["ms"] > 0
    for n in names:
        assert n in out


@pytest.mark.parametrize("name", sorted(ROWS))
def test_script_runs_on_the_card_by_default(name):
    """No ``--device``: the card. Where there is none the script refuses
    (code 2) instead of running on the CPU."""
    extra = ROWS[name][1]
    code = _script(name).main([*SMALL, *extra])
    assert code == (0 if torch.cuda.is_available() else 2)
