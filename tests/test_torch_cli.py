"""The port's CLI on the CPU, its import boundary, and the numpy-only
helpers it copies from the JAX package (held equal to their originals)."""

import ast
import csv
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from pairwise_perturbation_tpu import native as jnative
from pairwise_perturbation_tpu.utils import flags as jflags
from pairwise_perturbation_tpu.utils import metrics as jmetrics
from pairwise_perturbation_tpu.utils import synth as jsynth
from pairwise_perturbation_tpu_torch import cli, native as tnative
from pairwise_perturbation_tpu_torch.ops.kernels import mttkrp3
from pairwise_perturbation_tpu_torch.utils import flags as tflags
from pairwise_perturbation_tpu_torch.utils import metrics as tmetrics
from pairwise_perturbation_tpu_torch.utils import synth as tsynth
from pairwise_perturbation_tpu_torch.utils import tracing

torch.set_num_threads(1)

PKG = pathlib.Path(__file__).resolve().parents[1] / \
    "pairwise_perturbation_tpu_torch"
HEADER = "[dim],[iter],[gradnorm],[tol],[pp_update],[diffV],[dtime]"


def _run(tmp_path, *extra, name="out.csv"):
    out = str(tmp_path / name)
    rc = cli.main(["test_als", "-model", "CP", "-tensor", "r", "-dim", "3",
                   "-size", "12", "-rank", "3", "-maxiter", "12",
                   "-resprint", "2", "-pp_res_tol", "0.1", "-device", "cpu",
                   "-quiet", "-filename", out, *extra])
    with open(out) as fh:
        return rc, list(csv.reader(fh))


@pytest.mark.parametrize("dtype", ["float32", "float64", "bfloat16"])
@pytest.mark.parametrize("pp", ["0", "1"])
def test_cli_writes_reference_csv(tmp_path, pp, dtype):
    before = dict(mttkrp3.LAUNCHES)
    rc, rows = _run(tmp_path, "-pp", pp, "-dtype", dtype)
    assert rc == 0
    assert ",".join(rows[0]) == HEADER
    body = [[float(x) for x in r] for r in rows[1:]]
    assert len(body) >= 3 and all(len(r) == 7 for r in body)
    assert all(np.isfinite(r).all() for r in body)
    assert body[-1][2] < body[0][2]          # gradnorm decreased
    flags = {r[4] for r in body}
    assert flags == ({0.0} if pp == "0" else {0.0, 1.0})
    assert mttkrp3.LAUNCHES == before      # CPU tensors never launch


def test_cli_profile_prints_phase_report(tmp_path, capsys):
    tracing.reset()
    try:
        rc, _ = _run(tmp_path, "-pp", "1", "-profile", "1")
    finally:
        tracing.enable(False)
    assert rc == 0
    out = capsys.readouterr().out
    for name in ("cp.dt_sweep", "cp.pp_sweep", "cp.pp_cache_build",
                 "cp.diagnostics"):
        assert name in out
        assert tracing.stats()[name][0] > 0


@pytest.mark.parametrize("argv,step", [
    (["run", "-issparse", "1", "-resume", "ck.npz"], "reads no checkpoint"),
    (["pp_bench", "-model", "Tucker", "-device_loop", "1"],
     "ignores the flag"),
    (["-issparse", "1", "-model", "Tucker", "-resume", "ck.npz"],
     "reads no checkpoint"),
    (["run", "-mesh", "4"], "nproc_per_node 4"),
    (["-issparse", "1", "-model", "Tucker", "-device_loop", "1"],
     "ignores the flag"),
    (["-mesh", "4"], "A15"),
    (["-device_loop", "1"], "ignores the flag"),
    (["-pp", "2", "-device_loop", "2", "-mesh", "2"], "ignores the flag"),
    (["-pp", "1", "-layouts", "1"], "ignores the flag"),
    (["pp_bench", "-resume", "ck.npz"], "reads no checkpoint"),
    (["-issparse", "1", "-resume", "ck.npz"], "reads no checkpoint"),
    (["run", "-checkpoint", "ck"], "writes no checkpoint"),
    (["run", "-resume", "ck.npz"], "reads no checkpoint"),
    (["pp_bench", "-checkpoint", "ck"], "writes no checkpoint"),
])
def test_cli_refuses_unported_features(argv, step):
    if argv[0] in ("run", "pp_bench"):
        argv = argv + ["-device", "cpu"]
    else:
        argv = ["test_als", "-device", "cpu"] + argv
    with pytest.raises(SystemExit, match=step):
        cli.main(argv)


@pytest.mark.parametrize("argv,match", [
    # where the JAX package ignores -device_loop, the refusal says so
    (["pp_bench", "-device_loop", "1"], "pp_bench times host-driven sweeps"),
    (["test_als", "-pp", "0", "-device_loop", "1"],
     "-pp 0 runs the host-driven engine; the JAX package ignores"),
    (["test_als", "-pp", "2", "-device_loop", "1"],
     "-pp 2 runs the host-driven engine; the JAX package ignores"),
    (["test_als", "-issparse", "1", "-pp", "1", "-device_loop", "1"],
     "sparse engines .* the JAX package ignores"),
    (["test_als", "-model", "Tucker", "-pp", "0", "-device_loop", "2"],
     "Tucker -pp 0 .* the JAX package ignores"),
    # the same under -mesh, where the device engines run on a sharded V
    (["test_als", "-pp", "2", "-device_loop", "2", "-mesh", "2"],
     "-pp 2 runs the host-driven engine; the JAX package ignores"),
    (["test_als", "-model", "Tucker", "-pp", "0", "-device_loop", "1",
      "-mesh", "2"],
     "Tucker -pp 0 .* the JAX package ignores"),
    (["test_als", "-issparse", "1", "-pp", "1", "-device_loop", "1",
      "-mesh", "2"],
     "sparse engines .* the JAX package ignores"),
])
def test_cli_device_loop_refusals_follow_jax(argv, match):
    """-device_loop >= 1 where the JAX package has no device-resident
    engine either: each refusal says that the JAX package ignores the
    flag there, with -mesh or without."""
    with pytest.raises(SystemExit, match=match):
        cli.main(argv + ["-device", "cpu"])


def test_cli_device_loop_runs_cp_pp1(tmp_path):
    """test_als -pp 1 -device_loop 1 runs the device-resident engine (its
    phase scopes) and writes PP rows."""
    tracing.reset()
    try:
        rc, rows = _run(tmp_path, "-pp", "1", "-device_loop", "1",
                        "-profile", "1")
    finally:
        tracing.enable(False)
    assert rc == 0
    assert {r[4] for r in rows[1:]} == {"0", "1"}
    stats = tracing.stats()
    assert stats["cp.dt_phase_device"][0] > 0
    assert stats["cp.pp_phase_device"][0] > 0
    assert "cp.dt_sweep" not in stats


@pytest.mark.parametrize("argv,scopes", [
    (["-pp", "1", "-device_loop", "2"],
     ("cp.fused_dt_step", "cp.fused_build_step", "cp.fused_pp_step")),
    (["-model", "Tucker", "-tensor", "r2", "-pp", "1", "-device_loop", "1"],
     ("tucker.dt_phase_device", "tucker.pp_phase_device")),
    (["-model", "Tucker", "-tensor", "r2", "-pp", "2", "-device_loop", "2"],
     ("tucker.fused_dt_step", "tucker.fused_build_step",
      "tucker.fused_pp_step")),
])
def test_cli_device_loop_runs_the_other_engines(tmp_path, argv, scopes):
    """-device_loop 2 (CP -pp 1) and -device_loop 1 and 2 (Tucker -pp >=
    1, as JAX cli.py:272-278 routes them) run their device engines (their
    scopes) and write PP rows."""
    tracing.reset()
    try:
        rc, rows = _run(tmp_path, *argv, "-profile", "1")
    finally:
        tracing.enable(False)
    assert rc == 0
    assert {r[4] for r in rows[1:]} == {"0", "1"}
    stats = tracing.stats()
    assert all(stats[s][0] > 0 for s in scopes), stats


def test_cli_cuda_device_required(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["test_als", "-filename", str(tmp_path / "x.csv")])


def test_port_imports_neither_jax_nor_the_jax_package():
    """Every port module, imported in a fresh interpreter, adds no jax
    module and nothing of pairwise_perturbation_tpu to sys.modules."""
    mods = []
    for path in sorted(PKG.rglob("*.py")):
        parts = path.relative_to(PKG.parent).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__"
                             else parts))
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'pairwise_perturbation_tpu'\n"
        "             or m.startswith('pairwise_perturbation_tpu.'))\n"
        "print(len(new), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=str(PKG.parent), timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_sources_have_no_jax_imports():
    for path in PKG.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib",
                                    "pairwise_perturbation_tpu"), (path, n)


@pytest.mark.parametrize("name", ["p", "p2", "c", "r", "r2"])
def test_synth_copy_matches_original(name):
    dim = 4 if name in ("p", "p2") else 3
    for dtype in (np.float32, np.float64):
        a = tsynth.make_tensor(name, dim, 5, 3, seed=11, dtype=dtype)
        b = jsynth.make_tensor(name, dim, 5, 3, seed=11, dtype=dtype)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_flag_defaults_match_original():
    targs = vars(tflags.build_parser().parse_args([]))
    jargs = vars(jflags.build_parser().parse_args([]))
    assert targs.pop("device") == "cuda"
    assert targs == jargs
    for argv in (["-rank", "0", "-size", "9", "-maxiter", "-1", "-tol", "3",
                  "-pp_res_tol", "2", "-lambda", "-1", "-magni", "-2"],):
        t, j = (tflags.build_parser().parse_args(argv),
                jflags.build_parser().parse_args(argv))
        tflags.clamp(t)
        jflags.clamp(j)
        del vars(t)["device"]
        assert vars(t) == vars(j)


@pytest.mark.parametrize("shape,rank", [((200, 200, 200), 10),
                                        ((3, 128, 128, 7200), 10),
                                        ((4, 10, 12, 14), 3),
                                        ((5, 6, 7, 8, 9), 4)])
def test_native_copy_matches_original(shape, rank):
    assert tnative.available() == jnative.available()
    assert tnative.plan_chain_priority(shape, rank) == \
        jnative.plan_chain_priority(shape, rank)
    np.testing.assert_equal(tnative.plan_tree_split(shape, rank),
                            jnative.plan_tree_split(shape, rank))
    np.testing.assert_equal(tnative.plan_tree_split_traffic(shape, rank),
                            jnative.plan_tree_split_traffic(shape, rank))
    np.testing.assert_equal(tnative.pp_cache_flops(shape, rank),
                            jnative.pp_cache_flops(shape, rank))


def test_metrics_copy_matches_original(tmp_path, capsys):
    assert tmetrics.PlotFile.CP_HEADER == jmetrics.PlotFile.CP_HEADER
    assert tmetrics.PlotFile.BENCH_HEADER == jmetrics.PlotFile.BENCH_HEADER
    assert tmetrics.PlotFile.TUCKER_HEADER == \
        jmetrics.PlotFile.TUCKER_HEADER
    outs = []
    for mod in (tmetrics, jmetrics):
        path = tmp_path / f"{mod.__name__}.csv"
        plot = mod.PlotFile(str(path))
        plot.row(12, 3, 0.5, 1e-9, 1, 0.25, 0.125)
        plot.close()
        bench = tmp_path / f"{mod.__name__}.bench.csv"
        plot = mod.PlotFile(str(bench), mod.PlotFile.BENCH_HEADER)
        for kind, secs in (("DTtime", 0.0125), ("PPfirst", 3e-3),
                           ("PPsecond", 1.5e-4)):
            plot.bench_row(kind, secs)
        plot.close()
        outs.append((path.read_text(), bench.read_text(),
                     capsys.readouterr().out))
    assert outs[0] == outs[1]
    clock = tmetrics.SweepClock()
    assert clock.rtt == 0.0
    with clock.exclude():
        pass
    assert clock.dtime() >= 0.0


def test_tracing_scopes():
    tracing.reset()
    assert tracing.timed("x", lambda a: a + 1, 1) == 2
    assert "x" not in tracing.stats()       # disabled: a plain call
    tracing.enable()
    try:
        tracing.timed("x", lambda: None)
        with tracing.timer("y"):
            pass
    finally:
        tracing.enable(False)
    assert tracing.stats()["x"][0] == 1 and tracing.stats()["y"][0] == 1
    assert "timer" in tracing.report().splitlines()[0]
    tracing.reset()


def test_cli_run_refuses_unknown_optimizer():
    with pytest.raises(SystemExit, match="run takes -pp 0"):
        cli.main(["run", "-pp", "5", "-device", "cpu"])
