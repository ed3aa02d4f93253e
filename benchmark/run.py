"""Run one cell of ``BENCHMARK.json`` and print its result as the last
line of standard output.

    python -m benchmark.run --workload coil100-cp.pp --seed 7 \\
        --seconds 10 --trace 0

A cell names a configuration (``benchmark/configs/<config>.json``: the
tensor's generator and sizes, the model, rank or ranks, tolerance,
iteration cap, the fits' seeds, the reference and the limits of its
comparison) and a traffic mix (``benchmark/traffic/<traffic>.json``: the
``test_als`` flags of the engine). Per-layer metrics are read by
``benchmark/metrics/<metric>.py``, generators and references live in
``benchmark/generators`` and ``benchmark/references``; everything is
found by the name that the data gives.

A run makes V on the card from the configuration's data seed, warms the
engine with one untimed fit (set-up), then runs fits back to back, one at
a time: each job is the configuration's set of fits in an order drawn
from ``--seed``, and the window runs from the first timed fit to the end
of the job still running when ``--seconds`` have passed. ``fit_s`` is
the window over the fits completed in it. With ``--trace 1`` the first
fits of the window run under ``torch.profiler`` (device busy and idle),
the next with the port's tracing scopes on, each in a profiler range of
its name (scope times, rooflines), the rest with the scopes on.

Once the window has closed and the peak memory is read, every fit's
answer is judged by the configuration's float64 reference, which reads V
and what each fit returned and nothing else of the program.

A cell on N > 1 cards runs as N ranks, one a card: the process started
with the command is a launcher that creates no CUDA context, starts N
processes of this module with torchrun's environment, waits for them
(at most RANKS_SETUP_S + ``--seconds`` + RANKS_JUDGE_S), and prints
rank 0's result as its own last line. Every rank makes its own block of V
(``make_block`` of the generator), runs the same fits in the same order
and judges its block (``judge_block`` of the reference); rank 0's clock
alone decides when a job, a profiled stretch and the window end, and
sends each decision to the other ranks. If a rank fails, or the limit
passes, every rank is killed and the launcher exits with another code
than 0 and no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

PKG = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pairwise_perturbation_tpu")
# fits run under the profiler in a traced run, in each of its two
# profiled stretches, until this many seconds have passed
PROFILE_STRETCH_S = 2.0
# how long the launcher of a cell on several cards waits for its ranks:
# RANKS_SETUP_S of set-up (the first run of a checkout builds the
# kernels), then --seconds of window, then RANKS_JUDGE_S to judge every
# fit's answer
RANKS_SETUP_S = 900.0
RANKS_JUDGE_S = 240.0


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python -m benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--root", default=str(PKG.parent),
                   help="directory of BENCHMARK.json and benchmark/")
    p.add_argument("--device", default="cuda",
                   help="cpu runs the harness without a card (its tests)")
    p.add_argument("--precision", default="fp32",
                   choices=("fp32", "tf32", "bf16v"),
                   help="controls of the comparison: tf32 lifts the port's "
                        "float32 pins, bf16v stores V in bfloat16")
    return p.parse_args(argv)


def load(root: Path, kind: str, name: str):
    """The module ``benchmark/<kind>/<name>.py`` under ``root``."""
    path = root / "benchmark" / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name}".replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def data(root: Path, kind: str, name: str) -> dict:
    return json.loads((root / "benchmark" / kind / f"{name}.json")
                      .read_text())


def applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def fit_order(fit_seeds, seed: int):
    order = list(fit_seeds)
    random.Random(seed).shuffle(order)
    return order


class Reading:
    """What the per-layer readers read (benchmark/metrics/*.py)."""

    def __init__(self, **kw):
        self.notes = {}
        self.__dict__.update(kw)


class Solo:
    """The one process of a one-card cell: its own decisions."""
    rank = 0

    def decide(self, flag: bool) -> bool:
        return flag

    def barrier(self) -> None:
        pass


class Ranks:
    """The ranks of a cell on several cards, joined by
    ``torch.distributed``: rank 0's decisions, sent to every rank, and
    float64 or int64 reductions over the ranks."""

    def __init__(self, device):
        import torch.distributed as dist
        self.dist = dist
        self.device = device
        self.rank = dist.get_rank()

    def _tensor(self, values, dtype):
        import torch
        return torch.tensor(values, dtype=dtype, device=self.device)

    def decide(self, flag: bool) -> bool:
        """Rank 0's ``flag`` on every rank."""
        import torch
        t = self._tensor([int(flag)], torch.int64)
        self.dist.broadcast(t, src=0)
        return bool(t.item())

    def barrier(self) -> None:
        """Return once every rank has reached it."""
        import torch
        t = self._tensor([1], torch.int64)
        self.dist.all_reduce(t)
        t.item()

    def total(self, t):
        """The sum of a tensor over the ranks."""
        t = t.to(self.device)
        self.dist.all_reduce(t)
        return t

    def extreme(self, values, op: str):
        """The ranks' largest (``max``) or smallest (``min``) of each of
        ``values``."""
        import torch
        t = self._tensor(list(values), torch.int64)
        self.dist.all_reduce(t, op=getattr(self.dist.ReduceOp, op.upper()))
        return t.tolist()


def launch(argv, chips: int, seconds: float) -> int:
    """Run the cell as ``chips`` ranks of this module, one a card, with
    torchrun's environment; print rank 0's result, its ``setup_s`` taken
    from this process's start, as the last line. Returns the exit code."""
    import shutil
    import socket
    import tempfile
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(port),
               WORLD_SIZE=str(chips), LOCAL_WORLD_SIZE=str(chips))
    limit = RANKS_SETUP_S + seconds + RANKS_JUDGE_S
    tmp = tempfile.mkdtemp(prefix="bench-ranks-")
    procs, logs = [], []
    try:
        for r in range(chips):
            out = open(os.path.join(tmp, f"{r}.out"), "w+")
            err = open(os.path.join(tmp, f"{r}.err"), "w+")
            logs.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "benchmark.run", *argv],
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                stdout=out, stderr=err, preexec_fn=_die_with_parent))
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or all(c == 0 for c in codes):
                break
            if time.perf_counter() - T_START > limit:
                print(f"the ranks did not finish within {limit:.0f} s",
                      file=sys.stderr)
                failed = [r for r, c in enumerate(codes) if c is None]
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        texts = []
        for out, err in logs:
            out.seek(0)
            err.seek(0)
            texts.append((out.read(), err.read()))
            out.close()
            err.close()
        shutil.rmtree(tmp, ignore_errors=True)
    if failed:
        for r in failed:
            print(f"rank {r} of {chips} ended with code "
                  f"{procs[r].returncode}; the end of its standard error:",
                  file=sys.stderr)
            print("\n".join(texts[r][1].splitlines()[-40:]),
                  file=sys.stderr)
        return 6
    for r in range(1, chips):
        for line in texts[r][1].splitlines():
            print(f"[rank {r}] {line}", file=sys.stderr)
    sys.stderr.write(texts[0][1])
    lines = texts[0][0].splitlines()
    if not lines:
        print("rank 0 printed no result", file=sys.stderr)
        return 6
    result = json.loads(lines[-1])
    window_start = result.pop("window_start")
    if "setup_s" in result["metrics"]:
        result["metrics"]["setup_s"]["value"] = window_start - T_START
    found = forbidden_modules()
    if found:
        print("modules of JAX or of the JAX package were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 5
    for line in lines[:-1]:
        print(line)
    print(json.dumps(result))
    return 0


def _die_with_parent() -> None:
    """In a rank, before it runs: be killed when the launcher ends, so
    that no rank outlives a launcher that was itself killed."""
    import ctypes
    import signal
    try:
        ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass


def ranked(chips: int) -> bool:
    """Whether this process is a rank that a launcher started (torchrun's
    environment, for a world of the cell's size)."""
    return all(os.environ.get(k) for k in
               ("RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")) \
        and os.environ.get("WORLD_SIZE") == str(chips)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def window(engine, order, seconds: float, team=Solo()):
    """Jobs of fits back to back until ``seconds`` have passed (by rank
    0's clock, after each job); the fits and the window's seconds, closed
    once every rank has finished its fits."""
    fits = []
    t0 = time.perf_counter()
    while True:
        for s in order:
            fits.append(engine.fit(s))
        if team.decide(time.perf_counter() - t0 >= seconds):
            team.barrier()
            return fits, time.perf_counter() - t0


def traced_window(engine, order, seconds: float, team=Solo()):
    """The traced run's window: a profiled stretch with the scopes off,
    a profiled stretch with them on (each scope in a profiler range of
    its name), then fits with the scopes on until ``seconds`` have
    passed. Returns the fits and both profiles with their wall times.
    Only rank 0 runs the profiler; every rank runs the same fits with
    the scopes in the same state, each stretch ended by rank 0's
    clock."""
    import torch
    from benchmark import engine as eng, trace
    seeds = itertools.cycle(order)
    fits = []
    t0 = time.perf_counter()

    def profiled():
        prof = trace.profiler() if team.rank == 0 else None
        if prof is not None:
            prof.start()
        t = time.perf_counter()
        while True:
            fits.append(engine.fit(next(seeds)))
            if team.decide(time.perf_counter() - t >= PROFILE_STRETCH_S):
                break
        wall = time.perf_counter() - t
        if prof is not None:
            prof.stop()
        return prof, wall

    def in_range(timed, name, fn, *a, **kw):
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        with torch.profiler.record_function(name):
            return timed(name, fn, *a, **kw)

    quiet = profiled()
    eng.enable_scopes(in_range)
    scoped = profiled()
    while team.decide(time.perf_counter() - t0 < seconds):
        fits.append(engine.fit(next(seeds)))
    return fits, quiet, scoped


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    root = Path(args.root).resolve()
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]
    chips = int(cell["chips"])
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    conf = json.loads((root / entry["file"]).read_text())
    traffic = data(root, "traffic", cell["traffic"])
    # the program's build and kernel caches at fixed paths in the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    # one host thread: the host paces the sweeps, and idle pool threads
    # only compete with it for the machine's cores
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    if chips > 1 and not ranked(chips):
        return launch(argv, chips, args.seconds)

    import torch
    torch.set_num_threads(1)
    if args.device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < chips:
            print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 3
    device = torch.device(args.device)
    try:
        from benchmark import engine as eng
    except ImportError as e:
        print(f"the program is missing: {e}", file=sys.stderr)
        return 4
    from benchmark import peaks, trace

    # ---- set-up: V (a rank's block of it), the engine, one untimed fit
    eng.fp32_pins(args.precision)
    gen = load(root, "generators", conf["tensor"]["generator"])
    shape = tuple(conf["shape"])
    if chips > 1:
        ref = load(root, "references", conf["reference"])
        if not hasattr(gen, "make_block") or not hasattr(ref, "judge_block"):
            print(f"a cell on {chips} cards needs the generator's "
                  "make_block and the reference's judge_block",
                  file=sys.stderr)
            return 2
        device, layout = eng.join(conf, traffic, args.precision, chips,
                                  args.device)
        team = Ranks(device)
        V = gen.make_block(shape, conf, layout, device)
    else:
        layout, team = None, Solo()
        V = gen.make(shape, conf, device)
    engine = eng.Engine(conf, traffic, V, args.precision, layout)
    order = fit_order(conf.get("fit_seeds", [0]), args.seed)
    engine.fit(order[0])
    cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    team.barrier()
    t_window = time.perf_counter()
    setup_s = t_window - T_START

    # ---- the window
    scope_names = sorted(set(itertools.chain.from_iterable(
        getattr(load(root, "metrics", m["name"]), "SCOPES", ())
        for m in bench["per_layer"] if applies(m, args.workload))))
    if args.trace:
        fits, quiet, scoped = traced_window(engine, order, args.seconds,
                                            team)
    else:
        fits, window_s = window(engine, order, args.seconds, team)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0

    # ---- metrics (rank 0's)
    metrics = {}
    extra = {}
    if args.trace and team.rank == 0:
        stats, samples = eng.scopes()
        prof_q, wall_q = quiet
        q = trace.Stretch(prof_q, wall_q)
        s = trace.Stretch(scoped[0], scoped[1], scope_names)
        del quiet, scoped, prof_q
        r = Reading(
            fits=fits, stats=stats, samples=samples, ranges=s.ranges,
            busy_s=q.busy_s, window_s=q.wall_s, peak_bytes=window_peak,
            model=conf["model"], shape=shape, chips=chips,
            block_shape=tuple(V.shape),
            rank=conf.get("rank"), ranks=conf.get("ranks"),
            split=engine.split, itemsize=V.element_size(), peaks=peaks)
        for m in bench["per_layer"]:
            if applies(m, args.workload):
                v = load(root, "metrics", m["name"]).read(r)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        extra["breakdown"] = {"device_ops": trace.top(q.kernels, chars=120),
                              "idle_gaps": trace.top(q.idle_gaps())}
        if cuda:
            print(f"card and power limit: {power_limit()}; roofline bounds: "
                  f"{r.notes}", file=sys.stderr)
    elif not args.trace:
        values = {"fit_s": window_s / len(fits), "setup_s": setup_s}
        for m in bench["end_to_end"]:
            if applies(m, args.workload) and m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    peak = max(setup_peak, window_peak)
    if chips > 1:
        print(f"rank {team.rank}: memory peak {peak} bytes", file=sys.stderr)
        peak = team.extreme([peak], "max")[0]
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": chips, "memory_peak_bytes": peak}
    if args.trace and team.rank == 0:
        device_info.update(busy_s=q.busy_s, window_s=q.wall_s)

    # ---- correctness, after the window and the memory reading
    failed = sum(1 for f in fits if not (f.converged and f.finite))
    checks = {"unconverged_fits": {"value": failed, "limit": 0}}
    if chips > 1:
        checks["rank_disagreement"] = {"value": disagreement(fits, team),
                                       "limit": 0}
    del engine
    if cuda:
        torch.cuda.empty_cache()
    finite = [f for f in fits if f.finite]
    if chips > 1:
        numbers = ref.judge_block(
            V, [layout.span(m) for m in range(len(shape))], finite, conf,
            team.total)
        eng.leave()
    else:
        ref = load(root, "references", conf["reference"])
        numbers = ref.judge(V, finite, conf)
    # a number the reference could not read (no fit converged) fails
    for name, limit in conf["limits"].items():
        checks[name] = {"value": numbers.get(name), "limit": limit}
    correct = all(c["value"] is not None and math.isfinite(c["value"])
                  and c["value"] <= c["limit"] for c in checks.values())
    found = forbidden_modules()
    if found:
        print("modules of JAX or of the JAX package were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 5
    if team.rank != 0:
        return 0
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    result = {"correct": correct, "attempted": len(fits), "failed": failed,
              "metrics": metrics, "device": device_info, **extra,
              "fit_seconds": [f.seconds for f in fits], "checks": checks}
    if chips > 1:
        # the launcher takes setup_s from its own start
        result = {"window_start": t_window, **result}
    print(json.dumps(result))
    return 0


def disagreement(fits, team) -> int:
    """The fits whose sweeps or convergence differ between the ranks (all
    of them where the ranks ran different numbers of fits)."""
    n = len(fits)
    if team.extreme([n], "max") != team.extreme([n], "min"):
        return n
    mine = [f.iters for f in fits] + [int(f.converged) for f in fits]
    hi, lo = team.extreme(mine, "max"), team.extreme(mine, "min")
    return sum(1 for k in range(n)
               if hi[k] != lo[k] or hi[n + k] != lo[n + k])


if __name__ == "__main__":
    raise SystemExit(main())
