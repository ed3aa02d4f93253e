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


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def window(engine, order, seconds: float):
    """Jobs of fits back to back until ``seconds`` have passed; the
    fits and the window's seconds."""
    fits = []
    t0 = time.perf_counter()
    while True:
        for s in order:
            fits.append(engine.fit(s))
        if time.perf_counter() - t0 >= seconds:
            return fits, time.perf_counter() - t0


def traced_window(engine, order, seconds: float):
    """The traced run's window: a profiled stretch with the scopes off,
    a profiled stretch with them on (each scope in a profiler range of
    its name), then fits with the scopes on until ``seconds`` have
    passed. Returns the fits and both profiles with their wall times."""
    import torch
    from benchmark import engine as eng, trace
    seeds = itertools.cycle(order)
    fits = []
    t0 = time.perf_counter()

    def profiled():
        prof = trace.profiler()
        prof.start()
        t = time.perf_counter()
        while True:
            fits.append(engine.fit(next(seeds)))
            if time.perf_counter() - t >= PROFILE_STRETCH_S:
                break
        wall = time.perf_counter() - t
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
    while time.perf_counter() - t0 < seconds:
        fits.append(engine.fit(next(seeds)))
    return fits, quiet, scoped


def main(argv=None) -> int:
    args = parse_args(argv)
    root = Path(args.root).resolve()
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    cell = cells[args.workload]
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

    import torch
    torch.set_num_threads(1)
    if args.device == "cuda":
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < int(cell["chips"]):
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

    # ---- set-up: V, the engine, one untimed fit
    eng.fp32_pins(args.precision)
    gen = load(root, "generators", conf["tensor"]["generator"])
    V = gen.make(tuple(conf["shape"]), conf, device)
    engine = eng.Engine(conf, traffic, V, args.precision)
    order = fit_order(conf.get("fit_seeds", [0]), args.seed)
    engine.fit(order[0])
    cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_window = time.perf_counter()
    setup_s = t_window - T_START

    # ---- the window
    scope_names = sorted(set(itertools.chain.from_iterable(
        getattr(load(root, "metrics", m["name"]), "SCOPES", ())
        for m in bench["per_layer"] if applies(m, args.workload))))
    if args.trace:
        fits, quiet, scoped = traced_window(engine, order, args.seconds)
    else:
        fits, window_s = window(engine, order, args.seconds)
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0

    # ---- metrics
    metrics = {}
    extra = {}
    if args.trace:
        stats, samples = eng.scopes()
        prof_q, wall_q = quiet
        q = trace.Stretch(prof_q, wall_q)
        s = trace.Stretch(scoped[0], scoped[1], scope_names)
        del quiet, scoped, prof_q
        r = Reading(
            fits=fits, stats=stats, samples=samples, ranges=s.ranges,
            busy_s=q.busy_s, window_s=q.wall_s, peak_bytes=window_peak,
            model=conf["model"], shape=tuple(conf["shape"]),
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
    else:
        values = {"fit_s": window_s / len(fits), "setup_s": setup_s}
        for m in bench["end_to_end"]:
            if applies(m, args.workload) and m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": max(setup_peak, window_peak)}
    if args.trace:
        device_info.update(busy_s=q.busy_s, window_s=q.wall_s)

    # ---- correctness, after the window and the memory reading
    failed = sum(1 for f in fits if not (f.converged and f.finite))
    del engine
    if cuda:
        torch.cuda.empty_cache()
    ref = load(root, "references", conf["reference"])
    numbers = ref.judge(V, [f for f in fits if f.finite], conf)
    # a number the reference could not read (no fit converged) fails
    checks = {"unconverged_fits": {"value": failed, "limit": 0}}
    for name, limit in conf["limits"].items():
        checks[name] = {"value": numbers.get(name), "limit": limit}
    correct = all(c["value"] is not None and math.isfinite(c["value"])
                  and c["value"] <= c["limit"] for c in checks.values())
    found = forbidden_modules()
    if found:
        print("modules of JAX or of the JAX package were loaded: "
              + ", ".join(found), file=sys.stderr)
        return 5
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    result = {"correct": correct, "attempted": len(fits), "failed": failed,
              "metrics": metrics, "device": device_info, **extra,
              "fit_seconds": [f.seconds for f in fits], "checks": checks}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
