"""The port's spans and counters (utils/tracing) at the benchmark's cells,
on one CUDA card, run from the root of a checkout:

    python -m pairwise_perturbation_tpu_torch.scripts.span_check costs
    python -m pairwise_perturbation_tpu_torch.scripts.span_check reckon CELL
    python -m pairwise_perturbation_tpu_torch.scripts.span_check ranges CELL
    python -m pairwise_perturbation_tpu_torch.scripts.span_check nested CELL
    python -m pairwise_perturbation_tpu_torch.scripts.span_check outer CELL
    python -m pairwise_perturbation_tpu_torch.scripts.span_check pairs \\
        OUT PARENT CHANGE CELL:SEED:TRACE:SIDE,...

Each prints one JSON line.

- ``costs``: host microseconds a call of ``tracing.count`` and of
  ``tracing.timed`` with the scopes off, under a profiler (a range) and
  with the scopes on, beside a direct call.
- ``reckon CELL``: the engine as the benchmark builds it
  (``benchmark/engine.py``), one untimed fit, then the configuration's
  fits (a) with the scopes off, (b) under ``torch.profiler`` with the
  scopes off (the spans as ranges), (c) the same with ``tracing.timed``
  and ``tracing.nested`` swapped for plain calls (no ranges), and (d) with
  the scopes on through a wrapper like the benchmark's (a sync and a
  range around each ``timed`` call). Per fit of (d), the host waits that
  the code makes, reckoned from the spans' calls, beside the counters,
  and whether the counters equal (a)'s. The mean fit seconds of each
  mode give the cost of the ranges and of the scopes.
- ``ranges CELL``: fits alternating between ranges on and off inside one
  profiler session, then with the profiler off; then a quiet stretch as
  the benchmark's traced run takes it, with its device idle share and its
  idle gaps by the innermost host operation.
- ``nested CELL``: with the scopes on, fits alternating between
  ``solve.eigh`` as a nested span, as a plain call and as a span through
  ``tracing.timed``, with the profiler off and then on; the median sweep
  samples of each, so the nested span's cost to the sweeps it sits in.
- ``outer CELL``: the same, fits alternating between the spans as they
  are and the program without its fit, warm-up and eigh spans, each
  profiled fit in a profiler session of its own, as the benchmark's
  scoped stretch runs it.
- ``pairs OUT PARENT CHANGE PLAN``: benchmark runs (``--seconds 10``) of
  the checkouts PARENT and CHANGE in the order PLAN gives, one JSON line a
  run appended to ``OUT/runs.jsonl``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from pairwise_perturbation_tpu_torch.utils import tracing

SWEEPS = ("cp.dt_sweep", "cp.sweep", "cp.pp_sweep", "tucker.dt_sweep",
          "tucker.pp_sweep")
COUNTERS = ("wait.solve", "wait.pull", "wait.sync", "cp.pp_phase",
            "tucker.pp_phase")


def in_range(timed, name, fn, *a, **kw):
    """The benchmark's wrapper of a scoped call: a sync, then a range."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    with torch.profiler.record_function(name):
        return timed(name, fn, *a, **kw)


def reckoned(stats, cell: str) -> dict:
    """The host waits of one fit as the code makes them, from the spans'
    calls: four solves a sweep and a warm sweep, HOSVD's four; a
    diagnostics row's floats (CP 2, Tucker 3) and its sync; a pull a
    restart check; each warm-up's sync and pulls."""
    def c(n):
        return stats.get(n, (0,))[0]
    model = "cp" if "-cp." in cell else "tucker"
    pp = cell.endswith(".pp")
    fits = c(f"{model}.fit")
    sweeps = sum(c(n) for n in SWEEPS)
    rows = c(f"{model}.diagnostics")
    checks = c(f"{model}.restart_check")
    warm = 3 if pp else 1
    warm_sweeps = 2 if pp else 1
    warm_pulls = (2 if model == "cp" else 1) if pp else 0
    want = {"wait.solve": 4 * (sweeps + warm_sweeps * fits
                               + c("tucker.hosvd")),
            "wait.sync": rows + warm * fits,
            "wait.pull": (2 if model == "cp" else 3) * rows + checks
            + warm_pulls * fits}
    got = {n: c(n) for n in want}
    return dict(sweeps=sweeps, rows=rows, checks=checks,
                phases=c(f"{model}.pp_phase"), fits=fits, got=got,
                want=want, ok=got == want,
                waits_per_sweep=sum(got.values()) / max(sweeps, 1))


def _engine(cell: str):
    from benchmark import engine as eng, run as brun
    root = Path(".").resolve()
    bench = json.loads((root / "BENCHMARK.json").read_text())
    w = next(x for x in bench["workloads"] if x["name"] == cell)
    entry = next(x for x in bench["configs"] if x["name"] == w["config"])
    conf = json.loads((root / entry["file"]).read_text())
    traffic = brun.data(root, "traffic", w["traffic"])
    torch.set_num_threads(1)
    eng.fp32_pins("fp32")
    V = brun.load(root, "generators", conf["tensor"]["generator"]).make(
        tuple(conf["shape"]), conf, torch.device("cuda"))
    e = eng.Engine(conf, traffic, V)
    seeds = conf.get("fit_seeds", [0])
    e.fit(seeds[0])
    return e, seeds


def _plain(name, fn, *a, **kw):
    return fn(*a, **kw)


class _no_ranges:
    """``tracing.timed`` and ``tracing.nested`` as plain calls."""

    def __enter__(self):
        self.real = tracing.timed, tracing.nested
        tracing.timed = tracing.nested = _plain

    def __exit__(self, *exc):
        tracing.timed, tracing.nested = self.real


def reckon(cell: str) -> dict:
    from benchmark import engine as eng, trace
    e, seeds = _engine(cell)
    n_rep = 1 if len(seeds) > 1 else 4
    order = [s for _ in range(n_rep) for s in seeds]
    out = {"cell": cell}
    off, secs = [], {}
    secs["off"] = []
    for s in order:
        tracing.reset()
        secs["off"].append(e.fit(s).seconds)
        off.append({n: v[0] for n, v in tracing.stats().items()})
    prof = trace.profiler()
    prof.start()
    secs["ranges"] = [e.fit(s).seconds for s in order]
    prof.stop()
    prof = trace.profiler()
    prof.start()
    with _no_ranges():
        secs["no_ranges"] = [e.fit(s).seconds for s in order]
    prof.stop()
    del prof
    fits = []
    eng.enable_scopes(in_range)
    secs["scoped"] = []
    for k, s in enumerate(order):
        tracing.reset()
        secs["scoped"].append(e.fit(s).seconds)
        st = tracing.stats()
        r = reckoned(st, cell)
        r["counters_equal_off"] = all(st.get(n, (0,))[0] == off[k].get(n, 0)
                                      for n in COUNTERS)
        fits.append(r)
    tracing.enable(False)
    out["fits"] = fits
    out["fit_s"] = secs
    out["mean_fit_s"] = {m: statistics.mean(v) for m, v in secs.items()}
    return out


def ranges(cell: str) -> dict:
    from benchmark import trace
    e, seeds = _engine(cell)
    seed = seeds[0]
    rounds = 3 if "-cp." in cell else 6
    secs = {"ranges": [], "no_ranges": []}
    prof = trace.profiler()
    prof.start()
    for _ in range(rounds):
        secs["ranges"].append(e.fit(seed).seconds)
        with _no_ranges():
            secs["no_ranges"].append(e.fit(seed).seconds)
    prof.stop()
    off = [e.fit(seed).seconds for _ in range(rounds)]
    prof = trace.profiler()
    prof.start()
    quiet = [e.fit(seed).seconds for _ in range(2 if "-cp." in cell else 5)]
    prof.stop()
    q = trace.Stretch(prof, sum(quiet))
    gaps = q.idle_gaps()
    return dict(cell=cell, fit_s=secs, profiler_off_s=off,
                median={m: statistics.median(v) for m, v in secs.items()},
                profiler_off_median=statistics.median(off),
                quiet_idle_pct=100 * (1 - q.busy_s / q.wall_s),
                python_gap_s=gaps.get("python", 0.0),
                gaps=trace.top(gaps, 25),
                device_ops=trace.top(q.kernels, chars=120))


EXACT = ("cp.dt_sweep", "cp.sweep", "tucker.dt_sweep")


def nested(cell: str) -> dict:
    """With the scopes on through the wrapper, fits alternating between
    three treatments of ``solve.eigh`` inside the sweeps: a nested span
    (two CUDA events), a plain call (the program before its spans) and a
    span through ``tracing.timed`` (the wrapper's sync and range, and
    timed's sync), with the profiler off, then on; the median exact- and
    PP-sweep samples of each."""
    from benchmark import engine as eng, trace
    e, seeds = _engine(cell)
    real = tracing.nested
    modes = {"events": real, "plain": _plain,
             "synced": lambda name, fn, *a, **kw:
             tracing.timed(name, fn, *a, **kw)}
    rounds = 2 if "-cp." in cell else 5
    eng.enable_scopes(in_range)
    out = {"cell": cell}
    for profiled in (False, True):
        samples = {m: {"exact": [], "pp": []} for m in modes}
        prof = trace.profiler() if profiled else None
        if prof:
            prof.start()
        for _ in range(max(rounds // 2, 1) if profiled else rounds):
            for m, fn in modes.items():
                tracing.nested = fn
                tracing.reset()
                e.fit(seeds[0])
                for n in EXACT:
                    samples[m]["exact"] += tracing.samples(n)
                for n in ("cp.pp_sweep", "tucker.pp_sweep"):
                    samples[m]["pp"] += tracing.samples(n)
        tracing.nested = real
        if prof:
            prof.stop()
            del prof
        out["profiled" if profiled else "unprofiled"] = {
            m: {k: 1e3 * statistics.median(v) if v else None
                for k, v in d.items()} for m, d in samples.items()}
    tracing.enable(False)
    return out


OUTER = ("cp.fit", "tucker.fit", "warmup")


def outer(cell: str) -> dict:
    """With the scopes on through the wrapper, fits alternating between
    the program's spans as they are and the program without its new
    spans (``cp.fit``, ``tucker.fit`` and ``warmup`` plain calls,
    ``solve.eigh`` a plain call), with the profiler off, then on; the
    median exact- and PP-sweep samples of each."""
    from benchmark import engine as eng, trace
    e, seeds = _engine(cell)
    eng.enable_scopes(in_range)
    wrapped, real_nested = tracing.timed, tracing.nested

    def without(name, fn, *a, **kw):
        if name in OUTER:
            return fn(*a, **kw)
        return wrapped(name, fn, *a, **kw)
    modes = {"spans": (wrapped, real_nested), "without": (without, _plain)}
    rounds = 3 if "-cp." in cell else 6
    out = {"cell": cell}
    for profiled in (False, True):
        samples = {m: {"exact": [], "pp": []} for m in modes}
        for _ in range(rounds):
            for m, (t, n) in modes.items():
                tracing.timed, tracing.nested = t, n
                tracing.reset()
                prof = trace.profiler() if profiled else None
                if prof:
                    prof.start()
                e.fit(seeds[0])
                if prof:
                    prof.stop()
                    del prof
                for k in EXACT:
                    samples[m]["exact"] += tracing.samples(k)
                for k in ("cp.pp_sweep", "tucker.pp_sweep"):
                    samples[m]["pp"] += tracing.samples(k)
        tracing.timed, tracing.nested = wrapped, real_nested
        out["profiled" if profiled else "unprofiled"] = {
            m: {k: 1e3 * statistics.median(v) if v else None
                for k, v in d.items()} for m, d in samples.items()}
    tracing.enable(False)
    return out


def costs() -> dict:
    from benchmark import trace

    def f(x):
        return x

    def clock(fn, n):
        t = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t) / n * 1e6
    tracing.reset()
    res = {"direct_us": clock(lambda: f(1), 200000),
           "timed_off_us": clock(lambda: tracing.timed("x", f, 1), 200000),
           "count_us": clock(lambda: tracing.count("x"), 200000)}
    prof = trace.profiler()
    prof.start()
    res["timed_profiled_us"] = clock(lambda: tracing.timed("x", f, 1), 20000)
    res["direct_profiled_us"] = clock(lambda: f(1), 20000)
    prof.stop()
    tracing.enable()
    res["timed_on_us"] = clock(lambda: tracing.timed("x", f, 1), 20000)
    tracing.enable(False)
    tracing.reset()
    return res


def pairs(out_dir: str, parent: str, change: str, plan: str) -> dict:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    done = []
    for item in plan.split(","):
        cell, seed, tr, side = item.split(":")
        t = time.time()
        p = subprocess.run(
            [sys.executable, "-m", "benchmark.run", "--workload", cell,
             "--seed", seed, "--seconds", "10", "--trace", tr],
            cwd=parent if side == "parent" else change, capture_output=True,
            text=True, timeout=400)
        rec = dict(cell=cell, seed=int(seed), trace=int(tr), side=side,
                   rc=p.returncode, wall=time.time() - t,
                   err=p.stderr[-1500:] if p.returncode else p.stderr[-400:])
        try:
            rec["result"] = json.loads(p.stdout.strip().splitlines()[-1])
        except (IndexError, ValueError):
            rec["stdout"] = p.stdout[-1000:]
        with open(out / "runs.jsonl", "a") as fh:
            fh.write(json.dumps(rec) + "\n")
        m = rec.get("result", {}).get("metrics", {})
        print(cell, side, tr, seed, p.returncode, round(rec["wall"], 1),
              {k: round(v["value"], 4) for k, v in m.items()},
              file=sys.stderr, flush=True)
        done.append((cell, side, p.returncode))
    return {"runs": done}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] not in ("costs", "reckon", "ranges", "nested",
                                   "outer", "pairs"):
        print(__doc__, file=sys.stderr)
        return 2
    if argv[0] == "pairs":
        print(json.dumps(pairs(*argv[1:5])))
        return 0
    if not torch.cuda.is_available():
        raise SystemExit("span_check needs a CUDA device")
    mode = {"costs": lambda: costs(), "reckon": lambda: reckon(argv[1]),
            "ranges": lambda: ranges(argv[1]),
            "nested": lambda: nested(argv[1]),
            "outer": lambda: outer(argv[1])}[argv[0]]
    print(json.dumps(mode()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
