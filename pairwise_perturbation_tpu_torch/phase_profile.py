"""Host time, device busy time and idle share of each CP-ALS phase on one
CUDA card.

    python -m pairwise_perturbation_tpu_torch.phase_profile

For two f32 problems at rank 10, the order-3 200^3 tensor and the order-4
coil-100 shape (3, 128, 128, 7200), each filled from a seeded
``torch.Generator``, it times the phases the DT <-> PP phase machine runs:
``dt_sweep``, ``pp_build_caches``, ``pp_sweep``, ``cp_diagnostics`` and one
R x R ``svd_solve``. Then it profiles one whole ``als_cp_pp`` run of
``MAXITER`` sweeps.

- host ms: median over ``REPS`` calls of the wall time of one call that
  ends in ``torch.cuda.synchronize()``, with no profiler attached;
- device ms: the union of the intervals of the device activities (kernels,
  copies, sets) that ``torch.profiler`` records, per call. Only device
  events count: the operator rows that enclose a kernel carry the same
  time again and are left out, and so are the device mirrors of host
  ranges (the port's spans, utils/tracing);
- idle: 1 - device / host.

The top kernels by device time follow each phase. The last line is the
JSON of all numbers.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time
from collections import defaultdict
from typing import Callable, Dict, Iterable, List, Tuple

import torch

from pairwise_perturbation_tpu_torch import config, native
from pairwise_perturbation_tpu_torch.models import cp
from pairwise_perturbation_tpu_torch.ops import contract, solve

PROBLEMS = {"o3_200": (200, 200, 200), "coil": (3, 128, 128, 7200)}
RANK = 10
SEED = 0
REPS = 10
MAXITER = 40
TOP_KERNELS = 4
# CUPTI's own bookkeeping; recorded as a device activity but no work of
# the program.
_PROFILER_OVERHEAD = ("Activity Buffer Request",)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def phase_calls(shape, R: int, device) -> Dict[str, Callable[[], object]]:
    """The phases of one CP-PP run as closures over a state that the
    phase machine would hold: factors after one DT sweep, fresh PP caches,
    and a PP step 1% of the factors' size."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    V = torch.rand(shape, generator=gen, device=device)
    split = native.plan_tree_split_traffic(shape, R)[0]
    Ws, _ = cp.dt_sweep(V, cp.init_factors(shape, R, seed=SEED,
                                           device=device), 0.0,
                        root_split=split)
    single, pair = cp.pp_build_caches(V, Ws)
    dWs = [0.01 * W for W in Ws]
    V_norm_sq = contract.norm_sq(V)
    M = contract.mttkrp(V, Ws, 0)
    S = contract.hadamard_gram(Ws, skip_mode=0)
    return {
        "dt_sweep": lambda: cp.dt_sweep(V, Ws, 0.0, root_split=split),
        "pp_build_caches": lambda: cp.pp_build_caches(V, Ws),
        "pp_sweep": lambda: cp.pp_sweep(single, pair, Ws, Ws, dWs, 0.0, 1.0),
        "cp_diagnostics": lambda: cp.cp_diagnostics(V_norm_sq, V, Ws,
                                                    root_split=split),
        "svd_solve": lambda: solve.svd_solve(M, S),
    }


def host_ms(fn, device, reps: int, warmup: int = 3) -> List[float]:
    """Wall ms of ``reps`` calls, each ended by a device sync."""
    for _ in range(warmup):
        fn()
    _sync(device)
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def busy_us(intervals: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_events(prof) -> List:
    """The device activities of a finished profile, enclosing operator
    rows and profiler overhead left out, and the mirrors of host ranges
    (``record_function``, the port's spans) that the profiler lays on the
    device's timeline over the kernels they hold."""
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events()
            if e.device_type == cuda and e.name not in _PROFILER_OVERHEAD
            and not getattr(e, "is_user_annotation", False)]


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile as tprofile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return tprofile(activities=acts)


def profile(fn, device, reps: int):
    """(device busy ms per call, {kernel name: device ms per call})."""
    fn()
    _sync(device)
    with _profiler(device) as prof:
        for _ in range(reps):
            fn()
        _sync(device)
    events = device_events(prof)
    per_name: Dict[str, float] = defaultdict(float)
    for e in events:
        per_name[e.name] += e.time_range.elapsed_us() / 1e3 / reps
    busy = busy_us((e.time_range.start, e.time_range.end) for e in events)
    return busy / 1e3 / reps, dict(per_name)


def measure_phases(shape, R: int, device, reps: int):
    rows = {}
    for name, fn in phase_calls(shape, R, device).items():
        host = statistics.median(host_ms(fn, device, reps))
        dev, per_name = profile(fn, device, reps)
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]
        rows[name] = dict(host_ms=host, device_ms=dev, idle=1.0 - dev / host,
                          top=dict(top))
    return rows


def measure_run(shape, R: int, device, maxiter: int):
    """Wall s of one ``als_cp_pp`` run without and with the profiler, and
    the device busy share of the profiled run."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    V = torch.rand(shape, generator=gen, device=device)
    cfg = cp.CPConfig(tol=0.0, pp_res_tol=0.1, maxiter=maxiter,
                      resprint=1,
                      tree_split=native.plan_tree_split_traffic(shape, R)[0])

    def run():
        Ws = cp.init_factors(shape, R, seed=SEED, device=device)
        _sync(device)
        t0 = time.perf_counter()
        res = cp.als_cp_pp(V, Ws, cfg)
        _sync(device)
        return time.perf_counter() - t0, res

    run()
    wall, res = run()
    with _profiler(device) as prof:
        wall_prof, _ = run()
    busy = busy_us((e.time_range.start, e.time_range.end)
                   for e in device_events(prof)) / 1e6
    return dict(sweeps=res.iters,
                pp_rows=sum(1 for h in res.history if h["pp"] == 1),
                wall_s=wall, wall_profiled_s=wall_prof, device_busy_s=busy,
                idle_profiled=1.0 - busy / wall_prof)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("phase_profile needs a CUDA device")
    config.apply_fp32_pins()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"{smi}; torch {torch.__version__}")
    result = dict(device=smi, torch=torch.__version__, reps=REPS)
    for key, shape in PROBLEMS.items():
        rows = measure_phases(shape, RANK, "cuda", REPS)
        for name, r in rows.items():
            print(f"{key} {name}: host {r['host_ms']:.3f} ms, device "
                  f"{r['device_ms']:.3f} ms, idle {r['idle']:.3f}")
            for k, v in r["top"].items():
                print(f"    {v:9.3f} ms  {k[:90]}")
        run = measure_run(shape, RANK, "cuda", MAXITER)
        print(f"{key} als_cp_pp: {run}")
        result[key] = dict(phases=rows, run=run)
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
