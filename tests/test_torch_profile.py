"""The port's phase profiler (pairwise_perturbation_tpu_torch/phase_profile.py)
at a tiny size on the CPU, where the profiler records no device activity.
Its numbers come only from a card; here the bookkeeping is checked."""

import math
from types import SimpleNamespace

import pytest
import torch

from pairwise_perturbation_tpu_torch import phase_profile

torch.set_num_threads(1)


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 2), (5, 6)], 3.0),
    ([(0, 4), (1, 2), (3, 6)], 6.0),     # nested and overlapping
    ([(3, 6), (0, 4), (6, 7)], 7.0),     # unsorted, touching
])
def test_busy_is_the_union_of_intervals(intervals, want):
    assert phase_profile.busy_us(intervals) == want


def test_device_events_skip_operators_and_profiler_overhead():
    """An operator row carries its kernels' time again; only the device
    activities count, CUPTI's buffer requests are not work, and neither
    is a host range's mirror on the device's timeline."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    events = [SimpleNamespace(name="aten::copy_", device_type=cpu),
              SimpleNamespace(name="elementwise_kernel", device_type=cuda),
              SimpleNamespace(name="Activity Buffer Request",
                              device_type=cuda),
              SimpleNamespace(name="cp.fit", device_type=cuda,
                              is_user_annotation=True)]
    prof = SimpleNamespace(events=lambda: events)
    assert [e.name for e in phase_profile.device_events(prof)] == \
        ["elementwise_kernel"]


def test_phases_and_run_on_cpu():
    rows = phase_profile.measure_phases((6, 7, 8), 3, "cpu", reps=2)
    assert set(rows) == {"dt_sweep", "pp_build_caches", "pp_sweep",
                         "cp_diagnostics", "svd_solve"}
    for r in rows.values():
        assert r["host_ms"] > 0 and r["device_ms"] == 0.0
    run = phase_profile.measure_run((6, 7, 8), 3, "cpu", maxiter=6)
    assert run["sweeps"] == 7 and run["device_busy_s"] == 0.0
    assert math.isfinite(run["wall_s"]) and run["wall_profiled_s"] > 0


def test_main_refuses_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="CUDA"):
        phase_profile.main()


@pytest.mark.cuda
def test_cuda_span_ranges_are_no_device_work():
    """On the card the port's spans are profiler ranges (scopes off), and
    the profiler mirrors each on the device's timeline: the profile of a
    sweep lists no span as a kernel, and a whole run's busy time leaves
    the fit's mirror out."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pairwise_perturbation_tpu_torch.models import cp
    from pairwise_perturbation_tpu_torch.utils import tracing
    shape, R = (6, 7, 8), 3
    V = torch.rand(shape, device="cuda")
    Ws = cp.init_factors(shape, R, seed=0, device="cuda")
    _, per_name = phase_profile.profile(
        lambda: tracing.timed("cp.dt_sweep", cp.dt_sweep, V, Ws, 0.0),
        "cuda", reps=3)
    assert per_name and not {"cp.dt_sweep", "solve.eigh"} & set(per_name)
    run = phase_profile.measure_run(shape, R, "cuda", maxiter=6)
    # kernels of microseconds between host steps: mostly idle, where the
    # fit's mirror would read it busy throughout
    assert 0.3 < run["idle_profiled"] < 1.0
