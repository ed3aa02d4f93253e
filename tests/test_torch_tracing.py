"""The port's spans and counters (utils/tracing) inside its host engines,
and the benchmark's readers of them.

On the CPU, at tiny shapes of the benchmark's tiny configurations:
(a) the counters read the same with the scopes on and off, ``wait.solve``
is every eigh and svd call, ``*.pp_phase`` the PP phases of the fit's
history, and the waits are the ones the code makes; (b) under
``torch.profiler`` with the scopes off each span is one host range a
call, sweeps nest in their fit, and nothing inside ``paused()`` opens a
range; (c) with the scopes on through the benchmark's wrapper a call is
one range, the wrapper's, and a nested span (an eigh of a sweep) passes
neither through the wrapper nor through a sync; (d) the six readers on a synthetic reading;
(e) the traced benchmark run prints them where the fits reach their
names.
"""

import json
import math
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import engine as beng
from benchmark import run as brun
from benchmark.tests.conftest import TINY_CP, TINY_TUCKER, make_root
from pairwise_perturbation_tpu_torch.models import cp, tucker
from pairwise_perturbation_tpu_torch.scripts import span_check
from pairwise_perturbation_tpu_torch.utils import tracing

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SHAPE = tuple(TINY_CP["shape"])
NEW_METRICS = ("host_waits_per_sweep", "pp_phases_per_fit",
               "warmup_share_pct", "diagnostics_share_pct",
               "hosvd_share_pct", "eigh_share_pct")
COUNTERS = ("wait.solve", "wait.pull", "wait.sync", "cp.pp_phase",
            "tucker.pp_phase", "contract.first_kernel",
            "contract.first_einsum", "contract.step_kernel",
            "contract.step_einsum", "contract.v_reads",
            "cp.diag_v_reads")
SWEEPS = ("cp.dt_sweep", "cp.sweep", "cp.pp_sweep", "tucker.dt_sweep",
          "tucker.pp_sweep")
SPANS = SWEEPS + ("cp.fit", "tucker.fit", "warmup", "cp.restart_check",
                  "tucker.restart_check", "solve.eigh", "cp.diagnostics",
                  "tucker.diagnostics", "cp.pp_cache_build", "tucker.hosvd")
ENGINES = ("cp.pp", "cp.dt", "tucker.pp", "tucker.dt")


def _tensor(conf):
    gen = brun.load(REPO, "generators", conf["tensor"]["generator"])
    return gen.make(SHAPE, conf, torch.device("cpu"))


V_CP, V_TK = _tensor(TINY_CP), _tensor(TINY_TUCKER)


def _fit(engine, resprint=1):
    """One fit of a tiny benchmark configuration by the host engine
    ``engine``; a row every ``resprint`` sweeps."""
    if engine.startswith("cp"):
        vn = float(torch.linalg.vector_norm(V_CP))
        cfg = cp.CPConfig(tol=0.01 * vn, pp_res_tol=0.05, resprint=resprint)
        Ws = cp.init_factors(SHAPE, TINY_CP["rank"], seed=2, device="cpu")
        solve = cp.als_cp_pp if engine == "cp.pp" else cp.als_cp_dt
        return solve(V_CP, Ws, cfg)
    vn = float(torch.linalg.vector_norm(V_TK))
    cfg = tucker.TuckerConfig(tol=1e-6 * vn, pp_res_tol=0.1,
                              resprint=resprint)
    solve = tucker.als_tucker_pp if engine == "tucker.pp" \
        else tucker.als_tucker
    return solve(V_TK, TINY_TUCKER["ranks"], cfg)


def _counted(engine, scopes):
    tracing.reset()
    tracing.enable(scopes)
    try:
        res = _fit(engine)
    finally:
        tracing.enable(False)
    return res, tracing.stats()


def _calls(stats, name):
    return stats.get(name, (0,))[0]


def _pp_phases(history):
    """PP phases as a history with a row every sweep shows them: each
    step from a DT row to a PP row."""
    return sum(1 for a, b in zip(history, history[1:])
               if (a["pp"], b["pp"]) == (0, 1))


# ---- (a) counters


@pytest.mark.parametrize("engine", ENGINES)
def test_counters_same_with_scopes_on_and_off(engine, monkeypatch):
    calls = []
    for fn in ("eigh", "svd"):
        real = getattr(torch.linalg, fn)

        def spy(*a, _real=real, **k):
            calls.append(1)
            return _real(*a, **k)
        monkeypatch.setattr(torch.linalg, fn, spy)
    res_off, off = _counted(engine, False)
    n_off = len(calls)
    res_on, on = _counted(engine, True)
    counters = {n: off[n][0] for n in off}
    assert set(counters) <= set(COUNTERS)
    assert all(off[n][1] == 0.0 and math.isnan(off[n][2]) for n in off)
    assert {n: on[n][0] for n in counters} == counters
    assert res_on.iters == res_off.iters
    assert _calls(off, "wait.solve") == n_off == len(calls) - n_off > 0
    model = engine.split(".")[0]
    assert _calls(off, f"{model}.pp_phase") == _pp_phases(res_off.history)
    if engine.endswith(".pp"):
        assert _calls(off, f"{model}.pp_phase") >= 1


@pytest.mark.parametrize("engine", ENGINES)
def test_waits_are_the_codes(engine):
    """Each host wait of a fit, reckoned from its spans: four solves a
    sweep (CP's svd solver, Tucker's extraction) and a warm sweep's;
    HOSVD's four; a pull a restart check; a diagnostics row's floats
    (CP 2, Tucker 3) and its sync; each warm-up's sync and pulls."""
    _, s = _counted(engine, True)
    sweeps = sum(_calls(s, n) for n in SWEEPS)
    model, kind = engine.split(".")
    rows = _calls(s, f"{model}.diagnostics")
    checks = _calls(s, f"{model}.restart_check")
    warm = {"cp.pp": 3, "cp.dt": 1, "tucker.pp": 3, "tucker.dt": 1}[engine]
    warm_sweeps = 2 if kind == "pp" else 1
    warm_pulls = {"cp.pp": 2, "cp.dt": 0, "tucker.pp": 1,
                  "tucker.dt": 0}[engine]
    hosvd = 1 if model == "tucker" else 0
    assert _calls(s, "tucker.hosvd") == hosvd
    assert _calls(s, "warmup") == warm
    assert _calls(s, "wait.solve") == 4 * (sweeps + warm_sweeps + hosvd)
    assert _calls(s, "wait.sync") == rows + warm
    assert _calls(s, "wait.pull") == \
        (2 if model == "cp" else 3) * rows + checks + warm_pulls
    assert (checks > 0) == (engine != "cp.dt" and engine != "tucker.dt")
    if engine == "cp.pp":
        assert checks == _calls(s, "cp.dt_sweep") + _calls(s, "cp.pp_sweep") \
            + _calls(s, "cp.pp_phase")


@pytest.mark.parametrize("engine", ENGINES)
def test_span_check_reckons_each_fit(engine):
    """The chip script's reckoning of a fit's waits from its spans is
    the counters' reading."""
    _, s = _counted(engine, True)
    r = span_check.reckoned(s, "tiny-" + engine)
    assert r["ok"] and r["fits"] == 1 and r["sweeps"] > 0
    assert r["phases"] == _calls(s, engine.split(".")[0] + ".pp_phase")


def test_span_check_refuses_without_a_mode(capsys):
    assert span_check.main([]) == 2
    assert "reckon CELL" in capsys.readouterr().err


def test_count_store():
    tracing.reset()
    tracing.count("c")
    with tracing.paused():
        tracing.count("c", 2)
    assert tracing.stats()["c"][:2] == (3, 0.0)
    assert "counter" in tracing.report() and "c " in tracing.report()
    tracing.reset()
    assert tracing.stats() == {}


# ---- (b) ranges under the profiler, scopes off


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    names = set(SPANS)
    return out, [(e.name, e.time_range.start, e.time_range.end)
                 for e in prof.events() if e.name in names]


@pytest.mark.parametrize("engine", ENGINES)
def test_spans_are_ranges_with_scopes_off(engine):
    _, on = _counted(engine, True)
    tracing.reset()
    _, ranges = _profiled(lambda: _fit(engine))
    assert not tracing.stats().get("cp.fit") and not tracing.enabled()
    by_name = {}
    for name, _, _ in ranges:
        by_name[name] = by_name.get(name, 0) + 1
    # one range a call, none inside the warm-ups (paused, as the stats)
    assert by_name == {n: on[n][0] for n in SPANS if n in on}
    fit = engine.split(".")[0] + ".fit"
    assert by_name[fit] == 1
    _, lo, hi = next(r for r in ranges if r[0] == fit)
    assert all(lo <= s and e <= hi for n, s, e in ranges if n in SWEEPS)
    warm = [(s, e) for n, s, e in ranges if n == "warmup"]
    assert warm and not any(ws < s and e < we for ws, we in warm
                            for n, s, e in ranges if n != "warmup")


def test_paused_opens_no_range():
    def body():
        with tracing.paused():
            tracing.timed("inner.span", lambda: None)
        return tracing.timed("outer.span", lambda: 5)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert body() == 5
    names = [e.name for e in prof.events()]
    assert names.count("outer.span") == 1 and "inner.span" not in names
    assert "outer.span" not in tracing.stats()


# ---- (c) the benchmark's wrapper, scopes on


@pytest.mark.parametrize("engine", ["cp.pp", "tucker.pp"])
def test_scopes_on_open_only_the_wrappers_range(engine, monkeypatch):
    monkeypatch.setattr(tracing, "timed", tracing.timed)
    wrapped = {}

    def in_range(timed, name, fn, *a, **kw):
        wrapped[name] = wrapped.get(name, 0) + 1
        with torch.profiler.record_function(name):
            return timed(name, fn, *a, **kw)
    beng.enable_scopes(in_range)
    try:
        _, ranges = _profiled(lambda: _fit(engine))
        stats = tracing.stats()
    finally:
        tracing.enable(False)
    by_name = {}
    for name, _, _ in ranges:
        by_name[name] = by_name.get(name, 0) + 1
    assert by_name == {n: c for n, c in wrapped.items() if n in SPANS}
    # each wrapped call is a sample; the warm-ups make none inside
    assert {n: stats[n][0] for n in wrapped} == wrapped
    assert stats[engine.split(".")[0] + ".fit"][0] == 1
    # solve.eigh is nested in the sweeps: sampled, never through the
    # wrapper, so it adds no sync or range inside a sweep's sample
    assert "solve.eigh" not in wrapped and stats["solve.eigh"][0] > 0


def _one_sweep(device):
    V = V_CP.to(device)
    Ws = cp.init_factors(SHAPE, TINY_CP["rank"], seed=2, device=device)
    return tracing.timed("cp.dt_sweep", cp.dt_sweep, V, Ws, 0.0)


def test_nested_span_adds_no_sync(monkeypatch):
    """With the scopes on, a sweep's sample ends in its one sync, and
    the eighs inside it are samples of their own with none."""
    syncs = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: syncs.append(1))
    tracing.reset()
    tracing.enable()
    try:
        _one_sweep("cpu")
    finally:
        tracing.enable(False)
    s = tracing.stats()
    assert syncs == [1]
    assert s["solve.eigh"][0] == len(SHAPE) == len(tracing.samples(
        "solve.eigh"))
    assert 0 < s["solve.eigh"][1] < s["cp.dt_sweep"][1]


@pytest.mark.cuda
def test_cuda_nested_span_reads_the_device_clock(monkeypatch):
    """On the card: the sweep's one sync, and each eigh's sample from its
    pair of CUDA events, read when the stats are read."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _one_sweep("cuda")
    torch.cuda.synchronize()
    syncs = []
    real = torch.cuda.synchronize
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: (syncs.append(1), real(*a))[1])
    tracing.reset()
    tracing.enable()
    try:
        for _ in range(3):
            _one_sweep("cuda")
    finally:
        tracing.enable(False)
    assert syncs == [1, 1, 1]
    s = tracing.stats()
    eighs = tracing.samples("solve.eigh")
    assert s["solve.eigh"][0] == len(eighs) == 3 * len(SHAPE)
    assert all(t > 0 for t in eighs)
    assert sum(eighs) < s["cp.dt_sweep"][1]


# ---- (d) the readers


def _reader(name):
    return brun.load(REPO, "metrics", name)


def _reading(stats):
    return brun.Reading(stats={n: (c, s, float("nan"))
                               for n, (c, s) in stats.items()})


def test_readers_known_values():
    r = _reading({"cp.fit": (2, 4.0), "tucker.fit": (0, 0.0),
                  "cp.dt_sweep": (30, 1.0), "cp.pp_sweep": (70, 1.0),
                  "wait.solve": (400, 0.0), "wait.pull": (130, 0.0),
                  "wait.sync": (20, 0.0), "cp.pp_phase": (9, 0.0),
                  "warmup": (6, 0.1), "cp.diagnostics": (40, 0.6),
                  "solve.eigh": (400, 0.4)})
    want = {"host_waits_per_sweep": 5.5, "pp_phases_per_fit": 4.5,
            "warmup_share_pct": 2.5, "diagnostics_share_pct": 15.0,
            "hosvd_share_pct": None, "eigh_share_pct": 10.0}
    for name, value in want.items():
        got = _reader(name).read(r)
        assert got == pytest.approx(value) if value is not None \
            else got is None, name
    t = _reading({"tucker.fit": (4, 2.0), "tucker.hosvd": (4, 0.5),
                  "tucker.dt_sweep": (80, 1.0), "wait.solve": (400, 0.0),
                  "tucker.diagnostics": (12, 0.1)})
    assert _reader("hosvd_share_pct").read(t) == pytest.approx(25.0)
    assert _reader("host_waits_per_sweep").read(t) == pytest.approx(5.0)
    assert _reader("diagnostics_share_pct").read(t) == pytest.approx(5.0)
    assert _reader("pp_phases_per_fit").read(t) == 0.0


@pytest.mark.parametrize("cell,want", [
    ("tiny-cp.pp", (29.25, 46.610169491525426)),
    ("tiny-cp.dt", (30.0, 0.0)),
    ("tiny-tucker.pp", (10.0, 80.0)),
    ("tiny-tucker.dt", (20.0, 0.0))])
def test_older_readers_read_as_before(cell, want, tmp_path, monkeypatch):
    """``sweeps_per_fit`` and ``pp_sweep_share`` of the tiny cells' fit
    seeds, each fit once with the scopes on through a wrapper like the
    harness's: the readings of the program before its spans and
    counters, on the CPU."""
    root = make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    w = next(x for x in bench["workloads"] if x["name"] == cell)
    conf = json.loads((root / "benchmark" / "configs" /
                       f"{w['config']}.json").read_text())
    traffic = brun.data(root, "traffic", w["traffic"])
    V = _tensor(conf)
    engine = beng.Engine(conf, traffic, V)
    monkeypatch.setattr(tracing, "timed", tracing.timed)

    def in_range(timed, name, fn, *a, **kw):
        with torch.profiler.record_function(name):
            return timed(name, fn, *a, **kw)
    beng.enable_scopes(in_range)
    try:
        fits = [engine.fit(s) for s in conf["fit_seeds"]]
    finally:
        tracing.enable(False)
    stats, samples = beng.scopes()
    r = brun.Reading(fits=fits, stats=stats, samples=samples)
    got = tuple(_reader(m).read(r)
                for m in ("sweeps_per_fit", "pp_sweep_share"))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", NEW_METRICS)
def test_readers_none_without_their_names(name):
    # the parent program's scopes: sweeps and diagnostics, no fit span
    # and no counter
    old = _reading({"cp.dt_sweep": (30, 1.0), "cp.pp_sweep": (70, 1.0),
                    "cp.diagnostics": (40, 0.6), "cp.pp_cache_build":
                    (9, 0.1), "tucker.hosvd": (1, 0.1)})
    assert _reader(name).read(old) is None
    assert _reader(name).read(_reading({})) is None


# ---- (e) the traced benchmark run


def test_traced_run_prints_the_new_metrics(tmp_path):
    root = make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    lists = {m["name"]: m["workloads"] for m in bench["per_layer"]}
    procs = {}
    for cell in ("tiny-cp.pp", "tiny-cp.dt", "tiny-tucker.pp",
                 "tiny-tucker.dt"):
        procs[cell] = subprocess.Popen(
            [sys.executable, "-m", "benchmark.run", "--workload", cell,
             "--seed", "3000000019", "--seconds", "1", "--trace", "1",
             "--root", str(root), "--device", "cpu"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    for cell, p in procs.items():
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        res = json.loads(out.strip().splitlines()[-1])
        assert res["correct"] is True
        got = {n for n in res["metrics"] if n in NEW_METRICS}
        want = {n for n in NEW_METRICS if cell in lists[n]}
        if "cp" in cell:
            want.discard("hosvd_share_pct")
        assert got == want, cell
        assert all(math.isfinite(res["metrics"][n]["value"]) for n in got)
        assert res["metrics"]["host_waits_per_sweep"]["value"] > 4.0
