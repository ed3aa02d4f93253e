"""PP against DT end to end: the time each takes to reach the same fitness
(als_CP.cxx:621-833; arXiv:1811.10573 Figs. 5-8). The port's counterpart
of ``scripts/bench_pp_e2e.py``.

For each config, runs DT-ALS (``cp.als_cp_dt``) and the fused DT <-> PP
machine (``cp.als_cp_pp_fused``, chunks of 64 body steps) from identical
factors, then reports the first ``dtime`` at which each trajectory
reaches the same fitness target under ``fitness.equal_fitness_times``'
rule (sustained when both runs plateau, else first crossing of the worse
final row). Configs, as in the original: the coil-100 shape (the file
``data/coil-100.bin`` of the checkout when present, in its natural mode
order, else a uniform random tensor of its shape times 255) and the
order-6 strong-scaling family at ``--s6`` (24; 16 with ``--quick``): an
exact-rank ``r`` tensor, a 5%-noise ``c`` tensor and a collinearity
(0.5-0.9) ``col`` tensor with 1% noise, rank 6. An order-6 CP tensor is
built on the device from its factors as one ``torch.matmul`` of two
Khatri-Rao halves. ``--sweep`` runs the restart-tolerance grid {0.005,
0.01, 0.05, 0.1} and keeps each config's best.

    python -m pairwise_perturbation_tpu_torch.scripts.bench_pp_e2e \\
        --out DIR [--device cpu] [--quick] [--only=NAME] [--sweep] \\
        [--s6 S] [--coil-shape 3,128,128,7200] [--maxiter N]

Writes ``DIR/pp_e2e.json`` (merged into the file's earlier entries) and
``DIR/PP_WINS.md``, and nothing else; the last line of its output is one
JSON object of this run's per-config entries. The card by default; no
CUDA device exits 2.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from pairwise_perturbation_tpu_torch import native
from pairwise_perturbation_tpu_torch.models import cp
from pairwise_perturbation_tpu_torch.ops import contract
from pairwise_perturbation_tpu_torch.scripts import _bench
from pairwise_perturbation_tpu_torch.scripts.fitness import (
    equal_fitness_times, final_row_fitness)
from pairwise_perturbation_tpu_torch.utils import io, synth

R6 = 6
COIL_BIN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "..", "data", "coil-100.bin")


def _shape(text: str):
    return tuple(int(s) for s in text.split(","))


def _parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True,
                   help="directory for pp_e2e.json and PP_WINS.md")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--quick", action="store_true",
                   help="maxiter 40 and s6 16 (else 250 and 24)")
    p.add_argument("--only", action="append", default=[],
                   help="run only this config (repeatable)")
    p.add_argument("--sweep", action="store_true",
                   help="the restart-tolerance grid, best per config")
    p.add_argument("--s6", type=int, default=None,
                   help="size of the order-6 tensors' modes")
    p.add_argument("--coil-shape", type=_shape, default=_bench.COIL_SHAPE,
                   help="shape of the coil stand-in (no data file)")
    p.add_argument("--maxiter", type=int, default=None)
    return p.parse_args(argv)


def khatri_rao(ws):
    """Rows (i_0, ..., i_k) of the column-wise Kronecker product."""
    A = ws[0]
    for w in ws[1:]:
        A = (A[:, None, :] * w[None, :, :]).reshape(-1, A.shape[1])
    return A


def build_dense(Ws):
    """The CP tensor of the factors ``Ws``: two Khatri-Rao halves and one
    matmul, whose (prod s[:h], prod s[h:]) output reshapes to V."""
    h = len(Ws) // 2
    out = khatri_rao(Ws[:h]) @ khatri_rao(Ws[h:]).T
    return out.reshape(tuple(w.shape[0] for w in Ws))


def cp_tensor(shape, R, seed, device, noise=0.0, col=None):
    """A CP-structured float32 tensor built on ``device`` from numpy
    factors of ``seed`` (collinearity ``col`` = (min, max), rank weights
    folded into mode 0), plus ``noise`` x ||V|| of uniform(-1, 1) noise
    drawn on the device from seed + 1."""
    rng = np.random.default_rng(seed)
    if col is not None:
        Ws, lams = synth.gen_collinearity_factors(list(shape), R, col[0],
                                                  col[1], rng)
        Ws = [w.astype(np.float32) for w in Ws]
        Ws[0] = Ws[0] * lams.astype(np.float32)[None, :]
    else:
        Ws = [rng.random((s, R)).astype(np.float32) for s in shape]
    V = build_dense([torch.from_numpy(w).to(device) for w in Ws])
    if noise:
        gen = torch.Generator(device=device).manual_seed(seed + 1)
        nz = torch.rand(shape, generator=gen, device=device) * 2.0 - 1.0
        V = V + nz * (noise * torch.linalg.vector_norm(V)
                      / torch.linalg.vector_norm(nz))
    return V


def configs(args, maxiter):
    s6 = args.s6 or (16 if args.quick else 24)
    out = []
    if os.path.exists(COIL_BIN):
        out.append(dict(name="coil_standin_f32", path=COIL_BIN, R=10,
                        restol=0.1, kind="coil", maxiter=maxiter))
    else:
        out.append(dict(name="coil_shape_f32", shape=args.coil_shape, R=10,
                        restol=0.1, kind="random", maxiter=maxiter))
    for kind, tag in (("cp", "r"), ("cp_noise", "c"), ("col", "col")):
        out.append(dict(name=f"order6_s{s6}_{tag}", shape=(s6,) * 6, R=R6,
                        restol=0.1, kind=kind, maxiter=maxiter))
    if args.only:
        out = [c for c in out if c["name"] in args.only]
    return out


def make_tensor(c, device):
    if c["kind"] == "coil":
        return torch.from_numpy(io.load_coil100(c["path"])).to(device)
    if c["kind"] == "random":
        gen = torch.Generator(device=device).manual_seed(0)
        return torch.rand(c["shape"], generator=gen, device=device) * 255.0
    if c["kind"] == "cp":
        return cp_tensor(c["shape"], c["R"], 3, device)
    if c["kind"] == "col":
        return cp_tensor(c["shape"], c["R"], 7, device, noise=0.01,
                         col=(0.5, 0.9))
    return cp_tensor(c["shape"], c["R"], 5, device, noise=0.05)


def run_config(c, device, restols):
    """DT, then the fused machine at each restart tolerance, from the same
    factors; returns the per-restol entries and the best."""
    V = make_tensor(c, device)
    shape, R = tuple(V.shape), c["R"]
    print(f"[{c['name']}] shape={shape} R={R}", flush=True)
    Vn = float(torch.sqrt(contract.norm_sq(V)))
    W0 = cp.init_factors(shape, R, seed=0, dtype=torch.float32,
                         device=device)
    split, _, _ = native.plan_tree_split_traffic(shape, R)
    if split == (len(shape) - 1) // 2:
        split = None
    common = dict(tol=1e-10 * Vn, maxiter=c["maxiter"], resprint=5,
                  solver="svd", tree_split=split)
    res_dt = cp.als_cp_dt(V, [w.clone() for w in W0],
                          cp.CPConfig(pp_res_tol=restols[0], **common))
    print(f"  DT : final diffV {res_dt.diffV:.6e} dtime "
          f"{res_dt.history[-1]['dtime']:.3f}s iters {res_dt.iters}",
          flush=True)
    entries, best = {}, None
    for rt in restols:
        res_pp = cp.als_cp_pp_fused(V, [w.clone() for w in W0],
                                    cp.CPConfig(pp_res_tol=rt, **common),
                                    chunk=64)
        print(f"  PP rt={rt}: final diffV {res_pp.diffV:.6e} dtime "
              f"{res_pp.history[-1]['dtime']:.3f}s iters {res_pp.iters}",
              flush=True)
        t_dt, t_pp, target, rule = equal_fitness_times(res_dt.history,
                                                       res_pp.history)
        speedup = (t_dt / t_pp) if (t_dt is not None and t_pp) else None
        print(f"  target {target:.6e} ({rule}): DT {t_dt} s, PP {t_pp} s, "
              f"speedup {speedup}", flush=True)
        pps = [h["pp"] for h in res_pp.history]
        entry = dict(
            shape=list(shape), rank=R, restol=rt, maxiter=c["maxiter"],
            pp_row_fraction=sum(pps) / max(len(pps), 1),
            pp_phase_flips_logged=sum(1 for a, b in zip(pps, pps[1:])
                                      if a != b),
            dt_final_diffV=res_dt.diffV, pp_final_diffV=res_pp.diffV,
            dt_last_row_diffV=final_row_fitness(res_dt.history),
            pp_last_row_diffV=final_row_fitness(res_pp.history),
            dt_time_to_target=t_dt, pp_time_to_target=t_pp,
            dt_total_dtime=float(res_dt.history[-1]["dtime"]),
            pp_total_dtime=float(res_pp.history[-1]["dtime"]),
            target_diffV=target, speedup=speedup, fitness_rule=rule,
            dt_iters=res_dt.iters, pp_iters=res_pp.iters,
            dt_rows_finite=all(np.isfinite(h["diffV"])
                               for h in res_dt.history),
            pp_rows_finite=all(np.isfinite(h["diffV"])
                               for h in res_pp.history),
            note="DT host-driven; PP fused machine; identical initial "
                 "factors; total equal-fitness rule")
        if len(restols) > 1:
            entries[f"{c['name']}_rt{rt}"] = entry
        if best is None or (entry["speedup"] or 0) > (best["speedup"] or 0):
            best = entry
    entries[c["name"]] = dict(best, best_of_restols=restols) \
        if len(restols) > 1 else best
    return entries


def _cell(x, fmt="{:.3f}", none="never"):
    return none if x is None else fmt.format(x)


def wins_md(summary, device_name):
    lines = [
        f"# PP vs DT: end-to-end time to equal fitness ({device_name})",
        "",
        "Both solvers start from identical factors. DT is cp.als_cp_dt;",
        "PP is the fused DT <-> PP machine, cp.als_cp_pp_fused. The",
        "target and its rule are fitness.equal_fitness_times': sustained",
        "(the worse of the two final-quartile levels, held for 3 logged",
        "rows) when both runs plateau, else monotone (first crossing of",
        "the worse final row). Times are dtime, diagnostics excluded.",
        "",
        "| config | shape | rank | target diffV | rule | DT time (s) | "
        "PP time (s) | speedup | DT full run (s) | PP full run (s) |",
        "|---|---|---|---|---|---|---|---|---|---|"]
    for name, e in sorted(summary.items()):
        lines.append(
            f"| {name} | {'x'.join(str(s) for s in e['shape'])} | "
            f"{e['rank']} | {e['target_diffV']:.4e} | {e['fitness_rule']} | "
            f"{_cell(e['dt_time_to_target'])} | "
            f"{_cell(e['pp_time_to_target'])} | "
            f"{_cell(e['speedup'], '{:.2f}x', 'n/a')} | "
            f"{e['dt_total_dtime']:.3f} | {e['pp_total_dtime']:.3f} |")
    lines += ["", "Raw data: pp_e2e.json beside this file."]
    return "\n".join(lines) + "\n"


def run(argv=None):
    args = _parse(argv)
    bench = _bench.Bench(args.device, 1)
    maxiter = args.maxiter or (40 if args.quick else 250)
    restols = [0.005, 0.01, 0.05, 0.1] if args.sweep else None
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "pp_e2e.json")
    summary = {}
    if os.path.exists(path):
        with open(path) as fh:
            summary = json.load(fh)
    this_run = {}
    for c in configs(args, maxiter):
        this_run.update(run_config(c, bench.device, restols or [c["restol"]]))
        summary.update(this_run)
        with open(path, "w") as fh:
            json.dump(summary, fh, indent=1, sort_keys=True)
        if bench.device.type == "cuda":
            torch.cuda.empty_cache()
    with open(os.path.join(args.out, "PP_WINS.md"), "w") as fh:
        fh.write(wins_md(summary, bench.device_name))
    print(f"wrote {path} and PP_WINS.md")
    print(json.dumps(this_run, sort_keys=True))
    return 0, this_run


main = _bench.main_of(run)


if __name__ == "__main__":
    raise SystemExit(main())
