"""The exact rank-R tensor (``-tensor r``) made block by block under
``-mesh``, the collectives' counters, and the benchmark's fitness
reference for that tensor, on the CPU.

- ``parallel/mesh.cp_block`` tiles ``synth.random_cp_tensor``'s V on
  meshes of 2 and 4 ranks (and 2x2) at order 6, size 7 (padded to 8 on
  the sharded mode), rank 6: each block the same slice of V, to float32
  rounding, its padding zero; ||V|| summed from the blocks to 1e-6;
- one real torchrun cluster of four gloo ranks (this file is its worker,
  with its own time limit): ``test_als`` under ``-mesh 4`` and
  ``-mesh 2x2`` and ``pp_bench`` under ``-mesh 4`` with
  ``synth.random_cp_tensor`` made to raise, so no rank makes the whole
  V; their blocks, ||V||, factors and rows against the port's own run of
  the host array; the counters of a DT sweep, a PP cache build and a PP
  sweep against the count reckoned from the code; a fit whose ranks
  exchange nothing (``no_exchange``);
- ``benchmark/references/cp_als_fitness.py``: ``judge`` and
  ``judge_block`` over 1, 2 and 4 blocks alike to 1e-12, its gradient
  numbers ``cp_als``'s, and ``fitness_gap`` over its limit where a fit's
  answer is altered or its ranks exchange nothing;
- the three readers of the collectives' and the rank's layer.
"""

from __future__ import annotations

import csv
import json
import math
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from benchmark import run as brun  # noqa: E402
from pairwise_perturbation_tpu_torch import cli  # noqa: E402
from pairwise_perturbation_tpu_torch.models import cp  # noqa: E402
from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh  # noqa
from pairwise_perturbation_tpu_torch.utils import synth, tracing  # noqa

torch.set_num_threads(1)

ORDER, SIZE, R, SEED = 6, 7, 6, 0
SHAPE = (SIZE,) * ORDER
CLUSTER_S = 150.0
F64 = 1e-10
BASE = ["-model", "CP", "-tensor", "r", "-dim", str(ORDER), "-size",
        str(SIZE), "-rank", str(R), "-seed", str(SEED), "-device", "cpu",
        "-quiet"]
ALS = ["test_als"] + BASE + ["-pp", "1", "-pp_res_tol", "0.1", "-maxiter",
                             "15", "-resprint", "1", "-dtype", "float64"]
BENCH = ["pp_bench"] + BASE + ["-maxiter", "2", "-dtype", "float32"]
# name: (argv, -mesh or None)
RUNS = {"als4": (ALS, "4"), "als2x2": (ALS, "2x2"), "bench4": (BENCH, "4")}
STRONG6 = json.loads((REPO / "benchmark" / "configs" /
                      "strong6-cp.json").read_text())
FAULT_CONF = {"shape": list(SHAPE), "tol": 0.05}


def _argv(name, out: Path, mesh):
    argv, m = RUNS[name]
    tag = name if mesh else f"{name}_one"
    argv = list(argv) + ["-filename", str(out / f"{tag}.csv")]
    if argv[0] == "test_als":
        argv += ["-checkpoint", str(out / f"ck_{tag}")]
    return argv + (["-mesh", m] if mesh else [])


def _host_v(dtype=np.float64):
    return synth.random_cp_tensor(SHAPE, R, np.random.default_rng(SEED)) \
        .astype(dtype)


class _Mesh:
    """What plan_layout and span read of a mesh: its axes and this
    rank's coordinate."""

    def __init__(self, shape, coord):
        self.shape = tuple(shape)
        self.mesh_dim_names = pmesh.default_axis_names(len(shape))
        self.coord = list(coord)

    def get_coordinate(self):
        return self.coord


def _layouts(mesh_shape):
    """The layout of SHAPE at every coordinate of a mesh."""
    import itertools
    return [pmesh.plan_layout(SHAPE, _Mesh(mesh_shape, c))
            for c in itertools.product(*(range(n) for n in mesh_shape))]


# ---- cp_block, in one process


@pytest.mark.parametrize("mesh_shape", [(2,), (4,), (2, 2)])
def test_blocks_tile_the_host_tensor(mesh_shape):
    Ws = synth.random_cp_factors(SHAPE, R, np.random.default_rng(SEED))
    V32 = torch.from_numpy(_host_v(np.float32))
    V64 = torch.from_numpy(_host_v())
    scale = float(V64.abs().max())
    norm_sq = 0.0
    for lay in _layouts(mesh_shape):
        assert lay.padded_shape[0] == 8
        for dtype, V, tol in ((torch.float32, V32, 2.0 ** -24),
                              (torch.float64, V64, 1e-15)):
            B = pmesh.cp_block(Ws, lay, dtype, "cpu")
            want = pmesh.shard_tensor(V, lay)
            assert B.dtype == dtype and B.shape == want.shape
            assert float((B - want).abs().max()) <= tol * scale
        lo, hi = lay.span(0)
        if hi > SIZE:
            assert not B[SIZE - lo:].any()      # the padded slice
        norm_sq += float(torch.sum(B * B))
    assert math.sqrt(norm_sq) == pytest.approx(
        float(np.linalg.norm(V64.numpy().ravel())), rel=1e-6)


def test_block_arithmetic_does_not_depend_on_the_chunk(monkeypatch):
    """cp_block forms its chunks of rows in float64 with the same
    operations whatever their size: one row at a time gives the same
    bits."""
    Ws = synth.random_cp_factors(SHAPE, R, np.random.default_rng(SEED))
    lay = _layouts((4,))[1]
    want = pmesh.cp_block(Ws, lay, torch.float64, "cpu")
    monkeypatch.setattr(pmesh, "CP_BLOCK_CHUNK", SIZE)
    assert torch.equal(pmesh.cp_block(Ws, lay, torch.float64, "cpu"), want)


def test_norm_sq_sums_pieces_past_the_dot_limit(monkeypatch):
    """A V of at most DOT_MAX entries is one dot, bit for bit; a larger
    one the dots of its pieces summed (a 13 x 50^5 block is 4.06e9
    entries, past cuBLAS's 32-bit count); bf16 V each piece in float32."""
    from pairwise_perturbation_tpu_torch.ops import contract
    V = torch.rand(3, 5, 7, 11, dtype=torch.float64)
    v = V.reshape(-1)
    assert torch.equal(contract.norm_sq(V), torch.dot(v, v))
    monkeypatch.setattr(contract, "DOT_MAX", 100)
    assert float(contract.norm_sq(V)) == pytest.approx(float(v @ v),
                                                       rel=1e-14)
    B = V.to(torch.bfloat16)
    b = B.float().reshape(-1)
    assert float(contract.norm_sq(B)) == pytest.approx(float(b @ b),
                                                       rel=1e-6)


# ---- the cluster


def _counts():
    s = tracing.stats()
    return [s.get(n, (0,))[0] for n in
            ("mesh.all_reduce_count", "mesh.all_reduce_bytes",
             "mesh.broadcast_count")]


def _worker(out: Path) -> None:
    """One rank of the cluster: the CLI runs on the blocks, the counters,
    and the fit that exchanges nothing; writes ``rank<r>.npz``."""
    import torch.distributed as dist
    from benchmark import engine as beng
    from pairwise_perturbation_tpu_torch.parallel import collectives

    def whole(*a, **kw):
        raise AssertionError("a rank made the whole V")
    synth.random_cp_tensor = whole
    synth.make_tensor = whole
    pmesh.distributed_init("cpu")
    rank = dist.get_rank()
    res, blocks = {}, {}
    dense = cli._dense_tensor

    def recorded(args, device):
        V, layout, vnorm, dtype = dense(args, device)
        tag = f"{args.mesh}_{args.dtype}"
        blocks[tag] = V.clone()
        res[f"spans/{tag}"] = np.array([layout.span(m)
                                        for m in range(V.ndim)])
        res[f"vnorm/{tag}"] = np.array(vnorm)
        return V, layout, vnorm, dtype
    cli._dense_tensor = recorded
    for name in RUNS:
        res[f"rc/{name}"] = np.array(cli.main(_argv(name, out, True)))
    for tag, B in blocks.items():
        res[f"block/{tag}"] = B.numpy()

    # the counters of one DT sweep, one cache build and one PP sweep
    mesh = pmesh.make_mesh((4,), device_type="cpu")
    lay = pmesh.plan_layout(SHAPE, mesh)
    Ws_host = synth.random_cp_factors(SHAPE, R, np.random.default_rng(SEED))
    V = pmesh.cp_block(Ws_host, lay, torch.float64, "cpu")
    W0 = pmesh.shard_factors(cp.init_factors(
        SHAPE, R, seed=1, dtype=torch.float64, device="cpu"), lay)
    tracing.reset()
    Ws, _ = cp.dt_sweep(V, W0, 0.0, layout=lay)
    res["count/dt"] = np.array(_counts())
    tracing.reset()
    single, pair = cp.pp_build_caches(V, Ws, lay)
    res["count/build"] = np.array(_counts())
    tracing.reset()
    cp.pp_sweep(single, pair, Ws, Ws, [torch.zeros_like(W) for W in Ws],
                0.0, 1.0, layout=lay)
    res["count/pp"] = np.array(_counts())
    tracing.reset()
    collectives.broadcast_scalar(1.0, mesh, "cpu")
    res["count/broadcast"] = np.array(_counts())

    # no_exchange: each rank keeps its partials and its own clock
    conf = dict(STRONG6, shape=list(SHAPE), tol=FAULT_CONF["tol"])
    traffic = {"flags": ["-pp", "1", "-pp_res_tol", "0.05", "-resprint",
                         "10", "-mesh", "4"]}
    engine = beng.Engine(conf, traffic, V.float(), "fp32", lay)
    collectives._reduce_buffer = lambda buf, group: None
    collectives.broadcast = lambda tensors, mesh: list(tensors)
    f = engine.fit(2)
    for m, W in enumerate(f.factors):
        res[f"noex/W{m}"] = W.numpy()
    res["noex/meta"] = np.array([f.metric, f.diffV, f.iters, f.converged])
    np.savez(out / f"rank{rank}.npz", **res)
    dist.barrier()
    pmesh.distributed_close()


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    """The four ranks' results, and the port's own runs of the host
    array (no -mesh), from the same flags."""
    from pairwise_perturbation_tpu_torch.scripts.multiprocess_worker import \
        run_cluster
    out = tmp_path_factory.mktemp("rcp")
    rc, log = run_cluster(4, [str(Path(__file__).resolve()), str(out)],
                          timeout=CLUSTER_S)
    assert rc == 0, log[-4000:]
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]
    rcs = {name: cli.main(_argv(name, out, False)) for name in RUNS}
    return out, ranks, rcs


def _csv(path):
    with open(path) as fh:
        return list(csv.reader(fh))


def test_cluster_blocks_are_the_host_tensors_slices(cluster):
    """Every rank's block of both runs is its slice of the host array,
    to float32 rounding; ||V|| summed from the blocks equals the host
    array's norm to 1e-6; no rank made the whole V (random_cp_tensor
    raised on every rank)."""
    _, ranks, _ = cluster
    for tag, dtype, tol in (("4_float64", np.float64, 1e-15),
                            ("2x2_float64", np.float64, 1e-15),
                            ("4_float32", np.float32, 2.0 ** -24)):
        V = _host_v(dtype)
        scale = float(np.abs(V).max())
        padded = np.zeros((8,) + SHAPE[1:] if tag.startswith("4")
                          else (8, 8) + SHAPE[2:], dtype)
        padded[tuple(slice(0, s) for s in SHAPE)] = V
        for r in ranks:
            block = r[f"block/{tag}"]
            want = padded[tuple(slice(a, b) for a, b in r[f"spans/{tag}"])]
            assert block.shape == want.shape
            assert float(np.abs(block - want).max()) <= tol * scale, tag
            assert float(r[f"vnorm/{tag}"]) == pytest.approx(
                float(np.linalg.norm(V.ravel())), rel=1e-6)


@pytest.mark.parametrize("name", ["als4", "als2x2"])
def test_cluster_fits_are_the_host_arrays(cluster, name):
    """test_als -mesh 4 and 2x2 on the blocks: every rank exited 0, and
    rank 0 wrote the host-array run's rows and factors, [gradnorm] and
    [diffV] to 1e-10 relative, the rest equal but [tol] (||V|| summed in
    another order) and [dtime]."""
    out, ranks, rcs = cluster
    assert rcs[name] == 0
    assert all(int(r[f"rc/{name}"]) == 0 for r in ranks)
    got, want = _csv(out / f"{name}.csv"), _csv(out / f"{name}_one.csv")
    assert got[0] == want[0] and len(got) == len(want) > 3
    for g, w in zip(got[1:], want[1:]):
        for col, a, b in zip(want[0], g, w):
            if col in ("[gradnorm]", "[diffV]", "[tol]"):
                assert abs(float(a) - float(b)) <= F64 * abs(float(b)), col
            elif col != "[dtime]":
                assert a == b, (col, g, w)
    from pairwise_perturbation_tpu_torch.utils import io as tio
    a = tio.load_checkpoint(str(out / f"ck_{name}.npz"))
    b = tio.load_checkpoint(str(out / f"ck_{name}_one.npz"))
    assert a["iteration"] == b["iteration"]
    for x, y in zip(a["factors"], b["factors"]):
        assert x.shape == y.shape == (SIZE, R)
        assert float(np.abs(x - y).max()) <= F64 * float(np.abs(y).max())


def test_cluster_pp_bench_rows_are_the_host_arrays(cluster):
    out, ranks, rcs = cluster
    assert rcs["bench4"] == 0 and all(int(r["rc/bench4"]) == 0
                                      for r in ranks)
    got, want = _csv(out / "bench4.csv"), _csv(out / "bench4_one.csv")
    assert [r[0] for r in got] == [r[0] for r in want] == \
        ["[timetype]"] + ["[DTtime]"] * 2 + ["[PPfirst]", "[PPsecond]"] * 2


def _reckoned(s, b):
    """(all_reduces, bytes) of a DT or PP sweep on a 1D mesh that splits
    mode 0, reckoned from models/cp.py: for each mode i > 0 one leaf or
    correction term (s_i x R) and one Gram (R x R) summed over the axis;
    mode 0's own leaf and Grams need none; then one squared norm in
    normalize_factors."""
    n = len(s)
    return 2 * (n - 1) + 1, b * (R * sum(s[1:]) + (n - 1) * R * R + 1)


def test_counters_are_the_codes(cluster):
    """Per DT sweep and per PP sweep, on every rank: 2N - 1 all-reduces
    and their bytes as reckoned from the code; a PP cache build one
    all-reduce for every cache that contracted mode 0 (the pairs without
    mode 0 and the singles of the other modes, in one buffer); no
    broadcast in a sweep; broadcast_scalar one."""
    _, ranks, _ = cluster
    b = 8
    sweep = _reckoned(SHAPE, b)
    pairs = sum(R * SHAPE[i] * SHAPE[j] for i in range(1, ORDER)
                for j in range(i + 1, ORDER))
    build = (1, b * (pairs + R * sum(SHAPE[1:])))
    for r in ranks:
        assert tuple(r["count/dt"]) == sweep + (0,)
        assert tuple(r["count/pp"]) == sweep + (0,)
        assert tuple(r["count/build"]) == build + (0,)
        assert tuple(r["count/broadcast"]) == (0, 0, 1)


def test_unsharded_fit_counts_no_collective():
    """Without a layout the hooks are the identity: a whole fit counts no
    all-reduce and no broadcast."""
    V = torch.from_numpy(synth.random_cp_tensor(
        (5, 6, 7), 3, np.random.default_rng(1)))
    Ws = cp.init_factors(V.shape, 3, seed=1, dtype=V.dtype, device="cpu")
    tracing.reset()
    res = cp.als_cp_pp(V, Ws, cp.CPConfig(tol=1e-6, pp_res_tol=0.1,
                                          maxiter=20, resprint=1))
    assert res.iters > 0
    assert _counts() == [0, 0, 0]


# ---- the fitness reference


def _fit(factors, metric, diffV, converged=True):
    return SimpleNamespace(factors=[torch.as_tensor(W) for W in factors],
                           metric=float(metric), diffV=float(diffV),
                           converged=bool(converged), iters=1)


def _ref(name):
    return brun.load(REPO, "references", name)


@pytest.fixture(scope="module")
def sound():
    """Two fits of the host tensor in float64 from seeds 1 and 2, as the
    engine returns them."""
    V = torch.from_numpy(_host_v())
    fits = []
    for seed in (1, 2):
        Ws = cp.init_factors(SHAPE, R, seed=seed, dtype=torch.float64,
                             device="cpu")
        vn = float(torch.linalg.vector_norm(V))
        res = cp.als_cp_pp(V, Ws, cp.CPConfig(
            tol=FAULT_CONF["tol"] * vn, pp_res_tol=0.05, maxiter=250,
            resprint=10))
        assert res.converged
        fits.append(_fit(res.factors, res.gradnorm, res.diffV))
    return V, fits


@pytest.mark.parametrize("mesh_shape", [(1,), (2,), (4,)])
def test_judge_block_is_judge(sound, mesh_shape):
    """Over 1, 2 and 4 zero-padded blocks (the partials summed as the
    ranks sum them) the reference's readings, each fit's gradnorm and
    diffV and ||V||, are judge's on the whole V to 1e-12 relative, and so
    its numbers (gaps of those readings, in units of tol ||V|| or ||V||)
    to 1e-12."""
    V, fits = sound
    fit = _ref("cp_als_fitness")
    conf = FAULT_CONF
    want = fit.judge(V, fits, conf)
    padded = torch.zeros((8,) + SHAPE[1:], dtype=V.dtype)
    padded[:SIZE] = V
    lays = _layouts(mesh_shape) if mesh_shape != (1,) else \
        [pmesh.plan_layout(SHAPE, _Mesh((1,), [0]))]
    parts = []
    for lay in lays:
        spans = [lay.span(m) for m in range(ORDER)]
        src = padded if lay.padded_shape[0] == 8 else V
        parts.append((src[tuple(slice(a, b) for a, b in spans)], spans))
    sums = [fit.block_sums(b, s, SHAPE, fits) for b, s in parts]
    others = sum(sums[1:], torch.zeros_like(sums[0]))
    got = fit.judge_block(parts[0][0], parts[0][1], fits, conf,
                          lambda v: v + others)
    assert set(got) == set(want) == {"gradnorm_gap", "fitness_gap",
                                     "gradnorm_ref"}
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-12), k
    (rw, vw) = fit.fit_readings(V, fits)
    (rg, vg) = fit.readings_of_sums(sums[0] + others, fits)
    assert vg == pytest.approx(vw, rel=1e-12)
    for (g1, d1), (g2, d2) in zip(rg, rw):
        assert g1 == pytest.approx(g2, rel=1e-12)
        assert d1 == pytest.approx(d2, rel=1e-12)


def test_gradient_numbers_are_cp_als(sound):
    V, fits = sound
    a = _ref("cp_als").judge(V, fits, FAULT_CONF)
    b = _ref("cp_als_fitness").judge(V, fits, FAULT_CONF)
    assert a["gradnorm_gap"] == b["gradnorm_gap"]
    assert a["gradnorm_ref"] == b["gradnorm_ref"]
    assert b["fitness_gap"] == pytest.approx(max(
        abs(f.diffV - d) / vn for f, d, vn in _diffs(V, fits)), rel=1e-9)


def _diffs(V, fits):
    vn = float(torch.linalg.vector_norm(V))
    for f in fits:
        W = [w.double() for w in f.factors]
        rec = torch.einsum("az,bz,cz,dz,ez,fz->abcdef", *W)
        yield f, float(torch.linalg.vector_norm(V - rec)), vn


def test_fitness_gap_fails_where_the_answer_is_wrong(sound, cluster):
    """Sound fits read under the configuration's fitness_gap limit; a
    fit's answer altered (one factor entry moved by 5% of its factor's
    norm) and the ranks' fit that exchanged nothing (rank 0's answer)
    read over it."""
    V, fits = sound
    fit = _ref("cp_als_fitness")
    limit = STRONG6["limits"]["fitness_gap"]
    assert fit.judge(V, fits, FAULT_CONF)["fitness_gap"] < limit
    altered = []
    for f in fits:
        W = [w.clone() for w in f.factors]
        W[1][0, 0] += 0.05 * torch.linalg.vector_norm(W[1])
        altered.append(_fit(W, f.metric, f.diffV))
    assert fit.judge(V, altered, FAULT_CONF)["fitness_gap"] > limit
    r0 = cluster[1][0]
    metric, diffV, _, _ = r0["noex/meta"]
    noex = _fit([r0[f"noex/W{m}"] for m in range(ORDER)], metric, diffV)
    assert fit.judge(V, [noex], FAULT_CONF)["fitness_gap"] > limit


# ---- the readers


def _reader(name):
    return brun.load(REPO, "metrics", name)


def test_collective_readers_known_values():
    r = brun.Reading(
        stats={"cp.dt_sweep": (30, 1.0, 0.0), "cp.pp_sweep": (70, 1.0, 0.0),
               "mesh.all_reduce_bytes": (100 * 2 ** 20, 0.0, float("nan"))},
        ranges={"cp.fit": (4, 2.0), "mesh.all_reduce": (900, 0.5)})
    assert _reader("allreduce_mib_per_sweep").read(r) == pytest.approx(1.0)
    assert _reader("allreduce_share_pct").read(r) == pytest.approx(25.0)
    none = brun.Reading(stats={"cp.dt_sweep": (30, 1.0, 0.0)},
                        ranges={"cp.fit": (4, 2.0)})
    assert _reader("allreduce_mib_per_sweep").read(none) is None
    assert _reader("allreduce_share_pct").read(none) is None


def test_rank_sweep_roofline_counts_the_block():
    """One read of the rank's block and its factors at 3.35 TB/s bounds
    a 13 x 50^5 float32 block (its tree's operations take less at 67
    TFLOP/s); two sweeps of twice that least time read 50%."""
    from benchmark import peaks
    block = (13, 50, 50, 50, 50, 50)
    r = brun.Reading(model="CP", block_shape=block, rank=6, split=None,
                     itemsize=4, peaks=peaks,
                     ranges={"cp.dt_sweep": (2, 0.0)})
    m = _reader("rank_sweep_roofline_pct")
    assert m.read(r) is None
    flops, nbytes = m.counts(r)
    assert nbytes == 4 * (math.prod(block) + 2 * 6 * (13 + 5 * 50))
    assert flops / peaks.F32_FLOPS_PER_S < nbytes / peaks.HBM_BYTES_PER_S
    least = nbytes / peaks.HBM_BYTES_PER_S
    r.ranges = {"cp.dt_sweep": (2, 4 * least)}
    assert m.read(r) == pytest.approx(50.0)
    assert r.notes["rank_sweep_roofline_pct"] == "memory"


if __name__ == "__main__":
    _worker(Path(sys.argv[1]))
