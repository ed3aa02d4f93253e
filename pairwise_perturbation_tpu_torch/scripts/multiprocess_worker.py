"""Multi-process worker of the parallel layer (parallel/mesh.py) — the
port's counterpart of the root ``scripts/multiprocess_worker.py``. One
process per mesh device, started by torchrun and joined by
``init_process_group`` (the MPI_Init / MPI_Comm_rank substrate of the
reference, test_ALS.cxx:58-62):

    torchrun --standalone --nproc_per_node 2 \\
        -m pairwise_perturbation_tpu_torch.scripts.multiprocess_worker \\
        --inputs in.npz --outdir out --tasks functions,cp --device cpu

Every rank reads its inputs from the ``.npz`` the caller wrote, runs the
tasks and writes ``<outdir>/result_<rank>.npz``: its rank, world size,
backend, device, its kernels' launch counts, and per task:

- ``functions`` (COO ``indices``/``values``, CP factors ``cp_W<i>``,
  orthonormal Tucker factors ``tk_W<i>``): shard_coo, then the five
  sharded sparse functions (MTTKRP of every mode, PP caches, TTMc of
  every skip mode and -1, TTMc caches, gradnorm) and ||V||^2, in each of
  ``--dtypes``;
- ``cp`` (the same COO, ``cp_cfg`` as JSON): ``sparse_cp.als_cp_pp_sparse``
  from ``cp_W<i>`` with ``mesh=``;
- ``tucker`` (the COO ``tk_indices``/``tk_values``/``tk_shape`` if given,
  else the same one; ``tk_ranks``, ``tk_cfg``):
  ``sparse_tucker.als_tucker_pp_sparse`` with ``mesh=``, from the sketch
  HOSVD of the unsharded COO (``init_st``; its rows ``tk_O<i>`` if
  given);
  each of the two with its history, factors, scope statistics
  (``tracing`` on: sweep, cache build and ``mesh.all_reduce`` seconds),
  K7 launches and wall seconds;
- ``als`` (``als_indices``/``als_values``/``als_shape``, ``als_cfg``):
  plain sparse ALS with ``mesh=`` from seeded factors (float32), with
  its statistics, wall seconds and peak device memory;
- ``dense`` (``V``, factors ``d_W<i>``, ``mesh_shape``; optionally a file
  ``vfile`` with ``file_shape`` and ``axes_perm``): plan_layout,
  shard_tensor, shard_factors, sharded_mttkrp of every mode (its kernel
  launches counted apart), constrained_pp_caches, unshard_factors and
  read_dense_sharded, as this rank's blocks;
- ``dfunctions`` (dense V ``dd_V``, CP factors ``dd_W<i>``, the mesh
  shape ``dd_mesh``, which ``dcp`` and ``dtucker`` take too, and Tucker
  ranks ``dd_ranks``): the dense engines' sweep functions with
  ``layout=`` on this rank's blocks, each gathered whole (padded, so
  every rank holds the same array): ``cp.dt_sweep``,
  ``cp.pp_build_caches``, two ``cp.pp_sweep``s, and in float64
  ``tucker.hosvd``, ``tucker.tucker_dt_sweep``,
  ``tucker.tucker_build_caches`` and ``tucker.tucker_pp_sweep``; each
  beside one process's function on the zero-padded whole V (``err/``);
- ``dcp`` (``dc_V``, or an ``.npy`` file ``dc_vfile`` of which each rank
  reads only its block; factors ``dc_W<i>``, ``dc_cfg``,
  ``dc_pp``: the -pp values to run, ``dc_config``: config overrides;
  ``dc_loops``: the -device_loop values of -pp 1 to run as well):
  ``cp.als_cp_pp`` (-pp 1, or -pp 2 with ``partial_update``) with
  ``mesh_layout``, its history, its factors unsharded, scope statistics,
  wall seconds, kernel launches and those of its warm-ups
  (``dcp<pp>_*/<dtype>``); then ``cp.als_cp_pp_device`` (1) and
  ``cp.als_cp_pp_fused`` (2), the same records (``dcl<loop>_*/<dtype>``);
- ``dtucker`` (``dt_V`` or ``dt_vfile``, ``dt_ranks``, ``dt_tk_cfg``;
  ``dt_Q<i>`` starts it from ``tucker.hosvd`` with those draws;
  ``dt_hosvd_max`` sets tucker.HOSVD_EXACT_EIGH_MAX for this task
  alone; ``dt_loops`` as ``dc_loops``, ``dt_host`` 0 to skip the host
  engine): ``tucker.als_tucker_pp`` with ``mesh_layout``, the same
  records and its core (``dtk_*/<dtype>``); then
  ``tucker.als_tucker_pp_device`` and ``als_tucker_pp_fused``
  (``dtl<loop>_*/<dtype>``);
- ``drun`` (``dr_V`` or ``dr_vfile``, factors ``dr_W<i>``, ``dr_runs``: a
  JSON list of runs, each ``tag``, ``pp`` (run's -pp), ``steps`` (or
  ``maxiter`` and ``resprint``: the whole ``cli.run_cpd``, whose history
  is kept as ``run_hist/<dtype>/<tag>``), and optionally ``opts``
  (cli.run_optimizer's options), ``lam``, ``macro`` (step_cycle),
  ``each`` (record every step's factors) and ``config`` (config
  overrides); ``dr_lefts``: the hold-outs of one
  ``optimizers.msdt_cycle``; ``dr_svd``: a JSON list of low-rank kit
  checks, each ``name``, ``A`` (the key of a whole matrix, cut into this
  rank's rows of mode ``mode``), ``r`` and ``X`` (the key of the
  randomized SVD's test matrix, or null for the exact truncation)): the
  run optimizers on this rank's block with ``configure(..., layout)``,
  their factors gathered whole (padded) at the end (``run/<dtype>/<tag>
  /W/<m>``) and with ``each`` after every step (``.../<step>/<m>``),
  scope statistics, wall seconds, kernel launches and peak device memory;
  the cycle's factors
  (``cycle/<dtype>/<m>``); each check's (U s) VT gathered whole
  (``svd/<dtype>/<name>``);
- ``cli`` (``cli_argv``, a JSON list of argument lists, and optionally
  ``cli_config``, a JSON list of config overrides, one a run, and
  ``io_shapes``, utils/io.py's dataset file shapes to use): ``cli.main``
  of each inside this world, as ``torchrun -m
  pairwise_perturbation_tpu_torch.cli`` would run it; their exit codes
  and each run's kernel launches.

Every result is written with its SHA-256 (``sha/<key>``, for bitwise
comparisons across ranks and runs) and its relative max-norm distance
from the same function computed without a mesh on this rank's full copy
of the input (``err/<key>``); with ``--arrays`` also the array itself
(``<key>``; always for the engines' histories, factors and cores).
:func:`run_cluster` launches the worker (or the CLI) under
torchrun with a time limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TORCHRUN = [sys.executable, "-m", "torch.distributed.run", "--standalone"]


def run_cluster(nproc: int, argv, timeout: float = 120.0):
    """Run ``torchrun --standalone --nproc_per_node nproc *argv`` from the
    repository's root with one thread per rank; return (exit code, its
    output). On the time limit torchrun is sent SIGTERM, which ends its
    ranks, then its process group is killed, and TimeoutError raises."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen(
        TORCHRUN + [f"--nproc_per_node={nproc}", *map(str, argv)], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.terminate()
        try:
            out, _ = proc.communicate(timeout=20)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            out, _ = proc.communicate()
        raise TimeoutError(f"torchrun {list(argv)[:3]}... ({nproc} ranks) "
                           f"passed its {timeout} s limit:\n{out[-4000:]}")
    return proc.returncode, out


WORKER = ["-m", "pairwise_perturbation_tpu_torch.scripts.multiprocess_worker"]


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


class _Results:
    """What a rank writes: arrays (with ``--arrays``), their digests and
    their distances from the unsharded references."""

    def __init__(self, arrays: bool):
        self.arrays = arrays
        self.out = {}

    def put(self, key, x, ref=None, keep=False):
        """Record ``x`` under ``key`` (the array itself with ``--arrays``
        or ``keep``), with its distance from ``ref`` if given."""
        a = x.detach().cpu().numpy() if hasattr(x, "detach") else \
            np.asarray(x)
        self.out[f"sha/{key}"] = np.frombuffer(
            hashlib.sha256(np.ascontiguousarray(a).tobytes()).digest(),
            np.uint8)
        if ref is not None:
            r = ref.detach().cpu().numpy() if hasattr(ref, "detach") else \
                np.asarray(ref)
            scale = float(np.max(np.abs(r))) if r.size else 0.0
            self.out[f"err/{key}"] = np.asarray(
                float(np.max(np.abs(a - r))) / scale if scale else 0.0)
        if self.arrays or keep:
            self.out[key] = a

    def meta(self, key, value):
        self.out[key] = np.asarray(value)


def _coo(data, prefix, dtype, device):
    import torch
    from pairwise_perturbation_tpu_torch.ops import sparse as sp
    shape = tuple(int(s) for s in data[f"{prefix}shape"])
    return sp.SparseTensor(
        torch.from_numpy(data[f"{prefix}indices"]).to(device),
        torch.from_numpy(data[f"{prefix}values"]).to(dtype).to(device),
        shape)


def _factors(data, prefix, dtype, device):
    import torch
    out, i = [], 0
    while f"{prefix}{i}" in data:
        out.append(torch.from_numpy(data[f"{prefix}{i}"]).to(dtype)
                   .to(device))
        i += 1
    return out


def _stats():
    from pairwise_perturbation_tpu_torch.utils import tracing
    return json.dumps({k: list(v) for k, v in tracing.stats().items()})


def task_functions(data, res, mesh, dtypes, device):
    from pairwise_perturbation_tpu_torch.ops import sparse as sp
    from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
    for dtype in dtypes:
        d = _dtype_name(dtype)
        st = _coo(data, "", dtype, device)
        sts = pmesh.shard_coo(st, mesh)
        Ws = _factors(data, "cp_W", dtype, device)
        Ts = _factors(data, "tk_W", dtype, device)
        res.put(f"norm_sq/{d}", pmesh.sharded_sparse_norm_sq(sts, mesh),
                sp.norm_sq(st))
        for m in range(st.ndim):
            res.put(f"mttkrp/{d}/{m}",
                    pmesh.sharded_sparse_mttkrp(sts, Ws, m, mesh),
                    sp.mttkrp(st, Ws, m))
        caches = [("", pmesh.sharded_sparse_pp_caches(sts, Ws, mesh),
                   sp.build_pp_caches(st, Ws))]
        if Ts:
            for skip in list(range(st.ndim)) + [-1]:
                res.put(f"ttmc/{d}/{skip}",
                        pmesh.sharded_sparse_ttmc(sts, Ts, skip, mesh),
                        sp.ttmc(st, Ts, skip_mode=skip))
            caches.append(("t", pmesh.sharded_sparse_ttmc_caches(sts, Ts,
                                                                 mesh),
                           sp.build_ttmc_caches(st, Ts)))
        for tag, (single, pair), (s_ref, p_ref) in caches:
            for i in single:
                res.put(f"{tag}single/{d}/{i}", single[i], s_ref[i])
            for (i, j) in pair:
                res.put(f"{tag}pair/{d}/{i}_{j}", pair[(i, j)],
                        p_ref[(i, j)])
        res.put(f"gradnorm/{d}", pmesh.sharded_sparse_gradnorm(sts, Ws, mesh),
                sp.cp_gradnorm(st, Ws))


def _listed(data, key):
    """The array ``data[key]``, or nothing where the inputs lack it."""
    return data[key] if key in data else ()


def _history(hist, keys):
    return np.asarray([[h[k] for k in keys] for h in hist], np.float64)


def _timed_run(fn, device):
    """(result, wall seconds, scope statistics, K7 launches) of ``fn()``
    with the tracing scopes on."""
    import torch
    from pairwise_perturbation_tpu_torch.ops.kernels import coo_mttkrp
    from pairwise_perturbation_tpu_torch.utils import tracing
    tracing.reset()
    coo_mttkrp.reset_launch_counts()
    tracing.enable()
    t0 = time.perf_counter()
    try:
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        tracing.enable(False)
    return (out, time.perf_counter() - t0, _stats(),
            coo_mttkrp.LAUNCHES["coo_mttkrp"])


def _engine_run(res, tag, d, run, keys, device):
    r, wall, stats, k7 = _timed_run(run, device)
    res.put(f"{tag}_hist/{d}", _history(r.history, ("iter",) + keys),
            keep=True)
    for i, W in enumerate(r.factors):
        res.put(f"{tag}_W/{d}/{i}", W, keep=True)
    res.meta(f"{tag}_stats/{d}", stats)
    res.meta(f"{tag}_wall/{d}", wall)
    res.meta(f"{tag}_k7/{d}", k7)
    return r


def task_cp(data, res, mesh, dtypes, device):
    from pairwise_perturbation_tpu_torch.models import cp, sparse_cp
    from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
    cfg = cp.CPConfig(**json.loads(str(data["cp_cfg"])))
    for dtype in dtypes:
        sts = pmesh.shard_coo(_coo(data, "", dtype, device), mesh)
        W0 = _factors(data, "cp_W", dtype, device)
        _engine_run(res, "cp", _dtype_name(dtype),
                    lambda: sparse_cp.als_cp_pp_sparse(sts, W0, cfg,
                                                       mesh=mesh),
                    ("gradnorm", "diffV", "pp"), device)


def task_tucker(data, res, mesh, dtypes, device):
    from pairwise_perturbation_tpu_torch.models import sparse_tucker, tucker
    from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
    cfg = tucker.TuckerConfig(**json.loads(str(data["tk_cfg"])))
    ranks = tuple(int(x) for x in data["tk_ranks"])
    prefix = "tk_" if "tk_indices" in data else ""
    for dtype in dtypes:
        st = _coo(data, prefix, dtype, device)
        sts = pmesh.shard_coo(st, mesh)
        omegas = _factors(data, "tk_O", dtype, device) or None
        r = _engine_run(res, "tk", _dtype_name(dtype),
                        lambda: sparse_tucker.als_tucker_pp_sparse(
                            sts, ranks, cfg, mesh=mesh, omegas=omegas,
                            init_st=st),
                        ("diffnorm", "diffV", "pp"), device)
        res.put(f"tk_core/{_dtype_name(dtype)}", r.core, keep=True)


def task_als(data, res, mesh, device):
    import torch
    from pairwise_perturbation_tpu_torch.models import cp, sparse_cp
    from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
    cfg = json.loads(str(data["als_cfg"]))
    st = _coo(data, "als_", torch.float32, device)
    sts = pmesh.shard_coo(st, mesh)
    del st
    Ws = cp.init_factors(sts.shape, int(data["als_rank"]), seed=0,
                         dtype=torch.float32, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    r, wall, stats, k7 = _timed_run(lambda: sparse_cp.als_cp_sparse(
        sts, Ws, cp.CPConfig(**cfg), mesh=mesh), device)
    res.put("als_hist", _history(r.history,
                                 ("iter", "gradnorm", "diffV", "pp")),
            keep=True)
    res.meta("als_stats", stats)
    res.meta("als_wall", wall)
    res.meta("als_k7", k7)
    res.meta("als_nnz", sts.nnz)
    res.meta("als_peak_bytes", torch.cuda.max_memory_allocated(device)
             if device.type == "cuda" else 0)


def task_dense(data, res, device):
    import torch
    from pairwise_perturbation_tpu_torch.ops import contract
    from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
    from pairwise_perturbation_tpu_torch.scripts import _bench
    from pairwise_perturbation_tpu_torch.utils import io
    mesh = pmesh.make_mesh(tuple(int(s) for s in data["mesh_shape"]),
                           device_type=device.type)
    res.meta("coordinate", mesh.get_coordinate())
    V = torch.from_numpy(data["V"]).to(device)
    Ws = _factors(data, "d_W", V.dtype, device)
    layout = pmesh.plan_layout(V.shape, mesh)
    Vb = pmesh.shard_tensor(V, layout)
    Wb = pmesh.shard_factors(Ws, layout)
    spans = [layout.span(m) for m in range(V.ndim)]
    res.meta("spans", np.asarray(spans))
    res.put("V_block", Vb)

    def block(x, modes):
        """The reference's rows at this rank's spans of ``modes``."""
        return pmesh._padded_block(x, [spans[m] if m is not None
                                       else (0, x.shape[k])
                                       for k, m in enumerate(modes)])

    before = _bench.launch_counts()
    Ms = [pmesh.sharded_mttkrp(Vb, Wb, m, layout) for m in range(V.ndim)]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    res.meta("block_launches", json.dumps(
        {k: n - before[k] for k, n in _bench.launch_counts().items()}))
    for m in range(V.ndim):
        res.put(f"W_block/{m}", Wb[m])
        res.put(f"smttkrp/{m}", Ms[m],
                block(contract.mttkrp(V, Ws, m), (m, None)))
    single, pair = pmesh.constrained_pp_caches(Vb, Wb, layout)
    s_ref, p_ref = contract.build_pp_caches(V, Ws)
    for i in single:
        res.put(f"csingle/{i}", single[i], block(s_ref[i], (i, None)))
    for (i, j) in pair:
        res.put(f"cpair/{i}_{j}", pair[(i, j)],
                block(p_ref[(i, j)], (None, i, j)))
    for m, W in enumerate(pmesh.unshard_factors(Wb, layout)):
        res.put(f"unshard/{m}", W, Ws[m])
    if "vfile" in data:
        lay = pmesh.plan_layout(tuple(int(s) for s in data["final_shape"]),
                                mesh)
        got = io.read_dense_sharded(
            str(data["vfile"]), lay, out_dtype=np.float64,
            file_shape=tuple(int(s) for s in data["file_shape"]),
            axes_perm=tuple(int(s) for s in data["axes_perm"]),
            device=device)
        res.meta("read_spans", np.asarray(
            [lay.span(m) for m in range(len(lay.orig_shape))]))
        res.put("read_block", got)


def _dense_host(data, p):
    """The dense V of the inputs with prefix ``p`` as a host array: the
    ``.npy`` file ``<p>vfile`` memory-mapped (a rank's block alone is
    read from disk), or the inline array ``<p>V``."""
    if f"{p}vfile" in data:
        return np.load(str(data[f"{p}vfile"]), mmap_mode="r")
    return data[f"{p}V"]


def _dense_inputs(data, p, mesh, dtype, device, padded_refs):
    """(layout, V block, CP factor blocks ``<p>W<i>``) of this rank, and
    with ``padded_refs`` the zero-padded whole V and factors (one
    process's inputs; else None, None)."""
    import torch
    from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
    Vh = _dense_host(data, p)
    layout = pmesh.plan_layout(Vh.shape, mesh)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    Vb = pmesh._padded_block(Vh, [layout.span(m) for m in range(Vh.ndim)],
                             device, np_dt).to(dtype)
    W0 = _factors(data, f"{p}W", dtype, device)
    Wb = pmesh.shard_factors(W0, layout, device)
    if not padded_refs:
        return layout, Vb, Wb, None, None
    full = [(0, p) for p in layout.padded_shape]
    Vp = pmesh._padded_block(Vh, full, device, np_dt).to(dtype)
    Wp = [pmesh._padded_block(W, [full[m], (0, W.shape[1])], device)
          for m, W in enumerate(W0)]
    return layout, Vb, Wb, Vp, Wp


def _whole(x, dims, layout):
    """``x`` gathered along each (dim, mode) of ``dims`` whose mode is
    sharded: the padded global array, the same on every rank."""
    from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
    for dim, mode in dims:
        x = pmesh.gather_rows(x, mode, layout, dim=dim)
    return x


def task_dfunctions(data, res, mesh, dtypes, device):
    import torch
    from pairwise_perturbation_tpu_torch.models import cp, tucker
    for dtype in dtypes:
        d = _dtype_name(dtype)
        layout, Vb, Wb, Vp, Wp = _dense_inputs(data, "dd_", mesh, dtype,
                                               device, True)
        order = Vb.ndim

        def put(key, x, ref, dims):
            res.put(f"{d}/{key}", _whole(x, dims, layout), ref)

        def run(fn, args, **kw):
            """(``fn(*args[0])`` with the layout, one process's
            ``fn(*args[1])``)."""
            return fn(*args[0], layout=layout, **kw), fn(*args[1], **kw)

        (Ws, grads), ref = run(cp.dt_sweep, ((Vb, Wb, 0.0), (Vp, Wp, 0.0)))
        for m in range(order):
            put(f"dt/W{m}", Ws[m], ref[0][m], [(0, m)])
            put(f"dt/g{m}", grads[m], ref[1][m], [(0, m)])
        caches, ref = run(cp.pp_build_caches, ((Vb, Wb), (Vp, Wp)))
        _put_caches(put, "", caches, ref, rank_major=True)
        zeros = [torch.zeros_like(W) for W in Wb]
        zp = [torch.zeros_like(W) for W in Wp]
        (W1, dW1, _), r1 = run(cp.pp_sweep, (
            (*caches, Wb, Wb, zeros, 0.0, 1.0),
            (*ref, Wp, Wp, zp, 0.0, 1.0)))
        (W2, _, _), r2 = run(cp.pp_sweep, (
            (*caches, W1, Wb, dW1, 0.0, 1.0),
            (*ref, r1[0], Wp, r1[1], 0.0, 1.0)))
        for m in range(order):
            put(f"pp1/W{m}", W1[m], r1[0][m], [(0, m)])
            put(f"pp2/W{m}", W2[m], r2[0][m], [(0, m)])
        if dtype != torch.float64 or "dd_ranks" not in data:
            continue
        ranks = tuple(int(r) for r in data["dd_ranks"])
        (core, Th), (c_ref, Tp) = run(tucker.hosvd, ((Vb, ranks),
                                                     (Vp, ranks)))
        for m in range(order):
            put(f"hosvd/W{m}", Th[m], Tp[m], [(0, m)])
        put("hosvd/core", core, c_ref, [])
        (Td, cd), (Tdp, cd_ref) = run(tucker.tucker_dt_sweep,
                                      ((Vb, Th, Th), (Vp, Tp, Tp)),
                                      ranks=ranks, use_sign=True)
        for m in range(order):
            put(f"tdt/W{m}", Td[m], Tdp[m], [(0, m)])
        put("tdt/core", cd, cd_ref, [])
        tcaches, tref = run(tucker.tucker_build_caches, ((Vb, Th), (Vp, Tp)))
        _put_caches(put, "t", tcaches, tref, rank_major=False)
        dT = [a - b for a, b in zip(Td, Th)]
        dTp = [a - b for a, b in zip(Tdp, Tp)]
        (Tq, _, cq, _), ref = run(tucker.tucker_pp_sweep, (
            (*tcaches, Td, Th, dT), (*tref, Tdp, Tp, dTp)), ranks=ranks)
        for m in range(order):
            put(f"tpp/W{m}", Tq[m], ref[0][m], [(0, m)])
        put("tpp/core", cq, ref[2], [])


def _put_caches(put, tag, caches, ref, rank_major):
    """Single caches keep their mode on axis (rank-major CP pairs: axes
    1, 2; Tucker caches: the modes' own axes)."""
    single, pair = caches
    for i, x in single.items():
        put(f"{tag}single/{i}", x, ref[0][i], [(0 if rank_major else i, i)])
    for (i, j), x in pair.items():
        dims = [(1, i), (2, j)] if rank_major else [(i, i), (j, j)]
        put(f"{tag}pair/{i}_{j}", x, ref[1][(i, j)], dims)


def _run_counted(fn, device, warm=None):
    """(result, wall seconds, scope statistics, {kernel: launches}) of
    ``fn()`` with the tracing scopes on; with a dict ``warm``, the
    launches its warm-ups made are also added to it (_bench.warm_launches)."""
    import torch
    from pairwise_perturbation_tpu_torch.scripts import _bench
    from pairwise_perturbation_tpu_torch.utils import tracing
    tracing.reset()
    before = _bench.launch_counts()
    tracing.enable()
    t0 = time.perf_counter()
    try:
        with _bench.warm_launches() as w:
            out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        tracing.enable(False)
    after = _bench.launch_counts()
    if warm is not None:
        warm.update(w)
    return (out, time.perf_counter() - t0, _stats(),
            {k: n - before.get(k, 0) for k, n in after.items()})


def _dense_engine(res, tag, d, run, keys, layout, device):
    from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
    warm = {}
    r, wall, stats, launches = _run_counted(run, device, warm)
    res.meta(f"{tag}_warm/{d}", json.dumps(warm))
    res.put(f"{tag}_hist/{d}", _history(r.history, ("iter",) + keys),
            keep=True)
    for i, W in enumerate(pmesh.unshard_factors(r.factors, layout)):
        res.put(f"{tag}_W/{d}/{i}", W, keep=True)
    res.meta(f"{tag}_stats/{d}", stats)
    res.meta(f"{tag}_wall/{d}", wall)
    res.meta(f"{tag}_launches/{d}", json.dumps(launches))
    return r


def task_dcp(data, res, mesh, dtypes, device):
    from pairwise_perturbation_tpu_torch import config
    from pairwise_perturbation_tpu_torch.models import cp
    over = json.loads(str(data["dc_config"])) if "dc_config" in data else {}
    for dtype in dtypes:
        layout, Vb, Wb, _, _ = _dense_inputs(data, "dc_", mesh, dtype,
                                             device, False)
        cfg = cp.CPConfig(**json.loads(str(data["dc_cfg"])),
                          mesh_layout=layout)
        for pp in (int(p) for p in data["dc_pp"]):
            with config.override(**over):
                _dense_engine(res, f"dcp{pp}", _dtype_name(dtype),
                              lambda: cp.als_cp_pp(Vb, Wb, cfg,
                                                   partial_update=pp == 2),
                              ("gradnorm", "diffV", "pp"), layout, device)
        engines = {1: cp.als_cp_pp_device, 2: cp.als_cp_pp_fused}
        for loop in (int(x) for x in _listed(data, "dc_loops")):
            with config.override(**over):
                _dense_engine(res, f"dcl{loop}", _dtype_name(dtype),
                              lambda: engines[loop](Vb, Wb, cfg),
                              ("gradnorm", "diffV", "pp"), layout, device)


def task_dtucker(data, res, mesh, dtypes, device):
    """The Tucker engine at ``dt_hosvd_max`` if given, then the package's
    HOSVD threshold again for the tasks that follow."""
    from pairwise_perturbation_tpu_torch.models import tucker
    default = tucker.HOSVD_EXACT_EIGH_MAX
    if "dt_hosvd_max" in data:
        tucker.HOSVD_EXACT_EIGH_MAX = int(data["dt_hosvd_max"])
    try:
        _dtucker_runs(data, res, mesh, dtypes, device)
    finally:
        tucker.HOSVD_EXACT_EIGH_MAX = default


def _dtucker_runs(data, res, mesh, dtypes, device):
    from pairwise_perturbation_tpu_torch.models import tucker
    ranks = tuple(int(r) for r in data["dt_ranks"])
    for dtype in dtypes:
        d = _dtype_name(dtype)
        layout, Vb, _, _, _ = _dense_inputs(data, "dt_", mesh, dtype, device,
                                            False)
        cfg = tucker.TuckerConfig(**json.loads(str(data["dt_tk_cfg"])),
                                  mesh_layout=layout)
        Q0s = _factors(data, "dt_Q", dtype, device) or None
        Ws = tucker.hosvd(Vb, ranks, Q0s, layout=layout)[1] if Q0s else None
        engines = {"dtk": tucker.als_tucker_pp,
                   "dtl1": tucker.als_tucker_pp_device,
                   "dtl2": tucker.als_tucker_pp_fused}
        tags = ["dtk"] if "dt_host" not in data or int(data["dt_host"]) \
            else []
        tags += [f"dtl{int(x)}" for x in _listed(data, "dt_loops")]
        for tag in tags:
            r = _dense_engine(res, tag, d, lambda: engines[tag](
                Vb, ranks, cfg, Ws=Ws), ("diffnorm", "diffV", "pp"), layout,
                device)
            res.put(f"{tag}_core/{d}", r.core, keep=True)


def _drun_one(spec, Vb, Wb, layout, device, record):
    """One ``drun`` run: with ``maxiter``, ``cli.run_cpd`` (run's ALS loop,
    a diagnostics row every ``resprint`` steps); else ``steps`` steps of
    the optimizer, ``record(k, factors)`` after each with ``each``.
    Returns (factors, history rows (sweeps, gradnorm, diffV) or None, wall
    seconds, scope statistics, kernel launches)."""
    from pairwise_perturbation_tpu_torch import cli
    from pairwise_perturbation_tpu_torch.utils import tracing
    opts, macro = spec.get("opts", {}), spec.get("macro", False)
    if "maxiter" in spec:
        model, wall, stats, launches = _run_counted(lambda: cli.run_cpd(
            Vb, list(Wb), spec["pp"], tol=0.0, maxiter=spec["maxiter"],
            resprint=spec.get("resprint", 1), lam=spec.get("lam", 0.0),
            macro=macro, layout=layout, **opts), device)
        return (model.W, _history(model.history,
                                  ("sweeps", "gradnorm", "diffV")),
                wall, stats, launches)
    o = cli.run_optimizer(spec["pp"], Vb.ndim, Wb[0].shape[1], **opts)
    o.configure(Vb, list(Wb), spec.get("lam", 0.0), layout)
    fn = o.step_cycle if macro else o.step
    scope = f"{type(o).__name__}.{fn.__name__}"

    def run():
        for k in range(spec["steps"]):
            tracing.timed(scope, fn)
            if spec.get("each"):
                record(k, o.W)

    _, wall, stats, launches = _run_counted(run, device)
    return o.W, None, wall, stats, launches


def task_drun(data, res, mesh, dtypes, device):
    import torch
    from pairwise_perturbation_tpu_torch import config
    from pairwise_perturbation_tpu_torch.models import optimizers as opt
    from pairwise_perturbation_tpu_torch.ops import solve
    from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
    runs = json.loads(str(data["dr_runs"])) if "dr_runs" in data else []
    for dtype in dtypes:
        d = _dtype_name(dtype)
        layout, Vb, Wb, _, _ = _dense_inputs(data, "dr_", mesh, dtype,
                                             device, False)
        order = Vb.ndim

        def put(key, Ws):
            for m, W in enumerate(Ws):
                res.put(f"{key}/{m}", _whole(W, [(0, m)], layout), keep=True)

        if "dr_lefts" in data:
            put(f"cycle/{d}", opt.msdt_cycle(
                Vb, list(Wb), 0.0, lefts=tuple(int(x) for x in
                                               data["dr_lefts"]),
                layout=layout)[0])
        for spec in runs:
            tag = spec["tag"]
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            with config.override(**spec.get("config", {})):
                W, hist, wall, stats, launches = _drun_one(
                    spec, Vb, Wb, layout, device,
                    lambda k, Ws: put(f"run/{d}/{tag}/{k}", Ws))
            put(f"run/{d}/{tag}/W", W)
            if hist is not None:
                res.put(f"run_hist/{d}/{tag}", hist, keep=True)
            res.meta(f"run_stats/{d}/{tag}", stats)
            res.meta(f"run_wall/{d}/{tag}", wall)
            res.meta(f"run_launches/{d}/{tag}", json.dumps(launches))
            res.meta(f"run_peak/{d}/{tag}",
                     torch.cuda.max_memory_allocated(device)
                     if device.type == "cuda" else 0)
        for chk in json.loads(str(data["dr_svd"])) if "dr_svd" in data \
                else ():
            m, A = chk["mode"], data[chk["A"]]
            Ab = pmesh._padded_block(A, [layout.span(m), (0, A.shape[1])],
                                     device, None).to(dtype)
            if chk["X"] is None:
                U, sv, VT = solve.truncated_svd(Ab, chk["r"], layout, m)
            else:
                X = torch.from_numpy(data[chk["X"]]).to(dtype).to(device)
                U, sv, VT = solve.randomized_svd(Ab, chk["r"], X,
                                                 layout=layout, mode=m)
            res.put(f"svd/{d}/{chk['name']}",
                    _whole((U * sv) @ VT, [(0, m)], layout), keep=True)


def _cli_runs(data, res):
    """cli.main of each ``cli_argv`` entry, under its ``cli_config``
    overrides; exit codes and kernel launches per run."""
    from pairwise_perturbation_tpu_torch import cli, config
    from pairwise_perturbation_tpu_torch.scripts import _bench
    from pairwise_perturbation_tpu_torch.utils import io
    for name, shape in json.loads(str(data["io_shapes"])).items() \
            if "io_shapes" in data else ():
        setattr(io, name, tuple(shape))
    argvs = json.loads(str(data["cli_argv"]))
    overs = json.loads(str(data["cli_config"])) if "cli_config" in data \
        else [{}] * len(argvs)
    rcs, launches = [], []
    for argv, over in zip(argvs, overs):
        before = _bench.launch_counts()
        with config.override(**over):
            rcs.append(cli.main(list(argv)))
        launches.append({k: n - before.get(k, 0)
                         for k, n in _bench.launch_counts().items()})
    res.meta("cli_rc", rcs)
    res.meta("cli_launches", json.dumps(launches))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--tasks", default="functions",
                    help="comma-separated: functions, cp, tucker, als, "
                         "dense, dfunctions, dcp, dtucker, drun, cli")
    ap.add_argument("--dtypes", default="float64,float32")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--arrays", action="store_true",
                    help="write the result arrays, not only digests")
    args = ap.parse_args(argv)

    import torch
    from pairwise_perturbation_tpu_torch import config
    from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
    from pairwise_perturbation_tpu_torch.scripts import _bench
    torch.set_num_threads(1)
    config.apply_fp32_pins()
    if not pmesh.launched():
        raise SystemExit("multiprocess_worker runs under torchrun")
    device = pmesh.distributed_init(args.device)
    try:
        dtypes = [getattr(torch, d) for d in args.dtypes.split(",")]
        data = np.load(args.inputs, allow_pickle=False)  # read lazily
        res = _Results(args.arrays)
        res.meta("rank", pmesh.rank())
        res.meta("world", pmesh.world_size())
        res.meta("backend", pmesh.backend())
        res.meta("device", str(device))
        tasks = args.tasks.split(",")
        _bench.reset_launch_counts()
        mesh = None
        if {"functions", "cp", "tucker", "als"} & set(tasks):
            mesh = pmesh.make_mesh(device_type=device.type)
        if "functions" in tasks:
            task_functions(data, res, mesh, dtypes, device)
        if "cp" in tasks:
            task_cp(data, res, mesh, dtypes, device)
        if "tucker" in tasks:
            task_tucker(data, res, mesh, dtypes, device)
        if "als" in tasks:
            task_als(data, res, mesh, device)
        if "dense" in tasks:
            task_dense(data, res, device)
        dense = [t for t in ("dfunctions", "dcp", "dtucker", "drun")
                 if t in tasks]
        if dense:
            dmesh = pmesh.make_mesh(tuple(int(s) for s in data["dd_mesh"]),
                                    device_type=device.type)
            res.meta("coordinate", dmesh.get_coordinate())
            tasks_of = {"dfunctions": task_dfunctions, "dcp": task_dcp,
                        "dtucker": task_dtucker, "drun": task_drun}
            for t in dense:
                tasks_of[t](data, res, dmesh, dtypes, device)
        if "cli" in tasks:
            _cli_runs(data, res)
        res.meta("launches", json.dumps(_bench.launch_counts()))
        os.makedirs(args.outdir, exist_ok=True)
        np.savez(os.path.join(args.outdir, f"result_{pmesh.rank()}.npz"),
                 **res.out)
        print(f"[rank {pmesh.rank()}/{pmesh.world_size()}] ok: tasks "
              f"{args.tasks}, backend {pmesh.backend()}, device {device}",
              flush=True)
    finally:
        pmesh.distributed_close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
