"""Command-line entry points of the port — the counterpart of
``pairwise_perturbation_tpu/cli.py`` and of the reference's binaries:

- ``test_als`` (``./test_ALS``, test_ALS.cxx; JAX cli.py:182-409). CP,
  dense or sparse: -pp 0 DT-ALS, -pp 1 PP with DT preconditioning, -pp 2
  PP-partupdate (each PP sweep solves the ``-update_percentage_pp`` share
  of the modes that moved most), host-driven phases; ``-pp 1
  -device_loop 1`` keeps each phase's loop state on the device
  (``cp.als_cp_pp_device``), ``-device_loop 2`` the whole DT <-> PP
  machine's (``cp.als_cp_pp_fused``). ``-issparse 1`` runs
  the COO engine (models/sparse_cp.py) on V's nonzeros instead: plain ALS
  sweeps with -pp 0, PP with plain-ALS preconditioning with -pp 1.
  ``-model Tucker`` (models/tucker.py): -pp 0 DT-ALS from HOSVD, any
  other -pp Tucker-PP (``-device_loop 1`` and ``2`` as for CP:
  ``tucker.als_tucker_pp_device`` and ``als_tucker_pp_fused``);
  ``-tucker_subspace`` picks the factor extraction
  (-1 AUTO, 0 exact eigh, k subspace iterations) and ``-tucker_pp_skip``
  the quiet-mode skip of PP sweeps; the CSV has ``[diffnorm]`` in place
  of ``[gradnorm]``. With ``-issparse 1`` (models/sparse_tucker.py):
  -pp 0 sparse HOOI, -pp 1 sparse Tucker-PP, both from a randomized
  sparse HOSVD.
- ``run`` (``./run``, run.cxx; JAX cli.py:411-466): the second-gen CPD
  with -pp 0 DT, 1 MSDT, 2 DT-LR, 3 MSDT-LR, 4 Simple
  (models/optimizers.py), on dense V or, with ``-issparse 1``, on the COO
  of V's nonzeros (sparse chain tops; Simple sweeps through the COO
  MTTKRP). ``-device_loop 1`` steps MSDT (and
  MSDT-LR, as in the JAX package) a full MSDT rotation per call
  (``step_cycle``); ``-msdt_min_holdout``,
  ``-updaterank``, ``-randomsvd`` and ``-lambda`` as in the JAX package;
  ``-seed`` seeds the factors and the randomized SVD's draws.
- ``pp_bench`` (``./pp_bench``, pp_bench.cxx:277-348; JAX cli.py:468-551)
  for CP or Tucker: ``[timetype],[dtime]`` rows, ``[DTtime]`` (one DT
  sweep), ``[PPfirst]`` (a PP cache build and the first PP sweep) and
  ``[PPsecond]`` (the next PP sweep on those caches), ``-maxiter`` of each
  kind, every one from the same initial factors (Tucker: HOSVD's).

    python -m pairwise_perturbation_tpu_torch.cli test_als -model CP \\
        -tensor r -pp 1 -dim 3 -size 200 -rank 10 -maxiter 40 -filename out.csv
    python -m pairwise_perturbation_tpu_torch.cli test_als -model Tucker \\
        -tensor r -pp 1 -dim 3 -size 200 -rank 10 -maxiter 20 -filename t.csv
    python -m pairwise_perturbation_tpu_torch.cli run -tensor r -pp 1 \\
        -dim 3 -size 200 -rank 10 -maxiter 20 -filename run.csv
    python -m pairwise_perturbation_tpu_torch.cli pp_bench -model CP \\
        -tensor r -dim 3 -size 512 -rank 10 -maxiter 3 -filename bench.csv

Runs on ``-device`` (default ``cuda``), in float32, float64 or the
mixed-precision ``bfloat16`` mode (V stored bf16; factors, Grams and
solves float32), on the synthetic zoo p/p2/c/r/r2 or on the coil-100
(``-tensor o1``) and time-lapse (``-tensor o2``) binaries, read from
``-tensorfile`` (default coil-100.bin / time-lapse.bin) by utils/io.py.
The CSVs have the reference's schema.

Mode order: the port keeps V's natural (CTF) mode order. The JAX package
permutes modes for the TPU's (8, 128) tiles (its utils/layout.py), which
is the identity for coil-100 and every synthetic tensor, but (0, 3, 1, 2)
for time-lapse; its checkpoints are written back in the natural order, so
``-checkpoint`` files of either package load in the other.

``-checkpoint PATH`` writes the final factors of test_als (and Tucker's
core) to PATH.npz; ``-resume PATH`` starts dense CP test_als from a
checkpoint's factors, the only path where the JAX package reads it.
``-profile 1 -trace_dir DIR`` also writes a torch.profiler trace of the
command to DIR (utils/tracing.device_trace). ``-layouts 1`` is accepted
where the JAX package reads it (dense CP ``test_als -pp 0`` and ``-pp 1
-device_loop 1`` or ``2``) and builds nothing: on a card the mid_contract
kernel reads V in place. A flag that the JAX package ignores on a path is
refused there, saying so.

``-mesh N`` (or ``AxB``) runs ``test_als`` and ``pp_bench`` over a mesh
of ranks (parallel/mesh.py), one process per rank, started by torchrun;
rank 0 alone prints and writes the CSV (and the checkpoint, of the
unsharded factors). The dense engines take V block-sharded over its
largest modes (zero-padded; ``-tensor o1/o2`` read block by block from
the file, ``-tensor r`` formed block by block on each rank's device from
its factors' rows), CP and Tucker, every -pp, dtype and ``-device_loop``
of the unsharded run;
``-issparse 1`` takes an nnz-sharded COO over a 1D mesh:

    torchrun --standalone --nproc_per_node 2 \
        -m pairwise_perturbation_tpu_torch.cli test_als -model CP \
        -tensor r -pp 1 -dim 3 -size 200 -rank 10 -mesh 2
    torchrun --standalone --nproc_per_node 2 \
        -m pairwise_perturbation_tpu_torch.cli pp_bench -model CP \
        -tensor r -dim 3 -size 512 -rank 10 -maxiter 3 -mesh 2
    torchrun --standalone --nproc_per_node 2 \
        -m pairwise_perturbation_tpu_torch.cli test_als -model CP \
        -tensor p -issparse 1 -pp 1 -dim 8 -size 10 -rank 10 -mesh 2

``run -mesh N`` runs the five optimizers on the same block-sharded V
(``-issparse 1`` stays refused there, as in the JAX package):

    torchrun --standalone --nproc_per_node 2 \
        -m pairwise_perturbation_tpu_torch.cli run -tensor r -dim 3 \
        -size 200 -rank 10 -pp 1 -mesh 2
"""

from __future__ import annotations

import functools
import os
import sys
import time

import numpy as np

RUN_OPTIMIZERS = ("DT", "MSDT", "DT-LR", "MSDT-LR", "Simple")


def _device_loop_refusal(args, cmd):
    """Why ``-device_loop`` >= 1 is refused for this command, or None:
    where the JAX package ignores the flag, the refusal says so."""
    if args.device_loop < 1 or cmd == "run":
        return None
    ignored = "; the JAX package ignores the flag there. Use -device_loop 0"
    if cmd == "pp_bench":
        return "-device_loop: pp_bench times host-driven sweeps" + ignored
    if args.issparse:
        return ("-device_loop: the sparse engines (-issparse 1) have no "
                "device-resident loop" + ignored)
    if args.model == "CP" and args.pp != 1:
        return (f"-device_loop: test_als -model CP -pp {args.pp} runs the "
                "host-driven engine" + ignored)
    if args.model == "Tucker" and args.pp == 0:
        return ("-device_loop: test_als -model Tucker -pp 0 (DT-ALS) runs "
                "the host-driven engine" + ignored)
    return None


def _layouts_refusal(args, cmd):
    """Why ``-layouts 1`` is refused, or None: the JAX package reads it
    only in dense CP test_als with -pp 0 (DT-ALS) and with -pp 1
    -device_loop 1 or 2 (the device engines), and ignores it everywhere
    else."""
    if not args.layouts:
        return None
    if cmd == "test_als" and args.model == "CP" and not args.issparse:
        if args.pp == 0 or (args.pp == 1 and args.device_loop >= 1):
            return None
        where = (f"test_als -model CP -pp {args.pp}"
                 + (" -device_loop 0 (the host-driven engine)"
                    if args.pp == 1 else " (PP-partupdate)"))
    elif cmd == "test_als":
        where = ("the sparse engines (-issparse 1)" if args.issparse
                 else "test_als -model Tucker")
    else:
        where = cmd
    return (f"-layouts 1: {where} never reads it; the JAX package ignores "
            "the flag there. Use -layouts 0 (the flag serves dense CP "
            "test_als -pp 0, and -pp 1 with -device_loop 1 or 2)")


def _unsupported(args, cmd):
    """The first requested feature the port does not have yet, or that
    the JAX package ignores, or None."""
    resumes = cmd == "test_als" and args.model == "CP" and not args.issparse
    if cmd == "run":
        checks = [
            (args.pp >= len(RUN_OPTIMIZERS),
             "run takes -pp 0 (DT), 1 (MSDT), 2 (DT-LR), 3 (MSDT-LR) or "
             "4 (Simple)"),
        ]
    elif cmd == "pp_bench":
        checks = [
            (bool(args.issparse), "pp_bench has no sparse engine "
             "(-issparse 1), in the JAX package either"),
        ]
    else:
        checks = [
            (bool(args.issparse) and args.pp not in (0, 1),
             "-issparse 1 takes -pp 0 or 1: -pp 2 (PP-partupdate) has no "
             "sparse engine, in the JAX package either"),
        ]
    loop = _device_loop_refusal(args, cmd)
    layouts = _layouts_refusal(args, cmd)
    checks += [
        (loop is not None, loop),
        (bool(args.mesh) and bool(args.issparse)
         and (cmd != "test_als" or "x" in args.mesh),
         "-issparse 1 is supported for test_als -model {CP,Tucker} "
         "-pp {0,1} and for run (all optimizers); -mesh with sparse "
         "only for test_als CP/Tucker on a 1D mesh (nnz-sharded COO, "
         "parallel/mesh.shard_coo). Re-run without -issparse or "
         "adjust -mesh."),
        (layouts is not None, layouts),
        (bool(args.resume) and not resumes,
         "-resume seeds only dense CP test_als: the JAX package reads no "
         "checkpoint on this path either"),
        (bool(args.checkpoint) and cmd != "test_als",
         f"-checkpoint: {cmd} writes no checkpoint, in the JAX package "
         "either"),
    ]
    for bad, msg in checks:
        if bad:
            return msg
    return None


def _print_banner(args):
    if args.quiet:
        return
    print(f"  model=  {args.model}  tensor=  {args.tensor}  pp=  {args.pp}")
    print(f"  dim=  {args.dim}  size=  {args.size}  rank=  {args.rank}")
    print(f"  tolerance=  {args.tol}  restarttol=  {args.pp_res_tol}")
    print(f"  lambda=  {args.lam}  magnitude=  {args.magni}"
          f"  filename=  {args.filename}")
    print(f"  timelimit=  {args.timelimit}  maxiter=  {args.maxiter}"
          f"  resprint=  {args.resprint}")
    print(f"  dtype=  {args.dtype}  device=  {args.device}")
    if args.mesh:
        from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
        print(f"  mesh=  {args.mesh}  backend=  {pmesh.backend()}  "
              f"(nccl: a card per rank; gloo: CPU or ranks sharing a card)")


def _planned_split(args, shape):
    """Native-planner binary-tree root split (None = reference midpoint)."""
    if not args.planner:
        return None
    from pairwise_perturbation_tpu_torch import native
    split, best_t, mid_t = native.plan_tree_split_traffic(
        tuple(int(s) for s in shape), int(args.rank))
    if split == (len(shape) - 1) // 2:
        return None
    if not args.quiet and mid_t == mid_t and best_t == best_t and mid_t > 0:
        print(f"  planner: root split {split} "
              f"(modeled traffic saving {100 * (mid_t - best_t) / mid_t:.1f}%"
              " vs midpoint)")
    return split


def _device(name: str):
    import torch
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("-device cuda: no CUDA device is available "
                         "(use -device cpu for a CPU run)")
    return dev


def _load_tensor(args):
    """V as numpy, in float64 under -dtype float64 and else float32, and
    the factor dtype (-dtype bfloat16 stores only V in bf16, JAX
    cli.py:24-38): -tensor o1/o2 read from -tensorfile (default
    coil-100.bin / time-lapse.bin, JAX cli.py:43-44) in their natural
    (CTF) mode order, any other -tensor the synthetic tensor of
    -dim/-size/-rank."""
    import torch
    from pairwise_perturbation_tpu_torch.utils import io, synth
    np_dtype = np.float64 if args.dtype == "float64" else np.float32
    dtype = torch.float64 if args.dtype == "float64" else torch.float32
    if args.tensor == "o1":
        V = io.load_coil100(_dataset_path(args, "coil-100.bin",
                                          io.COIL100_FILE_SHAPE),
                            out_dtype=np_dtype)
    elif args.tensor == "o2":
        V = io.load_time_lapse(_dataset_path(args, "time-lapse.bin",
                                             io.TIME_LAPSE_FILE_SHAPE),
                               out_dtype=np_dtype)
    else:
        V = synth.make_tensor(args.tensor, args.dim, args.size, args.rank,
                              args.colmin, args.colmax, args.rationoise,
                              seed=args.seed, dtype=np_dtype)
    return V, dtype


def _load_tensor_sharded(args, device):
    """-mesh with -tensor o1/o2 (JAX cli.py:80-110): this rank's block of
    the dataset, read from the file alone (io.read_dense_sharded), and
    its layout, planned on the dataset's shape. The port keeps V's
    natural mode order (C10), so the file is viewed through the CTF axis
    reversal only; the JAX package composes its TPU mode permutation
    into that view as well."""
    from pairwise_perturbation_tpu_torch.utils import io
    file_shape = io.COIL100_FILE_SHAPE if args.tensor == "o1" \
        else io.TIME_LAPSE_FILE_SHAPE
    path = _dataset_path(args, "coil-100.bin" if args.tensor == "o1"
                         else "time-lapse.bin", file_shape)
    nd = len(file_shape)
    layout = _plan(args, tuple(reversed(file_shape)), device)
    V = io.read_dense_sharded(
        path, layout, out_dtype=np.float64 if args.dtype == "float64"
        else np.float32, file_shape=file_shape,
        axes_perm=tuple(range(nd - 1, -1, -1)), device=device)
    if not args.quiet:
        print(f"  sharded read: {path} -> {layout.orig_shape} padded "
              f"{layout.padded_shape} over mesh {args.mesh}")
    return V, layout


def _random_cp_sharded(args, device):
    """-mesh with -tensor r: this rank's zero-padded block of the exact
    rank-R tensor and its layout. The factors are drawn on the host as
    synth.random_cp_tensor draws them (``default_rng(-seed)``, mode order,
    uniform(0, 1)); the block is formed on ``device`` from their rows in
    the rank's spans (parallel/mesh.cp_block), so no rank holds the whole
    V, on the host or on a card."""
    import torch
    from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
    from pairwise_perturbation_tpu_torch.utils import synth
    shape = (args.size,) * args.dim
    layout = _plan(args, shape, device)
    Ws = synth.random_cp_factors(shape, args.rank,
                                 np.random.default_rng(args.seed))
    dtype = torch.float64 if args.dtype == "float64" else torch.float32
    V = pmesh.cp_block(Ws, layout, dtype, device)
    if not args.quiet:
        print(f"  blocks of -tensor r: {layout.orig_shape} padded "
              f"{layout.padded_shape} over mesh {args.mesh}")
    return V, layout


def _plan(args, shape, device):
    """The -mesh device mesh and the layout of V's ``shape`` on it."""
    from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
    mesh = pmesh.make_mesh(_mesh_shape(args), device_type=device.type)
    return pmesh.plan_layout(shape, mesh)


def _dense_tensor(args, device):
    """(V on ``device``, its layout or None, ||V||, the factor dtype) of
    the dense engines. Without -mesh V is the whole tensor; with it,
    this rank's zero-padded block (o1/o2 read block by block, r formed
    block by block from its factors over a mesh of several devices, any
    other tensor cut from the host array). ||V|| comes from the host
    array when there is one (JAX cli.py:191-195), else from the blocks'
    squared norms summed over the mesh, V never gathered."""
    import torch
    from pairwise_perturbation_tpu_torch.ops import contract
    from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
    # r in blocks wherever a mode is split; a mesh of one device keeps the
    # host array, so that a world of one runs as one process, bit for bit
    r_blocks = bool(args.mesh) and args.tensor == "r" \
        and np.prod(_mesh_shape(args)) > 1
    if args.mesh and args.tensor in ("o1", "o2") or r_blocks:
        V, layout = (_random_cp_sharded if r_blocks
                     else _load_tensor_sharded)(args, device)
        Vnorm = float(torch.sqrt(contract.norm_sq(V, layout)))
        dtype = V.dtype
    else:
        V, dtype = _load_tensor(args)
        Vnorm = float(np.linalg.norm(V.ravel()))
        layout = _plan(args, V.shape, device) if args.mesh else None
        if layout is not None:
            V = pmesh.shard_tensor(V, layout)
    return _dense(args, V, device), layout, Vnorm, dtype


def _global_shape(X, layout):
    return tuple(X.shape) if layout is None else layout.orig_shape


def _sharded_factors(Ws, layout):
    from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
    return Ws if layout is None else pmesh.shard_factors(Ws, layout)


def _unsharded(res, layout):
    """The result's factors whole, padding stripped (JAX
    cli.py:131-137), as tensors on the CPU; unchanged without a
    layout."""
    import torch
    from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
    if layout is not None:
        res.factors = [torch.from_numpy(W)
                       for W in pmesh.unshard_factors(res.factors, layout)]
    return res


def _dataset_path(args, default, file_shape):
    """-tensorfile, or ``default`` (JAX cli.py:43-44), once it is known to
    hold a float64 array of ``file_shape``."""
    path = args.tensorfile if args.tensorfile != "test" else default
    nbytes = 8 * int(np.prod(file_shape))
    if not os.path.isfile(path) or os.path.getsize(path) != nbytes:
        raise SystemExit(
            f"-tensor {args.tensor}: {path} is not a float64 binary of the "
            f"dataset's shape {tuple(file_shape)} ({nbytes} bytes); name "
            "one with -tensorfile")
    return path


def _save_checkpoint(args, res, model, core=None):
    """-checkpoint: the result's factors (and Tucker's core), in natural
    mode order, with the JAX CLI's meta (cli.py:247-252, 283-289,
    339-345, 399-405)."""
    from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
    if not args.checkpoint or pmesh.rank() != 0:
        return
    from pairwise_perturbation_tpu_torch.utils import io
    meta = dict(model=model, tensor=args.tensor)
    if args.issparse:
        meta["sparse"] = True

    def host(t):
        return t.detach().cpu().numpy()

    io.save_checkpoint(args.checkpoint, [host(w) for w in res.factors],
                       res.iters, core=None if core is None else host(core),
                       meta=meta)


def _resumed_factors(args, shape, dtype, device):
    """-resume: a checkpoint's factors in the run's factor dtype (JAX
    cli.py:206-215), checked against V's mode sizes."""
    import torch
    from pairwise_perturbation_tpu_torch.utils import io
    ck = io.load_checkpoint(args.resume)
    sizes = [f.shape[0] for f in ck["factors"]]
    if sizes != list(shape):
        raise SystemExit(f"-resume {args.resume}: factors of mode sizes "
                         f"{sizes}, but V has shape {list(shape)}")
    if not args.quiet:
        print(f"resumed {len(sizes)} factors from {args.resume} "
              f"(iteration {ck['iteration']})")
    return [torch.from_numpy(f).to(dtype).to(device) for f in ck["factors"]]


def _mesh_shape(args):
    return tuple(int(x) for x in args.mesh.split("x"))


def _join_mesh(args) -> bool:
    """-mesh: join the torchrun world of one rank per mesh device
    (parallel/mesh.distributed_init), or refuse and say how to launch.
    ``args.device`` becomes the rank's device; ranks other than 0 run
    quietly. Returns whether this call joined the world (False when the
    caller had joined it already)."""
    import torch.distributed as dist
    from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
    n = int(np.prod(_mesh_shape(args)))
    if not pmesh.launched() or pmesh.world_size() != n:
        raise SystemExit(
            f"-mesh {args.mesh} runs one process per mesh device (ROADMAP "
            f"A15's parallel layer), and this process is in a world of "
            f"{pmesh.world_size()}: launch {n} ranks with torchrun "
            f"--standalone --nproc_per_node {n} -m "
            "pairwise_perturbation_tpu_torch.cli ...")
    joined = not dist.is_initialized()
    args.device = str(pmesh.distributed_init(args.device))
    if pmesh.rank() != 0:
        args.quiet = True
    return joined


def _shard_coo(args, st, device):
    """-mesh: this rank's block of the COO's nonzeros and the mesh (JAX
    cli.py:316-326, 370-383); (st, None) without -mesh."""
    if not args.mesh:
        return st, None
    from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
    mesh = pmesh.make_mesh(_mesh_shape(args), device_type=device.type)
    st = pmesh.shard_coo(st, mesh)
    if not args.quiet:
        print(f"  sharded COO: nnz split over {args.mesh} devices")
    return st, mesh


def _plot(args, header):
    """The CSV writer, on rank 0 alone (None on the other ranks)."""
    from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
    from pairwise_perturbation_tpu_torch.utils.metrics import PlotFile
    if pmesh.rank() != 0:
        return None
    return PlotFile(args.filename, header, echo=not args.quiet)


def _solved(solve, plot, *a, **kw):
    """``solve(*a, plot, **kw)``, the CSV closed after it."""
    try:
        return solve(*a, plot, **kw)
    finally:
        if plot is not None:
            plot.close()


def _dense(args, V, device):
    """V (a host array or a tensor) on ``device``, stored in bf16 under
    -dtype bfloat16."""
    import torch
    X = torch.as_tensor(V).to(device)
    return X.to(torch.bfloat16) if args.dtype == "bfloat16" else X


def _tucker_ranks(args, order: int):
    """Tucker ranks: the reference's vectors for the coil-100 (o1) and
    time-lapse (o2) datasets in their natural mode order
    (test_ALS.cxx:366-380), else -rank in every mode."""
    if args.tensor == "o1":
        return (3, 10, 10, 70)
    if args.tensor == "o2":
        return (10, 100, 100, 5)
    return (args.rank,) * order


def _test_als_tucker(args, V, Vnorm, device, layout=None) -> int:
    """test_als -model Tucker (JAX cli.py:255-291, 351-409), with the
    CSV's TUCKER_HEADER. Dense: -pp 0 runs DT-ALS (als_tucker), any other
    -pp Tucker-PP (als_tucker_pp), both from HOSVD. -issparse 1: -pp 0
    sparse HOOI, -pp 1 sparse Tucker-PP, from the randomized sparse
    HOSVD. ``layout``: dense V is this rank's block (-mesh), and the
    factors are unsharded before the checkpoint."""
    from pairwise_perturbation_tpu_torch.models import sparse_tucker, tucker
    from pairwise_perturbation_tpu_torch.utils.metrics import PlotFile

    t0 = time.perf_counter()
    kw = {}
    if args.issparse:
        # the sparse Tucker engine takes no extraction options (JAX
        # cli.py:383-388): exact eigh, no quiet-mode skip
        X = _sparse_tensor(args, V, device)
        if args.mesh:
            # the HOSVD starts from the unsharded COO (JAX cli.py:376)
            kw["init_st"] = X
            X, kw["mesh"] = _shard_coo(args, X, device)
        cfg = tucker.TuckerConfig(tol=args.tol * Vnorm,
                                  pp_res_tol=args.pp_res_tol,
                                  maxiter=args.maxiter,
                                  timelimit=args.timelimit,
                                  resprint=args.resprint)
        solve = (sparse_tucker.als_tucker_sparse,
                 sparse_tucker.als_tucker_pp_sparse)[args.pp]
    else:
        X = V
        cfg = tucker.TuckerConfig(tol=args.tol * Vnorm,
                                  pp_res_tol=args.pp_res_tol,
                                  maxiter=args.maxiter,
                                  timelimit=args.timelimit,
                                  resprint=args.resprint,
                                  subspace_iters=args.tucker_subspace,
                                  pp_quiet_frac=args.tucker_pp_skip,
                                  mesh_layout=layout)
        # -device_loop 1 and 2 route -pp >= 1, as JAX cli.py:272-278 does
        # (_unsupported refuses them with -pp 0)
        solve = tucker.als_tucker if args.pp == 0 else (
            tucker.als_tucker_pp, tucker.als_tucker_pp_device,
            tucker.als_tucker_pp_fused)[min(args.device_loop, 2)]
    res = _solved(solve, _plot(args, PlotFile.TUCKER_HEADER), X,
                  _tucker_ranks(args, X.ndim), cfg, **kw)
    _save_checkpoint(args, _unsharded(res, layout), "Tucker", core=res.core)
    if not args.quiet:
        print(f"\nIter = {res.iters} Final Diff norm {res.diffnorm:E}")
        if not args.issparse:
            print(f"experiment took {time.perf_counter() - t0:.6f} seconds")
    return 0


def cmd_test_als(args) -> int:
    import torch
    from pairwise_perturbation_tpu_torch.models import cp, sparse_cp
    from pairwise_perturbation_tpu_torch.utils.metrics import PlotFile

    device = _device(args.device)
    _print_banner(args)
    layout = None
    if args.issparse:
        V, dtype = _load_tensor(args)
        Vnorm = float(np.linalg.norm(V.ravel()))  # of the f32 values
    else:
        V, layout, Vnorm, dtype = _dense_tensor(args, device)
    if not args.quiet:
        print(f"Vnorm= {Vnorm}")
    if args.issparse and args.dtype == "bfloat16":
        # test_als stores V in bf16 before the COO is built (JAX
        # cli.py:197-198, 308-310): the COO holds V's bf16-rounded values
        # in float32, as the JAX package stores them
        V = torch.from_numpy(V).to(torch.bfloat16).float().numpy()
    if args.model == "Tucker":
        return _test_als_tucker(args, V, Vnorm, device, layout)
    kw = {}
    if args.issparse:
        X, mesh = _shard_coo(args, _sparse_tensor(args, V, device), device)
        if mesh is not None:
            kw["mesh"] = mesh
        solve = (sparse_cp.als_cp_sparse, sparse_cp.als_cp_pp_sparse)[args.pp]
        split = None
    else:
        X = V
        # -device_loop 1 and 2 route -pp 1 alone, as JAX cli.py:235-242
        # does (_unsupported refuses them elsewhere)
        solve = (cp.als_cp_dt,
                 (cp.als_cp_pp, cp.als_cp_pp_device, cp.als_cp_pp_fused)[
                     min(args.device_loop, 2)],
                 functools.partial(cp.als_cp_pp, partial_update=True))[
            min(args.pp, 2)]
        # planned on the padded global shape under -mesh
        split = _planned_split(args, X.shape if layout is None
                               else layout.padded_shape)
    t0 = time.perf_counter()
    # factors at the original mode sizes, then zero-padded row blocks
    # under -mesh (JAX cli.py:218-224)
    shape = _global_shape(X, layout)
    if args.resume:
        Ws = _resumed_factors(args, shape, dtype, device)
    else:
        Ws = cp.init_factors(shape, args.rank, seed=args.seed, dtype=dtype,
                             device=device)
    cfg = cp.CPConfig(tol=args.tol * Vnorm, pp_res_tol=args.pp_res_tol,
                      lam=args.lam, ratio_step=args.magni,
                      maxiter=args.maxiter, timelimit=args.timelimit,
                      resprint=args.resprint,
                      update_percentage=args.update_percentage_pp,
                      tree_split=split, mesh_layout=layout)
    res = _solved(solve, _plot(args, PlotFile.CP_HEADER), X,
                  _sharded_factors(Ws, layout), cfg, **kw)
    _save_checkpoint(args, _unsharded(res, layout), "CP")
    if not args.quiet:
        print(f"\nIter = {res.iters} Final grad norm {res.gradnorm:E}")
        print(f"experiment took {time.perf_counter() - t0:.6f} seconds")
    return 0


def run_optimizer(pp: int, order: int, R: int, *, updaterank: int = 1,
                  randomsvd: bool = False, msdt_min_holdout: int = 0,
                  seed: int = 0):
    """The optimizer ``run -pp`` picks (``RUN_OPTIMIZERS``), with run's
    options."""
    from pairwise_perturbation_tpu_torch.models import optimizers as opt
    return {
        0: lambda: opt.CPDTOptimizer(order, R),
        1: lambda: opt.CPMSDTOptimizer(order, R,
                                       min_holdout_size=msdt_min_holdout),
        2: lambda: opt.CPDTLROptimizer(order, R, updaterank, randomsvd,
                                       seed=seed),
        3: lambda: opt.CPMSDTLROptimizer(order, R, updaterank, randomsvd,
                                         seed=seed,
                                         min_holdout_size=msdt_min_holdout),
        4: lambda: opt.CPSimpleOptimizer(order, R),
    }[pp]()


def run_cpd(X, Ws, pp: int, *, tol: float, maxiter: int, resprint: int,
            timelimit: float = 5e3, lam: float = 0.0, updaterank: int = 1,
            randomsvd: bool = False, msdt_min_holdout: int = 0,
            seed: int = 0, macro: bool = False, plot=None, layout=None):
    """The body of ``run`` on the tensor ``X`` (dense, or a COO
    ``SparseTensor``) from the factors ``Ws`` (run.cxx; JAX
    cli.py:435-462): the CPD of the optimizer ``pp`` picks
    (``RUN_OPTIMIZERS``), its ALS loop to the absolute gradnorm ``tol``;
    with ``macro``, MSDT steps a full rotation per call. Returns the CPD,
    whose ``history`` holds the logged rows. ``layout`` (``-mesh``): X
    and Ws are this rank's blocks of a dense V (parallel/mesh.py)."""
    from pairwise_perturbation_tpu_torch.models import optimizers as opt
    order, R = X.ndim, Ws[0].shape[1]
    optimizer = run_optimizer(pp, order, R, updaterank=updaterank,
                              randomsvd=randomsvd,
                              msdt_min_holdout=msdt_min_holdout, seed=seed)
    model = opt.CPD(order, list(X.shape), R, optimizer)
    model.init(X, Ws, lam=lam, layout=layout)
    model.als(tol=tol, timelimit=timelimit, maxsweep=maxiter,
              resprint=resprint, plot=plot, macro=macro)
    return model


def cmd_run(args) -> int:
    """The second-gen CPD (run.cxx; JAX cli.py:411-466) on dense V or,
    with -issparse 1, on the COO of V's nonzeros: -pp picks the
    optimizer, ``-device_loop`` >= 1 runs MSDT a full rotation per step;
    the LR optimizers' randomized SVD draws from ``-seed``. Under -mesh,
    dense V is block-sharded as the dense engines take it
    (``_dense_tensor``), and the factors are drawn at the original shape,
    then cut into zero-padded row blocks (JAX cli.py:420-443)."""
    from pairwise_perturbation_tpu_torch.models import cp
    from pairwise_perturbation_tpu_torch.utils.metrics import PlotFile

    device = _device(args.device)
    _print_banner(args)
    layout = None
    if args.issparse:
        V, dtype = _load_tensor(args)
        Vnorm = float(np.linalg.norm(V.ravel()))
        # run builds the COO from the float32 values, unrounded under
        # -dtype bfloat16 (JAX cli.py:429-438), unlike test_als
        X = _sparse_tensor(args, V, device)
    else:
        X, layout, Vnorm, dtype = _dense_tensor(args, device)
    Ws = cp.init_factors(_global_shape(X, layout), args.rank, seed=args.seed,
                         dtype=dtype, device=device)
    plot = _plot(args, PlotFile.CP_HEADER)
    try:
        model = run_cpd(X, _sharded_factors(Ws, layout), args.pp,
                        tol=args.tol * Vnorm, maxiter=args.maxiter,
                        resprint=args.resprint, timelimit=args.timelimit,
                        lam=args.lam, updaterank=args.updaterank,
                        randomsvd=bool(args.randomsvd),
                        msdt_min_holdout=args.msdt_min_holdout,
                        seed=args.seed, macro=bool(args.device_loop),
                        plot=plot, layout=layout)
    finally:
        if plot is not None:
            plot.close()
    if not args.quiet:
        print(f"\nFinal gradnorm {model.gradnorm:E}")
    return 0


def _synced(V):
    """Wait for ``V``'s device: each timed window of pp_bench ends here."""
    import torch
    if V.device.type == "cuda":
        torch.cuda.synchronize(V.device)


def pp_bench_cp(V, W0, lam, magni, maxiter, split=None, plot=None,
                layout=None):
    """The CP body of pp_bench (JAX cli.py:482-517): one untimed DT sweep,
    then ``maxiter`` [DTtime] rows of one DT sweep each; one untimed cache
    build, then ``maxiter`` pairs of rows: [PPfirst] a cache build and the
    first PP sweep from zero dWs, [PPsecond] the next PP sweep on those
    caches. Every row starts from a copy of ``W0`` (solver "svd", root
    split ``split``) and its window ends in a device synchronize. Rows go
    to ``plot`` (a PlotFile, or None). Returns the factors each row kind
    ended with, at its last row: {"DTtime": ..., "PPfirst": ...,
    "PPsecond": ...}. ``layout``: V and W0 are this rank's blocks."""
    import torch
    from pairwise_perturbation_tpu_torch.models import cp

    def row(kind, seconds):
        if plot is not None:
            plot.bench_row(kind, seconds)

    def fresh():
        return [w.clone() for w in W0]

    last = {}
    Ws, _ = cp.dt_sweep(V, fresh(), lam, solver="svd", root_split=split,
                        layout=layout)
    _synced(V)
    for _ in range(maxiter):
        Ws = fresh()
        t0 = time.perf_counter()
        Ws, _ = cp.dt_sweep(V, Ws, lam, solver="svd", root_split=split,
                            layout=layout)
        _synced(V)
        row("DTtime", time.perf_counter() - t0)
        last["DTtime"] = Ws
    cp.pp_build_caches(V, fresh(), layout)
    _synced(V)
    for _ in range(maxiter):
        Ws = fresh()
        t0 = time.perf_counter()
        single, pair = cp.pp_build_caches(V, Ws, layout)
        W_init = list(Ws)
        dWs = [torch.zeros_like(w) for w in Ws]
        Ws, dWs, _ = cp.pp_sweep(single, pair, Ws, W_init, dWs, lam, magni,
                                 solver="svd", layout=layout)
        _synced(V)
        t1 = time.perf_counter()
        row("PPfirst", t1 - t0)
        Ws2, _, _ = cp.pp_sweep(single, pair, Ws, W_init, dWs, lam, magni,
                                solver="svd", layout=layout)
        _synced(V)
        row("PPsecond", time.perf_counter() - t1)
        last["PPfirst"], last["PPsecond"] = Ws, Ws2
    return last


def pp_bench_tucker(V, ranks, maxiter, plot=None, layout=None):
    """The Tucker body of pp_bench (JAX cli.py:520-551), from HOSVD's
    factors W0: one untimed DT sweep, then ``maxiter`` [DTtime] rows of
    one DT sweep each (W0 as factors and sign references, exact eigh);
    one untimed cache build, then ``maxiter`` pairs of rows: [PPfirst] a
    cache build and the first PP sweep from zero dWs, [PPsecond] the next
    PP sweep on those caches. Each window ends in a device synchronize;
    rows go to ``plot`` (a PlotFile, or None). Returns the factors each
    row kind ended with, at its last row. ``layout``: V is this rank's
    block."""
    import torch
    from pairwise_perturbation_tpu_torch.models import tucker

    def row(kind, seconds):
        if plot is not None:
            plot.bench_row(kind, seconds)

    ranks = tuple(ranks)
    last = {}
    _, W0 = tucker.hosvd(V, ranks, layout=layout)
    tucker.tucker_dt_sweep(V, list(W0), W0, ranks=ranks, use_sign=True,
                           layout=layout)
    _synced(V)
    for _ in range(maxiter):
        t0 = time.perf_counter()
        Ws, _ = tucker.tucker_dt_sweep(V, list(W0), W0, ranks=ranks,
                                       use_sign=True, layout=layout)
        _synced(V)
        row("DTtime", time.perf_counter() - t0)
        last["DTtime"] = Ws
    tucker.tucker_build_caches(V, list(W0), layout)
    _synced(V)
    for _ in range(maxiter):
        t0 = time.perf_counter()
        single, pair = tucker.tucker_build_caches(V, list(W0), layout)
        W_init = list(W0)
        dWs = [torch.zeros_like(w) for w in W0]
        Ws, dWs, _, _ = tucker.tucker_pp_sweep(single, pair, list(W0),
                                               W_init, dWs, ranks=ranks,
                                               layout=layout)
        _synced(V)
        t1 = time.perf_counter()
        row("PPfirst", t1 - t0)
        Ws2, _, _, _ = tucker.tucker_pp_sweep(single, pair, Ws, W_init, dWs,
                                              ranks=ranks, layout=layout)
        _synced(V)
        row("PPsecond", time.perf_counter() - t1)
        last["PPfirst"], last["PPsecond"] = Ws, Ws2
    return last


def cmd_pp_bench(args) -> int:
    """Per-sweep timing (pp_bench.cxx:277-348): [DTtime] rows from
    1-sweep DT runs, then [PPfirst]/[PPsecond] from 1-sweep PP runs, all
    from identical factors, as the JAX package's ``cmd_pp_bench``: CP
    from -seed's factors, Tucker from HOSVD's."""
    from pairwise_perturbation_tpu_torch.models import cp
    from pairwise_perturbation_tpu_torch.utils.metrics import PlotFile

    device = _device(args.device)
    _print_banner(args)
    X, layout, _, dtype = _dense_tensor(args, device)
    plot = _plot(args, PlotFile.BENCH_HEADER)
    try:
        if args.model == "Tucker":
            pp_bench_tucker(X, _tucker_ranks(args, X.ndim), args.maxiter,
                            plot, layout)
        else:
            W0 = cp.init_factors(_global_shape(X, layout), args.rank,
                                 seed=args.seed, dtype=dtype, device=device)
            pp_bench_cp(X, _sharded_factors(W0, layout), args.lam,
                        args.magni, args.maxiter, _planned_split(
                            args, X.shape if layout is None
                            else layout.padded_shape), plot, layout)
    finally:
        if plot is not None:
            plot.close()
    return 0


def _sparse_tensor(args, V, device):
    """-issparse 1: the COO of the nonzeros of the host array V, as the
    JAX package's _cmd_test_als_sparse (cli.py:297-348) and cmd_run
    (:429-441) build it, and its nnz/density line."""
    from pairwise_perturbation_tpu_torch.ops import sparse

    st = sparse.from_dense(V, device=device)
    density = st.nnz / float(np.prod(st.shape))
    if not args.quiet:
        print(f"  sparse COO: nnz= {st.nnz}  density= {density:.4f}")
        if density > 0.25:
            print("  WARNING: tensor is dense-ish; the dense engine "
                  "(-issparse 0) will be faster")
    return st


def main(argv=None) -> int:
    from pairwise_perturbation_tpu_torch import config
    from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
    from pairwise_perturbation_tpu_torch.utils import flags, tracing
    argv = list(sys.argv[1:] if argv is None else argv)
    cmd = "test_als"
    if argv and argv[0] in ("test_als", "run", "pp_bench"):
        cmd = argv.pop(0)
    parser = flags.build_parser(f"pairwise_perturbation_tpu_torch.cli {cmd}")
    args = parser.parse_args(argv)
    flags.clamp(args)
    why = _unsupported(args, cmd)
    if why:
        raise SystemExit(why)
    joined = bool(args.mesh) and _join_mesh(args)
    config.apply_fp32_pins()
    if args.profile:
        tracing.enable()
    run = {"test_als": cmd_test_als, "run": cmd_run,
           "pp_bench": cmd_pp_bench}[cmd]
    try:
        if args.profile and args.trace_dir:
            # a device trace only under -profile 1, as in JAX
            # cli.py:611-625
            with tracing.device_trace(args.trace_dir) as path:
                with tracing.annotate(f"cli.{cmd}"):
                    rc = run(args)
            if not args.quiet:
                print(f"device trace written to {path}")
        else:
            rc = run(args)
        if args.profile and pmesh.rank() == 0:
            print("\n" + tracing.report())
    finally:
        if joined:
            pmesh.distributed_close()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
