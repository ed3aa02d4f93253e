"""Fused order-3 MTTKRP: the hand-written CUDA kernels and their plain
PyTorch version.

    mode 0  M[i,r] = sum_{j,k} V[i,j,k] B[j,r] C[k,r]
    mode 1  M[j,r] = sum_{i,k} V[i,j,k] A[i,r] C[k,r]
    mode 2  M[k,r] = sum_{i,j} V[i,j,k] A[i,r] B[j,r]

Replaces ``pairwise_perturbation_tpu/ops/kernels/mttkrp_pallas.py``:
``mttkrp3_mode`` and the Pallas kernels behind it, ``mttkrp3`` (mode 0),
``mttkrp3_m1`` (mode 1) and ``mttkrp3_m2`` (mode 2). The kernels
(``csrc/mttkrp3.cu``) are bound by memory bandwidth on the H100: they read
V once, coalesced, with no (I, J, R) intermediate; the source's header
says how. Unlike the Pallas version, mode 2 always uses its own kernel
(the TPU's 8 MiB VMEM fallback to a transposed copy has no Hopper
counterpart: its (K, R) partial sums live in scratch in device memory).

Each launch follows a plan, a pure function of the shapes and the SM
count that puts about ``BLOCKS_PER_SM`` blocks on every SM: modes 0 and 1
(:func:`rows_plan`) cut each output row's fibers into parts; mode 2
(:func:`minor_plan`) cuts V's I*J fibers into slabs and k into chunks,
while the slabs' (K, R) partials stay under ``SCRATCH_SHARE`` of V's
bytes. The first call for a (stream, mode, shapes, R, load width) builds
a launch record (:func:`launch_record`: the operands checked once, the
plan, its scratch, the kernel's shared-memory limit); later calls only
pass pointers.

:func:`mttkrp3_mode` launches the kernel for a CUDA tensor, or raises; it
takes the plain version (:func:`mttkrp3_mode_plain`) only for a tensor on
the CPU. Each call (with the partials' sum, two launches) adds one to
``LAUNCHES[mode]``.
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Sequence

import torch

from pairwise_perturbation_tpu_torch.ops.kernels import _build

# Kernel launches per mode, counted where each kernel is launched.
LAUNCHES: Dict[int, int] = {0: 0, 1: 0, 2: 0}

# Threads per block (csrc/mttkrp3.cu kMaxThreads), blocks meant to share
# an SM, the largest share of V's bytes that mode 2's partials may take,
# the fewest k vectors a chunk keeps when k is split to respect it, and
# the shared memory that a block's staged weights may take.
THREADS = 256
BLOCKS_PER_SM = 2
SCRATCH_SHARE = 0.04
MIN_KCOLS = 16
STAGE_BYTES = 64 * 1024
_PLAIN_SPECS = {0: "ijk,jr,kr->ir", 1: "ijk,ir,kr->jr", 2: "ijk,ir,jr->kr"}


class MinorPlan(NamedTuple):
    """Mode 2's launch shape (csrc/mttkrp3.cu pp_mttkrp3_mode2)."""
    vec: int          # floats per load of V: 4 (16 bytes) or 1
    rank_chunk: int   # RC, ranks per pass
    threads: int      # threads per block, a multiple of 32
    kcols: int        # k vectors per block
    rows: int         # fibers per block step (threads >= rows * kcols)
    k_chunks: int
    n_slabs: int
    slab_len: int     # fibers per slab
    stage: int        # fibers whose weights are staged at once
    smem: int         # dynamic shared memory of a block, bytes


def rank_chunk(R: int) -> int:
    """csrc/common.cuh rank_chunk: the smallest of 4, 8, 12, 16, 24 that
    covers R, else 32."""
    return next((c for c in (4, 8, 12, 16, 24) if R <= c), 32)


def step_unroll(vec: int, rc: int) -> int:
    """csrc/mttkrp3.cu step_unroll: steps whose loads a thread issues
    together."""
    return 8 if vec == 1 else (4 if vec * rc <= 64 else 2)


def _tile(kv: int, k_chunks: int):
    """(kcols, rows, threads): kv vectors of k cut into k_chunks chunks of
    kcols, and as many fibers per step as fill THREADS threads."""
    kcols = -(-kv // k_chunks)
    rows = max(1, THREADS // kcols)
    return kcols, rows, -(-kcols * rows // 32) * 32


@functools.lru_cache(maxsize=256)
def minor_plan(I: int, J: int, K: int, R: int, n_sm: int,
               vec: bool) -> MinorPlan:
    """Mode 2's split of the I*J fibers and of k on ``n_sm`` SMs; ``vec``
    asks for 16-byte loads (K % 4 == 0 and V 16-byte aligned). The
    BLOCKS_PER_SM * n_sm blocks are shared out over k chunks, rank chunks
    and slabs; k is split further (down to MIN_KCOLS vectors a chunk)
    while the slabs' (n_slabs, K, R) partials would exceed SCRATCH_SHARE
    of V's bytes, and the slabs are then capped at that share. Every
    fiber lies in exactly one slab."""
    vw = 4 if vec else 1
    kv = -(-K // vw)
    rc = rank_chunk(R)
    n_rc = -(-R // rc)
    n_fibers = I * J
    target = BLOCKS_PER_SM * n_sm
    max_slabs = max(1, int(SCRATCH_SHARE * n_fibers / R))
    k_chunks = -(-kv // THREADS)
    while (-(-target // (k_chunks * n_rc)) > max_slabs
           and -(-kv // (k_chunks + 1)) >= MIN_KCOLS):
        k_chunks += 1
    kcols, rows, threads = _tile(kv, k_chunks)
    k_chunks = -(-kv // kcols)
    n_slabs = min(-(-target // (k_chunks * n_rc)), max_slabs,
                  -(-n_fibers // (rows * step_unroll(vw, rc))))
    slab_len = -(-n_fibers // max(1, n_slabs))
    stage = min(slab_len, STAGE_BYTES // (4 * rc))
    return MinorPlan(vw, rc, threads, kcols, rows, k_chunks,
                     -(-n_fibers // slab_len), slab_len, stage,
                     4 * rc * max(stage, threads))


class RowsPlan(NamedTuple):
    """Modes 0 and 1's launch shape (csrc/mttkrp3.cu pp_mttkrp3_rows)."""
    vec: int          # floats per load of V: 4 (16 bytes) or 1
    rank_chunk: int   # RC, ranks per pass
    threads: int      # threads per block, a multiple of 32
    kcols: int        # k vectors per block step
    rows: int         # fibers per block step (threads >= rows * kcols)
    k_chunks: int     # steps of kcols vectors that cover k
    parts: int        # parts of an output row's fibers
    part_len: int     # fibers per part
    smem: int         # dynamic shared memory of a block, bytes


@functools.lru_cache(maxsize=256)
def rows_plan(nx: int, ny: int, K: int, R: int, n_sm: int,
              vec: bool) -> RowsPlan:
    """The rows kernel's split for nx output rows of ny fibers each (mode
    0: nx = I, ny = J; mode 1: nx = J, ny = I) on ``n_sm`` SMs; ``vec``
    as for :func:`minor_plan`. Each row's fibers are cut into the fewest
    equal parts that give BLOCKS_PER_SM * n_sm blocks (one per row, part
    and rank chunk) and whose staged weights fit STAGE_BYTES, but no part
    shorter than one unrolled step; every fiber of a row lies in exactly
    one part."""
    vw = 4 if vec else 1
    kv = -(-K // vw)
    rc = rank_chunk(R)
    n_rc = -(-R // rc)
    kcols, rows, threads = _tile(kv, -(-kv // THREADS))
    step = rows * step_unroll(vw, rc)
    parts = max(min(-(-BLOCKS_PER_SM * n_sm // (nx * n_rc)),
                    max(1, ny // step)),
                -(-ny // (STAGE_BYTES // (4 * rc))))
    part_len = -(-ny // parts)
    return RowsPlan(vw, rc, threads, kcols, rows, -(-kv // kcols),
                    -(-ny // part_len), part_len,
                    4 * rc * max(part_len, threads // 32))


def plan(shape: Sequence[int], R: int, mode: int, n_sm: int, vec: bool):
    """The launch plan of ``mode`` at V's ``shape``."""
    I, J, K = shape
    if mode == 2:
        return minor_plan(I, J, K, R, n_sm, vec)
    nx, ny = (I, J) if mode == 0 else (J, I)
    return rows_plan(nx, ny, K, R, n_sm, vec)


def can_vec(V) -> bool:
    """Whether the kernels may read V with 16-byte loads."""
    return V.shape[2] % 4 == 0 and V.data_ptr() % 16 == 0


def reset_launch_counts() -> None:
    for m in LAUNCHES:
        LAUNCHES[m] = 0


def mttkrp3_mode_plain(V, factors: Sequence, mode: int):
    """Plain PyTorch version (one einsum); what the kernels are held to."""
    others = [factors[m] for m in range(3) if m != mode]
    return torch.einsum(_PLAIN_SPECS[mode], V, *others)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(V, factors: Sequence, mode: int):
    if mode not in (0, 1, 2):
        raise ValueError(f"mode must be 0, 1 or 2, got {mode}")
    if V.ndim != 3 or len(factors) != 3:
        raise ValueError(f"order-3 V and 3 factors expected, got V "
                         f"{tuple(V.shape)} and {len(factors)} factors")
    R = factors[0].shape[1] if factors[0].ndim == 2 else -1
    for m, W in enumerate(factors):
        if W.ndim != 2 or W.shape != (V.shape[m], R):
            raise ValueError(f"factor {m} has shape {tuple(W.shape)}, "
                             f"expected ({V.shape[m]}, R)")
    if V.numel() == 0 or R <= 0:
        raise ValueError(f"empty operand: V {tuple(V.shape)}, R {R}")
    for name, t in [("V", V)] + [(f"factor {m}", W)
                                 for m, W in enumerate(factors) if m != mode]:
        if t.device != V.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel needs "
                             f"every operand on V's CUDA device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return R


class _Launch:
    """One launch record: the plan, the C entry's fixed arguments, and the
    scratch, allocated on the stream the record serves."""

    def __init__(self, V, R: int, mode: int, vec: bool):
        I, J, K = V.shape
        self.lib, self.R, self.n_out = _build.load(), R, V.shape[mode]
        p = self.plan = plan(V.shape, R, mode, _sm_count(V.device.index),
                             vec)
        if mode == 2:
            n_parts, self.args = p.n_slabs, (
                I, J, K, R, p.vec, p.threads, p.kcols, p.rows, p.k_chunks,
                p.n_slabs, p.slab_len, p.stage, p.smem)
        else:
            nx, ny, sx, sy = (I, J, J * K, K) if mode == 0 else \
                (J, I, K, J * K)
            n_parts, self.args = p.parts, (
                nx, ny, K, R, sx, sy, p.vec, p.threads, p.kcols, p.rows,
                p.k_chunks, p.parts, p.part_len, p.smem)
        self.partial = torch.empty(
            (n_parts, self.n_out, R), dtype=torch.float32,
            device=V.device) if n_parts > 1 or mode == 2 else None
        with torch.cuda.device(V.device):
            _build.check(self.lib, self.lib.pp_mttkrp3_prepare(
                0 if mode < 2 else 2, R, p.vec),
                f"mttkrp3 mode {mode} shared memory")


_RECORDS: Dict[tuple, _Launch] = {}
_MAX_RECORDS = 64


def launch_record(V, factors: Sequence, mode: int, stream) -> _Launch:
    """The launch record of ``mode`` for V's shape and load width, this
    factor signature (each factor's shape, dtype, device and contiguity)
    and ``stream`` (a raw stream handle): on first use the operands are
    checked (raising on what the kernel does not take) and the record is
    built; later calls with the same key skip both. Each stream has its
    own record, so calls on two streams never share scratch."""
    vec = V.ndim == 3 and can_vec(V)
    key = (stream, mode, vec, V.shape, V.dtype, V.device,
           V.is_contiguous()) + tuple(
        (W.shape, W.dtype, W.device, W.is_contiguous()) for W in factors)
    rec = _RECORDS.get(key)
    if rec is None:
        R = _check(V, factors, mode)
        if len(_RECORDS) >= _MAX_RECORDS:  # the oldest goes, scratch and all
            _RECORDS.pop(next(iter(_RECORDS)))
        rec = _RECORDS[key] = _Launch(V, R, mode, vec)
    return rec


def mttkrp3_mode(V, factors: Sequence, mode: int):
    """Fused order-3 MTTKRP of ``mode``: (V.shape[mode], R).

    CPU tensors go to the plain version; CUDA tensors launch the kernel
    on the current stream (f32, contiguous operands) or raise."""
    if V.device.type == "cpu":
        return mttkrp3_mode_plain(V, factors, mode)
    if V.device.type != "cuda":
        _check(V, factors, mode)  # raises: the kernels take CUDA operands
    stream = _build.current_stream(V.device)
    rec = launch_record(V, factors, mode, stream)
    out = V.new_empty((rec.n_out, rec.R))
    A, B, C = (W.data_ptr() for W in factors)
    part = 0 if rec.partial is None else rec.partial.data_ptr()
    lib = rec.lib
    if mode == 2:
        code = lib.pp_mttkrp3_mode2(V.data_ptr(), A, B, part, out.data_ptr(),
                                    *rec.args, stream)
    else:
        code = lib.pp_mttkrp3_rows(V.data_ptr(), B if mode == 0 else A, C,
                                   part, out.data_ptr(), *rec.args, stream)
    _build.check(lib, code, f"mttkrp3 mode {mode} launch")
    LAUNCHES[mode] += 1
    return out
