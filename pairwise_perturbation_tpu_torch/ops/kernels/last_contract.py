"""First-level contraction of the minor (last) mode: the hand-written CUDA
kernel and its plain PyTorch version.

    out[lead..., r] = sum_b V[lead..., b] W[b, r]

Replaces ``pairwise_perturbation_tpu/ops/kernels/mttkrp_pallas.py``:
``last_contract`` with its Pallas kernel ``_last_kernel`` (K5), and
``last_contract_eligible`` with ``_last_tile``, copied verbatim so that
the port's routing rule reads like the JAX one. As in the JAX package,
the minor mode of ``contract.first_contraction`` (the first step of every
chain on V) stays on the einsum; the kernel's callers are
``triple_roots`` (K6), for the chain root O3 of the PP cache build, and
the port's ``scripts/bench_firstpair.py``.

The kernel (``csrc/last_contract.cu``) views V as the (N, B) matrix
around its last mode and computes the tall-skinny product with W in one
pass over V; the source's header says what bounds it and how its design
answers. It takes any N and B: the TPU tile rule only decides
eligibility. Its yardstick is the one library call that computes the
same function, ``V2 @ W`` (cuBLAS SGEMM with TF32 off), which the port
never calls.

bf16-stored V follows the JAX package's mixed-precision rule: W is
rounded to bf16, products and sums are float32, the output is float32.
Eligibility stays float32 only, as in the JAX package.

:func:`plan` chooses, from the shapes, V's type and its alignment alone,
the path and its launch: ``"mma"`` (bf16 V, B % 8 == 0, V 16-byte
aligned) runs the products on the tensor cores (``_mma``), 8 rows of V
a warp as the B operand; ``"fma"`` (float32 V, and bf16 V off 16-byte
alignment or with a ragged B) runs them as FP32 FMAs. Both are hand
written; a shape takes one of them, and a failed launch raises. The plan
also says how B is split into slices of W that fit in shared memory with
two blocks on an SM, and how many blocks walk the row tiles of each
slice. With more than one slice the wrapper allocates the slices'
(n_slices, N, R) partials, which a second launch sums in slice order.
:func:`mma_step_map` is the mma path's fragment mapping (what each lane
loads and where the mma puts it) and :func:`emulate_mma` walks it over a
whole launch in numpy, so the CPU tests hold the mapping to the
contraction.

:func:`last_contract` launches the kernel for a CUDA tensor, or raises; it
takes the plain version (:func:`last_contract_plain`) only for a tensor
on the CPU. Each call (both launches) adds one to
``LAUNCHES["last_contract"]``.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple

import numpy as np
import torch

from pairwise_perturbation_tpu_torch.ops.kernels import _build, _mma

# Kernel launches, counted where the kernel is launched.
LAUNCHES: Dict[str, int] = {"last_contract": 0}

# Warps of a block (csrc/last_contract.cu kWarps), the blocks meant to
# share an SM, and the H100's shared memory per SM (228 KB), of which the
# system keeps 1 KB per block.
WARPS = 8
BLOCKS_PER_SM = 2
SMEM_PER_SM = 233472
SMEM_RESERVED = 1024
SMEM_BUDGET = SMEM_PER_SM // BLOCKS_PER_SM - SMEM_RESERVED
# The mma path (csrc/last_contract.cu kMmaRows, kMmaStep): rows of V a
# warp, columns of V a step (two k16 mmas), and the shared memory of one
# step's A fragments (two rank halves x 32 lanes x 16 bytes).
MMA_ROWS = 8
MMA_STEP = 32
MMA_STEP_BYTES = 2 * 32 * 16


class Plan(NamedTuple):
    """Launch 1's shape (csrc/last_contract.cu)."""
    path: str         # "mma" (tensor cores, bf16 V) or "fma"
    vec: int          # columns per load: 8 (mma), 4 or 1
    rank_chunk: int   # RC, ranks per pass
    rows: int         # rows of V per warp and tile
    slice_cols: int   # columns of V (rows of W) per slice
    n_slices: int
    blocks: int       # blocks per slice and rank chunk
    smem: int         # dynamic shared memory of a block, bytes


def rank_chunk(R: int) -> int:
    """csrc/common.cuh rank_chunk: the smallest of 4, 8, 12, 16, 24 that
    covers R, else 32."""
    return next((c for c in (4, 8, 12, 16, 24) if R <= c), 32)


def rows_per_warp(rc: int) -> int:
    """csrc/last_contract.cu rows_per_warp: fewer as RC grows, so that
    the rows x RC sums and the loads in flight fit in 128 registers."""
    return 2 if rc <= 24 else 1


def group_stride(rc: int, vec: int) -> int:
    """Floats between consecutive groups of ``vec`` staged rows of W: 4
    modulo 8, so the 8 lanes of a float4 phase read distinct banks."""
    return vec * rc + 4 if vec * rc % 8 == 0 else vec * rc


def path(B: int, v_offset: int, bf16: bool) -> str:
    """``"mma"`` for bf16 V with B % 8 == 0 at a 16-byte boundary
    (``v_offset`` = V's address modulo 16), else ``"fma"``."""
    return "mma" if bf16 and B % 8 == 0 and v_offset == 0 else "fma"


@functools.lru_cache(maxsize=256)
def plan(N: int, B: int, R: int, n_sm: int, v_offset: int = 0,
         bf16: bool = False) -> Plan:
    """Path, slices, tiles and grid of launch 1 for an (N, B) @ (B, R)
    product on ``n_sm`` SMs, V float32 or (``bf16``) bfloat16 at
    ``v_offset`` bytes past a 16-byte boundary. B is cut into the fewest
    equal slices whose staged W fits in SMEM_BUDGET, so two blocks share
    an SM; the BLOCKS_PER_SM * n_sm blocks the card holds at once are
    shared out over slices and rank chunks, and each block takes an equal
    run of row tiles (8 warps x rows rows each). The fma path loads 4
    values at a time when B % 4 == 0 and V is aligned to 4 elements, else
    1; the mma path stages whole 32-column steps of A fragments (W^T)."""
    if path(B, v_offset, bf16) == "mma":
        vw, rc, rows, unit, unit_bytes = 8, _mma.RANKS, MMA_ROWS, MMA_STEP, \
            MMA_STEP_BYTES
    else:
        item = 2 if bf16 else 4
        vw = 4 if B % 4 == 0 and v_offset % (4 * item) == 0 else 1
        rc = rank_chunk(R)
        rows = rows_per_warp(rc)
        unit, unit_bytes = vw, 4 * group_stride(rc, vw)
    units = -(-B // unit)
    n_slices = -(-units // (SMEM_BUDGET // unit_bytes))
    slice_units = -(-units // n_slices)
    slice_cols = slice_units * unit
    n_slices = -(-B // slice_cols)
    tiles = -(-N // (WARPS * rows))
    share = max(1, BLOCKS_PER_SM * n_sm // (n_slices * -(-R // rc)))
    per_block = -(-tiles // share)
    return Plan(path(B, v_offset, bf16), vw, rc, rows, slice_cols, n_slices,
                -(-tiles // per_block), slice_units * unit_bytes)


@functools.lru_cache(maxsize=1)
def mma_step_map():
    """One warp's 32-column step of the mma path as the kernel forms it
    (csrc/last_contract.cu ``mma_step``), as three (4096, 2) int arrays
    over its products: the V element (row of the warp's 8, column of the
    step), the W^T element (rank of the chunk's 16, column of the step)
    and the output the product is summed into (row, rank).

    V is the mma's B operand and W^T its A. Lane (g, t) loads 16 bytes of
    row g at columns 8t ... 8t + 7; the step's mma q takes pairs 2q and
    2q + 1 of the load as b0 and b1, and the same columns of W^T's ranks g
    and g + 8 (one 16-byte shared-memory load each) as a0, a2 and a1, a3;
    D's float i is rank g + 8 (i >> 1), row 2t + (i & 1)."""
    g, t = _mma.lanes()
    parts = []
    for q in (0, 1):
        a = np.zeros((32, 4, 2, 2), np.int64)
        b = np.zeros((32, 2, 2, 2), np.int64)
        for h in (0, 1):
            for i in range(4):
                a[:, i, h] = np.stack(
                    [g + 8 * (i & 1), 8 * t + 2 * (2 * q + (i >> 1)) + h], 1)
            for i in range(2):
                b[:, i, h] = np.stack([g, 8 * t + 2 * (2 * q + i) + h], 1)
        c = np.stack([np.stack([2 * t + (i & 1), g + 8 * (i >> 1)], 1)
                      for i in range(4)], 1)
        w, v, o = _mma.products(a, b, c)
        parts.append((v, w, o))
    return tuple(np.concatenate([p[k] for p in parts]) for k in range(3))


def emulate_mma(V2, W, p: Plan):
    """The mma path in numpy, launch by launch as the kernel runs it under
    plan ``p``: slices, rank chunks, row tiles of 8 (rows past N read row
    N - 1 and are not written), 32-column steps (a lane's 8 columns past
    the slice load zeros), W^T zero past R and B. Returns (out (N, R)
    float64, count (N, B, R), misplaced): count[n, b, r] is the number of
    times V[n, b] W[b, r] was summed into out[n, r]; ``misplaced`` counts
    products of real elements summed anywhere else."""
    N, B = V2.shape
    R = W.shape[1]
    v, w, o = mma_step_map()
    Wt = _mma.wt_bf16(torch.as_tensor(W, dtype=torch.float32)).float() \
        .numpy().astype(np.float64)
    out = np.zeros((N, R))
    count = np.zeros((N, B, R), np.int64)
    misplaced = 0
    for r0 in range(0, R, _mma.RANKS):
        for c0 in range(0, B, p.slice_cols):
            L = min(p.slice_cols, B - c0)
            for row0 in range(0, N, MMA_ROWS):
                for s in range(0, L, MMA_STEP):
                    live = s + v[:, 1] // 8 * 8 < L
                    vrow = np.minimum(row0 + v[:, 0], N - 1)
                    col, wcol = c0 + s + v[:, 1], c0 + s + w[:, 1]
                    rank = r0 + w[:, 0]
                    orow, orank = row0 + o[:, 0], r0 + o[:, 1]
                    x = np.where(live, V2[vrow, np.minimum(col, B - 1)], 0.) \
                        * Wt[rank, wcol]
                    written = (orow < N) & (orank < R)
                    np.add.at(out, (orow[written], orank[written]), x[written])
                    real = live & written & (wcol < B) & (rank < R)
                    ok = real & (vrow == orow) & (col == wcol) & (rank == orank)
                    misplaced += int((real & ~ok).sum())
                    np.add.at(count, (orow[ok], col[ok], orank[ok]), 1)
    return out, count, misplaced


def reset_launch_counts() -> None:
    LAUNCHES["last_contract"] = 0


def _last_tile(N: int, B: int) -> int:
    for Tr in (512, 256, 128, 64, 32, 16, 8):
        if Tr * B * 4 <= (4 << 20) and N % Tr == 0:
            return Tr
    return 0


def last_contract_eligible(shape, dtype, r: int) -> bool:
    if dtype not in (torch.float32,) or r > 256:
        return False
    B = shape[-1]
    N = 1
    for s in shape[:-1]:
        N *= s
    if B < 128 or B > 65536 or N < 8:
        return False
    return _last_tile(N, B) > 0


def last_contract_plain(V, W):
    """Plain PyTorch version (one einsum over the (N, B) view of V); what
    the kernel is held to. bf16 V: V and W rounded to bf16, contracted in
    float32."""
    shape = tuple(V.shape)
    acc = torch.float32 if V.dtype == torch.bfloat16 else V.dtype
    out = torch.einsum("nb,br->nr", V.reshape(-1, shape[-1]).to(acc),
                       W.to(V.dtype).to(acc))
    return out.reshape(shape[:-1] + (W.shape[1],))


def plan_for(V, R: int) -> Plan:
    """:func:`plan` for a CUDA tensor V and rank R."""
    return plan(V.numel() // V.shape[-1], V.shape[-1], R,
                _build.sm_count(V.device.index), V.data_ptr() % 16,
                V.dtype == torch.bfloat16)


def _check(V, W):
    if V.ndim < 1 or V.numel() == 0:
        raise ValueError(f"empty V {tuple(V.shape)}")
    if W.ndim != 2 or W.shape[0] != V.shape[-1] or W.shape[1] <= 0:
        raise ValueError(f"W has shape {tuple(W.shape)}, expected "
                         f"({V.shape[-1]}, R)")
    if V.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"V is {V.dtype}; the kernel takes float32 or "
                        "bfloat16")
    if W.dtype != torch.float32:
        raise TypeError(f"W is {W.dtype}; the kernel takes float32")
    for name, t in (("V", V), ("W", W)):
        if t.device != V.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel needs "
                             f"every operand on V's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def last_contract(V, W):
    """V x_{order-1} W in one pass over V; axes: the leading modes, then
    rank (already the rank-last convention).

    CPU tensors go to the plain version; CUDA tensors launch the kernel on
    the current stream (contiguous f32 or bf16 V, f32 W) or raise."""
    if V.device.type == "cpu":
        return last_contract_plain(V, W)
    _check(V, W)
    shape = tuple(V.shape)
    N, B, R = math.prod(shape[:-1]), shape[-1], W.shape[1]
    p = plan_for(V, R)
    out = torch.empty((N, R), dtype=torch.float32, device=V.device)
    part = torch.empty((p.n_slices, N, R), dtype=torch.float32,
                       device=V.device) if p.n_slices > 1 else None
    part_ptr = 0 if part is None else part.data_ptr()
    stream = torch.cuda.current_stream(V.device).cuda_stream
    lib = _build.load()
    if p.path == "mma":
        Wt = _mma.wt_bf16(W)
        code = lib.pp_last_contract_mma(
            V.data_ptr(), Wt.data_ptr(), Wt.shape[1], part_ptr,
            out.data_ptr(), N, B, R, p.slice_cols, p.n_slices, p.blocks,
            p.smem, stream)
    else:
        bf16 = V.dtype == torch.bfloat16
        Wr = W.to(V.dtype).float() if bf16 else W
        code = lib.pp_last_contract(
            V.data_ptr(), int(bf16), Wr.data_ptr(), part_ptr,
            out.data_ptr(), N, B, R, p.slice_cols, p.n_slices, p.blocks,
            p.vec, p.smem, stream)
    _build.check(lib, code, "last_contract launch")
    LAUNCHES["last_contract"] += 1
    return out.reshape(shape[:-1] + (R,))
