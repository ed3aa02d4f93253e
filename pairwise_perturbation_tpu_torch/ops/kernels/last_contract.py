"""First-level contraction of the minor (last) mode: the hand-written CUDA
kernel and its plain PyTorch version.

    out[lead..., r] = sum_b V[lead..., b] W[b, r]

Replaces ``pairwise_perturbation_tpu/ops/kernels/mttkrp_pallas.py``:
``last_contract`` with its Pallas kernel ``_last_kernel`` (K5), and
``last_contract_eligible`` with ``_last_tile``, copied verbatim so that
the port's routing rule reads like the JAX one. As in the JAX package,
nothing in the package routes to it (the minor mode stays on the einsum
in ``contract.first_contraction``); its entry point is
``scripts/bench_firstpair.py``.

The kernel (``csrc/last_contract.cu``) views V as the (N, B) matrix
around its last mode and computes the tall-skinny product with W in one
pass over V; the source's header says what bounds it and how its design
answers. It takes any N and B: the TPU tile rule only decides
eligibility. Its yardstick is the one library call that computes the
same function, ``V2 @ W`` (cuBLAS SGEMM with TF32 off), which the port
never calls.

:func:`plan` chooses, from the shapes alone, how B is split into slices
of W that fit in shared memory with two blocks on an SM, and how many
blocks walk the row tiles of each slice. With more than one slice the
wrapper allocates the slices' (n_slices, N, R) partials, which a second
launch sums in slice order.

:func:`last_contract` launches the kernel for a CUDA tensor, or raises; it
takes the plain version (:func:`last_contract_plain`) only for a tensor
on the CPU. Each call (both launches) adds one to
``LAUNCHES["last_contract"]``.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple

import torch

from pairwise_perturbation_tpu_torch.ops.kernels import _build

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


class Plan(NamedTuple):
    """Launch 1's shape (csrc/last_contract.cu)."""
    vec: int          # columns per load: 4 (16 bytes) or 1
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


@functools.lru_cache(maxsize=256)
def plan(N: int, B: int, R: int, n_sm: int, vec: bool) -> Plan:
    """Slices, tiles and grid of launch 1 for an (N, B) @ (B, R) product
    on ``n_sm`` SMs; ``vec`` asks for 16-byte loads (B % 4 == 0 and V
    16-byte aligned). B is cut into the fewest equal slices whose staged
    W fits in SMEM_BUDGET, so two blocks share an SM; the
    BLOCKS_PER_SM * n_sm blocks the card holds at once are shared out
    over slices and rank chunks, and each block takes an equal run of row
    tiles (8 warps x rows rows each)."""
    vw = 4 if vec else 1
    rc = rank_chunk(R)
    rows = rows_per_warp(rc)
    group_bytes = 4 * group_stride(rc, vw)
    groups = -(-B // vw)
    n_slices = -(-groups // (SMEM_BUDGET // group_bytes))
    slice_groups = -(-groups // n_slices)
    slice_cols = slice_groups * vw
    n_slices = -(-B // slice_cols)
    tiles = -(-N // (WARPS * rows))
    share = max(1, BLOCKS_PER_SM * n_sm // (n_slices * -(-R // rc)))
    per_block = -(-tiles // share)
    return Plan(vw, rc, rows, slice_cols, n_slices, -(-tiles // per_block),
                slice_groups * group_bytes)


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


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def last_contract_plain(V, W):
    """Plain PyTorch version (one einsum over the (N, B) view of V); what
    the kernel is held to."""
    shape = tuple(V.shape)
    out = torch.einsum("nb,br->nr", V.reshape(-1, shape[-1]), W)
    return out.reshape(shape[:-1] + (W.shape[1],))


def _check(V, W):
    if V.ndim < 1 or V.numel() == 0:
        raise ValueError(f"empty V {tuple(V.shape)}")
    if W.ndim != 2 or W.shape[0] != V.shape[-1] or W.shape[1] <= 0:
        raise ValueError(f"W has shape {tuple(W.shape)}, expected "
                         f"({V.shape[-1]}, R)")
    for name, t in (("V", V), ("W", W)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
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
    the current stream (contiguous f32 V and W) or raise."""
    if V.device.type == "cpu":
        return last_contract_plain(V, W)
    _check(V, W)
    shape = tuple(V.shape)
    N, B, R = math.prod(shape[:-1]), shape[-1], W.shape[1]
    p = plan(N, B, R, _sm_count(V.device.index),
             B % 4 == 0 and V.data_ptr() % 16 == 0)
    out = torch.empty((N, R), dtype=torch.float32, device=V.device)
    part = torch.empty((p.n_slices, N, R), dtype=torch.float32,
                       device=V.device) if p.n_slices > 1 else None
    lib = _build.load()
    code = lib.pp_last_contract(
        V.data_ptr(), W.data_ptr(), 0 if part is None else part.data_ptr(),
        out.data_ptr(), N, B, R, p.slice_cols, p.n_slices, p.blocks, p.vec,
        p.smem, torch.cuda.current_stream(V.device).cuda_stream)
    _build.check(lib, code, "last_contract launch")
    LAUNCHES["last_contract"] += 1
    return out.reshape(shape[:-1] + (R,))
