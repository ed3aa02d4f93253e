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

:func:`last_contract` launches the kernel for a CUDA tensor, or raises; it
takes the plain version (:func:`last_contract_plain`) only for a tensor
on the CPU. Each launch adds one to ``LAUNCHES["last_contract"]``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from pairwise_perturbation_tpu_torch.ops.kernels import _build

# Kernel launches, counted where the kernel is launched.
LAUNCHES: Dict[str, int] = {"last_contract": 0}


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
    out = torch.empty((N, R), dtype=torch.float32, device=V.device)
    lib = _build.load()
    code = lib.pp_last_contract(
        V.data_ptr(), W.data_ptr(), out.data_ptr(), N, B, R,
        torch.cuda.current_stream(V.device).cuda_stream)
    _build.check(lib, code, "last_contract launch")
    LAUNCHES["last_contract"] += 1
    return out.reshape(shape[:-1] + (R,))
