"""First-level contraction of a non-minor mode: the hand-written CUDA
kernel and its plain PyTorch version.

    C[pre..., post..., r] = sum_b V[pre..., b, post...] W[b, r]

Replaces ``pairwise_perturbation_tpu/ops/kernels/mttkrp_pallas.py``:
``mid_contract`` with its Pallas kernels ``_mid_kernel_t`` (rank-minor
output, K4) and ``_mid_kernel`` (rank-major output, K4'), and
``mid_contract_eligible``, copied verbatim so that the port routes exactly
the calls the JAX package routes. The kernel (``csrc/mid_contract.cu``) is
bound by memory bandwidth on the H100: it reads V once, coalesced, with
the sums in registers; the source's header says how. It takes any shape
the wrapper's checks admit: the TPU tiling conditions of the eligibility
test only decide routing.

bf16-stored V follows the JAX package's mixed-precision rule: W is
rounded to bf16, products and sums are float32, the output is float32.

:func:`mid_contract` launches the kernel for a CUDA tensor, or raises; it
takes the plain version (:func:`mid_contract_plain`) only for a tensor on
the CPU. Each launch adds one to ``LAUNCHES[layout]``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from pairwise_perturbation_tpu_torch.ops.kernels import _build

# Kernel launches per output layout, counted where the kernel is launched.
LAUNCHES: Dict[str, int] = {"rank_minor": 0, "rank_major": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _mid_tile(B: int, M: int) -> int:
    """Lane tile of the merged trailing dim, or 0 if no good tiling exists
    (the JAX package's TPU tiling rule, copied so routing agrees)."""
    if M < (1 << 15):
        return 0
    for L in (2048, 1024, 512, 256, 128):
        if B * L * 4 <= (2 << 20) and M % L == 0:
            return L
    return 0


def mid_contract_eligible(shape, mode: int, dtype, r: int) -> bool:
    """Whether :func:`mid_contract` applies to mode ``mode`` of ``shape``."""
    if dtype not in (torch.float32, torch.bfloat16) \
            or not (0 <= mode < len(shape) - 1):
        return False
    if r > 256:
        return False
    B = shape[mode]
    M = 1
    for s in shape[mode + 1:]:
        M *= s
    if B < 8 or B > 4096 or B % 8 != 0:
        return False
    return M >= 128 and _mid_tile(B, M) > 0


def _out(flat, shape, mode: int, rank_minor: bool):
    """The (P, M, R) or (P, R, M) result as the rank-last tensor of the
    remaining modes; rank-major comes back as a view."""
    R = flat.shape[-1] if rank_minor else flat.shape[1]
    rest = tuple(shape[:mode]) + tuple(shape[mode + 1:])
    if rank_minor:
        return flat.reshape(rest + (R,))
    return torch.movedim(
        flat.reshape(tuple(shape[:mode]) + (R,) + tuple(shape[mode + 1:])),
        mode, -1)


def mid_contract_plain(V, W, mode: int, rank_minor: bool = True):
    """Plain PyTorch version (one einsum); what the kernel is held to.
    bf16 V: V and W rounded to bf16, contracted in float32."""
    shape = tuple(V.shape)
    P, B = math.prod(shape[:mode]), shape[mode]
    acc = torch.float32 if V.dtype == torch.bfloat16 else V.dtype
    V3 = V.reshape(P, B, -1).to(acc)
    Wc = W.to(V.dtype).to(acc)
    spec = "pbm,br->pmr" if rank_minor else "pbm,br->prm"
    return _out(torch.einsum(spec, V3, Wc), shape, mode, rank_minor)


def _check(V, W, mode: int):
    if not 0 <= mode < V.ndim:
        raise ValueError(f"mode {mode} out of range for V {tuple(V.shape)}")
    if W.ndim != 2 or W.shape[0] != V.shape[mode] or W.shape[1] <= 0:
        raise ValueError(f"W has shape {tuple(W.shape)}, expected "
                         f"({V.shape[mode]}, R)")
    if V.numel() == 0:
        raise ValueError(f"empty V {tuple(V.shape)}")
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


def mid_contract(V, W, mode: int, rank_minor: bool = True):
    """V x_mode W in one pass over V; axes: the other modes ascending, then
    rank (the ``contract.contract_mode_kr`` convention). ``rank_minor``
    picks the physical layout: (P, M, R), or (P, R, M) returned as a view.

    CPU tensors go to the plain version; CUDA tensors launch the kernel
    on the current stream (contiguous f32 or bf16 V, f32 W) or raise."""
    if V.device.type == "cpu":
        return mid_contract_plain(V, W, mode, rank_minor)
    _check(V, W, mode)
    shape = tuple(V.shape)
    P, B = math.prod(shape[:mode]), shape[mode]
    M, R = V.numel() // (P * B), W.shape[1]
    Wr = W.to(V.dtype).float() if V.dtype == torch.bfloat16 else W
    out = torch.empty((P, M, R) if rank_minor else (P, R, M),
                      dtype=torch.float32, device=V.device)
    lib = _build.load()
    code = lib.pp_mid_contract(
        V.data_ptr(), int(V.dtype == torch.bfloat16), Wr.data_ptr(),
        out.data_ptr(), P, B, M, R, int(rank_minor),
        torch.cuda.current_stream(V.device).cuda_stream)
    _build.check(lib, code, "mid_contract launch")
    LAUNCHES["rank_minor" if rank_minor else "rank_major"] += 1
    return _out(out, shape, mode, rank_minor)
