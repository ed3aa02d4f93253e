"""The PP cache build's three chain roots of an order-4 tensor in one pass
over V: the hand-written CUDA kernel and its plain PyTorch version.

    O1[r, p, b2, m] = sum_b1 V[p, b1, b2, m] W1[b1, r]
    O2[r, p, b1, m] = sum_b2 V[p, b1, b2, m] W2[b2, r]
    O3[r, p, b1, b2] = sum_m V[p, b1, b2, m] W3[m, r]

Replaces ``pairwise_perturbation_tpu/ops/kernels/mttkrp_pallas.py``:
``triple_roots`` and its Pallas kernel ``_triple_kernel`` (K6), with
``triple_roots_eligible`` copied verbatim so that the port routes exactly
the calls the JAX package routes. The kernel (``csrc/triple_roots.cu``)
reads V once, where the einsum chain reads it three times; at R = 10 its
3R FMAs per element put it near the H100's FP32 balance, so both V's bytes
and the FMA count bound it. O3 sums over every column tile, so the blocks
write per-tile partials to scratch that a second launch sums in order (no
atomics). Outputs are rank-major, the chain convention of
``contract.build_pp_caches``.

bf16-stored V follows the JAX package's mixed-precision rule: the factors
are rounded to bf16, products and sums are float32, outputs are float32.

:func:`triple_roots` launches the kernel for a CUDA tensor, or raises; it
takes the plain version (:func:`triple_roots_plain`) only for a tensor on
the CPU. Each launch (both passes) adds one to ``LAUNCHES["triple_roots"]``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from pairwise_perturbation_tpu_torch.ops.kernels import _build

# Kernel launches, counted where the kernel is launched.
LAUNCHES: Dict[str, int] = {"triple_roots": 0}

# The kernel's block (csrc/triple_roots.cu kThreads) and the shared memory
# one block may use on Hopper (227 KB).
_THREADS = 512
_SMEM_LIMIT = 232448


def reset_launch_counts() -> None:
    LAUNCHES["triple_roots"] = 0


def _triple_tile(B1: int, B2: int, M: int, itemsize: int = 4) -> int:
    """The JAX package's TPU lane tile, copied so routing agrees."""
    for L in (1024, 512, 256, 128):
        if B1 * B2 * L * itemsize <= (16 << 20) and M >= L:
            return L
    return 0


def triple_roots_eligible(shape, dtype, r: int) -> bool:
    """Order-4, roots on axes {1,2,3}, mid axes tile-friendly, long minor
    axis. The caller must separately confirm the chain priority roots at
    axes {1,2,3} (axis 0 is the smallest mode)."""
    if len(shape) != 4 or dtype not in (torch.float32, torch.bfloat16):
        return False
    if r > 128:
        return False
    P, B1, B2, M = shape
    if B1 % 8 or B2 % 8 or B1 < 8 or B2 < 8 or B1 > 512 or B2 > 512:
        return False
    if M < 1024 or P > 64:
        return False
    return _triple_tile(B1, B2, M) > 0


def plan(B2: int, R: int) -> Tuple[int, int, int]:
    """(ranks per pass RC, columns per block L, shared-memory bytes) of the
    kernel: RC is R rounded up to even, at most 16; L the widest power of
    two <= 32 that fits. The one place the bytes of the shared-memory
    layout of csrc/triple_roots.cu are worked out; the launch takes all
    three."""
    rc = min(16, R + R % 2)
    rs = rc if rc % 4 == 2 else rc + 2
    for L in (32, 16, 8, 4, 2, 1):
        floats = (B2 * L * rs + B2 * rc + L * rc
                  + max(B2 * (L + 1), _THREADS * rs))
        if 4 * floats <= _SMEM_LIMIT:
            return rc, L, 4 * floats
    raise ValueError(f"B2 = {B2}: one column of the O1 accumulator does not "
                     "fit in shared memory")


def triple_roots_plain(V, W1, W2, W3):
    """Plain PyTorch version (three einsums); what the kernel is held to.
    bf16 V: V and the factors rounded to bf16, contracted in float32."""
    acc = torch.float32 if V.dtype == torch.bfloat16 else V.dtype
    Vf = V.to(acc)
    W1, W2, W3 = (W.to(V.dtype).to(acc) for W in (W1, W2, W3))
    return (torch.einsum("pabm,ar->rpbm", Vf, W1),
            torch.einsum("pabm,br->rpam", Vf, W2),
            torch.einsum("pabm,mr->rpab", Vf, W3))


def _check(V, Ws):
    if V.ndim != 4 or V.numel() == 0:
        raise ValueError(f"non-empty order-4 V expected, got {tuple(V.shape)}")
    R = Ws[0].shape[1] if Ws[0].ndim == 2 else -1
    for k, W in enumerate(Ws, start=1):
        if W.ndim != 2 or tuple(W.shape) != (V.shape[k], R) or R <= 0:
            raise ValueError(f"W{k} has shape {tuple(W.shape)}, expected "
                             f"({V.shape[k]}, R)")
    if V.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"V is {V.dtype}; the kernel takes float32 or "
                        "bfloat16")
    for k, W in enumerate(Ws, start=1):
        if W.dtype != torch.float32:
            raise TypeError(f"W{k} is {W.dtype}; the kernel takes float32")
    for name, t in [("V", V)] + [(f"W{k}", W) for k, W in enumerate(Ws, 1)]:
        if t.device != V.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel needs "
                             f"every operand on V's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return R


def triple_roots(V, W1, W2, W3):
    """(O1, O2, O3), rank-major: the chain roots contracting axes 1, 2 and
    3 of an order-4 V in one pass over V.

    CPU tensors go to the plain version; CUDA tensors launch the kernel
    on the current stream (contiguous f32 or bf16 V, f32 factors) or
    raise."""
    if V.device.type == "cpu":
        return triple_roots_plain(V, W1, W2, W3)
    R = _check(V, (W1, W2, W3))
    P, B1, B2, M = V.shape
    rc, L, smem = plan(B2, R)
    bf16 = V.dtype == torch.bfloat16
    W1, W2, W3 = (W.to(V.dtype).float() if bf16 else W for W in (W1, W2, W3))

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=V.device)

    O1, O2, O3 = empty(R, P, B2, M), empty(R, P, B1, M), empty(R, P, B1, B2)
    part3 = empty(P, math.ceil(M / L), R, B1, B2)
    lib = _build.load()
    code = lib.pp_triple_roots(
        V.data_ptr(), int(bf16), W1.data_ptr(), W2.data_ptr(), W3.data_ptr(),
        O1.data_ptr(), O2.data_ptr(), O3.data_ptr(), part3.data_ptr(),
        P, B1, B2, M, R, rc, L, smem,
        torch.cuda.current_stream(V.device).cuda_stream)
    _build.check(lib, code, "triple_roots launch")
    LAUNCHES["triple_roots"] += 1
    return O1, O2, O3
