"""The PP cache build's three chain roots of an order-4 tensor: the
route through the port's hand-written CUDA kernels and its plain PyTorch
version.

    O1[r, p, b2, m] = sum_b1 V[p, b1, b2, m] W1[b1, r]
    O2[r, p, b1, m] = sum_b2 V[p, b1, b2, m] W2[b2, r]
    O3[r, p, b1, b2] = sum_m V[p, b1, b2, m] W3[m, r]

Replaces ``pairwise_perturbation_tpu/ops/kernels/mttkrp_pallas.py``:
``triple_roots`` and its Pallas kernel ``_triple_kernel`` (K6), with
``triple_roots_eligible`` copied verbatim so that the port routes exactly
the calls the JAX package routes. Outputs are rank-major, the chain
convention of ``contract.build_pp_caches``.

On the H100 the three roots are three launches (:func:`composed`), not
one pass over V. O3 is the one root whose sum runs over the minor axis
m, so a kernel that cuts m into column tiles must keep O3's
R x B1 x B2 sums per tile (640 KB at the coil shape, more than an SM
holds) and sum them in a second pass; a one-read kernel built that way
reached 12% of its bound. Instead:

- O1 is ``mid_contract`` of mode 1 in its rank-outer layout: the (R, P,
  B2 M) output is O1 itself;
- O2 is ``mid_contract`` of mode 2 in its rank-outer layout: the (R, P
  B1, M) output is O2 itself;
- O3 is ``last_contract`` (K5) on V's (P B1 B2, M) view, whose (P, B1,
  B2, R) result is moved to rank-major (a copy of R P B1 B2 floats).

Each launch reads V once, coalesced, and sums in a fixed order: runs
repeat bit for bit.

bf16-stored V follows the JAX package's mixed-precision rule: the factors
are rounded to bf16, products and sums are float32, outputs are float32.
With bf16 V each launch takes its module's tensor-core path (``plan()``
names it) when V is 16-byte aligned and the launch's contiguous run (B2
M, M, M) is a multiple of 8, as at the coil shape.

:func:`triple_roots` launches the kernels for a CUDA tensor, or raises;
it takes the plain version (:func:`triple_roots_plain`) only for a tensor
on the CPU. Each call adds one to ``LAUNCHES["triple_roots"]``; its inner
launches also count in their own modules' counters (``mid_contract``'s
``rank_outer``, ``last_contract``'s ``last_contract``).
"""

from __future__ import annotations

from typing import Dict

import torch

from pairwise_perturbation_tpu_torch.ops.kernels import last_contract
from pairwise_perturbation_tpu_torch.ops.kernels import mid_contract

# Kernel launches, counted where the kernel is launched.
LAUNCHES: Dict[str, int] = {"triple_roots": 0}


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


def composed(V, W1, W2, W3):
    """(O1, O2, O3), rank-major and contiguous, from the first-level
    kernels' wrappers (module docstring); on CPU tensors their plain
    versions, which is how the tests reach the views and layouts."""
    O1 = mid_contract.mid_contract(V, W1, 1, layout="rank_outer")
    O2 = mid_contract.mid_contract(V, W2, 2, layout="rank_outer")
    O3 = last_contract.last_contract(V, W3)
    return O1.movedim(-1, 0), O2.movedim(-1, 0), O3.movedim(-1, 0).contiguous()


def triple_roots(V, W1, W2, W3):
    """(O1, O2, O3), rank-major: the chain roots contracting axes 1, 2 and
    3 of an order-4 V.

    CPU tensors go to the plain version; CUDA tensors launch the kernels
    on the current stream (contiguous f32 or bf16 V, f32 factors) or
    raise."""
    if V.device.type == "cpu":
        return triple_roots_plain(V, W1, W2, W3)
    _check(V, (W1, W2, W3))
    out = composed(V, W1, W2, W3)
    LAUNCHES["triple_roots"] += 1
    return out
