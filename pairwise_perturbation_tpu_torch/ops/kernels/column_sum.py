"""Column sums of V viewed as (P, B, M): the hand-written CUDA kernel and
its plain PyTorch version.

    out[p, 0, m] = sum_b V3[p, b, m]

Replaces ``scripts/bench_midvariants.py::_copy_kernel`` (S4), a
read-bandwidth probe that the JAX package's benchmark launches over the
two views of the coil-100 tensor that the first-level contractions read
((3, 128, 921600) and (384, 128, 7200)). It reads every byte of V once
and does one add per element, so its time is the best the
``mid_contract`` kernels could reach over the same bytes. The kernel
(``csrc/column_sum.cu``) writes exactly (P, 1, M); the JAX script pads M
to whole lane tiles. Its yardstick is the one library call that computes
the same function, ``V3.sum(1, keepdim=True)``, which the port never
calls.

:func:`column_sum` launches the kernel for a CUDA tensor, or raises; it
takes the plain version (:func:`column_sum_plain`) only for a tensor on
the CPU. Each launch adds one to ``LAUNCHES["column_sum"]``.
"""

from __future__ import annotations

from typing import Dict

import torch

from pairwise_perturbation_tpu_torch.ops.kernels import _build

# Kernel launches, counted where the kernel is launched.
LAUNCHES: Dict[str, int] = {"column_sum": 0}


def reset_launch_counts() -> None:
    LAUNCHES["column_sum"] = 0


def column_sum_plain(V3):
    """Plain PyTorch version, summed in order over b in V's dtype; what the
    kernel is held to."""
    out = torch.zeros_like(V3[:, :1])
    for b in range(V3.shape[1]):
        out += V3[:, b:b + 1]
    return out


def _check(V3):
    if V3.ndim != 3 or V3.numel() == 0:
        raise ValueError(f"non-empty (P, B, M) V expected, got "
                         f"{tuple(V3.shape)}")
    if V3.dtype != torch.float32:
        raise TypeError(f"V is {V3.dtype}; the kernel takes float32")
    if V3.device.type != "cuda":
        raise ValueError(f"V is on {V3.device}; the kernel needs a CUDA "
                         "tensor")
    if not V3.is_contiguous():
        raise ValueError("V is not contiguous")


def column_sum(V3):
    """(P, 1, M): the sums over b of V3 (P, B, M), in V's dtype.

    CPU tensors go to the plain version; CUDA tensors launch the kernel on
    the current stream (contiguous f32) or raise."""
    if V3.device.type == "cpu":
        return column_sum_plain(V3)
    _check(V3)
    P, B, M = V3.shape
    out = torch.empty((P, 1, M), dtype=torch.float32, device=V3.device)
    lib = _build.load()
    code = lib.pp_column_sum(V3.data_ptr(), out.data_ptr(), P, B, M,
                             torch.cuda.current_stream(V3.device).cuda_stream)
    _build.check(lib, code, "column_sum launch")
    LAUNCHES["column_sum"] += 1
    return out
