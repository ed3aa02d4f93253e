"""Global numeric configuration for the port.

Counterpart of ``pairwise_perturbation_tpu/config.py``. The reference runs
f32 matmuls at ``Precision.HIGHEST``; on the H100 the equivalent is true
FP32 with every TF32 path switched off, which :func:`apply_fp32_pins`
sets. Tests run on the CPU in float64 to check the algebra against the
JAX package.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import torch


@dataclass
class NumericConfig:
    # Compute dtype for tensors/factors.
    dtype: torch.dtype = torch.float32
    # Relative eigenvalue cutoff for pseudo-inverse solves, floored at the
    # dtype's eigenvalue noise level (R * eps) in ops/solve.py.
    rcond: float = 1e-12
    # Iterative-refinement passes for f32 R x R solves (f64 skips).
    solve_refine: int = 2
    # Route order-3 f32 MTTKRPs on CUDA tensors to the hand-written kernel
    # (ops/kernels/mttkrp3.py); the counterpart of ``use_pallas``.
    use_kernels: bool = True
    # Route single-mode, non-minor first-level contractions
    # (contract.first_contraction) to the mid_contract kernel
    # (ops/kernels/mid_contract.py); the counterpart of
    # ``use_pallas_first``, off by default as there.
    use_kernels_first: bool = False
    # Compute the PP cache build's three chain roots of an eligible order-4
    # V in one read (ops/kernels/triple_roots.py); the counterpart of
    # ``use_pallas_triple``, off by default as there.
    use_kernels_triple: bool = False


_cfg = NumericConfig()


def get() -> NumericConfig:
    return _cfg


@contextmanager
def override(**kwargs):
    """Context manager temporarily overriding config fields."""
    old = {k: getattr(_cfg, k) for k in kwargs}
    try:
        for k, v in kwargs.items():
            setattr(_cfg, k, v)
        yield _cfg
    finally:
        for k, v in old.items():
            setattr(_cfg, k, v)


def default_dtype():
    return _cfg.dtype


def apply_fp32_pins() -> None:
    """Pin float32 matmuls and convolutions to full FP32 (no TF32).

    The JAX package runs f32 at ``Precision.HIGHEST`` (about f32
    accuracy); TF32 keeps about three decimal digits and would let the
    R x R solves and the PP corrections drift on the card while the CPU
    tests still pass."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
