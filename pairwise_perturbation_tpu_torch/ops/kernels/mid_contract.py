"""First-level contraction of a non-minor mode: the hand-written CUDA
kernel and its plain PyTorch version.

    C[pre..., post..., r] = sum_b V[pre..., b, post...] W[b, r]

Replaces ``pairwise_perturbation_tpu/ops/kernels/mttkrp_pallas.py``:
``mid_contract`` with its Pallas kernels ``_mid_kernel_t`` (rank-minor
output, K4) and ``_mid_kernel`` (rank-major output, K4'), and
``mid_contract_eligible``, copied verbatim so that the port routes exactly
the calls the JAX package routes; also the benchmark-only Pallas kernels
that compute the same sum: ``_mid_kernel_zp`` (rank-outer output, launched
by ``scripts/bench_rankpos.py``, S2) and ``_mm_kernel`` of
``scripts/bench_midvariants.py`` (K4' swept over its lane tile, S5).

The kernel (``csrc/mid_contract.cu``) is bound by memory bandwidth on the
H100: it reads V once, coalesced, with the sums in registers; the
source's header says how. It takes any shape the wrapper's checks admit:
the TPU tiling conditions of the eligibility test only decide routing.

With V viewed as (P, B, M) around the contracted mode, ``layout`` picks
the physical output:

- ``"rank_minor"``: (P, M, R), the package's route (K4);
- ``"rank_major"``: (P, R, M), the PP chains' convention (K4');
- ``"rank_outer"``: (R, P, M), rank major-most (S2).

Each comes back as the rank-last tensor of the remaining modes; the two
rank-leading layouts as views (``movedim``, no copy), so a caller that
wants the physical tensor takes ``.movedim(-1, mode)`` (rank-major) or
``.movedim(-1, 0)`` (rank-outer). ``block_cols`` is the kernel's block
width in columns of M (threads): 256 on every package path; 128 and 512
are S5's sweep and are taken by the rank-major and rank-outer layouts
only.

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

LAYOUTS = ("rank_minor", "rank_major", "rank_outer")
BLOCK_COLS = (128, 256, 512)

# Kernel launches per output layout, counted where the kernel is launched.
LAUNCHES: Dict[str, int] = {k: 0 for k in LAYOUTS}

_SPECS = {"rank_minor": "pbm,br->pmr", "rank_major": "pbm,br->prm",
          "rank_outer": "pbm,br->rpm"}


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


def _out(flat, shape, mode: int, layout: str):
    """The physical result of ``layout`` as the rank-last tensor of the
    remaining modes; the rank-leading layouts come back as views."""
    pre, post = tuple(shape[:mode]), tuple(shape[mode + 1:])
    if layout == "rank_minor":
        return flat.reshape(pre + post + (flat.shape[-1],))
    if layout == "rank_major":
        return torch.movedim(flat.reshape(pre + (flat.shape[1],) + post),
                             mode, -1)
    return torch.movedim(flat.reshape((flat.shape[0],) + pre + post), 0, -1)


def _check_layout(layout: str, block_cols: int):
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}; expected one of {LAYOUTS}")
    if block_cols not in BLOCK_COLS:
        raise ValueError(f"block_cols {block_cols}; expected one of "
                         f"{BLOCK_COLS}")
    if layout == "rank_minor" and block_cols != 256:
        raise ValueError("the rank-minor layout runs at block_cols 256 only")


def mid_contract_plain(V, W, mode: int, layout: str = "rank_minor"):
    """Plain PyTorch version (one einsum, its result laid out as
    ``layout``); what the kernel is held to. bf16 V: V and W rounded to
    bf16, contracted in float32."""
    _check_layout(layout, 256)
    shape = tuple(V.shape)
    P, B = math.prod(shape[:mode]), shape[mode]
    acc = torch.float32 if V.dtype == torch.bfloat16 else V.dtype
    V3 = V.reshape(P, B, -1).to(acc)
    Wc = W.to(V.dtype).to(acc)
    flat = torch.einsum(_SPECS[layout], V3, Wc).contiguous()
    return _out(flat, shape, mode, layout)


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


def mid_contract(V, W, mode: int, layout: str = "rank_minor",
                 block_cols: int = 256):
    """V x_mode W in one pass over V; axes: the other modes ascending, then
    rank (the ``contract.contract_mode_kr`` convention), whatever the
    physical ``layout`` (see the module docstring).

    CPU tensors go to the plain version (``block_cols`` is then only
    checked); CUDA tensors launch the kernel on the current stream
    (contiguous f32 or bf16 V, f32 W) or raise."""
    _check_layout(layout, block_cols)
    if V.device.type == "cpu":
        return mid_contract_plain(V, W, mode, layout)
    _check(V, W, mode)
    shape = tuple(V.shape)
    P, B = math.prod(shape[:mode]), shape[mode]
    M, R = V.numel() // (P * B), W.shape[1]
    Wr = W.to(V.dtype).float() if V.dtype == torch.bfloat16 else W
    phys = {"rank_minor": (P, M, R), "rank_major": (P, R, M),
            "rank_outer": (R, P, M)}[layout]
    out = torch.empty(phys, dtype=torch.float32, device=V.device)
    lib = _build.load()
    code = lib.pp_mid_contract(
        V.data_ptr(), int(V.dtype == torch.bfloat16), Wr.data_ptr(),
        out.data_ptr(), P, B, M, R, LAYOUTS.index(layout), block_cols,
        torch.cuda.current_stream(V.device).cuda_stream)
    _build.check(lib, code, "mid_contract launch")
    LAUNCHES[layout] += 1
    return _out(out, shape, mode, layout)
