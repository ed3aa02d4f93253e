"""Khatri-Rao chain step on a rank-carrying intermediate: the hand-written
CUDA kernel and its plain PyTorch version.

    rank-minor  T (..., C, ..., R)  out[p, q, r] = sum_c T[p, c, q, r] W[c, r]
    rank-major  T (R, ..., C, ...)  out[r, p, q] = sum_c T[r, p, c, q] W[c, r]

with T viewed as (P, C, Q, R) or (R, P, C, Q) around the contracted axis
(P the axes before it, Q those after it, merged for free in row-major
order); the result keeps T's layout without the contracted axis. This is
the step ``ops/contract.contract_mode_kr`` computes with ``has_rank``, and
``contract._contract_mode_kr_rm`` on the PP cache chains.

Replaces no Pallas kernel: the JAX package writes the step as an einsum,
which XLA folds into its dot on the TPU. Eager ``torch.einsum`` on the H100
copies a rank-minor T (and a rank-major T contracted over a middle axis)
into (rank, kept, contracted) order before its batched GEMV, so it reads T
three times where the kernel (``csrc/chain_step.cu``, whose header says
how) reads it once. On a card, ops/contract.py sends every such step here
that :func:`route_admits` admits.

Both layouts are T as (rows, C, N) with N contiguous columns, a thread a
run of ``vec`` columns. :func:`plan` chooses, from the shapes, the SM
count and T's alignment alone, ``vec`` (4 with 16-byte loads where
N % 4 == 0 and T is 16-byte aligned, else 1) and into how many parts C is
cut so that the grid fills the card and a part's rows of W fit the
block's shared memory; parts are summed in order by a second launch.

:func:`chain_step` launches the kernel for a CUDA tensor, or raises; it
takes the plain version (:func:`chain_step_plain`) only for a tensor on the
CPU. Each call adds one to ``LAUNCHES["chain_step"]``.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Tuple

import torch

from pairwise_perturbation_tpu_torch.ops.kernels import _build

LAYOUTS = ("rank_minor", "rank_major")

# Kernel calls, counted where the kernel is launched.
LAUNCHES: Dict[str, int] = {"chain_step": 0}


def reset_launch_counts() -> None:
    LAUNCHES["chain_step"] = 0


# csrc/chain_step.cu: threads of a block (kThreads) and a block's dynamic
# shared memory (kMaxSmem); the plan's blocks meant to share an SM and the
# fewest rows of C a part keeps.
THREADS = 256
SMEM = 48 * 1024
BLOCKS_PER_SM = 4
MIN_PART = 8
# the SM count assumed for a tensor off the card (the H100's)
DEFAULT_SMS = 132


class Plan(NamedTuple):
    """A launch of csrc/chain_step.cu."""
    vec: int        # columns a thread: 4 or 1
    parts: int      # parts of C (grid y); > 1: partials summed in a 2nd launch
    part_len: int   # rows of C a part (the last may be shorter)
    blocks: int     # grid x
    smem: int       # dynamic shared memory of a block, bytes


@functools.lru_cache(maxsize=1024)
def view(shape, pos: int, layout: str = "rank_minor"):
    """(rows, C, N, P) of T's shape contracted over mode axis ``pos``: T as
    (rows, C, N) and P, the rows of one rank (rank-major) or all of them."""
    _check_layout(layout)
    if layout == "rank_minor":
        P = math.prod(shape[:pos])
        return P, shape[pos], math.prod(shape[pos + 1:]), P
    P = math.prod(shape[1:pos + 1])
    return shape[0] * P, shape[pos + 1], math.prod(shape[pos + 2:]), P


@functools.lru_cache(maxsize=256)
def plan(rows: int, C: int, N: int, R: int, n_sm: int = DEFAULT_SMS,
         aligned: bool = True) -> Plan:
    """The launch for T (rows, C, N) and W (C, R) on ``n_sm`` SMs, T at a
    16-byte boundary when ``aligned``. C is cut into parts when the rows
    give fewer than ``BLOCKS_PER_SM`` blocks an SM (each part at least
    ``MIN_PART`` rows), and always so that a part's rows of W fit
    ``SMEM``."""
    vec = 4 if N % 4 == 0 and aligned else 1
    blocks = -(-rows * (N // vec) // THREADS)
    parts = max(1, min(-(-BLOCKS_PER_SM * n_sm // blocks), C // MIN_PART))
    cap = SMEM // 4 // R                # rows of W a part may stage
    if cap > 0:
        parts = max(parts, -(-C // cap))
    part_len = -(-C // parts)
    parts = -(-C // part_len)
    return Plan(vec, parts, part_len, blocks, 4 * part_len * R)


def plan_for(T, R: int, pos: int, layout: str = "rank_minor") -> Plan:
    """:func:`plan` for a tensor T contracted over mode axis ``pos``."""
    rows, C, N, _ = view(T.shape, pos, layout)
    n_sm = _build.sm_count(T.device.index) if T.is_cuda else DEFAULT_SMS
    return plan(rows, C, N, R, n_sm, T.data_ptr() % 16 == 0)


def route_admits(T, R: int, pos: int, layout: str = "rank_minor") -> bool:
    """Whether the card's chain-step route (ops/contract.py) takes T
    contracted over mode axis ``pos`` at rank R: an axis of T's modes, a
    non-empty T, and a launch the kernel's checks admit (a grid of at most
    2^31 - 1 blocks by 65535 parts, a part's W within ``SMEM``). T's type,
    device and contiguity are the caller's to check."""
    return _admitted(T, R, pos, layout) is not None


def _admitted(T, R: int, pos: int, layout: str):
    """:func:`route_admits`' decision: the plan, or None."""
    n_sm = _build.sm_count(T.device.index) if T.is_cuda else DEFAULT_SMS
    return _admitted_shape(T.shape, R, pos, layout, n_sm,
                           T.data_ptr() % 16 == 0)


@functools.lru_cache(maxsize=1024)
def _admitted_shape(shape, R: int, pos: int, layout: str, n_sm: int,
                    aligned: bool):
    """:func:`_admitted` for T's shape, once a shape (the route asks at
    every step of every chain)."""
    _check_layout(layout)
    if not 0 <= pos < len(shape) - 1 or 0 in shape or R <= 0 or \
            shape[-1 if layout == "rank_minor" else 0] != R:
        return None
    rows, C, N, _ = view(shape, pos, layout)
    p = plan(rows, C, N, R, n_sm, aligned)
    ok = p.blocks <= 0x7FFFFFFF and p.parts <= 65535 and p.smem <= SMEM
    return p if ok else None


def _check_layout(layout: str):
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}; expected one of {LAYOUTS}")


def _out_shape(shape, pos: int, layout: str) -> Tuple[int, ...]:
    axis = pos if layout == "rank_minor" else pos + 1
    return tuple(shape[:axis]) + tuple(shape[axis + 1:])


def chain_step_plain(T, W, pos: int, layout: str = "rank_minor"):
    """Plain PyTorch version, summed over c in order in T's dtype; what the
    kernel is held to."""
    rows, C, N, P = view(T.shape, pos, layout)
    T3 = T.reshape(rows, C, N)
    if layout == "rank_minor":     # column n's rank n % R
        w = W.repeat(1, N // W.shape[1])[None]
    else:                          # row i's rank i // P
        w = W.T.repeat_interleave(P, 0)[:, :, None]
    out = torch.zeros((rows, N), dtype=T.dtype, device=T.device)
    for c in range(C):
        out += T3[:, c] * w[:, c]
    return out.reshape(_out_shape(T.shape, pos, layout))


def _refuse(T, W, pos: int, layout: str):
    """Raise what the kernel does not take: float32 contiguous T and W on
    T's CUDA device, W (C, R) for T's contracted axis and rank."""
    R = T.shape[-1 if layout == "rank_minor" else 0] if T.ndim else 0
    if not 0 <= pos < T.ndim - 1:
        raise ValueError(f"axis {pos} is not a mode axis of T "
                         f"{tuple(T.shape)}")
    C = T.shape[pos if layout == "rank_minor" else pos + 1]
    if W.ndim != 2 or tuple(W.shape) != (C, R):
        raise ValueError(f"W has shape {tuple(W.shape)}, expected ({C}, {R})")
    for name, t in (("T", T), ("W", W)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
        if t.device != T.device or t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}; the kernel needs "
                             "every operand on T's CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    raise ValueError(f"T {tuple(T.shape)} is empty or its launch is not "
                     "admitted (route_admits)")


def chain_step(T, W, pos: int, layout: str = "rank_minor"):
    """T contracted over mode axis ``pos`` with W (C, R), Khatri-Rao style,
    in T's layout (rank last for ``"rank_minor"``, first for
    ``"rank_major"``), in one pass over T.

    CPU tensors go to the plain version; CUDA tensors launch the kernel on
    the current stream (contiguous float32 T and W) or raise."""
    _check_layout(layout)
    if T.is_cpu:
        return chain_step_plain(T, W, pos, layout)
    R = W.shape[1] if W.ndim == 2 else 0
    p = _admitted(T, R, pos, layout) if (
        T.is_cuda and T.dtype is torch.float32 and
        W.dtype is torch.float32 and W.device == T.device and
        T.is_contiguous() and W.is_contiguous()) else None
    if p is None or \
            W.shape[0] != T.shape[pos if layout == "rank_minor" else pos + 1]:
        _refuse(T, W, pos, layout)
    rows, C, N, P = view(T.shape, pos, layout)
    out = T.new_empty(_out_shape(T.shape, pos, layout))
    partial = T.new_empty((p.parts, rows * N)) if p.parts > 1 else None
    lib = _build.load()
    code = lib.pp_chain_step(
        T.data_ptr(), W.data_ptr(),
        None if partial is None else partial.data_ptr(), out.data_ptr(),
        rows, C, N, P, R, int(layout == "rank_major"), p.vec, p.parts,
        p.part_len, _build.current_stream(T.device))
    if code:
        _build.check(lib, code, "chain_step launch")
    LAUNCHES["chain_step"] += 1
    return out
