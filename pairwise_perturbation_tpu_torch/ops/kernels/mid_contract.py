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

:func:`plan` chooses, from the shapes, V's type and its alignment alone,
the path and its launch: ``"mma"`` (bf16 V, M % 8 == 0, V 16-byte
aligned) runs the products on the tensor cores (``_mma``), W^T as the A
operand and 64 columns of V a warp as B; ``"fma"`` (float32 V, and bf16 V
off 16-byte alignment or with a ragged M) runs them as FP32 FMAs. Both
are hand written; a shape takes one of them, and a failed launch raises.
:func:`mma_tile_map` is the mma path's fragment mapping and
:func:`emulate_mma` walks it over a whole launch in numpy, so the CPU
tests hold the mapping to the contraction.

:func:`mid_contract` launches the kernel for a CUDA tensor, or raises; it
takes the plain version (:func:`mid_contract_plain`) only for a tensor on
the CPU. Each launch adds one to ``LAUNCHES[layout]``.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple

import numpy as np
import torch

from pairwise_perturbation_tpu_torch.ops.kernels import _build, _mma
from pairwise_perturbation_tpu_torch.ops.kernels.last_contract import \
    rank_chunk

LAYOUTS = ("rank_minor", "rank_major", "rank_outer")
BLOCK_COLS = (128, 256, 512)

# Kernel launches per output layout, counted where the kernel is launched.
LAUNCHES: Dict[str, int] = {k: 0 for k in LAYOUTS}

_SPECS = {"rank_minor": "pbm,br->pmr", "rank_major": "pbm,br->prm",
          "rank_outer": "pbm,br->rpm"}

# csrc/mid_contract.cu: rows of W staged per pass of the fma path (kRows),
# columns of M a warp of the mma path (kMmaCols), and its k tile.
K_ROWS = 64
MMA_COLS = 64
K_TILE = 16
# Static shared memory a block may use.
SMEM_STATIC = 48 * 1024


class Plan(NamedTuple):
    """A launch of csrc/mid_contract.cu."""
    path: str         # "mma" (tensor cores, bf16 V) or "fma"
    threads: int      # of a block: block_cols (fma) or 32 per 64 columns (mma)
    col_tiles: int    # column tiles of each p (grid x = P * col_tiles)
    rank_chunk: int   # ranks per pass (grid y = ceil(R / rank_chunk))
    smem: int         # static shared memory of a block, bytes


def path(M: int, v_offset: int, bf16: bool) -> str:
    """``"mma"`` for bf16 V with M % 8 == 0 at a 16-byte boundary
    (``v_offset`` = V's address modulo 16), else ``"fma"``."""
    return "mma" if bf16 and M % 8 == 0 and v_offset == 0 else "fma"


@functools.lru_cache(maxsize=256)
def plan(P: int, B: int, M: int, R: int, layout: str = "rank_minor",
         block_cols: int = 256, v_offset: int = 0,
         bf16: bool = False) -> Plan:
    """The launch for V (P, B, M) and W (B, R) in ``layout`` at
    ``block_cols`` columns a block, V float32 or (``bf16``) bfloat16 at
    ``v_offset`` bytes past a 16-byte boundary. The rank-minor layout
    stages its output tile in shared memory."""
    _check_layout(layout, block_cols)
    minor = layout == "rank_minor"
    if path(M, v_offset, bf16) == "mma":
        threads, rc = 32 * block_cols // MMA_COLS, _mma.RANKS
        smem = 4 * block_cols * (rc + 1) if minor else 0
    else:
        threads, rc = block_cols, rank_chunk(R)
        smem = 4 * (K_ROWS * rc + (block_cols * (rc + 1) if minor else 1))
    return Plan(path(M, v_offset, bf16), threads, -(-M // block_cols), rc,
                smem)


def plan_for(V, R: int, mode: int, layout: str = "rank_minor",
             block_cols: int = 256) -> Plan:
    """:func:`plan` for a tensor V contracted over ``mode`` at rank R."""
    P, B = math.prod(V.shape[:mode]), V.shape[mode]
    return plan(P, B, V.numel() // (P * B), R, layout, block_cols,
                V.data_ptr() % 16, V.dtype == torch.bfloat16)


@functools.lru_cache(maxsize=1)
def mma_tile_map():
    """One warp's k tile of the mma path as the kernel forms it
    (csrc/mid_contract.cu ``mma_k_tile``), as three (16384, 2) int arrays
    over its products: the W^T element (rank of the chunk's 16, row of the
    tile's 16), the V element (row of the tile, column of the warp's 64)
    and the output the product is summed into (rank, column).

    W^T is the A operand in its own layout. Lane (g, t) loads 16 bytes of
    rows 2t, 2t + 1, 2t + 8 and 2t + 9 at columns 8g ... 8g + 7; mma j's
    B pairs element j of rows 2t and 2t + 1 (b0) and of rows 2t + 8 and
    2t + 9 (b1), so its column n = g is m = 8g + j; D's float i is rank
    g + 8 (i >> 1) at column 16t + 8 (i & 1) + j."""
    g, t = _mma.lanes()
    a = np.zeros((32, 4, 2, 2), np.int64)
    for i in range(4):
        for h in (0, 1):
            a[:, i, h] = np.stack([g + 8 * (i & 1), 2 * t + h + 8 * (i >> 1)],
                                  1)
    parts = []
    for j in range(8):
        b = np.zeros((32, 2, 2, 2), np.int64)
        for i in range(2):
            for h in (0, 1):
                b[:, i, h] = np.stack([2 * t + 8 * i + h, 8 * g + j], 1)
        c = np.stack([np.stack([g + 8 * (i >> 1), 16 * t + 8 * (i & 1) + j],
                               1) for i in range(4)], 1)
        parts.append(_mma.products(a, b, c))
    return tuple(np.concatenate([p[k] for p in parts]) for k in range(3))


def emulate_mma(V3, W):
    """The mma path in numpy, warp tile by warp tile as the kernel runs it:
    for each p, 64-column tile and rank chunk of 16, the k tiles of 16
    rows (rows past B, and a lane's 8 columns past M, load zeros), W^T
    zero past R and B. Returns (out (P, M, R) float64, count (P, B, M, R),
    misplaced): count[p, b, m, r] is the number of times V[p, b, m] W[b,
    r] was summed into out[p, m, r]; ``misplaced`` counts products of real
    elements summed anywhere else."""
    P, B, M = V3.shape
    R = W.shape[1]
    w, v, o = mma_tile_map()
    Wt = _mma.wt_bf16(torch.as_tensor(W, dtype=torch.float32)).float() \
        .numpy().astype(np.float64)
    out = np.zeros((P, M, R))
    count = np.zeros((P, B, M, R), np.int64)
    misplaced = 0
    for p in range(P):
        for m0 in range(0, M, MMA_COLS):
            for r0 in range(0, R, _mma.RANKS):
                for k0 in range(0, B, K_TILE):
                    row, col = k0 + v[:, 0], m0 + v[:, 1]
                    live = (row < B) & (m0 + v[:, 1] // 8 * 8 < M)
                    wrow, rank = k0 + w[:, 1], r0 + w[:, 0]
                    orank, ocol = r0 + o[:, 0], m0 + o[:, 1]
                    x = np.where(live, V3[p, np.minimum(row, B - 1),
                                          np.minimum(col, M - 1)], 0.) \
                        * Wt[rank, wrow]
                    written = (ocol < M) & (orank < R)
                    np.add.at(out[p], (ocol[written], orank[written]),
                              x[written])
                    real = live & written & (wrow < B) & (rank < R)
                    ok = real & (row == wrow) & (col == ocol) & \
                        (rank == orank)
                    misplaced += int((real & ~ok).sum())
                    np.add.at(count[p], (row[ok], col[ok], orank[ok]), 1)
    return out, count, misplaced


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
    phys = {"rank_minor": (P, M, R), "rank_major": (P, R, M),
            "rank_outer": (R, P, M)}[layout]
    out = torch.empty(phys, dtype=torch.float32, device=V.device)
    stream = torch.cuda.current_stream(V.device).cuda_stream
    lib = _build.load()
    if plan_for(V, R, mode, layout, block_cols).path == "mma":
        Wt = _mma.wt_bf16(W)
        code = lib.pp_mid_contract_mma(
            V.data_ptr(), Wt.data_ptr(), Wt.shape[1], out.data_ptr(), P, B,
            M, R, LAYOUTS.index(layout), block_cols, stream)
    else:
        bf16 = V.dtype == torch.bfloat16
        Wr = W.to(V.dtype).float() if bf16 else W
        code = lib.pp_mid_contract(
            V.data_ptr(), int(bf16), Wr.data_ptr(), out.data_ptr(), P, B, M,
            R, LAYOUTS.index(layout), block_cols, stream)
    _build.check(lib, code, "mid_contract launch")
    LAUNCHES[layout] += 1
    return _out(out, shape, mode, layout)
