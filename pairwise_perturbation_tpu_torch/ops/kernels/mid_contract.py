"""First-level contraction of a non-minor mode: the hand-written CUDA
kernel and its plain PyTorch version.

    C[pre..., post..., r] = sum_b V[pre..., b, post...] W[b, r]

Replaces ``pairwise_perturbation_tpu/ops/kernels/mttkrp_pallas.py``:
``mid_contract`` with its Pallas kernels ``_mid_kernel_t`` (rank-minor
output, K4) and ``_mid_kernel`` (rank-major output, K4'), and
``mid_contract_eligible``, copied verbatim as the pinned copy of the JAX
package's rule (the tests hold the two equal); also the benchmark-only
Pallas kernels that compute the same sum: ``_mid_kernel_zp`` (rank-outer
output, launched by ``scripts/bench_rankpos.py``, S2) and ``_mm_kernel``
of ``scripts/bench_midvariants.py`` (K4' swept over its lane tile, S5).

The kernel (``csrc/mid_contract.cu``) is bound by memory bandwidth on the
H100: it reads V once, coalesced, with the sums in registers; the
source's header says how. It takes any shape the wrapper's checks admit:
the TPU tiling conditions of the eligibility test only decide the JAX
package's route. On a card, ops/contract.py sends every first-level
contraction of V over a non-minor mode here when :func:`route_admits`
admits it, with no flag, and so routes more calls than the JAX package:
on the TPU, XLA folds the transposition of V into
its dot, while eager ``torch.einsum`` on the H100 first copies V into the
permuted order and then runs a GEMM, three passes over V where the kernel
makes one.

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

:func:`plan` chooses, from the shapes, the layout, V's type and its
alignment alone, the path and its launch: ``"mma"`` (bf16 V, M % 8 == 0,
V 16-byte aligned) runs the products on the tensor cores (``_mma``), W^T
as the A operand and 64 columns of V a warp as B; ``"f32v"`` (float32 V,
rank-minor layout, M % 4 == 0, V 16-byte aligned: K4 on the package's
route) runs them as FP32 FMAs with 4 columns a thread, loaded 16 bytes a
row, and W's rank chunk staged once; ``"fma"`` (every other shape: the
rank-major and rank-outer layouts, and V off 16-byte alignment or with a
ragged M) runs them as FP32 FMAs with one column a thread. All three are
hand written; a shape takes one of them, and a failed launch raises.
:func:`mma_tile_map` is the mma path's fragment mapping and
:func:`emulate_mma` walks it over a whole launch in numpy, as
:func:`emulate_f32v` walks the f32v path's tiling, so the CPU tests hold
each mapping to the contraction.

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
# columns of M a warp of the mma path (kMmaCols), and its k tile; the
# f32v path's threads a block (kV4Threads), columns a block (kV4Cols, 4 a
# thread), rows a load group (kV4Group, two in flight) and ranks a pass
# at most (kV4MaxRanks).
K_ROWS = 64
MMA_COLS = 64
K_TILE = 16
V4_THREADS = 128
V4_COLS = 4 * V4_THREADS
V4_GROUP = 4
V4_MAX_RANKS = 16
# Shared memory a block may use without opting in (static, or dynamic:
# the f32v path's never exceeds it).
SMEM_STATIC = 48 * 1024


class Plan(NamedTuple):
    """A launch of csrc/mid_contract.cu."""
    path: str         # "mma" (tensor cores, bf16 V), "f32v" or "fma"
    threads: int      # of a block: block_cols (fma), 32 per 64 columns
                      # (mma), V4_THREADS (f32v)
    col_tiles: int    # column tiles of each p (grid x = P * col_tiles)
    rank_chunk: int   # ranks per pass (grid y = ceil(R / rank_chunk))
    smem: int         # shared memory of a block, bytes (f32v: dynamic)
    w_rows: int       # rows of W staged a pass (mma: 0, W^T read from L1)


def path(M: int, v_offset: int, bf16: bool,
         layout: str = "rank_minor") -> str:
    """``"mma"`` for bf16 V with M % 8 == 0 at a 16-byte boundary
    (``v_offset`` = V's address modulo 16); ``"f32v"`` for float32 V in
    the rank-minor layout with M % 4 == 0 at a 16-byte boundary; else
    ``"fma"``."""
    if bf16:
        return "mma" if M % 8 == 0 and v_offset == 0 else "fma"
    return "f32v" if layout == "rank_minor" and M % 4 == 0 \
        and v_offset == 0 else "fma"


def f32v_rank_chunk(R: int) -> int:
    """Ranks a pass of the f32v path: R itself up to V4_MAX_RANKS, else
    R cut into ceil(R / 16) chunks as equal as whole ranks allow (the
    last chunk pads the rest with zeros)."""
    return -(-R // -(-R // V4_MAX_RANKS))


def f32v_w_stride(rc: int) -> int:
    """W's row stride in the f32v path's shared memory: rc rounded up to
    whole float4s (csrc/mid_contract.cu ``w_stride``)."""
    return -(-rc // 4) * 4


def f32v_w_rows(B: int, rc: int) -> int:
    """Rows of W the f32v path stages a pass: B rounded up to two load
    groups (8 rows), or as many rows as 48 KB of shared memory hold at
    W's row stride, whichever is fewer."""
    step = 2 * V4_GROUP
    cap = SMEM_STATIC // (4 * f32v_w_stride(rc)) // step * step
    return min(-(-B // step) * step, cap)


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
    kind = path(M, v_offset, bf16, layout)
    if kind == "f32v":
        rc = f32v_rank_chunk(R)
        w_rows = f32v_w_rows(B, rc)
        smem = 4 * max(w_rows * f32v_w_stride(rc), V4_COLS * rc)
        return Plan(kind, V4_THREADS, -(-M // V4_COLS), rc, smem, w_rows)
    if kind == "mma":
        threads, rc, w_rows = 32 * block_cols // MMA_COLS, _mma.RANKS, 0
        smem = 4 * block_cols * (rc + 1) if minor else 0
    else:
        threads, rc, w_rows = block_cols, rank_chunk(R), K_ROWS
        smem = 4 * (K_ROWS * rc + (block_cols * (rc + 1) if minor else 1))
    return Plan(kind, threads, -(-M // block_cols), rc, smem, w_rows)


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


def emulate_f32v(V3, W):
    """The f32v path in numpy, block by block as the kernel runs it
    (csrc/mid_contract.cu ``mid_contract_f32v_kernel``, at :func:`plan`'s
    rank chunk and W rows): each block's W chunk staged at its stride
    (zero past B, R and the chunk), thread t's 16-byte loads of columns
    m0 + 4t ... m0 + 4t + 3 row by row (zeros past the chunk's rows), its
    sums at acc[j RC + r], the output tile at 4 t RC + j RC + r of the
    shared buffer and its copy out. Returns (out (P, M, R) float64, count
    (P, B, M, R), misplaced), as :func:`emulate_mma` does."""
    P, B, M = V3.shape
    R = W.shape[1]
    p_ = plan(P, B, M, R)
    assert p_.path == "f32v"
    rc, w_rows = p_.rank_chunk, p_.w_rows
    step = 2 * V4_GROUP
    t = np.arange(V4_THREADS)[:, None, None, None]
    j = np.arange(4)[None, :, None, None]
    r = np.arange(rc)[None, None, :, None]
    slot = 4 * t * rc + j * rc + r  # the sum's place in the shared tile
    out = np.zeros(P * M * R)
    count = np.zeros((P, B, M, R), np.int64)
    misplaced = 0
    for p in range(P):
        for m0 in range(0, M, V4_COLS):
            cols = min(V4_COLS, M - m0)
            live = m0 + 4 * t < M
            col = m0 + 4 * t + j
            for r0 in range(0, R, rc):
                # where each slot of the tile is copied to (-1: nowhere)
                if R == rc:
                    keep = live & (slot < cols * rc)
                    pos = (p * M + m0) * R + slot
                else:
                    c, rr = slot // rc, slot % rc
                    keep = live & (c < cols) & (rr < min(rc, R - r0))
                    pos = (p * M + m0 + c) * R + r0 + rr
                dest = np.where(keep, pos, -1)
                for c0 in range(0, B, w_rows):
                    n = min(w_rows, B - c0)
                    k = np.arange(-(-n // step) * step)[None, None, None, :]
                    w_ok = (k < n) & (r0 + r < R)  # staged W
                    v_ok = live & (k < n)                      # loaded V
                    x = np.where(v_ok, V3[p, np.minimum(c0 + k, B - 1),
                                          np.minimum(col, M - 1)], 0.) * \
                        np.where(w_ok, W[np.minimum(c0 + k, B - 1),
                                         np.minimum(r0 + r, R - 1)], 0.)
                    shape = x.shape
                    d = np.broadcast_to(dest, shape)
                    np.add.at(out, d[d >= 0], x[d >= 0])
                    real = np.broadcast_to(v_ok & w_ok, shape)
                    vb, vm, wb, wr, dd = (np.broadcast_to(a, shape)[real]
                                          for a in (c0 + k, col, c0 + k,
                                                    r0 + r, d))
                    ok = (dd >= 0) & (vb == wb) & \
                        (vm == dd // R % M) & (wr == dd % R) & \
                        (dd // (M * R) == p)
                    misplaced += int((~ok).sum())
                    np.add.at(count[p], (vb[ok], vm[ok], wr[ok]), 1)
    return out.reshape(P, M, R), count, misplaced


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


def route_admits(V, R: int, mode: int, layout: str = "rank_minor") -> bool:
    """Whether the card's first-level route (ops/contract.py) takes V x_mode
    W at rank R in ``layout``: a mode before V's last, and a launch whose
    grid the kernel's own checks admit (``P * col_tiles`` blocks in x, at
    most 2^31 - 1). V's type and device are the caller's to check."""
    if not 0 <= mode < V.ndim - 1 or V.numel() == 0 or R <= 0:
        return False
    p = plan_for(V, R, mode, layout)
    return math.prod(V.shape[:mode]) * p.col_tiles <= 0x7FFFFFFF


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
    stream = _build.current_stream(V.device)
    lib = _build.load()
    p = plan_for(V, R, mode, layout, block_cols)
    if p.path == "f32v":
        code = lib.pp_mid_contract_f32v(
            V.data_ptr(), W.data_ptr(), out.data_ptr(), P, B, M, R,
            p.rank_chunk, p.w_rows, stream)
    elif p.path == "mma":
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
