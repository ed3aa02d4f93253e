"""The tensor-core instruction of the bf16-V first-level kernels, as pure
functions the CPU tests can run.

``csrc/last_contract.cu`` and ``csrc/mid_contract.cu`` take bf16 V to
``mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`` (``pp::mma_bf16``
in ``csrc/common.cuh``): D (16 x 8, f32) += A (16 x 16) B (16 x 8), the
bf16 products exact in f32 and summed in f32, which is the JAX package's
rule for bf16 V (bf16 operands, f32 accumulation and output). Each lane
of the warp holds its share of A, B and C in registers at places the PTX
ISA fixes (:func:`a_slot`, :func:`b_slot`, :func:`c_slot`); each kernel
module describes what its lanes load into those registers, and
:func:`products` turns that into the list of products one mma forms, so a
test can check that every (row, b, rank) product of the contraction lands
exactly once in the right output.

:func:`wt_bf16` builds the operand both kernels read for W: W^T rounded
to bf16 and zero-padded to whole rank chunks and steps, so that padded
ranks and columns past B contribute exact zeros.
"""

from __future__ import annotations

import numpy as np
import torch

# Ranks per chunk (two n8 tiles, or one m16 tile) and the columns of W^T
# that its rows are padded to (one 32-column step of last_contract's mma
# path; two k16 tiles of mid_contract's).
RANKS = 16
COL_PAD = 32


def a_slot(lane: int, i: int, h: int):
    """(row, k) of A held by half ``h`` of register ``i`` of ``lane``."""
    g, t = lane >> 2, lane & 3
    return g + 8 * (i & 1), 2 * t + h + 8 * (i >> 1)


def b_slot(lane: int, i: int, h: int):
    """(k, n) of B held by half ``h`` of register ``i`` of ``lane``."""
    g, t = lane >> 2, lane & 3
    return 2 * t + h + 8 * i, g


def c_slot(lane: int, i: int):
    """(row, n) of C and D held by float ``i`` of ``lane``."""
    g, t = lane >> 2, lane & 3
    return g + 8 * (i >> 1), 2 * t + (i & 1)


def products(a_src, b_src, c_dst):
    """The products one mma forms, from what the kernel put in each lane's
    registers: ``a_src[lane, i, h]`` and ``b_src[lane, i, h]`` are the
    source of each bf16 half (a pair of ints naming the element), and
    ``c_dst[lane, i]`` the output that float is stored to. Returns three
    (2048, 2) int arrays: for every (row, n, k) of the tile, the source of
    A[row, k], the source of B[k, n] and the output of D[row, n]."""
    a_src, b_src, c_dst = (np.asarray(x) for x in (a_src, b_src, c_dst))
    A = np.full((16, 16, 2), -1)
    B = np.full((16, 8, 2), -1)
    C = np.full((16, 8, 2), -1)
    for lane in range(32):
        for i in range(4):
            C[c_slot(lane, i)] = c_dst[lane, i]
            for h in range(2):
                A[a_slot(lane, i, h)] = a_src[lane, i, h]
                if i < 2:
                    B[b_slot(lane, i, h)] = b_src[lane, i, h]
    assert (A >= 0).all() and (B >= 0).all() and (C >= 0).all()
    m, n, k = np.meshgrid(np.arange(16), np.arange(8), np.arange(16),
                          indexing="ij")
    return (A[m, k].reshape(-1, 2), B[k, n].reshape(-1, 2),
            C[m, n].reshape(-1, 2))


def lanes():
    """(g, t) of every lane, as two (32,) int arrays."""
    lane = np.arange(32)
    return lane >> 2, lane & 3


def wt_bf16(W, col_pad: int = COL_PAD):
    """W (B, R) float32 as the kernels' bf16 W^T: (RANKS * ceil(R /
    RANKS), col_pad * ceil(B / col_pad)), zero past R and B, rounded to
    nearest even as ``W.to(torch.bfloat16)`` rounds."""
    B, R = W.shape
    Wt = torch.zeros((-(-R // RANKS) * RANKS, -(-B // col_pad) * col_pad),
                     dtype=torch.bfloat16, device=W.device)
    Wt[:R, :B] = W.t()
    return Wt
