"""The reference's random rank-R tensor (``-tensor r``, test_ALS.cxx:
246-264; the strong-scaling runs of script_strongscaling.py), built on
the device block by block.

A frozen copy of the port's ``utils/synth.random_cp_tensor``
(benchmark/tests pins the two equal): factors uniform(0, 1), drawn on
the host from ``numpy.random.default_rng(data_seed)`` in mode order, and
V = sum_r W_0[:, r] o W_1[:, r] o ... exactly of rank R, with no noise.

:func:`make_block` gives one rank's zero-padded block of V from the row
slices of the factors, so that no card ever holds the whole tensor. Every
entry is formed by the same elementwise operations in the same order
whatever the block (the Khatri-Rao rows mode by mode, then the R terms
added one at a time), so the blocks of any mesh tile :func:`make`'s V bit
for bit."""

from __future__ import annotations

import numpy as np
import torch

# float64 entries formed at a time
CHUNK_ELEMS = 1 << 24


def factors(shape, R: int, data_seed: int):
    """The factors as the port's synth.random_cp_tensor draws them."""
    rng = np.random.default_rng(int(data_seed))
    return [rng.random((s, R)) for s in shape]


def khatri_rao(mats):
    """Rows (i, j, ...) in C order: out[(i, j, ...), r] = A[i, r] B[j, r]..."""
    out = mats[0]
    for M in mats[1:]:
        out = (out[:, None, :] * M[None, :, :]).reshape(-1, M.shape[1])
    return out


def block(Ws, spans, device, dtype=torch.float32):
    """The block of V at ``spans`` ((start, stop) of each mode in the
    padded index space) in ``dtype`` on ``device``: zero beyond V's
    extent."""
    rows = []
    for W, (lo, hi) in zip(Ws, spans):
        part = np.zeros((hi - lo, W.shape[1]))
        real = W[lo:hi]
        part[:len(real)] = real
        rows.append(torch.from_numpy(part).to(device))
    left = khatri_rao(rows[:-1])
    D = rows[-1]
    out = torch.empty([hi - lo for lo, hi in spans], dtype=dtype,
                      device=device)
    flat = out.view(-1, D.shape[0])
    step = max(1, CHUNK_ELEMS // max(1, D.shape[0]))
    for r0 in range(0, flat.shape[0], step):
        L = left[r0:r0 + step]
        acc = L[:, 0, None] * D[None, :, 0]
        for r in range(1, D.shape[1]):
            acc.add_(L[:, r, None] * D[None, :, r])
        flat[r0:r0 + step] = acc.to(dtype)
    return out


def make(shape, conf, device, dtype=torch.float32):
    """V of ``shape`` in ``dtype`` on ``device``, from the configuration's
    ``tensor.data_seed`` and ``rank``."""
    Ws = factors(shape, int(conf["rank"]), conf["tensor"]["data_seed"])
    return block(Ws, [(0, s) for s in shape], device, dtype)


def make_block(shape, conf, layout, device, dtype=torch.float32):
    """This rank's zero-padded block of :func:`make`'s V: ``layout.span(m)``
    is the rank's (start, stop) of mode ``m`` in the padded index
    space."""
    Ws = factors(shape, int(conf["rank"]), conf["tensor"]["data_seed"])
    return block(Ws, [layout.span(m) for m in range(len(shape))], device,
                 dtype)
