"""The collinearity CP tensor (the reference's ``-tensor c``,
Gen_collinearity, common.cxx:361-423), built on the device.

:func:`collinearity_factors` is a frozen copy of the port's
``utils/synth.gen_collinearity_factors`` (benchmark/tests pins the two
equal): unit-free uniform(0, 1) factor columns, redrawn until every pair
of columns of a mode has a cosine in [colmin, colmax], and weights
lambda_i = 0.2 + 0.6 (i+1)/R. The factors are small and drawn on the
host from ``numpy.random.default_rng(data_seed)``; the tensor
sum_i lambda_i a_i o b_i o ... is one matrix product on the device, and
the uniform(-1, 1) noise, scaled to ``rationoise`` of the tensor's norm,
comes from a device ``torch.Generator`` seeded with ``data_seed`` (the
reference draws it on the host; the distribution is the same)."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def collinearity(v1: np.ndarray, v2: np.ndarray) -> float:
    return float(v1 @ v2 / (np.linalg.norm(v1) * np.linalg.norm(v2)))


def collinearity_factors(lens: Sequence[int], R: int, col_min: float,
                         col_max: float, rng: np.random.Generator,
                         max_tries: int = 1000):
    """(factors, weights) of the collinearity CP tensor, as the port's
    synth.gen_collinearity_factors draws them."""
    dim = len(lens)
    vecs = [[rng.random(lens[j]) for j in range(dim)] for _ in range(R)]
    for j in range(dim):
        for i in range(1, R):
            for _ in range(max_tries):
                ok = all(col_min <= collinearity(vecs[i][j], vecs[k][j])
                         <= col_max for k in range(i))
                if ok:
                    break
                vecs[i][j] = rng.random(lens[j])
    Ws = [np.stack([vecs[i][j] for i in range(R)], axis=1)
          for j in range(dim)]
    lams = np.array([0.2 + 0.6 / R * (i + 1) for i in range(R)])
    return Ws, lams


def khatri_rao(mats):
    """Rows (i, j, ...) in C order: out[(i, j, ...), r] = A[i, r] B[j, r]..."""
    out = mats[0]
    for M in mats[1:]:
        out = (out[:, None, :] * M[None, :, :]).reshape(-1, M.shape[1])
    return out


def make(shape, conf, device, dtype=torch.float32):
    """V of ``shape`` in ``dtype`` on ``device``, from the configuration's
    ``tensor`` parameters (data_seed, colmin, colmax, rationoise) and
    ``rank``."""
    p = conf["tensor"]
    rng = np.random.default_rng(int(p["data_seed"]))
    Ws, lams = collinearity_factors(shape, int(conf["rank"]), p["colmin"],
                                    p["colmax"], rng)
    # accumulate in float64, store in dtype: V = KR(W_0..W_{N-2}) diag(l) W_N^T
    Wt = [torch.from_numpy(W).to(device, torch.float64) for W in Ws]
    lam = torch.from_numpy(lams).to(device, torch.float64)
    left = khatri_rao(Wt[:-1]) * lam[None, :]
    V = torch.empty(tuple(shape), dtype=dtype, device=device)
    flat = V.view(-1, shape[-1])
    rows = max(1, (1 << 24) // shape[-1])
    for r0 in range(0, flat.shape[0], rows):
        flat[r0:r0 + rows] = (left[r0:r0 + rows] @ Wt[-1].T).to(dtype)
    ratio = float(p["rationoise"])
    if ratio > 0:
        gen = torch.Generator(device=device).manual_seed(int(p["data_seed"]))
        noise = torch.rand(V.shape, generator=gen, device=device,
                           dtype=dtype).mul_(2).sub_(1)
        scale = ratio * torch.linalg.vector_norm(V, dtype=torch.float64) \
            / torch.linalg.vector_norm(noise, dtype=torch.float64)
        V.add_(noise.mul_(scale.to(dtype)))
        del noise
    return V
