"""Synthetic tensor zoo — the test/benchmark fixtures of the reference
driver (test_ALS.cxx:222-326). A numpy-only copy of
``pairwise_perturbation_tpu/utils/synth.py``; tests/test_torch_cli.py pins
the arrays of the two copies equal.

- ``p``  : Poisson operator, folded to order dim/2 with modes s^2
           (laplacian_tensor + fold_unfold, test_ALS.cxx:232-245)
- ``p2`` : Poisson operator at full order dim (laplacian_tensor)
- ``c``  : controlled-collinearity CP tensor + noise
           (Gen_collinearity, common.cxx:361-423; test_ALS.cxx:246-264)
- ``r``  : exact rank-R tensor from uniform(0,1) factors (test_ALS.cxx:274-286)
- ``r2`` : random tensor, uniform(0.5, 1) (test_ALS.cxx:266-273)

The Poisson operator: V[m_0 m_1, m_2 m_3, ...] = sum_k kron_j (D if j==k
else I) with D = tridiag(-1, 2, -1) — each term is rank-1 in the folded
view, so ``p`` has an exact low-rank CP structure. Built on host numpy
(these are O(tensor size), one-time) and moved to device by the caller.
"""

from __future__ import annotations

from functools import reduce
from typing import Sequence

import numpy as np


def laplacian_matrix(s: int, symmetric: bool = True) -> np.ndarray:
    """D = tridiag(-1, 2, -1) (common.cxx:575-595). The 'random' variant
    (random_laplacian_tensor, common.cxx:500-521) uses -1 above and -2 below
    the diagonal."""
    D = 2.0 * np.eye(s)
    off = -np.ones(s - 1)
    D += np.diag(off, 1)
    D += np.diag(off if symmetric else 2 * off, -1)
    return D


def identity_tensor(N: int, s: int) -> np.ndarray:
    """Kronecker of N/2 identity matrices as an order-N tensor
    (identitiy_tensor, common.cxx:462-494)."""
    assert N % 2 == 0
    d = N // 2
    out = np.eye(s)
    for _ in range(d - 1):
        out = np.multiply.outer(np.eye(s), out)
    return out.reshape([s] * N)


def poisson_folded(dim: int, s: int, symmetric: bool = True) -> np.ndarray:
    """Folded Poisson tensor: order dim/2, modes s^2; exact CP rank dim/2."""
    assert dim % 2 == 0
    d = dim // 2
    D = laplacian_matrix(s, symmetric).reshape(-1)
    I = np.eye(s).reshape(-1)
    V = np.zeros([s * s] * d)
    for k in range(d):
        vecs = [D if j == k else I for j in range(d)]
        V += reduce(np.multiply.outer, vecs)
    return V


def laplacian_tensor(dim: int, s: int, symmetric: bool = True) -> np.ndarray:
    """Order-``dim`` Poisson tensor (laplacian_tensor, common.cxx:575-642):
    sum over k of D at mode-pair k, identities elsewhere."""
    return poisson_folded(dim, s, symmetric).reshape([s] * dim)


def collinearity(v1: np.ndarray, v2: np.ndarray) -> float:
    """cos angle (common.cxx:297-302)."""
    return float(v1 @ v2 / (np.linalg.norm(v1) * np.linalg.norm(v2)))


def gram_schmidt(A: np.ndarray, B: np.ndarray) -> np.ndarray:
    """Remove B's component from A (common.cxx:291-295)."""
    return A - (A @ B) / (B @ B) * B


def gen_collinearity_factors(lens: Sequence[int], R: int, col_min: float,
                             col_max: float, rng: np.random.Generator,
                             max_tries: int = 1000):
    """Factor matrices + weights of the controlled-collinearity CP tensor
    (Gen_collinearity, common.cxx:361-423) WITHOUT materializing the
    tensor — callers can build it on device from the factors. Returns
    ``(Ws, lams)`` with ``Ws[j]`` of shape ``(lens[j], R)`` and
    ``lams[i] = 0.2 + 0.6 (i+1)/R``. Rejection sampling like the
    reference, with a bounded retry count."""
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


def gen_collinearity(lens: Sequence[int], R: int, col_min: float,
                     col_max: float, rng: np.random.Generator,
                     max_tries: int = 1000) -> np.ndarray:
    """CP tensor with per-mode pairwise factor collinearity constrained to
    [col_min, col_max] and weights lambda_i = 0.2 + 0.6 (i+1)/R
    (Gen_collinearity, common.cxx:361-423)."""
    Ws, lams = gen_collinearity_factors(lens, R, col_min, col_max, rng,
                                        max_tries)
    V = np.zeros(tuple(lens))
    for i in range(len(lams)):
        V += lams[i] * reduce(np.multiply.outer,
                              [W[:, i] for W in Ws])
    return V


def random_cp_factors(lens: Sequence[int], R: int,
                      rng: np.random.Generator):
    """The factors of tensor 'r': uniform(0,1), drawn in mode order."""
    return [rng.random((s, R)) for s in lens]


def random_cp_tensor(lens: Sequence[int], R: int,
                     rng: np.random.Generator) -> np.ndarray:
    """Tensor 'r': exact rank-R from uniform(0,1) factors
    (:func:`random_cp_factors`); under -mesh the CLI forms each rank's
    block from the same factors instead (parallel/mesh.cp_block)."""
    Ws = random_cp_factors(lens, R, rng)
    letters = "abcdefghijklmnop"[:len(lens)]
    spec = ",".join(l + "z" for l in letters) + "->" + letters
    return np.einsum(spec, *Ws, optimize=True)


def random_tensor(lens: Sequence[int], rng: np.random.Generator,
                  low: float = 0.5, high: float = 1.0) -> np.ndarray:
    """Tensor 'r2': uniform(low, high) (test_ALS.cxx:272)."""
    return rng.uniform(low, high, size=tuple(lens))


def unit_tensor(N: int, s: int) -> np.ndarray:
    """Shifted-diagonal unit tensor (unit_tensor, common.cxx:272-289):
    order-3 with V[c, r, (r + c(s-1)) % s] = 1."""
    V = np.zeros((s, s, s))
    for c in range(s):
        for r in range(s):
            V[c, r, (r + c * (s - 1)) % s] = 1.0
    return V


def make_tensor(name: str, dim: int, s: int, R: int,
                col_min: float = 0.5, col_max: float = 0.9,
                ratio_noise: float = 0.01, seed: int = 0,
                dtype=np.float32) -> np.ndarray:
    """Tensor-zoo dispatch mirroring test_ALS.cxx:222-326."""
    rng = np.random.default_rng(seed)
    if name == "p":
        V = poisson_folded(dim, s)
    elif name == "p2":
        V = laplacian_tensor(dim, s)
    elif name == "c":
        V = gen_collinearity([s] * dim, R, col_min, col_max, rng)
        noise = rng.uniform(-1, 1, size=V.shape)
        noise *= ratio_noise * np.linalg.norm(V) / np.linalg.norm(noise)
        V = V + noise
    elif name == "r":
        V = random_cp_tensor([s] * dim, R, rng)
    elif name == "r2":
        V = random_tensor([s] * dim, rng)
    else:
        raise ValueError(f"unknown synthetic tensor '{name}'")
    return V.astype(dtype)


def build_from_vectors(vecs: Sequence[np.ndarray]) -> np.ndarray:
    """Rank-1 tensor from per-mode vectors (build_V_vec, common.cxx:304-359)."""
    return reduce(np.multiply.outer, vecs)
