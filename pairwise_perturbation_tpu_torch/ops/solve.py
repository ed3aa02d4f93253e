"""R x R solves, the low-rank kit of CP-ALS and Tucker's eigenvector
helpers — port of ``pairwise_perturbation_tpu/ops/solve.py``. The Gram
matrices S are tiny (R x R), so they are solved on the device with
``torch.linalg``.

- :func:`svd_solve`      <-> ``SVD_solve`` (common.cxx:710-725): W = M pinv(S)
                             via symmetric eigh (S is symmetric PSD).
- :func:`svd_solve_mod`  <-> ``SVD_solve_mod`` (common.cxx:739-758): damped
                             PP solve.
- :func:`cholesky_solve` <-> ``cholesky_solve`` (common.cxx:727-737).
- :func:`randomized_svd` <-> ``randomized_svd`` (common.cxx:691-708); its
                             uniform test matrix is an argument.
- :func:`rankR_update_cholesky` / :func:`rankR_update_svd`
                         <-> ``get_rankR_update_*`` (common.cxx:768-813):
                             rank-r factorization of the factor update
                             dW = M pinv(S) - A, for the LR optimizers.
- :func:`gauss_seidel`   <-> ``Gauss_Seidel`` (common.cxx:840-868).
- :func:`truncated_eigh` / :func:`fix_sign_columns` / :func:`sign_match`
                         <-> the leading singular vectors of a Tucker
                             unfolding and their column signs
                             (als_Tucker.cxx:12-23, 632-643).

Where the JAX package branches with ``lax.cond`` the port selects with
``torch.where``, so no branch reads a value back. The factorizations do
synchronize on a CUDA device: ``torch.linalg.eigh`` and
``torch.linalg.svd`` document that they synchronize the device with the
CPU (their error check reads ``info`` back), so every
``svd_solve`` (``_psd_pinv``), ``truncated_eigh`` and ``truncated_svd``
waits for the card; ``cholesky_ex`` does not, and neither do the
Cholesky solves.
"""

from __future__ import annotations

from typing import Optional

import torch

from pairwise_perturbation_tpu_torch import config
from pairwise_perturbation_tpu_torch.parallel import collectives


def _eps_floor(dtype, n: int) -> float:
    """Dtype-aware relative eigenvalue floor: eigenvalues of an R x R
    matrix computed by eigh carry absolute noise ~ R * eps * lam_max, and
    reciprocating anything below that amplifies pure noise."""
    return float(torch.finfo(dtype).eps) * max(n, 1)


def _psd_pinv(S, rcond: Optional[float] = None):
    """Pseudo-inverse of a symmetric PSD matrix via eigh, with a relative
    cutoff ``rcond`` floored at the dtype's eigenvalue noise level.
    Eigenvector signs and order may differ from the JAX package's eigh;
    the pseudo-inverse does not depend on them."""
    if rcond is None:
        rcond = config.get().rcond
    rcond = max(float(rcond), _eps_floor(S.dtype, S.shape[-1]))
    lam, Q = torch.linalg.eigh(S)
    cutoff = rcond * torch.max(torch.abs(lam))
    inv = torch.where(torch.abs(lam) > cutoff, 1.0 / lam,
                      torch.zeros_like(lam))
    return (Q * inv) @ Q.T


def _refine_steps(dtype, refine: Optional[int]) -> int:
    """Iterative-refinement passes for a solve: low-precision solves of an
    ill-conditioned S are not backward stable, and a couple of passes with
    the same approximate inverse restore that; f64 skips them."""
    if refine is None:
        refine = config.get().solve_refine
    return 0 if dtype == torch.float64 else int(refine)


def svd_solve(M, S, rcond: Optional[float] = None,
              refine: Optional[int] = None):
    """Solve W S = M for W (S symmetric PSD): W = M pinv(S), plus
    iterative refinement in low precision."""
    P = _psd_pinv(S, rcond)
    W = M @ P
    for _ in range(_refine_steps(S.dtype, refine)):
        W = W + (M - W @ S) @ P
    return W


def svd_solve_mod(M, W_init, S, ratio_step: float,
                  rcond: Optional[float] = None):
    """Damped PP solve. Returns (W_new, dW) with

    dW = ratio_step * (M pinv(S) - W_init),  W_new = W_init + dW

    (identical to the reference for ratio_step == 1, common.cxx:752-756).
    """
    dW = ratio_step * (svd_solve(M, S, rcond) - W_init)
    return W_init + dW, dW


def _cholesky(S):
    """(L, ok): Cholesky factor and a 0-d bool tensor, False where S is not
    numerically positive definite. ``torch.linalg.cholesky`` raises there;
    the JAX package's returns NaN, which ``cholesky_ex`` lets the port
    reproduce without a host sync."""
    L, info = torch.linalg.cholesky_ex(S)
    ok = (info == 0) & torch.all(torch.isfinite(L))
    return torch.where(ok, L, torch.full_like(L, float("nan"))), ok


def cholesky_solve(M, S, refine: Optional[int] = None, L=None):
    """Solve W S = M via Cholesky of S (common.cxx:727-737), plus
    iterative refinement in low precision. NaN where S is not positive
    definite, as in the JAX package."""
    if L is None:
        L, _ = _cholesky(S)

    def _solve(rhs):
        # S = L L^T; W S = rhs  =>  S W^T = rhs^T  =>  two triangular solves.
        y = torch.linalg.solve_triangular(L, rhs.T, upper=False)
        return torch.linalg.solve_triangular(L.T, y, upper=True).T

    W = _solve(M)
    for _ in range(_refine_steps(S.dtype, refine)):
        W = W + _solve(M - W @ S)
    return W


def auto_solve(M, S, rcond: Optional[float] = None):
    """Cholesky solve with a pseudo-inverse fallback where S is
    numerically not positive definite (the collinearity fixtures make S
    near-singular). Both branches run; ``torch.where`` picks, so there is
    no host sync (the JAX package's ``lax.cond``)."""
    L, ok = _cholesky(S)
    return torch.where(ok, cholesky_solve(M, S, L=L), svd_solve(M, S, rcond))


def solve(M, S, method: str = "chol", rcond: Optional[float] = None):
    if method == "chol":
        return cholesky_solve(M, S)
    if method == "auto":
        return auto_solve(M, S, rcond)
    return svd_solve(M, S, rcond)


def truncated_eigh(G, k: int):
    """Top-``k`` eigenpairs of a symmetric PSD matrix, descending:
    (U[s, k], lam[k]). ``G`` is symmetrized first, as ``jnp.linalg.eigh``
    does by default; ``torch.linalg.eigh`` alone would read one
    triangle."""
    lam, Q = torch.linalg.eigh(0.5 * (G + G.mT))
    return Q.flip(1)[:, :k], lam.flip(0)[:k]


def fix_sign_columns(U, layout=None, mode: int = None):
    """Deterministic column signs: each column's largest-|.| entry is made
    positive (the first such entry on a tie, as ``jnp.argmax`` and
    ``torch.argmax`` both pick), a zero column is left as it is.

    Under ``layout`` with ``mode`` sharded, U is this rank's row block:
    every rank's (largest |entry|, entry) pair of each column is gathered
    along the axis (parallel/collectives.gather_blocks), and the first
    rank with the largest |entry| decides, which is the whole column's first
    largest entry (blocks are contiguous, in coordinate order). Every
    rank flips the same columns."""
    idx = torch.argmax(torch.abs(U), dim=0)
    picked = U.gather(0, idx[None, :])
    if collectives.is_sharded(layout, mode):
        cand = collectives.gather_blocks(
            torch.cat([torch.abs(picked), picked]), mode, layout)
        first = torch.argmax(cand[:, 0, :], dim=0)
        picked = cand[:, 1, :].gather(0, first[None, :])
    signs = torch.sign(picked)
    return U * torch.where(signs == 0, torch.ones_like(signs), signs)


def sign_match(U, W_ref, layout=None, mode: int = None):
    """Flip U's columns to agree with W_ref:
    U diag(sign(diag(U^T W_ref))), where a zero inner product counts as
    negative (``jnp.where(d > 0, 1, -1)``): a zero ``W_ref``, as the first
    DT sweep of a Tucker phase passes, negates every column. Under
    ``layout`` with ``mode`` sharded, U and W_ref are row blocks and the
    inner products are summed over the axis."""
    d = collectives.row_sum([torch.sum(U * W_ref, dim=0)], [mode],
                            layout)[0]
    return U * torch.where(d > 0, 1.0, -1.0).to(U.dtype)


def randomized_svd(A, r: int, X, n_iter: int = 1, layout=None,
                   mode: int = None):
    """Randomized range-finder truncated SVD (common.cxx:691-708).
    Returns (U[m, r], s[r], VT[r, n]).

    ``X`` is the (n, r) uniform test matrix. The JAX package draws it from
    ``jax.random`` inside; torch cannot reproduce those bits, so callers
    draw it (the optimizers from a seeded CPU ``torch.Generator``) and a
    parity test can pass in the JAX package's draw.

    ``layout``: A is this rank's row block of the factor of ``mode``. Each
    power iteration's ``A^T (A Q)`` is summed over the rows (one
    all_reduce where the mode is sharded), so every rank takes the same
    n x r QR; U is this rank's rows."""
    Q, _ = torch.linalg.qr(X.to(A.dtype))
    for _ in range(n_iter):
        # X = A^T A Q  (power iteration on the Gram)
        Q, _ = torch.linalg.qr(collectives.row_sum(
            [A.T @ (A @ Q)], [mode], layout)[0])
    U, s, VT_small = truncated_svd(A @ Q, r, layout, mode)
    return U, s, VT_small @ Q.T


def truncated_svd(A, r: int, layout=None, mode: int = None):
    """Exact truncated SVD. Tall matrices (m >= 4n, as the LR kit's dW of
    shape (s_i, R)) take the Gram-eigh route: G = A^T A is n x n and
    U = A V diag(1/sigma), the same leading factors, as the JAX package
    computes them; the rest take ``torch.linalg.svd``. Column signs may
    differ from the JAX package's; (U s) VT does not.

    ``layout``: A is this rank's row block of the factor of ``mode``; m is
    the padded global row count (the JAX package's route). The Gram is
    summed over the rows; the other route takes ``torch.linalg.svd`` of
    the rows gathered whole, and each rank keeps its own rows of U."""
    m = A.shape[0] if layout is None else layout.padded_shape[mode]
    n = A.shape[1]
    if m >= 4 * n:
        G = collectives.row_sum([A.T @ A], [mode], layout)[0]
        lam, Q = torch.linalg.eigh(G)
        lam, Q = lam.flip(0)[:r], Q.flip(1)[:, :r]
        floor = torch.finfo(A.dtype).eps * torch.clamp(lam[0], min=1e-30) * n
        sigma = torch.sqrt(torch.clamp(lam, min=0.0))
        inv = torch.where(lam > floor,
                          1.0 / torch.clamp(sigma, min=1e-30),
                          torch.zeros_like(sigma))
        return (A @ Q) * inv[None, :], sigma, Q.T
    U, s, VT = torch.linalg.svd(collectives.gather_rows(A, mode, layout),
                                full_matrices=False)
    if collectives.is_sharded(layout, mode):
        lo, hi = layout.span(mode)
        U = U[lo:hi]
    return U[:, :r], s[:r], VT[:r, :]


def rankR_update_cholesky(M, A, S, r: int, X=None, layout=None,
                          mode: int = None):
    """Rank-``r`` factorization (U, s, VT) of dW = M pinv(S) - A
    (``get_rankR_update_cholesky``, common.cxx:768-786), dW computed by a
    Cholesky solve of M - A S, then truncated: by :func:`randomized_svd`
    with the test matrix ``X`` when one is given, else exactly.
    ``layout``: M and A are this rank's row blocks of the factor of
    ``mode`` (S is whole), and so is U."""
    dW = cholesky_solve(M - A @ S, S)
    if X is not None:
        return randomized_svd(dW, r, X, n_iter=1, layout=layout, mode=mode)
    return truncated_svd(dW, r, layout, mode)


def rankR_update_svd(M, A, S, r: int, X=None, layout=None,
                     mode: int = None):
    """:func:`rankR_update_cholesky` whitened through the eigendecomposition
    of S instead (common.cxx:788-813)."""
    dW = (M - A @ S) @ _psd_pinv(S)
    if X is not None:
        return randomized_svd(dW, r, X, n_iter=1, layout=layout, mode=mode)
    return truncated_svd(dW, r, layout, mode)


def gauss_seidel(A, F, Gamma, maxits: int):
    """Gauss-Seidel relaxation for A Gamma = F (common.cxx:840-868):
    ``maxits`` times A <- A + (F - A Gamma) L^{-T}, with L the lower
    triangle of Gamma, diagonal included (the JAX package's ``lax.scan``
    is this loop)."""
    L = torch.tril(Gamma)
    for _ in range(maxits):
        # solve X L^T = F - A Gamma  =>  L X^T = (F - A Gamma)^T
        Xt = torch.linalg.solve_triangular(L, (F - A @ Gamma).T, upper=False)
        A = A + Xt.T
    return A
