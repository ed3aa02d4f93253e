"""Tensor-contraction primitives for CP-ALS — port of the CP half of
``pairwise_perturbation_tpu/ops/contract.py``.

- :func:`mttkrp`            <-> ``KhatriRao_contract`` (common.cxx:931-997)
- :func:`partial_mttkrp`    <-> the chain contractions inside
                                ``Build_mttkrp_map`` (als_CP.cxx:352-409)
- :func:`build_pp_caches`   <-> PP cache construction for all mode pairs and
                                singles (als_CP.cxx:667-695)
- :func:`gram` / :func:`hadamard_gram` <-> the ``S`` assembly
                                (als_CP.cxx:573-576)
- :func:`build_dense`       <-> ``build_V`` (common.cxx:135-197)
- :func:`cp_gradient`       <-> ``gradient_CP`` (common.cxx:1009-1052)
- :func:`cp_residual_norm`  <-> the diffV diagnostic (als_CP.cxx:474-479)
                                via the norm identity
- :func:`normalize_factors` <-> ``Normalize`` (common.cxx:644-689)

Functions are plain and eager on the tensors' own device. Where the JAX
package writes one multi-operand einsum and lets opt_einsum choose the
pairwise order, the port contracts one factor at a time in the global
:func:`contraction_priority` order (largest mode first): PyTorch's einsum
path depends on whether opt_einsum is installed, and contracting a small
mode of a large V first would materialize an intermediate many times V's
size. The order changes results by round-off only.
"""

from __future__ import annotations

import functools as _functools
import string
from typing import Dict, Sequence, Tuple

import torch

from pairwise_perturbation_tpu_torch import config

# Mode axes use lowercase letters; the rank axis is uppercase.
_MODES = string.ascii_lowercase
_RANK = "Z"


def _einsum(spec, *ops):
    """torch.einsum with the JAX package's mixed-precision rule
    (contract.py:54-78): when any operand is bfloat16 (bf16-stored V),
    every operand is rounded to bf16 and the contraction runs in float32,
    which returns float32. bf16 x bf16 products are exact in float32, so
    this is the TPU's bf16 contraction with f32 accumulation up to the
    order of the sums."""
    if any(o.dtype == torch.bfloat16 for o in ops):
        ops = [o.to(torch.bfloat16).float() for o in ops]
    return torch.einsum(spec, *ops)


def norm_sq(V):
    """||V||^2, accumulated in float32 for bf16 V, else in V's dtype."""
    v = V.reshape(-1)
    if v.dtype == torch.bfloat16:
        v = v.float()
    return torch.dot(v, v)


# ---------------------------------------------------------------------------
# CP primitives
# ---------------------------------------------------------------------------


def mttkrp(V, factors: Sequence, mode: int):
    """Exact MTTKRP for ``mode``: M[i_mode, r] = sum V * prod_{j != mode} W_j.

    Routes as the JAX package does (contract.py:109-128): an order-3
    float32 V with ``config.get().use_kernels`` goes to the fused kernel
    module, which launches its CUDA kernel for a CUDA tensor and runs its
    plain version for a CPU one; everything else (other orders, float64)
    is the priority-ordered einsum chain. The kernel takes contiguous
    operands only and factors may arrive as views (a transpose, for
    example), so they are made contiguous first: no copy for a contiguous
    factor, at most an (n, R) one otherwise.

    bf16 V: the JAX package writes one einsum, which rounds every factor
    to bf16; the chain therefore rounds them all, not only the first.
    """
    order = V.ndim
    if config.get().use_kernels and order == 3 and V.dtype == torch.float32:
        from pairwise_perturbation_tpu_torch.ops.kernels import mttkrp3
        return mttkrp3.mttkrp3_mode(V.contiguous(),
                                    [W.contiguous() for W in factors], mode)
    if V.dtype == torch.bfloat16:
        factors = [W.to(torch.bfloat16).float() for W in factors]
    others = (m for m in range(order) if m != mode)
    return partial_mttkrp(
        V, factors, order_by_priority(others, contraction_priority(V.shape)))


def contract_mode_kr(T, rem_modes: Tuple[int, ...], has_rank: bool, factor,
                     mode: int):
    """Contract one mode of a partial-MTTKRP intermediate with a factor.

    ``T`` has axes ``rem_modes`` (original mode ids, ascending) plus a
    trailing rank axis when ``has_rank``. Contracting mode ``m`` with
    W_m[s_m, R] removes that axis, Khatri-Rao-style (diagonal in the rank
    axis once it exists) — the reference's chain step V["acd*"] * W["d*"]
    (als_CP.cxx:383-384).
    """
    pos = rem_modes.index(mode)
    letters = _MODES[:len(rem_modes)]
    t_spec = letters + (_RANK if has_rank else "")
    out_spec = letters[:pos] + letters[pos + 1:] + _RANK
    out = _einsum(f"{t_spec},{letters[pos]}{_RANK}->{out_spec}", T, factor)
    return out, rem_modes[:pos] + rem_modes[pos + 1:]


def partial_mttkrp(V, factors: Sequence, contract_modes: Sequence[int]):
    """Chain-contract ``V`` with the factors of ``contract_modes`` (in order).

    Returns a tensor whose axes are the remaining modes (ascending original
    order) followed by the rank axis. With all-but-one mode contracted this
    is the exact MTTKRP; with all-but-two it is a PP pair cache.
    """
    T, rem, has_rank = V, tuple(range(V.ndim)), False
    for m in contract_modes:
        T, rem = contract_mode_kr(T, rem, has_rank, factors[m], m)
        has_rank = True
    return T


def fused_partial_mttkrp(V, factors: Sequence,
                         contract_modes: Sequence[int]):
    """Partial MTTKRP of a single-consumer chain. Returns (tensor,
    remaining_modes). The JAX package writes this as one einsum so XLA can
    fuse it; eager PyTorch has nothing to fuse, so it is the chain of
    :func:`partial_mttkrp` in the given order. For bf16 V only the first
    step rounds its factor, as the JAX version splits that step out
    (contract.py:161-182)."""
    cset = set(contract_modes)
    rem = tuple(m for m in range(V.ndim) if m not in cset)
    return partial_mttkrp(V, factors, contract_modes), rem


def contraction_priority(shape: Sequence[int]) -> Tuple[int, ...]:
    """Global mode-contraction order: largest modes first (ties by index),
    from the native planner (native/planner.cpp plan_chain_priority) or
    its pure-Python fallback. Memoized per shape."""
    return _priority_cached(tuple(int(s) for s in shape))


@_functools.lru_cache(maxsize=None)
def _priority_cached(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    from pairwise_perturbation_tpu_torch import native
    pr, _peak = native.plan_chain_priority(shape, 1)
    return tuple(pr)


def order_by_priority(modes, priority: Sequence[int]) -> Tuple[int, ...]:
    rank_of = {m: i for i, m in enumerate(priority)}
    return tuple(sorted(modes, key=lambda m: rank_of[m]))


def first_contraction(V, factor, mode: int, use_kernels: bool = None):
    """V x_m W_m (Khatri-Rao first level). Output axes: remaining modes
    ascending + rank (same convention as :func:`contract_mode_kr`).

    Routes as the JAX package does (contract.py:266-278): with
    ``use_kernels`` (``None`` reads ``config.get().use_kernels_first``, as
    the JAX package's ``use_pallas=None`` reads ``use_pallas_first``) a
    non-minor mode that ``mid_contract_eligible`` admits goes to the
    kernel module (rank-minor output), which launches its CUDA kernel for
    a CUDA tensor and runs its plain version for a CPU one; everything
    else, the minor mode included, is the einsum. The JAX package's
    mode-minor layouts of V are not ported."""
    order = V.ndim
    if use_kernels is None:
        use_kernels = config.get().use_kernels_first
    if use_kernels and mode < order - 1:
        from pairwise_perturbation_tpu_torch.ops.kernels import mid_contract
        if mid_contract.mid_contract_eligible(V.shape, mode, V.dtype,
                                              factor.shape[1]):
            rem = tuple(m for m in range(order) if m != mode)
            return mid_contract.mid_contract(V.contiguous(),
                                             factor.contiguous(), mode), rem
    return contract_mode_kr(V, tuple(range(order)), False, factor, mode)


def _first_contraction_rm(V, factor, mode: int):
    """First-level contraction producing a RANK-MAJOR intermediate
    (R, remaining modes ascending), the convention of the PP cache
    chains."""
    order = V.ndim
    rem = tuple(m for m in range(order) if m != mode)
    letters = _MODES[:order]
    out = letters[:mode] + letters[mode + 1:]
    spec = f"{letters},{letters[mode]}{_RANK}->{_RANK}{out}"
    return _einsum(spec, V, factor), rem


def _contract_mode_kr_rm(T, rem_modes: Tuple[int, ...], factor, mode: int):
    """One Khatri-Rao chain step on a rank-major intermediate
    (R, rem_modes...) -> (R, rem_modes without mode)."""
    pos = rem_modes.index(mode)
    letters = _MODES[:len(rem_modes)]
    out_spec = _RANK + letters[:pos] + letters[pos + 1:]
    out = _einsum(f"{_RANK}{letters},{letters[pos]}{_RANK}->{out_spec}",
                  T, factor)
    return out, rem_modes[:pos] + rem_modes[pos + 1:]


def build_pp_caches(V, factors: Sequence, use_kernels_first: bool = False):
    """Build all PP caches: pair tensors T_{ij}[R, s_i, s_j] (rank-major)
    for i<j and single matrices M_i[s_i, R].

    Mirrors the reference's ``Build_mttkrp_map`` calls over all (ii, jj)
    pairs then all singles (als_CP.cxx:676-694), including the memoized
    prefix reuse (als_CP.cxx:385-389): cache keys are the *contracted* mode
    tuples; a chain sharing a prefix reuses the prefix intermediate.
    Chains follow :func:`contraction_priority` and run rank-major, as in
    the JAX package (contract.py:357-442).

    With ``config.get().use_kernels_triple``, an order-4 V whose axis 0
    is the smallest mode roots every chain at axis 1, 2 or 3; when
    ``triple_roots_eligible`` admits it, the three roots come from one
    pass over V (contract.py:392-405).

    ``use_kernels_first`` is the JAX package's experimental
    ``use_pallas`` branch (contract.py:411-415), off unless given: each
    chain root not seeded above goes through :func:`first_contraction`
    with the kernels on (rank-last) and is moved to rank-major.
    ``config.use_kernels_first`` does not reach here, as
    ``use_pallas_first`` does not there.
    """
    order = V.ndim
    priority = contraction_priority(V.shape)
    memo: Dict[Tuple[int, ...], Tuple] = {}
    if config.get().use_kernels_triple and order == 4 and priority[-1] == 0:
        from pairwise_perturbation_tpu_torch.ops.kernels import triple_roots
        if triple_roots.triple_roots_eligible(V.shape, V.dtype,
                                              factors[0].shape[1]):
            o1, o2, o3 = triple_roots.triple_roots(
                V.contiguous(), *(W.contiguous() for W in factors[1:]))
            memo[(1,)] = (o1, (0, 2, 3))
            memo[(2,)] = (o2, (0, 1, 3))
            memo[(3,)] = (o3, (0, 1, 2))

    def get(key: Tuple[int, ...]):
        if key not in memo:
            if len(key) == 1 and use_kernels_first:
                T, rem = first_contraction(V, factors[key[0]], key[0],
                                           use_kernels=True)
                memo[key] = (T.movedim(-1, 0), rem)
            elif len(key) == 1:
                memo[key] = _first_contraction_rm(V, factors[key[0]], key[0])
            else:
                T, rem = get(key[:-1])
                memo[key] = _contract_mode_kr_rm(T, rem, factors[key[-1]],
                                                 key[-1])
        return memo[key]

    R = factors[0].shape[1]
    pair = {}
    for i in range(order):
        for j in range(i + 1, order):
            key = order_by_priority(
                (m for m in range(order) if m not in (i, j)), priority)
            if not key:  # order-2 tensor: the pair cache IS V (rank-bcast)
                pair[(i, j)] = V[None].to(factors[0].dtype).expand(
                    (R,) + tuple(V.shape))
                continue
            pair[(i, j)] = get(key)[0]          # already (R, s_i, s_j)
    single = {}
    for i in range(order):
        key = order_by_priority((m for m in range(order) if m != i), priority)
        single[i] = get(key)[0].T               # (s_i, R) for the solves
    return single, pair


def pp_correct_mttkrp(single_i, pair, dWs: Sequence, i: int):
    """First-order PP-corrected MTTKRP for mode ``i``:

    M~_i = M_i + sum_{j<i} T_{ji} x_j dW_j + sum_{j>i} T_{ij} x_j dW_j

    Reference: als_CP.cxx:778-794. ``pair[(a, b)]`` is rank-major with
    axes (R, s_a, s_b) — see :func:`build_pp_caches`.
    """
    M = single_i
    for j in range(len(dWs)):
        if j == i:
            continue
        if j < i:
            M = M + _einsum("Zab,aZ->bZ", pair[(j, i)], dWs[j])
        else:
            M = M + _einsum("Zab,bZ->aZ", pair[(i, j)], dWs[j])
    return M


def gram(W):
    """W^T W (R x R)."""
    return W.T @ W


def hadamard_gram(factors: Sequence, skip_mode: int = -1, regul=None):
    """S = Hadamard product of W_j^T W_j over j != skip_mode (+ lambda I).

    Reference: S["ij"] = prod (W[idx]["ki"] W[idx]["kj"]) (+ regul)
    (als_CP.cxx:573-578).
    """
    S = None
    for j, W in enumerate(factors):
        if j == skip_mode:
            continue
        G = gram(W)
        S = G if S is None else S * G
    if regul is not None:
        S = S + regul * torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
    return S


def build_dense(factors: Sequence):
    """Reconstruct the dense rank-R CP tensor from factors (test oracle;
    O(s^N) output). Reference: ``build_V`` (common.cxx:135-197)."""
    k = len(factors)
    spec = ",".join(_MODES[j] + _RANK for j in range(k)) + "->" + _MODES[:k]
    return _einsum(spec, *factors)


def cp_gradient(V, factors: Sequence, regul=None):
    """Full CP gradient for all modes: grad_i = -M_i + W_i S_i.

    Reference: ``gradient_CP`` (common.cxx:1009-1052).
    """
    grads = []
    for i in range(len(factors)):
        M = mttkrp(V, factors, i)
        S = hadamard_gram(factors, skip_mode=i, regul=regul)
        grads.append(-M + factors[i] @ S)
    return grads


def gradsubprob(M, S, W):
    """grad = -M + W S (common.cxx:1002-1004)."""
    return -M + W @ S


def cp_gradnorm(V, factors: Sequence, regul=None):
    """EXACT CP gradient norm sqrt(sum_i ||-M_i + W_i S_i||^2) at the
    current iterate (fresh MTTKRP per mode); diagnostics only, as in the
    JAX package (contract.py:534-546)."""
    grads = cp_gradient(V, factors, regul=regul)
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def cp_residual_norm(V_norm_sq, M_last, factors: Sequence):
    """|| V - [[W_1 .. W_N]] ||_F via the norm identity:

    ||V - Vhat||^2 = ||V||^2 - 2 <M_N, W_N> + 1^T (hadamard of all Grams) 1

    where M_N is the *exact* MTTKRP of the last mode (one MTTKRP, no
    O(s^N) temporary).
    """
    inner = torch.sum(M_last * factors[-1])
    vhat_sq = torch.sum(hadamard_gram(factors, skip_mode=-1))
    return torch.sqrt(torch.clamp(V_norm_sq - 2.0 * inner + vhat_sq, min=0.0))


def cp_residual_exact(V, factors: Sequence):
    """Exact reconstruction residual (test oracle)."""
    return torch.linalg.vector_norm(V - build_dense(factors))


def normalize_factors(factors: Sequence):
    """Rebalance all factor Frobenius norms to their geometric mean.

    Reference: ``Normalize`` (common.cxx:680-689).
    """
    norms = [torch.linalg.vector_norm(W) for W in factors]
    target = torch.prod(torch.stack(norms)) ** (1.0 / len(factors))
    return [W * (target / n) for W, n in zip(factors, norms)]
