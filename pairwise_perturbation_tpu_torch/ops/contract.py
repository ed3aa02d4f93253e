"""Tensor-contraction primitives for CP and Tucker ALS — port of
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
- :func:`ttmc` / :func:`ttmc_contract_mode` <-> ``TTMc`` (als_Tucker.cxx:76-110)
- :func:`build_ttmc_caches` <-> ``Build_ttmc_map`` (als_Tucker.cxx:426-466)
- :func:`mode_gram`         <-> ``unroll_tensor_contraction`` (common.cxx:205-223)

Functions are plain and eager on the tensors' own device. Where the JAX
package writes one multi-operand einsum and lets opt_einsum choose the
pairwise order, the port contracts one factor at a time in the global
:func:`contraction_priority` order (largest mode first): PyTorch's einsum
path depends on whether opt_einsum is installed, and contracting a small
mode of a large V first would materialize an intermediate many times V's
size. The order changes results by round-off only.

On a block-sharded V (parallel/mesh.py) the functions that take
``layout=`` run on this rank's block and factor blocks and sum their
partials through the mesh's reduction hooks: a contraction over a sharded
mode at the result (an MTTKRP, a TTMc, a corrected PP term), a sum over
the rows of a sharded factor at the small result (a Gram, a norm, an
inner product). They plan the contraction order on the padded global
shape, never the block's, so the order (and the rounding) is the
unsharded run's. ``layout=None`` is the unsharded function, unchanged.

The first contraction of V over a mode that is not its last is where a
chain's time goes on a card: ``torch.einsum`` copies V into the permuted
order before its GEMM. So the first step of every chain on V
(:func:`first_contraction`, rank-minor, for :func:`partial_mttkrp` and the
tree tops; :func:`_first_contraction_rm`, rank-major, for the PP cache
roots) is one decision, :func:`_kernel_first`: the hand-written
``mid_contract`` kernel, which reads V once in place, where a card admits
the call, and the einsum on V everywhere else, the CPU included. The
counters ``contract.first_kernel`` and ``contract.first_einsum``
(utils/tracing) count which of the two served each.

Every later step of a chain on a card meets the same copy: the einsum of
:func:`contract_mode_kr` on a rank-minor intermediate (and of a rank-major
cache chain's step over a middle mode) copies the intermediate into
(rank, kept, contracted) order before its batched GEMV. So each such step
on CUDA float32 operands goes to the hand-written ``chain_step`` kernel,
which reads the intermediate once in place, wherever :func:`_kernel_step`
admits it; ``contract.step_kernel`` and ``contract.step_einsum`` count
which served each. CPU tensors keep the einsum.
"""

from __future__ import annotations

import functools as _functools
import string
from typing import Dict, Sequence, Tuple

import torch

from pairwise_perturbation_tpu_torch import config
from pairwise_perturbation_tpu_torch.ops.kernels import (chain_step,
                                                         mid_contract)
from pairwise_perturbation_tpu_torch.parallel import collectives
from pairwise_perturbation_tpu_torch.utils import tracing

# Mode axes use lowercase letters; rank axes are uppercase.
_MODES = string.ascii_lowercase
_RANK = "Z"
_RANK2 = "Y"
# entries of one torch.dot at most (norm_sq)
DOT_MAX = 1 << 30
# counter of the first-level reads of V: a chain's first contraction, a
# fused order-3 MTTKRP, the triple roots' one pass
V_READS = "contract.v_reads"


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


def plan_shape(V, layout):
    """The shape contractions are planned on: V's own, or the padded
    global shape of a sharded V."""
    return tuple(V.shape) if layout is None else layout.padded_shape


def norm_sq(V, layout=None):
    """||V||^2, accumulated in float32 for bf16 V, else in V's dtype;
    summed over the ranks' blocks under ``layout``. A dot takes at most
    DOT_MAX entries (cuBLAS counts them in 32 bits), so a larger V is
    summed as the dots of its consecutive pieces; one piece, as any V
    up to that size is, is the one dot of the whole."""
    v = V.reshape(-1)
    total = None
    for piece in v.split(DOT_MAX):
        if piece.dtype == torch.bfloat16:
            piece = piece.float()
        d = torch.dot(piece, piece)
        total = d if total is None else total + d
    return collectives.reduce_modes([total], layout)[0]


# ---------------------------------------------------------------------------
# CP primitives
# ---------------------------------------------------------------------------


def mttkrp(V, factors: Sequence, mode: int, layout=None):
    """Exact MTTKRP for ``mode``: M[i_mode, r] = sum V * prod_{j != mode} W_j.

    Routes as the JAX package does (contract.py:109-128): an order-3
    float32 V with ``config.get().use_kernels`` goes to the fused kernel
    module, which launches its CUDA kernel for a CUDA tensor and runs its
    plain version for a CPU one; everything else (other orders, float64)
    is the priority-ordered chain of :func:`partial_mttkrp`, whose first
    step takes the mid_contract kernel on a card. The fused kernel takes
    contiguous operands only and factors may arrive as views (a transpose,
    for example), so they are made contiguous first: no copy for a
    contiguous factor, at most an (n, R) one otherwise.

    bf16 V: the JAX package writes one einsum, which rounds every factor
    to bf16; the chain therefore rounds them all, not only the first.

    ``layout``: V and the factors are this rank's blocks; the result is
    this rank's row block, summed over the axes of the other sharded
    modes (one all_reduce).
    """
    order = V.ndim
    if takes_mttkrp3(V):
        from pairwise_perturbation_tpu_torch.ops.kernels import mttkrp3
        tracing.count(V_READS)
        M = mttkrp3.mttkrp3_mode(V.contiguous(),
                                 [W.contiguous() for W in factors], mode)
    else:
        if V.dtype == torch.bfloat16:
            factors = [W.to(torch.bfloat16).float() for W in factors]
        others = (m for m in range(order) if m != mode)
        M = partial_mttkrp(V, factors, order_by_priority(
            others, contraction_priority(plan_shape(V, layout))))
    return collectives.reduce_modes([M], layout, (mode,))[0]


def takes_mttkrp3(V) -> bool:
    """Whether :func:`mttkrp` serves V from the fused order-3 kernel
    module (K1-K3, one read of V a mode): an order-3 float32 V under
    ``config.get().use_kernels``."""
    return config.get().use_kernels and V.ndim == 3 and \
        V.dtype == torch.float32


def contract_mode_kr(T, rem_modes: Tuple[int, ...], has_rank: bool, factor,
                     mode: int):
    """Contract one mode of a partial-MTTKRP intermediate with a factor.

    ``T`` has axes ``rem_modes`` (original mode ids, ascending) plus a
    trailing rank axis when ``has_rank``. Contracting mode ``m`` with
    W_m[s_m, R] removes that axis, Khatri-Rao-style (diagonal in the rank
    axis once it exists) — the reference's chain step V["acd*"] * W["d*"]
    (als_CP.cxx:383-384). With ``has_rank`` the step comes from the
    chain_step kernel where :func:`_kernel_step` takes it.
    """
    pos = rem_modes.index(mode)
    if has_rank:
        out = _kernel_step(T, factor, pos)
        if out is not None:
            return out, rem_modes[:pos] + rem_modes[pos + 1:]
    letters = _MODES[:len(rem_modes)]
    t_spec = letters + (_RANK if has_rank else "")
    out_spec = letters[:pos] + letters[pos + 1:] + _RANK
    out = _einsum(f"{t_spec},{letters[pos]}{_RANK}->{out_spec}", T, factor)
    return out, rem_modes[:pos] + rem_modes[pos + 1:]


def _on_card(V, factor) -> bool:
    """Whether the mid_contract kernel takes V and the factor: V on a CUDA
    device in float32 or bfloat16, the factor in float32. The CPU tests
    patch it to admit the CPU, where the kernel module runs its plain
    version."""
    return V.is_cuda and V.dtype in (torch.float32, torch.bfloat16) \
        and factor.dtype == torch.float32


def _kernel_first(V, factor, mode: int, layout: str = "rank_minor"):
    """V x_mode W over a non-minor ``mode`` from the mid_contract kernel in
    ``layout`` (its rank-last view), or None where the einsum is to serve
    it. The kernel takes it on a card (:func:`_on_card`) from a contiguous
    V whose launch ``mid_contract.route_admits``. Counts the call as
    ``contract.first_kernel`` or ``contract.first_einsum``."""
    if not (_on_card(V, factor) and V.is_contiguous() and
            mid_contract.route_admits(V, factor.shape[1], mode, layout)):
        tracing.count("contract.first_einsum")
        return None
    tracing.count("contract.first_kernel")
    return mid_contract.mid_contract(V, factor.contiguous(), mode, layout)


def _step_on_card(T, factor) -> bool:
    """Whether the chain_step kernel takes the intermediate T and the
    factor: both float32 on a CUDA device. The CPU tests patch it to admit
    the CPU, where the kernel module runs its plain version."""
    return T.is_cuda and T.dtype == torch.float32 \
        and factor.dtype == torch.float32


def _kernel_step(T, factor, pos: int, layout: str = "rank_minor"):
    """One chain step of the rank-carrying T over mode axis ``pos`` from
    the chain_step kernel in T's ``layout``, or None where the einsum is
    to serve it. The kernel takes it on a card (:func:`_step_on_card`)
    from a contiguous T whose launch ``chain_step.route_admits``. Counts
    the call as ``contract.step_kernel`` or ``contract.step_einsum``."""
    if _step_on_card(T, factor) and T.is_contiguous() and \
            chain_step.route_admits(T, factor.shape[1], pos, layout):
        tracing.count("contract.step_kernel")
        return chain_step.chain_step(T, factor.contiguous(), pos, layout)
    tracing.count("contract.step_einsum")
    return None


def first_contraction(V, factor, mode: int):
    """V x_m W_m, the first step of a chain on V (Khatri-Rao first level):
    what ``contract_mode_kr(V, all modes, False, factor, mode)`` computes,
    output axes the remaining modes ascending + rank, from the mid_contract
    kernel where :func:`_kernel_first` takes it (JAX contract.py:266-288
    routes the same step)."""
    tracing.count(V_READS)
    rem = tuple(m for m in range(V.ndim) if m != mode)
    if mode < V.ndim - 1:
        T = _kernel_first(V, factor, mode)
        if T is not None:
            return T, rem
    return contract_mode_kr(V, tuple(range(V.ndim)), False, factor, mode)


def partial_mttkrp(V, factors: Sequence, contract_modes: Sequence[int]):
    """Chain-contract ``V`` with the factors of ``contract_modes`` (in order).

    Returns a tensor whose axes are the remaining modes (ascending original
    order) followed by the rank axis. With all-but-one mode contracted this
    is the exact MTTKRP; with all-but-two it is a PP pair cache. The first
    step is :func:`first_contraction`.
    """
    modes = tuple(contract_modes)
    if not modes:
        return V
    T, rem = first_contraction(V, factors[modes[0]], modes[0])
    for m in modes[1:]:
        T, rem = contract_mode_kr(T, rem, True, factors[m], m)
    return T


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


def _first_contraction_rm(V, factor, mode: int):
    """First-level contraction producing a RANK-MAJOR intermediate
    (R, remaining modes ascending), the convention of the PP cache chains
    (JAX contract.py:322-339): over a non-minor mode from the mid_contract
    kernel's rank-outer layout (:func:`_kernel_first`), which is this
    tensor physically, where it takes the call; else the einsum on V."""
    tracing.count(V_READS)
    order = V.ndim
    rem = tuple(m for m in range(order) if m != mode)
    if mode < order - 1:
        T = _kernel_first(V, factor, mode, "rank_outer")
        if T is not None:
            return T.movedim(-1, 0), rem
    letters = _MODES[:order]
    out = letters[:mode] + letters[mode + 1:]
    spec = f"{letters},{letters[mode]}{_RANK}->{_RANK}{out}"
    return _einsum(spec, V, factor), rem


def _contract_mode_kr_rm(T, rem_modes: Tuple[int, ...], factor, mode: int):
    """One Khatri-Rao chain step on a rank-major intermediate
    (R, rem_modes...) -> (R, rem_modes without mode). Over a middle mode,
    where the einsum would copy T, from the chain_step kernel where
    :func:`_kernel_step` takes it; over the first or the last mode the
    einsum's batched GEMM reads T in place, and counts in neither
    counter."""
    pos = rem_modes.index(mode)
    if 0 < pos < len(rem_modes) - 1:
        out = _kernel_step(T, factor, pos, "rank_major")
        if out is not None:
            return out, rem_modes[:pos] + rem_modes[pos + 1:]
    letters = _MODES[:len(rem_modes)]
    out_spec = _RANK + letters[:pos] + letters[pos + 1:]
    out = _einsum(f"{_RANK}{letters},{letters[pos]}{_RANK}->{out_spec}",
                  T, factor)
    return out, rem_modes[:pos] + rem_modes[pos + 1:]


def build_pp_caches(V, factors: Sequence, shape=None):
    """Build all PP caches: pair tensors T_{ij}[R, s_i, s_j] (rank-major)
    for i<j and single matrices M_i[s_i, R].

    Mirrors the reference's ``Build_mttkrp_map`` calls over all (ii, jj)
    pairs then all singles (als_CP.cxx:676-694), including the memoized
    prefix reuse (als_CP.cxx:385-389): cache keys are the *contracted* mode
    tuples; a chain sharing a prefix reuses the prefix intermediate.
    Chains follow :func:`contraction_priority` and run rank-major, as in
    the JAX package (contract.py:357-442), each root from
    :func:`_first_contraction_rm`.

    With ``config.get().use_kernels_triple``, an order-4 V whose axis 0
    is the smallest mode roots every chain at axis 1, 2 or 3; when
    ``triple_roots_eligible`` admits it, the three roots come from one
    pass over V (contract.py:392-405).

    ``shape``: the shape the chains are planned on (default V's; a
    sharded V's block passes the padded global shape, and
    parallel/mesh.constrained_pp_caches sums the partials).
    """
    order = V.ndim
    priority = contraction_priority(V.shape if shape is None else shape)
    memo: Dict[Tuple[int, ...], Tuple] = {}
    if config.get().use_kernels_triple and order == 4 and \
            priority[-1] == 0:
        from pairwise_perturbation_tpu_torch.ops.kernels import triple_roots
        if triple_roots.triple_roots_eligible(V.shape, V.dtype,
                                              factors[0].shape[1]):
            o1, o2, o3 = triple_roots.triple_roots(
                V.contiguous(), *(W.contiguous() for W in factors[1:]))
            tracing.count("contract.first_kernel", 2)  # modes 1 and 2
            tracing.count(V_READS)
            memo[(1,)] = (o1, (0, 2, 3))
            memo[(2,)] = (o2, (0, 1, 3))
            memo[(3,)] = (o3, (0, 1, 2))

    def get(key: Tuple[int, ...]):
        # prefix by prefix, not by recursion: a closure that calls itself
        # is a reference cycle, which would keep the memo's intermediates
        # (a first level is R/s_m of V) allocated after the build returns,
        # until the garbage collector ran
        for n in range(1, len(key) + 1):
            k = key[:n]
            if k in memo:
                continue
            if n == 1:
                memo[k] = _first_contraction_rm(V, factors[k[0]], k[0])
            else:
                T, rem = memo[k[:-1]]
                memo[k] = _contract_mode_kr_rm(T, rem, factors[k[-1]], k[-1])
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


def _corrected(base, terms, layout):
    """``base`` plus the (term, j) ``terms``, added in order. Under
    ``layout`` a term over a sharded mode j is a partial over j's axis:
    the terms are reduced first, one all_reduce per axis for all of them
    (each axis carries one mode), so the additions keep the unsharded
    order."""
    for t in collectives.reduce_parts([(t, (j,)) for t, j in terms],
                                      layout):
        base = base + t
    return base


def pp_correct_mttkrp(single_i, pair, dWs: Sequence, i: int, layout=None):
    """First-order PP-corrected MTTKRP for mode ``i``:

    M~_i = M_i + sum_{j<i} T_{ji} x_j dW_j + sum_{j>i} T_{ij} x_j dW_j

    Reference: als_CP.cxx:778-794. ``pair[(a, b)]`` is rank-major with
    axes (R, s_a, s_b) — see :func:`build_pp_caches`. ``layout``: the
    terms over sharded modes are summed over their axes.
    """
    def terms():
        for j in range(len(dWs)):
            if j < i:
                yield _einsum("Zab,aZ->bZ", pair[(j, i)], dWs[j]), j
            elif j > i:
                yield _einsum("Zab,bZ->aZ", pair[(i, j)], dWs[j]), j
    return _corrected(single_i, terms(), layout)


def gram(W):
    """W^T W (R x R)."""
    return W.T @ W


def hadamard_gram(factors: Sequence, skip_mode: int = -1, regul=None,
                  layout=None):
    """S = Hadamard product of W_j^T W_j over j != skip_mode (+ lambda I).

    Reference: S["ij"] = prod (W[idx]["ki"] W[idx]["kj"]) (+ regul)
    (als_CP.cxx:573-578). ``layout``: the Grams of row-sharded factors
    are summed over their axes (one all_reduce per axis).
    """
    modes = [j for j in range(len(factors)) if j != skip_mode]
    S = None
    for G in collectives.row_sum([gram(factors[j]) for j in modes], modes,
                                 layout):
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


def cp_gradient(V, factors: Sequence, regul=None, layout=None):
    """Full CP gradient for all modes: grad_i = -M_i + W_i S_i, from a
    fresh :func:`mttkrp` per mode.

    Reference: ``gradient_CP`` (common.cxx:1009-1052). ``layout``: each
    grad is this rank's row block.
    """
    return gradients_from([mttkrp(V, factors, i, layout=layout)
                           for i in range(len(factors))], factors, regul,
                          layout)


def gradients_from(Ms: Sequence, factors: Sequence, regul=None,
                   layout=None):
    """grad_i = -M_i + W_i S_i of every mode from its exact MTTKRP
    ``Ms[i]``: the one formula of :func:`cp_gradient` and the
    diagnostics rows (models/cp.py), which take their Ms from a
    dimension tree."""
    return [gradsubprob(M, hadamard_gram(factors, skip_mode=i, regul=regul,
                                         layout=layout), factors[i])
            for i, M in enumerate(Ms)]


def gradsubprob(M, S, W):
    """grad = -M + W S (common.cxx:1002-1004)."""
    return -M + W @ S


def gradnorm_from(Ms: Sequence, factors: Sequence, regul=None, layout=None):
    """EXACT CP gradient norm sqrt(sum_i ||-M_i + W_i S_i||^2) from the
    exact MTTKRPs ``Ms`` (:func:`gradients_from`), the JAX package's
    ``cp_gradnorm`` (contract.py:534-546) given its MTTKRPs; ``layout``:
    the squares summed over the ranks' rows."""
    sq = [torch.sum(g * g)
          for g in gradients_from(Ms, factors, regul, layout)]
    return torch.sqrt(sum(collectives.row_sum(sq, range(len(sq)), layout)))


def cp_residual_norm(V_norm_sq, M_last, factors: Sequence, layout=None):
    """|| V - [[W_1 .. W_N]] ||_F via the norm identity:

    ||V - Vhat||^2 = ||V||^2 - 2 <M_N, W_N> + 1^T (hadamard of all Grams) 1

    where M_N is the *exact* MTTKRP of the last mode (one MTTKRP, no
    O(s^N) temporary). ``layout``: the inner product and the Grams are
    summed over the ranks' rows.
    """
    inner = collectives.row_sum([torch.sum(M_last * factors[-1])],
                                [len(factors) - 1], layout)[0]
    vhat_sq = torch.sum(hadamard_gram(factors, skip_mode=-1, layout=layout))
    return torch.sqrt(torch.clamp(V_norm_sq - 2.0 * inner + vhat_sq, min=0.0))


def cp_residual_exact(V, factors: Sequence):
    """Exact reconstruction residual (test oracle)."""
    return torch.linalg.vector_norm(V - build_dense(factors))


def factor_norms(factors: Sequence, layout=None, modes=None, sums=()):
    """The Frobenius norms of ``factors`` (``factors[k]`` of mode
    ``modes[k]``, default k), then the ``sums`` ((tensor, mode) pairs:
    sums over the rows of that mode's factor), as one list. Under
    ``layout`` a sharded mode's norm is of the whole factor: the root of
    the ranks' squared block norms summed; the squares and ``sums``
    travel in one buffer per axis."""
    modes = range(len(factors)) if modes is None else list(modes)
    norms = [torch.linalg.vector_norm(W) for W in factors]
    idx = [k for k, m in enumerate(modes)
           if collectives.is_sharded(layout, m)]
    red = collectives.reduce_parts([(norms[k] * norms[k], (modes[k],))
                                    for k in idx]
                                   + [(t, (m,)) for t, m in sums], layout)
    for k, sq in zip(idx, red):
        norms[k] = torch.sqrt(sq)
    return norms + red[len(idx):]


def normalize_factors(factors: Sequence, layout=None):
    """Rebalance all factor Frobenius norms to their geometric mean.

    Reference: ``Normalize`` (common.cxx:680-689).
    """
    norms = factor_norms(factors, layout)
    target = torch.prod(torch.stack(norms)) ** (1.0 / len(factors))
    return [W * (target / n) for W, n in zip(factors, norms)]


# ---------------------------------------------------------------------------
# Tucker primitives
# ---------------------------------------------------------------------------


def ttmc_contract_mode(T, factor, axis: int, transpose: bool = False):
    """Contract one mode of ``T`` with a factor, keeping axis positions:
    ``factor`` is (s, r) and the axis of length s becomes length r (the
    reverse with ``transpose``). One step of ``TTMc``
    (als_Tucker.cxx:95-108). With bf16 ``T`` (V itself) the factor is
    rounded to bf16 too, by :func:`_einsum`'s rule."""
    letters = _MODES[:T.ndim]
    f_spec = (letters[axis] + _RANK) if not transpose \
        else (_RANK + letters[axis])
    out_spec = letters[:axis] + _RANK + letters[axis + 1:]
    return _einsum(f"{letters},{f_spec}->{out_spec}", T, factor)


def ttmc(V, factors: Sequence, skip_mode: int = -1, transpose: bool = False,
         layout=None):
    """Tensor-times-matrix chain over every mode except ``skip_mode``
    (-1 contracts them all: the core). With ``transpose`` the factors map
    rank -> size (reconstruction, als_Tucker.cxx:303).

    One factor at a time in :func:`contraction_priority` order, where the
    JAX package writes one einsum. That einsum rounds every factor to
    bf16 when V is bf16 (contract.py:54-78), so here every factor is
    rounded before the chain, as :func:`mttkrp` does; the dimension-tree
    and cache chains (:func:`ttmc_contract_mode` step by step) round only
    the first. ``layout``: summed over the axes of the sharded modes it
    contracted (the core, ``skip_mode=-1``, over every axis)."""
    if V.dtype == torch.bfloat16:
        factors = [W.to(torch.bfloat16).float() for W in factors]
    T = V
    modes = (m for m in range(V.ndim) if m != skip_mode)
    for m in order_by_priority(modes,
                               contraction_priority(plan_shape(V, layout))):
        T = ttmc_contract_mode(T, factors[m], m, transpose)
    return collectives.reduce_modes([T], layout, (skip_mode,))[0]


def build_ttmc_caches(V, factors: Sequence, shape=None):
    """Tucker PP caches: pair tensors (modes i, j uncontracted) and single
    tensors (mode i uncontracted), axis positions preserved (contracted
    axes rank-sized). Every pair and then every single, as
    ``Build_ttmc_map`` (als_Tucker.cxx:744-760), each a chain in
    :func:`contraction_priority` order memoized on its contracted prefix
    (JAX contract.py:632-663), planned on ``shape`` (default V's; see
    :func:`build_pp_caches`)."""
    order = V.ndim
    priority = contraction_priority(V.shape if shape is None else shape)
    memo: Dict[Tuple[int, ...], object] = {(): V}

    def get(key: Tuple[int, ...]):
        # prefix by prefix, not by recursion (see build_pp_caches)
        for n in range(1, len(key) + 1):
            if key[:n] not in memo:
                memo[key[:n]] = ttmc_contract_mode(memo[key[:n - 1]],
                                                   factors[key[n - 1]],
                                                   key[n - 1])
        return memo[key]

    pair = {}
    for i in range(order):
        for j in range(i + 1, order):
            pair[(i, j)] = get(order_by_priority(
                (m for m in range(order) if m not in (i, j)), priority))
    single = {i: get(order_by_priority(
        (m for m in range(order) if m != i), priority))
        for i in range(order)}
    return single, pair


def pp_correct_ttmc(single_i, pair, dWs: Sequence, i: int, layout=None):
    """First-order PP-corrected TTMc of mode ``i``:
    Y~_i = Y_i + sum_{j != i} cache_{ij} x_j dW_j (als_Tucker.cxx:835-859);
    ``layout``: the terms over sharded modes are summed over their axes."""
    terms = ((ttmc_contract_mode(pair[(min(i, j), max(i, j))], dWs[j], j), j)
             for j in range(len(dWs)) if j != i)
    return _corrected(single_i, terms, layout)


def mode_gram(T, axis: int):
    """Gram matrix of the mode-``axis`` unfolding, T_(i) T_(i)^T
    (``unroll_tensor_contraction``, common.cxx:205-223)."""
    letters = _MODES[:T.ndim]
    a_spec = letters[:axis] + _RANK + letters[axis + 1:]
    b_spec = letters[:axis] + _RANK2 + letters[axis + 1:]
    return _einsum(f"{a_spec},{b_spec}->{_RANK}{_RANK2}", T, T)


def tucker_residual_norm(V_norm_sq, core_exact, core):
    """|| V - core x_i W_i || for orthonormal W by the norm identity
    ||V||^2 - 2 <TTMc(V, W), core> + ||core||^2 (replaces the
    reconstruction at als_Tucker.cxx:296-311); ``core_exact`` is
    TTMc(V, W, -1) at the current factors."""
    inner = torch.sum(core_exact * core)
    core_sq = torch.sum(core * core)
    return torch.sqrt(torch.clamp(V_norm_sq - 2.0 * inner + core_sq,
                                  min=0.0))


def fold_unfold(X, shape):
    """Reshape in row-major element order (``fold_unfold``,
    common.cxx:870-880)."""
    return X.reshape(shape)
