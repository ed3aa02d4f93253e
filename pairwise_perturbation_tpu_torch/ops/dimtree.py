"""Dimension trees for DT-ALS and the second-gen optimizers — port of
``pairwise_perturbation_tpu/ops/dimtree.py``.

1. **Binary dimension tree** (legacy engine): recursively halve the mode
   range; each node holds V contracted with all factors outside its range.
   Reference: ``Construct_Dimension_Tree`` (common.cxx:225-270) +
   ``mttkrp_map_DT`` (common.cxx:20-133).
2. **Chain (caterpillar) tree** (second-gen optimizers): after a
   first-level contraction V x W[left_index], each node drops one
   position. Reference: ``Construct_Subtree`` / ``Right_Subtree``
   (cp_dt_optimizer.cxx:67-124).

Nodes are built lazily inside a per-sweep memo, so each sweep sees exactly
the reference's cache-freshness semantics (a node built early in the sweep
is *not* rebuilt after later factors update).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

from pairwise_perturbation_tpu_torch.ops import contract
from pairwise_perturbation_tpu_torch.parallel import collectives


def binary_children(lo: int, hi: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    mid = (lo + hi) // 2
    return (lo, mid), (mid + 1, hi)


def binary_parent_map(order: int, root_split: int = None
                      ) -> Dict[Tuple[int, int], Tuple[int, int]]:
    """parent[(lo, hi)] for every non-root node of the binary tree.

    ``root_split``: mode index s ending the root's left child
    ([0, s] / [s+1, order-1]); None = the reference's fixed midpoint
    (common.cxx:252). Deeper levels stay midpoint.
    """
    parent: Dict[Tuple[int, int], Tuple[int, int]] = {}

    def rec(lo: int, hi: int, split: int = None):
        if lo == hi:
            return
        if split is None:
            (l0, l1), (r0, r1) = binary_children(lo, hi)
        else:
            (l0, l1), (r0, r1) = (lo, split), (split + 1, hi)
        parent[(l0, l1)] = (lo, hi)
        parent[(r0, r1)] = (lo, hi)
        rec(l0, l1)
        rec(r0, r1)

    rec(0, order - 1, root_split)
    return parent


class BinaryTreeSweep:
    """Lazy per-sweep node cache for the binary dimension tree.

    ``node(lo, hi)`` returns V contracted (Khatri-Rao-style) with every
    factor outside [lo, hi]; axes = modes lo..hi (ascending) + rank.
    Children of the root are built directly from V (mttkrp_map_DT's
    top-level special case, common.cxx:29-88); deeper nodes from their
    parent. ``factors`` is updated in place by the sweep that owns it.

    ``layout`` (parallel/mesh.py): V and the factors are this rank's
    blocks. Chains are planned on the padded global shape; nodes stay
    partial sums over the sharded modes they contracted, and only a leaf
    M_i is summed, over the axes of the sharded modes other than i.
    """

    def __init__(self, V, factors: Sequence, root_split: int = None,
                 layout=None):
        self.V = V
        self.factors = list(factors)
        self.order = V.ndim
        self.parent = binary_parent_map(self.order, root_split)
        self.layout = layout
        self.priority = contract.contraction_priority(
            contract.plan_shape(V, layout))
        self._memo: Dict[Tuple[int, int], object] = {}

    def node(self, lo: int, hi: int):
        key = (lo, hi)
        if key in self._memo:
            return self._memo[key]
        order = self.order
        if key == (0, order - 1):
            raise ValueError("root node is V itself; query children instead")
        plo, phi = self.parent[key]
        to_contract = [m for m in range(plo, phi + 1) if not lo <= m <= hi]
        chain = contract.order_by_priority(to_contract, self.priority)
        if (plo, phi) == (0, order - 1):
            # top-level node from V: one chain, its first step from the
            # mid_contract kernel on a card (JAX dimtree.py:104-121)
            T = contract.partial_mttkrp(self.V, self.factors, chain)
        else:
            T, rem = self.node(plo, phi), tuple(range(plo, phi + 1))
            for m in chain:
                T, rem = contract.contract_mode_kr(T, rem, True,
                                                   self.factors[m], m)
        self._memo[key] = T
        return T

    def mttkrp(self, i: int):
        """M_i from the tree: leaf node (i, i) -> matrix (s_i, R)."""
        return collectives.reduce_modes([self.node(i, i)], self.layout,
                                        (i,))[0]


# ---------------------------------------------------------------------------
# Chain tree (second-gen DT / MSDT optimizers)
# ---------------------------------------------------------------------------


def chain_tree(n_positions: int):
    """The caterpillar tree over *positions* 0..n_positions-1: (parent,
    contract_pos) dicts keyed by position tuples. ``parent[node]`` is the
    node it is contracted from; ``contract_pos[node]`` is the one position
    whose factor that step applies (Construct_Subtree / Right_Subtree,
    cp_dt_optimizer.cxx:67-124)."""
    parent: Dict[Tuple[int, ...], Tuple[int, ...]] = {}
    contract_pos: Dict[Tuple[int, ...], int] = {}

    def construct(top: Tuple[int, ...]):
        right(top)
        child = top[:-1]
        parent[child] = top
        contract_pos[child] = top[-1]
        if len(child) > 1:
            construct(child)

    def right(top: Tuple[int, ...]):
        child = top[:-2] + (top[-1],)
        parent[child] = top
        contract_pos[child] = top[-2]
        if len(child) > 1:
            right(child)

    construct(tuple(range(n_positions)))
    return parent, contract_pos


class ChainTreeSweep:
    """Lazy node cache for the chain tree of a DT/MSDT optimizer step.

    ``indexes[pos]`` maps tree positions to mode ids (the rotating
    assignment of CPMSDTOptimizer::update_indexes). The top node is the
    first-level contraction V x W[left_index] (mttkrp_map_init,
    cp_msdt_optimizer.cxx:111-144); every other node contracts one more
    factor. Node axes: the remaining positions' modes in *position order*,
    then the rank axis. ``top`` presets the first level (the LR
    optimizers' cached tensor, cp_dt_lr_optimizer.cxx:95-100).

    ``layout`` (parallel/mesh.py): V and the factors are this rank's
    blocks. The top and every inner node stay partial sums over the
    sharded modes they contracted (the top over a sharded hold-out), and
    only a leaf is summed, over the axes of the sharded modes other than
    its own, as :class:`BinaryTreeSweep` sums its leaves.
    """

    def __init__(self, V, factors: Sequence, indexes: Sequence[int],
                 left_index: int, top=None, layout=None):
        self.V = V
        self.factors = list(factors)
        self.indexes = list(indexes)
        self.left_index = left_index
        self.layout = layout
        n = V.ndim - 1
        self.parent, self.contract_pos = chain_tree(n)
        self._top = tuple(range(n))
        self._memo: Dict[Tuple[int, ...], object] = {}
        if top is not None:
            self._memo[self._top] = top

    def _axes_of(self, node: Tuple[int, ...]) -> Tuple[int, ...]:
        return tuple(self.indexes[p] for p in node)

    def top(self):
        """V contracted with W[left_index] through
        :func:`contract.first_contraction`, so a non-minor hold-out goes
        to the mid_contract kernel on a card as the binary tree's
        top-level child does; its axes (remaining modes
        ascending, then rank) are permuted to position order, as a
        view."""
        if self._top not in self._memo:
            T, rem = contract.first_contraction(
                self.V, self.factors[self.left_index], self.left_index)
            perm = [rem.index(m) for m in self._axes_of(self._top)]
            self._memo[self._top] = T.permute(perm + [len(rem)])
        return self._memo[self._top]

    def node(self, node: Tuple[int, ...]):
        if node == self._top:
            return self.top()
        if node not in self._memo:
            par = self.parent[node]
            mode = self.indexes[self.contract_pos[node]]
            # contract_mode_kr only looks axes up by mode id, so position
            # order serves as well as ascending order
            self._memo[node], _ = contract.contract_mode_kr(
                self.node(par), self._axes_of(par), True,
                self.factors[mode], mode)
        return self._memo[node]

    def mttkrp(self, pos: int):
        """M of the mode at tree position ``pos`` (leaf node (pos,))."""
        return collectives.reduce_modes([self.node((pos,))], self.layout,
                                        (self.indexes[pos],))[0]
