"""Binary dimension tree for DT-ALS — port of the binary-tree half of
``pairwise_perturbation_tpu/ops/dimtree.py`` (lines 30-128).

Recursively halve the mode range; each node holds V contracted with all
factors outside its range. Reference: ``Construct_Dimension_Tree``
(common.cxx:225-270) + ``mttkrp_map_DT`` (common.cxx:20-133). Nodes are
built lazily inside a per-sweep memo, so each sweep sees exactly the
reference's cache-freshness semantics (a node built early in the sweep is
*not* rebuilt after later factors update).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

from pairwise_perturbation_tpu_torch.ops import contract


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
    """

    def __init__(self, V, factors: Sequence, root_split: int = None):
        self.V = V
        self.factors = list(factors)
        self.order = V.ndim
        self.parent = binary_parent_map(self.order, root_split)
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
        chain = contract.order_by_priority(
            to_contract, contract.contraction_priority(self.V.shape))
        if (plo, phi) == (0, order - 1) and len(chain) > 1:
            # top-level node from V: one single-consumer chain
            T, _ = contract.fused_partial_mttkrp(self.V, self.factors, chain)
        elif (plo, phi) == (0, order - 1):
            # top-level node one mode away from V: the first-level
            # contraction, where the mid_contract kernel may serve it
            # (JAX dimtree.py:104-121)
            T, _ = contract.first_contraction(self.V, self.factors[chain[0]],
                                              chain[0])
        else:
            T, rem = self.node(plo, phi), tuple(range(plo, phi + 1))
            for m in chain:
                T, rem = contract.contract_mode_kr(T, rem, True,
                                                   self.factors[m], m)
        self._memo[key] = T
        return T

    def mttkrp(self, i: int):
        """M_i from the tree: leaf node (i, i) -> matrix (s_i, R)."""
        return self.node(i, i)
