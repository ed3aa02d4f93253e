"""A CP diagnostics row's MTTKRPs from one dimension tree
(models/cp.cp_diagnostics): all N are taken at the same factors, so one
binary tree (ops/dimtree.BinaryTreeSweep at the engine's root split)
gives them from two first-level reads of V, its leaf N-1 serving diffV's
norm identity. An order-3 float32 V on contract.mttkrp's fused route
(K1-K3) keeps a kernel a mode and reuses its mode-2 result.

Held here: the tree row against the JAX package's ``cp_diagnostics``
(the reference) and against the port's per-mode chain formula (a fresh
contract.mttkrp a mode into contract.gradnorm_from, the last mode's once
more for contract.cp_residual_norm), in float64 to 1e-10 relative, at
orders 3 to 6, with and without regularisation, at the midpoint and
another root split, and on a block-sharded V over two ranks (each rank a
thread of this process, the mesh's all_reduce a sum in rank order), each
rank's row against the reference's on the whole V; the counter
``cp.diag_v_reads``, which counts the reads of V the row's contractions
make, and its reader ``diag_v_reads_per_row``; and CP-DT and CP-PP fits
that log the per-mode formula's rows, each as close to the reference's
row at its iterate as that formula's.
"""

import copy
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark import run as brun
from pairwise_perturbation_tpu.models import cp as jcp
from pairwise_perturbation_tpu_torch.models import cp
from pairwise_perturbation_tpu_torch.ops import contract as tc
from pairwise_perturbation_tpu_torch.ops import dimtree
from pairwise_perturbation_tpu_torch.ops.kernels import mttkrp3
from pairwise_perturbation_tpu_torch.parallel import collectives
from pairwise_perturbation_tpu_torch.parallel import mesh as pmesh
from pairwise_perturbation_tpu_torch.utils import synth, tracing

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
F64 = 1e-10
SHAPES = {3: (5, 6, 4), 4: (3, 8, 6, 7), 5: (3, 4, 5, 4, 3),
          6: (3, 3, 4, 3, 2, 3)}
# a root split other than the midpoint ((order - 1) // 2) at each order
OTHER_SPLIT = {3: 0, 4: 2, 5: 1, 6: 3}
R = 3
RANKS = 2


def _inputs(shape, dtype=torch.float64, seed=0):
    gen = torch.Generator().manual_seed(seed)
    V = torch.randn(shape, generator=gen, dtype=torch.float64).to(dtype)
    Ws = [torch.randn((s, R), generator=gen, dtype=torch.float64).to(dtype)
          for s in shape]
    return V, Ws


def _chain_row(V, Ws, lam, layout=None):
    """The row as the port's per-mode chains compute it: a fresh MTTKRP a
    mode for the gradnorm, and the last mode's once more for diffV."""
    vn = tc.norm_sq(V, layout)
    Ms = [tc.mttkrp(V, Ws, i, layout=layout) for i in range(V.ndim)]
    gn = tc.gradnorm_from(Ms, Ws, regul=lam, layout=layout)
    M_last = tc.mttkrp(V, Ws, V.ndim - 1, layout=layout)
    return gn, tc.cp_residual_norm(vn, M_last, Ws, layout)


def _jax_row(V, Ws, lam):
    """The reference's row: the JAX package's cp_diagnostics on the same
    values, in their dtype, as torch scalars."""
    jV = jnp.asarray(V.numpy())
    jW = [jnp.asarray(W.numpy()) for W in Ws]
    gn, dv = jcp.cp_diagnostics(jnp.sum(jV * jV), jV, jW, lam)
    return (torch.tensor(float(gn), dtype=V.dtype),
            torch.tensor(float(dv), dtype=V.dtype))


def _tree_row(V, Ws, lam, split, layout=None):
    return cp.cp_diagnostics(tc.norm_sq(V, layout), V, Ws, lam, layout,
                             split)


def _rel(got, want):
    return float(abs(got - want) / abs(want))


class _Group:
    """The ranks' threads: an all_reduce deposits each rank's buffer,
    sums them in rank order (the same sum on every rank) and copies it
    back."""

    def __init__(self, n):
        self.bufs = [None] * n
        self.barrier = threading.Barrier(n, timeout=60)
        self.rank = threading.local()

    def reduce(self, buf):
        self.bufs[self.rank.r] = buf.clone()
        self.barrier.wait()
        total = self.bufs[0].clone()
        for b in self.bufs[1:]:
            total += b
        self.barrier.wait()
        buf.copy_(total)


class _Mesh:
    """What the layout and the hooks read of a (n,) mesh at rank r."""
    mesh_dim_names = ("x",)

    def __init__(self, n, r, group):
        self.shape, self._r, self._group = (n,), r, group

    def get_coordinate(self):
        return [self._r]

    def get_group(self, axis):
        return self._group


def _on_ranks(fn, monkeypatch, n=RANKS):
    """``fn(mesh)`` on n ranks, each a thread with its own (n,) mesh;
    the results in rank order."""
    group = _Group(n)
    monkeypatch.setattr(collectives, "_reduce_buffer",
                        lambda buf, g: g.reduce(buf))
    out, errors = [None] * n, []

    def rank(r):
        group.rank.r = r
        try:
            out[r] = fn(_Mesh(n, r, group))
        except Exception as e:          # raised below, once all stopped
            errors.append(e)
            group.barrier.abort()

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    return out


CASES = [(order, lam, split, False) for order in sorted(SHAPES)
         for lam in (0.0, 0.1) for split in ("midpoint", "other")] + \
    [(4, 0.1, "other", True), (6, 0.0, "midpoint", True)]


@pytest.mark.parametrize("order,lam,split,sharded", CASES)
def test_tree_row_matches_the_chain_formula(order, lam, split, sharded,
                                            monkeypatch):
    """(gradnorm, diffV) of the tree row equal the JAX package's
    cp_diagnostics and the port's per-mode chain formula in float64 to
    1e-10 relative, two reads of V counted; on a block-sharded V (mode 0
    split over two ranks and padded) every rank reads the same numbers,
    the reference's on the whole V."""
    shape = SHAPES[order]
    root = None if split == "midpoint" else OTHER_SPLIT[order]
    V, Ws = _inputs(shape)
    ref = _jax_row(V, Ws, lam)
    if not sharded:
        tracing.reset()
        got = _tree_row(V, Ws, lam, root)
        assert tracing.stats()["cp.diag_v_reads"][0] == 2
        assert all(_rel(g, w) <= F64 for g, w in zip(got, ref))
        want = _chain_row(V, Ws, lam)
        assert all(_rel(g, w) <= F64 for g, w in zip(got, want))
        return

    def rank(mesh):
        layout = pmesh.plan_layout(shape, mesh, modes=(0,))
        Vb = pmesh.shard_tensor(V, layout)
        Wb = pmesh.shard_factors(Ws, layout)
        return (_tree_row(Vb, Wb, lam, root, layout),
                _chain_row(Vb, Wb, lam, layout), layout.padded_shape)

    res = _on_ranks(rank, monkeypatch)
    assert res[0][2][0] > shape[0]              # mode 0 padded
    for got, want, _ in res:
        assert all(_rel(g, w) <= F64 for g, w in zip(got, ref))
        assert all(_rel(g, w) <= F64 for g, w in zip(got, want))
        assert all(torch.equal(g, h) for g, h in zip(got, res[0][0]))


def _tree_a_leaf(monkeypatch):
    """Each leaf of a row from a tree of its own, so that every leaf
    reads V anew: N reads, the same numbers."""
    real = dimtree.BinaryTreeSweep.mttkrp

    def fresh(self, i):
        tree = copy.copy(self)
        tree._memo = {}
        return real(tree, i)

    monkeypatch.setattr(dimtree.BinaryTreeSweep, "mttkrp", fresh)


@pytest.mark.parametrize("shape,dtype,reads,leaf_trees", [
    ((5, 6, 4), torch.float32, 3, False),
    ((5, 6, 4), torch.float64, 2, False),
    ((3, 8, 6, 7), torch.float32, 2, False),
    ((3, 4, 5, 4, 3), torch.float32, 2, False),
    ((3, 8, 6, 7), torch.float32, 4, True),
    ((3, 4, 5, 4, 3), torch.float64, 5, True)])
def test_row_counts_its_reads_of_v(shape, dtype, reads, leaf_trees,
                                   monkeypatch):
    """``cp.diag_v_reads`` counts the reads of V that the row's
    contractions make (``contract.v_reads`` while it ran): 2 a row on
    the tree, 3 on the order-3 fused route, whose kernel module is called
    once a mode (no duplicate for diffV) and gives the per-mode formula's
    row bit for bit, and N where every leaf rebuilds its top node."""
    V, Ws = _inputs(shape, dtype)
    if leaf_trees:
        _tree_a_leaf(monkeypatch)
    calls = []
    real = mttkrp3.mttkrp3_mode
    monkeypatch.setattr(mttkrp3, "mttkrp3_mode",
                        lambda *a: calls.append(a[2]) or real(*a))
    tracing.reset()
    tracing.count(tc.V_READS, 7)            # reads before the row
    got = _tree_row(V, Ws, 0.0, None)
    assert tracing.stats()["cp.diag_v_reads"][0] == reads
    assert tracing.stats()[tc.V_READS][0] == 7 + reads
    assert calls == ([0, 1, 2] if len(shape) == 3 and
                     dtype == torch.float32 else [])
    want = _chain_row(V, Ws, 0.0)
    if len(calls):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    else:
        tol = F64 if dtype == torch.float64 else 1e-5
        assert all(_rel(g, w) <= tol for g, w in zip(got, want))


def _collinear(shape, rank, seed):
    Ws, lams = synth.gen_collinearity_factors(
        shape, rank, 0.5, 0.9, np.random.default_rng(seed))
    Ws[0] = Ws[0] * lams
    V = tc.build_dense([torch.from_numpy(W) for W in Ws]).float()
    gen = torch.Generator().manual_seed(seed)
    V = V + 0.01 * V.norm() / V.numel() ** 0.5 * torch.randn(
        V.shape, generator=gen)
    return V, cp.init_factors(shape, rank, seed=seed, device="cpu",
                              dtype=torch.float32)


def _per_mode_diagnostics(V_norm_sq, V, Ws, lam=None, layout=None,
                          root_split=None):
    return _chain_row(V, list(Ws), lam, layout)


@pytest.mark.parametrize("engine", ["als_cp_dt", "als_cp_pp"])
def test_fit_logs_the_chain_formulas_rows(engine, monkeypatch):
    """A CP-DT and a CP-PP fit in float32 on a small collinear tensor
    (split 2, as the coil cells plan it): the same sweeps and rows as
    with the per-mode chain formula, each row's gradnorm and diffV
    within float32 round-off of ||V||; and at each row's iterate the
    tree row is as close to the reference's (the JAX package's
    cp_diagnostics in float64 on the same float32 values) as the
    per-mode formula's row is, to that round-off."""
    V, Ws = _collinear((4, 9, 8, 30), 3, seed=5)
    vnorm = float(V.norm())
    cfg = cp.CPConfig(tol=1e-3 * vnorm, pp_res_tol=0.05, maxiter=150,
                      resprint=5, tree_split=2)
    solve = getattr(cp, engine)
    tree_row, seen = cp.cp_diagnostics, []

    def beside(V_norm_sq, V, Ws, lam=None, layout=None, root_split=None):
        got = tree_row(V_norm_sq, V, Ws, lam, layout, root_split)
        seen.append((got, _chain_row(V, list(Ws), lam, layout),
                     _jax_row(V.double(), [W.double() for W in Ws], lam)))
        return got

    monkeypatch.setattr(cp, "cp_diagnostics", beside)
    tracing.reset()
    got = solve(V, list(Ws), cfg)
    stats = tracing.stats()
    assert stats["cp.diag_v_reads"][0] == 2 * len(got.history)
    assert len(seen) == len(got.history)
    for row, chain, ref in seen:
        for g, c, r in zip(row, chain, ref):
            assert abs(float(g) - float(r)) <= \
                abs(float(c) - float(r)) + 1e-6 * vnorm, (row, chain, ref)
    monkeypatch.setattr(cp, "cp_diagnostics", _per_mode_diagnostics)
    want = solve(V, list(Ws), cfg)
    assert got.converged and want.converged
    assert got.iters == want.iters
    assert [(h["iter"], h["pp"]) for h in got.history] == \
        [(h["iter"], h["pp"]) for h in want.history]
    if engine == "als_cp_pp":
        assert any(h["pp"] for h in got.history)
    for g, w in zip(got.history, want.history):
        for key in ("gradnorm", "diffV"):
            assert abs(g[key] - w[key]) <= 1e-6 * vnorm, (g, w)


def _reading(stats):
    return brun.Reading(stats={n: (c, 0.0, float("nan"))
                               for n, c in stats.items()})


@pytest.mark.parametrize("stats,want", [
    ({}, None),
    ({"cp.diagnostics": 9}, None),
    ({"cp.diag_v_reads": 18}, None),
    ({"cp.diagnostics": 9, "cp.diag_v_reads": 18}, 2.0),
    ({"cp.diagnostics": 4, "cp.diag_v_reads": 12}, 3.0)])
def test_diag_v_reads_per_row_reader(stats, want):
    got = brun.load(REPO, "metrics", "diag_v_reads_per_row").read(
        _reading(stats))
    assert got == want if want is None else got == pytest.approx(want)
