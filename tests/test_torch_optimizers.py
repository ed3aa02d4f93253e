"""The second-gen optimizers and ``run`` of the port against the JAX
package, on the CPU, from the same numpy tensor and initial factors: the
chain tree, the low-rank solve kit, every optimizer's steps and the
``run`` CLI.

In float64 the factors after each step must equal the JAX package's to
rel 1e-10 (round-off: the sums run in other orders, and Cholesky, QR and
eigh are other implementations). Low-rank factorizations are compared as
(U s) VT, never U, s and VT apart: their column signs are arbitrary (C5).
float32: rel 1e-4 over eight steps.

The ``cuda`` test holds the chain top's K4 launch on a card:

    python -m pytest tests/test_torch_optimizers.py --noconftest -m cuda
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from pairwise_perturbation_tpu import cli as jcli
from pairwise_perturbation_tpu.models import cp as jcp
from pairwise_perturbation_tpu.models import optimizers as jopt
from pairwise_perturbation_tpu.ops import dimtree as jdt
from pairwise_perturbation_tpu.ops import solve as jsolve
from pairwise_perturbation_tpu.ops import sparse as jsp
from pairwise_perturbation_tpu_torch import cli
from pairwise_perturbation_tpu_torch.models import cp as tcp
from pairwise_perturbation_tpu_torch.models import optimizers as topt
from pairwise_perturbation_tpu_torch.ops import contract as tc
from pairwise_perturbation_tpu_torch.ops import dimtree as tdt
from pairwise_perturbation_tpu_torch.ops import solve as tsolve
from pairwise_perturbation_tpu_torch.ops import sparse
from pairwise_perturbation_tpu_torch.ops.kernels import mid_contract, mttkrp3

from test_torch_partupdate import _csv, _jax_factors, assert_same_csv

torch.set_num_threads(1)


def _problem(shape, R=3, seed=0, dtype=np.float64):
    """A tensor of known rank-R factors with 1% noise, and the JAX
    package's initial factors for it."""
    rng = np.random.default_rng(seed)
    true = [rng.random((s, R)) for s in shape]
    letters = "abcde"[:len(shape)]
    V = np.einsum(",".join(c + "z" for c in letters) + "->" + letters, *true)
    V = V * (1 + 0.01 * rng.standard_normal(V.shape))
    W0 = [np.asarray(w) for w in jcp.init_factors(
        shape, R, key=jax.random.PRNGKey(seed), dtype=jnp.float64)]
    return V.astype(dtype), [w.astype(dtype) for w in W0]


def _close(t, j, tol=1e-10):
    j = np.asarray(j)
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    scale = max(np.max(np.abs(j)), 1e-300)
    assert t.shape == j.shape
    assert np.max(np.abs(t - j)) <= tol * scale, np.max(np.abs(t - j)) / scale


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_chain_tree_matches_jax(n):
    assert tdt.chain_tree(n) == jdt.chain_tree(n)


@pytest.mark.parametrize("shape", [(5, 6, 7), (4, 5, 6, 3), (3, 4, 2, 5, 3)])
def test_chain_tree_sweep_mttkrp_matches_jax(shape):
    """Every position's MTTKRP from the chain tree of every hold-out, and
    the chain top, in f64."""
    V, W0 = _problem(shape)
    order = len(shape)
    for left in range(order):
        indexes = topt.rotation_indexes(left, order)
        assert indexes == jopt.rotation_indexes(left, order)
        js = jdt.ChainTreeSweep(jnp.asarray(V), [jnp.asarray(w) for w in W0],
                                indexes, left)
        ts = tdt.ChainTreeSweep(_t(V), [_t(w) for w in W0], indexes, left)
        _close(ts.top(), js.top())
        for pos in range(order - 1):
            _close(ts.mttkrp(pos), js.mttkrp(pos))
        _close(topt.chain_top(_t(V), _t(W0[left]), left_index=left),
               js.top())


def test_chain_top_takes_mid_contract_under_use_kernels_first(monkeypatch):
    """Hold-out 1 of a (2, 8, 32768) f32 tensor is one the kernel route
    admits: with the route open (``contract._on_card`` patched to admit
    the CPU) the chain top goes through the kernel module, on the CPU its
    plain version, and equals the einsum route (the same sums, rel 1e-6);
    with the route closed, and for the minor hold-out, the module is not
    called."""
    calls = []
    plain = mid_contract.mid_contract_plain

    def spy(*a, **k):
        calls.append(a[2])
        return plain(*a, **k)

    monkeypatch.setattr(mid_contract, "mid_contract_plain", spy)
    gen = torch.Generator().manual_seed(0)
    V = torch.rand((2, 8, 32768), generator=gen)
    W = torch.rand((8, 4), generator=gen)
    assert mid_contract.route_admits(V, 4, 1)
    want = topt.chain_top(V, W, left_index=1)
    assert calls == []
    monkeypatch.setattr(tc, "_on_card", lambda V, factor: True)
    got = topt.chain_top(V, W, left_index=1)
    topt.chain_top(V, torch.rand((32768, 4), generator=gen), left_index=2)
    assert calls == [1]
    assert got.shape == want.shape == (32768, 2, 4)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-6


def test_simple_optimizer_takes_mttkrp3_on_order3_f32(monkeypatch):
    """CPSimpleOptimizer on an order-3 f32 V: each step's three MTTKRPs
    go through the fused kernel module (K1-K3 on the card), once a mode."""
    calls = []
    real = mttkrp3.mttkrp3_mode

    def spy(V, Ws, mode):
        calls.append(mode)
        return real(V, Ws, mode)

    monkeypatch.setattr(mttkrp3, "mttkrp3_mode", spy)
    V, W0 = _problem((6, 7, 8), dtype=np.float32)
    o = topt.CPSimpleOptimizer(3, 3)
    o.configure(_t(V), [_t(w) for w in W0], 0.0)
    assert o.step() == 1.0 and o.step() == 1.0
    assert calls == [0, 1, 2, 0, 1, 2]


# ---------------------------------------------------------------------------
# The low-rank kit
# ---------------------------------------------------------------------------


def _usv(usv):
    U, s, VT = (np.asarray(x) if not isinstance(x, torch.Tensor)
                else x.numpy() for x in usv)
    return (U * s) @ VT


@pytest.mark.parametrize("m,n,r", [(40, 5, 2), (40, 5, 5), (9, 5, 3)])
def test_truncated_svd_matches_jax(m, n, r):
    """The Gram-eigh route (m >= 4n) and torch.linalg.svd (m < 4n)."""
    A = np.random.default_rng(m + n + r).random((m, n))
    np.testing.assert_allclose(_usv(tsolve.truncated_svd(_t(A), r)),
                               _usv(jsolve.truncated_svd(jnp.asarray(A), r)),
                               rtol=0, atol=1e-10 * np.abs(A).max())


@pytest.mark.parametrize("m,n,r", [(40, 5, 2), (9, 5, 3)])
def test_randomized_svd_matches_jax_with_its_draw(m, n, r):
    """The JAX package's jax.random test matrix handed to the port."""
    A = np.random.default_rng(m).random((m, n))
    key = jax.random.PRNGKey(7)
    X = np.asarray(jax.random.uniform(key, (n, r), dtype=jnp.float64))
    want = _usv(jsolve.randomized_svd(jnp.asarray(A), r, key=key))
    got = _usv(tsolve.randomized_svd(_t(A), r, _t(X)))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-10 * np.abs(want).max())


@pytest.mark.parametrize("which", ["cholesky", "svd"])
@pytest.mark.parametrize("random", [False, True])
def test_rankR_update_matches_jax(which, random):
    rng = np.random.default_rng(3)
    W = rng.random((30, 4))
    S = W.T @ W + np.eye(4)
    M, A = rng.random((30, 4)), rng.random((30, 4))
    key = jax.random.PRNGKey(2)
    X = _t(jax.random.uniform(key, (4, 2), dtype=jnp.float64)) \
        if random else None
    jfn = getattr(jsolve, f"rankR_update_{which}")
    tfn = getattr(tsolve, f"rankR_update_{which}")
    want = _usv(jfn(jnp.asarray(M), jnp.asarray(A), jnp.asarray(S), 2,
                    random=random, key=key))
    got = _usv(tfn(_t(M), _t(A), _t(S), 2, X))
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-10 * np.abs(want).max())


def test_gauss_seidel_matches_jax():
    rng = np.random.default_rng(4)
    G = rng.random((5, 5))
    Gamma = G @ G.T + 5 * np.eye(5)
    F, A = rng.random((7, 5)), rng.random((7, 5))
    for its in (1, 4):
        _close(tsolve.gauss_seidel(_t(A), _t(F), _t(Gamma), its),
               jsolve.gauss_seidel(jnp.asarray(A), jnp.asarray(F),
                                   jnp.asarray(Gamma), its))


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------


OPTIMIZERS = {
    "simple": lambda m, o, R: m.CPSimpleOptimizer(o, R),
    "dt": lambda m, o, R: m.CPDTOptimizer(o, R),
    "msdt": lambda m, o, R: m.CPMSDTOptimizer(o, R),
    "msdt_min_holdout": lambda m, o, R: m.CPMSDTOptimizer(
        o, R, min_holdout_size=5),
    "dtlr": lambda m, o, R: m.CPDTLROptimizer(o, R, update_rank=2,
                                              num_subiteration=3),
    "msdtlr": lambda m, o, R: m.CPMSDTLROptimizer(o, R, update_rank=2),
    "msdtlr_min_holdout": lambda m, o, R: m.CPMSDTLROptimizer(
        o, R, update_rank=2, min_holdout_size=5),
}


def _pair(name, shape, lam=0.0, dtype=np.float64):
    V, W0 = _problem(shape, dtype=dtype)
    order, R = len(shape), W0[0].shape[1]
    jo, to = OPTIMIZERS[name](jopt, order, R), OPTIMIZERS[name](topt, order, R)
    jo.configure(jnp.asarray(V), [jnp.asarray(w) for w in W0], lam)
    to.configure(_t(V), [_t(w) for w in W0], lam)
    return jo, to


@pytest.mark.parametrize("shape", [(6, 7, 8), (3, 6, 5, 7)])
@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_steps_match_jax(name, shape):
    """Eight steps in f64 (randomsvd off): the same sweep count each step
    and the factors equal after every step. (3, 6, 5, 7) has a mode below
    min_holdout_size 5, so those optimizers skip hold-out 0."""
    jo, to = _pair(name, shape, lam=1e-3 if name == "dt" else 0.0)
    for _ in range(8):
        assert to.step() == jo.step()
        for t, j in zip(to.W, jo.W):
            _close(t, j)
    if "min_holdout" in name and len(shape) == 4:
        assert to.holdouts == jo.holdouts == (1, 2, 3)


@pytest.mark.parametrize("name", ["dt", "msdt", "dtlr"])
def test_optimizer_steps_f32_match_jax(name):
    jo, to = _pair(name, (6, 7, 8), dtype=np.float32)
    for _ in range(8):
        to.step()
        jo.step()
    for t, j in zip(to.W, jo.W):
        assert t.dtype == torch.float32
        _close(t, j, 1e-4)


@pytest.mark.parametrize("min_holdout", [0, 5])
def test_step_cycle_equals_steps_and_jax(min_holdout):
    """One step_cycle is the rotation's steps one by one, in the port, and
    equals the JAX package's device-resident cycle; the hold-outs of the
    restricted rotation agree with the JAX package's."""
    shape = (3, 6, 5, 7)
    V, W0 = _problem(shape)
    mk = OPTIMIZERS["msdt_min_holdout" if min_holdout else "msdt"]
    a, b, j = mk(topt, 4, 3), mk(topt, 4, 3), mk(jopt, 4, 3)
    a.configure(_t(V), [_t(w) for w in W0], 0.0)
    b.configure(_t(V), [_t(w) for w in W0], 0.0)
    j.configure(jnp.asarray(V), [jnp.asarray(w) for w in W0], 0.0)
    for _ in range(2):
        lefts = a._cycle_lefts()
        assert lefts == j._cycle_lefts()
        assert lefts == ((3, 2, 1) if min_holdout else (3, 2, 1, 0))
        ds = a.step_cycle()
        assert ds == j.step_cycle() == len(lefts) * 3 / 4
        assert sum(b.step() for _ in lefts) == pytest.approx(ds)
        assert a.left_index == b.left_index == j.left_index
        for x, y, z in zip(a.W, b.W, j.W):
            assert torch.equal(x, y)
            _close(x, z)


def test_randomsvd_draws_are_seeded():
    """-randomsvd 1: the test matrices come from the optimizer's own
    seeded generator, so two optimizers of one seed take the same steps,
    and another seed other steps."""
    V, W0 = _problem((6, 7, 8))

    def run(seed):
        o = topt.CPDTLROptimizer(3, 3, update_rank=2, randomsvd=True,
                                 seed=seed)
        o.configure(_t(V), [_t(w) for w in W0], 0.0)
        for _ in range(8):
            o.step()
        return o.W

    a, b, c = run(1), run(1), run(2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))


def test_cpd_als_on_sparse_tensor_matches_jax():
    """CPD takes a COO tensor (run -issparse 1): MSDT's logged sweeps,
    gradnorms and diffVs (the sparse diagnostics) of the JAX package's
    loop, to rel 1e-8."""
    V, W0 = _problem((4, 5, 6))
    V = V * (np.random.default_rng(1).random(V.shape) < 0.5)
    jm = jopt.CPD(3, list(V.shape), 3, jopt.CPMSDTOptimizer(3, 3))
    jm.init(jsp.from_dense(V), [jnp.asarray(w) for w in W0])
    tm = topt.CPD(3, list(V.shape), 3, topt.CPMSDTOptimizer(3, 3))
    tm.init(sparse.from_dense(V, device="cpu"), [_t(w) for w in W0])
    jm.als(tol=0.0, timelimit=1e4, maxsweep=5, resprint=2)
    tm.als(tol=0.0, timelimit=1e4, maxsweep=5, resprint=2)
    assert [h["sweeps"] for h in tm.history] == \
        [h["sweeps"] for h in jm.history]
    for a, b in zip(tm.history, jm.history):
        for k in ("gradnorm", "diffV"):
            assert abs(a[k] - b[k]) <= 1e-8 * abs(b[k]), (a, b)


@pytest.mark.parametrize("name", ["simple", "msdt", "dtlr"])
def test_cpd_als_history_matches_jax(name):
    """CPD.als: the logged sweeps (a float count), gradnorms and diffVs
    of the JAX package's loop, to rel 1e-8."""
    V, W0 = _problem((6, 7, 8))
    jm = jopt.CPD(3, list(V.shape), 3, OPTIMIZERS[name](jopt, 3, 3))
    jm.init(jnp.asarray(V), [jnp.asarray(w) for w in W0])
    tm = topt.CPD(3, list(V.shape), 3, OPTIMIZERS[name](topt, 3, 3))
    tm.init(_t(V), [_t(w) for w in W0])
    jm.als(tol=0.0, timelimit=1e4, maxsweep=5, resprint=2)
    tm.als(tol=0.0, timelimit=1e4, maxsweep=5, resprint=2)
    assert [h["sweeps"] for h in tm.history] == \
        [h["sweeps"] for h in jm.history]
    for a, b in zip(tm.history, jm.history):
        for k in ("gradnorm", "diffV"):
            assert abs(a[k] - b[k]) <= 1e-8 * abs(b[k]), (a, b)
    for t, j in zip(tm.W, jm.W):
        _close(t, j, 1e-8)


# ---------------------------------------------------------------------------
# The run CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [
    ["-pp", "0"], ["-pp", "1"], ["-pp", "2"], ["-pp", "3"], ["-pp", "4"],
    ["-pp", "1", "-device_loop", "1"],
    ["-pp", "3", "-msdt_min_holdout", "5", "-updaterank", "2",
     "-lambda", "0.001"],
])
def test_cli_run_csv_matches_jax(tmp_path, monkeypatch, extra):
    """``run`` through both CLIs in float64, the port's CLI handed the
    JAX package's initial factors: the CSVs agree but for [dtime]."""
    monkeypatch.setattr(tcp, "init_factors", _jax_factors)
    argv = ["run", "-tensor", "r", "-dim", "4", "-size", "6", "-rank", "3",
            "-maxiter", "6", "-resprint", "2", "-dtype", "float64"] + extra
    got = _csv(cli.main, tmp_path / "port.csv", argv + ["-device", "cpu"])
    want = _csv(jcli.main, tmp_path / "jax.csv", argv)
    assert_same_csv(got, want)


def test_cli_run_f32_profile(tmp_path, capsys):
    """run -pp 4 in float32 with -profile 1: the optimizer's step scope
    and the diagnostics in the report, a gradnorm that falls."""
    from pairwise_perturbation_tpu_torch.utils import tracing
    tracing.reset()
    try:
        rows = _csv(cli.main, tmp_path / "f32.csv",
                    ["run", "-tensor", "r", "-dim", "3", "-size", "10",
                     "-rank", "3", "-pp", "4", "-maxiter", "6",
                     "-resprint", "2", "-profile", "1", "-device", "cpu"])
    finally:
        tracing.enable(False)
    body = [[float(x) for x in r] for r in rows[1:]]
    assert [r[1] for r in body] == [0.0, 2.0, 4.0, 6.0]
    assert body[-1][2] < body[0][2]
    stats = tracing.stats()
    # the loop runs while int(sweeps) <= maxsweep, so one step follows
    # the last row (src/CP.cxx, the JAX package's CPD.als)
    assert stats["CPSimpleOptimizer.step"][0] == 7
    assert len(tracing.samples("CPSimpleOptimizer.step")) == 7
    assert stats["cp.diagnostics"][0] == 4
    assert "CPSimpleOptimizer.step" in capsys.readouterr().out


@pytest.mark.cuda
def test_cuda_chain_top_launches_k4(monkeypatch):
    """On a card, with no flag: the chain top of a non-minor hold-out
    launches K4 once, none with the route closed (``contract._on_card``
    patched), and agrees with that einsum route to rel 1e-4 (f32 sums in
    another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    gen = torch.Generator(device="cuda").manual_seed(3)
    V = torch.rand((3, 128, 16, 2048), generator=gen, device="cuda")
    W = torch.rand((128, 10), generator=gen, device="cuda")
    n0 = mid_contract.LAUNCHES["rank_minor"]
    monkeypatch.setattr(tc, "_on_card", lambda V, factor: False)
    want = topt.chain_top(V, W, left_index=1)
    torch.cuda.synchronize()
    assert mid_contract.LAUNCHES["rank_minor"] == n0
    monkeypatch.undo()
    got = topt.chain_top(V, W, left_index=1)
    torch.cuda.synchronize()
    assert mid_contract.LAUNCHES["rank_minor"] == n0 + 1
    assert got.shape == want.shape == (16, 2048, 3, 10)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4
