"""``run -issparse 1`` of the port against the JAX package, on the CPU: the
second-gen optimizers on a COO tensor (sparse chain tops and low-rank
refreshes, Simple's sparse sweep, the sparse diagnostics) and the ``run``
CLI that builds the COO.

float64 factors must equal the JAX package's to rel 1e-10 after every step
(the sums run in other orders); CSVs of the two CLIs, the port handed the
JAX package's initial factors and its ``-randomsvd`` draws (C1), agree
but for [dtime] to rel 1e-8, as the dense ``run`` CSVs do. float32
(-dtype bfloat16, whose factors are float32): rel 1e-4 over six sweeps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pairwise_perturbation_tpu import cli as jcli
from pairwise_perturbation_tpu.models import cp as jcp
from pairwise_perturbation_tpu.models import optimizers as jopt
from pairwise_perturbation_tpu.ops import sparse as jsp
from pairwise_perturbation_tpu.utils import synth as jsynth
from pairwise_perturbation_tpu_torch import cli
from pairwise_perturbation_tpu_torch.models import cp as tcp
from pairwise_perturbation_tpu_torch.models import optimizers as topt
from pairwise_perturbation_tpu_torch.ops import sparse as tsp
from pairwise_perturbation_tpu_torch.ops.kernels import coo_mttkrp
from pairwise_perturbation_tpu_torch.utils import tracing

from test_torch_optimizers import OPTIMIZERS, _close, _problem, _t
from test_torch_partupdate import _csv, _jax_factors, assert_same_csv

torch.set_num_threads(1)

SHAPE = (4, 6, 5, 7)


def _coo_problem(shape=SHAPE, keep=0.4, seed=0):
    """A rank-3 tensor with 1% noise, 60% of its entries zeroed, as a
    dense array, both packages' COO of it, and the JAX package's initial
    factors."""
    V, W0 = _problem(shape, seed=seed)
    mask = np.random.default_rng(seed + 1).random(shape) < keep
    V = V * mask
    return V, jsp.from_dense(V), tsp.from_dense(V, device="cpu"), W0


@pytest.mark.parametrize("left", range(4))
def test_sparse_chain_top_matches_jax(left):
    """The chain top of a COO tensor, axes in rotation order + rank: the
    JAX package's, and the port's dense route on the same values."""
    V, jst, st, W0 = _coo_problem()
    got = topt.chain_top(st, _t(W0[left]), left_index=left)
    _close(got, jopt.chain_top(jst, jnp.asarray(W0[left]), left_index=left))
    _close(got, topt.chain_top(_t(V), _t(W0[left]), left_index=left))


@pytest.mark.parametrize("left", [0, 2, 3])
def test_sparse_lr_update_cache_matches_jax(left):
    """cache + (V x_left U s) x VT on a COO tensor, to round-off."""
    V, jst, st, W0 = _coo_problem()
    rng = np.random.default_rng(left)
    top = np.asarray(jopt.chain_top(jst, jnp.asarray(W0[left]),
                                    left_index=left))
    U, s, VT = (rng.random((SHAPE[left], 2)), rng.random(2),
                rng.random((2, 3)))
    want = jopt.lr_update_cache(jst, jnp.asarray(top), jnp.asarray(U),
                                jnp.asarray(s), jnp.asarray(VT),
                                left_index=left)
    got = topt.lr_update_cache(st, _t(top), _t(U), _t(s), _t(VT),
                               left_index=left)
    _close(got, want)
    _close(got, topt.lr_update_cache(_t(V), _t(top), _t(U), _t(s), _t(VT),
                                     left_index=left))


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_sparse_optimizer_steps_match_jax(name):
    """Eight steps of every optimizer on a 4-mode COO tensor in f64: the
    same sweep count a step and factors equal after every step.
    min_holdout_size 5 skips hold-out 0 (size 4)."""
    _, jst, st, W0 = _coo_problem()
    jo, to = OPTIMIZERS[name](jopt, 4, 3), OPTIMIZERS[name](topt, 4, 3)
    jo.configure(jst, [jnp.asarray(w) for w in W0], 1e-3)
    to.configure(st, [_t(w) for w in W0], 1e-3)
    for _ in range(8):
        assert to.step() == jo.step()
        for t, j in zip(to.W, jo.W):
            _close(t, j)
    if name == "simple":
        assert to.grads is None


class _JaxDraws:
    """The randomized SVD's test matrices of the JAX package's LR
    optimizers: one split of PRNGKey(seed) an LR step, uniform (R, r)
    (JAX optimizers.py:408-411, solve.py:198), handed to the port."""

    def __init__(self, randomsvd, seed):
        self.randomsvd = randomsvd
        self.key = jax.random.PRNGKey(seed)

    def draw(self, rank, update_rank, like):
        self.key, k = jax.random.split(self.key)
        if not self.randomsvd:
            return None
        X = jax.random.uniform(k, (rank, update_rank), dtype=jnp.float64)
        return torch.from_numpy(np.array(X)).to(like.dtype)


RUN_SPARSE = ["run", "-tensor", "p", "-dim", "8", "-size", "3", "-rank",
              "3", "-maxiter", "6", "-resprint", "2", "-issparse", "1"]


@pytest.mark.parametrize("extra", [
    ["-pp", "0"], ["-pp", "1"], ["-pp", "2"], ["-pp", "3"], ["-pp", "4"],
    ["-pp", "1", "-device_loop", "1"],
    ["-pp", "2", "-randomsvd", "1", "-updaterank", "2"],
    ["-pp", "3", "-randomsvd", "1", "-lambda", "0.001"],
])
def test_cli_run_sparse_csv_matches_jax(tmp_path, monkeypatch, extra):
    """``run -issparse 1`` on the folded Poisson tensor (9^4) through both
    CLIs in float64, the port handed the JAX package's initial factors
    and randomized-SVD draws: the CSVs agree but for [dtime]."""
    monkeypatch.setattr(tcp, "init_factors", _jax_factors)
    monkeypatch.setattr(topt, "_RandomSVD", _JaxDraws)
    argv = RUN_SPARSE + ["-dtype", "float64"] + extra
    got = _csv(cli.main, tmp_path / "port.csv", argv + ["-device", "cpu"])
    want = _csv(jcli.main, tmp_path / "jax.csv", argv)
    assert_same_csv(got, want)


def test_cli_run_sparse_bf16_builds_unrounded_coo(tmp_path, monkeypatch):
    """-dtype bfloat16: ``run`` builds the COO from V's float32 values,
    not rounded to bf16 (JAX cli.py:429-438; test_als rounds them), and
    its CSV agrees with the JAX CLI's: gradnorm to rel 1e-4; diffV, the
    f32 norm identity sqrt(||V||^2 - 2<V, X> + ||X||^2), whose squares
    cancel, by its square to 1e-5 ||V||^2. Tensor r, whose values
    bf16 does not hold exactly (the Poisson tensor's are small integers);
    every entry is a nonzero."""
    seen = {}
    run_cpd = cli.run_cpd

    def capture(X, Ws, *a, **k):
        seen["X"], seen["Ws"] = X, Ws
        return run_cpd(X, Ws, *a, **k)

    def jax_f32_factors(shape, R, seed=0, dtype=None, device="cpu"):
        return [torch.from_numpy(np.array(W)) for W in jcp.init_factors(
            shape, R, key=jax.random.PRNGKey(seed), dtype=jnp.float32)]

    monkeypatch.setattr(cli, "run_cpd", capture)
    monkeypatch.setattr(tcp, "init_factors", jax_f32_factors)
    argv = ["run", "-tensor", "r", "-dim", "4", "-size", "5", "-rank", "3",
            "-maxiter", "6", "-resprint", "2", "-issparse", "1", "-dtype",
            "bfloat16", "-pp", "1"]
    got = _csv(cli.main, tmp_path / "port.csv", argv + ["-device", "cpu"])
    want = _csv(jcli.main, tmp_path / "jax.csv", argv)
    V = jsynth.make_tensor("r", 4, 5, 3, dtype=np.float32)
    st = seen["X"]
    assert isinstance(st, tsp.SparseTensor) and st.dtype == torch.float32
    assert seen["Ws"][0].dtype == torch.float32
    np.testing.assert_array_equal(st.values.numpy(), V[np.nonzero(V)])
    assert not np.array_equal(
        V, np.asarray(jnp.asarray(V, jnp.bfloat16), np.float32))
    assert got[0] == want[0] and len(got) == len(want) > 2
    vnorm_sq = (float(want[1][3]) / 1e-10) ** 2      # [tol] = 1e-10 ||V||
    for g, w in zip(got[1:], want[1:]):
        assert g[:2] == w[:2] and g[3:5] == w[3:5], (g, w)
        assert float(g[2]) == pytest.approx(float(w[2]), rel=1e-4), (g, w)
        assert abs(float(g[5]) ** 2 - float(w[5]) ** 2) <= 1e-5 * vnorm_sq


@pytest.mark.parametrize("pp,per_step", [(4, 4), (0, 0), (1, 0), (3, 0)])
def test_cli_run_sparse_f32_k7_calls(tmp_path, monkeypatch, pp, per_step):
    """float32 with -profile 1: the COO MTTKRP module (K7; on the CPU its
    plain version) serves 4 MTTKRPs a Simple step and 5 a diagnostics row
    (the gradnorm's four, the residual's one), and no DT, MSDT or LR
    step. The gradnorm falls."""
    calls = []
    plain = coo_mttkrp.coo_mttkrp_plain

    def spy(*a, **k):
        calls.append(a[2])
        return plain(*a, **k)

    monkeypatch.setattr(coo_mttkrp, "coo_mttkrp_plain", spy)
    tracing.reset()
    try:
        rows = _csv(cli.main, tmp_path / "f32.csv",
                    RUN_SPARSE + ["-pp", str(pp), "-profile", "1",
                                  "-device", "cpu"])
    finally:
        tracing.enable(False)
    body = [[float(x) for x in r] for r in rows[1:]]
    assert all(np.isfinite(r).all() for r in body)
    assert body[-1][2] < body[0][2]
    stats = tracing.stats()
    steps = [v[0] for k, v in stats.items() if k.endswith(".step")][0]
    diag = stats["cp.diagnostics"][0]
    assert diag == len(body)
    assert len(calls) == per_step * steps + 5 * diag
    assert coo_mttkrp.LAUNCHES["coo_mttkrp"] == 0   # CPU: no launch
