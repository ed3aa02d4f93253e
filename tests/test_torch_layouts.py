"""``-layouts 1`` (CPConfig.precompute_layouts): the mode-minor copies of V
(contract.prepare_layouts) and every function that reads them, against
the JAX package's with layouts on the same numpy inputs, on the CPU.

Functions (prepare_layouts, first_contraction and _first_contraction_rm
with layouts, the chain-root planners, dt_sweep and build_pp_caches with
layouts) to 1e-12 relative (max-norm) in float64 and 1e-5 in float32;
the engines that read the flag (als_cp_dt, als_cp_pp_device,
als_cp_pp_fused) take the JAX package's trajectories in float64 to 1e-9
with the same rows and flags. The CLI accepts -layouts 1 where the JAX
package reads it and refuses it, saying so, where the JAX package ignores
it; with layouts the K6 route of the cache build is not taken (JAX
contract.py:395-396).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pairwise_perturbation_tpu import cli as jcli
from pairwise_perturbation_tpu.models import cp as jcp
from pairwise_perturbation_tpu.ops import contract as jc
from pairwise_perturbation_tpu_torch import cli, config
from pairwise_perturbation_tpu_torch.models import cp as tcp
from pairwise_perturbation_tpu_torch.ops import contract as tc
from pairwise_perturbation_tpu_torch.ops.kernels import triple_roots

from test_torch_partupdate import _csv, _jax_factors, assert_same_csv

torch.set_num_threads(1)

F64, F32, TRAJ = 1e-12, 1e-5, 1e-9
SHAPES = [(7, 5, 6), (4, 6, 5, 7), (3, 5, 4, 6, 4)]
TOL = {np.float64: F64, np.float32: F32}
ENGINE_CFG = dict(tol=0.0, pp_res_tol=0.1, maxiter=30, resprint=1)


def _inputs(shape, dtype=np.float64, R=3, seed=0):
    rng = np.random.default_rng(seed + len(shape))
    V = rng.standard_normal(shape).astype(dtype)
    Ws = [rng.standard_normal((s, R)).astype(dtype) for s in shape]
    return V, Ws


def _rel(got, want):
    got = got.detach().numpy() if hasattr(got, "detach") else np.asarray(got)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _layouts_both(V, modes):
    return (tc.prepare_layouts(torch.from_numpy(V), modes),
            jc.prepare_layouts(jnp.asarray(V), modes))


@pytest.mark.parametrize("shape", SHAPES)
def test_prepare_layouts_matches_jax(shape):
    """One copy a non-minor mode (the minor one is skipped), equal to
    JAX's moveaxis copy, contiguous."""
    V, _ = _inputs(shape)
    modes = list(range(len(shape)))
    tl, jl = _layouts_both(V, modes)
    assert sorted(tl) == sorted(jl) == modes[:-1]
    for m in jl:
        assert tl[m].is_contiguous()
        np.testing.assert_array_equal(tl[m].numpy(), np.asarray(jl[m]))


@pytest.mark.parametrize("shape", SHAPES)
def test_chain_root_modes_match_jax(shape):
    """The planners of the copies' modes: the DT tree's (midpoint and
    every root split) and the PP caches'."""
    assert tc.chain_root_modes_pp(shape) == jc.chain_root_modes_pp(shape)
    for split in [None] + list(range(len(shape) - 1)):
        assert tc.chain_root_modes_dt(shape, split) == \
            jc.chain_root_modes_dt(shape, split)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_first_contractions_with_layouts_match_jax(shape, dtype):
    """first_contraction (rank-minor) and _first_contraction_rm
    (rank-major) of every mode, from the copy where one exists."""
    V, Ws = _inputs(shape, dtype)
    tl, jl = _layouts_both(V, list(range(len(shape))))
    for m in range(len(shape)):
        W = Ws[m]
        got, rem = tc.first_contraction(torch.from_numpy(V),
                                        torch.from_numpy(W), m, layouts=tl)
        want, jrem = jc.first_contraction(jnp.asarray(V), jl,
                                          jnp.asarray(W), m)
        assert rem == jrem
        assert _rel(got, want) <= TOL[dtype]
        got, rem = tc._first_contraction_rm(torch.from_numpy(V),
                                            torch.from_numpy(W), m, tl)
        want, jrem = jc._first_contraction_rm(jnp.asarray(V), jl,
                                              jnp.asarray(W), m)
        assert rem == jrem
        assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_dt_sweep_with_layouts_matches_jax(shape, dtype):
    """One DT sweep with the tree's root copies: factors and grads."""
    V, Ws = _inputs(shape, dtype)
    modes = tc.chain_root_modes_dt(shape)
    tl, jl = _layouts_both(V, modes)
    got, gg = tcp.dt_sweep(torch.from_numpy(V),
                           [torch.from_numpy(W) for W in Ws], 0.0,
                           layouts=tl)
    want, jg = jcp.dt_sweep(jnp.asarray(V), [jnp.asarray(W) for W in Ws],
                            jnp.asarray(0.0, dtype), jl)
    for a, b in zip(got + gg, list(want) + list(jg)):
        assert _rel(a, b) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_build_pp_caches_with_layouts_matches_jax(shape, dtype):
    """Every pair and single cache from the chain roots' copies."""
    V, Ws = _inputs(shape, dtype)
    tl, jl = _layouts_both(V, tc.chain_root_modes_pp(shape))
    ts, tp = tc.build_pp_caches(torch.from_numpy(V),
                                [torch.from_numpy(W) for W in Ws],
                                layouts=tl)
    js, jp = jc.build_pp_caches(jnp.asarray(V), [jnp.asarray(W) for W in Ws],
                                layouts=jl)
    assert sorted(tp) == sorted(jp) and sorted(ts) == sorted(js)
    for k in jp:
        assert _rel(tp[k], jp[k]) <= TOL[dtype], k
    for k in js:
        assert _rel(ts[k], js[k]) <= TOL[dtype], k


def test_layouts_bypass_the_triple_roots_kernel(monkeypatch):
    """With use_kernels_triple on and layouts given, K6's wrapper is not
    reached (JAX contract.py:395-396); without layouts it is, once."""
    calls = []
    real = triple_roots.triple_roots

    def spy(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(triple_roots, "triple_roots", spy)
    V, Ws = _inputs((3, 16, 24, 1200), np.float32, R=4)
    Vt, Wt = torch.from_numpy(V), [torch.from_numpy(W) for W in Ws]
    with config.override(use_kernels_triple=True):
        tc.build_pp_caches(Vt, Wt, layouts=tc.prepare_layouts(
            Vt, tc.chain_root_modes_pp(V.shape)))
        assert calls == []
        tc.build_pp_caches(Vt, Wt)
    assert len(calls) == 1


def _problem(seed=0, shape=(6, 5, 7, 6), R=3):
    """A rank-R tensor plus 1% noise and the JAX package's factors."""
    rng = np.random.default_rng(seed)
    truth = [rng.random((s, R)) for s in shape]
    V = np.einsum("ar,br,cr,dr->abcd", *truth)
    V = V + 0.01 * np.linalg.norm(V) / np.sqrt(V.size) \
        * rng.standard_normal(shape)
    W0 = [np.array(w) for w in jcp.init_factors(
        shape, R, key=jax.random.PRNGKey(seed), dtype=jnp.float64)]
    return V, W0


@pytest.mark.parametrize("engine", ["als_cp_dt", "als_cp_pp_device",
                                    "als_cp_pp_fused"])
def test_engines_with_layouts_match_jax(engine):
    """als_cp_dt, als_cp_pp_device and als_cp_pp_fused with
    precompute_layouts: the JAX package's rows (iter, PP flag), gradnorm
    and diffV to 1e-9 and factors to 1e-9; the port's rows are also its
    own run's without layouts to 1e-9."""
    V, W0 = _problem()
    rj = getattr(jcp, engine)(jnp.asarray(V), [jnp.asarray(w) for w in W0],
                             jcp.CPConfig(**ENGINE_CFG,
                                          precompute_layouts=True))
    rt = getattr(tcp, engine)(torch.from_numpy(V),
                             [torch.from_numpy(w) for w in W0],
                             tcp.CPConfig(**ENGINE_CFG,
                                          precompute_layouts=True))
    off = getattr(tcp, engine)(torch.from_numpy(V),
                              [torch.from_numpy(w) for w in W0],
                              tcp.CPConfig(**ENGINE_CFG))
    for other in (rj, off):
        assert [(h["iter"], h["pp"]) for h in rt.history] == \
            [(h["iter"], h["pp"]) for h in other.history]
        for g, w in zip(rt.history, other.history):
            for k in ("gradnorm", "diffV"):
                assert abs(g[k] - w[k]) <= TRAJ * abs(w[k]), (k, g, w)
    if engine != "als_cp_dt":
        assert {h["pp"] for h in rt.history} == {0, 1}
    for a, b in zip(rt.factors, rj.factors):
        assert _rel(a, b) <= TRAJ


@pytest.mark.parametrize("argv", [
    ["-pp", "0"], ["-pp", "1", "-device_loop", "1"],
    ["-pp", "1", "-device_loop", "2"]])
def test_cli_layouts_matches_jax(tmp_path, monkeypatch, argv):
    """test_als -model CP -layouts 1 where the JAX package reads it (-pp 0;
    -pp 1 with -device_loop 1 or 2), through both CLIs in float64 from
    the JAX package's factors: the CSVs agree but for [dtime]."""
    monkeypatch.setattr(tcp, "init_factors", _jax_factors)
    base = ["test_als", "-model", "CP", "-tensor", "r", "-dim", "4",
            "-size", "6", "-rank", "3", "-maxiter", "15", "-resprint", "1",
            "-pp_res_tol", "0.1", "-dtype", "float64", "-layouts", "1"]
    got = _csv(cli.main, tmp_path / "port.csv",
               base + argv + ["-device", "cpu"])
    want = _csv(jcli.main, tmp_path / "jax.csv", base + argv)
    assert_same_csv(got, want)


@pytest.mark.parametrize("argv,match", [
    (["test_als", "-pp", "1", "-device_loop", "0"],
     "-pp 1 -device_loop 0 .*never reads it; the JAX package ignores"),
    (["test_als", "-pp", "2"], "PP-partupdate.*the JAX package ignores"),
    (["test_als", "-issparse", "1", "-pp", "0"],
     "sparse engines.*the JAX package ignores"),
    (["test_als", "-model", "Tucker", "-pp", "1", "-device_loop", "1"],
     "Tucker never reads it; the JAX package ignores"),
    (["run", "-pp", "1"], "run never reads it"),
    (["pp_bench"], "pp_bench never reads it"),
])
def test_cli_refuses_layouts_where_jax_ignores_it(argv, match):
    with pytest.raises(SystemExit, match=match):
        cli.main(argv + ["-layouts", "1", "-device", "cpu"])
