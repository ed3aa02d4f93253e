"""``-layouts 1``: the JAX package's mode-minor copies of V
(its contract.prepare_layouts) against the port, which makes no copies
and reads V in place, on the same numpy inputs, on the CPU.

The JAX functions that read the copies (first_contraction and
_first_contraction_rm, dt_sweep and build_pp_caches) against the port's
on V, to 1e-12 relative (max-norm) in float64 and 1e-5 in float32; the
JAX engines that read the flag (als_cp_dt, als_cp_pp_device,
als_cp_pp_fused) against the port's in float64 to 1e-9 with the same
rows and flags. The port's CLI accepts -layouts 1 where the JAX package
reads it, and its rows are then those of -layouts 0; it refuses the flag,
saying so, where the JAX package ignores it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pairwise_perturbation_tpu import cli as jcli
from pairwise_perturbation_tpu.models import cp as jcp
from pairwise_perturbation_tpu.ops import contract as jc
from pairwise_perturbation_tpu_torch import cli
from pairwise_perturbation_tpu_torch.models import cp as tcp
from pairwise_perturbation_tpu_torch.ops import contract as tc

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


def _jax_layouts(V, modes):
    return jc.prepare_layouts(jnp.asarray(V), modes)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_first_contractions_with_layouts_match_jax(shape, dtype):
    """first_contraction (rank-minor) and _first_contraction_rm
    (rank-major) of every mode on V, against the JAX package's from the
    copy where one exists."""
    V, Ws = _inputs(shape, dtype)
    jl = _jax_layouts(V, list(range(len(shape))))
    for m in range(len(shape)):
        W = Ws[m]
        got, rem = tc.first_contraction(torch.from_numpy(V),
                                        torch.from_numpy(W), m)
        want, jrem = jc.first_contraction(jnp.asarray(V), jl,
                                          jnp.asarray(W), m)
        assert rem == jrem
        assert _rel(got, want) <= TOL[dtype]
        got, rem = tc._first_contraction_rm(torch.from_numpy(V),
                                            torch.from_numpy(W), m)
        want, jrem = jc._first_contraction_rm(jnp.asarray(V), jl,
                                              jnp.asarray(W), m)
        assert rem == jrem
        assert _rel(got, want) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_dt_sweep_with_layouts_matches_jax(shape, dtype):
    """One DT sweep on V against the JAX package's with the tree's root
    copies: factors and grads."""
    V, Ws = _inputs(shape, dtype)
    jl = _jax_layouts(V, jc.chain_root_modes_dt(shape))
    got, gg = tcp.dt_sweep(torch.from_numpy(V),
                           [torch.from_numpy(W) for W in Ws], 0.0)
    want, jg = jcp.dt_sweep(jnp.asarray(V), [jnp.asarray(W) for W in Ws],
                            jnp.asarray(0.0, dtype), jl)
    for a, b in zip(got + gg, list(want) + list(jg)):
        assert _rel(a, b) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_build_pp_caches_with_layouts_matches_jax(shape, dtype):
    """Every pair and single cache on V against the JAX package's from
    the chain roots' copies."""
    V, Ws = _inputs(shape, dtype)
    jl = _jax_layouts(V, jc.chain_root_modes_pp(shape))
    ts, tp = tc.build_pp_caches(torch.from_numpy(V),
                                [torch.from_numpy(W) for W in Ws])
    js, jp = jc.build_pp_caches(jnp.asarray(V), [jnp.asarray(W) for W in Ws],
                                layouts=jl)
    assert sorted(tp) == sorted(jp) and sorted(ts) == sorted(js)
    for k in jp:
        assert _rel(tp[k], jp[k]) <= TOL[dtype], k
    for k in js:
        assert _rel(ts[k], js[k]) <= TOL[dtype], k


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
    """als_cp_dt, als_cp_pp_device and als_cp_pp_fused on V against the
    JAX package's with precompute_layouts: its rows (iter, PP flag),
    gradnorm and diffV to 1e-9 and factors to 1e-9."""
    V, W0 = _problem()
    rj = getattr(jcp, engine)(jnp.asarray(V), [jnp.asarray(w) for w in W0],
                             jcp.CPConfig(**ENGINE_CFG,
                                          precompute_layouts=True))
    rt = getattr(tcp, engine)(torch.from_numpy(V),
                             [torch.from_numpy(w) for w in W0],
                             tcp.CPConfig(**ENGINE_CFG))
    assert [(h["iter"], h["pp"]) for h in rt.history] == \
        [(h["iter"], h["pp"]) for h in rj.history]
    for g, w in zip(rt.history, rj.history):
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


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("argv", [
    ["-pp", "0"], ["-pp", "1", "-device_loop", "1"],
    ["-pp", "1", "-device_loop", "2"]])
def test_cli_layouts_flag_changes_nothing(tmp_path, argv, dtype):
    """Where the port's CLI accepts -layouts 1 it builds nothing: its CSV
    rows are those of -layouts 0, every column but [dtime] the same
    text."""
    base = ["test_als", "-model", "CP", "-tensor", "r", "-dim", "4",
            "-size", "6", "-rank", "3", "-maxiter", "15", "-resprint", "1",
            "-pp_res_tol", "0.1", "-dtype", dtype, "-device", "cpu"] + argv
    on, off = (_csv(cli.main, tmp_path / f"{flag}.csv",
                    base + ["-layouts", flag]) for flag in ("1", "0"))
    assert on[0] == off[0] and len(on) == len(off) > 2
    keep = [k for k, name in enumerate(off[0]) if name != "[dtime]"]
    assert [[r[k] for k in keep] for r in on] == \
        [[r[k] for k in keep] for r in off]


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
