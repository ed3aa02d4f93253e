"""The port's ``pp_bench`` (CP) and the ``bench`` switch of ``als_cp_pp``
against the JAX package, on the CPU, from the same numpy tensor and the
same numpy initial factors.

In float64 the factors each row kind ends with must equal the JAX
package's ``dt_sweep``, ``pp_build_caches`` and ``pp_sweep`` run on the
same inputs to round-off (rel 1e-10, as tests/test_torch_cp.py's one-sweep
parity): the sums run in other orders, and eigh is another implementation.
"""

import csv

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from pairwise_perturbation_tpu import cli as jcli
from pairwise_perturbation_tpu import native as jnative
from pairwise_perturbation_tpu.models import cp as jcp
from pairwise_perturbation_tpu_torch import cli
from pairwise_perturbation_tpu_torch.models import cp as tcp
from pairwise_perturbation_tpu_torch.utils import synth

torch.set_num_threads(1)


def _order3():
    return synth.make_tensor("r", 3, 10, 3, dtype=np.float64), 3


def _order4():
    rng = np.random.default_rng(3)
    Ws = [rng.random((s, 3)) for s in (4, 7, 6, 5)]
    return np.einsum("az,bz,cz,dz->abcd", *Ws), 3


FIXTURES = {"order3": _order3, "order4": _order4}


def _inputs(fixture):
    V, R = FIXTURES[fixture]()
    rng = np.random.default_rng(7)
    W0 = [rng.random((s, R)) for s in V.shape]
    split = jnative.plan_tree_split_traffic(V.shape, R)[0]
    return V, W0, (None if split == (V.ndim - 1) // 2 else split)


def _close(t, j, tol=1e-10):
    j = np.asarray(j)
    assert np.max(np.abs(t.numpy() - j)) <= tol * np.max(np.abs(j))


@pytest.mark.parametrize("fixture", ["order3", "order4"])
@pytest.mark.parametrize("lam,magni", [(0.0, 1.0), (1e-3, 0.8)])
def test_pp_bench_body_matches_jax_sweeps(fixture, lam, magni):
    """[DTtime]: one DT sweep from W0; [PPfirst]: a cache build and one PP
    sweep from W0 and zero dWs; [PPsecond]: the next PP sweep on the same
    caches; each equal to the JAX package's sweeps on the same inputs."""
    V, W0, split = _inputs(fixture)
    got = cli.pp_bench_cp(torch.from_numpy(V),
                          [torch.from_numpy(w) for w in W0], lam, magni,
                          maxiter=2, split=split)
    jV, jW0 = jnp.asarray(V), [jnp.asarray(w) for w in W0]
    jlam = jnp.asarray(lam)
    want_dt, _ = jcp.dt_sweep(jV, jW0, jlam, solver="svd", root_split=split)
    single, pair = jcp.pp_build_caches(jV, jW0)
    zeros = [jnp.zeros_like(w) for w in jW0]
    want_1, dWs, _ = jcp.pp_sweep(single, pair, jW0, jW0, zeros, jlam, magni,
                                  solver="svd")
    want_2, _, _ = jcp.pp_sweep(single, pair, want_1, jW0, dWs, jlam, magni,
                                solver="svd")
    for kind, want in (("DTtime", want_dt), ("PPfirst", want_1),
                       ("PPsecond", want_2)):
        assert len(got[kind]) == V.ndim
        for t, j in zip(got[kind], want):
            _close(t, j)


def _bench_csv(main, path, dtype, dim):
    rc = main(["pp_bench", "-model", "CP", "-tensor", "r", "-dim", str(dim),
               "-size", "8", "-rank", "3", "-maxiter", "2", "-dtype", dtype,
               "-quiet", "-filename", str(path)] +
              (["-device", "cpu"] if main is cli.main else []))
    assert rc == 0
    with open(path) as fh:
        return list(csv.reader(fh))


@pytest.mark.parametrize("dtype,dim", [("float32", 3), ("float64", 4)])
def test_pp_bench_csv_matches_jax(tmp_path, dtype, dim):
    """The port's pp_bench CSV has the JAX cmd_pp_bench's header and the
    same sequence of row kinds at the same arguments (-maxiter 2), with
    positive, finite times."""
    got = _bench_csv(cli.main, tmp_path / "port.csv", dtype, dim)
    want = _bench_csv(jcli.main, tmp_path / "jax.csv", dtype, dim)
    assert got[0] == want[0] == ["[timetype]", "[dtime]"]
    assert [r[0] for r in got[1:]] == [r[0] for r in want[1:]] == \
        ["[DTtime]"] * 2 + ["[PPfirst]", "[PPsecond]"] * 2
    times = np.array([float(r[1]) for r in got[1:]])
    assert np.isfinite(times).all() and (times > 0).all()


def test_pp_bench_refuses_sparse():
    with pytest.raises(SystemExit, match="no sparse engine"):
        cli.main(["pp_bench", "-issparse", "1", "-device", "cpu"])


@pytest.mark.parametrize("shape", [(9, 10, 11), (4, 7, 6, 5)])
def test_als_cp_pp_bench_mode_matches_jax(shape):
    """cfg.bench: one PP phase straight from the given factors, no DT
    sweeps and no restart checks, then return; the same logged history
    and factors as the JAX package's. The initial factors are the
    tensor's rank-3 factors moved by 1%; PP without restarts drifts off
    within a few sweeps here, so the run stops at maxiter 4, and maxiter 20
    (the 15-sweep cache cap) is held to the JAX history's iterations and
    flags alone."""
    rng = np.random.default_rng(len(shape))
    true = [rng.random((s, 3)) for s in shape]
    V = np.einsum(",".join("abcd"[i] + "z" for i in range(len(shape)))
                  + "->" + "abcd"[:len(shape)], *true)
    W0 = [w * (1 + 0.01 * rng.standard_normal(w.shape)) for w in true]

    def run(maxiter):
        kw = dict(tol=0.0, pp_res_tol=1e-6, maxiter=maxiter, resprint=1,
                  bench=True)
        return (jcp.als_cp_pp(V, [jnp.asarray(w) for w in W0],
                              jcp.CPConfig(**kw)),
                tcp.als_cp_pp(torch.from_numpy(V),
                              [torch.from_numpy(w) for w in W0],
                              tcp.CPConfig(**kw)))

    rj, rt = run(4)
    hj = [(h["iter"], h["pp"]) for h in rj.history]
    assert [(h["iter"], h["pp"]) for h in rt.history] == hj == \
        [(i, 1) for i in range(5)]          # PP rows from the start
    for a, b in zip(rj.history, rt.history):
        assert abs(a["gradnorm"] - b["gradnorm"]) <= 1e-8 * abs(a["gradnorm"])
    assert rt.iters == rj.iters
    for t, j in zip(rt.factors, rj.factors):
        _close(t, j, 1e-8)
    rj, rt = run(20)  # the 15th sweep reaches the cache cap, unlogged
    assert [(h["iter"], h["pp"]) for h in rt.history] == \
        [(h["iter"], h["pp"]) for h in rj.history] == [(i, 1) for i in range(15)]
    assert rt.iters == rj.iters == 15
