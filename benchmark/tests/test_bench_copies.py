"""The benchmark's frozen copies, pinned to their originals in the port
at small sizes, and the roofline counts at shapes worked out by hand."""

import random

import numpy as np
import pytest
import torch

from benchmark import peaks, trace
from benchmark.run import load
from benchmark.tests.conftest import REPO
from pairwise_perturbation_tpu_torch import phase_profile
from pairwise_perturbation_tpu_torch.scripts import _bench
from pairwise_perturbation_tpu_torch.utils import synth

collinear = load(REPO, "generators", "collinear_cp")
tucker_decay = load(REPO, "generators", "tucker_decay")
random_cp = load(REPO, "generators", "random_cp")
exact = load(REPO, "metrics", "exact_sweep_roofline_pct")
build = load(REPO, "metrics", "pp_build_roofline_pct")


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 + 11])
def test_collinearity_factors_are_the_ports(seed):
    lens, R = (3, 9, 7, 20), 4
    a, la = collinear.collinearity_factors(
        lens, R, 0.5, 0.9, np.random.default_rng(seed))
    b, lb = synth.gen_collinearity_factors(
        lens, R, 0.5, 0.9, np.random.default_rng(seed))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert np.array_equal(la, lb)


def test_collinear_tensor_is_the_ports_without_noise():
    conf = {"rank": 4, "tensor": {"data_seed": 5, "colmin": 0.5,
                                  "colmax": 0.9, "rationoise": 0.0}}
    V = collinear.make((3, 9, 7, 20), conf, torch.device("cpu"),
                       torch.float64)
    ref = synth.gen_collinearity((3, 9, 7, 20), 4, 0.5, 0.9,
                                 np.random.default_rng(5))
    np.testing.assert_allclose(V.numpy(), ref, rtol=1e-12, atol=1e-12)


def test_collinear_noise_ratio_and_seed():
    conf = {"rank": 4, "tensor": {"data_seed": 5, "colmin": 0.5,
                                  "colmax": 0.9, "rationoise": 0.01}}
    shape = (3, 9, 7, 20)
    V = collinear.make(shape, conf, torch.device("cpu"), torch.float64)
    clean = torch.from_numpy(synth.gen_collinearity(
        shape, 4, 0.5, 0.9, np.random.default_rng(5)))
    ratio = float(torch.linalg.vector_norm(V - clean)
                  / torch.linalg.vector_norm(clean))
    assert ratio == pytest.approx(0.01, rel=1e-9)
    assert torch.equal(V, collinear.make(shape, conf, torch.device("cpu"),
                                         torch.float64))


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11])
def test_random_cp_is_the_ports(seed):
    shape, R = (4, 5, 3, 6), 3
    conf = {"rank": R, "tensor": {"data_seed": seed}}
    V = random_cp.make(shape, conf, torch.device("cpu"), torch.float64)
    ref = synth.random_cp_tensor(shape, R, np.random.default_rng(seed))
    np.testing.assert_allclose(V.numpy(), ref, rtol=1e-12, atol=1e-12)
    V32 = random_cp.make(shape, conf, torch.device("cpu"))
    assert V32.dtype == torch.float32
    assert torch.equal(V32, V.float())


def test_tucker_stand_in_spectrum():
    """No original in the port: its multilinear ranks are the widths,
    and the fitted ranks cut into a spectrum that goes on decaying."""
    conf = {"ranks": [3, 4, 4, 8], "tensor": {
        "data_seed": 2, "overfit": 2.0, "decay": 1.0, "rationoise": 0.0}}
    shape = (3, 12, 12, 40)
    V = tucker_decay.make(shape, conf, torch.device("cpu"), torch.float64)
    widths = (3, 8, 8, 16)
    for n, (s, r, t) in enumerate(zip(shape, conf["ranks"], widths)):
        sv = torch.linalg.svdvals(V.movedim(n, 0).reshape(s, -1))
        assert int(torch.sum(sv > 1e-10 * sv[0])) == t
        if r < s:
            assert sv[r] > 1e-3 * sv[0]
    assert torch.equal(V, tucker_decay.make(shape, conf,
                                            torch.device("cpu"),
                                            torch.float64))


def test_busy_is_phase_profiles():
    rng = random.Random(1)
    for _ in range(50):
        iv = []
        for _ in range(rng.randrange(0, 30)):
            s = rng.uniform(0, 100)
            iv.append((s, s + rng.uniform(0, 10)))
        assert trace.busy(iv) == pytest.approx(phase_profile.busy_us(iv),
                                               abs=1e-9)
        assert sum(e - s for s, e in trace.merged(iv)) == pytest.approx(
            trace.busy(iv), abs=1e-9)


def test_peaks_are_the_ports():
    assert peaks.HBM_BYTES_PER_S == _bench.HBM_BYTES_PER_S
    assert peaks.least_time_s(67e12, 1.0) == (1.0, "compute")
    assert peaks.least_time_s(1.0, 3.35e12) == (1.0, "memory")


def test_overlap_inside_ranges():
    union = trace.merged([(0, 2), (1, 3), (5, 6), (8, 10)])
    starts = [s for s, _ in union]
    assert union == [[0, 3], [5, 6], [8, 10]]
    assert trace.overlap(union, starts, 2, 9) == pytest.approx(3.0)
    assert trace.overlap(union, starts, 3, 5) == 0.0


def test_cp_dt_sweep_counts_by_hand():
    """(2, 3, 4, 5), R = 2, midpoint tree (0,1) | (2,3): node (0,1)
    from V: 2*120*2 for the first contraction, then mode 2 (4) on
    (2,3,4) x R: 2*24*2 -> 576; node (2,3): 480, then mode 1 on
    (2,4,5) x R: 2*40*2 -> 640; leaves 2*6*2 twice and 2*20*2 twice."""
    flops, nbytes = exact.cp_counts((2, 3, 4, 5), 2, None, 4)
    assert flops == 576 + 640 + 24 + 24 + 80 + 80
    assert nbytes == 4 * (120 + 2 * 2 * 14)


def test_cp_dt_sweep_counts_with_a_split():
    """Root split 0: (0,0) | (1,3), then (1,3) at its midpoint: (1,2) |
    (3,3), and (1,2): (1,1) | (2,2). Node (0,0) from V: 2*120*2, then
    the cheapest order drops mode 3 (-> 2*24*2) and mode 2 (-> 2*6*2);
    node (1,3) from V drops mode 0: 2*120*2; its children drop one and
    two modes of a (3,4,5) x R tensor; (1,2)'s children one of (3,4)."""
    flops, _ = exact.cp_counts((2, 3, 4, 5), 2, 0, 4)
    node00 = 480 + 2 * 24 * 2 + 2 * 6 * 2
    node13 = 480
    node12 = 2 * 60 * 2          # from (1,3): drop mode 3
    node33 = 2 * 60 * 2 + 2 * 15 * 2   # drop 2 (4) then 1 (3): 60*2, 15*2
    node11 = 2 * 12 * 2
    node22 = 2 * 12 * 2
    assert flops == node00 + node13 + node12 + node33 + node11 + node22


def test_tucker_dt_sweep_counts_by_hand():
    """(4, 6), ranks (2, 3): leaves from V 2*24*3 and 2*24*2; mode 0
    small side (m=3 < 4): 2*4*9 + 2*4*3*2; mode 1 mode side: 2*36*2;
    core 2*6*3*2."""
    flops, nbytes = exact.tucker_counts((4, 6), (2, 3), 4)
    assert flops == 144 + 96 + 120 + 144 + 72
    assert nbytes == 4 * (24 + 2 * (8 + 18) + 6)


def test_pp_build_counts_by_hand():
    flops, nbytes = build.cp_counts((2, 3, 4, 5), 2, 4)
    assert flops == 3 * 2 * 120 * 2
    assert nbytes == 4 * (120 + 71 * 2 + 2 * 14 * 2)
    flops, nbytes = build.tucker_counts((2, 3, 4, 5), (1, 2, 2, 3), 4)
    # pairs (i,j): s_i s_j times the other two ranks; singles s_i times
    # the other three; factors s r
    pairs = 2*3*2*3 + 2*4*2*3 + 2*5*2*2 + 3*4*1*3 + 3*5*1*2 + 4*5*1*2
    singles = 2*12 + 3*6 + 4*6 + 5*4
    assert flops == 2 * 120 * (1 + 2 + 2)
    assert nbytes == 4 * (120 + pairs + singles + (2 + 6 + 8 + 15))
