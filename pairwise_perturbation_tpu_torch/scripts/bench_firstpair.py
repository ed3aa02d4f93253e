"""Time the first-level contractions of an order-4 tensor against torch's
einsum at the coil-100 shape, then the PP cache build, the DT sweep and
the order-3 sweep with and without the kernels.

The port's counterpart of ``scripts/bench_firstpair.py``, in its order
and naming ("XLA" read as "torch"):

- ``V x_1 W1``, ``V x_2 W2``, ``V x_3 W3`` by ``torch.einsum``;
- ``mid_contract`` at modes 1 and 2 (K4, rank-minor), ``last_contract``
  at mode 3 (K5) and ``torch.matmul`` of the (N, B) view, the library
  call that computes K5's function; the max errors against the einsums;
- ``contract.build_pp_caches`` and ``cp.dt_sweep``, whose non-minor
  chain roots take the mid_contract kernel on a card
  (``contract._kernel_first``; the cache build in its rank-outer layout)
  and the einsum on the CPU, so the einsum rows above are the einsum's
  time;
- one order-3 ALS sweep (MTTKRP, Gram, ``svd_solve`` per mode, then
  ``normalize_factors``) at ``--order3-size``^3 with ``config.use_kernels``
  off and on (K1-K3).

    python -m pairwise_perturbation_tpu_torch.scripts.bench_firstpair \\
        [--device cpu] [--shape 3,128,128,7200] [--rank 10]
"""

from __future__ import annotations

import torch

from pairwise_perturbation_tpu_torch import config
from pairwise_perturbation_tpu_torch.models import cp
from pairwise_perturbation_tpu_torch.ops import contract, solve
from pairwise_perturbation_tpu_torch.ops.kernels.last_contract import \
    last_contract
from pairwise_perturbation_tpu_torch.ops.kernels.mid_contract import \
    mid_contract
from pairwise_perturbation_tpu_torch.scripts import _bench

# f32 sums of up to B products in other orders (bf16 nowhere here).
TOL = 1e-4


def _extra(p):
    p.add_argument("--order3-size", type=int, default=200,
                   help="size of the order-3 tensor of the sweep rows")


def run(argv=None):
    args = _bench.parse(__doc__, argv, _extra)
    bench = _bench.Bench(args.device, args.n)
    dev, R = bench.device, args.rank
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    V = torch.rand(args.shape, generator=gen, device=dev)
    Ws = [torch.rand((s, R), generator=gen, device=dev) for s in args.shape]

    def torch1():
        return torch.einsum("abcd,bZ->acdZ", V, Ws[1])

    def torch2():
        return torch.einsum("abcd,cZ->abdZ", V, Ws[2])

    def torch3():
        return torch.einsum("abcd,dZ->abcZ", V, Ws[3])

    def matmul3():
        return (V.reshape(-1, V.shape[-1]) @ Ws[3]).reshape(
            V.shape[:-1] + (R,))

    bench.time("torch V x_1 W1", torch1)
    bench.time("torch V x_2 W2", torch2)
    bench.time("torch V x_3 W3", torch3)
    bench.time("mid_contract mode 1", lambda: mid_contract(V, Ws[1], 1),
               kernel="K4")
    bench.time("mid_contract mode 2", lambda: mid_contract(V, Ws[2], 2),
               kernel="K4")
    bench.time("last_contract mode 3", lambda: last_contract(V, Ws[3]),
               kernel="K5")
    bench.time("torch.matmul mode 3 (library call for K5)", matmul3)
    bench.check("mode1 max err", lambda: mid_contract(V, Ws[1], 1), torch1,
                TOL, kernel="K4")
    bench.check("mode2 max err", lambda: mid_contract(V, Ws[2], 2), torch2,
                TOL, kernel="K4")
    bench.check("mode3 max err", lambda: last_contract(V, Ws[3]), torch3,
                TOL, kernel="K5")

    bench.time("build_pp_caches", lambda: contract.build_pp_caches(V, Ws),
               kernel="K4")
    bench.time("dt_sweep", lambda: cp.dt_sweep(V, Ws, 0.0, solver="svd"),
               kernel="K4")

    S = args.order3_size
    V3 = torch.rand((S, S, S), generator=gen, device=dev)
    Ws3 = [torch.rand((S, R), generator=gen, device=dev) for _ in range(3)]

    def o3_sweep(use_kernels):
        Wl = list(Ws3)
        with config.override(use_kernels=use_kernels):
            for i in range(3):
                M = contract.mttkrp(V3, Wl, i)
                Sg = contract.hadamard_gram(Wl, skip_mode=i)
                Wl[i] = solve.svd_solve(M, Sg)
        return contract.normalize_factors(Wl)

    bench.time("order3 sweep torch", lambda: o3_sweep(False), n=2 * args.n)
    bench.time("order3 sweep kernels", lambda: o3_sweep(True), n=2 * args.n,
               kernel="K1-K3")
    bench.check("order3 MTTKRP max err", lambda: _mttkrps(V3, Ws3, True),
                lambda: _mttkrps(V3, Ws3, False), TOL, kernel="K1-K3")
    return bench.finish(), bench.rows


def _mttkrps(V3, Ws3, use_kernels):
    with config.override(use_kernels=use_kernels):
        return [contract.mttkrp(V3, Ws3, i) for i in range(3)]


main = _bench.main_of(run)

if __name__ == "__main__":
    raise SystemExit(main())
