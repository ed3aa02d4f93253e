"""Diagnose the first-level contraction's speed: a read-only pass over V
and the K4' kernel swept over its block width.

The port's counterpart of ``scripts/bench_midvariants.py``, in its order
and naming, over the two (P, B, M) views of the coil-100 tensor that the
first-level contractions read, m1 = (a, b, c*d) and m2 = (a*b, c, d):

- ``column_sum`` (S4, the JAX script's ``_copy_kernel`` "reduce pass"):
  every byte of V read once, one add each, with the rate it reaches
  against the card's 3.35 TB/s; beside it ``V3.sum(1)``, the library call
  that computes the same function;
- ``mid_contract`` rank-major (K4', the JAX script's ``_mm_kernel``, S5)
  at each block width of the CUDA kernel, 128, 256 and 512 columns, in
  place of the JAX script's lane tiles L in {2048, 4096, 8192}; beside it
  the one einsum that computes the same function; the max errors against
  it.

The JAX script's ``dimension_semantics`` and ``cost_estimate`` variants
are Mosaic compiler hints with no CUDA meaning, so they have no rows here.
On the TPU ``_mm_kernel`` dots at DEFAULT precision (bf16 passes); the
port computes true FP32, as its FP32 pins require everywhere.

    python -m pairwise_perturbation_tpu_torch.scripts.bench_midvariants \\
        [--device cpu] [--shape 3,128,128,7200] [--rank 10]
"""

from __future__ import annotations

import torch

from pairwise_perturbation_tpu_torch.ops.kernels.column_sum import \
    column_sum
from pairwise_perturbation_tpu_torch.ops.kernels.mid_contract import (
    BLOCK_COLS, mid_contract)
from pairwise_perturbation_tpu_torch.scripts import _bench

# f32 sums of up to B terms in other orders.
TOL = 1e-4


def run(argv=None):
    args = _bench.parse(__doc__, argv)
    bench = _bench.Bench(args.device, args.n)
    dev, R = bench.device, args.rank
    a, b, c, d = args.shape
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    V = torch.rand(args.shape, generator=gen, device=dev)
    views = {"m1": (V.reshape(a, b, c * d),
                    torch.rand((b, R), generator=gen, device=dev)),
             "m2": (V.reshape(a * b, c, d),
                    torch.rand((c, R), generator=gen, device=dev))}
    nbytes = V.numel() * V.element_size()

    for view, (V3, _) in views.items():
        bench.time(f"reduce-pass {view} column_sum", lambda: column_sum(V3),
                   kernel="S4", nbytes=nbytes)
        bench.time(f"reduce-pass {view} torch.sum",
                   lambda: V3.sum(1, keepdim=True), nbytes=nbytes)
        bench.check(f"reduce-pass {view} max err", lambda: column_sum(V3),
                    lambda: V3.sum(1, keepdim=True), TOL, kernel="S4")
    print("   (dimension_semantics and cost_estimate are Mosaic compiler "
          "hints with no CUDA meaning: no rows)")

    for view, (V3, W) in views.items():
        for cols in BLOCK_COLS:
            bench.time(f"matmul {view} cols={cols}",
                       lambda: mid_contract(V3, W, 1, layout="rank_major",
                                            block_cols=cols), kernel="S5")
        bench.time(f"matmul {view} torch einsum",
                   lambda: torch.einsum("pbm,br->prm", V3, W))
        for cols in BLOCK_COLS:
            bench.check(
                f"matmul {view} cols={cols} max err",
                lambda: mid_contract(V3, W, 1, layout="rank_major",
                                     block_cols=cols).movedim(-1, 1),
                lambda: torch.einsum("pbm,br->prm", V3, W), TOL, kernel="S5")
    return bench.finish(), bench.rows


main = _bench.main_of(run)

if __name__ == "__main__":
    raise SystemExit(main())
