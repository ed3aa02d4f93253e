"""Does consuming the first-level kernel's rank-major output through a
rank-position-aware einsum (no transpose) beat the einsum chain?

The port's counterpart of ``scripts/bench_rankpos.py``, in its order and
naming ("XLA" read as "torch"). Chain under test (coil-100, node (2, 3)
of the DT sweep):

    C1 = V x_1 W1     (kernel, physical (P, R, M): K4', S1)
    out = C1 x_0 W0   (tail einsum; output rank-last (c, d, Z))

against ``torch.einsum("abcd,bZ,aZ->cdZ")``; then the kernel's rank-outer
layout (R, P, M) (S2) with one and two tails down to the leaf M_2
against the einsum chain; then the same rank-major chain with V stored
in bf16 (S3: bf16 V, f32 output) against the port's bf16 einsum chain
(two ``contract.contract_mode_kr`` steps; ``contract.partial_mttkrp``
would take the kernel for the first on a card).

    python -m pairwise_perturbation_tpu_torch.scripts.bench_rankpos \\
        [--device cpu] [--shape 3,128,128,7200] [--rank 10]
"""

from __future__ import annotations

import torch

from pairwise_perturbation_tpu_torch.ops import contract
from pairwise_perturbation_tpu_torch.ops.kernels.mid_contract import \
    mid_contract
from pairwise_perturbation_tpu_torch.scripts import _bench

# f32 sums in other orders; bf16 V: the same bf16-rounded products.
TOL = 1e-4


def kernel_phys(V, W1):
    """(a, Z, c, d): the kernel's physical rank-major output, no copy."""
    return mid_contract(V, W1, 1, layout="rank_major").movedim(-1, 1)


def kernel_zmajor(V, W1):
    """(Z, a, c, d): the kernel's physical rank-outer output, no copy."""
    return mid_contract(V, W1, 1, layout="rank_outer").movedim(-1, 0)


def run(argv=None):
    args = _bench.parse(__doc__, argv)
    bench = _bench.Bench(args.device, args.n)
    dev, R, shape = bench.device, args.rank, args.shape
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    V = torch.rand(shape, generator=gen, device=dev)
    W0 = torch.rand((shape[0], R), generator=gen, device=dev)
    W1 = torch.rand((shape[1], R), generator=gen, device=dev)
    W3 = torch.rand((shape[3], R), generator=gen, device=dev)

    def kernel_tail_rankpos():
        return torch.einsum("aZcd,aZ->cdZ", kernel_phys(V, W1), W0)

    def kernel_tail_rankpos_zfirst():
        return torch.einsum("aZcd,aZ->Zcd", kernel_phys(V, W1), W0)

    def torch_chain():
        return torch.einsum("abcd,bZ,aZ->cdZ", V, W1, W0)

    bench.time("kernel + rank-pos tail (rank-last out)", kernel_tail_rankpos,
               kernel="S1")
    bench.time("kernel + rank-pos tail (rank-major out)",
               kernel_tail_rankpos_zfirst, kernel="S1")
    bench.time("torch chain einsum", torch_chain)
    bench.check("max err", kernel_tail_rankpos, torch_chain, TOL,
                kernel="S1")

    def kernel_zmajor_tail():
        return torch.einsum("Zacd,aZ->Zcd", kernel_zmajor(V, W1), W0)

    def kernel_zmajor_two_tails():
        n23 = torch.einsum("Zacd,aZ->Zcd", kernel_zmajor(V, W1), W0)
        return torch.einsum("Zcd,dZ->cZ", n23, W3)      # M_2 (c, Z)

    def torch_two_tails():
        return torch.einsum("abcd,bZ,aZ,dZ->cZ", V, W1, W0, W3)

    bench.time("kernel(Z-major) + tail", kernel_zmajor_tail, kernel="S2")
    bench.time("kernel(Z-major) + 2 tails -> leaf", kernel_zmajor_two_tails,
               kernel="S2")
    bench.time("torch chain -> leaf", torch_two_tails)
    bench.check("leaf max err", kernel_zmajor_two_tails, torch_two_tails,
                TOL, kernel="S2")

    V16 = V.to(torch.bfloat16)

    def kernel_tail_rankpos16():
        return torch.einsum("aZcd,aZ->cdZ", kernel_phys(V16, W1), W0)

    def torch_chain16():
        T, rem = contract.contract_mode_kr(V16, (0, 1, 2, 3), False, W1, 1)
        return contract.contract_mode_kr(T, rem, True, W0, 0)[0]

    bench.time("bf16 kernel + rank-pos tail", kernel_tail_rankpos16,
               kernel="S3")
    bench.time("bf16 torch chain", torch_chain16)
    bench.check("bf16 max err", kernel_tail_rankpos16, torch_chain16, TOL,
                kernel="S3")
    return bench.finish(), bench.rows


main = _bench.main_of(run)

if __name__ == "__main__":
    raise SystemExit(main())
