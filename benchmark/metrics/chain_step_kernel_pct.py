"""Share of the later steps of the CP contraction chains on a
rank-carrying intermediate that the hand-written chain_step kernel served
(contractions and kernels): the port's ``contract.step_kernel`` counter
over it plus ``contract.step_einsum`` (the same steps left to
``torch.einsum``, which copies the intermediate into the permuted order
first). A rank-major cache-chain step over its first or last mode is a
batched GEMM on the intermediate in place and counts in neither. Counted
from the scoped stretch on; a program without the counters reads
nothing."""

KERNEL = "contract.step_kernel"
EINSUM = "contract.step_einsum"


def read(r):
    kernel = r.stats[KERNEL][0] if KERNEL in r.stats else 0
    einsum = r.stats[EINSUM][0] if EINSUM in r.stats else 0
    if not kernel + einsum:
        return None
    return 100.0 * kernel / (kernel + einsum)
