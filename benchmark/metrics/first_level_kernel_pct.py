"""Share of the first-level contractions of V over a non-minor mode that
the hand-written mid_contract kernel served (contractions and kernels):
the port's ``contract.first_kernel`` counter over it plus
``contract.first_einsum`` (the same contractions left to
``torch.einsum``, which copies V into the permuted order first). A
contraction over V's last mode is a plain GEMM and counts in neither.
Counted from the scoped stretch on; a program without the counters reads
nothing."""

KERNEL = "contract.first_kernel"
EINSUM = "contract.first_einsum"


def read(r):
    kernel = r.stats[KERNEL][0] if KERNEL in r.stats else 0
    einsum = r.stats[EINSUM][0] if EINSUM in r.stats else 0
    if not kernel + einsum:
        return None
    return 100.0 * kernel / (kernel + einsum)
