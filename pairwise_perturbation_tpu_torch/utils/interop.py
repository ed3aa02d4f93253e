"""State transfer between numpy and the port.

The JAX package draws its initial factors with ``jax.random``, whose bits
torch cannot reproduce. The parity tests therefore make the tensor (and
take the JAX package's factors) as numpy arrays and hand the same arrays
to both packages through these two functions.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def from_numpy(V, factors: Sequence, device="cpu", dtype=None,
               v_dtype=None) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(V, factors) as torch tensors on ``device``; ``dtype`` defaults to
    V's own dtype, ``v_dtype`` (V's torch dtype) to ``dtype``. With
    ``v_dtype=torch.bfloat16`` the mixed-precision mode's V is rounded
    from the same numpy values as ``jnp.asarray(V, jnp.bfloat16)``
    rounds them: both round to nearest even, so the bits agree. Arrays
    are copied, never shared with the caller."""
    V = np.asarray(V)
    dtype = dtype or torch.from_numpy(np.empty(0, V.dtype)).dtype

    def conv(x, dt=dtype):
        return torch.tensor(np.asarray(x), dtype=dt, device=device)

    return conv(V, v_dtype or dtype), [conv(W) for W in factors]


def to_numpy(x):
    """A tensor, or a list/tuple of tensors, as numpy arrays on the host."""
    if isinstance(x, (list, tuple)):
        return [to_numpy(t) for t in x]
    return x.detach().cpu().numpy()
