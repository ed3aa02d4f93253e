"""A Tucker stand-in with a multilinear spectrum that the configured
ranks cut into, built on the device from ``data_seed``.

V = G x_0 U_0 x_1 U_1 ... + noise, where U_n (s_n x t_n) has orthonormal
columns (QR of a standard normal matrix), t_n = min(s_n, round(
``overfit`` r_n)) is wider than the fitted rank r_n, and the core G is
standard normal, scaled along each mode n with r_n < s_n by
exp(-j / (``decay`` r_n)) for its j-th index. So each mode's spectrum
decays past the fitted rank without a gap at it, the truncated HOSVD is
not yet the best rank-(r_0, ..., r_N) fit, and HOOI-type sweeps still
move the factors. Gaussian noise of ``rationoise`` times ||V|| is added.
The reference has no such generator (it fits Tucker to the coil-100 and
time-lapse images); this one is the benchmark's own."""

from __future__ import annotations

import torch


def make(shape, conf, device, dtype=torch.float32):
    p = conf["tensor"]
    ranks = [int(r) for r in conf["ranks"]]
    gen = torch.Generator(device=device).manual_seed(int(p["data_seed"]))
    order = len(shape)
    widths = [min(s, int(round(p["overfit"] * r))) for s, r in
              zip(shape, ranks)]
    Us = [torch.linalg.qr(torch.randn((s, t), generator=gen, device=device,
                                      dtype=torch.float64))[0]
          for s, t in zip(shape, widths)]
    G = torch.randn(widths, generator=gen, device=device,
                    dtype=torch.float64)
    for n, (s, r, t) in enumerate(zip(shape, ranks, widths)):
        if r < s:
            d = torch.exp(-torch.arange(t, device=device,
                                        dtype=torch.float64)
                          / (p["decay"] * r))
            G = G * d.reshape([-1 if m == n else 1 for m in range(order)])
    # G x_n U_n over the first N-1 modes (small), then the last mode in
    # row blocks of V
    for n in range(order - 1):
        G = torch.movedim(torch.tensordot(G, Us[n], dims=([n], [1])),
                          -1, n)
    left = G.reshape(-1, widths[-1])
    V = torch.empty(tuple(shape), dtype=dtype, device=device)
    flat = V.view(-1, shape[-1])
    rows = max(1, (1 << 24) // shape[-1])
    for r0 in range(0, flat.shape[0], rows):
        flat[r0:r0 + rows] = (left[r0:r0 + rows] @ Us[-1].T).to(dtype)
    ratio = float(p["rationoise"])
    if ratio > 0:
        noise = torch.randn(V.shape, generator=gen, device=device,
                            dtype=dtype)
        scale = ratio * torch.linalg.vector_norm(V, dtype=torch.float64) \
            / torch.linalg.vector_norm(noise, dtype=torch.float64)
        V.add_(noise.mul_(scale.to(dtype)))
        del noise
    return V
