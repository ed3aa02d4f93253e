"""Plain float64 reference of a CP fit's answer: what the fit reports
(its gradient norm and its residual norm) and whether its factors are
the stationary point that it claims, worked out again from V and the
returned factors alone. Imports torch only.

For factors W_0..W_{N-1} of V (rank R, ridge lambda = 0):

- M_n = MTTKRP(V, W, n), S_n = Hadamard product of W_m^T W_m over m != n,
  gradient G_n = W_n S_n - M_n, gradnorm = sqrt(sum_n ||G_n||^2)
  (common.cxx:1009-1052);
- diffV = ||V - [[W_0, ..., W_{N-1}]]||, from the reconstruction itself,
  not from the norm identity.

V is read once for all fits, in float64 blocks along its last mode, so
that the reference fits beside the program's V on the card.

Block form, for a V that lives in blocks on several cards (one rank
each): :func:`block_sums` reads one rank's zero-padded block in float64
chunks and returns every sum over V's entries that the numbers need as
one float64 vector of partials (||V||^2, each fit's MTTKRP rows and
||V - [[W]]||^2 from the reconstruction); the partials summed over the
ranks give :func:`judge_sums` the numbers that :func:`judge` gives for
the whole V."""

from __future__ import annotations

import math

import torch

BLOCK_ELEMS = 1 << 26


def _khatri_rao(mats):
    out = mats[0]
    for M in mats[1:]:
        out = (out[:, None, :] * M[None, :, :]).reshape(-1, M.shape[1])
    return out


def fit_readings(V, fits):
    """[(gradnorm, diffV)] in float64 for the factors of each fit, and
    ||V||."""
    shape = tuple(V.shape)
    order = len(shape)
    lead = math.prod(shape[:-1])
    Ws = [[W.to(V.device, torch.float64) for W in f.factors] for f in fits]
    KR = [_khatri_rao(W[:-1]) for W in Ws]
    Ms = [[torch.zeros_like(W[n]) for n in range(order)] for W in Ws]
    res_sq = [0.0] * len(fits)
    v_sq = 0.0
    b = max(1, BLOCK_ELEMS // lead)
    flat = V.reshape(lead, shape[-1])
    for c0 in range(0, shape[-1], b):
        Vb = flat[:, c0:c0 + b].to(torch.float64)
        v_sq += float(torch.sum(Vb * Vb))
        for k, W in enumerate(Ws):
            D = W[-1][c0:c0 + b]
            Ms[k][-1][c0:c0 + b] = Vb.T @ KR[k]
            P = (Vb @ D).reshape(*shape[:-1], -1)
            for n in range(order - 1):
                T = P
                for m in reversed(range(order - 1)):
                    if m != n:
                        T = torch.sum(T * W[m].reshape(
                            [-1 if a == m else 1 for a in range(T.ndim - 1)]
                            + [W[m].shape[1]]), dim=m, keepdim=True)
                Ms[k][n] += T.reshape(shape[n], -1)
            res_sq[k] += float(torch.sum((Vb - KR[k] @ D.T) ** 2))
    out = []
    for k, W in enumerate(Ws):
        grams = [A.T @ A for A in W]
        gn_sq = 0.0
        for n in range(order):
            S = torch.ones_like(grams[0])
            for m in range(order):
                if m != n:
                    S = S * grams[m]
            gn_sq += float(torch.sum((W[n] @ S - Ms[k][n]) ** 2))
        out.append((math.sqrt(gn_sq), math.sqrt(res_sq[k])))
    return out, math.sqrt(v_sq)


def judge(V, fits, conf):
    """The numbers compared, each the worst over the converged fits:

    - ``gradnorm_gap``: |reported - reference gradnorm| / (tol ||V||);
    - ``diffV_gap``: |reported - reference diffV| / reference diffV;
    - ``gradnorm_ref``: reference gradnorm / (tol ||V||), above 1 where a
      fit stopped short of the stationarity it claims.

    A fit that never met its tolerance is counted by the caller, not
    here."""
    if float(conf.get("lambda", 0.0)) != 0.0:
        raise ValueError("the CP reference has no ridge term")
    done = [f for f in fits if f.converged]
    if not done:
        return {}
    readings, vnorm = fit_readings(V, done)
    return _numbers(done, readings, vnorm, conf)


def _numbers(done, readings, vnorm, conf):
    """The numbers compared, from the reference's readings of the
    converged fits ``done``."""
    tol_abs = float(conf["tol"]) * vnorm
    gaps, dgaps, refs = [], [], []
    for f, (gn, dv) in zip(done, readings):
        gaps.append(abs(f.metric - gn) / tol_abs)
        dgaps.append(abs(f.diffV - dv) / dv)
        refs.append(gn / tol_abs)
    return {"gradnorm_gap": max(gaps), "diffV_gap": max(dgaps),
            "gradnorm_ref": max(refs)}


def _padded(W, lo, hi):
    """Rows [lo, hi) of W, zero beyond its extent."""
    out = W.new_zeros((hi - lo, W.shape[1]))
    real = W[lo:hi]
    out[:len(real)] = real
    return out


def block_sums(block, spans, shape, fits):
    """The float64 partials of one block of V.

    ``block``: the rank's zero-padded block; ``spans``: its (start, stop)
    in each mode of the padded index space; ``shape``: V's unpadded
    shape; ``fits``: the fits, the factors whole (the converged ones are
    read, as :func:`judge` reads them). The vector holds ||V||^2, then
    for each converged fit its MTTKRP of every mode (the rows of the
    unpadded shape, those outside the block zero) and its residual.

    The block is read once for all fits, BLOCK_ELEMS entries at a time
    (whole rows of its last mode); each chunk's Khatri-Rao rows are
    formed from the factor rows of its own multi-indices, so beside the
    block only a chunk's worth is held."""
    fits = [f for f in fits if f.converged]
    order = len(shape)
    bshape = tuple(block.shape)
    dev = block.device
    f64 = torch.float64
    lead = math.prod(bshape[:-1])
    flat = block.reshape(lead, bshape[-1])
    lo = [a for a, _ in spans]
    Ws = [[_padded(W.to(dev, f64), a, b) for W, (a, b) in
           zip(f.factors, spans)] for f in fits]
    R = Ws[0][0].shape[1] if fits else 1
    Ms = [[torch.zeros((b - a, R), dtype=f64, device=dev)
           for a, b in spans] for _ in fits]
    res_sq = [torch.zeros((), dtype=f64, device=dev) for _ in fits]
    v_sq = torch.zeros((), dtype=f64, device=dev)
    rows = max(1, BLOCK_ELEMS // bshape[-1])
    for r0 in range(0, lead, rows):
        X = flat[r0:r0 + rows].to(f64)
        idx, rest = [], torch.arange(r0, r0 + X.shape[0], device=dev)
        for b in reversed(bshape[:-1]):
            idx.append(rest % b)
            rest = rest // b
        idx.reverse()
        v_sq += torch.sum(X * X)
        for k, W in enumerate(Ws):
            G = [W[m][idx[m]] for m in range(order - 1)]
            KR = G[0]
            for g in G[1:]:
                KR = KR * g
            D = W[-1]
            Ms[k][-1] += X.T @ KR
            P = X @ D
            for n in range(order - 1):
                T = P
                for m in range(order - 1):
                    if m != n:
                        T = T * G[m]
                Ms[k][n].index_add_(0, idx[n], T)
            res_sq[k] += torch.sum((X - KR @ D.T) ** 2)
    parts = [v_sq.reshape(1)]
    for k in range(len(fits)):
        for n in range(order):
            full = torch.zeros((shape[n], R), dtype=f64, device=dev)
            hi = min(spans[n][1], shape[n])
            full[lo[n]:hi] = Ms[k][n][:hi - lo[n]]
            parts.append(full.reshape(-1))
        parts.append(res_sq[k].reshape(1))
    return torch.cat(parts)


def judge_sums(sums, fits, conf):
    """:func:`judge`'s numbers from :func:`block_sums`'s vector summed over
    every block of V."""
    done = [f for f in fits if f.converged]
    if not done:
        return {}
    shape = [W.shape[0] for W in done[0].factors]
    R = done[0].factors[0].shape[1]
    sums = sums.to("cpu", torch.float64)
    vnorm = math.sqrt(float(sums[0]))
    pos = 1
    readings = []
    for f in done:
        W = [A.to("cpu", torch.float64) for A in f.factors]
        Ms = []
        for s in shape:
            Ms.append(sums[pos:pos + s * R].reshape(s, R))
            pos += s * R
        res_sq = float(sums[pos])
        pos += 1
        grams = [A.T @ A for A in W]
        gn_sq = 0.0
        for n in range(len(shape)):
            S = torch.ones_like(grams[0])
            for m in range(len(shape)):
                if m != n:
                    S = S * grams[m]
            gn_sq += float(torch.sum((W[n] @ S - Ms[n]) ** 2))
        readings.append((math.sqrt(gn_sq), math.sqrt(res_sq)))
    return _numbers(done, readings, vnorm, conf)


def judge_block(block, spans, fits, conf, total):
    """:func:`judge`'s numbers for a V held in blocks, one a rank: this
    rank's partials, summed over the ranks by ``total`` (a function that
    returns the sum of a float64 vector over every rank)."""
    if float(conf.get("lambda", 0.0)) != 0.0:
        raise ValueError("the CP reference has no ridge term")
    shape = tuple(int(s) for s in conf["shape"])
    return judge_sums(total(block_sums(block, spans, shape, fits)), fits,
                      conf)
