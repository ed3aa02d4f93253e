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
that the reference fits beside the program's V on the card."""

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
    tol_abs = float(conf["tol"]) * vnorm
    gaps, dgaps, refs = [], [], []
    for f, (gn, dv) in zip(done, readings):
        gaps.append(abs(f.metric - gn) / tol_abs)
        dgaps.append(abs(f.diffV - dv) / dv)
        refs.append(gn / tol_abs)
    return {"gradnorm_gap": max(gaps), "diffV_gap": max(dgaps),
            "gradnorm_ref": max(refs)}
