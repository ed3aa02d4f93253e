"""Plain float64 reference of a Tucker fit's answer, worked out again
from V and the returned factors and core alone. Imports torch only.

For factors W_n (s_n x r_n) and core C of V:

- the core that these factors give, C_ref = V x_0 W_0^T ... x_N W_N^T;
- diffV = ||V - C x_0 W_0 ... x_N W_N||, from the reconstruction itself;
- one exact HOOI sweep from the returned factors (modes in order, each
  the top r_n left singular vectors of V contracted with the other
  factors, by eigh of a Gram), whose core norm can only grow: how much it
  grows says how far the fit stopped from the stationary point it claims
  (als_Tucker.cxx:120-176).

V is read twice for all fits, in float64 blocks along its last mode."""

from __future__ import annotations

import math

import torch

BLOCK_ELEMS = 1 << 26


def _contract_lead(T, Ws, skip=None):
    """T (s_0, ..., s_{N-2}, c) with W_n^T applied to each leading mode
    n != skip: (r_0 or s_0, ..., c)."""
    for n, W in enumerate(Ws):
        if n != skip:
            T = torch.movedim(torch.tensordot(T, W, dims=([n], [0])), -1, n)
    return T


def _top_eig_sum(G, r):
    return float(torch.sum(torch.linalg.eigvalsh(G)[-r:]))


def _top_vectors(G, r):
    return torch.linalg.eigh(G)[1][:, -r:]


def fit_readings(V, fits):
    """[(core gap, orthonormality gap, diffV, ||C_q||, ||C_next||)] of
    each fit, in float64, and ||V||; C_q is the core of orthonormal bases
    of the returned factors, C_next that of one HOOI sweep from them."""
    shape = tuple(V.shape)
    order = len(shape)
    lead = math.prod(shape[:-1])
    flat = V.reshape(lead, shape[-1])
    b = max(1, BLOCK_ELEMS // lead)
    Ws = [[W.to(V.device, torch.float64) for W in f.factors] for f in fits]
    cores = [f.core.to(V.device, torch.float64) for f in fits]
    ranks = [tuple(W.shape[1] for W in Wk) for Wk in Ws]
    # pass 1: V x_last W_last^T (for the core and the HOOI sweep's first
    # N-1 modes) and the residual of the returned core
    Z = [torch.zeros(*shape[:-1], r[-1], dtype=torch.float64,
                     device=V.device) for r in ranks]
    Q = [None] * len(fits)
    for k, (Wk, C) in enumerate(zip(Ws, cores)):
        T = C
        for n in range(order - 1):
            T = torch.movedim(torch.tensordot(T, Wk[n], dims=([n], [1])),
                              -1, n)
        Q[k] = T.reshape(lead, -1)
    res_sq = [0.0] * len(fits)
    v_sq = 0.0
    for c0 in range(0, shape[-1], b):
        Vb = flat[:, c0:c0 + b].to(torch.float64)
        v_sq += float(torch.sum(Vb * Vb))
        for k, Wk in enumerate(Ws):
            D = Wk[-1][c0:c0 + b]
            Z[k] += (Vb @ D).reshape(Z[k].shape)
            res_sq[k] += float(torch.sum((Vb - Q[k] @ D.T) ** 2))
    out_core, new = [], []
    for k, Wk in enumerate(Ws):
        C_ref = _contract_lead(Z[k], Wk[:-1])
        gap = float(torch.linalg.vector_norm(cores[k] - C_ref)
                    / torch.linalg.vector_norm(C_ref))
        orth = max(float(torch.max(torch.abs(
            W.T @ W - torch.eye(W.shape[1], dtype=W.dtype,
                                device=W.device)))) for W in Wk)
        # the HOOI sweep starts from orthonormal bases of the returned
        # factors' spans (W = Q R): a factor's rounding off orthonormality
        # would otherwise change the core norm more than a sweep does
        QR = [torch.linalg.qr(W) for W in Wk]
        Zq = Z[k] @ torch.linalg.inv(QR[-1][1])
        W_new = [Q for Q, _ in QR]
        cn = float(torch.linalg.vector_norm(_contract_lead(Zq, W_new[:-1])))
        out_core.append((gap, orth, cn))
        # HOOI: modes 0..N-2 from Zq (the last factor still the returned
        # one), each with the factors updated before it
        for n in range(order - 1):
            Y = _contract_lead(Zq, W_new[:-1], skip=n)
            A = Y.movedim(n, 0).reshape(shape[n], -1)
            W_new[n] = _top_vectors(A @ A.T, ranks[k][n])
        new.append(W_new)
    # pass 2: the last mode's unfolding with the updated leading factors;
    # ||C_next||^2 is the sum of its Gram's top r_last eigenvalues
    grams = [torch.zeros(math.prod(r[:-1]), math.prod(r[:-1]),
                         dtype=torch.float64, device=V.device)
             for r in ranks]
    for c0 in range(0, shape[-1], b):
        Vb = flat[:, c0:c0 + b].to(torch.float64)
        Vb = Vb.reshape(*shape[:-1], -1)
        for k, W_new in enumerate(new):
            A = _contract_lead(Vb, W_new[:-1]).reshape(-1, Vb.shape[-1])
            grams[k] += A @ A.T
    out = []
    for k in range(len(fits)):
        gap, orth, cn = out_core[k]
        cn_next = math.sqrt(max(_top_eig_sum(grams[k], ranks[k][-1]), 0.0))
        out.append((gap, orth, math.sqrt(res_sq[k]), cn, cn_next))
    return out, math.sqrt(v_sq)


def judge(V, fits, conf):
    """The numbers compared, each the worst over the converged fits:

    - ``core_gap``: ||C - C_ref|| / ||C_ref||;
    - ``orth_gap``: the largest entry of |W_n^T W_n - I| over the modes;
    - ``diffV_gap``: |reported - reference diffV| / reference diffV;
    - ``hooi_gain``: (||C_next|| - ||C_q||) / (tol ||V||), the core
      norm one more exact sweep from the returned subspaces would still
      win, against the tolerance the fit claims to have met."""
    done = [f for f in fits if f.converged]
    if not done:
        return {}
    readings, vnorm = fit_readings(V, done)
    tol_abs = float(conf["tol"]) * vnorm
    rows = [(gap, orth, abs(f.diffV - dv) / dv, (cn_next - cn) / tol_abs)
            for f, (gap, orth, dv, cn, cn_next) in zip(done, readings)]
    return {"core_gap": max(r[0] for r in rows),
            "orth_gap": max(r[1] for r in rows),
            "diffV_gap": max(r[2] for r in rows),
            "hooi_gain": max(r[3] for r in rows)}
