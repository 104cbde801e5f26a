"""Oracles for the port's kernels.

Counterpart of ``repro.kernels.ref``.  Each oracle uses a *different*
mechanism from its kernel — a sequential scan over the query for F instead
of the closed-form prefix-max, a materialised softmax instead of the online
one, the token-by-token recurrence instead of the chunked scan — so that
agreement is evidence of correctness.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["sw_ref", "sw_numpy", "attention_ref", "ssd_ref"]

NEG = -1e9


def sw_ref(profile: torch.Tensor, subject: torch.Tensor, gap_open: float,
           gap_extend: float, subject_len: Optional[int] = None) -> torch.Tensor:
    """Oracle: outer loop over subject chars, INNER SEQUENTIAL loop over the
    query for F (the column-direction gap), no prefix-max closed form.

    profile: (A, Q) f32, ``profile[c, i]`` = score(query_i, char c).
    subject: (D,) int codes; entries >= A (or at or past ``subject_len``)
    are padding and are skipped.  Returns the best score, a 0-d f32 tensor
    on the profile's device.
    """
    A, Q = profile.shape
    dev = profile.device
    f32 = torch.float32
    go = torch.tensor(gap_open, dtype=f32, device=dev)
    ge = torch.tensor(gap_extend, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    codes = [int(c) for c in subject.tolist()]
    slen = len(codes) if subject_len is None else subject_len
    h_prev = torch.zeros(Q, dtype=f32, device=dev)
    e_prev = torch.full((Q,), NEG, dtype=f32, device=dev)
    best = zero
    for j, c in enumerate(codes):
        if j >= slen or c >= A:
            continue
        prof = profile[max(c, 0)]
        e = torch.maximum(h_prev - go, e_prev - ge)             # gap in col dir
        diag = torch.cat([zero[None], h_prev[:-1]]) + prof
        h_hat = torch.maximum(torch.maximum(diag, e), zero)
        f_i = torch.tensor(NEG, dtype=f32, device=dev)
        h_up = zero
        col = []
        for i in range(Q):
            f_i = torch.maximum(h_up - go, f_i - ge)
            h_up = torch.maximum(h_hat[i], f_i)
            col.append(h_up)
        h = torch.stack(col)
        best = torch.maximum(best, h.max())
        h_prev, e_prev = h, e
    return best


def sw_numpy(query: str, subject: str, score_fn, gap_open: float, gap_extend: float) -> float:
    """Cell-by-cell numpy triple-check for tiny cases (used by tests only)."""
    import numpy as np
    Q, D = len(query), len(subject)
    H = np.zeros((Q + 1, D + 1))
    E = np.full((Q + 1, D + 1), -1e9)
    F = np.full((Q + 1, D + 1), -1e9)
    best = 0.0
    for i in range(1, Q + 1):
        for j in range(1, D + 1):
            E[i, j] = max(H[i, j - 1] - gap_open, E[i, j - 1] - gap_extend)
            F[i, j] = max(H[i - 1, j] - gap_open, F[i - 1, j] - gap_extend)
            H[i, j] = max(0.0, H[i - 1, j - 1] + score_fn(query[i - 1], subject[j - 1]),
                          E[i, j], F[i, j])
            best = max(best, H[i, j])
    return best


# --------------------------------------------------------------------------
# Flash attention oracle (materialised, fp32)
# --------------------------------------------------------------------------
def attention_ref(q, k, v, *, causal: bool = True,
                  window: Optional[int] = None) -> torch.Tensor:
    """q (B,H,S,D); k/v (B,Hkv,T,D). Returns (B,H,S,D)."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    g = H // Hkv
    k = torch.repeat_interleave(k, g, dim=1)
    v = torch.repeat_interleave(v, g, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q, k).float() * D ** -0.5
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p.to(v.dtype), v)


# --------------------------------------------------------------------------
# SSD oracle: token-by-token recurrence (see also models/ssm.ssd_reference)
# --------------------------------------------------------------------------
def ssd_ref(x, dt, A, B, C, h0=None) -> Tuple[torch.Tensor, torch.Tensor]:
    from ..models.ssm import ssd_reference
    return ssd_reference(x, dt, A, B, C, h0=h0)
