"""Oracles for the port's kernels.

Counterpart of the Smith-Waterman half of ``repro.kernels.ref``.  Each
oracle uses a *different* mechanism from its kernel — here a sequential
scan over the query for F instead of the closed-form prefix-max — so that
agreement is evidence of correctness.
"""
from __future__ import annotations

from typing import Optional

import torch

__all__ = ["sw_ref", "sw_numpy"]

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
