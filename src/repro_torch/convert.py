"""Carry arrays of the reference package across to the port.

The reference hands out jax arrays; ``np.asarray`` of one is a read-only
view, which ``torch.from_numpy`` warns about.  These functions copy, so the
tensor owns its memory.  Like every entry point of the port they place the
result on the card unless the caller names another device.
"""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from .kernels.ops import resolve_device

__all__ = ["matrix_from_numpy", "profile_from_numpy"]


def _f32(a: Any, device: Any) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True)).to(
        resolve_device(device))


def matrix_from_numpy(m: Any, *, device: Any = None) -> torch.Tensor:
    """A substitution matrix (A, A), e.g. ``np.asarray(ops.BLOSUM50)`` of
    the reference, as an f32 tensor."""
    m = _f32(m, device)
    if m.dim() != 2 or m.shape[0] != m.shape[1]:
        raise ValueError(f"substitution matrix must be (A, A), got {tuple(m.shape)}")
    return m


def profile_from_numpy(prof: Any, q_len: int, *,
                       device: Any = None) -> Tuple[torch.Tensor, int]:
    """The reference's ``build_profile`` output ``(prof, q_len)``, with
    ``prof`` taken as ``np.asarray(...)``, as the port's ``(profile, q_len)``:
    an (A, Qp) f32 tensor and the true query length."""
    p = _f32(prof, device)
    if p.dim() != 2 or p.shape[1] % 128 or not 0 <= q_len <= p.shape[1]:
        raise ValueError(f"profile must be (A, Qp) with Qp % 128 == 0 and "
                         f"q_len <= Qp, got {tuple(p.shape)}, q_len={q_len}")
    return p, int(q_len)
