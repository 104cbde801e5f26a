"""Per-chunk symmetric int8 quantisation of gradients.

Counterpart of ``repro.optim.compression``'s ``int8_quantize`` and
``int8_dequantize``.  The reference's ``ef_int8_psum`` (the compressed
data-parallel all-reduce with error feedback) is a collective and comes
with the port's multi-GPU slice.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = ["int8_quantize", "int8_dequantize"]

_CHUNK = 1024


def int8_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (q (n_chunks, 1024) int8, scales (n_chunks, 1) f32): each
    chunk of the flattened f32 input scaled by its max |x| / 127 and
    rounded half to even."""
    flat = x.float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.shape[0]) % _CHUNK))
    chunks = flat.reshape(-1, _CHUNK)
    scale = chunks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(chunks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor, shape: Sequence[int],
                    dtype: torch.dtype) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(tuple(shape)).to(dtype)
