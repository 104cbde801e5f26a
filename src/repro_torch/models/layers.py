"""Shared building blocks: RMSNorm, RoPE, SwiGLU, embeddings, init.

Counterpart of ``repro.models.layers``, with the reference's f32 upcasts
and its casts back to the working dtype.  Initialisers draw from a
``torch.Generator`` on the generator's device: the shapes, dtypes and
distributions are the reference's, the bits are not.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

__all__ = ["rms_norm", "rope_freqs", "apply_rope", "swiglu", "dense_init",
           "embed_init", "init_device", "Params"]

Params = Dict[str, torch.Tensor]


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim//2,) inverse frequencies."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate pairs. x: (..., seq, heads, head_dim); positions: (..., seq)."""
    dh = x.shape[-1]
    inv = rope_freqs(dh, theta, x.device)                        # (dh/2,)
    ang = positions[..., :, None].float() * inv                  # (..., seq, dh/2)
    cos = torch.cos(ang)[..., :, None, :]                        # (..., seq, 1, dh/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    return (F.silu(g) * u) @ w_down


def init_device(gen: Optional[torch.Generator]) -> torch.device:
    """Where an initialiser draws: the generator's device, or ``meta``
    (shapes and dtypes only) without a generator."""
    return gen.device if gen is not None else torch.device("meta")


def _normal(gen: Optional[torch.Generator], shape: Sequence[int]) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                       device=init_device(gen))


def dense_init(gen: Optional[torch.Generator], shape: Sequence[int], in_axis_size: int,
               dtype: torch.dtype) -> torch.Tensor:
    """Scaled-normal init (1/sqrt(fan_in))."""
    return (_normal(gen, shape) * in_axis_size ** -0.5).to(dtype)


def embed_init(gen: Optional[torch.Generator], vocab: int, d: int,
               dtype: torch.dtype) -> torch.Tensor:
    return (_normal(gen, (vocab, d)) * 0.02).to(dtype)
