"""Mamba2 / SSD (state-space duality) mixer — chunked, matmul-rich form.

Counterpart of ``repro.models.ssm``.  The SSD recurrence
h_t = a_t·h_{t-1} + dt_t·(B_t ⊗ x_t),  y_t = C_t·h_t + D·x_t  is evaluated
chunk by chunk: inside a chunk everything is dense products, and chunks
are connected by the carried (B, H, P, N) state.  On CUDA tensors
:func:`ssd_chunked` runs the hand-written SSD kernels
(``repro_torch.kernels.ssd_scan``), ``h0`` and ``compute_dtype`` included,
and under autograd their hand-written backward (``SsdScanFn``): A =
-exp(A_log), dt and x reach it as nodes of the graph, so the block's
parameters train on the card; on CPU tensors it runs the plain chunked form.

Shapes: u (B, T, d_model); internally x (B, T, H, P) with H·P = d_inner,
B/C (B, T, N) single-group, dt (B, T, H), A (H,) negative reals.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan import segsum as _segsum
from ..kernels.ssd_scan import ssd_scan
from .config import ModelConfig
from .layers import dense_init, init_device, rms_norm

__all__ = ["ssm_init", "ssm_apply", "ssm_decode", "ssd_chunked",
           "ssd_reference", "init_ssm_cache"]


# --------------------------------------------------------------------------
# SSD core
# --------------------------------------------------------------------------
def ssd_reference(x, dt, A, B, C, h0=None):
    """Naive sequential recurrence (test oracle). x (b,t,h,p), dt (b,t,h),
    A (h,), B,C (b,t,n). Returns y (b,t,h,p), h_final (b,h,p,n)."""
    b, t, h, p = x.shape
    n = B.shape[-1]
    h_state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
               if h0 is None else h0)
    x, dt, B, C = x.float(), dt.float(), B.float(), C.float()
    ys = []
    for i in range(t):
        a = torch.exp(dt[:, i] * A)                             # (b,h)
        upd = torch.einsum("bhp,bn->bhpn", x[:, i] * dt[:, i, :, None], B[:, i])
        h_state = h_state * a[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", h_state, C[:, i]))
    return torch.stack(ys, dim=1), h_state


def ssd_chunked(x, dt, A, B, C, chunk: int, h0=None,
                compute_dtype: torch.dtype = torch.float32):
    """Chunked SSD. Same contract as ssd_reference.  ``compute_dtype``
    applies to the intra-chunk products only (decays/state stay fp32)."""
    h0 = None if h0 is None else h0.float()
    return ssd_scan(x, dt.float(), A.float(), B, C, chunk=chunk, h0=h0,
                    compute_dtype=compute_dtype)


# --------------------------------------------------------------------------
# full Mamba2 block
# --------------------------------------------------------------------------
def ssm_init(gen: Optional[torch.Generator], cfg: ModelConfig) -> Dict:
    d, di, n, hh, kk = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_conv
    dev, f32 = init_device(gen), torch.float32
    lo, hi = torch.log(torch.tensor(0.001)), torch.log(torch.tensor(0.1))
    u = torch.rand((hh,), generator=gen, dtype=f32, device=dev)
    dt = torch.exp(lo.to(dev) + u * (hi - lo).to(dev))
    return {
        "w_z": dense_init(gen, (d, di), d, cfg.param_dtype),
        "w_xbc": dense_init(gen, (d, di + 2 * n), d, cfg.param_dtype),
        "w_dt": dense_init(gen, (d, hh), d, cfg.param_dtype),
        "dt_bias": torch.log(torch.expm1(dt)),                 # softplus inverse
        "A_log": torch.log(torch.arange(1, hh + 1, dtype=f32, device=dev)),
        "D": torch.ones((hh,), dtype=f32, device=dev),
        "conv_w": (torch.randn((kk, di + 2 * n), generator=gen, dtype=f32,
                               device=dev) * kk ** -0.5).to(cfg.param_dtype),
        "norm": torch.ones((di,), dtype=f32, device=dev),
        "w_out": dense_init(gen, (di, d), di, cfg.param_dtype),
    }


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time. xbc (B,T,Ch); conv_w (K,Ch).
    Returns (out (B,T,Ch), new_state (B,K-1,Ch))."""
    k = conv_w.shape[0]
    if state is None:
        state = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]),
                            dtype=xbc.dtype, device=xbc.device)
    padded = torch.cat([state, xbc], dim=1)                     # (B, T+K-1, Ch)
    T = xbc.shape[1]
    out = padded[:, 0:T] * conv_w[0]
    for i in range(1, k):
        out = out + padded[:, i:i + T] * conv_w[i]
    new_state = padded[:, -(k - 1):] if k > 1 else state
    return out, new_state


def _block_inputs(params, u, cfg: ModelConfig, conv_state=None):
    di, n, hh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z = u @ params["w_z"]                                       # (B,T,di)
    xbc = u @ params["w_xbc"]                                   # (B,T,di+2n)
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], conv_state)
    xbc = F.silu(xbc)
    x, B, C = torch.split(xbc, [di, n, n], dim=-1)
    dt = F.softplus((u @ params["w_dt"]).float() + params["dt_bias"])  # (B,T,H)
    A = -torch.exp(params["A_log"])                             # (H,)
    xh = x.reshape(*x.shape[:-1], hh, cfg.ssm_headdim)
    return z, xh, dt, A, B, C, new_conv


def ssm_apply(params, u, cfg: ModelConfig, *, h0=None, conv_state=None,
              return_cache: bool = False):
    """Full-sequence Mamba2 block. u (B,T,d) → (B,T,d) [+cache]."""
    z, xh, dt, A, B, C, new_conv = _block_inputs(params, u, cfg, conv_state)
    y, h_final = ssd_chunked(xh.contiguous(), dt, A, B.contiguous(),
                             C.contiguous(), cfg.ssm_chunk, h0=h0,
                             compute_dtype=getattr(torch, cfg.ssm_compute_dtype))
    y = y + xh.float() * params["D"][:, None]
    y = y.reshape(*u.shape[:-1], cfg.d_inner).to(u.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    out = y @ params["w_out"]
    if return_cache:
        return out, {"h": h_final, "conv": new_conv}
    return out


def init_ssm_cache(batch: int, cfg: ModelConfig, dtype=torch.float32,
                   device=None) -> Dict:
    return {
        "h": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * cfg.ssm_state),
                            dtype=dtype, device=device),
    }


def ssm_decode(params, u, cache: Dict, cfg: ModelConfig):
    """Single-token step. u (B,1,d) → ((B,1,d), new_cache).  O(1) in
    context length; plain PyTorch, no kernel (as in the reference)."""
    z, xh, dt, A, B, C, new_conv = _block_inputs(params, u, cfg, cache["conv"])
    x_t = xh[:, 0].float()                                      # (B,H,P)
    dt_t = dt[:, 0]                                             # (B,H)
    a = torch.exp(dt_t * A)                                     # (B,H)
    upd = torch.einsum("bhp,bn->bhpn", x_t * dt_t[..., None], B[:, 0].float())
    h = cache["h"] * a[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", h, C[:, 0].float())
    y = y + x_t * params["D"][:, None]
    y = y.reshape(u.shape[0], 1, cfg.d_inner).to(u.dtype)
    y = rms_norm(y * F.silu(z), params["norm"], cfg.norm_eps)
    return y @ params["w_out"], {"h": h, "conv": new_conv}
