"""Attention: GQA + RoPE + optional sliding window.

Counterpart of ``repro.models.attention``.  Execution paths:
  * on CUDA tensors, ``attention`` with ``impl`` "chunked" or "pallas``
    runs the hand-written flash-attention kernel
    (``repro_torch.kernels.flash_attention``) for every shape, the small
    ones the reference sends to ``naive`` included;
  * on ``meta`` tensors (the dry run) it takes the same wrapper, whose
    launch points run the plain versions there (the device has no
    kernel), so the dry run saves and frees what the card's path does;
  * on CPU tensors it takes the reference's own dispatch: ``naive`` for
    tiny shapes, else ``chunked`` — flash-style double tiling over query
    and key/value chunks with an online-softmax carry, never materialising
    the (S, S) score matrix;
  * ``impl="naive"`` is an explicit request for the materialised
    reference and stays plain on every device.

With ``causal_skip=True`` the chunked path only visits the
lower-triangular (query-chunk, kv-chunk) pairs.  Decode (a single new token
against a KV cache) is a separate, plain path.  All shapes: q (B, S, H, Dh);
k/v (B, T, Hkv, Dh) with H % Hkv == 0.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..kernels.flash_attention import flash_attention

__all__ = ["attention", "decode_attention", "naive_attention",
           "chunked_attention"]

_NEG = -1e30
_KERNEL_IMPLS = ("chunked", "pallas")


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    if groups == 1:
        return k
    return torch.repeat_interleave(k, groups, dim=2)


def naive_attention(q, k, v, *, causal: bool, window: Optional[int],
                    q_offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Materialised reference. q_offset: absolute position of q[0] vs k[0];
    ``scale``: the scores' factor, Dh^-0.5 by default."""
    B, S, H, Dh = q.shape
    T = k.shape[1]
    k = _repeat_kv(k, H // k.shape[2])
    v = _repeat_kv(v, H // v.shape[2])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores * (Dh ** -0.5 if scale is None else scale)
    qpos = torch.arange(S, device=q.device)[:, None] + q_offset
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, _NEG)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def _chunk_body(q_blk, k_blk, v_blk, carry, qpos, kpos, kv_len, *, causal,
                window, scale):
    """One (q-chunk × kv-chunk) flash step. carry = (m, l, acc) in fp32."""
    m, l, acc = carry
    s = torch.einsum("bqhd,bkhd->bhqk", q_blk, k_blk).float() * scale
    mask = kpos[None, :] < kv_len  # mask kv padding
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    s = torch.where(mask, s, _NEG)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    acc_new = acc * alpha[..., None] + torch.einsum(
        "bhqk,bkhd->bhqd", p.to(v_blk.dtype), v_blk).float()
    return m_new, l_new, acc_new


def chunked_attention(q, k, v, *, causal: bool, window: Optional[int],
                      q_chunk: int, kv_chunk: int, causal_skip: bool = False,
                      q_offset: int = 0,
                      scale: Optional[float] = None) -> torch.Tensor:
    B, S, H, Dh = q.shape
    T = k.shape[1]
    groups = H // k.shape[2]
    scale = Dh ** -0.5 if scale is None else scale
    cq = min(q_chunk, S)
    ck = min(kv_chunk, T)
    nq, nk = -(-S // cq), -(-T // ck)
    pad = torch.nn.functional.pad
    qp = pad(q, (0, 0, 0, 0, 0, nq * cq - S))
    kp = pad(k, (0, 0, 0, 0, 0, nk * ck - T))
    vp = pad(v, (0, 0, 0, 0, 0, nk * ck - T))
    kpos_all = torch.arange(nk * ck, device=q.device)
    dev, f32 = q.device, torch.float32
    triangular = causal_skip and causal and q_offset == 0 and S == T
    outs = []
    for qi in range(nq):
        q_blk = qp[:, qi * cq:(qi + 1) * cq]
        qpos = qi * cq + torch.arange(cq, device=dev) + q_offset
        carry = (torch.full((B, H, cq), _NEG, dtype=f32, device=dev),
                 torch.zeros((B, H, cq), dtype=f32, device=dev),
                 torch.zeros((B, H, cq, Dh), dtype=f32, device=dev))
        # triangular schedule: q-chunk qi only needs kv-chunks [0, qi·cq/ck]
        n_valid = min(((qi + 1) * cq + ck - 1) // ck, nk) if triangular else nk
        for ki in range(n_valid):
            k_blk = _repeat_kv(kp[:, ki * ck:(ki + 1) * ck], groups)
            v_blk = _repeat_kv(vp[:, ki * ck:(ki + 1) * ck], groups)
            carry = _chunk_body(q_blk, k_blk, v_blk, carry, qpos,
                                kpos_all[ki * ck:(ki + 1) * ck], T,
                                causal=causal, window=window, scale=scale)
        _, l, acc = carry
        out = acc / torch.clamp(l[..., None], min=1e-30)
        outs.append(out.to(q.dtype))                         # (B, H, cq, Dh)
    out = torch.cat(outs, dim=2).transpose(1, 2)             # (B, nq·cq, H, Dh)
    return out[:, :S]


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              impl: str = "chunked", q_chunk: int = 1024, kv_chunk: int = 512,
              causal_skip: bool = False, q_offset: int = 0,
              scale: Optional[float] = None) -> torch.Tensor:
    """``scale``: the scores' factor, Dh^-0.5 by default (Zamba2 passes
    (Dh/2)^-0.5), on every path."""
    if q.device.type in ("cuda", "meta") and impl in _KERNEL_IMPLS:
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, window=window,
                              q_offset=q_offset, scale=scale)
        return out.transpose(1, 2)
    if impl == "naive" or q.shape[1] * k.shape[1] <= 256 * 256:
        return naive_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, scale=scale)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             q_chunk=q_chunk, kv_chunk=kv_chunk,
                             causal_skip=causal_skip, q_offset=q_offset,
                             scale=scale)


def decode_attention(q, k_cache, v_cache, cache_len, *,
                     window: Optional[int] = None, rolling: bool = False,
                     start_pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Single-step attention against a cache.

    q: (B, 1, H, Dh); caches: (B, T, Hkv, Dh); cache_len: int — number of
    valid entries (the new token's k/v already written).  With
    ``rolling=True`` the cache is a circular SWA buffer where *all* T slots
    are valid once full; masking is by slot validity only.
    ``start_pos`` (B,) masks slots before a request's admission — the
    continuous-batching farm admits requests into recycled slots mid-stream.
    """
    B, _, H, Dh = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    g = H // Hkv
    qg = q.reshape(B, 1, Hkv, g, Dh)          # grouped: never repeat the KV
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_cache).float()
    s = s * Dh ** -0.5
    slot = torch.arange(T, device=q.device)
    if rolling:
        valid = (slot < min(cache_len, T)).expand(B, T)
    else:
        valid = (slot < cache_len).expand(B, T)
        if window is not None:
            valid = valid & (slot[None, :] > cache_len - 1 - window)
    if start_pos is not None and not rolling:
        valid = valid & (slot[None, :] >= start_pos[:, None])
    s = torch.where(valid[:, None, None, None, :], s, _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v_cache.dtype), v_cache)
    return out.reshape(B, 1, H, Dh)
