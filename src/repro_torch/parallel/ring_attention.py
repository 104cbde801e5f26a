"""Ring attention — sequence parallelism as a cyclic SPSC network.

The paper's claim is that arbitrary streaming networks, cycles included,
compose from SPSC channels.  Ring attention is the flagship device-level
cycle: the sequence is sharded over a group of ranks, each rank keeps its
q shard resident, and the K/V shards circulate hop by hop on an SPSC ring
(:func:`~repro_torch.core.dchannel.double_buffered_ring`: hop k+1's
send is posted before hop k's attention), each hop folded into an online
softmax.  No gather of the sequence ever happens.

The port's copy of ``repro.parallel.ring_attention``.  Call it inside a
rank job (:mod:`repro_torch.core.ranks`) with q, k, v sequence-sharded
over ``group``, rank r holding positions ``[r * S_loc, (r + 1) * S_loc)``;
it returns the local output shard.

* :func:`ring_attention` on CUDA tensors runs each hop through the
  flash-attention kernel with its softmax statistics
  (:func:`~repro_torch.kernels.flash_attention.fa_forward_with_stats`,
  bfloat16: the kernel that writes them) and merges the hops by their
  row max m and 1/l in float32.  The block that left rank ``src`` holds
  keys ``S_loc * (me - src)`` positions before this rank's queries: the
  hop runs with that ``q_offset``; under ``causal`` the block of a later
  rank (``src > me``) is all masked and is skipped, with no launch.  A
  row whose every key in a hop is masked comes out of the kernel with
  m at the masked score (its output averages v over the visited tiles,
  or is 0): it gets zero weight in the merge.  On CPU tensors it runs
  :func:`ring_attention_plain`.
* :func:`ring_attention_plain` is the reference's hop — the model's
  ``_chunk_body`` over every block, masked — in eager PyTorch.

No gradient yet: with grad mode on and any of q, k, v requiring one,
both paths raise ``NotImplementedError`` (ROADMAP §1 item 11 step 6)
rather than return a detached result.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.dchannel import double_buffered_ring
from ..core.ranks import Group
from ..kernels import flash_attention as fa
from ..models.attention import _NEG, _chunk_body, _repeat_kv

__all__ = ["ring_attention", "ring_attention_plain"]


def _refuse_grad(*ts: torch.Tensor) -> None:
    """Raise if autograd would need the ring's gradient: the ring runs
    under ``no_grad`` and its result would come back detached."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in ts):
        raise NotImplementedError(
            "ring_attention carries no gradient yet (ROADMAP §1 item 11 "
            "step 6); run it under torch.no_grad() or detach q, k and v")


def ring_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, group: Group, causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """q (B, S_loc, H, Dh); k/v (B, S_loc, Hkv, Dh), sequence-sharded over
    ``group``.  Returns (B, S_loc, H, Dh) in q's dtype."""
    _refuse_grad(q, k, v)
    B, s_loc, H, Dh = q.shape
    n, me = group.size, group.rank
    groups = H // k.shape[2]
    dev = q.device
    qpos = me * s_loc + torch.arange(s_loc, device=dev)
    carry0 = (torch.full((B, H, s_loc), _NEG, dtype=torch.float32, device=dev),
              torch.zeros((B, H, s_loc), dtype=torch.float32, device=dev),
              torch.zeros((B, H, s_loc, Dh), dtype=torch.float32, device=dev))

    def hop(h, carry, block):
        k_blk, v_blk = block
        src = (me - h) % n
        kpos = src * s_loc + torch.arange(s_loc, device=dev)
        return _chunk_body(q, _repeat_kv(k_blk, groups),
                           _repeat_kv(v_blk, groups), carry, qpos, kpos,
                           n * s_loc, causal=causal, window=window,
                           scale=Dh ** -0.5), None

    with torch.no_grad():
        _, l, acc = double_buffered_ring(hop, (k, v), carry0, group)
        out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.transpose(1, 2).to(q.dtype)


def _fa_hop(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, window: Optional[int], q_offset: int):
    """One hop through the flash-attention wrapper: (out (B,H,S,D) f32,
    m (B,H,S) base 2, l (B,H,S)), l 0 on rows with no unmasked key."""
    B, s_loc, H, _ = q.shape
    o, stats = fa.fa_forward_with_stats(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, q_offset=q_offset)
    m, inv_l = stats.reshape(2, B, H, s_loc)
    # a row whose every key is masked keeps m at the masked score (or the
    # kernel saw no tile of it and wrote 1/l = 0): its output is an
    # average of v or 0, and it must not enter the merge
    seen = (inv_l > 0) & (m > fa.NEG2 / 2)
    l = torch.where(seen, 1.0 / torch.where(seen, inv_l, 1.0), 0.0)
    return o.float(), torch.where(seen, m, fa.NEG2), l


def _ring_fa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             group: Group, causal: bool, window: Optional[int]
             ) -> torch.Tensor:
    """:func:`ring_attention` through the flash-attention wrapper: the
    kernel on CUDA tensors (its plain version on CPU ones)."""
    _refuse_grad(q, k, v)
    B, s_loc, H, Dh = q.shape
    n, me = group.size, group.rank
    dev = q.device
    carry0 = (torch.full((B, H, s_loc), fa.NEG2, dtype=torch.float32,
                         device=dev),
              torch.zeros((B, H, s_loc), dtype=torch.float32, device=dev),
              torch.zeros((B, H, s_loc, Dh), dtype=torch.float32, device=dev))

    def hop(h, carry, block):
        src = (me - h) % n
        if causal and src > me:
            return carry, None          # every key lies after every query
        o, m_h, l_h = _fa_hop(q, *block, causal=causal, window=window,
                              q_offset=(me - src) * s_loc)
        m, l, acc = carry
        m_new = torch.maximum(m, m_h)
        a, b = torch.exp2(m - m_new), torch.exp2(m_h - m_new) * l_h
        return (m_new, l * a + b,
                acc * a[..., None] + o * b[..., None]), None

    with torch.no_grad():
        _, l, acc = double_buffered_ring(hop, (k, v), carry0, group)
        out = torch.where(l[..., None] > 0,
                          acc / torch.clamp(l[..., None], min=1e-30), 0.0)
    return out.transpose(1, 2).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   group: Group, causal: bool = True,
                   window: Optional[int] = None) -> torch.Tensor:
    """q (B, S_loc, H, Dh); k/v (B, S_loc, Hkv, Dh), sequence-sharded over
    ``group``.  Returns the local (B, S_loc, H, Dh) shard in q's dtype.
    On CUDA tensors each hop is one launch of the bfloat16 flash-attention
    kernel (float32 raises: only the bfloat16 kernel writes the
    statistics); on CPU tensors :func:`ring_attention_plain`."""
    if q.device.type == "cpu":
        return ring_attention_plain(q, k, v, group=group, causal=causal,
                                    window=window)
    return _ring_fa(q, k, v, group=group, causal=causal, window=window)
