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
  ``_chunk_body`` over every block, masked — in eager PyTorch.  It is the
  forward's oracle and carries no gradient (it raises when asked for one).

The gradient: with grad mode on and any of q, k, v requiring one,
:func:`ring_attention` runs :class:`RingAttentionFn` on either device.
Its forward is the flash-attention ring above, which also keeps each
row's *merged* statistics — the global row max m (base 2) and 1/l, in the
``(2, B·H·S_loc)`` float32 layout of
:func:`~repro_torch.kernels.flash_attention.fa_backward`.  Its backward
is a second ring (:func:`_ring_fa_backward`): the (k, v) blocks circulate
again, each travelling with its float32 (dk, dv) accumulators, and every
hop runs one flash-attention backward of this rank's q, output and
output gradient against the visiting block, with the merged statistics:
P = 2^(s - m)/l is then the ring's probability, and the kernel's
Δ = rowsum(do ∘ o) the global one.  dq accumulates where it is.  After
the last hop one more send brings every block's dk, dv home to its owner.
On CUDA tensors the hops run the bfloat16 backward kernel; on CPU tensors
its plain version (:func:`~repro_torch.kernels.flash_attention.fa_backward_plain`),
in any dtype.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.dchannel import double_buffered_ring, ring_post, ring_send
from ..core.ranks import Group
from ..kernels import flash_attention as fa
from ..models.attention import _NEG, _chunk_body, _repeat_kv

__all__ = ["ring_attention", "ring_attention_plain", "RingAttentionFn"]


def _wants_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def _refuse_grad(*ts: torch.Tensor) -> None:
    """Raise if autograd would need the gradient of a ring that runs under
    ``no_grad``: its result would come back detached."""
    if _wants_grad(*ts):
        raise NotImplementedError(
            "this ring carries no gradient: call ring_attention, whose "
            "RingAttentionFn differentiates the flash-attention ring")


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


def _ring_merge(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                group: Group, causal: bool, window: Optional[int]):
    """The flash-attention ring: (the local output (B, S_loc, H, Dh) in
    q's dtype, the merged statistics (2, B·H·S_loc) float32: each row's
    global m, base 2, and 1/l, 0 where no key of any hop is visible)."""
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
        m, l, acc = double_buffered_ring(hop, (k, v), carry0, group)
        seen = l > 0
        out = torch.where(seen[..., None],
                          acc / torch.clamp(l[..., None], min=1e-30), 0.0)
        stats = torch.stack([torch.where(seen, m, fa.NEG2),
                             torch.where(seen, 1.0 / torch.where(seen, l, 1.0),
                                         0.0)])
    return out.transpose(1, 2).to(q.dtype), stats.reshape(2, -1)


def _ring_fa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             group: Group, causal: bool, window: Optional[int]
             ) -> torch.Tensor:
    """:func:`ring_attention` through the flash-attention wrapper: the
    kernel on CUDA tensors (its plain version on CPU ones), no gradient."""
    _refuse_grad(q, k, v)
    return _ring_merge(q, k, v, group=group, causal=causal, window=window)[0]


def _bwd_hop(q, k, v, o, do, stats, *, causal, window, q_offset):
    """One hop's (dq, dk, dv) in the (B, H, S, D) layouts of its inputs:
    the backward kernel on CUDA tensors, its plain version elsewhere."""
    if q.device.type == "cuda":
        return fa.fa_backward(q, k, v, o, do, causal=causal, window=window,
                              q_offset=q_offset, stats=stats)
    return fa.fa_backward_plain(q, k, v, o, do, causal=causal, window=window,
                                q_offset=q_offset, stats=stats)


def _ring_fa_backward(q, k, v, out, do, stats, *, group: Group,
                      causal: bool, window: Optional[int]):
    """(dq, dk, dv) of the ring for the output gradient ``do``, each the
    local shard in its input's dtype.

    A second ring of ``group.size`` hops.  At hop h this rank holds the
    (k, v) block that left rank ``src = me - h`` and that block's float32
    (dk, dv) accumulators: the next hop's (k, v) send is posted first, then
    one backward of this rank's q, ``out`` and ``do`` against the block
    (``q_offset = (me - src)·S_loc``, the merged ``stats``) adds its dq here
    and its dk, dv to the accumulators, which are sent on after it.  Under
    ``causal`` a hop with ``src > me`` launches nothing, but its block and
    accumulators still move.  After the last hop one more send — the
    accumulators' n-th — brings every block's dk, dv home to the rank that
    owns the block."""
    B, s_loc, H, Dh = q.shape
    n, me = group.size, group.rank
    f32 = torch.float32
    qt, ot, dot = (t.transpose(1, 2) for t in (q, out, do))   # (B, H, S, D)
    dq = torch.zeros((B, H, s_loc, Dh), dtype=f32, device=q.device)
    block = (k, v)
    acc = (torch.zeros(k.shape, dtype=f32, device=k.device),
           torch.zeros(v.shape, dtype=f32, device=v.device))
    for h in range(n):
        src = (me - h) % n
        arrive = ring_post(block, group) if h + 1 < n else None
        if not (causal and src > me):
            kt, vt = (t.transpose(1, 2) for t in block)
            off = (me - src) * s_loc
            st = stats      # the global m and 1/l: P is the ring's probability
            oh = ot         # the ring's output: Δ = rowsum(do ∘ o) is global
            dq_h, dk_h, dv_h = _bwd_hop(qt, kt, vt, oh, dot, st, causal=causal,
                                        window=window, q_offset=off)
            dq += dq_h.float()
            acc = (acc[0] + dk_h.transpose(1, 2).float(),
                   acc[1] + dv_h.transpose(1, 2).float())
        if arrive is not None:
            acc = ring_send(acc, group)
            block = arrive()
    dk, dv = ring_send(acc, group)      # home: the accumulators' n-th send
    return (dq.transpose(1, 2).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


class RingAttentionFn(torch.autograd.Function):
    """The flash-attention ring with its gradient.  The forward saves q,
    the local k and v, the ring's output in q's dtype and the merged
    statistics (m base 2, 1/l: ``(2, B·H·S_loc)`` float32); the backward
    is :func:`_ring_fa_backward`'s second ring."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, window):
        out, stats = _ring_merge(q, k, v, group=group, causal=causal,
                                 window=window)
        ctx.save_for_backward(q, k, v, out, stats)
        ctx.group, ctx.causal, ctx.window = group, causal, window
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, stats = ctx.saved_tensors
        dq, dk, dv = _ring_fa_backward(
            q, k, v, out, do.contiguous(), stats, group=ctx.group,
            causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   group: Group, causal: bool = True,
                   window: Optional[int] = None) -> torch.Tensor:
    """q (B, S_loc, H, Dh); k/v (B, S_loc, Hkv, Dh), sequence-sharded over
    ``group``.  Returns the local (B, S_loc, H, Dh) shard in q's dtype.
    On CUDA tensors each hop is one launch of the bfloat16 flash-attention
    kernel (float32 raises: only the bfloat16 kernel writes the
    statistics); on CPU tensors :func:`ring_attention_plain`.  With grad
    mode on and an input that requires grad, :class:`RingAttentionFn` on
    either device (its hops through the wrapper's plain versions on CPU
    tensors)."""
    if _wants_grad(q, k, v):
        return RingAttentionFn.apply(q, k, v, group, causal, window)
    if q.device.type == "cpu":
        return ring_attention_plain(q, k, v, group=group, causal=causal,
                                    window=window)
    return _ring_fa(q, k, v, group=group, causal=causal, window=window)
