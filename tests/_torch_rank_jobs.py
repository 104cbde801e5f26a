"""Picklable rank jobs for the port's multi-rank tests.

A rank process (``repro_torch.core.ranks``) unpickles its job by importing
the module that defines it, so every job a test sends lives here, in a
module with no test-only imports (no pytest, no jax): a rank imports it
cold.  Each job takes the rank's context first, then the job's arguments,
and returns numpy arrays or Python values.
"""
from __future__ import annotations

import importlib

import torch

from _procs_nodes import f, fb_pred, fb_step
from repro_torch.core import dchannel, dfarm
from repro_torch.core.dpipeline import pipeline_apply

# the module, not the function the package exports under the same name
ra = importlib.import_module("repro_torch.parallel.ring_attention")


# -- dchannel ----------------------------------------------------------------
def channels(ctx):
    """Every channel of ``dchannel`` on this rank's block, filled with the
    rank: what arrived, as floats."""
    grp = ctx.world_group
    x = torch.full((2, 3), float(ctx.rank))
    tree = {"a": x, "b": (x + 10, [x.to(torch.int32)])}
    chained = dchannel.chain_send(tree, grp)
    chan = dchannel.RingChannel(grp, capacity=2)
    slots, out, arrived = chan.init(x), x, []
    for _ in range(4):
        got, slots = chan.step(slots, out)
        arrived.append(got)
        out = out + 100
    total = dchannel.double_buffered_ring(
        lambda hop, carry, block: (carry + block * (hop + 1), None),
        x, torch.zeros_like(x), grp)
    return {
        "ring": dchannel.ring_send(x, grp).numpy(),
        "ring3": dchannel.ring_send(x, grp, displacement=3).numpy(),
        "chain": chained["a"].numpy(),
        "chain_b": chained["b"][0].numpy(),
        "chain_int": chained["b"][1][0].numpy(),
        "reverse": dchannel.reverse_chain_send(x, grp).numpy(),
        "channel": torch.stack(arrived).numpy(),
        "double_buffered": total.numpy(),
    }


def exchange(ctx, backend, wire, capacity, shard):
    """dispatch, then combine of the doubled buffer, over the world."""
    items, dest = (torch.from_numpy(a) for a in shard)
    wire_dtype = None if wire is None else getattr(torch, wire)
    recv, info = dfarm.dispatch(items, dest, ctx.world_group, capacity,
                                backend=backend, wire_dtype=wire_dtype)
    back = dfarm.combine(recv * 2, info, ctx.world_group, backend=backend,
                         wire_dtype=wire_dtype)
    return recv.numpy(), back.numpy()


def farms(ctx, backend, capacity, shard):
    """farm_map and farm_until over round-robin destinations."""
    x = torch.from_numpy(shard)
    grp = ctx.world_group
    dest = dfarm.roundrobin_dest(x.shape[0], grp)
    mapped = dfarm.farm_map(f, x, dest, grp, capacity, backend=backend)
    looped = dfarm.farm_until(fb_step, fb_pred, x, dest, grp, capacity,
                              max_trips=32, backend=backend)
    return dest.numpy(), mapped.numpy(), looped.numpy()


def pipeline(ctx, m, mb, d, collect):
    """The reference's pipeline test: stage s adds its parameter s; the
    output and each stage's parameter gradient of the summed output."""
    p = torch.full((1, 1), float(ctx.rank), requires_grad=True)
    out = pipeline_apply(lambda pp, v: v + pp[0], p, torch.ones(m, mb, d),
                         group=ctx.world_group, collect=collect)
    out.sum().backward()
    return out.detach().numpy(), p.grad.numpy()


def stage_failure(ctx):
    """Raise on rank 1 alone, then meet the others in a collective that
    rank 1 never reaches."""
    if ctx.rank == 1:
        raise ValueError("rank 1 gave up")
    dchannel.psum(torch.ones(1), ctx.world_group)
    return ctx.rank


# -- ring attention ----------------------------------------------------------
def ring_attention(ctx, q, k, v, causal, window, hop):
    """This rank's shard of q, k, v, moved to the rank's device, through
    the ring; ``hop`` "plain" is ``ring_attention_plain``, "auto"
    ``ring_attention`` (which picks by device), "fa" the flash-attention
    hops (the kernel on the card, the wrapper's plain
    version on CPU tensors), with the q_offset of each hop that reaches
    the wrapper."""
    s = q.shape[1] // ctx.world
    own = slice(ctx.rank * s, (ctx.rank + 1) * s)
    q, k, v = (t[:, own].to(ctx.device) for t in (q, k, v))
    if hop in ("plain", "auto"):
        fn = ra.ring_attention_plain if hop == "plain" else ra.ring_attention
        out = fn(q, k, v, group=ctx.world_group, causal=causal, window=window)
        return out.float().cpu().numpy(), None
    calls = []
    inner = ra.fa.fa_forward_with_stats

    def counted(*a, **kw):
        calls.append(kw["q_offset"])
        return inner(*a, **kw)

    ra.fa.fa_forward_with_stats = counted
    try:
        out = ra.ring_attention(q, k, v, group=ctx.world_group,
                                causal=causal, window=window) \
            if q.is_cuda else ra._ring_fa(q, k, v, group=ctx.world_group,
                                          causal=causal, window=window)
    finally:
        ra.fa.fa_forward_with_stats = inner
    return out.float().cpu().numpy(), calls


# -- on the card ---------------------------------------------------------------
def card_ring_hop(ctx):
    """One bf16 ring hop on the rank's card and the host moves it took."""
    x = torch.full((64, 96), float(ctx.rank), dtype=torch.bfloat16,
                   device=ctx.device)
    got = dchannel.ring_send(x, ctx.world_group)
    return got.device.type, got.float().cpu().numpy(), ctx.staged


def score_rows(prof, q_len, x):
    """A device-farm worker: column 0 of each row of padded residues
    becomes its SW score against ``prof`` (10-2k gaps)."""
    from repro_torch.kernels import smith_waterman as sw
    y = torch.zeros_like(x)
    y[:, 0] = sw.sw_batch(prof.to(x.device), x.contiguous(), gap_open=10.0,
                          gap_extend=2.0, q_len=q_len).to(torch.int32)
    return y


def nccl_ring(ctx):
    """A ring hop and an all-reduce over NCCL, one card a rank."""
    x = torch.full((4,), float(ctx.rank), device=ctx.device)
    got = dchannel.ring_send(x, ctx.world_group)
    total = dchannel.psum(x, ctx.world_group)
    return got.cpu().numpy(), total.cpu().numpy(), ctx.staged



def fail_on_rank_one(x):
    """A farm worker that raises in rank 1 alone."""
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise ValueError("worker failed on rank 1")
    return x
