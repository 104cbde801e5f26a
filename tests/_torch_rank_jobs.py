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
from repro_torch.kernels import _build

# the module, not the function the package exports under the same name
ra = importlib.import_module("repro_torch.parallel.ring_attention")


# -- launch counters -----------------------------------------------------------
def count_launches(ctx, counter, keys):
    """Tally ``keys`` on this rank's launch counter ``counter``, as the
    kernels' wrappers do at a launch."""
    for key in keys:
        _build.COUNTERS[counter].add(key)


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


# -- the sharded model -------------------------------------------------------
def _mesh(mesh_shape):
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel.context import mesh_context
    return mesh_context(make_test_mesh(*mesh_shape))


def sharded_loss(ctx, cfg, params, batch, mesh_shape, grads):
    """``loss_fn`` (and with ``grads`` the gradients, gathered to full
    leaves) of the full ``params`` and ``batch`` cut onto this rank of a
    (data, model) mesh, on the rank's device: (loss, ce, aux, full
    gradients on the host, on rank 0)."""
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import model as M
    from repro_torch.parallel import rules
    from repro_torch.tree import tree_map
    B = next(iter(batch.values())).shape[0]
    here = lambda tree: tree_map(lambda t: t.to(ctx.device), tree)  # noqa: E731
    with _mesh(mesh_shape) as mc:
        plan = rules.param_shardings(mc, cfg)
        local = here(rules.shard_tree(params, plan))
        rows = here(rules.shard_tree(batch, rules.batch_shardings(mc, cfg, B)))
        full = None
        if grads:
            loss, metrics, g = loss_and_grads(local, rows, cfg)
            full = tree_map(lambda t: t.cpu(), rules.gather_tree(g, plan))
        else:
            with torch.no_grad():
                loss, metrics = M.loss_fn(local, rows, cfg)
    return (float(loss), float(metrics["ce"]), float(metrics["aux"]),
            full if ctx.rank == 0 else None)


def sharded_ffn(ctx, cfg, block, x, mesh_shape, grads=False):
    """``model._ffn_part`` of one MoE block (``{"moe", "norm2"}``, full)
    on this rank's rows of ``x`` under a (data, model) mesh: the output
    rows gathered over the data group, the router loss; with ``grads``
    also the block's gradients of the output's sum, gathered."""
    from repro_torch.models import model as M
    from repro_torch.parallel import rules
    from repro_torch.parallel.context import fsdp_gather
    from repro_torch.tree import tree_map
    with _mesh(mesh_shape) as mc:
        specs = M._attn_block_specs(cfg, mc.mp_size)
        specs = {"moe": specs["moe"], "norm2": specs["norm2"]}
        plan = rules.to_shardings(mc, specs)
        local = rules.shard_tree(block, plan)
        rows = rules.to_shardings(mc, ("dp", None, None))
        xl = rows.shard(x)
        full = None
        if grads:
            alias = tree_map(lambda t: t.detach().requires_grad_(), local)
            out, aux = M._ffn_part(fsdp_gather(alias, specs), xl, cfg)
            out.float().sum().backward()
            g = tree_map(lambda t: t.grad, alias)
            full = rules.gather_tree(g, plan)
        else:
            with torch.no_grad():
                out, aux = M._ffn_part(fsdp_gather(local, specs), xl, cfg)
        out = rows.gather(out.detach())
    return out, float(aux.detach()), full


def context_groups(ctx, mesh_args):
    """The (data, model) groups ``mesh_context`` gives this rank, as
    (ranks, index) pairs."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel.context import mesh_context
    with mesh_context(make_test_mesh(*mesh_args), dp_axes=(
            ("pod", "data") if len(mesh_args) > 2 and mesh_args[2] else
            ("data",))) as mc:
        return ((mc.data.ranks, mc.data.rank), (mc.model.ranks, mc.model.rank),
                mc.dp_size, mc.mp_size)


def fsdp_gather_job(ctx, full, mesh_shape):
    """``fsdp_gather`` of this rank's (dp, mp) shard of ``full``: the
    gathered value, and the gradient its shard receives from the loss
    sum((gathered * (rank + 1))), i.e. the sum over the data group of
    (rank + 1) on the shard's own rows."""
    from repro_torch.parallel import rules
    from repro_torch.parallel.context import fsdp_gather
    with _mesh(mesh_shape) as mc:
        plan = rules.to_shardings(mc, ("dp", "mp"))
        local = plan.shard(full).requires_grad_()
        got = fsdp_gather(local, ("dp", "mp"))
        (got * (ctx.rank + 1)).sum().backward()
        return got.detach(), local.grad


def region_job(ctx, x, mesh_shape):
    """The two region operators on the model group: ``enter_model`` then a
    rank-scaled product then ``psum_compat``: the value, and x's gradient
    of its sum."""
    from repro_torch.parallel.context import enter_model, psum_compat
    with _mesh(mesh_shape) as mc:
        x = x.clone().requires_grad_()
        part = enter_model(x, mc.model) * (mc.model.rank + 1)
        out = psum_compat(part, mc.model)
        out.sum().backward()
        return out.detach(), x.grad


def pad_kv(cfg, cache, n):
    """A prefill's cache with ``n`` empty positions after its last in each
    k/v leaf, for decode steps past it (the reference allocates its decode
    caches at max_len); a windowed model's rolling cache as it is."""
    if cfg.sliding_window is not None:
        return cache
    return {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, n))
            if k in ("k", "v") else v for k, v in cache.items()}


def serve_steps(cfg, params, batch, steps):
    """``prefill`` of ``batch``, then ``decode_step`` of each batch in
    ``steps`` at the next position: every call's logits and the final
    cache (the one-device run the sharded one is held against, and the
    sharded run's body inside a mesh context)."""
    from repro_torch.models import model as M
    S = next(iter(batch.values())).shape[1]
    with torch.no_grad():
        logits, cache = M.prefill(params, batch, cfg)
        outs = [logits]
        cache = pad_kv(cfg, cache, len(steps))
        for t, step in enumerate(steps):
            logits, cache = M.decode_step(params, step, cache, S + t, cfg)
            outs.append(logits)
    return outs, cache


def sharded_serve(ctx, cfg, params, batch, steps, mesh_shape):
    """``serve_steps`` on this rank's shards of the full ``params`` and its
    rows of ``batch`` and ``steps`` under a (data, model) mesh: the logits
    of every call gathered over the data group and the final cache
    gathered (``rules.gather_cache``), on the host."""
    from repro_torch.parallel import rules
    from repro_torch.tree import tree_map
    here = lambda tree: tree_map(lambda t: t.to(ctx.device), tree)  # noqa: E731
    B = next(iter(batch.values())).shape[0]
    with _mesh(mesh_shape) as mc:
        local = here(rules.shard_tree(params, rules.param_shardings(mc, cfg)))
        plan = rules.batch_shardings(mc, cfg, B)
        cut = lambda b: here(rules.shard_tree(b, {k: plan[k] for k in b}))  # noqa: E731
        outs, cache = serve_steps(cfg, local, cut(batch), [cut(s) for s in steps])
        split = B % mc.dp_size == 0
        outs = [dchannel.all_gather(o, mc.data, 0) if split else o for o in outs]
        full = rules.gather_cache(cfg, cache, mc, B)
    return [o.cpu() for o in outs], tree_map(lambda t: t.cpu(), full)


def ef_int8(ctx, g, r):
    """``ef_int8_psum`` over the world of this rank's row of ``g`` (a
    tree {"g": ...}) with residual ``r``."""
    from repro_torch.optim import ef_int8_psum
    out, res = ef_int8_psum({"g": g[ctx.rank]}, {"g": r}, ctx.world_group)
    return out["g"], res["g"]


def shard_round_trip(ctx, cfg, params, mesh_shape):
    """``shard_tree`` of the full ``params`` on this rank, then
    ``gather_tree``: each leaf's local shape (by path) and the gathered
    tree."""
    from repro_torch.parallel import rules
    from repro_torch.tree import tree_leaves_with_path
    with _mesh(mesh_shape) as mc:
        plan = rules.param_shardings(mc, cfg)
        local = rules.shard_tree(params, plan)
        shapes = {k: tuple(v.shape) for k, v in tree_leaves_with_path(local)}
        return shapes, rules.gather_tree(local, plan)


def ring_attention_grad(ctx, q, k, v, hop, do=None, causal=True, window=None):
    """The ring with this rank's shards of q, k, v requiring grad, and the
    loss sum(out * do) (``do`` ones when None): what it raised (the text),
    or this rank's (out, dq, dk, dv) as numpy arrays.  ``hop`` "plain" is
    ``ring_attention_plain``, "auto" ``ring_attention``, "fa"
    ``RingAttentionFn`` itself."""
    s = q.shape[1] // ctx.world
    own = slice(ctx.rank * s, (ctx.rank + 1) * s)
    q, k, v = (t[:, own].to(ctx.device).requires_grad_() for t in (q, k, v))
    fn = {"plain": ra.ring_attention_plain, "auto": ra.ring_attention,
          "fa": lambda q, k, v, **kw: ra.RingAttentionFn.apply(
              q, k, v, kw["group"], kw["causal"], kw["window"])}[hop]
    try:
        out = fn(q, k, v, group=ctx.world_group, causal=causal, window=window)
    except NotImplementedError as e:
        return str(e)
    d = torch.ones_like(out) if do is None else do[:, own].to(out)
    (out * d).sum().backward()
    return tuple(t.detach().float().cpu().numpy()
                 for t in (out, q.grad, k.grad, v.grad))


def echo_plus_rank(ctx, x):
    """``x + rank``: a reply as large as the job's argument."""
    return x + ctx.rank


# -- the dry run -----------------------------------------------------------------
def real_args(ctx, mc, cfg, shape, seed=0):
    """The arguments of ``launch.steps.step_fn_for(cfg, shape)``'s step as
    real tensors of this rank on its device, in the shapes and dtypes of
    ``input_specs`` under the mesh context ``mc``: (args, their bytes)."""
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    from repro_torch.optim import adamw_init
    from repro_torch.parallel import rules
    cfg = steps.serve_cfg(cfg, shape, mc)
    specs = steps.input_specs(cfg, shape, mc)
    _, names = steps.step_fn_for(cfg, shape, mc)
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    plan = rules.param_shardings(mc, cfg)
    params = rules.shard_tree(M.init_params(cfg, seed, device=dev), plan)
    batch = {}
    for k, v in specs["batch"].items():
        if v.dtype == torch.int32:
            batch[k] = torch.randint(0, cfg.vocab_size, v.shape, generator=gen,
                                     device=dev, dtype=torch.int32)
        else:
            batch[k] = torch.randn(v.shape, generator=gen, device=dev).to(v.dtype)
    real = {"params": params, "batch": batch}
    if "opt_state" in names:
        real["opt_state"] = adamw_init(params, getattr(torch, cfg.optimizer_dtype))
    if "cache" in names:
        real["cache"] = M.init_cache(cfg, shape.global_batch, shape.seq_len,
                                     device=dev)
        real["cache_len"] = specs["cache_len"]
    args = [real[n] for n in names]
    tensors = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            tensors.append(x)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
    walk(args)
    return args, sum(t.numel() * t.element_size() for t in tensors)


def real_step_tally(ctx, cfg, shape, mesh_shape):
    """The dry run's cell run for real on this rank of a (data, model)
    mesh: (bytes of its arguments, the collectives it issued by kind)."""
    from repro_torch.launch import steps
    with _mesh(mesh_shape) as mc:
        args, nbytes = real_args(ctx, mc, cfg, shape)
        fn, _ = steps.step_fn_for(cfg, shape, mc)
        with dchannel.tally() as t:
            fn(*args)
    return nbytes, t.kinds()
