"""Step builders: train, prefill and decode.

Counterpart of ``repro.launch.steps``'s ``make_train_step``,
``make_prefill_step`` and ``make_decode_step``.  The train step updates
the parameters and the optimizer state in place (the reference donates
them).  Inside a sharded mesh context (``repro_torch.parallel.context``)
the parameters and the optimizer state are this rank's shards and
``loss_and_grads`` returns each leaf's complete local gradient: a leaf
with a ``"dp"`` token comes summed over the data group from the gather's
backward, and every other leaf is summed over the data group here.

The spec functions (``train_state_specs``, ``input_specs``, ``serve_cfg``,
``step_fn_for``) are the reference's, with its signatures and rules.  Where
the reference gives ``jax.ShapeDtypeStruct``s with shardings attached, the
port's spec of a leaf is a ``meta`` tensor of the shape this rank holds:
the local shard under a sharded context (``ctx``, the active mesh
context), the full shape without one; the dtype is the reference's.  The
dry run (``launch/dryrun.py``) runs the step functions on them.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch
from torch.profiler import record_function

from ..models import model as M
from ..models.config import ModelConfig, param_count
from ..optim import AdamWState, adamw_update, cosine_schedule
from ..parallel.context import DP, MeshCtx, psum_compat, sharded_ctx
from ..tree import tree_leaves, tree_map

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step",
           "loss_and_grads", "reduce_data_replicated", "train_state_specs",
           "input_specs", "serve_cfg", "step_fn_for", "HBM_SERVE_BUDGET"]


def reduce_data_replicated(grads: Dict[str, Any], specs: Dict[str, Any],
                           group) -> Dict[str, Any]:
    """Each gradient whose leaf has no ``"dp"`` token (replicated over the
    data group, so each rank holds its own rows' part) summed over the
    data ``group``; the others as they are."""
    return tree_map(lambda g, toks: g if toks is not None and DP in toks
                    else psum_compat(g, group), grads, specs)


def loss_and_grads(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
           cfg: ModelConfig):
    """(loss, metrics, grads): the gradients of ``loss_fn`` with respect to
    every leaf, zeros for a leaf the loss does not use (audio's token
    embedding), each in its leaf's dtype; under a sharded mesh context
    each local shard's complete gradient (see the module's docstring).  The leaves are differentiated
    through aliases that share their storage, so ``params`` keeps its
    ``requires_grad`` flags."""
    alias = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(alias)
    with torch.enable_grad():
        loss, metrics = M.loss_fn(alias, batch, cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = iter([torch.zeros_like(p) if g is None else g
                  for p, g in zip(leaves, grads)])
    grads = tree_map(lambda _: next(grads), params)
    ctx = sharded_ctx()
    if ctx is not None:
        with torch.no_grad():
            grads = reduce_data_replicated(
                grads, M.params_pspecs(cfg, ctx.mp_size), ctx.data)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def make_train_step(cfg: ModelConfig, *, peak_lr: float = 3e-4,
                    warmup: int = 100, total_steps: int = 10_000):
    def train_step(params, opt_state, batch):
        loss, metrics, grads = loss_and_grads(params, batch, cfg)
        lr = cosine_schedule(opt_state.step, peak_lr=peak_lr,
                             warmup_steps=warmup, total_steps=total_steps)
        ctx = sharded_ctx()
        specs = None if ctx is None else M.params_pspecs(cfg, ctx.mp_size)
        with torch.no_grad(), record_function("train.adamw"):
            params, opt_state, om = adamw_update(params, grads, opt_state,
                                                 lr=lr, specs=specs)
        out_metrics = {"loss": loss, "lr": lr, **metrics, **om}
        return params, opt_state, out_metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        with torch.no_grad():
            return M.prefill(params, batch, cfg)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def serve_step(params, batch, cache, cache_len):
        with torch.no_grad():
            return M.decode_step(params, batch, cache, cache_len, cfg)
    return serve_step


# --------------------------------------------------------------------------
# specs (meta tensors of this rank's shapes)
# --------------------------------------------------------------------------
def _local(t: torch.Tensor, tokens, ctx: Optional[MeshCtx]) -> torch.Tensor:
    """A meta tensor of the shape this rank holds of ``t`` (by its sharding
    ``tokens``), in ``t``'s dtype."""
    shape = list(t.shape)
    if ctx is not None and ctx.size > 1:
        for dim, tok in enumerate(tokens or ()):
            n = {DP: ctx.dp_size, "mp": ctx.mp_size}.get(tok, 1)
            if shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} ({tokens}) "
                                 f"does not divide over {n} ranks")
            shape[dim] //= n
    return torch.empty(shape, dtype=t.dtype, device="meta")


def _sds(tree: Any, tok_tree: Any, ctx: Optional[MeshCtx]) -> Any:
    return tree_map(lambda t, toks: _local(t, toks, ctx), tree, tok_tree)


def train_state_specs(cfg: ModelConfig, ctx: Optional[MeshCtx]):
    """(params, opt_state) as meta tensors of this rank's shapes: the
    parameter tree of ``init_params`` cut by ``params_pspecs``, and the
    AdamW state (``mu``/``nu`` in ``cfg.optimizer_dtype`` with the
    parameters' tokens, ``step`` a 0-d int32) — no allocation."""
    p_full = M._build_params(cfg, None)                    # meta, full shapes
    p_tok = M.params_pspecs(cfg, ctx.mp_size if ctx else 1)
    params = _sds(p_full, p_tok, ctx)
    mdt = getattr(torch, cfg.optimizer_dtype)
    moments = lambda: tree_map(  # noqa: E731
        lambda p: torch.empty(p.shape, dtype=mdt, device="meta"), params)
    opt = AdamWState(step=torch.empty((), dtype=torch.int32, device="meta"),
                     mu=moments(), nu=moments())
    return params, opt


HBM_SERVE_BUDGET = 8e9   # bytes of params per chip we allow replicated-dp


def serve_cfg(cfg: ModelConfig, shape, ctx: Optional[MeshCtx]) -> ModelConfig:
    """For inference cells, replicate params over dp when they fit — kills
    the per-step ZeRO gathers that otherwise dominate the decode
    collective term (the reference's rule; ``REPRO_SERVE_FSDP=1`` keeps
    them sharded)."""
    if shape.kind == "train" or ctx is None or \
            os.environ.get("REPRO_SERVE_FSDP") == "1":
        return cfg
    per_chip = param_count(cfg) * 2 / max(ctx.mp_size, 1)   # bf16
    if per_chip <= HBM_SERVE_BUDGET:
        return cfg.replace(serve_params_replicated=True)
    return cfg


def input_specs(cfg: ModelConfig, shape, ctx: Optional[MeshCtx]) -> Dict[str, Any]:
    """Meta-tensor stand-ins for one assigned shape cell, this rank's
    shapes.  Returns kwargs for the step function of the cell's kind:

      train   → {params, opt_state, batch}
      prefill → {params, batch}
      decode  → {params, batch, cache, cache_len}

    ``ctx`` must be the active mesh context (or None).  The decode cache is
    this rank's (``init_cache`` on the meta device under the context), and
    ``cache_len`` the Python int S - 1: the port's ``decode_step`` takes
    the position as a host int, and S - 1 writes the cache's last slot."""
    cfg = serve_cfg(cfg, shape, ctx)
    B, S = shape.global_batch, shape.seq_len
    dt = cfg.param_dtype
    dp = ctx.dp_size if ctx else 1
    empty = lambda *shape, dtype: torch.empty(shape, dtype=dtype,  # noqa: E731
                                              device="meta")

    def batch_of(seq):
        out = {}
        if cfg.family == "audio":
            out["frames"] = empty(B, seq, cfg.d_model, dtype=dt)
            out["labels"] = empty(B, cfg.n_codebooks, seq, dtype=torch.int32)
        else:
            out["tokens"] = empty(B, seq, dtype=torch.int32)
            out["labels"] = empty(B, seq, dtype=torch.int32)
        if cfg.family == "vlm":
            out["vision_embeds"] = empty(B, cfg.vision_patches, cfg.vision_dim,
                                         dtype=torch.float32)
        if shape.kind != "train":
            out.pop("labels", None)
        toks = M.batch_pspecs(cfg, B, dp)
        return _sds(out, {k: toks[k] for k in out}, ctx)

    params, opt = train_state_specs(cfg, ctx)
    if shape.kind == "train":
        return {"params": params, "opt_state": opt, "batch": batch_of(S)}
    if shape.kind == "prefill":
        return {"params": params, "batch": batch_of(S)}
    # decode: one new token against a cache of S
    cache = M.init_cache(cfg, B, S, device="meta")
    return {"params": params, "batch": batch_of(1), "cache": cache,
            "cache_len": S - 1}


def step_fn_for(cfg: ModelConfig, shape, ctx: Optional[MeshCtx] = None):
    """(step function, the names of its arguments in order) for a cell."""
    cfg = serve_cfg(cfg, shape, ctx)
    if shape.kind == "train":
        return make_train_step(cfg), ("params", "opt_state", "batch")
    if shape.kind == "prefill":
        return make_prefill_step(cfg), ("params", "batch")
    return make_decode_step(cfg), ("params", "batch", "cache", "cache_len")
