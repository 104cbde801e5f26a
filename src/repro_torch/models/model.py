"""Unified decoder LM covering all 10 assigned architectures.

Counterpart of ``repro.models.model``.  One parameter tree — a dict with
the reference's keys, shapes and stacked leading axes — and one forward,
assembled from the block zoo (self-attention / dense-MLP / MoE /
Mamba2-SSD / cross-attention) according to ``cfg.layer_kinds()``:

  * uniform — dense, moe, ssm and audio: one stack of blocks;
  * hybrid  — zamba2: groups of (attn_every-1) Mamba2 blocks + 1 attention
              block whose parameters are *shared* across groups;
  * vlm     — llama-3.2-vision: groups of (cross_attn_every-1) self-attention
              blocks + 1 cross-attention block over the projected vision
              stream;
  * zamba2  — Zamba2 at its published equations (``models/zamba2.py``):
              Mamba2 layers with grouped B/C, and hybrid layers that feed
              (x, embedding) to one of two alternating shared blocks; no
              counterpart in the JAX package, training only.

The stacks run as Python loops over the leading axes (the reference's
``lax.scan``), over the per-layer views that one ``unbind(0)`` per stacked
leaf gives.  ``prefill`` and ``loss_fn`` are where the hand-written kernels
run on the card: every attention block, self or cross, goes through the
flash-attention kernel (forward, and under autograd its backward kernel)
and every Mamba2 block through the SSD kernels (forward, and under
autograd their backward kernels), so every family trains on the card.
``decode_step`` is plain PyTorch, as in the reference.  Caches are
returned as new tensors; the inputs are never written.

Training follows the reference: ``loss_fn`` is the vocab cross entropy,
chunked over ``cfg.loss_chunk`` with each chunk recomputed in the backward
(the reference's ``jax.checkpoint`` per chunk), plus 0.01 times the MoE
router loss; with ``cfg.remat`` each scan body (a layer; a group for the
hybrid and vlm families; the ssm family has none, as in the reference) is
recomputed in the backward by ``torch.utils.checkpoint``.

Distribution (``repro_torch.parallel.context``): ``params_pspecs``,
``cache_pspecs`` and ``batch_pspecs`` are the reference's sharding-token
trees.  Inside a ``mesh_context`` of more than one rank, ``loss_fn`` runs
SPMD by hand on the local shards those tokens name: the embedding lookup
and the cross entropy are vocab-parallel over the model group, attention
runs the rank's heads, the MLP its slice of d_ff and the MoE block its
experts (or d_ff slice), each region opened by ``enter_model`` and closed
by a sum over the model group; Mamba2 blocks run whole on every model
rank (their parameters replicate over it); each block's ``"dp"`` dims are
gathered where it runs (``fsdp_gather``).  Each rank's loss is its rows'
token sum over the global token count, summed over the data group; the
MoE router loss is the mean of the data shards' (the reference declares
its per-shard value replicated).  A batch that does not divide over the
data group is replicated and weighted 1/dp, so nothing counts twice.
``prefill`` and ``decode_step`` run under such a context too, on the
rank's rows and heads: the weights gathered over the data group as in
``loss_fn`` (none to gather with ``cfg.serve_params_replicated``), the MoE
through its mesh path at the step's token count, and the logits'
vocab shards all-gathered over the model group, so every rank returns the
full (B_loc, V) f32 logits of its data rows (the reference's "gathered
replicated").  The caches are local (``init_cache`` under the context
allocates this rank's): the batch dim is split over the data group where
``B % dp == 0`` (``cache_pspecs``' ``"dp"``), the SSM ``h``/``conv``
replicate over the model group as the Mamba2 parameters do, and a k/v
cache holds the kv heads this rank's q heads use (``_local_heads``), the
positions whole.  The reference's token ``"mp"`` sits on the k/v cache's
position dim, which GSPMD splits over the model axis; the port splits the
kv heads instead, so that each rank attends with what it holds.  Where
kv heads outnumber the model group evenly the bytes a rank holds are the
same; where a GQA model has fewer kv heads than model ranks (8 kv heads
at mp 16 in Mixtral, Mistral-Nemo, DeepSeek-Coder, Kimi-K2 and
Llama-Vision; 4 in StarCoder2) a rank holds ``max(1, kv / mp)`` = 1 kv
head, which ``mp / kv`` ranks hold alike (``parallel.rules.gather_cache``
keeps one copy).
"""
from __future__ import annotations

import functools
import itertools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from ..core import dchannel
from ..kernels.ops import resolve_device
from ..tree import tree_map
from .attention import attention, decode_attention
from ..parallel.context import (DP, MP, enter_model, fsdp_gather, pmax,
                                psum_compat, sharded_ctx)
from .config import ModelConfig
from .layers import (apply_rope, dense_init, embed_init, init_device,
                     rms_norm, swiglu)
from .moe import moe_apply, moe_init
from .ssm import init_ssm_cache, ssm_apply, ssm_decode, ssm_init

__all__ = ["init_params", "init_params_spec", "forward_hidden", "loss_fn",
           "prefill", "decode_step", "init_cache", "segment_counts",
           "params_pspecs", "cache_pspecs", "batch_pspecs", "local_kv_heads",
           "SUPPORTED_FAMILIES"]

Params = Dict[str, Any]
SUPPORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio",
                      "zamba2")
_UNIFORM = ("dense", "moe", "audio")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in SUPPORTED_FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r} ({cfg.name})")


# ==========================================================================
# layout
# ==========================================================================
def segment_counts(cfg: ModelConfig) -> Dict[str, int]:
    kinds = cfg.layer_kinds()
    if cfg.family == "hybrid":
        n_groups = sum(1 for k in kinds if k in ("attn", "attn_shared"))
        inner = cfg.attn_every - 1
        assert n_groups * cfg.attn_every == cfg.n_layers
        return {"groups": n_groups, "ssm_per_group": inner}
    if cfg.family == "vlm":
        n_groups = sum(1 for k in kinds if k == "cross")
        inner = cfg.cross_attn_every - 1
        assert n_groups * cfg.cross_attn_every == cfg.n_layers
        return {"groups": n_groups, "self_per_group": inner}
    return {"blocks": cfg.n_layers}


def _kv_heads_alloc(cfg: ModelConfig) -> int:
    # MHA: pad kv together with q heads; GQA: keep kv unpadded (replicated)
    return cfg.n_heads_padded if cfg.n_kv_heads == cfg.n_heads else cfg.n_kv_heads


# ==========================================================================
# init
# ==========================================================================
def _attn_block_init(gen: Optional[torch.Generator], cfg: ModelConfig,
                     cross: bool = False) -> Params:
    d, hp, kv, dh = cfg.d_model, cfg.n_heads_padded, _kv_heads_alloc(cfg), cfg.hdim
    dev, f32, dt = init_device(gen), torch.float32, cfg.param_dtype
    p = {
        "norm1": torch.ones((d,), dtype=f32, device=dev),
        "wq": dense_init(gen, (d, hp, dh), d, dt),
        "wk": dense_init(gen, (d, kv, dh), d, dt),
        "wv": dense_init(gen, (d, kv, dh), d, dt),
        "wo": dense_init(gen, (hp, dh, d), hp * dh, dt),
    }
    if cfg.family == "moe" and not cross:
        p["norm2"] = torch.ones((d,), dtype=f32, device=dev)
        p["moe"] = moe_init(gen, cfg)
    elif cfg.d_ff:
        p["norm2"] = torch.ones((d,), dtype=f32, device=dev)
        p["mlp"] = {
            "w_gate": dense_init(gen, (d, cfg.d_ff), d, dt),
            "w_up": dense_init(gen, (d, cfg.d_ff), d, dt),
            "w_down": dense_init(gen, (cfg.d_ff, d), cfg.d_ff, dt),
        }
    return p


def _stacked(build_one: Callable[[Optional[torch.Generator]], Any],
             gen: Optional[torch.Generator], *lead: int):
    """``build_one(gen)``'s tree with every leaf stacked on the leading
    axes ``lead``.  Each stacked leaf is allocated once and filled one
    index at a time, in row-major order, so initialisation peaks at the
    stack plus one tree (not twice the stack), and the draws come in the
    same order on every device and in every dtype."""
    dev = init_device(gen)
    out = tree_map(lambda t: torch.empty(lead + tuple(t.shape), dtype=t.dtype,
                                     device=dev), build_one(None))
    if gen is not None:
        for idx in itertools.product(*map(range, lead)):
            _fill(out, build_one(gen), idx)
    return out


def _fill(dst, src, idx) -> None:
    if isinstance(dst, dict):
        for k in dst:
            _fill(dst[k], src[k], idx)
    else:
        dst[idx].copy_(src)


def _layers(tree) -> List[Any]:
    """A stacked tree as the list of its per-index trees (views), by one
    ``unbind(0)`` per leaf.  Under autograd the gradient of each stacked
    leaf is then stacked once from the per-layer gradients; indexing layer
    by layer would write a zero-filled gradient of the whole stack for
    every layer."""
    if isinstance(tree, dict):
        parts = {k: _layers(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(tree.unbind(0))


def _build_params(cfg: ModelConfig, gen: Optional[torch.Generator]) -> Params:
    if cfg.family == "zamba2":
        from . import zamba2
        return zamba2.init_params(cfg, gen)
    segs = segment_counts(cfg)
    V, d, dt = cfg.vocab_padded, cfg.d_model, cfg.param_dtype
    params: Params = {
        "embed": embed_init(gen, V, d, dt),
        "final_norm": torch.ones((d,), dtype=torch.float32,
                                 device=init_device(gen)),
    }
    if cfg.n_codebooks:
        params["lm_head"] = _stacked(lambda g: embed_init(g, V, d, dt), gen,
                                     cfg.n_codebooks)
    else:
        params["lm_head"] = embed_init(gen, V, d, dt)
    if cfg.family == "hybrid":
        params["ssm"] = _stacked(lambda g: ssm_init(g, cfg), gen,
                                 segs["groups"], segs["ssm_per_group"])
        params["shared_attn"] = _attn_block_init(gen, cfg)   # ONE block, reused
    elif cfg.family == "vlm":
        g, inner = segs["groups"], segs["self_per_group"]
        params["self"] = _stacked(lambda gn: _attn_block_init(gn, cfg), gen,
                                  g, inner)
        params["cross"] = _stacked(
            lambda gn: _attn_block_init(gn, cfg, cross=True), gen, g)
        params["vision_proj"] = dense_init(gen, (cfg.vision_dim, d),
                                           cfg.vision_dim, dt)
    elif cfg.family == "ssm":
        params["blocks"] = _stacked(lambda g: ssm_init(g, cfg), gen,
                                    segs["blocks"])
    else:
        params["blocks"] = _stacked(lambda g: _attn_block_init(g, cfg), gen,
                                    segs["blocks"])
    return params


def init_params(cfg: ModelConfig, seed: int = 0, device: Any = None) -> Params:
    """Random parameters with the reference's tree, shapes, dtypes and
    distributions, drawn on ``device`` (``None``: the card) by a
    ``torch.Generator`` seeded with ``seed``."""
    _check_family(cfg)
    dev = resolve_device(device)
    return _build_params(cfg, torch.Generator(device=dev).manual_seed(seed))


def init_params_spec(cfg: ModelConfig) -> Params:
    """The tree of ``init_params`` as ``(shape, dtype)`` leaves, drawn
    nowhere (on the ``meta`` device)."""
    _check_family(cfg)
    return tree_map(lambda t: (tuple(t.shape), t.dtype), _build_params(cfg, None))


# ==========================================================================
# sharding-token trees (the reference's, token for token)
# ==========================================================================
def _fsdp_tok(cfg: ModelConfig):
    """'dp' for training (ZeRO-3); None for replicated-param serving."""
    return None if cfg.serve_params_replicated else DP


def _attn_block_specs(cfg: ModelConfig, mp_size: int, cross: bool = False):
    dp = _fsdp_tok(cfg)
    p = {
        "norm1": None,
        "wq": (dp, MP, None),
        "wk": (dp, None, None),
        "wv": (dp, None, None),
        "wo": (MP, None, dp),
    }
    if cfg.family == "moe" and not cross:
        ep = cfg.n_experts % max(mp_size, 1) == 0
        moe = {
            "router": (dp, None),
            "w_gate": (MP, dp, None) if ep else (None, dp, MP),
            "w_up": (MP, dp, None) if ep else (None, dp, MP),
            "w_down": (MP, None, dp) if ep else (None, MP, dp),
        }
        if cfg.n_shared_experts:
            moe["shared"] = {"w_gate": (dp, MP), "w_up": (dp, MP),
                             "w_down": (MP, dp)}
        p["norm2"] = None
        p["moe"] = moe
    elif cfg.d_ff:
        p["norm2"] = None
        p["mlp"] = {"w_gate": (dp, MP), "w_up": (dp, MP), "w_down": (MP, dp)}
    return p


def _ssm_specs(cfg: ModelConfig):
    # The SSD state mixes (H, P, N) non-separably with n_groups=1, so Mamba
    # parameters replicate over the model axis (as in the reference: Mamba
    # TP needs grouped B/C); FSDP over data still shards their storage.
    dp = _fsdp_tok(cfg)
    return {
        "w_z": (dp, None), "w_xbc": (dp, None), "w_dt": (dp, None),
        "dt_bias": None, "A_log": None, "D": None,
        "conv_w": (None, dp), "norm": None, "w_out": (None, dp),
    }


def params_pspecs(cfg: ModelConfig, mp_size: int = 16) -> Params:
    """Same tree structure as init_params, with sharding-token tuples.
    Stacked segments get a leading ``None`` dim prepended per stack level."""
    def prepend(tree, n_lead: int):
        return tree_map(lambda s: (None,) * n_lead
                        + (s if isinstance(s, tuple) else ()), tree)

    dp = _fsdp_tok(cfg)
    specs: Params = {
        "embed": (MP, dp),
        "final_norm": None,
        "lm_head": (None, MP, dp) if cfg.n_codebooks else (MP, dp),
    }
    if cfg.family == "hybrid":
        specs["ssm"] = prepend(_ssm_specs(cfg), 2)
        specs["shared_attn"] = _attn_block_specs(cfg, mp_size)
    elif cfg.family == "vlm":
        specs["self"] = prepend(_attn_block_specs(cfg, mp_size), 2)
        specs["cross"] = prepend(_attn_block_specs(cfg, mp_size, cross=True), 1)
        specs["vision_proj"] = (dp, None)
    elif cfg.family == "ssm":
        specs["blocks"] = prepend(_ssm_specs(cfg), 1)
    else:
        specs["blocks"] = prepend(_attn_block_specs(cfg, mp_size), 1)
    return specs


def cache_pspecs(cfg: ModelConfig, batch: int, dp_divisible: bool) -> Dict[str, Any]:
    b = DP if dp_divisible else None
    kv_spec = (None, b, MP, None, None)
    if cfg.family in _UNIFORM:
        return {"k": kv_spec, "v": kv_spec}
    if cfg.family == "ssm":
        return {"h": (None, b, None, None, None), "conv": (None, b, None, None)}
    if cfg.family == "hybrid":
        return {"h": (None, None, b, None, None, None),
                "conv": (None, None, b, None, None),
                "k": kv_spec, "v": kv_spec}
    if cfg.family == "vlm":
        s = (None, None, b, MP, None, None)
        return {"k": s, "v": s}
    raise ValueError(cfg.family)


def batch_pspecs(cfg: ModelConfig, batch: int, dp_size: int) -> Dict[str, Any]:
    b = DP if batch % max(dp_size, 1) == 0 else None
    out = {}
    if cfg.family == "audio":
        out["frames"] = (b, None, None)
        out["labels"] = (b, None, None)
    else:
        out["tokens"] = (b, None)
        out["labels"] = (b, None)
    if cfg.family == "vlm":
        out["vision_embeds"] = (b, None, None)
    return out


# ==========================================================================
# blocks
# ==========================================================================
class _LeaveRange(torch.autograd.Function):
    """Identity on a chunk's differentiable inputs.  Its backward runs once
    every backward node of the chunk has (the casts of the gradients back
    to the inputs' dtypes last), and leaves the range ``box`` holds."""

    @staticmethod
    def forward(ctx, box, *inputs):
        ctx.box = box
        return inputs

    @staticmethod
    def backward(ctx, *grads):
        if ctx.box:
            ctx.box.pop().__exit__(None, None, None)
        return (None, *grads)


def _span(name: str, fn: Callable, *args):
    """``fn(*args)`` under a profiler range ``name``, and while a profiler
    runs, its backward under one too: a prehook on the output's node
    enters it, and the backward of :class:`_LeaveRange`, through which the
    floating-point tensors among ``args`` and in its dicts (one level)
    pass, leaves it.  Off, one flag read a call."""
    box: List[Any] = []
    traced = (torch.autograd.profiler._is_profiler_enabled
              and torch.is_grad_enabled())
    if traced:
        args = [dict(a) if isinstance(a, dict) else a for a in args]
        slots = [(i, None) for i, a in enumerate(args)
                 if torch.is_tensor(a) and a.is_floating_point()]
        slots += [(i, k) for i, a in enumerate(args) if isinstance(a, dict)
                  for k, v in a.items()
                  if torch.is_tensor(v) and v.is_floating_point()]
        held = _LeaveRange.apply(box, *(args[i] if k is None else args[i][k]
                                        for i, k in slots))
        for (i, k), t in zip(slots, held):
            if k is None:
                args[i] = t
            else:
                args[i][k] = t
    with record_function(name):
        out = fn(*args)
    if traced and out.grad_fn is not None:
        out.grad_fn.register_prehook(lambda _: box.append(
            record_function(name).__enter__()))
    return out


def _ce_range(fn: Callable) -> Callable:
    """``fn(x_c, labels_c, head, ...)`` under :func:`_span`'s range
    "train.ce": the chunk's forward, its recompute and, while a profiler
    runs, its backward (left once ``x_c``'s and ``head``'s gradients are
    made)."""
    @functools.wraps(fn)
    def ranged(*args):
        return _span("train.ce", fn, *args)
    return ranged


@_ce_range
def _chunk_ce(x_c: torch.Tensor, labels_c: torch.Tensor, head: torch.Tensor,
              vocab: int) -> torch.Tensor:
    """Per-token cross entropy of one chunk: logits in f32, the vocab
    padding sliced off.  Under the "train.ce" range (:func:`_ce_range`):
    the forward, its recompute, and while a profiler runs, the backward."""
    logits = (x_c.float() @ head.float().T)[..., :vocab]
    lse = torch.logsumexp(logits, dim=-1)
    lab = torch.gather(logits, -1, labels_c[..., None].long())[..., 0]
    return lse - lab


@_ce_range
def _chunk_ce_sharded(x_c: torch.Tensor, labels_c: torch.Tensor,
                      head: torch.Tensor, vocab: int, group) -> torch.Tensor:
    """:func:`_chunk_ce` with ``head`` this rank's rows of the vocab: the
    max over the group on a detached value (a stabiliser), the sums of
    exponentials and the label logit summed over the group, the vocab
    padding masked by global id."""
    logits = x_c.float() @ head.float().T              # (B, c, V/mp)
    v_loc = logits.shape[-1]
    lo = group.rank * v_loc
    gid = lo + torch.arange(v_loc, device=logits.device)
    logits = torch.where(gid < vocab, logits, -1e30)
    gmax = pmax(logits.amax(dim=-1), group)
    se = torch.exp(logits - gmax[..., None]).sum(dim=-1)
    lse = torch.log(psum_compat(se, group)) + gmax
    loc = labels_c.long() - lo
    ok = (loc >= 0) & (loc < v_loc)
    lab = torch.gather(logits, -1, loc.clamp(0, v_loc - 1)[..., None])[..., 0]
    lab = psum_compat(torch.where(ok, lab, 0.0), group)
    return lse - lab


def _vocab_ce(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """(B, S) per-token cross entropy of x (B,S,d) against head (V,d).
    With ``cfg.loss_chunk`` dividing S it runs chunk by chunk along S and,
    under autograd, each chunk's logits are recomputed in the backward
    instead of kept (the reference's ``jax.checkpoint``), so no more than
    one chunk's (B, chunk, V) f32 logits live at a time."""
    S = x.shape[1]
    ctx = sharded_ctx()
    fn, extra = _chunk_ce, ()
    if ctx is not None:     # vocab-parallel over the model group
        head = fsdp_gather(head, (MP, _fsdp_tok(cfg)))
        x = enter_model(x, ctx.model)
        fn, extra = _chunk_ce_sharded, (ctx.model,)
    csize = cfg.loss_chunk if cfg.loss_chunk and S % cfg.loss_chunk == 0 else S
    if csize == S:
        return fn(x, labels, head, cfg.vocab_size, *extra)
    recompute = torch.is_grad_enabled()
    parts = []
    for c0 in range(0, S, csize):
        args = (x[:, c0:c0 + csize], labels[:, c0:c0 + csize], head,
                cfg.vocab_size, *extra)
        parts.append(checkpoint(fn, *args, use_reentrant=False)
                     if recompute else fn(*args))
    return torch.cat(parts, dim=1)


def _logits_full(x: torch.Tensor, head: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits (B, V) in f32.  Under a sharded context ``head`` is this
    rank's vocab rows: its ``"dp"`` dim is gathered, and the rows' logits
    are all-gathered over the model group, so every rank holds them all."""
    ctx = sharded_ctx()
    if ctx is not None:
        head = fsdp_gather(head, (MP, _fsdp_tok(cfg)))
    logits = x.float() @ head.float().T
    if ctx is not None:
        logits = dchannel.all_gather(logits.contiguous(), ctx.model, dim=-1)
    return logits[:, :cfg.vocab_size]


def _head_mask(cfg: ModelConfig, device) -> Optional[torch.Tensor]:
    hp = cfg.n_heads_padded
    if hp == cfg.n_heads:
        return None
    return (torch.arange(hp, device=device) < cfg.n_heads).to(cfg.param_dtype)


def _local_heads(cfg: ModelConfig, n: int, m: int) -> Tuple[slice, slice]:
    """(q heads, kv heads) of model rank ``m`` of ``n``: a contiguous 1/n
    of the (padded) q heads, and the kv heads those use (q head j uses kv
    head j // (H / Hkv))."""
    hp, kv = cfg.n_heads_padded, _kv_heads_alloc(cfg)
    hl, g = hp // n, hp // kv
    j0 = m * hl
    k0, k1 = j0 // g, (j0 + hl - 1) // g + 1
    if hp % n or hl % (k1 - k0) or (hl >= g and hl % g) or (hl < g and g % hl):
        raise ValueError(f"{cfg.name}: {hp} q heads and {kv} kv heads do not "
                         f"split over {n} model ranks")
    return slice(j0, j0 + hl), slice(k0, k1)


def local_kv_heads(cfg: ModelConfig, mp_size: int = 1, mp_rank: int = 0) -> int:
    """The kv heads a model rank holds (in its k/v cache, and of ``wk``/
    ``wv``): those its q heads use, ``max(1, kv / mp)``."""
    if mp_size == 1:
        return _kv_heads_alloc(cfg)
    ks = _local_heads(cfg, mp_size, mp_rank)[1]
    return ks.stop - ks.start


def _attn_core(p, x, cfg: ModelConfig, *, positions, mode: str,
               kv_cache=None, cache_len=None, rolling=False, vision=None,
               start_pos=None):
    """Shared attention path. Returns (delta, new_kv_cache or None).

    With ``vision`` (cross-attention) k and v are projected from the
    vision stream: q takes no RoPE, prefill attends every vision row
    (non-causal), decode attends them all, and no cache is returned.

    Under a sharded context ``p`` is gathered over the data group and the
    rank runs its q heads (``_local_heads``) with the kv heads they use,
    and the output projection's partial sums are summed over the model
    group."""
    ctx = sharded_ctx()
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    wk, wv = p["wk"], p["wv"]
    mask = _head_mask(cfg, x.device)
    if ctx is not None:
        qs, ks = _local_heads(cfg, ctx.model.size, ctx.model.rank)
        h = enter_model(h, ctx.model)
        # wk/wv replicate over the model group and a rank uses only its
        # kv heads: the entry operator sums their gradient over the group
        wk = enter_model(wk, ctx.model)[:, ks]
        wv = enter_model(wv, ctx.model)[:, ks]
        if vision is not None:
            vision = enter_model(vision, ctx.model)
        if mask is not None:
            mask = mask[qs]
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    if vision is not None:
        k = torch.einsum("bpd,dhk->bphk", vision, wk)
        v = torch.einsum("bpd,dhk->bphk", vision, wv)
    else:
        k = torch.einsum("bsd,dhk->bshk", h, wk)
        v = torch.einsum("bsd,dhk->bshk", h, wv)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    new_cache = None
    if mode == "decode" and vision is None:
        k_cache, v_cache = kv_cache
        T = k_cache.shape[1]
        # the reference's dynamic_update_slice clamps the slot to T - 1
        slot = (cache_len % T) if rolling else min(cache_len, T - 1)
        k_cache, v_cache = k_cache.clone(), v_cache.clone()
        k_cache[:, slot] = k[:, 0].to(k_cache.dtype)
        v_cache[:, slot] = v[:, 0].to(v_cache.dtype)
        new_cache = (k_cache, v_cache)
        attn = decode_attention(q, k_cache, v_cache, cache_len + 1,
                                window=cfg.sliding_window, rolling=rolling,
                                start_pos=start_pos)
    elif mode == "decode":
        attn = decode_attention(q, k, v, k.shape[1])
    else:
        attn = attention(q, k, v, causal=vision is None,
                         window=cfg.sliding_window, impl=cfg.attn_impl,
                         q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk,
                         causal_skip=cfg.causal_skip)
        if vision is None and mode == "prefill":
            new_cache = (k, v)
    if mask is not None:
        attn = attn * mask[None, None, :, None]
    out = torch.einsum("bshk,hkd->bsd", attn.to(x.dtype), p["wo"])
    if ctx is not None:
        out = psum_compat(out, ctx.model)
    return out, new_cache


def _ffn_part(p, x, cfg: ModelConfig):
    """MLP or MoE sub-block (with pre-norm + residual).  Returns (x, aux):
    the MoE router's load-balancing loss, None without one."""
    ctx = sharded_ctx()
    if "moe" in p:
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        delta, aux = moe_apply(h, p["moe"], cfg,
                               axis_name=None if ctx is None else ctx.model)
        return x + delta, aux
    if "mlp" in p:
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        m = p["mlp"]
        if ctx is None:
            return x + swiglu(h, m["w_gate"], m["w_up"], m["w_down"]), None
        part = swiglu(enter_model(h, ctx.model), m["w_gate"], m["w_up"],
                      m["w_down"])                  # this rank's d_ff slice
        return x + psum_compat(part, ctx.model), None
    return x, None


def _attn_block(p, x, cfg, *, positions, mode, kv_cache=None, cache_len=None,
                rolling=False, vision=None, start_pos=None):
    ctx = sharded_ctx()
    if ctx is not None:
        p = fsdp_gather(p, _attn_block_specs(cfg, ctx.mp_size,
                                             cross=vision is not None))
    delta, new_cache = _attn_core(p, x, cfg, positions=positions, mode=mode,
                                  kv_cache=kv_cache, cache_len=cache_len,
                                  rolling=rolling, vision=vision,
                                  start_pos=start_pos)
    x, aux = _ffn_part(p, x + delta, cfg)
    return x, aux, new_cache


def _ssm_block(p, x, cfg, mode, cache):
    """One Mamba2 block with residual. Returns (x, new_cache or None)."""
    if sharded_ctx() is not None:
        p = fsdp_gather(p, _ssm_specs(cfg))
    if mode == "decode":
        delta, nc = ssm_decode(p, x, cache, cfg)
        return x + delta, nc
    if mode == "prefill":
        delta, nc = ssm_apply(p, x, cfg, return_cache=True)
        return x + delta, nc
    return x + ssm_apply(p, x, cfg), None


# ==========================================================================
# forward
# ==========================================================================
def _vision_kv(params, vision_embeds, cfg: ModelConfig):
    """Project the (stub) vision embeddings once; per-cross-layer K/V are
    computed from this shared stream inside each cross block."""
    proj = fsdp_gather(params["vision_proj"], (_fsdp_tok(cfg), None))
    return (vision_embeds @ proj).to(proj.dtype)


def _maybe_remat(cfg: ModelConfig, mode: str) -> Callable:
    """``call(fn, *args, **kw)``: ``fn``'s activations recomputed in the
    backward (``torch.utils.checkpoint``, non-reentrant) in the train mode
    with ``cfg.remat`` under autograd; a plain call otherwise."""
    if mode != "train" or not cfg.remat or not torch.is_grad_enabled():
        return lambda fn, *a, **kw: fn(*a, **kw)
    return lambda fn, *a, **kw: checkpoint(fn, *a, use_reentrant=False, **kw)


def forward_hidden(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                   mode: str = "train", positions=None, cache=None,
                   cache_len=None, vision_stream=None, start_pos=None):
    """Run all blocks. x: (B,S,d) embeddings.  Returns (x, aux, new_cache):
    aux is the sum of the MoE blocks' router losses (f32, 0 without).
    ``mode``: "train" (no cache; remat per ``cfg.remat``), "prefill" or
    "decode"."""
    _check_family(cfg)
    if cfg.family == "zamba2":
        from . import zamba2
        x = zamba2.forward_hidden(params, x, cfg, mode=mode, positions=positions)
        return x, _sum_aux([], x.device), {}
    rolling = cfg.sliding_window is not None and mode == "decode"
    keep = mode in ("decode", "prefill")
    decode = mode == "decode"
    remat = _maybe_remat(cfg, mode)
    auxes = []
    new_cache: Dict[str, Any] = {}

    def block(p, x, **kw):
        return _attn_block(p, x, cfg, positions=positions, mode=mode,
                           start_pos=start_pos, **kw)

    if cfg.family in _UNIFORM:
        ks, vs = [], []
        for i, p in enumerate(_layers(params["blocks"])):
            kvc = (cache["k"][i], cache["v"][i]) if decode else None
            x, aux, nc = remat(block, p, x, kv_cache=kvc, cache_len=cache_len,
                               rolling=rolling)
            auxes.append(aux)
            if nc is not None:
                ks.append(nc[0])
                vs.append(nc[1])
        if keep:
            new_cache = {"k": torch.stack(ks), "v": torch.stack(vs)}

    elif cfg.family == "ssm":
        hs, convs = [], []
        for i, p in enumerate(_layers(params["blocks"])):
            c = {"h": cache["h"][i], "conv": cache["conv"][i]} if decode else None
            x, nc = _ssm_block(p, x, cfg, mode, c)
            if nc is not None:
                hs.append(nc["h"])
                convs.append(nc["conv"])
        if keep:
            new_cache = {"h": torch.stack(hs), "conv": torch.stack(convs)}

    elif cfg.family == "hybrid":
        shared_p = params["shared_attn"]
        clen = cache_len if cache_len is not None else 0

        def group(ssm_ps, x, gi):
            g_h, g_conv = [], []
            for ii, p in enumerate(ssm_ps):
                c = {"h": cache["h"][gi, ii], "conv": cache["conv"][gi, ii]} \
                    if decode else None
                x, nc = _ssm_block(p, x, cfg, mode, c)
                if nc is not None:
                    g_h.append(nc["h"])
                    g_conv.append(nc["conv"])
            kvc = (cache["k"][gi], cache["v"][gi]) if decode else None
            x, aux, nc = block(shared_p, x, kv_cache=kvc, cache_len=clen)
            return x, aux, (g_h, g_conv, nc)

        hs, convs, ks, vs = [], [], [], []
        for gi, g_tree in enumerate(_layers(params["ssm"])):
            x, aux, (g_h, g_conv, nc) = remat(group, _layers(g_tree), x, gi)
            auxes.append(aux)
            if keep:
                hs.append(torch.stack(g_h))
                convs.append(torch.stack(g_conv))
                ks.append(nc[0])
                vs.append(nc[1])
        if keep:
            new_cache = {"h": torch.stack(hs), "conv": torch.stack(convs),
                         "k": torch.stack(ks), "v": torch.stack(vs)}

    else:  # vlm
        clen = cache_len if cache_len is not None else 0

        def group(self_ps, pc, x, gi):
            g_k, g_v, g_aux = [], [], []
            for ii, p in enumerate(self_ps):
                kvc = (cache["k"][gi, ii], cache["v"][gi, ii]) if decode else None
                x, aux, nc = block(p, x, kv_cache=kvc, cache_len=clen)
                g_aux.append(aux)
                if nc is not None:
                    g_k.append(nc[0])
                    g_v.append(nc[1])
            # cross-attention over the vision stream, projected per block
            x, aux, _ = block(pc, x, vision=vision_stream)
            return x, _sum_aux(g_aux + [aux], x.device), (g_k, g_v)

        ks, vs = [], []
        for gi, (s_tree, pc) in enumerate(zip(_layers(params["self"]),
                                              _layers(params["cross"]))):
            x, aux, (g_k, g_v) = remat(group, _layers(s_tree), pc, x, gi)
            auxes.append(aux)
            if keep:
                ks.append(torch.stack(g_k))
                vs.append(torch.stack(g_v))
        if keep:
            new_cache = {"k": torch.stack(ks), "v": torch.stack(vs)}

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, _sum_aux(auxes, x.device), new_cache


def _sum_aux(auxes, device) -> torch.Tensor:
    """The router losses that are not None, summed; f32 0 without one."""
    auxes = [a for a in auxes if a is not None]
    return sum(auxes) if auxes else torch.zeros((), dtype=torch.float32,
                                                device=device)


# ==========================================================================
# entry points
# ==========================================================================
def _embed_lookup(table: torch.Tensor, ids: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """``table[ids]``; under a sharded context vocab-parallel: each model
    rank looks up the ids in its rows (zeros elsewhere) and the rows are
    summed over the model group."""
    ctx = sharded_ctx()
    if ctx is None:
        return table[ids.long()]
    tbl = fsdp_gather(table, (MP, _fsdp_tok(cfg)))
    v_loc = tbl.shape[0]
    loc = ids.long() - ctx.model.rank * v_loc
    ok = (loc >= 0) & (loc < v_loc)
    emb = torch.where(ok[..., None], tbl[loc.clamp(0, v_loc - 1)],
                      torch.zeros((), dtype=tbl.dtype, device=tbl.device))
    return psum_compat(emb, ctx.model)


def _embed_batch(params, batch, cfg: ModelConfig):
    """(x (B,S,d) in the working dtype, the projected vision stream or
    None): audio reads precomputed frame embeddings, vlm also projects
    ``batch["vision_embeds"]`` (the stub frontends)."""
    _check_family(cfg)
    if cfg.family == "audio":
        x = batch["frames"].to(cfg.param_dtype)
    else:
        x = _embed_lookup(params["embed"], batch["tokens"], cfg)
    vision = None
    if cfg.family == "vlm":
        vision = _vision_kv(params, batch["vision_embeds"].to(cfg.param_dtype), cfg)
    return x, vision


def _logits(last: torch.Tensor, params, cfg: ModelConfig) -> torch.Tensor:
    """(B, V) logits, or (B, n_codebooks, V) for audio; f32."""
    if cfg.n_codebooks:
        return torch.stack([_logits_full(last, params["lm_head"][cb], cfg)
                            for cb in range(cfg.n_codebooks)], dim=1)
    return _logits_full(last, params["lm_head"], cfg)


def loss_fn(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token cross entropy plus 0.01 times the MoE router loss.

    batch: {"tokens": (B,S) int, "labels": (B,S) int} (audio:
    {"frames": (B,S,d), "labels": (B,n_codebooks,S)}, the mean of the
    codebooks' losses; vlm adds {"vision_embeds": (B,P,vision_dim)}), on
    the parameters' device.  Returns (loss, {"ce", "aux"}), 0-d f32."""
    x, vision = _embed_batch(params, batch, cfg)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device).expand(B, S)
    x, aux, _ = forward_hidden(params, x, cfg, mode="train",
                               positions=positions, vision_stream=vision)
    if cfg.n_codebooks:
        losses = [_vocab_ce(x, params["lm_head"][cb], batch["labels"][:, cb],
                            cfg).mean() for cb in range(cfg.n_codebooks)]
        ce = sum(losses) / cfg.n_codebooks
    else:
        head = params["embed"] if cfg.family == "zamba2" else params["lm_head"]
        ce = _vocab_ce(x, head, batch["labels"], cfg).mean()
    ctx = sharded_ctx()
    if ctx is not None:
        # this rank's rows' share of the global mean (rows split evenly, or
        # replicated and weighted 1/dp), summed over the data group; the
        # sum's backward is the identity, so each rank differentiates its
        # own share
        ce = psum_compat(ce / ctx.dp_size, ctx.data)
        aux = psum_compat(aux / ctx.dp_size, ctx.data)
    loss = ce + 0.01 * aux
    return loss, {"ce": ce, "aux": aux}


def _no_serving(cfg: ModelConfig) -> None:
    if cfg.family == "zamba2":
        from .zamba2 import SERVING_CELL
        raise NotImplementedError(
            f"{cfg.name}: the zamba2 family trains only; prefill, decode and "
            f"their caches wait for the serving cell {SERVING_CELL}")


def prefill(params: Params, batch, cfg: ModelConfig):
    """Forward pass that also returns the populated cache + last logits.

    batch: {"tokens": (B,S) int} ({"frames": (B,S,d)} for audio; vlm adds
    {"vision_embeds": (B,P,vision_dim)}).  Returns (logits (B,V) f32, or
    (B,n_codebooks,V) for audio, cache).  Under a sharded context: this
    rank's rows and shards, the full logits of its rows, its local cache
    (see the module's docstring)."""
    _no_serving(cfg)
    x, vision = _embed_batch(params, batch, cfg)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device).expand(B, S)
    x, _, new_cache = forward_hidden(params, x, cfg, mode="prefill",
                                     positions=positions, vision_stream=vision)
    if cfg.sliding_window is not None and "k" in new_cache:
        w = min(cfg.sliding_window, S)
        new_cache["k"] = new_cache["k"][:, :, -w:]
        new_cache["v"] = new_cache["v"][:, :, -w:]
    return _logits(x[:, -1], params, cfg), new_cache


def decode_step(params: Params, batch, cache, cache_len: int, cfg: ModelConfig):
    """One token for every sequence in the batch.

    batch: {"tokens": (B,1)} ({"frames": (B,1,d)} for audio; vlm adds
    {"vision_embeds"}) and optionally {"start_pos": (B,)};
    cache_len: int — valid length before this step.
    Returns (logits as ``prefill``'s, new_cache).  Under a sharded
    context ``cache`` is this rank's, as ``prefill`` and ``init_cache``
    make it."""
    _no_serving(cfg)
    x, vision = _embed_batch(params, batch, cfg)
    cache_len = int(cache_len)
    positions = torch.full((x.shape[0], 1), cache_len, dtype=torch.long,
                           device=x.device)
    x, _, new_cache = forward_hidden(params, x, cfg, mode="decode",
                                     positions=positions, cache=cache,
                                     cache_len=cache_len, vision_stream=vision,
                                     start_pos=batch.get("start_pos"))
    return _logits(x[:, -1], params, cfg), new_cache


# ==========================================================================
# caches
# ==========================================================================
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: Any = None) -> Dict[str, Any]:
    """Allocate an (empty) decode cache matching forward_hidden's layout,
    on ``device`` (``None``: the card; ``"meta"`` allocates nothing).
    Under a sharded context, this rank's local cache: ``batch`` rows
    split over the data group where they divide, and the rank's kv
    heads."""
    _check_family(cfg)
    _no_serving(cfg)
    dev = resolve_device(device)
    kv = _kv_heads_alloc(cfg)
    ctx = sharded_ctx()
    if ctx is not None:
        kv = local_kv_heads(cfg, ctx.mp_size, ctx.model.rank)
        if batch % ctx.dp_size == 0:
            batch //= ctx.dp_size
    T = min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len
    dt = cfg.param_dtype
    segs = segment_counts(cfg)

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    if cfg.family in _UNIFORM:
        n = segs["blocks"]
        return {"k": zeros(n, batch, T, kv, cfg.hdim),
                "v": zeros(n, batch, T, kv, cfg.hdim)}
    if cfg.family == "vlm":
        g, inner = segs["groups"], segs["self_per_group"]
        return {"k": zeros(g, inner, batch, T, kv, cfg.hdim),
                "v": zeros(g, inner, batch, T, kv, cfg.hdim)}
    one = init_ssm_cache(batch, cfg, dt, dev)
    if cfg.family == "ssm":
        n = segs["blocks"]
        return {"h": zeros(n, *one["h"].shape, dtype=torch.float32),
                "conv": zeros(n, *one["conv"].shape)}
    g, inner = segs["groups"], segs["ssm_per_group"]
    return {"h": zeros(g, inner, *one["h"].shape, dtype=torch.float32),
            "conv": zeros(g, inner, *one["conv"].shape),
            "k": zeros(g, batch, T, kv, cfg.hdim),
            "v": zeros(g, batch, T, kv, cfg.hdim)}
