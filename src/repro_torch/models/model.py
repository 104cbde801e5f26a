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
              stream.

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

Left for a later slice of the port: the sharding specs (ROADMAP §1 item
11, multi-GPU); there is one device.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from ..kernels.ops import resolve_device
from ..tree import tree_map
from .attention import attention, decode_attention
from .config import ModelConfig
from .layers import (apply_rope, dense_init, embed_init, init_device,
                     rms_norm, swiglu)
from .moe import moe_apply, moe_init
from .ssm import init_ssm_cache, ssm_apply, ssm_decode, ssm_init

__all__ = ["init_params", "init_params_spec", "forward_hidden", "loss_fn",
           "prefill", "decode_step", "init_cache", "segment_counts",
           "SUPPORTED_FAMILIES"]

Params = Dict[str, Any]
SUPPORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
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
# blocks
# ==========================================================================
def _chunk_ce(x_c: torch.Tensor, labels_c: torch.Tensor, head: torch.Tensor,
              vocab: int) -> torch.Tensor:
    """Per-token cross entropy of one chunk: logits in f32, the vocab
    padding sliced off.  A profiler range ("train.ce") covers it, the
    backward's recompute included."""
    with record_function("train.ce"):
        logits = (x_c.float() @ head.float().T)[..., :vocab]
        lse = torch.logsumexp(logits, dim=-1)
        lab = torch.gather(logits, -1, labels_c[..., None].long())[..., 0]
        return lse - lab


def _vocab_ce(x: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """(B, S) per-token cross entropy of x (B,S,d) against head (V,d).
    With ``cfg.loss_chunk`` dividing S it runs chunk by chunk along S and,
    under autograd, each chunk's logits are recomputed in the backward
    instead of kept (the reference's ``jax.checkpoint``), so no more than
    one chunk's (B, chunk, V) f32 logits live at a time."""
    S = x.shape[1]
    csize = cfg.loss_chunk if cfg.loss_chunk and S % cfg.loss_chunk == 0 else S
    if csize == S:
        return _chunk_ce(x, labels, head, cfg.vocab_size)
    recompute = torch.is_grad_enabled()
    parts = []
    for c0 in range(0, S, csize):
        args = (x[:, c0:c0 + csize], labels[:, c0:c0 + csize], head,
                cfg.vocab_size)
        parts.append(checkpoint(_chunk_ce, *args, use_reentrant=False)
                     if recompute else _chunk_ce(*args))
    return torch.cat(parts, dim=1)


def _logits_full(x: torch.Tensor, head: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Logits (B, V) in f32."""
    logits = x.float() @ head.float().T
    return logits[:, :cfg.vocab_size]


def _head_mask(cfg: ModelConfig, device) -> Optional[torch.Tensor]:
    hp = cfg.n_heads_padded
    if hp == cfg.n_heads:
        return None
    return (torch.arange(hp, device=device) < cfg.n_heads).to(cfg.param_dtype)


def _attn_core(p, x, cfg: ModelConfig, *, positions, mode: str,
               kv_cache=None, cache_len=None, rolling=False, ext_kv=None,
               start_pos=None):
    """Shared attention path. Returns (delta, new_kv_cache or None).

    With ``ext_kv`` (cross-attention) k and v are the projected vision
    stream's: q takes no RoPE, prefill attends every vision row
    (non-causal), decode attends them all, and no cache is returned."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    if ext_kv is not None:
        k, v = ext_kv
    else:
        k = torch.einsum("bsd,dhk->bshk", h, p["wk"])
        v = torch.einsum("bsd,dhk->bshk", h, p["wv"])
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    new_cache = None
    if mode == "decode" and ext_kv is None:
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
        attn = attention(q, k, v, causal=ext_kv is None,
                         window=cfg.sliding_window, impl=cfg.attn_impl,
                         q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk,
                         causal_skip=cfg.causal_skip)
        if ext_kv is None and mode == "prefill":
            new_cache = (k, v)
    mask = _head_mask(cfg, x.device)
    if mask is not None:
        attn = attn * mask[None, None, :, None]
    out = torch.einsum("bshk,hkd->bsd", attn.to(x.dtype), p["wo"])
    return out, new_cache


def _ffn_part(p, x, cfg: ModelConfig):
    """MLP or MoE sub-block (with pre-norm + residual).  Returns (x, aux):
    the MoE router's load-balancing loss, None without one."""
    if "moe" in p:
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        delta, aux = moe_apply(h, p["moe"], cfg)
        return x + delta, aux
    if "mlp" in p:
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        m = p["mlp"]
        return x + swiglu(h, m["w_gate"], m["w_up"], m["w_down"]), None
    return x, None


def _attn_block(p, x, cfg, *, positions, mode, kv_cache=None, cache_len=None,
                rolling=False, ext_kv=None, start_pos=None):
    delta, new_cache = _attn_core(p, x, cfg, positions=positions, mode=mode,
                                  kv_cache=kv_cache, cache_len=cache_len,
                                  rolling=rolling, ext_kv=ext_kv,
                                  start_pos=start_pos)
    x, aux = _ffn_part(p, x + delta, cfg)
    return x, aux, new_cache


def _ssm_block(p, x, cfg, mode, cache):
    """One Mamba2 block with residual. Returns (x, new_cache or None)."""
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
    return (vision_embeds @ params["vision_proj"]).to(params["vision_proj"].dtype)


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
            kc = torch.einsum("bpd,dhk->bphk", vision_stream, pc["wk"])
            vc = torch.einsum("bpd,dhk->bphk", vision_stream, pc["wv"])
            x, aux, _ = block(pc, x, ext_kv=(kc, vc))
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
def _embed_batch(params, batch, cfg: ModelConfig):
    """(x (B,S,d) in the working dtype, the projected vision stream or
    None): audio reads precomputed frame embeddings, vlm also projects
    ``batch["vision_embeds"]`` (the stub frontends)."""
    _check_family(cfg)
    if cfg.family == "audio":
        x = batch["frames"].to(cfg.param_dtype)
    else:
        x = params["embed"][batch["tokens"].long()]
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
        ce = _vocab_ce(x, params["lm_head"], batch["labels"], cfg).mean()
    loss = ce + 0.01 * aux
    return loss, {"ce": ce, "aux": aux}


def prefill(params: Params, batch, cfg: ModelConfig):
    """Forward pass that also returns the populated cache + last logits.

    batch: {"tokens": (B,S) int} ({"frames": (B,S,d)} for audio; vlm adds
    {"vision_embeds": (B,P,vision_dim)}).  Returns (logits (B,V) f32, or
    (B,n_codebooks,V) for audio, cache)."""
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
    Returns (logits as ``prefill``'s, new_cache)."""
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
    on ``device`` (``None``: the card)."""
    _check_family(cfg)
    dev = resolve_device(device)
    kv = _kv_heads_alloc(cfg)
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
