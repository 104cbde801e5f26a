"""Unified decoder LM: the dense, SSM and hybrid families.

Counterpart of ``repro.models.model``.  One parameter tree — a dict with
the reference's keys, shapes and stacked leading axes — and one forward,
assembled from the block zoo according to ``cfg.layer_kinds()``:

  * dense  — phi3 & co: a stack of attention + SwiGLU blocks;
  * ssm    — mamba2: a stack of Mamba2 blocks;
  * hybrid — zamba2: groups of (attn_every-1) Mamba2 blocks + 1 attention
             block whose parameters are *shared* across groups.

The stacks run as Python loops over the leading axes (the reference's
``lax.scan``).  ``prefill`` is where the hand-written kernels run on the
card: every attention block of it goes through the flash-attention kernel
and every Mamba2 block through the SSD kernel.  ``decode_step`` is plain
PyTorch, as in the reference.  Caches are returned as new tensors; the
inputs are never written.

Left for later slices of the port: the ``moe``, ``vlm`` and ``audio``
families (ROADMAP §1 item 3), ``loss_fn`` (item 9, training) and the
sharding specs (item 10, multi-GPU); there is one device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..kernels.ops import resolve_device
from .attention import attention, decode_attention
from .config import ModelConfig
from .layers import (apply_rope, dense_init, embed_init, init_device,
                     rms_norm, swiglu)
from .ssm import init_ssm_cache, ssm_apply, ssm_decode, ssm_init

__all__ = ["init_params", "init_params_spec", "forward_hidden", "prefill", "decode_step",
           "init_cache", "segment_counts", "SUPPORTED_FAMILIES"]

Params = Dict[str, Any]
SUPPORTED_FAMILIES = ("dense", "ssm", "hybrid")
_LATER = {"moe": "ROADMAP §1 item 3 (moe.py; its a2a/ring backends with "
                 "multi-GPU, item 10)",
          "vlm": "ROADMAP §1 item 3 (the cross-attention family)",
          "audio": "ROADMAP §1 item 3 (EnCodec frames and codebook heads)"}


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
            f"{_LATER[cfg.family]}")
    if cfg.family not in SUPPORTED_FAMILIES:
        raise ValueError(cfg.family)


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
def _attn_block_init(gen: Optional[torch.Generator], cfg: ModelConfig) -> Params:
    d, hp, kv, dh = cfg.d_model, cfg.n_heads_padded, _kv_heads_alloc(cfg), cfg.hdim
    dev, f32, dt = init_device(gen), torch.float32, cfg.param_dtype
    p = {
        "norm1": torch.ones((d,), dtype=f32, device=dev),
        "wq": dense_init(gen, (d, hp, dh), d, dt),
        "wk": dense_init(gen, (d, kv, dh), d, dt),
        "wv": dense_init(gen, (d, kv, dh), d, dt),
        "wo": dense_init(gen, (hp, dh, d), hp * dh, dt),
    }
    if cfg.d_ff:
        p["norm2"] = torch.ones((d,), dtype=f32, device=dev)
        p["mlp"] = {
            "w_gate": dense_init(gen, (d, cfg.d_ff), d, dt),
            "w_up": dense_init(gen, (d, cfg.d_ff), d, dt),
            "w_down": dense_init(gen, (cfg.d_ff, d), cfg.d_ff, dt),
        }
    return p


def _stack(trees):
    """A list of equal trees → one tree of leaves stacked on a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree, *idx):
    """The tree's slice at leading indices ``idx`` (views, no copy)."""
    if isinstance(tree, dict):
        return {k: _index(v, *idx) for k, v in tree.items()}
    return tree[idx]


def _build_params(cfg: ModelConfig, gen: Optional[torch.Generator]) -> Params:
    segs = segment_counts(cfg)
    params: Params = {
        "embed": embed_init(gen, cfg.vocab_padded, cfg.d_model, cfg.param_dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                 device=init_device(gen)),
        "lm_head": embed_init(gen, cfg.vocab_padded, cfg.d_model, cfg.param_dtype),
    }
    if cfg.family == "hybrid":
        g, inner = segs["groups"], segs["ssm_per_group"]
        params["ssm"] = _stack([_stack([ssm_init(gen, cfg) for _ in range(inner)])
                                for _ in range(g)])
        params["shared_attn"] = _attn_block_init(gen, cfg)   # ONE block, reused
    elif cfg.family == "ssm":
        params["blocks"] = _stack([ssm_init(gen, cfg) for _ in range(segs["blocks"])])
    else:
        params["blocks"] = _stack([_attn_block_init(gen, cfg)
                                   for _ in range(segs["blocks"])])
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

    def spec(tree):
        if isinstance(tree, dict):
            return {k: spec(v) for k, v in tree.items()}
        return tuple(tree.shape), tree.dtype
    return spec(_build_params(cfg, None))


# ==========================================================================
# blocks
# ==========================================================================
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
               kv_cache=None, cache_len=None, rolling=False, start_pos=None):
    """Shared attention path. Returns (delta, new_kv_cache or None)."""
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"])
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if mode == "decode":
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
    else:
        attn = attention(q, k, v, causal=True, window=cfg.sliding_window,
                         impl=cfg.attn_impl, q_chunk=cfg.attn_q_chunk,
                         kv_chunk=cfg.attn_kv_chunk, causal_skip=cfg.causal_skip)
        new_cache = (k, v) if mode == "prefill" else None
    mask = _head_mask(cfg, x.device)
    if mask is not None:
        attn = attn * mask[None, None, :, None]
    out = torch.einsum("bshk,hkd->bsd", attn.to(x.dtype), p["wo"])
    return out, new_cache


def _ffn_part(p, x, cfg: ModelConfig):
    """MLP sub-block (with pre-norm + residual)."""
    if "mlp" in p:
        h = rms_norm(x, p["norm2"], cfg.norm_eps)
        m = p["mlp"]
        return x + swiglu(h, m["w_gate"], m["w_up"], m["w_down"])
    return x


def _attn_block(p, x, cfg, *, positions, mode, kv_cache=None, cache_len=None,
                rolling=False, start_pos=None):
    delta, new_cache = _attn_core(p, x, cfg, positions=positions, mode=mode,
                                  kv_cache=kv_cache, cache_len=cache_len,
                                  rolling=rolling, start_pos=start_pos)
    return _ffn_part(p, x + delta, cfg), new_cache


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
def forward_hidden(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                   mode: str = "train", positions=None, cache=None,
                   cache_len=None, start_pos=None):
    """Run all blocks. x: (B,S,d) embeddings. Returns (x, new_cache)."""
    _check_family(cfg)
    rolling = cfg.sliding_window is not None and mode == "decode"
    keep = mode in ("decode", "prefill")
    new_cache: Dict[str, Any] = {}

    if cfg.family == "dense":
        ks, vs = [], []
        for i in range(cfg.n_layers):
            kvc = (cache["k"][i], cache["v"][i]) if mode == "decode" else None
            x, nc = _attn_block(_index(params["blocks"], i), x, cfg,
                                positions=positions, mode=mode, kv_cache=kvc,
                                cache_len=cache_len, rolling=rolling,
                                start_pos=start_pos)
            if nc is not None:
                ks.append(nc[0])
                vs.append(nc[1])
        if keep:
            new_cache = {"k": torch.stack(ks), "v": torch.stack(vs)}

    elif cfg.family == "ssm":
        hs, convs = [], []
        for i in range(cfg.n_layers):
            c = {"h": cache["h"][i], "conv": cache["conv"][i]} \
                if mode == "decode" else None
            x, nc = _ssm_block(_index(params["blocks"], i), x, cfg, mode, c)
            if nc is not None:
                hs.append(nc["h"])
                convs.append(nc["conv"])
        if keep:
            new_cache = {"h": torch.stack(hs), "conv": torch.stack(convs)}

    else:  # hybrid
        segs = segment_counts(cfg)
        shared_p = params["shared_attn"]
        clen = cache_len if cache_len is not None else 0
        hs, convs, ks, vs = [], [], [], []
        for gi in range(segs["groups"]):
            g_h, g_conv = [], []
            for ii in range(segs["ssm_per_group"]):
                c = {"h": cache["h"][gi, ii], "conv": cache["conv"][gi, ii]} \
                    if mode == "decode" else None
                x, nc = _ssm_block(_index(params["ssm"], gi, ii), x, cfg, mode, c)
                if nc is not None:
                    g_h.append(nc["h"])
                    g_conv.append(nc["conv"])
            kvc = (cache["k"][gi], cache["v"][gi]) if mode == "decode" else None
            x, nc = _attn_block(shared_p, x, cfg, positions=positions,
                                mode=mode, kv_cache=kvc, cache_len=clen,
                                start_pos=start_pos)
            if keep:
                hs.append(torch.stack(g_h))
                convs.append(torch.stack(g_conv))
                ks.append(nc[0])
                vs.append(nc[1])
        if keep:
            new_cache = {"h": torch.stack(hs), "conv": torch.stack(convs),
                         "k": torch.stack(ks), "v": torch.stack(vs)}

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, new_cache


# ==========================================================================
# entry points
# ==========================================================================
def _embed(params, batch, cfg: ModelConfig) -> torch.Tensor:
    _check_family(cfg)
    return params["embed"][batch["tokens"].long()]


def prefill(params: Params, batch, cfg: ModelConfig):
    """Forward pass that also returns the populated cache + last logits.

    batch: {"tokens": (B,S) int}.  Returns (logits (B,V) f32, cache)."""
    x = _embed(params, batch, cfg)
    B, S = x.shape[0], x.shape[1]
    positions = torch.arange(S, device=x.device).expand(B, S)
    x, new_cache = forward_hidden(params, x, cfg, mode="prefill",
                                  positions=positions)
    if cfg.sliding_window is not None and "k" in new_cache:
        w = min(cfg.sliding_window, S)
        new_cache["k"] = new_cache["k"][:, :, -w:]
        new_cache["v"] = new_cache["v"][:, :, -w:]
    return _logits_full(x[:, -1], params["lm_head"], cfg), new_cache


def decode_step(params: Params, batch, cache, cache_len: int, cfg: ModelConfig):
    """One token for every sequence in the batch.

    batch: {"tokens": (B,1)} and optionally {"start_pos": (B,)};
    cache_len: int — valid length before this step.
    Returns (logits (B,V) f32, new_cache)."""
    x = _embed(params, batch, cfg)
    cache_len = int(cache_len)
    positions = torch.full((x.shape[0], 1), cache_len, dtype=torch.long,
                           device=x.device)
    x, new_cache = forward_hidden(params, x, cfg, mode="decode",
                                  positions=positions, cache=cache,
                                  cache_len=cache_len,
                                  start_pos=batch.get("start_pos"))
    return _logits_full(x[:, -1], params["lm_head"], cfg), new_cache


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

    one = init_ssm_cache(batch, cfg, dt, dev)
    if cfg.family == "dense":
        n = segs["blocks"]
        return {"k": zeros(n, batch, T, kv, cfg.hdim),
                "v": zeros(n, batch, T, kv, cfg.hdim)}
    if cfg.family == "ssm":
        n = segs["blocks"]
        return {"h": zeros(n, *one["h"].shape, dtype=torch.float32),
                "conv": zeros(n, *one["conv"].shape)}
    g, inner = segs["groups"], segs["ssm_per_group"]
    return {"h": zeros(g, inner, *one["h"].shape, dtype=torch.float32),
            "conv": zeros(g, inner, *one["conv"].shape),
            "k": zeros(g, batch, T, kv, cfg.hdim),
            "v": zeros(g, batch, T, kv, cfg.hdim)}
