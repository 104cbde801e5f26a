"""Zamba2 (Zyphra's Mamba2 backbone with shared attention blocks) at its
published layer equations: the family ``zamba2``.

The port's ``hybrid`` family copies the JAX package's simplified Zamba2
(one shared block over ``d_model``, a SwiGLU MLP, no adapters, one B/C
group) and stays as that package's twin.  This family follows the
published model (Hugging Face ``transformers``' ``modeling_zamba2.py``,
Zamba2-7B's ``config.json``), with ``e`` the token embedding and ``x_l``
the residual stream:

* Mamba layer: ``x_{l+1} = x_l + Mamba_l(RMSNorm(x_l))``.
* Hybrid layer (``layer_types[l] == "hybrid"``; its hybrid index ``i``
  picks memory block ``b = i mod n_mem_blocks``):
  ``s = RMSNorm(cat(x_l, e))`` over 2·d; ``a = W_o,b · Attn(RoPE(W_q,b s),
  RoPE(W_k,b s), W_v,b s)``, causal, heads of ``head_dim`` (224), scale
  (head_dim / 2)^-0.5, RoPE over the whole head; ``m = W_down,b ·
  (gelu(g) ⊙ u)`` with ``[g, u] = (W_gu,b + A_i B_i) · RMSNorm(a)`` (the
  layer's own LoRA adapter of rank ``adapter_rank``; no residual inside
  the block); ``T_l = W_lin,i · m``; then
  ``x_{l+1} = x_l + Mamba_l(RMSNorm(x_l + T_l))``.
* ``Mamba_l`` (Mamba2): in-projections to z (d_inner), xBC (d_inner +
  2·G·N) and dt (H); a causal depthwise conv of width ``ssm_conv`` with
  bias, then SiLU; the SSD over H heads of P, state N, G groups of B/C
  (head h reads group h // (H / G)), the ``D`` skip; ``y ⊙ silu(z)``, an
  RMSNorm over each group of d_inner / G channels (these three are
  ``kernels.gated_norm.gated_rmsnorm``), the out-projection.
* The final RMSNorm and an output head tied to the embedding.

On the card the shared attention runs the flash-attention kernels at
D = 224 and every mixer the SSD kernels, one ``ssd_scan`` call per B/C
group (the kernels take one group; the heads of a group are contiguous,
so this is the same arithmetic), then the gated-norm kernel on the SSD's
output, forward and backward.  With ``cfg.remat`` each Mamba layer and
each shared-block application is recomputed in the backward
(``torch.utils.checkpoint``): the stash is each layer's input and each
hybrid layer's ``T_l``.  Profiler ranges ``train.mamba`` (each mixer,
in_proj through out_proj) and ``train.shared`` (each shared-block
application: concat, attention, MLP with adapter, linear) cover their
forward, the remat recompute and, while a profiler runs, the backward.

Training only: ``prefill`` and ``decode_step`` wait for the serving cell
(``zamba2-serve-chat``), which needs two kinds of cache; the family runs
on one device (no sharding-token trees).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.gated_norm import gated_rmsnorm
from .attention import attention
from .config import ModelConfig
from .layers import apply_rope, dense_init, embed_init, init_device, rms_norm
from .model import _layers, _maybe_remat, _span, _stacked
from .ssm import _causal_conv, ssd_chunked

__all__ = ["Zamba2Config", "SERVING_CELL", "init_params", "forward_hidden",
           "param_count", "grouped_ssd"]

SERVING_CELL = "zamba2-serve-chat"


@dataclass(frozen=True)
class Zamba2Config(ModelConfig):
    """``ModelConfig`` with the published Zamba2 keys it lacks:
    ``layer_types`` (``layers_block_type``, "mamba" or "hybrid", at least
    ``n_layers`` long), ``ssm_groups`` (``mamba_ngroups``),
    ``n_mem_blocks`` (``num_mem_blocks``) and ``adapter_rank``.  The
    attention's input is 2·d_model wide; ``head_dim`` is
    ``attention_head_dim``."""
    layer_types: Tuple[str, ...] = ()
    ssm_groups: int = 1
    n_mem_blocks: int = 2
    adapter_rank: int = 128

    def layer_kinds(self) -> Tuple[str, ...]:
        if len(self.layer_types) < self.n_layers:
            raise ValueError(f"{self.name}: {len(self.layer_types)} layer types "
                             f"for {self.n_layers} layers")
        return tuple(self.layer_types[:self.n_layers])

    @property
    def n_hybrid(self) -> int:
        return sum(k == "hybrid" for k in self.layer_kinds())

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.ssm_groups * self.ssm_state

    def smoke(self) -> "Zamba2Config":
        """12 layers of the published pattern (its first two hybrid
        layers, so both memory blocks), at CPU widths: d 64, 4 heads of 32
        over the 128-wide concatenated input, 8 Mamba heads of 16 in 2 B/C
        groups, state 16, chunk 8, adapter rank 8."""
        return self.replace(
            name=self.name + "-smoke", n_layers=12, d_model=64, n_heads=4,
            n_kv_heads=4, head_dim=32, d_ff=128, vocab_size=256,
            ssm_state=16, ssm_headdim=16, ssm_chunk=8, ssm_groups=2,
            adapter_rank=8, remat=False)


def _check(cfg: Zamba2Config) -> None:
    if cfg.n_heads * cfg.hdim != 2 * cfg.d_model:
        raise ValueError(f"{cfg.name}: {cfg.n_heads} heads of {cfg.hdim} must "
                         f"span the 2 x {cfg.d_model} concatenated input")
    if cfg.ssm_heads % cfg.ssm_groups:
        raise ValueError(f"{cfg.name}: {cfg.ssm_heads} Mamba heads do not "
                         f"split into {cfg.ssm_groups} groups")
    if cfg.n_heads_padded != cfg.n_heads or cfg.vocab_padded != cfg.vocab_size:
        raise ValueError(f"{cfg.name}: the family pads neither heads nor vocab "
                         f"(pad_heads_to=0, pad_vocab_to=0)")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
def _mamba_init(gen: Optional[torch.Generator], cfg: Zamba2Config) -> Dict:
    d, di, hh, kk, c = (cfg.d_model, cfg.d_inner, cfg.ssm_heads, cfg.ssm_conv,
                        cfg.conv_dim)
    dev, f32, dt = init_device(gen), torch.float32, cfg.param_dtype
    lo, hi = math.log(0.001), math.log(0.1)
    u = torch.rand((hh,), generator=gen, dtype=f32, device=dev)
    step = torch.exp(lo + u * (hi - lo))
    return {
        "norm": torch.ones((d,), dtype=f32, device=dev),
        "w_z": dense_init(gen, (d, di), d, dt),
        "w_xbc": dense_init(gen, (d, c), d, dt),
        "w_dt": dense_init(gen, (d, hh), d, dt),
        "dt_bias": torch.log(torch.expm1(step)),               # softplus inverse
        "A_log": torch.log(torch.arange(1, hh + 1, dtype=f32, device=dev)),
        "D": torch.ones((hh,), dtype=f32, device=dev),
        "conv_w": (torch.randn((kk, c), generator=gen, dtype=f32, device=dev)
                   * kk ** -0.5).to(dt),
        "conv_b": (torch.randn((c,), generator=gen, dtype=f32, device=dev)
                   * kk ** -0.5).to(dt),
        "gnorm": torch.ones((di,), dtype=f32, device=dev),
        "w_out": dense_init(gen, (di, d), di, dt),
    }


def _shared_init(gen: Optional[torch.Generator], cfg: Zamba2Config) -> Dict:
    d, h, kv, dh, ff = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hdim, cfg.d_ff
    dev, f32, dt = init_device(gen), torch.float32, cfg.param_dtype
    return {
        "norm_in": torch.ones((2 * d,), dtype=f32, device=dev),
        "wq": dense_init(gen, (2 * d, h, dh), 2 * d, dt),
        "wk": dense_init(gen, (2 * d, kv, dh), 2 * d, dt),
        "wv": dense_init(gen, (2 * d, kv, dh), 2 * d, dt),
        "wo": dense_init(gen, (h, dh, d), h * dh, dt),
        "norm_ff": torch.ones((d,), dtype=f32, device=dev),
        "w_gate": dense_init(gen, (d, ff), d, dt),
        "w_up": dense_init(gen, (d, ff), d, dt),
        "w_down": dense_init(gen, (ff, d), ff, dt),
    }


def _hybrid_init(gen: Optional[torch.Generator], cfg: Zamba2Config) -> Dict:
    d, r, ff, dt = cfg.d_model, cfg.adapter_rank, cfg.d_ff, cfg.param_dtype
    return {
        "lora_a": dense_init(gen, (d, r), d, dt),
        "lora_b": dense_init(gen, (r, 2 * ff), r, dt),
        "linear": dense_init(gen, (d, d), d, dt),
    }


def init_params(cfg: Zamba2Config, gen: Optional[torch.Generator]) -> Dict[str, Any]:
    """The family's tree, drawn in this order: the embedding, each Mamba
    layer, each memory block, each hybrid layer's adapter and linear (a
    stacked leaf filled one index at a time).  No ``lm_head``: the head is
    the embedding."""
    _check(cfg)
    return {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, cfg.param_dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                 device=init_device(gen)),
        "mamba": _stacked(lambda g: _mamba_init(g, cfg), gen, cfg.n_layers),
        "shared": _stacked(lambda g: _shared_init(g, cfg), gen, cfg.n_mem_blocks),
        "hybrid": _stacked(lambda g: _hybrid_init(g, cfg), gen, cfg.n_hybrid),
    }


def param_count(cfg: Zamba2Config) -> int:
    """Parameters of the family's tree (the tied head counted once)."""
    _check(cfg)
    shapes = {"mamba": _mamba_init(None, cfg), "shared": _shared_init(None, cfg),
              "hybrid": _hybrid_init(None, cfg)}
    lead = {"mamba": cfg.n_layers, "shared": cfg.n_mem_blocks,
            "hybrid": cfg.n_hybrid}
    total = cfg.vocab_size * cfg.d_model + cfg.d_model
    for k, tree in shapes.items():
        total += lead[k] * sum(t.numel() for t in tree.values())
    return total


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------
def grouped_ssd(x, dt, A, B, C, chunk: int,
                compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The SSD with G groups of B/C: x (b,T,H,P), dt (b,T,H), A (H,), B/C
    (b,T,G,N), head h reading group h // (H / G).  One ``ssd_chunked`` call
    (on the card the SSD kernels) per group's contiguous heads; y
    (b,T,H,P) f32."""
    g, per = B.shape[2], x.shape[2] // B.shape[2]
    ys = []
    for gi in range(g):
        hs = slice(gi * per, (gi + 1) * per)
        y, _ = ssd_chunked(x[:, :, hs].contiguous(), dt[:, :, hs].contiguous(),
                           A[hs].contiguous(), B[:, :, gi].contiguous(),
                           C[:, :, gi].contiguous(), chunk,
                           compute_dtype=compute_dtype)
        ys.append(y)
    return torch.cat(ys, dim=2)


def _mixer(u: torch.Tensor, p: Dict[str, torch.Tensor], cfg: Zamba2Config
           ) -> torch.Tensor:
    """Mamba2 with grouped B/C, u (B,T,d) → (B,T,d): in_proj to out_proj."""
    b, t, _ = u.shape
    di, n, hh, g, P = (cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                       cfg.ssm_groups, cfg.ssm_headdim)
    z = u @ p["w_z"]
    xbc, _ = _causal_conv(u @ p["w_xbc"], p["conv_w"])
    xbc = F.silu(xbc + p["conv_b"])
    x, Bm, Cm = torch.split(xbc, [di, g * n, g * n], dim=-1)
    dt = F.softplus((u @ p["w_dt"]).float() + p["dt_bias"])  # (B,T,H)
    A = -torch.exp(p["A_log"])
    xh = x.reshape(b, t, hh, P)
    y = grouped_ssd(xh, dt, A, Bm.reshape(b, t, g, n), Cm.reshape(b, t, g, n),
                    cfg.ssm_chunk, getattr(torch, cfg.ssm_compute_dtype))
    y = gated_rmsnorm(y, xh, z, p["D"], p["gnorm"], g, cfg.norm_eps)
    return y @ p["w_out"]


def _mamba_layer(p, x, t, cfg: Zamba2Config) -> torch.Tensor:
    """``x + Mamba(RMSNorm(x [+ T]))``: the residual skips ``T``."""
    u = rms_norm(x if t is None else x + t, p["norm"], cfg.norm_eps)
    return x + _span("train.mamba", _mixer, u, p, cfg)


def _shared(x, e, ps, ph, positions, cfg: Zamba2Config) -> torch.Tensor:
    """One application of memory block ``ps`` with hybrid layer ``ph``'s
    adapter and linear: ``T_l`` (B,S,d)."""
    s = rms_norm(torch.cat([x, e], dim=-1), ps["norm_in"], cfg.norm_eps)
    q = apply_rope(torch.einsum("bsd,dhk->bshk", s, ps["wq"]), positions,
                   cfg.rope_theta)
    k = apply_rope(torch.einsum("bsd,dhk->bshk", s, ps["wk"]), positions,
                   cfg.rope_theta)
    v = torch.einsum("bsd,dhk->bshk", s, ps["wv"])
    a = attention(q, k, v, causal=True, window=None, impl=cfg.attn_impl,
                  q_chunk=cfg.attn_q_chunk, kv_chunk=cfg.attn_kv_chunk,
                  scale=(cfg.hdim / 2) ** -0.5)
    a = torch.einsum("bshk,hkd->bsd", a.to(x.dtype), ps["wo"])
    h = rms_norm(a, ps["norm_ff"], cfg.norm_eps)
    lo = h @ ph["lora_a"]
    ff = cfg.d_ff
    gate = h @ ps["w_gate"] + lo @ ph["lora_b"][:, :ff]
    up = h @ ps["w_up"] + lo @ ph["lora_b"][:, ff:]
    m = (F.gelu(gate) * up) @ ps["w_down"]
    return m @ ph["linear"]


def forward_hidden(params, x: torch.Tensor, cfg: Zamba2Config, *,
                   mode: str = "train", positions=None) -> torch.Tensor:
    """x (B,S,d), the embedding ``e`` → the final-normed hidden states.
    ``mode`` "train" only (remat per ``cfg.remat``)."""
    if mode != "train":
        raise NotImplementedError(
            f"{cfg.name}: the zamba2 family trains only; prefill and decode "
            f"wait for the serving cell {SERVING_CELL}")
    _check(cfg)
    remat = _maybe_remat(cfg, mode)
    e = x
    mamba, shared = _layers(params["mamba"]), _layers(params["shared"])
    hybrid = _layers(params["hybrid"]) if cfg.n_hybrid else []
    i = 0
    for layer, kind in enumerate(cfg.layer_kinds()):
        t = None
        if kind == "hybrid":
            t = remat(_span, "train.shared", _shared, x, e,
                      shared[i % cfg.n_mem_blocks], hybrid[i], positions, cfg)
            i += 1
        x = remat(_mamba_layer, mamba[layer], x, t, cfg)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)
