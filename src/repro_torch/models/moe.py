"""Mixture-of-Experts layer: the farm skeleton at device level.

Counterpart of ``repro.models.moe``.  Token→expert routing is the paper's
farm: the router is the Emitter, the experts are the Workers, and the
weighted recombination is the Collector (the (token, slot) pair is the
tag).  The port runs on one device, where the reference's ``moe_apply``
with ``axis_name=None`` computes ``_moe_dense``: every routed copy is
kept and none is dropped by a capacity.  Two forms compute that function:

  * ``_moe_grouped`` (backends ``local_gather`` and the default): a
    dropless grouped dispatch.  The (token, slot) copies are sorted by
    expert id, gathered into contiguous rows, each expert runs one SwiGLU
    on its rows, and ``gate × out`` is scatter-added in f32.  Expert FLOPs
    are the routed ones, k/E of the dense form's.
  * ``_moe_dense`` (backend ``dense``): every expert on every token, one
    combine weighted by the routing; the test oracle.

The reference's mesh backends (``a2a``, ``ring`` and ``local_gather`` over
a model axis) wait for multi-GPU: a mesh axis or one of those backends by
name raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import dense_init

__all__ = ["moe_apply", "moe_init", "router_aux_loss", "expert_shard_kind"]

_MESH_BACKENDS = ("a2a", "ring")
_LATER = "the MoE mesh backends come with multi-GPU (ROADMAP §1 item 11)"


def expert_shard_kind(n_experts: int, model_axis_size: int) -> str:
    """'ep' (experts over model) or 'tp' (d_ff over model)."""
    return "ep" if n_experts % model_axis_size == 0 else "tp"


def moe_init(gen: Optional[torch.Generator], cfg: ModelConfig):
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.param_dtype
    params = {
        "router": dense_init(gen, (d, E), d, torch.float32),
        "w_gate": dense_init(gen, (E, d, f), d, dt),
        "w_up": dense_init(gen, (E, d, f), d, dt),
        "w_down": dense_init(gen, (E, f, d), f, dt),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        params["shared"] = {
            "w_gate": dense_init(gen, (d, fs), d, dt),
            "w_up": dense_init(gen, (d, fs), d, dt),
            "w_down": dense_init(gen, (fs, d), fs, dt),
        }
    return params


def _route(tokens: torch.Tensor, router_w: torch.Tensor, top_k: int):
    """Returns (gate_weights (Tk,k), expert_ids (Tk,k), probs (Tk,E)), in
    f32; the top-k logits are renormalised over k."""
    logits = tokens.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    top_logits, ids = torch.topk(logits, top_k, dim=-1)
    gates = torch.softmax(top_logits, dim=-1)
    return gates, ids, probs


def router_aux_loss(probs: torch.Tensor, ids: torch.Tensor,
                    n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing loss: E * Σ_e f_e · p̄_e."""
    hot = F.one_hot(ids[..., 0], n_experts).float()
    return n_experts * torch.sum(hot.mean(dim=0) * probs.mean(dim=0))


def _expert_ffn(rows: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                wd: torch.Tensor) -> torch.Tensor:
    """One expert's SwiGLU on its (n, d) rows."""
    return (F.silu(rows @ wg) * (rows @ wu)) @ wd


def _shared_ffn(x: torch.Tensor, shared) -> torch.Tensor:
    return _expert_ffn(x, shared["w_gate"], shared["w_up"], shared["w_down"])


def _moe_grouped(tokens, params, gates, ids, cfg: ModelConfig) -> torch.Tensor:
    """Dropless grouped dispatch: (Tk, d) tokens → (Tk, d) f32."""
    tk, d = tokens.shape
    k = ids.shape[1]
    flat_ids = ids.reshape(-1)
    order = torch.argsort(flat_ids, stable=True)   # copies grouped by expert
    src = order // k                               # each copy's token
    rows = tokens[src]
    # One host read per layer: the expert loop needs each group's length.
    counts = torch.bincount(flat_ids, minlength=cfg.n_experts).tolist()
    out_rows = torch.empty_like(rows)
    start = 0
    for e, n in enumerate(counts):
        if n:
            out_rows[start:start + n] = _expert_ffn(
                rows[start:start + n], params["w_gate"][e], params["w_up"][e],
                params["w_down"][e])
            start += n
    contrib = out_rows.float() * gates.reshape(-1)[order][:, None]
    return torch.zeros((tk, d), dtype=torch.float32,
                       device=tokens.device).index_add_(0, src, contrib)


def _moe_dense(tokens, params, gates, ids, cfg: ModelConfig) -> torch.Tensor:
    """Oracle: run every expert on every token, combine by routing weights."""
    g = torch.einsum("td,edf->tef", tokens, params["w_gate"])
    u = torch.einsum("td,edf->tef", tokens, params["w_up"])
    h = torch.einsum("tef,efd->ted", F.silu(g) * u, params["w_down"])
    weight = torch.zeros((tokens.shape[0], cfg.n_experts), dtype=torch.float32,
                         device=tokens.device)
    weight.scatter_add_(1, ids, gates)
    return torch.einsum("ted,te->td", h.float(), weight)


def moe_apply(x: torch.Tensor, params, cfg: ModelConfig, *,
              axis_name: Optional[str] = None,
              backend: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the MoE block to x (B, S, d) on one device.

    Returns (out in x's dtype, aux_loss f32 scalar): the reference's
    ``moe_apply(..., axis_name=None)``.  ``backend`` defaults to
    ``cfg.moe_backend``; ``local_gather`` takes the grouped dispatch,
    ``dense`` the oracle."""
    backend = backend or cfg.moe_backend
    if axis_name is not None or backend in _MESH_BACKENDS:
        raise NotImplementedError(
            f"moe_apply over a mesh (axis_name={axis_name!r}, backend="
            f"{backend!r}): {_LATER}")
    if backend not in ("local_gather", "dense"):
        raise ValueError(f"unknown moe backend {backend!r}")
    B, S, d = x.shape
    tokens = x.reshape(-1, d)
    gates, ids, probs = _route(tokens, params["router"], cfg.top_k)
    aux = router_aux_loss(probs, ids, cfg.n_experts)
    combine = _moe_dense if backend == "dense" else _moe_grouped
    out = combine(tokens, params, gates, ids, cfg)
    if "shared" in params:
        out = out + _shared_ffn(tokens, params["shared"]).float()
    return out.to(x.dtype).reshape(B, S, d), aux
