"""Mixture-of-Experts layer: the farm skeleton at device level.

Counterpart of ``repro.models.moe``.  Token→expert routing is the paper's
farm: the router is the Emitter, the experts are the Workers, and the
weighted recombination is the Collector (the (token, slot) pair is the
tag).  On one device (``axis_name=None``) the reference's ``moe_apply``
computes ``_moe_dense``: every routed copy is kept and none is dropped by
a capacity.  Two forms compute that function:

  * ``_moe_grouped`` (backends ``local_gather`` and the default): a
    dropless grouped dispatch.  The (token, slot) copies are sorted by
    expert id, gathered into contiguous rows, each expert runs one SwiGLU
    on its rows, and ``gate × out`` is scatter-added in f32.  Expert FLOPs
    are the routed ones, k/E of the dense form's.
  * ``_moe_dense`` (backend ``dense``): every expert on every token, one
    combine weighted by the routing; the test oracle.

Over a model :class:`~repro_torch.core.ranks.Group` (``axis_name``, inside
a rank job; the activations are replicated over it) the reference's mesh
backends run, with its per-rank static capacities, so tokens past a
capacity drop as they do there:

  * ``local_gather``: each rank gathers the copies addressed to its own
    experts into a (E_loc, C, d) buffer, computes, and combines; one sum
    over the group (which the tensor-parallel layout needs anyway) adds
    the ranks' parts.
  * ``a2a`` / ``ring``: each rank routes its 1/n slice of the tokens
    through ``dfarm.dispatch``/``combine`` over the group (one all-to-all,
    or n-1 ring hops), with the (local expert id + 1) as a tag column;
    the ``ep`` layout only.

The experts split over the group when E divides by its size (``ep``: E/n
experts a rank, whole d_ff), else d_ff does (``tp``: every expert, d_ff/n
a rank).  The tokens and the gates enter the region through
``enter_model``, so their gradient sums the ranks' parts.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core import dfarm
from ..core.ranks import Group
from ..parallel.context import enter_model, psum_compat
from .config import ModelConfig
from .layers import dense_init

__all__ = ["moe_apply", "moe_init", "router_aux_loss", "expert_shard_kind"]

_MESH_BACKENDS = ("a2a", "ring")
_BACKENDS = ("local_gather", "dense") + _MESH_BACKENDS


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
    if tokens.device.type == "meta":
        raise NotImplementedError(
            "the dropless one-device MoE dispatch reads each expert's token "
            "count on the host, which the meta device of the dry run "
            "(launch/dryrun.py) cannot give; under a mesh the MoE takes its "
            "capacity path")
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


def _dispatch_local(tokens, eid_flat, gate_flat, e_loc: int, capacity: int):
    """Gather the copies owned by this rank into (E_loc, C, d); return the
    buffer and its combine.  ``eid_flat`` holds each copy's local expert
    id (out of range: another rank's expert); a copy past its expert's
    ``capacity`` (in (token, slot) order) is dropped and combines to 0."""
    L, d = eid_flat.shape[0], tokens.shape[1]
    dev = tokens.device
    onehot = (eid_flat[:, None] == torch.arange(e_loc, device=dev)).long()
    pos = ((onehot.cumsum(dim=0) - onehot) * onehot).sum(dim=1)  # rank in expert
    valid = (eid_flat >= 0) & (eid_flat < e_loc) & (pos < capacity)
    src = torch.arange(tokens.shape[0], device=dev).repeat_interleave(
        L // tokens.shape[0])
    # every copy is written, a dropped one into a spare slot past the
    # capacity that is cut off after: no index depends on the data's
    # count of valid copies (the meta device of the dry run has none)
    buf = tokens.new_zeros((e_loc, capacity + 1, d)).index_put(
        (torch.where(valid, eid_flat, 0), torch.where(valid, pos, capacity)),
        tokens[src])[:, :capacity]

    def combine(out_buf):
        got = out_buf[eid_flat.clamp(0, e_loc - 1), pos.clamp(0, capacity - 1)]
        got = torch.where(valid[:, None], got,
                          torch.zeros((), dtype=got.dtype, device=dev))
        return got.float() * gate_flat[:, None]

    return buf, combine


def _experts_batched(buf, wg, wu, wd) -> torch.Tensor:
    """(E_loc, C, d) -> (E_loc, C, d): every local expert's SwiGLU on its
    capacity buffer."""
    g = torch.einsum("ecd,edf->ecf", buf, wg)
    u = torch.einsum("ecd,edf->ecf", buf, wu)
    return torch.einsum("ecf,efd->ecd", F.silu(g) * u, wd)


def _wire(cfg: ModelConfig):
    return getattr(torch, cfg.moe_wire_dtype) if cfg.moe_wire_dtype else None


def _moe_mesh(x, tokens, params, gates, ids, cfg: ModelConfig, group: Group,
              backend: str) -> torch.Tensor:
    """The reference's mesh path over the model group: this rank's share
    of the block's output, summed over the group."""
    n, me = group.size, group.rank
    E, k, cf = cfg.n_experts, cfg.top_k, cfg.capacity_factor
    tk, d = tokens.shape
    e_loc = params["w_gate"].shape[0]          # the local shard's experts
    n_groups = E // e_loc
    first = ((me * n_groups) // n) * e_loc     # this rank's first expert
    tok_in = enter_model(tokens, group)
    gates_in = enter_model(gates, group)
    experts = (params["w_gate"], params["w_up"], params["w_down"])
    if backend == "local_gather":
        capacity = max(1, int(tk * k * cf / E + 0.999))
        buf, combine = _dispatch_local(tok_in, ids.reshape(-1) - first,
                                       gates_in.reshape(-1), e_loc, capacity)
        out = combine(_experts_batched(buf, *experts)).reshape(tk, k, d).sum(1)
    else:
        if n_groups != n:
            raise ValueError(f"the {backend} MoE dispatch needs the ep layout "
                             f"(n_experts {E} divisible by the model group's "
                             f"{n} ranks)")
        if tk % n:
            raise ValueError(f"{tk} tokens do not split over {n} model ranks")
        slc = tk // n
        mine = slice(me * slc, (me + 1) * slc)
        items = tok_in[mine].repeat_interleave(k, dim=0)       # (slc*k, d)
        flat_ids = ids[mine].reshape(-1)
        dest = (flat_ids // e_loc).to(torch.int32)
        # ship the (local expert id + 1) with the payload, so the worker
        # regroups without re-routing; 0 marks an empty slot
        tagged = torch.cat([items, (flat_ids % e_loc + 1).to(items.dtype)[:, None]],
                           dim=1)
        cap_dev = max(1, int(slc * k * cf / n + 0.999))
        recv, info = dfarm.dispatch(tagged, dest, group, cap_dev,
                                    backend=backend, wire_dtype=_wire(cfg))
        recv_flat = recv.reshape(-1, d + 1)
        recv_tok, recv_tag = recv_flat[:, :d], recv_flat[:, d]
        eid1 = torch.round(recv_tag.float()).long() - 1        # -1: empty
        cap2 = recv_flat.shape[0]
        cap_e = max(1, -(-cap2 // e_loc) * 2)   # per local expert (cf is in cap2)
        buf, combine = _dispatch_local(
            recv_tok, eid1, torch.ones((cap2,), dtype=torch.float32,
                                       device=x.device), e_loc, cap_e)
        back = combine(_experts_batched(buf, *experts)).to(x.dtype)
        processed = torch.cat([back, recv_tag[:, None].to(x.dtype)], dim=1)
        processed = processed.reshape(recv.shape[0], -1, d + 1)
        got = dfarm.combine(processed, info, group, backend=backend,
                            wire_dtype=_wire(cfg))[:, :d]      # (slc*k, d)
        my_out = (got.float().reshape(slc, k, d) * gates_in[mine][..., None]).sum(1)
        z = lambda rows: torch.zeros((rows, d), dtype=torch.float32,
                                     device=x.device)
        out = torch.cat([z(me * slc), my_out, z((n - me - 1) * slc)])
    if "shared" in params:
        out = out + _shared_ffn(tok_in, params["shared"]).float()
    # one sum adds disjoint expert contributions (ep) or partial d_ff
    # slices (tp), in the model dtype
    return psum_compat(out.to(x.dtype), group)


def moe_apply(x: torch.Tensor, params, cfg: ModelConfig, *,
              axis_name: Optional[Group] = None,
              backend: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the MoE block to x (B, S, d).

    Returns (out in x's dtype, aux_loss f32 scalar).  ``backend`` defaults
    to ``cfg.moe_backend``.  With ``axis_name=None``, one device: the
    reference's ``moe_apply(..., axis_name=None)``; ``local_gather`` takes
    the grouped dispatch, ``dense`` the oracle.  With ``axis_name`` the
    model :class:`~repro_torch.core.ranks.Group` (x replicated over it,
    ``params`` this rank's shard, the ``"dp"`` dims gathered), the mesh
    path of ``local_gather``, ``a2a`` or ``ring``."""
    backend = backend or cfg.moe_backend
    if backend not in _BACKENDS:
        raise ValueError(f"unknown moe backend {backend!r}")
    if axis_name is not None and not isinstance(axis_name, Group):
        raise ValueError(f"moe_apply over a mesh takes the model Group "
                         f"(repro_torch.core.ranks.Group, inside a rank "
                         f"job) as axis_name, got {axis_name!r}")
    if axis_name is None and backend in _MESH_BACKENDS:
        raise ValueError(f"the {backend} MoE backend exchanges tokens over "
                         f"the model Group: pass it as axis_name")
    if axis_name is not None and backend == "dense":
        raise ValueError("the dense MoE oracle runs on one device "
                         "(axis_name=None)")
    B, S, d = x.shape
    tokens = x.reshape(-1, d)
    gates, ids, probs = _route(tokens, params["router"], cfg.top_k)
    aux = router_aux_loss(probs, ids, cfg.n_experts)
    if axis_name is not None:
        out = _moe_mesh(x, tokens, params, gates, ids, cfg, axis_name, backend)
        return out.reshape(B, S, d), aux
    combine = _moe_dense if backend == "dense" else _moe_grouped
    out = combine(tokens, params, gates, ids, cfg)
    if "shared" in params:
        out = out + _shared_ffn(tokens, params["shared"]).float()
    return out.to(x.dtype).reshape(B, S, d), aux
