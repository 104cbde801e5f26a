"""Plain float32 reference of Zamba2's training steps, to judge a training
run: the published layer equations (``transformers``' ``modeling_zamba2.py``
with Zamba2-7B's ``config.json``) over the configuration's
``layers_block_type[:num_hidden_layers]``:

* a Mamba layer is ``x + Mamba(RMSNorm(x))``; a hybrid layer (its hybrid
  index i) feeds ``cat(x, e)`` (e the token embedding) to memory block
  ``i mod num_mem_blocks`` — RMSNorm over 2·hidden, causal attention of
  ``attention_head_dim`` heads at scale (head_dim / 2)^-0.5 with
  rotate-half RoPE over the whole head, RMSNorm, a gated-GeLU MLP whose
  gate and up projections add the layer's own rank-``adapter_rank``
  adapter, no residual inside the block — then the layer's own linear,
  giving T, and ``x + Mamba(RMSNorm(x + T))``;
* Mamba2: in-projections to z, xBC and dt; a causal depthwise conv of
  width ``mamba_d_conv`` with bias, SiLU; the SSD over ``n_mamba_heads``
  heads with ``mamba_ngroups`` groups of B/C (head h reads group
  h // (heads / groups)), evaluated chunk by chunk (``chunk_size``) in
  float32 (the log-decays' cumulative sums in float64, as the program's
  kernel keeps them): the intra-chunk products C·Bᵀ and (C·Bᵀ ∘ L)·(dt x),
  then a sequential pass of the chunk states; the D skip; y ∘ silu(z) normed
  over each group of d_inner / groups channels; the out-projection;
* the final RMSNorm, an output head tied to the embedding, the mean
  next-token cross entropy; AdamW as ``reference/phi3.py`` states it.

The weights are held as the configuration states them (bf16) and every
operation is computed in float32 with TF32 off.  It imports nothing of the
program.  ``init_params`` draws the initial weights from the seed with the
same generator calls in the same order as the port's initialiser (a frozen
copy).  To fit the card a step runs one sequence at a time; the forward
keeps each layer's input, and the backward recomputes one layer at a time
under autograd (a hybrid layer with its shared block).  Gradients of a
memory block sum over its uses, and the embedding's gradient takes the
head's, the lookup's and every hybrid layer's input e.

Departures: none from the equations.  As in the program, dt is not
clamped below (the model's fused path clamps nowhere; the eager path of
``modeling_zamba2.py`` clamps at ``time_step_min``), the separate
z / xBC / dt and gate / up matrices stand for the checkpoint's fused
in_proj and gate_up_proj (the same arithmetic), and weight decay falls on
every leaf of more than one dimension with the layers stacked (so only
``final_norm`` is undecayed), as the program's AdamW does.

``ssd_gap`` holds an SSD output (the program's) against this file's
chunked float32 SSD on the same inputs, and ``ssd_bwd_gaps`` the SSD's
input gradients for an output gradient dy against autograd through it.

Controls and planted faults: ``quant="fp8"`` passes the operands of every
projection, attention product and the head through float8 e4m3;
``ssd_dtype=torch.bfloat16`` computes the SSD's intra-chunk products in
bf16 (below the configuration's float32); ``rows=n`` takes the loss over
the first n sequences only; ``fault="block0"`` runs every hybrid layer on
memory block 0; ``fault="no_e"`` feeds the shared block ``cat(x, 0)``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from bench.reference.phi3 import _f32_products, _operand, _rms, adamw, lr_at  # noqa: F401

Params = Dict[str, torch.Tensor]
MAMBA_KEYS = ("norm", "w_z", "w_xbc", "w_dt", "dt_bias", "A_log", "D", "conv_w",
              "conv_b", "gnorm", "w_out")
SHARED_KEYS = ("norm_in", "wq", "wk", "wv", "wo", "norm_ff", "w_gate", "w_up",
               "w_down")
HYBRID_KEYS = ("lora_a", "lora_b", "linear")
GATED_NORM_EPS = 1e-5     # Zamba2RMSNormGated's, fixed in modeling_zamba2.py


def sizes(c: Dict[str, Any]) -> Dict[str, Any]:
    d = c["hidden_size"]
    di = c["mamba_expand"] * d
    types = list(c["layers_block_type"][:c["num_hidden_layers"]])
    return dict(d=d, di=di, H=c["n_mamba_heads"], P=c["mamba_headdim"],
                N=c["mamba_d_state"], G=c["mamba_ngroups"], K=c["mamba_d_conv"],
                C=di + 2 * c["mamba_ngroups"] * c["mamba_d_state"],
                ah=c["num_attention_heads"], akv=c["num_key_value_heads"],
                dh=c["attention_head_dim"], ff=c["intermediate_size"],
                V=c["vocab_size"], r=c["adapter_rank"], nb=c["num_mem_blocks"],
                types=types, nhyb=types.count("hybrid"), chunk=c["chunk_size"])


def init_params(c: Dict[str, Any], seed: int, device, dtype=torch.bfloat16) -> Params:
    """The initial weights drawn from ``seed`` by a generator on
    ``device``: embedding N(0, 0.02^2), projections N(0, 1/fan_in), conv
    weight and bias N(0, 1/width), dt_bias the softplus inverse of
    exp(U(log 0.001, log 0.1)), A_log log(1..H), norms and D 1; drawn the
    embedding, then layer by layer (u, w_z, w_xbc, w_dt, conv_w, conv_b,
    w_out), block by block (wq, wk, wv, wo, w_gate, w_up, w_down), hybrid
    layer by hybrid layer (lora_a, lora_b, linear)."""
    z = sizes(c)
    d, di, H, K, C = z["d"], z["di"], z["H"], z["K"], z["C"]
    gen = torch.Generator(device=device).manual_seed(seed)
    f32 = torch.float32

    def randn(shape):
        return torch.randn(shape, generator=gen, dtype=f32, device=device)

    def normal(shape, fan):
        return (randn(shape) * fan ** -0.5).to(dtype)

    p: Params = {"embed": (randn((z["V"], d)) * 0.02).to(dtype),
                 "final_norm": torch.ones(d, device=device)}
    lo, hi = math.log(0.001), math.log(0.1)
    for layer in range(len(z["types"])):
        pre = f"mamba.{layer}."
        u = torch.rand((H,), generator=gen, dtype=f32, device=device)
        step = torch.exp(lo + u * (hi - lo))
        p[pre + "norm"] = torch.ones(d, device=device)
        p[pre + "w_z"] = normal((d, di), d)
        p[pre + "w_xbc"] = normal((d, C), d)
        p[pre + "w_dt"] = normal((d, H), d)
        p[pre + "dt_bias"] = torch.log(torch.expm1(step))
        p[pre + "A_log"] = torch.log(torch.arange(1, H + 1, dtype=f32, device=device))
        p[pre + "D"] = torch.ones(H, device=device)
        p[pre + "conv_w"] = (randn((K, C)) * K ** -0.5).to(dtype)
        p[pre + "conv_b"] = (randn((C,)) * K ** -0.5).to(dtype)
        p[pre + "gnorm"] = torch.ones(di, device=device)
        p[pre + "w_out"] = normal((di, d), di)
    ah, akv, dh, ff = z["ah"], z["akv"], z["dh"], z["ff"]
    for b in range(z["nb"]):
        pre = f"shared.{b}."
        p[pre + "norm_in"] = torch.ones(2 * d, device=device)
        p[pre + "wq"] = normal((2 * d, ah, dh), 2 * d)
        p[pre + "wk"] = normal((2 * d, akv, dh), 2 * d)
        p[pre + "wv"] = normal((2 * d, akv, dh), 2 * d)
        p[pre + "wo"] = normal((ah, dh, d), ah * dh)
        p[pre + "norm_ff"] = torch.ones(d, device=device)
        p[pre + "w_gate"] = normal((d, ff), d)
        p[pre + "w_up"] = normal((d, ff), d)
        p[pre + "w_down"] = normal((ff, d), ff)
    for i in range(z["nhyb"]):
        pre = f"hybrid.{i}."
        p[pre + "lora_a"] = normal((d, z["r"]), d)
        p[pre + "lora_b"] = normal((z["r"], 2 * ff), z["r"])
        p[pre + "linear"] = normal((d, d), d)
    return p


def _rope(x, theta):
    """x (S, heads, dh); rotate-half at positions 0..S-1."""
    S, dh = x.shape[0], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                       device=x.device) / dh)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def ssd(x, dt, A, B, C, chunk: int, compute_dtype=torch.float32):
    """The SSD of one sequence, chunk by chunk: x (T,H,P), dt (T,H), A (H,),
    B/C (T,H,N) (each head's group) → y (T,H,P) f32.  ``compute_dtype``
    applies to the intra-chunk products only."""
    T, H, P = x.shape
    l = min(chunk, T)
    nc = T // l
    cd = compute_dtype
    xr, dtr = x.reshape(nc, l, H, P), dt.reshape(nc, l, H)
    Br, Cr = B.reshape(nc, l, H, -1), C.reshape(nc, l, H, -1)
    # the log-decays in float64: a chunk's cumulative sum reaches ~10^3 at
    # the published A and dt, where float32 differences of two sums lose
    # ~1e-4 of each decay; the decays themselves are float32
    cs = torch.cumsum((dtr * A).double(), dim=1)                 # (nc,l,H)
    seg = cs[:, :, None, :] - cs[:, None, :, :]                  # (nc,i,j,H)
    causal = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    L = torch.exp(torch.where(causal[None, :, :, None], seg, -torch.inf)).float()
    scores = torch.einsum("cihn,cjhn->cijh", Cr.to(cd), Br.to(cd)).float()
    gated = (scores * L).to(cd)
    xdt = (xr * dtr[..., None]).to(cd)
    y = torch.einsum("cijh,cjhp->cihp", gated, xdt).float()
    to_end = torch.exp(cs[:, -1:, :] - cs).float() * dtr         # (nc,l,H)
    states = torch.einsum("cjhn,cjh,cjhp->chpn", Br, to_end, xr)
    h = torch.zeros((H, P, Br.shape[-1]), dtype=torch.float32, device=x.device)
    offs = []
    for k in range(nc):
        offs.append(torch.einsum("ihn,hpn,ih->ihp", Cr[k], h, torch.exp(cs[k]).float()))
        h = h * torch.exp(cs[k, -1]).float()[:, None, None] + states[k]
    return (y + torch.stack(offs)).reshape(T, H, P)


def ssd_inputs(u, w, c, q8=lambda t: t):
    """The SSD's inputs in a Mamba2 mixer on one sequence, u (S, d) f32:
    (x (S,H,P), dt (S,H), A (H,), B and C (S,H,N) each head's group, z)."""
    z = sizes(c)
    S, di, H, P, N, G, K = u.shape[0], z["di"], z["H"], z["P"], z["N"], z["G"], z["K"]
    uq = q8(u)
    gate = uq @ q8(w["w_z"])
    xbc = uq @ q8(w["w_xbc"])
    pad = torch.cat([torch.zeros((K - 1, xbc.shape[1]), device=u.device), xbc])
    xbc = sum(pad[i:i + S] * w["conv_w"][i] for i in range(K)) + w["conv_b"]
    xbc = F.silu(xbc)
    x, B, C = torch.split(xbc, [di, G * N, G * N], dim=-1)
    dt = F.softplus(uq @ q8(w["w_dt"]) + w["dt_bias"])           # (S,H)
    A = -torch.exp(w["A_log"])
    per = H // G
    Bh = B.reshape(S, G, N).repeat_interleave(per, dim=1)        # (S,H,N)
    Ch = C.reshape(S, G, N).repeat_interleave(per, dim=1)
    return x.reshape(S, H, P), dt, A, Bh, Ch, gate


def mixer(u, w, c, q8, ssd_dtype=torch.float32):
    """Mamba2 on one sequence, u (S, d) f32 → (S, d)."""
    z = sizes(c)
    S, di, G = u.shape[0], z["di"], z["G"]
    xh, dt, A, Bh, Ch, gate = ssd_inputs(u, w, c, q8)
    y = ssd(xh, dt, A, Bh, Ch, c["chunk_size"], ssd_dtype) + xh * w["D"][:, None]
    y = y.reshape(S, G, di // G) * F.silu(gate).reshape(S, G, di // G)
    y = y * torch.rsqrt((y * y).mean(-1, keepdim=True) + GATED_NORM_EPS)
    return q8(y.reshape(S, di) * w["gnorm"]) @ q8(w["w_out"])


def shared_block(x, e, ws, wh, c, q8):
    """T of one hybrid layer: memory block ``ws`` with the layer's
    adapter and linear ``wh``, x and e (S, d) f32."""
    z = sizes(c)
    S, d, ah, akv, dh, ff = x.shape[0], z["d"], z["ah"], z["akv"], z["dh"], z["ff"]
    s = q8(_rms(torch.cat([x, e], dim=-1), ws["norm_in"], c["rms_norm_eps"]))
    q = _rope((s @ q8(ws["wq"].reshape(2 * d, ah * dh))).reshape(S, ah, dh), c["rope_theta"])
    k = _rope((s @ q8(ws["wk"].reshape(2 * d, akv * dh))).reshape(S, akv, dh), c["rope_theta"])
    v = (s @ q8(ws["wv"].reshape(2 * d, akv * dh))).reshape(S, akv, dh)
    rep = ah // akv
    q, k, v = (t.transpose(0, 1) for t in (q, k, v))             # (heads, S, dh)
    k, v = k.repeat_interleave(rep, 0), v.repeat_interleave(rep, 0)
    pos = torch.arange(S, device=x.device)
    seen = pos[None, :] <= pos[:, None]
    outs = []
    for r0 in range(0, S, 1024):                                 # query blocks
        sc = (q8(q[:, r0:r0 + 1024]) @ q8(k).transpose(1, 2)) * (dh / 2) ** -0.5
        a = torch.softmax(sc.masked_fill(~seen[r0:r0 + 1024], float("-inf")), dim=-1)
        outs.append(q8(a) @ q8(v))
    o = torch.cat(outs, dim=1).transpose(0, 1).reshape(S, ah * dh)
    a = q8(o) @ q8(ws["wo"].reshape(ah * dh, d))
    h = q8(_rms(a, ws["norm_ff"], c["rms_norm_eps"]))
    lo = q8(h @ q8(wh["lora_a"]))
    g = h @ q8(ws["w_gate"]) + lo @ q8(wh["lora_b"][:, :ff])
    u = h @ q8(ws["w_up"]) + lo @ q8(wh["lora_b"][:, ff:])
    m = q8(F.gelu(g) * u) @ q8(ws["w_down"])
    return q8(m) @ q8(wh["linear"])


def layer(x, e, wm, ws, wh, c, q8, ssd_dtype=torch.float32, fault=None):
    """One layer on one sequence: a Mamba layer (``ws`` None) or a hybrid
    one; x, e (S, d) f32."""
    t = None
    if ws is not None:
        t = shared_block(x, torch.zeros_like(e) if fault == "no_e" else e, ws, wh, c, q8)
    h = x if t is None else x + t
    return x + mixer(_rms(h, wm["norm"], c["rms_norm_eps"]), wm, c, q8, ssd_dtype)


def ssd_gap(x, dt, A, B, C, chunk: int, y, head_group: int) -> float:
    """Relative L2 gap of an SSD output ``y`` (b,T,H,P) against the chunked
    float32 SSD here on the same inputs: x (b,T,H,P), dt (b,T,H), A (H,),
    B/C (b,T,G,N), head h reading group h // ``head_group``."""
    num = den = 0.0
    with _f32_products():
        for i in range(x.shape[0]):
            Bh, Ch = (t[i].float().repeat_interleave(head_group, dim=1) for t in (B, C))
            want = ssd(x[i].float(), dt[i].float(), A.float(), Bh, Ch, chunk)
            num += float(((y[i].float() - want) ** 2).sum())
            den += float((want ** 2).sum())
    return math.sqrt(num / den)


SSD_INPUTS = ("x", "dt", "A", "B", "C")


def ssd_grads(x, dt, A, B, C, chunk: int, dy, head_group: int,
              compute_dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The gradients of the SSD's inputs for an output gradient ``dy``
    (b,T,H,P), by autograd through :func:`ssd` one sequence at a time
    (``compute_dtype`` for its intra-chunk products, which autograd then
    also takes for theirs): x (b,T,H,P), dt (b,T,H), A (H,), B/C (b,T,G,N),
    head h reading group h // ``head_group``; every gradient f32, dA summed
    over the sequences."""
    out: Dict[str, List[torch.Tensor]] = {n: [] for n in SSD_INPUTS}
    dA = torch.zeros(A.shape, dtype=torch.float32, device=A.device)
    with _f32_products(), torch.enable_grad():
        for i in range(x.shape[0]):
            leaves = [t.detach().float().requires_grad_()
                      for t in (x[i], dt[i], A, B[i], C[i])]
            Bh, Ch = (t.repeat_interleave(head_group, dim=1) for t in leaves[3:])
            y = ssd(leaves[0], leaves[1], leaves[2], Bh, Ch, chunk, compute_dtype)
            g = torch.autograd.grad(y, leaves, dy[i].float())
            for n, t in zip(SSD_INPUTS, g):
                if n == "A":
                    dA += t
                else:
                    out[n].append(t)
    grads = {n: torch.stack(v) for n, v in out.items() if v}
    grads["A"] = dA
    return grads


def ssd_bwd_gaps(x, dt, A, B, C, chunk: int, dy, grads: Dict[str, torch.Tensor],
                 head_group: int) -> Dict[str, float]:
    """Relative L2 gap of each of an SSD's input gradients ``grads`` (the
    program's, keyed by :data:`SSD_INPUTS`) against :func:`ssd_grads` in
    float32 on the same inputs and output gradient, each rounded to the
    dtype its gradient is stored in (bf16 for the program's dx, dB, dC):
    that storage rounds a sound result by ~1.7e-3 alone, and would hide
    the products' precision under it."""
    want = ssd_grads(x, dt, A, B, C, chunk, dy, head_group)
    return {n: float(torch.linalg.vector_norm(
        grads[n].float() - want[n].to(grads[n].dtype).float())
        / torch.linalg.vector_norm(want[n])) for n in SSD_INPUTS}


def _head_loss(x, norm, head, labels, c, q8):
    logits = q8(_rms(x, norm, c["rms_norm_eps"])) @ q8(head).T
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[:, None].long())[:, 0]).sum()


def loss_and_grads(p: Params, tokens: torch.Tensor, labels: torch.Tensor,
                   c: Dict[str, Any], quant: Optional[str] = None,
                   rows: Optional[int] = None, ssd_dtype=torch.float32,
                   fault: Optional[str] = None
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(mean cross entropy over the first ``rows`` sequences (all by
    default), f32 gradients of every leaf)."""
    q8 = _operand(quant)
    z = sizes(c)
    types = z["types"]
    block: List[Optional[int]] = []       # each layer's memory block, or None
    hyb: List[Optional[int]] = []         # each layer's hybrid index
    i = 0
    for kind in types:
        if kind == "hybrid":
            block.append(0 if fault == "block0" else i % z["nb"])
            hyb.append(i)
            i += 1
        else:
            block.append(None)
            hyb.append(None)
    B = tokens.shape[0] if rows is None else rows
    n_tok = B * tokens.shape[1]
    grads = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
             for k, v in p.items()}
    total = 0.0
    f32 = lambda t: t.to(torch.float32, copy=True)  # noqa: E731

    def weights(layer_no, need_grad):
        pick = lambda pre, keys: {k: (f32(p[pre + k]).requires_grad_()  # noqa: E731
                                      if need_grad else f32(p[pre + k])) for k in keys}
        wm = pick(f"mamba.{layer_no}.", MAMBA_KEYS)
        if block[layer_no] is None:
            return wm, None, None
        return (wm, pick(f"shared.{block[layer_no]}.", SHARED_KEYS),
                pick(f"hybrid.{hyb[layer_no]}.", HYBRID_KEYS))

    with _f32_products():
        for b in range(B):
            e = f32(p["embed"][tokens[b].long()])
            xs = [e]
            with torch.no_grad():
                for n in range(len(types)):
                    xs.append(layer(xs[-1], e, *weights(n, False), c, q8,
                                    ssd_dtype, fault))
            x = xs.pop().requires_grad_()
            norm = f32(p["final_norm"]).requires_grad_()
            head = f32(p["embed"]).requires_grad_()
            with torch.enable_grad():
                loss = _head_loss(x, norm, head, labels[b], c, q8)
                gx, gn, gh = torch.autograd.grad(loss / n_tok, (x, norm, head))
            total += float(loss.detach())
            grads["final_norm"] += gn
            grads["embed"] += gh
            del head, gh
            ge = torch.zeros_like(e)
            for n in reversed(range(len(types))):
                x = xs.pop().requires_grad_()
                wm, ws, wh = weights(n, True)
                ins = [x] + list(wm.values())
                names = [f"mamba.{n}.{k}" for k in wm]
                if ws is not None:
                    e_in = e.detach().requires_grad_()
                    ins += [e_in] + list(ws.values()) + list(wh.values())
                    names += ["e"] + [f"shared.{block[n]}.{k}" for k in ws] + \
                        [f"hybrid.{hyb[n]}.{k}" for k in wh]
                with torch.enable_grad():
                    out = layer(x, e_in if ws is not None else e, wm, ws, wh, c, q8,
                                ssd_dtype, fault)
                    gs = torch.autograd.grad(out, ins, gx, allow_unused=True)
                gx = gs[0]
                for name, g in zip(names, gs[1:]):
                    if g is None:
                        continue
                    if name == "e":
                        ge += g
                    else:
                        grads[name] += g
                del out, gs, wm, ws, wh, ins
            grads["embed"].index_add_(0, tokens[b].long(), gx + ge)
    return total / n_tok, grads

