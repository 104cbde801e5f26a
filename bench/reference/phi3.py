"""Plain float32 reference of a dense decoder's training steps, to judge
a training run: Phi-3-mini's architecture as the configuration states it
(RMSNorm, RoPE with rotate-half, causal multi-head attention in which a
position sees itself and the ``sliding_window`` - 1 before it, SwiGLU MLP,
untied output head, mean next-token cross entropy), AdamW with global-norm
clipping and a linear warm-up.

The weights are held as the configuration states them (bf16) and every
operation is computed in float32 with TF32 off.  It imports nothing of
the program.  ``init_params`` draws the initial weights from the seed with
the same generator calls in the same order as the port's initialiser (a
frozen copy), so that the reference starts where the program starts
without taking the program's weights.

To fit the card, a step runs one sequence at a time and, within it, the
backward one layer at a time: the forward keeps each layer's input, and
the backward recomputes that layer under autograd.  Gradients, moments
and weights are whole trees.  ``quant="fp8"`` passes every product's
operands through float8 e4m3 (per-tensor scale), the control; ``rows=n``
takes the loss over the first n sequences only, a fault.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch

Params = Dict[str, torch.Tensor]
LAYER_KEYS = ("norm1", "wq", "wk", "wv", "wo", "norm2", "w_gate", "w_up", "w_down")


def sizes(c: Dict[str, Any]) -> Dict[str, int]:
    d, H = c["hidden_size"], c["num_attention_heads"]
    return dict(d=d, H=H, Hkv=c["num_key_value_heads"], dh=d // H,
                ff=c["intermediate_size"], V=c["vocab_size"],
                L=c["num_hidden_layers"])


def init_params(c: Dict[str, Any], seed: int, device, dtype=torch.bfloat16) -> Params:
    """The initial weights drawn from ``seed`` by a generator on
    ``device``: embeddings N(0, 0.02^2), projections N(0, 1/fan_in), norm
    scales 1, drawn embed, lm_head, then layer by layer wq, wk, wv, wo,
    w_gate, w_up, w_down."""
    z = sizes(c)
    d, H, Hkv, dh, ff, V = z["d"], z["H"], z["Hkv"], z["dh"], z["ff"], z["V"]
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen, dtype=torch.float32,
                            device=device) * scale).to(dtype)

    p: Params = {"embed": normal((V, d), 0.02),
                 "final_norm": torch.ones(d, device=device),
                 "lm_head": normal((V, d), 0.02)}
    for i in range(z["L"]):
        pre = f"layers.{i}."
        p[pre + "norm1"] = torch.ones(d, device=device)
        p[pre + "wq"] = normal((d, H, dh), d ** -0.5)
        p[pre + "wk"] = normal((d, Hkv, dh), d ** -0.5)
        p[pre + "wv"] = normal((d, Hkv, dh), d ** -0.5)
        p[pre + "wo"] = normal((H, dh, d), (H * dh) ** -0.5)
        p[pre + "norm2"] = torch.ones(d, device=device)
        p[pre + "w_gate"] = normal((d, ff), d ** -0.5)
        p[pre + "w_up"] = normal((d, ff), d ** -0.5)
        p[pre + "w_down"] = normal((ff, d), ff ** -0.5)
    return p


class _STE(torch.autograd.Function):
    """x through float8 e4m3 at a per-tensor scale; the gradient passes."""

    @staticmethod
    def forward(ctx, x):
        s = x.abs().amax().clamp(min=1e-30) / 448.0
        return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s

    @staticmethod
    def backward(ctx, g):
        return g


def _operand(quant: Optional[str]) -> Callable[[torch.Tensor], torch.Tensor]:
    if quant is None:
        return lambda x: x
    if quant == "fp8":
        return _STE.apply
    raise ValueError(f"unknown quant {quant!r}")


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta):
    """x (S, heads, dh); rotate-half at positions 0..S-1."""
    S, dh = x.shape[0], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                       device=x.device) / dh)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def layer(x: torch.Tensor, w: Dict[str, torch.Tensor], c: Dict[str, Any],
          q8: Callable) -> torch.Tensor:
    """One decoder layer on one sequence, x (S, d) f32."""
    z = sizes(c)
    S, d, H, Hkv, dh = x.shape[0], z["d"], z["H"], z["Hkv"], z["dh"]
    h = q8(_rms(x, w["norm1"], c["rms_norm_eps"]))
    q = (h @ q8(w["wq"].reshape(d, H * dh))).reshape(S, H, dh)
    k = (h @ q8(w["wk"].reshape(d, Hkv * dh))).reshape(S, Hkv, dh)
    v = (h @ q8(w["wv"].reshape(d, Hkv * dh))).reshape(S, Hkv, dh)
    q, k = _rope(q, c["rope_theta"]), _rope(k, c["rope_theta"])
    rep = H // Hkv
    q, k, v = (t.transpose(0, 1) for t in (q, k, v))           # (heads, S, dh)
    k, v = k.repeat_interleave(rep, 0), v.repeat_interleave(rep, 0)
    s = (q8(q) @ q8(k).transpose(1, 2)) * dh ** -0.5
    pos = torch.arange(S, device=x.device)
    seen = pos[None, :] <= pos[:, None]                          # (query, key)
    if c.get("sliding_window"):
        seen &= pos[None, :] > pos[:, None] - c["sliding_window"]
    a = torch.softmax(s.masked_fill(~seen, float("-inf")), dim=-1)
    o = (q8(a) @ q8(v)).transpose(0, 1).reshape(S, H * dh)
    x = x + q8(o) @ q8(w["wo"].reshape(H * dh, d))
    h2 = q8(_rms(x, w["norm2"], c["rms_norm_eps"]))
    g, u = h2 @ q8(w["w_gate"]), h2 @ q8(w["w_up"])
    return x + q8(torch.nn.functional.silu(g) * u) @ q8(w["w_down"])


def _head_loss(x, norm, head, labels, c, q8):
    """Summed next-token cross entropy of one sequence."""
    logits = q8(_rms(x, norm, c["rms_norm_eps"])) @ q8(head).T
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[:, None].long())[:, 0]).sum()


@contextlib.contextmanager
def _f32_products() -> Iterator[None]:
    prev = torch.get_float32_matmul_precision()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)
        torch.backends.cudnn.allow_tf32 = tf32


def loss_and_grads(p: Params, tokens: torch.Tensor, labels: torch.Tensor,
                   c: Dict[str, Any], quant: Optional[str] = None,
                   rows: Optional[int] = None) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(mean cross entropy over the first ``rows`` sequences (all by
    default), f32 gradients of every leaf)."""
    q8 = _operand(quant)
    L = c["num_hidden_layers"]
    B = tokens.shape[0] if rows is None else rows
    n_tok = B * tokens.shape[1]
    grads = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
             for k, v in p.items()}
    total = 0.0
    f32 = lambda t: t.to(torch.float32, copy=True)  # noqa: E731
    with _f32_products():
        for b in range(B):
            xs = [f32(p["embed"][tokens[b].long()])]
            with torch.no_grad():
                for i in range(L):
                    w = {k: f32(p[f"layers.{i}.{k}"]) for k in LAYER_KEYS}
                    xs.append(layer(xs[-1], w, c, q8))
            x = xs.pop().requires_grad_()
            norm = f32(p["final_norm"]).requires_grad_()
            head = f32(p["lm_head"]).requires_grad_()
            with torch.enable_grad():
                loss = _head_loss(x, norm, head, labels[b], c, q8)
                gx, gn, gh = torch.autograd.grad(loss / n_tok, (x, norm, head))
            total += float(loss.detach())
            grads["final_norm"] += gn
            grads["lm_head"] += gh
            del head, gh
            for i in reversed(range(L)):
                x = xs.pop().requires_grad_()
                w = {k: f32(p[f"layers.{i}.{k}"]).requires_grad_() for k in LAYER_KEYS}
                with torch.enable_grad():
                    out = layer(x, w, c, q8)
                    gs = torch.autograd.grad(out, (x, *w.values()), gx)
                gx = gs[0]
                for k, g in zip(LAYER_KEYS, gs[1:]):
                    grads[f"layers.{i}.{k}"] += g
                del out, gs, w
            grads["embed"].index_add_(0, tokens[b].long(), gx)
    return total / n_tok, grads


def lr_at(step: int, o: Dict[str, Any]) -> float:
    """Linear warm-up to the peak, then a cosine decay to min_ratio."""
    if step < o["warmup_steps"]:
        return o["peak_lr"] * step / max(o["warmup_steps"], 1)
    frac = min(max((step - o["warmup_steps"]) / max(o["total_steps"] - o["warmup_steps"], 1), 0), 1)
    return o["peak_lr"] * (o["min_ratio"] + (1 - o["min_ratio"]) * 0.5 * (1 + math.cos(math.pi * frac)))


def adamw(p: Params, g: Dict[str, torch.Tensor], mu: Dict[str, torch.Tensor],
          nu: Dict[str, torch.Tensor], step: int, o: Dict[str, Any],
          stacked_decay: Dict[str, bool]) -> None:
    """One AdamW update in place, as the configuration states it: the
    gradients clipped to a global norm, the moments in f32, the update in
    f32 rounded to each weight's dtype, decoupled weight decay on the
    leaves named in ``stacked_decay``; ``step`` counts from 0."""
    gn = math.sqrt(sum(float((t * t).sum()) for t in g.values()))
    scale = min(o["max_grad_norm"] / max(gn, 1e-9), 1.0)
    lr = lr_at(step, o)
    t = step + 1
    c1, c2 = 1 - o["b1"] ** t, 1 - o["b2"] ** t
    for k in p:
        gk = g[k] * scale
        mu[k].mul_(o["b1"]).add_(gk * (1 - o["b1"]))
        nu[k].mul_(o["b2"]).add_(gk * gk * (1 - o["b2"]))
        d = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + o["eps"])
        wd = o["weight_decay"] if stacked_decay[k] else 0.0
        p32 = p[k].float()
        p[k].copy_(p32 - lr * (d + wd * p32))
