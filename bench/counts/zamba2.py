"""Work counts of the Zamba2 training cell, from the configuration's
published sizes alone (Hugging Face names), never from what a kernel
happens to do: the train step's FLOPs, the flash-attention launches' at
the attention's head dim (``attention_head_dim``, 224: ``work.py``'s
``hidden_size / num_attention_heads`` is half of it here), and the SSD
launches' bound.

The SSD bound of one launch (one B/C group: b sequences, T positions, H
heads of P, state N, chunks of l) is max(FLOPs at the card's bf16 rate,
bytes at its memory rate): the FLOPs are the chunked algorithm's products
— C·Bᵀ once per group (its causal half), (C·Bᵀ ∘ L)·(dt x) per head (the
causal half), Bᵀ·x for each chunk's state and C·h for the state's output
per head — and the backward twice those (two products of the same size
per product); the bytes are the inputs read once and the outputs written
once at their dtypes (x, B, C bf16; dt, A f32; y and the final state f32;
the backward reads dy f32 and writes dx, dB, dC bf16 and ddt, dA f32),
the scratch not counted.  The rate is the fastest the card offers, so no
product precision a kernel picks can read over 100 %.
"""
from __future__ import annotations

from typing import Any, Dict

from bench.counts.work import PEAKS, fa_pairs

BF16, F32 = 2, 4


def _layer_types(c: Dict[str, Any]):
    return c["layers_block_type"][:c["num_hidden_layers"]]


def mixer_params(c: Dict[str, Any]) -> int:
    """Parameters of one Mamba2 mixer that enter a product: the z, xBC and
    dt in-projections and the out-projection (the depthwise conv, the SSD
    and the norms are elementwise or counted apart)."""
    d = c["hidden_size"]
    di = c["mamba_expand"] * d
    conv = di + 2 * c["mamba_ngroups"] * c["mamba_d_state"]
    return d * (di + conv + c["n_mamba_heads"]) + di * d


def shared_use_params(c: Dict[str, Any]) -> int:
    """Parameters that enter a product at one hybrid layer: the memory
    block's q, k, v (over 2·hidden) and o, its gate, up and down, the
    layer's adapter (hidden → rank → 2·ffn) and its linear."""
    d, ff, r = c["hidden_size"], c["intermediate_size"], c["adapter_rank"]
    dh, h, kv = c["attention_head_dim"], c["num_attention_heads"], c["num_key_value_heads"]
    attn = 2 * d * dh * (h + 2 * kv) + h * dh * d
    return attn + 3 * d * ff + r * (d + 2 * ff) + d * d


def matmul_params(c: Dict[str, Any]) -> int:
    """Per token: every mixer, each memory block at each use, the tied head
    once; the embedding lookup is no product."""
    types = _layer_types(c)
    return (len(types) * mixer_params(c) + types.count("hybrid") * shared_use_params(c)
            + c["vocab_size"] * c["hidden_size"])


def fa_fwd_flops(c: Dict[str, Any], B: int, S: int) -> float:
    """One causal flash-attention forward launch at the attention's head
    dim: 2 products of 2·D FLOPs per unmasked pair, per (sequence, head)."""
    D = c["attention_head_dim"]
    return 2 * 2 * D * fa_pairs(S, S, True, None) * B * c["num_attention_heads"]


def fa_bwd_flops(c: Dict[str, Any], B: int, S: int) -> float:
    """One flash-attention backward launch: 5 products of 2·D FLOPs per pair."""
    return fa_fwd_flops(c, B, S) * 5 / 2


def train_flops(c: Dict[str, Any], B: int, S: int) -> float:
    """FLOPs of one train step at the bf16 rate: 6 x ``matmul_params`` x
    tokens, plus each hybrid layer's attention forward (2) and backward (5)
    products per causal pair; the SSD's products and the remat recompute
    not counted."""
    n_attn = _layer_types(c).count("hybrid")
    return (6 * matmul_params(c) * B * S
            + (fa_fwd_flops(c, B, S) + fa_bwd_flops(c, B, S)) * n_attn)


def ssd_shape(c: Dict[str, Any], B: int, S: int) -> Dict[str, int]:
    """(b, T, H, P, N, l) of one SSD launch: one B/C group's heads."""
    d = c["hidden_size"]
    H = c["n_mamba_heads"] // c["mamba_ngroups"]
    assert H * c["mamba_headdim"] * c["mamba_ngroups"] == c["mamba_expand"] * d
    return dict(b=B, T=S, H=H, P=c["mamba_headdim"], N=c["mamba_d_state"],
                l=min(c["chunk_size"], S))


def ssd_fwd_flops(b: int, T: int, H: int, P: int, N: int, l: int) -> float:
    nc, tri = T // l, l * (l + 1) // 2
    return b * nc * (2 * tri * N + H * (2 * tri * P + 4 * l * N * P))


def ssd_fwd_bytes(b: int, T: int, H: int, P: int, N: int, l: int) -> float:
    reads = b * T * (H * P * BF16 + H * F32 + 2 * N * BF16) + H * F32
    writes = b * T * H * P * F32 + b * H * P * N * F32
    return reads + writes


def ssd_bwd_bytes(b: int, T: int, H: int, P: int, N: int, l: int) -> float:
    reads = b * T * (H * P * BF16 + H * F32 + 2 * N * BF16 + H * P * F32) + H * F32
    writes = b * T * (H * P * BF16 + H * F32 + 2 * N * BF16) + H * F32
    return reads + writes


def ssd_fwd_bound_s(c: Dict[str, Any], B: int, S: int) -> float:
    """Seconds one SSD forward launch needs at least on the card."""
    z = ssd_shape(c, B, S)
    return max(ssd_fwd_flops(**z) / PEAKS["bf16_flops_per_s"],
               ssd_fwd_bytes(**z) / PEAKS["hbm_bytes_per_s"])


def ssd_bwd_bound_s(c: Dict[str, Any], B: int, S: int) -> float:
    """Seconds one SSD backward launch needs at least on the card."""
    z = ssd_shape(c, B, S)
    return max(2 * ssd_fwd_flops(**z) / PEAKS["bf16_flops_per_s"],
               ssd_bwd_bytes(**z) / PEAKS["hbm_bytes_per_s"])
