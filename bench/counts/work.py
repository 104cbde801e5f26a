"""Work counts, from the inputs' sizes alone: what a run's inputs need,
never what a kernel happens to do.  Frozen copies of the counts that
``chip_smoke.py`` has used since the port's kernels came up (``gcups``,
``fa_pairs``, ``train_flops``), with the parameter count worked out from
the configuration's published sizes instead of the program's
``param_count``, the embedding lookup left out of it and the attention
held to the configuration's window; and the peak rates of the card
(``peaks.json``).
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

PEAKS: Dict[str, Any] = json.loads(
    (Path(__file__).resolve().parent / "peaks.json").read_text())


def gcups(cells: float, seconds: float) -> float:
    """Giga cell updates per second: Σ |Q|·|D| over seconds, / 1e9."""
    return cells / (seconds * 1e9)


def fa_pairs(S: int, T: int, causal: bool, window: Optional[int]) -> int:
    """(query, key) pairs a flash-attention call must score: causal with
    q_offset 0, a sliding window of ``window`` keys, or all S x T."""
    i = np.arange(S, dtype=np.int64)
    hi = np.minimum(i, T - 1) if causal else np.full(S, T - 1)
    lo = np.maximum(i - window + 1, 0) if window else np.zeros(S, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def matmul_params(c: Dict[str, Any]) -> int:
    """Parameters that enter a matrix product once per token in a dense
    decoder with untied embeddings, from the published sizes (Hugging Face
    names): the output head, and per layer q/k/v/o and a SwiGLU MLP.  The
    input embedding is a row lookup, no product, and the norm scales
    (0.005% of the parameters) are elementwise: both are left out.
    (chip_smoke.py counts the embedding as a product too.)"""
    d, V, L = c["hidden_size"], c["vocab_size"], c["num_hidden_layers"]
    H, Hkv, ff = c["num_attention_heads"], c["num_key_value_heads"], c["intermediate_size"]
    dh = d // H
    return V * d + L * (d * dh * (2 * H + 2 * Hkv) + 3 * d * ff)


def fa_fwd_flops(c: Dict[str, Any], B: int, S: int) -> float:
    """One causal flash-attention forward launch of one layer, within the
    configuration's ``sliding_window`` where it has one: 2 products of 2·D
    FLOPs per unmasked pair, per (sequence, head)."""
    D = c["hidden_size"] // c["num_attention_heads"]
    pairs = fa_pairs(S, S, True, c.get("sliding_window"))
    return 2 * 2 * D * pairs * B * c["num_attention_heads"]


def fa_bwd_flops(c: Dict[str, Any], B: int, S: int) -> float:
    """One flash-attention backward launch: 5 products of 2·D FLOPs per
    unmasked pair, per (sequence, head)."""
    return fa_fwd_flops(c, B, S) * 5 / 2


def train_flops(c: Dict[str, Any], B: int, S: int) -> float:
    """FLOPs of one train step of a dense decoder, at the bf16 rate: 6 x
    the parameters that enter a product x tokens, plus the attention's
    forward (2) and backward (5) products of 2·D FLOPs per unmasked pair
    (causal, within the window); the remat recompute not counted."""
    L = c["num_hidden_layers"]
    return (6 * matmul_params(c) * B * S
            + (fa_fwd_flops(c, B, S) + fa_bwd_flops(c, B, S)) * L)
