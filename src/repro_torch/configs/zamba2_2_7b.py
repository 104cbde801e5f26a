"""Zamba2-2.7B — Mamba2 backbone + shared attention block [arXiv:2411.15242; hf].

54 layers as 9 groups of (5 Mamba2 blocks + 1 attention block); the
attention block's parameters are genuinely SHARED across all 9 occurrences
(``shared_attn_block=True``), as in the paper's shared-transformer design."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32_000,
    head_dim=80,
    attn_every=6,
    shared_attn_block=True,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=256,
    rope_theta=10_000.0,
)
