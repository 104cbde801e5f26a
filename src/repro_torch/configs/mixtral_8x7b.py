"""Mixtral 8x7B — 8 experts top-2, sliding-window attention [arXiv:2401.04088; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=32_000,
    head_dim=128,
    n_experts=8,
    top_k=2,
    sliding_window=4096,
    rope_theta=1_000_000.0,
    loss_chunk=1024,
)
