"""Phi-3-mini 3.8B — dense, RoPE, SwiGLU, MHA (kv=32) [arXiv:2404.14219; unverified]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32_064,
    head_dim=96,
    rope_theta=10_000.0,
    loss_chunk=1024,
)
