"""Llama-3.2-Vision 90B — cross-attention image layers every 5th layer
[hf:meta-llama/Llama-3.2-11B-Vision; unverified].

The vision frontend is a STUB per assignment: ``input_specs()`` provides
precomputed patch embeddings (B, 1601, 1280); the backbone projects them
once and cross-attends in 20 of the 100 layers."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128_256,
    head_dim=128,
    cross_attn_every=5,
    vision_patches=1601,
    vision_dim=1280,
    rope_theta=500_000.0,
    optimizer_dtype="bfloat16",
    loss_chunk=512,
)
