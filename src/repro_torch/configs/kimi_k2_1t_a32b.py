"""Kimi K2 — trillion-parameter MoE [arXiv:2501.kimi2; unverified].

Table values: 61L, d_model=7168, 64H (GQA kv=8), expert d_ff=2048,
vocab=163840, MoE 384 experts top-8.  One shared expert (public K2 detail)
is enabled via ``n_shared_experts=1``.  Optimizer moments in bf16: at 1T
params fp32 moments cannot fit any assigned mesh (see EXPERIMENTS §Dry-run).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163_840,
    head_dim=112,            # 7168 / 64
    n_experts=384,
    top_k=8,
    n_shared_experts=1,
    rope_theta=50_000.0,
    optimizer_dtype="bfloat16",
    loss_chunk=512,
)
