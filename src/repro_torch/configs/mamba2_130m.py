"""Mamba2-130M — pure SSD, attention-free [arXiv:2405.21060; unverified].

d_ff=0 (no MLP): 24 Mamba2 blocks only.  Vocab 50280 pads to 50288 for the
16-wide model axis.  O(1)-state decode ⇒ runs the long_500k cell."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    n_heads=12,            # unused (attention-free); kept for interface
    n_kv_heads=12,
    d_ff=0,
    vocab_size=50_280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=256,
)
