"""StarCoder2-7B — dense GQA kv=4, RoPE [arXiv:2402.19173; hf].

36 heads do not divide the 16-wide model axis; the framework pads to 48
masked heads (numerics-exact, see models/model.py)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab_size=49_152,
    head_dim=128,
    rope_theta=100_000.0,
    loss_chunk=1024,
)
