"""DeepSeek-Coder 33B — llama-arch dense GQA [arXiv:2401.14196; hf].

56 heads pad to 64 masked heads for the 16-wide model axis."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-coder-33b",
    family="dense",
    n_layers=62,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=19200,
    vocab_size=32_256,
    head_dim=128,
    rope_theta=100_000.0,
    loss_chunk=512,
)
