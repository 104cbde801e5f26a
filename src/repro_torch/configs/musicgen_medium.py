"""MusicGen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

Audio frontend is a STUB per assignment: ``input_specs()`` provides
precomputed frame embeddings (B, S, d_model); the model predicts 4 parallel
EnCodec codebooks (vocab 2048 each).  24 MHA heads pad to 32 masked heads."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    head_dim=64,
    n_codebooks=4,
    rope_theta=10_000.0,
)
