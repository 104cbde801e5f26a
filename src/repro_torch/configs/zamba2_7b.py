"""Zamba2-7B(-Instruct) at its published widths and layer equations: the
``zamba2`` family [arXiv:2411.15242; Zyphra/Zamba2-7B-Instruct config.json].

81 layers (``layers_block_type`` as published: 68 Mamba2 layers and 13
hybrid ones, ids 6, 11, 17, ...), d 3584, Mamba2 with 112 heads of 64,
state 64, 2 B/C groups, chunk 256, conv 4 with bias; two memory blocks
(attention of 32 heads of 224 over the 7168-wide concatenation of the
stream and the embedding, a gated-GeLU MLP of 14336) that alternate over
the hybrid layers, each hybrid layer with its own rank-128 adapter on the
MLP's gate and up projections and its own 3584 x 3584 linear; tied head.

Kept out of ``ARCHS``: that registry is the port's copy of the JAX
package's ten architectures, which the parity tests iterate over and hold
field for field against the JAX package, which has no such family.
Import it as ``repro_torch.configs.zamba2_7b.CONFIG``.
"""
from ..models.zamba2 import Zamba2Config

LAYER_TYPES = tuple("hybrid" if i in (6, 11, 17, 23, 29, 35, 41, 47, 53, 59,
                                      65, 71, 77) else "mamba"
                    for i in range(81))

CONFIG = Zamba2Config(
    name="zamba2-7b",
    family="zamba2",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32_000,
    head_dim=224,
    ssm_state=64,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=256,
    ssm_conv=4,
    rope_theta=10_000.0,
    norm_eps=1e-5,
    layer_types=LAYER_TYPES,
    ssm_groups=2,
    n_mem_blocks=2,
    adapter_rank=128,
    pad_heads_to=0,
    pad_vocab_to=0,
)
