"""Assigned architecture registry (10 archs × their shape sets).

The port's plain-data copy of ``repro.configs``: the same ten
``ModelConfig`` values, importable as ``repro_torch.configs.<id>``.
``SHAPES`` defines the assigned input-shape cells; ``long_500k`` is only
listed for archs with sub-quadratic decode (SSM / hybrid / sliding-window).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from ..models.config import ModelConfig

from .kimi_k2_1t_a32b import CONFIG as kimi_k2_1t_a32b
from .mixtral_8x7b import CONFIG as mixtral_8x7b
from .phi3_mini_3_8b import CONFIG as phi3_mini_3_8b
from .mistral_nemo_12b import CONFIG as mistral_nemo_12b
from .starcoder2_7b import CONFIG as starcoder2_7b
from .deepseek_coder_33b import CONFIG as deepseek_coder_33b
from .llama_3_2_vision_90b import CONFIG as llama_3_2_vision_90b
from .musicgen_medium import CONFIG as musicgen_medium
from .zamba2_2_7b import CONFIG as zamba2_2_7b
from .mamba2_130m import CONFIG as mamba2_130m

ARCHS: Dict[str, ModelConfig] = {
    c.name: c for c in [
        kimi_k2_1t_a32b, mixtral_8x7b, phi3_mini_3_8b, mistral_nemo_12b,
        starcoder2_7b, deepseek_coder_33b, llama_3_2_vision_90b,
        musicgen_medium, zamba2_2_7b, mamba2_130m,
    ]
}


@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str               # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)

# archs whose decode is sub-quadratic (SSM state / rolling SWA window):
SUBQUADRATIC = {"mamba2-130m", "zamba2-2.7b", "mixtral-8x7b"}


def cell_applicable(arch: str, shape: ShapeCell) -> Tuple[bool, str]:
    if shape.name == "long_500k" and arch not in SUBQUADRATIC:
        return False, "pure full-attention arch: 524k dense-KV decode is the quadratic case the spec excludes"
    return True, ""


def get(arch: str) -> ModelConfig:
    return ARCHS[arch]
