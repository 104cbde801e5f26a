"""The port's optimizer (counterpart of ``repro.optim``): AdamW with
global-norm clipping, the cosine LR schedule, int8 gradient quantisation
and gradient accumulation.  The reference's ``ef_int8_psum``, a
collective, comes with the multi-GPU slice."""
from .adamw import AdamWState, adamw_init, adamw_update, clip_by_global_norm
from .schedule import cosine_schedule
from .compression import int8_quantize, int8_dequantize
from .accumulate import accumulate_grads

__all__ = [
    "AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm",
    "cosine_schedule", "int8_quantize", "int8_dequantize",
    "accumulate_grads",
]
