"""The port's optimizer (counterpart of ``repro.optim``): AdamW with
global-norm clipping, the cosine LR schedule, int8 gradient quantisation
the error-feedback int8 all-reduce over a data group and gradient
accumulation."""
from .adamw import AdamWState, adamw_init, adamw_update, clip_by_global_norm
from .schedule import cosine_schedule
from .compression import ef_int8_psum, int8_quantize, int8_dequantize
from .accumulate import accumulate_grads

__all__ = [
    "AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm",
    "cosine_schedule", "int8_quantize", "int8_dequantize", "ef_int8_psum",
    "accumulate_grads",
]
