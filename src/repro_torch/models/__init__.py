"""The port's model stack (counterpart of ``repro.models``): every family
of ``configs/`` (dense, moe, ssm, hybrid, vlm, audio), with ``prefill``
and ``loss_fn`` running the hand-written flash-attention and SSD kernels on
the card, and the sharding-token trees of the mesh (``loss_fn`` runs on
their local shards inside ``repro_torch.parallel.mesh_context``)."""
from .config import ModelConfig, active_param_count, param_count
from .model import (batch_pspecs, cache_pspecs, decode_step, init_cache,
                    init_params, init_params_spec, loss_fn, params_pspecs,
                    prefill)
from .moe import moe_apply, moe_init, router_aux_loss

__all__ = [
    "ModelConfig", "param_count", "active_param_count",
    "init_params", "init_params_spec", "params_pspecs", "loss_fn", "prefill",
    "decode_step", "init_cache", "cache_pspecs", "batch_pspecs",
    "moe_apply", "moe_init", "router_aux_loss",
]
