"""The port's parallel layer (counterpart of ``repro.parallel``): the mesh
context and its sharding rules, the sharded model's collectives over the
rank groups of ``repro_torch.core.ranks``, and ring attention."""
from .context import MeshCtx, current_ctx, manual_model, mesh_context, shard
from . import rules
from .ring_attention import ring_attention, ring_attention_plain

__all__ = ["MeshCtx", "current_ctx", "mesh_context", "shard", "manual_model",
           "ring_attention", "ring_attention_plain", "rules"]
