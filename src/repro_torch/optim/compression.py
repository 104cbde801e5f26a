"""Error-feedback int8 gradient compression for the data-parallel
all-reduce.

Counterpart of ``repro.optim.compression``.  Quantising to int8 with a
per-chunk scale cuts the all-reduce's bytes 4x against f32; the
quantisation residual is carried in an error-feedback buffer added to the
next step's gradient (Karimireddy et al., 2019).  ``ef_int8_psum`` runs
inside a rank job (``repro_torch.core.ranks``) and takes the data
:class:`~repro_torch.core.ranks.Group` where the reference takes an axis
name: quantise with a scale shared by an all-reduce max, sum the codes as
int32, dequantise the mean, keep the residual.
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..core.dchannel import all_reduce
from ..core.ranks import Group
from ..tree import tree_leaves, tree_map

__all__ = ["int8_quantize", "int8_dequantize", "ef_int8_psum"]

_CHUNK = 1024


def int8_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (q (n_chunks, 1024) int8, scales (n_chunks, 1) f32): each
    chunk of the flattened f32 input scaled by its max |x| / 127 and
    rounded half to even."""
    flat = x.float().reshape(-1)
    flat = F.pad(flat, (0, (-flat.shape[0]) % _CHUNK))
    chunks = flat.reshape(-1, _CHUNK)
    scale = chunks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(chunks / torch.clamp(scale, min=1e-12)).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor, shape: Sequence[int],
                    dtype: torch.dtype) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(tuple(shape)).to(dtype)


def ef_int8_psum(grads: Any, residual: Any, axis_name: Group) -> Tuple[Any, Any]:
    """Compressed mean all-reduce with error feedback over ``axis_name``,
    the data :class:`~repro_torch.core.ranks.Group`.

    grads/residual: trees of the same structure (residual f32).  Returns
    (reduced grads in each leaf's dtype, new f32 residual).  Each chunk's
    scale is the group's largest (an all-reduce max), so the summed int8
    codes decode with one scale; the codes are summed as int32, so nothing
    overflows across ranks."""
    n = axis_name.size

    def one(g: torch.Tensor, r: torch.Tensor):
        x = g.float() + r
        flat = x.reshape(-1)
        chunks = F.pad(flat, (0, (-flat.shape[0]) % _CHUNK)).reshape(-1, _CHUNK)
        scale = chunks.abs().amax(dim=1, keepdim=True) / 127.0
        scale = all_reduce(scale, axis_name, dist.ReduceOp.MAX)
        q = torch.round(chunks / torch.clamp(scale, min=1e-12)).to(torch.int8)
        summed = all_reduce(q.to(torch.int32), axis_name)
        approx = int8_dequantize(summed.float() / n, scale, g.shape,
                                 torch.float32)
        new_r = x - int8_dequantize(q, scale, g.shape, torch.float32)
        return approx.to(g.dtype), new_r

    pairs = tree_leaves(tree_map(one, grads, residual))   # (g, r) a leaf
    gs, rs = iter([p[0] for p in pairs]), iter([p[1] for p in pairs])
    return (tree_map(lambda _: next(gs), grads),
            tree_map(lambda _: next(rs), grads))
