"""The Mamba2 mixer's gated-norm epilogue (the ``zamba2`` family's
``_mixer``, after the SSD): the CUDA kernels' wrappers and their plain
PyTorch versions.

For the SSD's output y (B,T,H,P) f32, its input x (B,T,H,P), the gate z
(B,T,H·P), the skip ``D`` (H,) and the norm's weight ``gnorm`` (H·P,), with
G groups of W = H·P / G channels::

    s = y + x·D[h];  v = s·silu(z);  r = rsqrt(mean over the group(v²) + eps)
    out = (v·r)·gnorm, in z's dtype

:func:`gated_rmsnorm` runs :func:`gated_rmsnorm_plain` on a CPU tensor
(under autograd, so the CPU's numbers are the eager expression's); on a
CUDA tensor it launches the hand-written kernel of ``csrc/gated_norm.cu``
and, with grad mode on and an input that requires grad, goes through
:class:`GatedRMSNormFn`, whose backward is that file's backward kernel
(:func:`gated_rmsnorm_backward`).  There is no fallback from the kernels to
the plain version.  :func:`gated_rmsnorm_backward_plain` is the backward's
formulas in eager PyTorch.  The kernels replace no TPU kernel: the JAX
package has no Zamba2 at its published widths (``models/ssm.py``'s
``ssm_apply`` keeps its own epilogue, which casts to bf16 before the gate
and normalises over all of d_inner).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["gated_rmsnorm", "gated_rmsnorm_plain", "gated_rmsnorm_backward_plain",
           "gated_rmsnorm_forward", "gated_rmsnorm_backward", "GatedRMSNormFn",
           "launch_count", "bwd_launch_count", "reset_launch_count"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ITEMS, _MAX_THREADS = 4, 512       # csrc/gated_norm.cu: W <= 512·4·4
_BWD_STRIP = 128     # csrc/gated_norm.cu's BWD_STRIP: one row of partials a strip

# Calls on CUDA since the last reset: forward, and backward (two kernels each).
_COUNTER = _build.COUNTERS["gated_norm"]
launch_count = _COUNTER.forward
bwd_launch_count = _COUNTER.backward
reset_launch_count = _COUNTER.reset          # both counts to 0


def gated_rmsnorm_plain(y, x, z, D, gnorm, groups: int, eps: float) -> torch.Tensor:
    """The epilogue in eager PyTorch, in y's dtype (f32 in the model: the
    expression ``models.zamba2._mixer`` wrote, bit for bit), cast to z's."""
    b, t, hh, P = y.shape
    di = hh * P
    v = y + x.to(y.dtype) * D[:, None]
    v = v.reshape(b, t, groups, di // groups) * \
        F.silu(z.to(y.dtype)).reshape(b, t, groups, di // groups)
    v = v * torch.rsqrt((v * v).mean(-1, keepdim=True) + eps)
    return (v.reshape(b, t, di) * gnorm).to(z.dtype)


def gated_rmsnorm_backward_plain(y, x, z, D, gnorm, groups: int, eps: float, do):
    """(dy, dx, dz, dD, dgnorm) of :func:`gated_rmsnorm_plain` for the
    output gradient ``do``: the backward kernel's formulas in eager PyTorch,
    not autograd, in y's dtype (float64 for float64 inputs, else f32).  With
    dn = do·gnorm and the forward's s, v, r::

        dv = r·dn − v·r³·mean(dn·v);  ds = dv·silu(z);  dy = ds;  dx = ds·D
        dz = (dv·s)·σ(z)·(1 + z·(1 − σ(z)));  dgnorm = Σ do·v·r;  dD = Σ ds·x

    dx and dz come back in x's and z's dtypes, the others in y's."""
    b, t, hh, P = y.shape
    di = hh * P
    w, f = di // groups, y.dtype
    zf = z.to(f).reshape(b, t, hh, P)
    sig = torch.sigmoid(zf)
    sz = F.silu(zf)
    s = y + x.to(f) * D.to(f)[:, None]
    v = (s * sz).reshape(b, t, groups, w)
    r = torch.rsqrt((v * v).mean(-1, keepdim=True) + eps)
    dof = do.to(f).reshape(b, t, groups, w)
    dn = dof * gnorm.to(f).reshape(groups, w)
    dgnorm = (dof * (v * r)).sum((0, 1)).reshape(di)
    dv = (r * dn - v * (r ** 3 * (dn * v).mean(-1, keepdim=True))).reshape(b, t, hh, P)
    ds = dv * sz
    dz = (dv * s) * (sig * (1 + zf * (1 - sig)))
    dD = (ds * x.to(f)).sum((0, 1, 3))
    return (ds, (ds * D.to(f)[:, None]).to(x.dtype), dz.reshape(b, t, di).to(z.dtype),
            dD, dgnorm)


def _check(y, x, z, D, gnorm, groups) -> None:
    """Raise on inputs that neither the kernels nor the plain version take."""
    if y.dim() != 4 or x.shape != y.shape:
        raise ValueError(f"y and x (B,T,H,P) expected, got {tuple(y.shape)}, "
                         f"{tuple(x.shape)}")
    b, t, hh, P = y.shape
    if z.shape != (b, t, hh * P) or D.shape != (hh,) or gnorm.shape != (hh * P,):
        raise ValueError(f"z (B,T,H·P), D (H,), gnorm (H·P,) expected for y "
                         f"{tuple(y.shape)}, got {tuple(z.shape)}, "
                         f"{tuple(D.shape)}, {tuple(gnorm.shape)}")
    if groups <= 0 or hh % groups:
        raise ValueError(f"{hh} heads do not split into {groups} groups")
    if any(u.device != y.device for u in (x, z, D, gnorm)):
        raise ValueError("y, x, z, D and gnorm must share a device")


def _aligned(t: torch.Tensor, nbytes: int) -> bool:
    return t.data_ptr() % nbytes == 0


def _check_kernel(y, x, z, D, gnorm, groups) -> None:
    """Raise on CUDA inputs the kernels do not take."""
    if y.device.type != "cuda":
        raise ValueError(f"no gated-norm kernel for {y.device}")
    if y.dtype != torch.float32 or D.dtype != torch.float32 or \
            gnorm.dtype != torch.float32:
        raise TypeError(f"y, D and gnorm must be float32, got {y.dtype}, "
                        f"{D.dtype}, {gnorm.dtype}")
    if x.dtype not in _DTYPES or z.dtype != x.dtype:
        raise TypeError(f"x and z must share float32 or bfloat16, got {x.dtype}, "
                        f"{z.dtype}")
    b, t, hh, P = y.shape
    if not (y.is_contiguous() and D.is_contiguous() and gnorm.is_contiguous()):
        raise ValueError("y, D and gnorm must be contiguous")
    if x.stride(3) != 1 or (hh > 1 and x.stride(2) != P) or z.stride(2) != 1:
        raise ValueError(f"x's heads and channels, and z's channels, must lie "
                         f"contiguously in a row; strides {x.stride()}, "
                         f"{z.stride()}")
    if P % 4 or any(s % 4 for s in (x.stride(0), x.stride(1), z.stride(0), z.stride(1))) \
            or not (_aligned(y, 16) and _aligned(gnorm, 16)
                    and _aligned(x, 4 * x.element_size())
                    and _aligned(z, 4 * z.element_size())):
        raise ValueError(f"the kernels load 4 channels at a time: P ({P}) and "
                         f"x's and z's row strides must be multiples of 4, and "
                         f"y, gnorm, x and z aligned to 4 elements")
    w = hh * P // groups
    if -(-w // 4 // _ITEMS) > _MAX_THREADS:
        raise ValueError(f"a group of {w} channels exceeds the kernel's "
                         f"{_MAX_THREADS} threads of {_ITEMS} chunks of 4")


_P, _I, _Q = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: csrc/gated_norm.cu's C interface: function -> (restype, argtypes)
_LIB = _build.Library("gated_norm", {
    "gn_forward": (_I, [_P] * 7 + [_I] * 3 + [_Q] * 4 + [_I] * 3
                   + [ctypes.c_float, _P]),
    "gn_backward": (_I, [_P] * 13 + [_I] * 3 + [_Q] * 4 + [_I] * 3 + [_P])})


def _strides(x, z):
    return x.stride(0), x.stride(1), z.stride(0), z.stride(1)


def gated_rmsnorm_forward(y, x, z, D, gnorm, groups: int, eps: float
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, r)`` by the forward kernel, without autograd, on CUDA: out
    (B,T,H·P) in z's dtype, r (B,T,G) f32, the group's rsqrt(mean(v²) + eps)
    that the backward reads.  One launch on the current stream."""
    _check(y, x, z, D, gnorm, groups)
    _check_kernel(y, x, z, D, gnorm, groups)
    b, t, hh, P = y.shape
    out = torch.empty((b, t, hh * P), dtype=z.dtype, device=y.device)
    r = torch.empty((b, t, groups), dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        _LIB.launch("gn_forward", y.data_ptr(), x.data_ptr(), z.data_ptr(),
                    D.data_ptr(), gnorm.data_ptr(), out.data_ptr(), r.data_ptr(),
                    _DTYPES[x.dtype], b * t, t, *_strides(x, z),
                    hh * P // groups, groups, P, float(eps),
                    torch.cuda.current_stream().cuda_stream)
    _COUNTER.add("fwd")
    return out, r


def gated_rmsnorm_backward(do, y, x, z, D, gnorm, r, groups: int):
    """(dy, dx, dz, dD, dgnorm) by the backward kernels on CUDA, for the
    output gradient ``do`` and the forward's ``r``: dy (B,T,H,P) f32, dx
    (B,T,H,P) and dz (B,T,H·P) contiguous in x's dtype, dD and dgnorm f32.
    One launch (the backward kernel, then the sum of its per-strip partials
    in strip order) on the current stream, no atomics: two calls give the
    same bits.  :func:`gated_rmsnorm_backward_plain` is the same function in
    eager PyTorch."""
    _check(y, x, z, D, gnorm, groups)
    _check_kernel(y, x, z, D, gnorm, groups)
    b, t, hh, P = y.shape
    di = hh * P
    if do.shape != z.shape or do.dtype != z.dtype or not do.is_contiguous() \
            or not _aligned(do, 4 * do.element_size()) \
            or r.shape != (b, t, groups) or r.dtype != torch.float32 \
            or not r.is_contiguous():
        raise ValueError(f"do must be a contiguous, aligned {tuple(z.shape)} "
                         f"{z.dtype} tensor and r the forward's (B,T,G) float32")
    f32 = dict(dtype=torch.float32, device=y.device)
    dy = torch.empty(y.shape, **f32)
    dx = torch.empty(y.shape, dtype=x.dtype, device=y.device)
    dz = torch.empty(z.shape, dtype=z.dtype, device=y.device)
    dD, dgnorm = torch.empty((hh,), **f32), torch.empty((di,), **f32)
    part = torch.empty((-(-b * t // _BWD_STRIP), di + hh), **f32)
    with torch.cuda.device(y.device):
        _LIB.launch("gn_backward", do.data_ptr(), y.data_ptr(), x.data_ptr(),
                    z.data_ptr(), D.data_ptr(), gnorm.data_ptr(), r.data_ptr(),
                    dy.data_ptr(), dx.data_ptr(), dz.data_ptr(), part.data_ptr(),
                    dD.data_ptr(), dgnorm.data_ptr(), _DTYPES[x.dtype], b * t, t,
                    *_strides(x, z), di // groups, groups, P,
                    torch.cuda.current_stream().cuda_stream)
    _COUNTER.add("bwd")
    return dy, dx, dz, dD, dgnorm


class GatedRMSNormFn(torch.autograd.Function):
    """The forward kernel, with the backward kernels as its gradient.  It
    saves the inputs and r with ``save_for_backward``, so a non-reentrant
    ``torch.utils.checkpoint`` drops them with the layer and recomputes
    them; x is saved as the view it is (a slice of xBC), not copied."""

    @staticmethod
    def forward(ctx, y, x, z, D, gnorm, groups, eps):
        out, r = gated_rmsnorm_forward(y, x, z, D, gnorm, groups, eps)
        ctx.save_for_backward(y, x, z, D, gnorm, r)
        ctx.groups = groups
        return out

    @staticmethod
    def backward(ctx, do):
        y, x, z, D, gnorm, r = ctx.saved_tensors
        grads = gated_rmsnorm_backward(do.to(z.dtype).contiguous(), y, x, z, D,
                                       gnorm, r, ctx.groups)
        return (*grads, None, None)


def gated_rmsnorm(y: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
                  D: torch.Tensor, gnorm: torch.Tensor, groups: int,
                  eps: float) -> torch.Tensor:
    """The epilogue, (B,T,H·P) in z's dtype.  y (B,T,H,P) f32; x (B,T,H,P)
    with its heads and channels contiguous in a row (any strides over
    (B, T): a slice of xBC is read in place); z (B,T,H·P); D (H,); gnorm
    (H·P,); H a multiple of ``groups``.  A CPU (or other non-CUDA) tensor
    runs :func:`gated_rmsnorm_plain`.  On CUDA (y, D, gnorm f32; x and z
    both f32 or both bf16; P and x's and z's row strides multiples of 4,
    which the model's shapes are) the forward kernel runs on the current
    stream,
    through :class:`GatedRMSNormFn` when grad mode is on and an input
    requires grad."""
    _check(y, x, z, D, gnorm, groups)
    if y.device.type != "cuda":
        return gated_rmsnorm_plain(y, x, z, D, gnorm, groups, eps)
    if torch.is_grad_enabled() and any(u.requires_grad for u in (y, x, z, D, gnorm)):
        return GatedRMSNormFn.apply(y, x, z, D, gnorm, groups, eps)
    return gated_rmsnorm_forward(y, x, z, D, gnorm, groups, eps)[0]
