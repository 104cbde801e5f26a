"""Flash attention (causal / sliding-window GQA): the CUDA kernel's wrapper
and its plain PyTorch version.

Counterpart of ``repro.kernels.flash_attention`` (the Pallas TPU kernel
``_fa_kernel`` behind ``flash_attention``).  :func:`flash_attention` takes
q (B, H, S, D) and k, v (B, Hkv, T, D) with any strides whose last axis is
unit: on CUDA tensors it launches one of the hand-written kernels in
``csrc/flash_attention.cu`` and counts the launch (bfloat16: the wgmma
kernel, whose K/V tiles arrive by TMA; float32: the SIMT kernel on the f32
pipes); on CPU tensors it runs :func:`fa_plain`.  There is no fallback from
a kernel to the plain version, nor from the bfloat16 kernel to the SIMT
one: a bfloat16 layout that TMA cannot take (:func:`tma_problem`) raises.

With grad mode on and an input that requires grad, a CUDA call goes
through :class:`FlashAttentionFn`, whose backward is the hand-written
kernel of ``csrc/flash_attention_bwd.cu`` (:func:`fa_backward`, three
kernels counted as one backward launch); a CPU call runs :func:`fa_plain`
under autograd.  In bfloat16 the forward kernel also writes each row's
softmax statistics (:func:`fa_forward_with_stats`), which the backward's
wgmma kernels read; :func:`fa_stats_plain` computes the same values.
:func:`fa_backward_plain` is that backward's plain version.  The JAX
package has no backward kernel: XLA differentiates the model's
``chunked_attention`` there.

:func:`fa_plain` is the TPU kernel's arithmetic in eager PyTorch, with one
q tile of all S rows: an online softmax over kv tiles, m, l and acc in f32,
P rounded to v's dtype before P·V (accumulated in f32, as the CUDA kernel
does), masked scores at NEG = -1e9.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional

import torch

__all__ = ["flash_attention", "fa_plain", "FlashAttentionFn", "fa_backward",
           "fa_backward_plain", "fa_forward_with_stats", "fa_stats_plain",
           "tma_problem", "launch_count", "bwd_launch_count",
           "reset_launch_count", "NEG", "NEG2", "HEAD_DIMS", "KV_TILE"]

NEG = -1e9
LOG2E = math.log2(math.e)
NEG2 = NEG * LOG2E   # a masked score in the statistics' base-2 domain
HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)   # the kernel's instances
_PLAIN_BK = 512      # kv rows per step of the plain version's online softmax
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The forward kernels' kv tiles: a tile that no row of a 64-row q group can
# see is skipped, which decides what a row whose every key is masked sees.
KV_TILE = {torch.float32: 64, torch.bfloat16: 128}
_Q_GROUP = 64
_PLAIN_BQ = 512      # q rows per step of the plain backward

LAUNCHES = 0         # forward kernel launches since the last reset
BWD_LAUNCHES = 0     # backward launches (three kernels each) since then
_LAUNCH_LOCK = threading.Lock()


def launch_count() -> int:
    with _LAUNCH_LOCK:
        return LAUNCHES


def bwd_launch_count() -> int:
    with _LAUNCH_LOCK:
        return BWD_LAUNCHES


def reset_launch_count() -> None:
    """Set both counts, forward and backward, to 0."""
    global LAUNCHES, BWD_LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES = BWD_LAUNCHES = 0


def _count_launch(backward: bool = False) -> None:
    global LAUNCHES, BWD_LAUNCHES
    with _LAUNCH_LOCK:
        if backward:
            BWD_LAUNCHES += 1
        else:
            LAUNCHES += 1


def fa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             causal: bool = True, window: Optional[int] = None,
             q_offset: int = 0, kv_tile: Optional[int] = None) -> torch.Tensor:
    """q (B,H,S,D); k/v (B,Hkv,T,D), H % Hkv == 0.  Returns (B,H,S,D) in
    q's dtype, on q's device.  ``kv_tile=None`` visits every key, as the TPU
    kernel does; ``kv_tile=KV_TILE[dtype]`` follows the CUDA kernel's skip
    rule (as in :func:`fa_backward_plain`), which differs only on rows
    whose every key is masked."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    g = H // Hkv
    dev = q.device
    if kv_tile is not None:
        seen, pad = _tile_seen(torch.arange(S, device=dev), T, causal=causal,
                               window=window, q_offset=q_offset, kv_tile=kv_tile)
    qg = q.float().reshape(B, Hkv, g, S, D)            # kv head h // g, in place
    m = torch.full((B, Hkv, g, S, 1), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, g, S, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, g, S, D), dtype=torch.float32, device=dev)
    qpos = torch.arange(S, device=dev)[:, None] + q_offset
    for k0 in range(0, T, _PLAIN_BK):
        kt = k[:, :, k0:k0 + _PLAIN_BK].float()[:, :, None]   # (B,Hkv,1,n,D)
        vt = v[:, :, k0:k0 + _PLAIN_BK][:, :, None]
        kpos = torch.arange(k0, k0 + kt.shape[3], device=dev)[None, :]
        mask = torch.ones((S, kt.shape[3]), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos <= qpos
        if window is not None:
            mask &= kpos > qpos - window
        s = (qg @ kt.transpose(-1, -2)) * D ** -0.5
        s = torch.where(mask, s, NEG)
        if kv_tile is not None:
            s = torch.where(seen[:, k0:k0 + kt.shape[3]], s, -torch.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ vt.float()
        m = m_new
    if kv_tile is not None:
        l = l + pad * torch.exp(NEG - m)
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, H, S, D).to(q.dtype)


def _tile_seen(rows, T, *, causal, window, q_offset, kv_tile):
    """The forward kernel's skip rule, per (64-row q group, kv tile), for q
    rows ``rows``: (seen, pad), seen (n, T) whether the row visits each
    key's tile, pad (n, 1) the padding slots past T that its visited tiles
    hold.  ``kv_tile=None`` visits every key and holds no padding."""
    n, dev = rows.numel(), rows.device
    if kv_tile is None:
        return (torch.ones((n, T), dtype=torch.bool, device=dev),
                torch.zeros((n, 1), dtype=torch.float32, device=dev))
    glo = rows // _Q_GROUP * _Q_GROUP + q_offset
    n_kt = -(-T // kv_tile)
    kv0 = torch.arange(n_kt, device=dev) * kv_tile
    tile_seen = torch.ones((n, n_kt), dtype=torch.bool, device=dev)
    if causal:
        tile_seen &= kv0[None, :] <= glo[:, None] + _Q_GROUP - 1
    if window is not None:
        tile_seen &= kv0[None, :] + kv_tile - 1 > glo[:, None] - window
    seen = tile_seen[:, torch.arange(T, device=dev) // kv_tile]
    return seen, tile_seen[:, -1:].to(torch.float32) * (n_kt * kv_tile - T)


def _row_blocks(q, k, *, causal, window, q_offset, kv_tile):
    """Per block of up to _PLAIN_BQ q rows: (r0, n, s, mask, pad), with s the
    scores q·kᵀ·D^-0.5·log2 e in f32 as (B, Hkv, g, n, T), NEG2 where
    masked and -inf on keys of tiles the row never visits, and pad (n, 1)
    the padding slots past T that a row's visited tiles hold."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    g = H // Hkv
    dev = q.device
    kf = k.float()[:, :, None]                     # (B,Hkv,1,T,D)
    kpos = torch.arange(T, device=dev)
    for r0 in range(0, S, _PLAIN_BQ):
        rows = torch.arange(r0, min(r0 + _PLAIN_BQ, S), device=dev)
        n = rows.numel()
        qpos = rows[:, None] + q_offset
        mask = torch.ones((n, T), dtype=torch.bool, device=dev)
        if causal:
            mask &= kpos[None, :] <= qpos
        if window is not None:
            mask &= kpos[None, :] > qpos - window
        seen, pad = _tile_seen(rows, T, causal=causal, window=window,
                               q_offset=q_offset, kv_tile=kv_tile)
        qc = q[:, :, r0:r0 + n].float().reshape(B, Hkv, g, n, D)
        s = torch.where(mask, (qc @ kf.transpose(-1, -2)) * (D ** -0.5 * LOG2E),
                        NEG2)
        yield r0, n, torch.where(seen, s, -torch.inf), mask, pad


def fa_stats_plain(q: torch.Tensor, k: torch.Tensor, *, causal: bool = True,
                   window: Optional[int] = None, q_offset: int = 0,
                   kv_tile: Optional[int] = None) -> torch.Tensor:
    """Each row's softmax statistics as the bfloat16 forward kernel writes
    them (``fa_forward_with_stats``): a (2, B·H·S) float32 tensor, row
    (b·H + h)·S + s, holding the row's max m of its visited scores in the
    base-2 domain (score·D^-0.5·log2 e, masked scores at NEG2; NEG2 where
    no tile is visited) and 1/l, l = Σ 2^(s - m) over the visited slots
    (padding past T included), 0 where l = 0.  ``kv_tile`` as in
    :func:`fa_backward_plain`; ``None`` visits every key."""
    B, H, S, _ = q.shape
    out = torch.empty((2, B, H, S), dtype=torch.float32, device=q.device)
    for r0, n, s, _, pad in _row_blocks(q, k, causal=causal, window=window,
                                        q_offset=q_offset, kv_tile=kv_tile):
        m = torch.clamp(s.amax(dim=-1, keepdim=True), min=NEG2)
        l = torch.exp2(s - m).sum(dim=-1, keepdim=True) + pad * torch.exp2(NEG2 - m)
        out[0, :, :, r0:r0 + n] = m.reshape(B, H, n)
        out[1, :, :, r0:r0 + n] = torch.where(l > 0, 1.0 / l, 0.0).reshape(B, H, n)
    return out.reshape(2, B * H * S)


def fa_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                      window: Optional[int] = None, q_offset: int = 0,
                      kv_tile: Optional[int] = None,
                      stats: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of ``flash_attention`` in q's, k's and v's dtypes: the
    backward kernel's steps in eager PyTorch, in f32, over blocks of q
    rows.  (1) Each row's max m and 1/l over the keys it visits
    (:func:`fa_stats_plain`, or ``stats`` in its layout, e.g. the forward
    kernel's), and Δ = rowsum(do ∘ o); (2) P = 2^(s - m)/l,
    dv = Σ Pᵀ·do, dS = P ∘ (do·vᵀ - Δ), 0 where masked,
    dk = Σ dSᵀ·q·D^-0.5; (3) dq = dS·k·D^-0.5.  The forward's rounding of
    P to v's dtype is taken as the identity.

    ``kv_tile=None`` differentiates :func:`fa_plain`: every row visits every
    key, so a row whose keys are all masked averages v over all T keys.
    ``kv_tile=KV_TILE[dtype]`` differentiates the CUDA forward kernel,
    which skips each kv tile of that many rows that no row of a 64-row q
    group can see, and counts the padding slots past T of a visited tile
    in l; the two differ only on rows whose every key is masked.
    """
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    g = H // Hkv
    dev, f32 = q.device, torch.float32
    scale = D ** -0.5
    if stats is None:
        stats = fa_stats_plain(q, k, causal=causal, window=window,
                               q_offset=q_offset, kv_tile=kv_tile)
    stats = stats.reshape(2, B, Hkv, g, S, 1)
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]    # (B,Hkv,1,T,D)
    dk = torch.zeros((B, Hkv, T, D), dtype=f32, device=dev)
    dv = torch.zeros((B, Hkv, T, D), dtype=f32, device=dev)
    dq = torch.empty((B, H, S, D), dtype=f32, device=dev)
    for r0, n, s, mask, _ in _row_blocks(q, k, causal=causal, window=window,
                                         q_offset=q_offset, kv_tile=kv_tile):
        m, inv_l = stats[0, ..., r0:r0 + n, :], stats[1, ..., r0:r0 + n, :]
        qc = q[:, :, r0:r0 + n].float().reshape(B, Hkv, g, n, D)
        dc = do[:, :, r0:r0 + n].float().reshape(B, Hkv, g, n, D)
        oc = o[:, :, r0:r0 + n].float().reshape(B, Hkv, g, n, D)
        delta = (dc * oc).sum(-1, keepdim=True)
        p = torch.exp2(s - m) * inv_l
        dv += (p.transpose(-1, -2) @ dc).sum(dim=2)
        ds = torch.where(mask, p * (dc @ vf.transpose(-1, -2) - delta), 0.0)
        dk += (ds.transpose(-1, -2) @ qc).sum(dim=2) * scale
        dq[:, :, r0:r0 + n] = (ds @ kf).reshape(B, H, n, D) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def tma_problem(name: str, shape, strides, dtype: torch.dtype,
                offset: int) -> Optional[str]:
    """Why the bfloat16 kernel's TMA loads cannot read a (B, H, rows, D)
    tensor of this shape, element strides, dtype and element offset into its
    storage (whose base the allocator aligns), or None if they can.

    TMA takes bfloat16 with a unit last axis, a start on a 16-byte boundary
    and strides that are multiples of 16 bytes below 2**40 on every other
    axis; an axis of size 1 is never stepped along, so its stride does not
    matter.
    """
    if dtype != torch.bfloat16:
        return f"{name} is {dtype}; the TMA loads take bfloat16"
    if shape[3] > 1 and strides[3] != 1:
        return f"{name}.stride(3) = {strides[3]}: the last axis must be unit"
    if offset * 2 % 16:
        return (f"{name} starts {offset} elements ({offset * 2} bytes) into "
                f"its storage, not on a 16-byte boundary as TMA requires")
    for axis in range(3):
        nbytes = strides[axis] * 2
        if shape[axis] > 1 and (nbytes % 16 or nbytes >= 2 ** 40):
            return (f"{name}.stride({axis}) = {strides[axis]} elements = "
                    f"{nbytes} bytes: TMA needs a multiple of 16 bytes "
                    f"below 2**40")
    return None


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    from ._build import load
    lib = load("flash_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fa_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i,
                              ctypes.POINTER(ctypes.c_longlong), f, i, i, i, p]
    lib.fa_launch.restype = i
    lib.fa_error_string.argtypes = [i]
    lib.fa_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=1)
def _bwd_lib() -> ctypes.CDLL:
    from ._build import load
    lib = load("flash_attention_bwd")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fa_bwd_launch.argtypes = [p] * 10 + [i] * 7 + [
        ctypes.POINTER(ctypes.c_longlong), f, i, i, i, i, p]
    lib.fa_bwd_launch.restype = i
    lib.fa_bwd_error_string.argtypes = [i]
    lib.fa_bwd_error_string.restype = ctypes.c_char_p
    return lib


class FlashAttentionFn(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient.  It
    saves q, k, v, the output and, in bfloat16, each row's softmax
    statistics as the forward kernel wrote them (float32: None; its
    backward recomputes them).  All go through ``save_for_backward``, so a
    non-reentrant ``torch.utils.checkpoint`` drops them with the layer and
    recomputes them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        stats = _empty_stats(q) if q.dtype == torch.bfloat16 else None
        out = _fa_launch(q, k, v, causal, window, q_offset, stats=stats)
        ctx.save_for_backward(q, k, v, out, stats)
        ctx.args = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, stats = ctx.saved_tensors
        causal, window, q_offset = ctx.args
        dq, dk, dv = fa_backward(q, k, v, out, do, causal=causal,
                                 window=window, q_offset=q_offset, stats=stats)
        return dq, dk, dv, None, None, None


def fa_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                o: torch.Tensor, do: torch.Tensor, *, causal: bool = True,
                window: Optional[int] = None, q_offset: int = 0,
                stats: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` with output ``o`` and
    output gradient ``do``, by the CUDA backward kernels: one launch (three
    kernels) on the current stream, no synchronise.  The gradients come
    back in q's, k's and v's dtypes and layouts.

    bfloat16 (the wgmma kernels) needs ``stats``, the softmax statistics
    that :func:`fa_forward_with_stats` returns beside ``o``, and q, k, v
    in layouts TMA takes (:func:`tma_problem`, else ``ValueError``); ``o``
    and ``do`` are copied where TMA cannot take them.  float32 (the SIMT
    kernels) recomputes the statistics and refuses ``stats``; ``do`` may
    have any strides (it is copied if its last axis is not unit)."""
    _check(q, k, v)
    if q.dtype == torch.bfloat16 and stats is None:
        raise ValueError("the bfloat16 backward kernel reads the softmax "
                         "statistics of the forward: pass stats= as "
                         "fa_forward_with_stats returns them")
    if q.dtype != torch.bfloat16 and stats is not None:
        raise ValueError(f"the {q.dtype} backward kernels recompute the "
                         f"softmax statistics: stats= is for bfloat16 only")
    if q.device.type != "cuda":
        raise ValueError(f"the flash-attention backward kernel runs on CUDA, "
                         f"not {q.device}; use fa_backward_plain")
    if o.shape != q.shape or do.shape != q.shape or not (
            o.dtype == do.dtype == q.dtype) or o.device != q.device \
            or do.device != q.device:
        raise ValueError(f"o and do must be {tuple(q.shape)} {q.dtype} on "
                         f"{q.device}")
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16:
        if stats.shape != (2, B * H * S) or stats.dtype != torch.float32 \
                or stats.device != q.device or not stats.is_contiguous():
            raise ValueError(f"stats must be a contiguous (2, {B * H * S}) "
                             f"float32 tensor on {q.device}, as "
                             f"fa_forward_with_stats returns it")
        _require_tma(q, k, v)
        o, do = (t if _tma_reason(n, t) is None else
                 t.clone(memory_format=torch.contiguous_format)
                 for n, t in (("o", o), ("do", do)))
        delta = torch.empty(B * H * S, dtype=torch.float32, device=q.device)
    else:
        if o.stride(-1) != 1:
            raise ValueError("o needs a unit stride on the last axis")
        if do.stride(-1) != 1:
            do = do.contiguous()
        stats = torch.empty((3, B * H * S), dtype=torch.float32, device=q.device)
        delta = None
    dq, dk, dv = (_like(t) for t in (q, k, v))
    strides = (ctypes.c_longlong * 24)(*_strides(q, k, v, o, do, dq, dk, dv))
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fa_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            stats.data_ptr(), None if delta is None else delta.data_ptr(),
            _DTYPES[q.dtype], B, H, Hkv, S, T, D, strides, float(D ** -0.5),
            int(causal), 0 if window is None else int(window), int(q_offset),
            KV_TILE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"fa_bwd_launch failed: {_what(err)} "
                           f"({lib.fa_bwd_error_string(err).decode()})")
    _count_launch(backward=True)
    return dq, dk, dv


def _like(t: torch.Tensor) -> torch.Tensor:
    """An empty tensor in ``t``'s layout (a (B,S,H,D) view stays one)."""
    out = torch.empty_like(t)
    return out if out.stride(-1) == 1 else torch.empty(
        t.shape, dtype=t.dtype, device=t.device)


def _check(q, k, v) -> None:
    """Raise on inputs that neither the kernels nor the plain version take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be 4-d, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if k.shape != (B, Hkv, T, D) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k/v {tuple(k.shape)}/"
                         f"{tuple(v.shape)} must be (B,H,S,D) and "
                         f"(B,Hkv,T,D) with H % Hkv == 0")
    if S == 0 or T == 0:
        raise ValueError("S and T must be at least 1")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must share a device")
    if q.device.type == "cpu":
        return
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for {q.device}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a unit stride on the last axis")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """softmax(q·kᵀ·D^-0.5 + mask)·v.

    q (B,H,S,D); k, v (B,Hkv,T,D) with H % Hkv == 0, one dtype (float32 or
    bfloat16), one device; any strides with a unit last axis.  ``q_offset``
    is the absolute position of q's row 0 against k's row 0.  Returns
    (B,H,S,D) in q's dtype, laid out like q.  On CUDA the kernel runs on
    the current stream and does not synchronise; with grad mode on and an
    input that requires grad it runs through :class:`FlashAttentionFn`.
    """
    _check(q, k, v)
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if q.device.type == "cpu":
        return fa_plain(q, k, v, causal=causal, window=window,
                        q_offset=q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, causal, window, q_offset)
    return _fa_launch(q, k, v, causal, window, q_offset)


def fa_forward_with_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: Optional[int] = None,
                          q_offset: int = 0):
    """``(flash_attention(q, k, v), stats)`` without autograd: ``stats`` is
    the (2, B·H·S) float32 tensor of each row's m (base 2) and 1/l that
    :func:`fa_backward` needs in bfloat16 (:func:`fa_stats_plain` has the
    layout).  On CUDA one launch of the bfloat16 kernel, which writes them
    in its epilogue (the float32 kernel writes none: ``ValueError``); on
    the CPU :func:`fa_plain` and :func:`fa_stats_plain` over every key."""
    _check(q, k, v)
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if q.device.type == "cpu":
        return (fa_plain(q, k, v, causal=causal, window=window,
                         q_offset=q_offset),
                fa_stats_plain(q, k, causal=causal, window=window,
                               q_offset=q_offset))
    if q.dtype != torch.bfloat16:
        raise ValueError(f"only the bfloat16 kernel writes the softmax "
                         f"statistics, not the {q.dtype} one")
    stats = _empty_stats(q)
    return _fa_launch(q, k, v, causal, window, q_offset, stats=stats), stats


def _empty_stats(q: torch.Tensor) -> torch.Tensor:
    B, H, S, _ = q.shape
    return torch.empty((2, B * H * S), dtype=torch.float32, device=q.device)


def _tma_reason(name: str, t: torch.Tensor) -> Optional[str]:
    """Why TMA cannot load the bfloat16 tensor ``t`` as it lies, or None."""
    why = tma_problem(name, t.shape, t.stride(), t.dtype, t.storage_offset())
    if why is None and t.data_ptr() % 16:
        why = f"{name} at {t.data_ptr():#x} is not 16-byte aligned"
    return why


def _require_tma(q, k, v) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        why = _tma_reason(name, t)
        if why is not None:
            raise ValueError(why)


def _strides(*tensors):
    """The (batch, head, row) element strides of each tensor in turn; an
    axis of size 1 is never stepped along: give it a stride TMA takes."""
    return [st if n > 1 else 8 for t in tensors
            for st, n in zip(t.stride()[:3], t.shape[:3])]


def _what(err: int) -> str:
    return (f"CUDA error {err}" if err < 1000 else
            f"CUresult {err - 1000} encoding a tensor map")


def _fa_launch(q, k, v, causal, window, q_offset, stats=None) -> torch.Tensor:
    """One forward launch on inputs that ``_check`` passed, on CUDA; with
    ``stats`` (bfloat16 only, (2, B·H·S) float32) the kernel also writes
    each row's m and 1/l there."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if q.dtype == torch.bfloat16:
        _require_tma(q, k, v)

    out = _like(q)
    strides = (ctypes.c_longlong * 12)(*_strides(q, k, v, out))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fa_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(),
                            None if stats is None else stats.data_ptr(),
                            _DTYPES[q.dtype], B, H, Hkv, S, T, D, strides,
                            float(D ** -0.5), int(causal),
                            0 if window is None else int(window),
                            int(q_offset), stream)
    if err != 0:
        raise RuntimeError(f"fa_launch failed: {_what(err)} "
                           f"({lib.fa_error_string(err).decode()})")
    _count_launch()
    return out
