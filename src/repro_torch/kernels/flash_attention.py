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

:func:`fa_plain` is the TPU kernel's arithmetic in eager PyTorch, with one
q tile of all S rows: an online softmax over kv tiles, m, l and acc in f32,
P rounded to v's dtype before P·V (accumulated in f32, as the CUDA kernel
does), masked scores at NEG = -1e9.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional

import torch

__all__ = ["flash_attention", "fa_plain", "tma_problem", "launch_count",
           "reset_launch_count", "NEG", "HEAD_DIMS"]

NEG = -1e9
HEAD_DIMS = (16, 32, 48, 64, 80, 96, 112, 128)   # the kernel's instances
_PLAIN_BK = 512      # kv rows per step of the plain version's online softmax
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES = 0         # kernel launches since the last reset
_LAUNCH_LOCK = threading.Lock()


def launch_count() -> int:
    with _LAUNCH_LOCK:
        return LAUNCHES


def reset_launch_count() -> None:
    global LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES = 0


def _count_launch() -> None:
    global LAUNCHES
    with _LAUNCH_LOCK:
        LAUNCHES += 1


def fa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             causal: bool = True, window: Optional[int] = None,
             q_offset: int = 0) -> torch.Tensor:
    """q (B,H,S,D); k/v (B,Hkv,T,D), H % Hkv == 0.  Returns (B,H,S,D) in
    q's dtype, on q's device."""
    B, H, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    g = H // Hkv
    dev = q.device
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
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.to(v.dtype).float() @ vt.float()
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, H, S, D).to(q.dtype)


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
    lib.fa_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                              ctypes.POINTER(ctypes.c_longlong), f, i, i, i, p]
    lib.fa_launch.restype = i
    lib.fa_error_string.argtypes = [i]
    lib.fa_error_string.restype = ctypes.c_char_p
    return lib


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """softmax(q·kᵀ·D^-0.5 + mask)·v.

    q (B,H,S,D); k, v (B,Hkv,T,D) with H % Hkv == 0, one dtype (float32 or
    bfloat16), one device; any strides with a unit last axis.  ``q_offset``
    is the absolute position of q's row 0 against k's row 0.  Returns
    (B,H,S,D) in q's dtype, laid out like q.  On CUDA the kernel runs on
    the current stream and does not synchronise.
    """
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
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must share a device")
    if q.device.type == "cpu":
        return fa_plain(q, k, v, causal=causal, window=window,
                        q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"no flash-attention kernel for {q.device}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must all be float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a unit stride on the last axis")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            why = tma_problem(name, t.shape, t.stride(), t.dtype,
                              t.storage_offset())
            if why is None and t.data_ptr() % 16:
                why = f"{name} at {t.data_ptr():#x} is not 16-byte aligned"
            if why is not None:
                raise ValueError(why)

    out = torch.empty_like(q)            # q's layout (a (B,S,H,D) view stays one)
    if out.stride(-1) != 1:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    # an axis of size 1 is never stepped along: give it a stride TMA takes
    strides = (ctypes.c_longlong * 12)(*[
        st if n > 1 else 8 for t in (q, k, v, out)
        for st, n in zip(t.stride()[:3], t.shape[:3])])
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fa_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            out.data_ptr(), _DTYPES[q.dtype], B, H, Hkv, S,
                            T, D, strides, float(D ** -0.5), int(causal),
                            0 if window is None else int(window),
                            int(q_offset), stream)
    if err != 0:
        what = (f"CUDA error {err}" if err < 1000 else
                f"CUresult {err - 1000} encoding a tensor map")
        raise RuntimeError(f"fa_launch failed: {what} "
                           f"({lib.fa_error_string(err).decode()})")
    _count_launch()
    return out
