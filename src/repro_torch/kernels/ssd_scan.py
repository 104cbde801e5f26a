"""Mamba2 SSD chunked scan: the CUDA kernel's wrapper and its plain PyTorch
version.

Counterpart of ``repro.kernels.ssd_scan`` (the Pallas TPU kernel
``_ssd_kernel`` behind ``ssd_scan``) and of the chunked form
``repro.models.ssm.ssd_chunked``, whose contract it takes: an optional
initial state ``h0`` and a ``compute_dtype`` for the intra-chunk products.
:func:`ssd_scan` launches the hand-written kernels in ``csrc/ssd_scan.cu``
on CUDA tensors (five passes of the chunk-parallel decomposition, on the
current stream: cumsum, C·Bᵀ, chunk states, the inter-chunk pass, y) and
counts one launch per call; on CPU tensors it runs :func:`ssd_plain`.
There is no fallback from the kernels to the plain version.

:func:`ssd_plain` is ``ssd_chunked`` in eager PyTorch: every input cast to
f32, a Python loop over chunks carrying the (b, H, P, N) f32 state, the
decay matrix built whole per chunk.  With ``compute_dtype=torch.float64``
it evaluates the same steps wholly in float64: the witness against which
f32 forms are judged where the f32 cumulative log-decays drift (at chunk
1024 with steep decays they reach -1e3, where each f32 step rounds by
~3e-5).  The kernels sum cs in float64 and hold that witness; the f32
form here, the reference's, does not (tests/test_torch_ssm.py).
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch

__all__ = ["ssd_scan", "ssd_plain", "segsum", "launch_count",
           "reset_launch_count", "MAX_P", "MAX_N", "MAX_CHUNK"]

MAX_P, MAX_N, MAX_CHUNK = 64, 128, 1024      # the kernel's limits
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_COMPUTE = (torch.float32, torch.bfloat16)

LAUNCHES = 0         # ssd_scan calls on CUDA since the last reset (5 kernels each)
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


def segsum(dA: torch.Tensor) -> torch.Tensor:
    """(b,l,h) → (b,h,l,l) lower-triangular cumulative log-decay."""
    l = dA.shape[1]
    cs = torch.cumsum(dA.transpose(1, 2), dim=-1)              # (b,h,l)
    seg = cs[..., :, None] - cs[..., None, :]                  # sum_{j<k<=i}
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=dA.device))
    return torch.where(mask, seg, -torch.inf)


def ssd_plain(x, dt, A, B, C, chunk: int, h0=None,
              compute_dtype: torch.dtype = torch.float32
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b,t,h,p), dt (b,t,h), A (h,), B/C (b,t,n); t % min(chunk, t) == 0.
    Returns y (b,t,h,p) and the final state (b,h,p,n), f32; float64 when
    ``compute_dtype`` is float64, which evaluates every step in float64."""
    b, t, h, p = x.shape
    n = B.shape[-1]
    l = min(chunk, t)
    nc = t // l
    cd = compute_dtype
    wd = torch.float64 if cd == torch.float64 else torch.float32   # working dtype
    xr = x.reshape(b, nc, l, h, p).to(wd)
    dtr = dt.reshape(b, nc, l, h).to(wd)
    Br = B.reshape(b, nc, l, n).to(wd)
    Cr = C.reshape(b, nc, l, n).to(wd)
    A = A.to(wd)
    h_prev = (torch.zeros((b, h, p, n), dtype=wd, device=x.device)
              if h0 is None else h0.to(wd))
    ys = []
    for c in range(nc):
        xc, dtc, Bc, Cc = xr[:, c], dtr[:, c], Br[:, c], Cr[:, c]
        dA = dtc * A                                            # (b,l,h)
        dA_cum = torch.cumsum(dA, dim=1)                        # (b,l,h)
        L = torch.exp(segsum(dA))                               # (b,h,l,l)
        scores = torch.einsum("bln,bsn->bls", Cc.to(cd), Bc.to(cd))
        gated = (scores.to(wd)[:, None] * L).to(cd)
        xdt = (xc * dtc[..., None]).to(cd)                      # (b,l,h,p)
        y_diag = torch.einsum("bhls,bshp->blhp", gated.to(wd), xdt.to(wd))
        state_decay = torch.exp(dA_cum)                         # (b,l,h)
        y_off = torch.einsum("bln,bhpn,blh->blhp", Cc, h_prev, state_decay)
        decay_to_end = torch.exp(dA_cum[:, -1:, :] - dA_cum)    # (b,l,h)
        states = torch.einsum("bln,blh,blhp->bhpn", Bc, decay_to_end * dtc, xc)
        h_prev = h_prev * torch.exp(dA_cum[:, -1])[..., None, None] + states
        ys.append(y_diag + y_off)
    y = torch.stack(ys, dim=1).reshape(b, t, h, p)
    return y, h_prev


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    from ._build import load
    lib = load("ssd_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_launch.argtypes = [p] * 11 + [i] * 8 + [p]
    lib.ssd_launch.restype = i
    lib.ssd_error_string.argtypes = [i]
    lib.ssd_error_string.restype = ctypes.c_char_p
    return lib


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 256,
             h0: Optional[torch.Tensor] = None,
             compute_dtype: torch.dtype = torch.float32
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD scan of ``ssd_chunked``.

    x (b,T,H,P); dt (b,T,H); A (H,); B, C (b,T,N); h0 optional (b,H,P,N).
    The chunk is ``min(chunk, T)`` and must divide T.  Returns y (b,T,H,P)
    f32 and the final state (b,H,P,N) f32.  On CUDA: x, B and C share one
    dtype (float32 or bfloat16), dt, A and h0 are float32, all contiguous;
    the five kernels run on the current stream and do not synchronise.
    Their scratch (cs in float64, CBᵀ and the chunk states (b,T/l,H,N,P)
    in f32) comes from ``torch.empty`` here.  There is no backward kernel
    yet: on CUDA, with grad mode on and an input that requires grad, it
    raises ``NotImplementedError`` rather than return a result that
    autograd cannot differentiate.
    """
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B.dim() != 3:
        raise ValueError(f"x (b,T,H,P), dt (b,T,H), A (H,), B/C (b,T,N) "
                         f"expected, got {tuple(x.shape)}, {tuple(dt.shape)},"
                         f" {tuple(A.shape)}, {tuple(B.shape)}")
    b, T, H, P = x.shape
    N = B.shape[-1]
    if dt.shape != (b, T, H) or A.shape != (H,) or B.shape != (b, T, N) \
            or C.shape != B.shape:
        raise ValueError(f"inconsistent shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}")
    if h0 is not None and h0.shape != (b, H, P, N):
        raise ValueError(f"h0 must be {(b, H, P, N)}, got {tuple(h0.shape)}")
    l = min(chunk, T)
    if l <= 0 or T % l:
        raise ValueError(f"seq {T} not divisible by chunk {l}")
    if compute_dtype not in _COMPUTE:
        raise TypeError(f"compute_dtype must be float32 or bfloat16, got "
                        f"{compute_dtype}")
    tensors = [x, dt, A, B, C] + ([] if h0 is None else [h0])
    if any(t.device != x.device for t in tensors):
        raise ValueError("x, dt, A, B, C and h0 must share a device")
    if x.device.type == "cpu":
        return ssd_plain(x, dt, A, B, C, l, h0=h0, compute_dtype=compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no SSD kernel for {x.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "ssd_scan has no backward kernel on CUDA yet (the SSD backward "
            "kernel is not written): its output would carry no gradient, so "
            "the ssm and hybrid families cannot train on the card")
    if x.dtype not in _DTYPES or not (x.dtype == B.dtype == C.dtype):
        raise TypeError(f"x, B, C must share float32 or bfloat16, got "
                        f"{x.dtype}, {B.dtype}, {C.dtype}")
    if any(t.dtype != torch.float32 for t in [dt, A] + ([] if h0 is None else [h0])):
        raise TypeError("dt, A and h0 must be float32")
    if P > MAX_P or N > MAX_N or l > MAX_CHUNK:
        raise ValueError(f"P={P}, N={N}, chunk={l} exceed the kernel's "
                         f"limits P<={MAX_P}, N<={MAX_N}, chunk<={MAX_CHUNK}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x, dt, A, B, C and h0 must be contiguous")

    nc = T // l
    f32 = dict(dtype=torch.float32, device=x.device)
    y = torch.empty((b, T, H, P), **f32)
    hout = torch.empty((b, H, P, N), **f32)
    cs = torch.empty((b, H, nc, l), dtype=torch.float64,
                     device=x.device)               # pass 1: cumsum(dt·A)
    cbt = torch.empty((b, nc, l, l), **f32)         # pass 2: (C·Bᵀ)ᵀ per chunk
    st = torch.empty((b, nc, H, N, P), **f32)       # passes 3-4: chunk states
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_launch(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                             B.data_ptr(), C.data_ptr(),
                             None if h0 is None else h0.data_ptr(),
                             y.data_ptr(), hout.data_ptr(), cs.data_ptr(),
                             cbt.data_ptr(), st.data_ptr(), _DTYPES[x.dtype],
                             int(compute_dtype == torch.bfloat16), b, T, H, P,
                             N, l, stream)
    if err != 0:
        raise RuntimeError(f"ssd_launch failed: CUDA error {err} "
                           f"({lib.ssd_error_string(err).decode()})")
    _count_launch()
    return y, hout
