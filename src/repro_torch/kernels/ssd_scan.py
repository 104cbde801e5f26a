"""Mamba2 SSD chunked scan: the CUDA kernels' wrappers and their plain
PyTorch versions.

Counterpart of ``repro.kernels.ssd_scan`` (the Pallas TPU kernel
``_ssd_kernel`` behind ``ssd_scan``) and of the chunked form
``repro.models.ssm.ssd_chunked``, whose contract it takes: an optional
initial state ``h0`` and a ``compute_dtype`` for the intra-chunk products.
:func:`ssd_scan` launches the hand-written kernels in ``csrc/ssd_scan.cu``
on CUDA tensors (five passes of the chunk-parallel decomposition, on the
current stream: cumsum, C·Bᵀ, chunk states, the inter-chunk pass, y) and
counts one launch per call; on CPU tensors it runs :func:`ssd_plain`.
There is no fallback from the kernels to the plain version.

With grad mode on and an input that requires grad, a CUDA call goes
through :class:`SsdScanFn`, whose backward is the hand-written kernels of
``csrc/ssd_scan_bwd.cu`` (:func:`ssd_backward`, eight kernels counted as
one backward launch, their products on the tensor cores as 3xTF32, whose
operand split :func:`tf32_split` states in PyTorch); it saves the forward's scratch (cs, CBᵀ and the
state entering each chunk) for them.  A CPU call runs :func:`ssd_plain`
under autograd.  :func:`ssd_backward_plain` is the backward's plain
version.  The JAX package has no backward kernel: XLA differentiates the
model's ``ssd_chunked`` there.

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

__all__ = ["ssd_scan", "ssd_plain", "ssd_backward_plain", "ssd_backward",
           "ssd_forward_with_scratch", "SsdScanFn", "segsum", "launch_count",
           "bwd_launch_count", "reset_launch_count", "tf32_split",
           "backward_kernel_configs", "BWD_KERNELS", "MAX_P", "MAX_N",
           "MAX_CHUNK"]

MAX_P, MAX_N, MAX_CHUNK = 64, 128, 1024      # the kernels' limits
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_COMPUTE = (torch.float32, torch.bfloat16)

LAUNCHES = 0         # forward calls on CUDA since the last reset (5 kernels each)
BWD_LAUNCHES = 0     # backward calls on CUDA since then (8 kernels each)
# The backward's kernels, in launch order (csrc/ssd_scan_bwd.cu).
BWD_KERNELS = ("ssd_bwd_ds_kernel", "ssd_bwd_ds_sum_kernel", "ssd_bwd_state_kernel",
               "ssd_bwd_pass_kernel", "ssd_bwd_bc_heads_kernel", "ssd_bwd_bc_kernel",
               "ssd_bwd_dx_kernel", "ssd_bwd_cumsum_kernel")
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


def tf32_split(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 ``a`` as ``hi + lo``, both TF32 values (10 explicit mantissa
    bits), as the backward kernels split an operand before its tensor-core
    products: ``hi`` rounds ``a`` to nearest with ties away from zero
    (``cvt.rna.tf32.f32``), ``lo`` rounds ``a - hi`` (exact in f32) the same
    way.  A product of two split operands summed as hi·hi + hi·lo + lo·hi
    (3xTF32) misses only lo·lo, 2^-22 of |a·b|.  Non-finite values pass
    through as ``hi`` with a zero ``lo``."""
    def rna(v):
        bits = v.contiguous().view(torch.int32)
        r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
        return torch.where(torch.isfinite(v), r, v)
    a = a.to(torch.float32)
    hi = rna(a)
    lo = torch.where(torch.isfinite(a), rna(a - hi), torch.zeros_like(a))
    return hi, lo


def segsum(dA: torch.Tensor) -> torch.Tensor:
    """(b,l,h) → (b,h,l,l) lower-triangular cumulative log-decay."""
    l = dA.shape[1]
    cs = torch.cumsum(dA.transpose(1, 2), dim=-1)              # (b,h,l)
    seg = cs[..., :, None] - cs[..., None, :]                  # sum_{j<k<=i}
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=dA.device))
    return torch.where(mask, seg, -torch.inf)


def _chunked(x, dt, A, B, C, chunk, h0, compute_dtype):
    """The inputs cut into chunks in the working dtype (float64 for the
    witness, else f32): (l, nc, wd, x, dt, A, B, C, h0), x (b,nc,l,h,p), dt
    (b,nc,l,h), B/C (b,nc,l,n), h0 (b,h,p,n) zeros if None."""
    b, t, h, p = x.shape
    n = B.shape[-1]
    l = min(chunk, t)
    nc = t // l
    wd = torch.float64 if compute_dtype == torch.float64 else torch.float32
    h0 = (torch.zeros((b, h, p, n), dtype=wd, device=x.device)
          if h0 is None else h0.to(wd))
    return (l, nc, wd, x.reshape(b, nc, l, h, p).to(wd),
            dt.reshape(b, nc, l, h).to(wd), A.to(wd),
            B.reshape(b, nc, l, n).to(wd), C.reshape(b, nc, l, n).to(wd), h0)


def ssd_plain(x, dt, A, B, C, chunk: int, h0=None,
              compute_dtype: torch.dtype = torch.float32
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b,t,h,p), dt (b,t,h), A (h,), B/C (b,t,n); t % min(chunk, t) == 0.
    Returns y (b,t,h,p) and the final state (b,h,p,n), f32; float64 when
    ``compute_dtype`` is float64, which evaluates every step in float64."""
    b, t, h, p = x.shape
    cd = compute_dtype
    l, nc, wd, xr, dtr, A, Br, Cr, h_prev = _chunked(x, dt, A, B, C, chunk,
                                                    h0, cd)
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


def ssd_backward_plain(x, dt, A, B, C, chunk: int, dy, dh_final=None, h0=None,
                       compute_dtype: torch.dtype = torch.float32):
    """(dx, ddt, dA, dB, dC, dh0) of :func:`ssd_plain` for the output
    gradient ``dy`` (b,t,h,p) and the final state's ``dh_final`` (b,h,p,n;
    None is zero): the backward kernels' decomposition in eager PyTorch,
    not autograd.  dh0 is None without ``h0``.  dx, dB and dC come back in
    their inputs' dtypes, ddt, dA and dh0 in f32; with ``compute_dtype``
    float64 every step runs, and every gradient comes back, in float64.

    Per chunk and head, with a = dt·A, cs = cumsum(a), u = dt·x,
    G_ij = (C_i·B_j)·exp(cs_i − cs_j) for j ≤ i, h_in the state entering
    the chunk and g the gradient of the state leaving it:
      reverse pass: g of chunk c−1 = exp(cs_L)·g + Σ_i exp(cs_i)·dy_i ⊗ C_i,
        from dh_final; dh0 is that sum once more for chunk 0;
      du_j = Σ_{i≥j} G_ij·dy_i + exp(cs_L − cs_j)·(g B_j); dx = dt·du,
        ddt gets x·du summed over p;
      dS_ij = Σ_h exp(cs_i − cs_j)·(dy_i·u_j) (j ≤ i), dC_i = Σ_j dS_ij B_j
        + Σ_h exp(cs_i)·(h_inᵀ dy_i), dB_j = Σ_i dS_ij C_i
        + Σ_h exp(cs_L − cs_j)·(gᵀ u_j);
      dcs: G ∘ (dy·uᵀ) by rows to i and by columns from j, exp(cs_i)·
        dy_i·(h_in C_i) to i, the state terms to cs_L and from each j,
        exp(cs_L)·⟨g, h_in⟩ to cs_L; da is its reverse cumulative sum,
        ddt gets A·da and dA = Σ dt·da.
    With bf16 ``compute_dtype`` the products read the forward's rounded
    operands (C·Bᵀ, the gated scores, dt·x) and the cotangents pass through
    the casts unrounded."""
    b, t, h, p = x.shape
    cd = compute_dtype
    l, nc, wd, xr, dtr, Af, Br, Cr, hs = _chunked(x, dt, A, B, C, chunk, h0, cd)
    dyr = dy.reshape(b, nc, l, h, p).to(wd)
    cs = torch.cumsum(dtr * Af, dim=2)                          # (b,nc,l,h)
    h_in = []                                                   # entering each chunk
    for c in range(nc):
        h_in.append(hs)
        e_end = torch.exp(cs[:, c, -1:] - cs[:, c])             # (b,l,h)
        hs = hs * torch.exp(cs[:, c, -1])[..., None, None] + torch.einsum(
            "bln,blh,blhp->bhpn", Br[:, c], e_end * dtr[:, c], xr[:, c])
    g = (torch.zeros_like(hs) if dh_final is None else dh_final.to(wd))
    g_out = [None] * nc                                         # leaving each chunk
    for c in reversed(range(nc)):
        g_out[c] = g
        g = g * torch.exp(cs[:, c, -1])[..., None, None] + torch.einsum(
            "blh,blhp,bln->bhpn", torch.exp(cs[:, c]), dyr[:, c], Cr[:, c])
    dxs, ddts, dBs, dCs = [], [], [], []
    dA = torch.zeros_like(Af)
    for c in range(nc):
        xc, dtc, Bc, Cc, dyc = xr[:, c], dtr[:, c], Br[:, c], Cr[:, c], dyr[:, c]
        csc, hin, gc = cs[:, c], h_in[c], g_out[c]
        L = torch.exp(segsum(dtc * Af))                         # (b,h,i,j)
        S = torch.einsum("bln,bsn->bls", Cc.to(cd), Bc.to(cd)).to(wd)
        Q = S[:, None] * L                                      # gated, unrounded
        G = Q.to(cd).to(wd)
        u = xc * dtc[..., None]                                 # (b,l,h,p)
        dG = torch.einsum("bihp,bjhp->bhij", dyc, u.to(cd).to(wd))
        dS = (dG * L).sum(1)                                    # (b,i,j)
        W = Q * dG
        e_end = torch.exp(csc[:, -1:] - csc)                    # (b,l,h)
        gB = torch.einsum("bhpn,bjn->bjhp", gc, Bc)
        du = torch.einsum("bhij,bihp->bjhp", G, dyc) + e_end[..., None] * gB
        v = torch.exp(csc)[..., None] * torch.einsum("bhpn,bihp->bihn", hin, dyc)
        dCs.append(torch.einsum("bij,bjn->bin", dS, Bc.to(cd).to(wd)) + v.sum(2))
        dBs.append(torch.einsum("bij,bin->bjn", dS, Cc.to(cd).to(wd))
                   + torch.einsum("bjh,bhpn,bjhp->bjn", e_end, gc, u))
        s = e_end * (u * gB).sum(-1)                            # (b,l,h)
        dcs = (W.sum(3) - W.sum(2)).transpose(1, 2) \
            + torch.einsum("bihn,bin->bih", v, Cc) - s
        dcs[:, -1] += s.sum(1) + torch.exp(csc[:, -1]) * (gc * hin).sum((-1, -2))
        da = torch.flip(torch.cumsum(torch.flip(dcs, (1,)), 1), (1,))
        dxs.append(dtc[..., None] * du)
        ddts.append((xc * du).sum(-1) + Af * da)
        dA = dA + (dtc * da).sum((0, 1))
    f32 = wd if wd == torch.float64 else torch.float32

    def out(parts, like):
        r = torch.stack(parts, 1).reshape(like.shape)
        return r if wd == torch.float64 else r.to(like.dtype)

    return (out(dxs, x), out(ddts, dt).to(f32), dA.to(f32), out(dBs, B),
            out(dCs, C), None if h0 is None else g.to(f32))


def _check(x, dt, A, B, C, h0, chunk, compute_dtype) -> int:
    """Raise on inputs that neither the kernels nor the plain version take;
    return the chunk ``min(chunk, T)``."""
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
    return l


def _check_kernel(x, dt, A, B, C, h0, l) -> None:
    """Raise on CUDA inputs that the kernels do not take."""
    if x.device.type != "cuda":
        raise ValueError(f"no SSD kernel for {x.device}")
    if x.dtype not in _DTYPES or not (x.dtype == B.dtype == C.dtype):
        raise TypeError(f"x, B, C must share float32 or bfloat16, got "
                        f"{x.dtype}, {B.dtype}, {C.dtype}")
    if any(t.dtype != torch.float32 for t in [dt, A] + ([] if h0 is None else [h0])):
        raise TypeError("dt, A and h0 must be float32")
    P, N = x.shape[3], B.shape[2]
    if P > MAX_P or N > MAX_N or l > MAX_CHUNK:
        raise ValueError(f"P={P}, N={N}, chunk={l} exceed the kernel's "
                         f"limits P<={MAX_P}, N<={MAX_N}, chunk<={MAX_CHUNK}")
    tensors = [x, dt, A, B, C] + ([] if h0 is None else [h0])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x, dt, A, B, C and h0 must be contiguous")


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


def _bind_bwd(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a library built from ``ssd_scan_bwd.cu``
    (also used for variants of that source built elsewhere)."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssd_bwd_launch.argtypes = [p] * 17 + [i] * 8 + [p]
    lib.ssd_bwd_launch.restype = i
    lib.ssd_bwd_workspace_floats.argtypes = [i] * 6
    lib.ssd_bwd_workspace_floats.restype = ctypes.c_longlong
    lib.ssd_bwd_kernel_configs.argtypes = [i] * 7 + [p]
    lib.ssd_bwd_kernel_configs.restype = i
    lib.ssd_bwd_error_string.argtypes = [i]
    lib.ssd_bwd_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=1)
def _bwd_lib() -> ctypes.CDLL:
    from ._build import load
    return _bind_bwd(load("ssd_scan_bwd"))


def _ssd_launch(x, dt, A, B, C, h0, l, compute_dtype):
    """One forward launch (five kernels) on inputs that ``_check_kernel``
    passed.  Returns (y, h, scratch): the scratch (cs (b,H,nc,l) f64,
    CBᵀ (b,nc,l,l) f32, st (b,nc,H,N,P) f32, which pass 4 leaves holding
    the state entering each chunk) is what the backward kernels read."""
    b, T, H, P = x.shape
    N = B.shape[-1]
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
    return y, hout, (cs, cbt, st)


class SsdScanFn(torch.autograd.Function):
    """The forward kernels, with the backward kernels as their gradient.
    It saves the inputs and the forward's scratch (cs, CBᵀ and the state
    entering each chunk) with ``save_for_backward``, so a non-reentrant
    ``torch.utils.checkpoint`` drops them with the layer and recomputes
    them.  ``h0`` may be None; ``chunk`` is already ``min(chunk, T)``.  An
    output that the loss does not use gets a None gradient, not zeros (the
    model's train step never uses the final state)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, h0, chunk, compute_dtype):
        y, hout, scratch = _ssd_launch(x, dt, A, B, C, h0, chunk, compute_dtype)
        ctx.save_for_backward(x, dt, A, B, C, h0, *scratch)
        ctx.args = (chunk, compute_dtype)
        ctx.set_materialize_grads(False)
        return y, hout

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, B, C, h0, *scratch = ctx.saved_tensors
        chunk, compute_dtype = ctx.args
        dy = torch.zeros_like(x, dtype=torch.float32) if dy is None \
            else dy.contiguous()
        dx, ddt, dA, dB, dC, dh0 = ssd_backward(
            x, dt, A, B, C, chunk, dy, tuple(scratch),
            dh_final=None if dh is None else dh.contiguous(), h0=h0,
            compute_dtype=compute_dtype)
        return dx, ddt, dA, dB, dC, dh0, None, None


def backward_kernel_configs(b: int, T: int, H: int, P: int, N: int,
                            chunk: int, dtype: torch.dtype = torch.float32):
    """``[(name, grid, block, dynamic shared bytes)]`` of each kernel that
    :func:`ssd_backward` launches for these shapes and x's ``dtype``, in
    launch order.  Builds the CUDA library (needs nvcc)."""
    l = min(chunk, T)
    out = (ctypes.c_longlong * (3 * len(BWD_KERNELS)))()
    n = _bwd_lib().ssd_bwd_kernel_configs(b, T, H, P, N, l, _DTYPES[dtype],
                                         out)
    if n != len(BWD_KERNELS):
        raise ValueError(f"no SSD backward launch for {(b, T, H, P, N, l)}")
    return [(name, out[3 * k], out[3 * k + 1], out[3 * k + 2])
            for k, name in enumerate(BWD_KERNELS)]


def ssd_forward_with_scratch(x, dt, A, B, C, *, chunk: int = 256,
                             h0: Optional[torch.Tensor] = None,
                             compute_dtype: torch.dtype = torch.float32):
    """``(y, h, scratch)`` without autograd, on CUDA: one forward launch,
    whose scratch (cs, CBᵀ, the states entering each chunk) is what
    :func:`ssd_backward` takes."""
    l = _check(x, dt, A, B, C, h0, chunk, compute_dtype)
    _check_kernel(x, dt, A, B, C, h0, l)
    return _ssd_launch(x, dt, A, B, C, h0, l, compute_dtype)


def ssd_backward(x, dt, A, B, C, chunk: int, dy, scratch, *,
                 dh_final: Optional[torch.Tensor] = None,
                 h0: Optional[torch.Tensor] = None,
                 compute_dtype: torch.dtype = torch.float32):
    """(dx, ddt, dA, dB, dC, dh0) of ``ssd_scan`` by the CUDA backward
    kernels: one launch (eight kernels) on the current stream, no
    synchronise, no atomics (two calls give the same bits).  ``scratch`` is
    the forward's, as :func:`ssd_forward_with_scratch` returns it; dy
    (b,T,H,P) and dh_final (b,H,P,N; None is zero) are contiguous f32.
    dx, dB, dC come back in x's dtype, ddt, dA and dh0 (None without h0)
    in f32; :func:`ssd_backward_plain` is the same function in eager
    PyTorch."""
    l = _check(x, dt, A, B, C, h0, chunk, compute_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"the SSD backward kernel runs on CUDA, not "
                         f"{x.device}; use ssd_backward_plain")
    _check_kernel(x, dt, A, B, C, h0, l)
    b, T, H, P = x.shape
    N = B.shape[-1]
    nc = T // l
    for name, t, shape in (("dy", dy, (b, T, H, P)),
                           ("dh_final", dh_final, (b, H, P, N))):
        if t is not None and (t.shape != shape or t.dtype != torch.float32
                              or t.device != x.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {shape} float32 "
                             f"tensor on {x.device}")
    cs, cbt, st = scratch
    if cs.shape != (b, H, nc, l) or cs.dtype != torch.float64 or \
            cbt.shape != (b, nc, l, l) or st.shape != (b, nc, H, N, P):
        raise ValueError("scratch must be the forward's (cs, cbt, st), as "
                         "ssd_forward_with_scratch returns it")
    f32 = dict(dtype=torch.float32, device=x.device)
    dx, dB, dC = torch.empty_like(x), torch.empty_like(B), torch.empty_like(C)
    ddt = torch.empty((b, T, H), **f32)
    dA = torch.empty((H,), **f32)
    dh0 = None if h0 is None else torch.empty((b, H, P, N), **f32)
    lib = _bwd_lib()
    work = torch.empty(lib.ssd_bwd_workspace_floats(b, T, H, P, N, l), **f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ssd_bwd_launch(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), cs.data_ptr(), cbt.data_ptr(), st.data_ptr(),
            dy.data_ptr(), None if dh_final is None else dh_final.data_ptr(),
            dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
            dC.data_ptr(), work.data_ptr(), None if dh0 is None else dh0.data_ptr(),
            _DTYPES[x.dtype], int(compute_dtype == torch.bfloat16), b, T, H, P,
            N, l, stream)
    if err != 0:
        raise RuntimeError(f"ssd_bwd_launch failed: CUDA error {err} "
                           f"({lib.ssd_bwd_error_string(err).decode()})")
    _count_launch(backward=True)
    return dx, ddt, dA, dB, dC, dh0


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
    in f32) comes from ``torch.empty`` here.  With grad mode on and an
    input that requires grad, a CUDA call runs through :class:`SsdScanFn`,
    whose backward is the kernels of ``csrc/ssd_scan_bwd.cu``.
    """
    l = _check(x, dt, A, B, C, h0, chunk, compute_dtype)
    if x.device.type == "cpu":
        return ssd_plain(x, dt, A, B, C, l, h0=h0, compute_dtype=compute_dtype)
    _check_kernel(x, dt, A, B, C, h0, l)
    tensors = [x, dt, A, B, C] + ([] if h0 is None else [h0])
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return SsdScanFn.apply(x, dt, A, B, C, h0, l, compute_dtype)
    y, hout, _ = _ssd_launch(x, dt, A, B, C, h0, l, compute_dtype)
    return y, hout
