"""Smith-Waterman local alignment: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of ``repro.kernels.smith_waterman`` (the Pallas TPU kernel
``_sw_kernel`` behind ``sw_pallas``).  :func:`sw_batch` scores one query
profile against a batch of subjects: on a CUDA tensor it launches the
hand-written kernel in ``csrc/smith_waterman.cu`` and counts the launch; on
a CPU tensor it runs :func:`sw_plain`.  There is no fallback from the
kernel to the plain version.  :func:`pack_subjects` builds its input: a
database search hands it a chunk of subjects per launch.

:func:`sw_plain` is eager PyTorch on whatever device its inputs are on, with
the kernel's arithmetic: F in closed form, an exclusive prefix-max of
``h_hat + i*ge`` over the query axis through ``torch.cummax``.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Any, Optional, Sequence, Tuple

import torch

__all__ = ["sw_batch", "sw_plain", "pack_subjects", "launch_count",
           "reset_launch_count", "DEFAULT_TILE", "MAX_QP", "NEG"]

NEG = -1e9
DEFAULT_TILE = 512   # subject chars per padding bucket
MAX_QP = 8192        # the reference's documented one-block query limit
WARP_QP = 1024       # largest Qp of the warp kernel (one warp per subject)
_MAX_SMEM = 232448   # bytes of shared memory a block may opt in to (H100)

LAUNCHES = 0         # kernel launches since the last reset
_LAUNCH_LOCK = threading.Lock()   # farm workers launch from several threads


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


def sw_plain(profile: torch.Tensor, subject: torch.Tensor, go: float,
             ge: float, q_len: int) -> torch.Tensor:
    """Best local-alignment score of ``profile`` (A, Qp) f32 against
    ``subject`` (Dp,) — or a batch (B, Dp) — of int codes; codes >= A are
    padding and skipped.  Returns a scalar, or (B,), f32 tensor on the
    profile's device."""
    A, Qp = profile.shape
    dev = profile.device
    subj = subject.to(dev).reshape(-1, subject.shape[-1]).long()
    B = subj.shape[0]
    f32 = torch.float32
    go_t = torch.tensor(go, dtype=f32, device=dev)
    ge_t = torch.tensor(ge, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    idx = torch.arange(Qp, dtype=f32, device=dev)
    qmask = idx < q_len
    idx_ge = idx * ge_t                        # idx * ge
    idx_m1_ge = (idx - 1.0) * ge_t             # (idx - 1) * ge
    neg_col = torch.full((B, 1), NEG, dtype=f32, device=dev)
    h = torch.zeros((B, Qp), dtype=f32, device=dev)
    e = torch.full((B, Qp), NEG, dtype=f32, device=dev)
    best = torch.zeros((B,), dtype=f32, device=dev)
    for j in range(subj.shape[1]):
        c = subj[:, j]
        valid = c < A
        s = profile[c.clamp(0, A - 1)]                             # (B, Qp)
        e_new = torch.maximum(h - go_t, e - ge_t)
        h_shift = torch.cat([zero.expand(B, 1), h[:, :-1]], dim=1)
        h_hat = torch.maximum(torch.maximum(h_shift + s, e_new), zero)
        h_hat = torch.where(qmask, h_hat, zero)
        # closed-form F: exclusive prefix-max over the query axis
        x = torch.cat([neg_col, (h_hat + idx_ge)[:, :-1]], dim=1)
        p = torch.cummax(x, dim=1).values
        f = p - go_t - idx_m1_ge
        h_new = torch.where(qmask, torch.maximum(h_hat, f), zero)
        v = valid[:, None]
        h = torch.where(v, h_new, h)
        e = torch.where(v, e_new, e)
        best = torch.where(valid, torch.maximum(best, h_new.amax(dim=1)), best)
    return best if subject.dim() > 1 else best[0]


def pack_subjects(subjects: Sequence[Any], A: int, device: Any
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pad encoded subjects into :func:`sw_batch`'s input: ``(B, Dp)``
    int32 codes padded with ``A``, Dp the longest subject, and their
    ``(B,)`` int32 lengths, both on ``device``."""
    lens = [int(s.shape[0]) for s in subjects]
    lengths = torch.tensor(lens, dtype=torch.int32)
    out = torch.full((len(lens), max(lens, default=0)), A, dtype=torch.int32)
    if sum(lens):
        out[torch.arange(out.shape[1]) < lengths[:, None]] = torch.cat(
            [torch.as_tensor(s).reshape(-1).to("cpu", torch.int32)
             for s in subjects])
    return out.to(device), lengths.to(device)


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    from ._build import load
    lib = load("smith_waterman")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.sw_launch.argtypes = [p, p, p, p, i, i, i, i, i, f, f, p]
    lib.sw_launch.restype = i
    lib.sw_error_string.argtypes = [i]
    lib.sw_error_string.restype = ctypes.c_char_p
    return lib


def sw_batch(profile: torch.Tensor, subjects: torch.Tensor,
             lengths: Optional[torch.Tensor] = None, *, gap_open: float,
             gap_extend: float, q_len: int) -> torch.Tensor:
    """Scores of one query profile against a batch of subjects.

    profile: (A, Qp) f32, Qp a multiple of 128 and at most 8192.
    subjects: (B, Dp) int32; codes >= A are padding.  lengths: optional
    (B,) int32, chars at or past ``lengths[b]`` are skipped too.
    Returns (B,) f32 on the profile's device.  A CUDA profile launches one
    kernel on the current stream and does not synchronise.  The kernel is
    chosen by Qp alone: Qp <= 1024 runs the warp kernel (one warp per
    subject, the profile in shared memory, so A * Qp * 4 bytes must fit a
    block's 227 KB); Qp > 1024 runs the block kernel (one 1024-thread block
    per subject).  There is no backward kernel: a CUDA profile that
    requires grad, with grad mode on, raises ``NotImplementedError``.
    """
    if profile.dim() != 2 or subjects.dim() != 2:
        raise ValueError(f"profile must be (A, Qp) and subjects (B, Dp), got "
                         f"{tuple(profile.shape)} and {tuple(subjects.shape)}")
    A, Qp = profile.shape
    B, Dp = subjects.shape
    if Qp == 0 or Qp % 128 or Qp > MAX_QP:
        raise ValueError(f"query block Qp={Qp} must be a positive multiple "
                         f"of 128 and at most {MAX_QP}")
    if not 0 <= q_len <= Qp:
        raise ValueError(f"q_len={q_len} outside [0, Qp={Qp}]")
    if profile.dtype != torch.float32 or subjects.dtype != torch.int32:
        raise TypeError(f"profile must be float32 and subjects int32, got "
                        f"{profile.dtype} and {subjects.dtype}")
    if lengths is not None and (lengths.shape != (B,)
                                or lengths.dtype != torch.int32):
        raise ValueError(f"lengths must be ({B},) int32")
    tensors = [profile, subjects] + ([] if lengths is None else [lengths])
    if any(t.device != profile.device for t in tensors):
        raise ValueError("profile, subjects and lengths must share a device")

    if profile.device.type == "cpu":
        subj = subjects
        if lengths is not None:
            live = torch.arange(Dp) < lengths[:, None]
            subj = torch.where(live, subjects, A)
        return sw_plain(profile, subj, gap_open, gap_extend, q_len).reshape(B)
    if profile.device.type != "cuda":
        raise ValueError(f"no Smith-Waterman kernel for {profile.device}")
    if torch.is_grad_enabled() and profile.requires_grad:
        raise NotImplementedError(
            "sw_batch has no backward kernel on CUDA (no Smith-Waterman "
            "backward kernel exists): its scores would carry no gradient")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("profile, subjects and lengths must be contiguous")
    if Qp <= WARP_QP and A * Qp * 4 > _MAX_SMEM:
        raise ValueError(f"profile of {A} codes x Qp={Qp} does not fit the "
                         f"warp kernel's {_MAX_SMEM} bytes of shared memory")
    if Qp <= WARP_QP and profile.data_ptr() % 16:
        raise ValueError("the warp kernel reads the profile 16 bytes at a "
                         "time: its start must be 16-byte aligned")

    out = torch.empty((B,), dtype=torch.float32, device=profile.device)
    lib = _lib()
    with torch.cuda.device(profile.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.sw_launch(profile.data_ptr(), subjects.data_ptr(),
                            None if lengths is None else lengths.data_ptr(),
                            out.data_ptr(), A, Qp, q_len, B, Dp,
                            float(gap_open), float(gap_extend), stream)
    if err != 0:
        raise RuntimeError(f"sw_launch failed: CUDA error {err} "
                           f"({lib.sw_error_string(err).decode()})")
    _count_launch()
    return out
