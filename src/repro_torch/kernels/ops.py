"""Public Smith-Waterman entry point and its front end: alphabet, BLOSUM50,
query profiles.

Counterpart of the Smith-Waterman half of ``repro.kernels.ops``.  Entry
points run on the card: ``device=None`` means ``cuda``, and raises when
there is none.  Only an explicit ``device="cpu"`` takes the plain PyTorch
version of the kernel.
"""
from __future__ import annotations

import functools
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from .smith_waterman import DEFAULT_TILE, sw_batch

__all__ = ["smith_waterman", "build_profile", "BLOSUM50", "AA_ALPHABET",
           "encode_seq", "resolve_device"]

AA_ALPHABET = "ARNDCQEGHILKMFPSTWYVBZX*"        # 24 codes, BLOSUM order

# BLOSUM50 (upper triangle source: NCBI), 24x24
_B50 = """
 5 -2 -1 -2 -1 -1 -1  0 -2 -1 -2 -1 -1 -3 -1  1  0 -3 -2  0 -2 -1 -1 -5
-2  7 -1 -2 -4  1  0 -3  0 -4 -3  3 -2 -3 -3 -1 -1 -3 -1 -3 -1  0 -1 -5
-1 -1  7  2 -2  0  0  0  1 -3 -4  0 -2 -4 -2  1  0 -4 -2 -3  4  0 -1 -5
-2 -2  2  8 -4  0  2 -1 -1 -4 -4 -1 -4 -5 -1  0 -1 -5 -3 -4  5  1 -1 -5
-1 -4 -2 -4 13 -3 -3 -3 -3 -2 -2 -3 -2 -2 -4 -1 -1 -5 -3 -1 -3 -3 -2 -5
-1  1  0  0 -3  7  2 -2  1 -3 -2  2  0 -4 -1  0 -1 -1 -1 -3  0  4 -1 -5
-1  0  0  2 -3  2  6 -3  0 -4 -3  1 -2 -3 -1 -1 -1 -3 -2 -3  1  5 -1 -5
 0 -3  0 -1 -3 -2 -3  8 -2 -4 -4 -2 -3 -4 -2  0 -2 -3 -3 -4 -1 -2 -2 -5
-2  0  1 -1 -3  1  0 -2 10 -4 -3  0 -1 -1 -2 -1 -2 -3  2 -4  0  0 -1 -5
-1 -4 -3 -4 -2 -3 -4 -4 -4  5  2 -3  2  0 -3 -3 -1 -3 -1  4 -4 -3 -1 -5
-2 -3 -4 -4 -2 -2 -3 -4 -3  2  5 -3  3  1 -4 -3 -1 -2 -1  1 -4 -3 -1 -5
-1  3  0 -1 -3  2  1 -2  0 -3 -3  6 -2 -4 -1  0 -1 -3 -2 -3  0  1 -1 -5
-1 -2 -2 -4 -2  0 -2 -3 -1  2  3 -2  7  0 -3 -2 -1 -1  0  1 -3 -1 -1 -5
-3 -3 -4 -5 -2 -4 -3 -4 -1  0  1 -4  0  8 -4 -3 -2  1  4 -1 -4 -4 -2 -5
-1 -3 -2 -1 -4 -1 -1 -2 -2 -3 -4 -1 -3 -4 10 -1 -1 -4 -3 -3 -2 -1 -2 -5
 1 -1  1  0 -1  0 -1  0 -1 -3 -3  0 -2 -3 -1  5  2 -4 -2 -2  0  0 -1 -5
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  2  5 -3 -2  0  0 -1  0 -5
-3 -3 -4 -5 -5 -1 -3 -3 -3 -3 -2 -3 -1  1 -4 -4 -3 15  2 -3 -5 -2 -3 -5
-2 -1 -2 -3 -3 -1 -2 -3  2 -1 -1 -2  0  4 -3 -2 -2  2  8 -1 -3 -2 -1 -5
 0 -3 -3 -4 -1 -3 -3 -4 -4  4  1 -3  1 -1 -3 -2  0 -3 -1  5 -4 -3 -1 -5
-2 -1  4  5 -3  0  1 -1  0 -4 -4  0 -3 -4 -2  0  0 -5 -3 -4  5  2 -1 -5
-1  0  0  1 -3  4  5 -2  0 -3 -3  1 -1 -4 -1  0 -1 -2 -2 -3  2  5 -1 -5
-1 -1 -1 -1 -2 -1 -1 -2 -1 -1 -1 -1 -1 -2 -2 -1  0 -3 -1 -1 -1 -1 -1 -5
-5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5 -5  1
"""
BLOSUM50 = torch.tensor(
    [[int(v) for v in row.split()] for row in _B50.strip().splitlines()],
    dtype=torch.float32)


def resolve_device(device: Any = None) -> torch.device:
    """``None`` -> ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch version")
    return dev


@functools.lru_cache(maxsize=None)
def _blosum50_on(device: torch.device) -> torch.Tensor:
    return BLOSUM50.to(device)


def encode_seq(seq: str, device: Any = "cpu") -> torch.Tensor:
    lut = {c: i for i, c in enumerate(AA_ALPHABET)}
    return torch.tensor([lut.get(c, lut["X"]) for c in seq.upper()],
                        dtype=torch.int32, device=device)


def build_profile(query: torch.Tensor, matrix: torch.Tensor = BLOSUM50,
                  pad_to: int = 128) -> Tuple[torch.Tensor, int]:
    """Farrar's query profile: (A, Qp) f32 with Qp a multiple of ``pad_to``,
    on the query's device.  Padded query positions score -1e4 so they
    never align."""
    q_len = int(query.shape[0])
    qp = -(-q_len // pad_to) * pad_to
    prof = matrix.to(query.device)[:, query.long()]            # (A, Q)
    return F.pad(prof, (0, qp - q_len), value=-1e4), q_len


def smith_waterman(query: Any, subject: Any, *, gap_open: float = 10.0,
                   gap_extend: float = 2.0, matrix: torch.Tensor = BLOSUM50,
                   tile: int = DEFAULT_TILE,
                   device: Optional[Any] = None) -> torch.Tensor:
    """Best local alignment score of two encoded sequences (the paper's
    application, Sec. 4.2), as a 0-d f32 tensor on ``device``.  The subject
    is padded to a multiple of ``tile`` with code A, as in the reference."""
    dev = resolve_device(device)
    if matrix is BLOSUM50:
        matrix = _blosum50_on(dev)
    query = torch.as_tensor(query, device=dev)
    subject = torch.as_tensor(subject, device=dev).to(torch.int32)
    prof, q_len = build_profile(query, matrix)
    dlen = int(subject.shape[0])
    dp = -(-dlen // tile) * tile
    subj = F.pad(subject, (0, dp - dlen), value=matrix.shape[0])
    return sw_batch(prof, subj[None], gap_open=gap_open,
                    gap_extend=gap_extend, q_len=q_len)[0]
