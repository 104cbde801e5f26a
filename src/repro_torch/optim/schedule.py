"""LR schedules (pure functions of the step).

Counterpart of ``repro.optim.schedule``.
"""
from __future__ import annotations

import math
from typing import Any

import torch

__all__ = ["cosine_schedule"]


def cosine_schedule(step: Any, *, peak_lr: float, warmup_steps: int,
                    total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then a cosine decay to
    ``min_ratio * peak_lr`` at ``total_steps``.  ``step``: an int, or an
    integer tensor of any shape (kept on its device); returns f32."""
    step = torch.as_tensor(step).float()
    warm = peak_lr * step / max(warmup_steps, 1)
    frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                       0, 1)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup_steps, warm, cos)
