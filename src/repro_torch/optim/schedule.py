"""LR schedules: linear warmup, then cosine decay to a floor.

Counterpart of ``repro.optim.schedule``, computed in f32 as the
reference computes it (the Python constants meet the step as f32).
"""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, warmup: int = 100, total: int = 10000,
                    floor: float = 0.1) -> torch.Tensor:
    """Multiplier in [floor, 1] (0 at step 0): linear warmup, then cosine
    decay. ``step`` is a number or a tensor; the result is an f32 tensor
    on ``step``'s device (the CPU for a number)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp_max(step / max(warmup, 1), 1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0, 1)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
