"""LR schedules (counterpart of repro/optim/schedules.py), including WSD
(Warmup-Stable-Decay) from MiniCPM [arXiv:2404.06395]. Each maps a step
count (an int or a 0-d integer tensor) to the rate, a 0-d f32 tensor on the
step's device, computed in f32 as the reference's."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def cosine(lr: float, total_steps: int, warmup: int = 0, min_ratio: float = 0.1):
    def fn(step):
        s = _step(step)
        warm = torch.clamp(s / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total_steps - warmup, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
        return lr * warm * cos
    return fn


def wsd(lr: float, total_steps: int, warmup_frac: float = 0.01,
        decay_frac: float = 0.1, min_ratio: float = 0.01):
    """Warmup-Stable-Decay: linear warmup, long flat plateau, sharp
    exponential-style decay over the final ``decay_frac`` of training."""
    warmup = max(int(total_steps * warmup_frac), 1)
    decay_start = int(total_steps * (1 - decay_frac))

    def fn(step):
        s = _step(step)
        warm = torch.clamp(s / warmup, max=1.0)
        decay_prog = torch.clamp(
            (s - decay_start) / max(total_steps - decay_start, 1), 0.0, 1.0)
        decay = torch.pow(torch.tensor(min_ratio, dtype=torch.float32,
                                       device=s.device), decay_prog)
        return lr * warm * decay
    return fn
