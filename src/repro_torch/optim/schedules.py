"""LR schedules: cosine and WSD (warmup-stable-decay, MiniCPM
arXiv:2404.06395). Each returns ``lr(step)``, a 0-d float32 tensor
computed in fp32 as the JAX package computes it."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def cosine_schedule(base_lr: float, warmup: int, total: int, min_frac=0.1):
    def lr(step):
        step = _f32(step)
        warm = base_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)
    return lr


def wsd_schedule(base_lr: float, warmup: int, total: int, decay_frac=0.1,
                 min_frac=0.01):
    """Warmup -> Stable (constant) -> Decay (last decay_frac of training)."""
    decay_start = int(total * (1 - decay_frac))

    def lr(step):
        step = _f32(step)
        warm = base_lr * step / max(warmup, 1)
        t = torch.clamp((step - decay_start) / max(total - decay_start, 1),
                        0.0, 1.0)
        dec = base_lr * (min_frac ** t)          # exponential anneal
        stable = torch.tensor(base_lr, dtype=torch.float32)
        return torch.where(step < warmup, warm,
                           torch.where(step < decay_start, stable, dec))
    return lr
