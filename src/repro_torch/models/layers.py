"""Core neural building blocks, as plain functions over tensors.

Conventions follow the JAX package's ``models/layers.py``: dense weights are
laid out ``(d_in, d_out)`` and cast to the activation dtype at use; norms
run in fp32 internally; RoPE is half-split (not interleaved). All apply
functions are shape-polymorphic over leading batch dims.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def truncated_normal_init(shape, scale: float = 0.02, *,
                          generator: Optional[torch.Generator] = None,
                          device=None, dtype=torch.float32) -> torch.Tensor:
    """``scale`` x a standard normal truncated to [-2, 2], drawn in fp32 on
    ``device`` and then cast to ``dtype``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * scale).to(dtype)


def rmsnorm(scale, x, eps: float = 1e-6):
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * scale).to(dtype)


def dense(w, x, b=None):
    """x (..., d_in) @ w (d_in, d_out), w cast to x's dtype."""
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def embed(table, ids):
    return F.embedding(ids.long(), table)


def unembed(table, x):
    """Tied unembedding from an embedding table."""
    return torch.matmul(x, table.to(x.dtype).t())


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)            # (hd/2,)
    angles = positions[..., :, None].float() * freqs               # (..., seq, hd/2)
    angles = angles[..., None, :]                                  # (..., seq, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def ffn(w_gate, w_up, w_down, x, activation: str):
    """Dense FFN; ``w_gate`` is unused (may be None) unless swiglu."""
    if activation == "swiglu":
        h = F.silu(dense(w_gate, x)) * dense(w_up, x)
    else:
        h = dense(w_up, x)
        if activation == "gelu":
            h = F.gelu(h, approximate="tanh")
        elif activation == "relu":
            h = F.relu(h)
        elif activation == "relu2":
            h = F.relu(h).square()
        else:
            raise ValueError(activation)
    return dense(w_down, h)
