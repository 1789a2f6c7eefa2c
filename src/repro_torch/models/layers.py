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


def nonparametric_layernorm(x, eps: float = 1e-5):
    """OLMo's LayerNorm without learnable affine parameters, in fp32 with
    the population variance (``jnp.var``'s; ``torch.var``'s default is
    Bessel-corrected)."""
    dtype = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return ((x - mu) * torch.rsqrt(var + eps)).to(dtype)


def apply_norm(kind: str, scale, x):
    """``cfg.norm``'s norm of x: "rmsnorm" with its ``scale``, or
    "nonparametric", which has none (``scale`` is None)."""
    if kind == "rmsnorm":
        return rmsnorm(scale, x)
    if kind == "nonparametric":
        return nonparametric_layernorm(x)
    raise ValueError(kind)


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


def gelu_tanh(x):
    """``jax.nn.gelu`` (tanh approximation, its default) op for op in x's
    dtype: its constants rounded to that dtype and every product and sum
    rounded, as XLA computes it. In bf16 this equals the JAX package bit for
    bit, where ``F.gelu(approximate="tanh")`` (one rounding at the end)
    differs in about one element in five."""
    c = torch.tensor(0.7978845608028654, dtype=x.dtype)       # sqrt(2 / pi)
    k = torch.tensor(0.044715, dtype=x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def ffn(w_gate, w_up, w_down, x, activation: str):
    """Dense FFN; ``w_gate`` is unused (may be None) unless swiglu."""
    if activation == "swiglu":
        h = F.silu(dense(w_gate, x)) * dense(w_up, x)
    else:
        h = dense(w_up, x)
        if activation == "gelu":
            h = gelu_tanh(h)
        elif activation == "relu":
            h = F.relu(h)
        elif activation == "relu2":
            h = F.relu(h).square()
        else:
            raise ValueError(activation)
    return dense(w_down, h)
