"""Core neural building blocks, as plain functions over tensors.

Conventions follow the JAX package's ``models/layers.py``: dense weights are
laid out ``(d_in, d_out)`` and cast to the activation dtype at use; norms
run in fp32 internally; RoPE is half-split (not interleaved). All apply
functions are shape-polymorphic over leading batch dims.

On a process mesh a weight may hold this rank's block and carry its
``sharding.Placement``: ``dense`` then runs a column-parallel product
("col": the replicated input's gradient summed over "model") or a
row-parallel one ("row": a replicated input cut to this rank's block
first, the partial products summed in fp32 over "model" in rank order and
cast back to the activation dtype); ``embed`` a vocab-parallel lookup
("vocab": each rank's rows masked, summed over "model"), ``unembed`` the
tied logits over this rank's rows, gathered over "model". A weight without
a placement is used as it is.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.sharding import placement


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
    """x (..., d_in) @ w (d_in, d_out), w cast to x's dtype; column- or
    row-parallel when ``w`` holds a "col" or "row" block (a column block's
    bias, whole, cut to it)."""
    rec = placement(w)
    use = None if rec is None else rec.use
    if use == "col":
        comm = rec.mesh.comm
        y = torch.matmul(comm.tp_copy(x), w.to(x.dtype))
        if b is not None:
            y = y + comm.tp_split(b, -1).to(x.dtype)
        return y
    if use == "row":
        comm = rec.mesh.comm
        if x.shape[-1] != w.shape[0]:               # a replicated input
            x = comm.tp_split(x, -1)
        y = comm.tp_sum(torch.matmul(x, w.to(x.dtype)).float()).to(x.dtype)
        return y if b is None else y + b.to(x.dtype)
    y = torch.matmul(x, w.to(x.dtype))
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def embed(table, ids):
    """The rows of ``table`` at ``ids``; vocab-parallel over a "vocab"
    block (the rows outside it zero, summed over "model": exact)."""
    rec = placement(table)
    if rec is None or rec.use != "vocab":
        return F.embedding(ids.long(), table)
    n = table.shape[0]
    local = ids.long() - rec.mesh.model_index * n
    inside = (local >= 0) & (local < n)
    e = F.embedding(local.clamp(0, n - 1), table)
    e = e * inside[..., None].to(e.dtype)
    return rec.mesh.comm.tp_sum(e)


def unembed(table, x):
    """Tied unembedding from an embedding table: over a "vocab" block,
    this rank's logits gathered over "model"."""
    rec = placement(table)
    if rec is None or rec.use != "vocab":
        return torch.matmul(x, table.to(x.dtype).t())
    comm = rec.mesh.comm
    return comm.tp_gather(torch.matmul(comm.tp_copy(x),
                                       table.to(x.dtype).t()), -1)


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
