"""MoE FFN block: router + routed experts (+ the shared experts and the
dense residual branch), single-device exact path (``moe_ffn_dense`` of the
JAX package's ``models/moe.py``): every expert runs on every token and the
results are combined by the gates. It never drops a token. A config with
``num_shared_experts`` (deepseek) adds one ungated FFN of width
``num_shared_experts * d_ff_expert`` on every token (``shared_branch``), and
one with ``dense_residual`` (arctic) a dense FFN (``dense_branch``), in
that order, on this path and after the EP dispatch. The
expert products are ordinary batched matrix products, as in the JAX
package, where XLA computes them outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import ffn
from repro_torch.moe.router import RouterOutput, route


def routed_dense(w_gate, w_up, w_down, router_out: RouterOutput, x,
                 activation: str):
    """All experts on all tokens. x: (T, d); w_gate/w_up: (E, d, F);
    w_down: (E, F, d). Returns (T, d) in x's dtype."""
    if activation == "swiglu":
        g = torch.matmul(x, w_gate.to(x.dtype))                  # (E, T, F)
        u = torch.matmul(x, w_up.to(x.dtype))
        h = F.silu(g) * u
    else:
        h = torch.matmul(x, w_up.to(x.dtype))
        h = F.gelu(h, approximate="tanh") if activation == "gelu" else F.relu(h)
    y_all = torch.matmul(h, w_down.to(x.dtype))                  # (E, T, d)
    T, E = x.shape[0], w_up.shape[0]
    # combine: sum_k gate_k * y_all[idx_k], gates cast to the activation dtype
    gates_full = torch.zeros((T, E), dtype=x.dtype, device=x.device)
    rows = torch.arange(T, device=x.device)[:, None].expand_as(
        router_out.expert_idx)
    gates_full.index_put_((rows, router_out.expert_idx.long()),
                          router_out.gates.to(x.dtype), accumulate=True)
    return torch.einsum("te,etd->td", gates_full, y_all)


def shared_branch(moe_p, cfg: ModelConfig, x):
    """The shared experts (the JAX MoE block's ``shared`` FFN: one FFN of
    width ``num_shared_experts * d_ff_expert``, ungated) on every token of
    x (..., d), or None when the block has none. ``moe_p``'s
    "shared_w_up", "shared_w_down" (and "shared_w_gate" under swiglu)."""
    if "shared_w_up" not in moe_p:
        return None
    return ffn(moe_p.get("shared_w_gate"), moe_p["shared_w_up"],
               moe_p["shared_w_down"], x, cfg.activation)


def dense_branch(moe_p, cfg: ModelConfig, x):
    """The dense residual branch (the JAX MoE block's ``dense`` FFN) on
    every token of x (..., d), or None when the block has none.
    ``moe_p``'s "dense_w_up", "dense_w_down" (and "dense_w_gate" under
    swiglu)."""
    if "dense_w_up" not in moe_p:
        return None
    return ffn(moe_p.get("dense_w_gate"), moe_p["dense_w_up"],
               moe_p["dense_w_down"], x, cfg.activation)


def moe_ffn_dense(moe_p, cfg: ModelConfig, x) -> Tuple[torch.Tensor, RouterOutput]:
    """Single-device exact MoE FFN. x: (..., d) -> same shape.
    ``moe_p``: {"router", "w_gate", "w_up", "w_down"} and, with shared
    experts or a dense residual branch, their ``shared_*`` / ``dense_*``
    weights."""
    shape = x.shape
    xt = x.reshape(-1, shape[-1])
    router_out = route(moe_p["router"], cfg.moe, xt)
    y = routed_dense(moe_p["w_gate"], moe_p["w_up"], moe_p["w_down"],
                     router_out, xt, cfg.activation)
    for branch in (shared_branch, dense_branch):
        extra = branch(moe_p, cfg, xt)
        if extra is not None:
            y = y + extra
    return y.reshape(shape), router_out
