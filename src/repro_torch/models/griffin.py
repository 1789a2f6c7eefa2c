"""Griffin / RecurrentGemma [arXiv:2402.19427] recurrent block, the port of
the JAX package's ``models/griffin.py``.

Recurrent block:  x -> (gate branch: linear+gelu) * (main branch:
linear -> temporal conv1d(4) -> RG-LRU) -> out projection.

RG-LRU:  r_t = sigmoid(W_a x_t),  i_t = sigmoid(W_x x_t)
         a_t = exp(c * softplus(Lambda) * (-r_t))         (c = 8)
         h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

``a`` and ``b`` are computed exactly as the JAX model computes them. The
scan over time, which the JAX model runs as ``jax.lax.associative_scan``,
goes through ``kernels.ops.rg_lru_scan``: the hand-written CUDA kernel on
the card, a sequential loop on the CPU; while autograd records (training)
through ``kernels.ops.RgLruScan``, whose backward is the hand-written
reverse-time scan (``rg_lru_scan_bwd``) on the card. Both round each
step's product and sum in fp32; the associative scan rounds in another
order, so the fp32 state agrees with the JAX model's to within 1e-4 (the
tolerance of ``tests/test_kernels.py``), not bit for bit. A one-token call
(decode, or a one-token prompt) takes ``rg_lru_step`` and launches no
kernel.

The block's bf16 arithmetic (the conv, the gelu, ``y * gate``) rounds at
every operation, in the JAX order, because XLA does: accumulating the conv
in fp32 and rounding once would differ from the reference in about half of
the elements. Parameters are a dict with the JAX package's keys.

On a process mesh under a tensor-parallel layout (``sharding``) the block
runs on this rank's ``dr / m`` channels: ``w_gate`` and ``w_main`` are
column blocks, the depthwise conv reads its channels of the whole
``conv_w`` / ``conv_b``, ``w_a`` and ``w_x`` (dr, dr) compute this rank's
columns from the main branch all-gathered over "model", ``lam`` and the
scan (the kernel, at (B, S, dr / m)) run on the rank's channels, the state
holds them, and ``w_out`` is row-parallel.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import dense, gelu_tanh, truncated_normal_init
from repro_torch.sharding import placement

CONV_WIDTH = 4
RGLRU_C = 8.0

WEIGHT_DTYPE = torch.bfloat16


def param_shapes(cfg: ModelConfig):
    """name -> (shape, init scale, storage dtype, init offset) of one
    block's parameters. Everything the reference casts to the bf16
    activation dtype at use is stored in bf16 (the dense weights, ``conv_w``
    and ``conv_b``); ``lam`` is used in fp32 and stays fp32. A scale of 0
    means zeros."""
    d, dr = cfg.d_model, cfg.rnn_width or cfg.d_model
    return {
        "w_gate": ((d, dr), d ** -0.5, WEIGHT_DTYPE, 0.0),
        "w_main": ((d, dr), d ** -0.5, WEIGHT_DTYPE, 0.0),
        "conv_w": ((CONV_WIDTH, dr), 0.1, WEIGHT_DTYPE, 0.0),
        "conv_b": ((dr,), 0.0, WEIGHT_DTYPE, 0.0),
        "w_a": ((dr, dr), dr ** -0.5, WEIGHT_DTYPE, 0.0),
        "w_x": ((dr, dr), dr ** -0.5, WEIGHT_DTYPE, 0.0),
        "lam": ((dr,), 0.5, torch.float32, 4.0),
        "w_out": ((dr, d), dr ** -0.5, WEIGHT_DTYPE, 0.0),
    }


def init_recurrent_block(cfg: ModelConfig, generator: torch.Generator,
                         device, trainable: bool = False
                         ) -> Dict[str, torch.Tensor]:
    """Random block weights from the JAX package's distributions (a standard
    normal truncated to [-2, 2] times each scale, ``lam`` shifted by 4);
    ``trainable``: every weight fp32, as the JAX package stores them."""
    out = {}
    for name, (shape, scale, dtype, offset) in param_shapes(cfg).items():
        dtype = torch.float32 if trainable else dtype
        if scale == 0.0:
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        t = truncated_normal_init(shape, scale, generator=generator,
                                  device=device)
        out[name] = (t + offset).to(dtype)
    return out


def _causal_conv(p, x, conv_state):
    """Depthwise causal conv1d(width=4). x: (B, S, dr); conv_state:
    (B, W-1, dr). Returns (out, new_state). Every product and sum rounds in
    x's dtype, the taps summed from the oldest, then the bias added, as the
    JAX package computes it."""
    w = p["conv_w"].to(x.dtype)
    xp = torch.cat([conv_state.to(x.dtype), x], dim=1)
    S = x.shape[1]
    out = sum(xp[:, i:i + S, :] * w[i] for i in range(CONV_WIDTH))
    new_state = xp[:, -(CONV_WIDTH - 1):, :].contiguous()
    return out + p["conv_b"].to(x.dtype), new_state


def _decay_and_input(p, x, x_all=None):
    """(a, b) of the recurrence from x (..., dr), fp32, as ``rg_lru``
    computes them in the JAX package. ``x_all``: on a mesh, x's channels
    of every rank, which ``w_a`` / ``w_x`` read (default x)."""
    x_all = x if x_all is None else x_all
    r = torch.sigmoid(dense(p["w_a"], x_all).float())
    i = torch.sigmoid(dense(p["w_x"], x_all).float())
    lam = p["lam"].float()
    softplus = torch.logaddexp(lam, torch.zeros_like(lam))   # jax.nn.softplus
    log_a = -RGLRU_C * softplus * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) * (
        i * x.float())
    return a, b


def rg_lru(p, x, h0, x_all=None):
    """x: (B, S, dr); h0: (B, dr) fp32. Returns (y in x's dtype, h_last
    fp32)."""
    a, b = _decay_and_input(p, x, x_all)
    fn = (kernel_ops.RgLruScan.apply if torch.is_grad_enabled()
          else kernel_ops.rg_lru_scan)
    h, h_last = fn(a.contiguous(), b.contiguous(), h0.float().contiguous())
    return h.to(x.dtype), h_last


def rg_lru_step(p, x, h0, x_all=None):
    """Single-token step. x: (B, 1, dr); h0: (B, dr) fp32."""
    a, b = _decay_and_input(p, x, x_all)
    h = a[:, 0] * h0.float() + b[:, 0]
    return h[:, None].to(x.dtype), h


def recurrent_block(p, cfg: ModelConfig, x, state) -> Tuple[torch.Tensor, dict]:
    """state: {"h": (B, dr) fp32, "conv": (B, W-1, dr)}. Returns (out,
    new_state); the input state is not modified."""
    gate = gelu_tanh(dense(p["w_gate"], x))
    main = dense(p["w_main"], x)
    rec = placement(p["w_main"])
    if rec is not None and rec.use == "col":
        # this rank's channels of the per-channel parameters
        comm = rec.mesh.comm
        p = dict(p, conv_w=comm.tp_split(p["conv_w"], 1),
                 conv_b=comm.tp_split(p["conv_b"], 0),
                 lam=comm.tp_split(p["lam"], 0))
    main, new_conv = _causal_conv(p, main, state["conv"])
    main_all = (comm.tp_gather(main, -1) if rec is not None
                and rec.use == "col" else None)
    if x.shape[1] == 1:
        y, new_h = rg_lru_step(p, main, state["h"], main_all)
    else:
        y, new_h = rg_lru(p, main, state["h"], main_all)
    out = dense(p["w_out"], y * gate)
    return out, {"h": new_h, "conv": new_conv}


def init_recurrent_state(cfg: ModelConfig, batch: int, dtype=torch.bfloat16,
                         device: Optional[torch.device] = None):
    """Zero state of ``cfg.rnn_width`` channels (a rank's under a
    tensor-parallel layout: ``models.transformer.local_config``)."""
    dr = cfg.rnn_width or cfg.d_model
    return {
        "h": torch.zeros((batch, dr), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, CONV_WIDTH - 1, dr), dtype=dtype,
                            device=device),
    }
