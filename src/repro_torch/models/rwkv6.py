"""RWKV-6 "Finch" [arXiv:2404.05892] time mix and channel mix, the port of
the JAX package's ``models/rwkv6.py``.

State per layer and head: S in R^{head_dim x head_dim} (plus the token
shift buffers x_{t-1}), O(1) in sequence length.

Recurrence (per head; diag acts on the key dimension):

    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

A sequence runs the chunked formulation (``wkv_chunked``): within a chunk
of ``CHUNK`` steps the recurrence is expanded with cumulative decay
products into a strict-lower-triangular intra-chunk product and an
inter-chunk state product. Every term that does not read the carried state
is computed for all chunks at once; a Python loop over the chunks runs the
carry's one fused multiply-add each, and the state product then reads the
stacked per-chunk states in one batched product. One token (decode, or a
one-token prompt) takes ``wkv_step``. The recurrence runs in fp32, the
rest in the bf16 activation dtype with every operation rounded, in the JAX
order (``sigmoid`` and ``silu`` as XLA expands them in bf16).

No Pallas kernel computes any of it in the JAX package, so the port is
plain PyTorch and launches no hand-written kernel. Parameters are dicts
under the JAX package's keys (``time_mix``: ``mu``, ``lora_a``, ...,
``ln_out``; ``channel_mix``: ``mu``, ``w_k``, ``w_v``, ``w_r``).

On a process mesh under a tensor-parallel layout (``sharding``) the time
mix runs on this rank's H/m heads: ``w_r`` / ``w_k`` / ``w_v`` / ``w_g``
are column blocks, the decay (its LoRA whole), ``bonus`` and ``ln_out``
are cut to the rank's heads, the WKV state holds them, the output norm
(an RMSNorm over all H * hd channels) sums its squares over "model", and
``w_o`` is row-parallel. The channel mix's ``w_k`` is a column block and
``w_v`` row-parallel; ``w_r``, the token-shift mixes and the LoRAs stay
whole, and so does the token-shift state.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense, rmsnorm
from repro_torch.sharding import placement

LORA_DIM = 64
CHUNK = 32
# Max per-step decay rate: w_t = exp(-rate), rate clipped to <= MAX_RATE so the
# intra-chunk rescaling exp(-cum) stays < exp(MAX_RATE*CHUNK) ~ 3e12 (f32-safe).
MAX_RATE = 0.9
# the clip's upper end as the reference computes it: log of fp32 0.9, in fp32
LOG_MAX_RATE = float(np.log(np.float32(MAX_RATE)))
DECAY_BASE = -6.0

WEIGHT_DTYPE = torch.bfloat16


class Constant(NamedTuple):
    """An init scale that fills the parameter with ``value``."""
    value: float


def param_shapes(cfg: ModelConfig):
    """{"time_mix": {name: (shape, init scale, storage dtype)},
    "channel_mix": {...}} of one layer, names as the JAX package's keys.
    Scale None means ones (``ln_out``), a ``Constant`` a constant fill
    (``decay_base``); any other scale multiplies a standard normal
    truncated to [-2, 2]. Everything the reference casts to the bf16
    activation dtype at use is stored in bf16; ``decay_base``, ``bonus``
    and ``ln_out`` are used in fp32 and stay fp32."""
    d, HD, F_ = cfg.d_model, cfg.num_heads * cfg.head_dim, cfg.d_ff
    bf, f32 = WEIGHT_DTYPE, torch.float32
    return {
        "time_mix": {
            "mu": ((5, d), 0.02, bf),
            "lora_a": ((d, LORA_DIM * 5), 0.01, bf),
            "lora_b": ((5, LORA_DIM, d), 0.01, bf),
            "w_r": ((d, HD), d ** -0.5, bf),
            "w_k": ((d, HD), d ** -0.5, bf),
            "w_v": ((d, HD), d ** -0.5, bf),
            "w_g": ((d, HD), d ** -0.5, bf),
            "w_o": ((HD, d), HD ** -0.5, bf),
            "decay_base": ((HD,), Constant(DECAY_BASE), f32),
            "decay_lora_a": ((d, LORA_DIM), 0.01, bf),
            "decay_lora_b": ((LORA_DIM, HD), 0.01, bf),
            "bonus": ((cfg.num_heads, cfg.head_dim), 0.5, f32),
            "ln_out": ((HD,), None, f32),
        },
        "channel_mix": {
            "mu": ((2, d), 0.02, bf),
            "w_k": ((d, F_), d ** -0.5, bf),
            "w_v": ((F_, d), F_ ** -0.5, bf),
            "w_r": ((d, d), d ** -0.5, bf),
        },
    }


def sigmoid(x):
    """``jax.nn.sigmoid`` as XLA computes it in bf16: ``1 / (1 + exp(-x))``
    with every step rounded in x's dtype. ``torch.sigmoid`` rounds once and
    differs from it in about a third of bf16 elements."""
    return 1.0 / (1.0 + torch.exp(-x))


def silu(x):
    """``jax.nn.silu``: ``x * sigmoid(x)``, each rounded in x's dtype."""
    return x * sigmoid(x)


def _shifted(x, x_prev):
    """x: (B, S, d); x_prev: (B, d), the last token before this segment.
    Returns x shifted one step back in time, x_prev first (in x's dtype)."""
    return torch.cat([x_prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


def _token_shift(p, x, x_prev):
    """The data-dependent token shift (ddlerp). x: (B, S, d); x_prev: (B,
    d). Returns the five mixed streams (B, S, 5, d) (r, k, v, w, g) and the
    new shift state x[:, -1] in x's dtype."""
    B, S, d = x.shape
    delta = _shifted(x, x_prev) - x
    lora = torch.tanh(dense(p["lora_a"], x)).reshape(B, S, 5, LORA_DIM)
    mod = torch.einsum("bsir,ird->bsid", lora, p["lora_b"].to(x.dtype))
    mix = p["mu"].to(x.dtype)[None, None] + mod                  # (B, S, 5, d)
    streams = x[:, :, None, :] + delta[:, :, None, :] * mix
    return streams, x[:, -1, :]


def _log_decay(p, xw):
    """Per-channel log decay (negative, fp32): the bf16 LoRA added to the
    fp32 ``decay_base``, clipped to [-20, log(MAX_RATE)] and exponentiated,
    so logw = -rate lies in [-MAX_RATE, 0)."""
    lw = dense(p["decay_lora_b"], torch.tanh(dense(p["decay_lora_a"], xw)))
    rate = torch.exp(torch.clamp(p["decay_base"].float() + lw.float(),
                                 -20.0, LOG_MAX_RATE))
    return -rate


def wkv_chunked(r, k, v, logw, u, state, chunk: int = CHUNK):
    """r, k, v: (B, S, H, hd); logw: (B, S, H, hd) negative log decay; u:
    (H, hd); state: (B, H, hd, hd). Runs in fp32. Returns (y (B, S, H, hd)
    in r's dtype, new state (B, H, hd, hd) fp32); the input state is not
    modified.

    S is padded with zeros to a multiple of the chunk (a padded logw of 0
    is w = 1, a padded k adds nothing), so the state after the padding is
    the state after the last real token."""
    B, S, H, hd = r.shape
    chunk = min(chunk, max(S, 1))
    pad = (-S) % chunk
    if pad:
        r, k, v, logw = (F.pad(a, (0, 0, 0, 0, 0, pad))
                         for a in (r, k, v, logw))
    n = (S + pad) // chunk
    shape_c = (B, n, chunk, H, hd)
    rc, kc, vc, lw = (a.reshape(shape_c).float() for a in (r, k, v, logw))

    cum = torch.cumsum(lw, dim=2)              # inclusive: sum_{j<=t}
    dec_in = torch.exp(cum - lw)               # exp(cum[t-1]) <= 1
    dec_all = torch.exp(cum[:, :, -1])         # a chunk's decay (B, n, H, hd)
    dec_out = torch.exp(cum[:, :, -1:] - cum)  # prod_{j>s} w_j <= 1
    k_resc = kc * torch.exp(-cum)              # k_s exp(-cum[s]) <= e^28.8
    r_sc = rc * dec_in                         # r_t exp(cum[t-1])

    # what no carried state reads, for every chunk at once: the intra-chunk
    # history, then the current token's bonus
    a = torch.einsum("bnthd,bnshd->bnhts", r_sc, k_resc)
    a = torch.tril(a, diagonal=-1)
    y = torch.einsum("bnhts,bnshe->bnthe", a, vc)
    bonus = (rc * (kc * u.float())).sum(-1)                   # (B, n, C, H)
    y = y + bonus[..., None] * vc
    kv = torch.einsum("bnshd,bnshe->bnhde", kc * dec_out, vc)

    # the carry: the state before each chunk, one fused multiply-add a chunk
    s = state.float()
    states = []
    for i in range(n):
        states.append(s)
        s = torch.addcmul(kv[:, i], dec_all[:, i, :, :, None], s)
    # the inter-chunk state term, every chunk at once
    y = y + torch.einsum("bnthd,bnhde->bnthe", r_sc,
                         torch.stack(states, dim=1))
    y = y.reshape(B, n * chunk, H, hd)[:, :S]
    return y.to(r.dtype), s


def wkv_step(r, k, v, logw, u, state):
    """One token. r, k, v, logw: (B, H, hd); state: (B, H, hd, hd). Runs in
    fp32; returns (y (B, H, hd), new state)."""
    r, k, v, logw = (a.float() for a in (r, k, v, logw))
    state = state.float()
    kv = k[..., :, None] * v[..., None, :]                    # (B, H, hd, hd)
    y = torch.einsum("bhd,bhde->bhe", r,
                     state + u.float()[None, :, :, None] * kv)
    new_state = torch.exp(logw)[..., None] * state + kv
    return y, new_state


def time_mix(p, cfg: ModelConfig, x, state) -> Tuple[torch.Tensor, dict]:
    """x: (B, S, d); state: {"shift_tm": (B, d), "wkv": (B, H, hd, hd)}.
    Returns (out (B, S, d), {"shift_tm", "wkv"}): a one-token call takes
    ``wkv_step``, a longer one ``wkv_chunked``."""
    B, S, d = x.shape
    hd = cfg.head_dim
    streams, new_shift = _token_shift(p, x, state["shift_tm"])
    xr, xk, xv, xw, xg = streams.unbind(2)
    r = dense(p["w_r"], xr).reshape(B, S, -1, hd)
    k = dense(p["w_k"], xk).reshape(B, S, -1, hd)
    v = dense(p["w_v"], xv).reshape(B, S, -1, hd)
    H = r.shape[2]
    g = silu(dense(p["w_g"], xg))
    logw, bonus, ln_out = _log_decay(p, xw), p["bonus"], p["ln_out"]
    rec = placement(p["w_r"])
    comm = rec.mesh.comm if rec is not None and rec.use == "col" else None
    if comm is not None:
        # this rank's heads of the per-channel decay, bonus and norm scale
        logw, bonus, ln_out = (comm.tp_split(logw, -1),
                               comm.tp_split(bonus, 0),
                               comm.tp_split(ln_out, 0))
    logw = logw.reshape(B, S, H, hd)
    if S == 1:
        y, new_wkv = wkv_step(r[:, 0], k[:, 0], v[:, 0], logw[:, 0],
                              bonus, state["wkv"])
        y = y[:, None].to(x.dtype)
    else:
        y, new_wkv = wkv_chunked(r, k, v, logw, bonus, state["wkv"])
    y = y.reshape(B, S, H * hd).to(x.dtype)
    y = (rmsnorm(ln_out, y) if comm is None
         else _rmsnorm_over_ranks(ln_out, y, comm, cfg.num_heads * hd))
    out = dense(p["w_o"], y * g)
    return out, {"shift_tm": new_shift, "wkv": new_wkv}


def _rmsnorm_over_ranks(scale, x, comm, width: int, eps: float = 1e-6):
    """``layers.rmsnorm`` of a vector whose ``width`` channels lie split
    over the ranks of ``comm``: this rank's x and scale, the squares'
    fp32 sum added over the ranks (and, on the way back, the gradient of
    that sum, which every rank's normalisation reads)."""
    dtype = x.dtype
    x = x.float()
    ss = comm.tp_copy(comm.tp_sum(x.square().sum(dim=-1, keepdim=True)))
    y = x * torch.rsqrt(ss / width + eps)
    return (y * scale).to(dtype)


def channel_mix(p, x, x_prev):
    """relu^2 channel mix with token shift: ``mu[0]`` mixes the key stream,
    ``mu[1]`` the receptance stream. x: (B, S, d); x_prev: (B, d). Returns
    (out, new shift state x[:, -1])."""
    shifted = _shifted(x, x_prev)
    mu = p["mu"].to(x.dtype)
    xk = x + (shifted - x) * mu[0]
    xr = x + (shifted - x) * mu[1]
    h = F.relu(dense(p["w_k"], xk)).square()
    rgate = sigmoid(dense(p["w_r"], xr))
    return rgate * dense(p["w_v"], h), x[:, -1, :]


def init_rwkv_state(cfg: ModelConfig, batch: int,
                    device: Optional[torch.device] = None
                    ) -> Dict[str, torch.Tensor]:
    """One layer's zero state, fp32 as the JAX package makes it
    (``models.transformer.init_cache`` stacks it over the layers), of
    ``cfg.num_heads`` heads (a rank's under a tensor-parallel layout:
    ``models.transformer.local_config``)."""
    d = cfg.d_model
    return {
        "shift_tm": torch.zeros((batch, d), dtype=torch.float32, device=device),
        "shift_cm": torch.zeros((batch, d), dtype=torch.float32, device=device),
        "wkv": torch.zeros((batch, cfg.num_heads, cfg.head_dim, cfg.head_dim),
                           dtype=torch.float32, device=device),
    }
