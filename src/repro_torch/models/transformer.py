"""Model assembly for the uniform-stack decoder-only GQA families (dense and
MoE), as an ``nn.Module`` whose parameters mirror the JAX package's
``init_model`` tree.

Execution modes (``Transformer.forward``):
  prefill — causal pass that fills a linear cache; returns logits at the
            last (or each request's last real) position.
  decode  — one token per slot against the paged KV block pool.

MoE layers run the single-device exact path (``moe_ffn_dense``), the
path the JAX engine takes without a mesh. The expert-parallel dispatch
path is not ported yet.

Storage: the embedding, ``lm_head``, attention and expert weights are kept
in bf16 — the reference casts each of them to the bf16 activation dtype at
every use, so the bf16 copy computes the same values in half the bytes.
The router weight and the norm scales stay fp32, as they are used in fp32.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (dense, embed, rmsnorm,
                                       truncated_normal_init)
from repro_torch.models.moe import moe_ffn_dense
from repro_torch.moe.router import expert_histogram

ACT_DTYPE = torch.bfloat16
WEIGHT_DTYPE = torch.bfloat16


class Runtime(NamedTuple):
    """Execution-context knobs the single-device path reads."""
    window_override: int = 0             # force a window (engine: max_len)

    def window(self, cfg: ModelConfig) -> int:
        return self.window_override or cfg.sliding_window


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class DecoderLayer(nn.Module):
    """One attention + MoE-FFN block. Weights are (d_in, d_out)."""

    def __init__(self, cfg: ModelConfig, tensors: Dict[str, torch.Tensor]):
        super().__init__()
        for name, t in tensors.items():
            setattr(self, name, _param(t))

    def attn_params(self):
        return {"wq": self.wq, "wk": self.wk, "wv": self.wv, "wo": self.wo}

    def moe_params(self):
        return {"router": self.router, "w_gate": self.w_gate,
                "w_up": self.w_up, "w_down": self.w_down}


class Transformer(nn.Module):
    """Decoder-only MoE transformer. Parameters (per-layer ones live in
    ``layers[l]``):

      embed (V, d), final_norm (d,), lm_head (d, V);
      ln1, ln2 (d,); wq (d, H*hd), wk/wv (d, K*hd), wo (H*hd, d);
      router (d, E); w_gate/w_up (E, d, F); w_down (E, F, d).
    """

    def __init__(self, cfg: ModelConfig, top: Dict[str, torch.Tensor],
                 layers):
        super().__init__()
        if not cfg.is_moe or cfg.attention != "gqa" or cfg.qkv_bias \
                or cfg.tie_embeddings or cfg.norm != "rmsnorm":
            raise ValueError(f"{cfg.name}: the port serves untied, bias-free "
                             "rmsnorm GQA MoE models only so far")
        self.cfg = cfg
        for name, t in top.items():
            setattr(self, name, _param(t))
        self.layers = nn.ModuleList(DecoderLayer(cfg, t) for t in layers)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens, rt: Runtime = Runtime(), *, mode: str,
                cache=None, cache_len=None, block_tables=None,
                last_pos=None, token_weight=None):
        return forward(self, self.cfg, tokens, rt, mode=mode, cache=cache,
                       cache_len=cache_len, block_tables=block_tables,
                       last_pos=last_pos, token_weight=token_weight)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_shapes(cfg: ModelConfig):
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    E, F = cfg.moe.num_experts, cfg.moe.d_ff_expert
    # name -> (shape, init scale, dtype); scale None = ones (norm scale)
    return {
        "ln1": ((d,), None, torch.float32),
        "ln2": ((d,), None, torch.float32),
        "wq": ((d, H * hd), 1 / math.sqrt(d), WEIGHT_DTYPE),
        "wk": ((d, K * hd), 1 / math.sqrt(d), WEIGHT_DTYPE),
        "wv": ((d, K * hd), 1 / math.sqrt(d), WEIGHT_DTYPE),
        "wo": ((H * hd, d), 1 / math.sqrt(H * hd), WEIGHT_DTYPE),
        "router": ((d, E), 0.02, torch.float32),
        "w_gate": ((E, d, F), 1 / math.sqrt(d), WEIGHT_DTYPE),
        "w_up": ((E, d, F), 1 / math.sqrt(d), WEIGHT_DTYPE),
        "w_down": ((E, F, d), 1 / math.sqrt(F), WEIGHT_DTYPE),
    }


def _draw(shape, scale, dtype, generator, device):
    if scale is None:
        return torch.ones(shape, dtype=dtype, device=device)
    if len(shape) == 3:
        # one expert at a time keeps the fp32 draw buffer small at full width
        out = torch.empty(shape, dtype=dtype, device=device)
        for e in range(shape[0]):
            out[e] = truncated_normal_init(shape[1:], scale, generator=generator,
                                           device=device, dtype=dtype)
        return out
    return truncated_normal_init(shape, scale, generator=generator,
                                 device=device, dtype=dtype)


def init_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device="cuda") -> Transformer:
    """Random weights from the same distributions as the JAX package's
    ``init_model`` (a standard normal truncated to [-2, 2] times the same
    scales), drawn on ``device`` from ``generator`` (which must live on that
    device). The draws differ from JAX's: use ``bridge.params_from_jax``
    for identical weights."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    d, V = cfg.d_model, cfg.vocab_size
    top = {
        "embed": _draw((V, d), 0.02, WEIGHT_DTYPE, generator, dev),
        "final_norm": torch.ones((d,), dtype=torch.float32, device=dev),
        "lm_head": _draw((d, V), 1 / math.sqrt(d), WEIGHT_DTYPE, generator, dev),
    }
    shapes = _layer_shapes(cfg)
    layers = [{name: _draw(shape, scale, dt, generator, dev)
               for name, (shape, scale, dt) in shapes.items()}
              for _ in range(cfg.num_layers)]
    return Transformer(cfg, top, layers)


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def cache_len_for(cfg: ModelConfig, rt: Runtime, max_len: int) -> int:
    w = rt.window(cfg)
    return min(max_len, w) if w else max_len


def init_cache(cfg: ModelConfig, rt: Runtime, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda"):
    """Stacked (over layers) linear cache {"k", "v"}: (L, B, S, K, hd)."""
    clen = cache_len_for(cfg, rt, max_len)
    shape = (cfg.num_layers, batch, clen, cfg.num_kv_heads, cfg.head_dim)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


# ---------------------------------------------------------------------------
# layer body and forward
# ---------------------------------------------------------------------------

def _attn_layer(layer: DecoderLayer, cfg: ModelConfig, x, positions,
                rt: Runtime, *, cache, cache_len=None, mode="prefill",
                block_tables=None, token_weight=None):
    """GQA attention + MoE FFN for one layer. ``cache``: this layer's
    {"k", "v"} (linear cache in prefill, block pool in decode), updated in
    place. Returns (x, (expert_counts (E,), aux, z))."""
    h = rmsnorm(layer.ln1, x)
    if mode == "prefill":
        a = attn.gqa_prefill(layer.attn_params(), cfg, h, positions, cache,
                             window=rt.window(cfg))
    elif mode == "decode":
        # the paged pool is linear in logical positions (window_override =
        # max_len only sizes caches) but decode still masks to the
        # architectural sliding window
        a = attn.gqa_decode_paged(layer.attn_params(), cfg, h, cache,
                                  block_tables, cache_len,
                                  window=cfg.sliding_window)
    else:
        raise ValueError(f"mode {mode!r}")
    x = x + a
    h = rmsnorm(layer.ln2, x)
    y, router_out = moe_ffn_dense(layer.moe_params(), cfg, h)
    # each token's weight on each of its top-k picks
    w = (None if token_weight is None else token_weight.reshape(-1, 1)
         .expand_as(router_out.expert_idx))
    counts = expert_histogram(router_out.expert_idx, cfg.moe.num_experts, w)
    return x + y, (counts, router_out.aux_loss, router_out.z_loss)


def _logits(model: Transformer, x):
    return dense(model.lm_head, rmsnorm(model.final_norm, x))


def forward(model: Transformer, cfg: ModelConfig, tokens, rt: Runtime = Runtime(),
            *, mode: str, cache=None, cache_len=None, block_tables=None,
            last_pos=None, token_weight=None):
    """Returns (logits, cache, stats).

    mode=prefill: tokens (B, S); logits (B, 1, V) at ``last_pos`` (the index
                  of each request's last real token; default the padded
                  end); fills ``cache`` (a fresh one when None).
    mode=decode:  tokens (B, 1); ``cache`` is the block pool {"k", "v"}:
                  (L, N, bs, K, hd); ``cache_len`` the (B,) int32 lengths;
                  ``block_tables`` (B, M) int32. Logits (B, 1, V).
    ``token_weight``: (B, S) weight of each token in the expert histogram
    (0 for padding / idle slots). stats: {"expert_counts": (L, E) fp32,
    "aux_loss", "z_loss"}.
    """
    x = embed(model.embed, tokens).to(ACT_DTYPE)
    B, S = tokens.shape
    if mode == "decode":
        positions = cache_len.long()[:, None]
    else:
        positions = torch.arange(S, device=x.device).expand(B, S)
        if cache is None:
            cache = init_cache(cfg, rt, B, S, device=x.device)
    counts, aux, z = [], 0.0, 0.0
    for l, layer in enumerate(model.layers):
        cache_l = {"k": cache["k"][l], "v": cache["v"][l]}
        x, (c, a_l, z_l) = _attn_layer(
            layer, cfg, x, positions, rt, cache=cache_l, cache_len=cache_len,
            mode=mode, block_tables=block_tables, token_weight=token_weight)
        counts.append(c)
        aux = aux + a_l
        z = z + z_l
    stats = {"expert_counts": torch.stack(counts), "aux_loss": aux,
             "z_loss": z}
    if mode == "prefill":
        if last_pos is not None:
            x = x[torch.arange(B, device=x.device), last_pos.long()][:, None]
        else:
            x = x[:, -1:]
    return _logits(model, x), cache, stats
