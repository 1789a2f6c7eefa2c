"""Model assembly, as an ``nn.Module`` whose parameters mirror the JAX
package's ``init_model`` tree, for six families:

* the uniform-stack decoder-only MoE models: GQA ones (Mixtral, the
  paper's Appendix C models llama-moe-3.5b and switch-base-128, and
  arctic-480b, whose MoE block adds a dense residual FFN on every token),
  and deepseek-v2-lite-16b, with multi-head latent attention (MLA: a
  compressed latent cache, ``models.attention.mla_*``) and a MoE block
  whose shared experts run on every token;
* the uniform-stack dense family (qwen1.5-0.5b, olmo-1b, stablelm-3b,
  minicpm-2b): a dense FFN in place of the MoE block, and per config the
  Q/K/V projections' biases (``qkv_bias``), OLMo's non-parametric LayerNorm
  (``norm="nonparametric"``: no ``ln1`` / ``ln2`` / ``final_norm``
  parameters at all) and tied embeddings (no ``lm_head``: the logits read
  the embedding table);
* the hybrid family (Griffin / RecurrentGemma): a repeating block pattern
  of recurrent layers (``models.griffin``, RG-LRU) and local-attention
  layers over a rotating window buffer, each followed by a dense FFN;
* the attention-free ``ssm`` family (RWKV-6): every layer a time mix
  (``models.rwkv6``: token shift, data-dependent decay, the chunked WKV
  recurrence) and a relu^2 channel mix, over a stacked recurrent state;
* the ``audio`` encoder-decoder (SeamlessM4T): a bidirectional encoder
  stack (``enc_layers``, ``enc_norm``; ``_encode``) over stub frame
  embeddings, at the encoder's own widths (``encoder_config``) with RoPE at
  the frame positions, and GQA decoder layers that attend, after their
  self-attention, over the encoder's output (``ln_cross`` and the
  ``cross_*`` projections; no RoPE). Train and prefill run the encoder on
  ``frames``; prefill keeps each layer's cross K and V in the cache
  (``cross_k`` / ``cross_v``), which decode reads in full and the encoder
  never runs again;
* the ``vlm`` backbone (LLaVA-NeXT): a uniform GQA stack with a dense FFN
  whose train and prefill inputs are ``num_prefix_embeddings`` precomputed
  patch embeddings (``prefix_embeds`` (B, P, d), the vision tower being a
  stub), cast to the embedding's dtype and placed before the token
  embeddings, at positions ``arange(P + S)`` (``_embed_inputs``, under
  ``input_mode="mixed"``); decode takes tokens only.

Execution modes (``Transformer.forward``):
  train   — full causal pass, logits over the whole sequence, no cache
            (hybrid and RWKV models start every recurrent layer from a zero
            state);
            optionally recomputed per layer in the backward (``remat``).
  prefill — causal pass that fills a cache (a linear cache, MLA's
            latent one; for hybrid models the per-layer recurrent states
            and window buffers; RWKV's stacked shift and WKV states, through
            which padded positions run too, as in the reference);
            returns logits at the last (or each request's last real)
            position.
  decode  — one token per row: against the paged KV block pool with (B,)
            per-slot lengths and block tables (continuous batching), or
            against the prefill's cache with one scalar ``cache_len`` for
            the whole batch (``ServeEngine``; MLA decodes this way only;
            RWKV's state needs no position and ignores ``cache_len``), or
            against a slotted linear cache with (B,) per-slot lengths and
            no block tables (``attention.gqa_decode_multi``).

MoE layers run the single-device exact path (``moe_ffn_dense``, the path
the JAX engine takes without a mesh) or, with ``Runtime.ep``, the
expert-parallel dispatch (``moe.dispatch``) with the R EP ranks as a
leading tensor dimension on one device, or with ``Runtime.mesh`` one rank
in this process (the others in theirs, over ``torch.distributed``):
prefill splits each sequence over the ranks (a process runs its positions
and gathers every rank's outputs back), decode replicates the tokens.
Under EP the placement plan
decides which slot each (token, k) pair goes to, which pairs are dropped at
capacity, and which weight row each slot computes with: its expert's row
of the layer's (E, ...) weights, or with a ``StoreView`` the replica
store's rows (``runtime.store``). While a layer-staged migration is in
flight, a layer whose fill is ready reads the target plan and the filled
rows, once the main stream has waited on that layer's fill event; the
other layers read the live plan and rows (``_migration_view``, the JAX
package's per-layer select).

Storage: the embedding, ``lm_head``, attention weights (MLA's
projections too) and QKV biases, expert, shared-expert and FFN weights and
the recurrent block's dense weights, ``conv_w`` and ``conv_b`` are kept in
bf16 — the reference casts each of them to the bf16 activation dtype at
every use, so the bf16 copy computes the same values in half the bytes.
RWKV's dense weights, token-shift mixes and LoRAs are bf16 too. The router
weight, the RG-LRU's ``lam``, RWKV's ``decay_base`` and ``bonus`` and the
norm scales stay fp32, as they are used in fp32. A trainable model
(``init_model(..., trainable=True)``, ``bridge.params_from_jax(...,
trainable=True)``) keeps every parameter in fp32 with ``requires_grad``,
as the JAX package trains them, and casts each to bf16 at use exactly as
the serving model computes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.placement import DevicePlan, identity_plan, to_device
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import griffin, rwkv6
from repro_torch.models.layers import (apply_norm, dense, embed, ffn,
                                       truncated_normal_init, unembed)
from repro_torch.models.moe import dense_branch, moe_ffn_dense, shared_branch
from repro_torch.moe import dispatch as ep_dispatch
from repro_torch.moe.router import expert_histogram, route
from repro_torch.sharding import (EXPERT_LEAVES, at_use, kv_span,
                                  placement)

ACT_DTYPE = torch.bfloat16
WEIGHT_DTYPE = torch.bfloat16
# a forward's stats for a model without MoE, as the JAX forward gives them
NO_MOE_STATS = {"expert_counts": None, "aux_loss": 0.0, "z_loss": 0.0}
# an RWKV layer's parameter name prefixes -> the JAX tree's blocks
RWKV_BLOCKS = {"tm_": "time_mix", "cm_": "channel_mix"}


class Runtime(NamedTuple):
    """Execution-context knobs (the JAX package's ``Runtime``). Without a
    ``mesh`` the EP ranks are a tensor dimension on one device
    (``StackedRanks``); with one (``launch.mesh.Mesh``, one process a
    rank) this process holds its mesh rank: its EP rank's home experts,
    the dispatch's collectives over the model group (``mesh.comm``), and
    its data rank's rows of a batch the data axis divides.

    ``decode_expert_tp`` (the JAX package's): on a mesh, a decode step's
    MoE layers keep each expert's F columns split over "data" where they
    lie and compute with this rank's block of them (expert-TP decode,
    ``_moe_apply``); the other modes, and a config whose ``d_ff_expert``
    the data ranks do not divide, take the ordinary path. ``rows_split``
    is set by ``forward``: this process runs its data rank's rows of the
    batch. A caller that sets it hands ``forward`` this rank's rows
    already (the tokens, every per-row input and the cache: the dry run's
    per-rank trees, ``launch.specs``), which then cuts nothing and runs
    the rest of a split batch's step as it is."""
    window_override: int = 0             # force a window (engine: max_len)
    ep: bool = False                     # expert-parallel dispatch
    ep_ranks: int = 1
    mesh: Optional[object] = None        # launch.mesh.Mesh, or None
    decode_expert_tp: bool = False       # 2D expert sharding for decode
    rows_split: bool = False             # set by forward under a mesh

    @property
    def comm(self):
        """The EP rank backend: the mesh's model group, or the ranks
        stacked on one device."""
        if self.mesh is not None:
            return self.mesh.comm
        return ep_dispatch.StackedRanks(self.ep_ranks)

    def window(self, cfg: ModelConfig) -> int:
        return self.window_override or cfg.sliding_window


class StoreView(NamedTuple):
    """What a forward reads of the replica store: its per-layer row tensors
    and, while a layer-staged migration is in flight, the ready mask, the
    target plan (its ``slot_rows`` the rows each slot reads once its layer
    is ready) and the per-layer fill events (``LayerStagedExecutor``)."""
    weights: Dict[str, List[torch.Tensor]]   # {name: [(E + 2RD, ...)] * L}
    ready: Optional[np.ndarray] = None       # (L,) bool, host
    target: Optional[DevicePlan] = None      # stacked target plan
    events: Optional[list] = None            # per layer: CUDA event or None


# a layer's attention parameters: GQA's projections and biases, MLA's
# projections (``models.attention.mla_*``)
ATTN_NAMES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv", "w_dkv", "w_krope",
              "w_uk", "w_uv", "w_q")
CROSS = "cross_"                 # a decoder layer's cross-attention prefix


def _param(t: torch.Tensor, trainable: bool = False) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=trainable)


def _layer_kind(cfg: ModelConfig, layer_idx: int) -> str:
    """"attn" for the uniform stack, "rwkv" for the ssm family, "decoder"
    for an encoder-decoder's decoder stack; the block pattern's entry
    ("recurrent" or "local") for hybrid models."""
    if cfg.family == "ssm":
        return "rwkv"
    if cfg.is_encdec:
        return "decoder"
    if cfg.family == "hybrid":
        return cfg.block_pattern[layer_idx % len(cfg.block_pattern)]
    return "attn"


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The config an encoder-decoder's encoder layers run under (the JAX
    ``_encode``'s): the encoder's widths, ``head_dim`` its ``d_model //
    num_heads``, GQA attention and a dense FFN, the model's norm,
    activation and RoPE."""
    enc = cfg.encoder
    return dataclasses.replace(
        cfg, num_layers=enc.num_layers, d_model=enc.d_model,
        num_heads=enc.num_heads, num_kv_heads=enc.num_kv_heads,
        d_ff=enc.d_ff, moe=None, encoder=None, attention="gqa",
        head_dim=enc.d_model // enc.num_heads)


class DecoderLayer(nn.Module):
    """One block. Weights are (d_in, d_out). ``kind`` "attn": attention +
    MoE FFN (a dense FFN in a model without MoE); "decoder": the same, with
    cross-attention (``ln_cross``, ``cross_*``) between them; "encoder": an
    encoder layer (attention + FFN at the encoder's widths); "recurrent":
    recurrent block (``rec_*``) + FFN; "local": local attention + FFN;
    "rwkv": time mix (``tm_*``) + channel mix (``cm_*``).

    ``gathers_at_use`` is set once, when a layout's placements are
    attached (``sharding.Sharder.attach``): a parameter of the layer is
    gathered at use, so each (re)computation runs on its ``LayerAtUse``."""

    gathers_at_use = False

    def __init__(self, cfg: ModelConfig, tensors: Dict[str, torch.Tensor],
                 kind: str = "attn", trainable: bool = False):
        super().__init__()
        self.kind = kind
        self.param_names = tuple(tensors)
        for name, t in tensors.items():
            setattr(self, name, _param(t, trainable))

    def attn_params(self):
        """The projections (GQA's or MLA's), and their biases where the
        config has them."""
        return {n: getattr(self, n) for n in ATTN_NAMES if hasattr(self, n)}

    def cross_params(self):
        """A decoder layer's cross-attention projections (and biases)
        under GQA's names."""
        return {n: getattr(self, CROSS + n) for n in ATTN_NAMES
                if hasattr(self, CROSS + n)}

    def moe_params(self):
        """The MoE block's weights: router and experts, and the shared
        experts' ``shared_*`` and the dense residual branch's ``dense_*``
        where the config has them."""
        p = {"router": self.router, "w_gate": self.w_gate,
             "w_up": self.w_up, "w_down": self.w_down}
        p.update((n, getattr(self, n)) for n in self.param_names
                 if n.startswith(("shared_", "dense_")))
        return p

    def rec_params(self):
        return {name[4:]: getattr(self, name) for name in self.param_names
                if name.startswith("rec_")}

    def rwkv_params(self, prefix: str):
        """The time mix's (``prefix`` "tm_") or the channel mix's ("cm_")
        parameters under the JAX package's keys."""
        return {name[len(prefix):]: getattr(self, name)
                for name in self.param_names if name.startswith(prefix)}


class LayerAtUse:
    """A layer's parameters as this rank computes with them
    (``sharding.at_use``: FSDP shards gathered over "data", "gathered"
    blocks over "model"), with ``DecoderLayer``'s accessors; the leaves
    named in ``keep`` as they lie (the MoE layer gathers them itself, or
    computes with its blocks). Made inside a layer's (re)computation, so
    under ``remat`` the backward gathers again."""
    attn_params = DecoderLayer.attn_params
    cross_params = DecoderLayer.cross_params
    moe_params = DecoderLayer.moe_params
    rec_params = DecoderLayer.rec_params
    rwkv_params = DecoderLayer.rwkv_params

    def __init__(self, layer: DecoderLayer, keep=()):
        self.kind = layer.kind
        self.param_names = layer.param_names
        for name in layer.param_names:
            w = getattr(layer, name)
            setattr(self, name, w if name in keep else at_use(w))


class Transformer(nn.Module):
    """Decoder-only transformer. Parameters (per-layer ones live in
    ``layers[l]``):

      embed (V, d), final_norm (d,), lm_head (d, V); every layer ln1, ln2
      (d,); attention layers wq (d, H*hd), wk/wv (d, K*hd), wo (H*hd, d),
      and under ``qkv_bias`` bq (H*hd,), bk/bv (K*hd,); MLA layers w_dkv
      (d, r), w_krope (d, rope), w_uk (r, H*nope), w_uv (r, H*v), w_q (d,
      H*(nope+rope)), wo (H*v, d). A non-parametric
      norm has no final_norm, ln1 or ln2; tied embeddings no lm_head.
      Dense layers: an FFN w_up (d, F), w_down (F, d) (and w_gate (d, F)
      under swiglu). MoE layers: router (d, E); w_gate/w_up (E, d, F); w_down (E, F, d);
      with shared experts (deepseek) also shared_w_up (d, Fs), shared_w_down
      (Fs, d) (and shared_w_gate (d, Fs) under swiglu), Fs =
      num_shared_experts * F; with a dense residual branch (arctic) also
      dense_w_up (d, Fd), dense_w_down (Fd, d) (and dense_w_gate (d, Fd)
      under swiglu).
      Hybrid layers: an FFN w_up (d, F), w_down (F, d) (and w_gate (d, F)
      under swiglu); recurrent layers rec_w_gate, rec_w_main (d, dr),
      rec_conv_w (4, dr), rec_conv_b (dr,), rec_w_a, rec_w_x (dr, dr),
      rec_lam (dr,), rec_w_out (dr, d); local layers the attention weights.
      RWKV layers: ln1, ln2 and the time mix tm_mu (5, d), tm_lora_a (d,
      320), tm_lora_b (5, 64, d), tm_w_r/w_k/w_v/w_g (d, H*hd), tm_w_o
      (H*hd, d), tm_decay_base (H*hd,), tm_decay_lora_a (d, 64),
      tm_decay_lora_b (64, H*hd), tm_bonus (H, hd), tm_ln_out (H*hd,); the
      channel mix cm_mu (2, d), cm_w_k (d, F), cm_w_v (F, d), cm_w_r (d, d).
      Encoder-decoder: enc_norm (d_enc,) at the top; decoder layers add
      ln_cross (d,) and cross_wq (d, H*hd), cross_wk / cross_wv (d, K*hd),
      cross_wo (H*hd, d); ``enc_layers[l]`` hold ln1, ln2, wq, wk, wv, wo
      and the FFN at the encoder's widths (``encoder_config``).
    ``trainable``: the parameters require gradients (the tensors given are
    then fp32).
    """

    def __init__(self, cfg: ModelConfig, top: Dict[str, torch.Tensor],
                 layers, trainable: bool = False, enc_layers=()):
        super().__init__()
        check_config(cfg)
        self.cfg = cfg
        for name, t in top.items():
            setattr(self, name, _param(t, trainable))
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, t, _layer_kind(cfg, l), trainable)
            for l, t in enumerate(layers))
        self.enc_layers = nn.ModuleList(
            DecoderLayer(cfg, t, "encoder", trainable) for t in enc_layers)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens, rt: Runtime = Runtime(), *, mode: str,
                cache=None, cache_len=None, block_tables=None,
                last_pos=None, token_weight=None, plan=None, store=None,
                resched=None, remat=False, frames=None, prefix_embeds=None):
        return forward(self, self.cfg, tokens, rt, mode=mode, cache=cache,
                       cache_len=cache_len, block_tables=block_tables,
                       last_pos=last_pos, token_weight=token_weight,
                       plan=plan, store=store, resched=resched, remat=remat,
                       frames=frames, prefix_embeds=prefix_embeds)


def check_config(cfg: ModelConfig) -> None:
    """Raise on a config the port cannot build."""
    if cfg.is_encdec != (cfg.family == "audio"):
        raise ValueError(f"{cfg.name}: an encoder comes with the audio "
                         "family's encoder-decoder only, and that family "
                         f"needs one (family {cfg.family!r}, encoder "
                         f"{cfg.encoder})")
    hybrid = cfg.family == "hybrid" and cfg.attention == "mixed"
    uniform = cfg.family in ("moe", "dense", "vlm") and cfg.attention == "gqa"
    # the encoder-decoder: a GQA decoder with a dense FFN, as in JAX
    encdec = (cfg.family == "audio" and cfg.attention == "gqa"
              and not cfg.is_moe)
    ssm = cfg.family == "ssm" and cfg.attention == "none" and not cfg.is_moe
    # MLA: DeepSeek's MoE models, as the JAX package has them
    mla = (cfg.family == "moe" and cfg.is_moe and cfg.attention == "mla"
           and cfg.mla is not None)
    if not (hybrid or uniform or mla or ssm or encdec):
        raise ValueError(f"{cfg.name}: family {cfg.family!r} with attention "
                         f"{cfg.attention!r} has no port")
    if cfg.norm not in ("rmsnorm", "nonparametric"):
        raise ValueError(f"{cfg.name}: norm {cfg.norm!r}")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

ZEROS = 0.0                      # a ``_layer_shapes`` scale: zeros (biases)
EXPERT_NAMES = ("w_gate", "w_up", "w_down")    # a MoE layer's (E, ...) experts


def expert_param_names(model) -> List[str]:
    """The parameter names (``model.named_parameters()``'s) of every MoE
    layer's expert weights: the leaves a mesh rank holds a block of
    (``init_model(expert_block=...)``), the rest whole."""
    if not model.cfg.is_moe:
        return []
    return [f"layers.{l}.{n}" for l, layer in enumerate(model.layers)
            if layer.kind == "attn" for n in EXPERT_NAMES
            if hasattr(layer, n)]


def _gqa_shapes(cfg: ModelConfig, prefix: str = ""):
    """GQA's projections (and, under ``qkv_bias``, their biases), each name
    after ``prefix``."""
    d, H, K, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {"wq": ((d, H * hd), 1 / math.sqrt(d), WEIGHT_DTYPE),
              "wk": ((d, K * hd), 1 / math.sqrt(d), WEIGHT_DTYPE),
              "wv": ((d, K * hd), 1 / math.sqrt(d), WEIGHT_DTYPE),
              "wo": ((H * hd, d), 1 / math.sqrt(H * hd), WEIGHT_DTYPE)}
    if cfg.qkv_bias:
        shapes.update({"bq": ((H * hd,), ZEROS, WEIGHT_DTYPE),
                       "bk": ((K * hd,), ZEROS, WEIGHT_DTYPE),
                       "bv": ((K * hd,), ZEROS, WEIGHT_DTYPE)})
    return {prefix + n: spec for n, spec in shapes.items()}


def _layer_shapes(cfg: ModelConfig, kind: str = "attn"):
    """name -> (shape, init scale, dtype) of one layer of ``kind``; scale
    None = ones (norm scale), ``ZEROS`` = zeros (the QKV biases, as the
    JAX ``init_dense`` makes them), an ``rwkv6.Constant`` a constant fill.
    Recurrent layers' ``rec_*`` entries carry ``models.griffin.param_shapes``
    (``init_model`` draws them there); RWKV layers' ``tm_*`` and ``cm_*``
    entries ``models.rwkv6.param_shapes``. An "encoder" layer takes the
    model's config and has the encoder's widths (``encoder_config``); a
    "decoder" layer's cross-attention has the decoder's, as the JAX
    ``init_gqa(cfg)`` draws it."""
    if kind == "encoder":
        return _layer_shapes(encoder_config(cfg), "attn")
    d = cfg.d_model
    shapes = {}
    if cfg.norm == "rmsnorm":
        shapes.update({"ln1": ((d,), None, torch.float32),
                       "ln2": ((d,), None, torch.float32)})
    if kind == "rwkv":
        for prefix, block in RWKV_BLOCKS.items():
            shapes.update((prefix + n, spec) for n, spec
                          in rwkv6.param_shapes(cfg)[block].items())
        return shapes
    if kind == "attn" and cfg.attention == "mla":
        H, m = cfg.num_heads, cfg.mla
        r, qk = m.kv_lora_rank, m.nope_head_dim + m.rope_head_dim
        shapes.update({
            "w_dkv": ((d, r), 1 / math.sqrt(d), WEIGHT_DTYPE),
            "w_krope": ((d, m.rope_head_dim), 1 / math.sqrt(d), WEIGHT_DTYPE),
            "w_uk": ((r, H * m.nope_head_dim), 1 / math.sqrt(r),
                     WEIGHT_DTYPE),
            "w_uv": ((r, H * m.v_head_dim), 1 / math.sqrt(r), WEIGHT_DTYPE),
            "w_q": ((d, H * qk), 1 / math.sqrt(d), WEIGHT_DTYPE),
            "wo": ((H * m.v_head_dim, d), 1 / math.sqrt(H * m.v_head_dim),
                   WEIGHT_DTYPE)})
    elif kind in ("attn", "local", "decoder"):
        shapes.update(_gqa_shapes(cfg))
    if kind == "decoder":
        if cfg.norm == "rmsnorm":
            shapes["ln_cross"] = ((d,), None, torch.float32)
        shapes.update(_gqa_shapes(cfg, CROSS))
    if kind == "attn" and cfg.is_moe:
        E, F = cfg.moe.num_experts, cfg.moe.d_ff_expert
        shapes.update({
            "router": ((d, E), 0.02, torch.float32),
            "w_gate": ((E, d, F), 1 / math.sqrt(d), WEIGHT_DTYPE),
            "w_up": ((E, d, F), 1 / math.sqrt(d), WEIGHT_DTYPE),
            "w_down": ((E, F, d), 1 / math.sqrt(F), WEIGHT_DTYPE)})
        if cfg.moe.num_shared_experts > 0:
            # the shared experts: the JAX block's init_ffn at width
            # num_shared_experts * d_ff_expert, under the model's activation
            Fs = cfg.moe.num_shared_experts * F
            if cfg.activation == "swiglu":
                shapes["shared_w_gate"] = ((d, Fs), 1 / math.sqrt(d),
                                           WEIGHT_DTYPE)
            shapes["shared_w_up"] = ((d, Fs), 1 / math.sqrt(d), WEIGHT_DTYPE)
            shapes["shared_w_down"] = ((Fs, d), 1 / math.sqrt(Fs),
                                       WEIGHT_DTYPE)
        if cfg.moe.dense_residual:
            # the dense residual branch: the JAX block's init_ffn at width
            # d_ff_dense or d_ff, under the model's activation
            Fd = cfg.moe.d_ff_dense or cfg.d_ff
            if cfg.activation == "swiglu":
                shapes["dense_w_gate"] = ((d, Fd), 1 / math.sqrt(d),
                                          WEIGHT_DTYPE)
            shapes["dense_w_up"] = ((d, Fd), 1 / math.sqrt(d), WEIGHT_DTYPE)
            shapes["dense_w_down"] = ((Fd, d), 1 / math.sqrt(Fd),
                                      WEIGHT_DTYPE)
        return shapes
    if kind == "recurrent":
        shapes.update({"rec_" + n: (shape, scale, dt) for n, (shape, scale, dt, _)
                       in griffin.param_shapes(cfg).items()})
    elif kind not in ("local", "attn", "decoder"):
        raise ValueError(f"layer kind {kind!r}")
    F = cfg.d_ff
    if cfg.activation == "swiglu":
        shapes["w_gate"] = ((d, F), 1 / math.sqrt(d), WEIGHT_DTYPE)
    shapes["w_up"] = ((d, F), 1 / math.sqrt(d), WEIGHT_DTYPE)
    shapes["w_down"] = ((F, d), 1 / math.sqrt(F), WEIGHT_DTYPE)
    return shapes


def _draw(shape, scale, dtype, generator, device, keep=None):
    """One parameter's draw; ``keep``: None, or (lo, hi), the rows of a 3-D
    draw to keep (every row is still drawn, in order)."""
    if scale is None:
        return torch.ones(shape, dtype=dtype, device=device)
    if isinstance(scale, rwkv6.Constant):
        return torch.full(shape, scale.value, dtype=dtype, device=device)
    if scale == ZEROS:
        return torch.zeros(shape, dtype=dtype, device=device)
    if len(shape) == 3:
        # one expert at a time keeps the fp32 draw buffer small at full width
        lo, hi = keep or (0, shape[0])
        out = torch.empty((hi - lo,) + tuple(shape[1:]), dtype=dtype,
                          device=device)
        for e in range(shape[0]):
            w = truncated_normal_init(shape[1:], scale, generator=generator,
                                      device=device, dtype=dtype)
            if lo <= e < hi:
                out[e - lo] = w
        return out
    return truncated_normal_init(shape, scale, generator=generator,
                                 device=device, dtype=dtype)


def init_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device="cuda", trainable: bool = False,
               expert_block=None, shard=None) -> Transformer:
    """Random weights from the same distributions as the JAX package's
    ``init_model`` (a standard normal truncated to [-2, 2] times the same
    scales), drawn on ``device`` from ``generator`` (which must live on that
    device). The draws differ from JAX's: use ``bridge.params_from_jax``
    for identical weights. ``trainable``: every parameter fp32 and
    requiring gradients (the serving default stores bf16 copies).
    ``expert_block``: None, or (lo, hi), the experts of each MoE layer to
    keep (an EP rank's home experts, ``sharding.expert_block``): every
    weight is still drawn, so the kept ones are the whole model's, and no
    process holds more than its block of experts. ``shard``: None, or a
    ``sharding.Sharder`` (``bridge.sharder``): every weight is drawn whole,
    one at a time (an expert at a time), and this rank keeps its block
    under the sharder's layout, each parameter carrying its
    ``Placement``. On the ``meta`` device nothing is drawn and no
    generator is needed: ``meta_model``."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return meta_model(cfg, trainable=trainable,
                          expert_block=expert_block, shard=shard)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    d, V = cfg.d_model, cfg.vocab_size

    def dtype(dt):
        return torch.float32 if trainable else dt

    def keep(name, t):
        return t if shard is None else shard.block(name, t).clone()

    def draw(name, shape, scale, dt):
        if shard is None:
            return _draw(shape, scale, dtype(dt), generator, dev,
                         expert_block if name.rsplit(".", 1)[-1]
                         in EXPERT_NAMES else None)
        rows = shard.expert_rows(name)
        t = _draw(shape, scale, dtype(dt), generator, dev, rows)
        return shard.block(name, t, rows_kept=rows is not None).clone()
    top = {"embed": draw("embed", (V, d), 0.02, WEIGHT_DTYPE)}
    if cfg.norm == "rmsnorm":
        top["final_norm"] = torch.ones((d,), dtype=torch.float32, device=dev)
    if not cfg.tie_embeddings:
        top["lm_head"] = draw("lm_head", (d, V), 1 / math.sqrt(d),
                              WEIGHT_DTYPE)
    layers = []
    for l in range(cfg.num_layers):
        kind = _layer_kind(cfg, l)
        t = {name: draw(f"layers.{l}.{name}", shape, scale, dt)
             for name, (shape, scale, dt) in _layer_shapes(cfg, kind).items()
             if not name.startswith("rec_")}
        if kind == "recurrent":
            t.update(("rec_" + n, keep(f"layers.{l}.rec_{n}", w))
                     for n, w in griffin.init_recurrent_block(
                         cfg, generator, dev, trainable).items())
        layers.append(t)
    enc_layers = []
    if cfg.is_encdec:
        if cfg.norm == "rmsnorm":
            top["enc_norm"] = torch.ones((cfg.encoder.d_model,),
                                         dtype=torch.float32, device=dev)
        enc_layers = [{name: draw(f"enc_layers.{l}.{name}", shape, scale, dt)
                       for name, (shape, scale, dt)
                       in _layer_shapes(cfg, "encoder").items()}
                      for l in range(cfg.encoder.num_layers)]
    model = Transformer(cfg, top, layers, trainable, enc_layers)
    if shard is not None:
        shard.attach(model)
    return model


def meta_model(cfg: ModelConfig, dtype=None, trainable: bool = False,
               expert_block=None, shard=None) -> Transformer:
    """A model whose every parameter is an empty ``meta`` tensor: nothing
    allocated, nothing drawn. Each holds this rank's block (``shard``: a
    ``sharding.Sharder``, whose placements are attached; ``expert_block``:
    (lo, hi), the experts kept) or the whole leaf. Dtypes are
    ``init_model``'s (fp32 when ``trainable``), or ``dtype`` for every
    leaf when given (the JAX dry run's abstract trees cast every leaf)."""
    meta = torch.device("meta")

    def leaf(name, shape, dt):
        if shard is not None:
            shape = shard.block_shape(name)
        elif expert_block is not None and len(shape) == 3 \
                and name.rsplit(".", 1)[-1] in EXPERT_NAMES:
            shape = (expert_block[1] - expert_block[0],) + tuple(shape[1:])
        dt = dtype or (torch.float32 if trainable else dt)
        return torch.empty(shape, dtype=dt, device=meta)

    d, V = cfg.d_model, cfg.vocab_size
    top = {"embed": leaf("embed", (V, d), WEIGHT_DTYPE)}
    if cfg.norm == "rmsnorm":
        top["final_norm"] = leaf("final_norm", (d,), torch.float32)
    if not cfg.tie_embeddings:
        top["lm_head"] = leaf("lm_head", (d, V), WEIGHT_DTYPE)
    layers = [{name: leaf(f"layers.{l}.{name}", spec[0], spec[2])
               for name, spec in _layer_shapes(
                   cfg, _layer_kind(cfg, l)).items()}
              for l in range(cfg.num_layers)]
    enc_layers = []
    if cfg.is_encdec:
        if cfg.norm == "rmsnorm":
            top["enc_norm"] = leaf("enc_norm", (cfg.encoder.d_model,),
                                   torch.float32)
        enc_layers = [{name: leaf(f"enc_layers.{l}.{name}", spec[0], spec[2])
                       for name, spec in _layer_shapes(
                           cfg, "encoder").items()}
                      for l in range(cfg.encoder.num_layers)]
    model = Transformer(cfg, top, layers, trainable, enc_layers)
    if shard is not None:
        shard.attach(model)
    return model


def param_shapes(cfg: ModelConfig):
    """({port parameter name: whole shape}, {name: its layer's kind}) of
    every parameter a model of ``cfg`` holds (``sharding.Sharder``'s
    input)."""
    d, V = cfg.d_model, cfg.vocab_size
    shapes = {"embed": (V, d)}
    if cfg.norm == "rmsnorm":
        shapes["final_norm"] = (d,)
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (d, V)
    if cfg.is_encdec and cfg.norm == "rmsnorm":
        shapes["enc_norm"] = (cfg.encoder.d_model,)
    kinds = {}
    stacks = [("layers", [_layer_kind(cfg, l)
                          for l in range(cfg.num_layers)])]
    if cfg.is_encdec:
        stacks.append(("enc_layers", ["encoder"] * cfg.encoder.num_layers))
    for stack, layer_kinds in stacks:
        for l, kind in enumerate(layer_kinds):
            for name, spec in _layer_shapes(cfg, kind).items():
                shapes[f"{stack}.{l}.{name}"] = tuple(spec[0])
                kinds[f"{stack}.{l}.{name}"] = kind
    return shapes, kinds


def local_config(model: Transformer, cfg: Optional[ModelConfig] = None
                 ) -> ModelConfig:
    """``cfg`` (default the model's) with the head and channel counts of
    the caches this rank holds: under a tensor-parallel layout the KV
    heads its attention computes (``num_kv_heads``), RWKV's heads
    (``num_heads``) and Griffin's recurrent channels (``rnn_width``);
    ``cfg`` itself otherwise."""
    cfg = cfg or model.cfg
    changes = {}
    for layer in model.layers:
        rq, rk = (placement(getattr(layer, n, None)) for n in ("wq", "wk"))
        if rk is not None and "num_kv_heads" not in changes:
            m = rk.mesh.model
            if rk.use == "col":
                changes["num_kv_heads"] = cfg.num_kv_heads // m
            elif rk.use == "gathered" and rq.use == "col":
                lo, hi = kv_span(cfg.num_heads, cfg.num_kv_heads, m,
                                 rk.mesh.model_index)
                changes["num_kv_heads"] = hi - lo
        rec = placement(getattr(layer, "rec_w_main", None))
        if rec is not None and rec.use == "col":
            changes["rnn_width"] = (cfg.rnn_width or cfg.d_model) \
                // rec.mesh.model
        rec = placement(getattr(layer, "tm_w_k", None))
        if rec is not None and rec.use == "col":
            changes["num_heads"] = cfg.num_heads // rec.mesh.model
    return dataclasses.replace(cfg, **changes) if changes else cfg


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def cache_len_for(cfg: ModelConfig, rt: Runtime, max_len: int) -> int:
    w = rt.window(cfg)
    return min(max_len, w) if w else max_len


def init_cache(cfg: ModelConfig, rt: Runtime, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda", source_len=None):
    """Uniform stack: one linear cache {"k", "v"}: (L, B, S, K, hd), S =
    ``cache_len_for``; an encoder-decoder adds the cross-attention's
    {"cross_k", "cross_v"}: (L, B, T_src, K, hd) zeros, T_src =
    ``source_len`` (default the encoder's ``max_source_len``, as the JAX
    package sizes them; a prefill over another number of frames replaces
    them, as the JAX prefill does); under MLA the latent one
    {"c_kv": (L, B, S, r), "k_rope": (L, B, S, rope)}. Hybrid: a list over layers, a recurrent state
    {"h", "conv"} for each recurrent layer and a window buffer {"k", "v"}
    of ``min(max_len, local_window)`` positions for each local layer.
    RWKV: the stacked state {"shift_tm", "shift_cm": (L, B, d), "wkv": (L,
    B, H, hd, hd)}, fp32 zeros as the JAX package makes them (``dtype`` and
    ``max_len`` do not apply); a forward stores its bf16 shift vectors
    there, exactly."""
    dev = resolve_device(device)
    if cfg.family == "ssm":
        return {name: t.new_zeros((cfg.num_layers, *t.shape))
                for name, t in rwkv6.init_rwkv_state(cfg, batch,
                                                     device=dev).items()}
    if cfg.family == "hybrid":
        W = min(max_len, cfg.local_window)
        return [griffin.init_recurrent_state(cfg, batch, dtype, dev)
                if _layer_kind(cfg, l) == "recurrent" else
                attn.init_gqa_cache(cfg, batch, W, dtype, dev)
                for l in range(cfg.num_layers)]
    clen = cache_len_for(cfg, rt, max_len)
    if cfg.attention == "mla":
        return {name: t.new_zeros((cfg.num_layers, *t.shape))
                for name, t in attn.init_mla_cache(cfg, batch, clen, dtype,
                                                   dev).items()}
    shape = (cfg.num_layers, batch, clen, cfg.num_kv_heads, cfg.head_dim)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev)}
    if cfg.is_encdec:
        src = cfg.encoder.max_source_len if source_len is None else source_len
        cshape = shape[:2] + (src,) + shape[3:]
        cache.update(cross_k=torch.zeros(cshape, dtype=dtype, device=dev),
                     cross_v=torch.zeros(cshape, dtype=dtype, device=dev))
    return cache


# ---------------------------------------------------------------------------
# layer body and forward
# ---------------------------------------------------------------------------

def _moe_apply(layer: DecoderLayer, cfg: ModelConfig, x, rt: Runtime,
               plan_l: Optional[DevicePlan], decode: bool, token_weight=None,
               experts_l=None, fill_event=None, predicted_l=None,
               resched_l=None):
    """MoE FFN of one layer (the JAX package's ``_moe_apply``). x: (B, S, d).
    Returns (y, expert_counts (E,), slot_counts, aux, z, dropped,
    overflow); slot_counts, dropped and overflow are None on the dense
    path, which has no slots and drops nothing. ``experts_l``: the weights
    ``plan_l.slot_rows`` index (the store's rows; None: the layer's home
    experts);
    ``fill_event``: a CUDA event the main stream waits on first (the
    layer's staged fill).

    ``token_weight`` (B, S) weights each token in the expert histogram, so
    padding and idle slots (weight 0) still flow through the FFN but do not
    skew the estimator's input. ``predicted_l``: None, or (B, S, K)
    Token-to-Expert predictions; the EP dispatch takes them (split over
    the ranks as ``x`` is), the dense path ignores them. ``resched_l``:
    None, or the layer's (E, C_max) int32 reschedule quota: the EP
    dispatch picks replicas through it and runs the rescue round; the
    dense path ignores it.

    Under a layout that splits the experts over "data" (``sharding``:
    "fsdp", expert TP) the layer's expert leaves and the store's rows come
    in as this rank's blocks (``_forward`` keeps them from ``LayerAtUse``):
    they are gathered here, the store's rows along the home experts' data
    dim. Expert-TP decode (``expert_tp_decode``: the JAX package's
    ``tp_mode``) gathers nothing: every rank routes the whole decode batch
    (its rows gathered over "data"), computes its slots' pairs with its
    block of each expert's F columns, reads no store (the replica slots
    come from ``gather_replica_pool``, as the reference's ``slot_w_l =
    None``), and one ordered sum over the ``(data, model)`` world makes y,
    of which it keeps its rows."""
    moe = cfg.moe
    B, S, d = x.shape
    if not rt.ep:
        y, router_out = moe_ffn_dense(layer.moe_params(), cfg, x)
        w = (None if token_weight is None else token_weight.reshape(-1, 1)
             .expand_as(router_out.expert_idx))
        counts = expert_histogram(router_out.expert_idx, moe.num_experts, w)
        return (y, counts, None, router_out.aux_loss, router_out.z_loss,
                None, None)

    R = rt.ep_ranks
    comm = rt.comm
    if plan_l is None:
        plan_l = to_device(identity_plan(moe.num_experts, R,
                                         moe.duplication_slots,
                                         moe.max_copies),
                           moe.num_experts, R, moe.duplication_slots,
                           x.device)
    if fill_event is not None:
        torch.cuda.current_stream(x.device).wait_event(fill_event)
    tp_mode = decode and expert_tp_decode(cfg, rt)
    if tp_mode:
        experts_l = None                 # the replica slots from the pool
        experts = {k: _f_block(getattr(layer, k), k, rt.mesh).to(x.dtype)
                   for k in EXPERT_LEAVES}
    elif experts_l is not None:
        experts = {k: _gathered_rows(w, placement(getattr(layer, k)))
                   for k, w in experts_l.items()}
    else:
        # the home experts at the activation dtype: a no-op for the bf16
        # serving weights, the per-use cast of a trainable model's fp32
        # ones (``models.moe.routed_dense`` casts them the same way),
        # through which the kernel's bf16 gradients reach the fp32
        # parameters
        experts = {k: getattr(layer, k).to(x.dtype) for k in EXPERT_LEAVES}
    rows = None
    if comm.held < comm.ranks and experts_l is None:
        # one rank a process, no store: this rank's home experts, and its
        # replica slots' weights from a pool gathered over the ranks
        experts, rows = ep_dispatch.gather_replica_pool(experts, plan_l, moe,
                                                        comm)
    kw = dict(ep_ranks=R, activation=cfg.activation, resched_quota=resched_l,
              comm=comm, slot_rows=rows)
    if decode:
        # decode batches are too small to shard: every rank sees every
        # token, routed once, and serves the pairs bound for its slots
        t = x.reshape(B * S, d)
        w = None if token_weight is None else token_weight.reshape(B * S)
        if tp_mode and rt.rows_split:
            # expert TP: the data ranks' rows too, so every rank of the
            # world holds the whole batch
            data = rt.mesh.data_comm
            t = data.tp_gather(t, 0)
            w = None if w is None else data.tp_gather(w, 0)
        router_out = route(layer.router, moe, t)
        pred = (None if predicted_l is None
                else predicted_l.reshape(B * S, moe.top_k))
        y, stats = ep_dispatch.ep_moe_ffn_replicated(
            t, router_out, experts, plan_l, moe, predicted_idx=pred,
            tp_comm=rt.mesh.world_comm if tp_mode else None, **kw)
        if tp_mode and rt.rows_split:
            at = rt.mesh.data_index * B * S
            y = y[at:at + B * S]
        y = y.reshape(B, S, d)
    else:
        # the sequence splits over the ranks (the JAX package's
        # P(batch, "model", None)): rank r takes positions
        # [r*S/R, (r+1)*S/R) of every row; the held ranks' rows go through
        # the dispatch, and every rank's outputs are gathered back
        if S % R:
            raise ValueError(f"sequence length {S} does not split over "
                             f"{R} EP ranks")
        def split(a):
            return comm.local(
                a.reshape(B, R, S // R, *a.shape[2:]).transpose(0, 1)
                .reshape(R, B * (S // R), *a.shape[2:]))
        t = split(x)
        # the router sees this rank's positions only: under one rank a
        # process its gradient is summed over the ranks on the way back
        router_w = (layer.router if comm.held == comm.ranks
                    else comm.psum_grad(layer.router))
        router_out = route(router_w, moe, t)
        pred = None if predicted_l is None else split(predicted_l)
        y, stats = ep_dispatch.ep_moe_ffn(t, router_out, experts, plan_l,
                                          moe, predicted_idx=pred, **kw)
        y = comm.all_gather(y).reshape(R, B, S // R, d).transpose(0, 1) \
            .reshape(B, S, d)
        w = None if token_weight is None else split(token_weight)
    # the shared experts, then the dense residual branch, on every token,
    # outside the ranks (the JAX package adds them after the shard_map)
    moe_p = layer.moe_params()
    for branch in (shared_branch, dense_branch):
        extra = branch(moe_p, cfg, x)
        if extra is not None:
            y = y + extra
    counts = stats.expert_counts
    if w is not None:
        counts = expert_histogram(
            router_out.expert_idx, moe.num_experts,
            w[..., None].expand_as(router_out.expert_idx))
        if not decode and comm.held < comm.ranks:
            # this process's positions only: summed over the model axis
            counts = comm.psum(counts[None])
    return (y, counts, stats.slot_counts, stats.aux_loss, stats.z_loss,
            stats.dropped, stats.overflow)


def expert_tp_decode(cfg: ModelConfig, rt: Runtime) -> bool:
    """Whether a decode step's MoE layers run expert TP (the JAX package's
    ``tp_mode``): ``rt.decode_expert_tp`` under EP on a mesh, whose data
    ranks divide ``d_ff_expert``."""
    return bool(rt.decode_expert_tp and rt.ep and rt.mesh is not None
                and cfg.is_moe and cfg.moe.d_ff_expert % rt.mesh.data == 0)


def _f_block(w, name: str, mesh):
    """This data rank's block of an expert leaf's F columns (``w_gate`` /
    ``w_up`` dim 2, ``w_down`` dim 1): the leaf as it lies where its
    layout splits F over "data" (expert TP), else cut from the leaf
    gathered at use."""
    dim = 1 if name == "w_down" else 2
    rec = placement(w)
    if rec is not None and rec.data_dim == dim:
        return w
    whole = at_use(w)
    n = whole.shape[dim] // mesh.data
    return whole.narrow(dim, mesh.data_index * n, n).contiguous()


def _gathered_rows(rows, rec):
    """The replica store's rows of one weight, whole: split over "data"
    along the home experts' data dim (``rec``, their ``Placement``) where
    the layout splits them, as the store's rows take their layout."""
    if rec is None or rec.data_dim is None:
        return rows
    return rec.mesh.data_comm.fsdp_gather(rows, rec.data_dim)


def _attn_layer(layer: DecoderLayer, cfg: ModelConfig, x, positions,
                rt: Runtime, *, cache, cache_len=None, mode="prefill",
                block_tables=None, token_weight=None, plan_l=None,
                experts_l=None, fill_event=None, predicted_l=None,
                resched_l=None, enc_out=None):
    """GQA or MLA attention + MoE FFN (a dense FFN without MoE) for one
    layer. ``cache``: this layer's {"k", "v"} (linear cache in prefill,
    block pool in decode) or MLA's {"c_kv", "k_rope"} (linear), updated in
    place; None in train mode. An encoder-decoder's decoder layer attends
    over ``enc_out`` (train, prefill) between the two, and its cache also
    holds {"cross_k", "cross_v"}, which prefill fills and decode reads in
    full. Returns (x,
    (expert_counts (E,), slot_counts, aux, z, dropped, overflow)), and for
    a model without MoE (x, None): the plan, store, predictions and quota
    arguments are the MoE block's, which it then ignores."""
    # a non-parametric norm has no scale: getattr's None
    h = apply_norm(cfg.norm, getattr(layer, "ln1", None), x)
    if cfg.attention == "mla":
        a = _mla_layer(layer, cfg, h, positions, rt, cache, cache_len, mode,
                       block_tables)
    elif mode == "train":
        a = attn.gqa_attention(layer.attn_params(), cfg, h, positions,
                               window=rt.window(cfg))
    elif mode == "prefill":
        a = attn.gqa_prefill(layer.attn_params(), cfg, h, positions, cache,
                             window=rt.window(cfg))
    elif mode == "decode" and block_tables is not None:
        # the paged pool is linear in logical positions (window_override =
        # max_len only sizes caches) but decode still masks to the
        # architectural sliding window
        a = attn.gqa_decode_paged(layer.attn_params(), cfg, h, cache,
                                  block_tables, cache_len,
                                  window=cfg.sliding_window)
    elif mode == "decode" and torch.is_tensor(cache_len) \
            and cache_len.dim() == 1:
        # per-slot positions over a slotted linear cache, masked to the
        # architectural sliding window, as the JAX package decodes there
        a = attn.gqa_decode_multi(layer.attn_params(), cfg, h, cache,
                                  cache_len, window=cfg.sliding_window)
    elif mode == "decode":
        # one scalar position for the whole batch over a linear cache (or
        # a rotating buffer once the cache is as short as the window)
        a = attn.gqa_decode_windowed(layer.attn_params(), cfg, h, cache,
                                     cache_len, window=rt.window(cfg))
    else:
        raise ValueError(f"mode {mode!r}")
    x = x + a
    if cfg.is_encdec:
        h = apply_norm(cfg.norm, getattr(layer, "ln_cross", None), x)
        if mode == "decode":
            c = attn.cross_decode(layer.cross_params(), cfg, h,
                                  cache["cross_k"], cache["cross_v"])
        else:
            c, k, v = attn.cross_attention(layer.cross_params(), cfg, h,
                                           enc_out)
            if mode == "prefill":
                cache["cross_k"].copy_(k)
                cache["cross_v"].copy_(v)
        x = x + c
    h = apply_norm(cfg.norm, getattr(layer, "ln2", None), x)
    if not cfg.is_moe:
        return x + ffn(getattr(layer, "w_gate", None), layer.w_up,
                       layer.w_down, h, cfg.activation), None
    y, *stats = _moe_apply(layer, cfg, h, rt, plan_l, mode == "decode",
                           token_weight, experts_l, fill_event, predicted_l,
                           resched_l)
    return x + y, tuple(stats)


def _mla_layer(layer: DecoderLayer, cfg: ModelConfig, h, positions,
               rt: Runtime, cache, cache_len, mode: str, block_tables):
    """MLA in train, prefill or linear-cache decode (one scalar
    ``cache_len``); paged decode is GQA's alone, as in the JAX package."""
    p, window = layer.attn_params(), rt.window(cfg)
    if mode == "train":
        return attn.mla_attention(p, cfg, h, positions, window=window)
    if mode == "prefill":
        return attn.mla_prefill(p, cfg, h, positions, cache, window=window)
    if mode != "decode":
        raise ValueError(f"mode {mode!r}")
    if block_tables is not None:
        raise ValueError("MLA decodes over its linear latent cache: the "
                         "paged pool is GQA only")
    return attn.mla_decode(p, cfg, h, cache, int(cache_len), window=window)


def _hybrid_layer(layer: DecoderLayer, cfg: ModelConfig, x, positions, state,
                  mode: str, cache_len):
    """One hybrid block: recurrent block or local attention over the
    rotating window buffer, then the FFN. Window buffers are updated in
    place; a recurrent layer returns a new state. In train mode a
    recurrent layer starts from the zero state it is given (``_forward``
    makes it at this rank's width) and a local layer attends
    over the whole sequence within its window, with no buffer. Returns (x,
    state)."""
    h = apply_norm(cfg.norm, getattr(layer, "ln1", None), x)
    if layer.kind == "recurrent":
        a, state = griffin.recurrent_block(layer.rec_params(), cfg, h, state)
    elif mode == "train":
        a = attn.gqa_attention(layer.attn_params(), cfg, h, positions,
                               window=cfg.local_window)
    elif mode == "prefill":
        a = attn.gqa_prefill_windowed(layer.attn_params(), cfg, h, positions,
                                      state, window=cfg.local_window)
    elif mode == "decode":
        a = attn.gqa_decode_windowed(layer.attn_params(), cfg, h, state,
                                     cache_len, window=cfg.local_window)
    else:
        raise ValueError(f"mode {mode!r}")
    x = x + a
    y = ffn(getattr(layer, "w_gate", None), layer.w_up, layer.w_down,
            apply_norm(cfg.norm, getattr(layer, "ln2", None), x),
            cfg.activation)
    return x + y, state


def _encoder_layer(layer: DecoderLayer, cfg: ModelConfig, enc_cfg: ModelConfig,
                   x, positions):
    """One encoder layer (the JAX ``_encode``'s body): GQA projections at
    the encoder's widths with RoPE, non-causal attention, then the FFN,
    under the model's norm and activation."""
    B, S = x.shape[:2]
    z = apply_norm(cfg.norm, getattr(layer, "ln1", None), x)
    p = layer.attn_params()
    q, k, v = attn.gqa_project(p, enc_cfg, z, positions)
    a = attn.chunked_attention(q, k, v, causal=False)
    x = x + dense(p["wo"], a.reshape(B, S, -1))
    z = apply_norm(cfg.norm, getattr(layer, "ln2", None), x)
    return x + ffn(getattr(layer, "w_gate", None), layer.w_up, layer.w_down,
                   z, cfg.activation)


def _encode(model: Transformer, cfg: ModelConfig, frames, remat=False):
    """The encoder over ``frames`` (B, T_src, d_enc), cast to bf16, at
    positions ``arange(T_src)``, then ``enc_norm``. Returns (B, T_src,
    d_enc) bf16."""
    enc_cfg = encoder_config(cfg)
    x = frames.to(device=model.device, dtype=ACT_DTYPE)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    for layer in model.enc_layers:
        x = _run_layer(remat, _encoder_layer, layer, cfg, enc_cfg, x,
                       positions)
    return apply_norm(cfg.norm, at_use(getattr(model, "enc_norm", None)), x)


def _rwkv_layer(layer: DecoderLayer, cfg: ModelConfig, x, state):
    """One RWKV block: time mix, then channel mix, each after its norm and
    added to the residual. ``state``: the layer's {"shift_tm", "shift_cm",
    "wkv"} (not modified). Returns (x, new state)."""
    h = apply_norm(cfg.norm, layer.ln1, x)
    a, tm = rwkv6.time_mix(layer.rwkv_params("tm_"), cfg, h, state)
    x = x + a
    h = apply_norm(cfg.norm, layer.ln2, x)
    y, shift_cm = rwkv6.channel_mix(layer.rwkv_params("cm_"), h,
                                    state["shift_cm"])
    return x + y, {"shift_tm": tm["shift_tm"], "shift_cm": shift_cm,
                   "wkv": tm["wkv"]}


def _logits(model: Transformer, x):
    """The final norm, then ``lm_head``, or under tied embeddings the
    embedding table (the JAX ``unembed``)."""
    h = apply_norm(model.cfg.norm, at_use(getattr(model, "final_norm", None)),
                   x)
    if model.cfg.tie_embeddings:
        return unembed(at_use(model.embed), h)
    return dense(at_use(model.lm_head), h)


def _migration_view(l: int, plan: Optional[DevicePlan],
                    store: Optional[StoreView]):
    """Layer ``l``'s (plan, weights, fill event): without a store the plan
    row and the layer's home experts; with one, the live plan row and
    the store's rows until the layer's staged fill is ready, then the
    target plan row (its filled rows) and the fill's event."""
    plan_l = None if plan is None else plan.layer(l)
    if store is None:
        return plan_l, None, None
    experts = {k: w[l] for k, w in store.weights.items()}
    if store.ready is not None and store.ready[l]:
        event = store.events[l] if store.events is not None else None
        return store.target.layer(l), experts, event
    return plan_l, experts, None


def forward(model: Transformer, cfg: ModelConfig, tokens, rt: Runtime = Runtime(),
            *, mode: str, cache=None, cache_len=None, block_tables=None,
            last_pos=None, token_weight=None, plan=None, store=None,
            predicted_idx=None, resched=None, remat=False, frames=None,
            prefix_embeds=None):
    """Returns (logits, cache, stats).

    Under a process mesh (``rt.mesh``; a MoE model under EP) the model
    holds this rank's block of each parameter under its layout
    (``model.layout``, ``sharding``: the experts alone under "none", the
    tensor-parallel rules too under "specs", FSDP storage as well under
    "fsdp", whose shards each layer gathers at use, and the replica
    store's rows with them). In prefill and decode the batch
    splits over the data axis when the data ranks divide it
    (``Mesh.batch_rows``): this rank runs its rows, reading and writing
    its rows of a cache in place (the paged pool is whole on every rank:
    its block tables pick the rows' blocks; a cache holds this rank's KV
    heads or channels, ``local_config``); a MoE model's statistics are
    summed (the losses averaged) over the data axis, and the logits
    gathered over it, so every rank returns the whole batch's. A batch
    the data ranks do not divide runs whole on each of them. Under
    ``rt.decode_expert_tp`` a decode step's MoE layers run expert TP
    (``expert_tp_decode``, ``_moe_apply``): their statistics are the
    whole batch's on every rank, and are not summed again. In train
    mode (a MoE model under EP, without replica slots) ``tokens`` are the
    rows this rank trains on, which ``train.steps.make_train_step``
    picks: the logits and statistics are theirs, the counts and losses
    summed and averaged over the model axis only, and nothing crosses the
    data axis. Without a tensor-parallel layout a model without MoE
    computes the same rows alike on every model rank.

    mode=train:   tokens (B, S); logits (B, S, V) over every position,
                  cache None, recurrent layers from zero states. Under
                  ``rt.ep`` each MoE layer runs the prefill's sequence split
                  through the EP dispatch under ``plan`` (None: the
                  identity plan), its grouped FFN through
                  ``kernels.ops.MoeGemm``; a ``store``, ``predicted_idx``
                  or ``resched`` raises, as the JAX train step takes none.
                  ``remat``: each layer runs under ``torch.utils.checkpoint``
                  (non-reentrant) and is recomputed in the backward.
    mode=prefill: tokens (B, S); logits (B, 1, V) at ``last_pos`` (the index
                  of each request's last real token; default the padded
                  end); fills ``cache`` (a fresh one when None).
    mode=decode:  tokens (B, 1); with ``block_tables`` (B, M) int32,
                  ``cache`` is the block pool {"k", "v"}: (L, N, bs, K, hd)
                  and ``cache_len`` the (B,) int32 lengths; without, the
                  prefill's cache and ``cache_len`` one int, the length
                  before this token, or a (B,) tensor of per-slot lengths
                  over a slotted linear cache. Logits (B, 1, V).
    ``prefix_embeds``: under ``input_mode="mixed"`` (the VLM), (B, P, d)
    patch embeddings placed before the tokens in train and prefill mode
    (``_embed_inputs``): the sequence is then P + S long, train logits
    cover all of it, and prefill fills P + S cache positions. Decode, and
    a config of another ``input_mode``, ignore it.
    ``token_weight``: (B, S) weight of each token in the expert histogram
    (0 for padding / idle slots). ``plan``: the (L, ...) placement plan
    stack the EP path dispatches under, a ``DevicePlan`` (see
    ``core.placement.to_device``) or a host ``PlacementPlan``; None is the
    identity plan. ``store``: a ``StoreView`` of the replica store, whose
    rows ``plan`` (then a ``DevicePlan`` made with the store's
    ``slot_rows``) indexes; None reads the home experts.
    ``predicted_idx``: None, or (L, B, S, K) Token-to-Expert predicted
    experts, which the EP prefill dispatches on (a correction round takes
    the mispredicted pairs); the dense path ignores them and the EP decode
    path raises on them. ``resched``: None, or the (L, E, C_max) int32
    reschedule quota stack (``repro_torch.schedule``) the EP dispatch
    picks replicas through, with a rescue round for the pairs that
    overflow; the dense path ignores it.
    RWKV runs every layer from its stacked state (train mode from zeros)
    and writes the new one into ``cache`` in place; decode ignores
    ``cache_len``.
    An encoder-decoder runs its encoder on ``frames`` (B, T_src, d_enc) in
    train and prefill mode (without them it raises ``KeyError``, as the
    JAX forward reads ``batch["frames"]``); prefill fills the cache's
    ``cross_k`` / ``cross_v`` (made anew when they hold another number of
    frames), and decode reads them and ignores ``frames``.
    A model without MoE (dense, hybrid, RWKV) ignores ``token_weight``,
    ``plan``, ``store``, ``predicted_idx`` and ``resched``; its stats are
    ``NO_MOE_STATS`` (no expert counts, zero aux and z losses).
    stats: {"expert_counts": (L, E) fp32, "aux_loss",
    "z_loss"}, and under EP also "slot_counts": (L, R * n_slots) kept pairs
    per global slot, "dropped": (L,) pairs dropped at capacity and
    "overflow": (L,) round-1 overflows the rescue round took (without
    ``resched`` a host vector of zeros: nothing is launched for it).
    """
    kw = dict(mode=mode, cache=cache, cache_len=cache_len,
              block_tables=block_tables, last_pos=last_pos,
              token_weight=token_weight, plan=plan, store=store,
              predicted_idx=predicted_idx, resched=resched, remat=remat,
              frames=frames, prefix_embeds=prefix_embeds)
    if rt.mesh is None:
        return _forward(model, cfg, tokens, rt, **kw)
    if cfg.is_moe and not rt.ep:
        raise ValueError("on a process mesh a MoE model runs under EP "
                         "(Runtime(ep=True)): each rank holds its experts")
    if rt.ep and rt.ep_ranks != rt.mesh.model:
        raise ValueError(f"ep_ranks {rt.ep_ranks} on a mesh of model axis "
                         f"{rt.mesh.model}")
    if mode == "train":
        if rt.ep and cfg.moe.duplication_slots:
            raise ValueError("training across processes runs without "
                             "replica slots (the JAX launcher's "
                             "use_duplication=False)")
        # the train step hands each rank its data rows and reduces over
        # the data axis itself
        return _forward(model, cfg, tokens, rt, **kw)
    if rt.rows_split:
        # the caller's rows already (the dry run's per-rank trees): the
        # step of a split batch, without the cuts
        logits, cache, stats = _forward(model, cfg, tokens, rt, **kw)
        return _rows_joined(cfg, rt, logits, cache, stats, mode,
                            tokens.shape[0] * rt.mesh.data,
                            resched is not None)
    rows = rt.mesh.batch_rows(tokens.shape[0])
    if rows is None:
        return _forward(model, cfg, tokens, rt, **kw)
    rt = rt._replace(rows_split=True)
    for k in ("token_weight", "last_pos", "block_tables", "frames",
              "prefix_embeds"):
        if kw[k] is not None:
            kw[k] = kw[k][rows]
    if torch.is_tensor(cache_len):
        kw["cache_len"] = cache_len[rows]
    if predicted_idx is not None:
        kw["predicted_idx"] = predicted_idx[:, rows]
    if block_tables is None:
        if cache is None:
            cache = init_cache(local_config(model, cfg), rt, tokens.shape[0],
                               tokens.shape[1], device=model.device,
                               source_len=None if frames is None
                               else frames.shape[1])
        if cfg.is_encdec and mode == "prefill" and frames is not None:
            # the cross K and V over these frames, made anew for the whole
            # batch when they hold another number (as ``_forward`` does)
            for name in ("cross_k", "cross_v"):
                if cache[name].shape[2] != frames.shape[1]:
                    shape = list(cache[name].shape)
                    shape[2] = frames.shape[1]
                    cache[name] = cache[name].new_empty(shape)
        kw["cache"] = _cache_rows(cache, rows)
    logits, out_cache, stats = _forward(model, cfg, tokens[rows], rt, **kw)
    if block_tables is None and cfg.family == "hybrid":
        # a recurrent layer's new state: written back into these rows
        for whole, mine in zip(cache, out_cache):
            for name, t in mine.items():
                whole[name][rows] = t
    return _rows_joined(cfg, rt, logits,
                        cache if block_tables is None else out_cache, stats,
                        mode, tokens.shape[0], resched is not None)


def _rows_joined(cfg: ModelConfig, rt: Runtime, logits, cache, stats,
                 mode: str, batch: int, quota: bool):
    """What every data rank returns of a batch it ran its rows of: a MoE
    model's statistics summed over the data axis, and the logits of all
    ``batch`` rows gathered over it. ``quota``: the step ran under a
    reschedule quota, so its overflow counts are device counts to sum."""
    data = rt.mesh.data_comm
    if cfg.is_moe and not (mode == "decode" and expert_tp_decode(cfg, rt)):
        # summed over the data axis (expert-TP decode routed the whole
        # batch on every rank: its statistics are global already): the
        # counts in one collective (the host zero overflow without a quota
        # stays as it is, whatever the device), the losses in one
        keys = ["expert_counts", "slot_counts", "dropped"] + (
            ["overflow"] if quota else [])
        stats.update(zip(keys, data.psum_counts(*(stats[k][None]
                                                  for k in keys))))
        stats["aux_loss"], stats["z_loss"] = data.pmean_losses(
            *(torch.as_tensor(stats[k], device=logits.device)[None]
              for k in ("aux_loss", "z_loss")))
    logits = data.all_gather(logits[None]).reshape(
        (batch,) + logits.shape[1:])
    return logits, cache, stats


def _cache_rows(cache, rows):
    """The views of a cache's batch rows ``rows`` (a uniform stack's or
    RWKV's (L, B, ...) tensors, or a hybrid model's per-layer states of
    (B, ...) tensors), which a forward updates in place."""
    if isinstance(cache, list):
        return [{k: t[rows] for k, t in st.items()} for st in cache]
    return {k: t[:, rows] for k, t in cache.items()}


def _forward(model: Transformer, cfg: ModelConfig, tokens, rt: Runtime, *,
             mode: str, cache, cache_len, block_tables, last_pos,
             token_weight, plan, store, predicted_idx, resched, remat, frames,
             prefix_embeds):
    """``forward`` on the rows this process runs."""
    if mode == "train" and rt.ep and (store is not None or predicted_idx
                                      is not None or resched is not None):
        raise ValueError("EP training takes a plan only: no store, "
                         "predicted_idx or resched (the JAX train step "
                         "takes none of them)")
    enc_out = None
    if cfg.is_encdec and mode != "decode":
        if frames is None:
            raise KeyError("frames")
        enc_out = _encode(model, cfg, frames, remat)
    if cfg.is_encdec and block_tables is not None:
        raise ValueError("an encoder-decoder decodes over its linear cache: "
                         "the paged pool has no cross-attention cache")
    x = _embed_inputs(model, cfg, tokens,
                      None if mode == "decode" else prefix_embeds)
    B, S = x.shape[:2]
    if mode == "decode" and torch.is_tensor(cache_len):
        positions = cache_len.long()[:, None]
    elif mode == "decode":
        positions = torch.full((B, 1), cache_len, dtype=torch.long,
                               device=x.device)
    else:
        positions = torch.arange(S, device=x.device).expand(B, S)
        if cache is None and mode != "train":
            cache = init_cache(local_config(model, cfg), rt, B, S,
                               device=x.device, source_len=(
                                   None if enc_out is None
                                   else enc_out.shape[1]))
        if mode == "prefill" and cfg.is_encdec:
            # the cross K and V of every layer over this source
            shape = (cfg.num_layers, B, enc_out.shape[1],
                     local_config(model, cfg).num_kv_heads, cfg.head_dim)
            for name in ("cross_k", "cross_v"):
                if tuple(cache[name].shape) != shape:
                    cache[name] = cache["k"].new_empty(shape)
    if cfg.family == "hybrid":
        cache = [None] * cfg.num_layers if cache is None else list(cache)
        for l, layer in enumerate(model.layers):
            if mode == "train" and layer.kind == "recurrent":
                cache[l] = griffin.init_recurrent_state(
                    local_config(model, cfg), B, x.dtype, x.device)
            x, cache[l] = _run_layer(
                remat, _hybrid_layer, layer, cfg, x, positions, cache[l],
                mode, cache_len)
        return (_last_logits(model, x, mode, last_pos),
                None if mode == "train" else cache, dict(NO_MOE_STATS))
    if cfg.family == "ssm":
        for l, layer in enumerate(model.layers):
            st = (rwkv6.init_rwkv_state(local_config(model, cfg), B,
                                        device=x.device)
                  if mode == "train" else _layer_cache(cache, l))
            x, new = _run_layer(remat, _rwkv_layer, layer, cfg, x, st)
            if mode != "train":
                for name, t in new.items():
                    st[name].copy_(t)
        return (_last_logits(model, x, mode, last_pos),
                None if mode == "train" else cache, dict(NO_MOE_STATS))
    if not cfg.is_moe:
        # the dense family: no router, so nothing to dispatch, plan or
        # count (the JAX forward's stats for a model without MoE)
        for l, layer in enumerate(model.layers):
            cache_l = None if cache is None else _layer_cache(cache, l)
            x, _ = _run_layer(remat, _attn_layer, layer, cfg, x, positions,
                              rt, cache=cache_l, cache_len=cache_len,
                              mode=mode, block_tables=block_tables,
                              enc_out=enc_out)
        return _last_logits(model, x, mode, last_pos), cache, dict(NO_MOE_STATS)
    if store is not None and not isinstance(plan, DevicePlan):
        raise ValueError("a store view needs a DevicePlan of its rows")
    if plan is not None and not isinstance(plan, DevicePlan):
        m = cfg.moe
        plan = to_device(plan, m.num_experts, rt.ep_ranks,
                         m.duplication_slots, x.device)
    counts, slots, dropped, overflow, aux, z = [], [], [], [], 0.0, 0.0
    tp_mode = mode == "decode" and expert_tp_decode(cfg, rt)
    for l, layer in enumerate(model.layers):
        cache_l = None if cache is None else _layer_cache(cache, l)
        plan_l, experts_l, event = _migration_view(l, plan, store)
        # the MoE layer gathers the store's rows, or computes with its
        # blocks under expert TP, in place of the home experts gathered
        keep = EXPERT_LEAVES if tp_mode or experts_l is not None else ()
        x, (c, sc, a_l, z_l, dr, ov) = _run_layer(
            remat, _attn_layer,
            layer, cfg, x, positions, rt, cache=cache_l, cache_len=cache_len,
            mode=mode, block_tables=block_tables, token_weight=token_weight,
            plan_l=plan_l, experts_l=experts_l, fill_event=event,
            predicted_l=None if predicted_idx is None else predicted_idx[l],
            resched_l=None if resched is None else resched[l], keep=keep)
        counts.append(c)
        slots.append(sc)
        dropped.append(dr)
        overflow.append(ov)
        aux = aux + a_l
        z = z + z_l
    stats = {"expert_counts": torch.stack(counts), "aux_loss": aux,
             "z_loss": z}
    if rt.ep:
        stats["slot_counts"] = torch.stack(slots)
        stats["dropped"] = torch.stack(dropped)
        stats["overflow"] = torch.stack(overflow)
    return _last_logits(model, x, mode, last_pos), cache, stats


def _embed_inputs(model: Transformer, cfg: ModelConfig, tokens,
                  prefix_embeds=None):
    """The token embeddings (B, S, d), with, under ``input_mode="mixed"``,
    ``prefix_embeds`` (B, P, d) cast to the embedding's dtype and placed
    before them; in the activation dtype (the JAX ``_embed_inputs``)."""
    x = embed(at_use(model.embed), tokens)
    if cfg.input_mode == "mixed" and prefix_embeds is not None:
        x = torch.cat([torch.as_tensor(prefix_embeds).to(x.device, x.dtype),
                       x], dim=1)
    return x.to(ACT_DTYPE)


def _layer_cache(cache, l: int):
    """Layer ``l``'s views of a uniform stack's cache ({"k", "v"} or MLA's
    {"c_kv", "k_rope"}), which the layer updates in place."""
    return {name: t[l] for name, t in cache.items()}


def _run_layer(remat: bool, fn, layer, *args, keep=(), **kwargs):
    """``fn(layer, *args, **kwargs)`` (on its ``LayerAtUse`` when the layer
    ``gathers_at_use``, the leaves named in ``keep`` as they lie), under a
    non-reentrant activation checkpoint when ``remat``: only the layer's
    inputs are kept, and the layer runs again in the backward (the JAX
    package's ``jax.checkpoint``), gathering its FSDP shards again."""
    def body(layer, *args, **kwargs):
        return fn(LayerAtUse(layer, keep) if layer.gathers_at_use else layer,
                  *args, **kwargs)
    if not remat:
        return body(layer, *args, **kwargs)
    return torch.utils.checkpoint.checkpoint(body, layer, *args,
                                             use_reentrant=False, **kwargs)


def _last_logits(model: Transformer, x, mode: str, last_pos):
    """Logits at each row's last real position in prefill (``last_pos``,
    default the padded end), at the one position in decode, at every
    position in train mode."""
    if mode == "prefill":
        if last_pos is not None:
            x = x[torch.arange(x.shape[0], device=x.device),
                  last_pos.long()][:, None]
        else:
            x = x[:, -1:]
    return _logits(model, x)
