"""Analytic roofline of one serving or training step on the port's card.

Three terms per (arch x shape x chips), in seconds:

  compute    = analytic FLOPs per device / peak FLOP/s
  memory     = analytic HBM bytes per device / HBM bytes/s
  collective = collective bytes per device / link bytes/s

The op model (``analytic_flops``, ``analytic_hbm_bytes``, ``model_flops``)
is the JAX package's ``roofline.py``, term for term, so one config and
shape give the same numbers in both packages. The JAX package reads its
per-device HLO and collective bytes and its memory analysis from a
compiled XLA program. Eager PyTorch has no compiled program; the port's
dry run (``launch.dryrun``) runs one rank's step on ``meta`` tensors and
counts instead, and ``analyze`` takes those counts (``counts``):

  collective_bytes_per_device  the result bytes of every collective the
                               rank issued, by kind in
                               ``collective_breakdown`` (with "count");
  argument_bytes               the step's parameters, moments, cache and
                               inputs on this rank;
  peak_bytes                   the high-water mark of live ``meta``
                               storage while the step ran (arguments
                               included), ``temp_bytes`` = peak -
                               arguments, ``output_bytes`` the results;
  executed_flops_per_device    the operations of every PyTorch operator
                               the step ran (``torch.utils.flop_counter``'s
                               table) plus its kernels' (``kernels.work``);
  executed_bytes_per_device    each operator's inputs and outputs plus its
                               kernels' bytes: what eager execution moves,
                               unfused.

The ``hlo_*`` fields stay 0: there is no HLO. Without counts the
collective and memory fields are 0 as well.

Hardware constants: NVIDIA H100 SXM 80GB HBM3 at 700 W, from the data
sheet, as ``core.simulator.H100_SXM_NVLINK`` holds them: 989 TFLOP/s dense
bf16, 3.35 TB/s HBM3, 900 GB/s NVLink 4 per GPU. They are peak figures,
not measurements. A 16 x 16 mesh of 256 cards spans 32 nodes of 8, whose
traffic between nodes runs over the network at a fraction of NVLink's
rate, so ``collective_s`` at 900 GB/s is a lower bound there.
"""

from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field
from typing import Dict

from repro_torch.core.simulator import (H100_SXM_NVLINK, attention_flops,
                                        dense_ffn_flops_per_token,
                                        ffn_flops_per_token)

# --------------------------------------------------------------------------
# hardware constants (H100 SXM, data sheet)
# --------------------------------------------------------------------------

PEAK_FLOPS = H100_SXM_NVLINK.peak_flops      # dense bf16 per card
HBM_BW = H100_SXM_NVLINK.hbm_bw              # bytes/s per card
LINK_BW = H100_SXM_NVLINK.link_bw            # NVLink bytes/s per card


def _recurrent_layers(cfg) -> int:
    L = cfg.num_layers
    return sum(1 for i in range(L)
               if cfg.block_pattern[i % len(cfg.block_pattern)]
               == "recurrent") if cfg.block_pattern else 0


# --------------------------------------------------------------------------
# analytic op model
# --------------------------------------------------------------------------

def analytic_flops(cfg, shape) -> float:
    """Per-STEP total (all devices) FLOPs for the step a shape lowers."""
    L, d, V = cfg.num_layers, cfg.d_model, cfg.vocab_size

    if shape.kind == "decode":
        tokens = shape.global_batch
        ctx = shape.seq_len
        w = cfg.sliding_window or (4096 if shape.name == "long_500k" else 0)
        s_eff = min(ctx, w) if w else ctx
        if cfg.family == "ssm":
            per_tok_layer = 14 * d * d            # rwkv6 time+channel mix
            attn = per_tok_layer * tokens * L
        elif cfg.family == "hybrid":
            dr = cfg.rnn_width or d
            rec_l = (4 * d * dr + 3 * dr) * 2 * tokens   # gates + out proj
            loc_l = attention_flops(cfg, tokens, min(ctx, cfg.local_window))
            n_rec = _recurrent_layers(cfg)
            attn = rec_l * n_rec + loc_l * (L - n_rec)
        else:
            attn = attention_flops(cfg, tokens, s_eff, causal=False) * L
        ffn = (ffn_flops_per_token(cfg)
               + dense_ffn_flops_per_token(cfg)) * tokens * L
        head = 2 * tokens * d * V
        return attn + ffn + head

    tokens = shape.global_batch * shape.seq_len
    if cfg.input_mode == "mixed" and cfg.num_prefix_embeddings:
        # a VLM's patch embeddings run every layer too (the attention
        # terms keep the text length, as the JAX formula does)
        tokens = shape.global_batch * (shape.seq_len
                                       + cfg.num_prefix_embeddings)
    if cfg.family == "ssm":
        attn = 14 * d * d * tokens * L
    elif cfg.family == "hybrid":
        dr = cfg.rnn_width or d
        rec_l = (4 * d * dr + 3 * dr) * 2 * tokens
        loc_l = attention_flops(cfg, tokens, min(shape.seq_len,
                                                 cfg.local_window))
        n_rec = _recurrent_layers(cfg)
        attn = rec_l * n_rec + loc_l * (L - n_rec)
    else:
        attn = attention_flops(cfg, tokens, shape.seq_len) * L
    ffn = (ffn_flops_per_token(cfg) + dense_ffn_flops_per_token(cfg)) \
        * tokens * L
    head = 2 * tokens * d * V
    enc = 0.0
    if cfg.is_encdec:
        # the JAX formula: max_source_len frames a row whatever the input,
        # the decoder's attention terms (causal), three FFN matrices
        e = cfg.encoder
        etoks = shape.global_batch * e.max_source_len
        enc = (attention_flops(cfg, etoks, e.max_source_len)
               + 2 * 3 * e.d_model * e.d_ff * etoks) * e.num_layers
    fwd = attn + ffn + head + enc
    return 3.0 * fwd if shape.kind == "train" else fwd


def analytic_hbm_bytes(cfg, shape, chips: int, *, act_coeff: float = 10.0
                       ) -> float:
    """Per-DEVICE HBM traffic per step (weights + activations + cache/opt).

    * weights: each device reads its resident shard once per step (train:
      + grad write + fp32 Adam moments read+write);
    * duplication: with ``duplication_slots > 0`` the replica store adds
      one read of the extra slot entries per MoE layer per step;
    * activations: ~``act_coeff`` residency round-trips per layer;
    * decode: the full KV-cache shard read per step (RWKV: its fp32 WKV
      state)."""
    B = 2  # bf16
    params = cfg.num_params()
    w = params * B / chips
    if (cfg.moe is not None and cfg.moe.duplication_slots > 0
            and shape.kind != "train"):
        e = cfg.moe
        ff_mult = 3 if cfg.activation == "swiglu" else 2
        expert_bytes = ff_mult * cfg.d_model * e.d_ff_expert * B
        w += e.duplication_slots * expert_bytes * cfg.num_layers
    if shape.kind == "train":
        # fwd read + bwd read + grad write (bf16) + moments r/w (fp32 x2 x2)
        w = params * (4 * 3 + 2 * 2 + 4 * 4) / chips / 2  # fp32 params
    tokens_local = shape.global_batch * shape.seq_len / chips
    if shape.kind == "decode":
        tokens_local = max(shape.global_batch / chips, 1.0 / chips)
    act = act_coeff * tokens_local * cfg.d_model * B * cfg.num_layers
    if shape.kind == "train":
        act *= 2.0        # bwd re-reads activations
    cache = 0.0
    if shape.kind == "decode":
        w_win = cfg.sliding_window or (4096 if shape.name == "long_500k" else 0)
        clen = min(shape.seq_len, w_win) if w_win else shape.seq_len
        if cfg.family == "ssm":
            state = cfg.num_heads * cfg.head_dim * cfg.head_dim * 4
            cache = shape.global_batch * state * cfg.num_layers / chips
        elif cfg.family == "hybrid":
            dr = cfg.rnn_width or cfg.d_model
            cache = shape.global_batch * (dr * 4 + cfg.local_window
                                          * cfg.num_kv_heads * cfg.head_dim
                                          * B) * cfg.num_layers / chips
        elif cfg.attention == "mla" and cfg.mla is not None:
            # the latent cache: c_kv and the shared k_rope per position
            cache = (shape.global_batch * clen
                     * (cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim) * B
                     * cfg.num_layers / chips)
        else:
            cache = (shape.global_batch * clen * 2 * cfg.num_kv_heads
                     * cfg.head_dim * B * cfg.num_layers / chips)
        cache = max(cache, 0.0)
    return w + act + cache


def model_flops(cfg, shape) -> float:
    """6·N_active·D for training, 2·N_active·D for inference (per step):
    the "useful compute" yardstick. N_active counts only the activated
    experts; D = tokens the step processes (decode: one per sequence), the
    text alone: a VLM's patch embeddings are left out, as the JAX formula
    leaves them out."""
    n = cfg.active_params()
    tokens = shape.global_batch * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch          # decode: 1 new token/seq


# --------------------------------------------------------------------------
# report
# --------------------------------------------------------------------------

@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # analytic op model (the compute and memory terms)
    analytic_flops_per_device: float
    analytic_hbm_per_device: float
    # compiled-program figures (the JAX package's HLO analysis; 0 here)
    hlo_flops_per_device: float
    hlo_bytes_per_device: float
    collective_bytes_per_device: float
    collective_breakdown: Dict[str, int] = field(default_factory=dict)
    model_flops_total: float = 0.0
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    peak_bytes: int = 0
    # the dry run's counted work (``launch.dryrun``; 0 without it)
    executed_flops_per_device: float = 0.0
    executed_bytes_per_device: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.analytic_flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.analytic_hbm_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def total_s(self) -> float:
        """Roofline step time = max of the three overlappable terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / analytic FLOPs: the share of the executed compute
        that is 6ND/2ND work."""
        total = self.analytic_flops_per_device * self.chips
        return self.model_flops_total / total if total else 0.0

    def row(self) -> Dict:
        d = asdict(self)
        d.update(compute_s=self.compute_s, memory_s=self.memory_s,
                 collective_s=self.collective_s, dominant=self.dominant,
                 total_s=self.total_s,
                 useful_flops_ratio=self.useful_flops_ratio)
        return d


def analyze(arch: str, shape, mesh_name: str, chips: int, cfg,
            counts=None) -> RooflineReport:
    """The report of ``cfg`` at ``shape`` over ``chips`` cards: the
    analytic terms, and with ``counts`` (``launch.dryrun.trace_one``'s) the
    counted collective bytes, memory and executed work of one rank."""
    c = counts or {}
    coll = c.get("collectives", {})
    return RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        analytic_flops_per_device=analytic_flops(cfg, shape) / chips,
        analytic_hbm_per_device=analytic_hbm_bytes(cfg, shape, chips),
        hlo_flops_per_device=0.0, hlo_bytes_per_device=0.0,
        collective_bytes_per_device=float(sum(
            v for k, v in coll.items() if k != "count")),
        collective_breakdown={k: int(v) for k, v in coll.items() if v},
        model_flops_total=model_flops(cfg, shape),
        argument_bytes=int(c.get("argument_bytes", 0)),
        output_bytes=int(c.get("output_bytes", 0)),
        temp_bytes=int(c.get("peak_bytes", 0) - c.get("argument_bytes", 0)),
        peak_bytes=int(c.get("peak_bytes", 0)),
        executed_flops_per_device=float(c.get("flops", 0.0)),
        executed_bytes_per_device=float(c.get("bytes", 0.0)))


def save_report(path: str, report: RooflineReport) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(report.row(), f, indent=1)
