"""MoE-GPS performance simulator: the port's copy of the JAX package's
``core/simulator.py`` (plain Python, the same arithmetic).

One MoE transformer layer's prefill latency under a prediction strategy,
on a throughput roofline: ``time(op) = max(flops / (peak_flops * util),
bytes / hbm_bw)``; collectives cost ``bytes / link_bw``. The layer splits
into attention (tensor-parallel over N devices), the ring all-reduce after
it, the dispatch all-to-all, the expert FFN (bottlenecked by the most
loaded device), the combine all-to-all and the prediction overhead
(Token-to-Expert only). Load factors (paper Sec 3.3, Fig 5): no prediction
loads compute and communication by the skew; Distribution-Only balances
compute to ``1 + eps`` and leaves communication at the skew; Token-to-
Expert balances compute and pays dispatch only for mispredicted tokens.

Hardware presets:

* ``A100_NVLINK`` and ``A100_PCIE``: the paper's validation points (4x
  A100, NVLink 3 or PCIe 4).
* ``H100_SXM_NVLINK``: the 4-card HGX H100 deployment the port's card
  belongs to. Peak dense bf16 (989 TFLOP/s) and HBM3 rate (3.35 TB/s) are
  the data sheet's; the link is NVLink 4's 900 GB/s per GPU, counted as
  ``A100_NVLINK`` counts NVLink 3's 600 GB/s. One card cannot measure
  the link, so it is modelled. ``mxu_util`` 0.45 is the port's own
  expert-GEMM rate on this card (``moe_gemm``'s prefill shape, measured by
  ``chip_smoke.py``'s kernel phase) over the peak.

The JAX package's TPU presets are not copied: the port states no rate
taken on or for a TPU. ``HardwareConfig`` takes any deployment.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict

from repro_torch.configs.base import ModelConfig
from repro_torch.core.balance import bottleneck_factor, comm_factor


# ---------------------------------------------------------------------------
# hardware
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HardwareConfig:
    name: str
    num_devices: int
    peak_flops: float            # per device, bf16/fp16 FLOP/s
    hbm_bw: float                # per device, bytes/s
    link_bw: float               # per device interconnect bandwidth, bytes/s
    mxu_util: float = 0.7        # achievable fraction of peak on big GEMMs
    topology: str = "fully_connected"   # fully_connected | torus2d
    torus_links_per_axis: int = 2

    def with_(self, **kw) -> "HardwareConfig":
        return dataclasses.replace(self, **kw)


# Paper validation points: 4x A100 (312 TF/s bf16, 2.0 TB/s HBM) fully
# connected over NVLink 3.0 (600 GB/s/GPU) or PCIe 4.0 (Fig 7 uses 64 GB/s).
A100_NVLINK = HardwareConfig("4xA100-NVLink", 4, 312e12, 2.0e12, 600e9)
A100_PCIE = HardwareConfig("4xA100-PCIe", 4, 312e12, 2.0e12, 64e9)
# 4x H100 SXM (989 TF/s dense bf16, 3.35 TB/s HBM3) over NVLink 4
# (900 GB/s/GPU, modelled); mxu_util = moe_gemm's prefill rate on the card.
H100_SXM_NVLINK = HardwareConfig("4xH100-SXM-NVLink", 4, 989e12, 3.35e12,
                                 900e9, mxu_util=0.45)

PRESETS: Dict[str, HardwareConfig] = {
    h.name: h for h in (A100_NVLINK, A100_PCIE, H100_SXM_NVLINK)
}


# ---------------------------------------------------------------------------
# op model
# ---------------------------------------------------------------------------

BYTES = 2  # bf16 / fp16 everywhere


def gemm_time(hw: HardwareConfig, flops: float, bytes_moved: float) -> float:
    """Roofline: compute-bound or HBM-bound, whichever dominates."""
    return max(flops / (hw.peak_flops * hw.mxu_util),
               bytes_moved / hw.hbm_bw)


def elementwise_time(hw: HardwareConfig, bytes_moved: float) -> float:
    return bytes_moved / hw.hbm_bw


def allreduce_time(hw: HardwareConfig, bytes_per_device: float) -> float:
    """Ring all-reduce: each device sends/receives 2(N-1)/N of its shard."""
    n = hw.num_devices
    return 2 * (n - 1) / n * bytes_per_device / hw.link_bw


def alltoall_time(hw: HardwareConfig, bottleneck_bytes: float) -> float:
    """All-to-all bottlenecked by the busiest device, at the per-device
    injection bandwidth."""
    return bottleneck_bytes / hw.link_bw


# ---------------------------------------------------------------------------
# per-layer workload terms
# ---------------------------------------------------------------------------

def _ffn_mult(activation: str) -> int:
    return 3 if activation == "swiglu" else 2


def attention_flops(cfg: ModelConfig, tokens: int, seq: int,
                    causal: bool = True) -> float:
    """One layer of attention (projections + scores + values + output).
    ``causal=False`` for decode (each query sees the whole context)."""
    if cfg.attention == "mla" and cfg.mla is None:
        raise NotImplementedError(
            "attention 'mla' without its MLAConfig has no port formula")
    d, hd = cfg.d_model, cfg.head_dim
    H, KV = cfg.num_heads, cfg.num_kv_heads
    s_eff = min(seq, cfg.sliding_window) if cfg.sliding_window else seq
    disc = 0.5 if (causal and s_eff == seq) else 1.0   # window keeps full width
    if cfg.attention == "mla":
        m = cfg.mla
        proj = 2 * tokens * d * (m.kv_lora_rank + m.rope_head_dim)       # down
        proj += 2 * tokens * m.kv_lora_rank * H * (m.nope_head_dim
                                                   + m.v_head_dim)
        qd = m.q_lora_rank or d
        proj += 2 * tokens * qd * H * (m.nope_head_dim + m.rope_head_dim)
        proj += 2 * tokens * H * m.v_head_dim * d                        # out
        hd_eff = m.nope_head_dim + m.rope_head_dim
        score = 2 * tokens * s_eff * H * hd_eff * disc
        value = 2 * tokens * s_eff * H * m.v_head_dim * disc
        return proj + 2 * (score + value)
    proj = 2 * tokens * d * (H + 2 * KV) * hd
    out = 2 * tokens * H * hd * d
    sv = 2 * 2 * tokens * s_eff * H * hd * disc
    return proj + out + sv


def ffn_flops_per_token(cfg: ModelConfig) -> float:
    """Routed-expert FLOPs per token (top-k experts)."""
    if cfg.moe is None:
        return 2 * _ffn_mult(cfg.activation) * cfg.d_model * cfg.d_ff
    e = cfg.moe
    return 2 * _ffn_mult(cfg.activation) * cfg.d_model * e.d_ff_expert * e.top_k


def dense_ffn_flops_per_token(cfg: ModelConfig) -> float:
    """Always-on FFN FLOPs per token (shared experts + dense residual)."""
    if cfg.moe is None:
        return 0.0
    e = cfg.moe
    f = 2 * _ffn_mult(cfg.activation) * cfg.d_model
    total = e.num_shared_experts * f * e.d_ff_expert
    if e.dense_residual:
        total += f * (e.d_ff_dense or cfg.d_ff)
    return total


def expert_bytes(cfg: ModelConfig) -> float:
    """Weight bytes of ONE expert (the unit moved by duplication)."""
    if cfg.moe is None:
        return 0.0
    return _ffn_mult(cfg.activation) * cfg.d_model * cfg.moe.d_ff_expert * BYTES


# ---------------------------------------------------------------------------
# latency model
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class LatencyBreakdown:
    attention: float
    allreduce: float
    dispatch: float
    ffn: float
    combine: float
    overhead: float
    strategy: str = ""
    accuracy: float = 0.0

    @property
    def total(self) -> float:
        return (self.attention + self.allreduce + self.dispatch + self.ffn
                + self.combine + self.overhead)

    def as_dict(self) -> Dict[str, float]:
        return {"attention": self.attention, "allreduce": self.allreduce,
                "dispatch": self.dispatch, "ffn": self.ffn,
                "combine": self.combine, "overhead": self.overhead,
                "total": self.total}


def layer_latency(
    cfg: ModelConfig,
    hw: HardwareConfig,
    *,
    batch: int,
    seq: int,
    skew: float,
    strategy: str = "none",          # none | dist_only | token_to_expert
    eps: float = 0.0,                # prediction error rate of the strategy
    overhead_frac: float = 0.0,      # T2E predictor cost / no-overhead runtime
    scenario: str = "typical",
    comm_model: str = "paper",       # paper | balanced
    lever: str = "duplicate",        # duplicate | reschedule | both
    resched_residual: float = 0.0,   # rank imbalance left after token sched
    resched_extra_frac: float = 0.0, # rescue-round a2a bytes / dispatch bytes
    dup_hbm_bytes: float = 0.0,      # replica-slot weight bytes read per step
) -> LatencyBreakdown:
    """Single-layer MoE prefill latency under a prediction strategy.

    ``comm_model="paper"`` reproduces the paper's accounting (Distribution-
    Only leaves communication at the skew-scaled baseline); ``"balanced"``
    also credits dispatch balance to duplication.

    The *lever* selects which balancing mechanism the prediction feeds (the
    defaults reproduce the paper's duplication-only accounting):

      duplicate   FFN load = 1 + f(eps); pays migration (charged by the
                  caller as overhead) and replica HBM reads
                  (``dup_hbm_bytes`` folded into the FFN roofline bytes).
      reschedule  no weight movement: token scheduling levels ranks to
                  ``resched_residual``; pays ``resched_extra_frac`` more
                  dispatch/combine bytes (the overflow rescue round).
      both        load = 1 + f(min(eps, residual)), pays both costs.
    """
    n = hw.num_devices
    tokens = batch * seq
    d = cfg.d_model

    # --- attention (TP over n devices) + ring all-reduce ------------------
    att_f = attention_flops(cfg, tokens, seq) / n
    att_bytes = (3 * tokens * d * BYTES) / n + tokens * d * BYTES
    t_attn = gemm_time(hw, att_f, att_bytes) \
        + elementwise_time(hw, 4 * tokens * d * BYTES / n)
    t_ar = allreduce_time(hw, tokens * d * BYTES)

    # --- FFN (EP over n devices) ------------------------------------------
    routed_f = ffn_flops_per_token(cfg) * tokens
    balanced_share = routed_f / n
    if strategy == "none":
        load = skew
    elif lever == "reschedule":
        load = min(skew, bottleneck_factor(resched_residual, n, scenario))
    elif lever == "both":
        load = bottleneck_factor(min(eps, resched_residual), n, scenario)
    else:   # duplicate (the paper's lever)
        load = bottleneck_factor(eps, n, scenario)
    ffn_bytes = expert_bytes(cfg) * _experts_per_device(cfg, n) \
        + dup_hbm_bytes + 2 * tokens * d * BYTES / n
    t_ffn = gemm_time(hw, balanced_share * load, ffn_bytes)
    # always-on branch (shared experts / dense residual), TP over n
    dense_f = dense_ffn_flops_per_token(cfg) * tokens / n
    if dense_f:
        t_ffn += gemm_time(hw, dense_f, ffn_bytes * 0.1)

    # --- dispatch / combine all-to-all -------------------------------------
    k = cfg.moe.top_k if cfg.moe else 1
    routed_bytes = tokens * k * d * BYTES
    base_move = routed_bytes * (n - 1) / (n * n)    # balanced bottleneck bytes
    if strategy == "token_to_expert":
        # correct tokens pre-routed (overlapped with attention); mispredicted
        # pairs pay the extra hop. Communication has no optimistic case.
        t_disp = alltoall_time(hw, base_move * comm_factor(eps, scenario) * eps)
        t_comb = alltoall_time(hw, base_move)
    elif strategy == "dist_only" and comm_model == "balanced":
        t_disp = alltoall_time(hw, base_move)
        t_comb = alltoall_time(hw, base_move)
    else:   # none, or dist_only under the paper's accounting
        t_disp = alltoall_time(hw, base_move * skew)
        t_comb = alltoall_time(hw, base_move * skew)

    if lever in ("reschedule", "both") and strategy != "none":
        # overflow tokens take a second hop to their rescue slot and back
        surcharge = 1.0 + max(float(resched_extra_frac), 0.0)
        t_disp *= surcharge
        t_comb *= surcharge

    # --- prediction overhead ------------------------------------------------
    base_total = t_attn + t_ar + t_disp + t_ffn + t_comb
    t_over = overhead_frac * base_total if strategy == "token_to_expert" else 0.0

    return LatencyBreakdown(attention=t_attn, allreduce=t_ar, dispatch=t_disp,
                            ffn=t_ffn, combine=t_comb, overhead=t_over,
                            strategy=strategy, accuracy=1.0 - eps)


def _experts_per_device(cfg: ModelConfig, n: int) -> int:
    if cfg.moe is None:
        return 1
    return max(1, cfg.moe.num_experts // n)


def duplication_move_time(cfg: ModelConfig, hw: HardwareConfig,
                          experts_moved_per_device: int = 1) -> float:
    """Paper Sec 5: weight-transfer cost of moving duplicated experts.
    One expert sent + received per device per layer by default."""
    return expert_bytes(cfg) * experts_moved_per_device / hw.link_bw


def duplication_is_hideable(cfg: ModelConfig, hw: HardwareConfig, *,
                            batch: int, seq: int) -> bool:
    """Can the expert move be overlapped with the attention layer?"""
    lb = layer_latency(cfg, hw, batch=batch, seq=seq, skew=1.0)
    return duplication_move_time(cfg, hw) <= lb.attention
