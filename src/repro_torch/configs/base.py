"""Model configuration for the PyTorch port.

The port's own copy of ``ModelConfig`` / ``MoEConfig`` / ``MLAConfig`` for
the families it serves so far: uniform-stack decoder-only GQA models with a
dense or MoE FFN (the dense family with QKV biases, a non-parametric
LayerNorm or tied embeddings), DeepSeek's MoE with multi-head latent
attention (MLA) and always-on shared experts, the hybrid family
(Griffin: RG-LRU recurrent blocks and local attention, in a repeating
``block_pattern``), the attention-free ``ssm`` family (RWKV-6:
``attention="none"``, a time mix and a relu^2 channel mix) and the
``audio`` encoder-decoder (SeamlessM4T: a bidirectional ``EncoderConfig``
stack over frame embeddings under a GQA decoder with cross-attention).
Field names and defaults follow the JAX package's configs, so a config
means the same model in both packages. Configs are plain frozen
dataclasses.

``reduced()`` derives the CPU-smoke variant (<=2 layers, or one block
pattern; d_model<=256, <=4 experts, <=1 shared expert, a dense residual
branch <=256 wide, an MLA latent of 64 with 32-wide heads, an encoder of 2
layers, d 256, 4 heads, 2 KV heads, F 512 over at most 64 frames) used by
the tests; it shrinks exactly the dimensions the JAX package's ``reduced()``
shrinks. ``num_params()`` / ``active_params()`` are the JAX package's
analytic counts, and ``INPUT_SHAPES`` its four assigned step shapes (the
roofline's inputs).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0          # always-on experts (deepseek-style)
    dense_residual: bool = False         # arctic: dense FFN in parallel with MoE
    d_ff_dense: int = 0                  # width of the dense residual branch
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01
    router_z_loss: float = 1e-3
    # Paper technique knobs -------------------------------------------------
    max_copies: int = 4                  # Algorithm 1 C_max
    duplication_slots: int = 0           # extra expert slots per EP rank
    # Replica weight movement -----------------------------------------------
    # "store": the EP engine keeps persistent replica rows
    # (repro_torch.runtime.ReplicaStore) and moves weights only when the
    # plan changes; "gather": every slot reads its expert's home weights
    # through the slot -> expert map (the oracle, and the path whenever no
    # store is threaded in).
    replica_impl: str = "store"
    # Overlapped migration: plan-diff fills are staged per layer on a side
    # stream and each layer adopts the target plan once its fill has
    # landed (repro_torch.runtime.LayerStagedExecutor). False drains the
    # diff between engine steps.
    overlap_migration: bool = True
    # Per-rank HBM budget (GB) for the replica store, in the JAX package's
    # accounting (a second copy of the home experts plus the replica
    # slots). 0 = unlimited; otherwise the EP engine clamps
    # duplication_slots until the store fits (core.placement.clamp_dup_slots).
    store_hbm_budget_gb: float = 0.0
    # Token rescheduling (repro_torch.schedule): the rescue round re-sends
    # pairs that overflowed their slot to an alternate copy at capacity
    # ``max(8, int(cap * resched_cap_frac))``; active only when a quota is
    # passed to the dispatch (lever "reschedule" or "both").
    resched_cap_frac: float = 0.5


@dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0                 # 0 = full-rank Q projection
    rope_head_dim: int = 64              # decoupled RoPE dims per head
    v_head_dim: int = 128
    nope_head_dim: int = 128


@dataclass(frozen=True)
class EncoderConfig:
    """Encoder stack for enc-dec (seamless-m4t) architectures."""
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    max_source_len: int = 4096


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                          # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                    # 0 -> d_model // num_heads
    attention: str = "gqa"               # gqa | mla | mixed | none (ssm)
    qkv_bias: bool = False
    sliding_window: int = 0              # 0 = full attention
    rope_theta: float = 10000.0
    # paged decode attention (``ContinuousEngine``): "fused" launches the
    # paged kernel straight off the block pool; "gather" materialises each
    # slot's logical view from its block table, then runs the plain
    # blockwise online softmax (``kernels.ref.paged_decode_ref``, the JAX
    # package's oracle). Taken only as configured, never as a fallback.
    paged_attn_impl: str = "fused"
    norm: str = "rmsnorm"                # rmsnorm | nonparametric (olmo)
    activation: str = "swiglu"           # swiglu | gelu | relu | relu2 (rwkv)
    tie_embeddings: bool = False         # logits read the embedding table
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    encoder: Optional[EncoderConfig] = None
    # hybrid (recurrentgemma): block pattern repeated over layers
    block_pattern: Tuple[str, ...] = ()  # e.g. ("recurrent","recurrent","local")
    rnn_width: int = 0                   # RG-LRU recurrence width (0 = d_model)
    local_window: int = 2048             # local-attention window (hybrid)
    # modality frontends (stubs): tokens, or "mixed" (vlm): precomputed
    # patch embeddings (B, P, d) prepended to the token embeddings
    input_mode: str = "tokens"
    num_prefix_embeddings: int = 0       # P, patch embeddings a sequence
    lr_schedule: str = "cosine"          # cosine | wsd (launch.train)
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    @property
    def is_encdec(self) -> bool:
        return self.encoder is not None

    def num_params(self) -> int:
        """Analytical parameter count (embedding + blocks + head), the JAX
        package's formula: a hybrid counts every layer's attention as GQA
        and its FFN, and RWKV's time mix as ``6 d^2 / 2``, as the reference
        does. An encoder adds ``4 d H (d / H)`` and its FFN a layer, whatever
        its KV heads, with the decoder's FFN matrix count; neither the
        decoder's cross-attention nor any norm scale is counted."""
        mla = self.attention == "mla"
        ssm = self.attention == "none" and self.family == "ssm"
        if not (self.attention in ("gqa", "mixed")
                or (mla and self.mla is not None) or ssm):
            raise NotImplementedError(
                f"attention {self.attention!r} without its config has no "
                "port count (ROADMAP.md §1)")
        d, L, hd = self.d_model, self.num_layers, self.head_dim
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if mla:
            m, H = self.mla, self.num_heads
            per_layer = d * m.kv_lora_rank                        # kv down
            per_layer += m.kv_lora_rank * H * (m.nope_head_dim + m.v_head_dim)
            per_layer += d * m.rope_head_dim                      # shared k_rope
            qd = m.q_lora_rank or d
            if m.q_lora_rank:
                per_layer += d * m.q_lora_rank
            per_layer += qd * H * (m.nope_head_dim + m.rope_head_dim)
            per_layer += H * m.v_head_dim * d                     # out proj
        elif ssm:
            per_layer = 6 * d * d // 2                            # rwkv6 time-mix approx
        else:
            per_layer = d * self.num_heads * hd                   # Q
            per_layer += 2 * d * self.num_kv_heads * hd           # K,V
            per_layer += self.num_heads * hd * d                  # O
        ff_mult = 3 if self.activation == "swiglu" else 2
        if self.moe is not None:
            e = self.moe
            per_layer += e.num_experts * ff_mult * d * e.d_ff_expert
            per_layer += e.num_shared_experts * ff_mult * d * e.d_ff_expert
            if e.dense_residual:
                per_layer += ff_mult * d * (e.d_ff_dense or self.d_ff)
            per_layer += d * e.num_experts                    # router
        else:
            per_layer += ff_mult * d * self.d_ff
        total = emb + L * per_layer
        if self.encoder is not None:
            enc = self.encoder
            enc_layer = 4 * enc.d_model * enc.num_heads * (enc.d_model
                                                           // enc.num_heads)
            enc_layer += ff_mult * enc.d_model * enc.d_ff
            total += enc.num_layers * enc_layer
        return total

    def active_params(self) -> int:
        """Active (per-token) parameter count: MoE counts only top_k
        experts."""
        if self.moe is None:
            return self.num_params()
        e = self.moe
        ff_mult = 3 if self.activation == "swiglu" else 2
        inactive = (e.num_experts - e.top_k) * ff_mult * self.d_model \
            * e.d_ff_expert
        return self.num_params() - self.num_layers * inactive

    def reduced(self) -> "ModelConfig":
        """CPU-smoke variant: same family/features, tiny dims."""
        changes = dict(
            num_layers=min(self.num_layers, 2),
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=64,
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 1024),
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            local_window=min(self.local_window, 32),
            rnn_width=min(self.rnn_width, 256) if self.rnn_width else 0,
            num_prefix_embeddings=min(self.num_prefix_embeddings, 8),
            name=self.name + "-smoke",
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=min(self.moe.d_ff_expert, 256),
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                d_ff_dense=(min(self.moe.d_ff_dense, 256)
                            if self.moe.d_ff_dense else 0),
            )
        if self.mla is not None:
            changes["mla"] = dataclasses.replace(
                self.mla, kv_lora_rank=64, rope_head_dim=32,
                nope_head_dim=32, v_head_dim=32)
        if self.encoder is not None:
            changes["encoder"] = dataclasses.replace(
                self.encoder, num_layers=2, d_model=256, num_heads=4,
                num_kv_heads=2, d_ff=512, max_source_len=64)
        if self.block_pattern:
            changes["num_layers"] = len(self.block_pattern)
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# Input shapes (the JAX package's assigned four)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}
