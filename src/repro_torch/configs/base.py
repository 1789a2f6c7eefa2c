"""Model configuration for the PyTorch port.

The port's own copy of ``ModelConfig`` / ``MoEConfig`` for the families it
serves so far (uniform-stack decoder-only GQA models with a dense or MoE
FFN). Field names and defaults follow the JAX package's configs, so a
config means the same model in both packages. Configs are plain frozen
dataclasses.

``reduced()`` derives the CPU-smoke variant (<=2 layers, d_model<=256,
<=4 experts) used by the tests; it shrinks exactly the dimensions the JAX
package's ``reduced()`` shrinks.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_loss: float = 0.01
    router_z_loss: float = 1e-3
    # Paper technique knobs -------------------------------------------------
    max_copies: int = 4                  # Algorithm 1 C_max
    duplication_slots: int = 0           # extra expert slots per EP rank


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                          # dense | moe
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                    # 0 -> d_model // num_heads
    attention: str = "gqa"
    qkv_bias: bool = False
    sliding_window: int = 0              # 0 = full attention
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"
    activation: str = "swiglu"
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

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
            name=self.name + "-smoke",
        )
        if self.moe is not None:
            changes["moe"] = dataclasses.replace(
                self.moe,
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                d_ff_expert=min(self.moe.d_ff_expert, 256),
            )
        return dataclasses.replace(self, **changes)
