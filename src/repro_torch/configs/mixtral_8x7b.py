"""Mixtral 8x7B [arXiv:2401.04088] — the paper's own model.

8 experts top-2, GQA (8 kv heads), SwiGLU, 4K sliding-window attention —
exactly the architecture MoE-GPS evaluates (Sec 3.4 / Fig 6).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    attention="gqa",
    sliding_window=4096,
    norm="rmsnorm",
    activation="swiglu",
    moe=MoEConfig(
        num_experts=8,
        top_k=2,
        d_ff_expert=14336,
        max_copies=4,
    ),
    source="arXiv:2401.04088",
)
