"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base] —
128-expert top-2 MoE with a dense residual branch (dense-MoE hybrid): a
dense SwiGLU FFN of width ``d_ff_dense`` runs on every token beside the
routed experts, and its output is added to theirs."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    attention="gqa",
    norm="rmsnorm",
    activation="swiglu",
    moe=MoEConfig(
        num_experts=128,
        top_k=2,
        d_ff_expert=4864,
        dense_residual=True,
        d_ff_dense=4864,
        max_copies=4,
    ),
    source="hf:Snowflake/snowflake-arctic-base",
)
