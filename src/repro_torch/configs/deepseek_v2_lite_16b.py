"""DeepSeek-V2-Lite 16B [arXiv:2405.04434] — multi-head latent attention
(a 512-wide latent KV cache plus one shared 64-wide RoPE key) and 64 routed
experts, top-6, beside 2 always-on shared experts.

As in the JAX package's config every layer is uniform: the published
checkpoint's dense first layer, the LayerNorm on the latent ``c_kv`` and
YaRN RoPE scaling are not modelled (ROADMAP.md §3)."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,                 # routed-expert width; every layer MoE
    vocab_size=102400,
    attention="mla",
    norm="rmsnorm",
    activation="swiglu",
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=0,          # Lite uses full-rank Q
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        d_ff_expert=1408,
        num_shared_experts=2,
        max_copies=4,
    ),
    source="arXiv:2405.04434",
)
