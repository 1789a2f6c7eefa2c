"""Switch Transformer base-128 [Fedus et al., JMLR 2022] — paper Appendix C
generality model: T5-base geometry, 128 experts top-1, ReLU FFN, MHA."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="switch-base-128",
    family="moe",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,            # MHA (no GQA, paper Sec 5)
    d_ff=3072,
    vocab_size=32128,
    attention="gqa",
    activation="relu",
    rope_theta=10000.0,
    moe=MoEConfig(num_experts=128, top_k=1, d_ff_expert=3072,
                  capacity_factor=1.25),
    source="JMLR 23(120) Switch Transformers; appendix-C model of MoE-GPS",
)
