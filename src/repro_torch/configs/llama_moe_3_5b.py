"""LLaMA-MoE 3.5B [Zhu et al., EMNLP 2024; hf:llama-moe/LLaMA-MoE-v1-3_5B]
— paper Appendix C generality model: LLaMA-7B FFNs split into 16 experts
(d_ff 11008 -> 16 x 688), top-4 routing, MHA (no GQA), SwiGLU."""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama-moe-3.5b",
    family="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,            # MHA
    d_ff=11008,
    vocab_size=32000,
    attention="gqa",
    activation="swiglu",
    moe=MoEConfig(num_experts=16, top_k=4, d_ff_expert=688),
    source="EMNLP 2024 llama-moe; appendix-C model of MoE-GPS",
)
