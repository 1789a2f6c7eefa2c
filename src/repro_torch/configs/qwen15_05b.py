"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B] — dense with QKV bias."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=2816,
    vocab_size=151936,
    attention="gqa",
    qkv_bias=True,
    norm="rmsnorm",
    activation="swiglu",
    source="hf:Qwen/Qwen1.5-0.5B",
)
