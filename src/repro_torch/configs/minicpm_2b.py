"""MiniCPM-2B [arXiv:2404.06395] — dense llama-like, WSD schedule."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    attention="gqa",
    norm="rmsnorm",
    activation="swiglu",
    tie_embeddings=True,
    lr_schedule="wsd",
    source="arXiv:2404.06395",
)
