"""StableLM [hf:stabilityai/stablelm-2-1_6b family] — dense."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50304,
    attention="gqa",
    norm="rmsnorm",
    activation="swiglu",
    source="hf:stabilityai/stablelm-2-1_6b",
)
