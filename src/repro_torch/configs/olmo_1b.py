"""OLMo-1B [arXiv:2402.00838] — dense with non-parametric LayerNorm."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab_size=50304,
    attention="gqa",
    norm="nonparametric",
    activation="swiglu",
    source="arXiv:2402.00838",
)
