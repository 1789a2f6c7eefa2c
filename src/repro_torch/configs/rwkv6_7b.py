"""RWKV-6 Finch 7B [arXiv:2404.05892] — attention-free SSM with
data-dependent decay time-mix and relu^2 channel-mix.

The JAX package's configuration of it, field for field: 64 time-mix heads
of 64 channels, a 14336-wide channel mix and a 65536-token vocabulary."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,          # time-mix heads (head_dim=64)
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    attention="none",
    norm="rmsnorm",
    activation="relu2",
    source="arXiv:2404.05892",
)
