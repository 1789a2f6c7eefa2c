"""LLaVA-NeXT-34B [hf:llava-hf/llava-v1.6-mistral-7b-hf family] — VLM.

The JAX package's configuration of it, field for field: the transformer
backbone only. The vision tower and its projector are a stub, so each
sequence takes ``num_prefix_embeddings`` precomputed anyres patch
embeddings (B, P, d_model), prepended to the token embeddings
(``models.transformer._embed_inputs``)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b",
    family="vlm",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    attention="gqa",
    norm="rmsnorm",
    activation="swiglu",
    input_mode="mixed",
    num_prefix_embeddings=2880,   # anyres tiling: 5 tiles x 576 patches
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
