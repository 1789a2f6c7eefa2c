"""SeamlessM4T-medium [arXiv:2308.11596] — encoder-decoder, multimodal.

The JAX package's configuration of it, field for field: the backbone only.
The mel-spectrogram and convolutional feature extractor are a stub, so the
encoder takes precomputed frame embeddings (B, T_src, d_model); a 12-layer
text decoder with cross-attention sits over a 12-layer bidirectional speech
encoder of the same widths."""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    num_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=256206,
    attention="gqa",
    norm="rmsnorm",
    activation="gelu",
    encoder=EncoderConfig(
        num_layers=12, d_model=1024, num_heads=16, num_kv_heads=16,
        d_ff=4096, max_source_len=4096),
    source="arXiv:2308.11596",
)
