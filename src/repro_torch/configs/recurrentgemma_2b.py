"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427] — hybrid RG-LRU +
local attention at 1:2 ratio (pattern: recurrent, recurrent, local).

The JAX package's configuration of it, field for field: an untied
``lm_head`` and dense ``w_a`` / ``w_x`` gates, as that package builds the
model (the published checkpoint ties the embedding and uses block-diagonal
gates)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,              # ~1:2 -> pattern tiled over 26 layers
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    attention="mixed",
    norm="rmsnorm",
    activation="gelu",
    block_pattern=("recurrent", "recurrent", "local"),
    rnn_width=2560,             # RG-LRU recurrence width
    local_window=2048,
    source="arXiv:2402.19427",
)
