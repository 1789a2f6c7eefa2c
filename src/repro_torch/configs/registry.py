"""Architecture registry: name -> ModelConfig for the architectures the
port serves: the MoE models (Mixtral, the paper's Appendix C
models, and DeepSeek-V2-Lite with MLA attention and shared experts), the
hybrid RecurrentGemma-2B, the dense family (Qwen1.5-0.5B, OLMo-1B,
StableLM-3B, MiniCPM-2B), the attention-free RWKV-6 7B, the
encoder-decoder SeamlessM4T-medium and the VLM backbone LLaVA-NeXT-34B:
all thirteen of the JAX package's configs."""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    # the paper's Appendix C generality models
    "llama-moe-3.5b": "repro_torch.configs.llama_moe_3_5b",
    "switch-base-128": "repro_torch.configs.switch_base_128",
    "arctic-480b": "repro_torch.configs.arctic_480b",
    # MLA attention and the MoE block's shared experts
    "deepseek-v2-lite-16b": "repro_torch.configs.deepseek_v2_lite_16b",
    # the dense family: QKV bias (qwen), non-parametric LayerNorm (olmo),
    # head_dim 80 (stablelm), tied embeddings and WSD (minicpm)
    "qwen1.5-0.5b": "repro_torch.configs.qwen15_05b",
    "olmo-1b": "repro_torch.configs.olmo_1b",
    "stablelm-3b": "repro_torch.configs.stablelm_3b",
    "minicpm-2b": "repro_torch.configs.minicpm_2b",
    # attention-free: the RWKV-6 time mix and relu^2 channel mix
    "rwkv6-7b": "repro_torch.configs.rwkv6_7b",
    # the encoder-decoder: a frame encoder and the decoder's cross-attention
    "seamless-m4t-medium": "repro_torch.configs.seamless_m4t_medium",
    # the VLM backbone: patch embeddings prepended to the tokens
    "llava-next-34b": "repro_torch.configs.llava_next_34b",
}

ALL_ARCHS = list(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {k: get_config(k) for k in _MODULES}
