"""Architecture registry: name -> ModelConfig for the architectures the
port serves so far."""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
}

ALL_ARCHS = list(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(_MODULES)}")
    return importlib.import_module(_MODULES[name]).CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {k: get_config(k) for k in _MODULES}
