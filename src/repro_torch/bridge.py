"""Weight bridge between the JAX package's parameter tree and the port.

``params_from_jax`` takes the tree of ``init_model`` as numpy arrays (for
example ``jax.tree.map(np.asarray, params)``) and builds the port's
``Transformer``; ``params_to_jax`` is its inverse, returning the same key
paths as float32 numpy arrays. Layer leaves are stacked over L in the JAX
tree and split into ``layers[l]`` here; every weight keeps its
``(d_in, d_out)`` layout.

The embedding, ``lm_head``, attention and expert weights are stored in
bf16 (the reference casts each to bf16 at every use, so the values the
model computes with are unchanged); the router weight and norm scales stay
fp32. A round trip therefore returns the bf16-rounded weights the
reference computes with, and is exact from then on.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import (WEIGHT_DTYPE, Transformer,
                                            _layer_shapes)

# JAX key path -> port parameter name
TOP_KEYS = {("embed", "table"): "embed", ("final_norm", "scale"): "final_norm",
            ("lm_head", "w"): "lm_head"}
LAYER_KEYS = {
    ("ln1", "scale"): "ln1", ("ln2", "scale"): "ln2",
    ("attn", "wq", "w"): "wq", ("attn", "wk", "w"): "wk",
    ("attn", "wv", "w"): "wv", ("attn", "wo", "w"): "wo",
    ("moe", "router", "w"): "router",
    ("moe", "experts", "w_gate"): "w_gate",
    ("moe", "experts", "w_up"): "w_up",
    ("moe", "experts", "w_down"): "w_down",
}
_TOP_DTYPES = {"embed": WEIGHT_DTYPE, "final_norm": torch.float32,
               "lm_head": WEIGHT_DTYPE}


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _put(tree: Dict, path, value):
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _tensor(a, dtype, device):
    return torch.tensor(np.asarray(a, np.float32)).to(device=device,
                                                      dtype=dtype)


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device="cuda") -> Transformer:
    """JAX ``init_model`` tree (numpy leaves) -> the port's ``Transformer``."""
    dev = resolve_device(device)
    top = {name: _tensor(_get(tree, path), _TOP_DTYPES[name], dev)
           for path, name in TOP_KEYS.items()}
    shapes = _layer_shapes(cfg)
    stacked = {name: np.asarray(_get(tree["layers"], path))
               for path, name in LAYER_KEYS.items()}
    for name, a in stacked.items():
        want = (cfg.num_layers,) + shapes[name][0]
        if a.shape != want:
            raise ValueError(f"layers.{name}: shape {a.shape}, expected {want}")
    layers = [{name: _tensor(a[l], shapes[name][2], dev)
               for name, a in stacked.items()}
              for l in range(cfg.num_layers)]
    return Transformer(cfg, top, layers)


def params_to_jax(model: Transformer) -> Dict[str, Any]:
    """The port's ``Transformer`` -> the JAX tree layout, float32 numpy."""
    def np32(t):
        return t.detach().to("cpu", torch.float32).numpy()
    tree: Dict[str, Any] = {}
    for path, name in TOP_KEYS.items():
        _put(tree, path, np32(getattr(model, name)))
    for path, name in LAYER_KEYS.items():
        _put(tree, ("layers",) + path,
             np.stack([np32(getattr(layer, name)) for layer in model.layers]))
    return tree
