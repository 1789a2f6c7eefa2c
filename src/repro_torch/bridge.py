"""Weight bridge between the JAX package's parameter tree and the port.

``params_from_jax`` takes the tree of ``init_model`` as numpy arrays (for
example ``jax.tree.map(np.asarray, params)``) and builds the port's
``Transformer``; ``params_to_jax`` is its inverse, returning the same key
paths as float32 numpy arrays. Uniform-stack layer leaves are stacked over
L in the JAX tree (``layers``) and split into ``layers[l]`` here; hybrid
models keep a list of per-layer trees (``hybrid_layers``: ``rec.*`` or
``attn.*``, ``ffn.*``, ``ln1``, ``ln2``). Every weight keeps its
``(d_in, d_out)`` layout.

The embedding, ``lm_head``, attention, expert and FFN weights, and the
recurrent block's dense weights, ``conv_w`` and ``conv_b`` are stored in
bf16 (the reference casts each to bf16 at every use, so the values the
model computes with are unchanged); the router weight, ``lam`` and the
norm scales stay fp32. A round trip therefore returns the bf16-rounded
weights the reference computes with, and is exact from then on.

``predictor_params_from_jax`` / ``predictor_params_to_jax`` carry the
Token-to-Expert predictors' parameter trees (``FFNPredictor.params``,
``LSTMPredictor.params``: nested dicts, every leaf fp32) across unchanged,
so both packages predict from one set of weights.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import (WEIGHT_DTYPE, Transformer,
                                            _layer_kind, _layer_shapes)

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
# one hybrid layer's JAX key path -> port parameter name
_REC_KEYS = {("rec", n, "w") if n.startswith("w_") else ("rec", n): "rec_" + n
             for n in ("w_gate", "w_main", "conv_w", "conv_b", "w_a", "w_x",
                       "lam", "w_out")}
_FFN_KEYS = {("ffn", n): n for n in ("w_gate", "w_up", "w_down")}


def _hybrid_keys(cfg: ModelConfig, kind: str):
    """JAX key path -> port name for one hybrid layer of ``kind``."""
    names = _layer_shapes(cfg, kind)
    keys = {**{p: n for p, n in LAYER_KEYS.items() if p[0] != "moe"},
            **_REC_KEYS, **_FFN_KEYS}
    return {path: name for path, name in keys.items() if name in names}


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
    if cfg.family == "hybrid":
        layers = []
        for l, sub in enumerate(tree["hybrid_layers"]):
            kind = _layer_kind(cfg, l)
            shapes = _layer_shapes(cfg, kind)
            t = {}
            for path, name in _hybrid_keys(cfg, kind).items():
                a = np.asarray(_get(sub, path))
                if a.shape != shapes[name][0]:
                    raise ValueError(f"hybrid_layers[{l}].{name}: shape "
                                     f"{a.shape}, expected {shapes[name][0]}")
                t[name] = _tensor(a, shapes[name][2], dev)
            layers.append(t)
        if len(layers) != cfg.num_layers:
            raise ValueError(f"{len(layers)} hybrid layers, expected "
                             f"{cfg.num_layers}")
        return Transformer(cfg, top, layers)
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
    if model.cfg.family == "hybrid":
        tree["hybrid_layers"] = []
        for layer in model.layers:
            sub: Dict[str, Any] = {}
            for path, name in _hybrid_keys(model.cfg, layer.kind).items():
                _put(sub, path, np32(getattr(layer, name)))
            tree["hybrid_layers"].append(sub)
        return tree
    for path, name in LAYER_KEYS.items():
        _put(tree, ("layers",) + path,
             np.stack([np32(getattr(layer, name)) for layer in model.layers]))
    return tree


def predictor_params_from_jax(tree: Dict[str, Any], device="cuda"
                              ) -> Dict[str, Any]:
    """A JAX predictor's parameter tree (numpy or jax leaves) -> the same
    tree of fp32 tensors on ``device`` (assign it to ``.params``)."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: predictor_params_from_jax(v, dev) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree, np.float32), device=dev)


def predictor_params_to_jax(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's predictor parameter tree -> the same tree of fp32 numpy
    arrays (assign ``jax.tree.map(jnp.asarray, ...)`` to ``.params``)."""
    if isinstance(tree, dict):
        return {k: predictor_params_to_jax(v) for k, v in tree.items()}
    return tree.detach().to("cpu", torch.float32).numpy()
