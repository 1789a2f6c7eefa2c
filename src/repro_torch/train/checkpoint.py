"""Checkpointing: flat-key ``.npz`` save and restore of nested dicts, lists
and NamedTuples of arrays (the port of the JAX package's
``train/checkpoint.py``).

Leaves are stored under their ``/``-joined path in one compressed npz: a
dict level by its key, a list or tuple level as ``#i``, a NamedTuple field
by its name, the keys the JAX package writes for the same tree. So a
checkpoint of ``{"params": bridge.params_to_jax(model), "opt":
bridge.opt_state_to_jax(state, model)}`` restores in the JAX package's
``restore_like``, and a JAX checkpoint of ``{"params": ..., "opt":
AdamWState}`` loads here. Tensors are written as float32 (bf16 has no
numpy type) or as their integer type.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Tuple

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _numpy(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        return (t.float() if t.is_floating_point() else t).numpy()
    return np.asarray(leaf)


def _leaves(tree, prefix: Tuple[str, ...] = ()):
    """(path, leaf) pairs in the tree's order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    elif _is_namedtuple(tree):
        for k, v in zip(tree._fields, tree):
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (f"#{i}",))
    else:
        yield prefix, tree


def flatten(tree) -> Dict[str, np.ndarray]:
    """{"/"-joined path: numpy array} of every leaf."""
    return {"/".join(path): _numpy(leaf) for path, leaf in _leaves(tree)}


def save(path: str, tree: Any) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **flatten(tree))


def _insert(root: Dict, keys: Tuple[str, ...], value):
    node = root
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = value


def _listify(node):
    """Turn {'#0': .., '#1': ..} levels back into lists."""
    if not isinstance(node, dict):
        return node
    if node and all(re.fullmatch(r"#\d+", k) for k in node):
        return [_listify(node[f"#{i}"]) for i in range(len(node))]
    return {k: _listify(v) for k, v in node.items()}


def load(path: str) -> Any:
    """The nested dict / list structure of a checkpoint; leaves are numpy
    arrays (a NamedTuple comes back as a dict of its fields). An empty
    dict holds no leaf, so it does not come back (OLMo's norms, ``{}`` in
    the JAX tree): ``restore_like`` over a template restores it."""
    with np.load(path, allow_pickle=False) as z:
        root: Dict = {}
        for key in z.files:
            _insert(root, tuple(key.split("/")), z[key])
    return _listify(root)


def restore_like(template: Any, loaded: Any) -> Any:
    """``template``'s structure with the loaded leaf at each path: tensors
    come back as tensors of the template leaf's dtype, shape and device,
    anything else as a numpy array of its dtype and shape. Raises
    ``KeyError`` on a path the checkpoint lacks."""
    flat = flatten(loaded)

    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, path + (str(k),)) for k, v in node.items()}
        if _is_namedtuple(node):
            return type(node)(*(build(v, path + (k,))
                                for k, v in zip(node._fields, node)))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, path + (f"#{i}",))
                              for i, v in enumerate(node))
        key = "/".join(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = flat[key]
        if torch.is_tensor(node):
            return torch.as_tensor(arr.reshape(tuple(node.shape))).to(
                device=node.device, dtype=node.dtype)
        if hasattr(node, "dtype"):
            return arr.astype(node.dtype).reshape(np.shape(node))
        return arr
    return build(template, ())
