"""Sharding rules: parameter path -> partition spec (the port of the JAX
package's ``sharding.py``, whole).

Mesh axes: ("pod", "data", "model") multi-pod or ("data", "model")
single-pod. The batch is sharded over (pod, data); the "model" axis
carries tensor parallelism for attention / FFN / vocab and expert
parallelism for MoE.

A spec is a tuple with one entry per dimension of the parameter: None
(not sharded), an axis name, or a tuple of axis names; ``()`` is
replicated. The functions run on shapes alone, over a flat ``{path:
shape}`` mapping in the JAX tree's '/'-joined path names
(``flatten_paths`` of ``bridge.params_to_jax``'s tree, or of any tree of
arrays or shape records), so they need no device. ``mesh``: anything with
a ``.shape`` mapping of axis name -> size (``launch.mesh.Mesh``).

Conventions (dims refer to the *unstacked* parameter; stacked layer
leaves prepend an unsharded L dim, handled automatically):

  embedding table (V, d)        -> (model, None)        vocab-sharded
  attention wq/wk/wv (d, H*hd)  -> (None, model)        head-sharded
  attention wo (H*hd, d)        -> (model, None)
  dense ffn w_gate/w_up (d, f)  -> (None, model)
  dense ffn w_down (f, d)       -> (model, None)
  moe experts (E, d, f)         -> (model, None, None)  expert-parallel
  router, norms, biases, small  -> replicated

What the process backend applies of them: the expert rule (each EP rank
holds its ``E / R`` home experts, ``shard_tensor``), the replica store's
``(None, "model", ...)`` layout (``runtime.store``) and the batch over
"data" (``launch.mesh.Mesh.batch_rows``). Attention, dense-FFN and vocab
tensor parallelism, FSDP and expert TP are computed here but not applied:
the non-expert weights are whole on every rank.
"""

from __future__ import annotations

import re
from typing import Dict, Sequence, Tuple

import numpy as np

Spec = Tuple

# (regex over '/'-joined path, spec for the LAST ndim dims of the leaf)
_RULES = [
    (r"embed/table$", ("model", None)),
    (r"(wq|wk|wv|w_q)/w$", (None, "model")),
    (r"(wo|w_o)/w$", ("model", None)),
    (r"(w_uk|w_uv)/w$", (None, "model")),          # MLA up-projections
    (r"(w_dkv|w_krope)/w$", (None, None)),
    (r"experts/w_gate$", ("model", None, None)),
    (r"experts/w_up$", ("model", None, None)),
    (r"experts/w_down$", ("model", None, None)),
    (r"(ffn|shared|dense|channel_mix)/w_(gate|up|k)/w$", (None, "model")),
    (r"(ffn|shared|dense|channel_mix)/w_(down|v)/w$", ("model", None)),
    (r"(shared|dense)/w_(gate|up)$", (None, "model")),
    (r"(shared|dense)/w_down$", ("model", None)),
    # rwkv time-mix projections
    (r"time_mix/w_(r|k|v|g)/w$", (None, "model")),
    (r"time_mix/w_o/w$", ("model", None)),
    # griffin recurrent block
    (r"(w_gate|w_main)/w$", (None, "model")),
    (r"w_out/w$", ("model", None)),
    # RG-LRU per-channel maps (dr -> dr) stay model-sharded on output only
    (r"(w_a|w_x)/w$", (None, "model")),
]

_EXPERT_TP_RULES = [
    (r"experts/w_gate$", ("model", None, "TP")),
    (r"experts/w_up$", ("model", None, "TP")),
    (r"experts/w_down$", ("model", "TP", None)),
]

STACKED_PREFIXES = ("layers", "enc_layers", "dec_layers")


def spec_for_path(path: str, ndim: int, stacked: bool) -> Spec:
    """The spec of a parameter. ``stacked``: a leading layer dim."""
    body_ndim = ndim - (1 if stacked else 0)
    for pat, spec in _RULES:
        if re.search(pat, path):
            spec = tuple(spec)
            if len(spec) < body_ndim:            # biases under a matched scope
                spec = (None,) * (body_ndim - len(spec)) + spec
            if len(spec) != body_ndim:
                break
            return ((None,) if stacked else ()) + spec
    return ()                                     # replicated


def flatten_paths(tree, prefix: str = "") -> Dict[str, tuple]:
    """{'/'-joined path: shape} of a nested tree of dicts, lists and leaves
    (arrays, tensors or anything with ``.shape``), in the JAX package's
    path names (list items by index)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tuple(int(d) for d in np.shape(tree))}
    out = {}
    for k, v in items:
        out.update(flatten_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _axes(s) -> tuple:
    return s if isinstance(s, tuple) else (s,)


def _entry(axes):
    """A spec entry of several axes: a tuple; of one, its name; of none,
    None (as ``jax.sharding.PartitionSpec`` normalises them)."""
    axes = tuple(axes)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def _add_fsdp(spec: Spec, shape, fsdp_axes, fsdp_size: int,
              stacked: bool) -> Spec:
    """ZeRO-style extension: shard the largest still-unsharded dim of a
    >=2D weight over the batch axes, when evenly divisible. The stacked
    layer dim is never fsdp-sharded."""
    if not fsdp_axes or len(shape) < 2:
        return spec
    used = {a for s in spec for a in _axes(s) if a}
    if used & set(fsdp_axes):            # axis already carried by the spec
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    first = 1 if stacked else 0
    free = [(d, i) for i, (d, s) in enumerate(zip(shape, parts))
            if i >= first and s is None and d % fsdp_size == 0
            and d >= fsdp_size]
    if not free:
        return spec
    _, idx = max(free)
    parts[idx] = _entry(fsdp_axes)
    return tuple(parts)


def _sanitize(spec: Spec, shape, mesh) -> Spec:
    """Drop mesh axes from dims they don't evenly divide (minicpm's vocab
    of 122753 does not shard 16-way)."""
    if mesh is None:
        return spec
    parts = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for d, s in zip(shape, parts):
        if s is None:
            out.append(None)
            continue
        n = int(np.prod([mesh.shape[a] for a in _axes(s)]))
        out.append(s if d % n == 0 else None)
    return tuple(out)


def param_specs(shapes: Dict[str, Sequence[int]],
                stacked_prefixes=STACKED_PREFIXES, fsdp_axes=(),
                fsdp_size: int = 1, mesh=None,
                expert_tp_axes=()) -> Dict[str, Spec]:
    """{path: spec} for a {path: shape} mapping. Leaves under a stacked
    prefix have a leading layer dim. ``fsdp_axes``: also shard weights
    over these batch axes (ZeRO-3 storage). ``mesh``: when given, axes are
    dropped from dims they don't evenly divide. ``expert_tp_axes``: the
    resident 2D expert layout (EP x f-TP, for decode)."""
    specs = {}
    for path, shape in shapes.items():
        shape = tuple(shape)
        stacked = any(path.startswith(p + "/") or ("/" + p + "/") in path
                      for p in stacked_prefixes)
        spec = spec_for_path(path, len(shape), stacked)
        if expert_tp_axes:
            for pat, tpl in _EXPERT_TP_RULES:
                if re.search(pat, path):
                    body = tuple(_entry(expert_tp_axes) if s == "TP" else s
                                 for s in tpl)
                    spec = ((None,) if stacked else ()) + body
                    break
        spec = _sanitize(spec, shape, mesh)
        spec = _add_fsdp(spec, shape, tuple(fsdp_axes), fsdp_size, stacked)
        spec = _sanitize(spec, shape, mesh)
        specs[path] = spec
    return specs


def batch_axes(mesh) -> tuple:
    """Mesh axis names that shard the batch dimension."""
    return tuple(n for n in mesh.shape if n in ("pod", "data"))


def act_spec(mesh, *, seq_over_model: bool = False) -> Spec:
    """The spec of (B, S, d) activations."""
    return (_entry(batch_axes(mesh)), "model" if seq_over_model else None,
            None)


def shard_tensor(full, spec: Spec, coords: Dict[str, int], mesh):
    """The block of ``full`` that the device at ``coords`` ({axis: index})
    holds under ``spec``: each sharded dim cut into equal blocks over its
    axes (several axes in row-major order), taken at the device's index.
    Works on anything sliceable with a shape (tensor or array)."""
    index = []
    for d, s in enumerate(tuple(spec) + (None,) * (len(full.shape)
                                                   - len(spec))):
        if s is None:
            index.append(slice(None))
            continue
        n, at = 1, 0
        for a in _axes(s):
            at = at * mesh.shape[a] + coords[a]
            n *= mesh.shape[a]
        if full.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(full.shape)} does not "
                             f"split over {s} ({n})")
        size = full.shape[d] // n
        index.append(slice(at * size, (at + 1) * size))
    return full[tuple(index)]


EXPERT_SPEC: Spec = ("model", None, None)      # the rule the backend applies


def expert_block(num_experts: int, coords: Dict[str, int], mesh):
    """(lo, hi): the experts rank ``coords`` holds under the expert rule."""
    r = mesh.shape["model"]
    e_loc = num_experts // r
    return coords["model"] * e_loc, (coords["model"] + 1) * e_loc

