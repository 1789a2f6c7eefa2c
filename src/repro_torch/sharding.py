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

What the process backend applies (``init_model(shard=)``,
``bridge.params_from_jax(shard=)``) is one of three layouts, named on the
launchers as ``--shard-params``:

  "none"   the expert rule alone (each EP rank holds its ``E / R`` home
           experts); every other weight whole on every rank;
  "specs"  ``param_specs(shapes, mesh=mesh)``: the rules above over
           "model", the expert rule among them;
  "fsdp"   ``param_specs(..., fsdp_axes=batch_axes(mesh), fsdp_size=D)``:
           "specs" with every weight of rank >= 2 also split over "data"
           (ZeRO-3 storage), as the JAX ``abstract_params`` lays it out;
           it trains and serves (each forward gathers the shards at use).

``expert_tp`` (``Sharder(..., expert_tp=True)``, with "specs" or "fsdp")
adds the JAX ``abstract_params(expert_tp=True)`` layout of the experts:
``param_specs(..., expert_tp_axes=batch_axes(mesh))``, ``w_gate`` /
``w_up`` as ``(model, None, data)`` and ``w_down`` as ``(model, data,
None)``: each rank holds its EP rank's experts at its data rank's block of
F. A decode step under ``Runtime(decode_expert_tp=True)`` computes with
those blocks where they lie (``models.transformer``: expert-TP decode);
any other forward gathers them over "data" at use, as the reference's
prefill reads the experts as ``P("model", None, None)``.

Each rank keeps ``shard_tensor``'s block of every leaf, and each parameter
carries a ``Placement``: its spec, its whole shape and how the layers use
its block over "model" (``use``):

  "col"       output features split: computed locally ("col" products);
  "row"       input features split: partial products summed over "model";
  "vocab"     the embedding's rows: a masked local lookup summed over
              "model", logits gathered over it;
  "expert"    the expert rule (the EP dispatch);
  "gathered"  a projection whose block splits a head (``_sanitize`` checks
              divisibility only): stored by its spec, all-gathered over
              "model" at use (``at_use``), then used whole;
  "whole"     not split over "model".

A leaf split over "data" (FSDP) is all-gathered over it at use, every
layer gathering its own leaves inside its (re)computation, and its
gradient is reduce-scattered back. The "gathered" leaves of a config: at
"model" 4, recurrentgemma-2b's ``wq``, ``wk`` and ``wv`` (10 query heads,
one KV head), and ``wk`` / ``wv`` of every ``reduced()`` config (2 KV
heads); none of any other config of the registry
(``tests/test_torch_dist_tp.py`` checks the list).
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Sequence, Tuple

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



# ---------------------------------------------------------------------------
# the layouts applied: a block of every leaf, and how it is used
# ---------------------------------------------------------------------------

LAYOUTS = ("none", "specs", "fsdp")

# a layer's head projections (port parameter names) -> the head count their
# "model" blocks must divide to be used locally: "q" the query heads, "kv"
# the KV heads
HEAD_LEAVES = {"wq": "q", "cross_wq": "q", "w_q": "q", "w_uk": "q",
               "w_uv": "q", "tm_w_r": "q", "tm_w_k": "q", "tm_w_v": "q",
               "tm_w_g": "q", "wk": "kv", "wv": "kv", "cross_wk": "kv",
               "cross_wv": "kv"}
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


class Placement:
    """How this rank holds and uses one parameter: ``spec`` (the leaf's
    own dims, no stacked L), ``use`` (see the module docstring), the dims
    split over "model" and "data" (None when whole over the axis) and the
    mesh whose groups it is used over (not pickled). A dim split over
    ``("pod", "data")`` (a multi-pod mesh) counts as split over "data":
    the mesh's data axis is then both."""

    def __init__(self, spec: Spec, use: str, mesh):
        self.spec, self.use = tuple(spec), use
        axes = [_axes(s) if s is not None else () for s in self.spec]
        self.model_dim = next((i for i, a in enumerate(axes)
                               if "model" in a), None)
        self.data_dim = next((i for i, a in enumerate(axes)
                              if "data" in a), None)
        self.mesh = mesh

    def __getstate__(self):
        return dict(self.__dict__, mesh=None)


def placement(t) -> Optional[Placement]:
    """The ``Placement`` a parameter (or its gathered use) carries, or
    None (a model built without a layout)."""
    return getattr(t, "placement", None)


def _heads(cfg, name: str, layer_kind: str) -> int:
    """The head count ``HEAD_LEAVES[name]`` refers to in a layer of
    ``layer_kind`` (an encoder layer at the encoder's widths)."""
    if layer_kind == "encoder":
        h, k = cfg.encoder.num_heads, cfg.encoder.num_kv_heads
    else:
        h, k = cfg.num_heads, cfg.num_kv_heads
    return h if HEAD_LEAVES[name] == "q" else k


def leaf_use(name: str, spec: Spec, cfg, model_axis: int,
             layer_kind: str = "attn") -> str:
    """How a leaf (``name`` the port's, without its ``layers.{l}.``
    prefix) with ``spec`` is used over a "model" axis of ``model_axis``
    ranks."""
    if not any(s is not None and "model" in _axes(s) for s in spec):
        return "whole"
    if name == "embed":
        return "vocab"
    if name in EXPERT_LEAVES and len(spec) == 3:
        return "expert"
    if name in HEAD_LEAVES and _heads(cfg, name, layer_kind) % model_axis:
        return "gathered"
    last = spec[-1]
    return "col" if last is not None and "model" in _axes(last) else "row"


def layout_specs(cfg, shapes: Dict[str, tuple], paths, mesh,
                 layout: str, expert_tp: bool = False) -> Dict[str, Spec]:
    """{port name: spec of the leaf's own dims} under ``layout`` for the
    leaves of ``shapes`` ({port name: whole shape}); ``paths``: {port name:
    (JAX path, stacked)} (``bridge.param_paths``). ``expert_tp``: the
    experts' F dim split over the batch axes too."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r}: one of {LAYOUTS}")
    if expert_tp and layout == "none":
        raise ValueError("expert TP lays the experts out by the sharding "
                         "rules: layout 'specs' or 'fsdp'")
    if layout == "none":
        return {n: EXPERT_SPEC if n.rsplit(".", 1)[-1] in EXPERT_LEAVES
                and len(s) == 3 else () for n, s in shapes.items()}
    full = {}
    for n, shape in shapes.items():
        path, stacked = paths[n]
        full[path] = ((cfg.num_layers,) if stacked else ()) + tuple(shape)
    kw = (dict(fsdp_axes=batch_axes(mesh), fsdp_size=int(np.prod(
        [mesh.shape[a] for a in batch_axes(mesh)]))) if layout == "fsdp"
          else {})
    if expert_tp:
        kw["expert_tp_axes"] = batch_axes(mesh)
    specs = param_specs(full, mesh=mesh, **kw)
    out = {}
    for n, shape in shapes.items():
        path, stacked = paths[n]
        spec = specs[path][1:] if stacked else specs[path]
        out[n] = tuple(spec) + (None,) * (len(shape) - len(spec))
    return out


class Sharder:
    """The blocks and ``Placement``s of one layout for the rank of
    ``mesh`` this process holds (``launch.mesh.Mesh``): ``block(name,
    whole)`` cuts a leaf, ``attach(model)`` records each parameter's
    placement on it. ``shapes``: {port name: whole shape};
    ``kinds``: {port name: its layer's kind} ("encoder", ...);
    ``expert_tp``: the experts' F dim also split over "data"."""

    def __init__(self, cfg, mesh, layout: str, shapes, paths, kinds,
                 expert_tp: bool = False):
        self.mesh, self.layout, self.expert_tp = mesh, layout, expert_tp
        self.specs = layout_specs(cfg, shapes, paths, mesh, layout,
                                  expert_tp)
        self.coords = getattr(mesh, "coords", None) or {
            "data": mesh.data_index, "model": mesh.model_index}
        self.shapes = {n: tuple(s) for n, s in shapes.items()}
        self.uses = {n: leaf_use(n.rsplit(".", 1)[-1], self.specs[n], cfg,
                                 mesh.model, kinds.get(n, "attn"))
                     for n in shapes}

    def block(self, name: str, whole, rows_kept: bool = False):
        """This rank's block of leaf ``name`` (a tensor or array);
        ``rows_kept``: ``whole`` holds the experts of ``expert_rows``
        already."""
        spec = self.specs[name]
        if rows_kept:
            spec = (None,) + tuple(spec[1:])
        return shard_tensor(whole, spec, self.coords, self.mesh)

    def expert_rows(self, name: str):
        """(lo, hi): the experts this rank keeps of an expert leaf split
        over "model" by the expert rule, else None."""
        spec = self.specs[name]
        if len(self.shapes[name]) != 3 or not spec or spec[0] != "model":
            return None
        n = self.shapes[name][0] // self.mesh.model
        return self.mesh.model_index * n, (self.mesh.model_index + 1) * n

    def attach(self, model) -> None:
        """Record each parameter's ``Placement`` on it, the layout on the
        model (``model.layout``), and ``gathers_at_use`` on each module
        holding a parameter that ``at_use`` gathers."""
        for name, p in model.named_parameters():
            if tuple(p.shape) != self.block_shape(name):
                raise ValueError(f"{name}: holds {tuple(p.shape)}, not its "
                                 f"block under {self.specs[name]}")
            p.placement = Placement(self.specs[name], self.uses[name],
                                    self.mesh)
            if needs_gather(p) and "." in name:
                model.get_submodule(name.rsplit(".", 1)[0]) \
                    .gathers_at_use = True
        model.layout = self.layout

    def block_shape(self, name: str) -> tuple:
        """The shape of this rank's block of leaf ``name``."""
        whole = np.broadcast_to(np.int8(0), self.shapes[name])
        return tuple(self.block(name, whole).shape)


def at_use(t):
    """A parameter as the layers compute with it: its FSDP shards gathered
    over "data", a "gathered" leaf's blocks over "model" (each carrying
    the gradient back to this rank's shard); anything else as it is. The
    result carries the parameter's ``Placement``."""
    rec = placement(t)
    if rec is None:
        return t
    out = t
    if rec.data_dim is not None:
        out = rec.mesh.data_comm.fsdp_gather(out, rec.data_dim)
    if rec.use == "gathered":
        out = rec.mesh.comm.tp_gather(out, rec.model_dim)
    if out is not t:
        out.placement = rec
    return out


def data_shards(t) -> int:
    """How many data ranks hold a block of ``t``: the mesh's data axis
    where its layout splits it over "data", else 1."""
    rec = placement(t)
    return 1 if rec is None or rec.data_dim is None else rec.mesh.data


def needs_gather(t) -> bool:
    """Whether ``at_use`` gathers ``t`` (over either axis)."""
    rec = placement(t)
    return rec is not None and (rec.data_dim is not None
                                or rec.use == "gathered")


def gather_whole(t, rec: Optional[Placement]):
    """The whole leaf from every rank's block ``t`` of a leaf placed by
    ``rec`` (None: ``t`` is whole): all-gathered over "data" and then over
    "model" along the dims its spec splits, so every rank gets it. No
    gradient (checkpoints, tests)."""
    if rec is None:
        return t
    out = t.detach()
    if rec.data_dim is not None:
        out = rec.mesh.data_comm._gather_dim(out, rec.data_dim)
    if rec.model_dim is not None:
        out = rec.mesh.comm._gather_dim(out, rec.model_dim)
    return out


def kv_span(num_heads: int, num_kv_heads: int, model_axis: int,
            model_index: int) -> Tuple[int, int]:
    """[lo, hi): the KV heads the query heads of "model" rank
    ``model_index`` read, when the query heads split over the ranks and
    the KV heads do not (the rank then holds those KV heads whole). Raises
    when its query heads do not read equally many heads each."""
    hl, g = num_heads // model_axis, num_heads // num_kv_heads
    lo = model_index * hl // g
    hi = ((model_index + 1) * hl - 1) // g + 1
    if hl % (hi - lo):
        raise ValueError(f"{hl} query heads a rank over {hi - lo} KV heads "
                         f"(H {num_heads}, K {num_kv_heads}, model "
                         f"{model_axis})")
    return lo, hi
