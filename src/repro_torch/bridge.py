"""Weight bridge between the JAX package's parameter tree and the port.

``params_from_jax`` takes the tree of ``init_model`` as numpy arrays (for
example ``jax.tree.map(np.asarray, params)``) and builds the port's
``Transformer``; ``params_to_jax`` is its inverse, returning the same key
paths as float32 numpy arrays. Uniform-stack layer leaves are stacked over
L in the JAX tree (``layers``) and split into ``layers[l]`` here (the MoE
block's ``shared`` experts and ``dense`` branch, where a config has them,
as ``shared_w_*`` and ``dense_w_*``; MLA's ``attn.w_dkv`` ... ``attn.wo``
under their JAX names; a relu
or gelu model's experts keep the ``w_gate`` the JAX tree holds and never
reads; the dense family's ``ffn.*`` as ``w_gate`` / ``w_up`` /
``w_down``, its Q/K/V biases ``attn.w*.b`` as ``bq`` / ``bk`` / ``bv``;
RWKV's ``time_mix.*`` and ``channel_mix.*`` as ``tm_*`` and ``cm_*``, the
dense weights' ``.w`` and ``ln_out.scale`` dropped from the name; an
encoder-decoder's ``cross.*`` and ``ln_cross`` as ``cross_w*`` and
``ln_cross``, its encoder stack ``enc_layers`` (``attn.*``, ``ffn.*``,
``ln1``, ``ln2``) split into ``enc_layers[l]`` as ``layers`` is, and
``enc_norm`` at the top);
hybrid models keep a list of per-layer trees (``hybrid_layers``:
``rec.*`` or ``attn.*``, ``ffn.*``, ``ln1``, ``ln2``). Every weight keeps
its ``(d_in, d_out)`` layout. Two of the JAX tree's shapes have no
parameter here: a non-parametric norm (OLMo) is an empty dict at
``final_norm``, ``ln1`` and ``ln2``, which ``params_to_jax`` emits and
``params_from_jax`` accepts, and a tied model (MiniCPM) has no
``lm_head`` on either side.

The embedding, ``lm_head``, attention weights and biases, expert,
shared-expert and FFN weights, the recurrent block's dense weights,
``conv_w`` and ``conv_b``, and RWKV's dense weights, ``mu`` and LoRAs are
stored in bf16 (the reference casts each to bf16 at every use, so the
values the model computes with are unchanged); the router weight, ``lam``,
RWKV's ``decay_base`` and ``bonus`` and the norm scales stay fp32. A
round trip therefore returns the bf16-rounded weights the reference
computes with, and is exact from then on. With
``trainable=True`` every parameter stays fp32 (and requires gradients),
so the round trip is exact at once.

``opt_state_to_jax`` / ``opt_state_from_jax`` carry the AdamW state (the
step and the two moments, in the JAX tree layout on the JAX side) across,
so either package can continue the other's training.

On a process mesh (``launch.mesh.Mesh``) ``sharder(cfg, mesh, layout)``
makes the ``sharding.Sharder`` of a layout ("none", "specs", "fsdp"; with
``expert_tp=True`` the experts' F dim split over "data" too):
``params_from_jax(..., shard=)`` and ``models.transformer.init_model(...,
shard=)`` keep this rank's block of every leaf. ``params_to_jax``,
``opt_state_to_jax`` and ``checkpoint_tree`` gather such a model's blocks
(and its moments') back to the mesh's rank 0, so the ``.npz`` is the one
both packages read.

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
from repro_torch.models.transformer import (CROSS, RWKV_BLOCKS, WEIGHT_DTYPE,
                                            Transformer, _layer_kind,
                                            _layer_shapes,
                                            expert_param_names, param_shapes)
from repro_torch.optim.adamw import AdamWState
from repro_torch.sharding import Sharder, gather_whole, placement

# JAX key path -> port parameter name
TOP_KEYS = {("embed", "table"): "embed", ("final_norm", "scale"): "final_norm",
            ("lm_head", "w"): "lm_head", ("enc_norm", "scale"): "enc_norm"}
LAYER_KEYS = {
    ("ln1", "scale"): "ln1", ("ln2", "scale"): "ln2",
    ("attn", "wq", "w"): "wq", ("attn", "wk", "w"): "wk",
    ("attn", "wv", "w"): "wv", ("attn", "wo", "w"): "wo",
    # qkv_bias (qwen)
    ("attn", "wq", "b"): "bq", ("attn", "wk", "b"): "bk",
    ("attn", "wv", "b"): "bv",
    # MLA's projections (deepseek; its out projection is "wo" above)
    ("attn", "w_dkv", "w"): "w_dkv", ("attn", "w_krope", "w"): "w_krope",
    ("attn", "w_uk", "w"): "w_uk", ("attn", "w_uv", "w"): "w_uv",
    ("attn", "w_q", "w"): "w_q",
    ("moe", "router", "w"): "router",
    ("moe", "experts", "w_gate"): "w_gate",
    ("moe", "experts", "w_up"): "w_up",
    ("moe", "experts", "w_down"): "w_down",
    # deepseek's shared experts (no w_gate under relu / gelu)
    ("moe", "shared", "w_gate"): "shared_w_gate",
    ("moe", "shared", "w_up"): "shared_w_up",
    ("moe", "shared", "w_down"): "shared_w_down",
    # arctic's dense residual branch (no w_gate under relu / gelu)
    ("moe", "dense", "w_gate"): "dense_w_gate",
    ("moe", "dense", "w_up"): "dense_w_up",
    ("moe", "dense", "w_down"): "dense_w_down",
    # the dense family's FFN
    ("ffn", "w_gate"): "w_gate", ("ffn", "w_up"): "w_up",
    ("ffn", "w_down"): "w_down",
    # an encoder-decoder's cross-attention (its projections' biases under
    # qkv_bias)
    ("ln_cross", "scale"): "ln_cross",
    **{("cross", f"w{c}", "w"): f"{CROSS}w{c}" for c in "qkvo"},
    **{("cross", f"w{c}", "b"): f"{CROSS}b{c}" for c in "qkv"},
}
# the norms a non-parametric config holds as empty dicts in the JAX tree
_EMPTY_NORMS = ("ln1", "ln2")
_TOP_DTYPES = {"embed": WEIGHT_DTYPE, "final_norm": torch.float32,
               "lm_head": WEIGHT_DTYPE, "enc_norm": torch.float32}
# one hybrid layer's JAX key path -> port parameter name
_REC_KEYS = {("rec", n, "w") if n.startswith("w_") else ("rec", n): "rec_" + n
             for n in ("w_gate", "w_main", "conv_w", "conv_b", "w_a", "w_x",
                       "lam", "w_out")}


def _rwkv_path(block: str, n: str):
    """The JAX key path (under ``layers``) of an RWKV block's parameter."""
    if n.startswith("w_"):
        return (block, n, "w")
    if n == "ln_out":
        return (block, n, "scale")
    return (block, n)


def _top_keys(cfg: ModelConfig):
    """JAX key path -> port name of the top-level leaves the config has."""
    return {path: name for path, name in TOP_KEYS.items()
            if not (name in ("final_norm", "enc_norm")
                    and cfg.norm != "rmsnorm")
            and not (name == "lm_head" and cfg.tie_embeddings)
            and not (name == "enc_norm" and not cfg.is_encdec)}


def _empty_norms(kind: str):
    """The norms a non-parametric config's layer of ``kind`` holds as
    empty dicts in the JAX tree."""
    return _EMPTY_NORMS + (("ln_cross",) if kind == "decoder" else ())


def _stack_keys(cfg: ModelConfig, kind=None):
    """JAX key path (under ``layers``, or ``enc_layers`` for ``kind``
    "encoder") -> port name for a uniform stack's layer: the keys the
    config has, the MoE block's or the FFN's (RWKV's: its time and channel
    mix's; a decoder's also its cross-attention's)."""
    kind = kind or _layer_kind(cfg, 0)
    names = _layer_shapes(cfg, kind)
    blocks = ("ln1", "ln2", "cross", "ln_cross") + (
        () if kind == "rwkv" else ("moe" if cfg.is_moe else "ffn", "attn"))
    keys = {path: name for path, name in LAYER_KEYS.items()
            if name in names and path[0] in blocks}
    if kind == "rwkv":
        keys.update((_rwkv_path(RWKV_BLOCKS[n[:3]], n[3:]), n)
                    for n in names if n[:3] in RWKV_BLOCKS)
    return keys


def _hybrid_keys(cfg: ModelConfig, kind: str):
    """JAX key path -> port name for one hybrid layer of ``kind``."""
    names = _layer_shapes(cfg, kind)
    keys = {**{p: n for p, n in LAYER_KEYS.items() if p[0] != "moe"},
            **_REC_KEYS}
    return {path: name for path, name in keys.items() if name in names}


def param_paths(cfg: ModelConfig):
    """{port parameter name: (its JAX '/'-joined path, whether the JAX tree
    stacks it over the layers)}: the names ``sharding.param_specs`` keys
    its rules by."""
    out = {name: ("/".join(path), False)
           for path, name in _top_keys(cfg).items()}
    if cfg.family == "hybrid":
        for l in range(cfg.num_layers):
            for path, name in _hybrid_keys(cfg, _layer_kind(cfg, l)).items():
                out[f"layers.{l}.{name}"] = (
                    f"hybrid_layers/{l}/" + "/".join(path), False)
        return out
    stacks = [("layers", None, cfg.num_layers)]
    if cfg.is_encdec:
        stacks.append(("enc_layers", "encoder", cfg.encoder.num_layers))
    for stack, kind, n in stacks:
        for path, name in _stack_keys(cfg, kind).items():
            for l in range(n):
                out[f"{stack}.{l}.{name}"] = (f"{stack}/" + "/".join(path),
                                              True)
    return out


def sharder(cfg: ModelConfig, mesh, layout: str,
            expert_tp: bool = False) -> Sharder:
    """The ``sharding.Sharder`` of ``layout`` for this process's rank of
    ``mesh`` over a model of ``cfg``; ``expert_tp``: the experts' F dim
    also split over "data" (the JAX ``abstract_params(expert_tp=True)``)."""
    shapes, kinds = param_shapes(cfg)
    return Sharder(cfg, mesh, layout, shapes, param_paths(cfg), kinds,
                   expert_tp)


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


def _flat_from_jax(tree: Dict[str, Any], cfg: ModelConfig
                   ) -> Dict[str, np.ndarray]:
    """A tree in the JAX ``init_model`` layout -> {port parameter name
    (``model.named_parameters()``'s): numpy array}, stacked layer leaves
    split over L."""
    out = {name: np.asarray(_get(tree, path))
           for path, name in _top_keys(cfg).items()}
    L = cfg.num_layers
    if cfg.family == "hybrid":
        subs = tree["hybrid_layers"]
        if len(subs) != L:
            raise ValueError(f"{len(subs)} hybrid layers, expected {L}")
        for l, sub in enumerate(subs):
            for path, name in _hybrid_keys(cfg, _layer_kind(cfg, l)).items():
                out[f"layers.{l}.{name}"] = np.asarray(_get(sub, path))
        return out
    stacks = [("layers", None, L)]
    if cfg.is_encdec:
        stacks.append(("enc_layers", "encoder", cfg.encoder.num_layers))
    for stack, kind, n in stacks:
        for path, name in _stack_keys(cfg, kind).items():
            a = np.asarray(_get(tree[stack], path))
            if a.shape[:1] != (n,):
                raise ValueError(f"{stack}.{name}: shape {a.shape}, "
                                 f"expected ({n}, ...)")
            out.update((f"{stack}.{l}.{name}", a[l]) for l in range(n))
    return out


def _jax_from_flat(model: Transformer, leaf) -> Dict[str, Any]:
    """The JAX tree layout of ``leaf(port parameter name)`` over every
    parameter of ``model`` (uniform-stack layer leaves stacked over L)."""
    cfg = model.cfg
    empty = cfg.norm != "rmsnorm"        # the JAX tree's {} norms
    tree: Dict[str, Any] = {"final_norm": {}} if empty else {}
    if empty and cfg.is_encdec:
        tree["enc_norm"] = {}
    for path, name in _top_keys(cfg).items():
        _put(tree, path, leaf(name))
    if cfg.family == "hybrid":
        tree["hybrid_layers"] = []
        for l, layer in enumerate(model.layers):
            sub: Dict[str, Any] = ({k: {} for k in _EMPTY_NORMS} if empty
                                   else {})
            for path, name in _hybrid_keys(cfg, layer.kind).items():
                _put(sub, path, leaf(f"layers.{l}.{name}"))
            tree["hybrid_layers"].append(sub)
        return tree
    stacks = [("layers", _layer_kind(cfg, 0), model.layers)]
    if cfg.is_encdec:
        stacks.append(("enc_layers", "encoder", model.enc_layers))
    for stack, kind, layers in stacks:
        tree[stack] = ({k: {} for k in _empty_norms(kind)} if empty
                       else {})
        for path, name in _stack_keys(cfg, kind).items():
            _put(tree, (stack,) + path,
                 np.stack([leaf(f"{stack}.{l}.{name}")
                           for l in range(len(layers))]))
    return tree


def _np32(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig,
                    device="cuda", trainable: bool = False,
                    shard: Sharder = None) -> Transformer:
    """JAX ``init_model`` tree (numpy leaves) -> the port's ``Transformer``.
    ``trainable``: every parameter fp32 with ``requires_grad``, as the JAX
    package trains them (the default stores the serving dtypes).
    ``shard``: None, or a ``Sharder`` (``sharder``): this rank's block of
    each leaf is taken from the numpy tree, each parameter carrying its
    ``Placement``."""
    dev = resolve_device(device)
    flat = _flat_from_jax(tree, cfg)
    if shard is not None:
        flat = {name: shard.block(name, a) for name, a in flat.items()}

    def dtype(dt):
        return torch.float32 if trainable else dt
    top = {name: _tensor(flat[name], dtype(_TOP_DTYPES[name]), dev)
           for name in _top_keys(cfg).values()}
    def stack(prefix, kinds):
        out = []
        for l, kind in enumerate(kinds):
            t = {}
            for name, (shape, _, dt) in _layer_shapes(cfg, kind).items():
                a = flat[f"{prefix}.{l}.{name}"]
                if shard is not None:
                    shape = shard.block_shape(f"{prefix}.{l}.{name}")
                if a.shape != shape:
                    raise ValueError(f"{prefix}[{l}].{name}: shape {a.shape}, "
                                     f"expected {shape}")
                t[name] = _tensor(a, dtype(dt), dev)
            out.append(t)
        return out
    layers = stack("layers", [_layer_kind(cfg, l)
                              for l in range(cfg.num_layers)])
    enc_layers = (stack("enc_layers", ["encoder"] * cfg.encoder.num_layers)
                  if cfg.is_encdec else [])
    model = Transformer(cfg, top, layers, trainable, enc_layers)
    if shard is not None:
        shard.attach(model)
    return model


def _split_leaves(model: Transformer):
    """{name: Placement} of the parameters a layout splits over an axis
    (a model built with a ``Sharder``), else {}."""
    out = {}
    for name, p in model.named_parameters():
        rec = placement(p)
        if rec is not None and (rec.model_dim is not None
                                or rec.data_dim is not None):
            out[name] = rec
    return out


def _mesh_rank(model: Transformer):
    """The global rank of a model built with a ``Sharder``, else None."""
    rec = next((placement(p) for p in model.parameters()
                if placement(p) is not None), None)
    return None if rec is None else rec.mesh.rank


def _leaf_fn(model: Transformer, flat: Dict[str, torch.Tensor], comm=None):
    """``leaf(name)`` for ``_jax_from_flat`` over ``flat`` (a tensor for
    each of ``model``'s parameter names): fp32 numpy; with ``comm`` (a
    mesh's model group) each expert leaf gathered over the group to its
    rank 0 when asked for, one layer's leaf at a time, so rank 0 holds one
    gathered leaf on the device at once (an empty array on the other
    ranks, whose tree is not used). A model built with a ``Sharder``
    gathers every split leaf whole over the mesh instead (every rank
    calls; ``comm`` is not read)."""
    split = _split_leaves(model)
    experts = (set(expert_param_names(model)) if comm is not None
               and not split else ())

    def leaf(name):
        if name in split:
            return _np32(gather_whole(flat[name], split[name]))
        if name not in experts:
            return _np32(flat[name])
        whole = comm.gather(flat[name].detach()[None])     # (R, E/R, ...)
        if whole is None:
            return np.zeros((0,), np.float32)
        return _np32(whole.reshape((-1,) + whole.shape[2:]))
    return leaf


def params_to_jax(model: Transformer, comm=None) -> Dict[str, Any]:
    """The port's ``Transformer`` -> the JAX tree layout, float32 numpy.
    ``comm``: None, or the model group (``launch.mesh.Mesh.comm``) of a
    model whose ranks each hold a block of the experts; every rank of the
    group calls, and the group's rank 0 gets the whole model's tree (the
    others None)."""
    tree = _jax_from_flat(model, _leaf_fn(
        model, dict(model.named_parameters()), comm))
    rank = _mesh_rank(model)
    if rank is not None:
        return None if rank else tree
    return None if comm is not None and comm.rank else tree


def opt_state_to_jax(state: AdamWState, model: Transformer,
                     comm=None) -> AdamWState:
    """The port's AdamW state over ``model``'s parameters (``mu`` / ``nu``
    keyed by parameter name, as ``train.steps`` keeps them) -> an
    ``AdamWState`` whose ``step`` is an int32 numpy scalar and whose
    ``mu`` / ``nu`` are float32 numpy trees in the JAX parameter layout:
    ``repro.optim.AdamWState(*...)`` continues from it, and
    ``train.checkpoint.save`` writes the JAX package's keys. ``comm`` as
    for ``params_to_jax``: the expert leaves' moments gathered to the
    group's rank 0."""
    out = AdamWState(
        step=np.asarray(state.step.cpu(), np.int32),
        mu=_jax_from_flat(model, _leaf_fn(model, state.mu, comm)),
        nu=_jax_from_flat(model, _leaf_fn(model, state.nu, comm)))
    rank = _mesh_rank(model)
    if rank is not None:
        return None if rank else out
    return None if comm is not None and comm.rank else out


def checkpoint_tree(model: Transformer, state: AdamWState, mesh=None):
    """{"params", "opt"} in the JAX layout, the tree ``train.checkpoint.
    save`` writes and ``repro.train.checkpoint`` restores. With ``mesh``
    (``launch.mesh.Mesh``; every rank calls): global rank 0's tree of the
    whole model, each expert leaf and its moments gathered over data index
    0's model group (every data index holds the same parameters), or,
    for a model built with a ``Sharder``, every split leaf gathered over
    the whole mesh; None on every other rank."""
    if mesh is None:
        return {"params": params_to_jax(model),
                "opt": opt_state_to_jax(state, model)}
    if _mesh_rank(model) is not None:
        # a layout's blocks: every rank takes part in each leaf's gather
        params = params_to_jax(model)
        opt = opt_state_to_jax(state, model)
        return None if mesh.rank else {"params": params, "opt": opt}
    if mesh.data_index:
        return None
    comm = mesh.comm if expert_param_names(model) and mesh.model > 1 else None
    if comm is None and mesh.rank:
        return None
    params = params_to_jax(model, comm)
    opt = opt_state_to_jax(state, model, comm)
    return None if mesh.rank else {"params": params, "opt": opt}


def opt_state_from_jax(state, model: Transformer) -> AdamWState:
    """A JAX ``AdamWState`` (or its checkpoint's {"step", "mu", "nu"}),
    numpy or jax leaves -> the port's state over ``model``'s parameters:
    fp32 moments on the model's device, keyed by parameter name."""
    get = (state.__getitem__ if isinstance(state, dict)
           else lambda k: getattr(state, k))
    dev = model.device

    def moments(tree):
        flat = _flat_from_jax(tree, model.cfg)
        return {name: _tensor(flat[name], torch.float32, dev)
                for name, _ in model.named_parameters()}
    return AdamWState(
        step=torch.tensor(np.asarray(get("step")), dtype=torch.int32,
                          device=dev),
        mu=moments(get("mu")), nu=moments(get("nu")))


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
