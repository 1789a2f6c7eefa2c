"""Abstract stand-ins for every input and state of a step, one rank's: the
port of the JAX package's ``launch/specs.py``.

Each tree is made of empty ``meta`` tensors at this rank's block shapes
(nothing is allocated, and arctic-480b's ~960 GB of bf16 weights cost
nothing), with the spec tree that gave them: a spec per leaf as
``sharding`` writes them (a tuple, an entry per dimension: None, an axis
name or a tuple of names). The rules are the reference's: the parameters
by ``sharding.param_specs`` (FSDP over the batch axes unless ``fsdp`` is
off, expert TP on request), the moments as their parameters, the cache by
``cache_specs``, the inputs over the batch axes, which drop to replication
when the batch does not divide (``long_500k``'s one row).

``abstract_cache`` is the reference's cache layout. The port's steps hold
another one in two places (``port_cache``): a GQA cache whose KV heads do
not divide the "model" axis keeps every position and the KV heads its
query heads read (``sharding.kv_span``) where the reference splits the
positions over "model", and RWKV's shift vectors stay whole over "model"
where the reference splits ``d``. ``launch.dryrun`` traces the port's
step on ``port_cache``.

The placement plan stays the one concrete input (``plan_args``, host
numpy).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.bridge import sharder
from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.placement import identity_plan, stack_plans
from repro_torch.models.transformer import (Runtime, init_cache,
                                            local_config, meta_model)
from repro_torch.optim.adamw import AdamWState
from repro_torch.sharding import batch_axes, shard_tensor
from repro_torch.train.steps import param_tree

# Sliding window applied to full-attention archs for long_500k decode
# (Mixtral's own 4K window), as in the reference
LONG_CONTEXT_WINDOW = 4096
META = torch.device("meta")


def _block(whole, spec, mesh):
    """A new ``meta`` tensor of this rank's block of ``whole`` under
    ``spec``."""
    view = shard_tensor(whole, spec, mesh.coords, mesh)
    return torch.empty(tuple(view.shape), dtype=whole.dtype, device=META)


def tree_bytes(tree) -> int:
    """The bytes of every tensor in a nested tree of dicts, lists, tuples
    and ``AdamWState``s."""
    if torch.is_tensor(tree):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return 0


# ---------------------------------------------------------------------------
# runtime
# ---------------------------------------------------------------------------

def runtime_for(cfg: ModelConfig, mesh, shape: InputShape, *,
                decode_expert_tp: bool = False) -> Runtime:
    """The step's ``Runtime`` on ``mesh``: EP over "model" for a MoE model,
    the long-context window for a full-attention model's ``long_500k``,
    and, where the batch splits over the batch axes, ``rows_split`` (the
    step is handed this rank's rows, as ``input_specs`` cuts them)."""
    window = 0
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid") \
            and not cfg.sliding_window:
        window = LONG_CONTEXT_WINDOW
    return Runtime(mesh=mesh, ep=cfg.is_moe, ep_ranks=mesh.shape["model"],
                   window_override=window, decode_expert_tp=decode_expert_tp,
                   rows_split=bool(_batch_axes_for(mesh,
                                                   shape.global_batch)))


def plan_args(cfg: ModelConfig, ep_ranks: int):
    """The identity placement-plan stack (host numpy), or None without
    MoE."""
    if not cfg.is_moe:
        return None
    m = cfg.moe
    return stack_plans([identity_plan(m.num_experts, ep_ranks,
                                      m.duplication_slots, m.max_copies)
                        for _ in range(cfg.num_layers)])


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def _batch_axes_for(mesh, B: int) -> tuple:
    """The batch axes, dropped to replication when B isn't evenly divisible
    (e.g. long-context decode with global_batch=1)."""
    b = batch_axes(mesh)
    n = int(np.prod([mesh.shape[a] for a in b])) if b else 1
    return b if b and B % n == 0 and n > 1 else ()


def _entry(axes):
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def input_specs(cfg: ModelConfig, shape: InputShape, mesh):
    """({name: this rank's ``meta`` input}, {name: spec}) of (arch, input
    shape): train / prefill {"tokens", "labels" (train)[, "prefix_embeds" |
    "frames"]}, decode {"tokens": (B, 1)}; int32 tokens, bf16 embeddings
    and frames."""
    B, S = shape.global_batch, shape.seq_len
    b = _entry(_batch_axes_for(mesh, B))
    whole = {"tokens": ((B, 1 if shape.kind == "decode" else S),
                        torch.int32)}
    if shape.kind == "train":
        whole["labels"] = ((B, S), torch.int32)
    if shape.kind != "decode":
        if cfg.input_mode == "mixed" and cfg.num_prefix_embeddings:
            whole["prefix_embeds"] = ((B, cfg.num_prefix_embeddings,
                                       cfg.d_model), torch.bfloat16)
        if cfg.is_encdec:
            enc = cfg.encoder
            whole["frames"] = ((B, enc.max_source_len, enc.d_model),
                               torch.bfloat16)
    specs = {k: (b,) + (None,) * (len(s) - 1) for k, (s, _) in whole.items()}
    out = {k: _block(torch.empty(s, dtype=dt, device=META), specs[k], mesh)
           for k, (s, dt) in whole.items()}
    return out, specs


# ---------------------------------------------------------------------------
# params / optimizer / cache
# ---------------------------------------------------------------------------

def abstract_params(cfg: ModelConfig, mesh, *, dtype=torch.bfloat16,
                    fsdp: bool = True, expert_tp: bool = False,
                    trainable: bool = False):
    """(a ``Transformer`` of this rank's ``meta`` blocks in ``dtype``, every
    leaf cast as the reference casts its abstract tree (None: each leaf's
    own dtype, as ``init_model`` holds it), with the placements
    ``sharding.at_use`` reads; {port name: spec of the leaf's own dims})
    under ``param_specs`` with FSDP over the batch axes (the port's "fsdp"
    layout; "specs" without ``fsdp``)."""
    shard = sharder(cfg, mesh, "fsdp" if fsdp else "specs",
                    expert_tp=expert_tp)
    model = meta_model(cfg, dtype=dtype, trainable=trainable, shard=shard)
    return model, dict(shard.specs)


def abstract_opt_state(model, *, moment_dtype=torch.float32) -> AdamWState:
    """AdamW's state of ``model``'s parameters: each moment this rank's
    block as its parameter's, in ``moment_dtype``; the step a replicated
    int32 scalar."""
    def zeros():
        return {n: torch.empty(tuple(p.shape), dtype=moment_dtype,
                               device=META)
                for n, p in sorted(param_tree(model).items())}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=META),
                      mu=zeros(), nu=zeros())


def cache_specs(cfg: ModelConfig, cache, mesh, B: int):
    """The spec tree of a cache (``init_cache``'s structure), by the
    reference's rules over its '/'-joined leaf paths."""
    m = mesh.shape["model"]
    b = _entry(_batch_axes_for(mesh, B))

    def leaf_spec(path: str, leaf):
        nd = leaf.dim()
        if "cross_k" in path or "cross_v" in path:      # (L,B,Se,KV,hd)
            kv_ok = cfg.num_kv_heads % m == 0
            return (None, b, None if kv_ok else "model",
                    "model" if kv_ok else None, None)
        if path.endswith("/k") or path.endswith("/v") or path in ("k", "v"):
            if nd == 5:                                  # (L,B,C,KV,hd)
                kv_ok = cfg.num_kv_heads % m == 0
                seq_ok = (not kv_ok) and leaf.shape[2] % m == 0
                return (None, b, "model" if seq_ok else None,
                        "model" if kv_ok else None, None)
            if nd == 4:                                  # hybrid: (B,W,KV,hd)
                kv_ok = cfg.num_kv_heads % m == 0
                return (b, None, "model" if kv_ok else None, None)
        if "c_kv" in path or "k_rope" in path:           # MLA: (L,B,C,r)
            return (None, b, None, None)
        if "wkv" in path:                                # rwkv: (L,B,H,hd,hd)
            return (None, b, "model" if leaf.shape[2] % m == 0 else None,
                    None, None)
        if "shift" in path:                              # rwkv: (L,B,d)
            return (None, b, "model" if cfg.d_model % m == 0 else None)
        if path.endswith("/h") or path == "h":           # griffin: (B,dr)
            return (b, "model" if leaf.shape[-1] % m == 0 else None)
        if "conv" in path:                               # griffin: (B,w,dr)
            return (b, None, "model" if leaf.shape[-1] % m == 0 else None)
        return (b,) + (None,) * (nd - 1)

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else k)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, f"{prefix}/{i}" if prefix else str(i))
                    for i, v in enumerate(tree)]
        return leaf_spec(prefix, tree)
    return walk(cache, "")


def _cache_len(cfg: ModelConfig, shape: InputShape) -> int:
    """The positions a cache holds: the prompt's, and a VLM's prefix."""
    max_len = shape.seq_len
    if cfg.input_mode == "mixed" and cfg.num_prefix_embeddings:
        max_len += cfg.num_prefix_embeddings    # prefix fills cache positions
    return max_len


def _map2(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map2(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map2(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def abstract_cache(cfg: ModelConfig, rt: Runtime, shape: InputShape, mesh):
    """(this rank's ``meta`` cache under the reference's ``cache_specs``,
    the spec tree)."""
    B = shape.global_batch
    whole = init_cache(cfg, rt, B, _cache_len(cfg, shape), device=META)
    specs = cache_specs(cfg, whole, mesh, B)
    return _map2(lambda t, s: _block(t, s, mesh), whole, specs), specs


def port_cache(model, cfg: ModelConfig, rt: Runtime, shape: InputShape,
               mesh):
    """The ``meta`` cache this rank's step holds in the port: its rows of
    the batch (every row when the batch does not split), its KV heads or
    channels under the model's layout (``local_config``), every position
    (see the module docstring for where this differs from
    ``abstract_cache``)."""
    B = shape.global_batch
    rows = B // mesh.data if rt.rows_split else B
    return init_cache(local_config(model, cfg), rt, rows,
                      _cache_len(cfg, shape), device=META)


def step_args(cfg: ModelConfig, shape: InputShape, mesh, *,
              fsdp: bool = True, expert_tp: bool = False,
              train_dtype=torch.float32) -> Dict:
    """Everything one rank's step of ``shape`` takes, on ``meta``: {"cfg",
    "rt", "model", "param_specs", "opt" (train), "cache" (``port_cache``;
    prefill and decode), "inputs", "input_specs", "plan"}."""
    rt = runtime_for(cfg, mesh, shape,
                     decode_expert_tp=expert_tp and shape.kind == "decode")
    if shape.kind == "train":
        model, pspecs = abstract_params(cfg, mesh, dtype=train_dtype,
                                        fsdp=fsdp, trainable=True)
    else:
        # the serving weights' own dtypes (bf16 matrices, fp32 router,
        # norm scales and the like), as the port holds them
        model, pspecs = abstract_params(cfg, mesh, dtype=None, fsdp=fsdp,
                                        expert_tp=expert_tp)
    inputs, ispecs = input_specs(cfg, shape, mesh)
    out = {"cfg": cfg, "rt": rt, "model": model, "param_specs": pspecs,
           "inputs": inputs, "input_specs": ispecs,
           "plan": plan_args(cfg, rt.ep_ranks)}
    if shape.kind == "train":
        out["opt"] = abstract_opt_state(model)
    else:
        out["cache"] = port_cache(model, cfg, rt, shape, mesh)
    return out


def argument_bytes(args: Dict) -> int:
    """The bytes of a step's arguments (``step_args``): the parameters,
    the moments, the cache and the inputs."""
    return (tree_bytes(list(args["model"].parameters()))
            + tree_bytes(args.get("opt")) + tree_bytes(args.get("cache"))
            + tree_bytes(args["inputs"]))


def with_layers(cfg: ModelConfig, layers: int,
                enc_layers: Optional[int] = None) -> ModelConfig:
    """``cfg`` at another depth (an encoder-decoder's encoder too)."""
    changes = {"num_layers": layers}
    if cfg.is_encdec:
        changes["encoder"] = dataclasses.replace(
            cfg.encoder, num_layers=layers if enc_layers is None
            else enc_layers)
    return dataclasses.replace(cfg, **changes)
