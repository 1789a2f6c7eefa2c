"""Legs of ``tests/test_torch_dist_fsdp_serve.py``: the port's engines and
serving steps with one rank a process (``launch.mesh``) on a (2, 2) mesh
under the "fsdp" layout (``sharding``: every weight of rank >= 2 also
split over "data", gathered at use), and the expert-TP decode of the
serving steps (``Runtime(decode_expert_tp=True)`` over "fsdp" + expert
TP). The module imports torch and ``repro_torch`` only (and the other
process legs' modules), so the ranks ``launch.mesh.spawn`` starts import
it quickly; ``run_rank`` is their entry point and returns numpy arrays.

Every leg builds its model from the JAX init's tree the test passes
(``params_from_jax(..., shard=bridge.sharder(cfg, mesh, layout,
expert_tp=...))``: this rank's block of every leaf) and records the bytes
of the parameters (and the replica store) it holds beside the sum of its
``Sharder.block_shape`` blocks.

* ``serve_<arch>``: ``ServeEngine.generate`` on ``_torch_dist_tp``'s
  batches (``serve_tp``, shared with the JAX subprocess);
* ``continuous``: ``ContinuousEngine`` on ``_torch_dist_serve``'s five
  staggered requests (``serve_capture``);
* ``tp`` and ``tp_resched``: ``make_prefill_step`` on ``TP_B`` prompts,
  then ``TP_STEPS`` greedy ``make_decode_step`` steps under a duplicated
  plan (``tp_plan``), the second leg also under a reschedule quota stack
  (``tp_quota``); ``tp_specs`` the first leg's steps on a model laid out
  by "specs" alone, whose experts are whole over "data" (each rank cuts
  its block of F at use).

The MoE model is reduced Mixtral at ``D_FF_EXPERT`` (``variant``): there
the "fsdp" rule splits the experts' F dim over "data" (reduced()'s F 256
equals d, where the rule splits ``w_down``'s d instead), as at published
widths.
"""

import dataclasses
import math

import numpy as np
import torch

from repro_torch.bridge import params_from_jax, sharder
from repro_torch.configs.registry import get_config
from repro_torch.core.duplication import duplicate_experts_host
from repro_torch.core.placement import PlacementPlan, stack_plans
from repro_torch.models.transformer import Runtime, init_cache, local_config
from repro_torch.schedule import make_scheduler
from repro_torch.serve import (ContinuousConfig, ContinuousEngine,
                               ServeConfig, ServeEngine, ServeRequest)
from repro_torch.train.steps import make_decode_step, make_prefill_step
from tests import _torch_dist_serve as ds
from tests import _torch_dist_tp as tp

MESH = (2, 2)
D_FF_EXPERT = 512
SERVE_ARCHS = ("mixtral-8x7b", "stablelm-3b", "recurrentgemma-2b",
               "deepseek-v2-lite-16b")
LEGS = tuple(f"serve_{a}" for a in SERVE_ARCHS) + ("continuous", "tp",
                                                   "tp_resched", "tp_specs")
TP_B, TP_S, TP_STEPS = 8, 16, 4
PLAN_FIELDS = ds.PLAN_FIELDS


def variant(cfg):
    """Reduced Mixtral with ``D_FF_EXPERT`` expert columns; any other
    config as it is."""
    if cfg.name.startswith("mixtral"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, d_ff_expert=D_FF_EXPERT))
    return cfg


def tp_config(cfg):
    """The serving steps' config: one replica slot (the engines set
    theirs from ``ServeConfig.dup_slots``)."""
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, duplication_slots=1))


def tp_tokens(cfg):
    """``TP_B`` seeded prompts of ``TP_S`` Zipf tokens, row b shifted by
    256 (b // 2), so the rows' hot experts differ."""
    from repro_torch.data.synthetic import token_batches

    toks = next(token_batches(3, cfg.vocab_size, TP_B, TP_S))["tokens"]
    return ((toks + 256 * (np.arange(TP_B)[:, None] // 2))
            % cfg.vocab_size).astype(np.int32)


def tp_plan(cfg):
    """A stacked plan that replicates each layer's hot expert (Algorithm 1
    on a skewed histogram, rolled by layer), as numpy arrays."""
    m, R = cfg.moe, MESH[1]
    plans = [duplicate_experts_host(np.roll([0.55, 0.15, 0.2, 0.1], l), R,
                                    m.duplication_slots, m.max_copies).plan
             for l in range(cfg.num_layers)]
    return PlacementPlan(*(np.asarray(a) for a in stack_plans(plans)))


def tp_quota(cfg, plan):
    """(L, E, C_max) int32 greedy quotas for the skewed histogram at a
    tight capacity, so the hot expert's copies split unevenly."""
    m, R = cfg.moe, MESH[1]
    quotas = []
    for l in range(cfg.num_layers):
        counts = np.roll([0.55, 0.15, 0.2, 0.1], l) * 4096
        layer = PlacementPlan(*(a[l] for a in plan))
        quotas.append(make_scheduler("greedy").plan_layer(
            counts, layer, ep_ranks=R, dup_slots=m.duplication_slots,
            cap=counts.max() / 8).quota)
    return np.stack(quotas).astype(np.int32)


def _to_np(t):
    return t.float().cpu().numpy()


def _stats_np(stats) -> dict:
    return {k: np.asarray(torch.as_tensor(v).float().cpu())
            for k, v in stats.items() if k != "aux_loss" and k != "z_loss"}


def held_bytes(model, shard, store=None) -> dict:
    """The parameter bytes this process holds and the sum of its leaves'
    ``Sharder.block_shape`` bytes; with a replica store also the bytes of
    its rows beyond the home experts (the model's own), beside the same
    rows' blocks: each replica row holds one home expert's block."""
    out = tp.held_bytes(model, shard)
    if store is not None:
        extra = store.device_bytes - sum(
            p.numel() * p.element_size() for n, p in model.named_parameters()
            if n.rsplit(".", 1)[-1] in store.weights)
        e_loc = store.home_rows
        want = sum(math.prod(shard.block_shape(f"layers.{l}.{k}"))
                   // e_loc * (w[l].shape[0] - e_loc) * w[l].element_size()
                   for k, w in store.weights.items()
                   for l in range(len(w)))
        out["store"], out["store_blocks"] = extra, want
    return out


def serve_leg(arch, tree, mesh):
    cfg = variant(get_config(arch).reduced())
    shard = sharder(cfg, mesh, "fsdp")
    model = params_from_jax(tree, cfg, device="cpu", shard=shard)
    kw = tp.MOE_SERVE_KW if cfg.is_moe else tp.DENSE_SERVE_KW
    eng = ServeEngine(cfg, model, ServeConfig(**kw), ep=cfg.is_moe,
                      ep_ranks=mesh.model if cfg.is_moe else 1, mesh=mesh)
    rec = tp._SCOPE["serve_tp"](eng, tp.serve_batches(cfg), tp.NEW,
                                tp.STEP_S, _to_np)
    rec["bytes"] = held_bytes(model, shard, eng._store)
    rec["data_dims"] = {n: (None if p.placement.data_dim is None else
                            int(p.placement.data_dim))
                        for n, p in model.named_parameters()}
    return rec


def continuous_leg(tree, mesh):
    cfg = variant(get_config("mixtral-8x7b").reduced())
    shard = sharder(cfg, mesh, "fsdp")
    model = params_from_jax(tree, cfg, device="cpu", shard=shard)
    eng = ContinuousEngine(cfg, model, ContinuousConfig(**ds.ENGINE_KW),
                           ep_ranks=mesh.model, ep=True, mesh=mesh)
    reqs = [ServeRequest(**r) for r in ds.requests(cfg.vocab_size)]
    rec = ds._SCOPE["serve_capture"](eng, reqs, _to_np, PLAN_FIELDS)
    rec["bytes"] = held_bytes(model, shard, eng._store)
    return rec


def tp_leg(tree, mesh, quota: bool, layout: str = "fsdp"):
    """The serving steps under ``Runtime(decode_expert_tp=True)`` on a
    model laid out by ``layout`` + expert TP ("specs" alone: no expert
    TP): the prefill (experts gathered), then ``TP_STEPS`` decode steps
    with each rank's blocks of the experts' F columns. Records every
    step's logits, greedy tokens and statistics, the parameter bytes and
    the expert leaves' specs."""
    cfg = tp_config(variant(get_config("mixtral-8x7b").reduced()))
    shard = sharder(cfg, mesh, layout, expert_tp=layout == "fsdp")
    model = params_from_jax(tree, cfg, device="cpu", shard=shard)
    plan = tp_plan(cfg)
    resched = torch.tensor(tp_quota(cfg, plan)) if quota else None
    rt = Runtime(ep=True, ep_ranks=mesh.model, mesh=mesh,
                 decode_expert_tp=True)
    cache = init_cache(local_config(model, cfg), rt, TP_B, TP_S + TP_STEPS,
                       device="cpu")
    prefill, decode = make_prefill_step(cfg, rt), make_decode_step(cfg, rt)
    logits, cache, stats = prefill(model, torch.tensor(tp_tokens(cfg)),
                                   cache, plan=plan, resched=resched)
    rec = {"logits": [_to_np(logits)], "stats": [_stats_np(stats)],
           "tokens": []}
    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    for t in range(TP_STEPS):
        rec["tokens"].append(tok.numpy().copy())
        tok, logits, cache, stats = decode(model, tok, cache, TP_S + t,
                                           plan=plan, resched=resched)
        rec["logits"].append(_to_np(logits))
        rec["stats"].append(_stats_np(stats))
    rec["tokens"].append(tok.numpy().copy())
    rec["bytes"] = tp.held_bytes(model, shard)
    rec["expert_spec"] = [str(shard.specs[f"layers.0.{k}"])
                          for k in ("w_gate", "w_up", "w_down")]
    return rec


def run_leg(name, trees, mesh):
    if name.startswith("serve_"):
        arch = name[len("serve_"):]
        return serve_leg(arch, trees[arch], mesh)
    if name == "continuous":
        return continuous_leg(trees["mixtral-8x7b"], mesh)
    return tp_leg(trees["mixtral-8x7b"], mesh, quota=name == "tp_resched",
                  layout="specs" if name == "tp_specs" else "fsdp")


def run_rank(mesh, trees: dict, names):
    """The entry point of each spawned rank: the legs of ``names``."""
    return {n: run_leg(n, trees, mesh) for n in names}
