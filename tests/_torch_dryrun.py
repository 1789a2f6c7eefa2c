"""Live legs for ``tests/test_torch_dryrun.py``: each rank of a process
world (``launch.mesh.spawn``) runs a prefill, a decode step or a train
step of a reduced config and records the result bytes of the collectives
it issued, by kind (``moe.dispatch.COLLECTIVE_BYTES``), and its argument
bytes: its parameter blocks (and moments), and its rows of the cache and
the inputs. The test holds each against ``launch.dryrun.trace_one`` on
the same mesh. ``run_rank`` is the ranks' entry point; this module imports
torch and ``repro_torch`` only.
"""

import dataclasses

import torch

from repro_torch.bridge import sharder
from repro_torch.configs.base import InputShape
from repro_torch.configs.registry import get_config
from repro_torch.launch import specs
from repro_torch.models.transformer import (Runtime, init_cache, init_model,
                                            local_config)
from repro_torch.moe import dispatch
from repro_torch.train.steps import (init_opt_state, make_decode_step,
                                     make_prefill_step, make_train_step)

B, S = 4, 16
SHAPES = {kind: InputShape(kind, S, B, kind)
          for kind in ("train", "prefill", "decode")}
# leg -> (arch, step, layout): a MoE model under EP and a dense one on the
# tensor-parallel rules, each step; one FSDP train step
LEGS = {f"{a.split('-')[0]}_{k}": (a, k, "specs")
        for a in ("mixtral-8x7b", "qwen1.5-0.5b")
        for k in ("prefill", "decode", "train")}
LEGS["qwen_train_fsdp"] = ("qwen1.5-0.5b", "train", "fsdp")


def leg_config(arch: str):
    """The reduced config at two layers."""
    return dataclasses.replace(get_config(arch).reduced(), num_layers=2)


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def run_rank(mesh, legs):
    """{leg: {"collectives": {kind: bytes, "count"}, "argument_bytes"}}."""
    out = {}
    for name, (arch, kind, layout) in legs.items():
        cfg = leg_config(arch)
        shape = SHAPES[kind]
        rt = Runtime(mesh=mesh, ep=cfg.is_moe, ep_ranks=mesh.model)
        plan = specs.plan_args(cfg, mesh.model)
        gen = torch.Generator().manual_seed(0)
        model = init_model(cfg, gen, device="cpu", trainable=kind == "train",
                           shard=sharder(cfg, mesh, layout))
        tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                               dtype=torch.int32)
        rows = B // mesh.data if B % mesh.data == 0 else B
        share = rows / B
        held = _bytes(model.parameters())
        dispatch.reset_collective_bytes()
        if kind == "train":
            opt = init_opt_state(model)
            batch = {"tokens": tokens, "labels": tokens}
            held += _bytes([opt.step, *opt.mu.values(), *opt.nu.values()])
            held += share * _bytes(batch.values())
            make_train_step(cfg, rt)(model, opt, batch, plan=plan)
        else:
            cache = init_cache(local_config(model, cfg), rt, B, S,
                               device="cpu")
            held += share * _bytes(cache.values())
            if kind == "prefill":
                held += share * _bytes([tokens])
                make_prefill_step(cfg, rt)(model, tokens, cache=cache,
                                           plan=plan)
            else:
                held += share * _bytes([tokens[:, :1]])
                make_decode_step(cfg, rt)(model, tokens[:, :1], cache, S - 1,
                                          plan=plan)
        out[name] = {"collectives": dispatch.collective_bytes(),
                     "argument_bytes": held}
    return out
