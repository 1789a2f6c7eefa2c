"""Legs of ``tests/test_torch_dist_train.py``: the port's train step with one
rank a process (``launch.mesh``) or, for the references, in this process.
The module imports torch and ``repro_torch`` only, so the ranks that
``launch.mesh.spawn`` starts import it quickly; ``run_rank`` is their entry
point and returns numpy arrays (the trees in the JAX layout, on each model
group's rank 0, whole: the expert leaves gathered over the group).

Legs, each on reduced widths and one seeded batch of ``B`` x ``S`` tokens:

* MoE legs under EP: reduced Mixtral on the JAX init's wide-margin weights
  (the test passes the tree), plain, under ``remat`` and with 2
  microbatches; reduced deepseek-v2-lite-16b with its router variant (E 16,
  K 6, 2 shared experts) on the port's own seeded weights;
* data-parallel legs (no MoE): reduced qwen1.5-0.5b on the JAX init's
  weights, and with a random loss mask; recurrentgemma-2b, rwkv6-7b,
  seamless-m4t-medium (random frames) and llava-next-34b (random prefix
  embeddings) on the port's seeded weights;
* ``replicated``: three steps of reduced Mixtral, then a digest of every
  parameter's bytes on each rank;
* ``launcher``: ``launch.train.train`` as a mesh rank, writing a
  checkpoint;
* ``collectives``: the gradient each ``ProcessGroupRanks`` collective that
  training takes passes back, and a raise from each of the others given
  a tensor that requires a gradient (``collective_grads``).

A leg returns the gradient half of the step (``make_grad_fn``: loss,
metrics, gradients) and, where it names a step, ``make_train_step``'s
metrics, parameters and first moments after one step at ``LR``.
"""

import argparse
import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.bridge import opt_state_to_jax, params_from_jax, params_to_jax
from repro_torch.configs.registry import get_config
from repro_torch.models.transformer import (Runtime, expert_param_names,
                                            init_model)
from repro_torch.optim.adamw import AdamWState
from repro_torch.sharding import expert_block
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.steps import (init_opt_state, make_grad_fn,
                                     make_train_step)

B, S, LR = 4, 32, 1e-3
# leg -> (arch, the weights: "jax" bridged from the tree the test passes,
# or "port" drawn from the seed; make_train_step keyword arguments; steps:
# 0 the gradients only, 1 also one step, 3 three steps and the digests)
LEGS = {
    "mixtral": ("mixtral-8x7b", "jax", {}, 1),
    "mixtral_remat": ("mixtral-8x7b", "jax", {"remat": True}, 1),
    "mixtral_mb2": ("mixtral-8x7b", "jax", {"microbatches": 2}, 1),
    "deepseek": ("deepseek-v2-lite-16b", "port", {}, 1),
    "qwen": ("qwen1.5-0.5b", "jax", {}, 1),
    "qwen_mask": ("qwen1.5-0.5b", "jax", {}, 0),
    "recurrentgemma": ("recurrentgemma-2b", "port", {}, 0),
    "rwkv": ("rwkv6-7b", "port", {}, 0),
    "seamless": ("seamless-m4t-medium", "port", {}, 0),
    "llava": ("llava-next-34b", "port", {}, 0),
    "replicated": ("mixtral-8x7b", "jax", {}, 3),
}
WORLDS = {(1, 4): ("collectives", "mixtral", "mixtral_remat", "deepseek",
                   "launcher"),
          (2, 2): ("mixtral", "mixtral_mb2", "qwen", "qwen_mask",
                   "recurrentgemma", "rwkv", "seamless", "llava",
                   "replicated")}
FRAMES, SEED = 24, 0
LAUNCH_ARGS = dict(arch="mixtral-8x7b", reduced=True, steps=2, batch=4,
                   seq=32, lr=3e-4, seed=0, log_every=1, data_mesh=1,
                   model_mesh=4, backend="gloo", device="cpu", trace_out="",
                   remat=False)


def leg_config(leg: str):
    arch = LEGS[leg][0]
    cfg = get_config(arch).reduced()
    if arch == "deepseek-v2-lite-16b":
        # the router variant: E 16, K 6 and two shared experts
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=16, top_k=6, num_shared_experts=2))
    return cfg


def leg_batch(leg: str, cfg) -> dict:
    """The leg's whole batch, numpy, seeded: tokens and labels, and where
    the leg has them a loss mask, frames or prefix embeddings."""
    rng = np.random.default_rng(SEED)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if leg == "qwen_mask":
        batch["loss_mask"] = (rng.random((B, S)) < 0.6).astype(np.float32)
    if cfg.is_encdec:
        batch["frames"] = rng.normal(
            size=(B, FRAMES, cfg.encoder.d_model)).astype(np.float32)
    if cfg.input_mode == "mixed":
        batch["prefix_embeds"] = rng.normal(
            size=(B, cfg.num_prefix_embeddings, cfg.d_model)).astype(
                np.float32)
    return batch


def leg_runtime(cfg, model_axis: int, mesh=None) -> Runtime:
    """The JAX launcher's runtime: EP over the model axis for a MoE
    model."""
    return Runtime(ep=cfg.is_moe, ep_ranks=model_axis, mesh=mesh)


def _keep_experts(model, mesh) -> None:
    """Keep, in place, this rank's block of each MoE layer's experts."""
    lo, hi = expert_block(model.cfg.moe.num_experts,
                          {"model": mesh.model_index}, mesh)
    params = dict(model.named_parameters())
    for name in expert_param_names(model):
        layer, attr = name.rsplit(".", 1)
        mod = model.get_submodule(layer)
        setattr(mod, attr, torch.nn.Parameter(
            params[name].data[lo:hi].clone(), requires_grad=True))


def leg_model(leg: str, tree=None, mesh=None):
    """The leg's trainable model on the CPU: bridged from ``tree`` or drawn
    from the seed; on a mesh under EP with this rank's experts only."""
    cfg = leg_config(leg)
    if LEGS[leg][1] == "jax":
        model = params_from_jax(tree, cfg, device="cpu", trainable=True)
        if mesh is not None and cfg.is_moe:
            _keep_experts(model, mesh)
        return model
    block = (None if mesh is None or not cfg.is_moe else expert_block(
        cfg.moe.num_experts, {"model": mesh.model_index}, mesh))
    return init_model(cfg, torch.Generator().manual_seed(SEED), device="cpu",
                      trainable=True, expert_block=block)


def _np(v):
    return torch.as_tensor(v).detach().float().numpy()


def _flat_grads(model, grads, comm):
    """The gradients as a flat JAX-layout dict, whole (the group's rank 0)
    or None."""
    tree = opt_state_to_jax(AdamWState(torch.zeros((), dtype=torch.int32),
                                       grads, grads), model, comm)
    return None if tree is None else ckpt.flatten(tree.mu)


def digests(model) -> dict:
    """{parameter name: sha1 of its bytes}."""
    return {n: hashlib.sha1(p.detach().numpy().tobytes()).hexdigest()
            for n, p in model.named_parameters()}


def run_leg(leg: str, trees: dict, model_axis: int, mesh=None,
            **step_kw) -> dict:
    """Leg ``leg`` over ``mesh`` (this process's rank) or, when None, in
    this process with ``model_axis`` EP ranks stacked (a MoE model) or on
    the whole batch (a model without MoE, ``model_axis`` ignored);
    ``step_kw`` in place of the leg's ``make_train_step`` arguments."""
    arch, _, kw, steps = LEGS[leg]
    kw = dict(kw, **step_kw)
    cfg = leg_config(leg)
    rt = leg_runtime(cfg, model_axis, mesh)
    comm = None if mesh is None else mesh.comm
    batch = leg_batch(leg, cfg)
    out = {}
    if steps == 3:
        model = leg_model(leg, trees.get(arch), mesh)
        opt, step = init_opt_state(model), make_train_step(
            cfg, rt, lr_fn=lambda s: LR, **kw)
        for i in range(3):
            opt, _ = step(model, opt, {k: np.roll(v, i, axis=0)
                                       for k, v in batch.items()})
        return {"digests": digests(model),
                "experts": sorted(expert_param_names(model))}
    model = leg_model(leg, trees.get(arch), mesh)
    loss, metrics, grads = make_grad_fn(cfg, rt, **kw)(model, batch)
    out["loss"] = float(loss)
    out["metrics"] = {k: _np(v) for k, v in metrics.items()}
    out["grads"] = _flat_grads(model, grads, comm)
    if steps:
        model = leg_model(leg, trees.get(arch), mesh)
        opt, m = make_train_step(cfg, rt, lr_fn=lambda s: LR, **kw)(
            model, init_opt_state(model), batch)
        out["step"] = {k: _np(v) for k, v in m.items()}
        params = params_to_jax(model, comm)
        mu = opt_state_to_jax(opt, model, comm)
        out["params"] = None if params is None else ckpt.flatten(params)
        out["mu"] = None if mu is None else ckpt.flatten(mu.mu)
    return out


# the collectives with no backward, each given a tensor that requires a
# gradient while autograd records
NO_BACKWARD = ("psum", "psum_counts", "psum_ordered", "gather", "mean_",
               "transfer")


def collective_inputs(R: int, n: int = 6):
    """(inputs, cotangents) of ``collective_grads``' cases, fp32 numpy:
    "a2a" (R, R, n) send buffers, "gather" and "local" (R, n) rows,
    "loss" (R,) losses, "weight" (n,) a replicated weight; the
    cotangents are every rank's (the loss of each case is the sum over
    the ranks of what each rank adds)."""
    rng = np.random.default_rng(11)

    def draw(*shape):
        return rng.normal(size=shape).astype(np.float32)
    x = {"a2a": draw(R, R, n), "gather": draw(R, n), "local": draw(R, n),
         "loss": draw(R), "weight": draw(n)}
    c = {"a2a": draw(R, R, n), "gather": draw(R, n), "local": draw(R, n),
         "loss": draw(1)[0], "weight": draw(R, n)}
    return x, c


def collective_grads(mesh) -> dict:
    """Each gradient-carrying collective of the model group on this rank's
    share of ``collective_inputs``, the gradient it passes back (numpy),
    whether each of ``NO_BACKWARD`` raised, and whether they all still run
    under ``no_grad``."""
    comm, r = mesh.comm, mesh.model_index
    x, c = collective_inputs(comm.ranks)

    def leaf(a):
        return torch.tensor(a, requires_grad=True)
    out = {}
    buf = leaf(x["a2a"][r:r + 1])
    (comm.all_to_all(buf)[0] * torch.tensor(c["a2a"][r])).sum().backward()
    out["all_to_all"] = buf.grad.numpy()
    t = leaf(x["gather"][r:r + 1])
    (comm.all_gather(t) * torch.tensor(c["gather"])).sum().backward()
    out["all_gather"] = t.grad.numpy()
    t = leaf(x["local"])
    (comm.local(t) * torch.tensor(c["local"][r])).sum().backward()
    out["local"] = t.grad.numpy()
    t = leaf(x["loss"][r:r + 1])
    (comm.pmean_losses(t)[0] * float(c["loss"])).backward()
    out["pmean_losses"] = t.grad.numpy()
    w = leaf(x["weight"])
    (comm.psum_grad(w) * torch.tensor(c["weight"][r])).sum().backward()
    out["psum_grad"] = w.grad.numpy()

    t = leaf(x["local"][r:r + 1])
    calls = {"psum": lambda: comm.psum(t),
             "psum_counts": lambda: comm.psum_counts(t),
             "psum_ordered": lambda: comm.psum_ordered(t[0]),
             "gather": lambda: comm.gather(t),
             "mean_": lambda: comm.mean_([t[0]]),
             "transfer": lambda: comm.transfer([(0, t, 1, t)])}
    out["raised"] = {}
    for name, call in calls.items():
        try:
            call()
            out["raised"][name] = False
        except RuntimeError as e:
            out["raised"][name] = "has no backward" in str(e)
    with torch.no_grad():
        comm.psum(t)
        comm.psum_ordered(t[0])
        comm.gather(t)
        out["no_grad_ran"] = bool(comm.all_gather(t).shape[0] == comm.ranks)
    return out


def run_launcher(path: str, mesh=None) -> int:
    """``launch.train``'s run of ``LAUNCH_ARGS`` with its checkpoint at
    ``path``: as this mesh rank, or stacked in this process."""
    from repro_torch.launch import train as launch_train

    args = dict(LAUNCH_ARGS, ckpt=path)
    if mesh is None:
        args["backend"] = "stacked"
    return launch_train.train(argparse.Namespace(**args), mesh)


def run_rank(mesh, trees: dict, legs, ckpt_path: str = ""):
    """The entry point of each spawned rank: every leg of ``legs``."""
    torch.manual_seed(SEED)
    out = {}
    for leg in legs:
        if leg == "launcher":
            out[leg] = run_launcher(ckpt_path, mesh)
        elif leg == "collectives":
            out[leg] = collective_grads(mesh)
        else:
            out[leg] = run_leg(leg, trees, mesh.model, mesh)
    return out
