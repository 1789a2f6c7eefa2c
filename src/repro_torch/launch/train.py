"""Training entry point (the port of ``repro.launch.train``): real steps of
``train.steps.make_train_step`` on random weights from ``--seed``, over
Zipf-distributed token batches from the same seed.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \
      --reduced --device cpu --steps 20 --batch 4 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
      --reduced --device cpu --steps 20 --batch 4 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-7b \
      --reduced --device cpu --steps 20 --batch 4 --seq 64
  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch seamless-m4t-medium --reduced --device cpu --steps 20

An encoder-decoder's encoder is fed zero frames of (batch, min(64,
max_source_len), d_enc) in bf16 every step, as the JAX launcher feeds them
(the encoder's output is then zero, and so is what the cross-attention
adds). A VLM (``input_mode="mixed"``) is fed zero patch embeddings of
(batch, num_prefix_embeddings, d) in bf16 before its tokens, as the JAX
launcher feeds them; the loss scores the text positions only.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llava-next-34b \
      --reduced --device cpu --steps 20

It takes the JAX launcher's flags, prints its lines and returns its code:
0 when the last step's loss is below the first. ``--device`` (default
cuda) picks the card or, with ``cpu``, the kernels' plain versions;
``--trace-out`` writes one span per step (host clock, each step ending on
its loss's read-back) as Chrome trace-event JSON; ``--remat`` recomputes
each layer in the backward (``make_train_step(remat=True)``: the same
values in less memory); fp32 matrix products stay fp32 (TF32 off). A
config's ``lr_schedule`` picks the schedule:
cosine, or WSD (minicpm-2b).

``--data-mesh`` and ``--model-mesh`` follow the JAX launcher's rule: both
nonzero train on a ``(data, model)`` mesh, a MoE model through the
expert-parallel dispatch over the model ranks with the identity plan and
no replica slots (the JAX launcher's ``use_duplication=False``), a model
without MoE data-parallel, its model ranks repeating their data rank's
work. ``--backend`` says where the ranks run. ``stacked`` (the default):
the EP ranks as a leading tensor dimension in this one process, on one
device (``Runtime(ep=True, ep_ranks=M)``), so ``--data-mesh`` must be 1.
``gloo`` or ``nccl``: the launcher starts ``data x model`` processes, one
a mesh rank (``launch.mesh``); each draws the whole model's weights from
``--seed`` and keeps its block of the experts and their moments, draws
the whole batch and trains on its data rank's rows; the gradients are
averaged over the data ranks. ``nccl`` takes a card a rank (fewer cards
raise); ``gloo`` runs on the CPU with ``--device cpu`` or, on a card,
stages its collectives through the host, every rank on card 0. Rank 0
prints the lines and writes ``--ckpt``, the whole model's, which the JAX
package restores. ``--shard-params`` lays the parameters (and their
moments) out over the mesh (``sharding``): ``none`` (the default) as
above; ``specs`` also the tensor-parallel blocks of the attention,
recurrent, RWKV and vocab leaves, so the model ranks of a model without
MoE divide its work; ``fsdp`` every weight's block over the data ranks
too (ZeRO-3: gathered at use, gradients reduce-scattered).

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-3b \
      --reduced --device cpu --data-mesh 2 --model-mesh 2 --backend gloo \
      --shard-params fsdp

  PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \
      --reduced --device cpu --data-mesh 1 --model-mesh 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \
      --reduced --device cpu --data-mesh 2 --model-mesh 2 --backend gloo
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.placement import identity_plan, stack_plans, to_device
from repro_torch.data.synthetic import token_batches
from repro_torch.device import resolve_device
from repro_torch.bridge import sharder
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.transformer import Runtime, init_model
from repro_torch.obs import SpanTracer
from repro_torch.optim.schedules import cosine_schedule, wsd_schedule
from repro_torch.sharding import LAYOUTS
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.steps import init_opt_state, make_train_step


def build_lr_fn(cfg, base_lr: float, total_steps: int):
    """The JAX launcher's schedule choice. (The JAX launcher also passes
    ``stable=`` to ``wsd_schedule``, which takes no such argument, so its
    WSD branch raises there; this one calls the schedule as defined.)"""
    if cfg.lr_schedule == "wsd":
        return wsd_schedule(base_lr, warmup=max(10, total_steps // 20),
                            total=total_steps)
    return cosine_schedule(base_lr, warmup=max(10, total_steps // 20),
                           total=total_steps)


BACKENDS = ("stacked",) + mesh_mod.BACKENDS


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale variant (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt", default="", help="save checkpoint here at the end")
    ap.add_argument("--data-mesh", type=int, default=0,
                    help="data ranks D, with --model-mesh (0 = the "
                         "single-device path)")
    ap.add_argument("--model-mesh", type=int, default=0,
                    help="model ranks M, with --data-mesh: an MoE model's "
                         "EP ranks")
    ap.add_argument("--backend", default="stacked", choices=BACKENDS,
                    help="stacked: the EP ranks as a tensor dimension in "
                         "this process (--data-mesh 1); nccl / gloo: one "
                         "process a mesh rank")
    ap.add_argument("--shard-params", default="none", choices=LAYOUTS,
                    help="the parameters' layout on a process mesh: none "
                         "(the experts' blocks), specs (tensor-parallel "
                         "blocks too), fsdp (and every weight over data)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome trace-event JSON of the steps")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each layer in the backward (less "
                         "activation memory, the same values)")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    mesh_flags = bool(args.data_mesh and args.model_mesh)
    if args.backend == "stacked":
        if mesh_flags and args.data_mesh != 1:
            raise ValueError(
                f"--data-mesh {args.data_mesh}: the stacked backend runs "
                "every EP rank in this process on one device, which has no "
                "data axis; a data axis needs --backend gloo or nccl (one "
                "process a mesh rank)")
        if args.shard_params != "none":
            raise ValueError(f"--shard-params {args.shard_params} lays the "
                             "parameters out over a process mesh: name "
                             "--backend gloo or nccl")
        return train(args)
    if not mesh_flags:
        raise ValueError(f"--backend {args.backend} runs a process mesh: "
                         "give --data-mesh and --model-mesh")
    device, threads = mesh_mod.rank_device(args.backend, args.device)
    return mesh_mod.spawn(_train_rank, (vars(args),), data=args.data_mesh,
                          model=args.model_mesh, backend=args.backend,
                          device=device, threads=threads)[0]


def _train_rank(mesh, argv: dict) -> int:
    return train(argparse.Namespace(**argv), mesh)


def train(args, mesh=None) -> int:
    """The launcher's run for ``args``; with ``mesh``, as its rank (rank 0
    prints and writes the checkpoint). Returns 0 when the last step's loss
    is below the first (rank 0's, which every rank shares)."""
    say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    rt = Runtime()
    if args.data_mesh and args.model_mesh:
        rt = Runtime(ep=cfg.is_moe, ep_ranks=args.model_mesh, mesh=mesh)
    if rt.ep:
        if cfg.moe.num_experts % rt.ep_ranks:
            raise ValueError(f"--model-mesh {rt.ep_ranks} does not divide "
                             f"{cfg.moe.num_experts} experts")
        # the JAX launcher's use_duplication=False: no replica slots
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, duplication_slots=0))
    step_fn = make_train_step(cfg, rt, lr_fn=build_lr_fn(cfg, args.lr,
                                                         args.steps),
                              remat=args.remat)
    dev = resolve_device(args.device) if mesh is None else mesh.device
    plan = None
    if rt.ep:
        m = cfg.moe
        plan = to_device(stack_plans([
            identity_plan(m.num_experts, rt.ep_ranks, 0, m.max_copies)
            for _ in range(cfg.num_layers)]), m.num_experts, rt.ep_ranks, 0,
            dev)
    # a mesh rank keeps its blocks under the layout (every weight drawn)
    shard = (None if mesh is None else
             sharder(cfg, mesh, getattr(args, "shard_params", "none")))
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                       device=dev, trainable=True, shard=shard)
    n_params = (sum(p.numel() for p in model.parameters()) if shard is None
                else sum(math.prod(s) for s in shard.shapes.values()))
    say(f"arch={cfg.name} params={n_params/1e6:.1f}M "
        f"(analytical {cfg.num_params()/1e6:.1f}M) "
        f"family={cfg.family} moe={cfg.is_moe}")

    opt = init_opt_state(model)
    tracer = SpanTracer(
        enabled=bool(args.trace_out) and (mesh is None or mesh.rank == 0),
        process_name="repro-torch-launch-train")
    gen = token_batches(args.seed, cfg.vocab_size, args.batch, args.seq)
    losses = []
    t0 = time.perf_counter()
    for step in range(args.steps):
        batch = next(gen)
        if cfg.input_mode == "mixed" and cfg.num_prefix_embeddings:
            batch["prefix_embeds"] = torch.zeros(
                (args.batch, cfg.num_prefix_embeddings, cfg.d_model),
                dtype=torch.bfloat16, device=dev)
        if cfg.is_encdec:
            batch["frames"] = torch.zeros(
                (args.batch, min(64, cfg.encoder.max_source_len),
                 cfg.encoder.d_model), dtype=torch.bfloat16, device=dev)
        with tracer.span("train_step", cat="train", args={"step": step}):
            opt, metrics = step_fn(model, opt, batch, plan)
            losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            extra = ""
            if cfg.is_moe and metrics.get("expert_counts") is not None:
                c = metrics["expert_counts"].cpu().numpy().sum(0)
                extra = f" skew={c.max() / max(c.mean(), 1e-9):.2f}"
            say(f"step {step:4d} loss={losses[-1]:.4f} "
                f"lr={float(metrics['lr']):.2e} "
                f"gnorm={float(metrics['grad_norm']):.2f}{extra}")
    dt = time.perf_counter() - t0
    say(f"done: {args.steps} steps in {dt:.1f}s "
        f"({dt / args.steps * 1e3:.0f} ms/step); "
        f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")

    if args.ckpt:
        from repro_torch.bridge import checkpoint_tree
        tree = checkpoint_tree(model, opt, mesh)
        if mesh is None or mesh.rank == 0:
            ckpt.save(args.ckpt, tree)
            say(f"checkpoint saved to {args.ckpt}")
    if args.trace_out and tracer.enabled:
        tracer.export(args.trace_out)
        say(f"trace written to {args.trace_out}")
    return 0 if losses[-1] < losses[0] else 1


if __name__ == "__main__":
    raise SystemExit(main())
