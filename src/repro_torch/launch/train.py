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
cosine, or WSD (minicpm-2b). ``--data-mesh 1
--model-mesh R`` trains an MoE model through the expert-parallel dispatch
over R ranks on the one device (``Runtime(ep=True, ep_ranks=R)``, the
identity plan stack, no replica slots: the JAX launcher's
``use_duplication=False``); a dense model trains as without it. One device
has no data axis, so any other ``--data-mesh`` raises.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b \
      --reduced --device cpu --data-mesh 1 --model-mesh 4
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.placement import identity_plan, stack_plans, to_device
from repro_torch.data.synthetic import token_batches
from repro_torch.device import resolve_device
from repro_torch.models.transformer import Runtime, init_model
from repro_torch.obs import SpanTracer
from repro_torch.optim.schedules import cosine_schedule, wsd_schedule
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


def main(argv=None) -> int:
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
                    help="1, with --model-mesh R: an MoE model trains "
                         "through the expert-parallel dispatch over R ranks "
                         "on the one device (0 = the single-device path)")
    ap.add_argument("--model-mesh", type=int, default=0,
                    help="EP ranks R, with --data-mesh 1")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome trace-event JSON of the steps")
    ap.add_argument("--remat", action="store_true",
                    help="recompute each layer in the backward (less "
                         "activation memory, the same values)")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    rt = Runtime()
    if args.data_mesh and args.model_mesh:
        if args.data_mesh != 1:
            raise ValueError(
                f"--data-mesh {args.data_mesh}: one device has no data axis "
                "(training across cards waits for a torch.distributed "
                "backend: ROADMAP.md section 1, item 4)")
        rt = Runtime(ep=cfg.is_moe, ep_ranks=args.model_mesh)
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
    dev = resolve_device(args.device)
    plan = None
    if rt.ep:
        m = cfg.moe
        plan = to_device(stack_plans([
            identity_plan(m.num_experts, rt.ep_ranks, 0, m.max_copies)
            for _ in range(cfg.num_layers)]), m.num_experts, rt.ep_ranks, 0,
            dev)
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                       device=dev, trainable=True)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"(analytical {cfg.num_params()/1e6:.1f}M) "
          f"family={cfg.family} moe={cfg.is_moe}")

    opt = init_opt_state(model)
    tracer = SpanTracer(enabled=bool(args.trace_out),
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
            print(f"step {step:4d} loss={losses[-1]:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.2f}{extra}")
    dt = time.perf_counter() - t0
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({dt / args.steps * 1e3:.0f} ms/step); "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f}")

    if args.ckpt:
        from repro_torch.bridge import opt_state_to_jax, params_to_jax
        ckpt.save(args.ckpt, {"params": params_to_jax(model),
                              "opt": opt_state_to_jax(opt, model)})
        print(f"checkpoint saved to {args.ckpt}")
    if args.trace_out:
        tracer.export(args.trace_out)
        print(f"trace written to {args.trace_out}")
    return 0 if losses[-1] < losses[0] else 1


if __name__ == "__main__":
    raise SystemExit(main())
