"""Serving entry point: batched requests through the ``ServeEngine`` with
prediction-guided expert duplication (the port of ``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \
      --reduced --device cpu --requests 8 --batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
      --reduced --device cpu --data-mesh 1 --model-mesh 4 --seq 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --reduced --device cpu --requests 8 --batch 4 --seq 40 --new-tokens 6
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \
      --reduced --device cpu --requests 8 --batch 4 --seq 40 --new-tokens 6

``--data-mesh`` and ``--model-mesh`` follow the JAX launcher's rule: both
nonzero turn the expert-parallel path on (``ServeEngine(ep=True)``), with
``--model-mesh`` EP ranks as a leading tensor dimension on the one device.
One card has no data axis, so ``--data-mesh`` must then be 1, and each
prompt of ``--seq`` tokens splits over the ranks.

An encoder-decoder (seamless-m4t-medium) fails in the forward with
``KeyError``: the launcher sends tokens and no frames, as the JAX launcher
does, and the encoder needs them (``ServeEngine.generate`` with
``batch["frames"]`` serves it).

A model without MoE (the dense family, Griffin, RWKV) has no experts to
balance:
its ``--strategy`` is "none" (the default there; the default for a MoE
model is "dist_only"), and another strategy or the mesh flags raise.

Weights are random, drawn from ``--seed``; prompts are Zipf-distributed
tokens from the same seed (numpy, so the JAX launcher gets the same ones).
``--strategy token_to_expert`` fits a ``ConditionalProbabilityModel`` on a
synthetic routing trace (64 sequences of ``--seq`` tokens, skew 1.5, from
``--seed``), as the JAX launcher does, and hands it to the engine.
``main(argv)`` returns 0 when every request completes. fp32 matrix
products stay fp32 (TF32 off), as the fp32 recurrences of Griffin and RWKV
are computed in the reference.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import get_config
from repro_torch.core.predictors import ConditionalProbabilityModel
from repro_torch.data.synthetic import make_routing_trace, token_batches
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_model
from repro_torch.serve import BatchScheduler, Request, ServeConfig, ServeEngine
from repro_torch.serve.engine import STRATEGIES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--strategy", default=None, choices=STRATEGIES,
                    help="default dist_only for a MoE model; a model "
                         "without MoE takes none only")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--dup-slots", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-mesh", type=int, default=0)
    ap.add_argument("--model-mesh", type=int, default=0,
                    help="with --data-mesh 1: EP ranks (the JAX launcher's "
                         "mesh flags)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome trace-event JSON of the run "
                         "(open in Perfetto / chrome://tracing)")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not cfg.is_moe:
        if args.strategy not in (None, "none"):
            raise ValueError(f"--strategy {args.strategy}: {cfg.name} has no "
                             "experts to balance (--strategy none)")
        if args.data_mesh or args.model_mesh:
            raise ValueError(f"--data-mesh / --model-mesh: {cfg.name} has no "
                             "experts to place on EP ranks")
    strategy = args.strategy or ("dist_only" if cfg.is_moe else "none")
    ep, ep_ranks = False, 1
    if args.data_mesh and args.model_mesh:
        if args.data_mesh != 1:
            raise ValueError(
                f"--data-mesh {args.data_mesh}: one device has no data axis "
                "(serving across cards waits for a torch.distributed "
                "backend: ROADMAP.md section 1, item 4)")
        ep, ep_ranks = True, args.model_mesh
        if args.seq % ep_ranks:
            raise ValueError(f"--seq {args.seq} does not split over "
                             f"{ep_ranks} EP ranks")
    dev = resolve_device(args.device)
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                       device=dev)

    predictor = None
    if strategy == "token_to_expert":
        trace = make_routing_trace(
            num_sequences=64, seq_len=args.seq, vocab=cfg.vocab_size,
            num_experts=cfg.moe.num_experts, num_layers=cfg.num_layers,
            skew=1.5, seed=args.seed)
        predictor = ConditionalProbabilityModel(
            cfg.num_layers, cfg.moe.num_experts, cfg.vocab_size
        ).fit(trace.experts, trace.tokens)

    tracer = None
    if args.trace_out:
        from repro_torch.obs import SpanTracer
        tracer = SpanTracer(process_name="repro-torch-launch-serve")
    engine = ServeEngine(cfg, model,
                         ServeConfig(strategy=strategy,
                                     dup_slots=args.dup_slots,
                                     max_len=args.seq + args.new_tokens),
                         ep_ranks=ep_ranks, ep=ep, predictor=predictor,
                         tracer=tracer)
    if ep:
        print(f"EP over {ep_ranks} ranks on one device "
              f"(replica store: {engine._store is not None})")

    sched = BatchScheduler(args.batch, args.seq)
    gen = token_batches(args.seed, cfg.vocab_size, 1, args.seq)
    for rid in range(args.requests):
        toks = next(gen)["tokens"][0]
        sched.submit(Request(rid, toks, max_new_tokens=args.new_tokens))

    t0 = time.perf_counter()
    batches = 0
    while sched.has_work():
        batch = sched.next_batch()
        out, tele = engine.generate({"tokens": batch["tokens"]},
                                    max_new_tokens=args.new_tokens)
        sched.finish(batch["requests"], out.cpu().numpy())
        batches += 1
        if cfg.is_moe and tele:
            print(f"batch {batches}: measured routing skew={tele['skew']:.2f}")
    dt = time.perf_counter() - t0
    done = len(sched.completed)
    print(f"served {done} requests in {batches} batches on {dev}, {dt:.1f}s "
          f"({done * args.new_tokens / dt:.1f} tok/s)")
    if tracer is not None:
        tracer.export(args.trace_out,
                      extra={"pred_accuracy": engine.accuracy.to_obj()
                             if engine.accuracy else []})
        print(f"trace written to {args.trace_out}")
    return 0 if done == args.requests else 1


if __name__ == "__main__":
    raise SystemExit(main())
