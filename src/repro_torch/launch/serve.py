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
nonzero serve on a ``(data, model)`` mesh; for a MoE model that turns the
expert-parallel path on (``ServeEngine(ep=True)``), and each prompt of
``--seq`` tokens splits over the ``--model-mesh`` EP ranks.
``--backend`` says where the ranks run. ``stacked`` (the default): as a
leading tensor dimension in this one process, on one device, so
``--data-mesh`` must be 1. ``nccl`` or ``gloo``: the launcher starts
``data x model`` processes, one a mesh rank (``launch.mesh``), each
holding its EP rank's experts; the batch splits over the data ranks.
``nccl`` takes a card a rank; ``gloo`` runs on the CPU with ``--device
cpu`` or, on a card, stages its collectives through the host, every rank
on card 0:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
      --reduced --device cpu --data-mesh 2 --model-mesh 2 --backend gloo

Rank 0 prints; every rank draws the whole model's weights from
``--seed``, one leaf at a time, and keeps its block of each under
``--shard-params`` (``sharding``): ``none`` (the default) its block of the
experts, the rest whole; ``specs`` also the tensor-parallel blocks of the
attention, recurrent and vocab leaves (``sharding.param_specs``). A model
without MoE serves on a process mesh under either, its batch split over
the data ranks:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
      --reduced --device cpu --data-mesh 2 --model-mesh 2 --backend gloo \
      --shard-params specs

``fsdp`` (FSDP storage) also splits every weight of rank >= 2 over the
data ranks (a MoE model's replica store with its experts); each layer
gathers its shards at use:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \
      --reduced --device cpu --data-mesh 2 --model-mesh 2 --backend gloo \
      --shard-params fsdp

Expert-TP decode (the experts' F columns resident over the data ranks)
has no flag here, as in the JAX launcher: it is a ``Runtime`` of the
serving steps (``train.steps.make_prefill_step`` / ``make_decode_step``
under ``Runtime(decode_expert_tp=True)`` on a model laid out by
``bridge.sharder(cfg, mesh, "fsdp", expert_tp=True)``).

An encoder-decoder (seamless-m4t-medium) fails in the forward with
``KeyError``: the launcher sends tokens and no frames, as the JAX launcher
does, and the encoder needs them (``ServeEngine.generate`` with
``batch["frames"]`` serves it).

A model without MoE (the dense family, Griffin, RWKV) has no experts to
balance: its ``--strategy`` is "none" (the default there; the default for
a MoE model is "dist_only"), and another strategy raises, as do the mesh
flags without a process backend (the stacked backend stacks EP ranks).

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

from repro_torch.bridge import sharder
from repro_torch.launch import mesh as mesh_mod
from repro_torch.sharding import LAYOUTS

from repro_torch.configs.registry import get_config
from repro_torch.core.predictors import ConditionalProbabilityModel
from repro_torch.data.synthetic import make_routing_trace, token_batches
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_model
from repro_torch.serve import BatchScheduler, Request, ServeConfig, ServeEngine
from repro_torch.serve.engine import STRATEGIES


BACKENDS = ("stacked",) + mesh_mod.BACKENDS


def _parser() -> argparse.ArgumentParser:
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
                    help="EP ranks (the JAX launcher's mesh flags)")
    ap.add_argument("--backend", default="stacked", choices=BACKENDS,
                    help="stacked: the EP ranks as a tensor dimension in "
                         "this process (--data-mesh 1); nccl / gloo: one "
                         "process a mesh rank")
    ap.add_argument("--shard-params", default="none", choices=LAYOUTS,
                    help="the parameters' layout on a process mesh: none "
                         "(the experts' blocks), specs (tensor-parallel "
                         "blocks too), fsdp (and every weight's data "
                         "shard, gathered at use)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the kernels' "
                         "plain versions)")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome trace-event JSON of the run "
                         "(open in Perfetto / chrome://tracing)")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not cfg.is_moe:
        if args.strategy not in (None, "none"):
            raise ValueError(f"--strategy {args.strategy}: {cfg.name} has no "
                             "experts to balance (--strategy none)")
        if (args.data_mesh or args.model_mesh) and args.backend == "stacked":
            raise ValueError(f"--data-mesh / --model-mesh: {cfg.name} has no "
                             "experts to place on stacked EP ranks (name "
                             "--backend gloo or nccl for a process mesh)")
    if args.shard_params != "none" and args.backend == "stacked":
        raise ValueError(f"--shard-params {args.shard_params} lays the "
                         "parameters out over a process mesh: name --backend "
                         "gloo or nccl")
    ep = bool(args.data_mesh and args.model_mesh) and cfg.is_moe
    if ep and args.seq % args.model_mesh:
        raise ValueError(f"--seq {args.seq} does not split over "
                         f"{args.model_mesh} EP ranks")
    if args.backend == "stacked":
        if ep and args.data_mesh != 1:
            raise ValueError(
                f"--data-mesh {args.data_mesh}: the stacked backend runs "
                "every EP rank in this process on one device, which has "
                "no data axis; a data axis needs --backend nccl or gloo "
                "(one process a mesh rank)")
        return serve(args, cfg)
    if not (args.data_mesh and args.model_mesh):
        raise ValueError(f"--backend {args.backend} runs a process mesh: "
                         "give --data-mesh and --model-mesh")
    device, threads = mesh_mod.rank_device(args.backend, args.device)
    return mesh_mod.spawn(_serve_rank, (vars(args),), data=args.data_mesh,
                          model=args.model_mesh, backend=args.backend,
                          device=device, threads=threads)[0]


def _serve_rank(mesh, argv: dict) -> int:
    args = argparse.Namespace(**argv)
    cfg = get_config(args.arch)
    return serve(args, cfg.reduced() if args.reduced else cfg, mesh=mesh)


def serve(args, cfg, mesh=None) -> int:
    """Serve ``args.requests`` requests in batches; with ``mesh``, as its
    rank (rank 0 prints). Returns 0 when every request completes."""
    say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    strategy = args.strategy or ("dist_only" if cfg.is_moe else "none")
    ep = bool(args.data_mesh and args.model_mesh) and cfg.is_moe
    ep_ranks = args.model_mesh if ep else 1
    dev = resolve_device(args.device) if mesh is None else mesh.device
    layout = args.shard_params
    shard = None if mesh is None else sharder(cfg, mesh, layout)
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                       device=dev, shard=shard)

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
    if args.trace_out and (mesh is None or mesh.rank == 0):
        from repro_torch.obs import SpanTracer
        tracer = SpanTracer(process_name="repro-torch-launch-serve")
    engine = ServeEngine(cfg, model,
                         ServeConfig(strategy=strategy,
                                     dup_slots=args.dup_slots,
                                     max_len=args.seq + args.new_tokens),
                         ep_ranks=ep_ranks, ep=ep, predictor=predictor,
                         tracer=tracer, mesh=mesh)
    if ep and mesh is None:
        say(f"EP over {ep_ranks} ranks on one device "
            f"(replica store: {engine._store is not None})")
    elif ep:
        say(f"EP over a {mesh.key} mesh of processes ({mesh.backend}, "
            f"{mesh.device}; replica store: {engine._store is not None}; "
            f"parameters {layout!r})")
    elif mesh is not None:
        say(f"parameters {layout!r} over a {mesh.key} mesh of processes "
            f"({mesh.backend}, {mesh.device})")

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
            say(f"batch {batches}: measured routing skew={tele['skew']:.2f}")
    dt = time.perf_counter() - t0
    done = len(sched.completed)
    say(f"served {done} requests in {batches} batches on {dev}, {dt:.1f}s "
        f"({done * args.new_tokens / dt:.1f} tok/s)")
    if tracer is not None:
        tracer.export(args.trace_out,
                      extra={"pred_accuracy": engine.accuracy.to_obj()
                             if engine.accuracy else []})
        say(f"trace written to {args.trace_out}")
    return 0 if done == args.requests else 1


if __name__ == "__main__":
    raise SystemExit(main())
