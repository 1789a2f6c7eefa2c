"""One sweep point, run in-process: build the engine on the requested
device, replay the workload trace, print a single JSON result line.

The port's copy of the JAX package's ``sweep/job.py``: the same engine
shape, trace tiers, virtual clock and metric schema, on
``repro_torch.serve.ContinuousEngine``. ``--backend`` says where the
point's mesh runs: ``stacked`` (the default) keeps its EP ranks
(``mesh.model``) as a leading tensor dimension in this process on one
device, so it refuses a data axis (``mesh.data > 1``); ``nccl`` or
``gloo`` runs ``data x model`` processes, one a mesh rank
(``launch.mesh.spawn``; nccl a card a rank, gloo on the CPU or sharing
card 0), whose rank 0 writes the document. Invoked by the runner as a
subprocess:

  PYTHONPATH=src python -m repro_torch.sweep.job \
      --point '{"arch": "mixtral-8x7b", "mesh": "1x4", ...}' --smoke \
      [--device cuda] [--backend stacked]

``--device`` defaults to ``cuda`` and raises without a card; ``cpu`` runs
the kernels' plain versions. ``--layers N`` cuts the model to its first N
layers (the document's config records it). The last stdout line is the
job document the runner collects; everything else goes to stderr or
earlier lines.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.transformer import init_model
from repro_torch.sharding import expert_block
from repro_torch.sweep.matrix import SweepPoint

BACKENDS = ("stacked",) + mesh_mod.BACKENDS

# Engine shape for sweep deployments (static: the same engine serves
# every workload of a point, so cross-point step times compare).
SMOKE_ENGINE = dict(max_slots=4, prefill_len=32, block_size=16, max_len=48,
                    predict_interval=4, dup_slots=1, metrics_window=4)
FULL_ENGINE = dict(max_slots=8, prefill_len=64, block_size=16, max_len=96,
                   predict_interval=4, dup_slots=1, metrics_window=8)

# Virtual-clock trace horizon per tier (seconds) and replay compression.
SMOKE_TRACE = dict(horizon=10.0, rate=1.5, time_scale=20.0, max_iters=40)
FULL_TRACE = dict(horizon=45.0, rate=1.5, time_scale=20.0, max_iters=400)

# Summary columns copied into the job's metric set (flat scalars only —
# these are the per-(metric, config-key) trend series).
SUMMARY_METRICS = (
    "completed", "preemptions", "throughput_tok_s", "throughput_req_s",
    "ttft_p50", "ttft_p99", "tpot_mean", "tpot_p99", "latency_p50",
    "latency_p99", "migration_replans", "migration_bytes_moved",
    "migration_stall_us", "migration_rejected",
    "dropped_tokens", "overflow_tokens", "overflow_absorbed_frac",
    "resched_a2a_bytes", "resched_plans",
    # decode fast path: wall-clock decode throughput and the
    # fused-vs-gather attention-compute roofline (alloc/live KV blocks)
    "decode_toks_per_s", "fused_vs_gather_speedup",
)


def run_point(point: SweepPoint, *, smoke: bool = True, trace_out: str = "",
              max_iters: int = 0, time_scale: float = 0.0,
              device: str = "cuda", backend: str = "stacked",
              layers: int = 0) -> dict:
    """The point's job document; under a process ``backend`` rank 0's.
    ``layers``: 0 (the config's depth), or the point's model cut to its
    first ``layers`` layers (recorded in the document's config)."""
    kw = dict(smoke=smoke, trace_out=trace_out, max_iters=max_iters,
              time_scale=time_scale, layers=layers)
    if backend == "stacked":
        if point.mesh.data > 1:
            raise ValueError(
                f"point {point.key}: mesh {point.mesh.key} has a data axis "
                f"of {point.mesh.data}; the stacked backend runs every EP "
                "rank in one process on one device, which has no data "
                "axis: a data axis needs --backend nccl or gloo (one "
                "process a mesh rank)")
        return _run_point(point, device=resolve_device(device), **kw)
    if backend not in mesh_mod.BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    dev, threads = mesh_mod.rank_device(backend, device)
    return mesh_mod.spawn(_point_rank, (point.to_obj(), kw),
                          data=point.mesh.data, model=point.mesh.model,
                          backend=backend, device=dev, threads=threads)[0]


def _point_rank(mesh, point_obj: dict, kw: dict) -> dict:
    return _run_point(SweepPoint.from_obj(point_obj), device=mesh.device,
                      mesh=mesh, **kw)


def _run_point(point: SweepPoint, *, smoke: bool, trace_out: str,
               max_iters: int, time_scale: float, layers: int, device,
               mesh=None) -> dict:
    from repro_torch.configs.registry import get_config
    from repro_torch.obs import SpanTracer
    from repro_torch.serve import ContinuousConfig, ContinuousEngine
    from repro_torch.workloads import build_workload, to_serve_requests

    dev = device
    cfg = get_config(point.arch)
    if point.reduced:
        cfg = cfg.reduced()
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)

    # lever legs of the strategy axis: keep dist_only prediction, drive
    # the token-rescheduling lever (matrix.LEVER_STRATEGIES)
    strategy, lever = point.strategy, "duplicate"
    if strategy in ("reschedule", "both"):
        strategy, lever = "dist_only", point.strategy

    predictor = None
    if strategy == "token_to_expert":
        from repro_torch.core.predictors import ConditionalProbabilityModel
        from repro_torch.data.synthetic import make_routing_trace
        prof = make_routing_trace(
            num_sequences=32, seq_len=32, vocab=cfg.vocab_size,
            num_experts=cfg.moe.num_experts, num_layers=cfg.num_layers,
            skew=1.8, seed=point.seed)
        predictor = ConditionalProbabilityModel(
            cfg.num_layers, cfg.moe.num_experts, cfg.vocab_size
        ).fit(prof.experts, prof.tokens)

    shape = dict(SMOKE_ENGINE if smoke else FULL_ENGINE)
    replay = dict(SMOKE_TRACE if smoke else FULL_TRACE)
    if max_iters:
        replay["max_iters"] = max_iters
    if time_scale:
        replay["time_scale"] = time_scale

    rank0 = mesh is None or mesh.rank == 0
    tracer = SpanTracer(process_name=f"sweep:{point.key}") \
        if trace_out and rank0 else None
    ccfg = ContinuousConfig(strategy=strategy, lever=lever, **shape)
    # a mesh rank keeps its block of experts (every weight still drawn)
    shard = ({} if mesh is None else {"expert_block": expert_block(
        cfg.moe.num_experts, {"model": mesh.model_index}, mesh)})
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(
        point.seed), device=dev, **shard)
    eng = ContinuousEngine(cfg, model, ccfg, ep_ranks=point.mesh.model,
                           ep=point.mesh.model > 1, predictor=predictor,
                           tracer=tracer, mesh=mesh)
    eng.warmup()

    trace = build_workload(point.workload, cfg.vocab_size,
                           horizon=replay["horizon"], rate=replay["rate"],
                           seed=point.seed)
    for r in sorted(to_serve_requests(trace), key=lambda r: r.arrival):
        eng.submit(r)

    # run_trace's virtual clock, with per-step walls kept for percentiles;
    # step() returns once its tokens are on the host, so each wall holds
    # the step's device work
    walls = []
    now, iters = 0.0, 0
    t_job = time.perf_counter()
    while eng.has_work() and iters < replay["max_iters"]:
        sched = eng.scheduler
        if (not sched.active_slots and sched.waiting
                and sched.waiting[0].arrival > now):
            now = sched.waiting[0].arrival
        t0 = time.perf_counter()
        start = now
        eng.step(start, clock=lambda: start + (
            time.perf_counter() - t0) * replay["time_scale"])
        dt = eng.agree(time.perf_counter() - t0)
        walls.append(dt)
        now = start + dt * replay["time_scale"]
        iters += 1
    wall_s = time.perf_counter() - t_job

    eng.metrics.flush(eng._plan_stack, eng.ep_ranks, ccfg.dup_slots)
    s = eng.metrics.summary()

    metrics = {
        "step_p50_ms": float(np.percentile(walls, 50) * 1e3),
        "step_p99_ms": float(np.percentile(walls, 99) * 1e3),
        "steps": float(iters),
        "submitted": float(len(trace)),
        # eager PyTorch has nothing to recompile; the key stays for the
        # references' rules, which read it
        "recompiled": 0.0,
        "drained_ok": float(not eng.has_work()),
    }
    for k in SUMMARY_METRICS:
        if k in s:
            metrics[k] = float(s[k])

    if tracer is not None:
        tracer.export(trace_out, extra={"sweep_point": point.to_obj()})

    device_info = {"device": dev.type}
    if mesh is not None:
        device_info["backend"] = mesh.backend
    if dev.type == "cuda":
        device_info["device_name"] = torch.cuda.get_device_name(dev)
    return {
        "schema": 1,
        "kind": "sweep-job",
        "key": point.key,
        "config": {**point.to_obj(), "smoke": smoke, **replay,
                   "engine": shape, **device_info,
                   **({"layers": layers} if layers else {})},
        "ok": bool(metrics["drained_ok"]),
        "wall_s": wall_s,
        "metrics": metrics,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--point", required=True,
                    help="JSON SweepPoint (see matrix.SweepPoint.to_obj)")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--trace-out", default="")
    ap.add_argument("--max-iters", type=int, default=0)
    ap.add_argument("--time-scale", type=float, default=0.0)
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the model to its first N layers (0: all)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda, which needs a card; "
                         "cpu runs the kernels' plain versions)")
    ap.add_argument("--backend", default="stacked", choices=BACKENDS,
                    help="stacked: the EP ranks in this process (no data "
                         "axis); nccl / gloo: one process a mesh rank")
    args = ap.parse_args(argv)
    point = SweepPoint.from_obj(json.loads(args.point))
    doc = run_point(point, smoke=args.smoke, trace_out=args.trace_out,
                    max_iters=args.max_iters, time_scale=args.time_scale,
                    device=args.device, backend=args.backend,
                    layers=args.layers)
    sys.stdout.flush()
    print(json.dumps(doc))
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
