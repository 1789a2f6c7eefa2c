"""One sweep point, run in-process: build the engine on the requested
device, replay the workload trace, print a single JSON result line.

The port's copy of the JAX package's ``sweep/job.py``: the same engine
shape, trace tiers, virtual clock and metric schema, on
``repro_torch.serve.ContinuousEngine``. The point's EP ranks
(``mesh.model``) are a leading tensor dimension on one device, so the job
needs no device count set before start; a data axis (``mesh.data > 1``)
needs several cards and is refused. Invoked by the runner as a subprocess:

  PYTHONPATH=src python -m repro_torch.sweep.job \
      --point '{"arch": "mixtral-8x7b", "mesh": "1x4", ...}' --smoke \
      [--device cuda]

``--device`` defaults to ``cuda`` and raises without a card; ``cpu`` runs
the kernels' plain versions. The last stdout line is the job document the
runner collects; everything else goes to stderr or earlier lines.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_model
from repro_torch.sweep.matrix import SweepPoint

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
              device: str = "cuda") -> dict:
    from repro_torch.configs.registry import get_config
    from repro_torch.obs import SpanTracer
    from repro_torch.serve import ContinuousConfig, ContinuousEngine
    from repro_torch.workloads import build_workload, to_serve_requests

    if point.mesh.data > 1:
        raise ValueError(
            f"point {point.key}: mesh {point.mesh.key} has a data axis of "
            f"{point.mesh.data}, and one device has no data axis (serving "
            "across cards waits for a torch.distributed backend: "
            "ROADMAP.md section 1, item 4)")
    dev = resolve_device(device)
    cfg = get_config(point.arch)
    if point.reduced:
        cfg = cfg.reduced()

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

    tracer = SpanTracer(process_name=f"sweep:{point.key}") \
        if trace_out else None
    ccfg = ContinuousConfig(strategy=strategy, lever=lever, **shape)
    model = init_model(cfg, torch.Generator(device=dev).manual_seed(
        point.seed), device=dev)
    eng = ContinuousEngine(cfg, model, ccfg, ep_ranks=point.mesh.model,
                           ep=point.mesh.model > 1, predictor=predictor,
                           tracer=tracer)
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
        dt = time.perf_counter() - t0
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

    device_info = {"device": str(dev)}
    if dev.type == "cuda":
        device_info["device_name"] = torch.cuda.get_device_name(dev)
    return {
        "schema": 1,
        "kind": "sweep-job",
        "key": point.key,
        "config": {**point.to_obj(), "smoke": smoke, **replay,
                   "engine": shape, **device_info},
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
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda, which needs a card; "
                         "cpu runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    point = SweepPoint.from_obj(json.loads(args.point))
    doc = run_point(point, smoke=args.smoke, trace_out=args.trace_out,
                    max_iters=args.max_iters, time_scale=args.time_scale,
                    device=args.device)
    sys.stdout.flush()
    print(json.dumps(doc))
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
