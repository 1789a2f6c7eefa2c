"""Local sweep execution: one subprocess per point.

Each point runs ``python -m repro_torch.sweep.job --device D`` in its own
process, so one point's device memory is gone before the next starts and a
crash fails only its point. The subprocess imports the same ``repro_torch``
as the caller (``PYTHONPATH`` is its ``src/``), so it loads the kernels the
caller's checkout built. Results are collected into one sweep report
document, the per-job Perfetto traces into one merged trace, and one
history line per job is appended to the trend database. The port's copy of
the JAX package's ``sweep/runner.py``.
"""

from __future__ import annotations

import json
import os
import platform
import subprocess
import sys
import time
from datetime import datetime, timezone
from typing import Sequence

from repro_torch.sweep.history import append_entry, sweep_history_entry
from repro_torch.sweep.matrix import SweepPoint

JOB_TIMEOUT_S = 1800


def sweep_meta() -> dict:
    try:
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            timeout=10).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        sha = "unknown"
    return {"git_sha": sha,
            "timestamp_utc": datetime.now(timezone.utc).isoformat(
                timespec="seconds"),
            "python": platform.python_version()}


def _src_root() -> str:
    import repro_torch
    return os.path.dirname(os.path.abspath(list(repro_torch.__path__)[0]))


def run_job(point: SweepPoint, *, smoke: bool, trace_out: str = "",
            max_iters: int = 0, device: str = "cuda",
            verbose: bool = True) -> dict:
    """One point in a subprocess; never raises — failures come back as an
    ``ok: false`` job document so one broken point doesn't kill the sweep."""
    cmd = [sys.executable, "-m", "repro_torch.sweep.job",
           "--point", json.dumps(point.to_obj()), "--device", device]
    if smoke:
        cmd.append("--smoke")
    if trace_out:
        cmd += ["--trace-out", trace_out]
    if max_iters:
        cmd += ["--max-iters", str(max_iters)]
    env = dict(
        os.environ,
        PYTHONPATH=_src_root() + (
            os.pathsep + os.environ["PYTHONPATH"]
            if os.environ.get("PYTHONPATH") else ""))
    t0 = time.perf_counter()
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=JOB_TIMEOUT_S, env=env)
        stdout_lines = out.stdout.strip().splitlines()
        doc = json.loads(stdout_lines[-1]) if stdout_lines else {}
        if not isinstance(doc, dict) or doc.get("kind") != "sweep-job":
            raise ValueError(
                f"job printed no result document (exit {out.returncode}): "
                f"{out.stderr.strip().splitlines()[-3:]}")
    except Exception as e:          # noqa: BLE001 - sweep must keep going
        doc = {"schema": 1, "kind": "sweep-job", "key": point.key,
               "config": {**point.to_obj(), "smoke": smoke,
                          "device": device},
               "ok": False, "wall_s": time.perf_counter() - t0,
               "metrics": {}, "error": f"{type(e).__name__}: {e}"}
    if verbose:
        m = doc.get("metrics", {})
        status = "ok" if doc.get("ok") else \
            f"FAILED ({doc.get('error', 'job reported not ok')})"
        print(f"  {point.key}: {status}  wall={doc.get('wall_s', 0):.1f}s "
              f"p50={m.get('step_p50_ms', float('nan')):.0f}ms "
              f"completed={m.get('completed', 0):.0f}"
              f"/{m.get('submitted', 0):.0f}")
        sys.stdout.flush()
    return doc


def run_sweep(points: Sequence[SweepPoint], *, smoke: bool = True,
              out_path: str = "", history_path: str = "",
              trace_dir: str = "", merged_trace_path: str = "",
              max_iters: int = 0, device: str = "cuda",
              verbose: bool = True) -> dict:
    meta = sweep_meta()
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
    if verbose:
        print(f"sweep: {len(points)} points "
              f"({'smoke' if smoke else 'full'} tier, device {device})")
    jobs, trace_docs, trace_names = {}, [], []
    t0 = time.perf_counter()
    for point in points:
        trace_out = os.path.join(
            trace_dir, f"trace_{point.key.replace('/', '_')}.json") \
            if trace_dir else ""
        doc = run_job(point, smoke=smoke, trace_out=trace_out,
                      max_iters=max_iters, device=device, verbose=verbose)
        jobs[point.key] = doc
        if history_path:
            append_entry(history_path, sweep_history_entry(doc, meta))
        if trace_out and os.path.exists(trace_out):
            with open(trace_out) as f:
                trace_docs.append(json.load(f))
            trace_names.append(f"sweep:{point.key}")
    report = {
        "schema": 1,
        "kind": "sweep",
        "smoke": smoke,
        "meta": meta,
        "total_wall_s": time.perf_counter() - t0,
        "points": len(points),
        "failed": sum(1 for d in jobs.values() if not d.get("ok")),
        "jobs": jobs,
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(report, f, indent=2)
        if verbose:
            print(f"wrote {out_path}")
    if merged_trace_path and trace_docs:
        from repro_torch.obs import merge_traces
        merged = merge_traces(trace_docs, names=trace_names)
        merged.setdefault("otherData", {})["sweep_meta"] = meta
        with open(merged_trace_path, "w") as f:
            json.dump(merged, f)
        if verbose:
            print(f"wrote {merged_trace_path} "
                  f"({len(merged['traceEvents'])} events)")
    if history_path and verbose:
        print(f"appended {len(jobs)} history entries to {history_path}")
    return report


def summarize(report: dict) -> str:
    """One-paragraph text summary (the CLI's exit message)."""
    jobs = report.get("jobs", {})
    ok = sum(1 for d in jobs.values() if d.get("ok"))
    lines = [f"sweep: {ok}/{len(jobs)} points ok in "
             f"{report.get('total_wall_s', 0.0):.1f}s"]
    for key, doc in sorted(jobs.items()):
        m = doc.get("metrics", {})
        mark = "ok " if doc.get("ok") else "ERR"
        lines.append(
            f"  [{mark}] {key}: p50={m.get('step_p50_ms', float('nan')):.0f}"
            f"ms tok/s={m.get('throughput_tok_s', float('nan')):.1f}")
    return "\n".join(lines)
