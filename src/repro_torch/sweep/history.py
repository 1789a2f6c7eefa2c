"""Trend database: an append-only JSONL of measurements, read back as
per-(bench, metric, config-key) series (the port's copy of the JAX
package's ``sweep/history.py``; the same lines, read the same way).

Two line kinds share one history file:

  * ``kind: "bench"`` — one benchmark-harness document per commit
    (per-bench wall/ok plus every summary metric);
  * ``kind: "sweep"`` — one line per sweep job, filed under the job's
    config-key so the same metric tracks separately per (mesh x workload
    x strategy) point.

Legacy lines (pre-sweep, no ``kind`` field) are read as bench entries so
the existing trajectory keeps counting.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Tuple

SeriesKey = Tuple[str, str, str]          # (bench, metric, config_key)

# Relative first->last change over the trend window before a metric is
# flagged as drifting (only when the window moves monotonically — noise
# wobbles both ways, drift doesn't).
DRIFT_REL = 0.10
DRIFT_MIN_POINTS = 4


def append_entry(path: str, entry: dict) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(entry) + "\n")


def load_history(path: str) -> List[dict]:
    if not os.path.exists(path):
        return []
    entries = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                entries.append(json.loads(line))
            except json.JSONDecodeError:
                continue              # a torn write must not kill the gate
    return entries


def bench_history_entry(doc: dict) -> dict:
    """History line for a benchmark harness's schema-2 document."""
    meta = doc.get("meta", {})
    return {
        "kind": "bench",
        "git_sha": meta.get("git_sha", "unknown"),
        "timestamp_utc": meta.get("timestamp_utc", ""),
        "smoke": doc.get("smoke", False),
        "total_wall_s": doc.get("total_wall_s", 0.0),
        "benches": {
            name: {"wall_us": rec.get("wall_us", 0.0),
                   "ok": bool(rec.get("ok")),
                   "summary": rec.get("summary") or {}}
            for name, rec in doc.get("benches", {}).items()},
    }


def sweep_history_entry(job_doc: dict, meta: dict) -> dict:
    """History line for one sweep job document (``sweep.job``)."""
    return {
        "kind": "sweep",
        "git_sha": meta.get("git_sha", "unknown"),
        "timestamp_utc": meta.get("timestamp_utc", ""),
        "smoke": bool(job_doc.get("config", {}).get("smoke")),
        "key": job_doc["key"],
        "ok": bool(job_doc.get("ok")),
        "wall_s": job_doc.get("wall_s", 0.0),
        "metrics": job_doc.get("metrics", {}),
    }


def _numeric(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def series(entries: Iterable[dict]) -> Dict[SeriesKey, List[Tuple[str, float]]]:
    """(bench, metric, config_key) -> [(timestamp, value)] in file order."""
    out: Dict[SeriesKey, List[Tuple[str, float]]] = {}

    def add(key: SeriesKey, ts: str, value) -> None:
        if _numeric(value):
            out.setdefault(key, []).append((ts, float(value)))
        elif isinstance(value, bool):
            out.setdefault(key, []).append((ts, 1.0 if value else 0.0))

    for e in entries:
        ts = e.get("timestamp_utc", "")
        kind = e.get("kind", "bench")
        if kind == "sweep":
            cfg = e.get("key", "unknown")
            add(("sweep", "wall_s", cfg), ts, e.get("wall_s"))
            add(("sweep", "ok", cfg), ts, e.get("ok"))
            for m, v in (e.get("metrics") or {}).items():
                add(("sweep", m, cfg), ts, v)
        else:
            add(("run", "total_wall_s", "default"), ts, e.get("total_wall_s"))
            for name, rec in (e.get("benches") or {}).items():
                add((name, "wall_us", "default"), ts, rec.get("wall_us"))
                add((name, "ok", "default"), ts, rec.get("ok"))
                for m, v in (rec.get("summary") or {}).items():
                    add((name, m, "default"), ts, v)
    return out


def trend(values: List[float], last_n: int = 8) -> dict:
    """Summary of the last ``last_n`` points of one series, with a drift
    flag: monotonic AND moved more than DRIFT_REL relative overall."""
    window = [v for v in values[-last_n:]]
    n = len(window)
    if n == 0:
        return {"n": 0, "first": float("nan"), "last": float("nan"),
                "mean": float("nan"), "rel_change": 0.0, "drifting": False}
    first, last = window[0], window[-1]
    denom = abs(first) if first else 1.0
    rel = (last - first) / denom
    diffs = [b - a for a, b in zip(window, window[1:])]
    monotonic = n >= DRIFT_MIN_POINTS and (
        all(d >= 0 for d in diffs) or all(d <= 0 for d in diffs))
    return {
        "n": n,
        "first": first,
        "last": last,
        "mean": sum(window) / n,
        "rel_change": rel,
        "drifting": bool(monotonic and abs(rel) > DRIFT_REL),
    }
