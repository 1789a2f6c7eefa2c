"""Metrics registry: counters, gauges, and histograms with label sets.

``ServeMetrics.summary()`` publishes every serving metric through a
registry instead of a hand-rolled dict, so one store feeds three sinks:

  * the flat ``{name: value}`` summary dict the benchmarks embed in
    their ``--json`` schema (unchanged keys — ``snapshot()``);
  * a Prometheus text-format exposition (``to_prometheus``) scrapeable
    from a file or a trivial HTTP handler;
  * JSONL (``to_jsonl``) for the trend database the regression harness
    appends to (``benchmarks/history.jsonl``).

Families are registered idempotently (asking for an existing name with
the same type returns the same family; a type conflict raises), so
``summary()`` can be called repeatedly without duplicating series.
"""

from __future__ import annotations

import json
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                    0.5, 1.0, 2.5, 5.0, 10.0)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> LabelKey:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _render_labels(key: LabelKey, extra: Sequence[Tuple[str, str]] = ()
                   ) -> str:
    items = list(key) + list(extra)
    if not items:
        return ""
    body = ",".join(f'{k}="{v}"' for k, v in items)
    return "{" + body + "}"


class Counter:
    """Monotonic counter child (one label set)."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        self.value += float(amount)


class Gauge:
    """Set-to-current-value child."""
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        self.value += float(amount)


class Histogram:
    """Cumulative-bucket histogram child (Prometheus semantics)."""
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: Sequence[float]):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)    # +1: +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        self.sum += v
        self.count += 1
        for i, edge in enumerate(self.buckets):
            if v <= edge:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def cumulative(self) -> List[int]:
        out, acc = [], 0
        for c in self.counts:
            acc += c
            out.append(acc)
        return out

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile estimate (upper edge of the bucket
        holding the q-th observation)."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        for i, cum in enumerate(self.cumulative()):
            if cum >= target:
                return (self.buckets[i] if i < len(self.buckets)
                        else math.inf)
        return math.inf


class _Family:
    def __init__(self, name: str, kind: str, help: str, buckets=None):
        self.name = name
        self.kind = kind
        self.help = help
        self.buckets = buckets
        self.children: Dict[LabelKey, object] = {}

    def labels(self, **labels: str):
        key = _label_key(labels)
        child = self.children.get(key)
        if child is None:
            child = {"counter": Counter, "gauge": Gauge}.get(self.kind,
                     lambda: Histogram(self.buckets))()
            self.children[key] = child
        return child


class MetricsRegistry:
    """Registry of metric families; thread-safe registration."""

    def __init__(self):
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _register(self, name: str, kind: str, help: str,
                  buckets=None) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind:
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind}")
                return fam
            fam = _Family(name, kind, help, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._register(name, "counter", help).labels(**labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._register(name, "gauge", help).labels(**labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = _DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._register(name, "histogram", help,
                              buckets=tuple(buckets)).labels(**labels)

    # --------------------------------------------------------------- export
    def snapshot(self) -> Dict[str, float]:
        """Flat ``{name{labels}: value}`` view (histograms expose
        ``_sum``/``_count``). This is what ``ServeMetrics.summary()``
        returns to its callers."""
        out: Dict[str, float] = {}
        for fam in self._families.values():
            for key, child in fam.children.items():
                suffix = _render_labels(key)
                if isinstance(child, Histogram):
                    out[f"{fam.name}_sum{suffix}"] = child.sum
                    out[f"{fam.name}_count{suffix}"] = float(child.count)
                else:
                    out[f"{fam.name}{suffix}"] = child.value
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (v0.0.4)."""
        lines: List[str] = []
        for fam in sorted(self._families.values(), key=lambda f: f.name):
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in sorted(fam.children.items()):
                if isinstance(child, Histogram):
                    cum = child.cumulative()
                    edges = [str(b) for b in child.buckets] + ["+Inf"]
                    for edge, c in zip(edges, cum):
                        lab = _render_labels(key, [("le", edge)])
                        lines.append(f"{fam.name}_bucket{lab} {c}")
                    lines.append(
                        f"{fam.name}_sum{_render_labels(key)} {child.sum}")
                    lines.append(
                        f"{fam.name}_count{_render_labels(key)} {child.count}")
                else:
                    lines.append(
                        f"{fam.name}{_render_labels(key)} {child.value}")
        return "\n".join(lines) + "\n"

    def to_jsonl(self, path: str, extra: Optional[dict] = None,
                 mode: str = "a") -> None:
        """Append one JSON line per metric family (trend-database form)."""
        with open(path, mode) as f:
            for fam in sorted(self._families.values(), key=lambda f_: f_.name):
                for key, child in sorted(fam.children.items()):
                    rec = {"metric": fam.name, "type": fam.kind,
                           "labels": dict(key)}
                    if isinstance(child, Histogram):
                        rec.update(sum=child.sum, count=child.count,
                                   buckets=list(child.buckets),
                                   bucket_counts=list(child.counts))
                    else:
                        rec["value"] = child.value
                    if extra:
                        rec.update(extra)
                    f.write(json.dumps(rec) + "\n")
