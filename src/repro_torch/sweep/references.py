"""ReFrame-style per-metric performance references.

The port's copy of the JAX package's ``sweep/references.py``. A
references document declares, per bench, ``{metric: [ref, lower_tol,
upper_tol]}``: the expected value plus relative tolerances on each side
(``null`` = that side unbounded) — the same convention as ReFrame's
``reference = {metric: (value, lower, upper)}`` performance tuples.
``gate_document`` checks a fresh schema-2 benchmark document against
every declared band; ``refresh_references`` rewrites the document
from a fresh measurement using per-metric-class default tolerances.

For a reference value of 0 the tolerances are absolute deviations
(a relative band around zero is always empty).
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

# (pattern, (lower_tol, upper_tol)) — first match wins; metrics matching
# no rule are NOT given a reference on refresh (trend-tracked only), so
# noisy columns don't flap the gate. None = that side unbounded.
TOLERANCE_RULES: Tuple[Tuple[str, Tuple[Optional[float],
                                        Optional[float]]], ...] = (
    # correctness flags must not move at all
    (r"^ok$", (0.0, 0.0)),
    (r"(_ok$|^recompiled$|_recompiled$|bitexact)", (0.0, 0.0)),
    # quality ratios: bounded below (regression), unbounded above
    (r"speedup", (0.5, None)),
    (r"hidden_fraction", (0.5, None)),
    # dist-predictor accuracy is judged over however many windows the
    # controller happened to spend in dist_only — a 3-11 window sample
    # whose count is wall-clock sensitive, so the rate swings ~2x run to
    # run at the same sha. Band it loosely: only a collapse toward zero
    # (the predictor stops landing at all) should gate.
    (r"^pred_dist_hit_rate$", (0.8, None)),
    (r"hit_rate", (0.5, None)),
    (r"^throughput_", (0.8, None)),
    # fleet A/B: SLO attainment on both legs is bounded below (the
    # static leg's under-attainment is the experiment's premise, so it
    # too must not collapse — a static leg that stops starving means
    # the A/B no longer demonstrates anything); the arbiter leg must
    # keep committing at least one quota move (ref 1, floor at 0.1
    # catches the lever silently disengaging). fleet_step_p50_ms rides
    # the generic step_p rule below; fleet_recompiled the recompile
    # rule above.
    (r"fleet_.*attainment", (0.5, None)),
    (r"^fleet_arbiter_moves$", (0.9, None)),
    # token rescheduling: the realized absorbed fraction (1 - drops /
    # capacity overflow) must stay >= 0.5x its reference; rescue-round
    # a2a traffic must not silently vanish (that would mean the lever
    # stopped engaging) but may grow with trace shape
    (r"overflow_absorbed_frac$", (0.5, None)),
    (r"resched_a2a_bytes$", (0.9, 3.0)),
    # the reschedule leg must stay dropless (ref 0 -> absolute band)
    (r"resched_dropped_tokens$", (0.0, 0.0)),
    # decode fast path: wall-clock decode throughput must not collapse
    # (bounded below like other throughput columns); the decode-shaped
    # attention phase timing is bounded above like step timings. The
    # fused-vs-gather roofline ratio is caught by the "speedup" rule
    # above; raw attn_fused_us/attn_gather_us walls and the interpret-
    # mode A/B ratio (decode_ab_ratio) deliberately match no rule —
    # interpret-mode kernel walls are not meaningful perf references.
    (r"^decode_toks_per_s$", (0.8, None)),
    (r"^attn_phase_decode_us$", (None, 1.5)),
    # timings: bounded above (CI machines are ~2x noisy, so the band is
    # wide; order-of-magnitude regressions are what it must catch)
    (r"^wall_us$", (None, 1.0)),
    (r"step_p(50|99)_ms$", (None, 1.5)),
)

TOTAL_WALL_TOL: Tuple[Optional[float], Optional[float]] = (None, 0.5)


def classify_metric(name: str) -> Optional[Tuple[Optional[float],
                                                 Optional[float]]]:
    for pattern, tols in TOLERANCE_RULES:
        if re.search(pattern, name):
            return tols
    return None


def bounds(ref: float, lower_tol: Optional[float],
           upper_tol: Optional[float]) -> Tuple[Optional[float],
                                                Optional[float]]:
    """Concrete (lo, hi) band; relative to |ref|, absolute when ref==0."""
    scale = abs(ref) if ref else 1.0
    lo = None if lower_tol is None else ref - scale * lower_tol
    hi = None if upper_tol is None else ref + scale * upper_tol
    return lo, hi


def check_metric(name: str, value, ref_tuple) -> Optional[str]:
    """None if ``value`` sits inside the reference band, else a failure
    message. A missing value (None) is itself a failure: a metric that
    silently disappears is a regression of the measurement, not a pass."""
    if (not isinstance(ref_tuple, (list, tuple)) or len(ref_tuple) != 3
            or not isinstance(ref_tuple[0], (int, float))
            or isinstance(ref_tuple[0], bool)):
        return f"{name}: malformed reference {ref_tuple!r}"
    ref, lower_tol, upper_tol = ref_tuple
    if value is None:
        return f"{name}: metric missing from the current document " \
               f"(reference {ref:g})"
    if not isinstance(value, (int, float)) or isinstance(value, bool):
        return f"{name}: non-numeric value {value!r}"
    lo, hi = bounds(float(ref), lower_tol, upper_tol)
    if lo is not None and value < lo:
        return (f"{name}: {value:g} below reference band "
                f"[{lo:g}, {'inf' if hi is None else f'{hi:g}'}] "
                f"(ref {ref:g}, -{lower_tol:g})")
    if hi is not None and value > hi:
        return (f"{name}: {value:g} above reference band "
                f"[{'-inf' if lo is None else f'{lo:g}'}, {hi:g}] "
                f"(ref {ref:g}, +{upper_tol:g})")
    return None


def structural_failures(doc: dict) -> List[str]:
    """A truncated/failed run must never slip through as a pass."""
    failures = []
    if not isinstance(doc, dict):
        return ["document is not a JSON object"]
    benches = doc.get("benches")
    if not isinstance(benches, dict) or not benches:
        failures.append("document has no benches (empty or missing "
                        "'benches' — truncated or failed run)")
    total = doc.get("total_wall_s")
    if not isinstance(total, (int, float)) or total <= 0:
        failures.append(f"document has no positive total_wall_s "
                        f"(got {total!r})")
    return failures


def _metric_value(rec: dict, metric: str):
    if metric == "ok":
        return 1.0 if rec.get("ok") else 0.0
    if metric == "wall_us":
        return rec.get("wall_us")
    return (rec.get("summary") or {}).get(metric)


def gate_document(doc: dict, refs: dict) -> Tuple[List[str], int]:
    """All reference-band violations of ``doc`` plus how many metric
    bands were checked (so an accidentally-empty references file is
    visible to the caller)."""
    failures = list(structural_failures(doc))
    checked = 0
    total_ref = refs.get("total_wall_s")
    if total_ref is not None:
        checked += 1
        msg = check_metric("total_wall_s", doc.get("total_wall_s"),
                           total_ref)
        if msg:
            failures.append(msg)
    benches = doc.get("benches") or {}
    for bench, metric_refs in (refs.get("benches") or {}).items():
        rec = benches.get(bench)
        if rec is None:
            failures.append(f"{bench}: bench disappeared from the suite "
                            f"({len(metric_refs)} referenced metrics)")
            checked += len(metric_refs)
            continue
        for metric, ref_tuple in metric_refs.items():
            checked += 1
            msg = check_metric(f"{bench}.{metric}",
                               _metric_value(rec, metric), ref_tuple)
            if msg:
                failures.append(msg)
    return failures, checked


def refresh_references(doc: dict, *, meta: Optional[dict] = None) -> dict:
    """Build a references document from a fresh measurement. Refuses
    structurally empty documents — refreshing from a truncated run would
    commit an empty gate."""
    empty = structural_failures(doc)
    if empty:
        raise ValueError("refusing to refresh references from a broken "
                         "document: " + "; ".join(empty))
    refs = {"schema": 1,
            "meta": dict(meta or doc.get("meta") or {}),
            "total_wall_s": [float(doc["total_wall_s"]), *TOTAL_WALL_TOL],
            "benches": {}}
    for bench, rec in doc["benches"].items():
        out = {"ok": [1.0 if rec.get("ok") else 0.0, 0.0, 0.0]}
        wall = rec.get("wall_us")
        if isinstance(wall, (int, float)):
            out["wall_us"] = [float(wall), *classify_metric("wall_us")]
        for metric, value in (rec.get("summary") or {}).items():
            tols = classify_metric(metric)
            if tols is None or metric in ("ok", "wall_us"):
                continue
            if isinstance(value, (int, float)) \
                    and not isinstance(value, bool):
                out[metric] = [float(value), tols[0], tols[1]]
        refs["benches"][bench] = out
    return refs
