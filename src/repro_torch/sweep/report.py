"""Markdown trend rendering for the history database (the table CI
appends to the GitHub Actions job summary); the port's copy of the JAX
package's ``sweep/report.py``."""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from repro_torch.sweep.history import (SeriesKey, load_history, series, trend)
from repro_torch.sweep.references import bounds

_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values: List[float], width: int = 12) -> str:
    if not values:
        return ""
    vals = values[-width:]
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return _SPARK[0] * len(vals)
    return "".join(
        _SPARK[int((v - lo) / (hi - lo) * (len(_SPARK) - 1))] for v in vals)


def _fmt(v: float) -> str:
    if v != v:
        return "-"
    if abs(v) >= 1e6:
        return f"{v:.3g}"
    if abs(v) >= 100:
        return f"{v:.0f}"
    return f"{v:.3g}"


def _ref_cell(refs: Optional[dict], key: SeriesKey) -> str:
    if not refs:
        return ""
    bench, metric, _ = key
    if bench == "run" and metric == "total_wall_s":
        tup = refs.get("total_wall_s")
    else:
        tup = (refs.get("benches") or {}).get(bench, {}).get(metric)
    if not tup:
        return "-"
    lo, hi = bounds(float(tup[0]), tup[1], tup[2])
    lo_s = "-inf" if lo is None else _fmt(lo)
    hi_s = "inf" if hi is None else _fmt(hi)
    return f"[{lo_s}, {hi_s}]"


def trend_table(series_map: Dict[SeriesKey, List[Tuple[str, float]]],
                *, last_n: int = 8, refs: Optional[dict] = None,
                benches: Optional[List[str]] = None) -> str:
    """One markdown row per (bench, metric, config-key) series."""
    header = "| bench | metric | config | n | latest | mean | Δ | trend |"
    sep = "|---|---|---|---|---|---|---|---|"
    if refs is not None:
        header = header[:-1] + " ref band |"
        sep += "---|"
    rows = [header, sep]
    for key in sorted(series_map):
        bench, metric, cfg = key
        if benches is not None and bench not in benches:
            continue
        values = [v for _, v in series_map[key]]
        t = trend(values, last_n)
        delta = f"{100 * t['rel_change']:+.0f}%"
        if t["drifting"]:
            delta += " ⚠"
        row = (f"| {bench} | {metric} | {cfg} | {t['n']} "
               f"| {_fmt(t['last'])} | {_fmt(t['mean'])} | {delta} "
               f"| {sparkline(values)} |")
        if refs is not None:
            row += f" {_ref_cell(refs, key)} |"
        rows.append(row)
    return "\n".join(rows)


def drift_warnings(series_map: Dict[SeriesKey, List[Tuple[str, float]]],
                   *, last_n: int = 8) -> List[str]:
    out = []
    for (bench, metric, cfg), points in sorted(series_map.items()):
        t = trend([v for _, v in points], last_n)
        if t["drifting"]:
            out.append(
                f"{bench}.{metric} [{cfg}] drifted "
                f"{100 * t['rel_change']:+.0f}% monotonically over the "
                f"last {t['n']} entries ({_fmt(t['first'])} -> "
                f"{_fmt(t['last'])})")
    return out


def render_report(history_path: str, references_path: str = "",
                  *, last_n: int = 8, title: str = "Perf trend") -> str:
    refs = None
    if references_path and os.path.exists(references_path):
        with open(references_path) as f:
            refs = json.load(f)
    entries = load_history(history_path)
    smap = series(entries)
    lines = [f"## {title}",
             f"_{len(entries)} history entries, {len(smap)} series "
             f"(window: last {last_n})_", ""]
    if not smap:
        lines.append("_history is empty — run a sweep with "
                     "`python -m repro_torch.sweep run --history FILE` "
                     "first_")
        return "\n".join(lines)
    lines.append(trend_table(smap, last_n=last_n, refs=refs))
    warns = drift_warnings(smap, last_n=last_n)
    if warns:
        lines += ["", "### Drift warnings", ""]
        lines += [f"- ⚠ {w}" for w in warns]
    return "\n".join(lines)
