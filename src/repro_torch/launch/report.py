"""The dry run's rows (``launch.dryrun``'s JSON files) as the roofline
table: the port of the JAX package's ``launch/report.py``. The last
column is the seconds the trace took (the reference's compile time).

  python -m repro_torch.launch.report [--dir experiments/dryrun]
                                      [--mesh 16x16]
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x >= 0.1:
        return f"{x:.2f}s"
    if x >= 1e-4:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.1f}us"


def fmt_b(x: float) -> str:
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x/div:.1f}{unit}"
    return f"{x:.0f}B"


def load_rows(dir_: str, tag: str = ""):
    """Every row in ``dir_``; with ``tag``, those whose file name ends in
    ``_{tag}``."""
    rows = []
    for path in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        base = os.path.basename(path)[:-5]
        if tag and not base.endswith("_" + tag):
            continue
        with open(path) as f:
            rows.append(json.load(f))
    return rows


SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def table(rows, mesh: str) -> str:
    """The markdown table of the ``ok`` rows of ``mesh``."""
    rows = [r for r in rows if r.get("mesh") == mesh and r.get("status") == "ok"]
    rows.sort(key=lambda r: (r["arch"], SHAPE_ORDER.index(r["shape"])
                             if r["shape"] in SHAPE_ORDER else 9))
    out = ["| arch | shape | compute | memory | collective | dominant | "
           "MODEL/analytic useful | peak bytes/dev | trace |",
           "|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        out.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(r['compute_s'])} "
            f"| {fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} "
            f"| **{r['dominant']}** | {r['useful_flops_ratio']:.2f} "
            f"| {fmt_b(r.get('temp_bytes', 0) + r.get('argument_bytes', 0))} "
            f"| {r.get('trace_s', 0):.1f}s |")
    return "\n".join(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args(argv)
    print(table(load_rows(args.dir), args.mesh))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
