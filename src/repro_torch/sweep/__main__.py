"""Sweep CLI (the port's copy of the JAX package's ``python -m
repro.sweep``).

  PYTHONPATH=src python -m repro_torch.sweep run --smoke \
      [--mesh 1x4 --mesh 2x4] [--workload steady ...] [--strategy ...] \
      [--device cuda] [--out SWEEP_report.json] [--history FILE] \
      [--trace-dir sweep-traces] [--merged-trace SWEEP_trace.json]

  PYTHONPATH=src python -m repro_torch.sweep report --history FILE \
      [--references FILE] [--last 8] [--out FILE]

  PYTHONPATH=src python -m repro_torch.sweep manifests --out-dir k8s/ \
      [--image IMAGE] [--namespace NS] [--smoke]

  PYTHONPATH=src python -m repro_torch.sweep collect --dir RESULTS_DIR \
      --history FILE [--pattern '*.json']

``run`` needs a card unless given ``--device cpu``. ``--backend`` says
where each point's mesh runs (``sweep.job``): ``stacked`` (the default)
in one process on one device, which has no data axis, so points of a mesh
``DxM`` with D > 1 come back ``ok: false`` (and ``run`` exits 1; restrict
such a sweep with ``--mesh 1x4``); ``nccl`` (a card a rank) or ``gloo``
(the CPU, or card 0 shared) in ``D x M`` processes.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.sweep.matrix import FULL_SPEC, SMOKE_SPEC, parse_mesh


def _spec_from_args(args):
    spec = SMOKE_SPEC if args.smoke else FULL_SPEC
    return spec.restrict(
        meshes=[parse_mesh(m) for m in args.mesh] if args.mesh else None,
        workloads=args.workload or None,
        strategies=args.strategy or None,
        archs=args.arch or None)


def _add_axis_filters(ap):
    ap.add_argument("--mesh", action="append", default=[],
                    help="restrict to mesh shape(s), e.g. --mesh 1x4 "
                         "(the CI matrix-leg knob; repeatable)")
    ap.add_argument("--workload", action="append", default=[])
    ap.add_argument("--strategy", action="append", default=[])
    ap.add_argument("--arch", action="append", default=[])


def cmd_run(args) -> int:
    from repro_torch.sweep.runner import run_sweep, summarize
    points = _spec_from_args(args).expand()
    if not points:
        print("sweep matrix is empty", file=sys.stderr)
        return 2
    report = run_sweep(points, smoke=args.smoke, out_path=args.out,
                       history_path=args.history, trace_dir=args.trace_dir,
                       merged_trace_path=args.merged_trace,
                       max_iters=args.max_iters, device=args.device,
                       backend=args.backend)
    print(summarize(report))
    return 1 if report["failed"] else 0


def cmd_report(args) -> int:
    from repro_torch.sweep.report import render_report
    md = render_report(args.history, args.references, last_n=args.last,
                       title=args.title)
    if args.out:
        with open(args.out, "w") as f:
            f.write(md + "\n")
        print(f"wrote {args.out}")
    else:
        print(md)
    return 0


def cmd_manifests(args) -> int:
    from repro_torch.sweep.k8s import write_manifests
    spec = _spec_from_args(args)
    points = spec.expand()
    paths = write_manifests(points, args.out_dir, image=args.image,
                            namespace=args.namespace, smoke=args.smoke)
    print(f"wrote {len(paths)} Job manifests to {args.out_dir}")
    for p in paths:
        print(f"  {p}")
    return 0


def cmd_collect(args) -> int:
    from repro_torch.sweep.collect import collect_results
    from repro_torch.sweep.runner import sweep_meta
    report = collect_results(args.dir, args.history, meta=sweep_meta(),
                             pattern=args.pattern)
    print(report.summarize())
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.sweep",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    run_p = sub.add_parser("run", help="execute the sweep locally")
    run_p.add_argument("--smoke", action="store_true",
                       help="smoke tier (SMOKE_SPEC; default is FULL_SPEC)")
    _add_axis_filters(run_p)
    run_p.add_argument("--device", default="cuda",
                       help="torch device of every job (default cuda, "
                            "which needs a card; cpu runs the kernels' "
                            "plain versions)")
    run_p.add_argument("--backend", default="stacked",
                       choices=("stacked", "nccl", "gloo"),
                       help="stacked: a point's EP ranks in one process "
                            "(no data axis); nccl / gloo: one process a "
                            "mesh rank")
    run_p.add_argument("--out", default="SWEEP_report.json")
    run_p.add_argument("--history", default="",
                       help="append one line per job to this JSONL trend db")
    run_p.add_argument("--trace-dir", default="",
                       help="write one Perfetto trace per job here")
    run_p.add_argument("--merged-trace", default="",
                       help="write the merged Perfetto trace here")
    run_p.add_argument("--max-iters", type=int, default=0)
    run_p.set_defaults(fn=cmd_run)

    rep_p = sub.add_parser("report", help="render the markdown trend table")
    rep_p.add_argument("--history", required=True,
                       help="the JSONL trend db to render")
    rep_p.add_argument("--references", default="",
                       help="a references document whose bands to show")
    rep_p.add_argument("--last", type=int, default=8)
    rep_p.add_argument("--title", default="Perf trend")
    rep_p.add_argument("--out", default="")
    rep_p.set_defaults(fn=cmd_report)

    man_p = sub.add_parser("manifests", help="emit k8s Job manifests")
    man_p.add_argument("--out-dir", required=True)
    man_p.add_argument("--image", default="repro-sweep:latest")
    man_p.add_argument("--namespace", default="default")
    man_p.add_argument("--smoke", action="store_true")
    _add_axis_filters(man_p)
    man_p.set_defaults(fn=cmd_manifests)

    col_p = sub.add_parser(
        "collect", help="ingest per-point cluster result docs into history")
    col_p.add_argument("--dir", required=True,
                       help="directory of completed sweep.job JSON docs")
    col_p.add_argument("--history", required=True,
                       help="the JSONL trend db to append to")
    col_p.add_argument("--pattern", default="*.json")
    col_p.set_defaults(fn=cmd_collect)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
