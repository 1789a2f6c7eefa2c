"""Chrome trace-event schema validation CLI (the gate for trace files the
port writes: ``--trace-out`` of the launchers, the engines' tracers).

  PYTHONPATH=src python -m repro_torch.obs.validate TRACE.json \
      [--require SPAN_NAME ...]

Prints ``PATH: OK (N events, M distinct names)`` for each loadable file.
Exits non-zero when a document fails the trace-event schema (it would not
load in Perfetto), is unreadable, or lacks a ``--require``d span or event
name; each failure goes to standard error. The arguments, lines and exit
codes are the JAX package's ``repro.obs.validate``."""

from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.trace import span_names, validate_chrome_trace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("paths", nargs="+", help="trace JSON files to validate")
    ap.add_argument("--require", action="append", default=[],
                    metavar="NAME",
                    help="fail unless an event with this name is present")
    args = ap.parse_args(argv)

    failed = False
    for path in args.paths:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"{path}: unreadable: {e}", file=sys.stderr)
            failed = True
            continue
        errors = validate_chrome_trace(doc)
        names = span_names(doc)
        missing = [n for n in args.require if n not in names]
        events = doc.get("traceEvents", []) if isinstance(doc, dict) else []
        if errors or missing:
            failed = True
            print(f"{path}: INVALID ({len(events)} events)", file=sys.stderr)
            for e in errors:
                print(f"  schema: {e}", file=sys.stderr)
            for n in missing:
                print(f"  missing required span/event: {n}", file=sys.stderr)
        else:
            print(f"{path}: OK ({len(events)} events, "
                  f"{len(names)} distinct names)")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
