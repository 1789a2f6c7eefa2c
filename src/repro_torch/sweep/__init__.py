"""Declarative (config x mesh x workload x strategy) sweep harness.

ReFrame-style regression tracking for the serving stack, the port's copy
of the JAX package's ``sweep``: a sweep spec expands into jobs
(``matrix``), each job runs a ``ContinuousEngine`` deployment on one
device in a subprocess (``job``/``runner``) or is emitted as a k8s Job
manifest for cluster runs (``k8s``), per-job metrics land in a trend
database (``history``, ``collect``) and gate against per-metric reference
bands (``references``), rendered as a markdown trend table (``report``).
The workloads are ``repro_torch.workloads.build_workload``.

  PYTHONPATH=src python -m repro_torch.sweep run --smoke --mesh 1x4
  PYTHONPATH=src python -m repro_torch.sweep report --history FILE
  PYTHONPATH=src python -m repro_torch.sweep manifests --out-dir k8s/
"""

from repro_torch.sweep.history import (append_entry, bench_history_entry,
                                       load_history, series,
                                       sweep_history_entry, trend)
from repro_torch.sweep.k8s import (job_manifest, manifest_name,
                                   validate_manifest)
from repro_torch.sweep.matrix import (FULL_SPEC, SMOKE_SPEC, MeshShape,
                                      SweepPoint, SweepSpec, parse_mesh)
from repro_torch.sweep.references import (check_metric, gate_document,
                                          refresh_references)
from repro_torch.sweep.report import render_report, trend_table

__all__ = [
    "FULL_SPEC", "MeshShape", "SMOKE_SPEC", "SweepPoint", "SweepSpec",
    "append_entry", "bench_history_entry", "check_metric", "gate_document",
    "job_manifest", "load_history", "manifest_name", "parse_mesh",
    "refresh_references", "render_report", "series", "sweep_history_entry",
    "trend", "trend_table", "validate_manifest",
]
