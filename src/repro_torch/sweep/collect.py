"""Cluster result collector: per-point job docs -> the trend database.

The k8s leg of the sweep runs every point as its own Job; each pod
writes (or uploads) one ``sweep.job`` result document. This module
closes the loop: point it at a directory of those per-point JSON docs
and it appends one ``kind: "sweep"`` line per NEW result to the history
file it is given, through the `history` API (the port's copy of the JAX
package's ``sweep/collect.py``).

Robustness rules, in the same spirit as `history.load_history`:

  * a torn / truncated / non-JSON file is SKIPPED, never fatal — a pod
    killed mid-write must not poison the gate;
  * a doc that is not a ``kind: "sweep-job"`` dict with a ``key`` is
    skipped (the directory may hold reports, traces, partial uploads);
  * duplicates are skipped: a (key, git_sha) pair already present in
    the history file — or seen earlier in the same batch — is not
    appended twice, so re-running the collector over a bucket that
    still holds old results is idempotent.
"""

from __future__ import annotations

import glob
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.sweep.history import (append_entry, load_history,
                                 sweep_history_entry)


@dataclass
class CollectReport:
    """What one collector pass did, file by file."""
    appended: List[str] = field(default_factory=list)   # files ingested
    duplicates: List[str] = field(default_factory=list)
    torn: List[str] = field(default_factory=list)       # unparseable JSON
    skipped: List[str] = field(default_factory=list)    # not a job doc

    @property
    def total(self) -> int:
        return (len(self.appended) + len(self.duplicates)
                + len(self.torn) + len(self.skipped))

    def summarize(self) -> str:
        return (f"collected {len(self.appended)}/{self.total} docs "
                f"({len(self.duplicates)} duplicate, {len(self.torn)} torn, "
                f"{len(self.skipped)} non-job)")


def _load_doc(path: str) -> Optional[dict]:
    try:
        with open(path) as f:
            return json.loads(f.read())
    except (OSError, json.JSONDecodeError):
        return None


def _is_job_doc(doc) -> bool:
    return (isinstance(doc, dict) and doc.get("kind") == "sweep-job"
            and isinstance(doc.get("key"), str) and doc.get("key"))


def collect_results(results_dir: str, history_path: str,
                    meta: Optional[dict] = None,
                    pattern: str = "*.json") -> CollectReport:
    """Ingest every job doc under ``results_dir`` into ``history_path``.

    ``meta`` supplies ``git_sha`` / ``timestamp_utc`` for docs that do
    not carry their own ``meta`` block (the per-job default); pass
    `runner.sweep_meta()` for a live stamp. Returns a `CollectReport`
    — nothing raises for bad individual files.
    """
    meta = meta or {}
    seen = {(e.get("key"), e.get("git_sha"))
            for e in load_history(history_path) if e.get("kind") == "sweep"}
    report = CollectReport()
    for path in sorted(glob.glob(os.path.join(results_dir, pattern))):
        doc = _load_doc(path)
        if doc is None:
            report.torn.append(path)
            continue
        if not _is_job_doc(doc):
            report.skipped.append(path)
            continue
        doc_meta = {**meta, **doc.get("meta", {})}
        entry = sweep_history_entry(doc, doc_meta)
        dedup = (entry["key"], entry["git_sha"])
        if dedup in seen:
            report.duplicates.append(path)
            continue
        append_entry(history_path, entry)
        seen.add(dedup)
        report.appended.append(path)
    return report
