"""k8s Job manifest emission for cluster-tier sweeps.

Each sweep point becomes one ``batch/v1`` Job running
``repro_torch.sweep.job`` inside the provided image — the
ReFrame-k8s-launcher shape: the local runner and the cluster run share the
exact per-point entrypoint and JSON result contract, so a collector can
feed cluster results into the same trend database.

The port's copy of the JAX package's ``sweep/k8s.py``: the same names,
labels and schema check. The container runs the port's job on one card
(``--device cuda``, ``nvidia.com/gpu: 1`` in its limits: the EP ranks of
a point live on that card) and needs no ``XLA_FLAGS``.

Manifests are written as YAML when PyYAML is importable and as JSON
otherwise (kubectl accepts both); nothing here imports kubernetes, and
nothing applies them.
"""

from __future__ import annotations

import json
import os
import re
from typing import List, Sequence

from repro_torch.sweep.matrix import SweepPoint

try:                                      # optional, never required
    import yaml as _yaml
except ImportError:                       # pragma: no cover - env specific
    _yaml = None

_DNS1123 = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")


def manifest_name(point: SweepPoint, prefix: str = "sweep") -> str:
    """DNS-1123 label for the Job: lowercase alphanumerics and '-',
    <= 63 chars, deterministic per point."""
    raw = f"{prefix}-{point.key}"
    name = re.sub(r"[^a-z0-9]+", "-", raw.lower()).strip("-")
    return name[:63].rstrip("-")


def job_manifest(point: SweepPoint, *, image: str,
                 namespace: str = "default", smoke: bool = True,
                 cpu: str = "4", memory: str = "8Gi",
                 backoff_limit: int = 0) -> dict:
    args = ["--point", json.dumps(point.to_obj())]
    if smoke:
        args.append("--smoke")
    args += ["--device", "cuda"]
    return {
        "apiVersion": "batch/v1",
        "kind": "Job",
        "metadata": {
            "name": manifest_name(point),
            "namespace": namespace,
            "labels": {
                "app": "repro-sweep",
                "sweep-mesh": point.mesh.key,
                "sweep-workload": point.workload,
                "sweep-strategy": point.strategy,
            },
        },
        "spec": {
            "backoffLimit": backoff_limit,
            "template": {
                "metadata": {"labels": {"app": "repro-sweep"}},
                "spec": {
                    "restartPolicy": "Never",
                    "containers": [{
                        "name": "sweep-job",
                        "image": image,
                        "command": ["python", "-m", "repro_torch.sweep.job"],
                        "args": args,
                        "env": [{"name": "PYTHONPATH", "value": "/app/src"}],
                        "resources": {
                            "requests": {"cpu": cpu, "memory": memory},
                            "limits": {"cpu": cpu, "memory": memory,
                                       "nvidia.com/gpu": "1"},
                        },
                    }],
                },
            },
        },
    }


def validate_manifest(manifest: dict) -> List[str]:
    """Schema sanity for a Job manifest (what the tests gate): required
    fields, DNS-1123 name, container command/image presence."""
    errors = []
    if manifest.get("apiVersion") != "batch/v1":
        errors.append(f"apiVersion must be batch/v1, "
                      f"got {manifest.get('apiVersion')!r}")
    if manifest.get("kind") != "Job":
        errors.append(f"kind must be Job, got {manifest.get('kind')!r}")
    name = (manifest.get("metadata") or {}).get("name", "")
    if not name or len(name) > 63 or not _DNS1123.match(name):
        errors.append(f"metadata.name {name!r} is not a DNS-1123 label")
    tmpl = ((manifest.get("spec") or {}).get("template") or {})
    pod = tmpl.get("spec") or {}
    if pod.get("restartPolicy") not in ("Never", "OnFailure"):
        errors.append("Job pods need restartPolicy Never/OnFailure, got "
                      f"{pod.get('restartPolicy')!r}")
    containers = pod.get("containers") or []
    if not containers:
        errors.append("spec.template.spec.containers is empty")
    for i, c in enumerate(containers):
        for field in ("name", "image", "command"):
            if not c.get(field):
                errors.append(f"containers[{i}].{field} missing")
    return errors


def write_manifests(points: Sequence[SweepPoint], out_dir: str, *,
                    image: str, namespace: str = "default",
                    smoke: bool = True) -> List[str]:
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for point in points:
        m = job_manifest(point, image=image, namespace=namespace,
                         smoke=smoke)
        errors = validate_manifest(m)
        if errors:
            raise ValueError(f"generated invalid manifest for "
                             f"{point.key}: {errors}")
        name = m["metadata"]["name"]
        if _yaml is not None:
            path = os.path.join(out_dir, f"{name}.yaml")
            with open(path, "w") as f:
                _yaml.safe_dump(m, f, sort_keys=False)
        else:
            path = os.path.join(out_dir, f"{name}.json")
            with open(path, "w") as f:
                json.dump(m, f, indent=2)
        paths.append(path)
    return paths
