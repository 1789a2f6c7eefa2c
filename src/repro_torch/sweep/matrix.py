"""Sweep specification and deterministic matrix expansion.

A ``SweepSpec`` names axes (model config x mesh shape x workload trace x
GPS strategy x seed); ``expand()`` takes the cartesian product in a fixed
axis order so the job list — and every job's ``key`` — is stable across
runs and machines. The key is the config-key under which the trend
database files the job's metrics, so determinism here is what makes
history comparable across commits. The port's copy of the JAX package's
``sweep/matrix.py``: the same specs expand to the same keys.
"""

from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class MeshShape:
    """(data, model) axis sizes; ``model`` carries expert parallelism."""
    data: int
    model: int

    @property
    def devices(self) -> int:
        return self.data * self.model

    @property
    def key(self) -> str:
        return f"{self.data}x{self.model}"


def parse_mesh(text: str) -> MeshShape:
    """'2x4' -> MeshShape(2, 4)."""
    try:
        data, model = (int(p) for p in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"mesh shape must look like '2x4', got {text!r}")
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be >= 1, got {text!r}")
    return MeshShape(data, model)


@dataclass(frozen=True)
class SweepPoint:
    """One fully-bound job of the matrix."""
    arch: str
    mesh: MeshShape
    workload: str
    strategy: str
    seed: int = 0
    reduced: bool = True

    @property
    def key(self) -> str:
        """Stable config-key: the trend-database series identifier."""
        return (f"{self.arch}@{self.mesh.key}/{self.workload}"
                f"/{self.strategy}/s{self.seed}")

    def to_obj(self) -> dict:
        d = dataclasses.asdict(self)
        d["mesh"] = self.mesh.key
        d["key"] = self.key
        return d

    @classmethod
    def from_obj(cls, obj: dict) -> "SweepPoint":
        return cls(arch=obj["arch"], mesh=parse_mesh(obj["mesh"]),
                   workload=obj["workload"], strategy=obj["strategy"],
                   seed=int(obj.get("seed", 0)),
                   reduced=bool(obj.get("reduced", True)))


@dataclass(frozen=True)
class SweepSpec:
    """Axes of the sweep; ``expand`` is their deterministic product."""
    archs: Tuple[str, ...] = ("mixtral-8x7b",)
    meshes: Tuple[MeshShape, ...] = (MeshShape(1, 4),)
    workloads: Tuple[str, ...] = ("skew_shift",)
    strategies: Tuple[str, ...] = ("dist_only",)
    seeds: Tuple[int, ...] = (0,)
    reduced: bool = True

    def expand(self) -> Tuple[SweepPoint, ...]:
        return tuple(
            SweepPoint(arch=a, mesh=m, workload=w, strategy=s, seed=seed,
                       reduced=self.reduced)
            for a, m, w, s, seed in itertools.product(
                self.archs, self.meshes, self.workloads, self.strategies,
                self.seeds))

    def restrict(self, *, meshes=None, workloads=None, strategies=None,
                 archs=None) -> "SweepSpec":
        """Filter axes (CI matrix legs pass ``--mesh`` to split the sweep
        across runners); unknown values raise so a typo'd leg fails fast."""
        def pick(have, want, label):
            if want is None:
                return have
            want = tuple(want)
            unknown = [w for w in want if w not in have]
            if unknown:
                raise ValueError(f"unknown {label}: {unknown} "
                                 f"(spec has {list(have)})")
            return want
        return dataclasses.replace(
            self,
            archs=pick(self.archs, archs, "arch"),
            meshes=pick(self.meshes, meshes, "mesh"),
            workloads=pick(self.workloads, workloads, "workload"),
            strategies=pick(self.strategies, strategies, "strategy"))


# Strategy axis values that are really balancing LEVERS: the job keeps
# the dist_only prediction mode and drives the token-rescheduling lever
# instead (repro_torch.schedule). Kept on the same axis so the trend database
# files duplicate-vs-reschedule runs as sibling series of one sweep.
LEVER_STRATEGIES = ("reschedule", "both")

# The CI smoke tier: 2 meshes x 3 workloads (the acceptance floor), one
# EP-only mesh and one data x EP mesh so the topology term in step time
# is exercised, against a steady trace, a skew-shifting trace, and the
# decode-heavy trace (long steady decode tail — the fused paged-
# attention fast path's regime, feeding the decode_toks_per_s trend
# series) — each point also run with the reschedule /
# duplicate+reschedule levers so the combined strategy space has trend
# series from day one.
SMOKE_SPEC = SweepSpec(
    archs=("mixtral-8x7b",),
    meshes=(MeshShape(1, 4), MeshShape(2, 4)),
    workloads=("steady", "skew_shift", "decode_heavy"),
    strategies=("dist_only",) + LEVER_STRATEGIES,
)

# The cluster tier (k8s manifests / nightly): wider meshes, every
# workload dynamic, both prediction strategies — the configuration
# regimes across which the paper says the optimal strategy flips — plus
# the combined-lever legs.
FULL_SPEC = SweepSpec(
    archs=("mixtral-8x7b",),
    meshes=(MeshShape(1, 4), MeshShape(2, 2), MeshShape(2, 4),
            MeshShape(2, 8)),
    workloads=("steady", "skew_shift", "diurnal", "multi_tenant",
               "decode_heavy", "fleet_shift"),
    strategies=("dist_only", "token_to_expert") + LEVER_STRATEGIES,
)
