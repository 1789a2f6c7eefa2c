"""Per-tenant admission: SLO classes and tenant -> model routing (the
port's copy of the JAX package's ``fleet/admission.py``).

The multi-tenant traces in ``workloads.traces`` stamp every request with a
tenant name; the fleet maps each tenant to one resident model instance
and one SLO class. The admission table is also where the arbiter reads
its primary signal: per-tenant SLO attainment, judged against the
TENANT's class (not the engine's default), from the per-model
``ServeMetrics`` completion timings.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.serve.metrics import ServeMetrics


@dataclass(frozen=True)
class SLOClass:
    """A named latency contract: TTFT / TPOT ceilings in (virtual)
    seconds. ``inf`` disables a bound."""
    name: str
    slo_ttft: float = float("inf")
    slo_tpot: float = float("inf")


#: Two conventional classes: latency-sensitive chat traffic vs
#: throughput-oriented batch jobs that only bound per-token pace.
INTERACTIVE = SLOClass("interactive", slo_ttft=2.0, slo_tpot=0.25)
BATCH = SLOClass("batch", slo_tpot=1.0)


class FleetAdmission:
    """Routes requests to models and scores tenants against their SLOs.

    ``routes``: tenant name -> model name. ``slos``: tenant name ->
    SLOClass (missing tenants get ``default_slo``). Unknown tenants go to
    ``default_model`` when set, otherwise submission raises — a fleet
    serving paying tenants should not silently absorb unknown traffic.
    """

    def __init__(self, routes: Dict[str, str],
                 slos: Optional[Dict[str, SLOClass]] = None,
                 default_model: str = "",
                 default_slo: SLOClass = BATCH):
        self.routes = dict(routes)
        self.slos = dict(slos or {})
        self.default_model = default_model
        self.default_slo = default_slo

    def route(self, tenant: str) -> str:
        model = self.routes.get(tenant, self.default_model)
        if not model:
            raise KeyError(f"no model routed for tenant {tenant!r} and no "
                           "default_model configured")
        return model

    def slo_for(self, tenant: str) -> SLOClass:
        return self.slos.get(tenant, self.default_slo)

    def tenants_for(self, model: str) -> List[str]:
        return [t for t, m in self.routes.items() if m == model]

    # ----------------------------------------------------------- attainment
    def tenant_attainment(self, metrics: ServeMetrics, tenant: str) -> float:
        slo = self.slo_for(tenant)
        return metrics.slo_attainment(tenant=tenant, slo_ttft=slo.slo_ttft,
                                      slo_tpot=slo.slo_tpot)

    def model_attainment(self, metrics: ServeMetrics, model: str) -> float:
        """Worst tenant attainment on this model (1.0 with no routed
        tenants / no completions): the arbiter protects the worst-off
        tenant, not the average."""
        tenants = self.tenants_for(model)
        if not tenants:
            return 1.0
        return min(self.tenant_attainment(metrics, t) for t in tenants)

    def strictest_slo(self, model: str) -> SLOClass:
        """Tightest per-bound contract across a model's tenants — what
        the engine-level ```ServeMetrics``` goodput should judge against."""
        tenants = self.tenants_for(model)
        if not tenants:
            return self.default_slo
        classes = [self.slo_for(t) for t in tenants]
        return SLOClass(name=f"{model}-strictest",
                        slo_ttft=min(c.slo_ttft for c in classes),
                        slo_tpot=min(c.slo_tpot for c in classes))
