"""Trace-driven serving workloads.

Arrival processes (Poisson / bursty MMPP / diurnal), topic-shifting token
corpora (so expert skew MOVES over a serving session, the condition the
online GPS controller exists for), multi-tenant trace assembly, and the
named builders of ``catalog`` (``build_workload``). The port's copy of the
JAX package's ``workloads`` and ``sweep/workloads.py`` (numpy only): one
seed gives the same trace in both.
"""
from repro_torch.workloads.arrivals import (bursty_arrivals, diurnal_arrivals,
                                      poisson_arrivals)
from repro_torch.workloads.corpus import ShiftingCorpus, Topic
from repro_torch.workloads.traces import (TenantSpec, TraceRequest, make_trace,
                                    skew_shift_trace, to_serve_requests)
from repro_torch.workloads.catalog import WORKLOADS, build_workload

__all__ = [
    "ShiftingCorpus", "TenantSpec", "Topic", "TraceRequest", "WORKLOADS",
    "build_workload", "bursty_arrivals", "diurnal_arrivals", "make_trace",
    "poisson_arrivals", "skew_shift_trace", "to_serve_requests",
]
