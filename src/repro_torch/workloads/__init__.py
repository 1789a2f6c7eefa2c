"""Trace-driven serving workloads.

Arrival processes (Poisson / bursty MMPP / diurnal), topic-shifting token
corpora (so expert skew MOVES over a serving session, the condition the
online GPS controller exists for), and multi-tenant trace assembly. The
port's copy of the JAX package's ``workloads`` (numpy only): one seed gives
the same trace in both.
"""
from repro_torch.workloads.arrivals import (bursty_arrivals, diurnal_arrivals,
                                      poisson_arrivals)
from repro_torch.workloads.corpus import ShiftingCorpus, Topic
from repro_torch.workloads.traces import (TenantSpec, TraceRequest, make_trace,
                                    skew_shift_trace, to_serve_requests)

__all__ = [
    "ShiftingCorpus", "TenantSpec", "Topic", "TraceRequest",
    "bursty_arrivals", "diurnal_arrivals", "make_trace", "poisson_arrivals",
    "skew_shift_trace", "to_serve_requests",
]
