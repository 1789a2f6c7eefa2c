"""Trace assembly: arrival process x length distributions x corpus, per
tenant, merged into one replayable request trace."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.workloads.arrivals import (bursty_arrivals, diurnal_arrivals,
                                      poisson_arrivals)
from repro_torch.workloads.corpus import ShiftingCorpus, Topic


@dataclass
class TraceRequest:
    rid: int
    arrival: float
    tokens: np.ndarray            # (S,) prompt
    max_new_tokens: int
    tenant: str = ""


@dataclass
class TenantSpec:
    """One tenant's traffic model."""
    name: str
    corpus: ShiftingCorpus
    arrivals: str = "poisson"               # poisson | bursty | diurnal
    rate: float = 1.0                       # base requests/s
    burst_rate: float = 0.0                 # bursty: high-phase rate
    diurnal_amplitude: float = 0.8
    diurnal_period: float = 60.0
    prompt_len_mean: float = 32.0           # lognormal body
    prompt_len_sigma: float = 0.4
    prompt_len_max: int = 64
    out_len_mean: float = 8.0
    out_len_sigma: float = 0.5
    out_len_max: int = 32

    def arrival_times(self, horizon: float,
                      rng: np.random.Generator) -> np.ndarray:
        if self.arrivals == "poisson":
            return poisson_arrivals(self.rate, horizon, rng)
        if self.arrivals == "bursty":
            high = self.burst_rate or 4.0 * self.rate
            return bursty_arrivals(self.rate, high, horizon, rng)
        if self.arrivals == "diurnal":
            return diurnal_arrivals(self.rate, self.diurnal_amplitude,
                                    self.diurnal_period, horizon, rng)
        raise ValueError(self.arrivals)

    def _lognormal_len(self, mean: float, sigma: float, lo: int, hi: int,
                       rng: np.random.Generator) -> int:
        mu = np.log(max(mean, 1.0)) - sigma ** 2 / 2
        return int(np.clip(round(rng.lognormal(mu, sigma)), lo, hi))

    def sample_lengths(self, rng: np.random.Generator) -> Tuple[int, int]:
        p = self._lognormal_len(self.prompt_len_mean, self.prompt_len_sigma,
                                1, self.prompt_len_max, rng)
        o = self._lognormal_len(self.out_len_mean, self.out_len_sigma,
                                1, self.out_len_max, rng)
        return p, o


def make_trace(tenants: Sequence[TenantSpec], horizon: float,
               seed: int = 0) -> List[TraceRequest]:
    """Merge every tenant's arrivals into one rid-ordered trace."""
    rng = np.random.default_rng(seed)
    events: List[Tuple[float, TenantSpec]] = []
    for spec in tenants:
        for t in spec.arrival_times(horizon, rng):
            events.append((float(t), spec))
    events.sort(key=lambda e: e[0])
    trace = []
    for rid, (t, spec) in enumerate(events):
        plen, olen = spec.sample_lengths(rng)
        trace.append(TraceRequest(
            rid=rid, arrival=t,
            tokens=spec.corpus.sample_prompt(t, plen, rng),
            max_new_tokens=olen, tenant=spec.name))
    return trace


def skew_shift_trace(vocab: int, horizon: float = 90.0, rate: float = 1.5,
                     seed: int = 0, *, arrivals: str = "bursty",
                     prompt_len_max: int = 64, out_len_max: int = 16,
                     ) -> List[TraceRequest]:
    """The benchmark's canonical single-tenant trace: bursty arrivals over
    a corpus whose mixture walks flat -> concentrated -> flat, so measured
    expert skew rises then falls across the session and the online GPS
    controller has something real to react to."""
    flat = Topic("broad", zipf_alpha=0.4, vocab_frac=1.0, seed=1)
    hot = Topic("trending", zipf_alpha=3.0, vocab_frac=0.05, seed=2)
    corpus = ShiftingCorpus(vocab, [flat, hot], schedule=[
        (0.0, [1.0, 0.0]),
        (0.35 * horizon, [0.9, 0.1]),
        (0.5 * horizon, [0.05, 0.95]),
        (0.75 * horizon, [0.1, 0.9]),
        (horizon, [1.0, 0.0]),
    ])
    spec = TenantSpec("main", corpus, arrivals=arrivals, rate=rate,
                      prompt_len_mean=24.0, prompt_len_max=prompt_len_max,
                      out_len_mean=6.0, out_len_max=out_len_max)
    return make_trace([spec], horizon, seed=seed)


def to_serve_requests(trace: Sequence[TraceRequest]):
    """TraceRequest -> repro_torch.serve.ServeRequest (import-cycle-free)."""
    from repro_torch.serve.scheduler import ServeRequest
    return [ServeRequest(rid=r.rid, tokens=r.tokens,
                         max_new_tokens=r.max_new_tokens,
                         arrival=r.arrival, tenant=r.tenant)
            for r in trace]
