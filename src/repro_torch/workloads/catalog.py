"""Named workload builders (the port's copy of the JAX package's
``sweep/workloads.py``; numpy only, so one seed gives the same trace in
both packages).

Each entry maps a workload name to a request trace with a distinct skew
dynamic: steady flat routing, a shifting hot topic, diurnal load,
multi-tenant mixtures with opposed skew, a decode-heavy tail, and the
fleet A/B's ramping chat tenant beside a flat batch tenant.
"""

from __future__ import annotations

from typing import List

from repro_torch.workloads.corpus import ShiftingCorpus, Topic
from repro_torch.workloads.traces import (TenantSpec, TraceRequest,
                                          make_trace, skew_shift_trace)


def _steady(vocab: int, horizon: float, rate: float,
            seed: int) -> List[TraceRequest]:
    """Poisson arrivals over a flat corpus: skew stays low, the baseline
    regime where duplication should mostly stay off."""
    flat = Topic("broad", zipf_alpha=0.4, vocab_frac=1.0, seed=1)
    corpus = ShiftingCorpus(vocab, [flat], schedule=[(0.0, [1.0])])
    spec = TenantSpec("steady", corpus, arrivals="poisson", rate=rate,
                      prompt_len_mean=24.0, prompt_len_max=64,
                      out_len_mean=6.0, out_len_max=16)
    return make_trace([spec], horizon, seed=seed)


def _skew_shift(vocab: int, horizon: float, rate: float,
                seed: int) -> List[TraceRequest]:
    return skew_shift_trace(vocab, horizon=horizon, rate=rate, seed=seed)


def _diurnal(vocab: int, horizon: float, rate: float,
             seed: int) -> List[TraceRequest]:
    return skew_shift_trace(vocab, horizon=horizon, rate=rate, seed=seed,
                            arrivals="diurnal")


def _multi_tenant(vocab: int, horizon: float, rate: float,
                  seed: int) -> List[TraceRequest]:
    """Two tenants whose hot topics peak at opposite ends of the session,
    so aggregate skew never settles."""
    broad = Topic("broad", zipf_alpha=0.5, vocab_frac=1.0, seed=1)
    hot_a = Topic("hot-a", zipf_alpha=3.0, vocab_frac=0.05, seed=2)
    hot_b = Topic("hot-b", zipf_alpha=3.0, vocab_frac=0.05, seed=3)
    corpus_a = ShiftingCorpus(vocab, [broad, hot_a], schedule=[
        (0.0, [0.2, 0.8]), (0.5 * horizon, [0.9, 0.1]),
        (horizon, [1.0, 0.0])])
    corpus_b = ShiftingCorpus(vocab, [broad, hot_b], schedule=[
        (0.0, [1.0, 0.0]), (0.5 * horizon, [0.9, 0.1]),
        (horizon, [0.2, 0.8])])
    tenants = [
        TenantSpec("tenant-a", corpus_a, arrivals="bursty", rate=rate / 2,
                   prompt_len_mean=24.0, prompt_len_max=64,
                   out_len_mean=6.0, out_len_max=16),
        TenantSpec("tenant-b", corpus_b, arrivals="poisson", rate=rate / 2,
                   prompt_len_mean=24.0, prompt_len_max=64,
                   out_len_mean=6.0, out_len_max=16),
    ]
    return make_trace(tenants, horizon, seed=seed)


def _decode_heavy(vocab: int, horizon: float, rate: float,
                  seed: int) -> List[TraceRequest]:
    """Decode-bound regime: sparse arrivals with short prompts and long
    generation budgets, so after a brief prefill warmup the engine sits in
    a steady decode tail — the state the fused paged-attention kernel (and
    the KindWindowEMA's decode window) is sized for. Output budgets stay
    within the smoke sweep engine's max_len=48 / max_iters bounds (prompt
    <= 16 + out <= 24, sparse arrivals so late tails drain in budget)
    while output tokens still dominate ~2-3x."""
    flat = Topic("broad", zipf_alpha=0.6, vocab_frac=1.0, seed=1)
    corpus = ShiftingCorpus(vocab, [flat], schedule=[(0.0, [1.0])])
    spec = TenantSpec("decode-heavy", corpus, arrivals="poisson",
                      rate=rate / 3, prompt_len_mean=8.0, prompt_len_max=16,
                      out_len_mean=12.0, out_len_max=24)
    return make_trace([spec], horizon, seed=seed)


def _fleet_shift(vocab: int, horizon: float, rate: float,
                 seed: int) -> List[TraceRequest]:
    """The fleet A/B trace: an interactive chat tenant whose load ramps
    up monotonically through the session (diurnal thinning with period
    4x horizon: rate -> 2x rate) while its corpus concentrates on a hot
    topic, against a steady flat batch tenant. Under a static equal HBM
    split the chat model starves as the shift lands; the cross-model
    arbiter should move KV/dup-slot quota toward it."""
    broad = Topic("broad", zipf_alpha=0.5, vocab_frac=1.0, seed=1)
    hot = Topic("hot", zipf_alpha=3.0, vocab_frac=0.05, seed=2)
    corpus_chat = ShiftingCorpus(vocab, [broad, hot], schedule=[
        (0.0, [1.0, 0.0]), (0.4 * horizon, [0.3, 0.7]),
        (horizon, [0.2, 0.8])])
    corpus_batch = ShiftingCorpus(vocab, [broad], schedule=[(0.0, [1.0])])
    tenants = [
        TenantSpec("chat", corpus_chat, arrivals="diurnal", rate=rate,
                   diurnal_amplitude=1.0, diurnal_period=4.0 * horizon,
                   prompt_len_mean=24.0, prompt_len_max=64,
                   out_len_mean=6.0, out_len_max=16),
        TenantSpec("batch", corpus_batch, arrivals="poisson", rate=rate / 2,
                   prompt_len_mean=24.0, prompt_len_max=64,
                   out_len_mean=8.0, out_len_max=16),
    ]
    return make_trace(tenants, horizon, seed=seed)


WORKLOADS = {
    "steady": _steady,
    "skew_shift": _skew_shift,
    "diurnal": _diurnal,
    "multi_tenant": _multi_tenant,
    "decode_heavy": _decode_heavy,
    "fleet_shift": _fleet_shift,
}


def build_workload(name: str, vocab: int, *, horizon: float, rate: float,
                   seed: int = 0) -> List[TraceRequest]:
    try:
        builder = WORKLOADS[name]
    except KeyError:
        raise ValueError(
            f"unknown workload {name!r} (have {sorted(WORKLOADS)})")
    return builder(vocab, horizon, rate, seed)
