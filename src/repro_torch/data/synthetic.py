"""Synthetic data with calibrated expert-routing skewness, and token
streams: the port's copy of the JAX package's ``data/synthetic.py``. numpy
only, with the same RNG calls in the same order, so one seed gives
bit-identical arrays in both packages.

* ``skewed_distribution``: an expert distribution with max/mean == skew
  (the hottest expert takes skew/E, a geometric tail the rest).
* ``make_routing_trace``: Zipf tokens and per-layer ground-truth experts,
  a ``predictability`` share of them a deterministic function of (token,
  layer), the rest drawn from a skewed base distribution that ``drift``
  tilts over the sequence index.
* ``token_batches``: Zipf LM batches for the launchers.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np


def skewed_distribution(num_experts: int, skew: float,
                        rng: np.random.Generator | None = None) -> np.ndarray:
    """Expert distribution p with max(p)/mean(p) == skew (1 <= skew <= E).

    The hottest expert takes skew/E; the tail decays geometrically (more
    realistic than uniform-tail) subject to the max constraint.
    """
    E = num_experts
    skew = float(np.clip(skew, 1.0, E))
    p_max = skew / E
    rest = 1.0 - p_max
    if E == 1:
        return np.ones((1,))
    # geometric tail: q_i = r^i, scaled to sum to `rest`, with q_0 <= p_max
    lo, hi = 1e-6, 1.0
    for _ in range(60):
        r = 0.5 * (lo + hi)
        q = r ** np.arange(E - 1, dtype=np.float64)
        q = q / q.sum() * rest
        if q[0] > p_max:
            lo = r
        else:
            hi = r
    p = np.concatenate([[p_max], q])
    if rng is not None:
        p[1:] = rng.permutation(p[1:])
    return p / p.sum()


def measured_skewness(counts: np.ndarray) -> float:
    p = counts / max(counts.sum(), 1e-12)
    return float(p.max() * p.shape[-1])


class RoutingTrace(NamedTuple):
    """A routing dataset: tokens + per-layer ground-truth expert labels."""
    tokens: np.ndarray        # (N, S) int32
    experts: np.ndarray       # (L, N, S) int32  top-1 expert per token per layer
    dist: np.ndarray          # (L, E) ground-truth marginal expert distribution
    skew: float
    predictability: float


def make_routing_trace(
    *,
    num_sequences: int,
    seq_len: int,
    vocab: int,
    num_experts: int,
    num_layers: int,
    skew: float = 1.4,
    predictability: float = 0.8,
    zipf_alpha: float = 1.2,
    drift: float = 0.0,
    seed: int = 0,
) -> RoutingTrace:
    """``drift``: the paper's core premise is that expert distributions
    CHANGE OVER TIME (hence *dynamic* duplication). drift > 0 applies a
    progressive exponent tilt base^(1 + drift * i/N) over sequence index i,
    so a train/test split sees a systematic distribution shift (what
    Table 1 measures on real datasets — skewed datasets drift more)."""
    rng = np.random.default_rng(seed)
    # Zipf token stream
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    pz = ranks ** (-zipf_alpha)
    pz /= pz.sum()
    tokens = rng.choice(vocab, size=(num_sequences, seq_len), p=pz).astype(np.int32)

    base = np.stack([skewed_distribution(num_experts, skew, rng)
                     for _ in range(num_layers)])
    # deterministic token->expert rule per layer, biased by the base dist so
    # the marginal stays skewed even for the predictable part
    rule = np.stack([rng.choice(num_experts, size=vocab, p=base[l])
                     for l in range(num_layers)]).astype(np.int32)

    experts = np.empty((num_layers, num_sequences, seq_len), np.int32)
    for l in range(num_layers):
        det = rule[l][tokens]                                   # (N, S)
        if drift > 0:
            rnd = np.empty_like(tokens)
            for i in range(num_sequences):
                p_i = base[l] ** (1.0 + drift * i / max(num_sequences - 1, 1))
                p_i = p_i / p_i.sum()
                rnd[i] = rng.choice(num_experts, size=(seq_len,), p=p_i)
        else:
            rnd = rng.choice(num_experts, size=tokens.shape,
                             p=base[l]).astype(np.int32)
        use_det = rng.random(tokens.shape) < predictability
        experts[l] = np.where(use_det, det, rnd.astype(np.int32))

    # empirical marginal
    dist = np.stack([
        np.bincount(experts[l].reshape(-1), minlength=num_experts).astype(np.float64)
        for l in range(num_layers)])
    dist /= dist.sum(axis=1, keepdims=True)
    return RoutingTrace(tokens=tokens, experts=experts, dist=dist,
                        skew=skew, predictability=predictability)


def token_batches(key_seed: int, vocab: int, batch: int, seq_len: int,
                  zipf_alpha: float = 1.2) -> Iterator[dict]:
    """Infinite LM batches: Zipf-distributed tokens (B, seq_len) and their
    next-token labels."""
    rng = np.random.default_rng(key_seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    pz = ranks ** (-zipf_alpha)
    pz /= pz.sum()
    while True:
        toks = rng.choice(vocab, size=(batch, seq_len + 1), p=pz).astype(np.int32)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
