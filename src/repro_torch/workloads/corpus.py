"""Topic-shifting token corpora.

The paper's premise is that expert load distributions are a property of
the *traffic*: different datasets route with different skew (MMLU 1.39 vs
SST2 1.99, Table 1), and live traffic drifts between regimes. We model
that with **topics**: each topic is a Zipf distribution over its own
permutation of the vocabulary with its own concentration. A concentrated
topic (high alpha) repeats few distinct tokens, which a token-identity
router maps to few experts — high skew; a flat topic spreads tokens — low
skew. A time-varying topic mixture therefore moves the *measured* routing
skew over a serving session, which is exactly the signal the online GPS
controller reacts to.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Topic:
    name: str
    zipf_alpha: float = 1.2        # token concentration (higher = fewer
                                   # distinct tokens = more routing skew)
    vocab_frac: float = 1.0        # fraction of the vocab this topic uses
    seed: int = 0                  # permutation seed (topic identity)


class ShiftingCorpus:
    """Samples prompts from a time-varying mixture of topics.

    ``schedule``: list of (t_start, weights) checkpoints; the mixture is
    linearly interpolated between consecutive checkpoints (weights are
    per-topic, re-normalised). A single checkpoint = stationary corpus.
    """

    def __init__(self, vocab: int, topics: Sequence[Topic],
                 schedule: Sequence[Tuple[float, Sequence[float]]]):
        if not topics:
            raise ValueError("need at least one topic")
        if not schedule:
            raise ValueError("need at least one schedule checkpoint")
        self.vocab = vocab
        self.topics = list(topics)
        self.schedule = sorted((float(t), np.asarray(w, np.float64))
                               for t, w in schedule)
        for _, w in self.schedule:
            if w.shape != (len(self.topics),):
                raise ValueError("schedule weights must match topics")
        self._dists = [self._topic_dist(t) for t in self.topics]

    def _topic_dist(self, topic: Topic) -> np.ndarray:
        rng = np.random.default_rng(topic.seed)
        n = max(int(self.vocab * topic.vocab_frac), 1)
        ranks = np.arange(1, n + 1, dtype=np.float64)
        p = ranks ** (-topic.zipf_alpha)
        p /= p.sum()
        dist = np.zeros((self.vocab,), np.float64)
        ids = rng.permutation(self.vocab)[:n]      # topic's own token subset
        dist[ids] = p
        return dist

    def mixture(self, t: float) -> np.ndarray:
        """Interpolated topic weights at time t (normalised)."""
        sched = self.schedule
        if t <= sched[0][0]:
            w = sched[0][1]
        elif t >= sched[-1][0]:
            w = sched[-1][1]
        else:
            for (t0, w0), (t1, w1) in zip(sched, sched[1:]):
                if t0 <= t <= t1:
                    a = (t - t0) / max(t1 - t0, 1e-12)
                    w = (1 - a) * w0 + a * w1
                    break
        w = np.maximum(w, 0.0)
        return w / max(w.sum(), 1e-12)

    def token_dist(self, t: float) -> np.ndarray:
        """Marginal token distribution at time t."""
        w = self.mixture(t)
        return sum(wi * d for wi, d in zip(w, self._dists))

    def sample_prompt(self, t: float, length: int,
                      rng: np.random.Generator) -> np.ndarray:
        """One request's prompt: topic drawn from the mixture at its
        arrival time, tokens i.i.d. from that topic (requests are
        topically coherent, the mixture shifts only across requests)."""
        k = rng.choice(len(self.topics), p=self.mixture(t))
        return rng.choice(self.vocab, size=length,
                          p=self._dists[k]).astype(np.int32)
