"""Synthetic token streams (the port's copy of the part of the JAX
package's ``data/synthetic.py`` its launchers read). numpy only, so one seed
gives the same prompts as the JAX package's launchers."""

from __future__ import annotations

from typing import Iterator

import numpy as np


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
