"""Next-token cross-entropy over (B, S, V) logits (the port of the JAX
package's ``train/loss.py``).

The JAX package takes the gold logit as ``sum(one_hot(label) * logits)``
so that a vocabulary-sharded layout reduces cheaply. One device has no such
layout, and a (B, S, V) one-hot would be 2 GB at Griffin's 256000-token
vocabulary, so the gold logit here is a gather. It gives the same values:
a label outside ``[0, V)`` has an all-zero one-hot in the reference, so its
gold logit is 0 here too. Accuracy compares the gold logit with the row's
largest, as the reference does.
"""

from __future__ import annotations

import torch


def lm_loss(logits, labels, mask=None, denom=None):
    """logits: (B, S, V); labels: (B, S) int. Returns (loss, {"nll",
    "accuracy"}), fp32 scalars; ``mask`` (B, S) weights each position.
    ``denom``: None (the mask's sum, at least 1), or the divisor to use in
    its place (a data rank's share of the whole batch's, so that the data
    ranks' mean is the whole batch's loss)."""
    logits = logits.float()
    V = logits.shape[-1]
    labels = labels.long()
    logz = torch.logsumexp(logits, dim=-1)
    valid = (labels >= 0) & (labels < V)
    gold = torch.gather(logits, -1, labels.clamp(0, V - 1)[..., None])[..., 0]
    gold = torch.where(valid, gold, torch.zeros_like(gold))
    nll = logz - gold
    mask = torch.ones_like(nll) if mask is None else mask.float()
    if denom is None:
        denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    top = logits.amax(dim=-1)
    acc = (((gold >= top) & (labels >= 0)) * mask).sum() / denom
    return loss, {"nll": loss, "accuracy": acc}
