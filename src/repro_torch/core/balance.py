"""Imbalance metrics and the paper's prediction-error -> load models (Sec 3.3).

The port's copy of the JAX package's ``core/balance.py`` (numpy only, the
same arithmetic).
"""

from __future__ import annotations

import numpy as np


def skewness(dist) -> float:
    """max expert share / mean expert share (paper Sec 2)."""
    dist = np.asarray(dist, np.float64)
    dist = dist / max(dist.sum(), 1e-12)
    return float(dist.max() * dist.shape[-1])


def error_rate(p_hat, p) -> float:
    """Distribution estimation error (paper Sec 3.2.1):
    mean |p_hat - p| normalised by the uniform share 1/E."""
    p_hat = np.asarray(p_hat, np.float64)
    p = np.asarray(p, np.float64)
    E = p.shape[-1]
    return float(np.mean(np.abs(p_hat - p)) * E)


def bottleneck_factor(eps: float, num_devices: int, scenario: str = "typical"
                      ) -> float:
    """Multiplier on the perfectly-balanced per-device load given prediction
    error rate ``eps`` (Sec 3.3 / Fig 5).

    optimistic  — errors cancel: still perfectly balanced.
    typical     — errors uniform across devices: (1 + eps).
    pessimistic — all errors land on one device: N * (1 + eps) upper bound.
    """
    if scenario == "optimistic":
        return 1.0
    if scenario == "typical":
        return 1.0 + eps
    if scenario == "pessimistic":
        return num_devices * (1.0 + eps)
    raise ValueError(scenario)


def comm_factor(eps: float, scenario: str = "typical") -> float:
    """Communication never enjoys an optimistic case (Sec 3.3): misrouted
    tokens always pay an extra hop."""
    return 1.0 + max(eps, 0.0)
