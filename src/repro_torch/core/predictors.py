"""The Distribution-Only predictor (paper Sec 3.2 / Appendix A).

``DistributionEstimator`` — multinomial MLE with a moving average over
batches (Eq. 1). Zero inference-time cost: its input is the expert
histogram the router produces anyway. The port's copy of the JAX
package's estimator; the Token-to-Expert predictors are not ported yet.
"""

from __future__ import annotations

import numpy as np


class DistributionEstimator:
    """EMA multinomial MLE over per-layer expert histograms."""

    def __init__(self, num_layers: int, num_experts: int, ema: float = 0.9):
        self.counts = np.zeros((num_layers, num_experts), np.float64)
        self.ema = ema
        self._initialized = False

    def update(self, batch_counts: np.ndarray):
        """batch_counts: (L, E) token counts from one batch."""
        bc = np.asarray(batch_counts, np.float64)
        if not self._initialized:
            self.counts = bc.copy()
            self._initialized = True
        else:
            self.counts = self.ema * self.counts + (1 - self.ema) * bc

    def predict(self) -> np.ndarray:
        tot = np.maximum(self.counts.sum(axis=1, keepdims=True), 1e-9)
        return self.counts / tot

    @staticmethod
    def flops_per_token(num_layers: int) -> float:
        return 0.0      # estimation is offline / a histogram side-effect
