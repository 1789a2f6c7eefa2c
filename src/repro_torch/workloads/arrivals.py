"""Request arrival processes.

Everything returns a sorted np.ndarray of arrival times in [0, horizon).
Rates are requests/second of *virtual* trace time — the serving benchmark
replays them against a virtual clock, so absolute scale is free.
"""

from __future__ import annotations

import numpy as np


def poisson_arrivals(rate: float, horizon: float,
                     rng: np.random.Generator) -> np.ndarray:
    """Homogeneous Poisson process: i.i.d. exponential gaps."""
    if rate <= 0:
        return np.empty((0,))
    n = max(int(rate * horizon * 2), 16)
    gaps = rng.exponential(1.0 / rate, size=n)
    t = np.cumsum(gaps)
    while t[-1] < horizon:                      # unlikely undershoot
        more = np.cumsum(rng.exponential(1.0 / rate, size=n)) + t[-1]
        t = np.concatenate([t, more])
    return t[t < horizon]


def bursty_arrivals(rate_low: float, rate_high: float, horizon: float,
                    rng: np.random.Generator, *, mean_dwell_low: float = 20.0,
                    mean_dwell_high: float = 5.0) -> np.ndarray:
    """2-state Markov-modulated Poisson process (calm <-> burst).

    The process alternates exponential-length dwell phases; within a phase
    arrivals are Poisson at that phase's rate. This is the classic bursty
    serving model: long quiet stretches punctuated by sharp load spikes.
    """
    times = []
    t = 0.0
    high = False
    while t < horizon:
        dwell = rng.exponential(mean_dwell_high if high else mean_dwell_low)
        end = min(t + dwell, horizon)
        rate = rate_high if high else rate_low
        seg = poisson_arrivals(rate, end - t, rng) + t
        times.append(seg)
        t = end
        high = not high
    return np.sort(np.concatenate(times)) if times else np.empty((0,))


def diurnal_arrivals(base_rate: float, amplitude: float, period: float,
                     horizon: float, rng: np.random.Generator) -> np.ndarray:
    """Inhomogeneous Poisson with a sinusoidal day/night rate, sampled by
    thinning: rate(t) = base * (1 + amplitude * sin(2 pi t / period))."""
    amplitude = float(np.clip(amplitude, 0.0, 1.0))
    rate_max = base_rate * (1.0 + amplitude)
    cand = poisson_arrivals(rate_max, horizon, rng)
    rate_t = base_rate * (1.0 + amplitude * np.sin(2 * np.pi * cand / period))
    keep = rng.random(cand.shape) < rate_t / rate_max
    return cand[keep]
