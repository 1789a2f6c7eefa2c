"""The port's trace-driven workloads and synthetic routing data against the
JAX package's (``repro.workloads``, ``repro.data.synthetic``), on the CPU.

Both are numpy: for one seed every array must be bit-equal, because the
port makes the same RNG calls in the same order.
"""

import numpy as np
import pytest

from repro.data import synthetic as jsyn
from repro import workloads as jwl
from repro_torch import workloads as twl
from repro_torch.data import synthetic as tsyn
from repro_torch.serve import ServeRequest


def _rngs(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_arrival_processes_match_jax(seed):
    a, b = _rngs(seed)
    for rate, horizon in ((0.0, 10.0), (1.5, 90.0), (40.0, 3.0)):
        np.testing.assert_array_equal(
            twl.poisson_arrivals(rate, horizon, a),
            jwl.poisson_arrivals(rate, horizon, b))
    for kw in (dict(), dict(mean_dwell_low=3.0, mean_dwell_high=1.0)):
        np.testing.assert_array_equal(
            twl.bursty_arrivals(1.5, 6.0, 90.0, a, **kw),
            jwl.bursty_arrivals(1.5, 6.0, 90.0, b, **kw))
    for amp in (0.0, 0.8, 1.5):
        np.testing.assert_array_equal(
            twl.diurnal_arrivals(2.0, amp, 30.0, 90.0, a),
            jwl.diurnal_arrivals(2.0, amp, 30.0, 90.0, b))
    t = twl.bursty_arrivals(1.5, 6.0, 90.0, np.random.default_rng(seed))
    assert (np.diff(t) >= 0).all() and (t >= 0).all() and (t < 90.0).all()


def _corpora(vocab=1024):
    def build(pkg):
        topics = [pkg.Topic("broad", zipf_alpha=0.4, vocab_frac=1.0, seed=1),
                  pkg.Topic("hot", zipf_alpha=3.0, vocab_frac=0.05, seed=2),
                  pkg.Topic("mid", zipf_alpha=1.2, vocab_frac=0.3, seed=3)]
        return pkg.ShiftingCorpus(vocab, topics, schedule=[
            (10.0, [0.2, 0.5, 0.3]), (0.0, [1.0, 0.0, 0.0]),
            (30.0, [0.0, 1.0, 0.0]), (60.0, [0.5, 0.0, 0.5])])
    return build(twl), build(jwl)


def test_shifting_corpus_matches_jax():
    t, j = _corpora()
    for when in (-1.0, 0.0, 5.0, 10.0, 17.5, 30.0, 45.0, 60.0, 99.0):
        np.testing.assert_array_equal(t.mixture(when), j.mixture(when))
        np.testing.assert_array_equal(t.token_dist(when), j.token_dist(when))
    a, b = _rngs(3)
    for when, n in ((0.0, 5), (12.0, 64), (40.0, 1), (70.0, 33)):
        pa, pb = t.sample_prompt(when, n, a), j.sample_prompt(when, n, b)
        assert pa.dtype == pb.dtype == np.int32
        np.testing.assert_array_equal(pa, pb)
    with pytest.raises(ValueError):
        twl.ShiftingCorpus(16, [], [(0.0, [])])
    with pytest.raises(ValueError):
        twl.ShiftingCorpus(16, [twl.Topic("x")], [(0.0, [0.5, 0.5])])


def _assert_traces_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.rid, x.arrival, x.max_new_tokens, x.tenant) == \
            (y.rid, y.arrival, y.max_new_tokens, y.tenant)
        np.testing.assert_array_equal(x.tokens, y.tokens)


@pytest.mark.parametrize("arrivals", ["poisson", "bursty", "diurnal"])
def test_make_trace_matches_jax(arrivals):
    t, j = _corpora()
    specs = {pkg: [pkg.TenantSpec("a", corpus, arrivals=arrivals, rate=1.0),
                   pkg.TenantSpec("b", corpus, arrivals="poisson", rate=0.5,
                                  prompt_len_max=16, out_len_max=4)]
             for pkg, corpus in ((twl, t), (jwl, j))}
    trace = twl.make_trace(specs[twl], 40.0, seed=2)
    _assert_traces_equal(trace, jwl.make_trace(specs[jwl], 40.0, seed=2))
    assert {r.tenant for r in trace} == {"a", "b"}
    with pytest.raises(ValueError):
        twl.TenantSpec("c", t, arrivals="bogus").arrival_times(
            1.0, np.random.default_rng(0))


@pytest.mark.parametrize("seed", [0, 3])
def test_skew_shift_trace_matches_jax(seed):
    for vocab, kw in ((1024, dict(horizon=24.0, rate=2.0)),
                      (32000, dict()),
                      (1024, dict(horizon=10.0, arrivals="poisson",
                                  prompt_len_max=32, out_len_max=4))):
        a = twl.skew_shift_trace(vocab, seed=seed, **kw)
        _assert_traces_equal(a, jwl.skew_shift_trace(vocab, seed=seed, **kw))
    reqs = twl.to_serve_requests(a)
    assert all(isinstance(r, ServeRequest) for r in reqs)
    assert [(r.rid, r.arrival, r.max_new_tokens) for r in reqs] == \
        [(r.rid, r.arrival, r.max_new_tokens) for r in a]


def test_skew_shift_trace_concentrates_in_the_middle():
    """The hot topic's share of the mixture peaks mid-trace, so the
    prompts' distinct-token share falls there."""
    trace = twl.skew_shift_trace(32000, seed=0)
    assert len(trace) == 221
    def distinct(lo, hi):
        toks = np.concatenate([r.tokens for r in trace
                               if lo <= r.arrival < hi])
        return len(np.unique(toks)) / len(toks)
    assert distinct(45.0, 67.5) < 0.5 * distinct(0.0, 30.0)


@pytest.mark.parametrize("E", [1, 4, 8, 64])
def test_skewed_distribution_matches_jax(E):
    for skew in (0.5, 1.0, 1.39, 2.0, 3.5, 100.0):
        a, b = _rngs(int(skew * 10) + E)
        pa = tsyn.skewed_distribution(E, skew, a)
        np.testing.assert_array_equal(pa, jsyn.skewed_distribution(E, skew,
                                                                    b))
        np.testing.assert_array_equal(tsyn.skewed_distribution(E, skew),
                                      jsyn.skewed_distribution(E, skew))
        want = min(max(skew, 1.0), E)
        assert tsyn.measured_skewness(pa) == pytest.approx(want)
        assert tsyn.measured_skewness(pa) == jsyn.measured_skewness(pa)


@pytest.mark.parametrize("drift", [0.0, 0.6])
def test_make_routing_trace_matches_jax(drift):
    kw = dict(num_sequences=6, seq_len=12, vocab=300, num_experts=8,
              num_layers=3, skew=1.8, predictability=0.7, zipf_alpha=1.1,
              drift=drift, seed=5)
    a, b = tsyn.make_routing_trace(**kw), jsyn.make_routing_trace(**kw)
    assert a._fields == b._fields
    for f in ("tokens", "experts", "dist"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.skew, a.predictability) == (b.skew, b.predictability)
    assert a.experts.shape == (3, 6, 12)
    np.testing.assert_allclose(a.dist.sum(1), 1.0)


def test_token_batches_unchanged():
    a = next(tsyn.token_batches(4, 500, 2, 9))
    b = next(jsyn.token_batches(4, 500, 2, 9))
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(a[k], b[k])
