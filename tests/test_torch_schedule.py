"""The port's token scheduler (``repro_torch.schedule``) against the JAX
package's ``repro.schedule``, on the CPU.

Both are numpy, so every result must be equal: quotas bit for bit, and the
shares, rank loads and overflow figures of each ``RescheduleResult``
within 1e-12 (the same arithmetic in the same order gives them bit for bit
here too). The cases: ``plan_layer`` of the greedy waterfill and the
transport LP over several seeds and geometries ``(E, R, D, C_max)``, at a
tight capacity (overflow) and a loose one, on plans from Algorithm 1; the
stacked ``plan_stack``; the quota helpers. Then the properties of the host
tests in ``tests/test_schedule.py``, on the port's scheduler: even quotas
reproduce the round-robin split, quotas round-trip and are monotone with
dead columns unreachable, scheduled splits conserve tokens and never
overflow or unbalance more than the even split, they strictly level rank
loads when replicas have headroom, and they are deterministic.
"""

import dataclasses

import numpy as np
import pytest

from repro.core.duplication import duplicate_experts_host as jax_dup
from repro.data.synthetic import skewed_distribution as jax_skewed
from repro import schedule as jsched
from repro_torch import schedule as tsched
from repro_torch.core.duplication import duplicate_experts_host
from repro_torch.core.placement import PlacementPlan
from repro_torch.data.synthetic import skewed_distribution
from repro_torch.schedule import (RESCHED_Q, even_quota, even_quota_stack,
                                  even_shares, make_scheduler,
                                  quota_realized_shares)

IMPLS = ("greedy", "lp")
# (E, R, D, C_max): the reduced and full Mixtral EP geometries, a second
# replica slot, fewer copies, and more ranks than experts per rank
GEOMETRIES = [(4, 4, 1, 4), (8, 4, 1, 4), (16, 4, 2, 4), (8, 2, 1, 3),
              (16, 8, 1, 2)]
RESULT_ARRAYS = ("shares", "rank_loads_even", "rank_loads_sched")
RESULT_FLOATS = ("overflow_even", "overflow_sched", "moved_tokens",
                 "imbalance_even", "imbalance_sched", "overflow_absorbed_frac")


def _case(E, R, D, C, alpha, seed, tokens=4096):
    """Counts and Algorithm 1's plan for a skewed distribution, as the JAX
    plan and the port's (host numpy) plan."""
    rng = np.random.default_rng(seed)
    dist = np.asarray(jax_skewed(E, alpha, rng=rng), np.float64)
    jplan = jax_dup(dist, R, D, C).plan
    return dist * tokens, jplan, PlacementPlan(*(np.asarray(a)
                                                 for a in jplan))


def _assert_results_equal(got, want):
    np.testing.assert_array_equal(got.quota, want.quota)
    assert got.quota.dtype == want.quota.dtype == np.int32
    for name in RESULT_ARRAYS:
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=1e-12, err_msg=name)
    for name in RESULT_FLOATS:
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=0, atol=1e-12, err_msg=name)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("tight", [True, False])
def test_plan_layer_matches_jax(impl, geometry, seed, tight):
    E, R, D, C = geometry
    counts, jplan, plan = _case(E, R, D, C, alpha=2.0 + seed, seed=seed)
    # tight: half the hottest expert's share over C copies, so its copies
    # overflow; loose: 4x the mean expert load
    cap = counts.max() / (2 * C) if tight else counts.mean() * 4
    kw = dict(ep_ranks=R, dup_slots=D, cap=cap)
    got = make_scheduler(impl).plan_layer(counts, plan, **kw)
    want = jsched.make_scheduler(impl).plan_layer(counts, jplan, **kw)
    _assert_results_equal(got, want)
    if tight:
        assert want.overflow_even > 0


@pytest.mark.parametrize("impl", IMPLS)
def test_plan_stack_matches_jax(impl):
    L, E, R, D, C = 3, 8, 4, 1, 4
    rng = np.random.default_rng(5)
    counts = np.stack([jax_skewed(E, 2.0 + l, rng=rng) * 2048
                       for l in range(L)])
    jplans = [jax_dup(counts[l] / counts[l].sum(), R, D, C).plan
              for l in range(L)]
    plans = [PlacementPlan(*(np.asarray(a) for a in p)) for p in jplans]
    kw = dict(ep_ranks=R, dup_slots=D, cap=256.0)
    quota, results = make_scheduler(impl).plan_stack(counts, plans, **kw)
    jquota, jresults = jsched.make_scheduler(impl).plan_stack(counts, jplans,
                                                              **kw)
    np.testing.assert_array_equal(quota, jquota)
    assert quota.shape == (L, E, C) and quota.dtype == np.int32
    for got, want in zip(results, jresults):
        _assert_results_equal(got, want)


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_quota_helpers_match_jax(geometry):
    E, R, D, C = geometry
    counts, jplan, plan = _case(E, R, D, C, alpha=3.0, seed=7)
    n_rep = np.asarray(plan.n_replicas, np.int64)
    np.testing.assert_array_equal(even_quota(plan), jsched.even_quota(jplan))
    np.testing.assert_array_equal(even_quota_stack(3, plan),
                                  jsched.even_quota_stack(3, jplan))
    np.testing.assert_array_equal(even_shares(n_rep, C),
                                  jsched.even_shares(n_rep, C))
    sh = make_scheduler("greedy").plan_layer(
        counts, plan, ep_ranks=R, dup_slots=D, cap=counts.mean()).shares
    q = tsched.shares_to_quota(sh, n_rep)
    np.testing.assert_array_equal(q, jsched.shares_to_quota(sh, n_rep))
    np.testing.assert_array_equal(quota_realized_shares(q),
                                  jsched.quota_realized_shares(q))
    assert RESCHED_Q == jsched.RESCHED_Q
    assert (tsched.base._HASH_MULT, tsched.base._HASH_EXPERT) == \
        (jsched.base._HASH_MULT, jsched.base._HASH_EXPERT)
    assert [f.name for f in dataclasses.fields(tsched.RescheduleResult)] \
        == [f.name for f in dataclasses.fields(jsched.RescheduleResult)]


# --------------------------------------------------------------------------
# the properties of tests/test_schedule.py, on the port
# --------------------------------------------------------------------------

EP_RANKS, DUP_SLOTS, MAX_COPIES = 4, 2, 4


def _plan(dist):
    return duplicate_experts_host(np.asarray(dist, np.float64), EP_RANKS,
                                  DUP_SLOTS, MAX_COPIES).plan


def _skewed_case(E=16, alpha=3.0, tokens=4096, seed=0):
    rng = np.random.default_rng(seed)
    dist = skewed_distribution(E, alpha, rng=rng)
    return np.asarray(dist, np.float64) * tokens, _plan(dist)


def test_even_quota_reproduces_round_robin_shares():
    _, plan = _skewed_case(seed=1)
    n_rep = np.asarray(plan.n_replicas, np.int64)
    got = quota_realized_shares(even_quota(plan))
    want = even_shares(n_rep, np.asarray(plan.replica_table).shape[1])
    np.testing.assert_allclose(got, want, atol=2.0 / RESCHED_Q)


def test_quota_roundtrip_and_monotonicity():
    counts, plan = _skewed_case(seed=2)
    res = make_scheduler("greedy").plan_layer(
        counts, plan, ep_ranks=EP_RANKS, dup_slots=DUP_SLOTS,
        cap=counts.sum() / 8)
    q = res.quota
    n_rep = np.asarray(plan.n_replicas, np.int64)
    assert q.dtype == np.int32 and q.shape == res.shares.shape
    assert (np.diff(q, axis=1) >= 0).all()
    cols = np.arange(q.shape[1])[None, :]
    assert (q[cols >= np.maximum(n_rep, 1)[:, None] - 1] == RESCHED_Q).all()
    np.testing.assert_allclose(quota_realized_shares(q), res.shares,
                               atol=2.0 / RESCHED_Q)


def test_even_quota_stack_shape_is_static():
    _, plan = _skewed_case(seed=3)
    stack = even_quota_stack(6, plan)
    E, C = np.asarray(plan.replica_table).shape
    assert stack.shape == (6, E, C) and stack.dtype == np.int32
    assert (stack[0] == stack[-1]).all()


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_scheduler_never_worse_than_even_split(impl, seed):
    counts, plan = _skewed_case(alpha=2.0 + seed, seed=seed)
    n_rep = np.asarray(plan.n_replicas, np.int64)
    cap = counts.sum() / (counts.shape[0] * 0.6)
    res = make_scheduler(impl).plan_layer(counts, plan, ep_ranks=EP_RANKS,
                                          dup_slots=DUP_SLOTS, cap=cap)
    sh = res.shares
    cols = np.arange(sh.shape[1])[None, :]
    live = cols < np.maximum(n_rep, 1)[:, None]
    assert (sh >= 0).all() and (sh[~live] == 0).all()
    np.testing.assert_allclose(sh.sum(1), 1.0, atol=1e-9)
    np.testing.assert_allclose((sh * counts[:, None]).sum(), counts.sum(),
                               rtol=1e-12)
    assert res.overflow_sched <= res.overflow_even + 1e-9
    assert res.imbalance_sched <= res.imbalance_even + 1e-9
    assert 0.0 <= res.overflow_absorbed_frac <= 1.0


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("seed", [0, 1, 4])
def test_scheduler_strictly_levels_rank_loads(impl, seed):
    counts, plan = _skewed_case(E=16, alpha=5.0, seed=seed)
    res = make_scheduler(impl).plan_layer(
        counts, plan, ep_ranks=EP_RANKS, dup_slots=DUP_SLOTS,
        cap=counts.mean() * 4)
    assert res.overflow_even == 0.0 and res.overflow_sched == 0.0
    assert res.imbalance_sched < res.imbalance_even - 0.01
    assert res.moved_tokens > 0


@pytest.mark.parametrize("impl", IMPLS)
def test_scheduler_deterministic(impl):
    counts, plan = _skewed_case(seed=11)
    kw = dict(ep_ranks=EP_RANKS, dup_slots=DUP_SLOTS, cap=counts.sum() / 10)
    a = make_scheduler(impl).plan_layer(counts, plan, **kw)
    b = make_scheduler(impl).plan_layer(counts, plan, **kw)
    assert np.array_equal(a.quota, b.quota)
    assert np.array_equal(a.shares, b.shares)


def test_plan_stack_stacks_per_layer_quotas():
    L, E = 3, 16
    counts = np.stack([skewed_distribution(E, 2.0 + l) * 2048
                       for l in range(L)])
    plans = [_plan(counts[l] / counts[l].sum()) for l in range(L)]
    quota, results = make_scheduler("greedy").plan_stack(
        counts, plans, ep_ranks=EP_RANKS, dup_slots=DUP_SLOTS, cap=256.0)
    assert quota.shape[0] == L and quota.dtype == np.int32
    assert len(results) == L
    for l, r in enumerate(results):
        assert np.array_equal(quota[l], r.quota)


def test_make_scheduler_rejects_unknown_impl():
    with pytest.raises(ValueError, match="unknown scheduler"):
        make_scheduler("simplex")
