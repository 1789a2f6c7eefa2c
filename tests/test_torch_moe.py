"""Routing, the dense MoE FFN, Algorithm 1 and the Distribution-Only
estimator in the PyTorch port, against the JAX package on the same numpy
inputs.

Tolerances: 1e-6 for fp32 router outputs and losses; the dense MoE FFN at
1e-5 in fp32 (sums of 256-long products in another order) and at one bf16
ulp (rtol/atol 1e-2) in bf16. Plans and assignments must be equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.core import duplication as jdup  # noqa: E402
from repro.core import placement as jpl  # noqa: E402
from repro.core.predictors import DistributionEstimator as JaxEstimator  # noqa: E402
from repro.models.moe import moe_ffn_dense as jax_moe_ffn  # noqa: E402
from repro.moe import router as jrouter  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import duplication as tdup  # noqa: E402
from repro_torch.core import placement as tpl  # noqa: E402
from repro_torch.core.predictors import DistributionEstimator  # noqa: E402
from repro_torch.models.moe import moe_ffn_dense  # noqa: E402
from repro_torch.moe import router as trouter  # noqa: E402

CFG = get_config("mixtral-8x7b").reduced()
JCFG = jax_get_config("mixtral-8x7b").reduced()


def _router_inputs(seed, T=48):
    rng = np.random.default_rng(seed)
    d, E = CFG.d_model, CFG.moe.num_experts
    x = rng.normal(size=(T, d)).astype(np.float32)
    w = (rng.normal(size=(d, E)) * 0.05).astype(np.float32)
    return x, w


def test_route_matches_jax():
    x, w = _router_inputs(0)
    k = CFG.moe.top_k
    # the inputs' top-(k+1) probabilities are separated by more than 1e-4,
    # so the selection and its order are no coin toss
    logits = x @ w
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    top = -np.sort(-p, axis=-1)[:, :k + 1]
    assert np.min(top[:, :-1] - top[:, 1:]) > 1e-4
    want = jrouter.route({"w": jnp.asarray(w)}, JCFG.moe, jnp.asarray(x))
    got = trouter.route(torch.tensor(w), CFG.moe, torch.tensor(x))
    np.testing.assert_array_equal(got.expert_idx.numpy(),
                                  np.asarray(want.expert_idx))
    assert got.expert_idx.dtype == torch.int32
    for name in ("gates", "probs", "aux_loss", "z_loss"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   atol=1e-6, rtol=1e-6, err_msg=name)


def test_route_ties_go_to_lowest_index_as_lax_top_k():
    # every row ties its two largest logits exactly
    x = np.eye(4, dtype=np.float32)
    w = np.asarray([[1.0, 2.0, 2.0, 0.0], [3.0, 3.0, 3.0, 3.0],
                    [0.5, 0.5, 0.1, 0.5], [0.0, 1.0, 0.0, 1.0]], np.float32)
    cfg = CFG.moe
    want = jrouter.route({"w": jnp.asarray(w)}, cfg, jnp.asarray(x))
    got = trouter.route(torch.tensor(w), cfg, torch.tensor(x))
    np.testing.assert_array_equal(got.expert_idx.numpy(),
                                  np.asarray(want.expert_idx))
    np.testing.assert_array_equal(got.expert_idx.numpy(),
                                  [[1, 2], [0, 1], [0, 1], [1, 3]])


def test_expert_histogram_matches_jax():
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 8, size=(5, 3, 2)).astype(np.int32)
    want = jrouter.expert_histogram(jnp.asarray(idx), 8)
    got = trouter.expert_histogram(torch.tensor(idx), 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    w = rng.uniform(size=idx.shape).astype(np.float32)
    np.testing.assert_allclose(
        trouter.expert_histogram(torch.tensor(idx), 8, torch.tensor(w)).numpy(),
        np.bincount(idx.reshape(-1), w.reshape(-1), minlength=8), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_dense_matches_jax(dtype):
    rng = np.random.default_rng(2)
    d, E, F = CFG.d_model, CFG.moe.num_experts, CFG.moe.d_ff_expert
    x = rng.normal(size=(2, 6, d)).astype(np.float32)
    w = {"router": rng.normal(size=(d, E)) * 0.05,
         "w_gate": rng.normal(size=(E, d, F)) / np.sqrt(d),
         "w_up": rng.normal(size=(E, d, F)) / np.sqrt(d),
         "w_down": rng.normal(size=(E, F, d)) / np.sqrt(F)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jp = {"router": {"w": jnp.asarray(w["router"])},
          "experts": {k: jnp.asarray(w[k]) for k in ("w_gate", "w_up",
                                                     "w_down")}}
    y_j, r_j = jax_moe_ffn(jp, JCFG, jnp.asarray(x, jdt))
    # the port stores expert weights in the activation dtype; the router
    # weight stays fp32
    tp = {k: torch.tensor(v).to(tdt if k != "router" else torch.float32)
          for k, v in w.items()}
    y_t, r_t = moe_ffn_dense(tp, CFG, torch.tensor(x).to(tdt))
    assert y_t.dtype == tdt and y_t.shape == x.shape
    np.testing.assert_array_equal(r_t.expert_idx.numpy(),
                                  np.asarray(r_j.expert_idx))
    tol = 1e-5 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(y_t.float().numpy(), np.asarray(y_j, np.float32),
                               atol=tol, rtol=tol)


# ---------------------------------------------------------------------------
# Algorithm 1 and the placement plans
# ---------------------------------------------------------------------------

def _plans_equal(a, b):
    assert type(a).__name__ == type(b).__name__ == "PlacementPlan"
    for field in a._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, field)),
                                      np.asarray(getattr(b, field)),
                                      err_msg=field)


@pytest.mark.parametrize("ep_ranks", [1, 2, 4])
@pytest.mark.parametrize("dup_slots", [1, 2])
def test_identity_plan_matches_jax(ep_ranks, dup_slots):
    _plans_equal(tpl.identity_plan(8, ep_ranks, dup_slots, 4),
                 jpl.identity_plan(8, ep_ranks, dup_slots, 4))


@pytest.mark.parametrize("ep_ranks", [1, 2, 4])
@pytest.mark.parametrize("dup_slots", [1, 2])
def test_duplicate_experts_host_matches_jax(ep_ranks, dup_slots):
    rng = np.random.default_rng(ep_ranks * 10 + dup_slots)
    for alpha in (0.3, 1.0, 5.0):            # heavy skew .. near uniform
        for _ in range(4):
            dist = rng.dirichlet(np.full(8, alpha))
            got = tdup.duplicate_experts_host(dist, ep_ranks, dup_slots, 4)
            want = jdup.duplicate_experts_host(dist, ep_ranks, dup_slots, 4)
            assert got.assignments == want.assignments
            _plans_equal(got.plan, want.plan)
            np.testing.assert_allclose(got.rank_loads, want.rank_loads)
            np.testing.assert_array_equal(
                tpl.slot_expert_map(got.plan, ep_ranks, dup_slots),
                jpl.slot_expert_map(want.plan, ep_ranks, dup_slots))
            assert tdup.bottleneck_load(dist, ep_ranks) == \
                jdup.bottleneck_load(dist, ep_ranks)
            assert tdup.skewness(dist) == jdup.skewness(dist)


def test_quota_limited_and_stacked_plans_match_jax():
    rng = np.random.default_rng(7)
    t_plans, j_plans = [], []
    for _ in range(3):
        dist = rng.dirichlet(np.full(8, 0.3))
        a = tdup.duplicate_experts_host(dist, 4, 1, 4).assignments
        t_plans.append(tpl.quota_limited_plan(a, 8, 4, 2, 4, quota=1))
        j_plans.append(jpl.quota_limited_plan(a, 8, 4, 2, 4, quota=1))
        _plans_equal(tpl.plan_from_assignments(a, 8, 4, 1, 4),
                     jpl.plan_from_assignments(a, 8, 4, 1, 4))
    _plans_equal(tpl.stack_plans(t_plans), jpl.stack_plans(j_plans))


def test_distribution_estimator_matches_jax():
    rng = np.random.default_rng(3)
    t, j = DistributionEstimator(2, 8, ema=0.8), JaxEstimator(2, 8, ema=0.8)
    for _ in range(6):
        counts = rng.integers(0, 50, size=(2, 8)).astype(np.float64)
        t.update(counts)
        j.update(counts)
        np.testing.assert_array_equal(t.predict(), j.predict())
    np.testing.assert_array_equal(t.counts, j.counts)
