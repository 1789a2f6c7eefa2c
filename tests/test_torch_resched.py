"""Token rescheduling in the port against the JAX package, on the CPU.

* ``choose_replica_quota`` and ``_global_positions`` are integer
  arithmetic: equal to the JAX functions bit for bit, the quota draw also
  at a T where ``(salt + 131 e) * 40503`` wraps in int32 (T = 53248 at
  K = 2: the salt reaches T + K - 2).
* ``ep_moe_ffn`` and ``ep_moe_ffn_replicated`` with a quota (greedy or
  LP, on an Algorithm 1 plan) against ``jax.vmap(..., axis_name="model")``
  of the JAX functions with ``use_kernel=True`` (Pallas in interpret mode),
  as ``tests/test_torch_dispatch.py`` runs them, at capacity factor 1.0
  (0.25 for the replicated path, whose capacity counts one rank's slots)
  where the rescue round has work: ``overflow`` (> 0), ``dropped``,
  ``slot_counts`` and the expert counts equal, y within 1e-5 in fp32 and
  ``BF16_ATOL`` in bf16; and the predicted mode with a quota (both rounds
  pick through it, no rescue round).
* ``ContinuousEngine(ep=True)`` under the levers against the meshed JAX
  engine (a ``(1, 4)`` ``AxisType.Auto`` mesh in one subprocess with four
  host devices and ``--xla_allow_excess_precision=false``), both on the
  same bridged reduced-Mixtral weights, made from the JAX init's so that
  the router and ``lm_head`` margins are wide by construction
  (``widen_margins``): every token's hidden state is dominated by a
  direction of its token group, which the router maps to two experts and
  ``lm_head`` to the next group's token, each several logits ahead, so an
  ulp of bf16 rounding elsewhere cannot flip a route or a token and the
  comparison runs to the end of every trace with no near-tie cut-off (on
  the init's own weights a route of the duplicate leg below sits 7e-4
  from a tie and flips). The runs:
  - the A/B of the JAX package's ``bench_serve_traces.py`` lever check
    (capacity factor 0.5, one replica slot, 10 requests of 40-60 copies
    of token 7): legs ``duplicate``, ``reschedule`` (greedy) and ``both``
    (LP);
  - legs ``reschedule`` (LP) and ``both`` (greedy) on mixed prompts;
  - legs ``reschedule`` (greedy) and ``both`` (LP) under
    ``token_to_expert`` with an equal fitted predictor, where every EP
    prefill dispatches on predictions through the quota;
  - a controller offered all three levers on ``skew_shift_trace``.
  Per iteration the generated lengths, the plan and quota stack in
  force, every re-plan's plan and quotas, the lever and strategy, the
  dropped and overflowed pairs, the migration counters and (controller)
  every decision and audit record are equal, and at the end the
  rescheduling summary columns.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import schedule as jsched  # noqa: E402
from repro.configs.base import MoEConfig as JaxMoEConfig  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.core.duplication import duplicate_experts_host as jax_dup  # noqa: E402
from repro.models.transformer import init_model as jax_init_model  # noqa: E402
from repro.moe import dispatch as jep  # noqa: E402
from repro.moe.router import route as jax_route  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.placement import PlacementPlan, to_device  # noqa: E402
from repro_torch.core.predictors import \
    ConditionalProbabilityModel  # noqa: E402
from repro_torch.data.synthetic import make_routing_trace  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.transformer import Runtime, forward  # noqa: E402
from repro_torch.moe import dispatch as ep  # noqa: E402
from repro_torch.moe.router import route  # noqa: E402
from repro_torch.serve import (ContinuousConfig, ContinuousEngine,  # noqa: E402
                               ControllerConfig, OnlineGPSController,
                               ServeRequest)
from repro_torch.workloads import (skew_shift_trace,  # noqa: E402
                                   to_serve_requests)
from tests._torch_margins import SOURCE as MARGINS_SOURCE  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
T, D_MODEL, F, E, K = 32, 32, 64, 8, 2
BF16_ATOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced model's operations are tiny: one intra-op thread runs
    them as fast as many, and keeps this file from oversubscribing the
    cores when test workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# the quota draw and the global positions
# --------------------------------------------------------------------------

def _plan(R, D, seed, num_experts=E):
    rng = np.random.default_rng(seed)
    dist = rng.random(num_experts) ** 4
    dist[rng.integers(num_experts)] += 1.0           # one hot expert
    dist /= dist.sum()
    return dist, jax_dup(dist, R, D, 4).plan


def _port_plan(plan):
    return PlacementPlan(*(np.asarray(a) for a in plan))


def _quota(plan, dist, R, D, impl, tokens=4096):
    """A scheduler's quota for ``dist`` on ``plan`` at a tight capacity."""
    counts = dist * tokens
    return jsched.make_scheduler(impl).plan_layer(
        counts, plan, ep_ranks=R, dup_slots=D,
        cap=counts.max() / 8).quota


@pytest.mark.parametrize("R,D", [(2, 1), (4, 1), (4, 2)])
@pytest.mark.parametrize("impl", ["greedy", "lp"])
@pytest.mark.parametrize("shift", [0, 1])
def test_choose_replica_quota_matches_jax(R, D, impl, shift):
    dist, plan = _plan(R, D, seed=R * 10 + D)
    quota = _quota(plan, dist, R, D, impl)
    assert (quota < jsched.RESCHED_Q).any()          # some copy is split
    rng = np.random.default_rng(shift)
    expert = rng.integers(0, E, 2000).astype(np.int32)
    salt = rng.integers(0, 5000, 2000).astype(np.int32)
    want = jep.choose_replica_quota(jax.tree.map(jnp.asarray, plan),
                                    jnp.asarray(quota), jnp.asarray(expert),
                                    jnp.asarray(salt), shift=shift)
    got = ep.choose_replica_quota(
        to_device(_port_plan(plan), E, R, D, "cpu"), torch.tensor(quota),
        torch.tensor(expert), torch.tensor(salt), shift)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # both rank rows of the prefill path's (R, N) experts at once
    got2 = ep.choose_replica_quota(
        to_device(_port_plan(plan), E, R, D, "cpu"), torch.tensor(quota),
        torch.tensor(np.stack([expert, expert[::-1]])), torch.tensor(salt),
        shift)
    np.testing.assert_array_equal(got2[0].numpy(), np.asarray(want))


def test_choose_replica_quota_wraps_like_jax():
    """The hash runs in int32: at T = 53248 tokens and K = 2 the product
    passes 2**31 for the last tokens, and ``%`` then follows the
    divisor's sign, as in JAX."""
    R, D, Tw = 4, 1, 53248
    dist, plan = _plan(R, D, seed=3)
    quota = _quota(plan, dist, R, D, "greedy")
    rng = np.random.default_rng(0)
    expert = rng.integers(0, E, (Tw, K)).astype(np.int32)
    salt = (np.arange(Tw, dtype=np.int32)[:, None]
            + np.arange(K, dtype=np.int32)[None, :])
    wide = (salt.astype(np.int64) + expert * 131) * 40503
    assert wide.max() >= 2 ** 31                     # the draw wraps
    dplan = to_device(_port_plan(plan), E, R, D, "cpu")
    for shift in (0, 1):
        want = jep.choose_replica_quota(
            jax.tree.map(jnp.asarray, plan), jnp.asarray(quota),
            jnp.asarray(expert.reshape(-1)), jnp.asarray(salt.reshape(-1)),
            shift=shift)
        got = ep.choose_replica_quota(
            dplan, torch.tensor(quota), torch.tensor(expert.reshape(-1)),
            ep._salt(Tw, K, "cpu"), shift)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("num_classes", [3, 12, 40])
@pytest.mark.parametrize("valid_frac", [1.0, 0.6])
def test_global_positions_match_jax(num_classes, valid_frac):
    rng = np.random.default_rng(num_classes)
    N = 300
    gslot = (rng.integers(0, num_classes, N) ** 2 % num_classes).astype(
        np.int32)
    valid = rng.random(N) < valid_frac
    want = jep._global_positions(jnp.asarray(gslot), jnp.asarray(valid),
                                 num_classes)
    got = ep._global_positions(torch.tensor(gslot), torch.tensor(valid),
                               num_classes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# ep_moe_ffn / ep_moe_ffn_replicated with a quota, against vmapped JAX
# --------------------------------------------------------------------------

def _inputs(R, seed):
    """Tokens with a common component the router weight's first column
    follows, so expert 0 is hot and a capacity factor of 1.0 overflows."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(D_MODEL,))
    v /= np.linalg.norm(v)
    x = (rng.normal(size=(R, T, D_MODEL)) + 2.0 * v).astype(np.float32)
    wr = (rng.normal(size=(D_MODEL, E)) * 0.3).astype(np.float32)
    wr[:, 0] += 1.5 * v
    w = {n: (rng.normal(size=s) * 0.1).astype(np.float32)
         for n, s in (("w_gate", (E, D_MODEL, F)), ("w_up", (E, D_MODEL, F)),
                      ("w_down", (E, F, D_MODEL)))}
    return x, wr, w


def _compare(fn_name, R, D, impl, dtype, seed, predicted=False):
    # the replicated path's capacity counts a rank's slots, not all S
    cf = 1.0 if fn_name == "ep_moe_ffn" else 0.25
    moe_kw = dict(num_experts=E, top_k=K, d_ff_expert=F, capacity_factor=cf,
                  duplication_slots=D)
    jmoe, moe = JaxMoEConfig(**moe_kw), MoEConfig(**moe_kw)
    x, wr, w = _inputs(R, seed)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xt = torch.tensor(x).to(tdt)
    wt = {n: torch.tensor(a).to(tdt) for n, a in w.items()}
    w_local = {n: jnp.asarray(a, jdt).reshape(R, E // R, *a.shape[1:])
               for n, a in w.items()}
    router = {"w": jnp.asarray(wr)}
    # plan and quota from the routes' own histogram (expert 0 hot)
    ro = route(torch.tensor(wr), moe, xt if fn_name == "ep_moe_ffn"
               else xt[0])
    dist = np.bincount(ro.expert_idx.reshape(-1).numpy(), minlength=E)
    dist = (dist + 1.0) / (dist + 1.0).sum()
    plan = jax_dup(dist, R, D, 4).plan
    quota = _quota(plan, dist, R, D, impl, tokens=R * T * K)
    pred = None
    if predicted:
        rng = np.random.default_rng(seed)
        true = ro.expert_idx.numpy()
        pred = np.where(rng.random(true.shape) < 0.5, true,
                        (true + 1) % E).astype(np.int32)

    def per_rank(xb, wb, plan_, q, pb):
        if fn_name == "ep_moe_ffn":
            r = jax_route(router, jmoe, xb, impl="fused")
            return jep.ep_moe_ffn(xb, r, wb, plan_, jmoe, axis_name="model",
                                  ep_ranks=R, use_kernel=True,
                                  resched_quota=q, predicted_idx=pb)
        xj0 = jnp.asarray(x[0], jdt)
        r = jax_route(router, jmoe, xj0, impl="fused")
        return jep.ep_moe_ffn_replicated(xj0, r, wb, plan_, jmoe,
                                         axis_name="model", ep_ranks=R,
                                         use_kernel=True, resched_quota=q)
    run = jax.vmap(per_rank, axis_name="model",
                   in_axes=(0, 0, None, None, None if pred is None else 0))
    yj, sj = jax.jit(run)(jnp.asarray(x, jdt), w_local,
                          jax.tree.map(jnp.asarray, plan), jnp.asarray(quota),
                          None if pred is None else jnp.asarray(pred))
    dp = to_device(_port_plan(plan), E, R, D, "cpu")
    ops.reset_launches()
    kw = dict(ep_ranks=R, resched_quota=torch.tensor(quota))
    if fn_name == "ep_moe_ffn":
        yt, st = ep.ep_moe_ffn(xt, ro, wt, dp, moe, predicted_idx=None
                               if pred is None else torch.tensor(pred), **kw)
    else:
        yt, st = ep.ep_moe_ffn_replicated(xt[0], ro, wt, dp, moe, **kw)
    assert sum(ops.LAUNCHES.values()) == 0
    yj = np.asarray(yj, np.float32)
    want_y = yj if fn_name == "ep_moe_ffn" else yj[0]
    atol = 1e-5 if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(yt.float().numpy(), want_y, atol=atol,
                               rtol=0 if dtype == "float32" else atol)
    for name in ("expert_counts", "slot_counts", "dropped", "overflow"):
        np.testing.assert_array_equal(
            np.asarray(getattr(st, name)), np.asarray(getattr(sj, name))[0],
            err_msg=name)
    return int(st.overflow), int(st.dropped)


@pytest.mark.parametrize("fn_name", ["ep_moe_ffn", "ep_moe_ffn_replicated"])
@pytest.mark.parametrize("R,D", [(2, 1), (4, 1), (4, 2)])
@pytest.mark.parametrize("impl", ["greedy", "lp"])
def test_resched_ep_moe_ffn_matches_vmapped_jax_fp32(fn_name, R, D, impl):
    overflow, _ = _compare(fn_name, R, D, impl, "float32", seed=R * 10 + D)
    assert overflow > 0                      # the rescue round has work


@pytest.mark.parametrize("fn_name", ["ep_moe_ffn", "ep_moe_ffn_replicated"])
def test_resched_ep_moe_ffn_matches_vmapped_jax_bf16(fn_name):
    overflow, _ = _compare(fn_name, 4, 1, "greedy", "bfloat16", seed=7)
    assert overflow > 0


@pytest.mark.parametrize("R", [2, 4])
def test_resched_predicted_mode_matches_vmapped_jax(R):
    overflow, dropped = _compare("ep_moe_ffn", R, 1, "greedy", "float32",
                                 seed=R, predicted=True)
    assert overflow == 0 and dropped > 0     # no rescue round in this mode


# --------------------------------------------------------------------------
# the engines under the levers, against the meshed JAX engine
# --------------------------------------------------------------------------

# the JAX package's lever A/B (bench_serve_traces.py, tests/test_schedule.py)
AB_ENGINE_KW = dict(max_slots=4, prefill_len=64, block_size=8, max_len=96,
                    strategy="dist_only", predict_interval=4,
                    metrics_window=4, dup_slots=1)
AB_LEGS = (("duplicate", "greedy"), ("reschedule", "greedy"), ("both", "lp"))
WIDE_LEGS = (("reschedule", "lp"), ("both", "greedy"))
T2E_ENGINE_KW = dict(AB_ENGINE_KW, strategy="token_to_expert")
T2E_LEGS = (("reschedule", "greedy"), ("both", "lp"))
GPS_ENGINE_KW = dict(max_slots=4, prefill_len=32, block_size=8, max_len=64,
                     strategy="dist_only", predict_interval=2,
                     overlap_migration=False, dup_slots=1)
# reduced Mixtral: 4 experts, top-2 (skew cap 2) mapped onto the full
# model's cap of 4
CONTROLLER_KW = dict(window_iters=2, patience=1, min_saving=0.3,
                     skew_cap_observed=2.0, skew_cap_target=4.0,
                     levers=("duplicate", "reschedule", "both"))
TRACE_KW = dict(horizon=8.0, rate=1.5, seed=0)
CAPACITY_FACTOR = 0.5
PLAN_FIELDS = ("n_replicas", "replica_table", "pool_expert", "pool_sel")
COUNTERS = ("replans", "commits", "prebegun", "cancelled", "planned_bytes",
            "bytes_moved", "rejected")
COLUMNS = ("dropped_tokens", "overflow_tokens", "resched_a2a_bytes",
           "overflow_absorbed_frac", "resched_plans", "resched_absorbed_pred",
           "resched_residual", "completed")


def _ab_requests():
    rng = np.random.default_rng(0)
    return [dict(rid=i, tokens=np.full(int(rng.integers(40, 60)), 7,
                                       np.int32).tolist(),
                 max_new_tokens=int(rng.integers(1, 6)), arrival=i * 0.01)
            for i in range(10)]


def _mixed_requests(vocab):
    rng = np.random.default_rng(1)
    return [dict(rid=i, tokens=rng.integers(0, vocab, n).tolist(),
                 max_new_tokens=10, arrival=float(i))
            for i, n in enumerate((5, 17, 11, 30, 9, 60, 23))]


# Executed by the JAX subprocess and here: the weights whose margins are
# wide by construction (tests/_torch_margins.py), and the serve loop that
# records what an engine did per iteration.
CAPTURE = MARGINS_SOURCE + '''
def fit_predictor(cls, cfg, make_routing_trace):
    tr = make_routing_trace(num_sequences=64, seq_len=32,
                            vocab=cfg.vocab_size,
                            num_experts=cfg.moe.num_experts,
                            num_layers=cfg.num_layers, skew=1.5, seed=0)
    return cls(cfg.num_layers, cfg.moe.num_experts,
               cfg.vocab_size).fit(tr.experts, tr.tokens)


def quota_of(eng):
    q = eng._resched_stack
    return None if q is None else np.asarray(q).copy()


def serve_capture(eng, reqs, plan_fields, columns, step_clock):
    import json
    eng.warmup()
    rec = {"plans": [], "quotas": [], "lens": [], "dropped": [],
           "overflow": [], "in_force": [], "quota": [], "mig": [],
           "strategy": [], "lever": [], "decisions": [], "summary": None}
    replan = eng.replan
    def recording_replan():
        out = replan()
        rec["plans"].append((eng.iterations, {f: np.asarray(getattr(
            eng._plan_stack, f)).copy() for f in plan_fields}))
        rec["quotas"].append((eng.iterations, quota_of(eng)))
        return out
    eng.replan = recording_replan
    for r in reqs:
        eng.submit(r)
    now = 0.0
    while eng.has_work() and len(rec["lens"]) < 100:
        sched = eng.scheduler
        if step_clock and (not sched.active_slots and sched.waiting
                           and sched.waiting[0].arrival > now):
            now = sched.waiting[0].arrival
        before = dict(eng.metrics.resched)
        ev = eng.step(now if step_clock else float(len(rec["lens"])))
        now += 0.25
        rec["lens"].append([len(r.generated) for r in reqs])
        rec["dropped"].append(eng.metrics.resched["dropped_tokens"]
                              - before["dropped_tokens"])
        rec["overflow"].append(eng.metrics.resched["overflow_tokens"]
                               - before["overflow_tokens"])
        rec["in_force"].append({f: np.asarray(getattr(
            eng._plan_stack, f)).copy() for f in plan_fields})
        rec["quota"].append(quota_of(eng))
        rec["mig"].append(dict(eng.metrics.migration))
        rec["strategy"].append(eng.strategy)
        rec["lever"].append(eng.lever)
        d = ev.decision
        rec["decisions"].append(None if d is None else (
            d.skew, d.volatility, str(d.recommended), d.strategy,
            d.predict_interval, d.switched, d.lever, d.lever_recommended,
            d.overflow_realized_frac))
    s = eng.metrics.summary()
    rec["summary"] = {k: s[k] for k in columns}
    rec["audit"] = (None if eng.controller is None else
                    json.loads(json.dumps(eng.controller.audit.to_obj())))
    rec["tokens"] = [list(r.generated) for r in reqs]
    return rec
'''

SUB = '''
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_allow_excess_precision=false")
import dataclasses, pickle
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs.registry import get_config
from repro.core.predictors import ConditionalProbabilityModel
from repro.data.synthetic import make_routing_trace
from repro.models.transformer import init_model
from repro.serve import (ContinuousConfig, ContinuousEngine,
                         ControllerConfig, OnlineGPSController, ServeRequest)
from repro.workloads import skew_shift_trace, to_serve_requests

exec(os.environ["RS_CAPTURE"])
fields = ("n_replicas", "replica_table", "pool_expert", "pool_sel")
columns = eval(os.environ["RS_COLUMNS"])
base = get_config("mixtral-8x7b").reduced()
cfg = dataclasses.replace(base, moe=dataclasses.replace(
    base.moe, capacity_factor=float(os.environ["RS_CF"])))
wide = widen_margins(jax.tree.map(np.asarray, init_model(
    jax.random.PRNGKey(0), base)), cfg)

def device_tree(tree):
    tree = jax.tree.map(jnp.asarray, tree)
    tree["layers"]["moe"]["experts"] = jax.tree.map(
        lambda w: w.astype(jnp.bfloat16), tree["layers"]["moe"]["experts"])
    return tree

def requests(rows):
    return [ServeRequest(**dict(r, tokens=np.asarray(r["tokens"], np.int32)))
            for r in rows]

mesh = jax.make_mesh((1, 4), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
res = {}
p = device_tree(wide)
for label, legs_env, reqs_env in (("ab", "RS_AB_LEGS", "RS_AB_REQUESTS"),
                                  ("mixed", "RS_WIDE_LEGS",
                                   "RS_WIDE_REQUESTS")):
    for lever, impl in eval(os.environ[legs_env]):
        eng = ContinuousEngine(cfg, p, ContinuousConfig(
            **eval(os.environ["RS_AB_ENGINE"]), lever=lever,
            resched_impl=impl), mesh=mesh, ep_ranks=4)
        with mesh:
            res[(label, lever, impl)] = serve_capture(
                eng, requests(eval(os.environ[reqs_env])), fields, columns,
                False)
pred = fit_predictor(ConditionalProbabilityModel, cfg, make_routing_trace)
for lever, impl in eval(os.environ["RS_T2E_LEGS"]):
    eng = ContinuousEngine(cfg, p, ContinuousConfig(
        **eval(os.environ["RS_T2E_ENGINE"]), lever=lever, resched_impl=impl),
        mesh=mesh, ep_ranks=4, predictor=pred)
    with mesh:
        res[("t2e", lever, impl)] = serve_capture(
            eng, requests(eval(os.environ["RS_WIDE_REQUESTS"])), fields,
            columns, False)
ctl = OnlineGPSController(get_config("mixtral-8x7b"), ControllerConfig(
    **eval(os.environ["RS_CONTROLLER"])))
eng = ContinuousEngine(cfg, p, ContinuousConfig(
    **eval(os.environ["RS_GPS_ENGINE"])), mesh=mesh, ep_ranks=4,
    controller=ctl)
reqs = to_serve_requests(skew_shift_trace(cfg.vocab_size,
                                          **eval(os.environ["RS_TRACE"])))
with mesh:
    res["gps"] = serve_capture(eng, reqs, fields, columns, True)
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    import pickle
    vocab = get_config("mixtral-8x7b").reduced().vocab_size
    out = tmp_path_factory.mktemp("resched") / "jax_resched.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               RS_CAPTURE=CAPTURE, RS_COLUMNS=repr(COLUMNS),
               RS_CF=repr(CAPACITY_FACTOR), RS_AB_ENGINE=repr(AB_ENGINE_KW),
               RS_AB_LEGS=repr(AB_LEGS), RS_WIDE_LEGS=repr(WIDE_LEGS),
               RS_T2E_ENGINE=repr(T2E_ENGINE_KW), RS_T2E_LEGS=repr(T2E_LEGS),
               RS_AB_REQUESTS=repr(_ab_requests()),
               RS_WIDE_REQUESTS=repr(_mixed_requests(vocab)),
               RS_CONTROLLER=repr(CONTROLLER_KW),
               RS_GPS_ENGINE=repr(GPS_ENGINE_KW), RS_TRACE=repr(TRACE_KW))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB),
                           str(out)], capture_output=True, text=True,
                          timeout=900, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _scope():
    scope = {"np": np}
    exec(CAPTURE, scope)
    return scope


@pytest.fixture(scope="module")
def wide():
    """The JAX init's weights (numpy) with wide margins."""
    base = jax_get_config("mixtral-8x7b").reduced()
    return _scope()["widen_margins"](jax.tree.map(np.asarray, jax_init_model(
        jax.random.PRNGKey(0), base)), base)


def _cfg():
    import dataclasses
    base = get_config("mixtral-8x7b").reduced()
    return dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=CAPACITY_FACTOR))


def _port_run(tree, engine_kw, reqs, step_clock=False, controller=None,
              predictor=None, **ccfg):
    """``serve_capture`` on the port's EP engine, recording also the least
    top-k margin (top-1 over top-2, top-2 over the rest) of every route and
    the least top-1 margin of every step's logits."""
    from repro_torch.models import transformer

    cfg = _cfg()
    eng = ContinuousEngine(cfg, params_from_jax(tree, cfg, device="cpu"),
                           ContinuousConfig(**engine_kw, **ccfg), ep_ranks=4,
                           ep=True, controller=controller,
                           predictor=predictor)
    margins = {"route": [], "logits": []}
    real_route = transformer.route

    def recording_route(w, moe, x):
        srt = torch.matmul(x.float(), w.float()).sort(
            -1, descending=True).values
        margins["route"].append(float(torch.minimum(
            srt[..., 0] - srt[..., 1], srt[..., 1] - srt[..., 2]).min()))
        return real_route(w, moe, x)

    def margin_of(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            top = out[1][:, -1].float().topk(2, dim=-1).values
            margins["logits"].append(float((top[:, 0] - top[:, 1]).min()))
            return out
        return wrapped
    eng._prefill_fn = margin_of(eng._prefill_fn)
    eng._decode_fn = margin_of(eng._decode_fn)
    transformer.route = recording_route
    try:
        rec = _scope()["serve_capture"](eng, [ServeRequest(**dict(
            r, tokens=np.asarray(r["tokens"], np.int32))) for r in reqs],
            PLAN_FIELDS, COLUMNS, step_clock)
    finally:
        transformer.route = real_route
    return eng, rec, margins


def _assert_same_run(rec, ref):
    """Every iteration and the summary equal: no near-tie cut-off."""
    assert rec["tokens"] == ref["tokens"]
    assert rec["lens"] == ref["lens"]
    n = len(ref["lens"])
    for it in range(n):
        for f in PLAN_FIELDS:
            np.testing.assert_array_equal(rec["in_force"][it][f],
                                          ref["in_force"][it][f],
                                          err_msg=f"{f} in force @ {it}")
        a, b = rec["quota"][it], ref["quota"][it]
        assert (a is None) == (b is None), it
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f"quota @ {it}")
        for k in COUNTERS:
            assert rec["mig"][it][k] == ref["mig"][it][k], (k, it)
    for key in ("dropped", "overflow", "strategy", "lever", "decisions"):
        assert rec[key] == ref[key], key
    assert [i for i, _ in rec["plans"]] == [i for i, _ in ref["plans"]]
    for (i, p), (_, q) in zip(rec["plans"], ref["plans"]):
        for f in PLAN_FIELDS:
            np.testing.assert_array_equal(p[f], q[f], err_msg=f"re-plan @ {i}")
    for (i, p), (_, q) in zip(rec["quotas"], ref["quotas"]):
        assert (p is None) == (q is None), i
        if p is not None:
            np.testing.assert_array_equal(p, q, err_msg=f"quota @ re-plan {i}")
    assert rec["summary"] == ref["summary"]
    assert rec["audit"] == ref["audit"]


@pytest.mark.parametrize("leg", AB_LEGS)
def test_lever_ab_matches_meshed_jax_engine(jax_ref, wide, leg):
    """The JAX package's lever A/B at reduced size: 10 prompts of token 7
    at capacity factor 0.5 overflow their slots; duplication alone drops
    pairs, the rescue round takes them. On the (1, 4) mesh the JAX engine
    drops no pair under either rescheduling lever, as its own test expects
    of its (2, 4) mesh, and the port drops none either. Under
    "reschedule" the plan it schedules across is not Algorithm 1's: the
    meshed warmup's re-plan from an empty estimator adopts the identity
    plan and the lever freezes it, so no boundary adopts a plan; the plan
    moves only when the prefetcher's pre-begun fills commit, which the
    lever does not stop. Until then the rescue round re-sends each
    overflowed pair to its home slot (the only copy) at cap2 = max(8,
    cap / 2)."""
    lever, impl = leg
    ref = jax_ref[("ab", lever, impl)]
    _, rec, margins = _port_run(wide, AB_ENGINE_KW, _ab_requests(),
                                lever=lever, resched_impl=impl)
    assert min(margins["route"]) > 1.0 and min(margins["logits"]) > 4.0
    _assert_same_run(rec, ref)
    s = rec["summary"]
    assert s["completed"] == 10
    if lever == "duplicate":
        assert s["dropped_tokens"] > 0 and s["overflow_tokens"] == 0
        assert s["resched_plans"] == 0
    else:
        assert s["resched_plans"] >= 1 and s["overflow_tokens"] > 0
        assert s["resched_a2a_bytes"] > 0
        assert 0.0 <= s["overflow_absorbed_frac"] <= 1.0
        assert ref["summary"]["dropped_tokens"] == 0 == s["dropped_tokens"]
    if lever == "reschedule":
        assert (rec["in_force"][0]["n_replicas"] == 1).all()
        mig = rec["mig"][-1]
        assert mig["replans"] == 0 and mig["commits"] == mig["prebegun"] >= 1


@pytest.mark.parametrize("leg", WIDE_LEGS)
def test_lever_engine_matches_meshed_jax_engine_to_the_end(jax_ref, wide,
                                                           leg):
    lever, impl = leg
    ref = jax_ref[("mixed", lever, impl)]
    vocab = get_config("mixtral-8x7b").reduced().vocab_size
    eng, rec, margins = _port_run(wide, AB_ENGINE_KW,
                                  _mixed_requests(vocab), lever=lever,
                                  resched_impl=impl)
    # the construction holds: no route or token came near a tie
    assert min(margins["route"]) > 1.0 and min(margins["logits"]) > 4.0
    _assert_same_run(rec, ref)
    s = rec["summary"]
    assert s["completed"] == len(_mixed_requests(vocab))
    assert s["overflow_tokens"] > 0 and s["resched_plans"] >= 2
    if lever == "reschedule":
        # the plan froze in warmup: boundaries only refresh the quotas
        assert rec["mig"][-1]["replans"] == 0
    else:
        assert rec["mig"][-1]["replans"] == s["resched_plans"]
    assert eng.lever == lever


@pytest.mark.parametrize("leg", T2E_LEGS)
def test_lever_under_token_to_expert_matches_meshed_jax_engine(jax_ref, wide,
                                                               leg):
    """Token-to-Expert under a rescheduling lever: every EP prefill after
    warmup dispatches on the predictions with the quota (both rounds pick
    through it, no rescue round, overflow 0 there), the decode steps run
    the replicated rescue round; plans, quotas, drops, overflow and the
    columns equal the JAX engine's to the end of the trace."""
    lever, impl = leg
    ref = jax_ref[("t2e", lever, impl)]
    vocab = get_config("mixtral-8x7b").reduced().vocab_size
    calls = []
    real = ep.ep_moe_ffn

    def recording(*a, predicted_idx=None, resched_quota=None, **kw):
        y, st = real(*a, predicted_idx=predicted_idx,
                     resched_quota=resched_quota, **kw)
        calls.append((predicted_idx is not None, resched_quota is not None,
                      int(st.overflow)))
        return y, st
    ep.ep_moe_ffn = recording
    try:
        pred = _scope()["fit_predictor"](ConditionalProbabilityModel,
                                         _cfg(), make_routing_trace)
        eng, rec, margins = _port_run(
            wide, T2E_ENGINE_KW, _mixed_requests(vocab), predictor=pred,
            lever=lever, resched_impl=impl)
    finally:
        ep.ep_moe_ffn = real
    assert min(margins["route"]) > 1.0 and min(margins["logits"]) > 4.0
    _assert_same_run(rec, ref)
    assert (True, True, 0) in calls
    assert all(ov == 0 for p, _, ov in calls if p)
    s = rec["summary"]
    assert s["completed"] == len(_mixed_requests(vocab))
    assert s["resched_plans"] >= 1 and eng.strategy == "token_to_expert"


def test_controller_with_every_lever_matches_jax_engine(jax_ref, wide):
    """A controller offered duplication, rescheduling and both drives the
    EP engine on the skew-shifting trace: every decision (with the lever
    it recommends and the one in force), every audit record, the lever
    and strategy per iteration, plans and quotas equal the JAX engine's
    to the end of the trace, and the run switches lever."""
    ref = jax_ref["gps"]
    ctl = OnlineGPSController(get_config("mixtral-8x7b"),
                              ControllerConfig(**CONTROLLER_KW))
    vocab = get_config("mixtral-8x7b").reduced().vocab_size
    reqs = [dict(rid=r.rid, tokens=r.tokens.tolist(),
                 max_new_tokens=r.max_new_tokens, arrival=r.arrival)
            for r in to_serve_requests(skew_shift_trace(vocab, **TRACE_KW))]
    eng, rec, margins = _port_run(wide, GPS_ENGINE_KW, reqs,
                                  step_clock=True, controller=ctl)
    assert min(margins["route"]) > 1.0 and min(margins["logits"]) > 4.0
    _assert_same_run(rec, ref)
    levers = [d[6] for d in rec["decisions"] if d is not None]
    assert "reschedule" in levers and "duplicate" in levers
    assert rec["summary"]["resched_plans"] >= 1
