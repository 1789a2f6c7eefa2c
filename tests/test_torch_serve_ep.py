"""The port's ``ServeEngine`` expert-parallel half against the JAX package,
on the CPU.

* ``duplicate_experts_device`` against ``jax.vmap`` of the JAX package's
  ``duplicate_experts_jax`` run op by op (``jax.disable_jit()``), on (L, 8)
  expert-count histograms over (R, D, C_max) in {(2, 1, 4), (4, 1, 4),
  (4, 2, 4), (8, 1, 2)}: seeded numpy draws, uniform, one-hot and
  zero-containing (one layer all zeros). All four plan fields are equal.
* ``device_slot_experts`` / ``device_plan`` on those plans (as device
  tensors) against the numpy ``slot_experts`` and ``to_device``.
* ``make_prefill_replan_step`` against the meshed JAX step, twice in a
  chain (the second call runs under the first's in-graph plan), on 2 x 48
  prompts whose hot slots overflow their capacity: the next plans, the
  expert and slot counts and the drops are equal, the logits
  within ``LOGIT_ATOL`` plus one bf16 ulp of their magnitude (``rtol``
  2^-7: the widened head's logits reach ~16), with equal argmax.
* ``ServeEngine(ep=True, ep_ranks=4)`` against the meshed JAX
  ``ServeEngine`` (a ``(1, 4)`` ``AxisType.Auto`` mesh in one subprocess
  with four host devices and ``--xla_allow_excess_precision=false``), both
  on the JAX init's reduced-Mixtral weights with wide router and
  ``lm_head`` margins (``tests/_torch_margins.py``), so no route or token
  sits near a tie and every run is compared to its end. Three batches of 2
  x 16 Zipf tokens (``data.synthetic.token_batches``), batch b shifted by
  256 b so that its hot experts, and so the plan, move each batch; 6 new
  tokens each; a re-plan per batch. Legs: the store with overlapped
  (layer-staged, 2-entry chunks) and with synchronous migration, the
  store-less ``replica_impl="gather"``, ``in_graph_replan``, strategy
  ``none``, lever ``reschedule`` (greedy) and ``both`` (LP), and
  ``token_to_expert`` with a ``ConditionalProbabilityModel``. Per batch the
  generated ids, the plan in force, every re-plan's plan (and an in-flight
  fill's target), the store's slot map and versions, ``history[-1]`` (skew,
  dropped, overflow, migration entries and bytes, the lever's predicted
  absorption and residual, the accuracy window's hit rate and KL), the
  last migration's counters and the prefill's per-rank loads are equal.
  (Nothing drops at this size: a rank's 8 tokens never fill a slot's
  least capacity of 8 pairs; the step above compares drops.)
  The overlap budget reads the recent prefill wall time, which differs
  between the two frameworks: both engines get the same ``_recent_step_s``
  before every call, and ``_note_step_time`` does nothing in either, so
  the fills commit at the same ticks.
* The store-memory clamp under ``ep=True`` equals the JAX engine's under a
  mesh (the case of ``tests/test_overlap_prefetch.py``).
* ``repro_torch.launch.serve`` with ``--data-mesh 1 --model-mesh 4`` serves
  every request through the EP engine; a data axis under the stacked
  backend (it names ``--backend nccl`` or ``gloo``) or a ``--seq`` that
  does not split over the ranks raises.
"""

import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.core.duplication import duplicate_experts_jax  # noqa: E402
from repro.models.transformer import init_model as jax_init_model  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.duplication import \
    duplicate_experts_device  # noqa: E402
from repro_torch.core.placement import (PlacementPlan,  # noqa: E402
                                        device_plan, device_slot_experts,
                                        slot_experts, to_device)
from repro_torch.core.predictors import \
    ConditionalProbabilityModel  # noqa: E402
from repro_torch.data.synthetic import (make_routing_trace,  # noqa: E402
                                        token_batches)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.transformer import Runtime, init_cache  # noqa: E402
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402
from repro_torch.train.steps import make_prefill_replan_step  # noqa: E402
from tests._torch_margins import SOURCE as MARGINS_SOURCE  # noqa: E402
from tests._torch_margins import widen_margins  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
R = 4
LOGIT_ATOL = 5e-2             # bf16 logits, as in tests/test_torch_model.py
PLAN_FIELDS = ("n_replicas", "replica_table", "pool_expert", "pool_sel")
BATCHES, B, S, NEW = 3, 2, 16, 6
MAX_LEN = 32                  # S + NEW <= the reduced window (64)
# the step's prompts: 24 tokens per rank, so a hot slot overflows its
# capacity of 8 pairs from a rank (the engine's 8 per rank never do)
STEP_S_TOKENS = 48
STEP_S = 3e-5                 # pinned overlap window: 2 chunks per tick
SERVE_KW = dict(strategy="dist_only", predict_interval=1, dup_slots=1,
                max_len=MAX_LEN)
# leg -> (ServeConfig changes, MoEConfig changes, with a predictor)
LEGS = {
    "store": (dict(migrate_chunk=2), {}, False),
    "sync": ({}, dict(overlap_migration=False), False),
    "gather": ({}, dict(replica_impl="gather"), False),
    "in_graph": (dict(in_graph_replan=True), {}, False),
    "none": (dict(strategy="none"), {}, False),
    "reschedule": (dict(lever="reschedule", resched_impl="greedy"), {},
                   False),
    "both": (dict(lever="both", resched_impl="lp"), {}, False),
    "t2e": (dict(strategy="token_to_expert"), {}, True),
}


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
# duplicate_experts_device
# --------------------------------------------------------------------------

GRID = ((2, 1, 4), (4, 1, 4), (4, 2, 4), (8, 1, 2))
KINDS = ("seed0", "seed1", "seed2", "uniform", "onehot", "zeros")
L_GRID, E_GRID = 4, 8


def _histogram(kind: str) -> np.ndarray:
    """(L, 8) expert counts of one kind."""
    if kind.startswith("seed"):
        rng = np.random.default_rng(int(kind[4:]))
        return np.stack([rng.multinomial(512, p) for p in rng.dirichlet(
            np.full(E_GRID, 0.4), L_GRID)]).astype(np.float32)
    if kind == "uniform":
        return np.full((L_GRID, E_GRID), 64.0, np.float32)
    if kind == "onehot":
        h = np.zeros((L_GRID, E_GRID), np.float32)
        h[np.arange(L_GRID), np.arange(L_GRID) * 3 % E_GRID] = 512.0
        return h
    h = np.random.default_rng(7).integers(0, 90, (L_GRID, E_GRID))
    h[:, ::3] = 0
    h[1] = 0                                        # a layer with no pairs
    return h.astype(np.float32)


def _jax_plan(hist, r, d, c):
    with jax.disable_jit():
        plan = jax.vmap(lambda x: duplicate_experts_jax(x, r, d, c))(
            jnp.asarray(hist))
    return {f: np.asarray(getattr(plan, f)) for f in PLAN_FIELDS}


CASES = [(g, k) for g in GRID for k in KINDS]


@pytest.mark.parametrize("rdc,kind", CASES,
                         ids=[f"R{g[0]}D{g[1]}C{g[2]}-{k}" for g, k in CASES])
def test_duplicate_experts_device_matches_vmapped_jax(rdc, kind):
    r, d, c = rdc
    hist = _histogram(kind)
    ref = _jax_plan(hist, r, d, c)
    out = duplicate_experts_device(torch.tensor(hist), r, d, c)
    for f in PLAN_FIELDS:
        t = getattr(out, f)
        assert t.dtype == torch.int32, f
        np.testing.assert_array_equal(t.numpy(), ref[f], err_msg=f)
    if kind.startswith("seed") and d == 1:
        # the grid bites: some layer replicates an expert
        assert (ref["n_replicas"] > 1).any()


@pytest.mark.parametrize("rdc,kind", CASES,
                         ids=[f"R{g[0]}D{g[1]}C{g[2]}-{k}" for g, k in CASES])
def test_device_plan_matches_host_builders(rdc, kind):
    """The in-graph plan's DevicePlan, built from its device tensors,
    equals the numpy ``slot_experts`` and ``to_device`` of the same plan
    (with and without a slot -> row map); ``to_device`` of the tensor plan
    gives the same, moved to the device it is asked for."""
    r, d, c = rdc
    ref = _jax_plan(_histogram(kind), r, d, c)
    host = PlacementPlan(**ref)
    dev = PlacementPlan(**{f: torch.tensor(a) for f, a in ref.items()})
    se = slot_experts(host, E_GRID, r, d)
    np.testing.assert_array_equal(
        device_slot_experts(dev, E_GRID, r, d).numpy(), se)
    rows = np.random.default_rng(3).integers(0, 20, se.shape).astype(
        np.int32)
    for rows_host, rows_dev in ((None, None), (rows, torch.tensor(rows))):
        want = to_device(host, E_GRID, r, d, "cpu", rows=rows_host)
        got = device_plan(dev, E_GRID, r, d, rows=rows_dev)
        assert got.slot_experts.dtype == torch.int32
        assert got.n_replicas.dtype == torch.int64
        np.testing.assert_array_equal(want.slot_experts.numpy(), se)
        np.testing.assert_array_equal(
            want.slot_rows.numpy(), se if rows_host is None else rows_host)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            assert torch.equal(a, b)
        # a plan of tensors through to_device: the same plan, on the
        # device asked for (the meta device stands in for the card)
        for a, b in zip(to_device(dev, E_GRID, r, d, "cpu", rows=rows_dev),
                        want):
            assert torch.equal(a, b)
        assert all(t.device.type == "meta" for t in to_device(
            dev, E_GRID, r, d, "meta", rows=rows_dev))


# --------------------------------------------------------------------------
# the prefill + re-plan step and the engine against the meshed JAX package
# --------------------------------------------------------------------------

def _batches(vocab, seq=S):
    """BATCHES (B, seq) Zipf prompts, batch b shifted by 256 b: under
    ``widen_margins`` its tokens' group, so its hot experts, moves."""
    gen = token_batches(0, vocab, B, seq)
    return [((next(gen)["tokens"] + 256 * b) % vocab).astype(np.int32)
            for b in range(BATCHES)]


# Executed by the JAX subprocess and here: serve batches through
# ``generate`` and record per batch what the engine did.
CAPTURE = MARGINS_SOURCE + '''
def plan_np(plan, fields):
    return None if plan is None else {
        f: np.asarray(getattr(plan, f)).copy() for f in fields}


def serve_batches(eng, batches, new_tokens, step_s, fields):
    eng._note_step_time = lambda dt: None
    rec = {"tokens": [], "in_force": [], "replans": [], "store_se": [],
           "store_version": [], "history": [], "migration": [],
           "loads": []}
    prefill, decode, replan = eng.prefill, eng.decode, eng.replan

    def pinned_prefill(*a, **k):
        eng._recent_step_s = step_s
        out = prefill(*a, **k)
        rec["loads"].append(eng.rank_loads(
            np.asarray(out[2]["slot_counts"])).tolist())
        return out

    def pinned_decode(*a, **k):
        eng._recent_step_s = step_s
        return decode(*a, **k)

    def recording_replan():
        out = replan()
        ex = eng._executor
        rec["replans"].append((eng.batches_seen, plan_np(out, fields),
                               plan_np(ex.target_plan, fields)
                               if ex is not None and ex.active else None))
        return out
    eng.prefill, eng.decode = pinned_prefill, pinned_decode
    eng.replan = recording_replan
    for b in batches:
        out, _ = eng.generate({"tokens": b}, max_new_tokens=new_tokens)
        rec["tokens"].append(np.asarray(out).tolist())
        rec["in_force"].append(plan_np(eng._current_plan(), fields))
        st = eng._store
        rec["store_se"].append(
            None if st is None else np.asarray(st.slot_experts).tolist())
        rec["store_version"].append(
            None if st is None else np.asarray(st.version).tolist())
        rec["history"].append(dict(eng.history[-1]))
        rec["migration"].append(dict(eng._last_migration))
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
from repro.core.duplication import duplicate_experts_host
from repro.core.placement import stack_plans
from repro.core.predictors import ConditionalProbabilityModel
from repro.data.synthetic import make_routing_trace
from repro.models.transformer import Runtime, init_cache, init_model
from repro.serve import ServeConfig, ServeEngine
from repro.train.steps import make_prefill_replan_step

exec(os.environ["SE_CAPTURE"])
fields = ("n_replicas", "replica_table", "pool_expert", "pool_sel")
base = get_config("mixtral-8x7b").reduced()
tree = widen_margins(jax.tree.map(np.asarray, init_model(
    jax.random.PRNGKey(0), base)), base)
tree = jax.tree.map(jnp.asarray, tree)
tree["layers"]["moe"]["experts"] = jax.tree.map(
    lambda w: w.astype(jnp.bfloat16), tree["layers"]["moe"]["experts"])
batches = [np.asarray(b, np.int32) for b in eval(os.environ["SE_BATCHES"])]
step_batches = [np.asarray(b, np.int32)
                for b in eval(os.environ["SE_STEP_BATCHES"])]
mesh = jax.make_mesh((1, 4), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
res = {}

# the fused prefill + re-plan step, twice in a chain
cfg = dataclasses.replace(base, moe=dataclasses.replace(
    base.moe, duplication_slots=1))
rt = Runtime(mesh=mesh, ep=True, ep_ranks=4, use_duplication=True)
step = jax.jit(make_prefill_replan_step(cfg, rt))
dist = np.array([0.55, 0.25, 0.15, 0.05])
plan = stack_plans([duplicate_experts_host(np.roll(dist, l), 4, 1, 4).plan
                    for l in range(cfg.num_layers)])
res["step"] = []
with mesh:
    for b in step_batches:
        cache = init_cache(cfg, rt, b.shape[0], b.shape[1])
        logits, _, stats, plan = step(tree, {"tokens": jnp.asarray(b)},
                                      cache, plan, None)
        res["step"].append({
            "logits": np.asarray(logits, np.float32),
            "expert_counts": np.asarray(stats["expert_counts"]),
            "slot_counts": np.asarray(stats["slot_counts"]),
            "dropped": np.asarray(stats["dropped"]),
            "plan": plan_np(plan, fields)})

pred = None
for name, (serve_kw, moe_kw, with_pred) in eval(os.environ["SE_LEGS"]).items():
    cfg = dataclasses.replace(base, moe=dataclasses.replace(base.moe,
                                                            **moe_kw))
    if with_pred and pred is None:
        tr = make_routing_trace(num_sequences=64, seq_len=32,
                                vocab=cfg.vocab_size,
                                num_experts=cfg.moe.num_experts,
                                num_layers=cfg.num_layers, skew=1.5, seed=0)
        pred = ConditionalProbabilityModel(
            cfg.num_layers, cfg.moe.num_experts,
            cfg.vocab_size).fit(tr.experts, tr.tokens)
    eng = ServeEngine(cfg, tree, ServeConfig(**dict(
        eval(os.environ["SE_SERVE_KW"]), **serve_kw)), mesh=mesh,
        ep_ranks=4, predictor=pred if with_pred else None)
    res[name] = serve_batches(eng, batches, eval(os.environ["SE_NEW"]),
                              eval(os.environ["SE_STEP_S"]), fields)
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(scope="module")
def wide():
    """The JAX init's reduced-Mixtral weights (numpy) with wide margins."""
    base = jax_get_config("mixtral-8x7b").reduced()
    return widen_margins(jax.tree.map(np.asarray, jax_init_model(
        jax.random.PRNGKey(0), base)), base)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    vocab = get_config("mixtral-8x7b").reduced().vocab_size
    out = tmp_path_factory.mktemp("serve_ep") / "jax_serve_ep.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               SE_CAPTURE=CAPTURE, SE_LEGS=repr(LEGS),
               SE_SERVE_KW=repr(SERVE_KW), SE_NEW=repr(NEW),
               SE_STEP_S=repr(STEP_S),
               SE_BATCHES=repr([b.tolist() for b in _batches(vocab)]),
               SE_STEP_BATCHES=repr([b.tolist() for b in _batches(
                   vocab, STEP_S_TOKENS)[:2]]))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB),
                           str(out)], capture_output=True, text=True,
                          timeout=900, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _cfg(**moe_kw):
    base = get_config("mixtral-8x7b").reduced()
    return dataclasses.replace(base, moe=dataclasses.replace(base.moe,
                                                             **moe_kw))


def _scope():
    scope = {"np": np}
    exec(CAPTURE, scope)
    return scope


def test_prefill_replan_step_matches_meshed_jax(jax_ref, wide):
    from repro_torch.core.duplication import duplicate_experts_host
    from repro_torch.core.placement import stack_plans

    cfg = _cfg(duplication_slots=1)
    model = params_from_jax(wide, cfg, device="cpu")
    rt = Runtime(ep=True, ep_ranks=R)
    step = make_prefill_replan_step(cfg, rt)
    dist = np.array([0.55, 0.25, 0.15, 0.05])
    plan = stack_plans([duplicate_experts_host(np.roll(dist, l), R, 1, 4).plan
                        for l in range(cfg.num_layers)])
    ops.reset_launches()
    for k, b in enumerate(_batches(cfg.vocab_size, STEP_S_TOKENS)[:2]):
        ref = jax_ref["step"][k]
        cache = init_cache(cfg, rt, b.shape[0], b.shape[1], device="cpu")
        logits, _, stats, plan = step(model, torch.tensor(b), cache,
                                      plan=plan)
        for f in PLAN_FIELDS:
            t = getattr(plan, f)
            assert torch.is_tensor(t) and t.dtype == torch.int32
            np.testing.assert_array_equal(t.numpy(), ref["plan"][f],
                                          err_msg=f"{f}, call {k}")
        for name in ("expert_counts", "slot_counts", "dropped"):
            np.testing.assert_array_equal(stats[name].numpy(), ref[name],
                                          err_msg=f"{name}, call {k}")
        # the widened head's logits reach ~16, where a bf16 ulp is 0.125:
        # one ulp of the magnitude on top of the bf16 path's LOGIT_ATOL
        np.testing.assert_allclose(logits.float().numpy(), ref["logits"],
                                   atol=LOGIT_ATOL, rtol=2.0 ** -7)
        np.testing.assert_array_equal(logits.float().numpy().argmax(-1),
                                      ref["logits"].argmax(-1))
    # the chain bites: the in-graph plans replicate, and pairs drop
    assert (jax_ref["step"][0]["plan"]["n_replicas"] > 1).any()
    assert sum(int(r["dropped"].sum()) for r in jax_ref["step"]) > 0
    assert sum(ops.LAUNCHES.values()) == 0          # the CPU runs plain versions


@pytest.fixture(scope="module")
def port_runs(wide):
    """Every leg on the port's EP ServeEngine: {leg: (engine, record)}."""
    runs = {}
    pred = None
    for name, (serve_kw, moe_kw, with_pred) in LEGS.items():
        cfg = _cfg(**moe_kw)
        if with_pred and pred is None:
            tr = make_routing_trace(num_sequences=64, seq_len=32,
                                    vocab=cfg.vocab_size,
                                    num_experts=cfg.moe.num_experts,
                                    num_layers=cfg.num_layers, skew=1.5,
                                    seed=0)
            pred = ConditionalProbabilityModel(
                cfg.num_layers, cfg.moe.num_experts,
                cfg.vocab_size).fit(tr.experts, tr.tokens)
        eng = ServeEngine(cfg, params_from_jax(wide, cfg, device="cpu"),
                          ServeConfig(**dict(SERVE_KW, **serve_kw)),
                          ep_ranks=R, ep=True,
                          predictor=pred if with_pred else None)
        runs[name] = (eng, _scope()["serve_batches"](
            eng, _batches(cfg.vocab_size), NEW, STEP_S, PLAN_FIELDS))
    return runs


def _assert_plans_equal(a, b, what):
    assert (a is None) == (b is None), what
    if a is not None:
        for f in PLAN_FIELDS:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f"{f} {what}")


@pytest.mark.parametrize("leg", list(LEGS))
def test_ep_serve_engine_matches_meshed_jax_engine(jax_ref, port_runs, leg):
    eng, rec = port_runs[leg]
    ref = jax_ref[leg]
    assert rec["tokens"] == ref["tokens"]
    for k in range(BATCHES):
        _assert_plans_equal(rec["in_force"][k], ref["in_force"][k],
                            f"in force after batch {k}")
        assert rec["store_se"][k] == ref["store_se"][k], k
        assert rec["store_version"][k] == ref["store_version"][k], k
        assert rec["history"][k] == ref["history"][k], k
        assert rec["migration"][k] == ref["migration"][k], k
        assert rec["loads"][k] == ref["loads"][k], k
    assert [r[0] for r in rec["replans"]] == [r[0] for r in ref["replans"]]
    for (i, p, t), (_, q, u) in zip(rec["replans"], ref["replans"]):
        _assert_plans_equal(p, q, f"re-plan @ batch {i}")
        _assert_plans_equal(t, u, f"fill target @ batch {i}")

    # each leg runs the path it names
    hist = rec["history"]
    if leg in ("store", "sync", "reschedule", "both", "t2e"):
        assert eng._store is not None and eng._overlap == (leg != "sync")
        assert any(h.get("migration_entries", 0) > 0 for h in hist)
        assert eng._store.version.sum() > 0          # a fill committed
    else:
        assert eng._store is None
    if leg == "store":
        # staged: a fill spans more than one tick
        assert any(m.get("steps_to_adopt", 0) > 1 for m in rec["migration"])
    if leg == "in_graph":
        assert rec["replans"] == []
        assert all(torch.is_tensor(t) for t in eng._plan_stack)
        assert (rec["in_force"][-1]["n_replicas"] > 1).any()
    if leg in ("reschedule", "both"):
        assert all("resched_residual" in h for h in hist)
        assert eng._resched_stack is not None
    if leg == "none":
        assert eng.moe_cfg.duplication_slots == 0 and rec["replans"] == []


def test_store_leg_matches_gather_leg(port_runs):
    """Synchronous migration puts every plan in force at once, as the
    store-less gather path does: the same ids, drops and loads."""
    sync, gather = port_runs["sync"][1], port_runs["gather"][1]
    assert sync["tokens"] == gather["tokens"]
    assert sync["loads"] == gather["loads"]
    assert [h["dropped"] for h in sync["history"]] == \
        [h["dropped"] for h in gather["history"]]


@pytest.mark.parametrize("budget_slots", [None, 1, 2])
def test_ep_serve_engine_store_clamp_matches_jax(wide, budget_slots):
    """``store_hbm_budget_gb`` clamps an EP engine's replica slots as it
    clamps the meshed JAX engine's (layers x (E / R + D) entries per
    rank, the JAX experts cast to the port's bf16 so that an entry holds
    the same bytes); without EP (the JAX engine without a mesh) nothing is
    clamped."""
    from repro.runtime.cost import entry_bytes as jax_entry_bytes
    from repro.serve import ServeConfig as JaxServeConfig
    from repro.serve import ServeEngine as JaxServeEngine

    jcfg = jax_get_config("mixtral-8x7b").reduced()
    params = jax.tree.map(jnp.asarray, wide)
    params["layers"]["moe"]["experts"] = jax.tree.map(
        lambda w: w.astype(jnp.bfloat16), params["layers"]["moe"]["experts"])
    entry = jax_entry_bytes(params["layers"]["moe"]["experts"])
    e_loc = jcfg.moe.num_experts // R
    budget_gb = (0.0 if budget_slots is None else
                 jcfg.num_layers * (e_loc + budget_slots) * entry / 1e9)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, store_hbm_budget_gb=budget_gb))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    want = JaxServeEngine(jcfg, params, JaxServeConfig(dup_slots=4),
                          mesh=mesh, ep_ranks=R).moe_cfg.duplication_slots
    assert want == (4 if budget_slots is None else budget_slots)
    cfg = _cfg(store_hbm_budget_gb=budget_gb)
    eng = ServeEngine(cfg, params_from_jax(wide, cfg, device="cpu"),
                      ServeConfig(dup_slots=4), ep_ranks=R, ep=True)
    assert eng.moe_cfg.duplication_slots == want
    assert eng._store is not None
    assert eng._store.hbm_bytes_per_rank <= budget_gb * 1e9 or \
        budget_slots is None
    dense = ServeEngine(cfg, params_from_jax(wide, cfg, device="cpu"),
                        ServeConfig(dup_slots=4), ep_ranks=R)
    assert dense.moe_cfg.duplication_slots == 4 and dense._store is None


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------

def test_launch_serve_ep_on_cpu(capsys):
    from repro_torch.launch import serve as launch_serve

    ops.reset_launches()
    rc = launch_serve.main(["--arch", "mixtral-8x7b", "--reduced", "--device",
                            "cpu", "--data-mesh", "1", "--model-mesh", "4",
                            "--requests", "5", "--batch", "2", "--seq", "16",
                            "--new-tokens", "4"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "served 5 requests in 3 batches on cpu" in out
    assert "EP over 4 ranks" in out
    assert sum(ops.LAUNCHES.values()) == 0


@pytest.mark.parametrize("argv,match", [
    (["--data-mesh", "2", "--model-mesh", "4"],
     "a data axis needs --backend nccl or gloo"),
    (["--data-mesh", "1", "--model-mesh", "4", "--seq", "18"], "split"),
])
def test_launch_serve_rejects_what_one_card_cannot_run(argv, match):
    from repro_torch.launch import serve as launch_serve

    with pytest.raises(ValueError, match=match):
        launch_serve.main(["--arch", "mixtral-8x7b", "--reduced", "--device",
                           "cpu", "--requests", "1", "--batch", "1"] + argv)
