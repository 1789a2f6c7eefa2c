"""The port's ``ContinuousEngine`` with the replica store against the JAX
package's engine, on the CPU.

Store engine (``ep=True``, ``replica_impl="store"``) against the meshed
JAX ``ContinuousEngine`` in store mode. The JAX side needs four devices:
it runs in one subprocess with ``--xla_force_host_platform_device_count=4``
on a ``(1, 4)`` mesh of ``AxisType.Auto`` axes, as in
``tests/test_torch_ep_serve.py`` (``test_replica_runtime.py``'s store
engine test uses jax's default ``Explicit`` axes, which the JAX model
refuses). Both serve the same five staggered requests on the same bridged
reduced-Mixtral weights with ``dist_only``, one replica slot per rank,
``predict_interval=4``, ``prefetch_lead=2`` and ``migration_gate=False``
(the gate compares predicted gains with wall-clock step times, which differ
between the two frameworks; it is tested on its own below), once with
overlapped (layer-staged) migration and once without. The JAX side's
expert weights are cast to bf16 once, the port's storage dtype: the JAX
model casts them to bf16 at every use, so its outputs do not change, and
both stores count the same bytes per entry.

The JAX engine's runtime does not set ``use_kernel``, so it rounds bf16 at
other places than the port. Per iteration these must be equal, exactly:
the generated lengths, the plan in force and every re-plan's plan, the
pairs dropped at capacity, the migration counters (replans, commits,
pre-begins, cancels, planned and moved bytes) and the store's slot map and
versions. Comparisons stop at the first iteration that produced a
differing token, whose producing JAX logits must then have a top-2 margin
under two bf16 ulps (``_near_tie``), or at the first iteration whose
dropped pairs differ by one or two, whichever comes first: a route near
tie in the two frameworks' bf16 hidden states moves a pair of a prefill
between slots (this trace's fifth prefill holds one; the model-level
comparison of ``tests/test_torch_ep_serve.py`` describes the same effect),
and what follows is served on other hidden states.

The gate alone: both engines on one set of estimator counts and a hand-set
``_recent_step_s``, over a grid of targets, stalls and step times, accept
the same re-plans, with equal hidden-stall estimates and chunk budgets.

Store-less engine (``ep=False``) against the meshless JAX engine in this
process, on the same trace: equal planned bytes, modelled stall and
re-plans per iteration (up to a near tie as above), and hidden plus
exposed stall equal to the stall (to a relative 1e-12: the two are sums
of floats in different orders).
"""

import dataclasses
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

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.core.duplication import \
    duplicate_experts_host as jax_dup  # noqa: E402
from repro.core.placement import stack_plans as jax_stack  # noqa: E402
from repro.data.synthetic import skewed_distribution  # noqa: E402
from repro.models.transformer import init_model as jax_init_model  # noqa: E402
from repro.serve import ContinuousConfig as JaxCCfg  # noqa: E402
from repro.serve import ContinuousEngine as JaxEngine  # noqa: E402
from repro.serve import ServeRequest as JaxRequest  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.duplication import duplicate_experts_host  # noqa: E402
from repro_torch.core.placement import stack_plans  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import (ContinuousConfig, ContinuousEngine,  # noqa: E402
                               ServeRequest)

ROOT = Path(__file__).resolve().parents[1]
R = 4
PLAN_FIELDS = ("n_replicas", "replica_table", "pool_expert", "pool_sel")
COUNTERS = ("replans", "commits", "prebegun", "cancelled", "planned_bytes",
            "bytes_moved", "rejected")
ENGINE_KW = dict(max_slots=4, prefill_len=64, block_size=8, max_len=128,
                 strategy="dist_only", predict_interval=4, dup_slots=1,
                 prefetch_lead=2, migration_gate=False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced model's operations are tiny: one intra-op thread runs
    them as fast as many, and keeps this file from oversubscribing the
    cores when test workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requests(vocab):
    rng = np.random.default_rng(1)
    return [dict(rid=i, tokens=rng.integers(0, vocab, n).astype(np.int32),
                 max_new_tokens=12, arrival=float(i))
            for i, n in enumerate((5, 17, 11, 30, 9))]


# Serves requests one iteration per virtual second and records, per
# iteration: generated lengths, dropped pairs, the logits that produced
# each new token, the plan in force, the migration counters and the
# store's slot map and versions; and every re-plan's plan. Executed by the
# JAX subprocess and here (``to_np`` converts the framework's logits).
CAPTURE = '''
def serve_capture(eng, reqs, to_np, plan_fields, warmup=True):
    if warmup:
        eng.warmup()
    rec = {"plans": [], "prefill": {}, "decode": [], "lens": [],
           "dropped": [], "slot": {}, "in_force": [], "mig": [],
           "store_se": [], "store_version": []}
    replan = eng.replan
    def recording_replan():
        out = replan()
        rec["plans"].append((eng.iterations, {f: np.asarray(getattr(
            eng._plan_stack, f)).copy() for f in plan_fields}))
        return out
    eng.replan = recording_replan
    last = {}
    pf, dec = eng._prefill_fn, eng._decode_fn
    def prefill(*a, **k):
        out = pf(*a, **k)
        last.setdefault("prefill", []).append(to_np(out[1])[0, -1])
        return out
    def decode(*a, **k):
        out = dec(*a, **k)
        last["decode"] = to_np(out[1])[:, -1]
        return out
    eng._prefill_fn, eng._decode_fn = prefill, decode
    for r in reqs:
        eng.submit(r)
    it = 0
    while eng.has_work() and it < 100:
        last.clear()
        before = eng.metrics.summary()["dropped_tokens"]
        ev = eng.step(float(it))
        for r, lg in zip(ev.prefilled, last.get("prefill", [])):
            rec["prefill"][r.rid] = lg
            rec["slot"][r.rid] = r.slot
        rec["decode"].append(last.get("decode"))
        rec["lens"].append([len(r.generated) for r in reqs])
        rec["dropped"].append(eng.metrics.summary()["dropped_tokens"] - before)
        rec["in_force"].append({f: np.asarray(getattr(
            eng._plan_stack, f)).copy() for f in plan_fields})
        rec["mig"].append(dict(eng.metrics.migration))
        if eng._store is not None:
            rec["store_se"].append(np.asarray(eng._store.slot_experts).copy())
            rec["store_version"].append(np.asarray(eng._store.version).copy())
        it += 1
    rec["slots"] = [rec["slot"][r.rid] for r in reqs]
    rec["tokens"] = [list(r.generated) for r in reqs]
    return rec
'''

SUB = '''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, pickle
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs.registry import get_config
from repro.models.transformer import init_model
from repro.serve import ContinuousConfig, ContinuousEngine, ServeRequest

out_path, R = sys.argv[1], 4
mesh = jax.make_mesh((1, R), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
cfg = get_config("mixtral-8x7b").reduced()
params = init_model(jax.random.PRNGKey(0), cfg)
params["layers"]["moe"]["experts"] = jax.tree.map(
    lambda w: w.astype(jnp.bfloat16), params["layers"]["moe"]["experts"])
exec(os.environ["ST_CAPTURE"])
kw = eval(os.environ["ST_ENGINE_KW"])
res = {}
for overlap in (True, False):
    eng = ContinuousEngine(cfg, params, ContinuousConfig(
        **kw, overlap_migration=overlap), mesh=mesh, ep_ranks=R)
    assert eng._store is not None
    reqs = [ServeRequest(**dict(r, tokens=np.asarray(r["tokens"], np.int32)))
            for r in eval(os.environ["ST_REQUESTS"])]
    with mesh:
        rec = serve_capture(eng, reqs, lambda a: np.asarray(a, np.float32),
                            ("n_replicas", "replica_table", "pool_expert",
                             "pool_sel"))
    rec["entry_bytes"] = eng._store.entry_bytes
    res[overlap] = rec
with open(out_path, "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    import pickle
    vocab = get_config("mixtral-8x7b").reduced().vocab_size
    out = tmp_path_factory.mktemp("store") / "jax_store.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               ST_CAPTURE=CAPTURE, ST_ENGINE_KW=repr(ENGINE_KW),
               ST_REQUESTS=repr([dict(r, tokens=r["tokens"].tolist())
                                 for r in _requests(vocab)]))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB),
                           str(out)], capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def jax_params():
    jcfg = jax_get_config("mixtral-8x7b").reduced()
    return jax.tree.map(np.asarray, jax_init_model(jax.random.PRNGKey(0),
                                                   jcfg))


def _port_model(jax_params):
    cfg = get_config("mixtral-8x7b").reduced()
    return cfg, params_from_jax(jax_params, cfg, device="cpu")


def _near_tie(logits) -> bool:
    """Top-2 margin under two bf16 ulps of the top logit."""
    a, b = np.sort(logits)[-2:][::-1]
    ulp = 2.0 ** (np.floor(np.log2(max(abs(a), 1e-30))) - 7)
    return a - b < 2 * ulp


def _serve(eng, vocab, to_np, warmup=True):
    scope = {"np": np}
    exec(CAPTURE, scope)
    reqs = [ServeRequest(**r) if isinstance(eng, ContinuousEngine)
            else JaxRequest(**r) for r in _requests(vocab)]
    return scope["serve_capture"](eng, reqs, to_np, PLAN_FIELDS, warmup)


def _compared_iterations(ref, rec) -> int:
    """Iterations whose records must agree: all of them, or those before
    the first that dropped one or two pairs fewer or more than the JAX
    engine, or that produced the first differing token, which must come
    from near-tie JAX logits."""
    n = min(len(ref["dropped"]), len(rec["dropped"]))
    moved = next((k for k in range(n)
                  if rec["dropped"][k] != ref["dropped"][k]), n)
    if moved < n:
        assert abs(rec["dropped"][moved] - ref["dropped"][moved]) <= 2, moved
        return moved
    for rid, (a, b) in enumerate(zip(ref["tokens"], rec["tokens"])):
        if list(a) == list(b):
            continue
        i = next((n for n, (x, y) in enumerate(zip(a, b)) if x != y),
                 min(len(a), len(b)))
        it = next(k for k, row in enumerate(ref["lens"]) if row[rid] > i)
        lg = (ref["prefill"][rid] if i == 0
              else ref["decode"][it][ref["slots"][rid]])
        assert _near_tie(lg), f"rid {rid} token {i} differs and is no near tie"
        return it
    np.testing.assert_array_equal(np.asarray(rec["lens"]),
                                  np.asarray(ref["lens"]))
    return len(rec["lens"])


def _assert_plans_equal(a, b, msg):
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f"{f} {msg}")


# --------------------------------------------------------------------------
# the store engine against the meshed JAX store engine
# --------------------------------------------------------------------------

@pytest.mark.parametrize("overlap", [True, False])
def test_store_engine_matches_meshed_jax_store_engine(jax_ref, jax_params,
                                                      overlap):
    cfg, model = _port_model(jax_params)
    ref = jax_ref[overlap]
    eng = ContinuousEngine(cfg, model, ContinuousConfig(
        **ENGINE_KW, overlap_migration=overlap), ep_ranks=R, ep=True)
    assert eng._store is not None and eng.moe_cfg.replica_impl == "store"
    assert eng._store.entry_bytes == ref["entry_bytes"]
    ops.reset_launches()
    rec = _serve(eng, cfg.vocab_size, lambda t: t.float().numpy())
    assert sum(ops.LAUNCHES.values()) == 0          # plain versions on the CPU
    stop = _compared_iterations(ref, rec)
    for it in range(stop):
        _assert_plans_equal(rec["in_force"][it], ref["in_force"][it],
                            f"in force @ {it}")
        for k in COUNTERS:
            assert rec["mig"][it][k] == ref["mig"][it][k], (k, it)
        np.testing.assert_array_equal(rec["store_se"][it],
                                      ref["store_se"][it], err_msg=str(it))
        np.testing.assert_array_equal(rec["store_version"][it],
                                      ref["store_version"][it],
                                      err_msg=str(it))
    np.testing.assert_array_equal(rec["dropped"][:stop], ref["dropped"][:stop])
    plans = [(i, p) for i, p in rec["plans"] if i <= stop]
    ref_plans = [(i, p) for i, p in ref["plans"] if i <= stop]
    assert [i for i, _ in plans] == [i for i, _ in ref_plans]
    for (i, p), (_, q) in zip(plans, ref_plans):
        _assert_plans_equal(p, q, f"re-plan @ {i}")
    # the comparison bites: replans, committed fills moving bytes, and with
    # overlap a pre-begun fill, all within the compared iterations
    last = rec["mig"][stop - 1]
    assert last["replans"] >= 2 and last["commits"] >= (2 if overlap else 1)
    assert last["bytes_moved"] > 0 and last["rejected"] == 0
    assert (last["prebegun"] >= 1) == overlap
    assert rec["store_version"][stop - 1].max() >= 1
    # live rows: every live replica slot's row holds its expert's home row
    store = eng._store
    rows = store.slot_rows()
    for l in range(cfg.num_layers):
        for s in store.replica_slots():
            e = store.slot_experts[l, s]
            if e >= 0:
                for w in store.weights.values():
                    assert torch.equal(w[l][rows[l, s]], w[l][e])


def test_store_engine_reads_replica_rows(jax_params):
    """A replica slot computes pairs on the main trace, and its store row
    is what it reads: zeroing every live replica row changes the tokens."""
    outs = []
    for zero in (False, True):
        cfg, model = _port_model(jax_params)
        eng = ContinuousEngine(cfg, model, ContinuousConfig(**ENGINE_KW),
                               ep_ranks=R, ep=True)
        if zero:
            real = eng._tick_migration

            def tick_then_zero(real=real, eng=eng):
                real()
                st = eng._store
                rows = st.slot_rows()
                for l in range(cfg.num_layers):
                    for s in st.replica_slots():
                        for w in st.weights.values():
                            w[l][rows[l, s]].zero_()
            eng._tick_migration = tick_then_zero
        rec = _serve(eng, cfg.vocab_size, lambda t: t.float().numpy())
        e_loc = cfg.moe.num_experts // R
        sc = eng.slot_counts.reshape(cfg.num_layers, R, -1)
        outs.append((rec["tokens"], int(sc[:, :, e_loc:].sum())))
    assert outs[0][1] > 0
    assert outs[0][0] != outs[1][0]


def test_migration_gate_matches_jax(jax_params):
    """``_migration_accept`` and its inputs on both engines, with one set
    of estimator counts and ``_recent_step_s`` set by hand."""
    cfg, model = _port_model(jax_params)
    jcfg = jax_get_config("mixtral-8x7b").reduced()
    params = jax.tree.map(jnp.asarray, jax_params)
    params["layers"]["moe"]["experts"] = jax.tree.map(
        lambda w: w.astype(jnp.bfloat16), params["layers"]["moe"]["experts"])
    kw = dict(ENGINE_KW, migration_gate=True)
    t_eng = ContinuousEngine(cfg, model, ContinuousConfig(**kw), ep_ranks=R,
                             ep=True)
    j_eng = JaxEngine(jcfg, params, JaxCCfg(**kw), ep_ranks=R)
    assert t_eng._entry_bytes == j_eng._entry_bytes
    E = cfg.moe.num_experts
    rng = np.random.default_rng(5)
    counts = rng.integers(0, 50, (cfg.num_layers, E)).astype(np.float64)
    counts[:, 0] += 200                                # one hot expert
    t_eng.estimator.update(counts)
    j_eng.estimator.update(counts)
    t_eng._current_plan()
    j_eng._current_plan()
    accepted = set()
    for seed in range(6):
        dists = [skewed_distribution(E, 1.2 + 0.6 * seed + l, rng)
                 for l in range(cfg.num_layers)]
        t_target = stack_plans([duplicate_experts_host(d, R, 1, 4).plan
                                for d in dists])
        j_target = jax_stack([jax_dup(d, R, 1, 4).plan for d in dists])
        for step_s in (0.0, 1e-4, 2e-3, 0.05):
            for window in (None, 1e-3, 0.04):
                for e in (t_eng, j_eng):
                    e._recent_step_s = step_s
                    e._serve_ema = type(e._serve_ema)()
                    if window is not None:
                        e._serve_ema.update("decode", window)
                assert t_eng._overlap_budget() == j_eng._overlap_budget()
                for entries in (1, 3, 8):
                    stall = entries * t_eng._entry_bytes / 64e9
                    assert t_eng._hidden_estimate(stall, entries) == \
                        j_eng._hidden_estimate(stall, entries)
                    for scale in (0.5, 1.0, 40.0):
                        a = t_eng._migration_accept(scale * stall, t_target,
                                                    entries)
                        b = j_eng._migration_accept(scale * stall, j_target,
                                                    entries)
                        assert a == b, (seed, step_s, window, entries, scale)
                        accepted.add(a)
    assert accepted == {True, False}                   # the grid bites


# --------------------------------------------------------------------------
# the store-less engine against the meshless JAX engine
# --------------------------------------------------------------------------

def test_storeless_engine_costs_replans_as_meshless_jax(jax_params):
    cfg, model = _port_model(jax_params)
    jcfg = jax_get_config("mixtral-8x7b").reduced()
    params = jax.tree.map(jnp.asarray, jax_params)
    params["layers"]["moe"]["experts"] = jax.tree.map(
        lambda w: w.astype(jnp.bfloat16), params["layers"]["moe"]["experts"])
    j_eng = JaxEngine(jcfg, params, JaxCCfg(**ENGINE_KW), ep_ranks=R)
    ref = _serve(j_eng, cfg.vocab_size, lambda a: np.asarray(a, np.float32),
                 warmup=False)
    t_eng = ContinuousEngine(cfg, model, ContinuousConfig(**ENGINE_KW),
                             ep_ranks=R, ep=False)
    assert t_eng._store is None and j_eng._store is None
    rec = _serve(t_eng, cfg.vocab_size, lambda t: t.float().numpy())
    stop = _compared_iterations(ref, rec)
    for it in range(stop):
        _assert_plans_equal(rec["in_force"][it], ref["in_force"][it],
                            f"in force @ {it}")
        for k in ("planned_bytes", "stall_s", "replans"):
            assert rec["mig"][it][k] == ref["mig"][it][k], (k, it)
    s = t_eng.metrics.summary()
    assert s["migration_planned_bytes"] > 0 and s["migration_replans"] >= 2
    assert s["migration_bytes_moved"] == 0 and s["migration_commits"] == 0
    assert s["migration_hidden_s"] + s["migration_exposed_s"] == \
        pytest.approx(s["migration_stall_us"] * 1e-6, rel=1e-12)


# --------------------------------------------------------------------------
# replica-slot budget and quota
# --------------------------------------------------------------------------

@pytest.mark.parametrize("budget_gb", [0.0, 0.001, 0.002, 0.0025, 1.0])
def test_store_budget_clamp_matches_jax(jax_params, budget_gb):
    """``store_hbm_budget_gb`` clamps the EP engine's replica slots as
    ``core.placement.clamp_dup_slots`` does in JAX (the JAX formula:
    layers x (E / R + D) entries per rank); a store-less engine is never
    clamped, as a meshless JAX engine is not."""
    from repro.core.placement import clamp_dup_slots as jax_clamp
    from repro.runtime.cost import entry_bytes as jax_entry_bytes

    cfg, model = _port_model(jax_params)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, store_hbm_budget_gb=budget_gb))
    experts = {k: v.astype(np.float32).astype(jnp.bfloat16)
               for k, v in jax_params["layers"]["moe"]["experts"].items()}
    want = jax_clamp(cfg.moe.num_experts, R, 3,
                     entry_bytes=jax_entry_bytes(experts),
                     num_layers=cfg.num_layers,
                     hbm_budget_bytes=budget_gb * 1e9)
    assert want == {0.0: 3, 0.001: 0, 0.002: 1, 0.0025: 2, 1.0: 3}[budget_gb]
    kw = dict(ENGINE_KW, dup_slots=3)
    eng = ContinuousEngine(cfg, model, ContinuousConfig(**kw), ep_ranks=R,
                           ep=True)
    assert eng.moe_cfg.duplication_slots == want == eng.dup_slot_quota
    assert (eng._store is None) == (want == 0)
    if eng._store is not None:
        assert eng._store.hbm_bytes_per_rank <= budget_gb * 1e9 or \
            budget_gb == 0
    dense = ContinuousEngine(cfg, _port_model(jax_params)[1],
                             ContinuousConfig(**kw), ep_ranks=R, ep=False)
    assert dense.moe_cfg.duplication_slots == 3 and dense._store is None


@pytest.mark.parametrize("quota", [0, 1, 2])
def test_quota_replan_matches_jax(jax_params, quota):
    """``set_dup_slot_quota`` then ``replan``: the quota-limited plan at the
    full slot geometry equals the JAX engine's, and the store engine
    migrates toward it (a shrink moves no bytes)."""
    cfg, model = _port_model(jax_params)
    jcfg = jax_get_config("mixtral-8x7b").reduced()
    kw = dict(ENGINE_KW, dup_slots=2, overlap_migration=False)
    t_eng = ContinuousEngine(cfg, model, ContinuousConfig(**kw), ep_ranks=R,
                             ep=True)
    j_eng = JaxEngine(jcfg, jax.tree.map(jnp.asarray, jax_params),
                      JaxCCfg(**kw), ep_ranks=R)
    counts = np.array([[90.0, 10.0, 30.0, 5.0], [5.0, 60.0, 20.0, 40.0]])
    for e in (t_eng, j_eng):
        e.estimator.update(counts)
        e._current_plan()
        e.replan()                                 # the full-quota plan
        e.set_dup_slot_quota(quota)
        assert e.dup_slot_quota == quota
    t_plan, j_plan = t_eng.replan(), j_eng.replan()
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(getattr(t_plan, f),
                                      np.asarray(getattr(j_plan, f)))
    assert int((t_plan.n_replicas - 1).sum()) <= quota * R
    # the first re-plan filled and committed; the quota one only shrinks or
    # keeps the replica sets, which moves nothing and swaps at once
    s = t_eng.metrics.summary()
    assert s["migration_commits"] == 1 and s["migration_replans"] == 2
    assert t_eng._plan_stack is t_plan
