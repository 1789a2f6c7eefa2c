"""The port's ``ContinuousEngine`` with an online GPS controller, on the
CPU.

Against the JAX engine: the mesh-less JAX ``ContinuousEngine`` with an
``OnlineGPSController`` and the port's (``ep=False``), each with a
controller on the port's H100 preset (the JAX one a
``repro.core.simulator.HardwareConfig`` with the same numbers), serve a
short ``skew_shift_trace`` (8 requests) on the port's reduced-Mixtral
weights (bridged to the JAX tree with ``params_to_jax`` and cast to the
JAX init's dtypes), one iteration per 0.25 virtual seconds, with
``overlap_migration=False`` (the modelled hidden share then needs no wall
clock: it is 0) and a controller that decides every 2 iterations with the
reduced model's skew cap mapped onto the full model's. Per iteration these
must be equal: the estimator's counts, the generated lengths, the
strategy and ``predict_interval`` in force, the plan in force, the
migration counters, every re-plan's plan and every decision (each field)
and audit record. The JAX engine runs in a subprocess with
``--xla_allow_excess_precision=false`` and its expert weights cast to
bf16 once (the port's storage dtype; the JAX model casts them to bf16 at
every use, so its outputs do not change, and both engines count the same
bytes per entry): under jit XLA otherwise keeps excess precision inside
fusions and flips near-tie routes. Comparisons stop at the first
iteration whose counts or lengths differ; the compared prefix must hold
at least 3 decisions and a switch each way.

The port alone, on the store engine (``ep=True``): the hidden migration
bytes the controller is fed, against ``_chunk_stall_split`` (and the
store-less engine's against ``_hidden_estimate``); a switch to "none"
with a fill in flight cancels it and adopts the identity plan for good;
a re-plan that restarts a fill in flight replaces the fill's target; the
engine accepts a controller that may choose Token-to-Expert and one
offered every balancing lever (which enables the token scheduler);
``_hw()`` is the controller's hardware.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from repro_torch.bridge import params_to_jax  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.placement import stack_plans  # noqa: E402
from repro_torch.core.duplication import duplicate_experts_host  # noqa: E402
from repro_torch.core.simulator import A100_PCIE, H100_SXM_NVLINK  # noqa: E402
from repro_torch.models.transformer import init_model  # noqa: E402
from repro_torch.serve import (ContinuousConfig, ContinuousEngine,  # noqa: E402
                               ControllerConfig, Decision,
                               OnlineGPSController)
from repro_torch.serve.engine import _chunk_stall_split  # noqa: E402
from repro_torch.workloads import (skew_shift_trace,  # noqa: E402
                                   to_serve_requests)

ROOT = Path(__file__).resolve().parents[1]
PLAN_FIELDS = ("n_replicas", "replica_table", "pool_expert", "pool_sel")
ENGINE_KW = dict(max_slots=4, prefill_len=32, block_size=8, max_len=64,
                 strategy="dist_only", predict_interval=2,
                 overlap_migration=False)
TRACE_KW = dict(horizon=8.0, rate=1.5, seed=0)
# reduced Mixtral: 4 experts, top-2 (skew cap 2); the full model's cap is 4
CONTROLLER_KW = dict(window_iters=2, patience=1, min_saving=0.55,
                     skew_cap_observed=2.0, skew_cap_target=4.0)
H100_ARGS = (H100_SXM_NVLINK.name, H100_SXM_NVLINK.num_devices,
             H100_SXM_NVLINK.peak_flops, H100_SXM_NVLINK.hbm_bw,
             H100_SXM_NVLINK.link_bw)

# Serves the trace with a frozen clock per iteration (idle gaps
# fast-forward to the next arrival) and records per iteration what the
# engine and its controller did. Executed by the JAX subprocess and here.
CAPTURE = '''
def serve_capture(eng, reqs, plan_fields):
    import dataclasses, json
    eng.warmup()
    rec = {"plans": [], "counts": [], "lens": [], "strategy": [],
           "interval": [], "in_force": [], "mig": [], "decisions": []}
    replan = eng.replan
    def recording_replan():
        out = replan()
        rec["plans"].append((eng.iterations, {f: np.asarray(getattr(
            eng._plan_stack, f)).copy() for f in plan_fields}))
        return out
    eng.replan = recording_replan
    for r in reqs:
        eng.submit(r)
    now = 0.0
    while eng.has_work() and len(rec["lens"]) < 200:
        sched = eng.scheduler
        if (not sched.active_slots and sched.waiting
                and sched.waiting[0].arrival > now):
            now = sched.waiting[0].arrival
        ev = eng.step(now)
        now += 0.25
        d = ev.decision
        if d is not None:
            d = {f.name: getattr(d, f.name) for f in dataclasses.fields(d)
                 if f.name not in ("recommended", "report")}
            d["recommended"] = [str(ev.decision.recommended),
                                ev.decision.recommended.lever]
        rec["decisions"].append(d)
        rec["counts"].append(eng.estimator.counts.copy())
        rec["lens"].append([len(r.generated) for r in reqs])
        rec["strategy"].append(eng.strategy)
        rec["interval"].append(eng.predict_interval)
        rec["in_force"].append({f: np.asarray(getattr(
            eng._plan_stack, f)).copy() for f in plan_fields})
        rec["mig"].append({k: eng.metrics.migration[k] for k in (
            "replans", "planned_bytes", "stall_s", "hidden_s", "exposed_s")})
    rec["audit"] = json.loads(json.dumps(eng.controller.audit.to_obj()))
    rec["tokens"] = [list(r.generated) for r in reqs]
    return rec
'''

SUB = '''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_allow_excess_precision=false"
import pickle
import numpy as np
import jax, jax.numpy as jnp
from repro.configs.registry import get_config
from repro.core.simulator import HardwareConfig
from repro.models.transformer import init_model
from repro.serve import (ContinuousConfig, ContinuousEngine,
                         ControllerConfig, OnlineGPSController)
from repro.workloads import skew_shift_trace, to_serve_requests

cfg = get_config("mixtral-8x7b").reduced()
with open(sys.argv[2], "rb") as f:                   # the port's weights
    host = pickle.load(f)
shapes = jax.eval_shape(lambda: init_model(jax.random.PRNGKey(0), cfg))
params = jax.tree.map(lambda s, a: jnp.asarray(a, s.dtype), shapes, host)
params["layers"]["moe"]["experts"] = jax.tree.map(
    lambda w: w.astype(jnp.bfloat16), params["layers"]["moe"]["experts"])
exec(os.environ["GS_CAPTURE"])
hw = HardwareConfig(*eval(os.environ["GS_HW"]), mxu_util=0.45)
ctl = OnlineGPSController(
    get_config("mixtral-8x7b"),
    ControllerConfig(hardware=hw, **eval(os.environ["GS_CONTROLLER"])),
    predictor_available=False)
eng = ContinuousEngine(cfg, params, ContinuousConfig(
    **eval(os.environ["GS_ENGINE"])), ep_ranks=4, controller=ctl)
reqs = to_serve_requests(skew_shift_trace(cfg.vocab_size,
                                          **eval(os.environ["GS_TRACE"])))
rec = serve_capture(eng, reqs, ("n_replicas", "replica_table",
                                "pool_expert", "pool_sel"))
rec["entry_bytes"] = eng._entry_bytes
with open(sys.argv[1], "wb") as f:
    pickle.dump(rec, f)
'''


def _model():
    cfg = get_config("mixtral-8x7b").reduced()
    return cfg, init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced model's operations are tiny: one intra-op thread runs
    them as fast as many, and keeps this file from oversubscribing the
    cores when test workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX engine's record, serving the port's weights (bridged)."""
    import pickle
    tmp = tmp_path_factory.mktemp("gps")
    out, weights = tmp / "jax_gps.pkl", tmp / "weights.pkl"
    with open(weights, "wb") as f:
        pickle.dump(params_to_jax(_model()[1]), f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               GS_CAPTURE=CAPTURE, GS_HW=repr(H100_ARGS),
               GS_CONTROLLER=repr(CONTROLLER_KW), GS_ENGINE=repr(ENGINE_KW),
               GS_TRACE=repr(TRACE_KW))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB),
                           str(out), str(weights)], capture_output=True,
                          text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _controller(**kw):
    return OnlineGPSController(
        get_config("mixtral-8x7b"),
        ControllerConfig(**dict(dict(hardware=H100_SXM_NVLINK,
                                     **CONTROLLER_KW), **kw)),
        predictor_available=False)


def _port_serve():
    cfg, model = _model()
    eng = ContinuousEngine(cfg, model, ContinuousConfig(**ENGINE_KW),
                           ep_ranks=4, controller=_controller())
    scope = {"np": np}
    exec(CAPTURE, scope)
    reqs = to_serve_requests(skew_shift_trace(cfg.vocab_size, **TRACE_KW))
    return eng, scope["serve_capture"](eng, reqs, PLAN_FIELDS)


def test_engine_with_controller_matches_jax_engine(jax_ref):
    eng, rec = _port_serve()
    ref = jax_ref
    assert eng._entry_bytes == ref["entry_bytes"]
    n = min(len(rec["lens"]), len(ref["lens"]))
    stop = next((k for k in range(n)
                 if not np.array_equal(rec["counts"][k], ref["counts"][k])
                 or rec["lens"][k] != ref["lens"][k]), n)
    if stop == n:
        assert len(rec["lens"]) == len(ref["lens"])
        assert rec["tokens"] == ref["tokens"]
    for k in range(stop):
        assert rec["strategy"][k] == ref["strategy"][k], k
        assert rec["interval"][k] == ref["interval"][k], k
        assert rec["decisions"][k] == ref["decisions"][k], k
        assert rec["mig"][k] == ref["mig"][k], k
        for f in PLAN_FIELDS:
            np.testing.assert_array_equal(rec["in_force"][k][f],
                                          ref["in_force"][k][f],
                                          err_msg=f"{f} @ {k}")
    plans = [(i, p) for i, p in rec["plans"] if i <= stop]
    ref_plans = [(i, p) for i, p in ref["plans"] if i <= stop]
    assert [i for i, _ in plans] == [i for i, _ in ref_plans]
    for (i, p), (_, q) in zip(plans, ref_plans):
        for f in PLAN_FIELDS:
            np.testing.assert_array_equal(p[f], q[f], err_msg=f"{f} @ {i}")
    decided = [d for d in rec["decisions"][:stop] if d is not None]
    assert rec["audit"][:len(decided)] == ref["audit"][:len(decided)]
    # the compared prefix bites: decisions, a switch each way, re-plans
    # that replicate and move bytes the controller is charged for
    assert len(decided) >= 3
    assert any(d["switched"] and d["strategy"] == "none" for d in decided)
    assert any(d["switched"] and d["strategy"] == "dist_only"
               for d in decided)
    assert any(p["n_replicas"].max() > 1 for _, p in plans)
    assert any(r["migration_bytes"] > 0 for r in rec["audit"][:len(decided)])


# --------------------------------------------------------------------------
# the port alone: the store engine's controller hook
# --------------------------------------------------------------------------

STORE_KW = dict(max_slots=4, prefill_len=32, block_size=8, max_len=64,
                strategy="dist_only", predict_interval=2, dup_slots=1,
                migrate_chunk=2)
# a link so slow that one 2-entry chunk (~400 s of wire) outlasts any CPU
# step: fills span steps at one chunk per step, and a step hides a real
# fraction of its chunk, however loaded the machine is
SLOW = A100_PCIE.with_(name="slow", link_bw=2e3)


def _store_engine(controller=None, **kw):
    cfg, model = _model()
    return ContinuousEngine(cfg, model,
                            ContinuousConfig(**dict(STORE_KW, **kw)),
                            ep_ranks=4, ep=True, controller=controller)


def _requests(vocab):
    return to_serve_requests(skew_shift_trace(vocab, horizon=6.0, rate=2.0,
                                              seed=1))


def _identity(eng):
    return int(np.asarray(eng._plan_stack.n_replicas).max()) == 1


def test_hidden_bytes_fed_to_the_controller():
    # stays on dist_only: no saving threshold, no stall charged
    ctl = _controller(hardware=SLOW, min_saving=0.0, migration_aware=False)
    eng = _store_engine(ctl)
    assert eng._store is not None and eng._overlap and eng._hw() is SLOW
    ticks, fed = [], []
    tick = eng._executor.tick

    def recording_tick(budget=None):
        window = eng._overlap_window_s()
        commit, moved = tick(budget)
        ticks.append((moved, window))
        return commit, moved
    eng._executor.tick = recording_tick
    observe = ctl.observe

    def recording_observe(counts, now, **kw):
        fed.append(kw)
        return observe(counts, now, **kw)
    ctl.observe = recording_observe
    eng.warmup()
    for r in _requests(eng.cfg.vocab_size):
        eng.submit(r)
    now, checked = 0.0, 0
    while eng.has_work():
        ticks.clear()
        eng.step(now)
        now += 0.25
        moved = sum(m for m, _ in ticks)
        want = 0.0
        for m, window in ticks:
            if m:
                hidden, exposed = _chunk_stall_split(m, window, SLOW, True)
                want += m * hidden / (hidden + exposed)
        assert eng._step_migration_bytes == moved
        np.testing.assert_allclose(eng._step_migration_hidden_bytes, want,
                                   rtol=1e-12, atol=0)
        assert fed[-1]["migration_bytes"] == moved
        assert fed[-1]["migration_hidden_bytes"] == \
            eng._step_migration_hidden_bytes
        assert fed[-1]["dropped_tokens"] == eng._step_dropped
        checked += 0.0 < want < moved
    # some steps hid part, not all, of what they moved
    assert checked >= 1
    assert eng.metrics.migration["commits"] >= 1
    assert len(ctl.decisions) >= 3


def test_storeless_hidden_bytes_follow_the_hidden_estimate():
    ctl = _controller(hardware=SLOW, min_saving=0.0, migration_aware=False)
    cfg, model = _model()
    eng = ContinuousEngine(cfg, model, ContinuousConfig(
        **dict(ENGINE_KW, overlap_migration=True)), ep_ranks=4,
        controller=ctl)
    assert eng._store is None and eng._overlap
    est = []
    hidden_estimate = eng._hidden_estimate

    def recording(stall_s, entries):
        out = hidden_estimate(stall_s, entries)
        est.append((stall_s, entries, out))
        return out
    eng._hidden_estimate = recording
    eng.warmup()
    for r in _requests(cfg.vocab_size):
        eng.submit(r)
    now, seen = 0.0, 0
    while eng.has_work():
        est.clear()
        eng.step(now)
        now += 0.25
        want = sum(n * eng._entry_bytes * h / s for s, n, h in est if s > 0)
        np.testing.assert_allclose(eng._step_migration_hidden_bytes, want,
                                   rtol=1e-12, atol=0)
        seen += want > 0
    assert seen >= 1


def _fill_in_flight(eng, now=0.0):
    """Serve until a staged fill is in flight after a step."""
    eng.warmup()
    for r in _requests(eng.cfg.vocab_size):
        eng.submit(r)
    while eng.has_work():
        eng.step(now)
        now += 0.25
        if eng._executor.active:
            return now
    raise AssertionError("no fill was in flight after any step")


def test_switch_to_none_cancels_the_fill_in_flight():
    # a window longer than the trace: the decision below is the only one
    eng = _store_engine(_controller(hardware=SLOW,
                                                window_iters=1000))
    now = _fill_in_flight(eng)
    assert eng._target_dev is not None
    se = eng._store.slot_experts.copy()
    commits = eng.metrics.migration["commits"]
    eng._apply_decision(Decision(t=now, skew=1.0, volatility=0.0,
                                 recommended="none", strategy="none",
                                 predict_interval=8, switched=True))
    assert (eng.strategy, eng.predict_interval) == ("none", 8)
    assert not eng._executor.active and eng._target_dev is None
    assert _identity(eng)
    # no later step commits the abandoned plan
    for _ in range(6):
        if not eng.has_work():
            break
        eng.step(now)
        now += 0.25
        assert _identity(eng) and not eng._executor.active
    assert eng.metrics.migration["commits"] == commits
    np.testing.assert_array_equal(eng._store.slot_experts, se)
    while eng.has_work():
        eng.step(now)
        now += 0.25
    assert len(eng.scheduler.completed) == len(_requests(eng.cfg.vocab_size))


def test_replan_restarts_a_fill_in_flight():
    eng = _store_engine()
    eng.warmup()
    m = eng.moe_cfg
    targets = []
    for hot in (0, 3):
        dist = np.full((m.num_experts,), 0.1)
        dist[hot] = 0.7
        targets.append(stack_plans([duplicate_experts_host(
            dist / dist.sum(), 4, m.duplication_slots, m.max_copies).plan
            for _ in range(eng.cfg.num_layers)]))
    eng._adopt_plan(targets[0])
    assert eng._executor.active and eng._executor.remaining_entries > 0
    eng._executor.tick(1)
    assert eng._executor.active                    # a fill in flight
    eng._adopt_plan(targets[1])                    # restarts it
    want = eng._to_device(targets[1]).slot_experts
    assert torch.equal(eng._target_dev.slot_experts, want)
    assert not eng._executor.ready_mask().all()
    while eng._executor.active:
        eng._tick_migration()
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(eng._plan_stack, f)),
                                      np.asarray(getattr(targets[1], f)))
    assert eng._target_dev is None
    store = eng._store
    rows = store.slot_rows()
    for l in range(eng.cfg.num_layers):
        for s in store.replica_slots():
            e = store.slot_experts[l, s]
            if e >= 0:
                for w in store.weights.values():
                    assert torch.equal(w[l][rows[l, s]], w[l][e])


def test_engine_refuses_what_the_port_cannot_run():
    # a controller that may choose Token-to-Expert is accepted (the port
    # runs it), and so is one offered every lever: it enables the token
    # scheduler, while the engine starts on its configured lever; a lever
    # the port does not know is refused
    ctl = OnlineGPSController(get_config("mixtral-8x7b"), ControllerConfig(),
                              predictor_available=True)
    eng = _store_engine(ctl)
    assert eng.controller is ctl and eng.strategy == "dist_only"
    assert not eng._resched_enabled
    ctl = OnlineGPSController(
        get_config("mixtral-8x7b"),
        ControllerConfig(levers=("duplicate", "reschedule", "both")))
    eng = _store_engine(ctl)
    assert eng.controller is ctl and eng._resched_enabled
    assert eng.lever == "duplicate" and eng._resched_stack is None
    with pytest.raises(ValueError, match="lever"):
        ContinuousConfig(**dict(ENGINE_KW, lever="migrate"))


def test_hw_is_the_controllers_hardware():
    assert _store_engine()._hw() is A100_PCIE
    ctl = _controller()
    assert _store_engine(ctl)._hw() is H100_SXM_NVLINK
    assert dataclasses.asdict(ControllerConfig().hardware) == \
        dataclasses.asdict(A100_PCIE)


def test_decisions_reach_step_events_and_the_tracer():
    from repro_torch.obs import SpanTracer

    tracer = SpanTracer(process_name="gps-test")
    ctl = _controller()
    cfg, model = _model()
    eng = ContinuousEngine(cfg, model, ContinuousConfig(**ENGINE_KW),
                           ep_ranks=4, controller=ctl, tracer=tracer)
    eng.warmup()
    for r in to_serve_requests(skew_shift_trace(cfg.vocab_size, **TRACE_KW)):
        eng.submit(r)
    events, now = [], 0.0
    while eng.has_work():
        sched = eng.scheduler
        if (not sched.active_slots and sched.waiting
                and sched.waiting[0].arrival > now):
            now = sched.waiting[0].arrival
        events.append(eng.step(now).decision)
        now += 0.25
    assert [d for d in events if d is not None] == ctl.decisions
    names = json.dumps(tracer.to_chrome())
    assert names.count('"gps.decision"') == len(ctl.decisions)
    assert names.count('"gps.switch"') == ctl.num_switches >= 1
