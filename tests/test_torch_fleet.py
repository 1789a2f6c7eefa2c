"""The port's fleet (``repro_torch.fleet``) against the JAX package's, on
the CPU.

* Budget, admission and arbiter: every case of ``tests/test_fleet.py``'s
  ledger, allocator-quota, quota-limited-plan, admission, arbiter and
  labelled-metrics tests runs on both packages with the same inputs; each
  case's observations (ledgers, quotas, moves, attainments) are equal and
  meet the JAX test's expectations. A seeded random sequence of
  ``ModelSignals`` through both arbiters gives equal moves and ledgers at
  every window.
* ``FleetEngine``: two models sharing one reduced-Mixtral ``Transformer``
  serve ``build_workload("fleet_shift")`` on a virtual clock, meshless
  (a static leg and an arbiter leg) and under ``ep=True`` (4 ranks, an
  arbiter leg), against the JAX ``FleetEngine`` (meshless, and on a
  ``(1, 4)`` ``AxisType.Auto`` mesh) in one subprocess with
  ``--xla_allow_excess_precision=false``, on weights with wide router and
  ``lm_head`` margins (``widen_margins``, ``tests/_torch_margins.py``, as
  in ``tests/test_torch_resched.py``) so no route or token sits near a tie.
  Per model the completed requests, their tokens and SLO attainment, the
  arbiter's moves and the final ledger are equal. The arbiter's cost gate
  runs on a ``HardwareConfig`` whose link is so fast that a dup-slot grant
  never depends on the measured (wall) step time.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests._torch_margins import SOURCE as MARGINS_SOURCE  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ns(pkg):
    """The names the cases use, from ``repro`` or ``repro_torch``."""
    import importlib
    mod = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    fleet, plc = mod("fleet"), mod("core.placement")
    return SimpleNamespace(
        **{k: getattr(fleet, k) for k in fleet.__all__},
        store_bytes_per_rank=plc.store_bytes_per_rank,
        identity_plan=plc.identity_plan,
        plan_from_assignments=plc.plan_from_assignments,
        quota_limited_plan=plc.quota_limited_plan,
        stack_plans=plc.stack_plans,
        duplicate_experts_host=mod("core.duplication").duplicate_experts_host,
        vacated_slots=mod("runtime.diff").vacated_slots,
        BlockAllocator=mod("serve").BlockAllocator,
        ServeMetrics=mod("serve.metrics").ServeMetrics,
        RequestTiming=mod("serve.metrics").RequestTiming,
        MetricsRegistry=mod("obs.metrics").MetricsRegistry,
        HardwareConfig=mod("core.simulator").HardwareConfig)


JAX, PORT = _ns("repro"), _ns("repro_torch")


# --------------------------------------------------------------------------
# the cases of tests/test_fleet.py, on either package
# --------------------------------------------------------------------------

def _share(ns, name, *, dup=2, kv=16, weights=1000, entry=10, layers=2,
           experts=8, ranks=4, kvb=8, **kw):
    return ns.ModelShare(name=name, weights_bytes=weights, entry_bytes=entry,
                         num_layers=layers, num_experts=experts,
                         ep_ranks=ranks, dup_slots=dup, kv_blocks=kv,
                         kv_block_bytes=kvb, **kw)


def _ledger(b):
    return {n: (s.dup_slots, s.dup_slot_quota, s.kv_block_quota)
            for n, s in b.shares.items()}


def case_share_bytes(ns):
    s = _share(ns, "m")
    assert s.store_bytes(2) == ns.store_bytes_per_rank(
        8, 4, 2, entry_bytes=10, num_layers=2)
    full = (s.provisioned_bytes, s.active_bytes)
    assert full[0] == 1000 + s.store_bytes(2) + 16 * 8 == full[1]
    s.kv_block_quota, s.dup_slot_quota = 4, 1
    assert s.active_bytes == 1000 + s.store_bytes(1) + 4 * 8
    assert s.dup_slot_entry_bytes == 2 * 10
    return full, s.active_bytes, s.dup_slot_entry_bytes


def case_share_quota_defaults(ns):
    a, b = _share(ns, "a"), _share(ns, "b", dup_slot_quota=1,
                                   kv_block_quota=99)
    assert (a.dup_slot_quota, a.kv_block_quota) == (2, 16)
    assert (b.dup_slot_quota, b.kv_block_quota) == (1, 16)
    return a.dup_slot_quota, b.kv_block_quota


def case_clamp_unlimited(ns):
    b = ns.FleetBudget(0.0)
    b.register(_share(ns, "a"))
    b.register(_share(ns, "b", dup=1))
    out = b.clamp()
    assert out == {"a": 2, "b": 1} and b.shares["a"].kv_block_quota == 16
    return out, _ledger(b)


def case_clamp_order(ns):
    b = ns.FleetBudget(0.0)
    b.register(_share(ns, "big", dup=3))
    b.register(_share(ns, "small", dup=1))
    b.total_bytes = float(b.provisioned_bytes() - 1)
    out = b.clamp()
    assert out == {"big": 2, "small": 1}
    b2 = ns.FleetBudget(0.0)
    b2.register(_share(ns, "a"))
    b2.register(_share(ns, "b"))
    b2.total_bytes = float(2 * 1000 + 2 * _share(ns, "x", dup=0)
                           .store_bytes(0) + 16 * 8)
    out2 = b2.clamp()
    assert out2 == {"a": 0, "b": 0} and b2.shares["a"].kv_block_quota < 16
    return out, _ledger(b), out2, _ledger(b2), b2.provisioned_bytes()


def case_clamp_raises(ns):
    b = ns.FleetBudget(10.0)
    b.register(_share(ns, "a"))
    with pytest.raises(ValueError, match="cannot fit"):
        b.clamp()
    return True


def case_transfer_bounds(ns):
    b = ns.FleetBudget(0.0)
    b.register(_share(ns, "hot", dup_slot_quota=1, kv_block_quota=8))
    b.register(_share(ns, "cold", dup_slot_quota=1, kv_block_quota=8))
    b.transfer("cold", "hot", dup_slots=1, kv_blocks=4)
    assert _ledger(b) == {"hot": (2, 2, 12), "cold": (2, 0, 4)}
    gates = (b.can_transfer("cold", "hot", dup_slots=1),
             b.can_transfer("cold", "hot", kv_blocks=5))
    assert gates == (False, False)
    with pytest.raises(ValueError, match="violates"):
        b.transfer("cold", "hot", dup_slots=1)
    return _ledger(b), gates


def case_transfer_budget(ns):
    b = ns.FleetBudget(0.0)
    b.register(_share(ns, "hot", entry=50, dup_slot_quota=1))
    b.register(_share(ns, "cold", kvb=1, kv_block_quota=8))
    b.total_bytes = float(b.active_bytes())
    gates = (b.can_transfer("cold", "hot", dup_slots=1),
             b.can_transfer("cold", "hot", kv_blocks=2),
             b.can_transfer("hot", "cold", kv_blocks=2))
    assert gates == (False, False, True)
    return gates


def case_summary_and_kv_bytes(ns):
    b = ns.FleetBudget(123.0)
    b.register(_share(ns, "m1"))
    s = b.summary()
    assert {"budget_total_bytes", "m1_weights_bytes", "m1_store_bytes",
            "m1_kv_bytes", "m1_dup_slot_quota", "m1_kv_block_quota"} <= set(s)
    assert ns.kv_block_bytes(2, 8, 4, 16) == 2 * 8 * 4 * 16 * 2 * 2
    return s, ns.kv_block_bytes(3, 16, 8, 128, 1)


def case_allocator_quota(ns):
    a = ns.BlockAllocator(num_blocks=9, block_size=4)
    a.set_quota(4)
    got = a.alloc(4)
    seen = [a.in_use, a.alloc(1) is None, a.free_blocks]
    a.free(got[:1])
    seen.append(a.alloc(1) is not None)
    assert seen == [4, True, 4, True]
    b = ns.BlockAllocator(num_blocks=9, block_size=4)
    got = b.alloc(6)
    b.set_quota(3)
    seen2 = [b.in_use, b.alloc(1) is None]
    b.free(got[:3])
    seen2.append(b.alloc(1) is None)
    b.free(got[3:4])
    seen2.append(b.alloc(1) is not None)
    assert seen2 == [6, True, True, True]
    c = ns.BlockAllocator(num_blocks=5, block_size=4)
    c.set_quota(99)
    q = [c.quota]
    c.set_quota(-3)
    q += [c.quota, c.alloc(1) is None]
    assert q == [4, 0, True]
    return seen, seen2, q


def _quota_plan(ns, dist, E=8, R=4, D=2, C=4, q=1):
    res = ns.duplicate_experts_host(dist, R, q, C)
    return ns.quota_limited_plan(res.assignments, E, R, D, C, quota=q)


PLAN_FIELDS = ("n_replicas", "replica_table", "pool_expert", "pool_sel")


def _plan_arrays(p):
    return [np.asarray(getattr(p, f)).tolist() for f in PLAN_FIELDS]


def case_quota_limited_plans(ns):
    dist = [0.5, 0.2, 0.1, 0.05, 0.05, 0.05, 0.03, 0.02]
    full = ns.plan_from_assignments(
        ns.duplicate_experts_host(dist, 4, 2, 4).assignments, 8, 4, 2, 4)
    lim = _quota_plan(ns, dist, q=1)
    for f in PLAN_FIELDS:
        assert np.asarray(getattr(lim, f)).shape == \
            np.asarray(getattr(full, f)).shape, f
    dist2 = [0.4, 0.3, 0.1, 0.05, 0.05, 0.04, 0.03, 0.03]
    E, R, D, q = 8, 4, 3, 1
    lim2 = _quota_plan(ns, dist2, E=E, R=R, D=D, q=q)
    n_slots = E // R + D
    table, n_rep = np.asarray(lim2.replica_table), np.asarray(lim2.n_replicas)
    extra = np.zeros(R, np.int64)
    for e in range(E):
        for c in range(1, int(n_rep[e])):
            extra[int(table[e, c]) // n_slots] += 1
    assert (extra <= q).all()
    zero = _quota_plan(ns, [0.9] + [0.1 / 7] * 7, q=0)
    ident = ns.identity_plan(8, 4, 2, 4)
    assert (np.asarray(zero.n_replicas) == 1).all()
    assert np.array_equal(np.asarray(zero.replica_table),
                          np.asarray(ident.replica_table))
    rich = ns.stack_plans([_quota_plan(ns, dist, q=2)] * 2)
    poor = ns.stack_plans([_quota_plan(ns, dist, q=0)] * 2)
    vac = (ns.vacated_slots(rich, poor, 4, 2), ns.vacated_slots(poor, rich,
                                                                4, 2),
           ns.vacated_slots(rich, rich, 4, 2))
    assert vac[0] > 0 and vac[1:] == (0, 0)
    return (_plan_arrays(full), _plan_arrays(lim), _plan_arrays(lim2),
            extra.tolist(), vac)


def _timing(ns, tenant, ttft, tpot, toks=5):
    return ns.RequestTiming(rid=0, arrival=0.0, t_first_token=ttft,
                            t_finished=ttft + tpot * (toks - 1),
                            prompt_len=8, new_tokens=toks, tenant=tenant)


def case_admission(ns):
    adm = ns.FleetAdmission(routes={"a": "m1"}, default_model="m0")
    routed = (adm.route("a"), adm.route("unknown"), adm.tenants_for("m1"))
    assert routed == ("m1", "m0", ["a"])
    with pytest.raises(KeyError):
        ns.FleetAdmission(routes={"a": "m1"}).route("unknown")
    adm2 = ns.FleetAdmission(routes={"chat": "m", "batch": "m"},
                             slos={"chat": ns.INTERACTIVE,
                                   "batch": ns.BATCH})
    s = adm2.strictest_slo("m")
    assert (s.slo_ttft, s.slo_tpot) == (ns.INTERACTIVE.slo_ttft,
                                        ns.INTERACTIVE.slo_tpot)
    assert adm2.strictest_slo("other") == adm2.default_slo
    return routed, dataclasses.astuple(s)


def case_attainment(ns):
    adm = ns.FleetAdmission(
        routes={"chat": "m", "batch": "m"},
        slos={"chat": ns.SLOClass("chat", slo_ttft=1.0, slo_tpot=0.5),
              "batch": ns.BATCH})
    m = ns.ServeMetrics()
    m.timings.extend([_timing(ns, "chat", 0.5, 0.1),
                      _timing(ns, "chat", 5.0, 0.1),
                      _timing(ns, "batch", 5.0, 0.1)])
    out = (adm.tenant_attainment(m, "chat"), adm.tenant_attainment(m, "batch"),
           adm.model_attainment(m, "m"), adm.model_attainment(m, "empty"),
           ns.ServeMetrics().slo_attainment(tenant="x"))
    assert out == (0.5, 1.0, 0.5, 1.0, 1.0)
    return out


def _signals(ns, hot_attain=0.5, hot_queue=8, cold_attain=1.0, step_s=0.1,
             entry=64, hot_skew=2.0):
    return {
        "hot": ns.ModelSignals(slo_attainment=hot_attain,
                               queue_depth=hot_queue, window_skew=hot_skew,
                               step_s=step_s, dup_entry_bytes=entry),
        "cold": ns.ModelSignals(slo_attainment=cold_attain, queue_depth=0,
                                window_skew=1.0, step_s=step_s,
                                dup_entry_bytes=entry)}


def _arbiter(ns, patience=2, **kw):
    b = ns.FleetBudget(0.0)
    b.register(_share(ns, "hot", dup_slot_quota=1, kv_block_quota=8))
    b.register(_share(ns, "cold", dup_slot_quota=1, kv_block_quota=8))
    return ns.FleetArbiter(ns.ArbiterConfig(patience=patience, window_iters=4,
                                            kv_blocks_per_move=4,
                                            kv_floor_blocks=2, **kw), b)


def _moves(moves):
    return [dataclasses.astuple(m) for m in moves]


def case_arbiter_patience(ns):
    arb = _arbiter(ns, patience=2)
    first = arb.observe(1.0, _signals(ns))
    moves = arb.observe(2.0, _signals(ns))
    assert first == [] and len(moves) == 1
    assert (moves[0].src, moves[0].dst, moves[0].kv_blocks) == ("cold",
                                                                "hot", 4)
    assert "cold->hot" in moves[0].explain()
    return _moves(moves), _ledger(arb.budget), arb.last_pressure, \
        arb.explain()


def case_arbiter_vote_reset(ns):
    arb = _arbiter(ns, patience=2)
    arb.observe(1.0, _signals(ns))
    arb.observe(2.0, _signals(ns, hot_attain=1.0, hot_queue=0, hot_skew=1.0))
    third = arb.observe(3.0, _signals(ns))
    fourth = arb.observe(4.0, _signals(ns))
    assert third == [] and len(fourth) == 1
    single = _arbiter(ns, patience=1).observe(1.0, {
        "hot": _signals(ns)["hot"]})
    assert single == []
    return _moves(fourth), _ledger(arb.budget)


def case_arbiter_cost_gate(ns):
    arb = _arbiter(ns, patience=1)
    moves = arb.observe(1.0, _signals(ns, step_s=1e-9, entry=10 ** 15))
    assert (moves[0].dup_slots, moves[0].kv_blocks) == (0, 4)
    arb2 = _arbiter(ns, patience=1)
    moves2 = arb2.observe(1.0, _signals(ns, step_s=0.5, entry=64))
    assert moves2[0].dup_slots == 1 and moves2[0].stall_s >= 0.0
    assert arb2.budget.shares["hot"].dup_slot_quota == 2
    return _moves(moves), _moves(moves2), _ledger(arb2.budget)


def case_arbiter_floor_and_cap(ns):
    arb = _arbiter(ns, patience=1)
    for t in range(1, 6):
        arb.observe(float(t), _signals(ns, step_s=1e-9, entry=10 ** 15))
    assert _ledger(arb.budget)["cold"][2] == 4
    assert _ledger(arb.budget)["hot"][2] == 12
    cap = _arbiter(ns, patience=1, max_moves=1)
    cap.observe(1.0, _signals(ns))
    assert cap.observe(2.0, _signals(ns)) == [] and len(cap.moves) == 1
    return _moves(arb.moves), _ledger(arb.budget), _moves(cap.moves)


def case_metrics_model_label(ns):
    reg = ns.MetricsRegistry()
    m1 = ns.ServeMetrics(registry=reg, model="m1")
    m2 = ns.ServeMetrics(registry=reg, model="m2")
    for m, ttft in ((m1, 0.5), (m2, 0.7)):
        m.timings.append(_timing(ns, "", ttft, 0.1))
        m.record_completion(m.timings[-1])
    snap = reg.snapshot()
    assert snap['serve_requests_completed_total{model="m1"}'] == 1.0
    assert snap['serve_requests_completed_total{model="m2"}'] == 1.0
    reg2 = ns.MetricsRegistry()
    m = ns.ServeMetrics(registry=reg2)
    m.timings.append(_timing(ns, "", 0.5, 0.1))
    m.record_completion(m.timings[-1])
    assert "serve_requests_completed_total" in reg2.snapshot()
    return sorted(snap), sorted(reg2.snapshot())


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_case_matches_the_jax_package(case):
    assert CASES[case](PORT) == CASES[case](JAX)


def test_random_signals_give_equal_moves_and_ledgers():
    """Three models, a tight byte budget, 300 windows of random signals:
    both arbiters commit the same moves (every field) and keep the same
    ledger at every window."""
    def run(ns):
        b = ns.FleetBudget(0.0)
        for i, name in enumerate(("a", "b", "c")):
            b.register(_share(ns, name, dup=3, kv=24, entry=10 + 5 * i,
                              kvb=8 + 4 * i, dup_slot_quota=1,
                              kv_block_quota=12))
        b.total_bytes = float(b.active_bytes() + 60)
        arb = ns.FleetArbiter(ns.ArbiterConfig(
            window_iters=4, patience=2, kv_blocks_per_move=3,
            kv_floor_blocks=3, max_moves=0,
            hardware=ns.HardwareConfig("slow-link", 4, 1e12, 1e12, 2e3)), b)
        rng = np.random.default_rng(11)
        trail = []
        for w in range(300):
            sig = {n: ns.ModelSignals(
                slo_attainment=float(rng.uniform(0.3, 1.0)),
                queue_depth=int(rng.integers(0, 12)),
                window_skew=float(rng.uniform(0.8, 3.0)),
                step_s=float(rng.uniform(1e-4, 0.2)),
                dup_entry_bytes=int(rng.integers(10, 500)))
                for n in ("a", "b", "c")}
            moves = arb.observe(0.25 * w, sig)
            trail.append((_moves(moves), _ledger(b), b.active_bytes(),
                          dict(arb.last_pressure)))
        return trail, arb.explain()

    port, ref = run(PORT), run(JAX)
    assert port == ref
    moves = [m for t in port[0] for m in t[0]]
    assert len(moves) > 5
    assert any(m[4] for m in moves) and any(not m[4] for m in moves)


# --------------------------------------------------------------------------
# FleetEngine against the JAX FleetEngine
# --------------------------------------------------------------------------

# Executed by the JAX subprocess and here: weights whose router and lm_head
# margins are wide (tests/_torch_margins.py), and the fleet run that
# records what happened.
CAPTURE = MARGINS_SOURCE + '''
def run_fleet(fleet, adm, reqs, max_iters, dt):
    fleet.warmup()
    for r in sorted(reqs, key=lambda r: r.arrival):
        fleet.submit(r)
    now, n, quota_ok = 0.0, 0, True
    while fleet.has_work() and n < max_iters:
        fleet.step(now)
        now += dt
        n += 1
        quota_ok &= all(e.allocator.in_use <= e.allocator.quota
                        for e in fleet.engines.values())
    for eng in fleet.engines.values():
        eng.metrics.flush(eng._plan_stack, eng.ep_ranks,
                          eng.moe_cfg.duplication_slots)
    s = fleet.summary()
    arb = fleet.arbiter
    return {
        "iterations": n, "drained": not fleet.has_work(),
        "quota_ok": quota_ok,
        "completed": {m: sorted(r.rid for r in e.scheduler.completed)
                      for m, e in fleet.engines.items()},
        "tokens": {r.rid: [int(t) for t in r.generated]
                   for e in fleet.engines.values()
                   for r in e.scheduler.completed},
        "attainment": {m: adm.model_attainment(e.metrics, m)
                       for m, e in fleet.engines.items()},
        "summary": {k: s[k] for k in COLUMNS},
        "moves": [] if arb is None else [
            (m.seq, m.t, m.src, m.dst, m.dup_slots, m.kv_blocks,
             m.pressure_src, m.pressure_dst) for m in arb.moves],
        "pressure": {} if arb is None else dict(arb.last_pressure),
    }
'''

COLUMNS = ("fleet_completed", "fleet_slo_attainment",
           "fleet_slo_attainment_worst", "fleet_arbiter_moves",
           "fleet_iterations", "m-chat_kv_block_quota",
           "m-batch_kv_block_quota", "m-chat_dup_slot_quota",
           "m-batch_dup_slot_quota", "m-chat_store_bytes",
           "m-chat_kv_bytes")
ENGINE_KW = dict(max_slots=4, prefill_len=64, block_size=8, max_len=96,
                 strategy="dist_only", predict_interval=4, dup_slots=2,
                 metrics_window=4, max_prefills_per_step=2)
KV_QUOTA = 12
ARBITER_KW = dict(window_iters=8, patience=2, queue_norm=4.0,
                  kv_blocks_per_move=4, kv_floor_blocks=4)
FAST_LINK = ("fast-link", 4, 1e30, 1e30, 1e30)
TRACE_KW = dict(horizon=20.0, rate=1.2, seed=0)
LEGS = (("meshless", False), ("meshless", True), ("ep", True))
DT, MAX_ITERS = 0.25, 320

SUB = '''
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_allow_excess_precision=false")
import pickle
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs.registry import get_config
from repro.core.simulator import HardwareConfig
from repro.fleet import (ArbiterConfig, BATCH, FleetAdmission, FleetEngine,
                         FleetModelSpec, SLOClass)
from repro.models.transformer import init_model
from repro.serve import ContinuousConfig
from repro.sweep.workloads import build_workload
from repro.workloads import to_serve_requests

COLUMNS = eval(os.environ["FL_COLUMNS"])
exec(os.environ["FL_CAPTURE"])
cfg = get_config("mixtral-8x7b").reduced()
tree = widen_margins(jax.tree.map(np.asarray, init_model(
    jax.random.PRNGKey(0), cfg)), cfg)
p = jax.tree.map(jnp.asarray, tree)
p["layers"]["moe"]["experts"] = jax.tree.map(
    lambda w: w.astype(jnp.bfloat16), p["layers"]["moe"]["experts"])
ccfg = ContinuousConfig(**eval(os.environ["FL_ENGINE"]))
trace = build_workload("fleet_shift", cfg.vocab_size,
                       **eval(os.environ["FL_TRACE"]))
mesh = jax.make_mesh((1, 4), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
res = {}
for kind, arbiter in eval(os.environ["FL_LEGS"]):
    adm = FleetAdmission(routes={"chat": "m-chat", "batch": "m-batch"},
                         slos={"chat": SLOClass("chat", slo_ttft=2.0,
                                                slo_tpot=1.0),
                               "batch": BATCH})
    specs = [FleetModelSpec(n, cfg, p, ccfg, dup_slot_quota=1,
                            kv_block_quota=int(os.environ["FL_KV"]))
             for n in ("m-chat", "m-batch")]
    acfg = ArbiterConfig(**eval(os.environ["FL_ARBITER"]),
                         hardware=HardwareConfig(*eval(os.environ["FL_HW"])))
    meshed = kind == "ep"
    fleet = FleetEngine(specs, mesh=mesh if meshed else None,
                        ep_ranks=4 if meshed else 1, admission=adm,
                        arbiter_cfg=acfg, enable_arbiter=arbiter)
    if meshed:
        with mesh:
            res[(kind, arbiter)] = run_fleet(fleet, adm,
                                             to_serve_requests(trace),
                                             int(os.environ["FL_MAX"]),
                                             float(os.environ["FL_DT"]))
    else:
        res[(kind, arbiter)] = run_fleet(fleet, adm, to_serve_requests(trace),
                                         int(os.environ["FL_MAX"]),
                                         float(os.environ["FL_DT"]))
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """The JAX fleets' records: the meshless legs and the meshed leg in two
    subprocesses that run side by side."""
    import pickle
    tmp = tmp_path_factory.mktemp("fleet")
    procs = []
    for i, legs in enumerate((LEGS[:2], LEGS[2:])):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu", FL_CAPTURE=CAPTURE,
                   FL_COLUMNS=repr(COLUMNS), FL_ENGINE=repr(ENGINE_KW),
                   FL_KV=str(KV_QUOTA), FL_ARBITER=repr(ARBITER_KW),
                   FL_HW=repr(FAST_LINK), FL_TRACE=repr(TRACE_KW),
                   FL_LEGS=repr(legs), FL_MAX=str(MAX_ITERS), FL_DT=repr(DT))
        out = tmp / f"jax_fleet{i}.pkl"
        procs.append((out, subprocess.Popen(
            [sys.executable, "-c", textwrap.dedent(SUB), str(out)],
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
            env=env)))
    res = {}
    for out, proc in procs:
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err[-4000:]
        with open(out, "rb") as f:
            res.update(pickle.load(f))
    return res


@pytest.fixture(scope="module")
def shared_model():
    """One reduced-Mixtral Transformer (the JAX init's weights with wide
    margins, bridged) for both models of every leg."""
    import jax
    from repro.configs.registry import get_config as jax_get_config
    from repro.models.transformer import init_model as jax_init_model
    from repro_torch.bridge import params_from_jax
    from repro_torch.configs.registry import get_config

    scope = {"np": np}
    exec(CAPTURE, scope)
    jcfg = jax_get_config("mixtral-8x7b").reduced()
    tree = scope["widen_margins"](jax.tree.map(np.asarray, jax_init_model(
        jax.random.PRNGKey(0), jcfg)), jcfg)
    cfg = get_config("mixtral-8x7b").reduced()
    return cfg, params_from_jax(tree, cfg, device="cpu"), scope


def _port_fleet(cfg, model, *, ep, arbiter, trace=False):
    from repro_torch.fleet import (BATCH, ArbiterConfig, FleetAdmission,
                                   FleetEngine, FleetModelSpec, SLOClass)
    from repro_torch.core.simulator import HardwareConfig
    from repro_torch.serve import ContinuousConfig

    adm = FleetAdmission(routes={"chat": "m-chat", "batch": "m-batch"},
                         slos={"chat": SLOClass("chat", slo_ttft=2.0,
                                                slo_tpot=1.0),
                               "batch": BATCH})
    ccfg = ContinuousConfig(**ENGINE_KW)
    specs = [FleetModelSpec(n, cfg, model, ccfg, dup_slot_quota=1,
                            kv_block_quota=KV_QUOTA)
             for n in ("m-chat", "m-batch")]
    fleet = FleetEngine(specs, ep=ep, ep_ranks=4 if ep else 1,
                        admission=adm, arbiter_cfg=ArbiterConfig(
                            **ARBITER_KW,
                            hardware=HardwareConfig(*FAST_LINK)),
                        enable_arbiter=arbiter, trace=trace, device="cpu")
    return fleet, adm


@pytest.mark.parametrize("leg", LEGS, ids=lambda v: str(v))
def test_fleet_engine_matches_the_jax_fleet(jax_ref, shared_model, leg):
    from repro_torch.obs import validate_chrome_trace
    from repro_torch.workloads import build_workload, to_serve_requests

    cfg, model, scope = shared_model
    kind, arbiter = leg
    fleet, adm = _port_fleet(cfg, model, ep=kind == "ep", arbiter=arbiter,
                             trace=True)
    scope["COLUMNS"] = COLUMNS
    reqs = to_serve_requests(build_workload("fleet_shift", cfg.vocab_size,
                                            **TRACE_KW))
    rec = scope["run_fleet"](fleet, adm, reqs, MAX_ITERS, DT)
    ref = jax_ref[leg]
    assert rec["drained"] and ref["drained"] and rec["quota_ok"]
    for key in ("iterations", "completed", "tokens", "attainment",
                "summary", "moves", "pressure"):
        assert rec[key] == ref[key], key
    n = sum(len(v) for v in rec["completed"].values())
    assert n == len(reqs)
    assert all(len(t) > 0 for t in rec["tokens"].values())
    # the ledger's quotas stay what was provisioned between the two
    s = fleet.budget.summary()
    assert s["m-chat_kv_block_quota"] + s["m-batch_kv_block_quota"] \
        == 2 * KV_QUOTA
    assert s["m-chat_dup_slot_quota"] + s["m-batch_dup_slot_quota"] == 2
    if arbiter:
        assert rec["moves"] and all(m[3] == "m-chat" for m in rec["moves"])
    else:
        assert rec["moves"] == [] and fleet.arbiter is None
    doc = fleet.merged_trace()
    assert validate_chrome_trace(doc) == []
    assert {e["pid"] for e in doc["traceEvents"]} == {1, 2}


def test_fleet_arbiter_leg_beats_the_static_leg(jax_ref):
    static = jax_ref[("meshless", False)]["summary"]
    moved = jax_ref[("meshless", True)]["summary"]
    assert moved["fleet_slo_attainment_worst"] \
        > static["fleet_slo_attainment_worst"]


def test_fleet_engine_construction_rules(shared_model):
    from repro_torch.fleet import FleetEngine, FleetModelSpec
    from repro_torch.serve import ContinuousConfig

    cfg, model, _ = shared_model
    ccfg = ContinuousConfig(max_slots=2, prefill_len=16, block_size=8,
                            max_len=32, strategy="none", dup_slots=1)
    with pytest.raises(ValueError, match="duplicate"):
        FleetEngine([FleetModelSpec("m", cfg, model, ccfg)] * 2,
                    device="cpu")
    fleet = FleetEngine([FleetModelSpec("m", cfg, model, ccfg,
                                        dup_slot_quota=0, kv_block_quota=3)],
                        device="cpu")
    eng = fleet.engines["m"]
    assert eng.allocator.quota == 3 and eng.dup_slot_quota == 0
    assert fleet.budget.shares["m"].kv_block_quota == 3
    assert fleet.budget.shares["m"].weights_bytes == sum(
        p.numel() * p.element_size() for p in model.parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            FleetEngine([FleetModelSpec("m", cfg, model, ccfg)])
