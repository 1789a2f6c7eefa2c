"""Token-to-Expert serving in the port against the JAX package, on the CPU.

* ``ep_moe_ffn(predicted_idx=...)``, the predicted round plus the
  correction round, against ``jax.vmap(..., axis_name="model")`` of the
  JAX function with ``use_kernel=True`` (Pallas in interpret mode), as in
  ``tests/test_torch_dispatch.py``: predictions that are all wrong, the
  top-1 route broadcast over k (half right, as the engines predict), a
  random mix, and all right; capacity factors 1.0 (both rounds overflow:
  the correction round's ``cap2`` is 8) and 8.0; the identity plan and a
  duplicated one. ``slot_counts``, ``dropped`` and the expert counts are
  equal, y within 1e-5 in fp32 and ``BF16_ATOL`` in bf16.
* The model threads the predictions: on the dense path they change
  nothing; under EP, predictions equal to the routes give the plain EP
  forward bit for bit, and the EP decode path refuses them.
* ``ContinuousEngine(ep=True, strategy="token_to_expert")`` with a
  ``ConditionalProbabilityModel`` against the meshed JAX engine (a
  ``(1, 4)`` ``AxisType.Auto`` mesh in a subprocess with four host devices
  and ``--xla_allow_excess_precision=false``), both on the same bridged
  reduced-Mixtral weights and an equal predictor: per iteration the
  generated lengths, the plan in force and every re-plan's plan, the pairs
  dropped, the migration counters, the predicted histogram
  (``_pred_counts``) and the accuracy windows are equal, up to the first
  iteration whose dropped pairs differ by one or two, or whose token is a
  near tie: of the JAX logits, or of a decode route (a router top-k margin
  under ``ROUTE_TIE`` in the port at that step; the JAX engine's runtime
  rounds bf16 at other places, so its hidden states differ by about a
  bf16 ulp and such a route may flip; ``tests/test_torch_store_serve.py``
  explains the dropped-pairs stop).
* The mesh-less engines with an ``OnlineGPSController`` that may choose
  Token-to-Expert (the JAX default preset, A100-PCIe): every decision and
  audit record, the strategy in force, the predicted histogram and the
  accuracy windows are equal per iteration, and the run switches into
  token_to_expert and out of it.
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

from repro.configs.base import MoEConfig as JaxMoEConfig  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.core.duplication import duplicate_experts_host as jax_dup  # noqa: E402
from repro.core.placement import identity_plan as jax_identity  # noqa: E402
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

ROOT = Path(__file__).resolve().parents[1]
T, D_MODEL, F, E, K = 32, 32, 64, 8, 2
BF16_ATOL = 1e-2
ROUTE_TIE = 1e-3
PREDICTIONS = ("all_wrong", "top1", "mixed", "all_right")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced model's operations are tiny: one intra-op thread runs
    them as fast as many, and keeps test workers side by side from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# ep_moe_ffn with predictions against the vmapped JAX function
# --------------------------------------------------------------------------

def _inputs(R, seed):
    """Tokens with a common component the router weight's first column
    follows, so expert 0 is hot and a capacity factor of 1.0 drops."""
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


def _plan(R, D, duplicated, seed=0):
    if not duplicated:
        return jax_identity(E, R, D, 4)
    rng = np.random.default_rng(seed)
    dist = rng.random(E) ** 4
    dist[rng.integers(E)] += 1.0
    return jax_dup(dist / dist.sum(), R, D, 4).plan


def _predictions(true_idx: np.ndarray, kind: str, seed: int) -> np.ndarray:
    """(R, T, K) predicted experts from the true routes."""
    rng = np.random.default_rng(seed)
    wrong = (true_idx + rng.integers(1, E, true_idx.shape)) % E
    if kind == "all_wrong":
        return wrong.astype(np.int32)
    if kind == "top1":
        return np.repeat(true_idx[..., :1], K, axis=-1).astype(np.int32)
    if kind == "mixed":
        return np.where(rng.random(true_idx.shape) < 0.5, true_idx,
                        wrong).astype(np.int32)
    return true_idx.astype(np.int32)


def _compare(R, D, cf, kind, dtype, seed):
    moe_kw = dict(num_experts=E, top_k=K, d_ff_expert=F, capacity_factor=cf,
                  duplication_slots=D)
    jmoe, moe = JaxMoEConfig(**moe_kw), MoEConfig(**moe_kw)
    x, wr, w = _inputs(R, seed)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    xt = torch.tensor(x).to(tdt)
    wt = {n: torch.tensor(a).to(tdt) for n, a in w.items()}
    ro = route(torch.tensor(wr), moe, xt)
    pred = _predictions(ro.expert_idx.numpy(), kind, seed)
    w_local = {n: jnp.asarray(a, jdt).reshape(R, E // R, *a.shape[1:])
               for n, a in w.items()}
    router = {"w": jnp.asarray(wr)}

    def per_rank(xb, wb, plan, pb):
        r = jax_route(router, jmoe, xb, impl="fused")
        return jep.ep_moe_ffn(xb, r, wb, plan, jmoe, axis_name="model",
                              ep_ranks=R, use_kernel=True, predicted_idx=pb)
    run = jax.jit(jax.vmap(per_rank, axis_name="model",
                           in_axes=(0, 0, None, 0)))
    out = {}
    for duplicated in (False, True):
        plan = _plan(R, D, duplicated, seed=seed)
        yj, sj = run(jnp.asarray(x, jdt), w_local,
                     jax.tree.map(jnp.asarray, plan), jnp.asarray(pred))
        dp = to_device(PlacementPlan(*(np.asarray(a) for a in plan)), E, R,
                       D, "cpu")
        ops.reset_launches()
        yt, st = ep.ep_moe_ffn(xt, ro, wt, dp, moe, ep_ranks=R,
                               predicted_idx=torch.tensor(pred))
        assert sum(ops.LAUNCHES.values()) == 0
        atol = 1e-5 if dtype == "float32" else BF16_ATOL
        np.testing.assert_allclose(yt.float().numpy(),
                                   np.asarray(yj, np.float32), atol=atol,
                                   rtol=0 if dtype == "float32" else atol)
        for name in ("expert_counts", "slot_counts", "dropped"):
            np.testing.assert_array_equal(
                getattr(st, name).numpy(), np.asarray(getattr(sj, name))[0],
                err_msg=f"{name} (duplicated={duplicated})")
        out[duplicated] = int(st.dropped)
    return out, float((pred == ro.expert_idx.numpy()).mean())


@pytest.mark.parametrize("kind", PREDICTIONS)
@pytest.mark.parametrize("R", [2, 4])
@pytest.mark.parametrize("cf", [1.0, 8.0])
def test_predicted_ep_moe_ffn_matches_vmapped_jax_fp32(kind, R, cf):
    dropped, acc = _compare(R, 1, cf, kind, "float32", seed=R * 10 + 1)
    want_acc = {"all_wrong": 0.0, "top1": 0.5, "all_right": 1.0}
    if kind in want_acc:
        assert acc == want_acc[kind]
    else:
        assert 0.3 < acc < 0.7
    if cf == 8.0 and kind == "all_right":
        assert dropped == {False: 0, True: 0}
    if kind == "all_wrong":
        # every pair goes to the correction round, whose capacity of 8
        # per (slot, source rank) the hot expert overflows
        assert dropped[False] > 0


@pytest.mark.parametrize("kind", ["top1", "all_wrong"])
def test_predicted_ep_moe_ffn_matches_vmapped_jax_bf16(kind):
    dropped, _ = _compare(4, 1, 1.0, kind, "bfloat16", seed=7)
    assert dropped[False] > 0


# --------------------------------------------------------------------------
# the model threads predictions
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    jcfg = jax_get_config("mixtral-8x7b").reduced()
    return jax.tree.map(np.asarray, jax_init_model(jax.random.PRNGKey(0),
                                                   jcfg))


def _port_model(jax_params):
    cfg = get_config("mixtral-8x7b").reduced()
    return cfg, params_from_jax(jax_params, cfg, device="cpu")


def test_forward_threads_predictions(jax_params):
    cfg, model = _port_model(jax_params)
    rng = np.random.default_rng(0)
    tokens = torch.tensor(rng.integers(0, cfg.vocab_size, (1, 32)))
    L, k = cfg.num_layers, cfg.moe.top_k
    wrong = torch.tensor(rng.integers(0, cfg.moe.num_experts, (L, 1, 32, k)))
    # the dense path ignores predictions
    a = forward(model, cfg, tokens, Runtime(), mode="prefill")
    b = forward(model, cfg, tokens, Runtime(), mode="prefill",
                predicted_idx=wrong)
    assert torch.equal(a[0], b[0])
    # EP: the routes as predictions change nothing, wrong ones do
    rt = Runtime(ep=True, ep_ranks=4)
    with torch.inference_mode():
        base = forward(model, cfg, tokens, rt, mode="prefill")
        routes = []
        real = ep.ep_moe_ffn

        def recording(x, router_out, *a, **kw):
            routes.append(router_out.expert_idx)
            return real(x, router_out, *a, **kw)
        ep.ep_moe_ffn = recording
        try:
            forward(model, cfg, tokens, rt, mode="prefill")
        finally:
            ep.ep_moe_ffn = real
        # (R, B * S / R, K) per layer -> (B, S, K) in sequence order
        exact = torch.stack([r.reshape(4, 1, 8, k).transpose(0, 1)
                             .reshape(1, 32, k) for r in routes])
        same = forward(model, cfg, tokens, rt, mode="prefill",
                       predicted_idx=exact)
        other = forward(model, cfg, tokens, rt, mode="prefill",
                        predicted_idx=wrong)
    assert torch.equal(base[0], same[0])
    assert torch.equal(base[2]["dropped"], same[2]["dropped"])
    assert not torch.equal(base[2]["slot_counts"], other[2]["slot_counts"])
    with torch.inference_mode(), \
            pytest.raises(NotImplementedError, match="prefill feature"):
        forward(model, cfg, tokens[:, :1], rt, mode="decode", cache=base[1],
                cache_len=4, predicted_idx=wrong[:, :, :1])


# --------------------------------------------------------------------------
# the engines against the JAX engines
# --------------------------------------------------------------------------

EP_ENGINE_KW = dict(max_slots=4, prefill_len=32, block_size=8, max_len=64,
                    strategy="token_to_expert", predict_interval=4,
                    dup_slots=1, prefetch_lead=2, migration_gate=False)
GPS_ENGINE_KW = dict(max_slots=4, prefill_len=32, block_size=8, max_len=64,
                     strategy="dist_only", predict_interval=2,
                     overlap_migration=False)
# reduced Mixtral: 4 experts, top-2 (skew cap 2) mapped onto the full
# model's cap of 4; min_saving sits between the windows' Token-to-Expert
# savings on the A100-PCIe preset (0.41-0.56 below it, 0.63-0.66 above)
CONTROLLER_KW = dict(window_iters=2, patience=1, min_saving=0.58,
                     skew_cap_observed=2.0, skew_cap_target=4.0)
TRACE_KW = dict(horizon=8.0, rate=1.5, seed=0)
PLAN_FIELDS = ("n_replicas", "replica_table", "pool_expert", "pool_sel")
COUNTERS = ("replans", "commits", "prebegun", "cancelled", "planned_bytes",
            "bytes_moved", "rejected")


def _requests(vocab):
    rng = np.random.default_rng(1)
    return [dict(rid=i, tokens=rng.integers(0, vocab, n).astype(np.int32),
                 max_new_tokens=10, arrival=float(i))
            for i, n in enumerate((5, 17, 11, 30, 9))]


# The predictor both engines use (each package's own class), and the
# serve loops that record what the engines did per iteration. Executed by
# the JAX subprocess and here.
CAPTURE = '''
def fit_predictor(cls, cfg, make_routing_trace):
    tr = make_routing_trace(num_sequences=64, seq_len=32,
                            vocab=cfg.vocab_size,
                            num_experts=cfg.moe.num_experts,
                            num_layers=cfg.num_layers, skew=1.5, seed=0)
    return cls(cfg.num_layers, cfg.moe.num_experts,
               cfg.vocab_size).fit(tr.experts, tr.tokens)


def serve_capture(eng, reqs, to_np, plan_fields, step_clock):
    import json
    eng.warmup()
    rec = {"plans": [], "prefill": {}, "decode": [], "lens": [],
           "dropped": [], "slot": {}, "in_force": [], "mig": [],
           "pred_counts": [], "strategy": [], "decisions": [],
           "n_windows": []}
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
    now = 0.0
    while eng.has_work() and len(rec["lens"]) < 100:
        sched = eng.scheduler
        if step_clock and (not sched.active_slots and sched.waiting
                           and sched.waiting[0].arrival > now):
            now = sched.waiting[0].arrival
        last.clear()
        before = eng.metrics.summary()["dropped_tokens"]
        ev = eng.step(now if step_clock else float(len(rec["lens"])))
        now += 0.25
        for r, lg in zip(ev.prefilled, last.get("prefill", [])):
            rec["prefill"][r.rid] = lg
            rec["slot"][r.rid] = r.slot
        rec["decode"].append(last.get("decode"))
        rec["lens"].append([len(r.generated) for r in reqs])
        rec["dropped"].append(eng.metrics.summary()["dropped_tokens"] - before)
        rec["in_force"].append({f: np.asarray(getattr(
            eng._plan_stack, f)).copy() for f in plan_fields})
        rec["mig"].append(dict(eng.metrics.migration))
        rec["pred_counts"].append(None if eng._pred_counts is None
                                  else eng._pred_counts.copy())
        rec["strategy"].append(eng.strategy)
        rec["n_windows"].append(len(eng.accuracy.windows))
        d = ev.decision
        rec["decisions"].append(None if d is None else (
            d.skew, d.volatility, str(d.recommended), d.strategy,
            d.predict_interval, d.switched))
    rec["accuracy"] = json.loads(json.dumps(eng.accuracy.to_obj()))
    rec["audit"] = (None if eng.controller is None else
                    json.loads(json.dumps(eng.controller.audit.to_obj())))
    rec["slots"] = [rec["slot"].get(r.rid) for r in reqs]
    rec["tokens"] = [list(r.generated) for r in reqs]
    return rec
'''

SUB = '''
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_allow_excess_precision=false")
import pickle
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

exec(os.environ["T2E_CAPTURE"])
fields = ("n_replicas", "replica_table", "pool_expert", "pool_sel")
to_np = lambda a: np.asarray(a, np.float32)
cfg = get_config("mixtral-8x7b").reduced()
params = init_model(jax.random.PRNGKey(0), cfg)
params["layers"]["moe"]["experts"] = jax.tree.map(
    lambda w: w.astype(jnp.bfloat16), params["layers"]["moe"]["experts"])
pred = fit_predictor(ConditionalProbabilityModel, cfg, make_routing_trace)
res = {}
mesh = jax.make_mesh((1, 4), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
eng = ContinuousEngine(cfg, params, ContinuousConfig(
    **eval(os.environ["T2E_EP_ENGINE"])), mesh=mesh, ep_ranks=4,
    predictor=pred)
reqs = [ServeRequest(**dict(r, tokens=np.asarray(r["tokens"], np.int32)))
        for r in eval(os.environ["T2E_REQUESTS"])]
with mesh:
    res["ep"] = serve_capture(eng, reqs, to_np, fields, False)
ctl = OnlineGPSController(get_config("mixtral-8x7b"), ControllerConfig(
    **eval(os.environ["T2E_CONTROLLER"])), predictor_available=True)
eng = ContinuousEngine(cfg, params, ContinuousConfig(
    **eval(os.environ["T2E_GPS_ENGINE"])), ep_ranks=4, predictor=pred,
    controller=ctl)
reqs = to_serve_requests(skew_shift_trace(cfg.vocab_size,
                                          **eval(os.environ["T2E_TRACE"])))
res["gps"] = serve_capture(eng, reqs, to_np, fields, True)
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    import pickle
    vocab = get_config("mixtral-8x7b").reduced().vocab_size
    out = tmp_path_factory.mktemp("t2e") / "jax_t2e.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               T2E_CAPTURE=CAPTURE, T2E_EP_ENGINE=repr(EP_ENGINE_KW),
               T2E_GPS_ENGINE=repr(GPS_ENGINE_KW),
               T2E_CONTROLLER=repr(CONTROLLER_KW), T2E_TRACE=repr(TRACE_KW),
               T2E_REQUESTS=repr([dict(r, tokens=r["tokens"].tolist())
                                  for r in _requests(vocab)]))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB),
                           str(out)], capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _scope():
    scope = {"np": np}
    exec(CAPTURE, scope)
    return scope


def _near_tie(logits) -> bool:
    """Top-2 margin under two bf16 ulps of the top logit."""
    a, b = np.sort(logits)[-2:][::-1]
    ulp = 2.0 ** (np.floor(np.log2(max(abs(a), 1e-30))) - 7)
    return a - b < 2 * ulp


def _compared_iterations(ref, rec, margins) -> int:
    """Iterations whose records must agree: all of them, or those before
    the first that dropped one or two pairs fewer or more than the JAX
    engine, or that produced the first differing token, which must come
    from near-tie JAX logits or (a decoded token) from a decode step whose
    route for that slot was a near tie in the port (``margins``: per
    iteration, each slot's least router top-k margin over the layers)."""
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
        slot = ref["slots"][rid]
        lg = ref["prefill"][rid] if i == 0 else ref["decode"][it][slot]
        route_tie = i > 0 and margins[it] is not None \
            and margins[it][slot] < ROUTE_TIE
        assert _near_tie(lg) or route_tie, \
            f"rid {rid} token {i} differs and is no near tie"
        return it
    np.testing.assert_array_equal(np.asarray(rec["lens"]),
                                  np.asarray(ref["lens"]))
    return len(rec["lens"])


def _assert_plans_equal(a, b, msg):
    for f in PLAN_FIELDS:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f"{f} {msg}")


def _assert_same_run(rec, ref, stop):
    for it in range(stop):
        _assert_plans_equal(rec["in_force"][it], ref["in_force"][it],
                            f"in force @ {it}")
        for k in COUNTERS:
            assert rec["mig"][it][k] == ref["mig"][it][k], (k, it)
        assert rec["strategy"][it] == ref["strategy"][it], it
        a, b = rec["pred_counts"][it], ref["pred_counts"][it]
        assert (a is None) == (b is None), it
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f"pred_counts @ {it}")
    np.testing.assert_array_equal(rec["dropped"][:stop], ref["dropped"][:stop])
    plans = [(i, p) for i, p in rec["plans"] if i <= stop]
    ref_plans = [(i, p) for i, p in ref["plans"] if i <= stop]
    assert [i for i, _ in plans] == [i for i, _ in ref_plans]
    for (i, p), (_, q) in zip(plans, ref_plans):
        _assert_plans_equal(p, q, f"re-plan @ {i}")
    # the accuracy windows closed within the compared iterations
    if stop:
        n_win = rec["n_windows"][stop - 1]
        assert n_win == ref["n_windows"][stop - 1]
        assert rec["accuracy"][:n_win] == ref["accuracy"][:n_win]


def _port_predictor(cfg):
    return _scope()["fit_predictor"](ConditionalProbabilityModel, cfg,
                                     make_routing_trace)


def _port_serve(eng, reqs, step_clock):
    """``serve_capture`` on the port's engine, recording also each decode
    step's least router top-k margin per slot over the layers."""
    from repro_torch.models import transformer

    margins, step_margins = [], []
    real_route, real_step = transformer.route, eng.step

    def recording_route(w, moe, x):
        if x.dim() == 2:                         # a decode step's tokens
            srt = torch.matmul(x.float(), w.float()).sort(
                -1, descending=True).values
            step_margins.append(srt[:, moe.top_k - 1] - srt[:, moe.top_k])
        return real_route(w, moe, x)

    def recording_step(now, clock=None):
        step_margins.clear()
        ev = real_step(now, clock)
        margins.append(torch.stack(step_margins).min(0).values.numpy()
                       if step_margins else None)
        return ev
    transformer.route, eng.step = recording_route, recording_step
    try:
        rec = _scope()["serve_capture"](eng, reqs,
                                        lambda t: t.float().numpy(),
                                        PLAN_FIELDS, step_clock)
    finally:
        transformer.route = real_route
    return rec, margins


def test_t2e_ep_engine_matches_meshed_jax_engine(jax_ref, jax_params):
    cfg, model = _port_model(jax_params)
    ref = jax_ref["ep"]
    eng = ContinuousEngine(cfg, model, ContinuousConfig(**EP_ENGINE_KW),
                           ep_ranks=4, ep=True,
                           predictor=_port_predictor(cfg))
    assert eng._store is not None
    predicted = []
    real = ep.ep_moe_ffn

    def recording(*a, predicted_idx=None, **kw):
        predicted.append(predicted_idx is not None)
        return real(*a, predicted_idx=predicted_idx, **kw)
    ep.ep_moe_ffn = recording
    try:
        rec, margins = _port_serve(
            eng, [ServeRequest(**r) for r in _requests(cfg.vocab_size)],
            False)
    finally:
        ep.ep_moe_ffn = real
    # warmup: one prefill without predictions, one with; then every EP
    # prefill layer dispatches on predictions
    L = cfg.num_layers
    assert not any(predicted[:L]) and all(predicted[L:])
    assert len(predicted) > 2 * L
    stop = _compared_iterations(ref, rec, margins)
    assert stop >= 6
    _assert_same_run(rec, ref, stop)
    last = rec["mig"][stop - 1]
    assert last["replans"] >= 1 and last["commits"] >= 1
    assert sum(rec["dropped"][:stop]) > 0          # the correction round drops
    assert rec["pred_counts"][stop - 1] is not None


def test_t2e_controller_decisions_match_jax_engine(jax_ref, jax_params):
    cfg, model = _port_model(jax_params)
    ref = jax_ref["gps"]
    ctl = OnlineGPSController(get_config("mixtral-8x7b"),
                              ControllerConfig(**CONTROLLER_KW),
                              predictor_available=True)
    eng = ContinuousEngine(cfg, model, ContinuousConfig(**GPS_ENGINE_KW),
                           ep_ranks=4, predictor=_port_predictor(cfg),
                           controller=ctl)
    reqs = to_serve_requests(skew_shift_trace(cfg.vocab_size, **TRACE_KW))
    rec, margins = _port_serve(eng, reqs, True)
    stop = _compared_iterations(ref, rec, margins)
    _assert_same_run(rec, ref, stop)
    assert rec["decisions"][:stop] == ref["decisions"][:stop]
    decided = [d for d in rec["decisions"][:stop] if d is not None]
    assert rec["audit"][:len(decided)] == ref["audit"][:len(decided)]
    # the compared run switches into Token-to-Expert and out of it
    into = [i for i, d in enumerate(decided)
            if d[5] and d[3] == "token_to_expert"]
    assert into and any(d[5] for d in decided[into[0] + 1:])
