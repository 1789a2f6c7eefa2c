"""Phase profiling in the port (``repro_torch.moe.profile``,
``ContinuousEngine.profile_phases``) against the JAX package, on the CPU.

* The numpy-drawn inputs of every profile function equal the JAX draws
  element for element (the JAX module's own ``_paged_attn_inputs``, and the
  draws of its other functions rebuilt here in its order).
* The port's phase chain route -> pack -> a2a -> ffn -> combine (both
  packers) against the JAX chain rebuilt from the blocks its
  ``dispatch_phase_times`` composes (``route``, ``dsp._PACKERS[impl]``,
  ``dsp.grouped_ffn``, its combine), fp32 at d 64, F 64, E 8, K 2, T 64,
  4 ranks: routes and packing equal, rows within 1e-5.
* The paged-attention inputs through the fused and the gather path
  against the JAX ``paged_decode_ref`` within 1e-5 (fp32).
* One migration chunk into the port's replica store against the JAX
  ``make_migrate_step`` on its store: every filled row equal, exactly.
* The engine: phase keys, ``total``, record / reset, the ``phase_*_us``
  columns, the span order on the "dispatch-profile" track equal to the
  JAX engine's, and ``_overlap_window_s``' last fallback equal to the JAX
  engine's for the same injected ``phase_times``.
Timings are only checked to be > 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import MoEConfig as JaxMoEConfig  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.moe import dispatch as jdsp  # noqa: E402
from repro.moe import profile as jprof  # noqa: E402
from repro.moe.router import route as jax_route  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.transformer import init_model  # noqa: E402
from repro_torch.moe import profile as prof  # noqa: E402
from repro_torch.obs import SpanTracer  # noqa: E402
from repro_torch.serve import ContinuousConfig, ContinuousEngine  # noqa: E402

SMALL = dict(d_model=64, d_ff=64, num_experts=8, tokens=64, seed=3)
TOP_K, RANKS, CF = 2, 4, 1.25
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return t.detach().float().numpy() if t.is_floating_point() \
        else t.detach().numpy()


# --------------------------------------------------------------------------
# the JAX draws, in the order of repro/moe/profile.py
# --------------------------------------------------------------------------

def _jax_dispatch_draws(d_model, d_ff, num_experts, tokens, seed):
    rng = np.random.default_rng(seed)
    T, E, d = tokens, num_experts, d_model
    x = jnp.asarray(rng.normal(size=(T, d)), jnp.float32)
    router = {"w": jnp.asarray(rng.normal(size=(d, E)) * 0.02, jnp.float32)}
    slot_w = {
        "w_gate": jnp.asarray(rng.normal(size=(E, d, d_ff)) * 0.02,
                              jnp.float32),
        "w_up": jnp.asarray(rng.normal(size=(E, d, d_ff)) * 0.02,
                            jnp.float32),
        "w_down": jnp.asarray(rng.normal(size=(E, d_ff, d)) * 0.02,
                              jnp.float32),
    }
    return x, router, slot_w


def _jax_migrate_draws(d_model, d_ff, num_experts, ranks, dup_slots, layers,
                       chunk, seed):
    rng = np.random.default_rng(seed)
    E, L = num_experts, layers
    experts = {
        "w_gate": jnp.asarray(rng.normal(size=(L, E, d_model, d_ff)) * 0.02,
                              jnp.float32),
        "w_up": jnp.asarray(rng.normal(size=(L, E, d_model, d_ff)) * 0.02,
                            jnp.float32),
        "w_down": jnp.asarray(rng.normal(size=(L, E, d_ff, d_model)) * 0.02,
                              jnp.float32),
    }
    n_slots = E // ranks + dup_slots
    layer = jnp.asarray(rng.integers(0, L, chunk), jnp.int32)
    dst = jnp.asarray((rng.integers(0, ranks, chunk) * n_slots
                       + E // ranks + rng.integers(0, dup_slots, chunk)),
                      jnp.int32)
    src = jnp.asarray(rng.integers(0, E, chunk), jnp.int32)
    return experts, layer, dst, src


MIGRATE = dict(d_model=64, d_ff=32, num_experts=8, ranks=4, dup_slots=2,
               layers=2, chunk=8, seed=5)
ATTN = dict(batch=4, num_kv=2, gqa=4, head_dim=32, block_size=8,
            max_blocks=6, valid_frac=0.6, seed=7)


def test_dispatch_and_pack_inputs_equal_the_jax_draws():
    port = prof.dispatch_inputs(**SMALL, device="cpu")
    x, router, slot_w = _jax_dispatch_draws(**SMALL)
    np.testing.assert_array_equal(_np(port["x"]), np.asarray(x))
    np.testing.assert_array_equal(_np(port["w_router"]),
                                  np.asarray(router["w"]))
    for k in slot_w:
        np.testing.assert_array_equal(_np(port["slot_w"][k]),
                                      np.asarray(slot_w[k]))
    p = prof.pack_inputs(d_model=32, num_experts=8, top_k=2, tokens=40,
                         seed=2, device="cpu")
    rng = np.random.default_rng(2)
    jx = jnp.asarray(rng.normal(size=(40, 32)), jnp.float32)
    jg = jnp.asarray(rng.integers(0, 8, 80), jnp.int32)
    np.testing.assert_array_equal(_np(p["x"]), np.asarray(jx))
    np.testing.assert_array_equal(_np(p["gslot"]), np.asarray(jg))


def test_migrate_inputs_equal_the_jax_draws():
    port = prof.migrate_inputs(**MIGRATE, device="cpu")
    experts, layer, dst, src = _jax_migrate_draws(**MIGRATE)
    for k, w in experts.items():
        np.testing.assert_array_equal(
            np.stack([_np(t) for t in port["experts"][k]]), np.asarray(w))
    np.testing.assert_array_equal(port["layer"], np.asarray(layer))
    np.testing.assert_array_equal(port["dst"], np.asarray(dst))
    np.testing.assert_array_equal(port["src"], np.asarray(src))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_paged_attention_inputs_equal_the_jax_draws(dtype):
    port = prof._paged_attn_inputs(**ATTN, dtype=getattr(torch, dtype),
                                   device="cpu")
    ref = jprof._paged_attn_inputs(**ATTN, dtype=getattr(jnp, dtype))
    for a, b in zip(port, ref):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        np.testing.assert_array_equal(_np(a), np.asarray(b).astype(
            np.float32) if a.is_floating_point() else np.asarray(b))


# --------------------------------------------------------------------------
# the phase chain
# --------------------------------------------------------------------------

def _jax_chain(x, router, slot_w, impl):
    """The chain of repro/moe/profile.py's dispatch_phase_times."""
    T, d = x.shape
    E = router["w"].shape[1]
    K, S = TOP_K, E
    N = T * K
    n_slots = S // RANKS
    cap = jdsp.capacity(T, K, S, CF)
    moe = JaxMoEConfig(num_experts=E, top_k=K, d_ff_expert=slot_w[
        "w_up"].shape[2], capacity_factor=CF, dispatch_impl=impl)
    out = jax_route(router, moe, x, impl="dense")
    gslot = out.expert_idx.reshape(-1)
    token_of = jnp.arange(N, dtype=jnp.int32) // K
    send, in_cap, dest, counts, _ = jdsp._PACKERS[impl](
        x, token_of, gslot, jnp.ones((N,), bool), num_classes=S, cap=cap)
    recv_a2a = send.reshape(RANKS, n_slots, cap, d).transpose(
        1, 0, 2, 3).reshape(n_slots, RANKS * cap, d)
    ys = jdsp.grouped_ffn(slot_w, send.reshape(S, cap, d),
                          "swiglu").reshape(S * cap, d)
    y_flat = jnp.where(in_cap[:, None], ys[jnp.minimum(dest, S * cap - 1)],
                       0.0)
    y = (y_flat.reshape(T, K, d) * out.gates[..., None]).sum(axis=1)
    return dict(idx=out.expert_idx, gates=out.gates, send=send,
                in_cap=in_cap, dest=dest, counts=counts, recv=recv_a2a,
                ys=ys, y=y)


@pytest.mark.parametrize("impl", ["sort", "onehot"])
def test_phase_chain_matches_the_jax_chain(impl):
    port = prof.dispatch_inputs(**SMALL, device="cpu")
    phases, out = prof.dispatch_chain(
        port["x"], port["w_router"], port["slot_w"], top_k=TOP_K,
        ranks=RANKS, capacity_factor=CF, impl=impl)
    ref = _jax_chain(*_jax_dispatch_draws(**SMALL), impl)
    assert set(phases) == set(prof.PHASES)
    np.testing.assert_array_equal(_np(out["route"].expert_idx),
                                  np.asarray(ref["idx"]))
    np.testing.assert_allclose(_np(out["route"].gates),
                               np.asarray(ref["gates"]), atol=TOL)
    for k in ("in_cap", "dest", "counts"):
        np.testing.assert_array_equal(_np(out[k]), np.asarray(ref[k]),
                                      err_msg=k)
    for k in ("send", "recv"):
        np.testing.assert_array_equal(_np(out[k]), np.asarray(ref[k]),
                                      err_msg=k)
    assert out["recv"].is_contiguous()
    assert out["recv"].data_ptr() != out["send"].data_ptr()
    for k in ("ys", "y"):
        np.testing.assert_allclose(_np(out[k]), np.asarray(ref[k]),
                                   atol=TOL, err_msg=k)
    assert float(out["y"].abs().max()) > 0
    # each phase's callable reproduces its output on its recorded inputs
    fn, args = phases["combine"]
    np.testing.assert_array_equal(_np(fn(*args)), _np(out["y"]))


def test_dispatch_phase_times_keys_and_total():
    t = prof.dispatch_phase_times(**SMALL, top_k=TOP_K, ranks=RANKS,
                                  iters=1, device="cpu")
    assert set(t) == set(prof.PHASES) | {"total"}
    assert all(v > 0 for v in t.values())
    assert t["total"] == sum(t[p] for p in prof.PHASES)
    p = prof.pack_impl_times(d_model=32, num_experts=8, tokens=64, iters=1,
                             device="cpu")
    assert set(p) == {"sort", "onehot"} and all(v > 0 for v in p.values())


# --------------------------------------------------------------------------
# paged attention and migration
# --------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["fused", "gather"])
def test_attention_paths_match_the_jax_reference(impl):
    window = 13
    q, kp, vp, tables, lengths = prof._paged_attn_inputs(
        **ATTN, dtype=torch.float32, device="cpu")
    got = prof._attn_fns(q, tables, lengths, window)[impl](q, kp, vp)
    jq, jk, jv, jt, jl = jprof._paged_attn_inputs(**ATTN,
                                                  dtype=jnp.float32)
    B, K, _, hd = jq.shape
    want = jref.paged_decode_ref(jq, jk[jt].reshape(B, -1, K, hd),
                                 jv[jt].reshape(B, -1, K, hd), jl,
                                 window=window,
                                 block_size=ATTN["block_size"])
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=TOL)
    t = prof.attn_phase_times(**ATTN, impl=impl, iters=1, device="cpu")
    assert set(t) == {prof.ATTN_PHASE} and t[prof.ATTN_PHASE] > 0
    both = prof.attn_impl_times(**ATTN, iters=1, device="cpu")
    assert set(both) == {"fused", "gather"}


def test_migrate_chunk_matches_the_jax_step():
    from repro.core.placement import identity_plan as jax_identity
    from repro.core.placement import stack_plans as jax_stack
    from repro.runtime import ReplicaStore as JaxStore
    from repro.runtime import make_migrate_step as jax_make_step
    from repro_torch.core.placement import identity_plan, stack_plans
    from repro_torch.runtime import ReplicaStore, make_migrate_step

    E, R, D, L = (MIGRATE[k] for k in ("num_experts", "ranks", "dup_slots",
                                       "layers"))
    experts, layer, dst, src = _jax_migrate_draws(**MIGRATE)
    jstore = JaxStore.from_params(experts, jax_stack(
        [jax_identity(E, R, D, 4) for _ in range(L)]), num_experts=E,
        ep_ranks=R, dup_slots=D)
    jout = jax_make_step(None, num_experts=E, ep_ranks=R, dup_slots=D)(
        jstore.weights, experts, layer, dst, src, jnp.ones((len(src),), bool))

    inp = prof.migrate_inputs(**MIGRATE, device="cpu")
    store = ReplicaStore.from_params(inp["experts"], stack_plans(
        [identity_plan(E, R, D, 4) for _ in range(L)]), num_experts=E,
        ep_ranks=R, dup_slots=D)
    make_migrate_step(store)(inp["layer"], inp["dst"], inp["src"])
    filled = {(int(l), int(s)) for l, s in zip(inp["layer"], inp["dst"])}
    assert len(filled) > 1
    for l, s in sorted(filled):
        for k in jout:
            np.testing.assert_array_equal(
                _np(store.weights[k][l][store.back_row(l, s)]),
                np.asarray(jout[k][l, s]), err_msg=f"{k} layer {l} slot {s}")
    t = prof.migrate_phase_time(**MIGRATE, iters=1, device="cpu")
    assert set(t) == {prof.MIGRATE_PHASE, prof.PREFETCH_PHASE}
    assert all(v > 0 for v in t.values())


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

CCFG = dict(max_slots=2, prefill_len=16, block_size=8, max_len=32,
            strategy="dist_only", dup_slots=1)
SPAN_ORDER = ["attn", "route", "pack", "a2a", "ffn", "combine", "migrate"]


@pytest.fixture(scope="module")
def engine():
    cfg = get_config("mixtral-8x7b").reduced()
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    return ContinuousEngine(cfg, model, ContinuousConfig(**CCFG),
                            tracer=SpanTracer())


@pytest.fixture(scope="module")
def jax_engine():
    from repro.models.transformer import init_model as jax_init
    from repro.obs import SpanTracer as JaxTracer
    from repro.serve import ContinuousConfig as JaxCCfg
    from repro.serve import ContinuousEngine as JaxEngine
    cfg = jax_get_config("mixtral-8x7b").reduced()
    return JaxEngine(cfg, jax_init(jax.random.PRNGKey(0), cfg),
                     JaxCCfg(**CCFG), tracer=JaxTracer())


def _profile_spans(tracer):
    doc = tracer.to_chrome()
    tids = {e["args"]["name"]: e["tid"] for e in doc["traceEvents"]
            if e.get("ph") == "M" and e.get("name") == "thread_name"}
    tid = tids["dispatch-profile"]
    return [e["name"] for e in doc["traceEvents"]
            if e.get("ph") == "X" and e["tid"] == tid]


def test_profile_phases_records_and_resets(engine):
    m = engine.metrics
    m.reset_phases()
    ops.reset_launches()
    phases = engine.profile_phases(iters=1)
    assert set(phases) == {"attn", *prof.PHASES, "total", "migrate",
                           "prefetch"}
    assert all(v > 0 for v in phases.values())
    assert phases["total"] == sum(phases[p] for p in prof.PHASES)
    assert m.phase_times == phases
    cols = {k: v for k, v in m.summary().items() if k.startswith("phase_")}
    assert cols == {f"phase_{k}_us": v * 1e6 for k, v in phases.items()}
    # recorded once: a second profile, or a what-if packer, only returns
    again = engine.profile_phases(iters=1, tokens=CCFG["max_slots"])
    assert m.phase_times == phases and again != phases
    engine.profile_phases(iters=1, impl="onehot")
    assert m.phase_times == phases
    assert m.reset_phases() == phases and m.phase_times == {}
    decode = engine.profile_phases(iters=1, tokens=CCFG["max_slots"])
    assert m.phase_times == decode
    assert _profile_spans(engine.tracer) == SPAN_ORDER * 4
    # the CPU runs the plain versions: no kernel was launched
    assert all(v == 0 for v in ops.LAUNCHES.values())


def test_profile_phases_time_the_draws_kept_between_calls(engine,
                                                          monkeypatch):
    """``draw_profile_inputs`` draws each shape's dispatch inputs and the
    migration inputs once, the values ``dispatch_inputs`` /
    ``migrate_inputs`` give at seed 0; ``profile_phases`` times what the
    ``draws`` dict holds and draws only what it lacks."""
    calls = []

    def spy(real):
        def fn(*a, **kw):
            calls.append((real.__name__, kw.get("tokens")))
            return real(*a, **kw)
        return fn
    for name in ("dispatch_inputs", "migrate_inputs"):
        monkeypatch.setattr(prof, name, spy(getattr(prof, name)))
    timed = []
    for name in ("dispatch_phase_times", "migrate_phase_time"):
        def timer(_real=getattr(prof, name), **kw):
            timed.append(kw["inputs"])
            return _real(**kw)
        monkeypatch.setattr(prof, name, timer)
    shapes = (CCFG["prefill_len"], CCFG["max_slots"])
    draws = engine.draw_profile_inputs(shapes, {})
    assert sorted(calls, key=str) == sorted(
        [("dispatch_inputs", t) for t in shapes]
        + [("migrate_inputs", None)], key=str)
    assert set(draws) == {("dispatch", t) for t in shapes} | {"migrate"}
    width = dict(d_model=engine.cfg.d_model, d_ff=engine.moe_cfg.d_ff_expert,
                 num_experts=engine.moe_cfg.num_experts, seed=0,
                 device="cpu")
    for t in shapes:
        got = draws[("dispatch", t)]
        want = prof.dispatch_inputs(tokens=t, **width)
        assert torch.equal(got["x"], want["x"])
        assert torch.equal(got["w_router"], want["w_router"])
        assert all(torch.equal(got["slot_w"][k], want["slot_w"][k])
                   for k in want["slot_w"])
    want = prof.migrate_inputs(ranks=engine.ep_ranks if engine.ep else 1,
                               dup_slots=1,
                               layers=engine.cfg.num_layers,
                               chunk=engine.ccfg.migrate_chunk, **width)
    got = draws["migrate"]
    assert all(torch.equal(a, b) for k in want["experts"]
               for a, b in zip(got["experts"][k], want["experts"][k]))
    assert all(np.array_equal(got[k], want[k])
               for k in ("layer", "dst", "src"))
    calls.clear()
    for t in shapes:
        phases = engine.profile_phases(iters=1, tokens=t, draws=draws)
        assert set(phases) == set(SPAN_ORDER) | {"total", "prefetch"}
    assert calls == []                       # nothing drawn again
    assert timed == [draws[("dispatch", shapes[0])], draws["migrate"],
                     draws[("dispatch", shapes[1])], draws["migrate"]]
    # without a dict, each call draws its own
    engine.profile_phases(iters=1, tokens=shapes[1])
    assert sorted(calls, key=str) == [("dispatch_inputs", shapes[1]),
                                      ("migrate_inputs", None)]


def test_profile_span_order_matches_the_jax_engine(jax_engine):
    jphases = jax_engine.profile_phases(iters=1)
    assert _profile_spans(jax_engine.tracer) == SPAN_ORDER
    assert set(jphases) == {"attn", *prof.PHASES, "total", "migrate",
                            "prefetch"}
    assert jax_engine.metrics.phase_times == jphases


def test_overlap_window_falls_back_to_the_phase_total(engine, jax_engine):
    injected = {"route": 1.5e-4, "pack": 2.5e-4, "total": 7.25e-4}
    for eng in (engine, jax_engine):
        eng.metrics.reset_phases()
        eng.metrics.record_phases(injected)
        assert eng._recent_step_s == 0.0
    got = engine._overlap_window_s()
    assert got == jax_engine._overlap_window_s()
    assert got == 7.25e-4 * engine.cfg.num_layers
    engine._recent_step_s = 0.02            # a measured step wins
    assert engine._overlap_window_s() == 0.02
    engine._recent_step_s = 0.0
    assert engine._overlap_budget() >= 0
    engine.metrics.reset_phases()
    jax_engine.metrics.reset_phases()
