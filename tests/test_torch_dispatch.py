"""The PyTorch port's expert-parallel dispatch (``repro_torch.moe.dispatch``)
against the JAX package's ``moe/dispatch.py``.

* The packers are pure functions: ``_pack_sort`` and ``_pack_onehot`` must
  give JAX's send buffer, in-capacity mask, destinations, per-slot counts
  and drop count bit for bit, on ``tests/test_dispatch_equivalence.py``'s
  grid (each case's two validity masks packed as two rank rows of one
  call) and its first-come case.
* ``choose_replica`` and ``core.placement.slot_experts`` are exact against
  JAX's replica choice and the slot weights its ``_slot_weights`` builds.
* ``ep_moe_ffn`` and ``ep_moe_ffn_replicated`` run with their R ranks as
  a leading dimension; the reference is ``jax.vmap(..., axis_name="model")``
  of the JAX functions with ``use_kernel=True`` (Pallas in interpret mode),
  which runs their collectives over R ranks in one process. Over R in
  {1, 2, 4}, one or two replica slots, capacity factors 1.0 and 8.0, and
  the identity and a duplicated plan: ``slot_counts``, ``dropped`` and the
  expert counts are equal, and y agrees within 1e-5 in fp32 (the same
  arithmetic, summed in another order) and within ``BF16_ATOL`` in bf16
  (a bf16 ulp of outputs of magnitude ~1, where a one-ulp difference of an
  fp32 sum flips a rounding).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import MoEConfig as JaxMoEConfig  # noqa: E402
from repro.core.duplication import duplicate_experts_host as jax_dup  # noqa: E402
from repro.core.placement import identity_plan as jax_identity  # noqa: E402
from repro.moe import dispatch as jep  # noqa: E402
from repro.moe.router import route as jax_route  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core.placement import (PlacementPlan, slot_experts,  # noqa: E402
                                        to_device)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.moe import dispatch as ep  # noqa: E402
from repro_torch.moe.router import route  # noqa: E402
from repro_torch.schedule import even_quota  # noqa: E402

PACK_FIELDS = ("send", "in_cap", "dest", "counts", "dropped")
PACKERS = {"sort": (ep._pack_sort, jep._pack_sort),
           "onehot": (ep._pack_onehot, jep._pack_onehot)}
T, D_MODEL, F, E, K = 32, 32, 64, 8, 2
BF16_ATOL = 1e-2


# --------------------------------------------------------------------------
# packers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["sort", "onehot"])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("cap", [1, 8, 64])
@pytest.mark.parametrize("num_classes", [2, 16, 33])
def test_packers_match_jax_bit_for_bit(impl, top_k, cap, num_classes):
    rng = np.random.default_rng(top_k * 1000 + cap * 10 + num_classes)
    Tn, d = 96, 8
    N = Tn * top_k
    x = rng.normal(size=(Tn, d)).astype(np.float32)
    token_of = np.arange(N, dtype=np.int32) // top_k
    # skewed assignment so some slots overflow the capacity
    gslot = (rng.integers(0, num_classes, N) ** 2 % num_classes).astype(np.int32)
    valid = np.stack([rng.random(N) < f for f in (1.0, 0.7)])      # 2 rows
    got = PACKERS[impl][0](
        torch.tensor(x).expand(2, Tn, d), torch.tensor(token_of),
        torch.tensor(gslot).expand(2, N), torch.tensor(valid),
        num_classes=num_classes, cap=cap)
    for r in range(2):
        want = jep._pack_sort(jnp.asarray(x), jnp.asarray(token_of),
                              jnp.asarray(gslot), jnp.asarray(valid[r]),
                              num_classes=num_classes, cap=cap,
                              use_kernel=True)
        if impl == "onehot":
            want = jep._pack_onehot(jnp.asarray(x), jnp.asarray(token_of),
                                    jnp.asarray(gslot), jnp.asarray(valid[r]),
                                    num_classes=num_classes, cap=cap)
        for g, w, name in zip(got, want, PACK_FIELDS):
            assert np.array_equal(g[r].numpy(), np.asarray(w)), name


@pytest.mark.parametrize("impl", ["sort", "onehot"])
def test_pack_drop_rule_is_first_come(impl):
    """Capacity 1 with every token on one slot: only the FIRST token in
    token order survives, as in JAX."""
    Tn, d, S = 16, 4, 4
    x = np.arange(Tn * d, dtype=np.float32).reshape(Tn, d)
    args = (np.arange(Tn, dtype=np.int32), np.zeros((Tn,), np.int32),
            np.ones((Tn,), bool))
    send, in_cap, _, counts, dropped = PACKERS[impl][0](
        torch.tensor(x)[None], torch.tensor(args[0]),
        torch.tensor(args[1])[None], torch.tensor(args[2])[None],
        num_classes=S, cap=1)
    want = PACKERS[impl][1](jnp.asarray(x), *map(jnp.asarray, args),
                            num_classes=S, cap=1)
    assert in_cap[0].tolist() == [True] + [False] * (Tn - 1)
    assert torch.equal(send[0, 0], torch.tensor(x[0]))
    assert int(dropped[0]) == Tn - 1 and counts[0].tolist() == [1, 0, 0, 0]
    for g, w, name in zip((send, in_cap, _, counts, dropped), want,
                          PACK_FIELDS):
        assert np.array_equal(g[0].numpy(), np.asarray(w)), name


# --------------------------------------------------------------------------
# replica choice and the slot -> expert map
# --------------------------------------------------------------------------

def _plan(R, D, duplicated, seed=0):
    if not duplicated:
        return jax_identity(E, R, D, 4)
    rng = np.random.default_rng(seed)
    dist = rng.random(E) ** 4
    dist[rng.integers(E)] += 1.0                     # one hot expert
    return jax_dup(dist / dist.sum(), R, D, 4).plan


def _port_plan(plan):
    return PlacementPlan(*(np.asarray(a) for a in plan))


@pytest.mark.parametrize("R,D", [(2, 1), (4, 1), (4, 2)])
def test_choose_replica_matches_jax(R, D):
    plan = _plan(R, D, True, seed=R + D)
    assert int((np.asarray(plan.n_replicas) - 1).sum()) > 0
    rng = np.random.default_rng(0)
    expert = rng.integers(0, E, 500).astype(np.int32)
    salt = rng.integers(0, 1000, 500).astype(np.int32)
    want = jep.choose_replica(jax.tree.map(jnp.asarray, plan),
                              jnp.asarray(expert), jnp.asarray(salt))
    got = ep.choose_replica(to_device(_port_plan(plan), E, R, D, "cpu"),
                            torch.tensor(expert), torch.tensor(salt))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("R,D", [(1, 1), (2, 1), (4, 1), (4, 2), (8, 1)])
@pytest.mark.parametrize("duplicated", [False, True])
def test_slot_experts_match_jax_slot_weights(R, D, duplicated):
    """Expert e's weights hold the value e, so the slot weights JAX builds
    (home experts + the gathered replica pool, per rank) spell out which
    expert each slot computes with."""
    plan = _plan(R, D, duplicated, seed=R * 10 + D)
    e_loc = E // R
    w_local = {"w": jnp.arange(E, dtype=jnp.float32).reshape(R, e_loc, 1)}
    jplan = jax.tree.map(jnp.asarray, plan)

    def per_rank(w):
        return jep._resolve_slot_weights(w, None, jplan, D, R, "model")["w"]
    want = np.asarray(jax.vmap(per_rank, axis_name="model")(w_local))
    got = slot_experts(_port_plan(plan), E, R, D)
    assert got.dtype == np.int32 and got.shape == (R * (e_loc + D),)
    if duplicated:
        np.testing.assert_array_equal(got, want.reshape(-1))
    else:
        # the identity plan's pool is zeros in JAX (no pair is routed to a
        # replica slot); the home slots must match
        home = got.reshape(R, e_loc + D)[:, :e_loc]
        np.testing.assert_array_equal(home, want[:, :e_loc, 0])
    stacked = slot_experts(PlacementPlan(*(np.stack([a, a]) for a in
                                           _port_plan(plan))), E, R, D)
    np.testing.assert_array_equal(stacked, np.stack([got, got]))


# --------------------------------------------------------------------------
# ep_moe_ffn / ep_moe_ffn_replicated against the vmapped JAX functions
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


def _jax_ep(fn_name, R, moe, x, wr, w, dtype):
    """vmap over R ranks of the JAX function, jitted with the plan as an
    argument so both plans share one compile."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    w_local = {n: jnp.asarray(a, jdt).reshape(R, E // R, *a.shape[1:])
               for n, a in w.items()}
    xj = jnp.asarray(x, jdt)
    router = {"w": jnp.asarray(wr)}

    def per_rank(xb, wb, plan):
        if fn_name == "ep_moe_ffn":
            ro = jax_route(router, moe, xb, impl="fused")
            return jep.ep_moe_ffn(xb, ro, wb, plan, moe, axis_name="model",
                                  ep_ranks=R, use_kernel=True)
        ro = jax_route(router, moe, xj[0], impl="fused")
        return jep.ep_moe_ffn_replicated(xj[0], ro, wb, plan, moe,
                                         axis_name="model", ep_ranks=R,
                                         use_kernel=True)
    run = jax.jit(jax.vmap(per_rank, axis_name="model",
                           in_axes=(0, 0, None)))
    return lambda plan: run(xj, w_local, jax.tree.map(jnp.asarray, plan))


def _port_ep(fn_name, R, D, moe, x, wr, w, plan, dtype):
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    xt = torch.tensor(x).to(tdt)
    wt = {n: torch.tensor(a).to(tdt) for n, a in w.items()}
    dp = to_device(_port_plan(plan), E, R, D, "cpu")
    if fn_name == "ep_moe_ffn":
        ro = route(torch.tensor(wr), moe, xt)
        return ep.ep_moe_ffn(xt, ro, wt, dp, moe, ep_ranks=R)
    ro = route(torch.tensor(wr), moe, xt[0])
    return ep.ep_moe_ffn_replicated(xt[0], ro, wt, dp, moe, ep_ranks=R)


def _compare(fn_name, R, D, cf, dtype, seed):
    moe_kw = dict(num_experts=E, top_k=K, d_ff_expert=F, capacity_factor=cf,
                  duplication_slots=D)
    jmoe, moe = JaxMoEConfig(**moe_kw), MoEConfig(**moe_kw)
    x, wr, w = _inputs(R, seed)
    jax_fn = _jax_ep(fn_name, R, jmoe, x, wr, w, dtype)
    dropped = {}
    for duplicated in (False, True):
        plan = _plan(R, D, duplicated, seed=seed)
        yj, sj = jax_fn(plan)
        ops.reset_launches()
        yt, st = _port_ep(fn_name, R, D, moe, x, wr, w, plan, dtype)
        assert sum(ops.LAUNCHES.values()) == 0
        # vmap stacks the rank axis onto every output; the replicated
        # function's y and all statistics are the same on every rank
        yj = np.asarray(yj, np.float32)
        want_y = yj if fn_name == "ep_moe_ffn" else yj[0]
        atol = 1e-5 if dtype == "float32" else BF16_ATOL
        np.testing.assert_allclose(yt.float().numpy(), want_y, atol=atol,
                                   rtol=0 if dtype == "float32" else atol)
        for name in ("expert_counts", "slot_counts", "dropped"):
            np.testing.assert_array_equal(
                getattr(st, name).numpy(), np.asarray(getattr(sj, name))[0],
                err_msg=f"{name} (duplicated={duplicated})")
        for name in ("aux_loss", "z_loss"):
            np.testing.assert_allclose(getattr(st, name).numpy(),
                                       np.asarray(getattr(sj, name))[0],
                                       rtol=1e-5)
        dropped[duplicated] = int(st.dropped)
    return dropped


@pytest.mark.parametrize("fn_name", ["ep_moe_ffn", "ep_moe_ffn_replicated"])
@pytest.mark.parametrize("R", [1, 2, 4])
@pytest.mark.parametrize("D", [1, 2])
@pytest.mark.parametrize("cf", [1.0, 8.0])
def test_ep_moe_ffn_matches_vmapped_jax_fp32(fn_name, R, D, cf):
    dropped = _compare(fn_name, R, D, cf, "float32", seed=R * 10 + D)
    if cf == 1.0:
        assert dropped[False] > 0            # the hot expert overflows
    else:
        assert dropped == {False: 0, True: 0}


@pytest.mark.parametrize("fn_name", ["ep_moe_ffn", "ep_moe_ffn_replicated"])
def test_ep_moe_ffn_matches_vmapped_jax_bf16(fn_name):
    dropped = _compare(fn_name, 4, 1, 1.0, "bfloat16", seed=7)
    assert dropped[False] > 0


def test_unported_modes_raise():
    """Token-to-Expert predictions compute in ``ep_moe_ffn`` (predictions
    equal to the routes leave nothing to correct: the result is the
    one-round dispatch's, bit for bit) and raise the JAX package's message
    in ``ep_moe_ffn_replicated``, a prefill feature there, also with a
    quota; a reschedule quota is accepted by both functions: the even
    quota on the identity plan picks every pair's home slot, as round
    robin does, and at a capacity factor of 8 nothing overflows, so both
    give the one-round result bit for bit with ``overflow`` 0."""
    moe = MoEConfig(num_experts=E, top_k=K, d_ff_expert=F)
    x, wr, w = _inputs(2, 0)
    host_plan = _port_plan(_plan(2, 0, False))
    plan = to_device(host_plan, E, 2, 0, "cpu")
    ro = route(torch.tensor(wr), moe, torch.tensor(x))
    wt = {n: torch.tensor(a) for n, a in w.items()}
    y0, s0 = ep.ep_moe_ffn(torch.tensor(x), ro, wt, plan, moe, ep_ranks=2)
    y1, s1 = ep.ep_moe_ffn(torch.tensor(x), ro, wt, plan, moe, ep_ranks=2,
                           predicted_idx=ro.expert_idx)
    assert torch.equal(y0, y1)
    for name in ("expert_counts", "slot_counts", "dropped"):
        assert torch.equal(getattr(s0, name), getattr(s1, name)), name
    quota = torch.tensor(even_quota(host_plan))
    with pytest.raises(NotImplementedError, match="prefill feature"):
        ep.ep_moe_ffn_replicated(torch.tensor(x[0]), ro, wt, plan, moe,
                                 ep_ranks=2, predicted_idx=ro.expert_idx,
                                 resched_quota=quota)
    roomy = MoEConfig(num_experts=E, top_k=K, d_ff_expert=F,
                      capacity_factor=8.0)
    ro1 = route(torch.tensor(wr), roomy, torch.tensor(x[0]))
    for fn, xs, r in ((ep.ep_moe_ffn, x, ro),
                      (ep.ep_moe_ffn_replicated, x[0], ro1)):
        ya, sa = fn(torch.tensor(xs), r, wt, plan, roomy, ep_ranks=2)
        yb, sb = fn(torch.tensor(xs), r, wt, plan, roomy, ep_ranks=2,
                    resched_quota=quota)
        assert torch.equal(ya, yb) and sa.overflow == 0
        assert int(sb.overflow) == 0 and int(sb.dropped) == 0
        for name in ("expert_counts", "slot_counts", "dropped"):
            assert torch.equal(getattr(sa, name), getattr(sb, name)), name
