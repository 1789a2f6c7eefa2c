"""The port's replica runtime (``repro_torch.runtime``) against the JAX
package's ``repro.runtime``, on the CPU.

* Cost model: every function of ``runtime/cost.py`` on the same inputs
  over a grid, exactly equal.
* Plan diffs: ``plan_diff``, ``apply_diff``, ``plans_equal``,
  ``vacated_slots`` and ``stacked_slot_experts`` on plans both packages'
  ``duplicate_experts_host`` build from the same ``skewed_distribution``
  inputs, exactly equal.
* Executors: the port's ``ReplicaStore`` and ``MigrationExecutor`` /
  ``LayerStagedExecutor`` against the JAX store and executors without a
  mesh (``make_migrate_step(None, ...)``), on fp32 toy experts with L = 3,
  E = 8, R = 4 and D of 1 and 2. For one chain of diffs and one budget
  sequence both give equal bytes per tick, ready masks, commit ticks,
  versions and slot maps, and every live slot's row holds exactly the JAX
  store's entry (the port keeps a live and a back row per replica slot
  where JAX keeps a whole back copy). A cancelled fill followed by a
  migration to a third plan lands exactly.
* Forward through the store: reduced Mixtral (bridged weights) on the EP
  path, dup_slots 2. At every state of a layer-staged fill, a prefill and
  a decode step through the store view equal, bit for bit, the port's
  ``replica_impl="gather"`` forward under the per-layer mixed plan (ready
  layers on the target plan, the others on the old one), as
  ``tests/test_overlap_prefetch.py`` holds the JAX store against its
  gather oracle; the gather path is held against JAX in
  ``tests/test_torch_ep_serve.py``. Overwriting one filled row of a ready
  layer changes the output: the rows are what the replica slots read.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.core.duplication import \
    duplicate_experts_host as jax_dup  # noqa: E402
from repro.core.placement import identity_plan as jax_identity  # noqa: E402
from repro.core.placement import stack_plans as jax_stack  # noqa: E402
from repro.core.simulator import A100_PCIE as JAX_A100_PCIE  # noqa: E402
from repro.data.synthetic import skewed_distribution  # noqa: E402
from repro.models.transformer import init_model as jax_init_model  # noqa: E402
import repro.runtime as jrt  # noqa: E402
from repro.runtime import cost as jcost  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.duplication import duplicate_experts_host  # noqa: E402
from repro_torch.core.placement import (PlacementPlan, identity_plan,  # noqa: E402
                                        stack_plans, to_device)
from repro_torch.core.simulator import A100_PCIE  # noqa: E402
from repro_torch.models.transformer import Runtime, StoreView  # noqa: E402
from repro_torch.runtime import cost as tcost  # noqa: E402
import repro_torch.runtime as trt  # noqa: E402
from repro_torch.serve import kvcache as tkv  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

E, R, L = 8, 4, 3


def _np_plan(plan):
    return PlacementPlan(*(np.asarray(a) for a in plan))


def _dists(layers, seed):
    """Per-layer skewed expert distributions (the tests' shared input)."""
    rng = np.random.default_rng(seed)
    return [skewed_distribution(E, 1.5 + 3.0 * rng.random(), rng)
            for _ in range(layers)]


def _plans(layers, dup, seed):
    """(JAX plan stack, port plan stack) from both packages' Algorithm 1
    on the same distributions."""
    dists = _dists(layers, seed)
    j = jax_stack([jax_dup(d, R, dup, 4).plan for d in dists])
    t = stack_plans([duplicate_experts_host(d, R, dup, 4).plan
                     for d in dists])
    return _np_plan(j), t


def _identity(layers, dup):
    return (_np_plan(jax_stack([jax_identity(E, R, dup, 4)
                                for _ in range(layers)])),
            stack_plans([identity_plan(E, R, dup, 4) for _ in range(layers)]))


# --------------------------------------------------------------------------
# cost model: exact against JAX over a grid
# --------------------------------------------------------------------------

@pytest.mark.parametrize("nbytes", [0.0, 1.0, 352321536.0, 2.8e9, 1.2345e11])
@pytest.mark.parametrize("window", [0.0, 0.004, 0.0285, 0.058, 1.0])
def test_cost_functions_equal_jax(nbytes, window):
    assert tcost.migration_stall_s(nbytes, A100_PCIE) == \
        jcost.migration_stall_s(nbytes, JAX_A100_PCIE)
    stall = jcost.migration_stall_s(nbytes, JAX_A100_PCIE)
    assert tcost.split_hidden_exposed(stall, window) == \
        jcost.split_hidden_exposed(stall, window)
    for gain in (0.0, stall / 2, stall, 2 * stall + 1e-3):
        for hidden in (0.0, window, stall):
            assert tcost.should_migrate(stall, gain, hidden) == \
                jcost.should_migrate(stall, gain, hidden)
    for steps in (0, 1, 16):
        for layers in (1, 8, 32):
            kw = dict(num_layers=layers, window_steps=steps)
            assert tcost.amortized_layer_stall_s(nbytes, A100_PCIE, **kw) == \
                jcost.amortized_layer_stall_s(nbytes, JAX_A100_PCIE, **kw)
    for chunk in (1, 8):
        for eb in (1, 393216, 352321536):
            for lo, hi in ((1, 1024), (0, 64)):
                kw = dict(chunk_entries=chunk, entry_bytes=eb,
                          min_chunks=lo, max_chunks=hi)
                assert tcost.overlap_chunk_budget(window, hw=A100_PCIE,
                                                  **kw) == \
                    jcost.overlap_chunk_budget(window, hw=JAX_A100_PCIE, **kw)


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
@pytest.mark.parametrize("dup", [1, 2])
def test_entry_and_plan_bytes_equal_jax(dtype, dup):
    rng = np.random.default_rng(dup)
    weights = {"w_gate": rng.normal(size=(L, E, 4, 6)).astype(dtype),
               "w_up": rng.normal(size=(L, E, 4, 6)).astype(dtype),
               "w_down": rng.normal(size=(L, E, 6, 4)).astype(dtype)}
    eb = jcost.entry_bytes(weights)
    assert tcost.entry_bytes(weights) == eb
    # the port's tensors, stacked and as per-layer lists (the store's form)
    tensors = {k: torch.from_numpy(v) for k, v in weights.items()}
    assert tcost.entry_bytes(tensors) == eb
    assert tcost.entry_bytes({k: list(v) for k, v in tensors.items()}) == eb
    (ja, ta), (jb, tb) = _plans(L, dup, 0), _plans(L, dup, 1)
    assert tcost.plan_migration_bytes(trt.plan_diff(ta, tb, R, dup),
                                      weights) == \
        jcost.plan_migration_bytes(jrt.plan_diff(ja, jb, R, dup), weights)


def test_kind_window_ema_sequences_equal_jax():
    rng = np.random.default_rng(7)
    for beta in (0.5, 0.9):
        t, j = tcost.KindWindowEMA(beta), jcost.KindWindowEMA(beta)
        for kind in ("decode", "prefill"):
            assert t.window(kind) == j.window(kind)
        for _ in range(40):
            kind = ("prefill", "decode")[int(rng.integers(2))]
            dt = float(rng.exponential(0.03))
            assert t.update(kind, dt) == j.update(kind, dt)
            for k in ("prefill", "decode"):
                assert t.window(k) == j.window(k)
        assert t.kinds() == j.kinds()


# --------------------------------------------------------------------------
# plan diffs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dup", [1, 2])
@pytest.mark.parametrize("seeds", [(0, 1), (2, 2), (3, 9), (None, 4)])
def test_plan_diff_functions_equal_jax(dup, seeds):
    a_seed, b_seed = seeds
    ja, ta = _identity(L, dup) if a_seed is None else _plans(L, dup, a_seed)
    jb, tb = _plans(L, dup, b_seed)
    for f in PlacementPlan._fields:                  # the inputs agree
        np.testing.assert_array_equal(getattr(ta, f), getattr(ja, f))
    np.testing.assert_array_equal(trt.stacked_slot_experts(tb, R, dup),
                                  jrt.stacked_slot_experts(jb, R, dup))
    td, jd = trt.plan_diff(ta, tb, R, dup), jrt.plan_diff(ja, jb, R, dup)
    for f in td._fields:
        np.testing.assert_array_equal(getattr(td, f), getattr(jd, f))
        assert getattr(td, f).dtype == getattr(jd, f).dtype, f
    assert td.num_entries == jd.num_entries
    se_a = trt.stacked_slot_experts(ta, R, dup)
    np.testing.assert_array_equal(trt.apply_diff(se_a, td),
                                  jrt.apply_diff(se_a, jd))
    for x, y in ((ta, tb), (tb, ta), (ta, ta)):
        jx = ja if x is ta else jb
        jy = ja if y is ta else jb
        assert trt.plans_equal(x, y) == jrt.plans_equal(jx, jy)
        assert trt.vacated_slots(x, y, R, dup) == \
            jrt.vacated_slots(jx, jy, R, dup)
    assert trt.plans_equal(None, None) and not trt.plans_equal(ta, None)


# --------------------------------------------------------------------------
# executors against the meshless JAX runtime
# --------------------------------------------------------------------------

def _toy_experts(seed=0, d=4, f=6):
    rng = np.random.default_rng(seed)
    return {"w_gate": rng.normal(size=(L, E, d, f)).astype(np.float32),
            "w_up": rng.normal(size=(L, E, d, f)).astype(np.float32),
            "w_down": rng.normal(size=(L, E, f, d)).astype(np.float32)}


class _Pair:
    """The JAX store + executor and the port's, driven in lockstep."""

    def __init__(self, experts, start, dup, staged, chunk):
        j0, t0 = start
        self.dup, self.staged = dup, staged
        jexp = {k: jnp.asarray(v) for k, v in experts.items()}
        texp = {k: torch.from_numpy(v.copy()) for k, v in experts.items()}
        self.jstore = jrt.ReplicaStore.from_params(
            jexp, j0, num_experts=E, ep_ranks=R, dup_slots=dup)
        self.tstore = trt.ReplicaStore.from_params(
            texp, t0, num_experts=E, ep_ranks=R, dup_slots=dup)
        jstep = jrt.make_migrate_step(None, num_experts=E, ep_ranks=R,
                                      dup_slots=dup)
        tstep = trt.make_migrate_step(self.tstore)
        if staged:
            self.jex = jrt.LayerStagedExecutor(
                jstep, jexp, self.jstore.entry_bytes, num_layers=L,
                chunk=chunk)
            self.tex = trt.LayerStagedExecutor(tstep, self.tstore,
                                               num_layers=L, chunk=chunk)
        else:
            self.jex = jrt.MigrationExecutor(jstep, jexp,
                                             self.jstore.entry_bytes,
                                             chunk=chunk)
            self.tex = trt.MigrationExecutor(tstep, self.tstore, chunk=chunk)
        self.check_live()

    def begin(self, jcur, tcur, jnew, tnew):
        self.jex.begin(self.jstore.weights,
                       jrt.plan_diff(jcur, jnew, R, self.dup), jnew)
        self.tex.begin(trt.plan_diff(tcur, tnew, R, self.dup), tnew)

    def tick(self, budget):
        """One tick on both sides; checks bytes, ready mask and, for ready
        layers, the rows a forward would read. Returns True on commit."""
        jc, jb = self.jex.tick(budget)
        tc, tb = self.tex.tick(budget)
        assert tb == jb
        assert (tc is None) == (jc is None)
        if self.staged and tc is None:
            ready = self.tex.ready_mask()
            np.testing.assert_array_equal(ready, self.jex.ready_mask())
            assert self.tex.remaining_entries == self.jex.remaining_entries
            tgt = jrt.stacked_slot_experts(self.jex.target_plan, R, self.dup)
            np.testing.assert_array_equal(trt.stacked_slot_experts(
                self.tex.target_plan, R, self.dup), tgt)
            assert self.tex.back_weights is self.tstore.weights
            rows = self.tex.target_rows
            for l in np.nonzero(ready)[0]:
                self._check_rows(l, tgt[l], rows[l],
                                 self.jex.back_weights)
        if jc is None:
            return False
        assert not self.staged or self.tex.back_weights is None
        jw, _, jse = jc
        filled, _, tse = tc
        np.testing.assert_array_equal(tse, jse)
        self.jstore.adopt(jw, jse)
        self.tstore.adopt(tse, filled)
        self.check_live()
        return True

    def _check_rows(self, l, se, rows, jweights):
        for s in np.nonzero(se >= 0)[0]:
            for k, w in self.tstore.weights.items():
                np.testing.assert_array_equal(
                    w[l][rows[s]].numpy(), np.asarray(jweights[k])[l, s],
                    err_msg=f"{k} layer {l} slot {s}")

    def check_live(self):
        np.testing.assert_array_equal(self.tstore.slot_experts,
                                      self.jstore.slot_experts)
        np.testing.assert_array_equal(self.tstore.version,
                                      self.jstore.version)
        rows = self.tstore.slot_rows()
        for l in range(L):
            self._check_rows(l, self.tstore.slot_experts[l], rows[l],
                             self.jstore.weights)


BUDGETS = [1, 2, 1, 3, 1, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1]


@pytest.mark.parametrize("dup", [1, 2])
@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("chunk", [1, 3])
def test_executors_match_meshless_jax_runtime(dup, staged, chunk):
    """identity -> A -> B -> C: equal bytes per tick, ready masks, commit
    ticks, versions, slot maps and live rows at every step."""
    pair = _Pair(_toy_experts(), _identity(L, dup), dup, staged, chunk)
    chain = [_identity(L, dup)] + [_plans(L, dup, s) for s in (2, 5, 11)]
    entries = 0
    for (jcur, tcur), (jnew, tnew) in zip(chain, chain[1:]):
        pair.begin(jcur, tcur, jnew, tnew)
        entries += pair.tex._diff.num_entries
        ticks = 0
        while not pair.tick(BUDGETS[ticks]):
            ticks += 1
        assert not pair.tex.active and not pair.jex.active
    assert entries > 2 * L
    # a slot refilled twice used both of its rows
    assert pair.tstore.live_bit.any()


@pytest.mark.parametrize("dup", [1, 2])
def test_cancel_then_third_plan_lands_exactly(dup):
    """A fill toward a WRONG plan, cancelled part-way, then a migration to
    a third plan: equal to the JAX runtime, live rows exact
    (``tests/test_overlap_prefetch.py``'s cancel case, on both sides)."""
    pair = _Pair(_toy_experts(1), _plans(L, dup, 3), dup, True, 1)
    jold, told = _plans(L, dup, 3)
    jwrong, twrong = _plans(L, dup, 4)
    jright, tright = _plans(L, dup, 8)
    pair.begin(jold, told, jwrong, twrong)
    assert not pair.tick(2) and pair.tex.active
    pair.jex.cancel()
    pair.tex.cancel()
    assert pair.tex.tick() == (None, 0) and not pair.tex.ready_mask().any()
    pair.check_live()                      # live rows untouched
    pair.begin(jold, told, jright, tright)
    while not pair.tick(1):
        pass
    # the result equals a store built on the third plan directly
    direct = trt.ReplicaStore.from_params(
        {k: torch.from_numpy(v) for k, v in _toy_experts(1).items()},
        tright, num_experts=E, ep_ranks=R, dup_slots=dup)
    se = pair.tstore.slot_experts
    got, want = pair.tstore.slot_rows(), direct.slot_rows()
    for l in range(L):
        for s in np.nonzero(se[l] >= 0)[0]:
            for k in direct.weights:
                assert torch.equal(pair.tstore.weights[k][l][got[l, s]],
                                   direct.weights[k][l][want[l, s]])


def test_store_layout_and_migrate_all():
    """Home rows hold the experts, an identity store copies nothing into the
    replica rows, and ``migrate_all`` fills and commits a whole diff."""
    dup = 2
    experts = {k: torch.from_numpy(v) for k, v in _toy_experts(2).items()}
    (_, t_id), (_, tb) = _identity(L, dup), _plans(L, dup, 6)
    store = trt.ReplicaStore.from_params(experts, t_id, num_experts=E,
                                         ep_ranks=R, dup_slots=dup)
    for k, w in store.weights.items():
        assert len(w) == L and w[0].shape[0] == E + 2 * R * dup
        for l in range(L):
            assert torch.equal(w[l][:E], experts[k][l])
            assert not w[l][E:].any()
    assert store.hbm_bytes_per_rank == \
        L * (E // R + dup) * store.entry_bytes        # the JAX figure
    assert store.device_bytes == L * (E + 2 * R * dup) * store.entry_bytes
    diff = trt.plan_diff(t_id, tb, R, dup)
    trt.migrate_all(trt.make_migrate_step(store), store, diff, chunk=3)
    np.testing.assert_array_equal(store.slot_experts,
                                  trt.stacked_slot_experts(tb, R, dup))
    rows = store.slot_rows()
    for l in range(L):
        for s in np.nonzero(store.slot_experts[l] >= 0)[0]:
            e = store.slot_experts[l, s]
            for k, w in store.weights.items():
                assert torch.equal(w[l][rows[l, s]], experts[k][l, e])


# --------------------------------------------------------------------------
# forward through the store against the gather path
# --------------------------------------------------------------------------

DUP = 2
S, BS, MAXLEN = 32, 8, 64


@pytest.fixture(scope="module")
def jax_params():
    jcfg = jax_get_config("mixtral-8x7b").reduced()
    return jax.tree.map(np.asarray,
                        jax_init_model(jax.random.PRNGKey(0), jcfg))


def _ep_setup(jax_params):
    base = get_config("mixtral-8x7b").reduced()
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, duplication_slots=DUP))
    model = params_from_jax(jax_params, cfg, device="cpu")
    Ex = cfg.moe.num_experts
    # plan B's hot experts are others than plan A's in every layer
    mk = lambda shift: stack_plans([duplicate_experts_host(  # noqa: E731
        np.roll(skewed_distribution(Ex, 2.5 + l), shift + l), R, DUP,
        cfg.moe.max_copies).plan for l in range(cfg.num_layers)])
    plan_a, plan_b = mk(0), mk(1)
    return cfg, model, plan_a, plan_b


def _mixed(plan_a, plan_b, ready):
    return PlacementPlan(*(np.where(
        ready.reshape((-1,) + (1,) * (np.asarray(a).ndim - 1)), b, a)
        for a, b in zip(plan_a, plan_b)))


def _forwards(cfg, model, plan, store):
    """One slot prefill and one paged decode step (two slots, one idle)
    under ``plan`` (and ``store``). Returns [(logits, stats)] * 2."""
    rt = Runtime(window_override=MAXLEN, ep=True, ep_ranks=R)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (1, S)).astype(np.int32)
    tw = (np.arange(S) < 27).astype(np.float32)[None]
    prefill = tsteps.make_slot_prefill_step(cfg, rt)
    decode = tsteps.make_paged_decode_step(cfg, rt)
    out = []
    _, lg, temp, st = prefill(model, torch.tensor(toks), None,
                              torch.tensor([26]), torch.tensor(tw), plan,
                              store)
    out.append((lg, st))
    pool = tkv.init_block_pool(cfg, 1 + 2 * (MAXLEN // BS), BS, device="cpu")
    tables = np.arange(1, 1 + 2 * (MAXLEN // BS), dtype=np.int32).reshape(2, -1)
    tkv.write_prefill_blocks(pool, temp, tables[0, :S // BS])
    forced = rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    _, lg, _, st = decode(model, torch.tensor(forced), pool,
                          torch.tensor(tables),
                          torch.tensor([27, 0], dtype=torch.int32),
                          torch.tensor([[1.0], [0.0]]), plan, store)
    out.append((lg, st))
    return out


def _assert_equal(got, want, msg):
    for (lg, st), (lg_w, st_w) in zip(got, want):
        assert torch.equal(lg, lg_w), msg
        for k in ("expert_counts", "slot_counts", "dropped"):
            assert torch.equal(st[k], st_w[k]), (k, msg)


def test_store_forward_equals_gather_at_every_staged_state(jax_params):
    cfg, model, plan_a, plan_b = _ep_setup(jax_params)
    m = cfg.moe
    store = trt.ReplicaStore.from_model(model, plan_a,
                                        num_experts=m.num_experts,
                                        ep_ranks=R, dup_slots=DUP)
    assert model.layers[0].w_up.data_ptr() == \
        store.weights["w_up"][0].data_ptr()           # no second home copy
    dev = lambda p, rows=None: to_device(  # noqa: E731
        p, m.num_experts, R, DUP, "cpu", rows=rows)
    live = dev(plan_a, store.slot_rows())
    ex = trt.LayerStagedExecutor(trt.make_migrate_step(store), store,
                                 num_layers=cfg.num_layers, chunk=1)
    diff = trt.plan_diff(plan_a, plan_b, R, DUP)
    assert diff.num_entries > cfg.num_layers
    ex.begin(diff, plan_b)
    target = dev(plan_b, ex.target_rows)
    states, replica_pairs = [], 0
    while True:
        ready = ex.ready_mask()
        got = _forwards(cfg, model, live, StoreView(
            store.weights, ready, target, ex.fill_events()))
        want = _forwards(cfg, model, _mixed(plan_a, plan_b, ready), None)
        _assert_equal(got, want, f"ready {ready}")
        states.append(int(ready.sum()))
        e_loc = m.num_experts // R
        replica_pairs += sum(int(st["slot_counts"].reshape(
            cfg.num_layers, R, -1)[:, :, e_loc:].sum()) for _, st in got)
        commit, _ = ex.tick(1)
        if commit is not None:
            break
    assert 0 in states and any(0 < n < cfg.num_layers for n in states)
    assert replica_pairs > 0
    # committed: the live rows under plan B equal the gather forward on B
    filled, plan, se = commit
    store.adopt(se, filled)
    _assert_equal(_forwards(cfg, model, dev(plan_b, store.slot_rows()),
                            StoreView(store.weights)),
                  _forwards(cfg, model, plan_b, None), "committed")


def test_corrupted_filled_row_changes_the_output(jax_params):
    """A ready layer reads its filled rows: overwrite one (a replica slot
    that computes pairs) and the output changes."""
    cfg, model, plan_a, plan_b = _ep_setup(jax_params)
    m = cfg.moe
    store = trt.ReplicaStore.from_model(model, plan_a,
                                        num_experts=m.num_experts,
                                        ep_ranks=R, dup_slots=DUP)
    dev = lambda p, rows=None: to_device(  # noqa: E731
        p, m.num_experts, R, DUP, "cpu", rows=rows)
    ex = trt.LayerStagedExecutor(trt.make_migrate_step(store), store,
                                 num_layers=cfg.num_layers, chunk=1)
    diff = trt.plan_diff(plan_a, plan_b, R, DUP)
    ex.begin(diff, plan_b)
    while not ex.ready_mask()[0]:                # layer 0 filled
        ex.tick(1)
    ready = ex.ready_mask()
    assert ex.active and not ready.all()
    view = StoreView(store.weights, ready, dev(plan_b, ex.target_rows),
                     ex.fill_events())
    live = dev(plan_a, store.slot_rows())
    before = _forwards(cfg, model, live, view)
    counts = before[0][1]["slot_counts"]
    filled = [(l, s) for l, s in zip(diff.layer, diff.dst_slot)
              if ready[l] and counts[l, s] > 0]
    assert filled, "no filled replica slot computed a pair"
    l, s = filled[0]
    row = int(ex.target_rows[l, s])
    assert row >= m.num_experts                  # a replica row, not a home
    store.weights["w_down"][l][row].mul_(2.0)
    after = _forwards(cfg, model, live, view)
    assert not torch.equal(after[0][0], before[0][0])
