"""Engine legs for ``tests/test_torch_dist_serve.py``: what each engine
serves and records, shared by the JAX subprocess (which ``exec``s
``CAPTURE``) and the port's processes (``run_rank``, the entry point of
the ranks ``launch.mesh.spawn`` starts; this module imports torch and
``repro_torch`` only).

``ContinuousEngine`` legs serve five staggered requests one iteration per
virtual second (``serve_capture``) and record per iteration the generated
lengths, the pairs dropped at capacity, the plan in force, the migration
counters and the store's slot map and versions; and every re-plan's plan
and the logits that produced each token. ``ServeEngine`` legs serve
``BATCHES`` batches through ``generate`` (``serve_batches``, the overlap
window pinned as in ``tests/test_torch_serve_ep.py``) and record per batch
the tokens, the plan in force, the re-plans, the store, ``history[-1]``,
the last migration and every prefill's and decode step's logits.
"""

import numpy as np

from repro_torch.bridge import params_from_jax
from repro_torch.configs.registry import get_config
from repro_torch.data.synthetic import token_batches
from repro_torch.serve import (ContinuousConfig, ContinuousEngine,
                               ServeConfig, ServeEngine, ServeRequest)
from repro_torch.sharding import EXPERT_SPEC, shard_tensor

PLAN_FIELDS = ("n_replicas", "replica_table", "pool_expert", "pool_sel")
ENGINE_KW = dict(max_slots=4, prefill_len=64, block_size=8, max_len=128,
                 strategy="dist_only", predict_interval=4, dup_slots=1,
                 prefetch_lead=2, migration_gate=False)
SERVE_KW = dict(strategy="dist_only", predict_interval=1, dup_slots=1,
                max_len=32, migrate_chunk=2)
BATCHES, B, S, NEW = 3, 2, 16, 6
STEP_S = 3e-5                 # the pinned overlap window (2 chunks a tick)
# leg -> (engine, mesh (data, model), ContinuousConfig / ServeConfig changes)
LEGS = {
    "cont_1x4": ("continuous", (1, 4), {}),
    "cont_2x2": ("continuous", (2, 2), {}),
    "cont_2x2_resched": ("continuous", (2, 2),
                         dict(lever="reschedule", resched_impl="greedy")),
    "serve_2x2": ("serve", (2, 2), {}),
}


def requests(vocab):
    """Five staggered Zipf prompts, request i shifted by 256 (i // 2):
    under ``widen_margins`` their hot experts, so the plan, move."""
    gen = token_batches(1, vocab, 1, 30)
    return [dict(rid=i, tokens=((next(gen)["tokens"][0, :n] + 256 * (i // 2))
                                % vocab).astype(np.int32),
                 max_new_tokens=12, arrival=float(i))
            for i, n in enumerate((5, 17, 11, 30, 9))]


def batches(vocab):
    """BATCHES (B, S) Zipf prompts, batch b shifted by 256 b: under
    ``widen_margins`` its hot experts, so the plan, move each batch."""
    gen = token_batches(0, vocab, B, S)
    return [((next(gen)["tokens"] + 256 * b) % vocab).astype(np.int32)
            for b in range(BATCHES)]


CAPTURE = '''
def plan_np(plan, fields):
    return None if plan is None else {
        f: np.asarray(getattr(plan, f)).copy() for f in fields}


def serve_capture(eng, reqs, to_np, fields):
    eng.warmup()
    rec = {"plans": [], "prefill": {}, "decode": [], "lens": [],
           "dropped": [], "slot": {}, "in_force": [], "mig": [],
           "store_se": [], "store_version": []}
    replan = eng.replan
    def recording_replan():
        out = replan()
        rec["plans"].append((eng.iterations, plan_np(eng._plan_stack,
                                                     fields)))
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
        rec["in_force"].append(plan_np(eng._plan_stack, fields))
        rec["mig"].append(dict(eng.metrics.migration))
        rec["store_se"].append(np.asarray(eng._store.slot_experts).copy())
        rec["store_version"].append(np.asarray(eng._store.version).copy())
        it += 1
    rec["slots"] = [rec["slot"][r.rid] for r in reqs]
    rec["tokens"] = [list(r.generated) for r in reqs]
    rec["entry_bytes"] = int(eng._store.entry_bytes)
    rec["overflow"] = float(eng.metrics.summary()["overflow_tokens"])
    return rec


def serve_batches(eng, batches, new_tokens, step_s, to_np, fields):
    eng._note_step_time = lambda dt: None
    rec = {"tokens": [], "in_force": [], "replans": [], "store_se": [],
           "store_version": [], "history": [], "migration": [],
           "prefill": [], "decode": [], "slot_counts": []}
    prefill, decode, replan = eng.prefill, eng.decode, eng.replan

    def pinned_prefill(*a, **k):
        eng._recent_step_s = step_s
        out = prefill(*a, **k)
        rec["prefill"].append(to_np(out[0]))
        rec["slot_counts"].append(np.asarray(out[2]["slot_counts"]).copy())
        return out

    def pinned_decode(*a, **k):
        eng._recent_step_s = step_s
        out = decode(*a, **k)
        rec["decode"].append(to_np(out[1]))
        return out

    def recording_replan():
        out = replan()
        rec["replans"].append((eng.batches_seen, plan_np(out, fields)))
        return out
    eng.prefill, eng.decode = pinned_prefill, pinned_decode
    eng.replan = recording_replan
    for b in batches:
        out, _ = eng.generate({"tokens": b}, max_new_tokens=new_tokens)
        rec["tokens"].append(np.asarray(out).tolist())
        rec["in_force"].append(plan_np(eng._current_plan(), fields))
        st = eng._store
        rec["store_se"].append(np.asarray(st.slot_experts).tolist())
        rec["store_version"].append(np.asarray(st.version).tolist())
        rec["history"].append(dict(eng.history[-1]))
        rec["migration"].append(dict(eng._last_migration))
    return rec
'''

_SCOPE = {"np": np}
exec(CAPTURE, _SCOPE)


def _to_np(t):
    return t.float().numpy()


def shard_experts(model, coords, mesh) -> None:
    """Keep, in place, each MoE layer's block of its expert weights under
    the expert rule (``sharding.EXPERT_SPEC``: rank m of the "model" axis
    keeps experts ``[m * E / R, (m + 1) * E / R)``); every other parameter
    stays whole."""
    import torch

    for layer in model.layers:
        for name in ("w_gate", "w_up", "w_down"):
            w = getattr(layer, name, None)
            if w is None or w.dim() != 3:
                continue
            block = shard_tensor(w.data, EXPERT_SPEC, coords, mesh)
            setattr(layer, name, torch.nn.Parameter(
                block.clone(), requires_grad=w.requires_grad))


def port_model(tree, mesh=None):
    """Reduced Mixtral from the JAX tree (numpy) on the CPU; with a mesh,
    this rank's block of the experts only (``params_from_jax`` then
    ``shard_tensor``)."""
    cfg = get_config("mixtral-8x7b").reduced()
    model = params_from_jax(tree, cfg, device="cpu")
    if mesh is not None:
        shard_experts(model, {"data": mesh.data_index,
                              "model": mesh.model_index}, mesh)
    return cfg, model


def run_leg(name, tree, mesh=None):
    """Leg ``name`` on the port: over ``mesh`` (this process's rank), or
    with the EP ranks stacked in this process when None."""
    kind, (_, model_axis), changes = LEGS[name]
    cfg, model = port_model(tree, mesh)
    if kind == "continuous":
        eng = ContinuousEngine(cfg, model, ContinuousConfig(
            **dict(ENGINE_KW, **changes)), ep_ranks=model_axis, ep=True,
            mesh=mesh)
        reqs = [ServeRequest(**r) for r in requests(cfg.vocab_size)]
        return _SCOPE["serve_capture"](eng, reqs, _to_np, PLAN_FIELDS)
    eng = ServeEngine(cfg, model, ServeConfig(**dict(SERVE_KW, **changes)),
                      ep_ranks=model_axis, ep=True, mesh=mesh)
    return _SCOPE["serve_batches"](eng, batches(cfg.vocab_size), NEW,
                                   STEP_S, _to_np, PLAN_FIELDS)


def run_rank(mesh, tree, names):
    """The entry point of each spawned rank: the legs of ``names`` on this
    mesh."""
    return {n: run_leg(n, tree, mesh) for n in names}
