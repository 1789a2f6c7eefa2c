"""The PyTorch port's expert-parallel (EP) path against the JAX package's
meshed EP path, at the model and at the engine level.

The JAX side needs four devices. It runs in one subprocess with
``--xla_force_host_platform_device_count=4``, set before jax is imported,
on a ``(1, 4)`` ("data", "model") mesh built with ``AxisType.Auto`` axes
(jax's default ``Explicit`` axes refuse the sharding constraints of the
JAX model). It writes its results to an ``.npz``; the port runs here on
the CPU, with its four EP ranks as a leading tensor dimension.

Model level: reduced Mixtral (bridged weights), a duplicated placement
plan with capacity factor 1.25, two slot prefills and three paged decode
steps. The prefill bucket is 64, not 32: with 4 ranks a rank then holds 16
tokens, so a slot can take more pairs than its capacity of 8 (the padding
routes alike) and pairs are dropped; the JAX side runs ``Runtime(mesh, ep=True, ep_ranks=4,
use_kernel=True)``, whose Pallas kernels round as the port's plain
versions do. Logits agree within ``LOGIT_ATOL`` (bf16, as in
``tests/test_torch_model.py``); ``slot_counts``, ``dropped`` and the
expert counts are equal.

Engine level: the meshed JAX ``ContinuousEngine`` (``replica_impl=
"gather"``, ``dist_only``, one replica slot per rank, a re-plan every 2
iterations) against ``repro_torch``'s ``ContinuousEngine(ep=True)`` with
the same ``replica_impl="gather"`` (the store path is held against the
JAX store engine in ``tests/test_torch_store_serve.py``). The
JAX engine's runtime does not set ``use_kernel``, so its router and expert
FFN round bf16 at other places than the port's. Generated tokens must be
equal, except where the JAX logits that produced a token have a top-2
margin under two bf16 ulps (``_near_tie``); comparisons stop at the first
such iteration. Before it, plan stacks are equal at every re-plan and the
pairs dropped at capacity are equal at every iteration.
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

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models.transformer import init_model as jax_init_model  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.placement import PlacementPlan  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.transformer import Runtime  # noqa: E402
from repro_torch.serve import (ContinuousConfig, ContinuousEngine,  # noqa: E402
                               ServeRequest)
from repro_torch.serve import kvcache as tkv  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
R = 4
LOGIT_ATOL = 5e-2
S, BS, MAXLEN = 64, 8, 128
PLAN_FIELDS = ("n_replicas", "replica_table", "pool_expert", "pool_sel")
ENGINE_KW = dict(max_slots=4, prefill_len=S, block_size=BS, max_len=MAXLEN,
                 strategy="dist_only", predict_interval=2, dup_slots=1)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced model's operations are tiny: one intra-op thread runs
    them as fast as many, and keeps this file from oversubscribing the
    cores when test workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model_inputs(vocab):
    # seed 0's second prompt puts one token's top-2 probabilities within the
    # bf16 noise of the two frameworks' hidden states, which moves one pair
    # between the replicas of an expert; seed 1's inputs hold no such tie
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in (20, 13)]
    forced = rng.integers(0, vocab, (3, 3)).astype(np.int32)
    forced[-1] = 0                                        # the idle slot
    return prompts, forced


def _engine_requests(vocab):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, vocab, n).astype(np.int32) for n in (5, 17, 11)]
    return [dict(rid=i, tokens=p, max_new_tokens=6, arrival=a)
            for i, (p, a) in enumerate(zip(prompts, (0.0, 1.0, 3.0)))]


# Serves requests one iteration per virtual second and records, per
# iteration, the generated lengths, the dropped pairs and the logits that
# produced each new token; and every re-plan's plan stack. Executed by
# the JAX subprocess and here for the port's engines (``to_np`` converts
# the framework's logits).
CAPTURE = '''
def serve_capture(eng, reqs, to_np, plan_fields):
    eng.warmup()
    rec = {"plans": [], "prefill": {}, "decode": [], "lens": [],
           "dropped": [], "slot": {}}
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
        it += 1
    rec["slots"] = [rec["slot"][r.rid] for r in reqs]
    rec["tokens"] = [list(r.generated) for r in reqs]
    return rec
'''

SUB = '''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs.registry import get_config
from repro.core.duplication import duplicate_experts_host
from repro.core.placement import stack_plans
from repro.models.transformer import Runtime, init_cache, init_model
from repro.serve import ContinuousConfig, ContinuousEngine, ServeRequest
from repro.serve import kvcache as jkv
from repro.train import steps as jsteps

out_path, R = sys.argv[1], 4
S, BS, MAXLEN = eval(os.environ["EP_SIZES"])
mesh = jax.make_mesh((1, R), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
base = get_config("mixtral-8x7b").reduced()
params = init_model(jax.random.PRNGKey(0), base)
res = {}

# ---- model level: duplicated plan, capacity factor 1.25
cfg = dataclasses.replace(base, moe=dataclasses.replace(
    base.moe, duplication_slots=1))
E = cfg.moe.num_experts
dist = np.array([[0.55, 0.15, 0.2, 0.1], [0.1, 0.2, 0.1, 0.6]])
plan = stack_plans([duplicate_experts_host(dist[l], R, 1, cfg.moe.max_copies)
                    .plan for l in range(cfg.num_layers)])
for f in plan._fields:
    res["plan_" + f] = np.asarray(getattr(plan, f))
jplan = jax.tree.map(jnp.asarray, plan)
rt = Runtime(mesh=mesh, ep=True, ep_ranks=R, use_duplication=True,
             use_kernel=True, window_override=MAXLEN)
prefill = jax.jit(jsteps.make_slot_prefill_step(cfg, rt))
decode = jax.jit(jsteps.make_paged_decode_step(cfg, rt))
prompts = [np.asarray(p) for p in eval(os.environ["EP_PROMPTS"])]
forced = np.asarray(eval(os.environ["EP_FORCED"]), np.int32)
B, M = len(prompts) + 1, MAXLEN // BS
pool = jkv.init_block_pool(cfg, 1 + B * M, BS)
tables = np.zeros((B, M), np.int32)
step = 0
with mesh:
    for b, p in enumerate(prompts):
        tables[b] = 1 + b * M + np.arange(M)
        toks = np.zeros((1, S), np.int32)
        toks[0, :len(p)] = p
        tw = (np.arange(S) < len(p)).astype(np.float32)[None]
        _, lg, temp, st = prefill(params, {"tokens": jnp.asarray(toks)},
                                  init_cache(cfg, rt, 1, S), plan=jplan,
                                  last_pos=jnp.asarray([len(p) - 1]),
                                  token_weight=jnp.asarray(tw))
        pool = jkv.write_prefill_blocks(pool, temp,
                                        jnp.asarray(tables[b, :S // BS]))
        for k in ("expert_counts", "slot_counts", "dropped"):
            res[f"m{step}_{k}"] = np.asarray(st[k])
        res[f"m{step}_logits"] = np.asarray(lg, np.float32)
        step += 1
    lengths = np.asarray([len(p) for p in prompts] + [0], np.int32)
    active = (lengths > 0).astype(np.float32)[:, None]
    for t in range(forced.shape[1]):
        _, lg, pool, st = decode(params, jnp.asarray(forced[:, t:t + 1]),
                                 pool, jnp.asarray(tables),
                                 jnp.asarray(lengths), plan=jplan,
                                 token_weight=jnp.asarray(active))
        for k in ("expert_counts", "slot_counts", "dropped"):
            res[f"m{step}_{k}"] = np.asarray(st[k])
        res[f"m{step}_logits"] = np.asarray(lg, np.float32)
        lengths = lengths + (lengths > 0)
        step += 1

# ---- engine level
exec(os.environ["EP_CAPTURE"])
ecfg = dataclasses.replace(base, moe=dataclasses.replace(
    base.moe, replica_impl="gather"))
kw = eval(os.environ["EP_ENGINE_KW"])
eng = ContinuousEngine(ecfg, params, ContinuousConfig(**kw), mesh=mesh,
                       ep_ranks=R)
reqs = [ServeRequest(**dict(r, tokens=np.asarray(r["tokens"], np.int32)))
        for r in eval(os.environ["EP_REQUESTS"])]
with mesh:
    rec = serve_capture(eng, reqs, lambda a: np.asarray(a, np.float32),
                        ("n_replicas", "replica_table", "pool_expert",
                         "pool_sel"))
res["e_tokens"] = np.array([np.asarray(t) for t in rec["tokens"]], object)
res["e_lens"] = np.asarray(rec["lens"])
res["e_dropped"] = np.asarray(rec["dropped"])
res["e_slots"] = np.asarray(rec["slots"])
res["e_plan_iters"] = np.asarray([i for i, _ in rec["plans"]])
for k, (_, p) in enumerate(rec["plans"]):
    for f, a in p.items():
        res[f"e_plan{k}_{f}"] = a
for rid, lg in rec["prefill"].items():
    res[f"e_prefill{rid}"] = lg
for it, lg in enumerate(rec["decode"]):
    if lg is not None:
        res[f"e_decode{it}"] = lg
np.savez(out_path, **res)
'''


def _listed(arrays):
    return repr([a.tolist() for a in arrays])


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    vocab = get_config("mixtral-8x7b").reduced().vocab_size
    prompts, forced = _model_inputs(vocab)
    reqs = _engine_requests(vocab)
    out = tmp_path_factory.mktemp("ep") / "jax_ep.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               EP_PROMPTS=_listed(prompts), EP_FORCED=repr(forced.tolist()),
               EP_SIZES=repr((S, BS, MAXLEN)),
               EP_CAPTURE=CAPTURE, EP_ENGINE_KW=repr(ENGINE_KW),
               EP_REQUESTS=repr([dict(r, tokens=r["tokens"].tolist())
                                 for r in reqs]))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB),
                           str(out)], capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out, allow_pickle=True))


@pytest.fixture(scope="module")
def port_model():
    jcfg = jax_get_config("mixtral-8x7b").reduced()
    cfg = get_config("mixtral-8x7b").reduced()
    params = jax_init_model(jax.random.PRNGKey(0), jcfg)
    return cfg, params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                device="cpu")


def _near_tie(logits) -> bool:
    """Top-2 margin under two bf16 ulps of the top logit."""
    a, b = np.sort(logits)[-2:][::-1]
    ulp = 2.0 ** (np.floor(np.log2(max(abs(a), 1e-30))) - 7)
    return a - b < 2 * ulp


# --------------------------------------------------------------------------
# model level
# --------------------------------------------------------------------------

def _run_port_model(cfg, model, ref):
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, duplication_slots=1))
    plan = PlacementPlan(*(ref["plan_" + f] for f in PLAN_FIELDS))
    rt = Runtime(window_override=MAXLEN, ep=True, ep_ranks=R)
    prefill = tsteps.make_slot_prefill_step(cfg, rt)
    decode = tsteps.make_paged_decode_step(cfg, rt)
    prompts, forced = _model_inputs(cfg.vocab_size)
    B, M = len(prompts) + 1, MAXLEN // BS
    pool = tkv.init_block_pool(cfg, 1 + B * M, BS, device="cpu")
    tables = np.zeros((B, M), np.int32)
    out = []
    for b, p in enumerate(prompts):
        tables[b] = 1 + b * M + np.arange(M)
        toks = np.zeros((1, S), np.int32)
        toks[0, :len(p)] = p
        tw = (np.arange(S) < len(p)).astype(np.float32)[None]
        _, lg, temp, st = prefill(model, torch.tensor(toks), None,
                                  torch.tensor([len(p) - 1]), torch.tensor(tw),
                                  plan)
        tkv.write_prefill_blocks(pool, temp, tables[b, :S // BS])
        out.append((lg, st))
    lengths = np.asarray([len(p) for p in prompts] + [0], np.int32)
    active = (lengths > 0).astype(np.float32)[:, None]
    for t in range(forced.shape[1]):
        _, lg, pool, st = decode(model, torch.tensor(forced[:, t:t + 1]),
                                 pool, torch.tensor(tables),
                                 torch.tensor(lengths), torch.tensor(active),
                                 plan)
        out.append((lg, st))
        lengths = lengths + (lengths > 0)
    return out


def test_ep_model_matches_meshed_jax(jax_ref, port_model):
    cfg, model = port_model
    ops.reset_launches()
    out = _run_port_model(cfg, model, jax_ref)
    assert sum(ops.LAUNCHES.values()) == 0          # the CPU runs plain versions
    # the plan replicates and something is dropped: the comparison bites
    assert int((jax_ref["plan_n_replicas"] - 1).sum()) > 0
    assert sum(int(jax_ref[f"m{k}_dropped"].sum()) for k in range(5)) > 0
    n_slots = R * (cfg.moe.num_experts // R + 1)
    for k, (lg, st) in enumerate(out):
        live = slice(None) if k < 2 else slice(0, 2)     # idle slot masked
        np.testing.assert_allclose(lg.float().numpy()[live],
                                   jax_ref[f"m{k}_logits"][live],
                                   atol=LOGIT_ATOL, rtol=0, err_msg=f"step {k}")
        assert st["slot_counts"].shape == (cfg.num_layers, n_slots)
        for name in ("expert_counts", "slot_counts", "dropped"):
            np.testing.assert_array_equal(st[name].numpy(),
                                          jax_ref[f"m{k}_{name}"],
                                          err_msg=f"{name}, step {k}")


# --------------------------------------------------------------------------
# engine level
# --------------------------------------------------------------------------

def _serve_port(cfg, model, ep: bool, **changes):
    # like with like: the JAX engine here runs replica_impl="gather"
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, replica_impl="gather"))
    scope = {"np": np}
    exec(CAPTURE, scope)
    eng = ContinuousEngine(cfg, model, ContinuousConfig(**dict(ENGINE_KW,
                                                               **changes)),
                           ep_ranks=R, ep=ep)
    reqs = [ServeRequest(**r) for r in _engine_requests(cfg.vocab_size)]
    rec = scope["serve_capture"](eng, reqs, lambda t: t.float().numpy(),
                                 PLAN_FIELDS)
    return rec, eng


def _first_divergence(tokens_a, tokens_b):
    """(rid, index) of the first differing token, in request order, or
    None when all are equal."""
    for rid, (a, b) in enumerate(zip(tokens_a, tokens_b)):
        if list(a) != list(b):
            i = next((n for n, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            return rid, i
    return None


def _producing_logits(lens, slots, prefill, decode, rid, i):
    """The logits row that produced token ``i`` of ``rid`` and the
    iteration that produced it."""
    it = next(k for k, row in enumerate(lens) if row[rid] > i)
    return (prefill[rid] if i == 0 else decode[it][slots[rid]]), it


@pytest.fixture(scope="module")
def served(jax_ref, port_model):
    cfg, model = port_model
    ops.reset_launches()
    rec, eng = _serve_port(cfg, model, ep=True)
    return rec, eng, sum(ops.LAUNCHES.values())


def test_ep_engine_matches_meshed_jax_engine(jax_ref, served):
    rec, eng, launches = served
    ref_tokens = list(jax_ref["e_tokens"])
    div = _first_divergence(ref_tokens, rec["tokens"])
    stop = len(rec["lens"])
    if div is not None:
        rid, i = div
        prefill = {r: jax_ref[f"e_prefill{r}"] for r in range(len(ref_tokens))}
        decode = {k: jax_ref.get(f"e_decode{k}") for k in range(len(
            jax_ref["e_lens"]))}
        lg, stop = _producing_logits(jax_ref["e_lens"], jax_ref["e_slots"],
                                     prefill, decode, rid, i)
        assert _near_tie(lg), f"rid {rid} token {i} differs and is no near tie"
    else:
        np.testing.assert_array_equal(np.asarray(rec["lens"]),
                                      jax_ref["e_lens"])
    # plans: equal at every re-plan up to the first divergence
    iters = [i for i, _ in rec["plans"] if i <= stop]
    ref_iters = [i for i in jax_ref["e_plan_iters"].tolist() if i <= stop]
    assert iters == ref_iters and len(iters) >= 2
    for k, (it, plan) in enumerate(rec["plans"][:len(iters)]):
        for f in PLAN_FIELDS:
            np.testing.assert_array_equal(plan[f], jax_ref[f"e_plan{k}_{f}"],
                                          err_msg=f"{f} @ {it}")
    assert sum(int((p["n_replicas"] - 1).sum()) for _, p in rec["plans"]) > 0
    # dropped pairs: equal per iteration up to the divergence
    np.testing.assert_array_equal(np.asarray(rec["dropped"][:stop]),
                                  jax_ref["e_dropped"][:stop])
    assert eng.device.type == "cpu" and launches == 0


def test_ep_engine_drops_at_capacity_and_records_them(served):
    rec, eng, _ = served
    s = eng.metrics.summary()
    assert s["completed"] == 3 and s["replans"] >= 2
    assert s["dropped_tokens"] == float(sum(rec["dropped"])) > 0
    # the plan reached the device tensors the dispatch reads
    assert eng._plan_dev is not None
    np.testing.assert_array_equal(eng._plan_dev.n_replicas.numpy(),
                                  eng._plan_stack.n_replicas)


def test_ep_engine_at_high_capacity_matches_dense_engine(port_model):
    """With capacity factor 8 nothing drops, so the EP engine serves the
    dense engine's tokens (up to a near tie of the dense logits)."""
    cfg, model = port_model
    cfg8 = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    ep_rec, ep_eng = _serve_port(cfg8, model, ep=True)
    dense_rec, _ = _serve_port(cfg8, model, ep=False)
    assert ep_eng.metrics.summary()["dropped_tokens"] == 0
    div = _first_divergence(dense_rec["tokens"], ep_rec["tokens"])
    if div is not None:
        lg, _ = _producing_logits(dense_rec["lens"], dense_rec["slots"],
                                  dense_rec["prefill"],
                                  dict(enumerate(dense_rec["decode"])), *div)
        assert _near_tie(lg), f"{div}: no near tie"
    assert ep_rec["plans"] and dense_rec["plans"]
