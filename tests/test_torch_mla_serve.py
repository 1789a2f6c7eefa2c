"""``deepseek-v2-lite-16b`` served by the PyTorch port's ``ServeEngine``
against the JAX package's, on the CPU.

Two configs (``tests/test_torch_mla_models.py``'s): ``reduced()`` (E 4,
top-2, one shared expert) and the router variant (E 16, top-6, 2 shared
experts: 4 experts a rank over 4 EP ranks), on the JAX init's weights with
wide router and ``lm_head`` margins over every one of the K picks
(``widen_topk``: no route and no greedy token near a tie), bridged into
the port. Each serves 2 batches of 2 x 48 Zipf prompts
(``data.synthetic.token_batches``; batch b shifted by 256 b, so its hot
experts and the plan move), 6 new tokens each, a re-plan per batch
(dist_only, one replica slot a rank), twice: on the dense MoE path (the
meshless JAX engine) and on the EP dispatch (4 ranks, the replica store
with staged fills: the engines' defaults; the JAX engine on a ``(1, 4)``
``AxisType.Auto`` mesh). A rank holds 12 tokens of a prompt, and the hot
slots overflow their capacity, so the EP runs drop pairs. The JAX engines
run jitted in one subprocess with four host devices and without XLA's
excess precision (``--xla_allow_excess_precision=false``), so they round
bf16 where the port does; both engines get the same pinned overlap window
before every step.

Every run goes to its end with no near-tie cut-off: the generated tokens,
every forward's expert counts and dropped pairs, each batch's telemetry
and the plan in force after each batch are equal.

The EP engine's other paths (synchronous and store-less fills, in-graph
re-planning, both levers, Token-to-Expert) run the router variant to the
end of every batch. Both packages' ``ContinuousEngine`` refuse MLA alike:
its paged KV pool is GQA's.
"""

import inspect
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

from repro.serve import ContinuousConfig as JaxContinuousConfig  # noqa: E402
from repro.serve import ContinuousEngine as JaxContinuousEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.data.synthetic import token_batches  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.transformer import init_model  # noqa: E402
from repro_torch.serve import (ContinuousConfig, ContinuousEngine,  # noqa: E402
                               ServeConfig, ServeEngine)

from tests._torch_margins import SOURCE as MARGINS_SOURCE  # noqa: E402
from tests.test_torch_mla_models import (ARCH, WIDEN_TOPK_SOURCE,  # noqa: E402
                                         _jax_tree, cfgs, variant,
                                         widen_topk)

ROOT = Path(__file__).resolve().parents[1]
R = 4
NAMES = ("reduced", "router")
LEGS = ("dense", "ep")
BATCHES, B, S, NEW = 2, 2, 48, 6
STEP_S = 3e-5                  # the pinned overlap window
SERVE_KW = dict(strategy="dist_only", predict_interval=1, dup_slots=1,
                max_len=S + NEW)
PLAN_FIELDS = ("n_replicas", "replica_table", "pool_expert", "pool_sel")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced models' operations are tiny: one intra-op thread runs
    them as fast as many, and keeps this file from oversubscribing the
    cores when test workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batches(vocab):
    """BATCHES (B, S) Zipf prompts, batch b shifted by 256 b."""
    gen = token_batches(0, vocab, B, S)
    return [((next(gen)["tokens"] + 256 * b) % vocab).astype(np.int32)
            for b in range(BATCHES)]


# Executed by the JAX subprocess and here: serve the batches through
# ``generate`` and record every forward and each batch's outcome.
CAPTURE = '''
def plan_np(plan, fields):
    return None if plan is None else {
        f: np.asarray(getattr(plan, f)).copy() for f in fields}


def serve_batches(eng, batches, new_tokens, step_s, fields):
    eng._note_step_time = lambda dt: None
    rec = {"tokens": [], "counts": [], "dropped": [], "history": [],
           "in_force": []}
    prefill, decode = eng.prefill, eng.decode

    def keep(stats):
        rec["counts"].append(np.asarray(stats["expert_counts"],
                                        np.float64).tolist())
        rec["dropped"].append(
            np.asarray(stats["dropped"]).astype(np.int64).tolist()
            if "dropped" in stats else None)

    def pinned_prefill(*a, **k):
        eng._recent_step_s = step_s
        out = prefill(*a, **k)
        keep(out[2])
        return out

    def pinned_decode(*a, **k):
        eng._recent_step_s = step_s
        out = decode(*a, **k)
        keep(out[3])
        return out
    eng.prefill, eng.decode = pinned_prefill, pinned_decode
    for b in batches:
        out, _ = eng.generate({"tokens": b}, max_new_tokens=new_tokens)
        rec["tokens"].append(np.asarray(out).tolist())
        rec["history"].append(dict(eng.history[-1]))
        rec["in_force"].append(plan_np(eng._current_plan(), fields))
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
from repro.models.transformer import init_model
from repro.serve import ServeConfig, ServeEngine

exec(os.environ["MLA_MARGINS"])
exec(os.environ["MLA_WIDEN"])
exec(os.environ["MLA_VARIANT"])
exec(os.environ["MLA_CAPTURE"])
fields = eval(os.environ["MLA_FIELDS"])
new, step_s = eval(os.environ["MLA_NEW"]), eval(os.environ["MLA_STEP_S"])
mesh = jax.make_mesh((1, 4), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
res = {}
for name in eval(os.environ["MLA_NAMES"]):
    cfg = variant(get_config(os.environ["MLA_ARCH"]).reduced(), name)
    tree = jax.tree.map(jnp.asarray, widen_topk(jax.tree.map(
        np.asarray, init_model(jax.random.PRNGKey(0), cfg)), cfg))
    tree["layers"]["moe"]["experts"] = jax.tree.map(
        lambda w: w.astype(jnp.bfloat16), tree["layers"]["moe"]["experts"])
    batches = [np.asarray(b, np.int32)
               for b in eval(os.environ["MLA_BATCHES"])[name]]
    for leg in ("dense", "ep"):
        kw = dict(mesh=mesh) if leg == "ep" else {}
        eng = ServeEngine(cfg, tree, ServeConfig(
            **eval(os.environ["MLA_SERVE_KW"])), ep_ranks=4, **kw)
        res[(name, leg)] = serve_batches(eng, batches, new, step_s, fields)
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("mla_serve") / "jax_serve.pkl"
    batches = {n: [b.tolist() for b in _batches(cfgs(n)[1].vocab_size)]
               for n in NAMES}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               MLA_MARGINS=MARGINS_SOURCE, MLA_WIDEN=WIDEN_TOPK_SOURCE,
               MLA_VARIANT=inspect.getsource(variant), MLA_CAPTURE=CAPTURE,
               MLA_FIELDS=repr(PLAN_FIELDS), MLA_NEW=repr(NEW),
               MLA_STEP_S=repr(STEP_S), MLA_NAMES=repr(NAMES),
               MLA_ARCH=ARCH, MLA_BATCHES=repr(batches),
               MLA_SERVE_KW=repr(SERVE_KW))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB),
                           str(out)], capture_output=True, text=True,
                          timeout=900, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _port_run(name, leg):
    jcfg, cfg = cfgs(name)
    tree = widen_topk(_jax_tree(jcfg), jcfg)
    eng = ServeEngine(cfg, params_from_jax(tree, cfg, device="cpu"),
                      ServeConfig(**SERVE_KW), ep_ranks=R, ep=leg == "ep")
    scope = {"np": np}
    exec(CAPTURE, scope)
    ops.reset_launches()
    rec = scope["serve_batches"](eng, _batches(cfg.vocab_size), NEW, STEP_S,
                                 PLAN_FIELDS)
    assert sum(ops.LAUNCHES.values()) == 0       # the CPU runs plain versions
    return eng, rec


@pytest.mark.parametrize("leg", LEGS)
@pytest.mark.parametrize("name", NAMES)
def test_serve_engine_matches_the_jax_engine_to_the_end(jax_ref, name, leg):
    ref = jax_ref[(name, leg)]
    eng, rec = _port_run(name, leg)
    assert rec["tokens"] == ref["tokens"]
    assert len(rec["counts"]) == len(ref["counts"]) == BATCHES * NEW
    for i, (a, b) in enumerate(zip(rec["counts"], ref["counts"])):
        np.testing.assert_array_equal(a, b, err_msg=f"counts @ forward {i}")
    # the port's dense path reports no drops; the JAX forward zeros
    L = eng.cfg.num_layers
    assert [d if d is not None else [0] * L for d in rec["dropped"]] == \
        ref["dropped"]
    # (and no dropped / overflow telemetry, where the JAX one has zeros)
    assert [dict({"dropped": 0.0, "overflow": 0.0}, **h)
            if leg == "dense" else h for h in rec["history"]] == \
        ref["history"]
    for k, (p, q) in enumerate(zip(rec["in_force"], ref["in_force"])):
        assert (p is None) == (q is None)
        for f in PLAN_FIELDS if p is not None else ():
            np.testing.assert_array_equal(p[f], q[f],
                                          err_msg=f"{f} after batch {k}")
    cfg = eng.cfg
    toks = np.asarray(rec["tokens"])
    assert toks.shape == (BATCHES, B, NEW)
    assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
    # every prefill routed every token K times in every layer
    assert np.asarray(rec["counts"][0]).sum() == \
        cfg.num_layers * B * S * cfg.moe.top_k
    if leg == "ep":
        assert eng._store is not None
        assert sum(np.sum(d) for d in rec["dropped"]) > 0   # capacity binds
        assert any(h.get("migration_entries", 0) > 0 for h in rec["history"])
    else:
        assert all(d is None for d in rec["dropped"])
        assert not np.any(ref["dropped"])


# leg -> (ServeConfig changes, MoEConfig changes, with a predictor)
OTHER_LEGS = {
    "sync": ({}, dict(overlap_migration=False), False),
    "gather": ({}, dict(replica_impl="gather"), False),
    "in_graph": (dict(in_graph_replan=True), {}, False),
    "reschedule": (dict(lever="reschedule", resched_impl="greedy"), {},
                   False),
    "both": (dict(lever="both", resched_impl="lp"), {}, False),
    "t2e": (dict(strategy="token_to_expert"), {}, True),
}


@pytest.mark.parametrize("leg", list(OTHER_LEGS))
def test_ep_serve_engine_runs_every_strategy_lever_and_store_mode(leg):
    """The EP engine's other paths on the router variant's MLA model: the
    synchronous and store-less fills, in-graph re-planning, both levers and
    Token-to-Expert run every batch to its end, with tokens in the
    vocabulary and the path each leg names in force (the MoE block and the
    engine are the ones ``tests/test_torch_serve_ep.py`` holds against the
    JAX package on Mixtral; MLA changes only the attention before them)."""
    import dataclasses

    from repro_torch.core.predictors import ConditionalProbabilityModel
    from repro_torch.data.synthetic import make_routing_trace

    serve_kw, moe_kw, with_pred = OTHER_LEGS[leg]
    jcfg, cfg = cfgs("router")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                           **moe_kw))
    pred = None
    if with_pred:
        tr = make_routing_trace(num_sequences=32, seq_len=S,
                                vocab=cfg.vocab_size,
                                num_experts=cfg.moe.num_experts,
                                num_layers=cfg.num_layers, skew=1.5, seed=0)
        pred = ConditionalProbabilityModel(
            cfg.num_layers, cfg.moe.num_experts,
            cfg.vocab_size).fit(tr.experts, tr.tokens)
    eng = ServeEngine(cfg, params_from_jax(widen_topk(_jax_tree(jcfg), jcfg),
                                           cfg, device="cpu"),
                      ServeConfig(**dict(SERVE_KW, **serve_kw)), ep_ranks=R,
                      ep=True, predictor=pred)
    for b in _batches(cfg.vocab_size):
        out, tele = eng.generate({"tokens": b}, max_new_tokens=NEW)
        toks = out.numpy()
        assert toks.shape == (B, NEW)
        assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
        assert tele["dropped"] >= 0
    if leg in ("reschedule", "both"):
        assert eng._resched_stack is not None
        assert "resched_residual" in eng.history[-1]
    if leg == "in_graph":
        assert all(torch.is_tensor(t) for t in eng._plan_stack)
    if leg == "gather":
        assert eng._store is None
    if leg == "sync":
        assert eng._store is not None and not eng._overlap


def test_both_continuous_engines_refuse_mla():
    jcfg, cfg = cfgs("reduced")
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    kw = dict(max_slots=2, prefill_len=16, block_size=8, max_len=32)
    with pytest.raises(ValueError, match="paged KV cache") as port:
        ContinuousEngine(cfg, model, ContinuousConfig(**kw))
    with pytest.raises(ValueError, match="paged KV cache") as ref:
        JaxContinuousEngine(jcfg, jax.tree.map(np.asarray, _jax_tree(jcfg)),
                            JaxContinuousConfig(**kw))
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="paged KV cache"):
        ContinuousEngine(cfg, model, ContinuousConfig(**kw), ep_ranks=R,
                         ep=True)
