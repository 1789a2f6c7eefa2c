"""Serving with the weights split over the data axis in the PyTorch port,
across processes (``launch.mesh``: one process a rank of a (2, 2) mesh,
``gloo`` on the CPU), against the meshed JAX package, on the CPU.

The JAX side runs in one subprocess with four host devices and
``--xla_allow_excess_precision=false``, on a (2, 2) ("data", "model")
mesh of ``AxisType.Auto`` axes, its parameters placed by
``repro.sharding.param_specs(tree, mesh=mesh, fsdp_axes=("data",),
fsdp_size=2)`` (and ``expert_tp_axes=("data",)`` for the expert-TP legs);
it starts first, so it runs while the port's one world does (every leg in
it, one intra-op thread a rank). Both packages run on the JAX init's
weights with wide margins (``tests/_torch_margins.py`` for the MoE
models, ``tests/_torch_dist_tp.py``'s ``widen_head`` for the others), so
no route or token sits near a tie and every run is compared to its end.
The MoE model is reduced Mixtral at 512 expert columns
(``tests/_torch_dist_fsdp_serve.py``'s ``variant``), where the "fsdp" rule
splits the experts' F dim, as at published widths. The legs:

* ``ServeEngine`` under "fsdp" for mixtral-8x7b (``dist_only`` with the
  replica store, whose rows take the experts' F split), stablelm-3b,
  recurrentgemma-2b and deepseek-v2-lite-16b: two batches of 4 x 16
  prompts, 5 new tokens. Equal: every batch's tokens on every rank;
  within ``LOGIT_ATOL`` plus one bf16 ulp of their magnitude, with the
  same argmax: every prefill's and decode step's logits.
* ``ContinuousEngine`` under "fsdp" for Mixtral: five staggered requests,
  a re-plan every 4 iterations, staged fills. Equal, per iteration: the
  generated lengths, the pairs dropped, the plan in force, the migration
  counters and the store; equal at the end: every token and the
  overflowed pairs; the producing logits within the tolerance above.
* Expert-TP decode: ``make_prefill_step`` on 8 x 16 prompts, then 4
  greedy ``make_decode_step`` steps under ``Runtime(decode_expert_tp=
  True)`` over "fsdp" + expert TP and a duplicated plan, once without and
  once with a reschedule quota stack. Equal: the greedy tokens, every
  step's expert and slot counts, drops and overflows (the counts summing
  to L x B x K); every step's logits within the tolerance above: the JAX
  package's own ``test_expert_tp_decode_matches_dense`` holds its logits
  to 5e-2, here ``LOGIT_ATOL``, plus one bf16 ulp of the widened logits'
  magnitude (they reach ~16, where one ulp is 0.125). The same steps on a
  "specs" model (the experts whole over "data", each rank cutting its
  block of F at use) equal the resident blocks' bit for bit.

On every rank the bytes of the parameters, and of the store's replica
rows, equal the sum of their ``Sharder.block_shape`` blocks.
"""

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

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models.transformer import init_model as jax_init_model  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from tests import _torch_dist_fsdp_serve as legs  # noqa: E402
from tests import _torch_dist_serve as ds  # noqa: E402
from tests import _torch_dist_tp as tp  # noqa: E402
from tests._torch_margins import widen_margins  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOGIT_ATOL = 5e-2             # bf16 logits, as in tests/test_torch_model.py
LOGIT_RTOL = 2.0 ** -7
COUNTERS = ("replans", "commits", "prebegun", "cancelled", "planned_bytes",
            "bytes_moved", "rejected")

SUB = '''
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_allow_excess_precision=false")
import dataclasses
import pickle
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs.registry import get_config
from repro.core.placement import PlacementPlan
from repro.models.transformer import Runtime, init_cache
from repro.serve import (ContinuousConfig, ContinuousEngine, ServeConfig,
                         ServeEngine, ServeRequest)
from repro.sharding import make_shardings, param_specs
from repro.train.steps import make_decode_step, make_prefill_step

with open(sys.argv[1], "rb") as f:
    inp = pickle.load(f)
exec(inp["serve_capture"])
exec(inp["continuous_capture"])
to_np = lambda a: np.asarray(a, np.float32)
mesh = jax.make_mesh(inp["mesh"], ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
D, R = inp["mesh"]


def config(arch, dup=None):
    cfg = get_config(arch).reduced()
    if cfg.is_moe:
        moe = dataclasses.replace(cfg.moe, d_ff_expert=inp["d_ff_expert"])
        if dup is not None:
            moe = dataclasses.replace(moe, duplication_slots=dup)
        cfg = dataclasses.replace(cfg, moe=moe)
    return cfg


def placed(arch, cfg, **kw):
    tree = jax.tree.map(jnp.asarray, inp["trees"][arch])
    if cfg.is_moe:
        tree["layers"]["moe"]["experts"] = jax.tree.map(
            lambda w: w.astype(jnp.bfloat16),
            tree["layers"]["moe"]["experts"])
    return jax.device_put(tree, make_shardings(mesh, param_specs(
        tree, mesh=mesh, fsdp_axes=("data",), fsdp_size=D, **kw)))


res = {}
for arch in inp["archs"]:
    cfg = config(arch)
    eng = ServeEngine(cfg, placed(arch, cfg), ServeConfig(
        **(inp["moe_kw"] if cfg.is_moe else inp["dense_kw"])), mesh=mesh,
                      ep_ranks=R)
    with mesh:
        res["serve_" + arch] = serve_tp(eng, inp["batches"][arch],
                                        inp["new"], inp["step_s"], to_np)

cfg = config("mixtral-8x7b")
eng = ContinuousEngine(cfg, placed("mixtral-8x7b", cfg), ContinuousConfig(
    **inp["engine_kw"]), mesh=mesh, ep_ranks=R)
reqs = [ServeRequest(**r) for r in inp["requests"]]
with mesh:
    res["continuous"] = serve_capture(eng, reqs, to_np, inp["plan_fields"])

cfg = config("mixtral-8x7b", dup=1)
tree = placed("mixtral-8x7b", cfg, expert_tp_axes=("data",))
rt = Runtime(mesh=mesh, ep=True, ep_ranks=R, use_duplication=True,
             decode_expert_tp=True)
prefill = jax.jit(make_prefill_step(cfg, rt))
decode = jax.jit(make_decode_step(cfg, rt), static_argnums=(3,))
plan = PlacementPlan(*(jnp.asarray(a) for a in inp["tp_plan"]))
S, steps = inp["tp_tokens"].shape[1], inp["tp_steps"]
stats_np = lambda st: {k: np.asarray(v, np.float32) for k, v in st.items()
                       if k not in ("aux_loss", "z_loss")}
for name, quota in (("tp", None), ("tp_resched", inp["tp_quota"])):
    q = None if quota is None else jnp.asarray(quota)
    cache = init_cache(cfg, rt, inp["tp_tokens"].shape[0], S + steps)
    with mesh:
        logits, cache, st = prefill(tree, {"tokens": jnp.asarray(
            inp["tp_tokens"])}, cache, plan, None, None, None, None, None, q)
        rec = {"logits": [to_np(logits)], "stats": [stats_np(st)],
               "tokens": []}
        tok = logits[:, -1].argmax(-1).astype(jnp.int32)[:, None]
        for t in range(steps):
            rec["tokens"].append(np.asarray(tok))
            tok, logits, cache, st = decode(tree, tok, cache, S + t, plan,
                                            None, None, None, None, q)
            rec["logits"].append(to_np(logits))
            rec["stats"].append(stats_np(st))
        rec["tokens"].append(np.asarray(tok))
    res[name] = rec
with open(sys.argv[2], "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced models' operations are tiny: one intra-op thread runs
    them as fast as many (each spawned rank runs one too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_tree(arch):
    """The JAX init's tree (numpy, fp32) of ``legs.variant``'s config with
    wide margins: the router's and ``lm_head``'s for a MoE model,
    ``lm_head``'s for the others."""
    cfg = legs.variant(jax_get_config(arch).reduced())
    tree = jax.tree.map(np.asarray, jax_init_model(jax.random.PRNGKey(0),
                                                   cfg))
    widen = widen_margins if cfg.is_moe else tp.widen_head
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        widen(tree, cfg))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": {leg: record}, "port": every rank's {leg: record}}."""
    tmp = tmp_path_factory.mktemp("dist_fsdp_serve")
    trees = {a: jax_tree(a) for a in legs.SERVE_ARCHS}
    mixtral = legs.tp_config(legs.variant(get_config("mixtral-8x7b")
                                          .reduced()))
    plan = legs.tp_plan(mixtral)
    vocab = mixtral.vocab_size
    inp = dict(
        trees=trees, archs=legs.SERVE_ARCHS, mesh=legs.MESH,
        d_ff_expert=legs.D_FF_EXPERT, serve_capture=tp.CAPTURE,
        continuous_capture=ds.CAPTURE, moe_kw=tp.MOE_SERVE_KW,
        dense_kw=tp.DENSE_SERVE_KW, new=tp.NEW, step_s=tp.STEP_S,
        batches={a: tp.serve_batches(legs.variant(get_config(a).reduced()))
                 for a in legs.SERVE_ARCHS},
        engine_kw=ds.ENGINE_KW, plan_fields=legs.PLAN_FIELDS,
        requests=ds.requests(vocab), tp_tokens=legs.tp_tokens(mixtral),
        tp_plan=tuple(plan), tp_quota=legs.tp_quota(mixtral, plan),
        tp_steps=legs.TP_STEPS)
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(SUB),
                             str(tmp / "in.pkl"), str(tmp / "jax.pkl")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    try:
        port = mesh_mod.spawn(legs.run_rank, (trees, legs.LEGS),
                              data=legs.MESH[0], model=legs.MESH[1],
                              backend="gloo", threads=1, timeout_s=300)
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    with open(tmp / "jax.pkl", "rb") as f:
        ref = pickle.load(f)
    return {"jax": ref, "port": port}


def _logits_close(got, want, what):
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=LOGIT_RTOL,
                               err_msg=what)
    np.testing.assert_array_equal(np.argmax(got, -1), np.argmax(want, -1),
                                  err_msg=what)


@pytest.mark.parametrize("arch", legs.SERVE_ARCHS)
def test_fsdp_serve_engine_matches_meshed_jax(runs, arch):
    name = f"serve_{arch}"
    rec, ref = runs["port"][0][name], runs["jax"][name]
    assert rec["tokens"] == ref["tokens"]
    assert len(rec["prefill"]) == len(ref["prefill"]) == tp.BATCHES
    assert len(rec["decode"]) == len(ref["decode"]) == tp.BATCHES * (
        tp.NEW - 1)
    for k, (a, b) in enumerate(zip(rec["prefill"], ref["prefill"])):
        _logits_close(a, b, f"prefill {k}")
    for k, (a, b) in enumerate(zip(rec["decode"], ref["decode"])):
        _logits_close(a, b, f"decode {k}")
    for r, other in enumerate(runs["port"][1:], 1):       # every rank alike
        assert other[name]["tokens"] == rec["tokens"], r
    # the layout splits every layer's matrices over "data": Mixtral's
    # experts along F (w_gate / w_up dim 2, w_down dim 1), as at published
    # widths (deepseek's reduced F equals d: w_down splits d)
    dims = rec["data_dims"]
    assert dims["embed"] is not None
    if arch == "mixtral-8x7b":
        assert (dims["layers.0.w_gate"], dims["layers.0.w_down"]) == (2, 1)
    if arch == "deepseek-v2-lite-16b":
        assert dims["layers.0.w_gate"] == 2


def _plans_equal(a, b, what):
    assert (a is None) == (b is None), what
    if a is not None:
        for f in legs.PLAN_FIELDS:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f"{f} {what}")


def test_fsdp_continuous_engine_matches_meshed_jax(runs):
    rec, ref = runs["port"][0]["continuous"], runs["jax"]["continuous"]
    assert rec["tokens"] == ref["tokens"]
    assert rec["lens"] == ref["lens"]
    assert rec["dropped"] == ref["dropped"]
    assert rec["entry_bytes"] == ref["entry_bytes"]     # the whole expert's
    for it in range(len(ref["lens"])):
        _plans_equal(rec["in_force"][it], ref["in_force"][it], f"@ {it}")
        for k in COUNTERS:
            assert rec["mig"][it][k] == ref["mig"][it][k], (k, it)
        np.testing.assert_array_equal(rec["store_se"][it],
                                      ref["store_se"][it], err_msg=str(it))
        np.testing.assert_array_equal(rec["store_version"][it],
                                      ref["store_version"][it],
                                      err_msg=str(it))
    assert [i for i, _ in rec["plans"]] == [i for i, _ in ref["plans"]]
    for (i, p), (_, q) in zip(rec["plans"], ref["plans"]):
        _plans_equal(p, q, f"re-plan @ {i}")
    for rid, toks in enumerate(ref["tokens"]):
        _logits_close(rec["prefill"][rid], ref["prefill"][rid],
                      f"rid {rid} prefill")
        for i in range(1, len(toks)):
            it = next(k for k, row in enumerate(ref["lens"]) if row[rid] > i)
            slot = ref["slots"][rid]
            _logits_close(rec["decode"][it][slot], ref["decode"][it][slot],
                          f"rid {rid} @ {it}")
    assert rec["overflow"] == ref["overflow"]
    for r, other in enumerate(runs["port"][1:], 1):
        for k in ("tokens", "lens", "dropped", "mig"):
            assert other["continuous"][k] == rec[k], (k, r)
    # the comparison bites: pairs drop, re-plans replicate, fills commit
    last = rec["mig"][-1]
    assert len(rec["plans"]) >= 2 and sum(rec["dropped"]) > 0
    assert any((p["n_replicas"] > 1).any() for _, p in rec["plans"])
    assert last["commits"] >= 1 and last["bytes_moved"] > 0


@pytest.mark.parametrize("name", ["tp", "tp_resched"])
def test_expert_tp_decode_matches_meshed_jax(runs, name):
    rec, ref = runs["port"][0][name], runs["jax"][name]
    cfg = legs.tp_config(legs.variant(get_config("mixtral-8x7b").reduced()))
    assert len(rec["tokens"]) == len(ref["tokens"]) == legs.TP_STEPS + 1
    for t, (a, b) in enumerate(zip(rec["tokens"], ref["tokens"])):
        np.testing.assert_array_equal(a, b, err_msg=f"tokens {t}")
    for t, (a, b) in enumerate(zip(rec["logits"], ref["logits"])):
        _logits_close(a, b, f"step {t}")
    want = cfg.num_layers * cfg.moe.top_k
    for t, (a, b) in enumerate(zip(rec["stats"], ref["stats"])):
        for k in ("expert_counts", "slot_counts", "dropped", "overflow"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{k} {t}")
        tokens = legs.TP_B * (legs.TP_S if t == 0 else 1)
        assert a["expert_counts"].sum() == want * tokens, t
        assert a["slot_counts"].sum() + a["dropped"].sum() == want * tokens
    # the comparison bites: replica slots serve pairs in decode, and the
    # quota's rescue round takes overflowed pairs in the prefill
    S = cfg.moe.num_experts // legs.MESH[1] + 1
    assert any(st["slot_counts"][:, S - 1::S].sum() > 0
               for st in rec["stats"][1:])
    if name == "tp_resched":
        assert rec["stats"][0]["overflow"].sum() > 0
    for r, other in enumerate(runs["port"][1:], 1):
        for t, a in enumerate(other[name]["tokens"]):
            np.testing.assert_array_equal(a, rec["tokens"][t], err_msg=str(r))
        for t, a in enumerate(other[name]["logits"]):
            np.testing.assert_array_equal(a, rec["logits"][t], err_msg=str(r))
    # experts split over both axes: EP over "model", F over "data"
    assert rec["expert_spec"] == ["('model', None, 'data')"] * 2 + [
        "('model', 'data', None)"]


def test_expert_tp_decode_on_whole_experts_equals_resident_blocks(runs):
    """Under "specs" the experts are whole over "data": each decode step
    cuts this rank's block of F from them, and computes what the resident
    blocks of "fsdp" + expert TP compute, bit for bit."""
    rec, ref = runs["port"][0]["tp_specs"], runs["port"][0]["tp"]
    assert rec["expert_spec"] == ["('model', None, None)"] * 3
    for t, (a, b) in enumerate(zip(rec["tokens"], ref["tokens"])):
        np.testing.assert_array_equal(a, b, err_msg=f"tokens {t}")
    for t, (a, b) in enumerate(zip(rec["logits"], ref["logits"])):
        np.testing.assert_array_equal(a, b, err_msg=f"logits {t}")
    for t, (a, b) in enumerate(zip(rec["stats"], ref["stats"])):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{k} {t}")


@pytest.mark.parametrize("name", legs.LEGS)
def test_each_rank_holds_its_blocks(runs, name):
    """Every rank's parameter bytes equal the sum of its blocks', below
    the whole model's; a replica store's rows hold a home expert's block
    each."""
    for r, rank in enumerate(runs["port"]):
        b = rank[name]["bytes"]
        assert b["held"] == b["blocks"], r
        if "store" in b:
            assert b["store"] == b["store_blocks"] > 0, r
