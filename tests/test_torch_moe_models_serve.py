"""The paper's other MoE models served by the PyTorch port's
``ContinuousEngine`` against the JAX package's, on the CPU.

``llama-moe-3.5b``, ``switch-base-128`` and ``arctic-480b`` at
``reduced()`` (4 experts; top-2, top-1 and top-2; arctic with its dense
residual branch), from the JAX init's weights with wide router and
``lm_head`` margins (``tests/_torch_margins.py``: every route and every
greedy token several logits from a tie), bridged into the port. Each model
serves one short trace twice: on the dense path (the meshless JAX engine,
``ep_ranks=4``) and on the EP path (4 ranks, ``dist_only``, one replica
slot a rank, the replica store with staged fills: the engines' defaults;
the JAX engine on a ``(1, 4)`` ``AxisType.Auto`` mesh). A rank
holds 16 tokens of a 64-token prefill bucket, more than the capacity
floor of 8 pairs a slot, so the EP legs drop pairs. The JAX engines run
in one subprocess with four host devices and without XLA's excess
precision (``--xla_allow_excess_precision=false``), so they round bf16
where the port does.

Both runs go to the end of the trace with no near-tie cut-off: per
iteration the generated lengths, the pairs dropped at capacity, the plan
stack in force and the migration counters are equal, and so are every
re-plan's plan, the generated tokens and the summary's counters.
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
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import (ContinuousConfig, ContinuousEngine,  # noqa: E402
                               ServeRequest)

from tests._torch_margins import SOURCE as MARGINS_SOURCE  # noqa: E402
from tests._torch_margins import widen_margins  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("llama-moe-3.5b", "switch-base-128", "arctic-480b")
LEGS = ("dense", "ep")
ENGINE_KW = dict(max_slots=4, prefill_len=64, block_size=8, max_len=96,
                 strategy="dist_only", predict_interval=2, dup_slots=1)
PLAN_FIELDS = ("n_replicas", "replica_table", "pool_expert", "pool_sel")
COUNTERS = ("replans", "commits", "prebegun", "cancelled", "planned_bytes",
            "bytes_moved", "rejected")
COLUMNS = ("completed", "dropped_tokens", "migration_replans",
           "migration_commits", "migration_bytes_moved")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced models' operations are tiny: one intra-op thread runs
    them as fast as many, and keeps this file from oversubscribing the
    cores when test workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requests(vocab):
    """Prompts drawn mostly from the first token group (``widen_margins``
    routes it to experts 0 and 1), so the expert histogram is skewed and
    Algorithm 1 replicates: on flat traffic it keeps every slot home."""
    rng = np.random.default_rng(2)
    hot = vocab // get_config(ARCHS[0]).reduced().moe.num_experts
    return [dict(rid=i, tokens=rng.integers(0, hot if i % 4 else vocab,
                                            n).tolist(),
                 max_new_tokens=6, arrival=float(i))
            for i, n in enumerate((5, 47, 11, 60, 29))]


# Executed by the JAX subprocess and here: serve one trace, one iteration
# per virtual second, recording what the engine did at every iteration.
CAPTURE = '''
def serve_capture(eng, reqs, plan_fields, columns):
    eng.warmup()
    rec = {"plans": [], "lens": [], "dropped": [], "in_force": [],
           "mig": []}
    replan = eng.replan
    def recording_replan():
        out = replan()
        rec["plans"].append((eng.iterations, {f: np.asarray(getattr(
            eng._plan_stack, f)).copy() for f in plan_fields}))
        return out
    eng.replan = recording_replan
    for r in reqs:
        eng.submit(r)
    while eng.has_work() and len(rec["lens"]) < 100:
        before = eng.metrics.summary()["dropped_tokens"]
        eng.step(float(len(rec["lens"])))
        rec["lens"].append([len(r.generated) for r in reqs])
        rec["dropped"].append(eng.metrics.summary()["dropped_tokens"]
                              - before)
        rec["in_force"].append({f: np.asarray(getattr(
            eng._plan_stack, f)).copy() for f in plan_fields})
        rec["mig"].append(dict(eng.metrics.migration))
    s = eng.metrics.summary()
    rec["summary"] = {k: float(s[k]) for k in columns}
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
from repro.models.transformer import init_model
from repro.serve import ContinuousConfig, ContinuousEngine, ServeRequest

exec(os.environ["MM_MARGINS"])
exec(os.environ["MM_CAPTURE"])
fields, columns = eval(os.environ["MM_FIELDS"]), eval(os.environ["MM_COLUMNS"])
mesh = jax.make_mesh((1, 4), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
res = {}
for arch in eval(os.environ["MM_ARCHS"]):
    cfg = get_config(arch).reduced()
    tree = jax.tree.map(jnp.asarray, widen_margins(jax.tree.map(
        np.asarray, init_model(jax.random.PRNGKey(0), cfg)), cfg))
    tree["layers"]["moe"]["experts"] = jax.tree.map(
        lambda w: w.astype(jnp.bfloat16), tree["layers"]["moe"]["experts"])
    reqs = eval(os.environ["MM_REQUESTS"])[arch]
    for leg in ("dense", "ep"):
        kw = dict(mesh=mesh) if leg == "ep" else {}
        eng = ContinuousEngine(cfg, tree, ContinuousConfig(
            **eval(os.environ["MM_ENGINE"])), ep_ranks=4, **kw)
        rows = [ServeRequest(**dict(r, tokens=np.asarray(r["tokens"],
                                                         np.int32)))
                for r in reqs]
        if leg == "ep":
            with mesh:
                res[(arch, leg)] = serve_capture(eng, rows, fields, columns)
        else:
            res[(arch, leg)] = serve_capture(eng, rows, fields, columns)
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_models") / "jax_serve.pkl"
    reqs = {a: _requests(get_config(a).reduced().vocab_size) for a in ARCHS}
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               MM_MARGINS=MARGINS_SOURCE, MM_CAPTURE=CAPTURE,
               MM_FIELDS=repr(PLAN_FIELDS), MM_COLUMNS=repr(COLUMNS),
               MM_ARCHS=repr(ARCHS), MM_REQUESTS=repr(reqs),
               MM_ENGINE=repr(ENGINE_KW))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB),
                           str(out)], capture_output=True, text=True,
                          timeout=900, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _port_run(arch, leg):
    jcfg = jax_get_config(arch).reduced()
    tree = widen_margins(jax.tree.map(np.asarray, jax_init_model(
        jax.random.PRNGKey(0), jcfg)), jcfg)
    cfg = get_config(arch).reduced()
    eng = ContinuousEngine(cfg, params_from_jax(tree, cfg, device="cpu"),
                           ContinuousConfig(**ENGINE_KW), ep_ranks=4,
                           ep=leg == "ep")
    scope = {"np": np}
    exec(CAPTURE, scope)
    reqs = [ServeRequest(**dict(r, tokens=np.asarray(r["tokens"], np.int32)))
            for r in _requests(cfg.vocab_size)]
    ops.reset_launches()
    rec = scope["serve_capture"](eng, reqs, PLAN_FIELDS, COLUMNS)
    assert sum(ops.LAUNCHES.values()) == 0       # the CPU runs plain versions
    return eng, rec


@pytest.mark.parametrize("leg", LEGS)
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_the_jax_engine_to_the_end(jax_ref, arch, leg):
    ref = jax_ref[(arch, leg)]
    eng, rec = _port_run(arch, leg)
    assert rec["tokens"] == ref["tokens"]
    assert rec["lens"] == ref["lens"]
    assert rec["dropped"] == ref["dropped"]
    for it in range(len(ref["lens"])):
        for f in PLAN_FIELDS:
            np.testing.assert_array_equal(rec["in_force"][it][f],
                                          ref["in_force"][it][f],
                                          err_msg=f"{f} in force @ {it}")
        for k in COUNTERS:
            assert rec["mig"][it][k] == ref["mig"][it][k], (k, it)
    assert [i for i, _ in rec["plans"]] == [i for i, _ in ref["plans"]]
    for (i, p), (_, q) in zip(rec["plans"], ref["plans"]):
        for f in PLAN_FIELDS:
            np.testing.assert_array_equal(p[f], q[f], err_msg=f"re-plan @ {i}")
    assert rec["summary"] == ref["summary"]
    s = rec["summary"]
    assert s["completed"] == len(rec["tokens"]) and len(rec["plans"]) >= 2
    assert any((p["n_replicas"] > 1).any() for _, p in rec["plans"])
    if leg == "ep":
        assert eng._store is not None and s["migration_commits"] >= 1
        assert s["dropped_tokens"] > 0       # capacity binds: the check bites
    else:
        assert s["dropped_tokens"] == 0
