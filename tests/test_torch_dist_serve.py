"""The port's engines over a process mesh (``launch.mesh``: one process a
mesh rank, ``gloo`` on the CPU) against the meshed JAX engines, on the
CPU.

The JAX side runs in one subprocess with four host devices and
``--xla_allow_excess_precision=false``, on ``(1, 4)`` and ``(2, 2)``
("data", "model") meshes of ``AxisType.Auto`` axes (jax's default
``Explicit`` axes refuse the JAX model's sharding constraints), started
first so that it runs while the port's worlds do. Both packages serve
reduced Mixtral on the JAX init's weights with wide router and
``lm_head`` margins (``tests/_torch_margins.py``; the JAX experts cast to
the port's bf16), so no route or token sits near a tie and every run is
compared to its end. The legs (``tests/_torch_dist_serve.py``):

* ``ContinuousEngine`` with the replica store under ``dist_only`` on a
  (1, 4) and a (2, 2) mesh, and under lever ``reschedule`` on the (2, 2)
  mesh: five staggered requests, a re-plan every 4 iterations, the
  prefetcher on, the migration gate off (it compares predicted gains with
  wall-clock step times, which differ between the frameworks). On the
  (2, 2) mesh a one-slot prefill runs whole on both data ranks and the
  decode batch of 4 slots splits over them. Equal, per iteration: the
  generated lengths, the pairs dropped at capacity, the plan in force, the
  migration counters (replans, commits, pre-begins, cancels, planned and
  moved bytes), the store's slot map and versions; equal at every
  re-plan: the plan; equal at the end: every token and the overflowed
  pairs. The prompts are Zipf tokens shifted by 256 every second request,
  so the hot experts move and the plans replicate them. The logits that
  produced each token agree within ``LOGIT_ATOL`` plus one bf16 ulp of
  their magnitude (``rtol`` 2^-7: the widened head's logits reach ~16),
  as in ``tests/test_torch_serve_ep.py``.
* ``ServeEngine(ep=True)`` with the store on the (2, 2) mesh: three
  batches of 2 x 16 prompts (each prompt on its own data rank, 8
  positions a model rank), 6 new tokens, a re-plan per batch, 2-entry
  fill chunks under a pinned overlap window. Equal per batch: the tokens,
  the plan in force, the re-plans, the store, ``history[-1]``, the last
  migration and every prefill's slot counts; every prefill's and decode
  step's logits within the tolerance above.

The (1, 4) process engine is also equal to the port's ``StackedRanks``
engine (every rank in this process) on the same leg, logits included, bit
for bit. Every rank of a world records the same run. Last, the launcher
and its refusals: ``python -m repro_torch.launch.serve --backend gloo`` on
a (2, 2) mesh serves every request; ``--backend nccl`` without four
cards raises.
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
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from tests import _torch_dist_serve as legs  # noqa: E402
from tests._torch_margins import SOURCE as MARGINS_SOURCE  # noqa: E402
from tests._torch_margins import widen_margins  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOGIT_ATOL = 5e-2             # bf16 logits, as in tests/test_torch_model.py
LOGIT_RTOL = 2.0 ** -7
COUNTERS = ("replans", "commits", "prebegun", "cancelled", "planned_bytes",
            "bytes_moved", "rejected")
CONTINUOUS = [n for n, (k, _, _) in legs.LEGS.items() if k == "continuous"]

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
from repro.serve import (ContinuousConfig, ContinuousEngine, ServeConfig,
                         ServeEngine, ServeRequest)

exec(os.environ["DS_MARGINS"])
exec(os.environ["DS_CAPTURE"])
fields = ("n_replicas", "replica_table", "pool_expert", "pool_sel")
base = get_config("mixtral-8x7b").reduced()
tree = widen_margins(jax.tree.map(np.asarray, init_model(
    jax.random.PRNGKey(0), base)), base)
tree = jax.tree.map(jnp.asarray, tree)
tree["layers"]["moe"]["experts"] = jax.tree.map(
    lambda w: w.astype(jnp.bfloat16), tree["layers"]["moe"]["experts"])
to_np = lambda a: np.asarray(a, np.float32)
engine_kw, serve_kw = eval(os.environ["DS_ENGINE_KW"]), eval(
    os.environ["DS_SERVE_KW"])
batches = [np.asarray(b, np.int32) for b in eval(os.environ["DS_BATCHES"])]
new, step_s = eval(os.environ["DS_NEW"]), eval(os.environ["DS_STEP_S"])
res = {}
for name, (kind, shape, changes) in eval(os.environ["DS_LEGS"]).items():
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    if kind == "continuous":
        eng = ContinuousEngine(base, tree, ContinuousConfig(
            **dict(engine_kw, **changes)), mesh=mesh, ep_ranks=shape[1])
        reqs = [ServeRequest(**dict(r, tokens=np.asarray(r["tokens"],
                                                         np.int32)))
                for r in eval(os.environ["DS_REQUESTS"])]
        with mesh:
            res[name] = serve_capture(eng, reqs, to_np, fields)
    else:
        eng = ServeEngine(base, tree, ServeConfig(**dict(serve_kw,
                                                         **changes)),
                          mesh=mesh, ep_ranks=shape[1])
        with mesh:
            res[name] = serve_batches(eng, batches, new, step_s, to_np,
                                      fields)
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced model's operations are tiny: one intra-op thread runs
    them as fast as many (each spawned rank runs one too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": the JAX legs, "port": {mesh: every rank's legs}, "stacked":
    the (1, 4) leg with its ranks stacked in this process}."""
    base = jax_get_config("mixtral-8x7b").reduced()
    tree = widen_margins(jax.tree.map(np.asarray, jax_init_model(
        jax.random.PRNGKey(0), base)), base)
    vocab = base.vocab_size
    out = tmp_path_factory.mktemp("dist_serve") / "jax.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               DS_MARGINS=MARGINS_SOURCE, DS_CAPTURE=legs.CAPTURE,
               DS_LEGS=repr(legs.LEGS), DS_ENGINE_KW=repr(legs.ENGINE_KW),
               DS_SERVE_KW=repr(legs.SERVE_KW), DS_NEW=repr(legs.NEW),
               DS_STEP_S=repr(legs.STEP_S),
               DS_BATCHES=repr([b.tolist() for b in legs.batches(vocab)]),
               DS_REQUESTS=repr([dict(r, tokens=r["tokens"].tolist())
                                 for r in legs.requests(vocab)]))
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(SUB),
                             str(out)], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env)
    try:
        port = {}
        for shape in sorted({m for _, m, _ in legs.LEGS.values()}):
            names = [n for n, (_, m, _) in legs.LEGS.items() if m == shape]
            port[shape] = mesh_mod.spawn(
                legs.run_rank, (tree, names), data=shape[0], model=shape[1],
                backend="gloo", threads=1, timeout_s=300)
        stacked = legs.run_leg("cont_1x4", tree)
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    with open(out, "rb") as f:
        ref = pickle.load(f)
    return {"jax": ref, "port": port, "stacked": stacked}


def _rank0(runs, name):
    return runs["port"][legs.LEGS[name][1]][0][name]


def _plans_equal(a, b, what):
    assert (a is None) == (b is None), what
    if a is not None:
        for f in legs.PLAN_FIELDS:
            np.testing.assert_array_equal(a[f], b[f], err_msg=f"{f} {what}")


def _producing_logits(rec):
    """(rid, decode iteration or None for the prefill, logits) of every
    token: the rows that produced it (an idle slot's row is no result)."""
    out = []
    for rid, toks in enumerate(rec["tokens"]):
        out.append((rid, None, rec["prefill"][rid]))
        for i in range(1, len(toks)):
            it = next(k for k, row in enumerate(rec["lens"]) if row[rid] > i)
            out.append((rid, it, rec["decode"][it][rec["slots"][rid]]))
    return out


def _logits_close(got, want, what):
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=LOGIT_RTOL,
                               err_msg=what)
    np.testing.assert_array_equal(np.argmax(got, -1), np.argmax(want, -1),
                                  err_msg=what)


@pytest.mark.parametrize("name", CONTINUOUS)
def test_process_continuous_engine_matches_meshed_jax(runs, name):
    rec, ref = _rank0(runs, name), runs["jax"][name]
    assert rec["tokens"] == ref["tokens"]
    assert rec["lens"] == ref["lens"]
    assert rec["dropped"] == ref["dropped"]
    assert rec["entry_bytes"] == ref["entry_bytes"]
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
    for rid, it, lg in _producing_logits(ref):
        got = (rec["prefill"][rid] if it is None
               else rec["decode"][it][rec["slots"][rid]])
        _logits_close(got, lg, f"rid {rid} @ {it}")
    assert rec["overflow"] == ref["overflow"]
    # the comparison bites: pairs drop; re-plans replicate and their fills
    # commit, moving bytes; the frozen plan of "reschedule" sends the
    # overflowing pairs to a rescue round instead
    last = rec["mig"][-1]
    assert len(rec["plans"]) >= 2 and sum(rec["dropped"]) > 0
    if "resched" in name:
        assert rec["overflow"] > 0
    else:
        assert any((p["n_replicas"] > 1).any() for _, p in rec["plans"])
        assert last["commits"] >= 1 and last["bytes_moved"] > 0


def test_process_serve_engine_matches_meshed_jax(runs):
    rec, ref = _rank0(runs, "serve_2x2"), runs["jax"]["serve_2x2"]
    assert rec["tokens"] == ref["tokens"]
    for k in range(legs.BATCHES):
        _plans_equal(rec["in_force"][k], ref["in_force"][k], f"batch {k}")
        assert rec["store_se"][k] == ref["store_se"][k], k
        assert rec["store_version"][k] == ref["store_version"][k], k
        assert rec["history"][k] == ref["history"][k], k
        assert rec["migration"][k] == ref["migration"][k], k
        np.testing.assert_array_equal(rec["slot_counts"][k],
                                      ref["slot_counts"][k], err_msg=str(k))
    assert [b for b, _ in rec["replans"]] == [b for b, _ in ref["replans"]]
    for (b, p), (_, q) in zip(rec["replans"], ref["replans"]):
        _plans_equal(p, q, f"re-plan @ batch {b}")
    assert len(rec["prefill"]) == len(ref["prefill"]) == legs.BATCHES
    assert len(rec["decode"]) == len(ref["decode"])
    for k, (a, b) in enumerate(zip(rec["prefill"], ref["prefill"])):
        _logits_close(a, b, f"prefill {k}")
    for k, (a, b) in enumerate(zip(rec["decode"], ref["decode"])):
        _logits_close(a, b, f"decode {k}")
    assert any(h.get("migration_entries", 0) > 0 for h in rec["history"])
    assert max(max(v) for v in rec["store_version"]) >= 1


def test_1x4_process_engine_equals_stacked_engine(runs):
    rec, ref = _rank0(runs, "cont_1x4"), runs["stacked"]
    for k in ("tokens", "lens", "dropped", "mig", "slots"):
        assert rec[k] == ref[k], k
    for it in range(len(ref["lens"])):
        _plans_equal(rec["in_force"][it], ref["in_force"][it], f"@ {it}")
    for (i, p), (j, q) in zip(rec["plans"], ref["plans"]):
        assert i == j
        _plans_equal(p, q, f"re-plan @ {i}")
    for (rid, it, a), (_, _, b) in zip(_producing_logits(rec),
                                       _producing_logits(ref)):
        np.testing.assert_array_equal(a, b, err_msg=f"rid {rid} @ {it}")


@pytest.mark.parametrize("name", list(legs.LEGS))
def test_every_rank_records_the_same_run(runs, name):
    ranks = runs["port"][legs.LEGS[name][1]]
    first = ranks[0][name]
    for r, rec in enumerate(ranks[1:], 1):
        rec = rec[name]
        assert rec["tokens"] == first["tokens"], r
        keys = (("lens", "dropped", "mig") if "lens" in first
                else ("history", "migration", "store_se"))
        for k in keys:
            assert rec[k] == first[k], (k, r)


def test_launch_serve_over_gloo_processes():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "mixtral-8x7b", "--reduced", "--device", "cpu", "--data-mesh", "2",
         "--model-mesh", "2", "--backend", "gloo", "--requests", "5",
         "--batch", "2", "--seq", "16", "--new-tokens", "4"],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = proc.stdout
    assert "EP over a 2x2 mesh of processes (gloo, cpu" in out
    assert "served 5 requests in 3 batches on cpu" in out
    assert out.count("served") == 1                  # rank 0 reports alone


def test_process_backends_are_named_not_chosen():
    from repro_torch.launch import serve as launch_serve

    argv = ["--arch", "mixtral-8x7b", "--reduced", "--data-mesh", "1",
            "--model-mesh", "4", "--requests", "1", "--batch", "1"]
    with pytest.raises(ValueError, match="backend nccl runs on cards"):
        launch_serve.main(argv + ["--device", "cpu", "--backend", "nccl"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            launch_serve.main(argv + ["--backend", "gloo"])
    with pytest.raises(ValueError, match="give --data-mesh"):
        launch_serve.main(["--arch", "mixtral-8x7b", "--reduced",
                           "--device", "cpu", "--backend", "gloo"])
