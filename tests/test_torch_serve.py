"""The PyTorch port's serving stack: allocator and scheduler cases of
``tests/test_continuous_serve.py`` run on the port, engine parity with the
JAX ``ContinuousEngine``, and the rule that the port imports nothing of
JAX or of the JAX package.

Engine parity: both engines serve the same three staggered requests on
the same (bridged) reduced-Mixtral weights without a mesh, with
``ep_ranks=2``, strategy ``dist_only`` and a re-plan every 2 iterations.
They must complete the same requests with the same tokens, hold estimator
counts that agree (allclose) and adopt equal plan stacks at every re-plan.
A token may differ only where the JAX logits' top-2 margin is under two
bf16 ulps, which the test establishes by re-running that step
teacher-forced; comparisons then stop at that iteration.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models.transformer import Runtime as JaxRuntime  # noqa: E402
from repro.models.transformer import forward as jax_forward  # noqa: E402
from repro.models.transformer import init_cache as jax_init_cache  # noqa: E402
from repro.models.transformer import init_model as jax_init_model  # noqa: E402
from repro.serve import ContinuousConfig as JaxCCfg  # noqa: E402
from repro.serve import ContinuousEngine as JaxEngine  # noqa: E402
from repro.serve import ServeRequest as JaxRequest  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.duplication import duplicate_experts_host  # noqa: E402
from repro_torch.core.placement import stack_plans  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serve import (BlockAllocator, ContinuousConfig,  # noqa: E402
                               ContinuousEngine, ContinuousScheduler,
                               ServeRequest, imbalance, plan_rank_loads)
from repro_torch.serve.scheduler import RequestState  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


# --------------------------------------------------------------------------
# KV block allocator and continuous scheduler (cases of
# tests/test_continuous_serve.py)
# --------------------------------------------------------------------------

def test_block_allocator_alloc_free_roundtrip():
    a = BlockAllocator(num_blocks=9, block_size=4)
    assert a.free_blocks == 8                       # block 0 reserved
    got = a.alloc(5)
    assert len(got) == 5 and 0 not in got
    assert a.alloc(4) is None                       # all-or-nothing
    assert a.free_blocks == 3
    a.free(got)
    assert a.free_blocks == 8
    with pytest.raises(ValueError):
        a.free([0])                                 # null block protected


def test_block_allocator_blocks_for():
    a = BlockAllocator(num_blocks=4, block_size=8)
    assert a.blocks_for(1) == 1
    assert a.blocks_for(8) == 1
    assert a.blocks_for(9) == 2


def _sched(max_slots=2, prefill_len=8, max_len=16, num_blocks=None,
           block_size=4, **kw):
    if num_blocks is None:
        num_blocks = 1 + max_slots * (max_len // block_size)
    alloc = BlockAllocator(num_blocks, block_size)
    return ContinuousScheduler(max_slots, prefill_len, max_len, alloc, **kw)


def _req(rid, plen=6, new=4, arrival=0.0):
    return ServeRequest(rid=rid, tokens=np.arange(plen, dtype=np.int32),
                        max_new_tokens=new, arrival=arrival)


def test_admission_respects_slots_and_arrival_times():
    s = _sched(max_slots=2)
    for i in range(3):
        s.submit(_req(i, arrival=float(i)))
    plan = s.schedule(now=0.0)
    assert [r.rid for r in plan.prefills] == [0]    # only rid 0 has arrived
    plan = s.schedule(now=5.0)
    assert [r.rid for r in plan.prefills] == [1]    # rid 2 waits for a slot
    assert s.request_in(0).rid == 0
    s.finish_slot(0, now=6.0)
    plan = s.schedule(now=6.0)
    assert [r.rid for r in plan.prefills] == [2]


def test_finish_frees_blocks_and_slot():
    s = _sched(max_slots=1)
    free0 = s.alloc.free_blocks
    s.submit(_req(0, plen=6))
    s.schedule(0.0)
    assert s.alloc.free_blocks == free0 - 2         # ceil(6/4) blocks
    req = s.finish_slot(0, 1.0)
    assert req.state == RequestState.FINISHED
    assert s.alloc.free_blocks == free0
    assert s.slots[0] is None


def test_decode_growth_allocates_block_on_boundary():
    s = _sched(max_slots=1, block_size=4)
    s.submit(_req(0, plen=4, new=4))
    plan = s.schedule(0.0)
    assert len(s.tables.owned[0]) == 1              # prompt fits one block
    s.ensure_decode_capacity(plan)                  # next write at pos 4
    assert len(s.tables.owned[0]) == 2


def test_pool_exhaustion_preempts_youngest():
    s = _sched(max_slots=2, prefill_len=8, max_len=12, num_blocks=4,
               block_size=4)
    s.submit(_req(0, plen=4, new=7, arrival=0.0))
    s.submit(_req(1, plen=4, new=7, arrival=0.1))
    plan = s.schedule(1.0)
    assert len(plan.prefills) == 2                  # both admitted (1 blk each)
    s.tables.lengths[:] = 4                         # both hit a block boundary
    s.ensure_decode_capacity(plan)
    assert [r.rid for r in plan.preempted] == [1]
    assert s.slots[1] is None and s.waiting[0].rid == 1
    assert s.waiting[0].n_preemptions == 1
    assert plan.decode_slots == [0]


def test_oversized_request_rejected():
    s = _sched(max_slots=1, prefill_len=8, max_len=16, num_blocks=3,
               block_size=4)
    with pytest.raises(ValueError):
        s.submit(_req(0, plen=8, new=8))            # needs 4 of 2 blocks


def test_full_length_prompt_accepted_on_tight_pool():
    s = _sched(max_slots=1, prefill_len=8, max_len=8, num_blocks=3,
               block_size=4)
    s.submit(_req(0, plen=8, new=4))                # clamped to 1 new token
    plan = s.schedule(0.0)
    assert [r.rid for r in plan.prefills] == [0]
    assert s.slots[0].max_new_tokens == 1


def test_plan_rank_loads_identity_vs_duplicated():
    E, R, D = 8, 4, 1
    p = np.full((E,), (1.0 - 3.0 / E) / (E - 1))
    p[0] = 3.0 / E
    counts = np.tile(p * 1000.0, (2, 1))
    home = plan_rank_loads(counts, None, R, 0)
    assert home.shape == (2, R)
    assert imbalance(home) > 1.5
    plans = [duplicate_experts_host(counts[l] / counts[l].sum(), R, D, 4).plan
             for l in range(2)]
    dup = plan_rank_loads(counts, stack_plans(plans), R, D)
    assert imbalance(dup) < imbalance(home)


# --------------------------------------------------------------------------
# engine parity with the JAX ContinuousEngine
# --------------------------------------------------------------------------

KW = dict(max_slots=4, prefill_len=32, block_size=8, max_len=64,
          strategy="dist_only", predict_interval=2)
PLAN_FIELDS = ("n_replicas", "replica_table", "pool_expert", "pool_sel")
SEED = 1        # these prompts make every re-plan replicate an expert


def _prompts(vocab):
    rng = np.random.default_rng(SEED)
    return ([rng.integers(0, vocab, n).astype(np.int32) for n in (5, 17, 11)],
            [0.0, 1.0, 3.0])


def _serve(engine_cls, cfg_cls, req_cls, cfg, model):
    """Serve the three requests one iteration per virtual second. Returns
    (requests, [(iteration, {field: plan array})], [(tokens by rid,
    estimator counts)] per iteration, engine)."""
    eng = engine_cls(cfg, model, cfg_cls(**KW), ep_ranks=2)
    eng.warmup()
    plans = []
    replan = eng.replan

    def recording_replan():
        out = replan()
        plans.append((eng.iterations, {f: np.asarray(getattr(
            eng._plan_stack, f)).copy() for f in PLAN_FIELDS}))
        return out
    eng.replan = recording_replan
    prompts, arrivals = _prompts(cfg.vocab_size)
    reqs = [req_cls(rid=i, tokens=p, max_new_tokens=6, arrival=a)
            for i, (p, a) in enumerate(zip(prompts, arrivals))]
    for r in reqs:
        eng.submit(r)
    history = []
    it = 0
    while eng.has_work() and it < 100:
        eng.step(float(it))
        it += 1
        history.append(({r.rid: list(r.generated) for r in reqs},
                        eng.estimator.counts.copy()))
    return reqs, plans, history, eng


def _jax_next_logits(jcfg, params, tokens):
    """JAX logits for the token after ``tokens``, re-run teacher-forced as
    one prefill of the whole prefix."""
    S = KW["max_len"]
    rt = JaxRuntime(window_override=S)
    toks = np.zeros((1, S), np.int32)
    toks[0, :len(tokens)] = tokens
    logits, _, _ = jax_forward(params, jcfg, {"tokens": jnp.asarray(toks)},
                               rt, mode="prefill",
                               cache=jax_init_cache(jcfg, rt, 1, S),
                               last_pos=jnp.asarray([len(tokens) - 1]))
    return np.asarray(logits[0, -1], np.float32)


def _near_tie(logits) -> bool:
    """Top-2 margin under two bf16 ulps of the top logit."""
    a, b = np.sort(logits)[-2:][::-1]
    ulp = 2.0 ** (np.floor(np.log2(max(abs(a), 1e-30))) - 7)
    return a - b < 2 * ulp


@pytest.fixture(scope="module")
def served():
    jcfg = jax_get_config("mixtral-8x7b").reduced()
    cfg = get_config("mixtral-8x7b").reduced()
    params = jax_init_model(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    ops.reset_launches()
    port = _serve(ContinuousEngine, ContinuousConfig, ServeRequest, cfg, model)
    launches = ops.LAUNCHES["paged_decode_attention"]
    ref = _serve(JaxEngine, JaxCCfg, JaxRequest, jcfg, params)
    return jcfg, params, ref, port, launches


def test_engine_matches_jax_engine(served):
    jcfg, params, (j_reqs, j_plans, j_hist, _), (t_reqs, t_plans, t_hist,
                                                  t_eng), _ = served
    # the first iteration at which any generated token differs
    stop = next((k for k, (a, b) in enumerate(zip(j_hist, t_hist))
                 if a[0] != b[0]), None)
    if stop is not None:
        for rid, j_gen in j_hist[stop][0].items():
            t_gen = t_hist[stop][0][rid]
            if j_gen != t_gen:
                i = next(n for n, (x, y) in enumerate(zip(j_gen, t_gen))
                         if x != y)
                prefix = np.concatenate([j_reqs[rid].tokens, j_gen[:i]])
                assert _near_tie(_jax_next_logits(jcfg, params, prefix)), (
                    f"rid {rid} token {i}: {j_gen[i]} vs {t_gen[i]} is no "
                    "near tie")
    else:
        assert len(j_hist) == len(t_hist)
        assert sorted(r.rid for r in j_reqs if r.done) == \
            sorted(r.rid for r in t_reqs if r.done) == [0, 1, 2]
        for a, b in zip(j_reqs, t_reqs):
            assert list(a.generated) == list(b.generated), a.rid
    last = len(t_hist) if stop is None else stop + 1
    for k in range(last):
        np.testing.assert_allclose(t_hist[k][1], j_hist[k][1], rtol=1e-6,
                                   atol=1e-6, err_msg=f"iteration {k}")
    j_plans = [p for p in j_plans if p[0] <= last]
    t_plans = [p for p in t_plans if p[0] <= last]
    assert len(t_plans) == len(j_plans) >= 2
    for (ij, pj), (it, pt) in zip(j_plans, t_plans):
        assert ij == it
        for f in PLAN_FIELDS:
            np.testing.assert_array_equal(pt[f], pj[f], err_msg=f"{f} @ {it}")
    # the comparison means something: the plans replicate experts
    assert sum(int((p["n_replicas"] - 1).sum()) for _, p in t_plans) > 0
    assert t_eng.metrics.summary()["replicated_replans"] >= 1


def test_teacher_forced_rerun_reproduces_engine_steps(served):
    """The near-tie re-run recomputes the engine's first token of each
    request, so it really re-runs the step in question."""
    jcfg, params, (j_reqs, _, _, _), _, _ = served
    for r in j_reqs:
        logits = _jax_next_logits(jcfg, params, r.tokens)
        assert int(np.argmax(logits)) == r.generated[0]


def test_engine_on_cpu_uses_the_plain_version(served):
    *_, (_, _, _, eng), launches = served
    assert eng.device.type == "cpu"
    assert eng.decode_steps > 0 and launches == 0
    s = eng.metrics.summary()
    assert s["completed"] == 3 and s["replans"] >= 2


# --------------------------------------------------------------------------
# the port stands alone
# --------------------------------------------------------------------------

def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    walked = {f.relative_to(ROOT).as_posix() for f in files}
    assert {f"src/repro_torch/{m}.py" for m in (
        "models/griffin", "launch/serve", "data/synthetic", "kernels/rg_lru",
        "serve/engine", "serve/scheduler", "runtime/store", "runtime/migrate",
        "runtime/diff", "runtime/cost", "core/balance", "core/gps",
        "core/simulator", "obs/audit", "serve/controller",
        "workloads/traces", "optim/adamw", "optim/schedules",
        "core/predictors", "schedule/base", "schedule/greedy",
        "schedule/lp", "roofline", "moe/profile", "fleet/budget",
        "fleet/admission", "fleet/arbiter", "fleet/engine",
        "workloads/catalog", "sweep/job", "sweep/runner", "sweep/k8s",
        "sweep/__main__", "launch/mesh", "sharding")} <= walked
    bad = [(f.relative_to(ROOT).as_posix(), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_sweep_jobs_run_the_ports_job(monkeypatch):
    """The runner's subprocess and the k8s container run
    ``repro_torch.sweep.job``, never the JAX package's job."""
    from repro_torch.sweep import k8s, runner
    from repro_torch.sweep.matrix import SMOKE_SPEC

    point = SMOKE_SPEC.expand()[0]
    seen = []

    def fake_run(cmd, **kw):
        seen.append((cmd, kw["env"]))
        raise OSError("not run")
    monkeypatch.setattr(runner.subprocess, "run", fake_run)
    doc = runner.run_job(point, smoke=True, device="cpu", verbose=False)
    assert not doc["ok"] and "not run" in doc["error"]
    (cmd, env), = seen
    assert cmd[1:3] == ["-m", "repro_torch.sweep.job"]
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert "XLA_FLAGS" not in env or env["XLA_FLAGS"] == os.environ.get(
        "XLA_FLAGS")
    assert env["PYTHONPATH"].split(os.pathsep)[0] == str(ROOT / "src")
    container = k8s.job_manifest(point, image="repro:ci")[
        "spec"]["template"]["spec"]["containers"][0]
    assert container["command"] == ["python", "-m", "repro_torch.sweep.job"]


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card_or_the_repo(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    script = ROOT / "chip_smoke.py"
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_near_tie_rule():
    # the bf16 ulp of 3.0 is 2**-6: two ulps are 0.03125
    assert _near_tie(np.asarray([1.0, 3.0, 2.98]))
    assert not _near_tie(np.asarray([1.0, 3.0, 2.9]))
