"""The port's sweep job, runner and CLI (``repro_torch.sweep``) on the CPU.

* Job parity: ``run_point(..., device="cpu")`` on reduced Mixtral, mesh
  1x4, trace ``skew_shift``, smoke tier, for ``dist_only``,
  ``token_to_expert`` and ``reschedule``, each held against the JAX
  ``repro.sweep.job.run_point`` on the same point. The JAX legs run in one
  subprocess with four host devices and
  ``--xla_allow_excess_precision=false``; there ``make_dev_mesh`` builds an
  ``AxisType.Auto`` mesh (the JAX job's ``jax.make_mesh`` gives
  ``Explicit`` axes, which the JAX model's sharding constraints refuse) and
  ``init_model`` returns the JAX init's weights with wide router and
  ``lm_head`` margins (``tests/_torch_margins.py``; the experts in bf16),
  the same tree the port's job gets through ``bridge.params_from_jax``, so
  no route or token sits near a tie and every leg runs to the end of its
  trace. ``TIME_SCALE`` makes every request arrive before the second
  step, so admission does not depend on either host's speed. The counts
  and migration counters are equal, the modelled columns within 1e-6
  relative; the wall-clock columns only present and finite.
* Runner: ``run_sweep`` runs two points in subprocesses with ``--device
  cpu``: the report document, one history line per job and a merged trace
  that ``obs.validate_chrome_trace`` accepts.
* CLI: ``run``, ``report``, ``manifests`` and ``collect`` end to end.
* No silent CPU: without a card the job raises unless asked for the CPU,
  and a data-axis point comes back ``ok: false`` with the refusal.
"""

import json
import math
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
from repro_torch.obs import validate_chrome_trace  # noqa: E402
from repro_torch.sweep import job, runner  # noqa: E402
from repro_torch.sweep.__main__ import main as sweep_main  # noqa: E402
from repro_torch.sweep.history import load_history  # noqa: E402
from repro_torch.sweep.matrix import MeshShape, SweepPoint  # noqa: E402
from tests._torch_margins import SOURCE as MARGINS_SOURCE  # noqa: E402
from tests._torch_margins import widen_margins  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LEGS = ("dist_only", "token_to_expert", "reschedule")
MAX_ITERS = 200                    # every leg drains in 16 steps
TIME_SCALE = 1e7                   # a step of >= 1 us moves the clock >= 10 s
EQUAL = ("steps", "submitted", "completed", "preemptions", "drained_ok",
         "dropped_tokens", "overflow_tokens", "resched_plans",
         "migration_replans", "migration_rejected", "migration_bytes_moved",
         "recompiled")
CLOSE = ("overflow_absorbed_frac", "resched_a2a_bytes", "migration_stall_us",
         "fused_vs_gather_speedup")
WALL = ("step_p50_ms", "step_p99_ms", "throughput_tok_s", "throughput_req_s",
        "ttft_p50", "ttft_p99", "tpot_mean", "tpot_p99", "latency_p50",
        "latency_p99", "decode_toks_per_s")
REL = 1e-6


def _point(strategy, mesh=MeshShape(1, 4)):
    return SweepPoint(arch="mixtral-8x7b", mesh=mesh, workload="skew_shift",
                      strategy=strategy)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced model's operations are tiny: one intra-op thread runs
    them as fast as many, and keeps this file from oversubscribing the
    cores when test workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def job_env(monkeypatch):
    """Job subprocesses inherit one intra-op thread."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


SUB = '''
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_allow_excess_precision=false")
import json
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
import repro.launch.mesh as jmesh
import repro.models.transformer as jtransformer
from repro.sweep.job import run_point
from repro.sweep.matrix import SweepPoint

exec(os.environ["SW_MARGINS"])
real_init = jtransformer.init_model

def wide_init(key, cfg):
    tree = jax.tree.map(jnp.asarray, widen_margins(
        jax.tree.map(np.asarray, real_init(key, cfg)), cfg))
    tree["layers"]["moe"]["experts"] = jax.tree.map(
        lambda w: w.astype(jnp.bfloat16), tree["layers"]["moe"]["experts"])
    return tree

def auto_mesh(data, model):
    return jax.make_mesh((data, model), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))

jtransformer.init_model = wide_init
jmesh.make_dev_mesh = auto_mesh
docs = {}
for point in json.loads(os.environ["SW_POINTS"]):
    doc = run_point(SweepPoint.from_obj(point), smoke=True,
                    max_iters=int(os.environ["SW_MAX_ITERS"]),
                    time_scale=float(os.environ["SW_TIME_SCALE"]))
    docs[point["strategy"]] = doc
with open(sys.argv[1], "w") as f:
    json.dump(docs, f)
'''


@pytest.fixture(scope="module")
def jax_docs(tmp_path_factory):
    out = tmp_path_factory.mktemp("sweep_job") / "jax_docs.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               SW_MARGINS=MARGINS_SOURCE,
               SW_POINTS=json.dumps([_point(s).to_obj() for s in LEGS]),
               SW_MAX_ITERS=str(MAX_ITERS), SW_TIME_SCALE=repr(TIME_SCALE))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB),
                           str(out)], capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def wide():
    """The JAX init's reduced-Mixtral weights (numpy), margins widened."""
    base = jax_get_config("mixtral-8x7b").reduced()
    return widen_margins(jax.tree.map(np.asarray, jax_init_model(
        jax.random.PRNGKey(0), base)), base)


@pytest.mark.parametrize("strategy", LEGS)
def test_job_matches_the_jax_job(jax_docs, wide, strategy, monkeypatch):
    monkeypatch.setattr(job, "init_model", lambda cfg, generator, device:
                        params_from_jax(wide, cfg, device=device))
    doc = job.run_point(_point(strategy), smoke=True, max_iters=MAX_ITERS,
                        time_scale=TIME_SCALE, device="cpu")
    ref = jax_docs[strategy]
    assert doc["ok"] and ref["ok"]
    assert doc["kind"] == ref["kind"] == "sweep-job"
    assert doc["key"] == ref["key"]
    assert doc["config"] == {**ref["config"], "device": "cpu"}
    got, want = doc["metrics"], ref["metrics"]
    assert set(got) == set(want) == set(EQUAL + CLOSE + WALL)
    for k in EQUAL:
        assert got[k] == want[k], (k, got[k], want[k])
    for k in CLOSE:
        assert math.isclose(got[k], want[k], rel_tol=REL, abs_tol=0.0), \
            (k, got[k], want[k])
    for k in WALL:
        assert math.isfinite(got[k]) and got[k] >= 0, (k, got[k])
    assert got["drained_ok"] == 1.0 and got["completed"] == got["submitted"]
    assert got["recompiled"] == 0.0
    if strategy == "reschedule":
        assert got["resched_plans"] > 0
    else:
        assert got["migration_replans"] > 0
    if strategy == "token_to_expert":
        # the store fills: on these weights dist_only's re-plans keep the
        # plan in force (0 bytes in both packages), this leg's move weights
        assert got["migration_bytes_moved"] > 0 and got["dropped_tokens"] > 0


def test_runner_runs_points_in_subprocesses(tmp_path, job_env):
    points = [_point("dist_only"), _point("reschedule")]
    out, hist = tmp_path / "report.json", tmp_path / "history.jsonl"
    merged = tmp_path / "merged.json"
    report = runner.run_sweep(points, smoke=True, out_path=str(out),
                              history_path=str(hist),
                              trace_dir=str(tmp_path / "traces"),
                              merged_trace_path=str(merged), max_iters=4,
                              device="cpu", verbose=False)
    assert json.loads(out.read_text()) == report
    assert report["kind"] == "sweep" and report["points"] == 2
    assert list(report["jobs"]) == [p.key for p in points]
    for p in points:
        doc = report["jobs"][p.key]
        assert "error" not in doc, doc
        assert doc["config"]["device"] == "cpu"
        assert doc["metrics"]["steps"] == 4.0
        assert doc["config"]["max_iters"] == 4
    # 4 iterations do not drain the trace: both jobs report not ok
    assert report["failed"] == 2
    lines = load_history(str(hist))
    assert [e["key"] for e in lines] == [p.key for p in points]
    assert all(e["kind"] == "sweep" and e["metrics"] for e in lines)
    trace = json.loads(merged.read_text())
    assert validate_chrome_trace(trace) == []
    assert trace["otherData"]["sweep_meta"] == report["meta"]
    names = {e["name"] for e in trace["traceEvents"]}
    assert "step" in names


def test_cli_end_to_end(tmp_path, job_env, capsys):
    hist = tmp_path / "history.jsonl"
    rc = sweep_main(["run", "--smoke", "--mesh", "1x4",
                     "--workload", "skew_shift", "--strategy", "dist_only",
                     "--device", "cpu", "--max-iters", str(MAX_ITERS),
                     "--out", str(tmp_path / "report.json"),
                     "--history", str(hist)])
    assert rc == 0, capsys.readouterr().out
    report = json.loads((tmp_path / "report.json").read_text())
    key = _point("dist_only").key
    assert list(report["jobs"]) == [key] and report["jobs"][key]["ok"]

    # the job document, as a cluster pod would write it, and a torn one
    results = tmp_path / "results"
    results.mkdir()
    (results / "a.json").write_text(json.dumps(report["jobs"][key]))
    (results / "torn.json").write_text('{"kind": "sweep-job", "ke')
    fresh = tmp_path / "collected.jsonl"
    assert sweep_main(["collect", "--dir", str(results),
                       "--history", str(fresh)]) == 0
    assert "collected 1/2 docs (0 duplicate, 1 torn, 0 non-job)" in \
        capsys.readouterr().out
    assert [e["key"] for e in load_history(str(fresh))] == [key]

    md = tmp_path / "trend.md"
    assert sweep_main(["report", "--history", str(hist),
                       "--out", str(md)]) == 0
    text = md.read_text()
    assert f"| sweep | completed | {key} | 1 |" in text
    assert f"| sweep | ok | {key} | 1 | 1 |" in text

    mdir = tmp_path / "k8s"
    assert sweep_main(["manifests", "--out-dir", str(mdir), "--smoke",
                       "--mesh", "1x4"]) == 0
    assert len(list(mdir.iterdir())) == 9          # 3 workloads x 3 levers


def test_report_and_collect_need_a_history(capsys):
    for argv in (["report"], ["collect", "--dir", "."]):
        with pytest.raises(SystemExit):
            sweep_main(argv)
    assert "--history" in capsys.readouterr().err


def test_no_silent_cpu(tmp_path, job_env):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    point = _point("dist_only")
    with pytest.raises(RuntimeError, match="cuda"):
        job.run_point(point)
    with pytest.raises(RuntimeError, match="cuda"):
        job.main(["--point", json.dumps(point.to_obj()), "--smoke"])
    doc = runner.run_job(point, smoke=True, max_iters=2, verbose=False)
    assert not doc["ok"] and "torch.cuda.is_available() is False" in \
        doc["error"]
    assert sweep_main(["run", "--smoke", "--mesh", "1x4", "--workload",
                       "steady", "--strategy", "dist_only", "--max-iters",
                       "2", "--out", str(tmp_path / "r.json")]) == 1


def test_a_data_axis_is_refused(job_env):
    point = _point("dist_only", MeshShape(2, 4))
    with pytest.raises(ValueError, match="one device has no data axis"):
        job.run_point(point, device="cpu")
    doc = runner.run_job(point, smoke=True, max_iters=2, device="cpu",
                         verbose=False)
    assert not doc["ok"] and doc["metrics"] == {}
    assert "one device has no data axis" in doc["error"]
    assert "ROADMAP.md section 1, item 4" in doc["error"]
