"""The port's sweep host modules (``repro_torch.sweep``: matrix, history,
references, report, k8s, collect) against the JAX package's
``repro.sweep`` on the same inputs.

* matrix: ``SMOKE_SPEC`` / ``FULL_SPEC`` expand to the same keys and
  ``to_obj()`` in the same order; ``parse_mesh``, ``from_obj`` and
  ``restrict`` agree, bad inputs raising the same errors.
* history: ``series``, ``trend``, both entry builders and ``load_history``
  give equal results on one fixed set of entries (legacy lines with no
  ``kind``, torn lines, drifting series).
* references: ``classify_metric`` over every metric name of both jobs'
  ``SUMMARY_METRICS``, the job documents' own columns and the names of
  ``tests/test_sweep.py``; ``bounds``, ``check_metric``, ``gate_document``
  and ``refresh_references`` on the same documents (zero references,
  malformed tuples, a missing bench, an empty document).
* report: the same text from the same history and references, except the
  empty-history line, which names the port's CLI.
* k8s: ``manifest_name`` on every ``FULL_SPEC`` point; each pair of
  manifests equal but for the container's command, ``--device`` in its
  args, its env and its resources (pinned); ``validate_manifest`` on the
  same broken manifests.
* collect: one directory of job documents (good, torn, non-job, already
  in the history, the same key twice in one batch) gives the same
  ``CollectReport`` lists and history lines.
"""

import copy
import json
import math

import pytest

torch = pytest.importorskip("torch")
from repro import sweep as jsweep  # noqa: E402
from repro.sweep import collect as jcollect  # noqa: E402
from repro.sweep import history as jhistory  # noqa: E402
from repro.sweep import k8s as jk8s  # noqa: E402
from repro.sweep import matrix as jmatrix  # noqa: E402
from repro.sweep import references as jrefs  # noqa: E402
from repro.sweep import report as jreport  # noqa: E402
from repro_torch import sweep as tsweep  # noqa: E402
from repro_torch.sweep import collect as tcollect  # noqa: E402
from repro_torch.sweep import history as thistory  # noqa: E402
from repro_torch.sweep import k8s as tk8s  # noqa: E402
from repro_torch.sweep import matrix as tmatrix  # noqa: E402
from repro_torch.sweep import references as trefs  # noqa: E402
from repro_torch.sweep import report as treport  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as in every port test file: workers run side
    by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(fn_name, jmod, tmod, *args, **kwargs):
    """(JAX result, port result); an exception is a result, as its type
    and message."""
    out = []
    for mod in (jmod, tmod):
        try:
            out.append(getattr(mod, fn_name)(*args, **kwargs))
        except Exception as e:       # noqa: BLE001 - compared, not hidden
            out.append((type(e).__name__, str(e)))
    return out


def same(a, b) -> bool:
    """Equality with NaN equal to NaN (``trend`` of an empty window)."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return a == b


def test_exported_names_are_the_jax_packages():
    assert tsweep.__all__ == jsweep.__all__
    assert all(hasattr(tsweep, n) for n in tsweep.__all__)


# ---------------------------------------------------------------------------
# matrix
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("spec", ["SMOKE_SPEC", "FULL_SPEC"])
def test_specs_expand_to_the_same_points(spec):
    jp = getattr(jmatrix, spec).expand()
    tp = getattr(tmatrix, spec).expand()
    assert [p.key for p in tp] == [p.key for p in jp]
    assert [p.to_obj() for p in tp] == [p.to_obj() for p in jp]
    for p in tp:
        assert tmatrix.SweepPoint.from_obj(p.to_obj()) == p
    assert tmatrix.LEVER_STRATEGIES == jmatrix.LEVER_STRATEGIES


@pytest.mark.parametrize("text", ["2x4", "1X4", "1x1", "16x2", "0x4", "2x0",
                                  "-1x2", "2x", "x4", "abc", "2x4x1", "",
                                  " 2x4"])
def test_parse_mesh_agrees(text):
    j, t = both("parse_mesh", jmatrix, tmatrix, text)
    if isinstance(j, tuple):
        assert t == j
    else:
        assert (t.data, t.model, t.devices, t.key) == \
            (j.data, j.model, j.devices, j.key)


@pytest.mark.parametrize("obj", [
    {"arch": "a", "mesh": "2x4", "workload": "w", "strategy": "s"},
    {"arch": "a", "mesh": "1x8", "workload": "w", "strategy": "s",
     "seed": "3", "reduced": 0},
    {"arch": "a", "mesh": "1-8", "workload": "w", "strategy": "s"},
    {"arch": "a", "workload": "w", "strategy": "s"},
])
def test_point_from_obj_agrees(obj):
    j = t = None
    try:
        j = jmatrix.SweepPoint.from_obj(obj).to_obj()
    except Exception as e:           # noqa: BLE001
        j = (type(e).__name__, str(e))
    try:
        t = tmatrix.SweepPoint.from_obj(obj).to_obj()
    except Exception as e:           # noqa: BLE001
        t = (type(e).__name__, str(e))
    assert t == j


@pytest.mark.parametrize("spec,kw", [
    ("SMOKE_SPEC", dict(meshes=["1x4"])),
    ("SMOKE_SPEC", dict(workloads=["steady"], strategies=["both"])),
    ("FULL_SPEC", dict(meshes=["2x8", "1x4"], archs=["mixtral-8x7b"])),
    ("FULL_SPEC", dict(strategies=["token_to_expert"])),
    ("SMOKE_SPEC", dict(meshes=["4x4"])),
    ("SMOKE_SPEC", dict(strategies=["token_to_expert"])),
    ("FULL_SPEC", dict(workloads=["stedy"])),
    ("FULL_SPEC", dict(archs=["llama-moe-3.5b"])),
    ("FULL_SPEC", dict()),
])
def test_restrict_agrees(spec, kw):
    out = []
    for mod in (jmatrix, tmatrix):
        args = dict(kw)
        if "meshes" in args:
            args["meshes"] = [mod.parse_mesh(m) for m in args["meshes"]]
        try:
            out.append([p.to_obj() for p in
                        getattr(mod, spec).restrict(**args).expand()])
        except ValueError as e:
            out.append(("ValueError", str(e)))
    assert out[1] == out[0]


# ---------------------------------------------------------------------------
# history
# ---------------------------------------------------------------------------
BENCH_DOC = {"smoke": True, "total_wall_s": 5.0,
             "meta": {"git_sha": "abc", "timestamp_utc": "t"},
             "benches": {"b": {"wall_us": 1.0, "ok": True,
                               "summary": {"m": 2.0}, "derived": "ignored"},
                         "c": {"ok": 0, "summary": None}}}
JOB_DOC = {"schema": 1, "kind": "sweep-job", "key": "k",
           "config": {"smoke": True, "device": "cuda"}, "ok": True,
           "wall_s": 2.0, "metrics": {"m": 1.0, "drained_ok": 1.0}}
ENTRIES = [
    # legacy: no kind, read as a bench line
    {"git_sha": "x", "timestamp_utc": "t0", "smoke": True,
     "total_wall_s": 90.0, "benches": {"b": {"wall_us": 1.0, "ok": True}}},
    {"kind": "bench", "timestamp_utc": "t1", "total_wall_s": 10.0,
     "benches": {"b": {"wall_us": 5.0, "ok": True,
                       "summary": {"speedup": 2.0, "flag": False,
                                   "name": "text", "n": 3}}}},
    {"kind": "sweep", "timestamp_utc": "t2", "key": "a@1x4/w/s/s0",
     "ok": True, "wall_s": 3.0, "metrics": {"step_p50_ms": 9.0}},
    {"kind": "sweep", "timestamp_utc": "t3", "key": "a@1x4/w/s/s0",
     "ok": False, "wall_s": 3.5, "metrics": None},
    {"kind": "sweep", "key": "b@2x4/w/s/s0", "ok": True},
] + [{"kind": "sweep", "timestamp_utc": f"d{i}", "key": "drift", "ok": True,
      "wall_s": 1.0 + 0.2 * i, "metrics": {"step_p50_ms": 10.0 - i}}
     for i in range(6)]


def _history_file(path):
    text = "".join(json.dumps(e) + "\n" for e in ENTRIES[:3])
    text += "\n   \n{\"torn\": \n"
    text += "".join(json.dumps(e) + "\n" for e in ENTRIES[3:])
    text += '{"kind": "sweep", "key": "cut'
    path.write_text(text)
    return str(path)


def test_history_constants_agree():
    assert (thistory.DRIFT_REL, thistory.DRIFT_MIN_POINTS) == \
        (jhistory.DRIFT_REL, jhistory.DRIFT_MIN_POINTS)


def test_load_history_and_series_agree(tmp_path):
    path = _history_file(tmp_path / "h.jsonl")
    j, t = both("load_history", jhistory, thistory, path)
    assert t == j == ENTRIES
    assert both("load_history", jhistory, thistory,
                str(tmp_path / "missing.jsonl")) == [[], []]
    j, t = both("series", jhistory, thistory, ENTRIES)
    assert t == j
    assert ("b", "wall_us", "default") in t       # the legacy line
    assert t[("sweep", "ok", "a@1x4/w/s/s0")] == [("t2", 1.0), ("t3", 0.0)]


@pytest.mark.parametrize("values", [
    [], [1.0], [1.0, 2.0], [1.0, 1.1, 1.2, 1.3, 1.5], [1.0, 1.4, 0.9, 1.3, 1.0],
    [1.0, 1.01, 1.02, 1.03], [0.0, 0.0, 0.5, 0.9, 2.0], [5.0, 4.0, 3.0, 2.0],
    [float(i) for i in range(20)], [2.0, 2.0, 2.0, 2.0],
])
@pytest.mark.parametrize("last_n", [8, 4])
def test_trend_agrees(values, last_n):
    j, t = both("trend", jhistory, thistory, values, last_n)
    assert same(t, j)


@pytest.mark.parametrize("doc", [BENCH_DOC, {}, {"benches": {}},
                                 {"meta": {"git_sha": "s"}, "smoke": 1}])
def test_bench_history_entry_agrees(doc):
    j, t = both("bench_history_entry", jhistory, thistory, doc)
    assert t == j


@pytest.mark.parametrize("doc,meta", [
    (JOB_DOC, {"git_sha": "abc", "timestamp_utc": "t"}),
    (JOB_DOC, {}),
    ({"key": "k2"}, {"git_sha": "s"}),
    ({"ok": True}, {}),                      # no key: both raise KeyError
])
def test_sweep_history_entry_agrees(doc, meta):
    j, t = both("sweep_history_entry", jhistory, thistory, doc, meta)
    assert t == j


def test_append_entry_agrees(tmp_path):
    for mod, name in ((jhistory, "j"), (thistory, "t")):
        path = str(tmp_path / name / "deep" / "h.jsonl")
        for e in ENTRIES:
            mod.append_entry(path, e)
    assert (tmp_path / "t" / "deep" / "h.jsonl").read_text() == \
        (tmp_path / "j" / "deep" / "h.jsonl").read_text()


# ---------------------------------------------------------------------------
# references
# ---------------------------------------------------------------------------
def _metric_names():
    from repro.sweep import job as jjob
    from repro_torch.sweep import job as tjob
    names = set(jjob.SUMMARY_METRICS) | set(tjob.SUMMARY_METRICS)
    names |= {"step_p50_ms", "step_p99_ms", "steps", "submitted",
              "recompiled", "drained_ok", "ok", "wall_us", "total_wall_s",
              "wall_s"}
    # the names of tests/test_sweep.py and the rules' own examples
    names |= {"store_ok", "m", "pack_speedup", "store_speedup", "speedup",
              "hidden_fraction", "pred_dist_hit_rate", "pred_t2e_hit_rate",
              "throughput_x", "fleet_slo_attainment", "fleet_worst_attainment",
              "fleet_arbiter_moves", "fleet_recompiled", "fleet_step_p50_ms",
              "resched_dropped_tokens", "attn_phase_decode_us",
              "attn_fused_us", "attn_gather_us", "decode_ab_ratio",
              "bitexact_logits", "x_recompiled", "unknown_metric"}
    return sorted(names)


def test_rules_agree():
    assert trefs.TOLERANCE_RULES == jrefs.TOLERANCE_RULES
    assert trefs.TOTAL_WALL_TOL == jrefs.TOTAL_WALL_TOL


@pytest.mark.parametrize("name", _metric_names())
def test_classify_metric_agrees(name):
    j, t = both("classify_metric", jrefs, trefs, name)
    assert t == j


@pytest.mark.parametrize("ref,lo,hi", [
    (10.0, 0.5, None), (10.0, None, 1.5), (-4.0, 0.2, 0.2), (0.0, 0.0, 0.0),
    (0.0, 2.0, None), (3, None, None)])
def test_bounds_agree(ref, lo, hi):
    assert both("bounds", jrefs, trefs, ref, lo, hi)[1] == \
        jrefs.bounds(ref, lo, hi)


CHECKS = [
    (5.0, [5.0, 0.1, 0.1]), (4.4, [5.0, 0.1, 0.1]), (5.6, [5.0, 0.1, 0.1]),
    (0.2, [0.0, 0.0, 0.0]), (0.0, [0.0, 0.0, 0.0]), (0.5, [0.0, None, 1.0]),
    (1e9, [5.0, 0.5, None]), (-1.0, [5.0, None, 1.5]), (None, [5.0, 0.1, 0.1]),
    ("fast", [5.0, 0.1, 0.1]), (True, [1.0, 0.0, 0.0]), (3, (3, 0.0, 0.0)),
    (1.0, [1.0, 0.1]), (1.0, ["1.0", 0.1, 0.1]), (1.0, [True, 0.1, 0.1]),
    (1.0, None), (1.0, 7.0), (1.0, {"ref": 1.0}),
]


@pytest.mark.parametrize("value,ref", CHECKS)
def test_check_metric_agrees(value, ref):
    j, t = both("check_metric", jrefs, trefs, "bench.metric", value, ref)
    assert t == j


DOC = {"total_wall_s": 50.0, "meta": {"git_sha": "abc"},
       "benches": {"b": {"wall_us": 1e6, "ok": True,
                         "summary": {"pack_speedup": 1.9, "noisy": 3.0,
                                     "store_ok": 1.0, "flag": True,
                                     "resched_dropped_tokens": 0.0}},
                   "c": {"wall_us": "n/a", "ok": False, "summary": None}}}
REFS = {"total_wall_s": [40.0, None, 0.5],
        "benches": {"b": {"ok": [1.0, 0.0, 0.0], "wall_us": [1e6, None, 1.0],
                          "pack_speedup": [2.0, 0.5, None],
                          "store_ok": [1.0, 0.0, 0.0],
                          "resched_dropped_tokens": [0.0, 0.0, 0.0],
                          "missing_metric": [1.0, 0.1, 0.1],
                          "bad": [1.0, 0.1]},
                    "gone": {"m": [1.0, 0.1, 0.1], "n": [2.0, 0.1, 0.1]}}}
GATES = [
    (DOC, REFS), (DOC, {}), (DOC, {"benches": {}}),
    ({"benches": {}}, REFS), ({}, {}), ("not a doc", {}),
    (dict(DOC, total_wall_s=0), {"total_wall_s": [40.0, None, 0.5]}),
    (dict(DOC, total_wall_s=100.0), REFS),
    ({"total_wall_s": 1.0, "benches": {"b": {"ok": False}}},
     {"benches": {"b": {"ok": [1.0, 0.0, 0.0]}}}),
]


@pytest.mark.parametrize("doc,refs", GATES)
def test_gate_document_agrees(doc, refs):
    j, t = both("gate_document", jrefs, trefs, doc, refs)
    assert t == j


@pytest.mark.parametrize("doc,meta", [
    (DOC, None), (DOC, {"git_sha": "override"}), ({"benches": {}}, None),
    ({"total_wall_s": 3.0}, None), ({}, None),
    ({"total_wall_s": 2.0, "benches": {"x": {"ok": True}}}, None),
])
def test_refresh_references_agrees(doc, meta):
    j, t = both("refresh_references", jrefs, trefs, copy.deepcopy(doc),
                meta=meta)
    assert t == j
    if isinstance(t, dict):
        # a refreshed document gates its own measurement clean
        assert trefs.gate_document(doc, t) == jrefs.gate_document(doc, t)


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("values", [[], [1.0], [1.0, 1.0], [0.0, 0.5, 1.0],
                                    [float(i % 5) for i in range(30)],
                                    [3.0, -2.0, 7.5, 1e9]])
def test_sparkline_agrees(values):
    assert treport.sparkline(values) == jreport.sparkline(values)
    assert treport.sparkline(values, 4) == jreport.sparkline(values, 4)


@pytest.mark.parametrize("refs", [None, {}, REFS,
                                  {"benches": {"b": {"m": [1.0, 0.5, None]}},
                                   "total_wall_s": [80.0, None, 0.5]}])
@pytest.mark.parametrize("benches", [None, ["b", "sweep"], []])
def test_trend_table_agrees(refs, benches):
    smap = jhistory.series(ENTRIES)
    for last_n in (8, 3):
        assert treport.trend_table(smap, last_n=last_n, refs=refs,
                                   benches=benches) == \
            jreport.trend_table(smap, last_n=last_n, refs=refs,
                                benches=benches)


def test_drift_warnings_agree():
    smap = jhistory.series(ENTRIES)
    smap[("b", "m", "c")] = [("t", v) for v in [1.0, 1.2, 1.4, 1.6, 1.8]]
    warns = treport.drift_warnings(smap)
    assert warns == jreport.drift_warnings(smap)
    assert len(warns) >= 2
    assert treport.drift_warnings(smap, last_n=3) == \
        jreport.drift_warnings(smap, last_n=3)


def test_render_report_agrees(tmp_path):
    hist = _history_file(tmp_path / "h.jsonl")
    refs = tmp_path / "refs.json"
    refs.write_text(json.dumps(REFS))
    for kw in (dict(), dict(last_n=3, title="Nightly")):
        assert treport.render_report(hist, str(refs), **kw) == \
            jreport.render_report(hist, str(refs), **kw)
        assert treport.render_report(hist, **kw) == \
            jreport.render_report(hist, **kw)
        assert treport.render_report(hist, str(tmp_path / "none.json"),
                                     **kw) == \
            jreport.render_report(hist, str(tmp_path / "none.json"), **kw)


def test_empty_history_line_names_the_ports_cli(tmp_path):
    empty = str(tmp_path / "empty.jsonl")
    t = treport.render_report(empty).splitlines()
    j = jreport.render_report(empty).splitlines()
    assert t[:-1] == j[:-1]
    assert "benchmarks/run.py" in j[-1]
    assert t[-1] == ("_history is empty — run a sweep with "
                     "`python -m repro_torch.sweep run --history FILE` "
                     "first_")


# ---------------------------------------------------------------------------
# k8s
# ---------------------------------------------------------------------------
FULL_POINTS = jmatrix.FULL_SPEC.expand()


def test_manifest_names_agree():
    for jp in FULL_POINTS + (
            jmatrix.SweepPoint("a" * 80, jmatrix.MeshShape(1, 1), "w", "s"),
            jmatrix.SweepPoint("Mixtral_8x7B", jmatrix.MeshShape(2, 4),
                               "w--x", "S", seed=12)):
        tp = tmatrix.SweepPoint.from_obj(jp.to_obj())
        assert tk8s.manifest_name(tp) == jk8s.manifest_name(jp)
        assert tk8s.manifest_name(tp, "nightly") == \
            jk8s.manifest_name(jp, "nightly")


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("i", range(0, len(FULL_POINTS), 13))
def test_manifests_differ_only_in_the_container_runtime(i, smoke):
    jp = FULL_POINTS[i]
    tp = tmatrix.SweepPoint.from_obj(jp.to_obj())
    kw = dict(image="repro:ci", namespace="sweeps", smoke=smoke, cpu="8",
              memory="32Gi", backoff_limit=1)
    jm, tm = jk8s.job_manifest(jp, **kw), tk8s.job_manifest(tp, **kw)
    assert tk8s.validate_manifest(tm) == []
    jc = jm["spec"]["template"]["spec"]["containers"][0]
    tc = tm["spec"]["template"]["spec"]["containers"][0]
    # the whole difference, pinned
    assert jc["command"] == ["python", "-m", "repro.sweep.job"]
    assert tc["command"] == ["python", "-m", "repro_torch.sweep.job"]
    assert tc["args"] == jc["args"] + ["--device", "cuda"]
    assert jc["env"] == [
        {"name": "XLA_FLAGS", "value": "--xla_force_host_platform_device_"
                                       f"count={jp.mesh.devices}"},
        {"name": "PYTHONPATH", "value": "/app/src"}]
    assert tc["env"] == [{"name": "PYTHONPATH", "value": "/app/src"}]
    assert jc["resources"] == {"requests": {"cpu": "8", "memory": "32Gi"},
                               "limits": {"cpu": "8", "memory": "32Gi"}}
    assert tc["resources"] == {
        "requests": {"cpu": "8", "memory": "32Gi"},
        "limits": {"cpu": "8", "memory": "32Gi", "nvidia.com/gpu": "1"}}
    for c in (jc, tc):
        for k in ("command", "args", "env", "resources"):
            c.pop(k)
    assert tm == jm


def _broken_manifests():
    base = jk8s.job_manifest(FULL_POINTS[0], image="repro:ci")
    out = []

    def edit(fn):
        m = copy.deepcopy(base)
        fn(m)
        out.append(m)
    edit(lambda m: m.update(kind="Deployment"))
    edit(lambda m: m.update(apiVersion="v1"))
    edit(lambda m: m["metadata"].update(name="Bad_Name!"))
    edit(lambda m: m["metadata"].update(name="a" * 64))
    edit(lambda m: m["metadata"].pop("name"))
    edit(lambda m: m["spec"]["template"]["spec"].update(
        restartPolicy="Always"))
    edit(lambda m: m["spec"]["template"]["spec"].update(containers=[]))
    edit(lambda m: m["spec"]["template"]["spec"]["containers"][0].pop(
        "image"))
    edit(lambda m: m["spec"]["template"]["spec"]["containers"].append(
        {"name": "side"}))
    edit(lambda m: m.pop("spec"))
    out += [{}, {"metadata": None, "spec": {"template": None}}]
    return out


@pytest.mark.parametrize("manifest", _broken_manifests())
def test_validate_manifest_agrees(manifest):
    j, t = both("validate_manifest", jk8s, tk8s, manifest)
    assert t == j and t


def test_write_manifests_agree(tmp_path):
    jpaths = jk8s.write_manifests(jmatrix.SMOKE_SPEC.expand(),
                                  str(tmp_path / "j"), image="repro:ci")
    tpaths = tk8s.write_manifests(tmatrix.SMOKE_SPEC.expand(),
                                  str(tmp_path / "t"), image="repro:ci")
    assert [p.split("/")[-1] for p in tpaths] == \
        [p.split("/")[-1] for p in jpaths]
    for p in tpaths:
        text = open(p).read()
        assert "repro_torch.sweep.job" in text and "nvidia.com/gpu" in text


# ---------------------------------------------------------------------------
# collect
# ---------------------------------------------------------------------------
def _job_doc(key, *, ok=True, sha=None):
    doc = {"schema": 1, "kind": "sweep-job", "key": key,
           "config": {"smoke": True}, "ok": ok, "wall_s": 1.5,
           "metrics": {"step_p50_ms": 10.0, "completed": 4.0}}
    if sha is not None:
        doc["meta"] = {"git_sha": sha, "timestamp_utc": "t0"}
    return doc


def test_collect_agrees(tmp_path):
    d = tmp_path / "results"
    d.mkdir()
    (d / "a.json").write_text(json.dumps(_job_doc("k-a")))
    (d / "a_retry.json").write_text(json.dumps(_job_doc("k-a", ok=False)))
    (d / "b.json").write_text(json.dumps(_job_doc("k-b", sha="doc-sha")))
    (d / "c.json").write_text(json.dumps(_job_doc("k-c")))   # in history
    (d / "torn.json").write_text('{"kind": "sweep-job", "key"')
    (d / "report.json").write_text(json.dumps({"kind": "sweep"}))
    (d / "nokey.json").write_text(json.dumps({"kind": "sweep-job"}))
    (d / "list.json").write_text("[1, 2]")
    (d / "notes.txt").write_text("not json")
    seeded = json.dumps({"kind": "sweep", "key": "k-c", "git_sha": "s1"})
    reports, lines = [], []
    for mod, name in ((jcollect, "j"), (tcollect, "t")):
        hist = tmp_path / f"{name}.jsonl"
        hist.write_text(seeded + "\n")
        rep = mod.collect_results(str(d), str(hist),
                                  meta={"git_sha": "s1",
                                        "timestamp_utc": "t9"})
        again = mod.collect_results(str(d), str(hist),
                                    meta={"git_sha": "s1"}, pattern="a*")
        reports.append([(r.appended, r.duplicates, r.torn, r.skipped,
                         r.total, r.summarize()) for r in (rep, again)])
        lines.append(hist.read_text())
    assert reports[1] == reports[0]
    assert lines[1] == lines[0]
    first = reports[1][0]
    assert [len(x) for x in first[:4]] == [2, 2, 1, 3]
