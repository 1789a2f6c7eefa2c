"""The dry run of the PyTorch port (``repro_torch.launch.{mesh, specs,
dryrun, report}``, the collective accounting of ``moe.dispatch`` and the
``meta`` branches of ``kernels.ops``), on the CPU.

* Shape parity with the JAX package. One JAX subprocess with 512 forced
  host devices builds ``repro.launch.specs``' abstract trees (nothing
  lowered) on ``AxisType.Auto`` meshes: every arch of the JAX package's
  ``ASSIGNED_ARCHS`` and Mixtral at every input shape on 16 x 16; olmo-1b
  and Mixtral on 2 x 16 x 16; without FSDP for qwen1.5-0.5b and
  arctic-480b; with expert TP for Mixtral's ``decode_32k``. Every
  parameter (through ``bridge.param_paths``), moment, cache leaf and
  input of the port's trees (``launch.specs``) has the per-rank shape and
  dtype of the JAX leaf's ``shard_shape``, and their bytes sum to the JAX
  shards' exactly. The cache the port's steps hold (``specs.port_cache``)
  equals that layout but where ``launch.specs`` says it does not.
* Dry against live. One (2, 2) ``gloo`` world runs a prefill, a decode
  step and a train step of reduced Mixtral (EP, "specs") and reduced
  qwen1.5-0.5b ("specs"), and an FSDP train step of qwen
  (``tests/_torch_dryrun.py``); on every rank the result bytes of its
  collectives, by kind and count, and its argument bytes equal
  ``trace_one``'s at the same rank of the same mesh. The CPU runs the
  kernels' plain versions, so FLOPs are not compared here.
* The depth extrapolation and the attention's block-count extrapolation
  equal whole traces; the tracer's FLOPs equal ``FlopCounterMode``'s.
* The CLI and the report; each kernel wrapper's ``meta`` outputs against
  its plain version's on the CPU; importing the mesh and the dry run
  initialises neither ``torch.distributed`` nor CUDA.
"""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.bridge import param_paths  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES, InputShape  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import placement  # noqa: E402
from repro_torch.kernels import ops, work  # noqa: E402
from repro_torch.launch import dryrun, report, specs  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.moe import dispatch  # noqa: E402
from tests import _torch_dryrun as legs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MIXTRAL = "mixtral-8x7b"
# (arch, shape, multi_pod, fsdp, expert_tp)
COMBOS = ([(a, s, False, True, False)
           for a in dryrun.ASSIGNED_ARCHS + [MIXTRAL] for s in INPUT_SHAPES]
          + [(a, s, True, True, False) for a in ("olmo-1b", MIXTRAL)
             for s in INPUT_SHAPES]
          + [(a, s, False, False, False)
             for a in ("qwen1.5-0.5b", "arctic-480b") for s in INPUT_SHAPES]
          + [(MIXTRAL, "decode_32k", False, True, True)])
# where the port's steps hold another cache than the reference's layout
# (``launch.specs``): GQA caches whose KV heads do not split 16 ways keep
# every position; RWKV's shift vectors stay whole over "model"
PORT_CACHE_DIFFERS = {"arctic-480b": ("k", "v"), "llava-next-34b": ("k", "v"),
                      "minicpm-2b": ("k", "v"), MIXTRAL: ("k", "v"),
                      "rwkv6-7b": ("shift_tm", "shift_cm")}

SUB = '''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import pickle
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType
from repro.configs.base import INPUT_SHAPES
from repro.configs.registry import get_config
from repro.launch import specs

with open(sys.argv[1], "rb") as f:
    combos = pickle.load(f)
meshes = {False: jax.make_mesh((16, 16), ("data", "model"),
                               axis_types=(AxisType.Auto,) * 2),
          True: jax.make_mesh((2, 16, 16), ("pod", "data", "model"),
                              axis_types=(AxisType.Auto,) * 3)}


def flat(tree):
    out = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", None)))
                        for k in kp)
        shape = tuple(leaf.sharding.shard_shape(leaf.shape))
        out[path] = (shape, str(leaf.dtype),
                     int(np.prod(shape)) * leaf.dtype.itemsize)
    return out


res = {}
for combo in combos:
    arch, shape_name, multi_pod, fsdp, expert_tp = combo
    cfg, shape, mesh = (get_config(arch), INPUT_SHAPES[shape_name],
                        meshes[multi_pod])
    rt = specs.runtime_for(cfg, mesh, shape, decode_expert_tp=expert_tp)
    rec = {"inputs": flat(specs.input_specs(cfg, shape, mesh))}
    if shape.kind == "train":
        params, pspecs = specs.abstract_params(cfg, mesh, dtype=jnp.float32,
                                               fsdp=fsdp)
        opt = specs.abstract_opt_state(params, pspecs, mesh)
        rec.update(params=flat(params), mu=flat(opt.mu), nu=flat(opt.nu),
                   step=flat({"step": opt.step}))
    else:
        params, _ = specs.abstract_params(cfg, mesh, fsdp=fsdp,
                                          expert_tp=expert_tp)
        rec.update(params=flat(params),
                   cache=flat(specs.abstract_cache(cfg, rt, shape, mesh)))
    res[combo] = rec
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": {combo: {section: {path: (shape, dtype, bytes)}}}, "live":
    every rank's ``_torch_dryrun.run_rank`` record}: the JAX subprocess
    runs while the port's world does."""
    tmp = tmp_path_factory.mktemp("dryrun")
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(COMBOS, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(SUB),
                             str(tmp / "in.pkl"), str(tmp / "jax.pkl")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    try:
        live = mesh_mod.spawn(legs.run_rank, (legs.LEGS,), data=2, model=2,
                              backend="gloo", threads=1, timeout_s=300)
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    with open(tmp / "jax.pkl", "rb") as f:
        ref = pickle.load(f)
    return {"jax": ref, "live": live}


def _dtype(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _flat(tree, prefix=""):
    """{'/'-joined path: tensor} of a cache's dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _port_trees(combo):
    """The port's trees of ``combo``: (the model, the moments or None, the
    reference's cache layout or None, the inputs)."""
    arch, shape_name, multi_pod, fsdp, expert_tp = combo
    cfg, shape = get_config(arch), INPUT_SHAPES[shape_name]
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod)
    inputs, _ = specs.input_specs(cfg, shape, mesh)
    if shape.kind == "train":
        model, _ = specs.abstract_params(cfg, mesh, dtype=torch.float32,
                                         fsdp=fsdp, trainable=True)
        return model, specs.abstract_opt_state(model), None, inputs
    model, _ = specs.abstract_params(cfg, mesh, fsdp=fsdp,
                                     expert_tp=expert_tp)
    rt = specs.runtime_for(cfg, mesh, shape, decode_expert_tp=expert_tp)
    cache, _ = specs.abstract_cache(cfg, rt, shape, mesh)
    return model, None, cache, inputs


def _check_params(cfg, params, ref, what):
    paths = param_paths(cfg)
    seen = set()
    for name, p in params.items():
        path, stacked = paths[name]
        shape, dtype, _ = ref[path]
        assert tuple(p.shape) == (shape[1:] if stacked else shape), \
            (what, name)
        assert _dtype(p) == dtype, (what, name)
        seen.add(path)
    assert seen == set(ref), (what, set(ref) ^ seen)


@pytest.mark.parametrize("combo", COMBOS, ids=lambda c: "-".join(
    str(x) for x in c))
def test_trees_match_the_jax_shards(runs, combo):
    ref = runs["jax"][combo]
    cfg = get_config(combo[0])
    model, opt, cache, inputs = _port_trees(combo)
    params = dict(model.named_parameters())
    _check_params(cfg, params, ref["params"], "params")
    want = sum(b for sec in ref.values() for _, _, b in sec.values())
    got = specs.tree_bytes(list(params.values())) + specs.tree_bytes(inputs)
    if opt is not None:
        _check_params(cfg, opt.mu, ref["mu"], "mu")
        _check_params(cfg, opt.nu, ref["nu"], "nu")
        assert (tuple(opt.step.shape), _dtype(opt.step)) == \
            ref["step"]["step"][:2]
        got += specs.tree_bytes(opt)
    if cache is not None:
        mine = {k[5:] if k.startswith("self/") else k: v
                for k, v in ref["cache"].items()}
        port = _flat(cache)
        assert set(port) == set(mine)
        for k, t in port.items():
            assert (tuple(t.shape), _dtype(t)) == mine[k][:2], k
        got += specs.tree_bytes(cache)
    assert {k: (tuple(t.shape), _dtype(t)) for k, t in inputs.items()} == \
        {k: v[:2] for k, v in ref["inputs"].items()}
    assert got == want


@pytest.mark.parametrize("arch", dryrun.ASSIGNED_ARCHS + [MIXTRAL])
def test_the_steps_cache_is_the_reference_layout_but_where_stated(arch):
    cfg, mesh = get_config(arch), mesh_mod.make_production_mesh()
    for shape in ("decode_32k", "prefill_32k"):
        shape = INPUT_SHAPES[shape]
        rt = specs.runtime_for(cfg, mesh, shape)
        model, _ = specs.abstract_params(cfg, mesh, dtype=None)
        ref = _flat(specs.abstract_cache(cfg, rt, shape, mesh)[0])
        port = _flat(specs.port_cache(model, cfg, rt, shape, mesh))
        assert set(ref) == set(port)
        differ = {k for k in ref if ref[k].shape != port[k].shape}
        stated = PORT_CACHE_DIFFERS.get(arch, ())
        assert {k.rsplit("/", 1)[-1] for k in differ} == set(stated), differ
        for k in differ:                  # more held, never less
            assert port[k].numel() > ref[k].numel()


@pytest.mark.parametrize("leg", sorted(legs.LEGS))
def test_dry_counts_equal_the_live_ones(runs, leg):
    arch, kind, layout = legs.LEGS[leg]
    for r, rec in enumerate(runs["live"]):
        mesh = mesh_mod.ProductionMesh({"data": 2, "model": 2}, rank=r)
        dry = dryrun.trace_one(legs.leg_config(arch), legs.SHAPES[kind], mesh,
                               fsdp=layout == "fsdp", whole=True)
        assert dry["collectives"] == rec[leg]["collectives"], r
        assert dry["argument_bytes"] == rec[leg]["argument_bytes"], r
        assert dry["collectives"]["count"] > 0


def _deep(arch, layers):
    return specs.with_layers(get_config(arch).reduced(), layers)


@pytest.mark.parametrize("arch,layers", [("qwen1.5-0.5b", 5),
                                         (MIXTRAL, 5),
                                         ("recurrentgemma-2b", 11),
                                         ("seamless-m4t-medium", 4)])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_extrapolated_depth_equals_a_whole_trace(arch, layers, kind):
    cfg = _deep(arch, layers)
    assert dryrun.sample_depths(cfg) is not None
    shape = InputShape(kind, 16, 4, kind)
    mesh = mesh_mod.ProductionMesh({"data": 2, "model": 2})
    got = dryrun.trace_one(cfg, shape, mesh)
    want = dryrun.trace_one(cfg, shape, mesh, whole=True)
    assert len(got["depths"]) == 2 and want["depths"] == [layers]
    for k in ("argument_bytes", "peak_bytes", "output_bytes", "flops",
              "bytes", "collectives", "kernels"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("Sq,Skv,kw", [
    (5 * 64 + 7, 6 * 64, dict(causal=True, window=100)),
    (4 * 64, 5 * 64 - 3, dict(causal=False)),
    (9 * 64, 9 * 64, dict(causal=True, q_offset=3, kv_valid_len=500))])
def test_counted_attention_equals_its_whole_trace(Sq, Skv, kw):
    kw = dict(kw, q_block=64, kv_block=64)
    res = []
    for counted in (False, True):
        t = dryrun.Tracer()
        q = torch.empty(2, Sq, 4, 16, device="meta", dtype=torch.bfloat16)
        k = torch.empty(2, Skv, 2, 16, device="meta", dtype=torch.bfloat16)
        t.track(q, k)
        fn = (dryrun.CountedAttention(t, attention.chunked_attention)
              if counted else attention.chunked_attention)
        with t, torch.inference_mode():
            out = fn(q, k, k, **kw)
        res.append((t.flops, t.bytes, t.peak, tuple(out.shape), out.dtype,
                    out.untyped_storage().nbytes()))
    assert res[0] == res[1]


def test_tracer_flops_equal_flop_counter_mode():
    from torch.utils.flop_counter import FlopCounterMode
    cfg = _deep("olmo-1b", 2)
    mesh = mesh_mod.ProductionMesh({"data": 2, "model": 2})
    args = specs.step_args(cfg, InputShape("train", 16, 4, "train"), mesh)
    t = dryrun.Tracer()
    with t:
        dryrun.run_step(args, InputShape("train", 16, 4, "train"))
    args = specs.step_args(cfg, InputShape("train", 16, 4, "train"), mesh)
    with FlopCounterMode(display=False) as fc:
        dryrun.run_step(args, InputShape("train", 16, 4, "train"))
    assert t.flops == fc.get_total_flops() > 0


def test_cli_writes_rows_the_report_renders(tmp_path, capsys):
    out = str(tmp_path)
    assert dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                        "--out", out]) == 0
    assert dryrun.main(["--arch", "olmo-1b", "--shape", "decode_32k",
                        "--multi-pod", "--out", out]) == 0
    assert dryrun.main(["--arch", MIXTRAL, "--shape", "decode_32k",
                        "--out", out]) == 0                 # a SKIP
    printed = capsys.readouterr().out
    assert "SKIP mixtral-8x7b" in printed and "FAIL" not in printed
    rows = report.load_rows(out)
    assert {(r["arch"], r["mesh"], r["chips"]) for r in rows} == {
        ("qwen1.5-0.5b", "16x16", 256), ("olmo-1b", "2x16x16", 512)}
    for r in rows:
        assert r["collective_bytes_per_device"] > 0
        assert r["dominant"] in ("compute", "memory", "collective")
        assert r["hlo_flops_per_device"] == r["hlo_bytes_per_device"] == 0
        assert r["executed_flops_per_device"] > 0
        assert r["peak_bytes"] == r["argument_bytes"] + r["temp_bytes"]
        assert r["argument_bytes"] > 0 and r["temp_bytes"] > 0
        assert r["status"] == "ok" and r["trace_s"] >= 0
        assert 0 < r["ordered_sum_allreduce_bytes"] < \
            r["ordered_sum_gathered_bytes"] <= r["collective_breakdown"][
                "all-gather"]
    for mesh, arch in (("16x16", "qwen1.5-0.5b"), ("2x16x16", "olmo-1b")):
        text = report.table(rows, mesh)
        assert f"| {arch} | decode_32k |" in text
        assert len(text.splitlines()) == 3
    with open(tmp_path / "qwen1.5-0.5b_decode_32k_16x16.json") as f:
        assert json.load(f)["collective_breakdown"]["count"] > 0
    assert report.fmt_b(5.665e9) == "5.7GB" and report.fmt_s(2e-5) == "20.0us"


def _meta(*ts):
    return [None if t is None else t.to("meta") for t in ts]


def _same(got, want):
    if want is None or isinstance(want, torch.Tensor):
        got, want = [got], [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.is_meta and (tuple(g.shape), g.dtype) == (tuple(w.shape),
                                                            w.dtype)


def test_kernel_wrappers_meta_outputs_match_the_plain_versions():
    gen = torch.Generator().manual_seed(0)
    work.reset_kernel_work()
    # paged decode attention: B 2, K 2, G 2, hd 16, 3 blocks of 4
    q = torch.randn(2, 2, 2, 16, generator=gen).to(torch.bfloat16)
    pool = torch.randn(7, 4, 2, 16, generator=gen).to(torch.bfloat16)
    tables = torch.tensor([[1, 2, 3], [4, 5, 6]], dtype=torch.int32)
    lengths = torch.tensor([5, 9], dtype=torch.int32)
    args = (q, pool, pool, tables, lengths)
    _same(ops.paged_decode_attention(*_meta(*args), window=4),
          ops.paged_decode_attention(*args, window=4))
    # moe_gemm and its backward: 3 slots of 8 rows, 2 experts, d 16, F 32
    x = torch.randn(3, 8, 16, generator=gen).to(torch.bfloat16)
    wg, wu = (torch.randn(2, 16, 32, generator=gen).to(torch.bfloat16)
              for _ in range(2))
    wd = torch.randn(2, 32, 16, generator=gen).to(torch.bfloat16)
    se = torch.tensor([0, 1, 1], dtype=torch.int32)
    rc = torch.tensor([[3], [8], [0]], dtype=torch.int32)
    for gate, act in ((wg, "swiglu"), (None, "relu")):
        args = (x, gate, wu, wd, se, act, rc)
        _same(ops.moe_gemm(*_meta(*args[:5]), act, rc.to("meta")),
              ops.moe_gemm(*args))
        dy = torch.randn(3, 8, 16, generator=gen).to(torch.bfloat16)
        _same(ops.moe_gemm_bwd(*_meta(x, gate, wu, wd, se, dy), act,
                               rc.to("meta")),
              ops.moe_gemm_bwd(x, gate, wu, wd, se, dy, act, rc))
    # the router and its backward: 2 ranks x 5 tokens x 8 experts, K 2
    logits = torch.randn(2, 5, 8, generator=gen)
    got = ops.fused_topk_route(logits.to("meta"), 2)
    want = ops.fused_topk_route(logits, 2)
    _same(got, want)
    grads = (torch.randn(2, 5, 2, generator=gen),
             torch.randn(2, 5, 8, generator=gen), None)
    _same(ops.fused_topk_route_bwd(*_meta(want[2], want[0], *grads)),
          ops.fused_topk_route_bwd(want[2], want[0], *grads))
    # the histogram: 2 rows of 11 ids over 5 classes
    ids = torch.randint(0, 6, (2, 11), generator=gen, dtype=torch.int32)
    _same(ops.histogram_offsets(ids.to("meta"), 5),
          ops.histogram_offsets(ids, 5))
    # the scan and its backward: 2 x 6 x 8
    a, b = (torch.rand(2, 6, 8, generator=gen) for _ in range(2))
    h0 = torch.zeros(2, 8)
    want = ops.rg_lru_scan(a, b, h0)
    _same(ops.rg_lru_scan(*_meta(a, b, h0)), want)
    dh = torch.randn(2, 6, 8, generator=gen)
    _same(ops.rg_lru_scan_bwd(*_meta(a, want[0], h0, dh, None)),
          ops.rg_lru_scan_bwd(a, want[0], h0, dh, None))
    # every meta call counted its kernel's work, and no launch
    assert set(work.KERNEL_WORK) == set(ops.LAUNCHES)
    assert all(w["bytes"] > 0 and w["calls"] > 0
               for w in work.KERNEL_WORK.values())
    assert work.KERNEL_WORK["moe_gemm"]["flops"] == sum(
        work.moe_gemm_work(3, 16, 32, 2, 24, 2, 3, gated)[1]
        for gated in (True, False))


def test_autograd_functions_run_on_meta():
    """A train step's kernels on ``meta``: each ``Function``'s backward
    gives the inputs' shapes."""
    x = torch.empty(3, 8, 16, device="meta", requires_grad=True)
    w = [torch.empty(s, device="meta", requires_grad=True)
         for s in ((2, 16, 32), (2, 16, 32), (2, 32, 16))]
    se = torch.empty(3, dtype=torch.int32, device="meta")
    y = ops.moe_gemm(x, *w, se, "swiglu")
    y.sum().backward()
    assert [tuple(t.grad.shape) for t in [x] + w] == [
        (3, 8, 16), (2, 16, 32), (2, 16, 32), (2, 32, 16)]
    logits = torch.empty(2, 5, 8, device="meta", requires_grad=True)
    idx, gates, probs, lse, counts = ops.FusedTopkRoute.apply(logits, 2)
    (gates.sum() + probs.sum() + lse.sum()).backward()
    assert logits.grad.shape == logits.shape
    a = torch.empty(2, 6, 8, device="meta", requires_grad=True)
    h, last = ops.RgLruScan.apply(a, a, torch.zeros(2, 8, device="meta"))
    (h.sum() + last.sum()).backward()
    assert a.grad.shape == a.shape


def test_dry_ranks_count_what_the_live_ones_move():
    comm = dispatch.DryRanks(ranks=4, rank=1, global_ranks=range(4))
    dispatch.reset_collective_bytes()
    t = torch.empty(1, 6, 8, dtype=torch.bfloat16, device="meta")
    out = comm.all_to_all(torch.empty(1, 4, 8, device="meta"))
    assert out.is_meta and tuple(out.shape) == (1, 4, 8)
    assert tuple(comm.all_gather(t).shape) == (4, 6, 8)
    assert tuple(comm.psum(t).shape) == (6, 8)
    # the ordered sum: R fp32 copies gathered, summed in rank order
    assert comm.tp_sum(t[0]).dtype == torch.bfloat16
    assert comm.gather(t) is None                      # not the group's 0
    assert dispatch.collective_bytes() == {
        "all-to-all": 4 * 8 * 4, "all-gather": 4 * 6 * 8 * 2 + 4 * 6 * 8 * 4,
        "all-reduce": 6 * 8 * 2, "gather": 0, "send/recv": 0, "count": 5}
    # XLA would all-reduce the bf16 tensor: 96 bytes, not 4 fp32 copies
    assert dispatch.ORDERED_SUMS == {"gathered": 4 * 6 * 8 * 4,
                                     "all-reduce": 6 * 8 * 2}


def test_a_plan_with_replica_slots_is_read_on_its_host_copy():
    """The replica pool reads the plan on the host: on ``meta`` it reads
    the ``MetaPlan``'s CPU copy, and the step traces."""
    cfg = _deep(MIXTRAL, 2)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, duplication_slots=1))
    mesh = mesh_mod.ProductionMesh({"data": 2, "model": 2})
    plan = placement.to_device(specs.plan_args(cfg, 2), 4, 2, 1, "meta")
    cpu = placement.to_device(specs.plan_args(cfg, 2), 4, 2, 1, "cpu")
    assert isinstance(plan, placement.MetaPlan) and plan.slot_experts.is_meta
    assert placement.host_plan(plan.layer(1)).slot_experts.tolist() == \
        cpu.layer(1).slot_experts.tolist()
    for kind in ("prefill", "decode"):
        got = dryrun.trace_one(cfg, InputShape(kind, 16, 4, kind), mesh)
        assert got["kernels"]["moe_gemm"]["calls"] == 2


def test_production_mesh_lays_out_the_reference_ranks():
    m = mesh_mod.make_production_mesh(multi_pod=True, rank=300)
    assert m.shape == {"pod": 2, "data": 16, "model": 16} and m.key == \
        "2x16x16"
    assert m.coords == {"pod": 1, "data": 2, "model": 12}
    assert (m.data, m.data_index, m.model_index) == (32, 18, 12)
    assert m.comm.ranks == 16 and m.data_comm.ranks == 32
    assert m.world_comm.ranks == 512 and m.device.type == "meta"
    assert m.batch_rows(64) == slice(36, 38)
    assert mesh_mod.batch_shards(m) == 32 and mesh_mod.model_axis_size(m) == 16
    assert mesh_mod.batch_shards(mesh_mod.make_production_mesh()) == 16


def test_importing_the_mesh_and_the_dry_run_initialises_nothing():
    code = ("import torch, torch.distributed as dist\n"
            "import repro_torch.launch.mesh, repro_torch.launch.dryrun\n"
            "assert not dist.is_initialized()\n"
            "assert not torch.cuda.is_initialized()\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
