"""The dry run: one rank's train, prefill or decode step of every (arch x
input shape x production mesh), traced and not run (the port of the JAX
package's ``launch/dryrun.py``).

The reference lowers and compiles each step on 512 fake host devices and
reads the compiled program's cost and memory analysis. Eager PyTorch has
no compiled program, so the port runs its own step on one rank's abstract
trees (``launch.specs``: every parameter, moment, cache leaf and input an
empty ``meta`` tensor at that rank's block shape) on an abstract mesh
(``launch.mesh.make_production_mesh``: 16 x 16, or 2 x 16 x 16 with
``--multi-pod``), whose collectives are ``moe.dispatch.DryRanks``. Nothing
is allocated and nothing is executed: the device is ``meta``, as the
reference's devices are fake. While the step runs, ``Tracer`` counts

  * the live ``meta`` storage, whose high-water mark is the peak (the
    arguments included);
  * the operations of every operator (``torch.utils.flop_counter``'s
    table) and the bytes each reads and writes, and each kernel's own
    (``kernels.work``, through the kernel wrappers' ``meta`` branches);

and ``moe.dispatch.COLLECTIVE_BYTES`` counts the result bytes of every
collective, by kind. ``roofline.analyze`` turns the counts into the
reference's report rows.

The dry run describes the card's path, which always runs the kernels: the
reference's ``--use-kernel`` has no counterpart. ``compile_s`` becomes
``trace_s``, the seconds the trace took.

Depth. Tracing a 32K prefill runs the eager block loop of
``models.attention.chunked_attention`` ((S / 512)^2 blocks a layer), so a
step is traced at two depths a whole period of the layer pattern apart
(two and three layers; Griffin's (recurrent, recurrent, local) five and
eight), and every
count is extrapolated linearly to the config's depth: the counts of the
layers between the two depths are those of every further period
(``sample_depths``). The arguments are counted at the full depth. The
peak's part above the arguments is extrapolated the same way, which holds
while the step peaks at the same point of every depth
(``tests/test_torch_dryrun.py`` holds the extrapolated counts against a
whole-depth trace).

Usage (no card needed):
  python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all [--multi-pod]
  python -m repro_torch.launch.dryrun ... --out experiments/dryrun
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.configs.registry import get_config
from repro_torch.kernels import work as kernel_work
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import attention
from repro_torch.moe import dispatch
from repro_torch.roofline import analyze, save_report

# the JAX package's ASSIGNED_ARCHS: its registry less the paper's models,
# which run by name
ASSIGNED_ARCHS = ["minicpm-2b", "stablelm-3b", "rwkv6-7b", "qwen1.5-0.5b",
                  "llava-next-34b", "seamless-m4t-medium", "arctic-480b",
                  "olmo-1b", "deepseek-v2-lite-16b", "recurrentgemma-2b"]

_EMPTY = ("empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided")


class _Uncacheable(Exception):
    pass


def _key(x):
    """A hashable description of an operator argument, or raise."""
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise _Uncacheable
        return (x.dtype, x.shape, x.stride())
    if isinstance(x, (list, tuple)):
        return tuple(_key(a) for a in x)
    if x is None or isinstance(x, (bool, int, float, str, torch.dtype,
                                   torch.device, torch.memory_format,
                                   torch.layout)):
        return (x.__class__, x)
    raise _Uncacheable


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for a in x:
            yield from _tensors(a)
    elif isinstance(x, dict):
        for a in x.values():
            yield from _tensors(a)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _rebuild(desc):
    """Empty outputs of a remembered operator: one tensor (a tuple
    description) or a tuple of them (a list)."""
    if isinstance(desc, tuple):
        s, st, dt = desc
        return torch.empty_strided(s, st, dtype=dt, device="meta")
    return tuple(torch.empty_strided(s, st, dtype=dt, device="meta")
                 for s, st, dt in desc)


class Tracer(TorchDispatchMode):
    """Counts what the operators of a ``meta`` run do: ``flops`` (the
    table ``torch.utils.flop_counter.FlopCounterMode`` counts with),
    ``bytes`` (each operator's tensor inputs and outputs, views and
    ``empty`` excluded), and the live bytes of ``meta`` storage, whose
    high-water mark is ``peak`` (``track`` registers what was live before).
    A functional operator's outputs depend on its inputs' shapes alone, so
    its result is remembered by them and a repeat makes empty outputs of
    the same shapes (the eager block loops repeat few shapes many times)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self._seen: Dict[int, weakref.ref] = {}
        self._memo: Dict[tuple, tuple] = {}
        self._functional: Dict[object, bool] = {}
        self._decomposes: Dict[object, bool] = {}
        self.live = self.peak = 0
        self.flops = 0
        self.bytes = 0

    def track(self, *trees) -> int:
        """Register the storage of every tensor in ``trees`` as live;
        returns the bytes newly registered."""
        before = self.live
        for t in _tensors(list(trees)):
            self._hold(t)
        return self.live - before

    def _hold(self, t) -> None:
        if not t.is_meta:
            return
        st = t.untyped_storage()
        k = id(st)
        ref = self._seen.get(k)
        if ref is not None and ref() is st:
            return
        n = st.nbytes()

        def dead(_, k=k, n=n):
            self.live -= n
            self._seen.pop(k, None)
        self._seen[k] = weakref.ref(st, dead)
        self.live += n
        self.peak = max(self.peak, self.live)

    def _is_functional(self, func) -> bool:
        ok = self._functional.get(func)
        if ok is None:
            sch = func._schema
            ok = (not any(a.alias_info is not None for a in sch.arguments)
                  and not any(r.alias_info is not None for r in sch.returns)
                  and len(sch.returns) > 0)
            self._functional[func] = ok
        return ok

    def _composite(self, func) -> bool:
        """Whether ``func`` decomposes into other operators (``matmul`` and
        ``einsum`` reach a mode whole under ``inference_mode``) and has no
        entry of its own in the flop table: it is then counted by its
        parts, as ``FlopCounterMode`` counts it."""
        ok = self._decomposes.get(func)
        if ok is None:
            ok = (func._overloadpacket not in self._flops
                  and torch._C._dispatch_has_kernel_for_dispatch_key(
                      func.name(), "CompositeImplicitAutograd"))
            self._decomposes[func] = ok
        return ok

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._composite(func):
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        functional = self._is_functional(func)
        key = None
        if functional:
            try:
                key = (func, _key(args), _key(tuple(sorted(kwargs.items()))))
            except _Uncacheable:
                key = None
        memo = self._memo.get(key) if key is not None else None
        if memo is not None:
            desc, flops, nbytes = memo
            out = _rebuild(desc)
        else:
            out = func(*args, **kwargs)
            flops, nbytes = self._work(func, args, kwargs, out, functional)
            if key is not None:
                desc = self._describe(out)
                if desc is not None:
                    self._memo[key] = (desc, flops, nbytes)
        self.flops += flops
        self.bytes += nbytes
        for t in _tensors(out):
            self._hold(t)
        return out

    @staticmethod
    def _describe(out):
        """The outputs' (shape, stride, dtype): a tuple for one ``meta``
        tensor, a list for a tuple of them, None for anything else."""
        if isinstance(out, torch.Tensor) and out.is_meta:
            return (tuple(out.shape), out.stride(), out.dtype)
        if isinstance(out, (tuple, list)) and out and all(
                isinstance(t, torch.Tensor) and t.is_meta for t in out):
            return [(tuple(t.shape), t.stride(), t.dtype) for t in out]
        return None

    def _work(self, func, args, kwargs, out, functional):
        packet = func._overloadpacket
        fn = self._flops.get(packet)
        flops = fn(*args, **kwargs, out_val=out) if fn is not None else 0
        name = packet.__name__
        views = not functional and any(
            r.alias_info is not None and not r.alias_info.is_write
            for r in func._schema.returns)
        if views or name in _EMPTY:
            return flops, 0
        nbytes = sum(_nbytes(t) for t in _tensors((args, kwargs))
                     if t.is_meta)
        nbytes += sum(_nbytes(t) for t in _tensors(out) if t.is_meta)
        return flops, nbytes




# ---------------------------------------------------------------------------
# the attention's block loop
# ---------------------------------------------------------------------------

# the (q blocks, kv blocks) ``CountedAttention`` traces
_BLOCK_SAMPLES = ((2, 2), (3, 2), (2, 3), (3, 3))


def _bilinear(f):
    """(a, b, c, e) of ``f(n, m) = a + b n + c m + e n m`` from its values
    at ``_BLOCK_SAMPLES``."""
    f22, f32, f23, f33 = f
    e = f33 - f32 - f23 + f22
    b, c = f32 - f22 - 2 * e, f23 - f22 - 2 * e
    return f22 - 2 * b - 2 * c - 4 * e, b, c, e


class CountedAttention:
    """``models.attention.chunked_attention`` for a traced prefill. Its
    eager loop runs the same operators for every (q block, kv block) pair,
    and for every q block and every kv block around them, so every count
    of a call is ``a + b nq + c nkv + e nq nkv`` in its block counts. A
    call without a graph to record (serving) with at least 4 blocks each
    way is traced at ``_BLOCK_SAMPLES``' block counts (the leading rows of
    q and of k and v, the last, partial block kept) and the counts of its
    own block counts are added to the tracer, the peak as the part above
    what was live when the call began; its result is an empty tensor of the
    call's (the padded block rows, viewed to the sequence's). One shape is
    traced once. A call that records a graph (training), or a short one,
    runs whole."""

    def __init__(self, tracer: "Tracer", real):
        self.tracer, self.real, self.memo = tracer, real, {}

    def _sample(self, q, k, v, kw):
        t = self.tracer
        flops, nbytes, peak, live = t.flops, t.bytes, t.peak, t.live
        t.peak = live
        out = self.real(q, k, v, **kw)
        got = (t.flops - flops, t.bytes - nbytes, t.peak - live)
        del out
        t.flops, t.bytes, t.peak = flops, nbytes, peak
        return got

    def __call__(self, q, k, v, **kw):
        Sq, Skv = q.shape[1], k.shape[1]
        qb = min(kw.get("q_block", 512), Sq)
        kb = min(kw.get("kv_block", 512), Skv)
        nq, nkv = -(-Sq // qb), -(-Skv // kb)
        if torch.is_grad_enabled() or not q.is_meta or min(nq, nkv) < 4:
            return self.real(q, k, v, **kw)
        key = (_key((q, k, v)), _key(tuple(sorted(kw.items()))))
        fit = self.memo.get(key)
        if fit is None:
            rq, rk = Sq - (nq - 1) * qb, Skv - (nkv - 1) * kb
            got = [self._sample(q[:, :(n - 1) * qb + rq],
                                k[:, :(m - 1) * kb + rk],
                                v[:, :(m - 1) * kb + rk], kw)
                   for n, m in _BLOCK_SAMPLES]
            fit = self.memo[key] = [_bilinear(c) for c in zip(*got)]
        flops, nbytes, peak = (a + b * nq + c * nkv + e * nq * nkv
                               for a, b, c, e in fit)
        t = self.tracer
        t.flops += flops
        t.bytes += nbytes
        t.peak = max(t.peak, t.live + peak)
        B, _, H, hd = q.shape
        return torch.empty((B, nq * qb, H, hd), dtype=q.dtype,
                           device=q.device)[:, :Sq]


# ---------------------------------------------------------------------------
# one step, traced
# ---------------------------------------------------------------------------

def skip_reason(cfg: ModelConfig, shape: InputShape, mesh=None) -> str:
    """Combination-level skips: a MoE model whose experts do not split
    over the mesh's "model" axis (Mixtral's 8 over 16), which the EP
    dispatch's plan cannot lay out (the reference's ``plan_args`` fails
    there alike); every other combination runs (dense decode windowed)."""
    if mesh is not None and cfg.is_moe \
            and cfg.moe.num_experts % mesh.shape["model"]:
        return (f"{cfg.moe.num_experts} experts do not split over "
                f"{mesh.shape['model']} EP ranks")
    return ""


def run_step(args: Dict, shape: InputShape, *, remat: bool = False,
             microbatches: int = 1):
    """One step of ``shape`` on ``specs.step_args``' trees; returns its
    outputs."""
    from repro_torch.train.steps import (make_decode_step, make_prefill_step,
                                         make_train_step)
    cfg, rt, model = args["cfg"], args["rt"], args["model"]
    inputs, plan = args["inputs"], args["plan"]
    if shape.kind == "train":
        step = make_train_step(cfg, rt, remat=remat,
                               microbatches=microbatches)
        return step(model, args["opt"], inputs, plan=plan)
    if shape.kind == "prefill":
        step = make_prefill_step(cfg, rt)
        return step(model, inputs["tokens"], cache=args["cache"], plan=plan,
                    frames=inputs.get("frames"),
                    prefix_embeds=inputs.get("prefix_embeds"))
    step = make_decode_step(cfg, rt)
    return step(model, inputs["tokens"], args["cache"], shape.seq_len - 1,
                plan=plan)


def trace_step(cfg: ModelConfig, shape: InputShape, mesh, **kw) -> Dict:
    """Build the trees of ``cfg`` (``specs.step_args``) and trace one step
    on them: {"argument_bytes", "peak_bytes", "output_bytes", "flops",
    "bytes", "collectives" {kind: bytes, "count"}, "ordered_sums"
    {"gathered", "all-reduce"} (``moe.dispatch.ORDERED_SUMS``), "kernels"
    {name: {"calls", "bytes", "flops"}}}."""
    remat = kw.pop("remat", False)
    microbatches = kw.pop("microbatches", 1)
    args = specs.step_args(cfg, shape, mesh, **kw)
    dispatch.reset_collective_bytes()
    kernel_work.reset_kernel_work()
    tracer = Tracer()
    arg_bytes = tracer.track(list(args["model"].parameters()),
                             args.get("opt"), args.get("cache"),
                             args["inputs"])
    real = attention.chunked_attention
    attention.chunked_attention = CountedAttention(tracer, real)
    try:
        with tracer:
            out = run_step(args, shape, remat=remat,
                           microbatches=microbatches)
    finally:
        attention.chunked_attention = real
    kern = {k: dict(v) for k, v in kernel_work.KERNEL_WORK.items()}
    held = {id(t.untyped_storage()) for t in _tensors(
        [list(args["model"].parameters()), args.get("opt"),
         args.get("cache"), args["inputs"]]) if t.is_meta}
    outputs, seen = 0, set()
    for t in _tensors(out):
        k = id(t.untyped_storage()) if t.is_meta else None
        if k is not None and k not in held and k not in seen:
            seen.add(k)
            outputs += t.untyped_storage().nbytes()
    return {"argument_bytes": arg_bytes, "peak_bytes": tracer.peak,
            "output_bytes": outputs,
            "flops": tracer.flops + sum(v["flops"] for v in kern.values()),
            "bytes": tracer.bytes + sum(v["bytes"] for v in kern.values()),
            "collectives": dispatch.collective_bytes(),
            "ordered_sums": dict(dispatch.ORDERED_SUMS), "kernels": kern}


def sample_depths(cfg: ModelConfig):
    """(d1, d2, n): the two depths a whole period of the layer pattern
    apart that are traced (d1 at least 2), and the periods the config adds
    past d1; None
    when the whole depth is traced (as shallow as d2, or an
    encoder-decoder whose stacks differ in depth)."""
    L = cfg.num_layers
    if cfg.is_encdec and cfg.encoder.num_layers != L:
        return None
    P = len(cfg.block_pattern) if cfg.family == "hybrid" \
        and cfg.block_pattern else 1
    # at least two layers: the first layer's statistics start the running
    # sums of a MoE forward, so its peak differs from a later layer's
    d1 = L % P + P * -(-2 // P)
    d2 = d1 + P
    if L <= d2:
        return None
    return d1, d2, (L - d1) // P


def _extrapolate(a, b, n):
    """a + n (b - a) over nested dicts of numbers (two traces' counts,
    whose layers run the same collectives and kernels)."""
    if isinstance(a, dict):
        return {k: _extrapolate(a[k], b[k], n) for k in a}
    return a + n * (b - a)


def trace_one(cfg: ModelConfig, shape: InputShape, mesh, *,
              fsdp: bool = True, remat: bool = False, microbatches: int = 1,
              expert_tp: bool = False, train_dtype: str = "float32",
              whole: bool = False) -> Dict:
    """The counts of one rank's step (``trace_step``'s keys, plus
    "trace_s", the seconds taken, and "depths", the depths traced), at
    the config's depth: extrapolated from ``sample_depths`` unless
    ``whole`` (or the config is too shallow), the arguments counted at
    the full depth."""
    trees = dict(fsdp=fsdp, expert_tp=expert_tp,
                 train_dtype=getattr(torch, train_dtype))
    step = dict(trees, remat=remat, microbatches=microbatches)
    t0 = time.perf_counter()
    depths = None if whole else sample_depths(cfg)
    if depths is None:
        out = trace_step(cfg, shape, mesh, **step)
        out["depths"] = [cfg.num_layers]
    else:
        d1, d2, n = depths
        out = _extrapolate(
            trace_step(specs.with_layers(cfg, d1), shape, mesh, **step),
            trace_step(specs.with_layers(cfg, d2), shape, mesh, **step), n)
        full = specs.argument_bytes(specs.step_args(cfg, shape, mesh,
                                                    **trees))
        temp = out["peak_bytes"] - out["argument_bytes"]
        out.update(argument_bytes=full, peak_bytes=full + temp,
                   depths=[d1, d2])
    out["trace_s"] = time.perf_counter() - t0
    return out


def run_combo(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
              fsdp: bool = True, tag: str = "", remat: bool = False,
              microbatches: int = 1, pad_vocab: int = 0,
              expert_tp: bool = False, train_dtype: str = "float32") -> dict:
    """One combination's report row (``roofline.RooflineReport.row`` with
    "status", "trace_s", "depths" and the ordered sums' gathered bytes
    beside an all-reduce's, ``ordered_sum_gathered_bytes`` and
    ``ordered_sum_allreduce_bytes``), written to ``out_dir`` as
    ``{arch}_{shape}_{mesh}{_tag}.json`` when given."""
    cfg = get_config(arch)
    if pad_vocab:
        # Megatron-style vocab padding: the vocab rounded up so the
        # embedding and the LM head shard evenly over the model axis
        v = (cfg.vocab_size + pad_vocab - 1) // pad_vocab * pad_vocab
        cfg = dataclasses.replace(cfg, vocab_size=v)
    shape = INPUT_SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    chips = 512 if multi_pod else 256
    reason = skip_reason(cfg, shape, mesh)
    if reason:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}
    counts = trace_one(cfg, shape, mesh, fsdp=fsdp, remat=remat,
                       microbatches=microbatches, expert_tp=expert_tp,
                       train_dtype=train_dtype)
    rep = analyze(arch, shape, mesh_name, chips, cfg, counts)
    row = rep.row()
    extra = dict(status="ok", trace_s=round(counts["trace_s"], 2),
                 depths=counts["depths"],
                 ordered_sum_gathered_bytes=counts["ordered_sums"][
                     "gathered"],
                 ordered_sum_allreduce_bytes=counts["ordered_sums"][
                     "all-reduce"])
    row.update(extra)
    if out_dir:
        suffix = f"_{tag}" if tag else ""
        path = os.path.join(out_dir,
                            f"{arch}_{shape_name}_{mesh_name}{suffix}.json")
        save_report(path, rep)
        with open(path, "r+") as f:
            d = json.load(f)
            d.update(extra)
            f.seek(0)
            json.dump(d, f, indent=1)
            f.truncate()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--pad-vocab", type=int, default=0,
                    help="round vocab up to a multiple (Megatron-style)")
    ap.add_argument("--expert-tp", action="store_true",
                    help="2D expert sharding (EP x f-TP) for decode")
    ap.add_argument("--train-dtype", default="float32",
                    help="parameter dtype of the train step "
                         "(bfloat16 halves FSDP gather bytes)")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    archs = ASSIGNED_ARCHS if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]

    failures = 0
    for arch in archs:
        for shape in shapes:
            try:
                row = run_combo(arch, shape, args.multi_pod, args.out,
                                fsdp=not args.no_fsdp, tag=args.tag,
                                remat=args.remat,
                                microbatches=args.microbatches,
                                pad_vocab=args.pad_vocab,
                                expert_tp=args.expert_tp,
                                train_dtype=args.train_dtype)
                if row["status"] == "ok":
                    print(f"OK   {arch:22s} {shape:12s} {row['mesh']:8s} "
                          f"trace={row['trace_s']}s "
                          f"c={row['compute_s']:.2e}s "
                          f"m={row['memory_s']:.2e}s "
                          f"n={row['collective_s']:.2e}s "
                          f"dom={row['dominant']}")
                else:
                    print(f"SKIP {arch:22s} {shape:12s} ({row['reason']})")
            except Exception as e:                    # reported, counted
                failures += 1
                print(f"FAIL {arch:22s} {shape:12s}: "
                      f"{type(e).__name__}: {e}")
                traceback.print_exc(limit=3)
            sys.stdout.flush()
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
