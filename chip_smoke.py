"""GPU smoke run of the PyTorch/CUDA port (``src/repro_torch``).

Phases, each printing one line of its own numbers; any failure exits
non-zero:

  1. device   — requires a CUDA card; prints nvidia-smi's name and power
                limit; turns TF32 off for fp32 matrix products and cuDNN.
  2. build    — compiles every CUDA kernel from ``src/repro_torch/kernels/
                csrc/`` (one nvcc per source, started together).
  3. kernels  — holds each kernel against its plain PyTorch version on the
                card at the main path's full-width shapes, and times the
                kernel, the plain version, a library call that computes the
                same function (a yardstick only; the port never calls it)
                and the least time the card could take (bound).
  4. main     — serves Mixtral-8x7B at published widths, depth cut to 8 of
                32 layers, with random weights from ``--seed``, through
                ``repro_torch.serve.ContinuousEngine`` (dist_only, ep_ranks
                4); checks completions, tokens, kernel launch counts and
                that a re-plan replicated an expert; then profiles decode
                steps with torch.profiler (device time by kernel, idle
                share) and checks a reduced model's logits on the card
                against the CPU path.

The last lines are the kernels JSON, the card's name and power limit, and
``{"ok": true, "device": {...}}``. Run from the repository root:

    python3 chip_smoke.py [--seed N]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12                 # H100 SXM, fp32 outside the tensor cores
MAIN_LAYERS = 8                    # of Mixtral's 32: 32 bf16 layers ~93 GB > 80 GB


def log(phase: str, **kv) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()),
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush: torch.Tensor, runs: int = 25) -> float:
    """Median of ``runs`` CUDA-event timings of ``fn``, the L2 cache flushed
    (a 256 MiB write) before each run, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


# ---------------------------------------------------------------------------
# phase 3: paged decode attention against its plain version
# ---------------------------------------------------------------------------

def paged_attention_phase(flush: torch.Tensor, seed: int, path_window: int):
    from repro_torch.kernels import ops, ref

    B, K, G, hd, bs, M = 8, 8, 4, 128, 16, 64
    N = 1 + B * M                                        # block 0 = null
    lengths_l = [0, 15, 16, 200, 511, 777, 1000, 1023]   # 0, block edges, ~1023
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = torch.device("cuda")
    perm = torch.randperm(B * M, generator=gen, device=dev).to(torch.int32)
    tables = (1 + perm).reshape(B, M).contiguous()
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
    base = {n: torch.randn(shape, generator=gen, device=dev)
            for n, shape in (("q", (B, K, G, hd)), ("k", (N, bs, K, hd)),
                             ("v", (N, bs, K, hd)))}

    def library(q, kp, vp, window):
        # yardstick: gather the view, expand KV heads, one fused attention
        kv = [ref.gather_view(p, tables).permute(0, 2, 1, 3)
              .repeat_interleave(G, dim=1) for p in (kp, vp)]
        S = kv[0].shape[2]
        pos = torch.arange(S, device=dev)[None, :]
        cl = (lengths + 1)[:, None]
        mask = pos < cl
        if window > 0:
            mask &= pos >= cl - window
        out = torch.nn.functional.scaled_dot_product_attention(
            q.reshape(B, K * G, 1, hd), kv[0], kv[1],
            attn_mask=mask[:, None, None, :])
        return out.reshape(B, K, G, hd)

    tol = {torch.float32: (1e-5, 0.0), torch.bfloat16: (1e-2, 1e-2)}
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, kp, vp = (base[n].to(dtype) for n in ("q", "k", "v"))
        elem = q.element_size()
        for window in (0, 18, path_window):
            got = ops.paged_decode_attention(q, kp, vp, tables, lengths,
                                             window=window)
            want = ref.paged_decode_plain(q, kp, vp, tables, lengths,
                                          window=window)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs()
            atol, rtol = tol[dtype]
            ok = bool((err <= atol + rtol * want.float().abs()).all())
            if not torch.isfinite(got.float()).all():
                ok = False
            cl = np.asarray(lengths_l) + 1
            live = (np.minimum(cl, window) if window > 0 else cl).sum()
            nbytes = (live * K * hd * 2 * elem          # live K and V rows
                      + 2 * q.numel() * elem            # q in, out
                      + lengths.numel() * 4
                      + sum(-(-int(c) // bs) for c in cl) * 4)
            flops = live * K * G * hd * 4               # QK^T and PV
            bound_ms = max(nbytes / HBM_BYTES_PER_S,
                           flops / FP32_FLOPS) * 1e3
            row = {"max_abs_err": float(err.max()), "ok": ok,
                   "bound_ms": bound_ms,
                   "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                                >= flops / FP32_FLOPS else "operations")}
            if dtype == torch.bfloat16:
                row["ms"] = time_ms(lambda: ops.paged_decode_attention(
                    q, kp, vp, tables, lengths, window=window), flush)
                row["plain_ms"] = time_ms(lambda: ref.paged_decode_plain(
                    q, kp, vp, tables, lengths, window=window), flush)
                row["library_ms"] = time_ms(
                    lambda: library(q, kp, vp, window), flush)
            results[(str(dtype).split(".")[-1], window)] = row
            log("kernels", kernel="paged_decode_attention",
                dtype=str(dtype).split(".")[-1], window=window,
                shape=f"B{B}xK{K}xG{G}xhd{hd}xbs{bs}xM{M}",
                **{k: (f"{v:.6g}" if isinstance(v, float) else v)
                   for k, v in row.items()})
    bad = [k for k, r in results.items() if not r["ok"]]
    if bad:
        raise SystemExit(f"paged_decode_attention disagrees with its plain "
                         f"version at {bad}")
    path = results[("bfloat16", path_window)]
    return {
        "name": "paged_decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
        "replaces": "src/repro/kernels/paged_attention.py:97",
        "max_abs_err": max(r["max_abs_err"] for (dt, _), r in results.items()
                           if dt == "bfloat16"),
        "ms": path["ms"], "plain_ms": path["plain_ms"],
        "bound_ms": path["bound_ms"], "bound_by": path["bound_by"],
        "library_ms": path["library_ms"],
    }


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def main_path_phase(seed: int):
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_model
    from repro_torch.serve import (ContinuousConfig, ContinuousEngine,
                                   ServeRequest)

    cfg = dataclasses.replace(get_config("mixtral-8x7b"),
                              num_layers=MAIN_LAYERS)
    log("main", model=cfg.name, d_model=cfg.d_model, heads=cfg.num_heads,
        kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
        d_ff_expert=cfg.moe.d_ff_expert, vocab=cfg.vocab_size,
        window=cfg.sliding_window,
        reduced=f"num_layers 32->{MAIN_LAYERS} (32 bf16 layers ~93 GB > 80 GB)")
    t0 = time.perf_counter()
    model = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                       device="cuda")
    torch.cuda.synchronize()
    log("main", init_s=f"{time.perf_counter() - t0:.3f}",
        weights_gb=f"{torch.cuda.memory_allocated() / 1e9:.3f}")

    ccfg = ContinuousConfig(max_slots=8, prefill_len=512, block_size=16,
                            max_len=1024, strategy="dist_only",
                            predict_interval=4, dup_slots=1)
    eng = ContinuousEngine(cfg, model, ccfg, ep_ranks=4)
    t0 = time.perf_counter()
    eng.warmup()
    log("main", warmup_s=f"{time.perf_counter() - t0:.3f}")

    rng = np.random.default_rng(seed)
    reqs = [ServeRequest(rid=i,
                         tokens=rng.integers(0, cfg.vocab_size,
                                             int(rng.integers(64, 501))
                                             ).astype(np.int32),
                         max_new_tokens=64, arrival=0.02 * i)
            for i in range(16)]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    eng.run_trace(reqs)
    wall = time.perf_counter() - t0
    launches = ops.LAUNCHES["paged_decode_attention"]

    done = eng.scheduler.completed
    s = eng.metrics.summary()
    imb = eng.metrics.imbalance_over_time()
    log("main", requests=len(reqs), completed=len(done),
        iterations=eng.iterations, decode_steps=eng.decode_steps,
        kernel_launches=launches, wall_s=f"{wall:.3f}",
        decode_toks_per_s=f"{s.get('decode_toks_per_s', 0.0):.2f}",
        step_p50_ms=f"{s['step_p50_s'] * 1e3:.3f}",
        ttft_p50_ms=f"{s['ttft_p50'] * 1e3:.3f}",
        replans=int(s["replans"]),
        replicated_replans=int(s["replicated_replans"]),
        modelled_imbalance=f"{float(np.mean(imb)) if imb else 1.0:.4f}",
        peak_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.3f}")
    failures = []
    if len(done) != len(reqs):
        failures.append(f"{len(done)} of {len(reqs)} requests completed")
    for r in done:
        toks = np.asarray(r.generated)
        if len(toks) != r.max_new_tokens or (toks < 0).any() \
                or (toks >= cfg.vocab_size).any():
            failures.append(f"request {r.rid}: bad tokens {toks[:8]}...")
    if launches != eng.decode_steps * cfg.num_layers:
        failures.append(f"kernel launches {launches} != decode steps "
                        f"{eng.decode_steps} x {cfg.num_layers} layers")
    if s["replicated_replans"] < 1:
        failures.append("no re-plan replicated an expert")
    if failures:
        raise SystemExit("main path failed: " + "; ".join(failures))
    profile_phase(eng, cfg, seed)
    del eng, model
    torch.cuda.empty_cache()
    return launches


def profile_phase(eng, cfg, seed: int, iters: int = 12) -> None:
    """Where a decode step's time goes: fill every slot with fresh
    requests, time ``iters`` decode-only iterations on the host clock, then
    ``iters`` more under torch.profiler. Prints the device's busy time by
    kernel and its idle share of the profiled window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as torch_profile

    from repro_torch.serve import ServeRequest

    rng = np.random.default_rng(seed + 1)
    for i in range(eng.ccfg.max_slots):
        eng.submit(ServeRequest(
            rid=1000 + i, max_new_tokens=2 * iters + 8, arrival=0.0,
            tokens=rng.integers(0, cfg.vocab_size, 256).astype(np.int32)))
    now = 0.0
    while eng.scheduler.waiting:                  # admission + prefills
        eng.step(now)
        now += 1.0
    t0 = time.perf_counter()
    for _ in range(iters):
        eng.step(now)
        now += 1.0
    plain_ms = (time.perf_counter() - t0) * 1e3 / iters
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            eng.step(now)
            now += 1.0
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    kernels = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            k = kernels.setdefault(e.name, [0.0, 0])
            k[0] += e.time_range.elapsed_us() / 1e3 / iters
            k[1] += 1
    busy = sum(ms for ms, _ in kernels.values())
    log("profile", decode_iterations=iters, slots=eng.ccfg.max_slots,
        step_ms=f"{plain_ms:.3f}", profiled_step_ms=f"{wall_ms:.3f}",
        device_busy_ms_per_step=f"{busy:.3f}",
        idle_share=f"{1 - busy / wall_ms:.4f}",
        device_ops_per_step=f"{sum(n for _, n in kernels.values()) / iters:.1f}")
    for name, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]:
        log("profile", ms_per_step=f"{ms:.4f}", share=f"{ms / busy:.4f}",
            per_step=f"{n / iters:.1f}", kernel=f"'{name[:90]}'")


def reference_phase(seed: int):
    """Reduced Mixtral on the card (kernel path) against the same weights
    on the CPU (plain path): a prefill and three teacher-forced decode
    steps, logits compared at a bf16 tolerance."""
    from repro_torch.bridge import params_from_jax, params_to_jax
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import Runtime, init_model
    from repro_torch.serve.kvcache import init_block_pool, write_prefill_blocks
    from repro_torch.train.steps import (make_paged_decode_step,
                                         make_slot_prefill_step)

    cfg = get_config("mixtral-8x7b").reduced()
    gpu = init_model(cfg, torch.Generator(device="cuda").manual_seed(seed),
                     device="cuda")
    cpu = params_from_jax(params_to_jax(gpu), cfg, device="cpu")
    rng = np.random.default_rng(seed)
    S, bs, n_dec = 32, 8, 3
    prompt = rng.integers(0, cfg.vocab_size, 20).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, n_dec).astype(np.int32)
    rt = Runtime(window_override=64)
    logits, launches = {}, {}
    for name, model in (("cuda", gpu), ("cpu", cpu)):
        before = ops.LAUNCHES["paged_decode_attention"]
        dev = model.device
        prefill = make_slot_prefill_step(cfg, rt)
        decode = make_paged_decode_step(cfg, rt)
        toks = np.zeros((1, S), np.int32)
        toks[0, :len(prompt)] = prompt
        tw = (np.arange(S) < len(prompt)).astype(np.float32)[None]
        _, lg, temp, _ = prefill(model, torch.tensor(toks, device=dev), None,
                                 torch.tensor([len(prompt) - 1], device=dev),
                                 torch.tensor(tw, device=dev))
        out = [lg.float().cpu()]
        pool = init_block_pool(cfg, 1 + 64 // bs, bs, device=dev)
        table = np.arange(1, 1 + 64 // bs, dtype=np.int32)
        write_prefill_blocks(pool, temp, table[:S // bs])
        for t in range(n_dec):
            ln = torch.tensor([len(prompt) + t], dtype=torch.int32, device=dev)
            _, lg, pool, _ = decode(
                model, torch.tensor([[forced[t]]], device=dev), pool,
                torch.tensor(table[None], device=dev), ln,
                torch.ones((1, 1), device=dev))
            out.append(lg.float().cpu())
        logits[name] = torch.cat(out)
        launches[name] = ops.LAUNCHES["paged_decode_attention"] - before
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    scale = float(logits["cpu"].abs().max())
    ok = (bool(torch.isfinite(logits["cuda"]).all())
          and err <= 5e-2 * max(scale, 1.0)
          and launches == {"cuda": n_dec * cfg.num_layers, "cpu": 0})
    log("reference", model=cfg.name, steps=f"prefill+{n_dec}decode",
        max_abs_err=f"{err:.6g}", logit_scale=f"{scale:.6g}",
        tolerance="5e-2 x max|logit| (bf16 activations, CPU vs GPU sums)",
        kernel_launches=f"cuda:{launches['cuda']},cpu:{launches['cpu']}",
        ok=ok)
    if not ok:
        raise SystemExit("reduced-model logits on the card disagree with the "
                         "CPU path")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "src", "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__} — run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    smi = nvidia_smi()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("device", nvidia_smi=f"'{smi}'", torch=torch.__version__,
        cuda=torch.version.cuda, count=torch.cuda.device_count(),
        tf32="off (cuda.matmul.allow_tf32=False, cudnn.allow_tf32=False)")

    t0 = time.perf_counter()
    logs = build.build_all()
    log("build", seconds=f"{time.perf_counter() - t0:.2f}",
        sources=",".join(build.sources()))
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "bytes stack" in line:
                log("build", kernel=name, ptxas=f"'{line.strip()}'")

    from repro_torch.configs.registry import get_config
    path_window = get_config("mixtral-8x7b").sliding_window
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    kernels = [paged_attention_phase(flush, args.seed, path_window)]
    del flush

    launches = main_path_phase(args.seed)
    kernels[0]["launches"] = launches
    reference_phase(args.seed)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
