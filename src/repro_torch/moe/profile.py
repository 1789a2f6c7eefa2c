"""Per-phase dispatch timing: route / pack / all_to_all / ffn / combine (the
port of the JAX package's ``moe/profile.py``).

One engine step's dispatch runs as one sequence of launches, so the host
cannot split its wall time by phase; this module times each phase as a
callable of its own on representative shapes, on explicit tensors:

  route    router matmul + the ``fused_topk_route`` kernel
  pack     send-buffer construction (``_pack_sort``, the dispatch's path,
           with the ``histogram_offsets`` kernel; ``impl="onehot"`` times
           the one-hot packer the tests keep as the oracle)
  a2a      send -> receive layout transform, materialised (the local cost
           that brackets an all_to_all; the wire is modelled by
           ``core.simulator``)
  ffn      grouped expert FFN on the received block (``moe_gemm``)
  combine  per-assignment gather + gate-weighted reduction

plus the paged decode ``attn`` step (``paged_decode_attention``), the
``migrate`` cost of one replica-fill chunk and its ``prefetch`` (host
issue) cost. Inputs are drawn from ``np.random.default_rng(seed)`` with the
JAX package's draws in its order, so both packages time the same numbers.
A CUDA tensor launches each kernel (``kernels.ops``); a CPU tensor runs
its plain version. Timings are host wall seconds, best of ``iters`` after
a warm call, each ended by ``torch.cuda.synchronize`` on the card.

Used by ``ContinuousEngine.profile_phases`` (the serve-side breakdown fed
into ``ServeMetrics``).
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref as kernel_ref
from repro_torch.moe import dispatch as dsp
from repro_torch.moe.router import route

PHASES = ("route", "pack", "a2a", "ffn", "combine")
# Paid once per plan switch, not per step: kept out of PHASES so per-step
# totals stay a sum of dispatch work.
MIGRATE_PHASE = "migrate"
# The host-side cost of issuing one overlapped fill chunk without waiting:
# what an overlapped fill charges the serving critical path.
PREFETCH_PHASE = "prefetch"
# Paged-decode attention, timed per decode step at serving shapes (not a
# dispatch phase).
ATTN_PHASE = "attn"

PACKERS = {"onehot": dsp._pack_onehot, "sort": dsp._pack_sort}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, *args, iters: int, device: torch.device) -> float:
    fn(*args)                                       # warm
    _sync(device)
    best = math.inf
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        fn(*args)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best


def _normal(rng: np.random.Generator, shape, device: torch.device,
            dtype=torch.float32, scale=None) -> torch.Tensor:
    """``rng.normal(size=shape)`` (times ``scale``) as ``dtype`` on
    ``device``: the draws of one call, made one leading index at a time so
    a weight stack never sits whole in float64 on the host. The scaling
    and the rounding to ``dtype`` are float64 operations on ``device``,
    the same IEEE arithmetic as numpy's."""
    out = torch.empty(shape, dtype=dtype, device=device)
    for i in range(shape[0]):
        a = torch.from_numpy(rng.normal(size=shape[1:])).to(device)
        out[i].copy_(a if scale is None else a * scale)
    return out


# ---------------------------------------------------------------------------
# dispatch phases
# ---------------------------------------------------------------------------

def dispatch_inputs(*, d_model: int, d_ff: int, num_experts: int,
                    tokens: int, seed: int, device="cuda") -> dict:
    """The dispatch profile's inputs, the JAX draws in their order: tokens
    x (T, d), the router (d, E) and the identity plan's slot weights
    {w_gate, w_up: (E, d, F); w_down: (E, F, d)}, all fp32."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    T, E, d, F = tokens, num_experts, d_model, d_ff
    x = _normal(rng, (T, d), dev)
    w_router = _normal(rng, (d, E), dev, scale=0.02)
    slot_w = {"w_gate": _normal(rng, (E, d, F), dev, scale=0.02),
              "w_up": _normal(rng, (E, d, F), dev, scale=0.02),
              "w_down": _normal(rng, (E, F, d), dev, scale=0.02)}
    return {"x": x, "w_router": w_router, "slot_w": slot_w}


def dispatch_chain(x, w_router, slot_w, *, top_k: int, ranks: int,
                   capacity_factor: float = 1.25, impl: str = "sort",
                   activation: str = "swiglu"
                   ) -> Tuple[Dict[str, Tuple[Callable, tuple]], dict]:
    """Run route -> pack -> a2a -> ffn -> combine once on one packing rank.

    Experts map to slots identity-style (slot == expert), so the shapes are
    those of an EP deployment of ``ranks`` ranks hosting ``E / ranks`` home
    experts each. Returns ({phase: (fn, args)}, outputs): each phase's
    callable with the inputs it was run on (for timing), and the outputs
    (``route`` the RouterOutput, ``send`` / ``in_cap`` / ``dest`` /
    ``counts`` the packer's, ``recv`` the transformed block, ``ys`` the
    FFN's (S * cap, d) rows, ``y`` the combined (T, d) output)."""
    T, d = x.shape
    E = w_router.shape[1]
    if E % ranks:
        ranks = 1
    K, S = top_k, E
    N = T * K
    n_slots = S // ranks
    cap = dsp.capacity(T, K, S, capacity_factor)
    dev = x.device
    moe = MoEConfig(num_experts=E, top_k=K, d_ff_expert=slot_w["w_up"].shape[2],
                    capacity_factor=capacity_factor)
    token_of = torch.arange(N, device=dev) // K
    valid = torch.ones((1, N), dtype=torch.bool, device=dev)
    slot_map = torch.arange(S, dtype=torch.int32, device=dev)
    pack = PACKERS[impl]

    def route_fn(w, t):
        return route(w, moe, t)

    def pack_fn(x_, g_):
        return pack(x_[None], token_of, g_[None], valid, num_classes=S,
                    cap=cap)

    def a2a_fn(s):
        # send (S*cap, d) -> per-rank (ranks, n_slots*cap, d) -> received
        # (n_slots, ranks*cap, d): the two reshuffles around the wire
        r = s.reshape(ranks, n_slots, cap, d)
        return r.transpose(0, 1).contiguous().view(n_slots, ranks * cap, d)

    out = {"route": route_fn(w_router, x)}
    gslot = out["route"].expert_idx.reshape(-1)     # identity slot mapping
    gates = out["route"].gates
    send, in_cap, dest, counts, _ = pack_fn(x, gslot)
    send, in_cap, dest = send[0], in_cap[0], dest[0]
    row_counts = counts.T.contiguous()              # (S, 1) live rows
    out.update(send=send, in_cap=in_cap, dest=dest, counts=counts[0])
    out["recv"] = a2a_fn(send)
    recv = send.reshape(S, cap, d)                  # full-slot view for ffn

    def ffn_fn(r):
        return kernel_ops.moe_gemm(r, slot_w["w_gate"], slot_w["w_up"],
                                   slot_w["w_down"], slot_map, activation,
                                   row_counts=row_counts)

    ys = ffn_fn(recv).reshape(S * cap, d)
    out["ys"] = ys

    def combine_fn(y_recv, g):
        rows = y_recv[torch.clamp(dest, max=S * cap - 1)]
        y_flat = torch.where(in_cap[:, None], rows,
                             torch.zeros((), dtype=rows.dtype, device=dev))
        return (y_flat.reshape(T, K, d) * g[..., None]).sum(dim=1)

    out["y"] = combine_fn(ys, gates)
    phases = {"route": (route_fn, (w_router, x)),
              "pack": (pack_fn, (x, gslot)),
              "a2a": (a2a_fn, (send,)),
              "ffn": (ffn_fn, (recv,)),
              "combine": (combine_fn, (ys, gates))}
    return phases, out


def dispatch_phase_times(*, d_model: int = 256, d_ff: int = 256,
                         num_experts: int = 64, top_k: int = 2,
                         tokens: int = 2048, ranks: int = 4,
                         capacity_factor: float = 1.25,
                         impl: str = "sort", activation: str = "swiglu",
                         iters: int = 5, seed: int = 0,
                         device="cuda", inputs=None) -> Dict[str, float]:
    """Time each dispatch phase on one device. Returns seconds per phase
    plus ``"total"``; ``impl`` selects the pack formulation; ``inputs``
    are ``dispatch_inputs``' (drawn here when not given)."""
    if inputs is None:
        inputs = dispatch_inputs(d_model=d_model, d_ff=d_ff,
                                 num_experts=num_experts, tokens=tokens,
                                 seed=seed, device=device)
    dev = inputs["x"].device
    phases, _ = dispatch_chain(inputs["x"], inputs["w_router"],
                               inputs["slot_w"], top_k=top_k, ranks=ranks,
                               capacity_factor=capacity_factor, impl=impl,
                               activation=activation)
    times = {p: _time(fn, *args, iters=iters, device=dev)
             for p, (fn, args) in phases.items()}
    times["total"] = sum(times[p] for p in PHASES)
    return times


def pack_impl_times(*, d_model: int = 256, num_experts: int = 64,
                    top_k: int = 2, tokens: int = 4096,
                    capacity_factor: float = 1.25, iters: int = 10,
                    seed: int = 0, device="cuda") -> Dict[str, float]:
    """Head-to-head pack-phase timing: both packers on identical inputs,
    measured interleaved round by round so drift hits both equally.
    Returns {"sort": s, "onehot": s} best-of-``iters``."""
    dev = resolve_device(device)
    inputs = pack_inputs(d_model=d_model, num_experts=num_experts,
                         top_k=top_k, tokens=tokens, seed=seed, device=dev)
    x, gslot = inputs["x"], inputs["gslot"]
    S = num_experts
    N = tokens * top_k
    cap = dsp.capacity(tokens, top_k, S, capacity_factor)
    token_of = torch.arange(N, device=dev) // top_k
    valid = torch.ones((1, N), dtype=torch.bool, device=dev)
    fns = {impl: (lambda p=pack: p(x[None], token_of, gslot[None], valid,
                                   num_classes=S, cap=cap))
           for impl, pack in PACKERS.items()}
    for fn in fns.values():
        fn()                                         # warm
    _sync(dev)
    best = {impl: math.inf for impl in fns}
    for _ in range(max(iters, 1)):
        for impl, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            best[impl] = min(best[impl], time.perf_counter() - t0)
    return best


def pack_inputs(*, d_model: int, num_experts: int, top_k: int, tokens: int,
                seed: int, device="cuda") -> dict:
    """``pack_impl_times``' inputs, the JAX draws: x (T, d) fp32 and a
    uniform slot per (token, k), (N,) int32."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    x = _normal(rng, (tokens, d_model), dev)
    gslot = torch.from_numpy(rng.integers(0, num_experts, tokens * top_k)
                             .astype(np.int32)).to(dev)
    return {"x": x, "gslot": gslot}


# ---------------------------------------------------------------------------
# replica migration
# ---------------------------------------------------------------------------

def migrate_inputs(*, d_model: int, d_ff: int, num_experts: int, ranks: int,
                   dup_slots: int, layers: int, chunk: int, seed: int,
                   device="cuda") -> dict:
    """The migration profile's inputs, the JAX draws in their order: the
    home experts {name: [(E, ...)] * L} fp32 and one chunk of (layer,
    dst_slot, src_expert) entries (host int32 arrays) aimed at replica
    slots."""
    dev = resolve_device(device)
    if num_experts % ranks:
        ranks = 1
    rng = np.random.default_rng(seed)
    E, L = num_experts, layers
    shapes = {"w_gate": (E, d_model, d_ff), "w_up": (E, d_model, d_ff),
              "w_down": (E, d_ff, d_model)}
    experts = {k: [_normal(rng, shape, dev, scale=0.02) for _ in range(L)]
               for k, shape in shapes.items()}
    n_slots = E // ranks + dup_slots
    layer = rng.integers(0, L, chunk).astype(np.int32)
    dst = (rng.integers(0, ranks, chunk) * n_slots + E // ranks
           + rng.integers(0, dup_slots, chunk)).astype(np.int32)
    src = rng.integers(0, E, chunk).astype(np.int32)
    return {"experts": experts, "layer": layer, "dst": dst, "src": src,
            "ranks": ranks}


def migrate_phase_time(*, d_model: int = 256, d_ff: int = 256,
                       num_experts: int = 64, ranks: int = 4,
                       dup_slots: int = 1, layers: int = 2, chunk: int = 8,
                       iters: int = 5, seed: int = 0,
                       device="cuda", inputs=None) -> Dict[str, float]:
    """Device cost of ONE replica-migration chunk (the row copies from home
    rows into back rows of a ``runtime.ReplicaStore``, on a side stream on
    the card) at representative shapes, plus the host cost of merely
    ISSUING it without waiting (the ``prefetch`` phase, the only part an
    overlapped fill charges the serving critical path). The wire term is
    modelled by ``runtime.cost``. Returns {"migrate": s, "prefetch": s}.

    The port's store holds the home experts in its own rows, so the copies
    read the store's home rows where the JAX step reads a separate expert
    stack. ``inputs`` are ``migrate_inputs``' (drawn here when not given;
    left as they were, so a caller may time them again)."""
    from repro_torch.core.placement import identity_plan, stack_plans
    from repro_torch.runtime import ReplicaStore, make_migrate_step

    if inputs is None:
        inputs = migrate_inputs(d_model=d_model, d_ff=d_ff,
                                num_experts=num_experts, ranks=ranks,
                                dup_slots=dup_slots, layers=layers,
                                chunk=chunk, seed=seed, device=device)
    inp = dict(inputs)
    experts = inp.pop("experts")
    dev = experts["w_up"][0].device
    R = inp["ranks"]
    plan = stack_plans([identity_plan(num_experts, R, dup_slots, 4)
                        for _ in range(layers)])
    store = ReplicaStore.from_params(experts, plan, num_experts=num_experts,
                                     ep_ranks=R, dup_slots=dup_slots)
    del experts
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    step = make_migrate_step(store, stream)
    args = (inp["layer"], inp["dst"], inp["src"])
    t = _time(step, *args, iters=iters, device=dev)
    best_issue = math.inf
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        step(*args)
        best_issue = min(best_issue, time.perf_counter() - t0)
        _sync(dev)                       # drain before the next round
    return {MIGRATE_PHASE: t, PREFETCH_PHASE: best_issue}


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

def _paged_attn_inputs(*, batch: int, num_kv: int, gqa: int, head_dim: int,
                       block_size: int, max_blocks: int, valid_frac: float,
                       dtype, seed: int, device="cuda"):
    """Representative paged-decode state: every slot holds a full
    ``max_blocks`` table row but only ``valid_frac`` of it holds live
    tokens. Returns q (B, K, G, hd), k_pool, v_pool (1 + B*M, bs, K, hd),
    tables (B, M) int32 and lengths (B,) int32."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    B, bs, K, hd, M = batch, block_size, num_kv, head_dim, max_blocks
    N = 1 + B * M                                    # block 0 = null
    q = _normal(rng, (B, K, gqa, hd), dev, dtype)
    k_pool = _normal(rng, (N, bs, K, hd), dev, dtype)
    v_pool = _normal(rng, (N, bs, K, hd), dev, dtype)
    tables = torch.from_numpy(
        1 + np.arange(B * M, dtype=np.int32).reshape(B, M)).to(dev)
    valid = max(1, int(M * bs * valid_frac))
    lengths = torch.from_numpy(rng.integers(max(1, valid // 2), valid,
                                            size=B).astype(np.int32)).to(dev)
    return q, k_pool, v_pool, tables, lengths


def _attn_fns(q, tables, lengths, window: int):
    B, K, _, hd = q.shape

    def fused(q_, k_, v_):
        return kernel_ops.paged_decode_attention(q_, k_, v_, tables, lengths,
                                                 window=window)

    def gather(q_, k_, v_):
        k_view = k_[tables].reshape(B, -1, K, hd)
        v_view = v_[tables].reshape(B, -1, K, hd)
        return kernel_ref.paged_decode_ref(q_, k_view, v_view, lengths,
                                           window=window,
                                           block_size=k_.shape[1])
    return {"fused": fused, "gather": gather}


def attn_phase_times(*, batch: int = 8, num_kv: int = 8, gqa: int = 4,
                     head_dim: int = 128, block_size: int = 16,
                     max_blocks: int = 32, valid_frac: float = 0.25,
                     window: int = 0, impl: str = "fused",
                     dtype=torch.bfloat16, iters: int = 5, seed: int = 0,
                     device="cuda") -> Dict[str, float]:
    """Time one paged-decode attention step at serving shapes. Returns
    ``{"attn": seconds}`` for ``impl`` ("fused": the kernel; "gather":
    materialise the table view, then attend, the what-if)."""
    q, k_pool, v_pool, tables, lengths = _paged_attn_inputs(
        batch=batch, num_kv=num_kv, gqa=gqa, head_dim=head_dim,
        block_size=block_size, max_blocks=max_blocks,
        valid_frac=valid_frac, dtype=dtype, seed=seed, device=device)
    fn = _attn_fns(q, tables, lengths, window)[impl]
    return {ATTN_PHASE: _time(fn, q, k_pool, v_pool, iters=iters,
                              device=q.device)}


def attn_impl_times(*, batch: int = 8, num_kv: int = 8, gqa: int = 4,
                    head_dim: int = 128, block_size: int = 16,
                    max_blocks: int = 32, valid_frac: float = 0.25,
                    window: int = 0, dtype=torch.bfloat16, iters: int = 5,
                    seed: int = 0, device="cuda") -> Dict[str, float]:
    """Head-to-head paged-decode attention timing, the fused kernel against
    the materialise-then-attend gather on identical pool state, measured
    interleaved round by round. Returns {"fused": s, "gather": s}."""
    q, k_pool, v_pool, tables, lengths = _paged_attn_inputs(
        batch=batch, num_kv=num_kv, gqa=gqa, head_dim=head_dim,
        block_size=block_size, max_blocks=max_blocks,
        valid_frac=valid_frac, dtype=dtype, seed=seed, device=device)
    dev = q.device
    fns = _attn_fns(q, tables, lengths, window)
    for fn in fns.values():
        fn(q, k_pool, v_pool)                        # warm
    _sync(dev)
    best = {impl: math.inf for impl in fns}
    for _ in range(max(iters, 1)):
        for impl, fn in fns.items():
            t0 = time.perf_counter()
            fn(q, k_pool, v_pool)
            _sync(dev)
            best[impl] = min(best[impl], time.perf_counter() - t0)
    return best
