"""Public wrappers for the port's kernels.

A CUDA tensor launches the hand-written Hopper kernel (or raises: there is
no fallback). A CPU tensor runs the kernel's plain PyTorch version from
``kernels.ref`` — that is how the CPU tests exercise the same interface.
A ``meta`` tensor (the dry run, ``launch.dryrun``, which executes nothing)
gets empty ``meta`` outputs of the kernel's shapes and dtypes, and the
kernel's bytes and operations are added to ``kernels.work.KERNEL_WORK``
(the formulas of its bound; the most the shapes allow where they depend on
the data): the dry run describes the card's path, which runs the kernel.
``LAUNCHES`` counts kernel launches per wrapper, so a run can show that
its main path went through the kernels.

The router, the scan and the grouped expert FFN also have a backward
kernel, and the autograd ``Function``s ``FusedTopkRoute``, ``RgLruScan``
and ``MoeGemm`` run each forward wrapper and, on the way back, the backward
wrapper, which dispatches the same way: the kernel on a CUDA tensor, the
plain version on a CPU tensor. Without a graph to record (``torch.no_grad``,
``inference_mode``) a ``Function`` launches what its forward wrapper
launches and nothing else.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import histogram as _hist
from repro_torch.kernels import moe_gemm as _mg
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rg_lru as _rg
from repro_torch.kernels import topk_router as _tk
from repro_torch.kernels import work as _work

LAUNCHES: Dict[str, int] = {"paged_decode_attention": 0, "moe_gemm": 0,
                            "fused_topk_route": 0, "histogram_offsets": 0,
                            "rg_lru_scan": 0, "fused_topk_route_bwd": 0,
                            "rg_lru_scan_bwd": 0, "moe_gemm_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _meta(t) -> bool:
    return t.device.type == "meta"


def _empty(shape, dtype, like):
    return torch.empty(tuple(shape), dtype=dtype, device=like.device)


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           window: int = 0):
    """Fused paged GQA decode over the shared KV block pool.

    Replaces the TPU kernel ``src/repro/kernels/paged_attention.py``
    (``paged_decode_attention``). q: (B, K, G, hd) — query heads grouped by
    their KV head; k_pool/v_pool: (N_blocks, bs, K, hd), block 0 the null
    block; block_tables: (B, M) int32; lengths: (B,) int32. Returns
    (B, K, G, hd) in q's dtype. On the card the kernel is bound by the live
    K/V bytes it reads (see ``kernels.paged_attention``). One call is two
    device launches, a split pass and a combine pass, and counts once in
    ``LAUNCHES``."""
    if q.device.type == "cpu":
        _pa.check_inputs(q, k_pool, v_pool, block_tables, lengths)
        return _ref.paged_decode_plain(q, k_pool, v_pool, block_tables,
                                       lengths, window=window)
    if _meta(q):
        _pa.check_inputs(q, k_pool, v_pool, block_tables, lengths)
        B, K, G, hd = q.shape
        bs, M = k_pool.shape[1], block_tables.shape[1]
        _work.add_kernel_work("paged_decode_attention", *_work.paged_decode_work(
            B, K, G, hd, q.element_size(), [M * bs - 1] * B, bs, window))
        return _empty(q.shape, q.dtype, q)
    out = _pa.paged_decode_attention(q, k_pool, v_pool, block_tables,
                                     lengths, window=window)
    LAUNCHES["paged_decode_attention"] += 1
    return out


def moe_gemm(x, w_gate, w_up, w_down, slot_experts, activation="swiglu",
             row_counts=None):
    """Grouped expert FFN of the EP dispatch, every slot in one call.

    Replaces the TPU kernel ``src/repro/kernels/moe_gemm.py``
    (``moe_gemm``). x: (S, T, d) rows received by each slot; w_gate / w_up:
    (E, d, F) expert weights (``w_gate`` None: ``w_up``, for gelu / relu);
    w_down: (E, F, d); slot_experts: (S,) int32, the expert slot s computes
    with (outside [0, E): zeros); row_counts: None (every row live) or
    (S, B) int32 with B dividing T, where rows ``[b*T/B, b*T/B +
    row_counts[s, b])`` of slot s are live and every other row gives zeros.
    Returns (S, T, d) in x's dtype. Bound by the weight bytes read, each
    live expert's once (see ``kernels.moe_gemm``). While autograd records
    and x or a weight requires a gradient, the call goes through
    ``MoeGemm`` (its way back is ``moe_gemm_bwd``); otherwise, as in
    serving, the forward alone."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, w_gate, w_up, w_down)):
        return MoeGemm.apply(x, w_gate, w_up, w_down, slot_experts,
                             activation, row_counts)
    return _moe_gemm(x, w_gate, w_up, w_down, slot_experts, activation,
                     row_counts)


def _moe_gemm(x, w_gate, w_up, w_down, slot_experts, activation,
              row_counts):
    if x.device.type == "cpu":
        _mg.check_inputs(x, w_gate, w_up, w_down, slot_experts, activation,
                         row_counts)
        return _ref.moe_gemm_plain(x, w_gate, w_up, w_down, slot_experts,
                                   activation, row_counts)
    if _meta(x):
        _mg.check_inputs(x, w_gate, w_up, w_down, slot_experts, activation,
                         row_counts)
        S, T, d = x.shape
        E, _, F = w_up.shape
        _work.add_kernel_work("moe_gemm", *_work.moe_gemm_work(
            S, d, F, w_up.element_size(), S * T, min(S, E),
            0 if row_counts is None else row_counts.numel(),
            activation == "swiglu"))
        return _empty(x.shape, x.dtype, x)
    out = _mg.moe_gemm(x, w_gate, w_up, w_down, slot_experts, activation,
                       row_counts)
    LAUNCHES["moe_gemm"] += 1
    return out


def fused_topk_route(logits, top_k: int):
    """Softmax, top-k (ties to the lowest index), logsumexp and expert
    counts in one pass over (R, T, E) fp32 logits, R independent batches
    (EP ranks).

    Replaces the TPU kernel ``src/repro/kernels/topk_router.py``
    (``fused_topk_route``). Returns idx (R, T, K) int32, un-normalised
    gates (R, T, K), probs (R, T, E), lse (R, T) and counts (R, E) int32."""
    if logits.device.type == "cpu":
        _tk.check_inputs(logits, top_k)
        return _ref.fused_topk_route_plain(logits, top_k)
    if _meta(logits):
        _tk.check_inputs(logits, top_k)
        *lead, T, E = logits.shape
        R = int(torch.Size(lead).numel())
        _work.add_kernel_work("fused_topk_route",
                              *_work.fused_topk_route_work(R, T, E, top_k))
        f32, i32 = torch.float32, torch.int32
        return (_empty((*lead, T, top_k), i32, logits),
                _empty((*lead, T, top_k), f32, logits),
                _empty((*lead, T, E), f32, logits),
                _empty((*lead, T), f32, logits),
                _empty((*lead, E), i32, logits))
    out = _tk.fused_topk_route(logits, top_k)
    LAUNCHES["fused_topk_route"] += 1
    return out


def histogram_offsets(ids, num_classes: int):
    """Class counts of each row of (R, N) int32 ids and their exclusive
    prefix sums, (R, num_classes) int32 each; ids outside the classes are
    not counted.

    Replaces the TPU kernel ``src/repro/kernels/histogram.py``
    (``histogram_offsets``)."""
    if ids.device.type == "cpu":
        _hist.check_inputs(ids, num_classes)
        return _ref.histogram_offsets_plain(ids, num_classes)
    if _meta(ids):
        _hist.check_inputs(ids, num_classes)
        *lead, N = ids.shape
        R = int(torch.Size(lead).numel())
        _work.add_kernel_work("histogram_offsets",
                              *_work.histogram_offsets_work(R, N,
                                                            num_classes))
        return tuple(_empty((*lead, num_classes), torch.int32, ids)
                     for _ in range(2))
    out = _hist.histogram_offsets(ids, num_classes)
    LAUNCHES["histogram_offsets"] += 1
    return out


def rg_lru_scan(a, b, h0):
    """The RG-LRU linear recurrence ``h_t = a_t * h_{t-1} + b_t`` per
    channel, fp32 carry from ``h0``.

    Replaces the TPU kernel ``src/repro/kernels/rg_lru.py``
    (``rg_lru_scan``). a, b: (B, S, D) fp32; h0: (B, D) fp32. Returns
    (h_all (B, S, D), h_last (B, D)). Bound by the bytes it reads and
    writes (see ``kernels.rg_lru``)."""
    if a.device.type == "cpu":
        _rg.check_inputs(a, b, h0)
        return _ref.rg_lru_scan_plain(a, b, h0)
    if _meta(a):
        _rg.check_inputs(a, b, h0)
        B, S, D = a.shape
        _work.add_kernel_work("rg_lru_scan", *_work.rg_lru_scan_work(B, S, D))
        return (_empty(a.shape, torch.float32, a),
                _empty(h0.shape, torch.float32, a))
    out = _rg.rg_lru_scan(a, b, h0)
    LAUNCHES["rg_lru_scan"] += 1
    return out


def fused_topk_route_bwd(probs, idx, d_gates, d_probs, d_lse):
    """``d_logits`` (..., T, E) fp32 of ``fused_topk_route``'s gates, probs
    and lse: ``probs * (dp - sum(probs * dp)) + probs * d_lse`` with ``dp =
    d_probs + scatter_add(idx, d_gates)``. Any of the three gradients may
    be None (zeros). Not a port of a Pallas kernel: the gradient ``jax.grad``
    takes through the JAX package's dense ``route``, written by hand
    because the forward is a kernel (see ``kernels.topk_router``)."""
    if probs.device.type == "cpu":
        _tk.check_bwd_inputs(probs, idx, d_gates, d_probs, d_lse)
        return _ref.fused_topk_route_bwd_plain(probs, idx, d_gates, d_probs,
                                               d_lse)
    if _meta(probs):
        _tk.check_bwd_inputs(probs, idx, d_gates, d_probs, d_lse)
        *lead, T, E = probs.shape
        _work.add_kernel_work("fused_topk_route_bwd",
                              *_work.fused_topk_route_bwd_work(
                                  int(torch.Size(lead).numel()), T, E,
                                  idx.shape[-1]))
        return _empty(probs.shape, torch.float32, probs)
    out = _tk.fused_topk_route_bwd(probs, idx, d_gates, d_probs, d_lse)
    LAUNCHES["fused_topk_route_bwd"] += 1
    return out


def rg_lru_scan_bwd(a, h_all, h0, d_h_all, d_h_last):
    """The gradient of ``rg_lru_scan``: the reverse-time recurrence
    ``g_t = d_h_all[t] + a_{t+1} * g_{t+1}`` from ``g_{S-1} = d_h_all[S-1]
    + d_h_last``, giving ``d_a_t = g_t * h_{t-1}``, ``d_b_t = g_t`` and
    ``d_h0 = a_0 * g_0``; ``d_h_all`` / ``d_h_last`` may be None (zeros).
    Not a port of a Pallas kernel: the gradient ``jax.grad`` takes through
    the JAX package's associative scan (see ``kernels.rg_lru``). Returns
    (d_a, d_b, d_h0), fp32."""
    if a.device.type == "cpu":
        _rg.check_bwd_inputs(a, h_all, h0, d_h_all, d_h_last)
        return _ref.rg_lru_scan_bwd_plain(a, h_all, h0, d_h_all, d_h_last)
    if _meta(a):
        _rg.check_bwd_inputs(a, h_all, h0, d_h_all, d_h_last)
        B, S, D = a.shape
        _work.add_kernel_work("rg_lru_scan_bwd",
                              *_work.rg_lru_scan_bwd_work(B, S, D))
        return (_empty(a.shape, torch.float32, a),
                _empty(a.shape, torch.float32, a),
                _empty(h0.shape, torch.float32, a))
    out = _rg.rg_lru_scan_bwd(a, h_all, h0, d_h_all, d_h_last)
    LAUNCHES["rg_lru_scan_bwd"] += 1
    return out


def moe_gemm_bwd(x, w_gate, w_up, w_down, slot_experts, dy,
                 activation="swiglu", row_counts=None):
    """The gradient of ``moe_gemm`` given ``dy`` (S, T, d): (dx (S, T, d),
    d_w_gate (E, d, F) or None without swiglu, d_w_up, d_w_down), in x's
    dtype. The hidden activations are recomputed, not kept; the weight
    gradients sum over every live row of every slot that names the row, in
    slot order (no atomics: repeated calls are bit-identical); dead rows
    give ``dx = 0`` and add nothing. Not a port of a Pallas kernel: the
    gradient ``jax.grad`` takes through the JAX package's einsum
    ``grouped_ffn``, written by hand because the forward is a kernel. On the
    card one call is seven device launches (the packed layout, the packed
    x and dy, dh, the hidden gradient, dx, the gate / up weight gradients
    and the down weight gradient; five on the FMA path of fp32 or unaligned
    rows, which packs nothing; see ``csrc/moe_gemm_bwd.cu``), counted once
    in ``LAUNCHES``."""
    if x.device.type == "cpu":
        _mg.check_bwd_inputs(x, w_gate, w_up, w_down, slot_experts, dy,
                             activation, row_counts)
        return _ref.moe_gemm_bwd_plain(x, w_gate, w_up, w_down, slot_experts,
                                       dy, activation, row_counts)
    if _meta(x):
        _mg.check_bwd_inputs(x, w_gate, w_up, w_down, slot_experts, dy,
                             activation, row_counts)
        S, T, d = x.shape
        E, _, F = w_up.shape
        gated = activation == "swiglu"
        _work.add_kernel_work("moe_gemm_bwd", *_work.moe_gemm_bwd_work(
            S, T, d, F, E, x.element_size(), S * T, min(S, E),
            0 if row_counts is None else row_counts.numel(), gated))
        wd = w_up.dtype
        return (_empty(x.shape, x.dtype, x),
                _empty(w_up.shape, wd, x) if gated else None,
                _empty(w_up.shape, wd, x), _empty(w_down.shape, wd, x))
    out = _mg.moe_gemm_bwd(x, w_gate, w_up, w_down, slot_experts, dy,
                           activation, row_counts)
    LAUNCHES["moe_gemm_bwd"] += 1
    return out


def _contiguous(t):
    return None if t is None else t.contiguous()


class FusedTopkRoute(torch.autograd.Function):
    """``fused_topk_route`` with a gradient: ``apply(logits, top_k)``
    returns its five outputs; idx and counts are integers and carry none,
    and the gradients of gates, probs and lse reach the logits through
    ``fused_topk_route_bwd``. Saves probs and idx."""

    @staticmethod
    def forward(ctx, logits, top_k: int):
        idx, gates, probs, lse, counts = fused_topk_route(logits, top_k)
        ctx.mark_non_differentiable(idx, counts)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(probs, idx)
        return idx, gates, probs, lse, counts

    @staticmethod
    def backward(ctx, _d_idx, d_gates, d_probs, d_lse, _d_counts):
        if d_gates is None and d_probs is None and d_lse is None:
            return None, None
        probs, idx = ctx.saved_tensors
        return fused_topk_route_bwd(probs, idx, _contiguous(d_gates),
                                    _contiguous(d_probs),
                                    _contiguous(d_lse)), None


class RgLruScan(torch.autograd.Function):
    """``rg_lru_scan`` with a gradient: ``apply(a, b, h0)`` returns
    (h_all, h_last), and the way back runs ``rg_lru_scan_bwd``. Saves a,
    h_all and h0 (the backward never reads b)."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h_all, h_last = rg_lru_scan(a, b, h0)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(a, h_all, h0)
        return h_all, h_last

    @staticmethod
    def backward(ctx, d_h_all, d_h_last):
        if d_h_all is None and d_h_last is None:
            return None, None, None
        a, h_all, h0 = ctx.saved_tensors
        d_a, d_b, d_h0 = rg_lru_scan_bwd(a, h_all, h0, _contiguous(d_h_all),
                                         _contiguous(d_h_last))
        return d_a, d_b, d_h0 if ctx.needs_input_grad[2] else None


class MoeGemm(torch.autograd.Function):
    """``moe_gemm`` with a gradient: ``apply(x, w_gate, w_up, w_down,
    slot_experts, activation, row_counts)`` returns its output, and the way
    back runs ``moe_gemm_bwd``, which returns the gradients of x and the
    three weight tensors (``w_gate`` None: none for it); the slot map and
    the counts are integers and get none. Saves the inputs only: the
    backward recomputes the (S, T, F) hidden activations."""

    @staticmethod
    def forward(ctx, x, w_gate, w_up, w_down, slot_experts, activation,
                row_counts):
        ctx.set_materialize_grads(False)
        ctx.activation = activation
        ctx.save_for_backward(x, w_gate, w_up, w_down, slot_experts,
                              row_counts)
        return _moe_gemm(x, w_gate, w_up, w_down, slot_experts, activation,
                         row_counts)

    @staticmethod
    def backward(ctx, dy):
        if dy is None:
            return (None,) * 7
        x, w_gate, w_up, w_down, slot_experts, row_counts = ctx.saved_tensors
        dx, d_gate, d_up, d_down = moe_gemm_bwd(
            x, w_gate, w_up, w_down, slot_experts, dy.contiguous(),
            ctx.activation, row_counts)
        need = ctx.needs_input_grad
        if w_gate is None:
            d_gate = None
        return (dx if need[0] else None, d_gate if need[1] else None,
                d_up if need[2] else None, d_down if need[3] else None,
                None, None, None)
