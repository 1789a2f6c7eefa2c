"""Public wrappers for the port's kernels.

A CUDA tensor launches the hand-written Hopper kernel (or raises: there is
no fallback). A CPU tensor runs the kernel's plain PyTorch version from
``kernels.ref`` — that is how the CPU tests exercise the same interface.
``LAUNCHES`` counts kernel launches per wrapper, so a run can show that
its main path went through the kernels.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.kernels import histogram as _hist
from repro_torch.kernels import moe_gemm as _mg
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import rg_lru as _rg
from repro_torch.kernels import topk_router as _tk

LAUNCHES: Dict[str, int] = {"paged_decode_attention": 0, "moe_gemm": 0,
                            "fused_topk_route": 0, "histogram_offsets": 0,
                            "rg_lru_scan": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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
    live expert's once (see ``kernels.moe_gemm``)."""
    if x.device.type == "cpu":
        _mg.check_inputs(x, w_gate, w_up, w_down, slot_experts, activation,
                         row_counts)
        return _ref.moe_gemm_plain(x, w_gate, w_up, w_down, slot_experts,
                                   activation, row_counts)
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
    out = _rg.rg_lru_scan(a, b, h0)
    LAUNCHES["rg_lru_scan"] += 1
    return out
