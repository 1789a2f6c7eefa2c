"""The work of each kernel: the bytes it must move (each input read once,
each output written once) and the operations it does, as ``(nbytes,
flops)``. ``chip_smoke.py`` divides them by the card's rates for each
kernel's bound; the dry run (``launch.dryrun``) adds them up for the
kernels a ``meta`` step calls (``kernels.ops``' ``meta`` branches), in
``KERNEL_WORK``.

Where the work depends on the data (the live rows of a grouped FFN, a
paged slot's length), the caller passes what its data needs; on ``meta``
there is no data, and the wrappers pass the most the shapes allow (every
row live, every slot at its table's length).
"""

from __future__ import annotations

from typing import Dict

KERNEL_WORK: Dict[str, Dict[str, float]] = {}


def reset_kernel_work() -> None:
    KERNEL_WORK.clear()


def add_kernel_work(name: str, nbytes: float, flops: float) -> None:
    """One ``meta`` call of kernel ``name``: its bytes and operations."""
    w = KERNEL_WORK.setdefault(name, {"calls": 0, "bytes": 0.0,
                                      "flops": 0.0})
    w["calls"] += 1
    w["bytes"] += float(nbytes)
    w["flops"] += float(flops)


def paged_decode_work(B: int, K: int, G: int, hd: int, elem: int,
                      lengths, block_size: int, window: int = 0):
    """``paged_decode_attention`` over slots of ``lengths`` (the positions
    before each token): the live K and V rows, q in and out, the lengths
    and each slot's live block-table entries read once; QK^T and PV over
    the live rows."""
    cl = [int(n) + 1 for n in lengths]
    live = sum(min(c, window) if window > 0 else c for c in cl)
    nbytes = (live * K * hd * 2 * elem + 2 * B * K * G * hd * elem
              + len(cl) * 4 + sum(-(-c // block_size) for c in cl) * 4)
    return nbytes, live * K * G * hd * 4


def moe_gemm_work(S: int, d: int, F: int, elem: int, n_live: int,
                  live_experts: int, n_counts: int, gated: bool):
    """``moe_gemm`` with ``n_live`` live rows over ``S`` slots: each live
    expert's matrices read once (three under swiglu, else two), its rows
    read and written once, the counts and the slot map read; three (two)
    products of 2 d F operations a live row."""
    matrix = (3 if gated else 2) * d * F * elem
    nbytes = live_experts * matrix + 2 * n_live * d * elem \
        + n_counts * 4 + S * 4
    return nbytes, (6.0 if gated else 4.0) * n_live * d * F


def fused_topk_route_work(R: int, T: int, E: int, K: int):
    """``fused_topk_route``: the logits read, probs written (E each), idx
    and gates written (K each), lse written, counts written; per element
    a max, an exp, a sum and a divide, and K rounds of a compare and a
    select."""
    return 4 * (2 * R * T * E + 2 * R * T * K + R * T + R * E), \
        R * T * E * (4 + 2 * K)


def histogram_offsets_work(R: int, N: int, C: int):
    """``histogram_offsets``: the ids read, counts and starts written; one
    add an id and one a class."""
    return 4 * (R * N + 2 * R * C), R * (N + C)


def rg_lru_scan_work(B: int, S: int, D: int):
    """``rg_lru_scan``: a and b read once, every h written once, h0 read,
    h_last written; one product and one sum per element."""
    return 4 * (3 * B * S * D + 2 * B * D), 2 * B * S * D


def fused_topk_route_bwd_work(R: int, T: int, E: int, K: int):
    """``fused_topk_route_bwd``: probs, d_probs read and d_logits written (E
    each), idx and d_gates read (K each), d_lse read; per element a
    product, a difference, two more products, a sum and the reduction's
    add."""
    return 4 * (3 * R * T * E + 2 * R * T * K + R * T), 6 * R * T * E


def rg_lru_scan_bwd_work(B: int, S: int, D: int):
    """``rg_lru_scan_bwd``: a, h_all and d_h_all read, d_a and d_b written;
    h0 and d_h_last read, d_h0 written; a product, a sum and a product per
    element."""
    return 4 * (5 * B * S * D + 3 * B * D), 3 * B * S * D


def moe_gemm_bwd_work(S: int, T: int, d: int, F: int, E: int, elem: int,
                      n_live: int, live_experts: int, n_counts: int,
                      gated: bool):
    """``moe_gemm_bwd``: the live rows of x and dy and every live expert's
    matrices read, dx and the whole weight gradients written, the counts
    and the slot map read; 8 products of 2 rows d F operations a live row
    (5 without a gate)."""
    n_mat = 3 if gated else 2
    nbytes = (2 * n_live * d + live_experts * n_mat * d * F + S * T * d
              + E * n_mat * d * F) * elem + n_counts * 4 + S * 4
    return nbytes, (8 if gated else 5) * 2.0 * n_live * d * F
