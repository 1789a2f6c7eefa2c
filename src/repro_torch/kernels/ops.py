"""Public wrappers for the port's kernels.

A CUDA tensor launches the hand-written Hopper kernel (or raises: there is
no fallback). A CPU tensor runs the kernel's plain PyTorch version from
``kernels.ref`` — that is how the CPU tests exercise the same interface.
``LAUNCHES`` counts kernel launches per wrapper, so a run can show that
its main path went through the kernels.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref as _ref

LAUNCHES: Dict[str, int] = {"paged_decode_attention": 0}


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
    K/V bytes it reads (see ``kernels.paged_attention``)."""
    if q.device.type == "cpu":
        _pa.check_inputs(q, k_pool, v_pool, block_tables, lengths)
        return _ref.paged_decode_plain(q, k_pool, v_pool, block_tables,
                                       lengths, window=window)
    out = _pa.paged_decode_attention(q, k_pool, v_pool, block_tables,
                                     lengths, window=window)
    LAUNCHES["paged_decode_attention"] += 1
    return out
