"""Fused paged-decode attention for Hopper: the launcher of
``csrc/paged_attention.cu``.

Port of the TPU kernel ``src/repro/kernels/paged_attention.py``
(``paged_decode_attention``, body ``_decode_kernel``). One decode step per
slot walks the slot's ``block_tables`` row and attends over its logical KV
stream straight from the shared pool, without the ``(B, M*bs, K, hd)``
gathered view the plain version builds.

The kernel is bound by bytes: each live K/V position is read once and used
by G query heads, ~G flops per byte in bf16. One CTA per (slot, KV head) reads
each K/V tile once for all G heads and loops over only the slot's live
blocks (in-context and, under a sliding window, in-window), so the bytes it
reads scale with each slot's valid window rather than the table width.
See the source's header for the design and what is left to do.

Built at first use by ``kernels.build``; ``torch`` tensors pass as raw
pointers through ``ctypes`` and the kernel runs on PyTorch's current
stream. ``kernels.ops.paged_decode_attention`` is the wrapper the model
calls.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
MAX_GROUP = 8                 # query heads per KV head
MAX_TILE_BYTES = 8192         # one (block_size, head_dim) K or V tile


def _function():
    lib = build.load("paged_attention")
    fn = lib.paged_decode_attention
    if fn.argtypes is None:
        # without argtypes ctypes would pass each pointer as a 32-bit int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def check_inputs(q, k_pool, v_pool, block_tables, lengths) -> None:
    """Raise on anything the kernel does not take."""
    if q.dim() != 4 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"expected q (B,K,G,hd) and pools (N,bs,K,hd); got "
                         f"{tuple(q.shape)}, {tuple(k_pool.shape)}, "
                         f"{tuple(v_pool.shape)}")
    B, K, G, hd = q.shape
    if k_pool.shape[2] != K or k_pool.shape[3] != hd:
        raise ValueError(f"pool heads/dims {tuple(k_pool.shape[2:])} do not "
                         f"match q's ({K}, {hd})")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or tuple(lengths.shape) != (B,):
        raise ValueError(f"expected block_tables (B, M) and lengths (B,) for "
                         f"B={B}; got {tuple(block_tables.shape)}, "
                         f"{tuple(lengths.shape)}")
    if q.dtype not in _DTYPES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError(f"q and pools must share float32 or bfloat16; got "
                        f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} > {MAX_HEAD_DIM}")
    if (hd * q.element_size()) % 16:
        raise ValueError(f"a row of head_dim {hd} is not a whole number of "
                         "16-byte loads")
    if G > MAX_GROUP:
        raise ValueError(f"{G} query heads per KV head > {MAX_GROUP}")
    if k_pool.shape[1] * hd * q.element_size() > MAX_TILE_BYTES:
        raise ValueError(f"a ({k_pool.shape[1]}, {hd}) K/V tile exceeds "
                         f"{MAX_TILE_BYTES} bytes")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           window: int = 0):
    """Launch the kernel on CUDA tensors. q: (B, K, G, hd); k_pool/v_pool:
    (N_blocks, bs, K, hd); block_tables: (B, M) int32; lengths: (B,) int32
    — the slot attends positions ``[0, lengths[b]]`` minus anything behind
    the sliding ``window``. Returns (B, K, G, hd) in q's dtype."""
    check_inputs(q, k_pool, v_pool, block_tables, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {q.device}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    B, K, G, hd = q.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _function()(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, K, G, hd, k_pool.shape[1], block_tables.shape[1], int(window),
        1.0 / math.sqrt(hd), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_decode_attention launch failed: CUDA "
                           f"error {err}")
    return out
