"""Fused top-k router for Hopper: the launcher of ``csrc/topk_router.cu``.

Port of the TPU kernel ``src/repro/kernels/topk_router.py``
(``fused_topk_route``). From ``(R, T, E)`` fp32 router logits, one launch
gives, for every rank's rows, the softmax probabilities, the top-k expert
indices (ties to the lowest index) and un-normalised gates, the per-row
logsumexp, and each rank's int32 expert counts. The logits themselves come
from ``torch.matmul`` outside the kernel, as the JAX package computes them
outside Pallas. ``kernels.ops.fused_topk_route`` is the wrapper the router
calls.

The kernel is launch-bound, so the launcher adds as little as it can
around the one launch: the kernel writes every count itself (one
thread-block cluster per rank sums its CTAs' histograms), so nothing is
zeroed first; the five outputs are views of two allocations, one fp32 and
one int32, each of a size that follows from the shapes alone; the ``ctypes``
function is looked up once. The launcher never synchronises, so it can be
captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

MAX_EXPERTS = 256
MAX_TOP_K = 8


@functools.cache
def _function():
    fn = build.load("topk_router").fused_topk_route
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_inputs(logits, top_k: int) -> None:
    """Raise on anything the kernel does not take."""
    if logits.dim() != 3:
        raise ValueError(f"expected logits (R, T, E); got {tuple(logits.shape)}")
    R, T, E = logits.shape
    if logits.dtype != torch.float32:
        raise TypeError(f"logits must be float32; got {logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    if not 0 < E <= MAX_EXPERTS:
        raise ValueError(f"{E} experts not in [1, {MAX_EXPERTS}]")
    if not 0 < top_k <= min(E, MAX_TOP_K):
        raise ValueError(f"top_k {top_k} not in [1, {min(E, MAX_TOP_K)}]")
    if R == 0 or T == 0:
        raise ValueError(f"logits {tuple(logits.shape)} has no rows")


def fused_topk_route(logits, top_k: int):
    """Launch the kernel on CUDA ``(R, T, E)`` fp32 logits. Returns idx
    ``(R, T, K)`` int32, gates ``(R, T, K)``, probs ``(R, T, E)``, lse
    ``(R, T)`` and counts ``(R, E)`` int32: contiguous views of one fp32
    and one int32 allocation. Raises ``RuntimeError`` if the launch is
    refused."""
    check_inputs(logits, top_k)
    if logits.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {logits.device}")
    R, T, E = logits.shape
    dev = logits.device
    n, nk = R * T * E, R * T * top_k
    f32 = torch.empty(n + nk + R * T, dtype=torch.float32, device=dev)
    i32 = torch.empty(nk + R * E, dtype=torch.int32, device=dev)
    # one as_strided call per view: less host work than slicing, then view
    probs = f32.as_strided((R, T, E), (T * E, E, 1))
    gates = f32.as_strided((R, T, top_k), (T * top_k, top_k, 1), n)
    lse = f32.as_strided((R, T), (T, 1), n + nk)
    idx = i32.as_strided((R, T, top_k), (T * top_k, top_k, 1))
    counts = i32.as_strided((R, E), (E, 1), nk)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _function()(logits.data_ptr(), idx.data_ptr(), gates.data_ptr(),
                      probs.data_ptr(), lse.data_ptr(), counts.data_ptr(),
                      R, T, E, top_k, stream)
    if err != 0:
        raise RuntimeError(f"fused_topk_route launch failed: CUDA error {err}")
    return idx, gates, probs, lse, counts
