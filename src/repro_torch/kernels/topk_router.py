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

``fused_topk_route_bwd`` launches the router's backward (the same
source): ``d_logits`` of the gates, probs and lse, which
``kernels.ops.FusedTopkRoute`` runs on the way back through the training
path's router. It takes up to 256 experts, as the forward does.
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


# ---------------------------------------------------------------------------
# the backward (csrc/topk_router.cu, fused_topk_route_bwd)
# ---------------------------------------------------------------------------

MAX_BWD_EXPERTS = MAX_EXPERTS


@functools.cache
def _bwd_function():
    fn = build.load("topk_router").fused_topk_route_bwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int64]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def check_bwd_inputs(probs, idx, d_gates, d_probs, d_lse) -> None:
    """Raise on anything the backward kernel does not take. The gradients
    may be None (zeros)."""
    if probs.dim() < 2:
        raise ValueError(f"expected probs (..., T, E); got {tuple(probs.shape)}")
    lead, E = tuple(probs.shape[:-1]), probs.shape[-1]
    if tuple(idx.shape[:-1]) != lead or idx.dtype != torch.int32:
        raise ValueError(f"idx {tuple(idx.shape)} {idx.dtype} does not index "
                         f"probs {tuple(probs.shape)} as int32")
    K = idx.shape[-1]
    if not 0 < E <= MAX_BWD_EXPERTS:
        raise ValueError(f"{E} experts not in [1, {MAX_BWD_EXPERTS}]")
    if not 0 < K <= min(E, MAX_TOP_K):
        raise ValueError(f"top_k {K} not in [1, {min(E, MAX_TOP_K)}]")
    want = {"probs": (probs, lead + (E,)), "d_gates": (d_gates, lead + (K,)),
            "d_probs": (d_probs, lead + (E,)), "d_lse": (d_lse, lead)}
    for name, (t, shape) in want.items():
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype}: expected "
                             f"{shape} float32")
        if not t.is_contiguous() or t.device != probs.device:
            raise ValueError(f"{name} must be contiguous, on {probs.device}")
    if not idx.is_contiguous() or idx.device != probs.device:
        raise ValueError(f"idx must be contiguous, on {probs.device}")


def fused_topk_route_bwd(probs, idx, d_gates, d_probs, d_lse):
    """Launch the backward on CUDA tensors: ``d_logits`` (..., T, E) fp32
    of the forward's differentiable outputs (gates, probs, lse), any of
    whose gradients may be None (zeros, not read)."""
    check_bwd_inputs(probs, idx, d_gates, d_probs, d_lse)
    if probs.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {probs.device}")
    E, K = probs.shape[-1], idx.shape[-1]
    d_logits = torch.empty_like(probs)
    stream = torch.cuda.current_stream(probs.device).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()
    err = _bwd_function()(probs.data_ptr(), idx.data_ptr(), ptr(d_gates),
                          ptr(d_probs), ptr(d_lse), d_logits.data_ptr(),
                          probs.numel() // E, E, K, stream)
    if err != 0:
        raise RuntimeError(f"fused_topk_route_bwd launch failed: CUDA error {err}")
    return d_logits
