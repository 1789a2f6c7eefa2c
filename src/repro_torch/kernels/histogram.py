"""Class histogram and exclusive prefix sum for Hopper: the launcher of
``csrc/histogram.cu``.

Port of the TPU kernel ``src/repro/kernels/histogram.py``
(``histogram_offsets``). One launch counts every row of an ``(R, N)``
int32 id array into ``C`` classes and returns the counts and their
exclusive prefix sums, ``(R, C)`` int32 each; the sort-based EP packer
reads them as slot fill levels and run starts. Ids outside ``[0, C)`` are
not counted. ``kernels.ops.histogram_offsets`` is the wrapper the dispatch
calls.

The kernel is launch-bound: for ``C <= 32`` (every main-path shape) a warp
handles a rank row from counting to scan, with no block-wide barrier; more
classes take a CTA per row. The launcher makes one ``(2, R, C)`` int32
allocation, viewed as counts and starts, looks the ``ctypes`` function up
once and never synchronises, so it can be captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build

MAX_CLASSES = (48 * 1024 - 8 * 4) // 4      # csrc/histogram.cu's kMaxClasses


@functools.cache
def _function():
    fn = build.load("histogram").histogram_offsets
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_inputs(ids, num_classes: int) -> None:
    """Raise on anything the kernel does not take."""
    if ids.dim() != 2:
        raise ValueError(f"expected ids (R, N); got {tuple(ids.shape)}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32; got {ids.dtype}")
    if not ids.is_contiguous():
        raise ValueError("ids must be contiguous")
    if not 0 < num_classes <= MAX_CLASSES:
        raise ValueError(f"num_classes {num_classes} not in [1, {MAX_CLASSES}]")
    if ids.shape[0] == 0:
        raise ValueError("ids has no rows")


def histogram_offsets(ids, num_classes: int):
    """Launch the kernel on a CUDA ``(R, N)`` int32 tensor. Returns
    ``(counts, starts)``, both ``(R, num_classes)`` int32, the two halves of
    one allocation. Raises ``RuntimeError`` if the launch is refused."""
    check_inputs(ids, num_classes)
    if ids.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {ids.device}")
    R, N = ids.shape
    counts, starts = torch.empty((2, R, num_classes), dtype=torch.int32,
                                 device=ids.device).unbind(0)
    stream = torch.cuda.current_stream(ids.device).cuda_stream
    err = _function()(ids.data_ptr(), counts.data_ptr(), starts.data_ptr(),
                      R, N, num_classes, stream)
    if err != 0:
        raise RuntimeError(f"histogram_offsets launch failed: CUDA error {err}")
    return counts, starts


@functools.cache
def _empty():
    fn = build.load("histogram").launch_empty
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch_empty() -> None:
    """Launch ``csrc/histogram.cu``'s empty kernel (one CTA of 32 threads)
    on the current CUDA stream: the card's launch floor, the yardstick of
    the two launch-bound kernels. Raises ``RuntimeError`` if the launch is
    refused."""
    err = _empty()(torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")
