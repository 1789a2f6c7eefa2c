"""RG-LRU linear-recurrence scan for Hopper: the launcher of
``csrc/rg_lru.cu``.

Port of the TPU kernel ``src/repro/kernels/rg_lru.py`` (``rg_lru_scan``).
From fp32 ``a`` and ``b`` of shape ``(B, S, D)`` and an fp32 ``h0`` of
shape ``(B, D)``, one launch computes ``h_t = a_t * h_{t-1} + b_t`` for
every channel and returns every ``h_t`` and the last one. Every recurrent
layer of a Griffin prefill calls it through ``kernels.ops.rg_lru_scan``.
``rg_lru_scan_bwd`` launches its backward (the same source), the
reverse-time recurrence that ``kernels.ops.RgLruScan`` runs in every
recurrent layer of a train step's backward.

Both are bound by the bytes they move. Each CTA owns a strip of 64
channels of one batch row (grid: strips x B), one thread per channel, and
streams the strip's inputs through a ring of 32-step time tiles in shared
memory, filled ahead of the serial chain, so the card keeps enough bytes
in flight even at the training shape's 2 x 2560 channels. Time is never
split over CTAs: combining carries would round in another order, and both
kernels equal their plain versions bit for bit. The C side fills the ring
with TMA where D % 4 == 0 and the inputs are 16-byte aligned, with 4-byte
``cp.async`` copies otherwise.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_BATCH = 65535                  # csrc/rg_lru.cu puts B on the grid's y axis


def _function():
    fn = build.load("rg_lru").rg_lru_scan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def check_inputs(a, b, h0) -> None:
    """Raise on anything the kernel does not take."""
    if a.dim() != 3:
        raise ValueError(f"expected a (B, S, D); got {tuple(a.shape)}")
    B, S, D = a.shape
    if tuple(b.shape) != (B, S, D):
        raise ValueError(f"b {tuple(b.shape)} does not match a {tuple(a.shape)}")
    if tuple(h0.shape) != (B, D):
        raise ValueError(f"h0 {tuple(h0.shape)} is not ({B}, {D})")
    for name, t in (("a", a), ("b", b), ("h0", h0)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32; got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != a.device:
            raise ValueError(f"{name} on {t.device}, a on {a.device}")
    if not (0 < B <= MAX_BATCH and S > 0 and D > 0):
        raise ValueError(f"a {tuple(a.shape)}: need 0 < B <= {MAX_BATCH}, "
                         "S > 0 and D > 0")


def rg_lru_scan(a, b, h0):
    """Launch the kernel on CUDA tensors. Returns ``(h_all (B, S, D),
    h_last (B, D))``, fp32."""
    check_inputs(a, b, h0)
    if a.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {a.device}")
    B, S, D = a.shape
    out = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = _function()(a.data_ptr(), b.data_ptr(), h0.data_ptr(),
                      out.data_ptr(), h_last.data_ptr(), B, S, D, stream)
    if err != 0:
        raise RuntimeError(f"rg_lru_scan launch failed: CUDA error {err}")
    return out, h_last


# ---------------------------------------------------------------------------
# the backward (csrc/rg_lru.cu, rg_lru_scan_bwd)
# ---------------------------------------------------------------------------

def _bwd_function():
    fn = build.load("rg_lru").rg_lru_scan_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def check_bwd_inputs(a, h_all, h0, d_h_all, d_h_last) -> None:
    """Raise on anything the backward kernel does not take. ``d_h_all``
    and ``d_h_last`` may be None (zeros)."""
    check_inputs(a, h_all, h0)
    B, S, D = a.shape
    for name, t, shape in (("d_h_all", d_h_all, (B, S, D)),
                           ("d_h_last", d_h_last, (B, D))):
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype}: expected "
                             f"{shape} float32")
        if not t.is_contiguous() or t.device != a.device:
            raise ValueError(f"{name} must be contiguous, on {a.device}")


def rg_lru_scan_bwd(a, h_all, h0, d_h_all, d_h_last):
    """Launch the backward on CUDA tensors. Returns ``(d_a, d_b (B, S, D),
    d_h0 (B, D))``, fp32."""
    check_bwd_inputs(a, h_all, h0, d_h_all, d_h_last)
    if a.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {a.device}")
    B, S, D = a.shape
    d_a, d_b, d_h0 = torch.empty_like(a), torch.empty_like(a), torch.empty_like(h0)
    stream = torch.cuda.current_stream(a.device).cuda_stream

    def ptr(t):
        return None if t is None else t.data_ptr()
    err = _bwd_function()(a.data_ptr(), h_all.data_ptr(), h0.data_ptr(),
                          ptr(d_h_all), ptr(d_h_last), d_a.data_ptr(),
                          d_b.data_ptr(), d_h0.data_ptr(), B, S, D, stream)
    if err != 0:
        raise RuntimeError(f"rg_lru_scan_bwd launch failed: CUDA error {err}")
    return d_a, d_b, d_h0
