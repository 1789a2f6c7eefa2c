"""Grouped expert FFN for Hopper: the launcher of ``csrc/moe_gemm.cu``.

Port of the TPU kernel ``src/repro/kernels/moe_gemm.py`` (``moe_gemm``).
For every slot ``s`` of the EP dispatch, ``y[s] = act(x[s] @ Wg[e]) *
(x[s] @ Wu[e]) @ Wd[e]`` with ``e = slot_experts[s]``. The weights stay in
the ``(E, d, F)`` / ``(E, F, d)`` weight tensors, and the kernels read each
row (expert) that a slot names once per launch, for all the slots that
name it: a replica slot that names its expert's home row costs no second
read, one that names its own row of the replica store
(``runtime.store``) costs a read of that row. An optional
``(S, B)`` ``row_counts`` marks the live rows of each slot (rows ``[b*T/B,
b*T/B + row_counts[s, b])``); the others are taken as zero, give zero
outputs and cost no weight reads. One call launches the
gate/up/activation kernel (writing ``h`` in x's dtype to a scratch this
wrapper allocates) and the down kernel on PyTorch's current stream; the
host reads no count. See the source's header for the two main loops (a
``cp.async`` + ``mma.sync`` loop over rows gathered per expert for the
decode shape, ``T <= 64``; TMA + ``wgmma`` tiles for the prefill shape).
``kernels.ops.moe_gemm`` is the wrapper the dispatch calls.

``moe_gemm_bwd`` launches its gradient (``csrc/moe_gemm_bwd.cu``): ``dx``
and the three weight gradients from ``dy``, recomputing the hidden
activations rather than keeping them, which ``kernels.ops.MoeGemm`` runs on
the way back through the training path's EP dispatch. It first packs each
weight row's live rows into one segment padded to ``PACK_TILE`` rows
(``split_bwd_index`` reads the layout; ``ref.moe_bwd_pack_plain`` is its
plain mirror), then runs grouped products over the segments; see that
source's header for its seven launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ACTIVATIONS = {"swiglu": 0, "gelu": 1, "relu": 2}
MAX_SLOTS = 65535
PACK_TILE = 64          # the backward's segments pad to this many rows
TILE_ROWS = 128         # packed rows a hidden / input CTA of the backward


def _function():
    fn = build.load("moe_gemm").moe_gemm
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _bwd_function():
    fn = build.load("moe_gemm_bwd").moe_gemm_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _bwd_index_function():
    fn = build.load("moe_gemm_bwd").moe_gemm_bwd_index
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def pack_rows_bound(S: int, T: int, E: int) -> int:
    """Packed rows the backward's scratch holds: every row live, each of
    the E segments padded by up to ``PACK_TILE - 1`` rows."""
    return S * T + E * (PACK_TILE - 1)


def _max_tiles(S: int, T: int, E: int) -> int:
    return -(-pack_rows_bound(S, T, E) // PACK_TILE)


def bwd_index_size(S: int, T: int, E: int) -> int:
    """int32 elements of the backward's index scratch."""
    return 2 * S + 2 * E + 2 + 3 * _max_tiles(S, T, E) + pack_rows_bound(
        S, T, E)


def split_bwd_index(index, S: int, T: int, E: int) -> dict:
    """The backward's flat index (``csrc/moe_gemm_bwd.cu``, ``Index``) as
    the dict ``ref.moe_bwd_pack_plain`` returns: ``slot_start`` and
    ``slot_n`` (S,), ``seg_off`` (E + 1,), ``seg_n`` (E,), ``tiles`` (n,
    3) of (first packed row, rows, weight row) and ``packed``
    (``seg_off[E]``,) of ``s * T + t``, -1 for padding; int64 on the
    CPU."""
    index = index.cpu().long()
    tm = _max_tiles(S, T, E)
    parts, at = {}, 0
    for name, n in (("slot_start", S), ("slot_n", S), ("seg_off", E + 1),
                    ("seg_n", E), ("n_tiles", 1), ("tile_row0", tm),
                    ("tile_rows", tm), ("tile_e", tm)):
        parts[name] = index[at:at + n]
        at += n
    nt = int(parts.pop("n_tiles")[0])
    parts["tiles"] = torch.stack([parts.pop(k)[:nt] for k in
                                  ("tile_row0", "tile_rows", "tile_e")], 1)
    parts["packed"] = index[at:at + int(parts["seg_off"][E])]
    return parts


def moe_bwd_index(slot_experts, row_counts, T: int, E: int):
    """The backward's packed layout alone on the card (its first launch):
    the flat int32 index for ``split_bwd_index``. slot_experts: (S,)
    int32; row_counts: None or (S, B) int32."""
    S = slot_experts.shape[0]
    if slot_experts.device.type != "cuda":
        raise ValueError("the CUDA kernel needs CUDA tensors, got "
                         f"{slot_experts.device}")
    index = torch.empty(bwd_index_size(S, T, E), dtype=torch.int32,
                        device=slot_experts.device)
    counts_ptr, B = ((None, 1) if row_counts is None
                     else (row_counts.data_ptr(), row_counts.shape[1]))
    stream = torch.cuda.current_stream(slot_experts.device).cuda_stream
    err = _bwd_index_function()(slot_experts.data_ptr(), counts_ptr,
                                index.data_ptr(), S, T, E, B, stream)
    if err != 0:
        raise RuntimeError(f"moe_gemm_bwd_index launch failed: CUDA error "
                           f"{err}")
    return index


def check_inputs(x, w_gate, w_up, w_down, slot_experts, activation,
                 row_counts=None) -> None:
    """Raise on anything the kernel does not take. ``w_gate`` may be None
    (the kernel then reads ``w_up`` in its place), and so may
    ``row_counts`` (every row live)."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation {activation!r} not in {tuple(ACTIVATIONS)}")
    if x.dim() != 3 or w_up.dim() != 3 or w_down.dim() != 3:
        raise ValueError(f"expected x (S,T,d), w_up (E,d,F), w_down (E,F,d); "
                         f"got {tuple(x.shape)}, {tuple(w_up.shape)}, "
                         f"{tuple(w_down.shape)}")
    S, T, d = x.shape
    E, d_w, F = w_up.shape
    if d_w != d or tuple(w_down.shape) != (E, F, d):
        raise ValueError(f"weights {tuple(w_up.shape)}, {tuple(w_down.shape)} "
                         f"do not fit x {tuple(x.shape)}")
    if w_gate is not None and w_gate.shape != w_up.shape:
        raise ValueError(f"w_gate {tuple(w_gate.shape)} != w_up "
                         f"{tuple(w_up.shape)}")
    if tuple(slot_experts.shape) != (S,) or slot_experts.dtype != torch.int32:
        raise ValueError(f"slot_experts must be ({S},) int32; got "
                         f"{tuple(slot_experts.shape)} {slot_experts.dtype}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16; got {x.dtype}")
    if S > MAX_SLOTS:
        raise ValueError(f"{S} slots > {MAX_SLOTS}")
    named = [("x", x), ("w_up", w_up), ("w_down", w_down),
             ("slot_experts", slot_experts)]
    if w_gate is not None:
        named.append(("w_gate", w_gate))
    if row_counts is not None:
        if (row_counts.dim() != 2 or row_counts.shape[0] != S
                or row_counts.shape[1] < 1 or row_counts.dtype != torch.int32):
            raise ValueError(f"row_counts must be ({S}, B) int32; got "
                             f"{tuple(row_counts.shape)} {row_counts.dtype}")
        if T % row_counts.shape[1]:
            raise ValueError(f"row_counts has {row_counts.shape[1]} blocks, "
                             f"which do not divide T = {T}")
        named.append(("row_counts", row_counts))
    for name, t in named:
        if name not in ("slot_experts", "row_counts") and t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}: cast the "
                            "weights once, not per call")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def moe_gemm(x, w_gate, w_up, w_down, slot_experts, activation="swiglu",
             row_counts=None):
    """Launch both kernels on CUDA tensors. x: (S, T, d); w_gate / w_up:
    (E, d, F); w_down: (E, F, d); slot_experts: (S,) int32 in [0, E) (a
    slot outside it computes zeros); row_counts: None or (S, B) int32 live
    rows per block of T / B rows. Returns (S, T, d) in x's dtype."""
    check_inputs(x, w_gate, w_up, w_down, slot_experts, activation,
                 row_counts)
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {x.device}")
    w_gate = w_up if w_gate is None else w_gate
    S, T, d = x.shape
    E, _, F = w_up.shape
    out = torch.empty_like(x)
    if S == 0 or T == 0:
        return out
    h = torch.empty((S, T, F), dtype=x.dtype, device=x.device)
    tensors = (x, w_gate, w_up, w_down, h, out)
    aligned = int(d % 8 == 0 and F % 8 == 0
                  and all(t.data_ptr() % 16 == 0 for t in tensors))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    counts_ptr, B = ((None, 1) if row_counts is None
                     else (row_counts.data_ptr(), row_counts.shape[1]))
    err = _function()(x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
                      w_down.data_ptr(), slot_experts.data_ptr(), counts_ptr,
                      h.data_ptr(), out.data_ptr(), S, T, d, F, E, B,
                      ACTIVATIONS[activation], _DTYPES[x.dtype], aligned,
                      stream)
    if err != 0:
        raise RuntimeError(f"moe_gemm launch failed: CUDA error {err}")
    return out


def check_bwd_inputs(x, w_gate, w_up, w_down, slot_experts, dy, activation,
                     row_counts=None) -> None:
    """``check_inputs`` of the forward, and ``dy`` of x's shape, dtype and
    device, contiguous."""
    check_inputs(x, w_gate, w_up, w_down, slot_experts, activation,
                 row_counts)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} on {dy.device} "
                         f"does not match x {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}")
    if not dy.is_contiguous():
        raise ValueError("dy must be contiguous")


def moe_gemm_bwd(x, w_gate, w_up, w_down, slot_experts, dy,
                 activation="swiglu", row_counts=None):
    """Launch the backward on CUDA tensors: the forward's arguments and
    ``dy`` (S, T, d). Returns (dx (S, T, d), d_w_gate (E, d, F) or None
    without swiglu, d_w_up (E, d, F), d_w_down (E, F, d)), all in x's
    dtype. Seven launches on PyTorch's current stream (five on the FMA path
    of fp32 or of rows that are not whole 16-byte chunks); the packed rows
    (``pack_rows_bound``: x and dy, the fp32 dh, then h, dg and du) and the
    index are scratch allocated here; the host reads no count."""
    check_bwd_inputs(x, w_gate, w_up, w_down, slot_experts, dy, activation,
                     row_counts)
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {x.device}")
    gated = activation == "swiglu"
    S, T, d = x.shape
    E, _, F = w_up.shape
    dx = torch.empty_like(x)
    d_up, d_down = torch.empty_like(w_up), torch.empty_like(w_down)
    d_gate = torch.empty_like(w_up) if gated else None
    if S == 0 or T == 0:
        for t in (dx, d_up, d_down, d_gate):
            if t is not None:
                t.zero_()
        return dx, d_gate, d_up, d_down
    P = pack_rows_bound(S, T, E)
    w_gate = w_gate if gated else w_up
    d_gate_out = d_gate if gated else d_up
    tensors = (x, w_gate, w_up, w_down, dy, dx, d_gate_out, d_up, d_down)
    aligned = int(d % 8 == 0 and F % 8 == 0
                  and all(t.data_ptr() % 16 == 0 for t in tensors))
    scratch = torch.empty((3 if gated else 2, P, F), dtype=x.dtype,
                          device=x.device)
    h, du = scratch[0], scratch[1]
    dg = scratch[2] if gated else du
    packed = (torch.empty(4 * P * (d + F), dtype=torch.uint8,
                          device=x.device)
              if aligned and x.dtype == torch.bfloat16 else None)
    index = torch.empty(bwd_index_size(S, T, E), dtype=torch.int32,
                        device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    counts_ptr, B = ((None, 1) if row_counts is None
                     else (row_counts.data_ptr(), row_counts.shape[1]))
    err = _bwd_function()(
        x.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(), w_down.data_ptr(),
        slot_experts.data_ptr(), counts_ptr, dy.data_ptr(), h.data_ptr(),
        dg.data_ptr(), du.data_ptr(),
        None if packed is None else packed.data_ptr(), index.data_ptr(),
        dx.data_ptr(), d_gate_out.data_ptr(), d_up.data_ptr(),
        d_down.data_ptr(), S, T, d, F, E, B, ACTIVATIONS[activation],
        _DTYPES[x.dtype], aligned, stream)
    if err != 0:
        raise RuntimeError(f"moe_gemm_bwd launch failed: CUDA error {err}")
    return dx, d_gate, d_up, d_down
