"""Plain PyTorch versions of the port's kernels (the allclose ground truth).

Each function repeats the JAX package's oracle (``src/repro/kernels/ref.py``)
or, where the Pallas kernel rounds differently from that oracle, the
Pallas body, op for op. The CPU tests hold these against the JAX kernels, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def paged_decode_ref(q, k_view, v_view, lengths, *, window: int = 0,
                     block_size: int = 16):
    """Gather-path paged-decode oracle for ``kernels.paged_attention``.

    Runs over the MATERIALISED logical view with the kernel's blockwise
    online-softmax op sequence: per logical block, fp32 scores, a running
    max / denominator / accumulator, and blocks wholly outside the valid
    (windowed) range leave the state untouched.

    q: (B, K, G, hd); k_view/v_view: (B, M*bs, K, hd) gathered views;
    lengths: (B,) int32 (new token already written at ``lengths[b]``).
    Returns (B, K, G, hd) in q's dtype.
    """
    B, K, G, hd = q.shape
    bs = block_size
    M = k_view.shape[1] // bs
    dev = q.device
    scale = 1.0 / (hd ** 0.5)
    cl = lengths.to(torch.int32) + 1                              # (B,)
    qf = q.float()
    kb = k_view.reshape(B, M, bs, K, hd)
    vb = v_view.reshape(B, M, bs, K, hd)
    m_run = torch.full((B, K, G), NEG_INF, dtype=torch.float32, device=dev)
    l_run = torch.zeros((B, K, G), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, K, G, hd), dtype=torch.float32, device=dev)
    offs = torch.arange(bs, dtype=torch.int32, device=dev)
    for mi in range(M):
        start = mi * bs
        pos = start + offs
        mask = pos[None, :] < cl[:, None]                         # (B, bs)
        live = start < cl                                         # (B,)
        if window > 0:
            mask &= pos[None, :] >= (cl - window)[:, None]
            live &= start + bs > cl - window
        k_blk = kb[:, mi].float()                                 # (B, bs, K, hd)
        v_blk = vb[:, mi].float()
        s = torch.einsum("bkgh,bckh->bkgc", qf, k_blk) * scale
        s = torch.where(mask[:, None, None, :], s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_new = l_run * corr + p.sum(dim=-1)
        a_new = acc * corr[..., None] + torch.einsum("bkgc,bckh->bkgh", p, v_blk)
        keep = live[:, None, None]
        m_run = torch.where(keep, m_new, m_run)
        l_run = torch.where(keep, l_new, l_run)
        acc = torch.where(keep[..., None], a_new, acc)
    return (acc / torch.clamp_min(l_run, 1e-20)[..., None]).to(q.dtype)


def gather_view(pool, block_tables):
    """(N, bs, K, hd) pool + (B, M) tables -> (B, M*bs, K, hd) logical view."""
    B = block_tables.shape[0]
    return pool[block_tables.long()].reshape(B, -1, *pool.shape[2:])


def paged_decode_plain(q, k_pool, v_pool, block_tables, lengths, *,
                       window: int = 0):
    """The plain version of the fused kernel's interface: gather each
    slot's view from the pool, then run ``paged_decode_ref`` over it."""
    return paged_decode_ref(q, gather_view(k_pool, block_tables),
                            gather_view(v_pool, block_tables), lengths,
                            window=window, block_size=k_pool.shape[1])


def paged_decode_split_plain(q, k_pool, v_pool, block_tables, lengths, *,
                             window: int = 0, blocks_per_split: int = 1):
    """The CUDA kernel's two passes in plain PyTorch (split-KV decoding).

    Split pass: split s covers table blocks ``[s*P, (s+1)*P)``; over its
    keys it takes fp32 scores (masked at -1e30), one max ``m`` and one sum
    ``l`` per head, and the un-normalised ``P @ V``. A split with no valid
    key is empty: ``m = -1e30``, ``l = 0`` and an accumulator of NaN, as
    the kernel leaves it unwritten. Combine pass: ``m* = max m_s`` and
    ``out = sum w_s acc_s / max(sum w_s l_s, 1e-20)`` with ``w_s = exp(m_s
    - m*)`` over the non-empty splits only. Same arguments and result as
    ``paged_decode_plain``; the tests and ``chip_smoke.py`` hold the kernel
    and the blockwise oracle against it."""
    B, K, G, hd = q.shape
    bs, M, P = k_pool.shape[1], block_tables.shape[1], blocks_per_split
    scale = 1.0 / (hd ** 0.5)
    kv = [gather_view(p, block_tables).float() for p in (k_pool, v_pool)]
    cl = lengths.to(torch.int32) + 1
    qf = q.float()
    ms, ls, accs = [], [], []
    for lo in range(0, M, P):
        pos = torch.arange(lo * bs, min(lo + P, M) * bs, dtype=torch.int32,
                           device=q.device)
        mask = pos[None, :] < cl[:, None]                         # (B, n)
        if window > 0:
            mask &= pos[None, :] >= (cl - window)[:, None]
        k, v = (t[:, lo * bs:min(lo + P, M) * bs] for t in kv)    # (B, n, K, hd)
        s = torch.einsum("bkgh,bckh->bkgc", qf, k) * scale
        s = torch.where(mask[:, None, None, :], s, NEG_INF)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        live = mask.any(dim=1)[:, None, None]                     # (B, 1, 1)
        ms.append(torch.where(live, m, NEG_INF))
        ls.append(torch.where(live, p.sum(dim=-1), 0.0))
        acc = torch.einsum("bkgc,bckh->bkgh", p, v)
        accs.append(torch.where(live[..., None], acc, float("nan")))
    m, l, acc = (torch.stack(t) for t in (ms, ls, accs))          # splits first
    live = l > 0
    m_star = torch.where(live, m, NEG_INF).amax(dim=0)
    w = torch.where(live, torch.exp(m - m_star), 0.0)
    num = torch.where(live[..., None], w[..., None] * acc, 0.0).sum(dim=0)
    den = (w * l).sum(dim=0)
    return (num / torch.clamp_min(den, 1e-20)[..., None]).to(q.dtype)


# ---------------------------------------------------------------------------
# the expert-parallel dispatch path's kernels
# ---------------------------------------------------------------------------

def _activate(g, u, activation: str):
    """fp32 activation of the grouped FFN; ``g`` is unused unless swiglu."""
    if activation == "swiglu":
        return F.silu(g) * u
    if activation == "gelu":
        return F.gelu(u, approximate="tanh")       # jax.nn.gelu's default
    if activation == "relu":
        return torch.relu(u)
    raise ValueError(f"activation {activation!r}")


def live_rows_mask(row_counts, T: int):
    """(S, B) live-row counts -> (S, T) bool: row t of slot s is live when
    ``t % (T / B) < row_counts[s, t // (T / B)]``."""
    S, B = row_counts.shape
    tb = T // B
    t = torch.arange(T, device=row_counts.device)
    return (t % tb)[None, :] < row_counts.long()[:, t // tb]


def moe_gemm_plain(x, w_gate, w_up, w_down, slot_experts,
                   activation: str = "swiglu", row_counts=None):
    """Per-slot expert FFN ``act(x @ wg) * (x @ wu) @ wd`` in the Pallas
    body's order (``src/repro/kernels/moe_gemm.py``, ``_kernel``): the gate
    and up products accumulate in fp32, the activation runs in fp32, ``h``
    is cast to x's dtype, and the down product accumulates in fp32 before
    the cast to x's dtype.

    x: (S, T, d); w_gate / w_up: (E, d, F) (``w_gate`` None: ``w_up``, as
    the JAX wrapper does); w_down: (E, F, d); slot_experts: (S,) int, the
    expert whose weights slot s computes with (outside [0, E): zeros);
    row_counts: None or (S, B) int, live rows per block of T / B rows
    (``live_rows_mask``); a dead row's output is zero, whatever it holds.
    Returns (S, T, d)."""
    w_gate = w_up if w_gate is None else w_gate
    E = w_up.shape[0]
    out = torch.zeros_like(x)
    for s, e in enumerate(slot_experts.tolist()):
        if not 0 <= e < E:
            continue
        xs = x[s].float()
        u = xs @ w_up[e].float()
        g = xs @ w_gate[e].float() if activation == "swiglu" else None
        h = _activate(g, u, activation).to(x.dtype)
        out[s] = (h.float() @ w_down[e].float()).to(x.dtype)
    if row_counts is not None:
        live = live_rows_mask(row_counts, x.shape[1])
        out = torch.where(live[..., None], out, torch.zeros((), dtype=x.dtype,
                                                            device=x.device))
    return out


def _hidden_grad(g, u, dh, activation: str):
    """fp32 ``(h, dg, du)`` of the grouped FFN's hidden layer from the sums
    ``g = x Wg``, ``u = x Wu`` and ``dh = dy Wd^T``, in the CUDA kernel's
    order (``csrc/moe_gemm_bwd.cu``, ``hidden_grad``); ``dg`` is None
    unless swiglu. The gelu is the tanh form (``jax.nn.gelu``), and relu's
    gradient at 0 is 0, as in JAX."""
    if activation == "swiglu":
        sg = torch.sigmoid(g)
        a = g * sg
        return a * u, dh * u * (sg * (1 + g * (1 - sg))), dh * a
    if activation == "gelu":
        k0, k1 = 0.7978845608028654, 0.044715
        t = torch.tanh(k0 * (u + k1 * u * u * u))
        return (0.5 * u * (1 + t), None,
                dh * (0.5 * (1 + t)
                      + 0.5 * u * (1 - t * t) * k0 * (1 + 3 * k1 * u * u)))
    if activation == "relu":
        return torch.relu(u), None, torch.where(u > 0, dh, 0.0)
    raise ValueError(f"activation {activation!r}")


def moe_gemm_bwd_plain(x, w_gate, w_up, w_down, slot_experts, dy,
                       activation: str = "swiglu", row_counts=None):
    """The gradient of ``moe_gemm_plain`` with respect to x and the three
    weight tensors, given ``dy`` (S, T, d), in the CUDA kernel's order of
    operations and rounding points (``csrc/moe_gemm_bwd.cu``): per slot,
    over its live rows only, the fp32 sums ``g = x Wg[e]``, ``u = x Wu[e]``
    and ``dh = dy Wd[e]^T``; ``h``, ``dg`` and ``du`` (``_hidden_grad``)
    rounded to x's dtype; ``dx = dg Wg[e]^T + du Wu[e]^T`` summed in fp32
    and rounded; and the fp32 weight sums ``dWg[e] += x^T dg``, ``dWu[e] +=
    x^T du``, ``dWd[e] += h^T dy`` over the slots that name row e, in slot
    order, rounded to the weights' dtype at the end. A dead row gives ``dx
    = 0`` and adds nothing, whatever it holds; a slot outside [0, E) gives
    zeros; a weight row that no live row names gets zeros.

    Same arguments as ``moe_gemm_plain`` plus ``dy``. Returns (dx (S, T,
    d), d_w_gate (E, d, F) or None unless swiglu, d_w_up (E, d, F),
    d_w_down (E, F, d))."""
    gated = activation == "swiglu"
    S, T, _ = x.shape
    E = w_up.shape[0]
    live = (torch.ones((S, T), dtype=torch.bool, device=x.device)
            if row_counts is None else live_rows_mask(row_counts, T))
    dx = torch.zeros_like(x)
    sums = {n: torch.zeros(w.shape, dtype=torch.float32, device=x.device)
            for n, w in (("w_gate", w_up), ("w_up", w_up),
                         ("w_down", w_down)) if n != "w_gate" or gated}
    for s, e in enumerate(slot_experts.tolist()):
        if not 0 <= e < E:
            continue
        rows = live[s].nonzero()[:, 0]
        xs, dys = x[s, rows].float(), dy[s, rows].float()
        g = xs @ w_gate[e].float() if gated else None
        u = xs @ w_up[e].float()
        dh = dys @ w_down[e].float().T
        h, dg, du = (None if t is None else t.to(x.dtype)
                     for t in _hidden_grad(g, u, dh, activation))
        dxs = du.float() @ w_up[e].float().T
        if gated:
            dxs = dg.float() @ w_gate[e].float().T + dxs
            sums["w_gate"][e] += xs.T @ dg.float()
        dx[s, rows] = dxs.to(x.dtype)
        sums["w_up"][e] += xs.T @ du.float()
        sums["w_down"][e] += h.float().T @ dys
    out = {n: t.to(w_up.dtype) for n, t in sums.items()}
    return dx, out.get("w_gate"), out["w_up"], out["w_down"]


def moe_bwd_pack_plain(slot_experts, row_counts, T: int, E: int,
                       tile: int = 64, tile_rows: int = 128) -> dict:
    """The packed layout ``moe_gemm_bwd``'s kernels work on
    (``csrc/moe_gemm_bwd.cu``, ``moe_bwd_rows``), as plain loops: for each
    weight row e, one segment of the live rows (``live_rows_mask``) of every
    slot that names e, slots ascending, then rows, padded with -1 rows to a
    multiple of ``tile``; the segments in the order of e; the
    ``tile_rows``-row tiles of each segment.

    slot_experts: (S,) int; row_counts: None or (S, B) int. Returns
    ``slot_start`` and ``slot_n`` (S,) (a slot's first packed row and live
    rows; 0 and 0 for a slot outside [0, E)), ``seg_off`` (E + 1,) and
    ``seg_n`` (E,), ``tiles`` (n, 3) of (first packed row, rows, e) and
    ``packed`` (``seg_off[E]``,) of ``s * T + t``, all int64."""
    se = [int(e) for e in slot_experts.tolist()]
    S = len(se)
    live = (torch.ones((S, T), dtype=torch.bool) if row_counts is None
            else live_rows_mask(row_counts.cpu(), T))
    slot_start, slot_n = [0] * S, [0] * S
    seg_off, seg_n, tiles, packed = [], [], [], []
    for e in range(E):
        seg_off.append(len(packed))
        for s in range(S):
            if se[s] != e:
                continue
            rows = live[s].nonzero()[:, 0].tolist()
            slot_start[s], slot_n[s] = len(packed), len(rows)
            packed += [s * T + t for t in rows]
        seg_n.append(len(packed) - seg_off[e])
        packed += [-1] * (-seg_n[e] % tile)
        length = len(packed) - seg_off[e]
        tiles += [(seg_off[e] + r, min(tile_rows, length - r), e)
                  for r in range(0, length, tile_rows)]
    seg_off.append(len(packed))
    as_t = lambda v: torch.tensor(v, dtype=torch.int64)   # noqa: E731
    return dict(slot_start=as_t(slot_start), slot_n=as_t(slot_n),
                seg_off=as_t(seg_off), seg_n=as_t(seg_n),
                tiles=torch.tensor(tiles, dtype=torch.int64).reshape(-1, 3),
                packed=as_t(packed))


def fused_topk_route_plain(logits, top_k: int):
    """Softmax, ``top_k`` rounds of max / argmax (ties to the lowest index),
    logsumexp and per-batch expert counts, in the Pallas body's order
    (``src/repro/kernels/topk_router.py``, ``_kernel``).

    logits: (..., T, E) fp32. Returns idx (..., T, K) int32, un-normalised
    gates (..., T, K) fp32, probs (..., T, E), lse (..., T) and counts
    (..., E) int32 (one histogram per leading index)."""
    x = logits.float()
    m = x.amax(dim=-1, keepdim=True)
    ex = torch.exp(x - m)
    den = ex.sum(dim=-1, keepdim=True)
    probs = ex / den
    lse = (m + torch.log(den)).squeeze(-1)
    work = probs.clone()
    sels, gs = [], []
    for _ in range(top_k):
        sel = torch.argmax(work, dim=-1, keepdim=True)   # first maximum
        gs.append(torch.gather(work, -1, sel))
        sels.append(sel)
        work.scatter_(-1, sel, float("-inf"))
    idx = torch.cat(sels, dim=-1)
    E = x.shape[-1]
    lead = idx.shape[:-2]
    counts = torch.zeros(lead + (E,), dtype=torch.int32, device=x.device)
    flat = idx.reshape(lead + (-1,))
    counts.scatter_add_(-1, flat, torch.ones_like(flat, dtype=torch.int32))
    return idx.to(torch.int32), torch.cat(gs, dim=-1), probs, lse, counts


def histogram_offsets_plain(ids, num_classes: int):
    """Class counts of ``ids`` (..., N) and their exclusive prefix sum,
    both (..., num_classes) int32 (``src/repro/kernels/histogram.py``:
    ``histogram`` then the ``cumsum`` of ``histogram_offsets``). Ids
    outside ``[0, num_classes)`` are not counted."""
    ok = (ids >= 0) & (ids < num_classes)
    lead = ids.shape[:-1]
    counts = torch.zeros(lead + (num_classes,), dtype=torch.int32,
                         device=ids.device)
    counts.scatter_add_(-1, torch.where(ok, ids, 0).long(),
                        ok.to(torch.int32))
    starts = torch.cumsum(counts, dim=-1, dtype=torch.int32) - counts
    return counts, starts


def rg_lru_scan_plain(a, b, h0):
    """The linear recurrence ``h_t = a_t * h_{t-1} + b_t`` per channel, a
    sequential loop over time with an fp32 carry, in the order of the Pallas
    body (``src/repro/kernels/rg_lru.py``, ``_kernel``) and of the JAX
    oracle ``rg_lru_ref``: one rounded product, then one rounded sum.

    a, b: (B, S, D) fp32; h0: (B, D) fp32. Returns (h_all (B, S, D),
    h_last (B, D))."""
    h = h0.float()
    out = torch.empty_like(a, dtype=torch.float32)
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out, h


# ---------------------------------------------------------------------------
# the backward of the router and of the scan (the training path's kernels)
# ---------------------------------------------------------------------------

def fused_topk_route_bwd_plain(probs, idx, d_gates, d_probs, d_lse):
    """The gradient of ``fused_topk_route``'s differentiable outputs with
    respect to its logits, as ``jax.grad`` takes it through the JAX
    package's dense ``route``: the gates are the probs at the chosen
    indices, and the gradient of the logsumexp is ``probs``. Per row:

        dp       = d_probs + scatter_add(idx, d_gates)
        d_logits = probs * (dp - sum(probs * dp)) + probs * d_lse

    probs, d_probs: (..., T, E) fp32; idx, d_gates: (..., T, K); d_lse:
    (..., T). A gradient of None counts as zeros. Each product, difference
    and sum rounds once, in the order the CUDA kernel rounds them; only the
    sum over E may run in another order there. Returns (..., T, E) fp32."""
    probs = probs.float()
    dp = (torch.zeros_like(probs) if d_probs is None
          else d_probs.float().clone())
    if d_gates is not None:
        dp.scatter_add_(-1, idx.long(), d_gates.float())
    s = (probs * dp).sum(dim=-1, keepdim=True)
    d_logits = probs * (dp - s)
    if d_lse is not None:
        d_logits = d_logits + probs * d_lse.float()[..., None]
    return d_logits


def rg_lru_scan_bwd_plain(a, h_all, h0, d_h_all, d_h_last):
    """The gradient of ``rg_lru_scan`` (``h_t = a_t * h_{t-1} + b_t``, fp32
    carry from ``h0``), the reverse-time recurrence, as a sequential loop:

        g_{S-1} = d_h_all[S-1] + d_h_last
        g_t     = d_h_all[t] + a_{t+1} * g_{t+1}
        d_b_t   = g_t
        d_a_t   = g_t * h_{t-1}        (h_{-1} = h0)
        d_h0    = a_0 * g_0

    a, h_all, d_h_all: (B, S, D) fp32; h0, d_h_last: (B, D) fp32; a
    gradient of None counts as zeros. Each product and each sum rounds once,
    in the CUDA kernel's order, so the kernel equals this bit for bit.
    Returns (d_a, d_b (B, S, D), d_h0 (B, D)), fp32."""
    S = a.shape[1]
    g = (torch.zeros_like(h0, dtype=torch.float32) if d_h_last is None
         else d_h_last.float().clone())
    d_a = torch.empty_like(a, dtype=torch.float32)
    d_b = torch.empty_like(a, dtype=torch.float32)
    for t in range(S - 1, -1, -1):
        if t < S - 1:
            g = a[:, t + 1] * g
        if d_h_all is not None:
            g = d_h_all[:, t] + g
        d_b[:, t] = g
        d_a[:, t] = g * (h_all[:, t - 1] if t > 0 else h0)
    return d_a, d_b, a[:, 0] * g
