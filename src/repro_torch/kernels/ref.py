"""Plain PyTorch versions of the port's kernels (the allclose ground truth).

Each function repeats the JAX package's oracle (``src/repro/kernels/ref.py``)
op for op. The CPU tests hold these against the JAX kernels, and
``chip_smoke.py`` holds the CUDA kernels against them on the card.
"""

from __future__ import annotations

import torch

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
