"""GQA attention: projection with RoPE, chunked online-softmax prefill, and
paged decode over the shared KV block pool.

Prefill follows the JAX package's ``chunked_attention`` block for block
(scores in the activation dtype, probabilities cast to V's dtype before
the PV product, an fp32 running max / denominator / accumulator) and is
plain PyTorch with the reference's masks. Decode goes through the fused
paged kernel (``kernels.ops.paged_decode_attention``), whose probabilities
stay fp32.

Layer parameters are a dict {"wq", "wk", "wv", "wo"} of (d_in, d_out)
weights. Caches and pools are updated in place (the JAX package returns
new arrays instead).
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.layers import apply_rope, dense

NEG_INF = -1e30


def _block_mask(q_pos, k_pos, causal: bool, window: int):
    """(Sq_blk, Skv_blk) boolean mask. window==0 -> full causal."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        m &= k_pos[None, :] > (q_pos[:, None] - window)
    return m


def chunked_attention(q, k, v, *, causal=True, window=0, q_offset=0,
                      kv_valid_len=None, q_block=512, kv_block=512):
    """Flash-style attention without materialising (Sq, Skv) for full seqs.

    q: (B, Sq, H, hd); k, v: (B, Skv, K, hd) with H % K == 0 (GQA).
    q_offset: absolute position of q[0]. kv_valid_len: optional scalar —
    keys at positions >= this are masked. Returns (B, Sq, H, hd).
    """
    B, Sq, H, hd = q.shape
    _, Skv, K, _ = k.shape
    G = H // K
    dev = q.device
    scale = 1.0 / math.sqrt(hd)

    q_block = min(q_block, Sq)
    kv_block = min(kv_block, Skv)
    pq = (-Sq) % q_block
    pkv = (-Skv) % kv_block
    if pq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pq))
    if pkv:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pkv))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pkv))
    Sq_p, Skv_p = Sq + pq, Skv + pkv
    nq, nkv = Sq_p // q_block, Skv_p // kv_block

    qb = q.reshape(B, nq, q_block, K, G, hd)
    kb = k.reshape(B, nkv, kv_block, K, hd)
    vb = v.reshape(B, nkv, kv_block, K, hd)
    valid = Skv if kv_valid_len is None else kv_valid_len

    outs = []
    for qi in range(nq):
        q_blk = qb[:, qi]                                   # (B, qb, K, G, hd)
        q_pos = q_offset + qi * q_block + torch.arange(q_block, device=dev)
        m_run = torch.full((B, K, G, q_block), NEG_INF, dtype=torch.float32,
                           device=dev)
        l_run = torch.zeros((B, K, G, q_block), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, K, G, q_block, hd), dtype=torch.float32,
                          device=dev)
        for ki in range(nkv):
            k_blk, v_blk = kb[:, ki], vb[:, ki]
            k_pos = ki * kv_block + torch.arange(kv_block, device=dev)
            s = torch.einsum("bqkgh,bckh->bkgqc", q_blk, k_blk) * scale
            mask = _block_mask(q_pos, k_pos, causal, window)
            mask &= (k_pos < valid)[None, :]
            s = torch.where(mask[None, None, None], s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqc,bckh->bkgqh", p.to(v_blk.dtype), v_blk).float()
            m_run = m_new
        out = (acc / torch.clamp_min(l_run, 1e-20)[..., None]).to(q.dtype)
        outs.append(out.permute(0, 3, 1, 2, 4))            # (B, qb, K, G, hd)
    out = torch.stack(outs, dim=1).reshape(B, Sq_p, H, hd)
    return out[:, :Sq]


def gqa_project(p, cfg: ModelConfig, x, positions):
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = dense(p["wq"], x).reshape(B, S, H, hd)
    k = dense(p["wk"], x).reshape(B, S, K, hd)
    v = dense(p["wv"], x).reshape(B, S, K, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_prefill(p, cfg: ModelConfig, x, positions, cache, *, window=0):
    """Prefill: causal attention, and k/v written into ``cache`` (one
    layer's {"k", "v"}: (B, S_max, K, hd)) from position 0, in place."""
    q, k, v = gqa_project(p, cfg, x, positions)
    out = chunked_attention(q, k, v, causal=True, window=window)
    B, S = x.shape[:2]
    cache["k"][:, :S] = k.to(cache["k"].dtype)
    cache["v"][:, :S] = v.to(cache["v"].dtype)
    return dense(p["wo"], out.reshape(B, S, -1))


def gqa_decode_paged(p, cfg: ModelConfig, x, pool, block_tables, lengths,
                     *, window: int = 0):
    """Continuous-batching decode over a paged KV block pool.

    pool: one layer's {"k", "v"}: (N_blocks, block, K, hd), updated in
    place. block_tables: (B, M) int32 maps each slot's logical block to a
    physical block (entries past a slot's allocation point at the null
    block 0 and are masked by ``lengths``). lengths: (B,) int32 — the new
    token is written at logical position ``lengths[b]``, whose block must
    already be allocated; ``lengths[b] == 0`` marks an idle slot whose KV
    write is suppressed, so dead slots never dirty the null block that
    other slots' tables point at. ``window``: architectural sliding window,
    applied as a mask.
    """
    B = x.shape[0]
    N, bs, K, hd = pool["k"].shape
    positions = lengths.long()[:, None]                           # (B, 1)
    q, k, v = gqa_project(p, cfg, x, positions)
    b_idx = torch.arange(B, device=x.device)
    blk = block_tables.long()[b_idx, positions[:, 0] // bs]       # (B,)
    off = positions[:, 0] % bs                                    # (B,)
    # inactive slots write back the value already there (all of them land
    # on the null block's first row), so the null block stays clean
    active = (lengths > 0)[:, None, None]                         # (B, 1, 1)
    for name, new in (("k", k), ("v", v)):
        buf = pool[name]
        buf[blk, off] = torch.where(active, new[:, 0].to(buf.dtype),
                                    buf[blk, off])
    G = q.shape[2] // K
    qg = q.reshape(B, K, G, hd)
    out = kernel_ops.paged_decode_attention(
        qg, pool["k"], pool["v"], block_tables, lengths, window=window)
    return dense(p["wo"], out.reshape(B, 1, -1))
