"""GQA attention: projection with RoPE, chunked online-softmax training
attention and prefill, paged decode over the shared KV block pool, and
decode over a contiguous per-batch cache, linear or a rotating window
buffer. An encoder-decoder's cross-attention over the encoder's output
(``cross_attention``; in decode over the cached cross K and V,
``cross_decode``). DeepSeek's multi-head latent attention (MLA) over a
compressed latent cache (``mla_*``, below).

Prefill follows the JAX package's ``chunked_attention`` block for block
(scores in the activation dtype, probabilities cast to V's dtype before
the PV product, an fp32 running max / denominator / accumulator) and is
plain PyTorch with the reference's masks. Paged decode goes through the
fused paged kernel (``kernels.ops.paged_decode_attention``), whose
probabilities stay fp32, or, under ``ModelConfig.paged_attn_impl=
"gather"``, materialises each slot's view from its block table and runs
the plain blockwise oracle (``kernels.ref.paged_decode_ref``), as the JAX
package's "gather" does. Contiguous decode (``decode_attention``; one
position for the batch, or each slot's own over a slotted cache,
``gqa_decode_multi``) is plain PyTorch, as the JAX package computes it
outside any Pallas kernel, and keeps its probabilities in fp32 for the PV
product too.

Rotating-window caches (Griffin's local layers): the buffer holds
``W = min(max_len, window)`` positions, absolute position ``p`` lives in
slot ``p % W``, and RoPE is applied at the absolute position when k is
written, so attention over the buffer does not depend on slot order.

Layer parameters are a dict {"wq", "wk", "wv", "wo"} of (d_in, d_out)
weights, and under ``qkv_bias`` the projections' biases {"bq", "bk",
"bv"}, which every path adds through ``gqa_project``. Caches and pools
are updated in place (the JAX package returns new arrays instead).

MLA (the JAX package's ``mla_*``): a layer's {"w_dkv" (d, r), "w_krope"
(d, rope), "w_uk" (r, H nope), "w_uv" (r, H v), "w_q" (d, H (nope +
rope)), "wo" (H v, d)}. The cache holds, per position, the latent
``c_kv`` (r) and the one RoPE key ``k_rope`` (rope) that every head
shares, stored after RoPE. Attention runs on the same cores as GQA with
K = H: q and k are (nope ‖ rope) wide, so the softmax scale is 1/sqrt(nope
+ rope), and V is zero-padded to that width and sliced back after. Decode
expands K and V from the whole cache (cast to the activation dtype) at
every step, as the reference does: two plain products outside any Pallas
kernel there. Q is full rank whatever ``q_lora_rank`` says, as the JAX
model builds it.

On a process mesh under a tensor-parallel layout (``sharding``) every path
works on this rank's heads: the head count is read off the projections'
widths, so a "col" block of ``wq`` / ``wk`` / ``wv`` (MLA's ``w_q``,
``w_uk``, ``w_uv``) computes this rank's H/m query and K/m KV heads, the
caches and the paged pool hold those K/m heads, and ``wo`` is
row-parallel. A projection whose block splits a head is "gathered"
(``sharding.at_use``): whole query heads compute every head alike on each
rank and ``wo`` takes this rank's block of the output; whole KV heads under
split query heads leave each rank the KV heads its query heads read
(``sharding.kv_span``: reduced configs at "model" 4). MLA's latent
projections and cache stay whole.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import ref as kernel_ref
from repro_torch.models.layers import apply_rope, dense
from repro_torch.sharding import kv_span, placement

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


def _local_kv(p, cfg: ModelConfig, k, v):
    """k, v (B, S, K, hd) as this rank's query heads read them: all of
    them but when ``wk`` was gathered for split query heads, then the KV
    heads of ``kv_span`` (each rank's own use of a replicated tensor)."""
    rk, rq = placement(p["wk"]), placement(p["wq"])
    if rk is None or rk.use != "gathered" or rq.use != "col":
        return k, v
    mesh = rq.mesh
    lo, hi = kv_span(cfg.num_heads, cfg.num_kv_heads, mesh.model,
                     mesh.model_index)
    comm = mesh.comm
    return comm.tp_copy(k)[:, :, lo:hi], comm.tp_copy(v)[:, :, lo:hi]


def gqa_project(p, cfg: ModelConfig, x, positions):
    """q (B, S, H, hd), k and v (B, S, K, hd) after RoPE: this rank's heads
    on a mesh (the module docstring)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q = dense(p["wq"], x, p.get("bq")).reshape(B, S, -1, hd)
    k = dense(p["wk"], x, p.get("bk")).reshape(B, S, -1, hd)
    v = dense(p["wv"], x, p.get("bv")).reshape(B, S, -1, hd)
    k, v = _local_kv(p, cfg, k, v)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_attention(p, cfg: ModelConfig, x, positions, *, window=0):
    """Train-mode causal self-attention over the whole sequence (the JAX
    package's ``gqa_attention``): ``gqa_prefill`` without a cache."""
    q, k, v = gqa_project(p, cfg, x, positions)
    out = chunked_attention(q, k, v, causal=True, window=window)
    B, S = x.shape[:2]
    return dense(p["wo"], out.reshape(B, S, -1))


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
    applied as a mask. ``cfg.paged_attn_impl``: "fused" launches the paged
    kernel on the pool (on a CPU tensor its plain version runs); "gather"
    materialises each slot's (M * block, K, hd) view from its table and
    runs ``kernels.ref.paged_decode_ref``, launching no kernel.
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
    if cfg.paged_attn_impl == "fused":
        out = kernel_ops.paged_decode_attention(
            qg, pool["k"], pool["v"], block_tables, lengths, window=window)
    elif cfg.paged_attn_impl == "gather":
        tables = block_tables.long()
        out = kernel_ref.paged_decode_ref(
            qg, pool["k"][tables].reshape(B, -1, K, hd),
            pool["v"][tables].reshape(B, -1, K, hd), lengths,
            window=window, block_size=bs)
    else:
        raise ValueError(f"paged_attn_impl {cfg.paged_attn_impl!r}")
    return dense(p["wo"], out.reshape(B, 1, -1))


def decode_attention(q, k_cache, v_cache, *, cache_len, window=0):
    """Single-token attention over a contiguous cache. q: (B, 1, H, hd);
    k_cache/v_cache: (B, S_max, K, hd); cache_len: current length including
    the new token, an int or a (B,) tensor. Scores in the activation dtype,
    probabilities and the PV product in fp32 (as the JAX package, so the
    contiguous and paged decodes agree to summation-order noise)."""
    B, _, H, hd = q.shape
    _, S_max, K, _ = k_cache.shape
    G = H // K
    scale = 1.0 / math.sqrt(hd)
    qg = q.reshape(B, K, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache) * scale
    pos = torch.arange(S_max, device=q.device)
    cl = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)  # (1|B, 1)
    mask = pos[None, :] < cl
    if window > 0:
        mask = mask & (pos[None, :] >= cl - window)
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s.float(), dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v_cache.float())
    return out.to(q.dtype).reshape(B, 1, H, hd)


def cross_attention(p, cfg: ModelConfig, x, enc_out):
    """Full (non-causal) cross-attention of the decoder stream x (B, S, d)
    over the encoder's output enc_out (B, Se, d_enc), without RoPE (the JAX
    package's ``cross_attention``). ``p``: GQA's {"wq", "wk", "wv", "wo"}
    (and biases). Returns (out (B, S, d), k, v): k and v (B, Se, K, hd),
    for the cross cache."""
    B, S, _ = x.shape
    Se = enc_out.shape[1]
    hd = cfg.head_dim
    q = dense(p["wq"], x, p.get("bq")).reshape(B, S, -1, hd)
    k = dense(p["wk"], enc_out, p.get("bk")).reshape(B, Se, -1, hd)
    v = dense(p["wv"], enc_out, p.get("bv")).reshape(B, Se, -1, hd)
    k, v = _local_kv(p, cfg, k, v)
    out = chunked_attention(q, k, v, causal=False)
    return dense(p["wo"], out.reshape(B, S, -1)), k, v


def cross_decode(p, cfg: ModelConfig, x, cross_k, cross_v):
    """One token's cross-attention over the whole cached source: x (B, 1,
    d); cross_k / cross_v (B, Se, K, hd) from the prefill. Probabilities
    and the PV product in fp32 (``decode_attention`` at ``cache_len`` Se,
    as the JAX decode step calls it)."""
    B = x.shape[0]
    q = dense(p["wq"], x, p.get("bq")).reshape(B, 1, -1, cfg.head_dim)
    out = decode_attention(q, cross_k, cross_v, cache_len=cross_k.shape[1])
    return dense(p["wo"], out.reshape(B, 1, -1))


def init_gqa_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None):
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def gqa_decode(p, cfg: ModelConfig, x, cache, cache_len: int, *, window=0):
    """Decode one token over a linear cache. x: (B, 1, d); ``cache_len``:
    the length BEFORE this token, where its k/v are written (in place)."""
    B = x.shape[0]
    positions = torch.full((B, 1), cache_len, dtype=torch.long, device=x.device)
    q, k, v = gqa_project(p, cfg, x, positions)
    cache["k"][:, cache_len] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, cache_len] = v[:, 0].to(cache["v"].dtype)
    out = decode_attention(q, cache["k"], cache["v"],
                           cache_len=cache_len + 1, window=window)
    return dense(p["wo"], out.reshape(B, 1, -1))


def gqa_decode_multi(p, cfg: ModelConfig, x, cache, lengths, *, window=0):
    """Decode one token a slot over a slotted linear cache, every slot at
    its own position. x: (B, 1, d); cache: one layer's {"k", "v"}: (B,
    S_max, K, hd), updated in place; lengths: (B,) int tensor, each slot's
    length before this token, where its k / v are written. Idle slots
    decode garbage that the caller ignores."""
    B = x.shape[0]
    positions = lengths.long()[:, None]                           # (B, 1)
    q, k, v = gqa_project(p, cfg, x, positions)
    b_idx = torch.arange(B, device=x.device)
    cache["k"][b_idx, positions[:, 0]] = k[:, 0].to(cache["k"].dtype)
    cache["v"][b_idx, positions[:, 0]] = v[:, 0].to(cache["v"].dtype)
    out = decode_attention(q, cache["k"], cache["v"], cache_len=lengths + 1,
                           window=window)
    return dense(p["wo"], out.reshape(B, 1, -1))


def gqa_prefill_windowed(p, cfg: ModelConfig, x, positions, cache, *,
                         window: int):
    """Prefill with a rotating window cache (buffer length <= window): the
    last ``min(S, W)`` positions are written to slots ``pos % W``."""
    W = cache["k"].shape[1]
    if W > window:
        return gqa_prefill(p, cfg, x, positions, cache, window=window)
    q, k, v = gqa_project(p, cfg, x, positions)
    out = chunked_attention(q, k, v, causal=True, window=window)
    B, S = x.shape[:2]
    n = min(S, W)
    tail = torch.arange(S - n, S, device=x.device)
    cache["k"][:, tail % W] = k[:, tail].to(cache["k"].dtype)
    cache["v"][:, tail % W] = v[:, tail].to(cache["v"].dtype)
    return dense(p["wo"], out.reshape(B, S, -1))


def gqa_decode_windowed(p, cfg: ModelConfig, x, cache, cache_len: int, *,
                        window: int = 0):
    """Decode against a linear cache (window == 0 or a buffer longer than
    the window) or a rotating window buffer: the new k/v go to slot
    ``cache_len % W`` and attention covers the ``min(cache_len + 1, W)``
    live slots."""
    W = cache["k"].shape[1]
    if window == 0 or W > window:
        return gqa_decode(p, cfg, x, cache, cache_len, window=window)
    B = x.shape[0]
    positions = torch.full((B, 1), cache_len, dtype=torch.long, device=x.device)
    q, k, v = gqa_project(p, cfg, x, positions)
    slot = cache_len % W
    cache["k"][:, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v[:, 0].to(cache["v"].dtype)
    out = decode_attention(q, cache["k"], cache["v"],
                           cache_len=min(cache_len + 1, W), window=0)
    return dense(p["wo"], out.reshape(B, 1, -1))


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention over a compressed cache
# ---------------------------------------------------------------------------

def _mla_qkv(p, cfg: ModelConfig, x, positions):
    """q_nope (B, S, H, nope), q_rope (B, S, H, rope) after RoPE, the
    latent c_kv (B, S, r) and the shared k_rope (B, S, 1, rope) after
    RoPE."""
    m = cfg.mla
    B, S, _ = x.shape
    q = dense(p["w_q"], x).reshape(B, S, -1, m.nope_head_dim + m.rope_head_dim)
    q_nope, q_rope = q.split([m.nope_head_dim, m.rope_head_dim], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv = dense(p["w_dkv"], x)
    k_rope = dense(p["w_krope"], x).reshape(B, S, 1, m.rope_head_dim)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
    return q_nope, q_rope, c_kv, k_rope


def _mla_expand(p, cfg: ModelConfig, c_kv):
    """Per-head k_nope (B, S, H, nope) and v (B, S, H, v) from the latent
    c_kv (B, S, r)."""
    m = cfg.mla
    B, S, _ = c_kv.shape
    k_nope = dense(p["w_uk"], c_kv).reshape(B, S, -1, m.nope_head_dim)
    v = dense(p["w_uv"], c_kv).reshape(B, S, -1, m.v_head_dim)
    return k_nope, v


def _pad_like(v, hd: int):
    """v zero-padded on its last axis to ``hd``."""
    if v.shape[-1] == hd:
        return v
    return torch.nn.functional.pad(v, (0, hd - v.shape[-1]))


def _mla_causal(p, cfg: ModelConfig, x, qkv, window: int):
    """Causal MLA over the whole sequence from ``_mla_qkv``'s outputs."""
    m = cfg.mla
    B, S, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = qkv
    H = q_nope.shape[2]
    rec = placement(p["w_q"])
    if rec is not None and rec.use == "col":
        # the shared rope key (replicated) meets this rank's heads only
        k_rope = rec.mesh.comm.tp_copy(k_rope)
    k_nope, v = _mla_expand(p, cfg, c_kv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, m.rope_head_dim)], dim=-1)
    out = chunked_attention(q, k, _pad_like(v, q.shape[-1]), causal=True,
                            window=window)[..., :m.v_head_dim]
    return dense(p["wo"], out.reshape(B, S, H * m.v_head_dim))


def mla_attention(p, cfg: ModelConfig, x, positions, *, window=0):
    """Train-mode MLA over the whole sequence: the concatenated (nope ‖
    rope) q and k through ``chunked_attention``, the rope key broadcast
    over the heads."""
    return _mla_causal(p, cfg, x, _mla_qkv(p, cfg, x, positions), window)


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   dtype=torch.bfloat16, device=None):
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, max_len, m.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, m.rope_head_dim),
                                  dtype=dtype, device=device)}


def mla_prefill(p, cfg: ModelConfig, x, positions, cache, *, window=0):
    """Prefill: causal MLA, and the latent ``c_kv`` and the roped
    ``k_rope`` written into ``cache`` (one layer's {"c_kv": (B, S_max, r),
    "k_rope": (B, S_max, rope)}) from position 0, in place."""
    qkv = _mla_qkv(p, cfg, x, positions)
    out = _mla_causal(p, cfg, x, qkv, window)
    S = x.shape[1]
    _, _, c_kv, k_rope = qkv
    cache["c_kv"][:, :S] = c_kv.to(cache["c_kv"].dtype)
    cache["k_rope"][:, :S] = k_rope[:, :, 0].to(cache["k_rope"].dtype)
    return out


def mla_decode(p, cfg: ModelConfig, x, cache, cache_len: int, *, window=0):
    """Decode one token per row over the latent cache. x: (B, 1, d);
    ``cache_len``: the length BEFORE this token, where its c_kv and k_rope
    are written (in place). K and V are expanded from all ``S_max`` cached
    positions, the unwritten ones masked. A cache no longer than
    ``window`` is a rotating window buffer, as ``gqa_decode_windowed``
    keeps one: the token goes to slot ``cache_len % S_max`` and attention
    covers the ``min(cache_len + 1, S_max)`` live slots (the RoPE'd
    ``k_rope`` carries its position), so a long-context decode runs past
    the buffer's end (up to it, the same as the linear cache)."""
    m = cfg.mla
    B = x.shape[0]
    positions = torch.full((B, 1), cache_len, dtype=torch.long,
                           device=x.device)
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(p, cfg, x, positions)
    H = q_nope.shape[2]
    S_max = cache["c_kv"].shape[1]
    if 0 < window and S_max <= window:
        slot, cache_len, window = cache_len % S_max, \
            min(cache_len, S_max - 1), 0
    else:
        slot = cache_len
    cache["c_kv"][:, slot] = c_kv_new[:, 0].to(cache["c_kv"].dtype)
    cache["k_rope"][:, slot] = k_rope_new[:, 0, 0].to(
        cache["k_rope"].dtype)
    k_nope, v = _mla_expand(p, cfg, cache["c_kv"].to(x.dtype))
    k_rope_all = cache["k_rope"][:, :, None, :].to(x.dtype).expand(
        B, S_max, H, m.rope_head_dim)
    k = torch.cat([k_nope, k_rope_all], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1).reshape(B, 1, H, -1)
    out = decode_attention(q, k, _pad_like(v, q.shape[-1]),
                           cache_len=cache_len + 1, window=window)
    out = out[..., :m.v_head_dim]
    return dense(p["wo"], out.reshape(B, 1, H * m.v_head_dim))
