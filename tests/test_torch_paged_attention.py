"""Paged decode attention in the PyTorch port against the JAX package.

The port's plain version (``repro_torch.kernels.ref``) is held against the
JAX Pallas kernel run as its own tests run it (``interpret=True``) and
against the JAX gather oracle, over the grid of
``tests/test_paged_attention.py`` plus an idle slot (length 0). So is the
plain version of the CUDA kernel's two passes,
``ref.paged_decode_split_plain`` (per-split softmax, then the combine), at
1, 2 and 3 blocks per split (3 leaves a ragged last split) and on a table
wide enough that some splits are live and some empty; ``split_plan`` is
checked for coverage, shared memory and CTA count. The dense family's
decode geometries (every query head its own KV head, G 1) run both plain
versions against the JAX kernel too: stablelm-3b's head_dim 80 at 32 KV
heads (10 16-byte chunks a bf16 row, 20 in fp32) and minicpm-2b's 36 KV
heads. The CUDA kernel itself runs only on a card: its tests are marked
``cuda`` and skip here.

Tolerances: atol 1e-5 in fp32 (the same op sequence, summed in another
order) and 1e-2 in bf16 (one bf16 ulp of outputs below 2 in magnitude).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import paged_decode_attention as jax_kernel  # noqa: E402
from repro.kernels.ref import paged_decode_ref as jax_ref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    MIN_CTAS, SMEM_LIMIT, smem_bytes, split_plan)

M = 4  # table width (blocks per slot)
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _ragged_lengths(bs, M=M):
    # idle slot, block-filling, block-opening, interior, full capacity
    return [0, bs - 1, bs, 2 * bs + 3, M * bs - 1]


def _state(bs, G, lengths, *, K=2, hd=32, seed=0, M=M):
    """numpy inputs: q (B,K,G,hd), pools (N,bs,K,hd), tables, lengths."""
    B = len(lengths)
    rng = np.random.default_rng(seed)
    N = 1 + B * M                                     # block 0 = null
    q = rng.normal(size=(B, K, G, hd)).astype(np.float32)
    kp = rng.normal(size=(N, bs, K, hd)).astype(np.float32)
    vp = rng.normal(size=(N, bs, K, hd)).astype(np.float32)
    perm = rng.permutation(B * M).astype(np.int32)
    tables = (1 + perm.reshape(B, M)).astype(np.int32)
    return q, kp, vp, tables, np.asarray(lengths, np.int32)


def _torch(arrays, dtype):
    q, kp, vp, tables, lengths = arrays
    return ([torch.tensor(a).to(TORCH[dtype]) for a in (q, kp, vp)]
            + [torch.tensor(tables), torch.tensor(lengths)])


def _jax(arrays, dtype):
    q, kp, vp, tables, lengths = arrays
    return ([jnp.asarray(a, JNP[dtype]) for a in (q, kp, vp)]
            + [jnp.asarray(tables), jnp.asarray(lengths)])


@functools.lru_cache(maxsize=None)
def _jax_wants(dtype, bs, G, window, lengths, M=M, K=2, hd=32):
    """The JAX Pallas kernel's (interpret=True) and the JAX gather oracle's
    outputs on ``_state``, as float32 numpy; cached, so every port-side
    version and split size is held against one JAX run per case."""
    arrays = _state(bs, G, list(lengths), M=M, K=K, hd=hd)
    q, kp, vp, tables, lens = _jax(arrays, dtype)
    want_kernel = jax_kernel(q, kp, vp, tables, lens, window=window,
                             interpret=True)
    B = tables.shape[0]
    want_oracle = jax_ref(q, kp[tables].reshape(B, -1, *kp.shape[2:]),
                          vp[tables].reshape(B, -1, *vp.shape[2:]), lens,
                          window=window, block_size=bs)
    return tuple(np.asarray(w, np.float32) for w in (want_kernel, want_oracle))


def _assert_matches_jax(got, dtype, bs, G, window, lengths, M=M, K=2, hd=32):
    assert got.dtype == TORCH[dtype]
    for want in _jax_wants(dtype, bs, G, window, tuple(lengths), M, K, hd):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.float().numpy(), want,
                                   atol=TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("window", [0, "bs+2"])
def test_plain_matches_jax_kernel_and_oracle(dtype, bs, G, window):
    window = bs + 2 if window == "bs+2" else 0
    lengths = _ragged_lengths(bs)
    got = ref.paged_decode_plain(*_torch(_state(bs, G, lengths), dtype),
                                 window=window)
    _assert_matches_jax(got, dtype, bs, G, window, lengths)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("window", [0, "bs+2"])
@pytest.mark.parametrize("P", [1, 2, 3])
def test_split_plain_matches_jax_kernel_and_oracle(dtype, bs, G, window, P):
    """The kernel's two passes at P blocks per split (P = 3: a ragged last
    split over the 4-block table) against both JAX references and the
    blockwise plain version."""
    window = bs + 2 if window == "bs+2" else 0
    lengths = _ragged_lengths(bs)
    args = _torch(_state(bs, G, lengths), dtype)
    got = ref.paged_decode_split_plain(*args, window=window,
                                       blocks_per_split=P)
    _assert_matches_jax(got, dtype, bs, G, window, lengths)
    np.testing.assert_allclose(
        got.float().numpy(),
        ref.paged_decode_plain(*args, window=window).float().numpy(),
        atol=TOL[dtype], rtol=0)


# the dense family's decode geometries, G 1 (label: KV heads, head dim)
DENSE_GEOMETRIES = {"stablelm_hd80": (32, 80), "minicpm_k36": (36, 64)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geometry", sorted(DENSE_GEOMETRIES))
def test_plain_versions_match_jax_kernel_at_the_dense_geometries(dtype,
                                                                 geometry):
    """Both plain versions (the split one at 1 and 3 blocks a split)
    against the JAX Pallas kernel and oracle, bs 16, no window."""
    K, hd = DENSE_GEOMETRIES[geometry]
    bs, G, window = 16, 1, 0
    lengths = _ragged_lengths(bs)
    args = _torch(_state(bs, G, lengths, K=K, hd=hd), dtype)
    got = ref.paged_decode_plain(*args, window=window)
    assert got.shape == (len(lengths), K, G, hd)
    _assert_matches_jax(got, dtype, bs, G, window, lengths, K=K, hd=hd)
    for P in (1, 3):
        split = ref.paged_decode_split_plain(*args, window=window,
                                             blocks_per_split=P)
        _assert_matches_jax(split, dtype, bs, G, window, lengths, K=K, hd=hd)


WIDE_M = 16
WIDE_LENGTHS = {
    # one idle slot; slots live in the first split only, in some, in all
    "mixed": (0, 7, 40, 100, WIDE_M * 8 - 1),
    "idle": (0, 0, 0),                      # every slot idle
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 19])
@pytest.mark.parametrize("P", [3, 5])
@pytest.mark.parametrize("lengths", sorted(WIDE_LENGTHS))
def test_split_plain_on_a_wide_table(dtype, window, P, lengths):
    """A 16-block table (bs 8): several splits live per long slot, the
    splits past a slot's length empty, and under window 19 the splits
    behind the window empty too. Empty splits carry a NaN accumulator in
    the plain version, so a combine that did not skip them would fail."""
    bs, G, lens = 8, 4, WIDE_LENGTHS[lengths]
    args = _torch(_state(bs, G, lens, M=WIDE_M), dtype)
    got = ref.paged_decode_split_plain(*args, window=window,
                                       blocks_per_split=P)
    assert torch.isfinite(got.float()).all()
    _assert_matches_jax(got, dtype, bs, G, window, lens, M=WIDE_M)
    np.testing.assert_allclose(
        got.float().numpy(),
        ref.paged_decode_plain(*args, window=window).float().numpy(),
        atol=TOL[dtype], rtol=0)


# (B, K, M, bs, hd, bytes per element, G)
PLANS = [(8, 8, 64, 16, 128, 2, 4),      # the main path's decode
         (8, 8, 64, 16, 128, 4, 4),
         (1, 8, 64, 16, 128, 2, 4),      # one slot alone
         (1, 8, 64, 16, 128, 4, 4),
         (64, 8, 256, 16, 128, 2, 4),    # wide batch: P bounded by memory
         (64, 8, 256, 16, 128, 4, 8),
         (2, 8, 4096, 16, 128, 4, 8),    # long table
         (3, 8, 100, 8, 64, 2, 4),       # M not a power of two
         (1, 1, 5, 16, 128, 2, 1),       # B*K*M < MIN_CTAS
         (8, 16, 64, 16, 64, 2, 1),      # qwen1.5-0.5b's decode
         (8, 16, 64, 16, 128, 2, 1),     # olmo-1b's
         (8, 32, 64, 16, 80, 2, 1),      # stablelm-3b's, hd 80
         (8, 32, 64, 16, 80, 4, 1),
         (8, 36, 64, 16, 64, 2, 1)]      # minicpm-2b's, 36 KV heads


@pytest.mark.parametrize("plan", PLANS, ids=lambda p: "-".join(map(str, p)))
def test_split_plan_covers_fits_and_fills(plan):
    B, K, M, bs, hd, elem, G = plan
    splits, P = split_plan(B, K, M, bs, hd, elem, G)
    assert P >= 1 and P & (P - 1) == 0
    assert splits * P >= M > (splits - 1) * P       # every block once
    assert smem_bytes(P, bs, hd, G, elem) <= SMEM_LIMIT
    if B * K * M >= MIN_CTAS:
        assert B * K * splits >= MIN_CTAS
    else:
        assert P == 1


@pytest.mark.parametrize("B,want", [(8, (8, 8)), (1, (64, 1))])
def test_split_plan_of_the_main_path(B, want):
    """max_len 1024 at block 16 is a 64-block table: 8 slots get 8 splits
    of 8 blocks (512 CTAs), one slot alone 64 splits of 1 (512 CTAs)."""
    assert split_plan(B, 8, 64, 16, 128, 2, 4) == want


@pytest.mark.parametrize("K,hd,elem,want", [
    (16, 64, 2, (4, 16)), (16, 128, 2, (4, 16)), (32, 80, 2, (2, 32)),
    (32, 80, 4, (4, 16)), (36, 64, 2, (2, 32))])
def test_split_plan_of_the_dense_family(K, hd, elem, want):
    """8 slots over a 64-block table at G 1: more KV heads than Mixtral's 8
    fill the card's 264 CTAs with fewer splits, so P grows (Mixtral's is
    8) until shared memory bounds it (stablelm's fp32 tile)."""
    assert split_plan(8, K, 64, 16, hd, elem, 1) == want


def test_wrapper_sends_cpu_tensors_to_plain_version():
    ops.reset_launches()
    arrays = _state(8, 2, _ragged_lengths(8))
    got = ops.paged_decode_attention(*_torch(arrays, "float32"), window=3)
    want = ref.paged_decode_plain(*_torch(arrays, "float32"), window=3)
    assert torch.equal(got, want)
    assert ops.LAUNCHES["paged_decode_attention"] == 0


@pytest.mark.parametrize("bad", ["float16", "noncontig", "hd512", "int64",
                                 "hd6", "G16", "tile"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, kp, vp, tables, lengths = _torch(_state(8, 2, [3, 9]), "float32")
    if bad == "float16":
        q, kp, vp = q.half(), kp.half(), vp.half()
    elif bad == "noncontig":
        kp = kp.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "hd512":
        q = torch.zeros(q.shape[:3] + (512,))
        kp = vp = torch.zeros(kp.shape[:3] + (512,))
    elif bad == "hd6":                  # 24-byte rows: not 16-byte loads
        q = torch.zeros(q.shape[:3] + (6,))
        kp = vp = torch.zeros(kp.shape[:3] + (6,))
    elif bad == "G16":
        q = torch.zeros((q.shape[0], q.shape[1], 16, q.shape[3]))
    elif bad == "tile":                 # (64, 64) fp32 tile: 16 KiB
        kp = vp = torch.zeros((kp.shape[0], 64) + kp.shape[2:3] + (64,))
        q = torch.zeros(q.shape[:3] + (64,))
    else:
        tables = tables.long()
    with pytest.raises((TypeError, ValueError)):
        ops.paged_decode_attention(q, kp, vp, tables, lengths)


# ---------------------------------------------------------------------------
# gqa_decode_paged: JAX parity and inactive-slot write suppression
# ---------------------------------------------------------------------------

def _decode_paged_pair(lengths, dtype):
    """One paged decode step through the JAX and the port's
    ``gqa_decode_paged`` on the same weights, inputs and pool."""
    from repro.configs.base import ModelConfig as JCfg
    from repro.models.attention import gqa_decode_paged as jax_decode
    from repro.models.attention import init_gqa
    from repro_torch.configs.base import ModelConfig as TCfg
    from repro_torch.models.attention import gqa_decode_paged as torch_decode

    dims = dict(name="t", family="dense", num_layers=1, d_model=64,
                num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=128)
    jcfg, tcfg = JCfg(paged_attn_impl="fused", **dims), TCfg(**dims)
    params = jax.tree.map(np.asarray, init_gqa(jax.random.PRNGKey(0), jcfg))
    B, bs = len(lengths), 8
    N = 1 + B * M
    rng = np.random.default_rng(5)
    shape = (N, bs, jcfg.num_kv_heads, jcfg.head_dim)
    pool = {n: rng.normal(size=shape).astype(np.float32) for n in ("k", "v")}
    for p in pool.values():
        p[0] = 0.0                                   # the null block
    # a released slot's row (lengths == 0) points wholly at null block 0
    tables = np.zeros((B, M), np.int32)
    for b, ln in enumerate(lengths):
        if ln > 0:
            tables[b] = 1 + b * M + np.arange(M)
    x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)

    jp = {k: {"w": jnp.asarray(v["w"], JNP[dtype])} for k, v in params.items()}
    out_j, pool_j = jax_decode(
        jp, jcfg, jnp.asarray(x, JNP[dtype]),
        {n: jnp.asarray(p, JNP[dtype]) for n, p in pool.items()},
        jnp.asarray(tables), jnp.asarray(lengths, jnp.int32), window=0)
    tp = {k: torch.tensor(v["w"]).to(TORCH[dtype]) for k, v in params.items()}
    pool_t = {n: torch.tensor(p).to(TORCH[dtype]) for n, p in pool.items()}
    out_t = torch_decode(tp, tcfg, torch.tensor(x).to(TORCH[dtype]), pool_t,
                         torch.tensor(tables),
                         torch.tensor(np.asarray(lengths, np.int32)), window=0)
    return (out_j, pool_j), (out_t, pool_t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_decode_paged_matches_jax(dtype):
    lengths = [3, 8, 0, 17]
    (out_j, pool_j), (out_t, pool_t) = _decode_paged_pair(lengths, dtype)
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])
    for n in ("k", "v"):
        np.testing.assert_allclose(pool_t[n].float().numpy(),
                                   np.asarray(pool_j[n], np.float32),
                                   atol=TOL[dtype], rtol=TOL[dtype])


def test_inactive_slot_write_suppressed():
    """Released slots (lengths == 0) must not write their projected K/V
    into the null block their table rows point at; active slots write
    their new token at position ``lengths[b]``."""
    lengths = [5, 0, 0, 12]
    _, (_, pool) = _decode_paged_pair(lengths, "float32")
    assert float(pool["k"][0].abs().max()) == 0.0
    assert float(pool["v"][0].abs().max()) == 0.0
    _, (_, before) = _decode_paged_pair([0, 0, 0, 0], "float32")
    for b, ln in enumerate(lengths):
        if ln > 0:
            blk, off = 1 + b * M + ln // 8, ln % 8
            assert not torch.equal(pool["k"][blk, off], before["k"][blk, off])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    ops.reset_launches()
    # (bs, G, window, table width M, lengths); the M = 64 cases run with
    # several splits live per slot and reach length 1023
    cases = [(8, 1, 0, M, _ragged_lengths(8)),
             (16, 4, 18, M, _ragged_lengths(16)),
             (16, 4, 0, M, _ragged_lengths(16)),
             (16, 4, 0, 64, [0, 15, 300, 700, 1023]),
             (16, 4, 40, 64, [0, 15, 300, 700, 1023])]
    for bs, G, window, width, lengths in cases:
        arrays = _state(bs, G, lengths, K=8, hd=128, M=width)
        dev = [t.cuda() for t in _torch(arrays, dtype)]
        got = ops.paged_decode_attention(*dev, window=window)
        torch.cuda.synchronize()
        want = ref.paged_decode_plain(*dev, window=window)
        tol = TOL[dtype]
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), atol=tol,
                                   rtol=0 if dtype == "float32" else tol)
    assert ops.LAUNCHES["paged_decode_attention"] == len(cases)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("geometry", sorted(DENSE_GEOMETRIES))
def test_cuda_kernel_matches_plain_version_at_the_dense_geometries(
        dtype, geometry):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    ops.reset_launches()
    K, hd = DENSE_GEOMETRIES[geometry]
    cases = [(M, _ragged_lengths(16)), (64, [0, 15, 300, 700, 1023])]
    for width, lengths in cases:
        arrays = _state(16, 1, lengths, K=K, hd=hd, M=width)
        dev = [t.cuda() for t in _torch(arrays, dtype)]
        got = ops.paged_decode_attention(*dev)
        torch.cuda.synchronize()
        want = ref.paged_decode_plain(*dev)
        tol = TOL[dtype]
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), atol=tol,
                                   rtol=0 if dtype == "float32" else tol)
    assert ops.LAUNCHES["paged_decode_attention"] == len(cases)
