"""Paged decode attention in the PyTorch port against the JAX package.

The port's plain version (``repro_torch.kernels.ref``) is held against the
JAX Pallas kernel run as its own tests run it (``interpret=True``) and
against the JAX gather oracle, over the grid of
``tests/test_paged_attention.py`` plus an idle slot (length 0). The CUDA
kernel itself runs only on a card: its test is marked ``cuda`` and skips
here.

Tolerances: atol 1e-5 in fp32 (the same op sequence, summed in another
order) and 1e-2 in bf16 (one bf16 ulp of outputs below 2 in magnitude).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention import paged_decode_attention as jax_kernel  # noqa: E402
from repro.kernels.ref import paged_decode_ref as jax_ref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

M = 4  # table width (blocks per slot)
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _ragged_lengths(bs):
    # idle slot, block-filling, block-opening, interior, full capacity
    return [0, bs - 1, bs, 2 * bs + 3, M * bs - 1]


def _state(bs, G, lengths, *, K=2, hd=32, seed=0):
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bs", [8, 16])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("window", [0, "bs+2"])
def test_plain_matches_jax_kernel_and_oracle(dtype, bs, G, window):
    window = bs + 2 if window == "bs+2" else 0
    arrays = _state(bs, G, _ragged_lengths(bs))
    q, kp, vp, tables, lengths = _jax(arrays, dtype)
    want_kernel = jax_kernel(q, kp, vp, tables, lengths, window=window,
                             interpret=True)
    B = tables.shape[0]
    want_oracle = jax_ref(q, kp[tables].reshape(B, -1, *kp.shape[2:]),
                          vp[tables].reshape(B, -1, *vp.shape[2:]), lengths,
                          window=window, block_size=bs)
    got = ref.paged_decode_plain(*_torch(arrays, dtype), window=window)
    assert got.dtype == TORCH[dtype] and got.shape == tuple(q.shape)
    for want in (want_kernel, want_oracle):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=TOL[dtype], rtol=0)


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
    for bs, G, window in ((8, 1, 0), (16, 4, 18), (16, 4, 0)):
        arrays = _state(bs, G, _ragged_lengths(bs), K=8, hd=128)
        dev = [t.cuda() for t in _torch(arrays, dtype)]
        got = ops.paged_decode_attention(*dev, window=window)
        torch.cuda.synchronize()
        want = ref.paged_decode_plain(*dev, window=window)
        tol = TOL[dtype]
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), atol=tol,
                                   rtol=0 if dtype == "float32" else tol)
    assert ops.LAUNCHES["paged_decode_attention"] == 3
