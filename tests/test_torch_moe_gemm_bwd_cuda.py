"""The ``moe_gemm_bwd`` kernel (``csrc/moe_gemm_bwd.cu``) on a card, across
its packed layout's boundaries, held against its plain version
``kernels.ref.moe_gemm_bwd_plain``. No JAX here: the plain version is the
oracle, and ``tests/test_torch_moe_gemm_bwd.py`` holds it against
``jax.grad`` on the CPU. Without a card the tests skip.

Each case runs swiglu, gelu and relu in bf16 and fp32 with garbage (+-1e3)
in every dead row, twice (the two calls bit-equal: no atomics), and its
launches are counted. The device's packed index (the first launch alone,
``moe_gemm.moe_bwd_index``) equals its plain mirror
``ref.moe_bwd_pack_plain``. Cases: segments of exactly 64 and 65 live
rows, with a weight row named by a slot without live rows and one named by
none; E 128 with segments of 0-2 rows; F 688 (ragged against the 64- and
128-column tiles); replica slots naming a home row beside a slot outside
[0, E); several 128-row tiles and k steps per expert; and an unaligned
shape (d 36, F 70: the FMA path).

Tolerances, as in ``tests/test_torch_moe_gemm_bwd.py``: bf16 within 2 bf16
ulps of each output's largest reference element (h, dg and du round to bf16
after fp32 sums taken in another order); fp32 within 1e-5 absolute plus
1e-5 relative. The weights are drawn at the models' scale (a standard
normal over the square root of each matrix's fan-in, as ``chip_smoke.py``
draws them), so that sums over d and 2F up to 2048 terms stay of order 1
and fp32's order-of-summation error stays under 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import moe_gemm as mg  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

ACTS = ("swiglu", "gelu", "relu")
DTYPES = (torch.float32, torch.bfloat16)
NAMES = ("dx", "d_w_gate", "d_w_up", "d_w_down")
# name: (S, T, d, F, E, B, slot map, counts or "random" or None)
CASES = {
    "segment_64_65": (4, 80, 128, 192, 4, 2, [0, 1, 1, 2],
                      [[40, 24], [40, 0], [20, 5], [0, 0]]),
    "wide_e": (128, 8, 128, 256, 128, 4, list(range(128)), "small"),
    "ragged_f": (4, 160, 256, 688, 2, 4, [0, 1, 0, 1], "random"),
    "replicas": (7, 96, 128, 256, 4, 3, [0, 1, 2, 3, 0, 2, 4], "random"),
    "multi_tile": (3, 320, 512, 1024, 2, 1, [0, 1, 0], None),
    "unaligned": (5, 24, 36, 70, 4, 3, [0, 2, 0, 1, 3], "random"),
}


def _case(name, seed):
    S, T, d, F, E, B, se, counts = CASES[name]
    rng = np.random.default_rng(seed)
    tb = T // B
    if counts == "random":
        counts = rng.integers(0, tb + 1, (S, B))
    elif counts == "small":                   # 0-2 live rows a slot
        counts = np.zeros((S, B), np.int64)
        counts[:, 0] = rng.integers(0, 3, S)
    x = (rng.normal(size=(S, T, d)) * 0.5).astype(np.float32)
    dy = (rng.normal(size=(S, T, d)) * 0.5).astype(np.float32)
    w = [(rng.normal(size=s) * s[1] ** -0.5).astype(np.float32)
         for s in ((E, d, F), (E, d, F), (E, F, d))]
    if counts is not None:
        counts = np.asarray(counts, np.int32)
        live = ((np.arange(T) % tb)[None] < counts[:, np.arange(T) // tb])
        x = np.where(live[..., None], x, 1e3).astype(np.float32)
        dy = np.where(live[..., None], dy, -1e3).astype(np.float32)
    return x, dy, w, np.asarray(se, np.int32), counts


def _close(got, want, dtype, what):
    err = float((got.float() - want.float()).abs().max())
    if dtype == torch.float32:
        ok = ((got - want).abs() <= 1e-5 + 1e-5 * want.abs()).all()
        assert bool(ok), (what, err)
    else:
        scale = max(float(want.float().abs().max()), 1e-30)
        ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
        assert err <= 2 * ulp, (what, err, ulp)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_moe_gemm_bwd_boundaries_equal_plain_version(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    ops.reset_launches()
    n = 0
    for i, act in enumerate(ACTS):
        x, dy, w, se, counts = _case(name, seed=i)
        for dtype in DTYPES:
            t = lambda a: torch.tensor(a).to(dtype).cuda()  # noqa: E731
            args = (t(x), t(w[0]) if act == "swiglu" else None, t(w[1]),
                    t(w[2]), torch.tensor(se).cuda(), t(dy), act,
                    None if counts is None else torch.tensor(counts).cuda())
            got = ops.moe_gemm_bwd(*args)
            again = ops.moe_gemm_bwd(*args)
            torch.cuda.synchronize()
            n += 2
            want = ref.moe_gemm_bwd_plain(*args)
            for part, g, a, wv in zip(NAMES, got, again, want):
                if wv is None:
                    assert g is None
                    continue
                assert torch.equal(g, a), (name, act, dtype, part)
                assert bool(torch.isfinite(g).all())
                _close(g, wv, dtype, (name, act, dtype, part))
    assert ops.LAUNCHES["moe_gemm_bwd"] == n


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_moe_bwd_index_equals_plain_mirror(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, _, w, se, counts = _case(name, seed=0)
    S, T, _ = x.shape
    E = w[1].shape[0]
    c = None if counts is None else torch.tensor(counts)
    index = mg.moe_bwd_index(torch.tensor(se).cuda(),
                             None if c is None else c.cuda(), T, E)
    torch.cuda.synchronize()
    got = mg.split_bwd_index(index, S, T, E)
    want = ref.moe_bwd_pack_plain(torch.tensor(se), c, T, E,
                                  tile=mg.PACK_TILE, tile_rows=mg.TILE_ROWS)
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), (name, key)
