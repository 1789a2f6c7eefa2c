"""The RG-LRU scan in the PyTorch port, against the JAX package.

The plain version (``repro_torch.kernels.ref.rg_lru_scan_plain``, the
path ``kernels.ops.rg_lru_scan`` takes for CPU tensors) is held against
the JAX Pallas kernel, run as its own tests run it (``interpret=True``),
and against the JAX oracle ``rg_lru_ref``, at ``tests/test_kernels.py``'s
shapes, ragged ones and a multi-chunk time carry included, within 1e-5 (the
tolerance of ``tests/test_kernels.py``: the same recurrence, the sum and
product possibly contracted differently by XLA). Inputs the kernel does not
take raise. The CUDA kernel runs only on a card: its test is marked
``cuda`` and skips here; on the card it must equal the plain version bit
for bit, at the training and prefill shapes and at the edges of its ring
of time tiles (``RING_EDGE_SHAPES``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import rg_lru_ref as jax_rg_lru_ref  # noqa: E402
from repro.kernels.rg_lru import rg_lru_scan as jax_rg_lru_scan  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rg_lru as rg_kernel  # noqa: E402

SHAPES = [(1, 16, 128), (2, 64, 128), (1, 300, 500),     # ragged D
          (4, 2000, 256),                                 # multi time-chunk carry
          (2, 1025, 257)]                                 # both dims ragged
# (B, S, D, aligned) at the edges of the CUDA kernels' ring (csrc/rg_lru.cu:
# 64-channel strips, 32-step tiles, rings of 4 tiles forward and 3
# backward): S ragged under either ring and past both, D ragged by the strip
# with D % 4 == 0 (TMA boxes past D) and D % 4 == 2 (4-byte copies), fewer
# strips than 2 x 132 and more than the card holds at once, and rows 4 bytes
# past a 16-byte boundary (the 4-byte copies at an aligned D)
RING_EDGE_SHAPES = [(2, 77, 2560, True), (2, 1191, 2560, True),
                    (2, 131, 2568, True), (3, 131, 2570, True),
                    (1, 65, 1600, True), (12, 65, 2560, True),
                    (2, 389, 2560, False)]


def off16(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary (the allocator's blocks start on one)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def _inputs(B, S, D, seed=0):
    rng = np.random.default_rng(seed + B * 7 + S + D)
    a = rng.uniform(0.5, 0.99, (B, S, D)).astype(np.float32)
    b = (rng.normal(size=(B, S, D)) * 0.1).astype(np.float32)
    h0 = rng.normal(size=(B, D)).astype(np.float32)
    return a, b, h0


@pytest.mark.parametrize("B,S,D", SHAPES)
def test_rg_lru_plain_matches_jax_kernel_and_oracle(B, S, D):
    a, b, h0 = _inputs(B, S, D)
    ops.reset_launches()
    out, h_last = ops.rg_lru_scan(torch.tensor(a), torch.tensor(b),
                                  torch.tensor(h0))
    assert out.shape == (B, S, D) and h_last.shape == (B, D)
    assert out.dtype == h_last.dtype == torch.float32
    assert ops.LAUNCHES["rg_lru_scan"] == 0          # CPU: the plain version
    ja, jb, jh = jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0)
    for want_out, want_last in (jax_rg_lru_scan(ja, jb, jh, interpret=True),
                                jax_rg_lru_ref(ja, jb, jh)):
        np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(h_last.numpy(), np.asarray(want_last),
                                   atol=1e-5, rtol=1e-5)
    # the carry is the last step's output
    assert torch.equal(out[:, -1], h_last)


def test_rg_lru_plain_rounds_product_then_sum():
    """Two rounded operations per step, the order the CUDA kernel
    reproduces with __fmul_rn / __fadd_rn."""
    a, b, h0 = _inputs(2, 9, 33)
    out, _ = ref.rg_lru_scan_plain(torch.tensor(a), torch.tensor(b),
                                   torch.tensor(h0))
    h = h0.copy()
    for t in range(a.shape[1]):
        h = (a[:, t] * h).astype(np.float32) + b[:, t]
        np.testing.assert_array_equal(out[:, t].numpy(), h)


@pytest.mark.parametrize("case", ["rank", "b_shape", "h0_shape", "dtype",
                                  "h0_dtype", "noncontiguous", "empty_time"])
def test_rg_lru_scan_rejects_what_the_kernel_does_not_take(case):
    a, b, h0 = (torch.tensor(x) for x in _inputs(2, 8, 16))
    if case == "rank":
        a = a[0]
    elif case == "b_shape":
        b = b[:, :-1]
    elif case == "h0_shape":
        h0 = h0[:, :-1]
    elif case == "dtype":
        a = a.to(torch.bfloat16)
    elif case == "h0_dtype":
        h0 = h0.double()
    elif case == "noncontiguous":
        a = a.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        a, b = a[:, :0], b[:, :0]
    with pytest.raises((TypeError, ValueError)):
        ops.rg_lru_scan(a, b, h0)


@pytest.mark.cuda
def test_cuda_rg_lru_scan_equals_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    ops.reset_launches()
    shapes = [(8, 2048, 2560, True), (2, 1025, 257, True), (3, 1, 70, True),
              (2, 1024, 2560, True)] + RING_EDGE_SHAPES
    for B, S, D, aligned in shapes:
        a, b, h0 = (torch.tensor(x).cuda() for x in _inputs(B, S, D))
        if not aligned:
            a, b = off16(a), off16(b)
            assert a.data_ptr() % 16 == 4
        got = ops.rg_lru_scan(a, b, h0)
        torch.cuda.synchronize()
        want = ref.rg_lru_scan_plain(a, b, h0)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.LAUNCHES["rg_lru_scan"] == len(shapes)
    with pytest.raises(ValueError):                    # B beyond the grid
        rg_kernel.check_inputs(*(torch.zeros(s, device="cuda") for s in (
            (rg_kernel.MAX_BATCH + 1, 1, 1), (rg_kernel.MAX_BATCH + 1, 1, 1),
            (rg_kernel.MAX_BATCH + 1, 1))))
