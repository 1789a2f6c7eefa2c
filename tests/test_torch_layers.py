"""The PyTorch port's building blocks (``repro_torch.models.layers``) against
the JAX package's (``repro.models.layers``) on the same numpy inputs.

Tolerances: 1e-6 in fp32 (the two frameworks' CPU kernels sum in different
orders), and one bf16 ulp (rtol 1e-2) in bf16.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

TOL = {"float32": dict(rtol=1e-6, atol=1e-6),
       "bfloat16": dict(rtol=1e-2, atol=1e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a, dtype):
    """The same numpy array as a jnp array and a torch tensor of ``dtype``."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, JNP[dtype]), torch.tensor(a).to(TORCH[dtype])


def _close(j, t, dtype):
    np.testing.assert_allclose(np.asarray(j, np.float32),
                               t.float().numpy(), **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 64))
    scale = rng.uniform(0.5, 1.5, size=(64,))
    jx, tx = _pair(x, dtype)
    out_j = jl.rmsnorm({"scale": jnp.asarray(scale, jnp.float32)}, jx)
    out_t = tl.rmsnorm(torch.tensor(scale, dtype=torch.float32), tx)
    assert out_t.dtype == TORCH[dtype]
    _close(out_j, out_t, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 32)) * 0.5
    w = rng.normal(size=(32, 48)) / np.sqrt(32)
    jx, tx = _pair(x, dtype)
    # the weight is stored fp32 and cast to the activation dtype at use
    out_j = jl.dense({"w": jnp.asarray(w, jnp.float32)}, jx)
    out_t = tl.dense(torch.tensor(w, dtype=torch.float32), tx)
    assert out_t.dtype == TORCH[dtype]
    _close(out_j, out_t, dtype)


def test_embed_and_unembed():
    rng = np.random.default_rng(2)
    table = rng.normal(size=(50, 16)).astype(np.float32)
    ids = rng.integers(0, 50, size=(3, 9)).astype(np.int32)
    out_j = jl.embed({"table": jnp.asarray(table)}, jnp.asarray(ids))
    out_t = tl.embed(torch.tensor(table), torch.tensor(ids))
    np.testing.assert_array_equal(np.asarray(out_j), out_t.numpy())
    x = rng.normal(size=(3, 9, 16)).astype(np.float32)
    _close(jl.unembed({"table": jnp.asarray(table)}, jnp.asarray(x)),
           tl.unembed(torch.tensor(table), torch.tensor(x)), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_half_split(dtype):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 11, 4, 64))
    positions = np.stack([np.arange(11), np.arange(11) + 37]).astype(np.int32)
    jx, tx = _pair(x, dtype)
    out_j = jl.apply_rope(jx, jnp.asarray(positions), 10000.0)
    out_t = tl.apply_rope(tx, torch.tensor(positions), 10000.0)
    assert out_t.dtype == TORCH[dtype]
    _close(out_j, out_t, dtype)


def test_rope_is_not_interleaved():
    # half-split: dims d and d + hd/2 rotate together, so rotating a vector
    # that lives only in the first half moves mass into the second half
    x = torch.zeros((1, 1, 1, 8))
    x[..., 0] = 1.0
    out = tl.apply_rope(x, torch.tensor([[1]]))
    assert out[..., 4].abs().item() > 0.5 and out[..., 1].item() == 0.0


@pytest.mark.parametrize("activation", ["swiglu", "gelu", "relu", "relu2"])
def test_ffn(activation):
    rng = np.random.default_rng(4)
    d, f = 32, 64
    x = rng.normal(size=(5, d)).astype(np.float32)
    w = {"w_gate": rng.normal(size=(d, f)) / np.sqrt(d),
         "w_up": rng.normal(size=(d, f)) / np.sqrt(d),
         "w_down": rng.normal(size=(f, d)) / np.sqrt(f)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    jp = {k: jnp.asarray(v) for k, v in w.items()}
    if activation != "swiglu":
        del jp["w_gate"]
    out_j = jl.ffn(jp, jnp.asarray(x), activation)
    out_t = tl.ffn(torch.tensor(w["w_gate"]) if activation == "swiglu" else None,
                   torch.tensor(w["w_up"]), torch.tensor(w["w_down"]),
                   torch.tensor(x), activation)
    _close(out_j, out_t, "float32")


def test_truncated_normal_init_range_and_scale():
    gen = torch.Generator(device="cpu").manual_seed(0)
    t = tl.truncated_normal_init((256, 256), 0.5, generator=gen, device="cpu")
    assert t.dtype == torch.float32
    assert float(t.abs().max()) <= 1.0                      # |z| <= 2
    # a standard normal truncated to [-2, 2] has std 0.8796
    assert abs(float(t.std()) / 0.5 - 0.8796) < 0.01
    again = tl.truncated_normal_init(
        (256, 256), 0.5, generator=torch.Generator().manual_seed(0),
        device="cpu")
    assert torch.equal(t, again)
