"""The gradient of the port's grouped expert FFN (``moe_gemm``): the plain
version ``kernels.ref.moe_gemm_bwd_plain``, the autograd ``Function``
``kernels.ops.MoeGemm`` and (on a card) the CUDA kernel
``csrc/moe_gemm_bwd.cu``.

The JAX package has no backward kernel to port: its trainer differentiates
the einsum ``grouped_ffn``, and ``jax.grad`` cannot pass through the
Pallas ``moe_gemm``. So the oracles are ``jax.grad`` through
``src/repro/kernels/ref.py::moe_gemm_ref`` (per-slot weights gathered by
the slot map on the JAX side, so that ``jax.grad`` sums the slots that
share an expert; the dead rows and the slots outside [0, E) masked out of
its input and output) and ``torch.autograd`` through ``moe_gemm_plain``,
fed the same numpy inputs made from a seed. Cases: swiglu, gelu and relu;
fp32 and bf16; slots that share an expert, slots outside [0, E), and
``row_counts`` with garbage (+-1e3) in the dead rows.

Tolerances, each with its reason:

* fp32: 1e-5 absolute plus 1e-5 relative (the same arithmetic summed in
  another order; observed below 1e-6).
* bf16: 2 bf16 ulps of the leaf's largest reference element (observed up
  to 1). The kernel keeps ``g``, ``u`` and ``dh`` in fp32 and rounds
  ``h``, ``dg`` and ``du`` to bf16, where ``moe_gemm_ref``'s einsums round
  ``g`` and ``u`` and autograd through ``moe_gemm_plain`` rounds ``dh``;
  ``jax.grad`` also sums shared experts' bf16 slot gradients in bf16.
* ``torch.autograd.gradcheck`` runs in fp32 (the plain path takes fp32 and
  bf16 only) with eps 1e-2 and atol / rtol 1e-2: central differences of
  fp32 sums of up to 24 terms of magnitude ~1 (the float64 default would
  be 1e-5). relu is left out: its kink at 0 breaks central differences.

The kernel's test (``cuda`` marker, skips without a card) holds it against
the plain version at the same tolerances on the card, bit-equal from one
call to the next, with its launch count.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import moe_gemm_ref  # noqa: E402
from repro_torch.kernels import moe_gemm as mg  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

ACTS = ["swiglu", "gelu", "relu"]
DTYPES = ["float32", "bfloat16"]
LAYOUTS = ["shared_experts", "out_of_range", "dead_rows"]
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
S, T, D, F, E, B = 5, 12, 16, 24, 4, 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(layout, seed=0, shape=(S, T, D, F, E, B)):
    """x, dy (S, T, d), weights of E experts, the slot map and the (S, B)
    counts (None but for ``dead_rows``), as numpy."""
    s_, t_, d_, f_, e_, b_ = shape
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(s_, t_, d_)) * 0.5).astype(np.float32)
    dy = (rng.normal(size=(s_, t_, d_)) * 0.5).astype(np.float32)
    w = {n: (rng.normal(size=sh) * 0.3).astype(np.float32)
         for n, sh in (("w_gate", (e_, d_, f_)), ("w_up", (e_, d_, f_)),
                       ("w_down", (e_, f_, d_)))}
    se = (np.arange(s_) * 2 % e_).astype(np.int32)       # experts shared
    counts = None
    if layout == "out_of_range":
        se[1], se[-2] = -1, e_
    if layout == "dead_rows":
        tb = t_ // b_
        counts = rng.integers(0, tb + 1, (s_, b_)).astype(np.int32)
        counts[0, 0], counts[1] = tb, 0
        live = _live(counts, t_)
        x = np.where(live[..., None], x, 1e3).astype(np.float32)
        dy = np.where(live[..., None], dy, -1e3).astype(np.float32)
    return x, dy, w, se, counts


def _live(counts, t_):
    tb = t_ // counts.shape[1]
    return (np.arange(t_) % tb)[None] < counts[:, np.arange(t_) // tb]


def _torch(x, dy, w, se, counts, act, dtype):
    t = TORCH[dtype]
    return (torch.tensor(x).to(t), torch.tensor(w["w_gate"]).to(t)
            if act == "swiglu" else None, torch.tensor(w["w_up"]).to(t),
            torch.tensor(w["w_down"]).to(t), torch.tensor(se),
            torch.tensor(dy).to(t),
            None if counts is None else torch.tensor(counts))


def _jax_grads(x, dy, w, se, counts, act, dtype):
    """jax.grad of sum(moe_gemm_ref(...) * dy) with respect to x and the
    three (E, ...) weight tensors, the slots' weights gathered by the slot
    map (its transpose sums shared experts) and the dead rows and the
    slots outside [0, E) masked out of x and y."""
    dt = JNP[dtype]
    s_, t_, _ = x.shape
    e_ = w["w_up"].shape[0]
    mask = ((se >= 0) & (se < e_))[:, None] & np.ones((1, t_), bool)
    if counts is not None:
        mask &= _live(counts, t_)
    m = jnp.asarray(mask[..., None], dt)
    sec = np.clip(se, 0, e_ - 1)
    dyj = jnp.asarray(dy, dt).astype(jnp.float32)

    def f(xj, wg, wu, wd):
        y = moe_gemm_ref(xj * m, (wg if act == "swiglu" else wu)[sec],
                         wu[sec], wd[sec], act)
        return jnp.sum((y * m).astype(jnp.float32) * dyj)
    args = [jnp.asarray(a, dt) for a in (x, w["w_gate"], w["w_up"],
                                         w["w_down"])]
    g = jax.grad(f, argnums=(0, 1, 2, 3))(*args)
    return [np.asarray(a, np.float32) for a in g]


def _close(got, want, dtype, name):
    got = got.float().numpy() if torch.is_tensor(got) else got
    err = np.abs(got - want)
    if dtype == "float32":
        ok = err <= 1e-5 + 1e-5 * np.abs(want)
        assert ok.all(), (name, float(err.max()))
    else:
        ulp = 2.0 ** (np.floor(np.log2(max(np.abs(want).max(), 1e-30))) - 7)
        assert err.max() <= 2 * ulp, (name, float(err.max()), ulp)


NAMES = ("dx", "d_w_gate", "d_w_up", "d_w_down")


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ACTS)
def test_plain_matches_jax_grad_of_the_oracle(act, dtype, layout):
    x, dy, w, se, counts = _inputs(layout, seed=ACTS.index(act))
    *args, ct = _torch(x, dy, w, se, counts, act, dtype)
    got = ref.moe_gemm_bwd_plain(*args, act, ct)
    want = _jax_grads(x, dy, w, se, counts, act, dtype)
    assert (got[1] is None) == (act != "swiglu")
    for name, g, j in zip(NAMES, got, want):
        if g is None:
            continue
        assert g.dtype == TORCH[dtype], name
        _close(g, j, dtype, name)
    if counts is not None:                      # dead rows: exactly zero
        dead = ~_live(counts, T)
        assert not got[0][torch.tensor(dead)].float().abs().any()
    if layout == "out_of_range":
        assert not got[0][[1, S - 2]].float().abs().any()
        used = set(se[(se >= 0) & (se < E)].tolist())
        for e in set(range(E)) - used:          # no live row: zeros
            assert not got[2][e].float().abs().any()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ACTS)
def test_plain_matches_autograd_through_the_forward(act, dtype, layout):
    x, dy, w, se, counts = _inputs(layout, seed=10 + ACTS.index(act))
    xt, wg, wu, wd, set_, dyt, ct = _torch(x, dy, w, se, counts, act, dtype)
    leaves = [t.clone().requires_grad_() if t is not None else None
              for t in (xt, wg, wu, wd)]
    y = ref.moe_gemm_plain(*leaves, set_, act, ct)
    want = torch.autograd.grad(y, [t for t in leaves if t is not None], dyt)
    want = list(want[:1]) + ([want[1]] if act == "swiglu" else [None]) \
        + list(want[-2:])
    got = ref.moe_gemm_bwd_plain(xt, wg, wu, wd, set_, dyt, act, ct)
    for name, g, a in zip(NAMES, got, want):
        if a is None:
            assert g is None
            continue
        _close(g, a.float().numpy(), dtype, name)


def test_weight_gradients_sum_the_slots_of_one_expert_in_slot_order():
    """Two slots of one expert add into its row: their sum equals the
    gradient of a call that gives each slot its own copy of the weights,
    summed in slot order from zeros (fp32, so no rounding but the sums'),
    bit for bit; an expert no slot names gets zeros."""
    x, dy, w, se, _ = _inputs("shared_experts", seed=3)
    xt, wg, wu, wd, set_, dyt, _ = _torch(x, dy, w, se, None, "swiglu",
                                          "float32")
    got = ref.moe_gemm_bwd_plain(xt, wg, wu, wd, set_, dyt)
    own = ref.moe_gemm_bwd_plain(xt, wg[set_.long()], wu[set_.long()],
                                 wd[set_.long()],
                                 torch.arange(S, dtype=torch.int32), dyt)
    torch.testing.assert_close(got[0], own[0], rtol=0, atol=0)
    for k in (1, 2, 3):
        for e in range(E):
            want = sum((own[k][s] for s in range(S) if se[s] == e),
                       torch.zeros_like(got[k][e]))
            torch.testing.assert_close(got[k][e], want, rtol=0, atol=0)


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_moe_gemm_function_passes_gradcheck(act):
    x, dy, w, se, counts = _inputs("dead_rows", seed=5,
                                   shape=(3, 6, 4, 8, 2, 2))
    x = np.where(_live(counts, 6)[..., None], x, 0).astype(np.float32)
    leaves = [torch.tensor(x, requires_grad=True)]
    if act == "swiglu":
        leaves.append(torch.tensor(w["w_gate"], requires_grad=True))
    leaves += [torch.tensor(w[n], requires_grad=True)
               for n in ("w_up", "w_down")]
    se_t, c_t = torch.tensor(se), torch.tensor(counts)

    def fn(*ts):
        wg = ts[1] if act == "swiglu" else None
        return ops.moe_gemm(ts[0], wg, ts[-2], ts[-1], se_t, act, c_t)
    ops.reset_launches()
    assert torch.autograd.gradcheck(fn, tuple(leaves), eps=1e-2, atol=1e-2,
                                    rtol=1e-2)
    assert not any(ops.LAUNCHES.values())       # the CPU runs plain versions


def test_moe_gemm_takes_the_function_only_while_autograd_records(
        monkeypatch):
    x, dy, w, se, counts = _inputs("dead_rows", seed=6)
    xt, wg, wu, wd, set_, dyt, ct = _torch(x, dy, w, se, counts, "swiglu",
                                           "float32")
    calls = []
    real = ops.MoeGemm.apply
    monkeypatch.setattr(ops.MoeGemm, "apply",
                        lambda *a: calls.append(1) or real(*a))
    plain = ops.moe_gemm(xt, wg, wu, wd, set_, "swiglu", ct)
    assert not calls                            # no input requires a grad
    wr = wu.clone().requires_grad_()
    with torch.no_grad():
        ops.moe_gemm(xt, wg, wr, wd, set_, "swiglu", ct)
    with torch.inference_mode():
        ops.moe_gemm(xt, wg, wr, wd, set_, "swiglu", ct)
    assert not calls
    y = ops.moe_gemm(xt, wg, wr, wd, set_, "swiglu", ct)
    assert calls == [1] and torch.equal(y, plain)
    (g,) = torch.autograd.grad(y, wr, dyt)
    assert torch.equal(g, ref.moe_gemm_bwd_plain(xt, wg, wu, wd, set_, dyt,
                                                 "swiglu", ct)[2])


def test_check_bwd_inputs_rejects_what_the_kernel_does_not_take():
    x, dy, w, se, counts = _inputs("dead_rows")
    xt, wg, wu, wd, set_, dyt, ct = _torch(x, dy, w, se, counts, "swiglu",
                                           "float32")
    mg.check_bwd_inputs(xt, wg, wu, wd, set_, dyt, "swiglu", ct)
    for bad in (dyt[:, :-1], dyt.to(torch.bfloat16),
                dyt.transpose(1, 2).contiguous().transpose(1, 2)):
        with pytest.raises(ValueError):
            ops.moe_gemm_bwd(xt, wg, wu, wd, set_, bad, "swiglu", ct)
    with pytest.raises(ValueError, match="row_counts"):
        ops.moe_gemm_bwd(xt, wg, wu, wd, set_, dyt, "swiglu", ct[:, :2])
    with pytest.raises(TypeError):
        ops.moe_gemm_bwd(xt, wg, wu.to(torch.bfloat16), wd, set_, dyt)


# ---------------------------------------------------------------------------
# the CUDA kernel (needs a card)
# ---------------------------------------------------------------------------

CUDA_CASES = [  # (layout, (S, T, d, F, E, B)): ragged, unaligned, > 1 tile
    ("dead_rows", (5, 24, 40, 72, 4, 3)),
    ("out_of_range", (5, 24, 36, 70, 4, 3)),
    ("shared_experts", (3, 300, 256, 520, 2, 2)),
]


@pytest.mark.cuda
def test_cuda_moe_gemm_bwd_equals_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    n = 0
    ops.reset_launches()
    for layout, shape in CUDA_CASES:
        for act in ACTS:
            for dtype in DTYPES:
                x, dy, w, se, counts = _inputs(layout, seed=n, shape=shape)
                args = [None if t is None else t.cuda() for t in
                        _torch(x, dy, w, se, counts, act, dtype)]
                got = ops.moe_gemm_bwd(*args[:6], act, args[6])
                again = ops.moe_gemm_bwd(*args[:6], act, args[6])
                torch.cuda.synchronize()
                n += 2
                want = ref.moe_gemm_bwd_plain(*args[:6], act, args[6])
                for name, g, a, w2 in zip(NAMES, got, again, want):
                    if w2 is None:
                        assert g is None
                        continue
                    assert torch.equal(g, a), name      # no atomics
                    _close(g.cpu(), w2.float().cpu().numpy(), dtype,
                           (layout, act, dtype, name))
    assert ops.LAUNCHES["moe_gemm_bwd"] == n
