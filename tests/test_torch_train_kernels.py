"""The backward of the router and of the RG-LRU scan in the PyTorch port.

Neither has a Pallas counterpart: the JAX package trains through its dense
``route`` and ``jax.lax.associative_scan``, and ``jax.grad`` derives their
gradients. The port's forward is a kernel on the card, so its gradient is
a hand-written kernel too, with a plain version beside it
(``kernels.ref.fused_topk_route_bwd_plain`` / ``rg_lru_scan_bwd_plain``).

Tolerances, each with its reason:

* the plain backward against autograd through the plain forward (softmax,
  gather, logsumexp; the sequential scan): 1e-6 absolute for the router
  (the same function, the sum over E and autograd's chain in another
  order), bit for bit for the scan (the same products and sums in the
  same order);
* ``FusedTopkRoute`` / ``RgLruScan`` through ``route`` and ``rg_lru``
  against ``jax.grad`` of the JAX functions on the same numpy inputs:
  1e-5 relative for the router's gradients (fp32 throughout), and for
  ``rg_lru`` (bf16 activations and weights) 2e-2 relative in norm per
  input, as bf16 products round apart in torch and XLA.

The CUDA kernels run only on a card: their tests carry the ``cuda`` marker
and skip here. There the scan's backward must equal its plain version bit
for bit (also at the edges of its ring of time tiles, the forward's test's
``RING_EDGE_SHAPES``), and the router's within 1e-6.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models import griffin as jgriffin  # noqa: E402
from repro.moe.router import route as jax_route  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import rg_lru as rg_kernel  # noqa: E402
from repro_torch.kernels import topk_router as tk_kernel  # noqa: E402
from repro_torch.models import griffin as tgriffin  # noqa: E402
from repro_torch.moe.router import route  # noqa: E402
from test_torch_rg_lru import RING_EDGE_SHAPES, off16  # noqa: E402

# (R, T, E, K): the training path's (1, T, 8, 2), ragged E, one expert
ROUTE_SHAPES = [(1, 64, 8, 2), (3, 17, 8, 2), (2, 33, 5, 3), (1, 9, 32, 8),
                (2, 7, 1, 1)]
# which of (d_gates, d_probs, d_lse) reach the backward
GRADS = [(True, True, True), (True, False, False), (False, True, False),
         (False, False, True), (True, False, True), (False, True, True),
         (True, True, False)]
SCAN_SHAPES = [(1, 1, 8), (2, 40, 33), (3, 257, 65)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small operations: one intra-op thread runs them as fast as many and
    keeps test workers side by side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _route_logits(R, T, E, seed):
    """Random logits with exact ties planted: rows 0-1 of every rank all
    equal (every expert tied), row 2 two experts tied at the top."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(R, T, E)) * 2.0).astype(np.float32)
    x[:, :2] = 0.25
    if T > 2 and E > 1:
        x[:, 2, :2] = x[:, 2].max() + 1.0
    return x


def _route_grads(R, T, E, K, use, seed):
    rng = np.random.default_rng(seed + 1)
    d = [rng.normal(size=s).astype(np.float32)
         for s in ((R, T, K), (R, T, E), (R, T))]
    return [torch.tensor(g) if u else None for g, u in zip(d, use)]


@pytest.mark.parametrize("use", GRADS, ids=lambda u: "".join("gpl"[i] if x
                                                             else "-" for i, x
                                                             in enumerate(u)))
@pytest.mark.parametrize("R,T,E,K", ROUTE_SHAPES)
def test_route_bwd_plain_matches_autograd(R, T, E, K, use):
    x = _route_logits(R, T, E, seed=R * 100 + T + E)
    d_gates, d_probs, d_lse = _route_grads(R, T, E, K, use, seed=T)
    idx, gates, probs, lse, _ = ref.fused_topk_route_plain(torch.tensor(x), K)
    got = ops.fused_topk_route_bwd(probs, idx, d_gates, d_probs, d_lse)
    # autograd through softmax, the gather of the chosen probs, logsumexp
    xl = torch.tensor(x, requires_grad=True)
    p = torch.softmax(xl, dim=-1)
    outs = (torch.gather(p, -1, idx.long()), p, torch.logsumexp(xl, dim=-1))
    terms = [(o * g).sum() for o, g in zip(outs, (d_gates, d_probs, d_lse))
             if g is not None]
    want, = torch.autograd.grad(sum(terms), xl)
    assert got.dtype == torch.float32 and got.shape == (R, T, E)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=0)
    # tied rows picked the lowest indices, as lax.top_k does
    assert (idx[:, :2] == torch.arange(K, dtype=torch.int32)).all()


def test_route_bwd_plain_rounds_as_the_kernel():
    """One rounding per product, difference and sum: the order the CUDA
    kernel keeps with __fmul_rn / __fsub_rn / __fadd_rn."""
    x = _route_logits(1, 5, 8, seed=3)
    d_gates, d_probs, d_lse = _route_grads(1, 5, 8, 2, (True,) * 3, seed=3)
    idx, _, probs, _, _ = ref.fused_topk_route_plain(torch.tensor(x), 2)
    got = ref.fused_topk_route_bwd_plain(probs, idx, d_gates, d_probs, d_lse)
    p, dp = probs.numpy()[0], d_probs.numpy()[0].copy()
    for t in range(5):
        for k in range(2):
            dp[t, idx[0, t, k]] = np.float32(dp[t, idx[0, t, k]]
                                              + d_gates[0, t, k].item())
        s = np.float32((p[t] * dp[t]).astype(np.float32).sum(
            dtype=np.float32))
        row = (p[t] * (dp[t] - s)).astype(np.float32) + (
            p[t] * np.float32(d_lse[0, t].item())).astype(np.float32)
        np.testing.assert_allclose(got[0, t].numpy(), row, atol=2e-7,
                                   rtol=0)


def _scan_inputs(B, S, D, seed=0):
    rng = np.random.default_rng(seed + B * 7 + S + D)
    a = rng.uniform(0.5, 0.99, (B, S, D)).astype(np.float32)
    b = (rng.normal(size=(B, S, D)) * 0.1).astype(np.float32)
    h0 = rng.normal(size=(B, D)).astype(np.float32)
    dh = rng.normal(size=(B, S, D)).astype(np.float32)
    dl = rng.normal(size=(B, D)).astype(np.float32)
    return a, b, h0, dh, dl


@pytest.mark.parametrize("use", [(True, True), (True, False), (False, True)],
                         ids=["both", "h_all", "h_last"])
@pytest.mark.parametrize("B,S,D", SCAN_SHAPES)
def test_rg_lru_bwd_plain_matches_autograd(B, S, D, use):
    a, b, h0, dh, dl = (torch.tensor(v) for v in _scan_inputs(B, S, D))
    d_h_all, d_h_last = (g if u else None for g, u in zip((dh, dl), use))
    h_all, _ = ref.rg_lru_scan_plain(a, b, h0)
    d_a, d_b, d_h0 = ops.rg_lru_scan_bwd(a, h_all, h0, d_h_all, d_h_last)
    leaves = [t.clone().requires_grad_() for t in (a, b, h0)]
    out = ref.rg_lru_scan_plain(*leaves)
    terms = [(o * g).sum() for o, g in zip(out, (d_h_all, d_h_last))
             if g is not None]
    want = torch.autograd.grad(sum(terms), leaves)
    for got, w in zip((d_a, d_b, d_h0), want):
        assert got.dtype == torch.float32
        assert torch.equal(got, w)


def test_rg_lru_bwd_plain_rounds_product_then_sum():
    a, b, h0, dh, dl = _scan_inputs(2, 6, 9)
    h_all, _ = ref.rg_lru_scan_plain(*(torch.tensor(v) for v in (a, b, h0)))
    d_a, d_b, d_h0 = ref.rg_lru_scan_bwd_plain(
        torch.tensor(a), h_all, torch.tensor(h0), torch.tensor(dh),
        torch.tensor(dl))
    h, g = h_all.numpy(), dl.copy()
    for t in range(5, -1, -1):
        if t < 5:
            g = (a[:, t + 1] * g).astype(np.float32)
        g = dh[:, t] + g
        np.testing.assert_array_equal(d_b[:, t].numpy(), g)
        np.testing.assert_array_equal(
            d_a[:, t].numpy(), g * (h[:, t - 1] if t else h0))
    np.testing.assert_array_equal(d_h0.numpy(), a[:, 0] * g)


# ---------------------------------------------------------------------------
# the Functions through the port's modules, against jax.grad
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T", [16, 48])
def test_route_gradients_match_jax_dense_route(T):
    """``route`` (through ``FusedTopkRoute``) against ``jax.grad`` of the
    JAX package's dense route: the gradient of a weighted sum of the
    normalised gates, the probs, the aux loss and the z loss, with respect
    to the tokens and the router weight."""
    moe = get_config("mixtral-8x7b").moe
    jmoe = jax_get_config("mixtral-8x7b").moe
    rng = np.random.default_rng(T)
    d, E, K = 32, moe.num_experts, moe.top_k
    x = rng.normal(size=(T, d)).astype(np.float32)
    x[:2] = 0.0                         # all experts tied on two rows
    w = (rng.normal(size=(d, E)) * 0.5).astype(np.float32)
    wg = rng.normal(size=(T, K)).astype(np.float32)
    wp = rng.normal(size=(T, E)).astype(np.float32)

    def jloss(x, w):
        out = jax_route({"w": w}, jmoe, x, impl="dense")
        return ((out.gates * wg).sum() + (out.probs * wp).sum()
                + 100.0 * out.aux_loss + 100.0 * out.z_loss)
    jl, (jdx, jdw) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw = (torch.tensor(v, requires_grad=True) for v in (x, w))
    out = route(tw, moe, tx)
    loss = ((out.gates * torch.tensor(wg)).sum()
            + (out.probs * torch.tensor(wp)).sum()
            + 100.0 * out.aux_loss + 100.0 * out.z_loss)
    loss.backward()
    assert loss.item() == pytest.approx(float(jl), rel=1e-5)
    assert (out.expert_idx[:2] == torch.arange(K, dtype=torch.int32)).all()
    for got, want in ((tx.grad, jdx), (tw.grad, jdw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def test_rg_lru_gradients_match_jax():
    """``griffin.rg_lru`` (through ``RgLruScan``) against ``jax.grad`` of
    the JAX package's ``rg_lru`` (associative scan), from fp32 weights as
    both packages train them: the gradients reaching the gate weights,
    ``lam``, the input and ``h0``."""
    jcfg = dataclasses.replace(jax_get_config("recurrentgemma-2b").reduced(),
                               rnn_width=64)
    tree = jax.tree.map(np.asarray, jgriffin.init_recurrent_block(
        jax.random.PRNGKey(5), jcfg))
    rng = np.random.default_rng(5)
    B, S, dr = 2, 24, 64
    x = rng.normal(size=(B, S, dr)).astype(np.float32)
    h0 = rng.normal(size=(B, dr)).astype(np.float32)
    wy = rng.normal(size=(B, S, dr)).astype(np.float32)
    wl = rng.normal(size=(B, dr)).astype(np.float32)
    # lam well below its init (4 + noise), so that a_t = exp(-8 softplus(lam)
    # r_t) sits near 1 and the gradient runs far back through the scan
    lam = rng.uniform(-6.0, -2.0, dr).astype(np.float32)
    leaves = {"w_a": tree["w_a"]["w"], "w_x": tree["w_x"]["w"],
              "lam": lam, "x": x, "h0": h0}

    def jloss(v):
        y, h_last = jgriffin.rg_lru(
            {"w_a": {"w": v["w_a"]}, "w_x": {"w": v["w_x"]}, "lam": v["lam"]},
            v["x"].astype(jnp.bfloat16), v["h0"])
        return (y.astype(jnp.float32) * wy).sum() + (h_last * wl).sum()
    jl, jg = jax.jit(jax.value_and_grad(jloss))(
        jax.tree.map(jnp.asarray, leaves))
    t = {k: torch.tensor(v, requires_grad=True) for k, v in leaves.items()}
    ops.reset_launches()
    y, h_last = tgriffin.rg_lru({k: t[k] for k in ("w_a", "w_x", "lam")},
                                t["x"].to(torch.bfloat16), t["h0"])
    loss = (y.float() * torch.tensor(wy)).sum() + (h_last * torch.tensor(wl)).sum()
    loss.backward()
    assert not any(ops.LAUNCHES.values())          # CPU: the plain versions
    assert loss.item() == pytest.approx(float(jl), rel=1e-3)
    for k, v in t.items():
        want = np.asarray(jg[k], np.float32)
        err = np.linalg.norm(v.grad.numpy() - want) / np.linalg.norm(want)
        assert err < 2e-2, (k, err)


def test_functions_without_autograd_run_the_forward_wrappers():
    """Under ``no_grad`` / ``inference_mode`` the router and the scan call
    the forward wrappers alone (what serving launches is unchanged), and
    the outputs carry no graph."""
    moe = get_config("mixtral-8x7b").moe
    x = torch.randn(6, 16)
    w = torch.randn(16, moe.num_experts, requires_grad=True)
    for ctx in (torch.no_grad, torch.inference_mode):
        with ctx():
            out = route(w, moe, x)
        assert all(t.grad_fn is None for t in out if torch.is_tensor(t))
    out = route(w, moe, x)
    assert out.gates.grad_fn is not None and out.expert_idx.grad_fn is None
    a, b, h0 = (torch.tensor(v) for v in _scan_inputs(1, 5, 4)[:3])
    with torch.inference_mode():
        got = ops.RgLruScan.apply(a, b, h0)
    assert all(torch.equal(g, w) for g, w in
               zip(got, ref.rg_lru_scan_plain(a, b, h0)))


@pytest.mark.parametrize("case", ["e_too_wide", "idx_dtype", "gates_shape",
                                  "probs_dtype", "lse_shape", "noncontiguous"])
def test_route_bwd_rejects_what_the_kernel_does_not_take(case):
    E = 257 if case == "e_too_wide" else 8
    probs = torch.softmax(torch.randn(1, 6, E), -1)
    idx = torch.zeros(1, 6, 2, dtype=torch.int32)
    d_gates, d_probs, d_lse = (torch.ones(1, 6, 2), torch.ones(1, 6, E),
                               torch.ones(1, 6))
    if case == "idx_dtype":
        idx = idx.long()
    elif case == "gates_shape":
        d_gates = d_gates[..., :1]
    elif case == "probs_dtype":
        d_probs = d_probs.double()
    elif case == "lse_shape":
        d_lse = d_lse[:, :-1]
    elif case == "noncontiguous":
        d_probs = torch.ones(1, E, 6).transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        ops.fused_topk_route_bwd(probs, idx, d_gates, d_probs, d_lse)


@pytest.mark.parametrize("case", ["h_shape", "dh_shape", "dlast_dtype",
                                  "noncontiguous"])
def test_rg_lru_bwd_rejects_what_the_kernel_does_not_take(case):
    a, b, h0, dh, dl = (torch.tensor(v) for v in _scan_inputs(2, 8, 16))
    h = b
    if case == "h_shape":
        h = h[:, :-1]
    elif case == "dh_shape":
        dh = dh[:, :, :-1]
    elif case == "dlast_dtype":
        dl = dl.double()
    else:
        dh = dh.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        ops.rg_lru_scan_bwd(a, h, h0, dh, dl)


# ---------------------------------------------------------------------------
# the CUDA kernels (a card only)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_route_bwd_equals_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    ops.reset_launches()
    n = 0
    for R, T, E, K in ROUTE_SHAPES + [(1, 2048, 8, 2)]:
        x = torch.tensor(_route_logits(R, T, E, seed=T)).cuda()
        idx, _, probs, _, _ = ops.fused_topk_route(x, K)
        for use in GRADS:
            grads = [None if g is None else g.cuda()
                     for g in _route_grads(R, T, E, K, use, seed=T)]
            got = ops.fused_topk_route_bwd(probs, idx, *grads)
            torch.cuda.synchronize()
            want = ref.fused_topk_route_bwd_plain(probs, idx, *grads)
            assert float((got - want).abs().max()) <= 1e-6
            n += 1
    assert ops.LAUNCHES["fused_topk_route_bwd"] == n
    with pytest.raises(ValueError):
        tk_kernel.check_bwd_inputs(torch.zeros(1, 2, 257, device="cuda"),
                                   torch.zeros(1, 2, 2, dtype=torch.int32,
                                               device="cuda"), None, None,
                                   None)


@pytest.mark.cuda
def test_cuda_rg_lru_bwd_equals_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    ops.reset_launches()
    n = 0
    shapes = [(*s, True) for s in SCAN_SHAPES + [(2, 1024, 2560)]]
    for B, S, D, aligned in shapes + RING_EDGE_SHAPES:
        a, b, h0, dh, dl = (torch.tensor(v).cuda()
                            for v in _scan_inputs(B, S, D))
        h_all, _ = ops.rg_lru_scan(a, b, h0)
        if not aligned:
            a, h_all, h0, dh, dl = (off16(t) for t in (a, h_all, h0, dh, dl))
            assert a.data_ptr() % 16 == 4
        for use in ((True, True), (True, False), (False, True)):
            grads = [g if u else None for g, u in zip((dh, dl), use)]
            got = ops.rg_lru_scan_bwd(a, h_all, h0, *grads)
            torch.cuda.synchronize()
            want = ref.rg_lru_scan_bwd_plain(a, h_all, h0, *grads)
            assert all(torch.equal(g, w) for g, w in zip(got, want))
            n += 1
    assert ops.LAUNCHES["rg_lru_scan_bwd"] == n
    with pytest.raises(ValueError):
        rg_kernel.check_bwd_inputs(*(torch.zeros(s, device="cuda") for s in (
            (1, 4, 8), (1, 4, 8), (1, 8), (1, 4, 7))), None)


@pytest.mark.cuda
def test_cuda_functions_launch_backward_only_under_autograd():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    moe = get_config("mixtral-8x7b").moe
    x = torch.randn(64, 32, device="cuda", requires_grad=True)
    w = torch.randn(32, moe.num_experts, device="cuda", requires_grad=True)
    ops.reset_launches()
    with torch.inference_mode():
        route(w, moe, x)
    assert ops.LAUNCHES["fused_topk_route"] == 1
    out = route(w, moe, x)
    (out.gates.sum() + out.aux_loss + out.z_loss).backward()
    assert ops.LAUNCHES["fused_topk_route"] == 2
    assert ops.LAUNCHES["fused_topk_route_bwd"] == 1
    assert x.grad is not None and w.grad is not None
