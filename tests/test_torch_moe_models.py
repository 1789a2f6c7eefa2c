"""The paper's other MoE models in the PyTorch port against the JAX
package, on the CPU: ``llama-moe-3.5b`` (16 experts, top-4, MHA),
``switch-base-128`` (128 experts, top-1, relu, MHA) and ``arctic-480b``
(128 experts, top-2, 56 query heads over 8 KV heads, a dense residual
branch beside the experts).

* Configs: every field of every port config (and of its ``reduced()``)
  equals the JAX config's, and so do ``num_params()``, ``active_params()``
  and the roofline's op model for the three models (1e-12 relative); ``reduced()`` caps shared experts at 1 and the dense
  branch at 256, as the JAX one does.
* The bridge: JAX tree -> port -> JAX tree returns every leaf, the dense
  branch's and a relu model's unused expert ``w_gate`` included, as its
  bf16 rounding (fp32 leaves exactly); the trainable round trip is exact.
* Prefill plus three paged decode steps against the JAX step functions on
  bridged weights, at ``reduced()`` (which caps E at 4 and K at 2 and
  makes llama-moe GQA) and at narrow variants at d 64 that keep the
  published routing (E 16, top-4; E 128, top-1, relu), both MHA: logits
  within ``LOGIT_ATOL`` (``tests/test_torch_model.py``'s), expert counts
  equal.
* The router's backward at the widths this slice trains (E 64, 128 and
  256, K 1 and 2): ``fused_topk_route_bwd_plain`` against ``jax.grad``
  through softmax, top-k and logsumexp, within 1e-6 absolute (fp32, the
  sum over E in another order), and ``route`` (through
  ``FusedTopkRoute``) against ``jax.grad`` of the JAX package's dense
  route at ``tests/test_torch_train_kernels.py``'s 1e-5. The kernel
  against its plain version on a card: ``tests/test_torch_route_bwd_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import roofline as jroof  # noqa: E402
from repro.configs.base import INPUT_SHAPES as JAX_INPUT_SHAPES  # noqa: E402
from repro.configs.base import ModelConfig as JaxModelConfig  # noqa: E402
from repro.configs.base import MoEConfig as JaxMoEConfig  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models.transformer import init_model as jax_init_model  # noqa: E402
from repro.moe.router import route as jax_route  # noqa: E402
from repro_torch import roofline as roof  # noqa: E402
from repro_torch.bridge import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.configs.base import ModelConfig, MoEConfig  # noqa: E402
from repro_torch.configs.registry import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.transformer import init_model  # noqa: E402
from repro_torch.moe.router import route  # noqa: E402

from tests.test_torch_model import LOGIT_ATOL, _run_jax, _run_torch  # noqa: E402
from tests.test_torch_route_bwd_cuda import WIDE_ROUTER, _route_case  # noqa: E402

ARCHS = ("llama-moe-3.5b", "switch-base-128", "arctic-480b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_same_fields(port, jax_cfg):
    """Every field of the port's config equals the JAX config's (the JAX
    one has fields for families the port does not serve yet)."""
    for f in dataclasses.fields(port):
        a, b = getattr(port, f.name), getattr(jax_cfg, f.name)
        if f.name in ("moe", "mla", "encoder") and a is not None:
            for g in dataclasses.fields(a):
                assert getattr(a, g.name) == getattr(b, g.name), (
                    port.name, g.name)
        else:
            assert a == b, (port.name, f.name, a, b)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_registry_holds_the_paper_models():
    for arch in ARCHS:
        assert arch in ALL_ARCHS and get_config(arch).name == arch


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_config_and_reduced_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    _assert_same_fields(cfg, jcfg)
    _assert_same_fields(cfg.reduced(), jcfg.reduced())
    assert cfg.num_params() == jcfg.num_params()
    assert cfg.active_params() == jcfg.active_params()
    assert cfg.reduced().num_params() == jcfg.reduced().num_params()


@pytest.mark.parametrize("chips", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_op_model_matches_jax(arch, chips):
    """``roofline``'s FLOPs, HBM bytes and model FLOPs for every assigned
    input shape (Arctic's dense branch and relu's two matrices included)."""
    for name, shape in INPUT_SHAPES.items():
        jshape = JAX_INPUT_SHAPES[name]
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        for got, want in (
                (roof.analytic_flops(cfg, shape),
                 jroof.analytic_flops(jcfg, jshape)),
                (roof.analytic_hbm_bytes(cfg, shape, chips),
                 jroof.analytic_hbm_bytes(jcfg, jshape, chips)),
                (roof.model_flops(cfg, shape), jroof.model_flops(jcfg, jshape))):
            assert got == pytest.approx(want, rel=1e-12, abs=0), name


@pytest.mark.parametrize("moe_kw", [
    dict(dense_residual=True, d_ff_dense=4864),
    dict(num_shared_experts=2),
    dict(num_shared_experts=3, dense_residual=True, d_ff_dense=100)],
    ids=["dense_residual", "shared", "both"])
def test_reduced_caps_shared_experts_and_the_dense_branch(moe_kw):
    kw = dict(name="m", family="moe", num_layers=4, d_model=1024,
              num_heads=8, num_kv_heads=8, d_ff=2048, vocab_size=4096)
    moe = dict(num_experts=16, top_k=2, d_ff_expert=512, **moe_kw)
    cfg = ModelConfig(**kw, moe=MoEConfig(**moe))
    jcfg = JaxModelConfig(**kw, moe=JaxMoEConfig(**moe))
    _assert_same_fields(cfg.reduced(), jcfg.reduced())
    red = cfg.reduced().moe
    assert red.num_shared_experts == min(moe.get("num_shared_experts", 0), 1)
    assert red.d_ff_dense == min(moe.get("d_ff_dense", 0), 256)
    assert cfg.reduced().num_params() == jcfg.reduced().num_params()


def test_init_model_draws_the_dense_branch():
    cfg = get_config("arctic-480b").reduced()
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    d, Fd = cfg.d_model, cfg.moe.d_ff_dense
    layer = model.layers[0]
    assert layer.dense_w_gate.shape == (d, Fd) == layer.dense_w_up.shape
    assert layer.dense_w_down.shape == (Fd, d)
    assert layer.dense_w_up.dtype == torch.bfloat16
    assert set(layer.moe_params()) == {"router", "w_gate", "w_up", "w_down",
                                       "dense_w_gate", "dense_w_up",
                                       "dense_w_down"}
    relu = dataclasses.replace(cfg, activation="relu")
    names = {n for n, _ in init_model(relu, torch.Generator().manual_seed(0),
                                      device="cpu").layers[0]
             .named_parameters()}
    assert "dense_w_gate" not in names and "w_gate" in names


# ---------------------------------------------------------------------------
# the bridge
# ---------------------------------------------------------------------------

def _jax_tree(jcfg):
    return jax.tree.map(np.asarray, jax_init_model(jax.random.PRNGKey(0),
                                                   jcfg))


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trips_bit_exactly(arch):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    tree = _jax_tree(jcfg)
    want = _leaves(tree)
    for trainable in (False, True):
        model = params_from_jax(tree, cfg, device="cpu", trainable=trainable)
        back = _leaves(params_to_jax(model))
        assert back.keys() == want.keys()
        for key, leaf in want.items():
            fp32 = trainable or "scale" in key or "router" in key
            rounded = np.asarray(jnp.asarray(leaf, jnp.bfloat16), np.float32)
            np.testing.assert_array_equal(back[key], leaf if fp32 else rounded,
                                          err_msg=key)
    if cfg.moe.dense_residual:
        assert {k for k in want if "/dense/" in k} == {
            f"layers/moe/dense/{n}" for n in ("w_gate", "w_up", "w_down")}
    if cfg.activation == "relu":
        # the experts' w_gate: held (as the JAX tree holds it), never read
        assert "layers/moe/experts/w_gate" in want


# ---------------------------------------------------------------------------
# prefill and paged decode against the JAX model
# ---------------------------------------------------------------------------

def _narrow(cfg, arch_cfg):
    """d 64, every query head its own KV head, the published routing."""
    return dataclasses.replace(
        cfg, d_model=64, num_kv_heads=cfg.num_heads,
        moe=dataclasses.replace(cfg.moe, num_experts=arch_cfg.moe.num_experts,
                                top_k=arch_cfg.moe.top_k))


MODEL_CASES = [(a, "reduced") for a in ARCHS] + [
    ("llama-moe-3.5b", "narrow"), ("switch-base-128", "narrow")]


@pytest.mark.parametrize("arch,variant", MODEL_CASES)
def test_prefill_and_paged_decode_match_jax(arch, variant):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if variant == "narrow":
        jcfg, cfg = (_narrow(jcfg, jax_get_config(arch)),
                     _narrow(cfg, get_config(arch)))
        assert cfg.num_kv_heads == cfg.num_heads
        assert cfg.moe.top_k == get_config(arch).moe.top_k
    params = jax_init_model(jax.random.PRNGKey(0), jcfg)
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (20, 13)]
    forced = rng.integers(0, cfg.vocab_size, (3, 3)).astype(np.int32)
    forced[-1] = 0                                        # the idle slot
    ops.reset_launches()
    lj, cj = _run_jax(jcfg, params, prompts, forced)
    lt, ct, _ = _run_torch(cfg, model, prompts, forced)
    assert sum(ops.LAUNCHES.values()) == 0
    assert len(lj) == len(lt) == 2 + 3
    for step, (a, b) in enumerate(zip(lj, lt)):
        assert a.shape == b.shape and np.isfinite(b).all()
        live = slice(None) if step < 2 else slice(0, 2)   # idle slot masked
        np.testing.assert_allclose(b[live], a[live], atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"step {step}")
    for step, (a, b) in enumerate(zip(cj, ct)):
        assert b.shape == (cfg.num_layers, cfg.moe.num_experts)
        np.testing.assert_array_equal(b, a, err_msg=f"counts, step {step}")
    np.testing.assert_array_equal(ct[0].sum(-1), 20 * cfg.moe.top_k)


# ---------------------------------------------------------------------------
# the router's backward at E 64 to 256
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,K", WIDE_ROUTER)
def test_route_bwd_plain_matches_jax_grad(E, K):
    """d_logits of gates, probs and lse: the plain backward on the plain
    forward's outputs against ``jax.grad`` through ``jax.nn.softmax``,
    ``lax.top_k`` and ``logsumexp``."""
    R, T = 2, 37
    x, (dg, dp, dl) = _route_case(R, T, E, K, seed=E + K)
    idx, _, probs, _, _ = ref.fused_topk_route_plain(torch.tensor(x), K)

    def f(lg):
        p = jax.nn.softmax(lg, axis=-1)
        gates, _ = jax.lax.top_k(p, K)
        return ((gates * dg).sum() + (p * dp).sum()
                + (jax.nn.logsumexp(lg, axis=-1) * dl).sum())
    want = np.asarray(jax.grad(f)(jnp.asarray(x)))
    _, jidx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x), axis=-1), K)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    got = ref.fused_topk_route_bwd_plain(probs, idx, *(torch.tensor(g) for g
                                                       in (dg, dp, dl)))
    assert got.shape == (R, T, E) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # through ops on CPU tensors: the plain version, no launch
    ops.reset_launches()
    again = ops.fused_topk_route_bwd(probs, idx, *(torch.tensor(g) for g
                                                   in (dg, dp, dl)))
    assert torch.equal(again, got) and not any(ops.LAUNCHES.values())


@pytest.mark.parametrize("E,K", WIDE_ROUTER)
def test_route_gradients_match_jax_dense_route_when_wide(E, K):
    """``route`` through ``FusedTopkRoute`` against ``jax.grad`` of the JAX
    package's dense route: the tokens' and the router weight's gradients
    of a weighted sum of the gates, the probs and the aux and z losses."""
    moe = MoEConfig(num_experts=E, top_k=K, d_ff_expert=8)
    jmoe = JaxMoEConfig(num_experts=E, top_k=K, d_ff_expert=8)
    rng = np.random.default_rng(E * 10 + K)
    T, d = 24, 32
    x = rng.normal(size=(T, d)).astype(np.float32)
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
    for got, want in ((tx.grad, jdx), (tw.grad, jdw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)
