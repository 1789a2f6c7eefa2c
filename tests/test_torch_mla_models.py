"""DeepSeek-V2-Lite (``deepseek-v2-lite-16b``) in the PyTorch port against
the JAX package, on the CPU: multi-head latent attention (MLA) and the MoE
block's shared experts.

Three configs: ``reduced()`` (E 4, K 2, one shared expert, nope = rope =
v = 32: q/k 64 wide, as ``head_dim``), the scale variant (nope 64, rope
32, v 48: q/k 96 wide while ``head_dim`` stays 64, so a softmax scale of
1/sqrt(head_dim) would show, and V narrower than nope) and the router
variant (the published routing's E 16, K 6 and 2 shared experts: the
router's K rounds and a shared FFN 2 x F wide).

* Configs: every field (``mla`` and ``moe`` field by field) equals the JAX
  config's, at full width and at ``reduced()``; ``num_params()`` is
  16.210198528e9 at full width; ``attention_flops`` over a grid of tokens,
  lengths and causality, and the roofline's FLOPs, HBM bytes (the latent
  cache's) and model FLOPs equal the JAX package's to 1e-12 relative.
* The bridge: JAX tree -> port -> JAX tree has the JAX ``init_model``'s
  tree structure and returns every leaf, MLA's six projections and the
  shared FFN's three included: bf16-stored leaves as their bf16 rounding,
  fp32 ones (and all of them under ``trainable``) exactly.
* Modules alone, on one layer's weights from the JAX init: ``mla_attention``
  and ``mla_prefill`` + two ``mla_decode`` steps (outputs and the latent
  cache) against the JAX functions run op by op (``jax.disable_jit()``),
  within 1e-2 of the bf16 outputs (one bf16 ulp at their magnitude of ~2:
  the two round sums in other orders); ``shared_branch`` and
  ``moe_ffn_dense`` with shared experts and a dense residual branch
  (shared first, as the reference adds them) within 1e-5 in fp32 and one
  bf16 ulp of the block's largest output in bf16.
* The whole model, op by op against ``repro.models.transformer.forward``
  on the same numpy weights with wide router margins over all K picks
  (``widen_topk``): train-mode logits, then a prefill into the latent
  cache and two linear-cache decode steps: logits within ``LOGIT_ATOL``
  (``tests/test_torch_model.py``'s 5e-2, the Mixtral model test's), the
  latent cache within 2e-2 of its values (bf16, up to ~2) and the expert
  counts equal.
* The MoE kernels' plain versions are held against the JAX Pallas
  kernels at deepseek's widths in ``tests/test_torch_moe_kernels.py`` and
  ``tests/test_torch_moe_models.py``; the kernels themselves against their
  plain versions on a card in ``tests/test_torch_mla_cuda.py``.
"""

import dataclasses
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import roofline as jroof  # noqa: E402
from repro.configs.base import INPUT_SHAPES as JAX_INPUT_SHAPES  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.core import simulator as jsim  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.layers import ffn as jax_ffn  # noqa: E402
from repro.models.moe import moe_ffn_dense as jax_moe_ffn_dense  # noqa: E402
from repro.models.transformer import Runtime as JaxRuntime  # noqa: E402
from repro.models.transformer import forward as jax_forward  # noqa: E402
from repro.models.transformer import init_cache as jax_init_cache  # noqa: E402
from repro.models.transformer import init_model as jax_init_model  # noqa: E402
from repro_torch import roofline as roof  # noqa: E402
from repro_torch.bridge import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.configs.registry import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.core import simulator as tsim  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.moe import moe_ffn_dense, shared_branch  # noqa: E402
from repro_torch.models.transformer import (Runtime, Transformer,  # noqa: E402
                                            check_config, forward,
                                            init_cache, init_model)

from tests._torch_margins import widen_margins  # noqa: E402
from tests.test_torch_model import LOGIT_ATOL  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
FULL_PARAMS = 16_210_198_528
VARIANTS = ("reduced", "scale", "router")
MODULE_TOL = 1e-2              # bf16 module outputs of magnitude ~2
CACHE_TOL = 2e-2               # the latent cache after a layer of bf16 noise
MLA_NAMES = ("w_dkv", "w_krope", "w_uk", "w_uv", "w_q", "wo")
SHARED_NAMES = ("shared_w_gate", "shared_w_up", "shared_w_down")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def variant(cfg, name: str):
    """``cfg`` (a reduced deepseek, port's or JAX's) as one of
    ``VARIANTS``."""
    if name == "scale":
        return dataclasses.replace(cfg, mla=dataclasses.replace(
            cfg.mla, nope_head_dim=64, rope_head_dim=32, v_head_dim=48))
    if name == "router":
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=16, top_k=6, num_shared_experts=2))
    return cfg


def cfgs(name: str):
    """(JAX config, port config) of a variant."""
    return (variant(jax_get_config(ARCH).reduced(), name),
            variant(get_config(ARCH).reduced(), name))


def widen_topk(tree, cfg, keep_head: bool = False):
    """``widen_margins`` (``tests/_torch_margins.py``), with the router's
    preference graded over all K picks: token group g prefers experts g,
    g + 1, ..., g + K - 1 by about 4.6 logits each (widen_margins grades
    the first two only), so no pick of a top-6 route sits near a tie.
    ``keep_head``: the JAX init's ``lm_head`` (logits of magnitude ~3, at
    which ``LOGIT_ATOL`` is a few bf16 ulps) in place of the widened one."""
    out = widen_margins(tree, cfg)
    d, E, K = cfg.d_model, cfg.moe.num_experts, cfg.moe.top_k
    if K > 2:
        v = np.linalg.qr(np.random.default_rng(1234).normal(size=(d, E)))[0].T
        rows = np.arange(E)
        extra = np.zeros((E, E))
        for j in range(K):
            extra[rows, (rows + j) % E] += K - j
        extra[rows, rows] -= 2.0
        extra[rows, (rows + 1) % E] -= 1.0
        layers = dict(out["layers"])
        moe = dict(layers["moe"])
        moe["router"] = {"w": np.asarray(moe["router"]["w"], np.float32)
                         + 0.3 * (v.T @ extra)[None].astype(np.float32)}
        layers["moe"] = moe
        out["layers"] = layers
    if keep_head:
        out["lm_head"] = tree["lm_head"]
    return out


# the source a JAX subprocess execs (with np and widen_margins in scope)
WIDEN_TOPK_SOURCE = inspect.getsource(widen_topk)


def _jax_tree(jcfg, seed=0):
    return jax.tree.map(np.asarray, jax_init_model(jax.random.PRNGKey(seed),
                                                   jcfg))


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# configs, counts and the roofline
# ---------------------------------------------------------------------------

def test_registry_holds_deepseek():
    assert ARCH in ALL_ARCHS and len(ALL_ARCHS) == 13      # llava the 13th
    cfg = get_config(ARCH)
    assert cfg.attention == "mla" and cfg.moe.num_shared_experts == 2
    assert (cfg.moe.num_experts, cfg.moe.top_k) == (64, 6)


@pytest.mark.parametrize("name", ("full",) + VARIANTS)
def test_config_fields_and_counts_match_jax(name):
    if name == "full":
        jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    else:
        jcfg, cfg = cfgs(name)
    for f in dataclasses.fields(cfg):
        a, b = getattr(cfg, f.name), getattr(jcfg, f.name)
        if f.name in ("mla", "moe"):
            for g in dataclasses.fields(a):
                assert getattr(a, g.name) == getattr(b, g.name), (f.name,
                                                                  g.name)
        else:
            assert a == b, f.name
    assert cfg.num_params() == jcfg.num_params()
    assert cfg.active_params() == jcfg.active_params()
    if name == "full":
        assert cfg.num_params() == FULL_PARAMS
    if name == "reduced":
        m = cfg.mla
        assert (m.kv_lora_rank, m.rope_head_dim, m.nope_head_dim,
                m.v_head_dim) == (64, 32, 32, 32)
        assert cfg.moe.num_shared_experts == 1


def test_mla_without_its_config_has_no_count():
    """attention "mla" with no MLAConfig is not a model the port builds:
    the counts refuse it rather than count GQA's or nothing."""
    bad = dataclasses.replace(get_config(ARCH), mla=None)
    with pytest.raises(NotImplementedError):
        bad.num_params()
    with pytest.raises(NotImplementedError):
        tsim.attention_flops(bad, 8, 64)
    with pytest.raises(ValueError):
        check_config(bad)


@pytest.mark.parametrize("name", ("full",) + VARIANTS)
def test_attention_flops_match_jax(name):
    if name == "full":
        jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    else:
        jcfg, cfg = cfgs(name)
    for tokens in (1, 512, 8192):
        for seq in (1, 256, 4096, 32768):
            for causal in (True, False):
                assert tsim.attention_flops(cfg, tokens, seq, causal) == \
                    jsim.attention_flops(jcfg, tokens, seq, causal)
    assert tsim.dense_ffn_flops_per_token(cfg) == \
        jsim.dense_ffn_flops_per_token(jcfg) > 0        # the shared experts


@pytest.mark.parametrize("chips", [1, 4])
@pytest.mark.parametrize("name", ["full", "reduced"])
def test_roofline_op_model_matches_jax(name, chips):
    if name == "full":
        jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    else:
        jcfg, cfg = cfgs(name)
    for shape_name, shape in INPUT_SHAPES.items():
        jshape = JAX_INPUT_SHAPES[shape_name]
        for got, want in (
                (roof.analytic_flops(cfg, shape),
                 jroof.analytic_flops(jcfg, jshape)),
                (roof.analytic_hbm_bytes(cfg, shape, chips),
                 jroof.analytic_hbm_bytes(jcfg, jshape, chips)),
                (roof.model_flops(cfg, shape),
                 jroof.model_flops(jcfg, jshape))):
            assert got == pytest.approx(want, rel=1e-12, abs=0), shape_name


def test_roofline_reads_the_latent_cache():
    """A decode step's HBM bytes count c_kv and k_rope per position (576
    values a layer at full width), not GQA's K and V."""
    cfg = get_config(ARCH)
    shape = INPUT_SHAPES["decode_32k"]
    gqa = dataclasses.replace(cfg, attention="gqa", mla=None)
    latent = roof.analytic_hbm_bytes(cfg, shape, 1) \
        - (cfg.num_params() - gqa.num_params()) * 2
    kv = roof.analytic_hbm_bytes(gqa, shape, 1)
    per_pos = shape.global_batch * shape.seq_len * cfg.num_layers * 2
    assert kv - latent == pytest.approx(
        per_pos * (2 * cfg.num_kv_heads * cfg.head_dim
                   - (cfg.mla.kv_lora_rank + cfg.mla.rope_head_dim)),
        rel=1e-12)


# ---------------------------------------------------------------------------
# the model's parameters and the bridge
# ---------------------------------------------------------------------------

def test_init_model_draws_mla_and_the_shared_experts():
    _, cfg = cfgs("router")
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    m, d, H = cfg.mla, cfg.d_model, cfg.num_heads
    Fs = cfg.moe.num_shared_experts * cfg.moe.d_ff_expert
    layer = model.layers[0]
    want = {"w_dkv": (d, m.kv_lora_rank), "w_krope": (d, m.rope_head_dim),
            "w_uk": (m.kv_lora_rank, H * m.nope_head_dim),
            "w_uv": (m.kv_lora_rank, H * m.v_head_dim),
            "w_q": (d, H * (m.nope_head_dim + m.rope_head_dim)),
            "wo": (H * m.v_head_dim, d), "shared_w_gate": (d, Fs),
            "shared_w_up": (d, Fs), "shared_w_down": (Fs, d)}
    for n, shape in want.items():
        t = getattr(layer, n)
        assert tuple(t.shape) == shape and t.dtype == torch.bfloat16, n
        # the JAX init_dense / init_ffn scale, 1/sqrt(d_in), of a normal
        # truncated at 2 (std 0.8796)
        assert float(t.float().std()) == pytest.approx(
            0.8796 / shape[0] ** 0.5, rel=0.1), n
    assert set(layer.attn_params()) == set(MLA_NAMES)
    assert set(SHARED_NAMES) <= set(layer.moe_params())
    assert not any(hasattr(layer, n) for n in ("wq", "wk", "wv"))
    trainable = init_model(cfg, torch.Generator().manual_seed(0), device="cpu",
                           trainable=True)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in trainable.parameters())


def test_check_config_admits_mla_on_the_moe_family_only():
    _, cfg = cfgs("reduced")
    check_config(cfg)
    dense = dataclasses.replace(cfg, family="dense", moe=None)
    with pytest.raises(ValueError, match="has no port"):
        check_config(dense)
    with pytest.raises(ValueError, match="has no port"):
        Transformer(dense, {}, [])


@pytest.mark.parametrize("name", VARIANTS)
def test_bridge_round_trips_with_the_jax_tree_structure(name):
    jcfg, cfg = cfgs(name)
    tree = _jax_tree(jcfg)
    want = _leaves(tree)
    assert {f"layers/attn/{n}/w" for n in MLA_NAMES} <= want.keys()
    assert {f"layers/moe/shared/{n}" for n in ("w_gate", "w_up",
                                               "w_down")} <= want.keys()
    for trainable in (False, True):
        model = params_from_jax(tree, cfg, device="cpu", trainable=trainable)
        back = params_to_jax(model)
        assert jax.tree.structure(back) == jax.tree.structure(tree)
        got = _leaves(back)
        for key, leaf in want.items():
            fp32 = trainable or "scale" in key or "router" in key
            rounded = np.asarray(jnp.asarray(leaf, jnp.bfloat16), np.float32)
            np.testing.assert_array_equal(got[key], leaf if fp32 else rounded,
                                          err_msg=key)


# ---------------------------------------------------------------------------
# the modules alone
# ---------------------------------------------------------------------------

def _layer0(tree, block):
    return jax.tree.map(lambda a: a[0], tree["layers"][block])


def _port_attn(tree, cfg):
    model = params_from_jax(tree, cfg, device="cpu")
    return model, model.layers[0].attn_params()


@pytest.mark.parametrize("name", VARIANTS)
def test_mla_attention_matches_jax(name):
    jcfg, cfg = cfgs(name)
    tree = _jax_tree(jcfg)
    jp = _layer0(tree, "attn")
    _, p = _port_attn(tree, cfg)
    rng = np.random.default_rng(1)
    B, S = 2, 40
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    with jax.disable_jit():
        want = jattn.mla_attention(jp, jcfg, jnp.asarray(x, jnp.bfloat16),
                                   jnp.asarray(pos))
    with torch.no_grad():
        got = tattn.mla_attention(p, cfg, torch.tensor(x).bfloat16(),
                                  torch.tensor(pos))
    assert got.dtype == torch.bfloat16 and got.shape == (B, S, cfg.d_model)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=MODULE_TOL, rtol=MODULE_TOL)


def test_mla_softmax_scale_is_the_query_width():
    """At the scale variant q/k are nope + rope = 96 wide while head_dim
    is 64: the port matches an fp32 numpy MLA at 1/sqrt(96) and not at
    1/sqrt(64)."""
    _, cfg = cfgs("scale")
    m, H = cfg.mla, cfg.num_heads
    model = init_model(cfg, torch.Generator().manual_seed(3), device="cpu",
                       trainable=True)
    p = {n: t.detach() for n, t in model.layers[0].attn_params().items()}
    rng = np.random.default_rng(2)
    B, S = 1, 12
    x = torch.tensor(rng.normal(size=(B, S, cfg.d_model)).astype(np.float32))
    pos = torch.arange(S)[None]
    with torch.no_grad():
        got = tattn.mla_attention(p, cfg, x, pos).numpy()
        q_nope, q_rope, c_kv, k_rope = tattn._mla_qkv(p, cfg, x, pos)
        k_nope, v = tattn._mla_expand(p, cfg, c_kv)
    q = torch.cat([q_nope, q_rope], -1).numpy()[0]            # (S, H, 96)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, m.rope_head_dim)],
                  -1).numpy()[0]
    v = v.numpy()[0]

    def attend(scale):
        s = np.einsum("qhd,khd->hqk", q, k) * scale
        s = np.where(np.tril(np.ones((S, S), bool))[None], s, -np.inf)
        pr = np.exp(s - s.max(-1, keepdims=True))
        pr /= pr.sum(-1, keepdims=True)
        o = np.einsum("hqk,khd->qhd", pr, v).reshape(S, H * m.v_head_dim)
        return o @ p["wo"].numpy()
    right = attend(1 / np.sqrt(m.nope_head_dim + m.rope_head_dim))
    wrong = attend(1 / np.sqrt(cfg.head_dim))
    np.testing.assert_allclose(got[0], right, atol=1e-4, rtol=1e-4)
    assert np.abs(got[0] - wrong).max() > 1e-2


@pytest.mark.parametrize("name", VARIANTS)
def test_mla_prefill_and_decode_match_jax(name):
    """``mla_prefill`` then two ``mla_decode`` steps over one layer's
    latent cache (S_max 24, positions past the written ones masked): the
    outputs and both cache tensors."""
    jcfg, cfg = cfgs(name)
    tree = _jax_tree(jcfg)
    jp = _layer0(tree, "attn")
    _, p = _port_attn(tree, cfg)
    rng = np.random.default_rng(4)
    B, S, S_max = 2, 13, 24
    xs = rng.normal(size=(B, S + 2, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S), (B, S)).astype(np.int32)
    jc = jattn.init_mla_cache(jcfg, B, S_max)
    tc = tattn.init_mla_cache(cfg, B, S_max)
    assert tuple(tc["c_kv"].shape) == (B, S_max, cfg.mla.kv_lora_rank)
    assert tuple(tc["k_rope"].shape) == (B, S_max, cfg.mla.rope_head_dim)
    outs = []
    with jax.disable_jit():
        ja, jc = jattn.mla_prefill(jp, jcfg, jnp.asarray(xs[:, :S],
                                                         jnp.bfloat16),
                                   jnp.asarray(pos), jc)
        jouts = [ja]
        for t in range(2):
            ja, jc = jattn.mla_decode(
                jp, jcfg, jnp.asarray(xs[:, S + t:S + t + 1], jnp.bfloat16),
                jc, S + t)
            jouts.append(ja)
    with torch.no_grad():
        outs.append(tattn.mla_prefill(p, cfg, torch.tensor(xs[:, :S])
                                      .bfloat16(), torch.tensor(pos), tc))
        for t in range(2):
            outs.append(tattn.mla_decode(
                p, cfg, torch.tensor(xs[:, S + t:S + t + 1]).bfloat16(), tc,
                S + t))
    for step, (got, want) in enumerate(zip(outs, jouts)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=MODULE_TOL, rtol=MODULE_TOL,
                                   err_msg=f"step {step}")
    for k in ("c_kv", "k_rope"):
        np.testing.assert_allclose(tc[k].float().numpy(),
                                   np.asarray(jc[k], np.float32),
                                   atol=MODULE_TOL, rtol=MODULE_TOL,
                                   err_msg=k)
        assert not tc[k][:, S + 2:].any()          # nothing past the writes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["reduced", "router"])
def test_shared_branch_and_moe_block_match_jax(name, dtype):
    """``shared_branch`` alone, and ``moe_ffn_dense`` with the shared
    experts and (for the order of the two adds) a dense residual branch,
    against the JAX block on the same weights: in fp32 within 1e-5 (sums
    in another order), in bf16 within one bf16 ulp of the block's largest
    output (the block adds three bf16 terms of that size, so an output near
    zero keeps their rounding)."""
    jcfg, cfg = cfgs(name)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, dense_residual=True, d_ff_dense=96))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dense_residual=True, d_ff_dense=96))
    tree = _jax_tree(jcfg)
    jp = _layer0(tree, "moe")
    fp32 = dtype == "float32"
    model = params_from_jax(tree, cfg, device="cpu", trainable=fp32)
    moe_p = {k: v.detach() for k, v in model.layers[0].moe_params().items()}
    assert tuple(moe_p["shared_w_up"].shape) == (
        cfg.d_model, cfg.moe.num_shared_experts * cfg.moe.d_ff_expert)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 7, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x, jnp.float32 if fp32 else jnp.bfloat16)
    tx = torch.tensor(x).to(torch.float32 if fp32 else torch.bfloat16)
    with jax.disable_jit():
        want_s = jax_ffn(jp["shared"], jx, jcfg.activation)
        want_y, want_r = jax_moe_ffn_dense(jp, jcfg, jx)
    with torch.no_grad():
        got_s = shared_branch(moe_p, cfg, tx)
        got_y, got_r = moe_ffn_dense(moe_p, cfg, tx)
    for got, want in ((got_s, want_s), (got_y, want_y)):
        want = np.asarray(want, np.float32)
        tol = 1e-5 if fp32 else 2.0 ** (np.floor(np.log2(
            np.abs(want).max())) - 7)
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=tol)
    np.testing.assert_array_equal(got_r.expert_idx.numpy(),
                                  np.asarray(want_r.expert_idx))
    no_shared = {k: v for k, v in moe_p.items() if not k.startswith("shared_")}
    assert shared_branch(no_shared, cfg, tx) is None


# ---------------------------------------------------------------------------
# the whole model: train mode, prefill and linear-cache decode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=VARIANTS)
def model_run(request):
    """One variant on ``widen_topk`` weights through both packages: train
    logits, a prefill of 2 x 20 tokens into a 32-position latent cache and
    two teacher-forced decode steps; the JAX side op by op."""
    jcfg, cfg = cfgs(request.param)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        widen_topk(_jax_tree(jcfg), jcfg, keep_head=True))
    params = jax.tree.map(jnp.asarray, tree)
    model = params_from_jax(tree, cfg, device="cpu")
    rng = np.random.default_rng(6)
    B, S, S_max = 2, 20, 32
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (B, 2)).astype(np.int32)
    jax_out, port_out = {}, {}
    with jax.disable_jit():
        lg, _, st = jax_forward(params, jcfg, {"tokens": jnp.asarray(toks)},
                                JaxRuntime(), mode="train")
        jax_out["train"] = (np.asarray(lg, np.float32),
                            np.asarray(st["expert_counts"]))
        cache = jax_init_cache(jcfg, JaxRuntime(), B, S_max)
        lg, cache, st = jax_forward(params, jcfg,
                                    {"tokens": jnp.asarray(toks)},
                                    JaxRuntime(), mode="prefill", cache=cache)
        steps = [(np.asarray(lg, np.float32), np.asarray(st["expert_counts"]))]
        for t in range(2):
            lg, cache, st = jax_forward(
                params, jcfg, {"tokens": jnp.asarray(forced[:, t:t + 1])},
                JaxRuntime(), mode="decode", cache=cache, cache_len=S + t)
            steps.append((np.asarray(lg, np.float32),
                          np.asarray(st["expert_counts"])))
        jax_out["serve"] = steps
        jax_out["cache"] = {k: np.asarray(v, np.float32)
                            for k, v in cache.items()}
    ops.reset_launches()
    with torch.no_grad():
        lg, _, st = forward(model, cfg, torch.tensor(toks), Runtime(),
                            mode="train")
        port_out["train"] = (lg.float().numpy(), st["expert_counts"].numpy())
        cache = init_cache(cfg, Runtime(), B, S_max, device="cpu")
        lg, cache, st = forward(model, cfg, torch.tensor(toks), Runtime(),
                                mode="prefill", cache=cache)
        steps = [(lg.float().numpy(), st["expert_counts"].numpy())]
        for t in range(2):
            lg, cache, st = forward(model, cfg,
                                    torch.tensor(forced[:, t:t + 1]),
                                    Runtime(), mode="decode", cache=cache,
                                    cache_len=S + t)
            steps.append((lg.float().numpy(), st["expert_counts"].numpy()))
        port_out["serve"] = steps
        port_out["cache"] = {k: v.float().numpy() for k, v in cache.items()}
    assert sum(ops.LAUNCHES.values()) == 0       # the CPU runs plain versions
    return cfg, jax_out, port_out


def test_train_logits_match_jax(model_run):
    cfg, want, got = model_run
    (lj, cj), (lt, ct) = want["train"], got["train"]
    assert lt.shape == lj.shape == (2, 20, cfg.vocab_size)
    np.testing.assert_allclose(lt, lj, atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_array_equal(ct, cj)
    assert ct.sum() == cfg.num_layers * 2 * 20 * cfg.moe.top_k


def test_prefill_and_decode_logits_and_latent_cache_match_jax(model_run):
    cfg, want, got = model_run
    for step, ((lj, cj), (lt, ct)) in enumerate(zip(want["serve"],
                                                    got["serve"])):
        assert lt.shape == lj.shape == (2, 1, cfg.vocab_size)
        np.testing.assert_allclose(lt, lj, atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(ct, cj, err_msg=f"counts, step {step}")
    m, L = cfg.mla, cfg.num_layers
    shapes = {"c_kv": (L, 2, 32, m.kv_lora_rank),
              "k_rope": (L, 2, 32, m.rope_head_dim)}
    for k, shape in shapes.items():
        assert got["cache"][k].shape == want["cache"][k].shape == shape
        np.testing.assert_allclose(got["cache"][k], want["cache"][k],
                                   atol=CACHE_TOL, rtol=CACHE_TOL, err_msg=k)
        assert not got["cache"][k][:, :, 22:].any()   # 20 + 2 written


def test_paged_decode_refuses_mla():
    _, cfg = cfgs("reduced")
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    cache = init_cache(cfg, Runtime(), 1, 16, device="cpu")
    with pytest.raises(ValueError, match="GQA only"):
        forward(model, cfg, torch.zeros((1, 1), dtype=torch.int64),
                Runtime(), mode="decode", cache=cache,
                cache_len=torch.tensor([3], dtype=torch.int32),
                block_tables=torch.zeros((1, 2), dtype=torch.int32))
