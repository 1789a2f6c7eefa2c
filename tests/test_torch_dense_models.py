"""The dense family in the PyTorch port against the JAX package, on the
CPU: ``qwen1.5-0.5b`` (QKV biases), ``olmo-1b`` (the non-parametric
LayerNorm), ``stablelm-3b`` (head_dim 80) and ``minicpm-2b`` (tied
embeddings, the WSD schedule).

* Configs: every field of every port config (and of its ``reduced()``)
  equals the JAX config's, and so do ``num_params()`` (the tied ``emb``
  term included; both formulas leave the QKV biases out),
  ``active_params()`` and the roofline's op model (``analytic_flops``,
  ``analytic_hbm_bytes``, ``model_flops``, 1e-12 relative) for every
  assigned input shape on 1 and 4 chips. The registry holds nine
  architectures; the families still to come are refused with their
  ROADMAP item.
* ``nonparametric_layernorm`` against the JAX one on inputs whose mean is
  a thousand times their spread, in fp32 (atol ``LN_ATOL``: about six
  fp32 ulps of the mean, 6.1e-5 each at 1000, over a unit spread; the two
  frameworks sum the mean in another order) and bf16 (one bf16 ulp); the
  Bessel-corrected variance misses that tolerance by more than 10x.
* The bridge: JAX tree -> port -> JAX tree returns every leaf (the biases
  among them) as its bf16 rounding (fp32 leaves exactly), with
  ``jax.tree.structure`` equal to ``init_model``'s: olmo's empty norm
  dicts, no ``lm_head`` for minicpm. The trainable round trip is exact, and
  the AdamW state's trees have the same structure.
* The forward on bridged weights with nonzero QKV biases drawn into the
  numpy tree (the JAX init makes them zero, which would hide a missing or
  misplaced bias): train-mode logits over the whole sequence, and a slot
  prefill plus three paged decode steps, against the JAX package run op by
  op (eager, so no fusion keeps excess precision), at ``reduced()`` and at
  stablelm's ``reduced()`` with ``head_dim=80``; logits within
  ``LOGIT_ATOL`` (``tests/test_torch_model.py``'s), the stats equal (no
  expert counts, zero aux and z losses).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import roofline as jroof  # noqa: E402
from repro.configs.base import INPUT_SHAPES as JAX_INPUT_SHAPES  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models.transformer import Runtime as JaxRuntime  # noqa: E402
from repro.models.transformer import forward as jax_forward  # noqa: E402
from repro.models.transformer import init_cache as jax_init_cache  # noqa: E402
from repro.models.transformer import init_model as jax_init_model  # noqa: E402
from repro.serve import kvcache as jkv  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import roofline as roof  # noqa: E402
from repro_torch.bridge import (opt_state_to_jax, params_from_jax,  # noqa: E402
                                params_to_jax)
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.configs.registry import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.transformer import (NO_MOE_STATS, Runtime,  # noqa: E402
                                            Transformer, check_config,
                                            init_model)
from repro_torch.serve import kvcache as tkv  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from repro_torch.train.steps import init_opt_state  # noqa: E402

from tests.test_torch_model import LOGIT_ATOL  # noqa: E402

ARCHS = ("qwen1.5-0.5b", "olmo-1b", "stablelm-3b", "minicpm-2b")
# (arch, head_dim override): reduced() forces head_dim 64, so stablelm's 80
# is a variant of its own
VARIANTS = [(a, 0) for a in ARCHS] + [("stablelm-3b", 80)]
LN_ATOL = {"float32": 4e-4, "bfloat16": 2e-2}
S, BS, MAXLEN = 32, 8, 64


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, head_dim=0):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    if head_dim:
        jcfg = dataclasses.replace(jcfg, head_dim=head_dim)
        cfg = dataclasses.replace(cfg, head_dim=head_dim)
    return jcfg, cfg


def _tree(jcfg, seed=0):
    """The JAX init's tree as numpy, with nonzero QKV biases where the
    config has them (drawn here: the init's are zero)."""
    tree = jax.tree.map(np.asarray, jax_init_model(jax.random.PRNGKey(seed),
                                                   jcfg))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(seed + 7)
        for n in ("wq", "wk", "wv"):
            b = tree["layers"]["attn"][n]["b"]
            tree["layers"]["attn"][n]["b"] = rng.normal(
                0.0, 0.5, b.shape).astype(np.float32)
    return tree


def _leaves(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_registry_holds_nine_architectures():
    # nine GQA models, deepseek-v2-lite-16b (MLA), rwkv6-7b (ssm),
    # seamless-m4t-medium (the encoder-decoder) and llava-next-34b (vlm)
    assert len(ALL_ARCHS) == 13
    for arch in ARCHS:
        assert arch in ALL_ARCHS and get_config(arch).name == arch
        assert get_config(arch).family == "dense" and not get_config(arch).is_moe


@pytest.mark.parametrize("arch", ARCHS)
def test_config_reduced_and_counts_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for port, ref in ((cfg, jcfg), (cfg.reduced(), jcfg.reduced())):
        for f in dataclasses.fields(port):
            assert getattr(port, f.name) == getattr(ref, f.name), (
                port.name, f.name)
        assert port.num_params() == ref.num_params()
        assert port.active_params() == ref.active_params()
    if cfg.tie_embeddings:
        # the tied model counts one (V, d) table
        untied = dataclasses.replace(cfg, tie_embeddings=False)
        assert untied.num_params() - cfg.num_params() == \
            cfg.vocab_size * cfg.d_model


@pytest.mark.parametrize("chips", [1, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_op_model_matches_jax(arch, chips):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name, shape in INPUT_SHAPES.items():
        jshape = JAX_INPUT_SHAPES[name]
        for got, want in (
                (roof.analytic_flops(cfg, shape),
                 jroof.analytic_flops(jcfg, jshape)),
                (roof.analytic_hbm_bytes(cfg, shape, chips),
                 jroof.analytic_hbm_bytes(jcfg, jshape, chips)),
                (roof.model_flops(cfg, shape), jroof.model_flops(jcfg, jshape))):
            assert got == pytest.approx(want, rel=1e-12, abs=0), name


@pytest.mark.parametrize("family,attention,item", [
    ("audio", "gqa", "2e"), ("vlm", "gqa", "2f")])
def test_families_still_to_come_are_refused(family, attention, item):
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              family=family, attention=attention)
    if item == "2f":
        # item 2f, the VLM prefix input, is ported: a GQA stack of the vlm
        # family is accepted and builds
        check_config(cfg)
        assert Transformer(cfg, {}, []).cfg.family == "vlm"
        return
    # item 2e, the encoder-decoder, is ported: an audio config without its
    # encoder is refused
    with pytest.raises(ValueError, match="encoder-decoder"):
        check_config(cfg)
    with pytest.raises(ValueError, match="encoder-decoder"):
        Transformer(cfg, {}, [])


# ---------------------------------------------------------------------------
# the non-parametric LayerNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nonparametric_layernorm_matches_jax(dtype):
    rng = np.random.default_rng(3)
    x = (1000.0 + rng.normal(size=(6, 5, 256))).astype(np.float32)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want = np.asarray(jlayers.nonparametric_layernorm(jnp.asarray(x, jd)),
                      np.float32)
    got = layers.nonparametric_layernorm(torch.tensor(x).to(td))
    assert got.dtype == td
    np.testing.assert_allclose(got.float().numpy(), want,
                               atol=LN_ATOL[dtype], rtol=0)
    assert np.isfinite(want).all() and np.abs(want).max() > 2
    # apply_norm dispatches to it and takes no scale
    assert torch.equal(layers.apply_norm("nonparametric", None,
                                         torch.tensor(x).to(td)), got)
    if dtype == "float32":
        # the Bessel-corrected variance would not pass
        xt = torch.tensor(x)
        mu = xt.mean(-1, keepdim=True)
        bessel = (xt - mu) * torch.rsqrt(xt.var(-1, keepdim=True) + 1e-5)
        assert np.abs(bessel.numpy() - want).max() > 10 * LN_ATOL[dtype]


# ---------------------------------------------------------------------------
# the bridge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trips_with_the_jax_tree_structure(arch):
    jcfg, cfg = _configs(arch)
    tree = _tree(jcfg)
    structure = jax.tree.structure(jax_init_model(jax.random.PRNGKey(0), jcfg))
    assert jax.tree.structure(tree) == structure
    want = _leaves(tree)
    for trainable in (False, True):
        model = params_from_jax(tree, cfg, device="cpu", trainable=trainable)
        back = params_to_jax(model)
        assert jax.tree.structure(back) == structure
        back = _leaves(back)
        assert back.keys() == want.keys()
        for key, leaf in want.items():
            fp32 = trainable or "scale" in key
            rounded = np.asarray(jnp.asarray(leaf, jnp.bfloat16), np.float32)
            np.testing.assert_array_equal(back[key], leaf if fp32 else rounded,
                                          err_msg=key)
    opt = opt_state_to_jax(init_opt_state(model), model)
    assert jax.tree.structure(opt.mu) == structure == \
        jax.tree.structure(opt.nu)
    names = {n for n, _ in model.named_parameters()}
    if cfg.norm == "nonparametric":
        assert tree["final_norm"] == {} and tree["layers"]["ln1"] == {}
        assert not any("ln" in n or "norm" in n for n in names)
    if cfg.tie_embeddings:
        assert "lm_head" not in tree and "lm_head" not in names
    if cfg.qkv_bias:
        assert {"layers.0.bq", "layers.0.bk", "layers.0.bv"} <= names
        assert np.abs(want["layers/attn/wq/b"]).max() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_init_model_has_the_jax_init_trees_leaves(arch):
    """The port's own init: the JAX tree's structure and leaf shapes, zero
    biases (as ``init_dense`` makes them)."""
    jcfg, cfg = _configs(arch)
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    got = params_to_jax(model)
    want = jax_init_model(jax.random.PRNGKey(0), jcfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (k, a), b in zip(_leaves(got).items(), _leaves(want).values()):
        assert a.shape == b.shape, k
        if k.endswith("/b"):
            assert not a.any(), k


# ---------------------------------------------------------------------------
# the forward against the JAX model
# ---------------------------------------------------------------------------

def _run_jax(jcfg, params, prompts, forced):
    """A slot prefill per prompt and teacher-forced paged decode steps over
    one pool (the last slot idle), op by op."""
    rt = JaxRuntime(window_override=MAXLEN)
    prefill = jsteps.make_slot_prefill_step(jcfg, rt)
    decode = jsteps.make_paged_decode_step(jcfg, rt)
    B, M = len(prompts) + 1, MAXLEN // BS
    pool = jkv.init_block_pool(jcfg, 1 + B * M, BS)
    tables = np.zeros((B, M), np.int32)
    logits, stats = [], []
    for b, p in enumerate(prompts):
        tables[b] = 1 + b * M + np.arange(M)
        toks = np.zeros((1, S), np.int32)
        toks[0, :len(p)] = p
        tw = (np.arange(S) < len(p)).astype(np.float32)[None]
        _, lg, temp, st = prefill(params, {"tokens": jnp.asarray(toks)},
                                  jax_init_cache(jcfg, rt, 1, S),
                                  last_pos=jnp.asarray([len(p) - 1]),
                                  token_weight=jnp.asarray(tw))
        pool = jkv.write_prefill_blocks(pool, temp,
                                        jnp.asarray(tables[b, :S // BS]))
        logits.append(np.asarray(lg, np.float32))
        stats.append(st)
    lengths = np.asarray([len(p) for p in prompts] + [0], np.int32)
    active = (lengths > 0).astype(np.float32)[:, None]
    for t in range(forced.shape[1]):
        _, lg, pool, st = decode(params, jnp.asarray(forced[:, t:t + 1]), pool,
                                 jnp.asarray(tables), jnp.asarray(lengths),
                                 token_weight=jnp.asarray(active))
        logits.append(np.asarray(lg, np.float32))
        stats.append(st)
        lengths = lengths + (lengths > 0)
    return logits, stats


def _run_torch(cfg, model, prompts, forced):
    rt = Runtime(window_override=MAXLEN)
    prefill = tsteps.make_slot_prefill_step(cfg, rt)
    decode = tsteps.make_paged_decode_step(cfg, rt)
    B, M = len(prompts) + 1, MAXLEN // BS
    pool = tkv.init_block_pool(cfg, 1 + B * M, BS, device="cpu")
    tables = np.zeros((B, M), np.int32)
    logits, stats = [], []
    for b, p in enumerate(prompts):
        tables[b] = 1 + b * M + np.arange(M)
        toks = np.zeros((1, S), np.int32)
        toks[0, :len(p)] = p
        tw = (np.arange(S) < len(p)).astype(np.float32)[None]
        _, lg, temp, st = prefill(model, torch.tensor(toks), None,
                                  torch.tensor([len(p) - 1]), torch.tensor(tw))
        tkv.write_prefill_blocks(pool, temp, tables[b, :S // BS])
        logits.append(lg.float().numpy())
        stats.append(st)
    lengths = np.asarray([len(p) for p in prompts] + [0], np.int32)
    active = (lengths > 0).astype(np.float32)[:, None]
    for t in range(forced.shape[1]):
        _, lg, pool, st = decode(model, torch.tensor(forced[:, t:t + 1]), pool,
                                 torch.tensor(tables), torch.tensor(lengths),
                                 torch.tensor(active))
        logits.append(lg.float().numpy())
        stats.append(st)
        lengths = lengths + (lengths > 0)
    return logits, stats, pool


def _assert_no_moe_stats(jst, tst):
    assert tst == NO_MOE_STATS
    assert jst["expert_counts"] is None
    assert float(jst["aux_loss"]) == float(jst["z_loss"]) == 0.0


@pytest.mark.parametrize("arch,head_dim", VARIANTS)
def test_train_logits_match_jax(arch, head_dim):
    jcfg, cfg = _configs(arch, head_dim)
    tree = _tree(jcfg)
    model = params_from_jax(tree, cfg, device="cpu")
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 24)).astype(np.int32)
    want, _, jst = jax_forward(jax.tree.map(jnp.asarray, tree), jcfg,
                               {"tokens": jnp.asarray(toks)}, JaxRuntime(),
                               mode="train")
    with torch.no_grad():
        got, cache, st = model(torch.tensor(toks), mode="train")
    assert cache is None and got.shape == want.shape == (2, 24, cfg.vocab_size)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=LOGIT_ATOL, rtol=0)
    _assert_no_moe_stats(jst, st)


@pytest.mark.parametrize("arch,head_dim", VARIANTS)
def test_prefill_and_paged_decode_match_jax(arch, head_dim):
    jcfg, cfg = _configs(arch, head_dim)
    tree = _tree(jcfg)
    params = jax.tree.map(jnp.asarray, tree)
    model = params_from_jax(tree, cfg, device="cpu")
    assert model.layers[0].wq.shape[1] == cfg.num_heads * cfg.head_dim
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (20, 13)]
    forced = rng.integers(0, cfg.vocab_size, (3, 3)).astype(np.int32)
    forced[-1] = 0                                        # the idle slot
    ops.reset_launches()
    lj, sj = _run_jax(jcfg, params, prompts, forced)
    lt, st, pool = _run_torch(cfg, model, prompts, forced)
    assert sum(ops.LAUNCHES.values()) == 0       # the CPU runs plain versions
    assert len(lj) == len(lt) == 2 + 3
    for step, (a, b) in enumerate(zip(lj, lt)):
        assert a.shape == b.shape and np.isfinite(b).all()
        live = slice(None) if step < 2 else slice(0, 2)   # idle slot masked
        np.testing.assert_allclose(b[live], a[live], atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"step {step}")
    for a, b in zip(sj, st):
        _assert_no_moe_stats(a, b)
    # the idle slot's table row is all null block: block 0 stays clean
    assert float(pool["k"][:, 0].abs().max()) == 0.0


def test_qkv_biases_reach_every_attention_path():
    """Zeroing qwen's biases moves the train, prefill and decode logits by
    far more than the tolerance: a path that dropped them would fail the
    parity tests above."""
    jcfg, cfg = _configs("qwen1.5-0.5b")
    tree = _tree(jcfg)
    zero = jax.tree_util.tree_map_with_path(
        lambda p, a: np.zeros_like(a) if getattr(p[-1], "key", "") == "b"
        else a, tree)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (20, 13)]
    forced = rng.integers(0, cfg.vocab_size, (3, 2)).astype(np.int32)
    runs = [_run_torch(cfg, params_from_jax(t, cfg, device="cpu"), prompts,
                       forced)[0] for t in (tree, zero)]
    for step, (a, b) in enumerate(zip(*runs)):
        assert np.abs(a - b).max() > 10 * LOGIT_ATOL, step
