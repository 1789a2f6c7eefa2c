"""The PyTorch port's VLM backbone (``llava-next-34b``) against the JAX
package, on the CPU: the config, the counts, the roofline, the bridge, the
prefix input (``_embed_inputs``) and the whole model in train, prefill and
decode mode, from the same (bridged) weights and the same numpy prefix
embeddings and tokens.

The model tests run the two variants of ``tests/_torch_vlm.py``:
``reduced()`` (G 2, head_dim 64, 8 prefix embeddings) and "wide" (G 7 at
head_dim 128, 600 prefix embeddings and 40 tokens: P + S crosses a 512
block of the chunked attention, and the text's RoPE positions start at
600). Prefix embeddings are fp32, so the cast to the embedding's dtype
runs. The JAX side runs jitted in one subprocess without XLA's excess
precision (under it XLA keeps bf16 fusions in fp32, where the port, like
JAX op by op, rounds every operation). Tolerances, each with its reason:

* prefill and decode logits within ``LOGIT_ATOL`` = 5e-2
  (``tests/test_torch_model.py``'s: bf16 activations, products summed in
  other orders);
* train-mode logits over all P + S positions (1.3M of them in "wide", up
  to ~4.6 in magnitude) within ``TRAIN_REL`` = 2e-2 in norm and
  ``TRAIN_ATOL`` = 1e-1 elementwise (~3 bf16 ulps at 4): the two packages'
  rounding differs by ~7.5e-3 in norm at ``reduced()`` with no prefix at
  all, against JAX op by op as well as jitted, and by ~1e-2 at "wide",
  prefix or not, where a few of the 1.3M logits sit 5-7e-2 apart;
* the KV cache after the prefill and after two decode steps within 2e-2
  in norm (bf16 projections of bf16 streams an ulp apart here and there).
"""

import dataclasses
import inspect
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import roofline as jroof  # noqa: E402
from repro.configs.base import INPUT_SHAPES as JAX_INPUT_SHAPES  # noqa: E402
from repro.configs.registry import ALL_ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models.transformer import init_model as jax_init_model  # noqa: E402
from repro_torch import roofline as roof  # noqa: E402
from repro_torch.bridge import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.configs.registry import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.models.transformer import (Runtime, _embed_inputs,  # noqa: E402
                                            _layer_shapes, check_config,
                                            forward, init_cache, init_model)
from tests._torch_vlm import SOURCE as HELPERS  # noqa: E402
from tests._torch_vlm import PREFIX, TEXT, VARIANTS  # noqa: E402
from tests._torch_vlm import vlm_config, vlm_prefix, vlm_tokens  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "llava-next-34b"
LOGIT_ATOL = 5e-2
TRAIN_ATOL, TRAIN_REL = 1e-1, 2e-2
CACHE_REL = 2e-2
B, NEW = 2, 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced model's operations are tiny: one intra-op thread runs
    them as fast as many, and keeps this file from oversubscribing the
    cores when test workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    return np.asarray(t.float().numpy() if torch.is_tensor(t) else t,
                      np.float32)


def _rel(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-300))


def _configs(name):
    return (vlm_config(get_config(ARCH).reduced(), name),
            vlm_config(jax_get_config(ARCH).reduced(), name))


# --------------------------------------------------------------------------
# the config, the counts, the roofline
# --------------------------------------------------------------------------

def test_registry_holds_all_thirteen_jax_configs():
    assert sorted(ALL_ARCHS) == sorted(JAX_ARCHS) and len(ALL_ARCHS) == 13
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.attention, cfg.input_mode) == ("vlm", "gqa",
                                                           "mixed")
    assert cfg.num_prefix_embeddings == 2880 and not cfg.is_moe
    assert cfg.paged_attn_impl == "fused"
    check_config(cfg)
    assert not hasattr(transformer, "UNPORTED_FAMILIES")


@pytest.mark.parametrize("name", ("full",) + VARIANTS)
def test_config_and_counts_match_jax(name):
    if name == "full":
        cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    else:
        cfg, jcfg = _configs(name)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.num_params() == jcfg.num_params()
    assert cfg.active_params() == jcfg.active_params()
    assert cfg.reduced().num_prefix_embeddings == min(
        cfg.num_prefix_embeddings, 8)


def test_param_count_is_what_the_model_holds_less_the_norms():
    """34,388,049,920, the JAX count: 60 layers of 557.85e6 (Q and O 7168
    x 7168, K and V 7168 x 1024, three 7168 x 20480 FFN matrices) and the
    untied embedding and head (64000 x 7168 each); the model holds the
    norm scales too (two a layer and the final one)."""
    cfg = get_config(ARCH)
    assert cfg.num_params() == 34_388_049_920
    held = sum(int(np.prod(shape)) for shape, _, _ in
               _layer_shapes(cfg, "attn").values()) * cfg.num_layers
    held += 2 * cfg.vocab_size * cfg.d_model + cfg.d_model
    assert held - cfg.num_params() == (2 * cfg.num_layers + 1) * cfg.d_model


@pytest.mark.parametrize("chips", [1, 4])
def test_roofline_op_model_matches_jax(chips):
    for cfg, jcfg in ((get_config(ARCH), jax_get_config(ARCH)),
                      _configs("reduced"), _configs("wide")):
        for sname, shape in INPUT_SHAPES.items():
            jshape = JAX_INPUT_SHAPES[sname]
            for got, want in (
                    (roof.analytic_flops(cfg, shape),
                     jroof.analytic_flops(jcfg, jshape)),
                    (roof.analytic_hbm_bytes(cfg, shape, chips),
                     jroof.analytic_hbm_bytes(jcfg, jshape, chips)),
                    (roof.model_flops(cfg, shape),
                     jroof.model_flops(jcfg, jshape))):
                assert got == pytest.approx(want, rel=1e-12, abs=0), sname


def test_roofline_counts_the_prefix_in_the_flops_only():
    """Train and prefill run the FFN and the head over P more tokens a row
    (the attention terms keep the text length, as in JAX); decode adds
    nothing; ``analytic_hbm_bytes`` and ``model_flops`` leave the prefix
    out."""
    from repro_torch.core.simulator import (attention_flops,
                                            dense_ffn_flops_per_token,
                                            ffn_flops_per_token)

    cfg = get_config(ARCH)
    text = dataclasses.replace(cfg, input_mode="tokens")
    P, L = cfg.num_prefix_embeddings, cfg.num_layers
    for sname, shape in INPUT_SHAPES.items():
        extra = roof.analytic_flops(cfg, shape) - roof.analytic_flops(
            text, shape)
        assert roof.model_flops(cfg, shape) == roof.model_flops(text, shape)
        assert roof.analytic_hbm_bytes(cfg, shape, 1) == \
            roof.analytic_hbm_bytes(text, shape, 1)
        if shape.kind == "decode":
            assert extra == 0
            continue
        n0 = shape.global_batch * shape.seq_len
        n1 = shape.global_batch * (shape.seq_len + P)
        per_token = (ffn_flops_per_token(cfg) + dense_ffn_flops_per_token(
            cfg)) * L + 2 * cfg.d_model * cfg.vocab_size
        want = (attention_flops(cfg, n1, shape.seq_len)
                - attention_flops(cfg, n0, shape.seq_len)) * L \
            + per_token * (n1 - n0)
        want *= 3.0 if shape.kind == "train" else 1.0
        assert extra == pytest.approx(want, rel=1e-12), sname


# --------------------------------------------------------------------------
# check_config, the bridge, the prefix input
# --------------------------------------------------------------------------

def test_check_config_takes_the_vlm_on_gqa():
    cfg = get_config(ARCH).reduced()
    check_config(cfg)
    for bad in (dataclasses.replace(cfg, attention="mla"),
                dataclasses.replace(cfg, attention="none")):
        with pytest.raises(ValueError, match="has no port"):
            check_config(bad)


@pytest.fixture(scope="module")
def trees():
    """{variant: the JAX init's tree (numpy)}."""
    return {name: jax.tree.map(np.asarray, jax_init_model(
        jax.random.PRNGKey(0), _configs(name)[1])) for name in VARIANTS}


@pytest.mark.parametrize("name", VARIANTS)
def test_bridge_round_trips_with_the_dense_keys(trees, name):
    """A VLM's tree is a dense model's: no key of its own."""
    cfg, jcfg = _configs(name)
    tree = trees[name]
    dense = jax_init_model(jax.random.PRNGKey(0), dataclasses.replace(
        jcfg, family="dense", input_mode="tokens", num_prefix_embeddings=0))
    assert jax.tree.structure(tree) == jax.tree.structure(dense)
    assert set(tree) == {"embed", "final_norm", "lm_head", "layers"}
    assert set(tree["layers"]) == {"ln1", "ln2", "attn", "ffn"}
    model = params_from_jax(tree, cfg, device="cpu")
    back = params_to_jax(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree.leaves(tree))
    H, hd = cfg.num_heads, cfg.head_dim
    assert tuple(model.layers[0].wq.shape) == (cfg.d_model, H * hd)
    exact = params_to_jax(params_from_jax(tree, cfg, device="cpu",
                                          trainable=True))
    for a, b in zip(jax.tree.leaves(exact), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_embed_inputs_casts_and_places_the_prefix_first():
    cfg = get_config(ARCH).reduced()
    P, S = PREFIX["reduced"], TEXT["reduced"]
    prefix = torch.tensor(vlm_prefix("reduced", B, cfg.d_model))
    tokens = torch.tensor(vlm_tokens("reduced", B, cfg.vocab_size))
    for trainable in (False, True):
        model = init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu", trainable=trainable)
        with torch.no_grad():
            x = _embed_inputs(model, cfg, tokens, prefix)
            tok = _embed_inputs(model, cfg, tokens)
        assert x.dtype == torch.bfloat16 and tuple(x.shape) == (
            B, P + S, cfg.d_model)
        # fp32 -> the table's dtype -> bf16 is fp32 -> bf16 either way
        assert torch.equal(x[:, :P], prefix.to(torch.bfloat16))
        assert torch.equal(x[:, P:], tok)
    # another input mode runs tokens only, whatever the batch carries
    text = dataclasses.replace(cfg, input_mode="tokens")
    with torch.no_grad():
        assert torch.equal(_embed_inputs(model, text, tokens, prefix), tok)


def test_forward_takes_the_prefix_in_train_and_prefill_only():
    cfg = get_config(ARCH).reduced()
    P, S = PREFIX["reduced"], TEXT["reduced"]
    model = init_model(cfg, torch.Generator().manual_seed(1), device="cpu")
    prefix = torch.tensor(vlm_prefix("reduced", B, cfg.d_model))
    tokens = torch.tensor(vlm_tokens("reduced", B, cfg.vocab_size))
    rt = Runtime()
    with torch.inference_mode():
        train, _, st = forward(model, cfg, tokens, rt, mode="train",
                               prefix_embeds=prefix)
        bare, _, _ = forward(model, cfg, tokens, rt, mode="train")
        lg, cache, _ = forward(model, cfg, tokens, rt, mode="prefill",
                               prefix_embeds=prefix)
        # a prefill with no cache makes one of P + S positions
        assert tuple(cache["k"].shape) == (2, B, P + S, 2, 64)
        big = init_cache(cfg, rt, B, P + S + 1, device="cpu")
        forward(model, cfg, tokens, rt, mode="prefill", cache=big,
                prefix_embeds=prefix)
        one = tokens[:, :1]
        a, _, _ = forward(model, cfg, one, rt, mode="decode",
                          cache={k: t.clone() for k, t in big.items()},
                          cache_len=P + S, prefix_embeds=prefix)
        b, _, _ = forward(model, cfg, one, rt, mode="decode", cache=big,
                          cache_len=P + S)
    assert st["expert_counts"] is None
    assert tuple(train.shape) == (B, P + S, cfg.vocab_size)
    assert tuple(bare.shape) == (B, S, cfg.vocab_size)
    assert torch.equal(lg[:, -1], train[:, -1])
    # the prefix reaches the text positions
    assert float((train[:, P:].float() - bare.float()).abs().max()) > 1e-2
    assert torch.equal(a, b)                     # decode ignores the prefix


# --------------------------------------------------------------------------
# the model against JAX (one subprocess)
# --------------------------------------------------------------------------

SUB = '''
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_allow_excess_precision=false"
import numpy as np
import jax, jax.numpy as jnp
from repro.configs.registry import get_config
from repro.models.transformer import Runtime, forward, init_cache, init_model

exec(os.environ["VM_HELPERS"])
arch, variants, (B, NEW) = eval(os.environ["VM_ARGS"])
rt = Runtime()
f32 = lambda a: np.asarray(a, np.float32)
res = {}
for name in variants:
    cfg = vlm_config(get_config(arch).reduced(), name)
    p = init_model(jax.random.PRNGKey(0), cfg)
    P, S = PREFIX[name], TEXT[name]
    prefix = jnp.asarray(vlm_prefix(name, B, cfg.d_model))
    tokens = jnp.asarray(vlm_tokens(name, B, cfg.vocab_size))
    forced = vlm_tokens(name, B, cfg.vocab_size, seed=1)[:, :NEW]
    batch = {"tokens": tokens, "prefix_embeds": prefix}
    out = {"train": f32(jax.jit(lambda p, b: forward(
        p, cfg, b, rt, mode="train")[0])(p, batch))}
    prefill = jax.jit(lambda p, b, c: forward(
        p, cfg, b, rt, mode="prefill", cache=c)[:2])
    decode = jax.jit(lambda p, t, c, n: forward(
        p, cfg, {"tokens": t}, rt, mode="decode", cache=c, cache_len=n)[:2])
    lg, cache = prefill(p, batch, init_cache(cfg, rt, B, P + S + NEW))
    out["logits"] = [f32(lg)]
    out["prefill_cache"] = {k: f32(v) for k, v in cache.items()}
    for i in range(NEW):
        lg, cache = decode(p, jnp.asarray(forced[:, i:i + 1]), cache,
                           P + S + i)
        out["logits"].append(f32(lg))
    out["cache"] = {k: f32(v) for k, v in cache.items()}
    res[name] = out
with open(sys.argv[1], "wb") as fh:
    pickle.dump(res, fh)
'''


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("vlm_models") / "jax_vlm.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               VM_HELPERS=HELPERS, VM_ARGS=repr((ARCH, VARIANTS, (B, NEW))))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB),
                           str(out)], capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("name", VARIANTS)
def test_model_matches_jax(jax_ref, trees, name):
    """Train-mode logits over P + S positions, a prefill of the prefix and
    the prompts, two decode steps at the true positions P + S + i, and the
    cache after each, against the JAX forward on the same bridged
    weights."""
    ref = jax_ref[name]
    cfg, _ = _configs(name)
    P, S = PREFIX[name], TEXT[name]
    model = params_from_jax(trees[name], cfg, device="cpu")
    prefix = torch.tensor(vlm_prefix(name, B, cfg.d_model))
    tokens = torch.tensor(vlm_tokens(name, B, cfg.vocab_size))
    forced = vlm_tokens(name, B, cfg.vocab_size, seed=1)[:, :NEW]
    rt = Runtime()
    ops.reset_launches()
    with torch.inference_mode():
        train, _, _ = forward(model, cfg, tokens, rt, mode="train",
                              prefix_embeds=prefix)
        cache = init_cache(cfg, rt, B, P + S + NEW, device="cpu")
        lg, _, _ = forward(model, cfg, tokens, rt, mode="prefill",
                           cache=cache, prefix_embeds=prefix)
        logits = [lg.float().numpy()]
        pre = {k: t.clone() for k, t in cache.items()}
        for i in range(NEW):
            lg, _, _ = forward(model, cfg, torch.tensor(forced[:, i:i + 1]),
                               rt, mode="decode", cache=cache,
                               cache_len=P + S + i)
            logits.append(lg.float().numpy())
    assert sum(ops.LAUNCHES.values()) == 0
    assert tuple(train.shape) == ref["train"].shape == (B, P + S,
                                                        cfg.vocab_size)
    np.testing.assert_allclose(train.float().numpy(), ref["train"],
                               atol=TRAIN_ATOL, rtol=0)
    assert _rel(train, ref["train"]) <= TRAIN_REL
    for step, (got, want) in enumerate(zip(logits, ref["logits"])):
        assert got.shape == want.shape == (B, 1, cfg.vocab_size)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"step {step}")
    for got, want in ((pre, ref["prefill_cache"]), (cache, ref["cache"])):
        for k in ("k", "v"):
            assert tuple(got[k].shape) == want[k].shape == (
                2, B, P + S + NEW, 2, cfg.head_dim), k
            assert _rel(got[k], want[k]) <= CACHE_REL, k


# --------------------------------------------------------------------------
# chip_smoke.py's llava phase, its pieces on the CPU
# --------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_variants_and_inputs_are_the_tests():
    """The phase's card-vs-CPU variants are this file's own: it loads
    ``tests/_torch_vlm.py`` from its path; its prefix embeddings are
    seeded at the token embeddings' scale."""
    cs = _chip_smoke()
    vlm = cs.llava_variants()
    assert Path(vlm.__file__).resolve() == ROOT / "tests" / "_torch_vlm.py"
    reduced = get_config(ARCH).reduced()
    assert vlm.VARIANTS == VARIANTS and vlm.PREFIX == PREFIX
    for name in VARIANTS:
        assert vlm.vlm_config(reduced, name) == vlm_config(reduced, name)
    p = cs.llava_prefix(3, 2, 5, 8, "cpu")
    assert tuple(p.shape) == (2, 5, 8) and p.dtype == torch.float32
    assert torch.equal(p, cs.llava_prefix(3, 2, 5, 8, "cpu"))
    assert 0.01 < float(p.std()) < 0.04          # the embeddings' 0.02


def test_chip_smoke_gather_check_reads_the_fused_decodes_own_logits():
    """``_DecodeLogits`` on a reduced llava ``ContinuousEngine`` on the
    CPU: every decode step's logits are kept under (request, index) of the
    token it made, whose argmax is that token; the prefill's token (index
    0) has none. ``_gather_against_fused`` compares the steps up to a
    request's first difference (all of them where there is none), takes a
    runner-up there as the gather run's token, and rejects any other token
    and a difference at the prefill."""
    from repro_torch.serve import (ContinuousConfig, ContinuousEngine,
                                   ServeRequest)

    cs = _chip_smoke()
    cfg = get_config(ARCH).reduced()
    model = init_model(cfg, torch.Generator().manual_seed(5), device="cpu")
    eng = ContinuousEngine(cfg, model, ContinuousConfig(
        max_slots=2, prefill_len=32, block_size=8, max_len=48,
        predict_interval=2))
    rng = np.random.default_rng(6)
    reqs = [ServeRequest(rid=i, tokens=rng.integers(
        0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=5,
        arrival=0.0) for i, n in enumerate((7, 12, 9))]
    kept = cs._DecodeLogits()
    kept.install(eng)
    eng.run_trace(reqs)
    cs._DecodeLogits.uninstall(eng)
    assert not hasattr(eng._decode_fn, "real")
    toks = {r.rid: list(r.generated) for r in eng.scheduler.completed}
    assert sorted(toks) == [0, 1, 2]
    fl = kept.logits()
    assert sorted(fl) == [(r, j) for r in range(3) for j in range(1, 5)]
    for (rid, j), row in fl.items():
        assert row.shape == (cfg.vocab_size,) and row.dtype == np.float32
        assert row[toks[rid][j]] == row.max()
    rows = cs._gather_against_fused(fl, fl, toks, toks)
    assert [(r["rid"], r["first_difference"], r["steps"], r["max_abs_err"])
            for r in rows] == [(r, None, 4, 0.0) for r in range(3)]
    gl = {k: v + (0.01 if k == (1, 2) else 0.0) for k, v in fl.items()}
    ids = np.argsort(fl[(1, 3)])[::-1][:2]
    runner_up = int(ids[1]) if ids[0] == toks[1][3] else int(ids[0])
    other = next(t for t in range(cfg.vocab_size) if t not in set(ids))
    for tok, want in ((runner_up, True), (other, False)):
        b = {**toks, 1: toks[1][:3] + [tok] + toks[1][4:]}
        row = cs._gather_against_fused(fl, gl, toks, b)[1]
        assert (row["first_difference"], row["steps"], row["runner_up"]) \
            == (3, 3, want)
        assert row["max_abs_err"] == pytest.approx(0.01, rel=1e-5)
        assert row["top"] == fl[(1, 3)].max()
        assert row["gap"] == fl[(1, 3)].max() - np.sort(fl[(1, 3)])[-2]
    b = {**toks, 2: [toks[2][0] + 1] + toks[2][1:]}
    row = cs._gather_against_fused(fl, fl, toks, b)[2]
    assert (row["first_difference"], row["steps"], row["runner_up"]) \
        == (0, 0, False)
    assert row["max_abs_err"] == float("inf")


def test_chip_smoke_card_vs_cpu_run_on_the_cpu():
    """The phase's ``_llava_run`` on the CPU: the prefill's logits and two
    decode steps' at the true positions, and the cache."""
    cs = _chip_smoke()
    cfg = vlm_config(get_config(ARCH).reduced(), "wide")
    model = init_model(cfg, torch.Generator().manual_seed(2), device="cpu")
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (2, 2)).astype(np.int32)
    prefix = (0.02 * rng.normal(size=(2, 600, cfg.d_model))).astype(
        np.float32)
    logits, cache = cs._llava_run(model, cfg, tokens, prefix, forced)
    assert tuple(logits.shape) == (3, 2, cfg.vocab_size)
    with torch.inference_mode():
        lg, ref_cache, _ = forward(model, cfg, torch.tensor(tokens),
                                   Runtime(), mode="prefill",
                                   prefix_embeds=torch.tensor(prefix))
    assert torch.equal(logits[0], lg[:, -1].float())
    assert tuple(cache["k"].shape) == (2, 2, 614, 2, 128)
    assert torch.equal(cache["k"][:, :, :612], ref_cache["k"].float())
    assert cs.rel_err(logits[2], logits[0]) > 1e-3
