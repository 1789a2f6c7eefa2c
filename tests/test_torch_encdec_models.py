"""The PyTorch port's encoder-decoder (``seamless-m4t-medium``) against the
JAX package, on the CPU: the config, the counts, the roofline, the bridge,
the encoder (``_encode``), the cross-attention, and the whole model in
train, prefill and decode mode, from the same (bridged) weights and the
same numpy frames and tokens.

Every module and model test runs the three variants of
``tests/_torch_encdec.py``: ``reduced()`` over 40 frames; the same over
600 frames (two key blocks, the second padded); G 1 in both stacks with
the encoder at 8 heads of 32 (RoPE's width differs from the decoder's),
over 600 frames. The JAX side runs jitted in one subprocess without XLA's
excess precision (under it XLA keeps bf16 fusions in fp32, where the port,
like JAX op by op, rounds every operation). Tolerances, each with its
reason:

* ``_encode``'s bf16 output (after ``enc_norm``, values up to ~4): within
  ``ENC_ATOL`` = 5e-2 elementwise and 1e-2 in norm: both round bf16
  products summed in other orders, about one bf16 ulp at that magnitude
  over two layers.
* ``cross_attention`` on one layer's weights over random bf16 inputs: k
  and v within 1e-3 in norm (one bf16 product each, summed in other
  orders: a few elements one bf16 ulp apart), the output within 1e-2 in
  norm.
* the model: logits within ``LOGIT_ATOL`` = 5e-2
  (``tests/test_torch_model.py``'s), train-mode logits too; the self and
  cross caches within 2e-2 in norm (bf16 projections of bf16 streams that
  are themselves an ulp apart here and there; ~5e-3 seen).
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
import jax.numpy as jnp  # noqa: E402

from repro import roofline as jroof  # noqa: E402
from repro.configs.base import INPUT_SHAPES as JAX_INPUT_SHAPES  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models.transformer import init_model as jax_init_model  # noqa: E402
from repro_torch import roofline as roof  # noqa: E402
from repro_torch.bridge import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.configs.registry import ALL_ARCHS, get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.transformer import (Runtime, Transformer,  # noqa: E402
                                            _encode, _layer_shapes,
                                            check_config, encoder_config,
                                            forward, init_cache, init_model)
from tests._torch_encdec import SOURCE as HELPERS  # noqa: E402
from tests._torch_encdec import FRAMES, VARIANTS  # noqa: E402
from tests._torch_encdec import encdec_config, encdec_frames  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "seamless-m4t-medium"
LOGIT_ATOL = 5e-2
ENC_ATOL = 5e-2
B, S, NEW = 2, 24, 2


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
    return (encdec_config(get_config(ARCH).reduced(), name),
            encdec_config(jax_get_config(ARCH).reduced(), name))


def _tokens(vocab):
    rng = np.random.default_rng(11)
    return (rng.integers(0, vocab, (B, S)).astype(np.int32),
            rng.integers(0, vocab, (B, NEW)).astype(np.int32))


def _cross_inputs(d, d_enc, frames):
    """The decoder stream x (B, S, d) and an encoder output (B, frames,
    d_enc) for ``cross_attention`` alone: seeded standard normals."""
    rng = np.random.default_rng(21)
    return (rng.normal(size=(B, S, d)).astype(np.float32),
            rng.normal(size=(B, frames, d_enc)).astype(np.float32))


# --------------------------------------------------------------------------
# the config, the counts, the roofline
# --------------------------------------------------------------------------

def test_registry_holds_seamless():
    assert ARCH in ALL_ARCHS and len(ALL_ARCHS) == 13
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.attention, cfg.activation) == ("audio", "gqa",
                                                           "gelu")
    assert cfg.is_encdec and not cfg.is_moe
    check_config(cfg)


@pytest.mark.parametrize("name", ("full",) + VARIANTS)
def test_config_and_counts_match_jax(name):
    if name == "full":
        cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    else:
        cfg, jcfg = _configs(name)
    for f in dataclasses.fields(cfg):
        a, b = getattr(cfg, f.name), getattr(jcfg, f.name)
        if f.name == "encoder":
            for g in dataclasses.fields(a):
                assert getattr(a, g.name) == getattr(b, g.name), g.name
        else:
            assert a == b, f.name
    assert cfg.num_params() == jcfg.num_params()
    assert cfg.active_params() == jcfg.active_params()


def test_param_count_leaves_out_cross_attention_and_norms():
    """``num_params()`` is the JAX formula's 826,699,776; the model holds
    877,094,912 (the 12 x 4 x 1024^2 cross-attention weights and every
    norm scale more), as the JAX ``init_model`` draws them."""
    cfg = get_config(ARCH)
    assert cfg.num_params() == 826_699_776
    held = sum(int(np.prod(shape)) for shape, _, _ in
               _layer_shapes(cfg, "decoder").values()) * cfg.num_layers
    held += sum(int(np.prod(shape)) for shape, _, _ in
                _layer_shapes(cfg, "encoder").values()) \
        * cfg.encoder.num_layers
    held += 2 * cfg.vocab_size * cfg.d_model + 2 * cfg.d_model   # + norms
    assert held == 877_094_912
    assert held - cfg.num_params() == 12 * 4 * 1024 ** 2 + 5 * 12 * 1024 \
        + 2 * 1024
    # the encoder term ignores the encoder's KV heads, as in JAX
    fewer = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, num_kv_heads=4))
    assert fewer.num_params() == cfg.num_params() == \
        jax_get_config(ARCH).num_params()


@pytest.mark.parametrize("chips", [1, 4])
def test_roofline_op_model_matches_jax(chips):
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
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


def test_roofline_encoder_term_is_the_references():
    """Prefill and train add the encoder over ``max_source_len`` frames a
    row (the decoder's causal attention terms, three FFN matrices at the
    encoder's widths); decode adds nothing."""
    from repro_torch.core.simulator import attention_flops

    cfg = get_config(ARCH)
    dec = dataclasses.replace(cfg, encoder=None, family="dense")
    e = cfg.encoder
    for sname, shape in INPUT_SHAPES.items():
        extra = roof.analytic_flops(cfg, shape) - roof.analytic_flops(
            dec, shape)
        if shape.kind == "decode":
            assert extra == 0
            continue
        etoks = shape.global_batch * e.max_source_len
        want = (attention_flops(cfg, etoks, e.max_source_len)
                + 6 * e.d_model * e.d_ff * etoks) * e.num_layers
        want *= 3.0 if shape.kind == "train" else 1.0
        assert extra == pytest.approx(want, rel=1e-12), sname


# --------------------------------------------------------------------------
# check_config, init, the cache, the bridge
# --------------------------------------------------------------------------

def test_check_config_takes_audio_with_an_encoder_only():
    cfg = get_config(ARCH).reduced()
    check_config(cfg)
    for bad in (dataclasses.replace(cfg, encoder=None),
                dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                                    encoder=cfg.encoder)):
        with pytest.raises(ValueError, match="encoder-decoder"):
            check_config(bad)
        with pytest.raises(ValueError, match="encoder-decoder"):
            Transformer(bad, {}, [])
    for bad in (dataclasses.replace(cfg, attention="mla"),
                dataclasses.replace(cfg, moe=get_config(
                    "mixtral-8x7b").reduced().moe)):
        with pytest.raises(ValueError, match="has no port"):
            check_config(bad)


def test_encoder_config_is_the_references():
    for name in VARIANTS:
        cfg, _ = _configs(name)
        e = encoder_config(cfg)
        enc = cfg.encoder
        assert (e.num_layers, e.d_model, e.num_heads, e.num_kv_heads,
                e.d_ff) == (enc.num_layers, enc.d_model, enc.num_heads,
                            enc.num_kv_heads, enc.d_ff)
        assert e.head_dim == enc.d_model // enc.num_heads
        assert (e.encoder, e.moe, e.attention) == (None, None, "gqa")
        assert (e.norm, e.activation, e.rope_theta) == (
            cfg.norm, cfg.activation, cfg.rope_theta)
    assert encoder_config(_configs("g1")[0]).head_dim == 32


def test_init_model_and_cache():
    cfg = get_config(ARCH).reduced()
    m = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert [lay.kind for lay in m.layers] == ["decoder"] * 2
    assert [lay.kind for lay in m.enc_layers] == ["encoder"] * 2
    assert m.enc_norm.shape == (256,) and m.enc_norm.dtype == torch.float32
    dec, enc = m.layers[0], m.enc_layers[0]
    assert dec.ln_cross.dtype == torch.float32
    assert {n: tuple(t.shape) for n, t in dec.cross_params().items()} == {
        "wq": (256, 256), "wk": (256, 128), "wv": (256, 128),
        "wo": (256, 256)}
    assert all(t.dtype == torch.bfloat16
               for t in dec.cross_params().values())
    assert tuple(enc.wk.shape) == (256, 128) and not hasattr(enc, "w_gate")
    assert not hasattr(enc, "ln_cross")
    cache = init_cache(cfg, Runtime(), 3, 30, device="cpu")
    assert {k: tuple(t.shape) for k, t in cache.items()} == {
        "k": (2, 3, 30, 2, 64), "v": (2, 3, 30, 2, 64),
        "cross_k": (2, 3, 64, 2, 64), "cross_v": (2, 3, 64, 2, 64)}
    sized = init_cache(cfg, Runtime(), 3, 30, device="cpu", source_len=7)
    assert tuple(sized["cross_v"].shape) == (2, 3, 7, 2, 64)
    trainable = init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu", trainable=True)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in trainable.parameters())


@pytest.fixture(scope="module")
def trees():
    """{variant: the JAX init's tree (numpy)}, as the subprocess draws it."""
    return {name: jax.tree.map(np.asarray, jax_init_model(
        jax.random.PRNGKey(0), _configs(name)[1])) for name in ("reduced",
                                                                 "g1")}


def _tree(trees, name):
    return trees["g1" if name == "g1" else "reduced"]


@pytest.mark.parametrize("name", ("reduced", "g1"))
def test_bridge_round_trips_encoder_and_cross_weights(trees, name):
    cfg, _ = _configs(name)
    tree = trees[name]
    model = params_from_jax(tree, cfg, device="cpu")
    back = params_to_jax(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    again = params_from_jax(back, cfg, device="cpu")
    for (n, a), (n_b, b) in zip(model.named_parameters(),
                                again.named_parameters()):
        assert n == n_b and a.dtype == b.dtype and torch.equal(a, b), n
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = "/".join(str(getattr(k, "key", k)) for k in path)
        want = leaf if keys.endswith("scale") else np.asarray(
            jnp.asarray(leaf, jnp.bfloat16), np.float32)
        np.testing.assert_array_equal(flat_back[path], want, err_msg=keys)
    assert set(tree) == {"embed", "final_norm", "lm_head", "layers",
                         "enc_layers", "enc_norm"}
    assert set(tree["layers"]) == {"ln1", "ln2", "attn", "cross",
                                   "ln_cross", "ffn"}
    assert set(tree["enc_layers"]) == {"ln1", "ln2", "attn", "ffn"}
    enc_hd = 32 if name == "g1" else 64
    K_enc = 8 if name == "g1" else 2
    assert tree["enc_layers"]["attn"]["wk"]["w"].shape == (2, 256,
                                                           K_enc * enc_hd)
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(a.size for a in jax.tree.leaves(tree))
    exact = params_to_jax(params_from_jax(tree, cfg, device="cpu",
                                          trainable=True))
    for a, b in zip(jax.tree.leaves(exact), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# the modules and the model against JAX (one subprocess)
# --------------------------------------------------------------------------

SUB = '''
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_allow_excess_precision=false"
import numpy as np
import jax, jax.numpy as jnp
from repro.configs.registry import get_config
from repro.models.transformer import (Runtime, _encode, cross_attention,
                                      forward, init_cache, init_model)

exec(os.environ["ED_HELPERS"])
arch, variants, (B, S, NEW) = eval(os.environ["ED_ARGS"])
rt = Runtime()
f32 = lambda a: np.asarray(a, np.float32)
res = {}
for name in variants:
    cfg = encdec_config(get_config(arch).reduced(), name)
    p = init_model(jax.random.PRNGKey(0), cfg)
    frames = jnp.asarray(encdec_frames(name, B, cfg.encoder.d_model))
    tokens, forced = _tokens(cfg.vocab_size)
    out = {"enc": f32(jax.jit(lambda p, f: _encode(p, cfg, f, rt))(p, frames))}
    x, e = _cross_inputs(cfg.d_model, cfg.encoder.d_model, FRAMES[name])
    cross0 = jax.tree.map(lambda a: a[0], p["layers"]["cross"])
    c, ck, cv = jax.jit(lambda q, x, e: cross_attention(q, cfg, x, e))(
        cross0, jnp.asarray(x, jnp.bfloat16), jnp.asarray(e, jnp.bfloat16))
    out["cross"] = (f32(c), f32(ck), f32(cv))
    prefill = jax.jit(lambda p, t, f, c: forward(
        p, cfg, {"tokens": t, "frames": f}, rt, mode="prefill", cache=c)[:2])
    decode = jax.jit(lambda p, t, c, n: forward(
        p, cfg, {"tokens": t}, rt, mode="decode", cache=c, cache_len=n)[:2])
    lg, cache = prefill(p, jnp.asarray(tokens), frames,
                        init_cache(cfg, rt, B, S + NEW))
    flat = lambda c: {"k": f32(c["self"]["k"]), "v": f32(c["self"]["v"]),
                      "cross_k": f32(c["cross_k"]),
                      "cross_v": f32(c["cross_v"])}
    out["logits"] = [f32(lg)]
    out["prefill_cache"] = flat(cache)
    for i in range(NEW):
        lg, cache = decode(p, jnp.asarray(forced[:, i:i + 1]), cache, S + i)
        out["logits"].append(f32(lg))
    out["cache"] = flat(cache)
    out["train"] = f32(jax.jit(lambda p, t, f: forward(
        p, cfg, {"tokens": t, "frames": f}, rt, mode="train")[0])(
            p, jnp.asarray(tokens), frames))
    res[name] = out
with open(sys.argv[1], "wb") as fh:
    pickle.dump(res, fh)
'''


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("encdec_models") / "jax_encdec.pkl"
    helpers = HELPERS + "\n\n" + "\n\n".join(
        inspect.getsource(f) for f in (_tokens, _cross_inputs))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               ED_HELPERS=helpers, ED_ARGS=repr((ARCH, VARIANTS, (B, S, NEW))))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB),
                           str(out)], capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("name", VARIANTS)
def test_encode_matches_jax(jax_ref, trees, name):
    cfg, _ = _configs(name)
    model = params_from_jax(_tree(trees, name), cfg, device="cpu")
    frames = torch.tensor(encdec_frames(name, B, cfg.encoder.d_model))
    with torch.inference_mode():
        got = _encode(model, cfg, frames)
    want = jax_ref[name]["enc"]
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == want.shape == (B, FRAMES[name], 256)
    err = np.abs(_np(got) - want).max()
    assert err <= ENC_ATOL and _rel(got, want) <= 1e-2


@pytest.mark.parametrize("name", VARIANTS)
def test_cross_attention_matches_jax(jax_ref, trees, name):
    cfg, _ = _configs(name)
    model = params_from_jax(_tree(trees, name), cfg, device="cpu")
    x, e = _cross_inputs(cfg.d_model, cfg.encoder.d_model, FRAMES[name])
    bf = lambda a: torch.tensor(a).to(torch.bfloat16)  # noqa: E731
    with torch.inference_mode():
        out, k, v = tattn.cross_attention(model.layers[0].cross_params(),
                                          cfg, bf(x), bf(e))
    want, wk, wv = jax_ref[name]["cross"]
    K = cfg.num_kv_heads
    assert tuple(k.shape) == wk.shape == (B, FRAMES[name], K, 64)
    assert _rel(k, wk) <= 1e-3 and _rel(v, wv) <= 1e-3
    assert _rel(out, want) <= 1e-2


@pytest.mark.parametrize("name", VARIANTS)
def test_model_matches_jax(jax_ref, trees, name):
    """A prefill of 2 x 24 tokens over the variant's frames, two decode
    steps, the caches after each, and the train-mode logits, against the
    JAX forward on the same bridged weights."""
    ref = jax_ref[name]
    cfg, _ = _configs(name)
    model = params_from_jax(_tree(trees, name), cfg, device="cpu")
    tokens, forced = _tokens(cfg.vocab_size)
    frames = torch.tensor(encdec_frames(name, B, cfg.encoder.d_model))
    rt = Runtime()
    ops.reset_launches()
    with torch.inference_mode():
        cache = init_cache(cfg, rt, B, S + NEW, device="cpu")
        lg, cache2, st = forward(model, cfg, torch.tensor(tokens), rt,
                                 mode="prefill", cache=cache, frames=frames)
        assert cache2 is cache and st["expert_counts"] is None
        logits = [lg.float().numpy()]
        pre = {k: t.clone() for k, t in cache.items()}
        for i in range(NEW):
            # decode never runs the encoder: frames are not needed
            lg, _, _ = forward(model, cfg, torch.tensor(forced[:, i:i + 1]),
                               rt, mode="decode", cache=cache,
                               cache_len=S + i)
            logits.append(lg.float().numpy())
        train, none, _ = forward(model, cfg, torch.tensor(tokens), rt,
                                 mode="train", frames=frames)
    assert none is None and sum(ops.LAUNCHES.values()) == 0
    assert tuple(cache["cross_k"].shape) == (2, B, FRAMES[name],
                                             cfg.num_kv_heads, 64)
    for step, (got, want) in enumerate(zip(logits, ref["logits"])):
        assert got.shape == want.shape == (B, 1, cfg.vocab_size)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"step {step}")
    np.testing.assert_allclose(train.float().numpy(), ref["train"],
                               atol=LOGIT_ATOL, rtol=0)
    for got, want in ((pre, ref["prefill_cache"]), (cache, ref["cache"])):
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
            assert _rel(got[k], want[k]) <= 2e-2, k
    # the decode steps wrote their k / v, and left the cross cache as it was
    assert torch.equal(pre["cross_k"], cache["cross_k"])
    assert not torch.equal(pre["k"], cache["k"])


def test_forward_needs_frames_outside_decode():
    cfg = get_config(ARCH).reduced()
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    for mode in ("train", "prefill"):
        with pytest.raises(KeyError, match="frames"):
            forward(model, cfg, tokens, Runtime(), mode=mode)
    with pytest.raises(ValueError, match="linear cache"):
        forward(model, cfg, tokens[:, :1], Runtime(), mode="decode",
                cache={}, cache_len=torch.ones(1, dtype=torch.int32),
                block_tables=torch.zeros((1, 1), dtype=torch.int32))


def test_encoder_reaches_the_logits_and_remat_matches():
    """Random frames move the logits (zero frames give ``enc_out`` 0, and
    the cross-attention then adds nothing); ``remat`` recomputes every
    layer, the encoder's too, with the same values; every parameter, the
    encoder's and the cross-attention's, gets a gradient."""
    cfg = get_config(ARCH).reduced()
    model = init_model(cfg, torch.Generator().manual_seed(1), device="cpu",
                       trainable=True)
    tokens = torch.tensor(_tokens(cfg.vocab_size)[0])
    frames = torch.tensor(encdec_frames("reduced", B, 256))
    zero = torch.zeros_like(frames)
    with torch.no_grad():
        enc0 = _encode(model, cfg, zero)
        assert not enc0.float().abs().any()
        a, _, _ = forward(model, cfg, tokens, Runtime(), mode="train",
                          frames=frames)
        b, _, _ = forward(model, cfg, tokens, Runtime(), mode="train",
                          frames=zero)
    assert float((a.float() - b.float()).abs().max()) > 1e-2
    plain, _, _ = forward(model, cfg, tokens, Runtime(), mode="train",
                          frames=frames)
    again, _, _ = forward(model, cfg, tokens, Runtime(), mode="train",
                          frames=frames, remat=True)
    assert torch.equal(plain, again)
    plain.float().sum().backward()
    for n, p in model.named_parameters():
        assert p.grad is not None and p.grad.abs().max() > 0, n


# --------------------------------------------------------------------------
# chip_smoke.py's seamless phase, its pieces on the CPU
# --------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_variants_and_counts_are_the_tests():
    cs = _chip_smoke()
    assert cs.SEAMLESS_VARIANTS == FRAMES
    reduced = get_config(ARCH).reduced()
    for name in VARIANTS:
        assert cs.seamless_variant(reduced, name) == encdec_config(reduced,
                                                                   name)
    assert cs.seamless_held(get_config(ARCH)) == 877_094_912
    f = cs.seamless_frames(3, 2, 5, 8, "cpu")
    assert tuple(f.shape) == (2, 5, 8) and f.dtype == torch.float32
    assert torch.equal(f, cs.seamless_frames(3, 2, 5, 8, "cpu"))


def test_chip_smoke_card_vs_cpu_run_on_the_cpu():
    """The phase's ``_seamless_run`` on the CPU: the encoder's output is
    ``_encode``'s, the cross cache holds the source's 600 frames, and the
    logits are the prefill's and two decode steps'."""
    cs = _chip_smoke()
    cfg = cs.seamless_variant(get_config(ARCH).reduced(), "long")
    model = init_model(cfg, torch.Generator().manual_seed(2), device="cpu")
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (2, 2)).astype(np.int32)
    frames = rng.normal(size=(2, 600, 256)).astype(np.float32)
    logits, enc, cross = cs._seamless_run(model, cfg, tokens, frames, forced)
    assert tuple(logits.shape) == (3, 2, cfg.vocab_size)
    with torch.inference_mode():
        want = _encode(model, cfg, torch.tensor(frames))
        lg, cache, _ = forward(model, cfg, torch.tensor(tokens), Runtime(),
                               mode="prefill", frames=torch.tensor(frames))
    assert torch.equal(enc, want.float())
    assert torch.equal(logits[0], lg[:, -1].float())
    assert tuple(cross["cross_k"].shape) == (2, 2, 600, 2, 64)
    assert torch.equal(cross["cross_v"], cache["cross_v"].float())
    assert cs.rel_err(logits[2], logits[0]) > 1e-3
