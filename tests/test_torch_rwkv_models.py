"""The PyTorch port's RWKV-6 (``rwkv6-7b``) against the JAX package, on the
CPU: the config, the roofline, the bridge, each module of
``models/rwkv6.py`` op by op, and the whole model at ``reduced()`` (2
layers, d 256, 4 heads of 64, F 512), from the same (bridged) weights and
the same numpy inputs.

The JAX init hides two paths: ``decay_base`` -6 keeps every rate near
0.0025, far from the ``MAX_RATE`` clip (and so the chunk's exp(0.9 x 32)
rescaling never shows), and ``mu`` at 0.02 makes the token shift nearly
invisible. Every module and model test runs three weight variants
(``tests/_torch_rwkv.py``): ``init``; ``clip`` (``decay_base`` +1.0: every
rate clips to 0.9); ``shift`` (``mu`` of both mixes drawn at scale 0.5).
Lengths S in {1, 20, 64, 75}: one token (the step), a short chunk, two
whole chunks, three with padding.

The modules run against the JAX functions op by op (``jax.disable_jit()``:
under jit XLA keeps excess precision in bf16 fusions, where both the port
and JAX op by op round every operation). Tolerances, each with its reason:

* ``_token_shift``: within one bf16 ulp, and at most 1e-3 of the streams'
  elements differ at all (the same bf16 operations in the same order, and
  ``tanh`` agrees bit for bit, but torch and XLA round about one bf16 dot
  product in 10^4 differently by one ulp: here the LoRA's); the new shift
  state bit for bit.
* ``_log_decay``: 1e-3 relative, elementwise: its LoRA runs in bf16, and
  such a one-ulp difference moves that element's rate by up to ~1e-4.
* ``wkv_chunked`` on the same bf16 r, k, v and fp32 logw (the JAX side
  jitted: it computes in fp32 only, so there is no bf16 rounding for jit
  to move): y within one bf16 ulp of its largest element (both round an fp32 y whose sums run in other
  orders; where they cancel, a small element can move by a few of its own
  ulps), the fp32 state within 1e-5 in norm; ``wkv_step`` 1e-6.
* ``time_mix``: out within 1e-2 of its largest element and 2e-3 in norm,
  the state within 1e-3 in norm: a one-ulp difference of a bf16 r, k or v
  projection (as for ``_log_decay``) moves the fp32 state, and through it
  the normed output, by that much. ``channel_mix``: within 5e-3 of its
  largest element, for the same reason.
* the model (JAX jitted in one subprocess without XLA's excess
  precision): logits within ``LOGIT_ATOL`` = 5e-2, as
  ``tests/test_torch_model.py``; the state after the prefill and after two
  decode steps within 2e-2 in norm for the bf16 shift vectors (a bf16 ulp
  is 8e-3 relative) and 1e-2 for the fp32 WKV state (two layers of the
  one-ulp projection differences above).

``wkv_chunked`` is also held against a ``wkv_step`` loop in the port, at
the reduced heads and at the published ones (64 of 64), with
``chip_smoke.py``'s own check (``wkv_chunk_vs_step``) within its 1e-4, and
the weight variants that phase applies on the card are checked here.
"""

import dataclasses
import importlib.util
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
from repro.models import rwkv6 as jrwkv  # noqa: E402
from repro.models.transformer import init_model as jax_init_model  # noqa: E402
from repro_torch import roofline as roof  # noqa: E402
from repro_torch.bridge import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.configs.base import INPUT_SHAPES  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import rwkv6 as trwkv  # noqa: E402
from repro_torch.models.transformer import (Runtime, Transformer,  # noqa: E402
                                            check_config, forward,
                                            init_cache, init_model)
from tests._torch_rwkv import SOURCE as VARIANT_SOURCE  # noqa: E402
from tests._torch_rwkv import VARIANTS  # noqa: E402
from tests._torch_rwkv import rwkv_variant as _variant  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "rwkv6-7b"
LOGIT_ATOL = 5e-2
LENGTHS = (1, 20, 64, 75)
B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced model's operations are tiny: one intra-op thread runs
    them as fast as many, and keeps this file from oversubscribing the
    cores when test workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(a):
    return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)


def _np(t):
    return np.asarray(t.float().numpy() if torch.is_tensor(t) else t,
                      np.float32)


def _rel(got, want):
    got, want = _np(got).astype(np.float64), _np(want).astype(np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-300))


def _max_rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _ulps(got, want):
    """|got - want| in bf16 ulps of ``want``."""
    got, want = _np(got), _np(want)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    return float((np.abs(got - want) / ulp).max())


def _port_block(tree, block, cfg):
    """A JAX block tree -> the port's parameter dict, in its storage
    dtypes."""
    shapes = trwkv.param_shapes(cfg)[block]
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            v = v["w"] if "w" in v else v["scale"]
        out[k] = torch.tensor(np.asarray(v, np.float32)).to(shapes[k][2])
    return out


@pytest.fixture(scope="module")
def blocks():
    """{variant: (JAX time mix, port time mix, JAX channel mix, port channel
    mix)} from one JAX init."""
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    tm = jrwkv.init_time_mix(jax.random.PRNGKey(1), jcfg)
    cm = jrwkv.init_channel_mix(jax.random.PRNGKey(2), jcfg)
    out = {}
    for name in VARIANTS:
        jt, jc = _variant(tm, name), _variant(cm, name)
        out[name] = (jax.tree.map(jnp.asarray, jt),
                     _port_block(jt, "time_mix", cfg),
                     jax.tree.map(jnp.asarray, jc),
                     _port_block(jc, "channel_mix", cfg))
    return jcfg, cfg, out


def _inputs(S, d=256, H=4, hd=64):
    rng = np.random.default_rng(100 + S)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    prev = rng.normal(size=(B, d)).astype(np.float32)
    state = rng.normal(size=(B, H, hd, hd)).astype(np.float32)
    return x, prev, state


# --------------------------------------------------------------------------
# the config, the roofline, the model's parameters and state
# --------------------------------------------------------------------------

def test_config_matches_jax_config():
    for reduce in (False, True):
        j, t = jax_get_config(ARCH), get_config(ARCH)
        if reduce:
            j, t = j.reduced(), t.reduced()
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert t.num_params() == j.num_params()
        assert t.active_params() == j.active_params()
    cfg = get_config(ARCH)
    assert cfg.num_params() == 5_905_580_032
    assert (cfg.family, cfg.attention, cfg.activation) == ("ssm", "none",
                                                           "relu2")


@pytest.mark.parametrize("chips", [1, 4])
def test_roofline_op_model_matches_jax(chips):
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    for name, shape in INPUT_SHAPES.items():
        jshape = JAX_INPUT_SHAPES[name]
        for got, want in (
                (roof.analytic_flops(cfg, shape),
                 jroof.analytic_flops(jcfg, jshape)),
                (roof.analytic_hbm_bytes(cfg, shape, chips),
                 jroof.analytic_hbm_bytes(jcfg, jshape, chips)),
                (roof.model_flops(cfg, shape),
                 jroof.model_flops(jcfg, jshape))):
            assert got == pytest.approx(want, rel=1e-12, abs=0), name
    # decode reads the fp32 WKV state, not a KV cache
    r = roof.analyze(ARCH, INPUT_SHAPES["decode_32k"], "1x1", 1, cfg)
    assert r.model_flops_total > 0 and r.analytic_hbm_per_device > 0


def test_check_config_takes_ssm_with_attention_none_only():
    cfg = get_config(ARCH).reduced()
    check_config(cfg)
    for bad in (dataclasses.replace(cfg, attention="gqa"),
                dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                                    attention="none")):
        with pytest.raises(ValueError, match="has no port"):
            check_config(bad)
        with pytest.raises(ValueError, match="has no port"):
            Transformer(bad, {}, [])


def test_init_model_and_cache():
    cfg = get_config(ARCH).reduced()
    m = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    layer = m.layers[0]
    assert [lay.kind for lay in m.layers] == ["rwkv", "rwkv"]
    assert torch.equal(layer.tm_decay_base, torch.full((256,), -6.0))
    assert torch.equal(layer.tm_ln_out, torch.ones(256))
    for n in ("tm_decay_base", "tm_bonus", "tm_ln_out", "ln1", "ln2"):
        assert getattr(layer, n).dtype == torch.float32, n
    for n in ("tm_mu", "tm_lora_a", "tm_lora_b", "tm_w_r", "tm_w_o",
              "tm_decay_lora_a", "tm_decay_lora_b", "cm_mu", "cm_w_k",
              "cm_w_v", "cm_w_r"):
        assert getattr(layer, n).dtype == torch.bfloat16, n
    assert layer.tm_lora_b.shape == (5, 64, 256)
    assert layer.cm_w_r.shape == (256, 256) and layer.cm_w_v.shape == (512, 256)
    bonus = layer.tm_bonus
    assert bonus.shape == (4, 64) and float(bonus.abs().max()) <= 1.0
    assert float(layer.tm_mu.float().abs().max()) <= 0.04    # 0.02 x 2 sd
    cache = init_cache(cfg, Runtime(), 3, 100, device="cpu")
    assert {k: (tuple(t.shape), t.dtype) for k, t in cache.items()} == {
        "shift_tm": ((2, 3, 256), torch.float32),
        "shift_cm": ((2, 3, 256), torch.float32),
        "wkv": ((2, 3, 4, 64, 64), torch.float32)}
    assert not any(t.any() for t in cache.values())
    trainable = init_model(cfg, torch.Generator().manual_seed(0), device="cpu",
                           trainable=True)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in trainable.parameters())


@pytest.fixture(scope="module")
def model_tree():
    jcfg = jax_get_config(ARCH).reduced()
    return jax.tree.map(np.asarray, jax_init_model(jax.random.PRNGKey(0), jcfg))


def test_bridge_round_trips_rwkv_weights(model_tree):
    cfg = get_config(ARCH).reduced()
    tree = model_tree
    model = params_from_jax(tree, cfg, device="cpu")
    back = params_to_jax(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    again = params_from_jax(back, cfg, device="cpu")
    for (n, a), (n_b, b) in zip(model.named_parameters(),
                                again.named_parameters()):
        assert n == n_b and a.dtype == b.dtype and torch.equal(a, b), n
    fp32 = ("scale", "decay_base", "bonus")
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = "/".join(str(getattr(k, "key", k)) for k in path)
        got = dict(jax.tree_util.tree_flatten_with_path(back)[0])[path]
        want = leaf if any(f in keys for f in fp32) else np.asarray(
            jnp.asarray(leaf, jnp.bfloat16), np.float32)
        np.testing.assert_array_equal(got, want, err_msg=keys)
    assert tree["layers"]["time_mix"]["lora_b"].shape == (2, 5, 64, 256)
    assert tree["layers"]["channel_mix"]["w_r"]["w"].shape == (2, 256, 256)
    # a trainable model keeps the JAX tree's fp32 values exactly
    exact = params_to_jax(params_from_jax(tree, cfg, device="cpu",
                                          trainable=True))
    for a, b in zip(jax.tree.leaves(exact), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# the modules, op by op
# --------------------------------------------------------------------------

def test_bf16_sigmoid_and_silu_are_xlas_expansion():
    """``jax.nn.sigmoid`` / ``silu`` in bf16 as XLA computes them: the
    port's equal them bit for bit, ``torch.sigmoid`` (one rounding) differs
    in about a third of the elements."""
    x = np.random.default_rng(0).normal(size=(20000,)).astype(np.float32) * 3
    with jax.disable_jit():
        js = jax.nn.sigmoid(jnp.asarray(x, jnp.bfloat16))
        jsilu = jax.nn.silu(jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_array_equal(_np(trwkv.sigmoid(_bf16(x))), _np(js))
    np.testing.assert_array_equal(_np(trwkv.silu(_bf16(x))), _np(jsilu))
    once = (_np(torch.sigmoid(_bf16(x))) != _np(js)).mean()
    assert 0.25 < once < 0.45, once


@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_token_shift_matches_jax(blocks, variant, S):
    _, _, b = blocks
    jp, tp, _, _ = b[variant]
    x, prev, _ = _inputs(S)
    with jax.disable_jit():
        js, jshift = jrwkv._token_shift(jp, jnp.asarray(x, jnp.bfloat16),
                                        jnp.asarray(prev))
    ts, tshift = trwkv._token_shift(tp, _bf16(x), torch.tensor(prev))
    assert ts.dtype == tshift.dtype == torch.bfloat16
    assert tuple(ts.shape) == (B, S, 5, 256)
    assert _ulps(ts, js) <= 1.0
    assert (_np(ts) != _np(js)).mean() <= 1e-3
    np.testing.assert_array_equal(_np(tshift), _np(jshift))
    if variant == "shift":
        # the shift moves every stream away from x
        assert (_np(ts) != _np(_bf16(x))[:, :, None]).mean() > 0.9


@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_log_decay_matches_jax(blocks, variant, S):
    _, _, b = blocks
    jp, tp, _, _ = b[variant]
    x, _, _ = _inputs(S)
    with jax.disable_jit():
        want = jrwkv._log_decay(jp, jnp.asarray(x, jnp.bfloat16))
    got = trwkv._log_decay(tp, _bf16(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-3, atol=0)
    assert float(got.max()) < 0 and float(got.min()) >= -trwkv.MAX_RATE
    if variant == "clip":
        # every rate at the clip, as the reference computes it
        np.testing.assert_array_equal(got.numpy(), _np(want))
        assert float(got.min()) == float(got.max()) == \
            -np.exp(np.float32(trwkv.LOG_MAX_RATE))


@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("clip", [False, True])
def test_wkv_chunked_matches_jax(blocks, clip, S):
    _, _, b = blocks
    jp, tp, _, _ = b["init"]
    rng = np.random.default_rng(200 + S)
    r, k, v = (rng.normal(size=(B, S, 4, 64)).astype(np.float32)
               for _ in range(3))
    logw = (np.full((B, S, 4, 64), -0.9, np.float32) if clip else
            -rng.uniform(0.0, 0.9, (B, S, 4, 64)).astype(np.float32))
    state = rng.normal(size=(B, 4, 64, 64)).astype(np.float32)
    jy, js = jax.jit(jrwkv.wkv_chunked)(
        *(jnp.asarray(a, jnp.bfloat16) for a in (r, k, v)),
        jnp.asarray(logw), jp["bonus"], jnp.asarray(state))
    st = torch.tensor(state)
    ty, ts = trwkv.wkv_chunked(_bf16(r), _bf16(k), _bf16(v),
                               torch.tensor(logw), tp["bonus"], st)
    assert ty.dtype == torch.bfloat16 and ts.dtype == torch.float32
    assert torch.equal(st, torch.tensor(state))          # input untouched
    assert _max_rel(ty, jy) <= 2.0 ** -8
    assert _rel(ts, js) <= 1e-5


@pytest.mark.parametrize("clip", [False, True])
def test_wkv_step_matches_jax(blocks, clip):
    _, _, b = blocks
    jp, tp, _, _ = b["init"]
    rng = np.random.default_rng(7)
    r, k, v = (rng.normal(size=(B, 4, 64)).astype(np.float32)
               for _ in range(3))
    logw = (np.full((B, 4, 64), -0.9, np.float32) if clip
            else -rng.uniform(0.0, 0.9, (B, 4, 64)).astype(np.float32))
    state = rng.normal(size=(B, 4, 64, 64)).astype(np.float32)
    with jax.disable_jit():
        jy, js = jrwkv.wkv_step(*(jnp.asarray(a) for a in (r, k, v, logw)),
                                jp["bonus"], jnp.asarray(state))
    ty, ts = trwkv.wkv_step(*(torch.tensor(a) for a in (r, k, v, logw)),
                            tp["bonus"], torch.tensor(state))
    assert _rel(ty, jy) <= 1e-6 and _rel(ts, js) <= 1e-6


@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_time_mix_matches_jax(blocks, variant, S, monkeypatch):
    jcfg, cfg, b = blocks
    jp, tp, _, _ = b[variant]
    x, prev, state = _inputs(S)
    paths = []
    for name in ("wkv_chunked", "wkv_step"):
        real = getattr(trwkv, name)
        monkeypatch.setattr(trwkv, name, lambda *a, _n=name, _f=real:
                            paths.append(_n) or _f(*a))
    with jax.disable_jit():
        jo, jst = jrwkv.time_mix(jp, jcfg, jnp.asarray(x, jnp.bfloat16),
                                 {"shift_tm": jnp.asarray(prev),
                                  "wkv": jnp.asarray(state)})
    st = {"shift_tm": torch.tensor(prev), "wkv": torch.tensor(state)}
    to, tst = trwkv.time_mix(tp, cfg, _bf16(x), st)
    # one token takes the step, longer prompts the chunked recurrence
    assert paths == (["wkv_step"] if S == 1 else ["wkv_chunked"])
    assert torch.equal(st["wkv"], torch.tensor(state))   # input untouched
    assert to.dtype == torch.bfloat16 and tuple(to.shape) == (B, S, 256)
    assert _max_rel(to, jo) <= 1e-2 and _rel(to, jo) <= 2e-3
    assert _rel(tst["wkv"], jst["wkv"]) <= 1e-3
    np.testing.assert_array_equal(_np(tst["shift_tm"]), _np(jst["shift_tm"]))


@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_channel_mix_matches_jax(blocks, variant, S):
    _, _, b = blocks
    _, _, jp, tp = b[variant]
    x, prev, _ = _inputs(S)
    with jax.disable_jit():
        jo, jshift = jrwkv.channel_mix(jp, jnp.asarray(x, jnp.bfloat16),
                                       jnp.asarray(prev))
    to, tshift = trwkv.channel_mix(tp, _bf16(x), torch.tensor(prev))
    assert to.dtype == torch.bfloat16
    assert _max_rel(to, jo) <= 5e-3
    np.testing.assert_array_equal(_np(tshift), _np(jshift))


def test_init_rwkv_state_matches_jax():
    jcfg, cfg = jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()
    want = jrwkv.init_rwkv_state(jcfg, 3)
    got = trwkv.init_rwkv_state(cfg, 3)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        assert not got[k].any()
    assert (trwkv.LORA_DIM, trwkv.CHUNK, trwkv.MAX_RATE) == (
        jrwkv.LORA_DIM, jrwkv.CHUNK, jrwkv.MAX_RATE)


# --------------------------------------------------------------------------
# the chunked recurrence against the stepwise one, in the port
# --------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", [(2, 75, 4, 64), (1, 96, 64, 64)],
                         ids=["reduced_heads", "published_heads"])
@pytest.mark.parametrize("clip", [False, True])
def test_wkv_chunked_matches_the_step_loop(shape, clip):
    """``chip_smoke.py``'s phase-rwkv check on the CPU: fp32 inputs, the
    chunked recurrence against ``wkv_step`` one token at a time, y and the
    final state within its ``WKV_REL`` in norm."""
    cs = _chip_smoke()
    row = cs.wkv_chunk_vs_step(shape, clip, 3, torch.device("cpu"))
    assert row["finite"]
    assert row["y_rel"] <= cs.WKV_REL and row["state_rel"] <= cs.WKV_REL
    # the clip's inputs reach the largest rescaling the chunk allows
    r, k, v, logw, u, state = cs.wkv_inputs(shape, clip, 3,
                                            torch.device("cpu"))
    assert float(logw.min()) >= -trwkv.MAX_RATE
    assert (float(logw.max()) == -np.float32(trwkv.MAX_RATE)) == clip


def test_chip_smoke_variants_change_what_the_init_hides():
    cs = _chip_smoke()
    cfg = get_config(ARCH).reduced()
    base = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    for name in cs.RWKV_VARIANTS:
        m = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
        cs.rwkv_variant(m, name, 0)
        changed = {n for (n, a), (_, b) in zip(m.named_parameters(),
                                               base.named_parameters())
                   if not torch.equal(a, b)}
        L = range(cfg.num_layers)
        want = {"init": set(),
                "clip": {f"layers.{l}.tm_decay_base" for l in L},
                "shift": {f"layers.{l}.{n}" for l in L
                          for n in ("tm_mu", "cm_mu")}}[name]
        assert changed == want, name
        if name == "clip":
            assert float(m.layers[0].tm_decay_base.min()) == 1.0
        if name == "shift":
            assert 0.3 < float(m.layers[1].tm_mu.float().std()) < 0.6


def test_chip_smoke_card_vs_cpu_run_keeps_both_states():
    """The phase's ``_rwkv_run`` on the CPU: its state after the prefill
    is a copy (the decode steps update the cache in place), equal to a
    prefill's alone, and its logits are the prefill's and decode's."""
    cs = _chip_smoke()
    cfg = get_config(ARCH).reduced()
    model = init_model(cfg, torch.Generator().manual_seed(2), device="cpu")
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (2, 75)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (2, 2)).astype(np.int32)
    logits, pre, end = cs._rwkv_run(model, cfg, tokens, forced)
    assert tuple(logits.shape) == (3, 2, cfg.vocab_size)
    with torch.inference_mode():
        lg, cache, _ = forward(model, cfg, torch.tensor(tokens), Runtime(),
                               mode="prefill")
    assert torch.equal(logits[0], lg[:, -1].float())
    for k in cache:
        assert torch.equal(pre[k], cache[k].float()), k
    assert cs.rel_err(end["wkv"], pre["wkv"]) > 1e-3   # two more tokens


# --------------------------------------------------------------------------
# the whole model against the JAX model
# --------------------------------------------------------------------------

SUB = '''
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_allow_excess_precision=false"
import numpy as np
import jax, jax.numpy as jnp
from repro.configs.registry import get_config
from repro.models.transformer import Runtime, forward, init_cache, init_model

exec(os.environ["RW_HELPERS"])
_variant = rwkv_variant
arch, variants, S_PROMPT, S_TRAIN = eval(os.environ["RW_ARGS"])
cfg = get_config(arch).reduced()
base = jax.tree.map(np.asarray, init_model(jax.random.PRNGKey(0), cfg))
rt = Runtime()
prefill = jax.jit(lambda p, t, c: forward(p, cfg, {"tokens": t}, rt,
                                          mode="prefill", cache=c)[:2])
decode = jax.jit(lambda p, t, c, n: forward(p, cfg, {"tokens": t}, rt,
                                            mode="decode", cache=c,
                                            cache_len=n)[:2])
train = jax.jit(lambda p, t: forward(p, cfg, {"tokens": t}, rt,
                                     mode="train")[0])
f32 = lambda tree: {k: np.asarray(v, np.float32) for k, v in tree.items()}
res = {}
for name in variants:
    p = jax.tree.map(jnp.asarray, _variant(base, name))
    tokens, forced = _tokens(cfg.vocab_size)
    lg, cache = prefill(p, jnp.asarray(tokens),
                        init_cache(cfg, rt, tokens.shape[0], S_PROMPT + 2))
    out = {"logits": [np.asarray(lg, np.float32)], "prefill_state": f32(cache),
           "dtypes": {k: str(v.dtype) for k, v in cache.items()}}
    for i in range(forced.shape[1]):
        lg, cache = decode(p, jnp.asarray(forced[:, i:i + 1]), cache,
                           S_PROMPT + i)
        out["logits"].append(np.asarray(lg, np.float32))
    out["state"] = f32(cache)
    out["train"] = np.asarray(train(p, jnp.asarray(tokens[:, :S_TRAIN])),
                              np.float32)
    res[name] = out
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
'''
S_PROMPT, S_TRAIN = 75, 64


def _tokens(vocab):
    rng = np.random.default_rng(11)
    return (rng.integers(0, vocab, (2, 75)).astype(np.int32),
            rng.integers(0, vocab, (2, 2)).astype(np.int32))


@pytest.fixture(scope="module")
def jax_model_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("rwkv_models") / "jax_rwkv.pkl"
    helpers = VARIANT_SOURCE + "\n\n" + inspect.getsource(_tokens)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               RW_HELPERS=helpers,
               RW_ARGS=repr((ARCH, VARIANTS, S_PROMPT, S_TRAIN)))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB),
                           str(out)], capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("variant", VARIANTS)
def test_model_matches_jax(jax_model_ref, model_tree, variant):
    """Prefill of 2 x 75 tokens (three chunks, the last padded), two decode
    steps, the state after each, and the train-mode logits over 2 x 64,
    against the JAX forward on the same bridged weights."""
    ref = jax_model_ref[variant]
    cfg = get_config(ARCH).reduced()
    model = params_from_jax(_variant(model_tree, variant), cfg, device="cpu")
    tokens, forced = _tokens(cfg.vocab_size)
    rt = Runtime()
    ops.reset_launches()
    with torch.inference_mode():
        lg, cache, st = forward(model, cfg, torch.tensor(tokens), rt,
                                mode="prefill")
        assert st["expert_counts"] is None and st["aux_loss"] == 0.0
        logits = [lg.float().numpy()]
        states = [{k: t.clone() for k, t in cache.items()}]
        for i in range(forced.shape[1]):
            lg, cache2, _ = forward(model, cfg,
                                    torch.tensor(forced[:, i:i + 1]), rt,
                                    mode="decode", cache=cache,
                                    cache_len=S_PROMPT + i)
            assert cache2 is cache                 # updated in place
            logits.append(lg.float().numpy())
        train, none, _ = forward(model, cfg, torch.tensor(tokens[:, :S_TRAIN]),
                                 rt, mode="train")
    assert none is None and sum(ops.LAUNCHES.values()) == 0
    for step, (got, want) in enumerate(zip(logits, ref["logits"])):
        assert got.shape == want.shape == (2, 1, cfg.vocab_size)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"step {step}")
    np.testing.assert_allclose(train.float().numpy(), ref["train"],
                               atol=LOGIT_ATOL, rtol=0)
    # the JAX cache holds its shift vectors in bf16 after a forward, the
    # port holds the same bf16 values in its fp32 cache
    assert ref["dtypes"] == {"shift_tm": "bfloat16", "shift_cm": "bfloat16",
                             "wkv": "float32"}
    for got, want in ((states[0], ref["prefill_state"]), (cache, ref["state"])):
        for k in ("shift_tm", "shift_cm"):
            assert torch.equal(got[k], got[k].bfloat16().float()), k
            assert _rel(got[k], want[k]) <= 2e-2, k
        assert got["wkv"].dtype == torch.float32
        assert _rel(got["wkv"], want["wkv"]) <= 1e-2


def test_train_forward_starts_from_zero_state_and_remat_matches():
    cfg = get_config(ARCH).reduced()
    model = init_model(cfg, torch.Generator().manual_seed(1), device="cpu",
                       trainable=True)
    tokens = torch.tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 40)), dtype=torch.int32)
    plain, cache, _ = forward(model, cfg, tokens, Runtime(), mode="train")
    again, _, _ = forward(model, cfg, tokens, Runtime(), mode="train",
                          remat=True)
    assert cache is None and torch.equal(plain, again)
    with torch.inference_mode():
        pre, _, _ = forward(model, cfg, tokens, Runtime(), mode="prefill")
    # a fresh prefill also starts from zeros: its last logits are train's
    assert torch.allclose(pre[:, 0].float(), plain[:, -1].float(), atol=1e-5)
    plain.float().sum().backward()
    assert all(p.grad is not None and p.grad.abs().max() > 0
               for p in model.parameters())
