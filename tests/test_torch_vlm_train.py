"""One train step of the VLM backbone (``llava-next-34b`` at ``reduced()``)
in the PyTorch port against the JAX package's, on the CPU, and the train
launcher's zero prefix.

The JAX init's fp32 weights of ``tests/_torch_vlm.py``'s two variants (8
prefix embeddings; G 7 at head_dim 128 over 600 of them) are bridged into
a trainable port model; one numpy batch of 2 x 16 (40) tokens and the
variant's random fp32 prefix embeddings. The loss scores the text
positions only (``logits[:, P:]``, as ``repro.train.steps`` slices them).
The JAX gradients and steps (plain; and, at ``reduced()``, under ``remat``
and over 2 microbatches, whose split reshapes ``prefix_embeds`` too) run
jitted in one subprocess without XLA's excess precision.

Tolerances are ``tests/test_torch_encdec_train.py``'s, with its reasons:
loss and nll 1e-3 relative; every gradient leaf 3e-2 relative in norm
(the JAX gradients read back from its step's first moments); parameters
after one AdamW step within 2 lr, at most 2% of a leaf's elements beyond
lr / 10; first moments 3e-2 relative in norm; the gradient norm 5e-3
relative.

The train launchers feed zero prefix embeddings (batch, P, d) in bf16.
Zero stays exactly zero through every layer (no biases; q, k, v and
SwiGLU of 0 are 0), and each RMSNorm at 0 passes its gradient on times
1/sqrt(1e-6) = 1000: at 2 and 4 layers both packages' gradient norms are
finite and agree; at 16 layers the JAX step's is NaN, and so is the
port's, and both launchers print ``gnorm=nan`` and return 1.
"""

import dataclasses
import inspect
import os
import pickle
import re
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.launch import train as jax_launch_train  # noqa: E402
from repro.models.transformer import init_model as jax_init_model  # noqa: E402
from repro_torch.bridge import (opt_state_to_jax, params_from_jax,  # noqa: E402
                                params_to_jax)
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.transformer import Runtime, forward  # noqa: E402
from repro_torch.optim.adamw import AdamWState  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.loss import lm_loss  # noqa: E402
from repro_torch.train.steps import (init_opt_state, make_loss_fn,  # noqa: E402
                                     make_train_step)
from tests._torch_vlm import SOURCE as HELPERS  # noqa: E402
from tests._torch_vlm import PREFIX, TEXT, VARIANTS  # noqa: E402
from tests._torch_vlm import vlm_config, vlm_prefix, vlm_tokens  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "llava-next-34b"
B, LR = 2, 1e-3
REL, GRAD_REL, MU_REL, GNORM_REL = 1e-3, 3e-2, 3e-2, 5e-3
# finite, finite (the card's training depth), then NaN in the JAX step
ZERO_DEPTHS = (2, 4, 16)
STEPS = {"plain": {}, "remat": {"remat": True}, "mb2": {"microbatches": 2}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(name, vocab, d):
    toks = vlm_tokens(name, B, vocab, extra=1)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "prefix_embeds": vlm_prefix(name, B, d)}


def _zero_batch(cfg):
    """The launcher's batch shape: 2 x 16 tokens after zero (bf16) prefix
    embeddings (numpy fp32 zeros here: exactly the same values)."""
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, 17)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "prefix_embeds": np.zeros((B, cfg.num_prefix_embeddings,
                                       cfg.d_model), np.float32)}


def _rel(got, want):
    n = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / max(n, 1e-30))


SUB = '''
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_allow_excess_precision=false"
import numpy as np
import jax, jax.numpy as jnp
from repro.configs.registry import get_config
from repro.models.transformer import Runtime, init_model
from repro.optim.adamw import adamw_init
from repro.train.checkpoint import _flatten
from repro.train.steps import make_train_step

exec(os.environ["VT_HELPERS"])
arch, variants, (B, LR), steps, depths = eval(os.environ["VT_ARGS"])
rt = Runtime()
res = {}
for name in variants:
    cfg = vlm_config(get_config(arch).reduced(), name)
    batch = {k: jnp.asarray(v) for k, v in _batch(
        name, cfg.vocab_size, cfg.d_model).items()}
    params = init_model(jax.random.PRNGKey(0), cfg)
    for label, kw in steps.items():
        if name != "reduced" and label != "plain":
            continue
        step = jax.jit(make_train_step(cfg, rt, lr_fn=lambda s: LR, **kw))
        p1, o1, m = step(params, adamw_init(params), batch)
        res[(name, label)] = {
            "metrics": {k: np.asarray(v, np.float32) for k, v in m.items()},
            "params": _flatten(p1), "mu": _flatten(o1.mu)}
for L in depths:
    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=L)
    batch = {k: jnp.asarray(v) for k, v in _zero_batch(cfg).items()}
    batch["prefix_embeds"] = batch["prefix_embeds"].astype(jnp.bfloat16)
    params = init_model(jax.random.PRNGKey(0), cfg)
    step = jax.jit(make_train_step(cfg, rt, lr_fn=lambda s: LR))
    _, _, m = step(params, adamw_init(params), batch)
    res[("zero", L)] = {k: float(m[k]) for k in ("loss", "grad_norm")}
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("vlm_train") / "jax_train.pkl"
    helpers = HELPERS + "\n\n" + "\n\n".join(
        inspect.getsource(f) for f in (_batch, _zero_batch))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               VT_HELPERS=helpers,
               VT_ARGS=repr((ARCH, VARIANTS, (B, LR), STEPS, ZERO_DEPTHS)))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB),
                           str(out)], capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


_TREES = {}         # the JAX init's tree per config, drawn once


def _port(name="reduced", layers=None):
    cfg = vlm_config(get_config(ARCH).reduced(), name)
    jcfg = vlm_config(jax_get_config(ARCH).reduced(), name)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
    key = (name, cfg.num_layers)
    if key not in _TREES:
        _TREES[key] = jax.tree.map(np.asarray, jax_init_model(
            jax.random.PRNGKey(0), jcfg))
    return cfg, params_from_jax(_TREES[key], cfg, device="cpu",
                                trainable=True)


def _as_jax_tree(model, per_param):
    state = AdamWState(torch.zeros((), dtype=torch.int32), per_param,
                       per_param)
    return opt_state_to_jax(state, model).mu


def _jax_grads(ref):
    """The JAX step's gradients from its first moments (one step from zero
    moments keeps ``mu = (1 - b1) g`` of the gradient clipped to norm 1)."""
    scale = min(1.0, 1.0 / float(ref["metrics"]["grad_norm"]))
    return {k: m / (0.1 * scale) for k, m in ref["mu"].items()}


def test_loss_scores_the_text_positions_only():
    cfg, model = _port()
    batch = {k: torch.tensor(v) for k, v in _batch(
        "reduced", cfg.vocab_size, cfg.d_model).items()}
    with torch.no_grad():
        loss, metrics = make_loss_fn(cfg, Runtime())(model, batch)
        logits, _, _ = forward(model, cfg, batch["tokens"], Runtime(),
                               mode="train",
                               prefix_embeds=batch["prefix_embeds"])
    P, S = PREFIX["reduced"], TEXT["reduced"]
    assert tuple(logits.shape) == (B, P + S, cfg.vocab_size)
    want, _ = lm_loss(logits[:, P:], batch["labels"])
    assert float(loss) == float(want)
    assert set(metrics) == {"nll", "accuracy"}


@pytest.mark.parametrize("name", VARIANTS)
def test_gradients_match_jax_leaf_by_leaf(jax_ref, name):
    ref = jax_ref[(name, "plain")]
    cfg, model = _port(name)
    batch = {k: torch.tensor(v) for k, v in _batch(
        name, cfg.vocab_size, cfg.d_model).items()}
    ops.reset_launches()
    loss, _ = make_loss_fn(cfg, Runtime())(model, batch)
    loss.backward()
    assert sum(ops.LAUNCHES.values()) == 0        # no kernel on this path
    assert loss.item() == pytest.approx(float(ref["metrics"]["loss"]),
                                        rel=REL)
    grads = ckpt.flatten(_as_jax_tree(model, {
        n: p.grad for n, p in model.named_parameters()}))
    want = _jax_grads(ref)
    assert grads.keys() == want.keys()
    for key, w in want.items():
        assert _rel(grads[key], w) <= GRAD_REL, key
        assert np.abs(grads[key]).max() > 0, key


def _check_step(ref, model, opt, m):
    want = ref["metrics"]
    assert set(m) == set(want)
    for k in ("loss", "nll"):
        assert float(m[k]) == pytest.approx(float(want[k]), rel=REL), k
    assert float(m["grad_norm"]) == pytest.approx(float(want["grad_norm"]),
                                                  rel=GNORM_REL)
    params = ckpt.flatten(params_to_jax(model))
    assert params.keys() == ref["params"].keys()
    for key, w in ref["params"].items():
        d = np.abs(params[key] - w)
        assert d.max() <= 2 * LR + 1e-6, (key, float(d.max()))
        assert (d > LR / 10).mean() <= 0.02, key
    mu = ckpt.flatten(opt_state_to_jax(opt, model).mu)
    for key, w in ref["mu"].items():
        assert _rel(mu[key], w) <= MU_REL, key


@pytest.mark.parametrize("name,label", [("reduced", "plain"),
                                        ("reduced", "remat"),
                                        ("reduced", "mb2"),
                                        ("wide", "plain")])
def test_train_step_matches_jax(jax_ref, name, label):
    """The step plain, under ``remat`` and over 2 microbatches (each of
    one row and its prefix), against the JAX step made the same way."""
    cfg, model = _port(name)
    opt, m = make_train_step(cfg, Runtime(), lr_fn=lambda s: LR,
                             **STEPS[label])(
        model, init_opt_state(model), _batch(name, cfg.vocab_size,
                                             cfg.d_model))
    _check_step(jax_ref[(name, label)], model, opt, m)


def test_launch_train_matches_the_jax_launcher(capsys, monkeypatch):
    """Both launchers on the reduced config: the same lines (numbers
    aside), and the port's batch carries zero prefix embeddings (batch, P,
    d) in bf16 every step."""
    argv = ["--arch", ARCH, "--reduced", "--steps", "3", "--batch", "2",
            "--seq", "16", "--log-every", "1"]
    assert jax_launch_train.main(argv) in (0, 1)
    want = capsys.readouterr().out.splitlines()
    from repro_torch.train import steps

    seen = []
    real = steps.forward

    def spy(*a, **kw):
        seen.append(kw.get("prefix_embeds"))
        return real(*a, **kw)
    monkeypatch.setattr(steps, "forward", spy)
    assert launch_train.main(argv + ["--device", "cpu"]) in (0, 1)
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert re.sub(r"[\d.e+-]+", "#", g) == re.sub(r"[\d.e+-]+", "#", w)
    assert "family=vlm moe=False" in got[0]
    assert len(seen) == 3
    for p in seen:
        assert p.dtype == torch.bfloat16 and tuple(p.shape) == (2, 8, 256)
        assert not p.any()


def test_zero_prefix_gradient_is_the_references(jax_ref):
    """The launcher's zero prefix: at 2 and 4 layers the gradient norm is
    finite and the port's equals the JAX step's; at 16 layers both are NaN
    (the loss stays finite)."""
    for L in ZERO_DEPTHS:
        ref = jax_ref[("zero", L)]
        cfg, model = _port(layers=L)
        batch = _zero_batch(cfg)
        batch["prefix_embeds"] = torch.zeros(
            batch["prefix_embeds"].shape, dtype=torch.bfloat16)
        _, m = make_train_step(cfg, Runtime(), lr_fn=lambda s: LR)(
            model, init_opt_state(model), batch)
        assert float(m["loss"]) == pytest.approx(ref["loss"], rel=REL)
        if L != ZERO_DEPTHS[-1]:
            assert np.isfinite(ref["grad_norm"])
            assert float(m["grad_norm"]) == pytest.approx(ref["grad_norm"],
                                                          rel=GNORM_REL)
        else:
            assert np.isnan(ref["grad_norm"])
            assert np.isnan(float(m["grad_norm"]))


def test_launchers_write_nan_at_16_layers(capsys, monkeypatch):
    """Both launchers at 16 layers (reduced widths, their zero prefix):
    step 0's gradient norm is NaN, AdamW writes NaN into every weight,
    and each returns 1."""
    L = ZERO_DEPTHS[-1]
    deep = {pkg: types.SimpleNamespace(reduced=lambda g=get: dataclasses.replace(
        g(ARCH).reduced(), num_layers=L)) for pkg, get in
        (("jax", jax_get_config), ("port", get_config))}
    argv = ["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2",
            "--seq", "16", "--log-every", "1"]
    monkeypatch.setattr(jax_launch_train, "get_config",
                        lambda name: deep["jax"])
    assert jax_launch_train.main(argv) == 1
    want = capsys.readouterr().out.splitlines()
    monkeypatch.setattr(launch_train, "get_config",
                        lambda name: deep["port"])
    assert launch_train.main(argv + ["--device", "cpu"]) == 1
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert re.sub(r"[\d.e+-]+", "#", g) == re.sub(r"[\d.e+-]+", "#", w)
    assert "gnorm=nan" in got[1] and "gnorm=nan" in want[1]
    assert "loss=nan" in got[2] and "loss=nan" in want[2]
