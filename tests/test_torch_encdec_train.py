"""One train step of the encoder-decoder (``seamless-m4t-medium`` at
``reduced()``) in the PyTorch port against the JAX package's, on the CPU,
and the checkpoints and the launcher around it.

The JAX init's fp32 weights of ``tests/_torch_encdec.py``'s three variants
(40 frames; 600; G 1 over 600 with the encoder at 8 heads of 32) are
bridged into a trainable port model; one numpy batch of 4 x 24 tokens and
the variant's random frames (zero frames would leave the encoder and the
cross-attention without a gradient). The JAX gradients and step run
jitted in one subprocess without XLA's excess precision.

Tolerances are ``tests/test_torch_rwkv_train.py``'s, with its reasons:
loss and nll 1e-3 relative; every gradient leaf 3e-2 relative in norm
(every one nonzero: the encoder's and the cross-attention's too; the JAX
gradients are read back from its step's first moments, which hold them
scaled); parameters after one AdamW step within 2 lr, at most 2% of a
leaf's elements beyond lr / 10; first moments 3e-2 relative in norm; the
gradient norm 5e-3 relative (the embedding table's bf16 backward
dominates it).
The port's weight-decay mask equals the JAX rule (``ndim >= 2`` of the
stacked tree) leaf for leaf: every leaf of both stacks decays, the norm
scales among them, and ``enc_norm`` does not.

Checkpoints: a port checkpoint of a trained step restores in the JAX
package's ``restore_like`` over a template of its own trees, and the JAX
package's checkpoint of that state restores in the port's, bit for bit
both ways. ``launch.train --arch seamless-m4t-medium --reduced`` prints
the JAX launcher's lines (numbers aside) and feeds the same zero frames,
and the JAX package reads its checkpoint.
"""

import contextlib
import dataclasses
import inspect
import io
import os
import pickle
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.launch import train as jax_launch_train  # noqa: E402
from repro.models.transformer import init_model as jax_init_model  # noqa: E402
from repro.optim.adamw import AdamWState as JaxAdamWState  # noqa: E402
from repro.optim.adamw import adamw_init as jax_adamw_init  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.bridge import (opt_state_from_jax, opt_state_to_jax,  # noqa: E402
                                params_from_jax, params_to_jax)
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.transformer import Runtime  # noqa: E402
from repro_torch.optim.adamw import AdamWState  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.steps import (init_opt_state, make_loss_fn,  # noqa: E402
                                     make_train_step, weight_decay_mask)
from tests._torch_encdec import SOURCE as HELPERS  # noqa: E402
from tests._torch_encdec import VARIANTS, encdec_config  # noqa: E402
from tests._torch_encdec import encdec_frames  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "seamless-m4t-medium"
B, S, LR = 4, 24, 1e-3
REL, GRAD_REL, MU_REL, GNORM_REL = 1e-3, 3e-2, 3e-2, 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(name, vocab, d_enc, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:],
            "frames": encdec_frames(name, B, d_enc, seed)}


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

exec(os.environ["ET_HELPERS"])
arch, variants, (B, S, LR) = eval(os.environ["ET_ARGS"])
rt = Runtime()
res = {}
for name in variants:
    cfg = encdec_config(get_config(arch).reduced(), name)
    batch = {k: jnp.asarray(v) for k, v in _batch(
        name, cfg.vocab_size, cfg.encoder.d_model).items()}
    params = init_model(jax.random.PRNGKey(0), cfg)
    step = jax.jit(make_train_step(cfg, rt, lr_fn=lambda s: LR))
    p1, o1, m = step(params, adamw_init(params), batch)
    res[name] = {"metrics": {k: np.asarray(v, np.float32)
                             for k, v in m.items()},
                 "params": _flatten(p1), "mu": _flatten(o1.mu)}
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("encdec_train") / "jax_train.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               ET_HELPERS=HELPERS + "\n\n" + inspect.getsource(_batch),
               ET_ARGS=repr((ARCH, VARIANTS, (B, S, LR))))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB),
                           str(out)], capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


_TREES = {}         # the JAX init's tree per variant, drawn once


def _port(name="reduced"):
    cfg = encdec_config(get_config(ARCH).reduced(), name)
    if name not in _TREES:
        jcfg = encdec_config(jax_get_config(ARCH).reduced(), name)
        _TREES[name] = jax.tree.map(np.asarray, jax_init_model(
            jax.random.PRNGKey(0), jcfg))
    tree = _TREES[name]
    return cfg, tree, params_from_jax(tree, cfg, device="cpu", trainable=True)


def _as_jax_tree(model, per_param):
    """{port name: tensor} -> the JAX tree layout (through the bridge's
    optimizer-state path, which maps every parameter)."""
    state = AdamWState(torch.zeros((), dtype=torch.int32), per_param,
                       per_param)
    return opt_state_to_jax(state, model).mu


def _jax_grads(ref):
    """The JAX step's gradients, leaf by leaf, from its first moments: one
    step from zero moments keeps ``mu = (1 - b1) g`` of the clipped
    gradient, and the clip scales every leaf by ``min(1, 1 / gnorm)``
    (``repro.optim.adamw``: b1 0.9, max_grad_norm 1.0)."""
    scale = min(1.0, 1.0 / float(ref["metrics"]["grad_norm"]))
    return {k: m / (0.1 * scale) for k, m in ref["mu"].items()}


@pytest.mark.parametrize("name", VARIANTS)
def test_gradients_match_jax_leaf_by_leaf(jax_ref, name):
    ref = jax_ref[name]
    cfg, _, model = _port(name)
    batch = {k: torch.tensor(v) for k, v in _batch(
        name, cfg.vocab_size, cfg.encoder.d_model).items()}
    ops.reset_launches()
    loss, metrics = make_loss_fn(cfg, Runtime())(model, batch)
    loss.backward()
    assert sum(ops.LAUNCHES.values()) == 0        # no kernel on this path
    assert set(metrics) == {"nll", "accuracy"}   # no aux loss, no counts
    assert loss.item() == pytest.approx(float(ref["metrics"]["loss"]),
                                        rel=REL)
    params = dict(model.named_parameters())
    grads = ckpt.flatten(_as_jax_tree(model, {n: p.grad for n, p
                                              in params.items()}))
    want = _jax_grads(ref)
    assert grads.keys() == want.keys()
    assert any(k.startswith("enc_layers/") for k in grads)
    for key, w in want.items():
        assert _rel(grads[key], w) <= GRAD_REL, key
        assert np.abs(grads[key]).max() > 0, key        # nothing detached


@pytest.mark.parametrize("name", VARIANTS)
def test_train_step_matches_jax(jax_ref, name):
    ref = jax_ref[name]
    cfg, _, model = _port(name)
    opt, m = make_train_step(cfg, Runtime(), lr_fn=lambda s: LR)(
        model, init_opt_state(model), _batch(name, cfg.vocab_size,
                                             cfg.encoder.d_model))
    want = ref["metrics"]
    assert set(m) == set(want)
    for k in ("loss", "nll"):
        assert float(m[k]) == pytest.approx(float(want[k]), rel=REL), k
    assert float(m["grad_norm"]) == pytest.approx(float(want["grad_norm"]),
                                                  rel=GNORM_REL)
    assert abs(float(m["accuracy"]) - float(want["accuracy"])) <= 1 / (B * S)
    params = ckpt.flatten(params_to_jax(model))
    assert params.keys() == ref["params"].keys()
    for key, w in ref["params"].items():
        d = np.abs(params[key] - w)
        assert d.max() <= 2 * LR + 1e-6, (key, float(d.max()))
        assert (d > LR / 10).mean() <= 0.02, key
    mu = ckpt.flatten(opt_state_to_jax(opt, model).mu)
    for key, w in ref["mu"].items():
        assert _rel(mu[key], w) <= MU_REL, key


def test_weight_decay_mask_is_the_jax_rule():
    cfg, tree, model = _port()
    mask = weight_decay_mask(model)
    got = ckpt.flatten(_as_jax_tree(model, {
        n: torch.full_like(p, float(mask[n]))
        for n, p in model.named_parameters()}))
    want = {k: np.full(a.shape, a.ndim >= 2, np.float32)
            for k, a in jckpt._flatten(tree).items()}
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for n in ("layers.0.ln_cross", "layers.1.ln1", "enc_layers.0.ln1",
              "enc_layers.1.ln2"):
        assert mask[n], n
    assert not mask["enc_norm"] and not mask["final_norm"]


def test_checkpoints_cross_both_ways(tmp_path):
    cfg, tree, model = _port("g1")
    opt, _ = make_train_step(cfg, Runtime(), lr_fn=lambda s: LR)(
        model, init_opt_state(model), _batch("g1", cfg.vocab_size,
                                             cfg.encoder.d_model))
    port_state = {"params": params_to_jax(model),
                  "opt": opt_state_to_jax(opt, model)}
    path = str(tmp_path / "port.npz")
    ckpt.save(path, port_state)
    # the JAX package restores it over a template of its own trees
    jparams = jax.tree.map(jnp.asarray, tree)
    template = {"params": jparams, "opt": jax_adamw_init(jparams)}
    restored = jckpt.restore_like(template, jckpt.load(path))
    assert jax.tree.structure(restored) == jax.tree.structure(template)
    assert isinstance(restored["opt"], JaxAdamWState)
    assert int(restored["opt"].step) == 1
    want = ckpt.flatten(port_state)
    got = jckpt._flatten(restored)
    assert got.keys() == want.keys()
    for key in ("params/enc_norm/scale", "params/layers/cross/wk/w",
                "params/enc_layers/attn/wq/w", "opt/mu/layers/ln_cross/scale"):
        assert key in got, key
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # and its checkpoint of that state restores in the port
    jpath = str(tmp_path / "jax.npz")
    jckpt.save(jpath, restored)
    again = ckpt.restore_like(port_state, ckpt.load(jpath))
    back = params_from_jax(again["params"], cfg, device="cpu",
                           trainable=True)
    for (n, a), (_, b) in zip(model.named_parameters(),
                              back.named_parameters()):
        assert torch.equal(a, b), n
    opt2 = opt_state_from_jax(again["opt"], back)
    assert int(opt2.step) == 1
    for n in opt.mu:
        assert torch.equal(opt.mu[n], opt2.mu[n]), n
        assert torch.equal(opt.nu[n], opt2.nu[n]), n


def test_remat_and_microbatches_match_the_plain_step():
    cfg0 = get_config(ARCH).reduced()
    batch = _batch("reduced", cfg0.vocab_size, 256, seed=3)
    out = {}
    for label, kw in (("plain", {}), ("remat", {"remat": True}),
                      ("mb2", {"microbatches": 2})):
        cfg, _, model = _port()
        _, m = make_train_step(cfg, Runtime(), lr_fn=lambda s: LR, **kw)(
            model, init_opt_state(model), batch)
        out[label] = (float(m["loss"]), ckpt.flatten(params_to_jax(model)))
    loss, params = out["plain"]
    assert out["remat"][0] == loss
    for key, w in params.items():
        np.testing.assert_array_equal(out["remat"][1][key], w, err_msg=key)
    assert out["mb2"][0] == pytest.approx(loss, rel=1e-5)
    for key, w in params.items():
        assert np.abs(out["mb2"][1][key] - w).max() <= 2 * LR + 1e-6, key


def test_launch_train_matches_the_jax_launcher(tmp_path, capsys,
                                               monkeypatch):
    """Both launchers on the reduced config: the same lines (numbers
    aside), the same zero frames (batch, min(64, max_source_len), d_enc)
    in bf16 each step, and the port's checkpoint restores in the JAX
    package over its own template."""
    argv = ["--arch", ARCH, "--reduced", "--steps", "3", "--batch", "2",
            "--seq", "16", "--log-every", "1"]
    assert jax_launch_train.main(argv) in (0, 1)
    want = capsys.readouterr().out.splitlines()
    from repro_torch.train import steps

    seen = []
    real = steps.forward

    def spy(*a, **kw):
        seen.append(kw.get("frames"))
        return real(*a, **kw)
    monkeypatch.setattr(steps, "forward", spy)
    path = str(tmp_path / "c.npz")
    assert launch_train.main(argv + ["--device", "cpu", "--ckpt", path]) \
        in (0, 1)
    got = capsys.readouterr().out.splitlines()
    assert got[-1] == f"checkpoint saved to {path}"
    got = got[:-1]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert re.sub(r"[\d.e+-]+", "#", g) == re.sub(r"[\d.e+-]+", "#", w)
    assert "family=audio moe=False" in got[0]
    assert len(seen) == 3
    for f in seen:
        assert f.dtype == torch.bfloat16 and tuple(f.shape) == (2, 64, 256)
        assert not f.any()
    jcfg = jax_get_config(ARCH).reduced()
    jparams = jax_init_model(jax.random.PRNGKey(0), jcfg)
    template = {"params": jparams, "opt": jax_adamw_init(jparams)}
    restored = jckpt.restore_like(template, jckpt.load(path))
    assert int(restored["opt"].step) == 3
    assert restored["params"]["enc_layers"]["ffn"]["w_up"].shape == (
        2, 256, 512)


def test_launch_train_runs_seamless():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = launch_train.main(["--arch", ARCH, "--reduced", "--device",
                                "cpu", "--steps", "12", "--batch", "2",
                                "--seq", "24", "--log-every", "4"])
    text = out.getvalue()
    assert rc == 0, text
    assert "family=audio moe=False" in text and "analytical 2.5M" in text
    assert text.count("step ") == 4


def test_zero_frames_give_the_encoder_the_references_gradient():
    """The train launcher's zero frames make every encoder activation 0,
    so its weights' gradients (activations times the output's gradient)
    are exactly 0, until that output gradient, multiplied by 1/sqrt(eps) =
    1000 at each of the encoder's RMSNorms at 0, overflows and 0 x inf
    gives NaN. With 8 encoder layers (reduced widths) the bottom layer's
    gradients hold NaNs and the seven above are exactly 0, in both
    packages, layer by layer, while the loss is finite. The published
    12-layer model overflows too (the chip phase's ``launch.train``)."""
    from repro.models.transformer import Runtime as JaxRuntime
    from repro.models.transformer import forward as jax_forward
    from repro.train.loss import lm_loss as jax_lm_loss

    L = 8
    jcfg = jax_get_config(ARCH).reduced()
    jcfg = dataclasses.replace(jcfg, encoder=dataclasses.replace(
        jcfg.encoder, num_layers=L))
    cfg = get_config(ARCH).reduced()
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, num_layers=L))
    batch = dict(_batch("reduced", cfg.vocab_size, 256),
                 frames=np.zeros((B, 64, 256), np.float32))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax_init_model(jax.random.PRNGKey(0), jcfg)

    def loss_fn(p):
        logits = jax_forward(p, jcfg, jb, JaxRuntime(), mode="train")[0]
        return jax_lm_loss(logits, jb["labels"])[0]
    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu", trainable=True)
    loss, _ = make_loss_fn(cfg, Runtime())(
        model, {k: torch.tensor(v) for k, v in batch.items()})
    loss.backward()
    assert np.isfinite(float(jloss)) and np.isfinite(loss.item())
    states = []
    for l in range(L):
        want = np.concatenate([np.asarray(g)[l].ravel() for g in
                               jax.tree.leaves(jgrads["enc_layers"])])
        got = torch.cat([p.grad.ravel() for n, p in model.named_parameters()
                         if n.startswith(f"enc_layers.{l}.")]).numpy()
        state = "nan" if np.isnan(want).any() else "zero"
        assert ("nan" if np.isnan(got).any() else "zero") == state, l
        if state == "zero":
            assert not want.any() and not got.any(), l
        states.append(state)
    assert states[0] == "nan" and states[-1] == "zero", states
