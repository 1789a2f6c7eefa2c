"""One train step of the dense family in the PyTorch port against the JAX
package's, on the CPU, and the checkpoints and the launcher around it.

``qwen1.5-0.5b`` (nonzero QKV biases, drawn into the tree), ``olmo-1b``
(the non-parametric LayerNorm: its norms are empty dicts in the JAX tree),
``stablelm-3b`` and ``minicpm-2b`` (tied embeddings: the table's gradient
sums its two uses) at ``reduced()``, from the JAX init's fp32 weights
bridged into a trainable port model, and one numpy batch. The JAX step
runs jitted in one subprocess without XLA's excess precision.

Tolerances are ``tests/test_torch_train.py``'s, with its reasons: loss,
nll and gradient norm 1e-3 relative; every gradient leaf (the biases and
the tied table among them) 3e-2 relative in norm; parameters after one
AdamW step within 2 lr (at most 2% of a leaf's elements beyond lr / 10);
first moments 3e-2 relative in norm. One leaf counts its 2% over part of
its elements: the K bias, whose gradient is what RoPE leaves of a shift the
softmax ignores (q . (k + b) moves every score of a query alike but for
the rotation), so a fifth of its elements sit 100-1000x below its largest,
under the bf16 noise of the two packages, and Adam's first step moves each
by lr along a sign that noise picks; there the 2% is counted over the
elements whose JAX gradient is at least a bf16 ulp (2^-8) of the leaf's
largest (at least half of them), and the 2 lr bound holds for all. The
port's weight-decay mask equals
the JAX rule (``ndim >= 2`` of the stacked tree) leaf for leaf: the
``(L, H*hd)`` biases and the one ``(V, d)`` table decay.

Checkpoints: a port checkpoint of a trained step restores in the JAX
package's ``restore_like`` over a template of its own trees (olmo's empty
norms and minicpm's missing ``lm_head`` included: the JAX tree structure
comes back), and the JAX package's checkpoint of that state restores in the
port's ``restore_like``, bit for bit both ways. ``launch.train --arch
minicpm-2b --reduced --device cpu`` runs the WSD schedule: its lr at every
step equals ``repro.optim.schedules.wsd_schedule``'s, bit for bit.
"""

import contextlib
import io
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

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models.transformer import init_model as jax_init_model  # noqa: E402
from repro.optim.adamw import AdamWState as JaxAdamWState  # noqa: E402
from repro.optim.adamw import adamw_init as jax_adamw_init  # noqa: E402
from repro.optim.schedules import wsd_schedule as jax_wsd  # noqa: E402
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

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen1.5-0.5b", "olmo-1b", "stablelm-3b", "minicpm-2b")
B, S, LR = 4, 16, 1e-3
REL, GRAD_REL, MU_REL = 1e-3, 3e-2, 3e-2
K_BIAS = "layers/attn/wk/b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    n = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / max(n, 1e-30))


def _tree(jcfg):
    """The JAX init's fp32 tree with nonzero QKV biases where the config
    has them."""
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jax_init_model(
        jax.random.PRNGKey(0), jcfg))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(7)
        for n in ("wq", "wk", "wv"):
            b = tree["layers"]["attn"][n]["b"]
            tree["layers"]["attn"][n]["b"] = rng.normal(
                0.0, 0.5, b.shape).astype(np.float32)
    return tree


def _batch(vocab, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


SUB = '''
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_allow_excess_precision=false"
import numpy as np
import jax, jax.numpy as jnp
from repro.configs.registry import get_config
from repro.models.transformer import Runtime, forward, init_model
from repro.optim.adamw import adamw_init
from repro.train.checkpoint import _flatten
from repro.train.loss import lm_loss
from repro.train.steps import make_train_step
jax_init_model = init_model

exec(os.environ["DT_HELPERS"])
B, S, LR = eval(os.environ["DT_SHAPE"])
res = {}
for arch in eval(os.environ["DT_ARCHS"]):
    cfg = get_config(arch).reduced()
    params = jax.tree.map(jnp.asarray, _tree(cfg))
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg.vocab_size).items()}
    rt = Runtime()

    def loss_fn(p):
        logits, _, st = forward(p, cfg, batch, rt, mode="train")
        loss, _ = lm_loss(logits, batch["labels"])
        return loss
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    step = jax.jit(make_train_step(cfg, rt, lr_fn=lambda s: LR))
    p1, o1, m = step(params, adamw_init(params), batch)
    res[arch] = {"grad_loss": float(loss), "grads": _flatten(grads),
                 "metrics": {k: np.asarray(v, np.float32)
                             for k, v in m.items()},
                 "params": _flatten(p1), "mu": _flatten(o1.mu)}
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    import inspect

    out = tmp_path_factory.mktemp("dense_train") / "jax_train.pkl"
    helpers = "\n\n".join(inspect.getsource(f) for f in (_tree, _batch))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               DT_HELPERS=helpers, DT_ARCHS=repr(ARCHS),
               DT_SHAPE=repr((B, S, LR)))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB),
                           str(out)], capture_output=True, text=True,
                          timeout=900, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _port(arch):
    cfg = get_config(arch).reduced()
    tree = _tree(jax_get_config(arch).reduced())
    return cfg, tree, params_from_jax(tree, cfg, device="cpu", trainable=True)


def _as_jax_tree(model, per_param):
    """{port name: tensor} -> the JAX tree layout (through the bridge's
    optimizer-state path, which maps every parameter)."""
    state = AdamWState(torch.zeros((), dtype=torch.int32), per_param,
                       per_param)
    return opt_state_to_jax(state, model).mu


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_leaf_by_leaf(jax_ref, arch):
    ref = jax_ref[arch]
    cfg, _, model = _port(arch)
    batch = {k: torch.tensor(v) for k, v in _batch(cfg.vocab_size).items()}
    ops.reset_launches()
    loss, metrics = make_loss_fn(cfg, Runtime())(model, batch)
    loss.backward()
    assert sum(ops.LAUNCHES.values()) == 0       # nothing to launch on a CPU
    assert set(metrics) == {"nll", "accuracy"}  # no aux loss, no counts
    assert loss.item() == pytest.approx(ref["grad_loss"], rel=REL)
    params = dict(model.named_parameters())
    grads = ckpt.flatten(_as_jax_tree(model, {n: p.grad for n, p
                                              in params.items()}))
    assert grads.keys() == ref["grads"].keys()
    for key, w in ref["grads"].items():
        assert _rel(grads[key], w) <= GRAD_REL, key
        assert np.abs(grads[key]).max() > 0, key        # nothing detached
    if cfg.qkv_bias:
        assert {"layers/attn/wq/b", "layers/attn/wk/b",
                "layers/attn/wv/b"} <= grads.keys()
    if cfg.tie_embeddings:
        # the table's gradient holds both uses: the unembedding's reaches
        # every row, the lookup's only the rows the batch reads
        assert "lm_head/w" not in grads
        unread = np.setdiff1d(np.arange(cfg.vocab_size),
                              batch["tokens"].numpy())
        assert np.abs(grads["embed/table"][unread]).max() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_decay_mask_is_the_jax_rule(arch):
    cfg, tree, model = _port(arch)
    mask = weight_decay_mask(model)
    got = ckpt.flatten(_as_jax_tree(model, {
        n: torch.full_like(p, float(mask[n]))
        for n, p in model.named_parameters()}))
    want = {k: np.full(a.shape, a.ndim >= 2, np.float32)
            for k, a in jckpt._flatten(tree).items()}
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    if cfg.qkv_bias:
        assert mask["layers.0.bq"] and got["layers/attn/wq/b"].all()
    assert mask["embed"]
    if cfg.tie_embeddings:
        assert "lm_head" not in mask


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(jax_ref, arch):
    ref = jax_ref[arch]
    cfg, _, model = _port(arch)
    opt, m = make_train_step(cfg, Runtime(), lr_fn=lambda s: LR)(
        model, init_opt_state(model), _batch(cfg.vocab_size))
    want = ref["metrics"]
    assert set(m) == set(want)
    for k in ("loss", "nll", "grad_norm"):
        assert float(m[k]) == pytest.approx(float(want[k]), rel=REL), k
    assert abs(float(m["accuracy"]) - float(want["accuracy"])) <= 1 / (B * S)
    params = ckpt.flatten(params_to_jax(model))
    assert params.keys() == ref["params"].keys()
    for key, w in ref["params"].items():
        d = np.abs(params[key] - w)
        assert d.max() <= 2 * LR + 1e-6, (key, float(d.max()))
        if key == K_BIAS:
            # its resolved elements only: see the module docstring
            g = np.abs(ref["grads"][key])
            resolved = g >= g.max() * 2.0 ** -8
            assert resolved.mean() >= 0.5, resolved.mean()
            d = d[resolved]
        assert (d > LR / 10).mean() <= 0.02, key
    mu = ckpt.flatten(opt_state_to_jax(opt, model).mu)
    for key, w in ref["mu"].items():
        assert _rel(mu[key], w) <= MU_REL, key


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoints_cross_both_ways(arch, tmp_path):
    cfg, tree, model = _port(arch)
    opt, _ = make_train_step(cfg, Runtime(), lr_fn=lambda s: LR)(
        model, init_opt_state(model), _batch(cfg.vocab_size))
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
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # and its checkpoint of that state restores in the port
    jpath = str(tmp_path / "jax.npz")
    jckpt.save(jpath, restored)
    loaded = ckpt.load(jpath)
    if cfg.norm == "nonparametric":
        # an npz holds no empty dict: the template brings them back
        assert "final_norm" not in loaded["params"]
        assert tree["final_norm"] == {} and tree["layers"]["ln1"] == {}
    again = ckpt.restore_like(port_state, loaded)
    assert jax.tree.structure(again["params"]) == \
        jax.tree.structure(jparams)
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


def test_launch_train_runs_minicpms_wsd_schedule(monkeypatch):
    """The launcher on minicpm-2b (``lr_schedule="wsd"``) over 24 steps:
    10 of warmup, the stable stretch, the decay from step 21; the lr of
    every step it ran equals the JAX package's ``wsd_schedule`` at the
    launcher's arguments, bit for bit, and the loss falls (exit 0)."""
    steps, lr = 24, 3e-4
    assert get_config("minicpm-2b").lr_schedule == "wsd"
    seen = []
    real = launch_train.make_train_step

    def recording(*a, **kw):
        step = real(*a, **kw)

        def wrapped(*sa, **skw):
            opt, m = step(*sa, **skw)
            seen.append(np.float32(m["lr"]))
            return opt, m
        return wrapped
    monkeypatch.setattr(launch_train, "make_train_step", recording)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = launch_train.main(["--arch", "minicpm-2b", "--reduced",
                                "--device", "cpu", "--steps", str(steps),
                                "--batch", "2", "--seq", "16", "--lr",
                                str(lr), "--log-every", "1"])
    assert rc == 0, out.getvalue()
    want_fn = jax_wsd(lr, warmup=max(10, steps // 20), total=steps)
    want = [np.float32(want_fn(s)) for s in range(steps)]
    assert len(seen) == steps
    np.testing.assert_array_equal(np.asarray(seen), np.asarray(want))
    assert want[5] < want[10] == want[20] > want[23] > 0   # warm, flat, decay
    assert out.getvalue().count(" lr=") == steps
