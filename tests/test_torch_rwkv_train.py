"""One train step of RWKV-6 (``rwkv6-7b`` at ``reduced()``) in the PyTorch
port against the JAX package's, on the CPU, and the checkpoints and the
launcher around it.

The JAX init's fp32 weights, and its ``clip`` and ``shift`` variants
(``tests/_torch_rwkv.py``: every decay rate at the 0.9 clip, and the
token shift's ``mu`` at scale 0.5), are bridged into a trainable
port model; one numpy batch of 4 x 40 tokens (a whole chunk and a padded
one). The JAX gradients and step run jitted in one subprocess without
XLA's excess precision.

Tolerances are ``tests/test_torch_train.py``'s, with its reasons: loss
and nll 1e-3 relative; every gradient leaf 3e-2 relative in norm;
parameters after one AdamW step within 2 lr, at most 2% of a leaf's
elements beyond lr / 10; first moments 3e-2 relative in norm. The gradient
norm is held to 5e-3 relative: it is dominated by the embedding table's
gradient, whose bf16 backward differs from JAX's by about 1.4% in norm,
and JAX's own gradient norm moves by more than 1e-3 between its jitted
runs with and without excess precision (a test here shows it). Under the clip the gradients of ``decay_base`` and of the decay
LoRA are zero in both packages (the clip's flat side), so Adam leaves them
where the weight decay alone moves them. The port's
weight-decay mask equals the JAX rule (``ndim >= 2`` of the stacked tree)
leaf for leaf: every layer leaf of the stack decays, ``mu``,
``decay_base``, ``bonus`` and ``ln_out`` among them.

Checkpoints: a port checkpoint of a trained step restores in the JAX
package's ``restore_like`` over a template of its own trees, and the JAX
package's checkpoint of that state restores in the port's, bit for bit
both ways. ``launch.train --arch rwkv6-7b --reduced --device cpu`` runs
and its loss falls.
"""

import contextlib
import inspect
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
from tests._torch_rwkv import SOURCE as VARIANT_SOURCE  # noqa: E402
from tests._torch_rwkv import VARIANTS, rwkv_variant  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "rwkv6-7b"
B, S, LR = 4, 40, 1e-3
REL, GRAD_REL, MU_REL = 1e-3, 3e-2, 3e-2
# the leaves the clip cuts off from the loss
CLIPPED = tuple(f"layers/time_mix/{n}" for n in ("decay_base", "decay_lora_a",
                                                 "decay_lora_b"))
GNORM_REL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(jcfg, variant):
    return rwkv_variant(jax_init_model(jax.random.PRNGKey(0), jcfg), variant)


def _batch(vocab, seed=0):
    toks = np.random.default_rng(seed).integers(
        0, vocab, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _rel(got, want):
    n = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / max(n, 1e-30))


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

exec(os.environ["RT_HELPERS"])
arch, variants, (B, S, LR) = eval(os.environ["RT_ARGS"])
cfg = get_config(arch).reduced()
rt = Runtime()
batch = {k: jnp.asarray(v) for k, v in _batch(cfg.vocab_size).items()}


def loss_fn(p):
    logits, _, _ = forward(p, cfg, batch, rt, mode="train")
    return lm_loss(logits, batch["labels"])[0]


grad_fn = jax.jit(jax.value_and_grad(loss_fn))
step = jax.jit(make_train_step(cfg, rt, lr_fn=lambda s: LR))
res = {}
for name in variants:
    params = jax.tree.map(jnp.asarray, _tree(cfg, name))
    loss, grads = grad_fn(params)
    p1, o1, m = step(params, adamw_init(params), batch)
    res[name] = {"grad_loss": float(loss), "grads": _flatten(grads),
                 "metrics": {k: np.asarray(v, np.float32)
                             for k, v in m.items()},
                 "params": _flatten(p1), "mu": _flatten(o1.mu)}
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("rwkv_train") / "jax_train.pkl"
    helpers = VARIANT_SOURCE + "\n\n" + "\n\n".join(
        inspect.getsource(f) for f in (_tree, _batch))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               RT_HELPERS=helpers, RT_ARGS=repr((ARCH, VARIANTS, (B, S, LR))))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB),
                           str(out)], capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


_INIT = {}          # the JAX init's tree, drawn once


def _port(variant="init"):
    cfg = get_config(ARCH).reduced()
    if not _INIT:
        _INIT["tree"] = _tree(jax_get_config(ARCH).reduced(), "init")
    tree = rwkv_variant(_INIT["tree"], variant)
    return cfg, tree, params_from_jax(tree, cfg, device="cpu", trainable=True)


def _as_jax_tree(model, per_param):
    """{port name: tensor} -> the JAX tree layout (through the bridge's
    optimizer-state path, which maps every parameter)."""
    state = AdamWState(torch.zeros((), dtype=torch.int32), per_param,
                       per_param)
    return opt_state_to_jax(state, model).mu


@pytest.mark.parametrize("variant", VARIANTS)
def test_gradients_match_jax_leaf_by_leaf(jax_ref, variant):
    ref = jax_ref[variant]
    cfg, _, model = _port(variant)
    batch = {k: torch.tensor(v) for k, v in _batch(cfg.vocab_size).items()}
    ops.reset_launches()
    loss, metrics = make_loss_fn(cfg, Runtime())(model, batch)
    loss.backward()
    assert sum(ops.LAUNCHES.values()) == 0        # RWKV launches no kernel
    assert set(metrics) == {"nll", "accuracy"}   # no aux loss, no counts
    assert loss.item() == pytest.approx(ref["grad_loss"], rel=REL)
    params = dict(model.named_parameters())
    grads = ckpt.flatten(_as_jax_tree(model, {n: p.grad for n, p
                                              in params.items()}))
    assert grads.keys() == ref["grads"].keys()
    for key, w in ref["grads"].items():
        if key in CLIPPED and variant == "clip":
            # every rate sits on the clip's flat side: no gradient at all
            assert not np.abs(w).any() and not np.abs(grads[key]).any()
            continue
        assert _rel(grads[key], w) <= GRAD_REL, key
        assert np.abs(grads[key]).max() > 0, key        # nothing detached


@pytest.mark.parametrize("variant", VARIANTS)
def test_train_step_matches_jax(jax_ref, variant):
    ref = jax_ref[variant]
    cfg, _, model = _port(variant)
    opt, m = make_train_step(cfg, Runtime(), lr_fn=lambda s: LR)(
        model, init_opt_state(model), _batch(cfg.vocab_size))
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
        if key in CLIPPED and variant == "clip":
            assert not np.abs(w).any() and not np.abs(mu[key]).any()
            continue
        assert _rel(mu[key], w) <= MU_REL, key


def test_gradient_norm_tolerance_is_the_references_own_spread(jax_ref):
    """JAX jitted with excess precision (this process: no XLA flag) against
    JAX jitted without it (the subprocess): the same weights and batch give
    gradient norms further apart than 1e-3, and within ``GNORM_REL``."""
    from repro.models.transformer import Runtime as JaxRuntime
    from repro.models.transformer import forward as jax_forward
    from repro.train.loss import lm_loss as jax_lm_loss

    jcfg = jax_get_config(ARCH).reduced()
    _port()
    params = jax.tree.map(jnp.asarray, _INIT["tree"])
    batch = {k: jnp.asarray(v) for k, v in _batch(jcfg.vocab_size).items()}

    def loss_fn(p):
        logits, _, _ = jax_forward(p, jcfg, batch, JaxRuntime(), mode="train")
        return jax_lm_loss(logits, batch["labels"])[0]
    grads = jax.jit(jax.grad(loss_fn))(params)
    norm = float(np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2)
                             for g in jax.tree.leaves(grads))))
    want = float(jax_ref["init"]["metrics"]["grad_norm"])
    assert REL < abs(norm / want - 1) <= GNORM_REL, (norm, want)


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
    # the stacked vectors decay as the JAX step decays them
    for n in ("tm_mu", "tm_decay_base", "tm_bonus", "tm_ln_out", "cm_mu",
              "ln1", "ln2"):
        assert mask[f"layers.0.{n}"] and mask[f"layers.1.{n}"], n
    assert mask["embed"] and mask["lm_head"] and not mask["final_norm"]


def test_checkpoints_cross_both_ways(tmp_path):
    cfg, tree, model = _port("shift")
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
    assert "params/layers/time_mix/ln_out/scale" in got
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
    batch = _batch(get_config(ARCH).reduced().vocab_size, seed=3)
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


def test_launch_train_runs_rwkv(tmp_path):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = launch_train.main(["--arch", ARCH, "--reduced", "--device",
                                "cpu", "--steps", "12", "--batch", "2",
                                "--seq", "40", "--log-every", "4",
                                "--ckpt", str(tmp_path / "c.npz")])
    text = out.getvalue()
    assert rc == 0, text
    assert "family=ssm moe=False" in text and "analytical 1.4M" in text
    assert text.count("step ") == 4
    loaded = ckpt.load(str(tmp_path / "c.npz"))
    assert loaded["params"]["layers"]["time_mix"]["bonus"].shape == (2, 4, 64)
