"""One train step of ``deepseek-v2-lite-16b`` in the PyTorch port against
the JAX package's, on the CPU, and the checkpoints and the launcher around
it.

Two configs (``tests/test_torch_mla_models.py``'s): ``reduced()`` (E 4,
top-2, one shared expert) and the router variant (E 16, top-6, 2 shared
experts), from the JAX init's fp32 weights with wide router and
``lm_head`` margins over all K picks (``widen_topk``), bridged into a
trainable port model, and one numpy batch of 4 x 16 tokens. Two paths
each: the single-device MoE path (``Runtime()``) and the EP dispatch over
4 ranks under the identity plan (the meshed JAX step: ``Runtime(mesh,
ep=True, ep_ranks=4, use_duplication=False)`` with ``plan_args`` on a
``(1, 4)`` ``AxisType.Auto`` mesh). The JAX steps run jitted in one
subprocess with four host devices and without XLA's excess precision.

Tolerances are ``tests/test_torch_train.py``'s, with its reasons: loss,
nll, aux loss and gradient norm 1e-3 relative; every gradient leaf (MLA's
six projections and the shared FFN's three among them) 3e-2 relative in
norm; parameters after one AdamW step within 2 lr (at most 2% of a leaf's
elements beyond lr / 10); first moments 3e-2 relative in norm; expert
counts and (EP) per-layer drops equal. AdamW decays what the JAX step
decays: every leaf of ndim >= 2 of the JAX tree, where the stacked layer
leaves carry a leading L.

A port checkpoint of a trained step restores in the JAX package over its
own trees, and the JAX package's checkpoint of that state restores in the
port, leaf for leaf. ``repro_torch.launch.train --arch
deepseek-v2-lite-16b --reduced`` trains on the CPU with and without
``--data-mesh 1 --model-mesh 4`` (exit 0: the loss falls).
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

from repro.optim.adamw import AdamWState as JaxAdamWState  # noqa: E402
from repro.optim.adamw import adamw_init as jax_adamw_init  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.bridge import (opt_state_from_jax, opt_state_to_jax,  # noqa: E402
                                params_from_jax, params_to_jax)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.transformer import Runtime  # noqa: E402
from repro_torch.optim.adamw import AdamWState  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.steps import (init_opt_state, make_loss_fn,  # noqa: E402
                                     make_train_step, weight_decay_mask)

from tests._torch_margins import SOURCE as MARGINS_SOURCE  # noqa: E402
from tests.test_torch_mla_models import (ARCH, WIDEN_TOPK_SOURCE,  # noqa: E402
                                         _jax_tree, cfgs, variant,
                                         widen_topk)

ROOT = Path(__file__).resolve().parents[1]
NAMES = ("reduced", "router")
PATHS = ("dense", "ep")
R, B, S, LR = 4, 4, 16, 1e-3
REL, GRAD_REL, MU_REL = 1e-3, 3e-2, 3e-2
MLA_LEAVES = {f"layers/attn/{n}/w" for n in ("w_dkv", "w_krope", "w_uk",
                                             "w_uv", "w_q", "wo")}
SHARED_LEAVES = {f"layers/moe/shared/{n}" for n in ("w_gate", "w_up",
                                                    "w_down")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    n = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / max(n, 1e-30))


def _tree(name):
    jcfg, _ = cfgs(name)
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        widen_topk(_jax_tree(jcfg), jcfg))


def _batch(cfg):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


SUB = '''
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_allow_excess_precision=false")
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs.registry import get_config
from repro.launch.specs import plan_args
from repro.models.transformer import Runtime, forward, init_model
from repro.optim.adamw import adamw_init
from repro.train.checkpoint import _flatten
from repro.train.loss import lm_loss
from repro.train.steps import make_train_step

exec(os.environ["TRAIN_MARGINS"])
exec(os.environ["TRAIN_WIDEN"])
exec(os.environ["TRAIN_VARIANT"])
B, S, LR, R = eval(os.environ["TRAIN_SHAPE"])
mesh = jax.make_mesh((1, R), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
res = {}
for name in eval(os.environ["TRAIN_NAMES"]):
    cfg = variant(get_config(os.environ["TRAIN_ARCH"]).reduced(), name)
    tree = widen_topk(jax.tree.map(np.asarray, init_model(
        jax.random.PRNGKey(0), cfg)), cfg)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])}
    for path in ("dense", "ep"):
        if path == "ep":
            rt = Runtime(mesh=mesh, ep=True, ep_ranks=R,
                         use_duplication=False)
            plan = plan_args(cfg, R)
        else:
            rt, plan = Runtime(), None
        r = {}

        def loss_fn(p):
            logits, _, st = forward(p, cfg, batch, rt, mode="train",
                                    plan=plan)
            loss, _ = lm_loss(logits, batch["labels"])
            return loss + st["aux_loss"] + st["z_loss"], st
        with mesh:
            (loss, st), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(params)
            r["grad_loss"] = float(loss)
            r["grads"] = _flatten(grads)
            r["expert_counts"] = np.asarray(st["expert_counts"])
            if path == "ep":
                r["dropped"] = np.asarray(st["dropped"])
            step = jax.jit(make_train_step(cfg, rt, lr_fn=lambda s: LR))
            p1, o1, m = (step(params, adamw_init(params), batch, plan)
                         if plan is not None else
                         step(params, adamw_init(params), batch))
        r["metrics"] = {k: np.asarray(v, np.float32) for k, v in m.items()}
        r["params"] = _flatten(p1)
        r["mu"] = _flatten(o1.mu)
        res[(name, path)] = r
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("mla_train") / "jax_train.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               TRAIN_MARGINS=MARGINS_SOURCE, TRAIN_WIDEN=WIDEN_TOPK_SOURCE,
               TRAIN_VARIANT=inspect.getsource(variant),
               TRAIN_NAMES=repr(NAMES), TRAIN_ARCH=ARCH,
               TRAIN_SHAPE=repr((B, S, LR, R)))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB),
                           str(out)], capture_output=True, text=True,
                          timeout=900, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _rt(path):
    return Runtime(ep=True, ep_ranks=R) if path == "ep" else Runtime()


def _as_jax_tree(model, per_param):
    """{port name: tensor} -> the JAX tree layout (through the bridge's
    optimizer-state path, which maps every parameter)."""
    state = AdamWState(torch.zeros((), dtype=torch.int32), per_param,
                       per_param)
    return opt_state_to_jax(state, model).mu


def _port(name):
    _, cfg = cfgs(name)
    tree = _tree(name)
    return cfg, tree, params_from_jax(tree, cfg, device="cpu", trainable=True)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("name", NAMES)
def test_gradients_match_jax_leaf_by_leaf(jax_ref, name, path):
    ref = jax_ref[(name, path)]
    cfg, _, model = _port(name)
    batch = {k: torch.tensor(v) for k, v in _batch(cfg).items()}
    ops.reset_launches()
    loss, metrics = make_loss_fn(cfg, _rt(path))(model, batch)
    loss.backward()
    assert sum(ops.LAUNCHES.values()) == 0       # the CPU runs plain versions
    assert loss.item() == pytest.approx(ref["grad_loss"], rel=REL)
    np.testing.assert_array_equal(metrics["expert_counts"].numpy(),
                                  ref["expert_counts"])
    if path == "ep":
        np.testing.assert_array_equal(metrics["dropped"].numpy(),
                                      ref["dropped"])
    params = dict(model.named_parameters())
    grads = ckpt.flatten(_as_jax_tree(model, {
        n: p.grad if p.grad is not None else torch.zeros_like(p)
        for n, p in params.items()}))
    assert grads.keys() == ref["grads"].keys()
    assert MLA_LEAVES | SHARED_LEAVES <= grads.keys()
    for key, w in ref["grads"].items():
        assert _rel(grads[key], w) <= GRAD_REL, key
        assert np.abs(grads[key]).max() > 0, key       # nothing detached


@pytest.mark.parametrize("name", NAMES)
def test_weight_decay_mask_is_the_jax_rule(name):
    _, tree, model = _port(name)
    mask = weight_decay_mask(model)
    got = ckpt.flatten(_as_jax_tree(model, {
        n: torch.full_like(p, float(mask[n]))
        for n, p in model.named_parameters()}))
    want = {k: np.full(a.shape, a.ndim >= 2, np.float32)
            for k, a in jckpt._flatten(tree).items()}
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert all(mask[f"layers.0.{n}"] for n in ("w_dkv", "w_q",
                                              "shared_w_gate"))


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_jax(jax_ref, name, path):
    ref = jax_ref[(name, path)]
    cfg, _, model = _port(name)
    opt, m = make_train_step(cfg, _rt(path), lr_fn=lambda s: LR)(
        model, init_opt_state(model), _batch(cfg))
    want = ref["metrics"]
    assert set(m) == set(want) | ({"dropped"} if path == "ep" else set())
    for k in ("loss", "nll", "grad_norm", "aux_loss"):
        assert float(m[k]) == pytest.approx(float(want[k]), rel=REL), k
    assert abs(float(m["accuracy"]) - float(want["accuracy"])) <= 1 / (B * S)
    np.testing.assert_array_equal(m["expert_counts"].numpy(),
                                  want["expert_counts"])
    params = ckpt.flatten(params_to_jax(model))
    assert params.keys() == ref["params"].keys()
    for key, w in ref["params"].items():
        d = np.abs(params[key] - w)
        assert d.max() <= 2 * LR + 1e-6, (key, float(d.max()))
        assert (d > LR / 10).mean() <= 0.02, key
    mu = ckpt.flatten(opt_state_to_jax(opt, model).mu)
    for key, w in ref["mu"].items():
        assert _rel(mu[key], w) <= MU_REL, key


def test_checkpoints_cross_both_ways(tmp_path):
    cfg, tree, model = _port("router")
    opt, _ = make_train_step(cfg, Runtime(), lr_fn=lambda s: LR)(
        model, init_opt_state(model), _batch(cfg))
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
    assert {f"params/{k}" for k in MLA_LEAVES | SHARED_LEAVES} <= got.keys()
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


@pytest.mark.parametrize("mesh", [[], ["--data-mesh", "1", "--model-mesh",
                                       "4"]], ids=["dense", "ep"])
def test_launch_train_trains_deepseek_on_the_cpu(mesh):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = launch_train.main(["--arch", ARCH, "--reduced", "--device",
                                "cpu", "--steps", "30", "--batch", "2",
                                "--seq", "32", "--log-every", "10"] + mesh)
    text = out.getvalue()
    assert rc == 0, text                       # the last loss below the first
    assert "arch=deepseek-v2-lite-16b-smoke" in text
    assert "done: 30 steps" in text
