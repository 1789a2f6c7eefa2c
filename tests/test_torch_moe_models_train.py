"""One train step of the paper's other MoE models in the PyTorch port
against the JAX package's, on the CPU.

``llama-moe-3.5b``, ``switch-base-128`` (relu experts, top-1) and
``arctic-480b`` (its dense residual branch) at ``reduced()``, from the JAX
init's fp32 weights with wide router and ``lm_head`` margins
(``tests/_torch_margins.py``), bridged into a trainable port model, and
one numpy batch. Two steps each: the single-device MoE path
(``Runtime()``) and the EP dispatch over 4 ranks under the identity plan
(the meshed JAX step: ``Runtime(mesh, ep=True, ep_ranks=4,
use_duplication=False)`` on a ``(1, 4)`` ``AxisType.Auto`` mesh). The JAX
steps run jitted in one subprocess with four host devices and without
XLA's excess precision.

Tolerances are ``tests/test_torch_train.py``'s, with its reasons: loss,
nll, aux loss and gradient norm 1e-3 relative; every gradient leaf (the
dense branch's among them) 3e-2 relative in norm; parameters after one
AdamW step within 2 lr (at most 2% of a leaf's elements beyond lr / 10);
first moments 3e-2 relative in norm; expert counts and (EP) per-layer
drops equal. A relu model's experts hold a ``w_gate`` that the forward
never reads: its gradient is exactly zero in both packages, and AdamW
still decays it (``p (1 - lr wd)``, as the JAX step does).
"""

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

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models.transformer import init_model as jax_init_model  # noqa: E402
from repro_torch.bridge import (opt_state_to_jax, params_from_jax,  # noqa: E402
                                params_to_jax)
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.transformer import Runtime  # noqa: E402
from repro_torch.optim.adamw import AdamWState  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.steps import (init_opt_state, make_loss_fn,  # noqa: E402
                                     make_train_step)

from tests._torch_margins import SOURCE as MARGINS_SOURCE  # noqa: E402
from tests._torch_margins import widen_margins  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("llama-moe-3.5b", "switch-base-128", "arctic-480b")
PATHS = ("dense", "ep")
R, B, S, LR, WD = 4, 4, 16, 1e-3, 0.1
REL, GRAD_REL, MU_REL = 1e-3, 3e-2, 3e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    n = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / max(n, 1e-30))


def _tree(arch):
    jcfg = jax_get_config(arch).reduced()
    tree = widen_margins(jax.tree.map(np.asarray, jax_init_model(
        jax.random.PRNGKey(0), jcfg)), jcfg)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _batch(cfg):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


SUB = '''
import os, pickle, sys
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
B, S, LR, R = eval(os.environ["TRAIN_SHAPE"])
mesh = jax.make_mesh((1, R), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
res = {}
for arch in eval(os.environ["TRAIN_ARCHS"]):
    cfg = get_config(arch).reduced()
    tree = widen_margins(jax.tree.map(np.asarray, init_model(
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
        res[(arch, path)] = r
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("moe_models_train") / "jax_train.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               TRAIN_MARGINS=MARGINS_SOURCE, TRAIN_ARCHS=repr(ARCHS),
               TRAIN_SHAPE=repr((B, S, LR, R)))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB),
                           str(out)], capture_output=True, text=True,
                          timeout=900, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _rt(path):
    return Runtime(ep=True, ep_ranks=R) if path == "ep" else Runtime()


def _grads(model):
    params = dict(model.named_parameters())
    g = {n: p.grad if p.grad is not None else torch.zeros_like(p)
         for n, p in params.items()}
    return ckpt.flatten(opt_state_to_jax(
        AdamWState(torch.zeros((), dtype=torch.int32), g, g), model).mu)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_leaf_by_leaf(jax_ref, arch, path):
    ref = jax_ref[(arch, path)]
    cfg = get_config(arch).reduced()
    model = params_from_jax(_tree(arch), cfg, device="cpu", trainable=True)
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
    grads = _grads(model)
    assert grads.keys() == ref["grads"].keys()
    unused = {"layers/moe/experts/w_gate"} if cfg.activation == "relu" else set()
    for key, w in ref["grads"].items():
        if key in unused:
            assert not np.abs(w).any() and not np.abs(grads[key]).any(), key
            continue
        assert _rel(grads[key], w) <= GRAD_REL, key
        assert np.abs(grads[key]).max() > 0, key       # nothing detached
    if cfg.moe.dense_residual:
        assert {k for k in grads if "/dense/" in k} == {
            f"layers/moe/dense/{n}" for n in ("w_gate", "w_up", "w_down")}


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(jax_ref, arch, path):
    ref = jax_ref[(arch, path)]
    cfg = get_config(arch).reduced()
    tree = _tree(arch)
    model = params_from_jax(tree, cfg, device="cpu", trainable=True)
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
    for key, w in ref["params"].items():
        d = np.abs(params[key] - w)
        assert d.max() <= 2 * LR + 1e-6, (key, float(d.max()))
        assert (d > LR / 10).mean() <= 0.02, key
    mu = ckpt.flatten(opt_state_to_jax(opt, model).mu)
    for key, w in ref["mu"].items():
        if np.abs(w).any():
            assert _rel(mu[key], w) <= MU_REL, key
        else:
            assert not np.abs(mu[key]).any(), key
    if cfg.activation == "relu":
        # the unused w_gate: no gradient, decayed all the same
        key = "layers/moe/experts/w_gate"
        before = ckpt.flatten(tree)[key]
        np.testing.assert_allclose(params[key], before * (1 - LR * WD),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(params[key], ref["params"][key],
                                   rtol=1e-6, atol=0)
