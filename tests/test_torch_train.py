"""Training in the PyTorch port against the JAX package: the train-mode
forward, ``lm_loss``, the in-place AdamW, ``make_train_step`` (plain,
``remat``, microbatches), checkpoints in both directions and
``launch.train``, on reduced Mixtral (widened router and ``lm_head``
margins, ``tests/_torch_margins.py``, so that no route sits near a tie)
and reduced RecurrentGemma, from the same (bridged) fp32 weights and the
same numpy batch.

The JAX oracle runs jitted in a subprocess without XLA's excess precision
(``--xla_allow_excess_precision=false``), so it rounds bf16 where the port
does (ROADMAP, "Rules for every port PR"); ``jax.disable_jit()`` gives the
same numbers ten times slower. Tolerances, each with its reason:

* train-mode logits: within 2 bf16 ulps of the largest JAX logit
  (``_scale_ulps``; observed 1-1.5): bf16 products and sums round apart in
  torch and XLA by an ulp here and there; expert counts equal (the margins
  are wide).
* loss, nll, aux and z losses, gradient norm: 1e-3 relative (the bf16
  noise of the logits, averaged over the batch); accuracy within one
  position.
* gradients, leaf by leaf: 3e-2 relative in norm. The reference
  differentiates ``x.astype(bf16) @ w.astype(bf16)`` with fp32 leaves, so
  a gradient reaches each weight as a bf16 product cast up to fp32, and
  bf16 rounds apart in the two frameworks (observed up to 1.7e-2, in the
  smallest leaves).
* first moments 3e-2 and second moments 6e-2 relative in norm (0.1 x and
  0.05 x the squared clipped gradients).
* updated parameters: within ``2 lr`` (+1e-6) of the JAX ones, as Adam's
  first step moves every element by about ``lr`` along the sign of its
  gradient, and a gradient near zero can have the other sign; at most 2%
  of a leaf's elements may differ by more than ``lr / 10``.
* ``remat`` against the plain step: bit for bit (the same operations run
  again). Microbatches against the plain step: the loss 1e-5 relative for
  Griffin (mean of equal halves' means); 1e-3 for Mixtral, whose aux loss
  is not linear in the batch (the JAX step has the same difference), and
  the parameters at the step tolerance above. The port's 4 microbatches
  against the JAX step's 4 at the step tolerances.
* in-place AdamW against the functional one: bit for bit.
* checkpoints: every leaf bit for bit across the packages; a step
  continued from a restored state equals the uninterrupted step bit for
  bit in the port, and the other package's step at the step tolerances.
"""

import dataclasses
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
from repro.models.transformer import Runtime as JaxRuntime  # noqa: E402
from repro.models.transformer import init_model as jax_init_model  # noqa: E402
from repro.optim.adamw import AdamWState as JaxAdamWState  # noqa: E402
from repro.optim.adamw import adamw_init as jax_adamw_init  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro.train.loss import lm_loss as jax_lm_loss  # noqa: E402
from repro.train.steps import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.bridge import (opt_state_from_jax,  # noqa: E402
                                opt_state_to_jax, params_from_jax,
                                params_to_jax)
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.transformer import (Runtime, forward,  # noqa: E402
                                            init_model)
from repro_torch.optim import schedules  # noqa: E402
from repro_torch.optim.adamw import (AdamWState, adamw_init,  # noqa: E402
                                     adamw_update, adamw_update_)
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.loss import lm_loss  # noqa: E402
from repro_torch.train.steps import (init_opt_state,  # noqa: E402
                                     make_loss_fn, make_train_step)

from tests._torch_margins import SOURCE as MARGINS_SOURCE  # noqa: E402
from tests._torch_margins import widen_margins  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["mixtral-8x7b", "recurrentgemma-2b"]
LR = 1e-3
B, S = 4, 16
REL = 1e-3
GRAD_REL, MU_REL, NU_REL = 3e-2, 3e-2, 6e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced models' operations are tiny: one intra-op thread runs
    them as fast as many, and keeps this file from oversubscribing the
    cores when test workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _jax_tree(arch):
    jcfg = jax_get_config(arch).reduced()
    tree = jax.tree.map(np.asarray, jax_init_model(jax.random.PRNGKey(0),
                                                   jcfg))
    if jcfg.is_moe:
        tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                            widen_margins(tree, jcfg))
    return jcfg, tree


def _port(arch):
    """(cfg, trainable port model, its fresh AdamW state) from the JAX
    init's weights."""
    cfg = get_config(arch).reduced()
    model = params_from_jax(_jax_tree(arch)[1], cfg, device="cpu",
                            trainable=True)
    return cfg, model, init_opt_state(model)


def _flat(tree):
    return ckpt.flatten(tree)


def _rel(got, want):
    n = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / max(n, 1e-30))


def _scale_ulps(got, want):
    """max |got - want| in bf16 ulps of the largest |want|."""
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    return float(np.abs(got - want).max() / ulp)


def _assert_params_close(got, want, lr=LR):
    for key, w in want.items():
        d = np.abs(got[key] - w)
        assert d.max() <= 2 * lr + 1e-6, (key, float(d.max()))
        assert (d > lr / 10).mean() <= 0.02, (key, float((d > lr / 10).mean()))


# ---------------------------------------------------------------------------
# the JAX oracle, jitted without excess precision in a subprocess
# ---------------------------------------------------------------------------

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

exec(os.environ["TRAIN_MARGINS"])
B, S, LR = eval(os.environ["TRAIN_SHAPE"])
res = {}
for arch in eval(os.environ["TRAIN_ARCHS"]):
    cfg = get_config(arch).reduced()
    tree = jax.tree.map(np.asarray, init_model(jax.random.PRNGKey(0), cfg))
    if cfg.is_moe:
        tree = widen_margins(tree, cfg)
    params = jax.tree.map(jnp.asarray, tree)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    batch = {"tokens": jnp.asarray(toks[:, :-1]),
             "labels": jnp.asarray(toks[:, 1:])}
    rt = Runtime()
    r = {}
    logits, _, stats = jax.jit(lambda p: forward(p, cfg, batch, rt,
                                                 mode="train"))(params)
    r["logits"] = np.asarray(logits, np.float32)
    if cfg.is_moe:
        r["expert_counts"] = np.asarray(stats["expert_counts"])
        r["aux_loss"] = float(stats["aux_loss"])
        r["z_loss"] = float(stats["z_loss"])

    def loss_fn(p):
        logits, _, stats = forward(p, cfg, batch, rt, mode="train")
        loss, _ = lm_loss(logits, batch["labels"])
        if cfg.is_moe:
            loss = loss + stats["aux_loss"] + stats["z_loss"]
        return loss
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    r["grad_loss"] = float(loss)
    r["grads"] = _flatten(grads)
    for name, mb in (("step", 1), ("mb4", 4)):
        step = jax.jit(make_train_step(cfg, rt, lr_fn=lambda s: LR,
                                       microbatches=mb))
        p1, o1, m = step(params, adamw_init(params), batch)
        r[name] = {"metrics": {k: np.asarray(v, np.float32)
                               for k, v in m.items()},
                   "params": _flatten(p1), "mu": _flatten(o1.mu),
                   "nu": _flatten(o1.nu), "step": int(o1.step)}
    res[arch] = r
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("train") / "jax_train.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               TRAIN_MARGINS=MARGINS_SOURCE, TRAIN_ARCHS=repr(ARCHS),
               TRAIN_SHAPE=repr((B, S, LR)))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB),
                           str(out)], capture_output=True, text=True,
                          timeout=900, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def port_steps():
    """One plain, one ``remat`` and one 4-microbatch port step of each
    arch from the same weights: {arch: {variant: (metrics, params tree,
    state)}}."""
    out = {}
    for arch in ARCHS:
        out[arch] = {}
        for name, kw in (("step", {}), ("remat", dict(remat=True)),
                         ("mb4", dict(microbatches=4))):
            cfg, model, opt = _port(arch)
            step = make_train_step(cfg, Runtime(), lr_fn=lambda s: LR, **kw)
            opt, m = step(model, opt, _batch(cfg))
            out[arch][name] = (m, _flat(params_to_jax(model)),
                               opt_state_to_jax(opt, model))
    return out


# ---------------------------------------------------------------------------
# model, loss and optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_trainable_init_is_fp32_and_serving_stays_bf16(arch):
    cfg = get_config(arch).reduced()
    gen = torch.Generator().manual_seed(0)
    model = init_model(cfg, gen, device="cpu", trainable=True)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in model.parameters())
    serving = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert not any(p.requires_grad for p in serving.parameters())
    assert serving.embed.dtype == torch.bfloat16
    # the same names and shapes, so the bridge and the optimizer see one tree
    assert [(n, p.shape) for n, p in model.named_parameters()] == \
        [(n, p.shape) for n, p in serving.named_parameters()]


@pytest.mark.parametrize("arch", ARCHS)
def test_trainable_bridge_and_opt_state_round_trip_exactly(arch):
    cfg, model, _ = _port(arch)
    _, tree = _jax_tree(arch)
    back = _flat(params_to_jax(model))
    for key, leaf in _flat(tree).items():
        np.testing.assert_array_equal(back[key], leaf)
    rng = np.random.default_rng(1)
    mu = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                      tree)
    nu = jax.tree.map(lambda a: rng.random(size=a.shape).astype(np.float32),
                      tree)
    state = opt_state_from_jax(JaxAdamWState(jnp.asarray(7, jnp.int32), mu,
                                             nu), model)
    assert int(state.step) == 7 and state.step.dtype == torch.int32
    assert set(state.mu) == {n for n, _ in model.named_parameters()}
    again = opt_state_to_jax(state, model)
    assert int(again.step) == 7
    for a, b in ((again.mu, mu), (again.nu, nu)):
        fa, fb = _flat(a), _flat(b)
        assert fa.keys() == fb.keys()
        for key in fb:
            np.testing.assert_array_equal(fa[key], fb[key])


@pytest.mark.parametrize("case", ["plain", "mask", "negative_labels",
                                  "out_of_range_labels"])
def test_lm_loss_matches_jax(case):
    rng = np.random.default_rng(3)
    Bq, Sq, V = 3, 7, 50
    logits = (rng.normal(size=(Bq, Sq, V)) * 3).astype(np.float32)
    labels = rng.integers(0, V, (Bq, Sq)).astype(np.int32)
    mask = None
    logits[0, 0] = logits[0, 0, labels[0, 0]]        # a tied argmax
    if case == "mask":
        mask = (rng.random((Bq, Sq)) > 0.4).astype(np.float32)
    elif case == "negative_labels":
        labels[:, ::2] = -1
    elif case == "out_of_range_labels":
        labels[1] = V + 3
        labels[2, :3] = V
    jl, jm = jax_lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                         None if mask is None else jnp.asarray(mask))
    jg = jax.grad(lambda x: jax_lm_loss(
        x, jnp.asarray(labels),
        None if mask is None else jnp.asarray(mask))[0])(jnp.asarray(logits))
    tlog = torch.tensor(logits, requires_grad=True)
    tl, tm = lm_loss(tlog, torch.tensor(labels),
                     None if mask is None else torch.tensor(mask))
    tl.backward()
    assert tl.item() == pytest.approx(float(jl), rel=1e-6)
    assert tm["nll"].item() == pytest.approx(float(jm["nll"]), rel=1e-6)
    assert tm["accuracy"].item() == pytest.approx(float(jm["accuracy"]),
                                                  abs=1e-7)
    np.testing.assert_allclose(tlog.grad.numpy(), np.asarray(jg),
                               rtol=1e-5, atol=1e-7)


def test_lm_loss_takes_the_gold_logit_without_a_one_hot():
    """A label outside [0, V) scores a gold logit of 0, as the reference's
    all-zero one-hot does."""
    logits = torch.tensor([[[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]])
    labels = torch.tensor([[5, -2]])
    loss, m = lm_loss(logits, labels)
    logz = torch.logsumexp(logits, -1)
    assert loss.item() == pytest.approx(float(logz.mean()), rel=1e-7)
    assert m["accuracy"].item() == 0.0


@pytest.mark.parametrize("lr_kind", ["float", "tensor"])
@pytest.mark.parametrize("clip", [True, False], ids=["clipped", "unclipped"])
def test_adamw_update_in_place_equals_functional_bit_for_bit(lr_kind, clip):
    rng = np.random.default_rng(11)
    shapes = {"b": {"w": (5, 3), "scale": (3,)}, "a": (4, 2, 6), "c": (7,)}

    def tree(fn, node=shapes):
        return ({k: tree(fn, v) for k, v in node.items()}
                if isinstance(node, dict) else fn(node))
    params = tree(lambda s: torch.tensor(rng.normal(size=s), dtype=torch.float32))
    ref_p = tree(lambda s: None)
    ref_p = {"b": {"w": params["b"]["w"].clone(),
                   "scale": params["b"]["scale"].clone()},
             "a": params["a"].clone(), "c": params["c"].clone()}
    scale = 1.0 if clip else 1e-3
    st_ref, st = adamw_init(ref_p), adamw_init(params)
    for i in range(4):
        grads = tree(lambda s: torch.tensor(rng.normal(size=s) * scale,
                                            dtype=torch.float32))
        lr = (schedules.cosine_schedule(1e-2, 2, 10)(st.step)
              if lr_kind == "tensor" else 3e-3)
        g_copy = {"b": {k: v.clone() for k, v in grads["b"].items()},
                  "a": grads["a"].clone(), "c": grads["c"].clone()}
        ref_p, st_ref, gn_ref = adamw_update(ref_p, g_copy, st_ref, lr)
        st, gn = adamw_update_(params, grads, st, lr)
        assert torch.equal(gn, gn_ref) and torch.equal(st.step, st_ref.step)
        for a, b in ((params, ref_p), (st.mu, st_ref.mu), (st.nu, st_ref.nu)):
            assert torch.equal(a["a"], b["a"]) and torch.equal(a["c"], b["c"])
            assert all(torch.equal(a["b"][k], b["b"][k]) for k in a["b"])
    assert (gn > 1.0) == clip


@pytest.mark.parametrize("arch", ARCHS)
def test_train_forward_matches_jax(arch, jax_ref):
    cfg, model, _ = _port(arch)
    ref = jax_ref[arch]
    with torch.no_grad():
        logits, cache, stats = forward(model, cfg,
                                       torch.tensor(_batch(cfg)["tokens"]),
                                       Runtime(), mode="train")
    assert cache is None and logits.shape == (B, S, cfg.vocab_size)
    assert _scale_ulps(logits.float().numpy(), ref["logits"]) <= 2
    if cfg.is_moe:
        np.testing.assert_array_equal(stats["expert_counts"].numpy(),
                                      ref["expert_counts"])
        assert stats["aux_loss"].item() == pytest.approx(ref["aux_loss"],
                                                         rel=REL)
        assert stats["z_loss"].item() == pytest.approx(ref["z_loss"], rel=REL)


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients_match_jax_leaf_by_leaf(arch, jax_ref):
    cfg, model, _ = _port(arch)
    loss, _ = make_loss_fn(cfg, Runtime())(model, {
        k: torch.tensor(v) for k, v in _batch(cfg).items()})
    loss.backward()
    assert loss.item() == pytest.approx(jax_ref[arch]["grad_loss"], rel=REL)
    params = dict(model.named_parameters())
    grads = _flat(opt_state_to_jax(
        AdamWState(torch.zeros((), dtype=torch.int32),
                   {n: p.grad for n, p in params.items()},
                   {n: p.grad for n, p in params.items()}), model).mu)
    want = jax_ref[arch]["grads"]
    assert grads.keys() == want.keys()
    for key, w in want.items():
        assert _rel(grads[key], w) <= GRAD_REL, key


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, jax_ref, port_steps):
    m, params, opt = port_steps[arch]["step"]
    ref = jax_ref[arch]["step"]
    want = ref["metrics"]
    assert set(m) == set(want)
    for k in ("loss", "nll", "grad_norm") + (("aux_loss",)
                                             if "aux_loss" in want else ()):
        assert float(m[k]) == pytest.approx(float(want[k]), rel=REL), k
    assert float(m["lr"]) == pytest.approx(float(want["lr"]), rel=1e-7)
    assert abs(float(m["accuracy"]) - float(want["accuracy"])) <= 1 / (B * S)
    if "expert_counts" in want:
        np.testing.assert_array_equal(m["expert_counts"].numpy(),
                                      want["expert_counts"])
    assert int(opt.step) == ref["step"] == 1
    _assert_params_close(params, ref["params"])
    for name, tol in (("mu", MU_REL), ("nu", NU_REL)):
        got = _flat(getattr(opt, name))
        for key, w in ref[name].items():
            assert _rel(got[key], w) <= tol, (name, key)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_and_microbatches_match_the_plain_step(arch, jax_ref,
                                                     port_steps):
    plain_m, plain_p, plain_o = port_steps[arch]["step"]
    remat_m, remat_p, remat_o = port_steps[arch]["remat"]
    assert torch.equal(remat_m["loss"], plain_m["loss"])
    for key in plain_p:
        np.testing.assert_array_equal(remat_p[key], plain_p[key])
    for a, b in ((remat_o.mu, plain_o.mu), (remat_o.nu, plain_o.nu)):
        fa, fb = _flat(a), _flat(b)
        assert all(np.array_equal(fa[k], fb[k]) for k in fb)
    mb_m, mb_p, mb_o = port_steps[arch]["mb4"]
    rel = 1e-3 if get_config(arch).is_moe else 1e-5
    assert float(mb_m["loss"]) == pytest.approx(float(plain_m["loss"]),
                                                rel=rel)
    assert float(mb_m["nll"]) == pytest.approx(float(plain_m["nll"]),
                                               rel=1e-5)
    _assert_params_close(mb_p, plain_p)
    ref = jax_ref[arch]["mb4"]
    for k in ("loss", "nll", "grad_norm"):
        assert float(mb_m[k]) == pytest.approx(float(ref["metrics"][k]),
                                               rel=REL), k
    _assert_params_close(mb_p, ref["params"])
    got = _flat(mb_o.mu)
    for key, w in ref["mu"].items():
        assert _rel(got[key], w) <= MU_REL, key


def test_remat_recomputes_each_layer_in_the_backward(monkeypatch):
    """Under ``remat`` every layer's router runs twice (forward, then the
    backward's recompute), its backward once."""
    cfg, model, opt = _port("mixtral-8x7b")
    calls = []
    real = ops.FusedTopkRoute.apply
    monkeypatch.setattr(ops.FusedTopkRoute, "apply",
                        lambda *a: calls.append(1) or real(*a))
    make_train_step(cfg, Runtime(), remat=True)(model, opt, _batch(cfg))
    assert len(calls) == 2 * cfg.num_layers


def test_train_step_rejects_the_ep_path():
    """The name dates from before EP training: the EP path now trains (one
    step of reduced Mixtral over 4 EP ranks, its loss and gradient norm
    finite, every parameter moved by AdamW, the layers' drops reported);
    the EP forward still refuses what the JAX train step takes none of,
    and a batch that does not split into the microbatches raises."""
    cfg = get_config("mixtral-8x7b").reduced()
    rt = Runtime(ep=True, ep_ranks=4)
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu",
                       trainable=True)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt, m = make_train_step(cfg, rt, lr_fn=lambda s: LR)(
        model, init_opt_state(model), _batch(cfg))
    assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
    assert m["dropped"].shape == (cfg.num_layers,) and int(opt.step) == 1
    for n, p in model.named_parameters():
        assert not torch.equal(p, before[n]), n
    with pytest.raises(ValueError, match="EP training takes a plan only"):
        forward(model, cfg, torch.zeros((1, 8), dtype=torch.long), rt,
                mode="train", resched=torch.zeros((2, 4, 4),
                                                  dtype=torch.int32))
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, Runtime(), microbatches=3)(
            model, init_opt_state(model), _batch(cfg))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _jax_step(jcfg):
    return jax.jit(jax_make_train_step(jcfg, JaxRuntime(),
                                       lr_fn=lambda s: LR))


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_written_by_the_port_restores_in_jax(arch, tmp_path):
    cfg, model, opt = _port(arch)
    step = make_train_step(cfg, Runtime(), lr_fn=lambda s: LR)
    opt, _ = step(model, opt, _batch(cfg, 0))
    path = str(tmp_path / "port.npz")
    ckpt.save(path, {"params": params_to_jax(model),
                     "opt": opt_state_to_jax(opt, model)})
    jcfg, tree = _jax_tree(arch)
    jparams = jax.tree.map(jnp.asarray, tree)
    restored = jckpt.restore_like({"params": jparams,
                                   "opt": jax_adamw_init(jparams)},
                                  jckpt.load(path))
    assert isinstance(restored["opt"], JaxAdamWState)
    assert int(restored["opt"].step) == 1
    for got, want in ((restored["params"], params_to_jax(model)),
                      (restored["opt"].mu, opt_state_to_jax(opt, model).mu)):
        fg, fw = _flat(got), _flat(want)
        assert fg.keys() == fw.keys()
        for key in fw:
            np.testing.assert_array_equal(fg[key], fw[key])
    # both packages continue from the one state
    batch = _batch(cfg, 1)
    p2, o2, jm = _jax_step(jcfg)(restored["params"], restored["opt"],
                                 {k: jnp.asarray(v) for k, v in batch.items()})
    opt, m = step(model, opt, batch)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=REL)
    assert int(o2.step) == int(opt.step) == 2
    _assert_params_close(_flat(params_to_jax(model)), _flat(p2))


@pytest.mark.parametrize("arch", ARCHS)
def test_checkpoint_written_by_jax_restores_in_the_port(arch, tmp_path):
    jcfg, tree = _jax_tree(arch)
    jparams = jax.tree.map(jnp.asarray, tree)
    jstep = _jax_step(jcfg)
    cfg = get_config(arch).reduced()
    b0, b1 = ({k: jnp.asarray(v) for k, v in _batch(cfg, s).items()}
              for s in (0, 1))
    p1, o1, _ = jstep(jparams, jax_adamw_init(jparams), b0)
    path = str(tmp_path / "jax.npz")
    jckpt.save(path, {"params": p1, "opt": o1})
    loaded = ckpt.load(path)
    model = params_from_jax(loaded["params"], cfg, device="cpu",
                            trainable=True)
    opt = opt_state_from_jax(loaded["opt"], model)
    assert int(opt.step) == 1
    for got, want in ((params_to_jax(model), p1),
                      (opt_state_to_jax(opt, model).nu, o1.nu)):
        fg, fw = _flat(got), _flat(jax.tree.map(np.asarray, want))
        for key in fw:
            np.testing.assert_array_equal(fg[key], fw[key])
    # the port's restore_like over a template of its own trees
    template = {"params": params_to_jax(model),
                "opt": opt_state_to_jax(init_opt_state(model), model)}
    again = ckpt.restore_like(template, loaded)
    assert isinstance(again["opt"], AdamWState) and int(again["opt"].step) == 1
    np.testing.assert_array_equal(again["params"]["lm_head"]["w"],
                                  np.asarray(p1["lm_head"]["w"]))
    p2, _, jm = jstep(p1, o1, b1)
    opt, m = make_train_step(cfg, Runtime(), lr_fn=lambda s: LR)(
        model, opt, b1)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=REL)
    _assert_params_close(_flat(params_to_jax(model)),
                         _flat(jax.tree.map(np.asarray, p2)))


def test_training_resumed_from_a_checkpoint_is_bit_exact(tmp_path):
    cfg, model, opt = _port("mixtral-8x7b")
    step = make_train_step(cfg, Runtime(), lr_fn=lambda s: LR)
    opt, _ = step(model, opt, _batch(cfg, 0))
    path = str(tmp_path / "mid.npz")
    ckpt.save(path, {"params": params_to_jax(model),
                     "opt": opt_state_to_jax(opt, model)})
    opt, m = step(model, opt, _batch(cfg, 1))
    loaded = ckpt.load(path)
    resumed = params_from_jax(loaded["params"], cfg, device="cpu",
                              trainable=True)
    ropt = opt_state_from_jax(loaded["opt"], resumed)
    ropt, rm = step(resumed, ropt, _batch(cfg, 1))
    assert torch.equal(rm["loss"], m["loss"])
    for (n, a), (_, b) in zip(model.named_parameters(),
                              resumed.named_parameters()):
        assert torch.equal(a, b), n
    assert all(torch.equal(ropt.nu[n], opt.nu[n]) for n in opt.nu)


def test_checkpoint_keys_follow_the_jax_layout(tmp_path):
    tree = {"a": [np.zeros(2), {"b": np.ones(3)}],
            "opt": AdamWState(np.asarray(3), {"w": np.ones(1)},
                              {"w": np.zeros(1)})}
    assert set(ckpt.flatten(tree)) == set(jckpt._flatten(
        {"a": tree["a"], "opt": JaxAdamWState(*tree["opt"])}))
    path = str(tmp_path / "t.npz")
    ckpt.save(path, tree)
    back = ckpt.load(path)
    assert isinstance(back["a"], list) and back["opt"]["step"] == 3
    with pytest.raises(KeyError, match="missing leaf"):
        ckpt.restore_like({"zz": np.zeros(1)}, back)


# ---------------------------------------------------------------------------
# launch.train
# ---------------------------------------------------------------------------

STEP_LINE = re.compile(r"^step +\d+ loss=\d+\.\d{4} lr=\S+ gnorm=\d+\.\d{2}"
                       r"( skew=\d+\.\d{2})?$")


@pytest.mark.parametrize("arch", ARCHS)
def test_launch_train_runs_on_the_cpu(arch, tmp_path, capsys):
    path = str(tmp_path / "ck.npz")
    rc = launch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                            "--steps", "12", "--batch", "4", "--seq", "32",
                            "--log-every", "4", "--ckpt", path])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    cfg = get_config(arch).reduced()
    assert out[0].startswith(f"arch={cfg.name} params=")
    steps = [ln for ln in out if ln.startswith("step")]
    assert len(steps) == 4 and all(STEP_LINE.match(ln) for ln in steps)
    assert ("skew=" in steps[0]) == cfg.is_moe
    assert out[-2].startswith("done: 12 steps in ")
    assert out[-1] == f"checkpoint saved to {path}"
    # the checkpoint restores in the JAX package
    jcfg, tree = _jax_tree(arch)
    jparams = jax.tree.map(jnp.asarray, tree)
    restored = jckpt.restore_like({"params": jparams,
                                   "opt": jax_adamw_init(jparams)},
                                  jckpt.load(path))
    assert int(restored["opt"].step) == 12


def test_launch_train_prints_the_jax_launchers_lines(capsys):
    argv = ["--arch", "mixtral-8x7b", "--reduced", "--steps", "3",
            "--batch", "2", "--seq", "16", "--log-every", "1"]
    assert jax_launch_train.main(argv) in (0, 1)
    want = capsys.readouterr().out.splitlines()
    assert launch_train.main(argv + ["--device", "cpu"]) in (0, 1)
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert re.sub(r"[\d.e+-]+", "#", g) == re.sub(r"[\d.e+-]+", "#", w)


@pytest.mark.parametrize("argv,err", [
    (["--arch", "mixtral-8x7b", "--data-mesh", "1", "--model-mesh", "3"],
     ValueError),
    (["--arch", "recurrentgemma-2b", "--data-mesh", "2", "--model-mesh", "2"],
     ValueError),
    (["--arch", "llava-next-34b"], None)])
def test_launch_train_rejects_what_the_port_cannot_train(argv, err):
    argv = argv + ["--reduced", "--device", "cpu", "--steps", "1"]
    if err is None:
        # llava-next-34b is ported: it trains (one step returns 1, as a
        # loss cannot fall over one step)
        assert launch_train.main(argv + ["--batch", "2", "--seq", "16"]) == 1
        return
    with pytest.raises(err):
        launch_train.main(argv)


def test_build_lr_fn_calls_the_wsd_schedule_as_defined():
    """The port's WSD branch runs; the JAX launcher's passes ``stable=``
    to a ``wsd_schedule`` without that parameter and raises (a reference
    fault, ROADMAP section 3)."""
    cfg = dataclasses.replace(get_config("mixtral-8x7b"), lr_schedule="wsd")
    lr = launch_train.build_lr_fn(cfg, 1e-3, 100)
    want = schedules.wsd_schedule(1e-3, warmup=10, total=100)
    for s in (0, 5, 50, 95):
        assert torch.equal(lr(s), want(s))
    jcfg = dataclasses.replace(jax_get_config("mixtral-8x7b"),
                               lr_schedule="wsd")
    with pytest.raises(TypeError, match="stable"):
        jax_launch_train.build_lr_fn(jcfg, 1e-3, 100)
    cos = launch_train.build_lr_fn(get_config("mixtral-8x7b"), 1e-3, 100)
    jcos = jax_launch_train.build_lr_fn(jax_get_config("mixtral-8x7b"), 1e-3,
                                        100)
    for s in (0, 9, 10, 60, 99):
        assert float(cos(s)) == pytest.approx(float(jcos(s)), rel=1e-6)
