"""Expert-parallel training in the PyTorch port against the JAX package: the
EP dispatch's gradients, the EP train step, EP against the dense step, and
``launch.train --data-mesh 1 --model-mesh 4``.

(a) ``ep_moe_ffn``'s gradients with respect to x, the router weight and the
    three expert tensors (through the fused router's and ``moe_gemm``'s
    backward, plain versions on the CPU) against ``jax.grad`` through
    ``jax.vmap(..., axis_name="model")`` of the JAX ``ep_moe_ffn`` with
    ``use_kernel=False`` and the dense router (``jax.grad`` cannot pass the
    Pallas forward), of ``sum(y * c) + aux + z`` for a fixed numpy
    cotangent c: R in {1, 2, 4}, D in {0, 1}, the identity and (D > 0) a
    duplicated plan, capacity factors 1.0 (drops) and 8.0 (none). fp32:
    1e-5 absolute plus 1e-5 relative (the same arithmetic in another
    order). bf16: 4 bf16 ulps of the leaf's largest element and 2e-2
    relative in norm (observed up to 2.7 ulps and 1.2e-2, the router's fp32
    gradient, over seeds 7-9): the port's ``moe_gemm`` keeps ``g`` and
    ``u`` in fp32 where JAX's einsum rounds them to bf16, and the gradients
    of the bf16 products differ by an ulp here and there.
(b) One step of the port's ``make_train_step(..., Runtime(ep=True,
    ep_ranks=4))`` against the meshed JAX ``make_train_step`` (reduced
    Mixtral, ``Runtime(mesh, ep=True, ep_ranks=4, use_duplication=False)``,
    ``plan_args``; a (1, 4) ``AxisType.Auto`` mesh on four host devices in a
    subprocess without XLA's excess precision) from the same bridged fp32
    weights (``tests/_torch_margins.py``'s wide margins, so that no route
    sits near a tie) and the same numpy batch: the per-layer drops and
    expert counts equal; loss, nll, aux loss and gradient norm 1e-3
    relative; every gradient leaf 3e-2 relative in norm; parameters after
    one AdamW step within 2 lr (at most 2% of a leaf's elements beyond lr /
    10); the first moments 3e-2 relative in norm. These are
    ``tests/test_torch_train.py``'s tolerances for the dense step, with the
    same reasons (bf16 rounds apart in the two frameworks), and they cover
    ``moe_gemm``'s fp32 ``g`` and ``u``. Also ``remat`` and 2 microbatches,
    each against the JAX step of the same kind.
(c) EP against dense: at a capacity factor where nothing drops (cap >=
    T_local), the port's EP step and its single-device step from the same
    weights: loss 1e-3 relative, every gradient leaf 3e-2 relative in norm
    (the dense path's ``torch.matmul`` rounds ``g`` and ``u`` to bf16 where
    ``moe_gemm`` keeps them fp32, and combines over all experts).
(d) The launcher trains reduced Mixtral through the EP path, prints the JAX
    launcher's lines, and its checkpoint restores in the JAX package.
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

from repro.configs.base import MoEConfig as JaxMoEConfig  # noqa: E402
from repro.core.duplication import duplicate_experts_host as jax_dup  # noqa: E402
from repro.core.placement import identity_plan as jax_identity  # noqa: E402
from repro.moe import dispatch as jep  # noqa: E402
from repro.moe.router import route as jax_route  # noqa: E402
from repro.optim.adamw import adamw_init as jax_adamw_init  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.bridge import (opt_state_to_jax, params_from_jax,  # noqa: E402
                                params_to_jax)
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core.placement import (PlacementPlan, identity_plan,  # noqa: E402
                                        stack_plans, to_device)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.transformer import Runtime  # noqa: E402
from repro_torch.moe import dispatch as ep  # noqa: E402
from repro_torch.moe.router import route  # noqa: E402
from repro_torch.optim.adamw import AdamWState  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train.steps import (init_opt_state, make_loss_fn,  # noqa: E402
                                     make_train_step)

from tests._torch_margins import SOURCE as MARGINS_SOURCE  # noqa: E402
from tests._torch_margins import widen_margins  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
T, D_MODEL, F, E, K = 32, 32, 64, 8, 2
R_TRAIN, B, S, LR = 4, 4, 32, 1e-3
REL, GRAD_REL, MU_REL = 1e-3, 3e-2, 3e-2
VARIANTS = {"step": {}, "remat": dict(remat=True),
            "mb2": dict(microbatches=2)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    n = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / max(n, 1e-30))


def _assert_params_close(got, want, lr=LR):
    for key, w in want.items():
        d = np.abs(got[key] - w)
        assert d.max() <= 2 * lr + 1e-6, (key, float(d.max()))
        assert (d > lr / 10).mean() <= 0.02, (key, float((d > lr / 10).mean()))


# ---------------------------------------------------------------------------
# (a) the dispatch's gradients against jax.grad through the vmapped JAX one
# ---------------------------------------------------------------------------

def _dispatch_inputs(R, seed):
    """Tokens with a common component the router's first column follows (so
    expert 0 is hot and a capacity factor of 1.0 drops), the weights and
    the cotangent of y, as ``tests/test_torch_dispatch.py`` draws them."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(D_MODEL,))
    v /= np.linalg.norm(v)
    x = (rng.normal(size=(R, T, D_MODEL)) + 2.0 * v).astype(np.float32)
    wr = (rng.normal(size=(D_MODEL, E)) * 0.3).astype(np.float32)
    wr[:, 0] += 1.5 * v
    w = {n: (rng.normal(size=s) * 0.1).astype(np.float32)
         for n, s in (("w_gate", (E, D_MODEL, F)), ("w_up", (E, D_MODEL, F)),
                      ("w_down", (E, F, D_MODEL)))}
    cot = rng.normal(size=(R, T, D_MODEL)).astype(np.float32)
    return x, wr, w, cot


def _plan(R, D, duplicated, seed):
    if not duplicated:
        return jax_identity(E, R, D, 4)
    rng = np.random.default_rng(seed)
    dist = rng.random(E) ** 4
    dist[rng.integers(E)] += 1.0
    return jax_dup(dist / dist.sum(), R, D, 4).plan


def _jax_dispatch_grads(R, moe, x, wr, w, cot, dtype):
    """jax.grad of sum_r sum(y_r * c_r) + aux + z through the vmapped JAX
    ``ep_moe_ffn`` (einsum FFN, dense router), with respect to x, the router
    weight and the (E, ...) expert tensors."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16

    def loss(xj, wrj, wj, plan):
        def per_rank(xb, wb, cb):
            ro = jax_route({"w": wrj}, moe, xb)
            y, st = jep.ep_moe_ffn(xb, ro, wb, plan, moe, axis_name="model",
                                   ep_ranks=R, use_kernel=False)
            return jnp.sum(y.astype(jnp.float32) * cb), st.aux_loss + st.z_loss
        w_local = {n: a.reshape(R, E // R, *a.shape[1:]) for n, a in wj.items()}
        ys, losses = jax.vmap(per_rank, axis_name="model")(
            xj, w_local, jnp.asarray(cot))
        return ys.sum() + losses.mean()
    grad = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))
    args = (jnp.asarray(x, jdt), jnp.asarray(wr),
            {n: jnp.asarray(a, jdt) for n, a in w.items()})
    return lambda plan: jax.tree.map(
        lambda a: np.asarray(a, np.float32),
        grad(*args, jax.tree.map(jnp.asarray, plan)))


def _port_dispatch_grads(R, D, moe, x, wr, w, cot, plan, dtype):
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    xt = torch.tensor(x).to(tdt).requires_grad_()
    wrt = torch.tensor(wr, requires_grad=True)
    wt = {n: torch.tensor(a).to(tdt).requires_grad_() for n, a in w.items()}
    dp = to_device(PlacementPlan(*(np.asarray(a) for a in plan)), E, R, D,
                   "cpu")
    ro = route(wrt, moe, xt)
    y, st = ep.ep_moe_ffn(xt, ro, wt, dp, moe, ep_ranks=R)
    loss = ((y.float() * torch.tensor(cot)).sum() + st.aux_loss + st.z_loss)
    gx, gr, *gw = torch.autograd.grad(loss, [xt, wrt] + [wt[n] for n in wt])
    return gx, gr, dict(zip(wt, gw)), int(st.dropped)


def _close(got, want, dtype, name):
    got = got.float().numpy()
    if dtype == "float32":
        err = np.abs(got - want)
        assert (err <= 1e-5 + 1e-5 * np.abs(want)).all(), (name,
                                                          float(err.max()))
        return
    ulp = 2.0 ** (np.floor(np.log2(max(np.abs(want).max(), 1e-30))) - 7)
    assert np.abs(got - want).max() <= 4 * ulp, (name, ulp)
    assert _rel(got, want) <= 2e-2, (name, _rel(got, want))


def _compare_dispatch(R, D, cf, dtype, seed):
    moe_kw = dict(num_experts=E, top_k=K, d_ff_expert=F, capacity_factor=cf,
                  duplication_slots=D)
    jmoe, moe = JaxMoEConfig(**moe_kw), MoEConfig(**moe_kw)
    x, wr, w, cot = _dispatch_inputs(R, seed)
    jax_fn = _jax_dispatch_grads(R, jmoe, x, wr, w, cot, dtype)
    dropped = {}
    for duplicated in ((False, True) if D else (False,)):
        plan = _plan(R, D, duplicated, seed)
        jx, jr, jw = jax_fn(plan)
        ops.reset_launches()
        gx, gr, gw, dropped[duplicated] = _port_dispatch_grads(
            R, D, moe, x, wr, w, cot, plan, dtype)
        assert not any(ops.LAUNCHES.values())   # the CPU runs plain versions
        _close(gx, jx, dtype, "x")
        _close(gr, jr, dtype, "router")
        for n in gw:
            _close(gw[n], jw[n], dtype, n)
    return dropped


@pytest.mark.parametrize("cf", [1.0, 8.0])
@pytest.mark.parametrize("D", [0, 1])
@pytest.mark.parametrize("R", [1, 2, 4])
def test_ep_dispatch_gradients_match_jax_grad_fp32(R, D, cf):
    dropped = _compare_dispatch(R, D, cf, "float32", seed=R * 10 + D)
    if cf == 1.0:
        assert dropped[False] > 0               # the hot expert overflows
    else:
        assert set(dropped.values()) == {0}


@pytest.mark.parametrize("D", [0, 1])
def test_ep_dispatch_gradients_match_jax_grad_bf16(D):
    dropped = _compare_dispatch(4, D, 1.0, "bfloat16", seed=7)
    assert dropped[False] > 0


# ---------------------------------------------------------------------------
# (b) the EP train step against the meshed JAX step
# ---------------------------------------------------------------------------

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
cfg = get_config("mixtral-8x7b").reduced()
tree = widen_margins(jax.tree.map(np.asarray,
                                  init_model(jax.random.PRNGKey(0), cfg)), cfg)
params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), tree)
toks = np.random.default_rng(0).integers(
    0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
batch = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
rt = Runtime(mesh=mesh, ep=True, ep_ranks=R, use_duplication=False)
plan = plan_args(cfg, R)
res = {}
with mesh:
    _, _, stats = jax.jit(lambda p: forward(p, cfg, batch, rt, mode="train",
                                            plan=plan))(params)
    for k in ("dropped", "expert_counts"):
        res[k] = np.asarray(stats[k])

    def loss_fn(p):
        logits, _, st = forward(p, cfg, batch, rt, mode="train", plan=plan)
        loss, _ = lm_loss(logits, batch["labels"])
        return loss + st["aux_loss"] + st["z_loss"]
    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    res["grad_loss"] = float(loss)
    res["grads"] = _flatten(grads)
    for name, kw in eval(os.environ["TRAIN_VARIANTS"]).items():
        step = jax.jit(make_train_step(cfg, rt, lr_fn=lambda s: LR, **kw))
        p1, o1, m = step(params, adamw_init(params), batch, plan)
        res[name] = {"metrics": {k: np.asarray(v, np.float32)
                                 for k, v in m.items()},
                     "params": _flatten(p1), "mu": _flatten(o1.mu)}
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
'''


def _tree():
    from repro.configs.registry import get_config as jax_get_config
    from repro.models.transformer import init_model as jax_init_model
    jcfg = jax_get_config("mixtral-8x7b").reduced()
    tree = widen_margins(jax.tree.map(np.asarray, jax_init_model(
        jax.random.PRNGKey(0), jcfg)), jcfg)
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _host_plan(cfg, R):
    m = cfg.moe
    return stack_plans([identity_plan(m.num_experts, R, 0, m.max_copies)
                        for _ in range(cfg.num_layers)])


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_ep") / "jax_train_ep.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               TRAIN_MARGINS=MARGINS_SOURCE,
               TRAIN_SHAPE=repr((B, S, LR, R_TRAIN)),
               TRAIN_VARIANTS=repr(VARIANTS))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB),
                           str(out)], capture_output=True, text=True,
                          timeout=900, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _grads(model):
    params = dict(model.named_parameters())
    return ckpt.flatten(opt_state_to_jax(
        AdamWState(torch.zeros((), dtype=torch.int32),
                   {n: p.grad for n, p in params.items()},
                   {n: p.grad for n, p in params.items()}), model).mu)


def _ep_model(cfg):
    return params_from_jax(_tree(), cfg, device="cpu", trainable=True)


@pytest.fixture(scope="module")
def port_steps():
    """One step of each variant from the bridged weights: {name: (metrics,
    params tree, state)}."""
    cfg = get_config("mixtral-8x7b").reduced()
    rt = Runtime(ep=True, ep_ranks=R_TRAIN)
    out = {}
    for name, kw in VARIANTS.items():
        model = _ep_model(cfg)
        opt, m = make_train_step(cfg, rt, lr_fn=lambda s: LR, **kw)(
            model, init_opt_state(model), _batch(cfg), _host_plan(cfg, R_TRAIN))
        out[name] = (m, ckpt.flatten(params_to_jax(model)),
                     opt_state_to_jax(opt, model))
    return out


def test_ep_gradients_match_the_meshed_jax_step_leaf_by_leaf(jax_ref):
    cfg = get_config("mixtral-8x7b").reduced()
    rt = Runtime(ep=True, ep_ranks=R_TRAIN)
    model = _ep_model(cfg)
    batch = {k: torch.tensor(v) for k, v in _batch(cfg).items()}
    loss, metrics = make_loss_fn(cfg, rt)(model, batch,
                                          _host_plan(cfg, R_TRAIN))
    loss.backward()
    assert loss.item() == pytest.approx(jax_ref["grad_loss"], rel=REL)
    np.testing.assert_array_equal(metrics["dropped"].numpy(),
                                  jax_ref["dropped"])
    np.testing.assert_array_equal(metrics["expert_counts"].numpy(),
                                  jax_ref["expert_counts"])
    grads = _grads(model)
    assert grads.keys() == jax_ref["grads"].keys()
    for key, w in jax_ref["grads"].items():
        assert _rel(grads[key], w) <= GRAD_REL, key
        assert np.abs(grads[key]).max() > 0, key       # nothing detached


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_ep_train_step_matches_the_meshed_jax_step(variant, jax_ref,
                                                    port_steps):
    m, params, opt = port_steps[variant]
    ref = jax_ref[variant]
    want = ref["metrics"]
    assert set(m) == set(want) | {"dropped"}
    for k in ("loss", "nll", "grad_norm", "aux_loss"):
        assert float(m[k]) == pytest.approx(float(want[k]), rel=REL), k
    assert abs(float(m["accuracy"]) - float(want["accuracy"])) <= 1 / (B * S)
    np.testing.assert_array_equal(m["expert_counts"].numpy(),
                                  want["expert_counts"])
    assert int(opt.step) == 1
    _assert_params_close(params, ref["params"])
    got = ckpt.flatten(opt.mu)
    for key, w in ref["mu"].items():
        assert _rel(got[key], w) <= MU_REL, key


def test_ep_remat_equals_the_plain_ep_step(port_steps):
    plain_m, plain_p, _ = port_steps["step"]
    remat_m, remat_p, _ = port_steps["remat"]
    assert torch.equal(remat_m["loss"], plain_m["loss"])
    for key in plain_p:
        np.testing.assert_array_equal(remat_p[key], plain_p[key])


def test_ep_step_without_a_plan_is_the_identity_plan_step():
    cfg = get_config("mixtral-8x7b").reduced()
    rt = Runtime(ep=True, ep_ranks=R_TRAIN)
    res = []
    for plan in (None, _host_plan(cfg, R_TRAIN)):
        model = _ep_model(cfg)
        opt, m = make_train_step(cfg, rt, lr_fn=lambda s: LR)(
            model, init_opt_state(model), _batch(cfg, 1), plan)
        res.append((m["loss"], ckpt.flatten(params_to_jax(model))))
    assert torch.equal(res[0][0], res[1][0])
    for key in res[0][1]:
        np.testing.assert_array_equal(res[0][1][key], res[1][1][key])


# ---------------------------------------------------------------------------
# (c) EP against dense where nothing drops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R", [2, 4])
def test_ep_step_equals_the_dense_step_without_drops(R):
    base = get_config("mixtral-8x7b").reduced()
    # a slot takes at most T_local pairs (top-k experts are distinct): at
    # cf = E / (R K) * R = E / K the capacity is T_local
    cf = base.moe.num_experts / base.moe.top_k
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=cf))
    batch = {k: torch.tensor(v) for k, v in _batch(cfg, 2).items()}
    out = {}
    for name, rt in (("ep", Runtime(ep=True, ep_ranks=R)),
                     ("dense", Runtime())):
        model = _ep_model(cfg)
        loss, metrics = make_loss_fn(cfg, rt)(model, batch)
        loss.backward()
        out[name] = (loss.item(), _grads(model), metrics)
    assert not out["ep"][2]["dropped"].any()
    np.testing.assert_array_equal(out["ep"][2]["expert_counts"].numpy(),
                                  out["dense"][2]["expert_counts"].numpy())
    assert out["ep"][0] == pytest.approx(out["dense"][0], rel=REL)
    for key, w in out["dense"][1].items():
        assert _rel(out["ep"][1][key], w) <= GRAD_REL, key


# ---------------------------------------------------------------------------
# (d) the launcher
# ---------------------------------------------------------------------------

STEP_LINE = re.compile(r"^step +\d+ loss=\d+\.\d{4} lr=\S+ gnorm=\d+\.\d{2}"
                       r" skew=\d+\.\d{2}$")


def test_launch_train_trains_mixtral_through_the_ep_path(tmp_path, capsys):
    path = str(tmp_path / "ep.npz")
    ops.reset_launches()
    rc = launch_train.main(["--arch", "mixtral-8x7b", "--reduced",
                            "--device", "cpu", "--data-mesh", "1",
                            "--model-mesh", "4", "--steps", "12",
                            "--batch", "4", "--seq", "32", "--log-every", "4",
                            "--ckpt", path])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0                               # the loss fell
    assert not any(ops.LAUNCHES.values())
    cfg = get_config("mixtral-8x7b").reduced()
    assert out[0].startswith(f"arch={cfg.name} params=")
    steps = [ln for ln in out if ln.startswith("step")]
    assert len(steps) == 4 and all(STEP_LINE.match(ln) for ln in steps)
    assert out[-2].startswith("done: 12 steps in ")
    assert out[-1] == f"checkpoint saved to {path}"
    jparams = jax.tree.map(jnp.asarray, _tree())
    restored = jckpt.restore_like({"params": jparams,
                                   "opt": jax_adamw_init(jparams)},
                                  jckpt.load(path))
    assert int(restored["opt"].step) == 12
    assert all(np.isfinite(np.asarray(v)).all()
               for v in jckpt._flatten(restored["params"]).values())
