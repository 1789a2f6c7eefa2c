"""Training across processes in the PyTorch port (``launch.mesh``: one
process a rank of a ``(data, model)`` mesh, ``gloo`` on the CPU), on the CPU.

Two worlds of four spawned ranks run every leg of
``tests/_torch_dist_train.py`` (one intra-op thread a rank), and one JAX
subprocess (four host devices, a ``(2, 2)`` mesh of ``AxisType.Auto``
axes, no XLA excess precision, as ``tests/test_torch_train_ep.py`` (b)
runs its oracle) serves the file, started first so that it runs beside
them. Reduced Mixtral and qwen1.5-0.5b train on the JAX init's weights
(Mixtral's with ``tests/_torch_margins.py``'s wide margins, so that no
route sits near a tie; qwen's with nonzero QKV biases), bridged.

(a) The collectives of ``ProcessGroupRanks`` that training takes carry the
    gradient autograd gives the same ``StackedRanks`` operation, under a
    loss every rank computes alike; those without a backward raise when
    given a tensor that requires a gradient while autograd records, and
    run as before under ``no_grad``.
(b) (1, 4) against the stacked EP step (``Runtime(ep=True, ep_ranks=4)``
    in this process, the same weights and batch): reduced Mixtral plain
    and under ``remat``, and reduced deepseek-v2-lite-16b's router variant
    (E 16, K 6, two shared experts) on the port's seeded weights. Loss,
    nll, accuracy, aux loss, per-layer drops and expert counts equal bit
    for bit, and every gradient leaf (the experts gathered from their
    owners) but the routers'. Each router's gradient is the sum of four
    ranks' parts, added in another order than the stacked step's one
    product over every rank's positions: within 1e-6 relative in norm (the
    largest seen 2.2e-7). The gradient norm within 1e-6 relative.
(c) (2, 2) against the meshed JAX step on a (2, 2) mesh, with the
    tolerances and reasons of ``tests/test_torch_train_ep.py`` (b): drops
    and expert counts equal; loss, nll, aux loss and gradient norm 1e-3
    relative, accuracy within one position; every gradient leaf 3e-2
    relative in norm; parameters after one AdamW step within 2 lr, at most
    2% of a leaf's elements beyond lr / 10; first moments 3e-2 relative in
    norm. Reduced Mixtral plain and with 2 microbatches (each against the
    JAX step of its kind), and reduced qwen1.5-0.5b (no MoE: data-parallel,
    its model ranks repeating their data rank's work).
(d) The other families, data-parallel in the (2, 2) world against the
    port's one-process step on the whole batch: recurrentgemma-2b,
    rwkv6-7b, seamless-m4t-medium (random frames), llava-next-34b (random
    prefix embeddings), and qwen1.5-0.5b under a random loss mask (the
    whole batch's denominator): loss within 1e-6 relative, every gradient
    leaf within 1e-5 relative in norm (the data ranks' mean adds in
    another order).
(e) After three steps every replicated parameter has the same bytes on
    all four ranks, and each expert block the same bytes on both data
    ranks of its model index.
(f) The launcher: ``python -m repro_torch.launch.train --backend gloo
    --data-mesh 2 --model-mesh 2`` prints the JAX launcher's lines once
    (up to numbers) and its checkpoint restores in the JAX package; the
    (1, 4) world's run of the launcher against the stacked launcher on
    the same flags: the same printed first loss, and every parameter and
    moment of the checkpoint within 1e-5 relative in norm. None is equal
    bit for bit after a step: the clip scale reads a gradient norm whose
    router and expert terms add in another order. ``--backend nccl``
    without four cards raises, and so does the stacked backend given a
    data axis.
"""

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
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models.transformer import init_model as jax_init_model  # noqa: E402
from repro.optim.adamw import adamw_init as jax_adamw_init  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.transformer import (Runtime, forward,  # noqa: E402
                                            init_model)
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from tests import _torch_dist_train as legs  # noqa: E402
from tests._torch_margins import widen_margins  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REL, GRAD_REL, MU_REL = 1e-3, 3e-2, 3e-2           # against JAX
ROUTER_REL, NORM_REL = 1e-6, 1e-6                  # (1, 4) against stacked
DP_LOSS_REL, DP_GRAD_REL = 1e-6, 1e-5              # data-parallel families
# a bf16-cast weight's gradient is rounded to bf16 once a piece of the
# batch: each data rank's rows against the whole batch's (seen 2.6e-3)
MASK_GRAD_REL = 5e-3
LAUNCH_REL = 1e-5
JAX_LEGS = {"mixtral-8x7b": {"mixtral": {},
                             "mixtral_mb2": {"microbatches": 2}},
            "qwen1.5-0.5b": {"qwen": {}}}
ROUTER = "layers/moe/router/w"
K_BIAS = "layers/attn/wk/b"

SUB = '''
import os, pickle, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_allow_excess_precision=false")
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs.registry import get_config
from repro.launch.specs import plan_args
from repro.models.transformer import Runtime, forward
from repro.optim.adamw import adamw_init
from repro.train.checkpoint import _flatten
from repro.train.loss import lm_loss
from repro.train.steps import make_train_step

B, S, LR, D, M = eval(os.environ["DT_SHAPE"])
with open(sys.argv[1], "rb") as f:
    trees, batches = pickle.load(f)
mesh = jax.make_mesh((D, M), ("data", "model"),
                     axis_types=(AxisType.Auto, AxisType.Auto))
res = {}
for arch, variants in eval(os.environ["DT_LEGS"]).items():
    cfg = get_config(arch).reduced()
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), trees[arch])
    batch = {k: jnp.asarray(v) for k, v in batches[arch].items()}
    rt = Runtime(mesh=mesh, ep=cfg.is_moe, ep_ranks=M, use_duplication=False)
    plan = plan_args(cfg, M) if cfg.is_moe else None
    out = {}
    with mesh:
        if cfg.is_moe:
            _, _, stats = jax.jit(lambda p: forward(
                p, cfg, batch, rt, mode="train", plan=plan))(params)
            for k in ("dropped", "expert_counts"):
                out[k] = np.asarray(stats[k])

        def loss_fn(p):
            logits, _, st = forward(p, cfg, batch, rt, mode="train",
                                    plan=plan)
            loss, _ = lm_loss(logits, batch["labels"])
            return loss + st["aux_loss"] + st["z_loss"]
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        out["grad_loss"] = float(loss)
        out["grads"] = _flatten(grads)
        for name, kw in variants.items():
            step = jax.jit(make_train_step(cfg, rt, lr_fn=lambda s: LR, **kw))
            p1, o1, m = step(params, adamw_init(params), batch, plan)
            out[name] = {"metrics": {k: np.asarray(v, np.float32)
                                     for k, v in m.items()},
                         "params": _flatten(p1), "mu": _flatten(o1.mu)}
    res[arch] = out
with open(sys.argv[2], "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    n = np.linalg.norm(want)
    return float(np.linalg.norm(got - want) / max(n, 1e-30))


def _jax_tree(arch):
    """The JAX init's fp32 tree: Mixtral's with wide margins, qwen's with
    nonzero QKV biases."""
    jcfg = jax_get_config(arch).reduced()
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jax_init_model(
        jax.random.PRNGKey(0), jcfg))
    if jcfg.is_moe:
        return jax.tree.map(lambda a: np.asarray(a, np.float32),
                            widen_margins(tree, jcfg))
    rng = np.random.default_rng(7)
    for n in ("wq", "wk", "wv"):
        b = tree["layers"]["attn"][n]["b"]
        tree["layers"]["attn"][n]["b"] = rng.normal(0.0, 0.5, b.shape).astype(
            np.float32)
    return tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": the JAX legs, (1, 4) / (2, 2): every rank's legs, "ckpt":
    the (1, 4) world's launcher checkpoint}."""
    tmp = tmp_path_factory.mktemp("dist_train")
    trees = {arch: _jax_tree(arch) for arch in JAX_LEGS}
    batches = {arch: legs.leg_batch(next(iter(v)), legs.leg_config(
        next(iter(v)))) for arch, v in JAX_LEGS.items()}
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump((trees, batches), f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               DT_SHAPE=repr((legs.B, legs.S, legs.LR, 2, 2)),
               DT_LEGS=repr(JAX_LEGS))
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(SUB),
                             str(tmp / "in.pkl"), str(tmp / "jax.pkl")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    out = {"ckpt": str(tmp / "process_1x4.npz"), "trees": trees}
    try:
        for shape, names in legs.WORLDS.items():
            out[shape] = mesh_mod.spawn(
                legs.run_rank, (trees, names, out["ckpt"]), data=shape[0],
                model=shape[1], backend="gloo", threads=1, timeout_s=300)
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    with open(tmp / "jax.pkl", "rb") as f:
        out["jax"] = pickle.load(f)
    return out


# ---------------------------------------------------------------------------
# (a) the collectives' gradients
# ---------------------------------------------------------------------------

def _stacked_collective_grads(R):
    """What autograd gives the ``StackedRanks`` form of each case of
    ``legs.collective_grads``, every rank's rows."""
    x, c = legs.collective_inputs(R)
    out = {}
    buf = torch.tensor(x["a2a"], requires_grad=True)          # (R, R, n)
    (buf.transpose(0, 1) * torch.tensor(c["a2a"])).sum().backward()
    out["all_to_all"] = buf.grad.numpy()
    t = torch.tensor(x["gather"], requires_grad=True)         # (R, n)
    (t * torch.tensor(c["gather"])).sum().backward()
    out["all_gather"] = t.grad.numpy()
    t = torch.tensor(x["local"], requires_grad=True)          # (R, n)
    (t * torch.tensor(c["local"])).sum().backward()
    out["local"] = t.grad.numpy()
    t = torch.tensor(x["loss"], requires_grad=True)           # (R,)
    (t.mean(dim=0) * float(c["loss"])).backward()
    out["pmean_losses"] = t.grad.numpy()
    w = torch.tensor(x["weight"], requires_grad=True)         # (n,)
    (w[None] * torch.tensor(c["weight"])).sum().backward()
    out["psum_grad"] = w.grad.numpy()
    return out


def test_collectives_carry_the_stacked_gradient_or_raise(runs):
    want = _stacked_collective_grads(4)
    for r, rank in enumerate(runs[(1, 4)]):
        got = rank["collectives"]
        for name in ("all_to_all", "all_gather", "pmean_losses"):
            np.testing.assert_array_equal(got[name], want[name][r:r + 1],
                                          err_msg=f"{name}, rank {r}")
        # local: the whole replicated tensor's gradient on every rank
        np.testing.assert_array_equal(got["local"], want["local"],
                                      err_msg=f"local, rank {r}")
        np.testing.assert_allclose(got["psum_grad"], want["psum_grad"],
                                   rtol=1e-6, err_msg=f"psum_grad, rank {r}")
        assert got["raised"] == {name: True for name in legs.NO_BACKWARD}, r
        assert got["no_grad_ran"], r


# ---------------------------------------------------------------------------
# (b) the (1, 4) process step against the stacked EP step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("leg", ["mixtral", "mixtral_remat", "deepseek"])
def test_process_step_equals_the_stacked_step(runs, leg):
    want = legs.run_leg(leg, runs["trees"], 4)
    got = runs[(1, 4)][0][leg]
    assert got["loss"] == want["loss"]
    assert got["metrics"].keys() == want["metrics"].keys()
    for k, w in want["metrics"].items():
        np.testing.assert_array_equal(got["metrics"][k], w, err_msg=k)
    assert got["grads"].keys() == want["grads"].keys()
    for k, w in want["grads"].items():
        if k == ROUTER:
            assert _rel(got["grads"][k], w) <= ROUTER_REL, k
        else:
            np.testing.assert_array_equal(got["grads"][k], w, err_msg=k)
        assert np.abs(w).max() > 0, k                     # nothing detached
    assert float(got["step"]["grad_norm"]) == pytest.approx(
        float(want["step"]["grad_norm"]), rel=NORM_REL)
    for r, rank in enumerate(runs[(1, 4)][1:], 1):       # the loss replicated
        assert rank[leg]["loss"] == got["loss"], r
        assert rank[leg]["grads"] is None, r              # whole on rank 0


# ---------------------------------------------------------------------------
# (c) the (2, 2) process step against the meshed JAX step
# ---------------------------------------------------------------------------

def _assert_params_close(got, want, grads, lr=legs.LR):
    for key, w in want.items():
        d = np.abs(got[key] - w)
        assert d.max() <= 2 * lr + 1e-6, (key, float(d.max()))
        if key == K_BIAS:
            # its resolved elements only, as tests/test_torch_dense_train.py
            # counts them: q . (k + b) moves every score of a query alike
            # but for RoPE's rotation, so the gradient of much of the K
            # bias sits under the two packages' bf16 noise, and Adam's
            # first step moves it by lr along a sign that noise picks
            g = np.abs(grads[key])
            resolved = g >= g.max() * 2.0 ** -8
            assert resolved.mean() >= 0.5, resolved.mean()
            d = d[resolved]
        assert (d > lr / 10).mean() <= 0.02, (key, float((d > lr / 10).mean()))


@pytest.mark.parametrize("leg", ["mixtral", "mixtral_mb2", "qwen"])
def test_mesh_step_matches_the_meshed_jax_step(runs, leg):
    arch = legs.LEGS[leg][0]
    ref = runs["jax"][arch]
    ranks = runs[(2, 2)]
    got = ranks[0][leg]
    for r in (1, 2, 3):                                  # every rank alike
        assert ranks[r][leg]["loss"] == got["loss"], r
    if leg != "mixtral_mb2":
        assert got["loss"] == pytest.approx(ref["grad_loss"], rel=REL)
        assert got["grads"].keys() == ref["grads"].keys()
        for key, w in ref["grads"].items():
            assert _rel(got["grads"][key], w) <= GRAD_REL, key
            assert np.abs(got["grads"][key]).max() > 0, key
        for key, g in got["grads"].items():    # both data ranks alike
            np.testing.assert_array_equal(ranks[2][leg]["grads"][key], g,
                                          err_msg=key)
    if leg == "mixtral":
        np.testing.assert_array_equal(got["metrics"]["dropped"],
                                      ref["dropped"])
        np.testing.assert_array_equal(got["metrics"]["expert_counts"],
                                      ref["expert_counts"])
    step, want = got["step"], ref[leg]["metrics"]
    assert set(step) == set(want) | ({"dropped"} if arch == "mixtral-8x7b"
                                     else set())
    keys = ["loss", "nll", "grad_norm"] + (["aux_loss"] if "aux_loss" in want
                                          else [])
    for k in keys:
        assert float(step[k]) == pytest.approx(float(want[k]), rel=REL), k
    assert abs(float(step["accuracy"]) - float(want["accuracy"])) <= 1 / (
        legs.B * legs.S)
    if "expert_counts" in want:
        np.testing.assert_array_equal(step["expert_counts"],
                                      want["expert_counts"])
    _assert_params_close(got["params"], ref[leg]["params"], ref["grads"])
    for key, w in ref[leg]["mu"].items():
        assert _rel(got["mu"][key], w) <= MU_REL, key


# ---------------------------------------------------------------------------
# (d) the other families, data-parallel, against the one-process step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("leg", ["recurrentgemma", "rwkv", "seamless",
                                 "llava"])
def test_data_parallel_step_matches_the_one_process_step(runs, leg):
    # each data rank's rows are one of two microbatches of the whole batch
    want = legs.run_leg(leg, runs["trees"], 1, microbatches=2)
    got = runs[(2, 2)][0][leg]
    assert got["loss"] == pytest.approx(want["loss"], rel=DP_LOSS_REL)
    assert got["grads"].keys() == want["grads"].keys()
    for key, w in want["grads"].items():
        assert _rel(got["grads"][key], w) <= DP_GRAD_REL, key
        assert np.abs(w).max() > 0, key
    for r in (1, 2, 3):
        assert runs[(2, 2)][r][leg]["loss"] == got["loss"], r


def test_loss_mask_divides_by_the_whole_batchs_mask(runs):
    """Under a loss mask the data ranks' rows hold different mask sums, so
    a mean of per-rank means would miss the whole batch's loss; the
    reference is the one-process step over the whole batch at once."""
    mask = legs.leg_batch("qwen_mask", legs.leg_config("qwen_mask"))[
        "loss_mask"]
    assert mask[:2].sum() != mask[2:].sum()
    want = legs.run_leg("qwen_mask", runs["trees"], 1)
    got = runs[(2, 2)][0]["qwen_mask"]
    assert got["loss"] == pytest.approx(want["loss"], rel=DP_LOSS_REL)
    for key, w in want["grads"].items():
        assert _rel(got["grads"][key], w) <= MASK_GRAD_REL, key


# ---------------------------------------------------------------------------
# (e) replicated parameters stay equal
# ---------------------------------------------------------------------------

def test_replicated_parameters_keep_their_bytes_on_every_rank(runs):
    ranks = [r["replicated"] for r in runs[(2, 2)]]
    experts = set(ranks[0]["experts"])
    assert experts and ranks[0]["digests"].keys() > experts
    for name, digest in ranks[0]["digests"].items():
        if name in experts:
            # rank (d, m) holds expert block m: equal over the data axis
            assert ranks[2]["digests"][name] == digest, name
            assert ranks[3]["digests"][name] == ranks[1]["digests"][name]
            assert ranks[1]["digests"][name] != digest, name
        else:
            assert all(r["digests"][name] == digest for r in ranks), name


# ---------------------------------------------------------------------------
# (f) the launcher
# ---------------------------------------------------------------------------

STEP_LINE = re.compile(r"^step +\d+ loss=\d+\.\d{4} lr=\S+ gnorm=\d+\.\d{2}"
                       r" skew=\d+\.\d{2}$")


def test_launch_train_over_gloo_processes(tmp_path):
    path = str(tmp_path / "mesh.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mixtral-8x7b", "--reduced", "--device", "cpu", "--backend", "gloo",
         "--data-mesh", "2", "--model-mesh", "2", "--steps", "3", "--batch",
         "4", "--seq", "32", "--log-every", "1", "--ckpt", path],
        capture_output=True, text=True, timeout=300, env=env)
    out = proc.stdout.splitlines()
    cfg = get_config("mixtral-8x7b").reduced()
    held = sum(p.numel() for p in init_model(cfg, device="cpu").parameters())
    assert len(out) == 6, (out, proc.stderr[-4000:])    # rank 0's, once
    assert out[0] == (f"arch={cfg.name} params={held / 1e6:.1f}M "
                      f"(analytical {cfg.num_params() / 1e6:.1f}M) "
                      "family=moe moe=True")
    assert all(STEP_LINE.match(ln) for ln in out[1:4]), out
    losses = [float(ln.split("loss=")[1].split()[0]) for ln in out[1:4]]
    assert proc.returncode == (0 if losses[-1] < losses[0] else 1)
    assert out[4].startswith("done: 3 steps in ")
    assert out[5] == f"checkpoint saved to {path}"
    tree = _jax_tree("mixtral-8x7b")
    jparams = jax.tree.map(jnp.asarray, tree)
    restored = jckpt.restore_like({"params": jparams,
                                   "opt": jax_adamw_init(jparams)},
                                  jckpt.load(path))
    assert int(restored["opt"].step) == 3
    flat = jckpt._flatten(restored["params"])
    assert flat.keys() == jckpt._flatten(tree).keys()
    assert all(np.isfinite(np.asarray(v)).all() for v in flat.values())
    assert flat["layers/moe/experts/w_up"].shape[1] == cfg.moe.num_experts


def test_process_launcher_matches_the_stacked_launcher(runs, tmp_path,
                                                       capsys):
    assert all(r["launcher"] in (0, 1) for r in runs[(1, 4)])
    assert len({r["launcher"] for r in runs[(1, 4)]}) == 1
    path = str(tmp_path / "stacked.npz")
    rc = legs.run_launcher(path)
    assert rc == runs[(1, 4)][0]["launcher"]
    stacked_lines = capsys.readouterr().out.splitlines()
    got, want = (ckpt.flatten(ckpt.load(p)) for p in (runs["ckpt"], path))
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        if np.issubdtype(w.dtype, np.floating) and np.abs(w).max() > 0:
            assert _rel(got[key], w) <= LAUNCH_REL, key
        else:
            np.testing.assert_array_equal(got[key], w, err_msg=key)
    assert stacked_lines[1].startswith("step    0 loss=")


def test_backends_are_named_and_checked(tmp_path):
    argv = ["--arch", "mixtral-8x7b", "--reduced", "--data-mesh", "1",
            "--model-mesh", "4", "--steps", "1", "--batch", "4",
            "--seq", "32"]
    if torch.cuda.device_count() < 4:
        with pytest.raises((RuntimeError, ValueError),
                           match="cards|card a rank|is_available"):
            launch_train.main(argv + ["--backend", "nccl"])
    with pytest.raises(ValueError, match="backend nccl runs on cards"):
        launch_train.main(argv + ["--device", "cpu", "--backend", "nccl"])
    with pytest.raises(ValueError, match="give --data-mesh"):
        launch_train.main(["--arch", "mixtral-8x7b", "--reduced",
                           "--device", "cpu", "--backend", "gloo"])
    with pytest.raises(ValueError, match="--backend gloo or nccl"):
        launch_train.main(["--arch", "mixtral-8x7b", "--reduced",
                           "--device", "cpu", "--data-mesh", "2",
                           "--model-mesh", "2"])


def test_forward_on_a_mesh_refuses_what_is_not_ported():
    """Every model trains and serves on a mesh, a MoE model under EP, the
    FSDP layout included (its serving is held against the meshed JAX
    engines in tests/test_torch_dist_fsdp_serve.py); what stays refused
    is a mesh MoE forward without EP."""
    fake = types.SimpleNamespace(model=1, data=1,
                                 batch_rows=lambda batch: None)
    toks = torch.zeros((1, 8), dtype=torch.long)
    qwen = get_config("qwen1.5-0.5b").reduced()
    model = init_model(qwen, torch.Generator().manual_seed(0), device="cpu")
    logits, _, _ = forward(model, qwen, toks, Runtime(mesh=fake),
                           mode="train")
    assert logits.shape == (1, 8, qwen.vocab_size)
    logits, _, _ = forward(model, qwen, toks, Runtime(mesh=fake),
                           mode="prefill")
    assert logits.shape == (1, 1, qwen.vocab_size)
    model.layout = "fsdp"
    served, _, _ = forward(model, qwen, toks, Runtime(mesh=fake),
                           mode="prefill")
    torch.testing.assert_close(served, logits, rtol=0, atol=0)
    mixtral = get_config("mixtral-8x7b").reduced()
    moe = init_model(mixtral, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="runs under EP"):
        forward(moe, mixtral, toks, Runtime(mesh=fake), mode="train")
