"""Tensor-parallel and FSDP training across processes in the PyTorch port
(``sharding``'s "specs" and "fsdp" layouts on a ``launch.mesh`` process
mesh, ``gloo`` on the CPU) against the meshed JAX train step, on the CPU.

One JAX subprocess (four host devices, ``AxisType.Auto`` axes, no XLA
excess precision, as ``tests/test_torch_dist_train.py`` runs its oracle)
serves the file, started first so that it runs beside the port's two
worlds of four spawned ranks (one intra-op thread a rank). Its parameters
and AdamW moments are placed by ``repro.sharding.param_specs``: on a
(1, 4) mesh by the tensor-parallel rules ("specs"), on a (2, 2) mesh with
FSDP over "data" as ``repro.launch.specs.abstract_params`` lays them out
("fsdp"). Both packages train the reduced configs on the JAX init's fp32
weights (a MoE model's with ``tests/_torch_margins.py``'s wide router
margins, so that no route sits near a tie), a MoE model through the EP
dispatch over the model axis without replica slots: on (1, 4) qwen1.5-0.5b
(QKV biases; its two KV heads gathered at use), mixtral-8x7b,
recurrentgemma-2b and rwkv6-7b; on (2, 2) qwen1.5-0.5b, mixtral-8x7b,
deepseek-v2-lite-16b (MLA) and seamless-m4t-medium (random frames).

Against the JAX step, with the tolerances and reasons of
``tests/test_torch_dist_train.py`` (c) for its (2, 2) step: the first
step's loss 1e-3 relative and every gradient leaf 3e-2 relative in norm;
each of the two steps' loss, nll and gradient norm 1e-3 relative (the
gradient norm ``GNORM_REL`` 5e-3 for rwkv6-7b, the reference's own spread,
as ``tests/test_torch_rwkv_train.py`` holds it); the first step's
accuracy within one position (a later step's weights carry the first
update's bf16 noise, under which near-tie argmaxes of the random weights
flip: two positions of 128 seen at qwen's second step); the parameters after the two steps within 2 lr a step, at most
2% of a leaf's elements beyond lr / 10 a step; the first moments 3e-2
relative in norm. Every rank reports the same losses.

Memory: each process holds exactly the bytes of its ``shard_tensor``
blocks, parameters and (fp32) moments alike, fewer than the whole model's;
a leaf whole over "model" has the same block on every model rank. Under
"fsdp" every weight of rank >= 2 that the data ranks divide is split over
"data". The gathered checkpoint of the (2, 2) world restores in the JAX
package, and so does ``launch.train --shard-params fsdp``'s.
"""

import functools
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
from repro.optim.adamw import adamw_init as jax_adamw_init  # noqa: E402
from repro.train import checkpoint as jckpt  # noqa: E402
from repro_torch.bridge import _jax_from_flat  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.models.transformer import init_model  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from tests import _torch_dist_tp as legs  # noqa: E402
from tests._torch_margins import widen_margins  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REL, GRAD_REL, MU_REL, GNORM_REL = 1e-3, 3e-2, 3e-2, 5e-3
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
from repro.models.transformer import Runtime
from repro.optim.adamw import adamw_init
from repro.sharding import batch_axes, make_shardings, param_specs
from repro.train.checkpoint import _flatten
from repro.train.steps import make_train_step

LR, STEPS = eval(os.environ["TT_LR_STEPS"])
with open(sys.argv[1], "rb") as f:
    trees, batches = pickle.load(f)
res = {}
for shape, (layout, archs) in eval(os.environ["TT_LEGS"]).items():
    D, M = shape
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    for arch in archs:
        cfg = get_config(arch).reduced()
        params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                              trees[arch])
        kw = (dict(fsdp_axes=batch_axes(mesh), fsdp_size=D)
              if layout == "fsdp" else {})
        shardings = make_shardings(mesh, param_specs(params, mesh=mesh,
                                                     **kw))
        params = jax.device_put(params, shardings)
        opt = adamw_init(params)
        opt = opt._replace(mu=jax.device_put(opt.mu, shardings),
                           nu=jax.device_put(opt.nu, shardings))
        batch = {k: jnp.asarray(v) for k, v in batches[arch].items()}
        rt = Runtime(mesh=mesh, ep=cfg.is_moe, ep_ranks=M,
                     use_duplication=False)
        plan = plan_args(cfg, M) if cfg.is_moe else None
        out = {"metrics": [], "mu": []}
        with mesh:
            step = jax.jit(make_train_step(cfg, rt, lr_fn=lambda s: LR))
            for _ in range(STEPS):
                params, opt, m = step(params, opt, batch, plan)
                out["metrics"].append({k: np.asarray(v, np.float32)
                                       for k, v in m.items()})
                out["mu"].append(_flatten(opt.mu))
            out["params"] = _flatten(params)
        res[(arch, shape)] = out
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


def jax_tree(arch):
    """The JAX init's fp32 tree; a MoE model's with wide router margins."""
    cfg = jax_get_config(arch).reduced()
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jax_init_model(
        jax.random.PRNGKey(0), cfg))
    if cfg.is_moe:
        tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                            widen_margins(tree, cfg))
    return tree


ARCHS = sorted({a for _, archs in legs.TRAIN.values() for a in archs})
CASES = [(a, m) for m, (_, archs) in legs.TRAIN.items() for a in archs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": {(arch, mesh): record}, mesh: every rank's {arch: record},
    "ckpt": the (2, 2) world's checkpoint, "trees"}."""
    tmp = tmp_path_factory.mktemp("dist_tp_train")
    trees = {a: jax_tree(a) for a in ARCHS}
    batches = {a: legs.train_batch(get_config(a).reduced()) for a in ARCHS}
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump((trees, batches), f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               TT_LR_STEPS=repr((legs.LR, legs.STEPS)),
               TT_LEGS=repr(legs.TRAIN))
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(SUB),
                             str(tmp / "in.pkl"), str(tmp / "jax.pkl")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    out = {"ckpt": str(tmp / "fsdp_2x2.npz"), "trees": trees}
    try:
        for shape, (layout, archs) in legs.TRAIN.items():
            out[shape] = mesh_mod.spawn(
                legs.run_train_rank, (trees, layout, archs,
                                      out["ckpt"] if layout == "fsdp"
                                      else ""),
                data=shape[0], model=shape[1], backend="gloo", threads=1,
                timeout_s=300)
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    with open(tmp / "jax.pkl", "rb") as f:
        out["jax"] = pickle.load(f)
    return out


@functools.lru_cache(maxsize=None)
def _layout_model(arch):
    """A reduced model of ``arch``: the layer structure ``_to_jax_flat``
    lays a flat tree out by."""
    return init_model(get_config(arch).reduced(),
                      torch.Generator().manual_seed(0), device="cpu")


def _to_jax_flat(arch, flat):
    """A port {name: whole numpy leaf} under the JAX tree's flat keys
    (stacked leaves stacked over the layers)."""
    return ckpt.flatten(_jax_from_flat(_layout_model(arch),
                                       lambda n: flat[n]))


@pytest.mark.parametrize("arch,shape", CASES)
def test_mesh_step_matches_the_meshed_jax_step(runs, arch, shape):
    ref, ranks = runs["jax"][(arch, shape)], runs[shape]
    got = ranks[0][arch]
    for r in range(1, len(ranks)):                       # every rank alike
        assert [float(m["loss"]) for m in ranks[r][arch]["metrics"]] == [
            float(m["loss"]) for m in got["metrics"]], r
    gnorm_rel = GNORM_REL if arch == "rwkv6-7b" else REL
    for i, (m, want) in enumerate(zip(got["metrics"], ref["metrics"])):
        # a step's tolerance for every step taken (i + 1)
        for k in ("loss", "nll"):
            assert float(m[k]) == pytest.approx(float(want[k]),
                                                rel=REL * (i + 1)), (i, k)
        assert float(m["grad_norm"]) == pytest.approx(
            float(want["grad_norm"]), rel=gnorm_rel * (i + 1)), i
    assert abs(float(got["metrics"][0]["accuracy"])
               - float(ref["metrics"][0]["accuracy"])) <= 1 / (
        legs.TB * legs.TS)
    # the first moments after the first step: each leaf's clipped gradient
    # times 1 - b1 (the clip scales within REL of each other)
    mu0 = _to_jax_flat(arch, got["mu"][0])
    assert mu0.keys() == ref["mu"][0].keys()
    for key, w in ref["mu"][0].items():
        assert _rel(mu0[key], w) <= GRAD_REL, key
        assert np.abs(mu0[key]).max() > 0, key
    mu = _to_jax_flat(arch, got["mu"][-1])
    for key, w in ref["mu"][-1].items():
        assert _rel(mu[key], w) <= MU_REL * legs.STEPS, key
    params = _to_jax_flat(arch, got["params"])
    lr, n = legs.LR, legs.STEPS
    for key, w in ref["params"].items():
        d = np.abs(params[key] - w)
        assert d.max() <= 2 * lr * n + 1e-6, (key, float(d.max()))
        if key == K_BIAS:
            # its resolved elements only, as tests/test_torch_dist_train.py
            # counts them (bf16 noise picks the sign of Adam's first steps)
            g = np.abs(ref["mu"][0][key])
            d = d[g >= g.max() * 2.0 ** -8]
        assert (d > lr / 10 * n).mean() <= 0.02 * n, (
            key, float((d > lr / 10 * n).mean()))


@pytest.mark.parametrize("arch,shape", CASES)
def test_each_process_holds_its_blocks_and_their_moments(runs, arch, shape):
    """Parameters and moments: exactly the bytes of this rank's blocks,
    under half the whole model's with FSDP over two data ranks (nearly
    every leaf split over both axes), under the whole model's without."""
    layout = legs.TRAIN[shape][0]
    whole = sum(int(np.prod(a.shape)) * 4
                for a in ckpt.flatten(runs["trees"][arch]).values())
    for r, rank in enumerate(runs[shape]):
        got = rank[arch]
        assert got["bytes"]["held"] == got["bytes"]["blocks"], r
        assert got["moment_bytes"]["held"] == got["moment_bytes"][
            "blocks"] == got["bytes"]["held"], r
        assert got["bytes"]["held"] < (whole / 2 if layout == "fsdp"
                                       else whole), r
        if layout == "fsdp":
            # every leaf split over "model" is split over "data" too
            for n, u in got["uses"].items():
                if u in ("col", "row", "vocab", "expert"):
                    assert got["data_dims"][n] is not None, (r, n)


def test_fsdp_checkpoint_restores_in_jax(runs):
    arch = legs.TRAIN[(2, 2)][1][0]
    tree = runs["trees"][arch]
    jparams = jax.tree.map(jnp.asarray, tree)
    restored = jckpt.restore_like({"params": jparams,
                                   "opt": jax_adamw_init(jparams)},
                                  jckpt.load(runs["ckpt"]))
    assert int(restored["opt"].step) == legs.STEPS
    flat = jckpt._flatten(restored["params"])
    assert flat.keys() == jckpt._flatten(tree).keys()
    want = _to_jax_flat(arch, runs[(2, 2)][0][arch]["params"])
    for key, w in want.items():
        np.testing.assert_array_equal(np.asarray(flat[key]), w, err_msg=key)


def test_launch_train_shards_its_parameters(tmp_path):
    """``launch.train --shard-params fsdp`` on a (2, 2) gloo world: the JAX
    launcher's lines once, the whole model's parameter count, and a
    checkpoint gathered from every rank's blocks that the JAX package
    restores; the layout needs a process backend."""
    from repro_torch.launch import train as launch_train

    path = str(tmp_path / "fsdp.npz")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "stablelm-3b", "--reduced", "--device", "cpu", "--backend", "gloo",
         "--data-mesh", "2", "--model-mesh", "2", "--shard-params", "fsdp",
         "--steps", "2", "--batch", "4", "--seq", "32", "--log-every", "1",
         "--ckpt", path],
        capture_output=True, text=True, timeout=300, env=env)
    out = proc.stdout.splitlines()
    assert proc.returncode in (0, 1), proc.stderr[-4000:]
    cfg = get_config("stablelm-3b").reduced()
    whole = sum(p.numel() for p in init_model(cfg, device="cpu").parameters())
    assert out[0].startswith(f"arch={cfg.name} params={whole / 1e6:.1f}M "), out
    assert out[-1] == f"checkpoint saved to {path}", out
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jax_init_model(
        jax.random.PRNGKey(0), jax_get_config("stablelm-3b").reduced()))
    jparams = jax.tree.map(jnp.asarray, tree)
    restored = jckpt.restore_like({"params": jparams,
                                   "opt": jax_adamw_init(jparams)},
                                  jckpt.load(path))
    assert int(restored["opt"].step) == 2
    for key, a in jckpt._flatten(restored["params"]).items():
        assert np.shape(a) == np.shape(jckpt._flatten(tree)[key]), key
        assert np.isfinite(np.asarray(a)).all(), key
    with pytest.raises(ValueError, match="name --backend gloo or nccl"):
        launch_train.main(["--arch", "stablelm-3b", "--reduced", "--device",
                           "cpu", "--shard-params", "specs"])
