"""Tensor-parallel serving across processes in the PyTorch port
(``sharding``'s "specs" layout on a ``launch.mesh`` process mesh, ``gloo``
on the CPU) against the meshed JAX engines, on the CPU.

The JAX side runs in one subprocess with four host devices and
``--xla_allow_excess_precision=false``, on ``(1, 4)`` and ``(2, 2)``
("data", "model") meshes of ``AxisType.Auto`` axes, its parameters placed
by ``repro.sharding.param_specs(tree, mesh=mesh)``; it starts first, so it
runs while the port's two worlds (one a mesh shape, every leg in it, one
intra-op thread a rank) do. Both packages serve the reduced configs of one
model of each family on the JAX init's weights with wide ``lm_head``
margins (``tests/_torch_dist_tp.py``'s ``widen_head``; a MoE model's also
wide router margins, ``tests/_torch_margins.py``), so no token sits near
a tie and every run is compared to its end: stablelm-3b (a dense GQA
model), mixtral-8x7b (EP with the replica store under Distribution-Only,
a re-plan every batch), recurrentgemma-2b (Griffin: its local layers'
single KV head gathered at use), rwkv6-7b, deepseek-v2-lite-16b (MLA,
EP), seamless-m4t-medium (frames through the encoder, the cross cache) and
llava-next-34b (prefix embeddings). ``ServeEngine.generate`` runs two
batches of 4 x 16 prompts, 5 new tokens each; on (2, 2) each data rank
serves two rows.

Equal: every batch's tokens, on every rank alike. Within ``LOGIT_ATOL``
plus one bf16 ulp of their magnitude (``LOGIT_RTOL`` 2^-7: the widened
logits reach ~16, as in ``tests/test_torch_dist_serve.py``), with the same
argmax: every prefill's and decode step's logits. Each rank holds the
bytes of its ``shard_tensor`` blocks and no more; the head projections
gathered at use are the ones ``legs.gathered_leaves`` names (and only
they), and at published widths only recurrentgemma-2b's; a model without
MoE serves on a mesh from ``launch.serve``.
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
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from tests import _torch_dist_tp as legs  # noqa: E402
from tests._torch_margins import widen_margins  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LOGIT_ATOL = 5e-2             # bf16 logits, as in tests/test_torch_model.py
LOGIT_RTOL = 2.0 ** -7

SUB = '''
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_allow_excess_precision=false")
import pickle
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs.registry import get_config
from repro.serve import ServeConfig, ServeEngine
from repro.sharding import make_shardings, param_specs

exec(os.environ["TP_CAPTURE"])
with open(sys.argv[1], "rb") as f:
    trees, batches = pickle.load(f)
moe_kw, dense_kw = eval(os.environ["TP_MOE_KW"]), eval(os.environ["TP_DENSE_KW"])
new, step_s = eval(os.environ["TP_NEW"]), eval(os.environ["TP_STEP_S"])
to_np = lambda a: np.asarray(a, np.float32)
res = {}
for shape in eval(os.environ["TP_MESHES"]):
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    for arch in eval(os.environ["TP_ARCHS"]):
        cfg = get_config(arch).reduced()
        tree = jax.tree.map(jnp.asarray, trees[arch])
        if cfg.is_moe:
            tree["layers"]["moe"]["experts"] = jax.tree.map(
                lambda w: w.astype(jnp.bfloat16),
                tree["layers"]["moe"]["experts"])
        tree = jax.device_put(tree, make_shardings(
            mesh, param_specs(tree, mesh=mesh)))
        eng = ServeEngine(cfg, tree, ServeConfig(
            **(moe_kw if cfg.is_moe else dense_kw)), mesh=mesh,
                          ep_ranks=shape[1])
        with mesh:
            res[(arch, shape)] = serve_tp(eng, batches[arch], new, step_s,
                                          to_np)
with open(sys.argv[2], "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced models' operations are tiny: one intra-op thread runs
    them as fast as many (each spawned rank runs one too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_tree(arch):
    """The JAX init's tree (numpy) with wide margins: the router's and
    ``lm_head``'s for a MoE model, ``lm_head``'s for the others."""
    cfg = jax_get_config(arch).reduced()
    tree = jax.tree.map(np.asarray, jax_init_model(jax.random.PRNGKey(0),
                                                   cfg))
    widen = widen_margins if cfg.is_moe else legs.widen_head
    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        widen(tree, cfg))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"jax": {(arch, mesh): record}, mesh: every rank's {arch: record}}."""
    tmp = tmp_path_factory.mktemp("dist_tp")
    trees = {a: jax_tree(a) for a in legs.SERVE_ARCHS}
    batches = {a: legs.serve_batches(get_config(a).reduced())
               for a in legs.SERVE_ARCHS}
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump((trees, batches), f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               TP_CAPTURE=legs.CAPTURE,
               TP_MOE_KW=repr(legs.MOE_SERVE_KW),
               TP_DENSE_KW=repr(legs.DENSE_SERVE_KW), TP_NEW=repr(legs.NEW),
               TP_STEP_S=repr(legs.STEP_S),
               TP_MESHES=repr(legs.SERVE_MESHES),
               TP_ARCHS=repr(legs.SERVE_ARCHS))
    proc = subprocess.Popen([sys.executable, "-c", textwrap.dedent(SUB),
                             str(tmp / "in.pkl"), str(tmp / "jax.pkl")],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    out = {}
    try:
        for shape in legs.SERVE_MESHES:
            out[shape] = mesh_mod.spawn(
                legs.run_serve_rank, (trees, legs.SERVE_ARCHS),
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


def _logits_close(got, want, what):
    np.testing.assert_allclose(got, want, atol=LOGIT_ATOL, rtol=LOGIT_RTOL,
                               err_msg=what)
    np.testing.assert_array_equal(np.argmax(got, -1), np.argmax(want, -1),
                                  err_msg=what)


CASES = [(a, m) for m in legs.SERVE_MESHES for a in legs.SERVE_ARCHS]


@pytest.mark.parametrize("arch,shape", CASES)
def test_tensor_parallel_engine_matches_meshed_jax(runs, arch, shape):
    rec, ref = runs[shape][0][arch], runs["jax"][(arch, shape)]
    assert rec["tokens"] == ref["tokens"]
    assert len(rec["prefill"]) == len(ref["prefill"]) == legs.BATCHES
    assert len(rec["decode"]) == len(ref["decode"]) == legs.BATCHES * (
        legs.NEW - 1)
    for k, (a, b) in enumerate(zip(rec["prefill"], ref["prefill"])):
        _logits_close(a, b, f"prefill {k}")
    for k, (a, b) in enumerate(zip(rec["decode"], ref["decode"])):
        _logits_close(a, b, f"decode {k}")
    for r, other in enumerate(runs[shape][1:], 1):       # every rank alike
        assert other[arch]["tokens"] == rec["tokens"], r


@pytest.mark.parametrize("arch,shape", CASES)
def test_each_rank_holds_its_blocks(runs, arch, shape):
    """The bytes a process holds are the sum of its ``shard_tensor``
    blocks, below the whole model's; every head projection used gathered
    is one ``gathered_leaves`` names, and every one it names is."""
    cfg = get_config(arch).reduced()
    ranks = runs[shape]
    for r, rank in enumerate(ranks):
        got = rank[arch]
        assert got["bytes"]["held"] == got["bytes"]["blocks"], r
        gathered = {n.split(".", 2)[2] if n.startswith("layers.") else
                    "enc." + n.split(".", 2)[2]
                    for n, u in got["uses"].items() if u == "gathered"}
        assert gathered == set(legs.gathered_leaves(cfg, shape[1])), r
        assert "col" in got["uses"].values() and "row" in \
            got["uses"].values(), r
        assert got["uses"]["embed"] == "vocab"


def test_gathered_leaves_at_published_widths():
    """The table of PERF.md: at "model" 4 recurrentgemma-2b gathers its
    local layers' wq, wk and wv; no other config of the registry gathers
    any, and ``reduced()`` gathers wk and wv (two KV heads)."""
    from repro_torch.configs.registry import ALL_ARCHS

    for name in ALL_ARCHS:
        cfg = get_config(name)
        want = {"wq", "wk", "wv"} if name == "recurrentgemma-2b" else set()
        assert set(legs.gathered_leaves(cfg, 4)) == want, name
        assert set(legs.gathered_leaves(cfg, 2)) == (
            {"wk", "wv"} if name == "recurrentgemma-2b" else set()), name
    assert set(legs.gathered_leaves(get_config("mixtral-8x7b").reduced(), 4)) \
        == {"wk", "wv"}
    assert legs.gathered_leaves(get_config("mixtral-8x7b").reduced(), 2) == []


def test_launch_serve_serves_a_dense_model_over_gloo_processes():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen1.5-0.5b", "--reduced", "--device", "cpu", "--data-mesh", "2",
         "--model-mesh", "2", "--backend", "gloo", "--requests", "5",
         "--batch", "2", "--seq", "16", "--new-tokens", "4",
         "--shard-params", "specs"],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = proc.stdout
    assert "parameters 'specs' over a 2x2 mesh of processes (gloo, cpu" \
        in out
    assert "served 5 requests in 3 batches on cpu" in out
    assert out.count("served") == 1                  # rank 0 reports alone


def test_serving_refuses_fsdp_storage():
    """FSDP storage serves (tests/test_torch_dist_fsdp_serve.py holds it
    against the meshed JAX engines): ``--shard-params fsdp`` on a (2, 2)
    gloo world serves every request; a layout without a process mesh is
    refused, and names the backends."""
    from repro_torch.launch import serve as launch_serve

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen1.5-0.5b", "--reduced", "--device", "cpu", "--data-mesh", "2",
         "--model-mesh", "2", "--backend", "gloo", "--requests", "5",
         "--batch", "2", "--seq", "16", "--new-tokens", "4",
         "--shard-params", "fsdp"],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = proc.stdout
    assert "parameters 'fsdp' over a 2x2 mesh of processes (gloo, cpu" in out
    assert "served 5 requests in 3 batches on cpu" in out
    assert out.count("served") == 1                  # rank 0 reports alone
    with pytest.raises(ValueError, match="name --backend gloo or nccl"):
        launch_serve.main(["--arch", "qwen1.5-0.5b", "--reduced", "--device",
                           "cpu", "--shard-params", "specs"])
