"""The port's sharding rules (``repro_torch.sharding``) against the JAX
package's ``repro.sharding``, on shapes alone.

For every config of the registry at its published shapes (``jax.eval_shape``
of the JAX ``init_model``: nothing is allocated), on mesh shapes (2, 4) and
(16, 16) (a stand-in with ``.shape``: the JAX ``_sanitize`` reads only
``mesh.shape[axis]``), with and without ``fsdp_axes=("data",)`` and
``expert_tp_axes=("data",)``: the port's ``param_specs`` over the
flattened ``{path: shape}`` mapping equals ``tuple()`` of every
``PartitionSpec`` the JAX ``param_specs`` gives for the tree, path by path.
A reduced model's own parameters, through ``bridge.params_to_jax``, give
the same specs as the JAX init's tree. ``shard_tensor`` cuts the blocks
that tile the whole parameter back, and ``init_model(expert_block=...)``
keeps the whole model's experts of its block.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import sharding as jsharding  # noqa: E402
from repro.configs.registry import ALL_ARCHS  # noqa: E402
from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models.transformer import init_model as jax_init_model  # noqa: E402
from repro_torch import sharding  # noqa: E402
from repro_torch.bridge import params_to_jax  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.transformer import init_model  # noqa: E402


class _Mesh:
    """A mesh stand-in: axis name -> size."""

    def __init__(self, data, model):
        self.shape = {"data": data, "model": model}


MESHES = {"2x4": _Mesh(2, 4), "16x16": _Mesh(16, 16)}
OPTIONS = {"plain": {}, "fsdp": {"fsdp_axes": ("data",)},
           "expert_tp": {"expert_tp_axes": ("data",)},
           "fsdp_expert_tp": {"fsdp_axes": ("data",),
                              "expert_tp_axes": ("data",)}}
_SHAPES = {}


def _abstract(arch):
    if arch not in _SHAPES:
        cfg = jax_get_config(arch)
        _SHAPES[arch] = jax.eval_shape(
            lambda k: jax_init_model(k, cfg), jax.random.PRNGKey(0))
    return _SHAPES[arch]


def _jax_specs(tree, mesh, opts):
    kw = dict(opts)
    if "fsdp_axes" in kw:
        kw["fsdp_size"] = mesh.shape["data"]
    specs = jsharding.param_specs(tree, mesh=mesh, **kw)
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, P))
    out = {}
    for kp, spec in flat:
        parts = [str(getattr(k, "key", getattr(k, "idx", k))) for k in kp]
        out["/".join(parts)] = tuple(spec)
    return out


def _port_specs(tree, mesh, opts):
    kw = dict(opts)
    if "fsdp_axes" in kw:
        kw["fsdp_size"] = mesh.shape["data"]
    return sharding.param_specs(sharding.flatten_paths(tree), mesh=mesh, **kw)


CASES = list(itertools.product(ALL_ARCHS, MESHES, OPTIONS))


@pytest.mark.parametrize("arch,mesh,opts", CASES,
                         ids=[f"{a}-{m}-{o}" for a, m, o in CASES])
def test_param_specs_match_jax(arch, mesh, opts):
    tree = _abstract(arch)
    want = _jax_specs(tree, MESHES[mesh], OPTIONS[opts])
    got = _port_specs(tree, MESHES[mesh], OPTIONS[opts])
    assert got == want


def test_registry_has_thirteen_configs():
    assert len(ALL_ARCHS) == 13


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen1.5-0.5b",
                                  "recurrentgemma-2b"])
def test_reduced_model_params_give_jax_specs(arch):
    """The port model's own tree (``params_to_jax``) gives the specs the
    JAX init's tree gives, for every option on the (2, 4) mesh."""
    cfg = get_config(arch).reduced()
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    tree = params_to_jax(model)
    jtree = jax.eval_shape(lambda k: jax_init_model(
        k, jax_get_config(arch).reduced()), jax.random.PRNGKey(0))
    for opts in OPTIONS.values():
        got = _port_specs(tree, MESHES["2x4"], opts)
        want = _jax_specs(jtree, MESHES["2x4"], opts)
        assert got == {k: v for k, v in want.items() if k in got}
        assert set(got) <= set(want)


def test_experts_are_expert_parallel_and_batch_over_data():
    specs = sharding.param_specs(
        {"layers/moe/experts/w_up": (32, 8, 4096, 14336),
         "embed/table": (32000, 4096)}, mesh=MESHES["2x4"])
    assert specs["layers/moe/experts/w_up"] == (None, "model", None, None)
    assert specs["embed/table"] == ("model", None)
    assert sharding.batch_axes(MESHES["2x4"]) == ("data",)
    assert sharding.act_spec(MESHES["2x4"]) == tuple(
        jsharding.act_spec(jax.make_mesh((1, 1), ("data", "model"))))
    assert sharding.act_spec(MESHES["2x4"], seq_over_model=True) == (
        "data", "model", None)


@pytest.mark.parametrize("spec", [("model", None, None), (None, "model"),
                                  (("data", "model"), None), ()])
def test_shard_tensor_blocks_tile_the_parameter(spec):
    mesh = MESHES["2x4"]
    full = np.arange(16 * 8 * 3).reshape(16, 8, 3)
    full = full[:, :, 0] if len(spec) == 2 else full
    blocks = {}
    for d, m in itertools.product(range(2), range(4)):
        blocks[d, m] = sharding.shard_tensor(full, spec,
                                             {"data": d, "model": m}, mesh)
    if spec == ():
        assert all(np.array_equal(b, full) for b in blocks.values())
    elif spec == ("model", None, None):
        np.testing.assert_array_equal(
            np.concatenate([blocks[0, m] for m in range(4)]), full)
        assert all(np.array_equal(blocks[0, m], blocks[1, m])
                   for m in range(4))
    elif spec == (None, "model"):
        np.testing.assert_array_equal(
            np.concatenate([blocks[0, m] for m in range(4)], axis=1), full)
    else:                          # row-major over (data, model)
        np.testing.assert_array_equal(
            np.concatenate([blocks[d, m] for d in range(2)
                            for m in range(4)]), full)
    with pytest.raises(ValueError, match="does not split"):
        sharding.shard_tensor(np.zeros((6, 2)), ("model", None),
                              {"model": 0}, mesh)


def test_init_model_keeps_its_block_of_the_whole_models_experts():
    cfg = get_config("mixtral-8x7b").reduced()
    whole = init_model(cfg, torch.Generator().manual_seed(3), device="cpu")
    mesh = _Mesh(1, 4)
    for m in range(4):
        block = sharding.expert_block(cfg.moe.num_experts, {"model": m}, mesh)
        part = init_model(cfg, torch.Generator().manual_seed(3), device="cpu",
                          expert_block=block)
        for a, b in zip(whole.layers, part.layers):
            for k in ("w_gate", "w_up", "w_down"):
                assert torch.equal(getattr(b, k),
                                   getattr(a, k)[block[0]:block[1]])
            assert torch.equal(a.wq, b.wq) and torch.equal(a.router, b.router)
        assert torch.equal(whole.lm_head, part.lm_head)
