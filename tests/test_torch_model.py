"""The PyTorch port's model against the JAX package's, on reduced Mixtral
with the same (bridged) weights.

A slot prefill (``last_pos`` and ``token_weight`` in use) and three paged
decode steps, teacher-forced with the same tokens, go through the JAX step
functions and the port's. Logits are bf16 in both; they agree within
``LOGIT_ATOL`` (a few bf16 ulps of logits of magnitude ~3: the two
frameworks round bf16 products and sums at different places). The
per-layer expert counts must be equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models.transformer import Runtime as JaxRuntime  # noqa: E402
from repro.models.transformer import init_cache as jax_init_cache  # noqa: E402
from repro.models.transformer import init_model as jax_init_model  # noqa: E402
from repro.serve import kvcache as jkv  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch.bridge import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.models.transformer import Runtime, init_model  # noqa: E402
from repro_torch.serve import kvcache as tkv  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

LOGIT_ATOL = 5e-2
S, BS, MAXLEN = 32, 8, 64


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("mixtral-8x7b").reduced()
    cfg = get_config("mixtral-8x7b").reduced()
    params = jax_init_model(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    return jcfg, params, cfg, params_from_jax(tree, cfg, device="cpu"), tree


def test_bridge_round_trips_bit_exactly(models):
    _, _, cfg, model, tree = models
    back = params_to_jax(model)
    again = params_from_jax(back, cfg, device="cpu")
    for (name, a), (name_b, b) in zip(model.named_parameters(),
                                      again.named_parameters()):
        assert name == name_b and a.dtype == b.dtype and torch.equal(a, b), name
    # tree -> port -> tree: fp32 leaves exactly, bf16-stored leaves as their
    # bf16 rounding (the value the reference computes with)
    flat_t = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_t) == len(flat_b)
    for path, leaf in flat_t:
        keys = "/".join(str(getattr(k, "key", k)) for k in path)
        rounded = np.asarray(jnp.asarray(leaf, jnp.bfloat16), np.float32)
        fp32 = "scale" in keys or "router" in keys
        np.testing.assert_array_equal(flat_b[path], leaf if fp32 else rounded,
                                      err_msg=keys)


def test_init_model_dtypes_and_scales():
    cfg = get_config("mixtral-8x7b").reduced()
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    layer = model.layers[0]
    assert model.embed.dtype == torch.bfloat16
    assert layer.router.dtype == torch.float32 and layer.ln1.dtype == torch.float32
    assert torch.equal(layer.ln1, torch.ones_like(layer.ln1))
    # truncated normal in [-2, 2] x scale: std 0.8796 x scale
    w = layer.w_gate.float()
    scale = 1 / np.sqrt(cfg.d_model)
    assert float(w.abs().max()) <= 2 * scale * 1.01
    assert abs(float(w.std()) / scale - 0.8796) < 0.02
    again = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(again.layers[1].w_down, model.layers[1].w_down)


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = get_config("mixtral-8x7b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tkv.init_block_pool(cfg, 4, 8)


def _run_jax(jcfg, params, prompts, forced):
    rt = JaxRuntime(window_override=MAXLEN)
    prefill = jsteps.make_slot_prefill_step(jcfg, rt)
    decode = jsteps.make_paged_decode_step(jcfg, rt)
    B = len(prompts) + 1                                  # last slot idle
    M = MAXLEN // BS
    pool = jkv.init_block_pool(jcfg, 1 + B * M, BS)
    tables = np.zeros((B, M), np.int32)
    logits, counts = [], []
    for b, p in enumerate(prompts):
        tables[b] = 1 + b * M + np.arange(M)
        toks = np.zeros((1, S), np.int32)
        toks[0, :len(p)] = p
        tw = (np.arange(S) < len(p)).astype(np.float32)[None]
        temp = jax_init_cache(jcfg, rt, 1, S)
        _, lg, temp, st = prefill(params, {"tokens": jnp.asarray(toks)}, temp,
                                  last_pos=jnp.asarray([len(p) - 1]),
                                  token_weight=jnp.asarray(tw))
        pool = jkv.write_prefill_blocks(pool, temp,
                                        jnp.asarray(tables[b, :S // BS]))
        logits.append(np.asarray(lg, np.float32))
        counts.append(np.asarray(st["expert_counts"]))
    lengths = np.asarray([len(p) for p in prompts] + [0], np.int32)
    active = (lengths > 0).astype(np.float32)[:, None]
    for t in range(forced.shape[1]):
        _, lg, pool, st = decode(params, jnp.asarray(forced[:, t:t + 1]), pool,
                                 jnp.asarray(tables), jnp.asarray(lengths),
                                 token_weight=jnp.asarray(active))
        logits.append(np.asarray(lg, np.float32))
        counts.append(np.asarray(st["expert_counts"]))
        lengths = lengths + (lengths > 0)
    return logits, counts


def _run_torch(cfg, model, prompts, forced):
    rt = Runtime(window_override=MAXLEN)
    prefill = tsteps.make_slot_prefill_step(cfg, rt)
    decode = tsteps.make_paged_decode_step(cfg, rt)
    B = len(prompts) + 1
    M = MAXLEN // BS
    pool = tkv.init_block_pool(cfg, 1 + B * M, BS, device="cpu")
    tables = np.zeros((B, M), np.int32)
    logits, counts = [], []
    for b, p in enumerate(prompts):
        tables[b] = 1 + b * M + np.arange(M)
        toks = np.zeros((1, S), np.int32)
        toks[0, :len(p)] = p
        tw = (np.arange(S) < len(p)).astype(np.float32)[None]
        _, lg, temp, st = prefill(model, torch.tensor(toks), None,
                                  torch.tensor([len(p) - 1]), torch.tensor(tw))
        tkv.write_prefill_blocks(pool, temp, tables[b, :S // BS])
        logits.append(lg.float().numpy())
        counts.append(st["expert_counts"].numpy())
    lengths = np.asarray([len(p) for p in prompts] + [0], np.int32)
    active = (lengths > 0).astype(np.float32)[:, None]
    for t in range(forced.shape[1]):
        _, lg, pool, st = decode(model, torch.tensor(forced[:, t:t + 1]), pool,
                                 torch.tensor(tables), torch.tensor(lengths),
                                 torch.tensor(active))
        logits.append(lg.float().numpy())
        counts.append(st["expert_counts"].numpy())
        lengths = lengths + (lengths > 0)
    return logits, counts, pool


def test_prefill_and_paged_decode_match_jax(models):
    jcfg, params, cfg, model, _ = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (20, 13)]
    forced = rng.integers(0, cfg.vocab_size, (3, 3)).astype(np.int32)
    forced[-1] = 0                                        # the idle slot
    lj, cj = _run_jax(jcfg, params, prompts, forced)
    lt, ct, pool = _run_torch(cfg, model, prompts, forced)
    assert len(lj) == len(lt) == 2 + 3
    for step, (a, b) in enumerate(zip(lj, lt)):
        assert a.shape == b.shape and np.isfinite(b).all()
        live = slice(None) if step < 2 else slice(0, 2)   # idle slot masked
        np.testing.assert_allclose(b[live], a[live], atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"step {step}")
    for step, (a, b) in enumerate(zip(cj, ct)):
        assert b.shape == (cfg.num_layers, cfg.moe.num_experts)
        np.testing.assert_array_equal(b, a, err_msg=f"counts, step {step}")
    # prefill counts weigh only real tokens; decode counts only live slots
    np.testing.assert_array_equal(ct[0].sum(-1), 20 * cfg.moe.top_k)
    np.testing.assert_array_equal(ct[2].sum(-1), 2 * cfg.moe.top_k)
    # the idle slot's table row is all null block: block 0 stays clean
    assert float(pool["k"][:, 0].abs().max()) == 0.0
