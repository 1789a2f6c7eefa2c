"""The PyTorch port's Griffin serving path against the JAX package, on
reduced RecurrentGemma (3 layers: recurrent, recurrent, local; d 256, rnn
width 256, local window 32) with the same (bridged) weights and the same
numpy inputs.

Tolerances, each with its reason:

* ``_causal_conv``: bit for bit (both round every bf16 product and sum, in
  the same order).
* ``rg_lru`` / ``rg_lru_step``: fp32 state within 1e-4 (``tests/
  test_kernels.py``'s tolerance: a sequential scan against JAX's
  associative scan), bf16 output within one bf16 ulp.
* ``recurrent_block`` and the windowed attention: outputs within two bf16
  ulps and states within 5e-3 — torch and XLA round a few bf16 dot
  products differently by one ulp, and a one-ulp change of the projection
  moves the RG-LRU state (which follows ``i * x`` closely) by about that
  much.
* model logits within ``LOGIT_ATOL`` = 5e-2, as ``tests/test_torch_model.py``.
* generated tokens equal up to the first difference, which must be a near
  tie of the JAX logits; then both engines are teacher-forced with the
  JAX tokens and their logits held within ``LOGIT_ATOL`` at every step.
* reduced Mixtral through ``ServeEngine`` (dist_only): estimator counts
  allclose and plan stacks equal after every batch, against the JAX engine
  run op by op (see the test).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import griffin as jgriffin  # noqa: E402
from repro.models.transformer import Runtime as JaxRuntime  # noqa: E402
from repro.models.transformer import forward as jax_forward  # noqa: E402
from repro.models.transformer import init_cache as jax_init_cache  # noqa: E402
from repro.models.transformer import init_model as jax_init_model  # noqa: E402
from repro.serve import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serve import ServeEngine as JaxServeEngine  # noqa: E402
from repro_torch.bridge import params_from_jax, params_to_jax  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import griffin as tgriffin  # noqa: E402
from repro_torch.models.transformer import (Runtime, forward,  # noqa: E402
                                            init_cache, init_model)
from repro_torch.serve import ServeConfig, ServeEngine  # noqa: E402

LOGIT_ATOL = 5e-2
ARCH = "recurrentgemma-2b"
PLAN_FIELDS = ("n_replicas", "replica_table", "pool_expert", "pool_sel")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The reduced model's operations are tiny: one intra-op thread runs
    them as fast as many, and keeps this file from oversubscribing the
    cores when test workers run side by side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(a):
    return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16)


def _np(t):
    return np.asarray(t.float().numpy() if torch.is_tensor(t) else t,
                      np.float32)


def _ulps(got, want):
    """|got - want| in bf16 ulps of ``want``."""
    got, want = _np(got), _np(want)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    return float((np.abs(got - want) / ulp).max())


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    params = jax_init_model(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, params)
    return jcfg, params, cfg, params_from_jax(tree, cfg, device="cpu"), tree


@pytest.fixture(scope="module")
def block():
    """One recurrent block's weights (a nonzero conv bias, unlike the init,
    so the bias path is exercised), as the JAX tree and the port's dict."""
    jcfg = jax_get_config(ARCH).reduced()
    tree = jax.tree.map(np.asarray, jgriffin.init_recurrent_block(
        jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(3)
    tree["conv_b"] = (rng.normal(size=tree["conv_b"].shape) * 0.1
                      ).astype(np.float32)
    shapes = tgriffin.param_shapes(jcfg)
    port = {k: torch.tensor(np.asarray(v["w"] if isinstance(v, dict) else v,
                                       np.float32)).to(shapes[k][2])
            for k, v in tree.items()}
    return jcfg, jax.tree.map(jnp.asarray, tree), port


def test_config_matches_jax_config():
    for reduce in (False, True):
        j, t = jax_get_config(ARCH), get_config(ARCH)
        if reduce:
            j, t = j.reduced(), t.reduced()
        for f in dataclasses.fields(t):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    r = get_config(ARCH).reduced()
    assert (r.num_layers, r.local_window, r.rnn_width) == (3, 32, 256)


# --------------------------------------------------------------------------
# the recurrent block's pieces
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S", [1, 5, 37])
def test_causal_conv_is_bit_exact(block, S):
    _, jp, tp = block
    rng = np.random.default_rng(S)
    x = rng.normal(size=(2, S, 256)).astype(np.float32)
    st = rng.normal(size=(2, 3, 256)).astype(np.float32)
    jo, js = jgriffin._causal_conv(jp, jnp.asarray(x, jnp.bfloat16),
                                   jnp.asarray(st, jnp.bfloat16))
    to, ts = tgriffin._causal_conv(tp, _bf16(x), _bf16(st))
    assert to.dtype == ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(to), _np(jo))
    np.testing.assert_array_equal(_np(ts), _np(js))


@pytest.mark.parametrize("S", [2, 37])
def test_rg_lru_matches_jax(block, S):
    _, jp, tp = block
    rng = np.random.default_rng(10 + S)
    x = rng.normal(size=(2, S, 256)).astype(np.float32)
    h0 = rng.normal(size=(2, 256)).astype(np.float32)
    ops.reset_launches()
    ty, th = tgriffin.rg_lru(tp, _bf16(x), torch.tensor(h0))
    jy, jh = jgriffin.rg_lru(jp, jnp.asarray(x, jnp.bfloat16), jnp.asarray(h0))
    assert ty.dtype == torch.bfloat16 and th.dtype == torch.float32
    assert _ulps(ty, jy) <= 1.0
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4,
                               rtol=1e-4)
    assert ops.LAUNCHES["rg_lru_scan"] == 0          # CPU: the plain version


def test_rg_lru_step_matches_jax(block):
    _, jp, tp = block
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3, 1, 256)).astype(np.float32)
    h0 = rng.normal(size=(3, 256)).astype(np.float32)
    ty, th = tgriffin.rg_lru_step(tp, _bf16(x), torch.tensor(h0))
    jy, jh = jgriffin.rg_lru_step(jp, jnp.asarray(x, jnp.bfloat16),
                                  jnp.asarray(h0))
    assert tuple(ty.shape) == (3, 1, 256)
    assert _ulps(ty, jy) <= 1.0
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("S", [1, 37])
def test_recurrent_block_matches_jax(block, S, monkeypatch):
    jcfg, jp, tp = block
    rng = np.random.default_rng(20 + S)
    x = rng.normal(size=(2, S, 256)).astype(np.float32)
    h0 = rng.normal(size=(2, 256)).astype(np.float32)
    st = rng.normal(size=(2, 3, 256)).astype(np.float32)
    scans = []
    scan = tgriffin.kernel_ops.rg_lru_scan
    monkeypatch.setattr(tgriffin.kernel_ops, "rg_lru_scan",
                        lambda *a: scans.append(a[0].shape) or scan(*a))
    state = {"h": torch.tensor(h0), "conv": _bf16(st)}
    to, tst = tgriffin.recurrent_block(tp, jcfg, _bf16(x), state)
    jo, jst = jgriffin.recurrent_block(
        jp, jcfg, jnp.asarray(x, jnp.bfloat16),
        {"h": jnp.asarray(h0), "conv": jnp.asarray(st, jnp.bfloat16)})
    # a one-token call takes the step and runs no scan
    assert len(scans) == (0 if S == 1 else 1)
    assert torch.equal(state["h"], torch.tensor(h0))  # input state untouched
    assert _ulps(to, jo) <= 2.0
    np.testing.assert_allclose(tst["h"].numpy(), np.asarray(jst["h"]),
                               atol=5e-3, rtol=0)
    assert _ulps(tst["conv"], jst["conv"]) <= 1.0


# --------------------------------------------------------------------------
# local attention over the rotating window buffer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("W", [32, 48])
def test_windowed_prefill_and_decode_match_jax(model, W):
    """W = window: the rotating buffer, with a 45-token prompt longer than
    the window and decode steps that wrap it. W > window: the linear
    fallback with the window as a mask."""
    jcfg, params, cfg, tmodel, _ = model
    window = cfg.local_window
    jp = params["hybrid_layers"][2]["attn"]
    tp = tmodel.layers[2].attn_params()
    rng = np.random.default_rng(W)
    B, S, n_dec = 2, 45 if W == window else 40, 5
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    xd = rng.normal(size=(n_dec, B, 1, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S))
    jc = jattn.init_gqa_cache(jcfg, B, W)
    tc = tattn.init_gqa_cache(cfg, B, W, device="cpu")
    jo, jc = jattn.gqa_prefill_windowed(jp, jcfg, jnp.asarray(x, jnp.bfloat16),
                                        jnp.asarray(pos), jc, window=window)
    to = tattn.gqa_prefill_windowed(tp, cfg, _bf16(x), torch.tensor(pos).long(),
                                    tc, window=window)
    assert _ulps(to, jo) <= 2.0
    for t in range(n_dec):
        jo, jc = jattn.gqa_decode_windowed(jp, jcfg,
                                           jnp.asarray(xd[t], jnp.bfloat16),
                                           jc, S + t, window=window)
        to = tattn.gqa_decode_windowed(tp, cfg, _bf16(xd[t]), tc, S + t,
                                       window=window)
        np.testing.assert_allclose(_np(to), _np(jo), atol=1e-2, rtol=1e-2,
                                   err_msg=f"decode step {t}")
    for n in ("k", "v"):
        assert _ulps(tc[n], jc[n]) <= 1.0, n
    if W == window:
        # slot p % W holds position p: the newest token sits at (S+4) % W
        assert (S + n_dec - 1) % W == 17


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def test_bridge_round_trips_hybrid_weights(model):
    _, _, cfg, tmodel, tree = model
    back = params_to_jax(tmodel)
    again = params_from_jax(back, cfg, device="cpu")
    for (name, a), (name_b, b) in zip(tmodel.named_parameters(),
                                      again.named_parameters()):
        assert name == name_b and a.dtype == b.dtype and torch.equal(a, b), name
    flat_t = jax.tree_util.tree_flatten_with_path(tree)[0]
    flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_t) == len(flat_b)
    for path, leaf in flat_t:
        keys = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        fp32 = "scale" in keys or keys.endswith("lam")
        rounded = np.asarray(jnp.asarray(leaf, jnp.bfloat16), np.float32)
        np.testing.assert_array_equal(flat_b[path], leaf if fp32 else rounded,
                                      err_msg=keys)
    layer0 = tmodel.layers[0]
    assert layer0.kind == "recurrent" and tmodel.layers[2].kind == "local"
    assert layer0.rec_lam.dtype == torch.float32
    assert layer0.rec_conv_w.dtype == layer0.rec_conv_b.dtype == torch.bfloat16


def test_init_model_and_cache_for_hybrid():
    cfg = get_config(ARCH).reduced()
    m = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    kinds = [layer.kind for layer in m.layers]
    assert kinds == ["recurrent", "recurrent", "local"]
    lam = m.layers[0].rec_lam
    assert lam.dtype == torch.float32 and 3.0 <= float(lam.min()) \
        and float(lam.max()) <= 5.0                       # N(0, .5) in +-2 sd, + 4
    assert float(m.layers[1].rec_conv_b.abs().max()) == 0.0
    cache = init_cache(cfg, Runtime(), 2, 100, device="cpu")
    assert cache[0]["h"].shape == (2, 256) and cache[0]["h"].dtype == torch.float32
    assert cache[1]["conv"].shape == (2, 3, 256)
    assert cache[2]["k"].shape == (2, 32, 1, 64)          # W = min(100, 32)
    assert init_cache(cfg, Runtime(), 1, 20, device="cpu")[2]["k"].shape[1] == 20


def _jax_run(jcfg, params, prompts, forced, max_len):
    rt = JaxRuntime()
    cache = jax_init_cache(jcfg, rt, prompts.shape[0], max_len)
    lg, cache, _ = jax_forward(params, jcfg, {"tokens": jnp.asarray(prompts)},
                               rt, mode="prefill", cache=cache)
    out = [np.asarray(lg, np.float32)]
    for t in range(forced.shape[1]):
        lg, cache, _ = jax_forward(params, jcfg,
                                   {"tokens": jnp.asarray(forced[:, t:t + 1])},
                                   rt, mode="decode", cache=cache,
                                   cache_len=prompts.shape[1] + t)
        out.append(np.asarray(lg, np.float32))
    return out


def _torch_run(cfg, tmodel, prompts, forced, max_len):
    rt = Runtime()
    cache = init_cache(cfg, rt, prompts.shape[0], max_len, device="cpu")
    with torch.inference_mode():
        lg, cache, st = forward(tmodel, cfg, torch.tensor(prompts), rt,
                                mode="prefill", cache=cache)
        assert st["expert_counts"] is None
        out = [lg.float().numpy()]
        for t in range(forced.shape[1]):
            lg, cache, _ = forward(tmodel, cfg,
                                   torch.tensor(forced[:, t:t + 1]), rt,
                                   mode="decode", cache=cache,
                                   cache_len=prompts.shape[1] + t)
            out.append(lg.float().numpy())
    return out


@pytest.mark.parametrize("S", [20, 45])
def test_hybrid_forward_matches_jax(model, S):
    """Prefill (a prompt shorter, then longer, than the window) and five
    teacher-forced decode steps, the second case wrapping the buffer."""
    jcfg, params, cfg, tmodel, _ = model
    rng = np.random.default_rng(S)
    prompts = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    lj = _jax_run(jcfg, params, prompts, forced, S + 5)
    lt = _torch_run(cfg, tmodel, prompts, forced, S + 5)
    for step, (a, b) in enumerate(zip(lj, lt)):
        assert b.shape == a.shape == (2, 1, cfg.vocab_size)
        assert np.isfinite(b).all()
        np.testing.assert_allclose(b, a, atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"step {step}")


# --------------------------------------------------------------------------
# ServeEngine
# --------------------------------------------------------------------------

def _jax_teacher_forced(eng, prompts, tokens):
    """JAX engine's prefill + decode steps fed ``tokens``; per-step logits."""
    logits, cache, _ = eng.prefill({"tokens": jnp.asarray(prompts)})
    out = [np.asarray(logits, np.float32)]
    for t in range(tokens.shape[1] - 1):
        _, lg, cache, _ = eng.decode(jnp.asarray(tokens[:, t:t + 1]), cache,
                                     prompts.shape[1] + t)
        out.append(np.asarray(lg, np.float32))
    return out


def _torch_teacher_forced(eng, prompts, tokens):
    logits, cache, _ = eng.prefill({"tokens": prompts})
    out = [logits.float().numpy()]
    for t in range(tokens.shape[1] - 1):
        _, lg, cache, _ = eng.decode(torch.tensor(tokens[:, t:t + 1]), cache,
                                     prompts.shape[1] + t)
        out.append(lg.float().numpy())
    return out


def test_serve_engine_generate_matches_jax_for_griffin(model):
    jcfg, params, cfg, tmodel, _ = model
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, cfg.vocab_size, (2, 40)).astype(np.int32)
    new = 6
    jeng = JaxServeEngine(jcfg, params, JaxServeConfig(strategy="none",
                                                       max_len=40 + new))
    teng = ServeEngine(cfg, tmodel, ServeConfig(strategy="none",
                                                max_len=40 + new))
    jgen, jtele = jeng.generate({"tokens": jnp.asarray(prompts)},
                                max_new_tokens=new)
    ops.reset_launches()
    tgen, ttele = teng.generate({"tokens": prompts}, max_new_tokens=new)
    jgen = np.asarray(jgen)
    assert tgen.dtype == torch.int32 and tuple(tgen.shape) == (2, new)
    assert jtele == ttele == {} and teng.batches_seen == 1
    assert ops.LAUNCHES["rg_lru_scan"] == 0
    # both engines fed the JAX tokens: logits agree at every step
    lj = _jax_teacher_forced(jeng, prompts, jgen)
    lt = _torch_teacher_forced(teng, prompts, jgen)
    for step, (a, b) in enumerate(zip(lj, lt)):
        np.testing.assert_allclose(b, a, atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"step {step}")
    # generated tokens equal up to the first difference, a near tie
    tgen = tgen.numpy()
    for r in range(2):
        diff = np.nonzero(tgen[r] != jgen[r])[0]
        if len(diff):
            top2 = np.sort(lj[diff[0]][r, -1])[-2:]
            assert top2[1] - top2[0] <= 2 * LOGIT_ATOL, (r, diff[0])


def test_serve_engine_plans_match_jax_for_mixtral():
    """Reduced Mixtral through both engines, three batches, re-plan every
    batch: equal estimator counts and equal plan stacks after each. The JAX
    engine runs with jit disabled: under jit XLA keeps excess precision
    inside its fusions (``xla_allow_excess_precision``) where the port, like
    JAX op by op, rounds every bf16 result, and on these prompts that moves
    a few layer-0 routing decisions (jitted JAX against itself op by op as
    well)."""
    jcfg = jax_get_config("mixtral-8x7b").reduced()
    cfg = get_config("mixtral-8x7b").reduced()
    params = jax_init_model(jax.random.PRNGKey(1), jcfg)
    tmodel = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                             device="cpu")
    kw = dict(strategy="dist_only", predict_interval=1, max_len=24 + 3)
    jeng = JaxServeEngine(jcfg, params, JaxServeConfig(**kw), ep_ranks=2)
    teng = ServeEngine(cfg, tmodel, ServeConfig(**kw), ep_ranks=2)
    assert teng.moe_cfg.duplication_slots == 1
    rng = np.random.default_rng(11)
    replicated = 0
    for batch in range(3):
        prompts = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
        with jax.disable_jit():
            jgen, jtele = jeng.generate({"tokens": jnp.asarray(prompts)},
                                        max_new_tokens=3)
        tgen, ttele = teng.generate({"tokens": prompts}, max_new_tokens=3)
        np.testing.assert_allclose(teng.estimator.counts,
                                   jeng.estimator.counts, rtol=1e-6,
                                   atol=1e-6, err_msg=f"batch {batch}")
        for f in PLAN_FIELDS:
            np.testing.assert_array_equal(
                np.asarray(getattr(teng._plan_stack, f)),
                np.asarray(getattr(jeng._plan_stack, f)),
                err_msg=f"{f} after batch {batch}")
        assert ttele["batch"] == jtele["batch"] == batch + 1
        np.testing.assert_allclose(ttele["skew"], jtele["skew"], rtol=1e-6)
        replicated += int((np.asarray(teng._plan_stack.n_replicas) - 1).sum())
        assert tgen.shape == (2, 3)
    assert replicated > 0                     # the plans replicate experts
    loads = teng.rank_loads(np.ones((cfg.num_layers, 2 * (2 + 1))))
    assert loads.shape == (cfg.num_layers, 2) and (loads == 3).all()


def test_serve_config_rejects_what_is_not_ported():
    # every strategy of the JAX package is ported; an unknown one is refused
    assert ServeConfig(strategy="token_to_expert").strategy == \
        "token_to_expert"
    with pytest.raises(ValueError, match="token_to_expert"):
        ServeConfig(strategy="oracle")


@pytest.mark.parametrize("arch", [ARCH, "mixtral-8x7b"])
def test_launch_serve_main_on_cpu(arch, capsys):
    rc = launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                            "--requests", "3", "--batch", "2", "--seq", "36",
                            "--new-tokens", "3"])
    assert rc == 0
    assert "served 3 requests in 2 batches on cpu" in capsys.readouterr().out


def test_launch_serve_needs_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--arch", ARCH, "--reduced"])
