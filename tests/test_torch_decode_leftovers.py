"""Two small pieces of the JAX package the port had left out, against the
JAX package on the CPU: the slotted linear-cache decode
(``models.attention.gqa_decode_multi``, and ``forward`` taking it for a
(B,) ``cache_len`` without block tables), the ``paged_attn_impl="gather"``
oracle of paged decode, and the trace schema check's command line
(``repro_torch.obs.validate``).

Tolerances: ``gqa_decode_multi`` and the paged decode within 1e-5 in fp32
(the same operations, summed in another order) and 1e-2 in bf16 (one bf16
ulp of outputs below 2), as ``tests/test_torch_paged_attention.py``;
through the whole model, logits within 5e-2 (``tests/test_torch_model.py``'s)
and the cache within 2e-2 in norm (the JAX forward's layer scan is jitted,
so the second layer's k / v come from a stream an ulp apart here and
there). The JAX functions run op by op here (no jit), so they round where
the port does. That "fused" launches the kernel on a card and "gather"
none is ``tests/test_torch_decode_leftovers_cuda.py``'s (no JAX there, as
the card's machine has none).
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models.transformer import Runtime as JaxRuntime  # noqa: E402
from repro.models.transformer import forward as jax_forward  # noqa: E402
from repro.models.transformer import init_model as jax_init_model  # noqa: E402
from repro.obs import validate as jax_validate  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.transformer import Runtime, forward, init_model  # noqa: E402
from repro_torch.obs import validate  # noqa: E402
from repro_torch.serve import (ContinuousConfig, ContinuousEngine,  # noqa: E402
                               ServeRequest)

TOL = {"float32": 1e-5, "bfloat16": 1e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LOGIT_ATOL = 5e-2
DIMS = dict(name="t", family="dense", num_layers=1, d_model=64, num_heads=8,
            num_kv_heads=2, d_ff=128, vocab_size=128)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _attn_params(jcfg, dtype):
    params = jax.tree.map(np.asarray, jattn.init_gqa(jax.random.PRNGKey(0),
                                                     jcfg))
    return ({k: {"w": jnp.asarray(v["w"], JNP[dtype])}
             for k, v in params.items()},
            {k: torch.tensor(v["w"]).to(TORCH[dtype])
             for k, v in params.items()})


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


# --------------------------------------------------------------------------
# gqa_decode_multi
# --------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_decode_multi_matches_jax(dtype, window):
    """Four slots at uneven lengths (an idle slot at 0, one at the last
    position) over a 32-position slotted cache: each writes its k / v at
    its own length and attends over its own prefix, windowed."""
    from repro.configs.base import ModelConfig as JCfg

    jcfg, tcfg = JCfg(**DIMS), ModelConfig(**DIMS)
    jp, tp = _attn_params(jcfg, dtype)
    lengths = np.asarray([0, 5, 13, 31], np.int32)
    B, S_max = len(lengths), 32
    rng = np.random.default_rng(3)
    shape = (B, S_max, jcfg.num_kv_heads, jcfg.head_dim)
    cache = {n: rng.normal(size=shape).astype(np.float32) for n in "kv"}
    x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
    out_j, cache_j = jattn.gqa_decode_multi(
        jp, jcfg, jnp.asarray(x, JNP[dtype]),
        {n: jnp.asarray(c, JNP[dtype]) for n, c in cache.items()},
        jnp.asarray(lengths), window=window)
    cache_t = {n: torch.tensor(c).to(TORCH[dtype]) for n, c in cache.items()}
    out_t = tattn.gqa_decode_multi(tp, tcfg, torch.tensor(x).to(TORCH[dtype]),
                                   cache_t, torch.tensor(lengths),
                                   window=window)
    _close(out_t, out_j, dtype)
    for n in "kv":
        _close(cache_t[n], cache_j[n], dtype)
        # each slot wrote its own position, and nothing else moved
        moved = (cache_t[n].float().numpy()
                 != torch.tensor(cache[n]).to(TORCH[dtype]).float().numpy()
                 ).any(axis=(2, 3))
        assert [list(np.nonzero(r)[0]) for r in moved] == [
            [int(ln)] for ln in lengths]


def test_forward_decodes_per_slot_without_block_tables():
    """``forward`` in decode mode with a (B,) ``cache_len`` and no block
    tables runs ``gqa_decode_multi`` at the architectural sliding window
    (qwen at ``reduced()`` with nonzero QKV biases and a window of 8),
    against the JAX forward on the same bridged weights and cache."""
    jcfg = dataclasses.replace(jax_get_config("qwen1.5-0.5b").reduced(),
                               sliding_window=8)
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              sliding_window=8)
    tree = jax.tree.map(np.asarray, jax_init_model(jax.random.PRNGKey(0),
                                                   jcfg))
    rng = np.random.default_rng(7)
    for n in ("wq", "wk", "wv"):
        b = tree["layers"]["attn"][n]["b"]
        tree["layers"]["attn"][n]["b"] = rng.normal(
            0, 0.5, b.shape).astype(np.float32)
    model = params_from_jax(tree, cfg, device="cpu")
    lengths = np.asarray([3, 20, 0, 9], np.int32)
    B, S_max = len(lengths), 24
    shape = (cfg.num_layers, B, S_max, cfg.num_kv_heads, cfg.head_dim)
    cache = {n: rng.normal(size=shape).astype(np.float32) for n in "kv"}
    tokens = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    want, cache_j, _ = jax_forward(
        jax.tree.map(jnp.asarray, tree), jcfg, {"tokens": jnp.asarray(tokens)},
        JaxRuntime(), mode="decode",
        cache={n: jnp.asarray(c, jnp.bfloat16) for n, c in cache.items()},
        cache_len=jnp.asarray(lengths))
    cache_t = {n: torch.tensor(c).to(torch.bfloat16) for n, c in cache.items()}
    calls = []
    real = tattn.gqa_decode_multi

    def spy(*a, **kw):
        calls.append(kw["window"])
        return real(*a, **kw)
    tattn.gqa_decode_multi = spy
    try:
        with torch.inference_mode():
            got, _, _ = forward(model, cfg, torch.tensor(tokens), Runtime(),
                                mode="decode", cache=cache_t,
                                cache_len=torch.tensor(lengths))
    finally:
        tattn.gqa_decode_multi = real
    assert calls == [8] * cfg.num_layers
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=LOGIT_ATOL, rtol=0)
    for n in "kv":
        got_c = cache_t[n].float().numpy()
        want_c = np.asarray(cache_j[n], np.float32)
        assert np.linalg.norm(got_c - want_c) <= 2e-2 * np.linalg.norm(
            want_c), n
        # each slot's new k / v went to its own position, in every layer
        moved = (got_c != torch.tensor(cache[n]).to(torch.bfloat16).float()
                 .numpy()).any(axis=(3, 4))
        assert [[list(np.nonzero(r)[0]) for r in layer] for layer in moved] \
            == [[[int(ln)] for ln in lengths]] * cfg.num_layers


# --------------------------------------------------------------------------
# paged_attn_impl="gather"
# --------------------------------------------------------------------------

def _paged_pair(impl, dtype, lengths, window):
    """One paged decode step through the JAX and the port's
    ``gqa_decode_paged`` under ``paged_attn_impl=impl`` (the JAX side
    "gather" always: its oracle), on the same weights, input and pool."""
    from repro.configs.base import ModelConfig as JCfg

    jcfg = JCfg(paged_attn_impl="gather", **DIMS)
    tcfg = ModelConfig(paged_attn_impl=impl, **DIMS)
    jp, tp = _attn_params(jcfg, dtype)
    B, M, bs = len(lengths), 4, 8
    rng = np.random.default_rng(5)
    shape = (1 + B * M, bs, jcfg.num_kv_heads, jcfg.head_dim)
    pool = {n: rng.normal(size=shape).astype(np.float32) for n in "kv"}
    for p in pool.values():
        p[0] = 0.0                                    # the null block
    tables = np.zeros((B, M), np.int32)
    for b, ln in enumerate(lengths):
        if ln > 0:
            tables[b] = 1 + b * M + rng.permutation(M)
    x = rng.normal(size=(B, 1, jcfg.d_model)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    out_j, pool_j = jattn.gqa_decode_paged(
        jp, jcfg, jnp.asarray(x, JNP[dtype]),
        {n: jnp.asarray(p, JNP[dtype]) for n, p in pool.items()},
        jnp.asarray(tables), jnp.asarray(lens), window=window)
    pool_t = {n: torch.tensor(p).to(TORCH[dtype]) for n, p in pool.items()}
    out_t = tattn.gqa_decode_paged(tp, tcfg, torch.tensor(x).to(TORCH[dtype]),
                                   pool_t, torch.tensor(tables),
                                   torch.tensor(lens), window=window)
    return (out_j, pool_j), (out_t, pool_t)


@pytest.mark.parametrize("window", [0, 12])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_matches_the_jax_gather_oracle_and_the_fused_plain_version(
        dtype, window):
    lengths = [3, 8, 0, 30]
    ops.reset_launches()
    (out_j, pool_j), (out_g, pool_g) = _paged_pair("gather", dtype, lengths,
                                                   window)
    _, (out_f, pool_f) = _paged_pair("fused", dtype, lengths, window)
    assert sum(ops.LAUNCHES.values()) == 0        # plain versions here
    _close(out_g, out_j, dtype)
    for n in "kv":
        _close(pool_g[n], pool_j[n], dtype)
        assert torch.equal(pool_g[n], pool_f[n])
    _close(out_f, out_g.float().numpy(), dtype)


def test_an_unknown_paged_attn_impl_raises():
    with pytest.raises(ValueError, match="paged_attn_impl"):
        _paged_pair("onehot", "float32", [3, 8], 0)


def _trace_run(impl):
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                              paged_attn_impl=impl)
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng = ContinuousEngine(cfg, model, ContinuousConfig(
        max_slots=2, prefill_len=16, block_size=8, max_len=32))
    rng = np.random.default_rng(1)
    reqs = [ServeRequest(rid=i, tokens=rng.integers(
        0, cfg.vocab_size, n).astype(np.int32), max_new_tokens=5)
        for i, n in enumerate((7, 12, 3))]
    for r in reqs:
        eng.submit(r)
    now = 0.0
    while eng.has_work():
        eng.step(now)
        now += 1.0
    return [list(r.generated) for r in reqs]


def test_continuous_engine_under_gather_serves_the_fused_tokens():
    assert _trace_run("gather") == _trace_run("fused")


def test_profile_phases_times_the_configured_impl(monkeypatch):
    """The engine's phase profile times the attention the config selects,
    as the JAX engine passes ``paged_attn_impl`` to ``attn_phase_times``."""
    from repro_torch.moe import profile

    seen = []

    def fake(**kw):
        seen.append(kw["impl"])
        return {profile.ATTN_PHASE: 1e-3}
    monkeypatch.setattr(profile, "attn_phase_times", fake)
    for impl in ("gather", "fused"):
        cfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                                  paged_attn_impl=impl)
        model = init_model(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
        eng = ContinuousEngine(cfg, model, ContinuousConfig(
            max_slots=2, prefill_len=16, block_size=8, max_len=32))
        assert eng.profile_phases(iters=1) == {profile.ATTN_PHASE: 1e-3}
    assert seen == ["gather", "fused"]


# --------------------------------------------------------------------------
# obs.validate
# --------------------------------------------------------------------------

def _traces(tmp_path):
    ok = {"traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
         "args": {"name": "p"}},
        {"ph": "X", "name": "prefill", "ts": 0, "dur": 5, "pid": 1,
         "tid": 0},
        {"ph": "X", "name": "decode", "ts": 5, "dur": 2, "pid": 1,
         "tid": 0}]}
    bad = {"traceEvents": [{"ph": "X", "name": "decode", "ts": -1, "pid": 1,
                            "tid": 0}, {"ph": "Q"}, 3]}
    paths = {}
    for name, doc in (("ok", ok), ("bad", bad)):
        paths[name] = tmp_path / f"{name}.json"
        paths[name].write_text(json.dumps(doc))
    paths["garbled"] = tmp_path / "garbled.json"
    paths["garbled"].write_text("{not json")
    paths["missing"] = tmp_path / "absent.json"
    return {k: str(v) for k, v in paths.items()}


@pytest.mark.parametrize("case,rc", [
    (("ok",), 0), (("ok", "--require", "decode", "--require", "prefill"), 0),
    (("bad",), 1), (("garbled",), 1), (("missing",), 1),
    (("ok", "--require", "replan"), 1), (("ok", "bad", "missing"), 1)])
def test_validate_prints_and_exits_as_the_jax_cli(tmp_path, capsys, case,
                                                  rc):
    """A valid trace, one that breaks the schema, an unreadable file, a
    missing file, a missing ``--require`` name and several files at once:
    the same exit code, standard output and standard error."""
    paths = _traces(tmp_path)
    argv = [paths.get(a, a) for a in case]
    assert jax_validate.main(argv) == rc
    want = capsys.readouterr()
    assert validate.main(argv) == rc
    got = capsys.readouterr()
    assert got.out == want.out and got.err == want.err
    assert (rc == 0) == (not got.err) and (got.out or got.err)
