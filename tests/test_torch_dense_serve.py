"""The dense family served by the PyTorch port's engines against the JAX
package's, on the CPU.

``qwen1.5-0.5b`` (QKV biases, nonzero here), ``olmo-1b`` (non-parametric
LayerNorm), ``stablelm-3b`` and ``minicpm-2b`` (tied embeddings) at
``reduced()``, from the JAX init's weights with wide logit margins
(``widen_logit_margins``: every greedy token several bf16 ulps of logit
clear of the runner-up), bridged into the port.

* ``ContinuousEngine`` against the meshless JAX ``ContinuousEngine`` on one
  short trace, to its end with no near-tie cut-off: per iteration the
  generated lengths, then the generated tokens and the summary's counters
  (completions, preemptions, drops, quota plans, migrations: a dense
  model re-plans and moves nothing on either side).
* ``ServeEngine`` against the JAX ``ServeEngine`` for qwen and minicpm: one
  batch's generated tokens.
* ``ep=True``, a GPS controller and the launcher's mesh flags and
  strategies other than ``none`` raise on a dense model.

The JAX engines run jitted in one subprocess without XLA's excess
precision (``--xla_allow_excess_precision=false``), so they round bf16
where the port does.
"""

import inspect
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
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.transformer import init_model  # noqa: E402
from repro_torch.serve import (ContinuousConfig, ContinuousEngine,  # noqa: E402
                               ServeConfig, ServeEngine, ServeRequest)
from repro_torch.serve.controller import OnlineGPSController  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen1.5-0.5b", "olmo-1b", "stablelm-3b", "minicpm-2b")
SERVE_ENGINE_ARCHS = ("qwen1.5-0.5b", "minicpm-2b")
ENGINE_KW = dict(max_slots=4, prefill_len=64, block_size=8, max_len=96,
                 predict_interval=2)
COLUMNS = ("completed", "preemptions", "dropped_tokens", "overflow_tokens",
           "resched_plans", "migration_replans", "migration_commits",
           "migration_planned_bytes", "migration_bytes_moved")
BATCH = dict(rows=3, seq=24, new_tokens=5, max_len=32)


def widen_logit_margins(tree, cfg, groups=8):
    """Give every token of group g = t * groups // V a component 8 sqrt(d)
    along a unit vector v_g (the v_g orthonormal): the normed hidden state
    at a position then points along its token's v_g. Untied models: the
    ``lm_head`` column of the next group's token 7 gains v_g (about 12
    logits over the random rest). Tied models, whose logits read the
    table: that token's row gains 16 sqrt(d) v_g, twice its group's
    component, so it leads group g's own tokens by about 8 d logits (and,
    read back as an input, repeats itself). Arrays in the JAX tree's
    layout."""
    d, V = cfg.d_model, cfg.vocab_size
    v = np.linalg.qr(np.random.default_rng(4321).normal(size=(d, groups)))[0].T
    group = np.arange(V) * groups // V
    nxt = (np.arange(groups) + 1) % groups * (V // groups) + 7
    table = np.asarray(tree["embed"]["table"], np.float32) \
        + 8.0 * np.sqrt(d) * v[group]
    out = dict(tree)
    if cfg.tie_embeddings:
        table[nxt] += 16.0 * np.sqrt(d) * v
    else:
        head = np.array(tree["lm_head"]["w"], np.float32)
        head[:, nxt] += v.T
        out["lm_head"] = {"w": head}
    out["embed"] = {"table": table}
    return out


def _tree(jcfg):
    """The JAX init's weights, nonzero QKV biases, wide margins."""
    tree = jax.tree.map(np.asarray, jax_init_model(jax.random.PRNGKey(0),
                                                   jcfg))
    if jcfg.qkv_bias:
        rng = np.random.default_rng(7)
        for n in ("wq", "wk", "wv"):
            b = tree["layers"]["attn"][n]["b"]
            tree["layers"]["attn"][n]["b"] = rng.normal(
                0.0, 0.5, b.shape).astype(np.float32)
    return widen_logit_margins(tree, jcfg)


def _requests(vocab):
    rng = np.random.default_rng(2)
    return [dict(rid=i, tokens=rng.integers(0, vocab, n).tolist(),
                 max_new_tokens=6, arrival=float(i))
            for i, n in enumerate((5, 47, 11, 60, 29, 18))]


def _batch(vocab):
    return np.random.default_rng(3).integers(
        0, vocab, (BATCH["rows"], BATCH["seq"])).astype(np.int32)


# Executed by the JAX subprocess and here: serve one trace, one iteration
# per virtual second, recording the generated lengths at every iteration.
CAPTURE = '''
def serve_capture(eng, reqs, columns):
    eng.warmup()
    rec = {"lens": []}
    for r in reqs:
        eng.submit(r)
    while eng.has_work() and len(rec["lens"]) < 100:
        eng.step(float(len(rec["lens"])))
        rec["lens"].append([len(r.generated) for r in reqs])
    s = eng.metrics.summary()
    rec["summary"] = {k: float(s[k]) for k in columns}
    rec["tokens"] = [list(r.generated) for r in reqs]
    return rec
'''

SUB = '''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_allow_excess_precision=false"
import pickle
import numpy as np
import jax, jax.numpy as jnp
from repro.configs.registry import get_config
from repro.models.transformer import init_model
jax_init_model = init_model
from repro.serve import (ContinuousConfig, ContinuousEngine, ServeConfig,
                         ServeEngine, ServeRequest)

exec(os.environ["DS_HELPERS"])
exec(os.environ["DS_CAPTURE"])
columns = eval(os.environ["DS_COLUMNS"])
batch_kw = eval(os.environ["DS_BATCH"])
res = {}
for arch in eval(os.environ["DS_ARCHS"]):
    cfg = get_config(arch).reduced()
    tree = jax.tree.map(jnp.asarray, _tree(cfg))
    eng = ContinuousEngine(cfg, tree, ContinuousConfig(
        **eval(os.environ["DS_ENGINE"])), ep_ranks=4)
    rows = [ServeRequest(**dict(r, tokens=np.asarray(r["tokens"], np.int32)))
            for r in _requests(cfg.vocab_size)]
    res[(arch, "continuous")] = serve_capture(eng, rows, columns)
    if arch in eval(os.environ["DS_SERVE_ARCHS"]):
        se = ServeEngine(cfg, tree, ServeConfig(max_len=batch_kw["max_len"]))
        out, _ = se.generate({"tokens": jnp.asarray(_batch(cfg.vocab_size))},
                             max_new_tokens=batch_kw["new_tokens"])
        res[(arch, "serve")] = np.asarray(out)
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("dense_serve") / "jax_serve.pkl"
    helpers = "\n\n".join(inspect.getsource(f) for f in (
        widen_logit_margins, _tree, _requests, _batch))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               DS_HELPERS=f"BATCH = {BATCH!r}\n" + helpers,
               DS_CAPTURE=CAPTURE, DS_COLUMNS=repr(COLUMNS),
               DS_ARCHS=repr(ARCHS), DS_SERVE_ARCHS=repr(SERVE_ENGINE_ARCHS),
               DS_ENGINE=repr(ENGINE_KW), DS_BATCH=repr(BATCH))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB),
                           str(out)], capture_output=True, text=True,
                          timeout=900, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _model(arch):
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    return cfg, params_from_jax(_tree(jcfg), cfg, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_continuous_engine_matches_the_jax_engine_to_the_end(jax_ref, arch):
    ref = jax_ref[(arch, "continuous")]
    cfg, model = _model(arch)
    eng = ContinuousEngine(cfg, model, ContinuousConfig(**ENGINE_KW),
                           ep_ranks=4)
    assert eng.moe_cfg is None and eng.estimator is None
    scope = {"np": np}
    exec(CAPTURE, scope)
    reqs = [ServeRequest(**dict(r, tokens=np.asarray(r["tokens"], np.int32)))
            for r in _requests(cfg.vocab_size)]
    ops.reset_launches()
    rec = scope["serve_capture"](eng, reqs, COLUMNS)
    assert sum(ops.LAUNCHES.values()) == 0       # the CPU runs plain versions
    assert rec["lens"] == ref["lens"]
    assert rec["tokens"] == ref["tokens"]
    assert rec["summary"] == ref["summary"]
    s = rec["summary"]
    assert s["completed"] == len(reqs) and s["migration_replans"] == 0
    assert eng.metrics.summary()["replans"] == 0
    assert all(len(t) == 6 for t in rec["tokens"])
    assert eng._plan_stack is None and eng._store is None


@pytest.mark.parametrize("arch", SERVE_ENGINE_ARCHS)
def test_serve_engine_matches_the_jax_engine(jax_ref, arch):
    cfg, model = _model(arch)
    eng = ServeEngine(cfg, model, ServeConfig(max_len=BATCH["max_len"]))
    out, tele = eng.generate({"tokens": _batch(cfg.vocab_size)},
                             max_new_tokens=BATCH["new_tokens"])
    assert tele == {} and eng.history == []
    np.testing.assert_array_equal(out.numpy(), jax_ref[(arch, "serve")])


def test_margins_set_the_greedy_tokens():
    """The widened weights make the next token a function of the last one:
    a check that the engines' agreement is over clear decisions."""
    for arch in ("qwen1.5-0.5b", "minicpm-2b"):
        cfg, model = _model(arch)
        toks = torch.tensor(_batch(cfg.vocab_size))
        with torch.no_grad():
            logits, _, _ = model(toks, mode="train")
        top2 = logits.float().topk(2, dim=-1).values
        gap = (top2[..., 0] - top2[..., 1]).min()
        assert gap > 8 * float(top2[..., 0].abs().max()) * 2 ** -8, arch


def test_ep_a_controller_and_the_launchers_ep_refuse_a_dense_model():
    from repro_torch.launch import serve as launch_serve

    cfg = get_config("qwen1.5-0.5b").reduced()
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    ccfg = ContinuousConfig(**ENGINE_KW)
    with pytest.raises(ValueError, match="MoE"):
        ContinuousEngine(cfg, model, ccfg, ep_ranks=4, ep=True)
    with pytest.raises(ValueError, match="MoE"):
        ServeEngine(cfg, model, ServeConfig(), ep_ranks=4, ep=True)
    with pytest.raises(ValueError, match="MoE"):
        OnlineGPSController(cfg)
    moe_ctl = OnlineGPSController(get_config("mixtral-8x7b").reduced())
    with pytest.raises(ValueError, match="MoE"):
        ContinuousEngine(cfg, model, ccfg, controller=moe_ctl)
    base = ["--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu"]
    # a mesh of processes serves it (tests/test_torch_dist_tp.py); the
    # stacked backend, whose EP ranks are a tensor dimension, does not
    with pytest.raises(ValueError, match="--data-mesh.*stacked EP ranks"):
        launch_serve.main(base + ["--data-mesh", "1", "--model-mesh", "4"])
    for strategy in ("dist_only", "token_to_expert"):
        with pytest.raises(ValueError, match="--strategy"):
            launch_serve.main(base + ["--strategy", strategy])


@pytest.mark.parametrize("arch", SERVE_ENGINE_ARCHS)
def test_launch_serve_serves_a_dense_model(arch, capsys):
    from repro_torch.launch import serve as launch_serve

    rc = launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                            "--requests", "3", "--batch", "2", "--seq", "24",
                            "--new-tokens", "3", "--strategy", "none"])
    assert rc == 0
    assert "served 3 requests in 2 batches on cpu" in capsys.readouterr().out
