"""``ServeEngine`` serving the encoder-decoder (``seamless-m4t-medium`` at
``reduced()``) in the PyTorch port against the JAX package's
``ServeEngine``, on the CPU, and the engines and launchers that refuse it.

Both engines take the same bridged weights and the same numpy batch: 2
prompts of 16 tokens and their frames (``tests/_torch_encdec.py``'s three
variants: 40 frames; 600; G 1 over 600 with the encoder at 8 heads of 32),
6 new tokens. The JAX engine runs in one subprocess without XLA's excess
precision (under it XLA keeps bf16 fusions in fp32, where the port, like
JAX op by op, rounds every operation).

Tolerances, as ``tests/test_torch_rwkv_serve.py``: logits within
``LOGIT_ATOL`` = 5e-2 at every step with both engines teacher-forced on
the JAX engine's tokens; the generated tokens equal up to the first
difference, which must be a near tie of the JAX logits (within 2
``LOGIT_ATOL``).

Both packages' ``ContinuousEngine`` refuse the encoder-decoder (its paged
pool has no cross-attention cache), and both packages' serve launchers
fail on it with ``KeyError``: they send tokens and no frames, and the
encoder reads them. The port's ``ServeEngine(ep=True)`` refuses a model
without experts.
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
from repro.launch import serve as jax_launch_serve  # noqa: E402
from repro.models.transformer import init_model as jax_init_model  # noqa: E402
from repro.serve import ContinuousConfig as JaxContinuousConfig  # noqa: E402
from repro.serve import ContinuousEngine as JaxContinuousEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.serve import (ContinuousConfig, ContinuousEngine,  # noqa: E402
                               ServeConfig, ServeEngine)
from tests._torch_encdec import SOURCE as HELPERS  # noqa: E402
from tests._torch_encdec import FRAMES, VARIANTS  # noqa: E402
from tests._torch_encdec import encdec_config  # noqa: E402
from tests._torch_encdec import encdec_frames  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "seamless-m4t-medium"
LOGIT_ATOL = 5e-2
B, S, NEW = 2, 16, 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(vocab):
    return np.random.default_rng(7).integers(0, vocab, (B, S)).astype(
        np.int32)


SUB = '''
import dataclasses, os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_allow_excess_precision=false"
import numpy as np
import jax, jax.numpy as jnp
from repro.configs.registry import get_config
from repro.models.transformer import init_model
from repro.serve import ServeConfig, ServeEngine

exec(os.environ["ES_HELPERS"])
arch, variants, (B, S, NEW) = eval(os.environ["ES_ARGS"])
res = {}
for name in variants:
    cfg = encdec_config(get_config(arch).reduced(), name)
    params = init_model(jax.random.PRNGKey(0), cfg)
    eng = ServeEngine(cfg, params, ServeConfig(strategy="none",
                                               max_len=S + NEW))
    batch = {"tokens": jnp.asarray(_prompts(cfg.vocab_size)),
             "frames": jnp.asarray(encdec_frames(name, B,
                                                 cfg.encoder.d_model))}
    gen, tele = eng.generate(batch, max_new_tokens=NEW)
    gen = np.asarray(gen)
    # teacher-forced on its own tokens: the logits of every step
    logits, cache, _ = eng.prefill(batch)
    out = [np.asarray(logits, np.float32)]
    for t in range(NEW - 1):
        _, lg, cache, _ = eng.decode(jnp.asarray(gen[:, t:t + 1]), cache,
                                     S + t)
        out.append(np.asarray(lg, np.float32))
    res[name] = {"gen": gen, "tele": tele, "logits": out,
                 "batches_seen": eng.batches_seen,
                 "cross": tuple(cache["cross_k"].shape)}
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("encdec_serve") / "jax_serve.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               ES_HELPERS=HELPERS + "\n\n" + inspect.getsource(_prompts),
               ES_ARGS=repr((ARCH, VARIANTS, (B, S, NEW))))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB),
                           str(out)], capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _model(name):
    cfg = encdec_config(get_config(ARCH).reduced(), name)
    jcfg = encdec_config(jax_get_config(ARCH).reduced(), name)
    tree = jax.tree.map(np.asarray, jax_init_model(jax.random.PRNGKey(0),
                                                   jcfg))
    return cfg, params_from_jax(tree, cfg, device="cpu")


@pytest.mark.parametrize("name", VARIANTS)
def test_serve_engine_matches_jax(jax_ref, name):
    ref = jax_ref[name]
    cfg, model = _model(name)
    batch = {"tokens": _prompts(cfg.vocab_size),
             "frames": encdec_frames(name, B, cfg.encoder.d_model)}
    eng = ServeEngine(cfg, model, ServeConfig(strategy="none",
                                              max_len=S + NEW))
    assert eng.moe_cfg is None and eng.estimator is None
    ops.reset_launches()
    gen, tele = eng.generate(batch, max_new_tokens=NEW)
    assert sum(ops.LAUNCHES.values()) == 0    # no kernel on this path
    assert gen.dtype == torch.int32 and tuple(gen.shape) == (B, NEW)
    assert tele == ref["tele"] == {} and eng.history == []
    assert eng.batches_seen == 1 and ref["batches_seen"] == 2
    jgen = ref["gen"]
    # both engines fed the JAX tokens: logits agree at every step
    logits, cache, _ = eng.prefill(batch)
    # the cache holds the source's frames, not max_source_len of them
    assert tuple(cache["cross_k"].shape) == ref["cross"] == (
        2, B, FRAMES[name], cfg.num_kv_heads, 64)
    lt = [logits.float().numpy()]
    for t in range(NEW - 1):
        _, lg, cache, _ = eng.decode(torch.tensor(jgen[:, t:t + 1]), cache,
                                     S + t)
        lt.append(lg.float().numpy())
    for step, (a, b) in enumerate(zip(ref["logits"], lt)):
        assert b.shape == a.shape == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(b, a, atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"step {step}")
    # generated tokens equal up to the first difference, a near tie
    gen = gen.numpy()
    for r in range(B):
        diff = np.nonzero(gen[r] != jgen[r])[0]
        if len(diff):
            top2 = np.sort(ref["logits"][diff[0]][r, -1])[-2:]
            assert top2[1] - top2[0] <= 2 * LOGIT_ATOL, (r, diff[0])


def test_frames_change_what_the_engine_generates():
    """The encoder's output reaches the tokens: other frames, other
    logits (the same prompts)."""
    cfg, model = _model("reduced")
    eng = ServeEngine(cfg, model, ServeConfig(strategy="none",
                                              max_len=S + NEW))
    tokens = _prompts(cfg.vocab_size)
    a, _, _ = eng.prefill({"tokens": tokens, "frames": encdec_frames(
        "reduced", B, 256)})
    b, _, _ = eng.prefill({"tokens": tokens, "frames": encdec_frames(
        "reduced", B, 256, seed=1)})
    assert float((a.float() - b.float()).abs().max()) > 1e-2
    with pytest.raises(KeyError, match="frames"):
        eng.generate({"tokens": tokens})


def test_continuous_engines_refuse_the_encoder_decoder():
    cfg, model = _model("reduced")
    ccfg = dict(max_slots=2, prefill_len=16, block_size=8, max_len=32)
    with pytest.raises(ValueError, match="audio"):
        ContinuousEngine(cfg, model, ContinuousConfig(**ccfg))
    with pytest.raises(ValueError, match="audio"):
        JaxContinuousEngine(jax_get_config(ARCH).reduced(), None,
                            JaxContinuousConfig(**ccfg))
    with pytest.raises(ValueError, match="MoE"):
        ServeEngine(cfg, model, ServeConfig(strategy="none"), ep_ranks=4,
                    ep=True)


def test_serve_launchers_fail_alike_without_frames():
    """The JAX launcher calls ``generate({"tokens": ...})`` with no frames
    and fails in the forward with ``KeyError``; the port's does the
    same."""
    argv = ["--arch", ARCH, "--reduced", "--requests", "2", "--batch", "2",
            "--seq", "8", "--new-tokens", "2"]
    with pytest.raises(KeyError, match="frames") as jax_err:
        jax_launch_serve.main(argv)
    with pytest.raises(KeyError, match="frames") as port_err:
        launch_serve.main(argv + ["--device", "cpu"])
    assert type(port_err.value) is type(jax_err.value)
    with pytest.raises(ValueError, match=f"{ARCH}-smoke"):
        launch_serve.main(argv + ["--device", "cpu", "--strategy",
                                  "dist_only"])
