"""``ServeEngine`` serving RWKV-6 (``rwkv6-7b`` at ``reduced()``) in the
PyTorch port against the JAX package's ``ServeEngine``, on the CPU, and the
engines and launcher that refuse or serve it.

Both engines take the same bridged weights (the JAX init and its ``clip``
and ``shift`` variants, ``tests/_torch_rwkv.py``) and the same numpy
prompts: 2 x 40 tokens (a whole chunk and a padded one) and 2 x 1 (a
one-token prompt, which the time mix runs as a step). The JAX engine runs
in one subprocess without XLA's excess precision (under it XLA keeps bf16
fusions in fp32, where the port, like JAX op by op, rounds every
operation).

Tolerances, as ``tests/test_torch_griffin.py``: logits within
``LOGIT_ATOL`` = 5e-2 at every step with both engines teacher-forced on
the JAX engine's tokens; the generated tokens equal up to the first
difference, which must be a near tie of the JAX logits (within 2
``LOGIT_ATOL``).

Both packages' ``ContinuousEngine`` refuse RWKV (its state is not a paged
KV pool), and the port's ``ServeEngine(ep=True)`` and the launcher's mesh
and strategy flags refuse a model without experts.
"""

import contextlib
import io
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
from repro.serve import ContinuousConfig as JaxContinuousConfig  # noqa: E402
from repro.serve import ContinuousEngine as JaxContinuousEngine  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.serve import (ContinuousConfig, ContinuousEngine,  # noqa: E402
                               ServeConfig, ServeEngine)
from tests._torch_rwkv import SOURCE as VARIANT_SOURCE  # noqa: E402
from tests._torch_rwkv import VARIANTS, rwkv_variant  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "rwkv6-7b"
LOGIT_ATOL = 5e-2
NEW = 6
# (batch, prompt length): two chunks, the last padded; one token
PROMPTS = ((2, 40), (2, 1))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prompts(vocab, shape):
    return np.random.default_rng(7 + shape[1]).integers(
        0, vocab, shape).astype(np.int32)


SUB = '''
import os, pickle, sys
os.environ["XLA_FLAGS"] = "--xla_allow_excess_precision=false"
import numpy as np
import jax, jax.numpy as jnp
from repro.configs.registry import get_config
from repro.models.transformer import init_model
from repro.serve import ServeConfig, ServeEngine

exec(os.environ["RS_HELPERS"])
arch, variants, prompts_shapes, new = eval(os.environ["RS_ARGS"])
cfg = get_config(arch).reduced()
base = jax.tree.map(np.asarray, init_model(jax.random.PRNGKey(0), cfg))
res = {}
# one engine (its steps compile once a shape: the weights are arguments);
# the state's size does not depend on max_len
eng = ServeEngine(cfg, base, ServeConfig(
    strategy="none", max_len=max(s for _, s in prompts_shapes) + new))
for name in variants:
    eng.params = jax.tree.map(jnp.asarray, rwkv_variant(base, name))
    for shape in prompts_shapes:
        prompts = _prompts(cfg.vocab_size, shape)
        seen = eng.batches_seen
        gen, tele = eng.generate({"tokens": jnp.asarray(prompts)},
                                 max_new_tokens=new)
        seen = eng.batches_seen - seen
        gen = np.asarray(gen)
        # teacher-forced on its own tokens: the logits of every step
        logits, cache, _ = eng.prefill({"tokens": jnp.asarray(prompts)})
        out = [np.asarray(logits, np.float32)]
        for t in range(new - 1):
            _, lg, cache, _ = eng.decode(jnp.asarray(gen[:, t:t + 1]), cache,
                                         shape[1] + t)
            out.append(np.asarray(lg, np.float32))
        res[name, shape] = {"gen": gen, "tele": tele, "logits": out,
                            "batches_seen": seen}
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    import inspect

    out = tmp_path_factory.mktemp("rwkv_serve") / "jax_serve.pkl"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               RS_HELPERS=VARIANT_SOURCE + "\n\n" + inspect.getsource(_prompts),
               RS_ARGS=repr((ARCH, VARIANTS, PROMPTS, NEW)))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB),
                           str(out)], capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def base_tree():
    jcfg = jax_get_config(ARCH).reduced()
    return jax.tree.map(np.asarray, jax_init_model(jax.random.PRNGKey(0), jcfg))


def _torch_teacher_forced(eng, prompts, tokens):
    logits, cache, _ = eng.prefill({"tokens": prompts})
    out = [logits.float().numpy()]
    for t in range(tokens.shape[1] - 1):
        _, lg, cache, _ = eng.decode(torch.tensor(tokens[:, t:t + 1]), cache,
                                     prompts.shape[1] + t)
        out.append(lg.float().numpy())
    return out


@pytest.mark.parametrize("shape", PROMPTS, ids=["prompt40", "prompt1"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_serve_engine_matches_jax(jax_ref, base_tree, variant, shape):
    ref = jax_ref[variant, shape]
    cfg = get_config(ARCH).reduced()
    model = params_from_jax(rwkv_variant(base_tree, variant), cfg,
                            device="cpu")
    prompts = _prompts(cfg.vocab_size, shape)
    eng = ServeEngine(cfg, model, ServeConfig(strategy="none",
                                              max_len=shape[1] + NEW))
    assert eng.moe_cfg is None and eng.estimator is None
    ops.reset_launches()
    gen, tele = eng.generate({"tokens": prompts}, max_new_tokens=NEW)
    assert sum(ops.LAUNCHES.values()) == 0          # RWKV launches no kernel
    assert gen.dtype == torch.int32 and tuple(gen.shape) == (2, NEW)
    assert tele == ref["tele"] == {} and eng.history == []
    assert eng.batches_seen == ref["batches_seen"] == 1
    jgen = ref["gen"]
    # both engines fed the JAX tokens: logits agree at every step
    lt = _torch_teacher_forced(eng, prompts, jgen)
    for step, (a, b) in enumerate(zip(ref["logits"], lt)):
        assert b.shape == a.shape == (2, 1, cfg.vocab_size)
        np.testing.assert_allclose(b, a, atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"step {step}")
    # generated tokens equal up to the first difference, a near tie
    gen = gen.numpy()
    for r in range(2):
        diff = np.nonzero(gen[r] != jgen[r])[0]
        if len(diff):
            top2 = np.sort(ref["logits"][diff[0]][r, -1])[-2:]
            assert top2[1] - top2[0] <= 2 * LOGIT_ATOL, (r, diff[0])


def test_continuous_engines_refuse_rwkv(base_tree):
    cfg = get_config(ARCH).reduced()
    model = params_from_jax(base_tree, cfg, device="cpu")
    ccfg = dict(max_slots=2, prefill_len=16, block_size=8, max_len=32)
    with pytest.raises(ValueError, match="ssm"):
        ContinuousEngine(cfg, model, ContinuousConfig(**ccfg))
    with pytest.raises(ValueError, match="ssm"):
        JaxContinuousEngine(jax_get_config(ARCH).reduced(), None,
                            JaxContinuousConfig(**ccfg))


def test_serve_engine_and_launcher_refuse_experts_rwkv_lacks(base_tree):
    cfg = get_config(ARCH).reduced()
    model = params_from_jax(base_tree, cfg, device="cpu")
    with pytest.raises(ValueError, match="MoE"):
        ServeEngine(cfg, model, ServeConfig(strategy="none"), ep_ranks=4,
                    ep=True)
    for flags in (["--strategy", "dist_only"],
                  ["--data-mesh", "1", "--model-mesh", "4"]):
        with pytest.raises(ValueError, match="rwkv6-7b-smoke"):
            launch_serve.main(["--arch", ARCH, "--reduced", "--device",
                               "cpu"] + flags)


def test_launch_serve_main_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = launch_serve.main(["--arch", ARCH, "--reduced", "--device",
                                "cpu", "--requests", "3", "--batch", "2",
                                "--seq", "36", "--new-tokens", "3"])
    assert rc == 0
    assert "served 3 requests in 2 batches on cpu" in out.getvalue()


def test_launch_serve_needs_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_serve.main(["--arch", ARCH, "--reduced"])
