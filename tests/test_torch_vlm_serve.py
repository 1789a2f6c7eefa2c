"""The VLM backbone (``llava-next-34b`` at ``reduced()``) served by the
PyTorch port's engines against the JAX package's, on the CPU.

* ``ServeEngine`` on a batch of prefix embeddings and prompts
  (``tests/_torch_vlm.py``'s two variants: 8 prefix embeddings and 16
  tokens; G 7 at head_dim 128 over 600 prefix embeddings and 40 tokens),
  from the JAX init's weights. ``generate`` decodes at ``S + t`` in both
  packages, S the prompt's length (the prefill filled P + S positions): in
  "wide" (S 40 < P 600) its first step overwrites prefix position 40's K
  and V, which both packages show. Its tokens equal the JAX engine's up to
  the first difference, which must be a near tie of the JAX logits (within
  2 ``LOGIT_ATOL``). The true positions, ``prefill`` then ``decode`` at
  ``P + S + t`` with both engines teacher-forced on the JAX tokens, give
  logits within ``LOGIT_ATOL`` = 5e-2 at every step
  (``tests/test_torch_encdec_serve.py``'s).
* ``ContinuousEngine`` text only (its requests carry tokens alone, as the
  JAX engine's do) against the meshless JAX ``ContinuousEngine``, on the
  JAX init's weights with wide logit margins
  (``tests/test_torch_dense_serve.py::widen_logit_margins``), to the end of
  one short trace: per iteration the generated lengths, then the tokens
  and the summary's counters, exactly.
* Both serve launchers send tokens only and serve the VLM text only: the
  same lines, numbers aside.

The JAX engines run jitted in one subprocess without XLA's excess
precision, so they round bf16 where the port does.
"""

import inspect
import os
import pickle
import re
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
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.serve import (ContinuousConfig, ContinuousEngine,  # noqa: E402
                               ServeConfig, ServeEngine, ServeRequest)
from tests._torch_vlm import SOURCE as HELPERS  # noqa: E402
from tests._torch_vlm import PREFIX, TEXT, VARIANTS  # noqa: E402
from tests._torch_vlm import vlm_config, vlm_prefix, vlm_tokens  # noqa: E402
from tests.test_torch_dense_serve import CAPTURE, COLUMNS  # noqa: E402
from tests.test_torch_dense_serve import widen_logit_margins  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCH = "llava-next-34b"
LOGIT_ATOL = 5e-2
B, NEW = 2, 6
ENGINE_KW = dict(max_slots=4, prefill_len=64, block_size=8, max_len=96,
                 predict_interval=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requests(vocab):
    rng = np.random.default_rng(2)
    return [dict(rid=i, tokens=rng.integers(0, vocab, n).tolist(),
                 max_new_tokens=6, arrival=float(i))
            for i, n in enumerate((5, 47, 11, 60, 29, 18))]


SUB = '''
import os, sys
os.environ["XLA_FLAGS"] = "--xla_allow_excess_precision=false"
import dataclasses, pickle
import numpy as np
import jax, jax.numpy as jnp
from repro.configs.registry import get_config
from repro.models.transformer import init_model
from repro.serve import (ContinuousConfig, ContinuousEngine, ServeConfig,
                         ServeEngine, ServeRequest)

exec(os.environ["VS_HELPERS"])
exec(os.environ["VS_CAPTURE"])
arch, variants, (B, NEW), engine_kw, columns = eval(os.environ["VS_ARGS"])
res = {}
for name in variants:
    cfg = vlm_config(get_config(arch).reduced(), name)
    P, S = PREFIX[name], TEXT[name]
    params = init_model(jax.random.PRNGKey(0), cfg)
    eng = ServeEngine(cfg, params, ServeConfig(strategy="none",
                                               max_len=P + S + NEW))
    batch = {"tokens": jnp.asarray(vlm_tokens(name, B, cfg.vocab_size)),
             "prefix_embeds": jnp.asarray(vlm_prefix(name, B, cfg.d_model))}
    seen = []
    decode = eng.decode
    def spy(tok, cache, n):
        seen.append(n)
        return decode(tok, cache, n)
    eng.decode = spy
    gen, tele = eng.generate(batch, max_new_tokens=NEW)
    eng.decode = decode
    out = {"gen": np.asarray(gen), "tele": tele, "positions": seen}
    # the logits of generate's steps, fed its own tokens
    logits, cache, _ = eng.prefill(batch)
    gl = [np.asarray(logits, np.float32)]
    for t in range(NEW - 1):
        _, l, cache, _ = eng.decode(jnp.asarray(out["gen"][:, t:t + 1]),
                                    cache, S + t)
        gl.append(np.asarray(l, np.float32))
    out["gen_logits"] = gl
    # the true positions P + S + t, greedy, and the logits of every step
    logits, cache, _ = eng.prefill(batch)
    out["prefill_k"] = np.asarray(cache["k"], np.float32)
    lg = [np.asarray(logits, np.float32)]
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None]
    true = [np.asarray(tok)]
    for t in range(NEW - 1):
        tok, l, cache, _ = eng.decode(tok, cache, P + S + t)
        lg.append(np.asarray(l, np.float32))
        true.append(np.asarray(tok))
    out["true_logits"], out["true_gen"] = lg, np.concatenate(true, 1)
    # generate's first step at S: position S of the prefill's cache
    _, cache0, _ = eng.prefill(batch)
    _, _, cache1, _ = eng.decode(jnp.asarray(out["gen"][:, :1]), cache0, S)
    out["k_at_S"] = np.asarray(cache1["k"], np.float32)[:, :, S]
    res[name] = out
cfg = get_config(arch).reduced()
tree = jax.tree.map(jnp.asarray, widen_logit_margins(jax.tree.map(
    np.asarray, init_model(jax.random.PRNGKey(0), cfg)), cfg))
eng = ContinuousEngine(cfg, tree, ContinuousConfig(**engine_kw), ep_ranks=4)
rows = [ServeRequest(**dict(r, tokens=np.asarray(r["tokens"], np.int32)))
        for r in _requests(cfg.vocab_size)]
res["continuous"] = serve_capture(eng, rows, columns)
with open(sys.argv[1], "wb") as f:
    pickle.dump(res, f)
'''


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("vlm_serve") / "jax_serve.pkl"
    helpers = HELPERS + "\n\n" + "\n\n".join(
        inspect.getsource(f) for f in (widen_logit_margins, _requests))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               VS_HELPERS=helpers, VS_CAPTURE=CAPTURE,
               VS_ARGS=repr((ARCH, VARIANTS, (B, NEW), ENGINE_KW, COLUMNS)))
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(SUB),
                           str(out)], capture_output=True, text=True,
                          timeout=600, env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out, "rb") as f:
        return pickle.load(f)


def _tree(name, widen=False):
    jcfg = vlm_config(jax_get_config(ARCH).reduced(), name)
    tree = jax.tree.map(np.asarray, jax_init_model(jax.random.PRNGKey(0),
                                                   jcfg))
    return widen_logit_margins(tree, jcfg) if widen else tree


def _engine(name):
    cfg = vlm_config(get_config(ARCH).reduced(), name)
    model = params_from_jax(_tree(name), cfg, device="cpu")
    P, S = PREFIX[name], TEXT[name]
    eng = ServeEngine(cfg, model, ServeConfig(strategy="none",
                                              max_len=P + S + NEW))
    batch = {"tokens": vlm_tokens(name, B, cfg.vocab_size),
             "prefix_embeds": vlm_prefix(name, B, cfg.d_model)}
    return cfg, eng, batch


@pytest.mark.parametrize("name", VARIANTS)
def test_generate_matches_jax_at_the_references_positions(jax_ref, name):
    ref = jax_ref[name]
    cfg, eng, batch = _engine(name)
    S = TEXT[name]
    seen = []
    decode = eng.decode

    def spy(tok, cache, n):
        seen.append(n)
        return decode(tok, cache, n)
    eng.decode = spy
    ops.reset_launches()
    gen, tele = eng.generate(batch, max_new_tokens=NEW)
    eng.decode = decode
    assert sum(ops.LAUNCHES.values()) == 0       # no kernel on this path
    assert seen == ref["positions"] == [S + t for t in range(NEW - 1)]
    assert tele == ref["tele"] == {} and tuple(gen.shape) == (B, NEW)
    gen, jgen = gen.numpy(), ref["gen"]
    # generate's first token is the prefill's, at the true last position
    np.testing.assert_array_equal(gen[:, 0], ref["true_gen"][:, 0])
    for r in range(B):
        diff = np.nonzero(gen[r] != jgen[r])[0]
        if len(diff):
            top2 = np.sort(ref["gen_logits"][diff[0]][r, -1])[-2:]
            assert top2[1] - top2[0] <= 2 * LOGIT_ATOL, (r, diff[0])


@pytest.mark.parametrize("name", VARIANTS)
def test_true_positions_match_jax_teacher_forced(jax_ref, name):
    """``prefill`` then ``decode`` at P + S + t, fed the JAX engine's
    tokens: the logits of every step within ``LOGIT_ATOL``; the greedy
    tokens equal up to a near tie of the JAX logits."""
    ref = jax_ref[name]
    cfg, eng, batch = _engine(name)
    P, S = PREFIX[name], TEXT[name]
    logits, cache, _ = eng.prefill(batch)
    assert tuple(cache["k"].shape) == (2, B, P + S + NEW, 2, cfg.head_dim)
    jk = ref["prefill_k"][:, :, :P + S]
    rel = np.linalg.norm(cache["k"][:, :, :P + S].float().numpy() - jk) \
        / np.linalg.norm(jk)
    assert rel <= 2e-2
    lt, toks = [logits.float().numpy()], [logits[:, -1].argmax(-1).numpy()]
    jtrue = ref["true_gen"]
    for t in range(NEW - 1):
        nt, lg, cache, _ = eng.decode(torch.tensor(jtrue[:, t:t + 1]), cache,
                                      P + S + t)
        lt.append(lg.float().numpy())
        toks.append(nt[:, 0].numpy())
    for step, (a, b) in enumerate(zip(ref["true_logits"], lt)):
        assert b.shape == a.shape == (B, 1, cfg.vocab_size)
        np.testing.assert_allclose(b, a, atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"step {step}")
    toks = np.stack(toks, 1)
    for r in range(B):
        diff = np.nonzero(toks[r] != jtrue[r])[0]
        if len(diff):
            top2 = np.sort(ref["true_logits"][diff[0]][r, -1])[-2:]
            assert top2[1] - top2[0] <= 2 * LOGIT_ATOL, (r, diff[0])


def test_generate_overwrites_a_prefix_position_as_the_reference_does(jax_ref):
    """In "wide" the prefill fills 640 positions (600 prefix embeddings,
    40 tokens) and ``generate``'s first decode step writes its K and V at
    position S = 40, a prefix position, in both packages; the true step
    would write at 640."""
    name = "wide"
    ref = jax_ref[name]
    cfg, eng, batch = _engine(name)
    S = TEXT[name]
    assert S < PREFIX[name]
    _, cache0, _ = eng.prefill(batch)
    before = cache0["k"][:, :, S].float().clone()
    _, _, cache1, _ = eng.decode(torch.tensor(ref["gen"][:, :1]), cache0, S)
    after = cache1["k"][:, :, S].float()
    jbefore = ref["prefill_k"][:, :, S]
    assert np.abs(ref["k_at_S"] - jbefore).max() > 1e-2      # JAX moved it
    assert float((after - before).abs().max()) > 1e-2        # and the port
    rel = np.linalg.norm(after.numpy() - ref["k_at_S"]) \
        / np.linalg.norm(ref["k_at_S"])
    assert rel <= 2e-2


def test_continuous_engine_serves_the_vlm_text_only_as_jax(jax_ref):
    ref = jax_ref["continuous"]
    cfg = get_config(ARCH).reduced()
    model = params_from_jax(_tree("reduced", widen=True), cfg, device="cpu")
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
    assert rec["summary"]["completed"] == len(reqs)
    assert all(len(t) == 6 for t in rec["tokens"])


def test_serve_launchers_serve_the_vlm_text_only_alike(capsys):
    argv = ["--arch", ARCH, "--reduced", "--requests", "4", "--batch", "2",
            "--seq", "12", "--new-tokens", "3"]
    jax_launch_serve.main(argv)
    want = capsys.readouterr().out.splitlines()
    assert launch_serve.main(argv + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want) == 1

    def mask(line):
        return re.sub(r"[\d.e+-]+", "#", line.replace(" on cpu", ""))
    assert [mask(g) for g in got] == [mask(w) for w in want]
    assert got[0].startswith("served 4 requests in 2 batches")
