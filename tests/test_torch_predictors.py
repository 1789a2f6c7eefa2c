"""The port's predictor ladder (``repro_torch.core.predictors``) and its
optimizer (``repro_torch.optim``) against the JAX package's, on the CPU.

* ``ProbabilityModel`` and ``ConditionalProbabilityModel`` (conditioned on
  the token and on the position) are numpy copies: fitted on the same
  ``make_routing_trace``, their counts, tables and predictions are equal.
* ``FFNPredictor`` and ``LSTMPredictor`` run on the JAX predictors'
  parameters (bridged with ``predictor_params_from_jax``): their logits
  agree within 1e-5 (fp32, summed in another order), and after 5 steps of
  ``_fit_neural`` from the same parameters and seed (the same batches,
  loss and AdamW) the parameters agree within 1e-4. ``flops_per_token`` is
  equal for every rung; ``predict`` takes the lowest index on ties.
* The ladder learns on ``tests/test_predictors.py``'s trace and holds its
  accuracy thresholds.
* ``adamw_update`` equals the JAX update within 1e-6 on a small tree with
  clipping active and decay on matrices only; the schedules match at 6
  steps.
* ``ServeEngine._predict_tokens`` gives (L, B, S, K), as in
  ``tests/test_serve_and_train.py``.
* On a card (``cuda`` marker; skipped here): the neural predictors'
  forward and 5 training steps on the card against the CPU.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import predictors as jpred  # noqa: E402
from repro.data.synthetic import make_routing_trace  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch.bridge import (predictor_params_from_jax,  # noqa: E402
                                predictor_params_to_jax)
from repro_torch.core import predictors as tpred  # noqa: E402
from repro_torch.optim import (adamw_init, adamw_update,  # noqa: E402
                               cosine_schedule, wsd_schedule)

L, E, V = 2, 8, 256
NEURAL = ("FFNPredictor", "LSTMPredictor")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small operations: one intra-op thread runs them as fast as many and
    keeps test workers side by side from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trace():
    return make_routing_trace(num_sequences=192, seq_len=64, vocab=V,
                              num_experts=E, num_layers=L, skew=1.6,
                              predictability=0.9, seed=1)


def split(trace, frac=0.8):
    k = int(trace.tokens.shape[0] * frac)
    return ((trace.tokens[:k], trace.experts[:, :k]),
            (trace.tokens[k:], trace.experts[:, k:]))


def _pair(name, seed=0):
    """The JAX predictor and the port's on its bridged parameters."""
    j = getattr(jpred, name)(L, E, V, seed=seed)
    t = getattr(tpred, name)(L, E, V, seed=seed, device="cpu")
    t.params = predictor_params_from_jax(jax.tree.map(np.asarray, j.params),
                                         "cpu")
    return j, t


def _max_diff(jtree, ttree):
    return max(jax.tree.leaves(jax.tree.map(
        lambda a, b: float(np.abs(np.asarray(a, np.float32) - b).max()),
        jtree, predictor_params_to_jax(ttree))))


# --------------------------------------------------------------------------
# frequency models
# --------------------------------------------------------------------------

@pytest.mark.parametrize("model", ["probability", "token", "position"])
def test_frequency_models_match_jax_bit_for_bit(trace, model):
    (tok_tr, ex_tr), (tok_te, _) = split(trace)
    if model == "probability":
        j = jpred.ProbabilityModel(L, E).fit(ex_tr)
        t = tpred.ProbabilityModel(L, E).fit(ex_tr)
        np.testing.assert_array_equal(t.counts, j.counts)
    else:
        j = jpred.ConditionalProbabilityModel(L, E, V, model).fit(ex_tr,
                                                                  tok_tr)
        t = tpred.ConditionalProbabilityModel(L, E, V, model).fit(ex_tr,
                                                                  tok_tr)
        np.testing.assert_array_equal(t.table, j.table)
        assert t.table.dtype == j.table.dtype
    for tokens in (tok_te, tok_te[:3, :17]):
        want, got = j.predict(tokens), t.predict(tokens)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert t.flops_per_token(32) == j.flops_per_token(32)


# --------------------------------------------------------------------------
# neural predictors
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", NEURAL)
@pytest.mark.parametrize("shape", [(3, 40), (1, 5)])
def test_neural_apply_matches_jax(trace, name, shape):
    j, t = _pair(name)
    tokens = trace.tokens[:shape[0], :shape[1]]
    want = np.asarray(j.apply(j.params, jnp.asarray(tokens)))
    got = t.apply(t.params, torch.tensor(tokens))
    assert got.shape == want.shape == (L,) + shape + (E,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(t.predict(tokens), j.predict(tokens))
    assert torch.equal(t(torch.tensor(tokens)), got)       # nn.Module call


@pytest.mark.parametrize("name", NEURAL)
def test_flops_per_token_equal(name):
    j, t = _pair(name)
    for layers in (1, 8, 32):
        assert t.flops_per_token(layers) == j.flops_per_token(layers)


@pytest.mark.parametrize("name", NEURAL)
def test_fit_neural_matches_jax(trace, name):
    j, t = _pair(name)
    (tok_tr, ex_tr), _ = split(trace)
    tok_tr, ex_tr = tok_tr[:, :24], ex_tr[:, :, :24]
    j.fit(ex_tr, tok_tr, steps=5, batch=8, seed=3)
    t.fit(ex_tr, tok_tr, steps=5, batch=8, seed=3)
    assert _max_diff(j.params, t.params) < 1e-4
    # the fit moved every matrix
    _, t0 = _pair(name)
    assert _max_diff(predictor_params_to_jax(t0.params), t.params) > 1e-3


def test_predict_breaks_ties_toward_the_lowest_index():
    t = tpred.FFNPredictor(1, 4, 8, device="cpu")
    p = t.params
    p["heads"] = torch.zeros_like(p["heads"])
    p["heads"][0, :, 1:3] = 1.0                    # experts 1 and 2 tie
    t.params = p
    tok = np.array([[0, 3, 7]], np.int32)
    logits = t.apply(t.params, torch.tensor(tok))
    assert torch.equal(logits[..., 1], logits[..., 2])
    np.testing.assert_array_equal(t.predict(tok), np.ones((1, 1, 3)))


def test_predictor_params_round_trip_and_registration():
    _, t = _pair("LSTMPredictor")
    tree = predictor_params_to_jax(t.params)
    assert set(tree) == {"embed", "compress", "lstm1", "lstm2", "attn_scale",
                         "res_mlp", "heads"}
    assert set(tree["lstm1"]) == {"wx", "wh", "b"}
    back = predictor_params_from_jax(tree, "cpu")
    pairs = list(zip(tpred._paths(back), tpred._paths(t.params)))
    assert len(pairs) == 11
    assert all(pa == pb and torch.equal(a, b)
               for (pa, a), (pb, b) in pairs)
    names = dict(t.named_parameters())
    assert "lstm1_wx" in names and len(names) == 11
    assert not any(p.requires_grad for p in names.values())


def test_accuracy_matches_jax(trace):
    (_, ex), _ = split(trace)
    pred = np.roll(ex, 1, axis=-1)
    assert tpred.accuracy(pred, ex) == jpred.accuracy(pred, ex)


# --------------------------------------------------------------------------
# the ladder learns (tests/test_predictors.py's thresholds)
# --------------------------------------------------------------------------

def test_ladder_holds_the_jax_thresholds(trace):
    (tok_tr, ex_tr), (tok_te, ex_te) = split(trace)
    prob = tpred.ProbabilityModel(L, E).fit(ex_tr)
    cond = tpred.ConditionalProbabilityModel(L, E, V).fit(ex_tr, tok_tr)
    acc_p = tpred.accuracy(prob.predict(tok_te), ex_te)
    acc_c = tpred.accuracy(cond.predict(tok_te), ex_te)
    assert 0.05 <= acc_p <= 0.65
    assert acc_c > acc_p + 0.1 and acc_c > 0.6
    ffn = tpred.FFNPredictor(L, E, V, seed=0, device="cpu").fit(
        ex_tr, tok_tr, steps=150, batch=32)
    assert tpred.accuracy(ffn.predict(tok_te), ex_te) > 0.55
    lstm = tpred.LSTMPredictor(L, E, V, seed=0, device="cpu").fit(
        ex_tr, tok_tr, steps=120, batch=16)
    assert tpred.accuracy(lstm.predict(tok_te), ex_te) > 0.5
    fl = [prob.flops_per_token(L), cond.flops_per_token(L),
          ffn.flops_per_token(L), lstm.flops_per_token(L)]
    assert fl == sorted(fl) and fl[0] < fl[-1]


def test_neural_predictors_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for name in NEURAL:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(tpred, name)(L, E, V)


# --------------------------------------------------------------------------
# optimizer and schedules
# --------------------------------------------------------------------------

def _tree(rng, scale=1.0):
    return {"w": (rng.normal(size=(5, 3)) * scale).astype(np.float32),
            "sub": {"b": (rng.normal(size=(3,)) * scale).astype(np.float32),
                    "m": (rng.normal(size=(2, 2, 3)) * scale
                          ).astype(np.float32)},
            "s": np.float32(rng.normal() * scale)}


def _to_torch(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


@pytest.mark.parametrize("wd", [0.1, 0.0])
@pytest.mark.parametrize("lr_kind", ["float", "schedule"])
def test_adamw_update_matches_jax(wd, lr_kind):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, params), _to_torch(params)
    js, ts = jadamw.adamw_init(jp), adamw_init(tp)
    jlr, tlr = jsched.cosine_schedule(1e-2, 2, 6), cosine_schedule(1e-2, 2, 6)
    for step in range(4):
        grads = _tree(rng, scale=3.0)         # global norm ~10: clipped
        lr_j = 1e-2 if lr_kind == "float" else jlr(step + 1)
        lr_t = 1e-2 if lr_kind == "float" else tlr(step + 1)
        jp, js, jn = jadamw.adamw_update(jp, jax.tree.map(jnp.asarray, grads),
                                         js, lr_j, weight_decay=wd)
        tp, ts, tn = adamw_update(tp, _to_torch(grads), ts, lr_t,
                                  weight_decay=wd)
        assert float(jn) > 1.0                # clipping active
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(
                jax.tree.map(lambda x: x.numpy(), tp))):
            np.testing.assert_allclose(b, np.asarray(a), atol=1e-6, rtol=0)
        for a, b in zip(jax.tree.leaves(js.mu), jax.tree.leaves(
                jax.tree.map(lambda x: x.numpy(), ts.mu))):
            np.testing.assert_allclose(b, np.asarray(a), atol=1e-6, rtol=0)
    assert int(ts.step) == int(js.step) == 4


def test_adamw_decays_matrices_only():
    zeros = {"w": np.zeros((2, 2), np.float32),
             "b": np.zeros((2,), np.float32)}
    p = {"w": np.ones((2, 2), np.float32), "b": np.ones((2,), np.float32)}
    tp, _, _ = adamw_update(_to_torch(p), _to_torch(zeros),
                            adamw_init(_to_torch(p)), 0.5, weight_decay=0.1)
    np.testing.assert_allclose(tp["w"].numpy(), 1 - 0.5 * 0.1, rtol=1e-7)
    np.testing.assert_array_equal(tp["b"].numpy(), 1.0)
    bf = {"w": torch.ones((2, 2), dtype=torch.bfloat16)}
    out, st, _ = adamw_update(bf, {"w": torch.ones((2, 2))}, adamw_init(bf),
                              1e-3)
    assert out["w"].dtype == torch.bfloat16
    assert st.mu["w"].dtype == torch.float32


@pytest.mark.parametrize("kind", ["cosine", "wsd"])
def test_schedules_match_jax(kind):
    jfn = getattr(jsched, f"{kind}_schedule")(1e-3, warmup=2, total=6)
    tfn = {"cosine": cosine_schedule, "wsd": wsd_schedule}[kind](
        1e-3, warmup=2, total=6)
    for step in range(7):
        got = tfn(step)
        assert got.dtype == torch.float32 and got.dim() == 0
        assert float(got) == pytest.approx(float(jfn(step)), rel=1e-6,
                                           abs=1e-12)


# --------------------------------------------------------------------------
# ServeEngine's Token-to-Expert pre-routing
# --------------------------------------------------------------------------

def test_serve_engine_predict_tokens_shape():
    from repro_torch.configs.registry import get_config
    from repro_torch.data.synthetic import make_routing_trace as port_trace
    from repro_torch.models.transformer import init_model
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = get_config("mixtral-8x7b").reduced()
    model = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    tr = port_trace(num_sequences=16, seq_len=16, vocab=cfg.vocab_size,
                    num_experts=cfg.moe.num_experts,
                    num_layers=cfg.num_layers, skew=1.5, seed=0)
    pred = tpred.ConditionalProbabilityModel(
        cfg.num_layers, cfg.moe.num_experts, cfg.vocab_size
    ).fit(tr.experts, tr.tokens)
    eng = ServeEngine(cfg, model, ServeConfig(strategy="token_to_expert"),
                      predictor=pred)
    p = eng._predict_tokens(tr.tokens[:2])
    assert p.shape == (cfg.num_layers, 2, 16, cfg.moe.top_k)
    assert p.dtype == torch.int32
    np.testing.assert_array_equal(p[..., 1].numpy(),
                                  pred.predict(tr.tokens[:2]))
    assert torch.equal(p[..., 0], p[..., 1])          # top-1 broadcast over k
    # the dense path ignores the predictions: the prefill equals dist_only's
    base = ServeEngine(cfg, model, ServeConfig(strategy="dist_only"))
    batch = {"tokens": tr.tokens[:2]}
    assert torch.equal(eng.prefill(batch)[0], base.prefill(batch)[0])
    assert ServeEngine(cfg, model, ServeConfig(strategy="dist_only"),
                       predictor=pred)._predict_tokens(tr.tokens[:2]) is None


def test_launch_serve_token_to_expert_on_cpu(capsys):
    from repro_torch.launch import serve as launch_serve

    rc = launch_serve.main(["--arch", "mixtral-8x7b", "--reduced",
                            "--device", "cpu", "--strategy",
                            "token_to_expert", "--requests", "3", "--batch",
                            "2", "--seq", "36", "--new-tokens", "3"])
    assert rc == 0
    assert "served 3 requests in 2 batches on cpu" in capsys.readouterr().out


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", NEURAL)
def test_neural_predictors_on_the_card_match_the_cpu(trace, name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    (tok_tr, ex_tr), (tok_te, _) = split(trace)
    gpu = getattr(tpred, name)(L, E, V, seed=0, device="cuda")
    cpu = getattr(tpred, name)(L, E, V, seed=0, device="cpu")
    cpu.params = predictor_params_from_jax(
        predictor_params_to_jax(gpu.params), "cpu")
    a = gpu.apply(gpu.params, torch.tensor(tok_te, device="cuda")).cpu()
    b = cpu.apply(cpu.params, torch.tensor(tok_te))
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=0)
    gpu.fit(ex_tr, tok_tr, steps=5, batch=8, seed=3)
    cpu.fit(ex_tr, tok_tr, steps=5, batch=8, seed=3)
    assert _max_diff(predictor_params_to_jax(cpu.params), gpu.params) < 1e-3
