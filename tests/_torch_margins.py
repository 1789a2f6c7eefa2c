"""Weights whose router and ``lm_head`` margins are wide by construction,
for the port's engine tests that compare whole runs with the JAX package
(``tests/test_torch_resched.py``, ``test_torch_fleet.py`` and
``test_torch_serve_ep.py``). The tests run ``widen_margins`` here, and
their JAX subprocesses ``exec`` its ``SOURCE`` (with ``np`` in scope)."""

import inspect

import numpy as np


def widen_margins(tree, cfg):
    """Give every token of group g = t * E // V a large component along a
    unit vector v_g (the v_g orthonormal): rmsnorm'ed hidden states then
    point along v_g, the router prefers expert g and then g + 1 by about
    4.6 logits each, and lm_head prefers the next group's token 7 by about
    12 logits over the random rest. Arrays in the JAX tree's layout."""
    d, V, E = cfg.d_model, cfg.vocab_size, cfg.moe.num_experts
    v = np.linalg.qr(np.random.default_rng(1234).normal(size=(d, E)))[0].T
    group = np.arange(V) * E // V
    pref = np.zeros((E, E))
    pref[np.arange(E), np.arange(E)] = 2.0
    pref[np.arange(E), (np.arange(E) + 1) % E] = 1.0
    nxt = (np.arange(E) + 1) % E * (V // E) + 7
    out = dict(tree)
    out["embed"] = {"table": np.asarray(tree["embed"]["table"], np.float32)
                    + 8.0 * np.sqrt(d) * v[group]}
    head = np.array(tree["lm_head"]["w"], np.float32)
    head[:, nxt] += v.T
    out["lm_head"] = {"w": head}
    layers = dict(tree["layers"])
    moe = dict(layers["moe"])
    moe["router"] = {"w": np.asarray(moe["router"]["w"], np.float32)
                     + 0.3 * (v.T @ pref)[None].astype(np.float32)}
    layers["moe"] = moe
    out["layers"] = layers
    return out


SOURCE = inspect.getsource(widen_margins)
