"""Configs and inputs of the VLM backbone (``llava-next-34b``) for the
port's tests (``tests/test_torch_vlm_*.py``). The tests call these
functions, and their JAX subprocesses ``exec`` ``SOURCE`` (with ``np`` and
``dataclasses`` in scope) on the JAX package's configs.

``reduced()`` hides what the published model has, so each test runs two
variants:

* "reduced": ``reduced()`` itself (4 heads over 2 KV heads of 64, G 2; 8
  prefix embeddings), whose P + S positions sit in one 512-wide block of
  the chunked attention;
* "wide": 14 heads over 2 KV heads of 128 (the published G 7 and
  head_dim), 600 prefix embeddings and 40 text tokens, so that P + S
  crosses a 512 block and the text's RoPE positions start at 600.

Prefix embeddings are fp32, 0.02 x a seeded standard normal (the token
embeddings' scale): the forward casts them to the embedding's dtype, so
the fp32 input shows that cast. The train launcher's zero prefix is the
zero-prefix test's alone."""

import dataclasses
import inspect

import numpy as np

VARIANTS = ("reduced", "wide")
PREFIX = {"reduced": 8, "wide": 600}
TEXT = {"reduced": 16, "wide": 40}


def vlm_config(reduced, name):
    """The variant ``name`` of a ``reduced()`` llava config (either
    package's)."""
    if name == "reduced":
        return reduced
    if name != "wide":
        raise ValueError(name)
    return dataclasses.replace(reduced, num_heads=14, num_kv_heads=2,
                               head_dim=128, num_prefix_embeddings=600)


def vlm_prefix(name, batch, d, seed=0):
    """(batch, PREFIX[name], d) float32 prefix embeddings."""
    rng = np.random.default_rng(2000 + seed)
    return (0.02 * rng.normal(size=(batch, PREFIX[name], d))).astype(
        np.float32)


def vlm_tokens(name, batch, vocab, extra=0, seed=0):
    """(batch, TEXT[name] + extra) int32 Zipf-free uniform token ids."""
    rng = np.random.default_rng(3000 + seed)
    return rng.integers(0, vocab, (batch, TEXT[name] + extra)).astype(
        np.int32)


SOURCE = (f"PREFIX = {PREFIX!r}\nTEXT = {TEXT!r}\n\n" + "\n\n".join(
    inspect.getsource(f) for f in (vlm_config, vlm_prefix, vlm_tokens)))
