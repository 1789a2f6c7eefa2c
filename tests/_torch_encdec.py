"""Configs and inputs of the encoder-decoder (``seamless-m4t-medium``) for
the port's tests (``tests/test_torch_encdec_*.py``). The tests call these
functions, and their JAX subprocesses ``exec`` ``SOURCE`` (with ``np`` and
``dataclasses`` in scope) on the JAX package's configs.

``reduced()`` hides three features of the published model, so each test
runs three variants:

* "reduced": ``reduced()`` itself (decoder and encoder G 2: 4 heads over 2
  KV heads, head_dim 64) over 40 frames, under one 512-frame block;
* "long": the same over 600 frames, so the non-causal online softmax runs
  across two key blocks and the second one's padded keys are masked;
* "g1": G 1 in both stacks (the published geometry: every head its own KV
  head), the encoder at 8 heads of 32 where the decoder keeps 64, so RoPE
  built at the wrong ``head_dim`` would show; over 600 frames.

Frames are seeded standard normals: zero frames (the train launcher's)
make the encoder's output exactly 0 and hide the encoder and the
cross-attention."""

import dataclasses
import inspect

import numpy as np

VARIANTS = ("reduced", "long", "g1")
FRAMES = {"reduced": 40, "long": 600, "g1": 600}


def encdec_config(reduced, name):
    """The variant ``name`` of a ``reduced()`` seamless config (either
    package's)."""
    if name in ("reduced", "long"):
        return reduced
    if name != "g1":
        raise ValueError(name)
    enc = dataclasses.replace(reduced.encoder, num_heads=8, num_kv_heads=8)
    return dataclasses.replace(reduced, num_kv_heads=reduced.num_heads,
                               encoder=enc)


def encdec_frames(name, batch, d_enc, seed=0):
    """(batch, FRAMES[name], d_enc) float32 frames, a seeded standard
    normal."""
    rng = np.random.default_rng(1000 + seed)
    return rng.normal(size=(batch, FRAMES[name], d_enc)).astype(np.float32)


SOURCE = f"FRAMES = {FRAMES!r}\n\n" + "\n\n".join(
    inspect.getsource(f) for f in (encdec_config, encdec_frames))
