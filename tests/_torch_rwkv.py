"""Weight variants of RWKV-6 that show what the JAX init hides, for the
port's RWKV tests (``tests/test_torch_rwkv_*.py``; ``chip_smoke.py``'s
``rwkv_variant`` applies the same two to a port model on the card). The
tests run ``rwkv_variant`` here, and their JAX subprocesses ``exec`` its
``SOURCE`` (with ``np`` in scope).

``decay_base`` -6 keeps every decay rate near 0.0025, far from the 0.9
clip, so the chunk's exp(0.9 x 32) rescaling never shows; ``mu`` at 0.02
makes the token shift nearly invisible."""

import inspect

import numpy as np

VARIANTS = ("init", "clip", "shift")


def rwkv_variant(tree, name):
    """A float32 numpy copy of a RWKV parameter tree (one layer's
    ``time_mix`` or ``channel_mix``, or a whole model's) with a variant:
    "clip" sets ``decay_base`` to +1.0, so every rate clips to 0.9; "shift"
    redraws both mixes' ``mu`` at scale 0.5 (a standard normal truncated to
    [-2, 2], from a fixed seed); "init" changes nothing."""
    def copy(t):
        if isinstance(t, dict):
            return {k: copy(v) for k, v in t.items()}
        return np.array(t, np.float32)
    if name not in ("init", "clip", "shift"):
        raise ValueError(name)
    tree = copy(tree)
    rng = np.random.default_rng(5)
    blocks = ([tree["layers"]["time_mix"], tree["layers"]["channel_mix"]]
              if "layers" in tree else [tree])
    for block in blocks:
        if name == "clip" and "decay_base" in block:
            block["decay_base"][...] = 1.0
        if name == "shift":
            block["mu"] = (np.clip(rng.normal(size=block["mu"].shape), -2, 2)
                           * 0.5).astype(np.float32)
    return tree


SOURCE = inspect.getsource(rwkv_variant)
