"""``paged_attn_impl`` on a card: "fused" launches the paged decode kernel
once a layer a decode step, and "gather" (each slot's view gathered from
its block table, then the plain blockwise oracle) launches none and serves
the same tokens, on ``ContinuousEngine`` with the reduced llava config
(G 2 over the paged pool). No JAX here: the card's machine has none. The
test is marked ``cuda`` and skips without a card:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_decode_leftovers_cuda.py
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.transformer import init_model  # noqa: E402
from repro_torch.serve import (ContinuousConfig, ContinuousEngine,  # noqa: E402
                               ServeRequest)


@pytest.mark.cuda
def test_fused_launches_the_kernel_and_gather_none_on_a_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the paged kernel has no CPU mode")
    cfg = get_config("llava-next-34b").reduced()
    model = init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                       device="cuda")
    out = {}
    for impl in ("fused", "gather"):
        c = dataclasses.replace(cfg, paged_attn_impl=impl)
        eng = ContinuousEngine(c, model, ContinuousConfig(
            max_slots=2, prefill_len=16, block_size=8, max_len=32))
        rng = np.random.default_rng(1)
        reqs = [ServeRequest(rid=i, tokens=rng.integers(
            0, c.vocab_size, n).astype(np.int32), max_new_tokens=4)
            for i, n in enumerate((7, 12))]
        for r in reqs:
            eng.submit(r)
        ops.reset_launches()
        now = 0.0
        while eng.has_work():
            eng.step(now)
            now += 1.0
        out[impl] = ([list(r.generated) for r in reqs],
                     ops.LAUNCHES["paged_decode_attention"], eng.decode_steps)
    tokens, fused, steps = out["fused"]
    assert fused == steps * cfg.num_layers and fused > 0
    assert out["gather"][1] == 0
    assert out["gather"][0] == tokens
