"""The router's backward kernel at the widths the paper's other MoE models
train at (E 64, 128 and 256; K 1 and 2; deepseek's E 64 with K 6), on a
card: held against its plain
version (``kernels.ref.fused_topk_route_bwd_plain``) within 1e-6, the sum
over E in another order, at one and several ranks, ragged row counts, tie
rows, each gradient alone and all three, and the train step's (1, 2048,
128) with K 1. No JAX here: the plain version is the oracle, and
``tests/test_torch_moe_models.py`` holds it against ``jax.grad`` on the
CPU. Without a card the test skips.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

WIDE_ROUTER = [(E, K) for E in (64, 128, 256) for K in (1, 2)] + [(64, 6)]
GRADS = ((True, True, True), (True, False, False), (False, True, False),
         (False, False, True))


def _route_case(R, T, E, K, seed):
    """fp32 logits (R, T, E) with the first two rows of every rank all
    tied, and the three gradients (gates, probs, lse) as numpy arrays."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(R, T, E)) * 2.0).astype(np.float32)
    x[:, :2] = 0.25                        # every expert tied
    grads = [rng.normal(size=s).astype(np.float32)
             for s in ((R, T, K), (R, T, E), (R, T))]
    return x, grads


@pytest.mark.cuda
def test_cuda_route_bwd_wide_equals_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    ops.reset_launches()
    n = 0
    for R, T, E, K in ([(r, t, e, k) for e, k in WIDE_ROUTER
                        for r, t in ((1, 8), (3, 65))]
                       + [(1, 2048, 128, 1)]):
        x, grads = _route_case(R, T, E, K, seed=T)
        idx, _, probs, _, _ = ops.fused_topk_route(torch.tensor(x).cuda(), K)
        assert (idx[:, :2] == torch.arange(K, dtype=torch.int32,
                                           device="cuda")).all()
        for use in GRADS:
            g = [torch.tensor(v).cuda() if u else None
                 for v, u in zip(grads, use)]
            got = ops.fused_topk_route_bwd(probs, idx, *g)
            torch.cuda.synchronize()
            want = ref.fused_topk_route_bwd_plain(probs, idx, *g)
            assert float((got - want).abs().max()) <= 1e-6, (R, T, E, K, use)
            n += 1
    assert ops.LAUNCHES["fused_topk_route_bwd"] == n
