"""The MoE kernels at ``deepseek-v2-lite-16b``'s shapes on a card, each
against its plain version (``kernels.ref``): the router at (1, 8, 64) and
(4, 128, 64) with K 6 (indices and counts exact, fp32 outputs within
1e-6), ``histogram_offsets`` into 18 and 69 classes (exact), ``moe_gemm``
at d 2048 / F 1408 on 68 slots in its decode and prefill loops (3e-2, as
``tests/test_kernels.py``), the router's backward at the train step's
(1, 2048, 64) with K 6 (1e-6) and ``moe_gemm_bwd`` at F 1408 (2 bf16 ulps
of each output's largest element, as ``chip_smoke.py`` holds it). No JAX
here: the plain versions are held against the JAX Pallas kernels in
``tests/test_torch_moe_kernels.py`` and ``tests/test_torch_moe_models.py``.
Without a card every test skips.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
def test_cuda_router_and_histogram_at_deepseek_shapes():
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    ops.reset_launches()
    for R, T in ((1, 8), (4, 128)):
        logits = torch.randn((R, T, 64), generator=gen, device="cuda") * 2.0
        got = ops.fused_topk_route(logits, 6)
        want = ref.fused_topk_route_plain(logits, 6)
        assert torch.equal(got[0], want[0]) and torch.equal(got[4], want[4])
        for g, w in zip(got[1:4], want[1:4]):
            assert float((g - w).abs().max()) <= 1e-6
    for R, N, C in ((4, 48, 18), (4, 768, 69)):
        ids = torch.randint(-1, C + 2, (R, N), generator=gen, device="cuda",
                            dtype=torch.int32)
        got = ops.histogram_offsets(ids, C)
        want = ref.histogram_offsets_plain(ids, C)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.LAUNCHES["fused_topk_route"] == 2
    assert ops.LAUNCHES["histogram_offsets"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("T,B", [(8, 1), (128, 4)])
def test_cuda_moe_gemm_at_deepseek_width(T, B):
    """68 slots (64 experts on 4 ranks, one replica slot each) at d 2048,
    F 1408: the decode loop (T 8) and the prefill loop (T 128, 4 blocks
    of ragged live rows)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(1)
    E, S, d, F = 64, 68, 2048, 1408
    w = {n: (torch.randn(shape, generator=gen, device="cuda") * s).bfloat16()
         for n, shape, s in (("w_gate", (E, d, F), d ** -0.5),
                             ("w_up", (E, d, F), d ** -0.5),
                             ("w_down", (E, F, d), F ** -0.5))}
    se = torch.cat([torch.arange(E), torch.zeros(4, dtype=torch.long)]) \
        .to(torch.int32).cuda()
    x = torch.randn((S, T, d), generator=gen, device="cuda").bfloat16()
    counts = torch.randint(0, T // B + 1, (S, B), generator=gen,
                           device="cuda", dtype=torch.int32)
    args = (x, w["w_gate"], w["w_up"], w["w_down"], se, "swiglu")
    ops.reset_launches()
    got = ops.moe_gemm(*args, row_counts=counts)
    want = ref.moe_gemm_plain(*args, row_counts=counts)
    err = (got.float() - want.float()).abs()
    assert bool((err <= 3e-2 + 3e-2 * want.float().abs()).all())
    assert ops.LAUNCHES["moe_gemm"] == 1


@pytest.mark.cuda
def test_cuda_route_bwd_and_moe_gemm_bwd_at_deepseek_width():
    """The router's backward at the train step's (1, 2048, 64) with K 6,
    and ``moe_gemm_bwd`` over 64 slots of 4 x 48 rows at d 2048, F 1408
    (bf16, 2 ulps of each output's largest element, as phase 3 holds
    it)."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(2)
    logits = torch.randn((1, 2048, 64), generator=gen, device="cuda") * 2.0
    idx, _, probs, _, _ = ops.fused_topk_route(logits, 6)
    grads = [torch.randn(s, generator=gen, device="cuda")
             for s in ((1, 2048, 6), (1, 2048, 64), (1, 2048))]
    got = ops.fused_topk_route_bwd(probs, idx, *grads)
    want = ref.fused_topk_route_bwd_plain(probs, idx, *grads)
    assert float((got - want).abs().max()) <= 1e-6
    E, d, F, T = 64, 2048, 1408, 4 * 48
    w = [(torch.randn(shape, generator=gen, device="cuda") * s).bfloat16()
         for shape, s in (((E, d, F), d ** -0.5), ((E, d, F), d ** -0.5),
                          ((E, F, d), F ** -0.5))]
    counts = torch.randint(0, 49, (E, 4), generator=gen, device="cuda",
                           dtype=torch.int32)
    live = ref.live_rows_mask(counts, T)[..., None]
    x = (torch.randn((E, T, d), generator=gen, device="cuda") * live).bfloat16()
    dy = (torch.randn((E, T, d), generator=gen, device="cuda") * 0.1
          * live).bfloat16()
    se = torch.arange(E, dtype=torch.int32, device="cuda")
    got = ops.moe_gemm_bwd(x, *w, se, dy, "swiglu", counts)
    want = ref.moe_gemm_bwd_plain(x, *w, se, dy, "swiglu", counts)
    for g, v in zip(got, want):
        top = float(v.float().abs().max())
        assert float((g.float() - v.float()).abs().max()) <= \
            2 * 2.0 ** (np.floor(np.log2(max(top, 1e-6))) - 7)
