"""The two launch-bound kernels of the PyTorch port, ``fused_topk_route``
and ``histogram_offsets``, at the shapes where their Hopper designs change.

The router kernel packs 32 / SEG rows into a warp for E <= 16 (SEG = E
rounded up to a power of two) and gives a row a whole warp above that; a
rank's rows run in one cluster of 1 to 8 CTAs whose warps loop when T needs
more, and the cluster's first CTA stores the counts (nothing is zeroed
before the launch). The histogram kernel runs a warp per rank row for
C <= 32 classes and a CTA per row above that.

On the CPU the plain versions (``repro_torch.kernels.ref``) are held against
the JAX Pallas kernels, run as their own tests run them
(``interpret=True``), at those boundaries: E of 8, 16, 17 and 256, K up to
8, T of 1, 63, 64 and 65; C of 32 and 33, N of 16 to 40000. Indices and
counts exact, fp32 outputs within 1e-6; histograms exact.

The ``cuda`` tests run the CUDA kernels on a card (they skip here): every
T of 1, 8, 63, 64, 65, 128, 512 and 4096 with R of 1 and 4, E of 8, 16, 17
and 256 and K of 1..8 for the router; C of 4, 13, 32 and 33, N of 0, 16,
256 and 40000 and R of 1, 4 and 33 for the histogram, with ids out of
range. The router's indices must match the plain version exactly except on
near-tie rows (sorted top-(K+1) probabilities holding two within 4 ulps,
which the two orders of summation may break differently), rows of exact
ties must pick experts 0..K-1, fp32 outputs agree within 1e-6 and counts
exactly; histograms are exact. Both wrappers are also captured in a CUDA
graph and replayed on new inputs, and a launch the kernel refuses raises.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.histogram import histogram_offsets as jax_hist  # noqa: E402
from repro.kernels.topk_router import fused_topk_route as jax_route  # noqa: E402
from repro_torch.kernels import histogram as hist_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TIE_ROWS = 3                  # rows of equal logits at each rank's start


def _logits(R, T, E, seed=0):
    rng = np.random.default_rng(seed + 1000 * E + T)
    logits = (rng.normal(size=(R, T, E)) * 2.0).astype(np.float32)
    logits[:, :TIE_ROWS] = 0.25
    return logits


def _ids(R, N, C, seed=0):
    rng = np.random.default_rng(seed + 7 * N + C)
    return rng.integers(-2, C + 3, (R, N)).astype(np.int32)


# --------------------------------------------------------------------------
# the plain versions against the Pallas kernels, at the designs' boundaries
# --------------------------------------------------------------------------

@pytest.mark.parametrize("R,T,E,K", [(1, 1, 8, 8), (2, 65, 16, 3),
                                     (2, 63, 17, 5), (1, 64, 256, 8)])
def test_fused_topk_route_plain_matches_jax_kernel_at_boundaries(R, T, E, K):
    logits = _logits(R, T, E)
    got = ops.fused_topk_route(torch.tensor(logits), K)
    for r in range(R):
        want = jax_route(jnp.asarray(logits[r]), K, interpret=True)
        np.testing.assert_array_equal(got[0][r].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[4][r].numpy(), np.asarray(want[4]))
        for g, w in zip(got[1:4], want[1:4]):
            np.testing.assert_allclose(g[r].numpy(), np.asarray(w), atol=1e-6,
                                       rtol=0)
    np.testing.assert_array_equal(got[0][:, :TIE_ROWS].numpy(),
                                  np.broadcast_to(np.arange(K),
                                                  (R, min(T, TIE_ROWS), K)))


@pytest.mark.parametrize("R,N,C", [(2, 16, 32), (2, 256, 33), (3, 100, 4),
                                   (1, 40000, 32)])
def test_histogram_offsets_plain_matches_jax_kernel_at_boundaries(R, N, C):
    ids = _ids(R, N, C)
    counts, starts = ops.histogram_offsets(torch.tensor(ids), C)
    for r in range(R):
        jc, js = jax_hist(jnp.asarray(ids[r]), C, interpret=True)
        np.testing.assert_array_equal(counts[r].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(starts[r].numpy(), np.asarray(js))
    assert int(counts.sum()) == int(((ids >= 0) & (ids < C)).sum())


# --------------------------------------------------------------------------
# the CUDA kernels against their plain versions (on a card only)
# --------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _route_agrees(logits, K):
    """The kernel's outputs against the plain version's, as the module
    docstring states. Returns a failure message or ''."""
    got = ops.fused_topk_route(logits, K)
    torch.cuda.synchronize()
    want = ref.fused_topk_route_plain(logits, K)
    top = torch.sort(want[2], dim=-1, descending=True).values[..., :K + 1]
    near = ((top[..., :-1] - top[..., 1:])
            <= 4 * torch.finfo(torch.float32).eps * top[..., :-1]).any(-1)
    differ = (got[0] != want[0]).any(-1)
    if bool((differ & ~near).any()):
        return f"{int((differ & ~near).sum())} rows routed differently"
    ties = torch.arange(K, dtype=torch.int32, device=logits.device)
    if not bool((got[0][:, :TIE_ROWS] == ties).all()):
        return "a row of exact ties did not pick experts 0..K-1"
    err = max(float((g - w).abs().max()) for g, w in zip(got[1:4], want[1:4]))
    if err > 1e-6:
        return f"fp32 outputs differ by {err}"
    if not bool(differ.any()) and not torch.equal(got[4], want[4]):
        return "counts differ"
    return ""


@pytest.mark.cuda
@pytest.mark.parametrize("E", [8, 16, 17, 256])
def test_cuda_fused_topk_route_across_its_design_boundaries(E):
    _need_card()
    ops.reset_launches()
    failures = []
    for T in (1, 8, 63, 64, 65, 128, 512, 4096):
        for R in (1, 4):
            logits = torch.tensor(_logits(R, T, E)).cuda()
            for K in range(1, 9):
                msg = _route_agrees(logits, K)
                if msg:
                    failures.append(f"R{R} T{T} E{E} K{K}: {msg}")
    assert not failures, failures
    assert ops.LAUNCHES["fused_topk_route"] == 8 * 2 * 8


@pytest.mark.cuda
@pytest.mark.parametrize("C", [4, 13, 32, 33])
def test_cuda_histogram_offsets_across_its_design_boundaries(C):
    _need_card()
    ops.reset_launches()
    for N in (0, 16, 256, 40000):
        for R in (1, 4, 33):
            ids = torch.tensor(_ids(R, N, C)).cuda()
            got = ops.histogram_offsets(ids, C)
            torch.cuda.synchronize()
            want = ref.histogram_offsets_plain(ids, C)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (R, N, C)
    assert ops.LAUNCHES["histogram_offsets"] == 4 * 3


@pytest.mark.cuda
def test_cuda_graph_replays_both_kernels_on_new_inputs():
    _need_card()
    logits = torch.tensor(_logits(4, 128, 8)).cuda()
    ids = torch.tensor(_ids(4, 256, 13)).cuda()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):              # warm up off the capture
        ops.fused_topk_route(logits, 2)
        ops.histogram_offsets(ids, 13)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        routed = ops.fused_topk_route(logits, 2)
        hist = ops.histogram_offsets(ids, 13)
    for seed in (1, 2):
        new_logits = torch.tensor(_logits(4, 128, 8, seed)).cuda()
        new_ids = torch.tensor(_ids(4, 256, 13, seed)).cuda()
        logits.copy_(new_logits)
        ids.copy_(new_ids)
        graph.replay()
        torch.cuda.synchronize()
        eager = ops.fused_topk_route(new_logits, 2)
        assert all(torch.equal(g, e) for g, e in zip(routed, eager))
        eager = ops.histogram_offsets(new_ids, 13)
        assert all(torch.equal(g, e) for g, e in zip(hist, eager))


@pytest.mark.cuda
def test_cuda_outputs_are_contiguous_views_and_refused_launches_raise():
    _need_card()
    routed = ops.fused_topk_route(torch.zeros((2, 5, 8), device="cuda"), 2)
    hist = ops.histogram_offsets(
        torch.zeros((2, 6), dtype=torch.int32, device="cuda"), 3)
    assert all(t.is_contiguous() for t in routed + hist)
    hist_kernel.launch_empty()
    torch.cuda.synchronize()
    # more ranks than a grid's y dimension takes: the launch is refused
    with pytest.raises(RuntimeError):
        ops.fused_topk_route(torch.zeros((65536, 1, 8), device="cuda"), 2)
