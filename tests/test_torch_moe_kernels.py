"""The expert-parallel path's three kernels in the PyTorch port, against the
JAX package.

Each plain version (``repro_torch.kernels.ref``) is held against the JAX
Pallas kernel, run as its own tests run it (``interpret=True``), and
against the JAX oracle (``src/repro/kernels/ref.py``) or reference router:

* ``moe_gemm``: a subset of ``tests/test_kernels.py``'s shapes, ragged T
  and F included, all three activations. The port reads each slot's
  weights through a slot -> expert map; the JAX kernel gets the same
  weights stacked per slot. Tolerances are ``tests/test_kernels.py``'s:
  1e-5 in fp32 (the same arithmetic, summed in another order) and 3e-2 in
  bf16 (against the oracle, which rounds the gate product to bf16 before
  the activation; the Pallas body and the port keep it in fp32).
* ``fused_topk_route``: indices and counts exact, probabilities, gates and
  logsumexp within 1e-6, over several ranks' rows at once.
* ``histogram_offsets``: exact, with ids outside the classes and N not a
  multiple of the Pallas block.

On CPU tensors the wrappers run the plain versions and count no launch;
inputs the kernels do not take raise. The CUDA kernels themselves run
only on a card: their tests are marked ``cuda`` and skip here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.histogram import histogram_offsets as jax_hist  # noqa: E402
from repro.kernels.moe_gemm import moe_gemm as jax_moe_gemm  # noqa: E402
from repro.kernels.ref import moe_gemm_ref as jax_gemm_ref  # noqa: E402
from repro.kernels.topk_router import fused_topk_route as jax_route  # noqa: E402
from repro_torch.kernels import histogram as hist_kernel  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _gemm_inputs(S, T, d, F, seed=0):
    """x (S,T,d), expert weights for E = S + 1 experts, and a slot ->
    expert map that repeats an expert (a replica) and skips one."""
    rng = np.random.default_rng(seed)
    E = S + 1
    x = rng.normal(size=(S, T, d)).astype(np.float32) * 0.1
    w = {n: (rng.normal(size=shape) * 0.05).astype(np.float32)
         for n, shape in (("w_gate", (E, d, F)), ("w_up", (E, d, F)),
                          ("w_down", (E, F, d)))}
    se = rng.permutation(E)[:S].astype(np.int32)
    se[-1] = se[0]
    return x, w, se


# --------------------------------------------------------------------------
# moe_gemm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("S,T,d,F", [
    (1, 8, 128, 256),          # minimal
    (2, 100, 128, 300),        # ragged T and F
    (4, 24, 64, 136),          # several slots, F not a block multiple
    (2, 8, 2048, 1408),        # deepseek-v2-lite-16b's expert width
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["swiglu", "gelu", "relu"])
def test_moe_gemm_plain_matches_jax_kernel_and_oracle(S, T, d, F, dtype,
                                                      activation):
    x, w, se = _gemm_inputs(S, T, d, F)
    jx = jnp.asarray(x, JNP[dtype])
    jw = {n: jnp.asarray(a[se], JNP[dtype]) for n, a in w.items()}
    want_kernel = jax_moe_gemm(jx, jw["w_gate"], jw["w_up"], jw["w_down"],
                               activation=activation, interpret=True)
    want_oracle = jax_gemm_ref(jx, jw["w_gate"], jw["w_up"], jw["w_down"],
                               activation)
    tw = {n: torch.tensor(a).to(TORCH[dtype]) for n, a in w.items()}
    got = ops.moe_gemm(torch.tensor(x).to(TORCH[dtype]),
                       tw["w_gate"] if activation == "swiglu" else None,
                       tw["w_up"], tw["w_down"], torch.tensor(se), activation)
    assert got.dtype == TORCH[dtype] and got.shape == (S, T, d)
    tol = TOL[dtype]
    for want in (want_kernel, want_oracle):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


# --------------------------------------------------------------------------
# fused_topk_route
# --------------------------------------------------------------------------

@pytest.mark.parametrize("R,T,E,K", [(3, 200, 8, 2), (2, 37, 16, 1),
                                     (1, 300, 64, 4),
                                     # deepseek's decode and prefill routes
                                     (1, 8, 64, 6), (4, 128, 64, 6)])
def test_fused_topk_route_plain_matches_jax_kernel(R, T, E, K):
    rng = np.random.default_rng(R * 100 + E)
    logits = rng.normal(size=(R, T, E)).astype(np.float32)
    logits[0, :5] = 0.25                      # rows of exact ties
    got = ops.fused_topk_route(torch.tensor(logits), K)
    assert [tuple(t.shape) for t in got] == [(R, T, K), (R, T, K), (R, T, E),
                                             (R, T), (R, E)]
    assert got[0].dtype == torch.int32 and got[4].dtype == torch.int32
    for r in range(R):
        want = jax_route(jnp.asarray(logits[r]), K, interpret=True)
        np.testing.assert_array_equal(got[0][r].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[4][r].numpy(), np.asarray(want[4]))
        for g, w in zip(got[1:4], want[1:4]):
            np.testing.assert_allclose(g[r].numpy(), np.asarray(w), atol=1e-6,
                                       rtol=0)
    # ties go to the lowest expert index, as lax.top_k breaks them
    np.testing.assert_array_equal(got[0][0, 0].numpy(), np.arange(K))
    assert int(got[4].sum()) == R * T * K


# --------------------------------------------------------------------------
# histogram_offsets
# --------------------------------------------------------------------------

@pytest.mark.parametrize("R,N,C", [(4, 256, 13), (4, 16, 4), (2, 1100, 7),
                                   (1, 5, 33),
                                   # deepseek's decode and prefill packers
                                   (4, 48, 18), (4, 768, 69)])
def test_histogram_offsets_plain_matches_jax_kernel(R, N, C):
    rng = np.random.default_rng(N + C)
    ids = rng.integers(0, C, (R, N)).astype(np.int32)
    ids[:, ::7] = C - 1                           # the overflow class is busy
    ids[0, :3] = (-1, C, C + 5)                   # outside: never counted
    counts, starts = ops.histogram_offsets(torch.tensor(ids), C)
    assert counts.dtype == starts.dtype == torch.int32
    for r in range(R):
        jc, js = jax_hist(jnp.asarray(ids[r]), C, interpret=True)
        np.testing.assert_array_equal(counts[r].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(starts[r].numpy(), np.asarray(js))
    assert int(counts[0].sum()) == N - 3


# --------------------------------------------------------------------------
# the wrappers: plain version on the CPU, checks on what the kernels take
# --------------------------------------------------------------------------

def test_cpu_tensors_run_the_plain_versions_without_launches():
    ops.reset_launches()
    x, w, se = _gemm_inputs(2, 8, 16, 24)
    ops.moe_gemm(torch.tensor(x), torch.tensor(w["w_gate"]),
                 torch.tensor(w["w_up"]), torch.tensor(w["w_down"]),
                 torch.tensor(se))
    ops.fused_topk_route(torch.zeros((2, 4, 8)), 2)
    ops.histogram_offsets(torch.zeros((2, 6), dtype=torch.int32), 3)
    assert ops.LAUNCHES == {k: 0 for k in ops.LAUNCHES}
    assert {"moe_gemm", "fused_topk_route", "histogram_offsets",
            "paged_decode_attention", "rg_lru_scan", "fused_topk_route_bwd",
            "rg_lru_scan_bwd", "moe_gemm_bwd"} == set(ops.LAUNCHES)


@pytest.mark.parametrize("case", [
    "x_rank", "w_dtype", "slot_map_dtype", "slot_map_shape", "down_shape",
    "activation", "noncontiguous"])
def test_moe_gemm_rejects_what_the_kernel_does_not_take(case):
    x, w, se = _gemm_inputs(2, 8, 16, 24)
    args = dict(x=torch.tensor(x), w_gate=torch.tensor(w["w_gate"]),
                w_up=torch.tensor(w["w_up"]), w_down=torch.tensor(w["w_down"]),
                slot_experts=torch.tensor(se), activation="swiglu")
    if case == "x_rank":
        args["x"] = args["x"][0]
    elif case == "w_dtype":
        args["w_up"] = args["w_up"].to(torch.bfloat16)
    elif case == "slot_map_dtype":
        args["slot_experts"] = args["slot_experts"].long()
    elif case == "slot_map_shape":
        args["slot_experts"] = args["slot_experts"][:1]
    elif case == "down_shape":
        args["w_down"] = args["w_down"][:, :-1]
    elif case == "activation":
        args["activation"] = "tanh"
    else:
        args["x"] = args["x"].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises((TypeError, ValueError)):
        ops.moe_gemm(**args)


@pytest.mark.parametrize("case", ["rank", "dtype", "top_k", "too_many_experts"])
def test_fused_topk_route_rejects_what_the_kernel_does_not_take(case):
    logits, k = torch.zeros((1, 4, 8)), 2
    if case == "rank":
        logits = logits[0]
    elif case == "dtype":
        logits = logits.to(torch.bfloat16)
    elif case == "top_k":
        k = 9
    else:
        logits = torch.zeros((1, 4, 300))
    with pytest.raises((TypeError, ValueError)):
        ops.fused_topk_route(logits, k)


@pytest.mark.parametrize("case", ["rank", "dtype", "no classes",
                                  "too many classes"])
def test_histogram_offsets_rejects_what_the_kernel_does_not_take(case):
    ids, c = torch.zeros((2, 6), dtype=torch.int32), 3
    if case == "rank":
        ids = ids[0]
    elif case == "dtype":
        ids = ids.long()
    elif case == "no classes":
        c = 0
    else:
        c = hist_kernel.MAX_CLASSES + 1     # more than the shared memory holds
    with pytest.raises((TypeError, ValueError)):
        ops.histogram_offsets(ids, c)


# --------------------------------------------------------------------------
# the CUDA kernels against their plain versions (on a card only)
# --------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_moe_gemm_matches_plain_version(dtype):
    _need_card()
    ops.reset_launches()
    for S, T, d, F in ((1, 8, 128, 256), (2, 100, 128, 300), (12, 128, 256, 512)):
        x, w, se = _gemm_inputs(S, T, d, F)
        dev = {n: torch.tensor(a).to(TORCH[dtype]).cuda() for n, a in w.items()}
        xs = torch.tensor(x).to(TORCH[dtype]).cuda()
        for act in ("swiglu", "gelu", "relu"):
            args = (xs, dev["w_gate"], dev["w_up"], dev["w_down"],
                    torch.tensor(se).cuda(), act)
            got = ops.moe_gemm(*args)
            torch.cuda.synchronize()
            want = ref.moe_gemm_plain(*args)
            tol = TOL[dtype]
            np.testing.assert_allclose(got.float().cpu().numpy(),
                                       want.float().cpu().numpy(),
                                       atol=tol, rtol=tol)
    assert ops.LAUNCHES["moe_gemm"] == 9


@pytest.mark.cuda
def test_cuda_fused_topk_route_matches_plain_version():
    _need_card()
    ops.reset_launches()
    logits = torch.randn((4, 128, 8), generator=torch.Generator().manual_seed(0))
    got = ops.fused_topk_route(logits.cuda(), 2)
    torch.cuda.synchronize()
    want = ref.fused_topk_route_plain(logits.cuda(), 2)
    assert torch.equal(got[0], want[0]) and torch.equal(got[4], want[4])
    for g, w in zip(got[1:4], want[1:4]):
        assert float((g - w).abs().max()) <= 1e-6
    assert ops.LAUNCHES["fused_topk_route"] == 1


@pytest.mark.cuda
def test_cuda_histogram_offsets_matches_plain_version():
    _need_card()
    ops.reset_launches()
    gen = torch.Generator().manual_seed(0)
    # the main path's prefill shape, then the most classes the kernel takes
    for N, C in ((256, 13), (40000, hist_kernel.MAX_CLASSES)):
        ids = torch.randint(-1, C + 2, (4, N), dtype=torch.int32,
                            generator=gen).cuda()
        got = ops.histogram_offsets(ids, C)
        torch.cuda.synchronize()
        want = ref.histogram_offsets_plain(ids, C)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert ops.LAUNCHES["histogram_offsets"] == 2
