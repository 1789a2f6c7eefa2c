"""Live rows in the port's ``moe_gemm``: the optional ``(S, B)`` row counts.

With ``row_counts``, rows ``[b*T/B, b*T/B + row_counts[s, b])`` of slot s
are live and every other row gives zeros, whatever it holds. On the CPU:

* with the dead rows zero-filled (what the dispatch's send buffer holds),
  the plain version with counts equals the JAX Pallas kernel
  (``interpret=True``) and the JAX oracle, which see only the zero rows,
  at ``tests/test_kernels.py``'s tolerances (1e-5 fp32, 3e-2 bf16);
* with garbage in the dead rows their outputs are exactly zero and the
  live rows are bit for bit those of the zero-filled run;
* ``check_inputs`` rejects counts of the wrong shape, dtype or device, and
  B not dividing T;
* ``_dispatch_round`` and ``ep_moe_ffn_replicated`` hand the kernel the
  packer's counts, ``(S, R_src)`` and ``(S, 1)``, and those counts mark
  exactly the rows the exchange filled.

The CUDA kernel's cases (expert groups of 1-3 slots, unnamed and
out-of-range experts, empty and ragged slots, ragged T, d and F, a group
larger than one pass, all activations in fp32 and bf16) are marked ``cuda``
and skip without a card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.moe_gemm import moe_gemm as jax_moe_gemm  # noqa: E402
from repro.kernels.ref import moe_gemm_ref as jax_gemm_ref  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.core.duplication import duplicate_experts_host  # noqa: E402
from repro_torch.core.placement import to_device  # noqa: E402
from repro_torch.kernels import moe_gemm as mg  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.moe import dispatch as ep  # noqa: E402
from repro_torch.moe.router import route  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 3e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(S, T, d, F, B, seed=0):
    """x (S, T, d), weights of E = S + 1 experts, a slot map with a replica,
    and (S, B) counts: ragged, one slot empty, one block full."""
    rng = np.random.default_rng(seed)
    E = S + 1
    x = rng.normal(size=(S, T, d)).astype(np.float32) * 0.1
    w = {n: (rng.normal(size=shape) * 0.05).astype(np.float32)
         for n, shape in (("w_gate", (E, d, F)), ("w_up", (E, d, F)),
                          ("w_down", (E, F, d)))}
    se = rng.permutation(E)[:S].astype(np.int32)
    se[-1] = se[0]
    tb = T // B
    counts = rng.integers(0, tb + 1, (S, B)).astype(np.int32)
    counts[0, 0] = tb
    if S > 1:
        counts[1] = 0
    return x, w, se, counts


def _live(counts, T):
    return ref.live_rows_mask(torch.tensor(counts), T).numpy()


def _port(x, w, se, activation, dtype, counts):
    tw = {n: torch.tensor(a).to(TORCH[dtype]) for n, a in w.items()}
    return ops.moe_gemm(torch.tensor(x).to(TORCH[dtype]),
                        tw["w_gate"] if activation == "swiglu" else None,
                        tw["w_up"], tw["w_down"], torch.tensor(se), activation,
                        row_counts=None if counts is None
                        else torch.tensor(counts))


@pytest.mark.parametrize("S,T,d,F,B", [
    (3, 8, 128, 256, 1),          # decode-shaped: one block per slot
    (4, 32, 64, 136, 4),          # four source ranks' blocks, F ragged
    (2, 100, 128, 300, 2),        # ragged T and F
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["swiglu", "gelu", "relu"])
def test_row_counts_plain_matches_jax_kernel_and_oracle(S, T, d, F, B, dtype,
                                                        activation):
    x, w, se, counts = _inputs(S, T, d, F, B)
    x[~_live(counts, T)] = 0.0                    # the send buffer's padding
    jx = jnp.asarray(x, JNP[dtype])
    jw = {n: jnp.asarray(a[se], JNP[dtype]) for n, a in w.items()}
    want_kernel = jax_moe_gemm(jx, jw["w_gate"], jw["w_up"], jw["w_down"],
                               activation=activation, interpret=True)
    want_oracle = jax_gemm_ref(jx, jw["w_gate"], jw["w_up"], jw["w_down"],
                               activation)
    got = _port(x, w, se, activation, dtype, counts)
    assert got.dtype == TORCH[dtype] and got.shape == (S, T, d)
    tol = TOL[dtype]
    for want in (want_kernel, want_oracle):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)
    assert not got[torch.tensor(~_live(counts, T))].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("garbage", ["nan", "inf", "large"])
def test_dead_rows_give_zeros_whatever_they_hold(dtype, garbage):
    S, T, d, F, B = 4, 24, 32, 48, 3
    x, w, se, counts = _inputs(S, T, d, F, B, seed=1)
    dead = ~_live(counts, T)
    x[dead] = 0.0
    clean = _port(x, w, se, "swiglu", dtype, counts)
    x[dead] = {"nan": np.nan, "inf": np.inf, "large": 3e4}[garbage]
    got = _port(x, w, se, "swiglu", dtype, counts)
    dead_t = torch.tensor(dead)
    assert torch.equal(got[dead_t], torch.zeros_like(got[dead_t]))
    assert torch.equal(got[~dead_t], clean[~dead_t])
    assert torch.isfinite(got.float()).all()


def test_out_of_range_expert_gives_zeros():
    x, w, se, counts = _inputs(3, 8, 16, 24, 1, seed=2)
    se[1] = 99
    got = _port(x, w, se, "swiglu", "float32", None)
    assert not got[1].any() and got[0].abs().sum() > 0


def test_counts_past_the_block_or_below_zero_are_clamped():
    x, w, se, _ = _inputs(2, 8, 16, 24, 2, seed=3)
    counts = np.array([[9, -3], [4, 4]], np.int32)   # block of 4 rows
    got = _port(x, w, se, "relu", "float32", counts)
    want = _port(x, w, se, "relu", "float32", np.array([[4, 0], [4, 4]],
                                                       np.int32))
    assert torch.equal(got, want)
    assert not got[0, 4:].any() and got[0, :4].abs().sum() > 0


@pytest.mark.parametrize("case", ["rank", "rows", "dtype", "blocks_divide",
                                  "device", "noncontiguous"])
def test_check_inputs_rejects_bad_row_counts(case):
    x, w, se, counts = _inputs(2, 8, 16, 24, 2)
    tc = torch.tensor(counts)
    if case == "rank":
        tc = tc.reshape(-1)
    elif case == "rows":
        tc = torch.cat([tc, tc])
    elif case == "dtype":
        tc = tc.long()
    elif case == "blocks_divide":
        tc = torch.zeros((2, 3), dtype=torch.int32)  # 3 does not divide 8
    elif case == "device":
        tc = tc.to("meta")
    else:
        tc = torch.zeros((4, 2), dtype=torch.int32)[::2]
    args = (torch.tensor(x), torch.tensor(w["w_gate"]), torch.tensor(w["w_up"]),
            torch.tensor(w["w_down"]), torch.tensor(se), "swiglu", tc)
    with pytest.raises((TypeError, ValueError)):
        mg.check_inputs(*args)
    with pytest.raises((TypeError, ValueError)):
        ops.moe_gemm(*args[:6], row_counts=tc)


# --------------------------------------------------------------------------
# the dispatch hands the kernel the packer's counts
# --------------------------------------------------------------------------

R, D_MODEL, F_FF, E, K = 4, 16, 32, 8, 2


def _ep_setup(seed=0, T=12):
    rng = np.random.default_rng(seed)
    moe = MoEConfig(num_experts=E, top_k=K, d_ff_expert=F_FF,
                    capacity_factor=1.0, duplication_slots=1)
    dist = rng.random(E) ** 4
    dist[0] += 1.0
    plan = to_device(duplicate_experts_host(dist / dist.sum(), R, 1, 4).plan,
                     E, R, 1, "cpu")
    w = {n: torch.tensor(rng.normal(size=s) * 0.1, dtype=torch.float32)
         for n, s in (("w_gate", (E, D_MODEL, F_FF)),
                      ("w_up", (E, D_MODEL, F_FF)),
                      ("w_down", (E, F_FF, D_MODEL)))}
    x = torch.tensor(rng.normal(size=(R, T, D_MODEL)) + 1.0,
                     dtype=torch.float32)
    wr = torch.tensor(rng.normal(size=(D_MODEL, E)), dtype=torch.float32)
    wr[:, 0] += 1.0                                   # expert 0 hot: drops
    return moe, plan, w, x, wr


def _recording(monkeypatch):
    calls = []
    real = ops.moe_gemm

    def record(x, w_gate, w_up, w_down, slot_experts, activation="swiglu",
               row_counts=None):
        out = real(x, w_gate, w_up, w_down, slot_experts, activation,
                   row_counts=row_counts)
        calls.append((x, slot_experts, row_counts, out))
        return out
    monkeypatch.setattr(ops, "moe_gemm", record)
    return calls


def _check_counts_mark_filled_rows(x, counts, out, slot_experts, w):
    S, T_s, _ = x.shape
    assert counts.dtype == torch.int32 and counts.is_contiguous()
    live = ref.live_rows_mask(counts, T_s)
    filled = x.abs().sum(-1) > 0           # tokens are nonzero; padding is 0
    assert torch.equal(live, filled)
    assert int(counts.sum()) == int(filled.sum()) > 0
    # the counts change nothing: padding rows give zeros either way
    plain = ref.moe_gemm_plain(x, w["w_gate"], w["w_up"], w["w_down"],
                               slot_experts)
    assert torch.equal(out, plain)


def test_dispatch_round_passes_packer_counts_per_source_rank(monkeypatch):
    moe, plan, w, x, wr = _ep_setup()
    calls = _recording(monkeypatch)
    ro = route(wr, moe, x)
    y, stats = ep.ep_moe_ffn(x, ro, w, plan, moe, ep_ranks=R)
    (xs, se, counts, out), = calls
    S = R * (E // R + 1)
    cap = xs.shape[1] // R
    assert counts.shape == (S, R) and xs.shape[0] == S
    assert int(stats.dropped) > 0                  # capacity was hit
    assert int(counts.max()) <= cap
    # per global slot, the pairs kept from every source rank
    assert torch.equal(counts.sum(dim=1), stats.slot_counts.to(torch.int32))
    _check_counts_mark_filled_rows(xs, counts, out, se, w)


def test_replicated_dispatch_passes_packer_counts_per_slot(monkeypatch):
    moe, plan, w, x, wr = _ep_setup(seed=1, T=8)
    calls = _recording(monkeypatch)
    ro = route(wr, moe, x[0])
    y, stats = ep.ep_moe_ffn_replicated(x[0], ro, w, plan, moe, ep_ranks=R)
    (xs, se, counts, out), = calls
    S = R * (E // R + 1)
    assert counts.shape == (S, 1) and xs.shape[0] == S
    assert torch.equal(counts[:, 0], stats.slot_counts.to(torch.int32))
    _check_counts_mark_filled_rows(xs, counts, out, se, w)
    send, counts2, se2 = ep.pack_replicated(x[0], ro, plan, moe,
                                            ep_ranks=R)[:3]
    assert torch.equal(send, xs) and torch.equal(counts2, counts)
    assert torch.equal(se2, se)


# --------------------------------------------------------------------------
# the CUDA kernel against its plain version (on a card only)
# --------------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _cuda_case(S, T, d, F, E_, se, counts, dtype, activation, seed=0,
               garbage=True):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((S, T, d), generator=gen) * 0.5
    w = {n: torch.randn(shape, generator=gen) * shape[1] ** -0.5
         for n, shape in (("w_gate", (E_, d, F)), ("w_up", (E_, d, F)),
                          ("w_down", (E_, F, d)))}
    x, w = x.to(TORCH[dtype]).cuda(), {n: a.to(TORCH[dtype]).cuda()
                                       for n, a in w.items()}
    se = torch.tensor(se, dtype=torch.int32).cuda()
    tc = None if counts is None else torch.tensor(counts, dtype=torch.int32).cuda()
    if tc is not None and garbage:
        x[~ref.live_rows_mask(tc, T)] = float("nan")
    wg = w["w_gate"] if activation == "swiglu" else None
    got = ops.moe_gemm(x, wg, w["w_up"], w["w_down"], se, activation,
                       row_counts=tc)
    torch.cuda.synchronize()
    want = ref.moe_gemm_plain(x, wg, w["w_up"], w["w_down"], se, activation,
                              row_counts=tc)
    tol = 3e-2 if dtype == "bfloat16" else 1e-4
    err = (got.float() - want.float()).abs()
    assert bool((err <= tol + tol * want.float().abs()).all()), float(err.max())
    if tc is not None:
        dead = ~ref.live_rows_mask(tc, T)
        assert not got[dead].any()


# slots 0, 3, 5 name expert 0 (a group of 3), 1 and 7 expert 1 (2), 2 and
# 4 one expert each, expert 4 no slot, slot 6 an out-of-range expert
GROUPED_SE = [0, 1, 2, 0, 3, 0, 9, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("activation", ["swiglu", "gelu", "relu"])
@pytest.mark.parametrize("T,d,F,B", [
    (8, 256, 512, 1),             # decode loop, one block per slot
    (40, 200, 328, 2),            # decode loop: T, d, F off every tile
    (128, 256, 512, 4),           # prefill loop (wgmma), four blocks
    (100, 200, 328, 4),           # prefill loop: ragged T, d, F
    (192, 128, 256, 3),           # prefill loop: two row tiles
    (64, 130, 250, 2),            # rows that are not 16-byte chunks
])
def test_cuda_moe_gemm_row_counts_match_plain_version(dtype, activation, T, d,
                                                      F, B):
    _need_card()
    rng = np.random.default_rng(T + d)
    tb = T // B
    counts = rng.integers(0, tb + 1, (len(GROUPED_SE), B))
    counts[1] = 0                              # an all-empty slot
    counts[0, 0] = tb
    ops.reset_launches()
    _cuda_case(len(GROUPED_SE), T, d, F, 5, GROUPED_SE, counts, dtype,
               activation)
    _cuda_case(len(GROUPED_SE), T, d, F, 5, GROUPED_SE, None, dtype,
               activation, garbage=False)
    assert ops.LAUNCHES["moe_gemm"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("T", [16, 128])
def test_cuda_moe_gemm_all_slots_empty(T):
    _need_card()
    _cuda_case(4, T, 128, 256, 3, [0, 1, 0, 2], np.zeros((4, 1)), "bfloat16",
               "swiglu")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_moe_gemm_group_larger_than_one_pass(dtype):
    """Six slots of 64 live rows on one expert: 384 rows, six passes of
    the decode loop's 64-row gather."""
    _need_card()
    _cuda_case(6, 64, 256, 256, 2, [0] * 6, np.full((6, 2), 32), dtype,
               "swiglu")
