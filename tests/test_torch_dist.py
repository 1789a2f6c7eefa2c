"""The EP dispatch with one rank a process (``ProcessGroupRanks`` over
``torch.distributed``) against the same dispatch with its ranks stacked on
one device (``StackedRanks``), on the CPU.

One world of four ``gloo`` processes (``launch.mesh.spawn``, a ``file://``
init under pytest's temporary directory, one intra-op thread each) runs
every case of ``tests/_torch_dist.py``: ``ep_moe_ffn`` plain, on
Token-to-Expert predictions and under a reschedule quota;
``ep_moe_ffn_replicated`` plain and under a quota; without a store the
process ranks build their replica slots through ``gather_replica_pool``
(an ``all_gather`` of one home expert a rank); with one, the store's fill
from the identity plan moves each replica row from its expert's home rank
(point to point), and each rank's rows must equal its block of the stacked
store's. This process runs the stacked cases.

At top-2 each rank's outputs are bit-equal to the stacked run's rows: the
all-to-all moves rows unchanged, the expert FFN computes each slot alone,
and the decode psum adds at most two nonzero partials a token. At top-4
the decode psum adds up to four partials in the ring's order, not the
stacked sum's; the tolerance there is one bf16 ulp of the outputs'
magnitude (``K4_ATOL``). The slot counts, drops, overflows and expert
counts are exact everywhere; the averaged router losses agree to 1e-6.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tests import _torch_dist as cases  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.sharding import EXPERT_SPEC, shard_tensor  # noqa: E402

class _ModelAxis:
    shape = {"model": cases.R}


COUNTS = ("expert_counts", "slot_counts", "dropped", "overflow")
K4_ATOL = 2.0 ** -6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks():
    names = sorted(cases.CASES)
    return mesh_mod.spawn(cases.run_rank, (names,), data=1, model=cases.R,
                          backend="gloo", threads=1, timeout_s=300)


def _rank_y(out, name, r):
    y = out["y"]
    return y if "decode" in cases.CASES[name][3] else y[r]


@pytest.mark.parametrize("name", sorted(cases.CASES))
def test_process_ranks_match_stacked_ranks(ranks, name):
    want = cases.run(name)
    top_k = cases.CASES[name][0]
    y_want = want["y"]
    for r, got in enumerate(ranks):
        got = got[name]
        y_got = _rank_y(got, name, 0)
        ref = y_want if "decode" in cases.CASES[name][3] else y_want[r]
        if top_k == 2:
            np.testing.assert_array_equal(y_got, ref, err_msg=f"rank {r}")
        else:
            np.testing.assert_allclose(y_got, ref, atol=K4_ATOL, rtol=0,
                                       err_msg=f"rank {r}")
        for k in COUNTS:
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{k}, rank {r}")
        for k in ("aux_loss", "z_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6,
                                       err_msg=f"{k}, rank {r}")


def test_cases_drop_and_replicate(ranks):
    """The comparisons bite: pairs are dropped and replica slots serve."""
    moe, inputs = cases.make_case("prefill")
    assert (inputs["plan"][0] > 1).any()
    assert cases.run("prefill")["dropped"] > 0
    assert cases.run("quota")["overflow"] > 0
    assert cases.run("decode_quota")["overflow"] > 0
    assert cases.run("store_decode")["dropped"] > 0
    sc = cases.run("decode")["slot_counts"].reshape(cases.R, -1)
    assert sc[:, cases.E // cases.R:].sum() > 0


@pytest.mark.parametrize("name", ["store", "store_decode"])
def test_process_store_fill_matches_stacked_store(ranks, name):
    moe, _ = cases.make_case(name)
    want = cases.run(name)["store_rows"]
    for r, got in enumerate(ranks):
        block = cases.stacked_rows(want, r, moe)
        for k, w in got[name]["store_rows"].items():
            np.testing.assert_array_equal(w, block[k], err_msg=f"{k}, {r}")
        # the home rows are the rank's block under the expert rule
        home = shard_tensor(torch.tensor(want["w_up"][:cases.E]),
                            EXPERT_SPEC, {"model": r}, _ModelAxis)
        np.testing.assert_array_equal(
            got[name]["store_rows"]["w_up"][:cases.E // cases.R],
            home.numpy())


def test_mesh_lays_ranks_out_as_jax_make_mesh():
    """A (2, 2) world: rank r at (r // 2, r % 2), its model group the ranks
    of its data index, its data group the ranks of its model index; a
    batch of 4 splits over the data ranks and a batch of 1 stays whole;
    a wall-clock reading agreed by its maximum over the world."""
    out = mesh_mod.spawn(cases.mesh_layout, (), data=2, model=2,
                         backend="gloo", threads=1, timeout_s=120)
    for r, got in enumerate(out):
        d, m = r // 2, r % 2
        assert got["rank"] == r and got["coords"] == (d, m)
        assert got["model_ranks"] == [2 * d, 2 * d + 1]
        assert got["data_ranks"] == [m, 2 + m]
        assert (got["data"], got["model"]) == (2, 2)
        assert got["rows"] == [None, slice(2 * d, 2 * d + 2)]
        assert got["agreed"] == (3.0, 0.0)
        assert got["gathered"] == [[2.0 * d] * 2, [2.0 * d + 1] * 2]


def test_nccl_is_named_and_needs_a_card_a_rank():
    if torch.cuda.device_count() >= 4:
        pytest.skip("four cards are present")
    with pytest.raises(RuntimeError, match="needs a card a rank"):
        mesh_mod.init_process(0, 4, init_file="/nonexistent/init",
                              backend="nccl")
    with pytest.raises(ValueError, match="one of"):
        mesh_mod.init_process(0, 4, init_file="/nonexistent/init",
                              backend="mpi")
    assert mesh_mod.rank_device("gloo", "cpu") == (torch.device("cpu"), 1)
    with pytest.raises(ValueError, match="runs on cards"):
        mesh_mod.rank_device("nccl", "cpu")


def test_a_failing_rank_fails_the_world():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        mesh_mod.spawn(cases.fail_on_rank, (1,), data=1, model=2,
                       backend="gloo", threads=1, timeout_s=60)
