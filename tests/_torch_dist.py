"""Dispatch-level cases for ``tests/test_torch_dist.py``: the same seeded
inputs through the EP dispatch with its ranks stacked on one device
(``StackedRanks``) and with one rank a process (``ProcessGroupRanks``).
The module imports torch and ``repro_torch`` only, so the ranks that
``launch.mesh.spawn`` starts import it quickly; ``run_rank`` is their
entry point and returns numpy arrays.

Each case: reduced widths (d 32, F 64, E 8 over R 4 ranks, 32 tokens a
rank), bf16 activations and experts, a plan that replicates the hot
experts. Without a store the process ranks hold their home experts only
and build their replica slots from ``gather_replica_pool``; the stacked
run reads every slot's expert from the whole (E, ...) weights. With one
(``store``) both fill their replica rows by ``migrate_all`` from the
identity plan, and the process store moves each row from the expert's
home rank.
"""

import numpy as np
import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core.duplication import duplicate_experts_host
from repro_torch.core.placement import (PlacementPlan, identity_plan,
                                        slot_experts, stack_plans, to_device)
from repro_torch.moe import dispatch as ep
from repro_torch.moe.router import route
from repro_torch.runtime import (ReplicaStore, make_migrate_step,
                                 migrate_all, plan_diff)
from repro_torch.schedule import even_quota

R, T, D_MODEL, F, E = 4, 32, 32, 64, 8
NAMES = ("w_gate", "w_up", "w_down")
# name -> (top_k, dup_slots, capacity factor, mode); mode: prefill, the
# predicted or quota prefill, decode, decode under a quota, the store
CASES = {
    "prefill": (2, 1, 1.0, "prefill"),
    "predicted": (2, 1, 1.0, "predicted"),
    "quota": (2, 1, 1.0, "quota"),
    "decode": (2, 1, 0.5, "decode"),
    "decode_quota": (2, 1, 0.25, "decode_quota"),
    "store": (2, 1, 1.0, "store"),
    "store_decode": (2, 2, 0.5, "store_decode"),
    "prefill_k4": (4, 1, 1.25, "prefill"),
    "decode_k4": (4, 1, 1.25, "decode"),
}


def make_case(name: str):
    """(MoEConfig, numpy inputs) of case ``name``."""
    K, D, cf, _ = CASES[name]
    moe = MoEConfig(num_experts=E, top_k=K, d_ff_expert=F,
                    duplication_slots=D, capacity_factor=cf)
    rng = np.random.default_rng(sorted(CASES).index(name))
    dist = rng.random(E) ** 3
    dist[rng.integers(E)] += 1.5                    # hot experts replicate
    plan = duplicate_experts_host(dist / dist.sum(), R, D, moe.max_copies).plan
    bf = lambda a: torch.tensor(a, dtype=torch.float32).bfloat16().float() \
        .numpy()
    router = rng.normal(size=(D_MODEL, E)).astype(np.float32)
    router[:, int(np.argmax(dist))] += 1.0          # skew the routes
    inputs = {
        "x": bf(rng.normal(size=(R, T, D_MODEL))),
        "router": router,
        "w_gate": bf(rng.normal(size=(E, D_MODEL, F)) / np.sqrt(D_MODEL)),
        "w_up": bf(rng.normal(size=(E, D_MODEL, F)) / np.sqrt(D_MODEL)),
        "w_down": bf(rng.normal(size=(E, F, D_MODEL)) / np.sqrt(F)),
        "predicted": rng.integers(0, E, (R, T, K)).astype(np.int32),
        "quota": even_quota(plan),
        "plan": tuple(np.asarray(a) for a in plan),
    }
    return moe, inputs


def _store(moe, experts, plan, comm):
    """A store built under the identity plan, then migrated to ``plan``
    (one layer): the fill of every replica row the plan uses."""
    ident = stack_plans([identity_plan(E, R, moe.duplication_slots,
                                       moe.max_copies)])
    store = ReplicaStore.from_params({k: [w] for k, w in experts.items()},
                                     ident, num_experts=E, ep_ranks=R,
                                     dup_slots=moe.duplication_slots,
                                     comm=comm)
    diff = plan_diff(ident, stack_plans([plan]), R, moe.duplication_slots)
    migrate_all(make_migrate_step(store), store, diff)
    return store


def run(name: str, comm=None):
    """Case ``name`` over the ranks ``comm`` holds (None: all R stacked).
    Returns {y (H, T, d) or (T, d), stats..., rows of the store} as numpy
    (y in fp32)."""
    moe, inputs = make_case(name)
    _, _, _, mode = CASES[name]
    comm = comm or ep.StackedRanks(R)
    held = slice(None) if comm.held == R else slice(comm.rank, comm.rank + 1)
    plan = PlacementPlan(*inputs["plan"])
    e_loc = E // R
    home = slice(None) if comm.held == R else slice(comm.rank * e_loc,
                                                    (comm.rank + 1) * e_loc)
    experts = {k: torch.tensor(inputs[k][home]).bfloat16() for k in NAMES}
    router = torch.tensor(inputs["router"])
    out = {}
    rows = None
    if mode.startswith("store"):
        store = _store(moe, experts, plan, None if comm.held == R else comm)
        experts = {k: w[0] for k, w in store.weights.items()}
        pdev = to_device(plan, E, R, moe.duplication_slots, "cpu",
                         rows=store.slot_rows()[0])
        out["store_rows"] = {k: w.float().numpy() for k, w in experts.items()}
    else:
        pdev = to_device(plan, E, R, moe.duplication_slots, "cpu",
                         rows=slot_experts(plan, E, R,
                                           moe.duplication_slots))
        if comm.held < R:
            experts, rows = ep.gather_replica_pool(experts, pdev, moe, comm)
    quota = (torch.tensor(inputs["quota"]) if mode.endswith("quota")
             else None)
    kw = dict(ep_ranks=R, comm=comm, slot_rows=rows, resched_quota=quota)
    if "decode" in mode:
        x = torch.tensor(inputs["x"][0]).bfloat16()         # replicated
        ro = route(router, moe, x)
        y, st = ep.ep_moe_ffn_replicated(x, ro, experts, pdev, moe, **kw)
    else:
        x = torch.tensor(inputs["x"][held]).bfloat16()
        ro = route(router, moe, x)
        pred = (torch.tensor(inputs["predicted"][held])
                if mode == "predicted" else None)
        y, st = ep.ep_moe_ffn(x, ro, experts, pdev, moe, predicted_idx=pred,
                              **kw)
    out["y"] = y.float().numpy()
    for k, v in st._asdict().items():
        out[k] = np.asarray(torch.as_tensor(v).float().numpy())
    return out


def run_rank(mesh, names):
    """The entry point of each spawned rank: every case of ``names``."""
    return {n: run(n, mesh.comm) for n in names}


def stacked_rows(store_rows, rank: int, moe):
    """The rows a process store of ``rank`` holds, from a stacked store's
    (E + 2RD, ...) rows: its home experts, then its replica slots' pairs."""
    e_loc, D = E // R, moe.duplication_slots
    pairs = E + 2 * rank * D
    return {k: np.concatenate([w[rank * e_loc:(rank + 1) * e_loc],
                               w[pairs:pairs + 2 * D]])
            for k, w in store_rows.items()}



def mesh_layout(mesh):
    """What a rank sees of its mesh: coordinates, its groups' members, the
    axis sizes, its batch rows and the agreed maximum of its rank."""
    from repro_torch.launch import mesh as mesh_mod

    dev = mesh_mod.make_dev_mesh(mesh.data, mesh.model)
    return {"rank": mesh.rank, "coords": (mesh.data_index, mesh.model_index),
            "model_ranks": mesh.model_ranks, "data_ranks": mesh.data_ranks,
            "model": mesh_mod.model_axis_size(dev),
            "data": mesh_mod.batch_shards(dev),
            "rows": [mesh.batch_rows(b) for b in (1, 4)],
            "agreed": mesh.agree_max(float(mesh.rank), -float(mesh.rank)),
            "gathered": mesh.comm.all_gather(torch.full(
                (1, 2), float(mesh.rank))).tolist()}


def fail_on_rank(mesh, bad: int):
    """Raise on rank ``bad``; the others wait in a collective, which the
    world's stop ends."""
    if mesh.rank == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    mesh.agree_max(0.0)
    return mesh.rank
