"""Expert-parallel MoE dispatch with placement-aware duplication (the port
of the JAX package's ``moe/dispatch.py``), with the R EP ranks as the
leading dimension of every per-rank tensor on one device.

Every rank hosts ``E_loc = E / R`` home experts plus ``D`` replica slots,
``S = R * n_slots`` global slots in all. Per layer:

  1. route (``moe.router.route``: one kernel launch for all ranks'
     tokens);
  2. pick a replica per (token, k): round-robin over ``n_replicas[e]``,
     or under a reschedule quota a hashed draw against the scheduler's
     per-copy thresholds (``choose_replica_quota``);
  3. pack each rank's ``(S * cap, d)`` send buffer with a stable argsort
     and the ``histogram_offsets`` kernel (``_pack_sort``; the one-hot
     cumsum packer ``_pack_onehot`` is kept as the tests' oracle); the
     drop rule is first-come within a slot, in token order;
  4. exchange: ``all_to_all`` over the ranks;
  5. run the grouped expert FFN on the received ``(R * n_slots, R * cap,
     d)`` block: one ``moe_gemm`` launch for all ranks, each slot reading
     one row of the layer's weight tensors through the plan's slot -> row
     map (``DevicePlan.slot_rows``). With the (E, ...) home experts as the
     weights that map is the slot -> expert map
     (``core.placement.slot_experts``: the JAX package's
     ``replica_impl="gather"``); with the replica store's row tensors
     (``runtime.store``) a replica slot reads its own row. The packer's
     per-slot counts go with it as the kernel's ``row_counts``, so rows
     past a source rank's count (zero padding) cost the kernel nothing;
  6. exchange back and combine with the router gates.

The collectives go through a rank backend. Every per-rank tensor has a
leading dimension of the H ranks held in this process, out of the R ranks
of the EP group. ``StackedRanks`` holds all of them (H = R) on one device:
``all_to_all`` is a transpose of the ``(R_src, R_dst, ...)`` send buffers,
``psum`` a sum over the rank dimension, ``pmean`` a mean and
``rank_index`` an ``arange(R)``. ``ProcessGroupRanks`` holds one (H = 1),
one rank per process, and runs the same methods as ``torch.distributed``
collectives over the mesh's model group (``launch.mesh``); ``DryRanks``
is the same without a group, for the dry run (``launch.dryrun``): its
collectives return ``meta`` outputs and move nothing. Both count the
result bytes of every collective they issue, by kind, in
``COLLECTIVE_BYTES``. Without a store
each process holds only its ranks' home experts, so a replica slot there
reads an expert of another rank from a pool that an ``all_gather`` builds
each forward (``gather_replica_pool``, the JAX package's
``replica_impl="gather"``). While autograd records, the process
collectives the dispatch runs carry their gradients (training across
processes, without replica slots); the others raise.

Token-to-Expert predicted mode (``ep_moe_ffn(predicted_idx=...)``, a
prefill feature): a first round dispatches every (token, k) pair to its
PREDICTED expert at capacity ``cap``; a correction round re-dispatches the
mispredicted pairs to their true experts at ``cap2 = max(8, int(cap *
correction_cap_frac))``, with the replica choice's salt shifted by one.
Each pair keeps the output of the round that computed its true expert.
The drop count is the two rounds' sum, as in the JAX package (it counts a
mispredicted pair dropped in round 1 although round 2 serves it).

Token rescheduling (``resched_quota``: (E, C_max) int32 per-copy
thresholds from ``repro_torch.schedule``): replica choice follows the
quota, and the pairs that overflowed their slot's capacity get a second,
*rescue* round aimed at the expert's next copy (the draw shifted by one):
in ``ep_moe_ffn`` at ``cap2 = max(8, int(cap * resched_cap_frac))``, in
``ep_moe_ffn_replicated`` at ``cap``, where every rank sees the global
first-come positions (``_global_positions``) and serves the overflowed
pairs whose alternate copy is its own. ``MoEStats.overflow`` counts the
round-1 overflows and ``dropped`` becomes the rescue round's drops, as in
the JAX package. In the predicted mode both rounds pick through the quota
(the correction round at shift 1) and there is no rescue round.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.core.placement import DevicePlan, host_plan, plan_dims
from repro_torch.kernels import ops as kernel_ops
from repro_torch.moe.router import RouterOutput

class MoEStats(NamedTuple):
    expert_counts: torch.Tensor  # (E,) float32 tokens routed per expert (global)
    slot_counts: torch.Tensor    # (S,) tokens kept per global slot (global)
    dropped: torch.Tensor        # () tokens dropped by capacity (global)
    aux_loss: torch.Tensor
    z_loss: torch.Tensor
    overflow: torch.Tensor       # () int64 round-1 capacity overflows the
                                 # rescue round tried to save (global); a
                                 # zero on x's device under a quota, a host
                                 # zero without one (nothing is launched)


class StackedRanks:
    """The EP ranks as the leading dimension of each per-rank tensor, all on
    one device; the collectives are operations on that dimension."""

    def __init__(self, ranks: int):
        self.ranks = ranks
        self.held = ranks

    def all_to_all(self, buf):
        """(R_src, R_dst, ...) -> (R_dst, R_src, ...): rank dst receives
        every source rank's block for it."""
        return buf.transpose(0, 1)

    def psum(self, t):
        return t.sum(dim=0)

    def pmean(self, t):
        return t.mean(dim=0)

    def rank_index(self, device):
        return torch.arange(self.ranks, device=device)

    def local(self, t):
        """(R, ...) per-rank rows -> the held ranks' rows: all of them."""
        return t

    def all_gather(self, t):
        """(H, ...) -> (R, ...): every rank's rows (all held here)."""
        return t

    def psum_counts(self, *ts):
        """``psum`` of each of several (H, ...) tensors."""
        return [self.psum(t) for t in ts]

    def pmean_losses(self, *ts):
        """``pmean`` of each of several (H,) tensors."""
        return [self.pmean(t) for t in ts]


# the result bytes of every collective a ``ProcessGroupRanks`` issued, by
# kind (the JAX package's ``roofline.collective_bytes`` counts each compiled
# collective's result shape the same way), and "count", how many it issued
COLLECTIVE_KINDS = ("all-to-all", "all-gather", "all-reduce", "gather",
                    "send/recv")
COLLECTIVE_BYTES: Dict[str, int] = dict.fromkeys(COLLECTIVE_KINDS + ("count",),
                                                 0)
# of the all-gathers, those of the ordered sums (``_sum_ordered``): the
# bytes gathered, and the result bytes an all-reduce of the tensor itself
# (XLA's psum) would have had
ORDERED_SUMS: Dict[str, int] = {"gathered": 0, "all-reduce": 0}


def reset_collective_bytes() -> None:
    for counts in (COLLECTIVE_BYTES, ORDERED_SUMS):
        for k in counts:
            counts[k] = 0


def collective_bytes() -> Dict[str, int]:
    """A copy of ``COLLECTIVE_BYTES``."""
    return dict(COLLECTIVE_BYTES)


def _count(kind: str, *results) -> None:
    COLLECTIVE_BYTES[kind] += sum(t.numel() * t.element_size()
                                  for t in results)
    COLLECTIVE_BYTES["count"] += 1


# elements of one ``ProcessGroupRanks.mean_`` collective (fp32: 256 MB)
MEAN_BUCKET_NUMEL = 1 << 26
# every rank's tensor into one buffer, joined along dim 0 (the newer name
# of ``all_gather_into_tensor`` where the installed torch has it)
_all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _records(*ts) -> bool:
    """Whether autograd records an operation on any of the tensors ``ts``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


class _AllToAll(torch.autograd.Function):
    """``all_to_all`` with a gradient. The exchange is its own transpose:
    rank src's block for rank dst lands at dst as block src, so the way back
    is the same exchange of the gradient (``StackedRanks``' transpose, whose
    gradient is the transpose)."""

    @staticmethod
    def forward(ctx, comm, buf):
        ctx.comm = comm
        return comm._all_to_all(buf)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm._all_to_all(g)


class _AllGather(torch.autograd.Function):
    """``all_gather`` with a gradient, for a gathered tensor every rank of
    the group uses alike, under a loss every rank computes alike (the loss
    is replicated over the model axis): each rank's rows then get their
    whole gradient from this rank's copy, so the way back takes this rank's
    rows. A sum over the ranks would count the gradient R times."""

    @staticmethod
    def forward(ctx, comm, t):
        ctx.comm = comm
        return comm._all_gather(t)

    @staticmethod
    def backward(ctx, g):
        r = ctx.comm.rank
        return None, g[r:r + 1].contiguous()


class _Local(torch.autograd.Function):
    """``local`` with a gradient: the forward takes this rank's rows of a
    tensor every rank holds alike; the way back gathers every rank's rows'
    gradient, so the whole tensor gets its whole gradient on every rank
    (``StackedRanks.local`` is the identity, and so is its gradient)."""

    @staticmethod
    def forward(ctx, comm, t):
        ctx.comm = comm
        return t[comm.rank:comm.rank + 1].clone()

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm._all_gather(g)


class _PmeanLosses(torch.autograd.Function):
    """``pmean_losses`` with a gradient: the mean's gradient is g / R on
    each rank's own loss, with no collective (``StackedRanks``' mean over
    its rows gives each row g / R)."""

    @staticmethod
    def forward(ctx, comm, *ts):
        ctx.comm = comm
        return tuple(comm._pmean_losses(ts))

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + tuple(g.reshape(1) / ctx.comm.ranks for g in gs)


# Tensor parallelism over the model group and FSDP over the data group
# (``sharding``, ``models.layers``): each forward below is what the layer
# computes, each backward what autograd must pass back when every rank
# computes the same loss and the tensors before ``tp_copy`` (after
# ``tp_sum``, ``tp_gather``) are the same on every rank of the group.

class _TpCopy(torch.autograd.Function):
    """The identity, with the gradient summed over the group on the way
    back: a replicated tensor that each rank then uses on its own block
    (the input of a column-parallel product, the router on this rank's
    positions)."""

    @staticmethod
    def forward(ctx, comm, x):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm._sum_ordered(g)


class _TpSum(torch.autograd.Function):
    """The sum over the group (a row-parallel product's partial sums), with
    the gradient passed through: what follows is computed alike on every
    rank, so each already holds the whole gradient."""

    @staticmethod
    def forward(ctx, comm, x):
        ctx.comm = comm
        return comm._sum_ordered(x)

    @staticmethod
    def backward(ctx, g):
        return None, g


class _TpGather(torch.autograd.Function):
    """The group's blocks joined along ``dim``, with this rank's block of
    the (whole, replicated) gradient passed back."""

    @staticmethod
    def forward(ctx, comm, x, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm._gather_dim(x, dim)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm._block(g, ctx.dim), None


class _TpSplit(torch.autograd.Function):
    """This rank's block along ``dim`` of a replicated tensor, with every
    rank's block of the gradient joined on the way back."""

    @staticmethod
    def forward(ctx, comm, x, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm._block(x, dim).clone()

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm._gather_dim(g, ctx.dim), None


class _FsdpGather(torch.autograd.Function):
    """A parameter's data-axis shards joined along ``dim`` (ZeRO-3: at
    use), with the gradient reduce-scattered back: each data rank's block
    of the mean of every data rank's gradient."""

    @staticmethod
    def forward(ctx, comm, x, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm._gather_dim(x, dim)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.comm._reduce_scatter_mean(g, ctx.dim), None


class ProcessGroupRanks:
    """One EP rank per process: the collectives of ``StackedRanks`` over a
    ``torch.distributed`` group of ``ranks`` processes, this one at
    ``rank`` in it (``global_ranks`` the group's members by group rank).
    Per-rank tensors keep a leading dimension of one. ``host_staging``:
    a ``gloo`` group given CUDA tensors; each collective then copies its
    operands to the host and its results back, by name. Every collective
    is bounded by the group's timeout, so a rank that died fails the
    others instead of hanging them.

    While autograd records (training), ``all_to_all``, ``all_gather``,
    ``local`` and ``pmean_losses`` carry gradients: each backward is the
    process form of what autograd gives the same ``StackedRanks``
    operation, under a loss that every rank of the group computes alike.
    ``psum_grad`` sums a replicated weight's gradient over the group. The
    other collectives have no backward: given a tensor that requires a
    gradient while autograd records, they raise rather than drop it.

    The tensor-parallel and FSDP layouts (``sharding``) use five more,
    on tensors without a rank dimension, each with its backward:
    ``tp_copy`` (identity; the gradient summed), ``tp_sum`` (the sum, in
    fp32 in rank order; the gradient passed), ``tp_gather`` (blocks joined
    along a dim; this rank's block of the gradient), ``tp_split`` (this
    rank's block; the gradients joined) and ``fsdp_gather`` (shards
    joined; the gradient's mean reduce-scattered).

    Every collective adds its result bytes to ``COLLECTIVE_BYTES`` under
    its kind before it is issued (``_issue_*``, the only calls into
    ``torch.distributed``), host-staged or not: an all-to-all its output,
    an all-gather its R rows, an all-reduce its tensor (``psum`` and each
    bucket of ``mean_``), a gather the R rows on the group's rank 0 (none
    elsewhere), and a batch of point-to-point copies the bytes this rank
    receives. What that shows of the ordered sums (``_sum_ordered``: ``tp_sum``,
    ``psum_ordered``, ``tp_copy``'s backward): each is an all-gather of R
    fp32 copies of the tensor, summed here in rank order, where XLA
    all-reduces the bf16 tensor itself, so at a "model" axis of 16 a bf16
    sum moves 32 times the result bytes of the reference's all-reduce (16
    fp32 copies, 16 x 4 bytes an element against 2); ``ORDERED_SUMS``
    keeps both. The counts are what the port moves, not what XLA would."""

    held = 1

    def __init__(self, group, *, ranks: int, rank: int, global_ranks,
                 host_staging: bool = False):
        self.group = group
        self.ranks = ranks
        self.rank = rank
        self.global_ranks = list(global_ranks)
        self.host_staging = host_staging

    def _host(self, t):
        return t.cpu() if self.host_staging else t

    def _back(self, t, like):
        return t.to(like.device) if self.host_staging else t

    def _no_gradient(self, what: str, *ts) -> None:
        if _records(*ts):
            raise RuntimeError(f"ProcessGroupRanks.{what} has no backward: it "
                               "was given a tensor that requires a gradient "
                               "while autograd records")

    def all_to_all(self, buf):
        """(1, R_dst, ...) -> (1, R_src, ...): this rank's block from every
        source rank."""
        if _records(buf):
            return _AllToAll.apply(self, buf)
        return self._all_to_all(buf)

    # -- the calls into torch.distributed (``DryRanks`` issues none) --

    def _issue_all_to_all(self, out, x) -> None:
        dist.all_to_all_single(out, x, group=self.group)

    def _issue_all_reduce(self, x) -> None:
        dist.all_reduce(x, group=self.group)

    def _issue_all_gather(self, out, x) -> None:
        _all_gather_single(out, x, group=self.group)

    def _issue_gather(self, x, out) -> None:
        dist.gather(x, out, dst=self.global_ranks[0], group=self.group)

    def _issue_p2p(self, ops) -> None:
        """``ops``: (send?, tensor, group rank of the peer, tag)."""
        if ops:
            for work in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend if send else dist.irecv, t,
                               self.global_ranks[peer], self.group, tag)
                    for send, t, peer, tag in ops]):
                work.wait()

    def _all_to_all(self, buf):
        x = self._host(buf[0].contiguous())
        out = torch.empty_like(x)
        _count("all-to-all", out)
        self._issue_all_to_all(out, x)
        return self._back(out, buf)[None]

    def psum(self, t):
        self._no_gradient("psum", t)
        x = t[0].cpu() if self.host_staging else t[0].clone()
        _count("all-reduce", x)
        self._issue_all_reduce(x)
        return self._back(x, t)

    def psum_counts(self, *ts):
        """``psum`` of several (1, ...) integer-valued tensors (counts) in
        one collective: packed as float64, exact below 2**53, and split
        back to each one's dtype and shape."""
        flat = self.psum(torch.cat([t.reshape(1, -1).to(torch.float64)
                                    for t in ts], dim=1))
        out, at = [], 0
        for t in ts:
            n = t[0].numel()
            out.append(flat[at:at + n].reshape(t.shape[1:]).to(t.dtype))
            at += n
        return out

    def pmean_losses(self, *ts):
        """``pmean`` of several (1,) fp32 losses in one collective: every
        rank's gathered, then each averaged over the ranks as
        ``StackedRanks.pmean`` averages its (R,) rows, so both backends give
        the same bits and every rank the same value."""
        if _records(*ts):
            return list(_PmeanLosses.apply(self, *ts))
        return self._pmean_losses(ts)

    def _pmean_losses(self, ts):
        rows = self._all_gather(torch.stack(ts, dim=-1))          # (R, n)
        return [rows[:, i].contiguous().mean(dim=0)
                for i in range(rows.shape[1])]

    def psum_grad(self, w):
        """``w`` as it is, with its gradient summed over the group on the
        way back (``tp_copy``): a weight every rank holds alike and applies
        to its own share of the positions (the router), whose gradient
        each rank then holds a part of. The parts are added in group-rank
        order, so every rank gets the same bits."""
        return self.tp_copy(w)

    def psum_ordered(self, t):
        """The sum over the group of every rank's ``t`` (any shape), added
        in fp32 in group-rank order: every rank gets the same bits,
        whatever order a reduction would take."""
        self._no_gradient("psum_ordered", t)
        return self._sum_ordered(t)

    # -- tensor parallelism and FSDP (no leading rank dimension) --

    def tp_copy(self, x):
        """``x`` as it is; its gradient summed over the group on the way
        back."""
        if _records(x):
            return _TpCopy.apply(self, x)
        return x

    def tp_sum(self, x):
        """The sum over the group of every rank's ``x``, in fp32 in group-
        rank order (every rank the same bits), cast back to ``x``'s dtype;
        the gradient passed through."""
        if _records(x):
            return _TpSum.apply(self, x)
        return self._sum_ordered(x)

    def tp_gather(self, x, dim: int):
        """Every rank's ``x`` joined along ``dim`` in group-rank order;
        this rank's block of the gradient on the way back."""
        if _records(x):
            return _TpGather.apply(self, x, dim)
        return self._gather_dim(x, dim)

    def tp_split(self, x, dim: int):
        """This rank's block of ``x`` (the same on every rank) along
        ``dim``; every rank's block of the gradient joined on the way
        back."""
        if _records(x):
            return _TpSplit.apply(self, x, dim)
        return self._block(x, dim)

    def fsdp_gather(self, x, dim: int):
        """Every rank's shard of a parameter joined along ``dim``; on the
        way back each rank's block of the group's mean gradient (a
        reduce-scatter)."""
        if _records(x):
            return _FsdpGather.apply(self, x, dim)
        return self._gather_dim(x, dim)

    def _sum_ordered(self, x):
        if self.ranks == 1:
            return x
        ORDERED_SUMS["gathered"] += self.ranks * x.numel() * 4
        ORDERED_SUMS["all-reduce"] += x.numel() * x.element_size()
        rows = self._all_gather(x.float()[None])
        return rows.sum(dim=0).to(x.dtype)

    def _gather_dim(self, x, dim: int):
        if self.ranks == 1:
            return x
        rows = self._all_gather(x[None])
        if dim == 0:                         # the rows are already joined
            return rows.reshape((-1,) + tuple(x.shape[1:]))
        return torch.cat(rows.unbind(0), dim=dim)

    def _block(self, x, dim: int):
        n = x.shape[dim] // self.ranks
        return x.narrow(dim, self.rank * n, n)

    def _reduce_scatter_mean(self, g, dim: int):
        """Each rank's block along ``dim`` of the group's mean of ``g``:
        the blocks exchanged (``all_to_all``) and added in group-rank
        order in fp32, so the result does not depend on a reduction's
        order."""
        if self.ranks == 1:
            return g
        n = g.shape[dim] // self.ranks
        send = torch.stack(g.split(n, dim=dim))          # (R, ..block..)
        got = self._all_to_all(send.float()[None])[0]    # every rank's block
        return (got.sum(dim=0) / self.ranks).to(g.dtype)

    def rank_index(self, device):
        return torch.tensor([self.rank], device=device)

    def local(self, t):
        if _records(t):
            return _Local.apply(self, t)
        return t[self.rank:self.rank + 1]

    def all_gather(self, t):
        """(1, ...) -> (R, ...) in group-rank order."""
        if _records(t):
            return _AllGather.apply(self, t)
        return self._all_gather(t)

    def _all_gather(self, t):
        # one buffer the ranks' rows land in, in group-rank order: no copy
        # to join them afterwards
        x = self._host(t.contiguous())
        out = x.new_empty((self.ranks,) + tuple(x.shape[1:]))
        _count("all-gather", out)
        self._issue_all_gather(out, x)
        return self._back(out, t)

    def gather(self, t):
        """(1, ...) -> (R, ...) in group-rank order on the group's rank 0,
        None on the others (a checkpoint's expert leaves)."""
        self._no_gradient("gather", t)
        x = self._host(t[0].contiguous())
        out = ([torch.empty_like(x) for _ in range(self.ranks)]
               if self.rank == 0 else None)
        _count("gather", *(out or ()))
        self._issue_gather(x, out)
        return None if out is None else self._back(torch.stack(out), t)

    def mean_(self, tensors) -> None:
        """Average each of ``tensors`` over the group, in place (the
        gradients over the data axis): one ``all_reduce`` a bucket of up to
        ``MEAN_BUCKET_NUMEL`` elements of one dtype, not one a tensor (a
        tensor larger than a bucket is a bucket of its own). Under host
        staging each bucket goes through the host."""
        self._no_gradient("mean_", *tensors)
        if self.ranks == 1:
            return
        buckets, size = [], MEAN_BUCKET_NUMEL
        for t in tensors:
            if (size + t.numel() > MEAN_BUCKET_NUMEL
                    or buckets[-1][0].dtype != t.dtype):
                buckets.append([])
                size = 0
            buckets[-1].append(t)
            size += t.numel()
        for bucket in buckets:
            flat = torch.cat([t.reshape(-1) for t in bucket])
            x = self._host(flat)
            _count("all-reduce", x)
            self._issue_all_reduce(x)
            x = self._back(x, flat).div_(self.ranks)
            at = 0
            for t in bucket:
                t.copy_(x[at:at + t.numel()].view_as(t))
                at += t.numel()

    def transfer(self, moves) -> None:
        """Point-to-point copies between the group's ranks: ``moves`` is a
        list of (src_rank, src tensor or None, dst_rank, dst tensor or
        None) in one order on every rank; this rank passes the tensor of
        each end it is, and copies where it is both. Sends and receives go
        out together and are waited on before it returns."""
        self._no_gradient("transfer", *(t for _, x, _, y in moves
                                        for t in (x, y)))

        def pinned(t):               # a staging buffer the copies run fast on
            return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)

        ops, landed = [], []
        for tag, (src, x, dst, y) in enumerate(moves):
            if src == dst:
                if src == self.rank:
                    y.copy_(x)
                continue
            if src == self.rank:
                ops.append((True, pinned(x).copy_(x) if self.host_staging
                            else x.contiguous(), dst, tag))
            elif dst == self.rank:
                buf = pinned(y) if self.host_staging else y
                ops.append((False, buf, src, tag))
                if self.host_staging:
                    landed.append((y, buf))
        if ops:
            _count("send/recv", *(t for send, t, _, _ in ops if not send))
        self._issue_p2p(ops)
        for y, buf in landed:
            y.copy_(buf)


class DryRanks(ProcessGroupRanks):
    """``ProcessGroupRanks`` without a group, for one rank of a mesh that
    is traced and not run (``launch.dryrun``): every collective takes the
    same code, allocates the live one's outputs (``meta`` tensors, given
    ``meta`` inputs) and counts their bytes in ``COLLECTIVE_BYTES``, and
    issues nothing."""

    def __init__(self, *, ranks: int, rank: int, global_ranks):
        super().__init__(None, ranks=ranks, rank=rank,
                         global_ranks=global_ranks)

    def _issue_all_to_all(self, out, x) -> None:
        pass

    def _issue_all_reduce(self, x) -> None:
        pass

    def _issue_all_gather(self, out, x) -> None:
        pass

    def _issue_gather(self, x, out) -> None:
        pass

    def _issue_p2p(self, ops) -> None:
        pass


def capacity(t_local: int, top_k: int, num_slots_global: int, factor: float,
             multiple: int = 8) -> int:
    c = math.ceil(t_local * top_k / num_slots_global * factor)
    return max(multiple, math.ceil(c / multiple) * multiple)


def _positions_in_slot(gslot, num_slots: int):
    """Rank of each element within its slot group (one-hot cumsum), per
    row. gslot: (R, N) in [0, num_slots). Returns (R, N) int64."""
    oh = F.one_hot(gslot.long(), num_slots)                     # (R, N, S)
    pos = torch.cumsum(oh, dim=1) - 1
    return torch.gather(pos, 2, gslot.long()[..., None])[..., 0]


def _gather_rows(x, idx):
    """x: (R, T, d); idx: (R, ...) token indices -> (R, ..., d)."""
    R = x.shape[0]
    r = torch.arange(R, device=x.device).reshape((R,) + (1,) * (idx.dim() - 1))
    return x[r, idx]


# ---------------------------------------------------------------------------
# send-buffer packing. Both packers share one contract, per rank row:
# assignments (token_of, gslot, valid) and a per-slot capacity give a
# zero-padded (num_classes * cap, d) send buffer, the in-capacity mask, the
# send-buffer destinations, per-slot counts and the dropped count. The drop
# rule is first-come within each slot in token order; ``_pack_sort`` keeps
# it through a stable argsort.
# x: (R, T, d); token_of: (N,); gslot, valid: (R, N).
# ---------------------------------------------------------------------------

def _pack_onehot(x, token_of, gslot, valid, *, num_classes: int, cap: int):
    """Reference oracle: (N, S+1) one-hot cumsum positions + scatter."""
    R, _, d = x.shape
    g = torch.where(valid, gslot.long(), num_classes)   # invalid -> overflow
    pos = _positions_in_slot(g, num_classes + 1)        # invalid eat no capacity
    in_cap = (pos < cap) & valid
    dest = torch.where(in_cap, g * cap + pos, num_classes * cap)
    rows = _gather_rows(x, token_of.expand(R, -1))
    send = torch.zeros((R, num_classes * cap + 1, d), dtype=x.dtype,
                       device=x.device)
    # only the discarded last row takes more than one write
    send.scatter_(1, dest[..., None].expand(-1, -1, d), rows)
    counts = torch.zeros((R, num_classes), dtype=torch.int32, device=x.device)
    counts.scatter_add_(1, g.clamp(max=num_classes - 1),
                        in_cap.to(torch.int32))
    dropped = (valid & ~in_cap).sum(dim=1)
    return send[:, :-1], in_cap, dest, counts, dropped


def _pack_sort(x, token_of, gslot, valid, *, num_classes: int, cap: int):
    """Stable argsort + histogram-offset slot assignment (the dispatch's
    path): positions within a slot come from the class histogram's
    exclusive prefix sum, and each slot's send range gathers its run of
    the sorted tokens."""
    R, _, d = x.shape
    N = gslot.shape[1]
    dev = x.device
    g = torch.where(valid, gslot.to(torch.int32), num_classes).contiguous()
    order = torch.argsort(g, dim=1, stable=True)        # token order kept
    g_sorted = torch.gather(g, 1, order).long()
    hist, starts = kernel_ops.histogram_offsets(g, num_classes + 1)
    hist, starts = hist.long(), starts.long()
    pos_sorted = (torch.arange(N, device=dev)[None, :]
                  - torch.gather(starts, 1, g_sorted))
    pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    in_cap = (pos < cap) & valid
    dest = torch.where(in_cap, g.long() * cap + pos, num_classes * cap)
    # slot s's send range [s*cap, s*cap + min(hist[s], cap)) gathers the
    # sorted run starting at starts[s]; the rest of the buffer stays zero
    ar_cap = torch.arange(cap, device=dev)
    fill = starts[:, :num_classes, None] + ar_cap               # (R, C, cap)
    counts = torch.clamp(hist[:, :num_classes], max=cap)
    fill_ok = ar_cap[None, None, :] < counts[..., None]
    tok_sorted = torch.gather(token_of.expand(R, -1), 1, order)
    src = torch.gather(tok_sorted, 1, fill.clamp(0, N - 1).reshape(R, -1))
    rows = _gather_rows(x, src).reshape(R, num_classes, cap, d)
    send = torch.where(fill_ok[..., None], rows,
                       torch.zeros((), dtype=x.dtype, device=dev))
    dropped = torch.clamp(hist[:, :num_classes] - cap, min=0).sum(dim=1)
    return (send.reshape(R, num_classes * cap, d), in_cap, dest,
            counts.to(torch.int32), dropped)


def choose_replica(plan: DevicePlan, expert, salt):
    """Round-robin replica choice. expert, salt: broadcastable int
    tensors. Returns the global slot of each (token, k)."""
    expert = expert.long()
    n_rep = plan.n_replicas[expert]
    choice = salt % torch.clamp(n_rep, min=1)
    c_max = plan.replica_table.shape[-1]
    return plan.replica_table[expert, torch.clamp(choice, max=c_max - 1)]


# quota draw constants: they must match repro_torch.schedule.base (kept
# literal here so the dispatch never imports the host-side scheduler)
_RESCHED_Q = 1 << 16
_RESCHED_MULT = 40503        # odd -> coprime with 2^16 -> equidistributed
_RESCHED_EXPERT = 131


def choose_replica_quota(plan: DevicePlan, quota, expert, salt,
                         shift: int = 0):
    """Quota-weighted replica choice (the reschedule lever's routing map).
    ``quota``: (E, C_max) int32 cumulative thresholds in [0, RESCHED_Q]
    (dead copy columns at RESCHED_Q); expert, salt: broadcastable int
    tensors. A hashed draw per (token, k), in int32 arithmetic that wraps
    as the JAX package's does, is compared against the expert's
    thresholds; ``shift`` rotates the choice to the expert's next copy
    (the rescue round's ``shift=1``). Returns the global slot."""
    expert = expert.long()
    e32 = expert.to(torch.int32)
    u = ((salt.to(torch.int32) + e32 * _RESCHED_EXPERT) * _RESCHED_MULT) \
        % _RESCHED_Q
    choice = (quota[expert] <= u[..., None]).sum(dim=-1)
    n_rep = torch.clamp(plan.n_replicas[expert], min=1)
    choice = (choice + shift) % n_rep
    c_max = plan.replica_table.shape[-1]
    return plan.replica_table[expert, torch.clamp(choice, max=c_max - 1)]


def _global_positions(gslot, valid, num_classes: int):
    """First-come position of each assignment within its global slot (the
    packers' ordering rule over all classes, so that replicated ranks
    agree on which pairs overflow). gslot, valid: (N,). Returns (N,)
    int64."""
    N = gslot.shape[0]
    g = torch.where(valid, gslot.to(torch.int32), num_classes).contiguous()
    order = torch.argsort(g, stable=True)
    _, starts = kernel_ops.histogram_offsets(g[None], num_classes + 1)
    pos_sorted = (torch.arange(N, device=g.device)
                  - starts[0].long()[g[order].long()])
    return torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)


def grouped_ffn(experts: dict, x, slot_rows, activation: str,
                row_counts=None):
    """x: (S, T_s, d) rows per slot -> (S, T_s, d): slot s runs the weights
    in row ``slot_rows[s]`` of ``experts`` (the ``moe_gemm`` kernel, or its
    plain version on the CPU). ``experts``: {"w_gate" (optional), "w_up",
    "w_down"} with (rows, d, F) / (rows, F, d) leaves: the home experts, or
    the replica store's rows. ``row_counts``: None, or (S, B) int32
    live rows of each block of T_s / B rows; the other rows must be zero
    (the packer's padding) and give zeros."""
    return kernel_ops.moe_gemm(x, experts.get("w_gate"), experts["w_up"],
                               experts["w_down"], slot_rows, activation,
                               row_counts=row_counts)


def _slot_map(plan: DevicePlan, num_experts: int, dup_slots: int, S: int,
              device):
    """(S,) int32 weight row of each slot."""
    if dup_slots == 0:
        return torch.arange(num_experts, dtype=torch.int32, device=device)
    rows = plan.slot_rows
    if rows.shape[-1] != S:
        raise ValueError(f"plan has {rows.shape[-1]} slots, dispatch needs {S}")
    return rows


def _held_rows(comm, rows, num_slots: int):
    """(S,) global slot -> row map -> the held ranks' (H * n_slots,)."""
    return comm.local(rows.reshape(comm.ranks, num_slots)).reshape(-1)


def gather_replica_pool(experts: dict, plan: DevicePlan, moe: MoEConfig,
                        comm: ProcessGroupRanks):
    """The replica slots' weights without a store, for one rank a process
    (the JAX package's ``gather_replica_pool`` and ``_slot_weights``):
    every rank contributes the one home expert of its that a replica slot
    holds, an ``all_gather`` makes the pool, and this rank's slot weights
    are its home experts followed by its replica slots' pool entries.
    ``experts``: this rank's (E_loc, ...) home experts. Returns
    ({name: (n_slots, ...)}, (S,) int32 slot -> row map over them). Under
    a plan that replicates nothing the pool is skipped (the replica slots
    are unreachable), as the JAX package's ``lax.cond`` skips it."""
    E, R, D = moe.num_experts, comm.ranks, moe.duplication_slots
    e_loc, n_slots = plan_dims(E, R, D)
    dev = plan.slot_rows.device
    rows = torch.arange(n_slots, dtype=torch.int32, device=dev).repeat(R)
    if D == 0:
        return experts, rows
    if _records(*experts.values()):
        # a pool entry's gradient would belong to the rank that sent it
        raise RuntimeError("the replica pool has no backward: training "
                           "across processes runs without replica slots")
    se = host_plan(plan).slot_experts.cpu().numpy().reshape(R, n_slots)
    replica = se[:, e_loc:]
    live = replica[replica >= 0]
    if live.size == 0:
        return {k: torch.cat([w, w.new_zeros((D,) + w.shape[1:])])
                for k, w in experts.items()}, rows
    home = live // e_loc
    pool_expert = np.zeros((R,), np.int64)
    for q in range(R):
        mine = np.unique(live[home == q])
        if mine.size > 1:
            raise ValueError(f"rank {q} would contribute experts {mine} to "
                             "the replica pool, which holds one a rank")
        pool_expert[q] = mine[0] if mine.size else q * e_loc
    own = int(pool_expert[comm.rank]) % e_loc
    sel = replica[comm.rank]
    sel = np.where(sel >= 0, sel // e_loc, 0)
    out = {}
    for k, w in experts.items():
        pool = comm.all_gather(w[own:own + 1])                 # (R, ...)
        out[k] = torch.cat([w, pool[torch.as_tensor(sel, device=w.device)]])
    return out, rows


def _dispatch_round(x, gslot, valid, *, num_slots: int, cap: int,
                    experts: dict, slot_rows, activation: str, comm):
    """One dispatch -> FFN -> combine round for the held ranks.

    x: (H, T, d); gslot, valid: (H, N) flattened (token, k) assignments
    with token index n // K; ``slot_rows``: the (S,) global slot -> row
    map. Returns y_flat (H, N, d) per-assignment outputs (zeros where
    dropped or invalid), slot counts (H, S), drops (H,) and the in-capacity
    mask."""
    H, T, d = x.shape
    R = comm.ranks
    N = gslot.shape[1]
    K = N // T
    S = R * num_slots
    token_of = torch.arange(N, device=x.device) // K
    send, in_cap, dest, slot_counts, dropped = _pack_sort(
        x, token_of, gslot, valid, num_classes=S, cap=cap)
    recv = comm.all_to_all(send.reshape(H, R, num_slots * cap, d))
    # (H_dst, R_src, n_slots, cap, d) -> (H_dst * n_slots, R_src * cap, d)
    recv = recv.reshape(H, R, num_slots, cap, d).transpose(1, 2) \
               .reshape(H * num_slots, R * cap, d).contiguous()
    # source rank r's rows for slot s sit at [r * cap, r * cap + count):
    # the counts each source packed for the held ranks' slots
    counts = comm.all_to_all(slot_counts.reshape(H, R, num_slots)) \
        .transpose(1, 2).reshape(H * num_slots, R).contiguous()
    y_slots = grouped_ffn(experts, recv, _held_rows(comm, slot_rows,
                                                    num_slots),
                          activation, row_counts=counts)
    y_back = y_slots.reshape(H, num_slots, R, cap, d).transpose(1, 2)
    y_recv = comm.all_to_all(y_back).reshape(H, S * cap, d)
    y_flat = torch.gather(y_recv, 1, dest.clamp(max=S * cap - 1)[..., None]
                          .expand(-1, -1, d))
    y_flat = torch.where(in_cap[..., None], y_flat,
                         torch.zeros((), dtype=y_flat.dtype, device=x.device))
    return y_flat, slot_counts, dropped, in_cap


def _salt(T: int, K: int, device):
    return (torch.arange(T, device=device)[:, None]
            + torch.arange(K, device=device)[None, :]).reshape(-1)


def _no_overflow(resched_quota, device):
    """MoEStats.overflow before a rescue round counts any: a zero on the
    device under a quota (the forward stacks the layers' counts there), a
    host zero without one."""
    return torch.zeros((), dtype=torch.int64,
                       device=device if resched_quota is not None else "cpu")


def _expert_counts(expert_idx, num_experts: int):
    """(..., T, K) assignments -> (..., E) float32 counts."""
    flat = expert_idx.reshape(expert_idx.shape[:-2] + (-1,)).long()
    out = torch.zeros(flat.shape[:-1] + (num_experts,), dtype=torch.float32,
                      device=flat.device)
    return out.scatter_add_(-1, flat, torch.ones_like(flat, dtype=torch.float32))


def ep_moe_ffn(x, router_out: RouterOutput, experts: dict, plan: DevicePlan,
               moe: MoEConfig, *, ep_ranks: int, activation: str = "swiglu",
               predicted_idx=None, correction_cap_frac: float = 0.25,
               resched_quota=None, comm=None, slot_rows=None):
    """Placement-aware EP MoE FFN over sharded tokens (see the module
    docstring). x: (H, T, d), held rank h's T local tokens in row h (H =
    ``comm.held``: all ``ep_ranks`` under ``StackedRanks``, the default);
    ``router_out``: the fused router's output on them, with leading H
    (losses (H,)); ``experts``: {"w_gate", "w_up", "w_down"}, the home
    experts or the store's rows (``plan.slot_rows`` indexes them; the
    held ranks' rows under ``ProcessGroupRanks``); ``slot_rows``: None, or
    an (S,) slot -> row map in place of the plan's; ``plan``: one layer's
    ``DevicePlan``; ``predicted_idx``: None, or (H, T, K) Token-to-Expert
    predictions, which add the correction round; ``resched_quota``: None,
    or the layer's (E, C_max) int32 quota, which the replica choice
    follows and which adds the rescue round.
    Returns (y (H, T, d), MoEStats) with global statistics."""
    comm = comm or StackedRanks(ep_ranks)
    H, T, d = x.shape
    if H != comm.held or comm.ranks != ep_ranks:
        raise ValueError(f"x has {H} rank rows, the rank backend holds "
                         f"{comm.held} of {comm.ranks} and ep_ranks is "
                         f"{ep_ranks}")
    K, E = moe.top_k, moe.num_experts
    dup_slots = moe.duplication_slots
    _, n_slots = plan_dims(E, ep_ranks, dup_slots)
    S = ep_ranks * n_slots
    cap = capacity(T, K, S, moe.capacity_factor)
    se = (_slot_map(plan, E, dup_slots, S, x.device) if slot_rows is None
          else slot_rows)
    kw = dict(num_slots=n_slots, experts=experts, slot_rows=se,
              activation=activation, comm=comm)

    true_idx = router_out.expert_idx                             # (H, T, K)
    gates = router_out.gates.to(x.dtype)
    true_flat = true_idx.reshape(H, T * K)
    salt = _salt(T, K, x.device)
    all_pairs = torch.ones((H, T * K), dtype=torch.bool, device=x.device)
    if resched_quota is None:
        def pick(e, shift):
            return choose_replica(plan, e, salt + shift if shift else salt)
    else:
        def pick(e, shift):
            return choose_replica_quota(plan, resched_quota, e, salt, shift)
    overflow = _no_overflow(resched_quota, x.device)
    if predicted_idx is None:
        y_flat, slot_counts, dropped, in_cap = _dispatch_round(
            x, pick(true_flat, 0), all_pairs, cap=cap, **kw)
        if resched_quota is not None:
            # rescue round: re-send the overflowed pairs to the expert's
            # next copy; its drops are the layer's drops
            miss = all_pairs & ~in_cap
            overflow = miss.sum(dim=1)           # summed with the counts
            cap2 = max(8, int(cap * moe.resched_cap_frac))
            y2, slot_counts2, dropped, _ = _dispatch_round(
                x, pick(true_flat, 1), miss, cap=cap2, **kw)
            y_flat = torch.where(in_cap[..., None], y_flat, y2)
            slot_counts = slot_counts + slot_counts2
    else:
        # round 1 on the predictions, round 2 corrects the mispredicted
        # pairs on their true experts at a fraction of the capacity
        pred = predicted_idx.reshape(H, T * K).to(true_flat.dtype)
        y1, slot_counts, dropped1, _ = _dispatch_round(
            x, pick(pred, 0), all_pairs, cap=cap, **kw)
        correct = pred == true_flat
        cap2 = max(8, int(cap * correction_cap_frac))
        y2, slot_counts2, dropped2, _ = _dispatch_round(
            x, pick(true_flat, 1), ~correct, cap=cap2, **kw)
        y_flat = torch.where(correct[..., None], y1, y2)
        slot_counts = slot_counts + slot_counts2
        dropped = dropped1 + dropped2
    y = (y_flat.reshape(H, T, K, d) * gates[..., None]).sum(dim=2)
    # the rescue round's overflow is per rank; otherwise it is no count
    rescued = resched_quota is not None and predicted_idx is None
    counts = comm.psum_counts(_expert_counts(true_idx, E), slot_counts,
                              dropped, *([overflow] if rescued else []))
    aux, z = comm.pmean_losses(router_out.aux_loss, router_out.z_loss)
    stats = MoEStats(
        expert_counts=counts[0], slot_counts=counts[1], dropped=counts[2],
        aux_loss=aux, z_loss=z, overflow=counts[3] if rescued else overflow)
    return y, stats


def pack_replicated(x, router_out: RouterOutput, plan: DevicePlan,
                    moe: MoEConfig, *, ep_ranks: int, comm=None,
                    resched_quota=None, shift: int = 0, select=None,
                    slot_rows=None):
    """The decode path's send side: the same (T, d) tokens on every rank,
    routed once (``router_out`` unbatched); each held rank packs the
    (token, k) pairs assigned to its slots. ``resched_quota``: None
    (round-robin), or the layer's quota, drawn at ``shift``; ``select``:
    None, or (N,) bool, the only pairs to pack (the rescue round's
    overflowed pairs); ``slot_rows``: None, or an (S,) slot -> row map in
    place of the plan's. Returns (send (H * n_slots, cap, d) rows per held
    slot, row_counts (H * n_slots, 1) int32 live rows per slot, the held
    slots' rows (H * n_slots,), in_cap (H, N), dest (H, N), dropped (H,),
    gslot (N,)) with N = T * K."""
    comm = comm or StackedRanks(ep_ranks)
    T, d = x.shape
    H = comm.held
    K, E = moe.top_k, moe.num_experts
    _, n_slots = plan_dims(E, ep_ranks, moe.duplication_slots)
    S = ep_ranks * n_slots
    cap = capacity(T, K, n_slots, moe.capacity_factor)  # per-rank slot capacity
    se = (_slot_map(plan, E, moe.duplication_slots, S, x.device)
          if slot_rows is None else slot_rows)
    expert_flat = router_out.expert_idx.reshape(-1)
    salt = _salt(T, K, x.device)
    if resched_quota is None:
        gslot = choose_replica(plan, expert_flat, salt)              # (N,)
    else:
        gslot = choose_replica_quota(plan, resched_quota, expert_flat, salt,
                                     shift)
    N = gslot.shape[0]
    rank = comm.rank_index(x.device)
    mine = (gslot // n_slots)[None, :] == rank[:, None]              # (H, N)
    if select is not None:
        mine = mine & select[None, :]
    token_of = torch.arange(N, device=x.device) // K
    send, in_cap, dest, counts, dropped = _pack_sort(
        x.expand(H, T, d), token_of, (gslot % n_slots).expand(H, N), mine,
        num_classes=n_slots, cap=cap)
    return (send.reshape(H * n_slots, cap, d), counts.reshape(H * n_slots, 1),
            _held_rows(comm, se, n_slots), in_cap, dest, dropped, gslot)


def ep_moe_ffn_replicated(x, router_out: RouterOutput, experts: dict,
                          plan: DevicePlan, moe: MoEConfig, *, ep_ranks: int,
                          activation: str = "swiglu", predicted_idx=None,
                          resched_quota=None, comm=None, slot_rows=None,
                          tp_comm=None):
    """Decode-path EP dispatch: the same (T, d) tokens on every rank, routed
    once (``router_out`` unbatched). Each held rank computes the (token,
    k) pairs assigned to its slots (``pack_replicated``) and a psum over
    the ranks combines the results. With ``resched_quota`` the pairs past
    their global slot's first-come capacity are served again on the
    expert's next copy, at the same capacity, by the rank that holds it.
    ``comm`` and ``slot_rows`` as for ``ep_moe_ffn``. Returns (y (T, d),
    MoEStats). Token-to-Expert predictions are a prefill feature:
    ``predicted_idx`` raises, as in the JAX package.

    ``tp_comm``: expert TP (the JAX package's ``tp_axis``), one rank a
    process. ``experts`` then hold this rank's block of each expert's F
    columns, and the same tokens reach every rank of the ``(data,
    model)`` world, so each rank's y is a partial sum over its F block and
    its slots' pairs: one sum over ``tp_comm`` (the mesh's
    ``world_comm``), in fp32 in global rank order and cast back once,
    gives every rank the same bits of the whole y. The slot counts and
    drops are summed over ``comm`` (the model axis) only, and the expert
    counts and overflows are global already, as in the JAX package."""
    if predicted_idx is not None:
        raise NotImplementedError("predicted pre-routing is a prefill feature")
    comm = comm or StackedRanks(ep_ranks)
    T, d = x.shape
    H = comm.held
    K, E = moe.top_k, moe.num_experts
    _, n_slots = plan_dims(E, ep_ranks, moe.duplication_slots)
    S = ep_ranks * n_slots
    kw = dict(ep_ranks=ep_ranks, comm=comm, resched_quota=resched_quota,
              slot_rows=slot_rows)
    packed = pack_replicated(x, router_out, plan, moe, **kw)
    cap = packed[0].shape[1]
    N = T * K
    rows_per_rank = n_slots * cap
    slot_counts = torch.zeros((H, S), dtype=torch.int32, device=x.device)

    def serve(send, row_counts, se, in_cap, dest, dropped, gslot):
        """One round's FFN: (H, N, d) outputs (zeros where not computed)
        and its drops; its kept pairs join the slot counts."""
        ys = grouped_ffn(experts, send, se, activation, row_counts=row_counts)
        ys = ys.reshape(H, rows_per_rank, d)
        y_flat = torch.gather(ys, 1, dest.clamp(max=rows_per_rank - 1)
                              [..., None].expand(-1, -1, d))
        slot_counts.scatter_add_(1, gslot.clamp(max=S - 1).expand(H, N),
                                 in_cap.to(torch.int32))
        return torch.where(in_cap[..., None], y_flat,
                           torch.zeros((), dtype=ys.dtype,
                                       device=x.device)), dropped

    y_flat, dropped = serve(*packed)
    overflow = _no_overflow(resched_quota, x.device)
    if resched_quota is not None:
        # rescue round: every rank sees the global first-come positions
        # (the tokens are replicated) and serves the overflowed pairs whose
        # alternate copy is its own; the two rounds' masks are disjoint
        gslot = packed[-1]
        every = torch.ones_like(gslot, dtype=torch.bool)
        miss = _global_positions(gslot, every, S) >= cap
        overflow = miss.sum()                        # global, not per rank
        y2, dropped = serve(*pack_replicated(x, router_out, plan, moe,
                                             shift=1, select=miss, **kw))
        y_flat = y_flat + y2
    gates = router_out.gates.to(x.dtype)
    y = (y_flat.reshape(H, T, K, d) * gates[..., None]).sum(dim=2)
    y = comm.psum(y) if tp_comm is None else tp_comm.psum_ordered(y[0])
    slot_counts, dropped = comm.psum_counts(slot_counts, dropped)
    stats = MoEStats(
        expert_counts=_expert_counts(router_out.expert_idx, E),  # replicated
        slot_counts=slot_counts,
        dropped=dropped,
        aux_loss=router_out.aux_loss,
        z_loss=router_out.z_loss,
        overflow=overflow)
    return y, stats
