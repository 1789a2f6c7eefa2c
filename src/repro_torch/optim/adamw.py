"""AdamW with decoupled weight decay and global-norm clipping, over a tree
(nested dicts) of tensors.

The JAX package's defaults and arithmetic: ``b1`` 0.9, ``b2`` 0.95, ``eps``
1e-8, ``weight_decay`` 0.1 on matrices only (``ndim >= 2``), gradients
clipped to a global norm of 1.0; moments and the update in fp32, the new
parameter cast back to the parameter's dtype. Leaves are visited in
sorted-key order, as ``jax.tree.leaves`` visits a dict, so the global norm
sums its terms in the reference's order.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional

import torch


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32
    mu: dict
    nu: dict


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of each
    tree in ``rest``), keeping the nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def adamw_init(params: Dict) -> AdamWState:
    def zeros(p):
        return tree_map(lambda a: torch.zeros_like(a, dtype=torch.float32), p)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return AdamWState(step=step, mu=zeros(params), nu=zeros(params))


def clip_by_global_norm(grads: Dict, max_norm: float):
    """Scale ``grads`` so their global L2 norm is at most ``max_norm``.
    Returns (clipped grads, the norm before clipping)."""
    sq = [g.float().square().sum() for g in tree_leaves(grads)]
    total = sq[0]
    for s in sq[1:]:
        total = total + s
    gn = torch.sqrt(total)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), gn


@torch.no_grad()
def adamw_update(params: Dict, grads: Dict, state: AdamWState, lr, *,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, max_grad_norm: float = 1.0):
    """One AdamW step. ``lr``: a float or a 0-d tensor (a schedule's value).
    Returns (new params, new state, the gradients' global norm)."""
    grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
    step = state.step + 1
    stepf = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=stepf.device), stepf)

    def upd(p, g, m, v):
        g = g.float()
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g.square()
        mh = m / bc1
        vh = v / bc2
        # decay only matrices (ndim >= 2)
        wd = weight_decay if p.dim() >= 2 else 0.0
        pf = p.float()
        new_p = pf - lr * (mh / (torch.sqrt(vh) + eps) + wd * pf)
        return new_p.to(p.dtype), m, v

    out = tree_map(upd, params, grads, state.mu, state.nu)
    new_params, mu, nu = (tree_map(lambda t, i=i: t[i], out)
                          for i in range(3))
    return new_params, AdamWState(step=step, mu=mu, nu=nu), gnorm


@torch.no_grad()
def adamw_update_(params: Dict, grads: Dict, state: AdamWState, lr, *,
                  b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                  weight_decay: float = 0.1, max_grad_norm: float = 1.0,
                  decay: Optional[Dict] = None,
                  reduce_sq: Optional[Callable] = None):
    """``adamw_update`` in place: ``grads`` are clipped and ``params``,
    ``state.mu`` and ``state.nu`` updated where they lie, one leaf at a
    time, so the update holds 16 bytes per fp32 parameter (the parameter,
    its gradient and two moments) plus one leaf's temporaries, where the
    functional form holds old and new trees at once. The same fp32
    operations in the same order, the global norm over the leaves in
    sorted-key order, so both give the same bits. ``decay``: None (decay
    the leaves of ndim >= 2, as ``adamw_update``) or a tree of bools
    matching ``params``. ``reduce_sq``: None, or a function of the list
    of the leaves' squared sums (0-d fp32, in leaf order) that returns the
    list the norm adds up in that order: across processes, each term the
    whole model's (``train.steps``: a sharded leaf's summed over its
    ranks). Returns (the state with the new step, the gradients' global
    norm before clipping)."""
    decays = (tree_leaves(decay) if decay is not None
              else [p.dim() >= 2 for p in tree_leaves(params)])
    leaves = list(zip(tree_leaves(params), tree_leaves(grads),
                      tree_leaves(state.mu), tree_leaves(state.nu), decays))
    sq = [g.float().square().sum() for _, g, _, _, _ in leaves]
    if reduce_sq is not None:
        sq = reduce_sq(sq)
    total = sq[0]
    for s in sq[1:]:
        total = total + s
    gn = torch.sqrt(total)
    scale = torch.clamp(max_grad_norm / torch.clamp(gn, min=1e-9), max=1.0)
    step = state.step + 1
    stepf = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=stepf.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=stepf.device), stepf)
    for p, g, m, v, dec in leaves:
        g = g.mul_(scale).float()
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g.square().mul_(1 - b2))
        del g
        # mh / (sqrt(vh) + eps) + wd * p, each step rounded as adamw_update
        upd = m / bc1
        upd.div_((v / bc2).sqrt_().add_(eps))
        pf = p.float()
        upd.add_(pf * (weight_decay if dec else 0.0))
        pf = pf.sub_(upd.mul_(lr))
        if pf is not p:
            p.copy_(pf)
    return AdamWState(step=step, mu=state.mu, nu=state.nu), gn
