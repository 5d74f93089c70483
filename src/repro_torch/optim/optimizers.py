"""AdamW written out by hand (``repro.optim.optimizers``): f32 moments
whatever the parameter's dtype, global-norm clipping and a cosine schedule
with linear warm-up.

``torch.optim.AdamW`` is not used: it keeps its moments in the parameter's
dtype (bf16 for the LMs) and applies the decay before the step, where
``repro`` keeps f32 moments and updates ``p32 - lr * (mh / (sqrt(vh) +
eps) + wd * p32)``, cast back to the parameter's dtype.  The learning rate
and the bias corrections are f32 tensors computed from the int32 step
count on the device, as ``repro`` computes them, so they agree to the
last bit of the schedule's arithmetic.

A parameter tree is a dict (any key order; JAX's sorted order is kept by
:func:`tree_leaves`), a list or a tuple, with tensors as leaves.  The
update runs leaf by leaf, so at most one leaf's f32 temporaries are alive
at once (a single ``_foreach`` over a 3.4 B-parameter model would make f32
copies of every parameter and gradient together), and it writes the
parameters and the moments in place: the step consumes the state it is
given, as ``repro``'s driver donates it (``donate_argnums=0``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.distributed import comm
from repro_torch.distributed.fault import UnreplayableStepError


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


@dataclasses.dataclass
class OptState:
    """First and second moments (trees shaped like the parameters, f32)
    and the int32 step count, a 0-d tensor on the parameters' device."""

    mu: Any
    nu: Any
    count: torch.Tensor


def tree_leaves(tree: Any, is_leaf=None) -> list:
    """The leaves of a dict / list / tuple tree in JAX's flatten order:
    dict keys sorted, sequences in order; a node for which ``is_leaf``
    holds is a leaf."""
    if is_leaf is not None and is_leaf(tree):
        return [tree]
    if isinstance(tree, dict):
        return [x for key in sorted(tree)
                for x in tree_leaves(tree[key], is_leaf)]
    if isinstance(tree, (list, tuple)):
        return [x for sub in tree for x in tree_leaves(sub, is_leaf)]
    return [tree]


def tree_unflatten(template: Any, leaves) -> Any:
    """A tree shaped like ``template`` whose leaves are ``leaves`` (in
    :func:`tree_leaves`' order); dicts come back with sorted keys."""
    it = iter(leaves)

    def rebuild(sub):
        if isinstance(sub, dict):
            return {key: rebuild(sub[key]) for key in sorted(sub)}
        if isinstance(sub, (list, tuple)):
            return type(sub)(rebuild(x) for x in sub)
        return next(it)

    out = rebuild(template)
    extra = object()
    if next(it, extra) is not extra:
        raise ValueError("tree_unflatten: more leaves than the template has")
    return out


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    """``fn`` applied to every leaf of ``tree`` and to the nodes at the
    same place in each of ``rest`` (trees that have ``tree``'s structure
    as a prefix, as in ``jax.tree.map``); the tree's structure kept."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, sub, *(r[key] for r in rest))
                for key, sub in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *subs)
                          for subs in zip(tree, *rest, strict=True))
    return fn(tree, *rest)


def adamw_init(params: Any) -> OptState:
    """Zero f32 moments shaped like ``params``; count 0 (int32)."""
    leaves = tree_leaves(params)
    if not leaves:
        raise ValueError("adamw_init: the parameter tree has no leaves")
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
    return OptState(mu=tree_map(zeros32, params), nu=tree_map(zeros32, params),
                    count=torch.zeros((), dtype=torch.int32,
                                      device=leaves[0].device))


def cosine_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The f32 learning rate at ``step`` (a tensor): linear warm-up over
    ``warmup_steps``, then a cosine down to ``min_lr_frac`` of ``lr`` at
    ``total_steps``."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1.0 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree: Any, specs: Any = None, mesh=None) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32.  With ``specs``
    (a tree of ``PartitionSpec`` s like ``tree``) and ``mesh``, each leaf
    is a rank's slice: its square-sum is summed over the axes its spec
    splits (one ``psum`` per set of axes), a replicated leaf counted once,
    and every rank gets the whole tree's norm."""
    leaves = tree_leaves(tree)
    if specs is None or mesh is None:
        total = None
        for leaf in leaves:
            sq = torch.sum(torch.square(leaf.float()))
            total = sq if total is None else total + sq
        return torch.sqrt(total)
    spec_leaves = tree_leaves(specs, is_leaf=lambda x: isinstance(
        x, comm.PartitionSpec))
    if len(spec_leaves) != len(leaves):
        raise ValueError(f"global_norm: {len(leaves)} leaves, "
                         f"{len(spec_leaves)} specs")
    sums: dict = {}
    for leaf, spec in zip(leaves, spec_leaves):
        key = comm.split_axes(spec, mesh)
        sq = torch.sum(torch.square(leaf.float()))
        sums[key] = sq if key not in sums else sums[key] + sq
    total = None
    for axes, sq in sums.items():
        if axes:
            sq = comm.psum(sq, axes, mesh=mesh)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def reduce_replicated(tree: Any, specs: Any, mesh) -> Any:
    """Each leaf of ``tree`` (a rank's gradients) summed over the mesh
    axes its spec in ``specs`` does not split: every rank then holds the
    whole objective's gradient of its slice, when each rank differentiated
    ``loss / world size`` through the collectives' transposes.  One
    ``psum`` per set of axes and dtype, over the leaves flattened
    together.  Without a mesh, ``tree`` as it is."""
    if mesh is None:
        return tree
    leaves = tree_leaves(tree)
    spec_leaves = tree_leaves(specs, is_leaf=lambda x: isinstance(
        x, comm.PartitionSpec))
    if len(spec_leaves) != len(leaves):
        raise ValueError(f"reduce_replicated: {len(leaves)} leaves, "
                         f"{len(spec_leaves)} specs")
    groups: dict = {}
    for i, (leaf, spec) in enumerate(zip(leaves, spec_leaves)):
        rest = tuple(a for a in mesh.axis_names
                     if a not in comm.split_axes(spec, mesh))
        if rest:
            groups.setdefault((rest, leaf.dtype), []).append(i)
    out = list(leaves)
    for (axes, _), idx in groups.items():
        flat = comm.psum(torch.cat([leaves[i].reshape(-1) for i in idx]),
                         axes, mesh=mesh)
        for i, piece in zip(idx, flat.split([leaves[i].numel()
                                             for i in idx])):
            out[i] = piece.view_as(leaves[i])
    return tree_unflatten(tree, out)


def _clip_scale(grads: Any, max_norm: float,
                norm: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(``min(1, max_norm / norm)``, the norm) of ``grads`` (or the
    ``norm`` given)."""
    gn = global_norm(grads) if norm is None else norm
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0), gn


def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> tuple[Any, torch.Tensor]:
    """Gradients scaled by ``min(1, max_norm / norm)`` (the scale cast to
    each gradient's dtype), and the norm before clipping."""
    scale, gn = _clip_scale(grads, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gn


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Any, opt: OptState, params: Any,
                 norm: torch.Tensor | None = None,
                 ) -> tuple[Any, OptState, dict]:
    """One AdamW step: clip ``grads`` by their global norm, then update
    every leaf of ``params`` and of ``opt``'s moments in place.  Returns
    (``params``, the new :class:`OptState`, ``{"grad_norm", "lr"}``, both
    f32 0-d tensors).  ``norm``: the global norm, where ``grads`` are one
    rank's part of a tree split across ranks (default: theirs).  A fault
    once the writes have begun raises :class:`UnreplayableStepError`: the
    input state is partly updated."""
    g_leaves, p_leaves = tree_leaves(grads), tree_leaves(params)
    m_leaves, v_leaves = tree_leaves(opt.mu), tree_leaves(opt.nu)
    if not len(g_leaves) == len(p_leaves) == len(m_leaves) == len(v_leaves):
        raise ValueError(
            f"adamw_update: {len(g_leaves)} gradients, {len(p_leaves)} "
            f"parameters, {len(m_leaves)} / {len(v_leaves)} moments")
    for g, p in zip(g_leaves, p_leaves):
        if g.shape != p.shape:
            raise ValueError(f"adamw_update: gradient {list(g.shape)} for "
                             f"parameter {list(p.shape)}")
    # The clip's scale is applied leaf by leaf below, not to a copy of
    # every gradient at once.
    scale, gn = _clip_scale(grads, cfg.max_grad_norm, norm)
    count = opt.count + 1
    lr = cosine_schedule(cfg, count)
    b1c = 1.0 - cfg.b1 ** count.float()
    b2c = 1.0 - cfg.b2 ** count.float()
    try:
        for g, m, v, p in zip(g_leaves, m_leaves, v_leaves, p_leaves):
            g32 = (g * scale.to(g.dtype)).float()
            m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g32)
            v.mul_(cfg.b2).add_((1.0 - cfg.b2) * g32 * g32)
            del g32
            step = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
            p32 = p.float()
            step.add_(cfg.weight_decay * p32)
            p.copy_(p32.sub_(lr * step))
    except Exception as e:
        raise UnreplayableStepError(
            "adamw_update failed while writing the parameters and moments "
            "in place") from e
    metrics = {"grad_norm": gn, "lr": lr}
    return params, OptState(mu=opt.mu, nu=opt.nu, count=count), metrics
