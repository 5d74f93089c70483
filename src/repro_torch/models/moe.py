"""Mixture-of-Experts FFN (dbrx 16e top-4, granite 40e top-8): the twin of
``repro.models.moe``.

Each token's router picks its top-k experts; a cumsum over the flattened
(token, slot) assignments, token-major, ranks each expert's tokens, and an
assignment past the expert's capacity is dropped.  The kept tokens are
scattered into per-expert buffers ``[E, C, D]``, run through each expert's
SwiGLU MLP, gathered back and summed with their gates.

Three regimes, chosen by :func:`dispatch_kind` as ``repro``'s ``moe_ffn``
chooses them:

1. ``_moe_sharded`` (a mesh and many tokens): sequence-parallel x (batch
   over ``pod``/``data``, sequence over ``model``), local routing and
   capacity, the FSDP all-gather of the expert weights, a tiled
   all_to_all of the dispatch buffers to the experts' owners over
   ``model`` and back, a local combine, the aux pmean'd over every axis;
2. ``_moe_dense_all`` (a mesh, few tokens): every rank runs its own
   experts on every token, masked by the routing weights, and the partial
   outputs are summed over ``model``;
3. :func:`moe_local` (no mesh): one device.

Under a mesh a rank holds its slice of the weights (:data:`PARAM_SPECS`,
``repro``'s ``param_specs`` of a MoE layer; experts padded to a multiple
of the ``model`` size and masked out of routing past ``n_real``).
:func:`moe_block` takes the block of x that the transformer's residual
gives this rank (its rows of the batch over the data axes and, under
sequence parallelism, its positions over ``model``) and returns y in the
same block: the sharded path runs on that block as it is, the dense one
gathers the sequence first and reduce-scatters y back onto it.
:func:`moe_ffn` is :func:`moe_block` on the ambient mesh.  Each mesh path
has a single-process twin (:func:`moe_sharded_twin`,
:func:`moe_dense_all_twin`): every rank's block in a loop over the whole
weights, the collectives done as tensor ops.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs import MoESpec
from repro_torch.distributed import comm
from repro_torch.distributed.comm import PartitionSpec as P
from repro_torch.models.common import FSDP, TP, dense_init, mesh_axes, \
    pad_to, split_keys

NEG_INF = -1e30
PARAMS = ("router", "w_gate", "w_up", "w_down")
# A rank's slice of one MoE layer: experts over "model", d_model over the
# FSDP axes (axes a mesh lacks are dropped).
PARAM_SPECS = {"router": P(None, None),
               "w_gate": P("model", FSDP, None),
               "w_up": P("model", FSDP, None),
               "w_down": P("model", None, FSDP)}


def param_shapes(d_model: int, spec: MoESpec, e_pad: int) -> dict:
    f = spec.d_ff_expert
    return {"router": (d_model, e_pad), "w_gate": (e_pad, d_model, f),
            "w_up": (e_pad, d_model, f), "w_down": (e_pad, f, d_model)}


def init_moe(generator: torch.Generator, d_model: int, spec: MoESpec,
             e_pad: int, dtype: torch.dtype) -> dict:
    """One layer's expert weights drawn as ``repro``'s ``init_moe`` draws
    them (normal x 1/sqrt(fan_in)); the router is f32 whatever ``dtype``."""
    ks = split_keys(generator, PARAMS)
    return {name: dense_init(ks[name], shape,
                             torch.float32 if name == "router" else dtype)
            for name, shape in param_shapes(d_model, spec, e_pad).items()}


def capacity(n_tokens: int, spec: MoESpec, e_pad: int) -> int:
    """Slots per expert: ``capacity_factor`` x the even share, at least 4,
    a multiple of 4."""
    c = int(n_tokens * spec.top_k * spec.capacity_factor / e_pad) + 1
    return max(4, pad_to(c, 4))


def _one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """``F.one_hot(ids, n)`` as the compare ``meta`` decomposes it into,
    so that a rank's counter counts on any device what a counting mesh
    counts on ``meta`` (the CPU's one-hot scatters instead)."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).long()


def _route(router, x, spec: MoESpec, n_real: int, e_pad: int):
    """The router in f32: returns (gate [T, k], ids [T, k], probs [T, E],
    logits [T, E]).  Ties go to the lower expert id, as ``lax.top_k``."""
    logits = x.float() @ router
    if n_real < e_pad:
        pad = torch.arange(e_pad, device=x.device) >= n_real
        logits = logits.masked_fill(pad[None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    gate, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, ids = gate[:, :spec.top_k], ids[:, :spec.top_k]
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    return gate, ids, probs, logits


def _aux(probs, ids, logits, e_pad: int, keep=None, axes=(),
         mesh=None) -> dict:
    """Load balance (E x sum of mean prob x mean assignment), router z-loss
    and the share of assignments dropped past capacity.  ``axes``: mesh
    axes the tokens are split over in equal shares; the means are taken
    over every rank's tokens (``pmean``), as one ``jnp.mean`` over the
    whole batch."""
    mean = (lambda t: comm.pmean(t, axes, mesh=mesh)) if axes else \
        (lambda t: t)
    me = mean(probs.mean(dim=0))
    ce = mean(_one_hot(ids, e_pad).float().mean(dim=(0, 1)))
    out = {"load_balance": (me * ce).sum() * e_pad,
           "router_z": mean((torch.logsumexp(logits, dim=-1) ** 2).mean())}
    if keep is None:
        out["dropped_frac"] = torch.zeros((), device=probs.device)
    else:
        # XLA's mean: the sum times the f32 reciprocal of the count.
        inv = torch.tensor(1.0 / keep.numel(), device=keep.device)
        out["dropped_frac"] = 1.0 - keep.float().sum() * inv
    return out


def _dispatch_local(x, gate, ids, spec: MoESpec, e_pad: int, c: int):
    """Cumsum-ranked capacity assignment: returns (buf [E, C, D], slot,
    keep, tok_of), one entry of the last three per (token, slot), token-major.
    A dropped assignment's slot is ``e_pad * c``, past the buffer."""
    t, d = x.shape
    k = spec.top_k
    flat_ids = ids.reshape(-1)
    # Expert-major one-hot [E, T*k]: the cumsum runs along the inner dim,
    # which the card scans in parallel (along the outer dim of a
    # [T*k, E] one-hot it runs one thread per expert).
    oh = _one_hot(flat_ids, e_pad).T.contiguous()
    pos = oh.cumsum(dim=1) - oh
    my_pos = pos.gather(0, flat_ids[None, :])[0]
    keep = my_pos < c
    slot = torch.where(keep, flat_ids * c + my_pos,
                       torch.full_like(flat_ids, e_pad * c))
    tok_of = torch.arange(t * k, device=x.device) // k
    # Kept slots are distinct; every dropped one lands on the extra row.
    buf = torch.zeros((e_pad * c + 1, d), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, slot, x[tok_of])
    return buf[:-1].reshape(e_pad, c, d), slot, keep, tok_of


def _combine_local(y_buf, slot, keep, tok_of, gate, t: int):
    """Each kept assignment's expert output x its gate (in the buffer's
    dtype), summed per token.  A token's k assignments are consecutive
    (``tok_of`` is ``arange // k``), so the segment sum is a sum over k."""
    e_c, d = y_buf.shape[0] * y_buf.shape[1], y_buf.shape[2]
    y_rep = y_buf.reshape(e_c, d)[slot.clamp(max=e_c - 1)]
    y_rep = torch.where(keep[:, None], y_rep, 0)
    y_rep = y_rep * gate.reshape(-1)[:, None].to(y_rep.dtype)
    return y_rep.reshape(t, -1, d).sum(dim=1)


def _expert_mlp(buf, wg, wu, wd):
    """Every expert's SwiGLU on its slots: [E, C, D] -> [E, C, D]."""
    return (F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)) @ wd


def moe_local(params: dict, x: torch.Tensor, spec: MoESpec, n_real: int):
    """x [T, D] -> ([T, D] in x's dtype, aux)."""
    t, _ = x.shape
    e_pad = params["router"].shape[1]
    c = capacity(t, spec, e_pad)
    gate, ids, probs, logits = _route(params["router"], x, spec, n_real, e_pad)
    buf, slot, keep, tok_of = _dispatch_local(x, gate, ids, spec, e_pad, c)
    y_buf = _expert_mlp(buf, params["w_gate"], params["w_up"],
                        params["w_down"])
    y = _combine_local(y_buf, slot, keep, tok_of, gate, t)
    return y.to(x.dtype), _aux(probs, ids, logits, e_pad, keep)


def _mesh_axes(mesh: comm.Mesh, fsdp=None
               ) -> tuple[tuple[str, ...], tuple[str, ...]]:
    """(the FSDP axes, the expert axes) the mesh has; ``fsdp``: the FSDP
    axes of the spec the weights were cut by (default :data:`FSDP`)."""
    return mesh_axes(mesh, FSDP if fsdp is None else fsdp), \
        mesh_axes(mesh, TP)


def _gather_experts(params: dict, fsdp: tuple, mesh: comm.Mesh):
    """This rank's experts with d_model whole (the FSDP all-gather)."""
    wg, wu, wd = params["w_gate"], params["w_up"], params["w_down"]
    if fsdp:
        wg = comm.all_gather(wg, fsdp, dim=1, tiled=True, mesh=mesh)
        wu = comm.all_gather(wu, fsdp, dim=1, tiled=True, mesh=mesh)
        wd = comm.all_gather(wd, fsdp, dim=2, tiled=True, mesh=mesh)
    return wg, wu, wd


def _moe_sharded(params: dict, x_loc3: torch.Tensor, spec: MoESpec,
                 n_real: int, mesh: comm.Mesh, fsdp=None):
    """``repro``'s ``_moe_sharded`` block on this rank: ``params`` this
    rank's slices (:data:`PARAM_SPECS`), ``x_loc3`` its block [B / fsdp,
    S / tp, D] of x.  Returns (y block, aux, (ids, slot, keep)), the aux
    pmean'd over the FSDP and expert axes."""
    fsdp, tp = _mesh_axes(mesh, fsdp)
    e_pad = params["router"].shape[1]
    b_loc, s_loc, d = x_loc3.shape
    x_loc = x_loc3.reshape(b_loc * s_loc, d)
    t_loc = x_loc.shape[0]
    c_loc = capacity(t_loc, spec, e_pad)
    wg, wu, wd = _gather_experts(params, fsdp, mesh)
    gate, ids, probs, logits = _route(params["router"], x_loc, spec, n_real,
                                      e_pad)
    buf, slot, keep, tok_of = _dispatch_local(x_loc, gate, ids, spec, e_pad,
                                              c_loc)
    if tp:
        # Experts to their owners: [E, C, D] -> [E / tp, C * tp, D].
        buf = comm.all_to_all(buf, tp, split_dim=0, concat_dim=1, mesh=mesh)
    y_buf = _expert_mlp(buf, wg, wu, wd)
    if tp:
        y_buf = comm.all_to_all(y_buf, tp, split_dim=1, concat_dim=0,
                                mesh=mesh)
    y = _combine_local(y_buf, slot, keep, tok_of, gate, t_loc)
    aux = {k: comm.pmean(v, fsdp + tp, mesh=mesh)
           for k, v in _aux(probs, ids, logits, e_pad, keep).items()}
    return (y.reshape(b_loc, s_loc, d).to(x_loc3.dtype), aux,
            (ids, slot, keep))


def moe_sharded_twin(params: dict, x3d: torch.Tensor, spec: MoESpec,
                     n_real: int, fsdp: int, tp: int):
    """:func:`_moe_sharded` on a (fsdp, tp) mesh in one process: the whole
    weights and x [B, S, D]; every rank's block in a loop, the all_to_alls
    as tensor ops.  Returns (y [B, S, D], aux, [(ids, slot, keep)] per rank
    in rank order)."""
    b, s, d = x3d.shape
    e_pad = params["router"].shape[1]
    bl, sl, e_loc = b // fsdp, s // tp, e_pad // tp
    ranks = [(f, j) for f in range(fsdp) for j in range(tp)]
    routed = {}
    for f, j in ranks:
        x_loc = x3d[f * bl:(f + 1) * bl, j * sl:(j + 1) * sl].reshape(-1, d)
        c_loc = capacity(x_loc.shape[0], spec, e_pad)
        gate, ids, probs, logits = _route(params["router"], x_loc, spec,
                                          n_real, e_pad)
        buf, slot, keep, tok_of = _dispatch_local(x_loc, gate, ids, spec,
                                                  e_pad, c_loc)
        routed[f, j] = (gate, ids, probs, logits, buf, slot, keep, tok_of)
    y_bufs = {}
    for f, j in ranks:
        experts = slice(j * e_loc, (j + 1) * e_loc)
        buf = torch.cat([routed[f, src][4][experts] for src in range(tp)],
                        dim=1)
        y_bufs[f, j] = _expert_mlp(buf, params["w_gate"][experts],
                                   params["w_up"][experts],
                                   params["w_down"][experts])
    y = torch.empty_like(x3d)
    auxes = []
    for f, j in ranks:
        gate, ids, probs, logits, buf, slot, keep, tok_of = routed[f, j]
        c_loc = buf.shape[1]
        y_buf = torch.cat([y_bufs[f, owner][:, j * c_loc:(j + 1) * c_loc]
                           for owner in range(tp)], dim=0)
        y_loc = _combine_local(y_buf, slot, keep, tok_of, gate, len(ids))
        y[f * bl:(f + 1) * bl, j * sl:(j + 1) * sl] = y_loc.reshape(
            bl, sl, d).to(x3d.dtype)
        auxes.append(_aux(probs, ids, logits, e_pad, keep))
    aux = {k: torch.stack([a[k] for a in auxes]).sum(0) / len(ranks)
           for k in auxes[0]}
    return y, aux, [routed[r][1:2] + routed[r][5:7] for r in ranks]


def _dense_all_partial(x, w_te, wg, wu, wd):
    """Every token through the given experts, weighted by their columns of
    the routing weights ``w_te`` [T, E_held]: [T, D]."""
    h = (F.silu(torch.einsum("td,edf->tef", x, wg))
         * torch.einsum("td,edf->tef", x, wu))
    y_e = torch.einsum("tef,efd->ted", h, wd)
    return torch.einsum("ted,te->td", y_e, w_te.to(y_e.dtype))


def _routing_weights(router, x, spec: MoESpec, n_real: int, e_pad: int,
                     axes=(), mesh=None):
    gate, ids, probs, logits = _route(router, x, spec, n_real, e_pad)
    w_te = (_one_hot(ids, e_pad).float() * gate[..., None]).sum(dim=1)
    return w_te, _aux(probs, ids, logits, e_pad, axes=axes, mesh=mesh)


def _moe_dense_all(params: dict, x: torch.Tensor, spec: MoESpec,
                   n_real: int, mesh: comm.Mesh, token_axes=(),
                   reduce: bool = True, fsdp=None):
    """``repro``'s ``_moe_dense_all`` on this rank: x [T, D] the same on
    every rank of ``model`` (by default on every rank; ``token_axes``:
    the data axes its tokens are split over), ``params`` this rank's
    slices; this rank's experts on every token, summed over ``model``
    (with ``reduce=False`` left unsummed, in x's dtype, for the caller to
    reduce).  Returns (y [T, D], aux)."""
    fsdp, tp = _mesh_axes(mesh, fsdp)
    e_pad = params["router"].shape[1]
    wg, wu, wd = _gather_experts(params, fsdp, mesh)
    w_te, aux = _routing_weights(params["router"], x, spec, n_real, e_pad,
                                 token_axes, mesh)
    e_loc = wg.shape[0]
    lo = (mesh.axis_index(tp) if tp else 0) * e_loc
    y = _dense_all_partial(x, w_te[:, lo:lo + e_loc], wg, wu, wd)
    if tp and reduce:
        y = comm.psum(y, tp, mesh=mesh)
    return y.to(x.dtype), aux


def moe_dense_all_twin(params: dict, x: torch.Tensor, spec: MoESpec,
                       n_real: int, tp: int):
    """:func:`_moe_dense_all` over ``tp`` expert ranks in one process: each
    rank's partial output, summed in rank order."""
    e_pad = params["router"].shape[1]
    w_te, aux = _routing_weights(params["router"], x, spec, n_real, e_pad)
    e_loc = e_pad // tp
    parts = [_dense_all_partial(
        x, w_te[:, j * e_loc:(j + 1) * e_loc],
        *(params[n][j * e_loc:(j + 1) * e_loc]
          for n in ("w_gate", "w_up", "w_down"))) for j in range(tp)]
    return torch.stack(parts).sum(0).to(x.dtype), aux


def dispatch_kind(b: int, s: int, mesh: comm.Mesh | None,
                  fsdp=None) -> str:
    """``repro``'s ``moe_ffn`` rule: "local" without a mesh; "sharded" when
    ``b * s >= 4096``, the FSDP size divides ``b`` and the expert-axis
    size divides ``s``; else "dense_all"."""
    if mesh is None:
        return "local"
    fsdp, tp = _mesh_axes(mesh, fsdp)
    n_fsdp = math.prod(mesh.shape[a] for a in fsdp)
    n_tp = math.prod(mesh.shape[a] for a in tp)
    if b * s >= 4096 and b % n_fsdp == 0 and s % n_tp == 0:
        return "sharded"
    return "dense_all"


def moe_block(params: dict, x: torch.Tensor, spec: MoESpec,
              n_experts_real: int, mesh: comm.Mesh | None,
              seq_parallel: bool = False, fsdp=None
              ) -> tuple[torch.Tensor, dict]:
    """The MoE FFN of this rank's block of x: [B / fsdp, S / tp (with
    ``seq_parallel``) or S, D] -> (y in the same block, aux).  Without a
    mesh, x is the whole batch.  On ``mesh`` the path is
    :func:`dispatch_kind`'s for the whole batch: "sharded" runs
    :func:`_moe_sharded` on the sequence block (cut here from x when the
    residual is not split on it, and y gathered back); "dense_all" runs
    :func:`_moe_dense_all` on every position (gathered here under
    ``seq_parallel``) and sums y over ``model`` (reduce-scattered onto the
    block under ``seq_parallel``).  ``fsdp``: the axes the experts'
    d_model and x's rows are split over (default :data:`FSDP`'s)."""
    b, s, d = x.shape
    if mesh is None:
        y, aux = moe_local(params, x.reshape(b * s, d), spec, n_experts_real)
        return y.reshape(b, s, d), aux
    fsdp, tp = _mesh_axes(mesh, fsdp)
    n_tp = mesh.axis_size(tp)
    e_pad = params["router"].shape[1]
    if params["w_gate"].shape[0] * n_tp != e_pad:
        raise ValueError(
            f"under a mesh moe_ffn takes this rank's expert slice "
            f"(PARAM_SPECS): {params['w_gate'].shape[0]} experts of "
            f"{e_pad} on {n_tp} expert ranks")
    s_all = s * n_tp if seq_parallel else s
    kind = dispatch_kind(b * mesh.axis_size(fsdp), s_all, mesh, fsdp)
    if kind == "dense_all":
        if seq_parallel and tp:
            x = comm.all_gather(x, tp, dim=1, tiled=True, mesh=mesh)
        y, aux = _moe_dense_all(params, x.reshape(b * s_all, d), spec,
                                n_experts_real, mesh, token_axes=fsdp,
                                reduce=False, fsdp=fsdp)
        y = y.reshape(b, s_all, d)
        if tp:
            y = comm.reduce_scatter(y, tp, dim=1, mesh=mesh) if \
                seq_parallel else comm.psum(y, tp, mesh=mesh)
        return y, aux
    if seq_parallel:
        y, aux, _ = _moe_sharded(params, x, spec, n_experts_real, mesh, fsdp)
        return y, aux
    sl, tj = s // n_tp, mesh.axis_index(tp)
    y, aux, _ = _moe_sharded(params, x[:, tj * sl:(tj + 1) * sl], spec,
                             n_experts_real, mesh, fsdp)
    if tp:
        y = comm.all_gather(y, tp, dim=1, tiled=True, mesh=mesh)
    return y, aux


def moe_ffn(params: dict, x: torch.Tensor, spec: MoESpec,
            n_experts_real: int, seq_parallel: bool = False
            ) -> tuple[torch.Tensor, dict]:
    """:func:`moe_block` on the ambient mesh
    (:func:`repro_torch.distributed.comm.mesh_scope`); without one, x
    [B, S, D] whole on one device."""
    return moe_block(params, x, spec, n_experts_real, comm.get_mesh(),
                     seq_parallel)
