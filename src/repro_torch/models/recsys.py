"""DCN-v2 (arXiv:2008.13535): embedding tables, cross network and deep
tower, served and trained, the counterpart of ``repro.models.recsys``.

Parameters are a plain dict shaped like ``repro``'s tree: ``tables``
(``table_i`` f32[rows_i, embed_dim]), ``cross`` and ``deep`` (lists of
``{"w", "b"}`` in ``x @ W`` orientation), ``logit`` and ``item``.

``impl="cuda"`` builds x0 with one launch of the grouped EmbeddingBag
kernel (:func:`eb_ops.embedding_bag_grouped`), which copies the dense
features in, writes each field's row straight into its columns and clamps
each id into its own table, as ``repro``'s ``jnp.take`` on clipped ids
does: one launch per :func:`dcn_forward` and two per
:func:`retrieval_scores` (the user's fields, then the candidates' rows of
``table_0``).  ``impl="torch"`` is the oracle: each field as a bag of one
id (``ids[:, None]``, no weights, ``"sum"``) through the plain EmbeddingBag
and a ``torch.cat``.  A bag of one gives ``0 + row * 1 = row``, the row
itself (``-0.0`` entries come back as ``+0.0``, which compares equal).

Under grad the grouped lookup is a :class:`GroupedLookup` autograd
function (serving calls the kernel alone, without its per-call cost): the
forward is the kernel, unchanged (one launch), and the
backward gives each table the dense gradient that JAX's autodiff of
``jnp.take(table, clip(ids))`` gives, a scatter-add (``index_add_``) of
the output's columns over the clipped ids; ``repro`` has no backward
kernel here, so this one is stock torch.

Serving paths: pointwise scoring (:func:`dcn_forward`) and retrieval
(:func:`retrieval_scores`: user tower against candidate item vectors), both
under ``no_grad``.  Training: :func:`dcn_loss`, the stable binary cross
entropy with logits, on the same undecorated forward (:func:`dcn_logits`).

On a mesh (``mesh=``, a :class:`~repro_torch.distributed.comm.Mesh` of
``"data"`` / ``"model"`` axes) each rank holds its slices by
:func:`param_specs`, ``repro``'s, and does what ``repro``'s GSPMD program
does in its place: the lookup is one launch of the grouped kernel on the
rank's table shards with ``clip=False`` (an id another rank holds reads
zeros), then a ``psum`` over ``"model"`` (:func:`_sharded_lookup`); the
deep layers and the item tower split by columns gather them after each
product; retrieval keeps each rank's top K and merges them.  The train
step (``launch/train.py::make_recsys_step``) differentiates ``loss /
world size`` on every rank, so that ``psum``'s transpose, ``psum``, sends
the loss's gradient back through the lookup once in all.
"""

from __future__ import annotations

import torch

from repro_torch.configs import RecsysConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import comm
from repro_torch.distributed.comm import PartitionSpec as P
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.models.common import ALL, DP, TP, dense_init, \
    mesh_axes, split_keys

IMPLS = ("cuda", "torch")

# Tables at or above this row count are split by rows over "model"; the
# rest are whole on every rank.  A split table is row-padded to a multiple
# of 512 (the two-pod mesh's size), as in ``repro``, so that every mesh
# up to it splits the rows evenly.
SHARD_VOCAB_MIN = 100_000


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor | None = None, mode: str = "sum",
                  impl: str = "cuda") -> torch.Tensor:
    """EmbeddingBag: ids int32[B, nnz] (-1 = padding) -> [B, D].
    ``impl="cuda"``: the kernel on a CUDA tensor, its plain version on a
    CPU tensor; ``"torch"``: the plain version."""
    if impl == "cuda":
        return eb_ops.embedding_bag(table, ids, weights, mode)
    if impl == "torch":
        return embedding_bag_ref(table, ids, weights, mode)
    raise ValueError(f"embedding_bag: impl must be one of {IMPLS}, got "
                     f"{impl!r}")


def _table_rows(vocab: int) -> int:
    if vocab >= SHARD_VOCAB_MIN:
        return -(-vocab // 512) * 512
    return vocab


def param_shapes(cfg: RecsysConfig) -> dict:
    """The parameter tree's shapes, without allocating it."""
    d0 = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
    dims = (d0,) + cfg.mlp_dims
    return {
        "tables": {f"table_{i}": (_table_rows(v), cfg.embed_dim)
                   for i, v in enumerate(cfg.vocab_sizes)},
        "cross": [{"w": (d0, d0), "b": (d0,)}
                  for _ in range(cfg.n_cross_layers)],
        "deep": [{"w": (dims[i], dims[i + 1]), "b": (dims[i + 1],)}
                 for i in range(len(cfg.mlp_dims))],
        "logit": (d0 + cfg.mlp_dims[-1], 1),
        # Item tower for retrieval: an item id's table_0 row -> mlp_dims[-1].
        "item": (cfg.embed_dim, cfg.mlp_dims[-1]),
    }


def param_specs(cfg: RecsysConfig) -> dict:
    """``repro``'s ``param_specs``: tables of at least
    :data:`SHARD_VOCAB_MIN` rows split by rows over ``"model"``, the rest
    whole; the cross layers whole (``d0`` = 429 at full width divides by
    no mesh size); a deep layer's ``w`` split by columns over ``"model"``
    where its width is a multiple of 16, its ``b`` whole; ``item`` split
    by columns, ``logit`` whole."""
    tables = {f"table_{i}": (P(TP, None) if v >= SHARD_VOCAB_MIN
                             else P(None, None))
              for i, v in enumerate(cfg.vocab_sizes)}
    cross = [{"w": P(None, None), "b": P(None)}
             for _ in range(cfg.n_cross_layers)]
    deep = [{"w": P(None, TP) if width % 16 == 0 else P(None, None),
             "b": P(None)} for width in cfg.mlp_dims]
    return {"tables": tables, "cross": cross, "deep": deep,
            "logit": P(None, None), "item": P(None, TP)}


def init_dcn(cfg: RecsysConfig, generator: torch.Generator) -> dict:
    """Random parameters on ``generator``'s device, with ``repro``'s
    distributions: tables Normal(0, 0.02), weights Normal(0, 1/fan_in),
    biases 0, all f32."""
    shapes = param_shapes(cfg)
    gens = split_keys(generator, ["tables", "cross", "deep", "logit", "item"])
    dev = generator.device
    f32 = torch.float32
    tgens = split_keys(gens["tables"], list(shapes["tables"]))
    cgens = split_keys(gens["cross"], list(range(cfg.n_cross_layers)))
    dgens = split_keys(gens["deep"], list(range(len(cfg.mlp_dims))))

    def layer(g, s):
        return {"w": dense_init(g, s["w"], f32),
                "b": torch.zeros(s["b"], dtype=f32, device=dev)}

    return {
        "tables": {name: dense_init(tgens[name], s, f32, scale=0.02)
                   for name, s in shapes["tables"].items()},
        "cross": [layer(cgens[i], s) for i, s in enumerate(shapes["cross"])],
        "deep": [layer(dgens[i], s) for i, s in enumerate(shapes["deep"])],
        "logit": dense_init(gens["logit"], shapes["logit"], f32),
        "item": dense_init(gens["item"], shapes["item"], f32),
    }


def batch_to_device(batch: dict,
                    device: str | torch.device | None = None) -> dict:
    """A stream batch (numpy ``dense``, ``sparse``, ``label``) as tensors on
    ``device`` (``None``: the card)."""
    dev = resolve_device(device)
    return {name: torch.from_numpy(arr).to(dev) for name, arr in batch.items()}


def _grouped(tables, ids: torch.Tensor, col0: int,
             prefix: torch.Tensor | None, clip: bool = True) -> torch.Tensor:
    """One launch of the grouped kernel (its plain version on a CPU
    tensor) into a new [B, col0 + F * D] tensor: ids clipped into each
    table with ``clip``, else an id outside its table gives zeros."""
    out = torch.empty(ids.shape[0], col0 + len(tables) * tables[0].shape[1],
                      dtype=tables[0].dtype, device=tables[0].device)
    return eb_ops.embedding_bag_grouped(tables, ids, out, col0, clip=clip,
                                        prefix=prefix)


class GroupedLookup(torch.autograd.Function):
    """``grouped_lookup``'s autograd: the forward launches the grouped
    kernel once (:func:`_grouped`); the backward is stock torch."""

    @staticmethod
    def forward(ctx, ids, prefix, col0: int, clip: bool, *tables):
        ctx.save_for_backward(ids)
        ctx.col0, ctx.clip = col0, clip
        ctx.rows = [t.shape[0] for t in tables]
        return _grouped(tables, ids, col0, prefix, clip)

    @staticmethod
    def backward(ctx, g_out):
        (ids,) = ctx.saved_tensors
        col0, d = ctx.col0, (g_out.shape[1] - ctx.col0) // len(ctx.rows)
        g_tables = []
        for f, rows in enumerate(ctx.rows):
            if not ctx.needs_input_grad[4 + f]:
                g_tables.append(None)
                continue
            idx = torch.clamp(ids[:, f], 0, rows - 1)
            cols = g_out[:, col0 + f * d:col0 + (f + 1) * d]
            if not ctx.clip:        # an id outside the table read nothing
                inside = (ids[:, f] >= 0) & (ids[:, f] < rows)
                cols = torch.where(inside[:, None], cols, 0.0)
            g_tables.append(torch.zeros(rows, d, dtype=g_out.dtype,
                                        device=g_out.device
                                        ).index_add_(0, idx, cols))
        g_prefix = g_out[:, :col0] if ctx.needs_input_grad[1] else None
        return (None, g_prefix, None, None, *g_tables)


def grouped_lookup(tables, ids: torch.Tensor,
                   prefix: torch.Tensor | None = None,
                   clip: bool = True) -> torch.Tensor:
    """[B, col0 + F * D]: ``prefix`` [B, col0] (or nothing), then field f's
    row ``tables[f][clip(ids[:, f])]`` for each of the F tables (with
    ``clip=False``, zeros for an id outside its table), built by one
    launch of the grouped kernel and differentiable in the tables (and
    the prefix).  When nothing needs a gradient (serving) the kernel is
    called alone: :class:`GroupedLookup`'s ``apply`` costs about 30 us a
    call at ``serve_p99``'s shape on an H100 (``chip_smoke.py``'s
    ``lookup_routes``)."""
    ids = ids.contiguous()
    col0 = 0 if prefix is None else prefix.shape[1]
    if prefix is not None:
        prefix = prefix.contiguous()
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (prefix, *tables)):
        return GroupedLookup.apply(ids, prefix, col0, clip, *tables)
    return _grouped(tables, ids, col0, prefix, clip)


# --------------------------------------------------------------------------
# The mesh: ``param_specs``' splits, one rank's share of the work
# --------------------------------------------------------------------------


def _model_rank(mesh) -> tuple[tuple[str, ...], int, int]:
    """(the mesh's ``"model"`` axes, this rank's index along them, their
    size); ``((), 0, 1)`` without a mesh or a ``"model"`` axis."""
    tp = mesh_axes(mesh, TP)
    if not tp:
        return tp, 0, 1
    return tp, mesh.axis_index(tp), mesh.axis_size(tp)


def _split(spec, mesh) -> bool:
    """Whether a leaf of ``spec`` is split on ``mesh``."""
    return mesh is not None and bool(comm.split_axes(spec, mesh))


def _shard_ids(ids: torch.Tensor, tables, split: list[bool], mesh
               ) -> torch.Tensor:
    """ids int32[B, F] into each field's whole (padded) table -> ids into
    this rank's tables: clipped into the whole table as ``repro`` clips,
    then shifted by this rank's first row where the table is split (an id
    another rank holds falls outside the shard); -1 for a whole table
    except on model rank 0, so that each row is written on one rank of
    the ``"model"`` group and its ``psum`` adds zeros to it."""
    _, j, n = _model_rank(mesh)
    rows = torch.tensor([t.shape[0] for t in tables], device=ids.device)
    cut = torch.tensor(split, device=ids.device)
    whole = torch.where(cut, rows * n, rows)
    ids = torch.minimum(torch.clamp(ids, min=0), whole - 1)
    kept = ids if j == 0 else torch.full_like(ids, -1)
    return torch.where(cut, ids - j * rows, kept).to(torch.int32)


def _sharded_lookup(tables, ids: torch.Tensor, split: list[bool], mesh,
                    prefix: torch.Tensor | None = None) -> torch.Tensor:
    """The grouped lookup of F fields on a rank of ``mesh`` whose tables
    are its shards: one launch of the kernel with ``clip=False`` on the
    ids :func:`_shard_ids` gives (the prefix, like a whole table's rows,
    written on model rank 0 only), then a ``psum`` over ``"model"``.
    Every element is one row's value plus zeros: the one-process lookup's
    exactly."""
    tp, j, _ = _model_rank(mesh)
    if prefix is not None and j:
        prefix = torch.zeros_like(prefix)
    part = grouped_lookup(tables, _shard_ids(ids, tables, split, mesh),
                          prefix, clip=False)
    return comm.psum(part, tp, mesh=mesh) if tp else part


def _rows_of(table: torch.Tensor, ids: torch.Tensor, split: bool, mesh
             ) -> torch.Tensor:
    """``table``'s rows at this rank's ids int32[N] (clipped) -> [N, D],
    on a mesh: where the table is split over ``"model"``, the ids of the
    rank's ``"model"`` group gathered, looked up on this shard, and the
    partial rows reduce-scattered back to their ranks."""
    if not split:
        return grouped_lookup([table], ids[:, None])
    tp, _, _ = _model_rank(mesh)
    every = comm.all_gather(ids, tp, dim=0, tiled=True, mesh=mesh)
    part = grouped_lookup([table], _shard_ids(every[:, None], [table],
                                              [True], mesh), clip=False)
    return comm.reduce_scatter(part, tp, dim=0, mesh=mesh)


def _gather_cols(h: torch.Tensor, split: bool, mesh) -> torch.Tensor:
    """A tensor split by columns over ``"model"`` (a weight, or the rows
    every rank of the group holds times its columns of one): every rank's
    columns, all-gathered (the gradient reduce-scattered back)."""
    if not split:
        return h
    tp, _, _ = _model_rank(mesh)
    return comm.all_gather(h, tp, dim=1, tiled=True, mesh=mesh)


# --------------------------------------------------------------------------
# The model
# --------------------------------------------------------------------------


def _lookup(table: torch.Tensor, ids: torch.Tensor, impl: str) -> torch.Tensor:
    """``repro``'s ``jnp.take(table, clip(ids, 0, rows - 1))``.  ids:
    int32[N] -> [N, D]: the grouped kernel with one field on
    ``impl="cuda"``, a bag of one id per row on ``"torch"``."""
    if impl == "cuda":
        return grouped_lookup([table], ids[:, None])
    ids = torch.clamp(ids, 0, table.shape[0] - 1)
    return embedding_bag(table, ids[:, None], None, "sum", impl)


def _features(params: dict, dense: torch.Tensor, sparse_ids: torch.Tensor,
              cfg: RecsysConfig, impl: str, mesh=None) -> torch.Tensor:
    """dense f32[B, n_dense]; sparse_ids int32[B, n_sparse] -> x0 [B, d0].
    ``impl="cuda"``: one grouped launch writes every row of x0 whole, the
    dense columns and each field's row; on a mesh, the rank's shards by
    :func:`_sharded_lookup`."""
    tables = [params["tables"][f"table_{i}"] for i in range(cfg.n_sparse)]
    if mesh is not None:
        if impl != "cuda":
            raise ValueError(f"on a mesh the lookup is the kernel's "
                             f"(impl='cuda'), got impl={impl!r}")
        specs = param_specs(cfg)["tables"]
        split = [_split(specs[f"table_{i}"], mesh)
                 for i in range(cfg.n_sparse)]
        return _sharded_lookup(tables, sparse_ids, split, mesh, dense)
    if impl == "cuda":
        return grouped_lookup(tables, sparse_ids, prefix=dense)
    embs = [_lookup(t, sparse_ids[:, i], impl) for i, t in enumerate(tables)]
    return torch.cat([dense] + embs, dim=-1)


def _cross_tower(params: dict, x0: torch.Tensor) -> torch.Tensor:
    x = x0
    for lw in params["cross"]:
        x = x0 * (x @ lw["w"] + lw["b"]) + x
    return x


def _deep_tower(params: dict, x0: torch.Tensor, cfg: RecsysConfig,
                mesh=None) -> torch.Tensor:
    """The deep layers; on a mesh a layer whose ``w`` is split by columns
    takes its bias's slice and gathers its columns after the ReLU, so
    each output element is one whole dot product."""
    specs = param_specs(cfg)["deep"]
    h = x0
    for lw, spec in zip(params["deep"], specs):
        w, b = lw["w"], lw["b"]
        split = _split(spec["w"], mesh)
        if split:
            _, j, _ = _model_rank(mesh)
            b = b[j * w.shape[1]:(j + 1) * w.shape[1]]
        h = _gather_cols(torch.relu(h @ w + b), split, mesh)
    return h


def dcn_logits(params: dict, dense: torch.Tensor, sparse_ids: torch.Tensor,
               cfg: RecsysConfig, impl: str = "cuda", mesh=None
               ) -> torch.Tensor:
    """Pointwise CTR logits f32[B], differentiable in ``params``.  On a
    mesh: this rank's parameters (:func:`param_specs`) and rows of the
    batch (split over the data axes), its rows' logits."""
    x0 = _features(params, dense, sparse_ids, cfg, impl, mesh)
    z = torch.cat([_cross_tower(params, x0),
                   _deep_tower(params, x0, cfg, mesh)], dim=-1)
    return (z @ params["logit"])[:, 0]


@torch.no_grad()
def dcn_forward(params: dict, dense: torch.Tensor, sparse_ids: torch.Tensor,
                cfg: RecsysConfig, impl: str = "cuda", mesh=None
                ) -> torch.Tensor:
    """Pointwise CTR logits f32[B] (serving: no graph is built)."""
    return dcn_logits(params, dense, sparse_ids, cfg, impl, mesh)


def dcn_loss(params: dict, batch: dict, cfg: RecsysConfig,
             impl: str = "cuda", mesh=None) -> torch.Tensor:
    """Mean binary cross entropy of ``batch["label"]`` given the logits of
    ``batch["dense"]`` / ``batch["sparse"]``, in ``repro``'s stable form
    ``max(z, 0) - z * y + log1p(exp(-|z|))``.  On a mesh the mean is over
    the global batch: the rows' sum ``psum``-ed over the data axes,
    divided once; every rank holds it."""
    logits = dcn_logits(params, batch["dense"], batch["sparse"], cfg, impl,
                        mesh)
    y = batch["label"].float()
    per_row = (torch.clamp(logits, min=0) - logits * y
               + torch.log1p(torch.exp(-torch.abs(logits))))
    dp = mesh_axes(mesh, DP)
    if not dp:
        return torch.mean(per_row)
    return (comm.psum(per_row.sum(), dp, mesh=mesh)
            / (per_row.shape[0] * mesh.axis_size(dp)))


@torch.no_grad()
def user_vector(params: dict, dense: torch.Tensor, sparse_ids: torch.Tensor,
                cfg: RecsysConfig, impl: str = "cuda", mesh=None
                ) -> torch.Tensor:
    """The user tower: [B, mlp_dims[-1]]."""
    return _deep_tower(params, _features(params, dense, sparse_ids, cfg,
                                         impl, mesh), cfg, mesh)


def _top_k(scores: torch.Tensor, k: int) -> tuple[torch.Tensor,
                                                  torch.Tensor]:
    """The ``k`` highest of each row and their positions, highest first,
    the lower position first among equal scores (``lax.top_k``)."""
    idx = torch.sort(scores, dim=-1, descending=True, stable=True
                     ).indices[:, :k]
    return torch.gather(scores, 1, idx), idx


def _first_of_id(ids: torch.Tensor) -> torch.Tensor:
    """For each position of ``ids`` int[N], the lowest position that holds
    the same id: a stable sort puts equal ids in position order, and a
    binary search finds the first of each.  Scores gathered through it are
    bit-equal for equal ids whatever order the product summed each column
    in (a host GEMM's tail columns take another order than its body), so
    :func:`_top_k` gives them ``lax.top_k``'s order.  Static shapes, so it
    also runs on ``meta``."""
    sid, order = torch.sort(ids, stable=True)
    return order[torch.searchsorted(sid, ids)]


@torch.no_grad()
def retrieval_scores(params: dict, dense: torch.Tensor,
                     sparse_ids: torch.Tensor, cand_ids: torch.Tensor,
                     cfg: RecsysConfig, top_k: int = 100,
                     impl: str = "cuda", mesh=None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Score B queries against item ids ``cand_ids`` int32[n_cand] (rows
    of ``table_0``); return the top ``top_k`` scores [B, top_k] and their
    candidate positions, highest first, the lower position first among
    equal scores (as ``lax.top_k``).  Equal ids after the clip score
    bit-equal: each candidate takes the score of its id's first position
    (:func:`_first_of_id`).

    On a mesh the queries are whole on every rank and ``cand_ids`` is
    this rank's block of the candidates (split over every axis): the rank
    scores its block (``table_0``'s rows by :func:`_rows_of`, the item
    tower gathered whole); the blocks' scores and clipped ids, gathered
    in rank order, give every candidate its id's first score across the
    ranks, and the global top ``top_k`` by the same stable sort."""
    u = user_vector(params, dense, sparse_ids, cfg, impl, mesh)  # [B, Dv]
    table = params["tables"]["table_0"]
    if mesh is None:
        ids = torch.clamp(cand_ids, 0, table.shape[0] - 1)
        cand_emb = _lookup(table, ids, impl)
        scores = u @ (cand_emb @ params["item"]).T
        return _top_k(scores[:, _first_of_id(ids)], top_k)
    specs = param_specs(cfg)
    split = _split(specs["tables"]["table_0"], mesh)
    cand_emb = _rows_of(table, cand_ids, split, mesh)
    # The ranks of a "model" group score other candidates: each takes the
    # whole item tower (16 x mlp_dims[-1]), not its columns of the product.
    item = _gather_cols(params["item"], _split(specs["item"], mesh), mesh)
    rows = table.shape[0] * (_model_rank(mesh)[2] if split else 1)
    axes = mesh_axes(mesh, ALL)
    ids = comm.all_gather(torch.clamp(cand_ids, 0, rows - 1), axes, dim=0,
                          tiled=True, mesh=mesh)
    scores = comm.all_gather(u @ (cand_emb @ item).T, axes, dim=1,
                             tiled=True, mesh=mesh)
    return _top_k(scores[:, _first_of_id(ids)], top_k)
