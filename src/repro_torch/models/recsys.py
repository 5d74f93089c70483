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
"""

from __future__ import annotations

import torch

from repro_torch.configs import RecsysConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.embedding_bag.ref import embedding_bag_ref
from repro_torch.models.common import dense_init, split_keys

IMPLS = ("cuda", "torch")

# Tables at or above this row count are row-padded to a multiple of 512,
# as in ``repro`` (which shards them over its mesh), so that parameter
# trees carry across.
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
             prefix: torch.Tensor | None) -> torch.Tensor:
    """One launch of the grouped kernel (its plain version on a CPU
    tensor) into a new [B, col0 + F * D] tensor, ids clipped."""
    out = torch.empty(ids.shape[0], col0 + len(tables) * tables[0].shape[1],
                      dtype=tables[0].dtype, device=tables[0].device)
    return eb_ops.embedding_bag_grouped(tables, ids, out, col0, clip=True,
                                        prefix=prefix)


class GroupedLookup(torch.autograd.Function):
    """``grouped_lookup``'s autograd: the forward launches the grouped
    kernel once (:func:`_grouped`); the backward is stock torch."""

    @staticmethod
    def forward(ctx, ids, prefix, col0: int, *tables):
        ctx.save_for_backward(ids)
        ctx.col0 = col0
        ctx.rows = [t.shape[0] for t in tables]
        return _grouped(tables, ids, col0, prefix)

    @staticmethod
    def backward(ctx, g_out):
        (ids,) = ctx.saved_tensors
        col0, d = ctx.col0, (g_out.shape[1] - ctx.col0) // len(ctx.rows)
        g_tables = []
        for f, rows in enumerate(ctx.rows):
            if not ctx.needs_input_grad[3 + f]:
                g_tables.append(None)
                continue
            idx = torch.clamp(ids[:, f], 0, rows - 1)
            cols = g_out[:, col0 + f * d:col0 + (f + 1) * d]
            g_tables.append(torch.zeros(rows, d, dtype=g_out.dtype,
                                        device=g_out.device
                                        ).index_add_(0, idx, cols))
        g_prefix = g_out[:, :col0] if ctx.needs_input_grad[1] else None
        return (None, g_prefix, None, *g_tables)


def grouped_lookup(tables, ids: torch.Tensor,
                   prefix: torch.Tensor | None = None) -> torch.Tensor:
    """[B, col0 + F * D]: ``prefix`` [B, col0] (or nothing), then field f's
    row ``tables[f][clip(ids[:, f])]`` for each of the F tables, built by
    one launch of the grouped kernel and differentiable in the tables (and
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
        return GroupedLookup.apply(ids, prefix, col0, *tables)
    return _grouped(tables, ids, col0, prefix)


def _lookup(table: torch.Tensor, ids: torch.Tensor, impl: str) -> torch.Tensor:
    """``repro``'s ``jnp.take(table, clip(ids, 0, rows - 1))``.  ids:
    int32[N] -> [N, D]: the grouped kernel with one field on
    ``impl="cuda"``, a bag of one id per row on ``"torch"``."""
    if impl == "cuda":
        return grouped_lookup([table], ids[:, None])
    ids = torch.clamp(ids, 0, table.shape[0] - 1)
    return embedding_bag(table, ids[:, None], None, "sum", impl)


def _features(params: dict, dense: torch.Tensor, sparse_ids: torch.Tensor,
              cfg: RecsysConfig, impl: str) -> torch.Tensor:
    """dense f32[B, n_dense]; sparse_ids int32[B, n_sparse] -> x0 [B, d0].
    ``impl="cuda"``: one grouped launch writes every row of x0 whole, the
    dense columns and each field's row."""
    tables = [params["tables"][f"table_{i}"] for i in range(cfg.n_sparse)]
    if impl == "cuda":
        return grouped_lookup(tables, sparse_ids, prefix=dense)
    embs = [_lookup(t, sparse_ids[:, i], impl) for i, t in enumerate(tables)]
    return torch.cat([dense] + embs, dim=-1)


def _cross_tower(params: dict, x0: torch.Tensor) -> torch.Tensor:
    x = x0
    for lw in params["cross"]:
        x = x0 * (x @ lw["w"] + lw["b"]) + x
    return x


def _deep_tower(params: dict, x0: torch.Tensor) -> torch.Tensor:
    h = x0
    for lw in params["deep"]:
        h = torch.relu(h @ lw["w"] + lw["b"])
    return h


def dcn_logits(params: dict, dense: torch.Tensor, sparse_ids: torch.Tensor,
               cfg: RecsysConfig, impl: str = "cuda") -> torch.Tensor:
    """Pointwise CTR logits f32[B], differentiable in ``params``."""
    x0 = _features(params, dense, sparse_ids, cfg, impl)
    z = torch.cat([_cross_tower(params, x0), _deep_tower(params, x0)], dim=-1)
    return (z @ params["logit"])[:, 0]


@torch.no_grad()
def dcn_forward(params: dict, dense: torch.Tensor, sparse_ids: torch.Tensor,
                cfg: RecsysConfig, impl: str = "cuda") -> torch.Tensor:
    """Pointwise CTR logits f32[B] (serving: no graph is built)."""
    return dcn_logits(params, dense, sparse_ids, cfg, impl)


def dcn_loss(params: dict, batch: dict, cfg: RecsysConfig,
             impl: str = "cuda") -> torch.Tensor:
    """Mean binary cross entropy of ``batch["label"]`` given the logits of
    ``batch["dense"]`` / ``batch["sparse"]``, in ``repro``'s stable form
    ``max(z, 0) - z * y + log1p(exp(-|z|))``."""
    logits = dcn_logits(params, batch["dense"], batch["sparse"], cfg, impl)
    y = batch["label"].float()
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


@torch.no_grad()
def user_vector(params: dict, dense: torch.Tensor, sparse_ids: torch.Tensor,
                cfg: RecsysConfig, impl: str = "cuda") -> torch.Tensor:
    """The user tower: [B, mlp_dims[-1]]."""
    return _deep_tower(params, _features(params, dense, sparse_ids, cfg, impl))


@torch.no_grad()
def retrieval_scores(params: dict, dense: torch.Tensor,
                     sparse_ids: torch.Tensor, cand_ids: torch.Tensor,
                     cfg: RecsysConfig, top_k: int = 100,
                     impl: str = "cuda") -> tuple[torch.Tensor, torch.Tensor]:
    """Score B queries against item ids ``cand_ids`` int32[n_cand] (rows
    of ``table_0``); return the top ``top_k`` scores [B, top_k] and their
    candidate positions, highest first, the lower position first among
    equal scores (as ``lax.top_k``)."""
    u = user_vector(params, dense, sparse_ids, cfg, impl)        # [B, Dv]
    cand_emb = _lookup(params["tables"]["table_0"], cand_ids, impl)
    scores = u @ (cand_emb @ params["item"]).T                   # [B, n_cand]
    order = torch.sort(scores, dim=-1, descending=True, stable=True).indices
    idx = order[:, :top_k]
    return torch.gather(scores, 1, idx), idx
