"""Roofline terms on NVIDIA H100 SXM cards, the useful work of each cell,
and the least time of each hand-written kernel.

  t_compute    = Σ_dtype FLOPs(dtype) / peak(dtype)
  t_memory     = min_bytes / 3.35 TB/s
  t_collective = wire bytes / 450 GB/s (NVLink 4; 0 on one card)

Every term is one rank's: its FLOPs, its bytes and what it sends, from a
count of one rank's call (on a mesh of ranks, or on a
:class:`~repro_torch.distributed.comm.CountingMesh`).  The wire bytes are
the count's collective bytes weighed by ``repro``'s ring factors
(:data:`repro_torch.analysis.count.WIRE_FACTORS`).  The link rate is
NVLink 4's: 18 links at 25 GB/s each way, 450 GB/s a card each way (the
data sheet's 900 GB/s counts both directions).  That holds within one
8-card NVLink domain only: beyond 8 cards a mesh axis crosses
InfiniBand, about 50 GB/s a card (one 400 Gb/s NIC a card), so on
``repro``'s 256- and 512-rank meshes the term understates the time of
any collective over an axis that spans hosts, by up to 9x (the same kind
of caveat as ``repro``'s note on its DCI link; no per-axis model here).

The peaks are NVIDIA's data sheet for the SXM part (dense, no sparsity,
at the full 700 W): 989 TFLOP/s in bf16 and fp16 on the tensor cores,
495 TFLOP/s in TF32, 67 TFLOP/s in float32 outside the tensor cores, and
3.35 TB/s of HBM3.  A float32 product runs on the tensor cores only when
``torch.backends.cuda.matmul.allow_tf32`` is on, so an f32 cell is held
to 67 TFLOP/s unless it is.

FLOPs and bytes come from :mod:`repro_torch.analysis.count`'s count of
one call; ``model_flops_*`` are the analytic useful-work counts of
``repro.analysis.roofline`` (6·N·D dense, 6·N_active·D MoE, closed forms
for GNN / recsys / DKS), so ``model_flops / flops`` exposes recompute
and padding.  The kernel formulas at the end (``*_work`` -> bytes and
operations, ``bound`` -> ms and what bounds it) are what each kernel
wrapper reports to an active counter and what ``chip_smoke.py`` holds
each kernel's time against.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
BF16_OPS_PER_S = 989e12     # dense bf16 / fp16 on the tensor cores
TF32_OPS_PER_S = 495e12     # dense TF32 on the tensor cores
F32_OPS_PER_S = 67e12       # float32 outside the tensor cores
CARD_BYTES = 80e9           # the card's HBM ("80 GB"); fits_one_card's limit
NVLINK_BYTES_PER_S = 450e9  # NVLink 4, one direction: 18 links x 25 GB/s
COLLECTIVE_NOTE = ("wire bytes over NVLink 4 (450 GB/s a card each way); "
                   "beyond 8 cards an axis crosses InfiniBand (~50 GB/s a "
                   "card), which this term does not model")


def peak_flops(dtype: torch.dtype | str) -> float:
    """The card's peak rate for products in ``dtype``: bf16 / fp16 on the
    tensor cores; float32 at TF32's rate only where
    ``torch.backends.cuda.matmul.allow_tf32`` is on."""
    name = str(dtype).replace("torch.", "")
    if name in ("bfloat16", "float16"):
        return BF16_OPS_PER_S
    if name == "float32" and torch.backends.cuda.matmul.allow_tf32:
        return TF32_OPS_PER_S
    return F32_OPS_PER_S


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops: float             # the compute term's FLOPs (a rank's)
    flops_by_dtype: dict
    min_bytes: float         # arguments read once, outputs written once
    eager_bytes: float       # every eager op's inputs and outputs
    collective_bytes: float  # the wire bytes a rank sends
    model_flops: float       # the whole step's, over every chip
    peak_flops: float        # the rate of the dtype carrying most FLOPs
    t_compute: float
    t_memory: float
    t_memory_eager: float
    t_collective: float
    bottleneck: str
    useful_flops_frac: float
    collective_note: str = COLLECTIVE_NOTE

    def as_row(self) -> dict:
        return dataclasses.asdict(self)


def roofline(arch: str, shape: str, summary, model_flops: float,
             mesh_name: str = "card", chips: int = 1) -> RooflineTerms:
    """The three-term roofline of one rank's call, from its
    :class:`~repro_torch.analysis.count.CountSummary`, on a mesh of
    ``chips`` cards (``mesh_name``; one card by default).  ``model_flops``
    is the whole step's and is divided by ``chips``, as ``repro``'s is.  A
    program whose FLOPs are under 1 % of a chip's share of
    ``model_flops`` (DKS's min-plus lattice, the GNNs' segment ops) does
    its work outside the products a counter sees: its compute term takes
    that share at the f32 rate, as ``repro``'s does.  The collective term
    is the rank's wire bytes over :data:`NVLINK_BYTES_PER_S`; the
    bottleneck is the largest of the three terms."""
    by_dtype = dict(summary.flops_by_dtype)
    flops = sum(by_dtype.values())
    per_chip = model_flops / chips
    if flops < 0.01 * per_chip:
        by_dtype = {"float32": float(per_chip)}
        flops = float(per_chip)
    t_c = sum(f / peak_flops(d) for d, f in by_dtype.items())
    lead = max(by_dtype, key=by_dtype.get) if by_dtype else "float32"
    t_m = summary.min_bytes / HBM_BYTES_PER_S
    wire = summary.wire_bytes
    t_x = wire / NVLINK_BYTES_PER_S
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    return RooflineTerms(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips, flops=flops,
        flops_by_dtype=by_dtype, min_bytes=summary.min_bytes,
        eager_bytes=summary.eager_bytes, collective_bytes=wire,
        model_flops=model_flops, peak_flops=peak_flops(lead),
        t_compute=t_c, t_memory=t_m,
        t_memory_eager=summary.eager_bytes / HBM_BYTES_PER_S,
        t_collective=t_x, bottleneck=max(terms, key=terms.get),
        useful_flops_frac=per_chip / flops if flops > 0 else 0.0)


# --------------------------------------------------------------------------
# Useful work (repro.analysis.roofline's closed forms, exactly)
# --------------------------------------------------------------------------


def model_flops_lm(cfg, shape, built=None) -> float:
    """6·N·D (dense) / 6·N_active·D (MoE) + attention flops.

    For decode shapes D = new tokens (=batch) but attention still reads the
    whole KV cache; we count matmul work: 6·N_active·B + attn 2·2·B·S·H·dh.
    """
    n_act = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.seq_len * shape.global_batch
        attn = (12 * cfg.n_layers * cfg.n_heads * cfg.head_dim
                * shape.seq_len * shape.seq_len * shape.global_batch) // 2
        return 6.0 * n_act * tokens + attn
    if shape.kind == "prefill":
        tokens = shape.seq_len * shape.global_batch
        attn = (4 * cfg.n_layers * cfg.n_heads * cfg.head_dim
                * shape.seq_len * shape.seq_len * shape.global_batch) // 2
        return 2.0 * n_act * tokens + attn
    # decode: one token per sequence
    tokens = shape.global_batch
    attn = (4 * cfg.n_layers * cfg.n_heads * cfg.head_dim
            * shape.seq_len * shape.global_batch)
    return 2.0 * n_act * tokens + attn


def model_flops_gnn(cfg, shape, n_nodes: int, n_edges: int) -> float:
    """Closed-form useful flops per family (fwd+bwd = 3x fwd for training)."""
    d = cfg.d_hidden
    d_in = max(shape.d_feat, 1)
    if cfg.family == "gat":
        per_layer = (2 * n_nodes * d_in * d * cfg.n_heads
                     + 6 * n_edges * d * cfg.n_heads)
        fwd = cfg.n_layers * per_layer
    elif cfg.family == "gin":
        fwd = cfg.n_layers * (2 * n_edges * d + 4 * n_nodes * d * d)
    elif cfg.family == "pna":
        n_agg = len(cfg.aggregators) * len(cfg.scalers)
        fwd = cfg.n_layers * (2 * n_nodes * d * d
                              + 4 * n_edges * d
                              + 2 * n_nodes * (n_agg + 1) * d * d)
    else:  # schnet
        fwd = cfg.n_layers * (2 * n_edges * (cfg.rbf * d + d * d + d)
                              + 6 * n_nodes * d * d)
    return 3.0 * fwd


def model_flops_recsys(cfg, shape) -> float:
    d0 = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
    cross = cfg.n_cross_layers * 2 * d0 * d0
    dims = (d0,) + cfg.mlp_dims
    deep = sum(2 * dims[i] * dims[i + 1] for i in range(len(cfg.mlp_dims)))
    per_ex = cross + deep + 2 * (d0 + cfg.mlp_dims[-1])
    if shape.kind == "train":
        return 3.0 * shape.batch * per_ex
    if shape.kind == "retrieval":
        cand = shape.n_candidates
        return (shape.batch * (deep)
                + 2.0 * cand * cfg.embed_dim * cfg.mlp_dims[-1]
                + 2.0 * shape.batch * cand * cfg.mlp_dims[-1])
    return 1.0 * shape.batch * per_ex


def model_flops_dks(v: int, e: int, m: int, k: int) -> float:
    """Per-superstep useful work: relax (E·2^m·K adds + segment mins) +
    combine (V · pairs · K² min-plus)."""
    n_sets = 1 << m
    pairs = (3 ** m + 1) // 2 - 2 ** m
    relax = 2.0 * e * n_sets * k
    combine = 2.0 * v * pairs * k * k
    return relax + combine


# --------------------------------------------------------------------------
# The hand-written kernels: bytes and operations of one call, and the
# least time for them.  Each ``*_work`` takes its wrapper's arguments and
# returns (bytes, operations, the operations' dtype).  Where the work
# depends on the data it counts what these inputs need; on ``meta``
# tensors, which hold no data, it counts the most the shapes allow.
# --------------------------------------------------------------------------


def bound(nbytes: float, ops: float,
          ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    """The least time in ms for ``nbytes`` of HBM traffic and ``ops``
    operations at ``ops_per_s``, and which of the two bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def lane_work(S0, changed, done, offsets, src, w, m=None, hubs=None,
              result=None) -> tuple[float, float, torch.dtype]:
    """One fused superstep: every lane's own table read once and written
    once (the rows senders pass on are bytes of that same table), ``w`` of
    every real in-edge, ``src`` of the finite-weight ones, the flags and
    the offsets; against an add and a compare per candidate of a live
    lane's finite in-edge from an active sender."""
    lanes, v, f, k = S0.shape
    if S0.is_meta:
        n_e = n_finite = src.shape[0]
        n_rows = lanes * n_e
    else:
        n_e = int(offsets[-1])
        finite = w[:n_e] < 5e8
        n_finite = int(finite.sum())
        n_rows = int(changed[~done][:, src[:n_e].long()[finite]].sum())
    nbytes = (2 * S0.numel() * 4 + 4 * n_e + 4 * n_finite
              + lanes * v + (v + 1) * 8 + lanes)
    return nbytes, 2 * n_rows * f * k, torch.float32


def lane_bound(S0, changed, done, offsets, src, w) -> tuple[float, str]:
    """Least time for one fused superstep on these inputs
    (:func:`lane_work`)."""
    return bound(*lane_work(S0, changed, done, offsets, src, w)[:2])


def combine_work(S, m, result=None) -> tuple[float, float, torch.dtype]:
    """The subset-combine closure: the table read once and written once,
    against a min-plus (an add and a compare) per K x K pair of every
    split of every row."""
    from repro_torch.core.spa import split_pairs

    k = S.shape[-1]
    rows = S.numel() // ((1 << m) * k)
    return (2 * S.numel() * 4, rows * len(split_pairs(m)) * k * k * 2,
            torch.float32)


def combine_bound(S, m) -> tuple[float, str]:
    return bound(*combine_work(S, m)[:2])


def topk_work(cand, k, result=None) -> tuple[float, float, torch.dtype]:
    """``padded_topk``: the candidates read once and the [Vv, F, K] result
    written once, against one compare per candidate."""
    vv, _, f = cand.shape
    return (cand.numel() + vv * f * k) * 4, cand.numel(), torch.float32


# Bytes of one entry of each input of the walk that its scans test.
BACKTRACE_ENTRY_BYTES = {"kw": 1, "pa": 4, "pb": 4, "S": 4, "indptr": 8,
                         "ew": 4, "esrc": 4}


def backtrace_reads(args, reads: dict | None = None) -> dict:
    """The distinct entries of each input of the walk on ``args`` (the
    wrapper's arguments) that the host's first-match order tests, by
    input name, and ``"scans"``: int64[obligations, 3] on the host, each
    obligation's walk, split items (p, i) and neighbours tested.
    ``reads``: what the plain walk already filled in on these arguments
    (``batched_backtrace_ref(..., reads=)``), else it runs here."""
    from repro_torch.kernels.batched_backtrace.ref import \
        batched_backtrace_ref

    if reads is None:
        reads = {}
        batched_backtrace_ref(*args, reads=reads)
    out = {name: int(torch.unique(torch.cat(reads[name])).numel())
           if reads.get(name) else 0 for name in BACKTRACE_ENTRY_BYTES}
    cols = [torch.cat(reads[k]).cpu() if reads.get(k) else
            torch.zeros(0, dtype=torch.long)
            for k in ("walk", "split_items", "neighbours")]
    out["scans"] = torch.stack(cols, dim=1)
    return out


def _backtrace_bytes(lanes: int, c: int, buffer: int,
                     distinct: dict | None = None) -> int:
    """The walk's bytes: every record array written once and the
    candidates read once, plus, where the scans are known (``distinct``,
    :func:`backtrace_reads`), each input entry they test read once."""
    nbytes = 5 * lanes * c * buffer * 4 + lanes * c + lanes * c * 8
    if distinct is not None:
        nbytes += sum(distinct[name] * size
                      for name, size in BACKTRACE_ENTRY_BYTES.items())
    return nbytes


def backtrace_work(S, kw, cand_idx, cand_val, indptr, esrc, ew, pa, pb,
                   buffer, degree_cap, result=None
                   ) -> tuple[float, float, torch.dtype]:
    """The walk's bytes (:func:`_backtrace_bytes`) with its scans: each
    input entry that the host's first-match order tests on these inputs,
    counted once (the plain walk counts them: :func:`backtrace_reads`).
    Without records (``meta``) only the writes and the candidates
    count."""
    lanes, c = cand_idx.shape
    distinct = None
    if result is not None and not S.is_meta:
        distinct = backtrace_reads((S, kw, cand_idx, cand_val, indptr, esrc,
                                    ew, pa, pb, buffer, degree_cap))
    return _backtrace_bytes(lanes, c, buffer, distinct), 0, torch.float32


def backtrace_bound(args, distinct: dict | None = None
                    ) -> tuple[float, str]:
    """Least time of the walk on ``args`` (:func:`backtrace_work`'s bytes;
    ``distinct``: :func:`backtrace_reads` of these arguments, else counted
    here)."""
    lanes, c = args[2].shape
    if distinct is None:
        distinct = backtrace_reads(args)
    return bound(_backtrace_bytes(lanes, c, args[-2], distinct), 0)


def backtrace_rounds(distinct: dict, threads: int, edges: int = 4) -> dict:
    """What sets the walk's time: the serial steps of its longest walk, at
    ``threads`` a walk testing ``edges`` neighbours each a round
    (``csrc/batched_backtrace.cu``): its obligations, its split rounds
    (each obligation's items (p, i) over ``threads``, rounded up) and edge
    rounds (its neighbours over ``threads * edges``); the walk with the
    most of the three together (:func:`backtrace_reads`' ``"scans"``)."""
    walk, items, nbrs = distinct["scans"].unbind(1)
    if walk.numel() == 0:
        return {"obligations": 0, "split_rounds": 0, "edge_rounds": 0,
                "threads": threads}
    per = torch.stack([torch.ones_like(walk), -(-items // threads),
                       -(-nbrs // (threads * edges))], dim=1)
    sums = torch.zeros(int(walk.max()) + 1, 3, dtype=torch.long)
    sums.index_add_(0, walk, per)
    o, sr, er = sums[int(sums.sum(1).argmax())].tolist()
    return {"obligations": o, "split_rounds": sr, "edge_rounds": er,
            "threads": threads}


def flash_flops(q, k, q_offset: int = 0) -> int:
    """4·Dh FLOPs per visible (query, key) pair and query head: the two
    matrix products of causal attention forward."""
    b, sq, hq, dh = q.shape
    pos = q_offset + np.arange(sq)
    return 4 * b * hq * dh * int(np.minimum(k.shape[1], pos + 1).sum())


def flash_work(q, k, v=None, q_offset: int = 0, result=None
               ) -> tuple[float, float, torch.dtype]:
    """Causal attention forward: q, k, v read once and o written once,
    against :func:`flash_flops`."""
    nbytes = q.element_size() * 2 * (q.numel() + k.numel())
    return nbytes, flash_flops(q, k, q_offset), q.dtype


def flash_bound(q, k, q_offset: int = 0) -> tuple[float, str]:
    """Least time for causal attention forward on these inputs: its FLOPs
    over the dense bf16 rate, against q, k, v read once and o written
    once."""
    return bound(*flash_work(q, k, q_offset=q_offset)[:2], BF16_OPS_PER_S)


def bag_work(table, ids, weighted: bool) -> tuple[int, int, int]:
    """Bytes and operations of one EmbeddingBag call on these inputs: each
    distinct table row that a valid id names read once (a row named again
    can come from the cache), the ids, the weights and the output, against
    a multiply and an add per gathered element; and the table's bytes
    read."""
    v, d = table.shape
    if ids.is_meta:
        n_valid = ids.numel()
        n_rows = min(n_valid, v)
    else:
        valid = (ids >= 0) & (ids < v)
        n_valid = int(valid.sum())
        n_rows = int(torch.unique(ids[valid]).numel())
    nbytes = (n_rows * d + ids.numel() * (2 if weighted else 1)
              + ids.shape[0] * d) * 4
    return nbytes, 2 * n_valid * d, n_rows * d * 4


def bag_bound(table, ids, weighted: bool) -> tuple[float, str]:
    """Least time for one EmbeddingBag call on these inputs (``bag_work``
    over HBM bandwidth and the f32 rate)."""
    return bound(*bag_work(table, ids, weighted)[:2])


def embedding_bag_work(table, ids, weights=None, mode="sum", result=None
                       ) -> tuple[float, float, torch.dtype]:
    nbytes, ops, rows = bag_work(table, ids, weights is not None)
    return nbytes, ops, torch.float32, [(table, rows)]


def grouped_work(tables, ids, out=None, col0=0, clip=False, prefix=None,
                 result=None) -> tuple[float, float, torch.dtype]:
    """One grouped lookup: :func:`bag_work` of each field's bags of one id
    (clipped into the table when ``clip``), summed over the fields, and
    the prefix columns read once and written once; each table's bytes
    read."""
    tables = list(tables)
    work = [bag_work(t, ids[:, f:f + 1].clamp(0, t.shape[0] - 1)
                     if clip else ids[:, f:f + 1], False)
            for f, t in enumerate(tables)]
    nbytes = sum(w[0] for w in work)
    if prefix is not None:
        nbytes += 2 * prefix.numel() * 4
    return (nbytes, sum(w[1] for w in work), torch.float32,
            [(t, w[2]) for t, w in zip(tables, work)])


def grouped_bound(tables, ids, prefix=None) -> tuple[float, str]:
    """Least time for one grouped lookup with clipped ids
    (:func:`grouped_work`)."""
    return bound(*grouped_work(tables, ids, clip=True, prefix=prefix)[:2])
