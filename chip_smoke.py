#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):

1. Device — fail unless ``torch.cuda.is_available()``; print the card's
   ``nvidia-smi --query-gpu=name,power.limit`` line.
2. Build — compile every CUDA source under ``src/repro_torch/csrc`` with
   nvcc (all at once), timed; each kernel's ptxas register and spill
   lines; the HGMMA (wgmma) and UTMALDG (TMA load) instructions in the
   flash library's SASS (``cuobjdump``), which must be there.
3. DKS kernels against their plain torch versions on the card, exact
   equality (tolerance 0: every lattice value is a min, a compare or one
   f32 add; the backtrace records are integers): random small shapes
   (``subset_combine``, ``lane_superstep`` and ``padded_topk`` up to m = 6
   keywords and K = 8 slots; the ``batched_backtrace`` walk on the final
   tables of 8 random buckets, stragglers included), then the main path's
   shapes (the
   paper-scale sec-rdfabout graph, an 8-lane m=3 K=3 bucket, a real mid-run
   state with one lane done; the hub count and threshold of
   ``lane_superstep``'s warp-per-hub rows), each kernel and plain version
   timed with CUDA events, and ``lane_superstep`` timed on cut edge
   lists, each with the hub list built for it.
4. Oracle — random small graphs through ``QueryEngine(backend="cuda")``;
   every top-1 weight equals the Dreyfus-Wagner optimum.
5. DKS main path — sec-rdfabout (460,451 nodes, 500,384 edges, vocabulary
   50,000, seed 7, tau 1001) on ``QueryEngine(backend="cuda")``: one
   ``query_batch`` bucket of 8 lanes (m=3, k=3) and two ``query`` calls
   (m=4, k=2), with the kernels' launch counters set to 0 just before and
   read just after (one ``batched_backtrace`` launch for the bucket); every
   result, answer trees and ``extraction_stats`` included, must equal the
   ``backend="torch"`` run.  Then the bucket's extraction is split on its
   final tables (device sort + walk, host replay + ``finish_tree``) beside
   the 981.2 ms the host collector took (PERF.md), and the walk kernel is
   held against
   its plain version there and timed beside a bytes floor.
6. LM serving — the flash-attention kernel against its plain version
   (random small shapes: MHA, GQA, MQA, ragged lengths, ``q_offset``; f32
   within 2e-5, bf16 within 2e-2; then the main path's shape, timed beside
   the plain version and ``scaled_dot_product_attention``, with TFLOP/s
   and the share of the bound), then
   ChatGLM3-6B at full width in bf16 with random weights from a seeded
   CUDA generator through ``repro_torch.launch.serve.generate``: 4 prompts
   of 2,048 tokens and then one of 1,000, each a prefill through the
   kernel (the launch counters set to 0 just before and read just after:
   28 launches per prefill, all on the ``"wgmma"`` route) and 32 greedy
   decode steps.  The prefill's
   last logits must agree with a prefill on naive attention within
   5e-2 x max |logit| (this script's own limit: one absolute bound on
   every logit), and so must the logits of the served tokens fed back
   through the KV cache with a naive prefill of the same tokens; beside
   each, the element-wise reading max |d| / (5e-2 + 5e-2 |want|) is
   printed (at most 1 would meet an element-wise atol = rtol = 5e-2).
   The first token must equal naive attention's wherever the top-2
   margin exceeds the difference.  Then torch.profiler splits one prefill and one
   decode step into kernel time and host time.
7. Recsys serving — the multi-hot EmbeddingBag kernel against its plain
   version at random small shapes (sum and mean, with and without
   weights, -1 pads, ids past the table, all-pad bags, nnz 1..300, D
   8..256) within atol = rtol = 1e-5, and the grouped lookup (F fields in
   one launch, at misaligned columns, ids clipped or padded) exactly; the
   multi-hot kernel timed at ids [65,536, 32] into DCN-v2's 10,000,384 x
   16 ``table_0`` (Zipf ids, 30 % pads, weights) with L2 warm and cold
   beside its plain version and ``F.embedding_bag``; then DCN-v2 at full
   width in f32 (26 tables, 29,497,558 rows x 16, random weights from a
   seeded CUDA generator, TF32 off) serving one batch each of
   ``serve_p99`` (512), ``serve_bulk`` (262,144) and ``retrieval_cand``
   (1 query x 1,000,448 candidates, top 100) from
   ``recsys_synthetic_stream``: the launch counter set to 0 just before
   and read just after (one grouped launch per forward, two per
   retrieval), and logits, scores and candidate positions bit-equal to
   ``impl="torch"``; then the grouped kernel at each of those lookups,
   equal to its plain version and to ``F.embedding`` per field, timed
   beside both.
8. Padded-CSR relax — one lane of a real mid-run state of the
   sec-rdfabout m=3 K=3 bucket (three supersteps in) through
   ``segment_minplus_padded`` at dmax=64 (one ``padded_topk`` launch):
   equal, exactly, to its plain version and to ``core/dks.py::relax``;
   ``padded_topk`` timed at that candidate shape beside its plain version.
9. Serving — the sec-rdfabout engines of phase 5 behind
   ``repro_torch.serve.DKSService`` on ``"cuda"``: a ``make_trace`` of 32
   requests (8 unique keyword sets, a quarter under a 75 ms deadline)
   from 8 client threads in ``serve_dks --smoke``'s settings (max_batch
   4, a 50 ms window), asserting coalescing, warm cache hits, a
   multi-lane deadline bucket, served trees, a ``/metrics`` scrape and
   every exact answer equal to ``engine.query`` on ``"cuda"`` and on
   ``"torch"`` (the kernels held at the replay's own shapes); then the
   phase 5 bucket
   through ``query_deadline_batch`` at ``deadline_s=0`` and at a deadline
   no run reaches, one ``query_stream`` (every update's weights and
   bounds) and telemetry-carrying engines (results equal to telemetry
   off, rows equal across backends), each held exactly against
   ``"torch"``.  Prints served p50 / p99 latency, the replay's requests/s
   (``ServeStats.throughput_rps``, first submit to last resolve), batch fill,
   cache hit rate, the bucket's driver vs lane supersteps and
   ``ExtractionOverlap``'s overlapped/inline split, ms per superstep of a
   stream (bounds every superstep) against a deadline run (bounds once),
   and the service's own launches of ``lane_superstep``, ``subset_combine``
   and ``batched_backtrace`` (zeroed just before the service starts, read
   just after it stops; each must be above zero).
10. Store and live graphs — phase 5's sec-rdfabout graph and index
   through ``repro_torch.store`` on ``"cuda"``: ``from_graph`` ->
   ``write_artifact`` (a temporary directory) -> ``open_artifact`` with
   every buffer re-hashed -> ``QueryEngine.build(artifact=...)``, whose
   bucket and two m = 4 queries equal phase 5's exactly (weights,
   supersteps, trees; the same launches), ``version`` the artifact's hash;
   artifact bytes, write MB/s, open and build ms.  Then the live leg: the
   graph's edges as a TSV whose entity names carry each node's tokens,
   ``ingest_tsv`` -> ``LiveDir.initialize`` -> an engine on the chain ->
   ``DKSService`` (``serve_dks --smoke``'s settings) under 4 client threads,
   and a fragment dropped into a watched directory (a shortcut between a
   probe pair 3 hops apart, a new entity with a fresh keyword):
   ``GraphWatcher`` publishes the delta and ``EngineSwapper`` builds, warms
   and swaps on the watcher's thread.  Asserted: no failed request, every
   served probe weight the base engine's or the union's, post-swap answers
   equal to engines on ``compact_chain`` (the union) on ``"cuda"`` and
   ``"torch"``, the chained version, staleness 0, build/warm/swap spans,
   every hot shape warmed, the warm's launches (counted on the watcher's
   thread while the dispatcher launched) equal to the same warm replayed
   alone, and device memory after three swaps and ``gc.collect()`` within
   one build's bytes of where it started.  Prints ingest edges/s, the
   delta's write ms, the swap's build / warm / swap ms, requests served
   across it, the service's and the warm's launches and the memory.
12. Sharded partition — phase 5's sec-rdfabout graph and index on
   ``ExecutionPolicy(partition="sharded", n_shards=4)`` (the
   frontier-compressed partition: 4 shards of the node axis on the one
   card, ``backend="torch"``): uncapped (``frontier_frac=1.0``), the
   bucket and the two m = 4 queries equal phase 5 exactly (weights,
   supersteps, flags, answer trees); at the default cap (0.25) each lane
   of the bucket equals phase 5 or stops with ``budget_hit`` and a sound
   bound, SPA <= phase 5's exact top-1 <= its own top-1; a small graph
   whose cap overflows answers on the card exactly as on the CPU
   (``query_batch`` and a stream); phase 9's ``make_trace`` served through
   ``DKSService`` on the sharded engine, every exact answer equal to
   ``engine.query``.  Prints the driver's ms per superstep beside phase
   5's ``"cuda"`` and ``"torch"``, the frontier bytes gathered per
   superstep against the dense table's, ``e_cap`` and the shard
   imbalance, peak device memory, and the hand-written kernels'
   launches on this path (zeroed just before, read just after: 0, since
   the sharded engine runs stock torch).
11. MoE and the int8 KV cache — the flash kernel at granite-moe-3b-a800m's
   prefill shape (q bf16 [4, 2048, 24, 64], k/v [4, 2048, 8, 64]) against
   its plain version, timed beside it and SDPA with its bound; then
   granite at full width and depth (32 layers, 40 experts top-8, head dim
   64; 3,374,295,552 bf16 parameters, random from a seeded CUDA
   generator, the router in f32) through ``serve.generate`` with phase 6's
   traffic and checks (4 x 2,048 and 1 x 1,000 tokens, 32 greedy steps
   each, 32 ``"wgmma"`` flash launches per prefill, logits within 5e-2 x
   max |logit| of naive attention), each prefill's per-layer
   ``dropped_frac`` and ``load_balance``, and a torch.profiler split.
   The int8 cache: the 4 x 2,048 prefill's K/V through ``quantize_kv``
   into a cache of 4,096 positions, 32 ``decode_step_quant`` steps fed
   the bf16-cache decode's greedy tokens, logits within atol = rtol =
   0.25 of its (``tests/test_kvcache.py``'s bound) and the greedy token
   equal wherever the top-2 margin exceeds the difference; then both
   caches grown to 32,768 positions (decode_32k's length at batch 4) and
   8 steps of each timed and held there, with the cache bytes.  Then
   dbrx-132b and command-r-plus-104b at full width and cut depth (4 of 40
   and 2 of 64 layers; full depth does not fit one card): a 4 x 2,048
   prefill through the kernel against naive attention and 8 decode steps.
13. Training — granite-moe-3b-a800m at full width and depth (phase 11's
   3,374,295,552 bf16 parameters, random from a seeded CUDA generator)
   through ``repro_torch.launch.train.train_lm``: 16 steps of 4 x 2,048
   tokens from ``lm_synthetic_stream`` (``repro``'s defaults: lr 3e-4,
   warm-up max(1, steps // 20), remat, ``"chunked"`` attention, AdamW
   with f32 moments); each step's loss, grad_norm and lr, its ms split
   into forward+backward and optimizer (host clock, synchronised),
   tokens/s, peak memory and the first and last step's per-layer
   ``dropped_frac``; every loss finite and the last below the first.
   From a fresh model and one batch, the loss and gradient norm on
   ``"flash_jax"`` (the hand-written backward) within 2e-2 relative of
   ``"chunked"``'s (bf16 scores); one step at ``grad_accum=2`` with its
   peak beside ``grad_accum=1``'s.  A checkpoint: granite at full width
   cut to 2 layers, saved after 2 steps, restored onto the card from a
   meta template, every leaf bit-equal, step 3's loss equal to the
   uninterrupted run's exactly; bytes and seconds.  DCN-v2 at full width
   through ``train_recsys`` on ``impl="cuda"``: 20 steps of 8,192 rows,
   one grouped-lookup launch a step (the counter zeroed just before and
   read just after), the loss falling, ms a step; one batch's table
   gradients within 1e-5 of ``impl="torch"``'s.  The f32 smoke configs
   of ChatGLM3-6B and granite: one train step on the card and on the CPU
   from the same weights, loss, grad_norm and parameters within 1e-4.
   TF32 is off throughout.
14. bluk-bnb — the paper's large dataset at full size (16,100,000 nodes,
   46,600,000 generated edges, vocabulary 500,000, seed 7, tau 1001),
   generated, indexed and built on ``QueryEngine(backend="cuda")`` (host
   ms each, the device graph's bytes); phase 5's traffic (a bucket of 8,
   m=3, k=3, and two m=4, k=2 queries) with the launch counters set to 0
   just before and read just after; per query supersteps, driver ms and
   ms per superstep, extraction ms, ``extraction_stats``, rows fetched
   and lane tables copied (0) for stragglers; a second run of the bucket
   checks every per-superstep message count against its int64 sum
   rounded to f32 and prints the largest beside 2^24; the three DKS
   kernels held exactly against their plain versions at its shapes
   (``batched_backtrace`` on the bucket's final tables,
   ``subset_combine`` on its ``init_state`` table, ``lane_superstep`` two
   supersteps in with lane 0 done) and timed beside their bounds; a
   ``backend="torch"`` twin of the bucket's first ``BLUK_TWIN_LANES``
   lanes and the first m=4 query equal to the ``"cuda"`` lanes exactly,
   ``extraction_stats`` and rows fetched included.
15. GNN — the four families of ``repro_torch.models.gnn`` (GAT, GIN, PNA,
   SchNet at their published widths, random weights from a seeded CUDA
   generator, synthetic data from seeded numpy at each shape's published
   size, features correlated with the labels), TF32 off.  Leg 1: each on
   its home shape (gat-cora on ``full_graph_sm``, the others on
   ``molecule``), f32, one ``gnn_train_step`` on the card and on the CPU
   from the same weights and batch: loss within 1e-4 relative, every
   gradient leaf within 1e-4 of its largest magnitude.  Leg 2: the same at
   ``mp_dtype="bfloat16"``, 16 AdamW steps each at
   ``examples/gnn_train.py``'s schedule, the loss falling; ms a step and
   peak memory.  Leg 3: ``ogb_products`` (2,449,029 nodes, 61,859,140
   edges, 100 features, nothing cut) x gin-tu, bf16, 4 steps, ms a step,
   peak memory, the batch's device bytes, one step under torch.profiler;
   the first step's loss within ``GNN_LOSS_BOUND`` of an f32 forward's,
   the bf16 forward's logits within ``GNN_LOGIT_BOUND`` (relative L2) of
   the f32 one's.  Leg 4: ``ogb_products`` x pna, the loss under
   ``no_grad`` in bf16 and f32 through the chunked aggregate (4 chunks),
   the logits' gap held as gin-tu's, then one train step.  Leg
   5: ``minibatch_lg`` x gat-cora, bf16: a reddit-size host graph built by
   ``build_graph``, 1,024 seeds sampled at fanout (15, 10), the sample's
   features to the card, 8 steps; host ms of the build and the sampling.
   The kernels' launch counters are set to 0 before the phase and read
   after it: the GNN path reaches no ``pallas_call`` in ``repro`` and
   launches none of the port's kernels.
16. The kernels line: one JSON object with each kernel's launches on the
   DKS query path (phase 5; ``serving_launches`` adds ``DKSService``'s
   in phase 9 for the three kernels it runs; ``store_launches`` and
   ``live_launches`` phase 10's artifact engine, live service and warm;
   ``sharded_launches`` phase 12's; the flash row's ``moe_launches`` and
   ``cut_depth_launches`` phase 11's, and ``moe_shape`` its times at
   granite's shape; the bag row's ``train_launches`` phase 13's DCN-v2
   steps; the DKS rows' ``bluk_launches`` and ``bluk_shape`` phase 14's;
   ``gnn_launches`` phase 15's, all 0), error, times and bound.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 on the tensor cores
BUCKET_M, BUCKET_K, BUCKET_LANES = 3, 3, 8
SINGLE_M, SINGLE_K, N_SINGLE = 4, 2, 2
QUERY_SEED = 2024
LM_ARCH, LM_SEED = "chatglm3-6b", 0
LM_BATCH, LM_PROMPT, LM_LONG, LM_GEN = 4, 2048, 1000, 32
LM_TOL = 5e-2               # bf16 logits against naive: x max |logit|
MOE_ARCH = "granite-moe-3b-a800m"   # phase 11, at full width and depth
QUANT_SEQ, QUANT_LONG, QUANT_LONG_STEPS = 4096, 32768, 8  # int8 cache legs
QUANT_TOL = 0.25            # tests/test_kvcache.py: int8 against bf16 cache
CUT_DEPTH = {"dbrx-132b": 4, "command-r-plus-104b": 2}  # layers one card holds
CUT_GEN = 8                 # decode steps of the cut-depth models
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
RECSYS_ARCH, RECSYS_SEED, RETRIEVAL_TOP_K, CAND_SEED = "dcn-v2", 0, 100, 11
REQUEST_REPS = 9            # host-clock repeats of each recsys request
LOOKUP_ROUTE_REPS = 300     # serve_p99's x0 by each route, interleaved
BAG_TOL = 1e-5              # repro's tests/test_kernels.py: sums reorder
BAG_SHAPES = (              # b, nnz, d, mode, weighted
    (37, 1, 16, "sum", False),
    (511, 3, 8, "mean", True),
    (1000, 64, 16, "sum", True),
    (77, 17, 32, "mean", False),
    (129, 8, 128, "sum", True),
    (3001, 32, 16, "mean", True),
    (203, 33, 12, "sum", True),
    (65, 300, 64, "mean", True),
    (90, 31, 256, "sum", False),
)
GROUPED_SHAPES = (          # b, fields, d, col0, extra columns past them
    (1, 1, 16, 0, 0),
    (300, 3, 16, 13, 0),
    (1031, 26, 16, 13, 0),
    (517, 5, 12, 1, 3),
)
BAG_TIMED = (65_536, 32, 0.3)   # bags, ids per bag, share of -1 pads
L2_FLUSH_BYTES = 128 << 20  # written between cold launches: > 2 x 50 MB L2
SPIN_CYCLES_PER_S = 2e9     # at or above the H100's top SM clock (1.98 GHz)
PADDED_STEPS, PADDED_DMAX = 3, 64
SERVE_REQUESTS, SERVE_UNIQUE, SERVE_CLIENTS = 32, 8, 8
SERVE_DEADLINE_FRAC, SERVE_DEADLINE_MS = 0.25, 75.0
SERVE_TIMEOUT_S = 120       # the most any served request is waited for
LIVE_CLIENTS = 4            # phase 10's client threads across the swap
LIVE_PROBE_HOPS = 3         # the live probe pair's hop distance
SHARDS = 4                  # phase 12's shards, all on the one card
SHARDED_CAP = 0.25          # phase 12's capped run: the default cap
SMALL_SHARDED = (3001, 12000, 0.05)  # phase 12's small graph and its cap
TRAIN_ARCH, TRAIN_SEED = "granite-moe-3b-a800m", 0   # phase 13
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 16, 4, 2048   # phases 6 and 11's shape
FLASH_JAX_TOL = 2e-2        # flash_jax against chunked, relative: bf16 scores
CKPT_LAYERS = 2             # the checkpoint leg's depth, at full width
DCN_TRAIN_STEPS, DCN_TRAIN_BATCH = 20, 8192
DCN_GRAD_TOL = 1e-5         # the scatter-add's atomics reorder sums
SMOKE_TRAIN_TOL = 1e-4      # f32 smoke step, card against CPU
# The bucket's extraction through the host collector, before the batched
# backtracer (PERF.md §5, on an H100 at 700 W).
EXTRACTION_HOST_MS = 981.2
TIGHT = {"degree_cap": 1, "buffer": 3}   # backtrace caps that make stragglers
BLUK_TWIN_LANES = 2         # phase 14's "torch" twin: the bucket's first lanes
GNN_ARCHS = ("gat-cora", "gin-tu", "pna", "schnet")
GNN_HOME = {"gat-cora": "full_graph_sm", "gin-tu": "molecule",
            "pna": "molecule", "schnet": "molecule"}   # each arch's shape
GNN_SEED = 0
GNN_TOL = 1e-4              # f32 step, card against CPU (atomics reorder sums)
GNN_OPT = {"lr": 3e-3, "total_steps": 60, "warmup_steps": 5}  # gnn_train.py's
GNN_BF16_STEPS, GNN_OGB_STEPS, GNN_SAMPLE_STEPS = 16, 4, 8
# ogb_products, bf16 against f32 from the same weights and batch.  The
# gin-tu loss, relative: 0.0007 on the card (PERF.md §6); a mean over 2.45 M
# nodes, it averages per-node rounding away, so a wide margin still fails a
# fault that shifts every logit one way.
GNN_LOSS_BOUND = 0.01
# The logits' relative L2 gap, which does not average: 0.0084 (gin-tu) and
# 0.0050 (pna) on the card (PERF.md §6); over 115 M logits a reordering of
# the atomic sums moves it by a small part of itself.
GNN_LOGIT_BOUND = 0.02
FLASH_SHAPES = (            # b, sq, skv, hq, hkv, dh, q_offset
    (1, 128, 128, 4, 4, 64, 0),       # MHA
    (2, 256, 256, 4, 2, 64, 0),       # GQA g=2
    (1, 128, 384, 8, 1, 128, 0),      # MQA, longer kv
    (2, 100, 100, 4, 4, 64, 0),       # lengths not a tile multiple
    (2, 8, 64, 4, 4, 64, 37),         # decode offset
    (1, 200, 200, 32, 2, 128, 0),     # ChatGLM3's GQA, g=16
    (2, 33, 33, 4, 2, 16, 0),         # the smoke configs' head dim
)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


def host_s(fn) -> float:
    """Host seconds of one call of ``fn`` ended by a synchronize, after a
    warm-up call: at least the time the host takes to queue it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def hold_device(seconds: float) -> None:
    """Queue a spin kernel of at least ``seconds`` (capped at 2 s), so the
    device waits while the host queues what follows."""
    torch.cuda._sleep(int(min(seconds, 2.0) * SPIN_CYCLES_PER_S))


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events, after
    a warm-up call.  A spin kernel queued ahead of the first event holds the
    device until the host has queued every call, so the host's time between
    launches stays off the clock."""
    hold_device(2 * iters * host_s(fn) + 1e-3)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def cold_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` with a cold L2: before each call a
    buffer of ``L2_FLUSH_BYTES`` is written, and each call is timed by its
    own pair of CUDA events, queued behind a spin kernel as in ``cuda_ms``."""
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device="cuda")
    hold = 2 * host_s(fn) + 1e-3
    total = 0.0
    for _ in range(iters):
        flush.fill_(1.0)
        hold_device(hold)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize()
        total += t0.elapsed_time(t1)
    return total / iters


def once_ms(fn) -> float:
    """Device time of one more call of ``fn`` (already run once), by CUDA
    events: for the plain versions at bluk-bnb's shape, whose call takes
    seconds and syncs with the host between its chunks."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def elementwise_room(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / (tol + tol |want|) at tol = ``LM_TOL``: at most 1
    where an element-wise atol = rtol = ``LM_TOL`` check would pass."""
    return float(((got - want).abs() / (LM_TOL + LM_TOL * want.abs())).max())


def sorted_unique_tables(shape, m, k, seed, device):
    """Random lattice tables f32[*shape, 2^m, K]: sorted, distinct,
    INF-padded, with the empty keyword-set all INF."""
    from repro_torch import INF
    from repro_torch.core.semiring import sorted_unique_k

    rng = np.random.default_rng(seed)
    s = rng.integers(1, 20, size=(*shape, 1 << m, k)).astype(np.float32)
    s[rng.random(s.shape) > 0.5] = INF
    t = sorted_unique_k(torch.from_numpy(s).to(device), k)
    t[..., 0, :] = INF
    return t.contiguous()


def hops_within(graph, start: int, depth: int | None = None) -> np.ndarray:
    """int[V]: hop distance from ``start`` over finite-weight edges (host
    BFS over the CSR); -1 for nodes it does not reach within ``depth``
    hops (no limit when None)."""
    from repro_torch import INF

    dist = np.full(graph.n_nodes, -1, np.int64)
    dist[start] = 0
    front = np.array([start])
    deg = np.diff(graph.indptr)
    d = 0
    while front.size and (depth is None or d < depth):
        d += 1
        counts = deg[front]
        idx = np.repeat(graph.indptr[front] - np.cumsum(counts) + counts,
                        counts) + np.arange(counts.sum())
        nbr = graph.indices[idx][graph.ew[idx] < INF]
        front = np.unique(nbr[dist[nbr] < 0])
        dist[front] = d
    return dist


def draw_queries(graph, index, n: int, m: int, rng) -> list[list[int]]:
    """``n`` queries of ``m`` distinct tokens, each token of moderate
    document frequency (2..200) and carried by a node of the component of
    the node with the most finite-weight edges, so that answers exist."""
    from repro_torch import INF

    finite_deg = np.bincount(
        np.repeat(np.arange(graph.n_nodes), np.diff(graph.indptr))[
            graph.ew < INF], minlength=graph.n_nodes)
    comp = hops_within(graph, int(np.argmax(finite_deg))) >= 0
    pool = sorted(t for t, d in index.token_dfs()
                  if 2 <= d <= 200 and comp[index.lookup(t)].any())
    check(len(pool) >= n * m, f"only {len(pool)} query tokens")
    picks = rng.choice(len(pool), size=(n, m), replace=False)
    return [[int(pool[j]) for j in row] for row in picks]


def lane_bound(S0, changed, done, offsets, src, w) -> tuple[float, str]:
    """Least time for one fused superstep on these inputs: the bytes it
    must move (every lane's own table read once and written once — the rows
    senders pass on are bytes of that same table —, ``w`` of every real
    in-edge, ``src`` of the finite-weight ones, the flags and the offsets)
    over HBM bandwidth, against its adds and compares (one of each per
    candidate of a live lane's finite in-edge from an active sender) over
    the f32 rate."""
    lanes, v, f, k = S0.shape
    n_e = int(offsets[-1])
    finite = w[:n_e] < 5e8
    n_rows = int(changed[~done][:, src[:n_e].long()[finite]].sum())
    nbytes = (2 * S0.numel() * 4 + 4 * n_e + 4 * int(finite.sum())
              + lanes * v + (v + 1) * 8 + lanes)
    return _bound(nbytes, 2 * n_rows * f * k)


def edge_subset(dg, keep):
    """(offsets, src, w) of the real edges where ``keep`` holds, still
    sorted by destination."""
    n_e = dg.n_edges
    offsets = torch.zeros(dg.v_pad + 1, dtype=torch.int64, device=dg.device)
    offsets[1:] = torch.cumsum(torch.bincount(
        dg.dst[:n_e][keep].long(), minlength=dg.v_pad), 0)
    return (offsets, dg.src[:n_e][keep].contiguous(),
            dg.w[:n_e][keep].contiguous())


def lane_breakdown(dg, S0, changed, done, m, full_out, fused, hub_nodes,
                   heavy=32, huge=256):
    """Where ``lane_superstep``'s time goes on the main path's state: the
    kernel timed on cut edge lists and flags, each cut with the hub list
    ``hub_nodes`` builds for its offsets, beside the in-degree figures that
    each cut speaks to.  Cuts: INF-weight (hub) edges dropped, which
    leaves the output as it was (checked); then also the in-edges of nodes
    with more than ``huge``, or more than ``heavy``, finite in-edges
    dropped; then no sender active (only the tables' stream, the merge and
    the combine sweep)."""
    n_e = dg.n_edges
    finite = dg.w[:n_e] < 5e8
    dst = dg.dst[:n_e].long()
    fin_deg = torch.bincount(dst[finite], minlength=dg.v_pad)
    light = finite & (fin_deg[dst] <= heavy)
    cut_fin = edge_subset(dg, finite)
    cut_fin = (*cut_fin, hub_nodes(cut_fin[0]))
    check(torch.equal(fused(S0, changed, done, *cut_fin[:3], m, cut_fin[3]),
                      full_out),
          "lane_superstep without INF-weight edges changed its output")
    cut_light = edge_subset(dg, light)
    cut_light = (*cut_light, hub_nodes(cut_light[0]))
    cut_big = edge_subset(dg, finite & (fin_deg[dst] <= huge))
    cut_big = (*cut_big, hub_nodes(cut_big[0]))
    idle = torch.zeros_like(changed)

    def timed(flags, cut):
        return cuda_ms(lambda: fused(S0, flags, done, *cut[:3], m, cut[3]),
                       10)

    ms = {"all edges": timed(changed, (dg.in_offsets, dg.src, dg.w,
                                       dg.hub_nodes)),
          "finite-weight edges only": timed(changed, cut_fin),
          f"finite edges into nodes of finite in-degree <= {huge} only":
              timed(changed, cut_big),
          f"finite edges into nodes of finite in-degree <= {heavy} only":
              timed(changed, cut_light),
          "finite edges, no sender active": timed(idle, cut_fin)}
    # Per (live lane, node): the rows gathered for it; a hub's rows are
    # shared by the 32 lanes of its warp.
    live = (~done).nonzero().flatten()
    senders = changed[live][:, dg.src[:n_e].long()] & finite
    chain = torch.stack([torch.bincount(dst[s], minlength=dg.v_pad)
                         for s in senders])
    deg = dg.in_offsets.diff()
    is_hub = torch.zeros(dg.v_pad, dtype=torch.bool, device=dg.device)
    is_hub[dg.hub_nodes.long()] = True
    per_thread = torch.where(is_hub, (chain + 31) // 32, chain)
    n_heavy = int((fin_deg > heavy).sum())
    return ms, {
        "max in-degree": int(deg.max()),
        "hubs (in-degree > HUB_IN_DEGREE, one warp per lane and hub)":
            int(dg.hub_nodes.numel()),
        "nodes with an INF-weight in-edge": int(torch.bincount(
            dst[~finite], minlength=dg.v_pad).gt(0).sum()),
        "INF-weight edges": int((~finite).sum()),
        "max finite in-degree": int(fin_deg.max()),
        f"nodes of finite in-degree > {heavy}": n_heavy,
        "their share of finite edges": float(
            fin_deg[fin_deg > heavy].sum() / fin_deg.sum()),
        "gathered rows (live lane, finite edge, active sender)":
            int(chain.sum()),
        "longest gather chain of one (lane, node)": int(chain.max()),
        "longest gather chain of one thread, hub rows over 32 lanes":
            int(per_thread.max()),
        f"share of gathered rows into nodes of finite in-degree > {heavy}":
            float(chain[:, fin_deg > heavy].sum() / chain.sum()),
    }


def extraction_parts(bt, S, kw, lanes, n_nodes) -> dict:
    """One more ``extract_lanes`` of the bucket, its host side split: the
    stragglers' host searches (the top-level ``backtrace`` calls, row
    fetches included), the rows of lane tables fetched for them, and
    ``finish_tree``; with the straggler counts (records failed in the
    window, scan positions past it)."""
    from repro_torch.answers import batched as bt_mod
    from repro_torch.core import reconstruct as rc_mod

    spent = {"stragglers' host backtrace": 0.0, "row fetches": 0.0,
             "finish_tree": 0.0}

    def timed(name, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[name] += time.perf_counter() - t0
        return run

    saved = (bt_mod.backtrace, rc_mod.finish_tree, bt_mod.LaneRows.rows)
    bt_mod.backtrace = timed("stragglers' host backtrace", bt_mod.backtrace)
    rc_mod.finish_tree = timed("finish_tree", rc_mod.finish_tree)
    bt_mod.LaneRows.rows = timed("row fetches", bt_mod.LaneRows.rows)
    before = (bt.host_fallbacks, bt.table_copies, bt.rows_fetched)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bt.extract_lanes(S, kw, k=BUCKET_K, lanes=lanes, n_nodes=n_nodes)
        total = time.perf_counter() - t0
    finally:
        bt_mod.backtrace, rc_mod.finish_tree, bt_mod.LaneRows.rows = saved
    recs = bt.backtrace_lanes(S, kw, BUCKET_K)
    out = {"extract_lanes ms": total * 1e3}
    out.update({f"{name} ms": x * 1e3 for name, x in spent.items()})
    out["stragglers"] = bt.host_fallbacks - before[0]
    out["of them failed walks in the window, per lane"] = \
        recs.fail.sum(axis=1).tolist()
    out["lane tables copied"] = bt.table_copies - before[1]
    out["rows fetched"] = bt.rows_fetched - before[2]
    return out


def held_records(got: dict, want: dict, what: str) -> float:
    """Max abs difference over the backtrace's record arrays; fails unless
    every array is equal."""
    err = max(max_abs_err(got[n].int(), want[n].int()) for n in want)
    for name in want:
        check(torch.equal(got[name], want[name]),
              f"batched_backtrace {name} != plain at {what} (max abs err "
              f"{err})")
    return err


def backtrace_bound(recs: dict, m: int) -> tuple[float, str]:
    """A floor on the walk's bytes for these records: every record array
    written once and the candidates read once, plus, per obligation it
    resolved, what its match reads at the least — m mask bytes for a leaf,
    two table cells for a split, the node's two offsets, one CSR entry
    and one cell for an edge.  The scan items tested before each first
    match are left out, so the true least time is higher."""
    kind = recs["kind"]
    lanes, c, b = kind.shape
    nbytes = (5 * kind.numel() * 4 + lanes * c + lanes * c * 8
              + int((kind == 1).sum()) * m + int((kind == 2).sum()) * 8
              + int((kind == 3).sum()) * (16 + 8 + 4))
    return _bound(nbytes, 0)


def combine_bound(S, m) -> tuple[float, str]:
    from repro_torch.core.spa import split_pairs

    k = S.shape[-1]
    rows = S.numel() // ((1 << m) * k)
    return _bound(2 * S.numel() * 4, rows * len(split_pairs(m)) * k * k * 2)


def flash_flops(q, k, q_offset: int = 0) -> int:
    """4·Dh FLOPs per visible (query, key) pair and query head: the two
    matrix products of causal attention forward."""
    b, sq, hq, dh = q.shape
    pos = q_offset + np.arange(sq)
    return 4 * b * hq * dh * int(np.minimum(k.shape[1], pos + 1).sum())


def flash_bound(q, k, q_offset: int = 0) -> tuple[float, str]:
    """Least time for causal attention forward on these inputs: its FLOPs
    over the dense bf16 rate, against q, k, v read once and o written
    once."""
    nbytes = q.element_size() * 2 * (q.numel() + k.numel())
    return _bound(nbytes, flash_flops(q, k, q_offset), BF16_OPS_PER_S)


def bag_work(table, ids, weighted: bool) -> tuple[int, int]:
    """Bytes and operations of one EmbeddingBag call on these inputs: each
    distinct table row that a valid id names read once (a row named again
    can come from the cache), the ids, the weights and the output, against
    a multiply and an add per gathered element."""
    v, d = table.shape
    valid = (ids >= 0) & (ids < v)
    n_rows = int(torch.unique(ids[valid]).numel())
    nbytes = (n_rows * d + ids.numel() * (2 if weighted else 1)
              + ids.shape[0] * d) * 4
    return nbytes, 2 * int(valid.sum()) * d


def bag_bound(table, ids, weighted: bool) -> tuple[float, str]:
    """Least time for one EmbeddingBag call on these inputs (``bag_work``
    over HBM bandwidth and the f32 rate)."""
    return _bound(*bag_work(table, ids, weighted))


def grouped_bound(tables, ids, prefix=None) -> tuple[float, str]:
    """Least time for one grouped lookup with clipped ids: ``bag_work`` of
    each field's bags of one id, summed over the fields, and the prefix
    columns read once and written once."""
    work = [bag_work(t, ids[:, f:f + 1].clamp(0, t.shape[0] - 1), False)
            for f, t in enumerate(tables)]
    nbytes = sum(w[0] for w in work)
    if prefix is not None:
        nbytes += 2 * prefix.numel() * 4
    return _bound(nbytes, sum(w[1] for w in work))


def _bound(nbytes: float, ops: float,
           ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def same_results(rc, rt, what: str) -> None:
    """Every field the two backends must agree on, exactly."""
    np.testing.assert_array_equal(rc.weights, rt.weights, err_msg=what)
    np.testing.assert_array_equal(rc.roots, rt.roots, err_msg=what)
    for f in ("supersteps", "msgs_bfs", "msgs_deep", "done", "capped",
              "budget_hit", "explored_frac"):
        check(getattr(rc, f) == getattr(rt, f),
              f"{what}: {f} {getattr(rc, f)} != {getattr(rt, f)}")
    trees = [[(a.root, a.edges, a.weight) for a in r.answers]
             for r in (rc, rt)]
    check(trees[0] == trees[1], f"{what}: answer trees differ")


def flash_phase(dev) -> tuple[float, tuple]:
    """The flash kernel against its plain version at small shapes and at
    the main path's prefill shape; returns (max abs err, (ms, plain ms,
    SDPA ms, bound ms, bound by)) at the main path's shape."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    err = 0.0
    g = torch.Generator(dev).manual_seed(1)

    def qkv(b, sq, skv, hq, hkv, dh, dtype):
        return (torch.randn(b, s, h, dh, generator=g, device=dev).to(dtype)
                for s, h in ((sq, hq), (skv, hkv), (skv, hkv)))

    def held(q, k, v, q_offset, what):
        nonlocal err
        got = fa_ops.flash_attention(q, k, v, q_offset=q_offset)
        want = attention_ref(q, k, v, q_offset=q_offset)
        err = max(err, max_abs_err(got.float(), want.float()))
        tol = FLASH_TOL[q.dtype]
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol, msg=lambda m: f"{what}: {m}")

    for shape in FLASH_SHAPES:
        for dtype in FLASH_TOL:
            held(*qkv(*shape[:-1], dtype), shape[-1], f"{shape} {dtype}")
    cfg = get_arch(LM_ARCH)
    q, k, v = qkv(LM_BATCH, LM_PROMPT, LM_PROMPT, cfg.n_heads, cfg.n_kv_heads,
                  cfg.head_dim, torch.bfloat16)
    held(q, k, v, 0, "main path shape")
    return err, time_flash(q, k, v)


def time_flash(q, k, v) -> tuple:
    """The flash kernel at one shape beside its plain version and
    ``scaled_dot_product_attention``: (ms, plain ms, SDPA ms, bound ms,
    bound by)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    torch.cuda.synchronize()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    times = (cuda_ms(lambda: fa_ops.flash_attention(q, k, v), 20),
             cuda_ms(lambda: attention_ref(q, k, v), 3),
             cuda_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                  enable_gqa=True), 20),
             *flash_bound(q, k))
    flops = flash_flops(q, k)
    log(f"  flash_attention at q {list(q.shape)}, k/v {list(k.shape)} bf16, "
        f"route {fa_ops.route(q.dtype, q.shape[-1])}: {times[0]} ms, "
        f"{flops / times[0] / 1e9:.1f} TFLOP/s, {100 * times[3] / times[0]:.1f} "
        f"% of the bound (plain {times[1]} ms, SDPA {times[2]} ms = "
        f"{flops / times[2] / 1e9:.1f} TFLOP/s, bound {times[3]} ms by "
        f"{times[4]})")
    return times


def lm_phase(dev) -> int:
    """ChatGLM3-6B serving through ``repro_torch.launch.serve.generate``:
    returns the flash kernel's launches on the main path."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import lm as lm_lib

    cfg = get_arch(LM_ARCH)
    gen = torch.Generator(dev).manual_seed(LM_SEED)
    model = lm_init(cfg, gen)
    requests = (torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                              generator=gen, device=dev),
                torch.randint(0, cfg.vocab, (1, LM_LONG), generator=gen,
                              device=dev))
    for p in requests:       # warm-up: cuBLAS picks its kernels per shape
        serve.generate(model, p, 2)
    prefill, naive = (lm_lib.make_prefill_step(i) for i in ("cuda", "naive"))
    total = 0
    for p in requests:
        total += serve_held(model, p, LM_GEN, prefill, naive)
    device_split(model, requests[0], prefill, lm_lib.make_decode_step())
    return total


def serve_held(model, p, gen: int, prefill, naive, twin=None) -> int:
    """One request through ``repro_torch.launch.serve.generate``: a prefill
    through the flash kernel (its counters set to 0 just before and read
    just after: one ``"wgmma"`` launch per layer) and ``gen`` greedy decode
    steps.  The prefill's last logits and the first token, then the served
    tokens fed back through the KV cache, are held against naive attention
    within ``LM_TOL`` x max |logit|.  A MoE model's decode is held on
    ``twin`` (``no_drop_twin``): a prefill of more tokens drops other
    assignments, so only a model that drops none decodes as it prefills.
    Returns the launches."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch import serve
    from repro_torch.models import lm as lm_lib

    cfg = model.cfg
    vocab = cfg.vocab
    torch.cuda.reset_peak_memory_stats()
    for c in (fa_ops.counter, *fa_ops.route_counters.values()):
        c.reset()
    res = serve.generate(model, p, gen, attn_impl="cuda")
    launched = fa_ops.launches
    by_route = dict(fa_ops.launches_by_route)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(launched == cfg.n_layers, f"flash_attention launched "
          f"{launched} times in one prefill, want {cfg.n_layers}")
    check(by_route == {"wgmma": cfg.n_layers, "wmma": 0},
          f"flash_attention launches by route {by_route}, want all "
          f"{cfg.n_layers} on wgmma")
    bsz, s = p.shape
    check(res.tokens.shape == (bsz, gen + 1)
          and bool(((res.tokens >= 0) & (res.tokens < vocab)).all())
          and bool(res.logits_last.isfinite().all()),
          "generated tokens or logits out of range")
    # Prefill: the kernel against naive attention.
    t0 = time.perf_counter()
    want, _ = naive(model, p)
    torch.cuda.synchronize()
    naive_ms = (time.perf_counter() - t0) * 1e3
    diff = max_abs_err(res.logits_last, want)
    room = elementwise_room(res.logits_last, want)
    top = float(want.abs().max())
    check(diff <= LM_TOL * top, f"prefill logits differ by {diff}, "
                                f"limit {LM_TOL} x {top}")
    top2 = want[:, :vocab].topk(2).values
    sure = (top2[:, 0] - top2[:, 1]) > diff
    check(torch.equal(res.tokens[sure, 0], want[sure, :vocab].argmax(-1)),
          "first greedy token differs from naive attention's")
    # Decode: the served tokens fed back through the cache, step by
    # step; the last step's logits against a naive prefill of the
    # prompt and every token before the last.
    ref = twin or model
    _, cache = prefill(ref, p)
    cache = lm_lib.grow_cache(cfg, cache, s + gen)
    with torch.no_grad():
        for t in range(gen):
            step, cache = ref.decode_step(cache, res.tokens[:, t:t + 1])
    full, _ = naive(ref, torch.cat([p, res.tokens[:, :-1]], dim=1))
    ddiff = max_abs_err(step[:, -1], full)
    droom = elementwise_room(step[:, -1], full)
    dtop = float(full.abs().max())
    check(ddiff <= LM_TOL * dtop, f"decode logits differ by {ddiff} "
                                  f"from a naive prefill, limit "
                                  f"{LM_TOL} x {dtop}")
    n = bsz * s
    log(f"  {bsz} x {s} tokens: prefill {res.prefill_ms:.2f} ms "
        f"({n / res.prefill_ms * 1e3:.0f} tokens/s; naive attention "
        f"{naive_ms:.2f} ms), decode {res.decode_ms_per_step:.3f} ms per "
        f"step over {res.steps} steps ({res.steps * bsz / res.decode_ms * 1e3:.1f} "
        f"tokens/s), peak device memory {peak:.2f} GiB")
    log(f"    prefill: max |logits_last| {top:.4f}, max |kernel - naive| "
        f"{diff:.6f} (element-wise {room:.4f}), first token checked in "
        f"{int(sure.sum())} of {bsz} rows; decode step {gen}"
        f"{' (no-drop twin)' if twin is not None else ''}: max "
        f"|logits| {dtop:.4f}, max |decode - naive prefill| {ddiff:.6f} "
        f"(element-wise {droom:.4f})")
    return launched


def no_drop_twin(model):
    """``model``'s weights, shared, under its config with the experts'
    capacity factor raised to E / k, the least at which no assignment can
    drop (capacity >= the token count).  ``repro``'s own prefill/decode
    consistency test raises it the same way
    (``tests/test_models_smoke.py``)."""
    from repro_torch.models import transformer as tfm

    cfg = model.cfg
    spec = cfg.moe
    twin = tfm.LM(cfg.scaled(moe=dataclasses.replace(
        spec, capacity_factor=spec.n_experts / spec.top_k)),
        device="meta", dtype=model.embed.dtype)
    twin.load_state_dict(model.state_dict(), assign=True)
    return twin


def device_split(model, prompts, prefill, decode) -> None:
    """Where a prefill's and a decode step's time goes on the card:
    torch.profiler's kernel times against the host clock (profiled, so the
    host side runs slower than unprofiled)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import lm as lm_lib

    steps = 4
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof_p:
        t0 = time.perf_counter()
        logits, cache = prefill(model, prompts)
        torch.cuda.synchronize()
        wall_p = (time.perf_counter() - t0) * 1e3
    cache = lm_lib.grow_cache(model.cfg, cache, prompts.shape[1] + steps)
    tok = logits.argmax(-1)[:, None]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof_d:
        t0 = time.perf_counter()
        for _ in range(steps):
            tok, cache = decode(model, cache, tok)
        torch.cuda.synchronize()
        wall_d = (time.perf_counter() - t0) * 1e3 / steps
    for what, prof, wall, per in (("prefill", prof_p, wall_p, 1),
                                  ("decode step", prof_d, wall_d, steps)):
        kernels = sorted((e for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA),
                         key=lambda e: -e.self_device_time_total)
        busy = sum(e.self_device_time_total for e in kernels) / 1e3 / per
        if busy == 0:
            log(f"  {what}: device time not measured (the profiler saw no "
                f"kernel)")
            continue
        top = "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / per:.3f} "
                        f"ms x{e.count // per}" for e in kernels[:6])
        log(f"  {what} under torch.profiler: kernels busy {busy:.3f} ms of "
            f"{wall:.3f} ms wall ({100 * busy / wall:.1f} %), "
            f"{sum(e.count for e in kernels) // per} kernel launches; top: "
            f"{top}")


def router_stats(model, p, what: str) -> float:
    """One prefill of ``p`` with each MoE layer's aux recorded by a forward
    hook: prints the forward's aux (means over layers) and each layer's
    ``dropped_frac`` and ``load_balance``; returns the largest drop."""
    per_layer = []
    hooks = [layer.moe.register_forward_hook(
        lambda mod, args, out: per_layer.append(out[1]))
        for layer in model.layers]
    try:
        with torch.no_grad():
            _, _, aux = model(p, attn_impl="cuda")
    finally:
        for h in hooks:
            h.remove()
    dropped = [round(float(a["dropped_frac"]), 5) for a in per_layer]
    balance = [round(float(a["load_balance"]), 4) for a in per_layer]
    for name, value in aux.items():
        check(bool(torch.isfinite(value)), f"{what}: aux {name} {value}")
    log(f"    {what} router, {p.shape[0]} x {p.shape[1]} tokens (capacity "
        f"factor {model.cfg.moe.capacity_factor}): forward aux load_balance "
        f"{float(aux['load_balance']):.4f}, router_z "
        f"{float(aux['router_z']):.4f}; per layer dropped_frac {dropped}; "
        f"load_balance {balance}")
    return max(dropped)


def quant_held(got, want, what: str) -> tuple[float, float, int, int]:
    """Each step's int8-cache logits against the bf16-cache decode's within
    atol = rtol = ``QUANT_TOL``, and the greedy token equal wherever the
    bf16 decode's top-2 margin exceeds twice the row's largest difference
    (past that no difference can reorder the two).  Returns (the
    element-wise reading, max |d|, rows whose token was checked, rows)."""
    room, diff, checked, rows = 0.0, 0.0, 0, 0
    for t, (g, w) in enumerate(zip(got, want)):
        d = (g - w).abs()
        room = max(room, float((d / (QUANT_TOL + QUANT_TOL * w.abs())).max()))
        diff = max(diff, float(d.max()))
        top2 = w.topk(2).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * d.max(dim=-1).values
        check(torch.equal(g[sure].argmax(-1), w[sure].argmax(-1)),
              f"{what}: greedy token differs at step {t}")
        checked += int(sure.sum())
        rows += sure.numel()
    check(room <= 1, f"{what}: logits past atol = rtol = {QUANT_TOL} of the "
                     f"bf16-cache decode (element-wise {room})")
    return room, diff, checked, rows


def decode_timed(step, cache, feed) -> tuple[list, dict, float]:
    """``step(cache, tok)`` over the tokens ``feed``: (each step's last
    logits, the cache, host ms per step ended by a synchronize)."""
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for tok in feed:
            logits, cache = step(cache, tok)
            out.append(logits[:, -1])
    torch.cuda.synchronize()
    return out, cache, (time.perf_counter() - t0) * 1e3 / len(feed)


def greedy_feed(model, cache, tok, steps: int) -> tuple[list, list, dict,
                                                        float]:
    """``steps`` greedy bf16-cache decode steps from ``tok``: (the tokens
    fed, each step's logits, the cache, ms per step)."""
    fed, want = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        for _ in range(steps):
            fed.append(tok)
            logits, cache = model.decode_step(cache, tok)
            want.append(logits[:, -1])
            tok = logits[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    fed.append(tok)
    return fed, want, cache, (time.perf_counter() - t0) * 1e3 / steps


def int8_leg(model, p) -> dict:
    """The int8 KV cache on the served model: the prefill's K/V through
    ``quantize_kv`` into a cache of ``QUANT_SEQ`` positions, then
    ``LM_GEN`` ``decode_step_quant`` steps fed the bf16-cache decode's
    greedy tokens and held against its logits; then both caches grown to
    ``QUANT_LONG`` positions and ``QUANT_LONG_STEPS`` steps of each timed
    and held there."""
    from repro_torch.models import kvcache
    from repro_torch.models import lm as lm_lib

    cfg = model.cfg
    bsz, s = p.shape
    names = ("k_q", "k_s", "v_q", "v_s")
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        logits, cache = lm_lib.make_prefill_step("cuda")(model, p)
        cq = kvcache.init_cache_quant(cfg, bsz, QUANT_SEQ, device=p.device)
        for src in ("k", "v"):
            cq[f"{src}_q"][:, :, :s], cq[f"{src}_s"][:, :, :s] = \
                kvcache.quantize_kv(cache[src])
        cq["pos"] = s
        cb = lm_lib.grow_cache(cfg, cache, QUANT_SEQ)
        del cache
    tok = logits.argmax(-1)[:, None]
    fed, want, cb, ms_b = greedy_feed(model, cb, tok, LM_GEN)
    got, cq, ms_q = decode_timed(model.decode_step_quant, cq, fed[:-1])
    short = quant_held(got, want, f"int8 decode at {QUANT_SEQ}")
    log(f"  int8 cache, {bsz} x {s} prefill quantized into {QUANT_SEQ} "
        f"positions, {LM_GEN} steps teacher-forced by the bf16-cache "
        f"decode: bf16 cache {ms_b:.3f} ms per step, int8 {ms_q:.3f} ms; "
        f"max |int8 - bf16| {short[1]:.6f} (element-wise {short[0]:.4f} of "
        f"atol = rtol = {QUANT_TOL}), greedy token checked in {short[2]} of "
        f"{short[3]} rows")
    # Both caches grown to decode_32k's length: each step reads all of it.
    cb = lm_lib.grow_cache(cfg, cb, QUANT_LONG)
    big = kvcache.init_cache_quant(cfg, bsz, QUANT_LONG, device=p.device)
    for n in names:
        big[n][:, :, :QUANT_SEQ] = cq[n]
    big["pos"] = cq["pos"]
    cq = big
    del big
    torch.cuda.empty_cache()
    bytes_b = sum(cb[n].numel() * cb[n].element_size() for n in ("k", "v"))
    bytes_q = sum(cq[n].numel() * cq[n].element_size() for n in names)
    fed, want, cb, ms_b32 = greedy_feed(model, cb, fed[-1], QUANT_LONG_STEPS)
    got, cq, ms_q32 = decode_timed(model.decode_step_quant, cq, fed[:-1])
    long = quant_held(got, want, f"int8 decode at {QUANT_LONG}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"  at {QUANT_LONG} positions (decode_32k's length, batch {bsz}), "
        f"{QUANT_LONG_STEPS} steps from position {cq['pos'] - QUANT_LONG_STEPS}"
        f": bf16 cache {bytes_b} bytes, {ms_b32:.3f} ms per step "
        f"({bsz / ms_b32 * 1e3:.1f} tokens/s; reading the cache once takes "
        f"{bytes_b / HBM_BYTES_PER_S * 1e3:.3f} ms at {HBM_BYTES_PER_S:.3g} "
        f"B/s); int8 cache {bytes_q} bytes, {ms_q32:.3f} ms per step "
        f"({bsz / ms_q32 * 1e3:.1f} tokens/s; its read "
        f"{bytes_q / HBM_BYTES_PER_S * 1e3:.3f} ms); max |int8 - bf16| "
        f"{long[1]:.6f} (element-wise {long[0]:.4f}), greedy token checked "
        f"in {long[2]} of {long[3]} rows; peak device memory {peak:.2f} GiB")
    return {"ms_bf16": ms_b, "ms_int8": ms_q, "ms_bf16_32k": ms_b32,
            "ms_int8_32k": ms_q32, "bytes_bf16": bytes_b,
            "bytes_int8": bytes_q}


def lm_init(cfg, gen, what: str = ""):
    """``init_lm`` on the generator's card, its parameter count checked
    against the config's and logged."""
    from repro_torch.models import transformer as tfm

    t0 = time.perf_counter()
    model = tfm.init_lm(cfg, gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == cfg.param_count_analytic(),
          f"{n_params} parameters, config says {cfg.param_count_analytic()}")
    ffn = (f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k} of d_ff "
           f"{cfg.moe.d_ff_expert}, f32 router" if cfg.moe else
           f"d_ff {cfg.d_ff}")
    log(f"  {cfg.name}{what}: {n_params} parameters ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.n_heads} q / {cfg.n_kv_heads} kv heads, "
        f"head dim {cfg.head_dim}, {ffn}, vocab {cfg.vocab}), "
        f"{cfg.param_dtype}, random "
        f"from seed {LM_SEED}, drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    return model


def moe_phase(dev) -> dict:
    """Phase 11: the flash kernel at granite-moe-3b-a800m's prefill shape;
    granite at full width and depth served through ``serve.generate`` (the
    flash launches counted per prefill); the int8 cache on it; dbrx-132b
    and command-r-plus-104b at full width and cut depth.  Returns the
    flash kernel's launches on the MoE path and at cut depth, its error
    and its times at granite's shape."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.launch import serve
    from repro_torch.models import lm as lm_lib

    t_phase = time.perf_counter()
    cfg = get_arch(MOE_ARCH)
    gen = torch.Generator(dev).manual_seed(LM_SEED)
    q, k, v = (torch.randn(LM_BATCH, LM_PROMPT, h, cfg.head_dim,
                           generator=gen, device=dev).bfloat16()
               for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    got = fa_ops.flash_attention(q, k, v).float()
    want = attention_ref(q, k, v).float()
    err = max_abs_err(got, want)
    tol = FLASH_TOL[torch.bfloat16]
    torch.testing.assert_close(got, want, atol=tol, rtol=tol,
                               msg=lambda m: f"granite's shape: {m}")
    timing, shapes = time_flash(q, k, v), (list(q.shape), list(k.shape))
    del q, k, v, got, want

    model = lm_init(cfg, gen)
    requests = (torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                              generator=gen, device=dev),
                torch.randint(0, cfg.vocab, (1, LM_LONG), generator=gen,
                              device=dev))
    for p in requests:       # warm-up: cuBLAS picks its kernels per shape
        serve.generate(model, p, 2)
    prefill, naive = (lm_lib.make_prefill_step(i) for i in ("cuda", "naive"))
    twin = no_drop_twin(model)
    launches = 0
    for p in requests:
        launches += serve_held(model, p, LM_GEN, prefill, naive, twin)
        router_stats(model, p, cfg.name)
    device_split(model, requests[0], prefill, lm_lib.make_decode_step())
    quant = int8_leg(model, requests[0])
    del model, twin, requests
    gc.collect()
    torch.cuda.empty_cache()

    cut = {}
    for name, depth in CUT_DEPTH.items():
        full = get_arch(name)
        cut_cfg = full.scaled(n_layers=depth)
        gen = torch.Generator(dev).manual_seed(LM_SEED)
        model = lm_init(cut_cfg, gen, f" at full width, reduced: n_layers "
                                      f"{full.n_layers}→{depth}")
        log(f"    full depth: {full.param_count_analytic()} parameters, "
            f"{full.param_count_analytic() * 2 / 2**30:.1f} GiB in bf16, "
            f"more than one card holds")
        p = torch.randint(0, cut_cfg.vocab, (LM_BATCH, LM_PROMPT),
                          generator=gen, device=dev)
        serve.generate(model, p, 2)
        twin = no_drop_twin(model) if cut_cfg.moe is not None else None
        cut[name] = serve_held(model, p, CUT_GEN, prefill, naive, twin)
        if twin is not None:
            router_stats(model, p, f"{name} (cut depth)")
        del model, twin, p
        gc.collect()
        torch.cuda.empty_cache()
    log(f"  the phase took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "cut_launches": cut, "err": err,
            "timing": timing, "shapes": shapes, "quant": quant}


def bag_times(what: str, kernel, plain, library, bound: tuple[float, str],
              cold: bool = False) -> dict:
    """One timed shape of an EmbeddingBag kernel: its time, its plain
    version's, the library call's and the bound, with L2 warm (the same
    inputs call after call) or cold (``cold_ms``)."""
    timer = cold_ms if cold else cuda_ms
    row = {"shape": what, "l2": "cold" if cold else "warm",
           "ms": timer(kernel, 20), "plain_ms": timer(plain, 3),
           "library_ms": timer(library, 20), "bound_ms": bound[0],
           "bound_by": bound[1], "call_ms": 1e3 * host_s(kernel)}
    log(f"  embedding_bag {what}, {row['l2']} L2: {row['ms']} ms (plain "
        f"{row['plain_ms']} ms, library {row['library_ms']} ms, bound "
        f"{row['bound_ms']} ms by {row['bound_by']}, "
        f"{100 * row['bound_ms'] / row['ms']:.1f} % of it; one call on the "
        f"host clock {row['call_ms']} ms)")
    return row


def bag_phase(dev, table) -> tuple[float, list[dict]]:
    """The EmbeddingBag kernels against their plain versions: the multi-hot
    bag at random small shapes (within ``BAG_TOL``), the grouped lookup at
    random small shapes (exactly), and the multi-hot bag at one Zipf shape
    into ``table``, timed with L2 warm and cold; returns (max abs err, the
    two timed rows)."""
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.embedding_bag.ref import (
        embedding_bag_grouped_ref, embedding_bag_ref)

    err = 0.0
    rng = np.random.default_rng(3)

    def held(table, ids, w, mode, what):
        nonlocal err
        got = eb_ops.embedding_bag(table, ids, w, mode)
        want = embedding_bag_ref(table, ids, w, mode)
        err = max(err, max_abs_err(got, want))
        torch.testing.assert_close(got, want, atol=BAG_TOL, rtol=BAG_TOL,
                                   msg=lambda m: f"embedding_bag {what}: {m}")
        return got

    for b, nnz, d, mode, weighted in BAG_SHAPES:
        v = 5000
        small = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)
                                 ).to(dev)
        ids = rng.integers(-1, v + 2, size=(b, nnz)).astype(np.int32)
        ids[rng.random(ids.shape) < 0.3] = -1
        ids[0] = -1                                  # an all-pad bag
        w = (torch.from_numpy(rng.normal(size=(b, nnz)).astype(np.float32)
                              ).to(dev) if weighted else None)
        got = held(small, torch.from_numpy(ids).to(dev), w, mode,
                   f"{(b, nnz, d, mode, weighted)}")
        check(not got[0].any(), "an all-pad bag is not zero")
    for i, (b, f, d, col0, extra) in enumerate(GROUPED_SHAPES):
        tabs = [torch.from_numpy(rng.normal(size=(int(rows), d)).astype(
            np.float32)).to(dev) for rows in rng.integers(1, 3000, f)]
        ids = torch.from_numpy(np.stack(
            [rng.integers(-3, t.shape[0] + 3, b) for t in tabs],
            axis=1).astype(np.int32)).to(dev)
        out = torch.full((b, col0 + f * d + extra), 7.0, device=dev)
        prefix = (torch.from_numpy(rng.normal(size=(b, col0)).astype(
            np.float32)).to(dev) if i % 2 else None)
        want = embedding_bag_grouped_ref(tabs, ids, out.clone(), col0,
                                         i % 2 == 0, prefix)
        got = eb_ops.embedding_bag_grouped(tabs, ids, out, col0, i % 2 == 0,
                                           prefix)
        err = max(err, max_abs_err(got, want))
        check(torch.equal(got, want), f"embedding_bag_grouped != plain at "
                                      f"{(b, f, d, col0, extra)}")
    b, nnz, pad = BAG_TIMED
    ids = np.minimum(rng.zipf(1.3, (b, nnz)), table.shape[0]) - 1
    ids[rng.random(ids.shape) < pad] = -1
    ids = torch.from_numpy(ids.astype(np.int32)).to(dev)
    w = torch.from_numpy(rng.random((b, nnz)).astype(np.float32)).to(dev)
    got = held(table, ids, w, "sum", "multi-hot timed shape")
    torch.cuda.synchronize()
    # F.embedding_bag takes no padding id with per-sample weights: clamp the
    # pads to row 0 and give them weight 0.
    lib_ids, lib_w = ids.clamp(min=0).long(), w * (ids >= 0)
    emb_bag = torch.nn.functional.embedding_bag

    def library():
        return emb_bag(lib_ids, table, mode="sum", per_sample_weights=lib_w)

    torch.testing.assert_close(library(), got, atol=BAG_TOL, rtol=BAG_TOL)
    what = (f"multi-hot ids {list(ids.shape)} ({int((ids >= 0).sum())} "
            f"valid, {int(torch.unique(ids[ids >= 0]).numel())} distinct, "
            f"Zipf 1.3) into {list(table.shape)} f32, weighted sum")
    rows = [bag_times(what, lambda: eb_ops.embedding_bag(table, ids, w),
                      lambda: embedding_bag_ref(table, ids, w), library,
                      bag_bound(table, ids, True), cold=cold)
            for cold in (False, True)]
    return err, rows


def lookup_routes(params, cfg, batch) -> dict:
    """``batch``'s x0 under ``no_grad`` by two routes, interleaved call by
    call on the host clock: ``grouped_lookup``, which calls the grouped
    kernel alone when nothing needs a gradient, as serving does, and
    :class:`GroupedLookup`'s ``apply`` (a ctx and ``save_for_backward``
    per call).  Returns each route's median and p99 in ms; the two x0
    must be equal."""
    from repro_torch.models import recsys as rec

    tables = [params["tables"][f"table_{i}"] for i in range(cfg.n_sparse)]
    dense, sparse = batch["dense"], batch["sparse"]

    def alone():
        return rec.grouped_lookup(tables, sparse, prefix=dense)

    def autograd():
        return rec.GroupedLookup.apply(sparse, dense, cfg.n_dense, *tables)

    routes = {"alone": alone, "autograd": autograd}
    ms = {name: [] for name in routes}
    with torch.no_grad():
        check(torch.equal(alone(), autograd()),
              "x0 differs between the kernel alone and GroupedLookup")
        for _ in range(LOOKUP_ROUTE_REPS):
            for name, fn in routes.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ms[name].append((time.perf_counter() - t0) * 1e3)
    return {name: (float(np.median(x)), float(np.percentile(x, 99)))
            for name, x in ms.items()}


def recsys_phase(dev) -> tuple[float, list[dict], int]:
    """DCN-v2 serving at full width through the grouped EmbeddingBag
    kernel: returns (the kernels' max abs err, their timed rows, the
    first the grouped lookup at serve_bulk's shape, and their launches on
    the main path)."""
    from repro_torch.configs import RECSYS_SHAPES, get_arch
    from repro_torch.data import recsys_synthetic_stream
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.embedding_bag.ref import \
        embedding_bag_grouped_ref
    from repro_torch.models import recsys as rec

    check(not torch.backends.cuda.matmul.allow_tf32
          and torch.get_float32_matmul_precision() == "highest",
          "f32 matrix products must run at full f32 precision (TF32 is on)")
    cfg = get_arch(RECSYS_ARCH)
    gen = torch.Generator(dev).manual_seed(RECSYS_SEED)
    t0 = time.perf_counter()
    params = rec.init_dcn(cfg, gen)
    torch.cuda.synchronize()
    rows = sum(t.shape[0] for t in params["tables"].values())
    n_params = rows * cfg.embed_dim + sum(
        t.numel() for key in ("cross", "deep") for lw in params[key]
        for t in lw.values()) + params["logit"].numel() + params["item"].numel()
    log(f"  {cfg.name}: {cfg.n_sparse} tables, {rows} rows x {cfg.embed_dim} "
        f"f32, {n_params} parameters ({n_params * 4 / 2**30:.2f} GiB), random "
        f"from seed {RECSYS_SEED}, drawn on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    err, multi_hot = bag_phase(dev, params["tables"]["table_0"])

    shapes = {s.name: s for s in RECSYS_SHAPES}
    batches = {name: rec.batch_to_device(next(recsys_synthetic_stream(
        cfg, shapes[name].batch, seed=0)), dev)
        for name in ("serve_p99", "serve_bulk", "retrieval_cand")}
    n_cand = -(-shapes["retrieval_cand"].n_candidates // 512) * 512
    cand = torch.from_numpy(np.random.default_rng(CAND_SEED).integers(
        0, cfg.vocab_sizes[0], n_cand).astype(np.int32)).to(dev)

    def forward(batch, impl):
        return rec.dcn_forward(params, batch["dense"], batch["sparse"], cfg,
                               impl=impl)

    def retrieve(batch, impl):
        return rec.retrieval_scores(params, batch["dense"], batch["sparse"],
                                    cand, cfg, top_k=RETRIEVAL_TOP_K,
                                    impl=impl)

    requests = (("serve_p99", forward, 1),       # x0's 26 fields
                ("serve_bulk", forward, 1),
                ("retrieval_cand", retrieve, 2))  # and the candidates' rows
    for name, fn, _ in requests:          # warm-up: cuBLAS picks per shape
        for impl in ("cuda", "torch"):
            fn(batches[name], impl)
    torch.cuda.synchronize()
    served = {}
    eb_ops.counter.reset()
    for name, fn, per in requests:
        before = eb_ops.launches
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn(batches[name], "cuda")
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check(eb_ops.launches - before == per,
              f"{name}: embedding_bag launched {eb_ops.launches - before} "
              f"times, want {per}")
        served[name] = (out, ms, torch.cuda.max_memory_allocated() / 2**30)
    launches = eb_ops.launches
    for name, fn, _ in requests:
        out, ms, peak = served[name]
        t0 = time.perf_counter()
        plain = fn(batches[name], "torch")
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if name == "retrieval_cand":
            (scores, idx), (p_scores, p_idx) = out, plain
            check(torch.equal(scores, p_scores) and torch.equal(idx, p_idx),
                  "retrieval scores or positions differ from impl=torch")
            check(scores.shape == (1, RETRIEVAL_TOP_K)
                  and bool(scores.isfinite().all())
                  and bool((scores[0, 1:] <= scores[0, :-1]).all())
                  and bool(((idx >= 0) & (idx < n_cand)).all()),
                  "retrieval scores not finite, not descending or positions "
                  "out of range")
            n, unit = n_cand, "candidates/s"
        else:
            check(torch.equal(out, plain),
                  f"{name}: logits differ from impl=torch")
            check(out.shape == (shapes[name].batch,)
                  and bool(out.isfinite().all()), f"{name}: bad logits")
            n, unit = shapes[name].batch, "rows/s"
        again = []
        for _ in range(REQUEST_REPS):
            t0 = time.perf_counter()
            fn(batches[name], "cuda")
            torch.cuda.synchronize()
            again.append((time.perf_counter() - t0) * 1e3)
        med = float(np.median(again))
        log(f"  {name}: {ms:.3f} ms warm, then median {med:.3f} ms (min "
            f"{min(again):.3f}) of {REQUEST_REPS} more ({n / med * 1e3:.0f} "
            f"{unit}; impl=torch {plain_ms:.3f} ms), peak device memory "
            f"{peak:.2f} GiB, bit-equal to impl=torch")
    routes = lookup_routes(params, cfg, batches["serve_p99"])
    log("  serve_p99's x0 under no_grad, median / p99 of "
        f"{LOOKUP_ROUTE_REPS} calls each, interleaved: " + "; ".join(
            f"{name} {med:.4f} / {p99:.4f} ms"
            for name, (med, p99) in routes.items()))
    # The grouped kernel at each lookup of the main path, held against its
    # plain version and beside F.embedding, once per field (which leaves
    # out x0's dense columns, 13 of 429).
    tables = [params["tables"][f"table_{i}"] for i in range(cfg.n_sparse)]
    d0 = cfg.n_dense + cfg.n_sparse * cfg.embed_dim

    def grouped(what, tabs, ids, ld, col0, prefix):
        nonlocal err
        check(all(bool(((ids[:, f] >= 0) & (ids[:, f] < t.shape[0])).all())
                  for f, t in enumerate(tabs)),
              f"{what}: ids outside the tables (F.embedding would differ)")
        out = torch.zeros(ids.shape[0], ld, device=dev)
        want = embedding_bag_grouped_ref(tabs, ids, out.clone(), col0, True,
                                         prefix)
        got = eb_ops.embedding_bag_grouped(tabs, ids, out, col0, True,
                                           prefix)
        err = max(err, max_abs_err(got, want))
        check(torch.equal(got, want), f"embedding_bag_grouped != plain at "
                                      f"{what}")
        long_ids = [ids[:, f].long() for f in range(len(tabs))]
        emb = torch.nn.functional.embedding

        def library():
            return [emb(i, t) for i, t in zip(long_ids, tabs)]

        check(torch.equal(torch.cat(library(), dim=1),
                          got[:, col0:col0 + len(tabs) * tabs[0].shape[1]]),
              f"{what}: F.embedding differs from the grouped kernel")
        return bag_times(
            f"grouped {what}: ids {list(ids.shape)} into out "
            f"[{ids.shape[0]}, {ld}] from column {col0}"
            + ("" if prefix is None else ", prefix copied in"),
            lambda: eb_ops.embedding_bag_grouped(tabs, ids, out, col0, True,
                                                 prefix),
            lambda: embedding_bag_grouped_ref(tabs, ids, out, col0, True,
                                              prefix),
            library, grouped_bound(tabs, ids, prefix))

    timed = [grouped(f"{name} x0", tables, batches[name]["sparse"], d0,
                     cfg.n_dense, batches[name]["dense"])
             for name in ("serve_bulk", "serve_p99", "retrieval_cand")]
    timed.append(grouped("retrieval_cand candidates", tables[:1],
                         cand[:, None].contiguous(), cfg.embed_dim, 0, None))
    # Why the kernel copies the dense columns in: the same lookup with them
    # left to a copy_ of their own.
    bulk = batches["serve_bulk"]
    x0 = torch.empty(bulk["sparse"].shape[0], d0, device=dev)
    apart = (cuda_ms(lambda: eb_ops.embedding_bag_grouped(
        tables, bulk["sparse"], x0, cfg.n_dense, True), 20),
        cuda_ms(lambda: x0[:, :cfg.n_dense].copy_(bulk["dense"]), 20))
    log(f"  grouped serve_bulk x0 without the prefix: {apart[0]} ms, and the "
        f"dense columns' copy_ {apart[1]} ms")
    return err, timed + multi_hot, launches


def padded_phase(dev, graph, index, bucket) -> tuple[float, tuple, int]:
    """The padded-CSR relax on one lane of a real mid-run sec-rdfabout
    state: returns (``padded_topk``'s max abs err, its times, its launches
    on the main path)."""
    from repro_torch import INF
    from repro_torch.core import dks, driver
    from repro_torch.kernels.segment_minplus import ops as sm_ops
    from repro_torch.kernels.segment_minplus.ref import padded_topk_ref

    dg = graph.to_device(dev)
    masks = torch.from_numpy(np.stack([index.keyword_masks(
        q, graph.n_nodes, v_pad=dg.v_pad) for q in bucket])).to(dev)
    cfg = dks.DKSConfig(m=BUCKET_M, k=BUCKET_K)
    st = driver.lane_init(dg, masks, cfg)
    for _ in range(PADDED_STEPS):
        st = dks.superstep(dg, st, cfg)
    lane = int(st.changed.sum(dim=1).argmax())
    S, changed = st.S[lane].contiguous(), st.changed[lane].contiguous()
    del st
    n_e = dg.n_edges
    src, dst, w = (x[:n_e].cpu().numpy() for x in (dg.src, dg.dst, dg.w))
    t0 = time.perf_counter()
    csr = sm_ops.padded_csr_from_graph(src, dst, w, dg.n_nodes,
                                       dmax=PADDED_DMAX, device=dev)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    sm_ops.counter.reset()
    t0 = time.perf_counter()
    got = sm_ops.segment_minplus_padded(S, csr, changed, BUCKET_K, dg.v_pad)
    torch.cuda.synchronize()
    relax_ms = (time.perf_counter() - t0) * 1e3
    launches = sm_ops.launches
    check(launches == 1, f"padded_topk launched {launches} times in one "
                         f"segment_minplus_padded, want 1")
    cand = sm_ops.padded_candidates(S, csr, changed)
    red_plain = padded_topk_ref(cand, BUCKET_K)
    check(torch.equal(got, sm_ops.merge_virtual_rows(red_plain, csr,
                                                     dg.v_pad)),
          "segment_minplus_padded differs from its plain version")
    check(torch.equal(got, dks.relax(dg, S[None], changed[None], cfg)[0]),
          "segment_minplus_padded differs from core/dks.py::relax")
    check(bool((got < INF).any()), "the relaxed lane received nothing")
    red = sm_ops.padded_topk(cand, BUCKET_K)
    err = max_abs_err(red, red_plain)
    check(torch.equal(red, red_plain), f"padded_topk != plain at the main "
                                       f"path's shape (max abs err {err})")
    del red_plain
    times = (cuda_ms(lambda: sm_ops.padded_topk(cand, BUCKET_K), 20),
             cuda_ms(lambda: padded_topk_ref(cand, BUCKET_K), 3), None,
             *_bound((cand.numel() + red.numel()) * 4, cand.numel()))
    deg = np.bincount(dst, minlength=dg.n_nodes)
    log(f"  lane {lane} after {PADDED_STEPS} supersteps "
        f"({int(changed.sum())} senders): padded CSR at dmax={PADDED_DMAX} "
        f"built on the host in {build_ms:.1f} ms ({csr.n_virtual} virtual "
        f"rows, {int((deg > PADDED_DMAX).sum())} hubs split); "
        f"segment_minplus_padded {relax_ms:.2f} ms")
    log(f"  padded_topk at cand {list(cand.shape)} f32 -> "
        f"{list(red.shape)}: {times[0]} ms (plain {times[1]} ms, bound "
        f"{times[3]} ms by {times[4]})")
    return err, times, launches


def same_stream(got, want) -> None:
    """Two backends' stream updates, exactly."""
    check(len(got) == len(want), f"stream lengths {len(got)} != {len(want)}")
    for uc, ut in zip(got, want):
        check(np.array_equal(uc.weights, ut.weights)
              and np.array_equal(uc.roots, ut.roots),
              f"stream step {uc.step}: weights/roots differ")
        for f in ("step", "frontier", "msgs_bfs", "msgs_deep", "nu_full",
                  "spa", "opt_lower_bound", "sound_opt_lower_bound",
                  "spa_ratio", "done"):
            check(getattr(uc, f) == getattr(ut, f),
                  f"stream step {uc.step}: {f} {getattr(uc, f)} != "
                  f"{getattr(ut, f)}")


def serving_phase(graph, index, engines, bucket, singles) -> dict:
    """Phase 9: the serving path on ``"cuda"``, held against ``"torch"``.
    Returns the phase's launch counts and a one-line summary."""
    from repro_torch.engine import ExecutionPolicy, QueryEngine
    from repro_torch.kernels.batched_backtrace import ops as bt_ops
    from repro_torch.kernels.lane_superstep import ops as ls_ops
    from repro_torch.kernels.subset_combine import ops as sc_ops
    from repro_torch.launch.serve_dks import (check_smoke, serve_replay,
                                              verify_served)
    from repro_torch.serve import ServeConfig
    from repro_torch.serve.loadgen import make_trace

    eng_c, eng_t = engines["cuda"], engines["torch"]
    t_phase = time.perf_counter()

    # The load replay, in serve_dks --smoke's settings.  The launch counts
    # are the service's own: zeroed just before it starts, read just after
    # it stops.
    trace = make_trace(index, SERVE_REQUESTS, unique=SERVE_UNIQUE, k=1,
                       deadline_frac=SERVE_DEADLINE_FRAC,
                       deadline_ms=SERVE_DEADLINE_MS, seed=0)
    cfg = ServeConfig(max_batch=4, max_wait_ms=50.0, cache_size=256,
                      trace_seed=0)
    for ops in (sc_ops, ls_ops, bt_ops):
        ops.counter.reset()
    run = serve_replay(eng_c, trace, cfg, clients=SERVE_CLIENTS, smoke=True,
                       k=1, timeout=SERVE_TIMEOUT_S)
    launches = {"lane_superstep": ls_ops.launches,
                "subset_combine": sc_ops.launches,
                "batched_backtrace": bt_ops.launches}
    for name, n in launches.items():
        check(n > 0, f"{name} never launched by DKSService")
    summary = check_smoke(run["stats"], run["tree_check"],
                          SERVE_DEADLINE_FRAC)
    # Every exact served answer, bit for bit, against the direct engine on
    # both backends: "torch" holds the kernels at the replay's own shapes.
    n_exact, n_approx = verify_served(eng_c, trace, run["served"])
    check(verify_served(eng_t, trace, run["served"]) == (n_exact, n_approx),
          "served answers checked differently against cuda and torch")
    st = run["replay_stats"]
    lat = np.asarray([r.latency_ms for r in run["served"]])
    log(f"  replay: {len(trace)} requests ({SERVE_UNIQUE} unique, "
        f"{SERVE_CLIENTS} clients) in {run['replay_s']:.3f} s (the service "
        f"with its tree and /metrics checks {run['wall_s']:.3f} s): served "
        f"p50 {np.percentile(lat, 50):.3f} ms, p99 "
        f"{np.percentile(lat, 99):.3f} ms, {st.throughput_rps:.2f} "
        f"requests/s (first submit to last resolve); batch fill "
        f"{st.mean_batch_fill:.3f} over {st.batch_dispatches} dispatches, "
        f"deadline fill {st.mean_deadline_fill:.3f} over "
        f"{st.deadline_dispatches}; cache hit rate {st.cache_hit_rate:.3f} "
        f"({st.cache_hits} hits, {st.single_flight_hits} single-flight); "
        f"{n_exact} exact answers == engine.query on cuda and on torch, "
        f"{n_approx} approximate within their sound bounds")
    log(f"  {summary}")
    log(f"  launches by DKSService (replay, trees, scrape): {launches}")

    # The bucket of phase 5 as one deadline bucket, at 0 and never.
    for deadline_s in (0.0, 600.0):
        outs, secs = {}, {}
        for b, eng in (("cuda", eng_c), ("torch", eng_t)):
            t0 = time.perf_counter()
            outs[b] = eng.query_deadline_batch(bucket, k=BUCKET_K,
                                               deadline_s=deadline_s,
                                               keep_state=True)
            secs[b] = time.perf_counter() - t0
        for i, ((rc, ic), (rt, it)) in enumerate(zip(outs["cuda"],
                                                     outs["torch"])):
            same_results(rc, rt, f"deadline {deadline_s} lane {i}")
            check(ic == it, f"deadline {deadline_s} lane {i}: {ic} != {it}")
        info = outs["cuda"][0][1]
        check(info["interrupted"] == (deadline_s == 0.0),
              f"deadline {deadline_s}: interrupted {info['interrupted']}")
        lanes = [r.supersteps for r, _ in outs["cuda"]]
        # ExtractionOverlap.submit copies a frozen lane's table to the
        # host, synchronously and pageable: one such copy, timed.
        lane_S = outs["cuda"][0][0].state.S[0]
        copy_ms = host_s(lambda: lane_S.cpu()) * 1e3
        log(f"  deadline bucket of {BUCKET_LANES} at {deadline_s} s: driver "
            f"{info['driver_supersteps']} supersteps vs {sum(lanes)} lane "
            f"supersteps {lanes}; ExtractionOverlap {info['extraction']}; "
            f"cuda {secs['cuda'] * 1e3:.1f} ms (its superstep loop, lane "
            f"copies included, {outs['cuda'][0][0].wall_time_s * 1e3:.1f} "
            f"ms; one pageable lane-table copy of "
            f"{lane_S.numel() * 4 / 2**20:.1f} MiB {copy_ms:.2f} ms), torch "
            f"{secs['torch'] * 1e3:.1f} ms (host clock)")
        del outs, lane_S

    # One stream, every update held; its cost beside a deadline run.
    query = singles[0]
    streams, stream_s = {}, {}
    for b, eng in (("cuda", eng_c), ("torch", eng_t)):
        t0 = time.perf_counter()
        streams[b] = list(eng.query_stream(query, k=SINGLE_K))
        stream_s[b] = time.perf_counter() - t0
    same_stream(streams["cuda"], streams["torch"])
    t0 = time.perf_counter()
    res, _ = eng_c.query_deadline(query, k=SINGLE_K, deadline_s=600.0,
                                  extract=False)
    dl_s = time.perf_counter() - t0
    steps = len(streams["cuda"]) - 1
    check(res.supersteps == steps, f"stream {steps} vs deadline "
          f"{res.supersteps} supersteps")
    log(f"  stream of {query} (m={SINGLE_M}, k={SINGLE_K}): {steps} "
        f"supersteps, bounds every superstep: "
        f"{stream_s['cuda'] * 1e3 / (steps + 1):.2f} ms per superstep "
        f"(cuda, init included) vs {dl_s * 1e3 / (steps + 1):.2f} ms for "
        f"query_deadline with bounds once; torch "
        f"{stream_s['torch'] * 1e3 / (steps + 1):.2f} ms per superstep; "
        f"final bound {streams['cuda'][-1].sound_opt_lower_bound}, "
        f"weights {streams['cuda'][-1].weights.tolist()}")

    # Telemetry on: the same answers, the same rows on both backends.
    rows = {}
    for b, eng in (("cuda", eng_c), ("torch", eng_t)):
        tel = QueryEngine.build(graph, index=index, policy=ExecutionPolicy(
            backend=b, telemetry=True))
        rt, rb = tel.query(query, k=SINGLE_K), eng.query(query, k=SINGLE_K)
        same_results(rt, rb, f"telemetry on vs off ({b})")
        check(rt.telemetry is not None and rb.telemetry is None,
              f"telemetry missing or leaking ({b})")
        rows[b] = rt.telemetry
        del tel
    check(rows["cuda"].rows() == rows["torch"].rows()
          and np.array_equal(rows["cuda"].frozen, rows["torch"].frozen),
          "telemetry rows differ between cuda and torch")
    log(f"  telemetry == off on both backends; rows equal "
        f"({rows['cuda'].n_steps} steps, peak frontier "
        f"{rows['cuda'].summary()['peak_frontier']})")

    log(f"  the phase took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches,
            "summary": f"{len(trace)} requests, p99 "
                       f"{np.percentile(lat, 99):.1f} ms, "
                       f"{st.throughput_rps:.1f} requests/s, "
                       f"launches {launches}"}


def live_probe(graph, rng) -> tuple[int, int]:
    """Two nodes exactly ``LIVE_PROBE_HOPS`` finite hops apart: ``a`` of
    small degree, ``b`` with fewer than 9 in-edges, so that a shortcut
    edge between them weighs 1 (the paper's weights are at least 1 per
    hop, so the pair's tree weighs at least ``LIVE_PROBE_HOPS`` before)."""
    deg = np.diff(graph.indptr)
    d_in = np.bincount(graph.dst, minlength=graph.n_nodes)
    for a in rng.permutation(np.flatnonzero((deg >= 1) & (deg <= 4))):
        dist = hops_within(graph, int(a), LIVE_PROBE_HOPS)
        far = np.flatnonzero((dist == LIVE_PROBE_HOPS) & (d_in < 9))
        if far.size:
            return int(a), int(far[0])
    raise RuntimeError("chip_smoke: no live probe pair")


def store_phase(dev, graph, tokens, index, bucket, singles,
                phase5: list) -> dict:
    """Phase 10: the graph store and live graphs on ``dev``.  Returns the
    launch counts (the artifact engine's, the live service's, the
    warm's) and a one-line summary."""
    import os
    import tempfile
    import threading

    from repro_torch.engine import ExecutionPolicy, QueryEngine
    from repro_torch.kernels.batched_backtrace import ops as bt_ops
    from repro_torch.kernels.lane_superstep import ops as ls_ops
    from repro_torch.kernels.subset_combine import ops as sc_ops
    from repro_torch.launch.serve_dks import wait_for
    from repro_torch.live import EngineSwapper, GraphWatcher, LiveDir
    from repro_torch.obs import parse_prometheus
    from repro_torch.serve import DKSService, ServeConfig
    from repro_torch.graph.index import mid_df_tokens
    from repro_torch.store import (DeltaBuilder, chained_hash, compact_chain,
                                   from_graph, ingest_tsv, open_artifact,
                                   open_chain, open_delta, write_artifact)

    kernels = {"lane_superstep": ls_ops, "subset_combine": sc_ops,
               "batched_backtrace": bt_ops}
    t_phase = time.perf_counter()
    mem: dict[str, int] = {}
    tmp_ctx = tempfile.TemporaryDirectory(prefix="chip-smoke-store-")
    tmp = Path(tmp_ctx.name)

    # (1) The artifact: written, reopened with every buffer re-hashed, and
    # an engine on it answering bit for bit as phase 5's graph-built one.
    result = from_graph(graph, index=index)
    t0 = time.perf_counter()
    art = write_artifact(tmp / "artifact", result.graph, result.index,
                         tau=result.tau, stats=result.stats.as_dict())
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    art = open_artifact(art.path)
    open_meta_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    art = open_artifact(art.path, verify="full")
    open_full_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = QueryEngine.build(artifact=art,
                            policy=ExecutionPolicy(backend="cuda"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(eng.device == dev, f"artifact engine on {eng.device}")
    check(eng.version == f"artifact:{art.content_hash}",
          f"artifact engine version {eng.version}")
    for ops in kernels.values():
        ops.counter.reset()
    got = eng.query_batch(bucket, k=BUCKET_K) + [
        eng.query(q, k=SINGLE_K) for q in singles]
    store_launches = {n: ops.launches for n, ops in kernels.items()}
    for i, (rc, rp) in enumerate(zip(got, phase5)):
        same_results(rc, rp, f"artifact engine vs phase 5, result {i}")
    steps = max(r.supersteps for r in got[:BUCKET_LANES]) + sum(
        r.supersteps for r in got[BUCKET_LANES:])
    check(store_launches == {"lane_superstep": steps,
                             "subset_combine": 1 + N_SINGLE,
                             "batched_backtrace": 1},
          f"artifact engine launches {store_launches}")
    nbytes = art.nbytes()
    log(f"  artifact: {nbytes / 1e6:.1f} MB of buffers, written in "
        f"{write_s * 1e3:.1f} ms ({nbytes / 1e6 / write_s:.1f} MB/s, "
        f"sha256 included); open {open_meta_s * 1e3:.2f} ms (meta), "
        f"{open_full_s * 1e3:.1f} ms (every buffer re-hashed); engine build "
        f"{build_s * 1e3:.1f} ms; bucket and {N_SINGLE} queries == phase 5 "
        f"(weights, supersteps, trees), launches {store_launches}")
    del eng, got, art, result

    # (2) The live leg.  sec-rdfabout's edges as a TSV whose entity names
    # carry each node's tokens, so keywords are shared as in the graph.
    names = [f"n{v} " + " ".join(f"t{t}" for t in row)
             for v, row in enumerate(tokens.tolist())]
    tsv = tmp / "sec.tsv"
    tsv.write_text("".join(f"{names[a]}\t{names[b]}\n"
                           for a, b in zip(graph.src.tolist(),
                                           graph.dst.tolist())))
    t0 = time.perf_counter()
    ingested = ingest_tsv(tsv)
    ingest_s = time.perf_counter() - t0
    a, b = live_probe(ingested.graph, np.random.default_rng(QUERY_SEED))
    name_a, name_b = ingested.names[a], ingested.names[b]
    probe = [name_a.split()[0], name_b.split()[0]]
    live = LiveDir.initialize(tmp / "live", ingested)
    del ingested, names
    # One build's device bytes: the engine, and the backtracer its first
    # bucket builds.
    mem_before_build = torch.cuda.memory_allocated()
    engine = QueryEngine.build(artifact=live.chain(),
                               policy=ExecutionPolicy(backend="cuda"))
    base_probe = float(engine.query_batch([probe], k=1)[0].weights[0])
    mem["before the service"] = torch.cuda.memory_allocated()
    build_bytes = mem["before the service"] - mem_before_build
    old_version = engine.version
    pool = [probe] + [[f"t{t}" for t in q] for q in bucket[:3]]
    watch_dir = tmp / "incoming"
    watch_dir.mkdir()
    # serve_dks --smoke's settings; a trace ring that keeps the swap's
    # trace through the cache hits of the load.
    cfg = ServeConfig(max_batch=4, max_wait_ms=50.0, cache_size=256,
                      trace_seed=0, trace_capacity=1 << 20)
    probe_weights: list[float] = []
    served = [0] * LIVE_CLIENTS
    failures: list = []
    stop = threading.Event()

    def client(i: int) -> None:
        while not stop.is_set():
            q = pool[i % len(pool)]
            try:
                srv = svc.query(list(q), k=1, timeout=SERVE_TIMEOUT_S)
            except Exception as exc:
                failures.append((q, repr(exc)))
                return
            served[i] += 1
            if q is probe:
                probe_weights.append(float(srv.result.weights[0]))

    for ops in kernels.values():
        ops.counter.reset()
    with DKSService(engine, cfg) as svc:
        del engine      # the service holds the only reference now
        swapper = EngineSwapper(svc)
        swapper.wire_metrics()
        watcher = GraphWatcher(live, watch_dir, poll_s=0.05,
                               on_delta=swapper.on_delta).start()
        threads = [threading.Thread(target=client, args=(i,), daemon=True,
                                    name=f"live-client-{i}")
                   for i in range(LIVE_CLIENTS)]
        try:
            for t in threads:
                t.start()
            # Every client's query served twice (the second a cache hit),
            # so every pool shape is hot when the swap comes.
            wait_for(lambda: failures or min(served) >= 2,
                     SERVE_TIMEOUT_S, "pre-swap load")
            mem["before the first swap"] = torch.cuda.memory_allocated()
            # The fragment: a shortcut between the probe pair, and a new
            # entity with a fresh keyword; dropped atomically.
            frag = tmp / "frag.part"
            frag.write_text(f"{name_a}\t{name_b}\nzzfresh kwfresh\t"
                            f"{name_a}\n")
            t_drop = time.perf_counter()
            os.replace(frag, watch_dir / "frag-0001.tsv")
            wait_for(lambda: swapper.swaps >= 1 or watcher.error
                     or failures, SERVE_TIMEOUT_S, "the hot swap")
            swap_wall_s = time.perf_counter() - t_drop
            mem["after swap 1"] = torch.cuda.memory_allocated()
            at_swap = list(served)
            wait_for(lambda: failures or all(
                n >= at + 2 for n, at in zip(served, at_swap)),
                SERVE_TIMEOUT_S, "post-swap load")
        finally:
            stop.set()
            for t in threads:
                t.join(SERVE_TIMEOUT_S)
            watcher.stop(SERVE_TIMEOUT_S)
        check(not any(t.is_alive() for t in threads),
              "a live client outlived its join")
        check(watcher.error is None and not failures,
              f"requests failed across the swap: {failures} "
              f"(watcher: {watcher.error!r})")
        served_total = svc.stats().requests
        trace = [t for t in svc.recent_traces() if t.name == "dks.swap"][-1]
        spans = {sp.name: sp.duration_ms for sp in trace.spans}
        check(list(spans) == ["build", "warm", "swap"],
              f"dks.swap spans {list(spans)}")
        check(swapper.last_hot and swapper.last_warmed == swapper.last_hot,
              f"hot shapes {swapper.last_hot}, warmed "
              f"{swapper.last_warmed}")
        warmed = list(swapper.last_warmed)
        chain = live.chain()
        delta = open_delta(live.delta_paths[0])
        check(chain.depth == 1 and svc.engine.version
              == f"artifact:{chain.content_hash}" == "artifact:"
              + chained_hash(live.base().content_hash, delta.content_hash),
              f"serving version {svc.engine.version}")
        check(svc.engine.device == dev, f"successor on {svc.engine.device}")
        samples = parse_prometheus(svc.registry.render())
        check(samples["dks_graph_staleness_seconds"] == 0.0
              and samples["dks_delta_applied_total"] == 1,
              f"staleness {samples['dks_graph_staleness_seconds']}, "
              f"applied {samples['dks_delta_applied_total']}")
        # Two more swaps onto the same chain, with no client load: each
        # retires a build, and their spans time the warm alone.
        quiet = []
        for i in (2, 3):
            swapper.swap_to(chain)
            mem[f"after swap {i}"] = torch.cuda.memory_allocated()
            check(swapper.last_warmed == swapper.last_hot,
                  f"swap {i}: warmed {swapper.last_warmed} of "
                  f"{swapper.last_hot}")
            quiet.append({sp.name: sp.duration_ms for sp in [
                t for t in svc.recent_traces()
                if t.name == "dks.swap"][-1].spans})
        post = {tuple(q): svc.query(list(q), k=1, timeout=SERVE_TIMEOUT_S)
                .result for q in pool + [["kwfresh", probe[0]]]}
        gc.collect()
        mem["after gc"] = torch.cuda.memory_allocated()
        ts = svc.tracer.stats()
    by_thread = {n: ops.counter.by_thread() for n, ops in kernels.items()}
    service = {n: t.get("dks-serve-dispatcher", 0)
               for n, t in by_thread.items()}
    warm = {n: t.get("repro-graph-watcher", 0) for n, t in by_thread.items()}
    check(all(service.values()), f"service launches {service}")
    check(warm["lane_superstep"] > 0 and warm["subset_combine"] > 0,
          f"warm launches {warm}")
    check(ts["begun"] == ts["finished"], f"traces incomplete: {ts}")
    check(abs(mem["after gc"] - mem["before the service"]) <= build_bytes,
          f"device memory after 3 swaps {mem} vs one build {build_bytes}")

    # The warm's count, exact though the dispatcher launched beside it:
    # the same warm queries again, on this thread alone.
    successor = QueryEngine.build(artifact=chain,
                                  policy=ExecutionPolicy(backend="cuda"))
    for ops in kernels.values():
        ops.counter.reset()
    toks = mid_df_tokens(successor.index)
    for m, k, lanes in warmed:
        successor.query_batch([list(toks[:m])] * lanes, k=k, extract=False,
                              strict=False, n_real=1)
    again = {n: ops.launches for n, ops in kernels.items()}
    check(again == warm, f"warm launches {warm} on the watcher's thread vs "
                         f"{again} replayed alone")

    # Post-swap answers against engines on the compacted union.
    union = {bk: QueryEngine.build(
        artifact=compact_chain(chain, tmp / f"union-{bk}"),
        policy=ExecutionPolicy(backend=bk)) for bk in ("cuda", "torch")}
    union_probe = float(union["torch"].query(probe, k=1).weights[0])
    check(union_probe < base_probe,
          f"the shortcut left the probe at {union_probe} (base "
          f"{base_probe})")
    bad = sorted({w for w in probe_weights} - {base_probe, union_probe})
    check(not bad, f"probe weights {bad} are neither the base engine's "
                   f"{base_probe} nor the union's {union_probe}")
    check(probe_weights[-1] == union_probe, "the last probe missed the swap")
    for q, res in post.items():
        for bk, ue in union.items():
            same_results(res, ue.query_batch([list(q)], k=1)[0],
                         f"post-swap {list(q)} vs union on {bk}")
    check(post[("kwfresh", probe[0])].found, "the fresh keyword found nothing")
    for bk, ue in union.items():
        check(ue.version == f"artifact:{ue.artifact.content_hash}",
              f"union engine version on {bk}")
    n_before = sum(1 for w in probe_weights if w == base_probe)
    # The delta's build and write, timed alone on the same fragment.
    (tmp / "frag-timed.tsv").write_text(f"{name_a}\t{name_b}\n"
                                        f"zzfresh kwfresh\t{name_a}\n")
    t0 = time.perf_counter()
    builder = DeltaBuilder(open_chain(live.base_path))
    builder.add_file(tmp / "frag-timed.tsv")
    timed = builder.write(tmp / "delta-timed")
    delta_s = time.perf_counter() - t0
    check(timed.content_hash == delta.content_hash,
          "the timed delta differs from the published one")
    log(f"  live leg: {graph.n_edges_directed} edges as TSV, ingested in "
        f"{ingest_s:.2f} s ({graph.n_edges_directed / ingest_s:,.0f} edges/s), "
        f"base {live.base().content_hash[:12]}; the delta (2 edges, 1 new "
        f"entity) built and written in {delta_s * 1e3:.1f} ms; the swap "
        f"{swap_wall_s:.3f} s from the drop: build "
        f"{spans['build']:.1f} ms, warm {spans['warm']:.1f} ms "
        f"({warmed}), swap {spans['swap']:.3f} ms; with no client load "
        f"(swaps 2 and 3): " + ", ".join(
            f"build {q['build']:.1f} ms, warm {q['warm']:.1f} ms"
            for q in quiet) + f" (switch interval "
        f"{sys.getswitchinterval() * 1e3:g} ms)")
    log(f"  served {served_total} requests from {LIVE_CLIENTS} clients "
        f"across the swap, 0 failed; probe {probe} {base_probe} -> "
        f"{union_probe} ({n_before} probes before, "
        f"{len(probe_weights) - n_before} after, none mixed); post-swap "
        f"answers == union on cuda and torch; version "
        f"{old_version[:20]}… -> {svc.engine.version[:20]}…; staleness 0; "
        f"dks.swap spans build/warm/swap")
    log(f"  launches: the service {service}, the warm {warm} (the warm "
        f"runs extract=False, so no backtrace), replayed alone {again}")
    log(f"  device memory (MiB): " + ", ".join(
        f"{k} {v / 2**20:.1f}" for k, v in mem.items())
        + f"; one build {build_bytes / 2**20:.1f}")
    del union, successor, svc, swapper, watcher, chain, post
    tmp_ctx.cleanup()
    log(f"  the phase took {time.perf_counter() - t_phase:.1f} s")
    return {"store_launches": store_launches,
            "live_launches": {n: {"service": service[n], "warm": warm[n]}
                              for n in kernels},
            "summary": f"artifact == phase 5; {served_total} requests "
                       f"across a hot swap, 0 failed; post-swap == union"}


def sharded_phase(dev, graph, index, bucket, singles, phase5,
                  per_step) -> dict:
    """Phase 12: the sharded partition on the card, held against phase 5
    (``phase5``: its bucket and queries; ``per_step``: its driver ms per
    superstep by backend).  Returns the phase's launch counts and a
    one-line summary."""
    from repro_torch.core.dks_sharded import frontier_cap
    from repro_torch.engine import ExecutionPolicy, QueryEngine
    from repro_torch.graph.generators import lod_like_graph
    from repro_torch.graph.index import InvertedIndex
    from repro_torch.kernels.batched_backtrace import ops as bt_ops
    from repro_torch.kernels.lane_superstep import ops as ls_ops
    from repro_torch.kernels.subset_combine import ops as sc_ops
    from repro_torch.launch.serve_dks import serve_replay, verify_served
    from repro_torch.serve import ServeConfig
    from repro_torch.serve.loadgen import make_trace

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    kernels = {"lane_superstep": ls_ops, "subset_combine": sc_ops,
               "batched_backtrace": bt_ops}
    for ops in kernels.values():
        ops.counter.reset()
    # Telemetry reads the frontier per superstep; it changes no answer.
    t0 = time.perf_counter()
    eng = QueryEngine.build(graph, index=index, device=dev,
                            policy=ExecutionPolicy(
                                partition="sharded", n_shards=SHARDS,
                                frontier_frac=1.0, telemetry=True))
    build_ms = (time.perf_counter() - t0) * 1e3
    fg = eng.device_graph
    check(fg.n_shards == SHARDS and fg.device == dev,
          f"sharded graph: {fg.n_shards} shards on {fg.device}")

    # Uncapped: exactly phase 5.
    t0 = time.perf_counter()
    batch = eng.query_batch(bucket, k=BUCKET_K)
    t_batch = time.perf_counter() - t0
    single = []
    for q in singles:
        t0 = time.perf_counter()
        single.append((eng.query(q, k=SINGLE_K), time.perf_counter() - t0))
    for i, (r, p) in enumerate(zip(batch + [r for r, _ in single], phase5)):
        same_results(r, p, f"sharded result {i} vs phase 5")
        check(not r.budget_hit, f"sharded result {i}: budget_hit uncapped")

    # The default cap: exact, or a forced stop with a sound bound.
    t0 = time.perf_counter()
    capped = eng.query_batch(bucket, k=BUCKET_K, frontier_frac=SHARDED_CAP)
    t_capped = time.perf_counter() - t0
    bounds = []
    for i, (r, p) in enumerate(zip(capped, phase5)):
        if not r.budget_hit:
            same_results(r, p, f"capped lane {i} vs phase 5")
            continue
        exact, own = float(p.weights[0]), float(r.weights[0])
        check(r.spa is not None and r.spa <= exact <= own,
              f"capped lane {i}: SPA {r.spa} <= exact {exact} <= own "
              f"{own} does not hold")
        bounds.append((r.supersteps, r.spa, exact, own))

    # A small graph whose cap overflows: the card answers as the CPU.
    n_s, e_s, frac_s = SMALL_SHARDED
    gs, toks_s = lod_like_graph(n_s, e_s, seed=5, vocab=200)
    idx_s = InvertedIndex.from_token_matrix(toks_s)
    qs = draw_queries(gs, idx_s, 4, BUCKET_M, np.random.default_rng(
        QUERY_SEED))
    small = [QueryEngine.build(gs, index=idx_s, device=d,
                               policy=ExecutionPolicy(
                                   partition="sharded", n_shards=SHARDS,
                                   frontier_frac=frac_s))
             for d in (dev, "cpu")]
    on_card, on_cpu = (e.query_batch(qs, k=2) for e in small)
    for i, (rc, rt) in enumerate(zip(on_card, on_cpu)):
        same_results(rc, rt, f"small sharded graph, lane {i}, cuda vs cpu")
        check(rc.spa == rt.spa, f"small graph lane {i}: spa differs")
    check(any(r.budget_hit for r in on_card),
          "small sharded graph: no lane overflowed its cap")
    same_stream(*(list(e.query_stream(qs[0], k=2)) for e in small))
    del small

    # Phase 9's trace through DKSService on the sharded engine.
    trace = make_trace(index, SERVE_REQUESTS, unique=SERVE_UNIQUE, k=1,
                       deadline_frac=SERVE_DEADLINE_FRAC,
                       deadline_ms=SERVE_DEADLINE_MS, seed=0)
    run = serve_replay(eng, trace, ServeConfig(
        max_batch=4, max_wait_ms=50.0, cache_size=256, trace_seed=0),
        clients=SERVE_CLIENTS, smoke=False, k=1, timeout=SERVE_TIMEOUT_S)
    n_exact, n_approx = verify_served(eng, trace, run["served"])
    check(n_exact > 0, "no exact served answer on the sharded engine")
    launches = {name: ops.launches for name, ops in kernels.items()}
    check(not any(launches.values()),
          f"hand-written kernels launched on the sharded path: {launches}")
    peak = torch.cuda.max_memory_allocated()

    steps = max(r.supersteps for r in batch)
    drv = batch[0].wall_time_s * 1e3 / steps
    log(f"  sharded engine: {SHARDS} shards of {fg.n_loc} nodes (V_pad "
        f"{fg.v_pad}), built in {build_ms:.1f} ms; bucket of "
        f"{BUCKET_LANES} and {N_SINGLE} queries == phase 5 exactly")
    log(f"  bucket (m={BUCKET_M}, k={BUCKET_K}): {steps} supersteps, "
        f"{t_batch * 1e3:.1f} ms = driver {batch[0].wall_time_s * 1e3:.1f} "
        f"ms ({drv:.2f} ms per superstep; phase 5: cuda "
        f"{per_step['cuda'][0]:.2f}, torch {per_step['torch'][0]:.2f}) + "
        f"extraction {(t_batch - batch[0].wall_time_s) * 1e3:.1f} ms")
    for i, (r, t) in enumerate(single):
        log(f"  query {i} (m={SINGLE_M}, k={SINGLE_K}): {r.supersteps} "
            f"supersteps, {t * 1e3:.1f} ms, driver "
            f"{r.wall_time_s * 1e3 / r.supersteps:.2f} ms per superstep "
            f"(phase 5: cuda {per_step['cuda'][1][i]:.2f}, torch "
            f"{per_step['torch'][1][i]:.2f})")
    cfg = ExecutionPolicy(partition="sharded").dks_config(BUCKET_M,
                                                          BUCKET_K)
    cell = (1 << BUCKET_M) * BUCKET_K * 4          # one node's table, bytes
    dense = BUCKET_LANES * graph.n_nodes * cell
    for frac in (1.0, SHARDED_CAP):
        f_cap = frontier_cap(fg, dataclasses.replace(cfg,
                                                     frontier_frac=frac))
        gathered = BUCKET_LANES * SHARDS * f_cap * (cell + 4)
        log(f"  frontier_frac={frac}: f_cap {f_cap} per shard and lane, "
            f"{gathered / 2**20:.1f} MiB gathered per superstep (ids and "
            f"tables) against the dense table's {dense / 2**20:.1f} MiB")
    front = batch[0].telemetry.frontier
    log(f"  the bucket's changed nodes after each superstep (all lanes): "
        f"{front.tolist()}, mean {front.mean():.0f}, whose tables are "
        f"{front.mean() * cell / 2**20:.1f} MiB")
    counts = (fg.edge_src >= 0).sum(dim=1).cpu().numpy()
    log(f"  e_cap {fg.e_cap} ({fg.n_edges} symmetric edges); edges per "
        f"shard {counts.tolist()}, imbalance (largest / mean) "
        f"{counts.max() / counts.mean():.4f}")
    log(f"  capped at {SHARDED_CAP}: {len(bounds)} of {BUCKET_LANES} lanes "
        f"stopped by overflow, (supersteps, SPA, exact, own top-1) "
        f"{bounds}; {t_capped * 1e3:.1f} ms")
    lat = np.asarray([r.latency_ms for r in run["served"]])
    st = run["replay_stats"]
    log(f"  served: {len(trace)} requests in {run['replay_s']:.3f} s, p50 "
        f"{np.percentile(lat, 50):.3f} ms, p99 {np.percentile(lat, 99):.3f}"
        f" ms, {st.throughput_rps:.2f} requests/s, batch fill "
        f"{st.mean_batch_fill:.3f}; {n_exact} exact answers == "
        f"engine.query, {n_approx} approximate within sound bounds")
    log(f"  small graph ({n_s} nodes, frontier_frac={frac_s}): cuda == cpu,"
        f" {sum(r.budget_hit for r in on_card)} of {len(qs)} lanes "
        f"overflowed")
    log(f"  peak device memory {peak / 2**30:.2f} GiB ({mem0 / 2**30:.2f} "
        f"GiB held before the phase); hand-written kernel launches "
        f"{launches}; the phase took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches,
            "summary": f"{steps} supersteps at {drv:.2f} ms each, "
                       f"{len(bounds)} capped lanes sound, {n_exact} exact "
                       f"served answers"}


def train_args(arch: str, steps: int, batch: int, seq: int = 128):
    """``repro_torch.launch.train``'s argument namespace for a run on the
    card."""
    from repro_torch.launch import train

    return train.parser().parse_args([
        "--arch", arch, "--steps", str(steps), "--batch", str(batch),
        "--seq", str(seq), "--seed", str(TRAIN_SEED), "--device", "cuda",
        "--log-every", str(steps)])


def attention_times(dev, cfg, card: str) -> None:
    """One layer's attention at the train shape, forward and forward +
    backward, on ``"chunked"`` and ``"flash_jax"`` (CUDA events, mean of 3):
    with remat a step runs each layer's forward twice and its backward
    once."""
    from repro_torch.models.attention import attention

    gen = torch.Generator(dev).manual_seed(TRAIN_SEED)
    q, k, v = (torch.randn(TRAIN_BATCH, TRAIN_SEQ, h, cfg.head_dim,
                           generator=gen, device=dev).bfloat16()
               .requires_grad_(True)
               for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    d_o = torch.randn_like(q)
    parts = []
    for impl in ("chunked", "flash_jax"):
        fwd = cuda_ms(lambda: attention(q, k, v, impl=impl), 3)
        both = cuda_ms(lambda: torch.autograd.grad(
            attention(q, k, v, impl=impl), (q, k, v), d_o), 3)
        per_step = cfg.n_layers * (fwd + both)
        parts.append(f"{impl} forward {fwd:.2f} ms, forward+backward "
                     f"{both:.2f} ms, x {cfg.n_layers} layers with remat "
                     f"{per_step:.1f} ms a step")
    log(f"  attention at q {list(q.shape)}, k/v {list(k.shape)} (bf16, one "
        f"layer): " + "; ".join(parts) + f" [{card}]")


def step_split(state, batch, step, card: str) -> None:
    """One train step under torch.profiler: kernel time against the host
    clock (profiled, so the host runs slower than unprofiled), launches,
    and the kernels that lead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy == 0:
        log("  train step: device time not measured (the profiler saw no "
            "kernel)")
        return
    top = "; ".join(f"{e.key[:70]} {e.self_device_time_total / 1e3:.1f} ms "
                    f"x{e.count}" for e in kernels[:10])
    log(f"  a train step under torch.profiler: kernels busy {busy:.1f} ms of "
        f"{wall:.1f} ms wall ({100 * busy / wall:.1f} %), "
        f"{sum(e.count for e in kernels)} kernel launches; top: {top} "
        f"[{card}]")


def granite_train(dev, card: str) -> dict:
    """granite-moe-3b-a800m at full width and depth through ``train_lm``:
    ``TRAIN_STEPS`` steps of ``TRAIN_BATCH`` x ``TRAIN_SEQ`` tokens; then,
    from a fresh model and one batch, the loss and gradient norm on
    ``"flash_jax"`` against ``"chunked"``; then one step at
    ``grad_accum=2`` with its peak memory."""
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_synthetic_stream
    from repro_torch.launch import train
    from repro_torch.models import lm as lm_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import global_norm

    cfg = get_arch(TRAIN_ARCH)
    args = train_args(TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ)
    t0 = time.perf_counter()
    out = train.train_lm(args)
    wall = time.perf_counter() - t0
    steps = out["steps"]
    for r in steps:
        check(bool(np.isfinite([r["loss"], r["grad_norm"], r["lr"]]).all()),
              f"{cfg.name} step {r['step']}: {r}")
        log(f"    step {r['step']:2d}: loss {r['loss']:.4f}, grad_norm "
            f"{r['grad_norm']:.4f}, lr {r['lr']:.3e}; {r['step_s'] * 1e3:.1f}"
            f" ms = forward+backward {r['grad_s'] * 1e3:.1f} + optimizer "
            f"{r['update_s'] * 1e3:.1f}")
    check(out["last_loss"] < out["first_loss"],
          f"{cfg.name}: loss {out['first_loss']} -> {out['last_loss']}")
    split = {k: 1e3 * float(np.mean([r[k] for r in steps[1:]]))
             for k in ("step_s", "grad_s", "update_s")}
    peak1 = out["peak_bytes"]
    log(f"  {cfg.name} trained at full width and depth "
        f"({cfg.param_count_analytic()} bf16 parameters; remat, chunked "
        f"attention, AdamW with f32 moments), {TRAIN_STEPS} steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens: loss {out['first_loss']:.4f} "
        f"-> {out['last_loss']:.4f}; steps 1..{TRAIN_STEPS - 1}: "
        f"{split['step_s']:.1f} ms a step = forward+backward "
        f"{split['grad_s']:.1f} + optimizer {split['update_s']:.1f} (host "
        f"clock, synchronised), {out['tokens_per_s']:.0f} tokens/s; first "
        f"step {steps[0]['step_s'] * 1e3:.1f} ms; peak "
        f"{peak1 / 2**30:.2f} GiB; train_lm {wall:.1f} s [{card}]")
    for r in (steps[0], steps[-1]):
        log(f"    step {r['step']} dropped_frac per layer: "
            f"{[round(d, 4) for d in r['dropped_frac']]}")
    del out
    gc.collect()
    torch.cuda.empty_cache()

    model = tfm.init_lm(cfg, torch.Generator(dev).manual_seed(TRAIN_SEED))
    for p in model.parameters():
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(
        lm_synthetic_stream(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ,
                            seed=TRAIN_SEED + 1)).items()}
    got = {}
    for impl in ("chunked", "flash_jax"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, grads, _ = lm_lib.loss_and_grads(model, batch, impl)
        gn = float(global_norm(grads))
        got[impl] = (float(loss), gn, time.perf_counter() - t0)
        del grads
    (lc, nc, tc), (lf, nf, tf) = got["chunked"], got["flash_jax"]
    check(abs(lf - lc) <= FLASH_JAX_TOL * abs(lc)
          and abs(nf - nc) <= FLASH_JAX_TOL * nc,
          f"flash_jax loss {lf}, grad_norm {nf} against chunked {lc}, {nc}")
    log(f"  flash_jax against chunked, one state and batch: loss {lf:.6f} / "
        f"{lc:.6f}, grad_norm {nf:.6f} / {nc:.6f} (limit {FLASH_JAX_TOL} "
        f"relative); forward+backward {tf * 1e3:.1f} / {tc * 1e3:.1f} ms "
        f"(one call each, host clock) [{card}]")

    attention_times(dev, cfg, card)
    state = lm_lib.init_train_state(model)
    step_split(state, batch, lm_lib.make_train_step(train.opt_config(args),
                                                    "chunked"), card)
    torch.cuda.reset_peak_memory_stats(dev)
    step = lm_lib.make_train_step(train.opt_config(args), "chunked",
                                  grad_accum=2)
    state, m = step(state, batch)
    peak2 = torch.cuda.max_memory_allocated(dev)
    check(bool(torch.isfinite(m["loss"])), f"grad_accum=2 loss {m['loss']}")
    log(f"  one step at grad_accum=2 (2 microbatches of {TRAIN_BATCH // 2} "
        f"x {TRAIN_SEQ}): loss {float(m['loss']):.4f}, "
        f"{(m['grad_s'] + m['update_s']) * 1e3:.1f} ms; peak "
        f"{peak2 / 2**30:.2f} GiB against {peak1 / 2**30:.2f} at "
        f"grad_accum=1 [{card}]")
    return {"split": split, "peak": (peak1, peak2)}


def bit_equal(a, b) -> bool:
    """Two tensors (or ints) with the same device, dtype and bits."""
    if not isinstance(a, torch.Tensor):
        return a == b
    return (a.device == b.device and a.dtype == b.dtype
            and torch.equal(a.reshape(-1).view(torch.uint8),
                            b.reshape(-1).view(torch.uint8)))


def checkpoint_leg(dev, card: str) -> None:
    """granite at full width cut to ``CKPT_LAYERS`` layers: two steps, a
    save, a restore into a fresh state on the card from a meta template
    (every leaf bit-equal), then step 3 from the restored state and from
    the live one: the same loss, exactly (the forward has no atomics)."""
    import tempfile

    from repro_torch.checkpoint import Stacked, restore_tree, save_tree
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_synthetic_stream
    from repro_torch.launch import train
    from repro_torch.models import lm as lm_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import tree_leaves

    full = get_arch(TRAIN_ARCH)
    cfg = full.scaled(n_layers=CKPT_LAYERS)
    state = lm_lib.init_train_state(tfm.init_lm(
        cfg, torch.Generator(dev).manual_seed(TRAIN_SEED)))
    step = lm_lib.make_train_step(train.opt_config(train_args(
        TRAIN_ARCH, TRAIN_STEPS, TRAIN_BATCH)), "chunked")
    stream = lm_synthetic_stream(cfg.vocab, TRAIN_BATCH, TRAIN_SEQ,
                                 seed=TRAIN_SEED)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in next(
        stream).items()} for _ in range(3)]
    for b in batches[:2]:
        state, _ = step(state, b)
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_tree(lm_lib.train_state_tree(state), tmp, 2)
        t_save = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
        t0 = time.perf_counter()
        back = lm_lib.train_state_from_tree(cfg, restore_tree(
            lm_lib.train_state_template(cfg), tmp, 2, device=dev))
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
    n = 0
    for g, w in zip(tree_leaves(lm_lib.train_state_tree(back)),
                    tree_leaves(lm_lib.train_state_tree(state)), strict=True):
        for a, b in (zip(g.parts, w.parts, strict=True)
                     if isinstance(g, Stacked) else [(g, w)]):
            n += 1
            check(bit_equal(a, b), f"restored tensor {n} differs from saved")
    _, resumed = step(back, batches[2])
    _, live = step(state, batches[2])
    l_r, l_u = float(resumed["loss"]), float(live["loss"])
    check(l_r == l_u, f"step 3 after a restore: loss {l_r} != {l_u}")
    log(f"  checkpoint: {cfg.name} at full width, reduced: n_layers "
        f"{full.n_layers}→{CKPT_LAYERS}; after 2 steps saved {nbytes} bytes "
        f"in {t_save:.2f} s ({nbytes / t_save / 1e9:.2f} GB/s), restored "
        f"onto the card from a meta template in {t_restore:.2f} s; {n} "
        f"tensors and ints bit-equal; step 3 loss {l_r:.6f} resumed == "
        f"{l_u:.6f} uninterrupted [{card}]")


def dcn_train(dev, card: str) -> int:
    """DCN-v2 at full width through ``train_recsys`` (``impl="cuda"``):
    ``DCN_TRAIN_STEPS`` steps of ``DCN_TRAIN_BATCH`` rows, the grouped
    lookup's launches counted; then one batch's table gradients on
    ``"cuda"`` against ``"torch"``.  Returns the launches."""
    from repro_torch.configs import get_arch
    from repro_torch.data import recsys_synthetic_stream
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.launch import train
    from repro_torch.models import recsys as rec_lib

    cfg = get_arch(RECSYS_ARCH)
    args = train_args(RECSYS_ARCH, DCN_TRAIN_STEPS, DCN_TRAIN_BATCH)
    eb_ops.counter.reset()
    out = train.train_recsys(args)
    launches = eb_ops.launches
    check(launches == DCN_TRAIN_STEPS,
          f"{launches} grouped lookups in {DCN_TRAIN_STEPS} steps")
    check(out["last_loss"] < out["first_loss"],
          f"{cfg.name}: loss {out['first_loss']} -> {out['last_loss']}")
    ms = [r["step_s"] * 1e3 for r in out["steps"]]
    log(f"  {cfg.name} trained at full width (f32, TF32 off) on "
        f"impl=cuda: {DCN_TRAIN_STEPS} steps of {DCN_TRAIN_BATCH} rows, "
        f"loss {out['first_loss']:.4f} -> {out['last_loss']:.4f}; "
        f"{launches} grouped lookups; {np.median(ms[1:]):.2f} ms a step "
        f"(median of steps 1..; first {ms[0]:.1f}) [{card}]")
    del out
    gc.collect()
    torch.cuda.empty_cache()

    params = rec_lib.init_dcn(cfg, torch.Generator(dev).manual_seed(
        TRAIN_SEED))
    batch = rec_lib.batch_to_device(next(recsys_synthetic_stream(
        cfg, DCN_TRAIN_BATCH, seed=TRAIN_SEED + 1)), dev)
    tables = [params["tables"][f"table_{i}"].requires_grad_(True)
              for i in range(cfg.n_sparse)]
    grads = {}
    for impl in ("cuda", "torch"):
        loss = rec_lib.dcn_loss(params, batch, cfg, impl)
        grads[impl] = torch.autograd.grad(loss, tables)
    err = max(max_abs_err(g, w) for g, w in zip(grads["cuda"],
                                                 grads["torch"]))
    for g, w in zip(grads["cuda"], grads["torch"]):
        torch.testing.assert_close(g, w, atol=DCN_GRAD_TOL,
                                   rtol=DCN_GRAD_TOL)
    log(f"  {cfg.name} table gradients on impl=cuda (the kernel, then a "
        f"scatter-add) == impl=torch within {DCN_GRAD_TOL} (max abs err "
        f"{err:.3g}) [{card}]")
    return launches


def smoke_on_card_and_cpu(dev, card: str) -> None:
    """One f32 train step of each smoke config from the same weights and
    batch on the card and on the CPU: loss, grad_norm and every parameter
    after the step within ``SMOKE_TRAIN_TOL``."""
    from repro_torch.configs import get_arch
    from repro_torch.data import lm_synthetic_stream
    from repro_torch.models import lm as lm_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import AdamWConfig

    for arch in (LM_ARCH, TRAIN_ARCH):
        cfg = get_arch(arch).smoke().scaled(param_dtype="float32")
        cpu = tfm.init_lm(cfg, torch.Generator("cpu").manual_seed(TRAIN_SEED))
        on_card = tfm.LM(cfg, device=dev)
        on_card.load_state_dict(cpu.state_dict())
        batch = {k: torch.from_numpy(v) for k, v in next(lm_synthetic_stream(
            cfg.vocab, 4, 64, seed=TRAIN_SEED)).items()}
        step = lm_lib.make_train_step(AdamWConfig(warmup_steps=1),
                                      attn_impl="naive")
        (s_c, m_c), (s_d, m_d) = (
            step(lm_lib.init_train_state(model),
                 {k: v.to(d) for k, v in batch.items()})
            for model, d in ((cpu, "cpu"), (on_card, dev)))
        err = 0.0
        for name in ("loss", "grad_norm", "lr"):
            torch.testing.assert_close(m_d[name].cpu(), m_c[name],
                                       atol=SMOKE_TRAIN_TOL,
                                       rtol=SMOKE_TRAIN_TOL)
        for (n, p), (_, q) in zip(s_d.model.named_parameters(),
                                  s_c.model.named_parameters(), strict=True):
            err = max(err, max_abs_err(p.detach().cpu(), q.detach()))
            torch.testing.assert_close(p.detach().cpu(), q.detach(),
                                       atol=SMOKE_TRAIN_TOL,
                                       rtol=SMOKE_TRAIN_TOL,
                                       msg=lambda msg: f"{arch} {n}: {msg}")
        log(f"  {arch} smoke (f32) train step, card == CPU within "
            f"{SMOKE_TRAIN_TOL}: loss {float(m_d['loss']):.6f} / "
            f"{float(m_c['loss']):.6f}, grad_norm "
            f"{float(m_d['grad_norm']):.6f} / {float(m_c['grad_norm']):.6f}, "
            f"parameters max abs err {err:.3g} [{card}]")


def train_phase(dev, card: str) -> dict:
    """Phase 13: training on the card.  Returns the granite numbers and the
    DCN-v2 train path's grouped-lookup launches."""
    t_phase = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        granite = granite_train(dev, card)
        gc.collect()
        torch.cuda.empty_cache()
        checkpoint_leg(dev, card)
        gc.collect()
        torch.cuda.empty_cache()
        launches = dcn_train(dev, card)
        gc.collect()
        torch.cuda.empty_cache()
        smoke_on_card_and_cpu(dev, card)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    log(f"  the phase took {time.perf_counter() - t_phase:.1f} s")
    return {**granite, "launches": launches}


def device_bytes(dg) -> int:
    """Bytes of the tensors a device graph (or a GNN batch) holds."""
    return sum(t.numel() * t.element_size()
               for t in vars(dg).values() if isinstance(t, torch.Tensor))


def gib(nbytes: float) -> str:
    return f"{nbytes / 2**30:.2f} GiB"


def lanes_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """``max_abs_err`` one lane at a time: a bluk-bnb bucket table is
    12.4 GB, and the difference of two would not fit beside them."""
    return max(max_abs_err(x, y) for x, y in zip(a, b))


def bluk_counts(dg, kw, cfg, batch) -> None:
    """A second run of the bucket: every per-superstep message count
    against its int64 sum rounded to f32 by numpy, the largest beside
    2^24, each superstep's host ms, and torch.profiler's split of the
    superstep with the most messages; the final counters equal the main
    path's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import dks, driver

    deg = dg.out_degree.long()
    st = driver.lane_init(dg, kw, cfg)
    rows, step_ms = [], []
    while not bool(st.done.all()):
        live = (~st.done).cpu().numpy()
        for fire, got in zip((st.first_fire, st.changed & ~st.first_fire),
                             dks.message_counts(dg, st)):
            exact = torch.where(fire, deg, 0).sum(dim=1).cpu().numpy()
            check(np.array_equal(got.cpu().numpy()[live],
                                 exact[live].astype(np.float32)),
                  f"message counts {got} != {exact} rounded to f32")
        total = torch.where(st.changed, deg, 0).sum(dim=1).cpu().numpy()
        rows.append(total[live])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = driver.lane_superstep(dg, st, cfg)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    for i, r in enumerate(batch):
        check(float(st.msgs_bfs[i]) == r.msgs_bfs and
              float(st.msgs_deep[i]) == r.msgs_deep,
              f"lane {i}: a second run counts other messages")
    largest = [int(x.max()) for x in rows]
    peak_step = int(np.argmax(largest))
    log(f"  largest per-superstep message count of a lane: {max(largest)} "
        f"(2^24 = {1 << 24}), at superstep {peak_step + 1}; lane-supersteps "
        f"past 2^24: {sum(int((x > 1 << 24).sum()) for x in rows)} of "
        f"{sum(len(x) for x in rows)}; per superstep, the largest "
        f"{largest}, host ms (synchronised) "
        f"{[round(x, 1) for x in step_ms]}")
    # The superstep with the most messages again, under the profiler.
    st = driver.lane_init(dg, kw, cfg)
    for _ in range(peak_step):
        st = driver.lane_superstep(dg, st, cfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        st = driver.lane_superstep(dg, st, cfg)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"  superstep {peak_step + 1} under torch.profiler: kernels busy "
        f"{busy:.3f} ms of {wall:.3f} ms wall, "
        f"{sum(e.count for e in kernels)} launches; top: " + "; ".join(
            f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms "
            f"x{e.count}" for e in kernels[:8]))


def bluk_extraction(eng, S_b, kw_b, twin: int) -> dict:
    """The bucket's extraction split on its final tables, the deadline
    path's cost per lane, ``batched_backtrace`` held against its plain
    version and timed; the twin's lanes extracted again from the
    ``"cuda"`` tables alone (their stats and rows fetched)."""
    from repro_torch.answers import BatchedBacktracer
    from repro_torch.answers.streaming import _host
    from repro_torch.core.reconstruct import HostScan
    from repro_torch.kernels.batched_backtrace import ops as bt_ops
    from repro_torch.kernels.batched_backtrace.ref import \
        batched_backtrace_ref

    bt = eng._backtracer()
    n = eng.n_nodes
    full = (1 << BUCKET_M) - 1
    flat = S_b[:, :, full, :].reshape(BUCKET_LANES, -1)
    sort_s = host_s(lambda: torch.sort(flat, dim=1, stable=True))
    del flat
    walk_s = host_s(lambda: bt._walk(S_b, kw_b, BUCKET_K, 4))
    parts = extraction_parts(bt, S_b, kw_b, list(range(BUCKET_LANES)), n)
    args = bt._walk_args(S_b, kw_b, BUCKET_K)[2]
    recs = bt_ops.batched_backtrace(*args)
    err = held_records(recs, batched_backtrace_ref(*args),
                       "bluk-bnb's final tables")
    times = (cuda_ms(lambda: bt_ops.batched_backtrace(*args), 5),
             once_ms(lambda: batched_backtrace_ref(*args)), None,
             *backtrace_bound(recs, BUCKET_M))
    log(f"  bucket extraction on its final tables (host clock, "
        f"synchronised): device {walk_s * 1e3:.1f} ms (stable sort of "
        f"{BUCKET_LANES} x {n * BUCKET_K} cells {sort_s * 1e3:.2f} ms, the "
        f"walk kernel, its records to the host); " + "; ".join(
            f"{name} {x}" for name, x in parts.items()))
    # What the deadline path (ExtractionOverlap) and query's host
    # collector pay per lane: a synchronous host copy of the table and a
    # host argsort of its full-set column.
    t0 = time.perf_counter()
    host0 = _host(S_b[0])
    copy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    HostScan(host0[:, full, :])
    argsort_s = time.perf_counter() - t0
    log(f"  a lane's table to the host as ExtractionOverlap takes it: "
        f"{S_b[0].numel() * 4} bytes in {copy_s * 1e3:.1f} ms; the host "
        f"collector's stable argsort of its {n * BUCKET_K} full-set cells "
        f"{argsort_s * 1e3:.1f} ms")
    bt_twin = BatchedBacktracer(eng.graph, device=S_b.device, backend="cuda")
    bt_twin.extract_lanes(S_b[:twin], kw_b[:twin], k=BUCKET_K, n_nodes=n)
    return {"err": err, "times": times,
            "twin": (bt_twin.stats(), bt_twin.rows_fetched)}


def bluk_combine(kw) -> tuple[float, tuple]:
    """``subset_combine`` on the bucket's ``init_state`` table against its
    plain version, and its times."""
    from repro_torch import INF
    from repro_torch.kernels.subset_combine import ops as sc_ops
    from repro_torch.kernels.subset_combine.ref import subset_combine_ref

    S = torch.full((BUCKET_LANES, kw.shape[2], 1 << BUCKET_M, BUCKET_K),
                   INF, device=kw.device)
    for i in range(BUCKET_M):
        S[:, :, 1 << i, 0] = torch.where(kw[:, i], 0.0, INF)
    got = sc_ops.subset_combine(S, BUCKET_M)
    want = subset_combine_ref(S, BUCKET_M)
    err = lanes_err(got, want)
    check(torch.equal(got, want), f"subset_combine != plain at bluk-bnb's "
                                  f"init_state table (max abs err {err})")
    del got, want
    return err, (cuda_ms(lambda: sc_ops.subset_combine(S, BUCKET_M), 5),
                 once_ms(lambda: subset_combine_ref(S, BUCKET_M)), None,
                 *combine_bound(S, BUCKET_M))


def bluk_lane(dg, kw, cfg) -> tuple[float, tuple]:
    """``lane_superstep`` on the bucket two supersteps in, lane 0 done,
    against its plain version, and its times."""
    from repro_torch.core import driver
    from repro_torch.kernels.lane_superstep import ops as ls_ops
    from repro_torch.kernels.lane_superstep.ref import fused_lane_step_ref

    st = driver.lane_init(dg, kw, cfg)
    for _ in range(2):
        st = driver.lane_superstep(dg, st, cfg)
    done = torch.zeros(BUCKET_LANES, dtype=torch.bool, device=kw.device)
    done[0] = True
    args = (st.S, st.changed, done, dg.in_offsets, dg.src, dg.w)
    del st
    got = ls_ops.fused_lane_step(*args, BUCKET_M, dg.hub_nodes)
    want = fused_lane_step_ref(*args, BUCKET_M)
    err = lanes_err(got, want)
    check(torch.equal(got, want), f"lane_superstep != plain at bluk-bnb's "
                                  f"mid-run state (max abs err {err})")
    del got, want
    return err, (cuda_ms(lambda: ls_ops.fused_lane_step(
        *args, BUCKET_M, dg.hub_nodes), 5),
        once_ms(lambda: fused_lane_step_ref(*args, BUCKET_M)), None,
        *lane_bound(*args))


def bluk_phase(dev) -> dict:
    """Phase 14: the DKS main path at bluk-bnb's full size on
    ``backend="cuda"``, phase 5's traffic, the three DKS kernels held
    against their plain versions at its shapes, a ``"torch"`` twin of the
    bucket's first ``BLUK_TWIN_LANES`` lanes and the first m = 4 query.
    Returns the launches, errors and times of the three kernels."""
    from repro_torch.configs import BLUK_BNB
    from repro_torch.core import dks
    from repro_torch.engine import ExecutionPolicy, QueryEngine
    from repro_torch.graph.generators import lod_like_graph
    from repro_torch.graph.index import InvertedIndex
    from repro_torch.kernels.batched_backtrace import ops as bt_ops
    from repro_torch.kernels.lane_superstep import ops as ls_ops
    from repro_torch.kernels.subset_combine import ops as sc_ops

    t_phase = time.perf_counter()
    cb = BLUK_BNB
    t0 = time.perf_counter()
    graph, tokens = lod_like_graph(cb.n_nodes, cb.n_edges, seed=cb.seed,
                                   vocab=cb.vocab, tau=cb.tau)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = InvertedIndex.from_token_matrix(tokens)
    index_s = time.perf_counter() - t0
    del tokens
    check(graph.n_nodes == cb.n_nodes, f"{cb.name}: {graph.n_nodes} nodes")
    qrng = np.random.default_rng(QUERY_SEED)
    bucket = draw_queries(graph, index, BUCKET_LANES, BUCKET_M, qrng)
    singles = draw_queries(graph, index, N_SINGLE, SINGLE_M, qrng)
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = QueryEngine.build(graph, index=index, device=dev,
                            policy=ExecutionPolicy(backend="cuda"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    dg = eng.device_graph
    log(f"  {cb.name}: {graph.n_nodes} nodes, {graph.n_edges_sym} symmetric "
        f"edges, largest degree {int(np.diff(graph.indptr).max())}, "
        f"{dg.hub_nodes.numel()} hubs; host: generated in "
        f"{gen_s * 1e3:.1f} ms, indexed in {index_s * 1e3:.1f} ms, engine "
        f"built in {build_s * 1e3:.1f} ms; device graph {device_bytes(dg)} "
        f"bytes ({gib(torch.cuda.memory_allocated() - mem0)} allocated); "
        f"bucket {bucket}, single queries {singles}")

    # ---- the main path, counted ----
    torch.cuda.reset_peak_memory_stats()
    for ops in (sc_ops, ls_ops, bt_ops):
        ops.counter.reset()
    t0 = time.perf_counter()
    batch = eng.query_batch(bucket, k=BUCKET_K, keep_state=True)
    t_batch = time.perf_counter() - t0
    bt = eng._backtracer()
    ext_bucket = (dict(eng.extraction_stats), bt.rows_fetched,
                  bt.table_copies)
    single = []
    for q in singles:
        t0 = time.perf_counter()
        single.append((eng.query(q, k=SINGLE_K), time.perf_counter() - t0))
    launches = {"subset_combine": sc_ops.launches,
                "lane_superstep": ls_ops.launches,
                "batched_backtrace": bt_ops.launches}
    peak = torch.cuda.max_memory_allocated()
    steps_batch = max(res.supersteps for res in batch)
    steps = steps_batch + sum(res.supersteps for res, _ in single)
    check(launches == {"subset_combine": 1 + N_SINGLE,
                       "lane_superstep": steps, "batched_backtrace": 1},
          f"{cb.name} launches {launches}, want subset_combine "
          f"{1 + N_SINGLE}, lane_superstep {steps}, batched_backtrace 1")
    check(bt.table_copies == 0, f"{bt.table_copies} lane tables copied")
    for res in batch + [res for res, _ in single]:
        check(res.found and len(res.answers) > 0,
              f"{cb.name}: no answer for {res.query}")
    # The final tables leave the results: the holds below need the room.
    S_b = torch.cat([res.state.S for res in batch])
    batch = [dataclasses.replace(res, state=None) for res in batch]
    log(f"[14/16] {cb.name} on backend=cuda: a bucket of {BUCKET_LANES} "
        f"(m={BUCKET_M}, k={BUCKET_K}) and {N_SINGLE} queries (m="
        f"{SINGLE_M}, k={SINGLE_K}); launches {launches}; peak device "
        f"memory {gib(peak)}")
    drv = batch[0].wall_time_s * 1e3
    log(f"  bucket: {steps_batch} supersteps, lanes "
        f"{[res.supersteps for res in batch]}, best weights "
        f"{[float(res.weights[0]) for res in batch]}; {t_batch * 1e3:.1f} "
        f"ms = driver {drv:.1f} ms ({drv / steps_batch:.2f} ms per "
        f"superstep) + extraction {t_batch * 1e3 - drv:.1f} ms; "
        f"extraction_stats {ext_bucket[0]}, rows fetched {ext_bucket[1]}, "
        f"lane tables copied {ext_bucket[2]}; msgs_bfs + msgs_deep per "
        f"lane {[res.msgs_bfs + res.msgs_deep for res in batch]}")
    for res, t in single:
        drv = res.wall_time_s * 1e3
        log(f"  query {list(res.query)}: {res.supersteps} supersteps, "
            f"weights {res.weights.tolist()}; {t * 1e3:.1f} ms = driver "
            f"{drv:.1f} ms ({drv / res.supersteps:.2f} ms per superstep) + "
            f"host collector {t * 1e3 - drv:.1f} ms; msgs_bfs + msgs_deep "
            f"{res.msgs_bfs + res.msgs_deep}")

    kw_b = torch.from_numpy(np.stack([index.keyword_masks(
        q, graph.n_nodes, v_pad=dg.v_pad) for q in bucket])).to(dev)
    twin = BLUK_TWIN_LANES
    ext = bluk_extraction(eng, S_b, kw_b, twin)
    del S_b
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  device memory held before the kernel holds: "
        f"{gib(torch.cuda.memory_allocated())}")
    cfg = dks.DKSConfig(m=BUCKET_M, k=BUCKET_K, backend="cuda")
    bluk_counts(dg, kw_b, cfg, batch)
    torch.cuda.empty_cache()
    errs, timing = {"batched_backtrace": ext["err"]}, \
        {"batched_backtrace": ext["times"]}
    errs["subset_combine"], timing["subset_combine"] = bluk_combine(kw_b)
    torch.cuda.empty_cache()
    errs["lane_superstep"], timing["lane_superstep"] = bluk_lane(dg, kw_b,
                                                                 cfg)
    torch.cuda.empty_cache()
    for name, (ms, plain, _, bound, by) in timing.items():
        log(f"  {name} at {cb.name}'s shape: {ms} ms (plain {plain} ms, "
            f"bound {bound} ms by {by}), == plain")

    # ---- the "torch" twin: the bucket's first lanes, the first query ----
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    twin_eng = QueryEngine(eng.graph, index, ExecutionPolicy(backend="torch"),
                           dg)
    got = twin_eng.query_batch(bucket[:twin], k=BUCKET_K)
    t_twin_b = time.perf_counter() - t0
    for i, (rc, rt) in enumerate(zip(batch, got)):
        same_results(rc, rt, f"{cb.name} bucket lane {i} vs torch twin")
    check(twin_eng.extraction_stats == ext["twin"][0] and
          twin_eng._backtracer().rows_fetched == ext["twin"][1],
          f"{cb.name} twin extraction {twin_eng.extraction_stats} != "
          f"{ext['twin']}")
    t0 = time.perf_counter()
    same_results(single[0][0], twin_eng.query(singles[0], k=SINGLE_K),
                 f"{cb.name} query 0 vs torch twin")
    t_twin_q = time.perf_counter() - t0
    log(f"  backend=torch twin == backend=cuda: bucket lanes 0..{twin - 1} "
        f"(weights, roots, supersteps, messages, flags, trees, "
        f"extraction_stats {ext['twin'][0]}, rows fetched {ext['twin'][1]}) "
        f"in {t_twin_b:.1f} s ({t_twin_b / batch[0].supersteps:.1f} s a "
        f"superstep with extraction), query 0 in {t_twin_q:.1f} s; peak "
        f"device memory {gib(torch.cuda.max_memory_allocated())}")
    log(f"  the phase took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "errs": errs, "timing": timing}


def gnn_full_graph(shape, n_classes: int, seed: int) -> dict:
    """A random graph of ``shape``'s published size, its features
    correlated with its labels (as ``examples/gnn_train.py``'s cora-like
    graph), made in bulk with numpy: ``GraphBatch`` fields."""
    rng = np.random.default_rng(seed)
    n, e, d = shape.n_nodes, shape.n_edges, shape.d_feat
    labels = rng.integers(0, n_classes, n)
    centers = rng.standard_normal((n_classes, d), dtype=np.float32)
    x = centers[labels]
    x += 0.5 * rng.standard_normal((n, d), dtype=np.float32)
    return {"x": x, "edge_src": rng.integers(0, n, e),
            "edge_dst": rng.integers(0, n, e), "node_mask": np.ones(n, bool),
            "edge_mask": np.ones(e, bool), "labels": labels.astype(np.int32),
            "graph_ids": np.zeros(n, np.int64),
            "positions": np.zeros((n, 3), np.float32), "n_graphs": 1}


def gnn_molecules(shape, family: str, n_classes: int, seed: int) -> dict:
    """``shape.batch_graphs`` molecules of ``n_nodes`` atoms and
    ``n_edges`` random in-molecule edges, atom types 1..9 in column 0 of x
    (SchNet's input) and positions (as ``examples/gnn_train.py``'s
    molecules); SchNet's label is 0.1 x the sum of the atom types, the
    others' a class their features are correlated with."""
    rng = np.random.default_rng(seed)
    g, atoms, per = shape.batch_graphs, shape.n_nodes, shape.n_edges
    n = g * atoms
    base = np.repeat(np.arange(g) * atoms, per)
    z = rng.integers(1, 10, n)
    y = rng.integers(0, n_classes, g)
    centers = rng.standard_normal((n_classes, shape.d_feat), dtype=np.float32)
    x = centers[np.repeat(y, atoms)]
    x += 0.5 * rng.standard_normal(x.shape, dtype=np.float32)
    x[:, 0] = z
    labels = (np.bincount(np.repeat(np.arange(g), atoms), weights=z) * 0.1
              if family == "schnet" else y)
    return {"x": x, "edge_src": base + rng.integers(0, atoms, g * per),
            "edge_dst": base + rng.integers(0, atoms, g * per),
            "node_mask": np.ones(n, bool), "edge_mask": np.ones(g * per, bool),
            "labels": labels.astype(np.float32 if family == "schnet"
                                    else np.int32),
            "graph_ids": np.repeat(np.arange(g), atoms),
            "positions": rng.normal(size=(n, 3)) * 2, "n_graphs": g}


def gnn_home_fields(arch: str, seed: int) -> dict:
    """``arch``'s home shape (``GNN_HOME``) at its published size."""
    from repro_torch.configs import GNN_SHAPES, get_arch

    cfg = get_arch(arch)
    shape = {s.name: s for s in GNN_SHAPES}[GNN_HOME[arch]]
    if shape.kind == "molecule":
        return gnn_molecules(shape, cfg.family, cfg.n_classes, seed)
    return gnn_full_graph(shape, cfg.n_classes, seed)


def gnn_card_vs_cpu(dev, card: str) -> None:
    """Leg 1: each arch on its home shape, f32, one train step on the card
    and on the CPU from the same weights (a seeded CUDA generator) and
    batch: the step's loss and grad_norm within ``GNN_TOL`` relative, every
    gradient leaf within ``GNN_TOL`` of its largest magnitude."""
    from repro_torch import interop
    from repro_torch.configs import get_arch
    from repro_torch.models import gnn as gnn_lib
    from repro_torch.optim import AdamWConfig, adamw_init, tree_map

    for arch in GNN_ARCHS:
        cfg = get_arch(arch)
        fields = gnn_home_fields(arch, GNN_SEED)
        params = gnn_lib.init_gnn(torch.Generator(dev).manual_seed(GNN_SEED),
                                  cfg, d_in=fields["x"].shape[1])
        out = {}
        for d in ("cpu", dev):
            p = tree_map(lambda t: t.to(d, copy=True), params)
            batch = interop.graph_batch_from_numpy(fields, d)
            _, _, m = gnn_lib.gnn_train_step(p, adamw_init(p), batch, cfg,
                                             AdamWConfig(**GNN_OPT))
            out[str(d)] = {k: ([g.cpu() for g in v] if k == "grads"
                               else v.cpu()) for k, v in m.items()}
        m_c, m_d = out["cpu"], out[str(dev)]
        for what in ("loss", "grad_norm"):
            a, b = m_d[what], m_c[what]
            rel = abs(float(a) - float(b)) / abs(float(b))
            check(rel <= GNN_TOL, f"{arch} f32 {what}: card {float(a)} cpu "
                  f"{float(b)} ({rel:.3g} relative > {GNN_TOL})")
        worst = 0.0
        for i, (a, b) in enumerate(zip(m_d["grads"], m_c["grads"],
                                       strict=True)):
            err = max_abs_err(a, b) / max(float(b.abs().max()), 1e-30)
            worst = max(worst, err)
            check(err <= GNN_TOL, f"{arch} f32 gradient leaf {i}: {err:.3g} "
                  f"of its largest magnitude > {GNN_TOL}")
        log(f"  {arch} on {GNN_HOME[arch]} (f32): card == CPU within "
            f"{GNN_TOL}: loss {float(m_d['loss']):.6f} / "
            f"{float(m_c['loss']):.6f}, grad_norm "
            f"{float(m_d['grad_norm']):.6f} / {float(m_c['grad_norm']):.6f}, "
            f"worst gradient leaf {worst:.3g} of its largest [{card}]")


def gnn_timed_steps(params, opt, batch, cfg, steps: int) -> tuple:
    """``steps`` train steps; each one's loss and host ms (ended by a
    synchronize)."""
    from repro_torch.models import gnn as gnn_lib
    from repro_torch.optim import AdamWConfig

    losses, ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, opt, m = gnn_lib.gnn_train_step(params, opt, batch, cfg,
                                                AdamWConfig(**GNN_OPT))
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
    check(all(np.isfinite(losses)), f"{cfg.name}: losses {losses}")
    return params, opt, losses, ms


def gnn_bf16_train(dev, card: str) -> None:
    """Leg 2: the four archs on their home shapes at ``mp_dtype="bfloat16"``
    (``repro``'s production cells), ``GNN_BF16_STEPS`` AdamW steps each at
    ``examples/gnn_train.py``'s schedule: the last loss below the first;
    ms a step (median of the last 8) and peak memory."""
    from repro_torch import interop
    from repro_torch.configs import get_arch
    from repro_torch.models import gnn as gnn_lib
    from repro_torch.optim import adamw_init

    for arch in GNN_ARCHS:
        cfg = dataclasses.replace(get_arch(arch), mp_dtype="bfloat16")
        fields = gnn_home_fields(arch, GNN_SEED + 1)
        batch = interop.graph_batch_from_numpy(fields, dev)
        params = gnn_lib.init_gnn(torch.Generator(dev).manual_seed(GNN_SEED),
                                  cfg, d_in=fields["x"].shape[1])
        torch.cuda.reset_peak_memory_stats()
        _, _, losses, ms = gnn_timed_steps(params, adamw_init(params), batch,
                                           cfg, GNN_BF16_STEPS)
        check(losses[-1] < losses[0], f"{arch} bf16: loss {losses[0]} -> "
              f"{losses[-1]} did not fall")
        log(f"  {arch} on {GNN_HOME[arch]} (bf16), {GNN_BF16_STEPS} steps: "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
            f"{float(np.median(ms[-8:])):.3f} ms a step (median of the last "
            f"8; first {ms[0]:.1f} ms); peak "
            f"{gib(torch.cuda.max_memory_allocated())} [{card}]")


def gnn_step_split(step, what: str, card: str) -> None:
    """One call of ``step`` under torch.profiler: the top device ops and
    kernel-busy time against the profiled wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy == 0:
        log(f"  {what}: device time not measured (the profiler saw no "
            f"kernel)")
        return
    top = "; ".join(f"{e.key[:70]} {e.self_device_time_total / 1e3:.3f} ms "
                    f"x{e.count}" for e in kernels[:8])
    log(f"  {what} under torch.profiler: kernels busy {busy:.3f} ms of "
        f"{wall:.3f} ms wall ({100 * busy / wall:.1f} %), "
        f"{sum(e.count for e in kernels)} kernel launches [{card}]; top: "
        f"{top}")


def gnn_logit_gap(params, batch, cfg) -> float:
    """The relative (L2) gap between the logits of a bf16 and an f32
    forward from the same weights and batch, under ``no_grad``."""
    from repro_torch.models import gnn as gnn_lib

    with torch.no_grad():
        a, b = (gnn_lib.gnn_forward(params, batch, dataclasses.replace(
            cfg, mp_dtype=mp)) for mp in ("bfloat16", "float32"))
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b))


def gnn_ogb(dev, card: str) -> None:
    """Legs 3 and 4: ogb_products at full size (2,449,029 nodes,
    61,859,140 edges, 100 features, nothing cut), bf16.  gin-tu:
    ``GNN_OGB_STEPS`` train steps, the first step's loss within
    ``GNN_LOSS_BOUND`` (relative) of an f32 forward's from the same
    weights and batch, one step under the profiler.  pna: the loss under
    ``no_grad`` in bf16 and f32 through the chunked aggregate (4 chunks),
    then one train step.  Each holds its bf16 logits within
    ``GNN_LOGIT_BOUND`` of the f32 ones (:func:`gnn_logit_gap`)."""
    from repro_torch import interop
    from repro_torch.configs import GIN_TU, GNN_SHAPES, PNA
    from repro_torch.models import gnn as gnn_lib
    from repro_torch.optim import AdamWConfig, adamw_init

    shape = {s.name: s for s in GNN_SHAPES}["ogb_products"]
    t0 = time.perf_counter()
    fields = gnn_full_graph(shape, PNA.n_classes, GNN_SEED + 2)
    gen_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    batch = interop.graph_batch_from_numpy(fields, dev)
    torch.cuda.synchronize()
    put_ms = (time.perf_counter() - t0) * 1e3
    del fields
    n, e = batch.x.shape[0], batch.edge_src.shape[0]
    check((n, e) == (shape.n_nodes, shape.n_edges), f"ogb_products {n}, {e}")
    log(f"  ogb_products: {n} nodes, {e} edges, {batch.x.shape[1]} features; "
        f"made on the host in {gen_ms:.1f} ms, to the card in {put_ms:.1f} "
        f"ms; the batch holds {device_bytes(batch)} device bytes")

    cfg = dataclasses.replace(GIN_TU, mp_dtype="bfloat16")
    params = gnn_lib.init_gnn(torch.Generator(dev).manual_seed(GNN_SEED),
                              cfg, d_in=shape.d_feat)
    with torch.no_grad():
        f32_loss = float(gnn_lib.gnn_loss(
            params, batch, dataclasses.replace(cfg, mp_dtype="float32")))
    gap = gnn_logit_gap(params, batch, cfg)
    check(gap <= GNN_LOGIT_BOUND, f"gin-tu ogb_products: bf16 "
          f"logits {gap:.4f} from f32's > {GNN_LOGIT_BOUND}")
    torch.cuda.reset_peak_memory_stats()
    params, opt, losses, ms = gnn_timed_steps(params, adamw_init(params),
                                              batch, cfg, GNN_OGB_STEPS)
    peak = torch.cuda.max_memory_allocated()
    rel = abs(losses[0] - f32_loss) / abs(f32_loss)
    check(rel <= GNN_LOSS_BOUND, f"gin-tu ogb_products: bf16 loss "
          f"{losses[0]} against f32 {f32_loss}: {rel:.4f} > {GNN_LOSS_BOUND}")
    log(f"  gin-tu on ogb_products (bf16), {GNN_OGB_STEPS} steps: loss "
        f"{' '.join(f'{x:.4f}' for x in losses)}; ms a step "
        f"{' '.join(f'{x:.1f}' for x in ms)} "
        f"({(n + e) / (float(np.median(ms[1:])) / 1e3):.4g} nodes+edges/s at "
        f"the median of steps 2-{GNN_OGB_STEPS}); peak {gib(peak)}; the "
        f"first loss against an f32 forward's {f32_loss:.4f}: {rel:.4f} "
        f"relative (bound {GNN_LOSS_BOUND}); the bf16 logits {gap:.4f} "
        f"from f32's (bound {GNN_LOGIT_BOUND}) [{card}]")
    gnn_step_split(lambda: gnn_lib.gnn_train_step(
        params, opt, batch, cfg, AdamWConfig(**GNN_OPT)),
        "a gin-tu ogb_products step", card)
    del params, opt
    gc.collect()
    torch.cuda.empty_cache()

    cfg = dataclasses.replace(PNA, mp_dtype="bfloat16")
    nc = gnn_lib.pna_chunks(e)
    check(nc == 4 and e % nc == 0, f"pna at {e} edges takes {nc} chunks")
    params = gnn_lib.init_gnn(torch.Generator(dev).manual_seed(GNN_SEED),
                              cfg, d_in=shape.d_feat)
    got = {}
    for mp in ("bfloat16", "float32"):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with torch.no_grad():
            loss = float(gnn_lib.gnn_loss(
                params, batch, dataclasses.replace(cfg, mp_dtype=mp)))
        torch.cuda.synchronize()
        got[mp] = (loss, (time.perf_counter() - t0) * 1e3,
                   torch.cuda.max_memory_allocated())
        check(np.isfinite(loss), f"pna ogb_products {mp} loss {loss}")
    gap = gnn_logit_gap(params, batch, cfg)
    check(gap <= GNN_LOGIT_BOUND, f"pna ogb_products: bf16 logits "
          f"{gap:.4f} from f32's > {GNN_LOGIT_BOUND}")
    log(f"  pna on ogb_products, no_grad, {nc} edge chunks of {e // nc}: "
        + "; ".join(f"{mp} loss {v[0]:.4f} in {v[1]:.1f} ms, peak "
                    f"{gib(v[2])}" for mp, v in got.items())
        + f"; the bf16 logits {gap:.4f} from f32's (bound "
        f"{GNN_LOGIT_BOUND}) [{card}]")
    torch.cuda.reset_peak_memory_stats()
    _, _, losses, ms = gnn_timed_steps(params, adamw_init(params), batch,
                                       cfg, 1)
    log(f"  pna on ogb_products (bf16), one train step: loss {losses[0]:.4f} "
        f"in {ms[0]:.1f} ms; peak "
        f"{gib(torch.cuda.max_memory_allocated())} [{card}]")


def gnn_minibatch(dev, card: str) -> None:
    """Leg 5: ``minibatch_lg`` x gat-cora, bf16: a reddit-size host graph
    (232,965 nodes; 57,307,946 random directed edges, weights given, so
    ``build_graph``'s CSR holds about 114.6 M entries), 1,024 seeds
    sampled at fanout (15, 10), their features gathered to the card,
    ``GNN_SAMPLE_STEPS`` train steps on the seeds' labels."""
    from repro_torch import interop
    from repro_torch.configs import GAT_CORA, GNN_SHAPES
    from repro_torch.graph.sampler import plan_sizes, sample_subgraph
    from repro_torch.graph.structure import build_graph
    from repro_torch.models import gnn as gnn_lib
    from repro_torch.optim import adamw_init

    shape = {s.name: s for s in GNN_SHAPES}["minibatch_lg"]
    rng = np.random.default_rng(GNN_SEED + 3)
    n, m = shape.n_nodes, shape.n_edges // 2
    src = rng.integers(0, n, m, dtype=np.int32)
    dst = rng.integers(0, n, m, dtype=np.int32)
    t0 = time.perf_counter()
    g = build_graph(src, dst, n, w=np.ones(m, np.float32))
    build_ms = (time.perf_counter() - t0) * 1e3
    del src, dst
    labels = rng.integers(0, GAT_CORA.n_classes, n)
    centers = rng.standard_normal((GAT_CORA.n_classes, shape.d_feat),
                                  dtype=np.float32)
    feats = centers[labels]
    feats += 0.5 * rng.standard_normal(feats.shape, dtype=np.float32)
    seeds = rng.choice(n, shape.batch_nodes, replace=False).astype(np.int32)
    t0 = time.perf_counter()
    sub = sample_subgraph(g, seeds, list(shape.fanout), seed=GNN_SEED)
    sample_ms = (time.perf_counter() - t0) * 1e3
    want = plan_sizes(shape.batch_nodes, list(shape.fanout))
    check((sub.n_sub, len(sub.edge_src)) == want,
          f"sample of {sub.n_sub} nodes, {len(sub.edge_src)} edges, not {want}")
    node_mask = np.zeros(sub.n_sub, bool)
    node_mask[:sub.seed_count] = True
    t0 = time.perf_counter()
    batch = interop.graph_batch_from_numpy({
        "x": feats[sub.node_ids], "edge_src": sub.edge_src,
        "edge_dst": sub.edge_dst, "node_mask": node_mask,
        "edge_mask": sub.edge_valid,
        "labels": labels[sub.node_ids].astype(np.int32),
        "graph_ids": np.zeros(sub.n_sub, np.int64),
        "positions": np.zeros((sub.n_sub, 3), np.float32), "n_graphs": 1},
        dev)
    torch.cuda.synchronize()
    put_ms = (time.perf_counter() - t0) * 1e3
    cfg = dataclasses.replace(GAT_CORA, mp_dtype="bfloat16")
    params = gnn_lib.init_gnn(torch.Generator(dev).manual_seed(GNN_SEED),
                              cfg, d_in=shape.d_feat)
    torch.cuda.reset_peak_memory_stats()
    _, _, losses, ms = gnn_timed_steps(params, adamw_init(params), batch,
                                       cfg, GNN_SAMPLE_STEPS)
    check(losses[-1] < losses[0], f"gat-cora minibatch: loss {losses[0]} -> "
          f"{losses[-1]} did not fall")
    log(f"  minibatch_lg: host graph of {g.n_nodes} nodes, {len(g.indices)} "
        f"CSR entries built in {build_ms:.1f} ms; {shape.batch_nodes} seeds "
        f"at fanout {shape.fanout} sampled in {sample_ms:.1f} ms "
        f"({sub.n_sub} node slots, {int(sub.node_valid.sum())} valid; "
        f"{len(sub.edge_src)} edge slots, {int(sub.edge_valid.sum())} "
        f"valid); features gathered and put on the card in {put_ms:.1f} ms "
        f"({device_bytes(batch)} device bytes)")
    log(f"  gat-cora on the sample (bf16), {GNN_SAMPLE_STEPS} steps: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"{float(np.median(ms[-4:])):.3f} ms a step (median of the last 4; "
        f"first {ms[0]:.1f}); peak "
        f"{gib(torch.cuda.max_memory_allocated())} [{card}]")


def gnn_phase(dev, card: str) -> None:
    """Phase 15: the GNN family trained on the card (legs 1-5).  Each leg
    runs in a function of its own, so its tensors die with it."""
    t_phase = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for leg in (gnn_card_vs_cpu, gnn_bf16_train, gnn_ogb, gnn_minibatch):
            leg(dev, card)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    log(f"  the phase took {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    # ---------------- 1. device ----------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root / "src"))
    from repro_torch import INF  # fails outside a checkout of the repo
    from repro_torch.configs import SEC_RDFABOUT
    from repro_torch.core import dks, driver
    from repro_torch.core.steiner_ref import dreyfus_wagner
    from repro_torch.engine import ExecutionPolicy, QueryEngine
    from repro_torch.graph.generators import (lod_like_graph,
                                              random_weighted_graph)
    from repro_torch.graph.index import InvertedIndex
    from repro_torch.graph.structure import HUB_IN_DEGREE
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.lane_superstep import ops as ls_ops
    from repro_torch.kernels.lane_superstep.ref import fused_lane_step_ref
    from repro_torch.kernels.subset_combine import ops as sc_ops
    from repro_torch.kernels.subset_combine.ref import subset_combine_ref
    from repro_torch.answers import BatchedBacktracer
    from repro_torch.kernels.batched_backtrace import ops as bt_ops
    from repro_torch.kernels.batched_backtrace.ref import \
        batched_backtrace_ref
    from repro_torch.kernels.segment_minplus import ops as sm_ops
    from repro_torch.kernels.segment_minplus.ref import padded_topk_ref

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    log(f"[1/16] device: {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {card}")

    # ---------------- 2. build ----------------
    t0 = time.perf_counter()
    build = cuda_build.build_all()
    log(f"[2/16] built {sorted(build)} in {time.perf_counter() - t0:.1f} s")
    for name, info in sorted(build.items()):
        entry = ""
        for line in info["log"].splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "registers" in line or "spill" in line or "error" in line:
                log(f"  {name} {entry[:64]}: {line.strip()}")
    flash_so = str(cuda_build.lib_path("flash_attention"))
    sass = subprocess.run([str(Path(cuda_build.nvcc_path()).parent
                               / "cuobjdump"), "-sass", flash_so],
                          capture_output=True, text=True, check=True).stdout
    counts = {op: sass.count(op) for op in ("HGMMA", "UTMALDG")}
    check(all(counts.values()), f"flash_attention's SASS lacks {counts}")
    log(f"  flash_attention SASS (cuobjdump): {counts}")

    # ---------------- 3. kernels vs plain ----------------
    errs = {"subset_combine": 0.0, "lane_superstep": 0.0,
            "padded_topk": 0.0, "batched_backtrace": 0.0}

    def held(name, got, want, what):
        err = max_abs_err(got, want)
        errs[name] = max(errs[name], err)
        check(torch.equal(got, want), f"{name} != plain at {what} "
                                      f"(max abs err {err})")

    # Up to m = 6 keywords and K = 8 slots, the kernels' range.
    for m, k in ((1, 3), (2, 1), (3, 2), (3, 3), (4, 2), (4, 4), (5, 2),
                 (5, 4), (6, 1), (6, 4), (6, 8), (3, 5), (2, 6), (4, 7),
                 (5, 8)):
        S = sorted_unique_tables((3, 1001), m, k, seed=10 * m + k, device=dev)
        held("subset_combine", sc_ops.subset_combine(S, m),
             subset_combine_ref(S, m), f"m={m} k={k}")
    g_small, _ = lod_like_graph(200, 2000, seed=5, vocab=40)
    dg_small = g_small.to_device(dev)
    rng = np.random.default_rng(0)
    for m, k in ((1, 2), (2, 2), (3, 3), (4, 2), (5, 4), (6, 3), (6, 8),
                 (2, 5), (4, 7)):
        cfg = dks.DKSConfig(m=m, k=k)
        masks = torch.from_numpy(rng.random((3, m, dg_small.v_pad)) < 0.03)
        st = dks.superstep(dg_small, driver.lane_init(
            dg_small, masks.to(dev), cfg), cfg)
        done = torch.tensor([True, False, False], device=dev)
        args = (st.S, st.changed, done, dg_small.in_offsets, dg_small.src,
                dg_small.w)
        held("lane_superstep",
             ls_ops.fused_lane_step(*args, m, dg_small.hub_nodes),
             fused_lane_step_ref(*args, m), f"small graph m={m} k={k}")
    for vv, c, f, k in ((64, 40, 8, 2), (64, 40, 8, 5), (33, 64, 16, 6),
                        (17, 9, 64, 7), (100, 128, 8, 8)):
        r = np.random.default_rng(vv + c + k)
        cand = r.integers(1, 30, size=(vv, c, f)).astype(np.float32)
        cand[r.random(cand.shape) > 0.6] = INF
        cand = torch.from_numpy(cand).to(dev)
        held("padded_topk", sm_ops.padded_topk(cand, k),
             padded_topk_ref(cand, k), f"cand {[vv, c, f]} k={k}")
    # The backtrace walk on final tables of random buckets (lane 0 has a
    # keyword on no node: every candidate INF), stragglers under TIGHT.
    for m, k, caps in ((2, 1, {}), (3, 3, {}), (4, 2, {}), (6, 1, {}),
                       (2, 5, {}), (3, 8, {}), (3, 3, TIGHT), (6, 2, TIGHT)):
        masks = rng.random((4, m, dg_small.v_pad)) < 0.05
        masks[:, :, g_small.n_nodes:] = False
        masks[0, 0] = False
        kw = torch.from_numpy(masks).to(dev)
        st = driver.run_lanes(dg_small, kw, dks.DKSConfig(
            m=m, k=k, max_supersteps=32))
        bt = BatchedBacktracer(g_small, device=dev, **caps)
        args = bt._walk_args(st.S.contiguous(), kw, k)[2]
        got = bt_ops.batched_backtrace(*args)
        torch.cuda.synchronize()
        errs["batched_backtrace"] = max(
            errs["batched_backtrace"],
            held_records(got, batched_backtrace_ref(*args),
                         f"small graph m={m} k={k} {caps}"))
    log("[3/16] kernels == plain versions at small shapes (DKS kernels to "
        "m=6, K=8; the backtrace walk on 8 random buckets)")

    t0 = time.perf_counter()
    cfg_sec = SEC_RDFABOUT
    graph, tokens = lod_like_graph(cfg_sec.n_nodes, cfg_sec.n_edges,
                                   seed=cfg_sec.seed, vocab=cfg_sec.vocab,
                                   tau=cfg_sec.tau)
    index = InvertedIndex.from_token_matrix(tokens)
    qrng = np.random.default_rng(QUERY_SEED)
    bucket = draw_queries(graph, index, BUCKET_LANES, BUCKET_M, qrng)
    singles = draw_queries(graph, index, N_SINGLE, SINGLE_M, qrng)
    log(f"  {cfg_sec.name}: {graph.n_nodes} nodes, {graph.n_edges_sym} "
        f"symmetric edges, built on the host in "
        f"{time.perf_counter() - t0:.1f} s; bucket {bucket}, single "
        f"queries {singles}")
    dg = graph.to_device(dev)
    masks = torch.from_numpy(np.stack([index.keyword_masks(
        q, graph.n_nodes, v_pad=dg.v_pad) for q in bucket])).to(dev)
    cfg = dks.DKSConfig(m=BUCKET_M, k=BUCKET_K)
    # subset_combine on exactly the table init_state hands it.
    S_pre = torch.full((BUCKET_LANES, dg.v_pad, 1 << BUCKET_M, BUCKET_K),
                       INF, device=dev)
    for i in range(BUCKET_M):
        S_pre[:, :, 1 << i, 0] = torch.where(masks[:, i], 0.0, INF)
    held("subset_combine", sc_ops.subset_combine(S_pre, BUCKET_M),
         subset_combine_ref(S_pre, BUCKET_M), "main path shape")
    # lane_superstep on a real mid-run state (two supersteps in), lane 0 done.
    st = driver.lane_init(dg, masks, cfg)
    for _ in range(2):
        st = dks.superstep(dg, st, cfg)
    done = torch.zeros(BUCKET_LANES, dtype=torch.bool, device=dev)
    done[0] = True
    ls_args = (st.S, st.changed, done, dg.in_offsets, dg.src, dg.w)
    ls_out = ls_ops.fused_lane_step(*ls_args, BUCKET_M, dg.hub_nodes)
    held("lane_superstep", ls_out, fused_lane_step_ref(*ls_args, BUCKET_M),
         "main path shape")
    log(f"  lane_superstep: {dg.hub_nodes.numel()} hubs (nodes of more than "
        f"HUB_IN_DEGREE = {HUB_IN_DEGREE} in-edges, one warp per lane and "
        f"hub) of {dg.n_nodes} nodes")
    # name -> (ms, plain ms, library ms or None, bound ms, bound by); no
    # single PyTorch call computes either DKS function.
    timing = {
        "subset_combine": (
            cuda_ms(lambda: sc_ops.subset_combine(S_pre, BUCKET_M), 20),
            cuda_ms(lambda: subset_combine_ref(S_pre, BUCKET_M), 3), None,
            *combine_bound(S_pre, BUCKET_M)),
        "lane_superstep": (
            cuda_ms(lambda: ls_ops.fused_lane_step(*ls_args, BUCKET_M,
                                                   dg.hub_nodes), 20),
            cuda_ms(lambda: fused_lane_step_ref(*ls_args, BUCKET_M), 3), None,
            *lane_bound(*ls_args)),
    }
    for name, (ms, plain, _, bound, by) in timing.items():
        log(f"  {name}: {ms} ms (plain {plain} ms, bound {bound} ms by {by})")
    parts, figures = lane_breakdown(dg, st.S, st.changed, done, BUCKET_M,
                                    ls_out, ls_ops.fused_lane_step,
                                    ls_ops.hub_nodes)
    log("  lane_superstep on cut inputs (timing only): " + "; ".join(
        f"{what} {ms} ms" for what, ms in parts.items()))
    log("  lane_superstep inputs: " + "; ".join(
        f"{what} {x}" for what, x in figures.items()))
    del st, ls_args, ls_out, S_pre
    log("[3/16] kernels == plain versions at the main path's shapes")

    # ---------------- 4. oracle ----------------
    for seed in range(6):
        r = np.random.default_rng(seed)
        n = int(r.integers(6, 14))
        g = random_weighted_graph(n, n + int(r.integers(0, 8)), seed=seed)
        m = int(r.integers(2, 5))
        groups = [np.sort(r.choice(n, size=int(r.integers(1, 3)),
                                   replace=False)) for _ in range(m)]
        offs = np.concatenate([[0], np.cumsum([len(x) for x in groups])])
        idx = InvertedIndex.from_postings(
            list(range(m)), offs, np.concatenate(groups).astype(np.int32))
        eng = QueryEngine.build(g, index=idx,
                                policy=ExecutionPolicy(backend="cuda"))
        got = eng.query(list(range(m)), k=2)
        want = dreyfus_wagner(g, groups)
        check(abs(got.best_weight - want) <= 1e-3,
              f"oracle seed {seed}: engine {got.best_weight} vs DW {want}")
    log("[4/16] top-1 weights == Dreyfus-Wagner on 6 random graphs")

    # ---------------- 5. main path ----------------
    del dg, masks
    engines = {b: QueryEngine.build(graph, index=index,
                                    policy=ExecutionPolicy(backend=b))
               for b in ("cuda", "torch")}
    runs = {}
    for b, eng in engines.items():
        if b == "cuda":
            for ops in (sc_ops, ls_ops, bt_ops):
                ops.counter.reset()
        t0 = time.perf_counter()
        batch = eng.query_batch(bucket, k=BUCKET_K, keep_state=b == "cuda")
        t_batch = time.perf_counter() - t0
        single = []
        for q in singles:
            t0 = time.perf_counter()
            single.append((eng.query(q, k=SINGLE_K),
                           time.perf_counter() - t0))
        if b == "cuda":
            launches = {"subset_combine": sc_ops.launches,
                        "lane_superstep": ls_ops.launches,
                        "batched_backtrace": bt_ops.launches}
        runs[b] = (batch, t_batch, single)
    batch, t_batch, single = runs["cuda"]
    steps_batch = max(r.supersteps for r in batch)
    steps = steps_batch + sum(r.supersteps for r, _ in single)
    check(launches["subset_combine"] == 1 + N_SINGLE,
          f"subset_combine launched {launches['subset_combine']} times, "
          f"want once per bucket ({1 + N_SINGLE})")
    check(launches["lane_superstep"] == steps,
          f"lane_superstep launched {launches['lane_superstep']} times, "
          f"want once per superstep ({steps})")
    check(launches["batched_backtrace"] == 1,
          f"batched_backtrace launched {launches['batched_backtrace']} "
          f"times, want once per bucket (1)")
    stats = {b: eng.extraction_stats for b, eng in engines.items()}
    check(stats["cuda"] == stats["torch"] and
          stats["cuda"]["device_resolved"] > 0,
          f"extraction_stats differ or resolved nothing: {stats}")
    for i, (rc, rt) in enumerate(zip(batch, runs["torch"][0])):
        same_results(rc, rt, f"bucket lane {i}")
    for i, ((rc, _), (rt, _)) in enumerate(zip(single, runs["torch"][2])):
        same_results(rc, rt, f"single query {i}")
    for r in batch + [r for r, _ in single]:
        check(r.found and len(r.answers) > 0, f"no answer for {r.query}")
    # Phase 10 holds an artifact-built engine to these, state dropped.
    phase5 = [dataclasses.replace(r, state=None) for r in batch] + [
        r for r, _ in single]
    log(f"[5/16] {cfg_sec.name} on backend=cuda == backend=torch: weights, "
        f"roots, supersteps, messages, flags, answer trees")

    def split(res, total_s, steps):
        """total / driver (init + supersteps, synchronised) / host answer
        extraction, in ms, and driver ms per superstep."""
        drv = res.wall_time_s * 1e3
        return (f"{total_s * 1e3:.1f} ms = driver {drv:.1f} ms "
                f"({drv / steps:.2f} ms per superstep) + extraction "
                f"{total_s * 1e3 - drv:.1f} ms")

    log(f"  bucket of {BUCKET_LANES} (m={BUCKET_M}, k={BUCKET_K}): "
        f"{steps_batch} supersteps, lanes {[r.supersteps for r in batch]}, "
        f"best weights {[float(r.weights[0]) for r in batch]}")
    for b, (bb, tb, _) in runs.items():
        log(f"    {b}: {split(bb[0], tb, steps_batch)}; "
            f"{tb * 1e3 / BUCKET_LANES:.1f} ms per query")
    for i, (rc, _) in enumerate(single):
        log(f"  query {list(rc.query)} (m={SINGLE_M}, k={SINGLE_K}): "
            f"{rc.supersteps} supersteps, weights {rc.weights.tolist()}")
        for b, (_, _, sg) in runs.items():
            log(f"    {b}: {split(sg[i][0], sg[i][1], rc.supersteps)}")
    # Phase 12 sets the sharded driver beside these: ms per superstep.
    per_step = {b: (bb[0].wall_time_s * 1e3 / steps_batch,
                    [r.wall_time_s * 1e3 / r.supersteps for r, _ in sg])
                for b, (bb, _, sg) in runs.items()}
    log(f"  launches on the main path: {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    bt = engines["cuda"]._backtracer()
    log(f"  extraction_stats {stats['cuda']}; for stragglers: lane tables "
        f"copied to the host {bt.table_copies}, rows fetched "
        f"{bt.rows_fetched}")

    # The bucket's extraction split, on its final tables: the device part
    # (stable sort of the 8 full-set columns + the walk kernel), then the
    # whole extract_lanes, whose rest is host replay + finish_tree.
    S_b = torch.cat([r.state.S for r in batch]).contiguous()
    kw_b = torch.from_numpy(np.stack([index.keyword_masks(
        q, graph.n_nodes, v_pad=S_b.shape[1]) for q in bucket])).to(dev)
    lanes_b = list(range(BUCKET_LANES))
    flat_b = S_b[:, :, (1 << BUCKET_M) - 1, :].reshape(BUCKET_LANES, -1)
    sort_s = host_s(lambda: torch.sort(flat_b, dim=1, stable=True))
    walk_s = host_s(lambda: bt._walk(S_b, kw_b, BUCKET_K, 4))
    ext_s = host_s(lambda: bt.extract_lanes(
        S_b, kw_b, k=BUCKET_K, lanes=lanes_b, n_nodes=graph.n_nodes))
    parts = extraction_parts(bt, S_b, kw_b, lanes_b, graph.n_nodes)
    bt_args = bt._walk_args(S_b, kw_b, BUCKET_K)[2]
    recs = bt_ops.batched_backtrace(*bt_args)
    plain = batched_backtrace_ref(*bt_args)
    errs["batched_backtrace"] = max(
        errs["batched_backtrace"],
        held_records(recs, plain, "the sec-rdfabout bucket's tables"))
    walked = int((recs["kind"] > 0).sum())
    timing["batched_backtrace"] = (
        cuda_ms(lambda: bt_ops.batched_backtrace(*bt_args), 20),
        cuda_ms(lambda: batched_backtrace_ref(*bt_args), 3), None,
        *backtrace_bound(recs, BUCKET_M))
    ms = timing["batched_backtrace"]
    log(f"  bucket extraction (host clock, synchronised): "
        f"{ext_s * 1e3:.1f} ms (host collector: {EXTRACTION_HOST_MS} ms) = "
        f"device {walk_s * 1e3:.1f} ms (stable sort of {list(flat_b.shape)} cells "
        f"{sort_s * 1e3:.2f} ms, the walk kernel, its records to the host) "
        f"+ host replay and finish_tree {(ext_s - walk_s) * 1e3:.1f} ms")
    log("  of which (host clock, one more call): " + "; ".join(
        f"{name} {x}" for name, x in parts.items()))
    log(f"  batched_backtrace at S {list(S_b.shape)}, "
        f"{bt_args[2].shape[1]} candidates per lane, {walked} obligations "
        f"walked (buffer {bt.buffer}, degree cap {bt.degree_cap}): "
        f"{ms[0]} ms (plain {ms[1]} ms, bound {ms[3]} ms by {ms[4]}), "
        f"records == plain walk")
    del S_b, kw_b, flat_b, bt_args, recs, plain

    # ---------------- 6. LM serving ----------------
    # The engines stay for phase 9 (serving); their states go.
    del runs, batch, single, g_small, dg_small
    gc.collect()
    torch.cuda.empty_cache()
    errs["flash_attention"], timing["flash_attention"] = flash_phase(dev)
    log("[6/16] flash_attention == plain version at small shapes and the "
        "main path's shape")
    launches["flash_attention"] = lm_phase(dev)
    log(f"[6/16] {LM_ARCH} served through the flash kernel: "
        f"{launches['flash_attention']} launches, logits and tokens agree "
        f"with naive attention")

    # ---------------- 7. recsys serving ----------------
    gc.collect()
    torch.cuda.empty_cache()
    errs["embedding_bag"], bag_rows, launches["embedding_bag"] = \
        recsys_phase(dev)
    # The kernels line gives the grouped lookup at serve_bulk's shape, the
    # largest of the main path; every timed shape rides along.
    timing["embedding_bag"] = tuple(bag_rows[0][k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by"))
    shapes = {"embedding_bag": {"timed_shapes": bag_rows}}
    log(f"[7/16] {RECSYS_ARCH} served through the grouped embedding_bag "
        f"kernel: {launches['embedding_bag']} launches (1 + 1 + 2), logits "
        f"and retrieval bit-equal to the plain path")

    # ---------------- 8. padded-CSR relax ----------------
    gc.collect()
    torch.cuda.empty_cache()
    err, timing["padded_topk"], launches["padded_topk"] = \
        padded_phase(dev, graph, index, bucket)
    errs["padded_topk"] = max(errs["padded_topk"], err)
    log(f"[8/16] {cfg_sec.name} padded-CSR relax through padded_topk "
        f"({launches['padded_topk']} launch) == plain == relax, exactly")

    # ---------------- 9. serving ----------------
    gc.collect()
    torch.cuda.empty_cache()
    serving = serving_phase(graph, index, engines, bucket, singles)
    log(f"[9/16] {cfg_sec.name} served on backend=cuda through DKSService: "
        f"{serving['summary']}; deadline bucket, stream and telemetry == "
        f"backend=torch")
    log(f"  card: {card}")
    del engines

    # ---------------- 10. store and live graphs ----------------
    gc.collect()
    torch.cuda.empty_cache()
    store = store_phase(dev, graph, tokens, index, bucket, singles, phase5)
    log(f"[10/16] {cfg_sec.name} through the graph store on backend=cuda: "
        f"{store['summary']}")

    # ---------------- 11. MoE and the int8 KV cache ----------------
    gc.collect()
    torch.cuda.empty_cache()
    moe = moe_phase(dev)
    errs["flash_attention"] = max(errs["flash_attention"], moe["err"])
    log(f"[11/16] {MOE_ARCH} served through the flash kernel: "
        f"{moe['launches']} launches, logits and tokens agree with naive "
        f"attention; int8 cache decode within {QUANT_TOL} of the bf16 cache; "
        f"at cut depth {moe['cut_launches']} launches")
    log(f"  card: {card}")

    # ---------------- 12. sharded partition ----------------
    gc.collect()
    torch.cuda.empty_cache()
    sharded = sharded_phase(dev, graph, index, bucket, singles, phase5,
                            per_step)
    log(f"[12/16] {cfg_sec.name} on the sharded partition ({SHARDS} shards,"
        f" backend=torch) == phase 5; {sharded['summary']}")

    # ---------------- 13. training ----------------
    gc.collect()
    torch.cuda.empty_cache()
    trained = train_phase(dev, card)
    log(f"[13/16] {TRAIN_ARCH} trained at full width and depth "
        f"({trained['split']['step_s']:.1f} ms a step); flash_jax == "
        f"chunked; a checkpoint restored bit-equal; {RECSYS_ARCH} trained on "
        f"the grouped lookup ({trained['launches']} launches); the smoke "
        f"steps card == CPU")

    # ---------------- 14. bluk-bnb ----------------
    gc.collect()
    torch.cuda.empty_cache()
    bluk = bluk_phase(dev)
    for name, err in bluk["errs"].items():
        errs[name] = max(errs[name], err)
    log(f"[14/16] bluk-bnb at full size on backend=cuda: launches "
        f"{bluk['launches']}; the three DKS kernels == plain versions at its "
        f"shapes; the torch twin's lanes == cuda's")
    log(f"  card: {card}")

    # ---------------- 15. GNN ----------------
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops

    gc.collect()
    torch.cuda.empty_cache()
    kernel_ops = {"subset_combine": sc_ops, "lane_superstep": ls_ops,
                  "flash_attention": fa_ops, "embedding_bag": eb_ops,
                  "padded_topk": sm_ops, "batched_backtrace": bt_ops}
    for ops in kernel_ops.values():
        ops.counter.reset()
    gnn_phase(dev, card)
    gnn_launches = {name: ops.launches for name, ops in kernel_ops.items()}
    log(f"[15/16] GNN: {', '.join(GNN_ARCHS)} card == CPU (f32) and trained "
        f"in bf16; gin-tu trained and pna's chunked aggregate run on "
        f"ogb_products at full size; gat-cora trained on a minibatch_lg "
        f"sample of a reddit-size host graph; hand-written kernel launches "
        f"{gnn_launches} (no pallas_call on this path)")
    log(f"  card: {card}")

    # ---------------- 16. kernels line ----------------
    sources = {"subset_combine": ("src/repro_torch/csrc/subset_combine.cu",
                                  "src/repro/kernels/subset_combine/kernel.py:63"),
               "lane_superstep": ("src/repro_torch/csrc/lane_superstep.cu",
                                  "src/repro/kernels/lane_superstep/kernel.py:131"),
               "flash_attention": ("src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention/kernel.py:96"),
               "embedding_bag": ("src/repro_torch/csrc/embedding_bag.cu",
                                 "src/repro/kernels/embedding_bag/kernel.py:50"),
               "padded_topk": ("src/repro_torch/csrc/padded_topk.cu",
                               "src/repro/kernels/segment_minplus/kernel.py:44"),
               "batched_backtrace": (
                   "src/repro_torch/csrc/batched_backtrace.cu",
                   "src/repro/answers/batched.py:303 (jitted while_loop, "
                   "no pallas_call)")}
    kernels = []
    for name, (source, replaces) in sources.items():
        ms, plain, library, bound, by = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": library,
            "gnn_launches": gnn_launches[name], **shapes.get(name, {})})
        if name in serving["launches"]:
            kernels[-1]["serving_launches"] = serving["launches"][name]
        if name in store["live_launches"]:
            kernels[-1]["store_launches"] = store["store_launches"][name]
            kernels[-1]["live_launches"] = store["live_launches"][name]
        if name in sharded["launches"]:
            kernels[-1]["sharded_launches"] = sharded["launches"][name]
        if name == "embedding_bag":
            kernels[-1]["train_launches"] = trained["launches"]
        if name in bluk["launches"]:
            ms, plain, library, bound, by = bluk["timing"][name]
            kernels[-1].update({
                "bluk_launches": bluk["launches"][name],
                "bluk_shape": {"ms": ms, "plain_ms": plain,
                               "library_ms": library, "bound_ms": bound,
                               "bound_by": by}})
        if name == "flash_attention":
            ms, plain, library, bound, by = moe["timing"]
            kernels[-1].update({
                "moe_launches": moe["launches"],
                "cut_depth_launches": moe["cut_launches"],
                "moe_shape": {"q": moe["shapes"][0], "kv": moe["shapes"][1],
                              "ms": ms, "plain_ms": plain,
                              "library_ms": library, "bound_ms": bound,
                              "bound_by": by}})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
