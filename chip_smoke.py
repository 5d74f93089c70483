#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

    python3 chip_smoke.py [--parent DIR]

``--parent DIR`` (a checkout of commit 29e18c9, the one before the walk's
and the wide ``padded_topk``'s redesign; any directory holding its
``src/repro_torch/csrc``): builds its ``subset_combine``,
``lane_superstep``, ``padded_topk`` and ``batched_backtrace`` after phase
2 and times each beside the new kernel in turns (parent, new, new,
parent) wherever the script times that kernel's redesign: the walk in
phases 5, 14 and 19, the wide kernels in phase 19.  Run with no
arguments it needs one card.

Phases (any failure exits non-zero; nothing is caught and ignored):

1. Device — fail unless ``torch.cuda.is_available()``; print the card's
   ``nvidia-smi --query-gpu=name,power.limit`` line.  At the start and
   end of every phase a line gives the card's SM and memory clocks,
   temperature, power draw and active clock-limit reasons (``nvidia-smi``;
   the reasons' field name probed once) and whether phase 17's meta dry
   run (started after phase 11, stopped on the way out) is running; a
   query that fails is logged and fails nothing.
2. Build — compile every CUDA source under ``src/repro_torch/csrc`` with
   nvcc (all at once), timed; each kernel's ptxas register and spill
   lines; the HGMMA (wgmma) and UTMALDG (TMA load) instructions in the
   flash library's SASS (``cuobjdump``), which must be there.
3. DKS kernels against their plain torch versions on the card, exact
   equality (tolerance 0: every lattice value is a min, a compare or one
   f32 add; the backtrace records are integers): random small shapes
   (``subset_combine``, ``lane_superstep`` and ``padded_topk`` up to m = 6
   keywords and K = 8 slots; the ``batched_backtrace`` walk on the final
   tables of 8 random buckets, stragglers included; then each kernel's
   wide route at (m, K) = (3, 10), (4, 10), (2, 16), (7, 3), (8, 2) and
   (6, 9), ``lane_superstep`` also on a hub graph with done lanes and
   INF-weight hub edges; then a hub of 5,000 in-edges with every sender
   active and with none, every lane done, rows at the 64 KB limit
   (m = 10, K = 16) and K = 16 at m = 5, and the bucket's shape on a
   4,000-node graph), then the main path's shapes (the
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
   its plain version there and timed beside its bound (the records, the
   candidates and each input entry its scans test, once) and the serial
   steps of its longest walk (obligations, split and edge rounds).
6. LM serving — the flash-attention kernel against its plain version
   (random small shapes: MHA, GQA, MQA, ragged lengths, ``q_offset``; f32
   within 2e-5, bf16 within 2e-2; then the main path's shape, timed beside
   the plain version and ``scaled_dot_product_attention``, with TFLOP/s
   and the share of the bound), then
   ChatGLM3-6B at full width in bf16 with random weights from a seeded
   CUDA generator through ``repro_torch.launch.serve.generate``: 4 prompts
   of 2,048 tokens and then one of 1,000, each a prefill through the
   kernel (the launch counters set to 0 just before and read just after:
   28 launches per prefill, all on the ``"wgmma"`` route) and
   ``LM_GEN`` (16) greedy decode steps.  The prefill's
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
   ``impl="torch"``; retrieval_cand's top 100 equal to the parent's
   scoring before the tie repair (29e18c9: the product's columns as they
   come), both timed in turns; then the grouped kernel at each of those
   lookups,
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
   just after it stops; each must be above zero).  Then phase 5's
   requests through a fresh service (``serve_script``: the bucket's first
   2 lanes as deadline buckets at 0 s and 600 s, the bucket of 8, the
   two single queries with their answer trees, the bucket again from
   the cache), kept for phase 18, with p50 / p99 and requests/s.
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
   ``engine.query``; then phase 18's stepwise twin (a stream, a deadline
   bucket and an instrumented run, below).  Prints the driver's ms per
   superstep beside phase 5's ``"cuda"`` and ``"torch"``, the frontier
   bytes gathered per
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
   traffic and checks (4 x 2,048 and 1 x 1,000 tokens, ``LM_GEN`` greedy
   steps each, 32 ``"wgmma"`` flash launches per prefill, logits within 5e-2 x
   max |logit| of naive attention), each prefill's per-layer
   ``dropped_frac`` and ``load_balance``, and a torch.profiler split.
   The int8 cache: the 4 x 2,048 prefill's K/V through ``quantize_kv``
   into a cache of 4,096 positions, ``LM_GEN`` ``decode_step_quant`` steps fed
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
   through ``repro_torch.launch.train.train_lm``: 8 steps of 4 x 2,048
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
   generated and indexed in a worker process started after phase 11
   (the index shipped as flat postings; its host ms each, and how long
   phase 14 waited for them and took to receive them), built on
   ``QueryEngine(backend="cuda")`` (host ms, the device graph's bytes);
   phase 5's traffic (a bucket of 8,
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
   ``build_graph`` (in a worker process started after phase 11; phase 15
   runs before phase 14), 1,024 seeds sampled at fanout (15, 10), the
   sample's
   features to the card, 8 steps; host ms of the build and the sampling.
   The kernels' launch counters are set to 0 before the phase and read
   after it: the GNN path reaches no ``pallas_call`` in ``repro`` and
   launches none of the port's kernels.
17. Accounting (run before the kernels line) — ``launch/dryrun.py`` on
   ``meta`` for every cell of ``launch/cells.py`` (40 (arch, shape) cells
   and 3 DKS cells; started after phase 11 in its own process, at the
   lowest priority on one core, so that its host time overlaps phases
   12-16 and leaves the host-clocked phases before them alone), then on
   the card for every cell whose predicted peak fits it, with content
   from a seeded generator: a count there, a warm call and the median of
   3 windows of calls, each at least 0.4 s (``dryrun.cuda_record``; 1
   call where a call takes over 2 s; a folded train step runs one
   micro-batch, its time that micro-batch's times the trips plus the
   update).  Asserted per measured cell: the measured peak within 10 % or
   0.5 GiB of the meta prediction, the FLOPs counted on the card equal to
   meta's, ``mfu`` and ``hbm_share`` at most 1.05; the DCN-v2 cells
   launch the grouped lookup (the kernels' counters set to 0 just before
   the card's cells and read just after: ``accounting_launches``).  Last,
   the dense DKS cell's one-card superstep at ``ACCOUNTING_SEED``, every
   state field's sha256 kept for phase 18's dense leg (:func:`dks_digest`).
18. Several ranks (run before the kernels line) — each multi-rank path
   in ranks the phase spawns (``repro_torch.distributed.ranks.run_ranks``,
   ``RANKS_TIMEOUT_S`` a spawn, past which the ranks are killed and the
   phase fails), held against its single-process twin on the card: 1
   rank over NCCL and 2 and 4 ranks sharing the card over gloo first run
   every collective of ``comm`` and its backward against its one-process
   definition, then phase 5's bucket on the sharded engine uncapped, one
   shard a rank (results, answer trees and a sha256 of every state field
   equal to the twin at the same shard count, phase 12's at 4; top-K
   weights equal to phase 5's; no kernel launched), both inside
   ``comm.through_group``, so that at 1 rank every collective goes
   through NCCL (the ops issued are counted and printed); the 1 and 4
   ranks then run the stepwise surfaces on the same engine: a stream of
   the bucket's first query (m = 3), its first 2 lanes as a deadline
   bucket at 0 s and at 600 s, and an instrumented run of the first query
   with the paper's Eq. 2 exit hook, each equal to phase 12's one-process
   twin exactly (every ``StreamUpdate`` field; results, trees and
   ``info``; the result and history rows), then the 2 lanes under half
   the time their loop took, which every rank stops at the same superstep
   mid-run with one state digest and sound bounds at most the exact
   answers; ms a superstep of the stream, the deadline bucket and the
   instrumented loop's four phases; the 1 and 4 ranks then serve the
   same engine through ``DKSService`` on rank 0 while the other ranks
   replay its records (``repro_torch.serve.follow``): phase 9's
   ``serve_script`` (served bucket equal to the twin and to phase 9's,
   the single queries' results and trees to phase 9's, the deadline
   buckets to phase 12's stepwise twin with ``approximate`` ==
   ``interrupted`` and the same bounds, the repeats all cache hits,
   every follower's replay log equal to rank 0's records; p50 / p99 and
   requests/s printed), and at 4 ranks a live swap on phase 12's small
   graph written as a ``LiveDir`` (2 client threads, a delta appended
   and swapped in under their load, no failed request, every rank
   installing the build at one record, the answers after it equal to a
   ``compact_chain`` engine's on the card); the 2 ranks
   then run one dbrx-132b MoE
   layer at full width expert-parallel on a (data 1, model 2) mesh, x [4,
   2,048, 6,144] bf16 (ids, slots and kept assignments equal to the twin,
   y within 5e-2 x max |y|), ChatGLM3-6B at full width over 2 GPipe
   stages of 14 layers, 4 x 2,048 tokens, 4 micro-batches, attention
   through the flash kernel (its launches counted in each rank, zeroed
   just before the forward and read just after), the logits at every
   position within 5e-2 x max |logit| of the plain forward, one f32 GPipe step
   at the smoke size against the plain step on the CPU within 1e-4, and
   the int8 ring all-reduce over DCN-v2's gradient tree (474,538,191
   f32), reduced values and error state bit-equal to the twin, then the
   transformer's tensor parallelism on a (data 1, model 2) mesh
   (``TP_MESH``): ChatGLM3-6B at full width and depth from phase 6's
   seed, built at ``tp=2`` and cut to each rank (``shard_lm``), a bf16
   prefill of 1 x 2,048 (``TP_BATCH``) through the flash kernel on each
   rank's heads (one launch a layer a rank) with the residual split on
   the sequence, run twice (the first call cold, the second timed warm),
   ``TP_DECODE`` decode steps teacher-forced by phase 6's second request
   against a cache split on the sequence and ``TP_QUANT_STEPS`` int8
   steps (the first step of each timed apart, cold), the logits within
   5e-2 x max |logit| of the whole model's on one process and the int8
   logits within atol = rtol = 0.25 of its int8 decode; granite at full
   width and 4 layers in f32, a prefill of 4 x 2,048 (the vocabulary
   padded to 49,156, the prefill's MoE through ``_moe_sharded`` on each
   rank's sequence block, the decode's through ``_moe_dense_all``),
   within 1e-4 x max of the one-process twin padded to the same ``tp``
   whose MoE runs the same dispatch (:func:`mesh_dispatch`), at 2 ranks
   and again at the 1-rank NCCL spawn inside ``through_group`` (its
   reduce-scatters, all-gathers and all_to_alls counted); two f32 smoke
   train steps at ``tp=2`` within 1e-4 of each leaf's largest magnitude
   of the same steps on the CPU.  DCN-v2 at full width (weights from
   ``RANKS_SEED``) on (data 1, model 2) over gloo and (1, 1) over NCCL:
   each rank's tables split by ``recsys.param_specs``, x0 by one grouped
   launch with ``clip=False`` on its shards and a ``psum``, serve_bulk's
   forward and retrieval_cand's top 100 twice (cold, then warm), one
   train_batch step; each rank then runs the one-process ``impl="cuda"``
   twin on the whole model and holds itself to it: x0 ``torch.equal``,
   logits and scores within 1e-5 x max, positions equal, the step's loss
   and ``grad_norm`` within 1e-5, its slices of the step's gradients and
   parameters within 1e-4 of each leaf's largest (the steps at AdamW's
   full lr, ``warmup_steps=1``; 2 lr more only where the twin's gradient
   is within its bound of 0: :func:`step_held`); 8 grouped launches a
   rank.  gin-tu and gat-cora at their published widths on
   ``minibatch_lg``'s padded sample (``gnn_cell``'s build, nodes and
   edges split over the ranks), a bf16 step and an f32 step each against
   the one-process step: the loss, ``grad_norm``, every gradient leaf and
   every parameter at ``RANKS_GNN_TOL``'s bounds, a second step timed
   warm; and the MB a rank's collectives move at ogb_products over 2 and
   256 ranks (:func:`gnn_mesh_bytes`).  The 4-rank gloo spawn then runs
   GPipe on a (pod 2, data 1, model 2) mesh (``PP3_MESH``, :func:`rank_pp3`):
   ChatGLM3-6B at full width cut to 4 layers (2 a stage), built at
   ``tp=2`` and cut to each rank by ``pipeline.stage_layer_specs``; a bf16
   pipelined forward of 4 x 1,024 tokens in 4 micro-batches through the
   flash kernel on each rank's heads (5 ticks x 2 layers = 10 launches a
   rank, counted from 0 around the call), its hidden states within 5e-2 x
   max of the one-process twin at the same padding; one f32 train step at
   AdamW's full lr on 4 x 128 tokens, loss and ``grad_norm`` within 1e-4
   relative and each rank's slice of the new parameters within 1e-4 of
   the leaf's largest (2 lr more only where the twin's gradient is within
   1e-4 of its leaf's largest gradient of 0); each rank runs that step
   under a ``count.Counter``, whose count equals a ``CountingMesh``'s
   count of the same stage's step on ``meta`` in the parent: the
   collective bytes kind by kind, and op for op the device-memory traffic
   and FLOPs of every op that moves bytes or does FLOPs (so nothing of
   gloo's transport, its host staging included, is counted), printed with the wire bytes and the NVLink term beside
   the step's ms (:func:`pp3_held`; the twin runs once, in the parent).
   The same leg then runs granite-moe-3b-a800m (``PP3_MOE_ARCH``) at full
   width cut to 4 layers, its forward in f32 (granite's router turns
   bf16's per-rank rounding into flipped picks) within 1e-4 x max of a
   one-process twin whose MoE runs the mesh's dispatch
   (:func:`mesh_dispatch`, one micro-batch's rows a call: ``_moe_dense_all``)
   and routes as the ranks routed (:func:`routes_replayed`: f32 sums in
   another order still flip a near tie now and then; where the twin's
   own top-k differs, the ranks' pick must lie within ``NEAR_TIE`` of
   its k-th probability), with the same step, parameter, launch and
   count checks.  Last, the
   dense DKS cell on a (data 2, model 2) mesh (``DENSE_MESH``,
   :func:`rank_dense`): bluk-bnb at full size, each rank's arguments by
   ``repro``'s in-specs from ``ACCOUNTING_SEED``'s draw (515 MB of ``S`` a
   rank), one superstep under a ``count.Counter`` (the bytes each
   collective moved a rank), the state gathered whole, and every field's
   sha256 equal to phase 17's one-card superstep (:func:`dense_held`).  Each
   path prints world size, backend, the ops staged through host memory
   (``comm.staged_ops``: none under NCCL), ms and peak
   memory a rank beside the card's name and power limit; one card shared
   by the ranks gives no multi-card time.
16. The kernels line: one JSON object with each kernel's launches on the
   DKS query path (phase 5; ``serving_launches`` adds ``DKSService``'s
   in phase 9 for the three kernels it runs; ``store_launches`` and
   ``live_launches`` phase 10's artifact engine, live service and warm;
   ``sharded_launches`` phase 12's; the flash row's ``moe_launches`` and
   ``cut_depth_launches`` phase 11's, and ``moe_shape`` its times at
   granite's shape; the bag row's ``train_launches`` phase 13's DCN-v2
   steps; the DKS rows' ``bluk_launches`` and ``bluk_shape`` phase 14's;
   ``gnn_launches`` phase 15's, all 0; ``accounting_launches`` phase
   17's; the flash row's ``ranks_launches`` phase 18's, by leg: the
   pipeline's and the tensor-parallel legs' ranks, the bag row's its
   DCN-v2 ranks', gloo's then NCCL's), error, times and bound; then a
   row for each DKS kernel's wide route (``"<name> (wide route)"``): its
   launches on phase 19's main path (``launches_by_route`` both routes'),
   its largest error over phases 3 and 19, its times at m = 4, K = 10;
   the two redesigned ones' ``shapes`` hold (a), (b) and (c).
19. DKS past the templated range (run after phase 11, on phase 5's
   engines, while phase 14's inputs are made in the worker) —
   phase 5's sec-rdfabout bucket of 8 at the paper's K = 10 (1.18 GB a
   table), its two m = 4 queries at K = 5 (the templated route) and
   K = 10, and one query of 7 keywords at K = 3 (707 MB a table) through
   ``QueryEngine(backend="cuda")``, the launch counters (by route) set to
   0 just before and read just after: one ``subset_combine`` a bucket or
   query, one ``lane_superstep`` a superstep, one walk for the bucket,
   each on the wide route past m = 6 or K = 8.  Every result (weights,
   roots, supersteps, messages, flags, trees) equals a ``"torch"`` twin's
   (the bucket's first ``WIDE_TWIN_LANES`` lanes).  Then each wide kernel
   held against its plain version and timed at (a) m = 4, K = 10 on a
   real state of the K = 10 query (``padded_topk`` through the padded
   relax at dmax = ``WIDE_DMAX``, one launch, equal to
   ``core/dks.py::relax``), beside its bound; the redesigned
   ``subset_combine`` and ``lane_superstep`` also at (b) the K = 10
   bucket and (c) the m = 7 query, ``WIDE_MID_STEPS`` supersteps in,
   each beside its bound, its plain version's one call and, with
   ``--parent``, the parent's kernel timed in turns; one superstep of
   the bucket under ``torch.profiler``; the driver and extraction ms of
   each query.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import functools
import gc
import json
import math
import multiprocessing
import os
import pickle
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# The bound formulas and the card's peaks (fails outside a checkout).
from repro_torch.analysis import roofline as rl  # noqa: E402
from repro_torch.analysis.roofline import (  # noqa: E402
    HBM_BYTES_PER_S, backtrace_bound, bag_bound, combine_bound,
    flash_bound, flash_flops, grouped_bound, lane_bound)
from repro_torch.launch.analyze import profile_window, window_line  # noqa: E402
BUCKET_M, BUCKET_K, BUCKET_LANES = 3, 3, 8
SINGLE_M, SINGLE_K, N_SINGLE = 4, 2, 2
QUERY_SEED = 2024
LM_ARCH, LM_SEED = "chatglm3-6b", 0
# LM_GEN: greedy decode steps a request (32 until PR 32, cut to keep the
# script inside its limit beside phase 19).
LM_BATCH, LM_PROMPT, LM_LONG, LM_GEN = 4, 2048, 1000, 16
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
# The DKS kernels' wide route (run-time m and K): phase 3's
# (m, K) past the templated m <= 6, K <= 8, and phase 19's traffic on
# sec-rdfabout: phase 5's bucket at the paper's K = 10, its two m = 4
# queries at K = 5 and 10, one query of 7 keywords at K = 3; the "torch"
# twin runs the bucket's first lanes.  The wide padded relax cuts dmax to
# 16, so that its candidates (C = 16 K slots) and their plain sort fit
# beside the engines.
WIDE_SHAPES = ((3, 10), (4, 10), (2, 16), (7, 3), (8, 2), (6, 9))
WIDE_BUCKET_K, WIDE_SINGLE_K, WIDE_M7 = 10, (5, 10), (7, 3)
WIDE_TWIN_LANES, WIDE_DMAX = 2, 16
# The redesigned wide kernels timed at (b) the bucket's own shape (8 lanes,
# m = 3, K = 10) and (c) the m = 7, K = 3 query, each this many supersteps
# into its run (the bucket's lanes end after 12 to 20), beside (a) m = 4,
# K = 10 as before; with --parent, the parent commit's kernels too.
WIDE_MID_STEPS, WIDE_TIMED_ITERS = 6, 10
SERVE_REQUESTS, SERVE_UNIQUE, SERVE_CLIENTS = 32, 8, 8
SERVE_DEADLINE_FRAC, SERVE_DEADLINE_MS = 0.25, 75.0
SERVE_TIMEOUT_S = 120       # the most any served request is waited for
LIVE_CLIENTS = 4            # phase 10's client threads across the swap
LIVE_PROBE_HOPS = 3         # the live probe pair's hop distance
SHARDS = 4                  # phase 12's shards, all on the one card
SHARDED_CAP = 0.25          # phase 12's capped run: the default cap
SMALL_SHARDED = (3001, 12000, 0.05)  # phase 12's small graph and its cap
RANKS_DKS_WORLDS = (1, 2, 4)   # phase 18: 1 rank over NCCL, 2 and 4 over gloo
RANKS_STEPWISE_WORLDS = (1, 4)  # of these, the ones that run the stepwise legs
STEPWISE_LANES = 2          # the deadline legs' lanes: the bucket's first
RANKS_TIMEOUT_S = 360       # each spawn of ranks: killed past it
SERVE_CONFIG = {"max_batch": 8, "max_wait_ms": 50.0}  # phases 9 and 18's
SWAP_CLIENTS = 2            # phase 18's client threads across the live swap
SWAP_REQUESTS = 6           # requests served before the swap, and after it
RANKS_SEED = 0              # phase 18's weights and gradients
RANKS_REPS = 2              # calls of the MoE layer and the pipeline
RANKS_MOE_ARCH, RANKS_MOE_X = "dbrx-132b", (4, 2048)   # one MoE layer
PP_STAGES, PP_MICRO, PP_ATTN = 2, 4, "cuda"   # GPipe over LM_ARCH
# GPipe on a (pod, data, model) mesh of the 4-rank spawn: LM_ARCH at full
# width cut to PP3_LAYERS layers, built at tp = the model axis, its bf16
# forward's tokens and its f32 train step's.
PP3_MESH = ((2, 1, 2), ("pod", "data", "model"))
PP3_LAYERS, PP3_TOKENS, PP3_STEP_TOKENS = 4, (4, 1024), (4, 128)
PP3_TOL = 5e-2              # the bf16 hidden states, x max |twin|
PP3_STEP_TOL = 1e-4         # loss, grad_norm (relative), params (x max)
PP3_DIR = ROOT / "build" / "chip_smoke_ranks" / "pp3"   # the ranks' steps
# The leg again with granite's MoE stages, its forward in f32: in bf16
# granite's router turns each rank's rounding into flipped picks.
PP3_MOE_ARCH, PP3_MOE_TOL = "granite-moe-3b-a800m", 1e-4
# Its twin routes as the ranks routed; where its own top-k differs, the
# ranks' worst pick must be within this share of its k-th probability
# (f32 sums in another order: a near tie, not a fault).
NEAR_TIE = 1e-5
# The dense DKS cell's leg of the 4-rank spawn: bluk-bnb on (data, model).
DENSE_MESH, DENSE_DATASET = ((2, 2), ("data", "model")), "bluk-bnb"
TP_MESH = (1, 2)            # phase 18's tensor-parallel legs: (data, model)
# ChatGLM3's tp leg: its prompts' rows (of phase 6's first request) and
# teacher-forced bf16 / int8 decode steps, cut from 4 rows and 8 steps to
# keep the script inside its limit.
TP_BATCH, TP_DECODE, TP_QUANT_STEPS = 1, 4, 4
TP_QUANT_SEQ, TP_CHUNK = 4096, 2048   # the int8 cache: 2,048 positions a rank
TP_MOE_LAYERS = 4           # granite's depth in the tp legs (of 32)
# granite's tp legs run in f32, held x max |logit| against the one-process
# twin with the same MoE dispatch: in bf16 each split matmul's partial
# sums round on each rank and again in the sum, and granite's router
# turns that into 5 % of a logit (40 experts, top 8); in f32 only the
# order of f32 sums differs.
TP_MOE_TOL = 1e-4
TP_TRAIN_STEPS = 2          # f32 smoke train steps at tp=2, card against CPU
# The default warm-up keeps Adam's first steps small: an element whose
# gradient is rounding noise would take a whole step at full rate
# (tests/test_torch_tensor_parallel.py).
TP_TRAIN_OPT = {"lr": 3e-3}
RING_ARCH = "dcn-v2"        # the int8 ring's gradient tree
SMOKE_OPT = {"warmup_steps": 1}  # the smoke train steps' optimizer
TRAIN_ARCH, TRAIN_SEED = "granite-moe-3b-a800m", 0   # phase 13
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 8, 4, 2048   # phases 6 and 11's shape
FLASH_JAX_TOL = 2e-2        # flash_jax against chunked, relative: bf16 scores
CKPT_LAYERS = 2             # the checkpoint leg's depth, at full width
DCN_TRAIN_STEPS, DCN_TRAIN_BATCH = 20, 8192
# Phase 18's DCN-v2 and GNN legs, on a (data 1, model = world) mesh: DCN-v2
# at full width on serve_bulk, train_batch and retrieval_cand; gin-tu and
# gat-cora at their published widths on minibatch_lg's padded sample.
# The steps take AdamW's full lr from the first (``warmup_steps=1``, as the
# CPU tests' steps), so that a step not taken, or taken the wrong way,
# moves a parameter by lr = 3e-4: past its bound below.
RANKS_DCN_SHAPES = ("serve_bulk", "train_batch", "retrieval_cand")
RANKS_DCN_TOL = 1e-5        # logits, scores, loss and grad_norm, x max
RANKS_DCN_GRAD_TOL = 1e-4   # the step's gradients, x each leaf's largest
RANKS_DCN_STEP_TOL = 1e-4   # one step's parameters, x each leaf's largest
RANKS_GNN_ARCHS = ("gin-tu", "gat-cora")
RANKS_GNN_SHAPE = "minibatch_lg"
# tests/test_torch_multirank_gnn.py's bounds, by message-passing dtype:
# the loss and grad_norm (relative), each gradient leaf (f32: its error's
# largest x the leaf's largest; bf16: its error's norm x the leaf's norm),
# each parameter after the step (x the leaf's largest).  Where the twin's
# gradient lies within its bound of 0 (bf16: everywhere), a rounding of
# the other sign moves the element lr the other way, so the parameters
# there get 2 lr more (:func:`step_held`).
RANKS_GNN_TOL = {"bfloat16": {"loss": 5e-2, "grad_norm": 1e-1,
                              "grads": 2e-1, "params": 5e-2},
                 "float32": {"loss": 1e-5, "grad_norm": 1e-5,
                             "grads": 1e-4, "params": 1e-4}}
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
ACCOUNTING_SEED = 0         # phase 17: the cells' content
PEAK_TOL, PEAK_SLACK = 0.10, 0.5 * 2 ** 30  # measured peak against meta's
SHARE_LIMIT = 1.05          # mfu and hbm_share: at most the peak, and noise
META_TIMEOUT_S = 900        # the meta dry run, started after phase 11
HOST_INPUTS_TIMEOUT_S = 600  # phases 14 and 15's host inputs, made since phase 11
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


def star_graph(n_nodes: int, hub_in: int, seed: int = 0):
    """Node 0 with ``hub_in`` in-edges from nodes 1.. (weights 1 to 3),
    beside 3,000 random edges: past ``WIDE_HUB_DEGREE``, a hub block's
    row on the wide route."""
    from repro_torch.graph.structure import build_graph

    rng = np.random.default_rng(seed)
    src = np.concatenate([np.arange(1, hub_in + 1),
                          rng.integers(0, n_nodes, 3000)])
    dst = np.concatenate([np.zeros(hub_in, np.int64),
                          rng.integers(0, n_nodes, 3000)])
    w = rng.integers(1, 4, size=len(src)).astype(np.float32)
    return build_graph(src, dst, n_nodes, w=w)


def timed_once(fn) -> tuple:
    """``fn()``'s result and the device ms of that one call (CUDA events):
    for the plain versions at the wide shapes, whose call takes seconds."""
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def parent_kernels(parent: Path) -> dict:
    """The kernels of the checkout at ``parent`` (``--parent``; 29e18c9,
    the commit before the walk's and the wide ``padded_topk``'s
    redesign): ``subset_combine``, ``lane_superstep``, ``padded_topk``
    and ``batched_backtrace``, built with this checkout's nvcc flags into
    build/chip_smoke_parent (all at once).  Returned:
    ``"through"(name, fn)``, ``fn`` (a wrapper call of the first two, whose
    C interface is unchanged) on the parent's library; the walk and the
    wide ``padded_topk`` on the new wrappers' arguments, through the
    parent's C interface (no plan)."""
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.batched_backtrace.ops import RECORDS

    csrc = parent / "src" / "repro_torch" / "csrc"
    out_dir = ROOT / "build" / "chip_smoke_parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    names = ("subset_combine", "lane_superstep", "padded_topk",
             "batched_backtrace")
    procs = {}
    for name in names:
        so = out_dir / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", str(csrc),
             "-o", str(so), str(csrc / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        check(proc.returncode == 0, f"the parent's {name} did not build:\n"
                                    f"{out}")
        libs[name] = ctypes.CDLL(str(so))
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("subset_combine", "lane_superstep"):
        for fn_name, argtypes in cuda_build.SIGNATURES[name].items():
            fn = getattr(libs[name], fn_name)
            fn.argtypes, fn.restype = list(argtypes), I
    pt = libs["padded_topk"].dks_padded_topk_wide
    pt.argtypes, pt.restype = [P, P, L, I, I, I, P], I
    bt = libs["batched_backtrace"].bt_batched_backtrace
    bt.argtypes = [P] * 15 + [I, I, L, I, I, I, I, I, L, L, P]
    bt.restype = I
    log(f"  the parent's kernels ({parent}) built in "
        f"{time.perf_counter() - t0:.1f} s")

    def through(name, fn):
        def call(*args):
            saved = cuda_build._LIBS.get(name)
            cuda_build._LIBS[name] = libs[name]
            try:
                return fn(*args)
            finally:
                cuda_build._LIBS[name] = saved   # None: loaded again
        return call

    def topk(cand, k):
        vv, c, f = cand.shape
        out = torch.empty(vv, f, k, dtype=torch.float32, device=cand.device)
        check(pt(cand.data_ptr(), out.data_ptr(), vv, c, f, k,
                 torch.cuda.current_stream().cuda_stream) == 0,
              "the parent's padded_topk did not launch")
        return out

    def walk(S, kw, cand_idx, cand_val, indptr, esrc, ew, pa, pb, buffer,
             degree_cap):
        lanes, vp, _, k = S.shape
        c = cand_idx.shape[1]
        out = {n: torch.empty(lanes, c, buffer, dtype=torch.int32,
                              device=S.device) for n in RECORDS}
        out["fail"] = torch.empty(lanes, c, dtype=torch.bool,
                                  device=S.device)
        check(bt(*(t.data_ptr() for t in (S, kw, cand_idx, cand_val, indptr,
                                          esrc, ew, pa, pb)),
                 *(out[n].data_ptr() for n in (*RECORDS, "fail")),
                 lanes, c, vp, kw.shape[1], k, pa.shape[1], buffer,
                 degree_cap, indptr.numel() - 1, esrc.numel(),
                 torch.cuda.current_stream().cuda_stream) == 0,
              "the parent's batched_backtrace did not launch")
        return out

    return {"through": through, "padded_topk": topk,
            "batched_backtrace": walk}


def in_turns(new, old, iters: int) -> dict:
    """``new`` beside the parent's ``old``, each ``iters`` calls (CUDA
    events) in turns: parent, new, new, parent."""
    turns = [cuda_ms(fn, iters) for fn in (old, new, new, old)]
    return {"ms": (turns[1] + turns[2]) / 2,
            "parent_ms": (turns[0] + turns[3]) / 2, "turns_ms": turns}


def wide_timed(new, plain, old, what: str) -> dict:
    """One wide kernel at one shape: its result equal to the plain
    version's (and to the parent's kernel ``old``, when given), the plain
    version's one call, and the kernel's mean ms over ``WIDE_TIMED_ITERS``
    calls (CUDA events); with the parent, the two timed in turns: parent,
    new, new, parent."""
    got = new()
    want, plain_ms = timed_once(plain)
    err = max_abs_err(got, want)
    check(torch.equal(got, want), f"{what} != plain (max abs err {err})")
    out = {"max_abs_err": err, "plain_ms": plain_ms}
    del want
    if old is None:
        out["ms"] = cuda_ms(new, WIDE_TIMED_ITERS)
        return out
    check(torch.equal(old(), got), f"{what}: the parent's kernel differs")
    del got
    out.update(in_turns(new, old, WIDE_TIMED_ITERS))
    return out


def walk_timed(args, old, what: str, iters: int) -> dict:
    """The walk kernel on ``args`` (the wrapper's): its records equal to
    the plain walk's (and to the parent's kernel ``old``, when given), its
    bound from the input entries the plain walk's scans test
    (``roofline.backtrace_reads``), the serial steps of its longest walk
    at its plan's threads (``roofline.backtrace_rounds``), and its mean ms
    over ``iters`` calls (with the parent: in turns).  The plain walk's
    time is the caller's."""
    from repro_torch.kernels.batched_backtrace import ops as bt_ops
    from repro_torch.kernels.batched_backtrace.ref import \
        batched_backtrace_ref

    recs = bt_ops.batched_backtrace(*args)
    reads = {}
    err = held_records(recs, batched_backtrace_ref(*args, reads=reads),
                       what)
    distinct = rl.backtrace_reads(args, reads)
    lanes, c = args[2].shape
    plan = bt_ops.walk_plan(lanes * c, args[-2], args[7].shape[1])
    out = {"err": err, "records": recs, "warps": plan.warps,
           "bound": backtrace_bound(args, distinct),
           "entries": {k: distinct[k] for k in rl.BACKTRACE_ENTRY_BYTES},
           "rounds": rl.backtrace_rounds(distinct, 32 * plan.warps,
                                         bt_ops.EDGES)}
    new = functools.partial(bt_ops.batched_backtrace, *args)
    if old is None:
        out["ms"] = cuda_ms(new, iters)
        return out
    held_records(old(*args), recs, f"{what}: the parent's kernel")
    out.update(in_turns(new, functools.partial(old, *args), iters))
    return out


def walk_line(got: dict) -> str:
    """The walk's timing beside its bound, rounds and parent, for a log."""
    bound, by = got["bound"]
    beside = ("" if "parent_ms" not in got else
              f"; the parent's kernel {got['parent_ms']} ms (turns parent, "
              f"new, new, parent: {got['turns_ms']})")
    r = got["rounds"]
    return (f"{got['ms']} ms, {got['warps']} warps a walk (bound {bound} ms "
            f"by {by}: {got['entries']} input entries tested; the longest "
            f"walk {r['obligations']} obligations, {r['split_rounds']} split "
            f"and {r['edge_rounds']} edge rounds at {r['threads']} threads)"
            f"{beside}")


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


def no_drop(cfg):
    """``cfg`` with the experts' capacity factor raised to E / k, the
    least at which no assignment can drop (capacity >= the token count).
    ``repro``'s own prefill/decode consistency test raises it the same way
    (``tests/test_models_smoke.py``)."""
    spec = cfg.moe
    return cfg.scaled(moe=dataclasses.replace(
        spec, capacity_factor=spec.n_experts / spec.top_k))


def no_drop_twin(model):
    """``model``'s weights, shared, under :func:`no_drop` of its
    config."""
    from repro_torch.models import transformer as tfm

    twin = tfm.LM(no_drop(model.cfg), device="meta",
                  dtype=model.embed.dtype)
    twin.load_state_dict(model.state_dict(), assign=True)
    return twin


def device_split(model, prompts, prefill, decode) -> None:
    """Where a prefill's and a decode step's time goes on the card:
    torch.profiler's kernel times against the host clock
    (``launch/analyze.py``'s window; profiled, so the host side runs
    slower than unprofiled)."""
    from repro_torch.models import lm as lm_lib

    steps = 4
    out = {}
    w_p = profile_window(lambda: out.update(
        zip(("logits", "cache"), prefill(model, prompts))), top=6)
    cache = lm_lib.grow_cache(model.cfg, out["cache"],
                              prompts.shape[1] + steps)
    tok = out["logits"].argmax(-1)[:, None]
    feed = {"tok": tok, "cache": cache}

    def step():
        feed["tok"], feed["cache"] = decode(model, feed["cache"],
                                            feed["tok"])

    w_d = profile_window(step, steps=steps, top=6)
    log(window_line("prefill", w_p))
    log(window_line("decode step", w_d))


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
    model = tfm.init_lm(tfm.build(cfg, 1), gen)
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
        return rec.GroupedLookup.apply(sparse, dense, cfg.n_dense, True,
                                       *tables)

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


def retrieval_repair(params, cfg, batch, cand) -> dict:
    """retrieval_cand's top ``RETRIEVAL_TOP_K`` as ``retrieval_scores``
    gives it (each candidate the score of its id's first position) beside
    the parent's one-process scoring (the product's columns as they come,
    commit 29e18c9): the same top scores and positions, and both timed
    in turns (parent, new, new, parent; CUDA events)."""
    from repro_torch.models import recsys as rec

    table = params["tables"]["table_0"]

    def before():
        u = rec.user_vector(params, batch["dense"], batch["sparse"], cfg)
        ids = torch.clamp(cand, 0, table.shape[0] - 1)
        emb = rec._lookup(table, ids, "cuda")
        return rec._top_k(u @ (emb @ params["item"]).T, RETRIEVAL_TOP_K)

    def after():
        return rec.retrieval_scores(params, batch["dense"], batch["sparse"],
                                    cand, cfg, top_k=RETRIEVAL_TOP_K)

    (s_old, i_old), (s_new, i_new) = before(), after()
    check(torch.equal(s_old, s_new) and torch.equal(i_old, i_new),
          "retrieval_cand: the tie repair changed the top "
          f"{RETRIEVAL_TOP_K}")
    got = in_turns(after, before, REQUEST_REPS)
    log(f"  retrieval_cand's tie repair ({cand.numel()} candidates, "
        f"{int(torch.unique(cand).numel())} distinct ids): "
        f"{got['ms']:.4f} ms a call against the parent's {got['parent_ms']:.4f}"
        f" (turns parent, new, new, parent: {got['turns_ms']}), the same top "
        f"{RETRIEVAL_TOP_K}")
    return got


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
    retrieval_repair(params, cfg, batches["retrieval_cand"], cand)
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
             *rl.bound(*rl.topk_work(cand, BUCKET_K)[:2]))
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


def wide_small_shapes(dev, g_small, dg_small, rng) -> dict:
    """Phase 3's wide route, past m = 6 or K = 8: each DKS kernel at every
    (m, K) of ``WIDE_SHAPES`` against its plain version, exactly, one
    wide launch each; ``lane_superstep`` also on a hub graph (in-degrees
    up to 980, INF-weight edges into hubs, lanes 1 and 3 of 4 done).
    Returns each kernel's largest error."""
    t0 = time.perf_counter()
    from repro_torch import INF
    from repro_torch.answers import BatchedBacktracer
    from repro_torch.core import dks, driver
    from repro_torch.graph.generators import lod_like_graph
    from repro_torch.kernels.batched_backtrace import ops as bt_ops
    from repro_torch.kernels.batched_backtrace.ref import \
        batched_backtrace_ref
    from repro_torch.kernels.lane_superstep import ops as ls_ops
    from repro_torch.kernels.lane_superstep.ref import fused_lane_step_ref
    from repro_torch.kernels.segment_minplus import ops as sm_ops
    from repro_torch.kernels.segment_minplus.ref import padded_topk_ref
    from repro_torch.kernels.subset_combine import ops as sc_ops
    from repro_torch.kernels.subset_combine.ref import subset_combine_ref

    errs_wide = dict.fromkeys(("subset_combine", "lane_superstep",
                               "padded_topk", "batched_backtrace"), 0.0)

    def held_wide(name, ops, call, want, what):
        before = ops.launches_by_route["wide"]
        got = call()
        torch.cuda.synchronize()
        check(ops.launches_by_route["wide"] == before + 1,
              f"{name} at {what} did not launch the wide route")
        err = max_abs_err(got, want)
        errs_wide[name] = max(errs_wide[name], err)
        check(torch.equal(got, want), f"{name} wide route != plain at "
                                      f"{what} (max abs err {err})")

    g_hub, _ = lod_like_graph(3000, 40000, seed=1, vocab=40, tau=300)
    dg_hub = g_hub.to_device(dev)
    for m, k in WIDE_SHAPES:
        S = sorted_unique_tables((3, 301), m, k, seed=10 * m + k, device=dev)
        held_wide("subset_combine", sc_ops,
                  lambda: sc_ops.subset_combine(S, m),
                  subset_combine_ref(S, m), f"m={m} k={k}")
        cfg = dks.DKSConfig(m=m, k=k)
        for what, dgw, density, done in (
                ("small graph", dg_small, 0.03, [True, False, False]),
                ("hub graph", dg_hub, 0.01, [False, True, False, True])):
            masks = torch.from_numpy(
                rng.random((len(done), m, dgw.v_pad)) < density).to(dev)
            st = driver.lane_init(dgw, masks, cfg)
            for _ in range(2):
                st = dks.superstep(dgw, st, cfg)
            args = (st.S, st.changed, torch.tensor(done, device=dev),
                    dgw.in_offsets, dgw.src, dgw.w)
            held_wide("lane_superstep", ls_ops,
                      lambda: ls_ops.fused_lane_step(*args, m,
                                                     dgw.hub_nodes),
                      fused_lane_step_ref(*args, m), f"{what} m={m} k={k}")
        if k > 8:  # padded_topk takes any F on its templated route
            r = np.random.default_rng(m + k)
            f, c = 1 << m, 4 * k
            cand = r.integers(1, 60, size=(257, c, f)).astype(np.float32)
            cand[r.random(cand.shape) > 0.6] = INF
            cand = torch.from_numpy(cand).to(dev)
            held_wide("padded_topk", sm_ops,
                      lambda: sm_ops.padded_topk(cand, k),
                      padded_topk_ref(cand, k), f"cand {[257, c, f]} k={k}")
        kw_masks = rng.random((4, m, dg_small.v_pad)) < 0.05
        kw_masks[:, :, g_small.n_nodes:] = False
        kw_masks[0, 0] = False
        kw = torch.from_numpy(kw_masks).to(dev)
        st = driver.run_lanes(dg_small, kw, dks.DKSConfig(
            m=m, k=k, max_supersteps=32))
        for caps in ({}, TIGHT):
            bt = BatchedBacktracer(g_small, device=dev, **caps)
            args = bt._walk_args(st.S.contiguous(), kw, k)[2]
            before = bt_ops.launches_by_route["wide"]
            got = bt_ops.batched_backtrace(*args)
            torch.cuda.synchronize()
            check(bt_ops.launches_by_route["wide"] == before + 1,
                  f"batched_backtrace at m={m} k={k} did not launch the "
                  f"wide route")
            errs_wide["batched_backtrace"] = max(
                errs_wide["batched_backtrace"],
                held_records(got, batched_backtrace_ref(*args),
                             f"wide m={m} k={k} {caps}"))
    # The redesigned kernels' own cases: a hub of 5,000 in-edges (a block
    # a lane) with every sender active and with none; every lane done;
    # rows at the 64 KB limit and K = 16 at m = 5 (a set stride padded to
    # 17), with a hub; the bucket's shape (8 lanes, m = 3, K = 10) on a
    # 4,000-node graph with nodes past WIDE_HUB_DEGREE, three supersteps in.
    dg_star = star_graph(6000, 5000).to_device(dev)
    for m, k in ((3, 10), (4, 10), (5, 16)):
        S0 = sorted_unique_tables((2, dg_star.v_pad), m, k, seed=m + k,
                                  device=dev)
        for active in (True, False):
            args = (S0, torch.full((2, dg_star.v_pad), active, device=dev),
                    torch.tensor([False, True], device=dev),
                    dg_star.in_offsets, dg_star.src, dg_star.w)
            held_wide("lane_superstep", ls_ops,
                      lambda: ls_ops.fused_lane_step(*args, m,
                                                     dg_star.hub_nodes),
                      fused_lane_step_ref(*args, m),
                      f"a hub of 5000 in-edges m={m} k={k}, "
                      f"{'every' if active else 'no'} sender active")
    S0 = sorted_unique_tables((3, dg_hub.v_pad), 3, 10, seed=5, device=dev)
    args = (S0, torch.ones(3, dg_hub.v_pad, dtype=torch.bool, device=dev),
            torch.ones(3, dtype=torch.bool, device=dev), dg_hub.in_offsets,
            dg_hub.src, dg_hub.w)
    held_wide("lane_superstep", ls_ops,
              lambda: ls_ops.fused_lane_step(*args, 3, dg_hub.hub_nodes),
              S0, "every lane done")
    # The row limit's and K = 16's states are random tables and senders:
    # the plain superstep's batched combine does not fit the card at m = 10.
    g_cut, _ = lod_like_graph(4000, 60000, seed=2, vocab=40)
    for what, dgw, m, k, lanes in (
            ("the row limit", star_graph(300, 260, 10).to_device(dev), 10,
             16, 2),
            ("K = 16", star_graph(300, 260, 5).to_device(dev), 5, 16, 2),
            ("the bucket's shape cut to 4000 nodes",
             g_cut.to_device(dev), 3, 10, 8)):
        if m > 3:
            S0 = sorted_unique_tables((lanes, dgw.v_pad), m, k, seed=m,
                                      device=dev)
            changed = torch.from_numpy(
                rng.random((lanes, dgw.v_pad)) < 0.5).to(dev)
        else:
            cfg = dks.DKSConfig(m=m, k=k)
            st = driver.lane_init(dgw, torch.from_numpy(
                rng.random((lanes, m, dgw.v_pad)) < 0.01).to(dev), cfg)
            for _ in range(3):
                st = dks.superstep(dgw, st, cfg)
            S0, changed = st.S, st.changed
        done = torch.zeros(lanes, dtype=torch.bool, device=dev)
        done[-1] = True
        args = (S0, changed, done, dgw.in_offsets, dgw.src, dgw.w)
        held_wide("lane_superstep", ls_ops,
                  lambda: ls_ops.fused_lane_step(*args, m, dgw.hub_nodes),
                  fused_lane_step_ref(*args, m), f"{what} m={m} k={k}")
        S = sorted_unique_tables((lanes, 61), m, k, seed=k, device=dev)
        held_wide("subset_combine", sc_ops,
                  lambda: sc_ops.subset_combine(S, m),
                  subset_combine_ref(S, m), f"{what} m={m} k={k}")
    log(f"  the wide route's holds took {time.perf_counter() - t0:.1f} s")
    return errs_wide


def wide_phase(dev, graph, index, bucket, singles, engines,
               old: dict | None = None) -> dict:
    """Phase 19: the DKS main path past the templated range, on phase 5's
    sec-rdfabout engines: the bucket at K = 10, the two m = 4 queries at
    K = 5 and 10, a query of 7 keywords at K = 3, the launch counters set
    to 0 just before and read just after; every result equal to the
    ``"torch"`` twin's (the bucket's first ``WIDE_TWIN_LANES`` lanes); then
    each wide kernel held against its plain version and timed at (a)
    m = 4, K = 10 on a real state of the K = 10 query, and the two
    redesigned ones also at (b) the K = 10 bucket and (c) the m = 7 query,
    ``WIDE_MID_STEPS`` supersteps in, where one superstep of the bucket
    runs under ``torch.profiler``; with ``old`` (:func:`parent_kernels`
    of the commit before this one) the parent's four kernels beside
    them, in turns.  Returns
    the launches by route, the wide kernels' errors and times (``timing``
    at (a), ``shapes`` at all three)."""
    from repro_torch import INF
    from repro_torch.answers import BatchedBacktracer
    from repro_torch.core import dks, driver
    from repro_torch.kernels.batched_backtrace import ops as bt_ops
    from repro_torch.kernels.batched_backtrace.ref import \
        batched_backtrace_ref
    from repro_torch.kernels.lane_superstep import ops as ls_ops
    from repro_torch.kernels.lane_superstep.ref import fused_lane_step_ref
    from repro_torch.kernels.segment_minplus import ops as sm_ops
    from repro_torch.kernels.segment_minplus.ref import padded_topk_ref
    from repro_torch.kernels.subset_combine import ops as sc_ops
    from repro_torch.kernels.subset_combine.ref import subset_combine_ref

    t_phase = time.perf_counter()

    [q7] = draw_queries(graph, index, 1, WIDE_M7[0],
                        np.random.default_rng(QUERY_SEED + 1))
    eng, twin = engines["cuda"], engines["torch"]
    kernels = {"subset_combine": sc_ops, "lane_superstep": ls_ops,
               "batched_backtrace": bt_ops}

    # ---- the main path, counted ----
    for ops in kernels.values():
        for c in (ops.counter, *ops.route_counters.values()):
            c.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    batch = eng.query_batch(bucket, k=WIDE_BUCKET_K)
    t_batch = time.perf_counter() - t0
    single = []
    for q, k in (*zip(singles, WIDE_SINGLE_K), (q7, WIDE_M7[1])):
        t0 = time.perf_counter()
        single.append((eng.query(q, k=k), time.perf_counter() - t0))
    launches = {n: ops.launches_by_route for n, ops in kernels.items()}
    peak = torch.cuda.max_memory_allocated()
    steps_batch = max(r.supersteps for r in batch)
    (r5, _), (r10, _), (r7, _) = single
    want = {"subset_combine": {"templated": 1, "wide": 3},
            "lane_superstep": {"templated": r5.supersteps,
                               "wide": steps_batch + r10.supersteps
                               + r7.supersteps},
            "batched_backtrace": {"templated": 0, "wide": 1}}
    check(launches == want, f"wide leg launches {launches}, want {want}")
    for r in batch + [r for r, _ in single]:
        check(r.found and len(r.answers) > 0, f"no answer for {r.query}")
    log(f"[19/19] {graph.n_nodes}-node sec-rdfabout past the templated "
        f"route on backend=cuda: launches by route {launches}; peak device "
        f"memory {gib(peak)}")

    def split(res, total_s):
        drv = res.wall_time_s * 1e3
        return (f"{total_s * 1e3:.1f} ms = driver {drv:.1f} ms "
                f"({drv / res.supersteps:.2f} ms per superstep) + "
                f"extraction {total_s * 1e3 - drv:.1f} ms")

    log(f"  bucket of {BUCKET_LANES} (m={BUCKET_M}, k={WIDE_BUCKET_K}, "
        f"{gib(BUCKET_LANES * graph.n_nodes * (4 << BUCKET_M) * WIDE_BUCKET_K)}"
        f" a table): {steps_batch} supersteps, lanes "
        f"{[r.supersteps for r in batch]}, best weights "
        f"{[float(r.weights[0]) for r in batch]}; "
        f"{split(batch[0], t_batch)}")
    for r, t in single:
        log(f"  query {list(r.query)} (m={r.m}, k={r.k}): {r.supersteps} "
            f"supersteps, weights {r.weights.tolist()}; {split(r, t)}")

    # ---- the "torch" twin ----
    t0 = time.perf_counter()
    got = twin.query_batch(bucket[:WIDE_TWIN_LANES], k=WIDE_BUCKET_K)
    t_twin = [time.perf_counter() - t0]
    for i, (rc, rt) in enumerate(zip(batch, got)):
        same_results(rc, rt, f"wide bucket lane {i} vs torch twin")
    for (rc, _), (q, k) in zip(single, (*zip(singles, WIDE_SINGLE_K),
                                        (q7, WIDE_M7[1]))):
        t0 = time.perf_counter()
        same_results(rc, twin.query(q, k=k), f"wide query {q} k={k} vs "
                                             f"torch twin")
        t_twin.append(time.perf_counter() - t0)
    log(f"  backend=torch twin == backend=cuda (weights, roots, supersteps, "
        f"messages, flags, trees): bucket lanes 0..{WIDE_TWIN_LANES - 1} in "
        f"{t_twin[0]:.1f} s, the three queries in "
        f"{', '.join(f'{t:.1f}' for t in t_twin[1:])} s")
    del batch, got, single

    # ---- each wide kernel at m = 4, K = 10, a real state ----
    m, k = SINGLE_M, WIDE_SINGLE_K[1]
    dg = eng.device_graph
    masks = torch.from_numpy(index.keyword_masks(
        singles[1], graph.n_nodes, v_pad=dg.v_pad)[None]).to(dev)
    cfg = dks.DKSConfig(m=m, k=k)
    errs, timing = {}, {}
    shapes = {"subset_combine": [], "lane_superstep": []}

    def both(label, S_c, m_c, lane_args, m_l):
        """Both redesigned kernels at one shape, beside their bounds."""
        for name, new, plain, bound, args_ in (
                ("subset_combine", sc_ops.subset_combine, subset_combine_ref,
                 combine_bound(S_c, m_c), (S_c, m_c)),
                ("lane_superstep",
                 lambda *a: ls_ops.fused_lane_step(*a, dg.hub_nodes),
                 fused_lane_step_ref, lane_bound(*lane_args[:6]),
                 (*lane_args, m_l))):
            got = wide_timed(functools.partial(new, *args_),
                             functools.partial(plain, *args_),
                             None if old is None else
                             functools.partial(old["through"](name, new),
                                               *args_),
                             f"wide {name} at {label}")
            got.update(shape=label, bound_ms=bound[0], bound_by=bound[1])
            shapes[name].append(got)
            errs[name] = max(errs.get(name, 0.0), got["max_abs_err"])
            beside = ("" if old is None else
                      f"; the parent's kernel {got['parent_ms']} ms (turns "
                      f"parent, new, new, parent: {got['turns_ms']})")
            log(f"  {name} wide route at {label}: {got['ms']} ms (plain "
                f"{got['plain_ms']} ms, bound {bound[0]} ms by {bound[1]}, "
                f"{100 * bound[0] / got['ms']:.1f} % of it){beside}, == "
                f"plain")

    S_pre = torch.full((1, dg.v_pad, 1 << m, k), INF, device=dev)
    for i in range(m):
        S_pre[:, :, 1 << i, 0] = torch.where(masks[:, i], 0.0, INF)
    st = driver.lane_init(dg, masks, cfg)
    for _ in range(2):
        st = dks.superstep(dg, st, cfg)
    done = torch.zeros(1, dtype=torch.bool, device=dev)
    args = (st.S, st.changed, done, dg.in_offsets, dg.src, dg.w)
    both(f"(a) m={m} k={k}, one lane", S_pre, m, args, m)
    for name in shapes:
        a = shapes[name][0]
        timing[name] = (a["ms"], a["plain_ms"], None, a["bound_ms"],
                        a["bound_by"])
    # The padded relax of that state (one padded_topk launch), equal to
    # its plain version and to core/dks.py::relax.
    n_e = dg.n_edges
    csr = sm_ops.padded_csr_from_graph(
        *(x[:n_e].cpu().numpy() for x in (dg.src, dg.dst, dg.w)),
        dg.n_nodes, dmax=WIDE_DMAX, device=dev)
    S1, ch1 = st.S[0].contiguous(), st.changed[0].contiguous()
    for c in (sm_ops.counter, *sm_ops.route_counters.values()):
        c.reset()
    relaxed = sm_ops.segment_minplus_padded(S1, csr, ch1, k, dg.v_pad)
    launches["padded_topk"] = sm_ops.launches_by_route
    check(launches["padded_topk"] == {"templated": 0, "wide": 1},
          f"padded_topk launches {launches['padded_topk']}, want 1 wide")
    check(torch.equal(relaxed, dks.relax(dg, S1[None], ch1[None], cfg)[0]),
          "wide segment_minplus_padded differs from core/dks.py::relax")
    cand = sm_ops.padded_candidates(S1, csr, ch1)
    plan = sm_ops.topk_wide_plan(*cand.shape[1:], k)
    got = wide_timed(
        lambda: sm_ops.padded_topk(cand, k), lambda: padded_topk_ref(cand, k),
        None if old is None else lambda: old["padded_topk"](cand, k),
        f"wide padded_topk at m={m} k={k}")
    errs["padded_topk"] = got["max_abs_err"]
    bound = rl.bound(*rl.topk_work(cand, k)[:2])
    timing["padded_topk"] = (got["ms"], got["plain_ms"], None, *bound)
    wide_topk = {k_: got[k_] for k_ in ("parent_ms", "turns_ms") if k_ in got}
    beside = ("" if old is None else
              f"; the parent's kernel {got['parent_ms']} ms (turns parent, "
              f"new, new, parent: {got['turns_ms']})")
    log(f"  padded_topk wide route at cand {list(cand.shape)}, k={k}: "
        f"{got['ms']} ms, team {plan.team}, {plan.chunk} candidates a "
        f"chunk, {plan.warps} warps a block (plain {got['plain_ms']} ms, "
        f"bound {bound[0]} ms by {bound[1]}, "
        f"{100 * bound[0] / got['ms']:.1f} % of it){beside}, == plain")
    del st, args, got, cand, relaxed, S1, ch1
    # The walk on the K = 10 query's final table.
    res = eng.query(singles[1], k=k, keep_state=True)
    bt = BatchedBacktracer(graph, device=dev)
    bt_args = bt._walk_args(res.state.S.contiguous(), masks, k)[2]
    got = walk_timed(bt_args, None if old is None else
                     old["batched_backtrace"], "the m=4 k=10 query's table",
                     20)
    errs["batched_backtrace"] = got["err"]
    timing["batched_backtrace"] = (
        got["ms"], cuda_ms(lambda: batched_backtrace_ref(*bt_args), 3),
        None, *got["bound"])
    wide_walk = {k_: got[k_] for k_ in ("parent_ms", "turns_ms", "rounds",
                                        "warps") if k_ in got}
    log(f"  batched_backtrace wide route at m={m} k={k}: {walk_line(got)} "
        f"(plain {timing['batched_backtrace'][1]} ms), == plain")
    del res, bt_args, got, S_pre

    # ---- the redesigned kernels at (b) the bucket, (c) m = 7 ----
    for label, queries, (m_s, k_s) in (
            (f"(b) m={BUCKET_M} k={WIDE_BUCKET_K}, the bucket's "
             f"{BUCKET_LANES} lanes", bucket, (BUCKET_M, WIDE_BUCKET_K)),
            (f"(c) m={WIDE_M7[0]} k={WIDE_M7[1]}, one lane", [q7],
             WIDE_M7)):
        cfg_s = dks.DKSConfig(m=m_s, k=k_s, backend="cuda")
        st = driver.lane_init(dg, torch.from_numpy(np.stack([
            index.keyword_masks(q, graph.n_nodes, v_pad=dg.v_pad)
            for q in queries])).to(dev), cfg_s)
        for _ in range(WIDE_MID_STEPS):
            st = driver.lane_superstep(dg, st, cfg_s)
        if m_s == BUCKET_M:
            log(window_line(
                f"one superstep of the K = {k_s} bucket ({WIDE_MID_STEPS} "
                f"in, backend=cuda)",
                profile_window(lambda: driver.lane_superstep(dg, st, cfg_s),
                               top=10), 70))
        args = (st.S.contiguous(), st.changed.contiguous(), st.done,
                dg.in_offsets, dg.src, dg.w)
        both(f"{label}, {WIDE_MID_STEPS} supersteps in", args[0], m_s,
             args, m_s)
        del st, args
    log(f"  the phase took {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "errs": errs, "timing": timing,
            "shapes": shapes, "padded_topk": wide_topk,
            "batched_backtrace": wide_walk}


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
    from repro_torch.serve import DKSService, ServeConfig
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
    # Phase 5's requests served (phase 18 holds its ranks' service to
    # these).
    with DKSService(eng_c, ServeConfig(**SERVE_CONFIG)) as svc:
        served = serve_script(svc, bucket, singles)
    check(served["repeat_hits"] == BUCKET_LANES,
          f"the bucket again: {served['repeat_hits']} cache hits")
    log(f"  phase 5's requests served: {served_line(served)}")

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
    return {"launches": launches, "served": served,
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

    # Uncapped: exactly phase 5 (states kept: phase 18's 4-rank twin).
    batch, t_batch = sharded_bucket(eng, bucket)
    t_batch /= 1e3
    twin4 = ([result_record(r) for r in batch], state_digest(batch))
    # Phase 18's stepwise twin.
    stepwise4 = stepwise_record(eng, bucket)
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
    log(f"  stepwise twin (phase 18's): a stream of {bucket[0]} "
        f"{stepwise4['stream_ms']:.2f} ms a superstep, the first "
        f"{STEPWISE_LANES} lanes as a deadline bucket "
        f"{stepwise4['deadline_ms']:.2f} ms, the instrumented loop "
        f"{fmt_ms(stepwise4['phases_ms'])} a superstep (host clock)")
    return {"launches": launches, "twin4": twin4, "stepwise4": stepwise4,
            "summary": f"{steps} supersteps at {drv:.2f} ms each, "
                       f"{len(bounds)} capped lanes sound, {n_exact} exact "
                       f"served answers"}


def train_args(arch: str, steps: int, batch: int, seq: int = 128):
    """``repro_torch.launch.train``'s argument namespace for a run on the
    card, at ``tp=1`` (no padding: the numbers stay those of earlier
    runs)."""
    from repro_torch.launch import train

    return train.parser().parse_args([
        "--arch", arch, "--steps", str(steps), "--batch", str(batch),
        "--seq", str(seq), "--seed", str(TRAIN_SEED), "--device", "cuda",
        "--log-every", str(steps), "--tp", "1"])


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
    """One train step under torch.profiler (``launch/analyze.py``'s
    window): kernel time against the host clock, launches, and the
    kernels that lead."""
    w = profile_window(lambda: step(state, batch), top=10)
    log(window_line("a train step", w, 70) + f" [{card}]")


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


def bluk_extraction(eng, S_b, kw_b, twin: int, old=None) -> dict:
    """The bucket's extraction split on its final tables, the deadline
    path's cost per lane, ``batched_backtrace`` held against its plain
    version and timed (beside the parent's walk ``old``, when given); the
    twin's lanes extracted again from the ``"cuda"`` tables alone (their
    stats and rows fetched)."""
    from repro_torch.answers import BatchedBacktracer
    from repro_torch.answers.streaming import _host
    from repro_torch.core.reconstruct import HostScan
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
    got = walk_timed(args, old, "bluk-bnb's final tables", 5)
    times = (got["ms"], once_ms(lambda: batched_backtrace_ref(*args)), None,
             *got["bound"])
    log(f"  batched_backtrace on bluk-bnb's final tables: {walk_line(got)} "
        f"(plain {times[1]} ms), records == plain walk")
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
    return {"err": got["err"], "times": times,
            "twin": (bt_twin.stats(), bt_twin.rows_fetched),
            "walk": {k_: got[k_] for k_ in ("parent_ms", "turns_ms",
                                            "rounds", "warps") if k_ in got}}


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


def bluk_inputs(conn) -> None:
    """bluk-bnb's host graph, its inverted index as flat postings
    (``to_postings``: a pickled dict of 500,000 small arrays takes tens of
    seconds each way), the seconds each took and the wall-clock time the
    result was ready, pickled to ``conn``: phase 14's inputs, made in a
    worker process (:func:`start_worker`)."""
    from repro_torch.configs import BLUK_BNB
    from repro_torch.graph.generators import lod_like_graph
    from repro_torch.graph.index import InvertedIndex

    cb = BLUK_BNB
    t0 = time.perf_counter()
    graph, tokens = lod_like_graph(cb.n_nodes, cb.n_edges, seed=cb.seed,
                                   vocab=cb.vocab, tau=cb.tau)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    postings = InvertedIndex.from_token_matrix(tokens).to_postings()
    data = pickle.dumps((graph, postings, gen_s, time.perf_counter() - t0,
                         time.time()), protocol=5)
    del graph, tokens, postings
    conn.send_bytes(data)
    conn.close()


def minibatch_worker(conn) -> None:
    """:func:`minibatch_inputs`, pickled to ``conn``: phase 15's leg 5
    inputs, made in a worker process (:func:`start_worker`)."""
    conn.send_bytes(pickle.dumps(minibatch_inputs(), protocol=5))
    conn.close()


def start_worker(target) -> tuple:
    """(the process running ``target(conn)``, the end its result arrives
    on).  The result stays in the pipe, with the worker blocked on it,
    until its phase reads it, so no thread of this process unpickles it
    while a timed phase runs."""
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    proc = ctx.Process(target=target, args=(send,), daemon=True)
    proc.start()
    send.close()
    return proc, recv


def received(recv, what: str):
    """The result of a worker's pipe, waited for at most
    ``HOST_INPUTS_TIMEOUT_S``."""
    check(recv.poll(HOST_INPUTS_TIMEOUT_S),
          f"{what} not made within {HOST_INPUTS_TIMEOUT_S} s")
    return pickle.loads(recv.recv_bytes())


def bluk_phase(dev, worker, old=None) -> dict:
    """Phase 14: the DKS main path at bluk-bnb's full size on
    ``backend="cuda"``, phase 5's traffic, the three DKS kernels held
    against their plain versions at its shapes, a ``"torch"`` twin of the
    bucket's first ``BLUK_TWIN_LANES`` lanes and the first m = 4 query.
    ``worker``: :func:`start_worker`'s of :func:`bluk_inputs`; ``old``:
    :func:`parent_kernels` (the walk beside the parent's).  Returns
    the launches,
    errors and times of the three kernels."""
    from repro_torch.configs import BLUK_BNB
    from repro_torch.core import dks
    from repro_torch.engine import ExecutionPolicy, QueryEngine
    from repro_torch.graph.index import InvertedIndex
    from repro_torch.kernels.batched_backtrace import ops as bt_ops
    from repro_torch.kernels.lane_superstep import ops as ls_ops
    from repro_torch.kernels.subset_combine import ops as sc_ops

    t_phase = time.perf_counter()
    cb = BLUK_BNB
    wall0 = time.time()
    graph, postings, gen_s, index_s, ready = received(
        worker[1], f"{cb.name}'s graph and index")
    index = InvertedIndex.from_postings(*postings)
    del postings
    wait_s = time.perf_counter() - t_phase
    ready_s = max(0.0, ready - wall0)
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
        f"{gen_s * 1e3:.1f} ms, indexed in {index_s * 1e3:.1f} ms (in a "
        f"worker process since phase 11; waited for them and received "
        f"them in {wait_s * 1e3:.1f} ms, {ready_s * 1e3:.1f} of it before "
        f"the worker had them), "
        f"engine built in {build_s * 1e3:.1f} ms; device graph {device_bytes(dg)} "
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
    log(f"[14/19] {cb.name} on backend=cuda: a bucket of {BUCKET_LANES} "
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
    ext = bluk_extraction(eng, S_b, kw_b, twin,
                          None if old is None else old["batched_backtrace"])
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
    return {"launches": launches, "errs": errs, "timing": timing,
            "walk": ext["walk"]}


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
    """One call of ``step`` under torch.profiler (``launch/analyze.py``'s
    window): the top device ops and kernel-busy time against the profiled
    wall."""
    log(window_line(what, profile_window(step), 70) + f" [{card}]")


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


def minibatch_inputs() -> dict:
    """``minibatch_lg``'s host inputs for phase 15's leg 5: a reddit-size
    host graph (232,965 nodes; 57,307,946 random directed edges, weights
    given, so ``build_graph``'s CSR holds about 114.6 M entries), its
    labels and features, the seeds, and the ms the graph took to build.
    Made in a worker process (:func:`minibatch_worker`) since phase 11."""
    from repro_torch.configs import GAT_CORA, GNN_SHAPES
    from repro_torch.graph.structure import build_graph

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
    return {"g": g, "labels": labels, "feats": feats, "seeds": seeds,
            "build_ms": build_ms}


def gnn_minibatch(dev, card: str, inputs: dict) -> None:
    """Leg 5: ``minibatch_lg`` x gat-cora, bf16: on
    :func:`minibatch_inputs`' host graph, 1,024 seeds sampled at fanout
    (15, 10), their features gathered to the card, ``GNN_SAMPLE_STEPS``
    train steps on the seeds' labels."""
    from repro_torch import interop
    from repro_torch.configs import GAT_CORA, GNN_SHAPES
    from repro_torch.graph.sampler import plan_sizes, sample_subgraph
    from repro_torch.models import gnn as gnn_lib
    from repro_torch.optim import adamw_init

    shape = {s.name: s for s in GNN_SHAPES}["minibatch_lg"]
    g, labels, feats, seeds, build_ms = (inputs[k] for k in (
        "g", "labels", "feats", "seeds", "build_ms"))
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
        f"CSR entries built in {build_ms:.1f} ms (in a worker process "
        f"since phase 11); {shape.batch_nodes} seeds "
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


def gnn_phase(dev, card: str, minibatch: dict) -> None:
    """Phase 15: the GNN family trained on the card (legs 1-5; leg 5 on
    ``minibatch``, :func:`minibatch_inputs`).  Each leg runs in a function
    of its own, so its tensors die with it."""
    t_phase = time.perf_counter()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for leg in (gnn_card_vs_cpu, gnn_bf16_train, gnn_ogb,
                    functools.partial(gnn_minibatch, inputs=minibatch)):
            leg(dev, card)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    log(f"  the phase took {time.perf_counter() - t_phase:.1f} s")


CARD_FIELDS = "clocks.sm,clocks.mem,temperature.gpu,power.draw"
# The active clock-limit reasons: newer drivers' name, then older ones'.
REASON_FIELDS = ("clocks_event_reasons.active",
                 "clocks_throttle_reasons.active")


def query_card(fields: str) -> subprocess.CompletedProcess:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30)


@functools.lru_cache(maxsize=1)
def card_fields() -> str:
    """:data:`CARD_FIELDS` and the first of :data:`REASON_FIELDS` this
    driver knows (probed once)."""
    for name in REASON_FIELDS:
        try:
            if query_card(name).returncode == 0:
                return f"{CARD_FIELDS},{name}"
        except (OSError, subprocess.SubprocessError):
            break
    return CARD_FIELDS


def card_state(what: str, meta: list) -> None:
    """Log the card's clocks, temperature, power draw and clock-limit
    reasons at a phase boundary, and whether phase 17's meta dry run is
    running.  Logging only: a query that fails is logged as such and the
    run goes on."""
    fields = card_fields()
    try:
        got = query_card(fields)
        state = (got.stdout.strip().splitlines() or ["(empty)"])[0] \
            if got.returncode == 0 else \
            f"not read (exit {got.returncode}: {got.stderr.strip()[:200]})"
    except (OSError, subprocess.SubprocessError) as e:
        state = f"not read ({e})"
    if not meta:
        dry = "not started"
    else:
        rc = meta[0][0].poll()
        dry = "running" if rc is None else f"exited with {rc}"
    log(f"  card at {what}: {fields} = {state}; meta dry run {dry}")


def start_meta_dry_run() -> tuple[subprocess.Popen, Path]:
    """Phase 17's meta dry run (``launch/dryrun.py --device meta``, no
    card), started after phase 11 in its own process, at the lowest
    priority on one core, so that its host time overlaps phases 12-16 and
    takes none from the host-clocked phases before them; its JSON goes
    under ``build/``."""
    out = ROOT / "build" / "chip_smoke_dryrun"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    core = max(os.sched_getaffinity(0))
    boot = (f"import os, runpy, sys; os.nice(19); "
            f"os.sched_setaffinity(0, {{{core}}}); "
            f"sys.argv = ['dryrun', '--device', 'meta', '--out', {str(out)!r}]; "
            f"runpy.run_module('repro_torch.launch.dryrun', "
            f"run_name='__main__')")
    with open(out / "meta.log", "w") as logf:
        proc = subprocess.Popen(
            [sys.executable, "-c", boot], stdout=logf,
            stderr=subprocess.STDOUT, cwd=ROOT,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    return proc, out


def accounting_phase(dev, card: str, meta: tuple, kernel_ops: dict
                     ) -> dict:
    """Phase 17: every catalog cell's meta count (from the dry run
    started after phase 11), then every cell the count says fits, run on the
    card by ``dryrun.cuda_record``; the kernels' launch counters set to 0
    just before the card's cells and read just after."""
    from repro_torch.launch import cells as cells_mod
    from repro_torch.launch import dryrun

    t_phase = time.perf_counter()
    proc, out = meta
    rc = proc.wait(timeout=META_TIMEOUT_S)
    tail = (out / "meta.log").read_text()[-2000:]
    check(rc == 0, f"the meta dry run exited {rc}: {tail}")
    metas = {}
    for f in (out / "meta").glob("*.json"):
        rec = json.loads(f.read_text())
        metas[rec["cell"]] = rec
    cells = cells_mod.all_cells()
    check(sorted(metas) == sorted(c.name for c in cells),
          f"the meta dry run covered {len(metas)} of {len(cells)} cells")
    log(f"  meta dry run: {len(metas)} cells counted in "
        f"{sum(r['count_s'] for r in metas.values()):.1f} s of host time "
        f"(alongside phases 12-16)")
    for c in cells:
        log(f"    {dryrun.summary_line(metas[c.name])}")
    fitting = [c for c in cells if metas[c.name]["fits_one_card"]]
    gc.collect()
    torch.cuda.empty_cache()
    for ops in kernel_ops.values():
        ops.counter.reset()
    records = []
    for cell in fitting:
        rec = dryrun.cuda_record(cell, metas[cell.name], ACCOUNTING_SEED,
                                 card, dev)
        records.append(rec)
        log(f"    {dryrun.summary_line(rec)}")
        got, want = rec["measured_peak_bytes"], rec["predicted_peak_bytes"]
        check(abs(got - want) <= max(PEAK_TOL * want, PEAK_SLACK),
              f"{cell.name}: measured peak {got} B against the meta "
              f"prediction {want} B")
        check(rec["card_flops"] == rec["flops"],
              f"{cell.name}: {rec['card_flops']} FLOPs counted on the card, "
              f"{rec['flops']} on meta")
        check(rec["mfu"] <= SHARE_LIMIT and rec["hbm_share"] <= SHARE_LIMIT,
              f"{cell.name}: mfu {rec['mfu']}, hbm_share "
              f"{rec['hbm_share']} above {SHARE_LIMIT}")
    launches = {name: ops.launches for name, ops in kernel_ops.items()}
    n_dcn = sum(1 for c in fitting if c.arch_id == "dcn-v2")
    check(launches["embedding_bag"] >= n_dcn > 0,
          f"the DCN-v2 cells launched the grouped lookup "
          f"{launches['embedding_bag']} times")
    (out / "cuda_records.json").write_text(json.dumps(records, indent=1))
    # The dense DKS cell's one-card superstep, for phase 18's dense leg.
    dense = next(c for c in cells if c.name == f"dks-{DENSE_DATASET}__"
                 "superstep_dense_m4_k2")
    fn, args = dense.build(dev, torch.Generator(dev).manual_seed(
        ACCOUNTING_SEED))
    digest = dks_digest(vars(fn(*args)))
    del fn, args
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  {len(records)} of {len(cells)} cells fit one card and ran on "
        f"it; launches {launches}; {dense.name}'s one-card superstep "
        f"digested for phase 18; the phase took "
        f"{time.perf_counter() - t_phase:.1f} s [{card}]")
    return {"launches": launches, "measured": len(records),
            "cells": len(cells), "dense_digest": digest}


def dks_digest(fields: dict) -> dict:
    """sha256 of every field of one DKS state, {name: tensor}."""
    import hashlib

    return {f: hashlib.sha256(t.contiguous().cpu().numpy().tobytes())
            .hexdigest() for f, t in fields.items()}


# --------------------------------------------------------------------------
# Phase 18: several ranks
# --------------------------------------------------------------------------
#
# Each multi-rank path runs in ranks spawned by the phase
# (``repro_torch.distributed.ranks.run_ranks``: a rendezvous file, a time
# limit that kills the ranks) and is held against its single-process twin
# on the card.  The rank functions are module-level: the ranks start from
# a fresh interpreter and import them by name.


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def rank_header(device) -> dict:
    """The group a rank ran in: world size, backend, the ops it stages
    through host memory."""
    from repro_torch.distributed import comm

    return {"world": comm.world_size(), "backend": comm.backend(),
            "staged": list(comm.staged_ops(device))}


def result_record(r) -> dict:
    """What a sharded result must share with its twin, exactly."""
    return {"weights": r.weights.tolist(), "roots": r.roots.tolist(),
            "supersteps": r.supersteps, "msgs": [r.msgs_bfs, r.msgs_deep],
            "flags": [r.done, r.budget_hit, r.capped],
            "explored_frac": r.explored_frac,
            "answers": [(a.root, list(a.edges), a.weight)
                        for a in r.answers]}


def state_digest(results) -> dict:
    """sha256 of every state field over a bucket's lanes."""
    import hashlib

    from repro_torch.core.dks import STATE_FIELDS

    return {f: hashlib.sha256(torch.cat([getattr(r.state, f)
                                         for r in results])
                              .cpu().numpy().tobytes()).hexdigest()
            for f in STATE_FIELDS}


def sharded_bucket(eng, bucket) -> tuple[list, float]:
    """The bucket uncapped on a sharded engine, states kept: (results,
    host ms)."""
    t0 = time.perf_counter()
    res = eng.query_batch(bucket, k=BUCKET_K, keep_state=True)
    return res, (time.perf_counter() - t0) * 1e3


def update_record(u) -> dict:
    """Every field of a ``StreamUpdate``, arrays as lists."""
    return {k: v.tolist() if hasattr(v, "tolist") else v
            for k, v in dataclasses.asdict(u).items()}


def stepwise_record(eng, bucket) -> dict:
    """The stepwise surfaces on one sharded engine (phase 12's twin, or one
    shard a rank): a stream of ``bucket[0]`` (m=3), the bucket's first
    ``STEPWISE_LANES`` lanes as a deadline bucket at 0 s and at one no run
    reaches, and an instrumented run of ``bucket[0]`` with the paper's
    Eq. 2 exit hook.  ``held`` must equal the twin's exactly; the rest are
    host times, ms a superstep."""
    from repro_torch.core.fagin import paper_exit_hook

    query, lanes = bucket[0], bucket[:STEPWISE_LANES]
    t0 = time.perf_counter()
    ups = list(eng.query_stream(query, k=BUCKET_K))
    stream_ms = (time.perf_counter() - t0) * 1e3 / len(ups)
    held = {"stream": [update_record(u) for u in ups]}
    for d in (0.0, 600.0):
        out = eng.query_deadline_batch(lanes, k=BUCKET_K, deadline_s=d)
        held[f"deadline/{d}"] = [(result_record(r), info) for r, info in out]
    loop_s = out[0][0].wall_time_s    # 600 s: the loop, not the extraction
    masks, _ = eng._masks(query)
    hook = paper_exit_hook(eng.graph, masks,
                           eng._config(BUCKET_M, BUCKET_K), eng._e_min,
                           graph=eng.device_graph)
    res, info = eng.query_instrumented(query, k=BUCKET_K, exit_hook=hook)
    held["instrumented"] = (result_record(res), info["history"])
    steps = held["deadline/600.0"][0][1]["driver_supersteps"]
    return {"held": held, "stream_ms": stream_ms,
            "deadline_ms": loop_s * 1e3 / (steps + 1), "loop_s": loop_s,
            "phases_ms": {name: t * 1e3 / res.supersteps
                          for name, t in info["timings"].items()}}


def rank_stepwise(device, eng, bucket) -> dict:
    """The stepwise surfaces on one shard a rank (:func:`stepwise_record`),
    then the deadline bucket under half the time its loop took (the
    slowest rank's): the ranks' shared stop interrupts it mid-run."""
    from repro_torch.distributed import comm

    rec = stepwise_record(eng, bucket)
    half = float(comm.pmax(torch.tensor(rec["loop_s"], dtype=torch.float64,
                                        device=device),
                           mesh=eng.device_graph.mesh)) / 2
    out = eng.query_deadline_batch(bucket[:STEPWISE_LANES], k=BUCKET_K,
                                   deadline_s=half, extract=False,
                                   keep_state=True)
    rec["mid_run"] = {"deadline_s": half,
                      "steps": [info["driver_supersteps"] for _, info in out],
                      "interrupted": [info["interrupted"] for _, info in out],
                      "sound": [info["sound_opt_lower_bound"]
                                for _, info in out],
                      "digest": state_digest([r for r, _ in out])}
    return rec


def rank_comm(device) -> None:
    """Every collective of ``comm`` and its backward, through the group
    even at one rank, against its one-process definition on every rank's
    seeded inputs.  Sums over ranks within 1e-5 (the group may add in
    another order); everything else exactly."""
    from repro_torch.distributed import comm

    n, r = comm.world_size(), comm.rank()
    mesh = comm.Mesh((n,), ("data",), device.type)

    def inputs(seed, shape):
        return [torch.randn(shape, device=device, generator=torch.Generator(
            device).manual_seed(1000 * seed + q)) for q in range(n)]

    def held(what, got, want, atol=0.0):
        torch.testing.assert_close(
            got, want, rtol=0, atol=atol,
            msg=lambda m: f"rank {r} of {n}, {what}: {m}")

    xs = inputs(1, (2 * n, 6))
    shift = [(q, (q + 1) % n) for q in range(n)]
    cases = (   # name, fn, cotangent shape, forward, backward, atol
        ("all_gather", lambda t: comm.all_gather(t, dim=1, tiled=True,
                                                 mesh=mesh),
         (2 * n, 6 * n), lambda w: torch.cat(xs, 1),
         lambda w: sum(w)[:, 6 * r:6 * (r + 1)], 1e-5),
        ("all_to_all", lambda t: comm.all_to_all(t, split_dim=0,
                                                 concat_dim=1, mesh=mesh),
         (2, 6 * n), lambda w: torch.cat([x[2 * r:2 * (r + 1)]
                                          for x in xs], 1),
         lambda w: torch.cat([c[:, 6 * r:6 * (r + 1)] for c in w], 0), 0.0),
        ("psum", lambda t: comm.psum(t, mesh=mesh), (2 * n, 6),
         lambda w: sum(xs), lambda w: sum(w), 1e-5),
        ("ppermute", lambda t: comm.ppermute(t, "data", shift, mesh=mesh),
         (2 * n, 6), lambda w: xs[(r - 1) % n], lambda w: w[(r + 1) % n],
         0.0))
    with comm.through_group():
        for seed, (name, fn, shape, fwd, bwd, atol) in enumerate(cases, 2):
            w = inputs(seed, shape)
            x = xs[r].clone().requires_grad_(True)
            y = fn(x)
            (g,) = torch.autograd.grad((y * w[r]).sum(), x)
            held(name, y.detach(), fwd(w), atol)
            held(f"{name}'s transpose", g, bwd(w), atol)
        held("pmax", comm.pmax(xs[r], mesh=mesh), torch.stack(xs).amax(0))
        held("pmin", comm.pmin(xs[r], mesh=mesh), torch.stack(xs).amin(0))
        flags = [x[:, 0] > 0 for x in xs]
        held("pmax of bool", comm.pmax(flags[r], mesh=mesh),
             torch.stack(flags).any(0))
        big = [torch.tensor([2 ** 40 + q], device=device) for q in range(n)]
        held("psum of int64", comm.psum(big[r], mesh=mesh), sum(big))


def served_record(srv) -> dict:
    """A served answer: its result record, its bounds and its tree page."""
    rec = {"result": result_record(srv.result),
           "approximate": srv.approximate,
           "bounds": [srv.opt_lower_bound, srv.sound_opt_lower_bound]}
    if srv.trees is not None:
        rec["trees"] = [(t.root, t.weight, [(e.u, e.v) for e in t.edges])
                        for t in srv.trees.items]
    return rec


def serve_script(svc, bucket, singles) -> dict:
    """Phase 5's requests through a ``DKSService`` (phase 9 in one
    process; phase 18 on rank 0 of a graph split across ranks): the
    bucket's first ``STEPWISE_LANES`` lanes as deadline buckets at 0 s
    and at 600 s (then the cache is emptied), the bucket of 8, the single
    queries with their answer trees, and the bucket again (cache hits).
    Returns the served records, latencies and the wall time."""
    def burst(queries, k, **kw):
        futs = [svc.submit(q, k=k, **kw) for q in queries]
        return [f.result(SERVE_TIMEOUT_S) for f in futs]

    out, served = {}, []
    t0 = time.perf_counter()
    for d in (0.0, 600.0):
        got = burst(bucket[:STEPWISE_LANES], BUCKET_K, deadline_ms=d * 1e3)
        out[f"deadline/{d}"] = [served_record(r) for r in got]
        served += got
    svc.invalidate_cache()
    got = burst(bucket, BUCKET_K)
    out["bucket"] = [served_record(r) for r in got]
    served += got
    got = burst(singles, SINGLE_K, return_trees=True,
                tree_page_size=SINGLE_K)
    out["singles"] = [served_record(r) for r in got]
    served += got
    got = burst(bucket, BUCKET_K)
    out["repeat_hits"] = sum(r.cache_hit for r in got)
    served += got
    out["wall_s"] = time.perf_counter() - t0
    out["latency_ms"] = [r.latency_ms for r in served]
    return out


def served_line(out: dict) -> str:
    """:func:`serve_script`'s latencies and rate, host clock."""
    lat = np.asarray(out["latency_ms"])
    return (f"{len(lat)} requests in {out['wall_s']:.3f} s, "
            f"{len(lat) / out['wall_s']:.2f} requests/s, p50 "
            f"{np.percentile(lat, 50):.3f} ms, p99 "
            f"{np.percentile(lat, 99):.3f} ms (host clock)")


def small_live(root: Path) -> tuple:
    """Phase 12's small graph (``SMALL_SHARDED``) as a ``LiveDir`` under
    ``root``, one TSV line an edge (node ``v`` named ``n<v>`` and its
    tokens ``t<token>``), and the fragment of one delta: a shortcut from
    node 0 to the last node and a new entity ``zzz fresh`` beside node 0.
    Returns (live path, fragment path, the clients' queries, the queries
    asked after the swap)."""
    from repro_torch.graph.generators import lod_like_graph
    from repro_torch.graph.index import mid_df_tokens
    from repro_torch.live import LiveDir
    from repro_torch.store import ingest_tsv

    n_s, e_s, _ = SMALL_SHARDED
    gs, toks = lod_like_graph(n_s, e_s, seed=5, vocab=200)
    name = [f"n{v} " + " ".join(f"t{t}" for t in row)
            for v, row in enumerate(toks)]
    src = np.repeat(np.arange(gs.n_nodes), np.diff(gs.indptr))
    keep = src < gs.indices
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    (root / "small.tsv").write_text("".join(
        f"{name[u]}\t{name[v]}\tlinks\n"
        for u, v in zip(src[keep], gs.indices[keep])))
    live = LiveDir.initialize(root / "live", ingest_tsv(root / "small.tsv"))
    frag = root / "frag-0001.tsv"
    frag.write_text(f"{name[0]}\t{name[n_s - 1]}\tshortcut\t1.0\n"
                    f"zzz fresh\t{name[0]}\tmentions\t0.9\n")
    mid = mid_df_tokens(live.chain().index())
    pool = [list(mid[3 * i:3 * i + 3]) for i in range(4)]
    return live.path, frag, pool, pool + [["fresh", "n0"]]


def small_policy():
    from repro_torch.engine import ExecutionPolicy

    return ExecutionPolicy(partition="sharded",
                           frontier_frac=SMALL_SHARDED[2])


def rank_swap(device, live_path, frag, pool, post) -> dict:
    """A live swap across ranks: rank 0 serves ``pool`` from client
    threads, appends ``frag`` to the ``LiveDir`` and swaps onto the grown
    chain under that load, then serves ``post``; the other ranks
    follow."""
    import threading

    from repro_torch.distributed import comm
    from repro_torch.engine import QueryEngine
    from repro_torch.launch.serve_dks import wait_for
    from repro_torch.live import EngineSwapper, LiveDir
    from repro_torch.serve import DKSService, ServeConfig, follow

    live = LiveDir(live_path)
    eng = QueryEngine.build(artifact=live.chain(), device=device,
                            policy=small_policy())
    if comm.rank() > 0:
        return {"logs": follow(eng)}
    failures, stop = [], threading.Event()
    with DKSService(eng, ServeConfig(max_batch=4, max_wait_ms=10.0)) as svc:
        swapper = EngineSwapper(svc)

        def client(i):
            while not stop.is_set():
                try:
                    svc.query(pool[i % len(pool)], k=2,
                              timeout=SERVE_TIMEOUT_S)
                except Exception as exc:
                    failures.append(repr(exc))
                    return

        threads = [threading.Thread(target=client, args=(i,), daemon=True)
                   for i in range(SWAP_CLIENTS)]
        try:
            for t in threads:
                t.start()
            wait_for(lambda: svc.stats().requests >= SWAP_REQUESTS,
                     SERVE_TIMEOUT_S, "the load before the swap")
            live.append([frag])
            t0 = time.perf_counter()
            swapper.swap_to(live.chain())
            swap_s = time.perf_counter() - t0
            n = svc.stats().requests
            wait_for(lambda: failures or
                     svc.stats().requests >= n + SWAP_REQUESTS,
                     SERVE_TIMEOUT_S, "the load after the swap")
        finally:
            stop.set()
            for t in threads:
                t.join(SERVE_TIMEOUT_S)
        post_served = [result_record(svc.query(q, k=2,
                                               timeout=SERVE_TIMEOUT_S)
                                     .result) for q in post]
        stats = svc.stats()
    return {"logs": list(svc.records), "failures": failures,
            "swaps": swapper.swaps, "version": svc.engine.version,
            "post": post_served, "requests": stats.requests,
            "swap_s": swap_s}


def rank_serve(device, eng, bucket, singles, live) -> dict:
    """The serving leg on one shard a rank: rank 0 serves
    :func:`serve_script` through ``DKSService`` while the other ranks
    follow; then, with ``live``, :func:`rank_swap`.  Every rank returns
    its record logs."""
    from repro_torch.distributed import comm
    from repro_torch.serve import DKSService, ServeConfig, follow

    t0 = time.perf_counter()
    if comm.rank() > 0:
        out = {"logs": follow(eng)}
    else:
        with DKSService(eng, ServeConfig(**SERVE_CONFIG)) as svc:
            out = serve_script(svc, bucket, singles)
        out["logs"] = list(svc.records)
    out["serve_s"] = time.perf_counter() - t0
    if live is not None:
        out["swap"] = rank_swap(device, *live)
    return out


def rank_dks(device, graph, index, bucket, stepwise: bool = False,
             serve: tuple | None = None) -> dict:
    """One shard a rank: ``comm``'s collectives held, then the bucket
    through the sharded engine and, with ``stepwise``, the stepwise
    surfaces (:func:`rank_stepwise`), and with ``serve`` (the single
    queries and :func:`small_live`'s tuple or None) the serving leg
    (:func:`rank_serve`), every collective through the group (at one rank
    too)."""
    from repro_torch.core.dks_sharded import frontier_cap
    from repro_torch.distributed import comm
    from repro_torch.engine import ExecutionPolicy, QueryEngine
    from repro_torch.kernels.batched_backtrace import ops as bt_ops
    from repro_torch.kernels.lane_superstep import ops as ls_ops
    from repro_torch.kernels.subset_combine import ops as sc_ops

    policy = ExecutionPolicy(partition="sharded", frontier_frac=1.0)
    eng = QueryEngine.build(graph, index=index, device=device,
                            policy=policy)
    fg = eng.device_graph
    check(fg.n_shards == comm.world_size() and fg.n_held == 1,
          f"rank {comm.rank()}: {fg.n_held} of {fg.n_shards} shards")
    comm.issued.clear()
    rank_comm(device)
    checked = dict(comm.issued)
    kernels = (ls_ops, sc_ops, bt_ops)
    for ops in kernels:
        ops.counter.reset()
    reset_peak(device)
    comm.issued.clear()
    with comm.through_group():
        res, ms = sharded_bucket(eng, bucket)
    issued = dict(comm.issued)
    if stepwise:
        with comm.through_group():
            steps = rank_stepwise(device, eng, bucket)
    if serve is not None:
        with comm.through_group():
            served = rank_serve(device, eng, bucket, *serve)
    out = {**rank_header(device), "ms": ms, "peak": peak_bytes(device),
           "driver_ms": res[0].wall_time_s * 1e3,
           "issued": issued, "checked": checked,
           "launches": sum(ops.launches for ops in kernels),
           "results": [result_record(r) for r in res],
           "f_cap": frontier_cap(fg, policy.dks_config(BUCKET_M, BUCKET_K)),
           "n_loc": fg.n_loc}
    if comm.rank() == 0:
        out["digest"] = state_digest(res)
    if stepwise:
        out["stepwise"] = steps
    if serve is not None:
        out["serve"] = served
    return out


def moe_layer_inputs(cfg, x_shape, device):
    """One MoE layer of ``cfg`` (bf16 experts, f32 router) and x
    [*x_shape, d_model] in bf16, from a seeded generator on ``device``."""
    from repro_torch.models import moe as moe_lib

    gen = torch.Generator(device).manual_seed(RANKS_SEED)
    params = moe_lib.init_moe(gen, cfg.d_model, cfg.moe, cfg.moe.n_experts,
                              torch.bfloat16)
    x = torch.randn((*x_shape, cfg.d_model), generator=gen,
                    device=device, dtype=torch.bfloat16)
    return params, x


def rank_moe(device, cfg, x_shape) -> dict:
    """The expert-parallel MoE layer on a (data 1, model 2) mesh."""
    from repro_torch.distributed import comm
    from repro_torch.launch.mesh import shard_tree
    from repro_torch.models import moe as moe_lib

    mesh = comm.Mesh((1, 2), ("data", "model"), device.type)
    full, x = moe_layer_inputs(cfg, x_shape, device)
    local = {k: v.clone() for k, v in shard_tree(
        full, moe_lib.PARAM_SPECS, mesh).items()}
    del full
    j, s = mesh.axis_index("model"), x.shape[1] // 2
    x_loc = x[:, j * s:(j + 1) * s].contiguous()
    del x
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reset_peak(device)
    times = []
    with torch.no_grad():
        for _ in range(RANKS_REPS):
            sync(device)
            t0 = time.perf_counter()
            y, aux, route = moe_lib._moe_sharded(local, x_loc, cfg.moe,
                                                 cfg.moe.n_experts, mesh)
            sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
    return {**rank_header(device), "ms": times, "peak": peak_bytes(device),
            "weights_bytes": sum(v.numel() * v.element_size()
                                 for v in local.values()),
            "y": y.cpu(), "route": [t.cpu() for t in route],
            "aux": {k: float(v) for k, v in aux.items()}}


def pp_smoke_inputs(cfg):
    """The smoke GPipe step's weights (on the CPU) and batch: phase 13's
    smoke step's."""
    from repro_torch.data import lm_synthetic_stream
    from repro_torch.models.transformer import init_lm

    model = init_lm(cfg, torch.Generator("cpu").manual_seed(TRAIN_SEED))
    batch = {k: torch.from_numpy(v) for k, v in next(lm_synthetic_stream(
        cfg.vocab, 4, 64, seed=TRAIN_SEED)).items()}
    return model, batch


def pp_tokens(cfg, shape, device):
    return torch.randint(0, cfg.vocab, shape, device=device,
                         generator=torch.Generator(device).manual_seed(1))


def rank_pp(device, cfg, tok_shape, smoke_cfg) -> dict:
    """An LM at full width over 2 stages (the flash kernel in each stage),
    then one f32 GPipe train step at the smoke size."""
    from repro_torch.distributed import comm
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import lm as lm_lib
    from repro_torch.models import pipeline as pp
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim import AdamWConfig

    mesh = comm.Mesh((PP_STAGES,), ("pod",), device.type)
    stage = mesh.axis_index("pod")
    model = init_lm(cfg, torch.Generator(device).manual_seed(LM_SEED))
    pp.keep_stage_layers(model, stage, PP_STAGES)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    toks = pp_tokens(cfg, tok_shape, device)
    reset_peak(device)
    times = []
    with torch.no_grad():
        for i in range(RANKS_REPS):
            fa_ops.counter.reset()
            sync(device)
            t0 = time.perf_counter()
            hidden = pp.pp_hidden_forward(
                model, toks, n_stages=PP_STAGES, n_micro=PP_MICRO,
                attn_impl=PP_ATTN, mesh=mesh)
            sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
    out = {**rank_header(device), "ms": times, "peak": peak_bytes(device),
           "weights_bytes": weights, "launches": fa_ops.launches,
           "hidden": hidden.cpu()}
    del model, hidden
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # One f32 GPipe step at the smoke size.
    small, batch = pp_smoke_inputs(smoke_cfg)
    small = small.to(device)
    pp.keep_stage_layers(small, stage, PP_STAGES)
    state = lm_lib.init_train_state(small)
    step = pp.make_pp_train_step(AdamWConfig(**SMOKE_OPT),
                                 n_stages=PP_STAGES, n_micro=PP_MICRO,
                                 attn_impl="naive", mesh=mesh)
    state, m = step(state, {k: v.to(device) for k, v in batch.items()})
    out["smoke"] = {"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    "params": {k: p.detach().cpu() for k, p in
                               state.model.named_parameters()}}
    return out


def count_of(c) -> dict:
    """What a ``count.Counter`` saw: collective bytes by kind, eager
    bytes, and {op: (calls, bytes, FLOPs)}."""
    summary = c.summary()
    return {"collective_bytes": summary.collective_bytes,
            "eager_bytes": summary.eager_bytes,
            "ops": {k: (v.calls, v.nbytes, v.flops)
                    for k, v in c.ops.items()}}


def pp3_cfg(cfg, dtype: str):
    return cfg.scaled(n_layers=PP3_LAYERS, param_dtype=dtype)


def pp3_batch(cfg, device) -> dict:
    toks = pp_tokens(cfg, PP3_STEP_TOKENS, device)
    return {"tokens": toks, "labels": torch.roll(toks, -1, 1)}


def rank_pp3(device, cfg, fwd_dtype: str = "bfloat16") -> dict:
    """GPipe on a (pod 2, data 1, model 2) mesh: ``cfg`` at full width cut
    to :data:`PP3_LAYERS` layers, built at ``tp=2``, this rank's slice by
    ``stage_layer_specs``: a ``fwd_dtype`` forward through the flash
    kernel (its launches counted from 0 around the call), then one f32
    train step at AdamW's full lr under a ``count.Counter``
    (:func:`count_of`)."""
    from repro_torch.analysis import count
    from repro_torch.distributed import comm
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.mesh import shard_lm
    from repro_torch.models import lm as lm_lib
    from repro_torch.models import pipeline as pp
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import AdamWConfig

    clock = {"start": time.time()}
    mesh = comm.Mesh(*PP3_MESH, device.type)
    stage = mesh.axis_index("pod")
    tp = mesh.axis_size("model")

    def stage_model(dtype):
        b = tfm.build(pp3_cfg(cfg, dtype), tp)
        whole = tfm.init_lm(b, torch.Generator(device).manual_seed(LM_SEED))
        model = shard_lm(whole, mesh, pp.stage_layer_specs(b))
        del whole
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        return pp.keep_stage_layers(model, stage, PP_STAGES)

    model = stage_model(fwd_dtype)
    clock[f"{fwd_dtype} model"] = time.time()
    toks = pp_tokens(cfg, PP3_TOKENS, device)
    reset_peak(device)
    routed: list = []
    with torch.no_grad(), routes_recorded(routed):
        fa_ops.counter.reset()
        sync(device)
        t0 = time.perf_counter()
        hidden = pp.pp_hidden_forward(model, toks, n_stages=PP_STAGES,
                                      n_micro=PP_MICRO, attn_impl=PP_ATTN,
                                      mesh=mesh)
        sync(device)
        fwd_ms = (time.perf_counter() - t0) * 1e3
        launches = fa_ops.launches
    out = {**rank_header(device), "coords": mesh.coords,
           "rank": comm.rank(), "launches": launches, "fwd_ms": fwd_ms,
           "hidden": hidden.cpu(), "routed": routed}
    clock["forward"] = time.time()
    del model, hidden
    model = stage_model("float32")
    clock["f32 model"] = time.time()
    state = lm_lib.init_train_state(model)
    step = pp.make_pp_train_step(AdamWConfig(**SMOKE_OPT),
                                 n_stages=PP_STAGES, n_micro=PP_MICRO,
                                 attn_impl="naive", mesh=mesh)
    batch = pp3_batch(cfg, device)
    with count.Counter() as counter:
        sync(device)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        sync(device)
    clock["step"] = time.time()
    # The new parameters (about 2 GB a rank in f32) go to a file: through
    # the spawn's result pipe they took minutes on the card's host.
    params = PP3_DIR / f"{cfg.name}-rank{comm.rank()}.pt"
    params.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: p.detach() for k, p in state.model.named_parameters()},
               params)
    clock["params to a file"] = time.time()
    out.update(ms=(time.perf_counter() - t0) * 1e3, peak=peak_bytes(device),
               loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
               count=count_of(counter), params=str(params),
               clock=clock)
    return out


@contextlib.contextmanager
def routes_recorded(calls: list):
    """Every MoE router call inside the block appends its ids [T, k] (on
    the host) to ``calls``."""
    from repro_torch.models import moe as moe_lib

    route = moe_lib._route

    def recording(router, x, spec, n_real, e_pad):
        out = route(router, x, spec, n_real, e_pad)
        calls.append(out[1].cpu())
        return out

    moe_lib._route = recording
    try:
        yield calls
    finally:
        moe_lib._route = route


@contextlib.contextmanager
def routes_replayed(next_ids, stats: dict):
    """Every MoE router call inside the block routes to ``next_ids()``
    [T, k] (another program's picks), its gates from its own
    probabilities at them; ``stats`` counts the tokens whose own top-k
    differs and keeps the worst relative gap between its k-th probability
    and the replayed set's smallest."""
    from repro_torch.models import moe as moe_lib

    route = moe_lib._route

    def replaying(router, x, spec, n_real, e_pad):
        _, ids, probs, logits = route(router, x, spec, n_real, e_pad)
        want = next_ids().to(ids.device)
        differ = (ids.sort(dim=-1).values != want.sort(dim=-1).values
                  ).any(dim=-1)
        if bool(differ.any()):
            kth = probs.gather(1, ids[:, -1:])[:, 0]
            low = probs.gather(1, want).min(dim=-1).values
            gap = ((kth - low) / kth)[differ]
            stats["flips"] += int(differ.sum())
            stats["gap"] = max(stats["gap"], float(gap.max()))
        gate = probs.gather(1, want)
        gate = gate / gate.sum(dim=-1, keepdim=True).clamp(min=1e-9)
        return gate, want, probs, logits

    moe_lib._route = replaying
    try:
        yield stats
    finally:
        moe_lib._route = route


def rank_quad(device, graph, index, bucket, stepwise, serve, cfg,
              moe_cfg) -> dict:
    """The 4-rank spawn: DKS (its stepwise and serving legs), then GPipe
    on (pod 2, data 1, model 2) with ``cfg`` and with ``moe_cfg``'s MoE
    stages, then the dense DKS cell on (data 2, model 2)."""
    out = {"dks": rank_dks(device, graph, index, bucket, stepwise, serve)}
    for key, arch_cfg, dtype in (("pp3", cfg, "bfloat16"),
                                 ("pp3_moe", moe_cfg, "float32")):
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out[key] = rank_pp3(device, arch_cfg, dtype)
        out[key]["leg_s"] = time.perf_counter() - t0
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["dense"] = rank_dense(device)
    return out


def rank_dense(device) -> dict:
    """The dense DKS cell (``DENSE_DATASET``, m = 4, K = 2) on a
    ``DENSE_MESH`` mesh: this rank's arguments by ``repro``'s in-specs,
    cut from phase 17's draw (``ACCOUNTING_SEED``), one superstep under a
    ``count.Counter`` (the bytes each collective moved a rank), then the
    state gathered whole; rank 0 returns its :func:`dks_digest`."""
    from repro_torch.analysis import count
    from repro_torch.core.dks import STATE_FIELDS
    from repro_torch.distributed import comm
    from repro_torch.launch import cells

    t0 = time.perf_counter()
    mesh = comm.Mesh(*DENSE_MESH, device.type)
    fn, args = cells.dks_cell_dense(DENSE_DATASET, mesh=mesh).build(
        device, torch.Generator(device).manual_seed(ACCOUNTING_SEED))
    s_bytes = args[1].S.numel() * args[1].S.element_size()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reset_peak(device)
    sync(device)
    t1 = time.perf_counter()
    with count.Counter() as counter:
        state = fn(*args)
        sync(device)
    t2 = time.perf_counter()
    peak = peak_bytes(device)
    del fn, args
    whole = {f: comm.unshard(getattr(state, f), cells.DENSE_SPECS.get(
        f, comm.PartitionSpec()), mesh) for f in STATE_FIELDS}
    digest = dks_digest(whole) if comm.rank() == 0 else None
    del state, whole
    return {**rank_header(device), "rank": comm.rank(),
            "coords": mesh.coords, "digest": digest, "ms": (t2 - t1) * 1e3,
            "peak": peak, "s_bytes": s_bytes,
            "collective_bytes": counter.summary().collective_bytes,
            "build_s": t1 - t0, "gather_s": time.perf_counter() - t2,
            "leg_s": time.perf_counter() - t0}


def dense_held(card: str, outs: list, want: dict) -> None:
    """:func:`rank_dense`'s ranks: the gathered state's digest against
    phase 17's one-card superstep, field by field."""
    got = outs[0]["digest"]
    odd = [f for f in want if got[f] != want[f]]
    check(not odd, f"the dense DKS cell on {DENSE_MESH}: fields {odd} "
          f"differ from phase 17's one-card superstep")
    kinds = outs[0]["collective_bytes"]
    check(all(o["collective_bytes"] == kinds for o in outs),
          f"the dense DKS cell on {DENSE_MESH}: the ranks' collective "
          f"bytes differ: {[o['collective_bytes'] for o in outs]}")
    ranks_line(f"dense DKS {DENSE_DATASET} (m 4, K 2) on (data, model) "
               f"{DENSE_MESH[0]}", outs, card,
               f"; {outs[0]['s_bytes'] / 1e6:.1f} MB of S a rank; one "
               f"superstep with the counter on; bytes each collective "
               f"moved a rank (GB, by kind) "
               f"{ {k: round(v / 1e9, 4) for k, v in kinds.items()} }; "
               f"every field's sha256 == phase 17's one-card superstep; "
               f"build {max(o['build_s'] for o in outs):.1f} s, gather "
               f"{max(o['gather_s'] for o in outs):.1f} s, leg "
               f"{max(o['leg_s'] for o in outs):.1f} s a rank")


def ranks_routes(outs: list, lps: int) -> dict:
    """{(micro-batch, layer): the router ids} of :func:`rank_pp3`'s
    forward, from the first ``model`` rank of each stage: its calls run
    tick by tick, its ``lps`` layers each tick, and stage ``p`` holds
    micro-batch ``tick - p`` (the ticks before and after are idle)."""
    replay = {}
    for o in outs:
        if any(o["coords"][a] for a in ("data", "model")):
            continue
        p = o["coords"]["pod"]
        for c, ids in enumerate(o["routed"]):
            tick, j = divmod(c, lps)
            if 0 <= tick - p < PP_MICRO:
                replay[tick - p, p * lps + j] = ids
    return replay


def pp3_clock(outs: list, returned: float) -> str:
    """The 4-rank leg's host seconds by part, the slowest rank's, and the
    return of the results to the parent (``returned``: its wall time)."""
    parts, last = {}, None
    for o in outs:
        c = o["clock"]
        names = list(c)
        for a, b in zip(names, names[1:]):
            parts[b] = max(parts.get(b, 0.0), c[b] - c[a])
        last = max(last or 0.0, c[names[-1]])
    parts["from its end to the spawn's return"] = returned - last
    return ", ".join(f"{k} {v:.1f} s" for k, v in parts.items())


def pp3_held(dev, card: str, cfg, outs: list, returned: float,
             fwd_dtype: str = "bfloat16", tol: float = PP3_TOL) -> list:
    """:func:`rank_pp3`'s ranks against the one-process twin at the same
    padding, run once here: the ``fwd_dtype`` hidden states (within
    ``tol`` x max), the flash launches, the f32 step's loss,
    ``grad_norm`` and each rank's slice of the new parameters
    (:func:`step_held`), and each rank's count of its step against a
    ``CountingMesh``'s count of its stage's step on ``meta``.  A MoE
    twin runs the mesh's dispatch (:func:`mesh_dispatch`), one
    micro-batch's rows a call.  Returns the ranks' flash launches."""
    from repro_torch.analysis import count
    from repro_torch.distributed import comm
    from repro_torch.launch.mesh import shard_tree
    from repro_torch.models import lm as lm_lib
    from repro_torch.models import pipeline as pp
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import AdamWConfig, adamw_update

    t0 = time.perf_counter()
    tp = dict(zip(PP3_MESH[1], PP3_MESH[0]))["model"]
    lps = PP3_LAYERS // PP_STAGES
    gen = lambda: torch.Generator(dev).manual_seed(LM_SEED)  # noqa: E731
    def twin_of(b):
        twin = tfm.init_lm(b, gen())
        return mesh_dispatch(twin, tp) if cfg.moe is not None else twin

    # (a) the forward; a MoE twin routes as the ranks routed.
    twin = twin_of(tfm.build(pp3_cfg(cfg, fwd_dtype), tp))
    toks = pp_tokens(cfg, PP3_TOKENS, dev)
    mb = PP3_TOKENS[0] // PP_MICRO
    replay, ties = ranks_routes(outs, lps), {"flips": 0, "gap": 0.0}
    order = iter(replay[t, layer] for t in range(PP_MICRO)
                 for layer in range(PP3_LAYERS))
    with torch.no_grad(), (routes_replayed(lambda: next(order), ties)
                           if cfg.moe is not None
                           else contextlib.nullcontext()):
        hidden = torch.cat([twin(toks[i:i + mb], attn_impl=PP_ATTN)[0]
                            for i in range(0, len(toks), mb)])
    check(ties["gap"] <= NEAR_TIE, f"GPipe {cfg.name} on {PP3_MESH}: "
          f"{ties['flips']} routed tokens differ from the twin's own "
          f"top-k by up to {ties['gap']:.3g} of its k-th probability "
          f"(a near tie is at most {NEAR_TIE})")
    scale = float(hidden.float().abs().max())
    err = max(max_abs_err(o["hidden"].to(dev).float(), hidden.float())
              for o in outs)
    off = (outs[0]["hidden"].to(dev).float() - hidden.float()).abs().amax(
        dim=-1) > tol * scale
    check(err <= tol * scale, f"GPipe {cfg.name} on {PP3_MESH}: hidden "
          f"states differ from the twin by {err} > {tol} x {scale} at "
          f"{int(off.sum())} of {off.numel()} positions (first "
          f"{off.nonzero()[:4].tolist()})")
    want = (PP_MICRO + PP_STAGES - 1) * lps
    launches = [o["launches"] for o in outs]
    check(launches == [want] * len(outs), f"GPipe {cfg.name} on {PP3_MESH}: flash "
          f"launches {launches}, want {want} a rank")
    del twin, hidden
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # (b) one f32 step at AdamW's full lr.
    opt_cfg = AdamWConfig(**SMOKE_OPT)
    b = tfm.build(pp3_cfg(cfg, "float32"), tp)
    twin = twin_of(b)
    state = lm_lib.init_train_state(twin)
    params = dict(twin.named_parameters())
    batch = pp3_batch(cfg, dev)
    # The pipeline's objective: the cross entropy alone (no MoE aux loss).
    hidden, _, _ = twin(batch["tokens"], attn_impl="naive")
    loss = lm_lib.chunked_ce(twin, hidden, batch["labels"])
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    loss = loss.detach()
    del hidden
    with torch.no_grad():
        _, _, m = adamw_update(opt_cfg, grads, state.opt, params)
    rel = {}
    for key, want_v in (("loss", float(loss)),
                        ("grad_norm", float(m["grad_norm"]))):
        rel[key] = max(abs(o[key] - want_v) / abs(want_v) for o in outs)
        check(rel[key] <= PP3_STEP_TOL, f"GPipe {cfg.name} on {PP3_MESH}: {key} "
              f"{[o[key] for o in outs]} against the twin's {want_v}")
    specs = tfm.named_param_specs(b, pp.stage_layer_specs(b))
    room, worst, strict = 0.0, "", []
    for o in outs:
        mesh = comm.CountingMesh(*PP3_MESH, rank=o["rank"])
        stage = mesh.axis_index("pod")
        got = torch.load(o["params"], map_location=dev)
        names = list(got)
        whole = [n if not n.startswith("layers.") else
                 f"layers.{stage * lps + int(n.split('.')[1])}."
                 f"{n.split('.', 2)[2]}" for n in names]
        cut = lambda tree: shard_tree(  # noqa: E731
            {n: tree[w].detach() for n, w in zip(names, whole)},
            {n: specs[w] for n, w in zip(names, whole)}, mesh)
        mine, g = cut(params), cut(grads)
        r, i, share = step_held([got[n] for n in names],
                                [mine[n] for n in names],
                                [g[n] for n in names], opt_cfg.lr,
                                PP3_STEP_TOL, PP3_STEP_TOL)
        del got, mine, g
        Path(o["params"]).unlink()
        strict.append(share)
        if r >= room:
            room, worst = r, f"rank {o['rank']} {names[i]}"
    check(room <= 1.0, f"GPipe {cfg.name} on {PP3_MESH}: the step's parameters "
          f"{room:.3g} x their bound from the twin's ({worst})")
    del twin, state, params, grads
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # (c) the count: a CountingMesh's count of each stage's step on meta.
    counted = {}
    for stage in range(PP_STAGES):
        cmesh = comm.CountingMesh(*PP3_MESH, rank=int(np.ravel_multi_index(
            (stage, 0, 0), PP3_MESH[0])))
        meta = pp.keep_stage_layers(tfm.LM(b, device="meta", mesh=cmesh,
                                           specs=pp.stage_layer_specs(b)),
                                    stage, PP_STAGES)
        step = pp.make_pp_train_step(opt_cfg, n_stages=PP_STAGES,
                                     n_micro=PP_MICRO, attn_impl="naive",
                                     mesh=cmesh)
        state = lm_lib.init_train_state(meta)
        with count.Counter() as c:
            step(state, {k: torch.empty(v.shape, dtype=v.dtype,
                                        device="meta")
                         for k, v in batch.items()})
        counted[stage] = count_of(c)
    for o in outs:
        got, want = o["count"], counted[o["coords"]["pod"]]
        check(got["collective_bytes"] == want["collective_bytes"],
              f"GPipe {cfg.name} on {PP3_MESH}: rank {o['rank']}'s counter counts "
              f"{got['collective_bytes']}, the counting mesh "
              f"{want['collective_bytes']}")
        # Ops that move bytes or do FLOPs; allocation-only ops move
        # nothing (the card's rank allocates 2 fewer `empty`s than meta).
        moved = [{k: v for k, v in c["ops"].items() if v[1] or v[2]}
                 for c in (got, want)]
        odd = {k: (moved[0].get(k), moved[1].get(k))
               for k in set(moved[0]) | set(moved[1])
               if moved[0].get(k) != moved[1].get(k)}
        check(not odd and got["eager_bytes"] == want["eager_bytes"],
              f"GPipe {cfg.name} on {PP3_MESH}: rank {o['rank']}'s counter and the "
              f"counting mesh differ op for op (rank, meta): {odd}; eager "
              f"bytes {got['eager_bytes']} and {want['eager_bytes']}")
    check(counted[0]["collective_bytes"] == counted[1]["collective_bytes"],
          f"GPipe {cfg.name} on {PP3_MESH}: the stages' collective bytes differ")
    wire = count.wire_bytes(counted[0]["collective_bytes"])
    n_ops = sum(v[0] for v in counted[0]["ops"].values() if v[1] or v[2])
    eager = counted[0]["eager_bytes"]
    gb = {k: round(v / 1e9, 4)
          for k, v in counted[0]["collective_bytes"].items()}
    ranks_line(f"GPipe {cfg.name} on (pod, data, model) {PP3_MESH[0]}",
               outs, card,
               f"; {PP3_LAYERS} of {cfg.n_layers} layers at full width, "
               f"tp={tp}, cut by stage_layer_specs; {fwd_dtype} forward of "
               f"{list(PP3_TOKENS)} tokens in {PP_MICRO} micro-batches "
               f"{max(o['fwd_ms'] for o in outs):.1f} ms, {launches} flash "
               f"launches, hidden within {err:.3g} of the twin (limit "
               f"{tol} x {scale:.3g}"
               + (f"; the twin routed as the ranks, {ties['flips']} "
                  f"token-layers a near tie off its own top-k, gap at "
                  f"most {ties['gap']:.3g}" if cfg.moe is not None else "")
               + "); f32 step of "
               f"{list(PP3_STEP_TOKENS)} tokens at lr {opt_cfg.lr} "
               f"(warm-up 1): loss {outs[0]['loss']:.6f}, grad_norm "
               f"{outs[0]['grad_norm']:.6f} (within {rel['loss']:.3g} and "
               f"{rel['grad_norm']:.3g} of the twin's, relative), "
               f"parameters within "
               f"{room:.3g} of their bound (worst {worst}; strict share "
               f"{min(strict):.4f}); each rank's counter == the counting "
               f"mesh's count on meta, op for op ({n_ops:.0f} calls that "
               f"move bytes or do FLOPs, {eager / 1e9:.4f} GB eager) and by "
               f"kind "
               f"(GB, counted, not measured) {gb}, wire {wire / 1e9:.4f} "
               f"GB a rank, "
               f"t_collective {wire / rl.NVLINK_BYTES_PER_S * 1e3:.3f} ms "
               f"at NVLink 4's 450 GB/s beside the step's "
               f"{max(o['ms'] for o in outs):.1f} ms over gloo with the "
               f"counter on (four ranks sharing one card: not a time "
               f"across cards); twin and "
               f"count here {time.perf_counter() - t0:.1f} s, leg "
               f"{max(o['leg_s'] for o in outs):.1f} s a rank: "
               f"{pp3_clock(outs, returned)}")
    return launches


def ring_leaf(shape, rank: int, i: int, device) -> torch.Tensor:
    """Rank ``rank``'s gradient of leaf ``i``: seeded normals."""
    gen = torch.Generator(device).manual_seed(RANKS_SEED + 1000 * rank + i)
    return torch.randn(shape, generator=gen, device=device)


def ring_shapes(cfg) -> list:
    """The leaf shapes of a DCN-v2 parameter tree, in flatten order."""
    from repro_torch.models import recsys
    from repro_torch.optim.optimizers import tree_leaves

    return tree_leaves(recsys.param_shapes(cfg),
                       is_leaf=lambda x: isinstance(x, tuple))


def rank_ring(device, shapes) -> dict:
    """The int8 ring all-reduce over DCN-v2's gradient tree (one step of
    error feedback from zero), then every leaf held bit for bit against
    the twin run on both ranks' gradients."""
    from repro_torch.distributed import comm
    from repro_torch.distributed import compression as comp

    mesh = comm.Mesh((comm.world_size(),), ("data",), device.type)
    r, n = comm.rank(), comm.world_size()
    grads = [ring_leaf(s, r, i, device) for i, s in enumerate(shapes)]
    state = comp.init_compression(grads)
    reset_peak(device)
    sync(device)
    t0 = time.perf_counter()
    red, state = comp.compressed_allreduce(grads, state, mesh)
    sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    peak = peak_bytes(device)
    equal = True
    for i, s in enumerate(shapes):
        both = torch.stack([grads[i] if q == r else ring_leaf(s, q, i, device)
                            for q in range(n)])
        t_red, t_state = comp.compressed_allreduce_twin(
            [both], comp.init_compression([both]), n)
        equal &= bool(torch.equal(t_red[0][r], red[i])
                      and torch.equal(t_state.error[0][r], state.error[i]))
        del both, t_red, t_state
    return {**rank_header(device), "ms": ms, "peak": peak, "equal": equal,
            "numel": sum(int(np.prod(s)) for s in shapes),
            "leaves": len(shapes)}


def tp_inputs(cfg, b, device, batch: int | None = None):
    """Phase 6's weights and tokens at the build ``b`` (a whole model on
    ``device``): the generator seeded ``LM_SEED`` draws the weights, then
    phase 6's two requests; the prompts are the first ``batch`` rows of
    its first (all of them by default), the decode is teacher-forced by the first ``TP_DECODE``
    tokens of its second in every row."""
    from repro_torch.models import transformer as tfm

    gen = torch.Generator(device).manual_seed(LM_SEED)
    model = tfm.init_lm(b, gen)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT),
                            generator=gen, device=device)
    long = torch.randint(0, cfg.vocab, (1, LM_LONG), generator=gen,
                         device=device)
    prompts = prompts[:batch]
    return model, prompts, long[:, :TP_DECODE].expand(len(prompts), -1)


def timed_ms(dev, fn, *args):
    """(host ms of ``fn(*args)`` ended by a synchronize, its result)."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn(*args)
    sync(dev)
    return (time.perf_counter() - t0) * 1e3, out


def tp_serve(model, b, prompts, feed, mesh, quant: bool) -> dict:
    """A bf16 prefill through the flash kernel, twice: the first (cold)
    call pays the groups' and cuBLAS's set-up and the allocator's growth,
    the second (warm) is timed on its own; the flash launches are those of
    the first.  Then the decode teacher-forced by ``feed`` against the
    warm prefill's cache grown to S + ``TP_DECODE`` (split on the sequence
    on a mesh) and, with ``quant``, ``TP_QUANT_STEPS`` steps against it
    quantized into ``TP_QUANT_SEQ`` positions; of each, the first step is
    timed apart (cold) from the mean of the others (warm).  Returns the
    warm logits (whole vocabulary, on the CPU), the host ms of each call
    ended by a synchronize, the flash launches and the peak."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import lm as lm_lib

    dev = prompts.device
    prefill = lm_lib.make_prefill_step("cuda")
    fa_ops.counter.reset()
    reset_peak(dev)
    cold, _ = timed_ms(dev, prefill, model, prompts)
    out = {"prefill_cold_ms": cold, "launches": fa_ops.launches}
    out["prefill_ms"], (logits, cache) = timed_ms(dev, prefill, model,
                                                  prompts)
    out["prefill"] = logits.cpu()
    s = prompts.shape[1]
    qc = lm_lib.quantize_cache(b, cache, TP_QUANT_SEQ, mesh) if quant \
        else None
    c = lm_lib.grow_cache(b, cache, s + feed.shape[1], mesh)
    del cache

    def steps(step, cache, n, key):
        logits, ms = [], []
        for t in range(n):
            t_ms, (lg, cache) = timed_ms(dev, step, cache, feed[:, t:t + 1])
            logits.append(lm_lib.gather_vocab(model, lg[:, -1]))
            ms.append(t_ms)
        out[f"{key}_cold_ms"], out[f"{key}_ms"] = ms[0], float(np.mean(ms[1:]))
        out[key] = torch.stack(logits).cpu()

    with torch.no_grad():
        steps(model.decode_step, c, feed.shape[1], "decode")
        del c
        if quant:
            steps(functools.partial(model.decode_step_quant, chunk=TP_CHUNK),
                  qc, TP_QUANT_STEPS, "quant")
    out["peak"] = peak_bytes(dev)
    return out


def rank_tp_lm(device, cfg) -> dict:
    """``cfg`` at full width on a ``TP_MESH`` mesh: phase 6's weights,
    built at the mesh's ``model`` size and cut to this rank
    (``shard_lm``), then :func:`tp_serve`."""
    from repro_torch.distributed import comm
    from repro_torch.launch.mesh import shard_lm
    from repro_torch.models import transformer as tfm

    t0 = time.perf_counter()
    mesh = comm.Mesh(TP_MESH, ("data", "model"), device.type)
    b = tfm.build(cfg, TP_MESH[1])
    whole, prompts, feed = tp_inputs(cfg, b, device, TP_BATCH)
    model = shard_lm(whole, mesh)
    del whole
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    comm.issued.clear()
    out = tp_serve(model, b, prompts, feed, mesh, True)
    return {**rank_header(device), **out, "issued": dict(comm.issued),
            "weights_bytes": sum(p.numel() * p.element_size()
                                 for p in model.parameters()),
            "leg_s": time.perf_counter() - t0}


def mesh_dispatch(model, tp: int):
    """The one-process ``model`` with each MoE layer dispatched as a
    (data 1, model ``tp``) mesh dispatches it (``moe.dispatch_kind``): a
    prefill through ``moe_sharded_twin`` on each rank's sequence block, a
    decode step through ``moe_dense_all_twin``, each the ranks' arithmetic
    with the collectives done as tensor ops.  Patches the layers in place
    (again on a second call) and returns ``model``."""
    import types

    from repro_torch.models import moe as moe_lib

    grid = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 1, "model": tp})

    def forward(layer, x, sp=False):
        params = {n: getattr(layer, n) for n in moe_lib.PARAMS}
        b, s, d = x.shape
        n_real = layer.spec.n_experts
        if moe_lib.dispatch_kind(b, s, grid) == "sharded":
            y, aux, _ = moe_lib.moe_sharded_twin(params, x, layer.spec,
                                                 n_real, 1, tp)
            return y, aux
        y, aux = moe_lib.moe_dense_all_twin(params, x.reshape(b * s, d),
                                            layer.spec, n_real, tp)
        return y.reshape(b, s, d), aux

    for layer in model.layers:
        layer.moe.forward = functools.partial(forward, layer.moe)
    return model


def tp_moe_cfg(cfg):
    """granite at ``TP_MOE_LAYERS`` layers in f32 (``TP_MOE_TOL``)."""
    return cfg.scaled(n_layers=TP_MOE_LAYERS, param_dtype="float32")


def rank_tp_moe(device, cfg) -> dict:
    """``cfg`` (:func:`tp_moe_cfg`) padded to ``TP_MESH``'s ``model`` size,
    on a (data 1, model = world) mesh: the residual split on the sequence
    feeds ``_moe_sharded`` its block; on one rank every collective goes
    through the group (``through_group``) and is counted."""
    from repro_torch.distributed import comm
    from repro_torch.launch.mesh import shard_lm
    from repro_torch.models import transformer as tfm

    t0 = time.perf_counter()
    world = comm.world_size()
    mesh = comm.Mesh((1, world), ("data", "model"), device.type)
    b = tfm.build(cfg, TP_MESH[1])
    whole, prompts, feed = tp_inputs(cfg, b, device)
    model = shard_lm(whole, mesh)
    del whole
    comm.issued.clear()
    with comm.through_group():
        out = tp_serve(model, b, prompts, feed[:, :2], mesh, False)
    return {**rank_header(device), **out, "issued": dict(comm.issued),
            "leg_s": time.perf_counter() - t0}


def tp_train_inputs(scfg):
    """The f32 smoke model at ``tp=TP_MESH[1]`` on the CPU (its weights
    from ``TRAIN_SEED``) and phase 13's smoke batch."""
    from repro_torch.data import lm_synthetic_stream
    from repro_torch.models import transformer as tfm

    b = tfm.build(scfg, TP_MESH[1])
    model = tfm.init_lm(b, torch.Generator("cpu").manual_seed(TRAIN_SEED))
    batch = {k: torch.from_numpy(v) for k, v in next(lm_synthetic_stream(
        scfg.vocab, 4, 64, seed=TRAIN_SEED)).items()}
    return b, model, batch


def tp_train_steps(model, batch) -> tuple[list, dict]:
    """``TP_TRAIN_STEPS`` f32 train steps (naive attention): (losses, the
    whole parameters on the CPU)."""
    from repro_torch.launch.mesh import gather_lm
    from repro_torch.models import lm as lm_lib
    from repro_torch.optim import AdamWConfig

    state = lm_lib.init_train_state(model)
    step = lm_lib.make_train_step(AdamWConfig(**TP_TRAIN_OPT),
                                  attn_impl="naive")
    losses = []
    for _ in range(TP_TRAIN_STEPS):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    whole = gather_lm(model) if model.mesh is not None else {
        k: p.detach() for k, p in model.named_parameters()}
    return losses, {k: v.cpu() for k, v in whole.items()}


def rank_tp_train(device, scfg) -> dict:
    """The f32 smoke train steps on a ``TP_MESH`` mesh on the card."""
    from repro_torch.distributed import comm
    from repro_torch.launch.mesh import shard_lm

    t0 = time.perf_counter()
    mesh = comm.Mesh(TP_MESH, ("data", "model"), device.type)
    _, whole, batch = tp_train_inputs(scfg)
    model = shard_lm(whole.to(device), mesh)
    losses, params = tp_train_steps(
        model, {k: v.to(device) for k, v in batch.items()})
    return {**rank_header(device), "losses": losses, "params": params,
            "leg_s": time.perf_counter() - t0}


def dcn_ranks_inputs(cfg, device) -> tuple[dict, dict]:
    """DCN-v2's whole parameters from ``RANKS_SEED`` (every rank draws the
    same) and phase 7's inputs: a batch of each of ``RANKS_DCN_SHAPES``
    (``recsys_synthetic_stream``, seed 0) and the candidates of
    ``CAND_SEED``."""
    from repro_torch.configs import RECSYS_SHAPES
    from repro_torch.data import recsys_synthetic_stream
    from repro_torch.models import recsys as rec

    params = rec.init_dcn(cfg, torch.Generator(device).manual_seed(
        RANKS_SEED))
    shapes = {s.name: s for s in RECSYS_SHAPES}
    batches = {name: rec.batch_to_device(next(recsys_synthetic_stream(
        cfg, shapes[name].batch, seed=0)), device)
        for name in RANKS_DCN_SHAPES}
    n_cand = -(-shapes["retrieval_cand"].n_candidates // 512) * 512
    batches["cand"] = torch.from_numpy(np.random.default_rng(
        CAND_SEED).integers(0, cfg.vocab_sizes[0], n_cand).astype(
            np.int32)).to(device)
    return params, batches


def dcn_calls(params, batches, cfg, mesh, opt) -> dict:
    """serve_bulk's logits (and x0), retrieval_cand's top 100 and one
    train_batch step on ``params`` (this rank's slices on ``mesh``, or the
    whole model), each timed; the step's AdamW state is ``opt``."""
    from repro_torch.distributed.comm import PartitionSpec
    from repro_torch.launch.mesh import data_rows, shard_tree
    from repro_torch.launch.train import make_recsys_step
    from repro_torch.models import recsys as rec
    from repro_torch.optim import AdamWConfig, tree_leaves

    dev = batches["cand"].device
    rows = (lambda x: data_rows(x, mesh)) if mesh is not None else \
        (lambda x: x)
    serve = {k: rows(v) for k, v in batches["serve_bulk"].items()}
    query = batches["retrieval_cand"]
    cand = batches["cand"] if mesh is None else shard_tree(
        batches["cand"], PartitionSpec(("pod", "data", "model")), mesh)
    out = {}
    with torch.no_grad():
        out["x0"] = rec._features(params, serve["dense"], serve["sparse"],
                                  cfg, "cuda", mesh)
    # Each serving call twice: the first (cold) pays cuBLAS's and the
    # allocator's set-up; the second (warm) is the reading.
    for key, fn, args in (
            ("serve", rec.dcn_forward, (serve["dense"], serve["sparse"])),
            ("retrieval", rec.retrieval_scores,
             (query["dense"], query["sparse"], cand))):
        extra = (RETRIEVAL_TOP_K,) if key == "retrieval" else ()
        out[f"{key}_cold_ms"], _ = timed_ms(dev, fn, params, *args, cfg,
                                            *extra, "cuda", mesh)
        out[f"{key}_ms"], out[key] = timed_ms(dev, fn, params, *args,
                                              cfg, *extra, "cuda", mesh)
    out["logits"], out["top"] = out.pop("serve"), out.pop("retrieval")
    step = make_recsys_step(cfg, AdamWConfig(warmup_steps=1), mesh=mesh)
    batch = {k: rows(v) for k, v in batches["train_batch"].items()}
    out["train_ms"], (_, metrics) = timed_ms(dev, step, (params, opt), batch)
    out["grads"] = tree_leaves(metrics.pop("grads"))
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    return out


def grads_held(got: list, want: list, tol: float, by_norm: bool) -> float:
    """The largest of the gradient leaves' errors over their bounds:
    ``tol`` x the leaf's largest magnitude for the error's largest, or
    (``by_norm``) ``tol`` x the leaf's norm for the error's norm."""
    room = 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        if by_norm:
            err = float(torch.linalg.vector_norm(g - w))
            top = float(torch.linalg.vector_norm(w))
        else:
            err, top = max_abs_err(g, w), float(w.abs().max())
        room = max(room, err / (tol * top) if top else
                   (0.0 if err == 0 else math.inf))
    return room


def step_held(got: list, want: list, grads: list, lr: float, p_tol: float,
              g_tol: float | None) -> tuple[float, int, float]:
    """One AdamW step's parameters ``got`` against the twin's ``want``:
    (the largest error over its bound, the leaf it is in, the share of
    the elements with a gradient that are held to the strict bound).  The
    bound is ``p_tol`` x the leaf's largest magnitude; where the twin's
    gradient ``grads`` is not 0 but within ``g_tol`` x the leaf's largest
    gradient of it (``g_tol`` None: everywhere), 2 lr more, since a
    gradient rounded to the other sign moves its element lr the other
    way.  Everywhere else the first step moves an element by lr (AdamW's
    m / sqrt(v) is the gradient's sign) or, with no gradient, by its
    decay alone, so a step not taken, or taken the wrong way, is 1 or 2
    lr off."""
    room, worst, strict, moved = 0.0, -1, 0, 0
    for i, (p, w, g) in enumerate(zip(got, want, grads)):
        g = g.float().abs()
        free = g > 0
        if g_tol is not None:
            free &= g <= g_tol * float(g.max())
        bound = p_tol * float(w.abs().max()) + 2 * lr * free
        r = float(((p.float() - w.float()).abs() / bound).max())
        if r >= room:
            room, worst = r, i
        strict += int(((g > 0) & ~free).sum())
        moved += int((g > 0).sum())
    return room, worst, strict / max(moved, 1)


def rank_dcn(device) -> dict:
    """DCN-v2 at full width on a (data 1, model = world) mesh: this rank's
    slices by ``recsys.param_specs``, the grouped kernel on its table
    shards (launches counted), then the one-process ``impl="cuda"`` twin
    in this process on the whole model, each rank's results held against
    it: x0 ``torch.equal``, logits and scores within ``RANKS_DCN_TOL`` x
    max, positions equal, the step's gradients within
    ``RANKS_DCN_GRAD_TOL`` and its parameters within
    ``RANKS_DCN_STEP_TOL`` of each leaf's largest (:func:`step_held`),
    each against this rank's slices of the twin's.  One rank goes
    through the group (``through_group``)."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed import comm
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.launch.mesh import shard_tree
    from repro_torch.models import recsys as rec
    from repro_torch.optim import (adamw_init, tree_leaves, tree_map,
                                   tree_unflatten)

    t0 = time.perf_counter()
    cfg = get_arch(RECSYS_ARCH)
    mesh = comm.Mesh((1, comm.world_size()), ("data", "model"), device.type)
    whole, batches = dcn_ranks_inputs(cfg, device)
    specs = rec.param_specs(cfg)
    params = tree_map(torch.clone, shard_tree(whole, specs, mesh))
    comm.issued.clear()
    reset_peak(device)
    eb_ops.counter.reset()
    with comm.through_group():
        got = dcn_calls(params, batches, cfg, mesh, adamw_init(params))
    launches = eb_ops.launches
    out = {**rank_header(device), "launches": launches,
           "serve_cold_ms": got["serve_cold_ms"],
           "retrieval_cold_ms": got["retrieval_cold_ms"],
           "issued": dict(comm.issued), "peak": peak_bytes(device),
           **{k: got[k] for k in ("serve_ms", "retrieval_ms", "train_ms",
                                  "metrics")}}
    gc.collect()
    torch.cuda.empty_cache()
    twin = dcn_calls(whole, batches, cfg, None, adamw_init(whole))
    out.update({f"twin_{k}": twin[k] for k in ("serve_ms", "retrieval_ms",
                                                "train_ms")})
    out["x0_equal"] = bool(torch.equal(got.pop("x0"), twin.pop("x0")))
    scale = float(twin["logits"].abs().max())
    out["logits_err"] = (max_abs_err(got["logits"], twin["logits"]), scale)
    (s, i), (ts, ti) = got["top"], twin["top"]
    out["scores_err"] = (max_abs_err(s, ts), float(ts.abs().max()))
    out["positions_equal"] = bool(torch.equal(i, ti))
    out["twin_metrics"] = twin["metrics"]
    mine = lambda tree: tree_leaves(shard_tree(tree, specs, mesh))  # noqa: E731
    want_g = mine(tree_unflatten(whole, twin["grads"]))
    out["grads_room"] = grads_held(got["grads"], want_g, RANKS_DCN_GRAD_TOL,
                                   by_norm=False)
    out["step_room"], out["worst"], out["strict"] = step_held(
        tree_leaves(params), mine(whole), want_g, twin["metrics"]["lr"],
        RANKS_DCN_STEP_TOL, RANKS_DCN_GRAD_TOL)
    out["leg_s"] = time.perf_counter() - t0
    return out


def gnn_step(cfg, state, batch, mesh):
    """One ``gnn_train_step`` (``AdamWConfig(warmup_steps=1)``) with
    ``cfg``'s message-passing dtype on a ``gnn_cell`` state and batch (the
    indices made int64, as the cell's step makes them)."""
    from repro_torch.models import gnn as gnn_lib
    from repro_torch.optim import AdamWConfig

    b64 = dataclasses.replace(
        batch, edge_src=batch.edge_src.long(),
        edge_dst=batch.edge_dst.long(), graph_ids=batch.graph_ids.long())
    return gnn_lib.gnn_train_step(state.params, state.opt, b64, cfg,
                                  AdamWConfig(warmup_steps=1), mesh)


def rank_gnn(device) -> dict:
    """gin-tu and gat-cora at their published widths on
    ``RANKS_GNN_SHAPE``'s padded sample (``gnn_cell``'s build, nodes and
    edges split over every rank), one train step in bf16 and one in f32
    each, then the one-process step on the whole batch in this process;
    each rank's first step held against it (``RANKS_GNN_TOL``): the loss,
    ``grad_norm``, every gradient and every parameter."""
    from repro_torch.configs import GNN_SHAPES, get_arch
    from repro_torch.distributed import comm
    from repro_torch.launch import cells
    from repro_torch.optim import tree_leaves

    t0 = time.perf_counter()
    mesh = comm.Mesh((1, comm.world_size()), ("data", "model"), device.type)
    shape = {s.name: s for s in GNN_SHAPES}[RANKS_GNN_SHAPE]
    out = {**rank_header(device), "legs": {}}
    comm.issued.clear()
    for arch in RANKS_GNN_ARCHS:
        for dtype in RANKS_GNN_TOL:
            cfg = dataclasses.replace(get_arch(arch), mp_dtype=dtype)
            leg = {}
            for where, m in (("ranks", mesh), ("twin", None)):
                _, (state, batch) = cells.gnn_cell(arch, shape, mesh=m).build(
                    device, torch.Generator(device).manual_seed(RANKS_SEED))
                reset_peak(device)
                with comm.through_group():
                    # The first step (cold) is held; the second, warm, is
                    # the reading.
                    _, (params, opt, metrics) = timed_ms(
                        device, gnn_step, cfg, state, batch, m)
                    first = [p.detach().clone() for p in tree_leaves(params)]
                    ms, _ = timed_ms(device, gnn_step, cfg, dataclasses.replace(
                        state, params=params, opt=opt), batch, m)
                if m is not None:
                    leg["peak"] = peak_bytes(device)
                leg[where] = {"ms": ms, "params": first,
                              "grads": metrics.pop("grads"),
                              **{k: float(v) for k, v in metrics.items()}}
                del state, batch, params, opt, metrics
            tol = RANKS_GNN_TOL[dtype]
            got, want = leg["ranks"], leg["twin"]
            f32 = dtype == "float32"
            room = {k: abs(got[k] - want[k]) / (tol[k] * abs(want[k]))
                    for k in ("loss", "grad_norm")}
            room["grads"] = grads_held(got["grads"], want["grads"],
                                       tol["grads"], by_norm=not f32)
            room["params"], worst, strict = step_held(
                got["params"], want["params"], want["grads"], want["lr"],
                tol["params"], tol["grads"] if f32 else None)
            out["legs"][f"{arch}/{dtype}"] = {
                "ms": got["ms"], "twin_ms": want["ms"], "loss": got["loss"],
                "twin_loss": want["loss"], "room": room, "strict": strict,
                "worst": worst,
                "peak": leg["peak"]}
            gc.collect()
            torch.cuda.empty_cache()
    out["issued"] = dict(comm.issued)
    out["leg_s"] = time.perf_counter() - t0
    return out


def rank_single(device, graph, index, bucket, stepwise, serve,
                moe_cfg) -> dict:
    """The one-rank spawn: DKS, then the granite tp leg, DCN-v2 and the
    GNNs at (1, 1)."""
    out = {"dks": rank_dks(device, graph, index, bucket, stepwise, serve)}
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out["tp_moe"] = rank_tp_moe(device, moe_cfg)
    for name, fn in (("dcn", rank_dcn), ("gnn", rank_gnn)):
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        out[name] = fn(device)
    return out


def rank_pair(device, graph, index, bucket, moe_args, pp_args,
              ring_args, tp_args) -> dict:
    """The paths of two ranks, one after the other in one spawn: DKS,
    then the MoE layer, the pipeline, the ring, the tensor-parallel legs
    (ChatGLM3-6B, granite, the smoke train steps), DCN-v2 and the GNNs."""
    out = {"dks": rank_dks(device, graph, index, bucket)}
    lm_cfg, moe_cfg, scfg = tp_args
    for name, fn, args in (("moe", rank_moe, moe_args),
                           ("pp", rank_pp, pp_args),
                           ("ring", rank_ring, ring_args),
                           ("tp", rank_tp_lm, (lm_cfg,)),
                           ("tp_moe", rank_tp_moe, (moe_cfg,)),
                           ("tp_train", rank_tp_train, (scfg,)),
                           ("dcn", rank_dcn, ()), ("gnn", rank_gnn, ())):
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        out[name] = fn(device, *args)
        out[name]["leg_s"] = time.perf_counter() - t0
    return out


def ranks_line(what: str, outs: list, card: str, extra: str = "") -> None:
    """One printed line per path: world, backend, staged ops, ms and peak
    memory a rank, beside the card."""
    head = outs[0]
    ms = [o["ms"] if np.isscalar(o["ms"]) else min(o["ms"]) for o in outs]
    log(f"  {what}: world {head['world']}, backend {head['backend']}, "
        f"staged {head['staged']}, {max(ms):.1f} ms (slowest rank), peak "
        f"{max(o['peak'] for o in outs) / 2**30:.2f} GiB a rank{extra} "
        f"[{card}; one card shared by the ranks: not a multi-card time]")


def fmt_ms(phases: dict) -> str:
    return ", ".join(f"{name} {ms:.2f}" for name, ms in phases.items()) \
        + " ms"


def stepwise_held(world: int, outs: list, twin: dict, card: str) -> None:
    """Phase 18's stepwise legs at ``world`` ranks against phase 12's
    one-process twin (``twin``): every stream update, the deadline
    buckets' results and ``info`` and the instrumented run's result and
    history exactly; the mid-run deadline stopped every rank at the same
    superstep with the same state, its sound bounds below the exact
    answers."""
    for r, out in enumerate(outs):
        for what, want in twin["held"].items():
            check(out["stepwise"]["held"][what] == want,
                  f"stepwise {what}, rank {r} of {world}: differs from the "
                  f"twin")
    mids = [out["stepwise"]["mid_run"] for out in outs]
    head = mids[0]
    full = twin["held"]["deadline/600.0"]
    for r, mid in enumerate(mids):
        check(mid["steps"] == head["steps"] and mid["digest"] ==
              head["digest"], f"mid-run deadline, rank {r} of {world}: "
              f"{mid['steps']} supersteps or its state differ from rank 0's")
    steps = head["steps"][0]
    check(0 < steps < full[0][1]["driver_supersteps"] and
          any(head["interrupted"]),
          f"the deadline at {head['deadline_s']:.4f} s stopped at "
          f"superstep {steps} of {full[0][1]['driver_supersteps']}: not "
          f"mid-run")
    for lb, (rec, _) in zip(head["sound"], full):
        check(lb <= rec["weights"][0], f"mid-run sound bound {lb} above "
              f"the exact {rec['weights'][0]}")
    n_up = len(twin["held"]["stream"])
    hist = len(twin["held"]["instrumented"][1])
    slowest = max(outs, key=lambda o: o["stepwise"]["stream_ms"])
    log(f"  stepwise at {world} rank(s): a stream of {n_up - 1} supersteps,"
        f" the deadline bucket of {STEPWISE_LANES} lanes at 0 s and 600 s "
        f"and an instrumented run of {hist} supersteps with the paper's "
        f"exit hook == the twin exactly; a deadline of "
        f"{head['deadline_s']:.4f} s stopped every rank at superstep "
        f"{steps} with one state digest. ms a superstep (slowest rank, "
        f"host clock): stream {slowest['stepwise']['stream_ms']:.2f} "
        f"(twin {twin['stream_ms']:.2f}), deadline bucket "
        f"{max(o['stepwise']['deadline_ms'] for o in outs):.2f} (twin "
        f"{twin['deadline_ms']:.2f}), instrumented "
        f"{fmt_ms(slowest['stepwise']['phases_ms'])} (twin "
        f"{fmt_ms(twin['phases_ms'])}) [{card}; one card shared by the "
        f"ranks: not a multi-card time]")


def dks_serve_held(dev, world: int, outs: list, twin: list,
                   stepwise4: dict, served9: dict, live: tuple,
                   card: str) -> None:
    """Phase 18's serving leg at ``world`` ranks: every follower's replay
    log equals rank 0's records; rank 0's served bucket equals the twin
    at the same shard count (``twin``) and phase 9's served bucket, its
    single queries and their trees phase 9's, its deadline buckets phase
    12's stepwise twin (results, ``approximate`` == ``interrupted``, the
    bounds); the bucket again is all cache hits.  At 4 ranks the live
    swap failed no request, every rank installed the new build at the
    same record, and the answers after it equal an engine built from
    ``compact_chain`` on the card."""
    head = outs[0]["serve"]
    for r, out in enumerate(outs[1:], 1):
        check(out["serve"]["logs"] == head["logs"],
              f"serving at {world} ranks: rank {r}'s replay log differs "
              f"from rank 0's records")
    kinds = [rec.kind for rec in head["logs"]]
    check(kinds[0] == "open" and kinds[-1] == "stop"
          and kinds.count("call") >= 4, f"records {kinds}")
    check([rec["result"] for rec in head["bucket"]] == twin,
          f"served bucket at {world} ranks differs from the twin")
    for what in ("bucket", "singles"):
        check(head[what] == served9[what],
              f"served {what} at {world} ranks differ from phase 9's")
    check(all(rec.get("trees") for rec in head["singles"]),
          "single queries served without trees")
    for d in (0.0, 600.0):
        want = stepwise4["held"][f"deadline/{d}"]
        for i, (rec, (res, info)) in enumerate(zip(head[f"deadline/{d}"],
                                                   want)):
            check(rec["result"] == res
                  and rec["approximate"] == info["interrupted"]
                  and rec["bounds"] == [info["opt_lower_bound"],
                                        info["sound_opt_lower_bound"]],
                  f"served deadline {d} s lane {i} at {world} ranks "
                  f"differs from the stepwise twin")
    check(head["repeat_hits"] == BUCKET_LANES,
          f"the bucket again: {head['repeat_hits']} cache hits")
    log(f"  DKSService at {world} rank(s), rank 0 leading and "
        f"{world - 1} follower(s) replaying {len(kinds)} records == its "
        f"log: {served_line(head)} (one process, phase 9: "
        f"{served_line(served9)}); bucket and trees == twin and phase 9, "
        f"deadline buckets at 0 s and 600 s == stepwise twin; leg "
        f"{head['serve_s']:.1f} s [{card}; one card shared by the ranks: "
        f"not a multi-card time]")
    if "swap" not in head:
        return
    from repro_torch.engine import QueryEngine
    from repro_torch.live import LiveDir
    from repro_torch.store import compact_chain

    sw = head["swap"]
    for r, out in enumerate(outs[1:], 1):
        check(out["serve"]["swap"]["logs"] == sw["logs"],
              f"live swap: rank {r}'s replay log differs from rank 0's")
    check(not sw["failures"] and sw["swaps"] == 1,
          f"live swap: {sw['swaps']} swaps, failures {sw['failures']}")
    check([rec.kind for rec in sw["logs"]].count("swap") == 1,
          "live swap: not one swap record")
    chain = LiveDir(live[0]).chain()
    check(sw["version"] == f"artifact:{chain.content_hash}",
          f"live swap: serving {sw['version']}")
    art = compact_chain(chain, Path(live[0]).parent / "compact",
                        overwrite=True)
    eng = QueryEngine.build(artifact=art, device=dev, policy=dataclasses
                            .replace(small_policy(), n_shards=world))
    want = [result_record(r) for r in eng.query_batch(live[3], k=2)]
    check(sw["post"] == want,
          "live swap: answers after the swap differ from compact_chain's")
    log(f"  live swap at {world} ranks on the small graph "
        f"({SMALL_SHARDED[0]} nodes): {sw['requests']} requests from "
        f"{SWAP_CLIENTS} clients, 0 failed; build, warm and install on "
        f"every rank at one record in {sw['swap_s']:.3f} s; answers "
        f"after it == compact_chain's engine [{card}]")


def tp_ms(outs: list, key: str) -> str:
    """:func:`tp_serve`'s warm ms of ``key`` and its cold first call's,
    the slowest rank's of each."""
    return (f"{max(o[key + '_ms'] for o in outs):.2f} ms (cold "
            f"{max(o[key + '_cold_ms'] for o in outs):.2f})")


def tp_line(what: str, outs: list, card: str, extra: str) -> None:
    """One printed line per tensor-parallel leg: the group, seconds, ms a
    prefill and a decode step warm and cold, peak GiB and flash launches
    a rank."""
    head = outs[0]
    quant = f", int8 step {tp_ms(outs, 'quant')}" if "quant_ms" in head \
        else ""
    log(f"  {what}: world {head['world']}, backend {head['backend']}; leg "
        f"{max(o['leg_s'] for o in outs):.1f} s; prefill "
        f"{tp_ms(outs, 'prefill')}, decode step {tp_ms(outs, 'decode')}"
        f"{quant} (slowest rank, host clock); peak {max(o['peak'] for o in outs) / 2**30:.2f} GiB "
        f"a rank; flash launches a rank (one prefill) "
        f"{[o['launches'] for o in outs]}; collectives issued a rank (both "
        f"prefills and the decode) {head['issued']}{extra} [{card}; one "
        f"card shared by the ranks: not a multi-card time]")


def tp_held(dev, card: str, cfg, moe_cfg, scfg, lm_outs, moe_outs,
            nccl_out, train_outs) -> dict:
    """Phase 18's tensor-parallel legs against one process on the card
    (the train steps against the CPU): ChatGLM3-6B's prefill and decode
    logits within ``LM_TOL`` x max |logit| of the whole model's at
    ``tp=1``, its int8 decode within atol = rtol = ``QUANT_TOL`` of the
    whole model's int8 decode; granite's at (1, 2) over gloo and (1, 1)
    over NCCL, in f32, within ``TP_MOE_TOL`` x max of the one-process twin
    padded to the same ``tp`` whose MoE runs the same dispatch; the smoke steps within ``SMOKE_TRAIN_TOL`` of each
    leaf's largest magnitude.  Returns the flash launches a rank."""
    from repro_torch.models import transformer as tfm

    def held(what, got, want, tol=LM_TOL):
        err = max_abs_err(got.float(), want.float())
        top = float(want.abs().max())
        check(bool(torch.isfinite(got).all()) and err <= tol * top,
              f"{what}: differs by {err} > {tol} x {top}")
        return err, top

    # ChatGLM3-6B at full width and depth on (data 1, model 2).
    b1 = tfm.build(cfg, 1)
    model, prompts, feed = tp_inputs(cfg, b1, dev, TP_BATCH)
    ref = tp_serve(model, b1, prompts, feed, None, True)
    del model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    errs, qrooms = [], []
    for r, out in enumerate(lm_outs):
        check(out["launches"] == cfg.n_layers, f"tp rank {r}: flash "
              f"launched {out['launches']} times, want {cfg.n_layers}")
        for key in ("prefill", "decode"):
            errs.append(held(f"tp {cfg.name} {key}, rank {r}", out[key],
                             ref[key]))
        qrooms.append(quant_held(list(out["quant"]), list(ref["quant"]),
                                 f"tp {cfg.name} int8 decode, rank {r}"))
    d, s = cfg.d_model, LM_PROMPT
    n = TP_MESH[1]
    slab = TP_BATCH * s * d * 2 / n * (n - 1) / 2 ** 20
    tp_line(f"tensor parallel {cfg.name}, (data, model) {TP_MESH}", lm_outs,
            card, f"; {lm_outs[0]['weights_bytes'] / 2**30:.2f} GiB of "
            f"weights a rank; prefill {TP_BATCH} x {s} with the residual "
            f"split on the sequence: each layer all-gathers its 2 normed "
            f"inputs and reduce-scatters its 2 outputs, {slab:.1f} MiB in "
            f"from the other rank each ({4 * cfg.n_layers * slab:.0f} MiB "
            f"a prefill); {TP_DECODE} decode steps teacher-forced against a "
            f"cache split on the sequence, {TP_QUANT_STEPS} int8 steps; "
            f"logits within {max(e for e, _ in errs):.4g} of the whole "
            f"model's (limit {LM_TOL} x {max(t for _, t in errs):.4g}), "
            f"int8 within {max(q[1] for q in qrooms):.4g} (element-wise "
            f"{max(q[0] for q in qrooms):.4f} of atol = rtol = {QUANT_TOL}); "
            f"one process: prefill {tp_ms([ref], 'prefill')}, decode step "
            f"{tp_ms([ref], 'decode')}, int8 step {tp_ms([ref], 'quant')}")
    del ref

    # granite at full width and cut depth: the one-process twin padded to
    # the same tp, its MoE dispatched as each group's mesh dispatches it,
    # against the 2 gloo ranks and the 1 NCCL rank.
    b2 = tfm.build(moe_cfg, TP_MESH[1])
    twin, prompts, feed = tp_inputs(moe_cfg, b2, dev)
    for what, outs in (("gloo", moe_outs), ("nccl", [nccl_out])):
        ref = tp_serve(mesh_dispatch(twin, len(outs)), b2, prompts,
                       feed[:, :2], None, False)
        errs = []
        for r, out in enumerate(outs):
            check(out["launches"] == moe_cfg.n_layers,
                  f"tp granite ({what}) rank {r}: flash launched "
                  f"{out['launches']} times, want {moe_cfg.n_layers}")
            for key in ("prefill", "decode"):
                errs.append(held(f"tp granite {key} ({what}), rank {r}",
                                 out[key], ref[key], TP_MOE_TOL))
        issued = outs[0]["issued"]
        check(issued.get("reduce_scatter", 0) > 0
              and issued.get("all_gather", 0) > 0
              and issued.get("all_to_all", 0) > 0,
              f"tp granite ({what}): collectives issued {issued}")
        tp_line(f"tensor parallel {moe_cfg.name} at {moe_cfg.n_layers} "
                f"layers ({what})", outs, card,
                f"; f32; padded to tp={b2.tp}: vocab {b2.vocab_p}, "
                f"{b2.e_pad} experts, capacity factor "
                f"{moe_cfg.moe.capacity_factor}; the prefill's "
                f"MoE through _moe_sharded on each rank's sequence block, "
                f"the decode's through _moe_dense_all; logits within "
                f"{max(e for e, _ in errs):.4g} of the one-process twin's "
                f"with the same dispatch (limit {TP_MOE_TOL} x "
                f"{max(t for _, t in errs):.4g}); twin: prefill "
                f"{tp_ms([ref], 'prefill')}, decode step "
                f"{tp_ms([ref], 'decode')}")
    del twin, ref
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # The f32 smoke steps at tp=2, card against CPU.
    _, whole, batch = tp_train_inputs(scfg)
    losses, params = tp_train_steps(whole, batch)
    for r, out in enumerate(train_outs):
        torch.testing.assert_close(
            torch.tensor(out["losses"]), torch.tensor(losses),
            atol=0, rtol=SMOKE_TRAIN_TOL)
        for name, want in params.items():
            err = max_abs_err(out["params"][name], want)
            top = float(want.abs().max())
            check(err <= SMOKE_TRAIN_TOL * top, f"tp smoke step, rank {r}, "
                  f"{name}: {err} > {SMOKE_TRAIN_TOL} x {top}")
    log(f"  tensor parallel smoke train: {TP_TRAIN_STEPS} f32 steps of "
        f"{scfg.name}'s smoke config at tp={TP_MESH[1]} on the card == the "
        f"CPU's within {SMOKE_TRAIN_TOL} of each leaf's largest (losses "
        f"{[round(x, 6) for x in train_outs[0]['losses']]}); leg "
        f"{max(o['leg_s'] for o in train_outs):.1f} s [{card}]")
    return {"tp_chatglm3": [o["launches"] for o in lm_outs],
            "tp_granite": [o["launches"] for o in moe_outs],
            "tp_granite_nccl": [nccl_out["launches"]]}


def gnn_mesh_bytes(world: int) -> dict:
    """MB a rank receives in one train step at ogb_products
    (``gnn_cell``'s padding) with nodes and edges split over ``world``
    ranks, by collective and pass (``gnn.collective_bytes``), for gin-tu,
    gat-cora and pna in bf16 message passing, over ring algorithms: an
    all-gather or a reduce-scatter of a table of B bytes moves (W - 1) / W
    x B into a rank, an all-reduce twice that."""
    from repro_torch.configs import GNN_SHAPES, get_arch
    from repro_torch.launch.cells import gnn_sizes
    from repro_torch.models.common import pad_to
    from repro_torch.models.gnn import collective_bytes

    shape = {s.name: s for s in GNN_SHAPES}["ogb_products"]
    n_nodes, n_edges, _ = gnn_sizes(shape)
    n, e = pad_to(n_nodes, 512), pad_to(n_edges, 512) // world
    frac = (world - 1) / world
    out = {}
    for arch in ("gin-tu", "gat-cora", "pna"):
        cfg = dataclasses.replace(get_arch(arch), mp_dtype="bfloat16")
        out[arch] = {f"{kind} {pas}": t * frac * (
            2 if kind == "all_reduce" else 1) / 2**20 for (pas, kind), t in
            collective_bytes(cfg, n, e, shape.d_feat).items()}
    return out


def dcn_gnn_held(card: str, pair: list, single: list) -> list:
    """Phase 18's DCN-v2 and GNN legs, each rank held (in the rank)
    against the one-process twin: checked and printed here.  Returns the
    grouped kernel's launches of each rank, the 2 gloo ranks' then the
    NCCL rank's."""
    for what, outs in (("gloo", [o["dcn"] for o in pair]),
                       ("nccl", [o["dcn"] for o in single])):
        head = outs[0]
        issued = head["issued"]
        ms = lambda key: max(o[key] for o in outs)  # noqa: E731
        # Printed first, so that a failed check below still leaves the
        # numbers in the log.
        log(f"  DCN-v2 at full width on (data 1, model {head['world']}), "
            f"backend {head['backend']}: serve_bulk "
            f"{ms('serve_ms'):.2f} ms (cold {ms('serve_cold_ms'):.2f}; twin "
            f"{ms('twin_serve_ms'):.2f}), retrieval_cand "
            f"{ms('retrieval_ms'):.2f} ms (cold "
            f"{ms('retrieval_cold_ms'):.2f}; twin "
            f"{ms('twin_retrieval_ms'):.2f}), one train_batch step "
            f"{ms('train_ms'):.2f} ms (twin {ms('twin_train_ms'):.2f}; the "
            f"step is a first call) (slowest rank, host clock); x0 == twin "
            f"{[o['x0_equal'] for o in outs]}, logits within "
            f"{max(o['logits_err'][0] for o in outs):.3g} (limit "
            f"{RANKS_DCN_TOL} x {head['logits_err'][1]:.4g}), scores within "
            f"{max(o['scores_err'][0] for o in outs):.3g}, positions equal "
            f"{[o['positions_equal'] for o in outs]}, the step's gradients "
            f"at {max(o['grads_room'] for o in outs):.3g} of their bound "
            f"and parameters at {max(o['step_room'] for o in outs):.3g} "
            f"(leaf {[o['worst'] for o in outs]}; "
            f"{min(o['strict'] for o in outs):.3f} of those with a gradient "
            f"held without the 2 lr slack), lr "
            f"{head['twin_metrics']['lr']:.3g}, "
            f"loss {head['metrics']['loss']:.6f} (twin "
            f"{head['twin_metrics']['loss']:.6f}); grouped launches a rank "
            f"{[o['launches'] for o in outs]}; collectives issued {issued}; "
            f"peak {max(o['peak'] for o in outs) / 2**30:.2f} GiB a rank; "
            f"leg {max(o['leg_s'] for o in outs):.1f} s [{card}; one card "
            f"shared by the ranks: not a multi-card time]")
        for r, out in enumerate(outs):
            where = f"DCN-v2 ({what}) rank {r}"
            check(out["launches"] == 8, f"{where}: embedding_bag_grouped "
                  f"launched {out['launches']} times, want 8 (x0, serve "
                  f"twice, retrieval's query and candidates twice, the "
                  f"step)")
            check(out["x0_equal"], f"{where}: x0 differs from the twin's")
            for key in ("logits_err", "scores_err"):
                err, top = out[key]
                check(err <= RANKS_DCN_TOL * top,
                      f"{where}: {key} {err} > {RANKS_DCN_TOL} x {top}")
            check(out["positions_equal"],
                  f"{where}: top-{RETRIEVAL_TOP_K} positions differ")
            check(out["grads_room"] <= 1.0, f"{where}: a gradient leaf is "
                  f"{out['grads_room']:.3g} of its bound away")
            check(out["step_room"] <= 1.0, f"{where}: a parameter after the "
                  f"step is {out['step_room']:.3g} of its bound away")
            for k in ("loss", "grad_norm"):
                got, want = out["metrics"][k], out["twin_metrics"][k]
                check(abs(got - want) <= RANKS_DCN_TOL * abs(want),
                      f"{where}: {k} {got} != twin {want}")
        check(issued.get("all_reduce", 0) > 0
              and issued.get("reduce_scatter", 0) > 0
              and issued.get("all_gather", 0) > 0,
              f"DCN-v2 ({what}): collectives issued {issued}")
    for what, outs in (("gloo", [o["gnn"] for o in pair]),
                       ("nccl", [o["gnn"] for o in single])):
        for name in outs[0]["legs"]:
            legs = [o["legs"][name] for o in outs]
            log(f"  GNN {name} on {RANKS_GNN_SHAPE} across "
                f"{outs[0]['world']} rank(s) ({what}): a step "
                f"{max(l['ms'] for l in legs):.2f} ms (twin "
                f"{max(l['twin_ms'] for l in legs):.2f}; the second step, "
                f"slowest rank, host clock); the first step's loss "
                f"{legs[0]['loss']:.6f} (twin {legs[0]['twin_loss']:.6f}); "
                f"the first step's " + ", ".join(
                    f"{k} at {max(l['room'][k] for l in legs):.3g}"
                    for k in legs[0]["room"]) +
                f" of their bounds (the parameters' worst in leaf "
                f"{[l['worst'] for l in legs]}; {min(l['strict'] for l in legs):.3f} "
                f"of those with a gradient held without the 2 lr slack); peak "
                f"{max(l['peak'] for l in legs) / 2**30:.2f} GiB a rank "
                f"[{card}; one card shared by the ranks]")
            for r, leg in enumerate(legs):
                for key, room in leg["room"].items():
                    check(room <= 1.0, f"GNN {name} ({what}) rank {r}: "
                          f"{key} at {room:.3g} of its bound")
        log(f"  GNN ({what}): collectives issued {outs[0]['issued']}; leg "
            f"{max(o['leg_s'] for o in outs):.1f} s")
    for world in (2, 256):
        log(f"  GNN collectives at ogb_products over {world} ranks, MB a "
            f"rank receives in a train step: " + "; ".join(
                f"{arch} " + ", ".join(f"{k} {v:,.1f}" for k, v in
                                       moved.items())
                for arch, moved in gnn_mesh_bytes(world).items()))
    return [o["dcn"]["launches"] for o in pair] + \
        [o["dcn"]["launches"] for o in single]


def ranks_phase(device_type: str, card: str, graph, index, bucket, singles,
                phase5, twin4, stepwise4, served9, dense17) -> dict:
    """Phase 18: DKS's frontier exchange and its stepwise surfaces,
    expert-parallel MoE, GPipe, the int8 ring, the transformer's tensor
    parallelism, DCN-v2 and the GNNs across ranks, each against its twin
    on the card.  ``twin4``: phase 12's 4-shard records and state digest;
    ``stepwise4``: its :func:`stepwise_record`; ``served9``: phase 9's
    :func:`serve_script` on one process; ``dense17``: phase 17's
    :func:`dks_digest` of the dense DKS cell.  Returns the flash launches of
    the pipeline's and the tensor-parallel legs' ranks, the grouped bag
    kernel's of the DCN-v2 legs' ranks and a summary."""
    from repro_torch.configs import get_arch
    from repro_torch.distributed.ranks import run_ranks
    from repro_torch.engine import ExecutionPolicy, QueryEngine
    from repro_torch.models import lm as lm_lib
    from repro_torch.models import moe as moe_lib
    from repro_torch.models.transformer import init_lm
    from repro_torch.optim import AdamWConfig

    t_phase = time.perf_counter()
    dev = torch.device(device_type, 0) if device_type == "cuda" \
        else torch.device("cpu")
    workdir = ROOT / "build" / "chip_smoke_ranks"
    workdir.mkdir(parents=True, exist_ok=True)

    def spawn(fn, world, *args):
        return run_ranks(fn, world, *args, device_type=device_type,
                         timeout_s=RANKS_TIMEOUT_S, workdir=workdir)

    # The spawns: 1 rank over NCCL and 4 over gloo run DKS; 2 over gloo
    # run DKS and then the MoE layer, the pipeline and the ring.
    moe_cfg = get_arch(RANKS_MOE_ARCH)
    cfg = get_arch(LM_ARCH)
    scfg = get_arch(LM_ARCH).smoke().scaled(param_dtype="float32")
    ring_cfg = get_arch(RING_ARCH)
    tp_moe = tp_moe_cfg(get_arch(MOE_ARCH))
    spawned, pair, single, quad, quad_returned = {}, None, None, None, 0.0
    # The serving leg rides the 1-rank and the 4-rank spawns, the live
    # swap the 4-rank one.
    live = small_live(workdir / "live")
    serve = {1: (singles, None), 4: (singles, live)}
    for world in RANKS_DKS_WORLDS:
        t0 = time.perf_counter()
        if world == 2:
            pair = spawn(rank_pair, 2, graph, index, bucket,
                         (moe_cfg, RANKS_MOE_X),
                         (cfg, (LM_BATCH, LM_PROMPT), scfg),
                         (ring_shapes(ring_cfg),), (cfg, tp_moe, scfg))
            spawned[world] = [out["dks"] for out in pair]
        elif world == 1:
            single = spawn(rank_single, 1, graph, index, bucket,
                           world in RANKS_STEPWISE_WORLDS, serve[1], tp_moe)
            spawned[world] = [out["dks"] for out in single]
        elif world == 4:
            quad = spawn(rank_quad, 4, graph, index, bucket,
                         world in RANKS_STEPWISE_WORLDS, serve.get(world),
                         cfg, get_arch(PP3_MOE_ARCH))
            quad_returned = time.time()
            spawned[world] = [out["dks"] for out in quad]
        else:
            spawned[world] = spawn(rank_dks, world, graph, index, bucket,
                                   world in RANKS_STEPWISE_WORLDS,
                                   serve.get(world))
        log(f"  {world} rank(s) spawned, ran and joined in "
            f"{time.perf_counter() - t0:.1f} s")

    # DKS: one shard a rank, against the twin at the same shard count.
    cell = (1 << BUCKET_M) * BUCKET_K * 4
    want5 = [r.weights.tolist() for r in phase5[:BUCKET_LANES]]
    for world, outs in spawned.items():
        if world == 4:
            twin, digest = twin4
        else:
            eng = QueryEngine.build(graph, index=index, device=dev,
                                    policy=ExecutionPolicy(
                                        partition="sharded",
                                        n_shards=world, frontier_frac=1.0))
            res, _ = sharded_bucket(eng, bucket)
            twin, digest = [result_record(r) for r in res], \
                state_digest(res)
            del eng, res
        for r, out in enumerate(outs):
            check(out["results"] == twin,
                  f"DKS rank {r} of {world}: results differ from the twin")
            check(out["launches"] == 0,
                  f"DKS rank {r}: {out['launches']} kernel launches")
            check(out["issued"].get("all_gather", 0) > 0
                  and out["issued"].get("all_reduce", 0) > 0,
                  f"DKS rank {r} of {world}: collectives issued "
                  f"{out['issued']}")
        check(outs[0]["digest"] == digest,
              f"DKS at {world} ranks: state fields differ from the twin")
        check([t["weights"] for t in twin] == want5,
              f"DKS at {world} shards: top-K differs from phase 5")
        steps = max(t["supersteps"] for t in twin)
        gathered = BUCKET_LANES * world * outs[0]["f_cap"] * (cell + 4)
        moved = (f"each exchange gathers {gathered / 2**20:.1f} MiB "
                 f"({BUCKET_LANES} lanes x {world} x f_cap "
                 f"{outs[0]['f_cap']} x {cell + 4} B), "
                 f"{gathered * (world - 1) / world / 2**20:.1f} MiB from "
                 f"other ranks" if world > 1 else
                 "each exchange's all_gather runs over 1 rank (nothing "
                 "from other ranks)")
        ranks_line(f"DKS {world} rank(s)", outs, card,
                   f"; comm's collectives and transposes == their "
                   f"definitions ({outs[0]['checked']} issued); {steps} "
                   f"supersteps, driver "
                   f"{max(o['driver_ms'] for o in outs) / steps:.2f} ms a "
                   f"superstep, collectives issued through the group "
                   f"{outs[0]['issued']}; {moved}; results, state fields "
                   f"== twin, top-K == phase 5")
        if world in RANKS_STEPWISE_WORLDS:
            stepwise_held(world, outs, stepwise4, card)
        if world in serve:
            dks_serve_held(dev, world, outs, twin, stepwise4, served9,
                           live, card)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    # MoE: dbrx-132b's layer, expert-parallel over 2 ranks.
    outs = [out["moe"] for out in pair]
    full, x = moe_layer_inputs(moe_cfg, RANKS_MOE_X, dev)
    with torch.no_grad():
        y, aux, routes = moe_lib.moe_sharded_twin(
            full, x, moe_cfg.moe, moe_cfg.moe.n_experts, 1, 2)
    s = x.shape[1] // 2
    scale = float(y.float().abs().max())
    err = 0.0
    drops = 0
    for j, out in enumerate(outs):
        for a, b, what in zip(out["route"], routes[j],
                              ("ids", "slots", "kept")):
            check(torch.equal(a, b.cpu()), f"MoE rank {j}: {what} differ")
        drops += int((~out["route"][2]).sum())
        check(out["aux"]["dropped_frac"] == float(aux["dropped_frac"]),
              f"MoE rank {j}: dropped_frac differs")
        err = max(err, max_abs_err(out["y"].float(),
                                   y[:, j * s:(j + 1) * s].float().cpu()))
    check(err <= LM_TOL * scale,
          f"MoE y differs from the twin by {err} > {LM_TOL} x {scale}")
    ranks_line(f"MoE {RANKS_MOE_ARCH} layer", outs, card,
               f"; {moe_cfg.moe.n_experts} experts top-"
               f"{moe_cfg.moe.top_k}, d_model {moe_cfg.d_model}, d_ff "
               f"{moe_cfg.moe.d_ff_expert}, x "
               f"{list(x.shape)} bf16; {outs[0]['weights_bytes'] / 2**30:.2f}"
               f" GiB of experts a rank; ids, slots, kept == twin, "
               f"{drops} dropped; max |y - twin| {err:.3g} (max |y| "
               f"{scale:.3g}); ms per call {[round(t, 1) for t in outs[0]['ms']]}")
    del full, x, y, routes
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # GPipe: ChatGLM3-6B over 2 stages, against the plain forward: the
    # final hidden states and the logits at every position (a row at a
    # time).
    outs = [out["pp"] for out in pair]
    model = init_lm(cfg, torch.Generator(dev).manual_seed(LM_SEED))
    toks = pp_tokens(cfg, (LM_BATCH, LM_PROMPT), dev)
    errs_h, errs_pp, scale = [], [], 0.0
    with torch.no_grad():
        hidden, _, _ = model(toks, attn_impl=PP_ATTN)
        for out in outs:
            got = out["hidden"].to(dev)
            check(got.shape == hidden.shape and got.dtype == hidden.dtype,
                  f"GPipe hidden {tuple(got.shape)} {got.dtype}, want "
                  f"{tuple(hidden.shape)} {hidden.dtype}")
            errs_h.append(max_abs_err(got.float(), hidden.float()))
            err = 0.0
            for b in range(hidden.shape[0]):
                want = model.unembed(hidden[b]).float()
                scale = max(scale, float(want.abs().max()))
                err = max(err, max_abs_err(model.unembed(got[b]).float(),
                                           want))
            errs_pp.append(err)
            del got
    del model, hidden
    check(max(errs_pp) <= LM_TOL * scale,
          f"GPipe logits differ by {max(errs_pp)} > {LM_TOL} x {scale}")
    launches = [out["launches"] for out in outs]
    check(all(n > 0 for n in launches),
          f"the pipeline's ranks launched the flash kernel {launches}")
    # The smoke step against the plain step on the CPU.
    small, batch = pp_smoke_inputs(scfg)
    st = lm_lib.init_train_state(small)
    st, m = lm_lib.make_train_step(AdamWConfig(**SMOKE_OPT),
                                   attn_impl="naive")(st, batch)
    plain = dict(st.model.named_parameters())
    lps = scfg.n_layers // PP_STAGES
    for stage, out in enumerate(outs):
        for name, p in out["smoke"]["params"].items():
            if name.startswith("layers."):
                i, rest = name.split(".", 2)[1:]
                name = f"layers.{stage * lps + int(i)}.{rest}"
            torch.testing.assert_close(
                p, plain[name].detach(), atol=SMOKE_TRAIN_TOL,
                rtol=SMOKE_TRAIN_TOL,
                msg=lambda msg: f"GPipe smoke step, {name}: {msg}")
    for name in ("loss", "grad_norm"):
        torch.testing.assert_close(
            torch.tensor(outs[0]["smoke"][name]), m[name].detach(),
            atol=SMOKE_TRAIN_TOL, rtol=SMOKE_TRAIN_TOL)
    ranks_line(f"GPipe {LM_ARCH}", outs, card,
               f"; {PP_STAGES} stages of {cfg.n_layers // PP_STAGES} "
               f"layers ({outs[0]['weights_bytes'] / 2**30:.2f} GiB a "
               f"rank), tokens {list(toks.shape)}, n_micro {PP_MICRO}, "
               f"attn {PP_ATTN} ({launches} flash launches a rank); the "
               f"final hidden states within {max(errs_h):.3g} and the "
               f"logits at all {toks.numel()} positions within "
               f"{max(errs_pp):.3g} of the plain forward (limit "
               f"{LM_TOL} x {scale:.3g}); smoke f32 step == CPU within "
               f"{SMOKE_TRAIN_TOL} (loss {float(m['loss']):.6f}); ms per "
               f"forward {[round(t, 1) for t in outs[0]['ms']]}")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    # GPipe on (pod 2, data 1, model 2): the 4-rank spawn's leg.
    pp3_launches = pp3_held(dev, card, cfg, [out["pp3"] for out in quad],
                            quad_returned)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    pp3_moe_launches = pp3_held(dev, card, get_arch(PP3_MOE_ARCH),
                                [out["pp3_moe"] for out in quad],
                                quad_returned, "float32", PP3_MOE_TOL)
    # The dense DKS cell on (data 2, model 2): the spawn's last leg.
    dense_held(card, [out["dense"] for out in quad], dense17)
    del quad
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # The int8 ring over DCN-v2's gradient tree.
    outs = [out["ring"] for out in pair]
    for r, out in enumerate(outs):
        check(out["equal"], f"ring rank {r}: reduced values or error "
                            f"state differ from the twin")
    ranks_line(f"int8 ring, {RING_ARCH}'s gradient tree", outs, card,
               f"; {outs[0]['numel']:,} f32 in {outs[0]['leaves']} "
               f"leaves; reduced values and error state bit-equal to the "
               f"twin")
    # Tensor parallelism: ChatGLM3-6B, granite, the smoke train steps.
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tp_launches = tp_held(dev, card, cfg, tp_moe, scfg,
                          [out["tp"] for out in pair],
                          [out["tp_moe"] for out in pair],
                          single[0]["tp_moe"],
                          [out["tp_train"] for out in pair])
    log(f"  tensor parallel references in this process: "
        f"{time.perf_counter() - t0:.1f} s")
    bag_launches = dcn_gnn_held(card, pair, single)
    return {"pp_launches": launches, "pp3_launches": pp3_launches,
            "pp3_moe_launches": pp3_moe_launches,
            "tp_launches": tp_launches,
            "bag_launches": {"dcn_v2_gloo": bag_launches[:2],
                             "dcn_v2_nccl": bag_launches[2:]},
            "summary": f"DKS at {list(RANKS_DKS_WORLDS)} ranks == twin, "
                       f"its stepwise surfaces at "
                       f"{list(RANKS_STEPWISE_WORLDS)}, DKSService at "
                       f"{sorted(serve)} with followers; "
                       f"MoE, GPipe (granite's MoE stages too), the dense "
                       f"DKS cell on (data, model), int8 ring, tensor "
                       f"parallelism, DCN-v2 and the GNNs held; "
                       f"phase {time.perf_counter() - t_phase:.1f} s"}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Drive the PyTorch/CUDA port "
                                 "end to end on one GPU (see the module's "
                                 "docstring).")
    ap.add_argument("--parent", type=Path, default=None,
                    help="a checkout of the commit before the wide "
                         "kernels' redesign: phase 19 times its wide "
                         "subset_combine and lane_superstep beside them")
    parent = ap.parse_args(argv).parent
    # ---------------- 1. device ----------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    meta: list = []             # the meta dry run, once phase 11 is done
    workers: list = []          # phases 14 and 15's inputs, from phase 11 on
    try:
        return phases(meta, workers, parent)
    finally:
        for proc, _ in workers:
            proc.kill()
            proc.join()
        for proc, _ in meta:
            if proc.poll() is None:
                proc.kill()
            proc.wait()


def phases(meta: list, workers: list, parent: Path | None) -> int:
    from repro_torch import INF
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

    card_state("phase 1 start", meta)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    log(f"[1/19] device: {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {card}")

    card_state("phase 1 end, phase 2 start", meta)

    # ---------------- 2. build ----------------
    t0 = time.perf_counter()
    build = cuda_build.build_all()
    log(f"[2/19] built {sorted(build)} in {time.perf_counter() - t0:.1f} s")
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
    old = parent_kernels(parent) if parent is not None else None

    card_state("phase 2 end, phase 3 start", meta)

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
    log("[3/19] kernels == plain versions at small shapes (DKS kernels to "
        "m=6, K=8; the backtrace walk on 8 random buckets)")

    errs_wide = wide_small_shapes(dev, g_small, dg_small, rng)
    log(f"[3/19] the wide route == plain versions at (m, K) in "
        f"{list(WIDE_SHAPES)} (padded_topk at K > 8; lane_superstep also "
        f"on a hub graph with done lanes; the walk on random buckets, "
        f"stragglers included)")

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
    log("[3/19] kernels == plain versions at the main path's shapes")

    card_state("phase 3 end, phase 4 start", meta)

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
    log("[4/19] top-1 weights == Dreyfus-Wagner on 6 random graphs")

    card_state("phase 4 end, phase 5 start", meta)

    # ---------------- 5. main path ----------------
    del dg, masks
    engines = {b: QueryEngine.build(graph, index=index,
                                    policy=ExecutionPolicy(backend=b))
               for b in ("cuda", "torch")}
    runs = {}
    for b, eng in engines.items():
        if b == "cuda":
            for ops in (sc_ops, ls_ops, bt_ops):
                for c in (ops.counter, *ops.route_counters.values()):
                    c.reset()
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
            wide_launched = {name: ops.launches_by_route["wide"]
                             for name, ops in (("subset_combine", sc_ops),
                                               ("lane_superstep", ls_ops),
                                               ("batched_backtrace", bt_ops))}
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
    check(not any(wide_launched.values()), f"inside m <= 6, K <= 8 the "
          f"wide route launched {wide_launched}")
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
    log(f"[5/19] {cfg_sec.name} on backend=cuda == backend=torch: weights, "
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
    got = walk_timed(bt_args, None if old is None else
                     old["batched_backtrace"],
                     "the sec-rdfabout bucket's tables", 20)
    recs = got["records"]
    errs["batched_backtrace"] = max(errs["batched_backtrace"], got["err"])
    walked = int((recs["kind"] > 0).sum())
    timing["batched_backtrace"] = (
        got["ms"], cuda_ms(lambda: batched_backtrace_ref(*bt_args), 3),
        None, *got["bound"])
    walk5 = {k_: got[k_] for k_ in ("parent_ms", "turns_ms", "rounds",
                                    "warps") if k_ in got}
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
        f"{walk_line(got)} (plain {ms[1]} ms), records == plain walk")
    del S_b, kw_b, flat_b, bt_args, recs, got

    card_state("phase 5 end, phase 6 start", meta)

    # ---------------- 6. LM serving ----------------
    # The engines stay for phase 9 (serving); their states go.
    del runs, batch, single, g_small, dg_small
    gc.collect()
    torch.cuda.empty_cache()
    errs["flash_attention"], timing["flash_attention"] = flash_phase(dev)
    log("[6/19] flash_attention == plain version at small shapes and the "
        "main path's shape")
    launches["flash_attention"] = lm_phase(dev)
    log(f"[6/19] {LM_ARCH} served through the flash kernel: "
        f"{launches['flash_attention']} launches, logits and tokens agree "
        f"with naive attention")

    card_state("phase 6 end, phase 7 start", meta)

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
    log(f"[7/19] {RECSYS_ARCH} served through the grouped embedding_bag "
        f"kernel: {launches['embedding_bag']} launches (1 + 1 + 2), logits "
        f"and retrieval bit-equal to the plain path")

    card_state("phase 7 end, phase 8 start", meta)

    # ---------------- 8. padded-CSR relax ----------------
    gc.collect()
    torch.cuda.empty_cache()
    err, timing["padded_topk"], launches["padded_topk"] = \
        padded_phase(dev, graph, index, bucket)
    errs["padded_topk"] = max(errs["padded_topk"], err)
    log(f"[8/19] {cfg_sec.name} padded-CSR relax through padded_topk "
        f"({launches['padded_topk']} launch) == plain == relax, exactly")

    card_state("phase 8 end, phase 9 start", meta)

    # ---------------- 9. serving ----------------
    gc.collect()
    torch.cuda.empty_cache()
    serving = serving_phase(graph, index, engines, bucket, singles)
    log(f"[9/19] {cfg_sec.name} served on backend=cuda through DKSService: "
        f"{serving['summary']}; deadline bucket, stream and telemetry == "
        f"backend=torch")
    log(f"  card: {card}")

    card_state("phase 9 end, phase 10 start", meta)

    # ---------------- 10. store and live graphs ----------------
    gc.collect()
    torch.cuda.empty_cache()
    store = store_phase(dev, graph, tokens, index, bucket, singles, phase5)
    log(f"[10/19] {cfg_sec.name} through the graph store on backend=cuda: "
        f"{store['summary']}")

    card_state("phase 10 end, phase 11 start", meta)

    # ---------------- 11. MoE and the int8 KV cache ----------------
    gc.collect()
    torch.cuda.empty_cache()
    moe = moe_phase(dev)
    errs["flash_attention"] = max(errs["flash_attention"], moe["err"])
    log(f"[11/19] {MOE_ARCH} served through the flash kernel: "
        f"{moe['launches']} launches, logits and tokens agree with naive "
        f"attention; int8 cache decode within {QUANT_TOL} of the bf16 cache; "
        f"at cut depth {moe['cut_launches']} launches")
    log(f"  card: {card}")
    meta.append(start_meta_dry_run())
    # Phases 14 and 15's host inputs are made meanwhile in two worker
    # processes, beside the meta dry run, while phases 19, 12 and 13 use
    # the card; phase 15 runs before 14, which needs the longer build.
    workers.extend((start_worker(bluk_inputs),
                    start_worker(minibatch_worker)))

    card_state("phase 11 end, phase 19 start", meta)

    # ---------------- 19. DKS past the templated range ----------------
    # Run here, on phase 5's engines, while phase 14's inputs are made in
    # the worker.
    gc.collect()
    torch.cuda.empty_cache()
    wide = wide_phase(dev, graph, index, bucket, singles, engines, old)
    for name, err in wide["errs"].items():
        errs_wide[name] = max(errs_wide[name], err)
    log(f"[19/19] {cfg_sec.name} at K = {WIDE_BUCKET_K} and m = "
        f"{WIDE_M7[0]} on backend=cuda == backend=torch; the four wide "
        f"kernels == plain versions at m={SINGLE_M} k={WIDE_SINGLE_K[1]}")
    log(f"  card: {card}")

    del engines

    card_state("phase 19 end, phase 12 start", meta)

    # ---------------- 12. sharded partition ----------------
    gc.collect()
    torch.cuda.empty_cache()
    sharded = sharded_phase(dev, graph, index, bucket, singles, phase5,
                            per_step)
    log(f"[12/19] {cfg_sec.name} on the sharded partition ({SHARDS} shards,"
        f" backend=torch) == phase 5; {sharded['summary']}")

    card_state("phase 12 end, phase 13 start", meta)

    # ---------------- 13. training ----------------
    gc.collect()
    torch.cuda.empty_cache()
    trained = train_phase(dev, card)
    log(f"[13/19] {TRAIN_ARCH} trained at full width and depth "
        f"({trained['split']['step_s']:.1f} ms a step); flash_jax == "
        f"chunked; a checkpoint restored bit-equal; {RECSYS_ARCH} trained on "
        f"the grouped lookup ({trained['launches']} launches); the smoke "
        f"steps card == CPU")

    card_state("phase 13 end, phase 15 start", meta)

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
    minibatch = received(workers[-1][1], "minibatch_lg's host graph")
    workers.pop()[0].join()
    gnn_phase(dev, card, minibatch)
    del minibatch
    gnn_launches = {name: ops.launches for name, ops in kernel_ops.items()}
    log(f"[15/19] GNN: {', '.join(GNN_ARCHS)} card == CPU (f32) and trained "
        f"in bf16; gin-tu trained and pna's chunked aggregate run on "
        f"ogb_products at full size; gat-cora trained on a minibatch_lg "
        f"sample of a reddit-size host graph; hand-written kernel launches "
        f"{gnn_launches} (no pallas_call on this path)")
    log(f"  card: {card}")

    card_state("phase 15 end, phase 14 start", meta)

    # ---------------- 14. bluk-bnb ----------------
    gc.collect()
    torch.cuda.empty_cache()
    bluk = bluk_phase(dev, workers[0], old)
    workers.pop(0)[0].join()
    for name, err in bluk["errs"].items():
        errs[name] = max(errs[name], err)
    log(f"[14/19] bluk-bnb at full size on backend=cuda: launches "
        f"{bluk['launches']}; the three DKS kernels == plain versions at its "
        f"shapes; the torch twin's lanes == cuda's")
    log(f"  card: {card}")

    card_state("phase 14 end, phase 17 start", meta)

    # ---------------- 17. accounting ----------------
    gc.collect()
    torch.cuda.empty_cache()
    accounting = accounting_phase(dev, card, meta[0], kernel_ops)
    log(f"[17/19] accounting: {accounting['cells']} cells counted on meta, "
        f"{accounting['measured']} that fit one card run on it; peaks "
        f"within {PEAK_TOL:.0%} or {PEAK_SLACK / 2 ** 30} GiB of meta's, "
        f"FLOPs == meta's, mfu and hbm_share <= {SHARE_LIMIT}")

    card_state("phase 17 end, phase 18 start", meta)

    # ---------------- 18. several ranks ----------------
    gc.collect()
    torch.cuda.empty_cache()
    ranks = ranks_phase("cuda", card, graph, index, bucket, singles, phase5,
                        sharded["twin4"], sharded["stepwise4"],
                        serving["served"], accounting["dense_digest"])
    log(f"[18/19] several ranks: {ranks['summary']}")
    log(f"  card: {card}")

    card_state("phase 18 end, phase 16 start", meta)

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
            "gnn_launches": gnn_launches[name],
            "accounting_launches": accounting["launches"][name],
            **shapes.get(name, {})})
        if name in serving["launches"]:
            kernels[-1]["serving_launches"] = serving["launches"][name]
        if name in store["live_launches"]:
            kernels[-1]["store_launches"] = store["store_launches"][name]
            kernels[-1]["live_launches"] = store["live_launches"][name]
        if name in sharded["launches"]:
            kernels[-1]["sharded_launches"] = sharded["launches"][name]
        if name == "embedding_bag":
            kernels[-1]["train_launches"] = trained["launches"]
            kernels[-1]["ranks_launches"] = ranks["bag_launches"]
        if name in bluk["launches"]:
            ms, plain, library, bound, by = bluk["timing"][name]
            kernels[-1].update({
                "bluk_launches": bluk["launches"][name],
                "bluk_shape": {"ms": ms, "plain_ms": plain,
                               "library_ms": library, "bound_ms": bound,
                               "bound_by": by,
                               **(bluk["walk"] if name == "batched_backtrace"
                                  else {})}})
        if name == "batched_backtrace":
            kernels[-1].update(walk5)
        if name == "flash_attention":
            ms, plain, library, bound, by = moe["timing"]
            kernels[-1].update({
                "ranks_launches": {"gpipe": ranks["pp_launches"],
                                   "gpipe_pod_data_model":
                                       ranks["pp3_launches"],
                                   "gpipe_pod_data_model_moe":
                                       ranks["pp3_moe_launches"],
                                   **ranks["tp_launches"]},
                "moe_launches": moe["launches"],
                "cut_depth_launches": moe["cut_launches"],
                "moe_shape": {"q": moe["shapes"][0], "kv": moe["shapes"][1],
                              "ms": ms, "plain_ms": plain,
                              "library_ms": library, "bound_ms": bound,
                              "bound_by": by}})
    # The wide route of each DKS kernel: its launches on phase 19's main
    # path (padded_topk: its padded relax), its largest error over phases 3
    # and 19, its times at m = 4, K = 10 on sec-rdfabout (phase 19).
    # The two redesigned ones also at (b) and (c) (``shapes``: (a) first).
    for name, (source, replaces) in sources.items():
        if name not in wide["timing"]:
            continue
        ms, plain, library, bound, by = wide["timing"][name]
        row = {
            "name": f"{name} (wide route)", "route": "cuda",
            "source": source, "replaces": replaces,
            "launches": wide["launches"][name]["wide"],
            "max_abs_err": errs_wide[name], "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": library,
            "shape": f"sec-rdfabout, m={SINGLE_M}, k={WIDE_SINGLE_K[1]}",
            "launches_by_route": wide["launches"][name]}
        if name in wide["shapes"]:
            row["shapes"] = [{**t, "library_ms": None}
                             for t in wide["shapes"][name]]
        row.update(wide.get(name, {}))
        kernels.append(row)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
