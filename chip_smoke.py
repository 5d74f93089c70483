#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) end to end on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):

1. Device — fail unless ``torch.cuda.is_available()``; print the card's
   ``nvidia-smi --query-gpu=name,power.limit`` line.
2. Build — compile every CUDA source under ``src/repro_torch/csrc`` with
   nvcc (all at once), timed.
3. Kernels against their plain torch versions on the card, exact equality
   (tolerance 0: every lattice value is a min, a compare or one f32 add):
   random small shapes, then the main path's shapes (the paper-scale
   sec-rdfabout graph, an 8-lane m=3 K=3 bucket, a real mid-run state with
   one lane done), each kernel and plain version timed with CUDA events.
4. Oracle — random small graphs through ``QueryEngine(backend="cuda")``;
   every top-1 weight equals the Dreyfus-Wagner optimum.
5. Main path — sec-rdfabout (460,451 nodes, 500,384 edges, vocabulary
   50,000, seed 7, tau 1001) on ``QueryEngine(backend="cuda")``: one
   ``query_batch`` bucket of 8 lanes (m=3, k=3) and two ``query`` calls
   (m=4, k=2), with the kernels' launch counters set to 0 just before and
   read just after; every result must equal the ``backend="torch"`` run.
6. The kernels line: one JSON object with each kernel's launches, error,
   times and bound.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
BUCKET_M, BUCKET_K, BUCKET_LANES = 3, 3, 8
SINGLE_M, SINGLE_K, N_SINGLE = 4, 2, 2
QUERY_SEED = 2024


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


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


def component_of(graph, start: int) -> np.ndarray:
    """bool[V]: the nodes joined to ``start`` by finite-weight edges (host
    BFS over the CSR)."""
    from repro_torch import INF

    seen = np.zeros(graph.n_nodes, bool)
    seen[start] = True
    front = np.array([start])
    deg = np.diff(graph.indptr)
    while front.size:
        starts = graph.indptr[front]
        idx = np.repeat(starts, deg[front]) + (
            np.arange(deg[front].sum()) - np.repeat(np.cumsum(deg[front])
                                                    - deg[front], deg[front]))
        nbr = graph.indices[idx][graph.ew[idx] < INF]
        nbr = np.unique(nbr[~seen[nbr]])
        seen[nbr] = True
        front = nbr
    return seen


def draw_queries(graph, index, n: int, m: int, rng) -> list[list[int]]:
    """``n`` queries of ``m`` distinct tokens, each token of moderate
    document frequency (2..200) and carried by a node of the component of
    the node with the most finite-weight edges, so that answers exist."""
    from repro_torch import INF

    finite_deg = np.bincount(
        np.repeat(np.arange(graph.n_nodes), np.diff(graph.indptr))[
            graph.ew < INF], minlength=graph.n_nodes)
    comp = component_of(graph, int(np.argmax(finite_deg)))
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


def lane_breakdown(dg, S0, changed, done, m, full_out, fused, heavy=32):
    """Where ``lane_superstep``'s time goes on the main path's state: the
    kernel timed on cut edge lists and flags, beside the in-degree figures
    that each cut speaks to.  Cuts: INF-weight (hub) edges dropped, which
    leaves the output as it was (checked); then also the in-edges of nodes
    with more than ``heavy`` finite in-edges dropped; then no sender
    active (only the tables' stream, the merge and the combine sweep)."""
    n_e = dg.n_edges
    finite = dg.w[:n_e] < 5e8
    dst = dg.dst[:n_e].long()
    fin_deg = torch.bincount(dst[finite], minlength=dg.v_pad)
    light = finite & (fin_deg[dst] <= heavy)
    cut_fin = edge_subset(dg, finite)
    check(torch.equal(fused(S0, changed, done, *cut_fin, m), full_out),
          "lane_superstep without INF-weight edges changed its output")
    cut_light = edge_subset(dg, light)
    idle = torch.zeros_like(changed)
    ms = {"all edges": cuda_ms(lambda: fused(S0, changed, done,
                                             dg.in_offsets, dg.src, dg.w, m),
                               10),
          "finite-weight edges only": cuda_ms(
              lambda: fused(S0, changed, done, *cut_fin, m), 10),
          f"finite edges into nodes of finite in-degree <= {heavy} only":
              cuda_ms(lambda: fused(S0, changed, done, *cut_light, m), 10),
          "finite edges, no sender active": cuda_ms(
              lambda: fused(S0, idle, done, *cut_fin, m), 10)}
    # Per (live lane, node): the rows its thread gathers, one after another.
    live = (~done).nonzero().flatten()
    senders = changed[live][:, dg.src[:n_e].long()] & finite
    chain = torch.stack([torch.bincount(dst[s], minlength=dg.v_pad)
                         for s in senders])
    n_heavy = int((fin_deg > heavy).sum())
    deg = dg.in_offsets.diff()
    return ms, {
        "max in-degree": int(deg.max()),
        "nodes with an INF-weight in-edge": int(torch.bincount(
            dst[~finite], minlength=dg.v_pad).gt(0).sum()),
        "INF-weight edges": int((~finite).sum()),
        "max finite in-degree": int(fin_deg.max()),
        f"nodes of finite in-degree > {heavy}": n_heavy,
        "their share of finite edges": float(
            fin_deg[fin_deg > heavy].sum() / fin_deg.sum()),
        "gathered rows (live lane, finite edge, active sender)":
            int(chain.sum()),
        "longest gather chain of one thread": int(chain.max()),
        f"share of gathered rows into nodes of finite in-degree > {heavy}":
            float(chain[:, fin_deg > heavy].sum() / chain.sum()),
    }


def combine_bound(S, m) -> tuple[float, str]:
    from repro_torch.core.spa import split_pairs

    k = S.shape[-1]
    rows = S.numel() // ((1 << m) * k)
    return _bound(2 * S.numel() * 4, rows * len(split_pairs(m)) * k * k * 2)


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
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
    from repro_torch.kernels import cuda_build
    from repro_torch.kernels.lane_superstep import ops as ls_ops
    from repro_torch.kernels.lane_superstep.ref import fused_lane_step_ref
    from repro_torch.kernels.subset_combine import ops as sc_ops
    from repro_torch.kernels.subset_combine.ref import subset_combine_ref

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    log(f"[1/6] device: {torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {card}")

    # ---------------- 2. build ----------------
    t0 = time.perf_counter()
    build = cuda_build.build_all()
    log(f"[2/6] built {sorted(build)} in {time.perf_counter() - t0:.1f} s")
    for name, info in sorted(build.items()):
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    # ---------------- 3. kernels vs plain ----------------
    errs = {"subset_combine": 0.0, "lane_superstep": 0.0}

    def held(name, got, want, what):
        err = max_abs_err(got, want)
        errs[name] = max(errs[name], err)
        check(torch.equal(got, want), f"{name} != plain at {what} "
                                      f"(max abs err {err})")

    for m, k in ((1, 3), (2, 1), (3, 2), (3, 3), (4, 2), (4, 4), (5, 2),
                 (5, 4)):
        S = sorted_unique_tables((3, 1001), m, k, seed=10 * m + k, device=dev)
        held("subset_combine", sc_ops.subset_combine(S, m),
             subset_combine_ref(S, m), f"m={m} k={k}")
    g_small, _ = lod_like_graph(200, 2000, seed=5, vocab=40)
    dg_small = g_small.to_device(dev)
    rng = np.random.default_rng(0)
    for m, k in ((1, 2), (2, 2), (3, 3), (4, 2), (5, 4)):
        cfg = dks.DKSConfig(m=m, k=k)
        masks = torch.from_numpy(rng.random((3, m, dg_small.v_pad)) < 0.03)
        st = dks.superstep(dg_small, driver.lane_init(
            dg_small, masks.to(dev), cfg), cfg)
        done = torch.tensor([True, False, False], device=dev)
        args = (st.S, st.changed, done, dg_small.in_offsets, dg_small.src,
                dg_small.w)
        held("lane_superstep", ls_ops.fused_lane_step(*args, m),
             fused_lane_step_ref(*args, m), f"small graph m={m} k={k}")
    log("[3/6] kernels == plain versions at small shapes")

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
    ls_out = ls_ops.fused_lane_step(*ls_args, BUCKET_M)
    held("lane_superstep", ls_out, fused_lane_step_ref(*ls_args, BUCKET_M),
         "main path shape")
    timing = {
        "subset_combine": (
            cuda_ms(lambda: sc_ops.subset_combine(S_pre, BUCKET_M), 20),
            cuda_ms(lambda: subset_combine_ref(S_pre, BUCKET_M), 3),
            *combine_bound(S_pre, BUCKET_M)),
        "lane_superstep": (
            cuda_ms(lambda: ls_ops.fused_lane_step(*ls_args, BUCKET_M), 20),
            cuda_ms(lambda: fused_lane_step_ref(*ls_args, BUCKET_M), 3),
            *lane_bound(*ls_args)),
    }
    for name, (ms, plain, bound, by) in timing.items():
        log(f"  {name}: {ms} ms (plain {plain} ms, bound {bound} ms by {by})")
    parts, figures = lane_breakdown(dg, st.S, st.changed, done, BUCKET_M,
                                    ls_out, ls_ops.fused_lane_step)
    log("  lane_superstep on cut inputs (timing only): " + "; ".join(
        f"{what} {ms} ms" for what, ms in parts.items()))
    log("  lane_superstep inputs: " + "; ".join(
        f"{what} {x}" for what, x in figures.items()))
    del st, ls_args, ls_out, S_pre
    log("[3/6] kernels == plain versions at the main path's shapes")

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
    log("[4/6] top-1 weights == Dreyfus-Wagner on 6 random graphs")

    # ---------------- 5. main path ----------------
    del dg, masks
    engines = {b: QueryEngine.build(graph, index=index,
                                    policy=ExecutionPolicy(backend=b))
               for b in ("cuda", "torch")}
    runs = {}
    for b, eng in engines.items():
        if b == "cuda":
            sc_ops.launches = 0
            ls_ops.launches = 0
        t0 = time.perf_counter()
        batch = eng.query_batch(bucket, k=BUCKET_K)
        t_batch = time.perf_counter() - t0
        single = []
        for q in singles:
            t0 = time.perf_counter()
            single.append((eng.query(q, k=SINGLE_K),
                           time.perf_counter() - t0))
        if b == "cuda":
            launches = {"subset_combine": sc_ops.launches,
                        "lane_superstep": ls_ops.launches}
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
    for i, (rc, rt) in enumerate(zip(batch, runs["torch"][0])):
        same_results(rc, rt, f"bucket lane {i}")
    for i, ((rc, _), (rt, _)) in enumerate(zip(single, runs["torch"][2])):
        same_results(rc, rt, f"single query {i}")
    for r in batch + [r for r, _ in single]:
        check(r.found and len(r.answers) > 0, f"no answer for {r.query}")
    log(f"[5/6] {cfg_sec.name} on backend=cuda == backend=torch: weights, "
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
    log(f"  launches on the main path: {launches}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # ---------------- 6. kernels line ----------------
    sources = {"subset_combine": ("src/repro_torch/csrc/subset_combine.cu",
                                  "src/repro/kernels/subset_combine/kernel.py:63"),
               "lane_superstep": ("src/repro_torch/csrc/lane_superstep.cu",
                                  "src/repro/kernels/lane_superstep/kernel.py:131")}
    kernels = []
    for name, (source, replaces) in sources.items():
        ms, plain, bound, by = timing[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
            "bound_ms": bound, "bound_by": by, "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
