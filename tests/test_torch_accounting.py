"""The port's accounting (``repro_torch.analysis``, ``launch/cells.py``,
``launch/dryrun.py``) against ``repro``'s (``repro.analysis``,
``repro.launch.cells``), on the CPU:

- the catalog: the same cells, the same ``model_flops`` exactly, and the
  same arguments (per argument: the multiset of (shape, dtype) of its
  leaves and their total bytes) at full width on ``meta`` against
  ``jax.eval_shape`` leaves, nothing allocated on either side;
- the counter's dot FLOPs against ``analyze_hlo`` of the jitted cell at
  ``smoke()`` widths;
- each kernel wrapper's report under a counter (its formula, and none of
  its plain version's ops);
- the full-width meta dry run of one cell per family against a hand count
  of its parameter and state bytes.

The port keeps a KV cache's ``pos`` as a host int where ``repro`` keeps a
0-d int32 array: the comparison counts it as that array.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.launch.cells as jc
from repro.analysis import analyze_hlo
from repro.configs import get_arch as repro_get_arch
from repro.configs.base import GNNShape as JGNNShape
from repro.configs.base import LMShape as JLMShape
from repro.configs.base import RECSYS_SHAPES as J_RECSYS_SHAPES

import repro_torch.launch.cells as tc
from repro_torch.analysis import count_call
from repro_torch.analysis import roofline as rl
from repro_torch.checkpoint.checkpointer import Stacked
from repro_torch.configs import RECSYS_SHAPES, GNNShape, LMShape, get_arch
from repro_torch.launch import dryrun
from repro_torch.models import lm as lm_lib
from repro_torch.models import transformer as tfm
from repro_torch.optim import AdamWConfig

META = torch.device("meta")
LMS = ("qwen1.5-4b", "chatglm3-6b", "command-r-plus-104b", "dbrx-132b",
       "granite-moe-3b-a800m")
CELLS = [f"{a}__{s}" for a, s in tc.all_assigned_cells()] + [
    c.name for c in tc.dks_cells()]
# Dot FLOPs, port over repro (analyze_hlo), at smoke widths.  The LM
# train step's gap: the port's chunked cross entropy recomputes each
# chunk's logits in the backward (torch.utils.checkpoint), one more head
# product per token than XLA's program (3.6 % at ChatGLM3's smoke width).
FLOP_TOL = {"prefill": 0.01, "serve_p99": 0.01, "gin_train": 0.01,
            "decode": 0.01, "lm_train": 0.05}


def _dtype(d) -> str:
    return str(d).replace("torch.", "")


def port_specs(x) -> list:
    """(shape, dtype) of every leaf of a port argument, laid out as
    ``repro``'s pytree: an LM's layers stacked, a train state as
    ``train_state_tree``, a cache's host ``pos`` as a 0-d int32."""
    if isinstance(x, torch.Tensor):
        return [(tuple(x.shape), _dtype(x.dtype))]
    if isinstance(x, Stacked):
        p = x.parts[0]
        return [((len(x.parts), *p.shape), _dtype(p.dtype))]
    if isinstance(x, tfm.LM):
        return port_specs(lm_lib._repro_tree(dict(x.named_parameters()),
                                             x.cfg.n_layers))
    if isinstance(x, lm_lib.TrainState):
        return port_specs(lm_lib.train_state_tree(x))
    if isinstance(x, dict):
        return [s for k, v in x.items()
                for s in ([((), "int32")] if k == "pos"
                          and isinstance(v, int) else port_specs(v))]
    if isinstance(x, (list, tuple)):
        return [s for v in x for s in port_specs(v)]
    if dataclasses.is_dataclass(x):
        return [s for f in dataclasses.fields(x)
                for s in port_specs(getattr(x, f.name))]
    return []


def repro_specs(x) -> list:
    return [(tuple(leaf.shape), str(leaf.dtype))
            for leaf in jax.tree_util.tree_leaves(x)]


def spec_bytes(specs) -> int:
    return sum(int(np.prod(s, dtype=np.int64)) * np.dtype(
        "float16" if d == "bfloat16" else d).itemsize for s, d in specs)


def repro_cell(name: str):
    arch, shape = name.split("__")
    if arch.startswith("dks-"):
        return next(c for c in jc.dks_cells(n_shards=tc.DKS_SHARDS)
                    if c.name == name)
    return jc.build_cell(arch, shape, tp=1)


@pytest.mark.parametrize("arch", LMS)
def test_active_param_count_is_repros(arch):
    assert (get_arch(arch).active_param_count()
            == repro_get_arch(arch).config.active_param_count())


def test_catalog_is_repros():
    assert [c.name for c in tc.all_cells()] == (
        [f"{a}__{s}" for a, s in jc.all_assigned_cells()]
        + [c.name for c in jc.dks_cells(n_shards=tc.DKS_SHARDS)])


@pytest.mark.parametrize("name", CELLS)
def test_cell_matches_repros(name):
    """model_flops exactly, the kind, and every argument's leaves
    on meta against repro's eval_shape leaves."""
    want, got = repro_cell(name), tc.get_cell(name)
    assert got.model_flops == want.model_flops
    assert got.kind == want.kind
    _, args = got.build(META)
    assert len(args) == len(want.args)
    for i, (a, b) in enumerate(zip(args, want.args)):
        p, r = sorted(port_specs(a)), sorted(repro_specs(b))
        assert p == r, f"argument {i}"
        assert spec_bytes(p) == spec_bytes(r)
    assert all(t.device.type == "meta"
               for t in jax.tree_util.tree_leaves(
                   args, is_leaf=lambda x: isinstance(x, torch.Tensor))
               if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
def test_decode_quant_cell_matches_repros(shape):
    want = jc.lm_decode_quant_cell("chatglm3-6b", shape, tp=1)
    got = tc.lm_decode_quant_cell("chatglm3-6b", shape)
    assert (got.name, got.model_flops) == (want.name, want.model_flops)
    _, args = got.build(META)
    for a, b in zip(args, want.args):
        assert sorted(port_specs(a)) == sorted(repro_specs(b))


def _smoke_cells(monkeypatch, make):
    """``make(cells_module, LMShape, GNNShape, RECSYS_SHAPES)`` on each
    package with every arch at its ``smoke()`` widths."""
    monkeypatch.setattr(jc, "get_arch", lambda a: dataclasses.replace(
        repro_get_arch(a), config=repro_get_arch(a).config.smoke()))
    monkeypatch.setattr(tc, "get_arch", lambda a: get_arch(a).smoke())
    return (make(jc, JLMShape, JGNNShape, J_RECSYS_SHAPES, {"tp": 1}),
            make(tc, LMShape, GNNShape, RECSYS_SHAPES, {}))


SMOKE = {
    "prefill": lambda m, L, G, R, kw: m.lm_cell(
        "chatglm3-6b", L("p", "prefill", 256, 2), **kw),
    "decode": lambda m, L, G, R, kw: m.lm_cell(
        "granite-moe-3b-a800m", L("d", "decode", 256, 2), **kw),
    "lm_train": lambda m, L, G, R, kw: m.lm_cell(
        "chatglm3-6b", L("t", "train", 128, 4), **kw),
    "serve_p99": lambda m, L, G, R, kw: m.recsys_cell(
        "dcn-v2", next(s for s in R if s.name == "serve_p99")),
    "gin_train": lambda m, L, G, R, kw: m.gnn_cell(
        "gin-tu", G("molecule", "molecule", 30, 64, d_feat=16,
                    batch_graphs=128)),
}


@pytest.mark.parametrize("case", sorted(SMOKE))
def test_dot_flops_match_analyze_hlo(monkeypatch, case):
    want_cell, got_cell = _smoke_cells(monkeypatch, SMOKE[case])
    text = jax.jit(want_cell.fn).lower(*want_cell.args).compile().as_text()
    want = analyze_hlo(text).dot_flops
    fn, args = got_cell.build(META)
    got = count_call(fn, args)[1].dot_flops
    assert want > 0
    assert abs(got - want) <= FLOP_TOL[case] * want, (got, want)


# -- the kernel wrappers under a counter (CPU: their plain versions) ----


def _kernel_calls():
    from repro_torch.kernels.batched_backtrace import ops as bt_ops
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.lane_superstep import ops as ls_ops
    from repro_torch.kernels.segment_minplus import ops as sm_ops
    from repro_torch.kernels.subset_combine import ops as sc_ops

    g = torch.Generator().manual_seed(0)
    rng = np.random.default_rng(0)
    S = torch.sort(torch.randint(0, 30, (2, 50, 8, 3), generator=g).float(),
                   dim=-1).values
    table = torch.randn(40, 8, generator=g)
    ids = torch.randint(-2, 45, (6, 5), generator=g, dtype=torch.int32)
    q = torch.randn(1, 33, 4, 16, generator=g)
    kv = torch.randn(1, 33, 2, 16, generator=g)
    # A small graph for the lane kernel and the walk.
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(
        rng.integers(0, 4, 50))]), dtype=torch.int64)
    n_e = int(offsets[-1])
    src = torch.randint(0, 50, (n_e,), generator=g, dtype=torch.int32)
    w = torch.randint(1, 4, (n_e,), generator=g).float()
    changed = torch.rand(2, 50, generator=g) < 0.5
    done = torch.tensor([False, True])
    cand = torch.randint(1, 20, (7, 12, 4), generator=g).float()
    grouped_out = torch.empty(6, 3 + 2 * 8)
    ids2 = ids[:, :2].contiguous()
    return {
        "subset_combine": (sc_ops.subset_combine, (S, 3),
                           rl.combine_work(S, 3)),
        "lane_superstep": (ls_ops.fused_lane_step,
                           (S, changed, done, offsets, src, w, 3),
                           rl.lane_work(S, changed, done, offsets, src, w)),
        "padded_topk": (sm_ops.padded_topk, (cand, 3),
                        rl.topk_work(cand, 3)),
        "flash_attention": (fa_ops.flash_attention, (q, kv, kv),
                            rl.flash_work(q, kv)),
        "embedding_bag": (eb_ops.embedding_bag, (table, ids),
                          rl.embedding_bag_work(table, ids)),
        "embedding_bag_grouped": (
            lambda t, i, o: eb_ops.embedding_bag_grouped(
                [t, t], i, o, col0=3, clip=True),
            (table, ids2, grouped_out),
            rl.grouped_work([table, table], ids2, clip=True)),
    }


@pytest.mark.parametrize("name", ["subset_combine", "lane_superstep",
                                  "padded_topk", "flash_attention",
                                  "embedding_bag", "embedding_bag_grouped"])
def test_kernel_wrapper_reports_its_formula(name):
    fn, args, (nbytes, flops, dtype, *_) = _kernel_calls()[name]
    _, s = count_call(fn, args)
    assert s.kernel_calls == {name: 1}
    assert s.n_ops == 1                 # the plain version's ops: none
    assert s.dot_flops == 0
    assert s.kernel_flops == flops and s.kernel_bytes == nbytes
    assert s.eager_bytes == nbytes
    assert s.flops_by_dtype == ({_dtype(dtype): flops} if flops else {})


def test_backtrace_wrapper_reports_its_records():
    from repro_torch.answers import BatchedBacktracer
    from repro_torch.core import dks, driver
    from repro_torch.graph.generators import lod_like_graph
    from repro_torch.kernels.batched_backtrace import ops as bt_ops

    graph, _ = lod_like_graph(200, 2000, seed=5, vocab=40)
    dg = graph.to_device("cpu")
    masks = np.random.default_rng(0).random((2, 3, dg.v_pad)) < 0.05
    masks[:, :, graph.n_nodes:] = False
    kw = torch.from_numpy(masks)
    st = driver.run_lanes(dg, kw, dks.DKSConfig(m=3, k=2, max_supersteps=32))
    bt = BatchedBacktracer(graph, device="cpu")
    args = bt._walk_args(st.S.contiguous(), kw, 2)[2]
    recs, s = count_call(bt_ops.batched_backtrace, args)
    assert s.kernel_calls == {"batched_backtrace": 1} and s.n_ops == 1
    want, _, _ = rl.backtrace_work(*args, result=recs)
    assert s.kernel_bytes == want
    assert rl.bound(want, 0)[0] == rl.backtrace_bound(args)[0]
    # The scans' bytes are part of it: more than the records alone.
    assert want > rl.backtrace_work(*args)[0]


TOL32 = np.float32(1e-3)


def brute_reads(S, kw, cand_idx, cand_val, indptr, esrc, ew, pa, pb,
                buffer, degree_cap):
    """The host backtrace's scans written out, one candidate and one
    obligation at a time: the set of (input, flat index) entries each
    first-match scan tests, and per walk (obligations, split items (p, i),
    neighbours)."""
    from repro_torch import INF

    S, kw = S.numpy(), kw.numpy()
    L, vp, n_sets, K = S.shape
    m, P = kw.shape[1], pa.shape[1]
    flat = S.reshape(-1)
    seen, walks = set(), []
    n_nodes = indptr.numel() - 1
    for lane in range(L):
        for c in range(cand_idx.shape[1]):
            x0 = np.float32(cand_val[lane, c])
            queue = [(int(cand_idx[lane, c]) // K, n_sets - 1, x0)]
            obl = items = nbrs = 0
            it = 0
            while x0 < INF and it < len(queue):
                v, s_, x = queue[it]
                it += 1
                obl += 1
                xt = np.float32(x + TOL32)
                if x <= TOL32:
                    bits = [b for b in range(m) if s_ >> b & 1]
                    seen.update(("kw", (lane * m + b) * vp + v) for b in bits)
                    if all(kw[lane, b, v] for b in bits):
                        continue
                row = (lane * vp + v) * n_sets
                n_p = int((pa[s_] > 0).sum())
                kids = None
                for p in range(n_p):
                    a, b = int(pa[s_, p]), int(pb[s_, p])
                    seen.update({("pa", s_ * P + p), ("pb", s_ * P + p)})
                    for i in range(K):
                        items += 1
                        seen.add(("S", (row + a) * K + i))
                        y = flat[(row + a) * K + i]
                        if not (y <= xt and y < INF):
                            items += K - 1 - i
                            break
                        for j in range(K):
                            seen.add(("S", (row + b) * K + j))
                            z = flat[(row + b) * K + j]
                            if not z < INF:
                                break
                            if abs(np.float32(np.float32(y + z) - x)) <= TOL32:
                                kids = [(v, a, y), (v, b, z)]
                                break
                        if kids:
                            break
                    if kids:
                        break
                if kids is None and v < n_nodes:
                    start = int(indptr[v])
                    seen.update({("indptr", v), ("indptr", v + 1)})
                    for d in range(min(int(indptr[v + 1]) - start,
                                       degree_cap)):
                        e = start + d
                        nbrs += 1
                        seen.update({("ew", e), ("esrc", e)})
                        w, u = np.float32(ew[e]), int(esrc[e])
                        if not (w < INF and w <= xt):
                            continue
                        xw = np.float32(x - w)
                        for j in range(K):
                            cell = ((lane * vp + u) * n_sets + s_) * K + j
                            seen.add(("S", cell))
                            z = flat[cell]
                            if not z < INF:
                                break
                            if abs(np.float32(z - xw)) <= TOL32:
                                kids = [(u, s_, z)]
                                break
                        if kids:
                            break
                if kids is None or len(queue) + len(kids) > buffer:
                    break
                queue += kids
            walks.append((obl, items, nbrs))
    counts = {}
    for name, _ in seen:
        counts[name] = counts.get(name, 0) + 1
    return counts, walks


@pytest.mark.parametrize("m,k,caps", [(3, 2, {}), (2, 3, {}), (4, 1, {}),
                                      (3, 3, {"degree_cap": 3, "buffer": 5})])
def test_backtrace_scan_bytes_equal_a_brute_force_count(m, k, caps):
    """The walk's scan reads (``rl.backtrace_reads``: entries its
    first-match order tests, each once) and each walk's obligations and
    scan lengths against the host scans written out one by one."""
    from repro_torch.answers import BatchedBacktracer
    from repro_torch.core import dks, driver
    from repro_torch.graph.generators import lod_like_graph

    graph, _ = lod_like_graph(150, 900, seed=m + k, vocab=30)
    dg = graph.to_device("cpu")
    masks = np.random.default_rng(m * k).random((3, m, dg.v_pad)) < 0.06
    masks[:, :, graph.n_nodes:] = False
    kw = torch.from_numpy(masks)
    st = driver.run_lanes(dg, kw, dks.DKSConfig(m=m, k=k,
                                                max_supersteps=32))
    args = BatchedBacktracer(graph, device="cpu", **caps)._walk_args(
        st.S.contiguous(), kw, k)[2]
    got = rl.backtrace_reads(args)
    want, walks = brute_reads(*args)
    assert {n: got[n] for n in rl.BACKTRACE_ENTRY_BYTES if got[n]} == want
    scans = got["scans"]
    per = np.zeros((len(walks), 3), np.int64)
    np.add.at(per, scans[:, 0].numpy(), np.stack(
        [np.ones(len(scans), np.int64), scans[:, 1].numpy(),
         scans[:, 2].numpy()], 1))
    assert per.tolist() == [list(w) for w in walks]
    assert want["S"] > 0 and want.get("ew", 0) > 0
    # One thread testing one item a round: rounds are the scan lengths.
    r = rl.backtrace_rounds(got, 1, edges=1)
    assert r["obligations"] + r["split_rounds"] + r["edge_rounds"] == \
        max(sum(w) for w in walks)
    wide = rl.backtrace_rounds(got, 256)
    assert wide["obligations"] <= sum(wide[k] for k in (
        "obligations", "split_rounds", "edge_rounds")) <= sum(r[k] for k in (
            "obligations", "split_rounds", "edge_rounds"))


def test_meta_wrappers_return_empty_outputs_of_the_right_shape():
    from repro_torch.kernels.embedding_bag import ops as eb_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.segment_minplus import ops as sm_ops

    q = torch.empty(2, 64, 8, 128, dtype=torch.bfloat16, device=META)
    kv = torch.empty(2, 64, 2, 128, dtype=torch.bfloat16, device=META)
    out, s = count_call(fa_ops.flash_attention, (q, kv, kv))
    assert (out.device, out.shape, out.dtype) == (META, q.shape, q.dtype)
    assert s.flops_by_dtype == {"bfloat16": rl.flash_flops(q, kv)}
    bag = eb_ops.embedding_bag(torch.empty(10, 4, device=META),
                               torch.empty(3, 2, dtype=torch.int32,
                                           device=META))
    assert (bag.device, bag.shape) == (META, (3, 4))
    top = sm_ops.padded_topk(torch.empty(5, 9, 4, device=META), 3)
    assert (top.device, top.shape) == (META, (5, 4, 3))


def test_scaled_multiplies_only_under_a_counter():
    from repro_torch.analysis import count

    x = torch.ones(3, 3)
    with count.scaled(4):               # no counter: nothing to scale
        y = x @ x
    _, s = count_call(lambda x: x @ x, (x,))
    with count.Counter() as c:
        with count.scaled(4):
            x @ x
    assert torch.equal(y, x @ x)
    assert c.folded == [4] and c.dot_flops == 4 * s.dot_flops


def _smoke_train_args():
    cfg = get_arch("chatglm3-6b").smoke()
    state = lm_lib.init_train_state(
        tfm.init_lm(cfg, torch.Generator().manual_seed(0)))
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab, (4, 32), generator=g,
                              dtype=torch.int32) for k in ("tokens", "labels")}
    return state, batch


def test_folded_train_step_counts_the_whole_step():
    """The catalog's folded step (one micro-batch run, counted x4) counts
    what ``make_train_step(grad_accum=4)`` runs: the same products and,
    but for the loss's scalar sums, the same bytes."""
    full = lm_lib.make_train_step(AdamWConfig(), "naive", grad_accum=4)
    folded = tc.folded_train_step(AdamWConfig(), "naive", 4)
    _, want = count_call(full, _smoke_train_args())
    _, got = count_call(folded, _smoke_train_args())
    assert want.multiplier == [] and got.multiplier == [4]
    assert got.dot_flops == want.dot_flops > 0
    assert got.flops_by_dtype == want.flops_by_dtype
    assert abs(got.eager_bytes - want.eager_bytes) <= 1e-3 * want.eager_bytes


def test_a_counted_train_step_is_the_step():
    """Counting a step with micro-batches changes nothing it computes."""
    step = lm_lib.make_train_step(AdamWConfig(), "naive", grad_accum=2)
    new, metrics = step(*_smoke_train_args())
    (new_c, metrics_c), _ = count_call(step, _smoke_train_args())
    assert torch.equal(metrics["loss"], metrics_c["loss"])
    for (name, p), q in zip(new.model.named_parameters(),
                            new_c.model.parameters()):
        assert torch.equal(p, q), name


# -- the full-width meta dry run against hand counts --------------------


def _gin_params(d_in, d, layers, classes) -> int:
    first = d_in * d + d + d * d + d + 1
    return first + (layers - 1) * (2 * d * d + 2 * d + 1) + d * classes


def _dcn_params() -> int:
    # DCN-v2's 26 vocabularies; a table of 100,000 rows or more is padded
    # to a multiple of 512 rows.
    vocab = [10_000_000, 10_000_000, 5_000_000, 1_000_000, 1_000_000,
             1_000_000, 500_000, 500_000, 100_000, 100_000, 100_000,
             50_000, 50_000, 50_000, 10_000, 10_000, 10_000, 5_000, 5_000,
             1_000, 1_000, 1_000, 500, 100, 100, 50]
    rows = [-(-v // 512) * 512 if v >= 100_000 else v for v in vocab]
    d0 = 13 + 26 * 16
    return (sum(rows) * 16 + 3 * (d0 * d0 + d0)
            + d0 * 1024 + 1024 + 1024 * 1024 + 1024 + 1024 * 512 + 512
            + (d0 + 512) + 16 * 512)


HAND = {
    # bf16 weights, f32 mu and nu, count and step; tokens and labels.
    "chatglm3-6b__train_4k": lambda: (
        10 * get_arch("chatglm3-6b").param_count_analytic() + 8
        + 2 * 256 * 4096 * 4),
    # f32 params, mu, nu, count, step; x, int32 edges, masks, labels,
    # graph ids, positions at n_pad, e_pad.
    "gin-tu__ogb_products": lambda: (
        12 * _gin_params(100, 64, 5, 2) + 8
        + 2_449_408 * (100 * 4 + 1 + 4 + 4 + 12) + 61_859_328 * (8 + 1)),
    "dcn-v2__train_batch": lambda: (
        12 * _dcn_params() + 8 + 65_536 * (13 * 4 + 26 * 4 + 4)),
    # The edge list (src, dst, w, valid), the node arrays and the state.
    "dks-bluk-bnb__superstep_dense_m4_k2": lambda: (
        93_200_384 * (4 + 4 + 4 + 1) + 16_100_352 * (4 + 1)
        + 16_100_352 * (16 * 2 * 4 + 3) + 2 * 16 * 4 + 2 * 2 * 4
        + 2 * 4 + 4 + 3),
}


@pytest.mark.parametrize("name", sorted(HAND))
def test_meta_dry_run_counts_the_state_by_hand(name):
    rec = dryrun.meta_record(tc.get_cell(name))
    assert rec["count"]["arg_bytes"] == HAND[name]()
    assert rec["peak_bytes"] >= rec["count"]["arg_bytes"]
    assert rec["min_bytes"] >= 0 and rec["eager_bytes"] > 0
    assert rec["fits_one_card"] == (rec["peak_bytes"] <= rl.CARD_BYTES)
    if name.startswith("chatglm3"):
        assert rec["count"]["multiplier"] == [
            tc.lm_grad_accum(get_arch("chatglm3-6b"),
                             next(s for s in tc.SHAPES["lm"]
                                  if s.name == "train_4k"))]
        assert not rec["fits_one_card"]    # 58 GiB of arguments alone


def test_dryrun_cuda_without_a_card_fails(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dryrun.main(["--device", "cuda", "--only", "serve_p99"]) == 2


def test_grad_accum_rule_divides_by_one_card():
    shape = next(s for s in tc.SHAPES["lm"] if s.name == "train_4k")
    assert tc.lm_grad_accum(get_arch("chatglm3-6b"), shape) == 128
    assert tc.lm_grad_accum(get_arch("command-r-plus-104b"), shape) == 256
    assert jc._lm_grad_accum(repro_get_arch("chatglm3-6b").config,
                             shape) == 1


@pytest.mark.parametrize("chunk", [7, 64, 1000])
def test_relax_ranges_from_host_offsets_equal_device_reads(monkeypatch,
                                                           chunk):
    """The dense cell's relax on meta takes each chunk's destination range
    from the graph's host offsets; on real data that gives the relax of
    the device reads exactly, padded edges included."""
    from repro_torch.core import dks
    from repro_torch.graph.generators import lod_like_graph

    graph, _ = lod_like_graph(300, 900, seed=3, vocab=30)
    dg = graph.to_device("cpu", pad_edges_to=graph.n_edges_sym + 37)
    rng = np.random.default_rng(chunk)
    S = torch.from_numpy(np.sort(rng.integers(0, 9, (2, dg.v_pad, 4, 2)),
                                 axis=-1).astype(np.float32))
    changed = torch.from_numpy(rng.random((2, dg.v_pad)) < 0.5)
    cfg = dks.DKSConfig(m=2, k=2)
    monkeypatch.setattr(dks, "RELAX_CHUNK_BYTES", chunk * 2 * 4 * 2 * 4)
    got = dks.relax(dg, S, changed, cfg)
    want = dks.relax_edges(S, changed, dg.src, dg.dst, dg.w, dg.valid)
    assert dg.in_offsets_host is not None
    assert torch.equal(got, want)
