"""The port's CUDA kernels against their plain torch versions, on the card.

This file imports neither JAX nor ``repro``, so it runs on a machine with a
GPU and PyTorch alone:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Without a card every test here skips (through the ``cuda_device``
fixture, decided when the test runs).  The flash tests also check which of
the kernel's two routes launched (``"wgmma"`` for bf16 at head dims 64 and
128, ``"wmma"`` otherwise); the lane-superstep tests take graphs with hubs
(nodes past ``HUB_IN_DEGREE`` in-edges, one warp per lane and hub).  Tolerance: none for the DKS
kernels (``padded_topk`` included) — every lattice value is a min, a
compare or one f32 add; 2e-5 (f32) and 2e-2 (bf16) for flash attention and
1e-5 for multi-hot EmbeddingBag, the JAX package's own
(``tests/test_kernels.py``), since their sums run in another order; none
for single-hot bags, the grouped lookup and the DCN-v2 logits built on
them, and none for the batched backtrace's records (integers).  The DKS
kernels run at m = 1..6 and K = 1..8.  The stepwise surfaces (streams,
deadline buckets, telemetry) and the service on ``"cuda"`` equal
``"torch"`` exactly, times excluded.  The GNN families (no kernel of
their own) on the card against the CPU: f32 loss within 1e-5 and
gradients within 1e-4 of each leaf's largest magnitude (atomics reorder
the scatter sums); PNA's chunked aggregate's maxima and minima exactly.
"""

import numpy as np
import pytest
import torch

from repro_torch import INF, interop
from repro_torch.configs import DCN_V2, get_arch
from repro_torch.core import dks, driver
from repro_torch.core.reconstruct import collect_answers
from repro_torch.core.semiring import sorted_unique_k
from repro_torch.checkpoint import Stacked, restore_tree, save_tree
from repro_torch.data import lm_synthetic_stream, recsys_synthetic_stream
from repro_torch.graph.generators import lod_like_graph
from repro_torch.answers import BatchedBacktracer
from repro_torch.engine import ExecutionPolicy, QueryEngine
from repro_torch.graph.generators import grid_graph
from repro_torch.kernels.batched_backtrace import ops as bt_ops
from repro_torch.kernels.batched_backtrace.ref import batched_backtrace_ref
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.kernels.embedding_bag.ref import (embedding_bag_grouped_ref,
                                                   embedding_bag_ref)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.lane_superstep import ops as ls_ops
from repro_torch.kernels.lane_superstep.ref import fused_lane_step_ref
from repro_torch.kernels.segment_minplus import ops as sm_ops
from repro_torch.kernels.segment_minplus.ref import padded_topk_ref
from repro_torch.kernels.subset_combine import ops as sc_ops
from repro_torch.kernels.subset_combine.ref import subset_combine_ref
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import kvcache
from repro_torch.models import lm as lm_lib
from repro_torch.models import recsys as rec_lib
from repro_torch.models import transformer as tfm
from repro_torch.optim import tree_leaves, tree_map
from repro_torch.serve import DKSService, ServeConfig
from repro_torch.serve.loadgen import make_trace, replay


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs the same checks "
                    "on the H100)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(1, 3), (2, 1), (3, 3), (4, 4), (5, 2),
                                 (6, 1), (6, 4), (6, 8), (3, 5), (2, 6),
                                 (4, 7), (5, 8)])
def test_subset_combine_kernel_matches_plain(cuda_device, m, k):
    rng = np.random.default_rng(10 * m + k)
    s = rng.integers(1, 20, size=(1001, 1 << m, k)).astype(np.float32)
    s[rng.random(s.shape) > 0.5] = INF
    S = sorted_unique_k(torch.from_numpy(s).to(cuda_device), k)
    S[:, 0, :] = INF
    launched = sc_ops.launches
    got = sc_ops.subset_combine(S, m)
    assert sc_ops.launches == launched + 1
    assert torch.equal(got, subset_combine_ref(S, m))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(1, 2), (3, 3), (5, 4), (6, 3), (6, 8),
                                 (2, 5), (4, 7)])
def test_lane_superstep_kernel_matches_plain(cuda_device, m, k):
    """A real mid-run state on a hub-heavy graph, one of 3 lanes done."""
    g, _ = lod_like_graph(200, 2000, seed=5, vocab=40)
    dg = g.to_device(cuda_device)
    cfg = dks.DKSConfig(m=m, k=k)
    masks = torch.from_numpy(
        np.random.default_rng(m).random((3, m, dg.v_pad)) < 0.03)
    st = dks.superstep(dg, driver.lane_init(dg, masks.to(cuda_device), cfg),
                       cfg)
    done = torch.tensor([True, False, False], device=cuda_device)
    args = (st.S, st.changed, done, dg.in_offsets, dg.src, dg.w)
    launched = ls_ops.launches
    got = ls_ops.fused_lane_step(*args, m)
    assert ls_ops.launches == launched + 1
    assert torch.equal(got, fused_lane_step_ref(*args, m))
    assert torch.equal(got[0], st.S[0])


@pytest.fixture(scope="module")
def hub_graph():
    """A graph whose in-degrees run through 31, 32 and 33 (the hub
    threshold) up to 980, with INF-weight edges (tau = 300) into hubs."""
    g, _ = lod_like_graph(3000, 40000, seed=1, vocab=40, tau=300)
    return g


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(1, 2), (3, 3), (5, 4), (6, 8), (3, 6)])
def test_lane_superstep_hub_warps_match_plain(cuda_device, hub_graph, m, k):
    """A real mid-run state, lanes 1 and 3 of 4 done: the rows of hubs
    (one warp per lane and hub) and of light nodes bit-equal to the plain
    version, in one launch."""
    dg = hub_graph.to_device(cuda_device)
    deg = dg.in_offsets.diff()
    for d in (31, 32, 33):
        assert bool((deg == d).any())
    assert int(deg.max()) > 900 and dg.hub_nodes.numel() == 422
    n_e = dg.n_edges
    inf_dst = dg.dst[:n_e][dg.w[:n_e] >= INF / 2].long()
    assert bool((deg[inf_dst] > 32).any())
    cfg = dks.DKSConfig(m=m, k=k)
    masks = torch.from_numpy(
        np.random.default_rng(m).random((4, m, dg.v_pad)) < 0.01)
    st = driver.lane_init(dg, masks.to(cuda_device), cfg)
    for _ in range(2):
        st = dks.superstep(dg, st, cfg)
    done = torch.tensor([False, True, False, True], device=cuda_device)
    args = (st.S, st.changed, done, dg.in_offsets, dg.src, dg.w)
    launched = ls_ops.launches
    got = ls_ops.fused_lane_step(*args, m, dg.hub_nodes)
    assert ls_ops.launches == launched + 1
    assert torch.equal(got, fused_lane_step_ref(*args, m))
    assert torch.equal(got[1], st.S[1]) and torch.equal(got[3], st.S[3])


@pytest.mark.cuda
def test_lane_superstep_takes_a_hub_list_built_for_cut_edges(cuda_device,
                                                            hub_graph):
    """Cut edge lists (finite weights only; then only edges into nodes of
    at most 100 finite in-edges) with their own hub lists from
    ``hub_nodes``: the kernel equals the plain version on each."""
    dg = hub_graph.to_device(cuda_device)
    m, k = 3, 3
    cfg = dks.DKSConfig(m=m, k=k)
    masks = torch.from_numpy(
        np.random.default_rng(7).random((3, m, dg.v_pad)) < 0.01)
    st = dks.superstep(dg, driver.lane_init(dg, masks.to(cuda_device), cfg),
                       cfg)
    done = torch.tensor([False, False, True], device=cuda_device)
    n_e = dg.n_edges
    dst = dg.dst[:n_e].long()
    finite = dg.w[:n_e] < INF / 2
    fin_deg = torch.bincount(dst[finite], minlength=dg.v_pad)
    for keep in (finite, finite & (fin_deg[dst] <= 100)):
        off = torch.zeros(dg.v_pad + 1, dtype=torch.int64,
                          device=cuda_device)
        off[1:] = torch.cumsum(torch.bincount(dst[keep], minlength=dg.v_pad),
                               0)
        src, w = dg.src[:n_e][keep].contiguous(), dg.w[:n_e][keep].contiguous()
        hubs = ls_ops.hub_nodes(off)
        assert 0 < hubs.numel() < dg.hub_nodes.numel()
        args = (st.S, st.changed, done, off, src, w)
        assert torch.equal(ls_ops.fused_lane_step(*args, m, hubs),
                           fused_lane_step_ref(*args, m))


@pytest.mark.cuda
def test_lane_superstep_skips_hub_entries_that_are_not_hubs(cuda_device,
                                                           hub_graph):
    """Entries of the hub list past the graph, negative, light or repeated
    change nothing: the kernel still equals the plain version."""
    dg = hub_graph.to_device(cuda_device)
    m, k = 2, 2
    cfg = dks.DKSConfig(m=m, k=k)
    masks = torch.from_numpy(
        np.random.default_rng(3).random((2, m, dg.v_pad)) < 0.01)
    st = dks.superstep(dg, driver.lane_init(dg, masks.to(cuda_device), cfg),
                       cfg)
    deg = dg.in_offsets.diff()
    light = int((deg <= 32).nonzero()[0])
    extra = torch.tensor([dg.v_pad + 7, -1, light], dtype=torch.int32,
                         device=cuda_device)
    hubs = torch.cat([extra, dg.hub_nodes, dg.hub_nodes[:5]])
    done = torch.tensor([False, False], device=cuda_device)
    args = (st.S, st.changed, done, dg.in_offsets, dg.src, dg.w)
    assert torch.equal(ls_ops.fused_lane_step(*args, m, hubs),
                       fused_lane_step_ref(*args, m))


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,hq,hkv,dh,q_offset", [
    (1, 128, 128, 4, 4, 64, 0),       # MHA
    (2, 256, 256, 4, 2, 64, 0),       # GQA g=2
    (1, 128, 384, 8, 1, 128, 0),      # MQA, longer kv
    (2, 100, 100, 4, 4, 64, 0),       # lengths not a tile multiple
    (2, 8, 64, 4, 4, 64, 37),         # decode offset
    (1, 200, 200, 32, 2, 128, 0),     # ChatGLM3's GQA, g=16
    (2, 33, 33, 4, 2, 16, 0),         # the smoke configs' head dim
    (1, 65, 70, 4, 1, 32, 5),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda_device, b, sq, skv, hq,
                                              hkv, dh, q_offset, dtype):
    g = torch.Generator(cuda_device).manual_seed(sq * 7 + dh)
    q, k, v = (torch.randn(b, s, h, dh, generator=g, device=cuda_device
                           ).to(dtype)
               for s, h in ((sq, hq), (skv, hkv), (skv, hkv)))
    launched = fa_ops.launches
    by_route = dict(fa_ops.launches_by_route)
    got = fa_ops.flash_attention(q, k, v, q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa_ops.launches == launched + 1
    # bf16 at head dims 64 and 128 takes the Hopper route, the rest WMMA.
    route = ("wgmma" if dtype == torch.bfloat16 and dh in (64, 128)
             else "wmma")
    by_route[route] += 1
    assert fa_ops.launches_by_route == by_route
    want = attention_ref(q, k, v, q_offset=q_offset)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,hq,hkv,q_offset", [
    (1, 1000, 1000, 4, 2, 0),      # the 1 x 1,000 prompt's ragged last tile
    (2, 129, 129, 4, 4, 0),        # one row past a 128-row tile
    (1, 200, 700, 4, 1, 500),      # Skv > Sq, rows start at q_offset
    (1, 256, 256, 32, 2, 0),       # Hq / Hkv = 16, ChatGLM3's grouping
    (3, 300, 300, 8, 2, 0),        # B = 3
])
@pytest.mark.parametrize("dh", [64, 128])
def test_flash_attention_wgmma_route_matches_plain(cuda_device, b, sq, skv,
                                                   hq, hkv, q_offset, dh):
    """The Hopper route (TMA, K/V ring, wgmma) at the edges of its tiles,
    within 2e-2 of the plain version in bf16."""
    g = torch.Generator(cuda_device).manual_seed(sq + skv + dh)
    q, k, v = (torch.randn(b, s, h, dh, generator=g, device=cuda_device
                           ).bfloat16()
               for s, h in ((sq, hq), (skv, hkv), (skv, hkv)))
    wgmma = fa_ops.launches_by_route["wgmma"]
    got = fa_ops.flash_attention(q, k, v, q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa_ops.launches_by_route["wgmma"] == wgmma + 1
    want = attention_ref(q, k, v, q_offset=q_offset)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", [(2, 256), (1, 700)])
def test_flash_attention_at_granite_widths_takes_wgmma(cuda_device, b, s):
    """granite-moe-3b-a800m's attention: 24 query and 8 KV heads (GQA 3) at
    head dim 64, bf16, on the Hopper route, within 2e-2 of the plain
    version."""
    g = torch.Generator(cuda_device).manual_seed(s)
    q, k, v = (torch.randn(b, s, h, 64, generator=g, device=cuda_device
                           ).bfloat16() for h in (24, 8, 8))
    assert fa_ops.route(q.dtype, 64) == "wgmma"
    wgmma = fa_ops.launches_by_route["wgmma"]
    got = fa_ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa_ops.launches_by_route["wgmma"] == wgmma + 1
    torch.testing.assert_close(got.float(), attention_ref(q, k, v).float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["chatglm3-6b", "qwen1.5-4b",
                                  "granite-moe-3b-a800m", "dbrx-132b"])
def test_smoke_prefill_through_the_kernel_matches_naive(cuda_device, arch):
    """One launch per layer per prefill; f32 logits and caches equal the
    naive attention's to 1e-4."""
    cfg = get_arch(arch).smoke().scaled(param_dtype="float32")
    gen = torch.Generator(cuda_device).manual_seed(0)
    model = tfm.init_lm(cfg, gen)
    tokens = torch.randint(0, cfg.vocab, (2, 100), generator=gen,
                           device=cuda_device)
    launched = fa_ops.launches
    got, cache = lm_lib.make_prefill_step("cuda")(model, tokens)
    assert fa_ops.launches == launched + cfg.n_layers
    want, cache_n = lm_lib.make_prefill_step("naive")(model, tokens)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(cache["k"], cache_n["k"], atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["chatglm3-6b", "granite-moe-3b-a800m"])
def test_decode_step_quant_on_the_card_matches_cpu(cuda_device, arch):
    """An f32 smoke model's int8-cache decode on the card against the same
    weights on the CPU: 12 teacher-forced steps, greedy tokens equal, logits
    within 5e-2 (P·V takes P in bf16, so the two devices' f32 exp can move
    a weight by a bf16 ulp, as between ``repro`` and the port)."""
    cfg = get_arch(arch).smoke().scaled(param_dtype="float32")
    cpu = tfm.init_lm(cfg, torch.Generator("cpu").manual_seed(0))
    card = tfm.LM(cfg, device=cuda_device, dtype=torch.float32)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, cfg.vocab, (2, 12),
                           generator=torch.Generator().manual_seed(1))
    caches = [kvcache.init_cache_quant(cfg, 2, 16, device=d)
              for d in ("cpu", cuda_device)]
    with torch.no_grad():
        for t in range(tokens.shape[1]):
            tok = tokens[:, t:t + 1]
            lc, caches[0] = cpu.decode_step_quant(caches[0], tok, chunk=8)
            lg, caches[1] = card.decode_step_quant(
                caches[1], tok.to(cuda_device), chunk=8)
            torch.testing.assert_close(lg.cpu(), lc, atol=5e-2, rtol=5e-2)
            assert torch.equal(lg.argmax(-1).cpu(), lc.argmax(-1)), t
    assert caches[1]["pos"] == 12


@pytest.mark.cuda
@pytest.mark.parametrize("b,nnz,v,d,mode,weighted", [
    (37, 1, 50, 16, "sum", False),
    (37, 5, 1000, 8, "mean", True),
    (101, 64, 3000, 32, "sum", True),
    (64, 17, 200, 128, "mean", False),
    (9, 3, 40, 12, "sum", True),          # D not a multiple of 4
    (1000, 32, 100_000, 16, "sum", True),
])
def test_embedding_bag_kernel_matches_plain(cuda_device, b, nnz, v, d, mode,
                                            weighted):
    """-1 pads, ids past the table, an all-pad bag; within 1e-5."""
    rng = np.random.default_rng(b + nnz)
    table = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)
                             ).to(cuda_device)
    ids = rng.integers(-1, v + 3, size=(b, nnz)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.3] = -1
    ids[0] = -1
    ids = torch.from_numpy(ids).to(cuda_device)
    w = (torch.from_numpy(rng.normal(size=(b, nnz)).astype(np.float32)
                          ).to(cuda_device) if weighted else None)
    launched = eb_ops.launches
    got = eb_ops.embedding_bag(table, ids, w, mode)
    torch.cuda.synchronize()
    assert eb_ops.launches == launched + 1
    torch.testing.assert_close(got, embedding_bag_ref(table, ids, w, mode),
                               atol=1e-5, rtol=1e-5)
    assert not got[0].any()


@pytest.mark.cuda
def test_embedding_bag_kernel_single_hot_is_the_row(cuda_device):
    """A bag of one id, no weights, is the row exactly, on an aligned and
    on a misaligned (scalar path) table; B = 0 and nnz = 0 give zeros."""
    rng = np.random.default_rng(0)
    flat = torch.from_numpy(rng.normal(size=300 * 16 + 1).astype(np.float32)
                            ).to(cuda_device)
    ids = torch.from_numpy(rng.integers(0, 300, (513, 1)).astype(np.int32)
                           ).to(cuda_device)
    for table in (flat[:-1].view(300, 16), flat[1:].view(300, 16)):
        got = eb_ops.embedding_bag(table, ids)
        assert torch.equal(got, table[ids[:, 0].long()])
    assert eb_ops.embedding_bag(table, ids[:0]).shape == (0, 16)
    assert not eb_ops.embedding_bag(table, ids[:, :0].contiguous()).any()


@pytest.mark.cuda
@pytest.mark.parametrize("nnz", [1, 31, 32, 33, 300])
@pytest.mark.parametrize("d", [8, 12, 16, 64])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_multi_hot_matches_plain(cuda_device, nnz, d, mode,
                                               weighted):
    """Bags around the kernel's 32-id stage and past it, -1 pads, ids >= V,
    all-pad bags, a batch that is no multiple of the bags a block holds;
    within 1e-5."""
    rng = np.random.default_rng(nnz * d)
    b, v = 203, 500
    table = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)
                             ).to(cuda_device)
    ids = rng.integers(-1, v + 40, size=(b, nnz)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.3] = -1
    ids[0] = -1
    ids[-1] = v + 7
    ids = torch.from_numpy(ids).to(cuda_device)
    w = (torch.from_numpy(rng.normal(size=(b, nnz)).astype(np.float32)
                          ).to(cuda_device) if weighted else None)
    launched = eb_ops.launches
    got = eb_ops.embedding_bag(table, ids, w, mode)
    torch.cuda.synchronize()
    assert eb_ops.launches == launched + 1
    torch.testing.assert_close(got, embedding_bag_ref(table, ids, w, mode),
                               atol=1e-5, rtol=1e-5)
    assert not got[0].any() and not got[-1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("n_fields", [1, 3, 26])
@pytest.mark.parametrize("b,col0,ld_extra", [(1, 0, 0), (300, 13, 0),
                                             (1031, 5, 3)])
@pytest.mark.parametrize("clip", [False, True])
@pytest.mark.parametrize("with_prefix", [False, True])
def test_embedding_bag_grouped_kernel_equals_plain(cuda_device, n_fields, b,
                                                   col0, ld_extra, clip,
                                                   with_prefix):
    """One launch for all fields, into columns at a misaligned col0 and row
    stride, with or without the prefix columns; ids past both ends;
    bit-equal to the plain version, the other columns untouched."""
    rng = np.random.default_rng(n_fields * b + col0)
    d = 16
    tables = [torch.from_numpy(rng.normal(size=(int(rows), d)).astype(
        np.float32)).to(cuda_device)
        for rows in rng.integers(1, 3000, n_fields)]
    ids = torch.from_numpy(np.stack(
        [rng.integers(-3, t.shape[0] + 3, b) for t in tables],
        axis=1).astype(np.int32)).to(cuda_device)
    ld = col0 + n_fields * d + ld_extra
    prefix = (torch.from_numpy(rng.normal(size=(b, col0)).astype(np.float32)
                               ).to(cuda_device) if with_prefix else None)
    got = torch.full((b, ld), 7.0, device=cuda_device)
    launched = eb_ops.launches
    eb_ops.embedding_bag_grouped(tables, ids, got, col0, clip, prefix)
    torch.cuda.synchronize()
    assert eb_ops.launches == launched + 1
    want = embedding_bag_grouped_ref(tables, ids, torch.full_like(got, 7.0),
                                     col0, clip, prefix)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_embedding_bag_grouped_kernel_takes_any_d(cuda_device):
    """D = 12 and D = 1 from misaligned tables, and more requests than one
    sweep of the grid: the row itself, or zeros for padding."""
    rng = np.random.default_rng(1)
    for d, b in ((12, 40_000), (1, 300_000)):
        flat = torch.from_numpy(rng.normal(size=999 * d + 1).astype(
            np.float32)).to(cuda_device)
        tables = [flat[1:].view(999, d), flat[:-1].view(999, d)]
        ids = torch.from_numpy(rng.integers(-2, 1001, (b, 2)).astype(
            np.int32)).to(cuda_device)
        got = torch.full((b, 2 * d + 1), 5.0, device=cuda_device)
        want = embedding_bag_grouped_ref(tables, ids, got.clone(), 1)
        eb_ops.embedding_bag_grouped(tables, ids, got, 1)
        assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("vv,c,f,k", [(8, 16, 4, 2), (16, 64, 16, 2),
                                      (8, 128, 16, 4), (24, 32, 8, 1),
                                      (1001, 192, 8, 3), (33, 12, 32, 4),
                                      (5, 3, 1, 3), (8, 64, 8, 5),
                                      (16, 40, 8, 8), (7, 9, 4, 6),
                                      (8, 16, 3, 7)])
def test_padded_topk_kernel_matches_plain(cuda_device, vv, c, f, k):
    rng = np.random.default_rng(vv + c)
    cand = rng.integers(1, 30, size=(vv, c, f)).astype(np.float32)
    cand[rng.random(cand.shape) > 0.6] = INF
    cand = torch.from_numpy(cand).to(cuda_device)
    launched = sm_ops.launches
    got = sm_ops.padded_topk(cand, k)
    torch.cuda.synchronize()
    assert sm_ops.launches == launched + 1
    assert torch.equal(got, padded_topk_ref(cand, k))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,dmax", [(3, 3, 64), (2, 2, 4), (5, 4, 16),
                                      (6, 5, 16), (2, 8, 8)])
def test_segment_minplus_padded_on_the_kernel_equals_relax(cuda_device, m, k,
                                                           dmax):
    """A real mid-run lane on a hub-heavy graph: one kernel launch, the
    edge-list relax's result exactly."""
    g, _ = lod_like_graph(200, 2000, seed=5, vocab=40)
    dg = g.to_device(cuda_device)
    cfg = dks.DKSConfig(m=m, k=k)
    masks = torch.from_numpy(
        np.random.default_rng(m).random((1, m, dg.v_pad)) < 0.03)
    st = dks.superstep(dg, driver.lane_init(dg, masks.to(cuda_device), cfg),
                       cfg)
    n_e = dg.n_edges
    csr = sm_ops.padded_csr_from_graph(
        dg.src[:n_e].cpu().numpy(), dg.dst[:n_e].cpu().numpy(),
        dg.w[:n_e].cpu().numpy(), dg.n_nodes, dmax=dmax, device=cuda_device)
    launched = sm_ops.launches
    got = sm_ops.segment_minplus_padded(st.S[0], csr, st.changed[0], k,
                                        dg.v_pad)
    assert sm_ops.launches == launched + 1
    assert torch.equal(got, dks.relax(dg, st.S, st.changed, cfg)[0])


@pytest.mark.cuda
def test_smoke_dcn_through_the_kernel_is_bit_equal_to_plain(cuda_device):
    """One grouped launch per forward, two per retrieval; logits, scores and
    positions bit-equal to the plain path."""
    cfg = DCN_V2.smoke()
    params = rec_lib.init_dcn(cfg, torch.Generator(cuda_device).manual_seed(0))
    batch = rec_lib.batch_to_device(next(recsys_synthetic_stream(cfg, 300)),
                                    cuda_device)
    cand = torch.arange(-5, 500, dtype=torch.int32, device=cuda_device) % 97
    launched = eb_ops.launches
    got = rec_lib.dcn_forward(params, batch["dense"], batch["sparse"], cfg)
    assert eb_ops.launches == launched + 1
    want = rec_lib.dcn_forward(params, batch["dense"], batch["sparse"], cfg,
                               impl="torch")
    assert torch.equal(got, want)
    d1, s1 = batch["dense"][:1], batch["sparse"][:1]
    launched = eb_ops.launches
    got = rec_lib.retrieval_scores(params, d1, s1, cand, cfg, top_k=50)
    assert eb_ops.launches == launched + 2
    want = rec_lib.retrieval_scores(params, d1, s1, cand, cfg, top_k=50,
                                    impl="torch")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def final_tables(graph, m, k, n_lanes, seed, device, density=0.05):
    """Final lane tables of a random bucket (the plain driver), and its
    keyword masks; lane 0 has a keyword on no node (an INF lane)."""
    dg = graph.to_device(device)
    masks = np.random.default_rng(seed).random((n_lanes, m, dg.v_pad)) \
        < density
    masks[:, :, graph.n_nodes:] = False
    masks[0, 0] = False
    kw = torch.from_numpy(masks).to(device)
    st = driver.run_lanes(dg, kw, dks.DKSConfig(m=m, k=k, max_supersteps=32))
    return st.S.contiguous(), kw


@pytest.mark.cuda
@pytest.mark.parametrize("caps", [{}, {"degree_cap": 1, "buffer": 3},
                                  {"degree_cap": 4, "buffer": 6}],
                         ids=["default", "tight", "narrow"])
@pytest.mark.parametrize("graph,m,k", [("lod", 2, 1), ("lod", 3, 3),
                                       ("lod", 4, 2), ("lod", 6, 1),
                                       ("lod", 2, 5), ("lod", 3, 8),
                                       ("grid", 2, 4), ("grid", 3, 2)])
def test_batched_backtrace_kernel_matches_plain(cuda_device, graph, m, k,
                                                caps):
    """Records of every candidate of a bucket (an INF lane, stragglers
    under tight caps, a tied unit grid) equal the plain walk's, in one
    launch."""
    g = (lod_like_graph(300, 1500, seed=m + k, vocab=40)[0]
         if graph == "lod" else grid_graph(7, 7))
    S, kw = final_tables(g, m, k, 4, seed=10 * m + k, device=cuda_device,
                         density=0.05 if graph == "lod" else 0.08)
    bt = BatchedBacktracer(g, device=cuda_device, **caps)
    args = bt._walk_args(S, kw, 4 * k)[2]
    launched = bt_ops.launches
    got = bt_ops.batched_backtrace(*args)
    torch.cuda.synchronize()
    assert bt_ops.launches == launched + 1
    want = batched_backtrace_ref(*args)
    for name, t in want.items():
        assert torch.equal(got[name], t), name
    assert bool(got["fail"][0].all())  # the INF lane


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 7, "all"])
def test_chunked_relax_on_the_card_equals_unchunked(cuda_device, chunk,
                                                    monkeypatch):
    """The ``"torch"`` relax over chunks of edges, on a real mid-run state
    on the card, equals the unchunked relax and the CPU's; the lane
    kernel equals its plain version taken over chunks of a few nodes."""
    g, _ = lod_like_graph(200, 2000, seed=5, vocab=40)
    dg = g.to_device(cuda_device)
    cfg = dks.DKSConfig(m=3, k=3)
    masks = torch.from_numpy(
        np.random.default_rng(3).random((3, 3, dg.v_pad)) < 0.03)
    st = driver.lane_init(dg, masks.to(cuda_device), cfg)
    for _ in range(2):
        st = dks.superstep(dg, st, cfg)
    args = (st.S, st.changed, dg.src, dg.dst, dg.w, dg.valid)
    whole = dks.receive_candidates(
        dks.edge_candidates(st.S, st.changed, dg.src, dg.w, dg.valid),
        dg.dst, dg.v_pad)
    got = dks.relax_edges(*args, chunk_edges=dg.src.shape[0]
                          if chunk == "all" else chunk)
    assert torch.equal(got, whole)
    cpu = dks.relax_edges(*(t.cpu() for t in args), chunk_edges=7)
    assert torch.equal(got.cpu(), cpu)
    done = torch.tensor([False, True, False], device=cuda_device)
    lane_args = (st.S, st.changed, done, dg.in_offsets, dg.src, dg.w)
    kernel = ls_ops.fused_lane_step(*lane_args, 3, dg.hub_nodes)
    monkeypatch.setattr(dks, "NODE_CHUNK_BYTES", 5000)
    monkeypatch.setattr(dks, "RELAX_CHUNK_BYTES", 20000)
    assert torch.equal(kernel, fused_lane_step_ref(*lane_args, 3))


@pytest.mark.cuda
def test_row_view_on_the_card_equals_host_collector(cuda_device):
    """Stragglers (hubs past a degree cap of 4) read their rows off the
    card: trees and ``exhausted`` equal the host collector on each lane's
    whole table, the counters equal the CPU tracer's, and no whole table
    is copied."""
    g = lod_like_graph(300, 1500, seed=6, vocab=40)[0]
    S, kw = final_tables(g, 3, 3, 4, seed=33, device=cuda_device)
    bt = BatchedBacktracer(g, device=cuda_device, degree_cap=4)
    got = bt.extract_lanes(S, kw, k=3, n_nodes=g.n_nodes)
    cpu = BatchedBacktracer(g, device="cpu", degree_cap=4)
    want = cpu.extract_lanes(S.cpu(), kw.cpu(), k=3, n_nodes=g.n_nodes)
    kw_host = kw.cpu().numpy()[:, :, :g.n_nodes]
    for lane, (a, b) in enumerate(zip(got, want)):
        host = collect_answers(S[lane, :g.n_nodes].cpu().numpy(), g,
                               kw_host[lane], k=3)
        trees = [[(t.root, t.edges, t.weight) for t in x[0]]
                 for x in (a, b, host)]
        assert trees[0] == trees[1] == trees[2]
        assert a[1] == b[1] == host[1]
    assert bt.stats() == cpu.stats() and bt.host_fallbacks > 0
    assert bt.table_copies == 0
    assert bt.rows_fetched == cpu.rows_fetched > 0


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(3, 3), (6, 1), (2, 5), (4, 8)])
def test_query_batch_on_the_kernels_equals_torch(cuda_device, m, k):
    """A bucket end to end on ``backend="cuda"`` (every DKS kernel and one
    backtrace launch) answers as ``"torch"``, trees included."""
    g, tokens = lod_like_graph(400, 2000, seed=3, vocab=30)
    engines = {b: QueryEngine.build(g, tokens=tokens, policy=ExecutionPolicy(
        backend=b, max_supersteps=24), device=cuda_device)
        for b in ("cuda", "torch")}
    rng = np.random.default_rng(m * 10 + k)
    queries = [list(rng.choice(30, size=m, replace=False)) for _ in range(4)]
    launched = bt_ops.launches
    got = engines["cuda"].query_batch(queries, k=k)
    assert bt_ops.launches == launched + 1
    want = engines["torch"].query_batch(queries, k=k)
    assert bt_ops.launches == launched + 1
    for rc, rt in zip(got, want):
        np.testing.assert_array_equal(rc.weights, rt.weights)
        assert [(a.root, a.edges, a.weight) for a in rc.answers] == \
            [(a.root, a.edges, a.weight) for a in rt.answers]
    assert engines["cuda"].extraction_stats == \
        engines["torch"].extraction_stats


# ---------------------------------------------------------------------------
# The stepwise surfaces and the service on the kernels
# ---------------------------------------------------------------------------

SERVE_WAIT = 60  # seconds: the most any future is waited for


@pytest.fixture(scope="module")
def serving_engines():
    """``"cuda"`` and ``"torch"`` engines, with and without telemetry, on
    ``lod_like_graph(600, 1800, seed=11, vocab=120)`` (built lazily: the
    module's tests skip without a card)."""
    cache = {}

    def get(device):
        if not cache:
            g, tokens = lod_like_graph(600, 1800, seed=11, vocab=120)
            for b in ("cuda", "torch"):
                for tel in (False, True):
                    cache[(b, tel)] = QueryEngine.build(
                        g, tokens=tokens, policy=ExecutionPolicy(
                            backend=b, max_supersteps=32, telemetry=tel),
                        device=device)
            index = cache[("torch", False)].index
            cache["toks"] = [t for t in sorted(index.vocabulary(),
                                               key=index.df)
                             if 2 <= index.df(t) <= 60]
        return cache

    return get


def same_served(rc, rt):
    np.testing.assert_array_equal(rc.weights, rt.weights)
    np.testing.assert_array_equal(rc.roots, rt.roots)
    for f in ("supersteps", "msgs_bfs", "msgs_deep", "explored_frac",
              "done", "budget_hit", "capped", "spa", "spa_ratio"):
        assert getattr(rc, f) == getattr(rt, f), f
    assert [(a.root, a.edges, a.weight) for a in rc.answers] == \
        [(a.root, a.edges, a.weight) for a in rt.answers]


@pytest.mark.cuda
def test_stream_on_the_kernels_equals_torch(cuda_device, serving_engines):
    """Per-superstep weights, roots, frontier, messages and bounds of a
    stream: one lane_superstep launch per superstep after init."""
    e = serving_engines(cuda_device)
    query = e["toks"][0:3]
    launched = ls_ops.launches
    got = list(e[("cuda", False)].query_stream(query, k=2))
    assert ls_ops.launches - launched == len(got) - 1 > 0
    want = list(e[("torch", False)].query_stream(query, k=2))
    assert len(got) == len(want)
    for uc, ut in zip(got, want):
        np.testing.assert_array_equal(uc.weights, ut.weights)
        np.testing.assert_array_equal(uc.roots, ut.roots)
        for f in ("step", "frontier", "msgs_bfs", "msgs_deep", "nu_full",
                  "spa", "opt_lower_bound", "sound_opt_lower_bound",
                  "spa_ratio", "done"):
            assert getattr(uc, f) == getattr(ut, f), (uc.step, f)


@pytest.mark.cuda
@pytest.mark.parametrize("deadline_s", [0.0, 600.0], ids=["at0", "never"])
def test_deadline_bucket_on_the_kernels_equals_torch(cuda_device,
                                                     serving_engines,
                                                     deadline_s):
    e = serving_engines(cuda_device)
    toks = e["toks"]
    queries = [toks[0:2], toks[2:4], toks[4:6], toks[1:3]]
    got = e[("cuda", False)].query_deadline_batch(
        queries, k=2, deadline_s=deadline_s)
    want = e[("torch", False)].query_deadline_batch(
        queries, k=2, deadline_s=deadline_s)
    for (rc, ic), (rt, it) in zip(got, want):
        same_served(rc, rt)
        assert ic == it
    assert got[0][1]["interrupted"] == (deadline_s == 0.0)


@pytest.mark.cuda
def test_telemetry_on_the_kernels_equals_torch(cuda_device, serving_engines):
    e = serving_engines(cuda_device)
    toks = e["toks"]
    queries = [toks[0:2], toks[2:4], toks[1:3]]
    for tel_b in ("cuda", "torch"):
        for rt, rb in zip(e[(tel_b, True)].query_batch(queries, k=2),
                          e[(tel_b, False)].query_batch(queries, k=2)):
            same_served(rt, rb)
    tc = e[("cuda", True)].query_batch(queries, k=2)[0].telemetry
    tt = e[("torch", True)].query_batch(queries, k=2)[0].telemetry
    assert tc.rows() == tt.rows() and tc.n_steps == tt.n_steps > 0
    np.testing.assert_array_equal(tc.frozen, tt.frozen)
    rc, ic = e[("cuda", False)].query_instrumented(toks[0:3], k=2)
    rt, it = e[("torch", False)].query_instrumented(toks[0:3], k=2)
    same_served(rc, rt)
    assert ic["history"] == it["history"]


@pytest.mark.cuda
def test_service_on_the_kernels_equals_torch(cuda_device, serving_engines):
    """A make_trace replay through DKSService on each backend: the same
    served answers, and served trees equal too."""
    e = serving_engines(cuda_device)
    trace = make_trace(e[("torch", False)].index, 16, unique=5, k=2,
                       seed=3)
    served = {}
    for b in ("cuda", "torch"):
        with DKSService(e[(b, False)], ServeConfig(
                max_batch=4, max_wait_ms=5.0, cache_size=64)) as svc:
            out = replay(svc, trace, n_clients=4, timeout=SERVE_WAIT)
            pages = [svc.submit(list(t.keywords), k=2, return_trees=True
                                ).result(SERVE_WAIT).trees
                     for t in trace[:3]]
            served[b] = (out, [[(t.root, t.weight, t.node_labels)
                                for t in p.items] for p in pages])
    for sc, st in zip(served["cuda"][0], served["torch"][0]):
        same_served(sc.result, st.result)
    assert served["cuda"][1] == served["torch"][1]


@pytest.mark.cuda
def test_artifact_engine_on_the_kernels_equals_graph_built(cuda_device,
                                                           tmp_path):
    """An engine built from a written and reopened artifact on the card
    answers as the graph-built ``"cuda"`` engine and as ``"torch"`` on the
    artifact: weights, supersteps and trees, with its kernels launched."""
    from repro_torch.store import from_graph, open_artifact, write_artifact
    g, tokens = lod_like_graph(600, 1800, seed=11, vocab=120)
    result = from_graph(g, tokens=tokens)
    art = write_artifact(tmp_path / "a", result.graph, result.index)
    engines = {
        "graph": QueryEngine.build(g, tokens=tokens, device=cuda_device,
                                   policy=ExecutionPolicy(backend="cuda")),
        "artifact": QueryEngine.build(
            artifact=open_artifact(art.path, verify="full"),
            device=cuda_device, policy=ExecutionPolicy(backend="cuda")),
        "torch": QueryEngine.build(artifact=art.path, device=cuda_device,
                                   policy=ExecutionPolicy(backend="torch")),
    }
    assert engines["artifact"].version == f"artifact:{art.content_hash}"
    index = engines["torch"].index
    toks = [t for t in sorted(index.vocabulary(), key=index.df)
            if 2 <= index.df(t) <= 60]
    queries = [toks[0:3], toks[3:5], toks[5:8], toks[1:3]]
    launched = (ls_ops.launches, bt_ops.launches)
    got = engines["artifact"].query_batch(queries, k=2)
    assert ls_ops.launches > launched[0] and bt_ops.launches > launched[1]
    for other in ("graph", "torch"):
        for rc, rt in zip(got, engines[other].query_batch(queries, k=2)):
            same_served(rc, rt)


@pytest.mark.cuda
def test_swap_on_the_card_warms_on_the_watcher_thread(cuda_device,
                                                      tmp_path):
    """A live graph served on the card: a fragment published through the
    watcher's thread swaps in a successor built on the same card, warmed
    there (its launches counted on that thread, apart from the
    dispatcher's), answering as a ``"torch"`` engine on the compacted
    union."""
    import threading

    from repro_torch.live import EngineSwapper, GraphWatcher, LiveDir
    from repro_torch.store import compact_chain, ingest_tsv

    lines = [f"e{i:03d} g{i % 4}\te{(i + 1) % 32:03d} g{(i + 1) % 4}"
             for i in range(32)]
    (tmp_path / "base.tsv").write_text("\n".join(lines) + "\n")
    live = LiveDir.initialize(tmp_path / "live",
                              ingest_tsv(tmp_path / "base.tsv"))
    policy = ExecutionPolicy(backend="cuda", max_supersteps=24)
    e0 = QueryEngine.build(artifact=live.chain(), policy=policy,
                           device=cuda_device)
    probe = ["e000", "e008"]
    incoming = tmp_path / "incoming"
    incoming.mkdir()
    with DKSService(e0, ServeConfig(max_batch=2, max_wait_ms=1.0,
                                    cache_size=0)) as svc:
        assert svc.query(probe, k=1, timeout=SERVE_WAIT).result.weights[0] \
            == 8.0
        swapped = threading.Event()
        swapper = EngineSwapper(svc)
        for ops in (ls_ops, sc_ops):
            ops.counter.reset()
        watcher = GraphWatcher(
            live, incoming, poll_s=0.02,
            on_delta=lambda lv, d: (swapper.on_delta(lv, d),
                                    swapped.set())).start()
        try:
            (incoming / "frag.tsv").write_text("e000 g0\te008 g0\n")
            assert swapped.wait(SERVE_WAIT), "no swap"
        finally:
            watcher.stop(SERVE_WAIT)
        warm = {ops: ops.counter.by_thread().get("repro-graph-watcher", 0)
                for ops in (ls_ops, sc_ops)}
        assert all(n > 0 for n in warm.values()), warm
        assert swapper.last_warmed, "the warm ran no hot shape"
        assert svc.engine.device == cuda_device
        post = svc.query(probe, k=1, timeout=SERVE_WAIT).result
        assert post.weights[0] == 1.0
    union = QueryEngine.build(
        artifact=compact_chain(live.chain(), tmp_path / "union"),
        policy=ExecutionPolicy(backend="torch", max_supersteps=24),
        device=cuda_device)
    same_served(post, union.query(probe, k=1))


# ---------------------------------------------------------------------------
# The sharded partition on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("frac", [1.0, 0.1], ids=["uncapped", "capped"])
@pytest.mark.parametrize("n_shards", [1, 4])
def test_sharded_engine_on_the_card_equals_cpu(cuda_device, n_shards, frac):
    """A sharded engine on the card answers as the same engine on the CPU,
    uncapped and capped (overflow forces stops): ``query_batch`` with its
    trees, and ``query_stream`` update by update.  The sharded path runs
    stock torch: no hand-written kernel launches."""
    g, tokens = lod_like_graph(401, 1800, seed=11, vocab=60)
    engines = {dev: QueryEngine.build(
        g, tokens=tokens, device=dev, policy=ExecutionPolicy(
            partition="sharded", n_shards=n_shards, frontier_frac=frac,
            max_supersteps=24)) for dev in ("cuda", "cpu")}
    assert engines["cuda"].device == cuda_device
    index = engines["cpu"].index
    toks = [t for t in sorted(index.vocabulary(), key=index.df)
            if 2 <= index.df(t) <= 60]
    queries = [toks[0:3], toks[3:6], toks[6:9], toks[1:4]]
    launched = [ops.launches for ops in (ls_ops, sc_ops, bt_ops)]
    got = engines["cuda"].query_batch(queries, k=2)
    for rc, rt in zip(got, engines["cpu"].query_batch(queries, k=2)):
        same_served(rc, rt)
    assert any(r.budget_hit for r in got) == (frac < 1.0)
    stream = {dev: list(eng.query_stream(toks[0:3], k=2))
              for dev, eng in engines.items()}
    assert len(stream["cuda"]) == len(stream["cpu"]) > 1
    for uc, ut in zip(stream["cuda"], stream["cpu"]):
        np.testing.assert_array_equal(uc.weights, ut.weights)
        np.testing.assert_array_equal(uc.roots, ut.roots)
        for f in ("step", "frontier", "msgs_bfs", "msgs_deep", "nu_full",
                  "spa", "opt_lower_bound", "sound_opt_lower_bound",
                  "spa_ratio", "done"):
            assert getattr(uc, f) == getattr(ut, f), (uc.step, f)
    assert [ops.launches for ops in (ls_ops, sc_ops, bt_ops)] == launched


# --------------------------------------------------------------------------
# training on the card
# --------------------------------------------------------------------------


@pytest.mark.cuda
def test_grouped_lookup_autograd_on_the_card_equals_plain(cuda_device):
    """``dcn_loss`` on ``impl="cuda"`` (one grouped launch forward, a
    scatter-add backward) against ``impl="torch"`` (autograd through the
    per-field bags): the loss bit-equal, every gradient within 1e-5 (the
    scatter-add's atomics reorder sums); ids past a table are clipped."""
    cfg = DCN_V2.smoke()
    params = rec_lib.init_dcn(cfg, torch.Generator(cuda_device).manual_seed(1))
    batch = rec_lib.batch_to_device(next(recsys_synthetic_stream(cfg, 500)),
                                    cuda_device)
    batch["sparse"][:3, 0] = torch.tensor([-5, 10 ** 6, 99])
    leaves = [p.requires_grad_(True) for p in
              [t for _, t in sorted(params["tables"].items())]]
    got = {}
    for impl in ("cuda", "torch"):
        launched = eb_ops.launches
        loss = rec_lib.dcn_loss(params, batch, cfg, impl)
        grads = torch.autograd.grad(loss, leaves)
        assert eb_ops.launches == launched + (impl == "cuda")
        got[impl] = (loss, grads)
    assert torch.equal(got["cuda"][0], got["torch"][0])
    for g, w in zip(got["cuda"][1], got["torch"][1]):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["chatglm3-6b", "granite-moe-3b-a800m"])
def test_smoke_train_step_on_the_card_equals_cpu(cuda_device, arch):
    """One f32 train step of the smoke config (naive attention, TF32 off)
    from the same weights and batch: loss, grad_norm and every parameter
    after the step within 1e-4 of the CPU's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_arch(arch).smoke().scaled(param_dtype="float32")
    cpu = tfm.init_lm(cfg, torch.Generator("cpu").manual_seed(0))
    card = tfm.LM(cfg, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    batch = {k: torch.from_numpy(v) for k, v in
             next(lm_synthetic_stream(cfg.vocab, 4, 32, seed=2)).items()}
    step = lm_lib.make_train_step(lm_lib.AdamWConfig(warmup_steps=1),
                                  attn_impl="naive")
    out = {}
    for name, dev, model in (("cpu", "cpu", cpu), ("card", cuda_device, card)):
        out[name] = step(lm_lib.init_train_state(model),
                         {k: v.to(dev) for k, v in batch.items()})
    for name in ("loss", "grad_norm", "lr"):
        torch.testing.assert_close(out["card"][1][name].cpu(),
                                   out["cpu"][1][name], atol=1e-4, rtol=1e-4)
    for (n, p), (_, q) in zip(out["card"][0].model.named_parameters(),
                              out["cpu"][0].model.named_parameters()):
        torch.testing.assert_close(p.detach().cpu(), q.detach(), atol=1e-4,
                                   rtol=1e-4, msg=lambda m: f"{n}: {m}")


@pytest.mark.cuda
def test_checkpoint_round_trip_from_the_card(cuda_device, tmp_path):
    """A bf16 train state on the card after one step, saved and restored
    onto the card from a meta template: every leaf bit-equal, and the next
    step from either state gives the same loss."""
    cfg = get_arch("granite-moe-3b-a800m").smoke()
    state = lm_lib.init_train_state(tfm.init_lm(
        cfg, torch.Generator(cuda_device).manual_seed(0)))
    step = lm_lib.make_train_step(lm_lib.AdamWConfig(), attn_impl="naive")
    stream = lm_synthetic_stream(cfg.vocab, 2, 64, seed=1)
    batches = [{k: torch.from_numpy(v).to(cuda_device) for k, v in
                next(stream).items()} for _ in range(2)]
    state, _ = step(state, batches[0])
    save_tree(lm_lib.train_state_tree(state), tmp_path, 1)
    back = lm_lib.train_state_from_tree(cfg, restore_tree(
        lm_lib.train_state_template(cfg), tmp_path, 1, device=cuda_device))
    got = tree_leaves(lm_lib.train_state_tree(back))
    want = tree_leaves(lm_lib.train_state_tree(state))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in (zip(g.parts, w.parts) if isinstance(g, Stacked)
                     else [(g, w)]):
            if isinstance(a, torch.Tensor):
                assert a.device == b.device and a.dtype == b.dtype
                assert torch.equal(a.reshape(-1).view(torch.uint8),
                                   b.reshape(-1).view(torch.uint8))
            else:
                assert a == b
    losses = [float(step(s, batches[1])[1]["loss"]) for s in (back, state)]
    assert losses[0] == losses[1]


def gnn_fields(family: str, n_graphs: int = 1, seed: int = 0, n: int = 48,
               e: int = 168) -> dict:
    """A small batch's fields: nodes 40.. receive no edge, the last 3
    nodes and a tenth of the edges masked, 8 edges duplicated."""
    rng = np.random.default_rng(seed)
    src, dst = rng.integers(0, n, e - 8), rng.integers(0, 40, e - 8)
    src, dst = np.concatenate([src, src[:8]]), np.concatenate([dst, dst[:8]])
    node_mask = np.ones(n, bool)
    node_mask[-3:] = False
    if family == "schnet":
        x = rng.integers(1, 10, (n, 1)).astype(np.float32)
        labels = rng.normal(size=n_graphs).astype(np.float32)
    else:
        x = rng.normal(size=(n, 12)).astype(np.float32)
        labels = rng.integers(0, 7, n_graphs if n_graphs > 1 else n)
    return {"x": x, "edge_src": src, "edge_dst": dst, "node_mask": node_mask,
            "edge_mask": rng.random(e) > 0.1, "labels": labels.astype(
                np.float32 if family == "schnet" else np.int32),
            "graph_ids": np.arange(n) * n_graphs // n,
            "positions": rng.normal(size=(n, 3)) * 2, "n_graphs": n_graphs}


@pytest.mark.cuda
@pytest.mark.parametrize("n_graphs", [1, 4], ids=["node", "graph"])
@pytest.mark.parametrize("arch", ["gat-cora", "gin-tu", "pna", "schnet"])
def test_gnn_loss_and_grads_card_equal_cpu(cuda_device, arch, n_graphs):
    """Each GNN family's f32 loss on the card within 1e-5 of the CPU's,
    every gradient leaf within 1e-4 of its largest magnitude (the scatter
    sums' atomics add in another order)."""
    cfg = get_arch(arch)
    fields = gnn_fields(cfg.family, n_graphs, seed=1)
    params = gnn_lib.init_gnn(torch.Generator("cpu").manual_seed(0), cfg,
                              d_in=fields["x"].shape[1])
    out = {}
    for dev in ("cpu", cuda_device):
        out[str(dev)] = gnn_lib.gnn_loss_and_grads(
            tree_map(lambda t: t.to(dev), params),
            interop.graph_batch_from_numpy(fields, dev), cfg)
    (l_c, g_c), (l_d, g_d) = out["cpu"], out[str(cuda_device)]
    torch.testing.assert_close(l_d.cpu(), l_c, atol=1e-5, rtol=1e-5)
    for a, b in zip(g_d, g_c):
        tol = 1e-4 * float(b.abs().max()) + 1e-30
        torch.testing.assert_close(a.cpu(), b, atol=tol, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("n_edges,nc", [(168, 4), (166, 1)],
                         ids=["chunked", "unchunked"])
def test_pna_aggregate_card_equal_cpu(cuda_device, n_edges, nc):
    """PNA's aggregate at chunk 42, chunked (4 x 42 edges) and not (166 %
    4 != 0): maxima and minima exactly, sums within 1e-6, and the
    gradients through the checkpointed chunks on an ``h`` of many exact
    zeros (ties split 1/k) within 1e-6."""
    fields = gnn_fields("pna", seed=5, e=n_edges)
    assert gnn_lib.pna_chunks(n_edges, 42) == nc
    rng = np.random.default_rng(6)
    h = np.maximum(rng.integers(-2, 3, (48, 5)), 0).astype(np.float32)
    w = torch.from_numpy(rng.normal(size=(4, 48, 5)).astype(np.float32))
    res = {}
    for dev in ("cpu", cuda_device):
        b = interop.graph_batch_from_numpy(fields, dev)
        has = gnn_lib._degree(b, 48)[:, None] > 0
        ht = torch.from_numpy(h).to(dev).requires_grad_(True)
        aggs = gnn_lib._pna_aggregate(ht, b, 48, 42)
        wd = w.to(dev)
        obj = (torch.sum(wd[0] * aggs[0]) + torch.sum(wd[1] * aggs[1])
               + torch.sum(torch.where(has, wd[2] * aggs[2], 0.0))
               + torch.sum(torch.where(has, wd[3] * aggs[3], 0.0)))
        res[str(dev)] = ([a.detach().cpu() for a in aggs],
                         torch.autograd.grad(obj, ht)[0].cpu())
    (a_c, g_c), (a_d, g_d) = res["cpu"], res[str(cuda_device)]
    for i, (x, y) in enumerate(zip(a_d, a_c)):
        if i < 2:
            torch.testing.assert_close(x, y, atol=1e-6, rtol=1e-6)
        else:
            assert torch.equal(x, y)
    torch.testing.assert_close(g_d, g_c, atol=1e-6, rtol=1e-6)
