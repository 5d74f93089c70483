"""The DKS kernels' wide route, host side, on the CPU: the plan the
wrappers hand the wide kernels (``subset_combine.ops.wide_plan``), the
hub entries ``lane_superstep``'s wide route gives blocks
(``lane_superstep.ops.wide_hub_entries``), the warps a walk the
answer-tree walk takes (``batched_backtrace.ops.walk_plan``) and the
wide ``padded_topk``'s plan (``segment_minplus.ops.topk_wide_plan``).

At every (m, K) the card tests take past the templated range, and at rows
of 2^m * K = 16,384 floats (the most the kernels take), the plan fits the
227 KB of shared memory a block may have, and its grid (hub blocks, one
per leading hub entry and lane; medium warps, one per hub entry and lane;
then light blocks of ``rows_per_block`` rows) covers every (lane, node)
row exactly once, as ``csrc/lane_superstep.cu`` maps blocks, warps and
teams to rows.  No
kernel runs here: the card tests (``tests/test_torch_cuda.py``) hold the
kernels on these plans against the plain versions.
"""

import functools

import numpy as np
import pytest
import torch

from repro_torch import INF

from repro_torch.graph.generators import lod_like_graph
from repro_torch.graph.structure import HUB_IN_DEGREE
from repro_torch.kernels.batched_backtrace import ops as bt_ops
from repro_torch.kernels.lane_superstep import ops as ls_ops
from repro_torch.kernels.segment_minplus import ops as sm_ops
from repro_torch.kernels.subset_combine import ops as sc_ops

WIDE = [(3, 10), (4, 10), (2, 16), (7, 3), (8, 2), (6, 9), (5, 16),
        (10, 16)]
ROW_LIMIT = [(14, 1), (10, 16), (9, 32), (4, 1024), (2, 4096),
             (1, 8192)]


@functools.lru_cache(maxsize=None)
def hub_graph():
    """In-degrees up to 980: 16 nodes past ``WIDE_HUB_DEGREE``."""
    return lod_like_graph(3000, 40000, seed=1, vocab=40, tau=300)[0] \
        .to_device(device="cpu")


@pytest.mark.parametrize("m,k", WIDE + ROW_LIMIT)
def test_wide_plan_fits_a_block(m, k):
    plan = sc_ops.wide_plan(m, k)
    assert plan.smem_bytes <= sc_ops.SMEM_MAX == 227 * 1024
    assert 1 <= plan.warps <= sc_ops.WIDE_WARPS
    assert plan.rows in (1, 2, 4, 8, 16, 32)
    assert plan.ks % 2 == 1 and k <= plan.ks <= k + 1
    # A team has a lane for each keyword set, up to the whole warp; more
    # only where twice the rows would not fit.  A hub block keeps a
    # partial table for each team.
    assert plan.team >= min(1 << m, 32)
    if plan.team > min(1 << m, 32):
        assert (2 * plan.rows * plan.row_floats + plan.warp_floats
                - plan.rows * plan.row_floats) * 4 > sc_ops.SMEM_MAX
    assert plan.partials == plan.warps * plan.rows >= 1
    assert plan.smem_bytes >= plan.partials * plan.row_floats * 4
    if (1 << m) * k == sc_ops.ROW_FLOATS and k <= 16:
        assert plan.partials == 3  # the 64 KB row limit: three partials
    assert plan.hub_degree == sc_ops.WIDE_HUB_DEGREE


def test_wide_plan_spreads_the_combine_where_it_ran_faster():
    """Private lists for teams of at most 8 lanes and lists of K >= 8
    slots, where they fit beside the row."""
    assert sc_ops.wide_plan(3, 10).spread and sc_ops.wide_plan(2, 16).spread
    assert not sc_ops.wide_plan(4, 10).spread  # teams of 16 lanes
    assert not sc_ops.wide_plan(7, 3).spread
    assert not sc_ops.wide_plan(3, 5).spread   # K < 8
    assert not sc_ops.wide_plan(2, 4096).spread  # 32 lists of 16 KB
    with pytest.raises(ValueError, match=r"2\^m \* k <= 16384"):
        sc_ops.wide_plan(10, 17)


def covered(plan, lanes: int, offsets: torch.Tensor,
            hubs: torch.Tensor) -> torch.Tensor:
    """How many blocks, warps or teams write each (lane, node) row under
    ``plan``, as the kernel maps them: hub block b takes entry b // lanes
    of ``hubs`` at lane b % lanes if its node has more than
    ``plan.hub_degree`` in-edges; medium warp i (over every entry) takes
    entry i // lanes at lane i % lanes if its node has more than
    ``HUB_IN_DEGREE`` and at most ``plan.hub_degree``; team g of warp w of
    light block j takes row (j * warps + w) * rows + g if its node has at
    most ``HUB_IN_DEGREE``."""
    n_nodes = offsets.numel() - 1
    deg = offsets.diff()
    n_rows = lanes * n_nodes
    count = torch.zeros(n_rows, dtype=torch.int64)
    n_hubs = ls_ops.wide_hub_entries(offsets, hubs, plan.hub_degree)
    for i in range(hubs.numel() * lanes):
        v = int(hubs[i // lanes])
        if not 0 <= v < n_nodes:
            continue
        row = (i % lanes) * n_nodes + v
        if i < n_hubs * lanes and deg[v] > plan.hub_degree:
            count[row] += 1
        if HUB_IN_DEGREE < deg[v] <= plan.hub_degree:
            count[row] += 1
    light_blocks = -(-n_rows // plan.rows_per_block)
    assert (light_blocks - 1) * plan.rows_per_block < n_rows
    rows = torch.arange(light_blocks * plan.rows_per_block)
    rows = rows[rows < n_rows]
    light = deg[rows % n_nodes] <= HUB_IN_DEGREE
    count.index_add_(0, rows[light], torch.ones(int(light.sum()),
                                                dtype=torch.int64))
    return count


@pytest.mark.parametrize("m,k", WIDE + ROW_LIMIT)
def test_wide_plan_covers_every_row_once(m, k):
    dg = hub_graph()
    plan = sc_ops.wide_plan(m, k)
    count = covered(plan, 3, dg.in_offsets, dg.hub_nodes)
    assert bool((count == 1).all())
    # Sixteen hubs get blocks: the leading entries of the sorted list.
    assert ls_ops.wide_hub_entries(dg.in_offsets, dg.hub_nodes,
                                   plan.hub_degree) == 16


def test_wide_hub_entries_reach_the_last_hub_of_an_unsorted_list():
    dg = hub_graph()
    off, deg = dg.in_offsets, dg.in_offsets.diff()
    hubs = torch.nonzero(deg > 32).flatten().int()   # by id, not degree
    last = int(torch.nonzero(deg[hubs.long()] > 256).max()) + 1
    assert ls_ops.wide_hub_entries(off, hubs, 256) == last > 16
    plan = sc_ops.wide_plan(3, 10)
    assert bool((covered(plan, 2, off, hubs) == 1).all())
    # Entries past the graph or negative are skipped, not counted.
    extra = torch.tensor([-1, off.numel() + 5], dtype=torch.int32)
    assert ls_ops.wide_hub_entries(off, torch.cat([extra, hubs]), 256) \
        == last + 2
    assert ls_ops.wide_hub_entries(off, extra, 256) == 0
    # A list written in place is counted again.
    listed = dg.hub_nodes.clone()
    assert ls_ops.wide_hub_entries(off, listed, 256) == 16
    listed[16:] = listed[0]
    assert ls_ops.wide_hub_entries(off, listed, 256) == listed.numel()


def test_wide_hub_entries_of_inference_tensors():
    """Tensors made under ``torch.inference_mode`` keep no version, so
    their count is taken anew each call, and a list written in place
    there is counted as it now is."""
    dg = hub_graph()
    with torch.inference_mode():
        off, hubs = dg.in_offsets.clone(), dg.hub_nodes.clone()
        assert ls_ops.wide_hub_entries(off, hubs, 256) == 16
        hubs[16:] = hubs[0]
        assert ls_ops.wide_hub_entries(off, hubs, 256) == hubs.numel()
    assert ls_ops.wide_hub_entries(off, hubs, 256) == hubs.numel()


# -- the walk's plan (kernels/batched_backtrace/ops.py::walk_plan) -----------

def n_pairs_of(m: int) -> int:
    """Split pairs of the full set: ``split_pair_table(m)``'s width."""
    return max(1, 2 ** (m - 1) - 1)


@pytest.mark.parametrize("m", [1, 2, 3, 5, 8])
def test_n_pairs_is_the_pair_table_width(m):
    from repro_torch.answers.batched import split_pair_table
    assert split_pair_table(m)[0].shape[1] == n_pairs_of(m)


@pytest.mark.parametrize("m", range(1, 15))
@pytest.mark.parametrize("buffer", [1, 64, 2048])
def test_walk_plan_fits_a_block(m, buffer):
    """Every m the tables allow (2^m * K <= 16,384: m <= 14) and every
    buffer the kernel takes: the queue and the prefix lengths fit a block,
    and a block of 1..8 warps (a power of two)."""
    for n_walks in (1, 40, 96, 1056, 5000, 10 ** 6):
        plan = bt_ops.walk_plan(n_walks, buffer, n_pairs_of(m))
        assert plan.warps in (1, 2, 4, 8)
        assert plan.smem_bytes == (7 * (buffer + 1) + 2 * n_pairs_of(m)) * 4
        assert plan.smem_bytes <= bt_ops.SMEM_MAX
        assert 1 <= plan.resident <= bt_ops.SM_BLOCKS
        assert plan.resident * plan.warps * 32 <= bt_ops.SM_THREADS
        assert plan.resident * (plan.smem_bytes + 1024) <= bt_ops.SM_SMEM


@pytest.mark.parametrize("buffer,n_pairs", [(64, 3), (64, 7), (2048, 8191)])
def test_walk_plan_keeps_every_walk_resident(buffer, n_pairs):
    """The widest block under which the bucket is one wave: more warps a
    walk as walks get fewer, never a second wave to have them."""
    last = bt_ops.WALK_WARPS
    for n_walks in (1, 40, 96, 500, 1056, 1057, 2112, 4224, 4225, 10 ** 5):
        plan = bt_ops.walk_plan(n_walks, buffer, n_pairs)
        assert plan.warps <= last
        last = plan.warps
        if plan.warps > 1:
            assert n_walks <= bt_ops.SMS * plan.resident
        if plan.warps < bt_ops.WALK_WARPS:
            wider = bt_ops.walk_plan(1, buffer, n_pairs)  # 8 warps
            assert wider.warps == bt_ops.WALK_WARPS
            twice = min(bt_ops.SM_BLOCKS,
                        bt_ops.SM_THREADS // (64 * plan.warps),
                        bt_ops.SM_SMEM // (plan.smem_bytes + 1024))
            assert n_walks > bt_ops.SMS * twice


def test_walk_plan_at_the_main_paths_buckets():
    """sec-rdfabout's bucket (8 lanes x 4k candidates at k = 3) and the
    K = 10 query (40 candidates) take 8 warps a walk; a bucket of 10^5
    walks one."""
    assert bt_ops.walk_plan(8 * 12, 64, 3).warps == 8
    assert bt_ops.walk_plan(40, 64, 7).warps == 8
    assert bt_ops.walk_plan(10 ** 5, 64, 7).warps == 1
    with pytest.raises(ValueError, match="shared memory"):
        bt_ops.walk_plan(1, 2048, 30000)


# -- the wide padded_topk's plan (segment_minplus.ops.topk_wide_plan) --------

TOPK_SHAPES = [(160, 16, 10), (161, 16, 10), (75, 8, 9), (50, 32, 12),
               (40, 64, 9), (33, 3, 11), (300, 2, 16), (20, 1024, 16),
               (48, 16, 10), (640, 8, 10), (8192, 2, 8192), (9, 1820, 9),
               (20, 1, 12)]


@pytest.mark.parametrize("c,f,k", TOPK_SHAPES)
def test_topk_wide_plan_fits_a_block(c, f, k):
    """Teams of up to 32 / F lanes a set, staging of two chunks and the
    lists within a block's 227 KB, chunk starts 16-byte aligned."""
    plan = sm_ops.topk_wide_plan(c, f, k)
    assert plan.ks == k | 1
    assert 1 <= plan.team and (f * plan.team <= 32 if f < 32
                               else plan.team == 1)
    assert 1 <= plan.chunk <= c and plan.stage >= plan.chunk * f
    assert plan.stage % 4 == 0 and plan.warp_floats % 4 == 0
    lists = f * plan.team if f < 32 else f
    assert plan.warp_floats >= 2 * plan.stage + lists * plan.ks
    assert 1 <= plan.warps <= sm_ops.TOPK_WARPS
    assert plan.smem_bytes <= sm_ops.SMEM_MAX
    assert plan.chunk == c or plan.chunk * f % 4 == 0
    assert plan.resident * (plan.smem_bytes + 1024) <= sm_ops.SM_SMEM
    assert 1 <= plan.blocks(1) <= plan.blocks(10 ** 6) \
        <= sm_ops.SMS * plan.resident


def test_topk_wide_plan_at_phase_19s_shape():
    """cand [Vv, 160, 16] at K = 10: teams of 2 lanes (every lane busy),
    two chunks of 80 candidates (5 KB), four warps a block."""
    plan = sm_ops.topk_wide_plan(160, 16, 10)
    assert (plan.team, plan.chunk, plan.warps) == (2, 80, 4)
    with pytest.raises(ValueError, match="F \\* k <= 16384"):
        sm_ops.topk_wide_plan(20, 2048, 9)


def emulate_wide_topk(cand: torch.Tensor, k: int, plan) -> torch.Tensor:
    """``padded_topk_wide_kernel``'s steps on the host: per row, chunk by
    chunk, each lane's partial list of its share (j = part, part + team,
    ... of each chunk), pruned against its K-th value, then the team's
    tree merge; a list per set where F >= 32."""
    vv, c, f = cand.shape
    out = torch.full((vv, f, k), INF)
    team = plan.team if f < 32 else 1
    for row in range(vv):
        lists = [[INF] * k for _ in range(f * team)]

        def insert(r, x):
            if not x < r[k - 1]:
                return
            j = 0
            while r[j] < x:
                j += 1
            if r[j] != x:
                r.insert(j, x)
                r.pop()

        for c0 in range(0, c, plan.chunk):
            tile = cand[row, c0:c0 + plan.chunk].tolist()
            for part in range(team):
                for s in range(f):
                    for j in range(part, len(tile), team):
                        insert(lists[part * f + s], tile[j][s])
        step = 1
        while step < team:
            for part in range(0, team, 2 * step):
                if part + step < team:
                    for s in range(f):
                        for y in lists[(part + step) * f + s]:
                            if not y < lists[part * f + s][k - 1]:
                                break
                            insert(lists[part * f + s], y)
            step *= 2
        out[row] = torch.tensor(lists[:f])
    return out


@pytest.mark.parametrize("c,f,k", [(161, 16, 10), (75, 8, 9), (33, 3, 11),
                                   (40, 64, 9), (300, 2, 16)])
def test_wide_topk_teams_equal_the_plain_version(c, f, k):
    """Partial lists over a team, merged, are the plain version's K
    smallest distinct (duplicates, ties, all-INF and short rows)."""
    from repro_torch import INF as inf
    from repro_torch.kernels.segment_minplus.ref import padded_topk_ref

    rng = np.random.default_rng(c + f + k)
    cand = rng.integers(1, 7, size=(6, c, f)).astype(np.float32)
    cand[rng.random(cand.shape) > 0.7] = inf
    cand[0] = inf
    cand[1] = np.minimum(cand[1], 3)
    cand[2] = rng.random((c, f)).astype(np.float32) * 1000
    cand = torch.from_numpy(cand)
    plan = sm_ops.topk_wide_plan(c, f, k)
    assert torch.equal(emulate_wide_topk(cand, k, plan),
                       padded_topk_ref(cand, k))
