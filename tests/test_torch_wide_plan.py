"""The DKS kernels' wide route, host side, on the CPU: the plan the
wrappers hand the wide kernels (``subset_combine.ops.wide_plan``) and the
hub entries ``lane_superstep``'s wide route gives blocks
(``lane_superstep.ops.wide_hub_entries``).

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

import pytest
import torch

from repro_torch.graph.generators import lod_like_graph
from repro_torch.graph.structure import HUB_IN_DEGREE
from repro_torch.kernels.lane_superstep import ops as ls_ops
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
