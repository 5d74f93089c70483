"""Port parity, lane driver: the host loop of ``repro_torch.core.driver``
ends in the same state as ``repro.core.driver.run_lanes`` (one jitted
``lax.while_loop``), every field bit for bit, for 1 lane and for 3 lanes
that finish at different supersteps, on both port backends."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import dks as dks_j
from repro.core import driver as drv_j
from repro.graph.generators import lod_like_graph as lod_j

from repro_torch import interop
from repro_torch.core import dks as dks_t
from repro_torch.core import driver as drv_t
from repro_torch.graph.generators import lod_like_graph as lod_t


@pytest.fixture(scope="module")
def graphs():
    gj, _ = lod_j(150, 500, seed=21, vocab=30)
    gt, _ = lod_t(150, 500, seed=21, vocab=30)
    return gj.to_device(), gt.to_device(device="cpu")


def ragged_masks(n_nodes, v_pad, n_lanes, m, seed):
    """Lanes with 1..3 keyword nodes per keyword: different frontiers, so
    lanes prove their exits at different supersteps."""
    rng = np.random.default_rng(seed)
    masks = np.zeros((n_lanes, m, v_pad), bool)
    for lane in range(n_lanes):
        for kw in range(m):
            masks[lane, kw, rng.choice(n_nodes, 1 + (lane + kw) % 3,
                                       replace=False)] = True
    return masks


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("n_lanes", [1, 3])
def test_run_lanes_matches_reference(graphs, backend, n_lanes):
    dj, dt = graphs
    masks = ragged_masks(dt.n_nodes, dt.v_pad, n_lanes, m=3, seed=n_lanes)
    cfg_j = dks_j.DKSConfig(m=3, k=2, max_supersteps=24)
    cfg_t = dks_t.DKSConfig(m=3, k=2, max_supersteps=24, backend=backend)
    want = drv_j.run_lanes(dj, jnp.asarray(masks), cfg_j)
    got = drv_t.run_lanes(dt, torch.from_numpy(masks), cfg_t)
    got_np = interop.state_to_numpy(got)
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(got_np[f.name],
                                      np.asarray(getattr(want, f.name)),
                                      err_msg=f.name)
    assert got_np["done"].all()
    if n_lanes > 1:  # a ragged finish: frozen lanes kept their counters
        assert len(set(got_np["step"].tolist())) > 1


def test_finished_lane_does_not_drift_at_one_lane(graphs):
    """Even at one lane the port freezes a finished lane: stepping it
    leaves every field, counters included, as it was."""
    _, dt = graphs
    masks = ragged_masks(dt.n_nodes, dt.v_pad, 1, m=2, seed=0)
    for backend in ("torch", "cuda"):
        cfg = dks_t.DKSConfig(m=2, k=1, backend=backend)
        st = drv_t.run_lanes(dt, torch.from_numpy(masks), cfg)
        again = drv_t.lane_superstep(dt, st, cfg)
        for name, arr in interop.state_to_numpy(st).items():
            np.testing.assert_array_equal(
                interop.state_to_numpy(again)[name], arr, err_msg=name)


def test_state_interop_round_trip(graphs):
    dj, _ = graphs
    masks = ragged_masks(dj.n_nodes, dj.v_pad, 2, m=2, seed=5)
    st = drv_j.lane_init(dj, jnp.asarray(masks),
                         dks_j.DKSConfig(m=2, k=2))
    fields = {f.name: np.asarray(getattr(st, f.name))
              for f in dataclasses.fields(st)}
    back = interop.state_to_numpy(interop.state_from_numpy(fields, "cpu"))
    for name, arr in fields.items():
        np.testing.assert_array_equal(back[name], arr)
        assert back[name].dtype == arr.dtype
    with pytest.raises(ValueError, match="missing"):
        interop.state_from_numpy({"S": fields["S"]}, "cpu")
