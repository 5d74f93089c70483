"""Port parity, kernels: each CUDA kernel's plain torch version (what its
wrapper runs on a CPU tensor) is bit-identical to the Pallas kernel run in
interpret mode and to ``repro``'s jnp reference.  The CUDA kernels
themselves need a card: ``tests/test_torch_cuda.py`` and ``chip_smoke.py``
hold them against the plain versions there.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import INF
from repro.core import dks as dks_j
from repro.core import driver as drv_j
from repro.core.semiring import sorted_unique_k
from repro.graph.generators import lod_like_graph as lod_j
from repro.kernels.lane_superstep import (fused_lane_superstep as fused_j,
                                          lane_csr_from_device_graph)
from repro.kernels.subset_combine.ops import subset_combine as sc_pallas
from repro.kernels.subset_combine.ref import subset_combine_ref as sc_ref_j

from repro_torch import interop
from repro_torch.core import dks as dks_t
from repro_torch.core import driver as drv_t
from repro_torch.graph.generators import lod_like_graph as lod_t
from repro_torch.kernels.lane_superstep import ops as ls_ops
from repro_torch.kernels.lane_superstep.ref import fused_lane_step_ref
from repro_torch.kernels.subset_combine import ops as sc_ops


def random_table(v, m, k, seed):
    """tests/test_kernels.py's lattice tables: sorted-unique, INF-padded,
    empty set all INF."""
    rng = np.random.default_rng(seed)
    s = rng.integers(1, 20, size=(v, 1 << m, k)).astype(np.float32)
    s[rng.random((v, 1 << m, k)) > 0.5] = INF
    s = np.array(sorted_unique_k(jnp.asarray(s), k))
    s[:, 0, :] = INF
    return s


def state_fields(st):
    return {f.name: np.asarray(getattr(st, f.name))
            for f in dataclasses.fields(st)}


def assert_same_state(st_j, st_t):
    got = interop.state_to_numpy(st_t)
    for name, want in state_fields(st_j).items():
        np.testing.assert_array_equal(got[name], want, err_msg=name)
        assert got[name].dtype == want.dtype, name


# --------------------------------------------------------------------------
# subset_combine
# --------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,v", [(2, 1, 8), (2, 2, 32), (3, 2, 8),
                                   (4, 2, 64), (4, 4, 16), (5, 2, 8)])
def test_subset_combine_plain_matches_pallas_and_ref(m, k, v):
    s = random_table(v, m, k, seed=m * 100 + k)
    got = sc_ops.subset_combine(torch.from_numpy(s), m)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(sc_pallas(jnp.asarray(s), m, interpret=True,
                                          block_v=8)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(sc_ref_j(jnp.asarray(s), m)))
    # One sweep == the torch backend's ceil(log2 m)-pass closure.
    cfg = dks_t.DKSConfig(m=m, k=k)
    np.testing.assert_array_equal(
        got.numpy(), dks_t.combine(torch.from_numpy(s), cfg).numpy())


def test_subset_combine_takes_lane_axis_and_checks_inputs():
    launched = sc_ops.launches
    s = np.stack([random_table(8, 3, 2, seed=s) for s in range(3)])
    got = sc_ops.subset_combine(torch.from_numpy(s), 3)
    for lane in range(3):
        np.testing.assert_array_equal(
            got[lane].numpy(), np.asarray(sc_ref_j(jnp.asarray(s[lane]), 3)))
    # Past rows of 2^m * k = 16,384 floats (64 KB, one row in a block's
    # shared memory) a tensor off the CPU is refused before any launch;
    # (7, 3) and (3, 10), past the templated route, pass the check (on
    # the card the wide route takes them); the plain version takes any.
    for shape, m in (((4, 2048, 9), 11), ((4, 8, 2049), 3),
                     ((4, 1024, 17), 10)):
        with pytest.raises(ValueError, match=r"2\^m \* k <= 16384"):
            sc_ops.subset_combine(torch.full(shape, INF, device="meta"), m)
    for shape, m in (((4, 128, 3), 7), ((4, 8, 10), 3), ((4, 1024, 16), 10)):
        assert sc_ops.subset_combine(
            torch.full(shape, INF, device="meta"), m).shape == shape
    wide = np.stack([random_table(8, 6, 2, seed=s) for s in range(2)])
    np.testing.assert_array_equal(
        sc_ops.subset_combine(torch.from_numpy(wide), 6)[1].numpy(),
        np.asarray(sc_ref_j(jnp.asarray(wide[1]), 6)))
    with pytest.raises(ValueError, match="contiguous"):
        sc_ops.subset_combine(torch.from_numpy(s).transpose(0, 1), 3)
    assert sc_ops.launches == launched  # the CPU path launches nothing


# --------------------------------------------------------------------------
# lane_superstep
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def hub_graphs():
    """One dense-ish graph in both packages: hubs split over several
    LaneCSR rows with dmax=4 on the reference side."""
    gj, _ = lod_j(200, 900, seed=3, vocab=40)
    gt, _ = lod_t(200, 900, seed=3, vocab=40)
    dj = gj.to_device()
    dt = gt.to_device(device="cpu")
    return dj, lane_csr_from_device_graph(dj, dmax=4), dt


def lane_state(dj, m, k, n_lanes, seed, steps=1):
    """A multi-lane mid-run reference state and the same state carried to
    the port through interop."""
    cfg = dks_j.DKSConfig(m=m, k=k, max_supersteps=8)
    rng = np.random.default_rng(seed)
    masks = np.zeros((n_lanes, m, dj.v_pad), bool)
    for lane in range(n_lanes):
        for kw in range(m):
            masks[lane, kw, rng.choice(dj.n_nodes, 4, replace=False)] = True
    st = jax.jit(drv_j.lane_init, static_argnums=2)(dj, jnp.asarray(masks),
                                                    cfg)
    for _ in range(steps):
        st = vmapped_superstep(dj, st, cfg)
    return st, interop.state_from_numpy(state_fields(st), device="cpu")


@functools.partial(jax.jit, static_argnums=2)
def vmapped_superstep(dj, st, cfg):
    """``repro``'s dense superstep vmapped over lanes, compiled."""
    return jax.vmap(lambda x: dks_j.superstep(dj, x, cfg))(st)


def test_lane_superstep_plain_matches_pallas_and_vmapped(hub_graphs):
    dj, csr, dt = hub_graphs
    m, k = 3, 2
    st_j, st_t = lane_state(dj, m, k, n_lanes=3, seed=m)
    cfg_j = dks_j.DKSConfig(m=m, k=k, max_supersteps=8)
    cfg_p = dataclasses.replace(cfg_j, relax_impl="pallas",
                                combine_impl="pallas")
    cfg_t = dks_t.DKSConfig(m=m, k=k, max_supersteps=8, backend="cuda")
    got = ls_ops.fused_lane_superstep(dt, st_t, cfg_t)
    assert_same_state(fused_j(dj, csr, st_j, cfg_p, interpret=True), got)
    want = vmapped_superstep(dj, st_j, cfg_j)
    assert_same_state(want, got)
    assert_same_state(want, dks_t.superstep(dt, st_t, dataclasses.replace(
        cfg_t, backend="torch")))


def test_lane_superstep_frozen_lane_matches_reference_driver(hub_graphs):
    dj, csr, dt = hub_graphs
    st_j, _ = lane_state(dj, 2, 2, n_lanes=3, seed=7)
    st_j = dataclasses.replace(st_j, done=jnp.asarray([True, False, False]))
    st_t = interop.state_from_numpy(state_fields(st_j), device="cpu")
    cfg_p = dks_j.DKSConfig(m=2, k=2, max_supersteps=8, relax_impl="pallas",
                            combine_impl="pallas")
    cfg_t = dks_t.DKSConfig(m=2, k=2, max_supersteps=8, backend="cuda")
    want = drv_j.lane_superstep(dj, st_j, cfg_p, csr=csr)
    got = drv_t.lane_superstep(dt, st_t, cfg_t)
    assert_same_state(want, got)
    # The frozen lane comes out untouched, counters included.
    for name, before in state_fields(st_j).items():
        np.testing.assert_array_equal(
            interop.state_to_numpy(got)[name][0], before[0], err_msg=name)
    S1 = ls_ops.fused_lane_step(st_t.S, st_t.changed, st_t.done,
                                dt.in_offsets, dt.src, dt.w, 2)
    assert torch.equal(S1[0], st_t.S[0])
    assert not torch.equal(S1[1], st_t.S[1])


def test_lane_step_checks_inputs(hub_graphs):
    _, _, dt = hub_graphs
    off = dt.in_offsets
    launched = ls_ops.launches
    S = torch.full((2, dt.v_pad, 4, 2), INF)
    changed = torch.zeros(2, dt.v_pad, dtype=torch.bool)
    done = torch.zeros(2, dtype=torch.bool)
    meta = [t.to("meta") for t in (changed, done, off, dt.src, dt.w)]
    # Past 2^m * k = 16,384 floats a row, refused before any launch;
    # (7, 3) and (3, 10) pass the check.
    with pytest.raises(ValueError, match=r"2\^m \* k <= 16384"):
        ls_ops.fused_lane_step(
            torch.full((2, dt.v_pad, 2048, 9), INF, device="meta"), *meta,
            11, dt.hub_nodes.to("meta"))
    with pytest.raises(ValueError, match=r"2\^m \* k <= 16384"):
        ls_ops.fused_lane_step(
            torch.full((2, dt.v_pad, 4, 4097), INF, device="meta"), *meta, 2,
            dt.hub_nodes.to("meta"))
    for m, k in ((7, 3), (3, 10)):
        assert ls_ops.fused_lane_step(
            torch.full((2, dt.v_pad, 1 << m, k), INF, device="meta"), *meta,
            m, dt.hub_nodes.to("meta")).shape == (2, dt.v_pad, 1 << m, k)
    wide = ls_ops.fused_lane_step(torch.full((2, dt.v_pad, 64, 5), INF),
                                  changed, done, off, dt.src, dt.w, 6)
    assert torch.equal(wide, torch.full((2, dt.v_pad, 64, 5), INF))
    with pytest.raises(ValueError, match="offsets"):
        ls_ops.fused_lane_step(S, changed, done, off.int(), dt.src, dt.w, 2)
    with pytest.raises(ValueError, match="changed"):
        ls_ops.fused_lane_step(S, changed[:1], done, off, dt.src, dt.w, 2)
    ls_ops.fused_lane_step(S, changed, done, off, dt.src, dt.w, 2)
    assert ls_ops.launches == launched  # the CPU path launches nothing


@pytest.mark.parametrize("m,k", [(1, 2), (3, 3)])
def test_lane_step_with_hub_list_matches_plain_and_vmapped(m, k):
    """A graph with 422 nodes past the hub threshold (in-degrees 31, 32,
    33 and up to 980, INF-weight edges among them): the wrapper given
    ``DeviceGraph.hub_nodes`` equals its plain version, and the lane
    superstep built on it equals ``repro``'s jnp one, a frozen lane
    included."""
    gj, _ = lod_j(3000, 40000, seed=1, vocab=40, tau=300)
    gt, _ = lod_t(3000, 40000, seed=1, vocab=40, tau=300)
    dj, dt = gj.to_device(), gt.to_device(device="cpu")
    assert dt.hub_nodes.numel() == 422
    st_j, st_t = lane_state(dj, m, k, n_lanes=3, seed=m, steps=2)
    done = torch.tensor([True, False, False])
    args = (st_t.S, st_t.changed, done, dt.in_offsets, dt.src, dt.w)
    S1 = ls_ops.fused_lane_step(*args, m, dt.hub_nodes)
    assert torch.equal(S1, fused_lane_step_ref(*args, m))
    assert torch.equal(S1[0], st_t.S[0])
    st_j = dataclasses.replace(st_j, done=jnp.asarray([True, False, False]))
    st_t = dataclasses.replace(st_t, done=done)
    cfg_j = dks_j.DKSConfig(m=m, k=k, max_supersteps=8)
    cfg_t = dks_t.DKSConfig(m=m, k=k, max_supersteps=8, backend="cuda")
    assert_same_state(drv_j.lane_superstep(dj, st_j, cfg_j),
                      drv_t.lane_superstep(dt, st_t, cfg_t))


def test_lane_step_checks_the_hub_list(hub_graphs):
    _, _, dt = hub_graphs
    S = torch.full((2, dt.v_pad, 4, 2), INF)
    changed = torch.zeros(2, dt.v_pad, dtype=torch.bool)
    done = torch.zeros(2, dtype=torch.bool)
    args = (S, changed, done, dt.in_offsets, dt.src, dt.w, 2)
    for bad in (dt.hub_nodes.long(), dt.hub_nodes[None]):
        with pytest.raises(ValueError, match="hubs"):
            ls_ops.fused_lane_step(*args, bad)
    # Omitted, the list is the one of the offsets given.
    assert torch.equal(ls_ops.fused_lane_step(*args),
                       ls_ops.fused_lane_step(*args, dt.hub_nodes))


@pytest.mark.parametrize("m,k", [(3, 10), (7, 3)])
def test_wide_lane_step_checks_the_hub_list(hub_graphs, m, k):
    """Past the templated range the kernel takes the hub list too (its
    leading entries get hub blocks): a list of the wrong dtype, shape or
    device raises before any launch, on the CPU as on the card."""
    _, _, dt = hub_graphs
    S = torch.full((2, dt.v_pad, 1 << m, k), INF)
    changed = torch.zeros(2, dt.v_pad, dtype=torch.bool)
    done = torch.zeros(2, dtype=torch.bool)
    args = (S, changed, done, dt.in_offsets, dt.src, dt.w, m)
    launched = ls_ops.launches_by_route
    for bad in (dt.hub_nodes.long(), dt.hub_nodes[None],
                dt.hub_nodes.float()):
        with pytest.raises(ValueError, match="hubs must be"):
            ls_ops.fused_lane_step(*args, bad)
    with pytest.raises(ValueError, match="hubs is on meta"):
        ls_ops.fused_lane_step(*args, dt.hub_nodes.to("meta"))
    meta = [t.to("meta") for t in (S, changed, done, dt.in_offsets, dt.src,
                                   dt.w)]
    with pytest.raises(ValueError, match="hubs is on cpu"):
        ls_ops.fused_lane_step(*meta, m, dt.hub_nodes)
    assert ls_ops.fused_lane_step(*meta, m, dt.hub_nodes.to("meta")).shape \
        == S.shape
    assert torch.equal(ls_ops.fused_lane_step(*args),
                       ls_ops.fused_lane_step(*args, dt.hub_nodes))
    assert ls_ops.launches_by_route == launched  # the CPU launches nothing
