"""The port's padded-CSR DKS relax (``repro_torch.kernels.segment_minplus``)
against ``repro`` on the CPU, bit for bit: ``padded_topk``'s plain version
(what its wrapper runs on a CPU tensor) against the Pallas kernel in
interpret mode, the vectorized ``padded_csr_from_graph`` against
``repro``'s loop, and ``segment_minplus_padded`` against ``repro``'s and
against the port's edge-list ``relax``.  No tolerance: every value is a
min, a compare or one f32 add.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import INF
from repro.core import dks as dks_j
from repro.graph.generators import lod_like_graph as lod_j
from repro.graph.generators import random_weighted_graph as rwg_j
from repro.kernels.segment_minplus import ops as sm_j
from repro.kernels.segment_minplus.kernel import padded_topk as topk_pallas
from repro.kernels.segment_minplus.ref import padded_topk_ref as topk_ref_j

from repro_torch.core import dks as dks_t
from repro_torch.core.semiring import sorted_unique_k
from repro_torch.graph.generators import lod_like_graph as lod_t
from repro_torch.graph.generators import random_weighted_graph as rwg_t
from repro_torch.kernels.segment_minplus import ops as sm_t


def random_table(v, m, k, seed):
    """Sorted-unique, INF-padded lattice tables, the empty set all INF."""
    rng = np.random.default_rng(seed)
    s = rng.integers(1, 20, size=(v, 1 << m, k)).astype(np.float32)
    s[rng.random(s.shape) > 0.5] = INF
    s = sorted_unique_k(torch.from_numpy(s), k).numpy()
    s[:, 0, :] = INF
    return s


def directed_edges(g):
    """The symmetrized CSR as (src, dst, w) arrays, as
    ``tests/test_kernels.py`` feeds the builder."""
    deg = np.diff(g.indptr)
    return (np.repeat(np.arange(g.n_nodes), deg).astype(np.int32),
            g.indices.astype(np.int32), g.ew.astype(np.float32))


def assert_same_csr(got, want):
    for name in ("src_pad", "w_pad", "real_of"):
        a, b = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        np.testing.assert_array_equal(a, b, err_msg=name)
        assert a.dtype == b.dtype, name
    assert (got.dmax, got.n_virtual) == (want.dmax, want.n_virtual)


# --------------------------------------------------------------------------
# padded_topk
# --------------------------------------------------------------------------


@pytest.mark.parametrize("vv,c,f,k", [(8, 16, 4, 2), (16, 64, 16, 2),
                                      (8, 128, 16, 4), (24, 32, 8, 1),
                                      (8, 12, 32, 3)])
def test_padded_topk_plain_matches_pallas_and_ref(vv, c, f, k):
    """``tests/test_kernels.py``'s cases (and m = 5, K = 3), exactly."""
    rng = np.random.default_rng(vv + c)
    cand = rng.integers(1, 30, size=(vv, c, f)).astype(np.float32)
    cand[rng.random((vv, c, f)) > 0.6] = INF
    launched = sm_t.launches
    got = sm_t.padded_topk(torch.from_numpy(cand), k)
    assert sm_t.launches == launched
    assert got.shape == (vv, f, k)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(topk_pallas(jnp.asarray(cand), k, block_v=8,
                                            interpret=True)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(topk_ref_j(jnp.asarray(cand), k)))


def test_padded_topk_checks_inputs():
    cand = torch.full((8, 6, 4), INF)
    with pytest.raises(ValueError, match="k <= 8"):
        sm_t.padded_topk(torch.full((8, 12, 4), INF, device="meta"), 9)
    assert torch.equal(sm_t.padded_topk(cand, 5), torch.full((8, 4, 5), INF))
    with pytest.raises(ValueError, match="C >= k"):
        sm_t.padded_topk(cand[:, :2].contiguous(), 3)
    with pytest.raises(ValueError, match="f32"):
        sm_t.padded_topk(cand.double(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        sm_t.padded_topk(cand.transpose(1, 2), 2)
    assert torch.equal(sm_t.padded_topk(cand, 3), torch.full((8, 4, 3), INF))


# --------------------------------------------------------------------------
# padded_csr_from_graph
# --------------------------------------------------------------------------


def test_padded_csr_hub_split_equals_jax():
    """A node of in-degree 5 at dmax=2 takes ceil(5/2) = 3 rows."""
    src = np.asarray([1, 2, 3, 4, 5], np.int32)
    dst = np.zeros(5, np.int32)
    w = np.arange(1, 6, dtype=np.float32)
    got = sm_t.padded_csr_from_graph(src, dst, w, 6, dmax=2, device="cpu")
    assert_same_csr(got, sm_j.padded_csr_from_graph(src, dst, w, 6, dmax=2))
    assert int((got.real_of[:8] == 0).sum()) >= 3


@pytest.mark.parametrize("graph,dmax,pad_rows_to", [
    ("rwg", 8, 8), ("rwg", 3, 4), ("lod", 4, 8), ("lod", 64, 8),
    ("lod", 16, 1)])
def test_padded_csr_equals_jax(graph, dmax, pad_rows_to):
    if graph == "rwg":
        gj, gt = rwg_j(40, 120, seed=3), rwg_t(40, 120, seed=3)
    else:
        gj, gt = lod_j(300, 1500, seed=2, vocab=30)[0], \
            lod_t(300, 1500, seed=2, vocab=30)[0]
    args_j, args_t = directed_edges(gj), directed_edges(gt)
    for a, b in zip(args_j, args_t):
        np.testing.assert_array_equal(a, b)
    got = sm_t.padded_csr_from_graph(*args_t, gt.n_nodes, dmax=dmax,
                                     pad_rows_to=pad_rows_to, device="cpu")
    assert_same_csr(got, sm_j.padded_csr_from_graph(
        *args_j, gj.n_nodes, dmax=dmax, pad_rows_to=pad_rows_to))


def test_padded_csr_rejects_dst_outside_the_graph():
    with pytest.raises(ValueError, match="dst outside"):
        sm_t.padded_csr_from_graph(np.zeros(2, np.int32),
                                   np.asarray([0, 4], np.int32),
                                   np.ones(2, np.float32), 4, device="cpu")


# --------------------------------------------------------------------------
# segment_minplus_padded
# --------------------------------------------------------------------------


@pytest.mark.parametrize("m,k,dmax", [(3, 2, 8), (2, 3, 2), (4, 1, 64)])
def test_segment_minplus_padded_equals_jax_and_relax(m, k, dmax):
    """The full padded-CSR relax (gather, reduce, hub merge) equals
    ``repro``'s (Pallas interpret) and the port's edge-list ``relax``."""
    gj, gt = rwg_j(40, 120, seed=3), rwg_t(40, 120, seed=3)
    dj, dt = gj.to_device(), gt.to_device(device="cpu")
    rng = np.random.default_rng(m * 10 + k)
    S = random_table(dt.v_pad, m, k, seed=11 + m)
    changed = rng.random(dt.v_pad) > 0.3
    csr_j = sm_j.padded_csr_from_graph(*directed_edges(gj), gj.n_nodes,
                                       dmax=dmax)
    csr_t = sm_t.padded_csr_from_graph(*directed_edges(gt), gt.n_nodes,
                                       dmax=dmax, device="cpu")
    got = sm_t.segment_minplus_padded(torch.from_numpy(S), csr_t,
                                      torch.from_numpy(changed), k, dt.v_pad)
    want = sm_j.segment_minplus_padded(jnp.asarray(S), csr_j,
                                       jnp.asarray(changed), k, dj.v_pad,
                                       interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    relax = dks_t.relax(dt, torch.from_numpy(S)[None],
                        torch.from_numpy(changed)[None],
                        dks_t.DKSConfig(m=m, k=k))[0]
    np.testing.assert_array_equal(got.numpy(), relax.numpy())
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(dks_j.relax(dj, jnp.asarray(S),
                                            jnp.asarray(changed),
                                            dks_j.DKSConfig(m=m, k=k))))
    assert bool((got < INF).any()) and bool((got == INF).any())


def test_segment_minplus_padded_checks_k():
    csr = sm_t.padded_csr_from_graph(np.zeros(1, np.int32),
                                     np.ones(1, np.int32),
                                     np.ones(1, np.float32), 2, device="cpu")
    with pytest.raises(ValueError, match="wants S"):
        sm_t.segment_minplus_padded(torch.full((2, 4, 2), INF), csr,
                                    torch.ones(2, dtype=torch.bool), 3, 2)
