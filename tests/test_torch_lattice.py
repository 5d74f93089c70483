"""Port parity, lattice and SPA: the torch semiring and bound functions
are bit-identical to ``repro.core.semiring`` / ``repro.core.spa`` on the
kinds of inputs of ``tests/test_semiring_props.py`` (integer values,
K = 1..4, m = 2..5), including empty segments."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import INF
from repro.core import semiring as sr_j
from repro.core import spa as spa_j

from repro_torch.core import semiring as sr_t
from repro_torch.core import spa as spa_t


def same(a_jax, b_torch):
    a, b = np.asarray(a_jax), b_torch.numpy()
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def sorted_vecs(rng, shape, k):
    """Sorted-unique INF-padded K-vectors built from 1..30 integer lists
    (the ``vals``/``to_vec`` strategy of test_semiring_props)."""
    raw = rng.integers(1, 31, size=(*shape, 12)).astype(np.float32)
    raw[rng.random(raw.shape) < 0.3] = INF
    return np.array(sr_j.sorted_unique_k(jnp.asarray(raw), k))


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_sorted_unique_merge_outer_identical(k):
    rng = np.random.default_rng(k)
    raw = rng.integers(1, 31, size=(64, 12)).astype(np.float32)
    raw[:5] = INF                                      # all-INF rows
    same(sr_j.sorted_unique_k(jnp.asarray(raw), k),
         sr_t.sorted_unique_k(torch.from_numpy(raw), k))
    a, b = sorted_vecs(rng, (64,), k), sorted_vecs(rng, (64,), k)
    ja, jb, ta, tb = (jnp.asarray(a), jnp.asarray(b), torch.from_numpy(a),
                      torch.from_numpy(b))
    same(sr_j.topk_merge(ja, jb), sr_t.topk_merge(ta, tb))
    same(sr_j.topk_merge(ja, ja), sr_t.topk_merge(ta, ta))   # idempotent
    same(sr_j.outer_combine(ja, jb), sr_t.outer_combine(ta, tb))
    big = np.full_like(a, INF - 3)                      # saturation at INF
    same(sr_j.outer_combine(jnp.asarray(big), jb),
         sr_t.outer_combine(torch.from_numpy(big), tb))


@pytest.mark.parametrize("seed", range(4))
def test_segment_topk_min_identical_with_empty_segments(seed):
    rng = np.random.default_rng(seed)
    n, v, k = int(rng.integers(5, 40)), int(rng.integers(2, 10)), 1 + seed
    vals = rng.integers(1, 50, (n, 3)).astype(np.float32)
    seg = rng.integers(0, v, n).astype(np.int32)
    n_seg = v + 3                       # the last three segments are empty
    got = sr_t.segment_topk_min(torch.from_numpy(vals),
                                torch.from_numpy(seg), n_seg, k)
    same(sr_j.segment_topk_min(jnp.asarray(vals), jnp.asarray(seg), n_seg, k),
         got)
    assert torch.all(got[v:] == INF)


def test_bump_to_inf_identical():
    x = np.asarray([0.0, 1.0, 4.99e8, 5e8, 7e8, INF, 2 * INF], np.float32)
    same(sr_j.bump_to_inf(jnp.asarray(x)), sr_t.bump_to_inf(torch.from_numpy(x)))


def test_split_pairs_and_submasks_identical():
    for m in range(1, 7):
        assert spa_t.split_pairs(m) == spa_j.split_pairs(m)
    for u in range(1, 64):
        assert spa_t.submasks(u) == spa_j.submasks(u)


@pytest.mark.parametrize("m", [2, 3, 4, 5])
def test_nu_and_spa_cover_identical(m):
    rng = np.random.default_rng(m)
    g = rng.integers(1, 20, (6, 1 << m)).astype(np.float32)
    g[:, 0] = INF
    g[rng.random(g.shape) < 0.3] = INF
    e_min = np.float32(1.0)
    # The port takes a leading lane axis; repro is per lane.
    nu_t = spa_t.nu_lower_bound(torch.from_numpy(g), torch.tensor(e_min), m)
    cover_t = spa_t.spa_cover_dp(torch.from_numpy(g), m)
    for lane in range(g.shape[0]):
        same(spa_j.nu_lower_bound(jnp.asarray(g[lane]), jnp.float32(e_min), m),
             nu_t[lane])
        same(spa_j.spa_cover_dp(jnp.asarray(g[lane]), m), cover_t[lane])


@pytest.mark.parametrize("best,spa", [
    (7.0, 5.0), (5.0, 7.0), (INF, 3.0), (4.0, 0.0), (4.0, INF), (9.0, 3.0)])
def test_spa_ratio_identical(best, spa):
    got = spa_t.spa_ratio(torch.tensor(best, dtype=torch.float32), spa)
    same(spa_j.spa_ratio(jnp.float32(best), spa), got)
