"""The port's CUDA kernels against their plain torch versions, on the card.

This file imports neither JAX nor ``repro``, so it runs on a machine with a
GPU and PyTorch alone:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Without a card every test here skips (through the ``cuda_device``
fixture, decided when the test runs).  Tolerance: none — every lattice
value is a min, a compare or one f32 add.
"""

import numpy as np
import pytest
import torch

from repro_torch import INF
from repro_torch.core import dks, driver
from repro_torch.core.semiring import sorted_unique_k
from repro_torch.graph.generators import lod_like_graph
from repro_torch.kernels.lane_superstep import ops as ls_ops
from repro_torch.kernels.lane_superstep.ref import fused_lane_step_ref
from repro_torch.kernels.subset_combine import ops as sc_ops
from repro_torch.kernels.subset_combine.ref import subset_combine_ref


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs the same checks "
                    "on the H100)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k", [(1, 3), (2, 1), (3, 3), (4, 4), (5, 2)])
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
@pytest.mark.parametrize("m,k", [(1, 2), (3, 3), (5, 4)])
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
