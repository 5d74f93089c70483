"""The port's CUDA kernels against their plain torch versions, on the card.

This file imports neither JAX nor ``repro``, so it runs on a machine with a
GPU and PyTorch alone:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Without a card every test here skips (through the ``cuda_device``
fixture, decided when the test runs).  Tolerance: none for the DKS
kernels — every lattice value is a min, a compare or one f32 add; 2e-5
(f32) and 2e-2 (bf16) for flash attention, the JAX package's own
(``tests/test_kernels.py``), since its sums run in another order.
"""

import numpy as np
import pytest
import torch

from repro_torch import INF
from repro_torch.configs import get_arch
from repro_torch.core import dks, driver
from repro_torch.core.semiring import sorted_unique_k
from repro_torch.graph.generators import lod_like_graph
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.lane_superstep import ops as ls_ops
from repro_torch.kernels.lane_superstep.ref import fused_lane_step_ref
from repro_torch.kernels.subset_combine import ops as sc_ops
from repro_torch.kernels.subset_combine.ref import subset_combine_ref
from repro_torch.models import lm as lm_lib
from repro_torch.models import transformer as tfm


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
    got = fa_ops.flash_attention(q, k, v, q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa_ops.launches == launched + 1
    want = attention_ref(q, k, v, q_offset=q_offset)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["chatglm3-6b", "qwen1.5-4b"])
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
