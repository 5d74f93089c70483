"""The port's recsys serving path (``repro_torch.models.recsys``, the
EmbeddingBag wrapper, ``repro_torch.data``) against ``repro`` on the CPU.

Inputs are made with numpy from fixed seeds and handed to both packages;
parameters come across with ``interop.dcn_params_from_numpy``.  On the CPU
the EmbeddingBag wrapper runs its plain version; ``repro``'s Pallas kernel
runs in interpret mode.  Tolerance: 1e-5 (``tests/test_kernels.py``'s for
the bag; f32 matrix products sum in another order in the two frameworks);
none for the table lookups, which are exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_arch as get_arch_j
from repro.configs.base import RECSYS_SHAPES as RECSYS_SHAPES_J
from repro.data import recsys_synthetic_stream as stream_j
from repro.kernels.embedding_bag.ops import embedding_bag as eb_pallas
from repro.kernels.embedding_bag.ref import embedding_bag_ref as eb_ref_j
from repro.models import recsys as rec_j

from repro_torch import interop
from repro_torch.configs import DCN_V2, RECSYS_SHAPES, get_arch
from repro_torch.data import recsys_synthetic_stream as stream_t
from repro_torch.kernels.embedding_bag import ops as eb_ops
from repro_torch.launch import serve
from repro_torch.models import recsys as rec_t

TOL = 1e-5
CFG_J = get_arch_j("dcn-v2").config.smoke()
CFG_T = DCN_V2.smoke()


@pytest.fixture(scope="module")
def smoke_params():
    """``repro``'s smoke init_dcn(PRNGKey(0)) and the same values in the
    port."""
    params_j = rec_j.init_dcn(jax.random.PRNGKey(0), CFG_J)
    params_np = jax.tree_util.tree_map(np.asarray, params_j)
    return params_j, interop.dcn_params_from_numpy(params_np, CFG_T,
                                                   device="cpu"), params_np


def batch(bsz, seed):
    b = next(stream_t(CFG_T, bsz, seed=seed))
    return b["dense"], b["sparse"]


def close(got_t, want_j):
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_j), atol=TOL,
                               rtol=TOL)


# --------------------------------------------------------------------------
# configs and data
# --------------------------------------------------------------------------


def test_dcn_v2_config_and_shapes_equal_jax():
    want = get_arch_j("dcn-v2").config
    assert get_arch("dcn-v2") is DCN_V2
    assert dataclasses.asdict(DCN_V2) == dataclasses.asdict(want)
    assert dataclasses.asdict(DCN_V2.smoke()) == dataclasses.asdict(
        want.smoke())
    assert [dataclasses.asdict(s) for s in RECSYS_SHAPES] == [
        dataclasses.asdict(s) for s in RECSYS_SHAPES_J]


def test_lm_server_rejects_the_recsys_arch():
    with pytest.raises(SystemExit, match="LM archs"):
        serve.main(["--arch", "dcn-v2", "--device", "cpu"])


@pytest.mark.parametrize("cfg_name,bsz,kw", [
    ("smoke", 64, {}),
    ("smoke", 33, {"seed": 3, "shard_id": 1, "n_shards": 2, "skip": 5}),
    ("full", 256, {"seed": 0}),
])
def test_stream_equals_jax_batch_for_batch(cfg_name, bsz, kw):
    cfg_t = CFG_T if cfg_name == "smoke" else DCN_V2
    cfg_j = CFG_J if cfg_name == "smoke" else get_arch_j("dcn-v2").config
    it_t, it_j = stream_t(cfg_t, bsz, **kw), stream_j(cfg_j, bsz, **kw)
    for _ in range(3):
        got, want = next(it_t), next(it_j)
        assert sorted(got) == sorted(want)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
            assert got[name].dtype == want[name].dtype, name


def test_batch_to_device():
    b = next(stream_t(CFG_T, 8))
    got = rec_t.batch_to_device(b, device="cpu")
    assert got["sparse"].dtype == torch.int32
    np.testing.assert_array_equal(got["dense"].numpy(), b["dense"])


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------


def test_full_param_shapes_equal_jax_eval_shape():
    """The full dcn-v2 tree (26 tables, ~29.5 M rows), shapes only."""
    cfg_j = get_arch_j("dcn-v2").config
    want = jax.eval_shape(lambda k: rec_j.init_dcn(k, cfg_j),
                          jax.random.PRNGKey(0))
    got = rec_t.param_shapes(DCN_V2)
    want_shapes = jax.tree_util.tree_map(lambda s: tuple(s.shape), want)
    assert got == want_shapes
    rows = sum(s[0] for s in got["tables"].values())
    assert rows == 29_497_558 and got["tables"]["table_0"] == (10_000_384, 16)


def test_init_dcn_matches_shapes_and_distribution():
    cfg = dataclasses.replace(CFG_T, embed_dim=64, mlp_dims=(256, 128))
    params = rec_t.init_dcn(cfg, torch.Generator("cpu").manual_seed(0))
    shapes = rec_t.param_shapes(cfg)
    assert {n: tuple(t.shape) for n, t in params["tables"].items()} == \
        shapes["tables"]
    assert [tuple(lw["w"].shape) for lw in params["deep"]] == \
        [s["w"] for s in shapes["deep"]]
    tables = torch.cat([t.flatten() for t in params["tables"].values()])
    assert abs(tables.std().item() - 0.02) < 1e-3
    d0 = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
    assert abs(params["cross"][0]["w"].std().item() - d0 ** -0.5) < 2e-3
    assert tables.dtype == torch.float32
    again = rec_t.init_dcn(cfg, torch.Generator("cpu").manual_seed(0))
    assert torch.equal(again["item"], params["item"])


def test_dcn_params_from_numpy_checks_the_tree(smoke_params):
    params_np = jax.tree_util.tree_map(lambda a: a, smoke_params[2])
    params_np["deep"][1]["w"] = params_np["deep"][1]["w"][:, :3]
    with pytest.raises(ValueError, match=r"deep\[1\]\.w has shape"):
        interop.dcn_params_from_numpy(params_np, CFG_T, device="cpu")
    params_np["deep"] = params_np["deep"][:1]
    with pytest.raises(ValueError, match="deep has 1 layers"):
        interop.dcn_params_from_numpy(params_np, CFG_T, device="cpu")


# --------------------------------------------------------------------------
# the serving path
# --------------------------------------------------------------------------


def test_features_through_embedding_bag_equal_jnp_take(smoke_params):
    """Both impls (one grouped lookup; a bag of one id per field) equal
    ``jnp.take`` on the clipped id exactly, ids below 0 and past the table
    included."""
    params_j, params_t, _ = smoke_params
    dense, sparse = batch(40, seed=1)
    sparse[:5, 0] = -7
    sparse[5:9, 25] = 10_000
    launched = eb_ops.launches
    for impl in rec_t.IMPLS:
        got = rec_t._features(params_t, torch.from_numpy(dense),
                              torch.from_numpy(sparse), CFG_T, impl)
        want = rec_j._features(params_j, jnp.asarray(dense),
                               jnp.asarray(sparse), CFG_J)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert eb_ops.launches == launched   # the CPU path launches nothing


@pytest.mark.parametrize("bsz", [1, 257])
def test_features_of_one_and_of_odd_batches_equal_jax(smoke_params, bsz):
    """B = 1 and a B that is no multiple of the kernel's 256-thread block,
    ids below 0 and past every table: both impls equal ``repro``'s
    ``_features`` exactly."""
    params_j, params_t, _ = smoke_params
    dense, sparse = batch(bsz, seed=bsz)
    rng = np.random.default_rng(bsz)
    hit = rng.random(sparse.shape) < 0.2
    sparse[hit] = rng.choice([-1, -(2 ** 31), 10 ** 6, 2 ** 31 - 1],
                             size=int(hit.sum()))
    want = np.asarray(rec_j._features(params_j, jnp.asarray(dense),
                                      jnp.asarray(sparse), CFG_J))
    for impl in rec_t.IMPLS:
        got = rec_t._features(params_t, torch.from_numpy(dense),
                              torch.from_numpy(sparse), CFG_T, impl)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("impl", rec_t.IMPLS)
@pytest.mark.parametrize("bsz,seed", [(16, 0), (37, 4)])
def test_dcn_forward_and_user_vector_match_jax(smoke_params, impl, bsz,
                                               seed):
    params_j, params_t, _ = smoke_params
    dense, sparse = batch(bsz, seed)
    dj, sj = jnp.asarray(dense), jnp.asarray(sparse)
    dt, st = torch.from_numpy(dense), torch.from_numpy(sparse)
    logits = rec_t.dcn_forward(params_t, dt, st, CFG_T, impl=impl)
    assert logits.shape == (bsz,)
    close(logits, rec_j.dcn_forward(params_j, dj, sj, CFG_J))
    close(rec_t.user_vector(params_t, dt, st, CFG_T, impl=impl),
          rec_j.user_vector(params_j, dj, sj, CFG_J))


@pytest.mark.parametrize("impl", rec_t.IMPLS)
@pytest.mark.parametrize("n_cand,top_k,dup", [(64, 8, False), (300, 20, True),
                                              (50, 50, True)])
def test_retrieval_scores_match_jax(smoke_params, impl, n_cand, top_k, dup):
    """Scores within 1e-5, candidate positions equal; with ``dup`` every
    candidate id appears several times, so equal scores must come back in
    ``lax.top_k``'s order (the lower position first)."""
    params_j, params_t, _ = smoke_params
    dense, sparse = batch(1, seed=n_cand)
    rng = np.random.default_rng(n_cand)
    hi = 12 if dup else CFG_T.vocab_sizes[0] + 20
    cand = rng.integers(-3, hi, n_cand).astype(np.int32)
    scores, idx = rec_t.retrieval_scores(
        params_t, torch.from_numpy(dense), torch.from_numpy(sparse),
        torch.from_numpy(cand), CFG_T, top_k=top_k, impl=impl)
    want_s, want_i = rec_j.retrieval_scores(
        params_j, jnp.asarray(dense), jnp.asarray(sparse), jnp.asarray(cand),
        CFG_J, top_k=top_k)
    assert scores.shape == (1, top_k) and idx.shape == (1, top_k)
    close(scores, want_s)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    if dup:
        ties = scores[0, 1:] == scores[0, :-1]
        assert bool(ties.any())
        assert bool((idx[0, 1:][ties] > idx[0, :-1][ties]).all())


def tie_candidates(n_cand: int) -> np.ndarray:
    """int32[n_cand]: every id at least twice (from 2 on), drawn from ids
    the clip folds together (below 0 with 0, past the vocabulary with its
    last row) and a few in between, shuffled."""
    vocab = CFG_T.vocab_sizes[0]
    rng = np.random.default_rng(500 + n_cand)
    pool = np.array([-7, -1, 0, 1, 3, 5, vocab - 1, vocab, vocab + 11,
                     2 ** 31 - 1, -(2 ** 31)], np.int32)
    base = rng.choice(pool, size=max(1, n_cand // 2))
    return rng.permutation(np.resize(base, n_cand)).astype(np.int32)


@pytest.mark.parametrize("n_cand", range(1, 81))
def test_retrieval_ties_are_bit_equal(smoke_params, n_cand):
    """All ``n_cand`` candidates ranked: equal ids after the clip score
    bit-equal wherever they sit (a host GEMM sums its tail columns in
    another order than its body, so the product alone does not tie
    them), and the positions are ``repro``'s: equal scores, the lower
    position first."""
    params_j, params_t, _ = smoke_params
    dense, sparse = batch(1, seed=3)
    cand = tie_candidates(n_cand)
    scores, idx = rec_t.retrieval_scores(
        params_t, torch.from_numpy(dense), torch.from_numpy(sparse),
        torch.from_numpy(cand), CFG_T, top_k=n_cand)
    want_s, want_i = rec_j.retrieval_scores(
        params_j, jnp.asarray(dense), jnp.asarray(sparse), jnp.asarray(cand),
        CFG_J, top_k=n_cand)
    close(scores, want_s)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_i))
    at = np.empty(n_cand, np.float32)
    at[idx.numpy()[0]] = scores.numpy()[0]
    clipped = np.clip(cand, 0, CFG_T.vocab_sizes[0] - 1)
    for i in np.unique(clipped):
        same = at[clipped == i]
        assert (same.view(np.int32) == same[0].view(np.int32)).all(), i


def test_first_of_id_points_at_the_lowest_position():
    ids = torch.tensor([5, 3, 5, 0, 3, 9, 5], dtype=torch.int32)
    assert rec_t._first_of_id(ids).tolist() == [0, 1, 0, 3, 1, 5, 0]
    assert rec_t._first_of_id(ids[:0]).numel() == 0
    meta = rec_t._first_of_id(torch.empty(7, dtype=torch.int32,
                                          device="meta"))
    assert meta.shape == (7,) and meta.is_meta


def test_recsys_embedding_bag_rejects_unknown_impl():
    with pytest.raises(ValueError, match="impl must be one of"):
        rec_t.embedding_bag(torch.zeros(4, 2), torch.zeros(1, 1, dtype=torch.int32),
                            impl="pallas")


# --------------------------------------------------------------------------
# the EmbeddingBag kernel's plain version
# --------------------------------------------------------------------------


@pytest.mark.parametrize("b,nnz,v,d,mode", [
    (8, 4, 100, 16, "sum"), (16, 8, 1000, 32, "mean"),
    (5, 3, 50, 8, "sum"),   # non-multiple batch (padding path)
    (7, 24, 300, 128, "mean"), (1, 1, 10, 16, "sum"),
])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_plain_matches_pallas_and_ref(b, nnz, v, d, mode,
                                                    weighted):
    """``tests/test_kernels.py``'s cases, weighted and not, within 1e-5."""
    rng = np.random.default_rng(b * nnz)
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = rng.integers(-1, v, size=(b, nnz)).astype(np.int32)
    ids[0] = -1                                    # an all-pad bag
    w = rng.normal(size=(b, nnz)).astype(np.float32) if weighted else None
    wj = None if w is None else jnp.asarray(w)
    wt = None if w is None else torch.from_numpy(w)
    launched = eb_ops.launches
    got = eb_ops.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                               wt, mode=mode)
    assert eb_ops.launches == launched
    want = eb_pallas(jnp.asarray(table), jnp.asarray(ids), wj, mode=mode,
                     interpret=True)
    close(got, want)
    close(got, eb_ref_j(jnp.asarray(table), jnp.asarray(ids), wj, mode=mode))
    assert not got[0].any()


def test_embedding_bag_weights_exact():
    table = torch.eye(4)
    got = eb_ops.embedding_bag(table, torch.tensor([[0, 1]], dtype=torch.int32),
                               torch.tensor([[2.0, 3.0]]))
    np.testing.assert_array_equal(got[0].numpy(), [2.0, 3.0, 0.0, 0.0])


def test_embedding_bag_ids_past_the_table_are_padding():
    """The port's choice for ids >= V (outside ``repro``'s contract):
    skipped like -1 and not counted by "mean"."""
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(size=(30, 8)).astype(np.float32))
    ids = torch.tensor([[3, 30, 7], [1000, -1, 29], [30, 31, -5]],
                       dtype=torch.int32)
    w = torch.from_numpy(rng.normal(size=(3, 3)).astype(np.float32))
    as_pad = torch.where(ids >= 30, -1, ids)
    for mode in ("sum", "mean"):
        assert torch.equal(eb_ops.embedding_bag(table, ids, w, mode),
                           eb_ops.embedding_bag(table, as_pad, w, mode))
    got = eb_ops.embedding_bag(table, ids, None, "mean")
    assert torch.equal(got[0], (table[3] + table[7]) / 2)
    assert torch.equal(got[1], table[29]) and not got[2].any()


def test_embedding_bag_checks_inputs():
    table = torch.zeros(10, 4)
    ids = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="supports float32"):
        eb_ops.embedding_bag(table.double(), ids)
    with pytest.raises(ValueError, match="int32 ids"):
        eb_ops.embedding_bag(table, ids.long())
    with pytest.raises(ValueError, match="mode"):
        eb_ops.embedding_bag(table, ids, mode="max")
    with pytest.raises(ValueError, match="weights"):
        eb_ops.embedding_bag(table, ids, torch.ones(2, 2))
    with pytest.raises(ValueError, match="contiguous"):
        eb_ops.embedding_bag(torch.zeros(4, 10).T, ids)
    assert eb_ops.embedding_bag(table, ids[:0]).shape == (0, 4)
    assert not eb_ops.embedding_bag(table, ids[:, :0]).any()


# --------------------------------------------------------------------------
# the grouped lookup's plain version
# --------------------------------------------------------------------------


def grouped_case(bsz, n_fields, d, seed):
    """Tables of assorted row counts, ids past both ends of each."""
    rng = np.random.default_rng(seed)
    tables = [torch.from_numpy(rng.normal(size=(int(rows), d)).astype(
        np.float32)) for rows in rng.integers(1, 60, n_fields)]
    ids = np.stack([rng.integers(-5, t.shape[0] + 5, bsz)
                    for t in tables], axis=1).astype(np.int32)
    return tables, torch.from_numpy(ids)


@pytest.mark.parametrize("bsz", [1, 37, 300])
@pytest.mark.parametrize("n_fields", [1, 3, 26])
def test_grouped_lookup_equals_per_field_lookups(bsz, n_fields):
    """``clip=True`` into x0-shaped columns (col0 = 13, ld = 13 + F*D + 3)
    equals one ``_lookup`` (a clipped bag of one id) per field and a
    ``torch.cat``, exactly; the columns around them are left alone."""
    d = 16
    tables, ids = grouped_case(bsz, n_fields, d, seed=bsz + n_fields)
    out = torch.full((bsz, 13 + n_fields * d + 3), 7.0)
    launched = eb_ops.launches
    got = eb_ops.embedding_bag_grouped(tables, ids, out, col0=13, clip=True)
    assert got is out and eb_ops.launches == launched
    want = torch.cat([rec_t._lookup(t, ids[:, i], "torch")
                      for i, t in enumerate(tables)], dim=-1)
    assert torch.equal(out[:, 13:13 + n_fields * d], want)
    assert bool((out[:, :13] == 7.0).all() and (out[:, -3:] == 7.0).all())
    single = rec_t._lookup(tables[0], ids[:, 0], "cuda")
    assert torch.equal(single, want[:, :d])


def test_grouped_lookup_copies_the_prefix():
    """A prefix fills the first col0 columns in the same call: x0 =
    [dense | fields], as ``torch.cat`` builds it."""
    tables, ids = grouped_case(37, 3, 16, seed=5)
    dense = torch.from_numpy(np.random.default_rng(5).normal(
        size=(37, 13)).astype(np.float32))
    got = eb_ops.embedding_bag_grouped(tables, ids, torch.empty(37, 61), 13,
                                       clip=True, prefix=dense)
    want = torch.cat([dense] + [rec_t._lookup(t, ids[:, i], "torch")
                                for i, t in enumerate(tables)], dim=-1)
    assert torch.equal(got, want)


def test_grouped_lookup_without_clip_pads_with_zeros():
    tables, ids = grouped_case(50, 4, 12, seed=9)
    out = eb_ops.embedding_bag_grouped(tables, ids, torch.full((50, 48), 3.0))
    for f, t in enumerate(tables):
        cols = out[:, f * 12:(f + 1) * 12]
        valid = (ids[:, f] >= 0) & (ids[:, f] < t.shape[0])
        assert bool(valid.any() and (~valid).any())
        assert torch.equal(cols[valid], t[ids[valid, f].long()])
        assert not cols[~valid].any()


def test_grouped_lookup_checks_inputs():
    tables = [torch.zeros(5, 4), torch.zeros(7, 4)]
    ids = torch.zeros(3, 2, dtype=torch.int32)
    out = torch.zeros(3, 10)
    with pytest.raises(ValueError, match="one table per field"):
        eb_ops.embedding_bag_grouped(tables[:1], ids, out)
    with pytest.raises(ValueError, match="1 to 64 fields"):
        eb_ops.embedding_bag_grouped([tables[0]] * 65,
                                     torch.zeros(3, 65, dtype=torch.int32),
                                     torch.zeros(3, 300))
    with pytest.raises(ValueError, match="one D"):
        eb_ops.embedding_bag_grouped([tables[0], torch.zeros(7, 3)], ids, out)
    with pytest.raises(ValueError, match="int32 ids"):
        eb_ops.embedding_bag_grouped(tables, ids.long(), out)
    with pytest.raises(ValueError, match="float32"):
        eb_ops.embedding_bag_grouped(tables, ids, out.double())
    with pytest.raises(ValueError, match="do not fit"):
        eb_ops.embedding_bag_grouped(tables, ids, out, col0=3)
    with pytest.raises(ValueError, match="prefix"):
        eb_ops.embedding_bag_grouped(tables, ids, out, col0=2,
                                     prefix=torch.zeros(3, 3))
    with pytest.raises(ValueError, match="needs every table"):
        eb_ops.embedding_bag_grouped([tables[0], torch.zeros(0, 4)], ids, out,
                                     clip=True)
    with pytest.raises(ValueError, match="contiguous"):
        eb_ops.embedding_bag_grouped(tables, ids, torch.zeros(10, 3).T)
    got = eb_ops.embedding_bag_grouped([tables[0], torch.zeros(0, 4)],
                                       ids, torch.ones(3, 8))
    assert torch.equal(got[:, 4:], torch.zeros(3, 4))
