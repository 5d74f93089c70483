"""The port's training infrastructure (``repro_torch.checkpoint``,
``repro_torch.distributed.fault``, ``repro_torch.data``): the twins of
``tests/test_infra.py``'s checkpoint, fault, stream and prefetch tests,
and checkpoints carried across the two packages in both directions, every
leaf bit-equal (bf16 included: both store its 16-bit pattern).
"""

import functools
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.checkpoint import restore_tree as restore_tree_j
from repro.checkpoint import save_tree as save_tree_j
from repro.configs import get_arch as get_arch_j
from repro.data import lm_synthetic_stream as lm_stream_j
from repro.models import lm as lm_j
from repro.models import transformer as tfm_j

from repro_torch import interop
from repro_torch.checkpoint import (Checkpointer, Stacked, latest_step,
                                    restore_tree, save_tree)
from repro_torch.configs import get_arch
from repro_torch.data import PrefetchIterator, lm_synthetic_stream
from repro_torch.distributed.fault import StepGuard, StragglerPolicy
from repro_torch.models import lm as lm_t
from repro_torch.optim import tree_leaves


def tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.bfloat16),
                  "s": Stacked(torch.full((2,), float(i)) for i in range(3))},
            "step": 7}


def same(a, b):
    if isinstance(a, Stacked):
        assert len(a.parts) == len(b.parts)
        for x, y in zip(a.parts, b.parts):
            same(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def test_checkpoint_roundtrip(tmp_path):
    t = tree()
    save_tree(t, tmp_path, step=3)
    assert latest_step(tmp_path) == 3
    out = restore_tree(t, tmp_path, 3)
    for a, b in zip(tree_leaves(t), tree_leaves(out)):
        same(a, b)
    meta = json.loads((tmp_path / "step_3" / "manifest.json").read_text())
    assert meta["dtypes"] == ["float32", "bfloat16", "float32", "int32"]
    assert meta["shapes"] == [[3, 4], [5], [3, 2], []]


def test_checkpoint_restores_onto_a_device_from_a_meta_template(tmp_path):
    t = tree()
    save_tree(t, tmp_path, step=1)
    template = {"a": torch.empty(3, 4, device="meta"),
                "b": {"c": torch.empty(5, dtype=torch.bfloat16, device="meta"),
                      "s": Stacked(torch.empty(2, device="meta")
                                   for _ in range(3))},
                "step": 0}
    out = restore_tree(template, tmp_path, 1, device="cpu")
    for a, b in zip(tree_leaves(t), tree_leaves(out)):
        same(a, b)


def test_checkpoint_torn_write_ignored(tmp_path):
    t = tree()
    save_tree(t, tmp_path, step=1)
    # A crash mid-save: a directory without _COMMITTED.
    bad = tmp_path / "step_2"
    bad.mkdir()
    (bad / "manifest.json").write_text("{}")
    assert latest_step(tmp_path) == 1


def test_checkpoint_async_and_retention(tmp_path):
    ck = Checkpointer(tmp_path, keep=2, async_save=True)
    t = tree()
    for s in (1, 2, 3, 4):
        ck.save(t, s)
    ck.wait()
    assert ck.latest() == 4
    steps = sorted(int(d.name.split("_")[1]) for d in tmp_path.iterdir()
                   if d.name.startswith("step_"))
    assert steps == [3, 4]
    out, step = ck.restore(t)
    assert step == 4
    for a, b in zip(tree_leaves(t), tree_leaves(out)):
        same(a, b)


def test_checkpoint_async_save_error_raised_by_wait(tmp_path):
    (tmp_path / "file").write_text("")
    ck = Checkpointer(tmp_path / "file", keep=2, async_save=True)
    ck.save(tree(), 1)
    with pytest.raises(OSError):
        ck.wait()


@pytest.mark.parametrize("bad", [
    {"a": torch.zeros(4, 4)},
    {"b": {"c": torch.ones(5, dtype=torch.bfloat16),
           "s": Stacked(torch.zeros(2) for _ in range(4))}},
    {"extra": torch.zeros(1)},
])
def test_checkpoint_shape_mismatch_rejected(tmp_path, bad):
    t = tree()
    save_tree(t, tmp_path, step=1)
    with pytest.raises(ValueError):
        restore_tree({**t, **bad}, tmp_path, 1)


def test_step_guard_retries_transient_failure():
    calls = {"n": 0}

    def flaky_step(state, batch):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("simulated preemption")
        return state + batch, {"loss": torch.tensor(1.0)}

    guard = StepGuard(max_retries=2)
    new_state, aux, info = guard.run(flaky_step, torch.tensor(1.0),
                                     torch.tensor(2.0))
    assert float(new_state) == 3.0
    assert info["retries"] == 1
    assert ("retry", "RuntimeError('simulated preemption')") in guard.events


def test_step_guard_gives_up():
    def dead_step(state, batch):
        raise RuntimeError("hard fault")

    guard = StepGuard(max_retries=1)
    with pytest.raises(RuntimeError):
        guard.run(dead_step, torch.tensor(0.0), torch.tensor(0.0))


def test_straggler_policy_flags_slow_steps():
    p = StragglerPolicy(threshold=2.0, patience=2)
    assert not p.observe(1.0)
    assert not p.observe(1.1)
    assert p.observe(5.0)
    assert not p.should_escalate
    assert p.observe(5.0)
    assert p.should_escalate


def test_lm_stream_deterministic_resumable_and_equal_to_jax():
    a = list(zip(range(3), lm_synthetic_stream(100, 2, 8, seed=1)))
    b = list(zip(range(3), lm_stream_j(100, 2, 8, seed=1)))
    for (_, x), (_, y) in zip(a, b):
        for key in ("tokens", "labels"):
            assert x[key].dtype == y[key].dtype == np.int32
            np.testing.assert_array_equal(x[key], y[key])
    # skip resumes mid-stream
    c = next(lm_synthetic_stream(100, 2, 8, seed=1, skip=2))
    np.testing.assert_array_equal(a[2][1]["tokens"], c["tokens"])


def test_streams_shard_disjoint():
    x = next(lm_synthetic_stream(1000, 4, 16, seed=3, shard_id=0, n_shards=2))
    y = next(lm_synthetic_stream(1000, 4, 16, seed=3, shard_id=1, n_shards=2))
    assert not np.array_equal(x["tokens"], y["tokens"])
    np.testing.assert_array_equal(
        y["tokens"], next(lm_stream_j(1000, 4, 16, seed=3, shard_id=1,
                                      n_shards=2))["tokens"])


def test_prefetch_iterator():
    it = PrefetchIterator(iter(range(5)), depth=2)
    assert list(it) == [0, 1, 2, 3, 4]


def test_prefetch_propagates_errors():
    def gen():
        yield 1
        raise ValueError("boom")

    it = PrefetchIterator(gen())
    assert next(it) == 1
    with pytest.raises(ValueError):
        for _ in it:
            pass


# --------------------------------------------------------------------------
# checkpoints across the packages
# --------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def repro_state(arch, seed):
    """``repro``'s bf16 smoke TrainState after one step, so that the
    moments and the count are not zeros (JAX arrays: immutable, shared)."""
    cfg = get_arch_j(arch).config.smoke()
    jb = tfm_j.build(cfg, tp=1)
    state = lm_j.init_train_state(jax.random.PRNGKey(seed), jb)
    batch = {k: jnp.asarray(v) for k, v in
             next(lm_stream_j(cfg.vocab, 2, 8, seed=seed)).items()}
    state, _ = jax.jit(lm_j.make_train_step(jb, lm_j.AdamWConfig(),
                                            attn_impl="naive"))(state, batch)
    return state


def bits(x) -> np.ndarray:
    """An array's raw bytes (bf16 through its 16-bit view)."""
    arr = np.asarray(x)
    return arr.view(np.uint16) if arr.dtype.name == "bfloat16" else arr


def port_bits(leaf) -> np.ndarray:
    if isinstance(leaf, Stacked):
        return np.stack([port_bits(p) for p in leaf.parts])
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf, np.int32)


@pytest.mark.parametrize("arch", ["chatglm3-6b", "granite-moe-3b-a800m"])
def test_port_checkpoint_restores_bit_equal_in_repro(tmp_path, arch):
    state_j = repro_state(arch, seed=1)
    cfg = get_arch(arch).smoke()
    state = interop.train_state_from_numpy(
        [np.asarray(x) for x in jax.tree_util.tree_leaves(state_j)], cfg,
        device="cpu")
    assert state.model.embed.dtype == torch.bfloat16
    assert state.opt.mu["embed"].dtype == torch.float32
    save_tree(lm_t.train_state_tree(state), tmp_path, step=1)
    template = lm_j.init_train_state(
        jax.random.PRNGKey(9), tfm_j.build(get_arch_j(arch).config.smoke()))
    back = restore_tree_j(template, tmp_path, 1)
    got = jax.tree_util.tree_leaves(back)
    want = jax.tree_util.tree_leaves(state_j)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(bits(g), bits(w))


@pytest.mark.parametrize("arch", ["chatglm3-6b", "granite-moe-3b-a800m"])
def test_repro_checkpoint_restores_bit_equal_in_the_port(tmp_path, arch):
    state_j = repro_state(arch, seed=1)
    save_tree_j(state_j, tmp_path, step=5)
    cfg = get_arch(arch).smoke()
    tree = restore_tree(lm_t.train_state_template(cfg), tmp_path, 5,
                        device="cpu")
    state = lm_t.train_state_from_tree(cfg, tree)
    assert state.step == 1 and int(state.opt.count) == 1
    assert all(p.requires_grad for p in state.model.parameters())
    got = tree_leaves(lm_t.train_state_tree(state))
    want = jax.tree_util.tree_leaves(state_j)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(port_bits(g), bits(w))
    # The restored model trains on.
    step = lm_t.make_train_step(lm_t.AdamWConfig(), attn_impl="naive")
    batch = {k: torch.from_numpy(v)
             for k, v in next(lm_synthetic_stream(cfg.vocab, 2, 8)).items()}
    state, metrics = step(state, batch)
    assert state.step == 2 and torch.isfinite(metrics["loss"])


# --------------------------------------------------------------------------
# checkpoints on a mesh, across the packages
# --------------------------------------------------------------------------
#
# ChatGLM3's bf16 smoke config at tp=2 on a (data 1, model 2) mesh: its
# train state cut by ``repro``'s ``_lm_state_specs`` (the port's
# ``lm_state_specs``), the moments drawn at random so that no leaf is
# zeros.  ``repro`` shards its state over 2 forced host devices and saves
# it; 2 gloo ranks restore it by the spec tree, and save the port's state
# from their slices; ``repro`` restores that with ``shardings=``.

CKPT_ARCH, CKPT_MESH, CKPT_AXES = "chatglm3-6b", (1, 2), ("data", "model")

REPRO_CKPT = """
    from repro.checkpoint import restore_tree, save_tree
    from repro.configs import get_arch
    from repro.launch.cells import _lm_state_specs
    from repro.launch.mesh import sharding_tree
    from repro.models import lm
    from repro.models import transformer as tfm
    from repro.optim import OptState
    from repro.shardmap import make_mesh
    b = tfm.build(get_arch(ARCH).config.smoke(), tp=2)
    sh = sharding_tree(make_mesh(MESH, AXES), _lm_state_specs(b))
    if MODE == "save":
        state = lm.init_train_state(jax.random.PRNGKey(1), b)
        keys = iter(jax.random.split(jax.random.PRNGKey(2), 4096))
        rnd = lambda t: jax.tree_util.tree_map(
            lambda p: jax.random.normal(next(keys), p.shape, jnp.float32), t)
        state = lm.TrainState(params=state.params, opt=OptState(
            mu=rnd(state.opt.mu), nu=rnd(state.opt.nu),
            count=jnp.int32(3)), step=jnp.int32(3))
        state = jax.device_put(state, sh)
        save_tree(state, DIR, 3)
        leaves = jax.tree_util.tree_leaves(state)
    else:
        template = lm.init_train_state(jax.random.PRNGKey(9), b)
        leaves = jax.tree_util.tree_leaves(restore_tree(template, DIR, 4,
                                                        shardings=sh))
    want = jax.tree_util.tree_leaves(sh)
    arrays = [np.asarray(x) for x in leaves]
    np.savez(OUT, *[a.view(np.uint16) if a.dtype.name == "bfloat16" else a
                    for a in arrays])
    out = {"sharded": [x.sharding == s for x, s in zip(leaves, want)],
           "split": sum(len(x.sharding.device_set) > 1 and
                        x.sharding.shard_shape(x.shape) != x.shape
                        for x in leaves)}
"""


def _ckpt_model():
    from repro_torch.models import transformer as tfm

    return tfm.build(get_arch(CKPT_ARCH).smoke(), CKPT_MESH[1])


def _port_state_tree(b) -> list:
    """The port's whole train state at ``b``, its moments at random."""
    from repro_torch.models import transformer as tfm

    state = lm_t.init_train_state(tfm.init_lm(
        b, torch.Generator().manual_seed(4)))
    gen = torch.Generator().manual_seed(5)
    for moments in (state.opt.mu, state.opt.nu):
        for t in moments.values():
            t.copy_(torch.randn(t.shape, generator=gen))
    state.opt.count = torch.tensor(4, dtype=torch.int32)
    state.step = 4
    return lm_t.train_state_tree(state)


def _slice(leaf, spec, mesh):
    """This rank's slice of a whole leaf (a :class:`Stacked` by its
    stack)."""
    from repro_torch.distributed import comm

    if isinstance(leaf, Stacked):
        return Stacked(comm.shard(torch.stack(leaf.parts), spec,
                                  mesh).unbind(0))
    if isinstance(leaf, torch.Tensor):
        return comm.shard(leaf, spec, mesh)
    return leaf


def _ckpt_ranks(device, dir_a, dir_b):
    """Restore ``repro``'s checkpoint onto this rank's slices; save the
    port's state from them."""
    from repro_torch.distributed import comm
    from repro_torch.launch.mesh import lm_state_specs
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import tree_map

    torch.set_num_threads(1)
    mesh = comm.Mesh(CKPT_MESH, CKPT_AXES, "cpu")
    b = _ckpt_model()
    specs = lm_state_specs(b)
    template = lm_t.train_state_tree(lm_t.init_train_state(
        tfm.LM(b, device="meta", mesh=mesh)))
    got = restore_tree(template, dir_a, 3, device="cpu", specs=specs,
                       mesh=mesh)
    local = tree_map(lambda leaf, spec: _slice(leaf, spec, mesh),
                     _port_state_tree(b), specs)
    path = save_tree(local, dir_b, 4, specs=specs, mesh=mesh)
    return {"rank": comm.rank(), "committed": (path / "_COMMITTED").exists(),
            "restored": [port_bits(leaf) for leaf in tree_leaves(got)]}


def test_checkpoints_cross_the_packages_on_a_mesh(tmp_path):
    """Both directions at 2 gloo ranks: each rank's restored slice of
    ``repro``'s sharded save equals that slice of the saved leaf, bit for
    bit; ``repro``'s ``restore_tree(shardings=)`` of the port's mesh save
    equals the port's whole state, bit for bit, bf16 leaves included."""
    import textwrap

    from tests.test_distributed import run_in_subprocess

    from repro_torch.distributed import comm
    from repro_torch.distributed.ranks import run_ranks
    from repro_torch.launch.mesh import lm_state_specs
    from repro_torch.optim import tree_map

    def repro(mode, directory):
        out = run_in_subprocess(
            f"ARCH, MESH, AXES = {CKPT_ARCH!r}, {CKPT_MESH!r}, "
            f"{CKPT_AXES!r}\nMODE, DIR = {mode!r}, {str(directory)!r}\n"
            f"OUT = {str(tmp_path / (mode + '.npz'))!r}\n"
            + textwrap.dedent(REPRO_CKPT), devices=2)
        z = np.load(tmp_path / f"{mode}.npz")
        return out, [z[f"arr_{i}"] for i in range(len(z.files))]

    out, saved = repro("save", tmp_path / "a")
    assert all(out["sharded"]) and out["split"] > 0
    ranks = run_ranks(_ckpt_ranks, 2, tmp_path / "a", tmp_path / "b",
                      timeout_s=120, workdir=tmp_path)
    b = _ckpt_model()
    specs = [leaf for leaf in tree_leaves(
        tree_map(lambda _, s: s, _port_state_tree(b), lm_state_specs(b)),
        is_leaf=lambda x: isinstance(x, comm.PartitionSpec))]
    assert len(specs) == len(saved)
    for r in ranks:
        assert r["committed"]
        mesh = comm.CountingMesh(CKPT_MESH, CKPT_AXES, r["rank"])
        assert len(r["restored"]) == len(saved)
        for got, whole, spec in zip(r["restored"], saved, specs):
            want = comm.shard(torch.from_numpy(whole), spec, mesh).numpy()
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    out, back = repro("restore", tmp_path / "b")
    assert all(out["sharded"]) and out["split"] > 0
    want = [port_bits(leaf) for leaf in tree_leaves(_port_state_tree(b))]
    assert len(back) == len(want)
    for got, w in zip(back, want):
        assert got.dtype == w.dtype
        np.testing.assert_array_equal(got, w)
