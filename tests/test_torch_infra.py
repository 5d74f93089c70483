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
