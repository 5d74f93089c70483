"""The port's mesh and collectives (``repro_torch.distributed.comm``,
``launch/mesh.py``) and the int8 ring all-reduce
(``repro_torch.distributed.compression``) across ranks on the CPU.

Ranks are processes over gloo, started by
``repro_torch.distributed.ranks.run_ranks`` (a rendezvous file under the
test's own temporary directory, never a fixed port; a time limit that
kills the ranks and fails the test).  Every collective and its backward
is held against its one-process definition, at 2 and 4 ranks, and
``reduce_scatter`` and the tiled ``all_gather``'s transpose against
``jax.lax.psum_scatter`` and JAX's VJP there too; the ring
against ``repro``'s at 8 ranks on ``repro``'s own inputs, run through
``tests.test_distributed.run_in_subprocess`` with 8 forced host devices.
Tolerance: none, but for sums over ranks (a psum, a transpose's
reduce-scatter), which gloo may add in another order than the definition
(1e-6 absolute on inputs of order 1).
"""

import inspect
import textwrap
import threading
import types

import numpy as np
import pytest
import torch

from tests.test_distributed import run_in_subprocess

from repro_torch.distributed import comm
from repro_torch.distributed import compression as comp
from repro_torch.distributed.ranks import run_ranks
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.mesh import P

RANKS_TIMEOUT_S = 120
WORLDS = (2, 4)
SHAPE = (4, 6, 3)


def rank_input(seed: int, rank: int, shape=SHAPE) -> torch.Tensor:
    return torch.randn(shape, generator=torch.Generator().manual_seed(
        1000 * seed + rank))


# -- the ranks' side ------------------------------------------------------

def _grad(fn, x, w):
    """(fn(x), d sum(fn(x) * w) / dx)."""
    x = x.clone().requires_grad_(True)
    out = fn(x)
    (g,) = torch.autograd.grad((out * w).sum(), x)
    return out.detach().numpy(), g.numpy()


def _collective_ranks(device, world):
    """Every collective on this rank, forward and backward."""
    r = comm.rank()
    line = comm.Mesh((world,), ("data",), "cpu")
    grid = comm.Mesh((2, world // 2), ("data", "model"), "cpu")
    x = rank_input(1, r)
    out = {"coords": grid.coords, "index": [
        grid.axis_index("data"), grid.axis_index("model"),
        grid.axis_index(), grid.axis_size(("data", "model"))]}
    out["gather_tiled"] = _grad(
        lambda t: comm.all_gather(t, "data", dim=1, tiled=True, mesh=line),
        x, rank_input(2, r, (4, 6 * world, 3)))
    out["gather_stacked"] = _grad(
        lambda t: comm.all_gather(t, "data", dim=0, mesh=line),
        x, rank_input(3, r, (world, *SHAPE)))
    out["all_to_all"] = _grad(
        lambda t: comm.all_to_all(t, "data", split_dim=0, concat_dim=2,
                                  mesh=line),
        x, rank_input(4, r, (4 // world, 6, 3 * world)))
    out["psum"] = _grad(lambda t: comm.psum(t, mesh=line), x,
                        rank_input(5, r))
    out["pmean"] = _grad(lambda t: comm.pmean(t, mesh=line), x,
                         rank_input(6, r))
    out["pmax"] = comm.pmax(x, mesh=line).numpy()
    out["pmin"] = comm.pmin(x, mesh=line).numpy()
    out["pmax_bool"] = comm.pmax(x[0, 0] > 0, mesh=line).numpy()
    shift = [(i, (i + 1) % world) for i in range(world)]
    out["shift"] = _grad(lambda t: comm.ppermute(t, "data", shift,
                                                 mesh=line),
                         x, rank_input(7, r))
    out["partial"] = _grad(
        lambda t: comm.ppermute(t, "data", [(0, world - 1)], mesh=line),
        x, rank_input(8, r))
    out["grid_gather"] = comm.all_gather(
        x, ("data", "model"), dim=0, tiled=True, mesh=grid).numpy()
    out["grid_psum_model"] = comm.psum(x, "model", mesh=grid).numpy()
    tree = {"a": rank_input(9, 0, (4, 6)), "b": [rank_input(10, 0, (8,))]}
    specs = {"a": P("model", "data"), "b": [P(("data", "model"))]}
    cut = mesh_lib.shard_tree(tree, specs, grid)
    back = mesh_lib.gather_tree(cut, specs, grid)
    out["tree"] = ({"a": cut["a"].numpy(), "b": cut["b"][0].numpy()},
                   all(torch.equal(u, v) for u, v in (
                       (back["a"], tree["a"]), (back["b"][0], tree["b"][0]))))
    refused = []
    for bad in (lambda: comm.ppermute(x, "data", [(0, 1), (1, 1)], mesh=line),
                lambda: comm.psum(x, ("model", "data"), mesh=grid),
                lambda: comm.psum(x, "pod", mesh=grid)):
        try:
            bad()
        except ValueError:
            refused.append(True)
    out["refused"] = len(refused)
    out["host_mesh"] = mesh_lib.make_host_mesh("cpu").shape
    try:
        mesh_lib.make_production_mesh(device_type="cpu")
    except ValueError:
        refused.append(True)
    out["refused"] = len(refused)
    with comm.mesh_scope(grid):
        out["ambient"] = comm.get_mesh() is grid
    out["outside"] = comm.get_mesh() is None
    out["backend"] = comm.backend()
    return out


def _ring_ranks(device, g_global, steps):
    """``repro``'s 8-way ring on its own inputs, then three steps of error
    feedback over a two-leaf tree."""
    mesh = comm.Mesh((comm.world_size(),), ("data",), "cpu")
    r = comm.rank()
    row = {"w": torch.from_numpy(g_global[r:r + 1])}
    red, state = comp.compressed_allreduce(row, comp.init_compression(row),
                                           mesh)
    out = {"ring": (red["w"].numpy(), state.error["w"].numpy()),
           "steps": []}
    state = None
    for step in steps:
        grads = {"a": torch.from_numpy(step["a"][r]),
                 "b": torch.from_numpy(step["b"][r])}
        state = state or comp.init_compression(grads)
        red, state = comp.compressed_allreduce(grads, state, mesh)
        out["steps"].append({k: (red[k].numpy(), state.error[k].numpy())
                             for k in red})
    return out


# -- fixtures ---------------------------------------------------------------

@pytest.fixture(scope="module")
def collective_runs(tmp_path_factory):
    return {world: run_ranks(_collective_ranks, world, world,
                             timeout_s=RANKS_TIMEOUT_S,
                             workdir=tmp_path_factory.mktemp(f"c{world}"))
            for world in WORLDS}


def feedback_steps(n, seed=7):
    """Three steps of per-rank gradients for a two-leaf tree."""
    rng = np.random.default_rng(seed)
    return [{"a": rng.normal(size=(n, 5, 7)).astype(np.float32),
             "b": (rng.normal(size=(n, 33)) * 3).astype(np.float32)}
            for _ in range(3)]


REPRO_RING = """
    from jax.sharding import PartitionSpec as P
    from repro import shardmap
    import repro.distributed.compression as comp
    mesh = shardmap.make_mesh((8,), ("data",))
    rng = np.random.default_rng(0)
    g_global = rng.normal(size=(8, 64)).astype(np.float32)

    def leaf(gl, el):
        x = gl.reshape(-1) + el.reshape(-1)
        pad = (-x.shape[0]) % 8
        xp = jnp.pad(x, (0, pad))
        red = comp._ring_allreduce_int8(xp, "data", 8)[: x.shape[0]]
        return red.reshape(gl.shape), (x - red).reshape(gl.shape)

    f = jax.jit(shardmap.shard_map(
        leaf, mesh=mesh, in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data")), check_vma=False))
    red, err = f(jnp.asarray(g_global), jnp.zeros_like(g_global))
    out = {"g": g_global.tolist(), "red": np.asarray(red).tolist(),
           "err": np.asarray(err).tolist(), "steps": []}
    errs = {k: None for k in STEP_SHAPES}
    for step in STEPS:
        row = {}
        for k in STEP_SHAPES:
            g = jnp.asarray(np.asarray(step[k], np.float32))
            e = errs[k] if errs[k] is not None else jnp.zeros_like(g)
            red, errs[k] = f(g, e)
            row[k] = [np.asarray(red).tolist(), np.asarray(errs[k]).tolist()]
        out["steps"].append(row)
"""


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    steps = feedback_steps(8)
    ref = run_in_subprocess(
        f"STEPS = {[{k: v.tolist() for k, v in s.items()} for s in steps]!r}"
        "\nSTEP_SHAPES = ('a', 'b')\n" + textwrap.dedent(REPRO_RING))
    g_global = np.asarray(ref["g"], np.float32)
    got = run_ranks(_ring_ranks, 8, g_global, steps,
                    timeout_s=RANKS_TIMEOUT_S,
                    workdir=tmp_path_factory.mktemp("ring"))
    return ref, got, steps


# -- reduce_scatter and all_gather's transpose against JAX -----------------

def scatter_inputs(world):
    """Per-rank x [2, 4 * world, 3] and the cotangents of its
    reduce-scatter and its tiled all-gather along dim 1, stacked over
    ranks."""
    rng = np.random.default_rng(world)
    draw = lambda *shape: rng.normal(size=(world, *shape)).astype(np.float32)
    return draw(2, 4 * world, 3), draw(2, 4, 3), draw(2, 4 * world * world, 3)


def _scatter_ranks(device, world):
    r = comm.rank()
    mesh = comm.Mesh((world,), ("data",), "cpu")
    x, ct_rs, ct_ag = (torch.from_numpy(a[r]) for a in scatter_inputs(world))
    y, g_rs = _grad(lambda t: comm.reduce_scatter(t, "data", dim=1,
                                                  mesh=mesh), x, ct_rs)
    z, g_ag = _grad(lambda t: comm.all_gather(t, "data", dim=1, tiled=True,
                                              mesh=mesh), x, ct_ag)
    comm.issued.clear()
    _grad(lambda t: comm.all_gather(t, "data", dim=1, tiled=True,
                                    mesh=mesh), x, ct_ag)
    return {"rs": (y, g_rs), "ag": (z, g_ag), "issued": dict(comm.issued)}


REPRO_SCATTER = """
    from jax.sharding import PartitionSpec as P
    from repro import shardmap

    def body(x, ct_rs, ct_ag):
        x, ct_rs, ct_ag = x[0], ct_rs[0], ct_ag[0]
        rs = lambda t: jax.lax.psum_scatter(t, "data", scatter_dimension=1,
                                            tiled=True)
        ag = lambda t: jax.lax.all_gather(t, "data", axis=1, tiled=True)
        y, vjp_rs = jax.vjp(rs, x)
        z, vjp_ag = jax.vjp(ag, x)
        return (y[None], vjp_rs(ct_rs)[0][None], z[None],
                vjp_ag(ct_ag)[0][None])

    out = {}
    for world in (2, 4):
        mesh = shardmap.make_mesh((world,), ("data",))
        f = jax.jit(shardmap.shard_map(
            body, mesh=mesh, in_specs=(P("data"),) * 3,
            out_specs=(P("data"),) * 4, check_vma=False))
        out[str(world)] = [np.asarray(a).tolist()
                           for a in f(*map(jnp.asarray,
                                           scatter_inputs(world)))]
"""


@pytest.fixture(scope="module")
def scatter_runs(tmp_path_factory):
    ref = run_in_subprocess(
        textwrap.dedent(inspect.getsource(scatter_inputs))
        + textwrap.dedent(REPRO_SCATTER))
    got = {world: run_ranks(_scatter_ranks, world, world,
                            timeout_s=RANKS_TIMEOUT_S,
                            workdir=tmp_path_factory.mktemp(f"s{world}"))
           for world in WORLDS}
    return ref, got


@pytest.mark.parametrize("world", WORLDS)
def test_reduce_scatter_and_all_gather_transpose_match_jax(scatter_runs,
                                                           world):
    """``comm.reduce_scatter`` against ``jax.lax.psum_scatter(...,
    tiled=True)`` and its VJP, and the tiled ``all_gather``'s VJP, now
    that reduce-scatter: the gathers and the 2-rank sums exactly (a sum
    of two f32 numbers is the same in either order), the 4-rank sums
    within 1e-6 of the largest magnitude (gloo and XLA may add the four
    in another order).  The all-gather's backward issues one
    reduce-scatter and no all-reduce."""
    ref, got = scatter_runs
    y_j, g_rs_j, z_j, g_ag_j = (np.asarray(a, np.float32)
                                for a in ref[str(world)])
    sum_tol = 0.0 if world == 2 else 1e-6
    for r, out in enumerate(got[world]):
        (y, g_rs), (z, g_ag) = out["rs"], out["ag"]
        np.testing.assert_allclose(
            y, y_j[r], rtol=0, atol=sum_tol * np.abs(y_j).max())
        np.testing.assert_array_equal(g_rs, g_rs_j[r])
        np.testing.assert_array_equal(z, z_j[r])
        np.testing.assert_allclose(
            g_ag, g_ag_j[r], rtol=0, atol=sum_tol * np.abs(g_ag_j).max())
        assert out["issued"] == {"all_gather": 1, "reduce_scatter": 1}


# -- the one-process definitions -------------------------------------------

def inputs(seed, world, shape=SHAPE):
    return [rank_input(seed, r, shape) for r in range(world)]


def test_no_group_no_mesh():
    assert not comm.is_initialized()
    assert comm.get_mesh() is None
    assert comm.world_size() == 1 and comm.rank() == 0
    assert comm.backend_for("cpu", 4) == "gloo"
    assert comm.STAGED_OPS == ("ppermute",)
    with pytest.raises(RuntimeError, match="process group"):
        comm.Mesh((1,), ("data",), "cpu")


def test_failed_init_raises_and_leaves_no_group(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="card"):
            comm.init(0, 1, f"file://{tmp_path}/rdv", device_type="cuda")
    with pytest.raises((ValueError, RuntimeError)):
        comm.init(0, 1, "nowhere://at-all", device_type="cpu")
    assert not comm.is_initialized()


@pytest.mark.parametrize("local_world, cards, want", [
    (8, 8, "nccl"),     # 16 ranks over 2 hosts of 8 cards: a card each
    (2, 1, "gloo"),     # 2 ranks sharing 1 card
    (1, 0, "gloo"),     # no card on the host
])
def test_backend_from_the_ranks_of_a_host(local_world, cards, want):
    assert comm.backend_for("cuda", local_world, cards=cards) == want
    assert comm.backend_for("cpu", local_world, cards=cards) == "gloo"


@pytest.mark.parametrize("env, cards, want", [
    # rank 9 of 16, the second of 8 on its host: its host's card 1
    ({"RANK": "9", "WORLD_SIZE": "16", "LOCAL_RANK": "1",
      "LOCAL_WORLD_SIZE": "8"}, 8, ("nccl", 1)),
    # rank 1 of 2 on a host of one card: both ranks on card 0
    ({"RANK": "1", "WORLD_SIZE": "2", "LOCAL_RANK": "1",
      "LOCAL_WORLD_SIZE": "2"}, 1, ("gloo", 0)),
])
def test_init_from_env_places_by_the_host(monkeypatch, env, cards, want):
    joined = {}

    def join(backend, **kwargs):
        joined.update(kwargs, backend=backend)

    def channel(backend, timeout):   # the control channel init makes
        joined["channel"] = (backend, timeout.total_seconds())

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device", lambda device: None)
    monkeypatch.setattr(comm.dist, "init_process_group", join)
    monkeypatch.setattr(comm.dist, "new_group", channel)
    for name, value in {**env, "MASTER_ADDR": "localhost",
                        "MASTER_PORT": "29500"}.items():
        monkeypatch.setenv(name, value)
    device = comm.init_from_env("cuda")
    backend, card = want
    assert device == torch.device("cuda", card)
    assert joined["backend"] == backend
    assert (joined["rank"], joined["world_size"]) == (
        int(env["RANK"]), int(env["WORLD_SIZE"]))
    assert joined.get("device_id") == (device if backend == "nccl" else None)
    assert joined["channel"] == ("gloo", comm.CHANNEL_TIMEOUT_S)
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    with pytest.raises(RuntimeError, match="LOCAL_WORLD_SIZE"):
        comm.init_from_env("cuda")


def test_one_rank_collectives_through_the_group(tmp_path):
    """At world size 1 a collective is elided unless run inside
    ``through_group``; there each one reaches the group, and :data:`issued`
    counts it."""
    comm.init(0, 1, f"file://{tmp_path}/rdv", device_type="cpu")
    try:
        mesh = comm.Mesh((1,), ("data",), "cpu")
        x = rank_input(1, 0).requires_grad_(True)
        comm.issued.clear()
        comm.psum(x, mesh=mesh)
        comm.all_gather(x, dim=1, tiled=True, mesh=mesh)
        assert sum(comm.issued.values()) == 0
        with comm.through_group():
            y = comm.all_gather(x, dim=1, tiled=True, mesh=mesh)
            z = comm.all_to_all(y, split_dim=0, concat_dim=2, mesh=mesh)
            s = comm.psum(z, mesh=mesh)
            flag = comm.pmax(x[0, 0] > 0, mesh=mesh)
            count = comm.psum(torch.tensor(2 ** 40, dtype=torch.int64),
                              mesh=mesh)
            p = comm.ppermute(x, "data", [(0, 0)], mesh=mesh)
            rs = comm.reduce_scatter(x.detach(), dim=1, mesh=mesh)
        # The backward, outside the block and on a thread of its own (as
        # autograd runs a card's), goes through the group as its forward
        # did.
        grads = []
        worker = threading.Thread(target=lambda: grads.extend(
            torch.autograd.grad((s * 3).sum(), x)))
        worker.start()
        worker.join()
        (g,) = grads
        # Backward: psum's psum, the reverse all_to_all, all_gather's
        # reduce-scatter.
        assert dict(comm.issued) == {"all_gather": 1, "all_to_all": 2,
                                     "all_reduce": 4, "reduce_scatter": 2}
        torch.testing.assert_close(s, x, rtol=0, atol=0)
        torch.testing.assert_close(rs, x, rtol=0, atol=0)
        assert torch.equal(flag, x[0, 0] > 0)
        assert int(count) == 2 ** 40
        torch.testing.assert_close(g, torch.full_like(x, 3), rtol=0, atol=0)
        torch.testing.assert_close(p, x, rtol=0, atol=0)
        assert comm.staged_ops(torch.device("cpu")) == ()
        assert comm.staged_ops(torch.device("cuda")) == comm.STAGED_OPS
    finally:
        comm.shutdown()
    assert comm.staged_ops(torch.device("cuda")) == ()


def test_filter_spec_drops_missing_axes():
    mesh = types.SimpleNamespace(axis_names=("data", "model"))
    assert comm.filter_spec(
        P("model", ("pod", "data"), None, "pod"), mesh.axis_names) == P(
            "model", ("data",), None, None)
    assert repr(P("data", None)) == "P('data', None)"


@pytest.mark.parametrize("world", WORLDS)
def test_mesh_layout(collective_runs, world):
    for r, out in enumerate(collective_runs[world]):
        data, model = divmod(r, world // 2)
        assert out["coords"] == {"data": data, "model": model}
        assert out["index"] == [data, model, r, world]
        assert out["ambient"] and out["outside"]
        assert out["backend"] == "gloo"
        assert out["refused"] == 4   # three bad calls, a 256-rank mesh
        assert out["host_mesh"] == {"data": world}


@pytest.mark.parametrize("world", WORLDS)
def test_all_gather_and_its_transpose(collective_runs, world):
    xs = inputs(1, world)
    w_t, w_s = inputs(2, world, (4, 6 * world, 3)), inputs(3, world,
                                                          (world, *SHAPE))
    for r, out in enumerate(collective_runs[world]):
        fwd, grad = out["gather_tiled"]
        np.testing.assert_array_equal(fwd, torch.cat(xs, 1).numpy())
        # Transpose: the sum over ranks of each cotangent's chunk r.
        want = sum(w[:, 6 * r:6 * (r + 1)] for w in w_t)
        np.testing.assert_allclose(grad, want.numpy(), rtol=0, atol=1e-6)
        fwd, grad = out["gather_stacked"]
        np.testing.assert_array_equal(fwd, torch.stack(xs).numpy())
        np.testing.assert_allclose(grad, sum(w[r] for w in w_s).numpy(),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(
            out["grid_gather"], torch.cat(xs, 0).numpy())


@pytest.mark.parametrize("world", WORLDS)
def test_all_to_all_and_its_transpose(collective_runs, world):
    xs = inputs(1, world)
    ws = inputs(4, world, (4 // world, 6, 3 * world))
    c = 4 // world
    for r, out in enumerate(collective_runs[world]):
        fwd, grad = out["all_to_all"]
        # Rank r receives chunk r of every source, concatenated on dim 2.
        want = torch.cat([x[r * c:(r + 1) * c] for x in xs], 2)
        np.testing.assert_array_equal(fwd, want.numpy())
        # Transpose: source r's chunk j came back from rank j's cotangent.
        back = torch.cat([w[:, :, 3 * r:3 * (r + 1)] for w in ws], 0)
        np.testing.assert_array_equal(grad, back.numpy())


@pytest.mark.parametrize("world", WORLDS)
def test_reductions(collective_runs, world):
    xs = torch.stack(inputs(1, world))
    w5, w6 = torch.stack(inputs(5, world)), torch.stack(inputs(6, world))
    for out in collective_runs[world]:
        np.testing.assert_allclose(out["psum"][0], xs.sum(0).numpy(),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(out["psum"][1], w5.sum(0).numpy(),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(out["pmean"][0],
                                   (xs.sum(0) / world).numpy(),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(out["pmean"][1],
                                   (w6.sum(0) / world).numpy(),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(out["pmax"], xs.amax(0).numpy())
        np.testing.assert_array_equal(out["pmin"], xs.amin(0).numpy())
        np.testing.assert_array_equal(out["pmax_bool"],
                                      (xs[:, 0, 0] > 0).any(0).numpy())
    half = world // 2
    for r, out in enumerate(collective_runs[world]):
        group = xs[(r // half) * half:(r // half + 1) * half]
        np.testing.assert_allclose(out["grid_psum_model"],
                                   group.sum(0).numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_ppermute_and_its_inverse(collective_runs, world):
    xs, w7, w8 = inputs(1, world), inputs(7, world), inputs(8, world)
    for r, out in enumerate(collective_runs[world]):
        fwd, grad = out["shift"]
        np.testing.assert_array_equal(fwd, xs[(r - 1) % world].numpy())
        np.testing.assert_array_equal(grad, w7[(r + 1) % world].numpy())
        fwd, grad = out["partial"]
        # Only the last rank receives; every other rank gets zeros.
        want = xs[0] if r == world - 1 else torch.zeros(SHAPE)
        np.testing.assert_array_equal(fwd, want.numpy())
        want = w8[world - 1] if r == 0 else torch.zeros(SHAPE)
        np.testing.assert_array_equal(grad, want.numpy())


def test_shard_tree_round_trip(collective_runs):
    a, b = rank_input(9, 0, (4, 6)), rank_input(10, 0, (8,))
    for r, out in enumerate(collective_runs[4]):
        data, model = divmod(r, 2)
        cut, whole = out["tree"]
        assert whole
        np.testing.assert_array_equal(
            cut["a"], a[model * 2:(model + 1) * 2,
                        data * 3:(data + 1) * 3].numpy())
        np.testing.assert_array_equal(cut["b"], b[2 * r:2 * (r + 1)].numpy())


# -- the int8 ring ------------------------------------------------------------

def test_int8_ring_equals_repro_at_8_ranks(ring_runs):
    ref, got, _ = ring_runs
    red = np.stack([out["ring"][0][0] for out in got])
    err = np.stack([out["ring"][1][0] for out in got])
    np.testing.assert_array_equal(red, np.asarray(ref["red"], np.float32))
    np.testing.assert_array_equal(err, np.asarray(ref["err"], np.float32))
    g = np.asarray(ref["g"], np.float32)
    assert np.abs(red - g.mean(0)).max() <= np.abs(g).max() / 127 * 16
    assert np.abs(err).max() > 0


def test_error_feedback_three_steps_equals_repro_and_the_twin(ring_runs):
    ref, got, steps = ring_runs
    state = None
    for i, step in enumerate(steps):
        grads = {k: torch.from_numpy(v) for k, v in step.items()}
        state = state or comp.init_compression(grads)
        red, state = comp.compressed_allreduce_twin(grads, state, 8)
        for k in ("a", "b"):
            rank_red = np.stack([out["steps"][i][k][0] for out in got])
            rank_err = np.stack([out["steps"][i][k][1] for out in got])
            np.testing.assert_array_equal(rank_red, red[k].numpy())
            np.testing.assert_array_equal(rank_err, state.error[k].numpy())
            want_red, want_err = ref["steps"][i][k]
            np.testing.assert_array_equal(
                rank_red, np.asarray(want_red, np.float32))
            np.testing.assert_array_equal(
                rank_err, np.asarray(want_err, np.float32))


def test_ring_returns_unchanged_at_axis_size_one():
    mesh = types.SimpleNamespace(axis_size=lambda axis: 1)
    grads = {"w": torch.ones(3)}
    state = comp.init_compression(grads)
    for red, same in (comp.compressed_allreduce(grads, state, mesh),
                      comp.compressed_allreduce_twin(grads, state, 1)):
        assert red is grads and same is state
