"""The dense DKS superstep on a mesh (``core/dks.py::mesh_superstep``)
against ``repro``'s ``superstep`` under GSPMD, on the CPU.

``repro``'s side jits ``core/dks.py::superstep`` with its dense cell's
in-specs (``src/repro/launch/cells.py::dks_cell_dense``: the graph's
leaves and the node masks ``P(DP)``, ``S`` ``P(DP, TP, None)``, the rest
whole) on 4 forced host devices, in one subprocess.  The port's side runs
on 4 gloo ranks, at (data 2, model 2) and at (pod 2, data 1, model 2), in
one spawn, with its relax and node chunks cut small so that the chunked
paths run.  Two graphs of 2,000 nodes, padded alike: a power-law graph
and a unit grid whose keywords sit in mirrored places on the two data
ranks' rows, so that the top-K answers tie on weight across ranks and
``_merge_topk``'s order decides their roots.  m = 3 (8 keyword sets, 4 on
each ``model`` rank), K = 2, 3 supersteps from ``init_state``.

Tolerance: none.  Every state field, gathered by its spec from the ranks,
is ``torch.equal`` to ``repro``'s and to the one-process port's after
every superstep; the fields whole on every rank are equal on every rank.
"""

import concurrent.futures
import textwrap

import numpy as np
import pytest
import torch

from tests.test_distributed import run_in_subprocess

from repro_torch.core import dks
from repro_torch.distributed import comm
from repro_torch.distributed.ranks import run_ranks
from repro_torch.graph import generators as gen
from repro_torch.models.common import DP, TP, mesh_axes

M, K, STEPS = 3, 2, 3
V_PAD, E_PAD = 2048, 12288
MESHES = (((2, 2), ("data", "model")),
          ((2, 1, 2), ("pod", "data", "model")))
CFG = dks.DKSConfig(m=M, k=K, max_supersteps=64)
SPLIT = ("S", "changed", "first_fire", "visited")
RANKS_TIMEOUT_S = 180


def _grid_keywords(rows: int, cols: int) -> np.ndarray:
    """Each keyword at two places mirrored about the grid's middle row:
    rows 17-18 on the first data rank's nodes, 21-22 on the second's."""
    kw = np.zeros((M, V_PAD), bool)
    for i, (r, c) in enumerate(((18, 10), (18, 12), (17, 11))):
        kw[i, r * cols + c] = kw[i, (rows - 1 - r) * cols + c] = True
    return kw


def _inputs() -> dict:
    """{name: (graph, keyword masks [m, V_PAD])}."""
    lod, _ = gen.lod_like_graph(2000, 6000, seed=5, vocab=50)
    rng = np.random.default_rng(11)
    kw = np.zeros((M, V_PAD), bool)
    for i in range(M):
        kw[i, rng.choice(2000, 6, replace=False)] = True
    return {"lod": (lod, kw),
            "tied": (gen.grid_graph(40, 50), _grid_keywords(40, 50))}


def _whole(g):
    return g.to_device("cpu", pad_nodes_to=V_PAD, pad_edges_to=E_PAD)


REPRO = """
    import functools
    from jax.sharding import PartitionSpec as P
    from repro.core import dks
    from repro.graph.structure import DeviceGraph
    from repro.launch.mesh import sharding_tree
    from repro.shardmap import make_mesh
    DP, TP = ("pod", "data"), ("model",)
    z = np.load(INPUTS)
    cfg = dks.DKSConfig(m=M, k=K, max_supersteps=64)
    gspec = dict(src=P(DP), dst=P(DP), w=P(DP), valid=P(DP),
                 out_degree=P(DP), node_valid=P(DP))
    sspec = dks.DKSState(
        S=P(DP, TP, None), changed=P(DP), first_fire=P(DP), visited=P(DP),
        g=P(None), s_front=P(None), topk_w=P(None), topk_root=P(None),
        msgs_bfs=P(), msgs_deep=P(), step=P(), done=P(), budget_hit=P(),
        capped=P())
    got = {}
    for name in NAMES:
        graph = DeviceGraph(**{f: jnp.asarray(z[f"{name}/{f}"])
                               for f in gspec},
                            n_nodes=int(z[f"{name}/n_nodes"]),
                            n_edges=int(z[f"{name}/n_edges"]))
        state0 = dks.init_state(graph, jnp.asarray(z[f"{name}/kw"]), cfg)
        for shape, axes in MESHES:
            mesh = make_mesh(shape, axes)
            gs = sharding_tree(mesh, DeviceGraph(
                **gspec, n_nodes=graph.n_nodes, n_edges=graph.n_edges))
            ss = sharding_tree(mesh, sspec)
            step = jax.jit(functools.partial(dks.superstep, cfg=cfg),
                           in_shardings=(gs, ss), out_shardings=ss)
            g, st = jax.device_put(graph, gs), jax.device_put(state0, ss)
            for i in range(STEPS):
                st = step(g, st)
                for f in FIELDS:
                    got[f"{name}/{len(shape)}/{i}/{f}"] = np.asarray(
                        getattr(st, f))
    np.savez(OUT, **got)
    out = {"ok": True}
"""


def _mesh_graph(whole, mesh: comm.Mesh) -> dks.MeshGraph:
    """This rank's :class:`~repro_torch.core.dks.MeshGraph` of ``whole``:
    every leaf's block over the data axes (the dense cell's ``P(DP)``)."""
    nodes = mesh_axes(mesh, DP)
    n, i = mesh.axis_size(nodes), mesh.axis_index(nodes)

    def cut(x):
        w = x.shape[0] // n
        return x[i * w:(i + 1) * w]

    return dks.MeshGraph(
        **{f: cut(getattr(whole, f)) for f in (
            "src", "dst", "w", "valid", "out_degree", "node_valid")},
        in_offsets=whole.in_offsets, hub_nodes=whole.hub_nodes,
        n_nodes=whole.n_nodes, n_edges=whole.n_edges,
        in_offsets_host=whole.in_offsets_host, mesh=mesh, node_axes=nodes,
        set_axes=mesh_axes(mesh, TP), node_lo=i * (whole.v_pad // n),
        edge_lo=i * (whole.e_pad // n))


def _mesh_state(state: dks.DKSState, mesh: comm.Mesh) -> dks.DKSState:
    """This rank's part of a lane-batched state: ``S``'s node rows over the
    data axes and its keyword sets over ``model``, the masks' rows."""
    nodes, sets = mesh_axes(mesh, DP), mesh_axes(mesh, TP)
    n, i = mesh.axis_size(nodes), mesh.axis_index(nodes)
    t, j = mesh.axis_size(sets), mesh.axis_index(sets)
    rows = slice(i * (V_PAD // n), (i + 1) * (V_PAD // n))
    w = state.S.shape[2] // t
    return dks.DKSState(**{
        f: getattr(state, f) for f in dks.STATE_FIELDS if f not in SPLIT},
        S=state.S[:, rows, j * w:(j + 1) * w].contiguous(),
        **{f: getattr(state, f)[:, rows] for f in SPLIT[1:]})


def _ranks(device, inputs):
    """Each mesh's 3 supersteps on this rank: every field of its state."""
    torch.set_num_threads(1)
    # Chunks of 300 edges and 64 nodes: the chunked relax with the
    # host's offsets, and the merge and closure over node chunks.
    dks.RELAX_CHUNK_BYTES = 300 * 4 * K * 4
    dks.NODE_CHUNK_BYTES = 64 * 8 * K * 4
    out = {}
    for name, (g, kw) in inputs.items():
        whole = _whole(g)
        state0 = dks.init_state(whole, torch.from_numpy(kw)[None], CFG)
        for shape, axes in MESHES:
            mesh = comm.Mesh(shape, axes, "cpu")
            graph, st = _mesh_graph(whole, mesh), _mesh_state(state0, mesh)
            steps = []
            for _ in range(STEPS):
                st = dks.superstep(graph, st, CFG)
                steps.append({f: getattr(st, f) for f in dks.STATE_FIELDS})
            out[name, len(shape)] = {"coords": mesh.coords, "steps": steps}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``repro``'s GSPMD supersteps (a subprocess), the 4 ranks and the
    one-process port, on both graphs."""
    work = tmp_path_factory.mktemp("dense_mesh")
    inputs = _inputs()
    arrays = {}
    for name, (g, kw) in inputs.items():
        whole = _whole(g)
        for f in ("src", "dst", "w", "valid", "out_degree", "node_valid"):
            arrays[f"{name}/{f}"] = getattr(whole, f).numpy()
        arrays.update({f"{name}/kw": kw, f"{name}/n_nodes": whole.n_nodes,
                       f"{name}/n_edges": whole.n_edges})
    np.savez(work / "inputs.npz", **arrays)
    head = (f"INPUTS = {str(work / 'inputs.npz')!r}\n"
            f"OUT = {str(work / 'repro.npz')!r}\nM, K, STEPS = {M}, {K}, "
            f"{STEPS}\nNAMES = {list(inputs)!r}\nMESHES = {MESHES!r}\n"
            f"FIELDS = {list(dks.STATE_FIELDS)!r}\n")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(run_in_subprocess,
                          head + textwrap.dedent(REPRO), 4)
        ranks = run_ranks(_ranks, 4, inputs, timeout_s=RANKS_TIMEOUT_S,
                          workdir=work)
        ref.result()
    one = {}
    for name, (g, kw) in inputs.items():
        whole = _whole(g)
        st = dks.init_state(whole, torch.from_numpy(kw)[None], CFG)
        one[name] = []
        for _ in range(STEPS):
            st = dks.superstep(whole, st, CFG)
            one[name].append(st)
    return dict(np.load(work / "repro.npz")), ranks, one


def _gathered(outs: list, key, step: int, field: str) -> torch.Tensor:
    """``field`` after superstep ``step`` put together from every rank's
    part by its spec (lane axis of 1 dropped); a whole field is rank
    0's, after checking that every rank holds the same."""
    parts = [(o[key]["coords"], o[key]["steps"][step][field]) for o in outs]
    if field not in SPLIT:
        for _, p in parts[1:]:
            assert torch.equal(p, parts[0][1]), (key, step, field)
        return parts[0][1][0]
    sizes = dict(zip(*next((a, s) for s, a in MESHES if len(s) == key[1])))
    blocks = {}
    for coords, p in parts:
        i = 0
        for a in (a for a in DP if a in sizes):
            i = i * sizes[a] + coords[a]
        blocks.setdefault(i, {})[coords["model"]] = p[0]
    rows = []
    for i in sorted(blocks):
        sets = blocks[i]
        if field == "S":
            rows.append(torch.cat([sets[j] for j in sorted(sets)], dim=1))
        else:
            for j in sets:
                assert torch.equal(sets[j], sets[0]), (key, step, field)
            rows.append(sets[0])
    return torch.cat(rows, dim=0)


@pytest.mark.parametrize("name", ["lod", "tied"])
@pytest.mark.parametrize("mesh", [2, 3], ids=["data2_model2",
                                              "pod2_data1_model2"])
def test_dense_mesh_superstep_matches_repros_gspmd(runs, name, mesh):
    ref, ranks, one = runs
    for step in range(STEPS):
        for f in dks.STATE_FIELDS:
            got = _gathered(ranks, (name, mesh), step, f)
            want = torch.from_numpy(np.asarray(
                ref[f"{name}/{mesh}/{step}/{f}"]))
            assert torch.equal(got, want.to(got.dtype)), (step, f)
            assert torch.equal(got, getattr(one[name][step], f)[0]), (
                step, f)


def test_tied_answers_cross_the_data_ranks(runs):
    """On the grid the top-K answers tie on weight across the two data
    ranks' rows: after the first superstep one root on each rank's rows;
    after the third both on the first rank's, though the second's rows
    reach the same weight (the merge chose by global cell index)."""
    _, _, one = runs
    half = V_PAD // 2
    first, last = one["tied"][0], one["tied"][STEPS - 1]
    for st in (first, last):
        w = st.topk_w[0]
        assert float(w[0]) == float(w[-1]) < 1e9
    assert int(first.topk_root[0, 0]) < half <= int(first.topk_root[0, 1])
    full = last.S[0, :, CFG.full, :]
    w = last.topk_w[0, -1]
    assert bool((full[half:] <= w).any())
    assert int(last.topk_root[0].max()) < half
