"""Carry a DKS engine's data across from the JAX package.

A DKS engine has no weights: its parameters are the graph, the inverted
index and the superstep state.  These functions take them as plain numpy
arrays (what ``repro``'s dataclasses hold, or ``np.asarray`` of its device
arrays), so this module needs neither ``jax`` nor ``repro``:

- :func:`graph_from_numpy` — a dict of ``Graph`` fields -> the port's
  :class:`~repro_torch.graph.structure.Graph`;
- :func:`index_from_postings` — ``InvertedIndex.to_postings`` arrays -> the
  port's :class:`~repro_torch.graph.index.InvertedIndex`;
- :func:`state_from_numpy` / :func:`state_to_numpy` — a dict of lane-batched
  ``DKSState`` fields <-> the port's :class:`~repro_torch.core.dks.DKSState`.

An LM's parameters and KV cache come across the same way:

- :func:`lm_params_from_numpy` — ``repro``'s LM param tree (stacked
  ``[L, ...]`` layer arrays, ``x @ W`` orientation; a MoE model's experts
  under ``layers/moe``) -> the port's
  :class:`~repro_torch.models.transformer.LM` with the same weights;
- :func:`cache_from_numpy` / :func:`cache_to_numpy` — a KV cache dict
  (``k``, ``v`` [L, B, S, Hkv, Dh], ``pos``) both ways;
- :func:`cache_quant_from_numpy` / :func:`cache_quant_to_numpy` — an int8
  KV cache dict (``k_q``, ``v_q`` int8 and ``k_s``, ``v_s`` f32 scales,
  ``pos``) both ways.

A DCN-v2 recommender's parameters too:

- :func:`dcn_params_from_numpy` — ``repro``'s ``init_dcn`` tree -> the
  port's parameter dict (:mod:`repro_torch.models.recsys`).

And the training states, so that both packages can take the same step:

- :func:`train_state_from_numpy` / :func:`train_state_to_numpy` — an LM
  ``TrainState`` as the list of ``repro``'s ``jax.tree_util.tree_leaves``
  (params, then ``opt.mu``, ``opt.nu``, ``opt.count``, then ``step``; dict
  keys sorted, layers stacked ``[L, ...]``) <->
  :class:`~repro_torch.models.lm.TrainState`;
- :func:`dcn_state_from_numpy` / :func:`dcn_state_to_numpy` — DCN-v2's
  ``(params, OptState)`` pair, ``repro``'s train carry.

A GNN's too:

- :func:`gnn_params_from_numpy` / :func:`gnn_params_to_numpy` — ``repro``'s
  ``init_gnn`` tree <-> the port's (:mod:`repro_torch.models.gnn`);
- :func:`gnn_state_from_numpy` / :func:`gnn_state_to_numpy` — its
  ``(params, OptState)`` pair;
- :func:`graph_batch_from_numpy` — a dict of ``GraphBatch`` fields -> the
  port's :class:`~repro_torch.models.gnn.GraphBatch`.

bf16 arrays, which numpy holds as ml_dtypes' ``bfloat16``, come across
exactly (through f32, which holds every bf16 value).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.dks import STATE_FIELDS, DKSState
from repro_torch.device import resolve_device
from repro_torch.graph.index import InvertedIndex
from repro_torch.graph.structure import Graph
from repro_torch.checkpoint.checkpointer import Stacked, leaf_like
from repro_torch.configs import GNNConfig, LMConfig, RecsysConfig
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import lm as lm_lib
from repro_torch.models import recsys
from repro_torch.models.transformer import LM
from repro_torch.optim import OptState, tree_leaves, tree_map, tree_unflatten

STATE_DTYPES = {
    "S": np.float32, "changed": np.bool_, "first_fire": np.bool_,
    "visited": np.bool_, "g": np.float32, "s_front": np.float32,
    "topk_w": np.float32, "topk_root": np.int32, "msgs_bfs": np.float32,
    "msgs_deep": np.float32, "step": np.int32, "done": np.bool_,
    "budget_hit": np.bool_, "capped": np.bool_,
}


def _copy(x):
    if isinstance(x, np.ndarray):
        return x.copy()
    if isinstance(x, tuple):
        return tuple(_copy(y) for y in x)
    if isinstance(x, list):
        return list(x)
    return x


def graph_from_numpy(fields: dict) -> Graph:
    """A dict of ``Graph`` field values (numpy arrays, lists, ints) -> the
    port's Graph, with every array copied."""
    names = {f.name for f in dataclasses.fields(Graph)}
    unknown = sorted(set(fields) - names)
    if unknown:
        raise ValueError(f"not Graph fields: {unknown}")
    return Graph(**{name: _copy(v) for name, v in fields.items()})


def index_from_postings(tokens, offsets, nodes) -> InvertedIndex:
    """``InvertedIndex.to_postings`` arrays -> the port's index."""
    return InvertedIndex.from_postings(
        list(tokens), np.asarray(offsets, np.int64),
        np.asarray(nodes, np.int32).copy())


def state_from_numpy(fields: dict,
                     device: str | torch.device | None = None) -> DKSState:
    """A dict of lane-batched ``DKSState`` fields (every field with its
    leading lane axis) -> the port's state on ``device``."""
    missing = sorted(set(STATE_FIELDS) - set(fields))
    if missing:
        raise ValueError(f"missing DKSState fields: {missing}")
    dev = resolve_device(device)
    return DKSState(**{
        f: torch.from_numpy(np.array(fields[f], STATE_DTYPES[f])).to(dev)
        for f in STATE_FIELDS})


def state_to_numpy(state: DKSState) -> dict[str, np.ndarray]:
    """The port's state -> a dict of numpy arrays, one per field."""
    return {f: getattr(state, f).cpu().numpy() for f in STATE_FIELDS}


def _tensor(arr) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def lm_params_from_numpy(params_np: dict, cfg: LMConfig,
                         device: str | torch.device | None = None) -> LM:
    """``repro``'s LM param tree with numpy leaves (``embed``,
    ``final_norm``, ``head``, and ``layers`` of stacked ``[L, ...]`` arrays)
    -> an :class:`LM` on ``device`` holding the same values, in the tree's
    dtype (a MoE router stays f32).  Names and shapes must match ``cfg``
    exactly, as a tree that ``repro`` built at ``tp=1`` does."""
    layers = dict(params_np["layers"])
    for name, arr in layers.pop("moe", {}).items():
        layers[f"moe.{name}"] = arr
    state = {name: _tensor(params_np[name])
             for name in ("embed", "final_norm", "head") if name in params_np}
    for key, arr in layers.items():
        if np.shape(arr)[0] != cfg.n_layers:
            raise ValueError(f"layers/{key} has {np.shape(arr)[0]} layers, "
                             f"the config {cfg.n_layers}")
        stacked = _tensor(arr)
        for i in range(cfg.n_layers):
            state[f"layers.{i}.{key}"] = stacked[i]
    model = LM(cfg, device=device, dtype=state["embed"].dtype)
    model.load_state_dict(state)
    return model


def cache_from_numpy(cache_np: dict,
                     device: str | torch.device | None = None) -> dict:
    """A KV cache dict of numpy arrays -> the port's (``pos`` an int)."""
    dev = resolve_device(device)
    return {"k": _tensor(cache_np["k"]).to(dev),
            "v": _tensor(cache_np["v"]).to(dev),
            "pos": int(cache_np["pos"])}


def cache_to_numpy(cache: dict) -> dict:
    """The port's KV cache -> numpy (bf16 as f32, exactly)."""
    return {"k": cache["k"].float().cpu().numpy(),
            "v": cache["v"].float().cpu().numpy(),
            "pos": np.int32(cache["pos"])}


def cache_quant_from_numpy(cache_np: dict,
                           device: str | torch.device | None = None) -> dict:
    """An int8 KV cache dict of numpy arrays -> the port's (``pos`` an
    int)."""
    dev = resolve_device(device)
    out = {name: torch.from_numpy(np.array(cache_np[name], dtype)).to(dev)
           for name, dtype in (("k_q", np.int8), ("k_s", np.float32),
                               ("v_q", np.int8), ("v_s", np.float32))}
    out["pos"] = int(cache_np["pos"])
    return out


def cache_quant_to_numpy(cache: dict) -> dict:
    """The port's int8 KV cache -> numpy, exactly."""
    out = {name: cache[name].cpu().numpy()
           for name in ("k_q", "k_s", "v_q", "v_s")}
    out["pos"] = np.int32(cache["pos"])
    return out


def dcn_params_from_numpy(params_np: dict, cfg: RecsysConfig,
                          device: str | torch.device | None = None) -> dict:
    """``repro``'s ``init_dcn`` tree with numpy leaves (``tables/table_i``,
    ``cross[i].w/b``, ``deep[i].w/b``, ``logit``, ``item``) -> the port's
    parameter dict on ``device``, f32.  Every shape must equal
    :func:`repro_torch.models.recsys.param_shapes` of ``cfg``."""
    dev = resolve_device(device)
    shapes = recsys.param_shapes(cfg)

    def put(arr, want, where):
        if tuple(np.shape(arr)) != tuple(want):
            raise ValueError(f"{where} has shape {list(np.shape(arr))}, the "
                             f"config {list(want)}")
        return torch.from_numpy(np.array(arr, np.float32)).to(dev)

    def layers(key):
        if len(params_np[key]) != len(shapes[key]):
            raise ValueError(f"{key} has {len(params_np[key])} layers, the "
                             f"config {len(shapes[key])}")
        return [{p: put(lw[p], s[p], f"{key}[{i}].{p}") for p in ("w", "b")}
                for i, (lw, s) in enumerate(zip(params_np[key], shapes[key]))]

    if set(params_np["tables"]) != set(shapes["tables"]):
        raise ValueError(f"tables {sorted(params_np['tables'])}, the config "
                         f"{sorted(shapes['tables'])}")
    return {
        "tables": {name: put(params_np["tables"][name], s, f"tables/{name}")
                   for name, s in shapes["tables"].items()},
        "cross": layers("cross"),
        "deep": layers("deep"),
        "logit": put(params_np["logit"], shapes["logit"], "logit"),
        "item": put(params_np["item"], shapes["item"], "item"),
    }


def train_state_from_numpy(leaves: list, cfg: LMConfig,
                           device: str | torch.device | None = None
                           ) -> lm_lib.TrainState:
    """``jax.tree_util.tree_leaves`` of ``repro``'s LM ``TrainState``, as
    numpy arrays (bf16 ones through ml_dtypes or as f32) -> the port's
    state on ``device``, in the dtypes of ``cfg`` (moments f32)."""
    dev = resolve_device(device)
    template = lm_lib.train_state_template(cfg)
    want = tree_leaves(template)
    if len(leaves) != len(want):
        raise ValueError(f"{len(leaves)} leaves, a {cfg.name} TrainState "
                         f"has {len(want)}")
    out = []
    for i, (arr, leaf) in enumerate(zip(leaves, want)):
        shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        if tuple(np.shape(arr)) != shape:
            raise ValueError(f"leaf {i} has shape {list(np.shape(arr))}, the "
                             f"config {list(shape)}")
        out.append(leaf_like(_tensor(arr), leaf, dev))
    return lm_lib.train_state_from_tree(cfg, tree_unflatten(template, out))


def _numpy(leaf) -> np.ndarray:
    if isinstance(leaf, Stacked):
        return np.stack([_numpy(p) for p in leaf.parts])
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(leaf, np.int32)


def train_state_to_numpy(state: lm_lib.TrainState) -> list:
    """The port's LM state -> numpy leaves in ``repro``'s order (bf16 as
    f32, exactly)."""
    return [_numpy(leaf)
            for leaf in tree_leaves(lm_lib.train_state_tree(state))]


def dcn_state_from_numpy(params_np: dict, opt_np: dict, cfg: RecsysConfig,
                         device: str | torch.device | None = None
                         ) -> tuple[dict, OptState]:
    """``repro``'s DCN-v2 ``(params, OptState)`` with numpy leaves
    (``opt_np``: ``{"mu", "nu"}`` trees shaped like the params, and
    ``"count"``) -> the port's parameter dict and :class:`OptState` on
    ``device``."""
    dev = resolve_device(device)
    params = dcn_params_from_numpy(params_np, cfg, dev)
    mu, nu = (dcn_params_from_numpy(opt_np[k], cfg, dev) for k in ("mu", "nu"))
    count = torch.tensor(int(opt_np["count"]), dtype=torch.int32, device=dev)
    return params, OptState(mu=mu, nu=nu, count=count)


def dcn_state_to_numpy(params: dict, opt: OptState) -> tuple[dict, dict]:
    """The inverse of :func:`dcn_state_from_numpy`."""
    to_np = lambda t: t.detach().cpu().numpy()
    return tree_map(to_np, params), {
        "mu": tree_map(to_np, opt.mu), "nu": tree_map(to_np, opt.nu),
        "count": np.int32(opt.count.item())}


def _gnn_d_in(params_np: dict, cfg: GNNConfig) -> int:
    if cfg.family == "schnet":
        return 1
    first = params_np["layers"][0]
    key = {"gat": "w", "gin": "w1", "pna": "pre"}[cfg.family]
    return int(np.shape(first[key])[0])


def gnn_params_from_numpy(params_np: dict, cfg: GNNConfig,
                          device: str | torch.device | None = None) -> dict:
    """``repro``'s ``init_gnn`` tree with numpy leaves -> the port's tree
    on ``device``, f32.  Its keys, nesting and shapes must equal those
    :func:`repro_torch.models.gnn.init_gnn` gives for ``cfg``."""
    dev = resolve_device(device)
    template = gnn_lib.init_gnn(torch.Generator("cpu").manual_seed(0), cfg,
                                _gnn_d_in(params_np, cfg))
    if tree_map(lambda _: 0, params_np) != tree_map(lambda _: 0, template):
        raise ValueError(f"not a {cfg.name} parameter tree: its keys or "
                         f"nesting differ")
    out = []
    for i, (arr, leaf) in enumerate(zip(tree_leaves(params_np),
                                        tree_leaves(template))):
        if tuple(np.shape(arr)) != tuple(leaf.shape):
            raise ValueError(f"leaf {i} has shape {list(np.shape(arr))}, the "
                             f"config {list(leaf.shape)}")
        out.append(torch.from_numpy(np.array(arr, np.float32)).to(dev))
    return tree_unflatten(template, out)


def gnn_params_to_numpy(params: dict) -> dict:
    """The port's GNN tree -> the same tree of numpy f32 arrays."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)


def gnn_state_from_numpy(params_np: dict, opt_np: dict, cfg: GNNConfig,
                         device: str | torch.device | None = None
                         ) -> tuple[dict, OptState]:
    """``repro``'s GNN ``(params, OptState)`` with numpy leaves (``opt_np``:
    ``{"mu", "nu"}`` trees shaped like the params, and ``"count"``) -> the
    port's tree and :class:`OptState` on ``device``."""
    dev = resolve_device(device)
    params = gnn_params_from_numpy(params_np, cfg, dev)
    mu, nu = (gnn_params_from_numpy(opt_np[k], cfg, dev) for k in ("mu", "nu"))
    count = torch.tensor(int(opt_np["count"]), dtype=torch.int32, device=dev)
    return params, OptState(mu=mu, nu=nu, count=count)


def gnn_state_to_numpy(params: dict, opt: OptState) -> tuple[dict, dict]:
    """The inverse of :func:`gnn_state_from_numpy`."""
    return gnn_params_to_numpy(params), {
        "mu": gnn_params_to_numpy(opt.mu), "nu": gnn_params_to_numpy(opt.nu),
        "count": np.int32(opt.count.item())}


GRAPH_BATCH_DTYPES = {
    "x": np.float32, "edge_src": np.int64, "edge_dst": np.int64,
    "node_mask": np.bool_, "edge_mask": np.bool_, "graph_ids": np.int64,
    "positions": np.float32,
}


def graph_batch_from_numpy(fields: dict,
                           device: str | torch.device | None = None
                           ) -> gnn_lib.GraphBatch:
    """A dict of ``GraphBatch`` fields (numpy arrays, ``n_graphs`` an int)
    -> the port's batch on ``device``: features and positions f32, edge
    and graph ids int64 (what ``scatter_reduce`` indexes with), labels in
    their own dtype."""
    names = {f.name for f in dataclasses.fields(gnn_lib.GraphBatch)}
    if set(fields) != names:
        raise ValueError(f"GraphBatch fields {sorted(names)}, got "
                         f"{sorted(fields)}")
    dev = resolve_device(device)
    out = {name: torch.from_numpy(np.array(fields[name], dtype)).to(dev)
           for name, dtype in GRAPH_BATCH_DTYPES.items()}
    out["labels"] = torch.from_numpy(np.array(fields["labels"])).to(dev)
    return gnn_lib.GraphBatch(**out, n_graphs=int(fields["n_graphs"]))
