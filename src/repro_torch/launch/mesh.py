"""Production meshes and the cut of a parameter tree across ranks: the twin
of ``repro.launch.mesh``.

``repro`` places arrays with ``NamedSharding`` s and lets XLA move them;
here each rank holds only its slice of a leaf, so ``named_sharding`` and
``sharding_tree`` become :func:`shard_tree` (this rank's slice of every
leaf, from a whole tree every rank holds) and :func:`gather_tree` (the
whole tree back, from every rank's slices).  A leaf's spec is a
:class:`~repro_torch.distributed.comm.PartitionSpec`.
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.distributed import comm
from repro_torch.distributed.comm import PartitionSpec
from repro_torch.optim.optimizers import tree_map

P = PartitionSpec


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> comm.Mesh:
    """16 x 16 (data, model) for one pod; 2 x 16 x 16 (pod, data, model)
    for two.  Raises unless the group has exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return comm.Mesh(shape, axes, device_type)


def make_host_mesh(device_type: str = "cuda") -> comm.Mesh:
    """Every rank of the group as a 1-D ``("data",)`` mesh."""
    return comm.Mesh((comm.world_size(),), ("data",), device_type)


def filter_spec(spec: PartitionSpec, mesh: comm.Mesh) -> PartitionSpec:
    """Drop axis names that the mesh does not have."""
    names = set(mesh.axis_names)

    def f(entry):
        if entry is None:
            return None
        if isinstance(entry, str):
            return entry if entry in names else None
        kept = tuple(a for a in entry if a in names)
        return kept if kept else None

    return PartitionSpec(*(f(e) for e in spec))


def shard_tree(tree: Any, spec_tree: Any, mesh: comm.Mesh) -> Any:
    """This rank's slice of every leaf: dimension ``d`` split over the
    ranks of ``spec[d]``, the chunk at this rank's index kept."""

    def cut(x: torch.Tensor, spec: PartitionSpec) -> torch.Tensor:
        for d, entry in enumerate(filter_spec(spec, mesh)):
            if entry is None:
                continue
            n, i = mesh.axis_size(entry), mesh.axis_index(entry)
            if x.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(x.shape)} does not "
                                 f"split over {entry} ({n} ranks)")
            w = x.shape[d] // n
            x = x.narrow(d, i * w, w)
        return x.contiguous()

    return tree_map(cut, tree, spec_tree)


def gather_tree(tree: Any, spec_tree: Any, mesh: comm.Mesh) -> Any:
    """The inverse of :func:`shard_tree`: every leaf whole on every rank."""

    def join(x: torch.Tensor, spec: PartitionSpec) -> torch.Tensor:
        for d, entry in enumerate(filter_spec(spec, mesh)):
            if entry is not None:
                x = comm.all_gather(x, entry, dim=d, tiled=True, mesh=mesh)
        return x

    return tree_map(join, tree, spec_tree)
