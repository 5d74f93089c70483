"""Production meshes and the cut of a parameter tree across ranks: the twin
of ``repro.launch.mesh``.

``repro`` places arrays with ``NamedSharding`` s and lets XLA move them;
here each rank holds only its slice of a leaf, so ``named_sharding`` and
``sharding_tree`` become :func:`shard_tree` (this rank's slice of every
leaf, from a whole tree every rank holds) and :func:`gather_tree` (the
whole tree back, from every rank's slices).  A leaf's spec is a
:class:`~repro_torch.distributed.comm.PartitionSpec`.  For the LM:
:func:`shard_lm` (a whole model -> this rank's, on a mesh),
:func:`gather_lm` (every rank's slices -> the whole parameters),
:func:`lm_state_specs` (``repro``'s ``_lm_state_specs``: AdamW's moments
split as the parameters) and :func:`data_rows` (this rank's rows of a
batch).
"""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.distributed import comm
from repro_torch.distributed.comm import PartitionSpec
from repro_torch.models import common
from repro_torch.models import transformer as tfm
from repro_torch.optim.optimizers import tree_map

P = PartitionSpec


MESH_NAMES = {False: "pod16x16", True: "multipod2x16x16"}


def make_production_mesh(*, multi_pod: bool = False, counting: bool = False,
                         device_type: str = "cuda") -> comm.Mesh:
    """16 x 16 (data, model) for one pod; 2 x 16 x 16 (pod, data, model)
    for two.  Raises unless the group has exactly that many ranks; with
    ``counting``, a :class:`~repro_torch.distributed.comm.CountingMesh`
    of that layout at rank 0 (no group: it counts on ``meta``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if counting:
        return comm.CountingMesh(shape, axes)
    return comm.Mesh(shape, axes, device_type)


def default_tp(args) -> int:
    """The tensor-parallel degree a CLI's model is padded to: ``--tp``,
    else ``repro``'s CLIs' rule, 1 under ``--smoke`` and else the
    production mesh's ``model`` size, 16."""
    if args.tp is not None:
        return args.tp
    return 1 if args.smoke else 16


def make_host_mesh(device_type: str = "cuda") -> comm.Mesh:
    """Every rank of the group as a 1-D ``("data",)`` mesh."""
    return comm.Mesh((comm.world_size(),), ("data",), device_type)


def shard_tree(tree: Any, spec_tree: Any, mesh: comm.Mesh) -> Any:
    """This rank's slice of every leaf (:func:`comm.shard`)."""
    return tree_map(lambda x, spec: comm.shard(x, spec, mesh), tree,
                    spec_tree)


def gather_tree(tree: Any, spec_tree: Any, mesh: comm.Mesh) -> Any:
    """The inverse of :func:`shard_tree`: every leaf whole on every rank
    (:func:`comm.unshard`)."""
    return tree_map(lambda x, spec: comm.unshard(x, spec, mesh), tree,
                    spec_tree)


def lm_state_specs(b: tfm.BuiltLM) -> list:
    """The specs of ``repro``'s ``TrainState`` pytree as
    :func:`repro_torch.models.lm.train_state_tree` gives it (``[params,
    [mu, nu, count], step]``): the moments split as the parameters, the
    counts whole."""
    ps = tfm.param_specs(b)
    return [ps, [ps, ps, P()], P()]


def shard_lm(model: tfm.LM, mesh: comm.Mesh, specs: dict | None = None
             ) -> tfm.LM:
    """This rank's :class:`~repro_torch.models.transformer.LM` on ``mesh``
    from a whole one (every rank holding the same): each parameter's
    slice by the spec tree ``specs`` (default ``param_specs``; a
    pipeline stage's ``stage_layer_specs``, whose layer axis
    :func:`~repro_torch.models.pipeline.keep_stage_layers` then cuts),
    copied, so the whole model can be freed."""
    out = tfm.LM(model.b, device="meta", dtype=model.embed.dtype, mesh=mesh,
                 specs=specs)
    whole = {k: p.detach() for k, p in model.named_parameters()}
    local = {k: v.clone() for k, v in shard_tree(
        whole, {k: s for k, s in out.named_specs().items() if k in whole},
        mesh).items()}
    out.load_state_dict(local, assign=True)
    for p in out.parameters():
        p.requires_grad_(False)
    return out


def gather_lm(model: tfm.LM) -> dict:
    """Every parameter of a rank's model whole, by name (every rank takes
    part)."""
    specs = model.named_specs()
    local = {k: p.detach() for k, p in model.named_parameters()}
    return gather_tree(local, {k: specs[k] for k in local}, model.mesh)


def data_rows(x: torch.Tensor, mesh: comm.Mesh) -> torch.Tensor:
    """This rank's rows of a batch ``x`` (dim 0 split over the data
    axes)."""
    axes = common.mesh_axes(mesh, common.FSDP)
    if not axes:
        return x
    n, i = mesh.axis_size(axes), mesh.axis_index(axes)
    if x.shape[0] % n:
        raise ValueError(f"a batch of {x.shape[0]} rows does not split "
                         f"over {axes} ({n} ranks)")
    w = x.shape[0] // n
    return x[i * w:(i + 1) * w]
