"""Shared model utilities: parameter init, the padding rule, the mesh's
logical axes and a leaf's slice of them.

``repro.models.common``'s ``constrain`` asks XLA to place an array; the
port's ranks hold their slices instead, so its counterparts here are the
axis names (:data:`DP`, :data:`TP`, :data:`FSDP`, ``repro``'s), the axes
of them a mesh has (:func:`mesh_axes`) and their sizes
(:func:`mesh_sizes`).  A spec's own helpers (``filter_spec``,
``local_shape``, ``split_axes``) sit beside ``PartitionSpec`` in
:mod:`repro_torch.distributed.comm`.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

# Data-parallel dims ("pod", "data"), the tensor dim ("model") and every
# dim, as ``repro``'s: an axis a mesh lacks is dropped, so one model runs
# on one device or any mesh.
DP = ("pod", "data")
TP = ("model",)
FSDP = ("pod", "data")
ALL = ("pod", "data", "model")


def pad_to(x: int, multiple: int) -> int:
    return int(-(-x // multiple) * multiple)


def mesh_sizes(mesh) -> tuple[int, int]:
    """(the FSDP / data-parallel size, the tensor-parallel size) of
    ``mesh``: the products of its ``pod`` / ``data`` and its ``model``
    axes, an absent axis (or no mesh) read as 1."""
    if mesh is None:
        return 1, 1
    return (math.prod(mesh.shape.get(a, 1) for a in FSDP),
            math.prod(mesh.shape.get(a, 1) for a in TP))


def mesh_axes(mesh, axes: Sequence[str]) -> tuple[str, ...]:
    """Those of ``axes`` that ``mesh`` has, in mesh order."""
    return tuple(a for a in mesh.axis_names if a in axes) if mesh else ()


def dense_init(generator: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype = torch.bfloat16,
               scale: float | None = None) -> torch.Tensor:
    """Normal(0, 1) x ``scale`` (default 1/sqrt(fan_in), fan_in =
    ``shape[-2]``), drawn in f32 on the generator's device, then cast."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(tuple(shape), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return (x * s).to(dtype)


def split_keys(generator: torch.Generator,
               names: Sequence[str]) -> dict[str, torch.Generator]:
    """One generator per name, on ``generator``'s device, each seeded by a
    draw from ``generator``: adding a parameter group leaves the others'
    numbers as they were."""
    seeds = torch.randint(0, 2**62, (len(names),), generator=generator,
                          device=generator.device).tolist()
    return {n: torch.Generator(generator.device).manual_seed(s)
            for n, s in zip(names, seeds)}
