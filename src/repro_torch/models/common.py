"""Shared model utilities: parameter init.

One card has no mesh, so ``repro.models.common``'s sharding constraints
have no counterpart here.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


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
