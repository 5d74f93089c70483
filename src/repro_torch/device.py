"""Where the port's tensors live.

Entry points run on the card unless the caller asks for the CPU: a
``device=None`` argument resolves to ``cuda:0`` and raises when there is no
GPU.  There is no silent fallback to the CPU — a CPU run is only ever one the
caller asked for (the tests pass ``device="cpu"``).
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda:0`` (raises ``RuntimeError`` without a GPU);
    anything else is taken as the caller's explicit choice."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain torch path on the CPU")
        return torch.device("cuda", 0)
    return torch.device(device)


def host_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` as a tensor on ``device``.  A read-only array (an mmapped
    artifact buffer) is copied first: ``torch.from_numpy`` would alias its
    pages, and on the CPU ``.to`` does not copy, so the tensor would sit
    on read-only memory."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a).to(device)
