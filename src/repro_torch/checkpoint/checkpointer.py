"""Checkpoints with async save, retention and a crash-safe commit, in
``repro.checkpoint.checkpointer``'s layout:

    <dir>/step_<N>/
        manifest.json       # step, n_leaves, treedef, shapes, dtypes
        leaf_<i>.npy        # one array per leaf
        _COMMITTED          # written last: the commit marker

The leaves are a tree's leaves in ``jax.tree_util.tree_flatten``'s order:
dict keys sorted, lists and tuples in order
(:func:`repro_torch.optim.tree_leaves`).  A leaf is a tensor, a Python int
(a 0-d int32 array on disk) or a :class:`Stacked`: ``repro`` scans over
layers and holds each layer parameter as one ``[L, ...]`` array, where the
port holds L tensors; a :class:`Stacked` leaf is saved as their stack and
restored split.  numpy has no bfloat16, so a bf16 leaf is saved as its
bit-equal 16-bit view with ``"bfloat16"`` in the manifest's ``dtypes``, as
``repro`` saves it; the view is taken in torch (``Tensor.view``), without
``ml_dtypes``.  ``repro``'s ``restore_tree`` checks ``n_leaves`` and each
leaf's shape, and reads each leaf back as its recorded dtype.

Fault-tolerance contract (``tests/test_torch_infra.py``):
- a save interrupted before ``_COMMITTED`` is ignored by :func:`latest_step`;
- :class:`Checkpointer` copies the leaves to the host on the caller's
  thread (ordered with the step loop) and writes them on a background
  thread, one save in flight at a time, keeping the newest ``keep``.

On a mesh (:class:`repro_torch.distributed.comm.Mesh`), where each rank
holds its slices of a tree cut by a spec tree (``launch/mesh.py``'s
``shard_tree``): :func:`save_tree` with ``specs=`` and ``mesh=`` gathers
every leaf whole, rank 0 writes ``repro``'s layout, and every rank
returns once rank 0 has committed; :func:`restore_tree` with ``specs=``
and ``mesh=`` reads each whole ``.npy`` on every rank and keeps the
rank's slice, cut as ``shard_tree`` cuts: the twin of ``repro``'s
``restore_tree(shardings=)``.  No file format is added.
"""

from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.optim.optimizers import tree_leaves, tree_map, \
    tree_unflatten

_NP_NAMES = {torch.float32: "float32", torch.float64: "float64",
             torch.float16: "float16", torch.int32: "int32",
             torch.int64: "int64", torch.int8: "int8", torch.uint8: "uint8",
             torch.bool: "bool"}


class Stacked:
    """One ``[L, ...]`` leaf held as L tensors of one shape and dtype."""

    def __init__(self, parts):
        self.parts = list(parts)
        if not self.parts:
            raise ValueError("Stacked needs at least one tensor")

    @property
    def shape(self) -> tuple:
        return (len(self.parts), *self.parts[0].shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        return self.parts[0].device


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as (the array written to disk, its logical dtype name)."""
    if isinstance(leaf, Stacked):
        t = torch.empty(leaf.shape, dtype=leaf.dtype)
        for i, part in enumerate(leaf.parts):
            t[i].copy_(part.detach())
    elif isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
    elif isinstance(leaf, (int, np.integer)) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int32), "int32"
    elif isinstance(leaf, np.ndarray):
        return leaf, leaf.dtype.name
    else:
        raise TypeError(f"checkpoint: unsupported leaf {type(leaf).__name__}")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    if t.dtype not in _NP_NAMES:
        raise TypeError(f"checkpoint: unsupported dtype {t.dtype}")
    return t.numpy(), _NP_NAMES[t.dtype]


def _write(host: list, directory: Path, step: int) -> Path:
    out = directory / f"step_{step}"
    tmp = directory / f".tmp_step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    meta = {"step": step, "n_leaves": len(host),
            "treedef": f"repro_torch: {len(host)} leaves in "
                       f"jax.tree_util.tree_flatten order",
            "shapes": [], "dtypes": []}
    for i, (arr, name) in enumerate(host):
        np.save(tmp / f"leaf_{i}.npy", arr)
        meta["shapes"].append(list(arr.shape))
        meta["dtypes"].append(name)
    (tmp / "manifest.json").write_text(json.dumps(meta))
    (tmp / "_COMMITTED").write_text("ok")
    if out.exists():
        shutil.rmtree(out)
    tmp.rename(out)
    return out


def save_tree(tree: Any, directory: str | Path, step: int,
              specs: Any = None, mesh: Any = None) -> Path:
    """Synchronous save; returns the committed directory.  With ``mesh``,
    ``tree`` is this rank's slices by the spec tree ``specs`` (a
    :class:`Stacked` leaf's spec is its stack's): every rank takes part
    in gathering each leaf whole, rank 0 writes, and every rank returns
    once it has committed (a failed write raises on every rank)."""
    if mesh is None:
        return _write([_host(leaf) for leaf in tree_leaves(tree)],
                      Path(directory), step)
    from repro_torch.distributed import comm

    def whole(leaf, spec):
        if isinstance(leaf, Stacked):
            leaf = torch.stack([p.detach() for p in leaf.parts])
        if isinstance(leaf, torch.Tensor):
            return comm.unshard(leaf.detach(), spec, mesh)
        return leaf

    host = [_host(leaf) for leaf in tree_leaves(tree_map(whole, tree,
                                                         specs))]
    out, error = Path(directory) / f"step_{step}", None
    if mesh.axis_index() == 0:
        try:
            _write(host, Path(directory), step)
        except Exception as e:  # noqa: BLE001 -- raised on every rank
            error = e
    dev = next((leaf.device for leaf in tree_leaves(tree)
                if isinstance(leaf, (torch.Tensor, Stacked))), "cpu")
    ok = comm.pmin(torch.tensor(float(error is None), device=dev),
                   mesh=mesh)
    if error is not None:
        raise error
    if not bool(ok) or not (out / "_COMMITTED").exists():
        raise RuntimeError(f"rank 0 did not commit {out}")
    return out


def latest_step(directory: str | Path) -> int | None:
    """The newest committed step under ``directory``, or None."""
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = []
    for d in directory.iterdir():
        if d.name.startswith("step_") and (d / "_COMMITTED").exists():
            try:
                steps.append(int(d.name.split("_")[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


def _host_tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A saved leaf as a host tensor of its logical dtype."""
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def leaf_like(t: torch.Tensor, leaf, device=None):
    """The host tensor ``t`` as a leaf of ``leaf``'s kind: a
    :class:`Stacked` split along its first axis, a tensor, or an int; in
    ``leaf``'s dtype, on ``device`` (None: ``leaf``'s device)."""
    if isinstance(leaf, Stacked):
        dev = leaf.device if device is None else device
        return Stacked(part.to(dev, leaf.dtype, copy=True)
                       for part in t.unbind(0))
    if isinstance(leaf, torch.Tensor):
        dev = leaf.device if device is None else device
        return t.to(dev, leaf.dtype, copy=True)
    return int(t)


def restore_tree(template: Any, directory: str | Path, step: int,
                 device: str | torch.device | None = None,
                 specs: Any = None, mesh: Any = None) -> Any:
    """A new tree shaped like ``template`` with the saved values: each
    tensor leaf in the template's dtype on ``device`` (None: the template
    leaf's own device), each int leaf an int.  The template's leaves give
    only shapes and dtypes, so a template on the ``meta`` device costs no
    memory.  With ``mesh``, ``template`` is this rank's tree by the spec
    tree ``specs``: each saved leaf is cut to this rank's slice
    (:func:`repro_torch.distributed.comm.shard`), the template's shape.
    Raises ``ValueError`` when the leaf count or a shape differs."""
    src = Path(directory) / f"step_{step}"
    if not (src / "_COMMITTED").exists():
        raise FileNotFoundError(f"no committed checkpoint at {src}")
    meta = json.loads((src / "manifest.json").read_text())
    leaves = tree_leaves(template)
    if meta["n_leaves"] != len(leaves):
        raise ValueError(
            f"checkpoint has {meta['n_leaves']} leaves, template has "
            f"{len(leaves)} — architecture mismatch")
    cuts = [None] * len(leaves)
    if mesh is not None:
        from repro_torch.distributed import comm
        from repro_torch.distributed.comm import PartitionSpec

        cuts = tree_leaves(tree_map(lambda _, spec: spec, template, specs),
                           is_leaf=lambda x: isinstance(x, PartitionSpec))
    out = []
    for i, (leaf, spec) in enumerate(zip(leaves, cuts, strict=True)):
        t = _host_tensor(np.load(src / f"leaf_{i}.npy"), meta["dtypes"][i])
        if spec is not None:
            t = comm.shard(t, spec, mesh)
        want = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        if tuple(t.shape) != want:
            raise ValueError(f"leaf {i}: checkpoint shape {tuple(t.shape)} "
                             f"!= template {want}")
        out.append(leaf_like(t, leaf, device))
    return tree_unflatten(template, out)


class Checkpointer:
    """Async checkpointer with retention."""

    def __init__(self, directory: str | Path, keep: int = 3,
                 async_save: bool = True):
        self.directory = Path(directory)
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def wait(self):
        """Join the save in flight; raise its error, if it had one."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _save(self, host: list, step: int):
        try:
            _write(host, self.directory, step)
            self._gc()
        except BaseException as e:  # noqa: BLE001 -- raised by wait()
            self._error = e

    def save(self, tree: Any, step: int):
        self.wait()
        # The device-to-host copy runs on the caller's thread (ordered with
        # the step loop); the disk writes overlap the next steps.
        host = [_host(leaf) for leaf in tree_leaves(tree)]
        if self.async_save:
            self._thread = threading.Thread(
                target=self._save, args=(host, step), daemon=True)
            self._thread.start()
        else:
            self._save(host, step)
            self.wait()

    def _gc(self):
        steps = sorted(
            int(d.name.split("_")[1]) for d in self.directory.iterdir()
            if d.name.startswith("step_") and (d / "_COMMITTED").exists())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.directory / f"step_{s}", ignore_errors=True)

    def latest(self) -> int | None:
        return latest_step(self.directory)

    def restore(self, template: Any, step: int | None = None,
                device: str | torch.device | None = None) -> tuple[Any, int]:
        """(:func:`restore_tree` of ``step``, default the latest, and the
        step)."""
        self.wait()
        if step is None:
            step = self.latest()
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return restore_tree(template, self.directory, step, device), step
