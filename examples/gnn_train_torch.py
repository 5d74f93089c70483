"""Train every GNN architecture of the port on a cora-like synthetic graph
(full batch), and SchNet on batched molecules: the PyTorch port's twin of
``examples/gnn_train.py``, on the same synthetic data, at ``smoke()``
widths, 60 AdamW steps each.  Exits non-zero unless every loss falls.

    PYTHONPATH=src python examples/gnn_train_torch.py             # cuda:0
    PYTHONPATH=src python examples/gnn_train_torch.py --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import interop
from repro_torch.configs import ARCHS, GNNConfig
from repro_torch.device import resolve_device
from repro_torch.models import gnn as gnn_lib
from repro_torch.optim import AdamWConfig, adamw_init


def cora_like(n=400, e=1600, d_feat=32, n_classes=7, seed=0) -> dict:
    """A random graph whose features are correlated with the labels, so
    that training can succeed (``GraphBatch`` fields, numpy)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n)
    centers = rng.normal(size=(n_classes, d_feat))
    x = centers[labels] + 0.5 * rng.normal(size=(n, d_feat))
    src = rng.integers(0, n, e)
    dst = rng.integers(0, n, e)
    return {"x": x, "edge_src": src, "edge_dst": dst,
            "node_mask": np.ones(n, bool), "edge_mask": np.ones(e, bool),
            "labels": labels.astype(np.int32), "graph_ids": np.zeros(n),
            "positions": rng.normal(size=(n, 3)) * 2, "n_graphs": 1}


def molecules(n_graphs=32, atoms=12, seed=0) -> dict:
    """Molecules with 3 random in-molecule neighbours per atom, atom types
    1..9 and an energy of 0.1 x the sum of the atom types."""
    rng = np.random.default_rng(seed)
    n = n_graphs * atoms
    pos = rng.normal(size=(n, 3)) * 2
    src, dst = [], []
    for gi in range(n_graphs):
        for i in range(atoms):
            for j in rng.choice(atoms, 3, replace=False):
                src.append(gi * atoms + i)
                dst.append(gi * atoms + int(j))
    z = rng.integers(1, 10, (n, 1)).astype(np.float32)
    energy = np.asarray([z[g * atoms:(g + 1) * atoms].sum()
                         for g in range(n_graphs)], np.float32) * 0.1
    return {"x": z, "edge_src": np.asarray(src), "edge_dst": np.asarray(dst),
            "node_mask": np.ones(n, bool),
            "edge_mask": np.ones(len(src), bool), "labels": energy,
            "graph_ids": np.repeat(np.arange(n_graphs), atoms),
            "positions": pos, "n_graphs": n_graphs}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default cuda:0; 'cpu' runs on the CPU")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    opt_cfg = AdamWConfig(lr=3e-3, total_steps=60, warmup_steps=5)
    failed = []
    for cfg in [c for c in ARCHS.values() if isinstance(c, GNNConfig)]:
        cfg = cfg.smoke()
        fields = (molecules() if cfg.family == "schnet"
                  else cora_like(n_classes=cfg.n_classes))
        batch = interop.graph_batch_from_numpy(fields, dev)
        params = gnn_lib.init_gnn(torch.Generator(dev).manual_seed(0), cfg,
                                  d_in=batch.x.shape[1])
        opt = adamw_init(params)
        t0 = time.perf_counter()
        losses = []
        for _ in range(60):
            params, opt, metrics = gnn_lib.gnn_train_step(
                params, opt, batch, cfg, opt_cfg)
            losses.append(float(metrics["loss"]))
        ok = losses[-1] < losses[0]
        print(f"{cfg.name:<10s} loss {losses[0]:8.4f} -> {losses[-1]:8.4f}  "
              f"({'OK' if ok else 'NO IMPROVEMENT'}; "
              f"{time.perf_counter() - t0:.1f} s on {dev})")
        if not ok:
            failed.append(cfg.name)
    if failed:
        print(f"no improvement: {failed}")
        return 1
    print("all GNN architectures train")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
