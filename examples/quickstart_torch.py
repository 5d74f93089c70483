"""Quickstart on the PyTorch port: the paper's Fig. 1 scenario, the twin
of ``examples/quickstart.py`` on the same graph and query.

Three "leads" (keyword groups) in a small call-record-style graph; DKS
finds the connection node and the minimal answer tree, verified against
the exact Dreyfus-Wagner oracle, then the same query through the
``QueryEngine`` facade.  Exits non-zero unless both give the optimum.

    PYTHONPATH=src python examples/quickstart_torch.py             # cuda:0
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import INF
from repro_torch.core import DKSConfig, dreyfus_wagner, extract_answers, run_dks
from repro_torch.device import resolve_device
from repro_torch.engine import QueryEngine
from repro_torch.graph.structure import build_graph

# A small entity graph: node 7 is the hidden hub connecting all three leads.
EDGES = [
    (0, 7), (1, 7), (2, 7),          # leads' phones -> hub
    (3, 0), (4, 1), (5, 2),          # peripheral entities
    (0, 1), (8, 9), (9, 2), (7, 8),  # noise / alternate paths
]
WEIGHTS = np.asarray([1, 1, 2, 1, 1, 1, 5, 1, 3, 2], np.float32)
GROUPS = [[0, 3], [1, 4], [2, 5]]     # keyword-nodes of each lead
LABELS = ["alice phone", "bob phone", "carol phone", "alice", "bob",
          "carol", "unused", "hub", "relay", "relay two"]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda:0",
                    help="'cpu' runs the port's plain versions")
    dev = resolve_device(ap.parse_args(argv).device)
    g = build_graph([e[0] for e in EDGES], [e[1] for e in EDGES], 10,
                    w=WEIGHTS)
    masks = np.zeros((3, g.n_nodes), bool)
    for i, grp in enumerate(GROUPS):
        masks[i, grp] = True

    cfg = DKSConfig(m=3, k=2)
    state = run_dks(g.to_device(dev), torch.from_numpy(masks).to(dev), cfg)
    print(f"device: {dev}; supersteps: {int(state.step[0])}  "
          f"(early exit: {bool(state.done[0])})")
    print(f"top-{cfg.k} answer weights: "
          f"{[float(x) for x in state.topk_w[0] if x < INF]}")

    answers = extract_answers(state.S[0].cpu().numpy(), g, masks, k=2)
    for i, a in enumerate(answers):
        print(f"answer #{i + 1}: root={a.root} weight={a.weight} "
              f"edges={a.edges}")
    opt = dreyfus_wagner(g, GROUPS)
    if not answers or abs(answers[0].weight - opt) > 1e-6:
        print(f"FAILED: best answer {answers[:1]} is not the optimum {opt}")
        return 1
    print(f"verified optimal (Dreyfus-Wagner oracle: {opt})")

    # The same flow through the QueryEngine facade: build once, then every
    # query is an index lookup and the lane-batched driver.
    g.labels = LABELS
    engine = QueryEngine.build(g, device=dev)
    result = engine.query(["alice", "bob", "carol"], k=2)
    print(f"\nengine ({engine.policy.backend} backend): best weight "
          f"{result.best.weight} at root {result.best.root} in "
          f"{result.supersteps} supersteps")
    if abs(result.best.weight - opt) > 1e-6:
        print(f"FAILED: the engine's best {result.best.weight} is not the "
              f"optimum {opt}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
