"""End-to-end driver on the PyTorch port (the paper's production flow,
Fig. 2c): a batch of relationship queries against an LOD-scale synthetic
graph through ``QueryEngine.query_batch``; the twin of
``examples/relationship_queries.py`` on the same graph and workload.

The engine owns index lookup, mask padding and device residency;
``query_batch`` buckets the mixed 2-/3-keyword workload by ``m`` and runs
each bucket through the lane-batched driver.  Exits non-zero unless every
query's best weight in the batch equals the same query served alone.

    PYTHONPATH=src python examples/relationship_queries_torch.py  # cuda:0
    PYTHONPATH=src python examples/relationship_queries_torch.py \\
        --device cpu [--dataset bluk-bnb-cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.device import resolve_device
from repro_torch.engine import ExecutionPolicy, QueryEngine
from repro_torch.launch.dks_query import load_dataset


def workload(index, n_queries: int) -> list[list]:
    """Mixed 2- and 3-keyword queries across the df spectrum (the JAX
    example's, seed 7)."""
    vocab = sorted(index.vocabulary(), key=index.df)
    usable = [t for t in vocab if index.df(t) >= 2]
    rng = np.random.default_rng(7)
    queries = []
    for i in range(n_queries):
        m = 2 + i % 2
        lo = int(len(usable) * (i / n_queries))
        picks = rng.choice(np.arange(lo, min(lo + 30, len(usable))), m,
                           replace=False)
        queries.append([usable[int(p)] for p in picks])
    return queries


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="sec-rdfabout-cpu")
    ap.add_argument("--n-queries", type=int, default=6)
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--budget", type=float, default=float("inf"))
    ap.add_argument("--device", default="cuda:0",
                    help="'cpu' runs the port's plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ds, g, index = load_dataset(args.dataset)
    print(f"graph: {ds.name} V={g.n_nodes:,} E_sym={g.n_edges_sym:,} "
          f"on {dev}")
    engine = QueryEngine.build(
        g, index=index, device=dev,
        policy=ExecutionPolicy(max_supersteps=24,
                               message_budget=args.budget))
    queries = workload(index, args.n_queries)

    t0 = time.perf_counter()
    results = engine.query_batch(queries, k=args.k)
    total_t = time.perf_counter() - t0

    failed = 0
    for qi, (q, res) in enumerate(zip(queries, results)):
        line = (f"q{qi} m={res.m} kw_nodes={res.kw_nodes:5d} "
                f"steps={res.supersteps:2d} "
                f"explored={100 * res.explored_frac:5.1f}% ")
        if res.found:
            line += f"best={res.best.weight} root={res.best.root}"
            if res.budget_hit or res.capped:
                line += f" SPA-ratio={res.spa_ratio:.2f}"
        else:
            line += "no answer (disconnected leads)"
        alone = engine.query(q, k=args.k)
        if alone.best_weight != res.best_weight:
            line += f"  MISMATCH: alone {alone.best_weight}"
            failed += 1
        print(line)

    print(f"\nserved {len(queries)} queries in {total_t:.2f}s "
          f"({total_t / len(queries):.2f}s avg, backend "
          f"{engine.policy.backend})")
    if failed:
        print(f"FAILED: {failed} batched answers differ from the query "
              f"served alone")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
