"""Serving on the PyTorch port: ``DKSService`` in front of ``QueryEngine``
— concurrent clients coalesced by the micro-batcher, repeat queries
served from the LRU result cache, and a deadline-bounded query answered
best-so-far with its SPA lower bound; the twin of ``examples/serving.py``
on the same graph and trace.  Exits non-zero unless some requests were
coalesced into one dispatch and some were served from the cache.

    PYTHONPATH=src python examples/serving_torch.py               # cuda:0
    PYTHONPATH=src python examples/serving_torch.py --device cpu
"""

from __future__ import annotations

import argparse

from repro_torch.device import resolve_device
from repro_torch.engine import ExecutionPolicy
from repro_torch.launch.dks_query import build_engine
from repro_torch.serve import DKSService, ServeConfig
from repro_torch.serve.loadgen import make_trace, replay


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", default="sec-rdfabout-cpu")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--device", default="cuda:0",
                    help="'cpu' runs the port's plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ds, engine = build_engine(args.dataset,
                              ExecutionPolicy(max_supersteps=16), device=dev)
    print(f"graph: {ds.name} V={engine.n_nodes:,} E_sym={engine.n_edges:,} "
          f"on {dev} ({engine.policy.backend} backend)")

    trace = make_trace(engine.index, args.requests, unique=4, seed=7)
    with DKSService(engine, ServeConfig(max_batch=4, max_wait_ms=25.0,
                                        cache_size=64)) as svc:
        served = replay(svc, trace, n_clients=args.clients)
        for i, (req, srv) in enumerate(zip(trace, served)):
            src = "cache" if srv.cache_hit else f"batch[{srv.batch_size}]"
            best = srv.best_weight if srv.found else None
            print(f"q{i:02d} m={len(req.keywords)} {src:9s} "
                  f"{srv.latency_ms:7.1f} ms  best={best}")
        coalesced = sum(1 for s in served
                        if not s.cache_hit and s.batch_size > 1)
        hits = sum(1 for s in served if s.cache_hit)

        # Deadline-bounded: the budget expires mid-run, the client still
        # gets ranked best-so-far answers plus a lower bound on the optimum.
        svc.invalidate_cache()
        q = list(trace[0].keywords)
        bounded = svc.query(q, k=1, deadline_ms=5.0)
        best = bounded.best_weight if bounded.found else None
        if bounded.approximate:
            print(f"\ndeadline 5ms on {q}: approximate, best-so-far={best}, "
                  f"optimum >= {bounded.opt_lower_bound} "
                  f"(sound: {bounded.sound_opt_lower_bound})")
        else:
            print(f"\ndeadline 5ms on {q}: finished inside the budget, "
                  f"exact best={best}")

        print("\n--- ServeStats ---")
        print(svc.stats().summary())
    print(f"\n{coalesced} requests coalesced into shared dispatches, "
          f"{hits} served from the cache")
    if not coalesced or not hits:
        print("FAILED: the service coalesced no requests or hit no cache "
              "entry")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
