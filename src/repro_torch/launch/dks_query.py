"""Relationship-query CLI (the paper's end-to-end flow, Fig. 2c), served by
:class:`repro_torch.engine.QueryEngine` — the port of
``repro.launch.dks_query``:

    python -m repro_torch.launch.dks_query --dataset sec-rdfabout \\
        --query 3,17,42 --k 2 --backend cuda

``--device`` defaults to the card; ``--device cpu`` runs the plain torch
path.  ``--stream`` prints per-superstep approximate answers with the
paper's early-termination bound (SPA ratio).  ``--explain`` serves the
query through a one-shot :class:`DKSService` and prints the request's
span tree.  ``--telemetry`` carries the per-superstep counters through the
driver's loop in a device buffer and prints the frontier/message table.
``--extract`` prints label-rendered answer trees.  ``--parity`` (with
``--backend cuda``) builds a ``"torch"`` twin and asserts bit-identical
top-K weights and superstep counts.  ``--partition sharded`` runs the
frontier-compressed sharded partition (one shard per CUDA device, one on
the CPU; its backend is ``"torch"``).  ``--artifact PATH`` mmap-loads a
graph-store artifact (``python -m repro_torch.launch.ingest`` writes one;
so does ``repro.launch.ingest``: the format is shared) instead of
generating ``--dataset``.
"""

from __future__ import annotations

import argparse
import time

from repro_torch import INF
from repro_torch.configs import DKS_CONFIGS
from repro_torch.engine import ExecutionPolicy, QueryEngine, WeightPolicy
from repro_torch.graph.generators import lod_like_graph
from repro_torch.graph.index import InvertedIndex, mid_df_tokens


def add_weight_policy_args(ap: argparse.ArgumentParser) -> None:
    """The shared --weight-policy / --blend / --predicate-filter flags
    (dks_query and serve_dks accept the same provenance-ranking knobs)."""
    ap.add_argument("--weight-policy", default="degree",
                    choices=["degree", "confidence"],
                    help="edge-weight semantics: 'degree' = the stored "
                         "(paper Sec. 7.1) weights; 'confidence' = blend "
                         "per-edge provenance into the length "
                         "(w / conf**blend) — needs a typed graph")
    ap.add_argument("--blend", type=float, default=1.0,
                    help="confidence exponent for --weight-policy "
                         "confidence (higher = provenance bites harder)")
    ap.add_argument("--predicate-filter", default=None,
                    help="comma-separated predicate names to allow; edges "
                         "with any other predicate are disconnected (INF) "
                         "— needs a typed graph")


def weight_policy_from_args(args) -> WeightPolicy:
    preds = None
    if args.predicate_filter:
        preds = tuple(p.strip() for p in args.predicate_filter.split(",")
                      if p.strip())
    return WeightPolicy(kind=args.weight_policy, blend=args.blend,
                        predicates=preds)


def load_dataset(name: str):
    ds = DKS_CONFIGS[name]
    g, tokens = lod_like_graph(ds.n_nodes, ds.n_edges, seed=ds.seed,
                               vocab=ds.vocab, tau=ds.tau)
    index = InvertedIndex.from_token_matrix(tokens)
    return ds, g, index


def engine_source(name: str, artifact: str | None = None):
    """Dataset name (or artifact path) -> (dataset config, the
    ``QueryEngine.build`` arguments that name the graph).  An artifact's
    graph and persisted index mmap-load straight into the engine; ``name``
    then only names the printed config."""
    if artifact is not None:
        from repro_torch.store import open_artifact
        return DKS_CONFIGS.get(name), {"artifact": open_artifact(artifact)}
    ds, g, index = load_dataset(name)
    return ds, {"graph": g, "index": index}


def add_partition_args(ap: argparse.ArgumentParser) -> None:
    """``--backend`` and ``--partition``, shared with ``serve_dks``."""
    ap.add_argument("--backend", default=None, choices=["torch", "cuda"],
                    help='default "cuda"; "torch" under --partition '
                         "sharded, its only backend")
    ap.add_argument("--partition", default="single",
                    choices=["single", "sharded"],
                    help="sharded = the frontier-compressed partition "
                         "(one shard per CUDA device, one on the CPU; all "
                         "on the engine's device)")


def resolve_backend(ap: argparse.ArgumentParser,
                    args: argparse.Namespace) -> None:
    """Fill in ``args.backend``'s default for the partition; refuse
    ``cuda`` with ``sharded`` (the shard body is stock torch)."""
    if args.backend is None:
        args.backend = "torch" if args.partition == "sharded" else "cuda"
    elif args.backend == "cuda" and args.partition == "sharded":
        ap.error("--partition sharded runs on --backend torch only: the "
                 "fused CUDA kernel is dense-only")


def describe_partition(engine: QueryEngine) -> str:
    """One line on a sharded engine's layout."""
    fg = engine.device_graph
    return (f"partition: sharded, {fg.n_shards} shard(s) of {fg.n_loc:,} "
            f"nodes, e_cap {fg.e_cap:,}, backend {engine.policy.backend}")


def build_engine(name: str, policy: ExecutionPolicy | None = None,
                 device=None, artifact: str | None = None):
    """Dataset name (or artifact path) -> (dataset config, ready engine on
    ``device``; None is the card)."""
    ds, source = engine_source(name, artifact)
    return ds, QueryEngine.build(**source, policy=policy, device=device)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="sec-rdfabout-cpu",
                    choices=sorted(DKS_CONFIGS))
    ap.add_argument("--artifact", default=None,
                    help="path to a graph-store artifact: mmap-load the "
                         "graph + persisted index instead of generating "
                         "--dataset (python -m repro_torch.launch.ingest "
                         "writes one)")
    ap.add_argument("--query", default=None,
                    help="comma-separated token ids (default: auto-pick)")
    ap.add_argument("--m", type=int, default=3,
                    help="number of keywords when auto-picking")
    ap.add_argument("--k", type=int, default=2)
    ap.add_argument("--max-supersteps", type=int, default=32)
    ap.add_argument("--message-budget", type=float, default=float("inf"))
    ap.add_argument("--exit-mode", default="sound",
                    choices=["sound", "none"])
    add_partition_args(ap)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, cuda:0)")
    add_weight_policy_args(ap)
    ap.add_argument("--stream", action="store_true",
                    help="print per-superstep answers with SPA bounds")
    ap.add_argument("--explain", action="store_true",
                    help="serve the query through a one-shot DKSService "
                         "and print its trace span tree with durations")
    ap.add_argument("--telemetry", action="store_true",
                    help="carry per-superstep counters in the driver's "
                         "loop and print the frontier/message table "
                         "(bit-identical answers)")
    ap.add_argument("--extract", action="store_true",
                    help="print label-rendered answer trees instead of "
                         "raw int ids")
    ap.add_argument("--parity", action="store_true",
                    help="with --backend cuda: build a torch twin engine "
                         "and assert bit-identical top-K weights and "
                         "superstep count")
    args = ap.parse_args(argv)
    resolve_backend(ap, args)
    if args.explain and args.stream:
        ap.error("--explain and --stream are mutually exclusive "
                 "(streaming runs outside the serving path)")
    if args.telemetry and args.stream:
        ap.error("--telemetry and --stream are mutually exclusive "
                 "(streaming is already per-superstep)")
    if args.parity and args.backend != "cuda":
        ap.error("--parity needs --backend cuda (it builds the torch twin "
                 "to compare against)")

    t0 = time.time()
    policy = ExecutionPolicy(
        backend=args.backend,
        partition=args.partition,
        exit_mode=args.exit_mode,
        max_supersteps=args.max_supersteps,
        message_budget=args.message_budget,
        weights=weight_policy_from_args(args),
        telemetry=args.telemetry,
    )
    ds, source = engine_source(args.dataset, args.artifact)
    engine = QueryEngine.build(**source, policy=policy, device=args.device)
    print(f"loaded {args.artifact or ds.name}: V={engine.n_nodes:,} E_sym={engine.n_edges:,} "
          f"on {engine.device} ({time.time()-t0:.1f}s)")
    if policy.partition == "sharded":
        print(describe_partition(engine))
    if not policy.weights.is_default:
        print(f"weight policy: {policy.weights}")

    index = engine.index
    if args.query:
        def parse_token(t: str):
            # Int ids for synthetic token-matrix vocabularies; the literal
            # string when only it is in the vocabulary (ingested dumps
            # index label text, numeric strings included).
            if t.lstrip("-").isdigit():
                ti = int(t)
                if index.df(ti) == 0 and index.df(t) > 0:
                    return t
                return ti
            return t

        query = [parse_token(t) for t in args.query.split(",")]
    else:
        mid = mid_df_tokens(index)
        query = mid[:: max(1, len(mid) // args.m)][: args.m]
    print("query tokens:", query, "df:", [index.df(t) for t in query])

    if args.stream:
        def show(upd):
            best = "-" if upd.best_weight >= INF else f"{upd.best_weight:g}"
            ratio = ("inf" if upd.spa_ratio == float("inf")
                     else f"{upd.spa_ratio:.3f}")
            print(f"  step {upd.step:2d} frontier={upd.frontier:6d} "
                  f"best={best:>6} spa-ratio={ratio}"
                  f"{'  [exit]' if upd.done else ''}")

        res = engine.query_streamed(query, k=args.k, on_update=show)
    elif args.explain:
        # One-shot service: the query takes the real serving path, so the
        # printed span tree has the anatomy production traces have.
        from repro_torch.obs import render_span_tree
        from repro_torch.serve import DKSService, ServeConfig
        with DKSService(engine, ServeConfig(
                max_batch=1, max_wait_ms=0.0)) as svc:
            served = svc.query(query, k=args.k)
            trace = svc.trace(served.trace_id)
        res = served.result
        print("\n--- request trace ---")
        print(render_span_tree(trace))
    else:
        res = engine.query(query, k=args.k)
    if res.telemetry is not None:
        tel = res.telemetry
        print(f"\n--- superstep telemetry ({tel.n_steps} steps"
              f"{', truncated' if tel.truncated else ''}) ---")
        print("  step  frontier  msgs_bfs     msgs_deep    frozen")
        for row in tel.rows():
            print(f"  {row['step']:4d}  {row['frontier']:8d}  "
                  f"{row['msgs_bfs']:11,.0f}  {row['msgs_deep']:11,.0f}  "
                  f"{int(tel.frozen[row['step'] - 1]):6d}")
    print(f"\nDKS finished in {res.supersteps} supersteps, "
          f"{res.wall_time_s:.2f}s")
    print(f"messages: bfs={res.msgs_bfs:,.0f} deep={res.msgs_deep:,.0f} "
          f"({100*res.msgs_total/max(engine.n_edges,1):.1f}% of |E|)")
    print(f"explored {100*res.explored_frac:.1f}% of nodes")
    if res.budget_hit:
        print(f"budget hit: SPA-ratio={res.spa_ratio:.3f}")
    elif res.capped:
        print(f"superstep cap hit: SPA-ratio={res.spa_ratio:.3f}")

    if args.parity:
        import dataclasses

        import numpy as np
        twin = QueryEngine.build(
            **source, policy=dataclasses.replace(policy, backend="torch"),
            device=engine.device)
        ref = twin.query(query, k=args.k)
        if not np.array_equal(res.weights, ref.weights):
            raise AssertionError(
                f"cuda/torch weights diverged: {res.weights} vs "
                f"{ref.weights}")
        if res.supersteps != ref.supersteps:
            raise AssertionError(
                f"cuda/torch superstep counts diverged: "
                f"{res.supersteps} vs {ref.supersteps}")
        print(f"\nparity: cuda == torch bit-identical "
              f"(top-{args.k} weights, {res.supersteps} supersteps)")

    print("\ntop answers (weights):", [w for w in res.weights if w < 1e8])
    if args.extract:
        from repro_torch.answers import render_tree
        if res.answers and res.answers_exhausted:
            print(f"(table holds fewer than k={args.k} distinct trees)")
        for i, a in enumerate(res.answers):
            rt = render_tree(a, label_fn=engine.node_label,
                             graph=engine.graph)
            print(f"  #{i+1} {rt.describe()}")
    else:
        for i, a in enumerate(res.answers):
            print(f"  #{i+1} weight={a.weight} root={a.root} "
                  f"edges={list(a.edges)[:8]}"
                  f"{'...' if len(a.edges) > 8 else ''}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
