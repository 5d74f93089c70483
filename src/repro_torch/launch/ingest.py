"""Ingestion CLI: generate-or-read -> stream-ingest -> write artifact ->
mmap reopen -> verify roundtrip query parity — the port of
``repro.launch.ingest``.  ``--device`` says where the verification engines
run (default: the card; ``--device cpu`` runs the plain torch path).

    # synthetic LOD stand-in -> artifact
    python -m repro_torch.launch.ingest --dataset sec-rdfabout-cpu \
        --out artifacts/sec-rdfabout-cpu

    # real dumps (N-Triples or TSV edge list, .gz transparently)
    python -m repro_torch.launch.ingest --input dump.nt.gz \
        --out artifacts/dump

    # live graph: initialize once, then append fragments as deltas
    python -m repro_torch.launch.ingest --input dump.nt.gz --live live/
    python -m repro_torch.launch.ingest --live live/ --append edits-0042.nt
    python -m repro_torch.launch.ingest --live live/ --compact

    # CI smoke: tiny graph, temp dir, hard asserts on parity + checksums
    # (includes the delta leg: base -> append -> chain parity vs union)
    python -m repro_torch.launch.ingest --smoke

The verification pass builds TWO engines — one from the reopened mmapped
artifact, one from the in-memory graph — and asserts bit-identical query
weights/supersteps on auto-picked queries: the artifact roundtrip must be
invisible to the engine.  The written artifact is then the input for
``python -m repro_torch.launch.dks_query --artifact ...`` and
``python -m repro_torch.launch.serve_dks --artifact ...``.
"""

from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import numpy as np

from repro_torch.configs import DKS_CONFIGS
from repro_torch.engine import ExecutionPolicy, QueryEngine
from repro_torch.graph.generators import lod_like_graph
from repro_torch.graph.index import mid_df_tokens
from repro_torch.store import (
    from_graph,
    ingest_ntriples,
    ingest_tsv,
    open_artifact,
    open_chain,
    write_artifact,
)


def pick_queries(index, n: int = 3, ms: tuple = (2, 3)) -> list[list]:
    """Auto-pick verification queries from the shared mid-df pool
    (:func:`repro_torch.graph.index.mid_df_tokens` — the same pool the query
    CLI auto-picks from)."""
    mid = mid_df_tokens(index)
    queries = []
    for i in range(n):
        m = ms[i % len(ms)]
        step = max(1, len(mid) // (m * (i + 2)))
        q = mid[i::step][:m]
        if len(q) == m:
            queries.append(q)
    return queries


def verify_roundtrip(result, artifact, *, n_queries: int = 3,
                     max_supersteps: int = 16, device=None) -> int:
    """Assert mmap-loaded artifact queries == in-memory build queries,
    bit-identical, both engines on ``device`` (None: the card).  Returns
    the number of queries checked."""
    policy = ExecutionPolicy(max_supersteps=max_supersteps)
    e_mem = QueryEngine.build(result.graph, index=result.index,
                              policy=policy, device=device)
    e_art = QueryEngine.build(artifact=artifact, policy=policy,
                              device=device)
    assert e_art.graph_hash == artifact.content_hash
    queries = pick_queries(e_mem.index, n=n_queries)
    assert queries, "no usable verification queries in the vocabulary"
    for q in queries:
        r_mem = e_mem.query(q, k=2, extract=False)
        r_art = e_art.query(q, k=2, extract=False)
        np.testing.assert_array_equal(
            r_mem.weights, r_art.weights,
            err_msg=f"artifact parity broke for query {q!r}")
        assert r_mem.supersteps == r_art.supersteps, q
        assert r_mem.spa == r_art.spa and r_mem.spa_ratio == r_art.spa_ratio
    return len(queries)


def _typed_fixture_lines() -> list[str]:
    """A small typed N-Triples fixture: a ``knows`` backbone (so a
    predicate-filtered engine stays connected), ``cites``/``funds`` cross
    edges, and N-Quads-style numeric 4th terms on some statements (the
    reader's per-statement confidence convention)."""
    def uri(i: int) -> str:
        return f"<http://x.example/e{i}>"

    lines = []
    n = 24
    for i in range(n - 1):   # knows backbone, alternating confidences
        conf = " 0.9" if i % 2 else ""
        lines.append(f"{uri(i)} <http://p.example/knows> {uri(i+1)}{conf} .")
    for i in range(0, n - 6, 3):   # cites cross edges, explicit confidence
        lines.append(f"{uri(i)} <http://p.example/cites> {uri(i+6)} "
                     f"\"0.5\"^^<http://www.w3.org/2001/XMLSchema#double> .")
    for i in range(0, n - 9, 4):   # funds long-range edges, high confidence
        lines.append(f"{uri(i)} <http://p.example/funds> {uri(i+9)} 4 .")
    return lines


def typed_smoke(tmp: Path, *, max_supersteps: int = 16,
                device=None) -> None:
    """Smoke leg for the typed edge channel: ingest a confidence-annotated
    N-Triples fixture, persist + reopen the v2 artifact, and assert (a)
    the predicate dictionary survives into the manifest, (b) default and
    predicate-filtered queries are bit-identical between the in-memory
    build and the mmapped artifact engine, and (c) a filtered engine's
    rendered trees carry only allowed predicates."""
    from repro_torch.answers import render_tree
    from repro_torch.graph import WeightPolicy

    fixture = tmp / "typed-fixture.nt"
    fixture.write_text("\n".join(_typed_fixture_lines()) + "\n",
                       encoding="utf-8")
    result = ingest_ntriples(fixture)
    assert result.stats.n_predicates == 3, result.stats.n_predicates
    assert result.graph.typed

    out = tmp / "typed-artifact"
    artifact = write_artifact(out, result.graph, result.index,
                              tau=result.tau,
                              stats=result.stats.as_dict(),
                              names=result.names, overwrite=True)
    reopened = open_artifact(out, verify="full")
    assert reopened.format_version == 2, reopened.format_version
    assert reopened.typed
    assert set(reopened.predicates) == {"knows", "cites", "funds"}, \
        reopened.predicates

    queries = [["e3", "e7"], ["e2", "e10"], ["e1", "e5", "e9"]]
    policies = [
        ExecutionPolicy(max_supersteps=max_supersteps),
        ExecutionPolicy(max_supersteps=max_supersteps,
                        weights=WeightPolicy(predicates=("knows",))),
        ExecutionPolicy(max_supersteps=max_supersteps,
                        weights=WeightPolicy(kind="confidence", blend=1.0)),
    ]
    for policy in policies:
        e_mem = QueryEngine.build(result.graph, index=result.index,
                                  policy=policy, device=device)
        e_art = QueryEngine.build(artifact=reopened, policy=policy,
                                  device=device)
        for q in queries:
            r_mem = e_mem.query(q, k=2, extract=False)
            r_art = e_art.query(q, k=2, extract=False)
            np.testing.assert_array_equal(
                r_mem.weights, r_art.weights,
                err_msg=f"typed artifact parity broke for {q!r} "
                        f"under {policy.weights}")
            assert r_mem.supersteps == r_art.supersteps, (q, policy.weights)

    # Predicate-filtered end-to-end: every rendered edge of every answer
    # tree must carry an allowed predicate.
    filt = QueryEngine.build(
        artifact=reopened,
        policy=ExecutionPolicy(max_supersteps=max_supersteps,
                               weights=WeightPolicy(predicates=("knows",))),
        device=device)
    res = filt.query(["e3", "e7"], k=2)
    assert res.answers, "filtered query returned no answer trees"
    for a in res.answers:
        rt = render_tree(a, label_fn=filt.node_label, graph=filt.graph)
        for e in rt.edges:
            assert e.predicate == "knows", (
                f"filtered tree served a {e.predicate!r} edge: "
                f"{rt.describe()}")
    print(f"typed smoke invariants hold: {result.stats.n_predicates} "
          f"predicates persisted in a format-v{reopened.format_version} "
          f"artifact; default/filtered/confidence parity on "
          f"{len(queries)} queries; filtered trees carry only 'knows' "
          f"edges ({len(res.answers)} trees checked)")


def delta_smoke(tmp: Path, *, max_supersteps: int = 16,
                device=None) -> None:
    """Smoke leg for live graphs: initialize a live dir from the typed
    fixture, append TWO delta fragments (dictionary growth across
    deltas: the second references entities only the first introduced),
    and assert (a) the chain engine is bit-identical to a full union
    re-ingest, (b) a post-delta-only keyword resolves through the lazy
    chain index, (c) compaction reproduces the union artifact's
    ``content_hash`` exactly, and (d) a mis-stacked delta fails loudly,
    naming both hashes."""
    from repro_torch.live import LiveDir
    from repro_torch.store import ArtifactError, ChainIndex, LazyArtifactIndex

    base_lines = _typed_fixture_lines()
    frag1_lines = [
        f"<http://x.example/e{i}> <http://p.example/mentions> "
        f"<http://x.example/fresh{j}> 0.8 ."
        for j, i in enumerate((0, 5, 11))]
    frag2_lines = [   # fresh0 resolves to its delta-1 id; fresh3 is new
        "<http://x.example/fresh0> <http://p.example/knows> "
        "<http://x.example/fresh3> .",
        "<http://x.example/fresh3> <http://p.example/cites> "
        "<http://x.example/e2> 0.6 .",
    ]
    base_nt = tmp / "live-base.nt"
    base_nt.write_text("\n".join(base_lines) + "\n", encoding="utf-8")
    (tmp / "frag1.nt").write_text("\n".join(frag1_lines) + "\n",
                                  encoding="utf-8")
    (tmp / "frag2.nt").write_text("\n".join(frag2_lines) + "\n",
                                  encoding="utf-8")
    union_nt = tmp / "live-union.nt"
    union_nt.write_text(
        "\n".join(base_lines + frag1_lines + frag2_lines) + "\n",
        encoding="utf-8")

    live = LiveDir.initialize(tmp / "live-smoke", ingest_ntriples(base_nt))
    d1 = live.append([tmp / "frag1.nt"])
    d2 = live.append([tmp / "frag2.nt"])
    assert d1 is not None and d2 is not None
    assert d2.base_content_hash != d1.base_content_hash  # stacks on chain
    chain = live.chain()
    assert chain.depth == 2

    union = ingest_ntriples(union_nt)
    policy = ExecutionPolicy(max_supersteps=max_supersteps)
    e_chain = QueryEngine.build(artifact=chain, policy=policy,
                                device=device)
    e_union = QueryEngine.build(union.graph, index=union.index,
                                policy=policy, device=device)
    queries = pick_queries(e_union.index) + [["fresh0", "e3"],
                                             ["fresh3", "e10"]]
    for q in queries:
        r_c = e_chain.query(q, k=2, extract=False)
        r_u = e_union.query(q, k=2, extract=False)
        np.testing.assert_array_equal(
            r_c.weights, r_u.weights,
            err_msg=f"chain/union parity broke for query {q!r}")
        assert r_c.supersteps == r_u.supersteps, q

    # Post-delta-only keywords resolve through the lazy chain index.
    assert isinstance(e_chain.index, ChainIndex)
    assert isinstance(e_chain.index.base_index, LazyArtifactIndex)
    assert e_chain.index.df("fresh3") == 1

    # Compaction == union re-ingest, down to the content hash.
    compacted = live.compact()
    union_art = write_artifact(tmp / "live-union-artifact", union.graph,
                               union.index, tau=union.tau,
                               stats=union.stats.as_dict(),
                               names=union.names)
    assert compacted.content_hash == union_art.content_hash, \
        "compacted chain is not bit-identical to the union re-ingest"

    # Mis-stacked chains fail loudly, naming both hashes.
    try:
        open_chain(live.path / "base-000000", d2.path)
    except ArtifactError as exc:
        assert "mis-stacked" in str(exc), exc
    else:
        raise AssertionError("mis-stacked chain opened without error")
    print(f"delta smoke invariants hold: 2 stacked deltas "
          f"(+V={d1.n_new_nodes + d2.n_new_nodes}, "
          f"+E={d1.n_new_edges + d2.n_new_edges}) bit-identical to the "
          f"union re-ingest on {len(queries)} queries; post-delta "
          f"keywords resolve lazily; compaction reproduced the union "
          f"content hash {union_art.content_hash[:12]}…; mis-stacking "
          f"rejected")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--dataset", default=None,
                     choices=sorted(DKS_CONFIGS),
                     help="synthetic LOD stand-in to generate+ingest "
                          "(default: sec-rdfabout-cpu)")
    src.add_argument("--input", default=None,
                     help="path to an N-Triples or TSV dump (.gz ok)")
    ap.add_argument("--format", default="auto",
                    choices=["auto", "ntriples", "tsv"],
                    help="--input format; auto sniffs the suffix")
    ap.add_argument("--out", default=None,
                    help="artifact directory to write (default: "
                         "experiments/artifacts/<name>)")
    ap.add_argument("--tau", type=int, default=1001,
                    help="hub cutoff for the degree weight model")
    ap.add_argument("--chunk-edges", type=int, default=1 << 20)
    ap.add_argument("--overwrite", action="store_true")
    ap.add_argument("--verify-queries", type=int, default=3,
                    help="roundtrip parity queries (0 skips verification)")
    ap.add_argument("--max-supersteps", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device of the verification engines "
                         "(default: the card, cuda:0)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized run: tiny synthetic graph into a temp "
                         "dir, full-checksum reopen, hard parity asserts")
    ap.add_argument("--live", default=None, metavar="DIR",
                    help="live-graph directory: with --input, initialize "
                         "it; with --append/--compact, grow/fold it")
    ap.add_argument("--append", nargs="+", default=None, metavar="FRAG",
                    help="fragment files to fold into ONE delta on the "
                         "--live chain")
    ap.add_argument("--compact", action="store_true",
                    help="fold the --live chain into a fresh base "
                         "artifact")
    ap.add_argument("--gc", action="store_true",
                    help="after any --append/--compact, delete "
                         "base-*/delta-* directories CHAIN.json no "
                         "longer references")
    ap.add_argument("--gc-keep", type=int, default=1, metavar="N",
                    help="unreferenced directories to retain as an "
                         "in-flight-reader grace window (default 1; "
                         "0 deletes all)")
    args = ap.parse_args(argv)

    if args.append or args.compact or args.gc:
        if args.live is None:
            ap.error("--append/--compact/--gc need --live DIR")
        return _live_update(args)

    tmp_ctx = None
    if args.smoke:
        tmp_ctx = tempfile.TemporaryDirectory(prefix="repro-ingest-smoke-")
        if args.out is None:
            args.out = str(Path(tmp_ctx.name) / "artifact")

    # ---- generate-or-read -> ingest ---------------------------------
    t0 = time.perf_counter()
    if args.input is not None:
        fmt = args.format
        if fmt == "auto":
            stem = args.input[:-3] if args.input.endswith(".gz") else \
                args.input
            fmt = "ntriples" if stem.endswith((".nt", ".ntriples")) else \
                "tsv"
        reader = ingest_ntriples if fmt == "ntriples" else ingest_tsv
        result = reader(args.input, tau=args.tau,
                        chunk_edges=args.chunk_edges)
        name = Path(args.input).name.split(".")[0]
    else:
        if args.smoke:
            n_nodes, n_edges, vocab, seed = 1500, 4500, 200, 11
            name = "smoke"
        else:
            ds = DKS_CONFIGS[args.dataset or "sec-rdfabout-cpu"]
            n_nodes, n_edges, vocab, seed = (ds.n_nodes, ds.n_edges,
                                             ds.vocab, ds.seed)
            name = ds.name
        g, tokens = lod_like_graph(n_nodes, n_edges, seed=seed,
                                   vocab=vocab, tau=args.tau)
        result = from_graph(g, tokens=tokens, tau=args.tau,
                            edges_requested=n_edges,
                            source=f"synthetic:{name}")
        result.stats.ingest_s = time.perf_counter() - t0
    st = result.stats
    print(f"ingested {st.source}: V={st.n_nodes:,} "
          f"E={st.edges_directed:,} directed "
          f"({st.edges_per_s:,.0f} edges/s"
          f"{f', {st.malformed_lines} malformed' if st.malformed_lines else ''}"
          f"{f', {st.self_loops_dropped} self-loops dropped' if st.self_loops_dropped else ''})")
    if st.edges_requested is not None:
        print(f"  requested {st.edges_requested:,} edges, produced "
              f"{st.edges_directed:,} (true counts)")

    # ---- live-dir initialization -------------------------------------
    if args.live is not None:
        from repro_torch.live import LiveDir
        live = LiveDir.initialize(args.live, result,
                                  overwrite=args.overwrite)
        print(f"initialized {live}")
        if args.verify_queries > 0:
            n = verify_roundtrip(result, live.base(),
                                 n_queries=args.verify_queries,
                                 max_supersteps=args.max_supersteps,
                                 device=args.device)
            print(f"verified: {n} queries bit-identical between the live "
                  f"base artifact and the in-memory build")
        return 0

    # ---- write artifact (atomic) -------------------------------------
    out = Path(args.out or (Path("experiments") / "artifacts" / name))
    t0 = time.perf_counter()
    artifact = write_artifact(out, result.graph, result.index,
                              tau=result.tau, stats=st.as_dict(),
                              names=result.names,
                              overwrite=args.overwrite or args.smoke)
    t_write = time.perf_counter() - t0
    print(f"wrote {artifact} ({artifact.nbytes()/1e6:.1f} MB buffers, "
          f"{t_write:.2f}s)")

    # ---- reopen (mmap) + verify --------------------------------------
    t0 = time.perf_counter()
    reopened = open_artifact(out, verify="full" if args.smoke else "meta")
    t_open = time.perf_counter() - t0
    print(f"reopened with mmap in {t_open*1e3:.0f} ms "
          f"(content hash {reopened.content_hash[:12]}…)")

    if args.verify_queries > 0:
        n = verify_roundtrip(result, reopened,
                             n_queries=args.verify_queries,
                             max_supersteps=args.max_supersteps,
                             device=args.device)
        print(f"verified: {n} queries bit-identical between the mmapped "
              f"artifact engine and the in-memory build")

    if args.smoke:
        assert st.edges_requested is None or st.edges_directed == \
            st.edges_requested, "generator undershot the requested edges"
        assert reopened.content_hash == artifact.content_hash
        print("ingest smoke invariants hold: checksum-verified reopen, "
              "query parity, true edge counts")
        typed_smoke(Path(tmp_ctx.name),
                    max_supersteps=args.max_supersteps, device=args.device)
        delta_smoke(Path(tmp_ctx.name),
                    max_supersteps=args.max_supersteps, device=args.device)
        tmp_ctx.cleanup()
    return 0


def _live_update(args) -> int:
    """``--live DIR --append frag…`` / ``--live DIR --compact``."""
    from repro_torch.live import LiveDir

    live = LiveDir(args.live)
    if args.append:
        t0 = time.perf_counter()
        delta = live.append(args.append)
        dt = time.perf_counter() - t0
        if delta is None:
            print(f"no new statements in {len(args.append)} fragment(s) "
                  f"— marked consumed, nothing published")
        else:
            print(f"published {delta} in {dt:.2f}s")
            print(f"chain now: {live.chain()}")
    if args.compact:
        t0 = time.perf_counter()
        art = live.compact()
        dt = time.perf_counter() - t0
        print(f"compacted chain into {art} in {dt:.2f}s")
    if args.gc:
        deleted = live.gc(keep_last=args.gc_keep)
        if deleted:
            print(f"gc: deleted {len(deleted)} superseded "
                  f"director{'y' if len(deleted) == 1 else 'ies'}: "
                  f"{', '.join(deleted)}")
        else:
            print("gc: nothing to delete")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
