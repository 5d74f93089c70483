"""Port parity of the graph store (``repro_torch.store`` against
``repro.store``), on the CPU: the on-disk artifact is the interchange
between the two packages, so an artifact written by either opens in the
other with the same bytes and the same ``content_hash``, and engines built
from it answer bit-identically to graph-built engines on both packages.
Also the readers (ids, names, labels and predicate tables equal to
``repro``'s), the lazy index, validation errors, cache tokens, the CPU
path off read-only mmaps, and the ingest CLI."""

import json
import warnings

import numpy as np
import pytest

from repro.engine import ExecutionPolicy as PolicyJ
from repro.engine import QueryEngine as EngineJ
from repro.graph import generators as gen_j
from repro.graph.structure import build_graph as build_graph_j
from repro.store import from_graph as from_graph_j
from repro.store import ingest_ntriples as ingest_ntriples_j
from repro.store import ingest_tsv as ingest_tsv_j
from repro.store import open_artifact as open_artifact_j
from repro.store import write_artifact as write_artifact_j

from repro_torch.engine import ExecutionPolicy, QueryEngine
from repro_torch.graph import generators as gen_t
from repro_torch.graph.index import InvertedIndex
from repro_torch.graph.structure import build_graph
from repro_torch.launch import ingest as ingest_cli
from repro_torch.serve import ResultCache
from repro_torch.store import (ArtifactError, ChecksumError,
                               FormatVersionError, LazyArtifactIndex,
                               StreamIngestor, from_graph, ingest_ntriples,
                               ingest_tsv, open_artifact, write_artifact,
                               write_tsv)
from repro_torch.store.ingest import IngestStats

N_NODES, N_EDGES, VOCAB, SEED = 600, 1800, 120, 11

PACKAGES = {
    "port": (gen_t, from_graph, write_artifact, open_artifact),
    "repro": (gen_j, from_graph_j, write_artifact_j, open_artifact_j),
}


def write_synthetic(package: str, path, seed: int = SEED):
    """The same seeded graph, ingested and written by ``package``."""
    gen, fg, write, _ = PACKAGES[package]
    g, tokens = gen.lod_like_graph(N_NODES, N_EDGES, seed=seed, vocab=VOCAB)
    result = fg(g, tokens=tokens, edges_requested=N_EDGES)
    return result, write(path, result.graph, result.index, tau=result.tau,
                         stats=result.stats.as_dict())


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("store")
    result, artifact = write_synthetic("port", tmp / "port")
    result_j, artifact_j = write_synthetic("repro", tmp / "repro")
    return result, artifact, result_j, artifact_j


def mid_df_queries(index, n=4, ms=(2, 3)):
    toks = [t for t in sorted(index.vocabulary(), key=index.df)
            if 2 <= index.df(t) <= 60]
    queries = []
    for i in range(n):
        m = ms[i % len(ms)]
        q = toks[i * 2: i * 2 + m]
        assert len(q) == m
        queries.append(q)
    return queries


def assert_same_result(ra, rb, query):
    np.testing.assert_array_equal(ra.weights, rb.weights,
                                  err_msg=f"weights diverged for {query!r}")
    np.testing.assert_array_equal(ra.roots, rb.roots)
    for f in ("supersteps", "spa", "spa_ratio", "done", "budget_hit",
              "capped", "msgs_bfs", "msgs_deep"):
        assert getattr(ra, f) == getattr(rb, f), (f, query)
    assert [(a.root, tuple(a.edges), a.weight) for a in ra.answers] == \
        [(a.root, tuple(a.edges), a.weight) for a in rb.answers], query


def artifact_bytes(path) -> dict[str, bytes]:
    return {p.name: p.read_bytes() for p in sorted(path.iterdir())}


@pytest.mark.parametrize("writer,reader", [("port", "repro"),
                                           ("repro", "port")])
def test_artifact_opens_in_the_other_package(setup, writer, reader):
    """Byte-identical artifacts from the same graph, and each package's
    artifact opens in the other under the same content_hash, with equal
    buffers, index and metadata."""
    _, artifact, _, artifact_j = setup
    assert artifact_bytes(artifact.path) == artifact_bytes(artifact_j.path)
    written = {"port": artifact, "repro": artifact_j}[writer]
    opened = PACKAGES[reader][3](written.path, verify="full")
    assert opened.content_hash == written.content_hash
    assert opened.manifest == written.manifest
    for name in ("src", "dst", "indptr", "indices", "ew", "sym_src",
                 "sym_w", "post_offsets", "post_nodes", "token_keys"):
        np.testing.assert_array_equal(opened.buffer(name),
                                      written.buffer(name))
    assert opened.index().to_postings()[0] == \
        written.index().to_postings()[0]


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_artifact_roundtrip_bit_identical(setup, backend):
    """graph -> artifact -> mmap -> engine answers as the in-memory build
    on both packages, and the port's engine as repro's: weights, roots,
    supersteps, messages, flags and answer trees."""
    result, artifact, result_j, artifact_j = setup
    policy = ExecutionPolicy(max_supersteps=32, backend=backend)
    e_mem = QueryEngine.build(result.graph, index=result.index,
                              policy=policy, device="cpu")
    # The port opens repro's artifact (same bytes as its own).
    e_art = QueryEngine.build(artifact=artifact_j.path, policy=policy,
                              device="cpu")
    ref = EngineJ.build(artifact=open_artifact_j(artifact.path),
                        policy=PolicyJ(max_supersteps=32))
    assert e_art.n_nodes == e_mem.n_nodes and e_art.n_edges == e_mem.n_edges
    assert e_art.version == ref.version == f"artifact:{artifact.content_hash}"
    for q in mid_df_queries(result.index)[:2]:
        ra = e_mem.query(q, k=2)
        rb = e_art.query(q, k=2)
        assert_same_result(ra, rb, q)
        assert_same_result(rb, ref.query(q, k=2), q)
    # Forced stop (superstep cap) survives the roundtrip.
    q = mid_df_queries(result.index)[0]
    assert_same_result(e_mem.query(q, k=1, max_supersteps=2),
                       e_art.query(q, k=1, max_supersteps=2), q)
    # The batched backtracer reads the mmapped CSR.
    batch = mid_df_queries(result.index, n=4, ms=(2,))
    for ra, rb in zip(e_mem.query_batch(batch, k=2),
                      e_art.query_batch(batch, k=2)):
        assert_same_result(ra, rb, "batch")


def test_cpu_engine_off_read_only_mmaps(setup):
    """The CPU path copies read-only buffers instead of aliasing them: no
    non-writable-array warning, every device tensor writable in place, and
    the artifact's bytes unchanged."""
    _, artifact, _, _ = setup
    before = artifact_bytes(artifact.path)
    art = open_artifact(artifact.path)
    assert not art.buffer("indptr").flags.writeable
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        engine = QueryEngine.build(artifact=art, device="cpu")
        bt = engine._backtracer()
    tensors = [bt._indptr, bt._esrc, bt._ew, engine.device_graph.src,
               engine.device_graph.w, engine.device_graph.in_offsets]
    for t in tensors:
        t.add_(1)
        t.sub_(1)
    assert not np.shares_memory(bt._indptr.numpy(), art.buffer("indptr"))
    q = mid_df_queries(engine.index, n=1)[0]
    assert engine.query_batch([q], k=2)[0].found
    assert artifact_bytes(artifact.path) == before


def test_index_persistence_token_matrix(setup):
    result, artifact, _, _ = setup
    orig = result.index
    loaded = open_artifact(artifact.path).index()
    assert sorted(loaded.vocabulary()) == sorted(orig.vocabulary())
    for tok in orig.vocabulary():
        np.testing.assert_array_equal(loaded.lookup(tok), orig.lookup(tok))
        assert loaded.df(tok) == orig.df(tok)
    missing = 10_000
    assert loaded.missing_tokens([missing]) == [missing]
    q = [orig.vocabulary()[0], missing]
    with pytest.raises(KeyError):
        loaded.keyword_masks(q, N_NODES)
    np.testing.assert_array_equal(
        loaded.keyword_masks(q, N_NODES, v_pad=640, on_missing="ignore"),
        orig.keyword_masks(q, N_NODES, v_pad=640, on_missing="ignore"))


@pytest.mark.parametrize("writer", ["port", "repro"])
def test_index_persistence_labels(tmp_path, writer):
    """String-token indexes and the label text survive save/load, written
    by either package and read by the port."""
    labels = ["paris piano", "piano bar", "tour eiffel paris", "", "bar"]
    src, dst = [0, 1, 2, 3], [1, 2, 3, 4]
    if writer == "port":
        g = build_graph(src, dst, 5, labels=labels)
        art = write_artifact(tmp_path / "a", g,
                             InvertedIndex.from_labels(labels))
    else:
        from repro.graph.index import InvertedIndex as IndexJ
        g = build_graph_j(src, dst, 5, labels=labels)
        art = write_artifact_j(tmp_path / "a", g, IndexJ.from_labels(labels))
    orig = InvertedIndex.from_labels(labels)
    opened = open_artifact(art.path, verify="full")
    assert opened.content_hash == art.content_hash
    loaded = opened.index()
    assert sorted(loaded.vocabulary()) == sorted(orig.vocabulary())
    for tok in orig.vocabulary():
        np.testing.assert_array_equal(loaded.lookup(tok), orig.lookup(tok))
    assert loaded.missing_tokens(["paris", "nope"]) == ["nope"]
    with pytest.raises(KeyError):
        loaded.keyword_masks(["nope"], 5)
    assert opened.labels() == labels
    assert [opened.label(i) for i in range(5)] == labels


def test_artifact_validation_errors(tmp_path, setup):
    result, _, _, _ = setup
    art = write_artifact(tmp_path / "a", result.graph, result.index)
    with pytest.raises(ArtifactError):
        write_artifact(tmp_path / "a", result.graph, result.index)
    with pytest.raises(ArtifactError):
        open_artifact(tmp_path / "nope")
    with pytest.raises(ValueError, match="verify"):
        open_artifact(art.path, verify="bogus")
    buf = art.path / "post_nodes.npy"
    raw = bytearray(buf.read_bytes())
    raw[-1] ^= 0xFF
    buf.write_bytes(bytes(raw))
    open_artifact(art.path)  # header/shape still fine
    with pytest.raises(ChecksumError):
        open_artifact(art.path, verify="full")
    manifest = json.loads((art.path / "manifest.json").read_text())
    manifest["format_version"] = 99
    (art.path / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(FormatVersionError):
        open_artifact(art.path)
    manifest["format_version"] = 1
    manifest["magic"] = "something-else"
    (art.path / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(FormatVersionError):
        open_artifact(art.path)
    # The engine's artifact= mode takes the artifact alone.
    with pytest.raises(ValueError, match="artifact= alone"):
        QueryEngine.build(result.graph, artifact=art, device="cpu")
    with pytest.raises(ValueError, match="graph= or artifact="):
        QueryEngine.build(device="cpu")


def test_cache_token_keyed_on_artifact_hash(tmp_path, setup):
    """A ResultCache keyed through cache_token misses across artifacts and
    hits across rebuilds of the same one; graph-built engines keep
    monotone int versions."""
    result, artifact, _, _ = setup
    _, art2 = write_synthetic("port", tmp_path / "other", seed=12)
    assert art2.content_hash != artifact.content_hash
    e_a = QueryEngine.build(artifact=open_artifact(artifact.path),
                            device="cpu")
    e_a2 = QueryEngine.build(artifact=artifact.path, device="cpu")
    e_b = QueryEngine.build(artifact=art2, device="cpu")
    q = mid_df_queries(result.index, n=1)[0]
    assert e_a.version == f"artifact:{artifact.content_hash}"
    assert e_a.graph_hash == artifact.content_hash
    assert e_a.artifact is not None
    cache = ResultCache(capacity=8)
    cache.put(e_a.cache_token(q, 1), "answer-from-artifact-A")
    assert cache.get(e_a2.cache_token(q, 1)) == "answer-from-artifact-A"
    assert cache.get(e_b.cache_token(q, 1)) is None
    e_mem = QueryEngine.build(result.graph, index=result.index, device="cpu")
    assert isinstance(e_mem.version, int) and e_mem.graph_hash is None
    assert cache.get(e_mem.cache_token(q, 1)) is None


NT = (
    '<http://ex.org/Alice_Smith> <http://ex.org/p#knows> '
    '<http://ex.org/Bob> .\n'
    '<http://ex.org/Bob> <http://ex.org/p#likes> "piano \\"jazz\\""@en .\n'
    '# a comment line\n'
    '\n'
    '<http://ex.org/Bob> <http://ex.org/p#knows> <http://ex.org/Carol> 0.7 .\n'
    'this line is malformed\n'
    '<http://ex.org/Loop> <http://ex.org/p#self> <http://ex.org/Loop> .\n'
    '_:b1 <http://ex.org/p#cites> <http://ex.org/Carol> "0.5"^^<x:double> .\n')


def assert_same_ingest(rt, rj):
    assert rt.names == rj.names
    assert rt.graph.labels == rj.graph.labels
    assert rt.graph.pred_names == rj.graph.pred_names
    for f in ("src", "dst", "w", "indptr", "indices", "ew", "pred", "conf",
              "csr_pred", "csr_conf"):
        a, b = getattr(rt.graph, f), getattr(rj.graph, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f)
    st, sj = rt.stats.as_dict(), rj.stats.as_dict()
    for d in (st, sj):
        d.pop("ingest_s"), d.pop("edges_per_s")
    assert st == sj
    assert sorted(rt.index.vocabulary()) == sorted(rj.index.vocabulary())
    for tok in rj.index.vocabulary():
        np.testing.assert_array_equal(rt.index.lookup(tok),
                                      rj.index.lookup(tok))


def test_ntriples_reader_matches_reference(tmp_path):
    nt = tmp_path / "d.nt"
    nt.write_text(NT)
    res = ingest_ntriples(nt)
    assert_same_ingest(res, ingest_ntriples_j(nt))
    st = res.stats
    assert (st.lines_read, st.statements, st.malformed_lines,
            st.self_loops_dropped, st.edges_directed) == (8, 5, 1, 1, 4)
    assert res.graph.typed and st.n_predicates == 4
    assert res.index.df("alice") == 1 and res.index.df("piano") == 1
    engine = QueryEngine.build(res.graph, index=res.index, device="cpu")
    assert engine.query(["alice", "bob"], k=1, extract=False).weights[0] \
        == 1.0
    with pytest.raises(ValueError):
        ingest_ntriples(nt, on_error="raise")


def test_tsv_reader_chunking_and_gz_match_reference(tmp_path):
    import gzip

    src, dst = gen_t.rmat_edges(300, 900, seed=5)
    tsv = tmp_path / "e.tsv"
    assert write_tsv(tsv, src, dst) == 900
    res = ingest_tsv(tsv, chunk_edges=128, spill_dir=tmp_path / "spill")
    assert res.stats.chunks >= 7 and res.stats.spilled_chunks > 0
    assert_same_ingest(res, ingest_tsv_j(tsv, chunk_edges=128,
                                         spill_dir=tmp_path / "spill_j"))
    res_big = ingest_tsv(tsv)
    assert res_big.stats.spilled_chunks == 0
    np.testing.assert_array_equal(res.graph.indices, res_big.graph.indices)
    gz = tmp_path / "e.tsv.gz"
    with gzip.open(gz, "wt") as f:
        f.write(tsv.read_text())
    assert_same_ingest(ingest_tsv(gz), ingest_tsv_j(gz))
    typed = tmp_path / "t.tsv"
    write_tsv(typed, [0, 1, 2], [1, 2, 3], pred=["a", "b", "a"],
              conf=[1.0, 0.5, 0.25])
    assert_same_ingest(ingest_tsv(typed), ingest_tsv_j(typed))


def test_ingestor_bad_args():
    with pytest.raises(ValueError):
        StreamIngestor(chunk_edges=0)
    ing = StreamIngestor()
    ing.add_edge("a", "b")
    ing._labels.clear()
    with pytest.raises(ValueError, match="labels"):
        ing.finalize(IngestStats(source="x"))
    with pytest.raises(ValueError):
        ingest_tsv("unused.tsv", on_error="bogus")


def test_from_graph_records_true_counts(setup):
    result, artifact, result_j, _ = setup
    assert result.stats.as_dict() == result_j.stats.as_dict()
    assert result.stats.edges_requested == N_EDGES
    assert result.stats.edges_directed == N_EDGES
    assert artifact.stats["edges_requested"] == N_EDGES
    g, _ = gen_t.lod_like_graph(20, 40, seed=1, vocab=5)
    with pytest.raises(ValueError, match="tokens="):
        from_graph(g)


def test_artifact_atomic_overwrite(tmp_path, setup):
    result, _, _, _ = setup
    art1 = write_artifact(tmp_path / "a", result.graph, result.index)
    art2 = write_artifact(tmp_path / "a", result.graph, result.index,
                          overwrite=True)
    assert art2.content_hash == art1.content_hash
    assert not list(tmp_path.glob("*.tmp-*"))


def test_lazy_index_binary_search(setup, tmp_path):
    """artifact.index() builds no token dict: lookups binary-search the
    mmapped sorted token table, with clean misses below, above and between
    keys and on wrong-type probes — as repro's lazy index does."""
    result, artifact, _, _ = setup
    loaded = open_artifact(artifact.path).index()
    assert isinstance(loaded, LazyArtifactIndex)
    assert loaded._frozen == {}
    vocab = sorted(result.index.vocabulary())
    assert loaded.df(vocab[0]) == result.index.df(vocab[0])
    assert loaded.lookup(min(vocab) - 1).size == 0
    assert loaded.lookup(max(vocab) + 1000).size == 0
    assert loaded.lookup("not-an-int").size == 0
    assert loaded.token_dfs() == open_artifact_j(
        artifact.path).index().token_dfs()

    labels = ["alpha beta", "beta gamma", "zeta alpha"]
    g = build_graph([0, 1], [1, 2], 3, labels=labels)
    art = write_artifact(tmp_path / "s", g, InvertedIndex.from_labels(labels))
    li = open_artifact(art.path).index()
    ref = open_artifact_j(art.path).index()
    for probe in ("aaaa", "zzzz", "bet", 123, "beta", "alpha", "zeta"):
        np.testing.assert_array_equal(li.lookup(probe), ref.lookup(probe))
    np.testing.assert_array_equal(li.lookup("beta"), [0, 1])
    assert li.vocabulary() == ref.vocabulary()


def test_ingest_cli_smoke(capsys):
    """``python -m repro_torch.launch.ingest --smoke --device cpu``: the
    roundtrip, typed and delta legs hold their invariants."""
    assert ingest_cli.main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for leg in ("ingest smoke invariants hold",
                "typed smoke invariants hold",
                "delta smoke invariants hold"):
        assert leg in out, leg


def test_ingest_cli_dataset_hash_matches_reference(tmp_path, capsys,
                                                   monkeypatch):
    """The CLI's synthetic dataset path writes the artifact repro writes
    (same content_hash), and its roundtrip runs on the asked device."""
    from repro_torch.configs import DKSBenchConfig
    from repro_torch.launch import dks_query
    tiny = DKSBenchConfig(name="tiny", n_nodes=N_NODES, n_edges=N_EDGES,
                          vocab=VOCAB, seed=SEED)
    monkeypatch.setitem(ingest_cli.DKS_CONFIGS, "tiny", tiny)
    assert ingest_cli.main(["--dataset", "tiny", "--out",
                            str(tmp_path / "a"), "--device", "cpu"]) == 0
    assert "bit-identical" in capsys.readouterr().out
    art = open_artifact(tmp_path / "a")
    g, tokens = gen_j.lod_like_graph(N_NODES, N_EDGES, seed=SEED,
                                     vocab=VOCAB)
    res_j = from_graph_j(g, tokens=tokens)
    ref = write_artifact_j(tmp_path / "ref", res_j.graph, res_j.index)
    assert art.content_hash == ref.content_hash
    # dks_query --artifact serves it, cuda == torch on the CPU.
    monkeypatch.setitem(dks_query.DKS_CONFIGS, "tiny", tiny)
    assert dks_query.main(["--artifact", str(tmp_path / "a"), "--device",
                           "cpu", "--k", "2", "--parity", "--extract"]) == 0
    out = capsys.readouterr().out
    assert "parity: cuda == torch bit-identical" in out
    assert "DKS finished in" in out
