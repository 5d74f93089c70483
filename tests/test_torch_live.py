"""Port parity of live graphs (``repro_torch.store.delta`` and
``repro_torch.live`` against ``repro``), on the CPU: delta artifacts and
``CHAIN.json`` byte-identical across the packages, chains bit-identical to
a union re-ingest (answer trees included) and to ``repro``'s chain engine,
compaction hash identity, dictionary growth through the lazy chain index,
the error surfaces, the fragment watcher, ``LiveDir.gc``, zero-downtime
swaps into ``DKSService`` on ``device="cpu"``, and launch counts that stay
exact under concurrent launching threads.  Every thread join and wait has
its own timeout."""

import gzip
import json
import sys
import threading

import numpy as np
import pytest

from repro.engine import ExecutionPolicy as PolicyJ
from repro.engine import QueryEngine as EngineJ
from repro.live import LiveDir as LiveDirJ
from repro.store import DeltaBuilder as DeltaBuilderJ
from repro.store import ingest_ntriples as ingest_ntriples_j
from repro.store import open_chain as open_chain_j

from repro_torch.engine import ExecutionPolicy, QueryEngine
from repro_torch.kernels.counting import LaunchCounter
from repro_torch.launch import ingest as ingest_cli
from repro_torch.live import EngineSwapper, GraphWatcher, LiveDir
from repro_torch.obs import parse_prometheus
from repro_torch.serve import DKSService, ServeConfig
from repro_torch.store import (ArtifactError, ChainIndex, DeltaBuilder,
                               FormatVersionError, LazyArtifactIndex,
                               chained_hash, compact_chain, from_graph,
                               ingest_ntriples, ingest_tsv, open_artifact,
                               open_chain, open_delta, write_artifact)

WAIT = 60  # seconds: the most any thread, future or event is waited for

BASE_LINES = []
for i in range(23):
    conf = " 0.9" if i % 2 else ""
    BASE_LINES.append(f"<http://x.example/e{i}> <http://p.example/knows> "
                      f"<http://x.example/e{i + 1}>{conf} .")
for i in range(0, 18, 3):
    BASE_LINES.append(f"<http://x.example/e{i}> <http://p.example/cites> "
                      f"<http://x.example/e{i + 6}> 0.5 .")
FRAG1_LINES = [
    f"<http://x.example/e{i}> <http://p.example/mentions> "
    f"<http://x.example/fresh{j}> 0.8 ."
    for j, i in enumerate((0, 5, 11))]
FRAG2_LINES = [   # fresh0 resolves to its delta-1 id; fresh3 is new
    "<http://x.example/fresh0> <http://p.example/knows> "
    "<http://x.example/fresh3> .",
    "<http://x.example/fresh3> <http://p.example/cites> "
    "<http://x.example/e2> 0.6 .",
]
QUERIES = [["e3", "e7"], ["fresh0", "e3"], ["fresh3", "e10"],
           ["e1", "e5", "fresh1"]]


def write_lines(path, lines):
    path.write_text("\n".join(lines) + "\n", encoding="utf-8")
    return path


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A port LiveDir with two stacked deltas, the same built by repro,
    and the union re-ingest."""
    tmp = tmp_path_factory.mktemp("live")
    for name, lines in [("base.nt", BASE_LINES), ("frag1.nt", FRAG1_LINES),
                        ("frag2.nt", FRAG2_LINES),
                        ("union.nt", BASE_LINES + FRAG1_LINES
                         + FRAG2_LINES)]:
        write_lines(tmp / name, lines)
    live = LiveDir.initialize(tmp / "live", ingest_ntriples(tmp / "base.nt"))
    d1 = live.append([tmp / "frag1.nt"])
    d2 = live.append([tmp / "frag2.nt"])
    live_j = LiveDirJ.initialize(tmp / "live_j",
                                 ingest_ntriples_j(tmp / "base.nt"))
    live_j.append([tmp / "frag1.nt"])
    live_j.append([tmp / "frag2.nt"])
    union = ingest_ntriples(tmp / "union.nt")
    return tmp, live, (d1, d2), union, live_j


def fresh_live(tmp_path):
    write_lines(tmp_path / "base.nt", BASE_LINES)
    write_lines(tmp_path / "frag1.nt", FRAG1_LINES)
    return LiveDir.initialize(tmp_path / "live",
                              ingest_ntriples(tmp_path / "base.nt"))


def tree_keys(res):
    return [(a.root, a.weight, tuple(sorted(a.edges))) for a in res.answers]


def dir_bytes(path):
    """Every buffer file's bytes, and the manifest without the ingest's
    timings (``stats`` is outside the content hash by design)."""
    out = {p.name: p.read_bytes() for p in sorted(path.iterdir())
           if p.suffix == ".npy"}
    manifest = json.loads((path / "manifest.json").read_text())
    for key in ("ingest_s", "edges_per_s"):
        manifest["stats"].pop(key)
    return out, manifest


def test_deltas_and_chain_state_identical_across_packages(setup):
    """Each package's live dir holds the same buffers and manifests (base,
    both deltas, content hashes; only the ingest timings differ), the same
    CHAIN.json entries, and each package opens the other's chain under
    the same chained hash."""
    tmp, live, (d1, d2), _union, live_j = setup
    for name in ("base-000000", "delta-000001", "delta-000002"):
        assert dir_bytes(live.path / name) == dir_bytes(live_j.path / name), \
            name
    for key in ("base", "deltas", "chain_hash", "consumed", "format",
                "version"):
        assert live._state[key] == live_j._state[key], key
    assert d2.chain_hash == live_j.chain_hash == live.chain_hash
    assert LiveDirJ(live.path).chain().content_hash == live.chain_hash
    assert LiveDir(live_j.path).chain().content_hash == live.chain_hash
    # A delta built by repro on the port's base is the port's delta.
    b = DeltaBuilderJ(open_chain_j(live.base_path))
    b.add_file(tmp / "frag1.nt")
    dj = b.write(tmp / "delta-j")
    assert dj.content_hash == d1.content_hash
    assert open_delta(dj.path).chain_hash == d1.chain_hash


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_chain_parity_with_union_reingest(setup, backend):
    """The port's chain engine == its union re-ingest engine == repro's
    chain engine: weights, roots, supersteps and answer trees."""
    _tmp, live, _deltas, union, live_j = setup
    policy = ExecutionPolicy(backend=backend, max_supersteps=24)
    e_chain = QueryEngine.build(artifact=live.chain(), policy=policy,
                                device="cpu")
    e_union = QueryEngine.build(union.graph, index=union.index,
                                policy=policy, device="cpu")
    ref = EngineJ.build(artifact=live_j.chain(),
                        policy=PolicyJ(max_supersteps=24))
    assert e_chain.version == ref.version
    for q in QUERIES:
        r_c, r_u, r_j = (e.query(q, k=2) for e in (e_chain, e_union, ref))
        for other in (r_u, r_j):
            np.testing.assert_array_equal(r_c.weights, other.weights,
                                          err_msg=f"weights diverged: {q}")
            np.testing.assert_array_equal(r_c.roots, other.roots)
            assert r_c.supersteps == other.supersteps
            assert tree_keys(r_c) == tree_keys(other), q
    for r_c, r_u in zip(e_chain.query_batch(QUERIES[:3], k=2),
                        e_union.query_batch(QUERIES[:3], k=2)):
        np.testing.assert_array_equal(r_c.weights, r_u.weights)
        assert tree_keys(r_c) == tree_keys(r_u)


def test_chain_version_is_chained_hash(setup):
    _tmp, live, (d1, d2), _union, _ = setup
    base = live.base()
    chain = live.chain()
    expect = chained_hash(chained_hash(base.content_hash, d1.content_hash),
                          d2.content_hash)
    assert chain.content_hash == expect and chain.depth == 2
    assert d2.base_content_hash == chained_hash(base.content_hash,
                                                d1.content_hash)
    engine = QueryEngine.build(artifact=chain, device="cpu")
    assert engine.version == f"artifact:{expect}"
    assert open_chain(base).content_hash == base.content_hash


def test_compaction_bit_identical_to_union(setup, tmp_path):
    _tmp, live, _deltas, union, live_j = setup
    compacted = compact_chain(live.chain(), tmp_path / "compacted")
    union_art = write_artifact(tmp_path / "union-art", union.graph,
                               union.index, tau=union.tau,
                               stats=union.stats.as_dict(),
                               names=union.names)
    assert compacted.content_hash == union_art.content_hash
    from repro.store import compact_chain as compact_chain_j
    assert compact_chain_j(live_j.chain(), tmp_path / "compacted-j") \
        .content_hash == compacted.content_hash
    assert "compacted[chain=" in repr(compacted)
    assert compacted.stats["chain_depth"] == 2


def test_live_dir_compact_resets_chain(tmp_path):
    live = fresh_live(tmp_path)
    live.append([tmp_path / "frag1.nt"])
    before = live.chain().content_hash
    art = live.compact()
    assert live.depth == 0 and live.chain_hash == art.content_hash
    assert art.stats["compacted_from_chain"] == before
    assert LiveDir(tmp_path / "live").chain().content_hash == \
        art.content_hash
    assert LiveDirJ(tmp_path / "live").chain().content_hash == \
        art.content_hash


def test_dictionary_growth_through_lazy_chain_index(setup):
    _tmp, live, (_d1, d2), _union, _ = setup
    chain = live.chain()
    engine = QueryEngine.build(artifact=chain, device="cpu")
    idx = engine.index
    assert isinstance(idx, ChainIndex)
    assert isinstance(idx.base_index, LazyArtifactIndex)
    assert idx.df("fresh3") == 1 and idx.df("fresh0") == 1
    assert "fresh3" in idx.vocabulary()
    assert engine.graph.labels is not None
    assert engine.node_label(int(idx.lookup("fresh3")[0])) == "fresh3"
    assert chain.entity_names().count("<http://x.example/fresh0>") == 1
    assert d2.new_names() == ["<http://x.example/fresh3>"]


def test_mis_stacked_delta_names_both_hashes(setup):
    _tmp, live, (_d1, d2), _union, _ = setup
    with pytest.raises(ArtifactError, match="mis-stacked") as exc:
        open_chain(live.base_path, d2.path)   # skips delta 1
    msg = str(exc.value)
    assert d2.base_content_hash[:12] in msg
    assert live.base().content_hash[:12] in msg
    assert "depth 1" in msg


def test_open_guards_route_to_the_right_opener(setup):
    _tmp, live, (d1, _d2), _union, _ = setup
    with pytest.raises(FormatVersionError, match="open_chain"):
        open_artifact(d1.path)
    with pytest.raises(FormatVersionError, match="open_artifact"):
        open_delta(live.base_path)
    assert f"base={d1.base_content_hash[:12]}" in repr(d1)
    assert "depth=1" in repr(d1)


def test_tau_mismatch_and_empty_delta_refused(setup, tmp_path):
    tmp, live, _deltas, _union, _ = setup
    other = ingest_ntriples(tmp / "base.nt", tau=7)
    write_artifact(tmp_path / "tau7", other.graph, other.index,
                   tau=other.tau, names=other.names)
    b = DeltaBuilder(open_artifact(tmp_path / "tau7"))
    with pytest.raises(ArtifactError, match="empty delta"):
        b.write(tmp_path / "never")
    b.add_statement("<http://x.example/e0>", "<http://x.example/zz>")
    d = b.write(tmp_path / "tau7-delta")
    with pytest.raises(ArtifactError, match="tau"):
        open_chain(live.base_path, d.path)


def test_initialize_requires_entity_names(tmp_path):
    from repro_torch.graph.generators import lod_like_graph
    g, tokens = lod_like_graph(64, 128, seed=3, vocab=32)
    with pytest.raises(ArtifactError, match="names"):
        LiveDir.initialize(tmp_path / "live", from_graph(g, tokens=tokens))


def test_watcher_run_once_marks_consumed(tmp_path):
    live = fresh_live(tmp_path)
    incoming = tmp_path / "incoming"
    incoming.mkdir()
    write_lines(incoming / "frag-01.nt", FRAG1_LINES)
    (incoming / "notes.json").write_text("{}")   # unrecognized: ignored
    seen = []
    watcher = GraphWatcher(live, incoming,
                           on_delta=lambda lv, d: seen.append(d))
    assert [p.name for p in watcher.pending()] == ["frag-01.nt"]
    delta = watcher.run_once()
    assert delta is not None and seen == [delta] and watcher.published == 1
    assert watcher.run_once() is None
    assert "frag-01.nt" in LiveDir(tmp_path / "live").consumed
    (incoming / "frag-02.nt").write_text("not a triple\n")
    assert watcher.run_once() is None
    assert "frag-02.nt" in live.consumed and live.depth == 1


def test_watcher_thread_publishes_and_stops(tmp_path):
    live = fresh_live(tmp_path)
    incoming = tmp_path / "incoming"
    incoming.mkdir()
    published = threading.Event()
    watcher = GraphWatcher(live, incoming, poll_s=0.02,
                           on_delta=lambda lv, d: published.set()).start()
    thread = watcher._thread
    try:
        with pytest.raises(RuntimeError, match="already running"):
            watcher.start()
        write_lines(incoming / "frag-01.nt", FRAG1_LINES)
        assert published.wait(WAIT), "watcher never published the delta"
    finally:
        watcher.stop(WAIT)
    assert not thread.is_alive()
    assert watcher.published == 1 and live.depth == 1


def small_engine(tmp_path):
    live = fresh_live(tmp_path)
    e0 = QueryEngine.build(artifact=live.chain(), device="cpu",
                           policy=ExecutionPolicy(max_supersteps=12))
    return live, e0


def test_set_engine_hardening(tmp_path):
    live, e0 = small_engine(tmp_path)
    cfg = ServeConfig(max_batch=2, max_wait_ms=1.0, cache_size=16)
    with DKSService(e0, cfg) as svc:
        q = ["e3", "e7"]
        svc.query(q, k=1, return_trees=True, timeout=WAIT)
        assert svc.query(q, k=1, return_trees=True, timeout=WAIT).cache_hit
        live.append([tmp_path / "frag1.nt"])
        e1 = QueryEngine.build(artifact=live.chain(), policy=e0.policy,
                               device="cpu")
        svc.set_engine(e1)
        assert svc.engine is e1
        assert not svc.query(q, k=1, return_trees=True,
                             timeout=WAIT).cache_hit
        stats = svc.stats()
        assert stats.engine_swaps == 1 and "engine swaps" in stats.summary()
        assert parse_prometheus(svc.registry.render())[
            "dks_engine_swaps_total"] == 1


def test_hot_shapes_recorded(tmp_path):
    _live, e0 = small_engine(tmp_path)
    with DKSService(e0, ServeConfig(max_batch=2, max_wait_ms=1.0,
                                    cache_size=0)) as svc:
        for _ in range(3):
            svc.query(["e3", "e7"], k=1, timeout=WAIT)
        hot = svc.stats().hot_shapes
    assert hot, "no hot shapes recorded"
    (shape, count), = [(s, c) for s, c in hot if c == max(c for _, c in hot)]
    m, k, lanes = shape
    assert (m, k) == (2, 1) and lanes >= 1 and count >= 1


def test_swap_under_inflight_load(tmp_path):
    """Requests in flight across a watcher-driven swap finish, the
    successor is built on the outgoing engine's device ("cpu"; a default
    device would raise here, with no card), warmed at every hot shape,
    and the swap is traced and metered."""
    live, e0 = small_engine(tmp_path)
    incoming = tmp_path / "incoming"
    incoming.mkdir()
    cfg = ServeConfig(max_batch=4, max_wait_ms=20.0, cache_size=0)
    with DKSService(e0, cfg) as svc:
        swapper = EngineSwapper(svc)
        swapper.wire_metrics()
        watcher = GraphWatcher(live, incoming, on_delta=swapper.on_delta)
        old_version = svc.engine.version
        svc.query(["e3", "e7"], k=1, timeout=WAIT)     # one hot shape
        futures = [svc.submit(q, k=1)
                   for q in (["e3", "e7"], ["e2", "e10"], ["e1", "e5"])]
        write_lines(incoming / "frag-01.nt", FRAG1_LINES)
        assert swapper.staleness_seconds == 0.0
        assert watcher.run_once() is not None    # publish + swap, inline
        served = [f.result(timeout=WAIT) for f in futures]
        assert all(s.result.weights[0] > 0 for s in served)
        assert swapper.swaps == 1 and swapper.deltas_applied == 1
        assert svc.engine.device == e0.device
        assert svc.engine.version == \
            f"artifact:{live.chain().content_hash}" != old_version
        # The in-flight batch's shape joins the hot ones if it dispatched
        # before the warm read them.
        assert (2, 1, 1) in swapper.last_hot
        assert swapper.last_warmed == swapper.last_hot
        assert svc.engine.trace_count(2, 1) == 1   # the warm's first use
        post = svc.query(["fresh0", "e3"], k=1, timeout=WAIT)
        assert post.result.weights[0] > 0
        samples = parse_prometheus(svc.registry.render())
        assert samples["dks_delta_applied_total"] == 1
        assert samples["dks_graph_staleness_seconds"] == 0.0
        swaps = [t for t in svc.recent_traces() if t.name == "dks.swap"]
        assert [sp.name for sp in swaps[-1].spans] == \
            ["build", "warm", "swap"]
    ts = svc.tracer.stats()
    assert ts["begun"] == ts["finished"], ts


def test_failed_swap_keeps_serving_and_raises(tmp_path):
    """A build that raises leaves the old engine serving, records the
    error on the swap's trace, and the staleness gauge keeps climbing."""
    live, e0 = small_engine(tmp_path)
    with DKSService(e0, ServeConfig(max_wait_ms=1.0)) as svc:
        swapper = EngineSwapper(svc)
        swapper.published()
        with pytest.raises(ArtifactError):
            swapper.swap_to(tmp_path / "no-such-artifact")
        assert svc.engine is e0 and swapper.swaps == 0
        assert swapper.staleness_seconds > 0.0
        trace = [t for t in svc.recent_traces() if t.name == "dks.swap"][-1]
        assert trace.attrs["outcome"] == "error"
        assert svc.query(["e3", "e7"], k=1, timeout=WAIT).result.found


def test_tsv_and_gz_fragments(tmp_path):
    lines = [f"a{i} left\ta{i + 1} right\tknows\t1.0" for i in range(6)]
    write_lines(tmp_path / "b.tsv", lines)
    live = LiveDir.initialize(tmp_path / "live",
                              ingest_tsv(tmp_path / "b.tsv"))
    with gzip.open(tmp_path / "f.tsv.gz", "wt") as f:
        f.write("a6 right\ta7 tail\tcites\t0.5\n")
    delta = live.append([tmp_path / "f.tsv.gz"])
    assert delta.n_new_nodes == 1 and delta.new_predicates == ["cites"]
    engine = QueryEngine.build(artifact=live.chain(), device="cpu")
    assert engine.query(["tail", "a0"], k=1, extract=False).weights[0] > 0
    with pytest.raises(ArtifactError, match="sniff"):
        live.append([tmp_path / "b.json"])


def test_gc_deletes_only_unreferenced_dirs(tmp_path):
    live = fresh_live(tmp_path)
    live.append([tmp_path / "frag1.nt"])
    assert live.gc(keep_last=0) == []
    live.compact()
    before = {p.name for p in live.path.iterdir() if p.is_dir()}
    assert {"base-000000", "delta-000001", "base-000001"} <= before
    assert sorted(live.gc(keep_last=0)) == ["base-000000", "delta-000001"]
    after = {p.name for p in live.path.iterdir() if p.is_dir()}
    assert "base-000001" in after and "base-000000" not in after
    assert live.chain().content_hash == live.chain_hash
    with pytest.raises(ValueError):
        live.gc(keep_last=-1)


def test_gc_keep_last_retains_newest_superseded(tmp_path):
    live = fresh_live(tmp_path)
    live.append([tmp_path / "frag1.nt"])
    live.compact()
    assert len(live.gc(keep_last=1)) == 1
    survivors = {p.name for p in live.path.iterdir() if p.is_dir()}
    assert len(survivors & {"base-000000", "delta-000001"}) == 1


def test_gc_refuses_mid_publish(tmp_path):
    live = fresh_live(tmp_path)
    live.append([tmp_path / "frag1.nt"])
    live.compact()
    live._publishing = True   # as a watcher thread inside append()
    try:
        with pytest.raises(RuntimeError, match="publish is in progress"):
            live.gc(keep_last=0)
    finally:
        live._publishing = False
    assert live.gc(keep_last=0)


def test_ingest_cli_live_lifecycle(tmp_path, capsys):
    """--input --live, then --append, --compact --gc through the port's
    ingest CLI, with the roundtrip verified on the CPU."""
    write_lines(tmp_path / "base.nt", BASE_LINES)
    write_lines(tmp_path / "frag1.nt", FRAG1_LINES)
    live_dir = str(tmp_path / "live")
    assert ingest_cli.main(["--input", str(tmp_path / "base.nt"), "--live",
                            live_dir, "--device", "cpu"]) == 0
    assert ingest_cli.main(["--live", live_dir, "--append",
                            str(tmp_path / "frag1.nt")]) == 0
    assert ingest_cli.main(["--live", live_dir, "--compact", "--gc",
                            "--gc-keep", "0"]) == 0
    out = capsys.readouterr().out
    for want in ("initialized LiveDir", "bit-identical", "published Delta",
                 "compacted chain", "gc: deleted"):
        assert want in out, want
    survivors = {p.name for p in (tmp_path / "live").iterdir()
                 if p.is_dir()}
    assert survivors == {"base-000001"}


def test_launch_counter_exact_under_threads():
    """More launching threads than cores, a short switch interval: every
    add is counted, and by_thread splits the count by thread."""
    counter = LaunchCounter()
    n_threads, per = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [counter.add() for _ in range(per)],
            name=f"launcher-{i}") for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(WAIT)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert counter.total == n_threads * per
    assert counter.by_thread() == {f"launcher-{i}": per
                                   for i in range(n_threads)}
    counter.reset()
    assert counter.total == 0 and counter.by_thread() == {}
