"""The port's observability (``repro_torch.obs`` and the engine's
telemetry) against ``repro`` on the CPU: the tracer ring, sampling and
trace JSON, the Prometheus text of the same registry calls, superstep
telemetry rows from the driver's loop (``"torch"`` and ``"cuda"``, whose
wrappers run the kernels' plain versions on CPU tensors) against
``repro``'s fused-loop buffer, the decoder, ``query_instrumented``'s final
state and history, and the serve layer's traces and ``/metrics``.

Tolerance: none for counters, telemetry rows and lattice values (every
one is a count, a min, a compare or one f32 add); times are excluded.
Every future wait carries a timeout.
"""

import contextlib
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from repro import obs as obs_j
from repro.core import dks as dks_j
from repro.engine import ExecutionPolicy as PolicyJ
from repro.engine import QueryEngine as EngineJ
from repro.graph import generators as gen_j
from repro.serve import DKSService as ServiceJ
from repro.serve import ServeConfig as ConfigJ

from repro_torch import obs as obs_t
from repro_torch.core import dks as dks_t
from repro_torch.engine import ExecutionPolicy as PolicyT
from repro_torch.engine import QueryEngine as EngineT
from repro_torch.graph import generators as gen_t
from repro_torch.interop import state_to_numpy
from repro_torch.obs import (MetricsRegistry, MetricsServer, Tracer,
                             parse_prometheus, render_span_tree)
from repro_torch.serve import DKSService, ServeConfig
from repro_torch.serve.loadgen import latency_split
from repro_torch.serve.stats import StatsCollector

WAIT = 30  # seconds: the most any future is waited for


@pytest.fixture(scope="module")
def graphs():
    gj, tokens = gen_j.lod_like_graph(600, 1800, seed=11, vocab=120)
    gt, _ = gen_t.lod_like_graph(600, 1800, seed=11, vocab=120)
    return gj, gt, tokens


@pytest.fixture(scope="module")
def engines(graphs):
    gj, gt, tokens = graphs
    ref = {tel: EngineJ.build(gj, tokens=tokens, policy=PolicyJ(
        max_supersteps=32, telemetry=tel)) for tel in (False, True)}
    port = {(b, tel): EngineT.build(gt, tokens=tokens, policy=PolicyT(
        backend=b, max_supersteps=32, telemetry=tel), device="cpu")
        for b in ("torch", "cuda") for tel in (False, True)}
    return ref, port


def mid_df_tokens(index, n, lo=2, hi=60):
    toks = [t for t in sorted(index.vocabulary(), key=index.df)
            if lo <= index.df(t) <= hi]
    assert len(toks) >= n
    return toks[:n]


@contextlib.contextmanager
def held_dispatcher(svc, engine, query):
    """Occupy the service's dispatcher with one request until the block
    exits: everything submitted inside queues up and drains together, so
    coalescing does not depend on racing the admission window."""
    entered, release = threading.Event(), threading.Event()
    orig = engine.query_batch

    def blocked(*args, **kwargs):
        del engine.query_batch        # later dispatches run unblocked
        entered.set()
        release.wait(WAIT)
        return orig(*args, **kwargs)

    engine.query_batch = blocked
    blocker = svc.submit(query, k=1)
    assert entered.wait(WAIT), "the dispatcher never took the blocker"
    try:
        yield blocker
    finally:
        release.set()
        blocker.result(timeout=WAIT)


# ---------------------------------------------------------------------------
# Traces
# ---------------------------------------------------------------------------


def test_tracer_ring_bounded_and_counters():
    tracer = Tracer(capacity=4)
    ids = []
    for i in range(10):
        tr = tracer.begin("req", i=i)
        with tr.span("outer") as outer:
            outer.set(note="x")
            with tr.span("inner"):
                pass
        tr.add_span("retro", tr.t_start, tr.t_start + 0.001, kind="queue")
        tr.finish()
        tr.finish()  # idempotent: must not double-count
        ids.append(tr.trace_id)
    assert tracer.stats() == {"begun": 10, "finished": 10, "sampled": 10,
                              "buffered": 4}
    assert [t.trace_id for t in tracer.recent()] == ids[-4:]
    assert tracer.get(ids[0]) is None and tracer.get(ids[-1]) is not None
    tr = tracer.get(ids[-1])
    by_name = {sp.name: sp for sp in tr.spans}
    assert by_name["inner"].parent_id == by_name["outer"].span_id
    assert by_name["retro"].parent_id is None
    rendered = render_span_tree(tr)
    for name in ("outer", "inner", "retro", "note=x"):
        assert name in rendered
    d = json.loads(json.dumps(tr.to_dict()))
    assert [s["name"] for s in d["spans"]] == ["retro", "outer", "inner"]


def traced_calls(obs):
    """The same tracer calls on either package; the trace JSON with its
    clock readings (start time, durations) taken out."""
    tracer = obs.Tracer(capacity=8, sample=0.5, seed=3)
    out = []
    for i in range(6):
        tr = tracer.begin("dks.request", m=2, k=i)
        tr.add_span("admit", tr.t_start, tr.t_start + 0.002,
                    outcome="queued")
        tr.add_span("coalesce", tr.t_start + 0.001, tr.t_start + 0.003,
                    shape="m2k1", fill=3)
        tr.link(coalesced_into=1)
        tr.set(outcome="served")
        tr.finish()
        d = tr.to_dict()
        d.pop("t_unix")
        d.pop("duration_ms")
        for sp in d["spans"]:
            sp.pop("offset_ms")
            sp.pop("duration_ms")
        out.append(d)
    return out, tracer.stats(), tracer.to_jsonl().count("\n")


def test_trace_json_and_sampling_match_reference():
    assert traced_calls(obs_t) == traced_calls(obs_j)

    def sampled_ids(obs, seed):
        tracer = obs.Tracer(capacity=256, sample=0.3, seed=seed)
        return {tr.trace_id for tr in (tracer.begin("req")
                                       for _ in range(200)) if tr.sampled}

    for seed in (7, 8):
        assert sampled_ids(obs_t, seed) == sampled_ids(obs_j, seed)
    assert sampled_ids(obs_t, 7) != sampled_ids(obs_t, 8)
    assert 0 < len(sampled_ids(obs_t, 7)) < 200
    tracer = Tracer(sample=0.0)
    tr = tracer.begin("req")
    with tr.span("ignored") as h:
        h.set(x=1)
    tr.finish()
    assert tr.spans == [] and tracer.stats()["sampled"] == 0


def test_trace_log_jsonl(tmp_path):
    log = tmp_path / "traces.jsonl"
    tracer = Tracer(capacity=8, log_path=str(log))
    for i in range(3):
        tr = tracer.begin("req", i=i)
        with tr.span("work"):
            pass
        tr.finish()
    lines = [json.loads(ln) for ln in log.read_text().splitlines()]
    assert [d["attrs"]["i"] for d in lines] == [0, 1, 2]
    assert all(d["spans"][0]["name"] == "work" for d in lines)


# ---------------------------------------------------------------------------
# Metrics
# ---------------------------------------------------------------------------


def registry_calls(obs):
    reg = obs.MetricsRegistry()
    c = reg.counter("rt_requests_total", "requests")
    g = reg.gauge("rt_depth", "queue depth")
    h = reg.histogram("rt_latency_ms", "latency", buckets=(1.0, 10.0, 100.0))
    c.inc()
    c.inc(2.5)
    g.set(7)
    g.dec(2)
    for v in (0.5, 5.0, 50.0, 500.0):
        h.observe(v)
    reg.register_collector(
        lambda: {"rt_external_total": 42, "rt_ratio": 0.25},
        kinds={"rt_external_total": "counter", "rt_ratio": "gauge"},
        helps={"rt_ratio": "a ratio"})
    return reg


def test_prometheus_text_matches_reference():
    assert registry_calls(obs_t).render() == registry_calls(obs_j).render()
    reg = registry_calls(obs_t)
    parsed = parse_prometheus(reg.render())
    assert parsed == reg.sample()
    assert parsed["rt_requests_total"] == 3.5
    assert parsed["rt_depth"] == 5.0
    assert parsed["rt_external_total"] == 42.0
    assert parsed['rt_latency_ms_bucket{le="1"}'] == 1.0
    assert parsed['rt_latency_ms_bucket{le="+Inf"}'] == 4.0
    assert parsed["rt_latency_ms_count"] == 4.0
    assert parsed["rt_latency_ms_sum"] == pytest.approx(555.5)
    c = reg.counter("rt_requests_total")
    assert reg.counter("rt_requests_total") is c
    with pytest.raises(ValueError):
        reg.gauge("rt_requests_total")
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(ValueError):
        MetricsRegistry().counter("0bad name")


def test_stats_empty_window_no_nan():
    empty = StatsCollector().report({})
    for f, v in vars(empty).items():
        if isinstance(v, (int, float)):
            assert np.isfinite(v), f"ServeStats.{f} not finite"
    assert empty.hot_shapes == ()
    assert empty.p50_ms == 0.0 and empty.throughput_rps == 0.0
    assert "nan" not in empty.summary().lower()
    split = latency_split([])
    assert split["n"] == 0 and split["latency_p95_ms"] == 0.0


# ---------------------------------------------------------------------------
# Superstep telemetry
# ---------------------------------------------------------------------------


def test_telemetry_decoder_matches_reference():
    rng = np.random.default_rng(3)
    buf = rng.integers(0, 1000, size=(5, obs_t.telemetry.N_COLS)).astype(
        np.float32)
    for n in (0, 3, 5, 9):          # 9 > T: the run overwrote the last row
        tt = obs_t.SuperstepTelemetry.from_buffer(buf, n)
        tj = obs_j.SuperstepTelemetry.from_buffer(buf, n)
        assert tt.truncated == tj.truncated == (n > 5)
        assert tt.rows() == tj.rows() and tt.summary() == tj.summary()
        np.testing.assert_array_equal(tt.frozen, tj.frozen)
        np.testing.assert_array_equal(tt.msgs_deep_delta,
                                      tj.msgs_deep_delta)
    with pytest.raises(ValueError):
        obs_t.SuperstepTelemetry.from_buffer(buf[:, :3], 2)
    col = obs_t.HostTelemetryCollector()
    col.record(3, 1.0, 0.0, 0, best=5.0)
    col.record(4, 2.0, 1.0, 1, best=4.0)
    assert col.build().rows() == [
        {"step": 1, "frontier": 3, "msgs_bfs": 1.0, "msgs_deep": 0.0,
         "best": 5.0},
        {"step": 2, "frontier": 4, "msgs_bfs": 2.0, "msgs_deep": 1.0,
         "best": 4.0}]


def same_telemetry(tt, tj):
    assert tt.n_steps == tj.n_steps and tt.truncated == tj.truncated
    assert tt.rows() == tj.rows()
    np.testing.assert_array_equal(tt.frozen, tj.frozen)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_telemetry_rows_match_reference_and_change_nothing(engines,
                                                           backend):
    ref, port = engines
    toks = mid_df_tokens(ref[False].index, 4)
    base, tel = port[(backend, False)], port[(backend, True)]
    for q in (toks[0:2], toks[1:4]):
        r_base = base.query(q, k=2)
        r_tel = tel.query(q, k=2)
        np.testing.assert_array_equal(r_base.weights, r_tel.weights)
        np.testing.assert_array_equal(r_base.roots, r_tel.roots)
        assert r_base.supersteps == r_tel.supersteps
        assert [a.edges for a in r_base.answers] == \
            [a.edges for a in r_tel.answers]
        assert r_base.telemetry is None
        same_telemetry(r_tel.telemetry, ref[True].query(
            q, k=2, extract=False).telemetry)
        assert r_tel.telemetry.msgs_bfs[-1] == r_tel.msgs_bfs
        assert int(r_tel.telemetry.frozen[-1]) == 1
    queries = [toks[0:2], toks[2:4], toks[1:3]]
    got = tel.query_batch(queries, k=1, extract=False)
    want = ref[True].query_batch(queries, k=1, extract=False)
    # One bucket, one lane-summed record shared by its results.
    assert got[0].telemetry is got[2].telemetry
    same_telemetry(got[0].telemetry, want[0].telemetry)
    assert int(got[0].telemetry.frozen[-1]) == len(queries)
    for rb, rt in zip(base.query_batch(queries, k=1, extract=False), got):
        np.testing.assert_array_equal(rb.weights, rt.weights)


def test_telemetry_is_fixed_at_build_and_leaves_cache_keys(engines):
    ref, port = engines
    q = mid_df_tokens(ref[False].index, 2)
    base, tel = port[("torch", False)], port[("torch", True)]
    assert base.cache_token(q, 1)[:3] == tel.cache_token(q, 1)[:3]
    with pytest.raises(ValueError, match="telemetry"):
        base.query(q, k=1, telemetry=True)
    assert tel.trace_count(2, 1) == tel.trace_count(2, 1, kind="fused")


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_instrumented_matches_reference(engines, backend):
    ref, port = engines
    q = mid_df_tokens(ref[False].index, 3)
    rt, it = port[(backend, False)].query_instrumented(q, k=2)
    rj, ij = ref[False].query_instrumented(q, k=2)
    assert it["history"] == ij["history"] == it["telemetry"].rows()
    np.testing.assert_array_equal(it["telemetry"].best,
                                  ij["telemetry"].best)
    assert set(it["timings"]) == set(ij["timings"])
    np.testing.assert_array_equal(rt.weights, rj.weights)
    assert (rt.supersteps, rt.msgs_bfs, rt.msgs_deep, rt.explored_frac) == \
        (rj.supersteps, rj.msgs_bfs, rj.msgs_deep, rj.explored_frac)
    assert [(a.root, a.edges) for a in rt.answers] == \
        [(a.root, a.edges) for a in rj.answers]
    # The final state, field by field (repro's is un-batched).
    state = port[(backend, False)].query_instrumented(
        q, k=2, keep_state=True)[0].state
    want = ref[False].query_instrumented(q, k=2, keep_state=True)[0].state
    for name, arr in state_to_numpy(state).items():
        np.testing.assert_array_equal(arr[0], np.asarray(getattr(want, name)),
                                      err_msg=name)
    # The host exit hook stops the run after its first superstep.
    r_hook, i_hook = port[(backend, False)].query_instrumented(
        q, k=2, exit_hook=lambda st: True)
    assert r_hook.supersteps == 1 and len(i_hook["history"]) == 1


def test_run_dks_drivers_match_reference(engines):
    ref, port = engines
    toks = mid_df_tokens(ref[False].index, 5)
    dgj, dgt = ref[False].device_graph, port[("torch", False)].device_graph
    masks = np.stack([ref[False]._masks(q)[0]
                      for q in (toks[0:3], toks[2:5])])
    cfg_j = PolicyJ(max_supersteps=32).dks_config(3, 2)
    cfg_t = PolicyT(max_supersteps=32).dks_config(3, 2)
    one_t = dks_t.run_dks(dgt, torch.from_numpy(masks[0]), cfg_t)
    one_j = dks_j.run_dks(dgj, masks[0], cfg_j)
    both_t = dks_t.run_dks_batched(dgt, torch.from_numpy(masks), cfg_t)
    both_j = dks_j.run_dks_batched(dgj, masks, cfg_j)
    np.testing.assert_array_equal(
        dks_t.extract_answer_weights(one_t, cfg_t)[0],
        dks_j.extract_answer_weights(one_j, cfg_j))
    np.testing.assert_array_equal(
        dks_t.extract_answer_weights(both_t, cfg_t),
        dks_j.extract_answer_weights(both_j, cfg_j))
    for name, arr in state_to_numpy(both_t).items():
        np.testing.assert_array_equal(arr, np.asarray(getattr(both_j, name)),
                                      err_msg=name)


# ---------------------------------------------------------------------------
# Serve-layer observability
# ---------------------------------------------------------------------------


def served_traces(service_cls, config_cls, engine, queries):
    """Serve ``queries`` one at a time; each request's span names and the
    attributes that are not clock readings, and the sample names on
    ``/metrics``."""
    out = []
    with service_cls(engine, config_cls(max_batch=1, max_wait_ms=0.0,
                                        cache_size=8)) as svc:
        for q in queries:
            srv = svc.query(q, k=1, timeout=WAIT)
            tr = svc.trace(srv.trace_id).to_dict()
            out.append((tr["attrs"], [
                (sp["name"], {a: v for a, v in sp["attrs"].items()
                              if a != "deadline_budget_ms"})
                for sp in tr["spans"]]))
        names = sorted(parse_prometheus(svc.registry.render()))
        stats = svc.stats()
    return out, names, (stats.requests, stats.cache_hits,
                        stats.batch_dispatches)


def test_served_traces_and_metrics_match_reference(graphs):
    gj, gt, tokens = graphs
    # Fresh engines: a trace's ``compiled`` reads the executor cache.
    ref = EngineJ.build(gj, tokens=tokens, policy=PolicyJ(max_supersteps=32))
    port = EngineT.build(gt, tokens=tokens,
                         policy=PolicyT(max_supersteps=32), device="cpu")
    toks = mid_df_tokens(ref.index, 4)
    queries = [toks[0:2], toks[2:4], toks[0:2]]   # the third is a cache hit
    got = served_traces(DKSService, ServeConfig, port, queries)
    assert got == served_traces(ServiceJ, ConfigJ, ref, queries)
    assert [attrs.get("compiled") for attrs, _ in got[0]] == \
        [True, False, None]


def test_trace_completeness_coalescing_and_single_flight(engines):
    ref, port = engines
    engine = port[("torch", False)]
    toks = mid_df_tokens(engine.index, 8)
    distinct = [toks[0:2], toks[2:4], toks[4:6]]
    with DKSService(engine, ServeConfig(max_batch=4, max_wait_ms=2.0,
                                        cache_size=8)) as svc:
        with held_dispatcher(svc, engine, toks[5:8]):
            futs = [svc.submit(q, k=1) for q in distinct]
        served = [f.result(timeout=WAIT) for f in futs]
        assert [s.batch_size for s in served] == [3, 3, 3]
        traces = [svc.trace(s.trace_id) for s in served]
        leader, riders = traces[0], traces[1:]
        names = {sp.name for sp in leader.spans}
        assert {"admit", "cache_lookup", "queue_wait", "coalesce",
                "device_dispatch", "extract"} <= names
        coalesce = next(sp for sp in leader.spans if sp.name == "coalesce")
        assert coalesce.attrs["fill"] == 3
        assert coalesce.attrs["shape"] == "m2k1"
        for tr in riders:
            assert tr.links["coalesced_into"] == leader.trace_id
            assert tr.attrs["outcome"] == "served"
        hit = svc.query(distinct[0], k=1, timeout=WAIT)
        assert hit.cache_hit
        hit_tr = svc.trace(hit.trace_id)
        assert hit_tr.attrs["outcome"] == "cache_hit"
        assert {sp.name for sp in hit_tr.spans} == {"admit", "cache_lookup"}
        q = toks[1:3]
        with held_dispatcher(svc, engine, toks[4:7]):
            futs = [svc.submit(q, k=1) for _ in range(5)]
        sf = [f.result(timeout=WAIT) for f in futs]
        sf_traces = [svc.trace(s.trace_id) for s in sf]
        followers = [t for t in sf_traces if "coalesced_into" in t.links]
        assert len(followers) == 4
        assert {t.links["coalesced_into"] for t in followers} == \
            {t.trace_id for t in sf_traces if "coalesced_into" not in t.links}
        st = svc.tracer.stats()
        assert st["begun"] == st["finished"] == 11   # 2 blockers included
        assert len(svc.recent_traces(100)) == 11


def test_metrics_surface_matches_stats_and_is_monotone(engines):
    engine = engines[1][("torch", False)]
    toks = mid_df_tokens(engine.index, 4)
    with DKSService(engine, ServeConfig(max_batch=2, max_wait_ms=5.0,
                                        cache_size=8)) as svc:
        svc.query(toks[0:2], k=1, timeout=WAIT)
        svc.query(toks[0:2], k=1, timeout=WAIT)  # cache hit
        first = parse_prometheus(svc.registry.render())
        stats = svc.stats()
        assert first["dks_requests_total"] == stats.requests == 2
        assert first["dks_cache_hits_total"] == stats.cache_hits == 1
        assert first["dks_batch_dispatches_total"] == stats.batch_dispatches
        assert first["dks_request_latency_ms_count"] == stats.requests
        assert first["dks_engine_execute_count_total"] == \
            engine.execute_count
        assert first["dks_engine_traces_total"] == \
            engine.cache_stats["traces"]
        assert first["dks_traces_begun_total"] == \
            first["dks_traces_finished_total"] == 2
        reasons = sum(first[f"dks_dispatch_reason_{r}_total"]
                      for r in ("full", "window", "flush"))
        assert reasons == stats.batch_dispatches + stats.deadline_dispatches
        svc.query(toks[2:4], k=1, timeout=WAIT)
        second = parse_prometheus(svc.registry.render())
        for name in ("dks_requests_total", "dks_cache_misses_total",
                     "dks_batch_dispatches_total",
                     "dks_request_latency_ms_count"):
            assert second[name] > first[name], f"{name} must be monotone"
        assert second["dks_cache_hits_total"] == first["dks_cache_hits_total"]


def test_metrics_server_endpoints(engines):
    engine = engines[1][("torch", False)]
    toks = mid_df_tokens(engine.index, 2)
    with DKSService(engine, ServeConfig(max_batch=2, max_wait_ms=5.0,
                                        cache_size=8)) as svc:
        svc.query(toks, k=1, timeout=WAIT)
        server = MetricsServer(svc.registry, tracer=svc.tracer).start()
        try:
            def get(path):
                with urllib.request.urlopen(server.url + path,
                                            timeout=WAIT) as resp:
                    return resp.read().decode()

            assert get("/healthz").strip() == "ok"
            scraped = parse_prometheus(get("/metrics"))
            assert scraped["dks_requests_total"] == svc.stats().requests
            lines = [json.loads(ln)
                     for ln in get("/traces?n=8").splitlines() if ln]
            assert len(lines) == 1
            assert {"admit", "device_dispatch"} <= \
                {sp["name"] for sp in lines[0]["spans"]}
            one = json.loads(get(f"/traces?id={lines[0]['trace_id']}"))
            assert one["trace_id"] == lines[0]["trace_id"]
        finally:
            server.stop()
