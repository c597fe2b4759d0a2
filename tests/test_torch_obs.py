"""PyTorch port, observability: the metrics registry and the trace
recorder against the JAX package's (the same operations give the same
``snapshot()``, Prometheus text and trace event structure), their unit
behaviour, the collator's pack-time arena and tier gauges against the
reference's on the same graphs, the ops layer's dispatch counters, the
engine's ``stats()`` as a view of its registry with the reference engine's
keys, the trainer's registry, and the healing ladder and chaos injections
as trace annotations.  Everything runs on the CPU; nothing depends on a
wall-clock window (timings only feed values that are compared with
themselves)."""

import importlib.util
import json
import os
import threading

import numpy as np
import pytest

import jax

import repro.graphs.collate as jcollate
import repro.graphs.generator as jgen
import repro.obs.metrics as jmetrics
import repro.obs.trace as jtrace
from repro.core.hetero_mp import HeteroMPConfig as JConfig
from repro.models.hgnn import init_drcircuitgnn
from repro.serve.circuit_engine import CircuitServeEngine as JEngine
import repro_torch.graphs.collate as tcollate
import repro_torch.graphs.generator as tgen
import repro_torch.obs.metrics as tmetrics
import repro_torch.obs.trace as ttrace
from repro_torch.core.hetero_mp import HeteroMPConfig
from repro_torch.fault import FaultInjector, FaultRule
from repro_torch.graphs.ell import DENSE_TIER_NNZ
from repro_torch.models.hgnn import DRCircuitGNN
from repro_torch.obs import (DEFAULT_REGISTRY, NULL_RECORDER, NULL_SPAN,
                             Counter, Gauge, Histogram, MetricsRegistry,
                             Recorder, TraceRecorder, default_registry)
from repro_torch.serve.circuit_engine import CircuitServeEngine
from repro_torch.train.circuit_trainer import (CircuitTrainConfig,
                                               CircuitTrainer)
from repro_torch.train.metrics import percentile
from _torch_port import HIDDEN, K, LAYERS

_spec = importlib.util.spec_from_file_location(
    "check_trace",
    os.path.join(os.path.dirname(__file__), "..", "tools", "check_trace.py"))
_ct = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_ct)
check_trace = _ct.check_trace

# the reference engine's stats() keys but jit_cache_size, which only a JAX
# jit cache has
STATS_KEYS = {
    "requests", "batches", "compiles", "graphs_per_s", "p50_ms", "p95_ms",
    "p99_ms", "wall_s", "cell_padding_ratio", "deadline_flushes",
    "failures", "retries", "bisects", "watchdog_timeouts",
    "nonfinite_outputs", "rejected_inputs", "admission_blocked",
    "admission_rejected", "admission_shed", "queued", "device_health",
    "quarantines", "probes", "readmissions", "devices",
    "dispatches_per_device", "live_buckets", "evictions", "live_compiles",
    "params_version"}


def _pair(n_cell, n_net, seed):
    """(reference, port) graphs of one seeded partition."""
    out = []
    for gen in (jgen, tgen):
        coo, xc, xn, y = gen.generate_partition(np.random.default_rng(seed),
                                                n_cell, n_net)
        out.append(gen.pack_graph_parallel(coo, n_cell, n_net, xc, xn, y))
    return tuple(out)


def _graph(n_cell, n_net, seed):
    return _pair(n_cell, n_net, seed)[1]


def _engine(**kw):
    model = DRCircuitGNN(16, 16, HIDDEN, LAYERS, device="cpu")
    return CircuitServeEngine(model, HeteroMPConfig(hidden=HIDDEN, k_cell=K,
                                                    k_net=K),
                              max_batch=2, device="cpu", **kw)


# ---------------------------------------------------------------------------
# parity with the reference: registry, exposition, trace structure
# ---------------------------------------------------------------------------

def _registry_ops(mod):
    """One sequence of registry operations, run on module ``mod``'s
    classes."""
    r = mod.MetricsRegistry()
    r.inc("serve.requests", 5)
    r.inc("serve.requests")
    r.counter("serve.dispatches", device=0).inc(3)
    r.counter("serve.dispatches", device=1).inc(2.5)
    r.set("arena.fill_ratio", 0.75, etype="near", dir="fwd")
    r.gauge("arena.fill_ratio", etype="pin", dir="bwd").add(-0.125)
    r.set("layout.live", 1e-7)
    for v in (12.0, 3.5, 7.25, 1e3, 0.1):
        r.observe("serve.latency_ms", v)
    h = r.histogram("train.step_ms", reservoir=3, host=0)
    for v in range(10):
        h.observe(float(v) / 3)
    r.histogram("empty.hist")
    return r


def test_registry_snapshot_and_prometheus_match_reference():
    a, b = _registry_ops(jmetrics), _registry_ops(tmetrics)
    assert a.snapshot() == b.snapshot()
    assert a.to_prometheus() == b.to_prometheus()
    assert a.snapshot_json(sort_keys=True) == b.snapshot_json(sort_keys=True)
    assert a.value("serve.requests") == b.value("serve.requests") == 6
    assert set(a.series("serve.dispatches")) == \
        set(b.series("serve.dispatches"))


def _trace_ops(mod):
    rec = mod.TraceRecorder()
    rec.instant("intake", "submit", rid=0, bucket="(8, 8)")
    with rec.span("worker/0", "collate", batch=2):
        with rec.span("worker/0", "device_put", device=0):
            pass
    try:
        with rec.span("worker/1", "collate"):
            raise ValueError("bad member")
    except ValueError:
        pass
    rec.complete("device/0", "batch", 10.0, 5.0, requests=2)
    rec.complete("device/1", "batch", 3.0, -1.0)
    rec.instant("healing", "retry", attempt=0, error="InjectedFault")
    rec.instant("chaos", "inject:dispatch", occurrence=0, device=1)
    return rec.export()


def _structure(doc):
    """Everything of a trace but the timestamps and the process name."""
    out = []
    for e in doc["traceEvents"]:
        e = dict(e)
        if e["ph"] != "X":
            e.pop("ts", None)
        if e.get("name") == "process_name":
            e["args"] = None
        out.append(e)
    return sorted(out, key=lambda e: json.dumps(e, sort_keys=True))


def test_trace_structure_matches_reference():
    a, b = _trace_ops(jtrace), _trace_ops(ttrace)
    assert _structure(a) == _structure(b)
    assert set(a) == set(b)
    assert check_trace(b, expect_device_tracks=2) == []


def test_bounded_trace_matches_reference():
    docs = []
    for mod in (jtrace, ttrace):
        rec = mod.TraceRecorder(max_events=3)
        for i in range(7):
            rec.instant("t", f"e{i}", i=i)
        docs.append(rec.export())
        assert len(rec) == 3 and rec.dropped == 4
    assert _structure(docs[0]) == _structure(docs[1])
    assert docs[0]["otherData"] == docs[1]["otherData"]


# ---------------------------------------------------------------------------
# registry units
# ---------------------------------------------------------------------------

def test_counter_and_gauge():
    c, g = Counter(), Gauge()
    c.inc()
    c.inc(2.5)
    g.set(4.0)
    g.add(-1.5)
    assert (c.value, g.value) == (3.5, 2.5)


def test_histogram_percentiles_are_the_ports_percentile():
    h = Histogram()
    vals = [float(v) for v in range(1, 101)]
    for v in vals:
        h.observe(v)
    for p in (0.50, 0.95, 0.99):
        assert h.percentile(p) == percentile(sorted(vals), p)
    s = h.summary()
    assert (s["count"], s["min"], s["max"]) == (100, 1.0, 100.0)
    assert s["mean"] == pytest.approx(50.5)
    assert set(s) == {"count", "sum", "min", "max", "mean", "p50", "p95",
                      "p99"}


def test_histogram_reservoir_bounds_window_not_count():
    h = Histogram(reservoir=8)
    for v in range(100):
        h.observe(float(v))
    assert h.count == 100 and h.window() == [float(v)
                                             for v in range(92, 100)]
    assert h.percentile(0.0) == 92.0
    assert Histogram().percentile(0.5) == 0.0 and Histogram().mean == 0.0


def test_registry_identity_labels_and_kinds():
    r = MetricsRegistry()
    assert r.counter("x") is r.counter("x")
    d0 = r.counter("d", device=0)
    assert d0 is not r.counter("d", device=1)
    d0.inc(3)
    assert r.value("d", device=0) == 3
    assert r.value("d", device=2, default=-1) == -1
    assert len(r) == 3           # reading a missing series created none
    with pytest.raises(ValueError):
        r.gauge("x")
    with pytest.raises(ValueError):
        r.histogram("x")
    assert default_registry() is DEFAULT_REGISTRY


def test_registry_thread_safety():
    r = MetricsRegistry()
    c, h = r.counter("hits"), r.histogram("lat")
    got = []
    barrier = threading.Barrier(8)

    def work():
        barrier.wait()
        got.append(r.counter("shared", lane=1))
        for i in range(500):
            c.inc()
            h.observe(float(i))
    ts = [threading.Thread(target=work) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert c.value == h.count == 4000
    assert all(g is got[0] for g in got)


# ---------------------------------------------------------------------------
# recorder units
# ---------------------------------------------------------------------------

def test_null_recorder_emits_nothing(tmp_path):
    rec = NULL_RECORDER
    assert rec.enabled is False and isinstance(TraceRecorder(), Recorder)
    rec.begin("t", "a")
    rec.end("t", "a")
    rec.instant("t", "b", k=1)
    rec.complete("t", "c", 0.0, 1.0)
    with rec.span("t", "d"):
        pass
    assert rec.span("t", "x") is rec.span("u", "y") is NULL_SPAN
    assert rec.export() == {"traceEvents": []} and rec.now() == 0.0
    p = tmp_path / "t.json"
    rec.dump(str(p))
    assert json.loads(p.read_text()) == {"traceEvents": []}


def test_trace_export_schema(tmp_path):
    rec = TraceRecorder()
    rec.instant("intake", "submit", rid=0)
    with rec.span("worker/0", "collate"):
        pass
    t0 = rec.now()
    rec.complete("device/0", "batch", t0, rec.now() - t0, requests=2)
    p = tmp_path / "t.json"
    rec.dump(str(p))
    doc = json.loads(p.read_text())
    assert check_trace(doc, expect_device_tracks=1) == []
    assert doc["traceEvents"][0]["name"] == "process_name"
    data = [e for e in doc["traceEvents"] if e["ph"] != "M"]
    assert [e["ts"] for e in data] == sorted(e["ts"] for e in data)
    # crossed and unclosed spans fail the checker
    bad = TraceRecorder()
    bad.begin("t", "outer")
    bad.begin("t", "inner")
    bad.end("t", "outer")
    assert check_trace(bad.export()) != []


def test_trace_concurrent_emission():
    rec = TraceRecorder()

    def work(k):
        for i in range(100):
            with rec.span(f"worker/{k}", "step", i=i):
                pass
    ts = [threading.Thread(target=work, args=(k,)) for k in range(6)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(rec) == 1200
    assert check_trace(rec.export(), expect_device_tracks=0) == []


# ---------------------------------------------------------------------------
# pack-time gauges and dispatch counters
# ---------------------------------------------------------------------------

ARENA_GAUGES = ("fill_ratio", "padded_slots", "slots", "chunk",
                "slot_saving")
TIER_GAUGES = ("tier", "tier_nnz", "tier_threshold")


@pytest.mark.parametrize("sizes", [((220, 110), (230, 100)),
                                   ((60, 30), (55, 28), (64, 31))])
def test_collate_gauges_match_reference(sizes):
    """The same graphs collated by both packages leave the same arena
    gauges (per edge-type direction and the plan's super-arenas) and the
    same tier gauges in their default registries."""
    pairs = [_pair(c, n, 40 + i) for i, (c, n) in enumerate(sizes)]
    jcollate.collate_graphs([p[0] for p in pairs])
    tcollate.collate_graphs([p[1] for p in pairs], device="cpu")
    jreg = jmetrics.DEFAULT_REGISTRY
    keys = [("arena." + g, et, d) for g in ARENA_GAUGES
            for et in ("near", "pin", "pinned") for d in ("fwd", "bwd")]
    keys += [("arena." + g, "__plan__", d)
             for g in ("slots", "padded_slots", "fill_ratio", "chunk")
             for d in ("fwd", "bwd")]
    keys += [("arena." + g, et, d) for g in TIER_GAUGES
             for et in ("near", "pin", "pinned") for d in ("fwd", "bwd")]
    for name, et, d in keys:
        a = jreg.value(name, default=None, etype=et, dir=d)
        b = DEFAULT_REGISTRY.value(name, default=None, etype=et, dir=d)
        assert a is not None and a == b, (name, et, d, a, b)


def test_tier_gauges_report_the_rule():
    gs = [_graph(220, 110, s) for s in range(4)]
    tcollate.collate_graphs(gs, device="cpu")
    for et in ("near", "pin", "pinned"):
        for d in ("fwd", "bwd"):
            tier = DEFAULT_REGISTRY.value("arena.tier", etype=et, dir=d)
            nnz = DEFAULT_REGISTRY.value("arena.tier_nnz", etype=et, dir=d)
            assert DEFAULT_REGISTRY.value("arena.tier_threshold", etype=et,
                                          dir=d) == DENSE_TIER_NNZ
            assert tier in (0.0, 1.0) and nnz > 0
            if nnz > DENSE_TIER_NNZ:
                assert tier == 0.0
    saving = DEFAULT_REGISTRY.value("arena.slot_saving", etype="near",
                                    dir="fwd")
    assert saving >= 1.5


def test_ops_dispatch_counters_count_op_calls():
    """Each op call counts once under its route (device type and
    executor family) and kind."""
    def counts():
        return {dict(k)["family"] + ":" + dict(k)["kind"]: m.value
                for k, m in DEFAULT_REGISTRY.series("ops.dispatch").items()}
    before = counts()
    eng = _engine()
    eng.submit(_graph(50, 25, 0))
    eng.run()
    after = counts()
    grown = {k: after[k] - before.get(k, 0.0) for k in after
             if after[k] != before.get(k, 0.0)}
    # the plan path: one arena (multi_fwd) call a layer, at most one dense
    # tier call a layer, on the CPU route
    assert grown.get("cpu_fused:multi_fwd", 0) + \
        grown.get("cpu_fused:multi_dense_fwd", 0) >= LAYERS
    assert all(k.startswith("cpu_") for k in grown)
    assert all(set(dict(lab)) == {"family", "kind"}
               for lab in DEFAULT_REGISTRY.series("ops.dispatch"))


# ---------------------------------------------------------------------------
# the engine's registry, exports and trace
# ---------------------------------------------------------------------------

def test_stats_keys_match_reference_engine():
    params = init_drcircuitgnn(jax.random.PRNGKey(0), 16, 16, HIDDEN,
                               LAYERS)
    jeng = JEngine(params, JConfig(hidden=HIDDEN, k_cell=K, k_net=K,
                                   backend="xla_fused"), max_batch=2)
    teng = _engine()
    for s in range(4):
        gj, gt = _pair(50 + (s % 2), 25, s)
        jeng.submit(gj)
        teng.submit(gt)
    jeng.run()
    teng.run()
    sj, st = jeng.stats(), teng.stats()
    assert set(st) == STATS_KEYS == set(sj) - {"jit_cache_size"}
    for key in ("requests", "batches", "compiles", "failures", "devices",
                "dispatches_per_device", "live_buckets", "live_compiles",
                "cell_padding_ratio", "params_version"):
        assert st[key] == sj[key], key
    assert isinstance(st["requests"], int)
    assert teng.metrics.value("serve.requests") == st["requests"] == 4
    assert sum(st["dispatches_per_device"]) == st["batches"]
    assert st["p99_ms"] >= st["p50_ms"] > 0.0


def test_noop_recorder_default_and_exports(tmp_path):
    eng = _engine()
    eng.submit(_graph(50, 25, 0))
    eng.run()
    assert eng.recorder is NULL_RECORDER
    p = tmp_path / "empty.json"
    eng.dump_trace(str(p))
    assert json.loads(p.read_text()) == {"traceEvents": []}
    snap = eng.metrics_snapshot()
    assert snap["serve.requests"] == 1
    assert snap["serve.latency_ms"]["count"] == 1
    text = eng.metrics_text()
    assert "serve_requests 1" in text
    assert "# TYPE serve_latency_ms summary" in text
    json.loads(eng.metrics.snapshot_json())
    traced = _engine(recorder=TraceRecorder())
    traced.submit(_graph(50, 25, 0))
    traced.run()
    assert set(traced.stats()) == set(eng.stats())


def test_chaos_and_ladder_annotated_in_trace(tmp_path):
    """Dispatch faults on occurrences 0..2 exhaust two retries and force a
    bisect: each rung is an instant of the trace, as many as the counters
    say, with the injections on the chaos track and the batches on the
    slot's track."""
    rec = TraceRecorder()
    chaos = FaultInjector([FaultRule("dispatch", at=(0, 1, 2))])
    eng = _engine(recorder=rec, chaos=chaos)
    for s in range(2):
        eng.submit(_graph(50, 25, s))
    assert len(eng.run()) == 2
    st = eng.stats()
    # two retries of the pair, then each half's first (successful) retry
    assert st["retries"] == 4 and st["bisects"] == 1 and st["failures"] == 0
    doc = rec.export()
    assert check_trace(doc, expect_device_tracks=1, expect_events=(
        "inject:dispatch", "retry", "bisect", "batch", "submit", "collate",
        "device_put", "bucket_create", "compile")) == []
    names = [e["name"] for e in doc["traceEvents"] if e["ph"] != "M"]
    assert names.count("inject:dispatch") == 3
    assert names.count("retry") == st["retries"]
    assert names.count("bisect") == st["bisects"]
    p = tmp_path / "chaos.json"
    eng.dump_trace(str(p))
    assert check_trace(json.loads(p.read_text())) == []


def test_online_deadline_flush_annotated_in_trace():
    rec = TraceRecorder()
    eng = _engine(recorder=rec, max_wait_ms=15.0)
    server = threading.Thread(target=eng.serve_forever)
    server.start()
    rid = eng.submit(_graph(50, 25, 0))     # alone: flushed by deadline
    eng.result(rid, timeout=600.0)
    eng.stop()
    server.join(timeout=600.0)
    assert eng.stats()["deadline_flushes"] >= 1
    assert check_trace(rec.export(),
                       expect_events=("deadline_flush",)) == []


# ---------------------------------------------------------------------------
# the trainer's registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
def test_trainer_stats_and_step_histogram(remat):
    gs = [_graph(40, 20, 100 + s) for s in range(3)]
    reg = MetricsRegistry()
    tr = CircuitTrainer(CircuitTrainConfig(hidden=HIDDEN, k_cell=K, k_net=K,
                                           epochs=1, remat=remat), 16, 16,
                        device="cpu", registry=reg,
                        recorder=TraceRecorder())
    tr.train_epoch(gs)
    st = tr.stats()
    assert set(st) == {"steps", "nonfinite_grad_steps", "step_p50_ms",
                       "step_p95_ms", "step_p99_ms", "peak_memory_bytes",
                       "recompute_ms"}
    assert st["steps"] == 3 and st["nonfinite_grad_steps"] == 0
    assert st["step_p50_ms"] > 0.0
    assert reg.value("train.steps") == 3 and tr.metrics is reg
    n_bytes = sum(p.numel() * 4 for p in tr.params) * 3
    assert st["peak_memory_bytes"] == n_bytes   # params + both moments
    assert (st["recompute_ms"] > 0.0) == remat
    assert reg.histogram("train.step_ms").count == 3
