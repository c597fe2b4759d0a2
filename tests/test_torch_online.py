"""PyTorch port, online serving: ``serve_forever``, deadline batching,
admission control, the self-healing ladder over a device ring, per-request
heads and the weight hot-swap of ``serve/circuit_engine.py``, on the CPU.

* Drain mode against the reference engine, weights carried across: under
  the same ``at=`` fault rules (and malformed members) ``run()`` fails the
  same requests, counts the same retries, bisects, failures and non-finite
  outputs, and serves the rest the reference's predictions
  (``assert_close``).
* The reference's behaviour tests of online serving, self-healing and the
  head registry, ported: each healthy member of a healed batch is bit for
  bit a fault-free run's; only a poison member fails; heads and hot swaps
  add no compile; an error outside the ladder's remit raises out of
  ``serve_forever`` and ``run()`` with every pending request failed.

No test depends on a wall-clock window: online tests wait on
``result(timeout=)`` with generous bounds and end with ``stop()``, a ring
that must see time pass runs on a probe interval that the test outwaits in
a bounded loop, and no test reads an order from completion timestamps
(the batcher's FIFO order is read from the trace's ``batch_formed``
events)."""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fault as jfault
import repro.graphs.generator as jgen
from repro.core.hetero_mp import HeteroMPConfig as JConfig
from repro.models.backbone import BackboneSpec as JSpec
from repro.models.hgnn import drcircuitgnn_forward, init_drcircuitgnn
from repro.serve.circuit_engine import CircuitServeEngine as JEngine
import repro_torch.graphs.generator as tgen
from repro_torch.core.hetero_mp import HeteroMPConfig
from repro_torch.fault import FaultInjector, FaultRule
from repro_torch.graphs.collate import LayoutTable
from repro_torch.kernels import drspmm as tk
from repro_torch.models.backbone import BackboneSpec
from repro_torch.models.hgnn import DRCircuitGNN
from repro_torch.obs import TraceRecorder
from repro_torch.serve.circuit_engine import (CircuitServeEngine,
                                              LoadShedError,
                                              NonFiniteInputError,
                                              NonFiniteOutputError,
                                              QueueFullError,
                                              WatchdogTimeoutError)
from repro_torch.sharding import DeviceRing, batch_devices
from _torch_port import HIDDEN, K, LAYERS, assert_close

CFG = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K)
JCFG = JConfig(hidden=HIDDEN, k_cell=K, k_net=K, backend="xla_fused")
WAIT = 240.0                 # result() / join() bound: never reached


def _pair(n_cell, n_net, seed):
    out = []
    for gen in (jgen, tgen):
        coo, xc, xn, y = gen.generate_partition(np.random.default_rng(seed),
                                                n_cell, n_net)
        out.append(gen.pack_graph_parallel(coo, n_cell, n_net, xc, xn, y))
    return tuple(out)


def _graph(n_cell, n_net, seed):
    return _pair(n_cell, n_net, seed)[1]


def _malformed(g):
    """Persistent poison: one feature row short of ``n_cell``, finite (it
    passes validation), in its bucket, and its collation always fails."""
    return dataclasses.replace(g, x_cell=g.x_cell[:-1])


@pytest.fixture(scope="module")
def params():
    return init_drcircuitgnn(jax.random.PRNGKey(0), 16, 16, HIDDEN, LAYERS)


def _model(params):
    return DRCircuitGNN.from_jax_params(jax.tree.map(np.asarray, params),
                                        device="cpu")


def _engine(params, **kw):
    kw.setdefault("max_wait_ms", 30.0)
    return CircuitServeEngine(_model(params), CFG, device="cpu", **kw)


def _serve_on_thread(eng):
    box = {}

    def run():
        try:
            eng.serve_forever()
        except BaseException as e:
            box["exc"] = e
    t = threading.Thread(target=run)
    t.start()
    return t, box


def _stop(eng, t, box):
    eng.stop()
    t.join(timeout=WAIT)
    assert not t.is_alive()
    assert "exc" not in box, box


def _reference(params, graphs, **kw):
    """Fault-free predictions of ``graphs`` (drain mode)."""
    eng = _engine(params, **kw)
    rids = [eng.submit(g) for g in graphs]
    eng.run()
    return [eng.result(r).pred for r in rids]


def _own(params, g):
    with torch.no_grad():
        return _model(params)(g, CFG).numpy()


# ---------------------------------------------------------------------------
# drain mode against the reference engine
# ---------------------------------------------------------------------------

DRAIN_CASES = {
    "retry": dict(rules=[dict(point="dispatch", at=(0,))]),
    "bisect": dict(rules=[dict(point="dispatch", at=(0, 1, 2))]),
    "nan-transient": dict(rules=[dict(point="nan_output", at=(0,))]),
    "nan-persistent": dict(rules=[dict(point="nan_output", at=(1, 2, 3))],
                           max_retries=1),
    "poison": dict(rules=[], poison=(2,), max_batch=4, max_retries=1),
    "poison-and-faults": dict(rules=[dict(point="dispatch", at=(2, 5)),
                                     dict(point="nan_output", at=(3,))],
                              poison=(1, 6)),
}


@pytest.mark.parametrize("name", sorted(DRAIN_CASES))
def test_drain_ladder_matches_reference(params, name):
    """``run()`` over one stream under the same fault schedule in both
    engines: the same requests fail with the same error type, the ladder
    counts agree, and every other prediction is the reference's."""
    case = DRAIN_CASES[name]
    kw = dict(max_batch=case.get("max_batch", 2),
              max_retries=case.get("max_retries", 2), retry_backoff_s=0.001)
    sizes = [(60, 30), (62, 29), (120, 60), (58, 31), (118, 61), (61, 30),
             (121, 58), (59, 29)]
    pairs = [_pair(c, n, 60 + i) for i, (c, n) in enumerate(sizes)]
    for i in case.get("poison", ()):
        pairs[i] = tuple(_malformed(g) for g in pairs[i])
    rules = case["rules"]
    jeng = JEngine(params, JCFG, chaos=jfault.FaultInjector(
        [jfault.FaultRule(**r) for r in rules], seed=3), **kw)
    teng = CircuitServeEngine(_model(params), CFG, device="cpu",
                              chaos=FaultInjector(
                                  [FaultRule(**r) for r in rules], seed=3),
                              **kw)
    outs = []
    for side, eng in enumerate((jeng, teng)):
        rids = [eng.submit(p[side]) for p in pairs]
        done = eng.run()
        outs.append([done[r] for r in rids])
        assert eng.chaos.counts() == jeng.chaos.counts()
    keys = ("requests", "batches", "failures", "retries", "bisects",
            "nonfinite_outputs")
    sj, st = jeng.stats(), teng.stats()
    assert {k: st[k] for k in keys} == {k: sj[k] for k in keys}
    for rj, rt in zip(*outs):
        assert (rj.error is None) == (rt.error is None), (rj.rid, rt.error)
        if rt.error is not None:
            assert type(rt.error).__name__ == type(rj.error).__name__
            continue
        assert_close(rt.pred, np.asarray(rj.pred))
    if "poison" in case:
        assert st["failures"] == len(case["poison"]) and st["bisects"] >= 1


def test_drain_healed_members_are_bit_identical(params):
    """Healthy members re-served by retries and bisection are bit for bit
    a fault-free run's."""
    graphs = [_graph(80, 40, s) for s in range(6)]
    poison = _malformed(_graph(80, 40, 99))
    eng = _engine(params, max_batch=4, max_retries=2, retry_backoff_s=0.001,
                  chaos=FaultInjector([FaultRule("dispatch", at=(1,)),
                                       FaultRule("nan_output", at=(0,))]))
    rids = [eng.submit(g) for g in graphs[:3] + [poison] + graphs[3:]]
    done = eng.run()
    refs = _reference(params, graphs)
    healthy = rids[:3] + rids[4:]
    for rid, ref in zip(healthy, refs):
        assert np.array_equal(done[rid].pred, ref)
    assert isinstance(done[rids[3]].error, ValueError)
    st = eng.stats()
    assert st["failures"] == 1 and st["bisects"] >= 1 and st["retries"] >= 2


# ---------------------------------------------------------------------------
# deadline batching and intake
# ---------------------------------------------------------------------------

def test_deadline_closes_partial_bucket(params):
    eng = _engine(params, max_batch=4, max_wait_ms=40.0)
    t, box = _serve_on_thread(eng)
    try:
        graphs = [_graph(50, 25, s) for s in range(2)]
        rids = [eng.submit(g) for g in graphs]      # 2 of 4: the deadline
        for rid, g in zip(rids, graphs):
            assert_close(eng.result(rid, timeout=WAIT).pred, _own(params, g))
    finally:
        _stop(eng, t, box)
    st = eng.stats()
    assert st["deadline_flushes"] >= 1 and st["requests"] == 2


def test_full_batch_needs_no_deadline(params):
    eng = _engine(params, max_batch=3, max_wait_ms=600_000.0)
    t, box = _serve_on_thread(eng)
    try:
        rids = [eng.submit(_graph(50, 25, 10 + s)) for s in range(3)]
        for rid in rids:
            eng.result(rid, timeout=WAIT)
    finally:
        _stop(eng, t, box)
    st = eng.stats()
    assert st["deadline_flushes"] == 0
    assert st["batches"] == 1 and st["requests"] == 3
    assert st["cell_padding_ratio"] < 3.0


def test_deadline_result_matches_drain_mode(params):
    graphs = [_graph(60, 30, s) for s in range(2)]
    eng = _engine(params, max_batch=4, max_wait_ms=20.0)
    t, box = _serve_on_thread(eng)
    try:
        rids = [eng.submit(g) for g in graphs]
        online = [eng.result(r, timeout=WAIT).pred for r in rids]
    finally:
        _stop(eng, t, box)
    for a, b in zip(online, _reference(params, graphs, max_batch=4)):
        assert np.array_equal(a, b)


def test_submit_during_serve_fifo_within_bucket(params):
    """Submits while serve_forever serves are all served, each its own
    forward; the batches a bucket forms take its requests in submit order
    (read from the trace's batch_formed events, not from timestamps)."""
    rec = TraceRecorder()
    eng = _engine(params, max_batch=2, max_wait_ms=15.0, recorder=rec)
    t, box = _serve_on_thread(eng)
    out = {}
    try:
        for wave in range(3):
            for s in range(3):
                g = _graph(48 + s, 24, 10 * wave + s)
                out[eng.submit(g)] = g
        for rid in out:
            eng.result(rid, timeout=WAIT)
    finally:
        _stop(eng, t, box)
    for rid, g in out.items():
        assert_close(eng.finished[rid].pred, _own(params, g))
    formed = [e["args"]["rids"] for e in rec.export()["traceEvents"]
              if e.get("name") == "batch_formed"]
    assert sorted(r for b in formed for r in b) == sorted(out)
    by_bucket = {}
    for b in formed:
        key = eng._group_key(out[b[0]])
        by_bucket.setdefault(key, []).extend(b)
    for rids in by_bucket.values():
        assert rids == sorted(rids)


def test_stop_drains_queue(params):
    eng = _engine(params, max_batch=4, max_wait_ms=600_000.0)
    rids = [eng.submit(_graph(52, 26, s)) for s in range(3)]
    t, box = _serve_on_thread(eng)
    _stop(eng, t, box)                 # a far deadline: only the drain
    assert set(rids) <= set(eng.finished)
    assert all(eng.finished[r].error is None for r in rids)


def test_serve_forever_stop_when_idle(params):
    eng = _engine(params, max_batch=2)
    rids = [eng.submit(_graph(52, 26, s)) for s in range(3)]
    eng.serve_forever(stop_when_idle=True)
    assert all(eng.result(r).pred is not None for r in rids)
    with pytest.raises(RuntimeError, match="while serve_forever"):
        eng._serving = True
        try:
            eng.run()
        finally:
            eng._serving = False


def test_max_finished_and_pop(params):
    eng = _engine(params, max_batch=1, max_finished=2)
    rids = [eng.submit(_graph(40, 20, s)) for s in range(4)]
    eng.run()
    assert len(eng.finished) == 2 and rids[0] not in eng.finished
    st = eng.stats()
    assert st["requests"] == 4 and st["p50_ms"] > 0
    assert eng.result(rids[-1], pop=True).pred is not None
    assert rids[-1] not in eng.finished


def test_result_timeout_and_unknown_head(params):
    eng = _engine(params)
    rid = eng.submit(_graph(40, 20, 0))
    with pytest.raises(TimeoutError):
        eng.result(rid, timeout=0.01)     # nothing serves: bounded wait
    with pytest.raises(KeyError, match="unknown head"):
        eng.submit(_graph(40, 20, 0), head="nope")


# ---------------------------------------------------------------------------
# bucket eviction
# ---------------------------------------------------------------------------

def test_bucket_eviction_lru(params):
    eng = _engine(params, max_batch=2, max_live_buckets=2)

    def serve_pair(n_cell, n_net, seed):
        for i in (0, 1):
            eng.submit(_graph(n_cell, n_net, seed + i))
        eng.run()

    serve_pair(40, 20, 0)
    serve_pair(90, 45, 10)
    assert (eng.live_buckets, eng.evictions, eng.compiles) == (2, 0, 2)
    serve_pair(160, 80, 20)
    assert (eng.live_buckets, eng.evictions, eng.compiles) == (2, 1, 3)
    serve_pair(91, 44, 30)
    serve_pair(158, 81, 40)
    assert eng.compiles == 3
    serve_pair(40, 20, 50)
    assert (eng.compiles, eng.evictions) == (4, 2)
    serve_pair(41, 19, 60)
    assert eng.compiles == 4 and eng.live_buckets == 2
    assert eng.stats()["live_compiles"] <= eng.compiles
    assert eng.metrics.value("layout.evictions") == 2


def test_eviction_under_one_off_tail(params):
    eng = _engine(params, max_batch=1, max_live_buckets=3)
    sizes = [(40, 20), (70, 35), (120, 60), (200, 100), (300, 150)]
    for i, (c, n) in enumerate(sizes):
        eng.submit(_graph(c, n, i))
        eng.run()
    assert eng.live_buckets <= 3 and len(eng._buckets) <= 3
    assert eng.evictions == len(sizes) - 3
    assert eng.stats()["requests"] == len(sizes)
    assert eng.metrics.value("layout.creates") == len(sizes)


def test_layout_table_lru_order():
    evicted = []
    rec = TraceRecorder()
    tab = LayoutTable(max_live=2, on_evict=lambda k, v: evicted.append(k),
                      recorder=rec)
    la = tab.get(("a",))
    tab.get(("b",))
    tab.get(("a",))
    tab.get(("c",))
    assert evicted == [("b",)]
    assert ("a",) in tab and ("c",) in tab and ("b",) not in tab
    assert tab.get(("a",)) is la and len(tab) == 2 and tab.evictions == 1
    names = [e["name"] for e in rec.export()["traceEvents"] if e["ph"] == "i"]
    assert names == ["bucket_create"] * 3 + ["bucket_evict"]


# ---------------------------------------------------------------------------
# the device ring
# ---------------------------------------------------------------------------

def test_two_slots_share_the_stream(params):
    """Two ring slots on the CPU: both dispatch, at most one compile a
    (signature, slot), every prediction its graph's own forward."""
    eng = _engine(params, max_batch=2, max_wait_ms=20.0,
                  devices=["cpu", "cpu"])
    assert len(eng.ring) == 2
    t, box = _serve_on_thread(eng)
    stream = [_graph(50 + (s % 3), 25, s) for s in range(12)]
    try:
        rids = [eng.submit(g) for g in stream]
        for rid in rids:
            eng.result(rid, timeout=WAIT)
    finally:
        _stop(eng, t, box)
    st = eng.stats()
    assert sum(st["dispatches_per_device"]) == st["batches"]
    assert all(c > 0 for c in st["dispatches_per_device"])
    assert eng.compiles <= 2
    for rid, g in zip(rids, stream):
        assert_close(eng.finished[rid].pred, _own(params, g))


def test_ring_defaults():
    """The engine's default ring on the CPU is the one CPU slot; on a card
    it is every visible card (``batch_devices``)."""
    assert batch_devices("cpu") == (torch.device("cpu"),)
    eng = CircuitServeEngine(DRCircuitGNN(16, 16, HIDDEN, LAYERS,
                                          device="cpu"), CFG, device="cpu")
    assert eng.ring.devices == (torch.device("cpu"),)
    ring = DeviceRing(batch_devices("cpu") * 2)
    assert [ring.next_index() for _ in range(4)] == [0, 1, 0, 1]


# ---------------------------------------------------------------------------
# the healing ladder, online
# ---------------------------------------------------------------------------

def test_retry_recovers_transient_dispatch_fault(params):
    chaos = FaultInjector([FaultRule("dispatch", at=(0,))])
    eng = _engine(params, max_batch=2, retry_backoff_s=0.01, chaos=chaos)
    t, box = _serve_on_thread(eng)
    graphs = [_graph(80, 40, s) for s in range(2)]
    try:
        rids = [eng.submit(g) for g in graphs]
        preds = [eng.result(r, timeout=WAIT).pred for r in rids]
    finally:
        _stop(eng, t, box)
    for p, ref in zip(preds, _reference(params, graphs)):
        assert np.array_equal(p, ref)
    st = eng.stats()
    assert st["retries"] >= 1 and st["failures"] == 0
    assert chaos.counts()["dispatch"] == 1


def test_bisect_isolates_poison_member(params):
    graphs = [_graph(80, 40, s) for s in range(4)]
    poison = _malformed(_graph(80, 40, 99))
    eng = _engine(params, max_batch=4, max_retries=1, retry_backoff_s=0.005)
    t, box = _serve_on_thread(eng)
    try:
        rids = [eng.submit(g) for g in (graphs[0], graphs[1], poison,
                                        graphs[2])]
        refs = _reference(params, graphs[:3])
        for rid, ref in zip((rids[0], rids[1], rids[3]), refs):
            assert np.array_equal(eng.result(rid, timeout=WAIT).pred, ref)
        with pytest.raises(RuntimeError) as ei:
            eng.result(rids[2], timeout=WAIT)
        assert isinstance(ei.value.__cause__, ValueError)
        assert eng.result(eng.submit(graphs[3]),
                          timeout=WAIT).pred is not None
    finally:
        _stop(eng, t, box)
    st = eng.stats()
    assert st["bisects"] >= 1 and st["failures"] == 1


@pytest.mark.parametrize("persistent", [False, True])
def test_nan_output(params, persistent):
    """A transient NaN output heals on a retry, bit for bit; one on every
    attempt ends as a diagnosed NonFiniteOutputError."""
    rule = FaultRule("nan_output", rate=1.0) if persistent \
        else FaultRule("nan_output", at=(0,))
    eng = _engine(params, max_batch=2, max_retries=1 if persistent else 2,
                  retry_backoff_s=0.005, chaos=FaultInjector([rule]))
    t, box = _serve_on_thread(eng)
    graphs = [_graph(80, 40, s) for s in range(2)]
    try:
        rids = [eng.submit(g) for g in graphs]
        if persistent:
            with pytest.raises(RuntimeError) as ei:
                eng.result(rids[0], timeout=WAIT)
            assert isinstance(ei.value.__cause__, NonFiniteOutputError)
            assert "non-finite predictions" in str(ei.value.__cause__)
        else:
            preds = [eng.result(r, timeout=WAIT).pred for r in rids]
    finally:
        _stop(eng, t, box)
    st = eng.stats()
    if persistent:
        assert st["nonfinite_outputs"] >= 2 and st["failures"] == 2
    else:
        for p, ref in zip(preds, _reference(params, graphs)):
            assert np.array_equal(p, ref)
        assert st["nonfinite_outputs"] == 1 and st["failures"] == 0


def test_watchdog_bounds_wedged_batch(params):
    """A preparation stalled far past the watchdog fails its request with
    WatchdogTimeoutError (result() returns, it does not wait out the
    stall), and the next request is served."""
    chaos = FaultInjector([FaultRule("straggler", at=(1,), delay_s=3.0)])
    eng = _engine(params, max_batch=1, max_retries=0, chaos=chaos)
    t, box = _serve_on_thread(eng)
    g = _graph(80, 40, 0)
    try:
        assert eng.result(eng.submit(g), timeout=WAIT).pred is not None
        eng.watchdog_s = 0.3
        with pytest.raises(RuntimeError) as ei:
            eng.result(eng.submit(g), timeout=WAIT)
        assert isinstance(ei.value.__cause__, WatchdogTimeoutError)
        assert eng.result(eng.submit(g), timeout=WAIT).pred is not None
    finally:
        _stop(eng, t, box)
    assert eng.stats()["watchdog_timeouts"] >= 1


def test_device_loss_quarantine_probe_readmission(params):
    """A lost slot fails until quarantined; serving goes on on the other;
    after the probe interval a probe finds it back and re-admits it; the
    retries absorb every loss."""
    chaos = FaultInjector([FaultRule("device_loss", at=(0,), device=1,
                                     down_for=4)])
    eng = _engine(params, max_batch=1, devices=["cpu", "cpu"],
                  quarantine_after=2, probe_interval_s=0.15, max_retries=3,
                  retry_backoff_s=0.01, chaos=chaos)
    t, box = _serve_on_thread(eng)
    g = _graph(80, 40, 0)
    saw = False
    try:
        deadline = time.monotonic() + WAIT
        while time.monotonic() < deadline:
            assert eng.result(eng.submit(g), timeout=WAIT).pred is not None
            h = eng.ring.health()
            saw = saw or "quarantined" in h["states"]
            if h["readmissions"] >= 1:
                break
            time.sleep(0.03)
    finally:
        _stop(eng, t, box)
    st = eng.stats()
    assert saw and st["quarantines"] >= 1 and st["probes"] >= 1
    assert st["readmissions"] >= 1 and st["failures"] == 0
    assert st["device_health"] == ["up", "up"]


def test_seeded_chaos_schedule_end_to_end(params):
    """One stream under a seeded schedule: a transient dispatch fault, a
    straggler, a lost slot, and a malformed member inside a full batch.
    Every healthy prediction is bit for bit a fault-free run's, only the
    malformed request fails, the slot is quarantined and probed back."""
    chaos = FaultInjector([
        FaultRule("dispatch", at=(1,)),
        FaultRule("straggler", at=(2,), delay_s=0.05),
        FaultRule("device_loss", at=(0,), device=1, down_for=3)], seed=42)
    eng = _engine(params, max_batch=2, devices=["cpu", "cpu"],
                  max_wait_ms=20.0, validate_inputs=False, watchdog_s=60.0,
                  max_retries=3, retry_backoff_s=0.01, quarantine_after=2,
                  probe_interval_s=0.1, chaos=chaos)
    bucket_a = [_graph(80, 40, s) for s in range(6)]
    bucket_b = [_graph(150, 75, 10 + s) for s in range(4)]
    poison = _malformed(_graph(150, 75, 99))
    t, box = _serve_on_thread(eng)
    rids = {}
    try:
        for g in bucket_a[:2] + bucket_b[:2] + bucket_a[2:4]:
            rids[eng.submit(g)] = g
        poison_rid = eng.submit(poison)
        rids[eng.submit(bucket_b[2])] = bucket_b[2]
        for g in bucket_a[4:] + bucket_b[3:]:
            rids[eng.submit(g)] = g
        for rid in rids:
            assert eng.result(rid, timeout=WAIT).pred is not None
        with pytest.raises(RuntimeError) as ei:
            eng.result(poison_rid, timeout=WAIT)
        assert isinstance(ei.value.__cause__, ValueError)
        deadline = time.monotonic() + WAIT
        while eng.ring.health()["readmissions"] < 1 \
                and time.monotonic() < deadline:
            assert eng.result(eng.submit(bucket_a[0]),
                              timeout=WAIT).pred is not None
            time.sleep(0.03)
    finally:
        _stop(eng, t, box)
    st = eng.stats()
    refs = _reference(params, list(rids.values()))
    for rid, ref in zip(rids, refs):
        assert np.array_equal(eng.result(rid).pred, ref), rid
    assert st["failures"] == 1 and st["retries"] >= 1 and st["bisects"] >= 1
    assert st["quarantines"] >= 1 and st["probes"] >= 1
    assert st["readmissions"] >= 1 and st["device_health"] == ["up", "up"]
    counts = chaos.counts()
    assert counts.get("dispatch") == 1 and counts.get("straggler") == 1
    assert counts.get("device_loss", 0) >= 1


# ---------------------------------------------------------------------------
# admission control
# ---------------------------------------------------------------------------

def test_admission_reject(params):
    eng = _engine(params, max_queue=2, admission="reject")
    g = _graph(60, 30, 0)
    eng.submit(g)
    eng.submit(g)
    with pytest.raises(QueueFullError):
        eng.submit(g)
    st = eng.stats()
    assert st["admission_rejected"] == 1 and st["queued"] == 2


def test_admission_shed_oldest(params):
    eng = _engine(params, max_queue=2, admission="shed_oldest")
    g = _graph(60, 30, 0)
    r1, r2 = eng.submit(g), eng.submit(g)
    r3 = eng.submit(g)
    with pytest.raises(RuntimeError) as ei:
        eng.result(r1, timeout=1.0)
    assert isinstance(ei.value.__cause__, LoadShedError)
    st = eng.stats()
    assert st["admission_shed"] == 1 and st["failures"] == 1
    eng.run()
    assert eng.result(r2).pred is not None and eng.result(r3).pred is not None


def test_admission_block_backpressures_producer(params):
    """A producer that meets a full queue waits until serving makes room
    (the server starts only once the producer is seen blocked)."""
    eng = _engine(params, max_queue=1, admission="block", max_batch=1)
    g = _graph(60, 30, 0)
    rids = [eng.submit(g)]
    producer = threading.Thread(
        target=lambda: rids.extend(eng.submit(g) for _ in range(5)))
    producer.start()
    deadline = time.monotonic() + WAIT
    while eng.stats()["admission_blocked"] < 1 \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    t, box = _serve_on_thread(eng)
    try:
        producer.join(timeout=WAIT)
        assert len(rids) == 6
        for r in rids:
            assert eng.result(r, timeout=WAIT).pred is not None
    finally:
        _stop(eng, t, box)
    st = eng.stats()
    assert st["admission_blocked"] >= 1
    assert st["failures"] == 0 and st["requests"] == 6


def test_admission_block_timeout(params):
    eng = _engine(params, max_queue=1, admission="block")
    g = _graph(60, 30, 0)
    eng.submit(g)
    with pytest.raises(TimeoutError, match="blocked on full queue"):
        eng.submit(g, timeout=0.05)
    assert eng.stats()["admission_blocked"] == 1
    with pytest.raises(ValueError, match="admission"):
        _engine(params, admission="lifo")


def test_nonfinite_input_rejected_at_submit(params):
    g = _graph(60, 30, 0)
    bad = dataclasses.replace(g, x_cell=torch.full_like(g.x_cell,
                                                        float("nan")))
    eng = _engine(params)
    with pytest.raises(NonFiniteInputError, match="x_cell"):
        eng.submit(bad)
    st = eng.stats()
    assert st["rejected_inputs"] == 1 and st["queued"] == 0
    eng2 = _engine(params, validate_inputs=False)
    eng2.submit(bad)
    assert eng2.stats()["queued"] == 1


# ---------------------------------------------------------------------------
# errors outside the ladder's remit
# ---------------------------------------------------------------------------

def _kernel_error(*_a, **_k):
    raise RuntimeError("drspmm_arena_fwd: CUDA error 9 (invalid "
                       "configuration argument)")


def _fail_kernels(monkeypatch):
    for name in ("drspmm_fwd_arena", "drspmm_dense_tier_fwd"):
        monkeypatch.setattr(tk, name, _kernel_error)


def test_kernel_error_raises_out_of_serve_forever(params, monkeypatch):
    """An error of a kernel wrapper is not retried or bisected: it fails
    every pending request and raises out of serve_forever."""
    _fail_kernels(monkeypatch)
    eng = _engine(params, max_batch=2, max_wait_ms=5.0)
    rids = [eng.submit(_graph(60, 30, s)) for s in range(3)]
    t, box = _serve_on_thread(eng)
    t.join(timeout=WAIT)
    assert not t.is_alive()
    assert "CUDA error 9" in str(box.get("exc"))
    for rid in rids:
        with pytest.raises(RuntimeError) as ei:
            eng.result(rid, timeout=1.0)
        assert "CUDA error 9" in str(ei.value.__cause__)
    st = eng.stats()
    assert st["retries"] == 0 and st["bisects"] == 0 and st["failures"] == 3


def test_kernel_error_raises_out_of_run(params, monkeypatch):
    _fail_kernels(monkeypatch)
    eng = _engine(params, max_batch=1)
    rids = [eng.submit(_graph(60, 30, s)) for s in range(2)]
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        eng.run()
    assert all(eng.finished[r].error is not None for r in rids)
    assert eng.stats()["retries"] == 0


# ---------------------------------------------------------------------------
# task heads and the hot swap
# ---------------------------------------------------------------------------

def test_head_registry_shares_backbone_zero_compiles():
    """Two named heads and the default over one backbone (depth 3,
    residual): one compile for all three, per-request selection, each
    prediction the forward with that head (and the reference's)."""
    gj = jgen.generate_design(3, "small", scale=0.03)[0]
    gt = tgen.generate_design(3, "small", scale=0.03)[0]
    params = init_drcircuitgnn(jax.random.PRNGKey(0), 16, 16, HIDDEN,
                               n_layers=3)
    spec = BackboneSpec(depth=3, hidden=HIDDEN, wiring="residual")
    jspec = JSpec(depth=3, hidden=HIDDEN, wiring="residual")
    model = _model(params)
    eng = CircuitServeEngine(model, CFG, spec=spec, max_batch=2,
                             device="cpu")
    hw_a = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(7), params.head_w.shape, jnp.float32, -0.2, 0.2))
    eng.register_head("taskA", hw_a)
    eng.register_head("taskB", -hw_a, np.asarray(params.head_b) + 0.5)
    assert eng.heads == ("taskA", "taskB")
    rids = {h: eng.submit(gt, head=h) for h in (None, "taskA", "taskB")}
    eng.run()
    preds = {h: eng.result(r).pred for h, r in rids.items()}
    assert eng.stats()["requests"] == 3 and eng.compiles == 1
    assert np.abs(preds["taskA"] - preds["taskB"]).max() > 1e-3
    assert np.abs(preds["taskA"] - preds[None]).max() > 1e-3
    with torch.no_grad():
        own = model(gt, CFG, spec, head=(torch.tensor(hw_a),
                                         model.head_b)).numpy()
    assert_close(preds["taskA"], own)
    assert_close(preds["taskA"], np.asarray(drcircuitgnn_forward(
        params._replace(head_w=jnp.asarray(hw_a)), gj, JCFG, jspec)))
    with pytest.raises(KeyError, match="unknown head"):
        eng.submit(gt, head="nope")
    with pytest.raises(ValueError, match="shapes"):
        eng.register_head("bad", np.zeros((7, 1), np.float32))


def test_head_registry_survives_update_params():
    """A swap replaces the backbone and the default head; registered heads
    keep serving; no compile; each result records its version."""
    g = tgen.generate_design(3, "small", scale=0.03)[0]
    p0 = init_drcircuitgnn(jax.random.PRNGKey(0), 16, 16, HIDDEN, 2)
    p1 = init_drcircuitgnn(jax.random.PRNGKey(1), 16, 16, HIDDEN, 2)
    eng = CircuitServeEngine(_model(p0), CFG, max_batch=1, device="cpu")
    hw = np.asarray(jax.random.uniform(jax.random.PRNGKey(9),
                                       p0.head_w.shape, jnp.float32,
                                       -0.3, 0.3))
    eng.register_head("fixed", hw)
    r0 = eng.submit(g, head="fixed")
    eng.run()
    before = eng.result(r0).pred
    c0 = eng.compiles
    assert eng.update_params(_model(p1)) == eng.params_version == 1
    assert eng.heads == ("fixed",)
    r1, r2 = eng.submit(g, head="fixed"), eng.submit(g)
    eng.run()
    after, default_after = eng.result(r1).pred, eng.result(r2).pred
    assert eng.compiles == c0
    assert np.abs(after - before).max() > 1e-6
    assert np.abs(after - default_after).max() > 1e-6
    assert eng.result(r0).params_version == 0
    assert eng.result(r1).params_version == eng.result(r2).params_version == 1
    assert np.array_equal(default_after, _own(p1, g))


def test_update_params_checks_state_and_keeps_caller_model(params):
    model = _model(params)
    eng = CircuitServeEngine(model, CFG, device="cpu")
    state = {k: v + 1.0 for k, v in model.state_dict().items()}
    with pytest.raises(ValueError, match="shape"):
        eng.update_params({**state, "head_b": torch.zeros(2)})
    with pytest.raises(ValueError, match="keys"):
        eng.update_params({k: v for k, v in state.items() if k != "head_b"})
    assert eng.params_version == 0
    assert eng.update_params(state) == 1
    assert torch.equal(eng.model.head_b, state["head_b"])
    assert not torch.equal(model.head_b, state["head_b"])   # a replica


def test_online_swap_each_result_matches_its_version(params):
    """A swap while requests are in flight: every result is bit for bit
    the forward of its graph under the weights of the version it
    reports."""
    p1 = init_drcircuitgnn(jax.random.PRNGKey(1), 16, 16, HIDDEN, LAYERS)
    eng = _engine(params, max_batch=2, max_wait_ms=5.0)
    t, box = _serve_on_thread(eng)
    graphs = [_graph(60 + s, 30, s) for s in range(6)]
    try:
        rids = [eng.submit(g) for g in graphs[:3]]
        assert eng.update_params(_model(p1)) == 1
        rids += [eng.submit(g) for g in graphs[3:]]
        res = [eng.result(r, timeout=WAIT) for r in rids]
    finally:
        _stop(eng, t, box)
    assert all(r.params_version == 1 for r in res[3:])
    by_version = {0: params, 1: p1}
    for r in res:
        alone = _reference(by_version[r.params_version], [r.graph],
                           max_batch=2)[0]
        assert np.array_equal(r.pred, alone)


def test_concurrent_submit_stress(params):
    """More producer threads than cores submit while serve_forever serves
    over two slots, with a short thread switch interval: every request is
    served exactly once, each its own graph's prediction, and nothing is
    left outstanding."""
    import os
    import sys
    graphs = [_graph(40 + (s % 3), 20, 300 + s) for s in range(6)]
    own = [_own(params, g) for g in graphs]
    eng = _engine(params, max_batch=2, max_wait_ms=2.0,
                  devices=["cpu", "cpu"], max_queue=4)
    n_threads = 2 * (os.cpu_count() or 4)
    got = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t, box = _serve_on_thread(eng)

        def produce(k):
            for j in range(3):
                i = (k + j) % len(graphs)
                got.append((eng.submit(graphs[i], timeout=WAIT), i))
        ps = [threading.Thread(target=produce, args=(k,))
              for k in range(n_threads)]
        for p in ps:
            p.start()
        for p in ps:
            p.join(timeout=WAIT)
        assert not any(p.is_alive() for p in ps)
        preds = {rid: eng.result(rid, timeout=WAIT).pred for rid, _ in got}
        _stop(eng, t, box)
    finally:
        sys.setswitchinterval(old)
    assert len(preds) == len(got) == 3 * n_threads
    for rid, i in got:
        assert_close(preds[rid], own[i])
    st = eng.stats()
    assert st["requests"] == len(got) and st["failures"] == 0
    assert not eng._outstanding and not eng.queue
