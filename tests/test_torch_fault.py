"""PyTorch port, faults: the chaos injector, the step monitor, the elastic
controller, the heartbeat and the device ring, each against the JAX
package's on the same inputs (one seed fires the same occurrences and
records the same events; one sequence of ring operations under one
injected clock gives the same routing, quarantines, probes and
re-admissions), their unit behaviour, and the trainer's chaos and monitor
hooks.  CPU only; the ring runs on an injected clock, so no test depends
on a wall-clock window."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import repro.fault as jfault
import repro.sharding.specs as jspecs
import repro_torch.fault as tfault
import repro_torch.sharding.specs as tspecs
import repro_torch.graphs.generator as tgen
from repro_torch.fault import (POINTS, ElasticController, FaultInjector,
                               FaultRule, Heartbeat, InjectedFault,
                               StepMonitor)
from repro_torch.sharding import DeviceRing, batch_devices
from repro_torch.train.circuit_trainer import (CircuitTrainConfig,
                                               CircuitTrainer)
from _torch_port import HIDDEN, K


def _graph(n_cell, n_net, seed):
    coo, xc, xn, y = tgen.generate_partition(np.random.default_rng(seed),
                                             n_cell, n_net)
    return tgen.pack_graph_parallel(coo, n_cell, n_net, xc, xn, y)


# ---------------------------------------------------------------------------
# parity with the reference injector
# ---------------------------------------------------------------------------

RULE_SETS = {
    "at": [dict(point="collate", at=(1, 3)), dict(point="dispatch", at=(0,))],
    "rate": [dict(point="dispatch", rate=0.3),
             dict(point="device_put", rate=0.5, n=4)],
    "device": [dict(point="device_put", at=(0, 2), device=1),
               dict(point="dispatch", rate=0.2, device=0)],
    "loss": [dict(point="device_loss", at=(1,), device=1, down_for=4),
             dict(point="device_loss", rate=0.1, device=0, down_for=2),
             dict(point="dispatch", at=(5,))],
    "mixed": [dict(point="straggler", at=(1,), delay_s=0.0),
              dict(point="straggler", rate=0.4, delay_s=0.0),
              dict(point="nan_output", at=(0, 2), n=1),
              dict(point="nan_output", rate=0.25)],
}


def _drive(mod, rules, seed):
    """One fixed sequence of touches of every point on ``mod``'s injector:
    the firings (point, occurrence, slot or delay) and the event log."""
    inj = mod.FaultInjector([mod.FaultRule(**r) for r in rules], seed=seed)
    rng = np.random.default_rng(1)
    out = np.ones(3, np.float32)
    fired = []
    for _ in range(60):
        what = int(rng.integers(5))
        dev = int(rng.integers(2))
        if what < 3:
            point = ("collate", "device_put", "dispatch")[what]
            try:
                inj.raise_if(point, device=None if point == "collate"
                             else dev)
                fired.append(None)
            except mod.InjectedFault as e:
                fired.append((e.point, e.occurrence, e.device))
        elif what == 3:
            fired.append(("stall", inj.stall()))
        else:
            fired.append(("poison", bool(np.isnan(inj.poison(out)).all())))
    events = [(e.point, e.occurrence, e.device) for e in inj.events]
    return fired, events, inj.counts()


@pytest.mark.parametrize("seed", [0, 7, 42])
@pytest.mark.parametrize("name", sorted(RULE_SETS))
def test_injector_schedule_matches_reference(name, seed):
    assert _drive(jfault, RULE_SETS[name], seed) == \
        _drive(tfault, RULE_SETS[name], seed)


def test_points_and_fault_message_match_reference():
    assert tfault.POINTS == jfault.POINTS
    a = str(jfault.InjectedFault("dispatch", 3, 1))
    assert a == str(tfault.InjectedFault("dispatch", 3, 1))


# ---------------------------------------------------------------------------
# injector units
# ---------------------------------------------------------------------------

def _fires(inj, point, n, device=None):
    pat = []
    for _ in range(n):
        try:
            inj.raise_if(point, device=device)
            pat.append(False)
        except InjectedFault:
            pat.append(True)
    return pat


def test_unknown_point_rejected():
    with pytest.raises(ValueError, match="unknown injection point"):
        FaultRule("warp_drive")
    for p in POINTS:
        FaultRule(p)


def test_at_rate_and_cap():
    inj = FaultInjector([FaultRule("collate", at=(1, 3))])
    assert _fires(inj, "collate", 6) == [False, True, False, True, False,
                                         False]
    assert inj.counts() == {"collate": 2}
    mk = lambda seed: FaultInjector([FaultRule("dispatch", rate=0.5)],
                                    seed=seed)
    a = _fires(mk(7), "dispatch", 100)
    assert a == _fires(mk(7), "dispatch", 100)
    assert a != _fires(mk(8), "dispatch", 100)
    assert 10 < sum(a) < 90
    capped = FaultInjector([FaultRule("collate", rate=1.0, n=2)])
    assert _fires(capped, "collate", 5) == [True, True, False, False, False]


def test_device_filter_and_fault_fields():
    inj = FaultInjector([FaultRule("device_put", at=(0,), device=1)])
    assert _fires(inj, "device_put", 3, device=0) == [False] * 3
    assert _fires(inj, "device_put", 2, device=1) == [True, False]
    assert (inj.events[0].point, inj.events[0].device) == ("device_put", 1)
    inj = FaultInjector([FaultRule("dispatch", at=(0,))])
    with pytest.raises(InjectedFault) as ei:
        inj.raise_if("dispatch", device=2)
    assert (ei.value.point, ei.value.device) == ("dispatch", 2)
    assert "slot 2" in str(ei.value)


def test_stall_and_poison():
    inj = FaultInjector([FaultRule("straggler", at=(1,), delay_s=0.01),
                         FaultRule("nan_output", at=(1,))])
    assert [inj.stall() for _ in range(3)] == [0.0, 0.01, 0.0]
    out = np.ones((4, 2), np.float32)
    assert inj.poison(out) is out
    bad = inj.poison(out)
    assert np.isnan(bad).all() and np.isfinite(out).all()
    assert inj.poison(out) is out
    assert inj.counts() == {"straggler": 1, "nan_output": 1}


def test_device_loss_down_window():
    inj = FaultInjector([FaultRule("device_loss", at=(0,), device=1,
                                   down_for=3)])
    assert _fires(inj, "device_put", 2, device=0) == [False, False]
    pat = []
    for _ in range(5):
        try:
            inj.raise_if("dispatch", device=1)
            pat.append(None)
        except InjectedFault as e:
            pat.append(e.point)
    assert pat == ["device_loss"] * 3 + [None, None]
    assert _fires(inj, "device_put", 2, device=0) == [False, False]


def test_injector_cap_holds_under_threads():
    inj = FaultInjector([FaultRule("dispatch", rate=0.3, n=50)])
    hits = []

    def work():
        for _ in range(200):
            try:
                inj.raise_if("dispatch")
            except InjectedFault:
                hits.append(1)
    ts = [threading.Thread(target=work) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len(hits) == 50 == inj.counts()["dispatch"]


# ---------------------------------------------------------------------------
# monitor, controller, heartbeat
# ---------------------------------------------------------------------------

def test_step_monitor_matches_reference():
    """One sequence of step times (steady, stragglers, deadline misses, a
    late host) gives the same events in both packages."""
    rng = np.random.default_rng(3)
    durations = list(0.1 + 0.01 * rng.random(40))
    durations[12] = durations[13] = durations[14] = 0.5
    durations[20] = 5.0
    durations[30] = 0.3
    seq = [(s, 0 if s % 7 else 3, d) for s, d in enumerate(durations)]
    evs = []
    for mod in (jfault, tfault):
        mon = mod.StepMonitor(n_hosts=1, patience=2)
        out = [mon.record(*a) for a in seq]
        evs.append([None if e is None else (e.step, e.host, e.duration,
                                            e.threshold, e.action)
                    for e in out])
        assert mon.n_hosts == 4
    assert evs[0] == evs[1]
    assert any(e and e[4] == "restart" for e in evs[1])
    assert any(e and e[4] == "rebalance" for e in evs[1])


@pytest.mark.parametrize("data,model,pods", [(4, 2, 1), (4, 1, 2), (8, 4, 1),
                                             (2, 1, 2)])
def test_elastic_controller_matches_reference(data, model, pods):
    a = jfault.ElasticController(data=data, model=model, pods=pods)
    b = ElasticController(data=data, model=model, pods=pods)
    for failed in range(pods * data + 1):
        outs = []
        for c in (a, b):
            try:
                outs.append(c.shrink(failed))
            except RuntimeError as e:
                outs.append(str(e))
        assert outs[0] == outs[1]
    for dead in ([0], [6, 1, 3], [0, 1, 2]):
        n = max(dead) + 2
        assert a.shard_remap(n, dead) == b.shard_remap(n, dead)


def test_step_monitor_escalation_and_recovery():
    mon = StepMonitor(n_hosts=1, patience=2)
    for s in range(10):
        assert mon.record(s, 0, 0.1) is None
    assert mon.record(10, 0, 0.5).action == "slack"
    assert mon.record(11, 0, 0.5).action == "rebalance"
    assert mon.record(12, 0, 1.5).action == "restart"
    assert mon.record(0, 5, 0.1) is None and mon.strikes[5] == 0


def test_heartbeat(tmp_path):
    path = str(tmp_path)
    hb = Heartbeat(path, host=0, interval=0.0)
    hb.beat(step=7)
    t_beat = time.time()
    assert Heartbeat.dead_hosts(path, timeout=60.0) == []
    assert Heartbeat.dead_hosts(path, timeout=0.5, now=t_beat + 10) == [0]
    rec = json.load(open(os.path.join(path, "host_0.json")))
    assert rec["step"] == 7
    assert not [f for f in os.listdir(path) if f.endswith(".tmp")]
    limited = Heartbeat(path, host=1, interval=1000.0)
    limited.beat(step=1)
    limited.beat(step=2)
    assert json.load(open(os.path.join(path, "host_1.json")))["step"] == 1
    with open(os.path.join(path, "host_2.json"), "w") as f:
        f.write('{"host": 2, "ti')
    with open(os.path.join(path, "host_3.json.tmp"), "w") as f:
        f.write("{")
    with open(os.path.join(path, "host_4.json"), "w") as f:
        json.dump({"host": 4, "step": 0, "time": time.time() - 1e6}, f)
    assert Heartbeat.dead_hosts(path, timeout=60.0) == [4]


# ---------------------------------------------------------------------------
# the device ring
# ---------------------------------------------------------------------------

RING_OPS = [("next",), ("next",), ("fail", 1), ("fail", 1), ("next",),
            ("next",), ("fail", 1), ("next",), ("tick", 0.5), ("next",),
            ("tick", 0.6), ("next",), ("fail", 1), ("next",), ("tick", 1.2),
            ("next",), ("release", 1), ("next",), ("success", 1), ("next",),
            ("next",), ("quarantine", 0), ("next",), ("next",),
            ("fail", 1), ("fail", 1), ("fail", 1), ("next",), ("tick", 2.0),
            ("next",), ("next",), ("success", 0), ("success", 1),
            ("next",), ("next",)]


def _ring_run(mod, n_slots):
    clock = [0.0]
    ring = mod.DeviceRing([object()] * n_slots, quarantine_after=2,
                          probe_interval_s=1.0, clock=lambda: clock[0])
    out = []
    for op in RING_OPS:
        if op[0] == "next":
            out.append(("next", ring.next_index()))
        elif op[0] == "tick":
            clock[0] += op[1]
        elif op[0] == "fail":
            ring.record_failure(op[1] % n_slots)
        elif op[0] == "success":
            ring.record_success(op[1] % n_slots)
        elif op[0] == "release":
            ring.release(op[1] % n_slots)
        else:
            ring.quarantine(op[1] % n_slots)
        out.append(ring.health())
    out.append(ring.quarantined)
    return out


@pytest.mark.parametrize("n_slots", [1, 2, 3])
def test_device_ring_matches_reference(n_slots):
    """One sequence of routing, failures, successes, releases, forced
    quarantines and clock ticks: every handout and health snapshot equal
    to the reference ring's, quarantines, probes and re-admissions
    included."""
    a, b = _ring_run(jspecs, n_slots), _ring_run(tspecs, n_slots)
    assert a == b
    if n_slots > 1:
        last = b[-2]
        assert last["quarantines"] >= 2 and last["probes"] >= 1
        assert last["readmissions"] >= 1


def test_ring_probe_release_never_sticks():
    t = [0.0]
    ring = DeviceRing([object(), object()], quarantine_after=1,
                      probe_interval_s=1.0, clock=lambda: t[0])
    ring.record_failure(1)
    assert ring.health()["states"][1] == "quarantined"
    t[0] = 1.5
    assert ring.next_index() == 1 and ring.health()["states"][1] == "probing"
    ring.release(1)
    assert ring.health()["states"][1] == "quarantined"
    assert ring.next_index() == 1
    ring.record_success(1)
    h = ring.health()
    assert h["states"][1] == "up" and h["readmissions"] == 1
    assert h["probes"] == 2


def test_device_ring_round_robin_and_batch_devices():
    cpu = batch_devices("cpu")
    assert [d.type for d in cpu] == ["cpu"]
    ring = DeviceRing(cpu * 3)
    assert [ring.next_index() for _ in range(6)] == [0, 1, 2, 0, 1, 2]
    with pytest.raises(ValueError):
        DeviceRing([])


# ---------------------------------------------------------------------------
# the trainer's hooks
# ---------------------------------------------------------------------------

def _tcfg(**kw):
    return CircuitTrainConfig(hidden=HIDDEN, n_layers=1, k_cell=K, k_net=K,
                              epochs=1, **kw)


def test_trainer_straggler_feeds_step_monitor():
    chaos = FaultInjector([FaultRule("straggler", at=(0,), delay_s=0.01)])
    mon = StepMonitor(n_hosts=1)
    tr = CircuitTrainer(_tcfg(), 16, 16, chaos=chaos, monitor=mon,
                        device="cpu")
    tr.train_epoch([_graph(40, 20, 0), _graph(40, 20, 1)])
    assert chaos.counts() == {"straggler": 1}
    assert len(mon.history[0]) == 2 and tr._global_step == 2


def test_trainer_batched_straggler_and_skip():
    """A batched epoch stalls once a batch; a poisoned batch is skipped
    and counted in the registry."""
    import dataclasses
    chaos = FaultInjector([FaultRule("straggler", rate=1.0, delay_s=0.0)])
    tr = CircuitTrainer(_tcfg(batch_size=2), 16, 16, chaos=chaos,
                        device="cpu")
    g1 = _graph(40, 20, 0)
    bad = _graph(40, 20, 2)
    bad = dataclasses.replace(bad, x_cell=torch.full_like(bad.x_cell,
                                                          float("nan")))
    before = [p.detach().clone() for p in tr.params]
    assert np.isnan(tr.train_epoch([g1, bad]))
    assert tr.nonfinite_grad_steps == 1
    assert tr.metrics.value("train.nonfinite_grad_steps") == 1
    assert chaos.counts() == {"straggler": 1}
    assert all(torch.equal(a, b.detach()) for a, b in zip(before,
                                                          tr.params))
