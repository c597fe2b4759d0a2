"""Fault tolerance policies: step-time monitoring, straggler escalation,
elastic mesh shrinking and a file-based heartbeat.

* :class:`StepMonitor`: robust step-time statistics (median + MAD); flags
  stragglers (> median + k·MAD) and hard failures (past median x
  ``deadline_factor``).  Escalation: ``slack`` (tolerate jitter), then
  ``rebalance`` (move the straggler's data shards, after ``patience``
  strikes), and ``restart`` (a missed deadline: declare the node dead).
* :class:`ElasticController`: the largest valid (pods, data, model) mesh
  for the surviving hosts, and the data-shard remap.
* :class:`Heartbeat`: host-local liveness records (file transport).

The policies are transport-agnostic and pure Python.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.train.metrics import median


@dataclasses.dataclass
class StragglerEvent:
    step: int
    host: int
    duration: float
    threshold: float
    action: str            # "slack" | "rebalance" | "restart"


class StepMonitor:
    def __init__(self, n_hosts: int = 1, *, mad_k: float = 6.0,
                 deadline_factor: float = 10.0, window: int = 50,
                 patience: int = 3):
        self.n_hosts = n_hosts
        self.mad_k = mad_k
        self.deadline_factor = deadline_factor
        self.window = window
        self.patience = patience
        self.history: Dict[int, List[float]] = {h: [] for h in range(n_hosts)}
        self.strikes: Dict[int, int] = {h: 0 for h in range(n_hosts)}
        self.events: List[StragglerEvent] = []

    def record(self, step: int, host: int,
               duration: float) -> Optional[StragglerEvent]:
        if host not in self.history:
            # a host that joins after construction registers lazily
            self.history[host] = []
            self.strikes[host] = 0
            self.n_hosts = max(self.n_hosts, host + 1)
        hist = self.history[host]
        hist.append(duration)
        if len(hist) > self.window:
            hist.pop(0)
        if len(hist) < 5:
            return None
        med = median(hist)
        mad = median([abs(x - med) for x in hist]) + 1e-9
        threshold = med + self.mad_k * mad
        deadline = med * self.deadline_factor
        if duration > deadline:
            ev = StragglerEvent(step, host, duration, deadline, "restart")
        elif duration > threshold:
            self.strikes[host] += 1
            action = ("rebalance" if self.strikes[host] >= self.patience
                      else "slack")
            ev = StragglerEvent(step, host, duration, threshold, action)
        else:
            self.strikes[host] = max(0, self.strikes[host] - 1)
            return None
        self.events.append(ev)
        return ev


class ElasticController:
    """Mesh shrink and data-shard remap on node loss.  The model axis is
    kept (resharding parameters over it changes their layout); the data
    axis shrinks to the largest power of two the survivors fill."""

    def __init__(self, data: int, model: int, pods: int = 1):
        self.data, self.model, self.pods = data, model, pods

    def shrink(self, failed_hosts: int) -> Tuple[int, int, int]:
        """The new (pods, data, model) after losing ``failed_hosts``:
        incomplete pods go first, then the data axis shrinks."""
        surviving = self.pods * self.data - failed_hosts
        if surviving <= 0:
            raise RuntimeError("no survivors")
        pods = self.pods
        while pods > 1 and surviving < pods * self.data:
            pods -= 1
        per_pod = surviving // pods
        data = _largest_pow2_leq(per_pod) if per_pod >= 1 else 1
        return pods, data, self.model

    def shard_remap(self, n_shards: int, dead: List[int]) -> Dict[int, int]:
        """The dead hosts' data shards, round-robin onto the survivors (a
        pure function of its arguments)."""
        alive = [h for h in range(n_shards) if h not in dead]
        return {d: alive[i % len(alive)] for i, d in enumerate(sorted(dead))}


def _largest_pow2_leq(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


class Heartbeat:
    """Host-local heartbeat records, one JSON file a host."""

    def __init__(self, path: str, host: int, interval: float = 5.0):
        self.path, self.host, self.interval = path, host, interval
        self._last = 0.0

    def beat(self, step: int):
        now = time.time()
        if now - self._last < self.interval:
            return
        self._last = now
        os.makedirs(self.path, exist_ok=True)
        # write, then rename (atomic on POSIX), so a reader never sees a
        # half-written record; the temporary name is the host's own
        final = f"{self.path}/host_{self.host}.json"
        tmp = f"{final}.tmp"
        with open(tmp, "w") as f:
            json.dump({"host": self.host, "step": step, "time": now}, f)
        os.replace(tmp, final)

    @staticmethod
    def dead_hosts(path: str, timeout: float, now: Optional[float] = None
                   ) -> List[int]:
        now = now or time.time()
        dead = []
        if not os.path.isdir(path):
            return dead
        for fn in os.listdir(path):
            if not (fn.startswith("host_") and fn.endswith(".json")):
                continue                      # .tmp files and strays
            try:
                with open(os.path.join(path, fn)) as f:
                    rec = json.load(f)
                host, t = rec["host"], rec["time"]
            except (OSError, ValueError, KeyError, TypeError):
                continue    # an unreadable record is no evidence either way
            if now - t > timeout:
                dead.append(host)
        return sorted(dead)
