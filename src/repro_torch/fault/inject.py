"""Deterministic chaos injection for the serve and train paths.

A :class:`FaultInjector` is a seed-scheduled set of :class:`FaultRule` s
bound to named **injection points**, the places of the pipeline where
production faults land:

    ``collate``      host-side collation raises (malformed batch)
    ``device_put``   the copy of a batch to its ring slot raises
    ``dispatch``     the batch's dispatch raises
    ``nan_output``   the batch output comes back NaN-poisoned
    ``straggler``    the host packing stage stalls for ``delay_s``
    ``device_loss``  a ring slot goes down for ``down_for`` touches

The serve engine (``serve/circuit_engine.py``), the trainer
(``train/circuit_trainer.py``) and the tests consume the same injector.

Scheduling is deterministic: a rule fires on explicit occurrence indices
(``at=(0, 3)``: the 0th and 3rd time its point is touched) and/or on
Bernoulli draws from a per-rule ``random.Random((seed << 20) + i)``, the
reference package's streams, so one seed gives one schedule in both
packages for one sequence of touches.  Every firing is recorded in
``injector.events``.

``device_loss`` is stateful: when its rule fires on a touch of the matching
slot, that slot enters a *down window* and its next ``down_for - 1``
touches (``device_put`` / ``dispatch``) raise :class:`InjectedFault` with
``point="device_loss"`` too: long enough to trip the engine's
consecutive-failure quarantine, short enough that the periodic probe finds
the slot healthy again.

The pipeline guards every hook with ``if chaos is not None``: an engine
without an injector runs no injection code.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

POINTS = ("collate", "device_put", "dispatch", "nan_output", "straggler",
          "device_loss")


class InjectedFault(RuntimeError):
    """Raised by an injection point; carries the point and ring slot."""

    def __init__(self, point: str, occurrence: int,
                 device: Optional[int] = None):
        self.point = point
        self.occurrence = occurrence
        self.device = device
        at = f" on ring slot {device}" if device is not None else ""
        super().__init__(f"injected {point} fault{at} "
                         f"(occurrence {occurrence})")


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One scheduled fault.  ``at`` fires on those occurrence indices of
    the rule's point (0-based, counted per rule, restricted to ``device``
    when set); ``rate`` also fires on seeded Bernoulli draws; ``n`` caps
    the firings.  ``delay_s`` is the straggler stall, ``down_for`` the
    device-loss window in touches."""
    point: str
    at: Tuple[int, ...] = ()
    rate: float = 0.0
    n: Optional[int] = None
    device: Optional[int] = None
    delay_s: float = 0.05
    down_for: int = 3

    def __post_init__(self):
        if self.point not in POINTS:
            raise ValueError(f"unknown injection point {self.point!r}; "
                             f"expected one of {POINTS}")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    point: str
    occurrence: int
    device: Optional[int]
    t: float


class FaultInjector:
    """Seed-scheduled fault source shared by every injection point;
    thread-safe (the engine touches points from the serve loop, the packing
    pool and healer threads at once)."""

    def __init__(self, rules: Sequence[FaultRule], seed: int = 0):
        self.rules = tuple(rules)
        self.seed = seed
        self._rngs = [random.Random(None if seed is None
                                    else (seed << 20) + i)
                      for i in range(len(self.rules))]
        self._touches = [0] * len(self.rules)   # occurrences per rule
        self._fired = [0] * len(self.rules)
        self._down: Dict[int, int] = {}         # slot -> failures left
        self.events: List[FaultEvent] = []
        self._lock = threading.Lock()
        # optional obs.trace.Recorder (the serve engine wires in its own):
        # every injected fault is then an instant on the "chaos" track
        self.recorder = None

    def _eval(self, point: str, device: Optional[int]) -> Optional[int]:
        """One touch of ``point``: the firing occurrence index or None
        (caller holds the lock)."""
        hit = None
        for i, rule in enumerate(self.rules):
            if rule.point != point:
                continue
            if rule.device is not None and device is not None \
                    and rule.device != device:
                continue
            occ = self._touches[i]
            self._touches[i] += 1
            if rule.n is not None and self._fired[i] >= rule.n:
                continue
            fire = occ in rule.at
            if not fire and rule.rate > 0.0:
                fire = self._rngs[i].random() < rule.rate
            if fire:
                self._fired[i] += 1
                if hit is None:
                    hit = occ
                if point == "device_loss" and device is not None:
                    # the triggering touch is the window's first failure
                    self._down[device] = max(self._down.get(device, 0),
                                             rule.down_for - 1)
        return hit

    def _record(self, point: str, occ: int, device: Optional[int]):
        self.events.append(FaultEvent(point, occ, device, time.time()))
        rec = self.recorder
        if rec is not None and rec.enabled:
            if device is None:
                rec.instant("chaos", f"inject:{point}", occurrence=occ)
            else:
                rec.instant("chaos", f"inject:{point}", occurrence=occ,
                            device=device)

    def raise_if(self, point: str, device: Optional[int] = None) -> None:
        """Touch a raising point (``collate`` / ``device_put`` /
        ``dispatch``); a touch of a slot also consults ``device_loss``."""
        with self._lock:
            if device is not None:
                if self._down.get(device, 0) > 0:
                    self._down[device] -= 1
                    occ = sum(self._fired)
                    self._record("device_loss", occ, device)
                    raise InjectedFault("device_loss", occ, device)
                occ = self._eval("device_loss", device)
                if occ is not None:
                    self._record("device_loss", occ, device)
                    raise InjectedFault("device_loss", occ, device)
            occ = self._eval(point, device)
            if occ is not None:
                self._record(point, occ, device)
                raise InjectedFault(point, occ, device)

    def stall(self, point: str = "straggler") -> float:
        """Touch the straggler point; sleeps the injected delay and
        returns it (0.0 when the point stays quiet)."""
        with self._lock:
            delay = 0.0
            for i, rule in enumerate(self.rules):
                if rule.point != point:
                    continue
                occ = self._touches[i]
                self._touches[i] += 1
                if rule.n is not None and self._fired[i] >= rule.n:
                    continue
                fire = occ in rule.at or (rule.rate > 0.0 and
                                          self._rngs[i].random() < rule.rate)
                if fire:
                    self._fired[i] += 1
                    delay = max(delay, rule.delay_s)
                    self._record(point, occ, None)
        if delay > 0.0:
            time.sleep(delay)
        return delay

    def poison(self, out: np.ndarray,
               point: str = "nan_output") -> np.ndarray:
        """Touch the NaN-poisoning point; when it fires, a copy of ``out``
        filled with NaN comes back (the output guard must catch it)."""
        with self._lock:
            occ = self._eval(point, None)
            if occ is None:
                return out
            self._record(point, occ, None)
        bad = np.array(out, copy=True)
        bad[...] = np.nan
        return bad

    def counts(self) -> Dict[str, int]:
        """Firings per point (from the event log)."""
        out: Dict[str, int] = {}
        with self._lock:
            for ev in self.events:
                out[ev.point] = out.get(ev.point, 0) + 1
        return out
