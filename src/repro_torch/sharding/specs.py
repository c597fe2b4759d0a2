"""Device placement: :func:`batch_devices`, :class:`DeviceRing` and
:func:`shard_devices`.

Independent collated batches (serving, data-parallel training) have no
dataflow between them, so routing them round-robin over the ring's slots
is pure throughput.  A slot is a ``torch.device``; two slots may name one
card (each then holds its own model replica: the serve engine's captures,
the trainer's data-parallel replicas).  :func:`shard_devices` places the
shards of a :class:`~repro_torch.sharding.plan_shard.ShardedRelationPlan`,
the counterpart of the reference's ``shard_mesh``: the port drives every
shard from one process, so a "mesh" is a tuple of devices.  The
reference's logical-axis rules (``shard_map`` / ``NamedSharding``
plumbing) have no counterpart.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device


def batch_devices(device="cuda") -> Tuple[torch.device, ...]:
    """Devices that can each run an independent batch: every visible card
    (raises when there is none), or the CPU when ``device`` asks for it."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return (dev,)
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


def shard_devices(n_shards: int, device="cuda") -> Tuple[torch.device, ...]:
    """Devices of ``n_shards`` shards: on a card, the visible cards in turn
    starting from ``device``'s (so shard 0 sits on it, and ``n`` shards on
    a one-card host all sit there); on the CPU, ``n`` times the CPU.
    Raises, as :func:`~repro_torch.resolve_device` does, when a card is
    asked for and none is visible, and when ``device`` names a card that
    is not visible."""
    dev = resolve_device(device)
    if n_shards < 1:
        raise ValueError(f"n_shards must be at least 1, got {n_shards}")
    if dev.type == "cpu":
        return (dev,) * n_shards
    count = torch.cuda.device_count()
    if dev.index >= count:
        raise RuntimeError(f"device {str(dev)!r} requested but only {count} "
                           f"CUDA device(s) are visible")
    return tuple(torch.device("cuda", (dev.index + d) % count)
                 for d in range(n_shards))


class DeviceRing:
    """Round-robin router with per-slot health.

    ``next_index`` is a thread-safe round-robin counter over the healthy
    slots.  ``record_failure(i)`` / ``record_success(i)`` track
    consecutive device-attributable failures a slot: ``quarantine_after``
    of them move it to ``"quarantined"``, and routing goes around it; after
    ``probe_interval_s`` the slot is handed out once as a probe
    (``"probing"``): a success re-admits it, a failure quarantines it again
    and restarts its probe clock.  With every slot down the ring serves
    round-robin over all of them (refusing service is worse than trying a
    sick device).  ``clock`` is injectable for tests."""

    UP, QUARANTINED, PROBING = "up", "quarantined", "probing"

    def __init__(self, devices: Optional[Sequence] = None, *,
                 quarantine_after: int = 3,
                 probe_interval_s: float = 1.0,
                 clock=time.monotonic):
        self.devices = tuple(devices) if devices is not None \
            else batch_devices()
        if not self.devices:
            raise ValueError("DeviceRing needs at least one device")
        self.quarantine_after = quarantine_after
        self.probe_interval_s = probe_interval_s
        self._clock = clock
        self._count = itertools.count()
        n = len(self.devices)
        self._hlock = threading.Lock()
        self._state = [self.UP] * n
        self._fails = [0] * n               # consecutive failures a slot
        self._since = [0.0] * n             # when each slot was quarantined
        self.quarantines = 0
        self.probes = 0
        self.readmissions = 0

    def __len__(self) -> int:
        return len(self.devices)

    def next_index(self) -> int:
        with self._hlock:
            now = self._clock()
            for i, st in enumerate(self._state):
                if st == self.QUARANTINED and \
                        now - self._since[i] >= self.probe_interval_s:
                    # one probe; PROBING keeps the slot out of the healthy
                    # rotation until the probe resolves
                    self._state[i] = self.PROBING
                    self.probes += 1
                    return i
            healthy = [i for i, st in enumerate(self._state)
                       if st == self.UP]
            if not healthy:
                return next(self._count) % len(self.devices)
            return healthy[next(self._count) % len(healthy)]

    def record_failure(self, index: int) -> None:
        """A device-attributable failure on slot ``index`` (a copy, a
        dispatch, a watchdog timeout; not a data fault)."""
        with self._hlock:
            i = index % len(self.devices)
            self._fails[i] += 1
            if self._state[i] == self.PROBING:
                self._state[i] = self.QUARANTINED     # the probe failed
                self._since[i] = self._clock()
            elif self._state[i] == self.UP and \
                    self._fails[i] >= self.quarantine_after:
                self._state[i] = self.QUARANTINED
                self._since[i] = self._clock()
                self.quarantines += 1

    def release(self, index: int) -> None:
        """Slot ``index`` was handed out but never touched (host-side
        collation failed first): a probe handout goes back to
        ``"quarantined"`` without restarting its probe clock, so the next
        ``next_index`` probes it again; no failure is recorded."""
        with self._hlock:
            i = index % len(self.devices)
            if self._state[i] == self.PROBING:
                self._state[i] = self.QUARANTINED

    def record_success(self, index: int) -> None:
        with self._hlock:
            i = index % len(self.devices)
            self._fails[i] = 0
            if self._state[i] != self.UP:
                self._state[i] = self.UP              # the probe succeeded
                self.readmissions += 1

    def quarantine(self, index: int) -> None:
        """Force a slot down (draining a device, degraded-mode runs)."""
        with self._hlock:
            i = index % len(self.devices)
            if self._state[i] == self.UP:
                self.quarantines += 1
            self._state[i] = self.QUARANTINED
            self._since[i] = self._clock()

    @property
    def quarantined(self) -> Tuple[int, ...]:
        with self._hlock:
            return tuple(i for i, st in enumerate(self._state)
                         if st != self.UP)

    def health(self) -> dict:
        """Per-slot state and the lifetime quarantine / probe /
        readmission counts."""
        with self._hlock:
            return dict(states=list(self._state),
                        consecutive_failures=list(self._fails),
                        quarantines=self.quarantines,
                        probes=self.probes,
                        readmissions=self.readmissions)
