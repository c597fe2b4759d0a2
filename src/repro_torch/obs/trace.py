"""Request tracing with Chrome trace-event export.

One :class:`Recorder` interface, two implementations:

* :data:`NULL_RECORDER`, the default: every method is a no-op and
  ``enabled`` is ``False``.  Emitters guard with ``if rec.enabled:``, so
  the happy path allocates nothing;
* :class:`TraceRecorder`: a bounded in-memory event buffer exported as
  Chrome trace-event JSON (``{"traceEvents": [...]}``), which Perfetto
  (https://ui.perfetto.dev) and ``chrome://tracing`` load.

Tracks are named lanes (``tid`` rows under one ``pid``).  The serve engine
uses:

* ``device/<i>``: one track a ring slot.  A batch attempt on a slot is an
  **X (complete) event** with its ``dur``: healing attempts can overlap the
  pipeline's next batch on one slot, which B/E pairs cannot express;
* ``worker/<i>``: one track a host thread that prepares batches (the
  packing pool, healer threads).  Collate and device-copy spans are **B/E
  pairs**; a track is one thread, so its pairs nest strictly;
* ``intake``: submit, admission, deadline-flush and batch-formed instants;
* ``healing``: retry, bisect, fail, watchdog and non-finite-output
  instants;
* ``chaos``: one instant per injected fault (point, occurrence, slot);
* ``layout``: bucket create / evict instants (``LayoutTable``) and the
  engine's captures (on the slot's ``device/<i>`` track).

Timestamps are ``time.perf_counter()`` microseconds since the recorder was
made, so exported ``ts`` never goes backwards.  Past ``max_events`` (2^16
by default) events are counted in ``dropped`` instead of kept.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Dict, List

DEFAULT_MAX_EVENTS = 65536

_PID = 1  # one process; tracks are tids


class _NullSpan:
    """The one shared no-op context manager."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class Recorder:
    """No-op base recorder; :class:`TraceRecorder` subclasses it.  Guard
    emission sites with ``if rec.enabled:`` so that tracing off costs that
    branch alone."""

    enabled: bool = False

    def begin(self, track: str, name: str, **args) -> None: ...

    def end(self, track: str, name: str, **args) -> None: ...

    def instant(self, track: str, name: str, **args) -> None: ...

    def complete(self, track: str, name: str, ts_us: float,
                 dur_us: float, **args) -> None: ...

    def span(self, track: str, name: str, **args):
        return NULL_SPAN

    def now(self) -> float:
        return 0.0

    def export(self) -> Dict[str, object]:
        return {"traceEvents": []}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.export(), f)


NULL_RECORDER = Recorder()


class _Span:
    __slots__ = ("_rec", "_track", "_name", "_args")

    def __init__(self, rec: "TraceRecorder", track: str, name: str, args):
        self._rec, self._track, self._name, self._args = rec, track, name, args

    def __enter__(self):
        self._rec.begin(self._track, self._name, **self._args)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self._rec.end(self._track, self._name)
        else:
            self._rec.end(self._track, self._name, error=exc_type.__name__)
        return False


class TraceRecorder(Recorder):
    """Bounded in-memory trace-event collector.  Thread-safe: an emit is
    one short locked append, and the recorder calls nothing back, so it may
    be called under an engine's or an injector's lock."""

    enabled = True

    def __init__(self, max_events: int = DEFAULT_MAX_EVENTS):
        self._lock = threading.Lock()
        self._events: List[dict] = []
        self._max_events = int(max_events)
        self._tids: Dict[str, int] = {}
        self._t0 = time.perf_counter()
        self.dropped = 0

    def now(self) -> float:
        """Microseconds since the recorder was made (monotonic)."""
        return (time.perf_counter() - self._t0) * 1e6

    def _tid(self, track: str) -> int:
        # caller holds self._lock
        tid = self._tids.get(track)
        if tid is None:
            tid = self._tids[track] = len(self._tids) + 1
        return tid

    def _emit(self, track: str, ev: dict) -> None:
        ts = self.now()
        with self._lock:
            if len(self._events) >= self._max_events:
                self.dropped += 1
                return
            ev["pid"] = _PID
            ev["tid"] = self._tid(track)
            ev.setdefault("ts", ts)
            self._events.append(ev)

    def begin(self, track: str, name: str, **args) -> None:
        ev = {"ph": "B", "name": name, "cat": track}
        if args:
            ev["args"] = args
        self._emit(track, ev)

    def end(self, track: str, name: str, **args) -> None:
        ev = {"ph": "E", "name": name, "cat": track}
        if args:
            ev["args"] = args
        self._emit(track, ev)

    def instant(self, track: str, name: str, **args) -> None:
        ev = {"ph": "i", "s": "t", "name": name, "cat": track}
        if args:
            ev["args"] = args
        self._emit(track, ev)

    def complete(self, track: str, name: str, ts_us: float,
                 dur_us: float, **args) -> None:
        """X event with the start and duration the caller measured."""
        ev = {"ph": "X", "name": name, "cat": track,
              "ts": float(ts_us), "dur": max(0.0, float(dur_us))}
        if args:
            ev["args"] = args
        self._emit(track, ev)

    def span(self, track: str, name: str, **args):
        """``with rec.span("worker/0", "collate", batch=2): ...``: a B at
        entry, an E at exit (annotated with the error on an exception)."""
        return _Span(self, track, name, args)

    def export(self) -> Dict[str, object]:
        """Chrome trace-event JSON: the process and thread names first,
        then every event sorted by ``ts``."""
        with self._lock:
            events = [dict(e) for e in self._events]
            tids = dict(self._tids)
            dropped = self.dropped
        meta: List[dict] = [{
            "ph": "M", "name": "process_name", "pid": _PID, "tid": 0,
            "args": {"name": "repro-torch-circuit-serve"},
        }]
        for track, tid in sorted(tids.items(), key=lambda kv: kv[1]):
            meta.append({"ph": "M", "name": "thread_name",
                         "pid": _PID, "tid": tid, "args": {"name": track}})
        events.sort(key=lambda e: (e["ts"], 0 if e["ph"] == "B" else 1))
        out: Dict[str, object] = {"traceEvents": meta + events,
                                  "displayTimeUnit": "ms"}
        if dropped:
            out["otherData"] = {"dropped_events": dropped}
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)
