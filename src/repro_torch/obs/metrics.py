"""Metrics registry: counters, gauges and bounded-reservoir histograms.

One typed, thread-safe home for the pipeline's telemetry:

* :class:`Counter` -- monotonically increasing float (``inc``);
* :class:`Gauge` -- last-write-wins float (``set``, ``add``);
* :class:`Histogram` -- the most recent ``reservoir`` observations plus
  exact ``count`` / ``sum`` / ``min`` / ``max``; its percentiles are
  :func:`repro_torch.train.metrics.percentile` (nearest rank), the one
  percentile definition of the port.

Instruments are keyed by ``(name, labels)``: ``registry.counter("x",
device="0")`` and ``registry.counter("x", device="1")`` are two series of
one metric.  Label only with small enums (ring slot, edge type, direction),
never with request ids.

Names are dotted lowercase paths, ``<subsystem>.<what>``:
``serve.requests``, ``serve.latency_ms``, ``train.step_ms``,
``ops.dispatch``, ``layout.evictions``, ``arena.fill_ratio``.  The
Prometheus writer maps dots to underscores (``serve_latency_ms``).

Exports: ``snapshot()`` (one JSON-able dict: counters and gauges as
numbers, histograms as ``{count, sum, min, max, mean, p50, p95, p99}``) and
``to_prometheus()`` (text exposition: ``# TYPE`` lines, ``name{label="v"}
value``, histograms as quantile series plus ``_count`` / ``_sum``).

``DEFAULT_REGISTRY`` takes the series of emitters that have no engine or
trainer at hand (the ops layer's dispatch counters, the collator's arena
gauges); engines and trainers own a registry each.
"""

from __future__ import annotations

import json
import re
import threading
from collections import deque
from typing import Deque, Dict, List, Tuple

from repro_torch.train.metrics import percentile

# metric names are mapped to this alphabet for the Prometheus writer
_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")

DEFAULT_RESERVOIR = 4096


class Counter:
    """Monotonic counter (float increments allowed: wall-clock totals)."""

    __slots__ = ("_lock", "_v")

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        return self._v


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("_lock", "_v")

    def __init__(self):
        self._lock = threading.Lock()
        self._v = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def add(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> float:
        return self._v


class Histogram:
    """The most recent ``reservoir`` observations (a sliding window: what
    latency objectives want of a long-lived loop) plus exact lifetime
    ``count`` / ``sum`` / ``min`` / ``max``."""

    __slots__ = ("_lock", "_window", "count", "sum", "min", "max")

    def __init__(self, reservoir: int = DEFAULT_RESERVOIR):
        self._lock = threading.Lock()
        self._window: Deque[float] = deque(maxlen=reservoir)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._window.append(v)
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile over the window."""
        with self._lock:
            window = sorted(self._window)
        return percentile(window, p)

    def percentiles(self, ps=(0.50, 0.95, 0.99)) -> Tuple[float, ...]:
        with self._lock:
            window = sorted(self._window)
        return tuple(percentile(window, p) for p in ps)

    def window(self) -> List[float]:
        """The window in observation order (oldest first)."""
        with self._lock:
            return list(self._window)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def summary(self) -> Dict[str, float]:
        p50, p95, p99 = self.percentiles()
        return dict(count=self.count, sum=self.sum,
                    min=self.min if self.count else 0.0,
                    max=self.max if self.count else 0.0,
                    mean=self.mean, p50=p50, p95=p95, p99=p99)


def _labels_key(labels: Dict[str, object]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Thread-safe get-or-create home of instruments, keyed by ``(name,
    sorted labels)``.  A getter on an existing series is one dict lookup,
    so emitters may call ``registry.inc("serve.retries")`` on the hot path
    (holding the instrument is cheaper still)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, tuple], object] = {}
        self._kinds: Dict[str, str] = {}      # metric name -> kind

    def _get(self, cls, kind: str, name: str, labels: dict, **kw):
        key = (name, _labels_key(labels))
        m = self._metrics.get(key)
        if m is not None:
            prev = self._kinds.get(name)
            if prev != kind:
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{prev}, requested {kind}")
            return m
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                prev = self._kinds.setdefault(name, kind)
                if prev != kind:
                    raise ValueError(f"metric {name!r} already registered "
                                     f"as {prev}, requested {kind}")
                m = self._metrics[key] = cls(**kw)
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, "counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, "gauge", name, labels)

    def histogram(self, name: str, reservoir: int = DEFAULT_RESERVOIR,
                  **labels) -> Histogram:
        return self._get(Histogram, "histogram", name, labels,
                         reservoir=reservoir)

    def inc(self, name: str, n: float = 1.0, **labels) -> None:
        self.counter(name, **labels).inc(n)

    def set(self, name: str, v: float, **labels) -> None:
        self.gauge(name, **labels).set(v)

    def observe(self, name: str, v: float, **labels) -> None:
        self.histogram(name, **labels).observe(v)

    def value(self, name: str, default: float = 0.0, **labels) -> float:
        """Current value of a counter or gauge series; ``default`` for a
        series never touched (reading creates none)."""
        m = self._metrics.get((name, _labels_key(labels)))
        return default if m is None else m.value

    def series(self, name: str) -> Dict[tuple, object]:
        """Every (labels -> instrument) of one metric name."""
        return {k[1]: m for k, m in self._metrics.items() if k[0] == name}

    def snapshot(self) -> Dict[str, object]:
        """JSON-able view: ``{name{label="v"}: number-or-summary}``."""
        with self._lock:
            items = list(self._metrics.items())
        out: Dict[str, object] = {}
        for (name, labels), m in sorted(items, key=lambda kv: kv[0]):
            key = name if not labels else (
                name + "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}")
            out[key] = m.summary() if isinstance(m, Histogram) else m.value
        return out

    def snapshot_json(self, **json_kw) -> str:
        return json.dumps(self.snapshot(), **json_kw)

    def to_prometheus(self) -> str:
        """Prometheus text exposition (a subset of format 0.0.4)."""
        with self._lock:
            items = sorted(self._metrics.items(), key=lambda kv: kv[0])
            kinds = dict(self._kinds)
        lines = []
        seen_type = set()
        for (name, labels), m in items:
            pname = _NAME_RE.sub("_", name.replace(".", "_"))
            if pname not in seen_type:
                seen_type.add(pname)
                kind = kinds.get(name, "gauge")
                ptype = {"counter": "counter",
                         "histogram": "summary"}.get(kind, "gauge")
                lines.append(f"# TYPE {pname} {ptype}")
            lab = "" if not labels else (
                "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}")
            if isinstance(m, Histogram):
                s = m.summary()
                base_lab = [f'{k}="{v}"' for k, v in labels]
                for q, phi in (("p50", "0.5"), ("p95", "0.95"),
                               ("p99", "0.99")):
                    ql = "{" + ",".join(
                        base_lab + [f'quantile="{phi}"']) + "}"
                    lines.append(f"{pname}{ql} {s[q]:.17g}")
                lines.append(f"{pname}_count{lab} {s['count']}")
                lines.append(f"{pname}_sum{lab} {s['sum']:.17g}")
            else:
                lines.append(f"{pname}{lab} {m.value:.17g}")
        return "\n".join(lines) + ("\n" if lines else "")

    def __len__(self) -> int:
        return len(self._metrics)


DEFAULT_REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return DEFAULT_REGISTRY
