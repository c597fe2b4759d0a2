"""Circuit serve engine: online, batched DR-CircuitGNN congestion inference.

Requests are whole circuit graphs.  The engine batches them by
block-diagonal collation (``graphs/collate.py``):

* **intake** -- ``submit()`` is thread-safe and legal while
  ``serve_forever()`` runs.  It rejects graphs with non-finite features at
  the door (``validate_inputs``), stamps each request with its shape bucket
  (quantised node counts + feature widths) and its head, and applies the
  **admission** policy when ``max_queue`` requests wait: ``"block"``
  (back-pressure the producer, up to its ``timeout``), ``"reject"``
  (:class:`QueueFullError`) or ``"shed_oldest"`` (the queue's head fails
  with :class:`LoadShedError`);
* **deadline batcher** -- requests group by (shape bucket, head), FIFO
  within a group.  The first group holding ``max_batch`` requests
  dispatches full; otherwise the oldest request's group dispatches once
  that request has waited ``max_wait_ms`` (``run()`` flushes at once).
  With ``pad_to_full`` a partial batch is filled up with copies of its last
  member, whose outputs are dropped, so that it keeps the full batch's
  signature;
* **per-bucket state** -- each bucket's :class:`BucketLayout` (pinned chunk
  widths and tiers, floored chunk counts) and its :class:`_BucketState` (a
  pack lock and the captured graphs) live in an LRU :class:`LayoutTable`
  bounded by ``max_live_buckets``; an evicted bucket drops both as one
  unit, once no batch of it waits for dispatch;
* **device ring** -- batches go round-robin over the slots of a
  :class:`~repro_torch.sharding.specs.DeviceRing` (``devices``: every
  visible card by default).  Each slot holds its own model replica, its
  own static head pair and its own captured graphs; two slots may name one
  card;
* **CUDA graphs** -- on a card the first dispatch of a (signature, slot)
  in a live bucket runs the batch forward eagerly (its output serves the
  batch) and captures it in a ``torch.cuda.CUDAGraph``; later batches copy
  the tensors the forward reads into the graph's static inputs and replay
  it.  ``compiles`` counts these (signature, slot) first dispatches,
  re-captures after an eviction included (on the CPU: first dispatches,
  the events the reference counts).  A capture or replay that fails
  raises; nothing falls back to the eager forward;
* **the dispatch lock** -- every dispatch holds one lock from the copy of
  its batch into the graph's static inputs through the replay (or the
  eager run) to the enqueue of the output's copy to pinned host memory, all
  on the slot's one compute stream (the device's default stream).  Two
  threads never interleave their copies into one graph's inputs, the
  capture's launch counts and the kernels' schedule memo see one dispatch
  at a time, and a hot swap (below) lands between two batches;
* **packing pool** -- pool threads collate upcoming batches on the host and
  copy the part the forward reads (no labels, no backward tables) to the
  card on a side stream; the compute stream waits on the copy's event;
* **completion** -- off the serving thread: a batch's output is read once
  the event recorded after its host copy completes (not by the completing
  thread's current stream), and the batch's tensors and captured graph
  stay referenced until then.  A non-finite member prediction raises
  :class:`NonFiniteOutputError` instead of being served;
* **self-healing ladder** -- a batch whose attempt failed is retried with
  exponential back-off on a freshly routed slot (``max_retries``), then
  bisected until only its poison member fails; device-attributable
  failures feed the ring's quarantine (``quarantine_after`` consecutive
  failures) and probe re-admission (``probe_interval_s``); ``watchdog_s``
  bounds an attempt, so a wedged batch becomes a timed-out request.  The
  ladder contains only host-side faults of a batch's preparation (a
  malformed graph's collation error), :class:`InjectedFault`,
  :class:`NonFiniteOutputError` and :class:`WatchdogTimeoutError`.  An
  error of a kernel's build or launch, of a capture, a replay or a copy to
  or from the card is not retried: it fails every request not yet finished
  and raises out of ``run()`` / ``serve_forever()``;
* **hot swap** -- ``update_params(state)`` copies new weights into every
  slot's replica in place, on the compute stream, under the dispatch lock:
  batches enqueued before it finish on the old weights, later ones read
  the new; no capture is made again.  Every request records the
  ``params_version`` that served it;
* **task heads** -- ``register_head(name, w, b)`` installs per-task output
  heads over the one backbone; ``submit(graph, head=name)`` selects one.
  A dispatch copies its batch's head into its slot's static pair, which
  the eager and captured forwards read, so heads add no capture;
* **chaos and observability** -- ``chaos=FaultInjector(...)``
  (``fault/inject.py``) touches every injection point under a seed; every
  counter and latency lives in a per-engine
  :class:`~repro_torch.obs.metrics.MetricsRegistry` (``stats()`` is a view
  of it, ``metrics_text()`` its Prometheus exposition) and
  ``recorder=TraceRecorder()`` traces each request from submit to commit,
  ladder steps and injections included (``dump_trace(path)``).  The
  default no-op recorder costs one ``if rec.enabled`` a site.

Two modes share the pipeline: ``run()`` drains a snapshot of the queue
(partial batches flush at once; failed batches go through the ladder
in-line), and ``serve_forever()`` serves submits as they arrive until
``stop()`` (which drains first) or, with ``stop_when_idle``, until the
queue and the pipeline are empty::

    eng = CircuitServeEngine(model, cfg, max_wait_ms=20.0)
    t = threading.Thread(target=eng.serve_forever)
    t.start()
    rid = eng.submit(graph)               # any thread, any time
    pred = eng.result(rid, timeout=5.0).pred
    eng.stop(); t.join()
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Deque, Dict, List, Mapping, Optional, Sequence, \
    Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.hetero_mp import HeteroMPConfig, plan_applicable
from repro_torch.core.parallel import prefetch
from repro_torch.fault.inject import FaultInjector, InjectedFault
from repro_torch.graphs.circuit import CircuitGraph
from repro_torch.graphs.collate import (ARENA_GRID_BITS, LayoutTable,
                                        collate_graphs, graph_tensors,
                                        map_graph_tensors, quantize_up)
from repro_torch.graphs.ell import _to_tensor
from repro_torch.models.backbone import BackboneSpec
from repro_torch.models.hgnn import DRCircuitGNN
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_RECORDER, NULL_SPAN, Recorder
from repro_torch.sharding.specs import DeviceRing, batch_devices


class QueueFullError(RuntimeError):
    """submit() under ``admission="reject"`` with the queue at capacity."""


class LoadShedError(RuntimeError):
    """Request shed by ``admission="shed_oldest"`` to admit a newer one;
    its ``result()`` raises with this cause."""


class WatchdogTimeoutError(RuntimeError):
    """A batch attempt outlived ``watchdog_s``; its requests fail so that
    ``result()`` returns instead of waiting on a wedged dispatch."""


class NonFiniteInputError(ValueError):
    """submit() rejected a graph whose features contain NaN/Inf."""


class NonFiniteOutputError(RuntimeError):
    """A member's prediction came out NaN/Inf."""


class _Uncontained(Exception):
    """Carries an error the healing ladder must not retry (a kernel's
    build or launch, a capture, a replay, a copy to or from the card) out
    to ``run()`` / ``serve_forever()``, which fail the pending requests and
    raise ``exc``."""

    def __init__(self, exc: BaseException):
        super().__init__(repr(exc))
        self.exc = exc


@dataclasses.dataclass
class CircuitRequest:
    rid: int
    graph: CircuitGraph
    t_submit: float
    t_done: float = 0.0
    pred: Optional[np.ndarray] = None     # (n_cell,) congestion in [0, 1]
    key: Optional[tuple] = None           # shape bucket, stamped by submit()
    # the registered head that serves the request; None: the model's own
    head: Optional[str] = None
    error: Optional[BaseException] = None  # set when the request failed
    # the params generation that served it (update_params bumps it)
    params_version: int = 0
    # committed (pred or error): an abandoned attempt that finishes late
    # finds it set and commits nothing
    final: bool = False

    @property
    def latency_ms(self) -> float:
        return (self.t_done - self.t_submit) * 1e3


def _forward_view(graph: CircuitGraph) -> CircuitGraph:
    """The part of a batch that the served forward reads: no labels and,
    on the plan path, none of the plan's backward tables.  Only this view
    is copied to the card, captured and copied into a capture's inputs."""
    plan = graph.plan
    if plan is not None:
        plan = dataclasses.replace(plan, bwd=None, bwd_src_rows=None,
                                   dense_bwd=None)
    return dataclasses.replace(graph, y_cell=None, plan=plan)


def _kernel_wrappers() -> List[Callable]:
    """The GNN forward's kernel wrappers, each counting its launches on
    its ``launches`` attribute."""
    from repro_torch.kernels import drelu_topk, drspmm
    seen: Dict[int, Callable] = {}
    for m in (drspmm, drelu_topk):
        for f in vars(m).values():
            if callable(f) and hasattr(f, "launches"):
                seen.setdefault(id(f), f)
    return list(seen.values())


@dataclasses.dataclass
class _Captured:
    """One (signature, slot)'s captured batch forward: the graph, its
    static input tensors (``graph_tensors`` of a batch's forward view), its
    static output, and the kernel launches recorded in it (wrapper ->
    count), which every replay runs."""
    graph: torch.cuda.CUDAGraph
    inputs: List[torch.Tensor]
    out: torch.Tensor
    launches: Dict[Callable, int]

    def run(self, view: CircuitGraph) -> torch.Tensor:
        """Copy the forward view ``view`` into the static inputs and
        replay, on the current stream; returns the static output, which the
        next replay overwrites (its copy to the host is enqueued first, on
        the same stream).  The replay's launches count on their
        wrappers."""
        for s, t in zip(self.inputs, graph_tensors(view)):
            s.copy_(t)
        self.graph.replay()
        for fn, n in self.launches.items():
            fn.launches += n
        return self.out


@dataclasses.dataclass
class _Slot:
    """One ring slot: its device, its model replica and the static head
    pair that its forwards read."""
    device: torch.device
    model: DRCircuitGNN
    head: Tuple[torch.Tensor, torch.Tensor]


@dataclasses.dataclass
class _BucketState:
    """Engine-side per-bucket state, dropped as one unit when its bucket
    is evicted and none of its batches waits for dispatch (new per-bucket
    fields belong here, so they cannot outlive ``max_live_buckets`` by
    more than the batches in the pipeline)."""
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)
    # (signature, slot) dispatched while the bucket is live -> its
    # captured forward (None on the CPU)
    sigs: Dict[tuple, Optional[_Captured]] = dataclasses.field(
        default_factory=dict)
    # batches prepared under this state and not yet dispatched
    pending: int = 0
    # evicted from the layout table; dropped when ``pending`` reaches 0
    evicted: bool = False


@dataclasses.dataclass
class _Prepared:
    """A batch collated on the host with its forward view on its slot's
    device (``copied``: the side stream's event for that copy)."""
    reqs: List[CircuitRequest]
    batch: object                    # CollatedBatch, tables on the host
    view: CircuitGraph               # the forward view on the slot
    copied: Optional[torch.cuda.Event]
    key: tuple
    state: _BucketState
    slot: int


@dataclasses.dataclass
class _Inflight:
    """A dispatched batch until ``_complete`` has read it.  ``host`` is the
    output's copy in (pinned) host memory, valid once ``done`` (an event on
    the compute stream) has completed; ``view`` and ``cap`` keep the
    batch's device tensors and the captured graph alive until then.
    ``kind``: ``"first"`` (the eager run before its capture), ``"replay"``
    or ``"eager"`` (its bucket was evicted while it was prepared, or the
    CPU)."""
    reqs: List[CircuitRequest]
    batch: object
    view: CircuitGraph
    host: torch.Tensor
    done: Optional[torch.cuda.Event]
    kind: str
    cap: Optional[_Captured]
    version: int
    slot: int
    t_disp: float


# One trace track a host thread that prepares batches ("worker/<k>"), so
# the B/E spans of a track nest strictly.
_track_local = threading.local()
_track_counter = itertools.count()


def _worker_track() -> str:
    name = getattr(_track_local, "name", None)
    if name is None:
        name = _track_local.name = f"worker/{next(_track_counter)}"
    return name


class CircuitServeEngine:
    """Micro-batching congestion-prediction server over one model, on the
    card unless ``device="cpu"`` is asked for."""

    # one mantissa bit: a size class with ±10% jitter collapses into one
    # bucket
    SERVE_NODE_BITS = 1

    def __init__(self, model: DRCircuitGNN, cfg: HeteroMPConfig, *,
                 spec: Optional[BackboneSpec] = None,
                 max_batch: int = 8,
                 n_pack_threads: int = 3,
                 node_bits: int = SERVE_NODE_BITS,
                 arena_bits: int = ARENA_GRID_BITS,
                 chunk: Union[None, int, Dict[str, int]] = None,
                 pad_to_full: bool = True,
                 max_wait_ms: float = 50.0,
                 max_live_buckets: Optional[int] = None,
                 max_finished: Optional[int] = None,
                 devices: Optional[Sequence] = None,
                 max_retries: int = 2,
                 retry_backoff_s: float = 0.02,
                 watchdog_s: Optional[float] = None,
                 max_queue: Optional[int] = None,
                 admission: str = "block",
                 validate_inputs: bool = True,
                 quarantine_after: int = 3,
                 probe_interval_s: float = 1.0,
                 chaos: Optional[FaultInjector] = None,
                 recorder: Optional[Recorder] = None,
                 registry: Optional[MetricsRegistry] = None,
                 device="cuda"):
        if admission not in ("block", "reject", "shed_oldest"):
            raise ValueError(f"unknown admission policy {admission!r}")
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, engine on "
                             f"{self.device}")
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.cfg = cfg
        self.spec = spec
        self.b = max_batch
        self.n_pack_threads = n_pack_threads
        self.node_bits = node_bits
        self.arena_bits = arena_bits
        self.chunk = chunk
        self.pad_to_full = pad_to_full
        self.max_wait_ms = max_wait_ms
        # bound on retained results (None keeps all: the run()-and-read
        # pattern); online clients set it or collect with result(pop=True)
        self.max_finished = max_finished
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.watchdog_s = watchdog_s
        self.max_queue = max_queue
        self.admission = admission
        self.validate_inputs = validate_inputs
        self.chaos = chaos
        devs = batch_devices(self.device) if devices is None \
            else tuple(resolve_device(d) for d in devices)
        self.ring = DeviceRing(devs, quarantine_after=quarantine_after,
                               probe_interval_s=probe_interval_s)
        model = model.eval()
        self._slots: List[_Slot] = []
        for d in self.ring.devices:
            replica = copy.deepcopy(model).to(d).eval()
            with torch.no_grad():
                head = (replica.head_w.detach().clone(),
                        replica.head_b.detach().clone())
            self._slots.append(_Slot(device=d, model=replica, head=head))
        self._params_version = 0
        # head name -> one (head_w, head_b) copy a slot
        self._heads: Dict[str, tuple] = {}
        self.queue: Deque[CircuitRequest] = deque()
        self.finished: Dict[int, CircuitRequest] = {}
        # submitted and not yet committed: what a fatal error fails
        self._outstanding: Dict[int, CircuitRequest] = {}
        self._rid = itertools.count()
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)   # submit/prep/stop
        self._done = threading.Condition(self._lock)   # result() waiters
        self._stop = False
        self._serving = False
        self._fatal: Optional[_Uncontained] = None
        # one dispatch at a time (module docstring)
        self._dispatch_lock = threading.Lock()
        # side streams for the copies of upcoming batches, one a card
        self._copy_streams = {d: torch.cuda.Stream(d)
                              for d in set(self.ring.devices)
                              if d.type == "cuda"}
        self.metrics = registry if registry is not None else MetricsRegistry()
        self._rec = recorder if recorder is not None else NULL_RECORDER
        if self.chaos is not None and self._rec.enabled:
            self.chaos.recorder = self._rec
        m = self.metrics
        self._c = {name: m.counter("serve." + name) for name in (
            "batches", "requests", "real_cells", "padded_cells", "wall_s",
            "deadline_flushes", "failures", "retries", "bisects",
            "watchdog_timeouts", "nonfinite_outputs", "rejected_inputs",
            "admission_blocked", "admission_rejected", "admission_shed")}
        self._disp = [m.counter("serve.dispatches", device=i)
                      for i in range(len(self.ring))]
        # latencies in their own bounded reservoir: trimming ``finished``
        # cannot skew them
        self._lat = m.histogram("serve.latency_ms")
        self._layouts = LayoutTable(max_live=max_live_buckets,
                                    on_evict=self._evict_bucket,
                                    metrics=m, recorder=self._rec)
        self._buckets: Dict[tuple, _BucketState] = {}
        self._n_compiles = 0        # cumulative, re-captures included
        self._healing = 0           # ladder runs in flight (serve_forever)

    @property
    def model(self) -> DRCircuitGNN:
        """The first slot's replica (the served weights)."""
        return self._slots[0].model

    # ------------------------------------------------------------- intake

    def submit(self, graph: CircuitGraph, timeout: Optional[float] = None,
               *, head: Optional[str] = None) -> int:
        """Enqueue one request; thread-safe, legal while serve_forever()
        runs.  ``head`` names a registered head (:meth:`register_head`);
        an unknown name raises ``KeyError`` here.  With ``max_queue``
        requests waiting, ``admission`` decides: ``"block"`` waits for room
        (up to ``timeout``, then :class:`TimeoutError`), ``"reject"``
        raises :class:`QueueFullError`, ``"shed_oldest"`` fails the queue's
        head with :class:`LoadShedError` and admits this one.  With
        ``validate_inputs``, non-finite features raise
        :class:`NonFiniteInputError`."""
        if head is not None and head not in self._heads:
            raise KeyError(f"unknown head {head!r}; registered heads: "
                           f"{sorted(self._heads)}")
        if self.validate_inputs:
            self._validate(graph)
        rid = next(self._rid)
        req = CircuitRequest(rid=rid, graph=graph,
                             t_submit=time.perf_counter(),
                             key=self._group_key(graph), head=head)
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._work:
            if self.max_queue is not None and \
                    len(self.queue) >= self.max_queue:
                if self.admission == "reject":
                    self._c["admission_rejected"].inc()
                    if self._rec.enabled:
                        self._rec.instant("intake", "admission_reject",
                                          rid=rid)
                    raise QueueFullError(
                        f"queue at capacity ({self.max_queue}); request "
                        f"rejected (admission='reject')")
                if self.admission == "shed_oldest":
                    while len(self.queue) >= self.max_queue:
                        old = self.queue.popleft()
                        self._c["admission_shed"].inc()
                        if self._rec.enabled:
                            self._rec.instant("intake", "admission_shed",
                                              rid=old.rid, admitted=rid)
                        self._finalize_failed_locked([old], LoadShedError(
                            f"request {old.rid} shed (FIFO head) to admit "
                            f"request {rid} under admission='shed_oldest'"))
                else:
                    waited = False
                    while len(self.queue) >= self.max_queue:
                        if not waited:
                            self._c["admission_blocked"].inc()
                            if self._rec.enabled:
                                self._rec.instant("intake",
                                                  "admission_block", rid=rid)
                            waited = True
                        rem = None if deadline is None \
                            else deadline - time.perf_counter()
                        if rem is not None and rem <= 0:
                            raise TimeoutError(
                                f"submit blocked on full queue "
                                f"({self.max_queue}) for {timeout}s")
                        self._work.wait(rem)
            self.queue.append(req)
            self._outstanding[rid] = req
            self._work.notify_all()
        if self._rec.enabled:
            self._rec.instant("intake", "submit", rid=rid,
                              bucket=str(req.key))
        return rid

    def _validate(self, g: CircuitGraph) -> None:
        """Non-finite features are rejected at the door: a poisoned member
        would fail the whole batch it lands in."""
        for name in ("x_cell", "x_net"):
            x = torch.as_tensor(getattr(g, name))
            bad = int((~torch.isfinite(x)).sum())
            if bad:
                self._c["rejected_inputs"].inc()
                if self._rec.enabled:
                    self._rec.instant("intake", "input_rejected", field=name)
                raise NonFiniteInputError(
                    f"graph.{name} contains {bad} non-finite value(s) of "
                    f"{x.numel()}; rejected at submit")

    def result(self, rid: int, timeout: Optional[float] = None,
               pop: bool = False) -> CircuitRequest:
        """Wait for request ``rid`` (serve_forever() running on another
        thread, or a later run()).  ``pop=True`` drops the engine's
        reference to it.  A failed request raises ``RuntimeError`` from its
        error."""
        deadline = None if timeout is None else time.perf_counter() + timeout
        with self._done:
            while rid not in self.finished:
                rem = None if deadline is None \
                    else deadline - time.perf_counter()
                if rem is not None and rem <= 0:
                    raise TimeoutError(f"request {rid} not finished within "
                                       f"{timeout}s")
                self._done.wait(rem)
            req = self.finished.pop(rid) if pop else self.finished[rid]
        if req.error is not None:
            raise RuntimeError(f"request {rid} failed in serving"
                               ) from req.error
        return req

    def _group_key(self, g: CircuitGraph) -> tuple:
        return (quantize_up(g.n_cell, self.node_bits),
                quantize_up(g.n_net, self.node_bits),
                g.x_cell.shape[1], g.x_net.shape[1])

    # ----------------------------------------------------------- batcher

    def _take_due_batch(self, max_wait_s: float = 0.0
                        ) -> Optional[List[CircuitRequest]]:
        """Deadline batcher (lock held).  Groups are (bucket, head), in
        order of first appearance; the first full group dispatches, else
        the oldest request's group once that request has waited
        ``max_wait_s`` (at once when ``max_wait_s <= 0``).  None when
        nothing is due.  Taken requests leave the queue; the rest keep
        their order."""
        if not self.queue:
            return None
        groups: Dict[tuple, List[CircuitRequest]] = {}
        order: List[tuple] = []
        for r in self.queue:
            k = (r.key, r.head)
            g = groups.get(k)
            if g is None:
                groups[k] = g = []
                order.append(k)
            if len(g) < self.b:
                g.append(r)
        pick = next((k for k in order if len(groups[k]) >= self.b), None)
        if pick is None:
            first = order[0]
            age = time.perf_counter() - groups[first][0].t_submit
            if max_wait_s <= 0 or age >= max_wait_s:
                pick = first
                if max_wait_s > 0 and len(groups[first]) < self.b:
                    self._c["deadline_flushes"].inc()
                    if self._rec.enabled:
                        self._rec.instant("intake", "deadline_flush",
                                          bucket=str(first),
                                          size=len(groups[first]),
                                          waited_ms=age * 1e3)
        if pick is None:
            return None
        chosen = {id(r) for r in groups[pick]}
        for _ in range(len(self.queue)):
            r = self.queue.popleft()
            if id(r) not in chosen:
                self.queue.append(r)
        self._work.notify_all()     # room for producers under "block"
        if self._rec.enabled:
            self._rec.instant("intake", "batch_formed", bucket=str(pick),
                              size=len(groups[pick]),
                              rids=[r.rid for r in groups[pick]])
        return groups[pick]

    def _next_deadline_s(self, max_wait_s: float) -> Optional[float]:
        """Seconds until the queue head's deadline (lock held); None with
        an empty queue."""
        if not self.queue or max_wait_s <= 0:
            return None if not self.queue else 0.0
        rem = self.queue[0].t_submit + max_wait_s - time.perf_counter()
        return max(rem, 0.0)

    # ----------------------------------------------------------- pipeline

    def _prepare(self, reqs: List[CircuitRequest], si: int) -> _Prepared:
        """Pool thread: collate on the host under the bucket's layout and
        lock, then copy the forward view to ring slot ``si`` (on the side
        stream, whose event the dispatch waits on).  A collation error is
        the batch's own fault (the ladder contains it); an error of the
        copy to the card is not (``_Uncontained``)."""
        rec = self._rec
        track = _worker_track() if rec.enabled else None
        key = reqs[0].key
        try:
            with (rec.span(track, "collate", batch=len(reqs),
                           bucket=str(key), device=si)
                  if rec.enabled else NULL_SPAN):
                if self.chaos is not None:
                    self.chaos.stall("straggler")
                    self.chaos.raise_if("collate")
                graphs = [r.graph for r in reqs]
                n_real = len(graphs)
                if self.pad_to_full and n_real < self.b:
                    # filler: copies of the last member (outputs dropped)
                    graphs = graphs + [graphs[-1]] * (self.b - n_real)
                with self._lock:
                    layout = self._layouts.get(key)  # LRU touch; may evict
                    st = self._buckets.get(key)
                    if st is None or st.evicted:     # (a returning bucket)
                        st = self._buckets[key] = _BucketState()
                    st.pending += 1
                plan = plan_applicable(self.cfg, self.model.hidden)
                try:
                    with st.lock:
                        batch = collate_graphs(
                            graphs, node_bits=self.node_bits,
                            arena_bits=self.arena_bits, chunk=self.chunk,
                            layout=layout, n_real=n_real, with_plan=plan,
                            with_edges=not plan, device="cpu")
                except BaseException:
                    self._release(key, st)
                    raise
        except Exception:
            # nothing touched the slot: no blame, but a probe handout must
            # not stay in probing limbo
            self.ring.release(si)
            raise
        dev = self.ring.devices[si]
        try:
            with (rec.span(track, "device_put", device=si)
                  if rec.enabled else NULL_SPAN):
                if self.chaos is not None:
                    self.chaos.raise_if("device_put", device=si)
                view, copied = self._to_slot(batch.graph, dev)
        except BaseException as e:
            self._release(key, st)
            self.ring.record_failure(si)
            if isinstance(e, InjectedFault):
                raise
            raise _Uncontained(e) from e
        return _Prepared(reqs=reqs, batch=batch, view=view, copied=copied,
                         key=key, state=st, slot=si)

    def _to_slot(self, graph: CircuitGraph, dev: torch.device):
        """The forward view of the host ``graph`` on ``dev``: pinned
        copies on the device's side stream and the event that ends them
        (None on the CPU)."""
        view = _forward_view(graph)
        if dev.type != "cuda":
            return view, None
        stream = self._copy_streams[dev]
        with torch.cuda.stream(stream):
            view = map_graph_tensors(view, lambda t: _to_tensor(t, dev))
            copied = torch.cuda.Event()
            copied.record(stream)
        return view, copied

    def _release(self, key: tuple, st: _BucketState) -> None:
        """One batch prepared under ``st`` has been dispatched (or failed,
        or was abandoned): an evicted state goes once none is left."""
        with self._lock:
            st.pending -= 1
            if st.evicted and st.pending == 0 \
                    and self._buckets.get(key) is st:
                del self._buckets[key]

    def _capture(self, view: CircuitGraph, slot: _Slot):
        """Run the slot's forward eagerly over static copies of ``view``
        on a side stream, then capture it there.  Returns the captured
        forward and the eager run's output, which serves this batch: the
        capture only records launches.  The eager run loads every kernel
        the forward launches and builds its per-pack device tables; the
        kernels' schedules are built inside the graph
        (``kernels/drspmm.py::_memo``), so a replay rebuilds them from the
        tables it was handed.  Launches recorded in the graph count only
        when a replay runs them.  The capture is thread-local, so the
        packing pool keeps allocating and copying, and it empties no
        allocator cache (``torch.cuda.graph`` would, pinned host blocks
        included)."""
        static = map_graph_tensors(view, torch.clone)
        main = torch.cuda.current_stream(slot.device)
        side = torch.cuda.Stream(slot.device)
        side.wait_stream(main)
        g = torch.cuda.CUDAGraph()
        kernels = _kernel_wrappers()
        with torch.cuda.stream(side):
            first = slot.model(static, self.cfg, self.spec, head=slot.head)
            before = [f.launches for f in kernels]
            g.capture_begin(capture_error_mode="thread_local")
            try:
                out = slot.model(static, self.cfg, self.spec, head=slot.head)
            finally:
                g.capture_end()
        recorded = {f: f.launches - b for f, b in zip(kernels, before)
                    if f.launches != b}
        for f, n in recorded.items():
            f.launches -= n
        main.wait_stream(side)
        first.record_stream(main)
        return _Captured(graph=g, inputs=graph_tensors(static), out=out,
                         launches=recorded), first

    def _dispatch(self, prepared: _Prepared) -> _Inflight:
        """Launch the batch's forward on its slot (asynchronous on a card)
        under the dispatch lock: a replay of the (signature, slot)'s
        captured graph, or, at its first dispatch in the live bucket, the
        eager run that precedes its capture; a batch whose bucket the pool
        evicted meanwhile replays a graph the bucket holds, or else runs
        eagerly (a capture would be dropped with the bucket) and counts no
        compile.  Then the output's copy to pinned host memory and the
        event ``_complete`` waits on.  An injected ``dispatch`` fault is
        the ladder's; any other error is ``_Uncontained``."""
        si = prepared.slot
        slot = self._slots[si]
        rec = self._rec
        t_disp = rec.now() if rec.enabled else 0.0
        try:
            if self.chaos is not None:
                try:
                    self.chaos.raise_if("dispatch", device=si)
                except InjectedFault:
                    self.ring.record_failure(si)
                    raise
            try:
                with self._dispatch_lock:
                    return self._launch(prepared, slot, t_disp)
            except BaseException as e:
                self.ring.record_failure(si)
                raise _Uncontained(e) from e
        finally:
            self._release(prepared.key, prepared.state)

    def _launch(self, prepared: _Prepared, slot: _Slot,
                t_disp: float) -> _Inflight:
        """``_dispatch``'s device half (dispatch lock held)."""
        si, st = prepared.slot, prepared.state
        sig = (prepared.batch.signature, si)
        with self._lock:
            live = not st.evicted
            compile_new = live and sig not in st.sigs
            if compile_new:
                st.sigs[sig] = None
                self._n_compiles += 1
            cap = st.sigs.get(sig)
            version = self._params_version
            head = prepared.reqs[0].head      # batches are head-homogeneous
            src = self._heads[head][si] if head is not None else None
        self._disp[si].inc()
        if compile_new:
            self.metrics.inc("serve.compiles")
            if self._rec.enabled:
                self._rec.instant(f"device/{si}", "compile",
                                  bucket=str(prepared.key))
        on_card = slot.device.type == "cuda"
        stream = torch.cuda.default_stream(slot.device) if on_card else None
        with torch.inference_mode(), (torch.cuda.stream(stream) if on_card
                                      else contextlib.nullcontext()):
            if prepared.copied is not None:
                stream.wait_event(prepared.copied)
            hw, hb = slot.head
            if src is None:
                src = (slot.model.head_w, slot.model.head_b)
            hw.copy_(src[0])
            hb.copy_(src[1])
            view = prepared.view
            if not on_card or (cap is None and not live):
                kind = "eager"
                out = slot.model(view, self.cfg, self.spec, head=slot.head)
            elif cap is None:
                kind = "first"
                cap, out = self._capture(view, slot)
                with self._lock:
                    st.sigs[sig] = cap
            else:
                kind = "replay"
                out = cap.run(view)
            done = None
            host = out
            if on_card:
                host = torch.empty(out.shape, dtype=out.dtype,
                                   pin_memory=True)
                host.copy_(out, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
        return _Inflight(reqs=prepared.reqs, batch=prepared.batch,
                         view=view, host=host, done=done, kind=kind,
                         cap=cap, version=version, slot=si, t_disp=t_disp)

    def _complete(self, entry: _Inflight) -> None:
        """Read the batch's output once its event completes, guard it and
        commit each real member's prediction."""
        si = entry.slot
        try:
            if entry.done is not None:
                entry.done.synchronize()
            preds = entry.host.numpy()
        except BaseException as e:
            self.ring.record_failure(si)
            raise _Uncontained(e) from e
        self.ring.record_success(si)
        if self.chaos is not None:
            preds = self.chaos.poison(preds)
        reqs, members = entry.reqs, entry.batch.members
        # a non-finite member prediction must fail as a diagnosis, never
        # be served: the ladder retries a transient, bisects a poison
        bad = [(r, m) for r, m in zip(reqs, members)
               if not np.isfinite(preds[m.cell_off:m.cell_off + m.n_cell]
                                  ).all()]
        if bad:
            self._c["nonfinite_outputs"].inc()
            rids = [r.rid for r, _ in bad]
            if self._rec.enabled:
                self._rec.instant("healing", "nonfinite_output", device=si,
                                  rids=rids)
            counts = [int((~np.isfinite(
                preds[m.cell_off:m.cell_off + m.n_cell])).sum())
                for _, m in bad]
            raise NonFiniteOutputError(
                f"non-finite predictions for request(s) {rids} ({counts} "
                f"bad cells of {[m.n_cell for _, m in bad]}) on ring slot "
                f"{si}")
        now = time.perf_counter()
        with self._done:
            committed = []
            for r, m in zip(reqs, members):
                if r.final:
                    continue      # an abandoned attempt committed first
                r.final = True
                # a copy: a view would pin the whole batch's output
                r.pred = preds[m.cell_off:m.cell_off + m.n_cell].copy()
                r.t_done = now
                r.params_version = entry.version
                self.finished[r.rid] = r
                self._outstanding.pop(r.rid, None)
                self._lat.observe(r.latency_ms)
                committed.append(m)
            self._trim_finished_locked()
            if committed:
                self._c["batches"].inc()
                self._c["requests"].inc(len(committed))
                self._c["real_cells"].inc(sum(m.n_cell for m in committed))
                self._c["padded_cells"].inc(entry.batch.graph.n_cell)
            self._done.notify_all()
        if self._rec.enabled:
            self._rec.complete(
                f"device/{si}", "batch", entry.t_disp,
                self._rec.now() - entry.t_disp, requests=len(committed),
                batch=len(reqs), params_version=entry.version,
                kind=entry.kind)

    def _evict_bucket(self, key: tuple, layout) -> None:
        """LayoutTable eviction hook (under ``self._lock``, from a pool
        thread's ``_prepare``): dropping the bucket's state drops its
        captured graphs and their memory pools, once no batch in flight
        holds them.  A state with batches waiting for dispatch is marked
        and dropped by the last of them (``_release``); a bucket that
        returns starts a new state and captures again."""
        st = self._buckets.get(key)
        if st is None:
            return
        if st.pending:
            st.evicted = True
        else:
            del self._buckets[key]

    def _trim_finished_locked(self) -> None:
        if self.max_finished is not None:
            while len(self.finished) > self.max_finished:
                self.finished.pop(next(iter(self.finished)))  # the oldest

    def _fail(self, reqs: List[CircuitRequest], exc: BaseException) -> None:
        with self._done:
            self._finalize_failed_locked(reqs, exc)

    def _finalize_failed_locked(self, reqs: List[CircuitRequest],
                                exc: BaseException) -> None:
        """Commit failures (lock held); requests already committed (an
        abandoned attempt's) are skipped."""
        now = time.perf_counter()
        failed = 0
        for r in reqs:
            if r.final:
                continue
            r.final = True
            r.error = exc
            r.t_done = now
            self.finished[r.rid] = r
            self._outstanding.pop(r.rid, None)
            failed += 1
        self._trim_finished_locked()
        if failed:
            self._c["failures"].inc(failed)
            if self._rec.enabled:
                self._rec.instant("healing", "fail", count=failed,
                                  error=type(exc).__name__,
                                  rids=[r.rid for r in reqs])
        self._done.notify_all()

    def _fail_outstanding(self, exc: BaseException) -> None:
        """A fatal error: every request not yet committed fails with it
        (``result()`` never waits on a dead pipeline)."""
        with self._done:
            self.queue.clear()
            self._finalize_failed_locked(list(self._outstanding.values()),
                                         exc)
            self._work.notify_all()

    # -------------------------------------------------- healing ladder

    def _attempt(self, reqs: List[CircuitRequest]) -> None:
        """One full serve attempt of ``reqs`` on a freshly routed slot
        (quarantined slots are skipped; a due probe may be handed out
        here)."""
        si = self.ring.next_index()
        self._complete(self._dispatch(self._prepare(reqs, si)))

    def _timed_attempt(self, reqs: List[CircuitRequest]) -> None:
        """``_attempt`` bounded by ``watchdog_s``: the attempt runs on a
        daemon thread; past the bound it is abandoned (its late commit is
        voided by the requests' ``final`` flags, and an error it raises
        then still reaches ``serve_forever`` if uncontained) and
        :class:`WatchdogTimeoutError` raises."""
        if self.watchdog_s is None:
            return self._attempt(reqs)
        box: Dict[str, BaseException] = {}
        abandoned = threading.Event()

        def attempt():
            try:
                self._attempt(reqs)
            except BaseException as e:
                box["exc"] = e
                if abandoned.is_set() and isinstance(e, _Uncontained):
                    self._set_fatal(e)

        th = threading.Thread(target=attempt, daemon=True)
        th.start()
        th.join(self.watchdog_s)
        if th.is_alive():
            abandoned.set()
            self._c["watchdog_timeouts"].inc()
            if self._rec.enabled:
                self._rec.instant("healing", "watchdog_timeout",
                                  batch=len(reqs), where="healing_attempt")
            raise WatchdogTimeoutError(
                f"healing attempt for batch of {len(reqs)} exceeded "
                f"watchdog {self.watchdog_s}s")
        if "exc" in box:
            raise box["exc"]

    def _heal(self, reqs: List[CircuitRequest], exc: BaseException,
              depth: int = 0) -> None:
        """The containment ladder, after a batch's attempt failed with
        ``exc``: up to ``max_retries`` re-serves with exponential back-off,
        each on a freshly routed slot; then, for a batch of several, a
        bisection whose halves each re-enter the ladder, so a poison member
        is isolated in O(log B) rounds and only it fails; a single request
        that keeps failing is failed with the last error.  A healthy
        member re-served here gets the prediction of a fault-free run:
        collation is block-diagonal and the bucket layout pins the padded
        shapes, so its rows do not depend on its companions.  An
        ``_Uncontained`` error passes through."""
        for attempt in range(self.max_retries):
            time.sleep(self.retry_backoff_s * (2 ** attempt))
            self._c["retries"].inc()
            if self._rec.enabled:
                self._rec.instant("healing", "retry", attempt=attempt,
                                  depth=depth, batch=len(reqs),
                                  error=type(exc).__name__)
            try:
                self._timed_attempt(reqs)
                return
            except _Uncontained:
                raise
            except Exception as e:
                exc = e
        if len(reqs) > 1:
            self._c["bisects"].inc()
            if self._rec.enabled:
                self._rec.instant("healing", "bisect", depth=depth,
                                  batch=len(reqs), error=type(exc).__name__)
            mid = len(reqs) // 2
            self._heal(reqs[:mid], exc, depth + 1)
            self._heal(reqs[mid:], exc, depth + 1)
        else:
            self._fail(reqs, exc)

    def _on_watchdog(self, reqs: List[CircuitRequest],
                     si: Optional[int] = None) -> None:
        """A pipeline batch outlived ``watchdog_s``: fail its requests now
        and blame its slot (a wedge is a device fault)."""
        self._c["watchdog_timeouts"].inc()
        if self._rec.enabled:
            self._rec.instant("healing", "watchdog_timeout",
                              batch=len(reqs), device=si, where="pipeline")
        if si is not None:
            self.ring.record_failure(si)
        self._fail(reqs, WatchdogTimeoutError(
            f"batch of {len(reqs)} in flight past the {self.watchdog_s}s "
            f"watchdog"))

    def _set_fatal(self, u: _Uncontained) -> None:
        with self._work:
            if self._fatal is None:
                self._fatal = u
            self._work.notify_all()

    def _discard(self, fut) -> None:
        """Done-callback of an abandoned prepare: its batch will never be
        dispatched, so its bucket state is released."""
        if not fut.cancelled() and fut.exception() is None:
            p = fut.result()
            self._release(p.key, p.state)

    # -------------------------------------------------------------- modes

    def run(self) -> Dict[int, CircuitRequest]:
        """Drain a snapshot of the queue: partial batches flush at once,
        batches go round-robin over the ring, and the packing pool keeps
        one batch in flight a slot (it prepares batches i+1..i+D while the
        D slots run batches i-D+1..i).  A failed batch goes through the
        healing ladder in-line; an uncontained error fails every pending
        request and raises."""
        batches = []
        with self._lock:
            if self._serving:
                raise RuntimeError("run() while serve_forever() is active; "
                                   "use submit()/result() instead")
            while self.queue:
                batches.append((self._take_due_batch(0.0),
                                self.ring.next_index()))
        t0 = time.perf_counter()
        n_dev = len(self.ring)

        def prep_safe(item):
            # a failed prepare is boxed as (reqs, error), so that it enters
            # the ladder instead of ending the prefetch iterator
            try:
                return self._prepare(*item)
            except Exception as e:
                return item[0], e

        def retire(entry):
            try:
                self._complete(entry)
            except _Uncontained:
                raise
            except Exception as e:
                self._heal(entry.reqs, e)

        inflight: Deque[_Inflight] = deque()
        try:
            for prepared in prefetch(batches, prep_safe, depth=n_dev,
                                     n_threads=max(self.n_pack_threads,
                                                   n_dev)):
                if isinstance(prepared, tuple):
                    reqs, e = prepared
                    if isinstance(e, _Uncontained):
                        raise e
                    self._heal(reqs, e)
                    continue
                try:
                    inflight.append(self._dispatch(prepared))
                except _Uncontained:
                    raise
                except Exception as e:
                    self._heal(prepared.reqs, e)
                    continue
                if len(inflight) > n_dev:
                    retire(inflight.popleft())
            while inflight:
                retire(inflight.popleft())
        except _Uncontained as u:
            self._fail_outstanding(u.exc)
            raise u.exc
        finally:
            self._c["wall_s"].inc(time.perf_counter() - t0)
        return self.finished

    def serve_forever(self, *, stop_when_idle: bool = False
                      ) -> Dict[int, CircuitRequest]:
        """Serve submits as they arrive until ``stop()`` (which drains the
        queue and the pipeline first) or, with ``stop_when_idle``, until
        the queue and the pipeline are empty.  Blocks the calling thread:
        run it on a thread of its own and feed it with ``submit()``.

        Pool threads prepare due batches (one in flight a slot, plus the
        pool's look-ahead), this thread dispatches them in order, and pool
        threads complete them, so results surface during lulls.  A failed
        batch goes to a healer thread (the ladder: retry, bisect, fail only
        the poison member) while the loop serves on; healer threads
        dispatch under the same dispatch lock.  With ``watchdog_s``, a
        batch wedged in preparation or in flight past the bound fails with
        :class:`WatchdogTimeoutError`.  An uncontained error fails every
        request not yet finished and raises here."""
        max_wait_s = self.max_wait_ms * 1e-3
        n_dev = len(self.ring)
        prep: Deque = deque()       # (future of _prepare, reqs, t0, slot)
        inflight: Deque = deque()   # (future of _complete, reqs, t0, slot)

        def overdue(t_start: float) -> bool:
            return (self.watchdog_s is not None
                    and time.perf_counter() - t_start > self.watchdog_s)

        def heal_async(reqs_h, exc):
            with self._lock:
                self._healing += 1

            def heal():
                try:
                    self._heal(reqs_h, exc)
                except _Uncontained as u:
                    self._set_fatal(u)
                except BaseException as e:
                    self._set_fatal(_Uncontained(e))
                finally:
                    with self._work:
                        self._healing -= 1
                        self._work.notify_all()

            threading.Thread(target=heal, daemon=True).start()

        def dispatch_head():
            fut, reqs_p, t_start, _si = prep.popleft()
            try:
                entry = self._dispatch(fut.result())
            except _Uncontained:
                raise
            except Exception as e:
                heal_async(reqs_p, e)
                return
            cfut = pool.submit(self._complete, entry)
            cfut.add_done_callback(self._notify_work)
            inflight.append((cfut, reqs_p, t_start, entry.slot))

        def reap_head():
            cfut, reqs_c, t_start, si = inflight.popleft()
            if cfut.done():
                exc = cfut.exception()
                if isinstance(exc, _Uncontained):
                    raise exc
                if exc is not None:
                    heal_async(reqs_c, exc)
            else:
                # overdue and still running: abandon it (the ``final``
                # flags void its late commit) and time it out
                self._on_watchdog(reqs_c, si)

        with self._lock:
            if self._serving:
                raise RuntimeError("serve_forever() is already running")
            self._serving = True
            self._fatal = None
            # _stop is not cleared: a stop() that raced ahead of this
            # thread's start still wins; it resets on exit
        t0 = time.perf_counter()
        # +2 workers: a wedged _complete past its watchdog must not starve
        # the packing look-ahead
        pool = ThreadPoolExecutor(
            max_workers=max(self.n_pack_threads, n_dev) + 2)
        try:
            while True:
                if self._fatal is not None:
                    raise self._fatal
                while prep and prep[0][0].done():
                    dispatch_head()
                while inflight and (inflight[0][0].done()
                                    or overdue(inflight[0][2])):
                    reap_head()
                if prep and overdue(prep[0][2]):
                    # a wedged prepare: the batch times out and its result,
                    # when it lands, is released unused
                    fut, reqs_p, _, si_p = prep.popleft()
                    if not fut.cancel():
                        fut.add_done_callback(self._discard)
                    self._on_watchdog(reqs_p, si_p)
                reqs = si = None
                with self._work:
                    if self._fatal is not None:
                        continue
                    # stopping flushes partials at once; one batch in
                    # flight a slot bounds the device queue
                    if len(inflight) <= n_dev:
                        reqs = self._take_due_batch(
                            0.0 if self._stop else max_wait_s)
                    if reqs is not None:
                        si = self.ring.next_index()
                    elif prep or inflight or self._healing:
                        if not ((prep and prep[0][0].done()) or
                                (inflight and inflight[0][0].done())):
                            self._work.wait(
                                self._tick_s(prep, inflight, max_wait_s))
                        continue
                    elif self._stop or (stop_when_idle and not self.queue):
                        break       # queue empty, pipeline dry, heals done
                    else:
                        self._work.wait(self._next_deadline_s(max_wait_s))
                        continue
                fut = pool.submit(self._prepare, reqs, si)
                fut.add_done_callback(self._notify_work)
                prep.append((fut, reqs, time.perf_counter(), si))
        except _Uncontained as u:
            self._fail_outstanding(u.exc)
            raise u.exc
        finally:
            pool.shutdown(wait=False)
            with self._lock:
                self._serving = False
                self._stop = False
            self._c["wall_s"].inc(time.perf_counter() - t0)
        return self.finished

    def _tick_s(self, prep, inflight, max_wait_s: float) -> Optional[float]:
        """The serve loop's sleep while the pipeline is busy: until the
        soonest of the queue head's deadline and the heads' watchdog
        deadlines (None: until a notify)."""
        cands = []
        q = self._next_deadline_s(max_wait_s)
        if q is not None:
            cands.append(q)
        if self.watchdog_s is not None:
            now = time.perf_counter()
            if prep:
                cands.append(max(prep[0][2] + self.watchdog_s - now, 0.0))
            if inflight:
                cands.append(max(inflight[0][2] + self.watchdog_s - now,
                                 0.0))
        return min(cands) if cands else None

    def stop(self) -> None:
        """Ask serve_forever() to drain (queue and pipeline) and return;
        thread-safe, and it wins even when it races ahead of the serving
        thread's start."""
        with self._work:
            self._stop = True
            self._work.notify_all()

    def _notify_work(self, _fut) -> None:
        with self._work:
            self._work.notify_all()

    # ---------------------------------------------------------- hot swap

    def update_params(self, state: Union[Mapping[str, torch.Tensor],
                                         DRCircuitGNN]) -> int:
        """Swap the served weights without stopping the loop.  ``state``
        is a state dict of the model's names and shapes, or a
        :class:`DRCircuitGNN` (``DRCircuitGNN.from_jax_params`` carries
        reference weights over).  It is copied into every slot's replica
        in place, on the compute stream, under the dispatch lock, and the
        new version is stamped in the same critical section: batches
        dispatched before it finish on the old weights, later ones read the
        new, and the captured graphs (which read the replicas' storage)
        stay valid, so a swap adds no capture.  Registered heads stay as
        they are; ``head=None`` follows the new weights' own head.
        Returns the new version."""
        if isinstance(state, torch.nn.Module):
            state = state.state_dict()
        own = self._slots[0].model.state_dict()
        if set(state) != set(own):
            raise ValueError(f"state keys {sorted(set(state) ^ set(own))} "
                             f"do not match the served model")
        for name, t in own.items():
            if tuple(state[name].shape) != tuple(t.shape):
                raise ValueError(f"{name}: shape {tuple(state[name].shape)} "
                                 f"!= {tuple(t.shape)}")
        with self._dispatch_lock:
            for slot in self._slots:
                self._on_compute(slot.device, lambda: slot.model
                                 .load_state_dict(state))
            with self._lock:
                self._params_version += 1
                return self._params_version

    @staticmethod
    def _on_compute(dev: torch.device, fn):
        """``fn()`` without autograd, on ``dev``'s compute stream."""
        with torch.no_grad(), (
                torch.cuda.stream(torch.cuda.default_stream(dev))
                if dev.type == "cuda" else contextlib.nullcontext()):
            return fn()

    @property
    def params_version(self) -> int:
        return self._params_version

    # -------------------------------------------------------- task heads

    def register_head(self, name: str, head_w, head_b=None) -> None:
        """Install (or replace) a named per-task output head over the one
        backbone.  ``head_w`` / ``head_b`` must have the model's head
        shapes (a head swaps values only, which is why it adds no
        capture); ``head_b=None`` is a zero bias.  Requests select it with
        ``submit(graph, head=name)``."""
        ref_w, ref_b = self.model.head_w, self.model.head_b

        def host(x, like):
            x = x.detach() if isinstance(x, torch.Tensor) \
                else torch.from_numpy(np.array(x))
            return x.to("cpu", like.dtype).clone()
        w = host(head_w, ref_w)
        b = torch.zeros(ref_b.shape, dtype=ref_b.dtype) if head_b is None \
            else host(head_b, ref_b)
        if w.shape != ref_w.shape or b.shape != ref_b.shape:
            raise ValueError(
                f"head {name!r} shapes {tuple(w.shape)}/{tuple(b.shape)} do "
                f"not match the backbone's head {tuple(ref_w.shape)}/"
                f"{tuple(ref_b.shape)}; a registered head swaps values only")
        with self._dispatch_lock:
            copies = tuple(self._on_compute(d, lambda d=d: (w.to(d), b.to(d)))
                           for d in self.ring.devices)
            with self._lock:
                self._heads[name] = copies

    @property
    def heads(self) -> tuple:
        """Registered head names, sorted."""
        return tuple(sorted(self._heads))

    # ------------------------------------------------------------- stats

    @property
    def compiles(self) -> int:
        """(signature, slot) first dispatches in a live bucket -- captures
        on a card -- cumulative: a bucket that returns after an eviction
        counts its re-captures too."""
        return self._n_compiles

    @property
    def live_buckets(self) -> int:
        return len(self._layouts)

    @property
    def evictions(self) -> int:
        return self._layouts.evictions

    def stats(self) -> Dict[str, float]:
        """A view of the metrics registry with the reference engine's keys
        (but ``jit_cache_size``, which only a JAX jit cache has)."""
        with self._lock:
            live = sum(len(s.sigs) for s in self._buckets.values())
            queued = len(self.queue)
        health = self.ring.health()
        ci = {name: int(cnt.value) for name, cnt in self._c.items()}
        wall_s = self._c["wall_s"].value
        p50, p95, p99 = self._lat.percentiles((0.50, 0.95, 0.99))
        return dict(requests=ci["requests"], batches=ci["batches"],
                    compiles=self.compiles,
                    graphs_per_s=ci["requests"] / max(wall_s, 1e-9),
                    p50_ms=p50, p95_ms=p95, p99_ms=p99, wall_s=wall_s,
                    cell_padding_ratio=(ci["padded_cells"]
                                        / max(ci["real_cells"], 1)),
                    deadline_flushes=ci["deadline_flushes"],
                    failures=ci["failures"], retries=ci["retries"],
                    bisects=ci["bisects"],
                    watchdog_timeouts=ci["watchdog_timeouts"],
                    nonfinite_outputs=ci["nonfinite_outputs"],
                    rejected_inputs=ci["rejected_inputs"],
                    admission_blocked=ci["admission_blocked"],
                    admission_rejected=ci["admission_rejected"],
                    admission_shed=ci["admission_shed"],
                    queued=queued,
                    device_health=health["states"],
                    quarantines=health["quarantines"],
                    probes=health["probes"],
                    readmissions=health["readmissions"],
                    devices=len(self.ring),
                    dispatches_per_device=[int(c.value) for c in self._disp],
                    live_buckets=self.live_buckets,
                    evictions=self.evictions, live_compiles=live,
                    params_version=self._params_version)

    # --------------------------------------------------------- exports

    @property
    def recorder(self) -> Recorder:
        return self._rec

    def dump_trace(self, path: str) -> None:
        """Write the Chrome trace-event JSON to ``path`` (an empty, valid
        trace with the default no-op recorder)."""
        self._rec.dump(path)

    def metrics_snapshot(self) -> Dict[str, object]:
        return self.metrics.snapshot()

    def metrics_text(self) -> str:
        """Prometheus text exposition of the engine's registry."""
        return self.metrics.to_prometheus()
