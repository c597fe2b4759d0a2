"""Circuit serve engine: batched DR-CircuitGNN congestion inference.

Requests are whole circuit graphs.  The engine batches them by
block-diagonal collation (``graphs/collate.py``):

* **intake** -- ``submit()`` is thread-safe; it rejects graphs with
  non-finite features at the door and stamps each request with its shape
  bucket (quantised node counts + feature widths);
* **batcher** -- requests group by bucket, FIFO within a bucket; ``run()``
  drains the queue, dispatching the first full bucket first and flushing
  partial buckets at once.  With ``pad_to_full`` a partial batch is filled
  up with copies of its last member, whose outputs are dropped, so that it
  keeps the full batch's signature;
* **per-bucket state** -- each bucket's :class:`BucketLayout` (pinned chunk
  widths and tiers, floored chunk counts: the batches of a bucket converge
  on one padded signature) and its :class:`_BucketState` (a pack lock and
  the captured graphs) live in an LRU :class:`LayoutTable` bounded by
  ``max_live_buckets``; an evicted bucket drops both as one unit;
* **CUDA graphs** -- on a card the first dispatch of a signature in a live
  bucket runs the batch forward eagerly (its output serves the batch) and
  captures it in a ``torch.cuda.CUDAGraph``; every later batch of that
  signature copies the tensors the forward reads into the graph's static
  inputs and replays it.  This is the port's counterpart of the
  reference's compile-once-per-signature: ``compiles`` counts captures,
  re-captures after an eviction included (on the CPU, first dispatches of
  a signature, the events the reference counts).  A bucket evicted while
  one of its batches waits for dispatch keeps its state until that batch
  is dispatched (it replays a graph the bucket holds, else it runs
  eagerly: no capture is made for a bucket on its way out); a returning
  bucket starts a new state.  A capture or replay that fails raises;
  nothing falls back to the eager forward.  On the plan path batches are
  collated without per-edge-type arenas, which that forward never reads;
* **packing pool** -- pool threads collate upcoming batches and copy them
  pinned-host -> device on a side stream (``core.parallel.prefetch``), so
  batch i+1 packs and copies while the card runs batch i; the compute
  stream waits on the copy's event before it reads the batch;
* **completion** -- each batch's output is split per real member, and a
  non-finite prediction fails the batch's requests with a diagnosis
  instead of being served.

``stats()`` reports requests, batches, graphs/s, p50/p95 latency, the
collated cell padding (filler and grid padding over real cells),
``compiles``, ``live_buckets`` and ``evictions``.  The online loop,
healing, chaos hooks, multi-tenant heads, the device ring and tracing come
later in the port.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.hetero_mp import HeteroMPConfig, plan_applicable
from repro_torch.core.parallel import prefetch
from repro_torch.graphs.circuit import CircuitGraph
from repro_torch.graphs.collate import (ARENA_GRID_BITS, LayoutTable,
                                        collate_graphs, graph_tensors,
                                        map_graph_tensors, quantize_up)
from repro_torch.models.hgnn import DRCircuitGNN
from repro_torch.train.metrics import percentile


class NonFiniteInputError(ValueError):
    """submit() rejected a graph whose features contain NaN/Inf."""


class NonFiniteOutputError(RuntimeError):
    """A member's prediction came out NaN/Inf."""


@dataclasses.dataclass
class CircuitRequest:
    rid: int
    graph: CircuitGraph
    t_submit: float
    key: tuple                              # shape bucket, stamped by submit()
    t_done: float = 0.0
    pred: Optional[np.ndarray] = None       # (n_cell,) congestion in [0, 1]
    error: Optional[BaseException] = None   # set when the batch failed

    @property
    def latency_ms(self) -> float:
        return (self.t_done - self.t_submit) * 1e3


def _forward_view(graph: CircuitGraph) -> CircuitGraph:
    """The part of a batch that the served forward reads: no labels and,
    on the plan path, none of the plan's backward tables.  A capture takes
    static copies of this view only, and a replay copies only it."""
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
    """One signature's captured batch forward: the graph, its static
    input tensors (``graph_tensors`` of the batch's ``_forward_view``),
    its static output, and the kernel launches recorded in it (wrapper ->
    count), which every replay runs."""
    graph: torch.cuda.CUDAGraph
    inputs: List[torch.Tensor]
    out: torch.Tensor
    launches: Dict[Callable, int]

    def run(self, graph: CircuitGraph) -> torch.Tensor:
        """Copy ``graph``'s forward view into the static inputs, replay,
        and return a copy of the output, all on the current stream: a
        later batch's copies into the same inputs queue behind this
        replay, and its replay overwrites the static output only after
        the copy.  The replay's launches count on their wrappers."""
        for s, t in zip(self.inputs, graph_tensors(_forward_view(graph))):
            s.copy_(t)
        self.graph.replay()
        for fn, n in self.launches.items():
            fn.launches += n
        return self.out.clone()


@dataclasses.dataclass
class _BucketState:
    """Engine-side per-bucket state, dropped as one unit when its bucket
    is evicted and none of its batches waits for dispatch (new per-bucket
    fields belong here, so they cannot outlive ``max_live_buckets`` by
    more than the batches in the pipeline)."""
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)
    # signatures dispatched while the bucket is live -> their captured
    # forward (None on the CPU)
    sigs: Dict[tuple, Optional[_Captured]] = dataclasses.field(
        default_factory=dict)
    # batches prepared under this state and not yet dispatched
    pending: int = 0
    # evicted from the layout table; dropped when ``pending`` reaches 0
    evicted: bool = False


# boxed through run()'s prefetch pipeline so a failed prepare fails its own
# batch instead of ending the iterator
_PREP_FAILED = object()


class CircuitServeEngine:
    """Micro-batching congestion-prediction server over one model on one
    device (a card unless ``device="cpu"`` is asked for)."""

    # one mantissa bit: a size class with ±10% jitter collapses into one
    # bucket
    SERVE_NODE_BITS = 1

    def __init__(self, model: DRCircuitGNN, cfg: HeteroMPConfig, *,
                 max_batch: int = 8, n_pack_threads: int = 3,
                 node_bits: int = SERVE_NODE_BITS,
                 arena_bits: int = ARENA_GRID_BITS,
                 chunk: Union[None, int, Dict[str, int]] = None,
                 pad_to_full: bool = True,
                 max_live_buckets: Optional[int] = None, device="cuda"):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model on {model.device}, engine on "
                             f"{self.device}")
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.model = model.eval()
        self.cfg = cfg
        self.b = max_batch
        self.n_pack_threads = n_pack_threads
        self.node_bits = node_bits
        self.arena_bits = arena_bits
        self.chunk = chunk
        self.pad_to_full = pad_to_full
        self.queue: Deque[CircuitRequest] = deque()
        self.finished: Dict[int, CircuitRequest] = {}
        self._rid = itertools.count()
        self._lock = threading.Lock()
        # side stream for the host -> device copies of upcoming batches
        self._copy_stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        # per-bucket state, evicted together: the layout (the table's
        # value) and the engine's _BucketState
        self._layouts = LayoutTable(max_live=max_live_buckets,
                                    on_evict=self._evict_bucket)
        self._buckets: Dict[tuple, _BucketState] = {}
        self._n_compiles = 0        # cumulative, re-captures included
        self._c = dict(batches=0, requests=0, real_cells=0, padded_cells=0,
                       failures=0, rejected_inputs=0, nonfinite_outputs=0)
        self._wall_s = 0.0
        self._lat_ms: List[float] = []

    # ------------------------------------------------------------- intake

    def submit(self, graph: CircuitGraph) -> int:
        """Enqueue one request (thread-safe); returns its id."""
        self._validate(graph)
        rid = next(self._rid)
        req = CircuitRequest(rid=rid, graph=graph,
                             t_submit=time.perf_counter(),
                             key=self._group_key(graph))
        with self._lock:
            self.queue.append(req)
        return rid

    def _validate(self, g: CircuitGraph) -> None:
        for name in ("x_cell", "x_net"):
            x = getattr(g, name)
            bad = int((~torch.isfinite(x)).sum())
            if bad:
                with self._lock:
                    self._c["rejected_inputs"] += 1
                raise NonFiniteInputError(
                    f"graph.{name} contains {bad} non-finite value(s) of "
                    f"{x.numel()}; rejected at submit")

    def _group_key(self, g: CircuitGraph) -> tuple:
        return (quantize_up(g.n_cell, self.node_bits),
                quantize_up(g.n_net, self.node_bits),
                g.x_cell.shape[1], g.x_net.shape[1])

    def _take_due_batch(self) -> List[CircuitRequest]:
        """Drain-mode batcher (lock held, queue non-empty): the first bucket
        holding ``max_batch`` requests, else the bucket of the oldest
        request.  Taken requests leave the queue; the rest keep their
        order."""
        groups: Dict[tuple, List[CircuitRequest]] = {}
        for r in self.queue:
            g = groups.setdefault(r.key, [])
            if len(g) < self.b:
                g.append(r)
        pick = next((k for k, g in groups.items() if len(g) >= self.b),
                    self.queue[0].key)
        chosen = {id(r) for r in groups[pick]}
        for _ in range(len(self.queue)):
            r = self.queue.popleft()
            if id(r) not in chosen:
                self.queue.append(r)
        return groups[pick]

    # ----------------------------------------------------------- pipeline

    def _prepare(self, reqs: List[CircuitRequest]):
        """Pool thread: collate under the bucket's layout and lock, and
        issue the copies to the device (on the side stream, whose
        completion event the dispatch waits on).  The relation plan is
        built only where the model reads it."""
        graphs = [r.graph for r in reqs]
        n_real = len(graphs)
        if self.pad_to_full and n_real < self.b:
            # filler replicates the last member (outputs dropped, loss
            # weight 0), so a partial batch keeps the full batch's shapes
            graphs = graphs + [graphs[-1]] * (self.b - n_real)
        key = reqs[0].key
        with self._lock:
            layout = self._layouts.get(key)      # LRU touch; may evict
            st = self._buckets.get(key)
            if st is None or st.evicted:         # (a returning bucket)
                st = self._buckets[key] = _BucketState()
            st.pending += 1
        plan = plan_applicable(self.cfg, self.model.hidden)
        kw = dict(node_bits=self.node_bits, arena_bits=self.arena_bits,
                  chunk=self.chunk, layout=layout, n_real=n_real,
                  with_plan=plan, with_edges=not plan, device=self.device)
        try:
            with st.lock:
                if self._copy_stream is None:
                    return reqs, collate_graphs(graphs, **kw), None, key, st
                with torch.cuda.stream(self._copy_stream):
                    batch = collate_graphs(graphs, **kw)
                    copied = torch.cuda.Event()
                    copied.record(self._copy_stream)
        except BaseException:
            self._release(key, st)
            raise
        return reqs, batch, copied, key, st

    def _release(self, key: tuple, st: _BucketState) -> None:
        """One batch prepared under ``st`` has been dispatched (or failed):
        an evicted state goes once no batch of it is left."""
        with self._lock:
            st.pending -= 1
            if st.evicted and st.pending == 0 \
                    and self._buckets.get(key) is st:
                del self._buckets[key]

    def _capture(self, graph: CircuitGraph):
        """Run the model's forward eagerly over static copies of
        ``graph``'s forward view on a side stream, then capture it there.
        Returns the captured forward and the eager run's output, which
        serves this batch: the capture only records launches.  The eager
        run loads every kernel the forward launches and builds its
        per-pack device tables; the kernels' schedules are built inside
        the graph (``kernels/drspmm.py::_memo``), so a replay rebuilds
        them from the tables it was handed.  Launches recorded in the
        graph count only when a replay runs them.  The capture is
        thread-local, so the packing pool keeps allocating and copying,
        and it empties no allocator cache (``torch.cuda.graph`` would,
        pinned host blocks included, which the next batches then
        allocate again)."""
        static = map_graph_tensors(_forward_view(graph), torch.clone)
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(main)
        g = torch.cuda.CUDAGraph()
        kernels = _kernel_wrappers()
        with torch.cuda.stream(side):
            first = self.model(static, self.cfg)
            before = [f.launches for f in kernels]
            g.capture_begin(capture_error_mode="thread_local")
            try:
                out = self.model(static, self.cfg)
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

    def _dispatch(self, prepared):
        """Launch the batch's forward (asynchronous on a card): a replay
        of the signature's captured graph, or, at the signature's first
        dispatch in the live bucket, the eager run that precedes its
        capture.  The pool prepares the next batch meanwhile and may evict
        this batch's bucket: such a batch replays a graph its bucket
        holds, or else runs eagerly (a capture would be dropped with the
        bucket), and counts no compile.  The batch tensors and the
        captured graph stay referenced until ``_complete`` has read the
        output, so neither the copy stream's allocations nor an evicted
        graph's pool are reused while the compute stream still reads
        them."""
        reqs, batch, copied, key, st = prepared
        try:
            if copied is not None:
                torch.cuda.current_stream(self.device).wait_event(copied)
            sig = batch.signature
            with self._lock:
                live = not st.evicted
                if live and sig not in st.sigs:
                    st.sigs[sig] = None
                    self._n_compiles += 1
                cap = st.sigs.get(sig)
            with torch.inference_mode():
                if self.device.type != "cuda" or (cap is None and not live):
                    return (reqs, batch, self.model(batch.graph, self.cfg),
                            None)
                if cap is None:
                    cap, out = self._capture(batch.graph)
                    with self._lock:
                        st.sigs[sig] = cap
                    return reqs, batch, out, cap
                return reqs, batch, cap.run(batch.graph), cap
        finally:
            self._release(key, st)

    def _complete(self, inflight) -> None:
        reqs, batch, out, _cap = inflight
        preds = out.cpu().numpy()                 # waits for the device
        real = batch.members[:len(reqs)]          # filler outputs dropped
        parts = [preds[m.cell_off:m.cell_off + m.n_cell] for m in real]
        bad = [(r.rid, int((~np.isfinite(p)).sum()))
               for r, p in zip(reqs, parts) if not np.isfinite(p).all()]
        if bad:
            with self._lock:
                self._c["nonfinite_outputs"] += 1
            raise NonFiniteOutputError(
                f"non-finite predictions (request id, bad cells): {bad}")
        now = time.perf_counter()
        with self._lock:
            for r, p in zip(reqs, parts):
                r.pred = p.copy()     # a view would pin the whole batch
                r.t_done = now
                self.finished[r.rid] = r
                self._lat_ms.append(r.latency_ms)
            self._c["batches"] += 1
            self._c["requests"] += len(reqs)
            self._c["real_cells"] += sum(m.n_cell for m in real)
            self._c["padded_cells"] += batch.graph.n_cell

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

    def _fail(self, reqs: List[CircuitRequest], exc: BaseException) -> None:
        """Contain a batch failure: its requests finish with ``error`` set
        and the rest of the stream is served."""
        now = time.perf_counter()
        with self._lock:
            for r in reqs:
                r.error, r.t_done = exc, now
                self.finished[r.rid] = r
            self._c["failures"] += len(reqs)

    # -------------------------------------------------------------- modes

    def run(self) -> Dict[int, CircuitRequest]:
        """Drain a snapshot of the queue.  The packing pool prepares batch
        i+1 while the device runs batch i; a batch is retired (its output
        read back) once the next one has been launched.  A batch whose
        collation fails or whose output is non-finite fails its own
        requests; an error capturing or launching the forward raises."""
        with self._lock:
            batches = []
            while self.queue:
                batches.append(self._take_due_batch())
        t0 = time.perf_counter()

        def prep_safe(reqs):
            try:
                return self._prepare(reqs)
            except Exception as e:            # fails this batch only
                return _PREP_FAILED, reqs, e

        def retire(entry):
            try:
                self._complete(entry)
            except Exception as e:            # fails this batch only
                self._fail(entry[0], e)

        inflight: Deque = deque()
        for prepared in prefetch(batches, prep_safe, depth=1,
                                 n_threads=self.n_pack_threads):
            if prepared[0] is _PREP_FAILED:
                self._fail(prepared[1], prepared[2])
                continue
            # a failed capture or launch is not a per-request fault: it
            # raises
            inflight.append(self._dispatch(prepared))
            if len(inflight) > 1:
                retire(inflight.popleft())
        while inflight:
            retire(inflight.popleft())
        self._wall_s += time.perf_counter() - t0
        return self.finished

    # -------------------------------------------------------------- stats

    @property
    def compiles(self) -> int:
        """Captures (first dispatches of a signature in a live bucket),
        cumulative: a bucket that returns after an eviction counts its
        re-captures too."""
        return self._n_compiles

    @property
    def live_buckets(self) -> int:
        return len(self._layouts)

    @property
    def evictions(self) -> int:
        return self._layouts.evictions

    def stats(self) -> Dict[str, float]:
        with self._lock:
            c = dict(self._c)
            lat = sorted(self._lat_ms)
        return dict(requests=c["requests"], batches=c["batches"],
                    compiles=self.compiles,
                    graphs_per_s=c["requests"] / max(self._wall_s, 1e-9),
                    p50_ms=percentile(lat, 0.50),
                    p95_ms=percentile(lat, 0.95),
                    wall_s=self._wall_s,
                    cell_padding_ratio=(c["padded_cells"]
                                        / max(c["real_cells"], 1)),
                    failures=c["failures"],
                    rejected_inputs=c["rejected_inputs"],
                    nonfinite_outputs=c["nonfinite_outputs"],
                    live_buckets=self.live_buckets,
                    evictions=self.evictions)
