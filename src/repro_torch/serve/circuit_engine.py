"""Circuit serve engine: batched DR-CircuitGNN congestion inference.

Requests are whole circuit graphs.  The engine batches them by
block-diagonal collation (``graphs/collate.py``):

* **intake** -- ``submit()`` is thread-safe; it rejects graphs with
  non-finite features at the door and stamps each request with its shape
  bucket (quantised node counts + feature widths);
* **batcher** -- requests group by bucket, FIFO within a bucket; ``run()``
  drains the queue, dispatching the first full bucket first and flushing
  partial buckets at once;
* **packing pool** -- pool threads collate upcoming batches and copy them
  pinned-host -> device on a side stream (``core.parallel.prefetch``), so
  batch i+1 packs and copies while the card runs batch i; the compute
  stream waits on the copy's event before it reads the batch;
* **completion** -- each batch's output is split per member, and a
  non-finite prediction fails the batch's requests with a diagnosis
  instead of being served.

``stats()`` reports requests, batches, graphs/s, p50/p95 latency and the
collated cell padding.  The engine serves ``backend="fused"`` with
``use_plan=True`` and refuses other configs at construction.  The online loop, healing, chaos hooks, multi-tenant
heads, the device ring and tracing come later in the port.
"""

from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.hetero_mp import (HeteroMPConfig, plan_applicable,
                                        single_graph_field)
from repro_torch.core.parallel import prefetch
from repro_torch.graphs.circuit import CircuitGraph
from repro_torch.graphs.collate import collate_graphs, quantize_up
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
                 max_batch: int = 8, n_pack_threads: int = 3, device="cuda"):
        field = single_graph_field(cfg)
        if field is not None:
            raise NotImplementedError(
                f"serving with {field}={getattr(cfg, field)!r} is not "
                f"ported yet: the reference serves collated fused arenas, "
                f"which run the fused kernels under it")
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
        self.queue: Deque[CircuitRequest] = deque()
        self.finished: Dict[int, CircuitRequest] = {}
        self._rid = itertools.count()
        self._lock = threading.Lock()
        # side stream for the host -> device copies of upcoming batches
        self._copy_stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
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
        return (quantize_up(g.n_cell, self.SERVE_NODE_BITS),
                quantize_up(g.n_net, self.SERVE_NODE_BITS),
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
        """Pool thread: collate and issue the copies to the device (on the
        side stream, whose completion event the dispatch waits on).  The
        relation plan is built only where the model reads it."""
        graphs = [r.graph for r in reqs]
        with_plan = plan_applicable(self.cfg, self.model.hidden)
        if self._copy_stream is None:
            return reqs, collate_graphs(graphs, with_plan=with_plan,
                                        device=self.device), None
        with torch.cuda.stream(self._copy_stream):
            batch = collate_graphs(graphs, with_plan=with_plan,
                                   device=self.device)
            copied = torch.cuda.Event()
            copied.record(self._copy_stream)
        return reqs, batch, copied

    def _dispatch(self, prepared):
        """Launch the batch's forward (asynchronous on a card).  The batch
        tensors stay referenced until ``_complete`` has read the output, so
        the copy stream's allocations are never reused while the compute
        stream still reads them."""
        reqs, batch, copied = prepared
        if copied is not None:
            torch.cuda.current_stream(self.device).wait_event(copied)
        with torch.inference_mode():
            out = self.model(batch.graph, self.cfg)
        return reqs, batch, out

    def _complete(self, inflight) -> None:
        reqs, batch, out = inflight
        preds = out.cpu().numpy()                 # waits for the device
        parts = [preds[m.cell_off:m.cell_off + m.n_cell]
                 for m in batch.members]
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
            self._c["real_cells"] += sum(m.n_cell for m in batch.members)
            self._c["padded_cells"] += batch.graph.n_cell

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
        requests; an error launching the forward raises."""
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
            # a failed kernel launch is not a per-request fault: it raises
            inflight.append(self._dispatch(prepared))
            if len(inflight) > 1:
                retire(inflight.popleft())
        while inflight:
            retire(inflight.popleft())
        self._wall_s += time.perf_counter() - t0
        return self.finished

    # -------------------------------------------------------------- stats

    def stats(self) -> Dict[str, float]:
        with self._lock:
            c = dict(self._c)
            lat = sorted(self._lat_ms)
        return dict(requests=c["requests"], batches=c["batches"],
                    graphs_per_s=c["requests"] / max(self._wall_s, 1e-9),
                    p50_ms=percentile(lat, 0.50),
                    p95_ms=percentile(lat, 0.95),
                    wall_s=self._wall_s,
                    cell_padding_ratio=(c["padded_cells"]
                                        / max(c["real_cells"], 1)),
                    failures=c["failures"],
                    rejected_inputs=c["rejected_inputs"],
                    nonfinite_outputs=c["nonfinite_outputs"])
