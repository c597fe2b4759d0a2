"""End-to-end DR-CircuitGNN trainer for congestion prediction.

The paper's protocol (Sec. 4.1): MSE regression on per-cell congestion,
AdamW, and rank-correlation metrics.  One step is: the graph (or a
block-diagonal collated batch) with its relation plan on the card ->
``DRCircuitGNN.forward`` -> loss -> ``loss.backward()`` through the sampled
DR-SpMM backward kernels -> non-finite check -> AdamW update.  A step whose
gradients are not all finite is skipped as a true no-op (parameters,
moments and the step counter stay) and counted in ``nonfinite_grad_steps``.

Plans and collated batches are built once on the host and cached on the
card, per graph and per member-id tuple, so an epoch after the first pays
no host packing.  Batches are collated into fused, quantized arenas
(``graphs/collate.py``), as in the reference, so they run the fused
kernels under every ``backend`` and ``use_plan``.  Where the plan path
does not apply (``core/hetero_mp.py::plan_applicable``: ``use_plan=False``,
``backend="bucket"``, k >= hidden on a node type, or ``use_drelu=False``,
the paper's dense-SpMM baseline) no plan is built: each layer runs one
single-relation op per relation, over a batch's fused arenas or a single
graph's packings, whose device tables are memoised on the card.
``auto_k`` runs the K profiler (:meth:`CircuitTrainer.profile_k`) before
:meth:`CircuitTrainer.fit` trains.

Robustness and observability: ``chaos`` (a
:class:`~repro_torch.fault.inject.FaultInjector`) can stall a step at its
``straggler`` point; every step's wall-clock feeds ``monitor`` (a
:class:`~repro_torch.fault.monitor.StepMonitor`) and the trainer's
``registry`` (``train.steps``, ``train.nonfinite_grad_steps``, the
``train.step_ms`` histogram, and the ``train.peak_memory_bytes`` /
``train.recompute_ms`` gauges); ``recorder`` marks skipped steps.

Scale-out: ``n_shards > 1`` partitions each single graph's plan over that
many shards (``sharding/plan_shard.py``; kernels 1 and 4 once per shard and
layer, shards placed by ``shard_devices``: the visible cards in turn), as
the reference's giant-graph steps; ``train_epoch(devices=...)`` takes
data-parallel steps, each batch's members dealt round-robin to the slots of
a :class:`~repro_torch.sharding.specs.DeviceRing`, each slot's gradient
taken on a replica of the model on its device, and their member-weighted
mean applied once by AdamW on the master weights.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.drelu import profile_optimal_k
from repro_torch.core.hetero_mp import (DRELU_BACKENDS, HeteroMPConfig,
                                        plan_applicable)
from repro_torch.fault.inject import FaultInjector
from repro_torch.fault.monitor import StepMonitor
from repro_torch.graphs.circuit import (EDGE_SCHEMA, CircuitGraph,
                                        relation_plan_of, sharded_plan_of)
from repro_torch.graphs.collate import collate_graphs
from repro_torch.graphs.ell import ell_to_coo
from repro_torch.kernels import ops
from repro_torch.models.backbone import BackboneSpec
from repro_torch.models.hgnn import DRCircuitGNN, batched_loss_fn, loss_fn
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_RECORDER, Recorder
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.schedules import constant
from repro_torch.sharding.specs import DeviceRing, batch_devices
from repro_torch.train import metrics as M


@dataclasses.dataclass
class CircuitTrainConfig:
    hidden: int = 64
    n_layers: int = 2
    k_cell: int = 16
    k_net: int = 16
    auto_k: bool = False              # profile per-type optimal K (Sec. 4.3)
    lr: float = 2e-4                  # the paper's DR-CircuitGNN setup
    weight_decay: float = 1e-5
    epochs: int = 10
    drelu_backend: str = "topk"       # "topk" | "bisect" (CUDA kernel)
    use_drelu: bool = True            # False: the dense-SpMM baseline
    # "fused" | "bucket" (per-degree-bucket kernels on single graphs)
    backend: str = "fused"
    use_plan: bool = True             # False: the serial per-relation path
    # > 1: single-graph steps run the graph's plan partitioned over that
    # many shards (the sharded path has no remat, as in the reference)
    n_shards: int = 0
    # dense-tier crossover for single-graph plans (None: DENSE_TIER_NNZ);
    # collated batches are tiered at pack time with the constant
    dense_threshold: Optional[int] = None
    seed: int = 0                     # weights of a model the trainer makes
    batch_size: int = 1               # graphs per optimizer step
    remat: bool = False               # recompute each layer in the backward
    wiring: str = "plain"             # plain | residual | dense

    def __post_init__(self):
        if self.drelu_backend not in DRELU_BACKENDS:
            raise ValueError(f"unknown drelu_backend {self.drelu_backend!r}; "
                             f"expected one of {DRELU_BACKENDS}")
        ops.check_backend(self.backend)


def _grads(model: DRCircuitGNN, loss_of) -> tuple:
    """``loss_of()``'s value and the gradients of ``model``'s parameters
    (zeros where none reaches, as for the last layer's net-side weights)."""
    for p in model.parameters():
        p.grad = None
    loss = loss_of()
    loss.backward()
    return loss.detach(), [p.grad if p.grad is not None
                           else torch.zeros_like(p)
                           for p in model.parameters()]


class CircuitTrainer:
    """Trains ``model`` (or a fresh one drawn from ``generator``, seed
    ``cfg.seed`` when omitted) on ``device``; without a card,
    ``device="cpu"`` must be asked for explicitly."""

    def __init__(self, cfg: CircuitTrainConfig, f_cell: int, f_net: int, *,
                 model: Optional[DRCircuitGNN] = None,
                 generator: Optional[torch.Generator] = None,
                 device="cuda", chaos: Optional[FaultInjector] = None,
                 monitor: Optional[StepMonitor] = None,
                 registry: Optional[MetricsRegistry] = None,
                 recorder: Optional[Recorder] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if model is None:
            g = generator if generator is not None \
                else torch.Generator().manual_seed(cfg.seed)
            model = DRCircuitGNN(f_cell, f_net, cfg.hidden, cfg.n_layers,
                                 device=self.device, generator=g)
        elif model.device != self.device:
            raise ValueError(f"model on {model.device}, trainer on "
                             f"{self.device}")
        if model.hidden != cfg.hidden or len(model.layers) != cfg.n_layers:
            raise ValueError(
                f"model (hidden {model.hidden}, {len(model.layers)} layers) "
                f"does not match cfg (hidden {cfg.hidden}, "
                f"{cfg.n_layers} layers)")
        self.model = model
        self.mp_cfg = HeteroMPConfig(hidden=cfg.hidden, k_cell=cfg.k_cell,
                                     k_net=cfg.k_net,
                                     drelu_backend=cfg.drelu_backend,
                                     dense_threshold=cfg.dense_threshold,
                                     use_drelu=cfg.use_drelu,
                                     backend=cfg.backend,
                                     use_plan=cfg.use_plan,
                                     n_shards=cfg.n_shards)
        self._with_plan = plan_applicable(self.mp_cfg, cfg.hidden)
        self.spec = BackboneSpec(depth=cfg.n_layers, hidden=cfg.hidden,
                                 wiring=cfg.wiring, remat=cfg.remat)
        self.params = list(model.parameters())
        self.opt_state = adamw_init(self.params)
        self.lr = constant(cfg.lr)
        self.step_loss: List[float] = []  # loss of each step (nan: skipped)
        self.chaos = chaos
        self.monitor = monitor if monitor is not None \
            else StepMonitor(n_hosts=1)
        self.metrics = registry if registry is not None else MetricsRegistry()
        self._rec = recorder if recorder is not None else NULL_RECORDER
        if self.chaos is not None and self._rec.enabled:
            self.chaos.recorder = self._rec
        self._c_steps = self.metrics.counter("train.steps")
        self._c_nonfinite = self.metrics.counter("train.nonfinite_grad_steps")
        self._h_step_ms = self.metrics.histogram("train.step_ms")
        self._g_peak = self.metrics.gauge("train.peak_memory_bytes")
        self._g_recompute = self.metrics.gauge("train.recompute_ms")
        # id(step input) -> (the input, pinned; its forward ms)
        self._fwd_time_cache: Dict[int, tuple] = {}
        self._global_step = 0
        # id(graph) / member-id tuple -> (pinned members, device graph);
        # the entry pins its graphs so their ids cannot be reused
        self._plan_cache: Dict[int, tuple] = {}
        self._batch_cache: Dict[tuple, tuple] = {}
        # data-parallel replicas of the model, one per ring slot
        self._replicas: Dict[int, DRCircuitGNN] = {}

    @property
    def nonfinite_grad_steps(self) -> int:
        """Skipped steps (a view of the registry's counter)."""
        return int(self._c_nonfinite.value)

    def stats(self) -> Dict[str, float]:
        """The registry's step counters and step-time percentiles."""
        p50, p95, p99 = self._h_step_ms.percentiles((0.50, 0.95, 0.99))
        return {"steps": int(self._c_steps.value),
                "nonfinite_grad_steps": self.nonfinite_grad_steps,
                "step_p50_ms": p50, "step_p95_ms": p95, "step_p99_ms": p99,
                "peak_memory_bytes": int(self._g_peak.value),
                "recompute_ms": float(self._g_recompute.value)}

    def _peak_memory_bytes(self) -> int:
        """Peak device memory: ``torch.cuda.max_memory_allocated`` on a
        card; on the CPU the bytes of the trainer's own parameters and
        AdamW moments (a live-buffer estimate, as the reference's CPU
        fallback)."""
        if self.device.type == "cuda":
            return int(torch.cuda.max_memory_allocated(self.device))
        return int(sum(t.numel() * t.element_size() for t in
                       self.params + self.opt_state.m + self.opt_state.v))

    def _recompute_ms(self, loss_of, key) -> float:
        """Under ``remat``, the extra work a step's backward pays: one
        forward of the step's loss, timed once per step input (``key``,
        pinned in the cache) with the device synchronised; 0.0 without
        remat."""
        if not self.cfg.remat:
            return 0.0
        hit = self._fwd_time_cache.get(id(key))
        if hit is not None and hit[0] is key:
            return hit[1]
        sync = (lambda: torch.cuda.synchronize(self.device)) \
            if self.device.type == "cuda" else (lambda: None)
        with torch.no_grad():
            sync()
            t0 = time.perf_counter()
            loss_of()
            sync()
        est = (time.perf_counter() - t0) * 1e3
        self._fwd_time_cache[id(key)] = (key, est)
        return est

    def _tick(self, duration_s: float, recompute_ms: float = 0.0) -> None:
        """One step's wall-clock to the monitor (host 0) and the registry,
        and the memory / recompute gauges."""
        self.monitor.record(self._global_step, 0, duration_s)
        self._global_step += 1
        self._c_steps.inc()
        self._h_step_ms.observe(duration_s * 1e3)
        self._g_peak.set(self._peak_memory_bytes())
        self._g_recompute.set(recompute_ms)

    def _planned(self, g: CircuitGraph) -> CircuitGraph:
        """``g`` on the device with its relation plan attached (cached):
        with ``n_shards > 1`` its sharded plan, each shard's tables on its
        device (``shard_devices``), so that the kernels' schedules are
        built once per graph.  Where the plan path does not apply no plan
        is built: the layers read ``g``'s edge packings, whose device
        tables the ops memoise."""
        hit = self._plan_cache.get(id(g))
        if hit is not None and hit[0] is g:
            return hit[1]
        pg = g
        if self._with_plan:
            plan = sharded_plan_of(g, self.cfg.n_shards) \
                if self.cfg.n_shards > 1 \
                else relation_plan_of(g, self.cfg.dense_threshold)
            pg = dataclasses.replace(g, plan=plan)
        pg = pg.to(self.device)
        self._plan_cache[id(g)] = (g, pg)
        return pg

    def _collate(self, graphs: List[CircuitGraph], device=None):
        """Collate a batch into fused, quantized arenas once and reuse it
        across epochs: (graph, cell_weight, n_real) on ``device`` (the
        trainer's by default)."""
        dev = self.device if device is None else device
        key = (tuple(id(g) for g in graphs), str(dev))
        hit = self._batch_cache.get(key)
        if hit is not None and all(a is b for a, b in zip(hit[0], graphs)):
            return hit[1]
        batch = collate_graphs(graphs, with_plan=self._with_plan, device=dev)
        entry = (batch.graph, batch.cell_weight, batch.n_real)
        self._batch_cache[key] = (tuple(graphs), entry)
        return entry

    def _step(self, grads_of, recompute_of=lambda: 0.0) -> tuple:
        """One optimizer step -> (loss, ok): ``grads_of()`` gives the
        step's loss and the gradients of ``self.params``; they are applied
        by AdamW when all are finite.  ``recompute_of()`` is the step's
        recompute estimate (ms)."""
        if self.chaos is not None:
            self.chaos.stall("straggler")
        t0 = time.perf_counter()
        loss, grads = grads_of()
        ok = bool(torch.stack([torch.isfinite(g).all() for g in grads]).all())
        if ok:
            adamw_update(self.params, grads, self.opt_state,
                         self.lr(self.opt_state.step),
                         weight_decay=self.cfg.weight_decay)
        loss = float(loss)                   # device barrier ends the step
        self._tick(time.perf_counter() - t0, recompute_of())
        if not ok:
            self._c_nonfinite.inc()
            if self._rec.enabled:
                self._rec.instant("train", "nonfinite_grads_skip",
                                  step=self._global_step)
        self.step_loss.append(loss if ok else float("nan"))
        return loss, ok

    def _model_step(self, loss_of, key) -> tuple:
        """:meth:`_step` on the model's loss ``loss_of()``; ``key`` is the
        step's input (the recompute estimate's cache key)."""
        return self._step(lambda: _grads(self.model, loss_of),
                          lambda: self._recompute_ms(loss_of, key))

    def _replica(self, slot: int, device: torch.device) -> DRCircuitGNN:
        """Ring slot ``slot``'s replica of the model on ``device``, its
        parameters copied from the master's."""
        rep = self._replicas.get(slot)
        if rep is None or rep.device != device:
            rep = copy.deepcopy(self.model).to(device)
            self._replicas[slot] = rep
        with torch.no_grad():
            for r, p in zip(rep.parameters(), self.params):
                r.copy_(p)
        return rep

    def _dp_grads(self, graphs: List[CircuitGraph], ring: DeviceRing):
        """One data-parallel step's loss and gradients: the members dealt
        round-robin to the ring's slots, each slot's members collated on
        its device and its loss and backward run on its replica, the
        slots' gradients combined on slot 0 as their member-count-weighted
        mean (the batched step's gradient over the same members) and
        brought to the master's device."""
        n_dev = min(len(ring), len(graphs))
        losses, grads, weights = [], [], []
        for d in range(n_dev):
            dev = ring.devices[d]
            graph, cell_w, n_real = self._collate(graphs[d::n_dev], device=dev)
            rep = self._replica(d, dev)
            loss, g = _grads(rep, lambda: batched_loss_fn(
                rep, graph, cell_w, self.mp_cfg, self.spec))
            losses.append(loss)
            grads.append(g)
            weights.append(n_real)
        total = sum(weights)
        dev0 = ring.devices[0]
        mean = [sum((w / total) * g.to(dev0) for w, g in zip(weights, gs))
                .to(self.device) for gs in zip(*grads)]
        return np.average([float(x) for x in losses], weights=weights), mean

    def train_epoch(self, graphs: List[CircuitGraph],
                    batch_size: Optional[int] = None, devices=None) -> float:
        """One epoch: one step per graph, or with ``batch_size > 1`` one
        step per block-diagonal batch of consecutive graphs (gradient = the
        mean of the members' losses).  Returns the mean loss of the steps
        taken (member-weighted for batches).

        ``devices`` (a sequence of devices, or True for every visible card,
        or the CPU for a CPU trainer) makes each batch a data-parallel step
        over a :class:`DeviceRing` of them (:meth:`_dp_grads`); a ring of
        one slot, or a batch of one graph, takes the batched step."""
        b = self.cfg.batch_size if batch_size is None else batch_size
        ring = None
        if devices is not None:
            ring = DeviceRing(batch_devices(self.device) if devices is True
                              else [resolve_device(d) for d in devices])
        losses, weights = [], []
        if b <= 1:
            for g in graphs:
                pg = self._planned(g)
                loss, ok = self._model_step(
                    lambda: loss_fn(self.model, pg, self.mp_cfg, self.spec),
                    pg)
                if ok:
                    losses.append(loss)
                    weights.append(1)
        else:
            for i in range(0, len(graphs), b):
                chunk = graphs[i:i + b]
                if ring is not None and len(ring) > 1 and len(chunk) > 1:
                    loss, ok = self._step(
                        lambda: self._dp_grads(chunk, ring))
                    n_real = len(chunk)
                else:
                    graph, cell_w, n_real = self._collate(chunk)
                    loss, ok = self._model_step(lambda: batched_loss_fn(
                        self.model, graph, cell_w, self.mp_cfg, self.spec),
                        graph)
                if ok:
                    losses.append(loss)
                    weights.append(n_real)
        return float(np.average(losses, weights=weights)) if losses \
            else float("nan")

    def profile_k(self, graphs: List[CircuitGraph]) -> Dict[str, int]:
        """The paper's preprocessing profiler (Sec. 4.3): the cost-model
        optimal K per source node type from the graphs' degrees (distinct
        neighbours of each non-empty destination row, over every edge type
        the type feeds), capped at ``hidden``; the trainer then steps with
        those K's."""
        deg_by_src = {"cell": [], "net": []}
        for g in graphs:
            for et, es in g.edges.items():
                dst, src, _w = ell_to_coo(es.adj)
                pairs = np.unique(dst * es.adj.n_src + src)
                deg = np.bincount(pairs // es.adj.n_src,
                                  minlength=es.adj.n_dst)
                deg_by_src[EDGE_SCHEMA[et][0]].append(deg[deg > 0])
        ks = {t: min(profile_optimal_k(np.concatenate(d), self.cfg.hidden),
                     self.cfg.hidden)
              for t, d in deg_by_src.items()}
        self.mp_cfg = dataclasses.replace(self.mp_cfg, k_cell=ks["cell"],
                                          k_net=ks["net"])
        # whether a plan is built depends on k, so cached graphs go
        self._with_plan = plan_applicable(self.mp_cfg, self.cfg.hidden)
        self._plan_cache.clear()
        self._batch_cache.clear()
        self._fwd_time_cache.clear()
        return ks

    def fit(self, train_graphs: List[CircuitGraph],
            eval_graphs: Optional[List[CircuitGraph]] = None,
            log_every: int = 1) -> Dict:
        if self.cfg.auto_k:
            ks = self.profile_k(train_graphs)
            print(f"[profile] optimal K per node type: {ks}")
        history = []
        t0 = time.perf_counter()
        for ep in range(self.cfg.epochs):
            loss = self.train_epoch(train_graphs)
            rec = {"epoch": ep, "loss": loss,
                   "wall_s": time.perf_counter() - t0}
            if eval_graphs is not None and (ep + 1) % log_every == 0:
                rec.update(self.evaluate(eval_graphs))
            history.append(rec)
        return {"history": history, "final": history[-1]}

    @torch.no_grad()
    def evaluate(self, graphs: List[CircuitGraph]) -> Dict[str, float]:
        preds, labels = [], []
        for g in graphs:
            pred = self.model(self._planned(g), self.mp_cfg, self.spec)
            preds.append(pred.cpu().numpy())
            labels.append(g.y_cell.cpu().numpy())
        return M.all_metrics(np.concatenate(preds), np.concatenate(labels))
