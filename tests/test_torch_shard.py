"""PyTorch port, sharded plans and data-parallel steps, against the JAX
package on the same numpy inputs.

* ``shard_relation_plan``: the reference's slab sizes, halo tables,
  ``full_arena_bytes`` and every shard's forward and transposed arena,
  table for table, at 1-4 shards, on a synthetic partition, a skewed hub
  graph (one source row every shard reads), a single-relation plan and a
  collated batch with a filler member; the ``arena.halo_*`` /
  ``arena.shard_bytes`` gauges equal the reference's.
* ``ops.drspmm_multi_sharded`` (the kernels' plain versions on the CPU):
  outputs and per-type gradients against the reference's single-device
  ``drspmm_multi`` (``jax.vjp``), and on a dense operand against the
  reference's numpy oracles ``reference_forward`` / ``reference_backward``.
* ``HeteroMPConfig(n_shards=2)`` in the model and ``CircuitTrainConfig(
  n_shards=2)`` against the reference's unsharded model and trainer.
* ``train_epoch(devices=[...])`` against the reference's batched epoch;
  a one-slot ring is the batched step; a poisoned member skips the whole
  combined update.

Tolerances: the sharded paths add in another order than the plan (each
shard re-packs its rows), so they are held to the reference's own sharded
tolerance, 2e-5 relative (``close``, as ``tests/test_sharded_parity.py``);
data-parallel steps to 1e-5 (``assert_close``); tables are exact."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.graphs.circuit as jcircuit
import repro.graphs.collate as jcollate
import repro.graphs.ell as jell
import repro.graphs.generator as jgen
from repro.core.hetero_mp import HeteroMPConfig as JConfig
from repro.kernels import ops as jops
from repro.models.hgnn import init_drcircuitgnn
from repro.models.hgnn import loss_fn as j_loss_fn
from repro.obs.metrics import MetricsRegistry as JRegistry
from repro.sharding import plan_shard as jshard
from repro.train import circuit_trainer as jtrainer
import repro_torch.graphs.circuit as tcircuit
import repro_torch.graphs.collate as tcollate
import repro_torch.graphs.ell as tell
import repro_torch.graphs.generator as tgen
from repro_torch.core.hetero_mp import HeteroMPConfig
from repro_torch.kernels import ops as tops
from repro_torch.models.backbone import BackboneSpec
from repro_torch.models.hgnn import DRCircuitGNN, loss_fn
from repro_torch.obs.metrics import DEFAULT_REGISTRY
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.sharding import plan_shard as tshard
from repro_torch.sharding.specs import shard_devices
from repro_torch.train.circuit_trainer import (CircuitTrainConfig,
                                               CircuitTrainer)
from _torch_port import (HIDDEN, K, LAYERS, SCALE, assert_close,
                         assert_fused_equal)

SHARDS = (1, 2, 3, 4)
CASES = ("medium", "hub", "single", "collated")


def close(a, r, msg="", tol=2e-5):
    """The reference's sharded tolerance (tests/test_sharded_parity.py)."""
    a, r = np.asarray(a), np.asarray(r)
    atol = tol * max(1.0, float(np.abs(r).max()) if r.size else 1.0)
    np.testing.assert_allclose(a, r, atol=atol, rtol=tol, err_msg=msg)


def _partition(gen, n_cell, n_net, seed):
    coo, xc, xn, y = gen.generate_partition(np.random.default_rng(seed),
                                            n_cell, n_net)
    return gen.pack_graph_parallel(coo, n_cell, n_net, xc, xn, y)


def _hub_relations(rng, n_cell):
    """``near`` where cell 0 feeds every cell, plus random edges."""
    dst = np.concatenate([np.arange(n_cell), rng.integers(0, n_cell, 64)])
    src = np.concatenate([np.zeros(n_cell, np.int64),
                          rng.integers(0, n_cell, 64)])
    pairs = np.unique(np.stack([dst, src], 1), axis=0)
    w = rng.normal(size=pairs.shape[0]).astype(np.float32)
    w[w == 0] = 1.0
    return [("near", "cell", "cell", pairs[:, 0], pairs[:, 1], w)]


def _single_relations(rng):
    tp = np.unique(np.stack([rng.integers(0, 40, 120),
                             rng.integers(0, 64, 120)], 1), axis=0)
    w = rng.normal(size=tp.shape[0]).astype(np.float32)
    w[w == 0] = 1.0
    return [("pinned", "net", "cell", tp[:, 0], tp[:, 1], w)]


_PLANS = {}


def _plans(case):
    """(reference host plan, port host plan) of ``case``, built from the
    same numpy inputs (memoised: the plans and their ids stay alive)."""
    if case in _PLANS:
        return _PLANS[case]
    if case == "medium":
        pair = (jcircuit.relation_plan_of(_partition(jgen, 120, 60, 0)),
                tcircuit.relation_plan_of(_partition(tgen, 120, 60, 0)))
    elif case in ("hub", "single"):
        rels = _hub_relations(np.random.default_rng(2), 96) \
            if case == "hub" else _single_relations(np.random.default_rng(3))
        n_of = {"cell": 96, "net": 12} if case == "hub" \
            else {"cell": 40, "net": 64}
        pair = (jell.build_relation_plan(rels, n_of),
                tell.build_relation_plan(rels, n_of))
    else:
        jm = [_partition(jgen, 60, 30, 0), _partition(jgen, 37, 20, 2)]
        tm = [_partition(tgen, 60, 30, 0), _partition(tgen, 37, 20, 2)]
        pair = (jcollate.collate_graphs(jm + [jm[-1]], n_real=2).graph.plan,
                tcollate.collate_graphs(tm + [tm[-1]], n_real=2,
                                        device="cpu").graph.plan)
    _PLANS[case] = pair
    return pair


def _shards(case, n):
    jp, tp = _plans(case)
    return (jshard.shard_relation_plan(jp, n, registry=JRegistry()),
            tshard.shard_relation_plan(tp, n, registry=MetricsRegistry()))


def _operands(plan, seed=0, dim=HIDDEN, k=K):
    """Per-type CBSR operands as numpy, one entry per type of the plan's
    size table (an unread type included)."""
    rng = np.random.default_rng(seed)
    out = {}
    for t, n in zip(plan.src_types, plan.src_sizes):
        x = rng.normal(size=(n, dim)).astype(np.float32)
        idx = np.sort(np.argsort(-x, axis=1, kind="stable")[:, :k],
                      axis=1).astype(np.int32)
        out[t] = (np.take_along_axis(x, idx, axis=1), idx)
    return out


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("case", CASES)
def test_shard_tables_match_reference(case, n):
    js, ts = _shards(case, n)
    for f in ("n_shards", "src_slab", "out_slab", "halo_pad", "n_src_total",
              "n_out_total", "row_block", "fwd_chunk", "bwd_chunk",
              "full_arena_bytes", "src_types", "src_off", "src_sizes",
              "local_src"):
        assert getattr(ts, f) == getattr(js, f), f
    assert [dataclasses.astuple(s) for s in ts.segments] == \
        [dataclasses.astuple(s) for s in js.segments]
    for f in ("send_idx", "halo_rows"):
        a, b = np.asarray(getattr(js, f)), getattr(ts, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for d in range(n):
        assert_fused_equal(js.local_fwd(d), ts.local_fwd(d))
        assert_fused_equal(js.local_bwd(d), ts.local_bwd(d))
        assert ts.shard_bytes(d) == js.shard_bytes(d)
    assert ts.halo_stats() == js.halo_stats()
    assert all(f.rel is None and f.blk_end is not None for f in ts.fwd)


@pytest.mark.parametrize("case", CASES)
def test_halo_gauges_match_reference(case):
    jp, tp = _plans(case)
    jr, tr = JRegistry(), MetricsRegistry()
    jshard.shard_relation_plan(jp, 3, registry=jr)
    tshard.shard_relation_plan(tp, 3, registry=tr)
    assert tr.snapshot() == jr.snapshot()
    assert set(tr.series("arena.halo_rows")) >= {(("shard", "0"),)}


@pytest.mark.parametrize("n", SHARDS)
@pytest.mark.parametrize("case", CASES)
def test_sharded_executor_matches_reference(case, n):
    """Forward and per-type gradients (``jax.vjp`` of the reference's
    single-device plan path under a seeded cotangent)."""
    jp, tp = _plans(case)
    _, ts = _shards(case, n)
    ops_ = _operands(tp, seed=n)
    types = list(ops_)
    rng = np.random.default_rng(7)
    gys = [rng.normal(size=(s.n_dst, HIDDEN)).astype(np.float32)
           for s in tp.segments]

    def jfn(*vals):
        ys = jops.drspmm_multi(jp, {t: (v, jnp.asarray(ops_[t][1]))
                                    for t, v in zip(types, vals)}, HIDDEN)
        return tuple(ys[s.etype] for s in jp.segments)

    jy, vjp = jax.vjp(jfn, *(jnp.asarray(ops_[t][0]) for t in types))
    jg = vjp(tuple(jnp.asarray(g) for g in gys))

    vals = [torch.tensor(ops_[t][0], requires_grad=True) for t in types]
    ys = tops.drspmm_multi_sharded(
        ts.to("cpu"), {t: (v, torch.from_numpy(ops_[t][1]))
                       for t, v in zip(types, vals)}, HIDDEN)
    ty = [ys[s.etype] for s in tp.segments]
    tg = torch.autograd.grad(ty, vals, [torch.from_numpy(g) for g in gys],
                             allow_unused=True)
    for s, a, r in zip(tp.segments, ty, jy):
        close(a.detach(), r, f"forward {s.etype}")
    for t, a, r in zip(types, tg, jg):
        close(torch.zeros_like(vals[0]) if a is None else a, r, f"grad {t}")


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("case", CASES)
def test_sharded_executor_matches_numpy_oracle(case, n):
    """On a dense operand (k = dim, columns in order) the executor is
    y = A @ x and dx = Aᵀ @ gy, the reference's numpy re-enactments of
    the exchange."""
    _, tp = _plans(case)
    js, ts = _shards(case, n)
    dim = 12
    rng = np.random.default_rng(n)
    x = rng.normal(size=(tp.n_src_total, dim)).astype(np.float32)
    gy = rng.normal(size=(tp.n_out_total, dim)).astype(np.float32)
    iota = torch.arange(dim, dtype=torch.int32)
    vals = [torch.tensor(x[o:o + sz], requires_grad=True)
            for o, sz in zip(tp.src_off, tp.src_sizes)]
    ys = tops.drspmm_multi_sharded(
        ts.to(["cpu"] * n),
        {t: (v, iota.expand(v.shape[0], dim).contiguous())
         for t, v in zip(tp.src_types, vals)}, dim)
    y = torch.cat([ys[s.etype] for s in tp.segments])
    y.backward(torch.from_numpy(gy))
    close(y.detach(), jshard.reference_forward(js, x), "forward")
    close(torch.cat([v.grad for v in vals]),
          jshard.reference_backward(js, gy), "backward")
    close(tshard.reference_forward(ts, x), jshard.reference_forward(js, x))
    close(tshard.reference_backward(ts, gy),
          jshard.reference_backward(js, gy))


def test_hub_row_halos_every_other_shard():
    """The hub row (cell 0, owned by shard 0) sits in each other shard's
    halo once; its padded slots send row 0 and add back exact zeros."""
    _, ts = _shards("hub", 4)
    for d in range(1, 4):
        assert int((ts.halo_rows[d] == 0).sum()) == 1, d
    assert (ts.send_idx[:, :, 1:] >= 0).all()


def test_sharded_dispatch_counted():
    _, ts = _shards("medium", 2)
    _, tp = _plans("medium")
    ops_ = _operands(tp)
    vals = {t: torch.tensor(v, requires_grad=True) for t, (v, _) in
            ops_.items()}
    before = {k: DEFAULT_REGISTRY.value("ops.dispatch", family="cpu_fused",
                                        kind=k)
              for k in ("shard_fwd", "shard_bwd", "multi_fwd")}
    ys = tops.drspmm_multi_sharded(
        ts.to("cpu"), {t: (vals[t], torch.from_numpy(i))
                       for t, (_, i) in ops_.items()}, HIDDEN,
        backend="bucket")
    sum(y.sum() for y in ys.values()).backward()
    after = {k: DEFAULT_REGISTRY.value("ops.dispatch", family="cpu_fused",
                                       kind=k) for k in before}
    assert {k: after[k] - before[k] for k in before} == \
        {"shard_fwd": 1, "shard_bwd": 1, "multi_fwd": 0}


def test_unplaced_plan_and_devices():
    _, ts = _shards("medium", 2)
    with pytest.raises(ValueError, match="place"):
        tops.drspmm_multi_sharded(ts, {}, HIDDEN)
    with pytest.raises(ValueError, match="devices for"):
        ts.to(["cpu"] * 3)
    assert shard_devices(3, "cpu") == (torch.device("cpu"),) * 3
    placed = ts.to("cpu")
    assert placed.to("cpu") is placed
    assert all(s.shape == (2, ts.halo_pad) for s in placed.send)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            shard_devices(2, "cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ts.to("cuda")


def test_shard_devices_refuses_a_card_not_visible(monkeypatch):
    """On a one-card host, shard 0 cannot sit on ``cuda:3``: the shards
    would silently cycle onto ``cuda:0`` instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert shard_devices(2, "cuda:0") == (torch.device("cuda", 0),) * 2
    with pytest.raises(RuntimeError, match="only 1 CUDA device"):
        shard_devices(2, "cuda:3")


def _claiming(placed, device):
    """``placed`` with its shards said to sit on ``device`` (its tables
    stay where they are): a plan placed elsewhere than its operands."""
    return dataclasses.replace(
        placed, devices=(torch.device(device),) * placed.n_shards)


def test_sharded_executor_refuses_shards_off_the_operands_device():
    _, ts = _shards("medium", 2)
    _, tp = _plans("medium")
    cbsr = {t: (torch.from_numpy(v), torch.from_numpy(i))
            for t, (v, i) in _operands(tp).items()}
    placed = ts.to("cpu")
    with pytest.raises(ValueError, match="operands on cpu"):
        tops.drspmm_multi_sharded(_claiming(placed, "cuda:0"), cbsr, HIDDEN)
    mixed = dataclasses.replace(placed, devices=(torch.device("cpu"),
                                                 torch.device("cuda", 0)))
    with pytest.raises(ValueError, match="operands on cpu"):
        tops.drspmm_multi_sharded(mixed, cbsr, HIDDEN)


def test_model_replaces_a_sharded_plan_placed_elsewhere():
    """A graph carrying a sharded plan whose shards are not
    ``shard_devices(n, model.device)`` runs on the model's own devices,
    with the output of the plan placed there in the first place."""
    g = _partition(tgen, 48, 24, 7)
    sp = tcircuit.sharded_plan_of(g, 2)
    model = DRCircuitGNN(g.x_cell.shape[1], g.x_net.shape[1], HIDDEN,
                         LAYERS, device="cpu")
    cfg = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K, n_shards=2)
    elsewhere = dataclasses.replace(g, plan=_claiming(sp.to("cpu"),
                                                      "cuda:0"))
    with torch.no_grad():
        want = model(dataclasses.replace(g, plan=sp.to("cpu")), cfg)
        got = model(elsewhere, cfg)
    assert torch.equal(got, want)


def test_sharded_plan_memoized_and_attachable():
    g = _partition(tgen, 48, 24, 7)
    sp = tcircuit.sharded_plan_of(g, 2)
    assert tcircuit.sharded_plan_of(g, 2) is sp
    assert tcircuit.sharded_plan_of(g, 3) is not sp
    pg = tcircuit.with_sharded_plan(g, 2)
    assert pg.plan is sp
    assert tcircuit.with_sharded_plan(pg, 2) is pg
    # another shard count re-partitions the graph's relation plan
    assert tcircuit.with_sharded_plan(pg, 3).plan.n_shards == 3
    assert tcircuit.relation_plan_of(g) is tcircuit.relation_plan_of(g)
    # the unsharded accessor never hands back an attached sharded plan
    assert isinstance(tcircuit.relation_plan_of(pg), tell.RelationPlan)
    moved = pg.to("cpu")
    assert moved.plan.devices == (torch.device("cpu"),) * 2


@pytest.fixture(scope="module")
def designs():
    return (jgen.generate_design(0, "small", SCALE)
            + jgen.generate_design(1, "medium", SCALE),
            tgen.generate_design(0, "small", SCALE)
            + tgen.generate_design(1, "medium", SCALE))


@pytest.fixture(scope="module")
def params():
    return init_drcircuitgnn(jax.random.PRNGKey(0), 16, 16, HIDDEN, LAYERS)


def _port_model(p):
    return DRCircuitGNN.from_jax_params(jax.tree.map(np.asarray, p),
                                        device="cpu")


def _flat(p):
    out = {n: np.asarray(getattr(p, n))
           for n in ("in_cell", "in_net", "head_w", "head_b")}
    for i, lp in enumerate(p.layers):
        for f in lp._fields:
            out[f"layers.{i}.{f}"] = np.asarray(getattr(lp, f))
    return out


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("n", [2, 3])
def test_sharded_model_matches_reference(params, designs, n, remat):
    """``HeteroMPConfig(n_shards=n)`` against the reference's unsharded
    loss and ``jax.grad``: the scale-0.02 plan is mixed-tier, its sharded
    plan all arena.  Remat is dropped on the sharded path."""
    jcfg = JConfig(hidden=HIDDEN, k_cell=K, k_net=K)
    tcfg = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K, n_shards=n)
    lj, gj = jax.value_and_grad(j_loss_fn)(params, designs[0][2], jcfg)
    model = _port_model(params)
    spec = BackboneSpec(depth=LAYERS, hidden=HIDDEN, remat=remat)
    lt = loss_fn(model, designs[1][2], tcfg, spec)
    close(lt.item(), float(lj), "loss")
    lt.backward()
    for name, r in _flat(gj).items():
        p = dict(model.named_parameters())[name]
        close(torch.zeros_like(p) if p.grad is None else p.grad, r, name)


def test_sharded_trainer_matches_reference(designs):
    """Two epochs over three graphs: per-epoch losses and final parameters
    within 2e-5 of the reference's single-device trainer."""
    kw = dict(hidden=HIDDEN, k_cell=K, k_net=K, lr=1e-3, epochs=1)
    jt = jtrainer.CircuitTrainer(jtrainer.CircuitTrainConfig(**kw), 16, 16)
    tt = CircuitTrainer(CircuitTrainConfig(**kw, n_shards=2), 16, 16,
                        model=_port_model(jt.params), device="cpu")
    gj, gt = designs[0][:3], designs[1][:3]
    for _ in range(2):
        close(tt.train_epoch(gt), jt.train_epoch(gj), "epoch loss")
    assert tt.opt_state.step == int(jt.opt_state.step) == 6
    plan = tt._planned(gt[0]).plan
    assert isinstance(plan, tshard.ShardedRelationPlan)
    assert plan.devices == (torch.device("cpu"),) * 2
    for name, r in _flat(jt.params).items():
        close(dict(tt.model.named_parameters())[name].detach(), r, name)


def test_dp_epoch_matches_reference(designs):
    """``train_epoch(batch_size=4, devices=[cpu, cpu])`` against the
    reference's batched epoch (batches of 4 and 1 over five graphs), two
    epochs: losses and parameters within 1e-5."""
    kw = dict(hidden=HIDDEN, k_cell=K, k_net=K, lr=1e-3, epochs=1)
    jt = jtrainer.CircuitTrainer(jtrainer.CircuitTrainConfig(**kw), 16, 16)
    tt = CircuitTrainer(CircuitTrainConfig(**kw), 16, 16,
                        model=_port_model(jt.params), device="cpu")
    gj, gt = designs
    for _ in range(2):
        assert_close(tt.train_epoch(gt, batch_size=4, devices=["cpu", "cpu"]),
                     jt.train_epoch(gj, batch_size=4))
    assert tt.opt_state.step == int(jt.opt_state.step) == 4
    assert tt.stats()["steps"] == 4 and len(tt._replicas) == 2
    for name, r in _flat(jt.params).items():
        assert_close(dict(tt.model.named_parameters())[name].detach(), r,
                     name)


@pytest.mark.parametrize("devices", [["cpu"], True], ids=["one", "all"])
def test_dp_one_slot_is_batched_step(designs, devices):
    """A ring of one slot (a list of one, or every device of a CPU
    trainer) takes the ordinary batched step: the same bits."""
    cfg = CircuitTrainConfig(hidden=HIDDEN, k_cell=K, k_net=K, lr=1e-3)
    a, b = (CircuitTrainer(cfg, 16, 16, device="cpu") for _ in range(2))
    la = a.train_epoch(designs[1][:4], batch_size=2, devices=devices)
    lb = b.train_epoch(designs[1][:4], batch_size=2)
    assert la == lb and not a._replicas
    for p, q in zip(a.params, b.params):
        assert torch.equal(p, q)


def test_dp_poisoned_member_skips_combined_update(designs):
    tt = CircuitTrainer(CircuitTrainConfig(hidden=HIDDEN, k_cell=K, k_net=K,
                                           lr=1e-3), 16, 16, device="cpu")
    gs = list(designs[1][:4])
    gs[3] = dataclasses.replace(gs[3], y_cell=gs[3].y_cell.clone())
    gs[3].y_cell[0] = float("nan")
    before = [p.detach().clone() for p in tt.params]
    assert np.isnan(tt.train_epoch(gs, batch_size=4, devices=["cpu"] * 3))
    assert tt.nonfinite_grad_steps == 1 and tt.opt_state.step == 0
    assert tt.stats()["steps"] == 1 and np.isnan(tt.step_loss[-1])
    for a, b in zip(before, tt.params):
        assert torch.equal(a, b.detach())
    # the clean members alone step
    assert np.isfinite(tt.train_epoch(gs[:3], batch_size=4,
                                      devices=["cpu"] * 3))
    assert tt.opt_state.step == 1
