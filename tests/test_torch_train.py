"""PyTorch port, training: model gradients, remat, AdamW, schedules,
collation weights, metrics and the trainer against the JAX package, with
the same weights carried over by ``from_jax_params`` and the same inputs
made with numpy.

Tolerances: gradients and losses are fp32 with another summation order
than the reference (``assert_close``: rtol 1e-5, atol 1e-5 scaled by the
reference's magnitude); identical inputs keep the D-ReLU masks identical.
Remat must reproduce the gradients bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.graphs.collate as jcollate
import repro.graphs.generator as jgen
import repro.optim as joptim
from repro.core.hetero_mp import HeteroMPConfig as JConfig
from repro.models.backbone import BackboneSpec as JSpec
from repro.models.hgnn import batched_loss_fn as j_batched_loss_fn
from repro.models.hgnn import init_drcircuitgnn
from repro.models.hgnn import loss_fn as j_loss_fn
from repro.train import circuit_trainer as jtrainer
from repro.train import metrics as jmetrics
import repro_torch.graphs.generator as tgen
from repro_torch.core.hetero_mp import HeteroMPConfig
from repro_torch.graphs.collate import collate_graphs
from repro_torch.models.backbone import BackboneSpec
from repro_torch.models.hgnn import DRCircuitGNN, batched_loss_fn, loss_fn
from repro_torch.optim import schedules
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.train import metrics as tmetrics
from repro_torch.train.circuit_trainer import (CircuitTrainConfig,
                                               CircuitTrainer)
from _torch_port import HIDDEN, K, LAYERS, SCALE, assert_close

JAX_BACKEND = {"topk": "topk", "bisect": "pallas"}


@pytest.fixture(scope="module")
def params():
    return init_drcircuitgnn(jax.random.PRNGKey(0), 16, 16, HIDDEN, LAYERS)


@pytest.fixture(scope="module")
def designs():
    return (jgen.generate_design(0, "small", SCALE)
            + jgen.generate_design(1, "medium", SCALE),
            tgen.generate_design(0, "small", SCALE)
            + tgen.generate_design(1, "medium", SCALE))


def _port_model(params):
    return DRCircuitGNN.from_jax_params(jax.tree.map(np.asarray, params),
                                        device="cpu")


def _flat(p):
    """Reference parameter tree -> {port parameter name: numpy array}."""
    out = {n: np.asarray(getattr(p, n))
           for n in ("in_cell", "in_net", "head_w", "head_b")}
    for i, lp in enumerate(p.layers):
        for f in lp._fields:
            out[f"layers.{i}.{f}"] = np.asarray(getattr(lp, f))
    return out


def _port_grads(model, loss):
    model.zero_grad(set_to_none=True)
    loss.backward()
    # the last layer's net-side weights feed nothing: no gradient (JAX: 0)
    return {n: torch.zeros_like(p) if p.grad is None else p.grad.clone()
            for n, p in model.named_parameters()}


def _assert_tree_close(port: dict, ref: dict):
    assert set(port) == set(ref)
    for n, r in ref.items():
        assert_close(np.asarray(port[n]), r, n)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("drelu_backend", ["topk", "bisect"])
@pytest.mark.parametrize("batched", [False, True], ids=["graph", "batch"])
def test_model_grads_match_jax(params, designs, batched, drelu_backend,
                               remat):
    """``jax.grad`` of the reference loss against ``loss.backward()``.
    Scale-0.02 plans are mixed-tier (``near`` in the arena, ``pin`` and
    ``pinned`` dense), so both backward kernels' plain versions run."""
    jcfg = JConfig(hidden=HIDDEN, k_cell=K, k_net=K,
                   drelu_backend=JAX_BACKEND[drelu_backend])
    tcfg = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K,
                          drelu_backend=drelu_backend)
    jspec = JSpec(depth=LAYERS, hidden=HIDDEN, remat=remat)
    tspec = BackboneSpec(depth=LAYERS, hidden=HIDDEN, remat=remat)
    model = _port_model(params)
    if batched:
        jb = jcollate.collate_graphs(designs[0][1:3])
        tb = collate_graphs(designs[1][1:3], device="cpu")
        assert tb.plan.has_arena and tb.plan.has_dense
        lj, gj = jax.value_and_grad(j_batched_loss_fn)(
            params, jb.graph, jb.cell_weight, jcfg, jspec)
        lt = batched_loss_fn(model, tb.graph, tb.cell_weight, tcfg, tspec)
    else:
        lj, gj = jax.value_and_grad(j_loss_fn)(params, designs[0][2], jcfg,
                                               jspec)
        lt = loss_fn(model, designs[1][2], tcfg, tspec)
    assert_close(lt.item(), float(lj))
    _assert_tree_close(_port_grads(model, lt), _flat(gj))


@pytest.mark.parametrize("drelu_backend", ["topk", "bisect"])
def test_remat_grads_bit_identical(params, designs, drelu_backend):
    tcfg = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K,
                          drelu_backend=drelu_backend)
    model = _port_model(params)
    batch = collate_graphs(designs[1][:2], device="cpu")
    grads = []
    for remat in (False, True):
        spec = BackboneSpec(depth=LAYERS, hidden=HIDDEN, wiring="residual",
                            remat=remat)
        grads.append(_port_grads(model, batched_loss_fn(
            model, batch.graph, batch.cell_weight, tcfg, spec)))
    for n in grads[0]:
        assert torch.equal(grads[0][n], grads[1][n]), n


@pytest.mark.parametrize("n_real", [None, 1])
def test_cell_weight_matches_reference(designs, n_real):
    """Exact-size collation: the reference's unquantized weights, filler
    members (after ``n_real``) weighted 0."""
    jb = jcollate.collate_graphs(designs[0][:3], quantize=False,
                                 n_real=n_real)
    tb = collate_graphs(designs[1][:3], quantize=False, n_real=n_real,
                        device="cpu")
    assert tb.n_real == jb.n_real
    np.testing.assert_array_equal(tb.cell_weight.numpy(),
                                  np.asarray(jb.cell_weight))
    assert np.isclose(tb.cell_weight.sum().item(), 1.0, rtol=1e-6)


def test_collate_rejects_bad_n_real(designs):
    with pytest.raises(ValueError, match="n_real"):
        collate_graphs(designs[1][:2], n_real=3, device="cpu")


@pytest.mark.parametrize("clip,wd", [(0.0, 0.0), (0.5, 1e-2)])
def test_adamw_matches_reference(clip, wd):
    """Six steps, the third with a non-finite gradient skipped on both
    sides (the trainer's no-op: nothing moves, the counter included)."""
    rng = np.random.default_rng(5)
    shapes = [(7, 3), (3,), (4, 4)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jp = [jnp.asarray(p) for p in p0]
    jst = joptim.adamw_init(jp)
    tp = [torch.from_numpy(p.copy()) for p in p0]
    tst = adamw_init(tp)
    lr = joptim.cosine(1e-2, 6, warmup=2)
    for step in range(6):
        grads = [rng.normal(size=s).astype(np.float32) for s in shapes]
        if step == 2:
            grads[1][0] = np.nan
            assert not all(np.isfinite(g).all() for g in grads)
            continue
        jp, jst = joptim.adamw_update(jp, [jnp.asarray(g) for g in grads],
                                      jst, lr(jst.step), weight_decay=wd,
                                      grad_clip=clip)
        adamw_update(tp, [torch.from_numpy(g) for g in grads], tst,
                     float(lr(jnp.asarray(tst.step))), weight_decay=wd,
                     grad_clip=clip)
        assert tst.step == int(jst.step)
    assert tst.step == 5
    for a, b in zip(tp, jp):
        assert_close(a.numpy(), np.asarray(b))
    for a, b in zip(tst.m + tst.v, list(jst.m) + list(jst.v)):
        assert_close(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)), ("cosine", (1e-3, 40, 5)), ("wsd", (1e-3, 40))])
def test_schedules_match_reference(name, args):
    ref = getattr(joptim, name)(*args)
    port = getattr(schedules, name)(*args)
    for step in range(45):
        assert_close(port(step), float(ref(jnp.asarray(step, jnp.int32))))


def test_metrics_match_reference():
    rng = np.random.default_rng(2)
    pred = rng.random(300)
    label = np.round(rng.random(300), 1)          # ties for the midranks
    for name in ("pearson", "spearman", "kendall", "mae", "rmse"):
        assert getattr(tmetrics, name)(pred, label) == \
            getattr(jmetrics, name)(pred, label), name
    assert tmetrics.all_metrics(pred, label) == \
        jmetrics.all_metrics(pred, label)
    vals = list(rng.random(9))
    assert tmetrics.median(vals) == jmetrics.median(vals)
    assert tmetrics.median(vals[:8]) == jmetrics.median(vals[:8])


@pytest.mark.parametrize("batch_size", [1, 2])
def test_trainer_matches_reference(designs, batch_size):
    """Four steps from the same weights on the same graphs: per-step losses
    and final parameters within 1e-5 relative (lr 1e-3 so the steps
    move)."""
    kw = dict(hidden=HIDDEN, k_cell=K, k_net=K, lr=1e-3, epochs=1,
              batch_size=batch_size)
    jt = jtrainer.CircuitTrainer(jtrainer.CircuitTrainConfig(**kw), 16, 16)
    tt = CircuitTrainer(CircuitTrainConfig(**kw), 16, 16,
                        model=_port_model(jt.params), device="cpu")
    gj, gt = designs
    steps = [[i] for i in range(4)] if batch_size == 1 \
        else [[0, 1], [2, 3], [0, 1], [2, 3]]
    for idx in steps:
        lj = jt.train_epoch([gj[i] for i in idx])
        lt = tt.train_epoch([gt[i] for i in idx])
        assert_close(lt, lj)
    assert tt.opt_state.step == int(jt.opt_state.step) == 4
    assert tt.stats()["steps"] == 4
    ref = _flat(jt.params)
    _assert_tree_close({n: p.detach() for n, p in
                        tt.model.named_parameters()}, ref)


def test_trainer_skips_nonfinite_step(designs):
    gt = designs[1]
    tt = CircuitTrainer(CircuitTrainConfig(hidden=HIDDEN, k_cell=K, k_net=K,
                                           lr=1e-3), 16, 16, device="cpu")
    tt.train_epoch(gt[:1])
    before = [p.detach().clone() for p in tt.params]
    moments = [m.clone() for m in tt.opt_state.m]
    bad = dataclasses.replace(gt[1], y_cell=gt[1].y_cell.clone())
    bad.y_cell[0] = float("nan")
    assert np.isnan(tt.train_epoch([bad]))
    assert tt.nonfinite_grad_steps == 1 and tt.opt_state.step == 1
    for a, b in zip(before + moments, tt.params + tt.opt_state.m):
        assert torch.equal(a, b.detach())


def test_trainer_refuses_unported_hooks(designs):
    """The chaos, monitor and registry hooks are ported (tests/
    test_torch_fault.py, test_torch_obs.py) and taken as given;
    data-parallel steps (tests/test_torch_shard.py) are ported too."""
    from repro_torch.fault import FaultInjector, StepMonitor
    from repro_torch.obs import MetricsRegistry
    reg = MetricsRegistry()
    tt = CircuitTrainer(CircuitTrainConfig(hidden=HIDDEN), 16, 16,
                        device="cpu", chaos=FaultInjector([]),
                        monitor=StepMonitor(), registry=reg)
    assert tt.metrics is reg


def test_circuitgnn_learns():
    """The port's counterpart of tests/test_system.py::
    test_circuitgnn_learns, from that test's weights (the reference
    trainer's seed-0 init).  Six epochs are init-sensitive in both
    packages, so the port starts where the reference test starts."""
    graphs = tgen.generate_design(0, "small", scale=0.04)
    model = _port_model(init_drcircuitgnn(jax.random.PRNGKey(0), 16, 16,
                                          32, 2))
    tr = CircuitTrainer(CircuitTrainConfig(epochs=6, hidden=32, k_cell=8,
                                           k_net=8), 16, 16, model=model,
                        device="cpu")
    h = tr.fit(graphs, eval_graphs=graphs)["history"]
    assert h[-1]["loss"] < h[0]["loss"]
    assert h[-1]["pearson"] > 0.15
    assert h[-1]["spearman"] > 0.15
