"""PyTorch port, the dense-SpMM baseline (``use_drelu=False``): the plain
version of the arena SpMM kernel against the JAX package's Pallas kernel
(interpret mode) and its XLA arena walk, ``ops.spmm`` (values and
gradients) against ``jax.vjp`` of the reference op, the serial
``hetero_conv``, the model, its gradients and the trainer against the
reference with ``use_drelu=False``, and ``run_fused`` against
``run_sequential``.  The CUDA kernel is held against the plain version on
a card in tests/test_torch_cuda.py.

Tolerances: fp32 with another summation order than the reference
(``assert_close``: rtol 1e-5, atol 1e-5 scaled by the reference's
magnitude); trainer losses within 1e-5 relative."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.graphs.ell as jell
import repro.graphs.generator as jgen
from repro.core.hetero_mp import HeteroMPConfig as JConfig
from repro.core.hetero_mp import hetero_conv as j_hetero_conv
from repro.kernels import drspmm as jk
from repro.kernels import ops as jops
from repro.models.hgnn import drcircuitgnn_forward, init_drcircuitgnn
from repro.models.hgnn import loss_fn as j_loss_fn
from repro.train import circuit_trainer as jtrainer
import repro_torch.graphs.ell as tell
import repro_torch.graphs.generator as tgen
from repro_torch.core import parallel
from repro_torch.core.hetero_mp import HeteroMPConfig, hetero_conv
from repro_torch.graphs.collate import collate_graphs
from repro_torch.kernels import drspmm as tk
from repro_torch.kernels import ops as tops
from repro_torch.models.hgnn import DRCircuitGNN, loss_fn
from repro_torch.serve import circuit_engine
from repro_torch.serve.circuit_engine import CircuitServeEngine
from repro_torch.train.circuit_trainer import (CircuitTrainConfig,
                                               CircuitTrainer)
from _torch_port import HIDDEN, K, LAYERS, SCALE, assert_close

ETYPES = ("near", "pin", "pinned")


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


def _features(n, seed, dim=HIDDEN):
    return np.random.default_rng(seed).normal(size=(n, dim)).astype(
        np.float32)


@pytest.mark.parametrize("etype", ETYPES)
@pytest.mark.parametrize("seed,size", [(0, "small"), (1, "medium")])
def test_spmm_arena_plain_matches_pallas(seed, size, etype):
    gj = jgen.generate_design(seed, size, SCALE)[0]
    gt = tgen.generate_design(seed, size, SCALE)[0]
    fj = jell.fuse_bucketed(gj.edges[etype].adj)
    ft = tell.fuse_bucketed(gt.edges[etype].adj)
    x = _features(ft.n_src, seed + 7)
    ref = np.asarray(jk.spmm_dense_fused(fj, jnp.asarray(x)))
    ref_x = np.asarray(jops._spmm_fused_xla(fj, jnp.asarray(x)))
    before = tk.spmm_arena.launches
    out = tk.spmm_arena(ft.to("cpu"), torch.from_numpy(x))
    assert tk.spmm_arena.launches == before          # CPU: plain version
    assert out.shape == (ft.n_arena_rows, HIDDEN)
    assert_close(out.numpy(), ref)
    assert_close(out.numpy()[ft.gather], ref_x)


@pytest.mark.parametrize("dense_oracle", [False, True])
@pytest.mark.parametrize("backend", ["xla_fused", "dense"])
@pytest.mark.parametrize("etype", ETYPES)
def test_spmm_grads_match_jax(etype, backend, dense_oracle, designs):
    """Values and the full (unsampled) gradient of the operand against
    ``jax.vjp`` of the reference op."""
    gj, gt = designs[0][1], designs[1][1]
    ej, et = gj.edges[etype], gt.edges[etype]
    x = _features(et.adj.n_src, 3)
    gy = _features(et.adj.n_dst, 4)
    y, vjp = jax.vjp(lambda v: jops.spmm(ej.adj, ej.adj_t, v,
                                         backend=backend), jnp.asarray(x))
    (gx,) = vjp(jnp.asarray(gy))
    xt = torch.from_numpy(x).requires_grad_()
    yt = tops.spmm(et.adj, et.adj_t, xt, dense=dense_oracle)
    yt.backward(torch.from_numpy(gy))
    assert_close(yt.detach().numpy(), np.asarray(y))
    assert_close(xt.grad.numpy(), np.asarray(gx))


def test_spmm_device_arena_memo(designs):
    """The fused arena of each adjacency is built and placed once."""
    adj = designs[1][0].edges["near"].adj
    a = tops.device_arena(adj, "cpu")
    assert tops.device_arena(adj, torch.device("cpu")) is a
    assert isinstance(a.nbr, torch.Tensor)


def test_hetero_conv_dense_matches(params, designs):
    """The serial loop: three ``spmm`` calls over ``graph.edges``, no
    sparsification, and the max merge."""
    gj, gt = designs[0][2], designs[1][2]
    xc, xn = _features(gt.n_cell, 1), _features(gt.n_net, 2)
    jcfg = JConfig(hidden=HIDDEN, k_cell=K, k_net=K, use_drelu=False)
    tcfg = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K, use_drelu=False)
    yj = j_hetero_conv(params.layers[0], gj, jnp.asarray(xc),
                       jnp.asarray(xn), jcfg)
    with torch.no_grad():
        yt = hetero_conv(_port_model(params).layers[0], gt,
                         torch.from_numpy(xc), torch.from_numpy(xn), tcfg)
    for a, b in zip(yj, yt):
        assert_close(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("k", [K, HIDDEN])
def test_model_dense_matches(params, designs, k):
    """Forward and gradients of the D-ReLU-off model.  With D-ReLU off,
    k is never read, so k >= hidden is accepted."""
    jcfg = JConfig(hidden=HIDDEN, k_cell=k, k_net=k, use_drelu=False)
    tcfg = HeteroMPConfig(hidden=HIDDEN, k_cell=k, k_net=k, use_drelu=False)
    model = _port_model(params)
    gj, gt = designs[0][0], designs[1][0]
    lj, grads = jax.value_and_grad(j_loss_fn)(params, gj, jcfg)
    with torch.no_grad():
        yt = model(gt, tcfg)
    assert gt.plan is None
    assert_close(yt.numpy(), np.asarray(drcircuitgnn_forward(params, gj,
                                                             jcfg)))
    model.zero_grad(set_to_none=True)
    lt = loss_fn(model, gt, tcfg)
    lt.backward()
    assert_close(lt.item(), float(lj))
    ref = {n: np.asarray(getattr(grads, n))
           for n in ("in_cell", "in_net", "head_w", "head_b")}
    for i, lp in enumerate(grads.layers):
        for f in lp._fields:
            ref[f"layers.{i}.{f}"] = np.asarray(getattr(lp, f))
    for n, p in model.named_parameters():
        g = np.zeros(p.shape, np.float32) if p.grad is None \
            else p.grad.numpy()
        assert_close(g, ref[n], n)


def test_config_rejects_large_k_only_with_drelu():
    """k >= hidden is accepted with D-ReLU on (that type stays dense on
    the serial path); an unknown backend is what the config rejects."""
    HeteroMPConfig(hidden=HIDDEN, k_cell=HIDDEN)
    HeteroMPConfig(hidden=HIDDEN, k_cell=HIDDEN, use_drelu=False)
    with pytest.raises(ValueError, match="backend"):
        HeteroMPConfig(hidden=HIDDEN, backend="nope")


def test_collate_without_plan(designs):
    batch = collate_graphs(designs[1][:2], with_plan=False, device="cpu")
    assert batch.plan is None
    assert collate_graphs(designs[1][:2], device="cpu").plan is not None


@pytest.mark.parametrize("batch_size", [1, 2])
def test_trainer_dense_matches_reference(designs, batch_size):
    """Two epochs of ``use_drelu=False`` from the same weights on the same
    graphs: every step's loss within 1e-5 relative of the JAX trainer."""
    kw = dict(hidden=HIDDEN, k_cell=K, k_net=K, lr=1e-3, epochs=2,
              batch_size=batch_size, use_drelu=False)
    jt = jtrainer.CircuitTrainer(jtrainer.CircuitTrainConfig(**kw), 16, 16)
    tt = CircuitTrainer(CircuitTrainConfig(**kw), 16, 16,
                        model=_port_model(jt.params), device="cpu")
    gj, gt = designs[0][:4], designs[1][:4]
    b = batch_size
    for ep in range(2):
        for i in range(0, len(gt), b):
            lj = jt.train_epoch(gj[i:i + b])
            lt = tt.train_epoch(gt[i:i + b])
            assert abs(lt - lj) <= 1e-5 * abs(lj), (ep, i, lt, lj)
    assert tt.opt_state.step == int(jt.opt_state.step) == 8 // b
    for pg in tt._plan_cache.values():
        assert pg[1].plan is None
    for _g, (graph, _w, _n) in tt._batch_cache.values():
        assert graph.plan is None


def test_trainer_dense_fit(designs):
    tt = CircuitTrainer(CircuitTrainConfig(hidden=HIDDEN, k_cell=K, k_net=K,
                                           epochs=2, batch_size=2,
                                           use_drelu=False), 16, 16,
                        device="cpu")
    out = tt.fit(designs[1][:4], eval_graphs=designs[1][:4])
    assert len(tt.step_loss) == 4 and np.isfinite(tt.step_loss).all()
    assert np.isfinite(out["final"]["pearson"])


def test_fused_equals_sequential(designs):
    """The three relation SpMMs of a layer run as concurrent modules give
    the same results as module by module (on the CPU both run in order;
    on a card, see tests/test_torch_cuda.py)."""
    g = designs[1][1]
    xc = torch.from_numpy(_features(g.n_cell, 5))
    xn = torch.from_numpy(_features(g.n_net, 6))
    fns = [lambda x, et=et: tops.spmm(g.edges[et].adj, g.edges[et].adj_t, x)
           for et in ETYPES]
    args = [(xc,), (xc,), (xn,)]
    fused = parallel.run_fused(fns, args)
    seq = parallel.run_sequential(fns, args)
    assert len(fused) == len(seq) == 3
    for a, b in zip(fused, seq):
        assert torch.equal(a, b)


def test_drelu_serving_never_runs_spmm(params, designs, monkeypatch):
    """The D-ReLU serving path is untouched by the dense baseline: it
    calls no ``spmm`` and still gives the reference's predictions."""
    def boom(*a, **k):
        raise AssertionError("spmm called on the D-ReLU path")
    monkeypatch.setattr(tops, "spmm", boom)
    jcfg = JConfig(hidden=HIDDEN, k_cell=K, k_net=K)
    tcfg = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K)
    eng = CircuitServeEngine(_port_model(params), tcfg, max_batch=2,
                             device="cpu")
    rids = [eng.submit(g) for g in designs[1]]
    done = eng.run()
    for rid, gj in zip(rids, designs[0]):
        assert done[rid].error is None
        np.testing.assert_allclose(
            done[rid].pred, np.asarray(drcircuitgnn_forward(params, gj, jcfg)),
            rtol=0, atol=1e-5)


def test_dense_serving_matches_reference(params, designs, monkeypatch):
    """A ``use_drelu=False`` model served through the port's engine (five
    partitions in batches of two) collates without a relation plan, which
    it never reads, and gives every request the reference's prediction of
    its own graph."""
    plans, collate = [], circuit_engine.collate_graphs

    def spy(graphs, **kw):
        batch = collate(graphs, **kw)
        plans.append(batch.plan)
        return batch
    monkeypatch.setattr(circuit_engine, "collate_graphs", spy)
    jcfg = JConfig(hidden=HIDDEN, k_cell=K, k_net=K, use_drelu=False)
    tcfg = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K, use_drelu=False)
    eng = CircuitServeEngine(_port_model(params), tcfg, max_batch=2,
                             device="cpu")
    rids = [eng.submit(g) for g in designs[1]]
    done = eng.run()
    assert len(rids) == 5 and len(plans) >= 3
    assert all(p is None for p in plans)
    for rid, gj in zip(rids, designs[0]):
        assert done[rid].error is None
        np.testing.assert_allclose(
            done[rid].pred, np.asarray(drcircuitgnn_forward(params, gj, jcfg)),
            rtol=0, atol=1e-6)
