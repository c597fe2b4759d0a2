"""PyTorch port, end to end: ``hetero_conv``, the DR-CircuitGNN forward
(both D-ReLU backends, all three wirings) and the serve engine's
per-request predictions against the JAX ``drcircuitgnn_forward``, with the
same weights carried over by ``from_jax_params``.  atol 1e-5: identical
inputs keep the D-ReLU masks identical, so only fp32 summation order
differs."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.graphs.generator as jgen
from repro.core.hetero_mp import HeteroMPConfig as JConfig
from repro.core.hetero_mp import hetero_conv as j_hetero_conv
from repro.models.backbone import BackboneSpec as JSpec
from repro.models.hgnn import drcircuitgnn_forward, init_drcircuitgnn
from repro.serve.circuit_engine import CircuitServeEngine as JEngine
import repro_torch.graphs.generator as tgen
from repro_torch.core.hetero_mp import HeteroMPConfig, hetero_conv
from repro_torch.graphs.circuit import relation_plan_of
from repro_torch.models.backbone import BackboneSpec
from repro_torch.models.hgnn import DRCircuitGNN
from repro_torch.serve.circuit_engine import (CircuitServeEngine,
                                              NonFiniteInputError)
from _torch_port import HIDDEN, K, LAYERS, SCALE

ATOL = 1e-5
JAX_BACKEND = {"topk": "topk", "bisect": "pallas"}


def _configs(drelu_backend):
    return (JConfig(hidden=HIDDEN, k_cell=K, k_net=K,
                    drelu_backend=JAX_BACKEND[drelu_backend]),
            HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K,
                           drelu_backend=drelu_backend))


@pytest.fixture(scope="module")
def params():
    return init_drcircuitgnn(jax.random.PRNGKey(0), 16, 16, HIDDEN, LAYERS)


@pytest.fixture(scope="module")
def designs():
    return (jgen.generate_design(0, "small", SCALE)
            + jgen.generate_design(1, "medium", SCALE),
            tgen.generate_design(0, "small", SCALE)
            + tgen.generate_design(1, "medium", SCALE))


@pytest.mark.parametrize("drelu_backend", ["topk", "bisect"])
def test_hetero_conv_matches(params, designs, drelu_backend):
    gj, gt = designs[0][2], designs[1][2]
    jcfg, tcfg = _configs(drelu_backend)
    rng = np.random.default_rng(1)
    xc = rng.normal(size=(gt.n_cell, HIDDEN)).astype(np.float32)
    xn = rng.normal(size=(gt.n_net, HIDDEN)).astype(np.float32)
    yj = j_hetero_conv(params.layers[0], gj, jnp.asarray(xc),
                       jnp.asarray(xn), jcfg)
    model = DRCircuitGNN.from_jax_params(jax.tree.map(np.asarray, params),
                                         device="cpu")
    with torch.no_grad():
        yt = hetero_conv(model.layers[0], relation_plan_of(gt).to("cpu"),
                         torch.from_numpy(xc), torch.from_numpy(xn), tcfg)
    for a, b in zip(yj, yt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("wiring", ["plain", "residual", "dense"])
@pytest.mark.parametrize("drelu_backend", ["topk", "bisect"])
def test_model_matches(params, designs, drelu_backend, wiring):
    jcfg, tcfg = _configs(drelu_backend)
    model = DRCircuitGNN.from_jax_params(jax.tree.map(np.asarray, params),
                                         device="cpu")
    for gj, gt in zip(designs[0][:2], designs[1][:2]):
        yj = drcircuitgnn_forward(params, gj, jcfg,
                                  JSpec(depth=LAYERS, hidden=HIDDEN,
                                        wiring=wiring))
        with torch.no_grad():
            yt = model(gt, tcfg, BackboneSpec(depth=LAYERS, hidden=HIDDEN,
                                              wiring=wiring))
        assert yt.shape == (gt.n_cell,)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=0,
                                   atol=ATOL)


@pytest.mark.parametrize("drelu_backend", ["topk", "bisect"])
def test_engine_matches(params, designs, drelu_backend):
    """Five requests in batches of two: every request's prediction equals
    the JAX forward of its own graph."""
    jcfg, tcfg = _configs(drelu_backend)
    model = DRCircuitGNN.from_jax_params(jax.tree.map(np.asarray, params),
                                         device="cpu")
    eng = CircuitServeEngine(model, tcfg, max_batch=2, device="cpu")
    rids = [eng.submit(g) for g in designs[1]]
    done = eng.run()
    for rid, gj in zip(rids, designs[0]):
        assert done[rid].error is None
        np.testing.assert_allclose(
            done[rid].pred, np.asarray(drcircuitgnn_forward(params, gj, jcfg)),
            rtol=0, atol=ATOL)
    st = eng.stats()
    assert st["requests"] == 5 and st["batches"] >= 3
    assert {"graphs_per_s", "p50_ms", "p95_ms", "cell_padding_ratio"} <= set(st)
    # filler members and grid padding over real cells, as the
    # reference engine counts them on the same stream
    ref = JEngine(params, jcfg, max_batch=2)
    for g in designs[0]:
        ref.submit(g)
    ref.run()
    assert st["cell_padding_ratio"] == ref.stats()["cell_padding_ratio"]


def test_engine_rejects_nonfinite_input(designs):
    model = DRCircuitGNN(16, 16, HIDDEN, LAYERS, device="cpu")
    eng = CircuitServeEngine(model, HeteroMPConfig(hidden=HIDDEN, k_cell=K,
                                                   k_net=K), device="cpu")
    g = designs[1][0]
    bad = type(g)(**{**g.__dict__, "x_net": g.x_net.clone()})
    bad.x_net[0, 0] = float("nan")
    with pytest.raises(NonFiniteInputError):
        eng.submit(bad)
    assert eng.stats()["rejected_inputs"] == 1 and not eng.queue


def test_engine_fails_nonfinite_output(designs):
    """A poisoned weight reaches the output guard: the batch's requests
    finish with an error instead of a served prediction."""
    model = DRCircuitGNN(16, 16, HIDDEN, LAYERS, device="cpu")
    with torch.no_grad():
        model.head_b.fill_(float("nan"))
    eng = CircuitServeEngine(model, HeteroMPConfig(hidden=HIDDEN, k_cell=K,
                                                   k_net=K), device="cpu")
    rid = eng.submit(designs[1][0])
    assert "non-finite" in str(eng.run()[rid].error)
    assert eng.stats()["failures"] == 1


@pytest.mark.parametrize("threshold", [-1, 10 ** 6])
def test_model_dense_threshold_matches(params, designs, threshold):
    """All-arena (-1) and all-dense plans give the reference's answer."""
    jcfg = JConfig(hidden=HIDDEN, k_cell=K, k_net=K,
                   dense_threshold=threshold)
    tcfg = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K,
                          dense_threshold=threshold)
    model = DRCircuitGNN.from_jax_params(jax.tree.map(np.asarray, params),
                                         device="cpu")
    gj, gt = designs[0][3], designs[1][3]
    with torch.no_grad():
        yt = model(gt, tcfg)
    np.testing.assert_allclose(
        yt.numpy(), np.asarray(drcircuitgnn_forward(params, gj, jcfg)),
        rtol=0, atol=ATOL)


def test_config_rejects_unknown_backend():
    with pytest.raises(ValueError, match="drelu_backend"):
        HeteroMPConfig(drelu_backend="pallas")
