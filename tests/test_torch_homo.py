"""PyTorch port, the homogeneous Table-2 baselines: ``homogenize`` exactly
as the reference, every kind of ``homo_forward`` (forward, gradients and
one AdamW step) against the reference from weights carried over by
``HomoGNN.from_jax_params``, and the port's counterparts of
tests/test_hgnn_model.py's four baseline tests.

Tolerances: fp32 with another summation order than the reference
(``assert_close``: rtol 1e-5, atol 1e-5 scaled by the magnitude); the
f64-oracle test keeps the reference test's own tolerances."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.graphs.generator as jgen
import repro.optim as joptim
from repro.graphs.ell import ell_to_coo as j_ell_to_coo
from repro.models.hgnn import homo_forward as j_homo_forward
from repro.models.hgnn import homogenize as j_homogenize
from repro.models.hgnn import init_homo
import repro_torch.graphs.generator as tgen
from repro_torch.graphs.ell import ell_to_coo
from repro_torch.kernels import ops as tops
from repro_torch.models.hgnn import (HOMO_KINDS, HomoGNN, homo_forward,
                                     homogenize, learnable_edge_packing)
from repro_torch.optim.adamw import adamw_init, adamw_update
from _torch_port import HIDDEN, assert_close

SCALE = 0.03


@pytest.fixture(scope="module")
def graphs():
    return (jgen.generate_design(3, "small", SCALE)[0],
            tgen.generate_design(3, "small", SCALE)[0])


@pytest.fixture(scope="module")
def homo(graphs):
    return j_homogenize(graphs[0]), homogenize(graphs[1])


def _init(kind, hj, n_layers=3, seed=0):
    return init_homo(jax.random.PRNGKey(seed), hj[2].shape[1], HIDDEN,
                     n_layers=n_layers, kind=kind, nnz=hj[0].nnz)


def test_homogenize_matches_reference(graphs, homo):
    """(dst, src, w) of both packings exactly equal, on a design whose
    per-relation ``ell_to_coo`` order is not the reference's row-major
    order (the order ``homogenize`` must rebuild)."""
    d, s, _w = ell_to_coo(graphs[1].edges["near"].adj)
    key = d * graphs[1].n_cell + s
    assert np.any(np.diff(key) < 0), "test graph happens to be sorted"
    hj, ht = homo
    for a, b in ((hj[0], ht[0]), (hj[1], ht[1])):
        for x, y in zip(j_ell_to_coo(a), ell_to_coo(b)):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        assert (a.nnz, a.n_dst, a.n_src) == (b.nnz, b.n_dst, b.n_src)
    np.testing.assert_array_equal(ht[2].numpy(), np.asarray(hj[2]))
    np.testing.assert_array_equal(ht[3].numpy(), np.asarray(hj[3]))
    assert ht[4] == hj[4]


def test_learnable_edge_packing_memo(homo):
    adj = homo[1][0]
    p = learnable_edge_packing(adj, "cpu")
    assert learnable_edge_packing(adj, torch.device("cpu")) is p
    fwd, bwd, dst, src, w, nnz = p
    assert nnz == adj.nnz == dst.shape[0]
    assert torch.all(dst[1:] >= dst[:-1])           # canonical order


def _flat(p):
    out = {"w_in": p.w_in, "head_w": p.head_w, "head_b": p.head_b}
    for i, lw in enumerate(p.w_layers):
        leaves = (lw,) if not isinstance(lw, tuple) else lw
        for j, leaf in enumerate(leaves):
            out[(i, j)] = leaf
    return {k: np.asarray(v) for k, v in out.items()}


def _port_flat(model):
    out = {n: p for n, p in model.named_parameters()
           if not n.startswith("layers.")}
    for i, layer in enumerate(model.layers):
        for j, (_n, p) in enumerate(layer.named_parameters()):
            out[(i, j)] = p
    return out


@pytest.mark.parametrize("kind", HOMO_KINDS)
def test_homo_forward_matches_jax(homo, kind):
    """Forward, gradients and one AdamW step (lr 1e-3, weight decay 2e-4,
    as ``bench_table2.train_homo``) from the same weights; ``gat_edge``
    starts from non-zero logits so its attention is not uniform."""
    hj, ht = homo
    pj = _init(kind, hj)
    if kind == "gat_edge":
        rng = np.random.default_rng(1)
        pj = pj._replace(w_layers=tuple(
            (w, jnp.asarray(rng.normal(size=s.shape).astype(np.float32)))
            for w, s in pj.w_layers))
    model = HomoGNN.from_jax_params(jax.tree.map(np.asarray, pj), kind,
                                    device="cpu")
    adj, adj_t, x, y, n_cell = hj

    def jloss(p):
        pred = j_homo_forward(p, adj, adj_t, x, n_cell, kind=kind)
        return jnp.mean((pred - y) ** 2), pred

    (lj, pred_j), gj = jax.value_and_grad(jloss, has_aux=True)(pj)
    pred_t = homo_forward(model, *ht[:3], ht[4])
    lt = torch.mean((pred_t - ht[3]) ** 2)
    assert_close(pred_t.detach().numpy(), np.asarray(pred_j))
    assert_close(lt.item(), float(lj))
    lt.backward()
    ref_g, tp = _flat(gj), _port_flat(model)
    for key, p in tp.items():
        assert_close(p.grad.numpy(), ref_g[key], str(key))
    pj2, _ = joptim.adamw_update(pj, gj, joptim.adamw_init(pj),
                                 jnp.asarray(1e-3), weight_decay=2e-4)
    params = list(tp.values())
    adamw_update(params, [p.grad for p in params], adamw_init(params),
                 1e-3, weight_decay=2e-4)
    ref_p = _flat(pj2)
    for key, p in tp.items():
        assert_close(p.detach().numpy(), ref_p[key], str(key))


@pytest.mark.parametrize("kind", HOMO_KINDS)
def test_homogeneous_baselines_run(homo, kind):
    adj, adj_t, x, y, n_cell = homo[1]
    model = HomoGNN(x.shape[1], HIDDEN, kind=kind, nnz=adj.nnz,
                    device="cpu")
    pred = model(adj, adj_t, x, n_cell)
    assert pred.shape == (n_cell,)
    assert torch.isfinite(pred).all()


def _naive_gat_f64(model, adj, x, n_cell):
    """Unstabilized exp-space GAT in float64 (the reference test's oracle,
    over the port's weights)."""
    dst, src, wv = ell_to_coo(adj)
    wv = wv.astype(np.float64)
    f64 = lambda t: t.detach().numpy().astype(np.float64)
    h = np.asarray(x, np.float64) @ f64(model.w_in)
    lmax = 0.0
    for layer in model.layers:
        hw = h @ f64(layer.w)
        a = f64(layer.a)
        hd = hw.shape[1]
        lrelu = lambda z: np.where(z >= 0, z, 0.01 * z)
        lr_src = lrelu(hw @ a[:hd])
        lr_self = lrelu(hw @ a[:hd] + hw @ a[hd:])
        lmax = max(lmax, float(np.abs(lr_src).max()),
                   float(np.abs(lr_self).max()))
        num = np.exp(lr_self)[:, None] * hw
        den = np.exp(lr_self).copy()
        np.add.at(num, dst, (wv * np.exp(lr_src[src]))[:, None] * hw[src])
        np.add.at(den, dst, wv * np.exp(lr_src[src]))
        h = np.maximum(num / np.maximum(den, 1e-6)[:, None], 0.0)
    z = h @ f64(model.head_w) + f64(model.head_b)
    return (1.0 / (1.0 + np.exp(-z)))[:n_cell, 0], lmax


def test_gat_large_scale_inputs_match_f64_oracle(homo):
    """The per-destination max subtraction keeps GAT finite and faithful
    where exp of the raw logits overflows fp32."""
    adj, adj_t, x, y, n_cell = homo[1]
    model = HomoGNN(x.shape[1], HIDDEN, n_layers=1, kind="gat",
                    device="cpu", generator=torch.Generator().manual_seed(1))
    ref, lmax1 = _naive_gat_f64(model, adj, x.numpy(), n_cell)
    with torch.no_grad():
        pred = homo_forward(model, adj, adj_t, x, n_cell)
    np.testing.assert_allclose(pred.numpy(), ref, rtol=1e-4, atol=1e-4)
    scale = 150.0 / lmax1
    ref_big, lmax = _naive_gat_f64(model, adj, x.numpy() * scale, n_cell)
    assert lmax > 100, "test did not reach the overflow regime"
    with torch.no_grad():
        p = homo_forward(model, adj, adj_t, x * scale, n_cell).numpy()
    assert np.isfinite(p).all()
    np.testing.assert_allclose(p, ref_big, rtol=1e-3, atol=1e-3)


def test_gat_edge_uniform_attention_matches_gcn(homo):
    """Zero logits are uniform attention over each destination's in-edges
    (self-loop included): the GCN's mean aggregation."""
    adj, adj_t, x, y, n_cell = homo[1]
    pe = HomoGNN(x.shape[1], HIDDEN, kind="gat_edge", nnz=adj.nnz,
                 device="cpu")
    pg = HomoGNN(x.shape[1], HIDDEN, kind="gcn", device="cpu")
    pg.load_state_dict({n: p for n, p in pe.state_dict().items()
                        if not n.endswith(".s")})
    with torch.no_grad():
        np.testing.assert_allclose(
            homo_forward(pe, adj, adj_t, x, n_cell).numpy(),
            homo_forward(pg, adj, adj_t, x, n_cell).numpy(),
            rtol=1e-5, atol=1e-5)


def test_gat_edge_scores_learn(homo):
    """dL/ds flows through the learnable op, and a gradient step on the
    per-edge scores lowers the loss."""
    adj, adj_t, x, y, n_cell = homo[1]
    model = HomoGNN(x.shape[1], HIDDEN, kind="gat_edge", nnz=adj.nnz,
                    device="cpu", generator=torch.Generator().manual_seed(2))
    loss = lambda: torch.mean((homo_forward(model, adj, adj_t, x, n_cell)
                               - y) ** 2)
    l0 = loss()
    l0.backward()
    s = model.layers[0].s
    assert s.grad.abs().max() > 0, "no gradient reached the edge scores"
    with torch.no_grad():
        for p in model.parameters():
            p -= 1.0 * p.grad
    assert loss().item() < l0.item()


def test_homo_model_refuses_bad_kind_and_device(homo):
    adj, adj_t, x, y, n_cell = homo[1]
    with pytest.raises(ValueError, match="kind"):
        HomoGNN(x.shape[1], HIDDEN, kind="gin", device="cpu")
    with pytest.raises(ValueError, match="nnz"):
        HomoGNN(x.shape[1], HIDDEN, kind="gat_edge", device="cpu")
    model = HomoGNN(x.shape[1], HIDDEN, device="cpu")
    with pytest.raises(ValueError, match="model on"):
        homo_forward(model, adj, adj_t, x.to("meta"), n_cell)
