"""PyTorch port, the serial per-relation path and its per-bucket executors
(``backend="bucket"``): the plain versions of kernels 10-12 against the JAX
package's per-bucket Pallas kernels (interpret mode) on the same
``pack_ell`` tables; ``ops.drspmm`` / ``ops.spmm`` / ``drspmm_learnable``
(values and gradients) under both backends against ``jax.vjp`` of the
reference ops; the serial ``hetero_conv`` against the plan path and the
reference; the model, the trainer and the GCN baseline against the
reference's per-bucket (``"xla"``) runs; and the refusals of what the
slice leaves out.  The CUDA kernels are held against these plain versions
on a card in tests/test_torch_cuda.py.

Tolerances: fp32 with another summation order than the reference
(``assert_close``: rtol 1e-5, atol 1e-5 scaled by the reference's
magnitude), as in tests/test_torch_drspmm.py."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.graphs.ell as jell
import repro.graphs.generator as jgen
import repro.optim as joptim
from repro.core.hetero_mp import HeteroMPConfig as JConfig
from repro.core.hetero_mp import hetero_conv as j_hetero_conv
from repro.kernels import drspmm as jk
from repro.kernels import learnable as jlearn
from repro.kernels import ops as jops
from repro.models.hgnn import homo_forward as j_homo_forward
from repro.models.hgnn import homogenize as j_homogenize
from repro.models.hgnn import init_drcircuitgnn, init_homo
from repro.train import circuit_trainer as jtrainer
import repro_torch.graphs.ell as tell
import repro_torch.graphs.generator as tgen
from repro_torch.core.hetero_mp import (HeteroMPConfig, hetero_conv,
                                        plan_applicable)
from repro_torch.graphs.circuit import relation_plan_of
from repro_torch.kernels import drspmm as tk
from repro_torch.kernels import learnable as tlearn
from repro_torch.kernels import ops as tops
from repro_torch.models.hgnn import (DRCircuitGNN, HomoGNN, homo_forward,
                                     homogenize, learnable_edge_packing)
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.serve.circuit_engine import CircuitServeEngine
from repro_torch.train.circuit_trainer import (CircuitTrainConfig,
                                               CircuitTrainer)
from _torch_port import HIDDEN, K, LAYERS, SCALE, assert_close

ETYPES = ("near", "pin", "pinned")
# the port's backend names and the reference's executor of the same family
# on the CPU
JAX_BACKEND = {"bucket": "xla", "fused": "xla_fused"}
BUCKET_KERNELS = ("drspmm_fwd_bucket", "drspmm_bwd_bucket", "spmm_bucket")


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


def _cbsr(n, k, seed, dim=HIDDEN):
    """A seeded CBSR operand (vals, idx) of n rows: the top k of a normal
    matrix, indices ascending."""
    x = _features(n, seed, dim)
    idx = np.sort(np.argsort(-x, axis=1, kind="stable")[:, :k],
                  axis=1).astype(np.int32)
    return np.take_along_axis(x, idx, axis=1), idx


@pytest.fixture
def calls(monkeypatch):
    """Count the calls of every kernel wrapper (on the CPU each runs its
    plain version, so the launch counters stay at 0)."""
    seen = {}
    names = ("drspmm_fwd_arena", "drspmm_bwd_arena", "drspmm_dense_tier_fwd",
             "drspmm_dense_tier_bwd", "spmm_arena", "drspmm_fwd_learnable",
             "drspmm_bwd_learnable", "drspmm_dw_learnable") + BUCKET_KERNELS
    for name in names:
        fn = getattr(tk, name)
        seen[name] = 0

        def wrapped(*a, _fn=fn, _name=name):
            seen[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(tk, name, wrapped)
    return seen


# ---------------------------------------------------------------------------
# kernels 10-12: plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

def _bucket_cases():
    """(name, port BucketedELL) of every case: a scale-0.02 relation (its
    ``near`` buckets pad rows with a real row 0), a matrix with a row
    wider than 256 slots, and an empty matrix's inert bucket."""
    g = tgen.generate_design(0, "small", SCALE)[0]
    rng = np.random.default_rng(3)
    n = 40
    dst = np.concatenate([np.full(300, 5), rng.integers(0, n, 90)])
    src = np.concatenate([rng.integers(0, n, 300), rng.integers(0, n, 90)])
    w = rng.random(dst.shape[0]).astype(np.float32) + 0.1
    return {"near": g.edges["near"].adj, "near_t": g.edges["near"].adj_t,
            "wide": tell.pack_ell(dst, src, w, n, n),
            "empty": tell.pack_ell(np.zeros(0), np.zeros(0), None, 6, 9)}


def _jax_bucket(b):
    return jell.ELLBucket(rows=jnp.asarray(b.rows), nbr=jnp.asarray(b.nbr),
                          w=jnp.asarray(b.w))


def _torch_bucket(b):
    return tell.ELLBucket(rows=torch.from_numpy(b.rows.astype(np.int64)),
                          nbr=torch.from_numpy(b.nbr),
                          w=torch.from_numpy(b.w))


def test_bucket_cases_cover_the_edge_cases():
    cases = _bucket_cases()
    near = cases["near"]
    padded = [b for b in near.buckets
              if np.count_nonzero(b.rows == 0) > 1]
    assert padded, "no bucket pads its rows with row 0"
    assert any(0 in b.rows[(b.w != 0).any(1)] for b in near.buckets), \
        "row 0 is not a real row of any bucket"
    assert max(b.width for b in cases["wide"].buckets) > 256
    (inert,) = cases["empty"].buckets
    assert inert.nbr.shape == (8, 1) and not inert.w.any()


@pytest.mark.parametrize("case", ["near", "near_t", "wide", "empty"])
@pytest.mark.parametrize("k", [K, 40])
def test_bucket_fwd_plain_matches_pallas(case, k):
    """Kernel 10's plain version against ``drspmm_fwd_bucket``, every
    bucket of the case; k 40 takes the kernel's wide-row branch."""
    adj = _bucket_cases()[case]
    xv, xi = _cbsr(adj.n_src, k, seed=k, dim=64)
    for b in adj.buckets:
        ref = jk.drspmm_fwd_bucket(_jax_bucket(b), jnp.asarray(xv),
                                   jnp.asarray(xi), 64, interpret=True)
        before = tk.drspmm_fwd_bucket.launches
        out = tk.drspmm_fwd_bucket(_torch_bucket(b), torch.from_numpy(xv),
                                   torch.from_numpy(xi), 64)
        assert tk.drspmm_fwd_bucket.launches == before   # CPU: plain
        assert out.shape == (b.n_rows, 64)
        assert_close(out.numpy(), np.asarray(ref), f"{case} {b.nbr.shape}")


@pytest.mark.parametrize("case", ["near", "near_t", "wide", "empty"])
@pytest.mark.parametrize("k", [K, 40])
def test_bucket_bwd_plain_matches_pallas(case, k):
    """Kernel 11's plain version against ``drspmm_bwd_bucket`` at the CBSR
    indices of each bucket's rows (``xi_rows = x_idx[b.rows]``)."""
    adj = _bucket_cases()[case]
    _xv, xi = _cbsr(adj.n_dst, k, seed=k, dim=64)
    gy = _features(adj.n_src, 9, 64)
    for b in adj.buckets:
        xi_rows = xi[b.rows]
        ref = jk.drspmm_bwd_bucket(_jax_bucket(b), jnp.asarray(gy),
                                   jnp.asarray(xi_rows), interpret=True)
        out = tk.drspmm_bwd_bucket(_torch_bucket(b), torch.from_numpy(gy),
                                   torch.from_numpy(xi_rows))
        assert out.shape == (b.n_rows, k)
        assert_close(out.numpy(), np.asarray(ref), f"{case} {b.nbr.shape}")


@pytest.mark.parametrize("case", ["near", "near_t", "wide", "empty"])
@pytest.mark.parametrize("dim", [HIDDEN, 72])
def test_spmm_bucket_plain_matches_pallas(case, dim):
    """Kernel 12's plain version against ``spmm_dense_bucket``."""
    adj = _bucket_cases()[case]
    x = _features(adj.n_src, dim, dim)
    for b in adj.buckets:
        ref = jk.spmm_dense_bucket(_jax_bucket(b), jnp.asarray(x),
                                   interpret=True)
        out = tk.spmm_bucket(_torch_bucket(b), torch.from_numpy(x))
        assert out.shape == (b.n_rows, dim)
        assert_close(out.numpy(), np.asarray(ref), f"{case} {b.nbr.shape}")


def _padded_slab(e, seed, r=16, n_src=70):
    """One (r, e) bucket packed by ``pack_ell`` from a seeded COO, at a
    width of the main path's buckets: rows 0 and 1 fill all e slots, the
    others end early; row 1 has weight 0 at slots 32-63 and over its
    middle third (padding windows between real slots), and every fifth
    row is all padding."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, e + 1, r)
    deg[:2] = e
    dst = np.repeat(np.arange(r), deg)
    j = np.arange(dst.size) - np.repeat(np.cumsum(deg) - deg, deg)
    w = rng.random(dst.size).astype(np.float32) + 0.1
    w[(dst == 1) & (((j >= 32) & (j < 64))
                    | ((j >= e // 3) & (j < 2 * e // 3)))] = 0.0
    w[dst % 5 == 4] = 0.0
    (b,) = tell.pack_ell(dst, rng.integers(0, n_src, dst.size), w, r, n_src,
                         bounds=()).buckets
    assert b.nbr.shape == (r, e)
    return b, n_src


MAIN_PATH_WIDTHS = [64, 78, 256, 260]


@pytest.mark.parametrize("e", MAIN_PATH_WIDTHS)
@pytest.mark.parametrize("k", [K, 40])
def test_bucket_bwd_plain_matches_pallas_padded_slabs(e, k):
    """Kernel 11's plain version against ``drspmm_bwd_bucket`` on slabs of
    the main path's widths with padding windows mid-row."""
    b, n_src = _padded_slab(e, e + k)
    gy = _features(n_src, 5, 64)
    xi_rows = np.random.default_rng(k).integers(
        0, 64, (b.n_rows, k)).astype(np.int32)
    ref = jk.drspmm_bwd_bucket(_jax_bucket(b), jnp.asarray(gy),
                               jnp.asarray(xi_rows), interpret=True)
    out = tk.drspmm_bwd_bucket(_torch_bucket(b), torch.from_numpy(gy),
                               torch.from_numpy(xi_rows))
    assert out.shape == (b.n_rows, k)
    assert_close(out.numpy(), np.asarray(ref), f"{b.nbr.shape}")


@pytest.mark.parametrize("e", MAIN_PATH_WIDTHS)
def test_spmm_bucket_plain_matches_pallas_padded_slabs(e):
    """Kernel 12's plain version against ``spmm_dense_bucket`` on slabs of
    the main path's widths with padding windows mid-row."""
    b, n_src = _padded_slab(e, e)
    x = _features(n_src, 6, HIDDEN)
    ref = jk.spmm_dense_bucket(_jax_bucket(b), jnp.asarray(x),
                               interpret=True)
    out = tk.spmm_bucket(_torch_bucket(b), torch.from_numpy(x))
    assert out.shape == (b.n_rows, HIDDEN)
    assert_close(out.numpy(), np.asarray(ref), f"{b.nbr.shape}")


def test_bucket_loop_accumulates_padding_rows():
    """The padding rows of a bucket repeat row 0: the caller's indexed add
    must accumulate them, so row 0 keeps its real sum."""
    adj = _bucket_cases()["near"]
    xv, xi = _cbsr(adj.n_src, K, seed=1)
    y = tops._bucket_fwd(tops.device_buckets(adj, "cpu"),
                         torch.from_numpy(xv), torch.from_numpy(xi), HIDDEN)
    ref = adj.to_dense() @ tk._densify(torch.from_numpy(xv),
                                       torch.from_numpy(xi), HIDDEN).numpy()
    assert np.abs(ref[0]).max() > 0
    assert_close(y.numpy(), ref)


def test_device_buckets_memo(designs):
    adj = designs[1][0].edges["near"].adj
    bk = tops.device_buckets(adj, "cpu")
    assert tops.device_buckets(adj, torch.device("cpu")) is bk
    b = bk.buckets[0]
    assert (b.rows.dtype, b.nbr.dtype, b.w.dtype) == \
        (torch.int64, torch.int32, torch.float32)
    assert len(bk.buckets) == len(adj.buckets)


# ---------------------------------------------------------------------------
# the single-relation ops under both backends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["bucket", "fused"])
@pytest.mark.parametrize("etype", ETYPES)
def test_drspmm_matches_jax(designs, calls, etype, backend):
    """Values and the sampled gradient of ``ops.drspmm`` against
    ``jax.vjp`` of the reference op and against the port's dense oracle.
    At scale 0.02 ``pin``/``pinned`` sit below the dense-tier crossover, so
    under ``"fused"`` they run the dense-tier kernels on their own dense
    matrices and ``near`` the arena kernels; ``"bucket"`` never goes
    dense."""
    ej, et = designs[0][0].edges[etype], designs[1][0].edges[etype]
    xv, xi = _cbsr(et.adj.n_src, K, seed=2)
    gy = _features(et.adj.n_dst, 4)
    y, vjp = jax.vjp(lambda v: jops.drspmm(
        ej.adj, ej.adj_t, v, jnp.asarray(xi), HIDDEN,
        backend=JAX_BACKEND[backend]), jnp.asarray(xv))
    (gv,) = vjp(jnp.asarray(gy))
    outs = {}
    for dense in (False, True):
        v = torch.from_numpy(xv).requires_grad_()
        yt = tops.drspmm(et.adj, et.adj_t, v, torch.from_numpy(xi), HIDDEN,
                         backend=backend, dense=dense)
        yt.backward(torch.from_numpy(gy))
        outs[dense] = (yt.detach().numpy(), v.grad.numpy())
        assert_close(outs[dense][0], np.asarray(y), f"fwd dense={dense}")
        assert_close(outs[dense][1], np.asarray(gv), f"bwd dense={dense}")
    assert_close(outs[False][0], outs[True][0])
    dense_tier = backend == "fused" and etype != "near"
    assert tops._dense_tier_single(et.adj) == (etype != "near")
    n_fwd, n_bwd = len(et.adj.buckets), len(et.adj_t.buckets)
    want = {"drspmm_fwd_bucket": n_fwd, "drspmm_bwd_bucket": n_bwd} \
        if backend == "bucket" else \
        {"drspmm_dense_tier_fwd": 1, "drspmm_dense_tier_bwd": 1} \
        if dense_tier else {"drspmm_fwd_arena": 1, "drspmm_bwd_arena": 1}
    assert {k: v for k, v in calls.items() if v} == want


@pytest.mark.parametrize("etype", ETYPES)
def test_spmm_bucket_matches_jax(designs, calls, etype):
    """``ops.spmm(backend="bucket")``: kernel 12 over the buckets of A
    forward and of Aᵀ backward, against the reference's per-bucket op."""
    ej, et = designs[0][1].edges[etype], designs[1][1].edges[etype]
    x = _features(et.adj.n_src, 3)
    gy = _features(et.adj.n_dst, 4)
    y, vjp = jax.vjp(lambda v: jops.spmm(ej.adj, ej.adj_t, v,
                                         backend="xla"), jnp.asarray(x))
    (gx,) = vjp(jnp.asarray(gy))
    xt = torch.from_numpy(x).requires_grad_()
    yt = tops.spmm(et.adj, et.adj_t, xt, backend="bucket")
    yt.backward(torch.from_numpy(gy))
    assert_close(yt.detach().numpy(), np.asarray(y))
    assert_close(xt.grad.numpy(), np.asarray(gx))
    assert {k: v for k, v in calls.items() if v} == \
        {"spmm_bucket": len(et.adj.buckets) + len(et.adj_t.buckets)}


def test_fused_adjacency_upgrades_bucket(designs, calls):
    """A pre-fused arena has no bucket slabs: ``"bucket"`` runs the fused
    kernels on it, as the reference's ``_effective_backend`` does."""
    es = designs[1][0].edges["near"]
    f, ft = tell.fuse_bucketed(es.adj), tell.fuse_bucketed(es.adj_t)
    assert tops._effective_backend(f, "bucket") == "fused"
    assert tops._effective_backend(es.adj, "bucket") == "bucket"
    x = torch.from_numpy(_features(es.adj.n_src, 5)).requires_grad_()
    tops.spmm(f, ft, x, backend="bucket").sum().backward()
    xv, xi = _cbsr(es.adj.n_src, K, seed=6)
    tops.drspmm(f, ft, torch.from_numpy(xv).requires_grad_(),
                torch.from_numpy(xi), HIDDEN, backend="bucket").sum().backward()
    assert {k: v for k, v in calls.items() if v} == \
        {"spmm_arena": 2, "drspmm_fwd_arena": 1, "drspmm_bwd_arena": 1}


def _eid_problem(seed=0, n_dst=61, n_src=47, n_edges=700):
    rng = np.random.default_rng(seed)
    key = np.unique(rng.integers(0, n_dst * n_src, n_edges))
    dst, src = key // n_src, key % n_src
    w = rng.random(dst.shape[0]).astype(np.float32) + 0.1
    xv, xi = _cbsr(n_src, K, seed=seed + 1)
    gy = _features(n_dst, seed + 2)
    return dst, src, w, xv, xi, gy


def test_learnable_bucket_slabs_match_jax(calls):
    """The slab entry point under ``"bucket"``: kernels 10/11 on weights
    gathered from ``w_canon``, dL/dw the bucketed plain reduction; both
    gradients against the reference's per-bucket (``"xla"``) op."""
    dst, src, w, xv, xi, gy = _eid_problem()
    fj, bj, _o, nnz = jell.pack_eid_slabs(dst, src, 61, 47)
    ft, bt, order, nnz_t = tell.pack_eid_slabs(dst, src, 61, 47)
    assert nnz == nnz_t
    wc = w[order]                                     # canonical order

    def jf(wv, v):
        return jlearn.drspmm_learnable(fj, bj, nnz, wv, v, jnp.asarray(xi),
                                       HIDDEN, backend="xla")
    y, vjp = jax.vjp(jf, jnp.asarray(wc), jnp.asarray(xv))
    gw, gv = vjp(jnp.asarray(gy))
    wt = torch.from_numpy(wc).requires_grad_()
    vt = torch.from_numpy(xv).requires_grad_()
    yt = tlearn.drspmm_learnable(ft, bt, nnz, wt, vt, torch.from_numpy(xi),
                                 HIDDEN, backend="bucket")
    yt.backward(torch.from_numpy(gy))
    assert_close(yt.detach().numpy(), np.asarray(y))
    assert_close(wt.grad.numpy(), np.asarray(gw))
    assert_close(vt.grad.numpy(), np.asarray(gv))
    assert {k: v for k, v in calls.items() if v} == \
        {"drspmm_fwd_bucket": len(ft.buckets),
         "drspmm_bwd_bucket": len(bt.buckets)}


def test_learnable_fused_pair_upgrades_bucket(calls):
    """A fused edge-id pair under ``"bucket"`` runs kernels 7-9 (their
    plain versions here) and no bucket kernel, and matches the slabs."""
    dst, src, w, xv, xi, gy = _eid_problem(seed=4)
    f, b, order, nnz = tell.pack_fused_eid_pair(dst, src, 61, 47)
    fs, bs, order_s, _n = tell.pack_eid_slabs(dst, src, 61, 47)
    outs = []
    for pair, o in (((f, b), order), ((fs, bs), order_s)):
        wt = torch.from_numpy(w[o]).requires_grad_()
        vt = torch.from_numpy(xv).requires_grad_()
        yt = tops.drspmm_learnable(*pair, nnz, wt, vt, torch.from_numpy(xi),
                                   HIDDEN, backend="bucket")
        yt.backward(torch.from_numpy(gy))
        outs.append((yt.detach().numpy(), wt.grad.numpy(), vt.grad.numpy()))
        if pair[0] is f:
            assert {k: v for k, v in calls.items() if v} == \
                {"drspmm_fwd_learnable": 1, "drspmm_bwd_learnable": 1,
                 "drspmm_dw_learnable": 1}
    for a, r in zip(*outs):
        assert_close(a, r)


@pytest.mark.parametrize("fn", ["drspmm", "spmm", "learnable", "homo",
                                "config", "train_config"])
def test_unknown_backend_raises(designs, fn):
    es = designs[1][0].edges["near"]
    xv, xi = _cbsr(es.adj.n_src, K, seed=0)
    v, i = torch.from_numpy(xv), torch.from_numpy(xi)
    with pytest.raises(ValueError, match="backend"):
        if fn == "drspmm":
            tops.drspmm(es.adj, es.adj_t, v, i, HIDDEN, backend="pallas")
        elif fn == "spmm":
            tops.spmm(es.adj, es.adj_t, v, backend="xla")
        elif fn == "learnable":
            dst, src, _w, xv, xi, _g = _eid_problem()
            f, b, _o, nnz = tell.pack_eid_slabs(dst, src, 61, 47)
            tops.drspmm_learnable(f, b, nnz, torch.ones(nnz),
                                  torch.from_numpy(xv), torch.from_numpy(xi),
                                  HIDDEN, backend="nope")
        elif fn == "homo":
            adj, adj_t, x, _y, n_cell = homogenize(designs[1][0])
            homo_forward(HomoGNN(x.shape[1], HIDDEN, device="cpu"), adj,
                         adj_t, x, n_cell, backend="nope")
        elif fn == "config":
            HeteroMPConfig(hidden=HIDDEN, backend="dense")
        else:
            CircuitTrainConfig(hidden=HIDDEN, backend="nope")


# ---------------------------------------------------------------------------
# the serial hetero_conv, the model and the trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k_net", [K, HIDDEN])
def test_hetero_conv_serial_matches_plan_and_jax(params, designs, k_net):
    """The serial path (``use_plan=False``, both backends) against the
    reference's serial path, and its fused family against the port's plan
    path exactly, forward and the gradients of both inputs.  With k_net = hidden the net type stays
    dense, so the serial ``pinned`` runs ``spmm`` (and no plan
    applies)."""
    gj, gt = designs[0][1], designs[1][1]
    xc, xn = _features(gt.n_cell, 1), _features(gt.n_net, 2)
    layer = _port_model(params).layers[0]
    base = dict(hidden=HIDDEN, k_cell=K, k_net=k_net)

    def run(cfg, over):
        c = torch.from_numpy(xc).requires_grad_()
        n = torch.from_numpy(xn).requires_grad_()
        yc, yn = hetero_conv(layer, over, c, n, cfg)
        (torch.sum(yc ** 2) + torch.sum(torch.sin(yn))).backward()
        return [yc.detach().numpy(), yn.detach().numpy(), c.grad.numpy(),
                n.grad.numpy()]

    def jrun(cfg):
        def f(a, b):
            yc, yn = j_hetero_conv(params.layers[0], gj, a, b, cfg)
            return jnp.sum(yc ** 2) + jnp.sum(jnp.sin(yn)), (yc, yn)
        (_, (yc, yn)), (ga, gb) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(jnp.asarray(xc), jnp.asarray(xn))
        return [np.asarray(a) for a in (yc, yn, ga, gb)]

    ref = jrun(JConfig(**base, use_plan=False))
    outs = {}
    for be in ("fused", "bucket"):
        cfg = HeteroMPConfig(**base, backend=be, use_plan=False)
        assert not plan_applicable(cfg, HIDDEN)
        outs[be] = run(cfg, gt)
        for a, r, nm in zip(outs[be], ref, ("yc", "yn", "dc", "dn")):
            assert_close(a, r, f"{be} {nm}")
    pcfg = HeteroMPConfig(**base)
    if plan_applicable(pcfg, HIDDEN):
        # forward: the plan's super-arena and stacked dense tier add the
        # same products in the same order as the per-relation executors;
        # backward: a source type's gradient sums its relations' parts in
        # another order (the plan per tier, autograd per relation)
        plan_out = run(pcfg, relation_plan_of(gt).to("cpu"))
        for a, r in zip(plan_out[:2], outs["fused"][:2]):
            np.testing.assert_array_equal(a, r)
        for a, r in zip(plan_out[2:], outs["fused"][2:]):
            assert_close(a, r)
    else:
        assert k_net == HIDDEN


@pytest.mark.parametrize("kw", [
    dict(backend="bucket"), dict(backend="bucket", k_net=HIDDEN),
    dict(use_plan=False), dict(k_cell=HIDDEN)], ids=[
    "bucket", "bucket-knet_hidden", "serial-fused", "fused-kcell_hidden"])
def test_trainer_serial_matches_reference(designs, calls, kw):
    """Three single-graph steps from the same weights: per-step losses and
    final parameters against the JAX trainer (``"bucket"`` against its
    per-bucket ``"xla"``, the fused serial path against ``"xla_fused"``)."""
    kw = dict(dict(hidden=HIDDEN, k_cell=K, k_net=K, lr=1e-3, epochs=1),
              **kw)
    jkw = dict(kw, backend=JAX_BACKEND[kw.get("backend", "fused")])
    jt = jtrainer.CircuitTrainer(jtrainer.CircuitTrainConfig(**jkw), 16, 16)
    tt = CircuitTrainer(CircuitTrainConfig(**kw), 16, 16,
                        model=_port_model(jt.params), device="cpu")
    assert not tt._with_plan
    gj, gt = designs
    for i in range(3):
        assert_close(tt.train_epoch([gt[i]]), jt.train_epoch([gj[i]]))
    assert tt.opt_state.step == int(jt.opt_state.step) == 3
    for pg in tt._plan_cache.values():
        assert pg[1].plan is None
    ref = {n: np.asarray(getattr(jt.params, n))
           for n in ("in_cell", "in_net", "head_w", "head_b")}
    for i, lp in enumerate(jt.params.layers):
        for f in lp._fields:
            ref[f"layers.{i}.{f}"] = np.asarray(getattr(lp, f))
    for n, p in tt.model.named_parameters():
        assert_close(p.detach().numpy(), ref[n], n)
    ran = {k for k, v in calls.items() if v}
    if kw.get("backend") == "bucket":
        want = {"drspmm_fwd_bucket", "drspmm_bwd_bucket"}
        assert ran == (want | {"spmm_bucket"} if kw["k_net"] == HIDDEN
                       else want)
    else:
        assert ran and not ran & set(BUCKET_KERNELS)
        assert ("spmm_arena" in ran) == (kw["k_cell"] == HIDDEN)


def test_drelu_is_identity_at_full_width(params, designs):
    """With k_net = hidden the nets' inter-layer activation is the
    identity (the reference's ``drelu``), not ReLU: a model forward equals
    one whose net activation is replaced by the identity by hand."""
    from repro_torch.core.drelu import drelu
    x = torch.randn(5, HIDDEN)
    assert drelu(x, HIDDEN) is x
    cfg = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=HIDDEN)
    jcfg = JConfig(hidden=HIDDEN, k_cell=K, k_net=HIDDEN)
    from repro.models.hgnn import drcircuitgnn_forward
    with torch.no_grad():
        pred = _port_model(params)(designs[1][0], cfg)
    assert_close(pred.numpy(),
                 np.asarray(drcircuitgnn_forward(params, designs[0][0],
                                                 jcfg)))


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_homo_bucket_matches_jax(designs, calls, kind):
    """``homo_forward(backend="bucket")`` against the reference's
    ``"xla"``: forward, gradients and one AdamW step (lr 1e-3, weight decay
    2e-4); kernel 12 (plain here) per bucket, no arena SpMM."""
    hj, ht = j_homogenize(designs[0][0]), homogenize(designs[1][0])
    pj = init_homo(jax.random.PRNGKey(0), hj[2].shape[1], HIDDEN,
                   n_layers=3, kind=kind)
    model = HomoGNN.from_jax_params(jax.tree.map(np.asarray, pj), kind,
                                    device="cpu")
    adj, adj_t, x, y, n_cell = hj

    def jloss(p):
        pred = j_homo_forward(p, adj, adj_t, x, n_cell, kind=kind,
                              backend="xla")
        return jnp.mean((pred - y) ** 2)

    lj, gj = jax.value_and_grad(jloss)(pj)
    lt = torch.mean((homo_forward(model, *ht[:3], ht[4], backend="bucket")
                     - ht[3]) ** 2)
    assert_close(lt.item(), float(lj))
    lt.backward()
    pj2, _ = joptim.adamw_update(pj, gj, joptim.adamw_init(pj),
                                 jnp.asarray(1e-3), weight_decay=2e-4)
    params = list(model.parameters())
    adamw_update(params, [p.grad for p in params], adamw_init(params), 1e-3,
                 weight_decay=2e-4)
    ref = [pj2.w_in] + [leaf for lw in pj2.w_layers
                        for leaf in (lw if isinstance(lw, tuple) else (lw,))]
    ref += [pj2.head_w, pj2.head_b]
    port = [model.w_in] + [p for layer in model.layers
                           for p in layer.parameters()]
    port += [model.head_w, model.head_b]
    for a, r in zip(port, ref):
        assert_close(a.detach().numpy(), np.asarray(r))
    n = len(ht[0].buckets) + len(ht[1].buckets)
    assert {k: v for k, v in calls.items() if v} == {"spmm_bucket": 3 * n}


def test_homo_gat_bucket_runs_fused_kernels(designs, calls):
    """``gat`` hands fused edge-id arenas over, so ``"bucket"`` runs
    kernels 7-9 and matches ``"fused"``."""
    adj, adj_t, x, y, n_cell = homogenize(designs[1][0])
    model = HomoGNN(x.shape[1], HIDDEN, n_layers=2, kind="gat",
                    device="cpu")
    with torch.no_grad():
        a = homo_forward(model, adj, adj_t, x, n_cell, backend="bucket")
        b = homo_forward(model, adj, adj_t, x, n_cell)
    assert torch.equal(a, b)
    assert {k: v for k, v in calls.items() if v} == \
        {"drspmm_fwd_learnable": 4}
    assert learnable_edge_packing(adj, "cpu")[0].eid is not None


# ---------------------------------------------------------------------------
# what the slice leaves out
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(backend="bucket"),
                                dict(use_plan=False)])
def test_batched_serial_training_raises(designs, kw):
    field = next(iter(kw))
    with pytest.raises(NotImplementedError, match=field):
        CircuitTrainConfig(hidden=HIDDEN, k_cell=K, k_net=K, batch_size=2,
                           **kw)
    tt = CircuitTrainer(CircuitTrainConfig(hidden=HIDDEN, k_cell=K, k_net=K,
                                           **kw), 16, 16, device="cpu")
    with pytest.raises(NotImplementedError, match=field):
        tt.train_epoch(designs[1][:2], batch_size=2)
    assert tt.opt_state.step == 0


@pytest.mark.parametrize("kw", [dict(backend="bucket"),
                                dict(use_plan=False)])
def test_engine_refuses_serial_configs(kw):
    model = DRCircuitGNN(16, 16, HIDDEN, LAYERS, device="cpu")
    with pytest.raises(NotImplementedError, match=next(iter(kw))):
        CircuitServeEngine(model, HeteroMPConfig(hidden=HIDDEN, k_cell=K,
                                                 k_net=K, **kw),
                           device="cpu")


def test_engine_serves_large_k_on_the_fused_family(params, designs, calls):
    """k_net >= hidden needs no serial-only executor: the engine serves it
    over the collated batch's edges with the fused kernels, as the
    reference does over its fused arenas."""
    from repro.models.hgnn import drcircuitgnn_forward
    cfg = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=HIDDEN)
    eng = CircuitServeEngine(_port_model(params), cfg, max_batch=2,
                             device="cpu")
    rids = [eng.submit(g) for g in designs[1][:2]]
    done = eng.run()
    jcfg = JConfig(hidden=HIDDEN, k_cell=K, k_net=HIDDEN)
    for rid, gj in zip(rids, designs[0][:2]):
        assert done[rid].error is None
        np.testing.assert_allclose(
            done[rid].pred, np.asarray(drcircuitgnn_forward(params, gj, jcfg)),
            rtol=0, atol=1e-5)
    assert all(calls[k] == 0 for k in BUCKET_KERNELS)
    assert calls["spmm_arena"] > 0
