"""PyTorch port, quantized layouts: fused and padded collation, bucket
layouts and signatures, batched training and serving under every backend,
and K profiling, against the JAX package on the same numpy inputs.

* ``collate_graphs`` (fused, quantized or exact, with a bucket layout, a
  pinned chunk width, filler members and edge ids): every arena table, plan
  segment, edge count and member slice equals the reference's;
  ``pad_fused_arena``, ``_arena_row_cap`` and ``LayoutTable`` likewise;
  over a seeded stream of jittered graphs the signatures change at the
  same batches.
* A padded arena's walk skips its padding chunks and gives the exact
  arena's rows.
* Batched training under ``backend="bucket"`` and ``use_plan=False`` runs
  the fused kernels over the collated arenas, as the reference's does:
  first-step losses and gradients, and two epochs of losses and
  parameters.
* The serve engine under both settings serves the reference's
  predictions, and its ``compiles`` / ``evictions`` / ``live_buckets``
  follow the reference engine's on the same stream.
* K profiling gives the reference's K.

Tolerances: fp32 with another summation order than the reference
(``assert_close``: rtol 1e-5, atol 1e-5 scaled by the reference's
magnitude); tables and counts are exact."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.core.drelu as jdrelu
import repro.graphs.circuit as jcircuit
import repro.graphs.collate as jcollate
import repro.graphs.ell as jell
import repro.graphs.generator as jgen
from repro.core.hetero_mp import HeteroMPConfig as JConfig
from repro.kernels import ops as jops
from repro.models.hgnn import batched_loss_fn as j_batched_loss_fn
from repro.models.hgnn import drcircuitgnn_forward, init_drcircuitgnn
from repro.serve.circuit_engine import CircuitServeEngine as JEngine
from repro.train import circuit_trainer as jtrainer
import repro_torch.core.drelu as tdrelu
import repro_torch.graphs.circuit as tcircuit
import repro_torch.graphs.collate as tcollate
import repro_torch.graphs.ell as tell
import repro_torch.graphs.generator as tgen
from repro_torch.core.hetero_mp import HeteroMPConfig
from repro_torch.kernels import drspmm as tk
from repro_torch.kernels import ops as tops
from repro_torch.models.hgnn import DRCircuitGNN, batched_loss_fn
from repro_torch.serve.circuit_engine import CircuitServeEngine
from repro_torch.train.circuit_trainer import (CircuitTrainConfig,
                                               CircuitTrainer)
from _torch_port import (HIDDEN, K, LAYERS, SCALE, assert_close,
                         assert_fused_equal, assert_plan_equal,
                         padded_and_exact_rows)

ETYPES = ("near", "pin", "pinned")
# the reference's executor of the port's backend on the CPU
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


def _stream(n, seed=7):
    """``n`` (reference, port) graph pairs of three size classes with ±10 %
    jitter in their node counts, the classes in a seeded order."""
    rng = np.random.default_rng(seed)
    base = [(60, 30), (120, 60), (240, 110)]
    out = []
    for i in range(n):
        c, m = base[int(rng.integers(len(base)))]
        c = int(c * rng.uniform(0.9, 1.1))
        m = int(m * rng.uniform(0.9, 1.1))
        pair = []
        for gen in (jgen, tgen):
            coo, xc, xn, y = gen.generate_partition(
                np.random.default_rng(100 + i), c, m)
            pair.append(gen.pack_graph_parallel(coo, c, m, xc, xn, y))
        out.append(tuple(pair))
    return out


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


@pytest.fixture
def calls(monkeypatch):
    """Count the calls of the arena and bucket kernel wrappers (on the CPU
    each runs its plain version)."""
    seen = {}
    for name in ("drspmm_fwd_arena", "drspmm_bwd_arena", "spmm_arena",
                 "drspmm_dense_tier_fwd", "drspmm_dense_tier_bwd")\
            + BUCKET_KERNELS:
        fn = getattr(tk, name)
        seen[name] = 0

        def wrapped(*a, _fn=fn, _name=name):
            seen[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(tk, name, wrapped)
    return seen


def _assert_batches_equal(bj, bt):
    """A port batch has the reference batch's graph, tables, members and
    edge counts exactly."""
    assert (bj.graph.n_cell, bj.graph.n_net) == (bt.graph.n_cell,
                                                 bt.graph.n_net)
    for f in ("x_cell", "x_net", "y_cell"):
        assert np.array_equal(np.asarray(getattr(bj.graph, f)),
                              getattr(bt.graph, f).numpy()), f
    np.testing.assert_array_equal(bt.cell_weight.numpy(),
                                  np.asarray(bj.cell_weight))
    for et in ETYPES:
        for d in ("adj", "adj_t"):
            a = getattr(bj.graph.edges[et], d)
            b = getattr(bt.graph.edges[et], d)
            if isinstance(a, jell.FusedELL):
                assert_fused_equal(a, b)
                if a.eid is None:
                    assert b.eid is None
                else:
                    assert np.array_equal(np.asarray(a.eid),
                                          np.asarray(b.eid))
            else:
                assert len(a.buckets) == len(b.buckets)
                for x, y in zip(a.buckets, b.buckets):
                    for f in ("rows", "nbr", "w"):
                        assert np.array_equal(np.asarray(getattr(x, f)),
                                              np.asarray(getattr(y, f))), f
    if bj.graph.plan is None:
        assert bt.graph.plan is None
    else:
        assert_plan_equal(bj.graph.plan, bt.graph.plan)
    assert [dataclasses.astuple(m) for m in bj.members] == \
        [dataclasses.astuple(m) for m in bt.members]
    assert bj.n_real == bt.n_real
    assert (bj.edge_nnz, bj.edge_nnz_exact, bj.edge_eid_offsets) == \
        (bt.edge_nnz, bt.edge_nnz_exact, bt.edge_eid_offsets)


# ---------------------------------------------------------------------------
# collation, padding, layouts and signatures
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 8])
@pytest.mark.parametrize("with_layout", [False, True])
@pytest.mark.parametrize("quantize", [False, True])
def test_collate_matches_reference(designs, quantize, with_layout, chunk):
    """Three fused batches with edge ids, one after another under one
    layout: every table, edge count and layout record as the reference's."""
    gj, gt = designs
    lj = jcollate.BucketLayout() if with_layout else None
    lt = tcollate.BucketLayout() if with_layout else None
    for sl in (slice(0, 2), slice(2, 4), slice(1, 3)):
        kw = dict(quantize=quantize, chunk=chunk, with_eids=True)
        bj = jcollate.collate_graphs(gj[sl], layout=lj, **kw)
        bt = tcollate.collate_graphs(gt[sl], layout=lt, device="cpu", **kw)
        _assert_batches_equal(bj, bt)
        if with_layout:
            assert dataclasses.asdict(lj) == dataclasses.asdict(lt)


@pytest.mark.parametrize("fused", [False, True])
def test_collate_filler_matches_reference(designs, fused):
    """A partial batch filled with copies of its last member (``n_real``),
    fused and quantized or exact bucketed."""
    gj, gt = designs
    kw = dict(fused=fused, quantize=fused, n_real=2)
    bj = jcollate.collate_graphs(gj[:2] + [gj[1]] * 2, **kw)
    bt = tcollate.collate_graphs(gt[:2] + [gt[1]] * 2, device="cpu", **kw)
    _assert_batches_equal(bj, bt)
    assert float(bt.cell_weight[bt.members[2].cell_off:].sum()) == 0.0


@pytest.mark.parametrize("extra_chunks,extra_blocks", [(0, 0), (5, 0),
                                                       (37, 3)])
def test_pad_fused_arena_matches_reference(designs, extra_chunks,
                                           extra_blocks):
    """Padding a plan's super-arena (it carries ``rel``) and an edge-id
    arena: the reference's tables; the walks stop where the unpadded
    arena's did and the padding rows' blocks walk nothing."""
    gj, gt = designs
    dst, src, _w = tell.ell_to_coo(gt[1].edges["near"].adj)
    n = gt[1].n_cell
    pairs = [(jcircuit.relation_plan_of(gj[1]).fwd,
              tcircuit.relation_plan_of(gt[1]).fwd),
             (jell.pack_fused_eid_pair(dst, src, n, n)[0],
              tell.pack_fused_eid_pair(dst, src, n, n)[0])]
    for a, b in pairs:
        n_c = b.n_chunks + extra_chunks
        n_r = b.n_arena_rows + extra_blocks * b.row_block
        pa = jell.pad_fused_arena(a, n_c, n_r)
        pb = tell.pad_fused_arena(b, n_c, n_r)
        assert_fused_equal(pa, pb)
        if a.eid is not None:
            assert np.array_equal(np.asarray(pa.eid), pb.eid)
        assert pb.nnz == -1 and pb.blk_end.shape == (pb.n_blocks,)
        np.testing.assert_array_equal(pb.blk_ptr[:b.n_blocks],
                                      b.blk_ptr[:-1])
        np.testing.assert_array_equal(pb.blk_end[:b.n_blocks],
                                      b.blk_ptr[1:])
        assert (pb.blk_end[b.n_blocks:] == n_c).all()
        assert (pb.blk_ptr[b.n_blocks:] == n_c).all()
        # padding a padded arena again keeps the walks
        pp = tell.pad_fused_arena(pb, n_c + 4, n_r + b.row_block)
        np.testing.assert_array_equal(pp.blk_end[:pb.n_blocks], pb.blk_end)
    with pytest.raises(ValueError):
        tell.pad_fused_arena(pairs[0][1], pairs[0][1].n_chunks - 1,
                             pairs[0][1].n_arena_rows)


def test_pack_fused_and_stats_match_reference(designs):
    """``pack_fused_pair`` gives the reference's arenas; ``degree_stats``
    and ``arena_stats`` (exact and padded arena, with its bucketed source)
    give its numbers."""
    gj, gt = designs
    dst, src, w = tell.ell_to_coo(gt[2].edges["near"].adj)
    n = gt[2].n_cell
    pj = jell.pack_fused_pair(dst, src, w, n, n)
    pt = tell.pack_fused_pair(dst, src, w, n, n)
    for a, b in zip(pj, pt):
        assert_fused_equal(a, b)
    sj, st = jell.degree_stats(dst, n), tell.degree_stats(dst, n)
    np.testing.assert_array_equal(st.pop("degrees"), sj.pop("degrees"))
    assert st == sj
    bj = jell.pack_ell(dst, src, w, n, n)
    bt = tell.pack_ell(dst, src, w, n, n)
    for a, b in ((pj[0], pt[0]), (jell.pad_fused_arena(pj[0], 500, 1600),
                                  tell.pad_fused_arena(pt[0], 500, 1600))):
        assert tell.arena_stats(b, bt) == jell.arena_stats(a, bj)


def test_arena_row_cap_matches_reference():
    for bounds in ((4, 16, 64, 256), (8,)):
        for br in (4, 8):
            for n in range(0, 600, 13):
                assert tcollate._arena_row_cap(n, bounds, br) == \
                    jcollate._arena_row_cap(n, bounds, br)


def test_layout_table_matches_reference():
    """The same touches on both tables: the same LRU order, evictions and
    ``on_evict`` calls; a touched bucket keeps its layout object."""
    keys = [("a",), ("b",), ("a",), ("c",), ("d",), ("a",), ("b",), ("b",),
            ("c",)]
    seen = []
    for mod in (jcollate, tcollate):
        ev = []
        tab = mod.LayoutTable(max_live=2,
                              on_evict=lambda k, v, ev=ev: ev.append(k))
        kept = {}
        for k in keys:
            lay = tab.get(k)
            if k in kept and kept[k][1] == tab.evictions:
                assert lay is kept[k][0]
            kept[k] = (lay, tab.evictions)
        seen.append((ev, list(tab.keys()), tab.evictions, len(tab)))
    assert seen[0] == seen[1]
    with pytest.raises(ValueError):
        tcollate.LayoutTable(max_live=0)


@pytest.mark.parametrize("quantize", [False, True])
def test_collate_without_edges_keeps_plan(designs, quantize):
    """``with_edges=False`` (the serve engine's plan path) packs no
    per-edge-type arena; the plan and the layout's plan records are the
    reference's, batch after batch under one layout."""
    gj, gt = designs
    lj, lt = jcollate.BucketLayout(), tcollate.BucketLayout()
    for sl in (slice(0, 2), slice(2, 4), slice(1, 3)):
        bj = jcollate.collate_graphs(gj[sl], quantize=quantize, layout=lj)
        bt = tcollate.collate_graphs(gt[sl], quantize=quantize, layout=lt,
                                     with_edges=False, device="cpu")
        assert bt.graph.edges == {}
        assert_plan_equal(bj.plan, bt.plan)
        for f in ("plan_chunk", "plan_min_chunks", "plan_tier"):
            assert getattr(lj, f) == getattr(lt, f)
    with pytest.raises(ValueError):
        tcollate.collate_graphs(gt[:2], with_edges=False, with_plan=False,
                                device="cpu")


@pytest.mark.parametrize("with_edges", [True, False])
@pytest.mark.parametrize("node_bits", [1, 2])
def test_signature_changes_match_reference(node_bits, with_edges):
    """A seeded stream of jittered graphs batched in pairs per shape bucket
    under per-bucket layouts: a batch brings a new signature to its bucket
    exactly where the reference's does, also when the port's batches carry
    only their plan (``with_edges=False``, as the serve engine collates
    them on the plan path)."""
    stream = _stream(16)
    layouts = ({}, {})
    seen = ({}, {})
    flags = ([], [])
    groups = {}
    for gj, gt in stream:
        key = (tcollate.quantize_up(gt.n_cell, node_bits),
               tcollate.quantize_up(gt.n_net, node_bits))
        groups.setdefault(key, []).append((gj, gt))
    for key, members in groups.items():
        for i in range(0, len(members) - 1):
            pair = members[i:i + 2]
            for side, mod in enumerate((jcollate, tcollate)):
                lay = layouts[side].setdefault(key, mod.BucketLayout())
                kw = {} if side == 0 else {"device": "cpu",
                                           "with_edges": with_edges}
                b = mod.collate_graphs([p[side] for p in pair],
                                       node_bits=node_bits, layout=lay,
                                       **kw)
                sigs = seen[side].setdefault(key, set())
                flags[side].append(b.signature not in sigs)
                sigs.add(b.signature)
    assert flags[0] == flags[1]
    if node_bits == 1:                        # the serve engine's grid:
        assert sum(flags[1]) < len(flags[1])  # its buckets converge


def test_signature_reads_shapes_not_values(designs):
    """Equal shapes give equal signatures whatever the tables hold; a
    changed static field (``nnz``) or shape changes it."""
    b = tcollate.collate_graphs(designs[1][:2], device="cpu")
    other = tcollate.map_graph_tensors(b.graph, lambda t: t + 1)
    assert tcollate.graph_signature(other) == b.signature
    near = b.graph.edges["near"]
    bumped = dataclasses.replace(b.graph, edges=dict(
        b.graph.edges, near=dataclasses.replace(
            near, adj=dataclasses.replace(near.adj, nnz=5))))
    assert tcollate.graph_signature(bumped) != b.signature
    assert len(tcollate.graph_tensors(b.graph)) == len(
        tcollate.graph_tensors(other))


def test_concat_edge_weights_and_split(designs):
    """Member weight vectors concatenate into the batch order and pad to
    the quantized count as in the reference; split_cell / split_net give
    the real members' rows."""
    gj, gt = designs
    bj = jcollate.collate_graphs(gj[:3], with_eids=True, n_real=2)
    bt = tcollate.collate_graphs(gt[:3], with_eids=True, n_real=2,
                                 device="cpu")
    rng = np.random.default_rng(4)
    for et in ETYPES:
        ws = [rng.normal(size=int(tell.ell_to_coo(g.edges[et].adj)[0]
                                  .shape[0])).astype(np.float32)
              for g in gt[:3]]
        a = np.asarray(bj.concat_edge_weights(et, [jnp.asarray(w)
                                                  for w in ws]))
        b = bt.concat_edge_weights(et, [torch.from_numpy(w) for w in ws])
        np.testing.assert_array_equal(b.numpy(), a)
        assert b.shape == (bt.edge_nnz[et],)
        with pytest.raises(ValueError):
            bt.concat_edge_weights(et, [torch.from_numpy(w) for w in ws[:2]])
    y = np.arange(bt.graph.n_cell, dtype=np.float32)
    yn = np.arange(bt.graph.n_net, dtype=np.float32)
    for a, b in zip(bj.split_cell(jnp.asarray(y)),
                    bt.split_cell(torch.from_numpy(y))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for a, b in zip(bj.split_net(jnp.asarray(yn)),
                    bt.split_net(torch.from_numpy(yn))):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert len(bt.split_cell(torch.from_numpy(y))) == 2


def test_learnable_collated_matches_members_and_reference(designs):
    """``drspmm_learnable`` over a collated batch's edge-id arenas with
    ``concat_edge_weights``: each member's rows equal the member's own
    product, and the output and both gradients equal the reference's."""
    gj, gt = designs
    bj = jcollate.collate_graphs(gj[:2], with_eids=True)
    bt = tcollate.collate_graphs(gt[:2], with_eids=True, device="cpu")
    rng = np.random.default_rng(9)
    n, dim = bt.graph.n_cell, HIDDEN
    x = rng.normal(size=(n, dim)).astype(np.float32)
    xi = np.sort(np.argsort(-x, axis=1, kind="stable")[:, :K],
                 axis=1).astype(np.int32)
    xv = np.take_along_axis(x, xi, axis=1)
    member_ws = [rng.random(int(tell.ell_to_coo(g.edges["near"].adj)[0]
                                .shape[0])).astype(np.float32) + 0.1
                 for g in gt[:2]]
    es = bt.graph.edges["near"]
    nnz = bt.edge_nnz["near"]
    w = bt.concat_edge_weights("near", [torch.from_numpy(v)
                                        for v in member_ws])
    w.requires_grad_(True)
    v = torch.from_numpy(xv).requires_grad_(True)
    y = tops.drspmm_learnable(es.adj, es.adj_t, nnz, w, v,
                              torch.from_numpy(xi), dim)
    gy = rng.normal(size=tuple(y.shape)).astype(np.float32)
    y.backward(torch.from_numpy(gy))
    for m, g, mw in zip(bt.members, gt[:2], member_ws):
        dst, src, _ = tell.ell_to_coo(g.edges["near"].adj)
        f, ft, _order, m_nnz = tell.pack_fused_eid_pair(dst, src, g.n_cell,
                                                        g.n_cell)
        sl = slice(m.cell_off, m.cell_off + m.n_cell)
        ym = tops.drspmm_learnable(f, ft, m_nnz, torch.from_numpy(mw),
                                   torch.from_numpy(xv[sl]),
                                   torch.from_numpy(xi[sl]), dim)
        assert_close(y[sl].detach().numpy(), ym.numpy())
    ej = bj.graph.edges["near"]
    wj = bj.concat_edge_weights("near", [jnp.asarray(v) for v in member_ws])
    yj, vjp = jax.vjp(lambda ww, vv: jops.drspmm_learnable(
        ej.adj, ej.adj_t, nnz, ww, vv, jnp.asarray(xi), dim,
        backend="xla_fused"), wj, jnp.asarray(xv))
    gw, gv = vjp(jnp.asarray(gy))
    assert_close(y.detach().numpy(), np.asarray(yj))
    assert_close(w.grad.numpy(), np.asarray(gw))
    assert_close(v.grad.numpy(), np.asarray(gv))


# ---------------------------------------------------------------------------
# padded arenas: the walk skips the padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [K, 40])
def test_padded_walk_skips_padding(designs, k):
    """A quantized batch's super-arenas: the schedule's runs cover exactly
    the exact-size arena's chunks (the padding chunks are walked by no
    block), and kernels 1 and 4 (plain) give the exact batch's real rows
    bit for bit, at k <= 32 and above (the kernels' narrow and wide
    walks)."""
    gt = designs[1][:2]
    be = tcollate.collate_graphs(gt, quantize=False, device="cpu")
    bp = tcollate.collate_graphs(gt, device="cpu")
    for fe, fp in ((be.plan.fwd, bp.plan.fwd), (be.plan.bwd, bp.plan.bwd)):
        sched = tk._arena_sched(fp)
        run = sched[:, 2] - sched[:, 1]
        assert run.sum().item() == fe.n_chunks < fp.n_chunks
        assert (run[1:] <= run[:-1]).all()
    for a, b in padded_and_exact_rows(be, bp, k, dim=64):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_model_on_padded_batch_matches_exact(params, designs):
    """The model over a quantized batch gives the exact batch's member
    rows (the padding is inert) under the plan path and the serial one."""
    model = _port_model(params)
    gt = designs[1][:3]
    exact = tcollate.collate_graphs(gt, quantize=False, device="cpu")
    padded = tcollate.collate_graphs(gt, device="cpu")
    for kw in ({}, {"use_plan": False}):
        cfg = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K, **kw)
        with torch.no_grad():
            ye = model(exact.graph, cfg)
            yp = model(padded.graph, cfg)
        for a, b in zip(exact.split_cell(ye), padded.split_cell(yp)):
            assert_close(b.numpy(), a.numpy())


# ---------------------------------------------------------------------------
# batched training and serving under every backend
# ---------------------------------------------------------------------------

SERIAL_CONFIGS = [dict(backend="bucket"), dict(use_plan=False),
                  dict(backend="bucket", k_net=HIDDEN)]
SERIAL_IDS = ["bucket", "serial", "bucket-knet_hidden"]


@pytest.mark.parametrize("kw", SERIAL_CONFIGS, ids=SERIAL_IDS)
def test_batched_grads_match_reference(params, designs, calls, kw):
    """``jax.grad`` of the reference's batched loss over its collated
    batch against ``loss.backward()`` over the port's: the fused kernels
    run (the arena forward and backward), no per-bucket kernel."""
    kw = dict(dict(hidden=HIDDEN, k_cell=K, k_net=K), **kw)
    jcfg = JConfig(**dict(kw, backend=JAX_BACKEND[kw.get("backend",
                                                          "fused")]))
    tcfg = HeteroMPConfig(**kw)
    gj, gt = designs
    jb = jcollate.collate_graphs(gj[1:3])
    tb = tcollate.collate_graphs(gt[1:3], device="cpu")
    lj, gradj = jax.value_and_grad(j_batched_loss_fn)(
        params, jb.graph, jb.cell_weight, jcfg)
    model = _port_model(params)
    lt = batched_loss_fn(model, tb.graph, tb.cell_weight, tcfg)
    model.zero_grad(set_to_none=True)
    lt.backward()
    assert_close(lt.item(), float(lj))
    ref = _flat(gradj)
    for n, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        assert_close(g.numpy(), ref[n], n)
    assert calls["drspmm_fwd_arena"] > 0 and calls["drspmm_bwd_arena"] > 0
    assert all(calls[k] == 0 for k in BUCKET_KERNELS)


@pytest.mark.parametrize("kw", SERIAL_CONFIGS[:2], ids=SERIAL_IDS[:2])
def test_batched_trainer_matches_reference(designs, calls, kw):
    """Two epochs of batches of two from the same weights: every step's
    loss and the final parameters against the JAX trainer's."""
    kw = dict(dict(hidden=HIDDEN, k_cell=K, k_net=K, lr=1e-3, epochs=2,
                   batch_size=2), **kw)
    jkw = dict(kw, backend=JAX_BACKEND[kw.get("backend", "fused")])
    jt = jtrainer.CircuitTrainer(jtrainer.CircuitTrainConfig(**jkw), 16, 16)
    tt = CircuitTrainer(CircuitTrainConfig(**kw), 16, 16,
                        model=_port_model(jt.params), device="cpu")
    gj, gt = designs[0][:4], designs[1][:4]
    for _ep in range(2):
        assert_close(tt.train_epoch(gt), jt.train_epoch(gj))
    assert tt.opt_state.step == int(jt.opt_state.step) == 4
    ref = _flat(jt.params)
    for n, p in tt.model.named_parameters():
        assert_close(p.detach().numpy(), ref[n], n)
    for _g, (graph, _w, _n) in tt._batch_cache.values():
        assert isinstance(graph.edges["near"].adj, tell.FusedELL)
    assert all(calls[k] == 0 for k in BUCKET_KERNELS)


@pytest.mark.parametrize("kw", SERIAL_CONFIGS[:2], ids=SERIAL_IDS[:2])
def test_engine_serves_serial_configs(params, designs, calls, kw):
    """The engine accepts ``backend="bucket"`` and ``use_plan=False``:
    three requests in batches of two, filler included, each served the
    reference's prediction of its own graph through the fused kernels."""
    kw = dict(dict(hidden=HIDDEN, k_cell=K, k_net=K), **kw)
    jcfg = JConfig(**dict(kw, backend=JAX_BACKEND[kw.get("backend",
                                                          "fused")]))
    eng = CircuitServeEngine(_port_model(params), HeteroMPConfig(**kw),
                             max_batch=2, device="cpu")
    rids = [eng.submit(g) for g in designs[1][2:]]
    done = eng.run()
    for rid, gj in zip(rids, designs[0][2:]):
        assert done[rid].error is None
        np.testing.assert_allclose(
            done[rid].pred, np.asarray(drcircuitgnn_forward(params, gj, jcfg)),
            rtol=0, atol=1e-5)
    assert calls["drspmm_fwd_arena"] > 0
    assert all(calls[k] == 0 for k in BUCKET_KERNELS)


def test_engine_compiles_match_reference(params):
    """A jittered stream through both engines, one drained batch at a time
    (a pair of one bucket, or a graph alone with its filler), with
    ``max_live_buckets`` 1 and 2: ``compiles``, ``evictions`` and
    ``live_buckets`` equal after every batch, and every prediction equal
    to the reference engine's."""
    stream = _stream(12, seed=3)
    for max_live in (1, 2):
        jeng = JEngine(params, JConfig(hidden=HIDDEN, k_cell=K, k_net=K,
                                       backend="xla_fused"),
                       max_batch=2, max_live_buckets=max_live)
        teng = CircuitServeEngine(_port_model(params),
                                  HeteroMPConfig(hidden=HIDDEN, k_cell=K,
                                                 k_net=K),
                                  max_batch=2, max_live_buckets=max_live,
                                  device="cpu")
        batches, i = [], 0
        while i < len(stream):
            pair = stream[i:i + 2]
            if len(pair) == 2 and teng._group_key(pair[0][1]) != \
                    teng._group_key(pair[1][1]):
                pair = pair[:1]
            batches.append(pair)
            i += len(pair)
        counts = ([], [])
        for pair in batches:
            preds = []
            for side, eng in enumerate((jeng, teng)):
                rids = [eng.submit(p[side]) for p in pair]
                done = eng.run()
                counts[side].append((eng.compiles, eng.evictions,
                                     eng.live_buckets))
                preds.append([np.asarray(done[r].pred) for r in rids])
                assert all(done[r].error is None for r in rids)
            for a, b in zip(*preds):
                np.testing.assert_allclose(b, a, rtol=0, atol=1e-5)
        assert counts[0] == counts[1]
        assert len(teng._buckets) <= max_live
        assert counts[1][-1][1] > 0                 # evictions happened
    assert counts[1][-1][0] < len(batches)          # and reuse


def test_engine_prefetch_eviction_keeps_no_state(params):
    """Alternating shape buckets through one ``run()`` with one live
    bucket: the packing pool evicts a bucket while its batch waits for
    dispatch.  Every prediction is the reference's forward of its own
    graph, and no evicted bucket's state outlives the run."""
    stream = _stream(12, seed=3)
    cfg = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K)
    jcfg = JConfig(hidden=HIDDEN, k_cell=K, k_net=K, backend="xla_fused")
    eng = CircuitServeEngine(_port_model(params), cfg, max_batch=2,
                             max_live_buckets=1, device="cpu")
    rids = [eng.submit(gt) for _gj, gt in stream]
    done = eng.run()
    for rid, (gj, _gt) in zip(rids, stream):
        assert done[rid].error is None
        np.testing.assert_allclose(
            done[rid].pred, np.asarray(drcircuitgnn_forward(params, gj, jcfg)),
            rtol=0, atol=1e-5)
    assert eng.evictions > 0 and eng.live_buckets == 1
    assert len(eng._buckets) <= 1
    assert all(st.pending == 0 and not st.evicted
               for st in eng._buckets.values())


# ---------------------------------------------------------------------------
# K profiling (Sec. 4.3)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [1, 2, 16, 48, 64, 256])
def test_candidate_ks_match(dim):
    assert tdrelu.candidate_ks(dim) == jdrelu.candidate_ks(dim)


def test_cost_model_and_profile_match():
    rng = np.random.default_rng(0)
    for _ in range(20):
        n, nnz, k, dim = (int(rng.integers(1, 5000)), int(rng.integers(0,
                          50000)), int(rng.integers(1, 64)), 64)
        maxd, mean = int(rng.integers(1, 300)), float(rng.uniform(0, 20))
        assert tdrelu.kernel_cost_model(n, nnz, k, dim, maxd, mean) == \
            jdrelu.kernel_cost_model(n, nnz, k, dim, maxd, mean)
        deg = rng.zipf(1.5 + rng.random(), size=n) % 500
        for d in (16, 64):
            assert tdrelu.profile_optimal_k(deg, d) == \
                jdrelu.profile_optimal_k(deg, d)
    stats = {"near": {"degrees": rng.integers(1, 90, 300),
                      "src_type": "cell"},
             "pinned": {"degrees": rng.integers(1, 5, 300),
                        "src_type": "net"}}
    dims = {"cell": 64, "net": 32}
    assert tdrelu.hetero_k_values(stats, dims) == \
        jdrelu.hetero_k_values(stats, dims)


@pytest.mark.parametrize("hidden", [32, 64])
def test_profile_k_matches_reference(hidden):
    gj = jgen.generate_design(5, "small", scale=0.04)
    gt = tgen.generate_design(5, "small", scale=0.04)
    jt = jtrainer.CircuitTrainer(jtrainer.CircuitTrainConfig(hidden=hidden),
                                 16, 16)
    tt = CircuitTrainer(CircuitTrainConfig(hidden=hidden), 16, 16,
                        device="cpu")
    ks = tt.profile_k(gt)
    assert ks == jt.profile_k(gj)
    assert (tt.mp_cfg.k_cell, tt.mp_cfg.k_net) == (ks["cell"], ks["net"])


def test_auto_k_fit_trains_with_profiled_k(designs):
    """``auto_k=True``: ``fit`` profiles first and trains with the
    reference's K on batches of two."""
    gj, gt = designs
    tt = CircuitTrainer(CircuitTrainConfig(hidden=HIDDEN, epochs=1,
                                           auto_k=True, batch_size=2),
                        16, 16, device="cpu")
    out = tt.fit(gt[:4])
    jt = jtrainer.CircuitTrainer(jtrainer.CircuitTrainConfig(hidden=HIDDEN),
                                 16, 16)
    ks = jt.profile_k(gj[:4])
    assert (tt.mp_cfg.k_cell, tt.mp_cfg.k_net) == (ks["cell"], ks["net"])
    assert np.isfinite(out["final"]["loss"]) and tt.opt_state.step == 2
