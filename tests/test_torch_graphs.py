"""PyTorch port, host-side packing: the generator, the relation plan and
the collated batch must equal the JAX package's table for table."""

import numpy as np
import pytest
import torch

import repro.graphs.circuit as jcircuit
import repro.graphs.collate as jcollate
import repro.graphs.ell as jell
import repro.graphs.generator as jgen
import repro_torch.graphs.circuit as tcircuit
import repro_torch.graphs.collate as tcollate
import repro_torch.graphs.ell as tell
import repro_torch.graphs.generator as tgen
from _torch_port import SCALE, assert_plan_equal

DESIGNS = [(0, "small"), (1, "medium")]


@pytest.mark.parametrize("seed,size", DESIGNS)
def test_generator_identical(seed, size):
    for gj, gt in zip(jgen.generate_design(seed, size, SCALE),
                      tgen.generate_design(seed, size, SCALE)):
        assert (gj.n_cell, gj.n_net) == (gt.n_cell, gt.n_net)
        for f in ("x_cell", "x_net", "y_cell"):
            assert np.array_equal(np.asarray(getattr(gj, f)),
                                  getattr(gt, f).numpy()), f
        for et in tcircuit.EDGE_TYPES:
            for d in ("adj", "adj_t"):
                bj = getattr(gj.edges[et], d)
                bt = getattr(gt.edges[et], d)
                assert (bj.n_dst, bj.n_src, bj.nnz) == \
                    (bt.n_dst, bt.n_src, bt.nnz)
                assert len(bj.buckets) == len(bt.buckets)
                for x, y in zip(bj.buckets, bt.buckets):
                    for f in ("rows", "nbr", "w"):
                        assert np.array_equal(np.asarray(getattr(x, f)),
                                              getattr(y, f)), (et, d, f)


@pytest.mark.parametrize("seed,size", DESIGNS)
def test_relation_plan_tables_equal(seed, size):
    tiers = set()
    for gj, gt in zip(jgen.generate_design(seed, size, SCALE),
                      tgen.generate_design(seed, size, SCALE)):
        pj, pt = jcircuit.relation_plan_of(gj), tcircuit.relation_plan_of(gt)
        assert_plan_equal(pj, pt)
        tiers |= {s.tier for s in pt.segments}
        for a, b in zip(jell.plan_to_coo(pj), tell.plan_to_coo(pt)):
            assert np.array_equal(np.asarray(a), b)
        assert np.array_equal(pj.to_dense(), pt.to_dense())
    assert tiers == {"arena", "dense"}      # mixed-tier plans at this scale


def _relations(rng, n_cell, n_net, nnz_pin):
    """near (arena-sized), pin with exactly ``nnz_pin`` distinct edges,
    pinned = pinᵀ; unit-free random weights."""
    def mk(n_dst, n_src, nnz):
        flat = rng.choice(n_dst * n_src, size=nnz, replace=False)
        w = rng.uniform(0.1, 1.0, nnz).astype(np.float32)
        return flat // n_src, flat % n_src, w
    nd, ns, nw = mk(n_cell, n_cell, 6000)
    pd, ps, pw = mk(n_net, n_cell, nnz_pin)
    return [("near", "cell", "cell", nd, ns, nw),
            ("pin", "cell", "net", pd, ps, pw),
            ("pinned", "net", "cell", ps, pd, pw)]


@pytest.mark.parametrize("delta", [-1, 0, 1])
def test_plan_tier_straddle(delta):
    """nnz = DENSE_TIER_NNZ + delta: at or below it the relation goes
    dense, one above it goes to the arena -- in both packages alike."""
    nnz = tell.DENSE_TIER_NNZ + delta
    rels = _relations(np.random.default_rng(7), 300, 200, nnz)
    n_of = {"cell": 300, "net": 200}
    pj = jell.build_relation_plan(rels, n_of)
    pt = tell.build_relation_plan(rels, n_of)
    assert_plan_equal(pj, pt)
    want = "dense" if delta <= 0 else "arena"
    assert pt.segment("pin").tier == want
    assert pt.segment("pinned").tier == want
    assert pt.segment("near").tier == "arena"


@pytest.mark.parametrize("seed,size", DESIGNS)
def test_collate_tables_equal(seed, size):
    gj = jgen.generate_design(seed, size, SCALE)
    gt = tgen.generate_design(seed, size, SCALE)
    bj = jcollate.collate_graphs(gj, quantize=False)
    bt = tcollate.collate_graphs(gt, quantize=False, device="cpu")
    assert_plan_equal(bj.graph.plan, bt.graph.plan)
    assert [tuple(vars(m).values()) for m in bj.members] == \
        [tuple(vars(m).values()) for m in bt.members]
    for f in ("x_cell", "x_net", "y_cell"):
        assert np.array_equal(np.asarray(getattr(bj.graph, f)),
                              getattr(bt.graph, f).numpy()), f


@pytest.mark.parametrize("quantum", [1, 2])
def test_quantize_up_matches(quantum):
    for n in range(1, 3000, 7):
        assert tcollate.quantize_up(n, quantum) == \
            jcollate.quantize_up(n, quantum)


def test_blk_ptr_covers_each_block():
    """blk_ptr[b]..blk_ptr[b+1] is exactly the chunk run of block b, and the
    trailing sentinel block owns one all-zero chunk."""
    g = tgen.generate_design(0, "small", SCALE)[0]
    f = tcircuit.relation_plan_of(g).fwd
    assert f.blk_ptr.shape == (f.n_blocks + 1,)
    for b in range(f.n_blocks):
        run = np.arange(f.blk_ptr[b], f.blk_ptr[b + 1])
        assert np.all(f.block_of[run] == b)
        assert (np.count_nonzero(f.block_of == b)) == run.size
    assert f.block_of[-1] == f.n_blocks - 1 and not f.w[-1].any()


def test_collate_places_members():
    """Member i's rows sit at its offsets in the collated node spaces."""
    gt = tgen.generate_design(1, "medium", SCALE)
    bt = tcollate.collate_graphs(gt, quantize=False, device="cpu")
    assert (bt.graph.n_cell, bt.graph.n_net) == \
        (sum(g.n_cell for g in gt), sum(g.n_net for g in gt))
    for g, m in zip(gt, bt.members):
        assert torch.equal(g.x_cell, bt.graph.x_cell[m.cell_off:m.cell_off
                                                     + m.n_cell])
        assert torch.equal(g.x_net, bt.graph.x_net[m.net_off:m.net_off
                                                   + m.n_net])
