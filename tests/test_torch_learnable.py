"""PyTorch port, learnable edge weights: the edge-id arenas against the JAX
package's (table for table), their round trip, the plain versions of the
learnable forward, dx and dw kernels against the reference's Pallas
kernels (interpret mode) and its XLA arena walks (the dx kernel also over
a skewed transposed arena at the GAT shape), and
``drspmm_learnable`` (values and both gradients) against ``jax.vjp`` of
the reference op.  The CUDA kernels are held against these plain versions
on a card in tests/test_torch_cuda.py.

Tolerance: fp32, rtol 1e-5 and atol 1e-5 (scaled by the output's
magnitude) -- the two sides sum the same products in another order."""

import dataclasses
import gc

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

try:
    from hypothesis import example, given, settings, strategies as st
except ImportError:                      # bare container: seeded fallback
    from _hyp_fallback import given, settings, strategies as st
    example = None

import repro.graphs.ell as jell
from repro.kernels import drspmm as jk
from repro.kernels import ops as jops
import repro_torch.graphs.ell as tell
from repro_torch.kernels import drspmm as tk
from repro_torch.kernels import learnable as tlearn
from repro_torch.kernels import ops as tops
from _torch_port import assert_close, assert_fused_equal

DIM = 32


def _edges(seed, n_dst, n_src, n_target):
    """Unique random (dst, src) pairs in a shuffled (unsorted) order."""
    rng = np.random.default_rng(seed)
    pairs = np.unique(np.stack([rng.integers(0, n_dst, n_target),
                                rng.integers(0, n_src, n_target)], 1), axis=0)
    pairs = pairs[rng.permutation(len(pairs))]
    return pairs[:, 0], pairs[:, 1]


def _packs(seed=0, n_dst=61, n_src=47, n_target=700):
    dst, src = _edges(seed, n_dst, n_src, n_target)
    return (jell.pack_fused_eid_pair(dst, src, n_dst, n_src),
            tell.pack_fused_eid_pair(dst, src, n_dst, n_src))


def _operands(seed, n, k, dim=DIM, iota=False):
    """CBSR (vals, idx) numpy operand (n, k): the identity indices of a
    dense matrix (k = dim) or k random columns per row."""
    rng = np.random.default_rng(seed)
    vals = rng.normal(size=(n, k)).astype(np.float32)
    if iota:
        idx = np.broadcast_to(np.arange(k, dtype=np.int32), (n, k)).copy()
    else:
        idx = np.sort(np.stack([rng.choice(dim, k, replace=False)
                                for _ in range(n)]), 1).astype(np.int32)
    return vals, idx


def _assert_eid_pair_equal(a, b):
    for x, y in zip(a[:2], b[:2]):
        assert_fused_equal(x, y)
        assert x.eid.dtype == y.eid.dtype == np.int32
        assert np.array_equal(np.asarray(x.eid), y.eid)
    assert np.array_equal(a[2], b[2]) and a[3] == b[3]


@pytest.mark.parametrize("shape", [(61, 47, 700), (40, 40, 300), (9, 90, 200),
                                   (1, 1, 1)])
def test_eid_arenas_match_reference(shape):
    """Table for table, padding -1 in ``eid`` and ``w`` the 0/1 mask."""
    (ja, ta) = _packs(3, *shape)
    _assert_eid_pair_equal(ja, ta)
    for f in ta[:2]:
        assert np.array_equal(f.w, (f.eid >= 0).astype(np.float32))
        assert f.eid.min() >= -1


def test_eid_slabs_and_decode_match_reference():
    dst, src = _edges(5, 30, 20, 200)
    a = jell.pack_eid_slabs(dst, src, 30, 20)
    b = tell.pack_eid_slabs(dst, src, 30, 20)
    for x, y in zip(a[:2], b[:2]):
        for bx, by in zip(x.buckets, y.buckets):
            assert np.array_equal(np.asarray(bx.w), by.w)
            assert np.array_equal(np.asarray(jell.decode_eids(bx.w)),
                                  tell.decode_eids(by.w))
    assert np.array_equal(a[2], b[2]) and a[3] == b[3]


def test_fuse_memo_hits_and_evicts():
    dst, src = _edges(7, 30, 30, 150)
    fwd, _bwd, _o, _n = tell.pack_eid_slabs(dst, src, 30, 30)
    f1 = tell.fuse_bucketed(fwd, eids=True)
    assert tell.fuse_bucketed(fwd, eids=True) is f1
    assert tell.fuse_bucketed(fwd) is not f1          # other layout key
    n = len(tell._FUSE_CACHE)
    del fwd, f1
    gc.collect()
    assert len(tell._FUSE_CACHE) == n - 2


rt_graphs = st.integers(0, 2 ** 31 - 1).flatmap(lambda seed: st.tuples(
    st.just(seed), st.integers(1, 40), st.integers(1, 40),
    st.integers(0, 200)))


def _roundtrip(seed, n_dst, n_src, nnz_t):
    """Scattering w[eid] over each fused arena rebuilds exactly the dense
    A(w) of the canonical COO: A for the forward arena and Aᵀ for the
    transposed one -- the oracle is picked by direction, never by shape
    (when n_dst == n_src the two shapes agree)."""
    rng = np.random.default_rng(seed)
    if nnz_t:
        dst, src = _edges(seed, n_dst, n_src, nnz_t)
    else:
        dst = src = np.zeros(0, np.int64)
    ff, fb, order, nnz = tell.pack_fused_eid_pair(dst, src, n_dst, n_src)
    w = rng.normal(size=nnz).astype(np.float32)
    canon = np.argsort(dst, kind="stable")
    a_ref = np.zeros((n_dst, n_src), np.float32)
    np.add.at(a_ref, (dst[canon], src[canon]), w)
    for f, ref in ((ff, a_ref), (fb, a_ref.T)):
        a = np.zeros(ref.shape, np.float32)
        slot_rows = f.rows[f.block_of[:, None] * f.row_block
                           + np.arange(f.row_block)]
        m = f.eid >= 0
        np.add.at(a, (np.broadcast_to(slot_rows[:, :, None], f.eid.shape)[m],
                      f.nbr[m]), w[f.eid[m]])
        np.testing.assert_allclose(a, ref, atol=1e-6)
    assert ff.nnz == fb.nnz == nnz == dst.shape[0]
    assert np.array_equal(dst[order], np.sort(dst, kind="stable"))


@settings(max_examples=50, deadline=None)
@given(rt_graphs)
def test_fused_eid_packing_roundtrip(args):
    _roundtrip(*args)


if example is not None:
    test_fused_eid_packing_roundtrip = example((0, 2, 2, 2))(
        test_fused_eid_packing_roundtrip)


@pytest.mark.parametrize("args", [(0, 2, 2, 2), (1, 17, 17, 120),
                                  (2, 5, 30, 80)])
def test_fused_eid_packing_roundtrip_square(args):
    """Explicit cases, the square (n_dst == n_src) one that fools a
    shape-picked oracle among them."""
    _roundtrip(*args)


@pytest.mark.parametrize("iota", [False, True], ids=["cbsr", "dense"])
def test_learnable_fwd_plain_matches_pallas(iota):
    (jf, jb, _o, nnz), (tf, tb, _o2, _n) = _packs(1)
    k = DIM if iota else 6
    xv, xi = _operands(2, tf.n_src, k, iota=iota)
    w = np.random.default_rng(4).normal(size=nnz).astype(np.float32)
    ref = np.asarray(jk.drspmm_fwd_learnable_fused(
        jf, nnz, jnp.asarray(w), jnp.asarray(xv), jnp.asarray(xi), DIM))
    ref_x = np.asarray(jops._fwd_learnable_fused_xla(
        jf, nnz, jnp.asarray(w), jnp.asarray(xv), jnp.asarray(xi), DIM))
    before = tk.drspmm_fwd_learnable.launches
    out = tk.drspmm_fwd_learnable(tf.to("cpu"), nnz, torch.from_numpy(w),
                                  torch.from_numpy(xv),
                                  torch.from_numpy(xi), DIM)
    assert tk.drspmm_fwd_learnable.launches == before   # CPU: plain version
    assert out.shape == (tf.n_arena_rows, DIM)
    assert_close(out.numpy(), ref)
    assert_close(out.numpy()[tf.gather], ref_x)


@pytest.mark.parametrize("k", [6, DIM])
def test_learnable_bwd_plain_matches_pallas(k):
    (jf, jb, _o, nnz), (tf, tb, _o2, _n) = _packs(2)
    _, xi = _operands(3, tf.n_src, k, iota=k == DIM)
    w = np.random.default_rng(5).normal(size=nnz).astype(np.float32)
    gy = np.random.default_rng(6).normal(size=(tf.n_dst, DIM)).astype(
        np.float32)
    xi_arena = jnp.take(jnp.asarray(xi), jnp.asarray(jb.rows), axis=0)
    ref = np.asarray(jk.drspmm_bwd_learnable_fused(
        jb, nnz, jnp.asarray(w), jnp.asarray(gy), xi_arena))
    ref_x = np.asarray(jops._bwd_x_learnable_fused_xla(
        jb, nnz, jnp.asarray(w), jnp.asarray(gy), jnp.asarray(xi)))
    out = tk.drspmm_bwd_learnable(tb.to("cpu"), nnz, torch.from_numpy(w),
                                  torch.from_numpy(gy), torch.from_numpy(xi))
    assert out.shape == (tb.n_arena_rows, k)
    assert_close(out.numpy(), ref)
    assert_close(out.numpy()[tb.gather], ref_x)


def _skewed_t_packs(seed=3, n=300, n_long=8):
    """Transposed edge-id arenas (the JAX package's, the port's) at Ec 4 of
    a graph as skewed as the homogenized Table-1 partition: ``n_long``
    sources of 240-270 out-edges among ones of 1-12, so the long rows end
    mid-batch and mid-window of the wide backward walk; every other
    row-block is then left empty (blocks 2b hold the packed blocks b)."""
    rng = np.random.default_rng(seed)
    deg = np.concatenate([rng.integers(240, 271, n_long),
                          rng.integers(1, 13, n - n_long)])
    src = np.repeat(np.arange(n), deg)
    dst = np.concatenate([rng.choice(n, d, replace=False) for d in deg])
    perm = rng.permutation(src.size)
    out = []
    for pack, extra in ((jell.pack_fused_eid_pair, {}),
                        (tell.pack_fused_eid_pair, {"blk_ptr": None})):
        _f, b, _o, nnz = pack(dst[perm], src[perm], n, n, chunk=4)
        out.append(dataclasses.replace(
            b, block_of=2 * np.asarray(b.block_of),
            rows=np.concatenate([np.asarray(b.rows)] * 2), **extra))
    return out[0], out[1].to("cpu"), nnz


@pytest.mark.parametrize("cols", ["iota", "perm"])
def test_learnable_bwd_skewed_arena_matches_pallas(cols):
    """Kernel 8 at the GAT shape (k = dim = 64) over long transposed rows
    and empty row-blocks: the port (its plain version on the CPU) against
    the Pallas kernel in interpret mode, with the GAT operand's iota
    columns and with each row's columns permuted.  The Pallas grid walks
    chunks, so it never writes a row-block that has none: there the port
    must give exactly 0."""
    jb, tb, nnz = _skewed_t_packs()
    runs = np.diff(tb.blk_ptr.numpy())
    assert runs.max() * 4 >= 240 and (runs == 0).sum() > 1
    rng = np.random.default_rng(14)
    w = rng.normal(size=nnz).astype(np.float32)
    gy = rng.normal(size=(tb.n_src, 64)).astype(np.float32)
    xi = np.broadcast_to(np.arange(64, dtype=np.int32), (tb.n_dst, 64))
    if cols == "perm":
        xi = np.argsort(rng.random((tb.n_dst, 64)), axis=1)
    xi = np.ascontiguousarray(xi, dtype=np.int32)
    ref = np.asarray(jk.drspmm_bwd_learnable_fused(
        jb, nnz, jnp.asarray(w), jnp.asarray(gy),
        jnp.take(jnp.asarray(xi), jnp.asarray(jb.rows), axis=0)))
    before = tk.drspmm_bwd_learnable.launches
    out = tk.drspmm_bwd_learnable(tb, nnz, torch.from_numpy(w),
                                  torch.from_numpy(gy),
                                  torch.from_numpy(xi)).numpy()
    assert tk.drspmm_bwd_learnable.launches == before   # CPU: plain version
    empty = np.repeat(runs == 0, tb.row_block)
    assert_close(out[~empty], ref[~empty])
    assert np.all(out[empty] == 0.0)


@pytest.mark.parametrize("k", [6, DIM, 37, 100])
def test_learnable_dw_plain_matches_pallas(k):
    """k 37 and 100 (beyond DIM, the CBSR columns drawn from dim 64 and
    128) hold the plain version, the card tests' oracle of kernel 9, at
    the lane-group widths kernel 9 takes above k 32."""
    dim = {37: 64, 100: 128}.get(k, DIM)
    (jf, jb, _o, nnz), (tf, tb, _o2, _n) = _packs(4)
    xv, xi = _operands(7, tf.n_src, k, dim, iota=k == DIM)
    gy = np.random.default_rng(8).normal(size=(tf.n_dst, dim)).astype(
        np.float32)
    gy_arena = jnp.take(jnp.asarray(gy), jnp.asarray(jf.rows), axis=0)
    contrib = jk.drspmm_dw_learnable_fused(jf, gy_arena, jnp.asarray(xv),
                                           jnp.asarray(xi))
    ref = np.asarray(jops._dw_contrib_to_canon(jf, nnz, contrib))
    ref_x = np.asarray(jops._dw_learnable_fused_xla(
        jf, nnz, jnp.asarray(gy), jnp.asarray(xv), jnp.asarray(xi)))
    out = tk.drspmm_dw_learnable(tf.to("cpu"), nnz, torch.from_numpy(gy),
                                 torch.from_numpy(xv), torch.from_numpy(xi))
    assert out.shape == (nnz,)
    assert_close(out.numpy(), ref)
    assert_close(out.numpy(), ref_x)


@pytest.mark.parametrize("skewed", [False, True])
def test_dw_sched_lists_each_slot_once(skewed):
    """Kernel 9's work list: one row a slot, every canonical id once, the
    real slots in destination order and the padding last; the sums its rows
    name (a slot's source CBSR row against its destination's gY row) are
    the plain version's."""
    if skewed:      # rows of 240-270 slots, every other row-block empty
        rng = np.random.default_rng(3)
        deg = np.concatenate([rng.integers(240, 271, 8),
                              rng.integers(1, 13, 292)])
        dst = np.repeat(np.arange(300), deg)
        src = np.concatenate([rng.choice(300, d, replace=False)
                              for d in deg])
        f = tell.pack_fused_eid_pair(dst, src, 300, 300, chunk=4)[0]
        f = dataclasses.replace(f, block_of=2 * f.block_of,
                                rows=np.concatenate([f.rows] * 2),
                                blk_ptr=None)
    else:
        f = _packs(4)[1][0]
    f = f.to("cpu")
    nnz = int((f.eid >= 0).sum())
    sched = tk._dw_sched(f)
    assert sched.dtype == torch.int32 and sched.shape == (f.eid.numel(), 4)
    ids, src, dst = sched[:, 0], sched[:, 1].long(), sched[:, 2].long()
    real = ids >= 0
    assert int(real.sum()) == nnz and bool(real[:nnz].all())
    assert torch.equal(ids[:nnz].sort().values, torch.arange(
        nnz, dtype=torch.int32))
    assert bool((dst[1:nnz] >= dst[:nnz - 1]).all())
    assert tk._dw_sched(f) is sched                     # built once
    rng = np.random.default_rng(17)
    xv, xi = _operands(18, f.n_src, 6)
    gy = torch.from_numpy(rng.normal(size=(f.n_dst, DIM)).astype(np.float32))
    xv, xi = torch.from_numpy(xv), torch.from_numpy(xi).long()
    gw = torch.empty(nnz)
    gw[ids[:nnz].long()] = (gy[dst[:nnz, None], xi[src[:nnz]]]
                            * xv[src[:nnz]]).sum(1)
    assert_close(gw.numpy(), tk.drspmm_dw_learnable_plain(
        f, nnz, gy, xv, xi.int()).numpy())


@pytest.mark.parametrize("reuse", ["inference", "training"])
def test_scheds_of_inference_tables(reuse):
    """Kernel 1's schedule and kernel 9's work list build on arena tables
    made under ``torch.inference_mode()`` (as a model's plan moved there
    is), inside it and after it, equal to those of ordinary tables and
    built once."""
    f = _packs(4)[1][0]
    want = (tk._arena_sched(f.to("cpu")), tk._dw_sched(f.to("cpu")))
    with torch.inference_mode():
        fi = f.to("cpu")
        assert fi.eid.is_inference() and fi.blk_ptr.is_inference()
        got = (tk._arena_sched(fi), tk._dw_sched(fi))
    if reuse == "training":       # the memo filled in inference, read after
        assert tk._arena_sched(fi) is got[0] and tk._dw_sched(fi) is got[1]
    else:
        with torch.inference_mode():
            assert tk._arena_sched(fi) is got[0]
            assert tk._dw_sched(fi) is got[1]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dense_oracle", [False, True])
@pytest.mark.parametrize("backend", ["xla_fused", "dense"])
@pytest.mark.parametrize("k", [6, DIM])
def test_drspmm_learnable_grads_match_jax(k, backend, dense_oracle):
    """Values and the gradients of both the canonical weights and the CBSR
    values against ``jax.vjp`` of the reference op; the indices get no
    gradient."""
    (jf, jb, _o, nnz), (tf, tb, _o2, _n) = _packs(5)
    xv, xi = _operands(9, tf.n_src, k, iota=k == DIM)
    rng = np.random.default_rng(10)
    w = rng.normal(size=nnz).astype(np.float32)
    gy = rng.normal(size=(tf.n_dst, DIM)).astype(np.float32)
    y, vjp = jax.vjp(lambda w_, v_: jops.drspmm_learnable(
        jf, jb, nnz, w_, v_, jnp.asarray(xi), DIM, backend=backend),
        jnp.asarray(w), jnp.asarray(xv))
    gw_ref, gx_ref = vjp(jnp.asarray(gy))
    wt = torch.from_numpy(w).requires_grad_()
    vt = torch.from_numpy(xv).requires_grad_()
    it = torch.from_numpy(xi)
    yt = tlearn.drspmm_learnable(tf, tb, nnz, wt, vt, it, DIM,
                                 dense=dense_oracle)
    yt.backward(torch.from_numpy(gy))
    assert_close(yt.detach().numpy(), np.asarray(y))
    assert_close(wt.grad.numpy(), np.asarray(gw_ref))
    assert_close(vt.grad.numpy(), np.asarray(gx_ref))
    assert it.grad is None


def test_drspmm_learnable_takes_eid_slabs():
    """Edge-id slabs are fused (and memoised) by the op itself."""
    dst, src = _edges(11, 25, 35, 200)
    fwd, bwd, _o, nnz = tell.pack_eid_slabs(dst, src, 25, 35)
    ff, fb, _o2, _n = tell.pack_fused_eid_pair(dst, src, 25, 35)
    xv, xi = _operands(12, 35, 5)
    w = torch.from_numpy(np.random.default_rng(13).normal(size=nnz)
                         .astype(np.float32))
    a = tops.drspmm_learnable(fwd, bwd, nnz, w, torch.from_numpy(xv),
                              torch.from_numpy(xi), DIM)
    b = tops.drspmm_learnable(ff, fb, nnz, w, torch.from_numpy(xv),
                              torch.from_numpy(xi), DIM)
    assert torch.equal(a, b)
    assert tops.device_arena(fwd, "cpu", eids=True) is \
        tops.device_arena(fwd, "cpu", eids=True)
