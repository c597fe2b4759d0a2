"""PyTorch port, DR-SpMM forward and backward: the plain versions of the
arena and dense-tier kernels against the JAX package's Pallas kernels
(interpret mode) and its XLA arena walk, and ``drspmm_multi`` (values and
gradients) against the JAX op.  The CUDA kernels are held against these
plain versions on a card in tests/test_torch_cuda.py.

Tolerance: fp32, rtol 1e-5 and atol 1e-5 (scaled by the output's
magnitude) -- the two sides sum the same products in another order."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.graphs.circuit as jcircuit
import repro.graphs.ell as jell
import repro.graphs.generator as jgen
from repro.kernels import drspmm as jk
from repro.kernels import ops as jops
import repro_torch.graphs.circuit as tcircuit
import repro_torch.graphs.ell as tell
import repro_torch.graphs.generator as tgen
from repro_torch.kernels import drspmm as tk
from repro_torch.kernels import ops as tops
from _torch_port import HIDDEN, SCALE, assert_close, cbsr_operands


def _plans(seed=0, size="small", dense_threshold=None):
    gj = jgen.generate_design(seed, size, SCALE)[0]
    gt = tgen.generate_design(seed, size, SCALE)[0]
    return (jcircuit.relation_plan_of(gj, dense_threshold=dense_threshold),
            tcircuit.relation_plan_of(gt, dense_threshold))


def _cotangent(n, seed, dim=HIDDEN):
    return np.random.default_rng(seed).normal(size=(n, dim)).astype(
        np.float32)


def _concat(plan, ops_np):
    """Type-concat (xv, xi) numpy operands, k padded to the group max."""
    kmax = max(ops_np[t][1].shape[1] for t in plan.src_types)
    pad = lambda a: np.pad(a, ((0, 0), (0, kmax - a.shape[1])))
    return (np.concatenate([pad(ops_np[t][0]) for t in plan.src_types]),
            np.concatenate([pad(ops_np[t][1]) for t in plan.src_types]))


@pytest.mark.parametrize("seed,size", [(0, "small"), (1, "medium")])
def test_arena_plain_matches_pallas(seed, size):
    pj, pt = _plans(seed, size)
    xv, xi = _concat(pt, cbsr_operands(pt, {"cell": 8, "net": 8}, seed))
    ref = np.asarray(jk.drspmm_fwd_multi(pj.fwd, jnp.asarray(xv),
                                         jnp.asarray(xi), HIDDEN))
    before = tk.drspmm_fwd_arena.launches
    out = tk.drspmm_fwd_arena(pt.fwd.to("cpu"), torch.from_numpy(xv),
                              torch.from_numpy(xi), HIDDEN)
    assert tk.drspmm_fwd_arena.launches == before   # CPU: plain version
    assert out.shape == (pt.fwd.n_arena_rows, HIDDEN)
    assert_close(out.numpy(), ref)


@pytest.mark.parametrize("k", [5, 16, 32])
def test_arena_plain_matches_pallas_long_runs(k):
    """Kernel 1's path on the CPU over an arena whose chunk runs reach 32
    chunks and more (8 rows of 128-280 neighbours at Ec 4, ending
    mid-window, beside 32 rows of 1-8), each package packing the same COO
    its own way, against the Pallas kernel.  Every row's columns are
    distinct but for column 1 repeating column 0 on every fifth row, and
    every fourth row's last pair is zero-valued.  The wrapper runs its
    plain version (no launch)."""
    rng = np.random.default_rng(26 + k)
    n_dst, n_src = 40, 300
    deg = np.concatenate([rng.integers(128, 281, 8),
                          rng.integers(1, 9, n_dst - 8)])
    dst = np.repeat(np.arange(n_dst), deg)
    src = np.concatenate([rng.choice(n_src, d, replace=False) for d in deg])
    perm = rng.permutation(dst.size)
    dst, src = dst[perm], src[perm]
    w = rng.normal(size=dst.size).astype(np.float32)
    fj = jell.fuse_bucketed(jell.pack_ell(dst, src, w, n_dst, n_src),
                            chunk=4)
    ft = tell.fuse_bucketed(tell.pack_ell(dst, src, w, n_dst, n_src),
                            chunk=4)
    runs = np.diff(ft.blk_ptr)
    assert runs.max() >= 32 and runs.min() <= 1 and ft.n_chunks < 400
    xv = rng.normal(size=(n_src, k)).astype(np.float32)
    xi = np.argsort(rng.random((n_src, HIDDEN)), axis=1)[:, :k]
    xi = xi.astype(np.int32)
    xi[::5, 1] = xi[::5, 0]
    xv[::4, -1] = 0.0
    ref = np.asarray(jk.drspmm_fwd_fused(fj, jnp.asarray(xv),
                                         jnp.asarray(xi), HIDDEN))
    before = tk.drspmm_fwd_arena.launches
    out = tk.drspmm_fwd_arena(ft.to("cpu"), torch.from_numpy(xv),
                              torch.from_numpy(xi), HIDDEN)
    assert tk.drspmm_fwd_arena.launches == before
    assert out.shape == (ft.n_arena_rows, HIDDEN)
    assert_close(out.numpy(), ref)
    dense = np.zeros((n_src, HIDDEN), np.float32)
    np.add.at(dense, (np.arange(n_src)[:, None], xi), xv)
    assert_close(out.numpy()[ft.gather], ft.to_dense() @ dense)


@pytest.mark.parametrize("seed,size", [(0, "small"), (1, "medium")])
def test_arena_sched_orders_longest_run_first(seed, size):
    """The launch order of kernel 1's k <= 32 walk, built once per
    ``blk_ptr``: every row-block once, longest chunk run first, ties in
    arena order, each row with its block's chunk range; a second call, or
    the arena rewrapped around the same tables, returns the same tensor,
    and a new ``blk_ptr`` its own."""
    _, pt = _plans(seed, size)
    f = pt.fwd.to("cpu")
    sched = tk._arena_sched(f)
    ptr = f.blk_ptr.long()
    b = sched[:, 0].long()
    assert sched.dtype == torch.int32 and sched.shape == (f.n_blocks, 4)
    assert torch.equal(torch.sort(b).values, torch.arange(f.n_blocks))
    runs = (ptr[1:] - ptr[:-1])[b]
    assert bool((runs[:-1] >= runs[1:]).all()) and int(runs[0]) > 1
    tie = runs[:-1] == runs[1:]
    assert bool((b[:-1][tie] < b[1:][tie]).all())
    assert torch.equal(sched[:, 1].long(), ptr[b])
    assert torch.equal(sched[:, 2].long(), ptr[b + 1])
    assert not bool(sched[:, 3].any())
    assert tk._arena_sched(f) is sched
    assert tk._arena_sched(dataclasses.replace(f)) is sched
    g = dataclasses.replace(f, blk_ptr=f.blk_ptr.clone())
    assert tk._arena_sched(g) is not sched
    assert torch.equal(tk._arena_sched(g), sched)


@pytest.mark.parametrize("seed,size", [(0, "small"), (1, "medium")])
def test_dense_tier_plain_matches_pallas(seed, size):
    pj, pt = _plans(seed, size)
    assert pt.has_dense
    xv, xi = _concat(pt, cbsr_operands(pt, {"cell": 8, "net": 8}, seed))
    ref = np.asarray(jk.drspmm_dense_tier_fwd(
        jnp.asarray(pj.dense_fwd), jnp.asarray(xv), jnp.asarray(xi), HIDDEN))
    out = tk.drspmm_dense_tier_fwd(torch.from_numpy(pt.dense_fwd),
                                   torch.from_numpy(xv),
                                   torch.from_numpy(xi), HIDDEN)
    assert_close(out.numpy(), ref)


@pytest.mark.parametrize("seed,size", [(0, "small"), (1, "medium")])
def test_dense_tier_plain_matches_pallas_k40(seed, size):
    """Kernel 2's path on the CPU at k 40 (more pairs than a warp's lanes)
    against the Pallas kernel: column 1 repeats column 0 on every source
    row and every fourth row's pair 2 is zero-valued.  The wrapper runs
    its plain version (no launch)."""
    pj, pt = _plans(seed, size)
    assert pt.has_dense
    n = pt.dense_fwd.shape[1]
    rng = np.random.default_rng(seed + 40)
    xv = rng.normal(size=(n, 40)).astype(np.float32)
    xi = rng.integers(0, HIDDEN, (n, 40), dtype=np.int32)
    xi[:, 1] = xi[:, 0]
    xv[::4, 2] = 0.0
    ref = np.asarray(jk.drspmm_dense_tier_fwd(
        jnp.asarray(pj.dense_fwd), jnp.asarray(xv), jnp.asarray(xi), HIDDEN))
    before = tk.drspmm_dense_tier_fwd.launches
    out = tk.drspmm_dense_tier_fwd(torch.from_numpy(pt.dense_fwd),
                                   torch.from_numpy(xv),
                                   torch.from_numpy(xi), HIDDEN)
    assert tk.drspmm_dense_tier_fwd.launches == before
    assert out.shape == (pt.dense_fwd.shape[0], HIDDEN)
    assert_close(out.numpy(), ref)


def test_arena_plain_duplicate_columns():
    """Zero-value duplicates of column 0 (k padding, CBSR filler) and
    duplicate non-zero columns both accumulate."""
    _, pt = _plans()
    n = pt.n_src_total
    rng = np.random.default_rng(3)
    xv = rng.normal(size=(n, 6)).astype(np.float32)
    xi = np.zeros((n, 6), np.int32)
    xi[:, 3:] = 5
    xv[:, 1:3] = 0.0
    dense = np.zeros((n, HIDDEN), np.float32)
    np.add.at(dense, (np.arange(n)[:, None], xi), xv)
    a = pt.fwd.to_dense()
    gather = pt.fwd.gather
    out = tk.drspmm_fwd_arena(pt.fwd.to("cpu"), torch.from_numpy(xv),
                              torch.from_numpy(xi), HIDDEN).numpy()
    assert_close(out[gather], a @ dense)


@pytest.mark.parametrize("backend", ["pallas_fused", "dense"])
@pytest.mark.parametrize("dense_oracle", [False, True])
def test_drspmm_multi_matches_jax(backend, dense_oracle):
    """k_cell != k_net: the narrower type is padded inside the op."""
    pj, pt = _plans(1, "medium")
    ops_np = cbsr_operands(pt, {"cell": 8, "net": 5}, seed=11)
    ref = jops.drspmm_multi(
        pj, {t: (jnp.asarray(v), jnp.asarray(i)) for t, (v, i)
             in ops_np.items()}, HIDDEN, backend=backend)
    with torch.no_grad():
        out = tops.drspmm_multi(
            pt.to("cpu"), {t: (torch.from_numpy(v), torch.from_numpy(i))
                           for t, (v, i) in ops_np.items()}, HIDDEN,
            dense=dense_oracle)
    assert set(out) == set(ref) == {"near", "pin", "pinned"}
    for et in ref:
        assert_close(out[et].numpy(), np.asarray(ref[et]), et)


@pytest.mark.parametrize("seed,size", [(0, "small"), (1, "medium")])
def test_arena_bwd_plain_matches_pallas(seed, size):
    """All-arena plan: every relation goes through the transposed arena."""
    pj, pt = _plans(seed, size, dense_threshold=-1)
    xv, xi = _concat(pt, cbsr_operands(pt, {"cell": 8, "net": 5}, seed))
    gy = _cotangent(pt.n_out_total, seed + 7)
    ref = np.asarray(jk.drspmm_bwd_multi(pj.bwd, jnp.asarray(pj.bwd_src_rows),
                                         jnp.asarray(gy), jnp.asarray(xi),
                                         interpret=True))
    before = tk.drspmm_bwd_arena.launches
    bwd = pt.bwd.to("cpu")
    out = tk.drspmm_bwd_arena(bwd, torch.from_numpy(pt.bwd_src_rows),
                              torch.from_numpy(gy), torch.from_numpy(xi))
    assert tk.drspmm_bwd_arena.launches == before   # CPU: plain version
    assert out.shape == (pt.bwd.n_arena_rows, xi.shape[1])
    assert_close(out.numpy(), ref)
    # the XLA arena walk of the reference returns caller order
    ref_xla = np.asarray(jops._bwd_fused_xla(
        pj.bwd, jnp.asarray(gy), jnp.asarray(xi), rows=pj.bwd_src_rows))
    assert_close(out.numpy()[pt.bwd.gather], ref_xla)


@pytest.mark.parametrize("k", [5, 16, 32])
def test_arena_bwd_plain_matches_pallas_long_runs(k):
    """Kernel 4's path on the CPU over a transposed arena whose chunk runs
    reach 20-70 chunks (8 rows of 80-280 neighbours at Ec 4, ending
    mid-window, beside 32 rows of 1-8), each package packing the same COO
    its own way, against the Pallas kernel in interpret mode.  Every row's
    columns are distinct but for column 1 repeating column 0 on every
    fifth row.  The wrapper runs its plain version (no launch)."""
    rng = np.random.default_rng(29 + k)
    n_rows, n_gy = 40, 300
    deg = np.concatenate([rng.integers(80, 281, 8),
                          rng.integers(1, 9, n_rows - 8)])
    dst = np.repeat(np.arange(n_rows), deg)
    src = np.concatenate([rng.choice(n_gy, d, replace=False) for d in deg])
    perm = rng.permutation(dst.size)
    dst, src = dst[perm], src[perm]
    w = rng.normal(size=dst.size).astype(np.float32)
    fj = jell.fuse_bucketed(jell.pack_ell(dst, src, w, n_rows, n_gy),
                            chunk=4)
    ft = tell.fuse_bucketed(tell.pack_ell(dst, src, w, n_rows, n_gy),
                            chunk=4)
    runs = np.diff(ft.blk_ptr)
    assert runs.max() >= 20 and runs.min() <= 1 and ft.n_chunks < 400
    gy = _cotangent(n_gy, 7 + k)
    xi = np.argsort(rng.random((n_rows, HIDDEN)), axis=1)[:, :k]
    xi = xi.astype(np.int32)
    xi[::5, 1] = xi[::5, 0]
    ref = np.asarray(jk.drspmm_bwd_fused(fj, jnp.asarray(gy),
                                         jnp.asarray(xi[fj.rows]),
                                         interpret=True))
    before = tk.drspmm_bwd_arena.launches
    bwd = ft.to("cpu")
    out = tk.drspmm_bwd_arena(bwd, bwd.rows, torch.from_numpy(gy),
                              torch.from_numpy(xi))
    assert tk.drspmm_bwd_arena.launches == before
    assert out.shape == (ft.n_arena_rows, k)
    assert_close(out.numpy(), ref)
    dense = ft.to_dense() @ gy
    assert_close(out.numpy()[ft.gather],
                 np.take_along_axis(dense, xi.astype(np.int64), 1))


@pytest.mark.parametrize("seed,size", [(0, "small"), (1, "medium")])
def test_dense_tier_bwd_plain_matches_pallas(seed, size):
    pj, pt = _plans(seed, size)
    assert pt.has_dense
    _, xi = _concat(pt, cbsr_operands(pt, {"cell": 8, "net": 8}, seed))
    gy = _cotangent(pt.dense_bwd.shape[1], seed + 3)
    ref = np.asarray(jk.drspmm_dense_tier_bwd(
        jnp.asarray(pj.dense_bwd), jnp.asarray(gy), jnp.asarray(xi),
        interpret=True))
    out = tk.drspmm_dense_tier_bwd(torch.from_numpy(pt.dense_bwd),
                                   torch.from_numpy(gy), torch.from_numpy(xi))
    assert_close(out.numpy(), ref)
    ref_xla = np.asarray(jops._multi_dense_bwd(pj, jnp.asarray(gy),
                                               jnp.asarray(xi), "xla_fused"))
    assert_close(out.numpy(), ref_xla)
    # rows of the slab outside every dense relation come back exactly 0
    empty = ~pt.dense_bwd.any(axis=1)
    assert np.all(out.numpy()[empty] == 0.0)


def test_dense_tier_bwd_empty_table():
    xi = torch.zeros((5, 4), dtype=torch.int32)
    out = tk.drspmm_dense_tier_bwd(torch.zeros((5, 0)), torch.zeros((0, 8)),
                                   xi)
    assert out.shape == (5, 4) and not out.any()


@pytest.mark.parametrize("threshold", [None, -1], ids=["mixed", "arena"])
@pytest.mark.parametrize("backend", ["xla_fused", "dense"])
@pytest.mark.parametrize("dense_oracle", [False, True])
def test_drspmm_multi_grads_match_jax(threshold, backend, dense_oracle):
    """Gradients of the CBSR values against ``jax.vjp`` of the reference
    op.  k_cell != k_net, so the kmax padding is sliced per type; cell
    feeds both ``near`` and ``pin``, so its arena segments add up."""
    pj, pt = _plans(1, "medium", dense_threshold=threshold)
    assert pt.has_dense == (threshold is None)
    ops_np = cbsr_operands(pt, {"cell": 8, "net": 5}, seed=13)
    types = pt.src_types
    etypes = [s.etype for s in pt.segments]
    gys = {et: _cotangent(s.n_dst, 20 + i)
           for i, (et, s) in enumerate(zip(etypes, pt.segments))}

    def f(vals):
        ys = jops.drspmm_multi(
            pj, {t: (v, jnp.asarray(ops_np[t][1])) for t, v in
                 zip(types, vals)}, HIDDEN, backend=backend)
        return tuple(ys[et] for et in etypes)

    _, vjp = jax.vjp(f, tuple(jnp.asarray(ops_np[t][0]) for t in types))
    (ref,) = vjp(tuple(jnp.asarray(gys[et]) for et in etypes))
    cbsr = {t: (torch.from_numpy(v).requires_grad_(), torch.from_numpy(i))
            for t, (v, i) in ops_np.items()}
    ys = tops.drspmm_multi(pt.to("cpu"), cbsr, HIDDEN, dense=dense_oracle)
    torch.autograd.backward([ys[et] for et in etypes],
                            [torch.from_numpy(gys[et]) for et in etypes])
    for t, r in zip(types, ref):
        g = cbsr[t][0].grad
        assert g.shape == ops_np[t][0].shape, t
        assert_close(g.numpy(), np.asarray(r), t)
        assert cbsr[t][1].grad is None


def test_kernel_wrappers_refuse_mixed_devices():
    _, pt = _plans()
    xv = torch.zeros((pt.n_src_total, 4))
    xi = torch.zeros((pt.n_src_total, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="devices"):
        tk.drspmm_fwd_arena(pt.fwd.to("cpu"), xv.to("meta"), xi, HIDDEN)
