"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, holds each
kernel against its plain PyTorch version at the shapes the serving and
training paths give it (the learnable-edge forward and sampled backward
also with each row's k = 64 columns permuted, beside their arenas' longest
chunk runs), then serves DR-CircuitGNN (hidden 64, k 16, 2 layers, random
weights from a seed) through ``CircuitServeEngine``:

1. Table-1 partitions (``generate_design(0, "small")`` +
   ``generate_design(1, "medium")``, scale 1.0) with ``drelu_backend``
   ``"topk"``;
2. the same with ``"bisect"`` (the D-ReLU bisection kernel);
3. a scale-0.02 stream whose plans route ``pin``/``pinned`` to the dense
   tier;

and trains it with ``CircuitTrainer.fit`` (2 epochs, batches of 2):

4. ``train-table1-topk``: the Table-1 partitions;
5. ``train-scale0.02-bisect``: the scale-0.02 stream with the bisection
   kernel and per-layer recompute (remat);
6. ``train-table1-dense``: the Table-1 partitions with D-ReLU off (the
   paper's dense-SpMM baseline): 11 launches of the arena SpMM kernel a
   step and none of the D-ReLU path's kernels;

and trains the homogeneous Table-2 baselines (hidden 64, 3 layers, 3 AdamW
steps on the homogenized first Table-1 partition, 11,840 nodes):

7. ``train-homo-gcn`` and ``train-homo-sage``: the arena SpMM kernel;
8. ``train-homo-gat`` and ``train-homo-gat_edge``: the learnable-edge
   forward, dx and dW kernels;

and trains on the serial per-relation path (single graphs, 2 epochs), each
step held in lockstep against a CPU trainer that starts it from the same
weights and optimizer state:

9. ``train-table1-bucket``: ``backend="bucket"``, the per-bucket DR-SpMM
   forward and backward kernels, one launch per degree bucket;
10. ``train-table1-bucket-knet64``: the same with ``k_net=64``, so the
    nets stay dense and ``pinned`` runs the per-bucket SpMM kernel;
11. ``train-table1-serial`` / ``train-scale0.02-serial``:
    ``use_plan=False`` on the fused family, one arena (or, below the
    crossover, dense-tier) launch per relation;
12. ``train-homo-gcn-bucket``: the GCN baseline on the per-bucket SpMM
    kernel;
13. ``learnable-slabs-bucket``: one call of the edge-id slab entry point
    of ``drspmm_learnable`` under ``backend="bucket"``;

and serves the dense LM at qwen3-0.6b's full width (random weights from a
seed, fp32 on the card, computed in bf16):

14. ``kernel-flash``: the flash-attention kernel against its plain version
    at the q/k/v of a prefill's first layer (captured: k/v at their 8 KV
    heads), at S 1000 (ragged tails, bf16 and fp32), in fp32, at head dims
    32 and 128, non-causal (Sq 128, Sk 256), with one KV head for 16 and
    at S 4,096 (GQA 16/8); timed beside ``scaled_dot_product_attention``
    on the same operands (k/v tiled outside the timed call);
15. ``serve-lm-qwen3-0.6b``: ``examples/serve_lm.py`` at depth 28: 4
    prompts of 1,008 tokens padded to 1,024, prefill (28 flash launches),
    16 greedy decode steps (none); decode at S-1 reproduces the prefill's
    last logits; a profiler breakdown of a prefill and a decode step
    (kernel 13's share, the count of device activities);
16. ``serve-lm-fp32-depth2``: full width, 2 layers, fp32: the card's
    prefill + 8 decode steps against the port's CPU path;
17. ``serve-lm-engine``: ``ServeEngine`` (4 slots, s_max 128) over 8 ragged
    requests, slots reused, no flash launch.

Every kernel's launch count is zeroed just before each path and read just
after; a kernel that the path should run and did not, or one it must not
run and did, fails the run.  Every
served prediction is compared with the port's CPU forward of the same
graph and weights; every training step's loss, and the first step's
gradients, with a CPU trainer started from the same weights on the same
batches.  The last lines are the kernel report, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Any failed phase exits
non-zero.  Needs one card; imports no JAX.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
import subprocess
import sys
import time
import warnings

import torch

HIDDEN, K, LAYERS, FEAT = 64, 16, 2, 16
SEED = 0
H100_BYTES_PER_S = 3.35e12        # HBM3, SXM part
H100_F32_PER_S = 67e12            # fp32 outside the tensor cores
H100_BF16_PER_S = 989e12          # bf16 on the tensor cores, dense
CELL_ATOL = 1e-4                  # served vs CPU forward, per cell
CELL_SHARE = 0.999                # share of cells that must be within it
LOSS_RTOL = 1e-4                  # training step loss, card vs CPU
# lockstep step loss, card vs CPU from the same state: summation order
# only, unless a near-tied D-ReLU pick flips (then LOSS_RTOL, reported)
LOCKSTEP_RTOL = 1e-6
GRAD_RTOL = 1e-4                  # first-step gradient, relative L2
REPS = 20


PROBLEMS = []


def fail(msg: str) -> None:
    """Stop now (the run cannot go on)."""
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def problem(msg: str) -> None:
    """Record a failed check; the run goes on and exits non-zero at the
    end."""
    print(f"chip_smoke: CHECK FAILED: {msg}", file=sys.stderr, flush=True)
    PROBLEMS.append(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = REPS) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after a warm-up
    (CUDA events; the working set stays in L2 across calls)."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, n_ops: float, peak: float = H100_F32_PER_S):
    """The least time (ms) for the bytes and operations at the card's
    memory rate and ``peak`` operation rate, and which of the two binds."""
    t_b, t_o = n_bytes / H100_BYTES_PER_S, n_ops / peak
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def bit_equal(a, b) -> bool:
    """Equal bit for bit, the sign of a zero included."""
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def drelu_hard_rows(n, d):
    """(n, d) rows on the card, seeded normal, with the bisection's hard
    cases first: +-inf (a NaN mid), ties at the threshold, one value,
    zeros and -0.0, lo + hi overflowing, values near 1e-10; every other
    remaining row ReLU'd."""
    g = torch.Generator().manual_seed(SEED)
    x = torch.randn((n, d), generator=g)
    x[0, ::5], x[0, 1::7] = math.inf, -math.inf
    x[1], x[1, ::3] = -math.inf, math.inf
    x[2, :d // 2] = 1.25
    x[3] = 0.5
    x[4] = 0.0
    x[4, 1::3] = -0.0
    x[5] = 3e38 - x[5].abs() * 1e37
    x[6] *= 1e-10
    x[7::2] = x[7::2].clamp(min=0.0)
    return x.cuda()


def drelu_ops_a_row(d):
    """Operations kernel 3 does on a row of d values: its sort network on
    the row padded to P (fminf and fmaxf a comparator: odd-even merge up
    to 64 values, bitonic above), min and max, the 64 steps (add,
    multiply, compare, select) and the output compare."""
    p = 32
    while p < d:
        p *= 2
    lg = p.bit_length() - 1
    pairs = (p // 4 * lg * (lg - 1) + p - 1 if p <= 64
             else p // 2 * lg * (lg + 1) // 2)
    return 2 * pairs + 2 * d + 64 * 4 + d


def first_layer_operands(model, graph, cfg):
    """The CBSR operands the first layer hands the DR-SpMM kernels, and the
    dense cell embedding it hands the D-ReLU kernel."""
    from repro_torch.core.hetero_mp import _sparsify_types
    from repro_torch.kernels.ops import _multi_concat
    with torch.inference_mode():
        h_cell = graph.x_cell @ model.in_cell
        h_net = graph.x_net @ model.in_net
        c_cell, c_net = _sparsify_types(h_cell, h_net, cfg)
        xv, xi = _multi_concat(graph.plan, (c_cell.values, c_net.values),
                               (c_cell.idx, c_net.idx))
    return xv, xi, h_cell.contiguous()


def arena_csr(f, n_src):
    """The (super-)arena ``f`` as a CSR matrix (the library yardstick)."""
    warnings.filterwarnings("ignore", message="Sparse")
    br = f.row_block
    rows = (f.block_of.long()[:, None] * br
            + torch.arange(br, device=f.w.device)[None, :])
    mask = f.w != 0
    return torch.sparse_coo_tensor(
        torch.stack([rows[:, :, None].expand(f.nbr.shape)[mask],
                     f.nbr.long()[mask]]), f.w[mask],
        (f.n_arena_rows, n_src)).coalesce().to_sparse_csr()


def check_kernels(model, cfg, big, small):
    """Each kernel against its plain version on the card, with times."""
    from repro_torch.kernels import drspmm as K1
    from repro_torch.kernels.drelu_topk import drelu_bisect, drelu_bisect_plain
    rows = {}
    tol = lambda ref: 1e-5 * max(1.0, float(ref.abs().max()))

    # kernel 1: the full-width super-arena of the first served batch
    plan = big.plan
    xv, xi, h_cell = first_layer_operands(model, big.graph, cfg)
    f = plan.fwd
    y = K1.drspmm_fwd_arena(f, xv, xi, HIDDEN)
    ref = K1.drspmm_fwd_arena_plain(f, xv, xi, HIDDEN)
    torch.cuda.synchronize()
    err = float((y - ref).abs().max())
    if not torch.allclose(y, ref, rtol=1e-5, atol=tol(ref)):
        problem(f"arena kernel disagrees with its plain version: {err}")
    y_sha = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()
    # the same operands with repeated non-zero columns (legal input outside
    # the CBSR contract): the kernel's broadcast fallback must add them all
    xi_dup = xi.clone()
    xi_dup[::3, 1] = xi_dup[::3, 0]
    y = K1.drspmm_fwd_arena(f, xv, xi_dup, HIDDEN)
    ref = K1.drspmm_fwd_arena_plain(f, xv, xi_dup, HIDDEN)
    torch.cuda.synchronize()
    if not torch.allclose(y, ref, rtol=1e-5, atol=tol(ref)):
        problem("arena kernel loses repeated columns: "
                f"{float((y - ref).abs().max())}")
    c, br, ec = f.nbr.shape
    real = int((f.w != 0).sum())
    a_csr = arena_csr(f, xv.shape[0])
    xd = K1._densify(xv, xi, HIDDEN)
    n_bytes = 4 * (f.blk_ptr.numel() + 2 * f.nbr.numel() + 2 * xv.numel()
                   + f.n_arena_rows * HIDDEN)
    b_ms, b_by = bound(n_bytes, 2.0 * real * xv.shape[1])
    rows["drspmm_fwd_arena"] = dict(
        name="drspmm_fwd_arena", route="cuda",
        source="src/repro_torch/csrc/drspmm_arena_fwd.cu",
        replaces="src/repro/kernels/drspmm.py:289",
        max_abs_err=err,
        ms=cuda_ms(lambda: K1.drspmm_fwd_arena(f, xv, xi, HIDDEN)),
        plain_ms=cuda_ms(lambda: K1.drspmm_fwd_arena_plain(f, xv, xi, HIDDEN)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: a_csr @ xd))
    log(f"kernel drspmm_fwd_arena: C={c} BR={br} Ec={ec} "
        f"R_arena={f.n_arena_rows} N_src={xv.shape[0]} k={xv.shape[1]} "
        f"real_slots={real} bytes={n_bytes}")
    dev = [device_breakdown(lambda: [fn() for _ in range(REPS)])[1] / REPS
           for fn in (lambda: K1.drspmm_fwd_arena(f, xv, xi, HIDDEN),
                      lambda: a_csr @ xd)]
    log(f"kernel drspmm_fwd_arena: device ms a call (profiler) {dev[0]} "
        f"(kernel), {dev[1]} (library: a_csr @ xd); output SHA-256 {y_sha}")

    # kernel 3: the first layer's cell embedding, full width; its library
    # yardstick is the torch.topk-threshold D-ReLU of the "topk" backend,
    # the same function up to ties at the threshold
    from repro_torch.core.drelu import drelu
    y = drelu_bisect(h_cell, K)
    ref = drelu_bisect_plain(h_cell, K)
    with torch.inference_mode():
        n_same = int((drelu(h_cell, K) == y).all(dim=1).sum())
    torch.cuda.synchronize()
    if not bit_equal(y, ref):
        problem("bisection kernel is not bit-exact against its plain version")
    y_sha = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()
    for d in (64, 96, 256):     # one lane a row; one warp a row (4, 8 regs)
        x = drelu_hard_rows(1031, d)
        for k in (1, d // 4, d - 1):
            if not bit_equal(drelu_bisect(x, k), drelu_bisect_plain(x, k)):
                problem(f"bisection kernel is not bit-exact on the hard rows "
                        f"at d {d}, k {k}")
    n, d = h_cell.shape
    b_ms, b_by = bound(8.0 * n * d, n * drelu_ops_a_row(d))
    with torch.inference_mode():
        lib_ms = cuda_ms(lambda: drelu(h_cell, K))
    rows["drelu_bisect"] = dict(
        name="drelu_bisect", route="cuda",
        source="src/repro_torch/csrc/drelu_bisect.cu",
        replaces="src/repro/kernels/drelu_topk.py:65",
        max_abs_err=float((y - ref).abs().max()),
        ms=cuda_ms(lambda: drelu_bisect(h_cell, K)),
        plain_ms=cuda_ms(lambda: drelu_bisect_plain(h_cell, K)),
        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
    with torch.inference_mode():
        dev = [device_breakdown(lambda: [fn() for _ in range(REPS)])[1]
               / REPS for fn in (lambda: drelu_bisect(h_cell, K),
                                 lambda: drelu(h_cell, K))]
    log(f"kernel drelu_bisect: N={n} D={d} k={K}; library_ms is the "
        f"torch.topk-threshold D-ReLU, which gives the kernel's rows "
        f"exactly on {n_same} of {n} rows; device ms a call (profiler) "
        f"{dev[0]} (kernel), {dev[1]} (library); output SHA-256 {y_sha}; "
        f"bit-exact on hard rows at d 64, 96 and 256")

    # kernel 2: the dense-tier table of a scale-0.02 batch
    plan = small.plan
    if not plan.has_dense:
        fail("the scale-0.02 batch has no dense-tier relation")
    xv, xi, _ = first_layer_operands(model, small.graph, cfg)
    a = plan.dense_fwd
    y = K1.drspmm_dense_tier_fwd(a, xv, xi, HIDDEN)
    ref = K1.drspmm_dense_tier_fwd_plain(a, xv, xi, HIDDEN)
    torch.cuda.synchronize()
    err = float((y - ref).abs().max())
    if not torch.allclose(y, ref, rtol=1e-5, atol=tol(ref)):
        problem(f"dense-tier kernel disagrees with its plain version: {err}")
    m, n = a.shape
    xd = K1._densify(xv, xi, HIDDEN)
    b_ms, b_by = bound(4.0 * (m * n + 2 * xv.numel() + m * HIDDEN),
                       2.0 * int((a != 0).sum()) * xv.shape[1])
    rows["drspmm_dense_tier_fwd"] = dict(
        name="drspmm_dense_tier_fwd", route="cuda",
        source="src/repro_torch/csrc/drspmm_dense_tier_fwd.cu",
        replaces="src/repro/kernels/drspmm.py:506",
        max_abs_err=err,
        ms=cuda_ms(lambda: K1.drspmm_dense_tier_fwd(a, xv, xi, HIDDEN)),
        plain_ms=cuda_ms(
            lambda: K1.drspmm_dense_tier_fwd_plain(a, xv, xi, HIDDEN)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: a @ xd))
    # the kernel's own device time beside its library call's (the events
    # read the host's launch rate where a call is shorter than its launch)
    dev = [device_breakdown(lambda: [fn() for _ in range(REPS)])[1] / REPS
           for fn in (lambda: K1.drspmm_dense_tier_fwd(a, xv, xi, HIDDEN),
                      lambda: a @ xd)]
    log(f"kernel drspmm_dense_tier_fwd: M={m} N={n} nnz={int((a != 0).sum())}"
        f"; device ms a call (profiler) {dev[0]} (kernel), {dev[1]} "
        f"(library: a @ xd)")
    log(f"kernel drspmm_dense_tier_fwd: output SHA-256 "
        f"{hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()}")
    for r in rows.values():
        log(f"  {r['name']}: max_abs_err={r['max_abs_err']} ms={r['ms']} "
            f"plain_ms={r['plain_ms']} bound_ms={r['bound_ms']} "
            f"({r['bound_by']}) library_ms={r['library_ms']}")
    return rows


def coo_csr(dst, src, w, shape):
    """A CSR matrix from COO triples (the library yardstick)."""
    warnings.filterwarnings("ignore", message="Sparse")
    return torch.sparse_coo_tensor(torch.stack([dst.long(), src.long()]),
                                   w, shape).coalesce().to_sparse_csr()


def record_calls(module, name, run):
    """Run ``run()`` with the kernel wrapper ``module.name`` wrapped to
    record every call's positional arguments; returns the list of argument
    tuples.
    The wrapper counts its launches on the module-level name, so the
    stand-in carries the counter while it is installed."""
    seen, fn = [], getattr(module, name)

    def rec(*args, **kw):
        seen.append(args)
        return fn(*args, **kw)

    rec.launches = fn.launches
    setattr(module, name, rec)
    try:
        run()
    finally:
        setattr(module, name, fn)
        fn.launches = rec.launches
    return seen


def check_spmm_kernel(model, cfg_dense, big):
    """Kernel 6 on the ``near`` arena of the first Table-1 batch, forward
    (the first layer's cell embedding) and transposed (the cotangent the
    batch's dense training loss sends back to that layer's ``near``)."""
    from repro_torch.kernels import drspmm as K1
    from repro_torch.kernels import ops
    from repro_torch.models.hgnn import batched_loss_fn
    tol = lambda ref: 1e-5 * float(ref.abs().max())
    g = big.graph
    adj, adj_t = g.edges["near"].adj, g.edges["near"].adj_t
    f = ops.device_arena(adj, "cuda")
    f_t = ops.device_arena(adj_t, "cuda")
    calls = record_calls(K1, "spmm_arena", lambda: batched_loss_fn(
        model, g, big.cell_weight, cfg_dense).backward())
    model.zero_grad(set_to_none=True)
    x = next(a[1] for a in calls if a[0] is f)            # layer 1, forward
    gy = [a[1] for a in calls if a[0] is f_t][-1]        # layer 1, backward
    row = None
    for arena, opnd, what in ((f, x, "forward"), (f_t, gy, "transposed")):
        y = K1.spmm_arena(arena, opnd)
        ref = K1.spmm_arena_plain(arena, opnd)
        torch.cuda.synchronize()
        err = float((y - ref).abs().max())
        if not torch.allclose(y, ref, rtol=1e-5, atol=tol(ref)):
            problem(f"spmm kernel ({what}) disagrees with its plain "
                    f"version: {err}")
        y_sha = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()
        c, br, ec = arena.nbr.shape
        real = int((arena.w != 0).sum())
        a_csr = arena_csr(arena, opnd.shape[0])
        n_bytes = 4 * (arena.blk_ptr.numel() + 2 * arena.nbr.numel()
                       + opnd.numel() + arena.n_arena_rows * opnd.shape[1])
        # each real slot reads a whole operand row: its 32-byte L2 sectors
        sectors = real * -(-4 * opnd.shape[1] // 32) * 32
        b_ms, b_by = bound(n_bytes, 2.0 * real * opnd.shape[1])
        r = dict(
            name="spmm_arena", route="cuda",
            source="src/repro_torch/csrc/spmm_arena.cu",
            replaces="src/repro/kernels/drspmm.py:443",
            max_abs_err=err, ref_max=float(ref.abs().max()),
            ms=cuda_ms(lambda: K1.spmm_arena(arena, opnd)),
            plain_ms=cuda_ms(lambda: K1.spmm_arena_plain(arena, opnd)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(lambda: a_csr @ opnd))
        dev = [device_breakdown(lambda: [fn() for _ in range(REPS)])[1]
               / REPS for fn in (lambda: K1.spmm_arena(arena, opnd),
                                 lambda: a_csr @ opnd)]
        log(f"kernel spmm_arena ({what}): C={c} BR={br} Ec={ec} "
            f"R_arena={arena.n_arena_rows} N_src={opnd.shape[0]} "
            f"dim={opnd.shape[1]} real_slots={real} bytes={n_bytes} "
            f"l2_sector_bytes={sectors}: max_abs_err={err} (max |ref| "
            f"{r['ref_max']}) sha256={y_sha} ms={r['ms']} "
            f"plain_ms={r['plain_ms']} bound_ms={b_ms} ({b_by}) "
            f"library_ms={r['library_ms']}; device ms a call (profiler) "
            f"{dev[0]} (kernel), {dev[1]} (library: a_csr @ x)")
        row = row or r               # the table's row is the forward
    return {"spmm_arena": row}


def check_learnable_kernels(homo_gat, homo):
    """Kernels 7-9 on the homogenized first Table-1 partition with the
    ``gat`` model's first-layer attention weights, its hw = h @ W as the
    dense operand (k = dim, indices iota) and the cotangent its loss sends
    back to that layer."""
    from repro_torch.kernels import drspmm as K1
    from repro_torch.models.hgnn import homo_forward, learnable_edge_packing
    adj, adj_t, x, y, n_cell = homo
    tol = lambda ref: 1e-5 * float(ref.abs().max())
    fwd_calls = []

    def run():
        nonlocal fwd_calls
        fwd_calls = record_calls(K1, "drspmm_fwd_learnable", lambda: torch.mean(
            (homo_forward(homo_gat, adj, adj_t, x, n_cell) - y) ** 2
        ).backward())

    dw_calls = record_calls(K1, "drspmm_dw_learnable", run)
    homo_gat.zero_grad(set_to_none=True)
    f, nnz, w, xv, xi, dim = fwd_calls[0]                 # layer 1
    _f, _n, gy, _xv, _xi = dw_calls[-1]                   # layer 1
    _ff, ft, dst_c, src_c, _w, _nnz = learnable_edge_packing(adj, "cuda")
    rows = {}
    a_w = coo_csr(dst_c, src_c, w, (adj.n_dst, adj.n_src))
    a_wt = coo_csr(src_c, dst_c, w, (adj.n_src, adj.n_dst))
    pattern = coo_csr(dst_c, src_c, torch.ones_like(w),
                      (adj.n_dst, adj.n_src))
    xt = xv.t().contiguous()
    k = xi.shape[1]
    specs = (
        ("drspmm_fwd_learnable", "drspmm_learnable_fwd.cu",
         "src/repro/kernels/drspmm.py:644",
         lambda: K1.drspmm_fwd_learnable(f, nnz, w, xv, xi, dim),
         lambda: K1.drspmm_fwd_learnable_plain(f, nnz, w, xv, xi, dim),
         lambda: a_w @ xv,
         4 * (f.blk_ptr.numel() + 2 * f.nbr.numel() + nnz + 2 * xv.numel()
              + f.n_arena_rows * dim)),
        ("drspmm_bwd_learnable", "drspmm_learnable_bwd.cu",
         "src/repro/kernels/drspmm.py:706",
         lambda: K1.drspmm_bwd_learnable(ft, nnz, w, gy, xi),
         lambda: K1.drspmm_bwd_learnable_plain(ft, nnz, w, gy, xi),
         lambda: a_wt @ gy,
         4 * (ft.blk_ptr.numel() + 2 * ft.nbr.numel() + ft.n_arena_rows
              + nnz + gy.numel() + xi.numel() + ft.n_arena_rows * k)),
        ("drspmm_dw_learnable", "drspmm_learnable_dw.cu",
         "src/repro/kernels/drspmm.py:765",
         lambda: K1.drspmm_dw_learnable(f, nnz, gy, xv, xi),
         lambda: K1.drspmm_dw_learnable_plain(f, nnz, gy, xv, xi),
         lambda: torch.sparse.sampled_addmm(pattern, gy, xt, beta=0.0),
         4 * (f.blk_ptr.numel() + 2 * f.nbr.numel() + f.n_arena_rows
              + gy.numel() + 2 * xv.numel() + nnz)),
    )
    for name, src, replaces, kern, plain, lib, n_bytes in specs:
        out, ref = kern(), plain()
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not torch.allclose(out, ref, rtol=1e-5, atol=tol(ref)):
            problem(f"{name} kernel disagrees with its plain version: {err}")
        b_ms, b_by = bound(n_bytes, 2.0 * nnz * k)
        rows[name] = dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{src}",
            replaces=replaces, max_abs_err=err,
            ref_max=float(ref.abs().max()), ms=cuda_ms(kern),
            plain_ms=cuda_ms(plain), bound_ms=b_ms, bound_by=b_by,
            library_ms=cuda_ms(lib))
        r = rows[name]
        log(f"kernel {name}: N={adj.n_src} nnz={nnz} k={k} dim={dim} "
            f"chunks={f.nbr.shape} bytes={n_bytes}: max_abs_err={err} "
            f"(max |ref| {r['ref_max']}) ms={r['ms']} "
            f"plain_ms={r['plain_ms']} bound_ms={b_ms} ({b_by}) "
            f"library_ms={r['library_ms']}")
    # kernel 7 on the same arena with a k = 64 operand whose columns are
    # not lane-aligned: each row a random permutation (from SEED), so every
    # 32-pair group takes the owner-table scatter; beside its ms, the chunk
    # runs that set the kernel's latency chain
    xi_perm = torch.argsort(torch.rand(
        xi.shape, generator=torch.Generator().manual_seed(SEED)),
        dim=1).to(device=xi.device, dtype=torch.int32)
    out = K1.drspmm_fwd_learnable(f, nnz, w, xv, xi_perm, dim)
    ref = K1.drspmm_fwd_learnable_plain(f, nnz, w, xv, xi_perm, dim)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    if not torch.allclose(out, ref, rtol=1e-5, atol=tol(ref)):
        problem(f"drspmm_fwd_learnable kernel (permuted columns) disagrees "
                f"with its plain version: {err}")
    c, br, ec = f.nbr.shape
    run = int(torch.diff(f.blk_ptr).max())
    buckets = [tuple(b.nbr.shape) for b in adj.buckets]
    log(f"kernel drspmm_fwd_learnable: longest chunk run {run} chunks "
        f"({run * ec} slots), widest degree bucket "
        f"{max(e for _r, e in buckets)} slots (buckets R x E {buckets}); "
        f"ms={rows['drspmm_fwd_learnable']['ms']} (iota columns, "
        f"lane-aligned), ms={cuda_ms(lambda: K1.drspmm_fwd_learnable(f, nnz, w, xv, xi_perm, dim))} "
        f"(permuted columns, max_abs_err={err}, max |ref| "
        f"{float(ref.abs().max())})")
    # kernel 8 on its transposed arena with the same permuted k = 64
    # columns; beside its ms, the transposed arena's chunk runs (at most 80
    # slots: its chain is a chunk's dependent loads, not a long row)
    out = K1.drspmm_bwd_learnable(ft, nnz, w, gy, xi_perm)
    ref = K1.drspmm_bwd_learnable_plain(ft, nnz, w, gy, xi_perm)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    if not torch.allclose(out, ref, rtol=1e-5, atol=tol(ref)):
        problem(f"drspmm_bwd_learnable kernel (permuted columns) disagrees "
                f"with its plain version: {err}")
    # the kernel's own device time (the events also see the host's launch
    # gaps, which a kernel this short can fall under)
    dev = [device_breakdown(lambda: [fn() for _ in range(REPS)])[1] / REPS
           for fn in (lambda: K1.drspmm_bwd_learnable(ft, nnz, w, gy, xi),
                      lambda: K1.drspmm_bwd_learnable(ft, nnz, w, gy,
                                                      xi_perm),
                      lambda: a_wt @ gy)]
    runs_t = torch.diff(ft.blk_ptr)
    run, ec = int(runs_t.max()), ft.nbr.shape[2]
    buckets = [tuple(b.nbr.shape) for b in adj_t.buckets]
    log(f"kernel drspmm_bwd_learnable: transposed arena {tuple(ft.nbr.shape)}"
        f", longest chunk run {run} chunks ({run * ec} slots), "
        f"{int((runs_t >= 32).sum())} runs of >= 32 chunks, mean "
        f"{float(runs_t.float().mean()):.2f} chunks a row-block, widest "
        f"degree bucket {max(e for _r, e in buckets)} slots (buckets R x E "
        f"{buckets}); ms={rows['drspmm_bwd_learnable']['ms']} (iota "
        f"columns), ms={cuda_ms(lambda: K1.drspmm_bwd_learnable(ft, nnz, w, gy, xi_perm))} "
        f"(permuted columns, max_abs_err={err}, max |ref| "
        f"{float(ref.abs().max())}); device ms a call (profiler) {dev[0]} "
        f"(iota), {dev[1]} (permuted), {dev[2]} (library: a_wt @ gy)")
    # the yardsticks compute the same functions (xi = identity); a CSR
    # matrix keeps its values in (row, column) order
    csr_order = torch.argsort(dst_c * adj.n_src + src_c)
    lib_err = [
        float((a_w @ xv - K1.drspmm_fwd_learnable(
            f, nnz, w, xv, xi, dim)[f.gather]).abs().max()),
        float((a_wt @ gy - K1.drspmm_bwd_learnable(
            ft, nnz, w, gy, xi)[ft.gather]).abs().max()),
        float((torch.sparse.sampled_addmm(pattern, gy, xt, beta=0.0).values()
               - K1.drspmm_dw_learnable(f, nnz, gy, xv, xi)[csr_order]
               ).abs().max())]
    log(f"library yardsticks vs kernels (forward, dx, dW): max |diff| "
        f"{lib_err}")
    # kernel 9's own device time beside its library call's, and the
    # forward arena's chunk runs (the kernel takes the slots flat, so a
    # long run sets no chain)
    dev = [device_breakdown(lambda: [fn() for _ in range(REPS)])[1] / REPS
           for fn in (lambda: K1.drspmm_dw_learnable(f, nnz, gy, xv, xi),
                      lambda: torch.sparse.sampled_addmm(pattern, gy, xt,
                                                         beta=0.0))]
    runs_f = torch.diff(f.blk_ptr)
    log(f"kernel drspmm_dw_learnable: arena {tuple(f.nbr.shape)}, "
        f"{int((f.eid >= 0).sum())} real slots, longest chunk run "
        f"{int(runs_f.max())} chunks, {int((runs_f >= 32).sum())} runs of "
        f">= 32 chunks; ms={rows['drspmm_dw_learnable']['ms']}; device ms a "
        f"call (profiler) {dev[0]} (kernel), {dev[1]} (library: "
        f"sampled_addmm)")
    return rows


def bucket_csr(b, n_src):
    """One degree bucket's slab as a bucket-local (R, n_src) CSR matrix
    (the library yardstick)."""
    warnings.filterwarnings("ignore", message="Sparse")
    r, e = b.nbr.shape
    mask = b.w != 0
    rows = torch.arange(r, device=b.w.device)[:, None].expand(r, e)
    return torch.sparse_coo_tensor(
        torch.stack([rows[mask], b.nbr.long()[mask]]), b.w[mask],
        (r, n_src)).coalesce().to_sparse_csr()


def check_bucket_kernels(model, graph, bucket_cfg):
    """Kernels 10-12 on every degree bucket of the first Table-1
    partition's ``near`` relation, each against its plain version: kernel
    10 on the first layer's cell CBSR operand, kernel 11 on the transposed
    buckets with the cotangent the ``"bucket"`` training loss sends back to
    that layer, kernel 12 on the first layer's dense cell embedding.  A
    kernel's row sums the relation's buckets: its time, its plain version's
    and its library yardstick's (``torch.sparse.mm`` of each bucket's CSR)
    are summed over the buckets, its bound is the whole loop's (operand
    rows counted once).  Each kernel and its library call are also timed by
    ``torch.profiler`` on each bucket (logged, not in the row).  Kernels
    11 and 12 also log each output's SHA-256 and the L2 sectors their
    gathers touch beside the byte bound, and kernel 12 is logged over the
    transposed buckets with kernel 11's cotangent as well."""
    from repro_torch.kernels import drspmm as K1
    from repro_torch.kernels import ops
    from repro_torch.models.hgnn import loss_fn
    near = graph.edges["near"]
    bk = ops.device_buckets(near.adj, "cuda")
    bk_t = ops.device_buckets(near.adj_t, "cuda")
    fwd_calls = []

    def run():
        nonlocal fwd_calls
        fwd_calls = record_calls(K1, "drspmm_fwd_bucket", lambda: loss_fn(
            model, graph, bucket_cfg).backward())

    bwd_calls = record_calls(K1, "drspmm_bwd_bucket", run)
    model.zero_grad(set_to_none=True)
    # layer 1 runs forward first and backward last
    fwd_of = {id(b): next(a for a in fwd_calls if a[0] is b)
              for b in bk.buckets}
    bwd_of = {id(b): [a for a in bwd_calls if a[0] is b][-1]
              for b in bk_t.buckets}
    with torch.inference_mode():
        h_cell = (graph.x_cell @ model.in_cell).contiguous()
    n_src, dim = near.adj.n_src, HIDDEN
    specs = {
        "drspmm_fwd_bucket": (
            "drspmm_bucket_fwd.cu", "src/repro/kernels/drspmm.py:122", bk,
            lambda b: fwd_of[id(b)][1:3] + (dim,), 1.0),
        "drspmm_bwd_bucket": (
            "drspmm_bucket_bwd.cu", "src/repro/kernels/drspmm.py:178", bk_t,
            lambda b: bwd_of[id(b)][1:3], 0.0),
        "spmm_bucket": (
            "spmm_bucket.cu", "src/repro/kernels/drspmm.py:231", bk,
            lambda b: (h_cell,), 1.0)}
    rows = {}
    for name, (src, replaces, pack, args_of, floor) in specs.items():
        kern = getattr(K1, name)
        plain = getattr(K1, name + "_plain")
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, err=0.0,
                   slab=0, out=0, real=0, ops=0.0, device_ms=0.0,
                   library_device_ms=0.0)
        used = set()
        for b in pack.buckets:
            args = args_of(b)
            out, ref = kern(b, *args), plain(b, *args)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            tol = 1e-5 * max(floor, float(ref.abs().max()))
            if not torch.allclose(out, ref, rtol=1e-5, atol=tol):
                problem(f"{name} kernel disagrees with its plain version on "
                        f"bucket {tuple(b.nbr.shape)}: {err}")
            csr = bucket_csr(b, args[0].shape[0])
            if name == "drspmm_fwd_bucket":
                xd = K1._densify(args[0], args[1], dim)
                lib = lambda: csr @ xd
                width, row_bytes = args[0].shape[1], 8 * args[0].shape[1]
            elif name == "drspmm_bwd_bucket":
                gy, xi_rows = args
                xl = xi_rows.long()
                lib = lambda: torch.gather(csr @ gy, 1, xl)
                width, row_bytes = xi_rows.shape[1], 4 * gy.shape[1]
            else:
                lib = lambda: csr @ h_cell
                width, row_bytes = dim, 4 * dim
            real = b.w != 0
            used.update(b.nbr[real].unique().tolist())
            r, e = b.nbr.shape
            extra = 4 * r * width if name == "drspmm_bwd_bucket" else 0
            slab = 8 * r * e + extra            # + xi_rows (kernel 11)
            n_real = int(real.sum())
            b_ms, b_by = bound(slab + row_bytes * int(b.nbr[real].unique()
                                                      .numel())
                               + 4 * r * out.shape[1], 2.0 * n_real * width)
            t = dict(ms=cuda_ms(lambda: kern(b, *args)),
                     plain_ms=cuda_ms(lambda: plain(b, *args)),
                     library_ms=cuda_ms(lib))
            tail = ""
            if name != "drspmm_fwd_bucket":
                sectors = bucket_sectors(b, args)
                tot["sectors"] = tot.get("sectors", 0) + sectors
                y_sha = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
                tail = f" sha256={y_sha} l2_sector_bytes={sectors}"
            log(f"kernel {name} bucket R={r} E={e} real_slots={n_real}: "
                f"max_abs_err={err} (max |ref| {float(ref.abs().max())}) "
                f"ms={t['ms']} plain_ms={t['plain_ms']} bound_ms={b_ms} "
                f"({b_by}) library_ms={t['library_ms']}{tail}")
            # the kernel's own device time beside its library call's (the
            # events read the host's launch rate where a call is shorter
            # than its launch)
            dev = [device_breakdown(
                lambda: [fn() for _ in range(REPS)])[1] / REPS
                for fn in (lambda: kern(b, *args), lib)]
            log(f"kernel {name} bucket R={r} E={e}: device ms a call "
                f"(profiler) {dev[0]} (kernel), {dev[1]} (library)")
            tot["device_ms"] += dev[0]
            tot["library_device_ms"] += dev[1]
            for key in ("ms", "plain_ms", "library_ms"):
                tot[key] += t[key]
            tot["err"] = max(tot["err"], err)
            tot["slab"] += slab
            tot["out"] += 4 * r * out.shape[1]
            tot["real"] += n_real
            tot["ops"] += 2.0 * n_real * width
        n_bytes = tot["slab"] + row_bytes * len(used) + tot["out"]
        b_ms, b_by = bound(n_bytes, tot["ops"])
        rows[name] = dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{src}",
            replaces=replaces, max_abs_err=tot["err"], ms=tot["ms"],
            plain_ms=tot["plain_ms"], bound_ms=b_ms, bound_by=b_by,
            library_ms=tot["library_ms"])
        log(f"kernel {name}: {len(pack.buckets)} buckets of near "
            f"(n_src {n_src}), {tot['real']} real slots, {n_bytes} bytes: "
            f"max_abs_err={tot['err']} ms={tot['ms']} "
            f"plain_ms={tot['plain_ms']} bound_ms={b_ms} ({b_by}) "
            f"library_ms={tot['library_ms']} (sums over the buckets)")
        log(f"kernel {name}: device ms (profiler, sums over the "
            f"buckets) {tot['device_ms']} (kernel), "
            f"{tot['library_device_ms']} (library)"
            + (f"; l2_sector_bytes={tot['sectors']} beside the bound's "
               f"{n_bytes} bytes" if "sectors" in tot else ""))
    # kernel 12 over the transposed buckets, the cotangent as its operand
    # (the gcn baseline's backward on buckets walks such slabs)
    dev_sum = [0.0, 0.0]
    for b in bk_t.buckets:
        gy = bwd_of[id(b)][1]
        out, ref = K1.spmm_bucket(b, gy), K1.spmm_bucket_plain(b, gy)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        if not torch.allclose(out, ref, rtol=1e-5,
                              atol=1e-5 * float(ref.abs().max())):
            problem(f"spmm_bucket kernel disagrees with its plain version "
                    f"on transposed bucket {tuple(b.nbr.shape)}: {err}")
        csr = bucket_csr(b, gy.shape[0])
        dev = [device_breakdown(
            lambda: [fn() for _ in range(REPS)])[1] / REPS
            for fn in (lambda: K1.spmm_bucket(b, gy), lambda: csr @ gy)]
        dev_sum = [a + d for a, d in zip(dev_sum, dev)]
        y_sha = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
        log(f"kernel spmm_bucket transposed bucket R={b.nbr.shape[0]} "
            f"E={b.nbr.shape[1]} real_slots={int((b.w != 0).sum())} "
            f"l2_sector_bytes={bucket_sectors(b, (gy,))}: max_abs_err={err} "
            f"sha256={y_sha}; device ms a call (profiler) {dev[0]} "
            f"(kernel), {dev[1]} (library: csr @ gy)")
    log(f"kernel spmm_bucket: device ms (profiler, sums over the transposed "
        f"buckets) {dev_sum[0]} (kernel), {dev_sum[1]} (library)")
    return rows


def bucket_sectors(b, args):
    """The 32-byte L2 sectors the real slots of bucket ``b`` touch: a whole
    operand row a slot (kernel 12, ``args`` = (x,)), or the distinct
    sectors of the row's sampled columns (kernel 11, ``args`` = (gY,
    xi_rows))."""
    real = (b.w != 0).sum(1)
    if len(args) == 1:
        return int(real.sum()) * -(-4 * args[0].shape[1] // 32) * 32
    s = torch.sort(args[1].long() // 8, dim=1).values
    distinct = 1 + (s[:, 1:] != s[:, :-1]).sum(1)
    return int((real * distinct).sum()) * 32


def learnable_slabs_path(model, graph, wrappers):
    """One call of the edge-id slab entry point ``drspmm_learnable``
    under ``backend="bucket"`` on the first Table-1 partition's ``near``
    relation (weights gathered from ``w_canon``, kernels 10/11): the
    output and both gradients against the same call on the CPU (the plain
    versions).  Returns the launch counts of the card's call."""
    import numpy as np
    from repro_torch.core.hetero_mp import HeteroMPConfig, _sparsify_types
    from repro_torch.graphs.ell import ell_to_coo, pack_eid_slabs
    from repro_torch.kernels.learnable import drspmm_learnable
    near = graph.edges["near"].adj
    d, s_, w = ell_to_coo(near)
    fs, bs, order, nnz = pack_eid_slabs(d, s_, near.n_dst, near.n_src)
    with torch.no_grad():
        c_cell, _ = _sparsify_types(
            graph.x_cell @ model.in_cell, graph.x_net @ model.in_net,
            HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K))
    xv0, xi0 = c_cell.values, c_cell.idx
    gy0 = torch.randn((near.n_dst, HIDDEN),
                      generator=torch.Generator().manual_seed(SEED))
    outs = []
    for dev in ("cuda", "cpu"):
        wc = torch.from_numpy(np.ascontiguousarray(w[order])).to(
            dev).requires_grad_()
        xv = xv0.to(dev, copy=True).requires_grad_()
        if dev == "cuda":
            for wr in wrappers.values():
                wr.launches = 0
        y = drspmm_learnable(fs, bs, nnz, wc, xv, xi0.to(dev), HIDDEN,
                             backend="bucket")
        y.backward(gy0.to(dev))
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = {k: wr.launches for k, wr in wrappers.items()}
        outs.append([t.detach().cpu() for t in (y, wc.grad, xv.grad)])
    log(f"path learnable-slabs-bucket: nnz={nnz}, "
        f"{len(fs.buckets)} forward / {len(bs.buckets)} transposed slabs, "
        f"launches={launches}")
    check_launches("learnable-slabs-bucket", launches,
                   ["drspmm_fwd_bucket", "drspmm_bwd_bucket"],
                   ["drspmm_fwd_learnable", "drspmm_bwd_learnable",
                    "drspmm_dw_learnable", "spmm_bucket"])
    if (launches["drspmm_fwd_bucket"], launches["drspmm_bwd_bucket"]) != \
            (len(fs.buckets), len(bs.buckets)):
        problem("path learnable-slabs-bucket: not one launch per slab")
    for nm, a, r in zip(("y", "dL/dw", "dL/dx_vals"), *outs):
        err = float((a - r).abs().max())
        log(f"path learnable-slabs-bucket: {nm} max_abs_err={err} "
            f"(max |ref| {float(r.abs().max())})")
        if not torch.allclose(a, r, rtol=1e-5,
                              atol=1e-5 * float(r.abs().max())):
            problem(f"path learnable-slabs-bucket: {nm} differs from the "
                    f"CPU by {err}")
    return launches


def backward_operands(model, batch, cfg):
    """(gY, xi) that the first layer's DR-SpMM backward receives from the
    batch's training loss: the loss is run backward once with the op's
    tiered backward wrapped to record its operands."""
    from repro_torch.kernels import ops
    from repro_torch.models.hgnn import batched_loss_fn
    seen = []
    tiered = ops._hybrid_bwd

    def record(plan, gy_cat, xi):
        seen.append((gy_cat.detach().clone(), xi))
        return tiered(plan, gy_cat, xi)

    ops._hybrid_bwd = record
    try:
        batched_loss_fn(model, batch.graph, batch.cell_weight,
                        cfg).backward()
    finally:
        ops._hybrid_bwd = tiered
        model.zero_grad(set_to_none=True)
    return seen[-1]          # layers run backward last to first


def check_bwd_kernels(model, cfg, big, small):
    """The two sampled-backward kernels against their plain versions on
    the card, on the cotangents of real training losses.  Those are small
    (the loss is a mean over the batch's cells), so the tolerance scales
    with the reference's magnitude without a floor."""
    from repro_torch.kernels import drspmm as K1
    rows = {}
    tol = lambda ref: 1e-5 * float(ref.abs().max())

    # kernel 4: the transposed super-arena of the first Table-1 batch
    plan = big.plan
    gy, xi = backward_operands(model, big, cfg)
    f = plan.bwd
    src = plan.bwd_src_rows
    y = K1.drspmm_bwd_arena(f, src, gy, xi)
    ref = K1.drspmm_bwd_arena_plain(f, src, gy, xi)
    torch.cuda.synchronize()
    err = float((y - ref).abs().max())
    if not torch.allclose(y, ref, rtol=1e-5, atol=tol(ref)):
        problem(f"arena backward kernel disagrees with its plain version: "
                f"{err}")
    y_sha = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()
    c, br, ec = f.nbr.shape
    k = xi.shape[1]
    real = int((f.w != 0).sum())
    a_t = arena_csr(f, gy.shape[0])
    n_bytes = 4 * (f.blk_ptr.numel() + 2 * f.nbr.numel() + src.numel()
                   + xi.numel() + gy.numel() + f.n_arena_rows * k)
    b_ms, b_by = bound(n_bytes, 2.0 * real * k)
    rows["drspmm_bwd_arena"] = dict(
        name="drspmm_bwd_arena", route="cuda",
        source="src/repro_torch/csrc/drspmm_arena_bwd.cu",
        replaces="src/repro/kernels/drspmm.py:344",
        max_abs_err=err, ref_max=float(ref.abs().max()),
        ms=cuda_ms(lambda: K1.drspmm_bwd_arena(f, src, gy, xi)),
        plain_ms=cuda_ms(lambda: K1.drspmm_bwd_arena_plain(f, src, gy, xi)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: a_t @ gy))
    log(f"kernel drspmm_bwd_arena: C={c} BR={br} Ec={ec} "
        f"R_arena={f.n_arena_rows} M={gy.shape[0]} N_src={xi.shape[0]} "
        f"k={k} dim={gy.shape[1]} real_slots={real} bytes={n_bytes}; "
        f"library_ms is torch.sparse.mm of the CSR Aᵀ by gY: the unsampled "
        f"(R_arena, dim) product, dim/k = {gy.shape[1] / k} times the "
        f"outputs")
    dev = [device_breakdown(lambda: [fn() for _ in range(REPS)])[1] / REPS
           for fn in (lambda: K1.drspmm_bwd_arena(f, src, gy, xi),
                      lambda: a_t @ gy)]
    log(f"kernel drspmm_bwd_arena: device ms a call (profiler) {dev[0]} "
        f"(kernel), {dev[1]} (library: a_t @ gy); output SHA-256 {y_sha}")

    # kernel 5: the stacked transposed dense-tier table of a scale-0.02
    # batch, on the dense segments' rows of a real cotangent
    plan = small.plan
    if not plan.has_dense:
        fail("the scale-0.02 batch has no dense-tier relation")
    gy_cat, xi = backward_operands(model, small, cfg)
    gy = torch.cat([gy_cat[s.out_off:s.out_off + s.n_dst]
                    for s in plan.dense_segments]).contiguous()
    a = plan.dense_bwd
    y = K1.drspmm_dense_tier_bwd(a, gy, xi)
    ref = K1.drspmm_dense_tier_bwd_plain(a, gy, xi)
    torch.cuda.synchronize()
    err = float((y - ref).abs().max())
    if not torch.allclose(y, ref, rtol=1e-5, atol=tol(ref)):
        problem(f"dense-tier backward kernel disagrees with its plain "
                f"version: {err}")
    n, m = a.shape
    k = xi.shape[1]
    nnz = int((a != 0).sum())
    b_ms, b_by = bound(4.0 * (n * m + gy.numel() + 2 * n * k),
                       2.0 * nnz * k)
    rows["drspmm_dense_tier_bwd"] = dict(
        name="drspmm_dense_tier_bwd", route="cuda",
        source="src/repro_torch/csrc/drspmm_dense_tier_bwd.cu",
        replaces="src/repro/kernels/drspmm.py:555",
        max_abs_err=err, ref_max=float(ref.abs().max()),
        ms=cuda_ms(lambda: K1.drspmm_dense_tier_bwd(a, gy, xi)),
        plain_ms=cuda_ms(lambda: K1.drspmm_dense_tier_bwd_plain(a, gy, xi)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.mm(a, gy)))
    dev = [device_breakdown(lambda: [fn() for _ in range(REPS)])[1] / REPS
           for fn in (lambda: K1.drspmm_dense_tier_bwd(a, gy, xi),
                      lambda: torch.mm(a, gy))]
    log(f"kernel drspmm_dense_tier_bwd: N={n} M={m} nnz={nnz} k={k} "
        f"dim={gy.shape[1]}; library_ms is torch.mm of Aᵀ by gY: the "
        f"unsampled dense (N, dim) product; device ms a call (profiler) "
        f"{dev[0]} (kernel), {dev[1]} (library)")
    for r in rows.values():
        log(f"  {r['name']}: max_abs_err={r['max_abs_err']} (max |ref| "
            f"{r['ref_max']}) ms={r['ms']} plain_ms={r['plain_ms']} "
            f"bound_ms={r['bound_ms']} ({r['bound_by']}) "
            f"library_ms={r['library_ms']}")
    return rows


def serve_path(name, model, cfg, graphs, cpu_model, wrappers, expect):
    """Serve ``graphs`` (max_batch 2), hold every prediction against the
    CPU forward, and return the kernels' launch counts of this path."""
    from repro_torch.serve.circuit_engine import CircuitServeEngine
    eng = CircuitServeEngine(model, cfg, max_batch=2, device="cuda")
    for w in wrappers.values():
        w.launches = 0
    rids = [eng.submit(g) for g in graphs]
    done = eng.run()
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    st = eng.stats()
    log(f"path {name}: {json.dumps(st)} launches={launches}")
    for k in expect:
        if launches[k] == 0:
            problem(f"path {name}: kernel {k} was never launched")
    n_cells = n_far = 0
    worst = 0.0
    for rid, g in zip(rids, graphs):
        r = done[rid]
        if r.error is not None:
            problem(f"path {name}: request {rid} failed: {r.error!r}")
        if r.pred.shape != (g.n_cell,) or not torch.isfinite(
                torch.from_numpy(r.pred)).all():
            problem(f"path {name}: request {rid} output malformed")
        with torch.no_grad():
            ref = cpu_model(g, cfg).numpy()
        diff = abs(r.pred - ref)
        n_cells += diff.size
        n_far += int((diff > CELL_ATOL).sum())
        worst = max(worst, float(diff.max()))
    share = 1.0 - n_far / n_cells
    log(f"path {name}: {n_cells} cells, {n_far} beyond {CELL_ATOL} of the "
        f"CPU forward (share within {share}), max |diff| {worst}")
    if share < CELL_SHARE:
        problem(f"path {name}: only {share} of cells within {CELL_ATOL}")
    return launches, st


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| (0 when both are 0)."""
    den = float(torch.linalg.norm(b))
    num = float(torch.linalg.norm(a - b))
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def check_launches(name, launches, expect, forbid=()):
    for k in expect:
        if launches[k] == 0:
            problem(f"path {name}: kernel {k} was never launched")
    for k in forbid:
        if launches[k] != 0:
            problem(f"path {name}: kernel {k} was launched "
                    f"{launches[k]} times")


def train_path(name, cfg, graphs, state, wrappers, expect, forbid=(),
               per_step=None):
    """``CircuitTrainer.fit`` on the card from the weights ``state``, held
    against a CPU trainer started from the same weights on the same
    batches: the first step's gradients per parameter, and every step's
    loss.  ``per_step`` pins the launches of ``expect[0]`` per step.
    Returns the kernels' launch counts of the card's fit."""
    from repro_torch.models.hgnn import DRCircuitGNN, batched_loss_fn
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.train.circuit_trainer import CircuitTrainer
    trainers = []
    for dev in ("cuda", "cpu"):
        m = DRCircuitGNN(FEAT, FEAT, HIDDEN, LAYERS, device=dev)
        m.load_state_dict(state)
        trainers.append(CircuitTrainer(cfg, FEAT, FEAT, model=m, device=dev))
    gpu, cpu = trainers

    def first_loss(tr):
        graph, cell_w, _ = tr._collate(graphs[:cfg.batch_size])
        return batched_loss_fn(tr.model, graph, cell_w, tr.mp_cfg, tr.spec)

    grads = []
    for tr in trainers:
        first_loss(tr).backward()
        grads.append({n: (torch.zeros_like(p) if p.grad is None
                          else p.grad).detach().cpu()
                      for n, p in tr.model.named_parameters()})
        tr.model.zero_grad(set_to_none=True)
    g_err = {n: rel_l2(grads[0][n], grads[1][n]) for n in grads[1]}
    worst = max(g_err, key=g_err.get)
    log(f"path {name}: first-step gradients, worst relative L2 "
        f"{g_err[worst]} ({worst})")
    if g_err[worst] > GRAD_RTOL:
        problem(f"path {name}: first-step gradient of {worst} differs from "
                f"the CPU by {g_err[worst]} (relative L2)")

    for w in wrappers.values():
        w.launches = 0
    t = time.perf_counter()
    hist = gpu.fit(graphs)["history"]
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"path {name}: fit {fit_s:.3f} s, epoch losses "
        f"{[h['loss'] for h in hist]}, {json.dumps(gpu.stats())} "
        f"launches={launches}")
    check_launches(name, launches, expect, forbid)
    n_steps = len(gpu.step_loss)
    if per_step is not None and launches[expect[0]] != per_step * n_steps:
        problem(f"path {name}: {launches[expect[0]]} launches of "
                f"{expect[0]} in {n_steps} steps, expected {per_step} a step")
    cpu.fit(graphs)
    worst = 0.0
    for i, (lg, lc) in enumerate(zip(gpu.step_loss, cpu.step_loss)):
        d = abs(lg - lc) / abs(lc)
        worst = max(worst, d)
        if not d <= LOSS_RTOL:
            problem(f"path {name}: step {i} loss {lg} on the card, {lc} on "
                    f"the CPU")
    if len(gpu.step_loss) != len(cpu.step_loss) or not gpu.step_loss:
        problem(f"path {name}: {len(gpu.step_loss)} steps on the card, "
                f"{len(cpu.step_loss)} on the CPU")
    log(f"path {name}: {len(gpu.step_loss)} steps, worst relative loss "
        f"difference to the CPU trainer {worst}")
    ev = gpu.evaluate(graphs)
    log(f"path {name}: evaluate pearson={ev['pearson']} "
        f"spearman={ev['spearman']} mae={ev['mae']}")
    if not all(map(lambda v: v == v, ev.values())):
        problem(f"path {name}: evaluate gave non-finite metrics {ev}")

    # where a training step's time goes on the card (cached first batch)
    fwd_ms = cuda_ms(lambda: first_loss(gpu), 5)
    fb_ms = cuda_ms(lambda: first_loss(gpu).backward(), 5)
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in gpu.params]
    opt_ms = cuda_ms(lambda: adamw_update(gpu.params, grads, gpu.opt_state,
                                          0.0), 5)
    gpu.model.zero_grad(set_to_none=True)
    log(f"path {name}: step breakdown on the card: forward+loss {fwd_ms} "
        f"ms, forward+backward {fb_ms} ms, AdamW {opt_ms} ms; host step "
        f"p50 {gpu.stats()['step_p50_ms']} ms")
    return launches


def drelu_masks(model, graph, cfg):
    """The keep mask of every D-ReLU the model's forward of ``graph``
    applies, in order, on the host."""
    from repro_torch.core import drelu as D
    masks = []
    orig = D._DReLU.__dict__["forward"]

    def forward(ctx, x, k):
        th = torch.topk(x, k, dim=-1).values[..., -1:]
        masks.append((x >= th).cpu())
        return orig.__func__(ctx, x, k)

    D._DReLU.forward = staticmethod(forward)
    try:
        with torch.no_grad():
            model(graph, cfg)
    finally:
        D._DReLU.forward = orig
    return masks


def lockstep_path(name, cfg, graphs, state, wrappers, expect, forbid,
                  count_of):
    """Train single graphs on the card for ``cfg.epochs`` epochs, each step
    in lockstep with a CPU trainer that takes it from the card's weights
    and optimizer state, on the same graph.  A step's losses must agree
    within LOCKSTEP_RTOL; where they do not, both forwards' D-ReLU masks
    are compared, and a step whose masks differ (a near-tied pick that
    GPU-vs-CPU rounding flips) is held to LOSS_RTOL instead and reported.
    ``count_of(g)`` gives each kernel's launches for a step on ``g``; the
    run's counts must equal their sum.  Returns the card's launch
    counts."""
    from repro_torch.models.hgnn import DRCircuitGNN, loss_fn
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.train.circuit_trainer import CircuitTrainer
    trainers = []
    for dev in ("cuda", "cpu"):
        m = DRCircuitGNN(FEAT, FEAT, HIDDEN, LAYERS, device=dev)
        m.load_state_dict(state)
        trainers.append(CircuitTrainer(cfg, FEAT, FEAT, model=m, device=dev))
    gpu, cpu = trainers

    def first_loss(tr):
        return loss_fn(tr.model, tr._planned(graphs[0]), tr.mp_cfg, tr.spec)

    grads = []
    for tr in trainers:
        first_loss(tr).backward()
        grads.append({n: (torch.zeros_like(p) if p.grad is None
                          else p.grad).detach().cpu()
                      for n, p in tr.model.named_parameters()})
        tr.model.zero_grad(set_to_none=True)
    g_err = {n: rel_l2(grads[0][n], grads[1][n]) for n in grads[1]}
    worst = max(g_err, key=g_err.get)
    log(f"path {name}: first-step gradients, worst relative L2 "
        f"{g_err[worst]} ({worst})")
    if g_err[worst] > GRAD_RTOL:
        problem(f"path {name}: first-step gradient of {worst} differs from "
                f"the CPU by {g_err[worst]} (relative L2)")

    expected = {}
    for w in wrappers.values():
        w.launches = 0
    launches = dict.fromkeys(wrappers, 0)
    diffs, flips = [], []
    t = time.perf_counter()
    for ep in range(cfg.epochs):
        for g in graphs:
            for k, v in count_of(g).items():
                expected[k] = expected.get(k, 0) + v
            # the CPU trainer takes this step from the card's state
            with torch.no_grad():
                for p, q in zip(cpu.params, gpu.params):
                    p.copy_(q)
                for a, b in zip(cpu.opt_state.m + cpu.opt_state.v,
                                gpu.opt_state.m + gpu.opt_state.v):
                    a.copy_(b)
            cpu.opt_state.step = gpu.opt_state.step
            pre_state = {k: v.detach().clone()
                         for k, v in cpu.model.state_dict().items()}
            before = {k: w.launches for k, w in wrappers.items()}
            lg = gpu.train_epoch([g])
            for k, w in wrappers.items():      # the step's own launches
                launches[k] += w.launches - before[k]
            lc = cpu.train_epoch([g])
            d = abs(lg - lc) / abs(lc)
            diffs.append(d)
            if not d <= LOCKSTEP_RTOL:
                # the step's forward from the pre-step state, both sides
                pre = DRCircuitGNN(FEAT, FEAT, HIDDEN, LAYERS, device="cpu")
                pre.load_state_dict(pre_state)
                card = DRCircuitGNN(FEAT, FEAT, HIDDEN, LAYERS,
                                    device="cuda")
                card.load_state_dict(pre_state)
                ma = drelu_masks(card, gpu._planned(g), gpu.mp_cfg)
                mb = drelu_masks(pre, cpu._planned(g), cpu.mp_cfg)
                n_flip = sum(int((a != b).any(-1).sum())
                             for a, b in zip(ma, mb))
                flips.append((len(diffs) - 1, n_flip, d))
                if n_flip == 0 or not d <= LOSS_RTOL:
                    problem(f"path {name}: step {len(diffs) - 1} loss {lg} "
                            f"on the card, {lc} on the CPU ({n_flip} "
                            f"D-ReLU mask rows differ)")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    log(f"path {name}: {len(diffs)} lockstep steps in {fit_s:.3f} s, "
        f"losses {gpu.step_loss}, {json.dumps(gpu.stats())} "
        f"launches={launches}")
    log(f"path {name}: relative loss difference to the CPU per step "
        f"{diffs}; steps beyond {LOCKSTEP_RTOL} (step, D-ReLU mask rows "
        f"that differ, difference): {flips}")
    check_launches(name, launches, expect, forbid)
    for k, v in expected.items():
        if launches[k] != v:
            problem(f"path {name}: {launches[k]} launches of {k}, expected "
                    f"{v} from the graphs' bucket and relation counts")
    ev = gpu.evaluate(graphs)
    log(f"path {name}: evaluate pearson={ev['pearson']} "
        f"spearman={ev['spearman']} mae={ev['mae']}")
    if not all(map(lambda v: v == v, ev.values())):
        problem(f"path {name}: evaluate gave non-finite metrics {ev}")
    fwd_ms = cuda_ms(lambda: first_loss(gpu), 5)
    fb_ms = cuda_ms(lambda: first_loss(gpu).backward(), 5)
    grads = [torch.zeros_like(p) if p.grad is None else p.grad
             for p in gpu.params]
    opt_ms = cuda_ms(lambda: adamw_update(gpu.params, grads, gpu.opt_state,
                                          0.0), 5)
    gpu.model.zero_grad(set_to_none=True)
    log(f"path {name}: step breakdown on the card: forward+loss {fwd_ms} "
        f"ms, forward+backward {fb_ms} ms, AdamW {opt_ms} ms; host step "
        f"p50 {gpu.stats()['step_p50_ms']} ms")
    return launches


def n_buckets(*packs):
    return sum(len(p.buckets) for p in packs)


def bucket_counts(g, k_net):
    """Per-step launches of kernels 10-12 on ``g`` under ``"bucket"`` (2
    layers): forward every relation's buckets in both layers; backward
    every relation's transposed buckets but the last layer's ``pin``,
    whose output never reaches the loss.  With k_net >= hidden ``pinned``
    runs the SpMM kernel (forward over A, backward over Aᵀ)."""
    e = g.edges
    c = {"drspmm_fwd_bucket": 2 * n_buckets(e["near"].adj, e["pin"].adj),
         "drspmm_bwd_bucket": 2 * n_buckets(e["near"].adj_t)
         + n_buckets(e["pin"].adj_t), "spmm_bucket": 0}
    pinned = 2 * n_buckets(e["pinned"].adj)
    pinned_t = 2 * n_buckets(e["pinned"].adj_t)
    if k_net >= HIDDEN:
        c["spmm_bucket"] = pinned + pinned_t
    else:
        c["drspmm_fwd_bucket"] += pinned
        c["drspmm_bwd_bucket"] += pinned_t
    return c


def serial_counts(g):
    """Per-step launches of kernels 1/2/4/5 on ``g`` under ``use_plan=False``
    with the fused family (2 layers): one launch per relation and layer,
    the dense tier for a relation at or below the crossover, no backward
    for the last layer's ``pin``."""
    from repro_torch.kernels.ops import _dense_tier_single
    c = dict.fromkeys(("drspmm_fwd_arena", "drspmm_bwd_arena",
                       "drspmm_dense_tier_fwd", "drspmm_dense_tier_bwd"), 0)
    for et in ("near", "pin", "pinned"):
        dense = _dense_tier_single(g.edges[et].adj)
        fwd, bwd = (("drspmm_dense_tier_fwd", "drspmm_dense_tier_bwd")
                    if dense else ("drspmm_fwd_arena", "drspmm_bwd_arena"))
        c[fwd] += 2
        c[bwd] += 1 if et == "pin" else 2
    return c


def homo_path(name, kind, homo, wrappers, expect, forbid, steps=3,
              backend="fused", per_step=None):
    """A homogeneous baseline (hidden 64, 3 layers, seeded weights) trained
    ``steps`` AdamW steps on the card (lr 1e-3, weight decay 2e-4, as
    ``benchmarks/bench_table2.py::train_homo``) with ``backend``, held
    against the same steps on the CPU: the first step's gradients and
    every step's loss.  ``per_step`` pins the launches of ``expect[0]`` a
    step.  Returns the kernels' launch counts of the card's steps."""
    from repro_torch.models.hgnn import HomoGNN, homo_forward
    from repro_torch.optim.adamw import adamw_init, adamw_update
    adj, adj_t, x, y, n_cell = homo
    models = []
    for dev in ("cuda", "cpu"):
        m = HomoGNN(x.shape[1], HIDDEN, 3, kind, adj.nnz, device=dev,
                    generator=torch.Generator().manual_seed(SEED))
        models.append((m, x.to(dev), y.to(dev)))

    def loss_of(m, xd, yd):
        return torch.mean((homo_forward(m, adj, adj_t, xd, n_cell,
                                        backend=backend) - yd) ** 2)

    def grads_of(m):
        return [torch.zeros_like(p) if p.grad is None else p.grad
                for p in m.parameters()]

    first = []
    for m, xd, yd in models:
        loss_of(m, xd, yd).backward()
        first.append([g.detach().cpu().clone() for g in grads_of(m)])
        m.zero_grad(set_to_none=True)
    names = [n for n, _ in models[1][0].named_parameters()]
    g_err = {n: rel_l2(a, b) for n, a, b in zip(names, *first)}
    worst = max(g_err, key=g_err.get)
    log(f"path {name}: first-step gradients, worst relative L2 "
        f"{g_err[worst]} ({worst})")
    if g_err[worst] > GRAD_RTOL:
        problem(f"path {name}: first-step gradient of {worst} differs from "
                f"the CPU by {g_err[worst]} (relative L2)")

    losses, step_ms, launches = [], [], None
    for i, (m, xd, yd) in enumerate(models):
        params = list(m.parameters())
        state = adamw_init(params)
        if i == 0:
            for w in wrappers.values():
                w.launches = 0
        ls = []
        for _ in range(steps):
            t = time.perf_counter()
            m.zero_grad(set_to_none=True)
            loss = loss_of(m, xd, yd)
            loss.backward()
            adamw_update(params, grads_of(m), state, 1e-3,
                         weight_decay=2e-4)
            ls.append(float(loss.detach()))         # barrier ends the step
            if i == 0:
                step_ms.append((time.perf_counter() - t) * 1e3)
        if i == 0:
            torch.cuda.synchronize()
            launches = {k: w.launches for k, w in wrappers.items()}
        losses.append(ls)
    log(f"path {name}: {steps} steps, losses {losses[0]} (CPU {losses[1]}), "
        f"host step ms {step_ms}, launches={launches}")
    check_launches(name, launches, expect, forbid)
    if per_step is not None and launches[expect[0]] != per_step * steps:
        problem(f"path {name}: {launches[expect[0]]} launches of "
                f"{expect[0]} in {steps} steps, expected {per_step} a step")
    worst = max(abs(a - b) / abs(b) for a, b in zip(*losses))
    log(f"path {name}: worst relative loss difference to the CPU {worst}")
    if not worst <= LOSS_RTOL:
        problem(f"path {name}: step losses {losses[0]} on the card, "
                f"{losses[1]} on the CPU")

    m, xd, yd = models[0]
    params = list(m.parameters())
    fwd_ms = cuda_ms(lambda: loss_of(m, xd, yd), 5)
    fb_ms = cuda_ms(lambda: loss_of(m, xd, yd).backward(), 5)
    grads = grads_of(m)
    opt_ms = cuda_ms(lambda: adamw_update(params, grads, adamw_init(params),
                                          0.0), 5)
    m.zero_grad(set_to_none=True)
    log(f"path {name}: step breakdown on the card: forward+loss {fwd_ms} "
        f"ms, forward+backward {fb_ms} ms, AdamW {opt_ms} ms; host step "
        f"p50 {sorted(step_ms)[len(step_ms) // 2]} ms")
    return launches


def modules_time(g, reps=REPS):
    """The three relation SpMMs of one partition as concurrent modules on
    side streams (``run_fused``) and module by module with a synchronise
    after each (``run_sequential``): host ms per layer's worth, synced."""
    from repro_torch.core.parallel import run_fused, run_sequential
    from repro_torch.kernels.ops import spmm
    gen = torch.Generator().manual_seed(SEED)
    x_c = torch.randn((g.n_cell, HIDDEN), generator=gen).cuda()
    x_n = torch.randn((g.n_net, HIDDEN), generator=gen).cuda()
    fns = [lambda x, et=et: spmm(g.edges[et].adj, g.edges[et].adj_t, x)
           for et in ("near", "pin", "pinned")]
    args = [(x_c,), (x_c,), (x_n,)]
    out = {}
    with torch.no_grad():
        for mode, run in (("fused", run_fused), ("sequential", run_sequential),
                          ("fused", run_fused),
                          ("sequential", run_sequential)):
            run(fns, args)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(reps):
                run(fns, args)
            torch.cuda.synchronize()
            out[mode] = (time.perf_counter() - t) * 1e3 / reps
        same = all(torch.equal(a, b) for a, b in zip(
            run_fused(fns, args), run_sequential(fns, args)))
    if not same:
        problem("run_fused and run_sequential disagree")
    return out


# ---------------------------------------------------------------------------
# the dense LM (qwen3-0.6b at full width): kernel 13 and the serving paths
# ---------------------------------------------------------------------------

LM_ARCH = "qwen3-0.6b"
LM_BATCH, LM_PROMPT, LM_NEW = 4, 1008, 16   # examples/serve_lm.py's layout
# bf16, 28 layers: decode at S-1 against the prefill's last logits, rel L2
# (the two round the same numbers through differently shaped products)
DECODE_RTOL = 5e-2
FP32_LM_RTOL = 1e-4          # fp32 depth 2: the card's logits vs the CPU's
CARD = ""                    # nvidia-smi's name and power limit


def lm_tokens(vocab, batch, prompt, total, seed):
    """``examples/serve_lm.py``'s prompts: ``prompt`` random tokens padded
    with zeros to the generation horizon ``total``."""
    toks = torch.randint(0, vocab, (batch, total),
                         generator=torch.Generator().manual_seed(seed))
    toks[:, prompt:] = 0
    return toks


def flash_cases(q, k, v):
    """(label, q, k, v, causal): the prefill's own operands (k/v at their
    KV heads), their first 1000 rows (ragged last tiles) in bf16 and fp32,
    fp32, head dims 32 and 128, a non-causal Sq 128 x Sk 256 call, one KV
    head for all q heads, and S 4,096 at the prefill's 16 / 8 heads."""
    g = torch.Generator("cuda").manual_seed(SEED)
    b, s, h, hd = q.shape

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)

    cases = [("prefill bf16 causal", q, k, v, True),
             ("S1000 bf16 causal", q[:, :1000], k[:, :1000], v[:, :1000],
              True),
             ("S1000 fp32 causal", q[:, :1000].float(), k[:, :1000].float(),
              v[:, :1000].float(), True),
             ("prefill fp32 causal", q.float(), k.float(), v.float(), True)]
    for d in (32, 128):
        for dt in (torch.float32, torch.bfloat16):
            cases.append((f"S1000 hd{d} {str(dt)[6:]} causal",
                          *(rnd(b, 1000, 8, d, dtype=dt) for _ in range(3)),
                          True))
    for dt in (torch.float32, torch.bfloat16):
        cases.append((f"Sq128 Sk256 {str(dt)[6:]} full",
                      rnd(b, 128, h, hd, dtype=dt),
                      rnd(b, 256, h, hd, dtype=dt),
                      rnd(b, 256, h, hd, dtype=dt), False))
    cases.append(("S1000 bf16 causal KV 1", q[:, :1000], k[:, :1000, :1],
                  v[:, :1000, :1], True))
    n_kv = k.shape[2]
    cases.append(("S4096 bf16 causal GQA", rnd(1, 4096, h, hd,
                                                dtype=torch.bfloat16),
                  *(rnd(1, 4096, n_kv, hd, dtype=torch.bfloat16)
                    for _ in range(2)), True))
    return cases


def bf16_limit(ref):
    """Per element: one bf16 ulp of the reference value (the kernel and the
    plain version each round one fp32 result to bf16) plus the fp32 slack
    of 1e-5 scaled by the magnitude, for values near zero."""
    ref = ref.float()
    ulp = torch.exp2((torch.frexp(ref).exponent - 8).float())
    ulp = torch.where(ref == 0, torch.zeros_like(ulp), ulp)
    return ulp + 1e-5 * max(1.0, float(ref.abs().max()))


def check_flash_kernel(q, k, v):
    """Kernel 13 against its plain version: at the prefill's q/k/v (k and v
    at their KV heads) and the cases above; timed at the prefill's shape
    beside SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.lm.attention import tile_kv
    err_main = None
    for label, a, b_, c, causal in flash_cases(q, k, v):
        y = FA.flash_attention(a, b_, c, causal=causal)
        ref = FA.flash_attention_plain(a, b_, c, causal=causal)
        torch.cuda.synchronize()
        diff = (y.float() - ref.float()).abs()
        err = float(diff.max())
        if a.dtype == torch.bfloat16:
            lim = bf16_limit(ref)
        else:
            lim = 1e-5 * (ref.abs() + max(1.0, float(ref.abs().max())))
        worst = float((diff / lim).max())
        ok = worst <= 1.0
        log(f"kernel flash_attention {label}: q {tuple(a.shape)} k "
            f"{tuple(b_.shape)} max_abs_err={err} (worst err/limit {worst}, "
            f"max|ref| {float(ref.float().abs().max())})")
        if not ok or not torch.isfinite(y).all():
            problem(f"flash kernel ({label}) disagrees with its plain "
                    f"version: {err}")
        err_main = err if err_main is None else err_main
    b, s, h, hd = q.shape
    n_kv = k.shape[2]
    # q and the n_kv heads of k and v read once, o written once; QK and PV
    # over the causal half
    b_ms, b_by = bound((2 * h + 2 * n_kv) * b * s * hd * q.element_size(),
                       4.0 * hd * b * h * (s * (s + 1) // 2), H100_BF16_PER_S)
    # SDPA on the same operands: k/v tiled to the q heads outside the timed
    # call (its fastest path), and with enable_gqa on the KV heads
    qt = q.transpose(1, 2)
    kt, vt = (tile_kv(t, h).transpose(1, 2) for t in (k, v))
    kg, vg = (t.transpose(1, 2) for t in (k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    sdpa_gqa = lambda: F.scaled_dot_product_attention(
        qt, kg, vg, is_causal=True, enable_gqa=True)
    log(f"  SDPA against the kernel at the prefill's shape: max_abs_diff="
        f"{float((sdpa().transpose(1, 2).float() - FA.flash_attention(q, k, v).float()).abs().max())}")
    row = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash_attention_fwd.cu",
        replaces="src/repro/kernels/flash_attention.py:71",
        max_abs_err=err_main,
        ms=cuda_ms(lambda: FA.flash_attention(q, k, v)),
        plain_ms=cuda_ms(lambda: FA.flash_attention_plain(q, k, v)),
        bound_ms=b_ms, bound_by=b_by, library_ms=cuda_ms(sdpa))
    # the kernel's own device time (the events above also see the host's
    # launch gaps)
    _, _, names = device_breakdown(
        lambda: [FA.flash_attention(q, k, v) for _ in range(REPS)])
    dev = sum(ms / n for ms, n, name in names if "flash_attention_fwd" in name)
    ratio = row["ms"] / row["library_ms"]
    log(f"  flash_attention (B {b}, S {s}, H {h}, KV {n_kv}, hd {hd}, bf16, "
        f"causal): ms={row['ms']} plain_ms={row['plain_ms']} bound_ms="
        f"{b_ms} ({b_by}) library_ms(SDPA, tiled k/v)={row['library_ms']} "
        f"SDPA enable_gqa ms={cuda_ms(sdpa_gqa)}; kernel device ms a launch "
        f"(profiler) {dev}; kernel/SDPA {ratio} "
        f"(target <= 1.5 and ms <= 0.096: "
        f"{ratio <= 1.5 and row['ms'] <= 0.096}); "
        f"{4.0 * hd * b * h * (s * (s + 1) // 2) / row['ms'] / 1e9:.1f} "
        f"TFLOP/s on the causal FLOPs [{CARD}]")
    return row


def device_breakdown(run):
    """Wall ms of ``run()`` under ``torch.profiler``, the summed time of
    the device activities (kernels, copies, sets) it traced, and every
    name's (ms, count, name), largest first.  Only device-side events
    count, so no kernel is counted twice through the operator that
    launched it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name[:60], (0.0, 0))
            by_name[e.name[:60]] = (ms + e.time_range.elapsed_us() / 1e3,
                                    n + 1)
    rows = sorted(((ms, n, k) for k, (ms, n) in by_name.items()),
                  reverse=True)
    return wall, sum(ms for ms, _, _ in rows), rows


def lm_counts(wrappers):
    return {k: w.launches for k, w in wrappers.items()}


def zero_counts(wrappers):
    for w in wrappers.values():
        w.launches = 0


def serve_lm_path(lm, tokens, wrappers):
    """serve-lm-qwen3-0.6b: ``examples/serve_lm.py`` at full width and
    depth: prefill the padded prompts, then greedy decode."""
    from repro_torch.models.lm import serve
    params, vocab = lm.params(), lm.cfg.vocab
    b, total = tokens.shape
    s = total - LM_NEW
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    zero_counts(wrappers)
    torch.cuda.synchronize()
    t = time.perf_counter()
    cache, logits = serve.prefill(lm, params, tokens)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    n_prefill = wrappers["flash_attention"].launches
    # decode at S-1 reproduces the prefill's last logits (the invariant of
    # tests/test_serve.py); it rewrites position S-1 with the same token,
    # which the greedy decode below rewrites before it reads it
    _, again = serve.decode_step(lm, params, cache, tokens[:, -1:], total - 1)
    rel = rel_l2(again, logits)
    finite &= torch.isfinite(logits).all() & torch.isfinite(again).all()
    tok = logits[:, -1:, :vocab].argmax(-1)
    gen = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(LM_NEW):
        cache, logits = serve.decode_step(lm, params, cache, tok, s + i)
        finite &= torch.isfinite(logits).all()
        tok = logits[:, :, :vocab].argmax(-1)
        gen.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    launches = lm_counts(wrappers)
    log(f"path serve-lm-{LM_ARCH}: {b} prompts of {s} tokens padded to "
        f"{total}, {lm.cfg.n_layers} layers, bf16: prefill {prefill_ms:.3f} "
        f"ms, {LM_NEW} decode steps {decode_s * 1e3 / LM_NEW:.3f} ms a step "
        f"= {b * LM_NEW / decode_s:.1f} tokens/s [{CARD}]; decode at S-1 vs "
        f"prefill rel L2 {rel} (limit {DECODE_RTOL}); launches={launches}; "
        f"sample {torch.cat(gen, 1)[:2].tolist()}")
    if n_prefill != lm.cfg.n_layers:
        problem(f"path serve-lm: {n_prefill} flash launches in the prefill, "
                f"expected {lm.cfg.n_layers}")
    if launches["flash_attention"] != n_prefill:
        problem("path serve-lm: the decode steps launched the flash kernel")
    check_launches("serve-lm", launches, ["flash_attention"],
                   [k for k in wrappers if k != "flash_attention"])
    if not bool(finite):
        problem("path serve-lm: non-finite logits")
    if not rel <= DECODE_RTOL:
        problem(f"path serve-lm: decode at S-1 differs from the prefill by "
                f"{rel} relative L2")
    # where a prefill's and a decode step's device time goes
    for what, run in (
            ("prefill", lambda: serve.prefill(lm, params, tokens)),
            ("decode step", lambda: serve.decode_step(
                lm, params, cache, tok, total - 1))):
        wall, busy, rows = device_breakdown(run)
        k13 = sum(ms for ms, _, n in rows if "flash_attention_fwd" in n)
        log(f"breakdown serve-lm {what}: wall {wall:.3f} ms under the "
            f"profiler, device busy {busy:.3f} ms ({busy / wall:.3f}) "
            f"[{CARD}]; {sum(c for _, c, _ in rows)} device activities; "
            f"kernel 13 {k13:.3f} ms ({k13 / busy:.3f} of busy); top "
            f"kernels (ms, calls): "
            + "; ".join(f"{n} {ms:.3f} x{c}" for ms, c, n in rows[:8]))
    return launches


def serve_lm_fp32_path(wrappers, n_steps=8):
    """serve-lm-fp32-depth2: full width, 2 layers, fp32 (TF32 off); the
    card's prefill + greedy decode against the port's CPU path from the
    same weights."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.lm import serve
    from repro_torch.models.lm.model import build_lm
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=2,
                              dtype="float32")
    lm = build_lm(cfg, device="cuda")
    lm.init(torch.Generator("cuda").manual_seed(SEED + 1))
    cpu = build_lm(cfg, device="cpu")
    cpu.load_state_dict(lm.state_dict())
    prompt, total = 120, 128
    tokens = lm_tokens(cfg.vocab, 2, prompt, total, SEED + 1)
    out, launches = {}, None
    for model, dev in ((lm, "cuda"), (cpu, "cpu")):
        params = model.params()
        if dev == "cuda":
            zero_counts(wrappers)
        cache, logits = serve.prefill(model, params, tokens.to(dev))
        steps, toks = [logits], []
        tok = logits[:, -1:, :cfg.vocab].argmax(-1)
        for i in range(n_steps):
            cache, logits = serve.decode_step(model, params, cache, tok,
                                              prompt + i)
            tok = logits[:, :, :cfg.vocab].argmax(-1)
            steps.append(logits)
            toks.append(tok)
        out[dev] = ([x.cpu() for x in steps], torch.cat(toks, 1).cpu())
        if dev == "cuda":
            launches = lm_counts(wrappers)
    rels = [rel_l2(a, b) for a, b in zip(out["cuda"][0], out["cpu"][0])]
    same = torch.equal(out["cuda"][1], out["cpu"][1])
    log(f"path serve-lm-fp32-depth2: 2 x {prompt} tokens padded to {total}, "
        f"prefill + {n_steps} decode steps: card vs CPU logits rel L2 max "
        f"{max(rels)} (limit {FP32_LM_RTOL}), greedy tokens equal: {same}; "
        f"launches={launches}")
    if launches["flash_attention"] != cfg.n_layers:
        problem(f"path serve-lm-fp32-depth2: {launches['flash_attention']} "
                f"flash launches, expected {cfg.n_layers}")
    check_launches("serve-lm-fp32-depth2", launches, ["flash_attention"],
                   [k for k in wrappers if k != "flash_attention"])
    if not max(rels) <= FP32_LM_RTOL or not same:
        problem("path serve-lm-fp32-depth2: the card disagrees with the CPU")
    return launches


def serve_lm_engine_path(lm, wrappers):
    """serve-lm-engine: ``ServeEngine`` (4 slots, s_max 128) over 8 ragged
    requests; prefill-by-decode, so no flash launch."""
    from repro_torch.serve.engine import ServeEngine
    g = torch.Generator().manual_seed(SEED + 2)
    lens = torch.randint(8, 49, (8,), generator=g).tolist()
    prompts = [torch.randint(1, lm.cfg.vocab, (n,), generator=g).tolist()
               for n in lens]
    eng = ServeEngine(lm, lm.params(), max_batch=4, s_max=128)
    zero_counts(wrappers)
    rids = [eng.submit(p, LM_NEW) for p in prompts]
    served = {i: set() for i in range(eng.b)}
    n_steps = 0
    t = time.perf_counter()
    while eng.n_active or eng.queue:
        eng.step()
        n_steps += 1
        for i, r in enumerate(eng.slots):
            if r is not None:
                served[i].add(r.rid)
    dt = time.perf_counter() - t
    launches = lm_counts(wrappers)
    n_gen = sum(len(eng.finished[r].generated) for r in rids
                if r in eng.finished)
    log(f"path serve-lm-engine: prompts {lens}, {n_steps} steps in "
        f"{dt * 1e3:.1f} ms ({dt * 1e3 / n_steps:.3f} ms a step, "
        f"{n_gen / dt:.1f} generated tokens/s) [{CARD}]; requests per slot "
        f"{[len(v) for v in served.values()]}; launches={launches}")
    if set(eng.finished) != set(rids) or n_gen != LM_NEW * len(rids):
        problem("path serve-lm-engine: not every request finished")
    if sum(len(v) for v in served.values()) != len(rids) or \
            max(len(v) for v in served.values()) < 2:
        problem("path serve-lm-engine: slots were not reused")
    check_launches("serve-lm-engine", launches, [], list(wrappers))
    return launches



def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device visible")
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "src"))
    try:
        from repro_torch.core.hetero_mp import HeteroMPConfig
        from repro_torch.graphs.collate import collate_graphs
        from repro_torch.graphs.generator import generate_design
        from repro_torch.kernels import _build
        from repro_torch.kernels.drelu_topk import drelu_bisect
        from repro_torch.kernels.drspmm import (drspmm_bwd_arena,
                                                drspmm_bwd_bucket,
                                                drspmm_bwd_learnable,
                                                drspmm_dense_tier_bwd,
                                                drspmm_dense_tier_fwd,
                                                drspmm_dw_learnable,
                                                drspmm_fwd_arena,
                                                drspmm_fwd_bucket,
                                                drspmm_fwd_learnable,
                                                spmm_arena, spmm_bucket)
        from repro_torch.models.hgnn import (DRCircuitGNN, HomoGNN,
                                             homogenize)
        from repro_torch.train.circuit_trainer import CircuitTrainConfig
        from repro_torch.configs import get_config
        from repro_torch.kernels import flash_attention as FA
        from repro_torch.models.lm import serve as lm_serve
        from repro_torch.models.lm.model import build_lm
    except ImportError as e:
        fail(f"the port is not importable next to this script: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    global CARD
    CARD = smi

    t = time.perf_counter()
    out_dir = _build.build_all()
    log(f"phase build: {out_dir} in {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    table1 = generate_design(0, "small", 1.0) + generate_design(1, "medium", 1.0)
    tiny = (generate_design(0, "small", 0.02)
            + generate_design(1, "medium", 0.02)
            + generate_design(2, "large", 0.02))
    log(f"phase data: {len(table1)} Table-1 partitions "
        f"{[(g.n_cell, g.n_net) for g in table1]}, {len(tiny)} scale-0.02 "
        f"partitions, in {time.perf_counter() - t:.1f} s")

    gen = torch.Generator().manual_seed(SEED)
    model = DRCircuitGNN(FEAT, FEAT, HIDDEN, LAYERS, device="cuda",
                         generator=gen)
    cpu_model = DRCircuitGNN(FEAT, FEAT, HIDDEN, LAYERS, device="cpu")
    cpu_model.load_state_dict(model.state_dict())
    topk = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K)
    bisect = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K,
                            drelu_backend="bisect")

    t = time.perf_counter()
    big = collate_graphs(table1[:2], device="cuda")
    small = collate_graphs(tiny[:2], device="cuda")
    log(f"phase plans: full-width tiers "
        f"{[(s.etype, s.tier) for s in big.plan.segments]}, scale-0.02 tiers "
        f"{[(s.etype, s.tier) for s in small.plan.segments]}")
    rows = check_kernels(model, topk, big, small)
    rows.update(check_bwd_kernels(model, topk, big, small))
    dense = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K, use_drelu=False)
    rows.update(check_spmm_kernel(model, dense, big))
    homo = homogenize(table1[0])
    log(f"phase homogenize: partition 0 -> {homo[0].n_dst} nodes, "
        f"{homo[0].nnz} edges")
    homo_gat = HomoGNN(homo[2].shape[1], HIDDEN, 3, "gat", device="cuda",
                       generator=torch.Generator().manual_seed(SEED))
    rows.update(check_learnable_kernels(
        homo_gat, (homo[0], homo[1], homo[2].cuda(), homo[3].cuda(),
                   homo[4])))
    part0 = table1[0].to("cuda")
    bucket = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K,
                            backend="bucket")
    log(f"phase buckets: partition 0 (R, E) near "
        f"{[b.nbr.shape for b in part0.edges['near'].adj.buckets]}, near "
        f"transposed "
        f"{[b.nbr.shape for b in part0.edges['near'].adj_t.buckets]}, "
        f"pinned {[b.nbr.shape for b in part0.edges['pinned'].adj.buckets]},"
        f" pin {[b.nbr.shape for b in part0.edges['pin'].adj.buckets]}")
    rows.update(check_bucket_kernels(model, part0, bucket))
    log(f"phase kernels: {time.perf_counter() - t:.1f} s")

    # where a batch's time goes: host collation (numpy packing + the
    # pinned copies) against the device forward of the same batch
    t = time.perf_counter()
    collate_graphs(table1[:2], device="cuda")
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3
    with torch.inference_mode():
        fwd_ms = {c.drelu_backend: cuda_ms(lambda: model(big.graph, c), 5)
                  for c in (topk, bisect)}
    log(f"phase breakdown: collate 2 Table-1 partitions {host_ms:.3f} ms on "
        f"the host; batch forward on the card {fwd_ms} ms")

    wrappers = {"drspmm_fwd_arena": drspmm_fwd_arena,
                "drspmm_dense_tier_fwd": drspmm_dense_tier_fwd,
                "drelu_bisect": drelu_bisect,
                "drspmm_bwd_arena": drspmm_bwd_arena,
                "drspmm_dense_tier_bwd": drspmm_dense_tier_bwd,
                "spmm_arena": spmm_arena,
                "drspmm_fwd_learnable": drspmm_fwd_learnable,
                "drspmm_bwd_learnable": drspmm_bwd_learnable,
                "drspmm_dw_learnable": drspmm_dw_learnable,
                "drspmm_fwd_bucket": drspmm_fwd_bucket,
                "drspmm_bwd_bucket": drspmm_bwd_bucket,
                "spmm_bucket": spmm_bucket}
    drelu_kernels = list(wrappers)[:5]
    learnable_kernels = list(wrappers)[6:9]
    bucket_kernels = list(wrappers)[9:]
    fwd_kernels = ["drspmm_fwd_arena", "drspmm_dense_tier_fwd",
                   "drelu_bisect"]
    total = dict.fromkeys(wrappers, 0)
    for name, cfg, graphs, expect in (
            ("table1-topk", topk, table1, ["drspmm_fwd_arena"]),
            ("table1-bisect", bisect, table1,
             ["drspmm_fwd_arena", "drelu_bisect"]),
            ("scale0.02-bisect", bisect, tiny, fwd_kernels)):
        t = time.perf_counter()
        launches, _ = serve_path(name, model, cfg, graphs, cpu_model,
                                 wrappers, expect)
        for k, v in launches.items():
            total[k] += v
        log(f"phase {name}: {time.perf_counter() - t:.1f} s")

    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    train = dict(hidden=HIDDEN, n_layers=LAYERS, k_cell=K, k_net=K,
                 epochs=2, batch_size=2)
    # a D-ReLU-off step: 3 relations x 2 layers forward, and backward all
    # but the last layer's pin, whose output never reaches the loss
    for name, cfg, graphs, expect, forbid, per_step in (
            ("train-table1-topk", CircuitTrainConfig(**train), table1,
             ["drspmm_fwd_arena", "drspmm_bwd_arena"], (), None),
            ("train-scale0.02-bisect",
             CircuitTrainConfig(**train, drelu_backend="bisect",
                                remat=True), tiny, drelu_kernels, (), None),
            ("train-table1-dense",
             CircuitTrainConfig(**train, use_drelu=False), table1,
             ["spmm_arena"], drelu_kernels, 3 * LAYERS + 3 * LAYERS - 1)):
        t = time.perf_counter()
        launches = train_path(name, cfg, graphs, state, wrappers, expect,
                              forbid, per_step)
        for k, v in launches.items():
            total[k] += v
        log(f"phase {name}: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    mt = modules_time(table1[0])
    log(f"phase modules: the three relation SpMMs of partition 0 (dim "
        f"{HIDDEN}): run_fused {mt['fused']} ms, run_sequential "
        f"{mt['sequential']} ms a layer, in {time.perf_counter() - t:.1f} s")

    for kind in ("gcn", "sage", "gat", "gat_edge"):
        t = time.perf_counter()
        gat = kind.startswith("gat")
        launches = homo_path(
            f"train-homo-{kind}", kind, homo, wrappers,
            learnable_kernels if gat else ["spmm_arena"],
            ["spmm_arena"] + drelu_kernels if gat
            else learnable_kernels + drelu_kernels)
        for k, v in launches.items():
            total[k] += v
        log(f"phase train-homo-{kind}: {time.perf_counter() - t:.1f} s")

    # the serial per-relation path: single graphs, every step in lockstep
    # with the CPU
    serial = dict(hidden=HIDDEN, n_layers=LAYERS, k_cell=K, k_net=K,
                  epochs=2, batch_size=1)
    fused_only = ["drspmm_fwd_arena", "drspmm_dense_tier_fwd",
                  "drspmm_bwd_arena", "drspmm_dense_tier_bwd", "spmm_arena"]
    from repro_torch.core.drelu import drelu
    h_net = torch.randn((part0.n_net, HIDDEN), device="cuda")
    if drelu(h_net, HIDDEN) is not h_net:
        problem("D-ReLU with k = width is not the identity")
    for name, cfg, graphs, expect, forbid, count_of in (
            ("train-table1-bucket",
             CircuitTrainConfig(**serial, backend="bucket"), table1,
             ["drspmm_fwd_bucket", "drspmm_bwd_bucket"],
             fused_only + ["spmm_bucket"] + learnable_kernels,
             lambda g: bucket_counts(g, K)),
            ("train-table1-bucket-knet64",
             CircuitTrainConfig(**dict(serial, k_net=HIDDEN),
                                backend="bucket"), table1,
             bucket_kernels, fused_only + learnable_kernels,
             lambda g: bucket_counts(g, HIDDEN)),
            ("train-table1-serial",
             CircuitTrainConfig(**serial, use_plan=False), table1,
             ["drspmm_fwd_arena", "drspmm_bwd_arena"],
             bucket_kernels + ["spmm_arena"] + learnable_kernels,
             serial_counts),
            ("train-scale0.02-serial",
             CircuitTrainConfig(**serial, use_plan=False), tiny,
             ["drspmm_fwd_arena", "drspmm_bwd_arena",
              "drspmm_dense_tier_fwd", "drspmm_dense_tier_bwd"],
             bucket_kernels + ["spmm_arena"] + learnable_kernels,
             serial_counts)):
        t = time.perf_counter()
        launches = lockstep_path(name, cfg, graphs, state, wrappers, expect,
                                 forbid, count_of)
        for k, v in launches.items():
            total[k] += v
        log(f"phase {name}: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    n_homo = len(homo[0].buckets) + len(homo[1].buckets)
    launches = homo_path("train-homo-gcn-bucket", "gcn", homo, wrappers,
                         ["spmm_bucket"],
                         ["spmm_arena"] + learnable_kernels + drelu_kernels
                         + bucket_kernels[:2],
                         backend="bucket", per_step=3 * n_homo)
    for k, v in launches.items():
        total[k] += v
    log(f"phase train-homo-gcn-bucket: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    launches = learnable_slabs_path(model, part0, wrappers)
    for k, v in launches.items():
        total[k] += v
    log(f"phase learnable-slabs-bucket: {time.perf_counter() - t:.1f} s")

    # the dense LM at qwen3-0.6b's full width and depth (bf16)
    t = time.perf_counter()
    wrappers["flash_attention"] = FA.flash_attention
    total["flash_attention"] = 0
    lm = build_lm(get_config(LM_ARCH), device="cuda")
    lm.init(torch.Generator("cuda").manual_seed(SEED))
    tokens = lm_tokens(lm.cfg.vocab, LM_BATCH, LM_PROMPT, LM_PROMPT + LM_NEW,
                       SEED).cuda()
    # a first prefill (the warm-up) hands kernel 13 its operands
    calls = record_calls(FA, "flash_attention",
                         lambda: lm_serve.prefill(lm, lm.params(), tokens))
    if len(calls) != lm.cfg.n_layers:
        problem(f"a prefill made {len(calls)} flash calls, expected "
                f"{lm.cfg.n_layers}")
    q, k, v = calls[0][:3]
    del calls
    if k.shape[2] != lm.cfg.n_kv:
        problem(f"the prefill handed kernel 13 k/v at {k.shape[2]} heads, "
                f"expected the {lm.cfg.n_kv} KV heads")
    rows["flash_attention"] = check_flash_kernel(q, k, v)
    del q, k, v
    log(f"phase kernel-flash: {LM_ARCH} ({sum(p.numel() for p in lm.parameters())}"
        f" parameters, fp32 on the card) in {time.perf_counter() - t:.1f} s")
    for name, run in (
            (f"serve-lm-{LM_ARCH}", lambda: serve_lm_path(lm, tokens, wrappers)),
            ("serve-lm-fp32-depth2", lambda: serve_lm_fp32_path(wrappers)),
            ("serve-lm-engine", lambda: serve_lm_engine_path(lm, wrappers))):
        t = time.perf_counter()
        launches = run()
        for k, v in launches.items():
            total[k] += v
        log(f"phase {name}: {time.perf_counter() - t:.1f} s")

    for k, r in rows.items():
        r["launches"] = total[k]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in rows.values()]}))
    if PROBLEMS:
        fail(f"{len(PROBLEMS)} check(s) failed: {PROBLEMS}")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
