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

and, over fused and quantized collation (``collate_graphs``' defaults):

* ``padded-arena``: kernels 1 and 4 over the first served batch's
  quantized arenas and over its exact-size arenas: the real rows bit for
  bit, and each one's profiler time;
* ``serve-table1-captured``: the Table-1 partitions and jittered (+-10 %)
  copies served twice (the second time reversed) with ``max_batch=2`` and
  filler, every batch a replay of its signature's captured CUDA graph held
  against the model's eager forward of the same batch, and served twice
  more with ``max_live_buckets=1`` (evictions, re-captures):
  ``compiles``, ``live_buckets``, ``evictions``, graphs/s, p50/p95;
* ``train-table1-bucket-batched`` / ``train-table1-serial-batched``:
  batches of two under ``backend="bucket"`` / ``use_plan=False``, in
  lockstep with a CPU trainer: kernels 1 and 4, none of 10-12;
* ``learnable-collated``: ``drspmm_learnable`` over two partitions'
  collated edge-id arenas (k 16 and 64): kernels 7-9 against their plain
  versions and against each member's own product;
* ``train-auto-k``: ``auto_k=True`` for one epoch; the K equals the CPU's
  ``profile_k``;

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
    requests, slots reused, no flash launch;

and trains it through kernel 13 and its backward, kernel 13b:

18. ``flash-bwd``: kernel 13b against its plain version (the same o, lse
    and a seeded dO), on the plain forward's o and lse and on kernel 13's
    own (its lse against the plain version's, its output bit-equal to the
    launch without lse): fp32 and bf16 at head dims 32, 64 and 128 (GQA,
    ragged tails, causal and full, q offsets) and bf16 at the prefill's
    q/k/v; 13b's ``ptxas`` registers and spills; timed beside SDPA's
    backward on tiled k/v, by events queued behind a sleep;
19. ``train-lm-fp32-depth2``: full width, 2 layers, fp32, B 2 x S 128:
    the card's loss, gradients and one ``make_train_step`` step against
    the port's CPU from the same weights (1e-5 / 1e-4);
20. ``train-lm-qwen3-0.6b``: ``launch.train.main`` at depth 28, bf16,
    remat ``full``, B 4 x S 1,024, 6 steps with a checkpoint every 3
    (under ``build/``), then a restart that restores step 3 bit for bit
    and runs steps 4-5: finite losses, the first within 0.5 of ln V, 56
    launches of kernel 13 and 28 of 13b a step, no plain version; step
    p50, tokens/s (every token over the runs' whole wall time, checkpoint
    saves included), forward+backward / AdamW ms and peak memory, and
    remat ``full`` against off at depth 2;

and serves and trains the MoE and SSM LM families at full width (random
weights from a seed, bf16):

21. ``serve-lm-granite-moe-1b-a400m``: 24 layers, 32 experts top-8,
    ``examples/serve_lm.py``'s layout: prefill (24 launches of kernel 13),
    16 greedy decode steps (none); the assignments each layer's capacity
    drops; a profiler breakdown of a prefill by MoE stage (router and
    top-k, slots, dispatch, experts, combine) and kernel 13's share;
22. ``serve-lm-moonshot-v1-16b-a3b-depth8``: the same at 8 of 48 layers
    (64 experts top-6, hd 128, MHA 16/16, vocab 163,840);
23. ``serve-lm-mamba2-1.3b``: 48 layers, 4 x 1,024 tokens, 16 greedy
    steps, no kernel 13; a 768-token prefill then decode steps over
    tokens 768-1,023 whose last logits match the 1,024-token prefill's
    (teacher forcing: within twice the bf16 prefill's distance from the
    fp32 prefill of the same weights);
24. ``lm-families-fp32-depth2``: each of the three at 2 layers, fp32:
    prefill + 8 decode steps, loss, gradients and one ``make_train_step``
    step (the updated parameters against the CPU's AdamW on the card's
    gradients and against the CPU's whole step) against the port's CPU
    from the same weights (1e-4 / 1e-5 / 1e-4), the MoE top-k expert sets
    equal on both; mamba2's teacher forcing over 64 decode steps in fp32;
25. ``train-lm-granite-moe-1b-a400m`` and 26. ``train-lm-mamba2-1.3b``:
    ``launch.train.main`` at full depth, bf16, remat ``full``, B 4 x S
    1,024, 4 steps: finite losses, the first near ln V; granite 48
    launches of kernel 13 and 24 of 13b a step, mamba2 none; step p50,
    tokens/s, peak memory, a forward+backward breakdown by stage.

and serves and trains the hybrid, audio and VLM families (random weights
from a seed, bf16; the served and fp32 models with the VLM's cross gates
and whisper's GELU biases drawn nonzero); ``kernel-flash`` and ``flash-bwd`` also hold kernels 13 / 13b
at the non-causal shapes these give them (``CROSS_SHAPES``: whisper's
encoder 1,500 x 1,500 and decoder 448 x 1,500 at hd 64, the VLM's 1,024 x
1,600 at hd 128 and 64/8 heads; bf16 and fp32), and ``flash-cross`` times
them beside SDPA and its backward:

27. ``serve-lm-zamba2-1.2b``: 38 layers, the shared block 7 times (6
    groups of 6 SSM layers and a tail of 2): 4 x 1,008 tokens padded to
    1,024, 7 launches of kernel 13 in the prefill, 16 greedy steps (none),
    teacher forcing (a 192-token prefill in a 256-slot cache, decode
    steps over tokens 192-255, against the 256-token prefill);
28. ``serve-lm-whisper-large-v3``: 32 + 32 layers over seeded frames of 4
    x 1,500 x 1,280, 432 prompt tokens padded to the 448-token context:
    96 launches in the prefill (32 encoder, 32 self, 32 cross);
29. ``serve-lm-llama-3.2-vision-90b-depth5``: full width at 5 of 100
    layers (4 self + 1 cross) over 1,600 seeded image tokens, 4 x 1,008
    tokens padded to 1,024: 5 launches in the prefill;
30. ``lm-hybrid-cross-fp32``: zamba2 at depth 8 (the shared block twice),
    whisper at 2 + 2 layers and the VLM at depth 5 cut in width
    (``VLM_CPU_CUT``), fp32: the checks of ``lm-families-fp32-depth2``,
    by the same function (``lm_fp32_path``), with seeded frames / image
    tokens;
31. ``train-lm-zamba2-1.2b``: ``launch.train.main``, 38 layers, B 4 x S
    1,024, 4 steps, 7 / 7 launches of kernels 13 / 13b a step;
32. ``train-lm-whisper-large-v3``: ``launch.train.main`` at B 4 x S 448,
    its zero frames replaced by seeded ones, 4 steps, 192 / 96 launches a
    step.

Every parameter count is taken from the model's leaves.  Every kernel's
launch count is zeroed just before each path and read just after; a kernel that the path should run and did not, or one it must not
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


def walked_slots(f) -> int:
    """Slots the walks of arena ``f`` visit: a quantized arena's padding
    chunks are walked by no block, so a bound does not count them."""
    c, br, ec = f.nbr.shape
    return int((f.walk_end.long() - f.blk_ptr[:-1].long()).sum()) * br * ec


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
    n_bytes = 4 * (f.blk_ptr.numel() + 2 * walked_slots(f) + 2 * xv.numel()
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
        n_bytes = 4 * (arena.blk_ptr.numel() + 2 * walked_slots(arena)
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
    n_bytes = 4 * (f.blk_ptr.numel() + 2 * walked_slots(f) + src.numel()
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


def record_engine(eng, keep_outputs=False):
    """Wrap ``eng``'s dispatch and capture to record, for every dispatched
    batch, how it ran (``first``: the eager run before its (signature,
    slot)'s capture, ``replay``, or ``eager``: its bucket was evicted while
    it was prepared), its batch, its requests, (``keep_outputs``) the
    dispatch's record (its forward view on the card and, once its event
    completes, the output's host copy), and for every capture its
    signature and the kernel launches recorded in it.  Returns ``(seen,
    captures)``."""
    from repro_torch.graphs.collate import graph_signature
    seen, captures = [], []
    dispatch, capture = eng._dispatch, eng._capture

    def rec_dispatch(prepared):
        entry = dispatch(prepared)
        seen.append((entry.batch, tuple(r.rid for r in entry.reqs),
                     entry if keep_outputs else None, entry.kind))
        return entry

    def rec_capture(view, slot):
        cap, out = capture(view, slot)
        captures.append((graph_signature(view),
                         {f.__name__: n for f, n in cap.launches.items()}))
        return cap, out
    eng._dispatch, eng._capture = rec_dispatch, rec_capture
    return seen, captures


def replay_summary(seen, captures) -> str:
    """Batches by how they ran, and the launches a replay of each captured
    signature runs (the ``launches`` counts hold the eager runs' launches
    and every replay's)."""
    kinds = {k: sum(1 for s in seen if s[3] == k)
             for k in ("first", "replay", "eager")}
    return (f"batches {kinds} (first: the eager run before its capture); "
            f"launches a replay runs, by captured signature: "
            f"{[c[1] for c in captures]}")


def serve_path(name, model, cfg, graphs, cpu_model, wrappers, expect):
    """Serve ``graphs`` (max_batch 2: each signature's first batch runs
    eagerly before its capture, later ones replay it), hold every
    prediction against the CPU forward, and return the kernels' launch
    counts of this path (launches that ran: the eager runs' and the
    replays')."""
    from repro_torch.serve.circuit_engine import CircuitServeEngine
    eng = CircuitServeEngine(model, cfg, max_batch=2, device="cuda")
    seen, captures = record_engine(eng)
    for w in wrappers.values():
        w.launches = 0
    rids = [eng.submit(g) for g in graphs]
    done = eng.run()
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    st = eng.stats()
    log(f"path {name}: {json.dumps(st)} launches={launches}; "
        f"{replay_summary(seen, captures)}")
    for k in expect:
        if launches[k] == 0:
            problem(f"path {name}: kernel {k} was never launched")
    hold_against_cpu(name, done, rids, graphs, cpu_model, cfg)
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
                  count_of, twin=None):
    """Train single graphs (or collated batches of ``cfg.batch_size``) on
    the card for ``cfg.epochs`` epochs, each step in lockstep with a CPU
    trainer that takes it from the card's weights and optimizer state, on
    the same graphs.  A step's losses must agree within LOCKSTEP_RTOL;
    where they do not, both forwards' D-ReLU masks are compared, and a
    step whose masks differ (a near-tied pick that GPU-vs-CPU rounding
    flips) is held to LOSS_RTOL instead and reported.  ``count_of(g)``
    gives each kernel's launches for a step on the card's step graph
    ``g``; the run's counts must equal their sum.  ``twin``, a
    ``(config, rtol)`` pair, adds a second card trainer of that config
    that takes each step from the same state, its loss held to ``rtol``
    relative.  Returns the card's launch counts."""
    from repro_torch.models.hgnn import (DRCircuitGNN, batched_loss_fn,
                                         loss_fn)
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.train.circuit_trainer import CircuitTrainer
    trainers = []
    for dev in ("cuda", "cpu"):
        m = DRCircuitGNN(FEAT, FEAT, HIDDEN, LAYERS, device=dev)
        m.load_state_dict(state)
        trainers.append(CircuitTrainer(cfg, FEAT, FEAT, model=m, device=dev))
    gpu, cpu = trainers
    bs = cfg.batch_size
    chunks = [graphs[i:i + bs] for i in range(0, len(graphs), bs)]
    if twin is not None:
        m = DRCircuitGNN(FEAT, FEAT, HIDDEN, LAYERS, device="cuda")
        m.load_state_dict(state)
        other = CircuitTrainer(twin[0], FEAT, FEAT, model=m, device="cuda")
        twin_diffs = []

    def step_graph(tr, chunk):
        return tr._planned(chunk[0]) if bs == 1 else tr._collate(chunk)[0]

    def first_loss(tr):
        if bs == 1:
            return loss_fn(tr.model, tr._planned(graphs[0]), tr.mp_cfg,
                           tr.spec)
        graph, cell_w, _ = tr._collate(chunks[0])
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

    expected = {}
    for w in wrappers.values():
        w.launches = 0
    launches = dict.fromkeys(wrappers, 0)
    diffs, flips = [], []
    t = time.perf_counter()
    for ep in range(cfg.epochs):
        for chunk in chunks:
            for k, v in count_of(step_graph(gpu, chunk)).items():
                expected[k] = expected.get(k, 0) + v
            # the CPU trainer (and the twin) take this step from the
            # card's state
            for tr in (cpu,) if twin is None else (cpu, other):
                with torch.no_grad():
                    for p, q in zip(tr.params, gpu.params):
                        p.copy_(q)
                    for a, b in zip(tr.opt_state.m + tr.opt_state.v,
                                    gpu.opt_state.m + gpu.opt_state.v):
                        a.copy_(b)
                tr.opt_state.step = gpu.opt_state.step
            pre_state = {k: v.detach().clone()
                         for k, v in cpu.model.state_dict().items()}
            before = {k: w.launches for k, w in wrappers.items()}
            lg = gpu.train_epoch(chunk)
            for k, w in wrappers.items():      # the step's own launches
                launches[k] += w.launches - before[k]
            lc = cpu.train_epoch(chunk)
            if twin is not None:
                lt = other.train_epoch(chunk)
                twin_diffs.append(abs(lg - lt) / abs(lt))
                if not twin_diffs[-1] <= twin[1]:
                    problem(f"path {name}: step {len(diffs)} loss {lg}, "
                            f"{lt} on the card's twin trainer")
            d = abs(lg - lc) / abs(lc)
            diffs.append(d)
            if not d <= LOCKSTEP_RTOL:
                # the step's forward from the pre-step state, both sides
                pre = DRCircuitGNN(FEAT, FEAT, HIDDEN, LAYERS, device="cpu")
                pre.load_state_dict(pre_state)
                card = DRCircuitGNN(FEAT, FEAT, HIDDEN, LAYERS,
                                    device="cuda")
                card.load_state_dict(pre_state)
                ma = drelu_masks(card, step_graph(gpu, chunk), gpu.mp_cfg)
                mb = drelu_masks(pre, step_graph(cpu, chunk), cpu.mp_cfg)
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
    if twin is not None:
        log(f"path {name}: relative loss difference to the card's twin "
            f"trainer (n_shards={twin[0].n_shards}) per step {twin_diffs}, "
            f"limit {twin[1]}")
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
LM_SEQ = 1024                # the training paths' sequence (B LM_BATCH)
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
    for label, (bq, sq, sk, hq, n_kv_, d) in CROSS_SHAPES.items():
        for dt in (torch.bfloat16, torch.float32):
            cases.append((f"{label} {str(dt)[6:]} full", rnd(bq, sq, hq, d,
                                                             dtype=dt),
                          *(rnd(bq, sk, n_kv_, d, dtype=dt)
                            for _ in range(2)), False))
    return cases


# the non-causal shapes of the hybrid / audio / VLM paths (B, Sq, Sk, H, KV,
# hd): whisper's encoder over its 1,500 frames, its decoder's 448 tokens
# against them, the VLM's 1,024 tokens against 1,600 image tokens
CROSS_SHAPES = {"whisper encoder": (4, 1500, 1500, 20, 20, 64),
                "whisper cross": (4, 448, 1500, 20, 20, 64),
                "VLM cross": (4, 1024, 1600, 64, 8, 128)}


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
    at their KV heads) and the cases above, without an lse buffer (every
    serving launch) and with one (training's: the lse against the plain
    version's, the output bit for bit the same); timed at the prefill's
    shape beside SDPA."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.lm.attention import tile_kv
    err_main = None
    for label, a, b_, c, causal in flash_cases(q, k, v):
        y = FA.flash_attention(a, b_, c, causal=causal)
        ref, lse_ref = FA.flash_attention_plain(a, b_, c, causal=causal,
                                                return_lse=True)
        # the launch training makes: with an lse buffer
        y_lse, lse = FA._forward(a, b_, c, causal, 0, with_lse=True)
        torch.cuda.synchronize()
        bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
        lse_err, lse_worst = worst_ratio(lse, lse_ref, False)
        log(f"kernel flash_attention {label} with lse: lse max_abs_err "
            f"{lse_err} (worst err/limit {lse_worst}), output bit-equal "
            f"to the launch without: "
            f"{torch.equal(y_lse.view(bits), y.view(bits))}")
        if not lse_worst <= 1.0 or not torch.equal(y_lse.view(bits),
                                                   y.view(bits)):
            problem(f"flash kernel ({label}) with an lse buffer: lse "
                    f"max_abs_err {lse_err}, or its output differs from "
                    f"the launch without")
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


def device_breakdown(run, spans=None):
    """Wall ms of ``run()`` under ``torch.profiler``, the summed time of
    the device activities (kernels, copies, sets) it traced, and every
    name's (ms, count, name), largest first.  Only device-side events
    count, so no kernel is counted twice through the operator that
    launched it.  ``spans``, a dict keyed by ``record_function`` labels,
    gets each label's device ms (the kernels launched inside it)."""
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
    labels = spans or {}
    for e in prof.events():
        # a record_function span's device-side range is not an activity
        if e.device_type == DeviceType.CUDA and not (
                e.name in labels or getattr(e, "is_user_annotation", False)):
            ms, n = by_name.get(e.name[:60], (0.0, 0))
            by_name[e.name[:60]] = (ms + e.time_range.elapsed_us() / 1e3,
                                    n + 1)
    rows = sorted(((ms, n, k) for k, (ms, n) in by_name.items()),
                  reverse=True)
    for e in prof.events() if spans is not None else ():
        # the host-side span: the device time of the kernels it launched
        if e.name in spans and e.device_type == DeviceType.CPU:
            spans[e.name] += e.device_time_total / 1e3
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



def bwd_cases(q, k, v):
    """(label, q, k, v, causal, q_offset) of kernel 13b's check: fp32 and
    bf16 at head dims 32, 64 and 128 (GQA, ragged tails, causal and full,
    a q offset), then bf16 at the prefill's own q/k/v (k/v at the 8 KV
    heads), the main path's shape."""
    g = torch.Generator("cuda").manual_seed(SEED + 3)

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=g, device="cuda").to(dtype)
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for hd, (b, sq, sk, h, n_kv, causal, off) in (
                (32, (1, 37, 101, 4, 1, True, 64)),
                (32, (2, 1000, 1000, 16, 8, True, 0)),
                (64, (2, 1000, 1000, 16, 8, True, 0)),
                (64, (2, 128, 256, 4, 2, False, 0)),
                (64, (1, 200, 300, 6, 3, True, 100)),
                (128, (2, 300, 300, 8, 2, True, 0)),
                (128, (1, 130, 70, 4, 4, False, 0))):
            cases.append((f"{str(dt)[6:]} hd{hd} B{b} Sq{sq} Sk{sk} H{h} "
                          f"KV{n_kv} {'causal' if causal else 'full'} "
                          f"q_offset {off}",
                          rnd(b, sq, h, hd, dtype=dt),
                          rnd(b, sk, n_kv, hd, dtype=dt),
                          rnd(b, sk, n_kv, hd, dtype=dt), causal, off))
    for label, (bq, sq, sk, h, n_kv, hd) in CROSS_SHAPES.items():
        for dt in (torch.bfloat16, torch.float32):
            cases.append((f"{label} {str(dt)[6:]} B{bq} Sq{sq} Sk{sk} H{h} "
                          f"KV{n_kv} hd{hd} full",
                          rnd(bq, sq, h, hd, dtype=dt),
                          rnd(bq, sk, n_kv, hd, dtype=dt),
                          rnd(bq, sk, n_kv, hd, dtype=dt), False, 0))
    cases.append(("prefill bf16 causal", q, k, v, True, 0))
    return cases


def ptxas_report(source: str) -> list:
    """[kernel, registers, spill store bytes, spill load bytes] of each
    kernel in ``source``'s ``nvcc -Xptxas -v`` build log."""
    import re
    from repro_torch.kernels import _build
    out, name, spill = [], None, (0, 0)
    for line in (_build.build_dir() / f"{source}.log").read_text() \
            .splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = tuple(int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append([name, int(m.group(1)), *spill])
            name = None
    return out


def fp32_limit(ref):
    """Per element: 1e-5 of the reference value plus 1e-5 scaled by the
    largest magnitude (fp32 results that differ in summation order)."""
    ref = ref.float()
    return 1e-5 * (ref.abs() + max(1.0, float(ref.abs().max())))


def worst_ratio(got, ref, bf16: bool):
    """(max |got - ref|, the largest ratio of error to limit; inf where
    ``got`` is not finite)."""
    diff = (got.float() - ref.float()).abs()
    lim = bf16_limit(ref) if bf16 else fp32_limit(ref)
    worst = float((diff / lim).max())
    return float(diff.max()), (worst if torch.isfinite(got).all()
                               else float("inf"))


def check_flash_bwd_kernel(q, k, v, wrappers):
    """Kernel 13b against its plain version on each case, twice: on the
    plain forward's o and lse (only the backward compared), and on kernel
    13's own o and lse, the pair training feeds it.  There kernel 13's lse
    is held against the plain version's at the fp32 limit and its output
    bit for bit against the launch without an lse buffer (serving's).
    Timed at the prefill's shape beside SDPA's backward on tiled k/v
    (never called by the port), both by events queued behind a sleep so
    that neither reads the host's dispatch."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.lm.attention import tile_kv
    g = torch.Generator("cuda").manual_seed(SEED + 4)
    err_main = None
    for label, a, b_, c, causal, off in bwd_cases(q, k, v):
        bf16 = a.dtype == torch.bfloat16
        o, lse = FA.flash_attention_plain(a, b_, c, causal=causal,
                                          q_offset=off, return_lse=True)
        do = torch.randn(a.shape, generator=g, device="cuda").to(a.dtype)
        ko, klse = FA._forward(a, b_, c, causal, off, with_lse=True)
        ko_serve = FA._forward(a, b_, c, causal, off, with_lse=False)[0]
        bits = torch.int16 if bf16 else torch.int32
        same_out = torch.equal(ko.view(bits), ko_serve.view(bits))
        lse_err, lse_worst = worst_ratio(klse, lse, False)
        errs, worst = {}, 0.0
        for which, (oo, ll) in (("plain o/lse", (o, lse)),
                                ("kernel o/lse", (ko, klse))):
            got = FA.flash_attention_bwd(a, b_, c, oo, ll, do,
                                         causal=causal, q_offset=off)
            ref = FA.flash_attention_bwd_plain(a, b_, c, oo, ll, do,
                                               causal=causal, q_offset=off)
            pairs = [worst_ratio(x, r, bf16) for x, r in zip(got, ref)]
            errs[which] = [e for e, _ in pairs]
            worst = max([worst] + [w for _, w in pairs])
        torch.cuda.synchronize()
        log(f"kernel flash_attention_bwd {label}: max_abs_err dq/dk/dv "
            f"{errs} (worst err/limit {worst}); kernel 13's lse "
            f"max_abs_err {lse_err} (worst err/limit {lse_worst}), output "
            f"bit-equal to the launch without lse: {same_out}")
        if not worst <= 1.0:
            problem(f"flash backward kernel ({label}) disagrees with its "
                    f"plain version: {errs}")
        if not lse_worst <= 1.0:
            problem(f"flash kernel's lse ({label}) disagrees with the plain "
                    f"version's: {lse_err}")
        if not same_out:
            problem(f"flash kernel ({label}): the output with an lse buffer "
                    f"differs from the one without")
        if a is q:
            err_main = max(max(e) for e in errs.values())
    for name, regs, st, ld in ptxas_report("flash_attention_bwd"):
        log(f"kernel flash_attention_bwd ptxas: {name}: {regs} registers, "
            f"spill stores {st} B, spill loads {ld} B")
    b, s, h, hd = q.shape
    n_kv = k.shape[2]
    o, lse = FA._forward(q, k, v, True, 0, with_lse=True)
    do = torch.randn(q.shape, generator=g, device="cuda").to(q.dtype)
    # q, o, dO, lse read and dq written; k, v read and dk, dv written at
    # the KV heads; 5 products over the causal half
    n_bytes = ((4 * h + 4 * n_kv) * b * s * hd * q.element_size()
               + b * h * s * 4)
    b_ms, b_by = bound(n_bytes, 10.0 * hd * b * h * (s * (s + 1) // 2),
                       H100_BF16_PER_S)
    run = lambda: FA.flash_attention_bwd(q, k, v, o, lse, do)
    # SDPA's backward on the same operands, k/v tiled outside the call
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, tile_kv(k, h), tile_kv(v, h)))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    dot = do.transpose(1, 2)
    sdpa_bwd = lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                           retain_graph=True)
    row = dict(
        name="flash_attention_bwd", route="cuda",
        source="src/repro_torch/csrc/flash_attention_bwd.cu",
        replaces="src/repro/models/lm/attention.py:102",
        max_abs_err=err_main, ms=queued_ms(run),
        plain_ms=queued_ms(lambda: FA.flash_attention_bwd_plain(
            q, k, v, o, lse, do)),
        bound_ms=b_ms, bound_by=b_by, library_ms=queued_ms(sdpa_bwd))
    _, _, names = device_breakdown(lambda: [run() for _ in range(REPS)])
    parts = {n: ms / REPS for ms, _, n in names if "flash_bwd" in n}
    lib_names = device_breakdown(lambda: [sdpa_bwd() for _ in range(REPS)])[2]
    log(f"  flash_attention_bwd (B {b}, S {s}, H {h}, KV {n_kv}, hd {hd}, "
        f"bf16, causal): ms={row['ms']} plain_ms={row['plain_ms']} "
        f"bound_ms={b_ms} ({b_by}, {n_bytes} bytes) library_ms(SDPA "
        f"backward, tiled k/v)={row['library_ms']} (events queued behind "
        f"a sleep); events back to back: kernel {cuda_ms(run)}, SDPA "
        f"backward {cuda_ms(sdpa_bwd)}; kernel device ms a call "
        f"(profiler) {sum(parts.values())}: {parts}; SDPA backward device "
        f"ms a call {sum(ms for ms, _, _ in lib_names) / REPS}; "
        f"{10.0 * hd * b * h * (s * (s + 1) // 2) / row['ms'] / 1e9:.1f} "
        f"TFLOP/s on the 5 causal products [{CARD}]")
    return row


def flash_cross_times():
    """Kernels 13 and 13b at the non-causal ``CROSS_SHAPES`` in bf16 (the
    shapes the hybrid, audio and VLM paths give them; checked against the
    plain versions in ``kernel-flash`` and ``flash-bwd``): each timed by
    events queued behind a sleep beside the plain version and
    ``scaled_dot_product_attention`` (non-causal; k/v tiled to the q heads
    outside the timed call) and its backward, with the bound of each: the
    bytes read and written once, the products over the whole Sq x Sk
    (2 for 13, 5 for 13b) at the bf16 tensor-core peak."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.lm.attention import tile_kv
    g = torch.Generator("cuda").manual_seed(SEED + 5)
    out = {}
    for label, (b, sq, sk, h, n_kv, hd) in CROSS_SHAPES.items():
        q, k, v, do = (torch.randn(shape, generator=g, device="cuda")
                       .to(torch.bfloat16)
                       for shape in ((b, sq, h, hd), (b, sk, n_kv, hd),
                                     (b, sk, n_kv, hd), (b, sq, h, hd)))
        o, lse = FA._forward(q, k, v, False, 0, with_lse=True)
        flops = 4.0 * hd * b * h * sq * sk
        fwd_bound = bound((2 * h * sq + 2 * n_kv * sk) * b * hd * 2, flops,
                          H100_BF16_PER_S)
        bwd_bound = bound((4 * h * sq + 4 * n_kv * sk) * b * hd * 2
                          + b * h * sq * 4, 2.5 * flops, H100_BF16_PER_S)
        qt = q.transpose(1, 2).detach().requires_grad_()
        kt, vt = (tile_kv(t, h).transpose(1, 2).detach().requires_grad_()
                  for t in (k, v))
        q_, k_, v_ = (t.detach() for t in (qt, kt, vt))
        sdpa = lambda: F.scaled_dot_product_attention(q_, k_, v_)
        ref = F.scaled_dot_product_attention(qt, kt, vt)
        sdpa_bwd = lambda: torch.autograd.grad(ref, (qt, kt, vt),
                                               do.transpose(1, 2),
                                               retain_graph=True)
        r = dict(
            fwd_ms=queued_ms(lambda: FA.flash_attention(q, k, v,
                                                        causal=False)),
            fwd_plain_ms=queued_ms(lambda: FA.flash_attention_plain(
                q, k, v, causal=False), reps=3),
            fwd_sdpa_ms=queued_ms(sdpa), fwd_bound_ms=fwd_bound[0],
            fwd_bound_by=fwd_bound[1],
            bwd_ms=queued_ms(lambda: FA.flash_attention_bwd(
                q, k, v, o, lse, do, causal=False)),
            bwd_plain_ms=queued_ms(lambda: FA.flash_attention_bwd_plain(
                q, k, v, o, lse, do, causal=False), reps=3),
            bwd_sdpa_ms=queued_ms(sdpa_bwd), bwd_bound_ms=bwd_bound[0],
            bwd_bound_by=bwd_bound[1])
        log(f"flash cross {label} (B {b}, Sq {sq}, Sk {sk}, H {h}, KV "
            f"{n_kv}, hd {hd}, bf16, full): kernel 13 ms={r['fwd_ms']} "
            f"plain_ms={r['fwd_plain_ms']} SDPA ms={r['fwd_sdpa_ms']} "
            f"bound_ms={r['fwd_bound_ms']} ({r['fwd_bound_by']}), "
            f"{flops / r['fwd_ms'] / 1e9:.1f} TFLOP/s; kernel 13b ms="
            f"{r['bwd_ms']} plain_ms={r['bwd_plain_ms']} SDPA backward ms="
            f"{r['bwd_sdpa_ms']} bound_ms={r['bwd_bound_ms']} "
            f"({r['bwd_bound_by']}), {2.5 * flops / r['bwd_ms'] / 1e9:.1f} "
            f"TFLOP/s (events queued behind a sleep) [{CARD}]")
        out[label] = r
        del q, k, v, do, o, lse, qt, kt, vt, q_, k_, v_, ref
    torch.cuda.empty_cache()
    return out


def count_plain_calls(fa_module):
    """Wrap kernel 13's two plain versions to count their calls; returns
    (counts, restore)."""
    counts = {"flash_attention_plain": 0, "flash_attention_bwd_plain": 0}
    saved = {n: getattr(fa_module, n) for n in counts}

    def wrap(n):
        def f(*a, **kw):
            counts[n] += 1
            return saved[n](*a, **kw)
        return f
    for n in counts:
        setattr(fa_module, n, wrap(n))
    return counts, lambda: [setattr(fa_module, n, f)
                            for n, f in saved.items()]


def lm_batch(vocab, seq, batch, step, device):
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    b = TokenPipeline(DataConfig(vocab=vocab, seq_len=seq,
                                 global_batch=batch)).global_batch(step)
    return {k: torch.from_numpy(v).long().to(device) for k, v in b.items()}


def train_lm_fp32_path(wrappers):
    """train-lm-fp32-depth2: qwen3-0.6b's full width, 2 layers, fp32 (TF32
    off), remat on, B 2 x S 128: the card's loss and gradients, then one
    ``make_train_step`` step, against the port's CPU from the same
    weights (loss 1e-5 relative, gradients and parameters 1e-4 relative L2
    a leaf)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.lm.model import build_lm
    from repro_torch.optim.adamw import adamw_init, tree_leaves
    from repro_torch.train import lm_step
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=2,
                              dtype="float32")
    lm = build_lm(cfg, device="cuda")
    lm.init(torch.Generator("cuda").manual_seed(SEED + 5))
    cpu = build_lm(cfg, device="cpu")
    cpu.load_state_dict(lm.state_dict())
    out, launches, plain = {}, None, None
    for model, dev in ((lm, "cuda"), (cpu, "cpu")):
        batch = lm_batch(cfg.vocab, 128, 2, 0, dev)
        params = model.params()
        if dev == "cuda":
            zero_counts(wrappers)
            calls, restore = count_plain_calls(FA)
        t = time.perf_counter()
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, tree_leaves(params))
        state = lm_step.TrainState(params, adamw_init(params))
        _, metrics = lm_step.make_train_step(model, lr=1e-3,
                                             total_steps=10)(state, batch)
        if dev == "cuda":
            torch.cuda.synchronize()
            launches, plain = lm_counts(wrappers), dict(calls)
            restore()
        out[dev] = (float(loss.detach()), [g.cpu() for g in grads],
                    [p.detach().cpu() for p in tree_leaves(params)],
                    float(metrics["grad_norm"]),
                    time.perf_counter() - t)
    (l_g, g_g, p_g, n_g, t_g), (l_c, g_c, p_c, n_c, t_c) = \
        out["cuda"], out["cpu"]
    loss_rel = abs(l_g - l_c) / abs(l_c)
    grad_rel = max(rel_l2(a, b) for a, b in zip(g_g, g_c))
    par_rel = max(rel_l2(a, b) for a, b in zip(p_g, p_c))
    log(f"path train-lm-fp32-depth2: B 2 x S 128, 2 layers fp32: loss card "
        f"{l_g} CPU {l_c} (rel {loss_rel}, limit 1e-5); gradients rel L2 "
        f"max {grad_rel} (limit 1e-4); grad norm {n_g} / {n_c}; one AdamW "
        f"step: parameters rel L2 max {par_rel} (limit 1e-4); card "
        f"{t_g:.2f} s, CPU {t_c:.2f} s; launches={launches}; plain calls "
        f"on the card {plain}")
    n = cfg.n_layers
    if launches["flash_attention"] != 4 * n or \
            launches["flash_attention_bwd"] != 2 * n:
        problem(f"path train-lm-fp32-depth2: kernel 13 / 13b launched "
                f"{launches['flash_attention']} / "
                f"{launches['flash_attention_bwd']} times, expected "
                f"{4 * n} / {2 * n} (remat: a forward and its recompute)")
    check_launches("train-lm-fp32-depth2", launches,
                   ["flash_attention", "flash_attention_bwd"],
                   [k for k in wrappers if not k.startswith("flash")])
    if any(plain.values()):
        problem(f"path train-lm-fp32-depth2: plain versions ran on the "
                f"card: {plain}")
    if not (loss_rel <= 1e-5 and grad_rel <= 1e-4 and par_rel <= 1e-4):
        problem("path train-lm-fp32-depth2: the card disagrees with the CPU")
    return launches


def remat_compare():
    """Forward+backward and AdamW ms and peak memory of qwen3-0.6b at depth
    2, bf16, B 4 x S 1,024, with remat ``full`` against remat off."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.lm.model import build_lm
    from repro_torch.optim.adamw import adamw_init, adamw_update, tree_leaves
    res = {}
    for remat in (True, False):
        cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=2,
                                  remat=remat)
        lm = build_lm(cfg, device="cuda")
        lm.init(torch.Generator("cuda").manual_seed(SEED))
        params = lm.params()
        opt = adamw_init(params)
        batch = lm_batch(cfg.vocab, LM_SEQ, LM_BATCH, 0, "cuda")
        fb, ad = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(4):
            t = time.perf_counter()
            grads = torch.autograd.grad(lm.loss(params, batch),
                                        tree_leaves(params))
            torch.cuda.synchronize()
            fb.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            adamw_update(params, grads, opt, 1e-4, weight_decay=0.1,
                         grad_clip=1.0)
            torch.cuda.synchronize()
            ad.append((time.perf_counter() - t) * 1e3)
            del grads
        res[remat] = (sorted(fb[1:])[1], sorted(ad[1:])[1],
                      torch.cuda.max_memory_allocated() / 2 ** 30)
        del lm, params, opt
        torch.cuda.empty_cache()
    log(f"  remat at depth 2 (bf16, B {LM_BATCH} x S {LM_SEQ}): "
        f"forward+backward / AdamW ms (median of 3 after a warm-up) and "
        f"peak GiB: full {res[True]}, off {res[False]} [{CARD}]")


def train_lm_path(wrappers, ckpt_dir):
    """train-lm-qwen3-0.6b: ``launch.train.main`` at depth 28, bf16, remat
    ``full``, B 4 x S 1,024: 6 steps with a checkpoint every 3, then a
    restart from the latest checkpoint (step 3), which runs steps 4-5."""
    import shutil

    from repro_torch.checkpoint import ckpt as ckpt_mod
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import train as launch_train
    from repro_torch.optim.adamw import adamw_update, tree_leaves
    from repro_torch.train import lm_step
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    argv = ["--arch", LM_ARCH, "--batch", str(LM_BATCH), "--seq",
            str(LM_SEQ), "--ckpt-dir", ckpt_dir, "--ckpt-every", "3",
            "--log-every", "1", "--lr", "3e-4", "--steps", "6"]
    step_ms, snap, got, models, bad, starts = [], {}, {}, [], [], []
    make_step, save, restore_fn, build = (
        lm_step.make_train_step, ckpt_mod.save_checkpoint,
        launch_train.restore_checkpoint, launch_train.build_lm)

    def timed_make(*a, **kw):
        fn = make_step(*a, **kw)
        starts.append(None)

        def step(state, batch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if starts[-1] is None:      # the run's training window opens
                starts[-1] = t
            out = fn(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            return out
        return step

    def saving(ckpt_dir_, step, state, **kw):
        if step == 3:       # the state the restart must find, on the host
            snap.update({k: v.detach().to("cpu", copy=True)
                         if torch.is_tensor(v) else v
                         for k, v in ckpt_mod._flatten(state).items()})
        return save(ckpt_dir_, step, state, **kw)

    bits = lambda t: t.detach().cpu().reshape(-1).view(torch.uint8)

    def restoring(ckpt_dir_, step, like, **kw):
        """Restore, and hold every restored leaf against the state saved
        at step 3, bit for bit, before the run updates it."""
        got["state"] = restore_fn(ckpt_dir_, step, like, **kw)
        got["step"] = step
        flat = ckpt_mod._flatten(got["state"])
        if set(flat) != set(snap):
            bad.append("leaf sets differ")
        for k, v in flat.items():
            w = snap.get(k)
            if torch.is_tensor(v):
                same = (torch.is_tensor(w) and v.shape == w.shape
                        and v.dtype == w.dtype
                        and torch.equal(bits(v), bits(w)))
            else:
                same = v == w
            if not same:
                bad.append(k)
        snap.clear()
        return got["state"]

    def building(*a, **kw):
        models.append(build(*a, **kw))
        return models[-1]
    zero_counts(wrappers)
    calls, restore_plain = count_plain_calls(FA)
    lm_step.make_train_step = timed_make
    ckpt_mod.save_checkpoint = saving
    launch_train.restore_checkpoint = restoring
    launch_train.build_lm = building
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    try:
        # each run's window: its first step's start to main's return
        # (checkpoint saves and their final wait included)
        losses = launch_train.main(argv)
        spans = [time.perf_counter() - starts[-1]]
        first_run = (lm_counts(wrappers), len(losses))
        restart = launch_train.main(argv)
        spans.append(time.perf_counter() - starts[-1])
    finally:
        lm_step.make_train_step, ckpt_mod.save_checkpoint = make_step, save
        launch_train.restore_checkpoint = restore_fn
        launch_train.build_lm = build
        restore_plain()
    wall = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches, plain = lm_counts(wrappers), dict(calls)
    n_steps = len(losses) + len(restart)
    steady = sorted(step_ms[1:len(losses)] + step_ms[len(losses) + 1:])
    p50 = steady[len(steady) // 2] if steady else float("nan")
    # users' rate: every token trained over the windows' whole wall time
    tok_s = n_steps * LM_BATCH * LM_SEQ / sum(spans)
    # forward+backward against AdamW of the restarted run's model and
    # state, one step each after the run
    lm, state = models[-1], got.get("state")
    fb_ms = opt_ms = float("nan")
    if state is not None:
        batch = lm_batch(lm.cfg.vocab, LM_SEQ, LM_BATCH, 99, "cuda")
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grads = torch.autograd.grad(lm.loss(state.params, batch),
                                    tree_leaves(state.params))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        adamw_update(state.params, grads, state.opt, 3e-4, weight_decay=0.1,
                     grad_clip=1.0)
        torch.cuda.synchronize()
        fb_ms, opt_ms = (t2 - t1) * 1e3, (time.perf_counter() - t2) * 1e3
        del grads
        # where a forward+backward's device time goes
        p_wall, busy, rows = device_breakdown(lambda: torch.autograd.grad(
            lm.loss(state.params, batch), tree_leaves(state.params)))
        k13 = sum(ms for ms, _, n in rows if "flash_attention_fwd" in n)
        k13b = sum(ms for ms, _, n in rows if "flash_bwd" in n)
        log(f"breakdown train-lm forward+backward: wall {p_wall:.3f} ms "
            f"under the profiler, device busy {busy:.3f} ms "
            f"({busy / p_wall:.3f}) "
            f"[{CARD}]; {sum(c for _, c, _ in rows)} device activities; "
            f"kernel 13 {k13:.3f} ms, 13b {k13b:.3f} ms "
            f"({(k13 + k13b) / busy:.3f} of busy); top kernels (ms, calls): "
            + "; ".join(f"{n} {ms:.3f} x{c}" for ms, c, n in rows[:10]))
    ln_v = math.log(lm.cfg.vocab)
    log(f"path train-lm-{LM_ARCH}: launch.train.main, {lm.cfg.n_layers} "
        f"layers bf16, remat {lm.cfg.remat_policy}, B {LM_BATCH} x S "
        f"{LM_SEQ}: losses {losses} then, restarted from step "
        f"{got.get('step')}, {restart} (ln V {ln_v}); step "
        f"host ms {[round(x, 3) for x in step_ms]}, p50 {p50} after each "
        f"run's first; {tok_s:.1f} tokens/s over the two runs' windows "
        f"({[round(x, 3) for x in spans]} s, checkpoints included); one "
        f"step split: forward+backward {fb_ms:.3f} ms, AdamW {opt_ms:.3f} ms;"
        f" peak memory {peak:.2f} GiB; {wall:.1f} s with the checkpoints "
        f"[{CARD}]; launches={launches} over {n_steps} steps (first run "
        f"{first_run}); plain calls {plain}; restored leaves not equal to "
        f"the saved ones: {bad[:5]}")
    allv = losses + restart
    if not all(math.isfinite(x) for x in allv) or len(losses) != 6 or \
            len(restart) != 2:
        problem(f"path train-lm: losses {losses} / {restart}: expected 6 "
                f"then 2 finite losses")
    if not abs(losses[0] - ln_v) <= 0.5:
        problem(f"path train-lm: first loss {losses[0]} not within 0.5 of "
                f"ln V {ln_v}")
    n = lm.cfg.n_layers
    if launches["flash_attention"] != 2 * n * n_steps or \
            launches["flash_attention_bwd"] != n * n_steps:
        problem(f"path train-lm: kernel 13 / 13b launched "
                f"{launches['flash_attention']} / "
                f"{launches['flash_attention_bwd']} times over {n_steps} "
                f"steps, expected {2 * n} / {n} a step")
    check_launches(f"train-lm-{LM_ARCH}", launches,
                   ["flash_attention", "flash_attention_bwd"],
                   [k for k in wrappers if not k.startswith("flash")])
    if any(plain.values()):
        problem(f"path train-lm: plain versions ran on the card: {plain}")
    if got.get("step") != 3 or "state" not in got or bad:
        problem(f"path train-lm: the restart restored step "
                f"{got.get('step')}, leaves differing from the saved ones: "
                f"{bad[:5]}")
    del lm, state, models[:]
    got.clear()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    remat_compare()
    return launches


# the MoE and SSM LM families (granite, moonshot at depth 8, mamba2)
MOE_SPANS = ("moe.route", "moe.slots", "moe.dispatch", "moe.experts",
             "moe.combine")
SSM_SPANS = ("ssm.conv", "ssm.ssd")
SSM_SPLIT = 768              # teacher forcing: prefill 768, decode the rest
# bf16, 48 layers: the last logits of a 768-token prefill + 256 decode
# steps may differ from the 1,024-token prefill's by twice the bf16
# prefill's own distance (rel L2) from the fp32 prefill of the same
# weights: each bf16 path rounds the same sums in other places (the
# decode conv in fp32, the prefill's in bf16; the recurrence against the
# chunked form), and each may be that far from the fp32 result
SSM_DECODE_FACTOR = 2.0
FAMILY_STEPS = 4             # train-lm-<family>: steps of launch.train.main


class StageSpans:
    """While installed, the MoE stages (``ffn._route``, ``_slots``,
    ``_dispatch``, ``_expert_ffn``, ``_combine``) and the SSD core's
    (``mamba2.causal_conv1d``, ``ssd_chunked``) each run inside a
    ``record_function`` span named for the stage, ``_slots`` records each
    call's dropped assignments (a device count) and ``_route`` each call's
    expert ids."""

    def __init__(self):
        from repro_torch.models.lm import ffn, mamba2
        self.drops, self.ids = [], []
        self.saved = []
        for mod, name, label in (
                (ffn, "_route", "moe.route"), (ffn, "_slots", "moe.slots"),
                (ffn, "_dispatch", "moe.dispatch"),
                (ffn, "_expert_ffn", "moe.experts"),
                (ffn, "_combine", "moe.combine"),
                (mamba2, "causal_conv1d", "ssm.conv"),
                (mamba2, "ssd_chunked", "ssm.ssd")):
            self.saved.append((mod, name, getattr(mod, name)))
            setattr(mod, name, self._wrap(getattr(mod, name), label))

    def _wrap(self, fn, label):
        from torch.profiler import record_function

        def run(*a, **kw):
            with record_function(label):
                out = fn(*a, **kw)
            if label == "moe.slots":
                self.drops.append((~out[2]).sum())
            elif label == "moe.route":
                self.ids.append(out[1].detach())
            return out
        return run

    def close(self):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def family_model(arch, device, dtype=None, n_layers=None, seed=SEED,
                 **over):
    """``build_lm`` of ``arch`` (depth ``n_layers`` if given, ``dtype`` if
    given, other fields ``over``) with weights drawn from ``seed`` on
    ``device``, the template's zero gates and biases drawn too
    (``draw_zero_inits``: they would leave the cross branches and the
    biases out)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.lm.model import build_lm, draw_zero_inits
    cfg = get_config(arch)
    over.update({k: v for k, v in (("n_layers", n_layers), ("dtype", dtype))
                 if v is not None})
    lm = build_lm(dataclasses.replace(cfg, **over), device=device)
    g = torch.Generator(device).manual_seed(seed)
    draw_zero_inits(lm.init(g), g)
    return lm


def n_params(lm) -> int:
    """The model's parameter count from its leaves (``param_count()`` is the
    reference's estimate: for whisper it counts a SwiGLU FFN the audio
    family does not have)."""
    return sum(p.numel() for p in lm.parameters())


def breakdown_log(name, what, run, labels):
    spans = dict.fromkeys(labels, 0.0)
    wall, busy, rows = device_breakdown(run, spans)
    k13 = sum(ms for ms, _, n in rows if "flash_attention_fwd" in n)
    k13b = sum(ms for ms, _, n in rows if "flash_bwd" in n)
    log(f"breakdown {name} {what}: wall {wall:.3f} ms under the profiler, "
        f"device busy {busy:.3f} ms ({busy / wall:.3f}) [{CARD}]; "
        f"{sum(c for _, c, _ in rows)} device activities; kernel 13 "
        f"{k13:.3f} ms ({k13 / busy:.3f} of busy), 13b {k13b:.3f} ms; "
        f"stages (device ms) "
        + ", ".join(f"{k} {v:.3f}" for k, v in spans.items())
        + f" ({sum(spans.values()) / busy:.3f} of busy); top kernels (ms, "
        f"calls): " + "; ".join(f"{n} {ms:.3f} x{c}"
                                for ms, c, n in rows[:8]))


def serve_lm_moe_path(name, arch, n_layers, wrappers):
    """serve-lm-<moe arch>: ``examples/serve_lm.py``'s layout at full width
    (``n_layers`` cut when given), bf16: prefill the padded prompts (one
    kernel 13 launch a layer), 16 greedy decode steps (none); the
    assignments each layer's capacity drops in the prefill; a profiler
    breakdown of a prefill by MoE stage."""
    from repro_torch.models.lm import serve
    from repro_torch.models.lm.ffn import moe_capacity
    lm = family_model(arch, "cuda", n_layers=n_layers)
    params, vocab, n = lm.params(), lm.cfg.vocab, lm.cfg.n_layers
    tokens = lm_tokens(vocab, LM_BATCH, LM_PROMPT, LM_PROMPT + LM_NEW,
                       SEED).cuda()
    b, total = tokens.shape
    s = total - LM_NEW
    serve.prefill(lm, params, tokens)                 # warm-up
    spans = StageSpans()
    try:
        zero_counts(wrappers)
        torch.cuda.synchronize()
        t = time.perf_counter()
        cache, logits = serve.prefill(lm, params, tokens)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t) * 1e3
        n_prefill = wrappers["flash_attention"].launches
        drops = [int(d) for d in spans.drops]
        finite = torch.isfinite(logits).all()
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
        breakdown_log(name, "prefill",
                      lambda: serve.prefill(lm, params, tokens), MOE_SPANS)
    finally:
        spans.close()
    from repro_torch.configs import get_config
    c = lm.cfg
    cap = moe_capacity(b * total, c.n_experts, c.top_k, c.capacity_factor)
    log(f"path {name}: {c.name} d {c.d_model}, {c.n_experts} experts top-"
        f"{c.top_k}, hd {c.hd}, heads {c.n_heads}/{c.n_kv}, vocab "
        f"{c.vocab}, {n} of {get_config(arch).n_layers} layers, bf16: {b} "
        f"prompts of {s} tokens padded to {total}: prefill {prefill_ms:.3f} "
        f"ms, {LM_NEW} decode steps {decode_s * 1e3 / LM_NEW:.3f} ms a step "
        f"= {b * LM_NEW / decode_s:.1f} tokens/s [{CARD}]; capacity "
        f"{cap} of {b * total * c.top_k} assignments over {c.n_experts} "
        f"experts, dropped per layer in the prefill {drops}; launches="
        f"{launches}; sample {torch.cat(gen, 1)[:2].tolist()}")
    if n_prefill != n or launches["flash_attention"] != n:
        problem(f"path {name}: {n_prefill} flash launches in the prefill "
                f"and {launches['flash_attention'] - n_prefill} in the "
                f"decode, expected {n} and 0")
    check_launches(name, launches, ["flash_attention"],
                   [k for k in wrappers if k != "flash_attention"])
    if not bool(finite):
        problem(f"path {name}: non-finite logits")
    del lm, params, cache
    torch.cuda.empty_cache()
    return launches


def serve_lm_ssm_path(wrappers):
    """serve-lm-mamba2-1.3b: full width and depth (48 layers), bf16: a
    1,024-token prefill of 4 sequences and 16 greedy decode steps; then a
    768-token prefill and decode steps over tokens 768-1,023, whose last
    logits match the 1,024-token prefill's (teacher forcing); no kernel
    13 launch; a profiler breakdown of a prefill."""
    from repro_torch.models.lm import serve
    arch = "mamba2-1.3b"
    lm = family_model(arch, "cuda")
    params, vocab = lm.params(), lm.cfg.vocab
    tokens = lm_tokens(vocab, LM_BATCH, LM_SEQ, LM_SEQ, SEED).cuda()
    b, total = tokens.shape
    serve.prefill(lm, params, tokens)                 # warm-up
    zero_counts(wrappers)
    torch.cuda.synchronize()
    t = time.perf_counter()
    cache, full = serve.prefill(lm, params, tokens)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    finite = torch.isfinite(full).all()
    tok = full[:, -1:, :vocab].argmax(-1)
    gen = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(LM_NEW):
        cache, logits = serve.decode_step(lm, params, cache, tok, total + i)
        finite &= torch.isfinite(logits).all()
        tok = logits[:, :, :vocab].argmax(-1)
        gen.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    del cache
    t = time.perf_counter()
    cache, _ = serve.prefill(lm, params, tokens[:, :SSM_SPLIT])
    for i in range(SSM_SPLIT, total):
        cache, logits = serve.decode_step(lm, params, cache,
                                          tokens[:, i:i + 1], i)
    torch.cuda.synchronize()
    tf_s = time.perf_counter() - t
    rel = rel_l2(logits, full)
    same = torch.equal(logits[:, :, :vocab].argmax(-1),
                       full[:, :, :vocab].argmax(-1))
    launches = lm_counts(wrappers)
    # the bf16 prefill against the fp32 prefill of the same weights
    lm32 = family_model(arch, "cuda", dtype="float32")
    _, full32 = serve.prefill(lm32, lm32.params(), tokens)
    bf16_rel = rel_l2(full, full32)
    limit = SSM_DECODE_FACTOR * bf16_rel
    del lm32
    torch.cuda.empty_cache()
    spans = StageSpans()
    try:
        breakdown_log("serve-lm-mamba2-1.3b", "prefill",
                      lambda: serve.prefill(lm, params, tokens), SSM_SPANS)
        breakdown_log("serve-lm-mamba2-1.3b", "decode step",
                      lambda: serve.decode_step(lm, params, cache,
                                                tokens[:, :1], 0), ())
    finally:
        spans.close()
    c = lm.cfg
    log(f"path serve-lm-{arch}: d {c.d_model}, state {c.ssm_state}, "
        f"{c.ssm_expand * c.d_model // c.ssm_head_dim} heads of "
        f"{c.ssm_head_dim}, chunk {c.ssm_chunk}, {c.n_layers} layers, bf16: "
        f"{b} x {total} tokens: prefill {prefill_ms:.3f} ms, {LM_NEW} "
        f"decode steps {decode_s * 1e3 / LM_NEW:.3f} ms a step = "
        f"{b * LM_NEW / decode_s:.1f} tokens/s [{CARD}]; prefill "
        f"{SSM_SPLIT} + {total - SSM_SPLIT} decode steps ({tf_s:.2f} s): "
        f"last logits vs the {total}-token prefill rel L2 {rel} (limit "
        f"{limit}: {SSM_DECODE_FACTOR} x the bf16 prefill's rel L2 "
        f"{bf16_rel} from the fp32 prefill), greedy token equal: {same}; "
        f"launches="
        f"{launches}; sample {torch.cat(gen, 1)[:2].tolist()}")
    check_launches(f"serve-lm-{arch}", launches, [], list(wrappers))
    if not bool(finite):
        problem(f"path serve-lm-{arch}: non-finite logits")
    if not rel <= limit:
        problem(f"path serve-lm-{arch}: decoding tokens {SSM_SPLIT}-"
                f"{total - 1} after a {SSM_SPLIT}-token prefill differs from "
                f"the {total}-token prefill by {rel} relative L2")
    del lm, params, cache
    torch.cuda.empty_cache()
    return launches


def topk_diff(ids_a, ids_b):
    """Tokens whose top-k expert set differs between two runs' routing
    calls (the same calls in the same order)."""
    if len(ids_a) != len(ids_b):
        return float("inf")
    return sum(int((a.sort(-1).values.cpu() != b.sort(-1).values.cpu())
                   .any(-1).sum()) for a, b in zip(ids_a, ids_b))


def lm_fp32_path(name, models, wrappers, n_steps=8):
    """``name``: each of ``models`` (``FP32_FAMILIES`` or ``FP32_CROSS``)
    in fp32 (TF32 off) from the same weights (cross gates and GELU biases
    nonzero) on the card and on the CPU, with seeded image tokens / frames
    where the family reads them: the prefill of 2 x 120 tokens padded to
    128 and 8 greedy decode steps (logits ``FP32_LM_RTOL``, the same
    tokens), then one ``make_train_step`` step at B 2 x S 128: its loss
    (1e-5 relative), the gradients it hands AdamW (1e-4 relative L2 a
    leaf), the parameters it updates against the CPU's AdamW applied to
    the card's own gradients and against the CPU's whole step (1e-4
    relative L2 a leaf each; the whole step only logged for
    ``WHOLE_STEP_LOGGED``); the MoE top-k expert sets of every routing call
    equal on both.  The CPU's D-ReLU keeps the card's picks
    (``DreluPins``; its own flipped picks counted and held under
    ``DRELU_FLIPS`` of the kept entries).  The SSM family also runs a
    64-token prefill and 64 decode steps against the 128-token prefill on
    the card (``FP32_LM_RTOL``)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.lm import serve
    from repro_torch.models.lm.model import build_lm
    from repro_torch.optim.adamw import adamw_init, tree_leaves
    from repro_torch.train import lm_step
    update = lm_step.adamw_update
    total_launches = {k: 0 for k in wrappers}
    for arch, over, seed in models:
        t0 = time.perf_counter()
        lm = family_model(arch, "cuda", dtype="float32", seed=seed, **over)
        cfg = lm.cfg
        cpu = build_lm(cfg, device="cpu")
        cpu.load_state_dict(lm.state_dict())
        prompt, total = 120, 128
        tokens = lm_tokens(cfg.vocab, 2, prompt, total, seed)
        extra = lm_extras(cfg, 2, "cpu", seed + 3)
        out, ids, launches, plain, secs = {}, {}, None, None, {}
        pins = DreluPins()
        for model, dev in ((lm, "cuda"), (cpu, "cpu")):
            t1 = time.perf_counter()
            params = model.params()
            ex = {k: v.to(dev) for k, v in extra.items()}
            pins.replay = dev == "cpu"
            if dev == "cuda":
                zero_counts(wrappers)
                calls, restore = count_plain_calls(FA)
            spans = StageSpans()
            try:
                cache, logits = serve.prefill(model, params, tokens.to(dev),
                                              ex or None)
                steps, toks = [logits], []
                tok = logits[:, -1:, :cfg.vocab].argmax(-1)
                for j in range(n_steps):
                    cache, logits = serve.decode_step(model, params, cache,
                                                      tok, prompt + j)
                    tok = logits[:, :, :cfg.vocab].argmax(-1)
                    steps.append(logits)
                    toks.append(tok)
                del cache
                # one step; its gradients are read where AdamW takes them
                grads = []
                lm_step.adamw_update = lambda p_, g_, *a, **kw: (
                    grads.extend(g.detach().clone() for g in g_),
                    update(p_, g_, *a, **kw))
                state = lm_step.TrainState(params, adamw_init(params))
                if dev == "cpu":
                    p0 = [p.detach().clone() for p in tree_leaves(params)]
                _, metrics = lm_step.make_train_step(
                    model, lr=1e-3, total_steps=10)(
                        state, {**lm_batch(cfg.vocab, 128, 2, 0, dev), **ex})
                loss = metrics["loss"]
                if dev == "cuda":
                    torch.cuda.synchronize()
            finally:
                lm_step.adamw_update = update
                spans.close()
                if dev == "cuda":
                    restore()
                else:
                    pins.close()
            if dev == "cuda":
                launches, plain = lm_counts(wrappers), dict(calls)
            secs[dev] = round(time.perf_counter() - t1, 1)
            ids[dev] = [x.cpu() for x in spans.ids]
            out[dev] = ([x.cpu() for x in steps], torch.cat(toks, 1).cpu(),
                        float(loss.detach()), [g.cpu() for g in grads],
                        [p.detach().cpu() for p in tree_leaves(params)],
                        float(metrics["grad_norm"]))
            del grads, state, params
        names = list(flat_names(lm.params()))
        (lg_g, tk_g, l_g, g_g, p_g, n_g), (lg_c, tk_c, l_c, g_c, p_c, n_c) = \
            out["cuda"], out["cpu"]
        rels = max(rel_l2(a, b) for a, b in zip(lg_g, lg_c))
        loss_rel = abs(l_g - l_c) / abs(l_c)
        grad_rel, grad_at = max((rel_l2(a, b), n)
                                for a, b, n in zip(g_g, g_c, names))
        # the CPU's AdamW on the card's gradients, from the same weights
        p_ref = [p.clone() for p in p0]
        update(p_ref, g_g, adamw_init(p_ref),
               lm_step.make_schedule(cfg, 1e-3, 10)(0), weight_decay=0.1,
               grad_clip=1.0)
        par_rel, par_at = max((rel_l2(a, b), n)
                              for a, b, n in zip(p_g, p_ref, names))
        whole_rel, whole_i = max((rel_l2(a, b), i)
                                 for i, (a, b) in enumerate(zip(p_g, p_c)))
        g_small = g_g[whole_i].abs()
        held = arch not in WHOLE_STEP_LOGGED
        del p0, p_ref
        diff = topk_diff(ids["cuda"], ids["cpu"])
        pre = prefill_flash(cfg)
        fwd, bwd = step_flash(cfg)
        log(f"path {name} {arch} {over}: {n_params(lm):,} parameters from "
            f"the leaves; prefill + {n_steps} decode steps: logits rel L2 "
            f"max {rels} (limit {FP32_LM_RTOL}), greedy tokens equal: "
            f"{torch.equal(tk_g, tk_c)}; B 2 x S 128: loss card {l_g} CPU "
            f"{l_c} (rel {loss_rel}, limit 1e-5); gradients rel L2 max "
            f"{grad_rel} at {grad_at} (limit 1e-4); grad norm {n_g} / {n_c}; "
            f"one step's parameters against the CPU's AdamW on the card's "
            f"gradients rel L2 max {par_rel} at {par_at} (limit 1e-4), "
            f"against the CPU's whole step {whole_rel} at {names[whole_i]} "
            f"({'limit 1e-4' if held else 'logged'}; its card gradient: |g| "
            f"min {float(g_small.min())}, max {float(g_small.max())}, "
            f"{int((g_small < 1e-6).sum())} of {g_small.numel()} elements "
            f"below 1e-6); routing calls {len(ids['cuda'])}, tokens whose "
            f"top-k expert set differs card vs CPU: {diff}; D-ReLU: "
            f"{pins.calls} calls, the CPU's own picks differ from the "
            f"card's at {pins.flips} of {pins.kept} kept entries (pinned to "
            f"the card's); launches={launches} (expected {pre} + {fwd} / "
            f"{bwd}); plain calls on the card {plain}; card {secs['cuda']} "
            f"s, CPU {secs['cpu']} s, {time.perf_counter() - t0:.1f} s in "
            f"all")
        if launches["flash_attention"] != pre + fwd or \
                launches["flash_attention_bwd"] != bwd:
            problem(f"path {name} {arch}: kernel 13 / 13b launched "
                    f"{launches['flash_attention']} / "
                    f"{launches['flash_attention_bwd']} times, expected "
                    f"{pre + fwd} / {bwd}")
        check_launches(f"{name} {arch}", launches,
                       ["flash_attention", "flash_attention_bwd"] if bwd
                       else [],
                       [k for k in wrappers if not k.startswith("flash")
                        or not bwd])
        if any(plain.values()):
            problem(f"path {name} {arch}: plain versions ran on the card: "
                    f"{plain}")
        if not (rels <= FP32_LM_RTOL and torch.equal(tk_g, tk_c)
                and loss_rel <= 1e-5 and grad_rel <= 1e-4
                and par_rel <= 1e-4 and (whole_rel <= 1e-4 or not held)
                and diff == 0):
            problem(f"path {name} {arch}: the card disagrees with the CPU")
        if pins.calls != len(pins.masks) or \
                pins.flips > DRELU_FLIPS * max(pins.kept, 1):
            problem(f"path {name} {arch}: D-ReLU calls card "
                    f"{len(pins.masks)} CPU {pins.calls}, {pins.flips} "
                    f"flipped picks of {pins.kept}")
        if cfg.family == "ssm":
            # teacher forcing in fp32 on the card: a 64-token prefill then
            # 64 decode steps against the 128-token prefill (1e-4)
            seq = lm_tokens(cfg.vocab, 2, total, total, SEED + 14).cuda()
            _, full = serve.prefill(lm, lm.params(), seq)
            cache, _ = serve.prefill(lm, lm.params(), seq[:, :total // 2])
            for j in range(total // 2, total):
                cache, last = serve.decode_step(lm, lm.params(), cache,
                                                seq[:, j:j + 1], j)
            tf = rel_l2(last, full)
            log(f"path {name} {arch}: a {total // 2}-token prefill + "
                f"{total // 2} decode steps against the {total}-token "
                f"prefill: last logits rel L2 {tf} (limit {FP32_LM_RTOL})")
            if not tf <= FP32_LM_RTOL:
                problem(f"path {name} {arch}: teacher forcing differs from "
                        f"the prefill by {tf}")
            del cache
        for k, v in launches.items():
            total_launches[k] += v
        del lm, cpu, out
        torch.cuda.empty_cache()
    return total_launches


def train_lm_family_path(arch, wrappers, seq=LM_SEQ, extras_seed=None):
    """train-lm-<arch>: ``launch.train.main`` at full width and depth,
    bf16, remat ``full``, B 4 x S ``seq``, ``FAMILY_STEPS`` steps: finite
    losses, the first within 0.5 of ln V (MoE: plus 0.01 x aux, aux at
    most the expert count); ``step_flash`` launches of kernels 13 / 13b a
    step (MoE 2 / 1 a layer, SSM none, the hybrid 1 / 1 an application of
    its shared block); step p50, tokens/s, peak memory, and a profiler
    breakdown of one forward+backward by stage.  With ``extras_seed`` the
    VLM's image tokens / the audio family's frames are seeded draws, a new
    one each step, in place of ``launch.train``'s zeros, which would leave
    the cross-attention no work and give whisper a NaN gradient (its
    all-zero encoder stream meets each ``rms_norm`` at 0; ROADMAP §3)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import train as launch_train
    from repro_torch.models.lm.model import extra_input
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import lm_step
    argv = ["--arch", arch, "--batch", str(LM_BATCH), "--seq", str(seq),
            "--log-every", "1", "--lr", "3e-4", "--steps", str(FAMILY_STEPS)]
    step_ms, starts, models = [], [], []
    make_step, build = lm_step.make_train_step, launch_train.build_lm
    zeros = launch_train._maybe_add_extras

    def timed_make(*a, **kw):
        fn = make_step(*a, **kw)

        def step(state, batch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            if not starts:
                starts.append(t)
            out = fn(state, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            return out
        return step

    def building(*a, **kw):
        models.append(build(*a, **kw))
        return models[-1]

    def seeded(cfg, batch, lm):
        batch.update(lm_extras(cfg, LM_BATCH, "cuda",
                               extras_seed + len(step_ms), lm.dtype))
    zero_counts(wrappers)
    calls, restore_plain = count_plain_calls(FA)
    lm_step.make_train_step = timed_make
    launch_train.build_lm = building
    if extras_seed is not None:
        launch_train._maybe_add_extras = seeded
    torch.cuda.reset_peak_memory_stats()
    try:
        losses = launch_train.main(argv)
        span = time.perf_counter() - starts[0]
    finally:
        lm_step.make_train_step, launch_train.build_lm = make_step, build
        launch_train._maybe_add_extras = zeros
        restore_plain()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches, plain = lm_counts(wrappers), dict(calls)
    steady = sorted(step_ms[1:])
    p50 = steady[len(steady) // 2] if steady else float("nan")
    tok_s = len(losses) * LM_BATCH * seq / span
    lm = models[-1]
    c = lm.cfg
    moe = c.family == "moe"
    batch = {**lm_batch(c.vocab, seq, LM_BATCH, 99, "cuda"),
             **lm_extras(c, LM_BATCH, "cuda", SEED + 99, lm.dtype)}
    params = lm.params()
    spans = StageSpans()
    try:
        breakdown_log(f"train-lm-{arch}", "forward+backward",
                      lambda: torch.autograd.grad(lm.loss(params, batch),
                                                  tree_leaves(params)),
                      MOE_SPANS if moe else SSM_SPANS)
    finally:
        spans.close()
    ln_v = math.log(c.vocab)
    hi = ln_v + 0.5 + (0.01 * c.n_experts if moe else 0.0)
    depth = (f"{c.enc_layers} + {c.n_layers}" if c.family == "audio"
             else str(c.n_layers))
    mem = extra_input(c)
    over = (f" over {mem[1]} seeded {mem[0]}"
            if mem and extras_seed is not None else "")
    log(f"path train-lm-{arch}: launch.train.main, {depth} layers bf16, "
        f"{n_params(lm):,} parameters from the leaves, remat "
        f"{c.remat_policy}, B {LM_BATCH} x S {seq}{over}: losses "
        f"{losses} (ln V {ln_v}, first-loss window [{ln_v - 0.5}, {hi}]); "
        f"step host ms {[round(x, 3) for x in step_ms]}, p50 {p50} after "
        f"the first; {tok_s:.1f} tokens/s over the run's window ({span:.3f}"
        f" s); peak memory {peak:.2f} GiB [{CARD}]; launches={launches} "
        f"over {len(losses)} steps; plain calls {plain}")
    if len(losses) != FAMILY_STEPS or \
            not all(math.isfinite(x) for x in losses):
        problem(f"path train-lm-{arch}: losses {losses}: expected "
                f"{FAMILY_STEPS} finite losses")
    if not ln_v - 0.5 <= losses[0] <= hi:
        problem(f"path train-lm-{arch}: first loss {losses[0]} outside "
                f"[{ln_v - 0.5}, {hi}]")
    fwd, bwd = step_flash(c)
    if launches["flash_attention"] != fwd * FAMILY_STEPS or \
            launches["flash_attention_bwd"] != bwd * FAMILY_STEPS:
        problem(f"path train-lm-{arch}: kernel 13 / 13b launched "
                f"{launches['flash_attention']} / "
                f"{launches['flash_attention_bwd']} times over "
                f"{FAMILY_STEPS} steps, expected {fwd} / {bwd} a step")
    check_launches(f"train-lm-{arch}", launches,
                   ["flash_attention", "flash_attention_bwd"] if fwd else [],
                   [k for k in wrappers if not k.startswith("flash")
                    or not fwd])
    if any(plain.values()):
        problem(f"path train-lm-{arch}: plain versions ran on the card: "
                f"{plain}")
    del lm, params, models[:]
    torch.cuda.empty_cache()
    return launches


# the hybrid (zamba2), audio (whisper) and VLM (llama-3.2-vision) families
WHISPER_CTX = 448            # whisper's published decoder context
VLM_DEPTH = 5                # one group: 4 self layers + 1 cross layer
# lm-hybrid-cross-fp32: the VLM at depth 5 cut in width so that the CPU
# trains it (hd 128, 8:1 GQA, d_ff / d 3.5 and drelu_k / d_ff 1/4 kept)
VLM_CPU_CUT = dict(d_model=1024, n_heads=8, n_kv=1, d_ff=3584, drelu_k=896)
# lm-hybrid-cross-fp32: at most this share of the kept D-ReLU entries may
# be picked otherwise by the CPU than by the card (near ties that fp32
# rounding flips; more would be a real difference)
DRELU_FLIPS = 1e-4
# the hybrid's teacher forcing: (sequence, prefix prefilled); one 256-token
# chunk, since the SSM path's 768 + 256 would take 256 of its ~140 ms
# decode steps
HYBRID_TF = (256, 192)

# lm-families-fp32-depth2: granite, moonshot and mamba2 at full width and
# 2 layers; lm-hybrid-cross-fp32: zamba2 at full width and depth 8 (one
# group and a tail of 2: the shared block twice), whisper at full width
# with 2 encoder + 2 decoder layers, the VLM at depth 5 cut to
# ``VLM_CPU_CUT``: (arch, fields replaced, seed) each
FP32_FAMILIES = (("granite-moe-1b-a400m", dict(n_layers=2), SEED + 11),
                 ("moonshot-v1-16b-a3b", dict(n_layers=2), SEED + 12),
                 ("mamba2-1.3b", dict(n_layers=2), SEED + 13))
FP32_CROSS = (("zamba2-1.2b", dict(n_layers=8), SEED + 41),
              ("whisper-large-v3", dict(n_layers=2, enc_layers=2), SEED + 42),
              ("llama-3.2-vision-90b", dict(n_layers=VLM_DEPTH,
                                            **VLM_CPU_CUT), SEED + 43))
# the one model whose whole step (the CPU's AdamW on the CPU's gradients)
# is logged and not held: zamba2's zero-initialised ``conv_c_b`` takes
# gradient elements near 4e-7, where AdamW's first update, lr g / (|g| +
# eps), turns fp32 noise into whole-update differences (4.4e-4 relative
# L2 in run 38e); the updated parameters are held against the CPU's AdamW
# on the card's gradients, as every model's are
WHOLE_STEP_LOGGED = ("zamba2-1.2b",)


def flat_names(tree, pre=""):
    """Leaf names of a parameter tree in ``tree_leaves``' order."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from flat_names(tree[k], f"{pre}{k}.")
        else:
            yield pre + k


def prefill_flash(cfg) -> int:
    """Kernel 13 launches of one prefill: one an attention layer; the
    hybrid's shared block once an application, whisper's decoder twice a
    layer (self and cross) after its encoder."""
    return {"ssm": 0, "hybrid": -(-cfg.n_layers // max(cfg.attn_every, 1)),
            "audio": cfg.enc_layers + 2 * cfg.n_layers}.get(cfg.family,
                                                            cfg.n_layers)


def step_flash(cfg):
    """(kernel 13, kernel 13b) launches of one training step under remat:
    a rematted attention runs its forward twice and its backward once; the
    hybrid's shared block runs outside remat, as the reference's does."""
    n = prefill_flash(cfg)
    if cfg.family == "hybrid" or not cfg.remat:
        return n, n
    return 2 * n, n


def lm_extras(cfg, batch, device, seed, dtype=torch.float32):
    """Seeded ``image_emb`` (VLM) / ``frames`` (audio) of ``batch``
    sequences, or {}."""
    from repro_torch.models.lm.model import extra_input
    spec = extra_input(cfg)
    if spec is None:
        return {}
    x = torch.randn((batch, spec[1], cfg.d_model), device=device,
                    generator=torch.Generator(device).manual_seed(seed))
    return {spec[0]: x.to(dtype)}


def serve_lm_family_path(name, arch, wrappers, n_layers=None):
    """serve-lm-<arch>: ``examples/serve_lm.py``'s layout at full width
    (depth ``n_layers`` if given), bf16, random weights from a seed: 4
    prompts padded with 16 zeros (whisper: to its 448-token context, over
    seeded frames of 4 x 1,500 x 1,280; the VLM: to 1,024, over 1,600
    seeded image tokens), the prefill (``prefill_flash`` launches of
    kernel 13), decode at S-1 against the prefill's last logits (rel L2
    ``DECODE_RTOL``), 16 greedy steps (no launch), a profiler breakdown of
    a prefill and a decode step.  The hybrid's prompts run the same way,
    then teacher forcing (``hybrid_teacher_forcing``)."""
    from repro_torch.models.lm import serve
    lm = family_model(arch, "cuda", n_layers=n_layers)
    params, c = lm.params(), lm.cfg
    total = WHISPER_CTX if c.family == "audio" else LM_SEQ
    s = total - LM_NEW
    tokens = lm_tokens(c.vocab, LM_BATCH, s, total, SEED + 21).cuda()
    extra = lm_extras(c, LM_BATCH, "cuda", SEED + 22, torch.bfloat16) \
        or None
    serve.prefill(lm, params, tokens, extra)                   # warm-up
    zero_counts(wrappers)
    torch.cuda.synchronize()
    t = time.perf_counter()
    cache, logits = serve.prefill(lm, params, tokens, extra)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t) * 1e3
    n_prefill = wrappers["flash_attention"].launches
    finite = torch.isfinite(logits).all()
    rel = None
    if c.family != "hybrid":
        # a recurrent state cannot take position S-1 again
        _, again = serve.decode_step(lm, params, cache, tokens[:, -1:],
                                     total - 1)
        rel = rel_l2(again, logits)
        finite &= torch.isfinite(again).all()
    tok = logits[:, -1:, :c.vocab].argmax(-1)
    gen = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(LM_NEW):
        cache, logits = serve.decode_step(lm, params, cache, tok, s + i)
        finite &= torch.isfinite(logits).all()
        tok = logits[:, :, :c.vocab].argmax(-1)
        gen.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    launches = lm_counts(wrappers)
    spans = StageSpans()
    try:
        breakdown_log(name, "prefill",
                      lambda: serve.prefill(lm, params, tokens, extra),
                      SSM_SPANS if c.family == "hybrid" else ())
        breakdown_log(name, "decode step", lambda: serve.decode_step(
            lm, params, cache, tok, total - 1), ())
    finally:
        spans.close()
    tf = ""
    if c.family == "hybrid":
        tf = hybrid_teacher_forcing(name, lm)
    mem = {"vlm": f"{c.n_img_tokens} image tokens",
           "audio": f"{c.enc_layers} encoder layers over {c.enc_frames} "
                    f"frames"}.get(c.family, f"shared block every "
                                             f"{c.attn_every} SSM layers")
    from repro_torch.configs import get_config
    full = get_config(arch)
    log(f"path {name}: {c.name} d {c.d_model}, heads {c.n_heads}/{c.n_kv} "
        f"hd {c.hd}, d_ff {c.d_ff}, vocab {c.vocab}, {c.n_layers} of "
        f"{full.n_layers} layers ({mem}), {n_params(lm):,} parameters from "
        f"the leaves (param_count() {c.param_count():,}), bf16: {LM_BATCH} "
        f"prompts of {s} tokens padded to {total}: prefill "
        f"{prefill_ms:.3f} ms, {LM_NEW} decode steps "
        f"{decode_s * 1e3 / LM_NEW:.3f} ms a step = "
        f"{LM_BATCH * LM_NEW / decode_s:.1f} tokens/s [{CARD}]; decode at "
        f"S-1 vs prefill rel L2 {rel} (limit {DECODE_RTOL}){tf}; launches="
        f"{launches}; sample {torch.cat(gen, 1)[:2].tolist()}")
    want = prefill_flash(c)
    if n_prefill != want or launches["flash_attention"] != want:
        problem(f"path {name}: {n_prefill} flash launches in the prefill "
                f"and {launches['flash_attention'] - n_prefill} in the "
                f"decode, expected {want} and 0")
    check_launches(name, launches, ["flash_attention"],
                   [k for k in wrappers if k != "flash_attention"])
    if not bool(finite):
        problem(f"path {name}: non-finite logits")
    if rel is not None and not rel <= DECODE_RTOL:
        problem(f"path {name}: decode at S-1 differs from the prefill by "
                f"{rel} relative L2")
    del lm, params, cache, extra
    torch.cuda.empty_cache()
    return launches


def hybrid_teacher_forcing(name, lm):
    """A ``HYBRID_TF[1]``-token prefill, its cache copied into one of
    ``HYBRID_TF[0]`` slots, and decode steps over the rest of the same
    sequence: the last logits against the whole sequence's prefill,
    within ``SSM_DECODE_FACTOR`` x the bf16 prefill's distance from the
    fp32 prefill of the same weights."""
    from repro_torch.models.lm import serve
    params, c = lm.params(), lm.cfg
    total, split = HYBRID_TF
    seq = lm_tokens(c.vocab, LM_BATCH, total, total, SEED + 23).cuda()
    _, full = serve.prefill(lm, params, seq)
    t = time.perf_counter()
    part, _ = serve.prefill(lm, params, seq[:, :split])
    cache = serve.cache_zeros(lm, LM_BATCH, total)
    for k, v in part.items():
        if k in ("sk", "sv"):               # (n_app, B, S, KV, hd)
            cache[k][:, :, :split].copy_(v)
        else:
            cache[k].copy_(v)
    del part
    for i in range(split, total):
        cache, last = serve.decode_step(lm, params, cache, seq[:, i:i + 1], i)
    torch.cuda.synchronize()
    tf_s = time.perf_counter() - t
    rel = rel_l2(last, full)
    lm32 = family_model(c.name, "cuda", dtype="float32")
    _, full32 = serve.prefill(lm32, lm32.params(), seq)
    bf16_rel = rel_l2(full, full32)
    limit = SSM_DECODE_FACTOR * bf16_rel
    same = torch.equal(last[..., :c.vocab].argmax(-1),
                       full[..., :c.vocab].argmax(-1))
    del lm32, cache
    torch.cuda.empty_cache()
    if not rel <= limit:
        problem(f"path {name}: decoding tokens {split}-{total - 1} after a "
                f"{split}-token prefill differs from the {total}-token "
                f"prefill by {rel} relative L2")
    return (f"; prefill {split} + {total - split} decode steps ({tf_s:.2f} "
            f"s): last logits vs the {total}-token prefill rel L2 {rel} "
            f"(limit {limit}: {SSM_DECODE_FACTOR} x the bf16 prefill's rel "
            f"L2 {bf16_rel} from the fp32 prefill), greedy token equal: "
            f"{same}")


class DreluPins:
    """While installed, ``ffn.drelu_grouped`` (the SwiGLU FFN's D-ReLU)
    records each call's kept entries on the card; with ``replay`` set, the
    CPU's call of the same index keeps the card's entries instead of its
    own and counts the entries where its own pick differs.  In fp32 the
    two devices round the FFN's products in other orders, so a near-tied
    top-k pick can flip between them, and one flipped entry moves the
    gradient of a whole row and column; pinned, the two run the same
    function on the same selection."""

    def __init__(self):
        from repro_torch.models.lm import ffn
        self.ffn, self.orig = ffn, ffn.drelu_grouped
        self.masks, self.replay, self.calls = [], False, 0
        self.flips, self.kept = 0, 0
        ffn.drelu_grouped = self._run

    def _run(self, x, k, groups):
        y = self.orig(x, k, groups)
        if not self.replay:
            self.masks.append((y != 0).cpu())
            return y
        card = self.masks[self.calls].to(x.device)
        self.calls += 1
        self.flips += int(((y != 0) != card).sum())
        self.kept += int(card.sum())
        return torch.where(card, x, torch.zeros_like(x))

    def close(self):
        self.ffn.drelu_grouped = self.orig


def member_rows(batch):
    """Per node type, the members' real rows in a collated batch."""
    out = {}
    for t, off, size in (("cell", "cell_off", "n_cell"),
                         ("net", "net_off", "n_net")):
        out[t] = torch.cat([getattr(m, off) + torch.arange(getattr(m, size))
                            for m in batch.members]).cuda()
    return out


def padded_vs_exact(model, cfg, exact, padded):
    """Kernels 1 and 4 over the quantized arenas of a batch and over the
    exact-size arenas of the same members, fed the first layer's operands
    and the loss's cotangent at the members' rows: the real rows must be
    bit for bit equal (the walks skip the padding chunks).  Logs each
    kernel's profiler time on both arenas."""
    from repro_torch.kernels import drspmm as K1
    pe, pp = exact.plan, padded.plan
    re_, rp = member_rows(exact), member_rows(padded)
    xv, xi, _ = first_layer_operands(model, exact.graph, cfg)
    gy, _ = backward_operands(model, exact, cfg)
    xv_p = xv.new_zeros((pp.n_src_total, xv.shape[1]))
    xi_p = xi.new_zeros((pp.n_src_total, xi.shape[1]))
    for t, oe, op in zip(pe.src_types, pe.src_off, pp.src_off):
        xv_p[op + rp[t]] = xv[oe + re_[t]]
        xi_p[op + rp[t]] = xi[oe + re_[t]]
    gy_p = gy.new_zeros((pp.n_out_total, gy.shape[1]))
    for se, sp in zip(pe.segments, pp.segments):
        gy_p[sp.out_off + rp[se.dst_type]] = gy[se.out_off + re_[se.dst_type]]
    runs = {
        ("fwd", "exact"): lambda: K1.drspmm_fwd_arena(pe.fwd, xv, xi, HIDDEN),
        ("fwd", "padded"): lambda: K1.drspmm_fwd_arena(pp.fwd, xv_p, xi_p,
                                                       HIDDEN),
        ("bwd", "exact"): lambda: K1.drspmm_bwd_arena(
            pe.bwd, pe.bwd_src_rows, gy, xi),
        ("bwd", "padded"): lambda: K1.drspmm_bwd_arena(
            pp.bwd, pp.bwd_src_rows, gy_p, xi_p)}
    out = {}
    for (d, which), run in runs.items():
        plan = pe if which == "exact" else pp
        f = plan.fwd if d == "fwd" else plan.bwd
        out[d, which] = run().index_select(0, f.gather)
    n_diff = 0
    for se, sp in zip(pe.arena_segments, pp.arena_segments):
        for d, t, off_e, off_p in (
                ("fwd", se.dst_type, se.arena_out_off, sp.arena_out_off),
                ("bwd", se.src_type, se.src_out_off, sp.src_out_off)):
            a = out[d, "padded"][off_p + rp[t]]
            b = out[d, "exact"][off_e + re_[t]]
            n_diff += int((a != b).any(-1).sum())
    times = {k: device_breakdown(lambda: [run() for _ in range(REPS)])[1]
             / REPS for k, run in runs.items()}
    ratio = {d: times[d, "padded"] / times[d, "exact"] for d in ("fwd", "bwd")}
    log(f"phase padded-arena: kernel 1 device ms a call (profiler) on the "
        f"quantized batch arena {times['fwd', 'padded']} (C={pp.fwd.n_chunks},"
        f" walked {walked_slots(pp.fwd) // (pp.fwd.row_block * pp.fwd.chunk)}"
        f" chunks, R_arena={pp.fwd.n_arena_rows}) and on the exact-size "
        f"arena {times['fwd', 'exact']} (C={pe.fwd.n_chunks}, "
        f"R_arena={pe.fwd.n_arena_rows}): ratio {ratio['fwd']}; kernel 4 "
        f"{times['bwd', 'padded']} against {times['bwd', 'exact']} (C="
        f"{pp.bwd.n_chunks} / {pe.bwd.n_chunks}): ratio {ratio['bwd']} "
        f"[{CARD}]; real rows that differ: {n_diff}")
    if n_diff:
        problem(f"padded and exact arenas give {n_diff} different real rows "
                f"through kernels 1 and 4")
    if max(ratio.values()) > 1.5:
        log(f"phase padded-arena: padding costs more than 1.5x: {ratio}")
    return times


def jittered(graphs, seed):
    """A copy of each graph's size class with +-10 % in its node counts,
    made from ``seed`` (the generator's partitions at those sizes)."""
    import numpy as np
    from repro_torch.graphs.generator import (generate_partition,
                                              pack_graph_parallel)
    rng = np.random.default_rng(seed)
    out = []
    for g in graphs:
        n_cell = int(g.n_cell * rng.uniform(0.9, 1.1))
        n_net = int(g.n_net * rng.uniform(0.9, 1.1))
        coo, xc, xn, y = generate_partition(rng, n_cell, n_net, FEAT, FEAT)
        out.append(pack_graph_parallel(coo, n_cell, n_net, xc, xn, y))
    return out


def captured_serve_path(model, cfg, stream, cpu_model, wrappers):
    """serve-table1-captured: ``stream`` served twice (max_batch 2,
    filler to full) by one engine, then by an engine with one live
    bucket: the stream and its reverse one batch a ``run()`` (each bucket
    change evicts, each return captures again), then the stream in one
    ``run()``, where the packing pool evicts a bucket while its batch
    waits for dispatch (that batch replays or runs eagerly, and no state
    outlives the live buckets).  Every dispatched
    batch's output (a replay of its signature's graph, or the eager run
    before its capture) is held against the model's eager forward of the
    same collated batch; the wrappers count the launches that ran (eager
    runs and replays), a capture's recorded launches only as they
    replay."""
    from repro_torch.serve.circuit_engine import CircuitServeEngine
    from repro_torch.train.metrics import percentile
    total = dict.fromkeys(wrappers, 0)
    for name, max_live in (("serve-table1-captured", None),
                           ("serve-table1-captured-evict", 1)):
        eng = CircuitServeEngine(model, cfg, max_batch=2, pad_to_full=True,
                                 max_live_buckets=max_live, device="cuda")
        seen, captures = record_engine(eng, keep_outputs=True)
        zero_counts(wrappers)
        passes = []
        orders = (stream, stream[::-1]) if max_live is None \
            else (stream, stream[::-1], stream)
        for i, order in enumerate(orders):
            # one live bucket: the first two passes one batch a run()
            per_batch = max_live is not None and i < 2
            groups = {}
            for g in order:
                groups.setdefault(eng._group_key(g), []).append(g)
            batches = [gs[j:j + 2] for gs in groups.values()
                       for j in range(0, len(gs), 2)] if per_batch \
                else [order]
            order = [g for gs in batches for g in gs]
            rids, done = [], {}
            t = time.perf_counter()
            for gs in batches:
                rids += [eng.submit(g) for g in gs]
                done = eng.run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
            lat = sorted(done[r].latency_ms for r in rids)
            passes.append(dict(
                graphs_per_s=len(rids) / dt, p50_ms=percentile(lat, 0.5),
                p95_ms=percentile(lat, 0.95), compiles=eng.compiles,
                live_buckets=eng.live_buckets, evictions=eng.evictions,
                buckets_held=len(eng._buckets),
                runs=len(batches) if per_batch else 1))
            if i == 0 and max_live is None:
                hold_against_cpu(name, done, rids, order, cpu_model, cfg)
            if any(done[r].error is not None for r in rids):
                problem(f"path {name}: a request failed")
            if len(eng._buckets) > eng.live_buckets:
                problem(f"path {name}: {len(eng._buckets)} bucket states "
                        f"held for {eng.live_buckets} live buckets")
        launches = lm_counts(wrappers)
        for k, v in launches.items():
            total[k] += v
        # every replay against the eager forward of its own batch
        n_equal, worst = 0, 0.0
        replays = [s for s in seen if s[3] == "replay"]
        for _batch, _rids, entry, _kind in replays:
            entry.done.synchronize()
            out = entry.host
            with torch.inference_mode():
                ref = model(entry.view, cfg).cpu()
            n_equal += bool(bit_equal(out, ref))
            worst = max(worst, float((out - ref).abs().max()))
        sigs = [s[0].signature for s in seen]
        n_sigs = len(set(sigs))
        # a replay of a signature whose graph was captured over other
        # members: the check that no schedule is replayed stale
        shared = sum(1 for i in range(len(seen)) for j in range(i)
                     if seen[i][3] == "replay" and sigs[i] == sigs[j]
                     and set(seen[i][1]) != set(seen[j][1]))
        log(f"path {name}: passes (cold with captures, the stream "
            f"reversed{', the stream in one run' if max_live else ''}) "
            f"{json.dumps(passes)} [{CARD}]; {len(seen)} batches, "
            f"{n_sigs} signatures, {len(captures)} captures, compiles "
            f"{eng.compiles}, evictions {eng.evictions}; {shared} replays "
            f"of a signature first served with other members; replay vs "
            f"eager: {n_equal} of {len(replays)} bit-equal, max |diff| "
            f"{worst} (limit: bit-equal, since a replay runs the captured "
            f"launches on the same tables); launches={launches}; "
            f"{replay_summary(seen, captures)}")
        if (max_live is None and not replays) or n_equal != len(replays):
            problem(f"path {name}: {len(replays) - n_equal} of "
                    f"{len(replays)} replays differ from the eager forward "
                    f"(max |diff| {worst})")
        if eng.compiles != len(captures):
            problem(f"path {name}: compiles {eng.compiles} but "
                    f"{len(captures)} captures")
        if max_live is None:
            if eng.compiles != n_sigs:
                problem(f"path {name}: {eng.compiles} captures for {n_sigs} "
                        f"signatures with no eviction")
            if shared == 0:
                problem(f"path {name}: no replay of a signature first "
                        f"served with other members")
        elif eng.evictions == 0 or eng.compiles <= n_sigs:
            problem(f"path {name}: {eng.evictions} evictions and "
                    f"{eng.compiles} captures for {n_sigs} signatures: no "
                    f"re-capture after an eviction")
        check_launches(name, launches, ["drspmm_fwd_arena"],
                       ["drspmm_bwd_arena", "drspmm_fwd_bucket"])
    return total


def hold_against_cpu(name, done, rids, graphs, cpu_model, cfg):
    """Every served prediction against the port's CPU forward of its own
    graph: a share CELL_SHARE of cells within CELL_ATOL."""
    n_cells = n_far = 0
    worst = 0.0
    for rid, g in zip(rids, graphs):
        r = done[rid]
        if r.error is not None:
            problem(f"path {name}: request {rid} failed: {r.error!r}")
            continue
        if r.pred.shape != (g.n_cell,) or not torch.isfinite(
                torch.from_numpy(r.pred)).all():
            problem(f"path {name}: request {rid} output malformed")
        with torch.no_grad():
            ref = cpu_model(g, cfg).numpy()
        diff = abs(r.pred - ref)
        n_cells += diff.size
        n_far += int((diff > CELL_ATOL).sum())
        worst = max(worst, float(diff.max()))
    share = 1.0 - n_far / max(n_cells, 1)
    log(f"path {name}: {n_cells} cells, {n_far} beyond {CELL_ATOL} of the "
        f"CPU forward (share within {share}), max |diff| {worst}")
    if share < CELL_SHARE:
        problem(f"path {name}: only {share} of cells within {CELL_ATOL}")


# the reference engine's stats() keys but ``jit_cache_size``, which only a
# JAX jit cache has
STATS_KEYS = {
    "requests", "batches", "compiles", "graphs_per_s", "p50_ms", "p95_ms",
    "p99_ms", "wall_s", "cell_padding_ratio", "deadline_flushes",
    "failures", "retries", "bisects", "watchdog_timeouts",
    "nonfinite_outputs", "rejected_inputs", "admission_blocked",
    "admission_rejected", "admission_shed", "queued", "device_health",
    "quarantines", "probes", "readmissions", "devices",
    "dispatches_per_device", "live_buckets", "evictions", "live_compiles",
    "params_version"}
ONLINE_GAP_S = 0.1        # mean of the seeded exponential arrival gaps
ONLINE_LIVE = 16          # max_live_buckets of the online phase


def batch_of_one(eng, model, cfg, g, served, head):
    """The eager forward of ``g`` alone (with its filler, as the engine
    pads a lone request) on the card, under the relation tiers and plan
    chunk widths of the batch ``served`` that served it, by ``model`` with
    ``head`` (a ``(w, b)`` pair or None): ``g``'s rows, on the host."""
    from repro_torch.graphs.collate import BucketLayout, collate_graphs
    from repro_torch.serve.circuit_engine import _forward_view
    plan = served.plan
    layout = BucketLayout(
        plan_tier={sg.etype: sg.tier for sg in plan.segments},
        plan_chunk={"fwd": plan.fwd.chunk, "bwd": plan.bwd.chunk})
    batch = collate_graphs([g] * eng.b if eng.pad_to_full else [g],
                           node_bits=eng.node_bits,
                           arena_bits=eng.arena_bits, layout=layout,
                           n_real=1, with_edges=False, device="cuda")
    with torch.inference_mode():
        out = model(_forward_view(batch.graph), cfg, head=head)
    return out[:g.n_cell].cpu()


def serve_online_path(model, cfg, table1, stream, tiny, wrappers):
    """serve-online: ``serve_forever`` on its own thread over two ring
    slots on the one card (max_batch 2, max_wait_ms 50, watchdog_s 60,
    max_queue 8 with ``admission="block"``, a ``TraceRecorder``), fed by a
    producer thread, twice over: the Table-1 partitions, each with a twin
    of its size (another seed, one bucket) under one head right behind it
    (a full batch), then their jittered copies (``stream[5:]``) and the
    scale-0.02 ``tiny`` stream, one request a seeded exponential gap (mean
    ONLINE_GAP_S), the default head and two registered heads in turn, one
    ``update_params`` to a second seed's weights halfway, and one malformed
    graph submitted with a healthy partner of its bucket (one full batch).
    One seeded ``FaultInjector`` fails one dispatch, poisons one output
    with NaN, stalls one preparation and takes slot 1 down for 6 touches; a
    trickle then runs until the slot is probed back.  Checks: only the malformed request
    fails; every other prediction is bit-equal to the eager forward of its
    graph alone under the version and head ``result()`` reports; the
    ladder's counters; captures = distinct (signature, slot) pairs (heads
    and the swap add none); no bucket state past ``max_live_buckets``; the
    dumped trace; ``stats()``'s keys.  Returns the path's launches."""
    import dataclasses
    import importlib.util
    import threading
    from repro_torch.fault import FaultInjector, FaultRule
    from repro_torch.models.hgnn import DRCircuitGNN
    from repro_torch.obs import TraceRecorder
    from repro_torch.serve.circuit_engine import CircuitServeEngine
    name = "serve-online"
    model_b = DRCircuitGNN(FEAT, FEAT, HIDDEN, LAYERS, device="cuda",
                           generator=torch.Generator().manual_seed(SEED + 1))
    gen = torch.Generator().manual_seed(SEED + 2)
    heads = {h: (torch.rand((HIDDEN, 1), generator=gen) - 0.5,
                 torch.rand((1,), generator=gen) - 0.5)
             for h in ("task-a", "task-b")}
    # slot 1's loss outlasts the 3 failures that quarantine it, so the
    # batches already routed to it fail too and a probe re-admits it
    chaos = FaultInjector([
        FaultRule("dispatch", at=(3,)),
        FaultRule("nan_output", at=(5,)),
        FaultRule("straggler", at=(2,), delay_s=0.2),
        FaultRule("device_loss", at=(0,), device=1, down_for=6)],
        seed=SEED + 3)
    rec = TraceRecorder()
    eng = CircuitServeEngine(model, cfg, max_batch=2, max_wait_ms=50.0,
                             devices=["cuda", "cuda"], watchdog_s=60.0,
                             max_queue=8, admission="block",
                             max_live_buckets=ONLINE_LIVE, max_retries=3,
                             quarantine_after=3, probe_interval_s=0.5,
                             chaos=chaos, recorder=rec, device="cuda")
    for h, (w, b) in heads.items():
        eng.register_head(h, w, b)
    seen = []                       # (entry, signature) of every dispatch
    dispatch = eng._dispatch

    def rec_dispatch(prepared):
        entry = dispatch(prepared)
        seen.append((entry, (prepared.batch.signature, prepared.slot)))
        return entry
    eng._dispatch = rec_dispatch
    # each Table-1 partition and its twin (its size, another seed: one
    # bucket) under one head, the twin at once behind it (a full batch);
    # then the jittered copies and the scale-0.02 stream, a head each in
    # turn; twice, the malformed graph and its partner after the first
    # pass's jittered copies, when the other faults have fired
    import numpy as np
    from repro_torch.graphs.generator import (generate_partition,
                                              pack_graph_parallel)
    n = len(table1)
    twins = []
    for j, g in enumerate(table1):
        coo, xc, xn, y = generate_partition(
            np.random.default_rng(SEED + 50 + j), g.n_cell, g.n_net, FEAT,
            FEAT)
        twins.append(pack_graph_parallel(coo, g.n_cell, g.n_net, xc, xn, y))
    order = [None, "task-a", "task-b"]
    poison = dataclasses.replace(table1[0], x_cell=table1[0].x_cell[:-1])
    plan, burst = [], set()
    for rep in range(2):
        for j in range(n):
            h = order[(rep * n + j) % 3]
            plan += [(table1[j], h), (twins[j], h)]
            burst.add(len(plan) - 1)
        plan += [(g, order[(i + rep) % 3])
                 for i, g in enumerate(stream[n:])]
        if rep == 0:
            plan += [(poison, "task-a"), (table1[0], "task-a")]
            burst.add(len(plan) - 1)
        plan += [(g, order[(i + rep) % 3]) for i, g in enumerate(tiny)]
    half = len(plan) // 2
    gaps = np.random.default_rng(SEED + 4).exponential(ONLINE_GAP_S,
                                                       len(plan))
    submitted, swap = [], {}

    def produce():
        for i, ((g, h), gap) in enumerate(zip(plan, gaps)):
            if i == half:
                swap["version"] = eng.update_params(model_b)
            if i not in burst:
                time.sleep(float(gap))
            submitted.append((eng.submit(g, timeout=600.0, head=h), g, h,
                              g is poison))

    zero_counts(wrappers)
    server = threading.Thread(target=eng.serve_forever)
    t0 = time.perf_counter()
    server.start()
    producer = threading.Thread(target=produce)
    producer.start()
    producer.join()
    failures = {}
    for rid, _g, _h, bad in submitted:
        try:
            eng.result(rid, timeout=600.0)
        except RuntimeError as e:
            failures[rid] = (bad, e.__cause__)
    stream_s = time.perf_counter() - t0
    trickle = tiny[0]
    deadline = time.perf_counter() + 120.0
    while eng.ring.quarantined and time.perf_counter() < deadline:
        rid = eng.submit(trickle)
        submitted.append((rid, trickle, None, False))
        try:
            eng.result(rid, timeout=600.0)
        except RuntimeError as e:
            failures[rid] = (False, e.__cause__)
        time.sleep(0.05)
    eng.stop()
    server.join(timeout=600.0)
    torch.cuda.synchronize()
    launches = lm_counts(wrappers)
    if server.is_alive():
        problem(f"path {name}: serve_forever did not return after stop()")
    st = eng.stats()
    kinds = {k: sum(1 for e, _ in seen if e.kind == k)
             for k in ("first", "replay", "eager")}
    log(f"path {name}: {len(submitted)} requests ({len(plan)} in the "
        f"stream, gaps mean {ONLINE_GAP_S} s, then a trickle) in "
        f"{stream_s:.3f} s to the stream's last result [{CARD}]; "
        f"graphs/s {st['graphs_per_s']}, p50 {st['p50_ms']} ms, p95 "
        f"{st['p95_ms']} ms, p99 {st['p99_ms']} ms; captures "
        f"{kinds['first']}, replays {kinds['replay']}, eager batches "
        f"{kinds['eager']}; kernel 1 launches "
        f"{launches['drspmm_fwd_arena']}, kernel 3 launches "
        f"{launches['drelu_bisect']}; stats {json.dumps(st)}; chaos "
        f"{chaos.counts()}; launches={launches}")
    # only the malformed request fails, with its collation error
    bad = [rid for rid, (is_bad, _e) in failures.items() if not is_bad]
    if bad or len(failures) != 1:
        problem(f"path {name}: failed requests {failures} (only the "
                f"malformed one may fail)")
    elif not isinstance(next(iter(failures.values()))[1], ValueError):
        problem(f"path {name}: the malformed request failed with "
                f"{failures}, not its collation error")
    for key, want in (("failures", 1),):
        if st[key] != want:
            problem(f"path {name}: {key} {st[key]}, expected {want}")
    for key in ("retries", "bisects", "quarantines", "probes",
                "readmissions", "nonfinite_outputs", "deadline_flushes"):
        if st[key] < 1:
            problem(f"path {name}: {key} {st[key]}, expected >= 1")
    counts = chaos.counts()
    for point in ("dispatch", "nan_output", "straggler", "device_loss"):
        if not counts.get(point):
            problem(f"path {name}: fault {point} never fired ({counts})")
    if set(st) != STATS_KEYS:
        problem(f"path {name}: stats() keys differ from the reference's: "
                f"{sorted(set(st) ^ STATS_KEYS)}")
    if st["params_version"] != 1 or swap.get("version") != 1:
        problem(f"path {name}: params_version {st['params_version']}")
    # captures: one a (signature, slot); heads and the swap add none
    pairs = {sig for _e, sig in seen}
    captured = [sig for e, sig in seen if e.kind == "first"]
    if eng.compiles != len(captured) or len(captured) != len(pairs) \
            or len(set(captured)) != len(captured):
        problem(f"path {name}: {eng.compiles} compiles, {len(captured)} "
                f"captures for {len(pairs)} (signature, slot) pairs")
    first_of = {}
    for e, sig in seen:
        first_of.setdefault(sig, e)
    shared = [(e, first_of[sig]) for e, sig in seen if e.kind == "replay"]
    other_head = sum(1 for e, f in shared if e.reqs[0].head != f.reqs[0].head)
    other_version = sum(1 for e, f in shared if e.version != f.version)
    log(f"path {name}: {len(pairs)} (signature, slot) pairs, "
        f"{other_head} replays under another head than their capture's, "
        f"{other_version} under other weights; {len(eng._buckets)} bucket "
        f"states, {eng.live_buckets} live (max {ONLINE_LIVE})")
    if not other_head:
        problem(f"path {name}: no replay served another head than its "
                f"capture's batch")
    if len(eng._buckets) > ONLINE_LIVE or eng.live_buckets > ONLINE_LIVE:
        problem(f"path {name}: {len(eng._buckets)} bucket states for "
                f"max_live_buckets {ONLINE_LIVE}")
    # every prediction against the eager forward of its graph alone
    served = {}
    for e, _sig in seen:
        for r in e.reqs:
            served[r.rid] = e.batch
    models = {0: model, 1: model_b}
    n_eq = n_cmp = 0
    worst = 0.0
    for rid, g, h, is_bad in submitted:
        if is_bad:
            continue
        r = eng.finished.get(rid)
        if r is None or r.error is not None or r.pred is None:
            continue
        m = models[r.params_version]
        head = None if r.head is None else tuple(
            t.cuda() for t in heads[r.head])
        ref = batch_of_one(eng, m, cfg, g, served[rid], head).numpy()
        n_cmp += 1
        same = r.pred.shape == ref.shape and np.array_equal(
            r.pred.view(np.int32), ref.view(np.int32))
        n_eq += same
        if r.pred.shape == ref.shape:
            worst = max(worst, float(np.abs(r.pred - ref).max()))
    log(f"path {name}: {n_eq} of {n_cmp} predictions bit-equal to their "
        f"graph's eager forward alone (max |diff| {worst})")
    if n_eq != n_cmp or n_cmp < len(plan) - 1:
        problem(f"path {name}: {n_cmp - n_eq} of {n_cmp} predictions differ "
                f"from their graph's eager forward (max |diff| {worst})")
    # the trace: valid JSON with the expected tracks
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "serve_online_trace.json")
    eng.dump_trace(path)
    with open(path) as f:
        doc = json.load(f)
    spec = importlib.util.spec_from_file_location(
        "check_trace", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tools", "check_trace.py"))
    ct = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ct)
    bad_trace = ct.check_trace(doc, expect_device_tracks=2, expect_events=(
        "inject:dispatch", "retry", "bisect", "batch", "collate",
        "device_put", "deadline_flush", "submit"))
    tracks = {e["args"]["name"] for e in doc["traceEvents"]
              if e.get("ph") == "M" and e["name"] == "thread_name"}
    for want in ("worker/", "device/", "intake", "healing", "chaos"):
        if not any(t == want or t.startswith(want) for t in tracks):
            bad_trace.append(f"no {want} track")
    log(f"path {name}: trace {len(doc['traceEvents'])} events, tracks "
        f"{sorted(tracks)}, problems {bad_trace}")
    if bad_trace:
        problem(f"path {name}: trace: {bad_trace}")
    check_launches(name, launches, ["drspmm_fwd_arena", "drelu_bisect",
                                    "drspmm_dense_tier_fwd"],
                   ["drspmm_bwd_arena", "drspmm_fwd_bucket"])
    return launches


def learnable_collated_path(graphs, wrappers):
    """learnable-collated: ``collate_graphs(with_eids=True)`` over two
    partitions and ``drspmm_learnable`` over its quantized ``near``
    edge-id arenas with the members' weights concatenated
    (``concat_edge_weights``), at k = 16 and k = 64 (the narrow and the
    wide walks): kernels 7, 8 and 9 against their plain versions on the
    batch's tables, and the output and both gradients against each
    member's own product."""
    from repro_torch.graphs.collate import collate_graphs
    from repro_torch.graphs.ell import ell_to_coo, pack_fused_eid_pair
    from repro_torch.kernels import drspmm as K1
    from repro_torch.kernels import ops
    batch = collate_graphs(graphs[:2], with_eids=True, device="cuda")
    es, nnz = batch.graph.edges["near"], batch.edge_nnz["near"]
    g = torch.Generator().manual_seed(SEED + 5)
    coo = [ell_to_coo(m.edges["near"].adj) for m in graphs[:2]]
    member_ws = [(torch.rand(c[0].shape[0], generator=g) + 0.1).cuda()
                 for c in coo]
    w_cat = batch.concat_edge_weights("near", member_ws)
    n = batch.graph.n_cell
    tol = lambda ref: 1e-5 * max(1.0, float(ref.abs().max()))
    total = dict.fromkeys(wrappers, 0)
    for k in (K, HIDDEN):
        x = torch.randn((n, HIDDEN), generator=g).cuda()
        xi = torch.sort(torch.topk(x, k, dim=1).indices, dim=1).values \
            .to(torch.int32).contiguous()
        xv = torch.gather(x, 1, xi.long()).contiguous()
        gy = torch.randn((n, HIDDEN), generator=g).cuda()
        zero_counts(wrappers)
        w = w_cat.clone().requires_grad_(True)
        v = xv.clone().requires_grad_(True)
        y = ops.drspmm_learnable(es.adj, es.adj_t, nnz, w, v, xi, HIDDEN)
        y.backward(gy)
        torch.cuda.synchronize()
        launches = lm_counts(wrappers)
        for key, val in launches.items():
            total[key] += val
        errs = {}
        for kname, kern, plain in (
                ("drspmm_fwd_learnable",
                 lambda: K1.drspmm_fwd_learnable(es.adj, nnz, w_cat, xv, xi,
                                                 HIDDEN),
                 lambda: K1.drspmm_fwd_learnable_plain(es.adj, nnz, w_cat,
                                                       xv, xi, HIDDEN)),
                ("drspmm_bwd_learnable",
                 lambda: K1.drspmm_bwd_learnable(es.adj_t, nnz, w_cat, gy,
                                                 xi),
                 lambda: K1.drspmm_bwd_learnable_plain(es.adj_t, nnz, w_cat,
                                                       gy, xi)),
                ("drspmm_dw_learnable",
                 lambda: K1.drspmm_dw_learnable(es.adj, nnz, gy, xv, xi),
                 lambda: K1.drspmm_dw_learnable_plain(es.adj, nnz, gy, xv,
                                                      xi))):
            a, ref = kern(), plain()
            errs[kname] = float((a - ref).abs().max())
            if not torch.allclose(a, ref, rtol=1e-5, atol=tol(ref)):
                problem(f"learnable-collated: {kname} at k {k} disagrees "
                        f"with its plain version: {errs[kname]}")
        m_err = 0.0
        for i, (m, (dst, src, _w), mw) in enumerate(
                zip(batch.members, coo, member_ws)):
            f, ft, _order, m_nnz = pack_fused_eid_pair(dst, src, m.n_cell,
                                                       m.n_cell)
            rows = slice(m.cell_off, m.cell_off + m.n_cell)
            off = batch.edge_eid_offsets["near"][i]
            wm = mw.clone().requires_grad_(True)
            vm = xv[rows].clone().requires_grad_(True)
            ym = ops.drspmm_learnable(f, ft, m_nnz, wm, vm,
                                      xi[rows].contiguous(), HIDDEN)
            ym.backward(gy[rows])
            for a, ref in ((y[rows], ym), (w.grad[off:off + m_nnz], wm.grad),
                           (v.grad[rows], vm.grad)):
                m_err = max(m_err, float((a - ref).abs().max()))
                if not torch.allclose(a, ref, rtol=1e-5, atol=tol(ref)):
                    problem(f"learnable-collated: the batch at k {k} "
                            f"disagrees with member {m} on its own edges")
        log(f"path learnable-collated: k={k} arenas fwd "
            f"{tuple(es.adj.nbr.shape)} bwd {tuple(es.adj_t.nbr.shape)}, "
            f"nnz {nnz} (exact "
            f"{batch.edge_nnz_exact['near']}); kernel vs plain max |diff| "
            f"{errs}; batch vs members max |diff| {m_err}; "
            f"launches={launches}")
        check_launches("learnable-collated", launches,
                       ["drspmm_fwd_learnable", "drspmm_bwd_learnable",
                        "drspmm_dw_learnable"])
    return total


def auto_k_path(graphs, state, wrappers):
    """train-auto-k: ``CircuitTrainConfig(auto_k=True)`` on the card for
    one epoch of batches of two; the K it trains with equals a CPU
    trainer's ``profile_k`` on the same graphs."""
    from repro_torch.models.hgnn import DRCircuitGNN
    from repro_torch.train.circuit_trainer import (CircuitTrainConfig,
                                                   CircuitTrainer)
    cfg = CircuitTrainConfig(hidden=HIDDEN, n_layers=LAYERS, epochs=1,
                             batch_size=2, auto_k=True)
    m = DRCircuitGNN(FEAT, FEAT, HIDDEN, LAYERS, device="cuda")
    m.load_state_dict(state)
    gpu = CircuitTrainer(cfg, FEAT, FEAT, model=m, device="cuda")
    zero_counts(wrappers)
    t = time.perf_counter()
    hist = gpu.fit(graphs)["history"]
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    launches = lm_counts(wrappers)
    cpu = CircuitTrainer(CircuitTrainConfig(hidden=HIDDEN, n_layers=LAYERS),
                         FEAT, FEAT, device="cpu")
    ks = cpu.profile_k(graphs)
    got = {"cell": gpu.mp_cfg.k_cell, "net": gpu.mp_cfg.k_net}
    log(f"path train-auto-k: K on the card {got}, CPU profile_k {ks}; fit "
        f"{fit_s:.3f} s, losses {gpu.step_loss}, launches={launches}")
    if got != ks:
        problem(f"train-auto-k: K {got} on the card, {ks} by the CPU")
    if not all(math.isfinite(h["loss"]) for h in hist):
        problem(f"train-auto-k: non-finite loss {hist}")
    if max(ks.values()) < HIDDEN:
        check_launches("train-auto-k", launches,
                       ["drspmm_fwd_arena", "drspmm_bwd_arena"])
    return launches


SHARD_RTOL = 2e-5          # sharded step loss vs the card's unsharded one
DP_RTOL = 1e-5             # data-parallel step vs the batched step
LARGE_TIMES = 8            # sharded-forward-large: x the large design's
LARGE_SHARDS = 4           # Table-1 node counts, over this many shards


def shard_log(name, graphs, n):
    """Each shard's device, H, halo and owned rows, and table bytes beside
    the unsharded plan's, for every graph's ``n``-way sharded plan."""
    from repro_torch.graphs.circuit import sharded_plan_of
    from repro_torch.sharding.specs import shard_devices
    devs = [str(d) for d in shard_devices(n, "cuda")]
    for i, g in enumerate(graphs):
        st = sharded_plan_of(g, n).halo_stats()
        sh = st["shards"]
        log(f"path {name}: partition {i}: shards on {devs}, H "
            f"{st['halo_pad']}, halo rows {[s['halo_rows'] for s in sh]}, "
            f"owned rows {[s['owned_rows'] for s in sh]}, shard bytes "
            f"{[s['arena_bytes'] for s in sh]} against full_arena_bytes "
            f"{st['full_arena_bytes']}")


def queued_ms(fn, reps=REPS, cycles=20_000_000):
    """Device ms of one ``fn()`` call: ``reps`` calls, each between two
    CUDA events, queued behind a ``torch.cuda._sleep`` so that the host
    has issued all of them before the first runs (back-to-back events,
    ``cuda_ms``, read the host's launch rate on short kernels).  Where the
    first event had already run when the host finished issuing, the sleep
    was too short: it is doubled and the calls queued again."""
    fn()
    while True:
        evs = [(torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        for a, b in evs:
            a.record()
            fn()
            b.record()
        ahead = not evs[0][0].query()
        torch.cuda.synchronize()
        if ahead or cycles >= 2 ** 31:
            return sum(a.elapsed_time(b) for a, b in evs) / reps
        cycles *= 2


def dp_path(graphs, state, wrappers):
    """train-table1-dp: ``train_epoch(batch_size=4, devices=[cuda:0,
    cuda:0])`` for two epochs (a two-slot data-parallel step, then the
    fifth partition's batch of one) against a card trainer's batched
    epochs from the same weights: every step's loss and the final
    parameters within DP_RTOL; then the data-parallel step and the
    batched step on the first four partitions, timed in turns."""
    from repro_torch.models.hgnn import DRCircuitGNN
    from repro_torch.train.circuit_trainer import (CircuitTrainConfig,
                                                   CircuitTrainer)
    cfg = CircuitTrainConfig(hidden=HIDDEN, n_layers=LAYERS, k_cell=K,
                             k_net=K)
    slots = [torch.device("cuda", 0)] * 2
    trainers = []
    for _ in range(2):
        m = DRCircuitGNN(FEAT, FEAT, HIDDEN, LAYERS, device="cuda")
        m.load_state_dict(state)
        trainers.append(CircuitTrainer(cfg, FEAT, FEAT, model=m,
                                       device="cuda"))
    dp, one = trainers
    zero_counts(wrappers)
    for _ in range(2):
        dp.train_epoch(graphs, batch_size=4, devices=slots)
    torch.cuda.synchronize()
    launches = lm_counts(wrappers)
    for _ in range(2):
        one.train_epoch(graphs, batch_size=4)
    diffs = [abs(a - b) / abs(b) for a, b in zip(dp.step_loss,
                                                   one.step_loss)]
    if len(diffs) != 4 or not all(d <= DP_RTOL for d in diffs):
        problem(f"train-table1-dp: step losses {dp.step_loss}, batched "
                f"{one.step_loss}")
    p_err = {n: rel_l2(p.detach(), q.detach()) for (n, p), q in
             zip(dp.model.named_parameters(), one.model.parameters())}
    worst = max(p_err, key=p_err.get)
    if not p_err[worst] <= DP_RTOL:
        problem(f"train-table1-dp: parameter {worst} differs from the "
                f"batched trainer's by {p_err[worst]} (relative L2)")
    per_epoch = [min(len(slots), len(c)) if len(c) > 1 else 1
                 for c in (graphs[i:i + 4] for i in range(0, len(graphs), 4))]
    want = 2 * LAYERS * sum(per_epoch)
    for k in ("drspmm_fwd_arena", "drspmm_bwd_arena"):
        if launches[k] != want:
            problem(f"train-table1-dp: {launches[k]} launches of {k}, "
                    f"expected {want}")
    check_launches("train-table1-dp", launches, [],
                   [k for k in wrappers if k not in ("drspmm_fwd_arena",
                                                     "drspmm_bwd_arena")])
    step_ms = {"dp": [], "batched": []}
    for tr, what in ((dp, "dp"), (one, "batched"), (one, "batched"),
                     (dp, "dp")):
        kw = {"devices": slots} if what == "dp" else {}
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.train_epoch(graphs[:4], batch_size=4, **kw)
        torch.cuda.synchronize()
        step_ms[what].append((time.perf_counter() - t) * 1e3)
    log(f"path train-table1-dp: step losses {dp.step_loss[:4]}, relative "
        f"difference to the batched trainer {diffs}, worst parameter "
        f"{p_err[worst]} ({worst}); replicas {len(dp._replicas)}; "
        f"launches={launches}; host ms a step on partitions 0-3 (4 "
        f"members, caches warm), in turns dp / batched / batched / dp: "
        f"{step_ms} [{CARD}]")
    return launches


def sharded_forward_large(state, wrappers):
    """sharded-forward-large: one partition made by ``generate_partition``
    at LARGE_TIMES x the large design's Table-1 node counts (the upper
    ends), the model's forward with ``n_shards=LARGE_SHARDS`` against the
    unsharded forward on the card (within SHARD_RTOL: a shard keeps each
    row's slot order, so the sums agree); then, at the first layer's
    operands, each shard's kernel 1 and kernel 4 launch and the unsharded
    plan's, each held against its plain version on the same local arena
    and timed (events), the exchange's host time and each shard's bytes.
    Kernel 1 must run LARGE_SHARDS x LAYERS times in the forward, and
    nothing else."""
    import dataclasses
    import numpy as np
    from repro_torch.core.hetero_mp import HeteroMPConfig
    from repro_torch.graphs.circuit import relation_plan_of, sharded_plan_of
    from repro_torch.graphs.generator import (TABLE1, generate_partition,
                                              pack_graph_parallel)
    from repro_torch.kernels import ops
    from repro_torch.kernels.drspmm import (drspmm_bwd_arena,
                                            drspmm_bwd_arena_plain,
                                            drspmm_fwd_arena,
                                            drspmm_fwd_arena_plain)
    from repro_torch.models.hgnn import DRCircuitGNN
    n = LARGE_SHARDS
    n_cell = LARGE_TIMES * TABLE1["large"]["n_cell"][1]
    n_net = LARGE_TIMES * TABLE1["large"]["n_net"][1]
    t = time.perf_counter()
    coo, xc, xn, y = generate_partition(np.random.default_rng(SEED + 34),
                                        n_cell, n_net)
    g = pack_graph_parallel(coo, n_cell, n_net, xc, xn, y)
    gen_s = time.perf_counter() - t
    t = time.perf_counter()
    plan = relation_plan_of(g)
    plan_s = time.perf_counter() - t
    t = time.perf_counter()
    splan = sharded_plan_of(g, n)
    shard_s = time.perf_counter() - t
    gu = dataclasses.replace(g, plan=plan).to("cuda")
    gs = dataclasses.replace(g, plan=splan).to("cuda")
    placed = gs.plan
    st = splan.halo_stats()
    log(f"path sharded-forward-large: {n_cell} cells, {n_net} nets, "
        f"{sum(len(d) for d, _ in coo.values())} edges; tiers "
        f"{[(s.etype, s.tier) for s in plan.segments]}; made in "
        f"{gen_s:.1f} s, plan {plan_s:.1f} s, {n} shards {shard_s:.1f} s "
        f"(host); shards on {[str(d) for d in placed.devices]}, S "
        f"{splan.src_slab}, T {splan.out_slab}, H {splan.halo_pad}, halo "
        f"rows {[x['halo_rows'] for x in st['shards']]}, owned rows "
        f"{[x['owned_rows'] for x in st['shards']]}, shard bytes "
        f"{[x['arena_bytes'] for x in st['shards']]} against "
        f"full_arena_bytes {st['full_arena_bytes']}")
    model = DRCircuitGNN(FEAT, FEAT, HIDDEN, LAYERS, device="cuda")
    model.load_state_dict(state)
    cfg = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K, n_shards=n)
    with torch.inference_mode():
        ref = model(gu, dataclasses.replace(cfg, n_shards=0))
        zero_counts(wrappers)
        out = model(gs, cfg)
        torch.cuda.synchronize()
        launches = lm_counts(wrappers)
    if launches["drspmm_fwd_arena"] != n * LAYERS:
        problem(f"sharded-forward-large: {launches['drspmm_fwd_arena']} "
                f"launches of kernel 1, expected {n * LAYERS}")
    check_launches("sharded-forward-large", launches, ["drspmm_fwd_arena"],
                   [k for k in wrappers if k != "drspmm_fwd_arena"])
    diff = (out - ref).abs()
    share = float((diff <= CELL_ATOL).float().mean())
    if not (torch.isfinite(out).all() and out.shape == (n_cell,)
            and torch.allclose(out, ref, rtol=SHARD_RTOL, atol=SHARD_RTOL
                               * max(1.0, float(ref.abs().max())))):
        problem(f"sharded-forward-large: {share} of the cells within "
                f"{CELL_ATOL} of the unsharded forward (max "
                f"{float(diff.max())})")

    # the first layer's kernel launches, shard by shard and unsharded
    xv, xi, _ = first_layer_operands(model, gu, cfg)
    gy = torch.randn((plan.n_out_total, HIDDEN),
                     generator=torch.Generator().manual_seed(SEED)).cuda()
    with torch.inference_mode():
        sv, si = ops._shard_slabs(placed, xv), ops._shard_slabs(placed, xi)
        gy_pad = ops._pad_rows(gy, n * placed.out_slab)
        gys = [gy_pad[d * placed.out_slab:(d + 1) * placed.out_slab]
               .contiguous() for d in range(n)]
        fwds = [lambda: drspmm_fwd_arena(gu.plan.fwd, xv, xi, HIDDEN)] + [
            lambda d=d: drspmm_fwd_arena(placed.fwd[d], sv[d], si[d],
                                         HIDDEN) for d in range(n)]
        bwds = [lambda: drspmm_bwd_arena(gu.plan.bwd, gu.plan.bwd_src_rows,
                                         gy, xi)] + [
            lambda d=d: drspmm_bwd_arena(placed.bwd[d], placed.bwd[d].rows,
                                         gys[d], si[d]) for d in range(n)]
        plain = [lambda: drspmm_fwd_arena_plain(gu.plan.fwd, xv, xi,
                                                HIDDEN)] + [
            lambda d=d: drspmm_fwd_arena_plain(placed.fwd[d], sv[d], si[d],
                                               HIDDEN) for d in range(n)]
        plain_t = [lambda: drspmm_bwd_arena_plain(
            gu.plan.bwd, gu.plan.bwd_src_rows, gy, xi)] + [
            lambda d=d: drspmm_bwd_arena_plain(placed.bwd[d],
                                               placed.bwd[d].rows, gys[d],
                                               si[d]) for d in range(n)]
        errs = []
        for what, ks, ps in (("kernel 1", fwds, plain),
                             ("kernel 4", bwds, plain_t)):
            for i, (kf, pf) in enumerate(zip(ks, ps)):
                y, want = kf(), pf()
                errs.append(float((y - want).abs().max()))
                if not torch.allclose(y, want, rtol=1e-5, atol=1e-5 * max(
                        1.0, float(want.abs().max()))):
                    problem(f"sharded-forward-large: {what} "
                            f"{'unsharded' if i == 0 else f'shard {i - 1}'} "
                            f"disagrees with its plain version: max "
                            f"|diff| {errs[-1]}")
        ev_fwd = [queued_ms(f) for f in fwds]
        ev_bwd = [queued_ms(f) for f in bwds]
        ex_ms = []
        for _ in range(6):
            torch.cuda.synchronize()
            t = time.perf_counter()
            ops._shard_slabs(placed, xv)
            ops._shard_slabs(placed, xi)
            torch.cuda.synchronize()
            ex_ms.append((time.perf_counter() - t) * 1e3)
        fwd_wall = cuda_ms(lambda: model(gs, cfg), 5)
        fwd_wall_u = cuda_ms(lambda: model(gu, dataclasses.replace(
            cfg, n_shards=0)), 5)
    log(f"path sharded-forward-large: {share} of the cells within "
        f"{CELL_ATOL} of the unsharded forward, max |diff| "
        f"{float(diff.max())}; launches={launches}; max |diff| against "
        f"the plain versions (unsharded, then per shard) kernel 1 "
        f"{errs[:n + 1]}, kernel 4 {errs[n + 1:]}; events ms a launch "
        f"queued behind a sleep (unsharded, then per shard) kernel 1 "
        f"{ev_fwd}, kernel 4 {ev_bwd}; exchange (both operands, host ms "
        f"after the first) {ex_ms[1:]}; forward ms (events) sharded "
        f"{fwd_wall}, unsharded "
        f"{fwd_wall_u} [{CARD}]")
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
    # pinned copies: fused and quantized as served, fused at exact sizes,
    # and the exact bucketed packing without arenas or plan) against the
    # device forward of the same batch, quantized and exact
    host_ms = {}
    for what, kw in (("fused-quantized", {}), ("fused-exact",
                                               {"quantize": False}),
                     ("bucketed-exact", {"fused": False,
                                         "quantize": False})):
        t = time.perf_counter()
        collate_graphs(table1[:2], device="cuda", **kw)
        torch.cuda.synchronize()
        host_ms[what] = (time.perf_counter() - t) * 1e3
    exact = collate_graphs(table1[:2], quantize=False, device="cuda")
    with torch.inference_mode():
        fwd_ms = {f"{c.drelu_backend}-{w}": cuda_ms(lambda: model(b.graph, c),
                                                    5)
                  for c in (topk, bisect)
                  for w, b in (("quantized", big), ("exact", exact))}
    log(f"phase breakdown: collate 2 Table-1 partitions on the host "
        f"{host_ms} ms; batch forward on the card {fwd_ms} ms [{CARD}]")

    # kernels 1 and 4 on the quantized arenas against the exact-size ones
    t = time.perf_counter()
    padded_vs_exact(model, topk, exact, big)
    del exact
    log(f"phase padded-arena: {time.perf_counter() - t:.1f} s")

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

    # captured serving: Table-1 partitions and jittered copies
    t = time.perf_counter()
    stream = table1 + jittered(table1, SEED + 9)
    log(f"phase jitter: {[(g.n_cell, g.n_net) for g in stream[5:]]} in "
        f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    launches = captured_serve_path(model, topk, stream, cpu_model, wrappers)
    for k, v in launches.items():
        total[k] += v
    log(f"phase serve-table1-captured: {time.perf_counter() - t:.1f} s")

    # online serving: serve_forever, the ladder, heads and a hot swap
    t = time.perf_counter()
    launches = serve_online_path(model, bisect, table1, stream, tiny,
                                 wrappers)
    for k, v in launches.items():
        total[k] += v
    log(f"phase serve-online: {time.perf_counter() - t:.1f} s")

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
             serial_counts),
            # batches of two: their fused arenas run kernels 1 and 4 under
            # either setting, one launch per relation (nnz -1: no dense
            # tier), no per-bucket kernel
            ("train-table1-bucket-batched",
             CircuitTrainConfig(**dict(serial, batch_size=2),
                                backend="bucket"), table1,
             ["drspmm_fwd_arena", "drspmm_bwd_arena"],
             fused_only[1:2] + fused_only[3:] + bucket_kernels
             + learnable_kernels, serial_counts),
            ("train-table1-serial-batched",
             CircuitTrainConfig(**dict(serial, batch_size=2),
                                use_plan=False), table1,
             ["drspmm_fwd_arena", "drspmm_bwd_arena"],
             fused_only[1:2] + fused_only[3:] + bucket_kernels
             + learnable_kernels, serial_counts)):
        t = time.perf_counter()
        launches = lockstep_path(name, cfg, graphs, state, wrappers, expect,
                                 forbid, count_of)
        for k, v in launches.items():
            total[k] += v
        log(f"phase {name}: {time.perf_counter() - t:.1f} s")

    # the plan sharded over 2 and 4 shards (all on the one card): single
    # graphs in lockstep with a CPU trainer of the same shards and with
    # the card's unsharded trainer; kernels 1 and 4 once per shard and
    # layer, no dense tier
    for n in (2, 4):
        name = f"train-table1-sharded-{n}"
        t = time.perf_counter()
        launches = lockstep_path(
            name, CircuitTrainConfig(**serial, n_shards=n), table1, state,
            wrappers, ["drspmm_fwd_arena", "drspmm_bwd_arena"],
            fused_only[1:2] + fused_only[3:] + bucket_kernels
            + learnable_kernels,
            lambda g, n=n: {"drspmm_fwd_arena": n * LAYERS,
                            "drspmm_bwd_arena": n * LAYERS},
            twin=(CircuitTrainConfig(**serial), SHARD_RTOL))
        shard_log(name, table1, n)
        for k, v in launches.items():
            total[k] += v
        log(f"phase {name}: {time.perf_counter() - t:.1f} s")
    for name, run in (
            ("train-table1-dp", lambda: dp_path(table1, state, wrappers)),
            ("sharded-forward-large",
             lambda: sharded_forward_large(state, wrappers))):
        t = time.perf_counter()
        launches = run()
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

    for name, run in (
            ("learnable-collated",
             lambda: learnable_collated_path(table1, wrappers)),
            ("train-auto-k", lambda: auto_k_path(table1, state, wrappers))):
        t = time.perf_counter()
        launches = run()
        for k, v in launches.items():
            total[k] += v
        log(f"phase {name}: {time.perf_counter() - t:.1f} s")

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
    log(f"phase kernel-flash: {LM_ARCH} ({sum(p.numel() for p in lm.parameters())}"
        f" parameters, fp32 on the card) in {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    wrappers["flash_attention_bwd"] = FA.flash_attention_bwd
    total["flash_attention_bwd"] = 0
    rows["flash_attention_bwd"] = check_flash_bwd_kernel(q, k, v, wrappers)
    del q, k, v
    log(f"phase flash-bwd: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    flash_cross_times()
    log(f"phase flash-cross: {time.perf_counter() - t:.1f} s")
    for name, run in (
            (f"serve-lm-{LM_ARCH}", lambda: serve_lm_path(lm, tokens, wrappers)),
            ("serve-lm-fp32-depth2", lambda: serve_lm_fp32_path(wrappers)),
            ("serve-lm-engine", lambda: serve_lm_engine_path(lm, wrappers))):
        t = time.perf_counter()
        launches = run()
        for k, v in launches.items():
            total[k] += v
        log(f"phase {name}: {time.perf_counter() - t:.1f} s")
    del lm
    torch.cuda.empty_cache()
    # training the dense LM: kernel 13 and its backward 13b
    ckpt_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "chip_smoke_lm_ckpt")
    for name, run in (
            ("train-lm-fp32-depth2", lambda: train_lm_fp32_path(wrappers)),
            (f"train-lm-{LM_ARCH}", lambda: train_lm_path(wrappers,
                                                          ckpt_dir))):
        t = time.perf_counter()
        launches = run()
        for k, v in launches.items():
            total[k] += v
        log(f"phase {name}: {time.perf_counter() - t:.1f} s")

    # the MoE and SSM families: granite at full depth, moonshot at 8 of its
    # 48 layers (its fp32 weights would not fit at full depth), mamba2
    moe_a, moe_b, ssm = ("granite-moe-1b-a400m", "moonshot-v1-16b-a3b",
                         "mamba2-1.3b")
    for name, run in (
            (f"serve-lm-{moe_a}",
             lambda: serve_lm_moe_path(f"serve-lm-{moe_a}", moe_a, None,
                                       wrappers)),
            (f"serve-lm-{moe_b}-depth8",
             lambda: serve_lm_moe_path(f"serve-lm-{moe_b}-depth8", moe_b, 8,
                                       wrappers)),
            (f"serve-lm-{ssm}", lambda: serve_lm_ssm_path(wrappers)),
            ("lm-families-fp32-depth2",
             lambda: lm_fp32_path("lm-families-fp32-depth2", FP32_FAMILIES,
                                  wrappers)),
            (f"train-lm-{moe_a}", lambda: train_lm_family_path(moe_a,
                                                               wrappers)),
            (f"train-lm-{ssm}", lambda: train_lm_family_path(ssm,
                                                             wrappers))):
        t = time.perf_counter()
        launches = run()
        for k, v in launches.items():
            total[k] += v
        log(f"phase {name}: {time.perf_counter() - t:.1f} s")

    # the hybrid (zamba2), audio (whisper) and VLM (llama-3.2-vision at 5
    # of its 100 layers: its fp32 weights would take 351 GB at full depth)
    hyb, aud, vlm = ("zamba2-1.2b", "whisper-large-v3",
                     "llama-3.2-vision-90b")
    for name, run in (
            (f"serve-lm-{hyb}",
             lambda: serve_lm_family_path(f"serve-lm-{hyb}", hyb, wrappers)),
            (f"serve-lm-{aud}",
             lambda: serve_lm_family_path(f"serve-lm-{aud}", aud, wrappers)),
            (f"serve-lm-{vlm}-depth{VLM_DEPTH}",
             lambda: serve_lm_family_path(f"serve-lm-{vlm}-depth{VLM_DEPTH}",
                                          vlm, wrappers, VLM_DEPTH)),
            ("lm-hybrid-cross-fp32",
             lambda: lm_fp32_path("lm-hybrid-cross-fp32", FP32_CROSS,
                                  wrappers)),
            (f"train-lm-{hyb}", lambda: train_lm_family_path(hyb, wrappers)),
            (f"train-lm-{aud}",
             lambda: train_lm_family_path(aud, wrappers, WHISPER_CTX,
                                          SEED + 30))):
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
