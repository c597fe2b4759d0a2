"""PyTorch port on a card: each CUDA kernel against its plain PyTorch
version, the serve engine on the card against the port's CPU forward, one
training step on the card against the same step on the CPU (the D-ReLU
trainer, the dense-SpMM trainer, the serial per-bucket trainer and the
homogeneous baselines), the concurrent relation modules against the
sequential ones, the flash-attention kernel (fp32 and bf16, k/v at
KV <= H heads, up to S 4,096) and the reduced dense LM (prefill, decode,
``ServeEngine``) and the reduced MoE, SSM, hybrid, VLM and audio LMs
(prefill, decode, a train step) on the card against the CPU, kernel 13b
(the flash backward) against its plain version, kernels 13 / 13b at a
non-causal cross-attention shape (Sq 448, Sk 1,500), bit-equal across two bf16 launches
and refusing a misaligned view, the forward's log-sum-exp, autograd
through ``chunked_attention`` and two LM training steps against the CPU,
and the engine's captured
CUDA graphs (each replay bit for bit the eager forward of its batch, two
contents of one signature, re-capture after an eviction), padded arenas
through kernels 1 and 4, and batched steps under ``backend="bucket"`` /
``use_plan=False``.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so it also runs on a machine with the card
and no JAX:  ``PYTHONPATH=src python -m pytest -q -m cuda tests/``.
Tolerances: the DR-SpMM kernels are fp32 with another summation order than
their plain versions (rtol 1e-5, atol 1e-5 scaled by magnitude); the
bisection is bit-exact; served predictions may differ from the CPU forward
where a GPU-vs-CPU rounding flips a near-tied top-k pick, so 99.9 % of
cells must be within 1e-4; a training step's loss and parameters must be
within 1e-4 relative (L2 for the parameters) of the CPU step; the
flash-attention kernel in fp32 as the DR-SpMM kernels and in bf16 within
one bf16 ulp of each element of its plain version (each rounds one fp32
result), plus the fp32 slack."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import parallel
from repro_torch.core.hetero_mp import HeteroMPConfig
from repro_torch.graphs.circuit import (EDGE_SCHEMA, EDGE_TYPES,
                                        relation_plan_of)
from repro_torch.graphs.ell import (ELLBucket, build_relation_plan,
                                    ell_to_coo, fuse_bucketed,
                                    pack_ell, pack_fused_eid_pair)
from repro_torch.graphs import collate as tcollate
from repro_torch.graphs.generator import (generate_design,
                                          generate_partition,
                                          pack_graph_parallel)
from repro_torch.kernels import drelu_topk, flash_attention
from repro_torch.kernels import drspmm as tk
from repro_torch.kernels import ops as tops
from repro_torch.models.hgnn import (HOMO_KINDS, DRCircuitGNN, HomoGNN,
                                     homo_forward, homogenize)
from repro_torch.data.pipeline import DataConfig, TokenPipeline
from repro_torch.models.lm import attention as lm_attention
from repro_torch.models.lm import serve as lm_serve
from repro_torch.models.lm.model import build_lm, draw_zero_inits
from repro_torch.optim.adamw import adamw_init, tree_leaves
from repro_torch.train import lm_step
from repro_torch.serve.circuit_engine import CircuitServeEngine
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.circuit_trainer import (CircuitTrainConfig,
                                               CircuitTrainer)
from _torch_port import (HIDDEN, K, LAYERS, SCALE, assert_bf16_close,
                         assert_close, cbsr_operands,
                         cuda, drelu_rows, lm_extras,  # noqa: F401  (fixture)
                         padded_and_exact_rows)

pytestmark = pytest.mark.cuda


def _operands(plan, k, seed, device, dim=64):
    ops_np = cbsr_operands(plan, {"cell": k, "net": k}, seed=seed, dim=dim)
    xv = np.concatenate([ops_np[t][0] for t in plan.src_types])
    xi = np.concatenate([ops_np[t][1] for t in plan.src_types])
    return torch.from_numpy(xv).to(device), torch.from_numpy(xi).to(device)


@pytest.mark.parametrize("k", [8, 16, 40, 64])
def test_arena_kernel_matches_plain(cuda, k):
    """k > 32 runs the wide walk; at k = dim = 64 the top-k columns are
    every column in order, so each 32-pair group is lane-aligned."""
    plan = relation_plan_of(generate_design(1, "medium", SCALE)[0]).to(cuda)
    xv, xi = _operands(plan, k, k, cuda)
    before = tk.drspmm_fwd_arena.launches
    y = tk.drspmm_fwd_arena(plan.fwd, xv, xi, 64)
    torch.cuda.synchronize()
    assert tk.drspmm_fwd_arena.launches == before + 1
    assert_close(y.cpu().numpy(),
                 tk.drspmm_fwd_arena_plain(plan.fwd, xv, xi, 64).cpu().numpy())


def test_arena_kernel_repeated_columns(cuda):
    """Zero-value padding duplicates and repeated non-zero columns (the
    kernel's broadcast fallback) both accumulate every pair."""
    plan = relation_plan_of(generate_design(0, "small", SCALE)[0]).to(cuda)
    n = plan.n_src_total
    rng = np.random.default_rng(3)
    xv = rng.normal(size=(n, 6)).astype(np.float32)
    xi = np.zeros((n, 6), np.int32)
    xi[:, 3:] = 5
    xv[:, 1:3] = 0.0
    xv, xi = torch.from_numpy(xv).to(cuda), torch.from_numpy(xi).to(cuda)
    y = tk.drspmm_fwd_arena(plan.fwd, xv, xi, HIDDEN)
    assert_close(y.cpu().numpy(), tk.drspmm_fwd_arena_plain(
        plan.fwd, xv, xi, HIDDEN).cpu().numpy())


def test_dense_tier_kernel_matches_plain(cuda):
    plan = relation_plan_of(generate_design(1, "medium", SCALE)[0]).to(cuda)
    assert plan.has_dense
    xv, xi = _operands(plan, 16, 5, cuda)
    before = tk.drspmm_dense_tier_fwd.launches
    y = tk.drspmm_dense_tier_fwd(plan.dense_fwd, xv, xi, 64)
    torch.cuda.synchronize()
    assert tk.drspmm_dense_tier_fwd.launches == before + 1
    assert_close(y.cpu().numpy(), tk.drspmm_dense_tier_fwd_plain(
        plan.dense_fwd, xv, xi, 64).cpu().numpy())


@pytest.mark.parametrize("n", [1, 31, 1031])
@pytest.mark.parametrize("d", [1, 7, 32, 33, 64, 65, 96, 128, 200, 256])
@pytest.mark.parametrize("which_k", ["one", "middle", "last"])
def test_drelu_bisect_kernel_bit_exact(cuda, which_k, d, n):
    """Every padded width (32, 64, 128, 256), k = 1, d // 2 and d - 1
    (0 at d 1), n below, at and above a block's 32 rows; the rows of
    ``drelu_rows``: ties at the threshold, one value, zeros, -0.0, +-inf
    (a NaN mid), overflowing lo + hi, ReLU'd rows.  Bit for bit, the sign
    of a zero included, in one launch."""
    k = {"one": min(1, d - 1), "middle": d // 2, "last": d - 1}[which_k]
    x = torch.from_numpy(drelu_rows(n, d, seed=d * 7 + n)).to(cuda)
    before = drelu_topk.drelu_bisect.launches
    y = drelu_topk.drelu_bisect(x, k)
    torch.cuda.synchronize()
    assert drelu_topk.drelu_bisect.launches == before + 1
    ref = drelu_topk.drelu_bisect_plain(x, k)
    assert torch.equal(y.view(torch.int32), ref.view(torch.int32))


@pytest.mark.parametrize("drelu_backend", ["topk", "bisect"])
def test_engine_on_card_matches_cpu(cuda, drelu_backend):
    graphs = generate_design(0, "small", SCALE) \
        + generate_design(1, "medium", SCALE)
    cfg = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K,
                         drelu_backend=drelu_backend)
    gpu = DRCircuitGNN(16, 16, HIDDEN, LAYERS, device=cuda)
    cpu = DRCircuitGNN(16, 16, HIDDEN, LAYERS, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    eng = CircuitServeEngine(gpu, cfg, max_batch=2, device=cuda)
    rids = [eng.submit(g) for g in graphs]
    done = eng.run()
    for rid, g in zip(rids, graphs):
        assert done[rid].error is None
        with torch.no_grad():
            ref = cpu(g, cfg).numpy()
        assert np.isfinite(done[rid].pred).all()
        assert np.mean(np.abs(done[rid].pred - ref) <= 1e-4) >= 0.999


def _plan_with_chunk(ec, device, dense_threshold=-1):
    """The plan of a scale-0.02 partition with the arena chunk width
    pinned to ``ec`` (all-arena by default)."""
    g = generate_design(1, "medium", SCALE)[0]
    rels = [(et, *EDGE_SCHEMA[et], *ell_to_coo(g.edges[et].adj))
            for et in EDGE_TYPES]
    plan = build_relation_plan(rels, {"cell": g.n_cell, "net": g.n_net},
                               chunk=ec, dense_threshold=dense_threshold)
    assert plan.bwd.nbr.shape[2] == ec
    return plan.to(device)


@pytest.mark.parametrize("ec", [4, 8, 16])
@pytest.mark.parametrize("k,dim", [(8, 64), (16, 64), (32, 64), (40, 64),
                                   (64, 64), (200, 256)])
def test_arena_bwd_kernel_matches_plain(cuda, k, dim, ec):
    """k 40, 64 and 200 run the kernel's wide walk (its 2- and 8-group
    instantiations).  Every fifth xi row repeats an index (the gather
    samples that gY column twice)."""
    plan = _plan_with_chunk(ec, cuda)
    _, xi = _operands(plan, k, k + ec, cuda, dim)
    xi[::5, 1] = xi[::5, 0]
    gy = torch.randn((plan.n_out_total, dim),
                     generator=torch.Generator().manual_seed(ec)).to(cuda)
    before = tk.drspmm_bwd_arena.launches
    dv = tk.drspmm_bwd_arena(plan.bwd, plan.bwd_src_rows, gy, xi)
    torch.cuda.synchronize()
    assert tk.drspmm_bwd_arena.launches == before + 1
    assert dv.shape == (plan.bwd.n_arena_rows, k)
    assert_close(dv.cpu().numpy(), tk.drspmm_bwd_arena_plain(
        plan.bwd, plan.bwd_src_rows, gy, xi).cpu().numpy())


@pytest.mark.parametrize("k", [8, 16, 32, 40])
def test_dense_tier_bwd_kernel_matches_plain(cuda, k):
    """The stacked transposed table with every seventh source row zeroed:
    those rows come back exactly 0."""
    plan = relation_plan_of(generate_design(1, "medium", SCALE)[0]).to(cuda)
    assert plan.has_dense
    _, xi = _operands(plan, k, 5, cuda)
    xi[::4, 2] = xi[::4, 1]
    a_t = plan.dense_bwd.clone()
    a_t[::7] = 0.0
    gy = torch.randn((a_t.shape[1], 64),
                     generator=torch.Generator().manual_seed(k)).to(cuda)
    before = tk.drspmm_dense_tier_bwd.launches
    dv = tk.drspmm_dense_tier_bwd(a_t, gy, xi)
    torch.cuda.synchronize()
    assert tk.drspmm_dense_tier_bwd.launches == before + 1
    assert_close(dv.cpu().numpy(), tk.drspmm_dense_tier_bwd_plain(
        a_t, gy, xi).cpu().numpy())
    assert torch.all(dv[::7] == 0)


def _dense_tier_bwd_operands(n, m, density, k, dim, seed, device):
    """A seeded (n, m) transposed dense-tier table at ``density`` (1.0:
    every entry non-zero, full rows; "rows": full rows with every third
    row zero), gY (m, dim) and columns (n, k) in [0, dim) with column 1
    repeating column 0 on every row."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, m)).astype(np.float32)
    if density == "rows":
        a[::3] = 0.0
    else:
        a[rng.random((n, m)) >= density] = 0.0
    gy = rng.normal(size=(m, dim)).astype(np.float32)
    xi = rng.integers(0, dim, (n, k), dtype=np.int32)
    xi[:, 1] = xi[:, 0]
    t = lambda x: torch.from_numpy(x).to(device)
    return t(a), t(gy), t(xi)


@pytest.mark.parametrize("k,dim", [(8, 16), (16, 64), (40, 256), (200, 64)])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.3, 1.0, "rows"])
@pytest.mark.parametrize("m", [1, 31, 33, 473, 1000, 4100])
@pytest.mark.parametrize("n", [1, 7, 473])
def test_dense_tier_bwd_kernel_shapes(cuda, n, m, density, k, dim):
    """Kernel 5 on seeded tables: rows narrower and wider than one window
    of the walk, empty tables, full rows, zero rows among full ones, k up
    to 200 and repeated columns.  One launch a call; a row with no
    non-zero entry comes back exactly 0."""
    a_t, gy, xi = _dense_tier_bwd_operands(n, m, density, k, dim,
                                           n * 10007 + m, cuda)
    before = tk.drspmm_dense_tier_bwd.launches
    dv = tk.drspmm_dense_tier_bwd(a_t, gy, xi)
    torch.cuda.synchronize()
    assert tk.drspmm_dense_tier_bwd.launches == before + 1
    assert_close(dv.cpu().numpy(), tk.drspmm_dense_tier_bwd_plain(
        a_t, gy, xi).cpu().numpy())
    assert torch.all(dv[(a_t == 0).all(dim=1)] == 0)


@pytest.mark.parametrize("n,m", [(473, 473), (473, 4100)])
def test_dense_tier_bwd_kernel_deterministic(cuda, n, m):
    """Two calls give bit-identical outputs."""
    a_t, gy, xi = _dense_tier_bwd_operands(n, m, 0.3, 40, 64, 11, cuda)
    dv1 = tk.drspmm_dense_tier_bwd(a_t, gy, xi)
    dv2 = tk.drspmm_dense_tier_bwd(a_t, gy, xi)
    torch.cuda.synchronize()
    assert torch.equal(dv1, dv2)


def _dense_tier_fwd_operands(m, n, density, k, dim, seed, device):
    """A seeded (m, n) dense-tier table at ``density`` (1.0: every entry
    non-zero; "rows": full rows with every third row zero) and a CBSR
    operand (n, k) with columns in [0, dim): column 1 repeats column 0 on
    every row (a repeated non-zero column), and pair 2 is zero-valued."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(m, n)).astype(np.float32)
    if density == "rows":
        a[::3] = 0.0
    else:
        a[rng.random((m, n)) >= density] = 0.0
    xv = rng.normal(size=(n, k)).astype(np.float32)
    xi = rng.integers(0, dim, (n, k), dtype=np.int32)
    xi[:, 1] = xi[:, 0]
    xv[:, 2] = 0.0
    t = lambda x: torch.from_numpy(x).to(device)
    return t(a), t(xv), t(xi)


@pytest.mark.parametrize("k,dim", [(8, 16), (16, 64), (40, 256), (200, 64)])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.3, 1.0, "rows"])
@pytest.mark.parametrize("n", [1, 31, 33, 473, 1000, 4100])
@pytest.mark.parametrize("m", [1, 7, 473])
def test_dense_tier_fwd_kernel_shapes(cuda, m, n, density, k, dim):
    """Kernel 2 on seeded tables: rows of A narrower and wider than one
    window of the walk, empty tables, full rows, zero rows among full ones,
    dim 16-256 (1-8 columns a lane), k on both sides of 32, repeated
    non-zero columns and zero-valued pairs.  One launch a call; a row of
    A with no non-zero entry comes back exactly 0."""
    a, xv, xi = _dense_tier_fwd_operands(m, n, density, k, dim,
                                         m * 10007 + n, cuda)
    before = tk.drspmm_dense_tier_fwd.launches
    y = tk.drspmm_dense_tier_fwd(a, xv, xi, dim)
    torch.cuda.synchronize()
    assert tk.drspmm_dense_tier_fwd.launches == before + 1
    assert_close(y.cpu().numpy(), tk.drspmm_dense_tier_fwd_plain(
        a, xv, xi, dim).cpu().numpy())
    assert torch.all(y[(a == 0).all(dim=1)] == 0)


@pytest.mark.parametrize("m,n", [(473, 473), (473, 4100)])
def test_dense_tier_fwd_kernel_deterministic(cuda, m, n):
    """Two calls give bit-identical outputs."""
    a, xv, xi = _dense_tier_fwd_operands(m, n, 0.3, 16, 64, 11, cuda)
    y1 = tk.drspmm_dense_tier_fwd(a, xv, xi, 64)
    y2 = tk.drspmm_dense_tier_fwd(a, xv, xi, 64)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)


@pytest.mark.parametrize("drelu_backend", ["topk", "bisect"])
def test_trainer_step_on_card_matches_cpu(cuda, drelu_backend):
    graphs = generate_design(1, "medium", SCALE)[:2]
    cfg = CircuitTrainConfig(hidden=HIDDEN, k_cell=K, k_net=K, lr=1e-3,
                             batch_size=2, drelu_backend=drelu_backend,
                             remat=drelu_backend == "bisect")
    gpu = CircuitTrainer(cfg, 16, 16, device=cuda)
    cpu_model = DRCircuitGNN(16, 16, HIDDEN, LAYERS, device="cpu")
    cpu_model.load_state_dict(gpu.model.state_dict())
    cpu = CircuitTrainer(cfg, 16, 16, model=cpu_model, device="cpu")
    before = (tk.drspmm_bwd_arena.launches,
              tk.drspmm_dense_tier_bwd.launches)
    loss_gpu = gpu.train_epoch(graphs)
    loss_cpu = cpu.train_epoch(graphs)
    assert tk.drspmm_bwd_arena.launches > before[0]
    assert tk.drspmm_dense_tier_bwd.launches > before[1]
    assert abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu)
    for (n, p), q in zip(gpu.model.named_parameters(), cpu.params):
        err = float(torch.linalg.norm(p.detach().cpu() - q.detach()))
        assert err <= 1e-4 * float(torch.linalg.norm(q.detach())), n


def _rel_close(a, b, rtol=1e-4):
    """Relative L2 closeness of a card tensor to its CPU counterpart."""
    a, b = a.detach().cpu(), b.detach().cpu()
    assert float(torch.linalg.norm(a - b)) <= rtol * float(
        torch.linalg.norm(b)) + 1e-12


@pytest.mark.parametrize("dim", [32, 64, 96])
@pytest.mark.parametrize("ec", [4, 8, 16])
def test_spmm_arena_kernel_matches_plain(cuda, ec, dim):
    adj = generate_design(1, "medium", SCALE)[0].edges["near"].adj
    f = fuse_bucketed(adj, chunk=ec).to(cuda)
    x = torch.randn((adj.n_src, dim),
                    generator=torch.Generator().manual_seed(ec)).to(cuda)
    before = tk.spmm_arena.launches
    y = tk.spmm_arena(f, x)
    torch.cuda.synchronize()
    assert tk.spmm_arena.launches == before + 1
    assert_close(y.cpu().numpy(), tk.spmm_arena_plain(f, x).cpu().numpy())


def _eid_arenas(device, ec=None, n=300, n_target=4000, seed=0):
    rng = np.random.default_rng(seed)
    pairs = np.unique(np.stack([rng.integers(0, n, n_target),
                                rng.integers(0, n, n_target)], 1), axis=0)
    pairs = pairs[rng.permutation(len(pairs))]
    ff, fb, _o, nnz = pack_fused_eid_pair(pairs[:, 0], pairs[:, 1], n, n,
                                          chunk=ec)
    w = torch.from_numpy(rng.normal(size=nnz).astype(np.float32))
    return ff.to(device), fb.to(device), nnz, w.to(device)


def _skewed_eid_arena(device, seed=3, transposed=False):
    """A forward edge-id arena at Ec 4 as skewed as the homogenized Table-1
    partition: 40 rows of 240-270 neighbours among 400 rows of 1-12, so the
    long chunk runs are no multiple of the wide walks' batches or 32-slot
    windows; every other row-block is then left empty (blocks 2b hold the
    packed blocks b).  ``transposed``: the same edges reversed, packed into
    the transposed arena, whose rows are then the 240-270-slot ones."""
    rng = np.random.default_rng(seed)
    n = 440
    deg = np.concatenate([rng.integers(240, 271, 40),
                          rng.integers(1, 13, n - 40)])
    dst = np.repeat(np.arange(n), deg)
    src = np.concatenate([rng.choice(n, d, replace=False) for d in deg])
    perm = rng.permutation(dst.size)
    if transposed:
        dst, src = src, dst
    ff, fb, _o, nnz = pack_fused_eid_pair(dst[perm], src[perm], n, n,
                                          chunk=4)
    f = fb if transposed else ff
    f = dataclasses.replace(f, block_of=2 * f.block_of,
                            rows=np.concatenate([f.rows, f.rows]),
                            blk_ptr=None)
    w = torch.from_numpy(rng.normal(size=nnz).astype(np.float32))
    return f.to(device), nnz, w.to(device)


def _skewed_arena(device, ec, seed=5):
    """A fixed-weight arena at chunk width ``ec`` as skewed as the Table-1
    super-arena: 40 rows of 260-300 neighbours among 400 of 1-12 (at Ec 4
    runs of 1 to 75 chunks, the long ones ending mid-window), every other
    row-block left empty (blocks 2b hold the packed blocks b) and row 3 of
    the longest run all padding; then the edge-id arena of the same edges
    (kernel 7), spread the same way, with its nnz and canonical weights."""
    rng = np.random.default_rng(seed)
    n = 440
    deg = np.concatenate([rng.integers(260, 301, 40),
                          rng.integers(1, 13, n - 40)])
    dst = np.repeat(np.arange(n), deg)
    src = np.concatenate([rng.choice(n, d, replace=False) for d in deg])
    perm = rng.permutation(dst.size)
    dst, src = dst[perm], src[perm]
    w = rng.normal(size=dst.size).astype(np.float32)
    spread = lambda f: dataclasses.replace(
        f, block_of=2 * f.block_of, rows=np.concatenate([f.rows, f.rows]),
        blk_ptr=None)
    f = spread(fuse_bucketed(pack_ell(dst, src, w, n, n), chunk=ec))
    b = int(np.argmax(np.diff(f.blk_ptr)))
    fw = f.w.copy()
    fw[f.blk_ptr[b]:f.blk_ptr[b + 1], 3, :] = 0.0
    f = dataclasses.replace(f, w=fw)
    ff, _fb, _o, nnz = pack_fused_eid_pair(dst, src, n, n, chunk=ec)
    wc = torch.from_numpy(rng.normal(size=nnz).astype(np.float32))
    return f.to(device), (spread(ff).to(device), nnz, wc.to(device))


def _narrow_operand(n, k, dim, seed, device, cols="distinct"):
    """A CBSR operand (n, k) for the k <= 32 walk and the reference to hold
    the kernel against (the plain version's operand, with the pairs that add
    nothing zeroed).  ``cols``: "distinct" (k distinct columns of [0, dim)
    a row, or k columns with repeats where k > dim; every fourth row's
    last pair zero-valued), "repeat" (column 1 repeating column 0 on every
    fifth row) or "outside" (every third row's pair 0 at column dim + 2,
    every seventh row's last pair at -1)."""
    rng = np.random.default_rng(seed)
    xv = rng.normal(size=(n, k)).astype(np.float32)
    if k <= dim:
        xi = np.argsort(rng.random((n, dim)), axis=1)[:, :k]
    else:
        xi = rng.integers(0, dim, (n, k))
    xi = xi.astype(np.int32)
    xv[::4, -1] = 0.0
    ref_v, ref_i = xv.copy(), xi.copy()
    if cols == "repeat":
        xi[::5, 1] = xi[::5, 0]
        ref_i = xi.copy()
    elif cols == "outside":
        xi[::3, 0] = dim + 2
        xi[::7, -1] = -1
        out = (xi < 0) | (xi >= dim)
        ref_v[out], ref_i[out] = 0.0, 0
    else:
        assert cols == "distinct", cols
    t = lambda a: torch.from_numpy(a).to(device)
    return t(xv), t(xi), t(ref_v), t(ref_i)


@pytest.mark.parametrize("dim", [1, 33, 64, 256])
@pytest.mark.parametrize("k", [1, 5, 16, 32])
@pytest.mark.parametrize("ec", [4, 8, 16])
def test_arena_kernel_skewed_arena(cuda, ec, k, dim):
    """Kernel 1's k <= 32 walk over runs of 1 to 75 chunks (long runs split
    between a row's warps, ending mid-window and mid-batch), empty
    row-blocks and an all-padding row, at 1, 2 and 4 rows a warp (k 32,
    16, <= 8); one launch a call."""
    f, _ = _skewed_arena(cuda, ec)
    runs = torch.diff(f.blk_ptr)
    assert int((runs == 0).sum()) > 1 and int(runs[runs > 0].min()) == 1
    assert int(runs.max()) >= (65 if ec == 4 else 260 // ec)
    xv, xi, rv, ri = _narrow_operand(f.n_src, k, dim, k + dim, cuda)
    before = tk.drspmm_fwd_arena.launches
    y = tk.drspmm_fwd_arena(f, xv, xi, dim)
    torch.cuda.synchronize()
    assert tk.drspmm_fwd_arena.launches == before + 1
    assert_close(y.cpu().numpy(),
                 tk.drspmm_fwd_arena_plain(f, rv, ri, dim).cpu().numpy())


@pytest.mark.parametrize("cols", ["repeat", "outside"])
@pytest.mark.parametrize("k", [5, 16, 32])
@pytest.mark.parametrize("ec", [4, 8, 16])
def test_arena_kernel_skewed_columns(cuda, ec, k, cols):
    """Repeated non-zero columns (every pair added, a batch at a time in
    pair order) and columns outside [0, dim) (nothing added) on the skewed
    arena."""
    f, _ = _skewed_arena(cuda, ec)
    xv, xi, rv, ri = _narrow_operand(f.n_src, k, 64, k, cuda, cols)
    y = tk.drspmm_fwd_arena(f, xv, xi, 64)
    assert_close(y.cpu().numpy(),
                 tk.drspmm_fwd_arena_plain(f, rv, ri, 64).cpu().numpy())


@pytest.mark.parametrize("ec", [4, 8, 16])
def test_arena_kernel_deterministic(cuda, ec):
    """Two calls on the skewed arena give the same bits, split runs
    included."""
    f, _ = _skewed_arena(cuda, ec)
    xv, xi, _rv, _ri = _narrow_operand(f.n_src, 16, 64, 1, cuda)
    y1 = tk.drspmm_fwd_arena(f, xv, xi, 64)
    y2 = tk.drspmm_fwd_arena(f, xv, xi, 64)
    assert torch.equal(y1, y2)


@pytest.mark.parametrize("k", [5, 16, 32])
@pytest.mark.parametrize("ec", [4, 8, 16])
def test_learnable_fwd_kernel_narrow_skewed(cuda, ec, k):
    """Kernel 7 at k <= 32 (the same walk, its weights gathered through the
    edge ids) on the skewed arena's edges; one launch a call."""
    _, (ff, nnz, w) = _skewed_arena(cuda, ec)
    xv, xi, rv, ri = _narrow_operand(ff.n_src, k, 64, k, cuda, "repeat")
    before = tk.drspmm_fwd_learnable.launches
    y = tk.drspmm_fwd_learnable(ff, nnz, w, xv, xi, 64)
    torch.cuda.synchronize()
    assert tk.drspmm_fwd_learnable.launches == before + 1
    assert_close(y.cpu().numpy(), tk.drspmm_fwd_learnable_plain(
        ff, nnz, w, rv, ri, 64).cpu().numpy())


LEARNABLE_COLS = ["iota", "perm", "mixed", "repeat", "zeros"]


def _learnable_operand(n, k, dim, seed, device, cols=None):
    """A CBSR operand (n, k).  ``cols=None``: the dense iota case at
    k == dim, else k random columns per row with every fifth row repeating
    a column.  At k == dim, ``cols`` picks the columns of each row:
    "iota" (every 32-pair group lane-aligned, the GAT baselines' operand),
    "perm" (a random permutation: no group aligned), "mixed" (group 0
    aligned and group 1 permuted on even rows, the other way round on odd
    rows), "repeat" (iota, with every fifth row repeating column 0 at
    pair 1: the broadcast fallback) or "zeros" (iota, with pairs 3-9 of
    every third row zero-valued and pairs 5-9 of them at a wrong column,
    so that zero pairs are skipped and leave the group aligned) or
    "outside" (iota, with pairs 5-8 of every third row at columns >= dim
    and pair 40 of the next rows at -1: they sample nothing)."""
    g = torch.Generator().manual_seed(seed)
    xv = torch.randn((n, k), generator=g)
    iota = torch.arange(k, dtype=torch.int32).expand(n, k).contiguous()
    if cols is None:
        cols = "iota" if k == dim else "random"
    if cols == "random":
        xi = torch.stack([torch.randperm(dim, generator=g)[:k]
                          for _ in range(n)]).to(torch.int32)
        xi[::5, 1] = xi[::5, 0]
        return xv.to(device), xi.to(device)
    assert k == dim
    xi = iota.clone()
    if cols == "perm":
        xi = torch.argsort(torch.rand((n, k), generator=g), dim=1)
    elif cols == "mixed":
        for r in range(n):
            h = 32 * (1 - r % 2)         # the permuted group's first pair
            xi[r, h:h + 32] = h + torch.randperm(32, generator=g)
    elif cols == "repeat":
        xi[::5, 1] = xi[::5, 0]
    elif cols == "zeros":
        xv[::3, 3:10] = 0.0
        xi[::3, 5:10] = 40
    elif cols == "outside":
        xi[::3, 5:9] = k + 3 * torch.arange(4, dtype=torch.int32)
        xi[1::3, 40] = -1
    else:
        assert cols == "iota", cols
    return xv.to(device), xi.to(torch.int32).contiguous().to(device)


@pytest.mark.parametrize("ec", [4, 8, 16])
@pytest.mark.parametrize("k,cols", [(6, None), (16, None), (40, None)]
                         + [(64, c) for c in LEARNABLE_COLS])
def test_learnable_fwd_kernel_matches_plain(cuda, k, cols, ec):
    """Repeated CBSR columns (every fifth row at k < 64, ``cols="repeat"``)
    take the broadcast path; k 64 = dim runs the wide walk, whose
    lane-aligned groups (the GAT baselines' iota operand) skip the
    scatter and whose other groups (permuted, mixed, repeated) take it."""
    ff, _fb, nnz, w = _eid_arenas(cuda, ec)
    xv, xi = _learnable_operand(ff.n_src, k, 64, k, cuda, cols)
    before = tk.drspmm_fwd_learnable.launches
    y = tk.drspmm_fwd_learnable(ff, nnz, w, xv, xi, 64)
    torch.cuda.synchronize()
    assert tk.drspmm_fwd_learnable.launches == before + 1
    assert_close(y.cpu().numpy(), tk.drspmm_fwd_learnable_plain(
        ff, nnz, w, xv, xi, 64).cpu().numpy())


@pytest.mark.parametrize("k,dim,cols", [(40, 64, None), (100, 128, None),
                                        (200, 256, None)]
                         + [(64, 64, c) for c in LEARNABLE_COLS])
def test_learnable_fwd_kernel_skewed_arena(cuda, k, dim, cols):
    """The wide walk over rows of 240-270 slots at Ec 4 (runs that end
    mid-batch and mid-window, split between a row's warps) and over empty
    row-blocks; k 100 and 200 take its 4- and 8-group instantiations."""
    ff, nnz, w = _skewed_eid_arena(cuda)
    runs = torch.diff(ff.blk_ptr)
    assert int(runs.max()) * 4 >= 240 and int((runs == 0).sum()) > 1
    xv, xi = _learnable_operand(ff.n_src, k, dim, 7, cuda, cols)
    y = tk.drspmm_fwd_learnable(ff, nnz, w, xv, xi, dim)
    assert_close(y.cpu().numpy(), tk.drspmm_fwd_learnable_plain(
        ff, nnz, w, xv, xi, dim).cpu().numpy())


def _bwd_learnable_ref(fb, nnz, w, gy, xi):
    """Kernel 8's plain version, with the columns outside [0, dim) (which
    the kernel samples as nothing, and the plain gather cannot index)
    read at column 0 and their outputs set to 0."""
    out = (xi < 0) | (xi >= gy.shape[1])
    ref = tk.drspmm_bwd_learnable_plain(fb, nnz, w, gy, xi.masked_fill(
        out, 0))
    return ref.masked_fill(out[fb.rows.long()], 0.0)


@pytest.mark.parametrize("ec", [4, 8, 16])
@pytest.mark.parametrize("k,dim,cols", [(8, 64, None), (32, 64, None),
                                        (40, 64, None), (100, 128, None),
                                        (200, 256, None)]
                         + [(64, 64, c) for c in
                            ["iota", "perm", "mixed", "repeat", "outside"]])
def test_learnable_bwd_kernel_matches_plain(cuda, k, dim, cols, ec):
    """k > 32 runs the walk's wide variant (k 40 and 64 its 2-group, k 100
    its 4-group and k 200 its 8-group instantiation); at k = dim = 64 the
    columns are those of the GAT baselines (iota), permuted, half
    permuted, repeated or partly outside [0, dim)."""
    _ff, fb, nnz, w = _eid_arenas(cuda, ec, seed=1)
    _, xi = _learnable_operand(fb.n_dst, k, dim, k + 1, cuda, cols)
    gy = torch.randn((fb.n_src, dim),
                     generator=torch.Generator().manual_seed(ec)).to(cuda)
    before = tk.drspmm_bwd_learnable.launches
    dv = tk.drspmm_bwd_learnable(fb, nnz, w, gy, xi)
    torch.cuda.synchronize()
    assert tk.drspmm_bwd_learnable.launches == before + 1
    assert dv.shape == (fb.n_arena_rows, k)
    assert_close(dv.cpu().numpy(),
                 _bwd_learnable_ref(fb, nnz, w, gy, xi).cpu().numpy())


@pytest.mark.parametrize("k,dim,cols", [(40, 64, None), (100, 128, None),
                                        (200, 256, None)]
                         + [(64, 64, c) for c in ["iota", "perm", "outside"]])
def test_learnable_bwd_kernel_skewed_arena(cuda, k, dim, cols):
    """The wide walk over transposed rows of 240-270 slots at Ec 4 (runs
    that end mid-batch and mid-window) and over empty row-blocks."""
    fb, nnz, w = _skewed_eid_arena(cuda, transposed=True)
    runs = torch.diff(fb.blk_ptr)
    assert int(runs.max()) * 4 >= 240 and int((runs == 0).sum()) > 1
    _, xi = _learnable_operand(fb.n_dst, k, dim, 9, cuda, cols)
    gy = torch.randn((fb.n_src, dim),
                     generator=torch.Generator().manual_seed(k)).to(cuda)
    before = tk.drspmm_bwd_learnable.launches
    dv = tk.drspmm_bwd_learnable(fb, nnz, w, gy, xi)
    torch.cuda.synchronize()
    assert tk.drspmm_bwd_learnable.launches == before + 1
    assert_close(dv.cpu().numpy(),
                 _bwd_learnable_ref(fb, nnz, w, gy, xi).cpu().numpy())


def _bwd_arena_ref(f, src, gy, xi):
    """Kernel 4's plain version, with the columns outside [0, dim) (which
    the kernel samples as nothing, and the plain gather cannot index)
    read at column 0 and their outputs set to 0."""
    out = (xi < 0) | (xi >= gy.shape[1])
    ref = tk.drspmm_bwd_arena_plain(f, src, gy, xi.masked_fill(out, 0))
    return ref.masked_fill(out[src.long()], 0.0)


def _skewed_spmm(cuda, ec, dim, seed=6):
    """The skewed arena of ``_skewed_arena`` for kernel 6, with one more
    row whose padding sits between real slots (row 5 of the second
    longest run: its third and fourth chunks and the first and last slot
    of every chunk weightless), and a seeded dense operand."""
    f, _ = _skewed_arena(cuda, ec)
    ptr = f.blk_ptr.long()
    b = int(torch.argsort(ptr[1:] - ptr[:-1], descending=True)[1])
    lo, hi = int(ptr[b]), int(ptr[b + 1])
    w = f.w.clone()
    w[lo + 2:lo + 4, 5, :] = 0.0
    w[lo:hi, 5, 0] = 0.0
    w[lo:hi, 5, -1] = 0.0
    assert bool((w[lo + 4:hi, 5] != 0).any())
    x = torch.randn((f.n_src, dim),
                    generator=torch.Generator().manual_seed(seed + dim))
    return dataclasses.replace(f, w=w), x.to(cuda)


@pytest.mark.parametrize("dim", [1, 33, 64, 96, 256])
@pytest.mark.parametrize("ec", [4, 8, 16])
def test_spmm_arena_kernel_skewed_arena(cuda, ec, dim):
    """Kernel 6 over runs of 1 to 75 chunks (runs longer than one and than
    two 32-slot windows, ending mid-window and mid-batch), empty
    row-blocks, an all-padding row and a row with padding between its real
    slots, at one to eight columns a lane; one launch a call."""
    f, x = _skewed_spmm(cuda, ec, dim)
    runs = torch.diff(f.blk_ptr)
    assert int((runs == 0).sum()) > 1 and int(runs[runs > 0].min()) == 1
    assert int(runs.max()) * ec > 64
    before = tk.spmm_arena.launches
    y = tk.spmm_arena(f, x)
    torch.cuda.synchronize()
    assert tk.spmm_arena.launches == before + 1
    assert y.shape == (f.n_arena_rows, dim)
    assert_close(y.cpu().numpy(), tk.spmm_arena_plain(f, x).cpu().numpy())


@pytest.mark.parametrize("ec", [4, 8, 16])
def test_spmm_arena_kernel_deterministic(cuda, ec):
    """Two calls on the skewed arena give the same bits."""
    f, x = _skewed_spmm(cuda, ec, 64)
    assert torch.equal(tk.spmm_arena(f, x), tk.spmm_arena(f, x))


def _skewed_bwd(cuda, ec, k, dim, cols="distinct"):
    """The skewed arena of ``_skewed_arena`` walked as a transposed arena
    (its rows sample their own CBSR columns, ``f.rows`` the source-row
    map), CBSR columns for its rows and a seeded gY over its neighbours."""
    f, eids = _skewed_arena(cuda, ec)
    _, xi, _, _ = _narrow_operand(f.n_dst, k, dim, k + dim, cuda, cols)
    gy = torch.randn((f.n_src, dim), generator=torch.Generator().manual_seed(
        ec * 1000 + k * dim)).to(cuda)
    return f, eids, xi, gy


@pytest.mark.parametrize("dim", [1, 33, 64, 256])
@pytest.mark.parametrize("k", [1, 5, 16, 32])
@pytest.mark.parametrize("ec", [4, 8, 16])
def test_arena_bwd_kernel_skewed_arena(cuda, ec, k, dim):
    """Kernel 4's k <= 32 walk over runs of 1 to 75 chunks (the long ones
    ending mid-window and mid-batch), empty row-blocks and an all-padding
    row, at 1, 2, 4 and 8 rows a warp (k 32, 16, 5, 1); k > dim repeats
    columns.  One launch a call."""
    f, _, xi, gy = _skewed_bwd(cuda, ec, k, dim)
    runs = torch.diff(f.blk_ptr)
    assert int((runs == 0).sum()) > 1 and int(runs[runs > 0].min()) == 1
    assert int(runs.max()) >= (65 if ec == 4 else 260 // ec)
    before = tk.drspmm_bwd_arena.launches
    dv = tk.drspmm_bwd_arena(f, f.rows, gy, xi)
    torch.cuda.synchronize()
    assert tk.drspmm_bwd_arena.launches == before + 1
    assert dv.shape == (f.n_arena_rows, k)
    assert_close(dv.cpu().numpy(), tk.drspmm_bwd_arena_plain(
        f, f.rows, gy, xi).cpu().numpy())


@pytest.mark.parametrize("cols", ["repeat", "outside"])
@pytest.mark.parametrize("k", [5, 16, 32])
@pytest.mark.parametrize("ec", [4, 8, 16])
def test_arena_bwd_kernel_skewed_columns(cuda, ec, k, cols):
    """Repeated columns (each lane samples its own) and columns outside
    [0, dim) (they sample nothing: 0) on the skewed arena."""
    f, _, xi, gy = _skewed_bwd(cuda, ec, k, 64, cols)
    dv = tk.drspmm_bwd_arena(f, f.rows, gy, xi)
    assert_close(dv.cpu().numpy(),
                 _bwd_arena_ref(f, f.rows, gy, xi).cpu().numpy())


@pytest.mark.parametrize("ec", [4, 8, 16])
def test_arena_bwd_kernel_deterministic(cuda, ec):
    """Two calls on the skewed arena give the same bits."""
    f, _, xi, gy = _skewed_bwd(cuda, ec, 16, 64)
    dv1 = tk.drspmm_bwd_arena(f, f.rows, gy, xi)
    dv2 = tk.drspmm_bwd_arena(f, f.rows, gy, xi)
    assert torch.equal(dv1, dv2)


@pytest.mark.parametrize("k", [5, 16, 32])
@pytest.mark.parametrize("ec", [4, 8, 16])
def test_learnable_bwd_kernel_narrow_skewed(cuda, ec, k):
    """Kernel 8 at k <= 32 (kernel 4's walk, its weights gathered through
    the edge ids) on the skewed arena's edges; one launch a call."""
    _, (ff, nnz, w), xi, gy = _skewed_bwd(cuda, ec, k, 64, "repeat")
    before = tk.drspmm_bwd_learnable.launches
    dv = tk.drspmm_bwd_learnable(ff, nnz, w, gy, xi)
    torch.cuda.synchronize()
    assert tk.drspmm_bwd_learnable.launches == before + 1
    assert_close(dv.cpu().numpy(),
                 _bwd_learnable_ref(ff, nnz, w, gy, xi).cpu().numpy())


@pytest.mark.parametrize("ec", [4, 8, 16])
@pytest.mark.parametrize("k", [6, 32, 40, 64])
def test_learnable_dw_kernel_matches_plain(cuda, k, ec):
    ff, _fb, nnz, _w = _eid_arenas(cuda, ec, seed=2)
    xv, xi = _learnable_operand(ff.n_src, k, 64, k + 2, cuda)
    gy = torch.randn((ff.n_dst, 64),
                     generator=torch.Generator().manual_seed(k)).to(cuda)
    before = tk.drspmm_dw_learnable.launches
    gw = tk.drspmm_dw_learnable(ff, nnz, gy, xv, xi)
    torch.cuda.synchronize()
    assert tk.drspmm_dw_learnable.launches == before + 1
    assert gw.shape == (nnz,)
    assert_close(gw.cpu().numpy(), tk.drspmm_dw_learnable_plain(
        ff, nnz, gy, xv, xi).cpu().numpy())


def _dw_operand(n, k, dim, seed, device):
    """A CBSR operand (n, k) for kernel 9: at k == dim the GAT operand's
    iota columns, else each row's k columns drawn from [0, dim) with
    repeats (k may exceed dim)."""
    if k == dim:
        return _learnable_operand(n, k, dim, seed, device)
    g = torch.Generator().manual_seed(seed)
    xv = torch.randn((n, k), generator=g)
    xi = torch.randint(0, dim, (n, k), generator=g, dtype=torch.int32)
    return xv.to(device), xi.to(device)


def _dw_ref(f, nnz, gy, xv, xi):
    """Kernel 9's plain version, with the columns outside [0, dim) (which
    the kernel samples as nothing, and the plain gather cannot index)
    read at column 0 with the value 0."""
    out = (xi < 0) | (xi >= gy.shape[1])
    return tk.drspmm_dw_learnable_plain(f, nnz, gy, xv.masked_fill(out, 0.0),
                                        xi.masked_fill(out, 0))


def _dw_one_launch(f, nnz, gy, xv, xi):
    before = tk.drspmm_dw_learnable.launches
    gw = tk.drspmm_dw_learnable(f, nnz, gy, xv, xi)
    torch.cuda.synchronize()
    assert tk.drspmm_dw_learnable.launches == before + 1
    assert gw.shape == (nnz,)
    return gw


@pytest.mark.parametrize("dim", [64, 256])
@pytest.mark.parametrize("k", [6, 37, 64, 100, 256])
def test_learnable_dw_kernel_skewed_arena(cuda, k, dim):
    """Kernel 9 over forward rows of 240-270 slots at Ec 4 and over empty
    row-blocks; each k takes another lane group (k 6 eight lanes of one
    position, 37 and 64 eight lanes of eight, 100 sixteen, 256 a warp),
    k 6 and 37 the scalar loads, the others the 16-byte loads."""
    ff, nnz, _w = _skewed_eid_arena(cuda)
    runs = torch.diff(ff.blk_ptr)
    assert int(runs.max()) * 4 >= 240 and int((runs == 0).sum()) > 1
    xv, xi = _dw_operand(ff.n_src, k, dim, k + 3, cuda)
    gy = torch.randn((ff.n_dst, dim),
                     generator=torch.Generator().manual_seed(dim)).to(cuda)
    gw = _dw_one_launch(ff, nnz, gy, xv, xi)
    assert_close(gw.cpu().numpy(),
                 tk.drspmm_dw_learnable_plain(ff, nnz, gy, xv,
                                              xi).cpu().numpy())


@pytest.mark.parametrize("cols", ["iota", "perm", "outside", "repeat"])
def test_learnable_dw_kernel_columns(cuda, cols):
    """Kernel 9 at k = dim = 64 on the skewed arena with the GAT operand's
    iota columns, permuted ones, columns outside [0, dim) (which sample
    nothing) and repeated ones."""
    ff, nnz, _w = _skewed_eid_arena(cuda)
    xv, xi = _learnable_operand(ff.n_src, 64, 64, 11, cuda, cols)
    gy = torch.randn((ff.n_dst, 64),
                     generator=torch.Generator().manual_seed(12)).to(cuda)
    gw = _dw_one_launch(ff, nnz, gy, xv, xi)
    assert_close(gw.cpu().numpy(),
                 _dw_ref(ff, nnz, gy, xv, xi).cpu().numpy())


@pytest.mark.parametrize("ec", [4, 8, 16])
@pytest.mark.parametrize("k,aligned", [(1, True), (3, True), (13, True),
                                       (30, True), (36, True), (255, True),
                                       (64, False)])
def test_learnable_dw_kernel_tails(cuda, k, aligned, ec):
    """Lengths that end inside a lane's positions: k not a multiple of 4
    (scalar loads, the last lane of a group partly or wholly idle), k 36
    (16-byte loads, the second one of the last lane skipped), and a k 64
    operand 4 bytes off a 16-byte boundary (a view into a flat buffer),
    which must take the scalar loads."""
    ff, _fb, nnz, _w = _eid_arenas(cuda, ec, seed=4)
    xv, xi = _dw_operand(ff.n_src, k, 256, k, cuda)
    if not aligned:
        buf = torch.zeros(xv.numel() + 1, device=cuda)
        buf[1:] = xv.flatten()
        xv = buf[1:].view(xv.shape)
        assert xv.data_ptr() % 16 == 4 and xv.is_contiguous()
    gy = torch.randn((ff.n_dst, 256),
                     generator=torch.Generator().manual_seed(ec)).to(cuda)
    gw = _dw_one_launch(ff, nnz, gy, xv, xi)
    assert_close(gw.cpu().numpy(),
                 tk.drspmm_dw_learnable_plain(ff, nnz, gy, xv,
                                              xi).cpu().numpy())


def test_learnable_dw_kernel_deterministic(cuda):
    """Two calls on the same inputs give the same bits (each slot sums in
    one fixed order, no atomics)."""
    ff, nnz, _w = _skewed_eid_arena(cuda)
    xv, xi = _learnable_operand(ff.n_src, 64, 64, 13, cuda, "perm")
    gy = torch.randn((ff.n_dst, 64),
                     generator=torch.Generator().manual_seed(14)).to(cuda)
    a = _dw_one_launch(ff, nnz, gy, xv, xi)
    b = _dw_one_launch(ff, nnz, gy, xv, xi)
    assert torch.equal(a, b)


def test_learnable_dw_kernel_writes_every_id(cuda):
    """The output's memory is filled with NaN before the launch (the
    caching allocator hands the freed block back to the wrapper's
    ``torch.empty``; a first call has built the arena's work list): every
    entry ends finite and equal to the plain version, so the kernel wrote
    each canonical id."""
    ff, nnz, _w = _skewed_eid_arena(cuda)
    xv, xi = _learnable_operand(ff.n_src, 64, 64, 15, cuda)
    gy = torch.randn((ff.n_dst, 64),
                     generator=torch.Generator().manual_seed(16)).to(cuda)
    _dw_one_launch(ff, nnz, gy, xv, xi)
    junk = torch.full((nnz,), float("nan"), device=cuda)
    where = junk.data_ptr()
    del junk
    gw = _dw_one_launch(ff, nnz, gy, xv, xi)
    assert gw.data_ptr() == where
    assert bool(torch.isfinite(gw).all())
    assert_close(gw.cpu().numpy(),
                 tk.drspmm_dw_learnable_plain(ff, nnz, gy, xv,
                                              xi).cpu().numpy())


def test_trainer_dense_step_on_card_matches_cpu(cuda):
    """A batched ``use_drelu=False`` step on the card launches the SpMM
    kernel and none of the D-ReLU path's, and matches the CPU step."""
    graphs = generate_design(1, "medium", SCALE)[:2]
    cfg = CircuitTrainConfig(hidden=HIDDEN, k_cell=K, k_net=K, lr=1e-3,
                             batch_size=2, use_drelu=False)
    gpu = CircuitTrainer(cfg, 16, 16, device=cuda)
    cpu_model = DRCircuitGNN(16, 16, HIDDEN, LAYERS, device="cpu")
    cpu_model.load_state_dict(gpu.model.state_dict())
    cpu = CircuitTrainer(cfg, 16, 16, model=cpu_model, device="cpu")
    others = [tk.drspmm_fwd_arena, tk.drspmm_bwd_arena,
              tk.drspmm_dense_tier_fwd, tk.drspmm_dense_tier_bwd,
              drelu_topk.drelu_bisect]
    before = [f.launches for f in others]
    n0 = tk.spmm_arena.launches
    loss_gpu = gpu.train_epoch(graphs)
    loss_cpu = cpu.train_epoch(graphs)
    assert tk.spmm_arena.launches - n0 == 11    # 6 forward, 5 backward
    assert [f.launches for f in others] == before
    assert abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu)
    for (n, p), q in zip(gpu.model.named_parameters(), cpu.params):
        _rel_close(p, q)


@pytest.mark.parametrize("kind", HOMO_KINDS)
def test_homo_step_on_card_matches_cpu(cuda, kind):
    """Loss and gradients of a baseline on the card against the CPU."""
    adj, adj_t, x, y, n_cell = homogenize(
        generate_design(3, "small", SCALE)[0])
    gpu = HomoGNN(x.shape[1], HIDDEN, kind=kind, nnz=adj.nnz, device=cuda)
    cpu = HomoGNN(x.shape[1], HIDDEN, kind=kind, nnz=adj.nnz, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    if kind == "gat_edge":
        with torch.no_grad():
            for m in (gpu, cpu):
                for layer in m.layers:
                    layer.s.copy_(torch.linspace(-1, 1, adj.nnz))
    counters = [tk.spmm_arena] if kind in ("gcn", "sage") else [
        tk.drspmm_fwd_learnable, tk.drspmm_bwd_learnable,
        tk.drspmm_dw_learnable]
    before = [f.launches for f in counters]
    losses = []
    for m, dev in ((gpu, cuda), (cpu, "cpu")):
        loss = torch.mean((homo_forward(m, adj, adj_t, x.to(dev), n_cell)
                           - y.to(dev)) ** 2)
        loss.backward()
        losses.append(loss.item())
    assert all(f.launches > b for f, b in zip(counters, before))
    assert abs(losses[0] - losses[1]) <= 1e-4 * abs(losses[1])
    for p, q in zip(gpu.parameters(), cpu.parameters()):
        _rel_close(p.grad, q.grad)


@pytest.mark.parametrize("kind", ["gcn", "sage"])
def test_homo_spmm_step_launches_kernel6(cuda, kind):
    """A ``gcn`` / ``sage`` step on ``_SpMM`` launches kernel 6 once a
    layer forward (over A) and once a layer backward (over Aᵀ): 6 for the
    3 layers, and nothing of the learnable path."""
    adj, adj_t, x, y, n_cell = homogenize(
        generate_design(3, "small", SCALE)[0])
    model = HomoGNN(x.shape[1], HIDDEN, kind=kind, nnz=adj.nnz, device=cuda)
    others = [tk.drspmm_fwd_learnable, tk.drspmm_bwd_learnable,
              tk.drspmm_dw_learnable]
    before = [f.launches for f in others]
    n0 = tk.spmm_arena.launches
    loss = torch.mean((homo_forward(model, adj, adj_t, x.to(cuda), n_cell)
                       - y.to(cuda)) ** 2)
    loss.backward()
    torch.cuda.synchronize()
    assert tk.spmm_arena.launches - n0 == 2 * len(model.layers) == 6
    assert [f.launches for f in others] == before


def _bucket_cases(device):
    """The buckets of a scale-0.02 ``near`` relation (and its transpose),
    plus one row of 300 slots, as device slabs."""
    g = generate_design(1, "medium", SCALE)[0]
    rng = np.random.default_rng(4)
    n = 60
    dst = np.concatenate([np.full(300, 7), rng.integers(0, n, 200)])
    src = rng.integers(0, n, dst.shape[0])
    wide = pack_ell(dst, src, rng.random(dst.shape[0]).astype(np.float32)
                    + 0.1, n, n)
    out = []
    for adj in (g.edges["near"].adj, g.edges["near"].adj_t, wide):
        bk = tops.device_buckets(adj, device)
        out += [(adj.n_src, b) for b in bk.buckets]
    assert max(b.nbr.shape[1] for _n, b in out) > 256
    return out


@pytest.mark.parametrize("k,dim", [(8, 32), (16, 64), (40, 64), (16, 96),
                                   (40, 96), (8, 256)])
def test_bucket_fwd_kernel_matches_plain(cuda, k, dim):
    """Kernel 10 on every bucket; every fifth operand row repeats a column
    (the broadcast fallback), and k 40 takes the wide-row branch."""
    for n_src, b in _bucket_cases(cuda):
        xv, xi = _learnable_operand(n_src, k, dim, k, cuda)
        before = tk.drspmm_fwd_bucket.launches
        y = tk.drspmm_fwd_bucket(b, xv, xi, dim)
        torch.cuda.synchronize()
        assert tk.drspmm_fwd_bucket.launches == before + 1
        assert_close(y.cpu().numpy(), tk.drspmm_fwd_bucket_plain(
            b, xv, xi, dim).cpu().numpy())


@pytest.mark.parametrize("k", [4, 16, 32, 40, 64])
def test_bucket_bwd_kernel_matches_plain(cuda, k):
    """Kernel 11 on every bucket at ``xi_rows`` of the bucket's rows;
    k > 32 runs the wide variant."""
    for n_src, b in _bucket_cases(cuda):
        _, xi = _learnable_operand(int(b.rows.max()) + 1, k, 64, k, cuda)
        xi_rows = xi.index_select(0, b.rows).contiguous()
        gy = torch.randn((n_src, 64),
                         generator=torch.Generator().manual_seed(k)).to(cuda)
        before = tk.drspmm_bwd_bucket.launches
        dv = tk.drspmm_bwd_bucket(b, gy, xi_rows)
        torch.cuda.synchronize()
        assert tk.drspmm_bwd_bucket.launches == before + 1
        assert_close(dv.cpu().numpy(), tk.drspmm_bwd_bucket_plain(
            b, gy, xi_rows).cpu().numpy())


@pytest.mark.parametrize("dim", [32, 64, 96, 256])
def test_spmm_bucket_kernel_matches_plain(cuda, dim):
    for n_src, b in _bucket_cases(cuda):
        x = torch.randn((n_src, dim),
                        generator=torch.Generator().manual_seed(dim)).to(cuda)
        before = tk.spmm_bucket.launches
        y = tk.spmm_bucket(b, x)
        torch.cuda.synchronize()
        assert tk.spmm_bucket.launches == before + 1
        assert_close(y.cpu().numpy(), tk.spmm_bucket_plain(b, x).cpu().numpy())


def test_bucket_kernels_on_an_inert_bucket(cuda):
    """An empty matrix's one all-zero bucket writes zeros."""
    b = ELLBucket(rows=torch.zeros(8, dtype=torch.int64, device=cuda),
                  nbr=torch.zeros((8, 1), dtype=torch.int32, device=cuda),
                  w=torch.zeros((8, 1), device=cuda))
    xv, xi = _learnable_operand(3, 4, 64, 0, cuda)
    assert not tk.drspmm_fwd_bucket(b, xv, xi, 64).any()
    assert not tk.drspmm_bwd_bucket(b, torch.randn(3, 64, device=cuda),
                                    xi[[0] * 8]).any()
    assert not tk.spmm_bucket(b, torch.randn(3, 64, device=cuda)).any()


def _wide_slab(r, e, seed, device, n_src=300):
    """One (r, e) slab packed by ``pack_ell`` from a seeded COO: rows 0
    and 1 fill all e slots, the others end early (random degrees); row 1
    has weight 0 at slots 32-63 and over its middle third (padding windows
    between real slots), and every fifth row is all padding (weight 0)."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(1, e + 1, r)
    deg[:2] = e
    dst = np.repeat(np.arange(r), deg)
    j = np.arange(dst.size) - np.repeat(np.cumsum(deg) - deg, deg)
    w = rng.random(dst.size).astype(np.float32) + 0.1
    w[(dst == 1) & (((j >= 32) & (j < 64))
                    | ((j >= e // 3) & (j < 2 * e // 3)))] = 0.0
    w[dst % 5 == 4] = 0.0
    b = pack_ell(dst, rng.integers(0, n_src, dst.size), w, r, n_src,
                 bounds=()).buckets[0]
    assert b.nbr.shape[1] == e
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a[:r], dt)).to(
        device)
    return ELLBucket(rows=t(b.rows, np.int64), nbr=t(b.nbr, np.int32),
                     w=t(b.w, np.float32)), n_src


@pytest.mark.parametrize("k,dim", [(16, 64), (16, 96), (40, 96), (64, 64),
                                   (64, 256), (200, 256)])
@pytest.mark.parametrize("e", [33, 256, 260, 300, 1000])
@pytest.mark.parametrize("r", [1, 3, 40])
def test_bucket_fwd_kernel_wide_slabs(cuda, r, e, k, dim):
    """Kernel 10 on slabs whose rows it splits over several warps: real
    slots ending early, padding windows mid-row, all-padding rows, k > 32
    (the slot-by-slot branch) and repeated columns (every fifth operand
    row, the broadcast fallback; at k == dim every fifth row repeats
    column 0).  One launch a call."""
    b, n_src = _wide_slab(r, e, r * 1000 + e, cuda)
    xv, xi = _learnable_operand(n_src, k, dim, k, cuda,
                                cols="repeat" if k == dim else None)
    before = tk.drspmm_fwd_bucket.launches
    y = tk.drspmm_fwd_bucket(b, xv, xi, dim)
    torch.cuda.synchronize()
    assert tk.drspmm_fwd_bucket.launches == before + 1
    assert_close(y.cpu().numpy(), tk.drspmm_fwd_bucket_plain(
        b, xv, xi, dim).cpu().numpy())


@pytest.mark.parametrize("r,e", [(40, 260), (1696, 256)])
def test_bucket_fwd_kernel_deterministic(cuda, r, e):
    """The split rows' partial sums are added in a fixed order: two calls
    on a 40 x 260 slab (and on a 1696 x 256 one) give bit-identical
    outputs."""
    b, n_src = _wide_slab(r, e, 7, cuda)
    xv, xi = _learnable_operand(n_src, 16, 64, 16, cuda)
    y1 = tk.drspmm_fwd_bucket(b, xv, xi, 64)
    y2 = tk.drspmm_fwd_bucket(b, xv, xi, 64)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)


WIDE_SLAB_R = [1, 3, 40]
WIDE_SLAB_E = [33, 64, 78, 256, 260, 300, 1000]


@pytest.mark.parametrize("dim", [1, 33, 64, 96, 256])
@pytest.mark.parametrize("e", WIDE_SLAB_E)
@pytest.mark.parametrize("r", WIDE_SLAB_R)
def test_spmm_bucket_kernel_wide_slabs(cuda, r, e, dim):
    """Kernel 12 on slabs whose rows it splits over several warps (E > 32):
    real slots ending early, padding windows mid-row, all-padding rows.
    One launch a call."""
    b, n_src = _wide_slab(r, e, r * 1000 + e, cuda)
    x = torch.randn((n_src, dim),
                    generator=torch.Generator().manual_seed(dim)).to(cuda)
    before = tk.spmm_bucket.launches
    y = tk.spmm_bucket(b, x)
    torch.cuda.synchronize()
    assert tk.spmm_bucket.launches == before + 1
    assert_close(y.cpu().numpy(), tk.spmm_bucket_plain(b, x).cpu().numpy())


def _sampled_columns(r, k, dim, seed, device):
    """(xi_rows (r, k) int32, the mask of its columns outside [0, dim)):
    random columns, every third row with one at -1 and one at dim + 7
    (they sample nothing), every fourth row repeating its first column."""
    rng = np.random.default_rng(seed)
    xi = rng.integers(0, dim, (r, k))
    xi[::3, 0] = -1
    xi[::3, -1] = dim + 7
    if k > 2:
        xi[1::4, 2] = xi[1::4, 1]
    xi = torch.from_numpy(xi.astype(np.int32))
    return xi.to(device), ((xi < 0) | (xi >= dim)).to(device)


def _bwd_ref(b, gy, xi_rows, outside):
    """Kernel 11's plain version with the columns outside [0, dim)
    contributing 0, as the kernel reads them."""
    ref = tk.drspmm_bwd_bucket_plain(
        b, gy, xi_rows.clamp(0, gy.shape[1] - 1))
    return ref.masked_fill(outside, 0.0)


@pytest.mark.parametrize("k", [1, 5, 16, 32, 40, 64])
@pytest.mark.parametrize("e", WIDE_SLAB_E)
@pytest.mark.parametrize("r", WIDE_SLAB_R)
def test_bucket_bwd_kernel_wide_slabs(cuda, r, e, k):
    """Kernel 11 on the slabs of ``test_spmm_bucket_kernel_wide_slabs``
    at k 1-32 (the narrow walk) and 40, 64 (the wide one), with columns
    outside the operand and repeated columns.  One launch a call."""
    b, n_src = _wide_slab(r, e, r * 1000 + e, cuda)
    gy = torch.randn((n_src, 64),
                     generator=torch.Generator().manual_seed(k)).to(cuda)
    xi_rows, outside = _sampled_columns(r, k, 64, k + e, cuda)
    before = tk.drspmm_bwd_bucket.launches
    dv = tk.drspmm_bwd_bucket(b, gy, xi_rows)
    torch.cuda.synchronize()
    assert tk.drspmm_bwd_bucket.launches == before + 1
    assert_close(dv.cpu().numpy(),
                 _bwd_ref(b, gy, xi_rows, outside).cpu().numpy())


DETERMINISTIC_SLABS = [(40, 260), (144, 78), (1696, 256), (7568, 64)]


@pytest.mark.parametrize("r,e", DETERMINISTIC_SLABS)
def test_spmm_bucket_kernel_deterministic(cuda, r, e):
    """Kernel 12's split rows are added in a fixed order: two calls give
    bit-identical outputs at the main path's bucket shapes."""
    b, n_src = _wide_slab(r, e, 7, cuda)
    x = torch.randn((n_src, 64),
                    generator=torch.Generator().manual_seed(3)).to(cuda)
    y1 = tk.spmm_bucket(b, x)
    y2 = tk.spmm_bucket(b, x)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)


@pytest.mark.parametrize("r,e", DETERMINISTIC_SLABS)
def test_bucket_bwd_kernel_deterministic(cuda, r, e):
    """Kernel 11's split rows are added in a fixed order: two calls give
    bit-identical outputs at the main path's bucket shapes (k 16)."""
    b, n_src = _wide_slab(r, e, 7, cuda)
    gy = torch.randn((n_src, 64),
                     generator=torch.Generator().manual_seed(3)).to(cuda)
    xi_rows, _ = _sampled_columns(r, K, 64, 5, cuda)
    d1 = tk.drspmm_bwd_bucket(b, gy, xi_rows)
    d2 = tk.drspmm_bwd_bucket(b, gy, xi_rows)
    torch.cuda.synchronize()
    assert torch.equal(d1, d2)


@pytest.mark.parametrize("k_net", [K, HIDDEN])
def test_trainer_bucket_step_on_card_matches_cpu(cuda, k_net):
    """A single-graph ``backend="bucket"`` step on the card launches
    kernels 10/11 (and 12 for the dense net type at k_net = hidden) and
    none of the fused family, and matches the CPU step."""
    g = generate_design(1, "medium", SCALE)[:1]
    cfg = CircuitTrainConfig(hidden=HIDDEN, k_cell=K, k_net=k_net, lr=1e-3,
                             backend="bucket")
    gpu = CircuitTrainer(cfg, 16, 16, device=cuda)
    cpu_model = DRCircuitGNN(16, 16, HIDDEN, LAYERS, device="cpu")
    cpu_model.load_state_dict(gpu.model.state_dict())
    cpu = CircuitTrainer(cfg, 16, 16, model=cpu_model, device="cpu")
    fused = [tk.drspmm_fwd_arena, tk.drspmm_bwd_arena,
             tk.drspmm_dense_tier_fwd, tk.drspmm_dense_tier_bwd,
             tk.spmm_arena]
    bucket = [tk.drspmm_fwd_bucket, tk.drspmm_bwd_bucket, tk.spmm_bucket]
    before = [f.launches for f in fused + bucket]
    loss_gpu = gpu.train_epoch(g)
    loss_cpu = cpu.train_epoch(g)
    after = [f.launches for f in fused + bucket]
    assert after[:5] == before[:5]
    assert after[5] > before[5] and after[6] > before[6]
    assert (after[7] > before[7]) == (k_net == HIDDEN)
    assert abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu)
    for (n, p), q in zip(gpu.model.named_parameters(), cpu.params):
        _rel_close(p, q)


def test_run_fused_on_card_equals_sequential(cuda):
    g = generate_design(1, "medium", SCALE)[0]
    xc = torch.randn((g.n_cell, 64), device=cuda)
    xn = torch.randn((g.n_net, 64), device=cuda)
    fns = [lambda x, et=et: tops.spmm(g.edges[et].adj, g.edges[et].adj_t, x)
           for et in ("near", "pin", "pinned")]
    args = [(xc,), (xc,), (xn,)]
    seq = parallel.run_sequential(fns, args)
    fused = parallel.run_fused(fns, args)
    torch.cuda.synchronize()
    for a, b in zip(fused, seq):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# kernel 13 (flash attention) and the dense LM
# ---------------------------------------------------------------------------



@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("sq,sk,causal,q_offset", [
    (128, 128, True, 0), (1000, 1000, True, 0), (200, 200, False, 0),
    (128, 256, False, 0), (37, 101, True, 64), (1, 77, True, 76),
    (4096, 4096, True, 0)])
@pytest.mark.parametrize("h,kv", [(3, 3), (4, 2), (4, 1)])
def test_flash_kernel_matches_plain(cuda, dtype, hd, sq, sk, causal,
                                    q_offset, h, kv):
    """fp32 and bf16, ragged q and kv tails, a q offset, causal or not, k/v
    at KV < H heads (head h reads KV head h % KV), and S 4,096, where the
    bf16 kernel's K/V ring wraps many times."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(hd + sq + sk + kv)
    q, k, v = (torch.randn((2, s, n, hd), generator=g).to(cuda, dt)
               for s, n in ((sq, h), (sk, kv), (sk, kv)))
    before = flash_attention.flash_attention.launches
    out = flash_attention.flash_attention(q, k, v, causal=causal,
                                          q_offset=q_offset)
    ref = flash_attention.flash_attention_plain(q, k, v, causal=causal,
                                                q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.launches == before + 1
    assert out.dtype == dt and out.shape == q.shape
    if dt == torch.float32:
        assert_close(out.cpu().numpy(), ref.cpu().numpy())
    else:
        assert_bf16_close(out.float().cpu().numpy(),
                          ref.float().cpu().numpy())


def test_flash_kernel_rejects_unsupported(cuda):
    q = torch.zeros((1, 8, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        flash_attention.flash_attention(q, q, q)
    q = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="q_offset"):
        flash_attention.flash_attention(q, q, q, q_offset=-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_rejects_kv_heads_not_dividing(cuda, dtype):
    """H % KV != 0 raises before any launch."""
    dt = getattr(torch, dtype)
    q = torch.zeros((1, 8, 4, 64), device=cuda, dtype=dt)
    k = torch.zeros((1, 8, 3, 64), device=cuda, dtype=dt)
    before = flash_attention.flash_attention.launches
    with pytest.raises(ValueError, match="KV head count"):
        flash_attention.flash_attention(q, k, k)
    assert flash_attention.flash_attention.launches == before


BWD_SHAPES = [(128, 128, True, 0), (200, 200, False, 0), (37, 101, True, 64),
              (1000, 1000, True, 0), (64, 300, False, 0), (1, 77, True, 76)]


def _bwd_case(cuda, dt, hd, sq, sk, h, kv, causal, q_offset, seed):
    """Seeded q/k/v/dO on the card and the plain forward's o and lse."""
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn((2, s, n, hd), generator=g).to(cuda, dt)
                   for s, n in ((sq, h), (sk, kv), (sk, kv), (sq, h)))
    o, lse = flash_attention.flash_attention_plain(
        q, k, v, causal=causal, q_offset=q_offset, return_lse=True)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("sq,sk,causal,q_offset", BWD_SHAPES)
@pytest.mark.parametrize("h,kv", [(3, 3), (4, 2), (4, 1)])
def test_flash_bwd_kernel_matches_plain(cuda, dtype, hd, sq, sk, causal,
                                        q_offset, h, kv):
    """Kernel 13b against ``flash_attention_bwd_plain`` on the same q, k,
    v, o, lse and dO: fp32 as the fp32 kernels (another summation order),
    bf16 within one bf16 ulp of each element plus the fp32 slack (each
    side rounds one fp32 sum), dk/dv at the KV heads."""
    dt = getattr(torch, dtype)
    args = _bwd_case(cuda, dt, hd, sq, sk, h, kv, causal, q_offset,
                     hd + sq + sk + kv)
    before = flash_attention.flash_attention_bwd.launches
    got = flash_attention.flash_attention_bwd(*args, causal=causal,
                                              q_offset=q_offset)
    ref = flash_attention.flash_attention_bwd_plain(*args, causal=causal,
                                                    q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention_bwd.launches == before + 1
    for name, a, b, t in zip(("dq", "dk", "dv"), got, ref, args[:3]):
        assert a.dtype == dt and a.shape == t.shape, name
        if dt == torch.float32:
            assert_close(a.cpu().numpy(), b.cpu().numpy(), name)
        else:
            assert_bf16_close(a.float().cpu().numpy(),
                              b.float().cpu().numpy(), name)


@pytest.mark.parametrize("hd", [32, 64, 128])
def test_flash_bwd_bf16_is_deterministic_and_refuses_misaligned(cuda, hd):
    """bf16 kernel 13b: two launches on the same inputs give bit-equal dq,
    dk and dv (no atomics: every element has one owner); a q view two
    bytes off a 16-byte boundary (TMA takes 16-byte aligned bases) raises
    without counting a launch, and the next launch runs as before."""
    args = _bwd_case(cuda, torch.bfloat16, hd, 1000, 1000, 4, 2, True, 0,
                     11 + hd)
    first = flash_attention.flash_attention_bwd(*args)
    again = flash_attention.flash_attention_bwd(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    q = args[0]
    buf = torch.empty(q.numel() + 8, dtype=q.dtype, device=cuda)
    shifted = buf[1:1 + q.numel()].view(q.shape)
    shifted.copy_(q)
    before = flash_attention.flash_attention_bwd.launches
    with pytest.raises(RuntimeError, match="misaligned"):
        flash_attention.flash_attention_bwd(shifted, *args[1:])
    assert flash_attention.flash_attention_bwd.launches == before
    after = flash_attention.flash_attention_bwd(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, after):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("sq,sk,causal,q_offset", BWD_SHAPES)
def test_flash_lse_matches_plain(cuda, dtype, hd, sq, sk, causal, q_offset):
    """The forward's log-sum-exp (the backward's input) against the plain
    version's, and its output bit for bit the same as without the lse
    buffer (a null pointer: every serving launch)."""
    dt = getattr(torch, dtype)
    q, k, v, _, lse_ref, _ = _bwd_case(cuda, dt, hd, sq, sk, 4, 2, causal,
                                       q_offset, hd * sq)
    before = flash_attention.flash_attention.launches
    out, lse = flash_attention._forward(q, k, v, causal, q_offset,
                                        with_lse=True)
    plain_out = flash_attention.flash_attention(q, k, v, causal=causal,
                                                q_offset=q_offset)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.launches == before + 2
    assert lse.shape == (2, 4, sq) and lse.dtype == torch.float32
    assert_close(lse.cpu().numpy(), lse_ref.cpu().numpy())
    assert torch.equal(out.view(torch.int16 if dt == torch.bfloat16
                                else torch.int32),
                       plain_out.view(torch.int16 if dt == torch.bfloat16
                                      else torch.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,h,kv", [(64, 4, 4), (128, 8, 1)])
def test_flash_cross_attention_matches_plain(cuda, dtype, hd, h, kv):
    """Cross-attention's shapes (whisper's decoder over 1,500 frames: Sq
    448, Sk 1,500, not a multiple of the 64- or 128-key tile; non-causal;
    MHA at hd 64 and 8:1 GQA at hd 128 as the VLM's): kernel 13's output
    and lse and kernel 13b's dq/dk/dv against the plain versions, one
    launch each, at the limits of the tests above."""
    dt = getattr(torch, dtype)
    q, k, v, o, lse_ref, do = _bwd_case(cuda, dt, hd, 448, 1500, h, kv,
                                        False, 0, 5 + hd + kv)
    f0 = flash_attention.flash_attention.launches
    b0 = flash_attention.flash_attention_bwd.launches
    out, lse = flash_attention._forward(q, k, v, False, 0, with_lse=True)
    got = flash_attention.flash_attention_bwd(q, k, v, o, lse_ref, do,
                                              causal=False)
    ref = flash_attention.flash_attention_bwd_plain(q, k, v, o, lse_ref, do,
                                                    causal=False)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.launches == f0 + 1
    assert flash_attention.flash_attention_bwd.launches == b0 + 1
    close = assert_close if dt == torch.float32 else assert_bf16_close
    close(out.float().cpu().numpy(), o.float().cpu().numpy(), "o")
    assert_close(lse.cpu().numpy(), lse_ref.cpu().numpy(), "lse")
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        close(a.float().cpu().numpy(), b.float().cpu().numpy(), name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_autograd_on_card_matches_cpu(cuda, dtype):
    """``chunked_attention`` under autograd on the card (kernels 13 and 13b)
    against the same on the CPU (the plain versions): fp32 within
    ``assert_close``; bf16 output within one bf16 ulp plus the fp32 slack,
    bf16 gradients within 1e-2 relative L2 (each side's o is one bf16
    rounding of its own fp32 sum, up to an ulp apart, and feeds
    D = rowsum(dO o), so the gradients are not one rounding apart)."""
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(7)
    base = [torch.randn((2, 300, n, 64), generator=g).to(dt)
            for n in (4, 2, 2)]
    do = torch.randn((2, 300, 4, 64), generator=g).to(dt)
    grads = {}
    for dev in ("cpu", cuda):
        x = [t.detach().to(dev).requires_grad_() for t in base]
        out = lm_attention.chunked_attention(*x, causal=True)
        out.backward(do.to(dev))
        grads[str(dev)] = [out.detach().cpu()] + [t.grad.cpu() for t in x]
    for i, (a, b) in enumerate(zip(grads[str(cuda)], grads["cpu"])):
        if dt == torch.float32:
            assert_close(a.numpy(), b.numpy())
        elif i == 0:
            assert_bf16_close(a.float().numpy(), b.float().numpy())
        else:
            _rel_close(a.float(), b.float(), rtol=1e-2)


def test_lm_train_step_on_card_matches_cpu(cuda):
    """Two steps of ``make_train_step`` on the reduced qwen3-0.6b in fp32
    (remat on) from the same weights and batches: losses, grad norms and
    parameters within 1e-4 relative; kernel 13 twice a layer a step (the
    forward and its recompute), 13b once."""
    lm, cpu = _lm_pair(cuda)
    batch = {k: torch.from_numpy(v.astype(np.int64)) for k, v in
             TokenPipeline(DataConfig(vocab=lm.cfg.vocab, seq_len=64,
                                      global_batch=2)).global_batch(0).items()}
    out = {}
    for model, dev in ((lm, cuda), (cpu, "cpu")):
        state = lm_step.TrainState(model.params(),
                                   adamw_init(model.params()))
        step = lm_step.make_train_step(model, lr=1e-3, total_steps=10)
        f0 = flash_attention.flash_attention.launches
        b0 = flash_attention.flash_attention_bwd.launches
        metrics = [step(state, {k: v.to(dev) for k, v in batch.items()})[1]
                   for _ in range(2)]
        out[str(dev)] = (metrics, state)
        if dev != "cpu":
            n = lm.cfg.n_layers
            assert flash_attention.flash_attention.launches - f0 == 4 * n
            assert flash_attention.flash_attention_bwd.launches - b0 == 2 * n
    (m_gpu, s_gpu), (m_cpu, s_cpu) = out[str(cuda)], out["cpu"]
    for a, b in zip(m_gpu, m_cpu):
        _rel_close(a["loss"], b["loss"])
        _rel_close(a["grad_norm"], b["grad_norm"])
    for a, b in zip(tree_leaves(s_gpu.params), tree_leaves(s_cpu.params)):
        _rel_close(a, b)


def _lm_pair(cuda, dtype="float32"):
    cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b")), dtype=dtype)
    lm = build_lm(cfg, device=cuda)
    lm.init(torch.Generator(cuda).manual_seed(0))
    cpu = build_lm(cfg, device="cpu")
    cpu.load_state_dict(lm.state_dict())
    return lm, cpu


def test_lm_prefill_decode_on_card_matches_cpu(cuda):
    """The reduced qwen3-0.6b in fp32: prefill (2 launches of kernel 13, one
    a layer) and two decode steps (none) within 1e-4 relative L2 of the
    CPU, and the same greedy tokens."""
    lm, cpu = _lm_pair(cuda)
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, lm.cfg.vocab, (2, 40)))
    before = flash_attention.flash_attention.launches
    c_gpu, l_gpu = lm_serve.prefill(lm, lm.params(), tok.to(cuda))
    assert flash_attention.flash_attention.launches == before + 2
    c_cpu, l_cpu = lm_serve.prefill(cpu, cpu.params(), tok)
    _rel_close(l_gpu, l_cpu)
    _rel_close(c_gpu["k"], c_cpu["k"])
    for pos, t in ((39, tok[:, -1:]), (12, tok[:, :1])):
        c_gpu, l_gpu = lm_serve.decode_step(lm, lm.params(), c_gpu,
                                            t.to(cuda), pos)
        c_cpu, l_cpu = lm_serve.decode_step(cpu, cpu.params(), c_cpu, t, pos)
        _rel_close(l_gpu, l_cpu)
        assert torch.equal(l_gpu.argmax(-1).cpu(), l_cpu.argmax(-1))
    assert flash_attention.flash_attention.launches == before + 2


def test_lm_engine_on_card_matches_cpu(cuda):
    lm, cpu = _lm_pair(cuda)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, lm.cfg.vocab, n).tolist() for n in (3, 7, 5)]
    out = []
    for model, dev in ((lm, cuda), (cpu, "cpu")):
        eng = ServeEngine(model, model.params(), max_batch=2, s_max=32,
                          device=dev)
        rids = [eng.submit(p, 6) for p in prompts]
        res = eng.run()
        out.append([res[r].generated for r in rids])
    assert out[0] == out[1]


def test_lm_bf16_prefill_on_card(cuda):
    """bf16 on the card: finite logits, and decode at S-1 reproduces the
    prefill's last logits within 5e-2 relative L2."""
    lm, _ = _lm_pair(cuda, "bfloat16")
    tok = torch.from_numpy(np.random.default_rng(2).integers(
        0, lm.cfg.vocab, (2, 64))).to(cuda)
    cache, lp = lm_serve.prefill(lm, lm.params(), tok)
    assert cache["k"].dtype == torch.bfloat16 and torch.isfinite(lp).all()
    _, ld = lm_serve.decode_step(lm, lm.params(), cache, tok[:, -1:], 63)
    _rel_close(ld, lp, 5e-2)


# kernel 13 launches of a reduced family's prefill, and kernels 13 / 13b
# of one train step under remat (a rematted layer runs its forward twice;
# the hybrid's shared block runs outside remat, as the reference's)
FAMILY_FLASH = {"granite-moe-1b-a400m": (2, 4, 2),
                "moonshot-v1-16b-a3b": (2, 4, 2), "mamba2-1.3b": (0, 0, 0),
                "zamba2-1.2b": (1, 1, 1),
                "llama-3.2-vision-90b": (2, 4, 2),
                "whisper-large-v3": (6, 12, 6)}


@pytest.mark.parametrize("arch", list(FAMILY_FLASH))
def test_lm_family_on_card_matches_cpu(cuda, arch):
    """The reduced MoE, SSM, hybrid, VLM and audio LMs in fp32 from the
    same weights (the VLM's gates and whisper's biases drawn nonzero,
    seeded ``image_emb`` / ``frames``): prefill, three decode steps (no
    launch) and one ``make_train_step`` step within 1e-4 relative L2 of
    the CPU, the same greedy tokens, kernels 13 / 13b launched as
    ``FAMILY_FLASH`` says."""
    cfg = reduced(get_config(arch))
    lm = build_lm(cfg, device=cuda)
    draw_zero_inits(lm.init(torch.Generator(cuda).manual_seed(0)),
                    torch.Generator(cuda).manual_seed(1))
    cpu = build_lm(cfg, device="cpu")
    cpu.load_state_dict(lm.state_dict())
    n_pre, n_fwd, n_bwd = FAMILY_FLASH[arch]
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 32)))
    extra = {k: torch.from_numpy(v)
             for k, v in lm_extras(cfg, (2,), seed=2).items()}
    on = lambda dev: {k: v.to(dev) for k, v in extra.items()} or None
    f0 = flash_attention.flash_attention.launches
    c_gpu, l_gpu = lm_serve.prefill(lm, lm.params(), tok.to(cuda), on(cuda))
    c_cpu, l_cpu = lm_serve.prefill(cpu, cpu.params(), tok, on("cpu"))
    _rel_close(l_gpu, l_cpu)
    for k in c_cpu:
        _rel_close(c_gpu[k], c_cpu[k])
    for step in range(3):
        t = tok[:, step:step + 1]
        c_gpu, l_gpu = lm_serve.decode_step(lm, lm.params(), c_gpu,
                                            t.to(cuda), 31 - step)
        c_cpu, l_cpu = lm_serve.decode_step(cpu, cpu.params(), c_cpu, t,
                                            31 - step)
        _rel_close(l_gpu, l_cpu)
        assert torch.equal(l_gpu.argmax(-1).cpu(), l_cpu.argmax(-1))
    assert flash_attention.flash_attention.launches - f0 == n_pre
    batch = {k: torch.from_numpy(v.astype(np.int64)) for k, v in
             TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=64,
                                      global_batch=2)).global_batch(0).items()}
    batch.update(extra)
    out = {}
    for model, dev in ((lm, cuda), (cpu, "cpu")):
        state = lm_step.TrainState(model.params(),
                                   adamw_init(model.params()))
        f0 = flash_attention.flash_attention.launches
        b0 = flash_attention.flash_attention_bwd.launches
        _, m = lm_step.make_train_step(model, lr=1e-3, total_steps=10)(
            state, {k: v.to(dev) for k, v in batch.items()})
        out[str(dev)] = (m, state)
        if dev != "cpu":
            assert flash_attention.flash_attention.launches - f0 == n_fwd
            assert flash_attention.flash_attention_bwd.launches - b0 == n_bwd
    (m_gpu, s_gpu), (m_cpu, s_cpu) = out[str(cuda)], out["cpu"]
    _rel_close(m_gpu["loss"], m_cpu["loss"])
    _rel_close(m_gpu["grad_norm"], m_cpu["grad_norm"])
    for a, b in zip(tree_leaves(s_gpu.params), tree_leaves(s_cpu.params)):
        _rel_close(a, b)


# ---------------------------------------------------------------------------
# quantized collation and captured serving
# ---------------------------------------------------------------------------

def _recording_engine(cfg, device, **kw):
    """An engine over a fresh model that records every dispatched batch
    with its dispatch record (its output's host copy once the record's
    event completes) and whether it was a replay, and counts its
    captures."""
    model = DRCircuitGNN(16, 16, HIDDEN, LAYERS, device=device)
    eng = CircuitServeEngine(model, cfg, max_batch=2, device=device, **kw)
    seen, captures = [], []
    dispatch, capture = eng._dispatch, eng._capture

    def rec_dispatch(prepared):
        entry = dispatch(prepared)
        seen.append((entry.batch, entry, entry.kind == "replay"))
        return entry

    def rec_capture(view, slot):
        captures.append(tcollate.graph_signature(view))
        return capture(view, slot)
    eng._dispatch, eng._capture = rec_dispatch, rec_capture
    return eng, seen, captures


def _out(entry):
    """A dispatched batch's output, read back from its host copy."""
    entry.done.synchronize()
    return entry.host


def _partition(n_cell, n_net, seed):
    coo, xc, xn, y = generate_partition(np.random.default_rng(seed),
                                        n_cell, n_net)
    return pack_graph_parallel(coo, n_cell, n_net, xc, xn, y)


def _assert_replays_are_eager(eng, seen):
    for _batch, entry, _replay in seen:
        with torch.inference_mode():
            ref = eng.model(entry.view, eng.cfg).cpu()
        assert torch.equal(_out(entry), ref)


@pytest.mark.parametrize("drelu_backend", ["topk", "bisect"])
def test_captured_replay_equals_eager(cuda, drelu_backend):
    """Served twice: each signature's first batch is served by the eager
    run before its capture, every later one by a replay of the captured
    graph, bit for bit the eager forward of the same collated batch; one
    capture per signature.  A replay counts the launches recorded in its
    graph on their wrappers; the capture counts none."""
    cfg = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K,
                         drelu_backend=drelu_backend)
    eng, seen, captures = _recording_engine(cfg, cuda)
    graphs = generate_design(0, "small", SCALE) \
        + generate_design(1, "medium", SCALE)
    fwd = (tk.drspmm_fwd_arena, tk.drspmm_dense_tier_fwd)
    counts = []
    for _ in range(2):
        before = sum(f.launches for f in fwd)
        for g in graphs:
            eng.submit(g)
        eng.run()
        counts.append(sum(f.launches for f in fwd) - before)
    _assert_replays_are_eager(eng, seen)
    sigs = {b.signature for b, _, _ in seen}
    assert len(captures) == eng.compiles == len(sigs)
    n = len(seen) // 2
    assert [r for _, _, r in seen] == [False] * n + [True] * n
    # the replays run the eager runs' forward launches
    assert counts[0] == counts[1] > 0


def test_same_signature_batches_match_their_own_eager(cuda):
    """Two batches of one signature with different contents: the second
    replays the first's graph and still matches its own eager forward
    (the kernels' schedules are rebuilt inside the graph), as does the
    first batch served again after it."""
    cfg = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K)
    eng, seen, captures = _recording_engine(cfg, cuda)
    pairs = [[_partition(200, 100, 2 * i), _partition(200, 100, 2 * i + 1)]
             for i in range(2)]
    for pair in pairs + pairs[:1]:
        for g in pair:
            eng.submit(g)
        eng.run()
    assert len(seen) == 3 and len(captures) == eng.compiles == 1
    assert [r for _, _, r in seen] == [False, True, True]
    assert seen[0][0].signature == seen[1][0].signature
    assert not torch.equal(_out(seen[0][1]), _out(seen[1][1]))
    assert torch.equal(_out(seen[0][1]), _out(seen[2][1]))
    _assert_replays_are_eager(eng, seen)


def test_eviction_recaptures(cuda):
    """With one live bucket, serving buckets A, B, A evicts twice and
    captures three times; every replay matches its eager forward."""
    cfg = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K)
    eng, seen, captures = _recording_engine(cfg, cuda, max_live_buckets=1)
    for n_cell, n_net, seed in ((60, 30, 0), (240, 110, 1), (61, 29, 2)):
        eng.submit(_partition(n_cell, n_net, seed))
        eng.run()
    assert (eng.compiles, eng.evictions, eng.live_buckets) == (3, 2, 1)
    assert len(captures) == 3 and len(eng._buckets) == 1
    _assert_replays_are_eager(eng, seen)


def test_prefetch_eviction_keeps_no_stale_state(cuda):
    """Alternating buckets through one ``run()`` with one live bucket: the
    packing pool evicts a bucket while its batch waits for dispatch; that
    batch replays a graph its bucket holds or runs eagerly, every output
    is its batch's eager forward, and no evicted bucket's state (nor its
    graphs) outlives the run."""
    cfg = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K)
    eng, seen, captures = _recording_engine(cfg, cuda, max_live_buckets=1)
    sizes = [(60, 30), (240, 110)] * 3
    for i, (n_cell, n_net) in enumerate(sizes):
        for j in range(2):
            eng.submit(_partition(n_cell, n_net, 10 * i + j))
    done = eng.run()
    assert all(r.error is None for r in done.values())
    assert len(seen) == len(sizes) and eng.evictions > 0
    assert len(eng._buckets) <= 1 and eng.live_buckets == 1
    assert eng.compiles == len(captures)
    _assert_replays_are_eager(eng, seen)


@pytest.mark.parametrize("k,dim", [(8, 32), (16, 64), (40, 64)])
def test_padded_arena_kernels_match_exact(cuda, k, dim):
    """Kernels 1 and 4 over a quantized batch's super-arenas give the
    exact-size batch's real rows bit for bit: the walks skip the padding
    chunks (narrow walk at k <= 32, wide above)."""
    gs = generate_design(1, "medium", SCALE)[:2]
    exact = tcollate.collate_graphs(gs, quantize=False, device=cuda)
    padded = tcollate.collate_graphs(gs, device=cuda)
    for a, b in padded_and_exact_rows(exact, padded, k, dim=dim):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kw", [dict(backend="bucket"), dict(use_plan=False)])
def test_batched_serial_step_on_card_matches_cpu(cuda, kw):
    """One batched step under ``backend="bucket"`` / ``use_plan=False`` on
    the card against the same step on the CPU: it runs kernels 1 and 4
    over the collated arenas and no per-bucket kernel."""
    gs = generate_design(1, "medium", SCALE)[:2]
    cfg = CircuitTrainConfig(hidden=HIDDEN, k_cell=K, k_net=K, lr=1e-3,
                             batch_size=2, **kw)
    gpu = CircuitTrainer(cfg, 16, 16, device=cuda)
    cpu = CircuitTrainer(cfg, 16, 16, device="cpu")
    cpu.model.load_state_dict(gpu.model.state_dict())
    names = ("drspmm_fwd_arena", "drspmm_bwd_arena", "drspmm_fwd_bucket",
             "drspmm_bwd_bucket", "spmm_bucket")
    for n in names:
        setattr(getattr(tk, n), "launches", 0)
    lg = gpu.train_epoch(gs)
    launched = {n: getattr(tk, n).launches for n in names}
    lc = cpu.train_epoch(gs)
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    for pg, pc in zip(gpu.model.parameters(), cpu.model.parameters()):
        d = (pg.detach().cpu() - pc.detach()).norm()
        assert d <= 1e-4 * pc.detach().norm()
    assert launched["drspmm_fwd_arena"] > 0
    assert launched["drspmm_bwd_arena"] > 0
    assert not any(launched[n] for n in names[2:])


@pytest.mark.parametrize("k", [8, 32])
def test_learnable_kernels_on_collated_arenas(cuda, k):
    """Kernels 7-9 over a quantized batch's ``near`` edge-id arenas, whose
    weight vector is padded past the real edges: each against its plain
    version (the padding ids' weight gradient is zero)."""
    gs = generate_design(1, "medium", SCALE)[:2]
    batch = tcollate.collate_graphs(gs, with_eids=True, device=cuda)
    es, nnz = batch.graph.edges["near"], batch.edge_nnz["near"]
    assert nnz > batch.edge_nnz_exact["near"]
    g = torch.Generator().manual_seed(3)
    w = (torch.rand(nnz, generator=g) + 0.1).to(cuda)
    n = batch.graph.n_cell
    x = torch.randn((n, HIDDEN), generator=g).to(cuda)
    xi = torch.sort(torch.topk(x, k, dim=1).indices, dim=1).values.to(
        torch.int32).contiguous()
    xv = torch.gather(x, 1, xi.long()).contiguous()
    gy = torch.randn((n, HIDDEN), generator=g).to(cuda)
    for kern, plain in (
            (lambda: tk.drspmm_fwd_learnable(es.adj, nnz, w, xv, xi, HIDDEN),
             lambda: tk.drspmm_fwd_learnable_plain(es.adj, nnz, w, xv, xi,
                                                   HIDDEN)),
            (lambda: tk.drspmm_bwd_learnable(es.adj_t, nnz, w, gy, xi),
             lambda: tk.drspmm_bwd_learnable_plain(es.adj_t, nnz, w, gy, xi)),
            (lambda: tk.drspmm_dw_learnable(es.adj, nnz, gy, xv, xi),
             lambda: tk.drspmm_dw_learnable_plain(es.adj, nnz, gy, xv, xi))):
        out, ref = kern(), plain()
        assert_close(out.cpu().numpy(), ref.cpu().numpy())


# ---------------------------------------------------------------------------
# online serving
# ---------------------------------------------------------------------------

def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                 b.view(np.int32))


def _pinned_layout(plan):
    """A bucket layout that pins ``plan``'s relation tiers and chunk
    widths."""
    return tcollate.BucketLayout(
        plan_tier={s.etype: s.tier for s in plan.segments},
        plan_chunk={"fwd": plan.fwd.chunk, "bwd": plan.bwd.chunk})


def _alone(eng, model, g, served, head=None):
    """The eager forward of ``g`` alone (with the engine's filler) on the
    card, under the tiers and chunk widths of the batch ``served`` that
    served it: ``g``'s rows on the host."""
    batch = tcollate.collate_graphs(
        [g] * eng.b if eng.pad_to_full else [g], node_bits=eng.node_bits,
        arena_bits=eng.arena_bits, layout=_pinned_layout(served.plan),
        n_real=1, with_edges=False, device=eng.device)
    with torch.inference_mode():
        out = model(batch.graph, eng.cfg, head=head)
    return out[:g.n_cell].cpu().numpy()


def _record_batches(eng):
    """request id -> the collated batch of its last dispatch."""
    served = {}
    dispatch = eng._dispatch

    def rec(prepared):
        entry = dispatch(prepared)
        for r in entry.reqs:
            served[r.rid] = entry.batch
        return entry
    eng._dispatch = rec
    return served


def _serve_thread(eng):
    import threading
    box = {}

    def run():
        try:
            eng.serve_forever()
        except BaseException as e:           # re-raised by the test
            box["exc"] = e
    t = threading.Thread(target=run)
    t.start()
    return t, box


def _member_rows(pair, i, k, device):
    """Kernel 1 over the batch ``pair`` (one pinned layout, all relations
    on the arena tier) with a seeded CBSR operand whose rows of member
    ``i`` depend only on that member: member ``i``'s output rows of every
    relation, on the host."""
    layout = tcollate.BucketLayout(
        plan_tier={et: "arena" for et in EDGE_TYPES},
        plan_chunk={"fwd": 8, "bwd": 8})
    batch = tcollate.collate_graphs(pair, layout=layout, device=device)
    plan, m = batch.plan, batch.members[i]
    x = np.random.default_rng(5).normal(
        size=(plan.n_src_total, HIDDEN)).astype(np.float32)
    rg = np.random.default_rng(6)
    for t, off in zip(plan.src_types, plan.src_off):
        o, n = (m.cell_off, m.n_cell) if t == "cell" else (m.net_off, m.n_net)
        x[off + o:off + o + n] = rg.normal(size=(n, HIDDEN))
    xi = np.sort(np.argsort(-x, axis=1, kind="stable")[:, :k],
                 axis=1).astype(np.int32)
    xv = np.take_along_axis(x, xi, axis=1)
    y = tk.drspmm_fwd_arena(plan.fwd, torch.from_numpy(xv).to(device),
                            torch.from_numpy(xi).to(device), HIDDEN)
    y = y[plan.fwd.gather.long()].cpu().numpy()
    rows = []
    for sg in plan.arena_segments:
        o, n = (m.cell_off, m.n_cell) if sg.dst_type == "cell" \
            else (m.net_off, m.n_net)
        rows.append(y[sg.arena_out_off + o:sg.arena_out_off + o + n])
    return np.concatenate(rows)


@pytest.mark.parametrize("k", [16, 40])
def test_arena_fwd_rows_ignore_companions(cuda, k):
    """Kernel 1 over a batch [h, g] and over [g, g] under one pinned
    layout: g's rows sit in other row-blocks, beside other rows, and their
    blocks' chunk runs have other lengths, yet they come out bit for bit
    the same (the walks split a run among warps by slot position, never
    by the run's length), as the healing ladder's bisection needs.  k 40
    runs the wide walk."""
    gs = generate_design(0, "small", SCALE) + generate_design(1, "medium",
                                                              SCALE)

    def max_deg(g):
        d, _s, _w = ell_to_coo(g.edges["near"].adj)
        return int(np.bincount(d).max())
    gs = sorted(gs, key=max_deg)
    g, h = gs[0], gs[-1]
    assert max_deg(h) > max_deg(g)
    alone = _member_rows([g, g], 0, k, cuda)
    assert _bits_equal(_member_rows([h, g], 1, k, cuda), alone)
    assert _bits_equal(_member_rows([g, h], 0, k, cuda), alone)


def test_online_concurrent_producers_bit_equal(cuda):
    """Two producer threads submit while ``serve_forever`` serves over two
    slots on the card: every prediction is bit for bit the eager forward
    of its graph alone."""
    import threading
    cfg = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K)
    model = DRCircuitGNN(16, 16, HIDDEN, LAYERS, device=cuda)
    eng = CircuitServeEngine(model, cfg, max_batch=2, max_wait_ms=20.0,
                             devices=[cuda, cuda], device=cuda)
    served = _record_batches(eng)
    graphs = generate_design(0, "small", SCALE) + generate_design(
        1, "medium", SCALE)
    t, box = _serve_thread(eng)
    out = {}

    def produce(gs):
        for g in gs:
            out[eng.submit(g)] = g
    try:
        ps = [threading.Thread(target=produce, args=(graphs[i::2] * 2,))
              for i in range(2)]
        for p in ps:
            p.start()
        for p in ps:
            p.join()
        preds = {rid: eng.result(rid, timeout=600.0).pred for rid in out}
    finally:
        eng.stop()
        t.join(timeout=600.0)
    assert "exc" not in box
    assert len(preds) == 2 * len(graphs)
    for rid, g in out.items():
        assert _bits_equal(preds[rid], _alone(eng, model, g, served[rid]))
    st = eng.stats()
    assert st["failures"] == 0 and all(st["dispatches_per_device"])


def test_online_heads_and_swap_add_no_capture(cuda):
    """One graph under the default head, two registered heads and, after
    a hot swap, again: one capture (one signature, one slot); every
    result carries the version and head it was served with and is bit for
    bit the eager forward under those weights.  Then a swap while requests
    are in flight: each result's version tells its weights."""
    cfg = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K)
    model = DRCircuitGNN(16, 16, HIDDEN, LAYERS, device=cuda)
    model_b = DRCircuitGNN(16, 16, HIDDEN, LAYERS, device=cuda,
                           generator=torch.Generator().manual_seed(1))
    eng = CircuitServeEngine(model, cfg, max_batch=2, device=cuda)
    served = _record_batches(eng)
    gen = torch.Generator().manual_seed(2)
    heads = {h: (torch.rand((HIDDEN, 1), generator=gen),
                 torch.rand((1,), generator=gen)) for h in ("a", "b")}
    for h, (w, b) in heads.items():
        eng.register_head(h, w, b)
    g = generate_design(1, "medium", SCALE)[0]
    rids = []
    for head in (None, "a", "b"):
        rids.append((eng.submit(g, head=head), head))
        eng.run()
    assert eng.update_params(model_b) == 1
    for head in ("a", None):
        rids.append((eng.submit(g, head=head), head))
        eng.run()
    assert eng.compiles == 1
    models = {0: model, 1: model_b}
    for i, (rid, head) in enumerate(rids):
        r = eng.result(rid)
        assert r.params_version == (0 if i < 3 else 1) and r.head == head
        hp = None if head is None else tuple(x.to(cuda) for x in heads[head])
        assert _bits_equal(r.pred, _alone(eng, models[r.params_version], g,
                                          served[rid], hp))
    # a swap while requests are in flight
    t, box = _serve_thread(eng)
    try:
        stream = generate_design(0, "small", SCALE)
        mine = [eng.submit(x) for x in stream]
        assert eng.update_params(model) == 2
        mine += [eng.submit(x) for x in stream]
        res = [eng.result(rid, timeout=600.0) for rid in mine]
    finally:
        eng.stop()
        t.join(timeout=600.0)
    assert "exc" not in box
    assert {r.params_version for r in res} <= {1, 2}
    assert all(r.params_version == 2 for r in res[len(stream):])
    for r in res:
        m = model if r.params_version == 2 else model_b
        assert _bits_equal(r.pred, _alone(eng, m, r.graph, served[r.rid]))


def test_online_bisect_healthy_members_bit_equal(cuda):
    """A full batch of four with one malformed member: the ladder bisects
    it, only the malformed request fails, and the healthy members come
    back bit for bit as a fault-free engine serves them."""
    cfg = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K)
    model = DRCircuitGNN(16, 16, HIDDEN, LAYERS, device=cuda)
    graphs = [_partition(154, 82, 30 + i) for i in range(3)]
    poison = dataclasses.replace(graphs[0], x_cell=graphs[0].x_cell[:-1])
    clean = CircuitServeEngine(model, cfg, max_batch=4, device=cuda)
    ref = [clean.submit(x) for x in graphs]
    clean.run()
    eng = CircuitServeEngine(model, cfg, max_batch=4, max_retries=1,
                             retry_backoff_s=0.005, device=cuda)
    t, box = _serve_thread(eng)
    try:
        rids = [eng.submit(x) for x in (graphs[0], graphs[1], poison,
                                        graphs[2])]
        healthy = [rids[0], rids[1], rids[3]]
        for rid, rr in zip(healthy, ref):
            assert _bits_equal(eng.result(rid, timeout=600.0).pred,
                               clean.result(rr).pred)
        with pytest.raises(RuntimeError) as ei:
            eng.result(rids[2], timeout=600.0)
        assert isinstance(ei.value.__cause__, ValueError)
    finally:
        eng.stop()
        t.join(timeout=600.0)
    assert "exc" not in box
    st = eng.stats()
    assert st["bisects"] >= 1 and st["failures"] == 1


def test_online_kernel_error_raises(cuda, monkeypatch):
    """A kernel launch that returns a CUDA error is not healed: it fails
    the pending requests and raises out of ``serve_forever``, with no
    retry."""
    class _Refused:
        def drspmm_arena_fwd(self, *args):
            return 9                      # cudaErrorInvalidConfiguration

        def error_string(self, rc):
            return b"invalid configuration argument"
    monkeypatch.setattr(tk, "_arena_lib", lambda: _Refused())
    cfg = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K)
    model = DRCircuitGNN(16, 16, HIDDEN, LAYERS, device=cuda)
    eng = CircuitServeEngine(model, cfg, max_batch=2, max_wait_ms=5.0,
                             device=cuda)
    t, box = _serve_thread(eng)
    rid = eng.submit(generate_design(1, "medium", SCALE)[0])
    t.join(timeout=600.0)
    assert not t.is_alive()
    assert "CUDA error 9" in str(box.get("exc"))
    with pytest.raises(RuntimeError) as ei:
        eng.result(rid, timeout=1.0)
    assert "CUDA error 9" in str(ei.value.__cause__)
    st = eng.stats()
    assert st["retries"] == 0 and st["failures"] == 1


# ---------------------------------------------------------------------------
# sharded plans and data-parallel steps
# ---------------------------------------------------------------------------

_SHARD_KERNELS = ("drspmm_fwd_arena", "drspmm_bwd_arena",
                  "drspmm_dense_tier_fwd", "drspmm_dense_tier_bwd")


def _zero_launches(names):
    for n in names:
        getattr(tk, n).launches = 0
    return lambda: {n: getattr(tk, n).launches for n in names}


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_sharded_executor_on_card_matches_cpu(cuda, n):
    """``drspmm_multi_sharded`` with every shard on the card against its
    CPU run: outputs and per-type gradients, one launch of kernel 1 and of
    kernel 4 per shard, no dense-tier kernel (a sharded plan has none)."""
    from repro_torch.sharding.plan_shard import shard_relation_plan
    coo, xc, xn, y = generate_partition(np.random.default_rng(n), 400, 200)
    g = pack_graph_parallel(coo, 400, 200, xc, xn, y)
    splan = shard_relation_plan(relation_plan_of(g), n)
    ops_ = cbsr_operands(splan, {"cell": K, "net": K}, seed=n)
    gy = {s.etype: torch.randn((s.n_dst, HIDDEN),
                               generator=torch.Generator().manual_seed(7))
          for s in splan.segments}
    out = {}
    for dev in (cuda, torch.device("cpu")):
        sp = splan.to(dev)
        vals = {t: torch.from_numpy(v).to(dev).requires_grad_()
                for t, (v, _) in ops_.items()}
        read = _zero_launches(_SHARD_KERNELS)
        ys = tops.drspmm_multi_sharded(
            sp, {t: (vals[t], torch.from_numpy(i).to(dev))
                 for t, (_, i) in ops_.items()}, HIDDEN)
        torch.autograd.backward([ys[e] for e in gy],
                                [gy[e].to(dev) for e in gy])
        out[dev.type] = ({e: y.detach().cpu() for e, y in ys.items()},
                         {t: v.grad.cpu() for t, v in vals.items()}, read())
    (yg, gg, lg), (yc, gc, _) = out["cuda"], out["cpu"]
    assert lg == {"drspmm_fwd_arena": n, "drspmm_bwd_arena": n,
                  "drspmm_dense_tier_fwd": 0, "drspmm_dense_tier_bwd": 0}
    for e in yc:
        assert_close(yg[e].numpy(), yc[e].numpy(), e)
    for t in gc:
        assert_close(gg[t].numpy(), gc[t].numpy(), t)


def test_sharded_trainer_step_on_card_matches_cpu(cuda):
    """One ``n_shards=2`` step on a single graph on the card against the
    same step on the CPU: kernels 1 and 4 twice a layer, none of 2 and 5,
    and shard 0 on the trainer's card."""
    g = generate_design(1, "medium", SCALE)[0]
    cfg = CircuitTrainConfig(hidden=HIDDEN, k_cell=K, k_net=K, lr=1e-3,
                             n_shards=2)
    gpu = CircuitTrainer(cfg, 16, 16, device=cuda)
    cpu = CircuitTrainer(cfg, 16, 16, device="cpu")
    cpu.model.load_state_dict(gpu.model.state_dict())
    assert gpu._planned(g).plan.devices[0] == gpu.device
    read = _zero_launches(_SHARD_KERNELS)
    lg = gpu.train_epoch([g])
    launched = read()
    lc = cpu.train_epoch([g])
    assert launched == {"drspmm_fwd_arena": 2 * LAYERS,
                        "drspmm_bwd_arena": 2 * LAYERS,
                        "drspmm_dense_tier_fwd": 0,
                        "drspmm_dense_tier_bwd": 0}
    assert abs(lg - lc) <= 1e-4 * abs(lc)
    for pg, pc in zip(gpu.model.parameters(), cpu.model.parameters()):
        _rel_close(pg, pc)


def test_dp_step_on_card_matches_batched(cuda):
    """A data-parallel step over two slots of the card against the batched
    step over the same four members on the card."""
    gs = generate_design(1, "medium", SCALE)[:3] \
        + generate_design(0, "small", SCALE)[:1]
    cfg = CircuitTrainConfig(hidden=HIDDEN, k_cell=K, k_net=K, lr=1e-3)
    dp = CircuitTrainer(cfg, 16, 16, device=cuda)
    one = CircuitTrainer(cfg, 16, 16, device=cuda)
    one.model.load_state_dict(dp.model.state_dict())
    ld = dp.train_epoch(gs, batch_size=4, devices=[cuda, cuda])
    lo = one.train_epoch(gs, batch_size=4)
    assert len(dp._replicas) == 2
    assert abs(ld - lo) <= 1e-5 * abs(lo)
    for pa, pb in zip(dp.model.parameters(), one.model.parameters()):
        _rel_close(pa, pb, 1e-5)
