"""PyTorch port on a card: each CUDA kernel against its plain PyTorch
version, the serve engine on the card against the port's CPU forward, one
training step on the card against the same step on the CPU (the D-ReLU
trainer, the dense-SpMM trainer, the serial per-bucket trainer and the
homogeneous baselines), the concurrent relation modules against the
sequential ones, and the flash-attention kernel (fp32 and bf16, k/v at
KV <= H heads, up to S 4,096) and the reduced dense LM (prefill, decode,
``ServeEngine``) on the card against the CPU.

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
from repro_torch.graphs.generator import generate_design
from repro_torch.kernels import drelu_topk, flash_attention
from repro_torch.kernels import drspmm as tk
from repro_torch.kernels import ops as tops
from repro_torch.models.hgnn import (HOMO_KINDS, DRCircuitGNN, HomoGNN,
                                     homo_forward, homogenize)
from repro_torch.models.lm import serve as lm_serve
from repro_torch.models.lm.model import build_lm
from repro_torch.serve.circuit_engine import CircuitServeEngine
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.circuit_trainer import (CircuitTrainConfig,
                                               CircuitTrainer)
from _torch_port import (HIDDEN, K, LAYERS, SCALE, assert_bf16_close,
                         assert_close, cbsr_operands,
                         cuda, drelu_rows)  # noqa: F401  (fixture)

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
