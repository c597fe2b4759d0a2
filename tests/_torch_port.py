"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages; JAX
stays on the CPU (its Pallas kernels run in interpret mode there)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

# Under pytest-xdist each worker takes its share of the cores for
# PyTorch's intra-op threads: at the default (every core in every
# worker) the workers' OpenMP threads wait on each other's cores, and a
# small model's training ran 30-60x slower than alone.  Every worker
# imports this module while it collects the suite.
_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "0"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // _WORKERS))

# small size of the parity tests: scale-0.02 Table-1 partitions, hidden 32,
# k 8, two layers
SCALE, HIDDEN, K, LAYERS = 0.02, 32, 8, 2


@pytest.fixture
def cuda():
    """Skip unless a CUDA card is visible (decided at run time, never at
    import, so every test worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def assert_close(actual, ref, msg=""):
    """fp32 parity where only the summation order differs: rtol 1e-5 and
    atol 1e-5 scaled by the reference's magnitude."""
    actual, ref = np.asarray(actual), np.asarray(ref)
    atol = 1e-5 * max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    np.testing.assert_allclose(actual, ref, rtol=1e-5, atol=atol,
                               err_msg=msg)


def assert_bf16_close(actual, ref, msg=""):
    """A bf16 output against a reference: every element within one bf16
    ulp of its reference value (each side rounds an fp32 result to bf16
    once), plus ``assert_close``'s fp32 slack (1e-5 scaled by the
    magnitude) for values near zero."""
    actual, ref = np.asarray(actual, np.float64), np.asarray(ref, np.float64)
    ulp = np.where(ref == 0, 0.0, np.ldexp(1.0, np.frexp(ref)[1] - 8))
    slack = 1e-5 * max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    excess = np.abs(actual - ref) - (ulp + slack)
    assert (excess <= 0).all(), (
        f"{msg} {int((excess > 0).sum())} elements beyond one bf16 ulp; "
        f"worst by {float(excess.max())}")


def lm_extras(cfg, lead, seed=0):
    """Seeded fp32 ``image_emb`` (VLM) or ``frames`` (audio) for a batch
    whose leading dims are ``lead``: one memory a sequence, shaped as the
    port's ``extra_input`` says, as numpy; {} for the other families."""
    from repro_torch.models.lm.model import extra_input
    spec = extra_input(cfg)
    if spec is None:
        return {}
    x = np.random.default_rng(seed).normal(size=(*lead, spec[1],
                                                 cfg.d_model))
    return {spec[0]: x.astype(np.float32)}


def nonzero_gates(params, seed=0):
    """A copy of a reference LM's parameter tree (numpy leaves) whose zero
    gates and biases the port's ``draw_zero_inits`` has drawn from
    ``seed``: the template makes them 0, and tanh(0) = 0 would leave the
    VLM's cross layer untested."""
    from repro_torch.models.lm.model import draw_zero_inits

    def to_torch(tree):
        return {k: to_torch(v) if isinstance(v, dict)
                else torch.from_numpy(np.array(v, np.float32))
                for k, v in tree.items()}

    def to_numpy(tree):
        return {k: to_numpy(v) if isinstance(v, dict) else v.numpy()
                for k, v in tree.items()}
    tree = to_torch(params)
    draw_zero_inits(tree, torch.Generator().manual_seed(seed))
    return to_numpy(tree)


def assert_fused_equal(a, b):
    """Port arena ``b`` has exactly the reference arena ``a``'s tables."""
    for f in ("nbr", "w", "block_of", "start", "rows", "gather", "rel"):
        x, y = getattr(a, f), getattr(b, f)
        if x is None:
            assert y is None, f
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    for f in ("n_dst", "n_src", "nnz", "row_block", "chunk"):
        assert getattr(a, f) == getattr(b, f), f


def assert_plan_equal(p, q):
    """Port plan ``q`` has exactly the reference plan ``p``'s tables."""
    assert_fused_equal(p.fwd, q.fwd)
    assert_fused_equal(p.bwd, q.bwd)
    for f in ("bwd_src_rows", "dense_fwd", "dense_bwd"):
        x, y = np.asarray(getattr(p, f)), np.asarray(getattr(q, f))
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert [dataclasses.astuple(s) for s in p.segments] == \
        [dataclasses.astuple(s) for s in q.segments]
    assert (p.src_types, p.src_off, p.src_sizes) == \
        (q.src_types, q.src_off, q.src_sizes)


def cbsr_operands(plan, k_of, seed=0, dim=HIDDEN):
    """Per-type CBSR operands ``{ntype: (vals, idx)}`` as numpy: the top
    ``k_of[t]`` of a seeded normal matrix per node type, idx ascending."""
    rng = np.random.default_rng(seed)
    out = {}
    for t, n in zip(plan.src_types, plan.src_sizes):
        x = rng.normal(size=(n, dim)).astype(np.float32)
        idx = np.sort(np.argsort(-x, axis=1, kind="stable")[:, :k_of[t]],
                      axis=1).astype(np.int32)
        out[t] = (np.take_along_axis(x, idx, axis=1), idx)
    return out


def drelu_rows(n, d, seed=0):
    """Seeded normal (n, d) float32 rows for the D-ReLU bisection, the hard
    cases first (as many as ``n`` holds): +-inf with ties at +inf; only
    +-inf (the first step's mid is NaN); ties straddling any threshold; a
    row of one value; a zero row; +0.0 and -0.0 with a few positives;
    small-integer ties; all negative; rows scaled by 1e10, 1e-10 and
    near the float maximum (lo + hi overflows); one finite value among
    -inf.  Every other remaining row is ReLU'd (many exact zeros)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    s = rng.normal(size=(13, d)).astype(np.float32)
    s[0, ::5] = np.inf
    s[0, 1::7] = -np.inf
    s[1] = -np.inf
    s[1, ::3] = np.inf
    s[2, :max(1, d // 2)] = 1.25
    s[3] = 0.5
    s[4] = 0.0
    s[5] = 0.0
    s[5, 1::3] = -0.0
    s[5, ::7] = np.abs(s[5, ::7])
    s[6] = np.round(2 * s[6])
    s[7] = -np.abs(s[7]) - 1.0
    s[8] *= 1e10
    s[9] *= 1e-10
    s[10] = rng.uniform(1e38, 3e38, size=d)
    s[11] = -np.inf
    s[11, d // 2] = 1.0
    s[12] = np.maximum(s[12], 0.0)
    m = min(n, len(s))
    x[:m] = s[:m]
    x[m::2] = np.maximum(x[m::2], 0.0)
    return x


def padded_and_exact_rows(exact, padded, k, dim=HIDDEN, seed=2):
    """Kernels 1 and 4 (through their wrappers) over an exact-size and a
    quantized collation of the same members, fed the same operands at the
    members' rows: [(padded rows, exact rows)] of every arena relation's
    forward output and source gradient, which must agree.  ``exact`` and
    ``padded`` are :class:`CollatedBatch` es on one device."""
    from repro_torch.kernels import drspmm as tk
    pe, pp = exact.plan, padded.plan
    dev = pe.fwd.nbr.device
    rows = {}
    for t, off, size in (("cell", "cell_off", "n_cell"),
                         ("net", "net_off", "n_net")):
        rows[t] = tuple(
            np.concatenate([getattr(m, off) + np.arange(getattr(m, size))
                            for m in b.members]) for b in (exact, padded))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(pe.n_src_total, dim)).astype(np.float32)
    xi = np.sort(np.argsort(-x, axis=1, kind="stable")[:, :k],
                 axis=1).astype(np.int32)
    xv = np.take_along_axis(x, xi, axis=1)
    xv_p = np.zeros((pp.n_src_total, k), np.float32)
    xi_p = np.zeros((pp.n_src_total, k), np.int32)
    for t, oe, op in zip(pe.src_types, pe.src_off, pp.src_off):
        e, p = rows[t]
        xv_p[op + p], xi_p[op + p] = xv[oe + e], xi[oe + e]
    gy = rng.normal(size=(pe.n_out_total, dim)).astype(np.float32)
    gy_p = np.zeros((pp.n_out_total, dim), np.float32)
    for se, sp in zip(pe.segments, pp.segments):
        e, p = rows[se.dst_type]
        gy_p[sp.out_off + p] = gy[se.out_off + e]
    t = lambda a: torch.from_numpy(a).to(dev)
    ye = tk.drspmm_fwd_arena(pe.fwd, t(xv), t(xi), dim)[pe.fwd.gather.long()]
    yp = tk.drspmm_fwd_arena(pp.fwd, t(xv_p), t(xi_p), dim)[
        pp.fwd.gather.long()]
    dve = tk.drspmm_bwd_arena(pe.bwd, pe.bwd_src_rows, t(gy), t(xi))[
        pe.bwd.gather.long()]
    dvp = tk.drspmm_bwd_arena(pp.bwd, pp.bwd_src_rows, t(gy_p), t(xi_p))[
        pp.bwd.gather.long()]
    out = []
    for se, sp in zip(pe.arena_segments, pp.arena_segments):
        e, p = rows[se.dst_type]
        out.append((yp[sp.arena_out_off + p], ye[se.arena_out_off + e]))
        e, p = rows[se.src_type]
        out.append((dvp[sp.src_out_off + p], dve[se.src_out_off + e]))
    return out
