"""The PyTorch port stands alone: no module of ``src/repro_torch`` (nor
``chip_smoke.py`` or the arena probes in ``tools/``) imports JAX or the JAX
package, the serving and training stacks import with JAX unavailable,
entry points refuse to fall back to the CPU silently, and a kernel wrapper
given a CUDA tensor never runs its plain version."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core.hetero_mp import HeteroMPConfig
from repro_torch.graphs import collate as tcollate
from repro_torch.graphs.generator import generate_design
from repro_torch.configs import get_config, reduced
from repro_torch.kernels import drelu_topk, drspmm, flash_attention
from repro_torch.kernels import ops as tops
from repro_torch.models.hgnn import (DRCircuitGNN, HomoGNN, homogenize,
                                     learnable_edge_packing)
from repro_torch.models.lm import attention as lm_attention
from repro_torch.models.lm.model import build_lm
from repro_torch.serve.circuit_engine import CircuitServeEngine
from repro_torch.serve.engine import ServeEngine
from repro_torch.train.circuit_trainer import (CircuitTrainConfig,
                                               CircuitTrainer)
from _torch_port import cuda  # noqa: F401  (fixture)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"] \
    + sorted((ROOT / "tools").glob("*_probe.py"))


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_serving_stack_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.serve.circuit_engine, "
            "repro_torch.kernels.ops, repro_torch.models.hgnn; "
            "assert 'jax' not in {m.split('.')[0] for m, v in "
            "sys.modules.items() if v is not None}")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_training_stack_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.train.circuit_trainer, "
            "repro_torch.optim.schedules, repro_torch.kernels.learnable, "
            "repro_torch.core.parallel, repro_torch.sharding.plan_shard, "
            "repro_torch.launch.train, repro_torch.train.lm_step, "
            "repro_torch.checkpoint, repro_torch.data.pipeline; "
            "assert 'jax' not in {m.split('.')[0] for m, v in "
            "sys.modules.items() if v is not None}")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_entry_points_refuse_missing_card(monkeypatch):
    """With no card visible, the default device raises instead of running
    on the CPU behind the caller's back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = generate_design(0, "small", 0.02)[:1]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DRCircuitGNN(16, 16, 32, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcollate.collate_graphs(g)
    model = DRCircuitGNN(16, 16, 32, 2, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CircuitServeEngine(model, HeteroMPConfig(hidden=32, k_cell=8,
                                                 k_net=8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CircuitTrainer(CircuitTrainConfig(hidden=32), 16, 16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.resolve_device("cuda:0")
    adj, adj_t, x, _y, _n = homogenize(g[0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HomoGNN(x.shape[1], 32)
    # spmm and drspmm_learnable place their arenas through device_arena
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tops.device_arena(adj, "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tops.device_arena(adj, "cuda", eids=True)
    # and the serial path's bucket slabs and dense matrices theirs
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tops.device_buckets(adj, "cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tops.device_dense(adj, "cuda")


KERNEL_WRAPPERS = ("drspmm_fwd_arena", "drspmm_dense_tier_fwd",
                   "drspmm_bwd_arena", "drspmm_dense_tier_bwd", "spmm_arena",
                   "drspmm_fwd_learnable", "drspmm_bwd_learnable",
                   "drspmm_dw_learnable", "drspmm_fwd_bucket",
                   "drspmm_bwd_bucket", "spmm_bucket")


@pytest.mark.parametrize("name", KERNEL_WRAPPERS)
def test_wrapper_counts_launches(name):
    """Every kernel wrapper carries its launch counter (an int), and the
    plain version beside it that CPU tensors run."""
    assert isinstance(getattr(drspmm, name).launches, int)
    assert callable(getattr(drspmm, name + "_plain"))


@pytest.mark.cuda
def test_wrappers_never_run_plain_on_card(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")
    monkeypatch.setattr(drspmm, "drspmm_fwd_arena_plain", boom)
    monkeypatch.setattr(drspmm, "drspmm_dense_tier_fwd_plain", boom)
    monkeypatch.setattr(drspmm, "drspmm_bwd_arena_plain", boom)
    monkeypatch.setattr(drspmm, "drspmm_dense_tier_bwd_plain", boom)
    monkeypatch.setattr(drelu_topk, "drelu_bisect_plain", boom)
    for name in ("spmm_arena_plain", "drspmm_fwd_learnable_plain",
                 "drspmm_bwd_learnable_plain", "drspmm_dw_learnable_plain",
                 "drspmm_fwd_bucket_plain", "drspmm_bwd_bucket_plain",
                 "spmm_bucket_plain"):
        monkeypatch.setattr(drspmm, name, boom)
    batch = tcollate.collate_graphs(generate_design(0, "small", 0.02),
                                    device=cuda)
    plan = batch.plan
    n = plan.n_src_total
    rng = np.random.default_rng(0)
    xv = torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32)).to(cuda)
    xi = torch.from_numpy(np.sort(rng.choice(64, size=(n, 8)), axis=1)
                          .astype(np.int32)).to(cuda)
    drspmm.drspmm_fwd_arena(plan.fwd, xv, xi, 64)
    drspmm.drspmm_dense_tier_fwd(plan.dense_fwd, xv, xi, 64)
    gy = torch.randn(plan.n_out_total, 64, device=cuda)
    drspmm.drspmm_bwd_arena(plan.bwd, plan.bwd_src_rows, gy, xi)
    drspmm.drspmm_dense_tier_bwd(plan.dense_bwd,
                                 torch.randn(plan.dense_bwd.shape[1], 64,
                                             device=cuda), xi)
    drelu_topk.drelu_bisect(torch.randn(n, 64, device=cuda), 8)
    adj, adj_t, x, _y, _n = homogenize(generate_design(0, "small", 0.02)[0])
    x = torch.randn((adj.n_src, 64), device=cuda, requires_grad=True)
    tops.spmm(adj, adj_t, x).sum().backward()
    w = torch.rand(adj.nnz, device=cuda, requires_grad=True)
    xi = torch.arange(64, dtype=torch.int32,
                      device=cuda).expand(adj.n_src, 64).contiguous()
    fwd, bwd, *_rest, nnz = learnable_edge_packing(adj, cuda)
    tops.drspmm_learnable(fwd, bwd, nnz, w, x, xi, 64).sum().backward()
    tops.spmm(adj, adj_t, x, backend="bucket").sum().backward()
    v = torch.randn((adj.n_src, 8), device=cuda, requires_grad=True)
    vi = xi[:, :8].contiguous()
    tops.drspmm(adj, adj_t, v, vi, 64, backend="bucket").sum().backward()
    torch.cuda.synchronize()


def test_lm_stack_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.models.lm.serve, repro_torch.serve.engine, "
            "repro_torch.configs; "
            "assert 'jax' not in {m.split('.')[0] for m, v in "
            "sys.modules.items() if v is not None}")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_lm_entry_points_refuse_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = reduced(get_config("qwen3-0.6b"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_lm(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_lm(cfg, device="cuda")
    lm = build_lm(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(lm, lm.params(), max_batch=2, s_max=16)


def test_flash_wrapper_counts_launches():
    assert isinstance(flash_attention.flash_attention.launches, int)
    assert callable(flash_attention.flash_attention_plain)


def _fake_card(monkeypatch):
    """Make the flash wrappers take CPU tensors for card tensors, with
    every C entry replaced by a recorder (outputs stay uninitialised) and
    both plain versions refusing to run."""
    monkeypatch.setattr(flash_attention, "_on_card", lambda *ts: True)

    def boom(*a, **k):
        raise AssertionError("plain version called for a card tensor")
    monkeypatch.setattr(flash_attention, "flash_attention_plain", boom)
    monkeypatch.setattr(flash_attention, "flash_attention_bwd_plain", boom)
    calls = []
    monkeypatch.setattr(flash_attention, "_call",
                        lambda entry, *args, stream_of: calls.append(
                            (entry, args)))
    return calls


def test_flash_refuses_gradients_on_card(monkeypatch):
    """A card tensor that needs a gradient never reaches the plain
    versions: the forward launches kernel 13 with a log-sum-exp buffer and
    the backward launches kernel 13b, each counted once.  The device test
    is made to answer "card" for CPU tensors, so this runs here."""
    calls = _fake_card(monkeypatch)
    f0 = flash_attention.flash_attention.launches
    b0 = flash_attention.flash_attention_bwd.launches
    q = torch.zeros((1, 8, 2, 64), requires_grad=True)
    kv = torch.zeros((1, 8, 1, 64), requires_grad=True)
    out = lm_attention.chunked_attention(q, kv, kv)
    assert [e for e, _ in calls] == ["flash_attention_fwd"]
    assert calls[0][1][4] is not None            # the lse buffer
    out.backward(torch.ones_like(out))
    assert [e for e, _ in calls] == ["flash_attention_fwd",
                                     "flash_attention_bwd"]
    assert q.grad.shape == q.shape and kv.grad.shape == kv.shape
    out = flash_attention.flash_attention(q, kv.detach(), kv.detach())
    out.sum().backward()
    assert flash_attention.flash_attention.launches == f0 + 2
    assert flash_attention.flash_attention_bwd.launches == b0 + 2
    with torch.no_grad():                        # serving: no lse buffer
        flash_attention.flash_attention(q, kv, kv)
    assert calls[-1][0] == "flash_attention_fwd" and calls[-1][1][4] is None


def test_flash_remat_relaunches_forward_on_card(monkeypatch):
    """Under the LM's remat the backward re-runs the layer: kernel 13 twice
    (forward and recompute, both with lse), kernel 13b once, no plain
    version."""
    from repro_torch.models.lm.model import _maybe_remat
    calls = _fake_card(monkeypatch)
    q = torch.zeros((1, 8, 2, 32), requires_grad=True)
    for policy in ("full", "dots", "proj"):
        calls.clear()
        body = _maybe_remat(
            lambda x: lm_attention.chunked_attention(x, x[:, :, :1],
                                                     x[:, :, :1]) * 2,
            True, policy)
        body(q).sum().backward()
        assert [e for e, _ in calls] == ["flash_attention_fwd",
                                         "flash_attention_fwd",
                                         "flash_attention_bwd"], policy
        assert all(args[4] is not None for e, args in calls[:2])


@pytest.mark.cuda
def test_flash_never_runs_plain_on_card(cuda, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("plain version called for a CUDA tensor")
    monkeypatch.setattr(flash_attention, "flash_attention_plain", boom)
    q = torch.randn((2, 100, 4, 64), device=cuda, dtype=torch.bfloat16)
    before = flash_attention.flash_attention.launches
    flash_attention.flash_attention(q, q, q)
    lm_attention.chunked_attention(q, q, q, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.launches == before + 2
    monkeypatch.setattr(flash_attention, "flash_attention_bwd_plain", boom)
    x = q.float().requires_grad_()
    b0 = flash_attention.flash_attention_bwd.launches
    lm_attention.chunked_attention(x, q.float(), q.float()).sum().backward()
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.launches == before + 3
    assert flash_attention.flash_attention_bwd.launches == b0 + 1
    assert torch.isfinite(x.grad).all()
