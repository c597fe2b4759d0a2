"""What a change to the port moves against its parent, on one NVIDIA card:
the served Table-1 paths, the wide (k > 32) walks of kernels 1, 4, 7 and
8, and kernels 13 and 13b.  The script imports the ``repro_torch`` package found first on
``PYTHONPATH``, so one copy of it times either tree; compare two trees
within one call, in the order parent, change, change, parent:

    PYTHONPATH=<tree>/src python3 tools/tree_compare.py --label parent

It prints one JSON object a line:

* ``serve``: ``chip_smoke.py``'s served paths (hidden 64, 2 layers, k 16,
  ``max_batch=2``, seeded weights): Table-1 (the 5 partitions of
  ``generate_design(0, "small")`` + ``(1, "medium")`` at scale 1.0) under
  ``topk`` and ``bisect``, and the 9 scale-0.02 partitions under
  ``bisect``.  Each is served by a fresh engine twice (``cold``: every
  signature new; ``warm``: the same requests again): graphs/s, p50 and
  p95 ms of the pass's own requests;
* ``serve`` of ``table1-captured``: the Table-1 partitions and a jittered
  copy of each (node counts x U(0.9, 1.1), seeded), ``topk``, the
  ``serve-table1-captured`` stream of ``chip_smoke.py``: ``cold`` captures
  each signature, ``warm`` replays them;
* ``collate``: host ms of collating the first two Table-1 partitions as
  the serve engine does on the plan path (the tree's default arguments,
  and ``with_edges=False`` where the tree has it), each the best of 3;
* ``kernel``: kernels 1 and 4 over the exact-size super-arenas of that
  batch's relation plan with a seeded k = 64 CBSR operand (dim 128), and
  kernels 7 and 8 over the homogenized partition 0's edge-id arenas with
  the ``gat`` layer's k = dim = 64 operand (iota columns): ms a call by
  CUDA events (20 calls after 3 warm-ups) and by ``torch.profiler`` (the
  kernel's own device time, 50 calls), with the output's SHA-256, so the
  two trees' outputs can be held bit for bit; and kernel 1's narrow walk
  on the main path's shape: the quantized super-arena of that batch as
  the engine serves it, a seeded k = 16 operand, dim 64;
* ``kernel`` of kernels 13 and 13b at the qwen3-0.6b prefill's shape (B 4,
  S 1,024, H 16, KV 8, hd 64, bf16, causal) on seeded q/k/v/dO: kernel 13
  without an lse buffer (serving's launch) and with one (training's), and
  13b on that launch's o and lse: ms a call by CUDA events queued behind a
  sleep (``queued_ms``) and back to back, the profiler's device ms (and
  13b's by kernel), and the SHA-256 of every output (13b: dq, dk, dv).

* ``lm_train``: qwen3-0.6b training at ``chip_smoke.py``'s shape (28
  layers bf16, remat ``full``, B 4 x S 1,024, seeded weights, the token
  pipeline's batches): LM_STEPS steps of ``make_train_step``, each
  synchronised and timed on the host (p50 after the first), then one
  forward+backward under the profiler: its wall, the device's busy ms and
  share, and kernel 13b's device ms.

``--only gnn``, ``--only flash`` or ``--only lm`` runs one group.  Every
line carries the card's name and power limit as ``nvidia-smi``
reports them.
"""

import argparse
import hashlib
import json
import subprocess
import time

import torch

SEED, HIDDEN, LAYERS, K, FEAT = 0, 64, 2, 16, 16
LM_STEPS = 8
WIDE_K, WIDE_DIM = 64, 128
REPS, PROF_REPS = 20, 50


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def events_ms(fn) -> float:
    for _ in range(3):
        fn()
    a, b = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(REPS):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / REPS


def kernel_ms(fn, match: str):
    """Device ms a call of the device activities whose name holds
    ``match`` (the kernel), and of all of them (its output's fill and
    gather included), under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROF_REPS):
            fn()
        torch.cuda.synchronize()
    own = total = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            total += us
            own += us if match in e.name else 0.0
    return own / PROF_REPS / 1e3, total / PROF_REPS / 1e3


def queued_ms(fn, cycles=20_000_000) -> float:
    """Device ms of one ``fn()`` call: REPS calls, each between two CUDA
    events, queued behind a ``torch.cuda._sleep`` so that the host has
    issued all of them before the first runs; the sleep doubles until it
    outlasts the host's issue."""
    fn()
    while True:
        evs = [(torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True)) for _ in range(REPS)]
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        for a, b in evs:
            a.record()
            fn()
            b.record()
        ahead = not evs[0][0].query()
        torch.cuda.synchronize()
        if ahead or cycles >= 2 ** 31:
            return sum(a.elapsed_time(b) for a, b in evs) / REPS
        cycles *= 2


def parts_ms(fn, match: str) -> dict:
    """Device ms a call of each kernel whose name holds ``match``, under
    the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROF_REPS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and match in e.name:
            name = e.name.split("(")[0].replace("void ", "")
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() \
                / PROF_REPS / 1e3
    return out


def sha(t: torch.Tensor) -> str:
    t = t.detach()
    if t.dtype == torch.bfloat16:                  # numpy has no bf16
        t = t.view(torch.int16)
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()[:16]


def serve(label, smi, model, cfg, graphs, name):
    from repro_torch.serve.circuit_engine import CircuitServeEngine
    from repro_torch.train.metrics import percentile
    eng = CircuitServeEngine(model, cfg, max_batch=2, device="cuda")
    out = {}
    for phase in ("cold", "warm"):
        rids = [eng.submit(g) for g in graphs]
        t = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        lat = sorted(done[r].latency_ms for r in rids)
        out[phase] = dict(graphs_per_s=len(rids) / dt,
                          p50_ms=percentile(lat, 0.5),
                          p95_ms=percentile(lat, 0.95))
    print(json.dumps(dict(what="serve", tree=label, path=name, card=smi,
                          compiles=getattr(eng, "compiles", None), **out)),
          flush=True)


def jittered(graphs, seed):
    """A partition of each graph's size class with its node counts scaled
    by U(0.9, 1.1), made from ``seed``."""
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


def narrow_kernel(label, smi, table1):
    """Kernel 1 (k = 16, dim 64) on the quantized plan of the first two
    Table-1 partitions, as the serve engine collates them."""
    from repro_torch.graphs.collate import collate_graphs
    from repro_torch.kernels import drspmm as K1
    try:
        batch = collate_graphs(table1[:2], with_edges=False, device="cuda")
    except TypeError:                         # a tree without the option
        batch = collate_graphs(table1[:2], device="cuda")
    plan = batch.plan
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn((plan.n_src_total, HIDDEN), generator=gen)
    xi = torch.sort(torch.topk(x, K, dim=1).indices, dim=1).values.to(
        torch.int32)
    xv = torch.gather(x, 1, xi.long()).contiguous().cuda()
    xi = xi.contiguous().cuda()

    def fn():
        return K1.drspmm_fwd_arena(plan.fwd, xv, xi, HIDDEN)
    out = fn()
    torch.cuda.synchronize()
    own, total = kernel_ms(fn, "arena_")
    print(json.dumps(dict(
        what="kernel", tree=label, kernel="drspmm_fwd_arena-k16", card=smi,
        arena=list(plan.fwd.nbr.shape), k=K, events_ms=events_ms(fn),
        device_ms=own, device_ms_all=total, sha256=sha(out))), flush=True)


def collate_ms(label, smi, graphs):
    from repro_torch.graphs.collate import collate_graphs
    variants = {"default": {}, "plan-only": {"with_edges": False}}
    for what, kw in variants.items():
        best = None
        for _ in range(3):
            t = time.perf_counter()
            try:
                collate_graphs(graphs, device="cuda", **kw)
            except TypeError:                 # a tree without the option
                best = None
                break
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
            best = ms if best is None else min(best, ms)
        if best is not None:
            print(json.dumps(dict(what="collate", tree=label, variant=what,
                                  card=smi, ms=best)), flush=True)


def wide_kernels(label, smi, table1):
    from repro_torch.graphs.collate import collate_graphs
    from repro_torch.kernels import drspmm as K1
    from repro_torch.models.hgnn import homogenize, learnable_edge_packing
    try:
        batch = collate_graphs(table1[:2], quantize=False, device="cuda")
    except TypeError:                         # a tree that only collates
        batch = collate_graphs(table1[:2], device="cuda")   # exact sizes
    plan = batch.plan
    gen = torch.Generator().manual_seed(SEED)
    n_src, n_out = plan.n_src_total, plan.n_out_total
    xv = torch.rand((n_src, WIDE_K), generator=gen).cuda()
    xi = torch.sort(torch.argsort(torch.rand((n_src, WIDE_DIM), generator=gen),
                                  dim=1)[:, :WIDE_K], dim=1).values \
        .to(torch.int32).cuda()
    gy = torch.randn((n_out, WIDE_DIM), generator=gen).cuda()
    homo = homogenize(table1[0])
    f, ft, _d, _s, _w, nnz = learnable_edge_packing(homo[0], "cuda")
    n = homo[0].n_src
    hv = torch.randn((n, WIDE_K), generator=gen).cuda()
    hi = torch.arange(WIDE_K, dtype=torch.int32).repeat(n, 1).cuda()
    hg = torch.randn((homo[0].n_dst, WIDE_K), generator=gen).cuda()
    we = torch.rand(nnz, generator=gen).cuda()
    # kernels 1 and 7 share the forward walk (``arena_fwd_*``), 4 and 8
    # the backward one (``arena_bwd_*``)
    cases = (
        ("drspmm_fwd_arena",
         lambda: K1.drspmm_fwd_arena(plan.fwd, xv, xi, WIDE_DIM),
         plan.fwd.nbr.shape),
        ("drspmm_bwd_arena",
         lambda: K1.drspmm_bwd_arena(plan.bwd, plan.bwd_src_rows, gy, xi),
         plan.bwd.nbr.shape),
        ("drspmm_fwd_learnable",
         lambda: K1.drspmm_fwd_learnable(f, nnz, we, hv, hi, WIDE_K),
         f.nbr.shape),
        ("drspmm_bwd_learnable",
         lambda: K1.drspmm_bwd_learnable(ft, nnz, we, hg, hi),
         ft.nbr.shape))
    for name, fn, shape in cases:
        out = fn()
        torch.cuda.synchronize()
        own, total = kernel_ms(fn, "arena_")
        print(json.dumps(dict(
            what="kernel", tree=label, kernel=name, card=smi,
            arena=list(shape), k=WIDE_K, events_ms=events_ms(fn),
            device_ms=own, device_ms_all=total, sha256=sha(out))),
            flush=True)


def flash_kernels(label, smi):
    """Kernels 13 and 13b at the qwen3-0.6b prefill's shape."""
    from repro_torch.kernels import flash_attention as FA
    b, s, h, kv, hd = 4, 1024, 16, 8, 64
    gen = torch.Generator().manual_seed(SEED)
    q, k, v, do = (torch.randn((b, s, n, hd), generator=gen)
                   .to("cuda", torch.bfloat16) for n in (h, kv, kv, h))
    o, lse = FA._forward(q, k, v, True, 0, with_lse=True)
    cases = (
        ("flash_attention", "flash_attention_fwd",
         lambda: FA._forward(q, k, v, True, 0, with_lse=False)[:1]),
        ("flash_attention+lse", "flash_attention_fwd",
         lambda: FA._forward(q, k, v, True, 0, with_lse=True)),
        ("flash_attention_bwd", "flash_bwd",
         lambda: FA.flash_attention_bwd(q, k, v, o, lse, do)))
    for name, match, fn in cases:
        out = fn()
        torch.cuda.synchronize()
        parts = parts_ms(fn, match)
        print(json.dumps(dict(
            what="kernel", tree=label, kernel=name, card=smi,
            shape=[b, s, h, kv, hd], queued_ms=queued_ms(fn),
            events_ms=events_ms(fn), device_ms=sum(parts.values()),
            parts=parts, sha256=[sha(t) for t in out])), flush=True)


def lm_train(label, smi):
    """qwen3-0.6b training steps and one profiled forward+backward."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.launch.train import build_lm, get_config
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.train import lm_step
    cfg = get_config("qwen3-0.6b")
    lm = build_lm(cfg, device=torch.device("cuda"))
    state = lm_step.init_train_state(
        lm, torch.Generator("cuda").manual_seed(SEED))
    step = lm_step.make_train_step(lm, lr=3e-4, total_steps=LM_STEPS)
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=1024,
                                    global_batch=4, seed=SEED))
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for i in range(LM_STEPS):
        batch = {k: torch.from_numpy(v).long().cuda()
                 for k, v in pipe.global_batch(i).items()
                 if not k.startswith("_")}
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    steady = sorted(ms[1:])
    p50 = steady[len(steady) // 2]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        torch.autograd.grad(lm.loss(state.params, batch),
                            tree_leaves(state.params))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    busy = k13b = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy += us / 1e3
            k13b += us / 1e3 if "flash_bwd" in e.name else 0.0
    print(json.dumps(dict(
        what="lm_train", tree=label, card=smi, steps_ms=ms, p50_ms=p50,
        tokens_per_s_p50=4 * 1024 / (p50 / 1e3), fwd_bwd_wall_ms=wall,
        device_busy_ms=busy, busy_share=busy / wall, k13b_ms=k13b,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="tree")
    ap.add_argument("--only", choices=("gnn", "flash", "lm"), default=None)
    args = ap.parse_args()
    label = args.label
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core.hetero_mp import HeteroMPConfig
    from repro_torch.graphs.generator import generate_design
    from repro_torch.kernels import _build
    from repro_torch.models.hgnn import DRCircuitGNN
    import repro_torch
    smi = card()
    t = time.perf_counter()
    _build.build_all()
    print(json.dumps(dict(what="build", tree=label,
                          package=repro_torch.__file__,
                          s=time.perf_counter() - t)), flush=True)
    if args.only in (None, "flash"):
        flash_kernels(label, smi)
    if args.only in (None, "lm"):
        lm_train(label, smi)
    if args.only not in (None, "gnn"):
        return
    table1 = generate_design(0, "small", 1.0) + generate_design(1, "medium",
                                                                1.0)
    tiny = (generate_design(0, "small", 0.02)
            + generate_design(1, "medium", 0.02)
            + generate_design(2, "large", 0.02))
    model = DRCircuitGNN(FEAT, FEAT, HIDDEN, LAYERS, device="cuda",
                         generator=torch.Generator().manual_seed(SEED))
    topk = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K)
    bisect = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K,
                            drelu_backend="bisect")
    for name, cfg, graphs in (("table1-topk", topk, table1),
                              ("table1-bisect", bisect, table1),
                              ("scale0.02-bisect", bisect, tiny)):
        serve(label, smi, model, cfg, graphs, name)
    serve(label, smi, model, topk, table1 + jittered(table1, SEED + 9),
          "table1-captured")
    collate_ms(label, smi, table1[:2])
    narrow_kernel(label, smi, table1)
    wide_kernels(label, smi, table1)


if __name__ == "__main__":
    main()
