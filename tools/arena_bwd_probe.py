"""Where the arena sampled backward (kernel 4), the learnable-edge arena
sampled backward (kernel 8) and the learnable-edge weight gradient
(kernel 9) spend their time, on one NVIDIA card.

    PYTHONPATH=src python3 tools/arena_bwd_probe.py --kernel 4 \
        [--repeats 3] [--sweep 4,16,...]
    PYTHONPATH=src python3 tools/arena_bwd_probe.py [--sweep 16x3,8x1,...]
    PYTHONPATH=src python3 tools/arena_bwd_probe.py --kernel 9 \
        [--repeats 3] [--sweep 8x8,32x4,...]

``--kernel 4`` packs the transposed super-arena ``chip_smoke.py`` hands
kernel 4 (the first served Table-1 batch: the first two partitions of
``generate_design(0, "small", 1.0)`` + ``(1, "medium", 1.0)``, collated;
Ec 4, 8 rows a block) with the CBSR columns of the first layer of
``chip_smoke.py``'s seeded model (its seeded D-ReLU, k 16) and a seeded
cotangent gY (dim 64), prints the arena's chunk runs (a histogram of run
lengths, how many row-blocks reach ``HEAVY_RUN`` chunks and how many
chunks they hold, and at which share of the grid the first of them
starts when the row-blocks are taken in reverse arena order and in the
order of ``_arena_sched``), and times, with CUDA events (``ms``) and with
``torch.profiler`` (``device_ms``), as below:

* kernel 4 over the whole arena, ``--repeats`` times, each with the
  SHA-256 of its output, and its error against the plain version; then
  with every row's columns 0..k-1 (``contiguous``: the same walk and
  loads, 2 of a gY row's eight 32-byte sectors touched instead of ~7.3):
  if that is much faster, the sectors moved set kernel 4's time;
* kernel 4 over the row-blocks of at least ``HEAVY_RUN`` chunks alone,
  over the other row-blocks alone (``only_blocks``) and over the whole
  arena with one row a row-block kept (``one_row``: the same chains, an
  eighth of the gathers);
* kernel 6 (``spmm_arena``) over the same arena with gY as its dense
  operand, whole and over the heavy row-blocks: the full 256-byte rows
  of the same slots, read by kernel 6's own walk (flat runs, one warp a
  row, whole rows);
* ``torch.sparse.mm`` of the CSR Aᵀ by gY (the library yardstick: the
  unsampled product, dim / k times the outputs).

With ``--sweep LOADS,...`` (a tree whose k <= 32 walk takes
``_arena_sched``) it also builds kernel 4 at other ``kBwdNarrowLoads`` of
``csrc/arena_bwd_walk.cuh`` (gY samples a lane issues a batch; one
``nvcc`` each, all started together), prints each build's registers and
spills, and times each over the whole arena, the heavy row-blocks and
the others, its output checked against the plain version and bit for
bit against the wrapper's (every build adds a row's slots in the same
order).

Without ``--kernel``, it probes kernel 8:

Packs the transposed edge-id arena the ``train-homo-gat`` path hands
kernel 8 (the homogenized first Table-1 partition, ``generate_design(0,
"small", 1.0)``: 11,840 rows, Ec 4, rows of at most 80 slots, k = dim =
64) with random canonical weights, a random cotangent gY and the GAT
operand's iota columns, all made from a seed, and times, with CUDA events
(``ms``: ``cuda_ms`` of ``tools/arena_fwd_probe.py``, mean of 50 L2-warm
calls after a warm-up, which reads the host's launch rate where that is
slower than the kernel) and with ``torch.profiler`` (``device_ms``: the
device time it traces over 50 more calls, a call):

* kernel 8 over the whole arena, with iota columns and with each row's
  k = 64 columns a random permutation;
* kernel 8 over the 240 heaviest row-blocks alone, over the other
  row-blocks alone, over the 16 longest chunk runs alone, and over those
  runs with only the first row of each row-block kept (``only_blocks`` and
  ``one_row`` of ``tools/arena_fwd_probe.py``: the same grid, less work);
* kernel 4 (``drspmm_bwd_arena``) on the same arena with the slot weights
  written out (``_canon_slot_weights``): kernel 8 less its
  ``eid -> w_canon`` stage;
* kernel 6 (``spmm_arena``) on the same arena and weights with gY as the
  dense operand: the same 256-byte row gathers with no column sampling,
  the gather floor of this arena;
* ``torch.sparse.mm`` of the CSR A(w)ᵀ by gY (the library yardstick: the
  same function at iota columns).

With ``--sweep SLOTSxBLOCKS,...`` it also builds kernel 8 at other
``kBwdWideSlots`` x ``kBwdWideMinBlocks`` of ``csrc/arena_bwd_walk.cuh``
(the slots whose gY loads a warp issues together at k 64 x the blocks an
SM must hold, which caps the registers; one ``nvcc`` each, all started
together, into ``build/repro_torch/probe/``) and times each over
the whole arena, the longest runs and the other row-blocks, with iota and
permuted columns.

``--kernel 9`` packs the forward edge-id arena the ``train-homo-gat`` path
hands kernel 9 (the same partition: 13,872 chunks of 8 x 4 in 1,482
row-blocks, 424,878 real slots, k = dim = 64) with a random cotangent gY
and a random CBSR operand at iota and at permuted columns, all made from a
seed, prints the arena's chunk runs (mean, p99, longest, how many reach
``LONG_RUN`` chunks), and times, by events (``ms``) and by the profiler
(``device_ms``), as above:

* kernel 9 over the whole arena, ``--repeats`` times, each with the
  SHA-256 of ``gw`` and its error against the plain version, and once at
  permuted columns;
* kernel 9 over the row-blocks of at least ``LONG_RUN`` chunks alone and
  over the other row-blocks alone (``only_blocks``: the same arena with
  the other blocks' chunks taken out; the error is read at the ids of the
  kept slots): if the long runs alone take most of the whole, the chain
  of a long run sets kernel 9's time;
* ``torch.sparse.sampled_addmm`` of the arena's CSR pattern, gY and the
  dense operand (the library yardstick: the same function at iota
  columns).

On a tree whose kernel 9 takes a work list (``_dw_sched``), it then
times the wrapper's build, and with ``--sweep LANESxBLOCKS,...``
kernel 9 built at other ``kDwLanes`` x ``kDwMinBlocks`` of
``csrc/drspmm_learnable_dw.cu`` (lanes a slot at k 64 x the blocks an
SM must hold; one ``nvcc``
each, all started together; each build's registers and spills printed),
over the whole arena, the long runs and the other row-blocks, with iota
and permuted columns, with the work list in the wrapper's destination
order and sorted by source instead, each output checked bit for bit
against the wrapper's (a build at other lanes sums in another order).

Prints one JSON object a line, then the card's name and power limit.
Needs one card; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import sys
import warnings
from pathlib import Path

import torch

from arena_fwd_probe import (HEAVY_BLOCKS, LONGEST_BLOCKS, SEED,
                             build_variants, card, one_row, only_blocks,
                             ptxas, sha, times)

DIM = 64
LONG_RUN = 32           # kernel 9: the row-blocks of at least this many chunks
HEAVY_RUN = 10          # kernel 4: the row-blocks of at least this many chunks
DW_NAMES = ("kDwLanes", "kDwMinBlocks")
BWD_NARROW_NAMES = ("kBwdNarrowLoads",)
BWD_NARROW_WALK = "arena_bwd_narrow"


def gat_t_arena():
    """(transposed edge-id arena on the card, nnz, canonical weights, gY,
    iota columns, permuted columns)."""
    from repro_torch.graphs.generator import generate_design
    from repro_torch.models.hgnn import homogenize, learnable_edge_packing
    adj = homogenize(generate_design(0, "small", 1.0)[0])[0]
    _f, ft, _dst, _src, _w, nnz = learnable_edge_packing(adj, "cuda")
    g = torch.Generator().manual_seed(SEED)
    w = torch.randn(nnz, generator=g).cuda()
    gy = torch.randn((ft.n_src, DIM), generator=g).cuda()
    n = ft.n_dst
    iota = torch.arange(DIM, dtype=torch.int32).expand(n, DIM).contiguous()
    perm = torch.argsort(torch.rand((n, DIM), generator=g), dim=1)
    return ft, nnz, w, gy, iota.cuda(), perm.to(torch.int32).cuda()


def launch(fn, ft, w, gy, xi, out) -> None:
    """One launch of a kernel-8 library built by ``build_variants``, as the
    port's wrapper makes it."""
    from repro_torch.kernels.drspmm import _arena_sched
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    _c, br, ec = ft.nbr.shape
    rc = fn(p(_arena_sched(ft)), p(ft.nbr), p(ft.eid), p(w),
            p(ft.rows), p(gy), p(xi), p(out), ft.n_blocks, br, ec,
            xi.shape[1], gy.shape[1],
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc:
        raise RuntimeError(f"kernel 8 variant: CUDA error {rc}")


def gat_f_arena():
    """(forward edge-id arena on the card, nnz, its CSR pattern, gY, CBSR
    values, iota columns, permuted columns)."""
    from chip_smoke import coo_csr
    from repro_torch.graphs.generator import generate_design
    from repro_torch.models.hgnn import homogenize, learnable_edge_packing
    adj = homogenize(generate_design(0, "small", 1.0)[0])[0]
    f, _ft, dst, src, _w, nnz = learnable_edge_packing(adj, "cuda")
    g = torch.Generator().manual_seed(SEED)
    gy = torch.randn((f.n_dst, DIM), generator=g).cuda()
    xv = torch.randn((f.n_src, DIM), generator=g).cuda()
    n = f.n_src
    iota = torch.arange(DIM, dtype=torch.int32).expand(n, DIM).contiguous()
    perm = torch.argsort(torch.rand((n, DIM), generator=g), dim=1)
    pattern = coo_csr(dst, src, torch.ones(nnz, device="cuda"),
                      (f.n_dst, f.n_src))
    return (f, nnz, pattern, gy, xv, iota.cuda(),
            perm.to(torch.int32).cuda())


def launch_dw(fn, sched, gy, xv, xi, gw) -> None:
    """One launch of a kernel-9 library (the wrapper's or one built by
    ``build_variants``) over the work list ``sched`` (``_dw_sched``'s
    rows, in any order)."""
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    rc = fn(p(sched), p(gy), p(xv), p(xi), p(gw), sched.shape[0],
            xi.shape[1], gy.shape[1],
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc:
        raise RuntimeError(f"kernel 9: CUDA error {rc}")


def by_source(sched):
    """``_dw_sched``'s rows sorted by source instead of destination row
    (padding still last): the slots of one CBSR row together, their gY
    rows scattered."""
    key = torch.where(sched[:, 0] >= 0, sched[:, 1].long(), 2 ** 40)
    return sched[torch.argsort(key, stable=True)].contiguous()


def kernel9(repeats: int, shapes) -> None:
    """The ``--kernel 9`` probe (module docstring)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import drspmm as K1
    f, nnz, pattern, gy, xv, iota, perm = gat_f_arena()
    _build.build_all()
    runs = torch.diff(f.blk_ptr)
    rs = runs.float()
    long_ = runs >= LONG_RUN
    print(json.dumps({
        "kernel": "drspmm_dw_learnable", "chunks": f.n_chunks,
        "blocks": f.n_blocks, "row_block": f.row_block,
        "ec": f.nbr.shape[2], "k": DIM, "dim": DIM,
        "real_slots": int((f.eid >= 0).sum()),
        "run_mean": float(rs.mean()),
        "run_p99": float(torch.quantile(rs, 0.99)),
        "run_max": int(runs.max()), "long_runs": int(long_.sum()),
        "long_run_blocks": torch.nonzero(long_).flatten().tolist(),
        "ptxas": ptxas(_build.build_dir() / "drspmm_learnable_dw.log",
                       "dw_kernel")}), flush=True)
    cases = {"all": f, "long": only_blocks(f, long_),
             "others": only_blocks(f, ~long_)}
    for part, fp in cases.items():
        ids = fp.eid[fp.eid >= 0].long()
        r = torch.diff(fp.blk_ptr)
        col_sets = (("iota", iota), ("perm", perm))[:2 if part == "all"
                                                     else 1]
        for cols, xi in col_sets:
            gw = K1.drspmm_dw_learnable(fp, nnz, gy, xv, xi)
            ref = K1.drspmm_dw_learnable_plain(fp, nnz, gy, xv, xi)
            torch.cuda.synchronize()
            case = {"kernel": "drspmm_dw_learnable", "blocks": part,
                    "columns": cols}
            print(json.dumps({
                **case, "chunks": int(r.sum()), "longest_run": int(r.max()),
                "real_slots": int(ids.numel()),
                "max_abs_err": float((gw[ids] - ref[ids]).abs().max()),
                "max_abs_ref": float(ref[ids].abs().max())}), flush=True)
            for rep in range(repeats if (part, cols) == ("all", "iota")
                             else 1):
                gw = K1.drspmm_dw_learnable(fp, nnz, gy, xv, xi)
                torch.cuda.synchronize()
                print(json.dumps({
                    **case, "repeat": rep,
                    **({"sha256": sha(gw)} if part == "all" else {}),
                    **times(lambda: K1.drspmm_dw_learnable(
                        fp, nnz, gy, xv, xi))}), flush=True)
    xt = xv.t().contiguous()
    print(json.dumps({
        "kernel": "torch.sparse.sampled_addmm", "blocks": "all",
        **times(lambda: torch.sparse.sampled_addmm(pattern, gy, xt,
                                                   beta=0.0))}), flush=True)
    if not hasattr(K1, "_dw_sched"):            # a tree before the work list
        return
    libs = {"wrapper": K1._learnable_lib("drspmm_learnable_dw", 5, 3)
            .drspmm_learnable_dw}
    variants = build_variants(
        shapes, header="drspmm_learnable_dw.cu", names=DW_NAMES,
        entry="drspmm_learnable_dw", n_ptr=5, n_int=3)
    for shape, fn in variants.items():
        tag = "x".join(map(str, shape))
        d = _build.BUILD_ROOT / "probe" / f"drspmm_learnable_dw-{tag}"
        print(json.dumps({"kernel": "drspmm_dw_learnable", "build": tag,
                          **dict(zip(DW_NAMES, shape)),
                          "ptxas": ptxas(d / "nvcc.log", "dw_kernel")}),
              flush=True)
        libs[tag] = fn
    for build, fn in libs.items():
        for part, fp in cases.items():
            ids = fp.eid[fp.eid >= 0].long()
            sched = K1._dw_sched(fp)
            for order, sc in (("destination", sched),
                              ("source", by_source(sched))):
                for cols, xi in (("iota", iota), ("perm", perm)):
                    want = K1.drspmm_dw_learnable(fp, nnz, gy, xv, xi)
                    gw = torch.empty_like(want)
                    launch_dw(fn, sc, gy, xv, xi, gw)
                    torch.cuda.synchronize()
                    print(json.dumps({
                        "kernel": "drspmm_dw_learnable", "build": build,
                        "blocks": part, "order": order, "columns": cols,
                        "same_as_wrapper": bool(torch.equal(gw[ids],
                                                            want[ids])),
                        **times(lambda: launch_dw(fn, sc, gy, xv, xi,
                                                  gw))}), flush=True)


def table1_bwd():
    """(transposed super-arena, its source-row map, gY, CBSR columns) of
    the first served Table-1 batch on the card: the columns of the first
    layer of ``chip_smoke.py``'s seeded model, gY seeded normal."""
    from chip_smoke import FEAT, HIDDEN, K, LAYERS, first_layer_operands
    from repro_torch.core.hetero_mp import HeteroMPConfig
    from repro_torch.graphs.collate import collate_graphs
    from repro_torch.graphs.generator import generate_design
    from repro_torch.models.hgnn import DRCircuitGNN
    table1 = (generate_design(0, "small", 1.0)
              + generate_design(1, "medium", 1.0))
    big = collate_graphs(table1[:2], device="cuda")
    model = DRCircuitGNN(FEAT, FEAT, HIDDEN, LAYERS, device="cuda",
                         generator=torch.Generator().manual_seed(SEED))
    cfg = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K)
    _xv, xi, _ = first_layer_operands(model, big.graph, cfg)
    plan = big.plan
    gy = torch.randn((plan.n_out_total, HIDDEN),
                     generator=torch.Generator().manual_seed(SEED + 1))
    return plan.bwd, plan.bwd_src_rows, gy.cuda(), xi


def launch_k4(fn, f, src, gy, xi, out) -> None:
    """One launch of a kernel-4 library built by ``build_variants``, as
    the port's wrapper makes it."""
    from repro_torch.kernels.drspmm import _arena_sched
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    _c, br, ec = f.nbr.shape
    rc = fn(p(_arena_sched(f)), p(f.nbr), p(f.w), p(src),
            p(gy), p(xi), p(out), f.n_blocks, br, ec, xi.shape[1],
            gy.shape[1],
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc:
        raise RuntimeError(f"kernel 4 variant: CUDA error {rc}")


def kernel4(repeats: int, shapes) -> None:
    """The ``--kernel 4`` probe (module docstring)."""
    from chip_smoke import arena_csr
    from repro_torch.kernels import _build
    from repro_torch.kernels import drspmm as K1
    f, src, gy, xi = table1_bwd()
    _build.build_all()
    runs = torch.diff(f.blk_ptr)
    heavy = runs >= HEAVY_RUN
    # position in the grid of each row-block: reverse arena order (the
    # chunk-at-a-time walk) and longest run first (the schedule)
    rev = f.n_blocks - 1 - torch.nonzero(heavy).flatten()
    by_run = torch.argsort(runs, descending=True, stable=True)
    pos = torch.empty_like(by_run)
    pos[by_run] = torch.arange(f.n_blocks, device=by_run.device)
    hist = torch.bincount(runs.long()).tolist()
    print(json.dumps({
        "kernel": "drspmm_bwd_arena", "chunks": f.n_chunks,
        "blocks": f.n_blocks, "row_block": f.row_block,
        "ec": f.nbr.shape[2], "k": xi.shape[1], "dim": gy.shape[1],
        "R_arena": f.n_arena_rows, "M": gy.shape[0], "N_src": xi.shape[0],
        "real_slots": int((f.w != 0).sum()),
        "run_hist": {n: c for n, c in enumerate(hist) if c},
        "heavy_blocks": int(heavy.sum()),
        "heavy_chunks": int(runs[heavy].sum()),
        "longest_run": int(runs.max()),
        "first_heavy_reverse_order": float(rev.min()) / f.n_blocks,
        "first_heavy_sched_order": float(pos[heavy].min()) / f.n_blocks,
        "ptxas": ptxas(_build.build_dir() / "drspmm_arena_bwd.log",
                       BWD_NARROW_WALK)}), flush=True)
    one = torch.ones_like(heavy)
    cases = {"all": f, "heavy": only_blocks(f, heavy),
             "others": only_blocks(f, ~heavy), "all-one-row": one_row(f, one)}
    for part, fp in cases.items():
        r = torch.diff(fp.blk_ptr)
        dv = K1.drspmm_bwd_arena(fp, src, gy, xi)
        ref = K1.drspmm_bwd_arena_plain(fp, src, gy, xi)
        torch.cuda.synchronize()
        case = {"kernel": "drspmm_bwd_arena", "blocks": part}
        print(json.dumps({
            **case, "chunks": int(r.sum()), "longest_run": int(r.max()),
            "real_slots": int((fp.w != 0).sum()),
            "max_abs_err": float((dv - ref).abs().max()),
            "max_abs_ref": float(ref.abs().max())}), flush=True)
        for rep in range(repeats if part == "all" else 1):
            dv = K1.drspmm_bwd_arena(fp, src, gy, xi)
            torch.cuda.synchronize()
            print(json.dumps({
                **case, "repeat": rep,
                **({"sha256": sha(dv)} if part == "all" else {}),
                **times(lambda: K1.drspmm_bwd_arena(fp, src, gy, xi))}),
                flush=True)
    k = xi.shape[1]
    xi_c = torch.arange(k, dtype=torch.int32, device=xi.device).expand(
        xi.shape).contiguous()
    print(json.dumps({
        "kernel": "drspmm_bwd_arena", "blocks": "all",
        "columns": "contiguous",
        **times(lambda: K1.drspmm_bwd_arena(f, src, gy, xi_c))}), flush=True)
    for part in ("all", "heavy"):
        fp = cases[part]
        print(json.dumps({"kernel": "spmm_arena", "operand": "gY",
                          "blocks": part,
                          **times(lambda: K1.spmm_arena(fp, gy))}),
              flush=True)
    a_t = arena_csr(f, gy.shape[0])
    print(json.dumps({"kernel": "torch.sparse.mm", "blocks": "all",
                      **times(lambda: a_t @ gy)}), flush=True)
    for shape, fn in build_variants(
            shapes, header="arena_bwd_walk.cuh", names=BWD_NARROW_NAMES,
            entry="drspmm_arena_bwd", n_ptr=7).items():
        d = _build.BUILD_ROOT / "probe" / (
            "drspmm_arena_bwd-" + "x".join(map(str, shape)))
        named = dict(zip(BWD_NARROW_NAMES, shape))
        print(json.dumps({"kernel": "drspmm_bwd_arena", **named,
                          "ptxas": ptxas(d / "nvcc.log", BWD_NARROW_WALK)}),
              flush=True)
        for part in ("all", "heavy", "others"):
            fp = cases[part]
            want = K1.drspmm_bwd_arena(fp, src, gy, xi)
            out = torch.empty_like(want)
            launch_k4(fn, fp, src, gy, xi, out)
            ref = K1.drspmm_bwd_arena_plain(fp, src, gy, xi)
            torch.cuda.synchronize()
            print(json.dumps({
                "kernel": "drspmm_bwd_arena", **named, "blocks": part,
                "same_as_wrapper": bool(torch.equal(out, want)),
                "max_abs_err": float((out - ref).abs().max()),
                **times(lambda: launch_k4(fn, fp, src, gy, xi, out))}),
                flush=True)


def kernel8(shapes) -> None:
    """The kernel-8 probe (module docstring)."""
    from repro_torch.kernels import drspmm as K1
    ft, nnz, w, gy, iota, perm = gat_t_arena()
    runs = torch.diff(ft.blk_ptr)
    order = torch.argsort(runs, descending=True)
    heavy = torch.zeros(ft.n_blocks, dtype=torch.bool, device=runs.device)
    heavy[order[:HEAVY_BLOCKS]] = True
    longest = torch.zeros_like(heavy)
    longest[order[:LONGEST_BLOCKS]] = True
    arenas = {"all": ft, "heavy": only_blocks(ft, heavy),
              "light": only_blocks(ft, ~heavy),
              "longest": only_blocks(ft, longest),
              "longest-one-row": one_row(ft, longest)}
    for part, fp in arenas.items():
        r = torch.diff(fp.blk_ptr)
        for cols, xi in (("iota", iota), ("perm", perm)):
            dv = K1.drspmm_bwd_learnable(fp, nnz, w, gy, xi)
            ref = K1.drspmm_bwd_learnable_plain(fp, nnz, w, gy, xi)
            torch.cuda.synchronize()
            print(json.dumps({
                "kernel": "drspmm_bwd_learnable", "blocks": part,
                "columns": cols, "chunks": int(r.sum()),
                "longest_run": int(r.max()),
                "longest_run_slots": int(r.max()) * ft.nbr.shape[2],
                "real_slots": int((fp.eid >= 0).sum()),
                "max_abs_err": float((dv - ref).abs().max()),
                **times(lambda: K1.drspmm_bwd_learnable(
                    fp, nnz, w, gy, xi))}), flush=True)
    wa = K1._canon_slot_weights(ft, nnz, w)
    f4 = dataclasses.replace(ft, w=wa)
    for part, fp in (("all", f4), ("longest", only_blocks(f4, longest))):
        print(json.dumps({
            "kernel": "drspmm_bwd_arena", "blocks": part, "columns": "iota",
            **times(lambda: K1.drspmm_bwd_arena(fp, fp.rows, gy, iota))}),
            flush=True)
        print(json.dumps({"kernel": "spmm_arena", "blocks": part,
                          **times(lambda: K1.spmm_arena(fp, gy))}),
              flush=True)
    rows = (ft.block_of.long()[:, None] * ft.row_block
            + torch.arange(ft.row_block, device=wa.device))
    mask = wa != 0
    a = torch.sparse_coo_tensor(
        torch.stack([rows[:, :, None].expand(ft.nbr.shape)[mask],
                     ft.nbr.long()[mask]]), wa[mask],
        (ft.n_arena_rows, ft.n_src)).coalesce().to_sparse_csr()
    print(json.dumps({"kernel": "torch.sparse.mm", "blocks": "all",
                      **times(lambda: a @ gy)}), flush=True)
    for (slots, blocks), fn in build_variants(
            shapes, header="arena_bwd_walk.cuh",
            names=("kBwdWideSlots", "kBwdWideMinBlocks"),
            entry="drspmm_learnable_bwd", n_ptr=8).items():
        for part in ("all", "longest", "light"):
            fp = arenas[part]
            for cols, xi in (("iota", iota), ("perm", perm)):
                out = torch.empty((fp.n_arena_rows, DIM), device="cuda")
                launch(fn, fp, w, gy, xi, out)
                ref = K1.drspmm_bwd_learnable_plain(fp, nnz, w, gy, xi)
                torch.cuda.synchronize()
                print(json.dumps({
                    "kernel": "drspmm_bwd_learnable", "slots": slots,
                    "min_blocks": blocks, "blocks": part, "columns": cols,
                    "max_abs_err": float((out - ref).abs().max()),
                    **times(lambda: launch(fn, fp, w, gy, xi, out))}),
                    flush=True)

def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", type=int, choices=(4, 8, 9), default=8,
                    help="the kernel to probe (default 8)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="kernels 4 and 9: timings over the whole arena")
    ap.add_argument("--sweep", default="",
                    help="comma-separated shapes to build and time: "
                         "SLOTSxBLOCKS of kernel 8's wide walk (e.g. "
                         "16x3,16x1), with --kernel 4 LOADS of the k <= 32 "
                         "walk (e.g. 4,16), with "
                         "--kernel 9 LANESxBLOCKS of kernel 9 (e.g. "
                         "8x8,32x4)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("arena_bwd_probe: no CUDA device visible")
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root / "src"), str(root)]
    warnings.filterwarnings("ignore", message="Sparse")
    shapes = [tuple(int(v) for v in s.split("x"))
              for s in args.sweep.split(",") if s]
    if args.kernel == 4:
        kernel4(args.repeats, shapes)
    elif args.kernel == 9:
        kernel9(args.repeats, shapes)
    else:
        kernel8(shapes)
    print(card())


if __name__ == "__main__":
    main()
