"""Where the arena DR-SpMM forward (kernel 1), the learnable-edge arena
forward (kernel 7), which share one walk, and the dense-operand arena SpMM
(kernel 6) spend their time, on one NVIDIA card.

    PYTHONPATH=src python3 tools/arena_fwd_probe.py --kernel 1 \
        [--repeats 5] [--sweep 2x32x4,1x64x8,...]
    PYTHONPATH=src python3 tools/arena_fwd_probe.py --kernel 6 \
        [--repeats 3] [--sweep 32x4,8x8,...]
    PYTHONPATH=src python3 tools/arena_fwd_probe.py [--sweep 2x8,...]

``--kernel 1`` packs the super-arena ``chip_smoke.py`` hands kernel 1 (the
first served Table-1 batch: the first two partitions of
``generate_design(0, "small", 1.0)`` + ``(1, "medium", 1.0)``, collated;
Ec 4, 8 rows a block) and the first layer's CBSR operand of
``chip_smoke.py``'s seeded model (k 16, dim 64), prints the arena's
chunk runs (mean, median, p99, longest, and how many blocks have the
longest and one chunk), and times, with CUDA events (``ms``, as below)
and with ``torch.profiler`` (``device_ms``: the device time
``chip_smoke.device_breakdown`` traces over 50 more calls, a call):

* kernel 1 over the whole arena, ``--repeats`` times, with the SHA-256 of
  its output and its error against the plain version;
* kernel 1 over the 16 longest chunk runs alone, over every other
  row-block alone, and over the 16 longest runs with one row a block kept
  (``only_blocks``, ``one_row``: the same grid, less work): if the
  longest runs alone take most of the whole, the chain of a long run sets
  kernel 1's time; if they take under half, the rate of its slots does;
* ``torch.sparse.mm`` of the arena's CSR by the densified operand (the
  library yardstick).

With ``--sweep PARTSxSPLITxLOADS,...`` it also builds kernel 1 at other
``kNarrowParts`` x ``kNarrowSplit`` x ``kNarrowLoads`` of the k <= 32
walk in ``csrc/arena_fwd_walk.cuh`` (most warps a row x slots of a run
each part takes x CBSR loads a lane issues a batch; one ``nvcc`` each,
all started together, into ``build/repro_torch/probe/``), prints each
build's registers and spills, and times each over the whole arena, the
longest runs and the other row-blocks, its output checked bit for bit
against the wrapper's.

``--kernel 6`` packs the ``near`` arena of the same batch and its
transpose, as ``chip_smoke.py::check_spmm_kernel`` hands them to kernel 6
(Ec 4, 8 rows a block), with a seeded operand x and a seeded cotangent gY
(dim 64).  For each direction (forward: A by x; transposed: Aᵀ by gY) it
prints the arena's chunk runs (a histogram of run lengths, how many
row-blocks reach ``HEAVY_RUN`` and ``LONG_RUN`` chunks and how many chunks
they hold, at which share of the grid the first and the last of the
heavy ones start in reverse arena order and in the order of
``_arena_sched``), the L2 sectors a call reads (real slots x the 32-byte
sectors of a ``dim``-float row) and kernel 6's registers, and times, with
CUDA events (``ms``) and with the profiler (``device_ms``):

* kernel 6 over the whole arena, ``--repeats`` times, each with the
  SHA-256 of its output, and its error against the plain version;
* kernel 6 over the row-blocks of at least ``HEAVY_RUN`` chunks alone,
  over the others alone, over the row-blocks of at least ``LONG_RUN``
  chunks alone (``only_blocks``), and over the whole arena with one row
  a row-block kept (``one_row``: the same chains, an eighth of the
  gathers);
* ``torch.sparse.mm`` of the arena's CSR by the operand (the library
  yardstick).

With ``--sweep LOADSxBLOCKS,...`` it also builds kernel 6 at other
``kSpmmLoads`` x ``kSpmmMinBlocks`` of ``csrc/spmm_arena.cu`` (floats a
lane has in flight a batch x blocks an SM must hold; one ``nvcc`` each,
all started together), prints each build's registers and spills and the
order of the row loads (``L``) and FMAs (``F``) in the SASS of its dim-64
walk (``cuobjdump``), and times each in both directions over the whole
arena and the heavy row-blocks, its output checked bit for bit against
the wrapper's (every build adds a row's slots in the same order).

Without ``--kernel`` it probes kernel 7:

Packs the arena the ``train-homo-gat`` path hands kernel 7 (the homogenized
first Table-1 partition, ``generate_design(0, "small", 1.0)``: 11,840 rows,
Ec 4, k = dim = 64) with random canonical weights and a random operand made
from a seed, and times, with CUDA events (mean of 50 L2-warm calls after a
warm-up):

* kernel 7 over the whole arena, with the GAT operand's iota columns and
  with each row's columns a random permutation;
* kernel 7 over the 240 heaviest row-blocks alone (the two widest degree
  buckets), over the other row-blocks alone, and over the 16 longest
  chunk runs alone (the latency chain of a row with the card otherwise
  idle): the other blocks' chunk ranges are emptied, so each launch has
  the full grid;
* kernel 7 over the 16 longest runs with only the first row of each
  row-block kept (the same chains, an eighth of the bytes on each SM);
* kernel 6 (``spmm_arena``) over the same arena and weights on the dense
  operand, whole and over the 16 longest runs: the same gathers without
  the index reads;
* ``torch.sparse.mm`` of the CSR A(w) by the dense operand.

With ``--sweep 1x32,2x8,...`` it also builds kernel 7 at other
``kWideParts`` x ``kWidePairs`` of ``csrc/arena_fwd_walk.cuh`` (warps a
row x pairs a lane in flight; one ``nvcc`` each, all started together, into
``build/repro_torch/probe/``) and times each over the whole arena, the
longest runs and the other row-blocks.

Prints one JSON object a line, then the card's name and power limit.
Needs one card; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import itertools
import json
import re
import shutil
import subprocess
import sys
import warnings
from pathlib import Path

import torch

SEED = 0
REPS = 50
HEAVY_BLOCKS = 240      # the 1,920 rows of the two widest degree buckets
LONGEST_BLOCKS = 16     # the longest chunk runs, with the card otherwise idle
NARROW_NAMES = ("kNarrowParts", "kNarrowSplit", "kNarrowLoads")
# the k <= 32 walk's instantiations in a ptxas log: [DPL, lanes a row,
# registers, ...] (arena_fwd_kernel, the chunk-at-a-time walk of older
# trees: [DPL, Ec, registers, ...])
NARROW_WALK = r"arena_fwd_(narrow|kernel)"
HEAVY_RUN = 10          # kernel 6: the row-blocks of at least this many chunks
LONG_RUN = 40           # and of at least this many
SPMM_NAMES = ("kSpmmLoads", "kSpmmMinBlocks")
SPMM_WALK = "spmm_arena_kernel"


def cuda_ms(fn, reps: int = REPS) -> float:
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = REPS) -> float:
    """Device time of one call of ``fn``: the device activities that
    ``chip_smoke.device_breakdown`` traces over ``reps`` L2-warm calls,
    over ``reps``."""
    from chip_smoke import device_breakdown
    for _ in range(3):
        fn()
    return device_breakdown(lambda: [fn() for _ in range(reps)])[1] / reps


def times(fn) -> dict:
    return {"ms": cuda_ms(fn), "device_ms": device_ms(fn)}


def sha(t: torch.Tensor) -> str:
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def ptxas(log: Path, kernel: str = "") -> list:
    """[template ints..., registers, stack bytes, spill store bytes, spill
    load bytes] of each instantiation of a kernel whose mangled name
    matches the regular expression ``kernel``, in an ``nvcc -Xptxas -v``
    log."""
    out, tpl, spill = [], None, None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            ints = re.findall(r"Li(\d+)E", name)
            tpl = ([int(v) for v in ints]
                   if re.search(kernel, name) and ints else None)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            spill = [int(v) for v in m.groups()]
        m = re.search(r"Used (\d+) registers", line)
        if m and tpl is not None:
            out.append([*tpl, int(m.group(1)), *(spill or [0, 0, 0])])
            tpl, spill = None, None
    return sorted(out)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def sass_order(lib: Path, kernel: str) -> str:
    """The row loads (``L``: ``LDG``) and FMAs (``F``: ``FFMA``) of the
    first function in ``lib``'s SASS whose mangled name matches the
    regular expression ``kernel``, in program order, run-length coded
    (``L16F32``: 16 loads, then 32 FMAs); "" where ``cuobjdump`` is
    missing."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return ""
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=120).stdout
    seq, inside = [], False
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            if inside:
                break
            inside = re.search(kernel, m.group(1)) is not None
            continue
        m = inside and re.search(
            r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and m.group(1).startswith(("LDG", "FFMA")):
            seq.append(m.group(1)[0])
    return "".join(f"{c}{len(list(g))}" for c, g in itertools.groupby(seq))


def gat_arena():
    """(forward edge-id arena on the card, nnz, canonical weights, dense
    operand, iota columns, permuted columns, adjacency)."""
    from repro_torch.graphs.generator import generate_design
    from repro_torch.models.hgnn import homogenize, learnable_edge_packing
    adj = homogenize(generate_design(0, "small", 1.0)[0])[0]
    f, _ft, _dst, _src, _w, nnz = learnable_edge_packing(adj, "cuda")
    g = torch.Generator().manual_seed(SEED)
    w = torch.randn(nnz, generator=g).cuda()
    n = adj.n_src
    xv = torch.randn((n, 64), generator=g).cuda()
    iota = torch.arange(64, dtype=torch.int32).expand(n, 64).contiguous()
    perm = torch.argsort(torch.rand((n, 64), generator=g), dim=1)
    return (f, nnz, w, xv, iota.cuda(), perm.to(torch.int32).cuda(), adj)


def table1_arena():
    """(super-arena, CBSR values, CBSR columns, dim) that ``chip_smoke.py``
    hands kernel 1: the first served Table-1 batch and the first layer's
    operand of its seeded model, on the card."""
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
    xv, xi, _ = first_layer_operands(model, big.graph, cfg)
    return big.plan.fwd, xv, xi, HIDDEN


def only_blocks(f, keep: torch.Tensor):
    """``f`` with the chunk ranges of the row-blocks outside ``keep`` (a
    bool mask over blocks) emptied: the same grid, less work."""
    keep_chunk = keep[f.block_of.long()]
    cut = lambda t: None if t is None else t[keep_chunk].contiguous()
    return dataclasses.replace(
        f, nbr=cut(f.nbr), w=cut(f.w), eid=cut(f.eid),
        block_of=cut(f.block_of), start=cut(f.start), rel=cut(f.rel),
        blk_ptr=torch.searchsorted(
            cut(f.block_of),
            torch.arange(f.n_blocks + 1, device=f.blk_ptr.device,
                         dtype=f.block_of.dtype)).to(torch.int32))


def one_row(f, keep: torch.Tensor):
    """``only_blocks(f, keep)`` with every row but the first of each
    row-block turned to padding: the same chains, an eighth of the
    bytes on each SM."""
    g = only_blocks(f, keep)
    pad = torch.ones_like(g.nbr, dtype=torch.bool)
    pad[:, 0, :] = False
    return dataclasses.replace(
        g, nbr=g.nbr.masked_fill(pad, 0), w=g.w.masked_fill(pad, 0.0),
        eid=None if g.eid is None else g.eid.masked_fill(pad, -1))


def build_variants(shapes, header="arena_fwd_walk.cuh",
                   names=("kWideParts", "kWidePairs"),
                   entry="drspmm_learnable_fwd", n_ptr=7, n_int=5):
    """``csrc/<entry>.cu`` built with the constants ``names`` of ``header``
    set to each shape of ``shapes`` (kernel 7 at each (parts, pairs) by
    default): {shape: the library's C entry ``entry``, taking ``n_ptr``
    pointers, ``n_int`` ints and the stream}."""
    from repro_torch.kernels import _build
    walk = (_build.CSRC / header).read_text()
    procs = {}
    for shape in shapes:
        d = _build.BUILD_ROOT / "probe" / (
            f"{entry}-" + "x".join(str(v) for v in shape))
        d.mkdir(parents=True, exist_ok=True)
        text = walk
        for name, value in zip(names, shape):
            text, n = re.subn(
                rf"constexpr int {name} = \d+;",
                f"constexpr int {name} = {value};", text)
            assert n == 1, name
        for src in _build.CSRC.glob("*.cu*"):
            (d / src.name).write_text(
                text if src.name == header else src.read_text())
        log = open(d / "nvcc.log", "w")
        procs[shape] = (d, log, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(d), "-o",
             str(d / "lib.so"), str(d / f"{entry}.cu")],
            stdout=log, stderr=subprocess.STDOUT))
    fns = {}
    for shape, (d, log, proc) in procs.items():
        if proc.wait() != 0:
            sys.exit(f"probe: build {shape} failed, see {d / 'nvcc.log'}")
        log.close()
        fn = getattr(ctypes.CDLL(str(d / "lib.so")), entry)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
            + [ctypes.c_void_p]
        fns[shape] = fn
    return fns


def launch(fn, f, w, xv, xi, out) -> None:
    """One launch of a kernel-7 library built by ``build_variants``, as
    the port's wrapper makes it."""
    from repro_torch.kernels.drspmm import _arena_sched
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    c, br, ec = f.nbr.shape
    rc = fn(p(_arena_sched(f)), p(f.nbr), p(f.eid), p(w),
            p(xv), p(xi), p(out),
            f.n_blocks, br, ec, xv.shape[1], out.shape[1],
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc:
        raise RuntimeError(f"kernel 7 variant: CUDA error {rc}")


def launch_k1(fn, f, xv, xi, out) -> None:
    """One launch of a kernel-1 library built by ``build_variants``, as
    the port's wrapper makes it."""
    from repro_torch.kernels.drspmm import _arena_sched
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    _c, br, ec = f.nbr.shape
    rc = fn(p(_arena_sched(f)), p(f.nbr), p(f.w), p(xv),
            p(xi), p(out),
            f.n_blocks, br, ec, xv.shape[1], out.shape[1],
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc:
        raise RuntimeError(f"kernel 1 variant: CUDA error {rc}")


def kernel1(repeats: int, shapes) -> None:
    """The ``--kernel 1`` probe (module docstring)."""
    from chip_smoke import arena_csr
    from repro_torch.kernels import _build
    from repro_torch.kernels import drspmm as K1
    f, xv, xi, dim = table1_arena()
    _build.build_all()
    runs = torch.diff(f.blk_ptr)
    rs = runs.float()
    order = torch.argsort(runs, descending=True)
    longest = torch.zeros(f.n_blocks, dtype=torch.bool, device=runs.device)
    longest[order[:LONGEST_BLOCKS]] = True
    print(json.dumps({
        "kernel": "drspmm_fwd_arena", "chunks": f.n_chunks,
        "blocks": f.n_blocks, "row_block": f.row_block,
        "ec": f.nbr.shape[2], "k": xv.shape[1], "dim": dim,
        "real_slots": int((f.w != 0).sum()),
        "run_mean": float(rs.mean()), "run_median": float(rs.median()),
        "run_p99": float(torch.quantile(rs, 0.99)),
        "run_max": int(runs.max()),
        "blocks_at_max": int((runs == runs.max()).sum()),
        "blocks_of_one_chunk": int((runs == 1).sum()),
        "ptxas": ptxas(_build.build_dir() / "drspmm_arena_fwd.log",
                       NARROW_WALK)}), flush=True)
    cases = {"all": f, "longest": only_blocks(f, longest),
             "others": only_blocks(f, ~longest),
             "longest-one-row": one_row(f, longest)}
    for part, fp in cases.items():
        r = torch.diff(fp.blk_ptr)
        y = K1.drspmm_fwd_arena(fp, xv, xi, dim)
        ref = K1.drspmm_fwd_arena_plain(fp, xv, xi, dim)
        torch.cuda.synchronize()
        case = {"kernel": "drspmm_fwd_arena", "blocks": part}
        print(json.dumps({
            **case, "chunks": int(r.sum()), "longest_run": int(r.max()),
            "real_slots": int((fp.w != 0).sum()), "sha256": sha(y),
            "max_abs_err": float((y - ref).abs().max()),
            "max_abs_ref": float(ref.abs().max())}), flush=True)
        for rep in range(repeats if part == "all" else 1):
            print(json.dumps({**case, "repeat": rep, **times(
                lambda: K1.drspmm_fwd_arena(fp, xv, xi, dim))}), flush=True)
    a = arena_csr(f, xv.shape[0])
    xd = K1._densify(xv, xi, dim)
    print(json.dumps({"kernel": "torch.sparse.mm", "blocks": "all",
                      **times(lambda: a @ xd)}), flush=True)
    for shape, fn in build_variants(
            shapes, names=NARROW_NAMES, entry="drspmm_arena_fwd", n_ptr=6,
            n_int=5).items():
        d = _build.BUILD_ROOT / "probe" / (
            "drspmm_arena_fwd-" + "x".join(map(str, shape)))
        named = dict(zip(NARROW_NAMES, shape))
        print(json.dumps({"kernel": "drspmm_fwd_arena", **named,
                          "ptxas": ptxas(d / "nvcc.log", NARROW_WALK)}),
              flush=True)
        for part in ("all", "longest", "others"):
            fp = cases[part]
            want = K1.drspmm_fwd_arena(fp, xv, xi, dim)
            out = torch.empty_like(want)
            launch_k1(fn, fp, xv, xi, out)
            ref = K1.drspmm_fwd_arena_plain(fp, xv, xi, dim)
            torch.cuda.synchronize()
            print(json.dumps({
                "kernel": "drspmm_fwd_arena", **named, "blocks": part,
                "same_as_wrapper": bool(torch.equal(out, want)),
                "max_abs_err": float((out - ref).abs().max()),
                **times(lambda: launch_k1(fn, fp, xv, xi, out))}),
                flush=True)


def table1_near():
    """(``near`` arena, its transpose, x, gY) of the first served Table-1
    batch on the card, as ``chip_smoke.py`` hands them to kernel 6; x and
    gY (dim 64) seeded normal."""
    from chip_smoke import HIDDEN
    from repro_torch.graphs.collate import collate_graphs
    from repro_torch.graphs.generator import generate_design
    from repro_torch.kernels import ops
    table1 = (generate_design(0, "small", 1.0)
              + generate_design(1, "medium", 1.0))
    near = collate_graphs(table1[:2], device="cuda").graph.edges["near"]
    g = torch.Generator().manual_seed(SEED)
    x = torch.randn((near.adj.n_src, HIDDEN), generator=g)
    gy = torch.randn((near.adj.n_dst, HIDDEN), generator=g)
    return (ops.device_arena(near.adj, "cuda"),
            ops.device_arena(near.adj_t, "cuda"), x.cuda(), gy.cuda())


def launch_k6(fn, f, x, out) -> None:
    """One launch of a kernel-6 library built by ``build_variants``, as
    the port's wrapper makes it."""
    from repro_torch.kernels.drspmm import _arena_sched
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    _c, br, ec = f.nbr.shape
    rc = fn(p(_arena_sched(f)), p(f.nbr), p(f.w), p(x), p(out), f.n_blocks,
            br, ec, x.shape[1],
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc:
        raise RuntimeError(f"kernel 6 variant: CUDA error {rc}")


def kernel6(repeats: int, shapes) -> None:
    """The ``--kernel 6`` probe (module docstring)."""
    from chip_smoke import arena_csr
    from repro_torch.kernels import _build
    from repro_torch.kernels import drspmm as K1
    f_fwd, f_t, x, gy = table1_near()
    _build.build_all()
    dirs = {"forward": (f_fwd, x), "transposed": (f_t, gy)}
    cases = {}
    for what, (f, opnd) in dirs.items():
        runs = torch.diff(f.blk_ptr)
        heavy, long = runs >= HEAVY_RUN, runs >= LONG_RUN
        # position in the grid of each row-block: reverse arena order (the
        # chunk-at-a-time walk) and longest run first (the schedule)
        rev = (f.n_blocks - 1 - torch.nonzero(heavy).flatten()).float()
        by_run = torch.argsort(runs, descending=True, stable=True)
        pos = torch.empty_like(by_run)
        pos[by_run] = torch.arange(f.n_blocks, device=by_run.device)
        sched = pos[heavy].float()
        real = int((f.w != 0).sum())
        dim = opnd.shape[1]
        hist = torch.bincount(runs.long()).tolist()
        print(json.dumps({
            "kernel": "spmm_arena", "direction": what,
            "chunks": f.n_chunks, "blocks": f.n_blocks,
            "row_block": f.row_block, "ec": f.nbr.shape[2], "dim": dim,
            "R_arena": f.n_arena_rows, "N_src": opnd.shape[0],
            "real_slots": real,
            "padding": 1 - real / f.nbr.numel(),
            "l2_sector_bytes": real * -(-4 * dim // 32) * 32,
            "run_hist": {n: c for n, c in enumerate(hist) if c},
            "heavy_blocks": int(heavy.sum()),
            "heavy_chunks": int(runs[heavy].sum()),
            "long_blocks": int(long.sum()),
            "long_chunks": int(runs[long].sum()),
            "longest_run": int(runs.max()),
            "heavy_start_reverse_order": [float(rev.min()) / f.n_blocks,
                                          float(rev.max()) / f.n_blocks],
            "heavy_start_sched_order": [float(sched.min()) / f.n_blocks,
                                        float(sched.max()) / f.n_blocks],
            "ptxas": ptxas(_build.build_dir() / "spmm_arena.log",
                           SPMM_WALK)}), flush=True)
        parts = {"all": f, "heavy": only_blocks(f, heavy),
                 "others": only_blocks(f, ~heavy)}
        if bool(long.any()):
            parts["long"] = only_blocks(f, long)
        parts["all-one-row"] = one_row(f, torch.ones_like(heavy))
        cases[what] = parts
        for part, fp in parts.items():
            r = torch.diff(fp.blk_ptr)
            y = K1.spmm_arena(fp, opnd)
            ref = K1.spmm_arena_plain(fp, opnd)
            torch.cuda.synchronize()
            case = {"kernel": "spmm_arena", "direction": what,
                    "blocks": part}
            print(json.dumps({
                **case, "chunks": int(r.sum()), "longest_run": int(r.max()),
                "real_slots": int((fp.w != 0).sum()),
                "max_abs_err": float((y - ref).abs().max()),
                "max_abs_ref": float(ref.abs().max())}), flush=True)
            for rep in range(repeats if part == "all" else 1):
                y = K1.spmm_arena(fp, opnd)
                torch.cuda.synchronize()
                print(json.dumps({
                    **case, "repeat": rep,
                    **({"sha256": sha(y)} if part == "all" else {}),
                    **times(lambda: K1.spmm_arena(fp, opnd))}), flush=True)
        a = arena_csr(f, opnd.shape[0])
        print(json.dumps({"kernel": "torch.sparse.mm", "direction": what,
                          "blocks": "all", **times(lambda: a @ opnd)}),
              flush=True)
    for shape, fn in build_variants(
            shapes, header="spmm_arena.cu", names=SPMM_NAMES,
            entry="spmm_arena", n_ptr=5, n_int=4).items():
        d = _build.BUILD_ROOT / "probe" / (
            "spmm_arena-" + "x".join(map(str, shape)))
        named = dict(zip(SPMM_NAMES, shape))
        print(json.dumps({"kernel": "spmm_arena", **named,
                          "ptxas": ptxas(d / "nvcc.log", SPMM_WALK),
                          "sass_dim64": sass_order(d / "lib.so",
                                                   SPMM_WALK + "ILi2E")}),
              flush=True)
        for what, (_f, opnd) in dirs.items():
            for part in ("all", "heavy"):
                fp = cases[what][part]
                want = K1.spmm_arena(fp, opnd)
                out = torch.empty_like(want)
                launch_k6(fn, fp, opnd, out)
                ref = K1.spmm_arena_plain(fp, opnd)
                torch.cuda.synchronize()
                print(json.dumps({
                    "kernel": "spmm_arena", **named, "direction": what,
                    "blocks": part,
                    "same_as_wrapper": bool(torch.equal(out, want)),
                    "max_abs_err": float((out - ref).abs().max()),
                    **times(lambda: launch_k6(fn, fp, opnd, out))}),
                    flush=True)


def kernel7(shapes) -> None:
    """The kernel-7 probe (module docstring)."""
    from repro_torch.kernels import drspmm as K1
    f, nnz, w, xv, iota, perm, adj = gat_arena()
    runs = torch.diff(f.blk_ptr)
    heavy = torch.zeros(f.n_blocks, dtype=torch.bool, device=runs.device)
    heavy[torch.argsort(runs, descending=True)[:HEAVY_BLOCKS]] = True
    longest = torch.zeros_like(heavy)
    longest[torch.argsort(runs, descending=True)[:LONGEST_BLOCKS]] = True
    arenas = {"all": f, "heavy": only_blocks(f, heavy),
              "light": only_blocks(f, ~heavy),
              "longest": only_blocks(f, longest),
              "longest-one-row": one_row(f, longest)}
    for part, fp in arenas.items():
        r = torch.diff(fp.blk_ptr)
        for cols, xi in (("iota", iota), ("perm", perm)):
            y = K1.drspmm_fwd_learnable(fp, nnz, w, xv, xi, 64)
            ref = K1.drspmm_fwd_learnable_plain(fp, nnz, w, xv, xi, 64)
            torch.cuda.synchronize()
            print(json.dumps({
                "kernel": "drspmm_fwd_learnable", "blocks": part,
                "columns": cols, "chunks": int(r.sum()),
                "longest_run": int(r.max()),
                "real_slots": int((fp.eid >= 0).sum()),
                "max_abs_err": float((y - ref).abs().max()),
                "ms": cuda_ms(lambda: K1.drspmm_fwd_learnable(
                    fp, nnz, w, xv, xi, 64))}), flush=True)
    wa = K1._canon_slot_weights(f, nnz, w)
    f6 = dataclasses.replace(f, w=wa)
    for part, fp in (("all", f6), ("longest", only_blocks(f6, longest))):
        print(json.dumps({"kernel": "spmm_arena", "blocks": part,
                          "ms": cuda_ms(lambda: K1.spmm_arena(fp, xv))}),
              flush=True)
    rows = (f.block_of.long()[:, None] * f.row_block
            + torch.arange(f.row_block, device=wa.device))
    mask = wa != 0
    a = torch.sparse_coo_tensor(
        torch.stack([rows[:, :, None].expand(f.nbr.shape)[mask],
                     f.nbr.long()[mask]]), wa[mask],
        (f.n_arena_rows, adj.n_src)).coalesce().to_sparse_csr()
    print(json.dumps({"kernel": "torch.sparse.mm", "blocks": "all",
                      "ms": cuda_ms(lambda: a @ xv)}), flush=True)
    for (parts, pairs), fn in build_variants(shapes).items():
        for part in ("all", "longest", "light"):
            fp = arenas[part]
            for cols, xi in (("iota", iota), ("perm", perm)):
                out = torch.empty((fp.n_arena_rows, 64), device="cuda")
                launch(fn, fp, w, xv, xi, out)
                ref = K1.drspmm_fwd_learnable_plain(fp, nnz, w, xv, xi, 64)
                torch.cuda.synchronize()
                print(json.dumps({
                    "kernel": "drspmm_fwd_learnable", "parts": parts,
                    "pairs": pairs, "blocks": part, "columns": cols,
                    "max_abs_err": float((out - ref).abs().max()),
                    "ms": cuda_ms(lambda: launch(fn, fp, w, xv, xi, out))}),
                    flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", type=int, choices=(1, 6, 7), default=7,
                    help="the kernel to probe (default 7)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="kernels 1 and 6: timings over the whole arena")
    ap.add_argument("--sweep", default="",
                    help="comma-separated shapes of the walk to build and "
                         "time: PARTSxSPLITxLOADS of the k <= 32 walk with "
                         "--kernel 1 (e.g. 2x32x4,1x64x8), LOADSxBLOCKS of "
                         "kernel 6 with --kernel 6 (e.g. 32x4,8x8), "
                         "else PARTSxPAIRS of the wide walk (e.g. "
                         "1x32,2x8,4x8)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("arena_fwd_probe: no CUDA device visible")
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root / "src"), str(root)]
    torch.backends.cuda.matmul.allow_tf32 = False
    warnings.filterwarnings("ignore", message="Sparse")
    shapes = [tuple(int(v) for v in s.split("x"))
              for s in args.sweep.split(",") if s]
    if args.kernel == 1:
        kernel1(args.repeats, shapes)
    elif args.kernel == 6:
        kernel6(args.repeats, shapes)
    else:
        kernel7(shapes)
    print(card())


if __name__ == "__main__":
    main()
