"""Where the arena DR-SpMM forward (kernel 1) and the learnable-edge arena
forward (kernel 7), which share one walk, spend their time, on one NVIDIA
card.

    PYTHONPATH=src python3 tools/arena_fwd_probe.py --kernel 1 \
        [--repeats 5] [--sweep 2x32x4,1x64x8,...]
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

Without ``--kernel 1`` it probes kernel 7:

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
import json
import re
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
                   entry="drspmm_learnable_fwd", n_ptr=8, n_int=5):
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
    rc = fn(p(f.blk_ptr), p(_arena_sched(f)), p(f.nbr), p(f.eid), p(w),
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
    rc = fn(p(f.blk_ptr), p(_arena_sched(f)), p(f.nbr), p(f.w), p(xv),
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
            shapes, names=NARROW_NAMES, entry="drspmm_arena_fwd", n_ptr=7,
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
    ap.add_argument("--kernel", type=int, choices=(1, 7), default=7,
                    help="the kernel to probe (default 7)")
    ap.add_argument("--repeats", type=int, default=3,
                    help="kernel 1: timings over the whole arena")
    ap.add_argument("--sweep", default="",
                    help="comma-separated shapes of the walk to build and "
                         "time: PARTSxSPLITxLOADS of the k <= 32 walk with "
                         "--kernel 1 (e.g. 2x32x4,1x64x8), else PARTSxPAIRS "
                         "of the wide walk (e.g. 1x32,2x8,4x8)")
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
    else:
        kernel7(shapes)
    print(card())


if __name__ == "__main__":
    main()
