"""Where the per-degree-bucket kernels spend their time, on one NVIDIA card:
the DR-SpMM forward (kernel 10, the default), its sampled backward
(kernel 11) and the dense-operand SpMM (kernel 12).

    PYTHONPATH=src python3 tools/bucket_fwd_probe.py [--sweep 2x32x8x8x5x8,...]
    PYTHONPATH=src python3 tools/bucket_fwd_probe.py --kernel 11 \
        [--repeats 3] [--sweep 1x32x8x8x5x16,...]
    PYTHONPATH=src python3 tools/bucket_fwd_probe.py --kernel 12 \
        [--repeats 3] [--sweep 2x32x8x8x5x16,...]

Kernel 10 (no ``--kernel``, or ``--kernel 10``):

Builds the operand the serial path's first layer hands kernel 10 on the
first Table-1 partition (``generate_design(0, "small", 1.0)``): the seeded
model of ``chip_smoke.py`` (hidden 64), its cell embedding's top-16 CBSR
rows (k 16, dim 64), and the partition's ``near`` relation in its degree
buckets (R x E 8 x 4, 544 x 16, 5440 x 64, 1696 x 256, 40 x 260).  For
each bucket it times, with CUDA events (``ms``: mean of 50 L2-warm calls
after a warm-up, which reads the host's launch rate where that is slower
than the kernel) and with ``torch.profiler`` (``device_ms``: the device
time ``chip_smoke.device_breakdown`` traces over 50 more calls, a call):

* kernel 10 over the whole bucket;
* kernel 10 over the bucket's 16 longest rows alone (most real slots):
  the chain of one row's walk with the card otherwise idle;
* kernel 12 (``spmm_bucket``) over the whole bucket with the densified
  operand: the same gathers without the index reads or the scatter;
* ``torch.sparse.mm`` of the bucket's CSR by the densified operand (the
  library yardstick of ``chip_smoke.py``);

then each time summed over the five buckets.

With ``--sweep P64xSLOTSxPARTSxWARPSxMINxFLIGHT,...`` it also builds
kernel 10 at other ``kParts64`` x ``kWarpSlots`` x ``kMaxParts`` x
``kBlockWarps`` x ``kMinBlocks`` x ``kInFlight`` of
``csrc/drspmm_bucket_fwd.cu`` (warps a row at 33-64 slots x slots a warp
past 64 x most warps a row x warps a block x blocks an SM must hold,
which caps the registers x slots whose CBSR loads a warp issues together;
one ``nvcc`` each, all started together, into
``build/repro_torch/probe/``) and times each over every bucket, whole and
its 16 longest rows.

``--kernel 12`` seeds a dense operand (dim 64, normal) for each of four
bucket lists: partition 0's ``near`` buckets (``near``), their
transposes walked with a seeded gY (``near_t``), and the homogenized
partition 0's buckets forward and transposed (``homo``, ``homo_t``,
which ``train-homo-gcn-bucket`` runs).  ``--kernel 11`` takes the
transposed ``near`` buckets with a seeded gY and the first layer's cell
CBSR columns (k 16) at each bucket's rows.  For each bucket it prints the
real slots, the longest row, the L2 sectors the gathers touch
(``l2_sector_bytes``: a whole 8-sector row a slot for kernel 12, the
distinct sectors of the row's k columns for kernel 11) and times (``ms``,
``device_ms`` as above):

* the kernel over the whole bucket, ``--repeats`` times, each with the
  SHA-256 of its output, and its error against the plain version;
* the kernel over the bucket's 16 longest rows alone;
* the kernel over the bucket with every weight 0 (``frame``: the same
  slab walk without a row load);
* the library call: ``torch.sparse.mm`` of the bucket's CSR by the
  operand (kernel 11: then the gather at ``xi_rows``);

then the sums over each list's buckets, and for kernel 12 kernel 6
(``spmm_arena``) over the same relation's arena, the same function in
one launch.  With ``--sweep
P64xSLOTSxPARTSxWARPSxMINxLOADS,...`` it builds the kernel at other
``kParts64`` x ``kWarpSlots`` x ``kMaxParts`` x ``kBlockWarps`` x
``kMinBlocks`` x ``kLoads`` (kernel 11: ``kNarrowLoads``) of its source
(the split of a row over warps as for kernel 10; blocks an SM, which caps
the registers; floats, or kernel 11's samples, a lane has in flight a
batch), prints each build's registers and spills, and times it over the
``near`` and ``near_t`` buckets, whole and their 16 longest rows, with
the SHA-256 of each whole output.  On a tree whose kernels lack these constants only the wrapper
is timed, so a parent from ``git archive`` can run this probe copied in.

Prints one JSON object a line, then the card's name and power limit.
Needs one card; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from arena_bwd_probe import times
from arena_fwd_probe import SEED, build_variants, card, ptxas, sha

LONGEST_ROWS = 16
SWEEP_NAMES = ("kParts64", "kWarpSlots", "kMaxParts", "kBlockWarps",
               "kMinBlocks", "kInFlight")
# kernels 11 and 12: (source, C entry, pointers, ints, the walk's kernels
# in a ptxas log, the sweep's constants)
SPLIT_NAMES = ("kParts64", "kWarpSlots", "kMaxParts", "kBlockWarps",
               "kMinBlocks")
SOURCES = {
    11: ("drspmm_bucket_bwd", 5, 4, r"bucket_bwd_(narrow|wide)",
         SPLIT_NAMES + ("kNarrowLoads",)),
    12: ("spmm_bucket", 4, 3, "spmm_bucket_kernel",
         SPLIT_NAMES + ("kLoads",))}
DIM = 64


def near_buckets(device="cuda"):
    """(the near relation's buckets on ``device``, CBSR values, CBSR
    indices, the densified operand, dim) of partition 0's first layer."""
    from chip_smoke import FEAT, HIDDEN, K, LAYERS
    from repro_torch.core.hetero_mp import HeteroMPConfig, _sparsify_types
    from repro_torch.graphs.generator import generate_design
    from repro_torch.kernels import drspmm as K1
    from repro_torch.kernels import ops
    from repro_torch.models.hgnn import DRCircuitGNN
    g = generate_design(0, "small", 1.0)[0].to(device)
    model = DRCircuitGNN(FEAT, FEAT, HIDDEN, LAYERS, device=device,
                         generator=torch.Generator().manual_seed(SEED))
    cfg = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K, backend="bucket")
    with torch.inference_mode():
        c_cell, _ = _sparsify_types(g.x_cell @ model.in_cell,
                                    g.x_net @ model.in_net, cfg)
    xv = c_cell.values.float().contiguous()
    xi = c_cell.idx.to(torch.int32).contiguous()
    bk = ops.device_buckets(g.edges["near"].adj, device)
    return bk.buckets, xv, xi, K1._densify(xv, xi, HIDDEN), HIDDEN


def longest_rows(b, args=()):
    """(the bucket's ``LONGEST_ROWS`` rows with the most real slots, as a
    bucket of its own; the operand args for them: kernel 11's ``xi_rows``
    follow the rows)."""
    from repro_torch.graphs.ell import ELLBucket
    top = torch.argsort((b.w != 0).sum(1), descending=True)[:LONGEST_ROWS]
    rows = ELLBucket(rows=b.rows[top], nbr=b.nbr[top].contiguous(),
                     w=b.w[top].contiguous())
    return rows, tuple(a[top].contiguous() if i == 1 else a
                       for i, a in enumerate(args))


def launch(fn, b, xv, xi, out) -> None:
    """One launch of a kernel-10 library built by ``build_variants``, as
    the port's wrapper makes it."""
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    r, e = b.nbr.shape
    rc = fn(p(b.nbr), p(b.w), p(xv), p(xi), p(out), r, e, xv.shape[1],
            out.shape[1], ctypes.c_void_p(torch.cuda.current_stream()
                                          .cuda_stream))
    if rc:
        raise RuntimeError(f"kernel 10 variant: CUDA error {rc}")


def add(total: dict, t: dict) -> None:
    for key, v in t.items():
        total[key] = total.get(key, 0.0) + v


def kernel10(sweep: str) -> None:
    """The kernel-10 probe (module docstring)."""
    from chip_smoke import bucket_csr
    from repro_torch.kernels import drspmm as K1
    buckets, xv, xi, xd, dim = near_buckets()
    totals = {}
    for b in buckets:
        r, e = b.nbr.shape
        real = b.w != 0
        top = longest_rows(b)[0]
        csr = bucket_csr(b, xv.shape[0])
        y = K1.drspmm_fwd_bucket(b, xv, xi, dim)
        ref = K1.drspmm_fwd_bucket_plain(b, xv, xi, dim)
        torch.cuda.synchronize()
        base = {"bucket": f"{r}x{e}", "real_slots": int(real.sum()),
                "longest_row": int(real.sum(1).max())}
        parts = {
            "drspmm_fwd_bucket": lambda: K1.drspmm_fwd_bucket(b, xv, xi, dim),
            "drspmm_fwd_bucket-longest": lambda: K1.drspmm_fwd_bucket(
                top, xv, xi, dim),
            "spmm_bucket": lambda: K1.spmm_bucket(b, xd),
            "torch.sparse.mm": lambda: csr @ xd}
        for name, fn in parts.items():
            t = times(fn)
            extra = {"max_abs_err": float((y - ref).abs().max())} \
                if name == "drspmm_fwd_bucket" else {}
            print(json.dumps({"kernel": name, **base, **extra, **t}),
                  flush=True)
            add(totals.setdefault(name, {}), t)
    for name, t in totals.items():
        print(json.dumps({"kernel": name, "bucket": "sum", **t}), flush=True)
    shapes = [tuple(int(v) for v in s.split("x"))
              for s in sweep.split(",") if s]
    for shape, fn in build_variants(
            shapes, header="drspmm_bucket_fwd.cu", names=SWEEP_NAMES,
            entry="drspmm_bucket_fwd", n_ptr=5, n_int=4).items():
        total = {}
        for b in buckets:
            for part, bp in (("whole", b), ("longest", longest_rows(b)[0])):
                out = torch.empty((bp.nbr.shape[0], dim), device="cuda")
                launch(fn, bp, xv, xi, out)
                ref = K1.drspmm_fwd_bucket_plain(bp, xv, xi, dim)
                torch.cuda.synchronize()
                t = times(lambda: launch(fn, bp, xv, xi, out))
                print(json.dumps({
                    "kernel": "drspmm_fwd_bucket",
                    **dict(zip(SWEEP_NAMES, shape)),
                    "bucket": "x".join(map(str, b.nbr.shape)), "rows": part,
                    "max_abs_err": float((out - ref).abs().max()), **t}),
                    flush=True)
                if part == "whole":
                    add(total, t)
        print(json.dumps({"kernel": "drspmm_fwd_bucket",
                          **dict(zip(SWEEP_NAMES, shape)), "bucket": "sum",
                          **total}), flush=True)


def split_cases(kernel: int) -> dict:
    """{list name: (adjacency, [(bucket, operand args)])} of ``--kernel
    11`` / ``12`` (module docstring), on the card."""
    from repro_torch.graphs.generator import generate_design
    from repro_torch.kernels import ops
    from repro_torch.models.hgnn import homogenize
    g = torch.Generator().manual_seed(SEED)
    seeded = lambda n: torch.randn((n, DIM), generator=g).cuda()
    near = generate_design(0, "small", 1.0)[0].edges["near"]
    lists = {"near_t": near.adj_t}
    if kernel == 12:
        homo = homogenize(generate_design(0, "small", 1.0)[0])
        lists = {"near": near.adj, "near_t": near.adj_t,
                 "homo": homo[0], "homo_t": homo[1]}
    else:
        _b, _xv, xi, _xd, _dim = near_buckets()
    cases = {}
    for what, adj in lists.items():
        opnd = seeded(adj.n_src)
        cases[what] = (adj, [
            (b, (opnd,) if kernel == 12
             else (opnd, xi.index_select(0, b.rows).contiguous()))
            for b in ops.device_buckets(adj, "cuda").buckets])
    return cases


def frame_of(b):
    """The bucket with every weight 0: the same slab walk, no row loads."""
    from repro_torch.graphs.ell import ELLBucket
    return ELLBucket(rows=b.rows, nbr=b.nbr, w=torch.zeros_like(b.w))


def sector_bytes(b, args) -> int:
    """The L2 sectors of 32 bytes the bucket's real slots touch: a whole
    operand row a slot (kernel 12), or the distinct sectors of the row's
    sampled columns (kernel 11).  ``chip_smoke.bucket_sectors``'s count,
    kept here too so that the probe runs beside an older
    ``chip_smoke.py``."""
    real = (b.w != 0).sum(1)
    if len(args) == 1:
        return int(real.sum()) * -(-4 * args[0].shape[1] // 32) * 32
    s = torch.sort(args[1].long() // 8, dim=1).values
    distinct = 1 + (s[:, 1:] != s[:, :-1]).sum(1)
    return int((real * distinct).sum()) * 32


def launch_split(kernel: int, fn, b, args, out) -> None:
    """One launch of a kernel-11 or -12 library built by
    ``build_variants``, as the port's wrapper makes it."""
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    r, e = b.nbr.shape
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    if kernel == 12:
        rc = fn(p(b.nbr), p(b.w), p(args[0]), p(out), r, e, out.shape[1],
                stream)
    else:
        gy, xi_rows = args
        rc = fn(p(b.nbr), p(b.w), p(gy), p(xi_rows), p(out), r, e,
                xi_rows.shape[1], gy.shape[1], stream)
    if rc:
        raise RuntimeError(f"kernel {kernel} variant: CUDA error {rc}")


def split_kernels(kernel: int, repeats: int, sweep: str) -> None:
    """The ``--kernel 11`` / ``--kernel 12`` probe (module docstring)."""
    from chip_smoke import bucket_csr
    from repro_torch.kernels import _build
    from repro_torch.kernels import drspmm as K1
    entry, n_ptr, n_int, walk, names = SOURCES[kernel]
    name = "spmm_bucket" if kernel == 12 else "drspmm_bwd_bucket"
    kern, plain = getattr(K1, name), getattr(K1, name + "_plain")
    cases = split_cases(kernel)
    _build.build_all()
    print(json.dumps({"kernel": name, "ptxas": ptxas(
        _build.build_dir() / f"{entry}.log", walk)}), flush=True)
    for what, (adj, pairs) in cases.items():
        totals = {}
        for b, args in pairs:
            r, e = b.nbr.shape
            real = b.w != 0
            top, top_args = longest_rows(b, args)
            y, ref = kern(b, *args), plain(b, *args)
            torch.cuda.synchronize()
            base = {"kernel": name, "list": what, "bucket": f"{r}x{e}"}
            print(json.dumps({
                **base, "real_slots": int(real.sum()),
                "longest_row": int(real.sum(1).max()),
                "l2_sector_bytes": sector_bytes(b, args),
                "max_abs_err": float((y - ref).abs().max()),
                "max_abs_ref": float(ref.abs().max())}), flush=True)
            for rep in range(repeats):
                y = kern(b, *args)
                torch.cuda.synchronize()
                t = times(lambda: kern(b, *args))
                print(json.dumps({**base, "rows": "whole", "repeat": rep,
                                  "sha256": sha(y), **t}), flush=True)
                if rep == 0:
                    add(totals.setdefault("whole", {}), t)
            t = times(lambda: kern(top, *top_args))
            print(json.dumps({**base, "rows": "longest", **t}), flush=True)
            add(totals.setdefault("longest", {}), t)
            frame = frame_of(b)
            t = times(lambda: kern(frame, *args))
            print(json.dumps({**base, "rows": "frame", **t}), flush=True)
            add(totals.setdefault("frame", {}), t)
            csr = bucket_csr(b, args[0].shape[0])
            lib = (lambda: csr @ args[0]) if kernel == 12 else (
                lambda: torch.gather(csr @ args[0], 1, args[1].long()))
            t = times(lib)
            print(json.dumps({**base, "rows": "library", **t}), flush=True)
            add(totals.setdefault("library", {}), t)
        for rows, t in totals.items():
            print(json.dumps({"kernel": name, "list": what, "bucket": "sum",
                              "rows": rows, **t}), flush=True)
        if kernel == 12:
            # kernel 6, the same function over the relation's arena
            from repro_torch.kernels import ops
            arena, opnd = ops.device_arena(adj, "cuda"), pairs[0][1][0]
            print(json.dumps({
                "kernel": "spmm_arena", "list": what, "bucket": "arena",
                "real_slots": int((arena.w != 0).sum()),
                **times(lambda: K1.spmm_arena(arena, opnd))}), flush=True)
    shapes = [tuple(int(v) for v in s.split("x"))
              for s in sweep.split(",") if s]
    text = (_build.CSRC / f"{entry}.cu").read_text()
    missing = [n for n in names if f"constexpr int {n} = " not in text]
    if shapes and missing:
        print(json.dumps({"kernel": name, "sweep": "skipped: the source "
                          f"has no {missing}"}), flush=True)
        shapes = []
    for shape, fn in build_variants(
            shapes, header=f"{entry}.cu", names=names, entry=entry,
            n_ptr=n_ptr, n_int=n_int).items():
        named = dict(zip(names, shape))
        d = _build.BUILD_ROOT / "probe" / (
            f"{entry}-" + "x".join(map(str, shape)))
        print(json.dumps({"kernel": name, **named,
                          "ptxas": ptxas(d / "nvcc.log", walk)}), flush=True)
        for what in ("near", "near_t"):
            total = {}
            for b, args in cases.get(what, (None, []))[1]:
                bucket = "x".join(map(str, b.nbr.shape))
                for part, (bp, a) in (("whole", (b, args)),
                                      ("longest", longest_rows(b, args))):
                    out = torch.empty_like(plain(bp, *a))
                    launch_split(kernel, fn, bp, a, out)
                    ref = plain(bp, *a)
                    torch.cuda.synchronize()
                    extra = {"sha256": sha(out)} if part == "whole" else {}
                    t = times(lambda: launch_split(kernel, fn, bp, a, out))
                    print(json.dumps({
                        "kernel": name, **named, "list": what,
                        "bucket": bucket, "rows": part,
                        "max_abs_err": float((out - ref).abs().max()),
                        **extra, **t}), flush=True)
                    if part == "whole":
                        add(total, t)
            print(json.dumps({"kernel": name, **named, "list": what,
                              "bucket": "sum", **total}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernel", type=int, default=10, choices=(10, 11, 12),
                    help="10: the DR-SpMM forward (default); 11: its "
                         "sampled backward; 12: the dense-operand SpMM")
    ap.add_argument("--repeats", type=int, default=1,
                    help="kernels 11 and 12: timings of each whole bucket")
    ap.add_argument("--sweep", default="",
                    help="comma-separated shapes of the walk to build and "
                         "time: P64xSLOTSxPARTSxWARPSxMINxFLIGHT for kernel "
                         "10 (e.g. 2x32x8x8x5x8), P64xSLOTSxPARTSxWARPSxMIN"
                         "xLOADS for kernels 11 and 12 (e.g. 2x32x8x8x6x16)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bucket_fwd_probe: no CUDA device visible")
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root / "src"), str(root)]
    if args.kernel == 10:
        kernel10(args.sweep)
    else:
        split_kernels(args.kernel, args.repeats, args.sweep)
    print(card())


if __name__ == "__main__":
    main()
