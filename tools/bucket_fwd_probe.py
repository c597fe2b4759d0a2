"""Where the per-degree-bucket DR-SpMM forward (kernel 10) spends its time,
on one NVIDIA card.

    PYTHONPATH=src python3 tools/bucket_fwd_probe.py [--sweep 2x32x8x8x5x8,...]

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

Prints one JSON object a line, then the card's name and power limit.
Needs one card; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from arena_bwd_probe import times
from arena_fwd_probe import SEED, build_variants

LONGEST_ROWS = 16
SWEEP_NAMES = ("kParts64", "kWarpSlots", "kMaxParts", "kBlockWarps",
               "kMinBlocks", "kInFlight")


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


def longest_rows(b):
    """The bucket's ``LONGEST_ROWS`` rows with the most real slots, as a
    bucket of its own."""
    from repro_torch.graphs.ell import ELLBucket
    top = torch.argsort((b.w != 0).sum(1), descending=True)[:LONGEST_ROWS]
    return ELLBucket(rows=b.rows[top], nbr=b.nbr[top].contiguous(),
                     w=b.w[top].contiguous())


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", default="",
                    help="comma-separated P64xSLOTSxPARTSxWARPSxMINxFLIGHT "
                         "shapes of the walk to build and time, e.g. "
                         "2x32x8x8x5x8")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("bucket_fwd_probe: no CUDA device visible")
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root / "src"), str(root)]
    from chip_smoke import bucket_csr
    from repro_torch.kernels import drspmm as K1
    buckets, xv, xi, xd, dim = near_buckets()
    totals = {}
    for b in buckets:
        r, e = b.nbr.shape
        real = b.w != 0
        top = longest_rows(b)
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
              for s in args.sweep.split(",") if s]
    for shape, fn in build_variants(
            shapes, header="drspmm_bucket_fwd.cu", names=SWEEP_NAMES,
            entry="drspmm_bucket_fwd", n_ptr=5, n_int=4).items():
        total = {}
        for b in buckets:
            for part, bp in (("whole", b), ("longest", longest_rows(b))):
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
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
