"""Where the learnable-edge arena forward (kernel 7) spends its time, on one
NVIDIA card.

    PYTHONPATH=src python3 tools/arena_fwd_probe.py

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
import json
import os
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


def only_blocks(f, keep: torch.Tensor):
    """``f`` with the chunk ranges of the row-blocks outside ``keep`` (a
    bool mask over blocks) emptied: the same grid, less work."""
    keep_chunk = keep[f.block_of.long()]
    return dataclasses.replace(
        f, nbr=f.nbr[keep_chunk].contiguous(),
        w=f.w[keep_chunk].contiguous(), eid=f.eid[keep_chunk].contiguous(),
        block_of=f.block_of[keep_chunk].contiguous(),
        start=f.start[keep_chunk].contiguous(),
        blk_ptr=torch.searchsorted(
            f.block_of[keep_chunk].contiguous(),
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
        eid=g.eid.masked_fill(pad, -1))


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
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    c, br, ec = f.nbr.shape
    rc = fn(p(f.blk_ptr), p(f.nbr), p(f.eid), p(w), p(xv), p(xi), p(out),
            f.n_blocks, br, ec, xv.shape[1], out.shape[1],
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc:
        raise RuntimeError(f"kernel 7 variant: CUDA error {rc}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", default="",
                    help="comma-separated PARTSxPAIRS shapes of the wide "
                         "walk to build and time, e.g. 1x32,2x8,4x8")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("arena_fwd_probe: no CUDA device visible")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.kernels import drspmm as K1
    warnings.filterwarnings("ignore", message="Sparse")
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
    shapes = [tuple(int(v) for v in s.split("x"))
              for s in args.sweep.split(",") if s]
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
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main()
