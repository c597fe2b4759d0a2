"""Where the learnable-edge arena sampled backward (kernel 8) spends its
time, on one NVIDIA card.

    PYTHONPATH=src python3 tools/arena_bwd_probe.py [--sweep 16x3,8x1,...]

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
                             times)

DIM = 64


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
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    _c, br, ec = ft.nbr.shape
    rc = fn(p(ft.blk_ptr), p(ft.nbr), p(ft.eid), p(w), p(ft.rows), p(gy),
            p(xi), p(out), ft.n_blocks, br, ec, xi.shape[1], gy.shape[1],
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc:
        raise RuntimeError(f"kernel 8 variant: CUDA error {rc}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", default="",
                    help="comma-separated SLOTSxBLOCKS shapes of the "
                         "wide walk to build and time, e.g. 16x3,16x1")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("arena_bwd_probe: no CUDA device visible")
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root / "src"), str(root)]
    from repro_torch.kernels import drspmm as K1
    warnings.filterwarnings("ignore", message="Sparse")
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
    shapes = [tuple(int(v) for v in s.split("x"))
              for s in args.sweep.split(",") if s]
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
    print(card())


if __name__ == "__main__":
    main()
