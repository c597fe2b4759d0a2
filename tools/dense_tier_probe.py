"""Where the dense-tier kernels (kernel 5, the sampled backward, and kernel
2, the forward) spend their time, on one NVIDIA card.

    PYTHONPATH=src python3 tools/dense_tier_probe.py [--repeats 5]
        [--sweep 4x16x8x8,...] [--sweep-fwd 4x16x8x8,...]

Builds the operands ``chip_smoke.py`` hands kernels 5 and 2: the seeded
model of ``chip_smoke.py`` (hidden 64, k 16) on its scale-0.02 batch
(the first two partitions of ``generate_design(0, "small", 0.02)``,
``(1, "medium", 0.02)`` and ``(2, "large", 0.02)``, collated), whose
stacked transposed dense-tier table is 473 x 473; gY is
the first layer's cotangent of the batch's training loss on the dense
relations' rows.  It times, with CUDA events (``ms``: mean of 50 L2-warm
calls after a warm-up, which reads the host's launch rate where that is
slower than the kernel), with ``torch.profiler`` (``device_ms``: the
device time ``chip_smoke.device_breakdown`` traces over 50 more calls, a
call) and on the host's clock (``host_ms``: the time a call takes to
return, the device left to run behind it):

* kernel 5 over the whole table, ``--repeats`` times, with a SHA-256 of
  its output (parent and change are compared bit for bit by it);
* kernel 5 over the table cut to its first 32, 128 and 256 columns, gY
  cut to match: how its time grows with the columns it walks;
* ``torch.mm`` of the table by gY (the library yardstick);
* kernel 2 (``drspmm_dense_tier_fwd``) on the first layer's CBSR operand
  (the batch's 473 x 473 forward table), the same way: ``--repeats``
  times with the table's ``row_nnz_max`` and ``empty_rows`` and a SHA-256
  of the output, cut to its first 32, 128 and 256 source columns (the
  operand cut to match), and on a seeded 473 x 4,100 table of density
  0.01 (several windows a row); ``a @ xd`` on the densified operand is
  its library yardstick.

With ``--sweep WARPSxUNROLLxBATCHxMIN,...`` it also builds kernel 5 at
other ``kWarps`` x ``kUnroll`` x ``kBatch`` x ``kMinBlocks`` of
``csrc/drspmm_dense_tier_bwd.cu`` (warps a block x 32-entry groups a
warp loads before it tests any x pairs whose gY loads a lane issues
before it adds any x blocks an SM must hold, 1 for no cap; one ``nvcc``
each, all started together, into ``build/repro_torch/probe/``), prints
each build's registers and spills at every k/32, and times each over the
whole table, its column prefixes and a 473 x 4,100 table of density 0.01
made from a seed (several windows a row).  ``--sweep-fwd`` does the same
for kernel 2, at the constants of the same names in
``csrc/drspmm_dense_tier_fwd.cu`` (rows, not source rows, a block), over
its whole table, its prefixes and its 473 x 4,100 table.  Each sweep
build's output is checked bit for bit against the wrapper's.

Prints one JSON object a line, then the card's name and power limit.
Needs one card; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from arena_fwd_probe import (REPS, SEED, build_variants, card, ptxas, sha,
                             times)

PREFIXES = (32, 128, 256)
SWEEP_NAMES = ("kWarps", "kUnroll", "kBatch", "kMinBlocks")


def operands(device="cuda"):
    """(Aᵀ, gY, xi) of kernel 5 and (A, xv, xi, densified operand) of
    kernel 2, as ``chip_smoke.py`` builds them, on ``device``."""
    from chip_smoke import (FEAT, HIDDEN, K, LAYERS, backward_operands,
                            first_layer_operands)
    from repro_torch.core.hetero_mp import HeteroMPConfig
    from repro_torch.graphs.collate import collate_graphs
    from repro_torch.graphs.generator import generate_design
    from repro_torch.kernels import drspmm as K1
    from repro_torch.models.hgnn import DRCircuitGNN
    tiny = (generate_design(0, "small", 0.02)
            + generate_design(1, "medium", 0.02)
            + generate_design(2, "large", 0.02))
    small = collate_graphs(tiny[:2], device=device)
    model = DRCircuitGNN(FEAT, FEAT, HIDDEN, LAYERS, device=device,
                         generator=torch.Generator().manual_seed(SEED))
    cfg = HeteroMPConfig(hidden=HIDDEN, k_cell=K, k_net=K)
    plan = small.plan
    gy_cat, xi_b = backward_operands(model, small, cfg)
    gy = torch.cat([gy_cat[s.out_off:s.out_off + s.n_dst]
                    for s in plan.dense_segments]).contiguous()
    xv, xi_f, _ = first_layer_operands(model, small.graph, cfg)
    return ((plan.dense_bwd, gy, xi_b),
            (plan.dense_fwd, xv, xi_f, K1._densify(xv, xi_f, HIDDEN)))


def wide_table(m, density, xi, dim):
    """A seeded table of ``xi``'s rows by ``m`` columns at ``density`` and a
    seeded (m, dim) gY (the sweep's several-windows case), on xi's
    device."""
    rng = np.random.default_rng(SEED)
    a = rng.normal(size=(xi.shape[0], m)).astype(np.float32)
    a[rng.random(a.shape) >= density] = 0.0
    gy = rng.normal(size=(m, dim)).astype(np.float32)
    return (torch.from_numpy(a).to(xi.device),
            torch.from_numpy(gy).to(xi.device), xi)


def wide_fwd(n, density, a, k, dim):
    """A seeded table of ``a``'s rows by ``n`` source columns at
    ``density`` and a seeded CBSR operand of ``n`` rows (k columns in
    [0, dim), column 1 repeating column 0), on a's device."""
    rng = np.random.default_rng(SEED + 1)
    at = rng.normal(size=(a.shape[0], n)).astype(np.float32)
    at[rng.random(at.shape) >= density] = 0.0
    xv = rng.normal(size=(n, k)).astype(np.float32)
    xi = rng.integers(0, dim, (n, k), dtype=np.int32)
    xi[:, 1] = xi[:, 0]
    t = lambda x: torch.from_numpy(x).to(a.device)
    return t(at), t(xv), t(xi)


def host_ms(fn, reps: int = REPS) -> float:
    """Host time of one call: ``reps`` calls on the host's clock with the
    device left to run behind them (the rate events read when the device
    is the faster)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    ms = (time.perf_counter() - t) * 1e3 / reps
    torch.cuda.synchronize()
    return ms


def all_times(fn) -> dict:
    return {**times(fn), "host_ms": host_ms(fn)}


def launch(fn, a, gy, xi, out) -> None:
    """One launch of a kernel-5 library built by ``build_variants``, as the
    port's wrapper makes it."""
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    n, m = a.shape
    rc = fn(p(a), p(gy), p(xi), p(out), n, m, xi.shape[1], gy.shape[1],
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc:
        raise RuntimeError(f"kernel 5 variant: CUDA error {rc}")


def launch_fwd(fn, a, xv, xi, out) -> None:
    """One launch of a kernel-2 library built by ``build_variants``, as the
    port's wrapper makes it."""
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    m, n = a.shape
    rc = fn(p(a), p(xv), p(xi), p(out), m, n, xv.shape[1], out.shape[1],
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc:
        raise RuntimeError(f"kernel 2 variant: CUDA error {rc}")


def shapes_of(arg: str) -> list:
    return [tuple(int(v) for v in s.split("x")) for s in arg.split(",") if s]


def fwd_probe(a, xv, xi, xd, repeats) -> dict:
    """Kernel 2 on the forward table: a line a case with the output's
    SHA-256, ``repeats`` timings of the whole table and one of each other
    case (the column prefixes, the 473 x 4,100 table), and ``a @ xd``.
    Returns the cases, for the sweep."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import drspmm as K1
    m, _ = a.shape
    dim = xd.shape[1]
    cases = {"whole": (a, xv, xi),
             **{f"columns {c}": (a[:, :c].contiguous(), xv[:c].contiguous(),
                                 xi[:c].contiguous()) for c in PREFIXES},
             f"{m}x4100 density 0.01": wide_fwd(4100, 0.01, a, xv.shape[1],
                                                dim)}
    for name, (ac, vc, ic) in cases.items():
        y = K1.drspmm_dense_tier_fwd(ac, vc, ic, dim)
        ref = K1.drspmm_dense_tier_fwd_plain(ac, vc, ic, dim)
        torch.cuda.synchronize()
        nnz = (ac != 0).sum(1)
        case = {"kernel": "drspmm_dense_tier_fwd", "case": name,
                "table": "x".join(map(str, ac.shape)),
                "nnz": int(nnz.sum()), "k": vc.shape[1], "dim": dim}
        print(json.dumps({
            **case, "row_nnz_max": int(nnz.max()),
            "empty_rows": int((nnz == 0).sum()), "sha256": sha(y),
            "max_abs_err": float((y - ref).abs().max()),
            "max_abs_ref": float(ref.abs().max()),
            **({"ptxas": ptxas(_build.build_dir()
                               / "drspmm_dense_tier_fwd.log")}
               if name == "whole" else {})}), flush=True)
        for r in range(repeats if name == "whole" else 1):
            print(json.dumps({**case, "repeat": r, **all_times(
                lambda: K1.drspmm_dense_tier_fwd(ac, vc, ic, dim))}),
                flush=True)
    print(json.dumps({"kernel": "a @ xd", "table": f"{m}x{xd.shape[0]}",
                      "dim": dim, **all_times(lambda: a @ xd)}), flush=True)
    return cases


def sweep(entry, shapes, cases, launch_fn, wrapper, plain) -> None:
    """``csrc/<entry>.cu`` built at each of ``shapes`` (its constants
    ``SWEEP_NAMES``): each build's registers and spills, then its output
    on each of ``cases`` (the wrapper's arguments) checked bit for bit
    against ``wrapper``'s, its error against ``plain``, and its times."""
    from repro_torch.kernels import _build
    for shape, fn in build_variants(
            shapes, header=f"{entry}.cu", names=SWEEP_NAMES, entry=entry,
            n_ptr=4, n_int=4).items():
        d = _build.BUILD_ROOT / "probe" / (
            f"{entry}-" + "x".join(map(str, shape)))
        print(json.dumps({"kernel": entry, **dict(zip(SWEEP_NAMES, shape)),
                          "ptxas": ptxas(d / "nvcc.log")}), flush=True)
        for name, args in cases.items():
            want = wrapper(*args)
            out = torch.empty_like(want)
            launch_fn(fn, *args, out)
            torch.cuda.synchronize()
            print(json.dumps({
                "kernel": entry, **dict(zip(SWEEP_NAMES, shape)),
                "case": name, "same_as_wrapper": bool(torch.equal(out, want)),
                "max_abs_err": float((out - plain(*args)).abs().max()),
                **times(lambda: launch_fn(fn, *args, out))}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=3,
                    help="timings of kernels 5 and 2 on the whole table")
    ap.add_argument("--sweep", default="",
                    help="comma-separated WARPSxUNROLLxBATCHxMIN shapes of "
                         "kernel 5 to build and time, e.g. 4x16x8x8")
    ap.add_argument("--sweep-fwd", default="",
                    help="the same for kernel 2")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("dense_tier_probe: no CUDA device visible")
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root / "src"), str(root)]
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build
    from repro_torch.kernels import drspmm as K1
    (at, gy, xi), (a, xv, xi_f, xd) = operands()
    n, m = at.shape
    row_nnz = (at != 0).sum(1)
    base = {"table": f"{n}x{m}", "nnz": int(row_nnz.sum()),
            "k": xi.shape[1], "dim": gy.shape[1]}
    y = K1.drspmm_dense_tier_bwd(at, gy, xi)
    ref = K1.drspmm_dense_tier_bwd_plain(at, gy, xi)
    torch.cuda.synchronize()
    print(json.dumps({"kernel": "drspmm_dense_tier_bwd", **base,
                      "row_nnz_max": int(row_nnz.max()),
                      "empty_rows": int((row_nnz == 0).sum()),
                      "sha256": sha(y),
                      "max_abs_err": float((y - ref).abs().max()),
                      "max_abs_ref": float(ref.abs().max()),
                      "ptxas": ptxas(_build.build_dir()
                                     / "drspmm_dense_tier_bwd.log")}),
          flush=True)
    for r in range(args.repeats):
        print(json.dumps({"kernel": "drspmm_dense_tier_bwd", **base,
                          "repeat": r, **all_times(
                              lambda: K1.drspmm_dense_tier_bwd(at, gy, xi))}),
              flush=True)
    cut = {c: (at[:, :c].contiguous(), gy[:c].contiguous())
           for c in PREFIXES}
    for c, (ac, gc) in cut.items():
        print(json.dumps({"kernel": "drspmm_dense_tier_bwd", **base,
                          "columns": c, "nnz": int((ac != 0).sum()),
                          **all_times(lambda: K1.drspmm_dense_tier_bwd(
                              ac, gc, xi))}), flush=True)
    print(json.dumps({"kernel": "torch.mm", **base,
                      **all_times(lambda: torch.mm(at, gy))}), flush=True)
    fwd_cases = fwd_probe(a, xv, xi_f, xd, args.repeats)

    cases = {"whole": (at, gy, xi),
             **{f"columns {c}": (ac, gc, xi) for c, (ac, gc) in cut.items()},
             f"{n}x4100 density 0.01": wide_table(4100, 0.01, xi,
                                                  gy.shape[1])}
    sweep("drspmm_dense_tier_bwd", shapes_of(args.sweep), cases, launch,
          K1.drspmm_dense_tier_bwd, K1.drspmm_dense_tier_bwd_plain)
    dim = xd.shape[1]
    sweep("drspmm_dense_tier_fwd", shapes_of(args.sweep_fwd), fwd_cases,
          launch_fwd, lambda *t: K1.drspmm_dense_tier_fwd(*t, dim),
          lambda *t: K1.drspmm_dense_tier_fwd_plain(*t, dim))
    print(card())


if __name__ == "__main__":
    main()
