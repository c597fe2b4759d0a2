"""Where the D-ReLU bisection (kernel 3, ``csrc/drelu_bisect.cu``) spends
its time, on one NVIDIA card.

    PYTHONPATH=src python3 tools/drelu_probe.py [--repeats 3] \
        [--sweep steps32,steps16,lane0]

Takes the cell embedding that ``chip_smoke.py`` hands kernel 3 (``h_cell``
of the first served Table-1 batch, the first two partitions of
``generate_design(0, "small", 1.0)`` + ``(1, "medium", 1.0)``, under
``chip_smoke.py``'s seeded model: 15,450 x 64, k 16) and times, with CUDA
events (``ms``: ``cuda_ms`` of ``tools/arena_fwd_probe.py``, mean of 50
L2-warm calls after a warm-up, which reads the host's launch rate where
that is slower than the kernel) and with ``torch.profiler``
(``device_ms``: the device time it traces over 50 more calls, a call):

* kernel 3 on ``h_cell``, ``--repeats`` times, each with the SHA-256 of
  its output and whether it equals the plain version bit for bit;
* the ``topk`` backend's D-ReLU (``core/drelu.py::drelu``, the
  ``torch.topk`` threshold) on the same input: the library yardstick;
* kernel 3 on seeded Gaussian rows at d 32, 64, 96, 128 and 256 (15,450
  rows, k = d / 4), each checked bit for bit against the plain version.

With ``--sweep NAME,...`` it also builds the tree's
``csrc/drelu_bisect.cu`` with one constant changed, one ``nvcc`` each,
all started together, into ``build/repro_torch/probe/drelu_bisect-<NAME>/``:

* ``stepsN``: ``kIters`` set to N (fewer bisection steps: a wrong
  threshold, a time that says what the steps cost);
* ``laneN``: ``kLaneMaxD`` set to N, so that only rows of up to N values
  (0, 32 or 64) take one lane a row and wider ones one warp a row
  (``lane0``: the one-warp-a-row design at every width);

prints each build's registers and spills and times each on ``h_cell`` and
on the synthetic rows, with whether its output equals the wrapper's and
the plain version's bit for bit.

Prints one JSON object a line, then the card's name and power limit.
Needs one card; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

from arena_fwd_probe import SEED, card, ptxas, sha, times

WIDTHS = (32, 64, 96, 128, 256)
KERNEL = "drelu_(bisect|lane|warp)_kernel"
CONSTANTS = {"steps": "kIters", "lane": "kLaneMaxD"}


def h_cell():
    """The dense cell embedding ``chip_smoke.py`` hands kernel 3, on the
    card."""
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
    return first_layer_operands(model, big.graph, cfg)[2], K


def build(names):
    """{name: the C entry ``drelu_bisect`` of each probe build}."""
    from repro_torch.kernels import _build
    procs = {}
    for name in names:
        what, value = re.fullmatch(r"(steps|lane)(\d+)", name).groups()
        text, n = re.subn(rf"constexpr int {CONSTANTS[what]} = \d+;",
                          f"constexpr int {CONSTANTS[what]} = {value};",
                          (_build.CSRC / "drelu_bisect.cu").read_text())
        assert n == 1, name
        d = _build.BUILD_ROOT / "probe" / f"drelu_bisect-{name}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "drelu_bisect.cu").write_text(text)
        log = open(d / "nvcc.log", "w")
        procs[name] = (d, log, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "drelu_bisect.cu")],
            stdout=log, stderr=subprocess.STDOUT))
    fns = {}
    for name, (d, log, proc) in procs.items():
        rc = proc.wait()
        log.close()
        if rc != 0:
            sys.exit(f"drelu_probe: build {name} failed, see "
                     f"{d / 'nvcc.log'}")
        fn = ctypes.CDLL(str(d / "lib.so")).drelu_bisect
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 \
            + [ctypes.c_void_p]
        fns[name] = fn
    return fns


def launch(fn, x, k, out) -> None:
    """One launch of a probe build, as the port's wrapper makes it."""
    rc = fn(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            x.shape[0], x.shape[1], k,
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    if rc:
        raise RuntimeError(f"drelu probe build: CUDA error {rc}")


def same(a, b) -> bool:
    """Bit for bit, the sign of a zero included."""
    return bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repeats", type=int, default=3,
                    help="timings of kernel 3 on h_cell")
    ap.add_argument("--sweep", default="",
                    help="comma-separated builds to time: stepsN (the "
                         "tree's kernel at N steps), laneN (one lane a row "
                         "only up to N values)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("drelu_probe: no CUDA device visible")
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root / "src"), str(root)]
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.core.drelu import drelu
    from repro_torch.kernels import _build
    from repro_torch.kernels.drelu_topk import (drelu_bisect,
                                                drelu_bisect_plain)
    x, k = h_cell()
    _build.build_all()
    print(json.dumps({
        "kernel": "drelu_bisect", "input": "h_cell",
        "rows": x.shape[0], "d": x.shape[1], "k": k,
        "ptxas": ptxas(_build.build_dir() / "drelu_bisect.log", KERNEL)}),
        flush=True)
    ref = drelu_bisect_plain(x, k)
    for rep in range(args.repeats):
        y = drelu_bisect(x, k)
        torch.cuda.synchronize()
        print(json.dumps({
            "kernel": "drelu_bisect", "input": "h_cell", "repeat": rep,
            "sha256": sha(y), "same_as_plain": same(y, ref),
            **times(lambda: drelu_bisect(x, k))}), flush=True)
    with torch.inference_mode():
        print(json.dumps({"kernel": "drelu (topk)", "input": "h_cell",
                          **times(lambda: drelu(x, k))}), flush=True)
    g = torch.Generator().manual_seed(SEED)
    inputs = {"h_cell": (x, k)}
    for d in WIDTHS:
        xs = torch.randn((x.shape[0], d), generator=g).cuda()
        inputs[f"randn{d}"] = (xs, d // 4)
        y = drelu_bisect(xs, d // 4)
        print(json.dumps({
            "kernel": "drelu_bisect", "input": f"randn{d}", "k": d // 4,
            "same_as_plain": same(y, drelu_bisect_plain(xs, d // 4)),
            **times(lambda: drelu_bisect(xs, d // 4))}), flush=True)
    names = [s for s in args.sweep.split(",") if s]
    for name, fn in build(names).items():
        d = _build.BUILD_ROOT / "probe" / f"drelu_bisect-{name}"
        print(json.dumps({"kernel": "drelu_bisect", "build": name,
                          "ptxas": ptxas(d / "nvcc.log", KERNEL)}),
              flush=True)
        for case, (xs, kk) in inputs.items():
            out = torch.empty_like(xs)
            launch(fn, xs, kk, out)
            torch.cuda.synchronize()
            print(json.dumps({
                "kernel": "drelu_bisect", "build": name, "input": case,
                "same_as_wrapper": same(out, drelu_bisect(xs, kk)),
                "same_as_plain": same(out, drelu_bisect_plain(xs, kk)),
                **times(lambda: launch(fn, xs, kk, out))}), flush=True)
    print(card())


if __name__ == "__main__":
    main()
