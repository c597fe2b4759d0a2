#!/usr/bin/env python
"""Save, and compare bit for bit, the D-ReLU outputs of a PyTorch-port tree
on the card: the served predictions of the Table-1 and scale-0.02
partitions under both D-ReLU backends, and the step losses and final
weights of a 2-epoch fit on each (the paths of ``chip_smoke.py``).

    python tools/port_outputs.py save <src dir of a checkout> <out.npz>
    python tools/port_outputs.py compare <a.npz> <b.npz>

Saving two trees (say, a commit and its parent, unpacked with
``git archive``) in one run on one card and comparing the files shows
whether a change moved any of these numbers.  Needs one card.
"""

from __future__ import annotations

import sys

import numpy as np


def save(src: str, out_path: str) -> None:
    sys.path.insert(0, src)
    import torch
    from repro_torch.core.hetero_mp import HeteroMPConfig
    from repro_torch.graphs.generator import generate_design
    from repro_torch.models.hgnn import DRCircuitGNN
    from repro_torch.serve.circuit_engine import CircuitServeEngine
    from repro_torch.train.circuit_trainer import (CircuitTrainConfig,
                                                   CircuitTrainer)
    torch.backends.cuda.matmul.allow_tf32 = False
    table1 = generate_design(0, "small", 1.0) + generate_design(1, "medium",
                                                                1.0)
    tiny = generate_design(0, "small", 0.02) + generate_design(1, "medium",
                                                               0.02)
    make = lambda: DRCircuitGNN(16, 16, 64, 2, device="cuda",
                                generator=torch.Generator().manual_seed(0))
    out, model = {}, make()
    for be in ("topk", "bisect"):
        cfg = HeteroMPConfig(hidden=64, k_cell=16, k_net=16, drelu_backend=be)
        for name, graphs in (("table1", table1), ("tiny", tiny)):
            eng = CircuitServeEngine(model, cfg, max_batch=2, device="cuda")
            rids = [eng.submit(g) for g in graphs]
            done = eng.run()
            for i, rid in enumerate(rids):
                out[f"serve_{be}_{name}_{i}"] = done[rid].pred
    for be, graphs, remat in (("topk", table1, False), ("bisect", tiny, True)):
        m = make()
        tr = CircuitTrainer(CircuitTrainConfig(
            hidden=64, k_cell=16, k_net=16, epochs=2, batch_size=2,
            drelu_backend=be, remat=remat), 16, 16, model=m, device="cuda")
        tr.fit(graphs)
        out[f"train_{be}_loss"] = np.array(tr.step_loss)
        for n, p in m.named_parameters():
            out[f"train_{be}_{n}"] = p.detach().cpu().numpy()
    np.savez(out_path, **out)
    print(f"saved {len(out)} arrays from {src} to {out_path}")


def compare(a_path: str, b_path: str) -> int:
    a, b = np.load(a_path), np.load(b_path)
    if set(a.files) != set(b.files):
        print(f"different arrays: {sorted(set(a.files) ^ set(b.files))}")
        return 1
    diff = [k for k in sorted(a.files) if not np.array_equal(a[k], b[k])]
    print(f"{len(a.files)} arrays, {len(diff)} differ bit for bit")
    for k in diff:
        print(f"  {k}: max |diff| {float(np.abs(a[k] - b[k]).max())}")
    return 1 if diff else 0


if __name__ == "__main__":
    if len(sys.argv) != 4 or sys.argv[1] not in ("save", "compare"):
        sys.exit(__doc__)
    if sys.argv[1] == "save":
        save(sys.argv[2], sys.argv[3])
    else:
        sys.exit(compare(sys.argv[2], sys.argv[3]))
