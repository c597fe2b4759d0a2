"""End-to-end LM training entry point, one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --steps 50 --batch 4 --seq 1024 --ckpt-dir build/ckpt

Port of ``repro/launch/train.py``: the same flags, plus ``--device``
(``cuda``, the default, or ``cpu``; ``--reduced`` runs the tiny
same-family config, which the CPU takes).  The VLM and audio
families get zero ``image_emb`` / ``frames`` (the reference's
``_maybe_add_extras``).  Wired in: the cosine / WSD
schedule, gradient accumulation (``--grad-accum`` splits each batch into
that many microbatches), async atomic checkpoints with restart from the
latest one, straggler monitoring (the port's ``StepMonitor``) and the
deterministic, shard-indexed token pipeline with a prefetching loader.
On the card the attention of every layer is kernel 13 and its gradient
kernel 13b.  A mesh (``--model-parallel`` above 1) is multi-device and
raises.  ``main(argv)`` returns the losses of the steps it ran.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint)
from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.data.pipeline import DataConfig, PrefetchingLoader, \
    TokenPipeline
from repro_torch.fault.monitor import StepMonitor
from repro_torch.models.lm.model import build_lm, extra_input
from repro_torch.train import lm_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1: a mesh is multi-device LM training "
            "(ROADMAP.md §1 item 6)")
    if args.batch % args.grad_accum:
        raise ValueError(f"--batch {args.batch} does not split into "
                         f"{args.grad_accum} microbatches")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    device = resolve_device(args.device)
    lm = build_lm(cfg, device=device)
    # counted from the leaves: ``param_count()`` is the reference's
    # estimate (whisper: a SwiGLU FFN the audio family does not have)
    print(f"[train] {cfg.name} ({cfg.family}) "
          f"params={sum(p.numel() for p in lm.parameters()):,} "
          f"device={device}")

    pipeline = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                        global_batch=args.batch,
                                        seed=args.seed))
    state = lm_step.init_train_state(
        lm, torch.Generator(device).manual_seed(args.seed))
    step_fn = lm_step.make_train_step(lm, lr=args.lr, total_steps=args.steps,
                                      grad_accum=args.grad_accum)

    start = 0
    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointManager(args.ckpt_dir, every=args.ckpt_every)
        last = latest_step(args.ckpt_dir)
        if last is not None:
            print(f"[train] restoring step {last}")
            state = restore_checkpoint(args.ckpt_dir, last, state)
            start = last + 1

    monitor = StepMonitor(n_hosts=1)
    loader = PrefetchingLoader(pipeline, start_step=start)
    losses = []
    try:
        for step in range(start, args.steps):
            batch = {k: _to_device(v, device, args.grad_accum)
                     for k, v in loader.next().items()
                     if not k.startswith("_")}
            _maybe_add_extras(cfg, batch, lm)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            ev = monitor.record(step, 0, dt)
            if ev:
                print(f"[fault] step {step}: {ev.action} "
                      f"({ev.duration:.2f}s > {ev.threshold:.2f}s)")
            losses.append(loss)
            if step % args.log_every == 0:
                print(f"step {step:5d} loss {loss:8.4f} "
                      f"gnorm {float(metrics['grad_norm']):8.3f} "
                      f"{dt*1e3:7.1f} ms")
            if ckpt:
                ckpt.maybe_save(step, state)
    finally:
        loader.close()
        if ckpt:
            ckpt.finalize()
    first = np.mean(losses[: max(len(losses) // 5, 1)])
    last5 = np.mean(losses[-max(len(losses) // 5, 1):])
    print(f"[train] loss {first:.4f} -> {last5:.4f} "
          f"({'improved' if last5 < first else 'NOT improved'})")
    return losses


def _maybe_add_extras(cfg, batch, lm):
    """The VLM's ``image_emb`` and the audio family's ``frames``: zeros in
    the model's dtype (the reference's contract; the front ends are
    stubs), one (n_img_tokens | enc_frames, d) memory a sequence."""
    spec = extra_input(cfg)
    if spec is not None:
        name, n = spec
        batch[name] = torch.zeros((*batch["tokens"].shape[:-1], n,
                                   cfg.d_model), dtype=lm.dtype,
                                  device=batch["tokens"].device)


def _to_device(a: np.ndarray, device, grad_accum: int) -> torch.Tensor:
    """A batch array as int64 on ``device``, split into ``grad_accum``
    microbatches along a new leading dimension when above 1."""
    t = torch.from_numpy(a.astype(np.int64)).to(device)
    if grad_accum > 1:
        t = t.reshape(grad_accum, t.shape[0] // grad_accum, *t.shape[1:])
    return t


if __name__ == "__main__":
    main()
