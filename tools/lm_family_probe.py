"""``chip_smoke.py``'s LM family paths alone, on one NVIDIA card.

    PYTHONPATH=src python3 tools/lm_family_probe.py [path ...]

Builds the kernels, then runs the named paths (all by default) with the
smoke's own functions, checks and log lines: ``moe``
(serve-lm-granite-moe-1b-a400m), ``moe8``
(serve-lm-moonshot-v1-16b-a3b-depth8), ``ssm`` (serve-lm-mamba2-1.3b),
``fp32`` (lm-families-fp32-depth2), ``train-moe``
(train-lm-granite-moe-1b-a400m), ``train-ssm`` (train-lm-mamba2-1.3b),
``flash-cross`` (kernels 13 / 13b at the non-causal ``CROSS_SHAPES``,
timed beside SDPA), ``flash-bwd`` (kernel 13b's check, on random q/k/v
at the qwen3-0.6b prefill's shape), ``hyb`` (serve-lm-zamba2-1.2b), ``aud``
(serve-lm-whisper-large-v3), ``vlm``
(serve-lm-llama-3.2-vision-90b-depth5), ``fp32-cross``
(lm-hybrid-cross-fp32), ``train-hyb`` (train-lm-zamba2-1.2b) and
``train-aud`` (train-lm-whisper-large-v3).  Launch counts cover kernels
13 and 13b only.  ``loss-aud`` is no smoke path: it takes the 4 steps
of train-lm-whisper-large-v3 again under other settings, to find what
moves its losses (``whisper_loss_arms``).  Exits 1 when a check failed."""

import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def whisper_loss_arms(steps=4):
    """train-lm-whisper-large-v3's steps (``launch.train``'s weights from
    seed 0, its token batches, the smoke's seeded frames, lr 3e-4 over
    ``steps`` steps, one step of warmup) from the same start in seven
    arms: as the smoke runs them; with kernels 13 / 13b replaced by their
    plain versions; in fp32 (TF32 off); with 4 steps of warmup (the
    cosine schedule over 400 steps); at lr 1e-4 and 3e-5; with zero
    frames (``launch.train``'s own).  Then whisper at full width with 2 +
    2 layers in fp32, ``steps`` steps on the card and on the CPU from the
    same weights (drawn on the CPU; B 2 x S 128).  Logs each arm's
    losses, gradient norms and learning rates."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, TokenPipeline
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models.lm.model import build_lm
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.train import lm_step
    cfg = get_config("whisper-large-v3")

    def run(c, device, batch, seq, total=steps, lr=3e-4, frames=True,
            plain=False, weights=None):
        lm = build_lm(c, device=device)
        if weights is None:
            lm.init(torch.Generator(device).manual_seed(0))
        else:
            lm.load_state_dict(weights)
        state = lm_step.TrainState(lm.params(), adamw_init(lm.params()))
        step = lm_step.make_train_step(lm, lr=lr, total_steps=total)
        pipe = TokenPipeline(DataConfig(vocab=c.vocab, seq_len=seq,
                                        global_batch=batch, seed=0))
        on_card = FA._on_card
        if plain:
            FA._on_card = lambda *a: False
        out = []
        try:
            for i in range(steps):
                b = {k: torch.from_numpy(v.astype("int64")).to(device)
                     for k, v in pipe.global_batch(i).items()
                     if not k.startswith("_")}
                ex = cs.lm_extras(c, batch, "cuda", cs.SEED + 30 + i)
                b.update({k: (v if frames else torch.zeros_like(v))
                          .to(device, lm.dtype) for k, v in ex.items()})
                state, m = step(state, b)
                out.append([float(m["loss"]), float(m["grad_norm"]),
                            float(m["lr"])])
        finally:
            FA._on_card = on_card
        del lm, state
        if device == "cuda":
            torch.cuda.empty_cache()
        return out
    arms = {"bf16 kernels (the smoke's)": dict(),
            "bf16 plain attention": dict(plain=True),
            "fp32 kernels": dict(dtype="float32"),
            "bf16 kernels, 4 warmup steps": dict(total=400),
            "bf16 kernels, lr 1e-4": dict(lr=1e-4),
            "bf16 kernels, lr 3e-5": dict(lr=3e-5),
            "bf16 kernels, zero frames": dict(frames=False)}
    for label, arm in arms.items():
        c = dataclasses.replace(cfg, dtype=arm.pop("dtype", cfg.dtype))
        t = time.perf_counter()
        r = run(c, "cuda", cs.LM_BATCH, cs.WHISPER_CTX, **arm)
        cs.log(f"loss-aud {label}: [loss, grad norm, lr] a step {r} "
               f"({time.perf_counter() - t:.1f} s) [{cs.CARD}]")
    small = dataclasses.replace(cfg, dtype="float32", n_layers=2,
                                enc_layers=2)
    cpu = build_lm(small, device="cpu")
    cpu.init(torch.Generator().manual_seed(0))
    weights = cpu.state_dict()
    got = {dev: run(small, dev, 2, 128, weights=weights)
           for dev in ("cuda", "cpu")}
    rel = [abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(got["cuda"],
                                                        got["cpu"])]
    cs.log(f"loss-aud fp32 2 + 2 layers, B 2 x S 128, the same weights: "
           f"card {got['cuda']}; CPU {got['cpu']}; losses' relative "
           f"difference a step {rel}")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device visible", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import _build, flash_attention as FA
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(f"card: {cs.CARD}; torch {torch.__version__}", flush=True)
    t = time.perf_counter()
    _build.build_all()
    print(f"phase build: {time.perf_counter() - t:.1f} s", flush=True)
    wrappers = {"flash_attention": FA.flash_attention,
                "flash_attention_bwd": FA.flash_attention_bwd}
    moe_a, moe_b = "granite-moe-1b-a400m", "moonshot-v1-16b-a3b"
    hyb, aud, vlm = ("zamba2-1.2b", "whisper-large-v3",
                     "llama-3.2-vision-90b")
    paths = {
        "moe": lambda: cs.serve_lm_moe_path(f"serve-lm-{moe_a}", moe_a,
                                            None, wrappers),
        "moe8": lambda: cs.serve_lm_moe_path(f"serve-lm-{moe_b}-depth8",
                                             moe_b, 8, wrappers),
        "ssm": lambda: cs.serve_lm_ssm_path(wrappers),
        "fp32": lambda: cs.lm_fp32_path("lm-families-fp32-depth2",
                                        cs.FP32_FAMILIES, wrappers),
        "train-moe": lambda: cs.train_lm_family_path(moe_a, wrappers),
        "train-ssm": lambda: cs.train_lm_family_path("mamba2-1.3b",
                                                     wrappers),
        "flash-cross": cs.flash_cross_times,
        "flash-bwd": lambda: cs.check_flash_bwd_kernel(
            *(torch.randn(shape, device="cuda").to(torch.bfloat16)
              for shape in ((4, 1024, 16, 64), (4, 1024, 8, 64),
                            (4, 1024, 8, 64))), wrappers),
        "hyb": lambda: cs.serve_lm_family_path(f"serve-lm-{hyb}", hyb,
                                               wrappers),
        "aud": lambda: cs.serve_lm_family_path(f"serve-lm-{aud}", aud,
                                               wrappers),
        "vlm": lambda: cs.serve_lm_family_path(
            f"serve-lm-{vlm}-depth{cs.VLM_DEPTH}", vlm, wrappers,
            cs.VLM_DEPTH),
        "fp32-cross": lambda: cs.lm_fp32_path("lm-hybrid-cross-fp32",
                                              cs.FP32_CROSS, wrappers),
        "train-hyb": lambda: cs.train_lm_family_path(hyb, wrappers),
        "train-aud": lambda: cs.train_lm_family_path(
            aud, wrappers, cs.WHISPER_CTX, cs.SEED + 30),
        "loss-aud": whisper_loss_arms}
    for name in argv or [p for p in paths if p != "loss-aud"]:
        t = time.perf_counter()
        paths[name]()
        print(f"phase {name}: {time.perf_counter() - t:.1f} s", flush=True)
    if cs.PROBLEMS:
        print(f"{len(cs.PROBLEMS)} check(s) failed: {cs.PROBLEMS}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
