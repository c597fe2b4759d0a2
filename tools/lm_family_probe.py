"""``chip_smoke.py``'s MoE and SSM LM paths alone, on one NVIDIA card.

    PYTHONPATH=src python3 tools/lm_family_probe.py [path ...]

Builds the kernels, then runs the named paths (all six by default) with
the smoke's own functions, checks and log lines: ``moe``
(serve-lm-granite-moe-1b-a400m), ``moe8``
(serve-lm-moonshot-v1-16b-a3b-depth8), ``ssm`` (serve-lm-mamba2-1.3b),
``fp32`` (lm-families-fp32-depth2), ``train-moe``
(train-lm-granite-moe-1b-a400m) and ``train-ssm`` (train-lm-mamba2-1.3b).
Launch counts cover kernels 13 and 13b only.  Exits 1 when a check
failed."""

import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


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
    paths = {
        "moe": lambda: cs.serve_lm_moe_path(f"serve-lm-{moe_a}", moe_a,
                                            None, wrappers),
        "moe8": lambda: cs.serve_lm_moe_path(f"serve-lm-{moe_b}-depth8",
                                             moe_b, 8, wrappers),
        "ssm": lambda: cs.serve_lm_ssm_path(wrappers),
        "fp32": lambda: cs.lm_families_fp32_path(wrappers),
        "train-moe": lambda: cs.train_lm_family_path(moe_a, wrappers),
        "train-ssm": lambda: cs.train_lm_family_path("mamba2-1.3b",
                                                     wrappers)}
    for name in argv or list(paths):
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
