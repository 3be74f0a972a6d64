#!/usr/bin/env python3
"""Time LM T's training step on the card: qwen2.5-3B at full width (36
layers), bf16 compute over f32 masters, AdamW, remat "full", B=1, S=4,096,
as ``chip_smoke.py``'s LM T times it (a warm-up step, then CUDA events
around each step), for the port of this checkout or of another tree.

    python3 tools/lm_t_step.py [--root DIR] [--steps N]

``--root`` names the root of another checkout (e.g. a parent commit
unpacked with ``git archive`` into a directory that ``.gitignore`` lists):
its ``src/repro_torch`` is imported and its kernels are built there. To
compare two trees on one card, run them in turns in one command (parent,
change, change, parent). Needs one CUDA card and ``nvcc``. Prints the
card, each step's ms and a JSON line with the median.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    args = sys.argv[1:]
    root, steps = ROOT, 4
    while args:
        flag, value, *args = args
        if flag == "--root":
            root = Path(value).resolve()
        elif flag == "--steps":
            steps = int(value)
        else:
            sys.exit(f"usage: {Path(__file__).name} [--root DIR] "
                     f"[--steps N]")
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch import configs
    from repro_torch.models import lm, params
    from repro_torch.train import optimizer, trainstep
    if not torch.cuda.is_available():
        sys.exit("lm_t_step: torch sees no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    cfg = configs.get("qwen2_5_3b")
    gen = torch.Generator(device=dev).manual_seed(6)
    p = params.init_params(lm.model_defs(cfg), gen, dev)
    state = optimizer.init(p)
    step = trainstep.make_train_step(cfg, optimizer.AdamWConfig())
    batches = [{k: torch.randint(0, cfg.vocab, (1, 4096), generator=gen,
                                 device=dev, dtype=torch.int32)
                for k in ("tokens", "labels")} for _ in range(steps + 1)]
    p, state, _ = step(p, state, batches[-1])        # warm-up
    torch.cuda.synchronize()
    ms, losses = [], []
    for batch in batches[:steps]:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        p, state, m = step(p, state, batch)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
        losses.append(float(m["loss"]))
    print(f"card: {card} | tree {root}: LM T step ms "
          f"{', '.join(f'{x:.2f}' for x in ms)}; losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}", flush=True)
    print(json.dumps({"lm_t_step": {"tree": str(root), "card": card,
                                    "median_ms": statistics.median(ms),
                                    "ms": ms, "losses": losses}}))


if __name__ == "__main__":
    main()
