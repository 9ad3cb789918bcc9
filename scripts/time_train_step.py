#!/usr/bin/env python3
"""Time the fusion train step of one checkout on one CUDA card, at the
training phase's shapes.

    python3 scripts/time_train_step.py [ROOT]

ROOT (default: this checkout) is the root of a checkout of the repository;
its ``chip_smoke.py`` and ``multimodal_isic_tpu_torch`` are imported, so two
commits are compared by running this script once from each (in turns:
parent, change, change, parent) in one call on the card.  The step is the
one ``chip_smoke.time_training`` times: the fast policy on a batch of
rendered 450² crops, then forward, backward and SGD of the B3@380 fusion
net, at bs 16 float32 and bs 128 with a bf16 backbone.  It prints:

- the card's name and power limit;
- img/s of each step: CUDA events around chains of calls (``CHAINS`` chains
  of ``ITERS`` steps after 2 warm-up steps), the median chain, the best and
  the worst;
- the device's busy share and the kernel time by family
  (``chip_smoke.profile_steps``);
- a JSON line with these numbers, for the records.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

CHAINS = 7
ITERS = {16: 10, 128: 2}


def main() -> int:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    root = Path(args[0] if args else Path(__file__).resolve().parents[1])
    root = root.resolve()
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("time_train_step: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from multimodal_isic_tpu_torch.core.rng import generator
    from multimodal_isic_tpu_torch.data.augment import make_fusion_train_fast
    from multimodal_isic_tpu_torch.train import fusion as T
    from multimodal_isic_tpu_torch.utils.profiling import timeit_closed
    assert Path(T.__file__).resolve().is_relative_to(root), T.__file__
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(f"{root}: {smi.stdout.strip()}")

    reqs = cs.make_requests(cs.LARGE_BATCH, seed=cs.SEED + 1)
    all_images = torch.from_numpy(reqs["image"]).to(device)
    all_meta = {k: torch.from_numpy(v).to(device) for k, v in reqs.items()
                if k != "image"}
    g = generator(cs.SEED + 5, device)
    policy = make_fusion_train_fast((cs.IMG, cs.IMG))
    record = {}
    for bsz, dtype in ((cs.BATCH, torch.float32),
                       (cs.LARGE_BATCH, torch.bfloat16)):
        images = all_images[:bsz]
        batch = {k: v[:bsz] for k, v in all_meta.items()}
        model = T.build_fusion(generator(cs.SEED + 6, device),
                               backbone="efficientnet-b3",
                               radiomics_dim=cs.RADIOMICS_DIM,
                               fusion_strategy="concat", dtype=dtype)
        step = T.make_fusion_train_step(model, T.fusion_optimizer(model))

        def train_step():
            batch["image"] = policy(images, None, g)[0]
            return step(batch, g)

        t = timeit_closed(train_step, iters=ITERS[bsz], repeats=CHAINS,
                          warmup=2)
        rates = sorted(bsz / s for s in t["all"])
        label = f"train step bs{bsz} {str(dtype)[6:]}"
        record[label] = {"median_img_s": bsz / t["median"],
                         "best_img_s": rates[-1], "worst_img_s": rates[0],
                         "chains_img_s": rates}
        print(f"{label}: {bsz / t['median']:.1f} img/s (median of {CHAINS} "
              f"chains of {ITERS[bsz]}; {rates[0]:.1f}–{rates[-1]:.1f})")
        cs.profile_steps(train_step, label)
        del model, step
        torch.cuda.empty_cache()
    print("train step times: " + json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
