"""The port's quality on the procedural 800x800 scene: the parity runbook's time-to-quality stage, then the
flagship's 20k-iteration schedule to its test PSNR.

    python -m yanerf_tpu_torch.proposal_quality --root /tmp/quality [--device cuda]

1. Writes the procedural scene (``yanerf_tpu_torch.synth_scene``, 100 / 8 /
   8 frames at 800x800, seed 0: the scene of the JAX package's
   ``results/proposal_quality.json``) at ``<root>/data/nerf_synthetic/lego``
   when it is not there.
2. Runs ``python -m yanerf_tpu_torch.repro_parity --root <root>``: the lego
   ``--test_only`` stage has no released checkpoint there and records so;
   the time-to-quality stage trains ``lego_proposal.yml`` (fused, K1 / K3 on
   the card) to val PSNR 30.7.
3. Trains ``lego_proposal.yml`` for 20,000 iterations, once per
   ``--seeds`` entry, with the config's own learning-rate schedule
   (``--lr_decay_iters`` overrides its horizon), K1 / K3 on the card
   (``--eager``: the eager model, no kernel), and reads each run's final
   test PSNR.
Writes ``<root>/proposal_quality.json`` with both stages, the card's name
and the seconds of each.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

from .repro_parity import REPO, TIME_TO_QUALITY_CONFIG, _dataset_options, _kernel_options, read_jsonl_last

SCHEDULE = ["runner.num_iters=20000", "runner.val_per_iter=5000"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True, help="where data/ and the runs' results go")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seeds", type=int, nargs="+", default=[42], help="one 20k run per seed (the config's is 42)")
    ap.add_argument("--lr_decay_iters", type=int, default=None, help="the decay horizon (default: the config's)")
    ap.add_argument("--skip_runbook", action="store_true")
    ap.add_argument("--eager", action="store_true", help="train the 20k runs on the eager model, no kernel")
    args = ap.parse_args(argv)
    import torch

    root = Path(args.root).resolve()
    scene = root / "data" / "nerf_synthetic" / "lego"
    record = {"scene": "yanerf_tpu_torch.synth_scene, 100 / 8 / 8 frames at 800x800, seed 0",
              "device": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"}
    if not (scene / "transforms_test.json").exists():
        t = time.perf_counter()
        subprocess.run([sys.executable, "-m", "yanerf_tpu_torch.synth_scene", "--out_dir", str(scene), "--hw",
                        "800", "--n_train", "100", "--n_val", "8", "--n_test", "8"], cwd=REPO, check=True)
        record["scene_s"] = time.perf_counter() - t

    if not args.skip_runbook:
        t = time.perf_counter()
        parity_out = root / "parity_real.json"
        subprocess.run([sys.executable, "-m", "yanerf_tpu_torch.repro_parity", "--device", args.device, "--root",
                        str(root), "--out", str(parity_out)], cwd=REPO, check=True)
        record["repro_parity"] = json.loads(parity_out.read_text())
        record["repro_parity_s"] = time.perf_counter() - t

    schedule = SCHEDULE + ([f"runner.lr_decay_iters={args.lr_decay_iters}"] if args.lr_decay_iters else [])
    kernels = [] if args.eager else _kernel_options(TIME_TO_QUALITY_CONFIG, args.device)
    record["schedule_20k"] = []
    for seed in args.seeds:
        t = time.perf_counter()
        out_dir = root / "results" / f"schedule_20k_seed{seed}"
        subprocess.run([sys.executable, "-m", "yanerf_tpu_torch.run", "--config", TIME_TO_QUALITY_CONFIG, "--device",
                        args.device, "--seed", str(seed), "--output_dir", str(out_dir), "--cfg_options",
                        *_dataset_options(scene), *kernels, *schedule],
                       cwd=REPO, check=True)
        version = max(out_dir.glob("version_*"), key=lambda p: int(p.name.split("_")[1]))
        val = [json.loads(line) for line in (version / "val_stats.json").read_text().splitlines() if line.strip()]
        train = [json.loads(line) for line in (version / "train_stats.json").read_text().splitlines() if line.strip()]
        record["schedule_20k"].append({
            "seed": seed, "options": kernels + schedule, "test": read_jsonl_last(version / "test_stats.json"),
            "val_curve": [[v["epoch"], v.get("val_loss_rgb_psnr")] for v in val],
            "train_step_s": [r.get("train_step_s") for r in train][-3:], "seconds": time.perf_counter() - t,
        })
    (root / "proposal_quality.json").write_text(json.dumps(record, indent=2) + "\n")
    print(json.dumps(record, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
