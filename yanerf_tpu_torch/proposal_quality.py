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
   (``--lr_decay_iters`` overrides its horizon), and reads each run's final
   test PSNR. ``--arm`` picks the NeRF-MLP's training path: ``k1k3`` (the
   default on the card: K1 forward, K3 backward), ``k1`` (K1 forward, the
   eager model's backward), ``k3`` (the eager forward, K3 backward) or
   ``eager`` (no kernel). The kernel arms render
   their frames on K1, and their final checkpoint is tested once more on
   the eager model (``test_eager_eval``), so a gap between arms can be told
   from the frame path.
Writes ``<root>/proposal_quality.json`` with both stages, the card's name
and the seconds of each.

The split arms are not config keys: ``python -m
yanerf_tpu_torch.proposal_quality run_arm <arm> <run.py arguments>`` runs
``yanerf_tpu_torch.run`` with every NeRFMLP's ``kernel_arm`` set to
``<arm>`` (``ops/kernels/fused_mlp.py``), which is how step 3 starts the
``k1`` / ``k3`` runs.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

from .repro_parity import (
    REPO,
    TIME_TO_QUALITY_CONFIG,
    _dataset_options,
    _kernel_options,
    read_jsonl_last,
    run_test_only,
)

SCHEDULE = ["runner.num_iters=20000", "runner.val_per_iter=5000"]
ARMS = ("k1k3", "k1", "k3", "eager")


def run_arm(argv) -> int:
    """``run_arm <arm> <run.py arguments>``: ``yanerf_tpu_torch.run`` with ``NeRFMLP.kernel_arm = <arm>``."""
    from . import run
    from .models.nerf_mlp import NeRFMLP
    from .ops.kernels.fused_mlp import ARMS as KERNEL_ARMS

    if argv[0] not in KERNEL_ARMS:
        raise SystemExit(f"run_arm takes one of {KERNEL_ARMS}, got {argv[0]!r}")
    NeRFMLP.kernel_arm = argv[0]
    run.main(argv[1:])
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "run_arm":
        return run_arm(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True, help="where data/ and the runs' results go")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--seeds", type=int, nargs="+", default=[42], help="one 20k run per seed (the config's is 42)")
    ap.add_argument("--lr_decay_iters", type=int, default=None, help="the decay horizon (default: the config's)")
    ap.add_argument("--skip_runbook", action="store_true")
    ap.add_argument("--arm", default="k1k3", choices=ARMS, help="the NeRF-MLP's training path on the card")
    args = ap.parse_args(argv)
    arm = "eager" if args.device != "cuda" else args.arm
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
    kernels = [] if arm == "eager" else _kernel_options(TIME_TO_QUALITY_CONFIG, args.device)
    entry = (["yanerf_tpu_torch.run"] if arm in ("k1k3", "eager")
             else ["yanerf_tpu_torch.proposal_quality", "run_arm", arm])
    record["arm"] = arm
    record["schedule_20k"] = []
    for seed in args.seeds:
        t = time.perf_counter()
        out_dir = root / "results" / f"schedule_20k_{arm}_seed{seed}"
        subprocess.run([sys.executable, "-m", *entry, "--config", TIME_TO_QUALITY_CONFIG, "--device",
                        args.device, "--seed", str(seed), "--output_dir", str(out_dir), "--cfg_options",
                        *_dataset_options(scene), *kernels, *schedule],
                       cwd=REPO, check=True)
        version = max(out_dir.glob("version_*"), key=lambda p: int(p.name.split("_")[1]))
        eager_eval = None
        if kernels:
            final = max((c for c in (version / "ckpts").glob("ckpts_*") if c.name[6:].isdigit()),
                        key=lambda c: int(c.name[6:]))
            eager_eval = run_test_only(TIME_TO_QUALITY_CONFIG, str(final), version / "test_eager_eval", args.device,
                                       _dataset_options(scene))
        val = [json.loads(line) for line in (version / "val_stats.json").read_text().splitlines() if line.strip()]
        train = [json.loads(line) for line in (version / "train_stats.json").read_text().splitlines() if line.strip()]
        record["schedule_20k"].append({
            "seed": seed, "arm": arm, "options": kernels + schedule,
            "test": read_jsonl_last(version / "test_stats.json"), "test_eager_eval": eager_eval,
            "val_curve": [[v["epoch"], v.get("val_loss_rgb_psnr")] for v in val],
            "train_step_s": [r.get("train_step_s") for r in train][-3:], "seconds": time.perf_counter() - t,
        })
    (root / "proposal_quality.json").write_text(json.dumps(record, indent=2) + "\n")
    print(json.dumps(record, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
