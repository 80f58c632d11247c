"""Real-scene parity runbook: one command from mounted data to parity numbers.

Counterpart of ``scripts/repro_parity.py``, driving the port's own CLI
(``python -m yanerf_tpu_torch.run``). The reference's headline numbers are
lego 30.70 / fern 27.94 test PSNR from its released checkpoints; once
``data/nerf_synthetic/lego``, ``data/nerf_llff_data/fern`` and the released
``.pth`` files are in place, this writes the whole parity record:

    python -m yanerf_tpu_torch.repro_parity            # auto-detects data + checkpoints
    python -m yanerf_tpu_torch.repro_parity --smoke --device cpu

Stages (each runs only if its inputs are present, and is recorded either way):
  1. lego: ``run --checkpoint lego.ckpts_-001.pth --test_only`` -> test PSNR
     against 30.70.
  2. fern: the same against 27.94 with ``fern.yml`` (real captures ship
     JPEGs, read by the port's own decoder).
  3. time-to-quality: train ``lego_proposal.yml`` (the fused dispatch; on
     the card with K1 / K3 switched on) on the lego scene and record the
     wall-clock minutes until val PSNR crosses 30.7; the run is stopped
     with SIGTERM, which the runner drains (checkpoint, then exit).
Each dataset stage points the config's ``base_dir`` at the scene it
found. Writes ``results/parity_real.json``.

Unlike the JAX script's process, the training child here holds no
accelerator lease that a kill would leave stale: when it has not drained
``DRAIN_TIMEOUT_S`` (600) seconds after the SIGTERM, it is killed.

``--smoke`` checks the whole flow on procedural stand-ins: a 64-pixel
scene written by ``yanerf_tpu_torch.synth_scene``, a reference-layout
``.pth`` written by the port's ``export_torch_checkpoint`` from a fresh
pipeline of the same tiny config, the ``--test_only`` import of it, and
the val-polling + SIGTERM time-to-quality loop at a reachable target. On
the card the smoke's two NeRF-MLP layers keep the published 256 / 128
widths, the ones K1 and K3 are built for, and run on them.
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import signal
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

REPO = Path(__file__).resolve().parent.parent
RUN = [sys.executable, "-m", "yanerf_tpu_torch.run"]

EXPECTED = {"lego": 30.70, "fern": 27.94}
CKPT_SEARCH = [
    "data/ckpts/{scene}.ckpts_-001.pth",
    "data/ckpts/{scene}*.pth",
    "data/{scene}.ckpts_-001.pth",
    "data/{scene}*.pth",
    "ckpts/{scene}*.pth",
]
DATA_MARKERS = {
    "lego": "data/nerf_synthetic/lego/transforms_test.json",
    "fern": "data/nerf_llff_data/fern/poses_bounds.npy",
}
CONFIGS = {"lego": "configs/nerf/lego.yml", "fern": "configs/nerf/fern.yml"}
TIME_TO_QUALITY_CONFIG = "configs/nerf/lego_proposal.yml"
DRAIN_TIMEOUT_S = 600.0  # seconds a SIGTERM'd training run may take to drain before it is killed
SMOKE_KERNEL_WIDTHS = ["pipeline.model.n_hidden_neurons_xyz=256", "pipeline.model.n_hidden_neurons_dir=128"]


def find_ckpt(scene: str, override: Optional[str], root: Path = REPO) -> Optional[str]:
    """The released checkpoint of ``scene``: ``override`` (which must exist), else the first search hit under
    ``root``, else None."""
    if override:
        if not Path(override).exists():
            raise FileNotFoundError(f"--{scene}_ckpt {override!r} does not exist")
        return override
    for pattern in CKPT_SEARCH:
        hits = sorted(root.glob(pattern.format(scene=scene)))
        if hits:
            return str(hits[0])
    return None


def _version_key(path: Path) -> int:
    """Numeric sort key for ``version_N`` directories (version_10 > version_9)."""
    name = path.parent.name if path.parent.name.startswith("version_") else path.name
    try:
        return int(name.split("_", 1)[1])
    except (IndexError, ValueError):
        return -1


def read_jsonl_last(path: Path) -> dict:
    lines = [ln for ln in path.read_text().splitlines() if ln.strip()] if path.exists() else []
    return json.loads(lines[-1]) if lines else {}


def _dataset_options(scene_dir: Path) -> List[str]:
    return [f"datasets.{i}.base_dir={scene_dir}" for i in range(3)]


def _kernel_options(config: str, device: str) -> List[str]:
    """On the card the NeRF-MLP runs on K1 (frames) and K1 + K3 (training)."""
    if device != "cuda":
        return []
    model = "pipeline.model.2" if "proposal" in config else "pipeline.model"
    return [f"{model}.use_pallas=True", f"{model}.use_pallas_train=True"]


def run_test_only(config: str, ckpt: str, out_dir: Path, device: str, cfg_options: Sequence[str] = ()) -> dict:
    """``run --checkpoint <pth> --test_only`` -> the test stats dict."""
    cmd = [*RUN, "--config", config, "--checkpoint", ckpt, "--test_only", "--output_dir", str(out_dir),
           "--device", device]
    if cfg_options:
        cmd += ["--cfg_options", *cfg_options]
    subprocess.run(cmd, cwd=REPO, check=True)
    return read_jsonl_last(out_dir / "test_stats.json")


def _best_val_psnr(out_dir: Path, best: float) -> float:
    # training versions its output dir; read the newest val log (numerically: version_10 after version_9)
    val_logs = sorted(out_dir.glob("version_*/val_stats.json"), key=_version_key)
    if val_logs:
        for line in val_logs[-1].read_text().splitlines():
            if line.strip():
                psnr = json.loads(line).get("val_loss_rgb_psnr")
                if psnr is not None:
                    best = max(best, float(psnr))
    return best


def run_time_to_quality(
    config: str,
    out_dir: Path,
    target_psnr: float,
    device: str,
    cfg_options: Sequence[str] = (),
    timeout_s: float = 3 * 3600,
    poll_s: float = 5.0,
) -> Dict[str, object]:
    """Train until val PSNR crosses ``target_psnr``, then SIGTERM (the runner drains: checkpoint, exit).

    A child still draining ``DRAIN_TIMEOUT_S`` after the signal is killed.
    Returns ``{reached, minutes_to_target, target_psnr, best_val_psnr,
    wall_minutes_total}``.
    """
    cmd = [*RUN, "--config", config, "--output_dir", str(out_dir), "--device", device]
    if cfg_options:
        cmd += ["--cfg_options", *cfg_options]
    start = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=REPO)
    best, reached, minutes = float("-inf"), False, None
    try:
        while proc.poll() is None and time.perf_counter() - start <= timeout_s:
            best = _best_val_psnr(out_dir, best)
            if best >= target_psnr:
                reached, minutes = True, (time.perf_counter() - start) / 60.0
                break
            time.sleep(poll_s)
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=DRAIN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                print(f"time-to-quality run did not drain {DRAIN_TIMEOUT_S:.0f} s after SIGTERM; killing it",
                      flush=True)
                proc.kill()
                proc.wait()
    # val lines written between the last poll and the exit (a run whose last validation crosses the target) count
    best = _best_val_psnr(out_dir, best)
    if not reached and best >= target_psnr:
        reached, minutes = True, (time.perf_counter() - start) / 60.0
    return {
        "reached": reached,
        "minutes_to_target": None if minutes is None else round(minutes, 2),
        "target_psnr": target_psnr,
        "best_val_psnr": None if best == float("-inf") else round(best, 3),
        "wall_minutes_total": round((time.perf_counter() - start) / 60.0, 2),
    }


def real_mode(args) -> dict:
    root = Path(args.root).resolve()
    record: dict = {"mode": "real", "root": str(root), "stages": {}}
    for scene, config in CONFIGS.items():
        marker = root / DATA_MARKERS[scene]
        ckpt = find_ckpt(scene, getattr(args, f"{scene}_ckpt"), root)
        stage: dict = {"expected_psnr": EXPECTED[scene], "data_found": marker.exists(), "ckpt": ckpt}
        if marker.exists() and ckpt:
            options = _dataset_options(marker.parent) + _kernel_options(config, args.device)
            stats = run_test_only(config, ckpt, root / "results" / "parity" / scene, args.device, options)
            psnr = stats.get("test_loss_rgb_psnr")
            stage.update(test_psnr=psnr, delta_vs_expected=None if psnr is None else round(psnr - EXPECTED[scene], 3))
        else:
            missing = [what for what, ok in (("dataset", marker.exists()), ("released .pth", ckpt)) if not ok]
            stage["skipped"] = f"no {' and no '.join(missing)} found under {root}"
        record["stages"][scene] = stage

    lego = root / DATA_MARKERS["lego"]
    if lego.exists() and not args.skip_time_to_quality:
        record["stages"]["time_to_30.7"] = run_time_to_quality(
            TIME_TO_QUALITY_CONFIG,
            root / "results" / "parity" / "lego_time_to_quality",
            target_psnr=30.7,
            device=args.device,
            cfg_options=_dataset_options(lego.parent) + _kernel_options(TIME_TO_QUALITY_CONFIG, args.device)
            + ["runner.val_per_iter=1000", "runner.num_iters=40000"],
        )
    else:
        reason = "--skip_time_to_quality" if args.skip_time_to_quality else f"no lego dataset found under {root}"
        record["stages"]["time_to_30.7"] = {"skipped": reason}
    return record


def smoke_options(scene_dir: Path) -> List[str]:
    """``lego.yml`` at CPU-feasible sizes: the config surface of the real runs, a 64-pixel scene."""
    return [
        'datasets=[{"type":"BlenderDataset","base_dir":"%s","split":"train"},'
        '{"type":"BlenderDataset","base_dir":"%s","split":"val"},'
        '{"type":"BlenderDataset","base_dir":"%s","split":"test"}]' % (scene_dir, scene_dir, scene_dir),
        "pipeline.ray_sampler.image_height=64",
        "pipeline.ray_sampler.image_width=64",
        "pipeline.ray_sampler.n_rays_per_image_sampled_from_mask=64",
        "pipeline.ray_sampler.n_pts_per_ray_training=8",
        "pipeline.ray_sampler.n_pts_per_ray_evaluation=8",
        "pipeline.renderer.n_pts_per_ray_fine_training=8",
        "pipeline.renderer.n_pts_per_ray_fine_evaluation=8",
        "pipeline.model.n_layers=2",
        "pipeline.model.input_skips=[]",
        "pipeline.model.n_hidden_neurons_xyz=32",
        "pipeline.model.n_hidden_neurons_dir=16",
        "pipeline.chunk_size_grid=8192",
        "runner.cache_dataset_on_device=False",
    ]


def smoke_mode(args) -> dict:
    """The real mode's code paths on procedural stand-ins, with a reachable PSNR target."""
    import torch

    from .pipelines import PIPELINES
    from .runners.checkpoints import export_torch_checkpoint
    from .utils.config import Config, DictAction

    work = Path(args.smoke_dir).resolve()
    work.mkdir(parents=True, exist_ok=True)
    scene_dir = work / "scene"
    if not (scene_dir / "transforms_test.json").exists():
        subprocess.run([sys.executable, "-m", "yanerf_tpu_torch.synth_scene", "--out_dir", str(scene_dir), "--hw",
                        "64", "--n_train", "6", "--n_val", "2", "--n_test", "2"], cwd=REPO, check=True)
    options = smoke_options(scene_dir)
    if args.device == "cuda":  # K1 / K3 are built for the published widths: the MLP keeps them on the card
        options += SMOKE_KERNEL_WIDTHS + _kernel_options(CONFIGS["lego"], args.device)

    # a reference-layout .pth of a fresh pipeline of the same config: the import path end to end
    cfg = Config.fromfile(str(REPO / CONFIGS["lego"]))
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg_options", nargs="+", action=DictAction)
    cfg.merge_from_dict(parser.parse_args(["--cfg_options", *options]).cfg_options)
    pipeline = PIPELINES.build(cfg.pipeline, generator=torch.Generator().manual_seed(0), device="cpu")
    pth = work / "smoke.ckpts_-001.pth"
    n_tensors = export_torch_checkpoint(pipeline, pth)

    record: dict = {"mode": "smoke", "device": args.device, "stages": {}, "pth_tensors": n_tensors}
    stats = run_test_only(CONFIGS["lego"], str(pth), work / "test_only", args.device, cfg_options=options)
    psnr = stats.get("test_loss_rgb_psnr")
    record["stages"]["test_only_import"] = {"test_psnr": psnr, "ok": psnr is not None}

    iters = int(args.smoke_iters)
    ttq = run_time_to_quality(
        CONFIGS["lego"],
        work / "time_to_quality",
        target_psnr=float(args.smoke_target_psnr),
        device=args.device,
        cfg_options=options + [f"runner.num_iters={iters}", f"runner.val_per_iter={max(1, iters // 6)}",
                               "runner.warmup_steps=10", "runner.print_per_iter=50",
                               "runner.save_per_iter=1000000"],
        timeout_s=args.smoke_timeout,
        poll_s=1.0,
    )
    ttq["ok"] = ttq["reached"] or ttq["best_val_psnr"] is not None
    record["stages"]["time_to_quality"] = ttq
    record["ok"] = bool(record["stages"]["test_only_import"]["ok"]) and ttq["ok"]
    return record


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="results/parity_real.json")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--root", default=str(REPO), help="where data/ and the checkpoints are searched")
    parser.add_argument("--lego_ckpt", default=None, help="path to the released lego .pth")
    parser.add_argument("--fern_ckpt", default=None, help="path to the released fern .pth")
    parser.add_argument("--skip_time_to_quality", action="store_true")
    parser.add_argument("--smoke", action="store_true", help="check the flow on procedural stand-ins")
    parser.add_argument("--smoke_dir", default=str(REPO / "results" / "parity_smoke"))
    parser.add_argument("--smoke_target_psnr", default=10.0, type=float)
    parser.add_argument("--smoke_iters", default=300, type=int)
    parser.add_argument("--smoke_timeout", default=1800, type=float)
    args = parser.parse_args(argv)

    record = smoke_mode(args) if args.smoke else real_mode(args)
    record["timestamp"] = time.strftime("%Y-%m-%dT%H:%M:%S")
    out = REPO / args.out if not osp.isabs(args.out) else Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(record, indent=2) + "\n")
    print(json.dumps(record, indent=2))
    return 0 if record.get("ok", True) else 1


if __name__ == "__main__":
    sys.exit(main())
