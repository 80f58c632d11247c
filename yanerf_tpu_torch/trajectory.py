"""Per-tensor divergence of the NeRF-MLP kernel arms from the eager model over training steps.

    python -m yanerf_tpu_torch.trajectory --scene <blender scene dir> [--steps 1000] [--device cuda] [--out t.json]

Trains the flagship (``configs/nerf/lego_proposal.yml`` unless ``--config``)
along five arms from one init and one draw stream, each on the fused K-step
dispatch of the config (``FusedTrainStep``; a captured CUDA graph on the
card, ``steps_per_call: 20`` as the flagship ships):
  * ``eager``: the eager NeRFMLP, no kernel;
  * ``k1k3``: ``use_pallas_train``, K1 forward and K3 backward;
  * ``k1``: K1 forward, the eager model's backward (``fused_mlp.ARMS``);
  * ``k3``: the eager model's forward, K3 backward;
  * ``eager_ulp``: the eager model from the init times ``1 + 2^-23`` (one
    float32 ulp on every NeRF-MLP weight): how far rounding noise alone
    carries a run, the floor the other arms are read against.
The batch rows come from ``--seed``, the draws of step k from
``make_step_draws(seed, k)``, so every arm sees the same rays and samples.

For every NeRF-MLP tensor (and the skip layer's embedding rows and the
first color layer's direction rows as tensors of their own) it reports,
against the eager arm:
  * at step 0, the gradient's cosine, its relative error
    ``|g - g_eager| / |g_eager|`` and the share of elements whose sign
    agrees: Adam's first update is ``-lr g / (|g| + eps)``, whose sign is
    the gradient's; and every arm's (eager's too) relative error against the
    step-0 gradient of the NeRF-MLP in float32 (``grad_rel_err_f32``; the
    same weights, the proposal models as they are), which says which bf16
    gradient is nearer the exact one;
  * at each of ``--checkpoints`` (10, 100, 1000), the weights' distance from
    the eager arm's, relative to the eager arm's own distance from the init
    (``rel_update``: 1 means the arms differ by as much as training moved
    the weights) and to the eager weights' norm (``rel_norm``);
and per arm the mean train MSE and PSNR of the last 100 steps. With
``--plain_check`` each arm's step-0 gradients on the card are also held,
tensor by tensor, to the same step on the CPU, where the kernels run their
plain versions (the same weights, batch and draws), at the init and at the
eager arm's trained weights; and at the trained weights the NeRF-MLP's
outputs on random points (``forward_check``): K1, its plain version and the
eager model against the float32 model.
"""

from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
CONFIG = REPO / "configs" / "nerf" / "lego_proposal.yml"
ARMS = ("eager", "k1k3", "k1", "k3", "eager_ulp")
CHECKPOINTS = (10, 100, 1000)
ULP = 2.0 ** -23


def dispatch_groups(steps: int, checkpoints: Sequence[int], steps_per_call: int) -> List[int]:
    """Dispatch sizes of at most ``steps_per_call`` whose running sums hit step 1 and every checkpoint."""
    marks = sorted({1, *(c for c in checkpoints if c <= steps), steps})
    groups, at = [], 0
    for mark in marks:
        while at < mark:
            n = min(steps_per_call, mark - at)
            groups.append(n)
            at += n
    return groups


def nerf_mlps(pipeline) -> List[torch.nn.Module]:
    from .models.nerf_mlp import NeRFMLP

    return [fn for fn in pipeline.implicit_functions if isinstance(fn, NeRFMLP)]


def tensors(pipeline) -> Dict[str, torch.Tensor]:
    """Every NeRF-MLP tensor by name (``m{i}.{param}``), plus the skip layer's embedding rows and the first color
    layer's direction rows."""
    out: Dict[str, torch.Tensor] = {}
    for i, mlp in enumerate(nerf_mlps(pipeline)):
        for name, p in mlp.named_parameters():
            out[f"m{i}.{name}"] = p
        h = mlp.n_hidden_neurons_xyz
        for skip in mlp.input_skips:
            if 0 < skip < mlp.n_layers:
                out[f"m{i}.xyz_encoder.mlp.{skip}.w[embedding rows]"] = mlp.xyz_encoder.mlp[skip].w[h:]
        out[f"m{i}.color_layer.0.w[direction rows]"] = mlp.color_layer[0].w[h:]
    return out


def build_arm(cfg, arm: str, seed: int, device: torch.device, init: Optional[Dict[str, torch.Tensor]] = None):
    """The pipeline of ``arm``: the config's init from ``seed`` (``init``, a state dict, replaces it)."""
    from .pipelines import PIPELINES

    pipeline = PIPELINES.build(cfg.pipeline, generator=torch.Generator().manual_seed(seed), device=device)
    if init is not None:
        pipeline.load_state_dict(init)
    for mlp in nerf_mlps(pipeline):
        mlp.use_pallas_train = arm in ("k1k3", "k1", "k3")
        mlp.kernel_arm = arm if mlp.use_pallas_train else "k1k3"
        if arm == "eager_ulp":
            with torch.no_grad():
                for p in mlp.parameters():
                    p.mul_(1.0 + ULP)
    return pipeline


def step0_gradients(pipeline, batch: Dict[str, Any], draws: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The gradient of the first step's objective for every tensor of :func:`tensors` (host float32)."""
    from .ops.structures import EvaluationMode

    pipeline.train()
    pipeline.zero_grad(set_to_none=True)
    preds = pipeline(evaluation_mode=EvaluationMode.TRAINING, draws=draws, **batch)
    torch.mean(preds["objective"]).backward()
    grads = {}
    for i, mlp in enumerate(nerf_mlps(pipeline)):
        h = mlp.n_hidden_neurons_xyz
        for name, p in mlp.named_parameters():
            grads[f"m{i}.{name}"] = p.grad.detach().float().cpu()
        for skip in mlp.input_skips:
            if 0 < skip < mlp.n_layers:
                grads[f"m{i}.xyz_encoder.mlp.{skip}.w[embedding rows]"] = grads[f"m{i}.xyz_encoder.mlp.{skip}.w"][h:]
        grads[f"m{i}.color_layer.0.w[direction rows]"] = grads[f"m{i}.color_layer.0.w"][h:]
    pipeline.zero_grad(set_to_none=True)
    return grads


def snapshot(pipeline) -> Dict[str, torch.Tensor]:
    return {k: v.detach().float().cpu().clone() for k, v in tensors(pipeline).items()}


def run_arm(cfg, arm: str, seed: int, device: torch.device, arrays, data_wrapper, rows: np.ndarray,
            checkpoints: Sequence[int], init=None) -> Dict[str, Any]:
    """Train ``arm`` for ``len(rows)`` steps on the fused dispatch; its step-0 gradients, its weights at step 1
    and at each checkpoint, its per-step train MSE."""
    from .runners import TrainState, create_optimizer, make_step_draws, make_train_step_fused
    from .runners.apis import _gather_batch

    pipeline = build_arm(cfg, arm, seed, device, init)
    batch = _gather_batch(arrays, data_wrapper, torch.as_tensor(rows[0], device=device))
    grads = step0_gradients(pipeline, batch, make_step_draws(pipeline, rows.shape[1], seed, 0))
    state = TrainState(pipeline=pipeline, optimizer=create_optimizer(cfg.runner, pipeline), step=0)
    fused = make_train_step_fused(pipeline, cfg.runner, seed, data_wrapper)
    weights = {0: snapshot(pipeline)}
    mse: List[float] = []
    t = time.perf_counter()
    for n in dispatch_groups(len(rows), checkpoints, int(cfg.runner.steps_per_call)):
        hist = fused(state, arrays, rows[state.step : state.step + n])
        mse += hist["loss_rgb_mse"].float().mean(dim=1).cpu().tolist()
        if state.step == 1 or state.step in checkpoints or state.step == len(rows):
            weights[state.step] = snapshot(pipeline)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t
    tail = float(np.mean(mse[-100:]))
    return dict(grads=grads, weights=weights, mse=mse, seconds=seconds, tail_mse=tail,
                tail_psnr=-10.0 * math.log10(tail), steps=state.step,
                final={k: v.detach().clone() for k, v in pipeline.state_dict().items()})


def _cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    den = float(a.norm() * b.norm())
    return float(a @ b) / den if den > 0 else float(torch.equal(a, b))


def _rel(a: torch.Tensor, b: torch.Tensor, scale: torch.Tensor) -> float:
    s = float(scale.double().norm())
    return float((a.double() - b.double()).norm()) / s if s > 0 else float("nan")


def compare(runs: Dict[str, Dict[str, Any]], f32_grads: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """Every arm against the eager arm, tensor by tensor (see the module's docstring); the eager arm against
    the float32 gradient only."""
    ref = runs["eager"]
    out: Dict[str, Any] = {"eager": {name: {"grad_rel_err_f32": _rel(g, f32_grads[name], f32_grads[name])}
                                     for name, g in ref["grads"].items()}}
    for arm, run in runs.items():
        if arm == "eager":
            continue
        per_tensor = {}
        for name, g in run["grads"].items():
            ge = ref["grads"][name]
            row = {"grad_cosine": _cosine(g, ge), "grad_rel_err": _rel(g, ge, ge),
                   "sign_agreement": float((torch.sign(g) == torch.sign(ge)).double().mean()),
                   "grad_rel_err_f32": _rel(g, f32_grads[name], f32_grads[name])}
            for step in sorted(k for k in run["weights"] if k > 1):
                w, we, w0 = run["weights"][step][name], ref["weights"][step][name], ref["weights"][0][name]
                row[f"rel_update_{step}"] = _rel(w, we, we - w0)
                row[f"rel_norm_{step}"] = _rel(w, we, we)
            per_tensor[name] = row
        out[arm] = per_tensor
    return out


def summary(comparison: Dict[str, Any], runs: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Per arm: the worst step-0 cosine and sign agreement and the largest ``rel_update`` at each checkpoint,
    each with its tensor; the arm's tail PSNR and seconds."""
    out = {}
    for arm, per_tensor in comparison.items():
        row: Dict[str, Any] = {"tail_psnr": runs[arm]["tail_psnr"], "seconds": runs[arm]["seconds"]}
        name = max(per_tensor, key=lambda n: per_tensor[n]["grad_rel_err_f32"])
        row["max_grad_rel_err_f32"] = [name, per_tensor[name]["grad_rel_err_f32"]]
        if arm == "eager":
            out[arm] = row
            continue
        for key, pick in (("grad_cosine", min), ("sign_agreement", min)):
            name = pick(per_tensor, key=lambda n: per_tensor[n][key])
            row[f"worst_{key}"] = [name, per_tensor[name][key]]
        for key in next(iter(per_tensor.values())):
            if key.startswith("rel_update_"):
                name = max(per_tensor, key=lambda n: per_tensor[n][key])
                row[f"max_{key}"] = [name, per_tensor[name][key]]
        out[arm] = row
    return out


def _to_cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    return tree


def card_against_plain(cfgs: Dict[str, Any], seed: int, init, batch, draws, card_grads) -> Dict[str, Any]:
    """Each arm's step-0 gradients on the card against the same step on the CPU (the kernels' plain versions),
    the same weights, batch and draws: per tensor ``|g_card - g_cpu| / |g_cpu|``."""
    cpu = torch.device("cpu")
    init_cpu, batch_cpu, draws_cpu = _to_cpu(init), _to_cpu(batch), _to_cpu(draws)
    out = {}
    for arm, grads in card_grads.items():
        cfg, path = cfgs[arm]
        plain = step0_gradients(build_arm(cfg, path, seed, cpu, init_cpu), batch_cpu, draws_cpu)
        out[arm] = {name: _rel(g, plain[name], plain[name]) for name, g in grads.items()}
    return out


def forward_check(cfg, f32_cfg, seed: int, weights, device: torch.device, n_rays: int = 4096,
                  pts_per_ray: int = 48) -> Dict[str, Any]:
    """The NeRF-MLP's outputs at ``weights`` on random points of [-1.3, 1.3]^3, against the float32 model on the
    card: K1 on the card, K1's plain version on the CPU, the eager bf16 model on the card. Per output channel
    (density, r, g, b) the mean and the root mean square of each one's difference from float32, and of K1's
    from its plain version."""
    gen = torch.Generator().manual_seed(seed)
    points = torch.rand(n_rays * pts_per_ray, 3, generator=gen) * 2.6 - 1.3
    dirs = torch.randn(n_rays, 3, generator=gen)
    cpu = torch.device("cpu")
    mlp = nerf_mlps(build_arm(cfg, "k1k3", seed, device, weights))[-1]
    mlp32 = nerf_mlps(build_arm(f32_cfg, "eager", seed, device, weights))[-1]
    mlp_cpu = nerf_mlps(build_arm(cfg, "k1k3", seed, cpu, _to_cpu(weights)))[-1]
    from .ops.kernels import nerf_mlp_fwd

    with torch.no_grad():
        p, d = points.to(device), dirs.to(device)
        ref = mlp32.eager_flat(p, d, pts_per_ray).cpu()
        outs = {"k1": nerf_mlp_fwd.nerf_mlp_fwd(mlp.packed_weights(), p, d, pts_per_ray).cpu(),
                "plain": nerf_mlp_fwd.nerf_mlp_fwd(mlp_cpu.packed_weights(), points, dirs, pts_per_ray),
                "eager": mlp.eager_flat(p, d, pts_per_ray).cpu()}
    stats = {}
    for name, out in outs.items():
        diff = (out - ref).double()
        stats[f"{name}_minus_f32"] = {"mean": diff.mean(0).tolist(), "rms": diff.pow(2).mean(0).sqrt().tolist()}
    diff = (outs["k1"] - outs["plain"]).double()
    stats["k1_minus_plain"] = {"mean": diff.mean(0).tolist(), "rms": diff.pow(2).mean(0).sqrt().tolist()}
    stats["f32_scale"] = ref.double().abs().mean(0).tolist()
    return stats


def trajectory(cfg, scene: Path, steps: int, device, seed: int = 0, checkpoints: Sequence[int] = CHECKPOINTS,
               arms: Sequence[str] = ARMS, plain_check: bool = False) -> Dict[str, Any]:
    """Run every arm of ``arms`` (the first must be ``eager``) on ``scene``; returns the comparison, its summary
    and each arm's per-step train MSE. ``plain_check`` (on the card) adds :func:`card_against_plain` for the
    float32 model and every arm."""
    from .datasets import DATASETS, DeviceCachedLoader, create_loader
    from .pipelines import set_nerf_mlp_option
    from .runners import make_step_draws
    from .runners.apis import _gather_batch

    if arms[0] != "eager":
        raise ValueError("the eager arm comes first: every other arm is held against it")
    device = torch.device(device)
    dataset_cfg = dict(cfg.datasets[0], base_dir=str(scene))
    dataset = DATASETS.build(dataset_cfg)
    batch_size = int(cfg.runner.batch_size_list[0])
    loader = DeviceCachedLoader(create_loader(dataset, None, batch_size, 0, is_train=True), device,
                                quantize_images=bool(cfg.runner.get("cache_quantize_images", False)))
    if not loader._ensure_cache():
        raise ValueError("the scene does not fit the device cache the fused dispatch trains from")
    rows = np.random.RandomState(seed).randint(len(dataset), size=(steps, batch_size))
    init = build_arm(cfg, "eager", seed, device).state_dict()
    f32_cfg = cfg.copy()
    set_nerf_mlp_option(f32_cfg, "compute_dtype", "float32")
    f32 = build_arm(f32_cfg, "eager", seed, device, init)
    batch0 = _gather_batch(loader._arrays, loader.data_wrapper, torch.as_tensor(rows[0], device=device))
    draws0 = make_step_draws(f32, batch_size, seed, 0)
    step0_gradients(f32, batch0, draws0)  # a warm-up: the process's first pass pays its one-off costs
    f32_grads = step0_gradients(f32, batch0, draws0)
    del f32
    runs = {}
    for arm in arms:
        runs[arm] = run_arm(cfg, arm, seed, device, loader._arrays, loader.data_wrapper, rows, checkpoints, init)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    comparison = compare(runs, f32_grads)
    record = {"steps": steps, "checkpoints": [c for c in checkpoints if c <= steps], "arms": list(arms),
              "summary": summary(comparison, runs), "per_tensor": comparison,
              "mse": {arm: run["mse"] for arm, run in runs.items()}}
    if plain_check:
        cfgs = {"f32": (f32_cfg, "eager"), **{arm: (cfg, arm) for arm in arms if arm != "eager_ulp"}}
        grads = {"f32": f32_grads, **{arm: runs[arm]["grads"] for arm in arms if arm != "eager_ulp"}}
        record["card_against_plain"] = card_against_plain(cfgs, seed, init, batch0, draws0, grads)
        # again at the eager arm's trained weights, where the densities are the scene's, not the init's
        trained = runs["eager"]["final"]
        grads = {arm: step0_gradients(build_arm(c, path, seed, device, trained), batch0, draws0)
                 for arm, (c, path) in cfgs.items()}
        record["card_against_plain_trained"] = card_against_plain(cfgs, seed, trained, batch0, draws0, grads)
        record["trained_grad_rel_err_f32"] = {arm: {n: _rel(g[n], grads["f32"][n], grads["f32"][n]) for n in g}
                                              for arm, g in grads.items()}
        record["forward_check"] = forward_check(cfg, f32_cfg, seed, trained, device)
    return record


def flagship_config(config: Path = CONFIG):
    """The config with ``use_pallas_train`` on its NeRFMLPs (each arm sets its own path)."""
    from .pipelines import set_nerf_mlp_option
    from .utils import Config

    cfg = Config.fromfile(str(config))
    set_nerf_mlp_option(cfg, "use_pallas_train", True)
    return cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", required=True, help="a Blender-format scene (python -m yanerf_tpu_torch.synth_scene)")
    ap.add_argument("--config", default=str(CONFIG))
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--checkpoints", type=int, nargs="+", default=list(CHECKPOINTS))
    ap.add_argument("--arms", nargs="+", default=list(ARMS), choices=ARMS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None, help="write the whole record here as JSON")
    ap.add_argument("--plain_check", action="store_true",
                    help="each arm's step-0 gradients on the card against the same step on the CPU")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    record = trajectory(flagship_config(Path(args.config)), Path(args.scene), args.steps, args.device, args.seed,
                        args.checkpoints, args.arms, args.plain_check)
    if args.device == "cuda":
        record["device"] = torch.cuda.get_device_name(0)
    if args.out:
        Path(args.out).write_text(json.dumps(record, indent=1) + "\n")
    print(json.dumps(record["summary"], indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
