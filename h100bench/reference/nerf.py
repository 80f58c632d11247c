"""Plain PyTorch reference of the benchmark's NeRF configurations: rays, draws, models, renderers, losses, Adam.

Written from the published description (Mildenhall et al. 2020 for the
NeRF MLP and the coarse-to-fine renderer, mip-NeRF 360 for the proposal
sampler and its interlevel loss) and the configuration file's settings, in
float32 with TF32 off. It imports nothing of the program: the benchmark
hands it the weights and the inputs it made, and it works out the rest
again (the image order, the random draws from the run's seed, the samples,
the gradients and the optimizer state).

``precision="fp8"`` is the control: the models compute in float8 e4m3
where the configuration's bfloat16 policy computes in bfloat16 (the step
below it): every matrix product's operands and every layer's output are
rounded to float8 under a per-tensor scale, the gradients passing
straight through the rounding.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

Params = Dict[str, torch.Tensor]
FP8_MAX = 448.0  # the largest float8 e4m3fn value


def no_tf32() -> None:
    """Full float32 matrix products on the card: the reference is float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a per-tensor scale; the gradient passes through unchanged."""
    scale = FP8_MAX / x.detach().abs().amax().clamp(min=1e-30)
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
    return x + (q - x.detach())


def linspace01(n: int, device) -> torch.Tensor:
    """``n`` values evenly spaced on [0, 1]: ``i * (1 / (n - 1))``, the last exactly 1."""
    if n == 1:
        return torch.zeros(1, device=device)
    step = torch.arange(n - 1, dtype=torch.float32) * torch.tensor(1.0 / (n - 1), dtype=torch.float32)
    return torch.cat([step, torch.ones(1)]).to(device)


def harmonic(x: torch.Tensor, n_freqs: int, append: bool = True) -> torch.Tensor:
    """``sin | cos | x`` of ``x * 2^k``, ``k < n_freqs``, each coordinate's frequencies together."""
    freqs = (2.0 ** torch.arange(n_freqs, dtype=torch.float32)).to(x.device)
    embed = (x[..., None] * freqs).reshape(*x.shape[:-1], -1)
    parts = [torch.sin(embed), torch.cos(embed)] + ([x] if append else [])
    return torch.cat(parts, dim=-1)


class Model:
    """The MLPs of one configuration over a dict of named weights (the program's parameter names)."""

    def __init__(self, config: dict, precision: str = "float32") -> None:
        if precision not in ("float32", "fp8"):
            raise ValueError(f"precision {precision!r}: float32 or fp8")
        self.precision = precision
        pipe = config["pipeline"]
        models = pipe["model"]
        self.models = list(models) if isinstance(models, list) else [models] * int(pipe["num_passes"])

    def _mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            return fp8_round(x) @ fp8_round(w)
        return x @ w

    def _out(self, y: torch.Tensor) -> torch.Tensor:
        return fp8_round(y) if self.precision == "fp8" else y

    def linear(self, p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
        return self._out(self._mm(x, p[name + ".w"]) + p[name + ".b"])

    def proposal(self, p: Params, i: int, points: torch.Tensor) -> torch.Tensor:
        """Raw densities ``(..., P, 1)`` of proposal MLP ``i`` at ``points`` ``(..., P, 3)``."""
        cfg, prefix = self.models[i], f"implicit_functions.{i}."
        x = harmonic(points, int(cfg.get("n_harmonic_functions_xyz", 10)),
                     cfg.get("harmonic_functions_xyz_append_intput", True))
        for layer in range(int(cfg.get("n_layers", 4))):
            x = torch.relu(self.linear(p, f"{prefix}mlp.{layer}", x))
        return self.linear(p, prefix + "density_layer", x)

    def nerf(self, p: Params, i: int, points: torch.Tensor, directions: torch.Tensor):
        """Raw densities ``(..., P, 1)`` and colors ``(..., P, 3)`` of NeRF MLP ``i``; ``directions`` per ray."""
        cfg, prefix = self.models[i], f"implicit_functions.{i}."
        emb = harmonic(points, int(cfg["n_harmonic_functions_xyz"]), cfg["harmonic_functions_xyz_append_intput"])
        y = emb
        for layer in range(int(cfg["n_layers"])):
            if layer > 0 and layer in cfg["input_skips"]:
                y = torch.cat([y, emb], dim=-1)
            y = torch.relu(self.linear(p, f"{prefix}xyz_encoder.mlp.{layer}", y))
        density = self.linear(p, prefix + "density_layer", y)
        inter = self.linear(p, prefix + "intermediate_linear", y)
        unit = directions / torch.clamp(torch.linalg.vector_norm(directions, dim=-1, keepdim=True), min=1e-12)
        dir_emb = harmonic(unit, int(cfg["n_harmonic_functions_dir"]), cfg["harmonic_functions_dir_append_intput"])
        w0 = p[prefix + "color_layer.0.w"]
        hidden = inter.shape[-1]
        color = self._mm(inter, w0[:hidden]) + p[prefix + "color_layer.0.b"] + self._mm(dir_emb, w0[hidden:])[..., None, :]
        color = torch.relu(self._out(color))
        n_color = sum(1 for k in p if k.startswith(prefix + "color_layer.") and k.endswith(".w"))
        for j in range(1, n_color - 1):
            color = torch.relu(self.linear(p, f"{prefix}color_layer.{j}", color))
        return density, torch.sigmoid(self.linear(p, f"{prefix}color_layer.{n_color - 1}", color))


def composite_weights(raw: torch.Tensor, lengths: torch.Tensor, directions: torch.Tensor, bias: float,
                      noise: torch.Tensor = None, noise_std: float = 0.0) -> torch.Tensor:
    """Emission-absorption weights ``(..., P)``: ``(1 - exp(-delta sigma))`` times the transmittance, one less the
    opacity ``1 - exp(-sum of delta sigma)`` of the intervals before,
    the last interval 1e10 long, deltas scaled by ``|d|``, ``sigma = relu(raw [+ noise * std]) + bias``."""
    deltas = torch.cat([lengths[..., 1:] - lengths[..., :-1], torch.full_like(lengths[..., :1], 1e10)], dim=-1)
    deltas = deltas * torch.linalg.vector_norm(directions, dim=-1)[..., None]
    sigma = raw[..., 0]
    if noise is not None:
        sigma = sigma + noise * noise_std
    tau = deltas * (torch.relu(sigma) + bias)
    opacity = 1.0 - torch.exp(-torch.cumsum(tau, dim=-1))  # of the ray up to and with each interval
    transmittance = torch.cat([torch.ones_like(tau[..., :1]), 1.0 - opacity[..., :-1]], dim=-1)
    return (1.0 - torch.exp(-tau)) * transmittance


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inverse-CDF samples of the piecewise-constant pdf over ``bins`` (edges) with masses ``weights + eps``.

    A ``u`` at or above the top of the CDF lands on the last edge.
    """
    weights = torch.clamp(weights, min=0.0) + eps
    cdf = torch.cumsum(weights / weights.sum(dim=-1, keepdim=True), dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    n_bins = weights.shape[-1]
    idx = torch.clamp(torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True) - 1, 0, n_bins - 1)
    lo, hi = torch.gather(cdf, -1, idx), torch.gather(cdf, -1, idx + 1)
    b_lo, b_hi = torch.gather(bins, -1, idx), torch.gather(bins, -1, idx + 1)
    denom = torch.where(hi - lo < eps, torch.ones_like(hi), hi - lo)
    val = b_lo + (u - lo) / denom * (b_hi - b_lo)
    top = (idx == n_bins - 1) & (u >= torch.clamp(hi, max=1.0))
    return torch.where(top, b_hi, val)


def interlevel_loss(t: torch.Tensor, w: torch.Tensor, t_prop: torch.Tensor, w_prop: torch.Tensor,
                    eps: float = 1e-7) -> torch.Tensor:
    """Per ray ``sum relu(w - w_outer)^2 / (w + eps)`` (mip-NeRF 360 eq. 13), ``w_outer`` the proposal mass over
    the intervals each final interval overlaps; the last (unbounded) interval left out on both sides."""
    t, w = t.detach(), w.detach()
    t_lo, t_hi, w = t[..., :-1], t[..., 1:], w[..., :-1]
    p_lo, p_hi, w_prop = t_prop[..., :-1].detach(), t_prop[..., 1:].detach(), w_prop[..., :-1]
    overlap = ((p_lo[..., None, :] <= t_hi[..., :, None]) & (p_hi[..., None, :] >= t_lo[..., :, None])).float()
    w_outer = torch.sum(w_prop[..., None, :] * overlap, dim=-1)
    excess = torch.relu(w - w_outer)
    return torch.sum(excess * excess / (w + eps), dim=-1)


def stratified(z: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """One draw per depth between the midpoints to its neighbours (the ends keep their outer half)."""
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    upper = torch.cat([mids, z[..., -1:]], dim=-1)
    lower = torch.cat([z[..., :1], mids], dim=-1)
    return lower + (upper - lower) * u


def rays(pose: torch.Tensor, focal: float, xy: torch.Tensor, width: int, height: int):
    """Origins and (unnormalized) directions of the pixels ``xy`` ``(..., 2)`` (x, y) of a 3x4 camera-to-world."""
    cam = torch.stack([(xy[..., 0] - width * 0.5) / focal, (xy[..., 1] - height * 0.5) / focal,
                       torch.ones_like(xy[..., 0])], dim=-1)
    directions = torch.sum(pose[:3, :3] * cam[..., None, :], dim=-1)
    return pose[:3, 3].expand_as(directions), directions


class Renderer:
    """One configuration's ray sampler, renderer and objective over ``Model``."""

    def __init__(self, config: dict, precision: str = "float32") -> None:
        pipe = config["pipeline"]
        self.model = Model(config, precision)
        self.sampler, self.r = pipe["ray_sampler"], pipe["renderer"]
        self.loss_weights = pipe["loss_weights"]
        self.proposal = self.r["type"].startswith("Proposal")
        self.height, self.width = int(self.sampler["image_height"]), int(self.sampler["image_width"])
        self.bias = float(self.r.get("background_density_bias", 0.0))
        if any(float(c) != 0.0 for c in self.r.get("bg_color", [0.0])):
            raise ValueError("the reference composites onto a black background only")

    def depths(self, lead: Tuple[int, ...], n: int, device) -> torch.Tensor:
        lo, hi = float(self.sampler["min_depth"]), float(self.sampler["max_depth"])
        return (linspace01(n, device) * (hi - lo) + lo).expand(*lead, n)

    def render(self, p: Params, origins, directions, z, training: bool, draws: Dict[str, List[torch.Tensor]]):
        """``(rgb, depth, {loss name: per-ray loss})`` of rays ``(..., 3)`` at first depths ``z`` ``(..., P)``.

        ``draws``: ``pdf_u`` (one tensor per refinement) and ``density_noise`` (one per compositing pass);
        without them the refinements are deterministic.
        """
        pts = lambda zz: origins[..., None, :] + zz[..., :, None] * directions[..., None, :]  # noqa: E731
        r, model = self.r, self.model
        pdf_u, noise = draws.get("pdf_u", []), draws.get("density_noise", [])
        mode = "training" if training else "evaluation"
        losses = {}
        if self.proposal:
            schedule = list(r["n_pts_per_ray_intermediate_" + mode]) + [int(r["n_pts_per_ray_final_" + mode])]
            histograms = []
            for k, n in enumerate(schedule):
                w = composite_weights(model.proposal(p, k, pts(z)), z, directions, self.bias)
                histograms.append((z, w))
                u = pdf_u[k] if training else linspace01(n, z.device).expand(*z.shape[:-1], n)
                if training:
                    u = (torch.arange(n, dtype=torch.float32, device=z.device) + u) / n
                z = sample_pdf(0.5 * (z[..., 1:] + z[..., :-1]), w.detach()[..., 1:-1], u).detach()
            raw, rgb = model.nerf(p, len(schedule), pts(z), directions)
            std = float(r.get("density_noise_std_train", 0.0)) if training else 0.0
            w = composite_weights(raw, z, directions, self.bias, noise[0] if std else None, std)
            losses["loss_proposal"] = sum(interlevel_loss(z, w, zk, wk) for zk, wk in histograms) / len(histograms)
            return torch.sum(w[..., None] * rgb, dim=-2), torch.sum(w * z, dim=-1, keepdim=True), losses, None
        n_fine = int(r.get("n_pts_per_ray_fine_" + mode, 64))
        std = float(r.get("density_noise_std_train", 0.0)) if training else 0.0
        outputs = []
        for k in range(len(model.models)):
            if k > 0:
                u = pdf_u[k - 1] if training else linspace01(n_fine, z.device).expand(*z.shape[:-1], n_fine)
                z_new = sample_pdf(0.5 * (z[..., 1:] + z[..., :-1]), outputs[-1][2].detach()[..., 1:-1], u).detach()
                z = torch.sort(torch.cat([z, z_new], dim=-1), dim=-1).values
            raw, rgb = model.nerf(p, k, pts(z), directions)
            w = composite_weights(raw, z, directions, self.bias, noise[k] if std else None, std)
            outputs.append((torch.sum(w[..., None] * rgb, dim=-2), torch.sum(w * z, dim=-1, keepdim=True), w))
        rgb, depth, _ = outputs[-1]
        return rgb, depth, losses, outputs[-2][0] if len(outputs) > 1 else None

    # -- training ---------------------------------------------------------------
    def draws(self, seed: int, step: int, device) -> Dict[str, List[torch.Tensor]]:
        """The step's draws, made again in the order the configuration's training call draws them, from the
        generator of ``(seed << 32) + step``: pixels, depth jitter, then per refinement / pass."""
        gen = torch.Generator(device=device).manual_seed((int(seed) << 32) + int(step))
        s, r = self.sampler, self.r
        n_rays, n_pix, n0 = int(s["n_rays_per_image_sampled_from_mask"]), self.height * self.width, int(
            s["n_pts_per_ray_training"])
        lead = (1, n_rays, 1)
        out: Dict[str, List[torch.Tensor]] = {"pdf_u": [], "density_noise": []}
        if s.get("pixel_replacement", False):
            out["pixels"] = torch.randint(0, n_pix, (1, n_rays), generator=gen, device=device)
        else:  # uniform without replacement: the top n of Gumbel keys
            u = torch.rand((1, n_pix), generator=gen, device=device)
            gumbel = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(torch.float32).tiny)))
            out["pixels"] = torch.topk(gumbel, n_rays, dim=-1).indices
        if s.get("stratified_point_sampling_training", True):
            out["strata_u"] = torch.rand((*lead, n0), generator=gen, device=device)
        noise_std = float(r.get("density_noise_std_train", 0.0))
        if self.proposal:
            n_final = int(r["n_pts_per_ray_final_training"])
            if r.get("stratified_sampling_training", True):
                for n in list(r["n_pts_per_ray_intermediate_training"]) + [n_final]:
                    out["pdf_u"].append(torch.rand((*lead, n), generator=gen, device=device))
            if noise_std > 0.0:
                out["density_noise"].append(torch.randn((*lead, n_final), generator=gen, device=device))
        else:
            n_fine = int(r.get("n_pts_per_ray_fine_training", 64))
            for k in range(len(self.model.models)):
                if k > 0 and r.get("stratified_sampling_coarse_training", True):
                    out["pdf_u"].append(torch.rand((*lead, n_fine), generator=gen, device=device))
                if noise_std > 0.0:
                    pts = n0 + k * n_fine if r.get("append_coarse_samples_to_fine", True) else (n_fine if k else n0)
                    out["density_noise"].append(torch.randn((*lead, pts), generator=gen, device=device))
        return out

    def objective(self, p: Params, pose: torch.Tensor, focal: float, image: torch.Tensor, draws) -> torch.Tensor:
        """The training objective of one image ``(H, W, 3)`` at the step's draws."""
        idx = draws["pixels"][0]
        xy = torch.stack([idx % self.width, idx // self.width], dim=-1).float()[:, None]  # (R, 1, 2)
        origins, directions = rays(pose, focal, xy, self.width, self.height)
        z = self.depths(origins.shape[:-1], int(self.sampler["n_pts_per_ray_training"]), origins.device)
        if "strata_u" in draws:
            z = stratified(z, draws["strata_u"][0])
        strip = lambda ts: [t[0] for t in ts]  # noqa: E731
        rgb, _, losses, prev_rgb = self.render(p, origins, directions, z, True,
                                               {"pdf_u": strip(draws["pdf_u"]),
                                                "density_noise": strip(draws["density_noise"])})
        target = image.reshape(-1, 3)[idx][:, None]
        losses["loss_rgb_mse"] = torch.mean((rgb - target) ** 2)
        if prev_rgb is not None:
            losses["loss_prev_stage_rgb_mse"] = torch.mean((prev_rgb - target) ** 2)
        losses = {k: torch.mean(v) for k, v in losses.items()}
        return sum(losses[k] * float(w) for k, w in self.loss_weights.items() if k in losses and float(w) != 0.0)

    # -- serving ----------------------------------------------------------------
    @torch.no_grad()
    def frame(self, p: Params, pose: torch.Tensor, focal: float, block: int = 8192):
        """The full frame's rgb ``(H, W, 3)`` and depth ``(H, W)``, rendered ``block`` rays at a time."""
        ys, xs = torch.meshgrid(torch.arange(self.height, dtype=torch.float32),
                                torch.arange(self.width, dtype=torch.float32), indexing="ij")
        xy = torch.stack([xs, ys], dim=-1).reshape(-1, 2).to(pose.device)
        n0 = int(self.sampler["n_pts_per_ray_evaluation"])
        rgb, depth = [], []
        for start in range(0, xy.shape[0], block):
            origins, directions = rays(pose, focal, xy[start:start + block][:, None], self.width, self.height)
            z = self.depths(origins.shape[:-1], n0, pose.device)
            c, d, _, _ = self.render(p, origins, directions, z, False, {})
            rgb.append(c[:, 0])
            depth.append(d[:, 0, 0])
        return torch.cat(rgb).reshape(self.height, self.width, 3), torch.cat(depth).reshape(self.height, self.width)


def learning_rate(runner: dict, step: int) -> float:
    """The rate of update ``step`` (from 0): linear warm-up, then exponential decay to ``min_lr``."""
    init, warm, n_warm = float(runner["init_lr"]), float(runner.get("warmup_lr", 0.0)), int(
        runner.get("warmup_steps", 0))
    if runner.get("lr_decay_type", "exponential") != "exponential":
        raise ValueError("the reference follows the exponential schedule only")
    if n_warm > 0 and step <= n_warm:
        return min(init, warm + (init - warm) * step / n_warm)
    return max(float(runner["min_lr"]), init * float(runner["lr_decay_rate"]) ** (step / int(runner["lr_decay_iters"])))


def image_order(seed: int, n_images: int, epoch: int = 0) -> np.ndarray:
    """The order an epoch visits the training images in: a permutation seeded by ``seed + epoch``."""
    return np.random.RandomState(int(seed) + epoch).permutation(n_images)


def train(config: dict, params: Params, poses: torch.Tensor, focal: float, images: torch.Tensor, seed: int,
          steps: int, precision: str = "float32"):
    """``steps`` updates from ``params`` (batch of one image, Adam with coupled decay 0 as configured).

    Returns ``(losses, first_grads, params_after)``: each step's objective, every leaf's gradient of the
    first step, and the leaves after the last step. ``images`` may be uint8 (decoded as ``k / 255``).
    """
    runner = config["runner"]
    if float(runner.get("weight_decay", 0.0) or 0.0) != 0.0 or runner.get("lr_param_groups"):
        raise ValueError("the reference's Adam has no weight decay and one param group")
    renderer = Renderer(config, precision)
    p = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    order = image_order(seed, images.shape[0])
    losses, first = [], None
    for step in range(steps):
        i = int(order[step])
        image = images[i].float() / 255.0 if images.dtype == torch.uint8 else images[i]
        loss = renderer.objective(p, poses[i, :3, :4], focal, image, renderer.draws(seed, step, images.device))
        grads = torch.autograd.grad(loss, list(p.values()))
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: g.detach().clone() for k, g in zip(p, grads)}
        lr, t = learning_rate(runner, step), step + 1
        with torch.no_grad():
            for (k, leaf), g in zip(p.items(), grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v2[k].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                leaf.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
    return losses, first, {k: v.detach() for k, v in p.items()}


def leaf_gap(program: Dict[str, float], reference: Dict[str, float], keep: Sequence[str]) -> float:
    """The worst leaf's gap of norms, ``|program - reference|`` over the larger of the leaf's reference norm and
    the median leaf's."""
    median = float(np.median([reference[k] for k in keep]))
    return max(abs(program[k] - reference[k]) / max(reference[k], median) for k in keep)
