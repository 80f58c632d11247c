"""NeRF pipeline orchestration: rays -> models -> renderer -> losses.

Counterpart of ``yanerf_tpu/pipelines/nerf_pipeline.py::NeRFPipeline`` in
EVALUATION and TRAINING mode. The pipeline is an ``nn.Module`` holding the implicit
functions, so its state dict keys are the JAX param tree's dotted paths
(``implicit_functions.2.xyz_encoder.mlp.0.w``). The full grid renders in
chunks with the reference's arithmetic, ``n_chunks = ceil(n_rays * P /
chunk_size_grid)``, edge-padded to equal size and mapped over by
``chunk_map``: a loop over the chunk axis eagerly, one
``torch._higher_order_ops.map`` node (its body recorded once) in a traced
program, as ``lax.map`` is in the JAX package. Under a (data x rays) mesh
(``parallel/``) each process renders its slice of the rays of a TRAINING
call and of every chunk, and the slices are gathered where the JAX package
constrains the ray axis. In TRAINING the rays are Monte-Carlo samples,
rendered in one call, and the NeRF-MLP's kernel switch is
``use_pallas_train`` (as ``_bind_model`` does in the JAX package); with
``output_rasterized_mc`` the Monte-Carlo samples are also splatted back
onto the image (``scatter_rays_to_image``) for the training vis.

A TRAINING call takes the JAX package's pixel masks: ``mask_crop`` ``(B,
1, H0, W0)`` (in ``mask_sample`` mode, resized to the sampling grid) and
``sampling_prob_mask`` ``(B, H, W)``, or ``(B, L, H, W)`` with
``n_rays_per_image`` a list of one ray count per layer
(``ray_sampler.py::pixel_weights``). ``training_draws`` lists what one
TRAINING call draws, in the order it draws it (with a mask the raw pixel
draws ``pixel_u`` / ``pixel_gumbel``, from which the sampler picks the
pixels by the mask), and ``make_draws`` makes those draws from a
generator, into given buffers if asked: the train loops make a step's draws ahead and feed
them in through ``draws``. It is the one place that decides a TRAINING
call's draws: the stages below get no generator in TRAINING, so a draw it
does not list raises.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from ..models import MODELS
from ..ops.metrics import sample_grid, view_metrics
from ..ops.sampling import (
    gumbel_from_uniform,
    scatter_rays_to_image,
    uniform_sample_with_replacement,
    weighted_sample_without_replacement,
)
from ..ops.structures import EvaluationMode, RendererOutput, RenderSamplingMode
from ..parallel.sharding import gather_rays, ray_parallel, shard_rays
from ..utils import resolve_device
from .builder import FEATURE_EXTRACTORS, PIPELINES, RAY_SAMPLERS, RENDERERS


class Draw(NamedTuple):
    """One random draw of a TRAINING call: ``draws[key]`` (or its next list entry when ``listed``)."""

    key: str
    shape: Tuple[int, ...]
    kind: str  # "uniform", "normal", "gumbel", "pixels" (randint below ``high``), "pixels_without_replacement"
    listed: bool = False
    high: int = 0
    approx: bool = False


def make_draws(
    specs: Sequence[Draw], generator: torch.Generator, device: torch.device, out: Optional[Dict[str, Any]] = None
) -> Dict[str, Any]:
    """The draws of ``specs``, in their order, from ``generator``: the ``draws`` a TRAINING call takes.

    With ``out`` (a dict of the same structure), each draw is written into
    its tensor there, with the same calls and so the same values.
    """
    draws: Dict[str, Any] = {}
    for spec in specs:
        target = None
        if out is not None:
            target = out[spec.key][len(draws.get(spec.key, []))] if spec.listed else out[spec.key]
        if spec.kind == "uniform":
            value = torch.rand(spec.shape, generator=generator, device=device, out=target)
        elif spec.kind == "normal":
            value = torch.randn(spec.shape, generator=generator, device=device, out=target)
        elif spec.kind == "gumbel":
            value = gumbel_from_uniform(torch.rand(spec.shape, generator=generator, device=device))
        elif spec.kind == "pixels":
            value = uniform_sample_with_replacement(spec.shape[0], spec.high, spec.shape[1], generator, device)
        else:
            weights = torch.ones((spec.shape[0], spec.high), dtype=torch.float32, device=device)
            value = weighted_sample_without_replacement(weights, spec.shape[1], generator, approx=spec.approx)
        if target is not None and value is not target:
            value = target.copy_(value)
        if spec.listed:
            draws.setdefault(spec.key, []).append(value)
        else:
            draws[spec.key] = value
    return draws


def chunk_map(body: Callable[[Dict[str, torch.Tensor]], Any], xs: Dict[str, torch.Tensor]) -> Any:
    """``body`` over the leading axis of every tensor of ``xs``, its outputs stacked on a new leading axis: the
    semantics of ``lax.map`` and of ``torch._higher_order_ops.map``.

    Traced (``torch.export``), the loop is that operator, one node whose
    body the graph records once, whatever the number of chunks. Eager, the
    same body runs once per chunk on the same slices (a frame's kernels
    launch as they are called, and a generator's draws follow one another
    across the chunks as in one loop).
    """
    if torch.compiler.is_compiling():
        from torch._higher_order_ops.map import map as traced_map

        return traced_map(body, xs)
    n = next(iter(xs.values())).shape[0]
    outs = [body({k: x[i] for k, x in xs.items()}) for i in range(n)]
    return torch.utils._pytree.tree_map(lambda *leaves: torch.stack(leaves), *outs)


def _shard_each(draws: Optional[Sequence[torch.Tensor]]) -> Optional[List[torch.Tensor]]:
    """This process's slice of the ray axis of each draw of a list (``parallel.shard_rays``)."""
    return None if draws is None else [shard_rays(t) for t in draws]


def _output_tree(out: RendererOutput) -> Dict[str, Any]:
    """A renderer output as a tree of dicts and tensors (what ``chunk_map`` stacks)."""
    tree = {"features": out.features, "depths": out.depths, "alpha_masks": out.alpha_masks, "aux": dict(out.aux)}
    if out.prev_stage is not None:
        tree["prev_stage"] = _output_tree(out.prev_stage)
    return tree


def _output_from_tree(tree: Dict[str, Any], leaf_fn: Callable[[torch.Tensor], torch.Tensor]) -> RendererOutput:
    """:func:`_output_tree` undone, ``leaf_fn`` applied to every tensor."""
    return RendererOutput(
        features=leaf_fn(tree["features"]), depths=leaf_fn(tree["depths"]), alpha_masks=leaf_fn(tree["alpha_masks"]),
        prev_stage=_output_from_tree(tree["prev_stage"], leaf_fn) if "prev_stage" in tree else None,
        aux={k: leaf_fn(v) for k, v in tree["aux"].items()},
    )


@PIPELINES.register_module()
class NeRFPipeline(nn.Module):
    def __init__(
        self,
        ray_sampler: Dict[str, Any],
        model: Union[Dict[str, Any], Sequence[Dict[str, Any]]],
        feature_extractor: Union[Dict[str, Any], Sequence[Dict[str, Any]], None],
        renderer: Dict[str, Any],
        chunk_size_grid: int,
        num_passes: int,
        loss_weights: Optional[Dict[str, float]] = None,
        output_rasterized_mc: bool = False,
        remat_models: bool = False,
        generator: Optional[torch.Generator] = None,
        device: Union[str, torch.device] = "cuda",
    ) -> None:
        """Build the stages; weights are drawn from ``generator`` and moved to ``device``."""
        super().__init__()
        device = resolve_device(device)
        self.ray_sampler = RAY_SAMPLERS.build(dict(ray_sampler))
        self.render_image_height = self.ray_sampler.image_height
        self.render_image_width = self.ray_sampler.image_width
        self.sampling_mode_training = self.ray_sampler.sampling_mode(EvaluationMode.TRAINING)
        self.sampling_mode_evaluation = self.ray_sampler.sampling_mode(EvaluationMode.EVALUATION)

        if isinstance(model, Sequence) and not isinstance(model, dict):
            model_cfgs = list(model)
            num_passes = len(model_cfgs)
        else:
            model_cfgs = [model] * num_passes
        self.num_passes = num_passes
        self.implicit_functions = nn.ModuleList(MODELS.build(dict(cfg), generator=generator) for cfg in model_cfgs)

        if feature_extractor is None:
            feature_extractor = []
        if isinstance(feature_extractor, dict):
            feature_extractor = [feature_extractor]
        self.feature_extractors = nn.ModuleList(
            FEATURE_EXTRACTORS.build(dict(cfg), generator=generator) for cfg in feature_extractor
        )

        self.renderer = RENDERERS.build(dict(renderer))
        self.chunk_size_grid = chunk_size_grid
        self.output_rasterized_mc = output_rasterized_mc
        if loss_weights is None:
            loss_weights = {"loss_rgb_mse": 1.0, "loss_prev_stage_rgb_mse": 1.0}
        self.loss_weights = dict(loss_weights)
        self.to(device)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(
        self,
        *,
        poses: torch.Tensor,
        focal_lengths: torch.Tensor,
        image_height: Optional[int] = None,
        image_width: Optional[int] = None,
        min_depth=None,
        max_depth=None,
        mask_crop: Optional[torch.Tensor] = None,
        sampling_prob_mask: Optional[torch.Tensor] = None,
        n_rays_per_image: Union[None, int, List[int]] = None,
        bg_image_rgb: Optional[torch.Tensor] = None,
        image_rgb: Optional[torch.Tensor] = None,
        depth_map: Optional[torch.Tensor] = None,
        evaluation_mode: EvaluationMode = EvaluationMode.EVALUATION,
        output_rasterized_mc: Optional[bool] = None,
        generator: Optional[torch.Generator] = None,
        draws: Optional[Dict[str, Any]] = None,
        **kwargs,
    ) -> Dict[str, Any]:
        """Render one batch; returns ``rendered_*`` tensors, per-sample ``loss_*`` and ``objective``.

        ``draws`` holds the random draws of a TRAINING call (``training_draws``):
        ``pixel_idx`` ``(B, n_rays)``, ``strata_u`` ``(B, n_rays, 1, P)``,
        ``pdf_u``, one ``(B, n_rays, 1, n_pts)`` tensor of uniform draws per
        refinement (per proposal pass, or per coarse -> fine step), and
        ``density_noise``, the ``(B, n_rays, 1, P_k)`` standard normal draws
        of the density noise of each compositing pass (the multipass
        renderer's passes; the proposal renderer's main pass). With a mask
        the pixels come from ``pixel_u`` / ``pixel_gumbel`` in place of
        ``pixel_idx`` (``training_draws(masked=True)``). Without ``draws`` a
        TRAINING call makes them from ``generator`` (``make_draws``);
        EVALUATION draws from ``generator`` where it draws.
        """
        training = evaluation_mode == EvaluationMode.TRAINING
        sampling_mode = self.sampling_mode_training if training else self.sampling_mode_evaluation
        mask = mask_crop if (mask_crop is not None and sampling_mode == RenderSamplingMode.MASK_SAMPLE) else None
        sampling_prob_mask = sampling_prob_mask if training else None
        n_rays_per_image = n_rays_per_image if training else None
        masked = mask is not None or sampling_prob_mask is not None
        if training:
            if draws is None:
                if generator is None:
                    raise ValueError("a TRAINING call takes its draws, or a generator to make them from")
                specs = self.training_draws(poses.shape[0], n_rays_per_image=n_rays_per_image, masked=masked)
                draws = make_draws(specs, generator, poses.device)
            if masked and "pixel_idx" in draws:
                raise ValueError("a masked TRAINING call draws its pixels by the mask: its draws carry pixel_u / "
                                 "pixel_gumbel (training_draws(masked=True)), not pixel_idx")
            generator = None  # every draw of a TRAINING call is one of training_draws
        draws = draws or {}
        rasterize_mc = self.output_rasterized_mc if output_rasterized_mc is None else output_rasterized_mc

        ray_bundle = self.ray_sampler(
            poses,
            focal_lengths,
            evaluation_mode,
            image_height=image_height,
            image_width=image_width,
            min_depth=min_depth,
            max_depth=max_depth,
            generator=generator,
            pixel_idx=draws.get("pixel_idx"),
            strata_u=draws.get("strata_u"),
            mask=mask,
            sampling_prob_mask=sampling_prob_mask,
            n_rays_per_image=n_rays_per_image,
            pixel_u=draws.get("pixel_u"),
            pixel_gumbel=draws.get("pixel_gumbel"),
        )
        xys = ray_bundle.xys
        bg_color = sample_grid(bg_image_rgb, xys) if bg_image_rgb is not None else None

        extracted_features = self.extract_features(**kwargs)
        implicit_functions = [self._bind_model(fn, extracted_features, training) for fn in self.implicit_functions]
        if sampling_mode == RenderSamplingMode.FULL_GRID and self.chunk_size_grid > 0:
            rendered = self._render_chunked(*ray_bundle, bg_color, implicit_functions, evaluation_mode, generator)
        else:
            # under a ray split each process renders its slice of the rays; then every process holds them all
            rendered = self.renderer(
                *(shard_rays(t) for t in (*ray_bundle, bg_color)), implicit_functions=implicit_functions,
                evaluation_mode=evaluation_mode, generator=generator, pdf_u=_shard_each(draws.get("pdf_u")),
                density_noise=_shard_each(draws.get("density_noise")),
            )
            rendered = _output_from_tree(_output_tree(rendered), gather_rays)

        preds = self._get_view_metrics(rendered, xys, image_rgb, depth_map)
        # renderer losses (the interlevel loss) reduce per sample like every other loss
        for k, v in rendered.aux.items():
            if k.startswith("loss_"):
                preds[k] = v.reshape(v.shape[0], -1).mean(dim=-1)
        if sampling_mode == RenderSamplingMode.FULL_GRID or rasterize_mc:
            preds["rendered_images"] = rendered.features
            preds["rendered_depths"] = rendered.depths
            preds["rendered_alpha_masks"] = rendered.alpha_masks
        if sampling_mode == RenderSamplingMode.MASK_SAMPLE and rasterize_mc:
            if image_height is None or image_width is None:
                image_height, image_width = self.render_image_height, self.render_image_width
            for key in ("rendered_images", "rendered_depths", "rendered_alpha_masks"):
                preds[key] = scatter_rays_to_image(preds[key], xys, image_height, image_width)

        objective = self._get_objective(preds)
        if objective is not None:
            preds["objective"] = objective
        return preds

    def masked_training(self, batch: Dict[str, Any]) -> bool:
        """Whether a TRAINING call of ``batch`` draws its pixels by a mask (``training_draws(masked=True)``)."""
        return batch.get("sampling_prob_mask") is not None or (
            batch.get("mask_crop") is not None and self.sampling_mode_training == RenderSamplingMode.MASK_SAMPLE
        )

    def training_draws(
        self, batch_size: int, n_rays_per_image: Union[None, int, List[int]] = None, masked: bool = False
    ) -> List[Draw]:
        """What one TRAINING call of ``batch_size`` images draws, in the order it draws it from a generator.

        The ray sampler's pixels and depth jitter, then the renderer's
        (``training_draw_shapes``). Images are the ray sampler's size.
        ``n_rays_per_image`` is the call's ray count (a list: one per layer
        of a multi-layer probability mask). Without a mask the pixels are
        drawn as indices (``pixel_idx``); with one (``masked``) as the raw
        draws the sampler turns into indices by the mask, per layer:
        ``pixel_u`` ``(B, n)`` uniforms (with replacement) or
        ``pixel_gumbel`` ``(B, H * W)`` Gumbel draws (without).
        """
        sampler = self.ray_sampler.sampler(EvaluationMode.TRAINING)
        n_rays = n_rays_per_image if n_rays_per_image is not None else sampler.n_rays_per_image
        if n_rays is None:
            raise NotImplementedError("draws are made ahead for Monte-Carlo (mask_sample) training only")
        counts = [int(n_rays)] if isinstance(n_rays, int) else [int(n) for n in n_rays]
        n_pixels = self.render_image_height * self.render_image_width
        lead = (batch_size, sum(counts), 1)
        replacement = sampler.pixel_replacement
        if masked:
            specs = [Draw("pixel_u", (batch_size, n), "uniform", listed=True) if replacement
                     else Draw("pixel_gumbel", (batch_size, n_pixels), "gumbel", listed=True) for n in counts]
        else:
            if not isinstance(n_rays, int):
                raise ValueError(f"n_rays_per_image={n_rays!r} is a list, which requires a (B, L, H, W) multi-layer "
                                 "sampling_prob_mask (one ray budget per probability layer)")
            specs = [Draw("pixel_idx", (batch_size, counts[0]), "pixels" if replacement
                          else "pixels_without_replacement", high=n_pixels, approx=sampler.approx_top_k)]
        if sampler.stratified_sampling:
            specs.append(Draw("strata_u", (*lead, sampler.n_pts_per_ray), "uniform"))
        for key, n in self.renderer.training_draw_shapes(sampler.n_pts_per_ray, len(self.implicit_functions)):
            specs.append(Draw(key, (*lead, n), "normal" if key == "density_noise" else "uniform", listed=True))
        return specs

    def extract_features(self, **kwargs) -> Dict[str, Any]:
        """The feature extractors' outputs for the batch's extra keyword arguments (``scene_id``).

        The tensor outputs of several extractors are stacked on dim 1
        (``global_codes`` ``(B, n_extractors, latent_dim)``); a non-tensor
        output must come from one extractor only. Without extractors the
        extra arguments are ignored.
        """
        extracted: Dict[str, Any] = {}
        for fe in self.feature_extractors:
            for k, v in fe(**kwargs).items():
                extracted.setdefault(k, []).append(v)
        for k, v_list in extracted.items():
            if isinstance(v_list[0], torch.Tensor):
                extracted[k] = torch.stack(v_list, dim=1)
            else:
                if len(v_list) != 1:
                    raise KeyError(f"{k} has multiple non-tensor values.")
                extracted[k] = v_list[0]
        return extracted

    @staticmethod
    def _bind_model(fn: nn.Module, extracted_features: Dict[str, Any], training: bool) -> Callable[..., Dict[str, Any]]:
        # in TRAINING the fused kernels (forward K1, backward K3) run only
        # when the model opted in with use_pallas_train
        extra = {"use_pallas": bool(getattr(fn, "use_pallas_train", False))} if training else {}

        def bound(origins, directions, lengths, **kw):
            return fn(origins, directions, lengths, **{**kw, **extracted_features, **extra})

        return bound

    def _render_chunked(
        self,
        origins: torch.Tensor,
        directions: torch.Tensor,
        lengths: torch.Tensor,
        xys: torch.Tensor,
        bg_color: Optional[torch.Tensor],
        implicit_functions: List[Callable[..., Dict[str, Any]]],
        evaluation_mode: EvaluationMode,
        generator: Optional[torch.Generator],
    ) -> RendererOutput:
        """Render a full grid chunk by chunk (``chunk_map``), the last chunk edge-padded and sliced away.

        The chunks are the leading axis of the mapped inputs, as the JAX
        package's ``lax.map`` takes them. A traced frame draws nothing: it
        refuses a generator.
        """
        batch_size = origins.shape[0]
        spatial = origins.shape[1:-1]
        n_pts = lengths.shape[-1]
        n_rays = math.prod(spatial)
        n_chunks = -(-n_rays * max(n_pts, 1) // self.chunk_size_grid)
        chunk_rays = -(-n_rays // n_chunks)
        chunk_rays = -(-chunk_rays // ray_parallel()) * ray_parallel()  # a ray split takes equal slices
        n_padded = n_chunks * chunk_rays

        def to_chunks(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
            if t is None:
                return None
            t = t.reshape(batch_size, n_rays, 1, t.shape[-1])
            # padded even by 0 rays: a traced frame has the same nodes at every chunk count
            t = torch.cat([t, t[:, -1:].expand(batch_size, n_padded - n_rays, 1, t.shape[-1])], dim=1)
            return t.reshape(batch_size, n_chunks, chunk_rays, 1, t.shape[-1]).movedim(1, 0)

        xs = {k: to_chunks(t) for k, t in (("origins", origins), ("directions", directions), ("lengths", lengths),
                                           ("xys", xys), ("bg_color", bg_color)) if t is not None}
        if generator is not None and torch.compiler.is_compiling():
            raise ValueError("a traced frame draws nothing: render it without a generator")

        def render_one(chunk: Dict[str, torch.Tensor]) -> Dict[str, Any]:
            # under a ray split each process renders its slice of the chunk, and the slices are gathered
            chunk = {k: shard_rays(v) for k, v in chunk.items()}
            out = self.renderer(
                chunk["origins"], chunk["directions"], chunk["lengths"], chunk["xys"], chunk.get("bg_color"),
                implicit_functions=implicit_functions,
                evaluation_mode=evaluation_mode,
                generator=generator,
            )
            return torch.utils._pytree.tree_map(gather_rays, _output_tree(out))

        def collate(leaf: torch.Tensor) -> torch.Tensor:
            # (n_chunks, B, chunk_rays, 1, *rest) -> (B, *spatial, *rest)
            rest = leaf.shape[4:]
            leaf = leaf.movedim(0, 1).reshape(batch_size, n_padded, *rest)
            return leaf[:, :n_rays].reshape(batch_size, *spatial, *rest)

        return _output_from_tree(chunk_map(render_one, xs), collate)

    def _get_view_metrics(
        self,
        raymarched: RendererOutput,
        xys: torch.Tensor,
        image_rgb: Optional[torch.Tensor] = None,
        depth_map: Optional[torch.Tensor] = None,
        keys_prefix: str = "loss_",
    ) -> Dict[str, Any]:
        metrics = view_metrics(
            image_sampling_grid=xys,
            images_pred=raymarched.features,
            images=image_rgb,
            depths_pred=raymarched.depths,
            depths=depth_map,
            keys_prefix=keys_prefix,
        )
        prev, prefix = raymarched.prev_stage, keys_prefix
        while prev is not None:
            prefix = prefix + "prev_stage_"
            metrics.update(
                view_metrics(
                    image_sampling_grid=xys,
                    images_pred=prev.features,
                    images=image_rgb,
                    depths_pred=prev.depths,
                    depths=depth_map,
                    keys_prefix=prefix,
                )
            )
            prev = prev.prev_stage
        return metrics

    def _get_objective(self, preds: Dict[str, Any]) -> Optional[torch.Tensor]:
        losses_weighted = [preds[k] * float(w) for k, w in self.loss_weights.items() if k in preds and w != 0.0]
        if not losses_weighted:
            return None
        loss = losses_weighted[0]
        for extra in losses_weighted[1:]:
            loss = loss + extra
        return loss
