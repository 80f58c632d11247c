"""The multipass (coarse -> fine) and proposal-sampler renderers, and the inverse-CDF ray refiner.

Counterpart of ``yanerf_tpu/pipelines/renderer.py``:
  * ``MultipassEmissionAbsorpsionRenderer``: every pass composites its own
    model's colors, its weights importance-sample the next pass's depths
    (merged with its own and sorted when ``append_coarse_samples_to_fine``),
    and each output keeps the previous pass's as ``prev_stage``;
  * ``ProposalEmissionAbsorpsionRenderer``: ``implicit_functions =
    [proposal_0, ..., proposal_{k-1}, main]``; each proposal's weights
    importance-sample the next pass's depths, only the main model
    composites colors, and the interlevel and distortion losses land in
    ``aux``.
The resampled depths are detached where the JAX package has
``stop_gradient``. The random draws are optional inputs, else drawn from
``generator``: ``pdf_u``, the u's of each refinement's ``sample_pdf``, and
``density_noise``, the training density noise of each compositing pass.
The eval-compositing dtype experiment is not ported.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..ops.proposal import distortion_loss, interlevel_loss
from ..ops.raymarch import emission_absorption, emission_absorption_weights
from ..ops.sample_pdf import sample_pdf
from ..ops.structures import EvaluationMode, RayBundle, RendererOutput
from .builder import RENDERERS


def refine_ray_points(
    origins: torch.Tensor,
    directions: torch.Tensor,
    lengths: torch.Tensor,
    xys: torch.Tensor,
    ray_weights: torch.Tensor,
    *,
    n_pts_per_ray: int,
    random_sampling: bool,
    add_input_samples: bool = True,
    stratified_u: bool = False,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> RayBundle:
    """Importance-sample new depths from previous-pass weights (detached); ``u`` replaces the draws."""
    z_vals = lengths
    z_vals_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    z_samples = sample_pdf(
        z_vals_mid,
        ray_weights[..., 1:-1],
        n_pts_per_ray,
        generator=generator,
        det=not random_sampling,
        stratified=stratified_u,
        u=u,
    ).detach()

    if add_input_samples:
        z_vals = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1).values
    elif random_sampling and not stratified_u:
        z_vals = torch.sort(z_samples, dim=-1).values
    else:
        z_vals = z_samples  # monotone by construction (det or stratified u)
    return RayBundle(origins=origins, directions=directions, lengths=z_vals, xys=xys)


@RENDERERS.register_module()
class MultipassEmissionAbsorpsionRenderer:
    """Coarse -> fine rendering (NeRF's hierarchical sampling) over ``implicit_functions``, one per pass."""

    def __init__(
        self,
        n_pts_per_ray_fine_training: int = 64,
        n_pts_per_ray_fine_evaluation: int = 64,
        stratified_sampling_coarse_training: bool = True,
        stratified_sampling_coarse_evaluation: bool = False,
        append_coarse_samples_to_fine: bool = True,
        bg_color: Sequence[float] = (0.0,),
        density_noise_std_train: float = 0.0,
        capping_function: str = "exponential",
        weight_function: str = "product",
        background_opacity: float = 1e10,
        blend_output: bool = False,
        background_density_bias: float = 0.0,
        hard_background: bool = False,
        density_relu: bool = True,
        density_activation: Optional[str] = None,
        density_pre_activation_bias: float = 0.0,
        surface_thickness: int = 1,
        eval_compositing_dtype: str = None,
    ) -> None:
        if eval_compositing_dtype is not None:
            raise NotImplementedError("eval_compositing_dtype is not ported yet")
        self.density_noise_std_train = density_noise_std_train
        self.append_coarse_samples_to_fine = append_coarse_samples_to_fine
        self._refiner_cfg = {
            EvaluationMode.TRAINING: (n_pts_per_ray_fine_training, stratified_sampling_coarse_training),
            EvaluationMode.EVALUATION: (n_pts_per_ray_fine_evaluation, stratified_sampling_coarse_evaluation),
        }
        self.raymarcher_kwargs = dict(
            default_bg_color=tuple(bg_color),
            capping_function=capping_function,
            weight_function=weight_function,
            background_opacity=background_opacity,
            density_relu=density_relu,
            density_activation=density_activation,
            density_pre_activation_bias=density_pre_activation_bias,
            blend_output=blend_output,
            background_density_bias=background_density_bias,
            hard_background=hard_background,
            surface_thickness=surface_thickness,
        )

    def training_draw_shapes(self, n_pts: int, n_passes: int) -> List[Tuple[str, int]]:
        """``(key, points)`` of each TRAINING draw per ray, in draw order: per pass, the refinement's u's
        (from the second pass on) and then the pass's density noise."""
        n_fine, random_sampling = self._refiner_cfg[EvaluationMode.TRAINING]
        shapes = []
        for k in range(n_passes):
            if k > 0 and random_sampling:
                shapes.append(("pdf_u", n_fine))
            if self.density_noise_std_train > 0.0:
                pts = n_pts + k * n_fine if self.append_coarse_samples_to_fine else (n_fine if k else n_pts)
                shapes.append(("density_noise", pts))
        return shapes

    def __call__(
        self,
        origins: torch.Tensor,
        directions: torch.Tensor,
        lengths: torch.Tensor,
        xys: torch.Tensor,
        bg_color: Optional[torch.Tensor],
        *,
        implicit_functions: List[Callable[..., Dict[str, Any]]],
        evaluation_mode: EvaluationMode = EvaluationMode.EVALUATION,
        generator: Optional[torch.Generator] = None,
        pdf_u: Optional[Sequence[torch.Tensor]] = None,
        density_noise: Optional[Sequence[torch.Tensor]] = None,
        **kwargs,
    ) -> RendererOutput:
        """The last pass's output, the earlier ones chained by ``prev_stage``.

        ``pdf_u``: one ``(..., n_pts_fine)`` tensor of uniform draws per
        refinement; ``density_noise``: one ``(..., P_k)`` tensor of standard
        normal draws per pass (TRAINING only), in place of the generator's.
        """
        if not implicit_functions:
            raise ValueError("The multipass renderer expects at least one implicit function")
        density_noise_std = self.density_noise_std_train if evaluation_mode == EvaluationMode.TRAINING else 0.0
        n_pts_fine, random_sampling = self._refiner_cfg[evaluation_mode]
        output = None
        for k, implicit_function in enumerate(implicit_functions):
            if k > 0:
                lengths = refine_ray_points(
                    origins,
                    directions,
                    lengths,
                    xys,
                    output.aux["weights"],
                    n_pts_per_ray=n_pts_fine,
                    random_sampling=random_sampling,
                    add_input_samples=self.append_coarse_samples_to_fine,
                    generator=generator,
                    u=None if pdf_u is None else pdf_u[k - 1],
                ).lengths
            model_out = implicit_function(origins, directions, lengths, **kwargs)
            features, depths, alpha_masks, weights = emission_absorption(
                model_out["rays_densities"],
                model_out["rays_features"],
                ray_lengths=lengths,
                ray_directions=directions,
                density_noise_std=density_noise_std,
                generator=generator,
                noise=None if density_noise is None else density_noise[k],
                bg_color=bg_color,
                **self.raymarcher_kwargs,
            )
            aux = dict(model_out.get("aux", {}))
            aux["weights"] = weights
            output = RendererOutput(
                features=features, depths=depths, alpha_masks=alpha_masks, aux=aux, prev_stage=output
            )
        return output


@RENDERERS.register_module()
class ProposalEmissionAbsorpsionRenderer:
    """Proposal-sampler renderer (mip-NeRF 360 / NerfAcc proposal estimator)."""

    def __init__(
        self,
        n_pts_per_ray_final_training: int = 32,
        n_pts_per_ray_final_evaluation: int = 32,
        n_pts_per_ray_intermediate_training: Sequence[int] = (),
        n_pts_per_ray_intermediate_evaluation: Sequence[int] = (),
        stratified_sampling_training: bool = True,
        stratified_sampling_evaluation: bool = False,
        bg_color: Sequence[float] = (0.0,),
        density_noise_std_train: float = 0.0,
        capping_function: str = "exponential",
        weight_function: str = "product",
        background_opacity: float = 1e10,
        blend_output: bool = False,
        background_density_bias: float = 0.0,
        hard_background: bool = False,
        density_relu: bool = True,
        density_activation: Optional[str] = None,
        density_pre_activation_bias: float = 0.0,
        surface_thickness: int = 1,
        interlevel_loss_eps: float = 1e-7,
        distortion_in_disparity: bool = False,
        eval_compositing_dtype: str = None,
    ) -> None:
        if eval_compositing_dtype is not None:
            raise NotImplementedError("eval_compositing_dtype is not ported yet")
        self.density_noise_std_train = density_noise_std_train
        self.distortion_in_disparity = distortion_in_disparity
        self._final_cfg = {
            EvaluationMode.TRAINING: (n_pts_per_ray_final_training, stratified_sampling_training),
            EvaluationMode.EVALUATION: (n_pts_per_ray_final_evaluation, stratified_sampling_evaluation),
        }
        self._intermediate_cfg = {
            EvaluationMode.TRAINING: tuple(n_pts_per_ray_intermediate_training),
            EvaluationMode.EVALUATION: tuple(n_pts_per_ray_intermediate_evaluation),
        }
        self.interlevel_loss_eps = interlevel_loss_eps
        self.weights_kwargs = dict(
            capping_function=capping_function,
            weight_function=weight_function,
            background_opacity=background_opacity,
            density_relu=density_relu,
            density_activation=density_activation,
            density_pre_activation_bias=density_pre_activation_bias,
            background_density_bias=background_density_bias,
            surface_thickness=surface_thickness,
        )
        self.raymarcher_kwargs = dict(
            default_bg_color=tuple(bg_color),
            blend_output=blend_output,
            hard_background=hard_background,
            **self.weights_kwargs,
        )

    def training_draw_shapes(self, n_pts: int, n_passes: int) -> List[Tuple[str, int]]:
        """``(key, points)`` of each TRAINING draw per ray, in draw order: each proposal pass's u's (when
        sampling at random), then the main pass's density noise."""
        n_final, random_sampling = self._final_cfg[EvaluationMode.TRAINING]
        schedule = list(self._intermediate_cfg[EvaluationMode.TRAINING]) + [n_final]
        shapes = [("pdf_u", n) for n in schedule] if random_sampling else []
        if self.density_noise_std_train > 0.0:
            shapes.append(("density_noise", n_final))
        return shapes

    def __call__(
        self,
        origins: torch.Tensor,
        directions: torch.Tensor,
        lengths: torch.Tensor,
        xys: torch.Tensor,
        bg_color: Optional[torch.Tensor],
        *,
        implicit_functions: List[Callable[..., Dict[str, Any]]],
        evaluation_mode: EvaluationMode = EvaluationMode.EVALUATION,
        generator: Optional[torch.Generator] = None,
        pdf_u: Optional[Sequence[torch.Tensor]] = None,
        density_noise: Optional[Sequence[torch.Tensor]] = None,
        **kwargs,
    ) -> RendererOutput:
        """``pdf_u``: one ``(..., n_pts)`` tensor of uniform draws per proposal pass; ``density_noise``: one
        ``(..., n_final)`` tensor of standard normal draws for the main pass (TRAINING); in place of the generator's.
        """
        if len(implicit_functions) < 2:
            raise ValueError(
                "The proposal renderer expects [proposal..., main] — at least two implicit functions"
            )
        n_props = len(implicit_functions) - 1
        n_final, random_sampling = self._final_cfg[evaluation_mode]
        intermediate = self._intermediate_cfg[evaluation_mode]
        if len(intermediate) != n_props - 1:
            raise ValueError(
                f"{n_props} proposal passes need {n_props - 1} intermediate point counts, "
                f"got {len(intermediate)} (the first pass uses the ray sampler's depths)"
            )
        pts_schedule = list(intermediate) + [n_final]
        s_near, s_far = lengths[..., :1], lengths[..., -1:]

        histograms = []
        for k in range(n_props):
            prop_out = implicit_functions[k](origins, directions, lengths, **kwargs)
            prop_weights, _ = emission_absorption_weights(
                prop_out["rays_densities"], lengths, directions, **self.weights_kwargs
            )
            prop_weights = prop_weights.to(torch.float32)
            histograms.append((lengths, prop_weights))
            bundle = refine_ray_points(
                origins,
                directions,
                lengths,
                xys,
                prop_weights,
                n_pts_per_ray=pts_schedule[k],
                random_sampling=random_sampling,
                add_input_samples=False,
                stratified_u=True,
                generator=generator,
                u=None if pdf_u is None else pdf_u[k],
            )
            lengths = bundle.lengths

        density_noise_std = self.density_noise_std_train if evaluation_mode == EvaluationMode.TRAINING else 0.0
        model_out = implicit_functions[-1](origins, directions, lengths, **kwargs)
        features, depths, alpha_masks, weights = emission_absorption(
            model_out["rays_densities"],
            model_out["rays_features"],
            ray_lengths=lengths,
            ray_directions=directions,
            density_noise_std=density_noise_std,
            generator=generator,
            noise=None if density_noise is None else density_noise[0],
            bg_color=bg_color,
            **self.raymarcher_kwargs,
        )

        loss = None
        for prop_lengths, prop_weights in histograms:
            term = interlevel_loss(lengths, weights, prop_lengths, prop_weights, eps=self.interlevel_loss_eps)
            loss = term if loss is None else loss + term
        loss = loss / float(n_props)

        aux = dict(model_out.get("aux", {}))
        aux["weights"] = weights
        aux["loss_proposal"] = loss
        aux["loss_distortion"] = distortion_loss(
            lengths, weights, in_disparity=self.distortion_in_disparity, near=s_near, far=s_far
        )
        return RendererOutput(features=features, depths=depths, alpha_masks=alpha_masks, aux=aux, prev_stage=None)
