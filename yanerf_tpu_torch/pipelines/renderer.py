"""The proposal-sampler renderer and the inverse-CDF ray refiner.

Counterpart of ``yanerf_tpu/pipelines/renderer.py``'s
``refine_ray_points`` and ``ProposalEmissionAbsorpsionRenderer``:
``implicit_functions = [proposal_0, ..., proposal_{k-1}, main]``; each
proposal's emission-absorption weights importance-sample the next pass's
depths, only the main model composites colors, and the interlevel and
distortion losses land in ``aux``. The resampled depths are detached where
the JAX package has ``stop_gradient``; the u's of each pass's ``sample_pdf``
are an optional input (``pdf_u``), else drawn from ``generator``. The
multipass (coarse -> fine) renderer, density noise and the eval-compositing
dtype experiment are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

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
        **kwargs,
    ) -> RendererOutput:
        """``pdf_u``: one ``(..., n_pts)`` tensor of uniform draws per proposal pass, in place of the generator's."""
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
