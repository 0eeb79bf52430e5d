"""The sampling cascade (counterpart of refnerf_tpu/models/model.py:56-268).

Deterministic resampling, no extras buffers. Each level resamples (not
differentiated: sdist is detached, model.py:123-127), casts frustum
Gaussians, runs the MLP and composites. `train=True` asks the MLP for its
training outputs (density-gradient normals).

The fused spatial stage (model.py:131-187): with `NerfMLP.fuse_lift` the
Gaussians come lifted in closed form (`render.cast_rays_lifted`); with
`fuse_compositing` the MLP gets each sample's delta = dt |d| and returns the
compositing weights from its spatial trunk (K6), except under
`opaque_background`, whose infinite last interval the trunk does not model
(logged once; the weights are then composited here).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
from torch import nn

from refnerf_tpu_torch.models import mlp as mlp_lib
from refnerf_tpu_torch.models import render
from refnerf_tpu_torch.models.mlp import MLP
from refnerf_tpu_torch.ops import coord
from refnerf_tpu_torch.ops import stepfun


@dataclasses.dataclass
class ModelConfig:
  """The JAX Model's fields and defaults (model.py:29-49)."""
  num_prop_samples: int = 64
  num_nerf_samples: int = 32
  num_levels: int = 3
  bg_intensity_range: Tuple[float, float] = (1.0, 1.0)
  anneal_slope: float = 10.0
  use_viewdirs: bool = True
  raydist_fn: Optional[Any] = None
  ray_shape: str = 'cone'
  disable_integration: bool = False
  single_jitter: bool = True  # stratified sampling only; not ported
  dilation_bias: float = 0.0025
  dilation_multiplier: float = 0.5
  resample_padding: float = 0.0
  opaque_background: bool = False
  init_s_near: float = 0.0
  init_s_far: float = 1.0
  render_with_specular_density: bool = False
  srgb_mapping_type: str = 'linear'
  srgb_mapping_when_rendering: bool = False
  vis_num_rays: int = 16


class Model(nn.Module):
  """num_levels of proposal resampling feeding a final NeRF level."""

  def __init__(self, nerf_mlp: MLP, prop_mlp: Optional[MLP] = None, **kwargs):
    super().__init__()
    self.cfg = c = ModelConfig(**kwargs)
    if c.num_levels > 1 and (c.dilation_bias > 0 or c.dilation_multiplier > 0):
      raise NotImplementedError(
          'weight dilation between levels (stepfun.max_dilate_weights) is '
          'not ported; bind Model.dilation_bias = Model.dilation_multiplier '
          '= 0')
    if c.srgb_mapping_when_rendering:
      raise NotImplementedError('only the sRGB mapping "none" is ported')
    if c.raydist_fn is not None:
      raise NotImplementedError('only the identity raydist_fn is ported')
    self.nerf_mlp = nerf_mlp
    self.prop_mlp = prop_mlp  # None: one MLP serves every level

  def _level_mlp(self, is_prop):
    if self.prop_mlp is None:
      return self.nerf_mlp
    return self.prop_mlp if is_prop else self.nerf_mlp

  def forward(self, rays, train_frac: float = 1.0, train: bool = False):
    """Render a bundle of rays through the cascade.

    Returns (renderings, ray_history): per level, the rendering dict (rgb,
    diffuse, specular, distance, acc) and the MLP outputs plus sdist and
    weights.
    """
    c = self.cfg
    _, s_to_t = coord.construct_ray_warps(c.raydist_fn, rays.near, rays.far)
    sdist = torch.cat([torch.full_like(rays.near, c.init_s_near),
                       torch.full_like(rays.far, c.init_s_far)], dim=-1)
    weights = torch.ones_like(rays.near)
    if c.anneal_slope > 0:
      # Schlick's bias function (arxiv 2010.09714).
      s = c.anneal_slope
      anneal = (s * train_frac) / ((s - 1) * train_frac + 1)
    else:
      anneal = 1.0
    # Eval composites over the midpoint of the background range.
    bg_rgbs = (c.bg_intensity_range[0] + c.bg_intensity_range[1]) / 2

    renderings, ray_history = [], []
    for i_level in range(c.num_levels):
      is_prop = i_level < c.num_levels - 1
      num_samples = c.num_prop_samples if is_prop else c.num_nerf_samples
      # weights**anneal in log space; zero-width intervals get -inf logits.
      logits = torch.where(
          sdist[..., 1:] > sdist[..., :-1],
          anneal * torch.log(weights + c.resample_padding),
          torch.full_like(weights, -float('inf')))
      # Sampling is not differentiated through (model.py:123-127).
      sdist = stepfun.sample_intervals(
          sdist, logits, num_samples,
          domain=(c.init_s_near, c.init_s_far)).detach()
      tdist = s_to_t(sdist)

      mlp = self._level_mlp(is_prop)
      lifted = None
      if mlp.cfg.fuse_lift and mlp.spatial_fused():
        # The closed-form lift: the [..., s, 3, 3] covariances are never
        # formed (model.py:133-143).
        means, lm, lv = render.cast_rays_lifted(
            tdist, rays.origins, rays.directions, rays.radii, c.ray_shape,
            mlp.pos_basis_t)
        if c.disable_integration:
          lv = torch.zeros_like(lv)
        covs, lifted = None, (lm, lv)
      else:
        means, covs = render.cast_rays(tdist, rays.origins, rays.directions,
                                       rays.radii, c.ray_shape)
        if c.disable_integration:
          covs = torch.zeros_like(covs)
      delta = None
      if mlp.cfg.fuse_compositing:
        if c.opaque_background:
          mlp_lib._warn_fused_fallback(
              'fuse_compositing inactive', 'opaque_background=True needs the '
              'exact infinite final interval; compositing stays outside')
        else:
          delta = (tdist[..., 1:] - tdist[..., :-1]) * torch.linalg.norm(
              rays.directions[..., None, :], dim=-1)
      ray_results = mlp((means, covs), rays.viewdirs if c.use_viewdirs
                        else None, train=train, delta=delta, lifted=lifted)

      weights = ray_results.pop('weights', None)
      if weights is None:
        weights = render.compute_alpha_weights(
            ray_results['density'], tdist, rays.directions,
            opaque_background=c.opaque_background)[0]
      if c.render_with_specular_density:
        if 'specular_density' not in ray_results:
          raise ValueError(
              'Specular density prediction from mlps should be enabled.')
        ray_results['specular_weights'] = render.compute_alpha_weights(
            ray_results['specular_density'], tdist, rays.directions,
            opaque_background=c.opaque_background)[0]

      rgb = ray_results['rgb']
      renderings.append(render.volumetric_rendering(
          rgb, ray_results.get('diffuse', rgb),
          ray_results.get('specular', torch.zeros_like(rgb)),
          weights, tdist, bg_rgbs))
      ray_results['sdist'] = sdist
      ray_results['weights'] = weights
      ray_history.append(ray_results)
    return renderings, ray_history
