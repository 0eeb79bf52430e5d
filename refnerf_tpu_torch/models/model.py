"""The sampling cascade (counterpart of refnerf_tpu/models/model.py:56-268).

Each level dilates the last level's weights (`stepfun.max_dilate_weights`,
model.py:86-103), resamples (not differentiated: sdist is detached,
model.py:123-127) through the ray-distance warp, casts frustum Gaussians,
runs its MLP (the PropMLP at the proposal levels, unless `single_mlp`) and
composites. `train=True` asks the MLP for its training outputs
(density-gradient normals, noise); `compute_extras=True` adds the eval
buffers (render.volumetric_rendering's extras) and each level's ray
bundles. `draws` (train/sampling.py `Draws`, or a test's) gives the random
tensors of a training forward: each level's jitter (stratified sampling),
the MLP's noise and a random background from `bg_intensity_range`; without
it the cascade is deterministic, as JAX's with `rng=None` and as eval runs
it.

The fused spatial stage (model.py:131-187): with `NerfMLP.fuse_lift` the
Gaussians come lifted in closed form (`render.cast_rays_lifted`); with
`fuse_compositing` the MLP gets each sample's delta = dt |d| and returns the
compositing weights from its spatial trunk (K6), except under
`opaque_background`, whose infinite last interval the trunk does not model
(logged once; the weights are then composited here).

`remat=True` (Model.remat; JAX wraps the MLP in nn.remat, construct.py:44)
runs each level's MLP under torch.utils.checkpoint (non-reentrant) when
gradients are taken: its activations are not kept but recomputed in the
backward, which reruns the same operations on the same inputs (the trunk
kernels' forwards launch twice a level a step). The autograd graph is the
one without remat, so the step is the same bit for bit. The MLP's noise is
drawn once and given again to each recompute (`_Replayed`). On the plain
layer stack (F4) the density gradient's inner autograd.grad unpacks the
checkpointed activations during the forward already, which recomputes the
MLP once more there (ROADMAP H22).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
import torch.utils.checkpoint
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
  single_jitter: bool = True  # one jitter a ray when stratified
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


class _Replayed:
  """A level's MLP draws, taken from `draws` on the first call and given
  again, in order, on every recompute under remat."""

  def __init__(self, draws):
    self._draws, self._taken, self._next = draws, [], 0

  def rewind(self):
    self._next = 0
    return self

  def normal(self, shape):
    if self._next == len(self._taken):
      self._taken.append(self._draws.normal(shape))
    out = self._taken[self._next]
    self._next += 1
    return out


class Model(nn.Module):
  """num_levels of proposal resampling feeding a final NeRF level."""

  def __init__(self, nerf_mlp: MLP, prop_mlp: Optional[MLP] = None,
               remat: bool = False, **kwargs):
    super().__init__()
    self.cfg = ModelConfig(**kwargs)
    self.nerf_mlp = nerf_mlp
    self.prop_mlp = prop_mlp  # None: one MLP serves every level
    self.remat = remat

  def _run_mlp(self, mlp, gaussians, viewdirs, train, delta, lifted, draws):
    """mlp(...), under torch.utils.checkpoint with `remat` when a graph is
    being built."""
    if not (self.remat and torch.is_grad_enabled()):
      return mlp(gaussians, viewdirs, train=train, delta=delta, lifted=lifted,
                 draws=draws)
    replayed = None if draws is None else _Replayed(draws)

    def run(means, covs, viewdirs, delta, lifted):
      return mlp((means, covs), viewdirs, train=train, delta=delta,
                 lifted=lifted,
                 draws=None if replayed is None else replayed.rewind())
    return torch.utils.checkpoint.checkpoint(
        run, *gaussians, viewdirs, delta, lifted, use_reentrant=False)

  def _level_mlp(self, is_prop):
    if self.prop_mlp is None:
      return self.nerf_mlp
    return self.prop_mlp if is_prop else self.nerf_mlp

  def forward(self, rays, train_frac: float = 1.0, train: bool = False,
              compute_extras: bool = False, draws=None):
    """Render a bundle of rays through the cascade; `draws` as the module
    says (None: deterministic).

    Returns (renderings, ray_history): per level, the rendering dict (rgb,
    diffuse, specular, distance, acc; with `compute_extras` also the
    composited normals, roughness and tint, the distance mean and
    percentiles, and the first `vis_num_rays` rays' 'ray_sdist',
    'ray_weights' and 'ray_rgbs') and the MLP outputs plus sdist and
    weights.
    """
    c = self.cfg
    _, s_to_t = coord.construct_ray_warps(c.raydist_fn, rays.near, rays.far)
    sdist = torch.cat([torch.full_like(rays.near, c.init_s_near),
                       torch.full_like(rays.far, c.init_s_far)], dim=-1)
    weights = torch.ones_like(rays.near)
    prod_num_samples = 1
    use_dilation = c.dilation_bias > 0 or c.dilation_multiplier > 0
    if c.anneal_slope > 0:
      # Schlick's bias function (arxiv 2010.09714).
      s = c.anneal_slope
      anneal = (s * train_frac) / ((s - 1) * train_frac + 1)
    else:
      anneal = 1.0
    lo, hi = c.bg_intensity_range
    domain = (c.init_s_near, c.init_s_far)

    renderings, ray_history = [], []
    for i_level in range(c.num_levels):
      is_prop = i_level < c.num_levels - 1
      num_samples = c.num_prop_samples if is_prop else c.num_nerf_samples
      # A multiple of the expected interval span plus a bias.
      dilation = c.dilation_bias + c.dilation_multiplier * (
          c.init_s_far - c.init_s_near) / prod_num_samples
      prod_num_samples *= num_samples
      if i_level > 0 and use_dilation:
        # Only the resampling reads the dilated weights: not differentiated.
        sdist, weights = stepfun.max_dilate_weights(
            sdist, weights.detach(), dilation, domain=domain,
            renormalize=True)
        sdist, weights = sdist[..., 1:-1], weights[..., 1:-1]
      # weights**anneal in log space; zero-width intervals get -inf logits.
      logits = torch.where(
          sdist[..., 1:] > sdist[..., :-1],
          anneal * torch.log(weights + c.resample_padding),
          torch.full_like(weights, -float('inf')))
      jitter = None
      if draws is not None:
        jitter = draws.jitter(sdist.shape[:-1], num_samples, c.single_jitter)
      # Sampling is not differentiated through (model.py:123-127).
      sdist = stepfun.sample_intervals(
          sdist, logits, num_samples, domain=domain, jitter=jitter).detach()
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
      ray_results = self._run_mlp(
          mlp, (means, covs), rays.viewdirs if c.use_viewdirs else None,
          train, delta, lifted, None if draws is None else draws.mlp())

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

      # The background (model.py:200-214): random in training with draws
      # (multinerf's regularizer against faking opacity with it), else the
      # midpoint of its range. One colour a ray, as multinerf draws it: JAX
      # draws (weights.shape[0], 3), the same for a flat batch, which a
      # patch-shaped one [n, p, p] broadcasts to [n, p, n, 3] (ROADMAP F9).
      if lo == hi:
        bg_rgbs = lo
      elif train and draws is not None:
        bg_rgbs = draws.background(weights.shape[:-1] + (3,), lo, hi)
      else:
        bg_rgbs = (lo + hi) / 2

      rgb = ray_results['rgb']
      rendering = render.volumetric_rendering(
          rgb, ray_results.get('diffuse', rgb),
          ray_results.get('specular', torch.zeros_like(rgb)),
          weights, tdist, bg_rgbs, rays.far, compute_extras,
          extras={k: v for k, v in ray_results.items()
                  if k.startswith('normals') or k in ('roughness', 'tint')},
          srgb_mapping=(c.srgb_mapping_type if c.srgb_mapping_when_rendering
                        else 'none'))
      if compute_extras:
        # Bags of rays for visualization ('ray_' buffers are ray bundles,
        # not image chunks, downstream).
        n = c.vis_num_rays
        rendering['ray_sdist'] = sdist.reshape(-1, sdist.shape[-1])[:n]
        rendering['ray_weights'] = weights.reshape(
            -1, weights.shape[-1])[:n]
        rendering['ray_rgbs'] = rgb.reshape(-1, *rgb.shape[-2:])[:n]
      renderings.append(rendering)
      ray_results['sdist'] = sdist
      ray_results['weights'] = weights
      ray_history.append(ray_results)

    if compute_extras:
      # Proposal levels have meaningless colors; show the final level's
      # average color in their bundles.
      last = renderings[-1]
      final_rgb = torch.sum(last['ray_rgbs'] * last['ray_weights'][..., None],
                            dim=-2)
      for r in renderings[:-1]:
        r['ray_rgbs'] = torch.broadcast_to(final_rgb[:, None, :],
                                           r['ray_rgbs'].shape)
    return renderings, ray_history
