"""The train step's losses (counterpart of refnerf_tpu/train/losses.py).

The whole suite: the photometric data loss (mse, charb; losses.py:38-99)
with its disparity and normal metrics, the interlevel and distortion losses
(:102-124), the orientation loss (:127-145), the predicted-normal loss
(:148-163), the depth smoothness of patch-shaped renderings (:166-192), the
noisy-view consistency losses (diffuse, specular, normals; :195-311) and
distance consistency (:314-349), and the accumulated-weights and
weights-entropy losses (:352-372). Masked means are weighted sums with a
1e-10 floor on the mask's sum, as JAX writes them. The cross-device sums
(`axis_name`) belong to data parallelism (ROADMAP queue 1, item 8).
"""

from __future__ import annotations

import math

import torch

from refnerf_tpu_torch.ops import image as image_ops
from refnerf_tpu_torch.ops import ref_utils
from refnerf_tpu_torch.ops import stepfun


def _masked_mean(x, mask):
  """mean(x[mask]) as a weighted sum; mask broadcasts against x."""
  mask = torch.broadcast_to(mask, x.shape).to(x.dtype)
  return (x * mask).sum() / torch.maximum(mask.sum(), mask.new_tensor(1e-10))


def compute_data_loss(batch, renderings, rays, config):
  """Photometric loss over all levels and the per-level mse.

  Returns (loss, stats) with stats['mses'] a [levels] tensor; with
  `compute_disp_metrics` / `compute_normal_metrics` and the batch's
  disparities / normals, also stats['disparity_mses'] / ['normal_maes'] (in
  degrees; NaN for a level without normals), which read the renderings'
  extras.
  """
  stats = {}
  gt_rgb = batch.rgb[..., :3]
  lossmult = torch.broadcast_to(rays.lossmult, gt_rgb.shape)
  if config.disable_multiscale_loss:
    lossmult = torch.ones_like(lossmult)
  if config.supervised_by_linear_rgb:
    gt_rgb = image_ops.srgb_to_linear(gt_rgb)

  denom = lossmult.sum()
  data_losses, mses = [], []
  for rendering in renderings:
    resid_sq = (rendering['rgb'] - gt_rgb)**2
    mses.append((lossmult * resid_sq).sum() / denom)
    if config.data_loss_type == 'mse':
      data_loss = resid_sq
    elif config.data_loss_type == 'charb':
      data_loss = torch.sqrt(resid_sq + config.charb_padding**2)
    else:
      raise ValueError(f'Unknown data_loss_type {config.data_loss_type}')
    data_losses.append((lossmult * data_loss).sum() / denom)

    if config.compute_disp_metrics and batch.disps is not None:
      disp = 1 / (1 + rendering['distance_mean'])
      stats.setdefault('disparity_mses', []).append(
          ((disp - batch.disps)**2).mean())

    if config.compute_normal_metrics and batch.normals is not None:
      if rendering.get('normals') is not None:
        normal_mae = ref_utils.compute_weighted_mae(
            rendering['acc'] * batch.alphas,
            ref_utils.l2_normalize(rendering['normals']),
            ref_utils.l2_normalize(batch.normals))
      else:
        normal_mae = torch.tensor(math.nan, device=gt_rgb.device)
      stats.setdefault('normal_maes', []).append(normal_mae)

  data_losses = torch.stack(data_losses)
  loss = (config.data_coarse_loss_mult * data_losses[:-1].sum() +
          config.data_loss_mult * data_losses[-1])
  stats['mses'] = torch.stack(mses)
  for k in ('disparity_mses', 'normal_maes'):
    if k in stats:
      stats[k] = torch.stack(stats[k])
  return loss, stats


def orientation_loss(rays, num_levels, ray_history, config):
  """Back-facing normal penalty, Ref-NeRF Eq 15."""
  total = 0.0
  for i, ray_results in enumerate(ray_history):
    n = ray_results.get(config.orientation_loss_target)
    if n is None:
      raise ValueError(
          f'Normals ({config.orientation_loss_target!r}) cannot be absent '
          'if the orientation loss is on; the model config must enable '
          'that normals source.')
    # viewdirs point camera -> point; negate so v points toward the camera.
    terms = ref_utils.orientation_loss_terms(ray_results['weights'], n,
                                             -rays.viewdirs)
    mult = (config.orientation_coarse_loss_mult if i < num_levels - 1
            else config.orientation_loss_mult)
    total = total + mult * terms.sum(dim=-1).mean()
  return total


def predicted_normal_loss(num_levels, ray_history, config):
  """Agreement of the density normals with the predicted normals."""
  total = 0.0
  for i, ray_results in enumerate(ray_history):
    n = ray_results.get('normals')
    n_pred = ray_results.get('normals_pred')
    if n is None or n_pred is None:
      raise ValueError('Predicted normals and gradient normals cannot be None '
                       'if predicted normal loss is on.')
    w = ray_results['weights']
    loss = (w * (1.0 - (n * n_pred).sum(dim=-1))).sum(dim=-1).mean()
    mult = (config.predicted_normal_coarse_loss_mult if i < num_levels - 1
            else config.predicted_normal_loss_mult)
    total = total + mult * loss
  return total


def interlevel_loss(ray_history, config):
  """Proposal supervision (mip-NeRF 360); no gradient reaches the final
  level's histogram."""
  last = ray_history[-1]
  c, w = last['sdist'].detach(), last['weights'].detach()
  total = 0.0
  for ray_results in ray_history[:-1]:
    total = total + stepfun.lossfun_outer(
        c, w, ray_results['sdist'], ray_results['weights']).mean()
  return config.interlevel_loss_mult * total


def distortion_loss(ray_history, config):
  """mip-NeRF 360's distortion on the final level's histogram."""
  last = ray_history[-1]
  loss = stepfun.lossfun_distortion(last['sdist'], last['weights']).mean()
  return config.distortion_loss_mult * loss


def compute_depth_smoothness_loss(renderings, config):
  """Bilateral, edge-aware depth smoothness over patch-shaped renderings
  [..., ph, pw, c]."""
  losses = []
  bilateral = lambda x: torch.exp(-x.abs().mean(dim=-1, keepdim=True))
  for rendering in renderings:
    depths = rendering['distance']
    acc00 = rendering['acc'][..., :-1, :-1, None].detach()
    weights = rendering['rgb'].detach()
    v00 = depths[..., :-1, :-1, :]
    v01 = depths[..., :-1, 1:, :]
    v10 = depths[..., 1:, :-1, :]
    w01 = bilateral(weights[..., :-1, :-1, :] - weights[..., :-1, 1:, :])
    w10 = bilateral(weights[..., :-1, :-1, :] - weights[..., 1:, :-1, :])
    l1 = (acc00 * w01 * (v00 - v01)**2).abs().mean()
    l2 = (acc00 * w10 * (v00 - v10)**2).abs().mean()
    losses.append((l1 + l2) / 2)
  losses = torch.stack(losses)
  return (config.depth_smoothness_coarse_loss_mult * losses[:-1].sum() +
          config.depth_smoothness_loss_mult * losses[-1])


def _var_unbiased(x, dim):
  """Variance with ddof 1 as JAX writes it: the two-pass biased variance
  times n / (n - 1)."""
  n = x.shape[dim]
  centered = x - x.mean(dim=dim, keepdim=True)
  return (centered * centered).mean(dim=dim, keepdim=True) * (n / max(1, n - 1))


def _consistency_term(kind, ref, noise, what):
  """One level's per-ray consistency error of `ref` [n, 1, ..., c] against
  its rotated renders `noise` [n, a, ..., c], summed over channels."""
  if kind == 'mse':
    err = ((ref - noise)**2).mean(dim=1, keepdim=True)
  elif kind == 'avg_mse':
    err = ((ref - noise.mean(dim=1, keepdim=True))**2).mean(dim=1,
                                                            keepdim=True)
  elif kind == 'var':
    err = _var_unbiased(torch.cat([ref, noise], dim=1), 1).mean(
        dim=-1, keepdim=True)
  else:
    raise ValueError(f'Unknown consistency_{what}_loss_type {kind}')
  return err.sum(dim=-1)


def noisy_consistency_loss(num_levels, renderings, renderings_noise, config,
                           warmup_ratio=1.0):
  """Diffuse, specular and normal consistency across rotated views.

  The specular term is negated: specular colour is meant to vary with the
  view. Returns (diffuse, specular, normals), each summed over levels.
  """
  total_diffuse = total_specular = total_normal = 0.0
  n_angles = config.sample_noise_angles
  # The sampler clamps the noise rays to the batch: group by what was
  # rendered.
  n_samples = renderings_noise[-1]['diffuse'].shape[0] // n_angles
  normals_on = (config.consistency_normal_loss_mult > 0 or
                config.consistency_normal_coarse_loss_mult > 0)
  for i, (rendering, rendering_noise) in enumerate(
      zip(renderings, renderings_noise)):
    reshape_noise = lambda x: x.reshape(n_samples, n_angles, *x.shape[1:])
    mask = (rendering['acc'][:n_samples, None] >
            config.acc_threshold_for_consistency_loss)
    diffuse_loss = _masked_mean(_consistency_term(
        config.consistency_diffuse_loss_type,
        rendering['diffuse'][:n_samples, None],
        reshape_noise(rendering_noise['diffuse']), 'diffuse'), mask)
    specular_loss = -_masked_mean(_consistency_term(
        config.consistency_specular_loss_type,
        rendering['specular'][:n_samples, None],
        reshape_noise(rendering_noise['specular']), 'specular'), mask)

    normal_loss = 0.0
    if normals_on:
      if rendering.get('normals') is None or rendering.get(
          'normals_pred') is None:
        raise ValueError('Predicted normals and gradient normals cannot be '
                         'None if the normal consistency loss is on.')
      target = config.consistency_normal_loss_target
      if target not in ('normals', 'normals_pred'):
        raise ValueError('Given an unknown type of '
                         'consistency_normal_loss_target.')
      n = rendering[target][:n_samples, None]
      n_noise = reshape_noise(rendering_noise[target])
      normal_err = (1.0 - (n * n_noise).sum(dim=-1)).mean(dim=1,
                                                          keepdim=True)
      normal_loss = _masked_mean(normal_err, mask)

    coarse = i < num_levels - 1
    mult = lambda name: getattr(
        config, f'consistency_{name}_coarse_loss_mult' if coarse
        else f'consistency_{name}_loss_mult')
    total_diffuse = total_diffuse + (
        warmup_ratio * mult('diffuse') * diffuse_loss)
    total_specular = total_specular + (
        warmup_ratio * mult('specular') * specular_loss)
    total_normal = total_normal + (
        warmup_ratio * mult('normal') * normal_loss)
  return total_diffuse, total_specular, total_normal


def noisy_distance_consistency_loss(num_levels, rays, noisy_rays, renderings,
                                    renderings_noise, config,
                                    warmup_ratio=1.0):
  """Consistency of the expected surface point across rotated views."""
  if config.consistency_distance_loss_type != 'mse':
    raise ValueError(f'Unknown consistency_distance_loss_type '
                     f'{config.consistency_distance_loss_type}')
  total = 0.0
  n_angles = config.sample_noise_angles
  n_samples = renderings_noise[-1]['distance'].shape[0] // n_angles
  reshape_noise = lambda x: x.reshape(n_samples, n_angles, *x.shape[1:])
  origins = rays.origins[:n_samples, None]
  directions = rays.directions[:n_samples, None]
  origins_ = reshape_noise(noisy_rays.origins)
  directions_ = reshape_noise(noisy_rays.directions)
  for i, (rendering, rendering_noise) in enumerate(
      zip(renderings, renderings_noise)):
    distance = rendering['distance'][:n_samples, None]
    distance_ = reshape_noise(rendering_noise['distance'])
    mask = (rendering['acc'][:n_samples, None] >
            config.acc_threshold_for_consistency_loss)
    distance_mse = ((origins + directions * distance) -
                    (origins_ + directions_ * distance_))**2
    distance_loss = _masked_mean(
        distance_mse.mean(dim=1, keepdim=True).sum(dim=-1), mask)
    mult = (config.consistency_distance_coarse_loss_mult
            if i < num_levels - 1 else config.consistency_distance_loss_mult)
    total = total + warmup_ratio * mult * distance_loss
  return total


def accumulated_weights_loss(renderings, config):
  """(1 - acc)^2 on the final level: pushes rays to full opacity."""
  return config.accumulated_weights_loss_mult * (
      (1 - renderings[-1]['acc'])**2).mean()


def weights_entropy_loss(num_levels, renderings, ray_history, config,
                         warmup_ratio):
  """Shannon entropy of the compositing weights on high-opacity rays."""
  total = 0.0
  for i, (rendering, ray_results) in enumerate(zip(renderings, ray_history)):
    mask = rendering['acc'] > config.acc_threshold_for_weights_entropy_loss
    w = ray_results['weights']
    ent = (-w * torch.log(w + 1e-10)).sum(dim=-1)
    mult = (config.weights_entropy_coarse_loss_mult if i < num_levels - 1
            else config.weights_entropy_loss_mult)
    total = total + warmup_ratio * mult * _masked_mean(ent, mask)
  return total

