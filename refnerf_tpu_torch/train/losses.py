"""The train step's losses (counterpart of refnerf_tpu/train/losses.py).

Ported: the photometric data loss (mse, charb; losses.py:38-99), the
orientation loss (:127-145) and the predicted-normal loss (:148-163). The
rest of the suite is refused by the train step (ROADMAP queue 1, item 13).
"""

from __future__ import annotations

import torch

from refnerf_tpu_torch.ops import image as image_ops
from refnerf_tpu_torch.ops import ref_utils


def compute_data_loss(batch, renderings, rays, config):
  """Photometric loss over all levels and the per-level mse.

  Returns (loss, stats) with stats['mses'] a [levels] tensor.
  """
  if config.compute_disp_metrics or config.compute_normal_metrics:
    raise NotImplementedError(
        'disparity/normal metrics need the extras buffers, not ported '
        '(ROADMAP queue 1, item 3)')
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
  data_losses = torch.stack(data_losses)
  loss = (config.data_coarse_loss_mult * data_losses[:-1].sum() +
          config.data_loss_mult * data_losses[-1])
  return loss, {'mses': torch.stack(mses)}


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
