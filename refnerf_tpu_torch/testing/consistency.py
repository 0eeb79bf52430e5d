"""Holding the consistency loss terms of two implementations of one train
step against each other.

The diffuse, specular, distance and normals consistency terms are means of
nearly cancelling quantities (a variance across five nearly equal renders,
squared distances between nearly equal points, 1 - cos of nearly parallel
normals), so a relative tolerance on them says nothing. Each is held to a
bound from the arithmetic of its own cancellation (`bound`), given the
largest difference between the two implementations' renders of the same
rays (`render_gap`, of the renders `step_renders` gives). Used by
tests/test_torch_port_losses.py against JAX and by chip_smoke.py's kernels
against fused_trunk='off'.
"""

from __future__ import annotations

import numpy as np
import torch

from refnerf_tpu_torch.train import sampling

# The loss terms that are means of nearly cancelling quantities.
TERMS = ('diffuse_consistency', 'specular_consistency',
         'distance_consistency', 'normals_consistency')
# The rendered quantities those terms read.
GAP_KEYS = ('diffuse', 'specular', 'normals', 'normals_pred', 'distance')


def step_renders(model, rays, config, step, angles, noisy_rays=None):
  """What the consistency terms read of the train step at `step`: both
  levels of the main forward of `rays`, then both of the noisy forward of
  the rays rotated by `angles` (or of `noisy_rays` when given), each a dict
  of the GAP_KEYS as detached float tensors; and the noisy rays."""
  train_frac = float(np.clip((step - 1) / (config.max_steps - 1), 0, 1))
  main, _ = model(rays, train_frac=train_frac, train=True,
                  compute_extras=True)
  if noisy_rays is None:
    noisy_rays = sampling.sample_noisy_rays(
        rays, main[-1], angles,
        config.sample_noise_size // config.patch_size**2)
  noisy, _ = model(noisy_rays, train_frac=train_frac, train=True,
                   compute_extras=True)
  return [{k: r[k].detach().float() for k in GAP_KEYS}
          for r in main + noisy], noisy_rays


def render_gap(renders, reference, noisy_rays):
  """`bound`'s `gap`: the largest |difference| of each GAP_KEYS quantity
  between two lists of renders (tensors or arrays) of the same rays, and
  the longest of the rotated directions `noisy_rays.directions`."""
  as_np = lambda x: (x.detach().cpu().numpy() if torch.is_tensor(x)
                     else np.asarray(x, np.float32))
  gap = {k: max(float(np.abs(as_np(a[k]) - as_np(b[k])).max())
                for a, b in zip(renders, reference, strict=True))
         for k in GAP_KEYS}
  gap['max_dir'] = noisy_rays.directions.norm(dim=-1).max().item()
  return gap


def bound(name, term, config, ratio, gap):
  """How far the consistency term `name` (value `term`, at warmup ratio
  `ratio`) can move when every render it reads moves by at most `gap[k]`
  (k: one of GAP_KEYS); `gap['max_dir']` bounds |d'| of the rotated
  directions.

  The term is r * sum_l m_l V_l over levels, each V_l a masked mean of
  per-ray errors v >= 0, over c = 3 channels where it reads colours. A
  variance of 5 renders each moved by <= e moves by <= 1.25 (2 sd e + e^2)
  (1.25 = 5/4, the unbiased factor), and the channels' mean of it by no
  more. A square (x - y)^2 with x and y each moved by <= d moves by
  <= 2 |x - y| 2d + (2d)^2: summed over the channels (mse, avg_mse), by
  <= 4d sqrt(c v) + c (2d)^2 with d = e; for distance consistency x - y =
  |d'| (t - t'), so d = max_dir e. 1 - n.n' moves by <= 2 sqrt(3) e (1 + e)
  + 3 e^2. By Jensen and Cauchy-Schwarz, sum_l m_l sqrt(V_l) <= m sqrt(T /
  (r m)), m = sum_l m_l. At ratio 0 the term is exactly 0 and so is the
  bound.
  """
  if ratio == 0:
    return 0.0
  prefix = {'normals_consistency': 'normal'}.get(name, name.split('_')[0])
  m = (getattr(config, f'consistency_{prefix}_loss_mult') +
       getattr(config, f'consistency_{prefix}_coarse_loss_mult'))
  if m == 0:
    return 0.0
  v = abs(float(term)) / (ratio * m)
  if name == 'distance_consistency':
    d = 2 * gap['max_dir'] * gap['distance']
    dv = 2 * np.sqrt(v) * d + d * d
  elif name == 'normals_consistency':
    e = gap[config.consistency_normal_loss_target]
    dv = 2 * np.sqrt(3) * e * (1 + e) + 3 * e * e
  else:
    e = gap[prefix]
    if getattr(config, f'consistency_{prefix}_loss_type') == 'var':
      dv = 1.25 * (2 * np.sqrt(v) * e + e * e)
    else:  # mse, avg_mse: summed over the 3 channels
      dv = 2 * np.sqrt(3 * v) * 2 * e + 3 * (2 * e)**2
  return float(ratio * m * dv)
