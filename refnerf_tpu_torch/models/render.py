"""Volume rendering: frustum Gaussians, transmittance, compositing.

Counterpart of refnerf_tpu/models/render.py:39-147, :150-171 and :201-228 for
serving: full covariances (`diag=False`) or their closed-form lift
(`cast_rays_lifted`), no extras buffers and the 'none' sRGB mapping.

Every clamp on a differentiated path is `torch.maximum` against a tensor
constant, so a tie splits its gradient 0.5/0.5 as JAX's `jnp.maximum` does.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = float(np.finfo(np.float32).eps)


def _at_least(lo, x):
  """max(lo, x) with JAX's tie subgradient (jnp.maximum)."""
  return torch.maximum(x.new_tensor(lo), x)


def lift_gaussian(d, t_mean, t_var, r_var):
  """Lift a per-ray 1D Gaussian to 3D along direction d (full covariance)."""
  mean = d[..., None, :] * t_mean[..., None]
  d_mag_sq = _at_least(1e-10, torch.sum(d**2, dim=-1, keepdim=True))
  d_outer = d[..., :, None] * d[..., None, :]
  eye = torch.eye(d.shape[-1], dtype=d.dtype, device=d.device)
  null_outer = eye - d[..., :, None] * (d / d_mag_sq)[..., None, :]
  t_cov = t_var[..., None, None] * d_outer[..., None, :, :]
  xy_cov = r_var[..., None, None] * null_outer[..., None, :, :]
  return mean, t_cov + xy_cov


def _cone_moments(t0, t1):
  """(t_mean, t_var, r_var per unit base radius squared) of a conical
  frustum, in the numerically stable form in its midpoint and half-width
  (mip-NeRF Eq 7)."""
  mu = (t0 + t1) / 2
  hw = (t1 - t0) / 2
  denom = _at_least(_EPS, 3 * mu**2 + hw**2)
  t_mean = mu + (2 * mu * hw**2) / denom
  t_var = (hw**2) / 3 - (4 / 15) * hw**4 * (12 * mu**2 - hw**2) / denom**2
  r_var = (mu**2) / 4 + (5 / 12) * hw**2 - (4 / 15) * (hw**4) / denom
  return t_mean, t_var, r_var


def conical_frustum_to_gaussian(d, t0, t1, base_radius):
  """Moment-match a conical frustum with a Gaussian (mip-NeRF Eq 7)."""
  t_mean, t_var, r_var = _cone_moments(t0, t1)
  return lift_gaussian(d, t_mean, t_var, r_var * base_radius**2)


def cylinder_to_gaussian(d, t0, t1, radius):
  """Moment-match a cylinder segment with a Gaussian."""
  t_mean = (t0 + t1) / 2
  r_var = radius**2 / 4
  t_var = (t1 - t0)**2 / 12
  return lift_gaussian(d, t_mean, t_var, r_var)


def cast_rays(tdist, origins, directions, radii, ray_shape):
  """Fencepost distances along each ray -> sample Gaussians (means, covs)."""
  t0 = tdist[..., :-1]
  t1 = tdist[..., 1:]
  if ray_shape == 'cone':
    gaussian_fn = conical_frustum_to_gaussian
  elif ray_shape == 'cylinder':
    gaussian_fn = cylinder_to_gaussian
  else:
    raise ValueError("ray_shape must be 'cone' or 'cylinder'")
  means, covs = gaussian_fn(directions, t0, t1, radii)
  return means + origins[..., None, :], covs


def cast_rays_lifted(tdist, origins, directions, radii, ray_shape, basis):
  """Sample Gaussians already lifted onto `basis` [3, nb]: (means [..., s, 3],
  lifted means [..., s, nb], lifted variances [..., s, nb]) (JAX
  render.py:95-147, the `fuse_lift` producer).

  Equal to `coord.lift_and_diagonalize(*cast_rays(...), basis)` in closed
  form: with cov = t_var d d^T + r_var (I - d d^T / |d|^2), the lifted
  variance of basis vector p is t_var (d.p)^2 + r_var (|p|^2 - (d.p)^2 /
  |d|^2). Only per-ray dot products and per-sample 1D moments are formed;
  the [..., s, 3, 3] covariances never are.
  """
  t0 = tdist[..., :-1]
  t1 = tdist[..., 1:]
  if ray_shape == 'cone':
    t_mean, t_var, r_var = _cone_moments(t0, t1)
  elif ray_shape == 'cylinder':
    t_mean = (t0 + t1) / 2
    t_var = (t1 - t0)**2 / 12
    r_var = torch.full_like(t_mean, 0.25)
  else:
    raise ValueError("ray_shape must be 'cone' or 'cylinder'")
  r_var = r_var * radii**2
  dp = torch.matmul(directions, basis)  # [..., nb] direction . p_j
  op = torch.matmul(origins, basis)     # [..., nb] origin . p_j
  pp = torch.sum(basis * basis, dim=0)  # [nb] |p_j|^2
  d_mag_sq = _at_least(1e-10, torch.sum(directions**2, dim=-1, keepdim=True))
  dp2 = dp**2
  null_p = pp - dp2 / d_mag_sq
  lm = op[..., None, :] + t_mean[..., None] * dp[..., None, :]
  lv = (t_var[..., None] * dp2[..., None, :]
        + r_var[..., None] * null_p[..., None, :])
  means = origins[..., None, :] + directions[..., None, :] * t_mean[..., None]
  return means, lm, lv


def compute_alpha_weights(density, tdist, dirs, opaque_background=False):
  """Compositing weights alpha * transmittance; returns (weights, alpha, trans)."""
  t_delta = tdist[..., 1:] - tdist[..., :-1]
  delta = t_delta * torch.linalg.norm(dirs[..., None, :], dim=-1)
  density_delta = density * delta
  if opaque_background:
    # The final interval is infinitely wide.
    density_delta = torch.cat([
        density_delta[..., :-1],
        torch.full_like(density_delta[..., -1:], float('inf'))], dim=-1)
  alpha = 1 - torch.exp(-density_delta)
  trans = torch.exp(-torch.cat([
      torch.zeros_like(density_delta[..., :1]),
      torch.cumsum(density_delta[..., :-1], dim=-1)], dim=-1))
  return alpha * trans, alpha, trans


def volumetric_rendering(rgbs, diffuse_rgbs, specular_rgbs, weights, tdist,
                         bg_rgbs):
  """Composite per-sample colors into per-ray rgb, diffuse, specular,
  distance and acc (no extras; sRGB mapping 'none')."""
  acc = weights.sum(dim=-1)
  bg_w = _at_least(0.0, 1 - acc[..., None])
  composite = lambda c: (weights[..., None] * c).sum(dim=-2) + bg_w * bg_rgbs
  t_mids = 0.5 * (tdist[..., :-1] + tdist[..., 1:])
  return {
      'rgb': composite(rgbs),
      'diffuse': composite(diffuse_rgbs),
      'specular': composite(specular_rgbs),
      'distance': (weights[..., None] * t_mids[..., None]).sum(dim=-2),
      'acc': acc,
  }
