"""Ray-distance warps, the basis lift and the positional encoding
(counterpart of refnerf_tpu/ops/coord.py).

Only the identity warp (`raydist_fn=None`, coord.py:67-93) is ported.
"""

from __future__ import annotations

import math

import torch


def construct_ray_warps(fn, t_near, t_far):
  """Bijection between metric distance t and normalized distance s in [0,1].

  Returns (t_to_s, s_to_t).
  """
  if fn is not None:
    raise NotImplementedError(
        f'raydist_fn {fn!r}: only the identity warp (None) is ported')
  t_to_s = lambda t: (t - t_near) / (t_far - t_near)
  s_to_t = lambda s: s * t_far + (1 - s) * t_near
  return t_to_s, s_to_t


def lift_and_diagonalize(mean, cov, basis):
  """Project mean/cov onto `basis` [d, n]; keep the covariance diagonal."""
  fn_mean = torch.matmul(mean, basis)
  fn_cov_diag = torch.sum(basis * torch.matmul(cov, basis), dim=-2)
  return fn_mean, fn_cov_diag


def pos_enc(x, min_deg, max_deg, append_identity=True):
  """The NeRF positional encoding (coord.py:134-143): sin of the scaled
  coordinates and of them shifted by pi/2 (the cosines, written as JAX
  writes them so that they round alike), degree-major, basis-minor, after
  x itself with `append_identity`."""
  scales = 2.0**torch.arange(min_deg, max_deg, dtype=x.dtype, device=x.device)
  scaled = (x[..., None, :] * scales[:, None]).reshape(*x.shape[:-1], -1)
  four_feat = torch.sin(torch.cat([scaled, scaled + 0.5 * math.pi], dim=-1))
  if append_identity:
    return torch.cat([x, four_feat], dim=-1)
  return four_feat
