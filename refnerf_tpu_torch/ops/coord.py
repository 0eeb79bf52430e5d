"""Ray-distance warps and the basis lift (counterpart of refnerf_tpu/ops/coord.py).

Only the identity warp (`raydist_fn=None`, coord.py:67-93) is ported.
"""

from __future__ import annotations

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
