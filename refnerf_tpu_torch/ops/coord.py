"""Ray-distance warps, the basis lift and the positional encoding
(counterpart of refnerf_tpu/ops/coord.py).

Every ray-distance warp of JAX's `construct_ray_warps` (coord.py:53-93) is
ported: the identity (None), 'piecewise', and reciprocal, log, exp, sqrt and
square by name or by a callable's `__name__`; so are the scene
contraction of mip-NeRF 360 (`contract`, `inv_contract`, coord.py:19-33)
and `track_linearize` (coord.py:35-56), which pushes a Gaussian through a
warp such as `contract` by its Jacobian.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from refnerf_tpu_torch.ops import mathx

# The clamp of the squared magnitude: it keeps the gradient of `contract`
# and `inv_contract` finite at x = 0 (coord.py:16, :22).
_EPS = float(np.finfo(np.float32).eps)


def contract(x):
  """Contract points toward the origin (Eq 10 of arxiv.org/abs/2111.12077):
  the identity inside the unit ball, (2 - 1/|x|) x/|x| outside it."""
  x_mag_sq = torch.clamp(torch.sum(x**2, dim=-1, keepdim=True), min=_EPS)
  return torch.where(x_mag_sq <= 1, x,
                     ((2 * torch.sqrt(x_mag_sq) - 1) / x_mag_sq) * x)


def inv_contract(z):
  """The inverse of contract()."""
  z_mag_sq = torch.clamp(torch.sum(z**2, dim=-1, keepdim=True), min=_EPS)
  return torch.where(z_mag_sq <= 1, z,
                     z / (2 * torch.sqrt(z_mag_sq) - z_mag_sq))


def track_linearize(fn, mean, cov):
  """Push Gaussians (mean [..., d], cov [..., d, d]) through `fn`, a map of
  R^d applied over the last axis, by linearizing it around the means:
  Covar[A x + y] = A Covar[x] A^T with A = d fn / dx (coord.py:35-56).
  The Jacobian-vector product runs over the covariance's columns, then over
  the rows of the result, as JAX's vmap of `jax.linearize` does. A diagonal
  covariance [..., d] raises. Returns (fn(mean), the covariances)."""
  if mean.dim() + 1 != cov.dim():
    raise ValueError('cov must be non-diagonal')
  fn_mean = fn(mean)
  lin = lambda v: torch.func.jvp(fn, (mean,), (v,))[1]
  cols = torch.func.vmap(lin, in_dims=-1, out_dims=-2)
  return fn_mean, cols(cols(cov))


# The ray-distance curves by name, (forward, inverse) (coord.py:53-59).
_RAYDIST_FNS = {
    'reciprocal': (torch.reciprocal, torch.reciprocal),
    'log': (torch.log, torch.exp),
    'exp': (torch.exp, torch.log),
    'sqrt': (torch.sqrt, torch.square),
    'square': (torch.square, torch.sqrt),
}


def construct_ray_warps(fn, t_near, t_far):
  """Bijection between metric distance t and normalized distance s in [0,1].

  `fn` is None (the identity), 'piecewise' (identity below 1, 1/x above,
  so that t_near may be 0), a name of `_RAYDIST_FNS`, or a callable whose
  `__name__` is one (a gin reference such as `@jnp.reciprocal` arrives as
  its last part). Returns (t_to_s, s_to_t).
  """
  if fn is None:
    t_to_s = lambda t: (t - t_near) / (t_far - t_near)
    s_to_t = lambda s: s * t_far + (1 - s) * t_near
    return t_to_s, s_to_t
  if fn == 'piecewise':
    fn_fwd = lambda x: torch.where(x < 1, 0.5 * x, 1 - 0.5 / x)
    fn_inv = lambda x: torch.where(x < 0.5, 2 * x, 0.5 / (1 - x))
  else:
    name = fn if isinstance(fn, str) else fn.__name__
    if name not in _RAYDIST_FNS:
      raise ValueError(f'Unknown raydist_fn {fn!r}')
    fn_fwd, fn_inv = _RAYDIST_FNS[name]
  s_near, s_far = fn_fwd(t_near), fn_fwd(t_far)
  t_to_s = lambda t: (fn_fwd(t) - s_near) / (s_far - s_near)
  s_to_t = lambda s: fn_inv(s * s_far + (1 - s) * s_near)
  return t_to_s, s_to_t


def integrated_pos_enc(mean, var, min_deg, max_deg):
  """The integrated positional encoding (coord.py:100-120) of coordinate
  means and diagonal variances [..., d]: E[sin] of the 2^k-scaled
  coordinates and of them shifted by pi/2, degree-major, basis-minor, as
  JAX's plain MLP path writes it. The fused trunks' fused_mlp.encode_ipe
  takes cos(m) instead of sin(m + pi/2); the two differ by the f32
  rounding of m + pi/2, up to ~5e-4 at 2^15 (max_deg_point 16), above the
  plain path's f32 parity with JAX, so the plain layer stack uses this
  form (tests/test_torch_port_plainstack.py)."""
  scales = 2.0**torch.arange(min_deg, max_deg, dtype=mean.dtype,
                             device=mean.device)
  shape = (*mean.shape[:-1], -1)
  scaled_mean = (mean[..., None, :] * scales[:, None]).reshape(shape)
  scaled_var = (var[..., None, :] * (scales**2)[:, None]).reshape(shape)
  return torch.exp(-0.5 * torch.cat([scaled_var] * 2, dim=-1)) * mathx.safe_sin(
      torch.cat([scaled_mean, scaled_mean + 0.5 * math.pi], dim=-1))


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
