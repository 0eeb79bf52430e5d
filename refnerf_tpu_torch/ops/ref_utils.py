"""Reflections and the integrated directional encoding (IDE).

Counterpart of refnerf_tpu/ops/ref_utils.py:23-164. The spherical-harmonic
constants are recomputed here in numpy (that module imports jax); the IDE is
the same real re/im recurrence. `ide_tables` lays the constants out for the
fused IDE of ops/fused_mlp.py.
"""

from __future__ import annotations

import functools
import math
import warnings

import numpy as np
import torch

_EPS = float(np.finfo(np.float32).eps)


def reflect(viewdirs, normals):
  """Reflect view directions about unit normals: u = 2 (n.v) n - v."""
  return 2.0 * torch.sum(
      normals * viewdirs, dim=-1, keepdim=True) * normals - viewdirs


def l2_normalize(x, eps=_EPS):
  """Normalize x to unit length along the last axis."""
  sq = torch.sum(x**2, dim=-1, keepdim=True)
  return x / torch.sqrt(torch.maximum(sq.new_tensor(eps), sq))


def orientation_loss_terms(w, n, v):
  """Per-sample back-facing penalty w * min(0, n.v)^2 (Ref-NeRF Eq 15);
  v [..., 3] points from the surface toward the camera."""
  n_dot_v = (n * v[..., None, :]).sum(dim=-1)
  return w * torch.minimum(n_dot_v.new_zeros(()), n_dot_v)**2


def generalized_binomial_coeff(a, k):
  """Generalized binomial coefficient (a choose k) for real a."""
  return np.prod(a - np.arange(k)) / math.factorial(k)


def assoc_legendre_coeff(l, m, k):
  """Coefficient of cos^k sin^m in the associated Legendre polynomial P_l^m."""
  return ((-1)**m * 2**l * math.factorial(l) / math.factorial(k) /
          math.factorial(l - k - m) *
          generalized_binomial_coeff(0.5 * (l + k + m - 1.0), l))


def sph_harm_coeff(l, m, k):
  """Spherical harmonic normalization * associated Legendre coefficient."""
  return (np.sqrt(
      (2.0 * l + 1.0) * math.factorial(l - m) /
      (4.0 * np.pi * math.factorial(l + m))) * assoc_legendre_coeff(l, m, k))


def get_ml_array(deg_view):
  """All (m, l) pairs of the encoding: l in {1, 2, 4, ...}, m in [0, l]."""
  ml_list = []
  for i in range(deg_view):
    l = 2**i
    for m in range(l + 1):
      ml_list.append((m, l))
  return np.array(ml_list).T


@functools.lru_cache(maxsize=None)
def ide_constants(deg_view):
  """(ml_array int32, coefficient matrix [l_max+1, P] f32, vMF sigmas [P])."""
  ml_array = get_ml_array(deg_view)
  l_max = 2**(deg_view - 1)
  mat = np.zeros((l_max + 1, ml_array.shape[1]), dtype=np.float64)
  for i, (m, l) in enumerate(ml_array.T):
    for k in range(l - m + 1):
      mat[k, i] = sph_harm_coeff(l, m, k)
  sigma = 0.5 * ml_array[1, :] * (ml_array[1, :] + 1)
  return (ml_array.astype(np.int32), mat.astype(np.float32),
          sigma.astype(np.float32))


@functools.lru_cache(maxsize=None)
def ide_tables(deg_view):
  """(mat [l_max+1, P], sigma_row [1, P], gather [l_max+1, P]) f32: the
  tables of the fused IDE (fused_mlp.py:1161-1175). `gather` is the {0, 1}
  matrix that picks power m_i of (x + iy) for harmonic i."""
  ml_array, mat, sigma = ide_constants(deg_view)
  gather = np.zeros_like(mat)
  gather[ml_array[0], np.arange(ml_array.shape[1])] = 1.0
  return mat, sigma.reshape(1, -1), gather


def generate_ide_fn(deg_view):
  """Integrated directional encoding (Ref-NeRF Eqs 6-8).

  Returns a function (xyz [..., 3], kappa_inv [..., 1]) -> [..., 2P], the
  real parts of the P harmonics followed by their imaginary parts.
  """
  if deg_view > 5:
    warnings.warn('Only deg_view of at most 5 is numerically stable.')
  ml_array, mat_np, sigma_np = ide_constants(deg_view)
  l_max = 2**(deg_view - 1)
  m_values = [int(m) for m in ml_array[0, :]]

  def integrated_dir_enc_fn(xyz, kappa_inv):
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    vmz = [torch.ones_like(z)]
    for _ in range(l_max):
      vmz.append(vmz[-1] * z)
    vmz = torch.stack(vmz, dim=-1)

    re_pows, im_pows = [torch.ones_like(x)], [torch.zeros_like(x)]
    for _ in range(max(m_values)):
      re_prev, im_prev = re_pows[-1], im_pows[-1]
      re_pows.append(re_prev * x - im_prev * y)
      im_pows.append(re_prev * y + im_prev * x)
    re_vmxy = torch.stack([re_pows[m] for m in m_values], dim=-1)
    im_vmxy = torch.stack([im_pows[m] for m in m_values], dim=-1)

    mat = torch.as_tensor(mat_np, device=xyz.device)
    z_part = torch.matmul(vmz, mat)
    sigma = torch.as_tensor(sigma_np, device=xyz.device)
    atten = torch.exp(-sigma * kappa_inv)
    return torch.cat([re_vmxy * z_part * atten, im_vmxy * z_part * atten],
                     dim=-1)

  return integrated_dir_enc_fn
