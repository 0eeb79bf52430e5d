"""Image-space ops (counterpart of refnerf_tpu/ops/image.py:19-52).

Clamps are written `torch.maximum` against a tensor constant: at a tie that
splits the gradient 0.5/0.5, as JAX's `jnp.maximum` does, where
`torch.clamp` would pass all of it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_EPS = float(np.finfo(np.float32).eps)


def linear_to_srgb(linear, eps=_EPS):
  """sRGB OETF; assumes linear in [0, 1]."""
  srgb0 = 323 / 25 * linear
  srgb1 = (211 * torch.maximum(linear.new_tensor(eps), linear)**(5 / 12)
           - 11) / 200
  return torch.where(linear <= 0.0031308, srgb0, srgb1)


def srgb_to_linear(srgb, eps=_EPS):
  """Inverse of linear_to_srgb."""
  linear0 = 25 / 323 * srgb
  linear1 = torch.maximum(srgb.new_tensor(eps),
                          (200 * srgb + 11) / 211)**(12 / 5)
  return torch.where(srgb <= 0.04045, linear0, linear1)


def mse_to_psnr(mse):
  """PSNR in dB of a mean squared error (signal range 1)."""
  return -10.0 / math.log(10.0) * torch.log(mse)


def clip01(x):
  """x clipped to [0, 1] with JAX's subgradient 0.5 at either bound."""
  return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))
