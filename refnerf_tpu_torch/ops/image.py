"""Image-space ops (counterpart of refnerf_tpu/ops/image.py:37-43)."""

from __future__ import annotations

import numpy as np
import torch

_EPS = float(np.finfo(np.float32).eps)


def linear_to_srgb(linear, eps=_EPS):
  """sRGB OETF; assumes linear in [0, 1]."""
  srgb0 = 323 / 25 * linear
  srgb1 = (211 * torch.clamp(linear, min=eps)**(5 / 12) - 11) / 200
  return torch.where(linear <= 0.0031308, srgb0, srgb1)
