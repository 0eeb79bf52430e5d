"""Ray bundles and batches as dataclasses of tensors (counterpart of
cameras/rays.py:38-74)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch


@dataclasses.dataclass
class Rays:
  """A bundle of rays; every field shares the leading (ray) dims."""
  origins: torch.Tensor
  directions: torch.Tensor
  viewdirs: torch.Tensor
  radii: torch.Tensor
  imageplane: torch.Tensor
  lossmult: torch.Tensor
  near: torch.Tensor
  far: torch.Tensor
  cam_idx: torch.Tensor

  @property
  def shape(self):
    return self.origins.shape[:-1]

  def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> 'Rays':
    """A new bundle with `fn` applied to every field."""
    return Rays(**{f.name: fn(getattr(self, f.name))
                   for f in dataclasses.fields(self)})

  def reshape(self, *dims) -> 'Rays':
    """Reshape the leading dims of every field, keeping its trailing dim."""
    return self.map(lambda x: x.reshape(*dims, x.shape[-1]))

  def __getitem__(self, s) -> 'Rays':
    return self.map(lambda x: x[s])


@dataclasses.dataclass
class Batch:
  """A training or evaluation batch: rays and their pixels' values."""
  rays: Rays
  rgb: Optional[torch.Tensor] = None      # [..., 3] (or 4) ground truth


def dummy_rays(n: int = 1, device=None) -> Rays:
  """A tiny bundle of n rays (zeros; far = 1)."""
  data = lambda d: torch.zeros((n, d), dtype=torch.float32, device=device)
  return Rays(
      origins=data(3), directions=data(3), viewdirs=data(3), radii=data(1),
      imageplane=data(2), lossmult=data(1), near=data(1),
      far=data(1) + 1.0,
      cam_idx=torch.zeros((n, 1), dtype=torch.int32, device=device))


def pad_rays_to(rays: Rays, n: int) -> tuple[Rays, int]:
  """Pad a flat bundle along axis 0 to exactly n rays.

  Padded rays repeat the last ray, so they stay numerically well-behaved.
  Returns (padded_rays, padding).
  """
  count = rays.origins.shape[0]
  padding = n - count
  if padding < 0:
    raise ValueError(f'Cannot pad {count} rays down to {n}')
  if padding == 0:
    return rays, 0
  return rays.map(lambda x: torch.cat(
      [x, x[-1:].expand(padding, *x.shape[1:])], dim=0)), padding
