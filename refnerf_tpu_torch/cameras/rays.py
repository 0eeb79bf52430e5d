"""Ray bundles, pixel batches and batches as dataclasses of tensors
(counterpart of cameras/rays.py:19-87)."""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Optional, Union

import torch


@dataclasses.dataclass
class Pixels:
  """Pixel coordinates and per-ray metadata, before ray casting: the train
  split ships these and the train step casts them on the device
  (`Config.cast_rays_in_train_step`)."""
  pix_x_int: torch.Tensor
  pix_y_int: torch.Tensor
  lossmult: torch.Tensor
  near: torch.Tensor
  far: torch.Tensor
  cam_idx: torch.Tensor

  @property
  def shape(self):
    return self.pix_x_int.shape

  def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> 'Pixels':
    """A new batch of pixels with `fn` applied to every field."""
    return Pixels(**{f.name: fn(getattr(self, f.name))
                     for f in dataclasses.fields(self)})


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
  """A training or evaluation batch: rays (or pixels) and their pixels'
  values."""
  rays: Union[Rays, Pixels]
  rgb: Optional[torch.Tensor] = None      # [..., 3] (or 4) ground truth
  disps: Optional[torch.Tensor] = None
  normals: Optional[torch.Tensor] = None
  alphas: Optional[torch.Tensor] = None

  def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> 'Batch':
    """A new batch with `fn` applied to every tensor, the rays' included."""
    return Batch(self.rays.map(fn), **{
        f.name: None if getattr(self, f.name) is None
        else fn(getattr(self, f.name))
        for f in dataclasses.fields(self) if f.name != 'rays'})


class DataSplit(enum.Enum):
  TRAIN = 'train'
  VAL = 'val'
  TEST = 'test'


class BatchingMethod(enum.Enum):
  ALL_IMAGES = 'all_images'
  SINGLE_IMAGE = 'single_image'


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
