"""The random draws of a train step, and the noisy-view rays of the
consistency losses (counterpart of refnerf_tpu/train/sampling.py).

The random draws and the deterministic maps are separate here. The map,
`sample_noisy_rays`, takes the [a, 3] Euler angles as an argument, so a test
can hand it JAX's draw. The draw, `draw_noise_angles`, is uniform on
[0, max_angle) from a torch.Generator seeded from (Config.seed, step): a run
resumed at any step draws the same angles as the uninterrupted run (H4), and
no generator state has to ride the checkpoint. Its stream differs from JAX's
`fold_in` keys (H3).

`Draws` holds the other random tensors of a step under `Config.randomized`
(JAX's `rng_fwd` and `rng_noisy_fwd`, step.py:159-187): each level's
sampling jitter, its density, specular-density and bottleneck noise, and
its random background, taken in the model's order from one generator
seeded from (Config.seed, step, stream). The main forward and the noisy
forward take different streams. The model asks for them through three
methods, `jitter`, `mlp` (whose `normal` gives the noise) and `background`,
in the order of JAX's key splits (model.py:115-118, :151-154, :207-214;
mlp.py:436-445, :516-520), so a test can hand the model JAX's own draws.
"""

from __future__ import annotations

import numpy as np
import torch

from refnerf_tpu_torch.cameras import rays as rays_lib
from refnerf_tpu_torch.ops import stepfun

# Mixed into the generator's seed so that the noise angles, the main
# forward's draws and the noisy forward's do not share a stream.
_NOISE_STREAM = 1
FWD_STREAM = 2
NOISY_FWD_STREAM = 3


def euler_angles_to_matrix(euler_angles):
  """XYZ-convention Euler angles [..., 3] -> rotation matrices [..., 3, 3]:
  mx @ my @ mz."""
  if euler_angles.dim() == 0 or euler_angles.shape[-1] != 3:
    raise ValueError('Invalid input euler angles.')

  def axis_rot(axis, angle):
    cos, sin = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(angle), torch.zeros_like(angle)
    if axis == 'X':
      flat = (one, zero, zero, zero, cos, -sin, zero, sin, cos)
    elif axis == 'Y':
      flat = (cos, zero, sin, zero, one, zero, -sin, zero, cos)
    else:  # 'Z'
      flat = (cos, -sin, zero, sin, cos, zero, zero, zero, one)
    return torch.stack(flat, -1).reshape(angle.shape + (3, 3))

  mx, my, mz = [axis_rot(c, e)
                for c, e in zip('XYZ', torch.movedim(euler_angles, -1, 0))]
  return mx @ my @ mz


def max_noise_angle(sample_angle_range, warmup_ratio) -> float:
  """The draw's upper bound in radians, in float32 as JAX computes it
  (sampling.py:58-60): range / 180 * pi, rounded to f32, times the ratio."""
  return float(np.float32(sample_angle_range / 180.0 * np.pi) *
               np.float32(warmup_ratio))


def seeded_generator(seed, step, stream, device=None) -> torch.Generator:
  """A generator on `device` seeded on the host from (seed, step, stream)
  alone: no host sync, and no state to checkpoint."""
  device = torch.device('cpu' if device is None else device)
  mixed = np.random.SeedSequence(
      [seed & (2**63 - 1), int(step), stream]).generate_state(
          1, np.uint64)[0]
  gen = torch.Generator(device=device)
  gen.manual_seed(int(mixed))
  return gen


def draw_noise_angles(seed, step, n_angles, max_angle, device=None):
  """[n_angles, 3] angles uniform on [0, max_angle), from a generator on
  `device` seeded from (seed, step) alone."""
  gen = seeded_generator(seed, step, _NOISE_STREAM, device)
  u = torch.rand((n_angles, 3), generator=gen, device=gen.device)
  return u * max_angle


class Draws:
  """The random tensors of one forward, drawn in the model's order from a
  generator seeded from (seed, step, stream) on `device`."""

  def __init__(self, seed, step, stream, device=None):
    self.generator = seeded_generator(seed, step, stream, device)

  def jitter(self, batch_shape, num_samples, single_jitter):
    """A level's sampling offsets (stepfun.draw_jitter)."""
    return stepfun.draw_jitter(self.generator, batch_shape, num_samples,
                               single_jitter)

  def mlp(self):
    """The draws of a level's MLP (its noise): `normal(shape)`."""
    return self

  def normal(self, shape):
    """Standard normal noise of `shape`."""
    return torch.randn(tuple(shape), generator=self.generator,
                       device=self.generator.device)

  def background(self, shape, lo, hi):
    """A level's background colours, uniform on [lo, hi)."""
    u = torch.rand(tuple(shape), generator=self.generator,
                   device=self.generator.device)
    return u * (hi - lo) + lo


@torch.no_grad()
def sample_noisy_rays(rays, rendering, xyz_angles, sample_noise_size=128):
  """Rotate the first `sample_noise_size` rays by each of the [a, 3] Euler
  angles `xyz_angles`.

  Origins are re-derived so each ray's expected surface point (origin +
  distance * direction) is kept under the rotation. Rays are laid out
  sample-major: ray i's `a` rotated copies are contiguous, as JAX lays them
  out (the reference emits angle-major blocks; JAX fixed the grouping). Ray
  bundles may be patch-shaped, [n, ..., 3]. The result carries no graph.

  Returns a Rays bundle of min(sample_noise_size, len(distance)) * a rays.
  """
  n = min(sample_noise_size, rendering['distance'].shape[0])
  a = xyz_angles.shape[0]
  rot = euler_angles_to_matrix(xyz_angles)  # [a, 3, 3]

  distance = rendering['distance'][:n]
  if distance.dim() == rays.origins.dim() - 1:
    distance = distance[..., None]
  elif distance.dim() != rays.origins.dim():
    raise ValueError('The dimension of distance is wrong.')
  distance = torch.repeat_interleave(distance, a, dim=0)

  def tile(x):
    return torch.repeat_interleave(x[:n], a, dim=0)

  def rotate(x):
    # [n, ..., 3] x [a, 3, 3] -> [n, ..., a, 3] -> [n, a, ..., 3].
    rotated = torch.einsum('...j,akj->...ak', x[:n], rot)
    rotated = torch.movedim(rotated, -2, 1)
    return rotated.reshape((n * a,) + tuple(x.shape[1:]))

  directions_ = rotate(rays.directions)
  origins = tile(rays.origins)
  directions = tile(rays.directions)
  return rays_lib.Rays(
      origins=origins + distance * directions - distance * directions_,
      directions=directions_,
      viewdirs=rotate(rays.viewdirs),
      radii=tile(rays.radii),
      imageplane=tile(rays.imageplane),
      lossmult=tile(rays.lossmult),
      near=tile(rays.near),
      far=tile(rays.far),
      cam_idx=tile(rays.cam_idx))
