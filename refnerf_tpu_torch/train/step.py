"""The train step: forward, losses, backward, clipping and Adam.

Counterpart of refnerf_tpu/train/step.py. `make_train_step(model, config,
raycast_fn)` returns `train_step(state, batch, cameras=None) -> (state,
stats)`, driven as bench.py drives the JAX step. A batch of `Pixels` (the
train split under `Config.cast_rays_in_train_step`) is cast to rays inside
the step by `raycast_fn(cameras, pixels)`, with the cameras on the card
(`datasets.BaseDataset.device_cameras`); a batch of `Rays` is used as it
is. The JAX state is immutable; here the parameters (the model's) and the
optimizer moments are updated in place and the same state object comes back
with its step advanced.

The optimizer is optax's chain written out (step.py:40-51): clip by value,
then clip by global norm as optax does it (scale by max_norm / norm, and
only when norm >= max_norm; not torch's clip_grad_norm_, which scales by
max_norm / (norm + 1e-6) whenever norm > max_norm), then Adam with eps
outside the square root, bias correction at count + 1, and the learning rate
of the log-lerp schedule at the update count (0 at the first update).

Every loss of JAX's step is ported (data, interlevel, distortion,
orientation, predicted normals, depth smoothness, the noisy-view consistency
losses, acc and weights entropy), with the noisy second forward: the first
`sample_noise_size // patch_size**2` rays, rotated by the angles of
`noise_angles(step, a, max_angle) -> [a, 3]`, go through the model again in
the same differentiated step. By default the angles come from a generator
seeded from (Config.seed, step) (`sampling.draw_noise_angles`), so a resumed
run draws what the uninterrupted run drew; a test can hand the step JAX's
draws. Under `Config.randomized` each forward also takes its random
tensors (stratified jitter, density and bottleneck noise, backgrounds) from
`sampling.Draws` seeded from (Config.seed, step) and its own stream, the
main forward's and the noisy forward's apart, as JAX's `rng_fwd` and
`rng_noisy_fwd` (step.py:159-187); the streams differ from JAX's (H3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from refnerf_tpu_torch.cameras import rays as rays_lib
from refnerf_tpu_torch.ops import image as image_ops
from refnerf_tpu_torch.ops import mathx
from refnerf_tpu_torch.train import losses as losses_lib
from refnerf_tpu_torch.train import sampling


@dataclasses.dataclass
class AdamState:
  count: int                          # updates so far (optax's count)
  mu: Dict[str, torch.Tensor]         # first moments, by parameter name
  nu: Dict[str, torch.Tensor]         # second moments


@dataclasses.dataclass
class TrainState:
  step: int
  model: torch.nn.Module
  opt: AdamState

  def params(self) -> Dict[str, torch.Tensor]:
    return dict(self.model.named_parameters())


def create_lr_schedule(config):
  """step -> learning rate, log-lerp decay with warmup (step.py:31-37)."""
  def schedule(step):
    return mathx.learning_rate_decay(
        torch.tensor(float(step), dtype=torch.float32), config.lr_init,
        config.lr_final, config.max_steps, config.lr_delay_steps,
        config.lr_delay_mult)
  return schedule


def create_train_state(config, model) -> TrainState:
  params = dict(model.named_parameters())
  zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
  return TrainState(step=0, model=model,
                    opt=AdamState(count=0, mu=zeros(), nu=zeros()))


def global_norm(tensors) -> torch.Tensor:
  """sqrt of the sum of squares over every element (optax.global_norm)."""
  return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float):
  """optax.clip_by_global_norm: t / norm * max_norm unless norm < max_norm."""
  g_norm = global_norm(grads.values())
  if bool(g_norm < max_norm):
    return grads
  return {k: (t / g_norm) * max_norm for k, t in grads.items()}


def apply_gradients(state: TrainState, grads: Dict[str, torch.Tensor],
                    config) -> None:
  """One optimizer update of the chain of step.py:40-51, in place."""
  if config.grad_max_val > 0:
    v = config.grad_max_val
    grads = {k: torch.clip(g, -v, v) for k, g in grads.items()}
  if config.grad_max_norm > 0:
    grads = clip_by_global_norm(grads, config.grad_max_norm)
  opt = state.opt
  b1, b2, eps = config.adam_beta1, config.adam_beta2, config.adam_eps
  count = opt.count + 1
  # The step's scalars, computed in f32 on the host and passed as Python
  # floats (exact f32 values): no host-to-device copy per parameter.
  f32 = lambda v: torch.tensor(v, dtype=torch.float32)
  neg_lr = -float(create_lr_schedule(config)(opt.count))
  bc1, bc2 = float(1 - f32(b1)**count), float(1 - f32(b2)**count)
  with torch.no_grad():
    for name, p in state.model.named_parameters():
      g = grads[name]
      mu = opt.mu[name] = (1 - b1) * g + b1 * opt.mu[name]
      nu = opt.nu[name] = (1 - b2) * g**2 + b2 * opt.nu[name]
      update = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
      p.add_(neg_lr * update)
  opt.count = count


def _consistency_enabled(config) -> bool:
  return config.sample_noise_size > 0 and (
      config.consistency_diffuse_coarse_loss_mult > 0 or
      config.consistency_specular_coarse_loss_mult > 0 or
      config.consistency_normal_coarse_loss_mult > 0 or
      config.consistency_diffuse_loss_mult > 0 or
      config.consistency_specular_loss_mult > 0 or
      config.consistency_normal_loss_mult > 0)


def _distance_consistency_enabled(config) -> bool:
  return (config.consistency_distance_loss_mult > 0 or
          config.consistency_distance_coarse_loss_mult > 0)


def _consistency_ratio(config, step) -> float:
  """The consistency losses' warmup-then-decay ratio at `step` (step.py:
  74-87), in float32 as JAX traces it, on the host."""
  f32 = np.float32
  step = f32(step)
  ratio = f32(1.0)
  if 0.0 < config.consistency_warmup_steps <= 1.0:
    ratio = np.minimum(f32(1.0), step / f32(
        config.consistency_warmup_steps * config.max_steps))
  if 0.0 < config.consistency_decay_steps <= 1.0:
    decay_start = config.consistency_decay_steps * config.max_steps
    steps_left = f32(config.max_steps) - step
    total_decay = config.max_steps - decay_start
    decay_ratio = np.maximum(f32(0.0),
                             steps_left / f32(max(1.0, total_decay)))
    if step >= f32(decay_start):
      ratio = decay_ratio
  return float(ratio)


def _param_stats(params, grads):
  """Per-parameter |w|^2, |g| and max|g| (step.py:256-264)."""
  return ({k: torch.sum(p.detach()**2) for k, p in params.items()},
          {k: torch.sqrt(torch.sum(g**2)) for k, g in grads.items()},
          {k: g.abs().max() for k, g in grads.items()})


def make_train_step(model, config, raycast_fn=None, noise_angles=None,
                    draws=None):
  """Build train_step(state, batch, cameras=None) -> (state, stats)
  (step.py:120-283). `raycast_fn(cameras, pixels) -> Rays` casts a batch
  of Pixels (e.g. camera_utils.cast_ray_batch with the dataset's camtype).
  `noise_angles(step, a, max_angle) -> [a, 3]` gives the noisy forward's
  Euler angles; by default `sampling.draw_noise_angles` seeded from
  (config.seed, step), drawn on the model's device. `draws(step, stream)`
  gives a forward's random tensors under `config.randomized` (stream
  `sampling.FWD_STREAM` or `NOISY_FWD_STREAM`); by default
  `sampling.Draws` seeded from (config.seed, step, stream) on the model's
  device."""
  num_levels = model.cfg.num_levels
  schedule = create_lr_schedule(config)
  consistency_on = _consistency_enabled(config)
  distance_consistency_on = _distance_consistency_enabled(config)
  noisy_on = consistency_on or distance_consistency_on
  if noisy_on:
    # Windows outside (0, 1] are off; only an inverted pair of windows that
    # are both on is an error.
    if (0.0 < config.consistency_decay_steps <= 1.0 and
        0.0 < config.consistency_warmup_steps <= 1.0 and
        config.consistency_warmup_steps > config.consistency_decay_steps):
      raise ValueError('Consistency loss decay should be after whole warmup.')
    if config.patch_size ** 2 > config.sample_noise_size:
      raise ValueError(
          f'Patch size {config.patch_size}^2 too large for sampling noise '
          f'view points {config.sample_noise_size}')
  device = next(model.parameters()).device
  if noise_angles is None:
    noise_angles = lambda step, a, max_angle: sampling.draw_noise_angles(
        config.seed, step, a, max_angle, device)
  if not config.randomized:
    draws = lambda step, stream: None
  elif draws is None:
    draws = lambda step, stream: sampling.Draws(config.seed, step, stream,
                                                device)
  # The extras are computed only for the metrics and losses that read them.
  compute_extras = (config.compute_disp_metrics or
                    config.compute_normal_metrics or noisy_on)

  def loss_and_grads(state: TrainState, batch, cameras=None):
    """(total loss, stats, gradients by parameter name before clipping)."""
    step = torch.tensor(float(state.step), dtype=torch.float32)
    train_frac = float(torch.clamp((step - 1) / (config.max_steps - 1), 0, 1))
    rays = batch.rays
    if isinstance(rays, rays_lib.Pixels):
      if raycast_fn is None:
        raise ValueError('Batch carries Pixels but no raycast_fn was given.')
      rays = raycast_fn(cameras, rays)
    renderings, ray_history = model(
        rays, train_frac=train_frac, train=True, compute_extras=compute_extras,
        draws=draws(state.step, sampling.FWD_STREAM))

    ratio = _consistency_ratio(config, state.step)
    noisy_rays = renderings_noise = None
    if noisy_on:
      # The noisy second forward (step.py:179-187): its rays come from the
      # first forward's distance, so it runs after it, on its own graph.
      angles = noise_angles(
          state.step, config.sample_noise_angles,
          sampling.max_noise_angle(config.sample_angle_range, ratio))
      noisy_rays = sampling.sample_noisy_rays(
          rays, renderings[-1],
          angles.to(device=rays.origins.device, dtype=torch.float32),
          config.sample_noise_size // config.patch_size**2)
      renderings_noise, _ = model(
          noisy_rays, train_frac=train_frac, train=True, compute_extras=True,
          draws=draws(state.step, sampling.NOISY_FWD_STREAM))

    loss_terms = {}
    data_loss, stats = losses_lib.compute_data_loss(batch, renderings, rays,
                                                    config)
    loss_terms['data'] = data_loss
    if config.interlevel_loss_mult > 0:
      loss_terms['interlevel'] = losses_lib.interlevel_loss(ray_history,
                                                            config)
    if config.distortion_loss_mult > 0:
      loss_terms['distortion'] = losses_lib.distortion_loss(ray_history,
                                                            config)
    if (config.orientation_coarse_loss_mult > 0 or
        config.orientation_loss_mult > 0):
      loss_terms['orientation'] = losses_lib.orientation_loss(
          rays, num_levels, ray_history, config)
    if (config.predicted_normal_coarse_loss_mult > 0 or
        config.predicted_normal_loss_mult > 0):
      loss_terms['predicted_normals'] = losses_lib.predicted_normal_loss(
          num_levels, ray_history, config)
    if config.patch_size > 1 and (
        config.depth_smoothness_coarse_loss_mult > 0 or
        config.depth_smoothness_loss_mult > 0):
      loss_terms['smoothness'] = losses_lib.compute_depth_smoothness_loss(
          renderings, config)
    if consistency_on:
      (loss_terms['diffuse_consistency'], loss_terms['specular_consistency'],
       loss_terms['normals_consistency']) = losses_lib.noisy_consistency_loss(
           num_levels, renderings, renderings_noise, config, ratio)
    if config.accumulated_weights_loss_mult > 0:
      loss_terms['acc'] = losses_lib.accumulated_weights_loss(renderings,
                                                              config)
    if distance_consistency_on:
      loss_terms['distance_consistency'] = (
          losses_lib.noisy_distance_consistency_loss(
              num_levels, rays, noisy_rays, renderings, renderings_noise,
              config, ratio))
    if (config.weights_entropy_loss_mult > 0 or
        config.weights_entropy_coarse_loss_mult > 0):
      loss_terms['weights_entropy'] = losses_lib.weights_entropy_loss(
          num_levels, renderings, ray_history, config, ratio)
    # A term of levels whose loss is off is the float 0 (as in JAX).
    loss_terms = {k: torch.as_tensor(v, dtype=torch.float32,
                                     device=data_loss.device)
                  for k, v in loss_terms.items()}
    total = torch.stack(list(loss_terms.values())).sum()
    params = state.params()
    grads = torch.autograd.grad(total, list(params.values()))
    stats['loss'] = total.detach()
    stats['losses'] = {k: v.detach() for k, v in loss_terms.items()}
    for k in ('mses', 'disparity_mses', 'normal_maes'):
      if k in stats:
        stats[k] = stats[k].detach()
    return total.detach(), stats, dict(zip(params, grads))

  def train_step(state: TrainState, batch, cameras=None):
    _, stats, grads = loss_and_grads(state, batch, cameras)
    stats['psnrs'] = image_ops.mse_to_psnr(stats['mses'])
    stats['psnr'] = stats['psnrs'][-1]
    stats['learning_rate'] = schedule(state.step)
    if config.stats_every <= 1 or state.step % config.stats_every == 0:
      w_l2s, g_norms, g_maxes = _param_stats(state.params(), grads)
    else:
      zero = {k: torch.zeros(()) for k in grads}
      w_l2s, g_norms, g_maxes = zero, dict(zero), dict(zero)
    stats['weights_l2s'] = w_l2s
    stats['grad_norms'] = g_norms
    stats['grad_maxes'] = g_maxes
    apply_gradients(state, grads, config)
    state.step += 1
    return state, stats

  train_step.loss_and_grads = loss_and_grads
  return train_step
