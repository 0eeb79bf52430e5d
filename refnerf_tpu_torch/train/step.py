"""The train step: forward, losses, backward, clipping and Adam.

Counterpart of refnerf_tpu/train/step.py. `make_train_step(model, config)`
returns `train_step(state, batch) -> (state, stats)`, driven as bench.py
drives the JAX step. The JAX state is immutable; here the parameters (the
model's) and the optimizer moments are updated in place and the same state
object comes back with its step advanced.

The optimizer is optax's chain written out (step.py:40-51): clip by value,
then clip by global norm as optax does it (scale by max_norm / norm, and
only when norm >= max_norm; not torch's clip_grad_norm_, which scales by
max_norm / (norm + 1e-6) whenever norm > max_norm), then Adam with eps
outside the square root, bias correction at count + 1, and the learning rate
of the log-lerp schedule at the update count (0 at the first update).

Ported losses: data (mse, charb), orientation, predicted normals. Refused
with NotImplementedError: every other loss with a multiplier > 0 and the
noisy second forward (ROADMAP queue 1, item 13), `randomized=True` and
density/bottleneck noise (item 14: the RNG streams differ, H3).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from refnerf_tpu_torch.ops import image as image_ops
from refnerf_tpu_torch.ops import mathx
from refnerf_tpu_torch.train import losses as losses_lib


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


def _refuse_unported(model, config):
  on = lambda *names: [n for n in names if getattr(config, n) > 0]
  unported = on('interlevel_loss_mult', 'distortion_loss_mult',
                'accumulated_weights_loss_mult', 'weights_entropy_loss_mult',
                'weights_entropy_coarse_loss_mult',
                'consistency_distance_loss_mult',
                'consistency_distance_coarse_loss_mult')
  if config.patch_size > 1:
    unported += on('depth_smoothness_loss_mult',
                   'depth_smoothness_coarse_loss_mult')
  if config.sample_noise_size > 0:  # _consistency_enabled (step.py:59-66)
    unported += on('consistency_diffuse_coarse_loss_mult',
                   'consistency_specular_coarse_loss_mult',
                   'consistency_normal_coarse_loss_mult',
                   'consistency_diffuse_loss_mult',
                   'consistency_specular_loss_mult',
                   'consistency_normal_loss_mult')
  if unported:
    raise NotImplementedError(
        f'{unported} > 0: these losses are not ported (ROADMAP queue 1, '
        'item 13)')
  if config.randomized:
    raise NotImplementedError(
        'randomized=True: stratified sampling and random backgrounds draw '
        'from an RNG whose stream differs from JAX (H3); not ported '
        '(ROADMAP queue 1, item 14)')
  for mlp in (model.nerf_mlp, model.prop_mlp):
    if mlp is not None and (mlp.cfg.density_noise > 0 or
                            mlp.cfg.bottleneck_noise > 0):
      raise NotImplementedError(
          'density_noise / bottleneck_noise > 0 is not ported (ROADMAP '
          'queue 1, item 14)')


def _param_stats(params, grads):
  """Per-parameter |w|^2, |g| and max|g| (step.py:256-264)."""
  return ({k: torch.sum(p.detach()**2) for k, p in params.items()},
          {k: torch.sqrt(torch.sum(g**2)) for k, g in grads.items()},
          {k: g.abs().max() for k, g in grads.items()})


def make_train_step(model, config):
  """Build train_step(state, batch) -> (state, stats) (step.py:120-283)."""
  _refuse_unported(model, config)
  num_levels = model.cfg.num_levels
  schedule = create_lr_schedule(config)

  def loss_and_grads(state: TrainState, batch):
    """(total loss, stats, gradients by parameter name before clipping)."""
    step = torch.tensor(float(state.step), dtype=torch.float32)
    train_frac = float(torch.clamp((step - 1) / (config.max_steps - 1), 0, 1))
    rays = batch.rays
    renderings, ray_history = model(rays, train_frac=train_frac, train=True)

    loss_terms = {}
    data_loss, stats = losses_lib.compute_data_loss(batch, renderings, rays,
                                                    config)
    loss_terms['data'] = data_loss
    if (config.orientation_coarse_loss_mult > 0 or
        config.orientation_loss_mult > 0):
      loss_terms['orientation'] = losses_lib.orientation_loss(
          rays, num_levels, ray_history, config)
    if (config.predicted_normal_coarse_loss_mult > 0 or
        config.predicted_normal_loss_mult > 0):
      loss_terms['predicted_normals'] = losses_lib.predicted_normal_loss(
          num_levels, ray_history, config)
    total = torch.stack(list(loss_terms.values())).sum()
    params = state.params()
    grads = torch.autograd.grad(total, list(params.values()))
    stats['loss'] = total.detach()
    stats['losses'] = {k: v.detach() for k, v in loss_terms.items()}
    stats['mses'] = stats['mses'].detach()
    return total.detach(), stats, dict(zip(params, grads))

  def train_step(state: TrainState, batch):
    _, stats, grads = loss_and_grads(state, batch)
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
