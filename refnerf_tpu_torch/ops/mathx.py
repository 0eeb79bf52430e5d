"""Scalar/array math helpers (counterpart of refnerf_tpu/ops/mathx.py)."""

from __future__ import annotations

import math

import numpy as np
import torch

_TRIG_T = 100 * math.pi


def safe_trig_arg(x, t=_TRIG_T):
  """Reduce |x| >= t into [0, t) with a floor-mod, as jnp's `x % t` does.

  torch.remainder is the floor-mod (torch.fmod would keep the sign of x).
  """
  return torch.where(x.abs() < t, x, torch.remainder(x, t))


def safe_trig_helper(x, fn, t=_TRIG_T):
  """`fn` of `x` reduced mod t, so large arguments stay accurate."""
  return fn(safe_trig_arg(x, t))


def safe_cos(x):
  return safe_trig_helper(x, torch.cos)


def safe_sin(x):
  return safe_trig_helper(x, torch.sin)


def sorted_interp(x, xp, fp):
  """Batched linear interpolation; xp/fp sorted along the last axis.

  The dense [..., n, m] masked max/min reduction of mathx.py:66-87, kept
  literally so zero-width bins resolve exactly as in the JAX package.
  """
  # mask[..., i, j] is True iff x[..., j] >= xp[..., i].
  mask = x[..., None, :] >= xp[..., :, None]

  def find_interval(y):
    y0 = torch.where(mask, y[..., None], y[..., :1, None]).amax(dim=-2)
    y1 = torch.where(~mask, y[..., None], y[..., -1:, None]).amin(dim=-2)
    return y0, y1

  fp0, fp1 = find_interval(fp)
  xp0, xp1 = find_interval(xp)
  offset = torch.clip(torch.nan_to_num((x - xp0) / (xp1 - xp0)), 0, 1)
  return fp0 + offset * (fp1 - fp0)


def learning_rate_decay(step, lr_init, lr_final, max_steps, lr_delay_steps=0,
                        lr_delay_mult=1.0):
  """Log-linear LR decay with a reverse-cosine warmup (mathx.py:46-63).

  The absolute learning rate at `step` (a number or a float tensor), in the
  JAX function's order of operations.
  """
  xp = torch if isinstance(step, torch.Tensor) else np
  clip = ((lambda v: torch.clamp(v, 0, 1)) if xp is torch
          else (lambda v: np.clip(v, 0, 1)))
  if lr_delay_steps > 0:
    delay_rate = lr_delay_mult + (1 - lr_delay_mult) * xp.sin(
        0.5 * np.pi * clip(step / lr_delay_steps))
  else:
    delay_rate = 1.0
  t = clip(step / max_steps)
  log_lerped = xp.exp(t * (math.log(lr_final) - math.log(lr_init))
                      + math.log(lr_init))
  return delay_rate * log_lerped
