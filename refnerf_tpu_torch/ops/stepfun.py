"""Step-function sampling: the deterministic resampling of the cascade, the
weighted percentiles of the eval extras, and `resample` (vis's ray panels).

Counterpart of refnerf_tpu/ops/stepfun.py:110-187 and :212-237, where
sampling is the deterministic linspace (`rng=None` there). Stratified
sampling is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from refnerf_tpu_torch.ops import mathx

_EPS = float(np.finfo(np.float32).eps)


def integrate_weights(w):
  """CDF endpoints of weights assumed to sum to 1; starts at 0, ends at 1."""
  cw = torch.clamp(torch.cumsum(w[..., :-1], dim=-1), max=1)
  shape = cw.shape[:-1] + (1,)
  return torch.cat([w.new_zeros(shape), cw, w.new_ones(shape)], dim=-1)


def invert_cdf(u, t, w_logits):
  """Invert the CDF defined by (t, softmax(w_logits)) at points u in [0,1)."""
  w = torch.softmax(w_logits, dim=-1)
  cw = integrate_weights(w)
  return mathx.sorted_interp(u, cw, t)


def sample(t, w_logits, num_samples, deterministic_center=False):
  """Deterministic-linspace samples of the step function (t, w_logits)."""
  eps = _EPS
  if deterministic_center:
    pad = 1 / (2 * num_samples)
    u = torch.linspace(pad, 1.0 - pad - eps, num_samples, device=t.device)
  else:
    u = torch.linspace(0, 1.0 - eps, num_samples, device=t.device)
  u = u.expand(t.shape[:-1] + (num_samples,))
  return invert_cdf(u, t, w_logits)


def sample_intervals(t, w_logits, num_samples, domain=(-np.inf, np.inf)):
  """num_samples + 1 fenceposts around the deterministic sample centers."""
  if num_samples <= 1:
    raise ValueError(f'num_samples must be > 1, is {num_samples}.')
  centers = sample(t, w_logits, num_samples, deterministic_center=True)
  mid = (centers[..., 1:] + centers[..., :-1]) / 2
  minval, maxval = domain
  first = torch.clamp(2 * centers[..., :1] - mid[..., :1], min=minval)
  last = torch.clamp(2 * centers[..., -1:] - mid[..., -1:], max=maxval)
  return torch.cat([first, mid, last], dim=-1)


def weighted_percentile(t, w, ps):
  """Percentiles `ps` (in [0,100]) of the step fn (t, w); w sums to 1."""
  cw = integrate_weights(w)
  ps_b = torch.broadcast_to(
      torch.tensor(ps, dtype=t.dtype, device=t.device) / 100,
      t.shape[:-1] + (len(ps),))
  return mathx.sorted_interp(ps_b, cw, t)


def resample(t, tp, vp, use_avg=False, eps=_EPS):
  """Resample the step function (tp, vp) onto new endpoints t by summation
  (stepfun.py:221-237); with `use_avg`, width-weighted averages instead."""
  if use_avg:
    wp = torch.diff(tp, dim=-1)
    v_numer = resample(t, tp, vp * wp, use_avg=False)
    v_denom = resample(t, tp, wp, use_avg=False)
    return v_numer / torch.clamp(v_denom, min=eps)
  acc = torch.cumsum(vp, dim=-1)
  acc0 = torch.cat([acc.new_zeros(acc.shape[:-1] + (1,)), acc], dim=-1)
  return torch.diff(mathx.sorted_interp(t, tp, acc0), dim=-1)
