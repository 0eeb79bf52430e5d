"""Step-function tools: the resampling of the cascade (deterministic, or
stratified with jitter), the weight dilation between its levels, the
weighted percentiles of the eval extras, `resample` (vis's ray panels), and
the lookups and losses of the train step (`searchsorted`, `query`,
`inner_outer`, `lossfun_outer`, `lossfun_distortion`,
`interval_distortion`).

Counterpart of refnerf_tpu/ops/stepfun.py. The draw and the map of the
stratified samples are apart: `sample` and `sample_intervals` take the
jitter offsets as a tensor (JAX draws them from its rng inside `sample`,
stepfun.py:167-176), and `draw_jitter` makes them. Without offsets both are
the deterministic linspace (JAX's `rng=None`), as eval runs them.
"""

from __future__ import annotations

import numpy as np
import torch

from refnerf_tpu_torch.ops import mathx

_EPS = float(np.finfo(np.float32).eps)


def searchsorted(a, v):
  """For each v, indices (lo, hi) into sorted `a` with a[lo] <= v < a[hi].

  Out-of-range queries clamp both indices to the first or last index of
  `a`; a tie with an entry of `a` counts as at or above it, as JAX's masked
  reduction does (stepfun.py:26-39). a: [..., n], v: [..., m]; returns two
  int64 [..., m].
  """
  batch = torch.broadcast_shapes(a.shape[:-1], v.shape[:-1])
  a = a.expand(*batch, a.shape[-1]).contiguous()
  v = v.expand(*batch, v.shape[-1]).contiguous()
  above = torch.searchsorted(a, v, right=True)  # #entries <= v
  idx_lo = torch.clamp(above - 1, min=0)
  idx_hi = torch.clamp(above, max=a.shape[-1] - 1)
  return idx_lo, idx_hi


def query(tq, t, y, outside_value=0):
  """Look up the step function (t, y) at locations tq (outside_value
  outside its support)."""
  idx_lo, idx_hi = searchsorted(t, tq)
  batch = idx_lo.shape[:-1]
  # idx_lo reaches len(y) only past the support, where lo == hi anyway.
  yq = torch.gather(y.expand(*batch, y.shape[-1]), -1,
                    torch.clamp(idx_lo, max=y.shape[-1] - 1))
  return torch.where(idx_lo == idx_hi, torch.full_like(yq, outside_value), yq)


def inner_outer(t0, t1, y1):
  """Inner and outer measures of the step fn (t1, y1) over intervals t0."""
  cy1 = torch.cat([torch.zeros_like(y1[..., :1]), torch.cumsum(y1, dim=-1)],
                  dim=-1)
  idx_lo, idx_hi = searchsorted(t1, t0)
  cy1 = cy1.expand(*idx_lo.shape[:-1], cy1.shape[-1])
  cy1_lo = torch.gather(cy1, -1, idx_lo)
  cy1_hi = torch.gather(cy1, -1, idx_hi)
  y0_outer = cy1_hi[..., 1:] - cy1_lo[..., :-1]
  y0_inner = torch.where(idx_hi[..., :-1] <= idx_lo[..., 1:],
                         cy1_lo[..., 1:] - cy1_hi[..., :-1],
                         torch.zeros_like(y0_outer))
  return y0_inner, y0_outer


def lossfun_outer(t, w, t_env, w_env, eps=_EPS):
  """Proposal supervision: the half-quadratic penalty on w above the outer
  measure of its envelope (t_env, w_env)."""
  _, w_outer = inner_outer(t, t_env, w_env)
  excess = torch.maximum(w - w_outer, torch.zeros_like(w))  # H1: not clamp
  return excess**2 / (w + eps)


def lossfun_distortion(t, w):
  """mip-NeRF 360's distortion: iint w_i w_j |t_i - t_j| di dj."""
  ut = (t[..., 1:] + t[..., :-1]) / 2
  dut = torch.abs(ut[..., :, None] - ut[..., None, :])
  loss_inter = torch.sum(w * torch.sum(w[..., None, :] * dut, dim=-1), dim=-1)
  loss_intra = torch.sum(w**2 * (t[..., 1:] - t[..., :-1]), dim=-1) / 3
  return loss_inter + loss_intra


def interval_distortion(t0_lo, t0_hi, t1_lo, t1_hi):
  """mean(|x - y|) for x ~ U[t0_lo, t0_hi], y ~ U[t1_lo, t1_hi]."""
  d_disjoint = torch.abs((t1_lo + t1_hi) / 2 - (t0_lo + t0_hi) / 2)
  d_overlap = (
      2 * (torch.minimum(t0_hi, t1_hi)**3 - torch.maximum(t0_lo, t1_lo)**3) +
      3 * (t1_hi * t0_hi * torch.abs(t1_hi - t0_hi) +
           t1_lo * t0_lo * torch.abs(t1_lo - t0_lo) + t1_hi * t0_lo *
           (t0_lo - t1_hi) + t1_lo * t0_hi *
           (t1_lo - t0_hi))) / (6 * (t0_hi - t0_lo) * (t1_hi - t1_lo))
  are_disjoint = (t0_lo > t1_hi) | (t1_lo > t0_hi)
  return torch.where(are_disjoint, d_disjoint, d_overlap)


def weight_to_pdf(t, w, eps=_EPS**2):
  """Turn weights summing to 1 into a PDF integrating to 1."""
  return w / torch.clamp(t[..., 1:] - t[..., :-1], min=eps)


def pdf_to_weight(t, p):
  """Turn a PDF integrating to 1 into weights summing to 1."""
  return p * (t[..., 1:] - t[..., :-1])


def max_dilate(t, w, dilation, domain=(-np.inf, np.inf)):
  """Dilate (max-pool) a non-negative step function by +-dilation: the
  sorted endpoints of [t, t - dilation, t + dilation] clipped to `domain`,
  each new bin taking the largest w whose dilated interval holds its left
  endpoint. The comparison is [..., 3n + 1, n] (stepfun.py:90-101)."""
  t0 = t[..., :-1] - dilation
  t1 = t[..., 1:] + dilation
  t_dilate = torch.sort(torch.cat([t, t0, t1], dim=-1), dim=-1).values
  t_dilate = torch.clamp(t_dilate, *domain)
  inside = ((t0[..., None, :] <= t_dilate[..., None])
            & (t1[..., None, :] > t_dilate[..., None]))
  w_dilate = torch.where(inside, w[..., None, :],
                         torch.zeros_like(w[..., None, :])).amax(dim=-1)
  return t_dilate, w_dilate[..., :-1]


def max_dilate_weights(t, w, dilation, domain=(-np.inf, np.inf),
                       renormalize=False, eps=_EPS**2):
  """Dilate a weight vector through its PDF (stepfun.py:104-113); with
  `renormalize` the result sums to 1 (its sum floored at eps)."""
  p = weight_to_pdf(t, w)
  t_dilate, p_dilate = max_dilate(t, p, dilation, domain=domain)
  w_dilate = pdf_to_weight(t_dilate, p_dilate)
  if renormalize:
    w_dilate = w_dilate / torch.clamp(
        torch.sum(w_dilate, dim=-1, keepdim=True), min=eps)
  return t_dilate, w_dilate


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


def max_jitter(num_samples) -> float:
  """The stratified samples' largest offset (stepfun.py:169-173): each
  sample stays in its bin of the evenly spaced u; one sample jitters within
  its whole bin."""
  u_max = _EPS + (1 - _EPS) / num_samples
  return (1 - u_max) / max(1, num_samples - 1) - _EPS


def draw_jitter(generator, batch_shape, num_samples, single_jitter):
  """Offsets uniform on [0, max_jitter): [..., 1] with `single_jitter` (one
  a ray), else [..., num_samples], from `generator` on its device."""
  d = 1 if single_jitter else num_samples
  u = torch.rand(tuple(batch_shape) + (d,), generator=generator,
                 device=generator.device)
  return u * max_jitter(num_samples)


def sample(t, w_logits, num_samples, deterministic_center=False,
           jitter=None):
  """Samples of the step function (t, w_logits). With `jitter` (offsets
  [..., 1] or [..., num_samples] in [0, max_jitter), from `draw_jitter`),
  stratified: the evenly spaced u of linspace(0, 1 - u_max) shifted by the
  offsets; without, the deterministic linspace (`deterministic_center`:
  the PDF intervals' centers)."""
  eps = _EPS
  if jitter is not None:
    u_max = eps + (1 - eps) / num_samples
    u = torch.linspace(0, 1 - u_max, num_samples, device=t.device) + jitter
  else:
    if deterministic_center:
      pad = 1 / (2 * num_samples)
      u = torch.linspace(pad, 1.0 - pad - eps, num_samples, device=t.device)
    else:
      u = torch.linspace(0, 1.0 - eps, num_samples, device=t.device)
    u = u.expand(t.shape[:-1] + (num_samples,))
  return invert_cdf(u, t, w_logits)


def sample_intervals(t, w_logits, num_samples, domain=(-np.inf, np.inf),
                     jitter=None):
  """num_samples + 1 fenceposts around the sample centers (deterministic,
  or stratified by `jitter` as in `sample`)."""
  if num_samples <= 1:
    raise ValueError(f'num_samples must be > 1, is {num_samples}.')
  centers = sample(t, w_logits, num_samples, deterministic_center=True,
                   jitter=jitter)
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
