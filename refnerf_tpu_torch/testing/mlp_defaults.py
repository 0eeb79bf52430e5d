"""The JAX package's default Model, and a model of how the wide-input kernel
instances compute its density gradient.

`DEFAULTS` are the gin bindings a run needs beyond `Config()` and the MLP's
and the Model's own defaults: none for the model. Those defaults
(refnerf_tpu/models/mlp.py, refnerf_tpu/models/model.py,
refnerf_tpu/configs.py) are 3 levels of 64, 64 and 32 samples (model.py:29-31)
on a PropMLP and a NerfMLP that are both the MLP at its defaults: an 8 x 256
spatial trunk with the skip at layer 5 (mlp.py:71), a 256-wide bottleneck
(:72), IPE degrees 0-11 (`max_deg_point` 12, :77) on the icosahedron basis at
2 subdivisions (:144-145: 21 basis vectors, 504 IPE columns), density normals
on (`disable_density_normals = False`, :139), and a 1 x 128 directional
trunk on [bottleneck 256 | positional encoding of degree 4, 27]; batch
16,384 rays (configs.py:49). Every user whose gin binds only the data gets
this Model. Its spatial trunk is the shape of `wide_input` with the 256-wide
compute-dtype head, and, in training (density normals), the density gradient
(K3) and the second-order backward from u's cotangent.

`DEFAULTS_NORMALS` adds the orientation loss on the density normals, which
sends a nonzero cotangent of u into the trunk's backward
(refnerf_tpu/train/losses.py:132 reads `orientation_loss_target`, as the
port's losses do). Without it the cotangent of u is zero: autograd hands
the trunk's Function zeros, as JAX hands its custom VJP, and both run the
second-order pass on them.

Parse them without a gin file (`configs.parse([], DEFAULTS_NORMALS)`); the
tests cut them to narrow widths with later bindings, and chip_smoke.py
phase 25 runs them at full width.

`chunked_density_grad` computes u and the second-order gradients as the
wide-input instances do (csrc/trunk_fwd_tma.cu `fwd_wide`, trunk_fwd_f32.cu
`fwd_f32_wide`, trunk_bwd_tma.cu `bwd_wide`, trunk_bwd_f32.cu
`bwd_f32_wide`): no [n, 504] gradient of the input is ever whole. The
forward's u_x products come a chunk of input columns at a time, each folded
onto the lifted means at once, its partner segment's values read from the
input; the backward's tangent ts of the input is made a chunk at a time at
layer 0, each chunk stored to a scratch, and read back from that scratch at
the skip layer (`skip_tangent='scratch'`; 'rebuilt' makes it again there,
as the bf16 instance did before). Its `faults` plant the errors that
chip_smoke.py's bounds must see.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from refnerf_tpu_torch.ops import fused_mlp

DEFAULTS = []
DEFAULTS_NORMALS = DEFAULTS + [
    'Config.orientation_loss_mult = 0.1',
    "Config.orientation_loss_target = 'normals'",
]

# Planted faults of `chunked_density_grad`: u without the skip layer's
# input columns (W5's share of the fold), the tangent without its term at
# the skip layer, and each column scaled by its own segment's value in place
# of its partner's (the sin / cos pairing swapped).
FAULTS = ('no skip fold', 'no skip tangent', 'pairing swapped')


def _coefficients(segs, k0, k1, swap):
  """For the packed input columns [k0, k1) (sin columns [0, F), cos columns
  [F, 2F)), f32 [n, k1 - k0]: a sin column c's partner xc[:, c], a cos
  column F + c's -xs[:, c] (u_m = xc u_xs - xs u_xc); with `swap` each
  column's own segment's value; and each column's fold row c."""
  xs, xc = (s.float() for s in segs)
  f = xs.shape[1]
  cols = torch.arange(k0, k1, device=xs.device)
  c = torch.where(cols < f, cols, cols - f)
  sin, cos = (xs, xc) if swap else (xc, xs)
  coef = torch.where(cols < f, sin[:, c], -cos[:, c])
  return coef, c


def chunked_density_grad(segs: Sequence[torch.Tensor], weights, biases, wd,
                         fold, ubar: Optional[torch.Tensor] = None, *,
                         skip_period: int = 4,
                         compute_dtype: str = 'float32', chunk: int = 128,
                         faults: Sequence[str] = (),
                         skip_tangent: str = 'scratch'):
  """u = d sigma / d(lifted means) [n, nb] f32 and, with `ubar` [n, nb],
  the second-order parameter gradients (`_bwd_kernel` :822-853) as the
  wide-input instances compute them, `chunk` input columns at a time (256
  for the bf16 forward's u_x products, 128 for the f32 forward's and both
  backwards' tangent; the last chunk of 504 columns partial).

  segs: the two IPE segments (xs, xc) [n, F]; weights, biases, wd: as for
  `fused_mlp.trunk_reference`; fold: the [F, nb] scale fold. Returns (u,
  None) without ubar, else (u, (dws, dwd)): the second-order share of each
  layer's weight gradient ([out, in] f32) and of the density head's,
  which `trunk_backward_reference` adds to the first-order gradients.
  `faults`: any of FAULTS. `skip_tangent`: the skip layer's tangent read
  back from the [n, 2F] scratch that layer 0's chunks were stored to
  ('scratch'), or made again from ubar ('rebuilt').
  """
  bad = set(faults) - set(FAULTS)
  if bad:
    raise ValueError(f'unknown faults {sorted(bad)}')
  if skip_tangent not in ('scratch', 'rebuilt'):
    raise ValueError(f'skip_tangent: scratch or rebuilt, got {skip_tangent!r}')
  cdt = fused_mlp.DTYPES[compute_dtype]
  segs = [s.to(cdt) for s in segs]
  f = int(segs[0].shape[1])
  if len(segs) != 2 or int(segs[1].shape[1]) != f or fold.shape[0] != f:
    raise ValueError('the density gradient takes two IPE segments of the '
                     "fold's width")
  t = fused_mlp._trunk(weights, biases, (f, f), skip_period, cdt)
  acts = fused_mlp._forward_acts(t, segs)
  ss = fused_mlp._inner_chain(t, acts, wd, 2)[1]
  width, depth = t.width, len(t.ws)
  swap = 'pairing swapped' in faults
  fold = fold.float()
  spans = [(k0, min(k0 + chunk, 2 * f)) for k0 in range(0, 2 * f, chunk)]

  # The forward: the chain's u_x products, the skip layer's then layer 0's,
  # each chunk's columns folded at once.
  u = segs[0].new_zeros((segs[0].shape[0], fold.shape[1]), dtype=torch.float32)
  for l in reversed(range(depth)):
    if not (l == 0 or l in t.skips) or (
        l in t.skips and 'no skip fold' in faults):
      continue
    off = 0 if l == 0 else width
    for k0, k1 in spans:
      ux = fused_mlp._dot_t(ss[l], t.ws[l][:, off + k0:off + k1])
      coef, rows = _coefficients(segs, k0, k1, swap)
      u = u + (ux * coef) @ fold[rows]
  if ubar is None:
    return u, None

  # The second order: the tangent ts of the input, chunk by chunk, pushed
  # forward; the weight gradients s_l^T [p_{l-1} | ts].
  tp = ubar.float() @ fold.t()

  def tangent():
    out = []
    for k0, k1 in spans:
      coef, rows = _coefficients(segs, k0, k1, swap)
      out.append((tp[:, rows] * coef).to(cdt))
    return out

  ts = tangent()
  scratch = torch.cat(ts, 1)  # layer 0's chunks, stored
  dws = [torch.zeros(w.shape, dtype=torch.float32, device=u.device)
         for w in t.ws]
  p = None
  for l in range(depth):
    if l == 0:
      tt = 0
      for (k0, k1), tc in zip(spans, ts):
        tt = tt + fused_mlp._dot(tc, t.ws[0][:, k0:k1])
        dws[0][:, k0:k1] += fused_mlp._outer(ss[0], tc)
    else:
      tt = fused_mlp._dot(p, t.ws[l][:, :width])
      dws[l][:, :width] += fused_mlp._outer(ss[l], p)
      if l in t.skips:
        tsk = ([scratch[:, k0:k1] for k0, k1 in spans]
               if skip_tangent == 'scratch' else tangent())
        for (k0, k1), tc in zip(spans, tsk):
          if 'no skip tangent' not in faults:
            tt = tt + fused_mlp._dot(tc, t.ws[l][:, width + k0:width + k1])
          dws[l][:, width + k0:width + k1] += fused_mlp._outer(ss[l], tc)
    p = fused_mlp._mask(acts[l]) * tt.to(cdt)
  return u, (dws, p.float().sum(0).reshape(1, width))
