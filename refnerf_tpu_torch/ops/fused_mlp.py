"""Layer-fused dense trunks: the CUDA kernel wrappers and their plain versions.

Counterpart of refnerf_tpu/ops/pallas/fused_mlp.py: the Pallas kernel pair
`_fwd_kernel` (:612) and `_bwd_kernel` (:668), built per `TrunkCfg` by
`_make_op` (:880) and wrapped there as a custom VJP. Here each trunk kind is
one `torch.autograd.Function`:

- `SpatialTrunk` (`fused_encoded_trunk`, :1326): the IPE segments
  xs = e sin(m), xc = e cos(m) are made here, outside the kernel
  (:1412-1434), from lifted means/vars that enter detached (:1396). The
  forward runs the trunk over the two segments, the density head, the f32
  head block and the compute-dtype bottleneck head (K1); with
  `density_grad` it also runs the inner reverse chain and returns
  u = d sigma / d lifted-means (K3, :589-609, :651-665). The backward (K4)
  recomputes the trunk and returns every first- and second-order parameter
  gradient in one pass (:668-853). `SpaModes` fuses the spatial stages
  into the three: the IPE made in the kernel from the lifted means and
  variances (K7, `encode`: `_segments` :550-563, the chain rule :657-660,
  :829-831) and the compositing weights after the density head (K6,
  `weights`: `_epilogue_fwd` :498, backward :719-741). Their plain versions
  are `ipe_trig` and `composite_weights` / `composite_weights_backward`.
  With `out_y` the forward also returns the trunk's last activation y in
  the compute dtype and the backward takes its cotangent (K11, :617,
  :629-630, :717-718), as mip-NeRF without view directions needs.
- `DirectionalTrunk` (`fused_trunk`, :1178): the trunk over [bottleneck,
  IDE + n.v] and the f32 rgb head (K2); its backward (K5) also returns each
  segment's cotangent in the segment's dtype (`needs_dx`, :1009-1015).
  `DirModes` fuses the directional stages into both (:531-547, :646-647,
  :752-764, :802-819): the IDE from refdirs and kappa_inv (K8), with the
  normalize/reflect/n.v geometry from grad_pred and viewdirs (K9), and the
  colour epilogue after the rgb head (K10). Their plain versions are
  `dir_geometry`, `ide_forward`/`ide_backward` (the closed form) and
  `rgb_epilogue`.

Both backwards are `once_differentiable`: autograd never differentiates
through a kernel, and the second-order terms of u come out of the one
backward pass, as in the Pallas contract.

Kernels (`csrc/trunk_fwd.cu`: K1-K3, K6-K11; `csrc/trunk_bwd.cu`: K4-K11),
at width 256 and, for the directional trunk, 128, run for CUDA tensors
unless `mode='off'`. A CPU tensor or `mode='off'` takes the
plain PyTorch versions, `trunk_reference` and `trunk_backward_reference`,
written in the Pallas kernels' order of operations and casts:

    h = relu(cdt(f32 sum of segment/activation products) + cdt(bias))
    sigma = f32(y) @ wd,  hf = f32(y) @ wh + bh,  hc = cdt(y @ wc) + cdt(bc)

For a CUDA tensor a wrapper launches its kernel or raises; it never falls
back to the plain version. Each launch through a wrapper adds one to
`launches[K]`.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from refnerf_tpu_torch.ops import image as image_ops
from refnerf_tpu_torch.ops import mathx
from refnerf_tpu_torch.ops import ref_utils

DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}
MODES = ('auto', 'on', 'off')
_KS = 32  # the kernels stream weights in K-slices of this many rows
_TILE = 64  # samples per CTA of the trunk kernels
# Rows per slab of the backward kernels: the per-sample operands of the
# weight-gradient products (feature-major, compute dtype) are kept for one
# slab at a time, about 1.1 GB for the spatial trunk in bf16.
BWD_SLAB = 65536
_KSPLIT = 1024  # samples per partial sum of the weight-gradient kernel

# Launches through the wrappers, by kernel: K1 spatial forward, K2
# directional forward, K3 spatial forward with the density gradient, K4
# spatial backward, K5 directional backward. A launch of K1, K3 or K4 with
# fused spatial stages also counts under each stage it runs: K6 the
# compositing weights, K7 the IPE. A launch of K2 or K5 with fused
# directional stages likewise: K8 the IDE, K9 the direction geometry, K10
# the colour epilogue. A launch of K1 or K4 with the trunk's features out
# (y, and its cotangent back) also counts under K11.
launches = {'K1': 0, 'K2': 0, 'K3': 0, 'K4': 0, 'K5': 0, 'K6': 0, 'K7': 0,
            'K8': 0, 'K9': 0, 'K10': 0, 'K11': 0}

Head = Tuple[torch.Tensor, Optional[torch.Tensor]]  # (weight [out, in], bias)


def skip_input_layers(depth: int, skip_period: int) -> Tuple[int, ...]:
  """Layers whose input is [activation, trunk input] (fused_mlp.py:148)."""
  return tuple(i + 1 for i in range(depth)
               if i % skip_period == 0 and 0 < i and i + 1 < depth)


def _check_trunk(depth: int, skip_period: int):
  if depth > 1 and (depth - 1) % skip_period == 0:
    raise NotImplementedError(
        f'a trunk of depth {depth} with skip_layer {skip_period} ends in a '
        'skip concat; the fused trunk does not model it (mlp.py:234-240)')


def ipe_scale_fold(scales, n_basis) -> np.ndarray:
  """The [deg * n_basis, n_basis] scale fold S of fused_mlp.py:1317:
  S[d * n_basis + j, j] = scales[d]; d sigma/d lifted-means = u_m @ S."""
  scales = np.asarray(scales, np.float32)
  return np.kron(scales[:, None], np.eye(n_basis, dtype=np.float32))


def ipe_trig(lm, lv, scales):
  """(e, sin m, cos m), each [n, deg * nb] f32, of lifted means/vars
  [n, nb] (`_segments` :550-563): m = lm s_d, v = lv s_d^2, e = exp(-v/2).

  Degree-major, basis-minor columns. The scales are powers of two, so the
  scaling is an exact elementwise multiply; large arguments are range
  reduced as mathx.safe_sin does (a floor-mod, ROADMAP H2).
  """
  s = torch.as_tensor(np.asarray(scales, np.float32), device=lm.device)
  n = lm.shape[0]
  m = (lm.float()[:, None, :] * s[:, None]).reshape(n, -1)
  v = (lv.float()[:, None, :] * (s * s)[:, None]).reshape(n, -1)
  m = mathx.safe_trig_arg(m)
  return torch.exp(-0.5 * v), torch.sin(m), torch.cos(m)


def encode_ipe(lm, lv, scales, compute_dtype='float32'):
  """The IPE segments (xs, xc) = (e sin m, e cos m) of lifted means/vars
  [n, nb] (:1412-1434), two [n, deg * nb] tensors in the compute dtype."""
  cdt = DTYPES[compute_dtype]
  e, sinm, cosm = ipe_trig(lm, lv, scales)
  return (e * sinm).to(cdt), (e * cosm).to(cdt)


def _by_ray(x, samples):
  """[n] -> [rays, samples] f32."""
  return x.float().reshape(-1, samples)


def _composite(raw, delta, bsig, samples):
  x = _by_ray(raw, samples) + bsig.float()
  dd = F.softplus(x) * _by_ray(delta, samples)
  excl = F.pad(torch.cumsum(dd[:, :-1], 1), (1, 0))
  trans = torch.exp(-excl)
  return x, (1 - torch.exp(-dd)) * trans, trans


def composite_weights(raw, delta, bsig, samples):
  """K6 forward, in f32 (`_epilogue_fwd` :498): the compositing weights
  [n] of rays of `samples` consecutive rows. sigma = softplus(raw + bsig),
  dd = sigma delta, w = (1 - exp(-dd)) exp(-excl), excl the exclusive
  prefix sum of dd along the ray (render.compute_alpha_weights' order).
  raw [n] is the density head without its bias, bsig [1] the density
  head's bias plus the activation bias."""
  return _composite(raw, delta, bsig, samples)[1].reshape(-1)


def composite_weights_backward(raw, delta, bsig, samples, wbar):
  """K6 backward in closed form (:719-741): with T = exp(-excl),
  ct_dd = wbar (T - w) - suffix(wbar w), suffix the exclusive suffix sum
  along the ray, and ct_raw = ct_dd delta sigmoid(raw + bsig).
  Returns (ct_raw [n], d bsig [1])."""
  x, w, trans = _composite(raw, delta, bsig, samples)
  wb = _by_ray(wbar, samples)
  xw = wb * w
  incl = torch.flip(torch.cumsum(torch.flip(xw, [1]), 1), [1])
  suffix = F.pad(incl[:, 1:], (0, 1))
  ct_raw = ((wb * (trans - w) - suffix) * _by_ray(delta, samples)
            * torch.sigmoid(x))
  return ct_raw.reshape(-1), ct_raw.sum().reshape(1)


def _dot(a, w):
  """a [n, k] @ w [out, k]^T with products and sums in f32."""
  return a.float() @ w.float().t()


def _dot_t(a, w):
  """a [n, out] @ w [out, k]: the reverse product, in f32."""
  return a.float() @ w.float()


def _outer(a, b):
  """a [n, p]^T @ b [n, q] -> [p, q]: a sum over samples, in f32."""
  return a.float().t() @ b.float()


def _mask(h):
  """relu' of a stored activation, in its dtype (`_mask` :174)."""
  return (h > 0).to(h.dtype)


class _Trunk(NamedTuple):
  """A trunk's parameters cast as the Pallas kernels read them (`_wrefs`)."""
  ws: List[torch.Tensor]       # per layer [width, in], compute dtype
  bs: List[torch.Tensor]       # per layer [width], compute dtype
  bounds: np.ndarray           # segment column bounds of the trunk input
  skips: Tuple[int, ...]
  width: int
  cdt: torch.dtype


def _trunk(weights, biases, seg_dims, skip_period, cdt) -> _Trunk:
  return _Trunk([w.to(cdt) for w in weights], [b.to(cdt) for b in biases],
                np.cumsum([0] + [int(d) for d in seg_dims]),
                skip_input_layers(len(weights), skip_period),
                int(weights[-1].shape[0]), cdt)


def _seg_cols(t: _Trunk, w, j, off=0):
  return w[:, off + t.bounds[j]:off + t.bounds[j + 1]]


def _forward_acts(t: _Trunk, segs, act):
  """Every layer's activation, in the compute dtype (`_forward_trunk` :566)."""
  def seg_sum(w, off):
    hb = _dot(segs[0], _seg_cols(t, w, 0, off))
    for j in range(1, len(segs)):
      hb = hb + _dot(segs[j], _seg_cols(t, w, j, off))
    return hb

  acts, h = [], None
  for l, (w, b) in enumerate(zip(t.ws, t.bs)):
    if l == 0:
      hb = seg_sum(w, 0)
    else:
      hb = _dot(h, w[:, :t.width])
      if l in t.skips:
        hb = hb + seg_sum(w, t.width)
    h = act(hb.to(t.cdt) + b)
    acts.append(h)
  return acts


def _inner_chain(t: _Trunk, acts, wd, n_segs):
  """The density-gradient reverse chain (`_inner_chain` :589).

  Returns (u per segment [n, d_j] f32, s_l per layer in the compute dtype).
  """
  n = acts[0].shape[0]
  us = [acts[0].new_zeros((n, int(t.bounds[j + 1] - t.bounds[j])),
                          dtype=torch.float32) for j in range(n_segs)]
  ss = [None] * len(t.ws)
  q = wd.float().reshape(1, -1).expand(n, t.width).to(t.cdt)
  for l in reversed(range(len(t.ws))):
    s = _mask(acts[l]) * q
    ss[l] = s
    if l == 0 or l in t.skips:
      off = 0 if l == 0 else t.width
      for j in range(n_segs):
        us[j] = us[j] + _dot_t(s, _seg_cols(t, t.ws[l], j, off))
    if l > 0:
      q = _dot_t(s, t.ws[l][:, :t.width]).to(t.cdt)
  return us, ss


def fold_density_grad(us, xs, xc, fold, trig=None):
  """d sigma / d lifted-means from the segment gradients (:653-662):
  u_m = f32(xc) u_xs - f32(xs) u_xc, then u = u_m @ S. With K7's f32
  `trig` = (e, sin m, cos m), u_m = e (cos m u_xs - sin m u_xc) (:657-659);
  in bf16 the two differ by the rounding of xs and xc."""
  if trig is None:
    u_m = xc.float() * us[0] - xs.float() * us[1]
  else:
    e, sinm, cosm = trig
    u_m = e * (cosm * us[0] - sinm * us[1])
  return u_m @ fold


class DirModes(NamedTuple):
  """The fused stages of a directional trunk (K8-K10).

  ide_deg > 0 (K8): the IDE of that degree is computed from raw inputs at
  position `ide_at` of the segments, (refdirs [n, 3], kappa_inv [n, 1]),
  and stands there as two segments (re, im), P wide each. With `geo` (K9)
  the raw inputs are (grad_pred [n, 3], viewdirs [n, 3], kappa_inv [n, 1]):
  n = -normalize(grad_pred), refdirs = reflect(-viewdirs, n), and n.v
  follows the IDE as a width-1 segment. `rgbe` (K10) is (premultiplier,
  bias, padding) of the colour epilogue after the f32 rgb head.
  """
  ide_deg: int = 0
  ide_at: int = 0
  geo: bool = False
  rgbe: Optional[Tuple[float, float, float]] = None

  def n_raw(self) -> int:
    """How many raw inputs stand in for the IDE segments."""
    return 0 if not self.ide_deg else (3 if self.geo else 2)


class SpaModes(NamedTuple):
  """The fused stages of the spatial trunk (K6, K7).

  `scales` non-empty (K7): the two segments are made in the kernel from
  the lifted means and variances (lm, lv) [n, nb] f32 that stand in for
  them, with these per-degree scales (`ipe_trig`); the density-gradient
  fold and the second-order tangent take the f32 factors e cos m and
  e sin m (:657-660, :829-831), not the rounded segments. `samples` > 0
  (K6): the compositing weights of rays of that many consecutive rows
  follow the density head, from comp = (delta [n] f32, bsig [1] f32).
  """
  scales: Tuple[float, ...] = ()
  samples: int = 0


def _spatial_segments(segs, sp: SpaModes, cdt):
  """The trunk's segments and, with K7, the f32 (e, sin m, cos m)."""
  if not sp.scales:
    return [s.to(cdt) for s in segs], None
  trig = ipe_trig(segs[0], segs[1], sp.scales)
  e, sinm, cosm = trig
  return [(e * sinm).to(cdt), (e * cosm).to(cdt)], trig


_EPS = float(np.finfo(np.float32).eps)
_LOG3 = float(np.float32(np.log(3.0)))


def dir_geometry(grad, v):
  """(refdirs [n, 3], n.v [n, 1]) from grad_pred and viewdirs, in f32
  (`_dir_geometry` :355): n = -grad / sqrt(max(|grad|^2, eps)),
  refdirs = 2 (n.(-v)) n + v."""
  sq = torch.sum(grad * grad, dim=-1, keepdim=True)
  n = -grad / torch.sqrt(torch.maximum(sq, sq.new_tensor(_EPS)))
  mv = -v
  r = 2.0 * torch.sum(n * mv, dim=-1, keepdim=True) * n - mv
  return r, torch.sum(n * v, dim=-1, keepdim=True)


@functools.lru_cache(maxsize=None)
def _ide_tables(deg: int, device: torch.device):
  return tuple(torch.as_tensor(a, device=device)
               for a in ref_utils.ide_tables(deg))


def _ide_powers(rd, l_max):
  """Columns k = 0..l_max of z^k, Re((x+iy)^k), Im((x+iy)^k), by the
  running products of `_ide_powers` :382; each [n, l_max + 1]."""
  x, y, z = rd[:, 0:1], rd[:, 1:2], rd[:, 2:3]
  vmz, re, im = [torch.ones_like(z)], [torch.ones_like(x)], [torch.zeros_like(x)]
  for _ in range(l_max):
    re_p, im_p = re[-1], im[-1]
    vmz.append(vmz[-1] * z)
    re.append(re_p * x - im_p * y)
    im.append(re_p * y + im_p * x)
  return torch.cat(vmz, 1), torch.cat(re, 1), torch.cat(im, 1)


def _ide_parts(rd, ki, deg):
  mat, sg, gm = _ide_tables(deg, rd.device)
  vmz, re, im = _ide_powers(rd, mat.shape[0] - 1)
  zp, at = vmz @ mat, torch.exp(-ki * sg)
  return (mat, sg, gm), (vmz, re, im), re @ gm, im @ gm, zp, at


def ide_forward(rd, ki, deg):
  """The IDE's (re [n, P], im [n, P]) in f32 from refdirs [n, 3] and
  kappa_inv [n, 1] (`_ide_fwd` :402): the power stacks gathered and
  contracted through `ref_utils.ide_tables`, times exp(-sigma kappa_inv)."""
  _, _, rev, imv, zp, at = _ide_parts(rd.float(), ki.float(), deg)
  zpat = zp * at
  return rev * zpat, imv * zpat


def ide_backward(rd, ki, deg, g_re, g_im):
  """(d refdirs [n, 3], d kappa_inv [n, 1]) from the f32 cotangents of the
  IDE's re and im halves, in closed form (`_ide_bwd` :423-460):
  d Re(w^m)/dx = m Re(w^(m-1)), d Re(w^m)/dy = -m Im(w^(m-1)),
  d Im(w^m)/dx = m Im(w^(m-1)), d Im(w^m)/dy = m Re(w^(m-1)) for
  w = x + iy; d z^k/dz = k z^(k-1); d atten/d kappa_inv = -sigma atten."""
  (mat, sg, gm), (vmz, re, im), rev, imv, zp, at = _ide_parts(
      rd.float(), ki.float(), deg)
  zpat = zp * at
  gmix = g_re * rev + g_im * imv
  d_ki = -((gmix * zpat) @ sg.t())
  d_vmz = (gmix * at) @ mat.t()
  d_re = (g_re * zpat) @ gm.t()
  d_im = (g_im * zpat) @ gm.t()
  ramp = torch.arange(mat.shape[0], dtype=torch.float32, device=rd.device)
  shift = lambda a: F.pad(a[:, :-1], (1, 0))  # column m holds power m - 1
  re_s, im_s = shift(re), shift(im)
  d_x = torch.sum((d_re * re_s + d_im * im_s) * ramp, -1, keepdim=True)
  d_y = torch.sum((d_im * re_s - d_re * im_s) * ramp, -1, keepdim=True)
  d_z = torch.sum(d_vmz * shift(vmz) * ramp, -1, keepdim=True)
  return torch.cat([d_x, d_y, d_z], 1), d_ki


def rgb_epilogue(raw, rawd, rawt, premult, bias, pad):
  """The Ref-NeRF colour epilogue in f32 (`_rgb_epilogue` :283-299):
  sigmoid specular x sigmoid tint + sigmoid diffuse, normalised by
  max(max channel, 1), linear_to_srgb (`_linear_to_srgb` :305, the same
  ops as image.linear_to_srgb), clipped to [0, 1], padded. `amax` and the
  maximum/minimum against tensor constants give JAX's tie subgradients,
  which every gamut-normalised sample hits."""
  rgb = torch.sigmoid(premult * raw + bias)
  rgb = torch.sigmoid(rawt) * rgb + torch.sigmoid(rawd - _LOG3)
  mx = rgb.amax(dim=-1, keepdim=True)
  rgb = rgb / torch.maximum(mx, torch.ones_like(mx))
  rgb = image_ops.clip01(image_ops.linear_to_srgb(rgb))
  return rgb * (1 + 2 * pad) - pad


def _vjp(fn, primals, cots):
  """Cotangents of fn's inputs by autograd on detached copies, as the
  Pallas kernel takes jax.vjp of the same plain function."""
  with torch.enable_grad():
    xs = [p.detach().float().requires_grad_(True) for p in primals]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return torch.autograd.grad(outs, xs, [c.float() for c in cots])


def dir_segments(segs, dm: DirModes, cdt):
  """The trunk's segments from the raw inputs: at `ide_at` the IDE's re and
  im (f32, rounded to the compute dtype as the Pallas kernel rounds them,
  :531-547) and, with geo, n.v."""
  if not dm.ide_deg:
    return [s.to(cdt) for s in segs]
  j = dm.ide_at
  raw = [s.float() for s in segs[j:j + dm.n_raw()]]
  tail = []
  if dm.geo:
    rd, nd = dir_geometry(raw[0], raw[1])
    tail = [nd.to(cdt)]
  else:
    rd = raw[0]
  re, im = ide_forward(rd, raw[-1], dm.ide_deg)
  return ([s.to(cdt) for s in segs[:j]] + [re.to(cdt), im.to(cdt)] + tail
          + [s.to(cdt) for s in segs[j + dm.n_raw():]])


def _dir_dx(segs, dm: DirModes, dxs):
  """The raw inputs' f32 cotangents from those of the trunk's segments
  (:802-819); the viewdirs of geo mode get None."""
  if not dm.ide_deg:
    return dxs
  j, nr = dm.ide_at, dm.n_raw()
  raw = [s.float() for s in segs[j:j + nr]]
  rd = dir_geometry(raw[0], raw[1])[0] if dm.geo else raw[0]
  d_rd, d_ki = ide_backward(rd, raw[-1], dm.ide_deg, dxs[j], dxs[j + 1])
  if dm.geo:
    d_g, = _vjp(lambda g: dir_geometry(g, raw[1]), [raw[0]],
                [d_rd, dxs[j + 2]])
    mid = [d_g, None, d_ki]
  else:
    mid = [d_rd, d_ki]
  return dxs[:j] + mid + dxs[j + 2 + int(dm.geo):]


def trunk_reference(segs: Sequence[torch.Tensor], weights, biases, *,
                    skip_period: int = 4, wd: Optional[torch.Tensor] = None,
                    head_f32: Optional[Head] = None,
                    head_cdt: Optional[Head] = None,
                    compute_dtype: str = 'float32',
                    activation: Optional[Callable] = None,
                    density_grad: bool = False,
                    dir_modes: Optional[DirModes] = None, rgbx=None,
                    fold=None, spa_modes: Optional[SpaModes] = None,
                    comp=None, out_y: bool = False):
  """The plain version of the forward kernel, in the Pallas order (:612).

  Args:
    segs: input segments [n, d_j]; their concatenation is the trunk input.
      With `dir_modes.ide_deg` the IDE's raw inputs stand in for its two
      segments (DirModes); with `spa_modes.scales` (lm, lv) stand in for
      the two IPE segments (SpaModes).
    weights, biases: per layer, [width, in] and [width]. The skip layer's
      input columns are [activation, segments] in that order.
    wd: density head weight [1, width]; gives sigma without its bias.
    head_f32: (wh [hf, width], bh [hf]) evaluated in f32.
    head_cdt: (wc [hc, width], bc [hc]) evaluated in the compute dtype.
    activation: the trunk nonlinearity; None is ReLU.
    density_grad: also run the inner chain (needs wd and ReLU).
    dir_modes: the fused directional stages (K8-K10), or None.
    rgbx: with `dir_modes.rgbe`, (raw diffuse [n, 3], raw tint [n, 3]).
    fold: with `density_grad`, the [F, nb] scale fold of the two IPE
      segments: u comes out folded onto the lifted means, as the kernel
      gives it (K3).
    spa_modes: the fused spatial stages (K6, K7), or None.
    comp: with `spa_modes.samples`, (delta [n], bsig [1]) f32.
    out_y: also return the trunk's last activation y (K11, :617, :629-630).

  Returns:
    list [y [n, width] in the compute dtype with `out_y`][, sigma [n]]
    [, hf [n, hf]][, hc [n, hc]][, u_j [n, d_j] per segment, or u [n, nb]
    with `fold`][, rgb [n, 3] f32 with the colour epilogue][, weights [n] f32
    with the compositing epilogue]. Every step is a differentiable torch
    op, so autograd through this function is an independent reference for
    the backward.
  """
  cdt = DTYPES[compute_dtype]
  act = torch.relu if activation is None else activation
  dm = dir_modes or DirModes()
  sp = spa_modes or SpaModes()
  trig = None
  if sp.scales:
    segs, trig = _spatial_segments(segs, sp, cdt)
  else:
    segs = dir_segments(segs, dm, cdt)
  t = _trunk(weights, biases, [s.shape[-1] for s in segs], skip_period, cdt)
  acts = _forward_acts(t, segs, act)
  h = acts[-1]
  outs = [h] if out_y else []
  y32 = h.float()
  sig = None
  if wd is not None:
    sig = y32 @ wd.float().reshape(-1)
    outs.append(sig)
  if head_f32 is not None:
    wh, bh = head_f32
    hval = y32 @ wh.float().t() + bh.float()
    outs.append(hval)
  if head_cdt is not None:
    wc, bc = head_cdt
    outs.append(_dot(h, wc.to(cdt)).to(cdt) + bc.to(cdt))
  if density_grad:
    if wd is None or act not in (torch.relu, F.relu):
      raise NotImplementedError('the density gradient needs the density '
                                'head and a ReLU trunk')
    us = _inner_chain(t, acts, wd, len(segs))[0]
    if fold is None:
      outs += us
    else:
      outs.append(fold_density_grad(us, segs[0], segs[1], fold, trig))
  if dm.rgbe is not None:
    outs.append(rgb_epilogue(hval, rgbx[0].float(), rgbx[1].float(),
                             *dm.rgbe))
  if sp.samples:
    outs.append(composite_weights(sig, comp[0], comp[1], sp.samples))
  return outs


def trunk_backward_reference(segs, weights, biases, cots, *, skip_period=4,
                             wd=None, head_f32=None, head_cdt=None,
                             compute_dtype='float32', fold=None,
                             needs_dx=False,
                             dir_modes: Optional[DirModes] = None, rgbx=None,
                             rgb_bar=None,
                             spa_modes: Optional[SpaModes] = None,
                             comp=None, ybar=None):
  """The plain version of the backward kernel, step by step in the Pallas
  order (`_bwd_kernel` :668-853), not by autograd.

  Args:
    segs, weights, biases, wd, head_f32, head_cdt, dir_modes, rgbx,
      spa_modes: as for trunk_reference.
    cots: cotangents (sigma [n] f32, hf [n, hf] f32, hc [n, hc], u [n, nb]
      f32[, weights [n] f32]), each None when absent or zero. u needs
      `fold`, the [F, nb] scale fold of the two IPE segments; the weights'
      cotangent goes with the compositing epilogue.
    comp: with `spa_modes.samples`, (delta [n], bsig [1], sigma [n]) f32,
      sigma the forward's output (the density head without its bias). The
      weights' cotangent becomes one of sigma, added to `cots`' (:719-742).
    needs_dx: also return each segment's cotangent; with the fused IDE,
      those of its raw inputs (None for the viewdirs of geo mode).
    rgb_bar: with the colour epilogue, the cotangent of rgb [n, 3] f32 (None
      is zero). Its pull-back through the epilogue (autograd of
      `rgb_epilogue`, as the Pallas kernel takes jax.vjp, :752-764) adds to
      the head's cotangent.
    ybar: the cotangent of y [n, width] (K11, `trunk_reference`'s out_y),
      or None. It enters y's cotangent first, in the compute dtype, ahead of
      the heads' (:717-718).

  Returns:
    (dws, dbs, dwd, dwh, dbh, dwc, dbc, dxs, drgbx, dbsig): f32 gradients
    in the layout of the parameters ([out, in] weights; dwd [1, width]);
    dxs per segment in the segment's dtype, or None; drgbx (d raw diffuse,
    d raw tint) f32 with the colour epilogue, else None; dbsig [1] with the
    compositing epilogue, else None.
  """
  cdt = DTYPES[compute_dtype]
  sbar, hbar, cbar, ubar, *wbar = cots
  dm = dir_modes or DirModes()
  sp = spa_modes or SpaModes()
  raw = list(segs)
  dtypes = [s.dtype for s in segs]
  trig = None
  if sp.scales:
    segs, trig = _spatial_segments(segs, sp, cdt)
  else:
    segs = dir_segments(segs, dm, cdt)
  dbsig = None
  if sp.samples:
    delta, bsig, sig = comp
    wb = wbar[0] if wbar and wbar[0] is not None else torch.zeros_like(sig)
    ct_raw, dbsig = composite_weights_backward(sig, delta, bsig, sp.samples,
                                               wb)
    sbar = ct_raw if sbar is None else sbar.float() + ct_raw
  t = _trunk(weights, biases, [s.shape[-1] for s in segs], skip_period, cdt)
  n, W, L, G = segs[0].shape[0], t.width, len(t.ws), len(segs)
  acts = _forward_acts(t, segs, torch.relu)
  y = acts[-1]
  y32 = y.float()
  ss = None
  if ubar is not None:
    ss = _inner_chain(t, acts, wd, G)[1]

  # Head backward: the cotangent g on y and the head gradients (:714-775).
  dwd = dwh = dbh = dwc = dbc = None
  g = torch.zeros_like(y)
  if ybar is not None:
    g = g + ybar.to(cdt)
  g32 = None
  if wd is not None:
    sb = y32.new_zeros(n) if sbar is None else sbar.float()
    g32 = sb[:, None] * wd.float().reshape(1, -1)
    dwd = (sb @ y32).reshape(1, W)
  drgbx = None
  if head_f32 is not None:
    wh = head_f32[0].float()
    hb = y32.new_zeros((n, wh.shape[0])) if hbar is None else hbar.float()
    if dm.rgbe is not None:
      hval = y32 @ wh.t() + head_f32[1].float()
      rb = torch.zeros_like(hval) if rgb_bar is None else rgb_bar
      d_raw, *drgbx = _vjp(lambda a, b, c: rgb_epilogue(a, b, c, *dm.rgbe),
                           [hval, rgbx[0], rgbx[1]], [rb])
      hb = hb + d_raw
    back = hb @ wh
    g32 = back if g32 is None else g32 + back
    dwh = _outer(hb, y32)
    dbh = hb.sum(0)
  if head_cdt is not None:
    wc = head_cdt[0].to(cdt)
    cb = (y.new_zeros((n, wc.shape[0])) if cbar is None else cbar.to(cdt))
    g = g + _dot_t(cb, wc).to(cdt)
    dwc = _outer(cb, y)
    dbc = cb.float().sum(0)
  if g32 is not None:
    g = g + g32.to(cdt)

  # First-order reverse through the trunk (:777-801).
  dws = [torch.zeros(w.shape, dtype=torch.float32, device=y.device)
         for w in t.ws]
  dbs = [None] * L
  dxs = [y32.new_zeros((n, s.shape[-1])) for s in segs] if needs_dx else None

  def seg_grads(dw, off, left, rights):
    for j in range(G):
      dw[:, off + t.bounds[j]:off + t.bounds[j + 1]] += _outer(left, rights[j])

  for l in reversed(range(L)):
    zeta = _mask(acts[l]) * g
    if l == 0:
      seg_grads(dws[0], 0, zeta, segs)
    else:
      dws[l][:, :W] += _outer(zeta, acts[l - 1])
      if l in t.skips:
        seg_grads(dws[l], W, zeta, segs)
    dbs[l] = zeta.float().sum(0)
    if needs_dx and (l == 0 or l in t.skips):
      off = 0 if l == 0 else W
      for j in range(G):
        dxs[j] = dxs[j] + _dot_t(zeta, _seg_cols(t, t.ws[l], j, off))
    if l > 0:
      g = _dot_t(zeta, t.ws[l][:, :W]).to(cdt)

  # Second-order pass from the cotangent of u: the tangent chain p (:823-853).
  if ubar is not None:
    if fold is None or G != 2:
      raise ValueError('the cotangent of u needs the IPE scale fold')
    tp = ubar.float() @ fold.float().t()
    if trig is None:
      ts = [(tp * segs[1].float()).to(cdt),
            (-(tp * segs[0].float())).to(cdt)]
    else:
      e, sinm, cosm = trig
      ts = [(tp * e * cosm).to(cdt), (-(tp * e * sinm)).to(cdt)]
    p = None
    for l in range(L):
      if l == 0:
        tt = _dot(ts[0], _seg_cols(t, t.ws[0], 0))
        for j in range(1, G):
          tt = tt + _dot(ts[j], _seg_cols(t, t.ws[0], j))
        seg_grads(dws[0], 0, ss[0], ts)
      else:
        tt = _dot(p, t.ws[l][:, :W])
        dws[l][:, :W] += _outer(ss[l], p)
        if l in t.skips:
          for j in range(G):
            tt = tt + _dot(ts[j], _seg_cols(t, t.ws[l], j, W))
          seg_grads(dws[l], W, ss[l], ts)
      p = _mask(acts[l]) * tt.to(cdt)
    dwd = dwd + p.float().sum(0).reshape(1, W)
  if dxs is not None:
    dxs = [None if d is None else d.to(dt)
           for d, dt in zip(_dir_dx(raw, dm, dxs), dtypes)]
  return dws, dbs, dwd, dwh, dbh, dwc, dbc, dxs, drgbx, dbsig


class TrunkPack(NamedTuple):
  """A trunk's weights laid out for the kernels: built once per model."""
  w: torch.Tensor             # per layer [width, K_l], K contiguous, flat
  wt: torch.Tensor            # per layer [K_l, width] (W_l^T), flat
  b: torch.Tensor             # [depth, width]
  wd: Optional[torch.Tensor]  # [width] f32
  wh: Optional[torch.Tensor]  # [hf, width] f32
  bh: Optional[torch.Tensor]  # [hf] f32
  wc: Optional[torch.Tensor]  # [hc, width]
  wct: Optional[torch.Tensor]  # [width, hc] (wc^T)
  bc: Optional[torch.Tensor]  # [hc]
  seg_dims: Tuple[int, ...]
  kin: int                    # sum(seg_dims) rounded up to the K-slice
  depth: int
  width: int
  skip: int                   # the one skip-input layer, or -1
  compute_dtype: str

  def k_dims(self) -> Tuple[int, ...]:
    """Each layer's packed input width K_l (kin | width | width + kin)."""
    return tuple(self.kin if l == 0 else
                 self.width + (self.kin if l == self.skip else 0)
                 for l in range(self.depth))


def pack_trunk(weights, biases, seg_dims, *, skip_period=4, wd=None,
               head_f32=None, head_cdt=None,
               compute_dtype='float32') -> TrunkPack:
  """Re-lay a trunk's weights for the kernels (the split of `_canonicalize`).

  The segments' weight columns stay contiguous and are zero-padded to
  `kin`, matching the kernels' shared-memory input tile; the skip layer
  keeps its activation columns first. `wt` holds each layer transposed, the
  B operand of the reverse products (s W, zeta W), whose zero-padded rows
  give zero-padded columns.
  """
  cdt = DTYPES[compute_dtype]
  depth, width = len(weights), int(weights[-1].shape[0])
  fin = int(sum(seg_dims))
  kin = -(-fin // _KS) * _KS
  skips = skip_input_layers(depth, skip_period)
  if len(skips) > 1:
    raise NotImplementedError(
        f'the trunk kernel models one skip layer, got {skips}')
  blocks, tblocks = [], []
  with torch.no_grad():
    for l, w in enumerate(weights):
      w = w.detach().float()
      k_in = fin if l == 0 else width + (fin if l in skips else 0)
      if tuple(w.shape) != (width, k_in):
        raise ValueError(f'layer {l}: expected weight {(width, k_in)}, '
                         f'got {tuple(w.shape)}')
      if l == 0 or l in skips:
        w = F.pad(w, (0, kin - fin))
      blocks.append(w.reshape(-1))
      tblocks.append(w.t().reshape(-1))
    f32 = lambda t: None if t is None else t.detach().float().contiguous()
    wh, bh = head_f32 if head_f32 is not None else (None, None)
    wc, bc = head_cdt if head_cdt is not None else (None, None)
    c = lambda t: None if t is None else t.detach().to(cdt).contiguous()
    return TrunkPack(
        w=torch.cat(blocks).to(cdt).contiguous(),
        wt=torch.cat(tblocks).to(cdt).contiguous(),
        b=torch.stack([b.detach() for b in biases]).to(cdt).contiguous(),
        wd=None if wd is None else f32(wd.reshape(-1)),
        wh=f32(wh), bh=f32(bh), wc=c(wc),
        wct=None if wc is None else c(wc.t()), bc=c(bc),
        seg_dims=tuple(int(d) for d in seg_dims), kin=kin, depth=depth,
        width=width, skip=skips[0] if skips else -1,
        compute_dtype=compute_dtype)


def use_kernel(x: torch.Tensor, mode: str) -> bool:
  """Whether a wrapper launches its kernel for input x under `mode`."""
  if mode not in MODES:
    raise ValueError(f'fused_trunk mode must be one of {MODES}, got {mode!r}')
  return x.is_cuda and mode != 'off'


def _kernel_guard(activation):
  if activation is not None and activation not in (torch.relu, F.relu):
    raise NotImplementedError(
        f'the trunk kernel models ReLU only, got {activation!r}')


def _ptr(t):
  return None if t is None else t.data_ptr()


def _library(name: str, pack: TrunkPack, hc: int):
  from refnerf_tpu_torch.ops import cuda_build  # builds on first use
  if not cuda_build.library('trunk_fwd').refnerf_trunk_supports(pack.width,
                                                                 hc):
    raise NotImplementedError(
        f'no trunk kernel instance for width {pack.width} and compute-dtype '
        f'head {hc} (built: width 256, head 0 or 128; width 128, head 0)')
  return cuda_build.library(name)


def _instance_guard(pack: TrunkPack, hc, fold, dm: DirModes, sp: SpaModes,
                    y: bool):
  """Refuses, before anything is built or launched, what mip-NeRF's
  instances do not run. K11 (y out, ybar in) runs in an instance of its
  own: the spatial trunk at width 256 without the compute-dtype head, the
  density gradient (K3) or a fused stage (K6-K10). Width 128 runs only the
  plain directional trunk (K2, K5): no density head, density gradient or
  fused stage."""
  fused = (('the density gradient (K3)', fold is not None),
           ('the compositing weights (K6)', sp.samples),
           ('the in-kernel IPE (K7)', sp.scales),
           ('a fused directional stage (K8-K10)', dm.ide_deg or dm.rgbe))
  if y:
    what = 'the trunk-features output (K11)'
    modes = ((f'width {pack.width}', pack.width != 256),
             (f'the compute-dtype head ({hc})', hc)) + fused
  elif pack.width == 128:
    what = 'the width-128 trunk'
    modes = (('the density head', pack.wd is not None),) + fused
  else:
    return
  off = [name for name, on in modes if on]
  if off:
    raise NotImplementedError(
        f'{what} has no kernel with ' + ', '.join(off) + ' (ROADMAP queue 2)')


def _check_launch(err, what):
  if err != 0:
    raise RuntimeError(f'{what} launch failed with cudaError {err}')


def visible_dims(segs, dm: DirModes) -> Tuple[int, ...]:
  """The widths of the trunk's segments: with the fused IDE its raw inputs
  give way to (P, P) and, in geo mode, n.v's 1."""
  dims = [int(s.shape[-1]) for s in segs]
  if dm.ide_deg:
    p = int(ref_utils.ide_constants(dm.ide_deg)[0].shape[1])
    j = dm.ide_at
    dims[j:j + dm.n_raw()] = [p, p] + ([1] if dm.geo else [])
  return tuple(dims)


def _dir_segments(segs, ide_deg=0, ide_at=0, ide_geo=False):
  """fused_trunk's segments with the IDE's raw-input tuple at `ide_at`
  spread out, and the DirModes of its IDE keywords."""
  segs = list(segs)
  if not ide_deg:
    return segs, DirModes()
  segs[ide_at:ide_at + 1] = list(segs[ide_at])
  return segs, DirModes(int(ide_deg), ide_at, bool(ide_geo))


def trunk_dims(segs, ide_deg=0, ide_at=0, ide_geo=False, rgb_epilogue=None):
  """The segment widths of the pack fused_trunk needs for `segs` and its
  keywords (the colour epilogue changes none)."""
  del rgb_epilogue
  return visible_dims(*_dir_segments(segs, ide_deg, ide_at, ide_geo))


class _KernelIn(NamedTuple):
  """A trunk input as the kernels take it: the columns are [x0 (d0) | the
  fused IDE block (re P | im P | n.v in geo mode) | x1 (d1)], the IDE block
  made in the kernel from the raw f32 inputs g (refdirs or grad_pred), v
  (viewdirs, geo mode) and k (kappa_inv). With K7 x0 and x1 are None: the
  kernel makes both segments (SpaModes)."""
  x0: Optional[torch.Tensor]
  x1: Optional[torch.Tensor]
  g: Optional[torch.Tensor]
  v: Optional[torch.Tensor]
  k: Optional[torch.Tensor]
  p: int            # IDE harmonics, 0 without the fused IDE
  lmax: int
  geo: bool
  tables: tuple     # (mat, sigma_row, gather) f32 on the device, or Nones
  d0: int
  d1: int


def _cols(x):
  return 0 if x is None else int(x.shape[1])


def _kernel_inputs(segs, pack: TrunkPack, dm: DirModes) -> _KernelIn:
  dev = segs[0].device
  for t in (pack.w, pack.wt, pack.b, pack.wd, pack.wh, pack.wc):
    if t is not None and t.device != dev:
      raise ValueError(f'weights on {t.device}, inputs on {dev}')
  dims = visible_dims(segs, dm)
  if dims != pack.seg_dims:
    raise ValueError(f'segments {dims} do not match the pack {pack.seg_dims}')
  cdt = DTYPES[pack.compute_dtype]
  c = lambda s: s.to(cdt).contiguous()
  if not dm.ide_deg:
    if not 1 <= len(segs) <= 2:
      raise NotImplementedError('the trunk kernel takes one or two input '
                                f'segments, got {len(segs)}')
    x0, x1 = c(segs[0]), c(segs[1]) if len(segs) > 1 else None
    return _KernelIn(x0, x1, None, None, None, 0, 0, False, (None,) * 3,
                     _cols(x0), _cols(x1))
  nr = dm.n_raw()
  if dm.ide_at != 1 or len(segs) > 2 + nr:
    raise NotImplementedError(
        'the trunk kernel takes the fused IDE after exactly one segment and '
        f'before at most one more, got {dims}')
  n = int(segs[0].shape[0])
  raw = [s.float().contiguous() for s in segs[1:1 + nr]]
  for r, w in zip(raw, (3, 3, 1) if dm.geo else (3, 1)):
    if tuple(r.shape) != (n, w):
      raise ValueError(f'raw IDE input of shape {tuple(r.shape)}, expected '
                       f'{(n, w)}')
  tables = _ide_tables(dm.ide_deg, dev)
  x0, x1 = c(segs[0]), c(segs[-1]) if len(segs) > 1 + nr else None
  return _KernelIn(x0, x1, raw[0], raw[1] if dm.geo else None, raw[-1],
                   int(tables[0].shape[1]), int(tables[0].shape[0]) - 1,
                   dm.geo, tables, _cols(x0), _cols(x1))


_MAX_RAY_ROWS = 1024  # rows a forward CTA may own so that it holds whole rays


def ray_rows(samples: int) -> int:
  """Rows of the smallest run of whole 64-row tiles that holds whole rays of
  `samples` rows: a K6 forward CTA owns that many, a backward slab a
  multiple of it."""
  return samples * _TILE // math.gcd(samples, _TILE)


@functools.lru_cache(maxsize=None)
def _scale_fold(scales, nb, device):
  return torch.as_tensor(ipe_scale_fold(scales, nb), device=device)


class _SpaIn(NamedTuple):
  """The fused spatial stages as the kernels take them: with K7 the raw
  (lm, lv) f32 and the scale fold that carries the scales; with K6 delta,
  bsig and the samples per ray."""
  lm: Optional[torch.Tensor]
  lv: Optional[torch.Tensor]
  fold: Optional[torch.Tensor]
  delta: Optional[torch.Tensor]
  bsig: Optional[torch.Tensor]
  samples: int


def _spa_inputs(segs, pack: TrunkPack, sp: SpaModes, comp, fold) -> _SpaIn:
  """Check the K6/K7 inputs against the pack; (lm, lv) are then the two
  segments, [n, nb] each, and pack.seg_dims (nb deg, nb deg)."""
  n = int(segs[0].shape[0])
  dev = segs[0].device
  lm = lv = enc_fold = delta = bsig = None
  if (sp.scales or sp.samples) and (pack.wc is None or pack.wd is None):
    raise NotImplementedError(
        'the fused spatial stages run in the spatial trunk with its density '
        'head and the compute-dtype bottleneck head (built: head 128)')
  if sp.scales:
    if len(segs) != 2 or any(s.dim() != 2 or s.shape[1] != segs[0].shape[1]
                             for s in segs):
      raise ValueError('the in-kernel IPE takes (lm, lv), [n, nb] each')
    nb = int(segs[0].shape[1])
    f = nb * len(sp.scales)
    if pack.seg_dims != (f, f):
      raise ValueError(f'IPE of {nb} x {len(sp.scales)} columns does not '
                       f'match the pack {pack.seg_dims}')
    lm, lv = (s.float().contiguous() for s in segs)
    enc_fold = (fold.float().contiguous() if fold is not None
                else _scale_fold(tuple(sp.scales), nb, dev))
  if sp.samples:
    if ray_rows(sp.samples) > _MAX_RAY_ROWS or n % sp.samples:
      raise NotImplementedError(
          f'the compositing epilogue takes whole rays of a number of samples '
          f'whose rows and 64-row tiles meet within {_MAX_RAY_ROWS} rows; '
          f'got {n} rows of {sp.samples}')
    delta, bsig = comp[0], comp[1]
    delta = delta.float().reshape(n).contiguous()
    bsig = bsig.float().reshape(1).contiguous()
  return _SpaIn(lm, lv, enc_fold, delta, bsig, sp.samples)


def _rgbe_inputs(dm: DirModes, rgbx, pack: TrunkPack, n):
  """(raw diffuse, raw tint) f32 and (premult, bias, pad) of the epilogue."""
  if dm.rgbe is None:
    return None, None, (0.0, 0.0, 0.0)
  if pack.wh is None or pack.wh.shape[0] != 3 or pack.wd is not None:
    raise ValueError('the colour epilogue needs the rgb head (3 wide) as '
                     'the only f32 head')
  rawd, rawt = (r.float().reshape(n, 3).contiguous() for r in rgbx)
  return rawd, rawt, dm.rgbe


def _launch_inputs(segs, pack: TrunkPack, dm: DirModes, sp: SpaModes, comp,
                   fold):
  """(_KernelIn, _SpaIn) of a launch; with K7 the segments are (lm, lv)
  and the two segments' widths come from the pack."""
  if not (sp.scales or sp.samples):
    return _kernel_inputs(segs, pack, dm), _SpaIn(*(None,) * 5, 0)
  si = _spa_inputs(segs, pack, sp, comp, fold)
  if not sp.scales:
    return _kernel_inputs(segs, pack, dm), si
  for t in (pack.w, pack.wt, pack.b, pack.wd, pack.wc):
    if t.device != si.lm.device:
      raise ValueError(f'weights on {t.device}, inputs on {si.lm.device}')
  return _KernelIn(None, None, None, None, None, 0, 0, False, (None,) * 3,
                   *pack.seg_dims), si


def trunk_kernel(segs: Sequence[torch.Tensor], pack: TrunkPack,
                 fold: Optional[torch.Tensor] = None,
                 dir_modes: Optional[DirModes] = None, rgbx=None,
                 spa_modes: Optional[SpaModes] = None, comp=None,
                 out_y: bool = False):
  """Launch the CUDA forward kernel; outputs as `trunk_reference` returns
  them with `fold` ([F, nb] f32, two IPE segments): the density gradient
  comes out folded, u [n, nb] f32 (K3). `dir_modes` and `rgbx` (K8-K10),
  `spa_modes` and `comp` (K6, K7), `out_y` (K11) as for trunk_reference."""
  dm = dir_modes or DirModes()
  sp = spa_modes or SpaModes()
  hc = 0 if pack.wc is None else int(pack.wc.shape[0])
  _instance_guard(pack, hc, fold, dm, sp, out_y)
  lib = _library('trunk_fwd', pack, hc)
  cdt = DTYPES[pack.compute_dtype]
  ki, si = _launch_inputs(segs, pack, dm, sp, comp, fold)
  dev, n, d0, d1 = segs[0].device, int(segs[0].shape[0]), ki.d0, ki.d1
  hf = 0 if pack.wh is None else int(pack.wh.shape[0])
  sig = torch.empty(n, device=dev) if pack.wd is not None else None
  hout = torch.empty(n, hf, device=dev) if hf else None
  cout = torch.empty(n, hc, device=dev, dtype=cdt) if hc else None
  u = nb = None
  if fold is not None:
    if (pack.wd is None or not d1 or ki.p or fold.shape[0] != d0):
      raise ValueError('the density gradient needs the density head and two '
                       f'IPE segments matching the fold {tuple(fold.shape)}')
    fold = fold.float().contiguous()
    nb = int(fold.shape[1])
    u = torch.empty(n, nb, device=dev)
  if si.lm is not None:
    fold, nb = si.fold, int(si.fold.shape[1])
  rawd, rawt, (premult, rbias, pad) = _rgbe_inputs(dm, rgbx, pack, n)
  rgb = torch.empty(n, 3, device=dev) if rawd is not None else None
  wts = torch.empty(n, device=dev) if si.samples else None
  y = torch.empty(n, pack.width, device=dev, dtype=cdt) if out_y else None
  mat, sg, gm = ki.tables
  with torch.cuda.device(dev):
    err = lib.refnerf_trunk_fwd(
        1 if cdt == torch.bfloat16 else 0, pack.width, hc,
        _ptr(ki.x0), d0, _ptr(ki.x1), d1,
        n, pack.kin, pack.depth, pack.skip, _ptr(pack.w), _ptr(pack.wt),
        _ptr(pack.b), _ptr(pack.wd), _ptr(pack.wh), _ptr(pack.bh), hf,
        _ptr(pack.wc), _ptr(pack.bc), _ptr(fold), nb or 0, _ptr(sig),
        _ptr(hout), _ptr(cout), _ptr(u), _ptr(ki.g), _ptr(ki.v), _ptr(ki.k),
        ki.p, ki.lmax, int(ki.geo), _ptr(mat), _ptr(sg), _ptr(gm),
        _ptr(rawd), _ptr(rawt), _ptr(rgb), premult, rbias, pad,
        _ptr(si.lm), _ptr(si.lv), _ptr(si.delta), _ptr(si.bsig), si.samples,
        _ptr(wts), _ptr(y), torch.cuda.current_stream(dev).cuda_stream)
  _check_launch(err, 'trunk forward kernel')
  return [t for t in (y, sig, hout, cout, u, rgb, wts) if t is not None]


def trunk_backward_kernel(segs, pack: TrunkPack, cots, fold=None,
                          needs_dx=False, slab=BWD_SLAB,
                          dir_modes: Optional[DirModes] = None, rgbx=None,
                          rgb_bar=None, spa_modes: Optional[SpaModes] = None,
                          comp=None, ybar=None):
  """Launch the CUDA backward kernels (K4, K5; K8-K10 with `dir_modes`, K6
  and K7 with `spa_modes`, K11 with `ybar`); returns what
  `trunk_backward_reference` returns.

  Per slab of samples: the per-tile kernel recomputes the trunk and runs the
  inner chain, the head backward, the first-order reverse and (with the
  cotangent of u) the tangent chain, writing each layer's weight-gradient
  operands feature-major into a scratch buffer and per-tile sums of the
  vector gradients; then a split-K product over samples forms each weight
  gradient's partials, and fixed-order reductions sum them (no atomics: the
  result does not depend on the schedule). With K6 a slab holds whole rays.
  """
  dm = dir_modes or DirModes()
  sp = spa_modes or SpaModes()
  sbar, hbar, cbar, ubar, *wbar = cots
  hc = 0 if pack.wc is None else int(pack.wc.shape[0])
  _instance_guard(pack, hc, fold, dm, sp, ybar is not None)
  lib = _library('trunk_bwd', pack, hc)
  cdt = DTYPES[pack.compute_dtype]
  seg_dtypes = [s.dtype for s in segs]
  ki, si = _launch_inputs(segs, pack, dm, sp, comp, fold)
  dev, n, d0, d1 = segs[0].device, int(segs[0].shape[0]), ki.d0, ki.d1
  W, L, kin = pack.width, pack.depth, pack.kin
  hf = 0 if pack.wh is None else int(pack.wh.shape[0])
  dg = ubar is not None
  if dg and (fold is None or not d1 or ki.p or pack.wd is None):
    raise ValueError('the cotangent of u needs the density head, two IPE '
                     'segments and the scale fold')
  if (dg or si.lm is not None or si.samples) and needs_dx:
    raise NotImplementedError('the backward kernel emits segment cotangents '
                              'only without the density gradient and the '
                              'fused spatial stages')
  if ki.p and not needs_dx:
    raise NotImplementedError('the fused IDE backward comes with needs_dx')
  nb = int(fold.shape[1]) if dg else 0
  fold = fold.float().contiguous() if dg else None
  if si.lm is not None:
    fold, nb = si.fold, int(si.fold.shape[1])
  sig = wb = None
  if si.samples:
    sig = comp[2].float().reshape(n).contiguous()
    wb = (wbar[0].float().reshape(n).contiguous()
          if wbar and wbar[0] is not None else torch.zeros(n, device=dev))
  rows_of = lambda t, w: None if t is None else (
      t.float().reshape(n, w).contiguous())
  sbar = rows_of(sbar, 1) if pack.wd is not None else None
  hbar = rows_of(hbar, hf) if hf else None
  ubar = rows_of(ubar, nb) if dg else None
  cbar = (cbar.to(cdt).reshape(n, hc).contiguous()
          if cbar is not None and hc else None)
  if ybar is not None:
    ybar = ybar.to(cdt).reshape(n, W).contiguous()
  rawd, rawt, (premult, rbias, pad) = _rgbe_inputs(dm, rgbx, pack, n)
  rgbe = rawd is not None
  if rgbe:
    rgb_bar = (torch.zeros(n, 3, device=dev) if rgb_bar is None
               else rows_of(rgb_bar, 3))
  drawd, drawt = ((torch.empty(n, 3, device=dev), torch.empty(n, 3, device=dev))
                  if rgbe else (None, None))

  k_pack = pack.k_dims()
  fin = sum(pack.seg_dims)
  k_out = [fin if l == 0 else W + (fin if l == pack.skip else 0)
           for l in range(L)]
  dws = [torch.empty(W, k, device=dev) for k in k_out]
  dwc = torch.empty(hc, W, device=dev) if hc else None
  # The vector gradients, one f32 row: db [L, W] | dwd [W] | dwh [hf, W] |
  # dbh [hf] | dbc [hc] | d bsig [1] (K6).
  nvec = (L * W + (W if pack.wd is not None else 0) + hf * W + hf + hc
          + int(si.samples > 0))
  vec = torch.empty(nvec, device=dev)
  dx0 = dx1 = ddg = ddk = None
  if needs_dx:
    dx0 = torch.empty(n, d0, device=dev, dtype=cdt)
    dx1 = torch.empty(n, d1, device=dev, dtype=cdt) if d1 else None
    if ki.p:
      ddg, ddk = torch.empty(n, 3, device=dev), torch.empty(n, 1, device=dev)

  whole = ray_rows(si.samples) if si.samples else _TILE
  slab = n if n <= slab else slab // whole * whole
  rp_max = -(-slab // _TILE) * _TILE
  # Scratch, feature-major [features][rows], rows padded to the tile:
  # h_l and zeta_l (and s_l, p_l with the density gradient) [L][W], the
  # padded input x (and its tangent ts) [kin], cbar [hc].
  regions = [('hs', L * W), ('zs', L * W)]
  regions += [('ss', L * W), ('ps', L * W)] if dg else []
  regions += [('xs', kin)] + ([('ts', kin)] if dg else [])
  regions += [('cs', hc)] if hc else []
  scratch = torch.empty(sum(f for _, f in regions) * rp_max, device=dev,
                        dtype=cdt)
  dx_keep = torch.empty(rp_max * kin, device=dev) if needs_dx else None
  vec_part = torch.empty(rp_max // _TILE * nvec, device=dev)
  wpart = torch.empty(-(-rp_max // _KSPLIT) * W * max(max(k_pack), W),
                      device=dev)
  es = scratch.element_size()
  stream = torch.cuda.current_stream(dev).cuda_stream
  flag = 1 if cdt == torch.bfloat16 else 0
  mat, sg, gm = ki.tables

  def at(t, row, width):
    return None if t is None else t.data_ptr() + row * width * t.element_size()

  with torch.cuda.device(dev):
    for start in range(0, n, slab):
      rows = min(slab, n - start)
      rp = -(-rows // _TILE) * _TILE
      reg, off = {}, 0
      for name, feats in regions:
        reg[name] = scratch.data_ptr() + off * rp * es
        off += feats
      layer = lambda name, l: reg[name] + l * W * rp * es
      err = lib.refnerf_trunk_bwd(
          flag, W, hc, at(ki.x0, start, d0), d0, at(ki.x1, start, d1), d1,
          rows, kin, L, pack.skip, _ptr(pack.w), _ptr(pack.wt), _ptr(pack.b),
          _ptr(pack.wd), _ptr(pack.wh), _ptr(pack.bh), hf, _ptr(pack.wct),
          at(sbar, start, 1), at(hbar, start, hf), at(cbar, start, hc),
          at(ubar, start, nb), _ptr(fold), nb, at(dx0, start, d0),
          at(dx1, start, d1), _ptr(dx_keep), rp, reg['hs'], reg['zs'],
          reg.get('ss'), reg.get('ps'), reg['xs'], reg.get('ts'),
          reg.get('cs'), vec_part.data_ptr(), nvec, at(ki.g, start, 3),
          at(ki.v, start, 3), at(ki.k, start, 1), ki.p, ki.lmax, int(ki.geo),
          _ptr(mat), _ptr(sg), _ptr(gm), at(ddg, start, 3), at(ddk, start, 1),
          at(rawd, start, 3), at(rawt, start, 3), at(rgb_bar, start, 3),
          at(drawd, start, 3), at(drawt, start, 3), premult, rbias, pad,
          at(si.lm, start, nb), at(si.lv, start, nb), at(si.delta, start, 1),
          _ptr(si.bsig), at(sig, start, 1), at(wb, start, 1), si.samples,
          at(ybar, start, W), stream)
      _check_launch(err, 'trunk backward kernel')
      acc = int(start > 0)
      nsplit = -(-rp // _KSPLIT)
      for l in range(L):
        ncut = 0 if l == 0 else W
        err = lib.refnerf_wgrad(
            flag, W, k_pack[l], ncut, rp, _KSPLIT, layer('zs', l),
            reg['xs'] if l == 0 else layer('hs', l - 1), reg['xs'],
            layer('ss', l) if dg else None,
            (reg['ts'] if l == 0 else layer('ps', l - 1)) if dg else None,
            reg.get('ts'), wpart.data_ptr(), stream)
        _check_launch(err, 'weight-gradient kernel')
        err = lib.refnerf_reduce(wpart.data_ptr(), nsplit, W, k_pack[l],
                                 k_out[l], dws[l].data_ptr(), acc, stream)
        _check_launch(err, 'reduction kernel')
      if hc:
        err = lib.refnerf_wgrad(flag, hc, W, W, rp, _KSPLIT, reg['cs'],
                                layer('hs', L - 1), None, None, None, None,
                                wpart.data_ptr(), stream)
        _check_launch(err, 'weight-gradient kernel')
        err = lib.refnerf_reduce(wpart.data_ptr(), nsplit, hc, W, W,
                                 dwc.data_ptr(), acc, stream)
        _check_launch(err, 'reduction kernel')
      err = lib.refnerf_reduce(vec_part.data_ptr(), rp // _TILE, 1, nvec,
                               nvec, vec.data_ptr(), acc, stream)
      _check_launch(err, 'reduction kernel')

  off = 0

  def take(size, shape):
    nonlocal off
    out = vec[off:off + size].reshape(shape)
    off += size
    return out

  dbs = list(take(L * W, (L, W)))
  dwd = take(W, (1, W)) if pack.wd is not None else None
  dwh = take(hf * W, (hf, W)) if hf else None
  dbh = take(hf, (hf,)) if hf else None
  dbc = take(hc, (hc,)) if hc else None
  dbsig = take(1, (1,)) if si.samples else None
  dxs = None
  if needs_dx:
    mid = ([] if not ki.p else [ddg, None, ddk] if ki.geo else [ddg, ddk])
    dxs = [dx0] + mid + ([dx1] if dx1 is not None else [])
    dxs = [None if d is None else d.to(dt) for d, dt in zip(dxs, seg_dtypes)]
  return (dws, dbs, dwd, dwh, dbh, dwc, dbc, dxs,
          (drawd, drawt) if rgbe else None, dbsig)


class _Spec(NamedTuple):
  """What one trunk call is: static for the autograd Functions."""
  depth: int
  skip_period: int
  compute_dtype: str
  kernel: bool                 # launch the CUDA kernels
  pack: Optional[TrunkPack]
  fold: Optional[torch.Tensor]  # [F, nb]: emit u (spatial)
  has: Tuple[bool, ...]        # y (K11), wd, head_f32, head_cdt present
  needs_dx: bool
  dir_modes: DirModes = DirModes()
  spa_modes: SpaModes = SpaModes()


def _unflatten(spec: _Spec, params):
  L = spec.depth
  ws, bs = list(params[:L]), list(params[L:2 * L])
  wd, wh, bh, wc, bc = params[2 * L:]
  return ws, bs, wd, (wh, bh) if spec.has[2] else None, \
      (wc, bc) if spec.has[3] else None


def _count(which, spec: _Spec):
  """One launch of kernel `which`, also counted under each fused mode."""
  launches[which] += 1
  dm, sp = spec.dir_modes, spec.spa_modes
  for k, on in (('K6', sp.samples), ('K7', sp.scales), ('K8', dm.ide_deg),
                ('K9', dm.geo), ('K10', dm.rgbe), ('K11', spec.has[0])):
    if on:
      launches[k] += 1


def _forward(spec: _Spec, segs, params, which, rgbx=None, comp=None):
  ws, bs, wd, head_f32, head_cdt = _unflatten(spec, params)
  kw = dict(dir_modes=spec.dir_modes, rgbx=rgbx, spa_modes=spec.spa_modes,
            comp=comp, out_y=spec.has[0])
  if spec.kernel:
    outs = trunk_kernel(segs, spec.pack, spec.fold, **kw)
    _count(which, spec)
    return outs
  return trunk_reference(segs, ws, bs, skip_period=spec.skip_period, wd=wd,
                         head_f32=head_f32, head_cdt=head_cdt,
                         compute_dtype=spec.compute_dtype,
                         density_grad=spec.fold is not None, fold=spec.fold,
                         **kw)


def _backward(spec: _Spec, segs, params, grads, which, rgbx=None, comp=None):
  """Parameter, segment, epilogue-input and bsig gradients from the output
  cotangents."""
  ws, bs, wd, head_f32, head_cdt = _unflatten(spec, params)
  grads = list(grads)
  ybar, *cots = [grads.pop(0) if h else None for h in spec.has]
  ubar = grads.pop(0) if spec.fold is not None else None
  rgb_bar = grads.pop(0) if spec.dir_modes.rgbe is not None else None
  wbar = grads.pop(0) if spec.spa_modes.samples else None
  cots = (*cots, ubar, wbar)
  kw = dict(dir_modes=spec.dir_modes, rgbx=rgbx, rgb_bar=rgb_bar,
            spa_modes=spec.spa_modes, comp=comp, ybar=ybar)
  if spec.kernel:
    res = trunk_backward_kernel(segs, spec.pack, cots, spec.fold,
                                spec.needs_dx, **kw)
    _count(which, spec)
  else:
    res = trunk_backward_reference(
        segs, ws, bs, cots, skip_period=spec.skip_period, wd=wd,
        head_f32=head_f32, head_cdt=head_cdt,
        compute_dtype=spec.compute_dtype, fold=spec.fold,
        needs_dx=spec.needs_dx, **kw)
  dws, dbs, dwd, dwh, dbh, dwc, dbc, dxs, drgbx, dbsig = res
  cast = lambda g, p: None if (g is None or p is None) else g.to(p.dtype)
  pg = [cast(g, p) for g, p in zip(dws + dbs, ws + bs)]
  pg += [cast(dwd, wd),
         cast(dwh, head_f32[0] if head_f32 else None),
         cast(dbh, head_f32[1] if head_f32 else None),
         cast(dwc, head_cdt[0] if head_cdt else None),
         cast(dbc, head_cdt[1] if head_cdt else None)]
  return pg, dxs, drgbx, dbsig


class SpatialTrunk(torch.autograd.Function):
  """The spatial trunk: forward K1 (K3 with the density gradient), backward
  K4; with the spec's SpaModes also K6 and K7 in both, with y out (the
  spec's has[0]) also K11. Inputs (spec, a, b, delta, bsig, *params): (a,
  b) the IPE segments (xs, xc), or with K7 the lifted means and variances
  (lm, lv), which take no gradient; delta [n] and bsig [1] with K6, else
  None, of which bsig takes a gradient. K6's backward reads the forward's
  sigma, saved here."""

  @staticmethod
  def forward(ctx, spec, a, b, delta, bsig, *params):
    comp = (delta, bsig) if spec.spa_modes.samples else None
    outs = _forward(spec, [a, b], params,
                    'K1' if spec.fold is None else 'K3', comp=comp)
    ctx.spec = spec
    sig = outs[int(spec.has[0])]
    ctx.save_for_backward(a, b, *(comp + (sig,) if comp else ()),
                          *[p for p in params if p is not None])
    ctx.present = [p is not None for p in params]
    return tuple(outs)

  @staticmethod
  @once_differentiable
  def backward(ctx, *grads):
    a, b, *saved = ctx.saved_tensors
    comp = None
    if ctx.spec.spa_modes.samples:
      comp, saved = tuple(saved[:3]), saved[3:]
    params = [saved.pop(0) if p else None for p in ctx.present]
    pg, _, _, dbsig = _backward(ctx.spec, [a, b], params, grads, 'K4',
                                comp=comp)
    return (None, None, None, None, dbsig, *pg)


class DirectionalTrunk(torch.autograd.Function):
  """The directional trunk: forward K2, backward K5 with segment
  cotangents; with the spec's DirModes also K8-K10 in both. Inputs (spec,
  n_segs, *segs, *params, *rgbx), rgbx = (raw diffuse, raw tint) with the
  colour epilogue, else empty."""

  @staticmethod
  def forward(ctx, spec, n_segs, *args):
    n_par = 2 * spec.depth + 5
    segs = list(args[:n_segs])
    params = args[n_segs:n_segs + n_par]
    rgbx = list(args[n_segs + n_par:]) or None
    ctx.spec, ctx.n_segs = spec, n_segs
    ctx.save_for_backward(*segs, *[p for p in params if p is not None],
                          *(rgbx or []))
    ctx.present = [p is not None for p in params]
    return tuple(_forward(spec, segs, params, 'K2', rgbx))

  @staticmethod
  @once_differentiable
  def backward(ctx, *grads):
    saved = list(ctx.saved_tensors)
    segs, saved = saved[:ctx.n_segs], saved[ctx.n_segs:]
    params = [saved.pop(0) if p else None for p in ctx.present]
    rgbx = saved or None
    pg, dxs, drgbx, _ = _backward(ctx.spec, segs, params, grads, 'K5',
                                  rgbx)
    return (None, None, *(dxs or [None] * len(segs)), *pg, *(drgbx or []))


def _params(weights, biases, wd, head_f32, head_cdt):
  wh, bh = head_f32 if head_f32 is not None else (None, None)
  wc, bc = head_cdt if head_cdt is not None else (None, None)
  return [*weights, *biases, wd, wh, bh, wc, bc]


def _needs_grad(tensors):
  return torch.is_grad_enabled() and any(
      t is not None and t.requires_grad for t in tensors)


def fused_encoded_trunk(lm, lv, scales, weights, biases, wd, bd=None, *,
                        skip_period=4, density_grad=False,
                        head_f32: Optional[Head] = None,
                        head_cdt: Optional[Head] = None,
                        compute_dtype='float32', mode='auto',
                        activation=None, pack: Optional[TrunkPack] = None,
                        in_kernel_trig=False, delta=None, act_bias=0.0,
                        out_y=False):
  """K1/K3 forward, K4 backward: the IPE trunk of lifted means/vars
  lm, lv [..., nb] (:1326). lm and lv enter detached (:1396-1397).

  `pack` is the kernels' weight layout (pack_trunk); the MLP caches it.
  Without one the kernel path packs on every call.

  `in_kernel_trig` (K7): the kernels make the IPE from lm and lv, and the
  density gradient's fold and its second-order tangent take the f32 trig
  factors (SpaModes). `delta` (K6): the per-sample [..., S] t-interval
  length times |direction| of rays of S consecutive samples; the kernels
  then also emit the compositing weights of
  sigma = softplus(raw + bd + act_bias) (:1352-1360). delta takes no
  gradient; bd takes the weights' through bsig = bd + act_bias, a device
  tensor. `out_y` (K11): also return the trunk's last activation y, in the
  compute dtype; its cotangent enters the backward.

  Returns ([y [..., width],] sigma [...], [h_f32 [..., hf],]
  [h_cdt [..., hc],] [u [..., nb],] [weights [...]]), in the Pallas order
  (:1456-1472), sigma with `bd` added (:1460), u = d sigma / d lm with
  `density_grad`.
  """
  lead = lm.shape[:-1]
  nb = lm.shape[-1]
  n = math.prod(lead)
  _check_trunk(len(weights), skip_period)
  lm2, lv2 = (t.detach().reshape(n, nb).float().contiguous() for t in (lm, lv))
  params = _params(weights, biases, wd, head_f32, head_cdt)
  kernel = use_kernel(lm2, mode)
  if kernel:
    _kernel_guard(activation)
  if delta is not None and wd is None:
    raise ValueError('the compositing epilogue needs the density head')
  if not (activation is None or activation in (torch.relu, F.relu)):
    if density_grad or delta is not None or _needs_grad(params):
      raise NotImplementedError('the trunk backward, the density gradient '
                                'and the compositing epilogue model ReLU '
                                'only')
    outs = trunk_reference(list(encode_ipe(lm2, lv2, scales, compute_dtype)),
                           weights, biases, skip_period=skip_period,
                           wd=wd, head_f32=head_f32, head_cdt=head_cdt,
                           compute_dtype=compute_dtype, activation=activation,
                           out_y=out_y)
  else:
    spa = SpaModes(tuple(float(s) for s in scales) if in_kernel_trig else (),
                   0 if delta is None else int(delta.shape[-1]))
    segs = ([lm2, lv2] if in_kernel_trig
            else list(encode_ipe(lm2, lv2, scales, compute_dtype)))
    if kernel and pack is None:
      f = nb * len(scales)
      pack = pack_trunk(weights, biases, (f, f), skip_period=skip_period,
                        wd=wd, head_f32=head_f32, head_cdt=head_cdt,
                        compute_dtype=compute_dtype)
    fold = None
    if density_grad:
      fold = _scale_fold(tuple(float(s) for s in scales), nb, lm2.device)
    dcol = bsig = None
    if spa.samples:
      dcol = delta.detach().float().reshape(n).contiguous()
      bsig = (torch.zeros(1, device=lm2.device) if bd is None
              else bd.float().reshape(1)) + float(act_bias)
    spec = _Spec(len(weights), skip_period, compute_dtype, kernel,
                 pack if kernel else None, fold,
                 (bool(out_y), wd is not None, head_f32 is not None,
                  head_cdt is not None),
                 False, spa_modes=spa)
    outs = list(SpatialTrunk.apply(spec, *segs, dcol, bsig, *params))
  wts = outs.pop() if delta is not None else None
  res = [outs.pop(0).reshape(*lead, -1)] if out_y else []
  sig = outs[0] if bd is None else outs[0] + bd.float()
  res.append(sig.reshape(lead))
  res += [o.reshape(*lead, o.shape[-1]) for o in outs[1:]]
  if wts is not None:
    res.append(wts.reshape(lead))
  return tuple(res)


def fused_trunk(segs: Sequence, weights, biases, head_f32: Head, *,
                skip_period=4, compute_dtype='float32', mode='auto',
                activation=None, pack: Optional[TrunkPack] = None,
                ide_deg=0, ide_at=0, ide_geo=False, rgb_epilogue=None):
  """K2 forward, K5 backward: a trunk over input segments [..., d_j] and its
  f32 head (:1178-1314), with segment cotangents in the compute dtype.

  With `ide_deg` (K8), segs[ide_at] is the tuple of the IDE's raw inputs,
  (refdirs [..., 3], kappa_inv [..., 1]); with `ide_geo` (K9) it is
  (grad_pred [..., 3], viewdirs [..., 3], kappa_inv [..., 1]) and n.v
  follows the IDE in the trunk input. Their cotangents come out in f32, the
  viewdirs' as None. `rgb_epilogue` (K10) is (raw_diffuse [..., 3],
  raw_tint [..., 3], rgb_premultiplier, rgb_bias, rgb_padding): the colour
  epilogue runs after the rgb head, which `head_f32` must be.

  Returns the head output [..., hf], or (head output, rgb [..., 3]) with
  `rgb_epilogue`. `pack` as for fused_encoded_trunk.
  """
  segs, dm = _dir_segments(segs, ide_deg, ide_at, ide_geo)
  rgbx = []
  if rgb_epilogue is not None:
    rawd, rawt, premult, bias, pad = rgb_epilogue
    dm = dm._replace(rgbe=(float(premult), float(bias), float(pad)))
  lead = segs[0].shape[:-1]
  n = math.prod(lead)
  _check_trunk(len(weights), skip_period)
  cdt = DTYPES[compute_dtype]
  raw = range(dm.ide_at, dm.ide_at + dm.n_raw())
  flat = [s.reshape(n, s.shape[-1]) for s in segs]
  flat = [s.float() if j in raw else s.to(cdt) for j, s in enumerate(flat)]
  if rgb_epilogue is not None:
    rgbx = [rawd.reshape(n, 3).float(), rawt.reshape(n, 3).float()]
  params = _params(weights, biases, None, head_f32, None)
  kernel = use_kernel(flat[0], mode)
  if kernel:
    _kernel_guard(activation)
  if not (activation is None or activation in (torch.relu, F.relu)):
    if _needs_grad(flat + params + rgbx):
      raise NotImplementedError('the trunk backward models ReLU only')
    outs = trunk_reference(flat, weights, biases, skip_period=skip_period,
                           head_f32=head_f32, compute_dtype=compute_dtype,
                           activation=activation, dir_modes=dm, rgbx=rgbx)
  else:
    if kernel and pack is None:
      pack = pack_trunk(weights, biases, visible_dims(flat, dm),
                        skip_period=skip_period, head_f32=head_f32,
                        compute_dtype=compute_dtype)
    spec = _Spec(len(weights), skip_period, compute_dtype, kernel,
                 pack if kernel else None, None, (False, False, True, False),
                 True, dm)
    outs = DirectionalTrunk.apply(spec, len(flat), *flat, *params, *rgbx)
  outs = [o.reshape(*lead, o.shape[-1]) for o in outs]
  return outs[0] if len(outs) == 1 else tuple(outs)
