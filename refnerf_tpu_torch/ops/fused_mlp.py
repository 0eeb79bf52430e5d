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

Kernels (`csrc/trunk_fwd_tma.cu` (bf16), `csrc/trunk_fwd_f32.cu` (f32) or
`csrc/trunk_fwd.cu` by dtype and shape, `forward_library`: K1-K3, K6-K11,
f32 K11 in trunk_fwd.cu;
`csrc/trunk_bwd_tma.cu` (bf16), `csrc/trunk_bwd_f32.cu` (f32) or
`csrc/trunk_bwd.cu` by dtype and shape, `backward_library`: K4-K11), at
width 256 and,
for the directional trunk, 128; the spatial trunk at width 1024 with the
256-wide head (`w1024`) layer by layer on `csrc/trunk_w1024.cu` (K1 and
first-order K4; wgmma in bf16, three TF32 passes of wgmma in f32),
`_w1024_forward` and `_w1024_backward`; the depth-1 directional trunk of
`dir1` (mip-NeRF 360's, on 256 + 27 columns) on `csrc/trunk_dir1.cu` (K2
and K5 with dx; wgmma fed by TMA and bulk copies, three TF32 passes in
f32; its weight gradient on trunk_w1024.cu's product), `_dir1_forward` and
`_dir1_backward`; the f32 K3 and K1 of the wide-input spatial trunk with the
256-wide head (`wide_tf32`, the JAX package's default MLP), and K1 of the
same trunk with the density head alone (mip-NeRF 360's proposal MLP), on
`csrc/trunk_wide_tf32.cu` (three TF32 passes of wgmma, the weights laid out
as panels by `tf32_panel_index`), `_wide_tf32_forward`, their K4
(`wide_tf32_bwd`) on `csrc/trunk_wide_bwd_tf32.cu`, `_wide_tf32_backward`;
all run for CUDA tensors unless `mode='off'`. A CPU
tensor or `mode='off'` takes the plain PyTorch versions, `trunk_reference` and `trunk_backward_reference`,
written in the Pallas kernels' order of operations and casts:

    h = relu(cdt(f32 sum of segment/activation products) + cdt(bias))
    sigma = f32(y) @ wd,  hf = f32(y) @ wh + bh,  hc = cdt(y @ wc) + cdt(bc)

For a CUDA tensor a wrapper launches its kernel or raises; it never falls
back to the plain version. Each launch through a wrapper adds one to
`launches[K]`. The forward launch is a PyTorch operator,
`refnerf_tpu_torch::trunk_forward` (`launch_trunk`), so that
`torch.export` records it and a loaded program (serving.py) runs and
counts it: `trunk_kernel` for CUDA tensors, counted where it launches;
`trunk_plain` for CPU ones, which launches nothing and is not counted.
"""

from __future__ import annotations

import functools
import logging
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

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
_TILE = 64  # samples per tile of the trunk kernels (a CTA holds one or two)
# Rows per slab of the backward kernels at width 256: the per-sample
# operands of the weight-gradient products (compute dtype; feature-major, or
# sample-major for csrc/trunk_bwd_tma.cu and csrc/trunk_bwd_f32.cu) are
# kept for one slab at a time, about 1.1 GB for the spatial trunk in bf16
# and 2.2 GB in f32. The width-128 trunk takes four times the rows a slab
# and the width-1024 trunk twice (`bwd_slab_rows`): fewer launches of the
# former's small weight-gradient and reduction kernels; the latter's
# recomputed activations, 2 GiB in bf16 and 4 GiB in f32.
BWD_SLAB = 65536
# Samples per partial sum of the weight-gradient kernel: trunk_bwd.cu's
# (128 x 128 tiles, each operand read twice), and trunk_bwd_tma.cu's, whose
# 2048 give 32 partials a slab (half the reduction's reads) and 128 CTAs for
# a 256 x 256 gradient. trunk_bwd_f32.cu's split, and trunk_bwd_tma.cu's
# for the width-128 trunk's 128-row gradients, is chosen per gradient
# (`_wgrad_split`): as many splits as fill the card's SMs once.
_KSPLIT = 1024
_KSPLIT_TMA = 2048
# The trunk_fwd_tma.cu, trunk_fwd_f32.cu, trunk_bwd_tma.cu and
# trunk_bwd_f32.cu kernels take at most this many layers (a tensor map a
# layer in the launch's parameters) and input columns (one input tile), the
# forwards also at most _TMA_HEADS f32 heads; a width-256 or width-128 trunk
# past them runs trunk_fwd.cu's and trunk_bwd.cu's instances.
_TMA_DEPTH = 8
_TMA_KIN = 256
_TMA_HEADS = 16
# The wide-input instances (width 256, the density head, f32 heads and a
# compute-dtype head of _WIDE_HEADS, the density gradient on at most
# _WIDE_NB basis vectors: `wide_input`) of trunk_fwd_f32.cu and
# trunk_bwd_f32.cu (f32) and of trunk_fwd_tma.cu and trunk_bwd_tma.cu (bf16)
# take past _TMA_KIN up to this many input columns, streamed in chunks of
# columns: _CHUNK in f32, _WIDE_CHUNK in bf16.
_WIDE_KIN = 1024
_CHUNK = 128
_WIDE_CHUNK = 128
_WIDE_HEADS = (0, 128, 256)
_WIDE_NB = 32  # kMaxNbWide in csrc/trunk_fwd_args.cuh and trunk_bwd_args.cuh
# The library of each direction's TMA kernels, by compute dtype.
FWD_LIBRARY = {'bfloat16': 'trunk_fwd_tma', 'float32': 'trunk_fwd_f32'}
BWD_LIBRARY = {'bfloat16': 'trunk_bwd_tma', 'float32': 'trunk_bwd_f32'}
# The width-1024 spatial trunk (mip-NeRF 360's NeRF MLP: `w1024`) runs
# layer by layer on csrc/trunk_w1024.cu, forward and backward, in both
# dtypes: the density head and the 256-wide compute-dtype head, no f32
# head, on at most _WIDE_KIN input columns. Its backward recomputes the
# activations per slab (`bwd_slab_rows`) and splits each weight gradient's
# sum over rows into partials (`w1024_splits`).
W1024, W1024_HEAD = 1024, 256
W1024_LIBRARY = 'trunk_w1024'
_W1024_COLSUM_ROWS = 2048  # rows a CTA of a column sum takes
_WIDE_COLSUM_ROWS = 256  # the same in the f32 wide-input backward (dwd)
# The depth-1 width-128 directional trunk on [bottleneck 256 | at most
# DIR1_D1 columns] with an f32 head of at most DIR1_HEADS outputs alone
# (mip-NeRF 360's, and any Model left at the MLP's defaults: `dir1`) runs on
# csrc/trunk_dir1.cu in both dtypes and both directions. Its backward's
# head partials are DIR1_PARTS floats a CTA (dwh [3][128] | dbh [3]); its
# layer's weight gradient is trunk_w1024.cu's product over rows.
DIR1_LIBRARY = 'trunk_dir1'
DIR1_D0, DIR1_D1, DIR1_HEADS = 256, 29, 3
DIR1_PARTS = DIR1_HEADS * 128 + DIR1_HEADS
# The f32 forward (K3 with the density gradient, and K1) of the wide-input
# spatial trunk with the 256-wide compute-dtype head and no f32 head
# (`wide_tf32`: the JAX package's default MLP), and K1 of the same trunk
# with the density head alone (mip-NeRF 360's proposal MLP), runs on
# csrc/trunk_wide_tf32.cu, three TF32 passes of wgmma over its weights laid
# out as 256 x 256 panels (`tf32_panel_index`).
WIDE_TF32_LIBRARY = 'trunk_wide_tf32'
# The bf16 K3 of the same trunk (`wide_bf16`) runs on
# csrc/trunk_wide_bf16.cu: 128-row tiles on one bf16 pass of wgmma over the
# pack's own weights, the fold three TF32 passes against its panel
# (`bf16_fold_index`).
WIDE_BF16_LIBRARY = 'trunk_wide_bf16'
# The f32 backward (K4, first order and with u's cotangent; at the density
# head alone first order) of the same trunk (`wide_tf32_bwd`: the density
# gradient's fold not needed) runs on
# csrc/trunk_wide_bwd_tf32.cu, three TF32 passes of wgmma over its own
# panels (`tf32_bwd_panel_index`), its weight gradients on trunk_w1024.cu's
# f32 tn product (`_wide_tf32_backward`).
WIDE_TF32_BWD_LIBRARY = 'trunk_wide_bwd_tf32'
# Shared memory a CTA may use on an H100 (227 KB): a launch that needs more
# is refused by its C entry (cudaErrorInvalidConfiguration).
SMEM_LIMIT = 232448

# Launches through the wrappers, by kernel: K1 spatial forward, K2
# directional forward, K3 spatial forward with the density gradient, K4
# spatial backward, K5 directional backward. A launch of K1, K3 or K4 with
# fused spatial stages also counts under each stage it runs: K6 the
# compositing weights, K7 the IPE. A launch of K2 or K5 with fused
# directional stages likewise: K8 the IDE, K9 the direction geometry, K10
# the colour epilogue. A launch of K1 or K4 with the trunk's features out
# (y, and its cotangent back) also counts under K11. A launch of K1, K3 or K4
# on the wide-input instances (`wide_input`) also counts under 'K1 wide',
# 'K3 wide' or 'K4 wide', on the width-1024 instances (`w1024`) under 'K1
# w1024' or 'K4 w1024'.
launches = {'K1': 0, 'K2': 0, 'K3': 0, 'K4': 0, 'K5': 0, 'K6': 0, 'K7': 0,
            'K8': 0, 'K9': 0, 'K10': 0, 'K11': 0, 'K1 wide': 0, 'K3 wide': 0,
            'K4 wide': 0, 'K1 w1024': 0, 'K4 w1024': 0}

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


def _forward_acts(t: _Trunk, segs):
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
    h = torch.relu(hb.to(t.cdt) + b)
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
    density_grad: also run the inner chain (needs wd).
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
  dm = dir_modes or DirModes()
  sp = spa_modes or SpaModes()
  trig = None
  if sp.scales:
    segs, trig = _spatial_segments(segs, sp, cdt)
  else:
    segs = dir_segments(segs, dm, cdt)
  t = _trunk(weights, biases, [s.shape[-1] for s in segs], skip_period, cdt)
  acts = _forward_acts(t, segs)
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
    if wd is None:
      raise NotImplementedError('the density gradient needs the density '
                                'head')
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
  acts = _forward_acts(t, segs)
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


def _ptr(t):
  return None if t is None else t.data_ptr()


def _library(name: str, pack: TrunkPack, hc: int):
  """Library `name`, built on first use; a trunk on at most `_TMA_KIN`
  input columns must be one that trunk_fwd.cu's instances hold (past them
  `missing_instance` has decided)."""
  from refnerf_tpu_torch.ops import cuda_build  # builds on first use
  if pack.kin <= _TMA_KIN and not cuda_build.library(
      'trunk_fwd').refnerf_trunk_supports(pack.width, hc):
    raise NotImplementedError(
        f'no trunk kernel instance for width {pack.width} and compute-dtype '
        f'head {hc} (built: width 256, head 0 or 128; width 128, head 0)')
  return cuda_build.library(name)


def missing_instance(pack: TrunkPack, hc, fold=None, dm: DirModes = DirModes(),
                     sp: SpaModes = SpaModes(),
                     y: bool = False) -> Optional[str]:
  """Why no built kernel instance runs this trunk, or None; decided from
  the pack's shape and the modes alone, before anything is built or
  launched. K11 (y out, ybar in) runs in an instance of its own: the
  spatial trunk at width 256 without the compute-dtype head, the density
  gradient (K3) or a fused stage (K6-K10). Width 256 past `_TMA_KIN` input
  columns runs the spatial trunk of `wide_input`, a 256-wide head and K3
  too. Width 128 runs only the plain
  directional trunk (K2, K5): no density head, density gradient or fused
  stage. Width 1024 runs only the spatial trunk of `w1024` (K1, first-order
  K4): the density head and the 256-wide compute-dtype head alone, on at
  most `_WIDE_KIN` input columns. An instance whose launch needs more
  shared memory than SMEM_LIMIT (`kernel_smem` of the forward's and the
  backward's library) does not run the trunk either."""
  fused = (('the density gradient (K3)', fold is not None),
           ('the compositing weights (K6)', sp.samples),
           ('the in-kernel IPE (K7)', sp.scales),
           ('a fused directional stage (K8-K10)', dm.ide_deg or dm.rgbe))
  modes = ()
  if y:
    what = 'the trunk-features output (K11)'
    modes = ((f'width {pack.width}', pack.width != 256),
             (f'the compute-dtype head ({hc})', hc)) + fused
  elif pack.width == 128:
    what = 'the width-128 trunk'
    modes = (('the density head', pack.wd is not None),) + fused
  elif pack.width == W1024:
    what = 'the width-1024 trunk'
    modes = _w1024_modes(pack, hc, fold, sp) + fused[3:]
  off = [name for name, on in modes if on]
  if off:
    return f'{what} has no kernel with ' + ', '.join(off) + ' (ROADMAP queue 2)'
  if not ((pack.width == 256 and hc in (0, 128)) or
          (pack.width == 128 and hc == 0) or pack.width == W1024 or
          wide_input(pack, y, fold, sp)):
    return (f'no trunk kernel instance for width {pack.width} and '
            f'compute-dtype head {hc} (built: width 256, head 0 or 128; '
            f'width 128, head 0; width {W1024}, head {W1024_HEAD}; width 256 '
            f'on {_TMA_KIN + 1}-{_WIDE_KIN} input columns, head 0, 128 or '
            '256)')
  for lib in (forward_library(pack, y, fold, sp),
              backward_library(pack, y, fold)):
    need = kernel_smem(lib, pack, hc, fold, sp)
    if need is not None and need > SMEM_LIMIT:
      return (f'{lib}.cu needs {need} B of shared memory a CTA for the '
              f'{pack.compute_dtype} trunk of depth {pack.depth} on '
              f'{pack.kin} input columns' +
              (' with the density gradient' if fold is not None else '') +
              f', past the {SMEM_LIMIT} B of an H100')
  return None


def _instance_guard(pack: TrunkPack, hc, fold, dm: DirModes, sp: SpaModes,
                    y: bool):
  """Refuses, before anything is built or launched, what no instance runs
  (`missing_instance`)."""
  why = missing_instance(pack, hc, fold, dm, sp, y)
  if why:
    raise NotImplementedError(why)


def _k7_basis(pack: TrunkPack, sp: SpaModes) -> int:
  """K7's basis vectors (the lifted means' width), 0 without K7."""
  return pack.seg_dims[0] // len(sp.scales) if sp.scales else 0


def kernel_smem(lib: str, pack: TrunkPack, hc: int, fold=None,
                sp: SpaModes = SpaModes()) -> Optional[int]:
  """The dynamic shared memory (bytes) that library `lib`'s launch asks for
  to run `pack` in the modes given (the density gradient with `fold`, K6
  and K7 by `sp`), mirroring the sum of its C launch; the libraries whose
  ring adapts give the bytes at the deepest ring that fits, or at their
  shallowest ring, past SMEM_LIMIT, when none does; the width-1024
  library the largest of its products' CTAs. For trunk_fwd_tma.cu
  and trunk_bwd_tma.cu only their wide-input instances' sums
  (`fwd_wide_smem`, `tma_smem`; 231,480 B and 210,248 B for the PropMLP's
  trunk of depth 4 on 504 columns; with the density gradient of the MLP's
  defaults, 8 layers and 21 basis vectors, 222,648 B and 215,240 B): None
  for their other instances, whose
  largest sums within their shapes (8 layers, 256 input columns, 16 f32
  heads: 228,904 B, K3 with K6 on 1,024-row rays at the 2-stage ring;
  223,624 B; 194,120 B for the two-tile width-128 backward; 230,472 B for
  the two-tile width-128 forward on 256 input columns at the 4-stage ring)
  fit."""
  W, kin, L = pack.width, pack.kin, pack.depth
  hf = 0 if pack.wh is None else int(pack.wh.shape[0])
  dg = fold is not None
  nbd = int(fold.shape[1]) if dg else 0  # the density gradient's basis
  if lib == DIR1_LIBRARY:
    # csrc/trunk_dir1.cu's CTA, both directions: 1 KB to align, the head
    # (wh [3][128], b1 and bh in f32: 2,064 B) and the backward's sums of
    # it (DIR1_PARTS floats a consumer warp: 12,384 B), the mbarriers; bf16
    # `kBSmem`: W1 resident as five [128][64] boxes, 3 stages of a 64-row
    # tile's bottleneck and a 5 KB slot for its span and head cotangents, 7
    # mbarriers (211,112 B); f32 `kFSmem`: 4 stages of three [128][32] f32
    # slots, 8 mbarriers (212,144 B).
    head = 4 * (3 * 128 + 128 + 4) + 4 * 8 * DIR1_PARTS
    if pack.compute_dtype == 'float32':
      return 1024 + 4 * 3 * 128 * 128 + head + 8 * 8
    return 1024 + 5 * 128 * 128 + 3 * (4 * 64 * 128 + 5 * 1024) + head + 8 * 7
  if lib == WIDE_TF32_LIBRARY:
    # csrc/trunk_wide_tf32.cu `smem_bytes`: 1 KB to align, two stages of
    # B's [256][32] f32 hi and lo (64 KB each), the activation tile [64][256]
    # f32, two [64][32] f32 input slots (then each consumer thread's 16
    # sums of u), with the density gradient the relu' bits
    # of all layers but the last, the sigma sums, 4 mbarriers (228,896 B at
    # depth 8; K1 214,560 B, with the density head alone too).
    return (1024 + 2 * 65536 + 4 * _TILE * 256 + 2 * 8192 +
            (8 * (L - 1) * 256 if dg else 0) + 4 * 2 * _TILE + 8 * 4)
  if lib == WIDE_BF16_LIBRARY:
    # csrc/trunk_wide_bf16.cu `smem_bytes`: 1 KB to align, four stages of a
    # [128][64] bf16 slice (16 KB each), two warpgroups' [64][256] bf16
    # activation tiles and two [64][128] input buffers each, the relu' bits
    # of all layers but the last (16 B a consumer thread and layer), 8
    # mbarriers (226,368 B at depth 8).
    return (1024 + 4 * 16384 + 2 * 32768 + 4 * 16384 + 16 * (L - 1) * 256 +
            8 * 8)
  if lib == WIDE_TF32_BWD_LIBRARY:
    # csrc/trunk_wide_bwd_tf32.cu `bwd_smem_bytes`: K3's ring, activation
    # tile, input slots and relu' bits, the ring's 4 mbarriers and ts's
    # (228,392 B at depth 8, 220,200 B at depth 4).
    return (1024 + 2 * 65536 + 4 * _TILE * 256 + 2 * 8192 + 8 * (L - 1) * 256
            + 8 * 5)
  if lib == W1024_LIBRARY:
    # Its products' largest CTA (csrc/trunk_w1024.cu): bf16 the nt
    # product's `kNtSmem` (1 KB to align the swizzled tiles, 3 stages of a
    # [128][64] and a [256][64] slice, the [128][256] staging tile, 8
    # mbarriers: 214,080 B) and the tn product's `kTnSmem` (4 stages, 8
    # mbarriers, the bias sums' two halves of 128 floats: 198,720 B); f32
    # the TF32 nt product's `kF32NtSmem` (4 stages of a [128][32] A slice
    # and B's two [128][32] parts, 8 mbarriers: 197,696 B) and the tn
    # product's `kF32TnSmem` (4 stages of Z's and X's [32][128], two
    # buffers of X^T's two [128][32] parts, 12 mbarriers: 197,728 B).
    if pack.compute_dtype == 'float32':
      return max(1024 + 4 * 3 * 128 * 128 + 8 * 8,
                 1024 + 4 * 2 * 128 * 128 + 2 * 2 * 128 * 128 + 12 * 8)
    stage = (128 + 256) * 64 * 2
    return max(1024 + 3 * stage + 128 * 256 * 2 + 8 * 8,
               1024 + 4 * stage + 8 * 8 + 2 * 128 * 4)
  tiles = ray_rows(sp.samples) // _TILE if sp.samples else 1
  sraw = 4 * tiles * _TILE if sp.samples else 0
  t = 2 if pack.compute_dtype == 'bfloat16' else 4
  pad, ld = 16 // t, _TILE + 4

  def ring(rest, lo, hi, stage=16 * 256 * 4):  # [16][256] f32 slices
    fit = (SMEM_LIMIT - rest) // stage if rest < SMEM_LIMIT else 0
    return rest + max(lo, min(fit, hi)) * stage

  if lib == 'trunk_fwd_tma' and kin > _TMA_KIN:
    # The wide-input instance (`fwd_wide_smem`): the activation tiles and
    # two buffers of chunks (64 KB each; 32 KB each with the density
    # gradient, which runs one tile at a time and adds its relu' bits, u,
    # two warpgroups' u of a product and the fold, its rows padded to a
    # multiple of 8), the deepest ring of [256][64] bf16 slices that fits
    # (4 to 2), then the heads' weights if they fit too.
    nt = 1 if dg else 2
    fold_bytes = 4 * pack.seg_dims[0] * (-(-nbd // 8) * 8)
    rest = (1024 + 2 * nt * 32768 +
            (8 * L * 256 + 4 * 3 * _TILE * nbd + fold_bytes if dg else 0) + 8)
    for stages in (4, 3, 2):
      need = rest + stages * (256 * 128 + 16)
      if need <= SMEM_LIMIT:
        break
    heads = 4 * (1 + hf) * 256
    return need + heads if need + heads <= SMEM_LIMIT else need
  if lib == 'trunk_bwd_tma' and kin > _TMA_KIN:
    # The wide-input instance (`tma_smem`): the 4-stage ring (3 stages and
    # the fold with the density gradient; at the 256-wide head, whose
    # tangent is read back, the fold's rows padded to a multiple of 4 and
    # two more mbarriers), the activation tile, two chunks of _WIDE_CHUNK
    # columns, the relu' masks, the column sums' and the cotangents' rows
    # (u's with the density gradient).
    rb = dg and hc == 256
    stages = 3 if dg else 4
    nbp = -(-nbd // 4) * 4 if rb else nbd
    return (1024 + stages * 256 * 128 + 4 * pack.seg_dims[0] * nbp +
            (4 + 2 * _WIDE_CHUNK // 64) * 8192 + 8 * L * 256 + 4 * 4 * 256 +
            4 * _TILE * (1 + hf + nbd) + 8 + 16 * stages + (16 if rb else 0))
  if lib in ('trunk_fwd_f32', 'trunk_bwd_f32') and kin > _TMA_KIN:
    # The wide-input instances (`fwd_f32_wide_smem`, `f32_wide_smem`): the
    # activation tile and an input chunk of _CHUNK columns, [.][68] f32; the
    # forward's density gradient its relu' bits, u and the fold (its rows
    # padded to a multiple of 8), the backward's the rows of u's cotangent
    # and the fold.
    tiles = 1024 + 4 * (W + _CHUNK) * (_TILE + 4) + 8 + 16 * 8
    if lib == 'trunk_fwd_f32':
      nbp = -(-nbd // 8) * 8
      return ring(tiles + 4 * 4 * 4 * _TILE +
                  (8 * L * 256 + 4 * _TILE * nbd + 4 * pack.seg_dims[0] * nbp
                   if dg else 0), 2, 8)
    return ring(tiles + 8 * L * 256 + 4 * 2 * 256 + 4 * _TILE * (1 + hf + nbd)
                + (4 * pack.seg_dims[0] * nbd if dg else 0), 4, 8)

  if lib == 'trunk_fwd':  # trunk_fwd.cu `launch`
    s = t * (_TILE * (W + pad) + _TILE * (kin + pad) +
             2 * max(W, hc) * (_KS + pad))
    if dg:
      s += 4 * (L * _TILE * (W // 32) + _TILE * kin)
    return s + sraw
  if lib == 'trunk_fwd_f32':  # trunk_fwd_f32.cu `fwd_f32_smem`, R rows a CTA
    rows = 2 * _TILE if W == 128 else _TILE
    rest = (1024 + 4 * (W + kin) * (rows + 4) +
            (8 * L * 256 + 4 * kin * ld if dg else 0) +
            4 * (4 * 4 * _TILE + (3 * _TILE if W == 256 else 0)) + sraw + 8 +
            16 * 8)
    return ring(rest, 2, 8, stage=16 * W * 4)
  nb = int(fold.shape[1]) if dg else _k7_basis(pack, sp)
  if lib == 'trunk_bwd':  # trunk_bwd.cu `launch_bwd`
    return (t * (_TILE * (W + pad) + _TILE * (kin + pad) + 2 * W * (_KS + pad))
            + 4 * (L * _TILE * (W // 32) + _TILE * (1 + hf + nb)))
  if lib == 'trunk_bwd_f32':  # trunk_bwd_f32.cu `f32_smem`, R rows a CTA
    rows = bwd_cta_rows(lib, W)
    rest = (1024 + 4 * (W + kin) * (rows + 4) + 8 * L * 256 + 4 * 512 +
            4 * rows * (1 + hf + nb) + 8 + 16 * 8)
    return ring(rest, 4, 8, stage=16 * W * 4)
  return None


def _w1024_modes(pack: TrunkPack, hc: int, fold=None,
                 sp: SpaModes = SpaModes(), y: bool = False):
  """What of a width-1024 trunk and its modes the width-1024 instances do
  not run, as (what, whether) pairs: `w1024` holds where none is,
  `missing_instance` names those that are."""
  return (('no density head', pack.wd is None),
          ('f32 heads', pack.wh is not None),
          (f'{pack.kin} input columns', pack.kin > _WIDE_KIN),
          (f'compute-dtype head {hc} (built: {W1024_HEAD})',
           hc != W1024_HEAD),
          ('the density gradient (K3)', fold is not None),
          ('the compositing weights (K6)', sp.samples),
          ('the in-kernel IPE (K7)', sp.scales),
          ('the trunk-features output (K11)', y))


def w1024(pack: TrunkPack, y: bool = False, fold=None,
          sp: SpaModes = SpaModes()) -> bool:
  """Whether `pack` runs on the width-1024 instances (csrc/trunk_w1024.cu,
  both dtypes): the spatial trunk at width 1024 with the density head and
  the `W1024_HEAD`-wide compute-dtype head alone, on at most `_WIDE_KIN`
  input columns, without the density gradient, a fused stage or y
  (`_w1024_modes`): mip-NeRF 360's NeRF MLP."""
  hc = 0 if pack.wc is None else int(pack.wc.shape[0])
  return pack.width == W1024 and not any(
      on for _, on in _w1024_modes(pack, hc, fold, sp, y))


def dir1(pack: TrunkPack, y: bool = False, fold=None,
         sp: SpaModes = SpaModes()) -> bool:
  """Whether `pack` runs on csrc/trunk_dir1.cu (both dtypes, both
  directions): one layer of width 128 on two segments, the first of
  `DIR1_D0` (256) columns and the second of at most `DIR1_D1` (29), with
  an f32 head of 1 to `DIR1_HEADS` (3) outputs and no density or
  compute-dtype head, without the density gradient, a fused spatial stage
  or y (`missing_instance` refuses the fused directional stages of a
  width-128 trunk first): the directional trunk of mip-NeRF 360 and of a
  Model at the MLP's defaults, on [bottleneck 256 | positional encoding
  of degree 4, 27]."""
  hf = 0 if pack.wh is None else int(pack.wh.shape[0])
  return (pack.width == 128 and pack.depth == 1 and len(pack.seg_dims) == 2
          and pack.seg_dims[0] == DIR1_D0 and 1 <= pack.seg_dims[1] <= DIR1_D1
          and 1 <= hf <= DIR1_HEADS and pack.wd is None and pack.wc is None
          and not y and fold is None and not (sp.scales or sp.samples))


def wide_input(pack: TrunkPack, y: bool = False, fold=None,
               sp: SpaModes = SpaModes()) -> bool:
  """Whether `pack` runs on the wide-input instances (trunk_fwd_f32.cu and
  trunk_bwd_f32.cu in f32, trunk_fwd_tma.cu and trunk_bwd_tma.cu in bf16):
  the spatial trunk at width 256 within `_TMA_DEPTH` layers on more than
  `_TMA_KIN` and at most `_WIDE_KIN` input columns, with the density head,
  at most `_TMA_HEADS` f32 heads and a compute-dtype head of `_WIDE_HEADS`,
  with or without the density gradient (two IPE segments of equal, even
  width on at most `_WIDE_NB` basis vectors), no fused stage or y: the MLP's
  defaults (8 x 256 on JAX's default encoding, 504 IPE columns, the 256-wide
  bottleneck, density normals) and a proposal MLP on the same encoding."""
  hf = 0 if pack.wh is None else int(pack.wh.shape[0])
  hc = 0 if pack.wc is None else int(pack.wc.shape[0])
  dg = fold is None or (len(pack.seg_dims) == 2 and
                        pack.seg_dims[0] == pack.seg_dims[1] == fold.shape[0]
                        and pack.seg_dims[0] % 2 == 0
                        and fold.shape[1] <= _WIDE_NB)
  return (pack.width == 256 and
          pack.depth <= _TMA_DEPTH and _TMA_KIN < pack.kin <= _WIDE_KIN and
          hf <= _TMA_HEADS and pack.wd is not None and hc in _WIDE_HEADS and
          dg and not y and not (sp.scales or sp.samples))


def _wide_tf32_shape(pack: TrunkPack, y, fold, sp, first_order) -> bool:
  """The f32 spatial trunk of `wide_input` that csrc/trunk_wide_tf32.cu and
  csrc/trunk_wide_bwd_tf32.cu run: no f32 head, the 256-wide compute-dtype
  head or (K1, first-order K4: `first_order` without `fold`) none, at least
  2 layers, on two segments of the same width, at most 256 columns and a
  multiple of 4."""
  hc = 0 if pack.wc is None else int(pack.wc.shape[0])
  return (pack.compute_dtype == 'float32' and pack.wh is None and
          (hc == 256 or (hc == 0 and first_order and fold is None)) and
          pack.depth >= 2 and len(pack.seg_dims) == 2 and
          pack.seg_dims[0] == pack.seg_dims[1] <= 256 and
          pack.seg_dims[0] % 4 == 0 and wide_input(pack, y, fold, sp))


def wide_tf32(pack: TrunkPack, y: bool = False, fold=None,
              sp: SpaModes = SpaModes()) -> bool:
  """Whether the forward of `pack`, with the density gradient (`fold`, K3)
  or without it (K1), runs on csrc/trunk_wide_tf32.cu: the f32 spatial
  trunk of `wide_input` with the 256-wide compute-dtype head and no f32
  head, at least 2 layers, on two segments of the same width, at most 256
  columns and a multiple of 4 (the JAX package's default MLP, 8 x 256 on 2
  x 252 IPE columns: trained, and served); and K1 of the same trunk with
  the density head alone (mip-NeRF 360's proposal MLP, 4 x 256 on the same
  columns; 8 x 256 too)."""
  return _wide_tf32_shape(pack, y, fold, sp, fold is None)


def wide_bf16(pack: TrunkPack, y: bool = False, fold=None,
              sp: SpaModes = SpaModes()) -> bool:
  """Whether the forward of `pack` with the density gradient (`fold`) runs
  on csrc/trunk_wide_bf16.cu: the bf16 spatial trunk of `wide_input` with
  the 256-wide compute-dtype head and no f32 head, 2 to `_TMA_DEPTH`
  layers with the skip at a layer past the first, on two segments of the
  same width, 193 to 256 columns and a multiple of 4 (four 128-column
  chunks of input: the JAX package's default MLP, 8 x 256 on 2 x 252 IPE
  columns, in training)."""
  hc = 0 if pack.wc is None else int(pack.wc.shape[0])
  d = pack.seg_dims[0]
  return (pack.compute_dtype == 'bfloat16' and fold is not None and
          pack.wh is None and hc == 256 and pack.depth >= 2 and
          0 < pack.skip < pack.depth and len(pack.seg_dims) == 2 and
          192 < d == pack.seg_dims[1] <= 256 and d % 4 == 0 and
          wide_input(pack, y, fold, sp))


def wide_tf32_bwd(pack: TrunkPack, y: bool = False, fold=None,
                  sp: SpaModes = SpaModes()) -> bool:
  """Whether the backward of `pack` runs on csrc/trunk_wide_bwd_tf32.cu:
  the f32 spatial trunk of `wide_input` with the 256-wide compute-dtype head
  and no f32 head, at least 2 layers, on two segments of the same width, at
  most 256 columns and a multiple of 4, first order or with u's cotangent
  (the JAX package's default MLP with and without density normals: K4 of
  `wide_tf32`'s shape, `fold` given or not); with the density head alone
  first order only (mip-NeRF 360's proposal MLP, no `fold`)."""
  return _wide_tf32_shape(pack, y, fold, sp, True)


def forward_library(pack: TrunkPack, out_y: bool = False, fold=None,
                    sp: SpaModes = SpaModes()) -> str:
  """The library whose kernel runs the forward of `pack`, decided from its
  dtype, shape and modes alone, before anything is built or launched: at
  width 256 or 128 within `_TMA_DEPTH` layers, `_TMA_KIN` input columns and
  `_TMA_HEADS` f32 heads, 'trunk_fwd_tma' (bf16: wgmma fed by TMA; at width
  256 with K11's y too) or 'trunk_fwd_f32' (f32, without K11's y:
  register-blocked FMA products fed by TMA, where its shared memory holds
  the trunk: K3 on at most 192 input columns); past `_TMA_KIN` input
  columns the spatial trunk of `wide_input` on the same two (their
  wide-input instances, a 256-wide head and K3 there too); the spatial
  trunk of `w1024` 'trunk_w1024';
  the directional trunk of `dir1` 'trunk_dir1'; the f32 K1 and K3 of
  `wide_tf32` (K1 at the density head alone too) 'trunk_wide_tf32'; the
  bf16 K3 of `wide_bf16`
  'trunk_wide_bf16'; every other shape with an
  instance 'trunk_fwd'. (Width 128 runs the plain directional trunk alone:
  `missing_instance` refuses its other modes first.)"""
  hf = 0 if pack.wh is None else int(pack.wh.shape[0])
  if w1024(pack, out_y, fold, sp):
    return W1024_LIBRARY
  if dir1(pack, out_y, fold, sp):
    return DIR1_LIBRARY
  if wide_tf32(pack, out_y, fold, sp):
    return WIDE_TF32_LIBRARY
  if wide_bf16(pack, out_y, fold, sp):
    return WIDE_BF16_LIBRARY
  if wide_input(pack, out_y, fold, sp):
    return FWD_LIBRARY[pack.compute_dtype]
  if (pack.width not in (256, 128) or pack.depth > _TMA_DEPTH or
      pack.kin > _TMA_KIN or hf > _TMA_HEADS or
      (out_y and (pack.width != 256 or pack.compute_dtype != 'bfloat16'))):
    return 'trunk_fwd'
  if pack.compute_dtype == 'bfloat16':
    return 'trunk_fwd_tma'
  # trunk_fwd_f32.cu stages K7's lifted means and variances in 4 KB.
  fits = (kernel_smem('trunk_fwd_f32', pack, 0, fold, sp) <= SMEM_LIMIT and
          _k7_basis(pack, sp) <= 8)
  return 'trunk_fwd_f32' if fits else 'trunk_fwd'


def tma_forward(pack: TrunkPack, out_y: bool = False) -> bool:
  """Whether the forward of `pack` runs trunk_fwd_tma.cu's kernel (bf16 at
  width 256 or 128, within `_TMA_DEPTH` layers, `_TMA_KIN` input columns
  and `_TMA_HEADS` f32 heads; K11's y at width 256; the bf16 trunk of
  `wide_input`: `forward_library`)."""
  return forward_library(pack, out_y) == 'trunk_fwd_tma'


def backward_library(pack: TrunkPack, y: bool = False, fold=None) -> str:
  """The library whose kernels run the backward of `pack`, decided from its
  dtype and shape alone, before anything is built or launched: at width
  256 or 128 within `_TMA_DEPTH` layers and `_TMA_KIN` input columns,
  'trunk_bwd_tma' (bf16: wgmma fed by TMA; at width 128 on at least 128
  input columns, whose tile keeps the skip layer's zeta) or 'trunk_bwd_f32'
  (f32: register-blocked FMA products fed by TMA; at width 128 where its
  shared memory holds the trunk: at most 192 input columns); past
  `_TMA_KIN` input columns the spatial trunk of `wide_input` (without y's
  cotangent `y`; with u's, `fold`, too) on the same two (their wide-input
  instances); the spatial trunk of `w1024` (first order) 'trunk_w1024';
  the directional trunk of `dir1` 'trunk_dir1'; the f32 trunk of
  `wide_tf32_bwd` (with or without `fold`; at the density head alone
  without) 'trunk_wide_bwd_tf32'; every
  other shape with an instance (deeper, wider or narrower trunks)
  'trunk_bwd'."""
  if w1024(pack, y, fold):
    return W1024_LIBRARY
  if dir1(pack, y, fold):
    return DIR1_LIBRARY
  if wide_tf32_bwd(pack, y, fold):
    return WIDE_TF32_BWD_LIBRARY
  if wide_input(pack, y, fold):
    return BWD_LIBRARY[pack.compute_dtype]
  if (pack.width in (256, 128) and pack.depth <= _TMA_DEPTH and
      pack.kin <= _TMA_KIN):
    if pack.compute_dtype == 'bfloat16':
      if pack.width == 256 or pack.kin >= 128:
        return 'trunk_bwd_tma'
      return 'trunk_bwd'
    if (pack.width == 256 or
        kernel_smem('trunk_bwd_f32', pack, 0) <= SMEM_LIMIT):
      return 'trunk_bwd_f32'
  return 'trunk_bwd'


def bwd_cta_rows(route: str, width: int) -> int:
  """Samples a CTA of library `route`'s per-tile backward takes at trunk
  width `width`: two 64-sample tiles (128) on trunk_bwd_tma.cu's and
  trunk_bwd_f32.cu's width-128 instances, one (`_TILE`) elsewhere. A slab's
  scratch rows and its per-CTA vector partials follow it."""
  two = route in ('trunk_bwd_tma', 'trunk_bwd_f32') and width == 128
  return 2 * _TILE if two else _TILE


def _vec_groups(nparts: int) -> int:
  """The first stage's groups of a two-stage sum of `nparts` per-CTA
  vector partials: the largest divisor of nparts up to 32."""
  return max(q for q in range(1, min(32, nparts) + 1) if nparts % q == 0)


def bwd_slab_rows(width: int) -> int:
  """Rows a slab of the backward takes by default at trunk width `width`:
  `BWD_SLAB`; four times that at 128, whose weight-gradient and reduction
  launches are short enough that their count shows (its f32 scratch then
  takes about the 2.2 GB of the width-256 spatial trunk's); twice that at
  1024, whose recomputed activations then take 2 GiB in bf16 and 4 GiB in
  f32."""
  return {128: 4 * BWD_SLAB, W1024: 2 * BWD_SLAB}.get(width, BWD_SLAB)


def bwd_scratch_rows(route: str, width: int, rows: int) -> int:
  """Rows of a slab of `rows` samples in the backward's scratch (rp):
  rounded up to whole CTAs of `bwd_cta_rows`."""
  cta = bwd_cta_rows(route, width)
  return -(-rows // cta) * cta


def tma_backward(pack: TrunkPack) -> bool:
  """Whether the backward of `pack` runs trunk_bwd_tma.cu's kernels (bf16
  at width 256 or 128, within `_TMA_DEPTH` layers and `_TMA_KIN` input
  columns; the bf16 trunk of `wide_input`: `backward_library`)."""
  return backward_library(pack) == 'trunk_bwd_tma'


def _wgrad_split(route: str, rp: int, m: int, n: int, sms: int) -> int:
  """Samples per partial of the weight-gradient product of an m x n
  gradient over rp rows: trunk_bwd_f32.cu's 128 x 128 output tiles, and
  trunk_bwd_tma.cu's for the width-128 trunk's 128-row gradients (given
  `sms`: its fixed split leaves most SMs idle), times the splits fill the
  card's `sms` SMs once (one CTA an SM); the other gradients' fixed
  splits."""
  if route == 'trunk_bwd' or (route == 'trunk_bwd_tma' and
                              (m != 128 or not sms)):
    return _KSPLIT_TMA if route == 'trunk_bwd_tma' else _KSPLIT
  tiles = -(-m // 128) * -(-n // 128)
  splits = max(1, sms // tiles)
  return -(-rp // (splits * 64)) * 64


# Once per process and reason: a trunk shape without a kernel instance.
_NO_INSTANCE_LOGGED = set()


def _kernel_for(pack, hc, mode, **modes) -> bool:
  """Under mode 'auto', whether a shape without a kernel instance runs the
  plain versions instead (False, logged once); under 'on' it raises. True
  when an instance runs it."""
  why = missing_instance(pack, hc, **modes)
  if why is None:
    return True
  if mode == 'on':
    raise NotImplementedError(why)
  if why not in _NO_INSTANCE_LOGGED:
    _NO_INSTANCE_LOGGED.add(why)
    logging.warning('fused_trunk: no kernel instance (%s); the plain '
                    'versions run instead.', why)
  return False


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


# The epilogues of the width-1024 products (csrc/trunk_w1024.cu `Epi`).
_NT_RELU, _NT_REV, _NT_HEAD_BWD, _NT_BIAS = 0, 1, 2, 3


def _w1024_input(segs, pack: TrunkPack):
  """The trunk input as the width-1024 kernels read it: the segments side by
  side and zero-padded to `pack.kin` columns, [n, kin] in the compute
  dtype (the skip layer reads it beside h as a second K segment)."""
  dims = tuple(int(t.shape[-1]) for t in segs)
  if dims != pack.seg_dims:
    raise ValueError(f'segments {dims} do not match the pack {pack.seg_dims}')
  dev = segs[0].device
  for t in (pack.w, pack.wt, pack.b, pack.wd, pack.wh, pack.wc):
    if t is not None and t.device != dev:
      raise ValueError(f'weights on {t.device}, inputs on {dev}')
  x = segs[0].new_empty((int(segs[0].shape[0]), pack.kin),
                        dtype=DTYPES[pack.compute_dtype])
  off = 0
  for t in segs:
    x[:, off:off + t.shape[1]].copy_(t)
    off += t.shape[1]
  x[:, off:].zero_()
  return x


def _w1024_layers(pack: TrunkPack):
  """Each layer's offset (elements) in the pack's flat layouts of W_l and
  W_l^T, and its packed input width K_l."""
  off, out = 0, []
  for k in pack.k_dims():
    out.append((off, k))
    off += pack.width * k
  return out


def _w1024_operands(lib, pack: TrunkPack, names, stream):
  """{name: (B, B's low part or None)} for the pack's weight tensors
  `names` ('w', 'wt', 'wc', 'wct'), the B operands of the products: bf16
  the tensor as it is; f32 its TF32 high and low parts, split once a call
  (`refnerf_w1024_split`)."""
  out = {}
  for name in names:
    t = getattr(pack, name)
    if pack.compute_dtype == 'bfloat16':
      out[name] = (t, None)
      continue
    parts = torch.empty(2, t.numel(), device=t.device)
    err = lib.refnerf_w1024_split(t.numel(), t.data_ptr(), parts[0].data_ptr(),
                                  parts[1].data_ptr(), stream)
    _check_launch(err, 'width-1024 weight split')
    out[name] = tuple(parts)
  return out


def _w1024_nt(lib, pack: TrunkPack, mode, m, n, a0, lda0, k0, b, ldb, out,
              a1=None, lda1=0, k1=0, bias=None, act=None, sb=None,
              stream=None, b_off=0):
  """One nt product of csrc/trunk_w1024.cu: out [m, n] = epilogue `mode`
  of [a0 | a1] B^T (addresses and leading dimensions in elements), B from
  b (a `_w1024_operands` pair) at element b_off."""
  bh, bl = (None if t is None else t.data_ptr() + b_off * t.element_size()
            for t in b)
  err = lib.refnerf_w1024_nt(int(pack.compute_dtype == 'bfloat16'), mode, m,
                             n, a0, lda0, k0, a1, lda1, k1, bh, bl, ldb, bias,
                             act, n if act else 0, sb, _ptr(pack.wd), out, n,
                             stream)
  _check_launch(err, 'width-1024 product')


def _w1024_trunk(lib, pack: TrunkPack, w, x, rows, acts, stream):
  """The trunk's layers on `rows` rows of x [., kin], B from w (the pack's
  `w` as `_w1024_operands` gives it): layer l's activation into acts(l), a
  [>= rows, width] buffer. Returns the last one's."""
  W, es = pack.width, pack.b.element_size()
  h = None
  for l, (off, k) in enumerate(_w1024_layers(pack)):
    out = acts(l)
    if l == 0:
      a = dict(a0=x.data_ptr(), lda0=pack.kin, k0=pack.kin)
    else:
      a = dict(a0=h.data_ptr(), lda0=W, k0=W)
      if l == pack.skip:
        a.update(a1=x.data_ptr(), lda1=pack.kin, k1=pack.kin)
    _w1024_nt(lib, pack, _NT_RELU, rows, W, b=w, ldb=k, out=out.data_ptr(),
              bias=pack.b.data_ptr() + l * W * es, stream=stream, b_off=off,
              **a)
    h = out
  return h


def _w1024_forward(segs, pack: TrunkPack):
  """The width-1024 forward (`w1024`, csrc/trunk_w1024.cu): in f32 the
  weights split into their TF32 parts, then one product a layer, then the
  bottleneck head's and sigma's f32 dot product. Returns [sigma [n], hc [n,
  hc]], as trunk_kernel."""
  from refnerf_tpu_torch.ops import cuda_build  # builds on first use
  lib = cuda_build.library(W1024_LIBRARY)
  x = _w1024_input(segs, pack)
  n, W, dev = int(x.shape[0]), pack.width, x.device
  hc = int(pack.wc.shape[0])
  cdt = DTYPES[pack.compute_dtype]
  sig = torch.empty(n, device=dev)
  cout = torch.empty(n, hc, device=dev, dtype=cdt)
  if n:
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
      ops = _w1024_operands(lib, pack, ('w', 'wc'), stream)
      bufs = torch.empty(2, n, W, device=dev, dtype=cdt)
      y = _w1024_trunk(lib, pack, ops['w'], x, n, lambda l: bufs[l % 2],
                       stream)
      _w1024_nt(lib, pack, _NT_BIAS, n, hc, y.data_ptr(), W, W, ops['wc'], W,
                cout.data_ptr(), bias=pack.bc.data_ptr(), stream=stream)
      err = lib.refnerf_w1024_sigma(int(cdt == torch.bfloat16), n, W,
                                    y.data_ptr(), pack.wd.data_ptr(),
                                    sig.data_ptr(), stream)
      _check_launch(err, 'width-1024 sigma')
  return [sig, cout]


def w1024_splits(m: int, n: int, sms: int, cdt: str = 'bfloat16') -> int:
  """The partials the width-1024 backward makes of an m x n weight gradient
  at most, whatever its rows, on a card of `sms` SMs: the persistent tn
  product (one CTA an SM over its tiles, the last one cut at n) takes the
  fewest, up to 16, whose units fill at least 90% of the SM-waves they
  take (else the fullest). bf16 tiles are 128 x 256 (1024 x 1024 on 132
  SMs: 4, 1024 x 1536: 5, 1024 x 512: 8, 256 x 1024: 15), f32 128 x 128
  (1024 x 1024: 2, 1024 x 1536: 4, 1024 x 512: 4, 256 x 1024: 8)."""
  if cdt == 'float32':
    tiles = (m // 128) * -(-n // 128)
  else:
    tiles = (m // 128) * -(-n // 256)
  fill = lambda s: tiles * s / (-(-tiles * s // sms) * sms)
  return next((s for s in range(1, 17) if fill(s) >= 0.9),
              max(range(1, 17), key=fill))


def w1024_split(rows: int, m: int, n: int, sms: int,
                cdt: str = 'bfloat16') -> int:
  """Rows per partial of an m x n weight gradient over `rows` rows, in whole
  slices of the product (64 rows in bf16, 32 in f32): at most
  `w1024_splits` partials, fewer where the rows are few."""
  q = 32 if cdt == 'float32' else 64
  return -(-rows // (w1024_splits(m, n, sms, cdt) * q)) * q


def _w1024_backward(segs, pack: TrunkPack, cots, slab: Optional[int] = None):
  """The width-1024 first-order backward (`w1024`, csrc/trunk_w1024.cu):
  per slab of `slab` rows (`bwd_slab_rows`) the activations recomputed, the
  heads' backward, then per layer downwards the weight gradient's partials
  and their fixed-order sum, the bias gradient and the reverse product. The
  weight-gradient product also gives the bias gradient's partials (the
  column sums of zeta it holds: dbc from cbar's with dwc, db_l from
  zeta_l's with dW_l), summed in the same fixed order; the density head's
  gradient is the one column sum a slab. In f32 the B operands (w, wct,
  wt) are split into their TF32 parts once a call. Returns what
  trunk_backward_reference does (no dx, u or epilogue)."""
  from refnerf_tpu_torch.ops import cuda_build  # builds on first use
  sbar, _, cbar, ubar, *_ = cots
  if ubar is not None:
    raise ValueError('the width-1024 backward takes no cotangent of u')
  lib = cuda_build.library(W1024_LIBRARY)
  red = cuda_build.library('trunk_bwd').refnerf_reduce
  cdt = DTYPES[pack.compute_dtype]
  bf = int(cdt == torch.bfloat16)
  x = _w1024_input(segs, pack)
  n, dev = int(x.shape[0]), x.device
  W, L, kin = pack.width, pack.depth, pack.kin
  hc = int(pack.wc.shape[0])
  f32 = lambda *shape: torch.empty(*shape, device=dev)
  sbar = (torch.zeros(n, device=dev) if sbar is None
          else sbar.float().reshape(n).contiguous())
  cbar = (torch.zeros(n, hc, device=dev, dtype=cdt) if cbar is None
          else cbar.to(cdt).reshape(n, hc).contiguous())
  fin = sum(pack.seg_dims)
  k_pack = pack.k_dims()
  k_out = [fin if l == 0 else W + (fin if l == pack.skip else 0)
           for l in range(L)]
  dws = [f32(W, k) for k in k_out]
  dbs, dwd, dwc, dbc = f32(L, W), f32(1, W), f32(hc, W), f32(hc)
  slab = max(1, min(slab or bwd_slab_rows(W), n))
  acts = torch.empty(L, slab, W, device=dev, dtype=cdt)
  zs = torch.empty(2, slab, W, device=dev, dtype=cdt)
  sms = torch.cuda.get_device_properties(dev).multi_processor_count
  # Every slab's partials fit, a short last slab's too (its split may be
  # finer than a full slab's): sized by the most partials any slab makes.
  grads = [(W, k) for k in k_pack] + [(hc, W)]
  splits = {g: w1024_splits(*g, sms, pack.compute_dtype) for g in grads}
  wpart = f32(max(splits[m, k] * m * k for m, k in grads))
  bpart = f32(max(splits[m, k] * m for m, k in grads))
  vpart = f32(-(-slab // _W1024_COLSUM_ROWS) * W)
  stream = torch.cuda.current_stream(dev).cuda_stream
  ptr = lambda t, row, width: t.data_ptr() + row * width * t.element_size()

  def reduce(parts, nparts, rows, k, k_out_, dst, acc):
    err = red(parts.data_ptr(), nparts, rows, k, k_out_, dst.data_ptr(), acc,
              stream)
    _check_launch(err, 'width-1024 reduction')

  def wgrad(dst, bias, m, k, k_dst, rows, z, x0, ldx0, n0, x1, ldx1, acc):
    """dst (+)= z^T [x0 | x1] and bias (+)= z's column sums over the slab's
    rows (z [rows, m] contiguous), both from the one product."""
    ksplit = w1024_split(rows, m, k, sms, pack.compute_dtype)
    nparts = -(-rows // ksplit)
    assert nparts <= splits[m, k], (rows, m, k, nparts)
    assert nparts * m * k <= wpart.numel(), (rows, m, k, nparts)
    assert nparts * m <= bpart.numel(), (rows, m, nparts)
    err = lib.refnerf_w1024_tn(bf, m, k, rows, ksplit, z, m, x0, ldx0, n0,
                               x1, ldx1, wpart.data_ptr(), bpart.data_ptr(),
                               stream)
    _check_launch(err, 'width-1024 weight gradient')
    reduce(wpart, nparts, m, k, k_dst, dst, acc)
    reduce(bpart, nparts, 1, m, m, bias, acc)

  with torch.cuda.device(dev):
    ops = _w1024_operands(lib, pack, ('w', 'wct', 'wt'), stream)
    layers = _w1024_layers(pack)
    for start in range(0, n, slab):
      rows, acc = min(slab, n - start), int(start > 0)
      xs = x[start:start + rows]
      y = _w1024_trunk(lib, pack, ops['w'], xs, rows, lambda l: acts[l],
                       stream)
      cb, sb = ptr(cbar, start, hc), ptr(sbar, start, 1)
      # The heads' backward: zeta of the last layer, then the heads'
      # gradients (dwc = cbar^T y, dbc, and dwd from y's column sums scaled
      # by sigma's cotangent).
      _w1024_nt(lib, pack, _NT_HEAD_BWD, rows, W, cb, hc, hc, ops['wct'], hc,
                zs[0].data_ptr(), act=y.data_ptr(), sb=sb, stream=stream)
      wgrad(dwc, dbc, hc, W, W, rows, cb, y.data_ptr(), W, W, None, 0, acc)
      err = lib.refnerf_w1024_colsum(bf, rows, W, y.data_ptr(), W, sb,
                                     _W1024_COLSUM_ROWS, vpart.data_ptr(),
                                     stream)
      _check_launch(err, 'width-1024 column sum')
      reduce(vpart, -(-rows // _W1024_COLSUM_ROWS), 1, W, W, dwd, acc)
      for l in reversed(range(L)):
        z = zs[(L - 1 - l) % 2]
        if l == 0:
          src = (xs.data_ptr(), kin, kin, None, 0)
        elif l == pack.skip:
          src = (acts[l - 1].data_ptr(), W, W, xs.data_ptr(), kin)
        else:
          src = (acts[l - 1].data_ptr(), W, W, None, 0)
        wgrad(dws[l], dbs[l], W, k_pack[l], k_out[l], rows, z.data_ptr(),
              *src, acc)
        if l > 0:
          _w1024_nt(lib, pack, _NT_REV, rows, W, z.data_ptr(), W, W,
                    ops['wt'], W, zs[(L - l) % 2].data_ptr(),
                    act=acts[l - 1].data_ptr(), stream=stream,
                    b_off=layers[l][0])
  return (dws, list(dbs.unbind(0)), dwd, None, None, dwc, dbc, None, None,
          None)


def _dir1_inputs(segs, pack: TrunkPack):
  """The two segments as csrc/trunk_dir1.cu reads them in place, in the
  compute dtype: [n, 256] by a TMA tensor map and [n, d1] by bulk copies
  of whole tiles, so each contiguous at a 16-byte aligned address; raises
  where one is not (no copy is made to hide it)."""
  ki = _kernel_inputs(segs, pack, DirModes())
  for what, t in (('bottleneck', ki.x0), ('second', ki.x1)):
    if not t.is_contiguous() or t.data_ptr() % 16:
      raise ValueError(f'the directional trunk kernel reads the {what} '
                       'segment in place: it must be contiguous at a '
                       '16-byte aligned address')
  return ki.x0, ki.x1


def _dir1_weights(lib, pack: TrunkPack, stream, transposed=False):
  """(B, B's low part) of W1 [128, 288] (or, `transposed`, W1^T [288,
  128] with the hidden units of every 8 permuted as zeta's TF32 fragments
  hold them): bf16 the pack's tensor and None; f32 its TF32 parts, split
  once a call (`refnerf_dir1_split`)."""
  t = pack.wt if transposed else pack.w
  if pack.compute_dtype == 'bfloat16':
    return t, None
  rows, cols = ((pack.kin, pack.width) if transposed
                else (pack.width, pack.kin))
  hi, lo = torch.empty(2, rows * cols, device=t.device)
  err = lib.refnerf_dir1_split(rows, cols, t.data_ptr(), hi.data_ptr(),
                               lo.data_ptr(), int(transposed), stream)
  _check_launch(err, 'directional trunk weight split')
  return hi, lo


def _dir1_forward(segs, pack: TrunkPack):
  """K2 on csrc/trunk_dir1.cu (`dir1`): in f32 W1 split into its TF32
  parts, then one launch. Returns [rgb [n, hf] f32], as trunk_kernel."""
  from refnerf_tpu_torch.ops import cuda_build  # builds on first use
  lib = cuda_build.library(DIR1_LIBRARY)
  x0, x1 = _dir1_inputs(segs, pack)
  n, dev, hf = int(x0.shape[0]), x0.device, int(pack.wh.shape[0])
  rgb = torch.empty(n, hf, device=dev)
  if n:
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
      w, w_lo = _dir1_weights(lib, pack, stream)
      err = lib.refnerf_dir1_fwd(
          int(pack.compute_dtype == 'bfloat16'), n, int(x1.shape[1]), hf,
          x0.data_ptr(), x1.data_ptr(), _ptr(w), _ptr(w_lo), pack.b.data_ptr(),
          pack.wh.data_ptr(), pack.bh.data_ptr(), rgb.data_ptr(), stream)
      _check_launch(err, 'directional trunk forward (trunk_dir1)')
  return [rgb]


def dir1_splits(sms: int, cdt: str) -> int:
  """The partials of the directional trunk's weight gradient (128 x 288
  on trunk_w1024.cu's product, whose units are an output tile and a split
  of the rows) at most, on a card of `sms` SMs: as many splits as fill the
  SMs once with its tiles (bf16 128 x 256: 2 tiles, 66 splits on 132 SMs;
  f32 128 x 128: 3, 44)."""
  tiles = 2 if cdt == 'bfloat16' else 3
  return max(1, sms // tiles)


def dir1_split(rows: int, sms: int, cdt: str) -> int:
  """Rows per partial of that weight gradient over `rows` rows, in whole
  slices of the product (64 rows in bf16, 32 in f32): at most
  `dir1_splits` partials."""
  q = 32 if cdt == 'float32' else 64
  return -(-rows // (dir1_splits(sms, cdt) * q)) * q


def _dir1_backward(segs, pack: TrunkPack, cots):
  """K5 with the segments' cotangents on csrc/trunk_dir1.cu (`dir1`): one
  launch recomputes the layer and writes dx, zeta, the second segment
  zero-padded to 32 columns and each CTA's head partial; trunk_w1024.cu's
  product sums zeta^T [x0 | x1 padded] and zeta's column sums over rows in
  `dir1_split` partials; trunk_bwd.cu's refnerf_reduce sums every partial
  in a fixed order. In f32 W1 and W1^T (its hidden units permuted) are
  split into their TF32 parts first. The whole batch in one pass (the
  scratch is zeta and the padded segment, [n, 160] in the compute dtype).
  Returns what trunk_backward_reference does with needs_dx."""
  from refnerf_tpu_torch.ops import cuda_build  # builds on first use
  sbar, hbar, cbar, ubar, *_ = cots
  if sbar is not None or cbar is not None or ubar is not None:
    raise ValueError('the directional trunk has the f32 head alone')
  lib = cuda_build.library(DIR1_LIBRARY)
  seg_dtypes = [s.dtype for s in segs]
  x0, x1 = _dir1_inputs(segs, pack)
  n, d1, dev = int(x0.shape[0]), int(x1.shape[1]), x0.device
  hf, W, kin = int(pack.wh.shape[0]), pack.width, pack.kin
  cdt = DTYPES[pack.compute_dtype]
  bf = int(cdt == torch.bfloat16)
  f32 = lambda *shape: torch.empty(*shape, device=dev)
  hbar = (torch.zeros(n, hf, device=dev) if hbar is None
          else hbar.float().reshape(n, hf).contiguous())
  if hbar.data_ptr() % 16:
    hbar = hbar.clone()
  dx0 = torch.empty(n, DIR1_D0, device=dev, dtype=cdt)
  dx1 = torch.empty(n, d1, device=dev, dtype=cdt)
  dw, db, vec = f32(W, DIR1_D0 + d1), f32(W), f32(DIR1_PARTS)
  if n:
    tn = cuda_build.library(W1024_LIBRARY).refnerf_w1024_tn
    red = cuda_build.library('trunk_bwd').refnerf_reduce
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    z = torch.empty(n, W, device=dev, dtype=cdt)
    x1p = torch.empty(n, kin - DIR1_D0, device=dev, dtype=cdt)
    # Scratch sized by the most partials any row count makes (H24): a CTA
    # an SM, and dir1_splits of the weight gradient.
    hpart = f32(sms, DIR1_PARTS)
    splits = dir1_splits(sms, pack.compute_dtype)
    wpart, bpart = f32(splits * W * kin), f32(splits * W)
    with torch.cuda.device(dev):
      w, w_lo = _dir1_weights(lib, pack, stream)
      wt, wt_lo = (_dir1_weights(lib, pack, stream, transposed=True)
                   if not bf else (None, None))
      nparts = lib.refnerf_dir1_parts(bf, n)
      assert 0 < nparts <= sms, (n, nparts, sms)
      err = lib.refnerf_dir1_bwd(
          bf, n, d1, hf, x0.data_ptr(), x1.data_ptr(), _ptr(w), _ptr(w_lo),
          _ptr(wt), _ptr(wt_lo), pack.b.data_ptr(), pack.wh.data_ptr(),
          hbar.data_ptr(),
          dx0.data_ptr(), dx1.data_ptr(), z.data_ptr(), x1p.data_ptr(),
          hpart.data_ptr(), sms, stream)
      _check_launch(err, 'directional trunk backward (trunk_dir1)')
      ksplit = dir1_split(n, sms, pack.compute_dtype)
      nsplit = -(-n // ksplit)
      assert nsplit <= splits, (n, ksplit, splits)
      err = tn(bf, W, kin, n, ksplit, z.data_ptr(), W, x0.data_ptr(),
               DIR1_D0, DIR1_D0, x1p.data_ptr(), kin - DIR1_D0,
               wpart.data_ptr(), bpart.data_ptr(), stream)
      _check_launch(err, 'directional trunk weight gradient')
      for parts, count, rows, k, k_out, dst in (
          (wpart, nsplit, W, kin, DIR1_D0 + d1, dw),
          (bpart, nsplit, 1, W, W, db),
          (hpart, nparts, 1, DIR1_PARTS, DIR1_PARTS, vec)):
        _check_launch(red(parts.data_ptr(), count, rows, k, k_out,
                          dst.data_ptr(), 0, stream), 'reduction kernel')
  else:
    for t in (dw, db, vec):
      t.zero_()
  dwh = vec[:DIR1_HEADS * W].reshape(DIR1_HEADS, W)[:hf]
  dbh = vec[DIR1_HEADS * W:DIR1_HEADS * W + hf]
  dxs = [d.to(dt) for d, dt in zip((dx0, dx1), seg_dtypes)]
  return [dw], [db], None, dwh, dbh, None, None, dxs, None, None


def tf32_panel_index(depth: int, skip: int, kin: int, d: int,
                     width: int = 256, dg: bool = True,
                     head: bool = True) -> np.ndarray:
  """Where each entry of csrc/trunk_wide_tf32.cu's weight panels comes from:
  [panels * width, width] indices into cat(pack.w, pack.wc.flatten()), -1
  for zeros. Each panel is a product's B [N = width][K = width], in the
  order a tile runs them: layer 0's input share one panel a segment (the
  segment's d columns, zeros to 256), each hidden layer's activation share
  and at the skip layer its input share (one a segment), the bottleneck
  wc (not without the compute-dtype `head`: K1 of the density head alone
  stops at the layers), then with the density gradient (`dg`; K1 stops at
  the bottleneck) the chain: at layer l from depth - 1 down, at the skip
  layer u_x's [Wx_l^T] (one a segment, N the segment's columns), W_l^T's
  hidden part; last layer 0's u_x. Within every 8 of K, slot s holds column
  8 (s // 8) + 2 (s % 4) + (s % 8) // 4, where a TF32 A fragment of the
  accumulators' layout finds it."""
  ks = [kin if l == 0 else width + (kin if l == skip else 0)
        for l in range(depth)]
  offs = np.concatenate([[0], np.cumsum([width * k for k in ks])])
  s = np.arange(width)
  perm = (s // 8) * 8 + 2 * (s % 4) + (s % 8) // 4
  n, kp = np.arange(width)[:, None], perm[None, :]
  out = []

  def fwd(l, col0, seg_cols=False):  # B[n][k'] = W_l[n][col0 + perm(k')]
    idx = offs[l] + n * ks[l] + col0 + kp
    out.append(np.where(kp < d, idx, -1) if seg_cols else idx)

  def rev(l, col0, seg_cols=False):  # B[n][k'] = W_l[perm(k')][col0 + n]
    idx = offs[l] + kp * ks[l] + col0 + n
    out.append(np.where(n < d, idx, -1) if seg_cols else idx)

  for g in (0, 1):
    fwd(0, g * d, True)
  for l in range(1, depth):
    fwd(l, 0)
    if l == skip:
      for g in (0, 1):
        fwd(l, width + g * d, True)
  if head:
    out.append(offs[-1] + n * width + kp)  # the bottleneck wc [256][width]
  for l in range(depth - 1, -1, -1) if dg else ():
    if l == 0 or l == skip:
      for g in (0, 1):
        rev(l, (0 if l == 0 else width) + g * d, True)
    if l > 0:
      rev(l, 0)
  return np.concatenate(out).astype(np.int32)


def _panel_source(pack: TrunkPack) -> torch.Tensor:
  """cat(pack.w, pack.wc.flatten(), 0) in f32: what the panel indices
  point into, the zero last (an index of -1); wc left out without it."""
  return torch.cat([pack.w.float()] + (
      [] if pack.wc is None else [pack.wc.float().reshape(-1)]) +
                   [pack.w.new_zeros(1, dtype=torch.float32)])


def tf32_panels(pack: TrunkPack, dg: bool = True) -> torch.Tensor:
  """csrc/trunk_wide_tf32.cu's weight panels of `pack` (`wide_tf32`) in
  f32, [panels * 256, 256], before their TF32 split: K3's with the density
  gradient (`dg`), else K1's (without the bottleneck's at the density head
  alone)."""
  idx = tf32_panel_index(pack.depth, pack.skip, pack.kin, pack.seg_dims[0],
                         dg=dg, head=pack.wc is not None)
  src = _panel_source(pack)
  idx = torch.from_numpy(idx).long().to(src.device)
  return src[torch.where(idx < 0, src.numel() - 1, idx)]


def tf32_fold_index(d: int, nb: int) -> np.ndarray:
  """Where each entry of csrc/trunk_wide_tf32.cu's fold panel comes from:
  [64, 128] indices into the fold S [d, nb], -1 for zeros. Rows 32 cw + j
  (basis vector j < 32) are the B operand of warpgroup cw's fold, K its 128
  columns c = 128 cw + k permuted within every 8 as `tf32_panel_index`'s
  K: B[j][k'] = S[c][j]."""
  s = np.arange(128)
  perm = (s // 8) * 8 + 2 * (s % 4) + (s % 8) // 4
  j = np.arange(32)[:, None]
  rows = [np.where((c < d) & (j < nb), c * nb + j, -1)
          for c in (128 * cw + perm[None, :] for cw in (0, 1))]
  return np.concatenate(rows).astype(np.int32)


def tf32_fold_panel(fold) -> torch.Tensor:
  """csrc/trunk_wide_tf32.cu's fold panel of the fold S [d, nb] in f32,
  [64, 128], before its TF32 split."""
  idx = torch.from_numpy(tf32_fold_index(*fold.shape)).long().to(fold.device)
  src = torch.cat([fold.float().reshape(-1), fold.new_zeros(1,
                                                            dtype=torch.float32)])
  return src[torch.where(idx < 0, src.numel() - 1, idx)]


def bf16_fold_index(d: int, nb: int) -> np.ndarray:
  """Where each entry of csrc/trunk_wide_bf16.cu's fold panel comes from:
  [4 * 32, 128] indices into the fold S [d, nb], -1 for zeros. Rows 32 ch +
  j (basis vector j < 32) are the B operand of the fold of input chunk ch,
  the trunk input's columns c = 128 ch + k of [x0 | x1] (two segments of d
  columns), K permuted within every 8 as `tf32_panel_index`'s: B[j][k'] =
  S[c][j] for a sin column c < d, S[c - d][j] for a cos column c < 2 d."""
  s = np.arange(128)
  perm = (s // 8) * 8 + 2 * (s % 4) + (s % 8) // 4
  j = np.arange(32)[:, None]
  rows = []
  for ch in range(4):
    c = 128 * ch + perm[None, :]
    row = np.where(c < d, c, c - d)
    rows.append(np.where((c < 2 * d) & (j < nb), row * nb + j, -1))
  return np.concatenate(rows).astype(np.int32)


def bf16_fold_panel(fold) -> torch.Tensor:
  """csrc/trunk_wide_bf16.cu's fold panel of the fold S [d, nb] in f32,
  [4 * 32, 128], before its TF32 split."""
  idx = torch.from_numpy(bf16_fold_index(*fold.shape)).long().to(fold.device)
  src = torch.cat([fold.float().reshape(-1),
                   fold.new_zeros(1, dtype=torch.float32)])
  return src[torch.where(idx < 0, src.numel() - 1, idx)]


def tf32_bwd_panel_index(depth: int, skip: int, kin: int, d: int, dg: bool,
                         width: int = 256, head: bool = True) -> np.ndarray:
  """Where each entry of csrc/trunk_wide_bwd_tf32.cu's weight panels comes
  from: [panels * width, width] indices into cat(pack.w, pack.wc.flatten()),
  -1 for zeros, K permuted within every 8 as `tf32_panel_index`'s. In the
  order a tile runs them: the recompute (layer 0's input share one panel a
  segment, its d columns; each hidden layer's activation share, at the skip
  layer its input share one a segment); with u's cotangent (`dg`) the
  inner chain's W_l^T from layer depth - 1 down to 1; the head backward's wc
  (B[n][k'] = wc[perm(k')][n]; none without the compute-dtype `head`, whose
  zeta_{L-1} is no product); the reverse's W_l^T likewise; with u's
  cotangent the tangent's layers, as the recompute's but for the input
  share of layer 0 and of the skip layer: two panels of 256 of the tangent's
  columns (the segments side by side, as the pack's kin), whose A the kernel
  reads from its ts scratch."""
  ks = [kin if l == 0 else width + (kin if l == skip else 0)
        for l in range(depth)]
  offs = np.concatenate([[0], np.cumsum([width * k for k in ks])])
  s = np.arange(width)
  perm = (s // 8) * 8 + 2 * (s % 4) + (s % 8) // 4
  n, kp = np.arange(width)[:, None], perm[None, :]
  out = []

  def fwd(l, col0, cols=None):  # B[n][k'] = W_l[n][col0 + perm(k')]
    idx = offs[l] + n * ks[l] + col0 + kp
    out.append(idx if cols is None else np.where(kp < cols, idx, -1))

  def rev(l):  # B[n][k'] = W_l[perm(k')][n]
    out.append(offs[l] + kp * ks[l] + n)

  def layers(col0, cols):  # the input share's panel g: col0[g], cols[g]
    for g in (0, 1):
      fwd(0, col0[g], cols[g])
    for l in range(1, depth):
      fwd(l, 0)
      if l == skip:
        for g in (0, 1):
          fwd(l, width + col0[g], cols[g])

  layers((0, d), (d, d))
  if dg:
    for l in range(depth - 1, 0, -1):
      rev(l)
  if head:
    out.append(offs[-1] + kp * width + n)
  for l in range(depth - 1, 0, -1):
    rev(l)
  if dg:
    layers((0, width), (min(kin, width), kin - width))
  return np.concatenate(out).astype(np.int32)


def tf32_bwd_panels(pack: TrunkPack, dg: bool) -> torch.Tensor:
  """csrc/trunk_wide_bwd_tf32.cu's weight panels of `pack`
  (`wide_tf32_bwd`) in f32, [panels * 256, 256], before their TF32 split."""
  idx = tf32_bwd_panel_index(pack.depth, pack.skip, pack.kin,
                             pack.seg_dims[0], dg, head=pack.wc is not None)
  src = _panel_source(pack)
  idx = torch.from_numpy(idx).long().to(src.device)
  return src[torch.where(idx < 0, src.numel() - 1, idx)]


def tf32_tp_index(d: int, nb: int) -> np.ndarray:
  """Where each entry of csrc/trunk_wide_bwd_tf32.cu's tp panel (the B of
  tp = ubar S^T, one [256][32] slice) comes from: indices into the fold S
  [d, nb], -1 for zeros. B[c][k'] = S[c][perm(k')] for c < d, K permuted
  within every 8 as `tf32_panel_index`'s."""
  s = np.arange(32)
  perm = (s // 8) * 8 + 2 * (s % 4) + (s % 8) // 4
  c, j = np.arange(256)[:, None], perm[None, :]
  return np.where((c < d) & (j < nb), c * nb + j, -1).astype(np.int32)


def tf32_tp_panel(fold) -> torch.Tensor:
  """csrc/trunk_wide_bwd_tf32.cu's tp panel of the fold S [d, nb] in f32,
  [256, 32], before its TF32 split."""
  idx = torch.from_numpy(tf32_tp_index(*fold.shape)).long().to(fold.device)
  src = torch.cat([fold.float().reshape(-1),
                   fold.new_zeros(1, dtype=torch.float32)])
  return src[torch.where(idx < 0, src.numel() - 1, idx)]


@functools.lru_cache(maxsize=8)
def _bwd_panel_index(depth, skip, kin, d, dg, head, device):
  return torch.from_numpy(tf32_bwd_panel_index(depth, skip, kin, d, dg,
                                               head=head)).to(device)


@functools.lru_cache(maxsize=8)
def _tp_index(d, nb, device):
  return torch.from_numpy(tf32_tp_index(d, nb)).to(device)


@functools.lru_cache(maxsize=8)
def _panel_index(depth, skip, kin, d, dg, head, device):
  return torch.from_numpy(tf32_panel_index(depth, skip, kin, d, dg=dg,
                                           head=head)).to(device)


@functools.lru_cache(maxsize=8)
def _bf16_fold_index(d, nb, device):
  return torch.from_numpy(bf16_fold_index(d, nb)).to(device)


@functools.lru_cache(maxsize=8)
def _fold_index(d, nb, device):
  return torch.from_numpy(tf32_fold_index(d, nb)).to(device)


def _wide_tf32_forward(segs, pack: TrunkPack, fold):
  """K3 (`fold` given) or K1 on csrc/trunk_wide_tf32.cu (`wide_tf32`):
  the weights' panels and K3's fold panel split into their TF32 parts once
  a call (`refnerf_wide_tf32_split`), then one launch. Returns [sigma [n],
  the bottleneck [n, 256]] and with K3 u [n, nb], f32, as trunk_kernel; at
  the density head alone (K1 of `refnerf_wide_tf32_k1h0`) [sigma [n]]."""
  from refnerf_tpu_torch.ops import cuda_build  # builds on first use
  lib = cuda_build.library(WIDE_TF32_LIBRARY)
  ki = _kernel_inputs(segs, pack, DirModes())
  x0, x1 = ki.x0, ki.x1
  for t in (x0, x1):
    if t.data_ptr() % 16:
      raise ValueError('the f32 density-gradient kernel reads the IPE '
                       'segments by TMA: each must start at a 16-byte '
                       'aligned address')
  n, dev, d = int(x0.shape[0]), x0.device, ki.d0
  dg, head = fold is not None, pack.wc is not None
  outs = [torch.empty(n, device=dev)]
  if head:
    outs.append(torch.empty(n, 256, device=dev))
  if dg:
    fold = fold.float().contiguous()
    outs.append(torch.empty(n, int(fold.shape[1]), device=dev))
  if n:
    idx = _panel_index(pack.depth, pack.skip, pack.kin, d, dg, head, dev)
    what = 'f32 density-gradient' if dg else 'f32'
    with torch.cuda.device(dev):
      stream = torch.cuda.current_stream(dev).cuda_stream
      hi, lo = torch.empty(2, idx.numel(), device=dev)
      err = lib.refnerf_wide_tf32_split(
          idx.numel(), idx.data_ptr(), pack.w.data_ptr(), pack.w.numel(),
          _ptr(pack.wc), hi.data_ptr(), lo.data_ptr(), stream)
      _check_launch(err, f'{what} weight split')
      common = (x0.data_ptr(), x1.data_ptr(), hi.data_ptr(), lo.data_ptr(),
                idx.numel() // 65536)
      if not head:
        err = lib.refnerf_wide_tf32_k1h0(n, d, pack.depth, pack.skip, *common,
                                         pack.b.data_ptr(), pack.wd.data_ptr(),
                                         outs[0].data_ptr(), stream)
        _check_launch(err, f'{what} forward (trunk_wide_tf32)')
        return outs
      heads = (pack.b.data_ptr(), pack.wd.data_ptr(), pack.bc.data_ptr(),
               *(t.data_ptr() for t in outs), stream)
      if dg:
        nb = int(fold.shape[1])
        fidx = _fold_index(d, nb, dev)
        fh, fl = torch.empty(2, fidx.numel(), device=dev)
        err = lib.refnerf_wide_tf32_split(
            fidx.numel(), fidx.data_ptr(), fold.data_ptr(), fold.numel(),
            fold.data_ptr(), fh.data_ptr(), fl.data_ptr(), stream)
        _check_launch(err, f'{what} fold split')
        err = lib.refnerf_wide_tf32_k3(n, d, pack.depth, pack.skip, nb,
                                       *common, fh.data_ptr(), fl.data_ptr(),
                                       *heads)
      else:
        err = lib.refnerf_wide_tf32_k1(n, d, pack.depth, pack.skip, *common,
                                       *heads)
      _check_launch(err, f'{what} forward (trunk_wide_tf32)')
  return outs


def _wide_bf16_forward(segs, pack: TrunkPack, fold):
  """K3 on csrc/trunk_wide_bf16.cu (`wide_bf16`): the fold panel split into
  its TF32 parts once a call (`refnerf_wide_bf16_fold`), then one launch
  over the pack's own weights. Returns [sigma [n] f32, the bottleneck [n,
  256] bf16, u [n, nb] f32], as trunk_kernel."""
  from refnerf_tpu_torch.ops import cuda_build  # builds on first use
  lib = cuda_build.library(WIDE_BF16_LIBRARY)
  ki = _kernel_inputs(segs, pack, DirModes())
  x0, x1 = ki.x0, ki.x1
  for t in (x0, x1):
    if t.data_ptr() % 16:
      raise ValueError('the bf16 density-gradient kernel reads the IPE '
                       'segments 8 bytes a copy: each must start at a '
                       '16-byte aligned address')
  n, dev, d = int(x0.shape[0]), x0.device, ki.d0
  fold = fold.float().contiguous()
  nb = int(fold.shape[1])
  sig = torch.empty(n, device=dev)
  cout = torch.empty(n, 256, device=dev, dtype=torch.bfloat16)
  u = torch.empty(n, nb, device=dev)
  if n:
    fidx = _bf16_fold_index(d, nb, dev)
    with torch.cuda.device(dev):
      stream = torch.cuda.current_stream(dev).cuda_stream
      fh, fl = torch.empty(2, fidx.numel(), device=dev)
      err = lib.refnerf_wide_bf16_fold(fidx.numel(), fidx.data_ptr(),
                                       fold.data_ptr(), fh.data_ptr(),
                                       fl.data_ptr(), stream)
      _check_launch(err, 'bf16 density-gradient fold split')
      err = lib.refnerf_wide_bf16_k3(
          n, d, pack.depth, pack.skip, nb, pack.kin, x0.data_ptr(),
          x1.data_ptr(), pack.w.data_ptr(), pack.wt.data_ptr(),
          pack.wc.data_ptr(), fh.data_ptr(), fl.data_ptr(),
          pack.b.data_ptr(), pack.wd.data_ptr(), pack.bc.data_ptr(),
          sig.data_ptr(), cout.data_ptr(), u.data_ptr(), stream)
      _check_launch(err, 'bf16 density-gradient forward (trunk_wide_bf16)')
  return [sig, cout, u]


def wide_tf32_splits(m: int, n: int, sms: int) -> int:
  """The partials of an m x n weight gradient of the f32 wide-input backward
  (`_wide_tf32_backward`) at most, whatever its rows: trunk_w1024.cu's f32
  tn product's 128 x 128 tiles times the splits fill the card's `sms` SMs
  once (on 132 SMs 256 x 256: 4 tiles, 33 splits; 256 x 512: 16; 256 x 768:
  11). `w1024_splits`' cap of 16 would leave half the SMs idle at 256 x
  256."""
  return max(1, sms // ((m // 128) * -(-n // 128)))


def wide_tf32_split(rows: int, m: int, n: int, sms: int) -> int:
  """Rows per partial of that weight gradient over `rows` rows, in whole
  32-row slices of the product: at most `wide_tf32_splits` partials."""
  return -(-rows // (wide_tf32_splits(m, n, sms) * 32)) * 32


def wide_tf32_slab_rows(hc: int) -> int:
  """Rows a slab of the f32 wide-input backward (`_wide_tf32_backward`)
  takes by default: `bwd_slab_rows(256)` with the 256-wide head, four times
  that at the density head alone (the proposal trunk: its scratch, h and
  zeta [depth][256] and x [512] a row, then takes 2.7 GB at depth 4, 4.8 GB
  at depth 8), whose per-slab launches (the per-tile kernel's partial last
  wave, a tn product and two reductions a layer) cost 0.70 ms a call at
  524,288 rows in slabs of 65,536 against 262,144 (PERF.md, PR 28 call
  2)."""
  return bwd_slab_rows(256) * (1 if hc else 4)


def _wide_tf32_backward(segs, pack: TrunkPack, cots, fold=None,
                        slab: Optional[int] = None):
  """K4 on csrc/trunk_wide_bwd_tf32.cu (`wide_tf32_bwd`): first order, or
  the second-order pass too where the cotangent of u (cots' fourth, with
  `fold`) is given; at the density head alone first order on the head-0
  instance (`refnerf_wide_tf32_k4h0`: no cbar, dwc or dbc; dwd's share of
  each 64-row tile summed in the kernel from y, which it does not store,
  the shares then reduced in a fixed order). The weights' panels
  (`tf32_bwd_panel_index`) and tp's (`tf32_tp_index`, from the fold) split
  into their TF32 parts once a call (trunk_wide_tf32.cu's
  `refnerf_wide_tf32_split`); per slab of `slab` rows
  (`wide_tf32_slab_rows`) the per-tile kernel writes the weight gradients'
  operands (h, zeta, s, p [L][rp][256]; x, ts [rp][512]); trunk_w1024.cu's
  f32 tn product forms each gradient's partials (dW_l in two launches,
  zeta_l^T [h_{l-1} | x] with db_l, zeta_l's column sums, then s_l^T
  [p_{l-1} | ts], which adds nothing to the bias; dwc and dbc from cbar),
  its column sums dwd (sbar y, then p_{L-1}), and trunk_bwd.cu's
  refnerf_reduce sums every partial in a fixed order. Returns what
  trunk_backward_reference does (no dx)."""
  from refnerf_tpu_torch.ops import cuda_build  # builds on first use
  sbar, _, cbar, ubar, *_ = cots
  dg = ubar is not None
  if dg and fold is None:
    raise ValueError('the cotangent of u needs the scale fold')
  lib = cuda_build.library(WIDE_TF32_BWD_LIBRARY)
  split_fn = cuda_build.library(WIDE_TF32_LIBRARY).refnerf_wide_tf32_split
  prod = cuda_build.library(W1024_LIBRARY)
  red = cuda_build.library('trunk_bwd').refnerf_reduce
  ki = _kernel_inputs(segs, pack, DirModes())
  x0, x1 = ki.x0, ki.x1
  for t in (x0, x1):
    if t.data_ptr() % 16:
      raise ValueError('the f32 wide-input backward reads the IPE segments '
                       'by TMA: each must start at a 16-byte aligned address')
  n, dev, d = int(x0.shape[0]), x0.device, ki.d0
  W, L, kin = pack.width, pack.depth, pack.kin
  hc = 0 if pack.wc is None else int(pack.wc.shape[0])
  if dg and not hc:
    raise ValueError('the f32 wide-input backward at the density head alone '
                     'is first order')
  f32 = lambda *shape: torch.empty(*shape, device=dev)
  sbar = (torch.zeros(n, device=dev) if sbar is None
          else sbar.float().reshape(n).contiguous())
  if hc:
    cbar = (torch.zeros(n, hc, device=dev) if cbar is None
            else cbar.float().reshape(n, hc).contiguous())
    if cbar.data_ptr() % 16:
      cbar = cbar.clone()
  nb = int(fold.shape[1]) if dg else 0
  ubar = ubar.float().reshape(n, nb).contiguous() if dg else None
  fin = sum(pack.seg_dims)
  k_pack = pack.k_dims()
  k_out = [fin if l == 0 else W + (fin if l == pack.skip else 0)
           for l in range(L)]
  dws = [f32(W, k) for k in k_out]
  dbs, dwd = f32(L, W), f32(1, W)
  dwc, dbc = (f32(hc, W), f32(hc)) if hc else (None, None)
  if not n:
    for t in dws + [dbs, dwd, dwc, dbc]:
      if t is not None:
        t.zero_()
    return (dws, list(dbs.unbind(0)), dwd, None, None, dwc, dbc, None, None,
            None)
  slab = max(1, min(slab or wide_tf32_slab_rows(hc), n))
  rp_max = -(-slab // _TILE) * _TILE
  # The scratch: h, zeta (and s, p) [L][rp][W]; x (and ts) [rp][2 W].
  regions = [('hs', L * W), ('zs', L * W)]
  regions += [('ss', L * W), ('ps', L * W)] if dg else []
  regions += [('xs', 2 * W)] + ([('ts', 2 * W)] if dg else [])
  scratch = f32(sum(k for _, k in regions) * rp_max)
  sms = torch.cuda.get_device_properties(dev).multi_processor_count
  # Every slab's partials fit, a short last slab's too: sized by the most
  # partials any slab makes (H24).
  grads = [(W, k) for k in k_pack] + ([(hc, W)] if hc else [])
  splits = {g: wide_tf32_splits(*g, sms) for g in grads}
  wpart = f32(max(splits[m, k] * m * k for m, k in grads))
  bpart = f32(max(splits[m, k] * m for m, k in grads))
  # dwd's partials: the column sums' blocks, or at the density head alone
  # the kernel's tiles (and their first stage's group sums).
  vpart = f32(-(-slab // (_WIDE_COLSUM_ROWS if hc else _TILE)) * W)
  vmid = None if hc else f32(-(-slab // _TILE) * W)
  stream = torch.cuda.current_stream(dev).cuda_stream
  at = lambda t, row, width: (None if t is None else
                              t.data_ptr() + row * width * t.element_size())

  def reduce(parts, nparts, rows, k, k_dst, dst, acc):
    err = red(parts.data_ptr(), nparts, rows, k, k_dst, dst.data_ptr(), acc,
              stream)
    _check_launch(err, 'reduction kernel')

  def wgrad(dst, bias, m, k, k_dst, rows, z, ldz, x0_, ldx0, n0, x1_, ldx1,
            acc):
    """dst (+)= z^T [x0_ | x1_] over the slab's rows, and bias (+)= z's
    column sums where given, from the one product."""
    ksplit = wide_tf32_split(rows, m, k, sms)
    nparts = -(-rows // ksplit)
    assert nparts <= splits[m, k], (rows, m, k, nparts)
    assert nparts * m * k <= wpart.numel(), (rows, m, k, nparts)
    assert nparts * m <= bpart.numel(), (rows, m, nparts)
    err = prod.refnerf_w1024_tn(0, m, k, rows, ksplit, z, ldz, x0_, ldx0, n0,
                                x1_, ldx1, wpart.data_ptr(),
                                None if bias is None else bpart.data_ptr(),
                                stream)
    _check_launch(err, 'f32 wide-input weight gradient')
    reduce(wpart, nparts, m, k, k_dst, dst, acc)
    if bias is not None:
      reduce(bpart, nparts, 1, m, m, bias, acc)

  def colsum(rows, v, s, dst, acc):
    err = prod.refnerf_w1024_colsum(0, rows, W, v, W, s, _WIDE_COLSUM_ROWS,
                                    vpart.data_ptr(), stream)
    _check_launch(err, 'f32 wide-input column sum')
    reduce(vpart, -(-rows // _WIDE_COLSUM_ROWS), 1, W, W, dst, acc)

  with torch.cuda.device(dev):
    idx = _bwd_panel_index(L, pack.skip, kin, d, dg, hc > 0, dev)
    hi, lo = torch.empty(2, idx.numel(), device=dev)
    err = split_fn(idx.numel(), idx.data_ptr(), pack.w.data_ptr(),
                   pack.w.numel(), _ptr(pack.wc), hi.data_ptr(),
                   lo.data_ptr(), stream)
    _check_launch(err, 'f32 wide-input backward weight split')
    th = tl = None
    if dg:
      fold = fold.float().contiguous()
      tidx = _tp_index(d, nb, dev)
      th, tl = torch.empty(2, tidx.numel(), device=dev)
      err = split_fn(tidx.numel(), tidx.data_ptr(), fold.data_ptr(),
                     fold.numel(), fold.data_ptr(), th.data_ptr(),
                     tl.data_ptr(), stream)
      _check_launch(err, 'f32 wide-input backward fold split')
    for start in range(0, n, slab):
      rows, acc = min(slab, n - start), int(start > 0)
      rp = -(-rows // _TILE) * _TILE
      reg, off = {}, 0
      for name, feats in regions:
        reg[name] = scratch.data_ptr() + off * rp * 4
        off += feats
      layer = lambda name, l: reg[name] + l * W * rp * 4
      if hc:
        err = lib.refnerf_wide_tf32_k4(
            rows, rp, d, L, pack.skip, nb, at(x0, start, d), at(x1, start, d),
            hi.data_ptr(), lo.data_ptr(), idx.numel() // (W * W), _ptr(th),
            _ptr(tl), pack.b.data_ptr(), pack.wd.data_ptr(),
            at(sbar, start, 1), at(cbar, start, hc), at(ubar, start, nb),
            reg['hs'], reg['zs'], reg.get('ss'), reg.get('ps'), reg['xs'],
            reg.get('ts'), stream)
      else:
        err = lib.refnerf_wide_tf32_k4h0(
            rows, rp, d, L, pack.skip, at(x0, start, d), at(x1, start, d),
            hi.data_ptr(), lo.data_ptr(), idx.numel() // (W * W),
            pack.b.data_ptr(), pack.wd.data_ptr(), at(sbar, start, 1),
            reg['hs'], reg['zs'], reg['xs'], vpart.data_ptr(), stream)
      _check_launch(err, 'f32 wide-input backward (trunk_wide_bwd_tf32)')
      # The head: dwc = cbar^T y and dbc; dwd = sum sbar y (+ sum p_{L-1}).
      y = layer('hs', L - 1)
      if hc:
        wgrad(dwc, dbc, hc, W, W, rows, at(cbar, start, hc), hc, y, W, W,
              None, 0, acc)
        colsum(rows, y, at(sbar, start, 1), dwd, acc)
      else:
        # The tiles' sums in two fixed-order stages (`_vec_groups`), so that
        # a thread sums tens of them and not thousands.
        tiles = rp // _TILE
        q = _vec_groups(tiles)
        reduce(vpart, q, tiles // q, W, W, vmid, 0)
        reduce(vmid, tiles // q, 1, W, W, dwd, acc)
      if dg:
        colsum(rows, layer('ps', L - 1), None, dwd, 1)
      for l in range(L):
        for z, a, x, bias, acc_l in (
            ('zs', 'hs', 'xs', dbs[l], acc), ('ss', 'ps', 'ts', None, 1)):
          if z == 'ss' and not dg:
            continue
          if l == 0:
            src = (reg[x], 2 * W, kin, None, 0)
          elif l == pack.skip:
            src = (layer(a, l - 1), W, W, reg[x], 2 * W)
          else:
            src = (layer(a, l - 1), W, W, None, 0)
          wgrad(dws[l], bias, W, k_pack[l], k_out[l], rows, layer(z, l), W,
                *src, acc_l)
  return (dws, list(dbs.unbind(0)), dwd, None, None, dwc, dbc, None, None,
          None)


def trunk_kernel(segs: Sequence[torch.Tensor], pack: TrunkPack,
                 fold: Optional[torch.Tensor] = None,
                 dir_modes: Optional[DirModes] = None, rgbx=None,
                 spa_modes: Optional[SpaModes] = None, comp=None,
                 out_y: bool = False):
  """Launch the CUDA forward kernel (trunk_fwd_tma.cu's, trunk_fwd_f32.cu's
  or trunk_fwd.cu's: `forward_library`); outputs as `trunk_reference`
  returns them with `fold`
  ([F, nb] f32, two IPE segments): the density gradient comes out folded,
  u [n, nb] f32 (K3). `dir_modes` and `rgbx` (K8-K10), `spa_modes` and
  `comp` (K6, K7), `out_y` (K11) as for trunk_reference."""
  dm = dir_modes or DirModes()
  sp = spa_modes or SpaModes()
  hc = 0 if pack.wc is None else int(pack.wc.shape[0])
  _instance_guard(pack, hc, fold, dm, sp, out_y)
  # By dtype and shape (`forward_library`): trunk_fwd_tma.cu (bf16) and
  # trunk_fwd_f32.cu (f32) take trunk_fwd.cu's arguments; trunk_fwd_f32.cu
  # reads the head transposed.
  route = forward_library(pack, out_y, fold, sp)
  if route == W1024_LIBRARY:
    return _w1024_forward(segs, pack)
  if route == DIR1_LIBRARY:
    return _dir1_forward(segs, pack)
  if route == WIDE_TF32_LIBRARY:
    return _wide_tf32_forward(segs, pack, fold)
  if route == WIDE_BF16_LIBRARY:
    return _wide_bf16_forward(segs, pack, fold)
  fwd_fn = getattr(_library(route, pack, hc), f'refnerf_{route}')
  head = pack.wct if route == 'trunk_fwd_f32' else pack.wc
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
    err = fwd_fn(
        1 if cdt == torch.bfloat16 else 0, pack.width, hc,
        _ptr(ki.x0), d0, _ptr(ki.x1), d1,
        n, pack.kin, pack.depth, pack.skip, _ptr(pack.w), _ptr(pack.wt),
        _ptr(pack.b), _ptr(pack.wd), _ptr(pack.wh), _ptr(pack.bh), hf,
        _ptr(head), _ptr(pack.bc), _ptr(fold), nb or 0, _ptr(sig),
        _ptr(hout), _ptr(cout), _ptr(u), _ptr(ki.g), _ptr(ki.v), _ptr(ki.k),
        ki.p, ki.lmax, int(ki.geo), _ptr(mat), _ptr(sg), _ptr(gm),
        _ptr(rawd), _ptr(rawt), _ptr(rgb), premult, rbias, pad,
        _ptr(si.lm), _ptr(si.lv), _ptr(si.delta), _ptr(si.bsig), si.samples,
        _ptr(wts), _ptr(y), torch.cuda.current_stream(dev).cuda_stream)
  _check_launch(err, 'trunk forward kernel')
  return [t for t in (y, sig, hout, cout, u, rgb, wts) if t is not None]


def unpack_trunk(pack: TrunkPack):
  """(weights, biases, keywords of trunk_reference) of a pack: each layer's
  [width, in] weight with the `kin` padding stripped, the heads, the skip
  period that puts the skip at `pack.skip`, the compute dtype."""
  fin = sum(pack.seg_dims)
  ws, off = [], 0
  for l, k in enumerate(pack.k_dims()):
    w = pack.w[off:off + pack.width * k].reshape(pack.width, k)
    off += pack.width * k
    ws.append(w[:, :k - pack.kin + fin] if l == 0 or l == pack.skip else w)
  head = lambda w, b: None if w is None else (w, b)
  return ws, list(pack.b.unbind(0)), dict(
      skip_period=pack.skip - 1 if pack.skip > 0 else pack.depth,
      wd=pack.wd, head_f32=head(pack.wh, pack.bh),
      head_cdt=head(pack.wc, pack.bc), compute_dtype=pack.compute_dtype)


def trunk_plain(segs, pack: TrunkPack, fold=None, dir_modes=None, rgbx=None,
                spa_modes=None, comp=None, out_y=False):
  """trunk_kernel's plain version on the pack's own weights: what the
  forward op runs for CPU tensors (`trunk_reference`)."""
  ws, bs, kw = unpack_trunk(pack)
  return trunk_reference(segs, ws, bs, density_grad=fold is not None,
                         fold=fold, dir_modes=dir_modes, rgbx=rgbx,
                         spa_modes=spa_modes, comp=comp, out_y=out_y, **kw)


# The forward launch as a PyTorch operator, so that torch.export records it
# as one node that a loaded program runs (serving.py): its schema is the
# TrunkPack, DirModes and SpaModes flattened into tensors and scalars.
TRUNK_OP = 'refnerf_tpu_torch::trunk_forward'


def _op_args(segs, pack: TrunkPack, fold=None, dm: Optional[DirModes] = None,
             rgbx=None, sp: Optional[SpaModes] = None, comp=None,
             out_y=False):
  dm, sp = dm or DirModes(), sp or SpaModes()
  rgbe = dm.rgbe or (0.0, 0.0, 0.0)
  rawd, rawt = rgbx if rgbx is not None else (None, None)
  delta, bsig = comp[:2] if comp is not None else (None, None)
  return (list(segs), pack.w, pack.wt, pack.b, pack.wd, pack.wh, pack.bh,
          pack.wc, pack.wct, pack.bc, list(pack.seg_dims), pack.kin,
          pack.depth, pack.width, pack.skip, fold, dm.ide_deg, dm.ide_at,
          dm.geo, dm.rgbe is not None, *rgbe, rawd, rawt, list(sp.scales),
          sp.samples, delta, bsig, bool(out_y))


def _from_op_args(segs, w, wt, b, wd, wh, bh, wc, wct, bc, seg_dims, kin,
                  depth, width, skip, fold, ide_deg, ide_at, geo, rgbe,
                  premult, rgb_bias, rgb_pad, rawd, rawt, scales, samples,
                  delta, bsig, out_y):
  """The inverse of `_op_args`: (segs, pack, fold, DirModes, rgbx,
  SpaModes, comp, out_y)."""
  cdt = 'bfloat16' if b.dtype == torch.bfloat16 else 'float32'
  pack = TrunkPack(w, wt, b, wd, wh, bh, wc, wct, bc, tuple(seg_dims), kin,
                   depth, width, skip, cdt)
  dm = DirModes(ide_deg, ide_at, geo,
                (premult, rgb_bias, rgb_pad) if rgbe else None)
  sp = SpaModes(tuple(scales), samples)
  return (list(segs), pack, fold, dm, (rawd, rawt) if rgbe else None, sp,
          (delta, bsig) if samples else None, out_y)


def launch_keys(which, pack, out_y, fold, dm: DirModes, sp: SpaModes):
  """The `launches` keys that one launch of kernel `which` counts under:
  its own, its wide-input or width-1024 instance's and each fused
  mode's."""
  keys = [which]
  if which in ('K1', 'K3', 'K4') and wide_input(pack, out_y, fold, sp):
    keys.append(which + ' wide')
  if which in ('K1', 'K4') and w1024(pack, out_y, fold, sp):
    keys.append(which + ' w1024')
  for k, on in (('K6', sp.samples), ('K7', sp.scales), ('K8', dm.ide_deg),
                ('K9', dm.geo), ('K10', dm.rgbe), ('K11', out_y)):
    if on:
      keys.append(k)
  return keys


def _count(which, pack, out_y, fold, dm: DirModes, sp: SpaModes):
  """One launch of kernel `which`, also counted under each fused mode."""
  for k in launch_keys(which, pack, out_y, fold, dm, sp):
    launches[k] += 1


def forward_kind(pack: TrunkPack, fold) -> str:
  """The forward kernel a pack's launch is: the spatial trunk has the
  density head (K1, K3 with the density gradient), the directional one
  has not (K2)."""
  return 'K2' if pack.wd is None else 'K1' if fold is None else 'K3'


@torch.library.custom_op(TRUNK_OP, mutates_args=(), device_types='cpu')
def trunk_forward(
    segs: List[torch.Tensor], w: torch.Tensor, wt: torch.Tensor,
    b: torch.Tensor, wd: Optional[torch.Tensor], wh: Optional[torch.Tensor],
    bh: Optional[torch.Tensor], wc: Optional[torch.Tensor],
    wct: Optional[torch.Tensor], bc: Optional[torch.Tensor],
    seg_dims: List[int], kin: int, depth: int, width: int, skip: int,
    fold: Optional[torch.Tensor], ide_deg: int, ide_at: int, geo: bool,
    rgbe: bool, premult: float, rgb_bias: float, rgb_pad: float,
    rawd: Optional[torch.Tensor], rawt: Optional[torch.Tensor],
    scales: List[float], samples: int, delta: Optional[torch.Tensor],
    bsig: Optional[torch.Tensor], out_y: bool) -> List[torch.Tensor]:
  """The forward launch (K1-K3, K6-K11 by its modes): for CUDA tensors
  trunk_kernel, counted in `launches`; for CPU tensors its plain version,
  `trunk_plain`, which launches nothing and counts nothing."""
  segs, pack, fold, dm, rgbx, sp, comp, out_y = _from_op_args(
      segs, w, wt, b, wd, wh, bh, wc, wct, bc, seg_dims, kin, depth, width,
      skip, fold, ide_deg, ide_at, geo, rgbe, premult, rgb_bias, rgb_pad,
      rawd, rawt, scales, samples, delta, bsig, out_y)
  return trunk_plain(segs, pack, fold, dir_modes=dm, rgbx=rgbx,
                     spa_modes=sp, comp=comp, out_y=out_y)


@trunk_forward.register_kernel('cuda')
def _trunk_forward_cuda(*args):
  segs, pack, fold, dm, rgbx, sp, comp, out_y = _from_op_args(*args)
  outs = trunk_kernel(segs, pack, fold, dir_modes=dm, rgbx=rgbx,
                      spa_modes=sp, comp=comp, out_y=out_y)
  _count(forward_kind(pack, fold), pack, out_y, fold, dm, sp)
  return outs


@trunk_forward.register_fake
def _trunk_forward_fake(*args):
  """Empty outputs of trunk_kernel's shapes and dtypes for each mode."""
  segs, pack, fold, dm, _, sp, _, out_y = _from_op_args(*args)
  n, cdt = segs[0].shape[0], DTYPES[pack.compute_dtype]
  new = lambda *shape, dtype=torch.float32: segs[0].new_empty(shape,
                                                              dtype=dtype)
  outs = [new(n, pack.width, dtype=cdt)] if out_y else []
  if pack.wd is not None:
    outs.append(new(n))
  if pack.wh is not None:
    outs.append(new(n, pack.wh.shape[0]))
  if pack.wc is not None:
    outs.append(new(n, pack.wc.shape[0], dtype=cdt))
  if fold is not None:
    outs.append(new(n, fold.shape[1]))
  if dm.rgbe is not None:
    outs.append(new(n, 3))
  if sp.samples:
    outs.append(new(n))
  return outs


def launch_trunk(segs, pack: TrunkPack, fold=None, dir_modes=None, rgbx=None,
                 spa_modes=None, comp=None, out_y=False):
  """The forward through the `trunk_forward` op: trunk_kernel's arguments
  and outputs, the launch counted."""
  return trunk_forward(*_op_args(segs, pack, fold, dir_modes, rgbx,
                                 spa_modes, comp, out_y))


def trunk_op_nodes(graph):
  """The `trunk_forward` nodes of an exported graph, each with its
  (kernel, library): 'K1' / 'K3' for the spatial trunk, 'K2' for the
  directional one, and `forward_library`'s choice for its shapes."""
  found = []
  for node in graph.nodes:
    if getattr(node.target, 'name', lambda: None)() != TRUNK_OP:
      continue
    args = torch.fx.node.map_arg(
        node.args, lambda a: a.meta['val'] if 'val' in a.meta else a)
    _, pack, fold, _, _, sp, _, out_y = _from_op_args(*args)
    found.append((node, forward_kind(pack, fold),
                  forward_library(pack, out_y, fold, sp)))
  return found


def trunk_backward_kernel(segs, pack: TrunkPack, cots, fold=None,
                          needs_dx=False, slab: Optional[int] = None,
                          dir_modes: Optional[DirModes] = None, rgbx=None,
                          rgb_bar=None, spa_modes: Optional[SpaModes] = None,
                          comp=None, ybar=None):
  """Launch the CUDA backward kernels (K4, K5; K8-K10 with `dir_modes`, K6
  and K7 with `spa_modes`, K11 with `ybar`); returns what
  `trunk_backward_reference` returns.

  Per slab of samples: the per-tile kernel recomputes the trunk and runs the
  inner chain, the head backward, the first-order reverse and (with the
  cotangent of u) the tangent chain, writing each layer's weight-gradient
  operands into a scratch buffer (sample-major for trunk_bwd_tma.cu and
  trunk_bwd_f32.cu, feature-major for trunk_bwd.cu: `backward_library`)
  and per-tile sums of the
  vector gradients; then a split-K product over samples forms each weight
  gradient's partials, and fixed-order reductions sum them (no atomics: the
  result does not depend on the schedule). With K6 a slab holds whole rays.
  `slab`: its rows, by default `bwd_slab_rows` of the trunk's width.
  """
  dm = dir_modes or DirModes()
  sp = spa_modes or SpaModes()
  sbar, hbar, cbar, ubar, *wbar = cots
  hc = 0 if pack.wc is None else int(pack.wc.shape[0])
  _instance_guard(pack, hc, fold, dm, sp, ybar is not None)
  if backward_library(pack, ybar is not None, fold) == W1024_LIBRARY:
    if needs_dx:
      raise NotImplementedError('the width-1024 backward emits no segment '
                                'cotangents')
    return _w1024_backward(segs, pack, cots, slab)
  if backward_library(pack, ybar is not None, fold) == WIDE_TF32_BWD_LIBRARY:
    if needs_dx:
      raise NotImplementedError('the f32 wide-input backward emits no segment '
                                'cotangents')
    return _wide_tf32_backward(segs, pack, cots, fold, slab)
  if backward_library(pack, ybar is not None, fold) == DIR1_LIBRARY:
    # It computes dx in the same pass whether or not needs_dx asks.
    out = _dir1_backward(segs, pack, cots)
    return out if needs_dx else out[:7] + (None,) + out[8:]
  lib = _library('trunk_bwd', pack, hc)
  cdt = DTYPES[pack.compute_dtype]
  # By dtype and shape (`backward_library`): trunk_bwd_tma.cu (bf16) and
  # trunk_bwd_f32.cu (f32) take the same arguments as trunk_bwd.cu, the
  # scratch sample-major; trunk_bwd_f32.cu reads the head untransposed.
  route = backward_library(pack, ybar is not None, fold)
  head = pack.wct
  if route == 'trunk_bwd':
    tile_fn, wgrad_fn = lib.refnerf_trunk_bwd, lib.refnerf_wgrad
  else:
    from refnerf_tpu_torch.ops import cuda_build
    rlib = cuda_build.library(route)
    tile_fn = getattr(rlib, f'refnerf_{route}')
    wgrad_fn = getattr(rlib, f'refnerf_wgrad_{route.rsplit("_", 1)[1]}')
    if route == 'trunk_bwd_f32':
      head = pack.wc
  sms = (torch.cuda.get_device_properties(segs[0].device).multi_processor_count
         if route == 'trunk_bwd_f32' or (route == 'trunk_bwd_tma' and
                                          pack.width == 128)
         else 0)
  split = lambda rp, m, n: _wgrad_split(route, rp, m, n, sms)
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
  slab = slab or bwd_slab_rows(pack.width)
  slab = n if n <= slab else slab // whole * whole
  cta = bwd_cta_rows(route, pack.width)
  rp_max = bwd_scratch_rows(route, pack.width, slab)
  # Scratch, feature-major [features][rows], rows padded to the CTA:
  # h_l and zeta_l (and s_l, p_l with the density gradient) [L][W], the
  # padded input x (and its tangent ts) [kin], cbar [hc].
  regions = [('hs', L * W), ('zs', L * W)]
  regions += [('ss', L * W), ('ps', L * W)] if dg else []
  regions += [('xs', kin)] + ([('ts', kin)] if dg else [])
  regions += [('cs', hc)] if hc else []
  scratch = torch.empty(sum(f for _, f in regions) * rp_max, device=dev,
                        dtype=cdt)
  dx_keep = torch.empty(rp_max * kin, device=dev) if needs_dx else None
  vec_part = torch.empty(rp_max // cta * nvec, device=dev)
  vec_mid = (torch.empty(rp_max // cta * nvec, device=dev) if cta != _TILE
             else None)
  # Partials of one gradient: the card-filling splits never outnumber the
  # SMs.
  nsplit_max = sms if sms else -(-rp_max // split(rp_max, W, W))
  wpart = torch.empty(nsplit_max * W * max(max(k_pack), W), device=dev)
  es = scratch.element_size()
  stream = torch.cuda.current_stream(dev).cuda_stream
  flag = 1 if cdt == torch.bfloat16 else 0
  mat, sg, gm = ki.tables

  def at(t, row, width):
    return None if t is None else t.data_ptr() + row * width * t.element_size()

  with torch.cuda.device(dev):
    for start in range(0, n, slab):
      rows = min(slab, n - start)
      rp = bwd_scratch_rows(route, W, rows)
      reg, off = {}, 0
      for name, feats in regions:
        reg[name] = scratch.data_ptr() + off * rp * es
        off += feats
      layer = lambda name, l: reg[name] + l * W * rp * es
      err = tile_fn(
          flag, W, hc, at(ki.x0, start, d0), d0, at(ki.x1, start, d1), d1,
          rows, kin, L, pack.skip, _ptr(pack.w), _ptr(pack.wt), _ptr(pack.b),
          _ptr(pack.wd), _ptr(pack.wh), _ptr(pack.bh), hf, _ptr(head),
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
      for l in range(L):
        ncut = 0 if l == 0 else W
        ksplit = split(rp, W, k_pack[l])
        nsplit = -(-rp // ksplit)
        err = wgrad_fn(
            flag, W, k_pack[l], ncut, rp, ksplit, layer('zs', l),
            reg['xs'] if l == 0 else layer('hs', l - 1), reg['xs'],
            layer('ss', l) if dg else None,
            (reg['ts'] if l == 0 else layer('ps', l - 1)) if dg else None,
            reg.get('ts'), wpart.data_ptr(), stream)
        _check_launch(err, 'weight-gradient kernel')
        err = lib.refnerf_reduce(wpart.data_ptr(), nsplit, W, k_pack[l],
                                 k_out[l], dws[l].data_ptr(), acc, stream)
        _check_launch(err, 'reduction kernel')
      if hc:
        ksplit = split(rp, hc, W)
        nsplit = -(-rp // ksplit)
        err = wgrad_fn(flag, hc, W, W, rp, ksplit, reg['cs'],
                                layer('hs', L - 1), None, None, None, None,
                                wpart.data_ptr(), stream)
        _check_launch(err, 'weight-gradient kernel')
        err = lib.refnerf_reduce(wpart.data_ptr(), nsplit, hc, W, W,
                                 dwc.data_ptr(), acc, stream)
        _check_launch(err, 'reduction kernel')
      nparts = rp // cta
      if cta == _TILE:
        err = lib.refnerf_reduce(vec_part.data_ptr(), nparts, 1, nvec, nvec,
                                 vec.data_ptr(), acc, stream)
      else:
        # The two-tile CTAs' partials in two fixed-order stages, so that a
        # thread sums tens of them and not a thousand: groups q of the rows
        # q * rows + r first, then the rows.
        q = _vec_groups(nparts)
        err = lib.refnerf_reduce(vec_part.data_ptr(), q, nparts // q, nvec,
                                 nvec, vec_mid.data_ptr(), 0, stream)
        _check_launch(err, 'reduction kernel')
        err = lib.refnerf_reduce(vec_mid.data_ptr(), nparts // q, 1, nvec,
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


def _forward(spec: _Spec, segs, params, rgbx=None, comp=None):
  ws, bs, wd, head_f32, head_cdt = _unflatten(spec, params)
  kw = dict(dir_modes=spec.dir_modes, rgbx=rgbx, spa_modes=spec.spa_modes,
            comp=comp, out_y=spec.has[0])
  if spec.kernel:
    return launch_trunk(segs, spec.pack, spec.fold, **kw)
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
    _count(which, spec.pack, spec.has[0], spec.fold, spec.dir_modes,
           spec.spa_modes)
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
    outs = _forward(spec, [a, b], params, comp=comp)
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
    return tuple(_forward(spec, segs, params, rgbx))

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
                        pack: Optional[TrunkPack] = None,
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
  compute dtype; its cotangent enters the backward. Under mode 'auto' a
  trunk without a kernel instance (`missing_instance`) takes the plain
  versions, logged once; under 'on' it raises.

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
  if delta is not None and wd is None:
    raise ValueError('the compositing epilogue needs the density head')
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
  if kernel:
    kernel = _kernel_for(
        pack, 0 if head_cdt is None else int(head_cdt[0].shape[0]), mode,
        fold=fold, sp=spa, y=bool(out_y))
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
  if _needs_grad([*params, bsig]):
    outs = list(SpatialTrunk.apply(spec, *segs, dcol, bsig, *params))
  else:
    # Nothing to differentiate (a served request, an export): the forward
    # alone, without the autograd Function.
    outs = _forward(spec, segs, params,
                    comp=(dcol, bsig) if spa.samples else None)
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
                pack: Optional[TrunkPack] = None,
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
  `rgb_epilogue`. `pack` and the shapes without an instance as for
  fused_encoded_trunk.
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
  if kernel and pack is None:
    pack = pack_trunk(weights, biases, visible_dims(flat, dm),
                      skip_period=skip_period, head_f32=head_f32,
                      compute_dtype=compute_dtype)
  if kernel:
    kernel = _kernel_for(pack, 0, mode, dm=dm)
  spec = _Spec(len(weights), skip_period, compute_dtype, kernel,
               pack if kernel else None, None, (False, False, True, False),
               True, dm)
  if _needs_grad([*flat, *params, *rgbx]):
    outs = DirectionalTrunk.apply(spec, len(flat), *flat, *params, *rgbx)
  else:
    outs = _forward(spec, flat, params, rgbx or None)
  outs = [o.reshape(*lead, o.shape[-1]) for o in outs]
  return outs[0] if len(outs) == 1 else tuple(outs)
