"""The Ref-NeRF MLP (counterpart of refnerf_tpu/models/mlp.py).

One module for the proposal and NeRF MLPs, with the JAX module's fields and
layer names (`spatial_i`, `raw_density`, ..., `viewdir_i`, `rgb`), so a flax
parameter tree maps onto the state_dict one transpose per layer
(refnerf_tpu_torch/convert.py).

Both dense trunks always run in the fused formulation of the JAX package's
`fused_trunk='on'` path (mlp.py:252-333, :499-642): the spatial trunk through
`fused_mlp.fused_encoded_trunk` (K1; K3 with density-gradient normals; K4
backward), the directional trunk through `fused_mlp.fused_trunk` (K2; K5
backward). The flags `fuse_dir_enc`, `fuse_dir_geo` and `fuse_dir_rgb` move
the IDE (K8), the direction geometry (K9) and the colour epilogue (K10) into
the directional trunk; `fuse_ipe_trig` moves the IPE (K7) and
`fuse_compositing` the compositing weights (K6) into the spatial trunk, and
`fuse_lift` takes the lifted Gaussians in closed form (`lifted`, from
render.cast_rays_lifted). All under JAX's gates; a flag that is set but
cannot act is logged once. On CUDA tensors those are the hand-written
kernels; on the CPU, or with `fused_trunk='off'`, their plain versions.

Ported: evaluation and training (`train=True`: density-gradient normals,
differentiable through u) with predicted normals, the IDE or the positional
direction encoding, reflections, roughness, diffuse/specular/tint and n.v;
without view directions (`Model.use_viewdirs = False`, passed in at build
time as `use_viewdirs`) the spatial trunk also returns its features y (K11)
and the rgb head runs on them, outside the trunk (mlp.py:295, :652-656).
Not ported, and refused with NotImplementedError: density and bottleneck
noise and a trunk that ends in a skip concat.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from refnerf_tpu_torch.ops import coord
from refnerf_tpu_torch.ops import fused_mlp
from refnerf_tpu_torch.ops import geopoly
from refnerf_tpu_torch.ops import image as image_ops
from refnerf_tpu_torch.ops import ref_utils
from refnerf_tpu_torch.utils import ginlite

# The activations of the MLP's defaults; gin may name them as references.
ACTIVATIONS = {'relu': torch.relu, 'softplus': F.softplus,
               'sigmoid': torch.sigmoid}

# Once per process and (reason, detail): a fusion flag that is set but
# cannot act (mlp.py:34-46).
_FALLBACK_WARNED = set()


def _warn_fused_fallback(reason: str, detail: str):
  if (reason, detail) not in _FALLBACK_WARNED:
    _FALLBACK_WARNED.add((reason, detail))
    logging.warning('fused_trunk: %s (%s); the plain chain runs instead.',
                    reason, detail)


def activation(v):
  """An activation by name; gin references resolve by their last part."""
  if callable(v) and not isinstance(v, ginlite.Ref):
    return v
  name = v.name if isinstance(v, ginlite.Ref) else str(v)
  name = name.split('.')[-1]
  if name not in ACTIVATIONS:
    raise ValueError(f'unknown activation {v!r}; known: {sorted(ACTIVATIONS)}')
  return ACTIVATIONS[name]


@dataclasses.dataclass
class MLPConfig:
  """The JAX MLP's fields and defaults (mlp.py:70-158)."""
  net_depth: int = 8
  net_width: int = 256
  bottleneck_width: int = 256
  net_depth_viewdirs: int = 1
  net_width_viewdirs: int = 128
  net_activation: Any = 'relu'
  min_deg_point: int = 0
  max_deg_point: int = 12
  weight_init: str = 'torch_uniform'
  skip_layer: int = 4
  skip_layer_dir: int = 4  # unused, as in the JAX MLP and the reference
  num_rgb_channels: int = 3
  deg_view: int = 4
  use_reflections: bool = False
  use_directional_enc: bool = False
  enable_pred_roughness: bool = False
  roughness_activation: Any = 'softplus'
  roughness_bias: float = -1.0
  use_diffuse_color: bool = False
  use_specular_tint: bool = False
  use_n_dot_v: bool = False
  enable_pred_specular_density: bool = False
  bottleneck_noise: float = 0.0
  density_activation: Any = 'softplus'
  density_bias: float = -1.0
  density_noise: float = 0.0
  fuse_compositing: bool = False
  fuse_dir_enc: bool = False
  fuse_dir_rgb: bool = False
  fuse_dir_geo: bool = False
  fuse_lift: bool = False
  fuse_ipe_trig: bool = False
  rgb_premultiplier: float = 1.0
  rgb_activation: Any = 'sigmoid'
  rgb_bias: float = 0.0
  rgb_padding: float = 0.001
  enable_pred_normals: bool = False
  disable_density_normals: bool = False
  disable_rgb: bool = False
  srgb_mapping: bool = True
  srgb_mapping_normalization: bool = True
  warp_fn: Any = None
  basis_shape: str = 'icosahedron'
  basis_subdivisions: int = 2
  compute_dtype: str = 'float32'
  # 'auto' and 'on': the CUDA kernels for CUDA tensors; 'off': the plain
  # versions everywhere. CPU tensors always take the plain versions.
  fused_trunk: str = 'auto'
  # The TPU kernels' block size (0: 512 in bf16, 256 in f32). The kernels
  # here do not take it; it is read only for the fuse_compositing gate,
  # which JAX sets by it (samples per ray must divide it).
  fused_block: int = 0


class MLP(nn.Module):
  """Spatial trunk + density/normal/roughness/colour heads + directional trunk.

  `use_viewdirs` (the Model's field) says whether the MLP will be given view
  directions. The JAX module creates its layers when they are first called,
  so without view directions its tree has no bottleneck, no directional
  trunk and no roughness or tint head, and its rgb head reads the spatial
  trunk's features; this module builds that tree.
  """

  def __init__(self, use_viewdirs: bool = True, **kwargs):
    super().__init__()
    self.cfg = c = MLPConfig(**kwargs)
    self.use_viewdirs = use_viewdirs
    if c.warp_fn is not None:
      raise NotImplementedError('warp_fn is not ported')
    if c.weight_init != 'torch_uniform':
      raise NotImplementedError(f'weight_init {c.weight_init!r} is not ported')
    if c.use_reflections and not (c.enable_pred_normals or
                                  not c.disable_density_normals):
      raise ValueError('Normals must be computed for reflection directions.')
    if c.use_n_dot_v and c.disable_density_normals and not (
        c.enable_pred_normals):
      raise ValueError('use_n_dot_v needs a normals source (density '
                       'normals or predicted normals).')
    if c.enable_pred_specular_density and not c.use_diffuse_color:
      raise ValueError('Specular density is useless if not using diffuse '
                       'color.')
    if not use_viewdirs and c.use_diffuse_color and not c.disable_rgb:
      # The reference hits an UnboundLocalError here (mlp.py:469-475).
      raise ValueError('use_diffuse_color requires view directions '
                       '(Model.use_viewdirs = True).')
    if use_viewdirs and c.net_depth_viewdirs < 1:
      raise NotImplementedError('a directional trunk of depth 0 is not ported')
    self.net_activation = activation(c.net_activation)
    self.density_activation = activation(c.density_activation)
    self.roughness_activation = activation(c.roughness_activation)
    self.rgb_activation = activation(c.rgb_activation)

    basis = np.array(
        geopoly.generate_basis(c.basis_shape, c.basis_subdivisions)).T
    self.register_buffer('pos_basis_t', torch.tensor(basis, dtype=torch.float32),
                         persistent=False)
    self.scales = 2.0**np.arange(c.min_deg_point, c.max_deg_point)
    if c.use_directional_enc:
      self.dir_enc_fn = ref_utils.generate_ide_fn(c.deg_view)
      dir_width = 2 * ref_utils.ide_constants(c.deg_view)[0].shape[1]
    else:
      self.dir_enc_fn = lambda d, _: coord.pos_enc(d, 0, c.deg_view)
      dir_width = 3 + 6 * c.deg_view

    w, fin = c.net_width, 2 * basis.shape[1] * len(self.scales)
    skips = fused_mlp.skip_input_layers(c.net_depth, c.skip_layer)
    for i in range(c.net_depth):
      d_in = fin if i == 0 else w + (fin if i in skips else 0)
      self.add_module(f'spatial_{i}', nn.Linear(d_in, w))
    self.raw_density = nn.Linear(w, 1)
    self._heads = []  # (name, layer name, width) of the f32 head block
    if c.enable_pred_specular_density:
      self.raw_specular_density = nn.Linear(w, 1)
      self._heads.append(('specular_density', 'raw_specular_density', 1))
    if c.enable_pred_normals:
      self.grad_pred = nn.Linear(w, 3)
      self._heads.append(('grad_pred', 'grad_pred', 3))
    self._packs = {}
    if not use_viewdirs:
      self.rgb = nn.Linear(w, c.num_rgb_channels)
      return
    if c.enable_pred_roughness:
      self.raw_roughness = nn.Linear(w, 1)
      self._heads.append(('roughness', 'raw_roughness', 1))
    if c.use_diffuse_color:
      self.raw_rgb_diffuse = nn.Linear(w, c.num_rgb_channels)
      self._heads.append(('diffuse', 'raw_rgb_diffuse', c.num_rgb_channels))
    if c.use_specular_tint:
      self.raw_tint = nn.Linear(w, 3)
      self._heads.append(('tint', 'raw_tint', 3))
    if c.bottleneck_width > 0:
      self.bottleneck = nn.Linear(w, c.bottleneck_width)

    dir_in = c.bottleneck_width + dir_width + int(c.use_n_dot_v)
    wv = c.net_width_viewdirs
    skips = fused_mlp.skip_input_layers(c.net_depth_viewdirs, c.skip_layer)
    for i in range(c.net_depth_viewdirs):
      d_in = dir_in if i == 0 else wv + (dir_in if i in skips else 0)
      self.add_module(f'viewdir_{i}', nn.Linear(d_in, wv))
    self.rgb = nn.Linear(wv, c.num_rgb_channels)

  def reset_parameters(self, generator: torch.Generator):
    """Initialise as the JAX MLP does with 'torch_uniform' (mlp.py:49-64):
    kernels uniform in +-1/sqrt(fan_in), zero biases."""
    with torch.no_grad():
      for layer in self.children():
        if isinstance(layer, nn.Linear):
          lim = 1 / math.sqrt(layer.in_features)
          layer.weight.uniform_(-lim, lim, generator=generator)
          layer.bias.zero_()

  def _stack(self, prefix, depth):
    layers = [getattr(self, f'{prefix}_{i}') for i in range(depth)]
    return [l.weight for l in layers], [l.bias for l in layers]

  def _pack(self, name, build):
    """The kernel's weight layout of one trunk, cached until a weight changes."""
    key = (name, self.cfg.compute_dtype)
    sig = tuple((p.data_ptr(), p._version) for p in self.parameters())
    hit = self._packs.get(key)
    if hit is None or hit[0] != sig:
      hit = self._packs[key] = (sig, build())
    return hit[1]

  def _block(self):
    """The block of the fuse_compositing gate (mlp.py:216-219)."""
    if self.cfg.fused_block:
      return self.cfg.fused_block
    return 512 if self.cfg.compute_dtype == 'bfloat16' else 256

  def spatial_fused(self) -> bool:
    """Whether the spatial trunk runs the formulation that fuse_lift,
    fuse_ipe_trig and fuse_compositing act in: a ReLU trunk (JAX's `_fused`,
    mlp.py:221-241). A set flag that cannot act is logged once."""
    if self.net_activation in (torch.relu, F.relu):
      return True
    for f in ('fuse_lift', 'fuse_ipe_trig', 'fuse_compositing'):
      if getattr(self.cfg, f):
        _warn_fused_fallback(f'{f} inactive', 'non-relu net_activation')
    return False

  def _spatial(self, lm, lv, rgb_heads, density_grad, delta=None,
               out_y=False):
    """K1/K3 (K6, K7 by the fuse flags, K11 with `out_y`): the trunk's
    features y or None, raw density, the f32 heads, the bottleneck, with
    `density_grad` the density-gradient normals (mlp.py:252-333) and with
    `delta` the compositing weights."""
    c = self.cfg
    ws, bs = self._stack('spatial', c.net_depth)
    heads = [h for h in self._heads
             if rgb_heads or h[0] in ('specular_density', 'grad_pred')]
    head_f32 = None
    if heads:
      layers = [getattr(self, h[1]) for h in heads]
      head_f32 = (torch.cat([l.weight for l in layers]),
                  torch.cat([l.bias for l in layers]))
    head_cdt = None
    if rgb_heads and c.bottleneck_width > 0:
      head_cdt = (self.bottleneck.weight, self.bottleneck.bias)
    kw = dict(wd=self.raw_density.weight, head_f32=head_f32, head_cdt=head_cdt)
    pack = None
    if fused_mlp.use_kernel(lm, c.fused_trunk):
      f = lm.shape[-1] * len(self.scales)
      pack = self._pack('spatial', lambda: fused_mlp.pack_trunk(
          ws, bs, (f, f), skip_period=c.skip_layer,
          compute_dtype=c.compute_dtype, **kw))
    outs = list(fused_mlp.fused_encoded_trunk(
        lm, lv, self.scales, ws, bs, bd=self.raw_density.bias,
        skip_period=c.skip_layer, compute_dtype=c.compute_dtype,
        mode=c.fused_trunk, activation=self.net_activation, pack=pack,
        density_grad=density_grad,
        in_kernel_trig=c.fuse_ipe_trig and self.spatial_fused(), delta=delta,
        act_bias=c.density_bias, out_y=out_y, **kw))
    y = outs.pop(0) if out_y else None
    raw_density = outs.pop(0)
    fh = {}
    if head_f32 is not None:
      hout, off = outs.pop(0), 0
      for name, _, dim in heads:
        fh[name] = hout[..., off:off + dim]
        off += dim
    if head_cdt is not None:
      fh['bottleneck'] = outs.pop(0)
    normals = None
    if density_grad:
      u_lm = outs.pop(0)  # d sigma / d lifted-means, [..., n_basis]
      normals = -ref_utils.l2_normalize(u_lm @ self.pos_basis_t.t())
    if delta is not None:
      fh['weights'] = outs.pop(0)
    return y, raw_density, fh, normals

  def _directional(self, segs, **fuse):
    """K2 (with K8-K10 by `fuse`, fused_trunk's keywords): raw rgb of the
    directional trunk and its rgb head, and with the colour epilogue the
    final rgb (mlp.py:599-642)."""
    c = self.cfg
    ws, bs = self._stack('viewdir', c.net_depth_viewdirs)
    head_f32 = (self.rgb.weight, self.rgb.bias)
    pack = None
    if fused_mlp.use_kernel(segs[0], c.fused_trunk):
      dims = fused_mlp.trunk_dims(segs, **fuse)
      pack = self._pack(f'directional{dims}', lambda: fused_mlp.pack_trunk(
          ws, bs, dims, skip_period=c.skip_layer, head_f32=head_f32,
          compute_dtype=c.compute_dtype))
    return fused_mlp.fused_trunk(
        segs, ws, bs, head_f32, skip_period=c.skip_layer,
        compute_dtype=c.compute_dtype, mode=c.fused_trunk,
        activation=self.net_activation, pack=pack, **fuse)

  def _dir_fusions(self):
    """Which directional stages run in the trunk (mlp.py:499-613), each
    flag that is set but cannot act logged once."""
    c = self.cfg
    ide = c.fuse_dir_enc and c.use_directional_enc
    if c.fuse_dir_enc and not ide:
      _warn_fused_fallback('fuse_dir_enc inactive', 'needs use_directional_enc')
    geo = (ide and c.fuse_dir_geo and c.use_reflections and c.use_n_dot_v
           and c.enable_pred_normals)
    if c.fuse_dir_geo and not geo:
      _warn_fused_fallback(
          'fuse_dir_geo inactive',
          'needs fuse_dir_enc + reflections + n_dot_v + pred normals')
    rgb = (c.fuse_dir_rgb and c.use_diffuse_color and c.use_specular_tint
           and c.srgb_mapping and c.srgb_mapping_normalization
           and self.rgb_activation is torch.sigmoid
           and c.num_rgb_channels == 3)
    if c.fuse_dir_rgb and not rgb:
      _warn_fused_fallback(
          'fuse_dir_rgb inactive',
          'needs diffuse+tint+srgb+norm with sigmoid rgb_activation')
    return ide, geo, rgb

  def _view_rgb(self, means, viewdirs, fh, grad_pred, normals, roughness):
    """The directional branch (mlp.py:476-642): the direction encoding (the
    IDE or the positional encoding, or with K8/K9 its raw inputs) beside the
    bottleneck, through the directional trunk and its rgb head (K2). Returns
    (raw rgb [..., s, C], the colour epilogue's rgb [..., s, 3] with K10 or
    None)."""
    c = self.cfg
    lead = means.shape[:-1]
    n = math.prod(lead)
    fuse_ide, fuse_geo, fuse_rgb = self._dir_fusions()
    segs = []
    if c.bottleneck_width > 0:
      segs.append(fh['bottleneck'].reshape(n, -1))
    vb = viewdirs[..., None, :].expand(means.shape)
    fuse = {}
    if fuse_ide:
      # K8/K9: the raw inputs of the IDE go in; the 2P-wide encoding never
      # leaves the trunk (mlp.py:526-597).
      kappa_inv = (roughness if c.enable_pred_roughness
                   else torch.zeros_like(means[..., :1]))
      fuse = dict(ide_deg=c.deg_view, ide_at=len(segs), ide_geo=fuse_geo)
      if fuse_geo:
        segs.append((grad_pred.reshape(n, 3), vb.reshape(n, 3),
                     kappa_inv.reshape(n, 1)))
      else:
        dirs = (ref_utils.reflect(-vb, normals) if c.use_reflections else vb)
        segs.append((dirs.reshape(n, 3), kappa_inv.reshape(n, 1)))
        if c.use_n_dot_v:
          segs.append(torch.sum(normals * vb, dim=-1,
                                keepdim=True).reshape(n, 1))
    else:
      if c.use_reflections:
        # viewdirs point camera->point; flip so refdirs point outward.
        dir_enc = self.dir_enc_fn(ref_utils.reflect(-vb, normals), roughness)
      elif c.enable_pred_roughness:
        dir_enc = self.dir_enc_fn(vb, roughness)
      else:
        # One encoding a ray, broadcast to its samples (mlp.py:557-561).
        dir_enc = self.dir_enc_fn(viewdirs, roughness)
        dir_enc = dir_enc[..., None, :].expand(*lead, dir_enc.shape[-1])
      # In the compute dtype at its producer (mlp.py:562-568).
      dir_enc = dir_enc.to(fused_mlp.DTYPES[c.compute_dtype])
      if c.use_n_dot_v:
        # n.v rides as one extra plane on the encoding segment (mlp.py:584).
        dotprod = torch.sum(normals * vb, dim=-1, keepdim=True)
        dir_enc = torch.cat([dir_enc, dotprod.to(dir_enc.dtype)], dim=-1)
      segs.append(dir_enc.reshape(n, -1))
    fused_rgb = None
    if fuse_rgb:
      # K10: the colour epilogue runs after the rgb head, in the trunk.
      fuse['rgb_epilogue'] = (fh['diffuse'], fh['tint'], c.rgb_premultiplier,
                              c.rgb_bias, c.rgb_padding)
      raw_rgb, fused_rgb = self._directional(segs, **fuse)
      fused_rgb = fused_rgb.reshape(*lead, 3)
    else:
      raw_rgb = self._directional(segs, **fuse)
    return raw_rgb.reshape(*lead, c.num_rgb_channels), fused_rgb

  def forward(self, gaussians, viewdirs: Optional[torch.Tensor] = None,
              train: bool = False, delta: Optional[torch.Tensor] = None,
              lifted=None):
    """Evaluate the MLP on sample Gaussians (means [..., s, 3], covs
    [..., s, 3, 3]) seen from viewdirs [..., 3].

    `train` turns on the density-gradient normals (mlp.py:389-392). `delta`
    [..., s]: each sample's t-interval times |direction|; with
    `fuse_compositing`, under JAX's gates (mlp.py:394-408), the results
    then hold the compositing weights. `lifted`: (lm, lv) [..., s, nb] from
    render.cast_rays_lifted (`fuse_lift`), in place of covs (may be None).
    Returns a dict of per-sample results, as the JAX MLP does.
    """
    c = self.cfg
    means, covs = gaussians
    compute_density_normals = (
        not c.disable_density_normals
        and (train or ((c.use_reflections or c.use_n_dot_v)
                       and not c.enable_pred_normals)))
    if train and (c.density_noise > 0 or c.bottleneck_noise > 0):
      raise NotImplementedError(
          'density_noise / bottleneck_noise > 0 draw noise from an rng; '
          'stochastic training is not ported (ROADMAP queue 1, item 14)')
    if not c.disable_rgb and (viewdirs is None) == self.use_viewdirs:
      raise ValueError(
          f'an MLP built with use_viewdirs={self.use_viewdirs} was called '
          f'{"without" if viewdirs is None else "with"} view directions')
    # Without view directions the rgb head reads the trunk's features (K11,
    # mlp.py:277, :295).
    rgb_heads = not c.disable_rgb and viewdirs is not None
    need_y = not c.disable_rgb and viewdirs is None
    if delta is not None and not (
        c.fuse_compositing and c.density_noise == 0
        and self.density_activation is F.softplus and delta.shape[-1] > 0
        and self._block() % delta.shape[-1] == 0 and self.spatial_fused()):
      if c.fuse_compositing:
        _warn_fused_fallback(
            'fuse_compositing inactive',
            f'needs density_noise == 0, softplus density, and num_samples '
            f'({delta.shape[-1]}) dividing fused_block ({self._block()})')
      delta = None

    if lifted is None:
      lm, lv = coord.lift_and_diagonalize(means, covs, self.pos_basis_t)
    elif not self.spatial_fused():
      raise ValueError(
          'lifted (fuse_lift) inputs require the fused spatial path; the '
          'model must gate cast_rays_lifted on the same predicate')
    else:
      lm, lv = lifted
    y, raw_density, fh, normals = self._spatial(
        lm, lv, rgb_heads, compute_density_normals, delta, need_y)

    normals_pred = grad_pred = None
    normals_to_use = normals
    if c.enable_pred_normals:
      grad_pred = fh['grad_pred']
      normals_pred = normals_to_use = -ref_utils.l2_normalize(grad_pred)
    density = self.density_activation(raw_density + c.density_bias)

    roughness = 0.0
    tint = diffuse = specular = None
    fuse_rgb = False
    if c.disable_rgb:
      rgb = torch.zeros_like(means)
    else:
      if viewdirs is None:
        # The rgb head on y, outside the trunk: flax's Dense promotes the
        # compute-dtype y and its f32 parameters to f32 (mlp.py:652-653).
        raw_rgb = self.rgb(y.float())
      else:
        if c.use_specular_tint:
          tint = torch.sigmoid(fh['tint'])
        if c.enable_pred_roughness:
          roughness = self.roughness_activation(
              fh['roughness'] + c.roughness_bias)
        raw_rgb, fused_rgb = self._view_rgb(means, viewdirs, fh, grad_pred,
                                            normals_to_use, roughness)
        fuse_rgb = fused_rgb is not None
      rgb = self.rgb_activation(c.rgb_premultiplier * raw_rgb + c.rgb_bias)

      if c.use_diffuse_color:
        # Linear diffuse starts near 0.25 so the combined colour starts ~0.5.
        diffuse_linear = torch.sigmoid(fh['diffuse'] - math.log(3.0))
        specular_linear = tint * rgb if c.use_specular_tint else 0.5 * rgb
        rgb = specular_linear + diffuse_linear
        if c.srgb_mapping:
          if not fuse_rgb:  # else K10 ran this in the trunk
            # Written as maximum/minimum against tensor constants: the ties
            # at the gamut bound (rgb / max(rgb) = 1, linear_to_srgb(1) = 1)
            # are hit at every normalised sample, and there JAX passes half
            # the gradient to each side (mlp.py:669-675).
            if c.srgb_mapping_normalization:
              mx = rgb.amax(dim=-1, keepdim=True)
              rgb = rgb / torch.maximum(mx, torch.ones_like(mx))
            rgb = image_ops.clip01(image_ops.linear_to_srgb(rgb))
          diffuse = image_ops.clip01(image_ops.linear_to_srgb(diffuse_linear))
          specular = image_ops.clip01(
              image_ops.linear_to_srgb(specular_linear))
        else:
          diffuse, specular = diffuse_linear, specular_linear
      if fuse_rgb:
        # The epilogue, padding included, ran in the trunk; the chain above
        # gives only the diffuse and specular extras (mlp.py:681-684).
        rgb = fused_rgb
      else:
        # Map colour to [-rgb_padding, 1 + rgb_padding].
        rgb = rgb * (1 + 2 * c.rgb_padding) - c.rgb_padding

    out = dict(density=density, rgb=rgb)
    if 'weights' in fh:
      # The compositing weights of the trunk (K6), used by the model in
      # place of render.compute_alpha_weights.
      out['weights'] = fh['weights']
    if not c.disable_density_normals:
      out['normals'] = normals
    if c.enable_pred_normals:
      out['normals_pred'] = normals_pred
      out['grad_pred'] = grad_pred
    if c.use_specular_tint:
      out['tint'] = tint
    if c.use_diffuse_color:
      out['diffuse'] = diffuse
      out['specular'] = specular
      if c.enable_pred_specular_density:
        out['specular_density'] = self.density_activation(
            fh['specular_density'][..., 0] + c.density_bias)
    if c.enable_pred_roughness:
      out['roughness'] = roughness
    return out
