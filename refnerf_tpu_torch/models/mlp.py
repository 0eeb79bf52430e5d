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
Under `fused_trunk='auto'` a trunk whose shape has no kernel instance runs
the plain versions too, logged once (under 'on' it raises).

A trunk with a non-ReLU activation, or one that ends in a skip concat,
runs the plain layer stack instead (JAX's `_fused`, mlp.py:221-241): dense
layers in the compute dtype under torch autograd, the heads as separate
f32 layers on its output, the density normals by autograd (second order in
training), logged once where the kernels would have run.

Ported: evaluation and training (`train=True`: density-gradient normals,
differentiable through u) with predicted normals, the IDE or the positional
direction encoding, reflections, roughness, diffuse/specular/tint and n.v;
without view directions (`Model.use_viewdirs = False`, passed in at build
time as `use_viewdirs`) the spatial trunk also returns its features y (K11)
and the rgb head runs on them, outside the trunk (mlp.py:295, :652-656).
In training, density, specular-density and bottleneck noise (mlp.py:436-445,
:516-520) come from the forward's `draws` (train/sampling.py); a directional
trunk of depth 0 sends the rgb head the concatenated inputs (mlp.py:498-499,
:641-650). The weight inits are JAX's four (mlp.py:49-64). `warp_fn` is
read and unused, as in JAX (mlp.py:143).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
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
               'sigmoid': torch.sigmoid, 'elu': F.elu}

# The weight inits (mlp.py:49-64): (kind, scale, fan), as JAX's
# variance_scaling: uniform in +-sqrt(3 scale / fan), or a normal truncated
# at two standard deviations of variance scale / fan.
WEIGHT_INITS = {'torch_uniform': ('uniform', 1 / 3, 'fan_in'),
                'he_uniform': ('uniform', 2.0, 'fan_in'),
                'glorot_uniform': ('uniform', 1.0, 'fan_avg'),
                'lecun_normal': ('truncated_normal', 1.0, 'fan_in')}
# jax.nn.initializers' stddev of the unit normal truncated to [-2, 2].
_TRUNC_STD = .87962566103423978

# Once per process and (reason, detail): a fusion flag that is set but
# cannot act (mlp.py:34-46).
_FALLBACK_WARNED = set()


def _warn_fused_fallback(reason: str, detail: str):
  if (reason, detail) not in _FALLBACK_WARNED:
    _FALLBACK_WARNED.add((reason, detail))
    logging.warning('fused_trunk: %s (%s); the plain chain runs instead.',
                    reason, detail)


def _need_draws(name, draws):
  """As JAX without an rng key (mlp.py:437-438, :517-518)."""
  if draws is None:
    raise ValueError(f'{name} > 0 requires draws (Config.randomized)')


def trailing_concat(depth: int, skip: int) -> bool:
  """Whether a trunk of `depth` layers ends in a skip concat (mlp.py:234)."""
  return depth > 1 and (depth - 1) % skip == 0


def plain_stack(x, layers, act, skip, cdt):
  """The plain trunk (mlp.py:334-344, :644-649): each dense layer in the
  compute dtype, as flax's Dense with dtype=cdt casts its inputs and f32
  parameters, then the activation; after every skip-th layer the trunk's
  input is appended (promoted to the wider dtype, as jnp.concatenate)."""
  inputs = x
  for i, layer in enumerate(layers):
    x = act(F.linear(x.to(cdt), layer.weight.to(cdt), layer.bias.to(cdt)))
    if i % skip == 0 and i > 0:
      dt = torch.promote_types(x.dtype, inputs.dtype)
      x = torch.cat([x.to(dt), inputs.to(dt)], dim=-1)
  return x


@contextlib.contextmanager
def frozen_packs(module: nn.Module):
  """Within, every MLP in `module` takes the kernel packs it has cached (run
  it once on the request's shapes first) and never rebuilds them. For
  torch.export: it traces with fake parameters, whose data pointers the
  cache key cannot read, and the cached packs enter the exported program as
  constants, built once from the real weights."""
  mlps = [m for m in module.modules() if isinstance(m, MLP)]
  for m in mlps:
    m._packs_frozen = True
  try:
    yield
  finally:
    for m in mlps:
      m._packs_frozen = False


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
    if c.weight_init not in WEIGHT_INITS:
      raise ValueError(f'Unknown weight init {c.weight_init}')
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
    # The heads read the trunk's output, which a trailing skip concat widens.
    wo = w + (fin if trailing_concat(c.net_depth, c.skip_layer) else 0)
    self.raw_density = nn.Linear(wo, 1)
    self._heads = []  # (name, layer name, width) of the f32 head block
    if c.enable_pred_specular_density:
      self.raw_specular_density = nn.Linear(wo, 1)
      self._heads.append(('specular_density', 'raw_specular_density', 1))
    if c.enable_pred_normals:
      self.grad_pred = nn.Linear(wo, 3)
      self._heads.append(('grad_pred', 'grad_pred', 3))
    self._packs = {}
    self._packs_frozen = False
    if c.disable_rgb:
      # A density-only MLP (a proposal MLP) has no colour layers: JAX never
      # creates their parameters (mlp.py:277, :295, :466).
      return
    if not use_viewdirs:
      self.rgb = nn.Linear(wo, c.num_rgb_channels)
      return
    if c.enable_pred_roughness:
      self.raw_roughness = nn.Linear(wo, 1)
      self._heads.append(('roughness', 'raw_roughness', 1))
    if c.use_diffuse_color:
      self.raw_rgb_diffuse = nn.Linear(wo, c.num_rgb_channels)
      self._heads.append(('diffuse', 'raw_rgb_diffuse', c.num_rgb_channels))
    if c.use_specular_tint:
      self.raw_tint = nn.Linear(wo, 3)
      self._heads.append(('tint', 'raw_tint', 3))
    if c.bottleneck_width > 0:
      self.bottleneck = nn.Linear(wo, c.bottleneck_width)

    dir_in = c.bottleneck_width + dir_width + int(c.use_n_dot_v)
    wv = c.net_width_viewdirs
    skips = fused_mlp.skip_input_layers(c.net_depth_viewdirs, c.skip_layer)
    for i in range(c.net_depth_viewdirs):
      d_in = dir_in if i == 0 else wv + (dir_in if i in skips else 0)
      self.add_module(f'viewdir_{i}', nn.Linear(d_in, wv))
    # A trunk of depth 0 hands the rgb head its inputs (mlp.py:641-650).
    rgb_in = wv if c.net_depth_viewdirs > 0 else dir_in
    self.rgb = nn.Linear(
        rgb_in + (dir_in if trailing_concat(c.net_depth_viewdirs, c.skip_layer)
                  else 0), c.num_rgb_channels)

  def reset_parameters(self, generator: torch.Generator):
    """Initialise as the JAX MLP does (mlp.py:49-64): each kernel by
    `weight_init` (WEIGHT_INITS), zero biases; the draws from `generator`,
    layer by layer in the order they were built."""
    kind, scale, fan = WEIGHT_INITS[self.cfg.weight_init]
    with torch.no_grad():
      for layer in self.children():
        if isinstance(layer, nn.Linear):
          n = (layer.in_features if fan == 'fan_in' else
               (layer.in_features + layer.out_features) / 2)
          if kind == 'uniform':
            lim = math.sqrt(3 * scale / n)
            layer.weight.uniform_(-lim, lim, generator=generator)
          else:
            # The unit normal truncated to [-2, 2] by its inverse CDF.
            lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
            u = torch.empty_like(layer.weight).uniform_(lo, 1 - lo,
                                                        generator=generator)
            z = torch.clamp(math.sqrt(2) * torch.erfinv(2 * u - 1), -2, 2)
            layer.weight.copy_(z * (math.sqrt(scale / n) / _TRUNC_STD))
          layer.bias.zero_()

  def _stack(self, prefix, depth):
    layers = [getattr(self, f'{prefix}_{i}') for i in range(depth)]
    return [l.weight for l in layers], [l.bias for l in layers]

  def _pack(self, name, build):
    """The kernel's weight layout of one trunk, cached until a weight
    changes; under `frozen_packs` the cached layout, never rebuilt."""
    key = (name, self.cfg.compute_dtype)
    if self._packs_frozen:
      if key not in self._packs:
        raise RuntimeError(
            f'no {name} pack was built before the packs were frozen: run the '
            'model once on the same shapes first')
      return self._packs[key][1]
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

  def _plain_reason(self, depth):
    """Why a trunk of `depth` layers runs the plain layer stack, as
    (reason, detail) in JAX's words (`_fused`, mlp.py:221-241), or None: a
    non-ReLU activation, or a trunk that ends in a skip concat."""
    if self.net_activation not in (torch.relu, F.relu):
      return 'non-relu net_activation', repr(self.net_activation)
    if trailing_concat(depth, self.cfg.skip_layer):
      return ('trailing skip concat',
              f'depth={depth}, skip_layer={self.cfg.skip_layer}')
    return None

  def _fused(self, depth, x) -> bool:
    """Whether a trunk of `depth` layers on x runs the fused formulation;
    if not, logged once where the kernels would have run."""
    why = self._plain_reason(depth)
    if why is not None and fused_mlp.use_kernel(x, self.cfg.fused_trunk):
      _warn_fused_fallback(*why)
    return why is None

  def spatial_fused(self) -> bool:
    """Whether the spatial trunk runs the formulation that fuse_lift,
    fuse_ipe_trig and fuse_compositing act in (`_plain_reason`). A set flag
    that cannot act is logged once."""
    why = self._plain_reason(self.cfg.net_depth)
    if why is None:
      return True
    for f in ('fuse_lift', 'fuse_ipe_trig', 'fuse_compositing'):
      if getattr(self.cfg, f):
        _warn_fused_fallback(f'{f} inactive', why[0])
    return False

  def _spatial_plain(self, means, covs, rgb_heads, density_grad, out_y):
    """The spatial trunk as the plain layer stack (mlp.py:346-362,
    :432-441): the IPE of the lifted Gaussians, the trunk, the heads on its
    output; the density normals by autograd w.r.t. the means, with the
    graph kept when the caller differentiates (training). Returns what
    `_spatial` does."""
    c = self.cfg
    cdt = fused_mlp.DTYPES[c.compute_dtype]
    layers = [getattr(self, f'spatial_{i}') for i in range(c.net_depth)]

    def trunk(m):
      lm, lv = coord.lift_and_diagonalize(m, covs, self.pos_basis_t)
      x = coord.integrated_pos_enc(lm, lv, c.min_deg_point, c.max_deg_point)
      x = plain_stack(x, layers, self.net_activation, c.skip_layer, cdt)
      return x, self.raw_density(x.float())[..., 0]

    normals = None
    if density_grad:
      outer = torch.is_grad_enabled()
      with torch.enable_grad():
        m = means.detach().requires_grad_(True)
        x, raw_density = trunk(m)
        grad, = torch.autograd.grad(raw_density.sum(), m, create_graph=outer)
      if not outer:
        x, raw_density, grad = x.detach(), raw_density.detach(), grad.detach()
      normals = -ref_utils.l2_normalize(grad)
    else:
      x, raw_density = trunk(means)
    fh = {name: getattr(self, layer)(x.float()) for name, layer, _ in self._heads
          if rgb_heads or name in ('specular_density', 'grad_pred')}
    if rgb_heads and c.bottleneck_width > 0:
      b = self.bottleneck
      fh['bottleneck'] = F.linear(x.to(cdt), b.weight.to(cdt), b.bias.to(cdt))
    return (x if out_y else None), raw_density, fh, normals

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
      # The heads differ with rgb_heads (a mesh's density grid runs
      # without the colour heads), so each set keeps a pack of its own.
      pack = self._pack(f'spatial{rgb_heads}', lambda: fused_mlp.pack_trunk(
          ws, bs, (f, f), skip_period=c.skip_layer,
          compute_dtype=c.compute_dtype, **kw))
    outs = list(fused_mlp.fused_encoded_trunk(
        lm, lv, self.scales, ws, bs, bd=self.raw_density.bias,
        skip_period=c.skip_layer, compute_dtype=c.compute_dtype,
        mode=c.fused_trunk, pack=pack,
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

  def spatial_stage(self, means, covs, rgb_heads, density_grad, delta=None,
                    out_y=False, lifted=None):
    """The spatial stage as JAX's `_fused` routes it (mlp.py:221-241,
    :389-441): `_spatial` where the trunk has the fused formulation (the
    kernels on the card; their plain versions on the CPU and under 'off'),
    else the plain layer stack, logged once where the kernels would have
    run. covs: [..., 3, 3], or [..., 3] diagonal variances as the mesh
    tools pass them, lifted as JAX's `predict_density` lifts them;
    `lifted`: (lm, lv) from render.cast_rays_lifted in place of covs.
    Returns what `_spatial` does."""
    if not self.spatial_fused():
      if lifted is not None:
        raise ValueError(
            'lifted (fuse_lift) inputs require the fused spatial path; the '
            'model must gate cast_rays_lifted on the same predicate')
      self._fused(self.cfg.net_depth, means)
      return self._spatial_plain(means, covs, rgb_heads, density_grad, out_y)
    if lifted is None:
      lm, lv = coord.lift_and_diagonalize(means, covs, self.pos_basis_t)
      # Diagonal covs [..., s, 3] lift to [..., nb]: one variance a basis
      # vector, the same for every sample, as integrated_pos_enc reads it.
      lifted = lm, lv.reshape(lm.shape)
    return self._spatial(*lifted, rgb_heads, density_grad, delta, out_y)

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
        pack=pack, **fuse)

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
    # A trunk of depth 0 runs no trunk: the rgb head reads its inputs.
    fused_dir = c.net_depth_viewdirs > 0 and self._fused(c.net_depth_viewdirs,
                                                         means)
    fuse_ide, fuse_geo, fuse_rgb = (self._dir_fusions() if fused_dir
                                    else (False, False, False))
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
      cdt = fused_mlp.DTYPES[c.compute_dtype]
      dir_enc = dir_enc.to(cdt)
      dotprod = (torch.sum(normals * vb, dim=-1, keepdim=True)
                 if c.use_n_dot_v else None)
      if not fused_dir:
        # The plain layer stack on the concatenated input (mlp.py:643-651).
        pieces = ([fh['bottleneck']] if c.bottleneck_width > 0 else []) + [
            dir_enc] + ([dotprod] if dotprod is not None else [])
        dt = functools.reduce(torch.promote_types, [p.dtype for p in pieces])
        x = plain_stack(
            torch.cat([p.to(dt) for p in pieces], dim=-1),
            [getattr(self, f'viewdir_{i}')
             for i in range(c.net_depth_viewdirs)],
            self.net_activation, c.skip_layer, cdt)
        return self.rgb(x.float()), None
      if dotprod is not None:
        # n.v rides as one extra plane on the encoding segment (mlp.py:584).
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
              lifted=None, draws=None):
    """Evaluate the MLP on sample Gaussians (means [..., s, 3], covs
    [..., s, 3, 3]) seen from viewdirs [..., 3].

    `train` turns on the density-gradient normals (mlp.py:389-392). `delta`
    [..., s]: each sample's t-interval times |direction|; with
    `fuse_compositing`, under JAX's gates (mlp.py:394-408), the results
    then hold the compositing weights. `lifted`: (lm, lv) [..., s, nb] from
    render.cast_rays_lifted (`fuse_lift`), in place of covs (may be None).
    `draws`: the level's noise (`normal(shape)`, train/sampling.py), read in
    training with density or bottleneck noise, in JAX's order (density,
    specular density, bottleneck). Returns a dict of per-sample results, as
    the JAX MLP does.
    """
    c = self.cfg
    means, covs = gaussians
    compute_density_normals = (
        not c.disable_density_normals
        and (train or ((c.use_reflections or c.use_n_dot_v)
                       and not c.enable_pred_normals)))
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

    y, raw_density, fh, normals = self.spatial_stage(
        means, covs, rgb_heads, compute_density_normals, delta, need_y,
        lifted)

    raw_spec = (fh['specular_density'][..., 0]
                if c.enable_pred_specular_density else None)
    if c.density_noise > 0 and train:
      _need_draws('density_noise', draws)
      raw_density = raw_density + c.density_noise * draws.normal(
          raw_density.shape)
      if raw_spec is not None:
        raw_spec = raw_spec + c.density_noise * draws.normal(raw_spec.shape)

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
        if c.bottleneck_width > 0 and c.bottleneck_noise > 0 and train:
          _need_draws('bottleneck_noise', draws)
          b = fh['bottleneck']
          fh['bottleneck'] = b + c.bottleneck_noise * draws.normal(b.shape)
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
            raw_spec + c.density_bias)
    if c.enable_pred_roughness:
      out['roughness'] = roughness
    return out
