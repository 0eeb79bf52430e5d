"""mip-NeRF 360's published model in the port against the JAX package, on
the CPU.

The configuration is `refnerf_tpu_torch/testing/mipnerf360.py`'s MIPNERF360
(multinerf's configs/360.gin on the MLP's and Model's defaults; no gin
file): a 4 x 256 density-only PropMLP, an 8 x 1024 NeRF MLP with the skip at
layer 5, the 256-wide bottleneck and 504 IPE columns, the reciprocal warp
from 0.2 to 1e6 with an opaque background, `warp_fn = @coord.contract`.

- `coord.contract`, `inv_contract` and `track_linearize` against JAX,
  values and gradients, at x = 0, |x| = 1 and |x| >> 1 (float32, 1e-6
  relative);
- the model cut to size (NerfMLP.net_width 48, still depth 8 with the skip
  at layer 5, the 256-wide bottleneck and 504 columns; PropMLP 16 wide; 16 +
  8 samples; batch 12): a render and two train steps with JAX's draws
  handed in (H3), against JAX with fused_trunk='on' (its Pallas trunks in
  interpret mode) and 'off' (its plain layer stack);
- the full-width JAX parameter tree through `convert` (`spatial_5` on 1528
  columns, `viewdir_0` on 283, the 256-wide bottleneck);
- the width-1024 routing at the full shapes, in both dtypes, and the shapes
  still without an instance;
- the width-1024 wrappers (`fused_mlp._w1024_forward`, `_w1024_backward`)
  against the plain versions with the C entry points of csrc/trunk_w1024.cu
  and the reduction of csrc/trunk_bwd.cu replaced by `_W1024Sim`, a model
  of their contract on CPU memory (each argument list checked against
  `cuda_build.EXPORTS`, each write of partials held inside its buffer; the
  f32 products as three TF32 passes, `_tf32` modelling the split):
  slabs, partials and their sums, the heads;
- the full-width model trained and served with the width-1024 libraries
  so replaced, and the other trunks' kernels by their plain versions:
  launch counts a step and a request, and the step against 'off'.

Tolerances. Against JAX 'on', float32 1e-5 (the renders, the loss terms),
the gradients 2e-4 of their largest entry and the parameters after a step
2e-2 of their largest move, as tests/test_torch_port_cascade.py: sums in
another order, carried through the resampling. Against JAX 'off', 1e-3:
JAX's plain path builds the IPE cosine as sin(m + pi/2)
(tests/test_torch_port_model.py). The wrappers against the plain versions:
values 1e-4 (float32) and 5e-2 (bfloat16) of their largest entry, every
gradient within 5e-3 / 5e-2 relative L2, as chip_smoke.py's KERNEL_BOUND
and GRAD_BOUND: the kernels sum the padded input in one product where the
plain version sums each segment, and a pre-activation within that noise of
0 flips a relu' mask.
"""

import collections
import contextlib
import ctypes
import math
import os
import subprocess
import sys
import textwrap
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refnerf_tpu import configs as jconfigs
from refnerf_tpu.cameras import rays as jrays
from refnerf_tpu.models import construct as jconstruct
from refnerf_tpu.ops import coord as jcoord
from refnerf_tpu_torch import configs
from refnerf_tpu_torch import convert
from refnerf_tpu_torch.cameras import rays as rays_lib
from refnerf_tpu_torch.models import construct
from refnerf_tpu_torch.ops import coord
from refnerf_tpu_torch.ops import fused_mlp
from refnerf_tpu_torch.testing.mipnerf360 import MIPNERF360
from refnerf_tpu_torch.train import step as step_lib
from tests.test_torch_port_cascade import _params, jax_draws
from tests.test_torch_port_losses import (_assert_grads, _flat as _flat_tree,
                                          _jax_step_with_grads)

torch.set_num_threads(1)

# Cut to size; both packages run their fused formulation under 'on'.
SMALL = ['NerfMLP.net_width = 48', 'PropMLP.net_width = 16',
         'Model.num_prop_samples = 16', 'Model.num_nerf_samples = 8',
         'Config.batch_size = 12']
ON = ["NerfMLP.fused_trunk = 'on'", "PropMLP.fused_trunk = 'on'"]
OFF = ["NerfMLP.fused_trunk = 'off'", "PropMLP.fused_trunk = 'off'"]
TOL = 1e-5
KERNEL_BOUND = {'float32': 1e-4, 'bfloat16': 5e-2}
GRAD_BOUND = {'float32': 5e-3, 'bfloat16': 5e-2}


def _t(a):
  return torch.tensor(np.ascontiguousarray(a))


def _np(x):
  return np.asarray(jnp.asarray(x, jnp.float32))


# ------------------------------------------------------------- coord trio


def _points():
  """x = 0, points on and beside the unit sphere, and far ones (1e3, 1e6)."""
  rng = np.random.default_rng(0)
  d = rng.normal(size=(8, 3))
  d /= np.linalg.norm(d, axis=-1, keepdims=True)
  mags = np.array([0.0, 0.5, 1.0 - 1e-6, 1.0, 1.0 + 1e-6, 2.0, 1e3, 1e6])
  pts = (d * mags[:, None]).astype(np.float32)
  pts[3] = [0.6, 0.8, 0.0]  # |x| = 1 exactly in float32
  return pts


def _close(port, ref, tol=1e-6, what=''):
  ref = _np(ref)
  np.testing.assert_allclose(np.asarray(port.detach()), ref, rtol=tol,
                             atol=tol * max(1e-6, float(np.abs(ref).max())),
                             err_msg=what)


@pytest.mark.parametrize('fn', ['contract', 'inv_contract'])
def test_contraction_matches_jax(fn):
  # Values and the gradient of a weighted sum of the outputs, at x = 0
  # (the eps clamp keeps it finite), |x| = 1 and far points; inv_contract
  # on contracted points (|z| < 2) and on the inverse's own domain edge.
  pts = _points()
  if fn == 'inv_contract':
    pts = np.asarray(jcoord.contract(jnp.asarray(pts)))
  w = np.random.default_rng(1).normal(size=pts.shape).astype(np.float32)
  pfn, jfn = getattr(coord, fn), getattr(jcoord, fn)
  x = _t(pts).requires_grad_(True)
  out = pfn(x)
  _close(out, jfn(jnp.asarray(pts)), what=fn)
  grad, = torch.autograd.grad((out * _t(w)).sum(), x)
  jgrad = jax.grad(lambda v: jnp.sum(jfn(v) * w))(jnp.asarray(pts))
  assert np.isfinite(_np(jgrad)).all() and torch.isfinite(grad).all()
  _close(grad, jgrad, what=f'd {fn}')


def test_contract_round_trip():
  # inv_contract(contract(x)) = x to float32 rounding, out to |x| = 1e3.
  pts = _t(_points()[:-1])
  back = coord.inv_contract(coord.contract(pts))
  np.testing.assert_allclose(back.numpy(), pts.numpy(), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize('fn', ['contract', 'sin'])
def test_track_linearize_matches_jax(fn):
  # Gaussians with full covariances pushed through contract (and a map
  # that mixes no coordinates, sin) by its Jacobian: means and
  # covariances, and the gradient of a weighted sum of both with respect
  # to the means and the covariances, against jax.linearize's.
  rng = np.random.default_rng(2)
  mean = _points()[1:]
  a = rng.normal(size=mean.shape + (3,)).astype(np.float32) * 0.1
  cov = (a @ np.swapaxes(a, -1, -2)).astype(np.float32)
  wm = rng.normal(size=mean.shape).astype(np.float32)
  wc = rng.normal(size=cov.shape).astype(np.float32)
  pfn, jfn = ((coord.contract, jcoord.contract) if fn == 'contract'
              else (torch.sin, jnp.sin))
  m, c = _t(mean).requires_grad_(True), _t(cov).requires_grad_(True)
  fm_, fc = coord.track_linearize(pfn, m, c)
  jm, jc = jcoord.track_linearize(jfn, jnp.asarray(mean), jnp.asarray(cov))
  _close(fm_, jm, what='mean')
  _close(fc, jc, what='cov')
  gm, gc = torch.autograd.grad((fm_ * _t(wm)).sum() + (fc * _t(wc)).sum(),
                               (m, c))
  jg = jax.grad(lambda mu, cv: sum(
      jnp.sum(o * w) for o, w in zip(jcoord.track_linearize(jfn, mu, cv),
                                     (wm, wc))), argnums=(0, 1))(
                                         jnp.asarray(mean), jnp.asarray(cov))
  _close(gm, jg[0], 1e-5, 'd mean')
  _close(gc, jg[1], what='d cov')


def test_track_linearize_refuses_a_diagonal_covariance():
  mean = jnp.zeros((4, 3))
  with pytest.raises(ValueError, match='non-diagonal'):
    jcoord.track_linearize(jcoord.contract, mean, jnp.ones((4, 3)))
  with pytest.raises(ValueError, match='non-diagonal'):
    coord.track_linearize(coord.contract, torch.zeros(4, 3), torch.ones(4, 3))


# --------------------------------------------------- the model, cut to size


def _rays_np(n, config, seed):
  rng = np.random.default_rng(seed)
  d = rng.normal(size=(n, 3)).astype(np.float32)
  f = lambda v, k=1: np.full((n, k), v, np.float32)
  return dict(origins=rng.normal(size=(n, 3)).astype(np.float32) * 0.1,
              directions=d,
              viewdirs=d / np.linalg.norm(d, axis=-1, keepdims=True),
              radii=f(0.001), lossmult=f(1.0), near=f(config.near),
              far=f(config.far), imageplane=f(0.0, 2),
              cam_idx=np.zeros((n, 1), np.int32))


class _Pair:
  """MIPNERF360 + `bindings` in both packages (JAX's parameters with random
  biases carried into the port), on one batch."""

  def __init__(self, bindings, n=12, seed=0):
    jconfig, jgin = jconfigs.parse([], MIPNERF360 + bindings)
    self.jconfig = jconfig
    self.jmodel = jconstruct.construct_model(jconfig, jgin)
    self.params = _params(self.jmodel, seed)
    self.config, gin = configs.parse([], MIPNERF360 + bindings)
    self.model = construct.construct_model(self.config, gin, 'cpu')
    convert.load_jax_params(self.model, self.params)
    r = _rays_np(n, self.config, seed)
    rgb = np.random.default_rng(seed + 1).uniform(size=(n, 3)).astype(
        np.float32)
    self.jbatch = jrays.Batch(
        rays=jrays.Rays(**{k: jnp.asarray(v) for k, v in r.items()}),
        rgb=jnp.asarray(rgb))
    self.batch = rays_lib.Batch(
        rays=rays_lib.Rays(**{k: _t(v) for k, v in r.items()}), rgb=_t(rgb))


def test_the_cut_keeps_the_published_shapes():
  # The cut changes widths and sample counts alone: depth 8 with the skip
  # at layer 5 on 504 columns, the 256-wide bottleneck, the directional
  # trunk on 256 + 27 columns, the warp, the opaque background.
  pair = _Pair(SMALL + ON)
  mlp = pair.model.nerf_mlp
  assert mlp.spatial_0.in_features == 504 and mlp.spatial_5.in_features == 48 + 504
  assert fused_mlp.skip_input_layers(8, 4) == (5,)
  assert mlp.bottleneck.out_features == 256 and mlp.viewdir_0.in_features == 283
  assert not hasattr(mlp, 'spatial_8')
  assert pair.model.cfg.raydist_fn == 'reciprocal'
  assert pair.model.cfg.opaque_background and pair.config.far == 1e6
  assert pair.model.prop_mlp.cfg.warp_fn.name == 'coord.contract'


@pytest.mark.parametrize('fused,tol', [('on', TOL), ('off', 1e-3)])
def test_served_matches_jax(fused, tol):
  # Eval (no draws) at train_frac 0.3: every level's rgb, acc and distance
  # against JAX under fused_trunk='on' and 'off' (absolute floor tol / 10:
  # the proposal levels' rgb is the opaque background's 0, to 1e-7). The
  # distance is compared in the warp's normalized space s = (1/t - 1/near)
  # / (1/far - 1/near): with far = 1e6 the last fencepost lies an ulp or
  # two below s = 1 in both packages, and an ulp there moves t by ~30%,
  # which the opaque background's last interval carries into the distance
  # (1e-4 in s at the proposal levels, whose median falls in that interval:
  # linear in t there, the ulp moves it by ~2e-5 in s).
  modes = ON if fused == 'on' else OFF
  pair = _Pair(SMALL + modes)
  jr, jh = pair.jmodel.apply({'params': pair.params}, pair.jbatch.rays,
                             train_frac=0.3, compute_extras=False)
  with torch.no_grad():
    pr, ph = pair.model(pair.batch.rays, train_frac=0.3)
  assert len(pr) == 3
  near, far = pair.config.near, pair.config.far
  warp = lambda t: (1 / t - 1 / near) / (1 / far - 1 / near)
  for level in range(3):
    for k in ('rgb', 'acc'):
      np.testing.assert_allclose(np.asarray(pr[level][k]), _np(jr[level][k]),
                                 rtol=tol, atol=tol * 1e-1,
                                 err_msg=f'{level} {k}')
    np.testing.assert_allclose(
        warp(pr[level]['distance'].double().numpy()),
        warp(_np(jr[level]['distance']).astype(np.float64)), rtol=0,
        atol=tol if level == 2 else max(tol, 1e-4), err_msg=f'{level} distance')
    np.testing.assert_allclose(ph[level]['sdist'].numpy(),
                               _np(jh[level]['sdist']), rtol=0, atol=1e-6)


@pytest.mark.parametrize('fused,tol', [('on', TOL), ('off', 1e-3)])
def test_two_train_steps_match_jax_with_jax_draws(fused, tol):
  # Config.randomized from step 100,000: every jitter is JAX's own (its key
  # splits replayed into the port's step). After each of two steps: every
  # loss term within `tol`, and under 'on' the gradients and the parameters
  # (as test_torch_port_cascade.py's steps); under 'off' JAX's IPE cosine
  # differs as in test_served_matches_jax, so the terms are held within
  # 1e-3 and the gradients within 1e-2 of their largest entry.
  from refnerf_tpu.train import step as jstep
  pair = _Pair(SMALL + (ON if fused == 'on' else OFF), seed=3)
  jtrain = _jax_step_with_grads(pair.jmodel, pair.jconfig)
  jstate = jstep.create_train_state(pair.jconfig, pair.jmodel, pair.params)
  jstate = jstate.replace(step=jnp.asarray(100000, jnp.int32))
  state = step_lib.create_train_state(pair.config, pair.model)
  state.step = 100000
  train = step_lib.make_train_step(pair.model, pair.config,
                                   draws=jax_draws(pair.config.seed))
  before = {k: v.detach().clone().numpy() for k, v in state.params().items()}
  for i in (1, 2):
    _, _, grads = train.loss_and_grads(state, pair.batch)
    jstate, jstats = jtrain(jstate, pair.jbatch)
    state, stats = train(state, pair.batch)
    assert state.step == int(jstate.step) == 100000 + i
    assert set(stats['losses']) == set(jstats['losses']) == {
        'data', 'interlevel', 'distortion'}
    for k in jstats['losses']:
      np.testing.assert_allclose(float(stats['losses'][k]),
                                 float(jstats['losses'][k]), rtol=tol,
                                 atol=1e-9, err_msg=k)
    want = _flat_tree(jax.device_get(jstats['grads']))
    assert set(grads) == set(want)
    for k, g in grads.items():
      _assert_grads(g, want[k], 2e-4 if fused == 'on' else 1e-2, k)
    if fused == 'off':
      continue
    jparams = _flat_tree(jax.device_get(jstate.params))
    for k, p in state.params().items():
      moved = max(1e-12, float(np.abs(jparams[k] - before[k]).max()))
      np.testing.assert_allclose(p.detach().numpy(), jparams[k], rtol=0,
                                 atol=2e-2 * moved, err_msg=k)


# ------------------------------------------------ the full-width weights


def test_full_width_tree_converts():
  # JAX's initial parameters of the model at full width go into the port
  # unchanged (kernels transposed): spatial_5 on 1024 + 504 columns,
  # viewdir_0 on 256 + 27, the bottleneck 1024 -> 256, the PropMLP.
  jconfig, jgin = jconfigs.parse([], MIPNERF360)
  jmodel = jconstruct.construct_model(jconfig, jgin)
  params = jax.device_get(jconstruct.init_params(jax.random.PRNGKey(0),
                                                 jmodel))
  config, gin = configs.parse([], MIPNERF360)
  model = construct.construct_model(config, gin, 'cpu')
  convert.load_jax_params(model, params)
  nerf = params['nerf_mlp'] if 'nerf_mlp' in params else params['NerfMLP_0']
  mlp = model.nerf_mlp
  shapes = {'spatial_0': (504, 1024), 'spatial_5': (1528, 1024),
            'spatial_7': (1024, 1024), 'bottleneck': (1024, 256),
            'raw_density': (1024, 1), 'viewdir_0': (283, 128),
            'rgb': (128, 3)}
  for name, shape in shapes.items():
    k = np.asarray(nerf[name]['kernel'])
    assert k.shape == shape, name
    np.testing.assert_array_equal(getattr(mlp, name).weight.detach().numpy(),
                                  k.T, err_msg=name)
  assert sum(p.numel() for p in mlp.parameters()) == sum(
      np.asarray(v).size for v in jax.tree_util.tree_leaves(nerf))
  assert model.prop_mlp.spatial_0.weight.shape == (256, 504)


# ------------------------------------------------------ the kernel routing


def _pack(cdt, width=1024, hc=256, hf=0, fin=504, depth=8, wd=True):
  skips = fused_mlp.skip_input_layers(depth, 4)
  ws = [torch.zeros(width, fin if l == 0 else width + (fin if l in skips
                                                       else 0))
        for l in range(depth)]
  bs = [torch.zeros(width) for _ in range(depth)]
  head = lambda k: (torch.zeros(k, width), torch.zeros(k)) if k else None
  return fused_mlp.pack_trunk(
      ws, bs, (fin // 2, fin - fin // 2), wd=torch.zeros(1, width) if wd
      else None, head_f32=head(hf), head_cdt=head(hc), compute_dtype=cdt)


@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
def test_w1024_routes_at_full_shape(cdt):
  # The NeRF MLP's spatial trunk (width 1024, 512 packed columns, the
  # density head, the 256-wide bottleneck) has an instance in both dtypes:
  # the forward and the backward on trunk_w1024, each launch within an
  # H100's shared memory, counted under 'K1 w1024' / 'K4 w1024' too.
  pack = _pack(cdt)
  assert fused_mlp.w1024(pack) and pack.kin == 512
  assert fused_mlp.missing_instance(pack, 256) is None
  assert fused_mlp.forward_library(pack) == 'trunk_w1024'
  assert fused_mlp.backward_library(pack) == 'trunk_w1024'
  assert fused_mlp.kernel_smem('trunk_w1024', pack, 256) <= (
      fused_mlp.SMEM_LIMIT)
  modes = (False, None, fused_mlp.DirModes(), fused_mlp.SpaModes())
  assert fused_mlp.launch_keys('K1', pack, *modes) == ['K1', 'K1 w1024']
  assert fused_mlp.launch_keys('K4', pack, *modes) == ['K4', 'K4 w1024']
  # The larger of the two wgmma products' CTAs (csrc/trunk_w1024.cu):
  # bf16 the nt product's (`kNtSmem`), f32 the TF32 tn product's
  # (`kF32TnSmem`).
  assert fused_mlp.kernel_smem('trunk_w1024', _pack(cdt), 256) == (
      214080 if cdt == 'bfloat16' else 197728)


@pytest.mark.parametrize('case,words', [
    ('width 1024 without the bottleneck', 'head 0'),
    ('width 1024 with a 128-wide head', 'head 128'),
    ('width 1024 with the density gradient', 'density gradient'),
    ('width 1024 on 1056 columns', '1056 input columns'),
    ('width 1024 without the density head', 'no density head'),
    ('width 1024 with f32 heads', 'f32 heads'),
    ('width 512', 'width 512'),
    ('width 2048', 'width 2048'),
    ('width 256 on 256 columns with a 256-wide head', 'head 256'),
    ('width 128 spatial', 'the density head'),
    ('width 256 on 504 columns with a 64-wide head', 'head 64'),
])
def test_shapes_still_without_an_instance_are_named(case, words):
  # What the JAX pair runs and the port does not yet (ROADMAP queue 2) is
  # named by missing_instance before anything is built: 'auto' runs the
  # plain versions, 'on' raises.
  cdt = 'float32' if case.startswith('f32') else 'bfloat16'
  fold = None
  if case == 'width 1024 without the bottleneck':
    pack, hc = _pack(cdt, hc=0), 0
  elif case == 'width 1024 with a 128-wide head':
    pack, hc = _pack(cdt, hc=128), 128
  elif case == 'width 1024 with the density gradient':
    pack, hc = _pack(cdt), 256
    fold = torch.as_tensor(fused_mlp.ipe_scale_fold(2.0**np.arange(12), 21))
  elif case == 'width 1024 on 1056 columns':
    pack, hc = _pack(cdt, fin=1056), 256
  elif case == 'width 1024 without the density head':
    pack, hc = _pack(cdt, wd=False), 256
  elif case == 'width 1024 with f32 heads':
    pack, hc = _pack(cdt, hf=3), 256
  elif case.startswith('width 512') or case.startswith('width 2048'):
    w = int(case.split()[1])
    pack, hc = _pack(cdt, width=w), 256
  elif case == 'width 256 on 256 columns with a 256-wide head':
    pack, hc = _pack(cdt, width=256, fin=256), 256
  elif case == 'width 128 spatial':
    pack, hc = _pack(cdt, width=128, hc=0), 0
  else:
    pack, hc = _pack(cdt, width=256, hc=64), 64
  why = fused_mlp.missing_instance(pack, hc, fold)
  assert why is not None and words in why, why
  assert not fused_mlp.w1024(pack, fold=fold)
  with pytest.raises(NotImplementedError, match=words):
    fused_mlp._kernel_for(pack, hc, 'on', fold=fold)
  assert not fused_mlp._kernel_for(pack, hc, 'auto', fold=fold)


@pytest.mark.parametrize('case', [
    'width 256 with a 256-wide bottleneck',
    'f32 width 256 on 504 columns with a 128-wide head'])
def test_shapes_with_an_instance_now_route_to_the_wide_instances(case):
  # Two shapes the test above named until the wide-input instances took the
  # compute-dtype head (the MLP's defaults, and the f32 128-wide head that
  # was past shared memory): each routes to its dtype's wide-input pair
  # within an H100's shared memory, under 'on' too.
  cdt = 'float32' if case.startswith('f32') else 'bfloat16'
  hc = 256 if '256-wide' in case else 128
  pack = _pack(cdt, width=256, hc=hc)
  assert fused_mlp.wide_input(pack) and fused_mlp.missing_instance(
      pack, hc) is None
  libs = (fused_mlp.forward_library(pack), fused_mlp.backward_library(pack))
  assert libs == (fused_mlp.FWD_LIBRARY[cdt], fused_mlp.BWD_LIBRARY[cdt])
  assert all(fused_mlp.kernel_smem(lib, pack, hc) <= fused_mlp.SMEM_LIMIT
             for lib in libs)
  assert fused_mlp._kernel_for(pack, hc, 'on')


# --------------------------------- the wrappers on a model of the C contract


def _tf32(x):
  """f32 x rounded to TF32 as cvt.rna.tf32.f32 rounds it: to 10 mantissa
  bits, ties away from zero (the low 13 bits of the magnitude)."""
  b = x.float().contiguous().view(torch.int32)
  return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
  """The TF32 parts of f32 x as csrc/trunk_w1024.cu splits them: hi, and
  the TF32 rounding of x - hi."""
  hi = _tf32(x)
  return hi, _tf32(x.float() - hi)


def _tf32_product(a, b, passes=3):
  """a @ b as the f32 products compute it: lo.hi + hi.lo + hi.hi of the
  two operands' TF32 parts, f32 sums (`passes` 1: hi.hi alone, the
  shortcut the bounds must see)."""
  (ah, al), (bh, bl) = _split(a), _split(b)
  if passes == 1:
    return ah @ bh
  return al @ bh + ah @ bl + ah @ bh


def _view(p, rows, ld, cols, dtype):
  """[rows, cols] with row stride ld at address p, sharing its memory."""
  es = torch.empty(0, dtype=dtype).element_size()
  count = (rows - 1) * ld + cols
  buf = (ctypes.c_char * (count * es)).from_address(p)
  return torch.frombuffer(buf, dtype=dtype, count=count).as_strided(
      (rows, cols), (ld, 1))


class _W1024Sim:
  """The C entry points of csrc/trunk_w1024.cu and trunk_bwd.cu's
  refnerf_reduce as their comments state them, on CPU memory: each call's
  arguments are checked against cuda_build.EXPORTS (count and ctypes types)
  and recorded, then run in torch with the kernels' casts (products in f32,
  rounded to the compute dtype where the kernels round; f32 products as
  `passes` TF32 passes, `_tf32_product`). Each write of partials (`_tn`,
  `_colsum`) must lie inside the storage of a live tensor that
  `torch.empty` returned (`allocated`, filled by the w1024_sim fixture)."""

  def __init__(self):
    self.calls = []
    self.allocated = []  # weak references to what torch.empty returned
    self.passes = 3

  def inside(self, p, nbytes):
    """Whether [p, p + nbytes) lies within one live tensor's storage."""
    self.allocated = [r for r in self.allocated if r() is not None]
    for r in self.allocated:
      st = r().untyped_storage()
      if st.data_ptr() <= p and p + nbytes <= st.data_ptr() + st.nbytes():
        return True
    return False

  def __getattr__(self, fn):
    from refnerf_tpu_torch.ops import cuda_build
    types = next(f[fn] for f in cuda_build.EXPORTS.values() if fn in f)
    impl = getattr(self, '_' + fn.split('_')[-1])

    def call(*args):
      assert len(args) == len(types), (fn, len(args), len(types))
      for a, t in zip(args, types):
        assert not isinstance(a, torch.Tensor), fn
        t.from_param(a)
      self.calls.append(fn)
      return impl(*args)
    return call

  def _nt(self, bf, mode, m, n, a0, lda0, k0, a1, lda1, k1, b, b_lo, ldb,
          bias, act, ld_act, sb, wd, out, ldo, stream):
    del stream
    dt = torch.bfloat16 if bf else torch.float32
    rnd = lambda v: v.to(dt).float()
    # bf16: B as it is; f32: B's TF32 parts from refnerf_w1024_split, which
    # the product must equal (hi + lo within rounding of the weights).
    assert bool(b_lo) != bool(bf), 'b_lo is given in f32 alone'
    es = 2 if bf else 4

    def product(a, lda, k, off):
      av = _view(a, m, lda, k, dt).float()
      bv = _view(b + off * es, n, ldb, k, dt).float()
      if bf:
        return av @ bv.t()
      lo = _view(b_lo + off * es, n, ldb, k, dt)
      assert torch.equal(_tf32(bv), bv) and torch.equal(_tf32(lo), lo)
      ah, al = _split(av)
      if self.passes == 1:
        return ah @ bv.t()
      return al @ bv.t() + ah @ lo.t() + ah @ bv.t()

    acc = product(a0, lda0, k0, 0)
    if k1:
      acc = acc + product(a1, lda1, k1, k0)
    if mode in (0, 3):  # kRelu, kBias
      v = rnd(rnd(acc) + _view(bias, 1, n, n, dt).float())
      v = torch.relu(v) if mode == 0 else v
    else:  # kRev, kHeadBwd
      g = rnd(acc)
      if mode == 2:
        g32 = (_view(sb, m, 1, 1, torch.float32) *
               _view(wd, 1, n, n, torch.float32)) if sb else 0 * g
        g = rnd(g + rnd(g32))
      h = _view(act, m, ld_act, n, dt).float()
      v = torch.where(h > 0, g, torch.zeros_like(g))
    _view(out, m, ldo, n, dt).copy_(v.to(dt))
    return 0

  @staticmethod
  def _split(n, v, hi, lo, stream):
    del stream
    h, l = _split(_view(v, 1, n, n, torch.float32))
    _view(hi, 1, n, n, torch.float32).copy_(h)
    _view(lo, 1, n, n, torch.float32).copy_(l)
    return 0

  @staticmethod
  def _sigma(bf, m, w, y, wd, sig, stream):
    del stream
    yv = _view(y, m, w, w, torch.bfloat16 if bf else torch.float32).float()
    _view(sig, m, 1, 1, torch.float32).copy_(
        yv @ _view(wd, w, 1, 1, torch.float32))
    return 0

  def _tn(self, bf, mo, no, rows, ksplit, z, ldz, x0, ldx0, n0, x1, ldx1,
          part, bpart, stream):
    del stream
    # bf16: 128 x 256 tiles over 64-row slices, x0's columns on whole
    # tiles where x1 follows; f32: 128 x 128 tiles over 32-row slices,
    # three TF32 passes; the bias partials where bpart is given.
    if bf:
      assert ksplit % 64 == 0 and mo % 128 == 0
      assert n0 == no or n0 % 256 == 0
    else:
      assert ksplit % 32 == 0 and mo % 128 == 0 and no % 2 == 0
      assert n0 == no or n0 % 128 == 0
    splits = -(-rows // ksplit)
    assert self.inside(part, splits * mo * no * 4), (
        'the partials overrun their buffer', rows, ksplit, mo, no)
    assert not bpart or self.inside(bpart, splits * mo * 4), (
        'the bias partials overrun their buffer', rows, ksplit, mo)
    dt = torch.bfloat16 if bf else torch.float32
    zm = _view(z, rows, ldz, mo, dt).float()
    xs = [_view(x0, rows, ldx0, n0, dt).float()] if n0 else []
    if n0 < no:
      xs.append(_view(x1, rows, ldx1, no - n0, dt).float())
    xm = torch.cat(xs, 1)
    parts = _view(part, splits * mo, no, no, torch.float32).reshape(
        splits, mo, no)
    for s in range(splits):
      rs = slice(s * ksplit, (s + 1) * ksplit)
      parts[s].copy_(zm[rs].t() @ xm[rs] if bf else
                     _tf32_product(zm[rs].t(), xm[rs], self.passes))
      if bpart:
        _view(bpart + s * mo * 4, 1, mo, mo, torch.float32).copy_(
            zm[rs].sum(0, keepdim=True))
    return 0

  def _colsum(self, vbf, rows, cols, v, ldv, s, block_rows, part, stream):
    del stream
    blocks = -(-rows // block_rows)
    assert self.inside(part, blocks * cols * 4), (
        'the column sums overrun their buffer', rows, block_rows, cols)
    vm = _view(v, rows, ldv, cols, torch.bfloat16 if vbf else
               torch.float32).float()
    sm = _view(s, rows, 1, 1, torch.float32) if s else torch.ones(rows, 1)
    parts = _view(part, blocks, cols, cols, torch.float32)
    for b in range(blocks):
      rs = slice(b * block_rows, (b + 1) * block_rows)
      parts[b].copy_((sm[rs] * vm[rs]).sum(0))
    return 0

  @staticmethod
  def _reduce(parts, nparts, rows, k, k_out, dst, accumulate, stream):
    del stream
    ps = _view(parts, nparts * rows, k, k, torch.float32).reshape(
        nparts, rows, k)[:, :, :k_out]
    d = _view(dst, rows, k_out, k_out, torch.float32)
    total = d.clone() if accumulate else torch.zeros_like(d)
    for q in range(nparts):  # dst first, then the partials in order
      total += ps[q]
    d.copy_(total)
    return 0


@pytest.fixture
def w1024_sim(monkeypatch):
  """cuda_build.library answers with a _W1024Sim (the width-1024 library
  and trunk_bwd's reduction alone), on a card of an H100's 132 SMs; the
  stream and device calls of the wrappers are no-ops; what torch.empty
  returns is registered with the sim (`_W1024Sim.inside`)."""
  from refnerf_tpu_torch.ops import cuda_build
  sim = _W1024Sim()
  empty = torch.empty

  def library(name):
    assert name in (fused_mlp.W1024_LIBRARY, 'trunk_bwd'), name
    return sim

  def registered(*args, **kwargs):
    t = empty(*args, **kwargs)
    sim.allocated.append(weakref.ref(t))
    return t
  monkeypatch.setattr(cuda_build, 'library', library)
  monkeypatch.setattr(torch, 'empty', registered)
  monkeypatch.setattr(torch.cuda, 'device',
                      lambda dev: contextlib.nullcontext())
  monkeypatch.setattr(torch.cuda, 'current_stream',
                      lambda dev=None: type('S', (), {'cuda_stream': 0})())
  monkeypatch.setattr(torch.cuda, 'get_device_properties',
                      lambda dev: type('P', (), {'multi_processor_count': 132}))
  return sim


def _trunk(seed, n, fin=504):
  gen = torch.Generator().manual_seed(seed)
  rand = lambda *s: torch.randn(*s, generator=gen)
  skips = fused_mlp.skip_input_layers(8, 4)
  ws = []
  for l in range(8):
    k = fin if l == 0 else 1024 + (fin if l in skips else 0)
    ws.append(rand(1024, k) * math.sqrt(2 / k))
  bs = [rand(1024) * 0.05 for _ in range(8)]
  kw = dict(wd=rand(1, 1024) / 32,
            head_cdt=(rand(256, 1024) / 32, rand(256) * 0.1))
  segs = [rand(n, fin // 2) for _ in range(2)]
  cots = (rand(n), None, rand(n, 256), None)
  return segs, ws, bs, kw, cots


def _flat(res):
  out = []
  for x in res:
    if isinstance(x, (list, tuple)):
      out += [t for t in x if t is not None]
    elif x is not None:
      out.append(x)
  return out


@pytest.mark.parametrize('cdt,slab', [
    ('float32', None), ('float32', 256), ('bfloat16', 256),
    ('bfloat16', None), ('float32', 384), ('float32', 288)])
def test_w1024_wrappers_match_plain(w1024_sim, cdt, slab):
  # 600 rows (not a multiple of the 128- or 256-row tiles; three slabs of
  # 256 where `slab` is set, the last of 88), the density head and the
  # bottleneck: the forward's sigma and bottleneck within KERNEL_BOUND of
  # their largest value, every gradient of the backward within GRAD_BOUND
  # relative L2, against trunk_reference and trunk_backward_reference; the
  # launches as the wrappers make them. In slabs of 384, 534 rows: a full
  # slab splits a 1024 x 1024 weight gradient into 2 partials of 192 rows,
  # the last slab's 150 rows into 2 of 96; in slabs of 288, 388 rows: a
  # full slab splits the skip layer's 1024 x 1536 gradient into 3 partials
  # of 96 rows, the last slab's 100 rows into 4 of 32 (H24: more than a
  # full slab), and every write of partials stays inside its buffer all the
  # same (`_W1024Sim.inside`).
  n = {384: 534, 288: 388}.get(slab, 600)
  split = lambda rows, k=1024: fused_mlp.w1024_split(rows, 1024, k, 132, cdt)
  if slab == 384:
    assert (split(slab), split(n - slab)) == (192, 96)
  if slab == 288:
    assert (split(slab, 1536), split(n - slab, 1536)) == (96, 32)
    assert -(-slab // 96) < -(-(n - slab) // 32)
  segs, ws, bs, kw, cots = _trunk(4, n)
  dt = fused_mlp.DTYPES[cdt]
  segs = [s.to(dt) for s in segs]
  cots = cots[:2] + (cots[2].to(dt), None)
  pack = fused_mlp.pack_trunk(ws, bs, (252, 252), compute_dtype=cdt, **kw)
  got = fused_mlp.trunk_kernel(segs, pack)
  want = fused_mlp.trunk_reference(segs, ws, bs, compute_dtype=cdt, **kw)
  assert len(got) == len(want) == 2
  for g, w in zip(got, want):
    assert g.shape == w.shape and g.dtype == w.dtype
    scale = max(1.0, w.float().abs().max().item())
    assert (g.float() - w.float()).abs().max().item() <= (
        KERNEL_BOUND[cdt] * scale)
  # f32 splits the layers' and the bottleneck's weights into their TF32
  # parts first.
  splits = 2 if cdt == 'float32' else 0
  assert w1024_sim.calls == ['refnerf_w1024_split'] * splits + [
      'refnerf_w1024_nt'] * 9 + ['refnerf_w1024_sigma']
  w1024_sim.calls.clear()
  got = fused_mlp.trunk_backward_kernel(segs, pack, cots, slab=slab)
  want = fused_mlp.trunk_backward_reference(segs, ws, bs, cots,
                                            compute_dtype=cdt, **kw)
  assert got[7:] == (None, None, None)
  got, want = _flat(got[:7]), _flat(want[:7])
  assert len(got) == len(want) == 8 + 8 + 1 + 2
  for i, (g, w) in enumerate(zip(got, want)):
    assert g.shape == w.shape and g.dtype == torch.float32, i
    assert ((g - w).norm() / w.norm()).item() <= GRAD_BOUND[cdt], i
  slabs = 1 if slab is None else -(-n // slab)
  count = collections.Counter(w1024_sim.calls)
  # A slab: 8 layers recomputed, the heads' backward, 7 reverse products;
  # 9 weight gradients, whose products also give dbc's and the biases'
  # partials; the column sum of dwd alone; one fixed-order sum for each of
  # those. In f32, once a call, the TF32 split of w, wc^T and w^T.
  want = {'refnerf_w1024_nt': 16 * slabs, 'refnerf_w1024_tn': 9 * slabs,
          'refnerf_w1024_colsum': slabs,
          'refnerf_reduce': (9 + 1 + 9) * slabs}
  if cdt == 'float32':
    want['refnerf_w1024_split'] = 3
  assert count == want


def test_w1024_backward_sums_slabs_in_order(w1024_sim):
  # Per slab each gradient's partials are summed in a fixed order and
  # added to the running sum (no atomics: H4). Slabs of 128 rows give the
  # sum of the slab-by-slab backwards taken alone, within float32 rounding
  # of the additions.
  n = 300
  segs, ws, bs, kw, cots = _trunk(5, n)
  pack = fused_mlp.pack_trunk(ws, bs, (252, 252), **kw)
  whole = _flat(fused_mlp.trunk_backward_kernel(segs, pack, cots, slab=128))
  parts = [_flat(fused_mlp.trunk_backward_kernel(
      [s[i:i + 128] for s in segs], pack,
      tuple(None if c is None else c[i:i + 128] for c in cots)))
           for i in range(0, n, 128)]
  for j, g in enumerate(whole):
    total = parts[0][j] + parts[1][j] + parts[2][j]
    np.testing.assert_allclose(g.numpy(), total.numpy(), rtol=1e-6,
                               atol=1e-6 * total.abs().max().item())


def _c_constants(path):
  """The `constexpr int NAME = EXPR;` constants of a CUDA source, each EXPR
  evaluated over the integers and the constants before it."""
  import re
  found = {}
  text = open(path).read()
  for name, expr in re.findall(r'constexpr int (\w+) = ([^;]+);', text):
    found[name] = eval(expr.replace('/', '//'), {}, dict(found))
  return found


def test_w1024_smem_mirrors_the_bf16_products():
  # kernel_smem's sum for trunk_w1024 is the larger of its two wgmma
  # products' dynamic shared memory as csrc/trunk_w1024.cu states it, in
  # each dtype, within an H100's SMEM_LIMIT. bf16: kNtSmem (the ring, the
  # staging tile, the mbarriers), kTnSmem (the deeper ring, the mbarriers,
  # the bias sums' halves); f32 (three TF32 passes): kF32NtSmem (the ring
  # of A slices and B's two parts, the mbarriers), kF32TnSmem (the ring of
  # Z and X slices, two buffers of X^T's two parts, the mbarriers).
  from refnerf_tpu_torch.ops import cuda_build
  c = _c_constants(cuda_build.CSRC / 'trunk_w1024.cu')
  for cdt, nt, tn, want in (('bfloat16', 'kNtSmem', 'kTnSmem',
                             (214080, 198720)),
                            ('float32', 'kF32NtSmem', 'kF32TnSmem',
                             (197696, 197728))):
    assert (c[nt], c[tn]) == want
    assert fused_mlp.kernel_smem('trunk_w1024', _pack(cdt), 256) == (
        max(c[nt], c[tn]))
    assert max(c[nt], c[tn]) <= fused_mlp.SMEM_LIMIT


@pytest.mark.parametrize('n,slab', [(600, None), (534, 384)])
def test_w1024_bias_gradients_come_from_the_weight_gradients(w1024_sim, n,
                                                            slab):
  # In both dtypes the bias gradients (each layer's db and the
  # bottleneck's dbc) are the weight-gradient products' per-partial column
  # sums of zeta and cbar, summed in the fixed order: within GRAD_BOUND of
  # trunk_backward_reference, and the only column sum left a slab is the
  # density head's (y scaled by sigma's cotangent).
  segs, ws, bs, kw, cots = _trunk(6, n)
  colsums = []
  sim_colsum = w1024_sim._colsum

  def colsum(vbf, rows, cols, v, ldv, s, block_rows, part, stream):
    colsums.append((cols, bool(s)))
    return sim_colsum(vbf, rows, cols, v, ldv, s, block_rows, part, stream)
  w1024_sim._colsum = colsum
  for cdt in ('bfloat16', 'float32'):
    dt = fused_mlp.DTYPES[cdt]
    xs = [s.to(dt) for s in segs]
    cs = cots[:2] + (cots[2].to(dt), None)
    pack = fused_mlp.pack_trunk(ws, bs, (252, 252), compute_dtype=cdt, **kw)
    colsums.clear()
    got = fused_mlp.trunk_backward_kernel(xs, pack, cs, slab=slab)
    want = fused_mlp.trunk_backward_reference(xs, ws, bs, cs,
                                              compute_dtype=cdt, **kw)
    slabs = -(-n // (slab or n))
    assert colsums == [(1024, True)] * slabs, cdt
    # (dbs, dbc): index 1 is the layers' bias gradients, 6 the
    # bottleneck's.
    for g, w in list(zip(got[1], want[1])) + [(got[6], want[6])]:
      assert g.shape == w.shape and g.dtype == torch.float32
      assert ((g - w).norm() / w.norm()).item() <= GRAD_BOUND[cdt], cdt


@pytest.mark.parametrize('sms', [132, 114])
def test_w1024_split_fits_its_scratch_for_every_slab(sms):
  # H24: for every slab length from 1 row to a full slab
  # (bwd_slab_rows(1024)), each weight gradient of the NeRF MLP (1024 x
  # 512, 1024 x 1024, 1024 x 1536, the bottleneck's 256 x 1024) splits into
  # whole 64-row slices (32 in f32) that cover the slab in at most
  # w1024_splits partials, the count the scratch is sized by, at most 16
  # (the rule of either dtype's tiles: 128 x 256 in bf16, 128 x 128 in
  # f32).
  full = fused_mlp.bwd_slab_rows(1024)
  rows = np.arange(1, full + 1)
  for cdt, q in (('bfloat16', 64), ('float32', 32)):
    for m, k in ((1024, 512), (1024, 1024), (1024, 1536), (256, 1024)):
      most = fused_mlp.w1024_splits(m, k, sms, cdt)
      assert 1 <= most <= 16
      split = np.array([fused_mlp.w1024_split(int(r), m, k, sms, cdt)
                        for r in rows[::97]] +
                       [fused_mlp.w1024_split(full, m, k, sms, cdt)])
      # w1024_split is ceil(rows / (most * q)) * q: checked on a sample
      # against the function, then for every length.
      every = -(-rows // (most * q)) * q
      assert (split == np.append(every[::97], every[-1])).all()
      parts = -(-rows // every)
      assert (every % q == 0).all() and (parts * every >= rows).all()
      assert parts.max() <= most, (cdt, m, k, sms)


def _truncated_product(a, b, slice_k=None):
  """a @ b (f32 operands) as three TF32 passes accumulate on the tensor
  cores, modelled in float64: each k8 step's three products (each an
  exact sum of 8) added into the accumulator, which is cut to 24
  significant bits toward zero after every addition; with `slice_k` each
  slice_k-deep slice accumulates so into a fresh set that is added into
  the result in f32, rounded to nearest (csrc/trunk_w1024.cu's `part`)."""
  (ah, al), (bh, bl) = (tuple(t.double().numpy() for t in _split(x))
                        for x in (a, b))
  cut = lambda x: np.ldexp(np.trunc(np.frexp(x)[0] * 2.0**24) / 2.0**24,
                           np.frexp(x)[1])
  k_all, step = a.shape[1], slice_k or a.shape[1]
  out = np.zeros((a.shape[0], b.shape[1]), np.float32)
  for k0 in range(0, k_all, step):
    acc = np.zeros(out.shape)
    for k in range(k0, k0 + step, 8):
      s = slice(k, k + 8)
      for x, y in ((al, bh), (ah, bl), (ah, bh)):
        acc = cut(acc + x[:, s] @ y[s])
    out = out + acc.astype(np.float32)
  return out.astype(np.float64)


def test_w1024_tf32_truncating_accumulation_needs_slice_sums():
  # H26: the tensor cores add into f32 accumulators with truncation, whose
  # bias grows with the additions. On a layer's product (64 rows of relu'd
  # activations by a 1024 x 128 block of He-scaled weights), modelled by
  # `_truncated_product`: one accumulator set over K = 1024 (3 x 128
  # additions) reads tens of times an f32 product's error; each 32-deep
  # slice summed into the result in f32, as the kernels do, reads within
  # 3x of it.
  gen = torch.Generator().manual_seed(8)
  a = torch.relu(torch.randn(64, 1024, generator=gen))
  b = torch.randn(1024, 128, generator=gen) * math.sqrt(2 / 1024)
  exact = a.double().numpy() @ b.double().numpy()
  rel = lambda got: np.linalg.norm(got - exact) / np.linalg.norm(exact)
  f32 = rel((a @ b).double().numpy())
  one_set = rel(_truncated_product(a, b))
  sliced = rel(_truncated_product(a, b, 32))
  assert one_set > 10 * f32 and sliced < 3 * f32, (f32, one_set, sliced)


@pytest.mark.parametrize('passes', [3, 1])
def test_w1024_tf32_passes_against_the_f32_bound(w1024_sim, passes):
  # The f32 products as csrc/trunk_w1024.cu computes them, each operand
  # split into TF32 parts (hi = tf32(v), lo = tf32(v - hi)) and three
  # passes summed (lo.hi + hi.lo + hi.hi), modelled in torch (`_split`,
  # `_tf32_product`) against float64: the skip layer's product at the NeRF
  # MLP's shapes (600 x 1528 by 1528 x 1024) and the whole forward through
  # the wrappers on _W1024Sim against trunk_reference. Three passes sit
  # well inside KERNEL_BOUND['float32'] (1e-4 of the largest entry: the
  # product within 1e-6, the trunk within 1e-5); one pass (hi.hi alone)
  # reads above the bound, so the bound would see that shortcut.
  segs, ws, bs, kw, _ = _trunk(7, 600)
  gen = torch.Generator().manual_seed(7)
  a = torch.relu(torch.randn(600, 1528, generator=gen))
  b = ws[5].t().contiguous()
  exact = a.double() @ b.double()
  got = _tf32_product(a, b, passes).double()
  err = ((got - exact).abs().max() / exact.abs().max()).item()
  w1024_sim.passes = passes
  pack = fused_mlp.pack_trunk(ws, bs, (252, 252), **kw)
  out = fused_mlp.trunk_kernel(segs, pack)
  want = fused_mlp.trunk_reference(segs, ws, bs, **kw)
  trunk = max(((g - w).abs().max() / max(1.0, w.abs().max().item())).item()
              for g, w in zip(out, want))
  if passes == 3:
    assert err <= 1e-6 and trunk <= KERNEL_BOUND['float32'] / 10, (err, trunk)
  else:
    assert err > KERNEL_BOUND['float32'] and trunk > KERNEL_BOUND['float32'], (
        err, trunk)


# --------------------------------- the full-width model through the route


def _route_stubs(monkeypatch):
  """use_kernel as on a card. The forward op's CPU implementation runs
  trunk_kernel where the pack takes the width-1024 route (its libraries
  replaced by the w1024_sim fixture) and the plain version elsewhere; the
  backward likewise. Forward launches are recorded under the keys the
  op's CUDA implementation counts (`fwd`), every route in `routes`."""
  fwd, routes = collections.Counter(), []
  plain_fwd, kernel_bwd = fused_mlp.trunk_plain, fused_mlp.trunk_backward_kernel

  def forward(segs, pack, fold=None, dir_modes=None, rgbx=None,
              spa_modes=None, comp=None, out_y=False):
    dm, sp = dir_modes or fused_mlp.DirModes(), spa_modes or fused_mlp.SpaModes()
    route = fused_mlp.forward_library(pack, out_y, fold, sp)
    routes.append(('fwd', pack.width, route))
    fwd.update(fused_mlp.launch_keys(fused_mlp.forward_kind(pack, fold), pack,
                                     out_y, fold, dm, sp))
    if route == fused_mlp.W1024_LIBRARY:
      return fused_mlp.trunk_kernel(segs, pack, fold, dm, rgbx, sp, comp, out_y)
    return plain_fwd(segs, pack, fold, dir_modes, rgbx, spa_modes, comp, out_y)

  def backward(segs, pack, cots, fold=None, needs_dx=False, slab=None,
               dir_modes=None, rgbx=None, rgb_bar=None, spa_modes=None,
               comp=None, ybar=None):
    route = fused_mlp.backward_library(pack, ybar is not None, fold)
    routes.append(('bwd', pack.width, route))
    if route == fused_mlp.W1024_LIBRARY:
      return kernel_bwd(segs, pack, cots, fold, needs_dx, slab, dir_modes,
                        rgbx, rgb_bar, spa_modes, comp, ybar)
    ws, bs, kw = fused_mlp.unpack_trunk(pack)
    return fused_mlp.trunk_backward_reference(
        segs, ws, bs, cots, fold=fold, needs_dx=needs_dx,
        dir_modes=dir_modes, rgbx=rgbx, rgb_bar=rgb_bar, spa_modes=spa_modes,
        comp=comp, ybar=ybar, **kw)

  monkeypatch.setattr(fused_mlp, 'use_kernel',
                      lambda x, mode: fused_mlp.MODES.index(mode) < 2)
  monkeypatch.setattr(fused_mlp, 'trunk_plain', forward)
  monkeypatch.setattr(fused_mlp, 'trunk_backward_kernel', backward)
  return fwd, routes


@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
def test_full_width_model_takes_the_w1024_route(w1024_sim, monkeypatch, cdt):
  # MIPNERF360 at full width (4 rays, 64 + 64 + 32 samples) trains a step
  # under 'on' with the NeRF MLP's spatial trunk on the width-1024
  # libraries: K1 and K4 once each under 'K1 w1024' / 'K4 w1024', the
  # PropMLP's pair twice ('K1 wide' / 'K4 wide'), the directional trunk's
  # once (K2 on 283 columns, K5; both on trunk_dir1, run here by their
  # plain versions); its loss and gradient norm within
  # chip_smoke.py's 1e-3 and 1e-2 of the step under 'off'; then a request
  # launches K1 three times (one 'K1 w1024') and K2 once.
  fwd, routes = _route_stubs(monkeypatch)
  bindings = MIPNERF360 + [f"NerfMLP.compute_dtype = '{cdt}'",
                           f"PropMLP.compute_dtype = '{cdt}'",
                           'Config.batch_size = 4']
  config, gin = configs.parse([], bindings + ON)
  model = construct.construct_model(config, gin, 'cpu')
  r = _rays_np(4, config, 7)
  batch = rays_lib.Batch(rays=rays_lib.Rays(**{k: _t(v) for k, v in
                                               r.items()}),
                         rgb=_t(np.full((4, 3), 0.5, np.float32)))
  state = step_lib.create_train_state(config, model)
  train = step_lib.make_train_step(model, config)
  before = dict(fused_mlp.launches)
  loss_on, _, grads = train.loss_and_grads(state, batch)
  norm_on = step_lib.global_norm(grads.values()).item()
  launches = {k: v - before[k] + fwd[k] for k, v in fused_mlp.launches.items()}
  assert {k: v for k, v in launches.items() if v} == {
      'K1': 3, 'K1 wide': 2, 'K2': 1, 'K4': 3, 'K4 wide': 2, 'K5': 1,
      'K1 w1024': 1, 'K4 w1024': 1}
  assert ('fwd', 1024, 'trunk_w1024') in routes
  assert ('bwd', 1024, 'trunk_w1024') in routes
  assert ('fwd', 128, 'trunk_dir1') in routes and ('bwd', 128, 'trunk_dir1') in routes
  for mlp in (model.nerf_mlp, model.prop_mlp):
    mlp.cfg.fused_trunk = 'off'
  loss_off, _, grads = train.loss_and_grads(state, batch)
  norm_off = step_lib.global_norm(grads.values()).item()
  assert abs(loss_on.item() - loss_off.item()) <= 1e-3 * abs(loss_off.item())
  assert abs(norm_on - norm_off) <= 1e-2 * norm_off
  for mlp in (model.nerf_mlp, model.prop_mlp):
    mlp.cfg.fused_trunk = 'on'
  fwd.clear()
  with torch.no_grad():
    model(batch.rays, train_frac=1.0)
  assert {k: v for k, v in fwd.items() if v} == {
      'K1': 3, 'K1 wide': 2, 'K1 w1024': 1, 'K2': 1}


def test_configuration_builds_and_renders_without_jax():
  # In a process with jax, flax, optax, absl and refnerf_tpu blocked: the
  # bindings parse (the gin references @jnp.reciprocal and @coord.contract
  # resolve by their last part), the model cut to size renders, and
  # coord's trio runs.
  script = textwrap.dedent(f'''
      import sys
      for name in ('jax', 'flax', 'optax', 'absl', 'refnerf_tpu'):
        sys.modules[name] = None
      import torch
      from refnerf_tpu_torch import configs
      from refnerf_tpu_torch.cameras import rays as rays_lib
      from refnerf_tpu_torch.models import construct, renderer
      from refnerf_tpu_torch.ops import coord
      from refnerf_tpu_torch.testing.mipnerf360 import MIPNERF360
      config, gin = configs.parse([], MIPNERF360 + {SMALL!r})
      model = construct.construct_model(config, gin, 'cpu')
      d = torch.randn(3, 3, generator=torch.Generator().manual_seed(0))
      rays = rays_lib.dummy_rays(3)
      rays.directions, rays.viewdirs = d, d / d.norm(dim=-1, keepdim=True)
      rays.near = rays.near + config.near
      rays.far = rays.far + config.far
      out = renderer.render_rays(model, rays, 3)
      assert torch.isfinite(out['rgb']).all() and out['rgb'].shape == (3, 3)
      x = torch.randn(4, 3) * 10
      m, c = coord.track_linearize(coord.contract, x,
                                   torch.eye(3).expand(4, 3, 3))
      assert torch.allclose(coord.inv_contract(m), x, rtol=1e-4)
      bad = [k for k in sys.modules if k.split('.')[0] in
             ('jax', 'flax', 'optax', 'absl', 'refnerf_tpu') and
             sys.modules[k] is not None]
      assert not bad, bad
      print('ok')
  ''')
  root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  proc = subprocess.run([sys.executable, '-c', script], cwd=root,
                        capture_output=True, text=True, timeout=600)
  assert proc.returncode == 0 and 'ok' in proc.stdout, proc.stderr[-3000:]
