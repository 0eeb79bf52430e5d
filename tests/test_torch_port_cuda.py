"""The CUDA trunk kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips elsewhere:
K1-K5, K6 and K7 (the fused spatial stages), K8-K10 (the fused
directional stages) and mip-NeRF's K11 (the trunk's features out) and
128-wide directional trunk, in both directions. This
file imports no jax, so it also runs where jax is not installed; there, skip
tests/conftest.py (it imports jax):

    python -m pytest --noconftest tests/test_torch_port_cuda.py

Tolerances, as in chip_smoke.py. Values (sigma, heads, bottleneck, rgb):
max |kernel - plain| <= bound * max(1, max|plain|), with bound 1e-4 in
float32 (one arithmetic, another summation order) and 5e-2 in bfloat16 (a
per-layer bf16 rounding flip of 2^-8, carried by later layers). Derivatives
(u, gradients, dx): |kernel - plain|_2 / |plain|_2 <= 5e-3 in float32 and
5e-2 in bfloat16, since a pre-activation within the summation-order noise
of 0 flips a relu' mask and moves its sample's derivative by ~10%. K6's
compositing weights (f32, each below 1): max |kernel - plain| <= 1e-5 in
float32 and 5e-3 in bfloat16, absolute, below what an inclusive scan or a
dropped density bias reads on the same inputs (checked too). K11's y
(compute dtype): |kernel - plain|_2 / |plain|_2 <= 1e-5 in float32 and
1e-2 in bfloat16, below what a dropped last bias reads (checked too).
TF32 is off for the plain versions.
"""

import math
import os

import numpy as np
import pytest
import torch

from refnerf_tpu_torch import configs
from refnerf_tpu_torch.cameras import rays as rays_lib
from refnerf_tpu_torch.models import construct
from refnerf_tpu_torch.models import renderer
from refnerf_tpu_torch.ops import fused_mlp
from refnerf_tpu_torch.train import step as step_lib

BOUND = {'float32': 1e-4, 'bfloat16': 5e-2}
GRAD_BOUND = {'float32': 5e-3, 'bfloat16': 5e-2}
WEIGHT_BOUND = {'float32': 1e-5, 'bfloat16': 5e-3}
Y_BOUND = {'float32': 1e-5, 'bfloat16': 1e-2}
GIN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   'configs', 'blender_refnerf.gin')
SCALES = 2.0**np.arange(0, 16)  # the flagship's IPE degrees


@pytest.fixture
def dev():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA card: the trunk kernels have no CPU mode')
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  return torch.device('cuda')


# (segment widths, width, f32 head outputs, compute-dtype head outputs,
# density head): the flagship's spatial (K1) and directional (K2) trunks;
# mip-NeRF's spatial trunk without heads but the density (K11) and its
# directional trunk at width 128 on [bottleneck 128 | positional encoding
# 33] (mip K2).
TRUNKS = {'K1': ((48, 48), 256, 10, 128, True),
          'K2': ((128, 73), 256, 3, 0, False),
          'K11': ((48, 48), 256, 0, 0, True),
          'mip K2': ((128, 33), 128, 3, 0, False)}


def _case(which, dev, n=1000, seed=0, width=None):
  """The trunk TRUNKS[which] (8 layers, skip at 5; `width` overrides its
  width). n = 1000 rows is not a multiple of the kernel's 64-row tile. The
  (48, 48) segments are the IPE encoding of random lifted means and
  variances, the others uniform in [-1, 1]."""
  gen = torch.Generator().manual_seed(seed)
  rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
  seg_dims, w0, hf, hc, density = TRUNKS[which]
  width = width or w0
  fin = sum(seg_dims)
  skips = fused_mlp.skip_input_layers(8, 4)
  ws = [rand(width, fin if l == 0 else width + (fin if l in skips else 0))
        for l in range(8)]
  ws = [w * math.sqrt(2 / w.shape[1]) for w in ws]
  bs = [rand(width) * 0.05 for _ in range(8)]
  head = lambda k: (rand(k, width) / math.sqrt(width), rand(k) * 0.1)
  kw = dict(skip_period=4,
            wd=rand(1, width) / math.sqrt(width) if density else None,
            head_f32=head(hf) if hf else None,
            head_cdt=head(hc) if hc else None)
  if seg_dims == (48, 48):
    lm = torch.rand(n, 3, generator=gen).to(dev) * 3 - 1.5
    lv = 10.0**(torch.rand(n, 3, generator=gen).to(dev) * 4 - 6)
    segs = list(fused_mlp.encode_ipe(lm, lv, SCALES))
  else:
    segs = [torch.rand(n, d, generator=gen).to(dev) * 2 - 1 for d in seg_dims]
  return segs, ws, bs, kw


def _assert_close(got, want, cdt, what='', n_values=None):
  """The first n_values outputs (all by default) are values, the rest
  derivatives."""
  assert len(got) == len(want), what
  n_values = len(got) if n_values is None else n_values
  for i, (a, b) in enumerate(zip(got, want)):
    assert a.dtype == b.dtype and a.shape == b.shape, (what, i)
    d, b = a.float() - b.float(), b.float()
    if i < n_values:
      scale = max(1.0, b.abs().max().item())
      err = d.abs().max().item()
      assert err <= BOUND[cdt] * scale, (what, i, err, BOUND[cdt] * scale)
    else:
      err = d.norm().item() / max(b.norm().item(), 1e-30)
      assert err <= GRAD_BOUND[cdt], (what, i, err, GRAD_BOUND[cdt])


@pytest.mark.cuda
@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
@pytest.mark.parametrize('which', ['K1', 'K2'])
def test_kernel_matches_plain(dev, which, cdt):
  segs, ws, bs, kw = _case(which, dev)
  pack = fused_mlp.pack_trunk(ws, bs, [s.shape[-1] for s in segs],
                              compute_dtype=cdt, **kw)
  with torch.no_grad():
    got = fused_mlp.trunk_kernel(segs, pack)
    want = fused_mlp.trunk_reference(segs, ws, bs, compute_dtype=cdt, **kw)
  torch.cuda.synchronize()
  _assert_close(got, want, cdt)


@pytest.mark.cuda
@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
def test_density_grad_kernel_matches_plain(dev, cdt):
  # K3: sigma, the heads and u = d sigma / d lifted-means.
  segs, ws, bs, kw = _case('K1', dev)
  segs = [s.to(fused_mlp.DTYPES[cdt]) for s in segs]
  fold = torch.as_tensor(fused_mlp.ipe_scale_fold(SCALES, 3), device=dev)
  pack = fused_mlp.pack_trunk(ws, bs, [s.shape[-1] for s in segs],
                              compute_dtype=cdt, **kw)
  with torch.no_grad():
    got = fused_mlp.trunk_kernel(segs, pack, fold)
    want = fused_mlp.trunk_reference(segs, ws, bs, compute_dtype=cdt,
                                     density_grad=True, **kw)
    want = want[:-2] + [fused_mlp.fold_density_grad(want[-2:], *segs, fold)]
  torch.cuda.synchronize()
  _assert_close(got, want, cdt, 'K3', n_values=3)


def _cotangents(which, dev, n, seed=1):
  gen = torch.Generator().manual_seed(seed)
  rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
  if which == 'K1':
    return rand(n), rand(n, 10), rand(n, 128), rand(n, 3)
  return None, rand(n, 3), None, None


@pytest.mark.cuda
@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
@pytest.mark.parametrize('which', ['K1', 'K2'])
def test_backward_kernel_matches_plain(dev, which, cdt):
  # K4 (spatial, with the cotangent of u) and K5 (directional, with dx):
  # every weight, bias and segment gradient. A slab of 256 rows splits the
  # 1000 samples into four, so the slab accumulation runs too.
  n = 1000
  segs, ws, bs, kw = _case(which, dev, n=n)
  segs = [s.to(fused_mlp.DTYPES[cdt]) for s in segs]
  cots = _cotangents(which, dev, n)
  fold = (torch.as_tensor(fused_mlp.ipe_scale_fold(SCALES, 3), device=dev)
          if which == 'K1' else None)
  needs_dx = which == 'K2'
  pack = fused_mlp.pack_trunk(ws, bs, [s.shape[-1] for s in segs],
                              compute_dtype=cdt, **kw)
  with torch.no_grad():
    got = fused_mlp.trunk_backward_kernel(segs, pack, cots, fold, needs_dx,
                                          slab=256)
    want = fused_mlp.trunk_backward_reference(
        segs, ws, bs, cots, compute_dtype=cdt, fold=fold, needs_dx=needs_dx,
        **kw)
  torch.cuda.synchronize()
  flat = lambda r: [t for x in r for t in (x if isinstance(x, list) else [x])
                    if t is not None]
  _assert_close(flat(got), flat(want), cdt, which, n_values=0)


@pytest.mark.cuda
def test_wrappers_count_launches_and_honour_off(dev):
  segs, ws, bs, kw = _case('K2', dev, n=77)
  kw.pop('wd'), kw.pop('head_cdt')
  ws = [w.requires_grad_(True) for w in ws]
  before = dict(fused_mlp.launches)
  on = fused_mlp.fused_trunk(segs, ws, bs, **kw)
  on.sum().backward()
  grad_on = ws[0].grad.clone()
  ws[0].grad = None
  off = fused_mlp.fused_trunk(segs, ws, bs, mode='off', **kw)
  off.sum().backward()
  assert fused_mlp.launches['K2'] == before['K2'] + 1
  assert fused_mlp.launches['K5'] == before['K5'] + 1
  _assert_close([on, grad_on], [off, ws[0].grad], 'float32', n_values=1)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_model(dev):
  segs, ws, bs, kw = _case('K2', dev, n=8)
  kw.pop('wd'), kw.pop('head_cdt')
  with torch.no_grad(), pytest.raises(NotImplementedError, match='ReLU'):
    fused_mlp.fused_trunk(segs, ws, bs, activation=torch.tanh, **kw)
  segs, ws, bs, kw = _case('K2', dev, n=8, width=64)
  kw.pop('wd'), kw.pop('head_cdt')
  with torch.no_grad(), pytest.raises(NotImplementedError, match='width 64'):
    fused_mlp.fused_trunk(segs, ws, bs, **kw)
  # Width 128 runs the plain directional trunk alone.
  segs, ws, bs, kw = _case('K1', dev, n=8, width=128)
  kw.pop('head_cdt')
  with torch.no_grad(), pytest.raises(NotImplementedError,
                                      match='width-128.*density head'):
    fused_mlp.fused_encoded_trunk(
        torch.zeros(8, 3, device=dev), torch.full((8, 3), 1e-4, device=dev),
        SCALES, ws, bs, **kw)


# The fused directional stages (K8 the IDE, K9 the direction geometry, K10
# the colour epilogue) in the directional trunk's forward and backward.
DIR_CASES = {'K8': (True, False, False), 'K8+K9': (True, True, False),
             'K10': (False, False, True), 'K8+K9+K10': (True, True, True)}


def _dir_case(dev, case, n=1000, seed=3):
  """Flagship directional trunk (8 x 256, skip at 5, rgb head) on the raw
  inputs of a mode: bottleneck 128 | refdirs, kappa_inv, n.v (K8), or
  grad_pred, viewdirs, kappa_inv (K9), or the 73-wide encoding (K10 alone);
  kappa_inv in [0.05, 0.5] as the model's roughness (ROADMAP H9)."""
  ide, geo, rgb = DIR_CASES[case]
  gen = torch.Generator().manual_seed(seed)
  rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
  unit = lambda v: v / v.norm(dim=-1, keepdim=True)
  skips = fused_mlp.skip_input_layers(8, 4)
  ws = [rand(256, 201 if l == 0 else 256 + (201 if l in skips else 0))
        for l in range(8)]
  ws = [w * math.sqrt(2 / w.shape[1]) for w in ws]
  bs = [rand(256) * 0.05 for _ in range(8)]
  head = (rand(3, 256) / 16, rand(3) * 0.1)
  ki = 0.05 + 0.45 * torch.rand(n, 1, generator=gen).to(dev)
  segs = [rand(n, 128)]
  if not ide:
    segs.append(torch.rand(n, 73, generator=gen).to(dev) * 2 - 1)
  elif geo:
    segs += [rand(n, 3), unit(rand(n, 3)), ki]
  else:
    segs += [unit(rand(n, 3)), ki, torch.rand(n, 1, generator=gen).to(dev)]
  dm = fused_mlp.DirModes(5 if ide else 0, 1, geo,
                          (1.0, 0.0, 0.001) if rgb else None)
  rgbx = (rand(n, 3), rand(n, 3)) if rgb else None
  return segs, ws, bs, head, dm, rgbx


@pytest.mark.cuda
@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
@pytest.mark.parametrize('case', sorted(DIR_CASES))
def test_dir_modes_match_plain(dev, case, cdt):
  # Forward: raw rgb (and rgb with K10) as values; backward, given random
  # cotangents of both: every parameter gradient, the segments' and raw
  # inputs' cotangents and d raw diffuse / tint, as derivatives.
  n = 1000
  segs, ws, bs, head, dm, rgbx = _dir_case(dev, case, n)
  segs = [s if dm.ide_deg and 1 <= j < 1 + dm.n_raw()
          else s.to(fused_mlp.DTYPES[cdt]) for j, s in enumerate(segs)]
  pack = fused_mlp.pack_trunk(ws, bs, fused_mlp.visible_dims(segs, dm),
                              head_f32=head, compute_dtype=cdt)
  gen = torch.Generator().manual_seed(4)
  hbar = torch.randn(n, 3, generator=gen).to(dev)
  rgb_bar = torch.randn(n, 3, generator=gen).to(dev) if rgbx else None
  kw = dict(dir_modes=dm, rgbx=rgbx)
  with torch.no_grad():
    got = fused_mlp.trunk_kernel(segs, pack, **kw)
    want = fused_mlp.trunk_reference(segs, ws, bs, head_f32=head,
                                     compute_dtype=cdt, **kw)
    gb = fused_mlp.trunk_backward_kernel(
        segs, pack, (None, hbar, None, None), needs_dx=True, slab=256,
        rgb_bar=rgb_bar, **kw)
    wb = fused_mlp.trunk_backward_reference(
        segs, ws, bs, (None, hbar, None, None), head_f32=head,
        compute_dtype=cdt, needs_dx=True, rgb_bar=rgb_bar, **kw)
  torch.cuda.synchronize()
  _assert_close(got, want, cdt, case)
  flat = lambda r: [t for x in r for t in (x if isinstance(x, (list, tuple))
                                           else [x]) if t is not None]
  _assert_close(flat(gb), flat(wb), cdt, case, n_values=0)


# The fused spatial stages (K7 the IPE, K6 the compositing weights) in the
# spatial trunk's forward (K1, K3) and backward (K4): (IPE in the kernel,
# samples a ray, density gradient and backward). 128 samples a ray is the
# flagship's (a forward CTA owns two tiles); 24 makes CTAs of three tiles
# whose rays do not align with the tiles. K6+K7 on K1 is the served launch,
# where the ray scratch shares the shared memory of the relu' bits.
SPA_CASES = {'K7': (True, 0, False), 'K7+K3': (True, 0, True),
             'K6+K7': (True, 128, False),
             'K6+K3': (False, 128, True), 'K6+K7+K3': (True, 128, True),
             'K6+K7+K3 S24': (True, 24, True)}


def _assert_weights(got, want, raw, comp, samples, cdt, what):
  """K6's weights within WEIGHT_BOUND, and two faults of the scan (an
  inclusive one, a dropped density bias) read on the plain raw density
  above it."""
  delta, bsig = comp
  err = (got - want).abs().max().item()
  assert err <= WEIGHT_BOUND[cdt], (what, err, WEIGHT_BOUND[cdt])
  dd = torch.nn.functional.softplus(raw + bsig) * delta
  incl = (want * torch.exp(-dd) - want).abs().max().item()
  nobias = (fused_mlp.composite_weights(raw, delta, bsig * 0, samples)
            - want).abs().max().item()
  assert min(incl, nobias) > WEIGHT_BOUND[cdt], (what, incl, nobias)


@pytest.mark.cuda
@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
@pytest.mark.parametrize('case', sorted(SPA_CASES))
def test_spatial_modes_match_plain(dev, case, cdt):
  # Forward: sigma and the heads as values, u as a derivative, the weights
  # by WEIGHT_BOUND; backward (slabs of 512 rows, whole rays), given random
  # cotangents of every output: every parameter gradient and d bsig, as
  # derivatives.
  enc, samples, dg = SPA_CASES[case]
  n = {0: 1000, 128: 1536, 24: 1440}[samples]
  _, ws, bs, kw = _case('K1', dev, n=8)
  gen = torch.Generator().manual_seed(6)
  rand = lambda *s: torch.rand(*s, generator=gen).to(dev)
  lm, lv = rand(n, 3) * 3 - 1.5, 10.0**(rand(n, 3) * 4 - 6)
  # delta and bsig as chip_smoke.py's phase 9 makes them (the flagship's).
  comp = (rand(n) * 0.08 + 0.01, torch.tensor([0.5], device=dev))
  comp = comp if samples else None
  sp = fused_mlp.SpaModes(tuple(float(s) for s in SCALES) if enc else (),
                          samples)
  segs = ([lm, lv] if enc else [s.to(fused_mlp.DTYPES[cdt]) for s in
                                fused_mlp.encode_ipe(lm, lv, SCALES)])
  fold = (torch.as_tensor(fused_mlp.ipe_scale_fold(SCALES, 3), device=dev)
          if dg else None)
  pack = fused_mlp.pack_trunk(ws, bs, (48, 48), compute_dtype=cdt, **kw)
  kws = dict(spa_modes=sp, comp=comp)
  with torch.no_grad():
    got = fused_mlp.trunk_kernel(segs, pack, fold, **kws)
    want = fused_mlp.trunk_reference(segs, ws, bs, compute_dtype=cdt,
                                     density_grad=dg, fold=fold, **kws, **kw)
  torch.cuda.synchronize()
  assert len(got) == len(want) == 3 + dg + bool(samples), case
  _assert_close(got[:3], want[:3], cdt, case)
  if dg:
    _assert_close(got[3:4], want[3:4], cdt, case, n_values=0)
  if samples:
    _assert_weights(got[-1], want[-1], want[0], comp, samples, cdt, case)
  if not dg:
    return
  cots = _cotangents('K1', dev, n) + ((rand(n) - 0.5,) if samples else ())
  with torch.no_grad():
    gb = fused_mlp.trunk_backward_kernel(
        segs, pack, cots, fold, slab=512, spa_modes=sp,
        comp=comp + (got[0],) if samples else None)
    wb = fused_mlp.trunk_backward_reference(
        segs, ws, bs, cots, compute_dtype=cdt, fold=fold, spa_modes=sp,
        comp=comp + (want[0],) if samples else None, **kw)
  torch.cuda.synchronize()
  flat = lambda r: [t for x in r for t in (x if isinstance(x, list) else [x])
                    if t is not None]
  _assert_close(flat(gb), flat(wb), cdt, case, n_values=0)


@pytest.mark.cuda
def test_in_kernel_ipe_range_reduction_matches_plain(dev):
  # K7 with lv = 0 and lm in [-3, 3]: at degree 15 |m| reaches ~1e5, where
  # an ulp of m is ~8e-3 and every degree is undamped, so the kernel's
  # reduction must round as torch.remainder does (fmodf plus t): float32,
  # values 1e-4 as above (a reduction x - t floor(x / t) moves sin by up
  # to ~1e-2 there).
  n = 1000
  _, ws, bs, kw = _case('K1', dev, n=8)
  gen = torch.Generator().manual_seed(7)
  lm = (torch.rand(n, 3, generator=gen) * 6 - 3).to(dev)
  lv = torch.zeros(n, 3, device=dev)
  assert (lm.abs().max() * SCALES[-1]).item() > 5e4
  sp = fused_mlp.SpaModes(tuple(float(s) for s in SCALES))
  pack = fused_mlp.pack_trunk(ws, bs, (48, 48), compute_dtype='float32', **kw)
  with torch.no_grad():
    got = fused_mlp.trunk_kernel([lm, lv], pack, spa_modes=sp)
    want = fused_mlp.trunk_reference([lm, lv], ws, bs, spa_modes=sp, **kw)
  torch.cuda.synchronize()
  _assert_close(got, want, 'float32', 'K7 range reduction')


def _rays(n, dev):
  rng = np.random.default_rng(0)
  d = torch.tensor(rng.normal(size=(n, 3)).astype(np.float32), device=dev)
  rays = rays_lib.dummy_rays(n, dev)
  rays.directions, rays.viewdirs = d, d / d.norm(dim=-1, keepdim=True)
  rays.radii = rays.radii + 1e-3
  rays.near, rays.far = rays.near + 2, rays.far + 5
  rays.lossmult = rays.lossmult + 1
  return rays


@pytest.mark.cuda
@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
def test_model_kernels_match_plain_path(dev, cdt):
  config, gin = configs.parse(
      [GIN],
      ['Model.num_prop_samples = 16', 'Model.num_nerf_samples = 16',
       f"NerfMLP.compute_dtype = '{cdt}'"])
  model = construct.construct_model(config, gin, dev)
  rays = _rays(100, dev)
  before = fused_mlp.launches['K1']
  with torch.no_grad():
    out = renderer.render_rays(model, rays, 64)
    assert fused_mlp.launches['K1'] == before + 2 * 2
    model.nerf_mlp.cfg.fused_trunk = 'off'
    plain = renderer.render_rays(model, rays, 64)
  for k in out:
    assert torch.isfinite(out[k]).all()
    err = (out[k] - plain[k]).abs().max().item()
    assert err <= BOUND[cdt], (k, err)


FUSE = ['NerfMLP.fuse_dir_enc = True', 'NerfMLP.fuse_dir_geo = True',
        'NerfMLP.fuse_dir_rgb = True']


@pytest.mark.cuda
def test_model_with_dir_fusions_matches_plain_path(dev):
  # The flagship with K8-K10 at 16 samples per level, f32: a served request
  # (each of K2, K8, K9, K10 once per level) and one step's loss and
  # gradients (forward and backward each once per level) against
  # fused_trunk='off'.
  config, gin = configs.parse(
      [GIN], ['Model.num_prop_samples = 16', 'Model.num_nerf_samples = 16',
              'Config.sample_noise_size = 0'] + FUSE)
  model = construct.construct_model(config, gin, dev)
  rays = _rays(100, dev)
  before = dict(fused_mlp.launches)
  with torch.no_grad():
    out = renderer.render_rays(model, rays, 128)
  for k in ('K2', 'K8', 'K9', 'K10'):
    assert fused_mlp.launches[k] == before[k] + 2, k
  batch = rays_lib.Batch(rays=rays, rgb=torch.rand(100, 3, generator=torch
                                                   .Generator().manual_seed(0)).to(dev))
  state = step_lib.create_train_state(config, model)
  train = step_lib.make_train_step(model, config)
  before = dict(fused_mlp.launches)
  loss, _, grads = train.loss_and_grads(state, batch)
  for k in ('K8', 'K9', 'K10'):
    assert fused_mlp.launches[k] == before[k] + 4, k
  model.nerf_mlp.cfg.fused_trunk = 'off'
  with torch.no_grad():
    plain = renderer.render_rays(model, rays, 128)
  loss_off, _, grads_off = train.loss_and_grads(state, batch)
  for k in out:
    err = (out[k] - plain[k]).abs().max().item()
    assert err <= BOUND['float32'], (k, err)
  assert abs(loss.item() - loss_off.item()) <= 1e-4 * abs(loss_off.item())
  for k in grads:
    _assert_close([grads[k]], [grads_off[k]], 'float32', k, n_values=0)


@pytest.mark.cuda
def test_train_step_kernels_match_plain_path(dev):
  # The flagship's train step at full width and 16 samples per level, f32:
  # the loss and every gradient through K2-K5 against fused_trunk='off'.
  config, gin = configs.parse(
      [GIN], ['Model.num_prop_samples = 16', 'Model.num_nerf_samples = 16',
              'Config.sample_noise_size = 0'])
  model = construct.construct_model(config, gin, dev)
  batch = rays_lib.Batch(rays=_rays(100, dev),
                         rgb=torch.rand(100, 3, generator=torch.Generator()
                                        .manual_seed(0)).to(dev))
  state = step_lib.create_train_state(config, model)
  train = step_lib.make_train_step(model, config)
  before = dict(fused_mlp.launches)
  loss, _, grads = train.loss_and_grads(state, batch)
  for k in ('K2', 'K3', 'K4', 'K5'):
    assert fused_mlp.launches[k] == before[k] + 2, k
  model.nerf_mlp.cfg.fused_trunk = 'off'
  loss_off, _, grads_off = train.loss_and_grads(state, batch)
  assert abs(loss.item() - loss_off.item()) <= 1e-4 * abs(loss_off.item())
  for k in grads:
    _assert_close([grads[k]], [grads_off[k]], 'float32', k, n_values=0)


SPATIAL = ['NerfMLP.fuse_ipe_trig = True', 'NerfMLP.fuse_compositing = True',
           'NerfMLP.fuse_lift = True']


@pytest.mark.cuda
def test_model_with_all_fusions_matches_plain_path(dev):
  # The flagship with the six fuse flags at 16 samples per level, f32: a
  # served request (K1, K6, K7 once per level) and one step's loss and
  # gradients (K3 and K4 with K6 and K7 once each per level) against
  # fused_trunk='off'.
  config, gin = configs.parse(
      [GIN], ['Model.num_prop_samples = 16', 'Model.num_nerf_samples = 16',
              'Config.sample_noise_size = 0'] + FUSE + SPATIAL)
  model = construct.construct_model(config, gin, dev)
  rays = _rays(100, dev)
  before = dict(fused_mlp.launches)
  with torch.no_grad():
    out = renderer.render_rays(model, rays, 128)
  for k in ('K1', 'K6', 'K7'):
    assert fused_mlp.launches[k] == before[k] + 2, k
  batch = rays_lib.Batch(rays=rays, rgb=torch.rand(100, 3, generator=torch
                                                   .Generator().manual_seed(0)).to(dev))
  state = step_lib.create_train_state(config, model)
  train = step_lib.make_train_step(model, config)
  before = dict(fused_mlp.launches)
  loss, _, grads = train.loss_and_grads(state, batch)
  for k in ('K3', 'K4'):
    assert fused_mlp.launches[k] == before[k] + 2, k
  for k in ('K6', 'K7'):
    assert fused_mlp.launches[k] == before[k] + 4, k
  model.nerf_mlp.cfg.fused_trunk = 'off'
  with torch.no_grad():
    plain = renderer.render_rays(model, rays, 128)
  loss_off, _, grads_off = train.loss_and_grads(state, batch)
  for k in out:
    err = (out[k] - plain[k]).abs().max().item()
    assert err <= BOUND['float32'], (k, err)
  assert abs(loss.item() - loss_off.item()) <= 1e-4 * abs(loss_off.item())
  for k in grads:
    _assert_close([grads[k]], [grads_off[k]], 'float32', k, n_values=0)


# mip-NeRF (configs/blender_mipnerf.gin): K11, the spatial trunk with its
# features y out and their cotangent in (Model.use_viewdirs = False), and
# the 128-wide directional trunk on [bottleneck 128 | positional encoding
# 33] (K2, K5), as shipped.
MIP_GIN = os.path.join(os.path.dirname(GIN), 'blender_mipnerf.gin')


def _flat(r):
  return [t for x in r for t in (x if isinstance(x, (list, tuple)) else [x])
          if t is not None]


@pytest.mark.cuda
@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
def test_k11_matches_plain(dev, cdt):
  # Forward: y (compute dtype) by relative L2 (Y_BOUND, below what a
  # dropped last bias reads, checked too) and sigma as a value. Backward
  # (slabs of 256 rows), given random cotangents of sigma and y: every
  # parameter gradient as a derivative.
  n = 1000
  segs, ws, bs, kw = _case('K11', dev, n, seed=8)
  segs = [s.to(fused_mlp.DTYPES[cdt]) for s in segs]
  pack = fused_mlp.pack_trunk(ws, bs, (48, 48), compute_dtype=cdt, **kw)
  gen = torch.Generator().manual_seed(9)
  cots = (torch.randn(n, generator=gen).to(dev), None, None, None)
  ybar = torch.randn(n, 256, generator=gen).to(dev).to(fused_mlp.DTYPES[cdt])
  with torch.no_grad():
    got = fused_mlp.trunk_kernel(segs, pack, out_y=True)
    want = fused_mlp.trunk_reference(segs, ws, bs, compute_dtype=cdt,
                                     out_y=True, **kw)
    gb = fused_mlp.trunk_backward_kernel(segs, pack, cots, slab=256,
                                         ybar=ybar)
    wb = fused_mlp.trunk_backward_reference(segs, ws, bs, cots,
                                            compute_dtype=cdt, ybar=ybar, **kw)
  torch.cuda.synchronize()
  assert got[0].dtype == fused_mlp.DTYPES[cdt] and got[0].shape == (n, 256)
  l2 = lambda a: ((a.float() - want[0].float()).norm()
                  / want[0].float().norm()).item()
  assert l2(got[0]) <= Y_BOUND[cdt], (l2(got[0]), Y_BOUND[cdt])
  nobias = fused_mlp.trunk_reference(segs, ws, bs[:-1] + [bs[-1] * 0],
                                     compute_dtype=cdt, out_y=True, **kw)[0]
  assert l2(nobias) > Y_BOUND[cdt]
  _assert_close(got[1:], want[1:], cdt, 'K11')
  _assert_close(_flat(gb), _flat(wb), cdt, 'K11 backward', n_values=0)


@pytest.mark.cuda
@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
def test_width_128_matches_plain(dev, cdt):
  # K2 at width 128: the raw rgb as a value; K5 (slabs of 256 rows), given a
  # random cotangent of it: every parameter gradient and both segments'
  # cotangents as derivatives.
  n = 1000
  segs, ws, bs, kw = _case('mip K2', dev, n, seed=8)
  segs = [s.to(fused_mlp.DTYPES[cdt]) for s in segs]
  pack = fused_mlp.pack_trunk(ws, bs, (128, 33), compute_dtype=cdt, **kw)
  assert pack.kin == 192
  hbar = torch.randn(n, 3, generator=torch.Generator().manual_seed(10)).to(dev)
  cots = (None, hbar, None, None)
  with torch.no_grad():
    got = fused_mlp.trunk_kernel(segs, pack)
    want = fused_mlp.trunk_reference(segs, ws, bs, compute_dtype=cdt, **kw)
    gb = fused_mlp.trunk_backward_kernel(segs, pack, cots, needs_dx=True,
                                         slab=256)
    wb = fused_mlp.trunk_backward_reference(segs, ws, bs, cots,
                                            compute_dtype=cdt, needs_dx=True,
                                            **kw)
  torch.cuda.synchronize()
  _assert_close(got, want, cdt, 'K2 W128')
  _assert_close(_flat(gb), _flat(wb), cdt, 'K5 W128', n_values=0)


@pytest.mark.cuda
@pytest.mark.parametrize('viewdirs', [True, False])
def test_mipnerf_kernels_match_plain_path(dev, viewdirs):
  # The gin at full width and 16 samples per level, f32, as shipped (K1, K2;
  # K4, K5 at width 128) and without view directions (K1 and K4 with K11):
  # a served request and one step's loss and gradients against
  # fused_trunk='off', each kernel once per level.
  config, gin = configs.parse(
      [MIP_GIN], ['Model.num_prop_samples = 16', 'Model.num_nerf_samples = 16',
                  'Config.sample_noise_size = 0']
      + ([] if viewdirs else ['Model.use_viewdirs = False']))
  model = construct.construct_model(config, gin, dev)
  rays = _rays(100, dev)
  before = dict(fused_mlp.launches)
  with torch.no_grad():
    out = renderer.render_rays(model, rays, 128)
  for k in ('K1', 'K2') if viewdirs else ('K1', 'K11'):
    assert fused_mlp.launches[k] == before[k] + 2, k
  batch = rays_lib.Batch(rays=rays, rgb=torch.rand(100, 3, generator=torch
                                                   .Generator().manual_seed(0)).to(dev))
  state = step_lib.create_train_state(config, model)
  train = step_lib.make_train_step(model, config)
  before = dict(fused_mlp.launches)
  loss, _, grads = train.loss_and_grads(state, batch)
  for k in ('K1', 'K4') + (('K2', 'K5') if viewdirs else ()):
    assert fused_mlp.launches[k] == before[k] + 2, k
  if not viewdirs:
    assert fused_mlp.launches['K11'] == before['K11'] + 4
  model.nerf_mlp.cfg.fused_trunk = 'off'
  with torch.no_grad():
    plain = renderer.render_rays(model, rays, 128)
  loss_off, _, grads_off = train.loss_and_grads(state, batch)
  for k in out:
    err = (out[k] - plain[k]).abs().max().item()
    assert err <= BOUND['float32'], (k, err)
  assert abs(loss.item() - loss_off.item()) <= 1e-4 * abs(loss_off.item())
  for k in grads:
    _assert_close([grads[k]], [grads_off[k]], 'float32', k, n_values=0)
