"""The CUDA trunk kernels against their plain versions, on the card.

Every test here but one needs an NVIDIA GPU (marker `cuda`) and skips
elsewhere:
K1-K5, K6 and K7 (the fused spatial stages), K8-K10 (the fused
directional stages) and mip-NeRF's K11 (the trunk's features out) and
128-wide directional trunk, in both directions; the bf16 width-256
backward's weight-gradient product and its determinism, and its shapes
past the wgmma/TMA kernels (trunk_bwd.cu's instances); the bf16 width-256
forward on wgmma/TMA (trunk_fwd_tma.cu) in every mode it runs, its
determinism, and its shapes past it (trunk_fwd.cu's instances); the f32
width-256 backward on FMA products fed by TMA (trunk_bwd_f32.cu) in every
mode, its determinism, its weight-gradient product and its shapes past it
(trunk_bwd.cu's f32 instances); the f32 wide-input instances of both
FMA/TMA libraries on mip-NeRF 360's 504-column proposal trunk (depth 4 and
8) and their shared-memory sums; mip-NeRF's width-128 forward and backward
on the two-tile instances of the wgmma/TMA and FMA/TMA libraries and the
bf16 K11 forward on trunk_fwd_tma.cu, their determinism and their shapes
past them (trunk_fwd.cu's and trunk_bwd.cu's width-128 instances);
mip-NeRF with the spatial fuse flags; mip-NeRF 360's width-1024
spatial trunk (trunk_w1024.cu) in both directions and its slabbed
backward's determinism; its depth-1 directional trunk (trunk_dir1.cu) in
both directions and dtypes, its determinism and its refusal of a
misaligned segment; the
plain layer stack and the shapes without an instance under
fused_trunk='auto'; the host data path (the ray cast on the card against the
CPU's, the flagship trained from prefetched batches, sampled on the step's
thread and on a sampler thread, against the same batches copied
synchronously, the eval metrics on the card against the CPU's); a kill and
resume of the flagship through NeRFSystem, bit for bit; the mesh tools'
density grid and vertex colours through K1 against the plain spatial stage,
and a model exported to a refnerf-pl checkpoint and imported again serving
bit for bit; the flagship served from a weight-embedded artifact
(serving.py) against the in-process kernels (bit for bit) and
fused_trunk='off', its launches counted; the flagship trained on two
ranks sharing the card over gloo against one process (phase 22's bounds,
the ranks bit-identical, each rank's launches); Model.remat bit for bit,
every forward launch run once more a step. Two tests
need no card and run everywhere: the data pipeline and the metrics, asked
for CUDA where torch.cuda.is_available() reads false, refuse to start. This
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
from refnerf_tpu_torch.models import mlp as mlp_lib
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


def _case(which, dev, n=1000, seed=0, width=None, depth=8, skip=4,
          seg_dims=None):
  """The trunk TRUNKS[which] (`depth` layers, skip at skip + 1; `width` and
  `seg_dims` override its own). n = 1000 rows is not a multiple of the
  kernel's 64-row tile. The (48, 48) segments are the IPE encoding of
  random lifted means and variances, the others uniform in [-1, 1]."""
  gen = torch.Generator().manual_seed(seed)
  rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
  dims, w0, hf, hc, density = TRUNKS[which]
  seg_dims = seg_dims or dims
  width = width or w0
  fin = sum(seg_dims)
  skips = fused_mlp.skip_input_layers(depth, skip)
  ws = [rand(width, fin if l == 0 else width + (fin if l in skips else 0))
        for l in range(depth)]
  ws = [w * math.sqrt(2 / w.shape[1]) for w in ws]
  bs = [rand(width) * 0.05 for _ in range(depth)]
  head = lambda k: (rand(k, width) / math.sqrt(width), rand(k) * 0.1)
  kw = dict(skip_period=skip,
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
  # A width without an instance raises under 'on' and runs the plain
  # versions under 'auto', as 'off' does.
  segs, ws, bs, kw = _case('K2', dev, n=8, width=64)
  kw.pop('wd'), kw.pop('head_cdt')
  with torch.no_grad(), pytest.raises(NotImplementedError, match='width 64'):
    fused_mlp.fused_trunk(segs, ws, bs, mode='on', **kw)
  with torch.no_grad():
    assert torch.equal(fused_mlp.fused_trunk(segs, ws, bs, **kw),
                       fused_mlp.fused_trunk(segs, ws, bs, mode='off', **kw))
  # Width 128 runs the plain directional trunk alone; under 'on' the rest
  # raises.
  segs, ws, bs, kw = _case('K1', dev, n=8, width=128)
  kw.pop('head_cdt')
  with torch.no_grad(), pytest.raises(NotImplementedError,
                                      match='width-128.*density head'):
    fused_mlp.fused_encoded_trunk(
        torch.zeros(8, 3, device=dev), torch.full((8, 3), 1e-4, device=dev),
        SCALES, ws, bs, mode='on', **kw)


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
  # Forward (bf16 on trunk_fwd_tma.cu, whose y leaves the activation tiles
  # by TMA; f32 on trunk_fwd.cu): y (compute dtype) by relative L2
  # (Y_BOUND, below what a dropped last bias reads, checked too) and sigma
  # as a value. Backward (slabs of 256 rows), given random cotangents of
  # sigma and y: every parameter gradient as a derivative.
  n = 1000
  segs, ws, bs, kw = _case('K11', dev, n, seed=8)
  segs = [s.to(fused_mlp.DTYPES[cdt]) for s in segs]
  pack = fused_mlp.pack_trunk(ws, bs, (48, 48), compute_dtype=cdt, **kw)
  assert fused_mlp.forward_library(pack, out_y=True) == (
      'trunk_fwd_tma' if cdt == 'bfloat16' else 'trunk_fwd')
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
  # K2 at width 128 on the two-tile instances of trunk_fwd_tma.cu (bf16)
  # and trunk_fwd_f32.cu (f32), N = 1000 so that the last 128-sample CTA
  # holds 104 live rows: the raw rgb as a value; K5 (slabs of 256 rows, so
  # the last slab's second 128-sample CTA holds 104 live rows), given a
  # random cotangent of it, on the two-tile instances of trunk_bwd_tma.cu
  # (bf16) and trunk_bwd_f32.cu (f32): every parameter gradient and both
  # segments' cotangents as derivatives.
  n = 1000
  segs, ws, bs, kw = _case('mip K2', dev, n, seed=8)
  segs = [s.to(fused_mlp.DTYPES[cdt]) for s in segs]
  pack = fused_mlp.pack_trunk(ws, bs, (128, 33), compute_dtype=cdt, **kw)
  assert pack.kin == 192
  assert fused_mlp.forward_library(pack) == (
      'trunk_fwd_tma' if cdt == 'bfloat16' else 'trunk_fwd_f32')
  assert fused_mlp.backward_library(pack) == (
      'trunk_bwd_tma' if cdt == 'bfloat16' else 'trunk_bwd_f32')
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
@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
def test_width_128_backward_is_deterministic(dev, cdt):
  # H4: K5 at width 128 adds each CTA's two tiles in a fixed order and sums
  # its partials with no float atomics: two runs on the same inputs (two
  # slabs, several splits) give bit-identical gradients.
  n = 4500
  segs, ws, bs, kw = _case('mip K2', dev, n, seed=26)
  segs = [s.to(fused_mlp.DTYPES[cdt]) for s in segs]
  pack = fused_mlp.pack_trunk(ws, bs, (128, 33), compute_dtype=cdt, **kw)
  cots = (None, torch.randn(n, 3, generator=torch.Generator().manual_seed(27))
          .to(dev), None, None)
  run = lambda: _flat(fused_mlp.trunk_backward_kernel(segs, pack, cots,
                                                      needs_dx=True,
                                                      slab=4096))
  with torch.no_grad():
    a, b = run(), run()
  assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['K2 W128 float32', 'K2 W128 bfloat16',
                                  'K11 bfloat16'])
def test_two_tile_and_y_forwards_are_deterministic(dev, case):
  # The width-128 forwards (two tiles a CTA) sum each head over one
  # quad or two column warps in a fixed order, and K11's y leaves by TMA:
  # two runs on the same inputs give bit-identical outputs.
  which, cdt = case.rsplit(' ', 1)
  n = 4500
  if which == 'K11':
    segs, ws, bs, kw = _case('K11', dev, n, seed=30)
    dims = (48, 48)
  else:
    segs, ws, bs, kw = _case('mip K2', dev, n, seed=30)
    dims = (128, 33)
  segs = [s.to(fused_mlp.DTYPES[cdt]) for s in segs]
  pack = fused_mlp.pack_trunk(ws, bs, dims, compute_dtype=cdt, **kw)
  out_y = which == 'K11'
  assert fused_mlp.forward_library(pack, out_y) == (
      'trunk_fwd_tma' if cdt == 'bfloat16' else 'trunk_fwd_f32')
  with torch.no_grad():
    a = fused_mlp.trunk_kernel(segs, pack, out_y=out_y)
    b = fused_mlp.trunk_kernel(segs, pack, out_y=out_y)
  assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['float32 depth 10', 'float32 kin 288',
                                  'bfloat16 depth 10', 'bfloat16 kin 288'])
def test_width_128_forward_past_the_new_shapes_matches_plain(dev, case):
  # A width-128 trunk deeper than 8 layers or wider than 256 input columns
  # runs trunk_fwd.cu's width-128 instance forward; under
  # fused_trunk='auto' it launches it, it does not go plain.
  cdt, what, size = case.split()
  n = 1000
  shape = (dict(depth=10, skip=5) if what == 'depth'
           else dict(seg_dims=(128, int(size) - 128)))
  segs, ws, bs, kw = _case('mip K2', dev, n, seed=31, **shape)
  segs = [s.to(fused_mlp.DTYPES[cdt]) for s in segs]
  pack = fused_mlp.pack_trunk(ws, bs, [s.shape[-1] for s in segs],
                              compute_dtype=cdt, **kw)
  assert fused_mlp.forward_library(pack) == 'trunk_fwd'
  assert fused_mlp.missing_instance(pack, 0) is None
  with torch.no_grad():
    got = fused_mlp.trunk_kernel(segs, pack)
    want = fused_mlp.trunk_reference(segs, ws, bs, compute_dtype=cdt, **kw)
  torch.cuda.synchronize()
  _assert_close(got, want, cdt, case)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['float32 depth 10', 'float32 kin 224',
                                  'bfloat16 depth 10', 'bfloat16 kin 288'])
def test_width_128_past_the_new_shapes_matches_plain(dev, case):
  # A width-128 trunk deeper than 8 layers, wider than 256 input columns,
  # or in f32 wider than trunk_bwd_f32.cu's shared memory holds (224), runs
  # trunk_bwd.cu's width-128 instance; under fused_trunk='auto' it launches
  # it, it does not go plain.
  cdt, what, size = case.split()
  n = 1000
  shape = (dict(depth=10, skip=5) if what == 'depth'
           else dict(seg_dims=(128, int(size) - 128)))
  segs, ws, bs, kw = _case('mip K2', dev, n, seed=28, **shape)
  segs = [s.to(fused_mlp.DTYPES[cdt]) for s in segs]
  pack = fused_mlp.pack_trunk(ws, bs, [s.shape[-1] for s in segs],
                              compute_dtype=cdt, **kw)
  assert fused_mlp.backward_library(pack) == 'trunk_bwd'
  assert fused_mlp.missing_instance(pack, 0) is None
  cots = (None, torch.randn(n, 3, generator=torch.Generator().manual_seed(29))
          .to(dev), None, None)
  with torch.no_grad():
    got = fused_mlp.trunk_backward_kernel(segs, pack, cots, needs_dx=True,
                                          slab=512)
    want = fused_mlp.trunk_backward_reference(segs, ws, bs, cots,
                                              compute_dtype=cdt,
                                              needs_dx=True, **kw)
  torch.cuda.synchronize()
  _assert_close(_flat(got), _flat(want), cdt, case, n_values=0)


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


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['M256 N256', 'M256 N96 two', 'M256 N352 two',
                                  'M128 N256'])
def test_wgrad_tma_matches_matmul(dev, case):
  # The bf16 weight-gradient product (wgmma, operands sample-major) against
  # f32 matmul of the same bf16 operands over 4096 samples in two splits:
  # the f32 sums differ in order only, 1e-5 relative L2.
  from refnerf_tpu_torch.ops import cuda_build
  M, N, ncut, two = {'M256 N256': (256, 256, 256, False),
                     'M256 N96 two': (256, 96, 0, True),
                     'M256 N352 two': (256, 352, 256, True),
                     'M128 N256': (128, 256, 256, False)}[case]
  gen = torch.Generator().manual_seed(11)
  rp, ks = 4096, fused_mlp._KSPLIT_TMA
  bf = lambda *s: torch.randn(*s, generator=gen).to(dev, torch.bfloat16)
  z, a, x = bf(rp, M), bf(rp, max(ncut, 1)), bf(rp, max(N - ncut, 1))
  s, pa, tx = (bf(rp, M), bf(rp, max(ncut, 1)), bf(rp, max(N - ncut, 1))) \
      if two else (None, None, None)
  out = torch.empty(rp // ks, M, N, device=dev)
  ptr = lambda t: None if t is None else t.data_ptr()
  err = cuda_build.library('trunk_bwd_tma').refnerf_wgrad_tma(
      1, M, N, ncut, rp, ks, ptr(z), ptr(a), ptr(x), ptr(s), ptr(pa), ptr(tx),
      out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
  torch.cuda.synchronize()
  assert err == 0
  cat = lambda u, v: torch.cat(([u[:, :ncut]] if ncut else [])
                               + ([v[:, :N - ncut]] if ncut < N else []), 1)
  want = z.float().t() @ cat(a, x).float()
  if two:
    want += s.float().t() @ cat(pa, tx).float()
  got = out.sum(0)
  assert ((got - want).norm() / want.norm()).item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize('which', ['K4', 'K5'])
def test_bf16_backward_is_deterministic(dev, which):
  # H4: the bf16 width-256 backward (wgmma, TMA) sums its partials in a
  # fixed order, with no float atomics: two runs on the same inputs (two
  # slabs, several splits) give bit-identical gradients.
  n = 4500
  segs, ws, bs, kw = _case('K1' if which == 'K4' else 'K2', dev, n, seed=12)
  segs = [s.to(torch.bfloat16) for s in segs]
  pack = fused_mlp.pack_trunk(ws, bs, [s.shape[1] for s in segs],
                              compute_dtype='bfloat16', **kw)
  cots = _cotangents('K1' if which == 'K4' else 'K2', dev, n)
  fold = (torch.as_tensor(fused_mlp.ipe_scale_fold(SCALES, 3), device=dev)
          if which == 'K4' else None)
  run = lambda: _flat(fused_mlp.trunk_backward_kernel(
      segs, pack, cots, fold, needs_dx=which == 'K5', slab=4096))
  with torch.no_grad():
    a, b = run(), run()
  assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['K4 depth 10', 'K5 depth 10',
                                  'K5 kin 320'])
def test_bf16_backward_past_the_tma_shapes_matches_plain(dev, case):
  # A bf16 width-256 trunk deeper than 8 layers or wider than 256 input
  # columns runs trunk_bwd.cu's bf16 instances (fused_mlp.tma_backward);
  # under fused_trunk='auto' it launches them, it does not go plain.
  which = 'K1' if case.startswith('K4') else 'K2'
  n = 1000
  shape = (dict(depth=10, skip=5) if 'depth' in case
           else dict(seg_dims=(128, 161)))
  segs, ws, bs, kw = _case(which, dev, n=n, seed=13, **shape)
  segs = [s.to(torch.bfloat16) for s in segs]
  cots = _cotangents(which, dev, n)
  fold = (torch.as_tensor(fused_mlp.ipe_scale_fold(SCALES, 3), device=dev)
          if which == 'K1' else None)
  pack = fused_mlp.pack_trunk(ws, bs, [s.shape[-1] for s in segs],
                              compute_dtype='bfloat16', **kw)
  assert not fused_mlp.tma_backward(pack)
  assert fused_mlp.missing_instance(pack, 128 if which == 'K1' else 0) is None
  with torch.no_grad():
    got = fused_mlp.trunk_backward_kernel(segs, pack, cots, fold,
                                          which == 'K2', slab=512)
    want = fused_mlp.trunk_backward_reference(
        segs, ws, bs, cots, compute_dtype='bfloat16', fold=fold,
        needs_dx=which == 'K2', **kw)
  torch.cuda.synchronize()
  _assert_close(_flat(got), _flat(want), 'bfloat16', case, n_values=0)


@pytest.mark.cuda
@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
def test_mipnerf_spatial_fusions_match_plain(dev, cdt):
  # mip-NeRF's spatial trunk (hf = 0, the bottleneck head) with K6 and K7:
  # the served forward (sigma and the bottleneck as values, the weights by
  # WEIGHT_BOUND and two faults of the scan above it) and the first-order
  # K4 with K6/K7 (slabs of 512 rows, whole rays; every parameter gradient
  # and d bsig as derivatives).
  n, samples = 1536, 128
  _, ws, bs, kw = _case('K11', dev, n=8)
  gen = torch.Generator().manual_seed(13)
  kw['head_cdt'] = (torch.randn(128, 256, generator=gen).to(dev) / 16,
                    torch.randn(128, generator=gen).to(dev) * 0.1)
  rand = lambda *s: torch.rand(*s, generator=gen).to(dev)
  lm, lv = rand(n, 3) * 3 - 1.5, 10.0**(rand(n, 3) * 4 - 6)
  comp = (rand(n) * 0.08 + 0.01, torch.tensor([0.5], device=dev))
  sp = fused_mlp.SpaModes(tuple(float(s) for s in SCALES), samples)
  pack = fused_mlp.pack_trunk(ws, bs, (48, 48), compute_dtype=cdt, **kw)
  with torch.no_grad():
    got = fused_mlp.trunk_kernel([lm, lv], pack, spa_modes=sp, comp=comp)
    want = fused_mlp.trunk_reference([lm, lv], ws, bs, compute_dtype=cdt,
                                     spa_modes=sp, comp=comp, **kw)
  torch.cuda.synchronize()
  assert len(got) == len(want) == 3
  _assert_close(got[:2], want[:2], cdt, 'mip K6+K7')
  _assert_weights(got[2], want[2], want[0], comp, samples, cdt, 'mip K6+K7')
  cots = (rand(n) - 0.5, None, rand(n, 128) - 0.5, None, rand(n) - 0.5)
  with torch.no_grad():
    gb = fused_mlp.trunk_backward_kernel(
        [lm, lv], pack, cots, slab=512, spa_modes=sp, comp=comp + (got[0],))
    wb = fused_mlp.trunk_backward_reference(
        [lm, lv], ws, bs, cots, compute_dtype=cdt, spa_modes=sp,
        comp=comp + (want[0],), **kw)
  torch.cuda.synchronize()
  _assert_close(_flat(gb), _flat(wb), cdt, 'mip K6+K7+K4', n_values=0)


@pytest.mark.cuda
def test_mipnerf_with_spatial_fusions_matches_plain_path(dev):
  # configs/blender_mipnerf.gin with fuse_ipe_trig, fuse_compositing and
  # fuse_lift at 16 samples per level, f32: a served request (K1 with K6
  # and K7 once per level) and one step's loss and gradients (first-order
  # K4 with K6 and K7) against fused_trunk='off'.
  config, gin = configs.parse(
      [MIP_GIN], ['Model.num_prop_samples = 16', 'Model.num_nerf_samples = 16',
                  'Config.sample_noise_size = 0'] + SPATIAL)
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
  assert fused_mlp.launches['K4'] == before['K4'] + 2
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


TINY = ['NerfMLP.net_depth = 2', 'NerfMLP.net_width = 16',
        'NerfMLP.net_depth_viewdirs = 1', 'NerfMLP.net_width_viewdirs = 16',
        'NerfMLP.bottleneck_width = 8', 'NerfMLP.max_deg_point = 4',
        'NerfMLP.deg_view = 2', 'Model.num_prop_samples = 8',
        'Model.num_nerf_samples = 8']


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['tiny', 'elu'])
def test_plain_paths_under_auto_match_off(dev, case, caplog):
  # Under fused_trunk='auto' on the card: the verify skill's tiny gin (width
  # 16, no kernel instance) runs the plain versions, and an ELU trunk the
  # plain layer stack; each logs once and serves and trains as 'off' does
  # (the same operations on the same device).
  import logging
  extra = ["NerfMLP.net_activation = 'elu'"] if case == 'elu' else []
  config, gin = configs.parse([GIN], TINY + extra + [
      'Config.sample_noise_size = 0'])
  model = construct.construct_model(config, gin, dev)
  rays = _rays(50, dev)
  batch = rays_lib.Batch(rays=rays, rgb=torch.rand(50, 3, generator=torch
                                                   .Generator().manual_seed(0)).to(dev))
  state = step_lib.create_train_state(config, model)
  train = step_lib.make_train_step(model, config)
  before = dict(fused_mlp.launches)
  with caplog.at_level(logging.WARNING):
    with torch.no_grad():
      out = renderer.render_rays(model, rays, 128)
    loss, _, grads = train.loss_and_grads(state, batch)
  assert fused_mlp.launches == before
  # Logged here, or once already by an earlier test of this process.
  if case == 'elu':
    assert any('non-relu' in r.getMessage() for r in caplog.records) or (
        'non-relu' in str(mlp_lib._FALLBACK_WARNED))
  else:
    assert any('no kernel instance' in r.getMessage()
               for r in caplog.records) or (
        'width 16' in str(fused_mlp._NO_INSTANCE_LOGGED))
  model.nerf_mlp.cfg.fused_trunk = 'off'
  with torch.no_grad():
    plain = renderer.render_rays(model, rays, 128)
  loss_off, _, grads_off = train.loss_and_grads(state, batch)
  for k in out:
    assert torch.equal(out[k], plain[k]), k
  assert loss.item() == loss_off.item()
  for k in grads:
    assert torch.equal(grads[k], grads_off[k]), k


# The bf16 width-256 forward on wgmma and TMA (csrc/trunk_fwd_tma.cu, chosen
# by fused_mlp.tma_forward): the flagship's spatial trunk with and without
# its f32 heads, the bottleneck and the density gradient (K1, K3), with K7
# and K6 (rays of 128 samples: two tiles a CTA), its directional trunk alone
# and with K8-K10, and K3 at 256 input columns (4 basis vectors x 32
# scales, F = 128: both warpgroups hold u_x; with K7 the f32 fold tile spans
# the activation and input tiles).
TMA_FWD_CASES = ('K1', 'K1 hf=0', 'K2', 'K3', 'K3 hc=0', 'K3 F128',
                 'K7+K3 F128', 'K6+K7', 'K6+K7+K3', 'K8+K9+K10')
SCALES32 = 2.0**(np.arange(32) % 16)


def _tma_fwd_case(dev, case):
  return _fwd_case(dev, case, 'bfloat16')


def _fwd_case(dev, case, cdt):
  """(kernel, plain, pack, n_values, weights): the forward of `case` in
  `cdt` through trunk_kernel and trunk_reference; outputs before n_values
  are values, the one at `weights` (or None) K6's weights, the rest u."""
  bf = fused_mlp.DTYPES[cdt]
  gen = torch.Generator().manual_seed(14)
  rand = lambda *s: torch.rand(*s, generator=gen).to(dev)
  if case in DIR_CASES:
    segs, ws, bs, head, dm, rgbx = _dir_case(dev, case)
    segs = [s if dm.ide_deg and 1 <= j < 1 + dm.n_raw() else s.to(bf)
            for j, s in enumerate(segs)]
    pack = fused_mlp.pack_trunk(ws, bs, fused_mlp.visible_dims(segs, dm),
                                head_f32=head, compute_dtype=cdt)
    kw = dict(dir_modes=dm, rgbx=rgbx)
    return (lambda: fused_mlp.trunk_kernel(segs, pack, **kw),
            lambda: fused_mlp.trunk_reference(segs, ws, bs, head_f32=head,
                                              compute_dtype=cdt, **kw),
            pack, 1 + (rgbx is not None), None)
  if case == 'K2':
    segs, ws, bs, kw = _case('K2', dev, seed=15)
    segs = [s.to(bf) for s in segs]
    pack = fused_mlp.pack_trunk(ws, bs, (128, 73), compute_dtype=cdt, **kw)
    return (lambda: fused_mlp.trunk_kernel(segs, pack),
            lambda: fused_mlp.trunk_reference(
                segs, ws, bs, compute_dtype=cdt, **kw), pack, 1, None)
  wide = 'F128' in case
  nb, scales = (4, SCALES32) if wide else (3, SCALES)
  samples = 128 if 'K6' in case else 0
  n = 1536 if samples else 1000
  _, ws, bs, kw = _case('K1', dev, n=8, seed=16,
                        seg_dims=(128, 128) if wide else None)
  if case == 'K1 hf=0':
    kw['head_f32'] = None
  if case == 'K3 hc=0':
    kw['head_cdt'] = None
  lm, lv = rand(n, nb) * 3 - 1.5, 10.0**(rand(n, nb) * 4 - 6)
  enc = 'K7' in case
  sp = fused_mlp.SpaModes(tuple(float(s) for s in scales) if enc else (),
                          samples)
  comp = ((rand(n) * 0.08 + 0.01, torch.tensor([0.5], device=dev))
          if samples else None)
  segs = [lm, lv] if enc else [s.to(bf) for s in
                               fused_mlp.encode_ipe(lm, lv, scales)]
  dg = 'K3' in case
  fold = (torch.as_tensor(fused_mlp.ipe_scale_fold(scales, nb), device=dev)
          if dg else None)
  f = nb * len(scales)
  pack = fused_mlp.pack_trunk(ws, bs, (f, f), compute_dtype=cdt, **kw)
  kws = dict(spa_modes=sp, comp=comp)
  nv = 1 + (kw['head_f32'] is not None) + (kw['head_cdt'] is not None)
  return (lambda: fused_mlp.trunk_kernel(segs, pack, fold, **kws),
          lambda: fused_mlp.trunk_reference(
              segs, ws, bs, compute_dtype=cdt, density_grad=dg,
              fold=fold, **kws, **kw),
          pack, nv, nv + dg if samples else None)


@pytest.mark.cuda
@pytest.mark.parametrize('case', TMA_FWD_CASES)
def test_tma_forward_matches_plain(dev, case):
  # Values (sigma, the heads, the bottleneck, rgb) by BOUND, u by GRAD_BOUND,
  # K6's weights by WEIGHT_BOUND; each case routes to trunk_fwd_tma.cu.
  kernel, plain, pack, nv, weights = _tma_fwd_case(dev, case)
  assert fused_mlp.tma_forward(pack)
  with torch.no_grad():
    got, want = kernel(), plain()
  torch.cuda.synchronize()
  if weights is not None:
    err = (got[weights] - want[weights]).abs().max().item()
    assert err <= WEIGHT_BOUND['bfloat16'], (case, err)
    got, want = got[:weights], want[:weights]
  _assert_close(got, want, 'bfloat16', case, n_values=nv)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['K6+K7+K3', 'K8+K9+K10'])
def test_tma_forward_is_deterministic(dev, case):
  # The forward sums in a fixed order (no atomics): two runs on the same
  # inputs give bit-identical outputs.
  kernel = _tma_fwd_case(dev, case)[0]
  with torch.no_grad():
    a, b = kernel(), kernel()
  assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['K1 depth 10', 'K3 depth 10',
                                  'K2 kin 288'])
def test_bf16_forward_past_the_tma_shapes_matches_plain(dev, case):
  # A bf16 width-256 trunk deeper than 8 layers or wider than 256 input
  # columns runs trunk_fwd.cu's bf16 instances (fused_mlp.tma_forward);
  # under fused_trunk='auto' it launches them, it does not go plain.
  which = 'K2' if case.startswith('K2') else 'K1'
  shape = (dict(depth=10, skip=5) if 'depth' in case
           else dict(seg_dims=(128, 160)))
  segs, ws, bs, kw = _case(which, dev, seed=17, **shape)
  segs = [s.to(torch.bfloat16) for s in segs]
  fold = (torch.as_tensor(fused_mlp.ipe_scale_fold(SCALES, 3), device=dev)
          if case.startswith('K3') else None)
  pack = fused_mlp.pack_trunk(ws, bs, [s.shape[-1] for s in segs],
                              compute_dtype='bfloat16', **kw)
  assert not fused_mlp.tma_forward(pack)
  assert fused_mlp.missing_instance(pack, 128 if which == 'K1' else 0) is None
  with torch.no_grad():
    got = fused_mlp.trunk_kernel(segs, pack, fold)
    want = fused_mlp.trunk_reference(segs, ws, bs, compute_dtype='bfloat16',
                                     density_grad=fold is not None,
                                     fold=fold, **kw)
  torch.cuda.synchronize()
  _assert_close(got, want, 'bfloat16', case,
                n_values=len(got) - (fold is not None))


# The f32 width-256 backward on register-blocked FMA products fed by TMA
# (trunk_bwd_f32.cu), in every mode it runs: K4 with the cotangent of u,
# first-order K4, K4 with K6/K7, K4 with K11's y cotangent, K5 with dx and
# K5 with K8-K10.
F32_BWD_CASES = ('K4', 'K4 first-order', 'K6+K7+K4', 'K11', 'K5',
                 'K8+K9+K10')


def _f32_backward(dev, case, n=1000, slab=256, seed=0, **shape):
  """(pack, kernel backward, plain backward) of an f32 case on n rows in
  slabs of `slab` (whole rays with K6); `shape` overrides _case's."""
  gen = torch.Generator().manual_seed(seed + 1)
  rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
  fold = torch.as_tensor(fused_mlp.ipe_scale_fold(SCALES, 3), device=dev)
  if case in ('K5', 'K5 kin 288', 'K8+K9+K10'):
    if case == 'K8+K9+K10':
      segs, ws, bs, head, dm, rgbx = _dir_case(dev, case, n, seed)
      kw = dict(head_f32=head)
    else:
      segs, ws, bs, kw = _case('K2', dev, n, seed, **shape)
      dm, rgbx = fused_mlp.DirModes(), None
    pack = fused_mlp.pack_trunk(ws, bs, fused_mlp.visible_dims(segs, dm),
                                compute_dtype='float32', **kw)
    cots = (None, rand(n, 3), None, None)
    mode = dict(needs_dx=True, dir_modes=dm, rgbx=rgbx,
                rgb_bar=rand(n, 3) if rgbx else None)
    return pack, (
        lambda: fused_mlp.trunk_backward_kernel(segs, pack, cots, slab=slab,
                                                **mode),
        lambda: fused_mlp.trunk_backward_reference(
            segs, ws, bs, cots, compute_dtype='float32', **mode, **kw))
  if case == 'K6+K7+K4':
    _, ws, bs, kw = _case('K1', dev, n=8, seed=seed)
    u = lambda *s: torch.rand(*s, generator=gen).to(dev)
    segs = [u(n, 3) * 3 - 1.5, 10.0**(u(n, 3) * 4 - 6)]
    comp = (u(n) * 0.08 + 0.01, torch.tensor([0.5], device=dev))
    sp = fused_mlp.SpaModes(tuple(float(s) for s in SCALES), 128)
    pack = fused_mlp.pack_trunk(ws, bs, (48, 48), compute_dtype='float32',
                                **kw)
    cots = _cotangents('K1', dev, n) + (rand(n),)
    with torch.no_grad():
      sk = fused_mlp.trunk_kernel(segs, pack, fold, spa_modes=sp,
                                  comp=comp)[0]
      sr = fused_mlp.trunk_reference(segs, ws, bs, fold=fold, spa_modes=sp,
                                     comp=comp, **kw)[0]
    return pack, (
        lambda: fused_mlp.trunk_backward_kernel(
            segs, pack, cots, fold, slab=slab, spa_modes=sp,
            comp=comp + (sk,)),
        lambda: fused_mlp.trunk_backward_reference(
            segs, ws, bs, cots, fold=fold, spa_modes=sp, comp=comp + (sr,),
            **kw))
  segs, ws, bs, kw = _case('K11' if case == 'K11' else 'K1', dev, n, seed,
                           **shape)
  pack = fused_mlp.pack_trunk(ws, bs, [s.shape[-1] for s in segs],
                              compute_dtype='float32', **kw)
  cots, f, ybar = _cotangents('K1', dev, n), fold, None
  if case != 'K4' and not case.startswith('K4 depth'):
    cots, f = cots[:3] + (None,), None
  if case == 'K11':
    cots, ybar = (cots[0], None, None, None), rand(n, 256)
  return pack, (
      lambda: fused_mlp.trunk_backward_kernel(segs, pack, cots, f, slab=slab,
                                              ybar=ybar),
      lambda: fused_mlp.trunk_backward_reference(
          segs, ws, bs, cots, fold=f, ybar=ybar, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize('case', F32_BWD_CASES)
def test_f32_backward_matches_plain(dev, case):
  # Every parameter gradient, the segments' and raw inputs' cotangents, d
  # raw diffuse / tint and d bsig by relative L2 (GRAD_BOUND, float32); n
  # = 1000 rows (1536 with K6's 128-sample rays) in slabs of 256 (512), so
  # the slab accumulation and a ragged last tile run too.
  n, slab = (1536, 512) if case == 'K6+K7+K4' else (1000, 256)
  pack, (kernel, plain) = _f32_backward(dev, case, n, slab)
  assert fused_mlp.backward_library(pack) == 'trunk_bwd_f32'
  with torch.no_grad():
    got, want = _flat(kernel()), _flat(plain())
  torch.cuda.synchronize()
  _assert_close(got, want, 'float32', case, n_values=0)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['K4', 'K5'])
def test_f32_backward_is_deterministic(dev, case):
  # H4: trunk_bwd_f32.cu sums its partials in a fixed order, with no float
  # atomics: two runs on the same inputs (two slabs, several splits) give
  # bit-identical gradients.
  _, (kernel, _) = _f32_backward(dev, case, n=4500, slab=4096, seed=23)
  with torch.no_grad():
    a, b = _flat(kernel()), _flat(kernel())
  assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['K4 depth 10', 'K5 kin 288'])
def test_f32_backward_past_the_tma_shapes_matches_plain(dev, case):
  # An f32 width-256 trunk deeper than 8 layers or wider than 256 input
  # columns runs trunk_bwd.cu's f32 instances (fused_mlp.backward_library);
  # under fused_trunk='auto' it launches them, it does not go plain.
  shape = (dict(depth=10, skip=5) if 'depth' in case
           else dict(seg_dims=(128, 160)))
  pack, (kernel, plain) = _f32_backward(dev, case, n=1000, slab=512,
                                        seed=25, **shape)
  assert fused_mlp.backward_library(pack) == 'trunk_bwd'
  assert fused_mlp.missing_instance(pack, 128 if 'K4' in case else 0) is None
  with torch.no_grad():
    got, want = _flat(kernel()), _flat(plain())
  torch.cuda.synchronize()
  _assert_close(got, want, 'float32', case, n_values=0)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['M256 N96 two', 'M256 N352 two',
                                  'M128 N256'])
def test_wgrad_f32_matches_matmul(dev, case):
  # The f32 weight-gradient product (FMA, operands sample-major by TMA)
  # against f32 matmul over 4096 samples in three splits (the last one
  # short): the sums differ in order only, 1e-5 relative L2.
  from refnerf_tpu_torch.ops import cuda_build
  M, N, ncut, two = {'M256 N96 two': (256, 96, 0, True),
                     'M256 N352 two': (256, 352, 256, True),
                     'M128 N256': (128, 256, 256, False)}[case]
  gen = torch.Generator().manual_seed(27)
  rp, ks = 4096, 1536
  f = lambda *s: torch.randn(*s, generator=gen).to(dev)
  z, a, x = f(rp, M), f(rp, max(ncut, 1)), f(rp, max(N - ncut, 1))
  s, pa, tx = (f(rp, M), f(rp, max(ncut, 1)), f(rp, max(N - ncut, 1))) \
      if two else (None, None, None)
  out = torch.empty(-(-rp // ks), M, N, device=dev)
  ptr = lambda t: None if t is None else t.data_ptr()
  err = cuda_build.library('trunk_bwd_f32').refnerf_wgrad_f32(
      0, M, N, ncut, rp, ks, ptr(z), ptr(a), ptr(x), ptr(s), ptr(pa), ptr(tx),
      out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
  torch.cuda.synchronize()
  assert err == 0
  cat = lambda u, v: torch.cat(([u[:, :ncut]] if ncut else [])
                               + ([v[:, :N - ncut]] if ncut < N else []), 1)
  want = z.t() @ cat(a, x)
  if two:
    want += s.t() @ cat(pa, tx)
  got = out.sum(0)
  assert ((got - want).norm() / want.norm()).item() <= 1e-5


# The f32 width-256 forward on register-blocked FMA products fed by TMA
# (csrc/trunk_fwd_f32.cu, chosen by fused_mlp.forward_library), in every
# mode it runs: the flagship's spatial trunk with and without its f32 heads
# and bottleneck (K1, K1 hf=0 as mip-NeRF's, K3, K3 hc=0), with K7 and K6
# (rays of 128 samples: two tiles a CTA), and its directional trunk (K2)
# alone and with K8, K8+K9, K10 and all three.
F32_FWD_CASES = ('K1', 'K1 hf=0', 'K3', 'K3 hc=0', 'K7', 'K6+K7', 'K6+K7+K3',
                 'K2', 'K8', 'K8+K9', 'K10', 'K8+K9+K10')


@pytest.mark.cuda
@pytest.mark.parametrize('case', F32_FWD_CASES)
def test_f32_forward_matches_plain(dev, case):
  # Values (sigma, the heads, the bottleneck, rgb) by BOUND, u by GRAD_BOUND,
  # K6's weights by WEIGHT_BOUND, all float32; each case routes to
  # trunk_fwd_f32.cu.
  kernel, plain, pack, nv, weights = _fwd_case(dev, case, 'float32')
  assert fused_mlp.forward_library(pack) == 'trunk_fwd_f32'
  with torch.no_grad():
    got, want = kernel(), plain()
  torch.cuda.synchronize()
  if weights is not None:
    err = (got[weights] - want[weights]).abs().max().item()
    assert err <= WEIGHT_BOUND['float32'], (case, err)
    got, want = got[:weights], want[:weights]
  _assert_close(got, want, 'float32', case, n_values=nv)


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['K1', 'K6+K7+K3', 'K8+K9+K10'])
def test_f32_forward_is_deterministic(dev, case):
  # The heads sum in a fixed order (no atomics): two runs on the same inputs
  # give bit-identical outputs.
  kernel = _fwd_case(dev, case, 'float32')[0]
  with torch.no_grad():
    a, b = kernel(), kernel()
  assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize('case', ['K1 depth 10', 'K3 depth 10',
                                  'K2 kin 288'])
def test_f32_forward_past_its_shapes_matches_plain(dev, case):
  # An f32 width-256 trunk deeper than 8 layers or wider than 256 input
  # columns runs trunk_fwd.cu's f32 instances (fused_mlp.forward_library);
  # under fused_trunk='auto' it launches them, it does not go plain.
  which = 'K2' if case.startswith('K2') else 'K1'
  shape = (dict(depth=10, skip=5) if 'depth' in case
           else dict(seg_dims=(128, 160)))
  segs, ws, bs, kw = _case(which, dev, seed=18, **shape)
  fold = (torch.as_tensor(fused_mlp.ipe_scale_fold(SCALES, 3), device=dev)
          if case.startswith('K3') else None)
  pack = fused_mlp.pack_trunk(ws, bs, [s.shape[-1] for s in segs],
                              compute_dtype='float32', **kw)
  assert fused_mlp.forward_library(pack, fold=fold) == 'trunk_fwd'
  assert fused_mlp.missing_instance(pack, 128 if which == 'K1' else 0,
                                    fold) is None
  with torch.no_grad():
    got = fused_mlp.trunk_kernel(segs, pack, fold)
    want = fused_mlp.trunk_reference(segs, ws, bs,
                                     density_grad=fold is not None, fold=fold,
                                     **kw)
  torch.cuda.synchronize()
  _assert_close(got, want, 'float32', case,
                n_values=len(got) - (fold is not None))


def _k3_trunk(dev, F, n=1000, seed=19):
  """The flagship's spatial trunk (f32) on 2F input columns of the IPE of
  4 basis vectors, with the density gradient's fold: (segs, ws, bs, kw,
  fold, pack)."""
  scales = 2.0**(np.arange(F // 4) % 16)
  gen = torch.Generator().manual_seed(seed)
  rand = lambda *s: torch.rand(*s, generator=gen).to(dev)
  _, ws, bs, kw = _case('K1', dev, n=8, seed=seed, seg_dims=(F, F))
  segs = list(fused_mlp.encode_ipe(rand(n, 4) * 3 - 1.5,
                                   10.0**(rand(n, 4) * 4 - 6), scales))
  fold = torch.as_tensor(fused_mlp.ipe_scale_fold(scales, 4), device=dev)
  pack = fused_mlp.pack_trunk(ws, bs, (F, F), compute_dtype='float32', **kw)
  return segs, ws, bs, kw, fold, pack


def _prop_case(dev, depth, n=1000, seed=40, cdt='float32', fin=504, deg=12):
  """mip-NeRF 360's proposal trunk: the IPE of 21 basis vectors x 12
  degrees (two segments of 252 columns, kin 512 packed) of random lifted
  means and variances, width 256, the density head alone; depth 4, or 8
  with the skip at layer 5. `fin`: fin / (2 deg) basis vectors in place of
  21 (264: kin 288; 1008: kin 1024), on `deg` degrees (13 at fin 546: two
  segments of 273, not a multiple of 4 columns). Returns (segs, ws, bs,
  kw, pack)."""
  gen = torch.Generator().manual_seed(seed)
  rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
  nb = fin // (2 * deg)
  lm = torch.rand(n, nb, generator=gen).to(dev) * 3 - 1.5
  lv = 10.0**(torch.rand(n, nb, generator=gen).to(dev) * 4 - 6)
  segs = list(fused_mlp.encode_ipe(lm, lv, 2.0**np.arange(deg), cdt))
  skips = fused_mlp.skip_input_layers(depth, 4)
  ws = [rand(256, fin if l == 0 else 256 + (fin if l in skips else 0))
        for l in range(depth)]
  ws = [w * math.sqrt(2 / w.shape[1]) for w in ws]
  bs = [rand(256) * 0.05 for _ in range(depth)]
  kw = dict(skip_period=4, wd=rand(1, 256) / 16, head_f32=None,
            head_cdt=None)
  pack = fused_mlp.pack_trunk(ws, bs, (fin // 2, fin // 2), compute_dtype=cdt,
                              **kw)
  return segs, ws, bs, kw, pack


@pytest.mark.cuda
@pytest.mark.parametrize('cdt,fin,depth', [
    ('float32', 504, 4), ('float32', 504, 8), ('bfloat16', 504, 4),
    ('bfloat16', 504, 8), ('bfloat16', 264, 4), ('bfloat16', 264, 8),
    ('bfloat16', 1008, 4), ('bfloat16', 1008, 8), ('bfloat16', 546, 4),
    ('bfloat16', 546, 8)])
def test_wide_input_f32_trunk_matches_plain(dev, cdt, fin, depth):
  # The wide-input instances (f32: trunk_fwd_f32.cu `fwd_f32_wide`,
  # trunk_bwd_f32.cu `bwd_f32_wide`; bf16: trunk_fwd_tma.cu `fwd_wide`,
  # trunk_bwd_tma.cu's WIDE instance) on mip-NeRF 360's proposal trunk
  # (504 columns; in bf16 also 264, 1008, and 546 on 13 degrees: segments
  # of 273 columns, which wide_chunk fills by 2-byte loads, a 4-column
  # piece straddling the segments), 1000 rows (not a multiple of 128):
  # sigma by BOUND; given a random cotangent of sigma, every weight and
  # bias gradient by GRAD_BOUND (slabs of 256 rows: the slab accumulation
  # runs too); each counted under 'K1 wide' / 'K4 wide'; reruns
  # bit-identical.
  deg = 13 if fin == 546 else 12
  segs, ws, bs, kw, pack = _prop_case(dev, depth, cdt=cdt, fin=fin, deg=deg)
  assert fused_mlp.wide_input(pack) and pack.kin == -(-fin // 32) * 32
  assert fused_mlp.forward_library(pack) == fused_mlp.FWD_LIBRARY[cdt]
  assert fused_mlp.backward_library(pack) == fused_mlp.BWD_LIBRARY[cdt]
  assert fused_mlp.missing_instance(pack, 0) is None
  sbar = torch.randn(1000, generator=torch.Generator().manual_seed(41)).to(dev)
  cots = (sbar, None, None, None)
  with torch.no_grad():
    got = fused_mlp.trunk_kernel(segs, pack)
    again = fused_mlp.trunk_kernel(segs, pack)
    want = fused_mlp.trunk_reference(segs, ws, bs, compute_dtype=cdt, **kw)
    gb = _flat(fused_mlp.trunk_backward_kernel(segs, pack, cots, slab=256))
    gb2 = _flat(fused_mlp.trunk_backward_kernel(segs, pack, cots, slab=256))
    wb = _flat(fused_mlp.trunk_backward_reference(segs, ws, bs, cots,
                                                  compute_dtype=cdt, **kw))
  torch.cuda.synchronize()
  what = f'wide {cdt} {fin} depth {depth}'
  _assert_close(got, want, cdt, f'{what} fwd')
  _assert_close(gb, wb, cdt, f'{what} bwd', n_values=0)
  assert all(torch.equal(a, b) for a, b in zip(got, again))
  assert all(torch.equal(a, b) for a, b in zip(gb, gb2))
  # Counted through the autograd Function, as the model launches them.
  before = dict(fused_mlp.launches)
  lm = torch.rand(64, fin // (2 * deg), device=dev)
  w = [t.clone().requires_grad_() for t in ws]
  sig, = fused_mlp.fused_encoded_trunk(lm, lm * 1e-3, 2.0**np.arange(deg), w,
                                       bs, kw['wd'], compute_dtype=cdt,
                                       mode='on')
  sig.sum().backward()
  torch.cuda.synchronize()
  moved = {k: v - before[k] for k, v in fused_mlp.launches.items()}
  assert moved['K1'] == moved['K1 wide'] == moved['K4'] == 1
  assert moved['K4 wide'] == 1


# (library, trunk): launches at the edge of each library's shared memory,
# as fused_mlp.kernel_smem counts it: trunk_bwd.cu's f32 K5 at 288 input
# columns (exactly the 232,448 B limit) and at 320 (past it, F5); K3 at 192
# and 224 input columns on trunk_fwd_f32.cu (two ring stages, and none) and
# on trunk_fwd.cu (past the limit at 224); mip-NeRF's width-128 K5 on
# trunk_bwd_f32.cu's two-tile instance at 192 input columns (five ring
# stages) and at 224 (past the limit); its width-128 K2 on
# trunk_fwd_f32.cu's two-tile instance at 192 input columns (seven ring
# stages) and at 256, the widest its input tile takes (two: its shallowest
# ring); mip-NeRF 360's proposal trunk on the wide-input instances at 512
# input columns (the forward's seven stages; the backward's seven at depth
# 4, six at 8), and in bf16 on trunk_fwd_tma.cu's (three stages and the
# density head's weights) and trunk_bwd_tma.cu's (depth 4 and 8).
SMEM_CASES = ('trunk_bwd K5 kin 288', 'trunk_bwd K5 kin 320',
              'trunk_fwd_f32 K3 kin 192', 'trunk_fwd_f32 K3 kin 224',
              'trunk_fwd K3 kin 96', 'trunk_fwd K3 kin 224',
              'trunk_bwd_f32 K5W128 kin 192', 'trunk_bwd_f32 K5W128 kin 224',
              'trunk_fwd_f32 K2W128 kin 192', 'trunk_fwd_f32 K2W128 kin 256',
              'trunk_fwd_f32 K1wide kin 512', 'trunk_bwd_f32 K4wide4 kin 512',
              'trunk_bwd_f32 K4wide8 kin 512', 'trunk_fwd_tma K1wide kin 512',
              'trunk_bwd_tma K4wide4 kin 512', 'trunk_bwd_tma K4wide8 kin 512')


@pytest.mark.cuda
@pytest.mark.parametrize('case', SMEM_CASES)
def test_shared_memory_sums_match_the_launches(dev, monkeypatch, case):
  # Pins fused_mlp.kernel_smem to the C side: with the route forced and the
  # instance guard off, a launch is refused (cudaErrorInvalidConfiguration)
  # exactly when the mirrored sum passes SMEM_LIMIT; one that runs matches
  # its plain version.
  lib, which, _, kin = case.split()
  kin = int(kin)
  cdt = 'bfloat16' if lib.endswith('_tma') else 'float32'
  monkeypatch.setattr(fused_mlp, 'missing_instance', lambda *a, **k: None)
  if which in ('K5', 'K5W128'):
    segs, ws, bs, kw = _case('K2' if which == 'K5' else 'mip K2', dev,
                             seed=20, seg_dims=(128, kin - 128))
    pack = fused_mlp.pack_trunk(ws, bs, (128, kin - 128),
                                compute_dtype='float32', **kw)
    need = fused_mlp.kernel_smem(lib, pack, 0)
    monkeypatch.setattr(fused_mlp, 'backward_library', lambda *a, **k: lib)
    cots = (None, torch.randn(1000, 3, device=dev), None, None)
    run = lambda: _flat(fused_mlp.trunk_backward_kernel(segs, pack, cots,
                                                        needs_dx=True))
    plain = lambda: _flat(fused_mlp.trunk_backward_reference(
        segs, ws, bs, cots, needs_dx=True, **kw))
    nv = 0
  elif which.startswith('K4wide'):
    segs, ws, bs, kw, pack = _prop_case(dev, int(which[-1]), seed=42, cdt=cdt)
    need = fused_mlp.kernel_smem(lib, pack, 0)
    cots = (torch.randn(1000, device=dev), None, None, None)
    run = lambda: _flat(fused_mlp.trunk_backward_kernel(segs, pack, cots))
    plain = lambda: _flat(fused_mlp.trunk_backward_reference(
        segs, ws, bs, cots, compute_dtype=cdt, **kw))
    nv = 0
  elif which == 'K1wide':
    segs, ws, bs, kw, pack = _prop_case(dev, 4, seed=43, cdt=cdt)
    need = fused_mlp.kernel_smem(lib, pack, 0)
    run = lambda: fused_mlp.trunk_kernel(segs, pack)
    plain = lambda: fused_mlp.trunk_reference(segs, ws, bs, compute_dtype=cdt,
                                              **kw)
    nv = 1
  elif which == 'K2W128':
    segs, ws, bs, kw = _case('mip K2', dev, seed=20,
                             seg_dims=(128, kin - 128))
    pack = fused_mlp.pack_trunk(ws, bs, (128, kin - 128),
                                compute_dtype='float32', **kw)
    need = fused_mlp.kernel_smem(lib, pack, 0)
    monkeypatch.setattr(fused_mlp, 'forward_library', lambda *a: lib)
    run = lambda: fused_mlp.trunk_kernel(segs, pack)
    plain = lambda: fused_mlp.trunk_reference(segs, ws, bs, **kw)
    nv = 1
  else:
    segs, ws, bs, kw, fold, pack = _k3_trunk(dev, kin // 2)
    need = fused_mlp.kernel_smem(lib, pack, 128, fold)
    monkeypatch.setattr(fused_mlp, 'forward_library', lambda *a: lib)
    run = lambda: fused_mlp.trunk_kernel(segs, pack, fold)
    plain = lambda: fused_mlp.trunk_reference(segs, ws, bs, density_grad=True,
                                              fold=fold, **kw)
    nv = 3
  if kin == 288:
    assert need == fused_mlp.SMEM_LIMIT
  with torch.no_grad():
    if need > fused_mlp.SMEM_LIMIT:
      with pytest.raises(RuntimeError, match='cudaError 9'):
        run()
      return
    got, want = run(), plain()
  torch.cuda.synchronize()
  _assert_close(got, want, cdt, case, n_values=nv)


@pytest.mark.cuda
def test_f32_trunk_past_shared_memory_runs_plain_under_auto(dev):
  # F5: the f32 directional trunk on 320 input columns needs more shared
  # memory in trunk_bwd.cu than an H100 has; under fused_trunk='auto' it
  # runs the plain versions (missing_instance names it) and its outputs and
  # gradients match fused_trunk='off'; under 'on' it raises before any
  # launch.
  segs, ws, bs, kw = _case('K2', dev, seed=21, seg_dims=(128, 192))
  pack = fused_mlp.pack_trunk(ws, bs, (128, 192), compute_dtype='float32',
                              **kw)
  assert 'trunk_bwd.cu' in fused_mlp.missing_instance(pack, 0)
  gen = torch.Generator().manual_seed(22)
  cot = torch.randn(1000, 3, generator=gen).to(dev)
  leaves = [t.clone().requires_grad_() for t in segs + ws + bs]

  def run(mode):
    xs = [t.detach().clone().requires_grad_() for t in leaves]
    s, w, b = xs[:2], xs[2:2 + len(ws)], xs[2 + len(ws):]
    out = fused_mlp.fused_trunk(s, w, b, kw['head_f32'],
                                compute_dtype='float32', mode=mode)
    (out * cot).sum().backward()
    return [out.detach()] + [x.grad for x in xs]

  before = dict(fused_mlp.launches)
  got, want = run('auto'), run('off')
  assert fused_mlp.launches == before
  _assert_close(got, want, 'float32', 'kin 320', n_values=1)
  with pytest.raises(NotImplementedError, match='trunk_bwd.cu'):
    run('on')


# ------------------------------------------------------------------------
# The host data path: the cast on the card, the prefetch, the metrics.


def _cameras(n_cams=5, ndc=False):
  """A bank of n_cams 800 x 800 cameras of nerf_synthetic's focal length
  (neighbouring rays ~1e-3 apart, whose difference gives the radii) on a
  ring (or, for NDC, facing -z)."""
  from refnerf_tpu_torch.cameras import camera_utils
  pixtocams = np.stack([camera_utils.get_pixtocam(1111.0 + i, 800, 800)
                        for i in range(n_cams)])
  poses = []
  for i in range(n_cams):
    theta = 2 * np.pi * i / n_cams
    pos = (np.array([0.3 * i, 0.1, 4.0]) if ndc else
           np.array([4 * np.cos(theta), 4 * np.sin(theta), 0.5]))
    look = np.array([0.0, 0.05, 1.0]) if ndc else pos
    poses.append(camera_utils.viewmatrix(look, np.array([0.0, 0.0, 1.0]),
                                         pos))
  return pixtocams.astype(np.float32), np.stack(poses).astype(np.float32)


CAST_CASES = {
    'pinhole': (None, False, 'perspective'),
    'distorted_ndc': ({'k1': 0.05, 'k2': -0.02, 'k3': 0.01, 'p1': 0.003,
                       'p2': -0.002}, True, 'perspective'),
    'fisheye': ({'k1': 0.02, 'k2': 0.01, 'k3': -0.005, 'k4': 0.001}, False,
                'fisheye'),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(CAST_CASES))
def test_cast_on_the_card_matches_the_cpu(dev, case):
  # 3 x 3 patches, a camera each, as the train split's Pixels: max abs
  # error 1e-5 on origins, directions and viewdirs, relative 1e-5 on radii
  # (both f32, the same products and sums in the same order; a reduction in
  # another order moved the radii by ~1e-4 relative at this focal length).
  from refnerf_tpu_torch.cameras import camera_utils
  distortion, ndc, camtype = CAST_CASES[case]
  pixtocams, poses = _cameras(ndc=ndc)
  cameras = (pixtocams, poses, distortion, pixtocams[0] if ndc else None)
  rng = np.random.default_rng(30)
  n = 4096
  dx, dy = camera_utils.pixel_coordinates(3, 3)
  x = (rng.integers(0, 798, (n, 1, 1)) + dx).astype(np.int32)
  y = (rng.integers(0, 798, (n, 1, 1)) + dy).astype(np.int32)
  scalar = lambda v: torch.from_numpy(
      np.broadcast_to(v, x.shape)[..., None].copy())
  pixels = rays_lib.Pixels(
      torch.from_numpy(x), torch.from_numpy(y), scalar(np.float32(1)),
      scalar(np.float32(0.5)), scalar(np.float32(6)),
      scalar(rng.integers(0, 5, (n, 1, 1)).astype(np.int32)))
  ptype = camera_utils.ProjectionType(camtype)
  cpu = camera_utils.cast_ray_batch(cameras, pixels, ptype)
  gpu = camera_utils.cast_ray_batch(
      cameras, pixels.map(lambda t: t.to(dev)), ptype)
  for k in ('origins', 'directions', 'viewdirs'):
    err = (getattr(gpu, k).cpu() - getattr(cpu, k)).abs().max().item()
    assert err <= 1e-5, (k, err)
  # The fisheye's sin and cos are not correctly rounded on either device:
  # an ulp of a direction is ~1e-4 of a radius at this focal length.
  rel = ((gpu.radii.cpu() - cpu.radii).abs() / cpu.radii).max().item()
  assert rel <= (1e-3 if camtype == 'fisheye' else 1e-5), rel


def _scene_and_model(tmp_path, dev):
  from refnerf_tpu_torch.data import datasets
  from refnerf_tpu_torch.tools import sphere_scene
  root = sphere_scene.make_scene(str(tmp_path / 'scene'), 6, 1, 64)
  config, gin = configs.parse([GIN], [
      'Config.batch_size = 256', 'Config.randomized = False',
      'Config.sample_noise_size = 0', "NerfMLP.compute_dtype = 'bfloat16'",
      f"Config.data_dir = '{root}'"] + [
          f'NerfMLP.{f} = True' for f in (
              'fuse_dir_enc', 'fuse_dir_geo', 'fuse_dir_rgb', 'fuse_ipe_trig',
              'fuse_compositing', 'fuse_lift')])
  make_ds = lambda: datasets.load_dataset('train', root, config)
  return config, gin, make_ds


@pytest.mark.cuda
def test_prefetched_batches_train_as_synchronous_ones(dev, tmp_path):
  # The flagship (bf16, all six fuse flags, batch 256) trained 3 steps from
  # prefetched batches (pinned memory, a side stream), sampled on this
  # thread and on a sampler thread, and 3 steps from the same batches
  # copied synchronously: every batch tensor and every step's loss bit for
  # bit.
  from refnerf_tpu_torch.cameras import camera_utils
  from refnerf_tpu_torch.data import prefetch
  config, gin, make_ds = _scene_and_model(tmp_path, dev)
  losses = {}
  seen = {}
  for how in ('prefetched', 'sampler thread', 'synchronous'):
    ds = make_ds()
    model = construct.construct_model(config, gin, dev)
    cast = lambda cams, pix: camera_utils.cast_ray_batch(cams, pix,
                                                         ds.camtype)
    train = step_lib.make_train_step(model, config, cast)
    state = step_lib.create_train_state(config, model)
    cameras = ds.device_cameras(dev)
    if how != 'synchronous':
      batches = prefetch.training_batches(
          ds, device=dev, threaded=how == 'sampler thread')
    else:
      batches = (b.map(lambda t: t.to(dev)) for b in ds)
    losses[how], seen[how] = [], []
    for _ in range(3):
      batch = next(batches)
      assert isinstance(batch.rays, rays_lib.Pixels)
      tensors = []
      batch.map(lambda t: tensors.append(t.clone()) or t)
      seen[how].append(tensors)
      state, stats = train(state, batch, cameras)
      losses[how].append(stats['loss'].clone())
    batches.close()
  for how in ('prefetched', 'sampler thread'):
    for a, b in zip(seen[how], seen['synchronous']):
      assert all(torch.equal(x, y) for x, y in zip(a, b)), how
    for a, b in zip(losses[how], losses['synchronous']):
      assert torch.equal(a, b), (how, a.item(), b.item())


def test_training_batches_refuse_to_run_without_a_gpu(monkeypatch):
  # Asked for CUDA where there is none, the pipeline raises before it
  # starts its sampler thread (here torch.cuda.is_available() reads false,
  # on any machine).
  import threading
  from refnerf_tpu_torch.data import prefetch
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  before = threading.active_count()
  with pytest.raises(RuntimeError, match='no CUDA device'):
    prefetch.training_batches(iter([1, 2, 3]))
  with pytest.raises(RuntimeError, match='no CUDA device'):
    prefetch.training_batches(iter([1, 2, 3]), threaded=True)
  with pytest.raises(RuntimeError, match='no CUDA device'):
    prefetch.device_prefetch(iter([1]), device='cuda:0')
  assert threading.active_count() == before


def test_metrics_refuse_to_run_without_a_gpu(monkeypatch, tmp_path):
  # The metrics default to the card: without one they raise rather than
  # computing on the CPU (torch.cuda.is_available() reads false here).
  from refnerf_tpu_torch import metrics
  monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
  with pytest.raises(RuntimeError, match='no CUDA device'):
    metrics.MetricHarness()
  with pytest.raises(RuntimeError, match='no CUDA device'):
    metrics.VGGLPIPS(str(tmp_path / 'weights.npz'))
  harness = metrics.MetricHarness(device='cpu')
  assert harness.device == torch.device('cpu')


@pytest.mark.cuda
def test_metrics_on_the_card_match_the_cpu(dev):
  # PSNR, SSIM and the colour-corrected PSNR of an 800 x 800 image (f64
  # color_correct) on the card and on the CPU: within 1e-4 dB and 1e-5.
  from refnerf_tpu_torch import metrics
  rng = np.random.default_rng(31)
  gt = np.clip(rng.uniform(0, 1, (800, 800, 3)), 0, 1)
  pred = np.clip(gt**1.2 * 0.9 + rng.normal(0, 0.03, gt.shape), 0, 1)
  config = configs.Config()
  card = metrics.eval_metrics(metrics.MetricHarness(), torch.tensor(pred),
                              torch.tensor(gt), config)
  host = metrics.eval_metrics(metrics.MetricHarness(device='cpu'),
                              torch.tensor(pred), torch.tensor(gt), config)
  assert card[2].device.type == 'cuda'  # the harness's default device
  for j in (0, 1):
    assert abs(card[j]['psnr'] - host[j]['psnr']) <= 1e-4
    assert abs(card[j]['ssim'] - host[j]['ssim']) <= 1e-5
  assert (card[2].cpu() - host[2]).abs().max().item() <= 1e-9


@pytest.mark.cuda
def test_system_kill_and_resume_is_bit_for_bit(dev, tmp_path):
  # The shipped flagship gin (its own float32, no fuse flags) at batch 256
  # through NeRFSystem on the card: 8 steps against 4, a kill (an early
  # exit) and 4 more from the checkpoint. The kernels reduce the weight
  # gradients in a fixed order (H4) and the checkpoint keeps every dtype and
  # the integer Adam count, so every parameter and moment is equal.
  from refnerf_tpu_torch import system
  from refnerf_tpu_torch.tools import sphere_scene
  scene = sphere_scene.make_scene(str(tmp_path / 'scene'), 6, 1, 32)

  def trained(exp, *more):
    config, gin = configs.parse([GIN], [
        'Config.batch_size = 256', 'Config.max_steps = 8',
        'Config.checkpoint_every = 4', 'Config.val_sample_num = 1',
        f"Config.data_dir = '{scene}'",
        f"Config.checkpoint_dir = '{tmp_path / 'exp'}'",
        f"Config.exp_name = '{exp}'", *more])
    sys_obj = system.NeRFSystem(config, gin, device=dev)
    sys_obj.train()
    return sys_obj

  whole = trained('whole')
  assert trained('cut', 'Config.early_exit_steps = 4').state.step == 4
  resumed = trained('cut')
  assert whole.state.step == resumed.state.step == 8
  assert whole.state.opt.count == resumed.state.opt.count == 8
  for k, v in whole.model.state_dict().items():
    assert torch.equal(resumed.model.state_dict()[k], v), k
  for which in ('mu', 'nu'):
    for k, v in getattr(whole.state.opt, which).items():
      assert torch.equal(getattr(resumed.state.opt, which)[k], v), (which, k)


@pytest.mark.cuda
@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
def test_mesh_tools_through_k1_match_off(dev, cdt):
  # The flagship at full width: the density grid (K1 without the
  # bottleneck head) and vertex colours (K1 with it) in uneven chunks,
  # every chunk one K1 launch, against fused_trunk='off': the grid, the
  # diffuse head and the colours each by the L2 error over the plain
  # field's spread about its mean, within BOUND (random weights leave a
  # nearly flat field, whose own relative L2 would pass a constant).
  from refnerf_tpu_torch import geometry

  def spread_l2(got, want):
    got, want = (np.asarray(a, np.float64).reshape(len(a), -1)
                 for a in (got, want))
    return np.linalg.norm(got - want) / np.linalg.norm(want - want.mean(0))

  config, gin = configs.parse([GIN], [f"NerfMLP.compute_dtype = '{cdt}'",
                                      "NerfMLP.fused_trunk = 'on'"])
  model = construct.construct_model(config, gin, dev)
  box = ((-1.5,) * 3, (1.5,) * 3)
  verts = np.random.default_rng(0).uniform(-1.2, 1.2, (5000, 3)).astype(
      np.float32)
  diffuse = lambda: geometry.spatial_heads(
      model.nerf_mlp, torch.from_numpy(verts).to(dev), 0.05 ** 2 / 4,
      True)[1]['diffuse'].float().cpu().numpy()
  before = fused_mlp.launches['K1']
  grid = geometry.density_grid(model, 48, *box, chunk=40000)
  colors = geometry.vertex_colors(model, verts, 0.05, chunk=3000)
  assert fused_mlp.launches['K1'] - before == 3 + 2
  heads = diffuse()
  model.nerf_mlp.cfg.fused_trunk = 'off'
  plain = geometry.density_grid(model, 48, *box)
  plain_colors = geometry.vertex_colors(model, verts, 0.05)
  plain_heads = diffuse()
  assert fused_mlp.launches['K1'] - before == 6
  for got, want in ((grid, plain), (heads, plain_heads),
                    (colors, plain_colors)):
    assert spread_l2(got, want) <= BOUND[cdt], spread_l2(got, want)


@pytest.mark.cuda
def test_interop_round_trip_serves_bit_for_bit(dev, tmp_path):
  # The flagship exported to a refnerf-pl .ckpt and imported into a model
  # built from another seed serves a request equal to the original's.
  from refnerf_tpu_torch import interop
  from refnerf_tpu_torch.tools import export_torch_checkpoint
  from refnerf_tpu_torch.tools import import_torch_checkpoint

  def build(seed):
    config, gin = configs.parse([GIN], [f'Config.seed = {seed}',
                                        "NerfMLP.compute_dtype = 'bfloat16'"])
    return construct.construct_model(config, gin, dev), config

  model, config = build(0)
  other, _ = build(1)
  ckpt = str(tmp_path / 'model.ckpt')
  export_torch_checkpoint.export(model, 3, ckpt)
  sd, step = import_torch_checkpoint.load_lightning(ckpt)
  assert step == 3
  other.load_state_dict(interop.torch_state_dict_to_params(
      sd, other.state_dict(), other))
  rng = np.random.default_rng(1)
  d = torch.tensor(rng.normal(size=(4096, 3)).astype(np.float32), device=dev)
  rays = rays_lib.dummy_rays(4096, dev)
  rays.directions = d
  rays.viewdirs = d / d.norm(dim=-1, keepdim=True)
  rays.origins = torch.zeros_like(d)
  rays.near, rays.far = rays.near + 2, rays.far + 6
  rays.radii = rays.radii + 1e-3
  with torch.no_grad():
    a = renderer.render_rays(model, rays, 4096)
    b = renderer.render_rays(other, rays, 4096)
  assert torch.equal(a['rgb'], b['rgb'])


@pytest.mark.cuda
@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
def test_served_artifact_matches_off_and_counts_launches(dev, tmp_path, cdt):
  # The flagship with the six fuse flags exported under fused_trunk='on'
  # (refnerf_tpu_torch/serving.py) at chunk 1024: the loaded program holds
  # the trunk operator twice for each trunk, a request launches K1, K2 and
  # K6-K10 twice each, equals the in-process kernels bit for bit and the
  # in-process fused_trunk='off' render within chip_smoke.py's SERVE_BOUND
  # (rgb, acc and distance: the L2 error over the plain render's spread
  # about its mean across the rays, 2e-5 in f32 and 2e-4 in bf16).
  from refnerf_tpu_torch import serving
  six = [f'NerfMLP.{f} = True' for f in (
      'fuse_dir_enc', 'fuse_dir_geo', 'fuse_dir_rgb', 'fuse_ipe_trig',
      'fuse_compositing', 'fuse_lift')]
  config, gin = configs.parse([GIN], [f"NerfMLP.compute_dtype = '{cdt}'",
                                      "NerfMLP.fused_trunk = 'on'"] + six)
  model = construct.construct_model(config, gin, dev)
  n = 1024
  rng = np.random.default_rng(2)
  d = torch.tensor(rng.normal(size=(n, 3)).astype(np.float32), device=dev)
  rays = rays_lib.dummy_rays(n, dev)
  rays.directions, rays.viewdirs = d, d / d.norm(dim=-1, keepdim=True)
  rays.origins = torch.tensor(rng.normal(size=(n, 3)).astype(np.float32),
                              device=dev) * 0.1
  rays.near, rays.far = rays.near + 2, rays.far + 5
  rays.radii = rays.radii + 1e-3
  path = str(tmp_path / 'scene.rnsrv')
  meta = serving.export_serving(model, path, chunk=n, device=dev)
  assert meta['trunk_ops'] == {'K1': 2, 'K2': 2}
  served = serving.load_serving(path)
  lib = fused_mlp.FWD_LIBRARY[cdt]
  assert [r for _, _, r in fused_mlp.trunk_op_nodes(
      served.exported.graph)] == [lib] * 4
  for k in fused_mlp.launches:
    fused_mlp.launches[k] = 0
  got = served(rays)
  assert {k: v for k, v in fused_mlp.launches.items() if v} == {
      k: 2 for k in ('K1', 'K2', 'K6', 'K7', 'K8', 'K9', 'K10')}
  with torch.no_grad():
    kern = renderer.render_rays(model, rays, n)
    model.nerf_mlp.cfg.fused_trunk = 'off'
    plain = renderer.render_rays(model, rays, n)
  for k in ('rgb', 'acc', 'distance'):
    assert torch.equal(got[k], kern[k]), k
  bound = {'float32': 2e-5, 'bfloat16': 2e-4}[cdt]
  for k in ('rgb', 'acc', 'distance'):
    g, w = got[k].double(), plain[k].double()
    spread = ((g - w).norm() / (w - w.mean(0)).norm()).item()
    assert spread <= bound, (k, spread)


# The flagship with the six fuse flags in bf16 (phase 10's launches).
SIX = [f'NerfMLP.{f} = True' for f in (
    'fuse_dir_enc', 'fuse_dir_geo', 'fuse_dir_rgb', 'fuse_ipe_trig',
    'fuse_compositing', 'fuse_lift')]
SIX_PER_STEP = {'K2': 1, 'K3': 1, 'K4': 1, 'K5': 1, 'K6': 2, 'K7': 2,
                'K8': 2, 'K9': 2, 'K10': 2}


def _train_batch(n, dev, seed=0):
  rng = np.random.default_rng(seed)
  d = torch.tensor(rng.normal(size=(n, 3)).astype(np.float32), device=dev)
  rays = rays_lib.dummy_rays(n, dev)
  rays.directions, rays.viewdirs = d, d / d.norm(dim=-1, keepdim=True)
  rays.origins = torch.tensor(rng.normal(size=(n, 3)).astype(np.float32),
                              device=dev) * 0.1
  rays.near, rays.far = rays.near + 2, rays.far + 5
  rays.radii = rays.radii + 1e-3
  rays.lossmult = torch.tensor(rng.uniform(0.5, 2, (n, 1)).astype(np.float32),
                               device=dev)
  rgb = torch.tensor(rng.uniform(0, 1, (n, 3)).astype(np.float32), device=dev)
  return rays_lib.Batch(rays=rays, rgb=rgb)


@pytest.mark.cuda
def test_two_ranks_sharing_the_card_match_one_process(dev, tmp_path):
  # The flagship at full width (bf16, the six fuse flags) at a global batch
  # of 512: two ranks on this card over gloo (torchrun running
  # refnerf_tpu_torch/testing/data_parallel.py) against one process, two
  # steps from the same state and batch, within chip_smoke.py's phase-22
  # bounds: the loss 1e-5 relative, the reduced gradients 1e-4 relative
  # L2, the parameters 1e-2 of the largest move. The ranks stay
  # bit-identical, and each launches K2-K10 as phase 10 counts them.
  import json
  import socket
  import subprocess
  import sys
  from refnerf_tpu_torch.testing import data_parallel as dp
  bindings = ["NerfMLP.compute_dtype = 'bfloat16'", 'Config.batch_size = 512',
              *SIX]
  config, gin = configs.parse([GIN], bindings)
  model = construct.construct_model(config, gin, dev)
  state = step_lib.create_train_state(config, model)
  dp.save_state(str(tmp_path / 'state.pt'), state)
  dp.save_batch(str(tmp_path / 'batch.pt'),
                _train_batch(512, dev).map(lambda x: x.cpu()))
  run = dict(name='flagship', kind='steps', gin=GIN, bindings=bindings,
             state=str(tmp_path / 'state.pt'),
             batch=str(tmp_path / 'batch.pt'), steps=2,
             out=str(tmp_path / 'out'))
  with open(tmp_path / 'spec.json', 'w') as f:
    json.dump(dict(device='cuda:0', backend='gloo', runs=[run]), f)
  one = dp.run(dict(run, out=None), None, dev)
  with socket.socket() as s:
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
  root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  env = {k: v for k, v in os.environ.items()
         if k not in ('RANK', 'LOCAL_RANK', 'WORLD_SIZE', 'MASTER_ADDR',
                      'MASTER_PORT')}
  env['PYTHONPATH'] = root
  proc = subprocess.run(
      [sys.executable, '-m', 'torch.distributed.run', '--nproc_per_node=2',
       '--master_addr=127.0.0.1', f'--master_port={port}', '-m',
       'refnerf_tpu_torch.testing.data_parallel', str(tmp_path / 'spec.json')],
      cwd=root, env=env, capture_output=True, text=True, timeout=600)
  assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
  ranks = [torch.load(tmp_path / 'out' / f'flagship.rank{r}.pt',
                      weights_only=False) for r in (0, 1)]
  want = {k: 2 * v for k, v in SIX_PER_STEP.items()}
  for rank in ranks:
    for got in rank['launches']:
      assert {k: v for k, v in got.items() if v} == want
  for s in range(2):
    for k, p in ranks[0]['params'][s].items():
      assert torch.equal(p, ranks[1]['params'][s][k]), (s, k)
    loss, ref = float(ranks[0]['loss'][s]), float(one['loss'][s])
    assert abs(loss - ref) <= 1e-5 * abs(ref)
    num = sum(float((ranks[0]['grads'][s][k] - g).double().norm()**2)
              for k, g in one['grads'][s].items())
    den = sum(float(g.double().norm()**2) for g in one['grads'][s].values())
    assert (num / den)**0.5 <= 1e-4
    before = one['start'] if s == 0 else one['params'][s - 1]
    move = max(float((p - before[k]).abs().max())
               for k, p in one['params'][s].items())
    diff = max(float((ranks[0]['params'][s][k] - p).abs().max())
               for k, p in one['params'][s].items())
    assert diff <= 1e-2 * move


@pytest.mark.cuda
def test_remat_on_the_card_is_bit_for_bit_and_reruns_the_forwards(dev):
  # Model.remat on the flagship at full width (bf16, the six fuse flags),
  # batch 512, two steps: the step is the step without remat bit for bit
  # (the kernels' forwards are deterministic, H4), and every forward launch
  # of a step runs once more in its backward.
  batch = _train_batch(512, dev)
  runs = {}
  for remat in (False, True):
    config, gin = configs.parse([GIN], [
        "NerfMLP.compute_dtype = 'bfloat16'", 'Config.batch_size = 512',
        *SIX, f'Model.remat = {remat}'])
    model = construct.construct_model(config, gin, dev)
    assert model.remat == remat
    state = step_lib.create_train_state(config, model)
    train = step_lib.make_train_step(model, config)
    for k in fused_mlp.launches:
      fused_mlp.launches[k] = 0
    for _ in range(2):
      state, stats = train(state, batch)
    launches = dict(fused_mlp.launches)
    for k in fused_mlp.launches:
      fused_mlp.launches[k] = 0
    model(batch.rays, train=True)
    runs[remat] = (stats['loss'], launches, dict(fused_mlp.launches),
                   {k: p.detach().clone() for k, p in
                    model.named_parameters()})
  (l0, n0, fwd, p0), (l1, n1, _, p1) = runs[False], runs[True]
  assert torch.equal(l0, l1)
  for k, v in p0.items():
    assert torch.equal(v, p1[k]), k
  assert n0 == {k: 2 * 2 * SIX_PER_STEP.get(k, 0) for k in n0}
  assert n1 == {k: v + 2 * fwd[k] for k, v in n0.items()}
  assert fwd['K3'] == fwd['K2'] == 2


@pytest.mark.cuda
@pytest.mark.parametrize('n,cdt', [
    (n, cdt) for n in (1000, 4097, 534) for cdt in ('float32', 'bfloat16')] +
    [(n, 'bfloat16') for n in (1, 63, 65, 257)] +
    [(n, 'float32') for n in (257, 513)])
def test_w1024_trunk_matches_plain(dev, cdt, n):
  # mip-NeRF 360's NeRF MLP trunk (8 x 1024, the skip at layer 5, the IPE
  # of 21 basis vectors x 12 degrees: 504 columns, the density head and
  # the 256-wide bottleneck) through fused_encoded_trunk under 'on' at n
  # rows (1000; 4097, whose last 128-row tile holds one row; 534, whose
  # last slab of 150 rows splits its weight gradients otherwise than a full
  # slab of 384; in bf16 also 1, 63, 65 and 257, across the wgmma
  # products' 128-row tiles and 64-row slices; in f32 also 257 and 513, one
  # row past the TF32 products' 128-row tiles: at a few dozen rows one f32
  # relu' flip, which summation order decides, weighs a whole row's share
  # of each gradient and can pass GRAD_BOUND alone (H8, H25)), on
  # trunk_w1024.cu: sigma and the bottleneck by
  # BOUND and every gradient by GRAD_BOUND against the plain versions; one
  # launch each counted under 'K1 w1024' / 'K4 w1024'; a second run
  # bit-identical (H4); the backward in slabs of 384 rows bit-identical
  # run to run and within GRAD_BOUND of one slab.
  gen = torch.Generator().manual_seed(24)
  rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
  scales = 2.0**np.arange(0, 12)
  lm = torch.rand(n, 21, generator=gen).to(dev) * 3 - 1.5
  lv = 10.0**(torch.rand(n, 21, generator=gen).to(dev) * 4 - 6)
  skips = fused_mlp.skip_input_layers(8, 4)
  ks = [504 if l == 0 else 1024 + (504 if l in skips else 0) for l in range(8)]
  params = ([rand(1024, k) * math.sqrt(2 / k) for k in ks] +
            [rand(1024) * 0.05 for _ in range(8)] +
            [rand(1, 1024) / 32, rand(1) * 0.1, rand(256, 1024) / 32,
             rand(256) * 0.1])
  params = [p.requires_grad_(True) for p in params]
  ws, bs = params[:8], params[8:16]
  wd, bd, wc, bc = params[16:20]
  outs = {}
  weights = [rand(n), rand(n, 256)]
  for mode in ('on', 'off', 'on again'):
    mode, key = mode.split()[0], mode
    before = dict(fused_mlp.launches)
    res = fused_mlp.fused_encoded_trunk(
        lm, lv, scales, ws, bs, wd, bd, head_cdt=(wc, bc), compute_dtype=cdt,
        mode=mode)
    loss = sum((r.float() * w).sum() for r, w in zip(res, weights))
    grads = torch.autograd.grad(loss, params)
    moved = {k: v - before[k] for k, v in fused_mlp.launches.items() if
             v != before[k]}
    outs[key] = (res, grads, moved)
  (res, grads, moved), (pres, pgrads, pmoved) = outs['on'], outs['off']
  again = outs['on again']
  assert all(torch.equal(x, y) for x, y in zip(res, again[0]))
  assert all(torch.equal(x, y) for x, y in zip(grads, again[1]))
  assert moved == {'K1': 1, 'K1 w1024': 1, 'K4': 1, 'K4 w1024': 1}
  assert pmoved == {}
  for r, p in zip(res, pres):
    scale = max(1.0, p.float().abs().max().item())
    assert (r.float() - p.float()).abs().max().item() <= BOUND[cdt] * scale
  for g, p in zip(grads, pgrads):
    assert ((g - p).norm() / p.norm()).item() <= GRAD_BOUND[cdt]
  # The backward in slabs: run to run bit-identical, within GRAD_BOUND of
  # one slab.
  f = lm.shape[-1] * len(scales)
  pack = fused_mlp.pack_trunk(ws, bs, (f, f), wd=wd, head_cdt=(wc, bc),
                              compute_dtype=cdt)
  segs = list(fused_mlp.encode_ipe(lm, lv, scales, cdt))
  cots = (rand(n), None, rand(n, 256).to(fused_mlp.DTYPES[cdt]), None)
  with torch.no_grad():
    flat = lambda r: [t for x in r[:7] if x is not None
                      for t in (x if isinstance(x, list) else [x])]
    a = flat(fused_mlp.trunk_backward_kernel(segs, pack, cots, slab=384))
    b = flat(fused_mlp.trunk_backward_kernel(segs, pack, cots, slab=384))
    one = flat(fused_mlp.trunk_backward_kernel(segs, pack, cots))
  assert all(torch.equal(x, y) for x, y in zip(a, b))
  for x, y in zip(a, one):
    assert ((x - y).norm() / y.norm()).item() <= GRAD_BOUND[cdt]


def _dir1_case(dev, n, seed=24):
  """mip-NeRF 360's directional trunk on n rows: [bottleneck 256 in [-1, 1]
  | the positional encoding of degree 4 of random unit directions, 27], a
  He-scaled 128 x 283 layer, the rgb head; the parameters need grad."""
  from refnerf_tpu_torch.ops import coord
  gen = torch.Generator().manual_seed(seed)
  rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
  d = rand(n, 3)
  segs = [torch.rand(n, 256, generator=gen).to(dev) * 2 - 1,
          coord.pos_enc(d / d.norm(dim=-1, keepdim=True), 0, 4)]
  params = [rand(128, 283) * math.sqrt(2 / 283), rand(128) * 0.05,
            rand(3, 128) / 11.3, rand(3) * 0.1]
  return segs, [p.requires_grad_(True) for p in params], rand(n, 3)


@pytest.mark.cuda
@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
@pytest.mark.parametrize('n', [1, 63, 65, 257, 4097, 131072])
def test_dir1_trunk_matches_plain(dev, cdt, n):
  # mip-NeRF 360's directional trunk (1 x 128 on [256 | 27], the rgb head)
  # through fused_trunk under 'on' at n rows (across the 64-row bf16 and
  # 128-row f32 tiles, a partial last tile read by plain loads; 131,072 a
  # 4096-ray request's NeRF samples) on csrc/trunk_dir1.cu: rgb by BOUND,
  # every parameter gradient and both segments' cotangents by GRAD_BOUND
  # against 'off'; K2 and K5 each launched once; a second run bit-identical
  # (H4).
  segs, params, wbar = _dir1_case(dev, n)
  cs = [s.to(fused_mlp.DTYPES[cdt]).requires_grad_(True) for s in segs]
  w, b, wh, bh = params
  pack = fused_mlp.pack_trunk([w], [b], (256, 27), head_f32=(wh, bh),
                              compute_dtype=cdt)
  assert fused_mlp.forward_library(pack) == fused_mlp.DIR1_LIBRARY
  assert fused_mlp.backward_library(pack) == fused_mlp.DIR1_LIBRARY
  outs = {}
  for key in ('on', 'off', 'on again'):
    before = dict(fused_mlp.launches)
    rgb = fused_mlp.fused_trunk(cs, [w], [b], (wh, bh), compute_dtype=cdt,
                                mode=key.split()[0])
    grads = torch.autograd.grad((rgb * wbar).sum(), params + cs)
    moved = {k: v - before[k] for k, v in fused_mlp.launches.items()
             if v != before[k]}
    outs[key] = (rgb, grads, moved)
  (rgb, grads, moved), (prgb, pgrads, pmoved) = outs['on'], outs['off']
  assert moved == {'K2': 1, 'K5': 1} and pmoved == {}
  assert torch.equal(rgb, outs['on again'][0])
  assert all(torch.equal(x, y) for x, y in zip(grads, outs['on again'][1]))
  scale = max(1.0, prgb.abs().max().item())
  assert (rgb - prgb).abs().max().item() <= BOUND[cdt] * scale
  for i, (g, p) in enumerate(zip(grads, pgrads)):
    assert g.dtype == p.dtype and g.shape == p.shape, i
    err = ((g.float() - p.float()).norm() / p.float().norm()).item()
    assert err <= GRAD_BOUND[cdt], (i, err)


@pytest.mark.cuda
def test_dir1_refuses_a_misaligned_segment_on_the_card(dev):
  # The kernels read the segments in place (a TMA tensor map, bulk copies):
  # a 27-column segment whose base lies 2 bytes past a 16-byte boundary
  # raises, in both directions; it is not copied to hide it.
  segs, params, wbar = _dir1_case(dev, 640)
  w, b, wh, bh = params
  pack = fused_mlp.pack_trunk([w], [b], (256, 27), head_f32=(wh, bh),
                              compute_dtype='bfloat16')
  cs = [s.to(torch.bfloat16) for s in segs]
  buf = torch.zeros(cs[1].numel() + 8, dtype=torch.bfloat16, device=dev)
  cs[1] = buf[1:1 + cs[1].numel()].view(cs[1].shape).copy_(cs[1])
  assert cs[1].is_contiguous() and cs[1].data_ptr() % 16
  cots = (None, wbar, None, None)
  with pytest.raises(ValueError, match='second segment'):
    fused_mlp.trunk_kernel(cs, pack)
  with pytest.raises(ValueError, match='second segment'):
    fused_mlp.trunk_backward_kernel(cs, pack, cots, needs_dx=True)


def _defaults_case(dev, n, hc, seed=25):
  """The JAX package's default spatial trunk (testing/mlp_defaults.py): the
  IPE of random lifted means and variances on 21 basis vectors x 12
  degrees (two segments of 252 columns), 8 x 256 with the skip at layer 5,
  the density head and an hc-wide bottleneck; the scale fold; random
  cotangents of sigma, the bottleneck and u."""
  gen = torch.Generator().manual_seed(seed)
  rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
  lm = torch.rand(n, 21, generator=gen).to(dev) * 3 - 1.5
  lv = 10.0**(torch.rand(n, 21, generator=gen).to(dev) * 4 - 6)
  scales = tuple(float(2**d) for d in range(12))
  segs = list(fused_mlp.encode_ipe(lm, lv, scales))
  skips = fused_mlp.skip_input_layers(8, 4)
  ws = [rand(256, k) * math.sqrt(2 / k) for k in
        (504 if l == 0 else 256 + (504 if l in skips else 0)
         for l in range(8))]
  bs = [rand(256) * 0.05 for _ in range(8)]
  kw = dict(skip_period=4, wd=rand(1, 256) / 16,
            head_cdt=(rand(hc, 256) / 16, rand(hc) * 0.1))
  fold = torch.as_tensor(fused_mlp.ipe_scale_fold(scales, 21)).to(dev)
  return segs, ws, bs, kw, fold, (rand(n), rand(n, hc) * 0.1, rand(n, 21))


@pytest.mark.cuda
@pytest.mark.parametrize('hc', [256, 128])
@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
@pytest.mark.parametrize('n', [1, 63, 65, 257, 131072])
def test_defaults_wide_trunk_matches_plain(dev, n, cdt, hc):
  # The defaults' spatial trunk (8 x 256 on 504 columns, the density head,
  # a 256- or 128-wide bottleneck) on the wide-input instances at n rows
  # (across the 64-row tiles and the bf16 forward's two-tile units;
  # 131,072 a 4096-ray request's samples at two levels): K1 (sigma, the
  # bottleneck by BOUND), K3 (u by GRAD_BOUND), K4 first-order and with u's
  # cotangent (every gradient by GRAD_BOUND), each a second time
  # bit-identical (H4).
  segs, ws, bs, kw, fold, (sbar, cbar, ubar) = _defaults_case(dev, n, hc)
  cs = [s.to(fused_mlp.DTYPES[cdt]) for s in segs]
  pack = fused_mlp.pack_trunk(ws, bs, (252, 252), compute_dtype=cdt, **kw)
  for f in (None, fold):
    assert fused_mlp.wide_input(pack, fold=f)
    assert fused_mlp.forward_library(pack, fold=f) == (
        fused_mlp.WIDE_TF32_LIBRARY if fused_mlp.wide_tf32(pack, fold=f)
        else fused_mlp.FWD_LIBRARY[cdt])
    assert fused_mlp.backward_library(pack, fold=f) == (
        fused_mlp.BWD_LIBRARY[cdt])
  c1 = (sbar, None, cbar.to(fused_mlp.DTYPES[cdt]), None)
  c2 = c1[:3] + (ubar,)
  cases = (
      ('K1', 2, lambda: fused_mlp.trunk_kernel(cs, pack),
       lambda: fused_mlp.trunk_reference(cs, ws, bs, compute_dtype=cdt,
                                         **kw)),
      ('K3', 2, lambda: fused_mlp.trunk_kernel(cs, pack, fold),
       lambda: fused_mlp.trunk_reference(cs, ws, bs, compute_dtype=cdt,
                                         density_grad=True, fold=fold, **kw)),
      ('K4 first-order', 0,
       lambda: fused_mlp.trunk_backward_kernel(cs, pack, c1),
       lambda: fused_mlp.trunk_backward_reference(cs, ws, bs, c1,
                                                  compute_dtype=cdt, **kw)),
      ('K4 with ubar', 0,
       lambda: fused_mlp.trunk_backward_kernel(cs, pack, c2, fold),
       lambda: fused_mlp.trunk_backward_reference(
           cs, ws, bs, c2, compute_dtype=cdt, fold=fold, **kw)))
  for which, nv, kernel, plain in cases:
    with torch.no_grad():
      got, again, want = (_flat(f()) for f in (kernel, kernel, plain))
    torch.cuda.synchronize()
    _assert_close(got, want, cdt, f'{which} {cdt} hc {hc} n {n}',
                  n_values=nv)
    assert all(torch.equal(a, b) for a, b in zip(got, again)), which


@pytest.mark.cuda
@pytest.mark.parametrize('which', ['K3 f32', 'K4 bf16 ubar'])
@pytest.mark.parametrize('n', [1, 63, 64, 65, 128, 129, 257, 4097])
def test_redesigned_defaults_instances_match_plain(dev, n, which):
  # The two instances redesigned for the defaults' spatial trunk (8 x 256 on
  # 504 columns, the 256-wide bottleneck) at n rows, across the 64-row
  # tiles: f32 K3 on csrc/trunk_wide_tf32.cu (three TF32 passes of wgmma),
  # sigma and the bottleneck by BOUND, u by GRAD_BOUND; bf16
  # K4 with u's cotangent (the tangent read back at the skip layer), every
  # gradient by GRAD_BOUND; each a second time bit-identical (H4).
  cdt = 'bfloat16' if 'bf16' in which else 'float32'
  segs, ws, bs, kw, fold, (sbar, cbar, ubar) = _defaults_case(dev, n, 256)
  cs = [s.to(fused_mlp.DTYPES[cdt]) for s in segs]
  pack = fused_mlp.pack_trunk(ws, bs, (252, 252), compute_dtype=cdt, **kw)
  if which.startswith('K3'):
    assert fused_mlp.forward_library(pack, fold=fold) == (
        fused_mlp.WIDE_TF32_LIBRARY)
    nv = 2
    kernel = lambda: fused_mlp.trunk_kernel(cs, pack, fold)
    plain = lambda: fused_mlp.trunk_reference(
        cs, ws, bs, compute_dtype=cdt, density_grad=True, fold=fold, **kw)
  else:
    cots = (sbar, None, cbar.to(fused_mlp.DTYPES[cdt]), ubar)
    nv = 0
    kernel = lambda: fused_mlp.trunk_backward_kernel(cs, pack, cots, fold)
    plain = lambda: fused_mlp.trunk_backward_reference(
        cs, ws, bs, cots, compute_dtype=cdt, fold=fold, **kw)
  with torch.no_grad():
    got, again, want = (_flat(f()) for f in (kernel, kernel, plain))
  torch.cuda.synchronize()
  _assert_close(got, want, cdt, f'{which} n {n}', n_values=nv)
  assert all(torch.equal(a, b) for a, b in zip(got, again)), which
