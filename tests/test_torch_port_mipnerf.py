"""mip-NeRF through the port against the JAX package, on the CPU.

configs/blender_mipnerf.gin runs the spatial trunk K1 and a 128-wide
directional trunk (K2, K5) over [bottleneck 128 | positional encoding 33];
with `Model.use_viewdirs = False` bound on top there is no directional
trunk, and the spatial trunk returns its features y for the rgb head (K11,
`out_y`). Here the port's plain versions are held against JAX, which runs
its Pallas kernels in interpret mode:

- function level: `coord.pos_enc`; `fused_mlp.fused_encoded_trunk` with
  `out_y`, with and without the density gradient and the heads, and
  `fused_mlp.fused_trunk` at width 128 on (128, 33) segments, against JAX,
  values and `jax.grad` through y . ybar, sigma and the heads (and the
  segments' cotangents at width 128);
- the parameter trees: both full-width JAX trees load into the port's model
  (init only); the kernel path names the K11 modes it has no kernel for;
- MLP level: a small cut of the gin (trunks of depth 3), with and without
  view directions, eval and train, against the JAX MLP with
  `fused_trunk='on'`;
- slice level: two train steps against JAX `make_train_step` and a served
  `render_rays` against JAX `Model.apply`, for both runs.

Tolerances. `pos_enc` 1e-6 (the same sines; the libraries' sin differ by an
ulp). The trunks in float32: values and gradients within 1e-5 of
max(1, max |reference|) (the same f32 arithmetic, summed in another order);
in bfloat16 5e-2 of it, as tests/test_torch_port_spatialfuse.py (a bf16
rounding flip, 2^-8 relative, of one activation moves every later layer).
The MLP: values 1e-5, gradients 1e-4 of the largest entry (as the
spatialfuse file). The slice, as tests/test_torch_port_train.py: the loss
terms, loss and psnr 1e-5 relative, the parameters 2e-2 of each one's
largest move; the served request 1e-4.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refnerf_tpu import configs as jconfigs
from refnerf_tpu.cameras import rays as jrays
from refnerf_tpu.models import construct as jconstruct
from refnerf_tpu.models import render as jrender
from refnerf_tpu.models.mlp import MLP as JaxMLP
from refnerf_tpu.ops import coord as jcoord
from refnerf_tpu.ops.pallas import fused_mlp as jfused
from refnerf_tpu.train import step as jstep
from refnerf_tpu_torch import configs
from refnerf_tpu_torch import convert
from refnerf_tpu_torch.cameras import rays as rays_lib
from refnerf_tpu_torch.models import construct
from refnerf_tpu_torch.models import renderer
from refnerf_tpu_torch.ops import coord
from refnerf_tpu_torch.ops import fused_mlp
from refnerf_tpu_torch.train import step as step_lib

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIN = os.path.join(REPO, 'configs', 'blender_mipnerf.gin')
NO_VIEWDIRS = ['Model.use_viewdirs = False']
DEPTH, WIDTH, SKIP, NB = 4, 32, 2, 3


def _t(a):
  return torch.tensor(np.ascontiguousarray(a))


def _np(x):
  return np.asarray(jnp.asarray(x, jnp.float32))


def _close(port, ref, tol, what, floor=1.0):
  """Each value within tol * max(floor, max |ref|) of the reference."""
  a, b = port.detach().float().numpy(), np.asarray(ref, np.float32)
  assert a.shape == b.shape, (what, a.shape, b.shape)
  scale = max(floor, float(np.abs(b).max(initial=0.0)))
  np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale, err_msg=what)


@pytest.mark.parametrize('identity', [True, False])
@pytest.mark.parametrize('deg', range(6))
def test_pos_enc_matches_jax(deg, identity):
  rng = np.random.default_rng(deg)
  x = rng.normal(size=(7, 5, 3)).astype(np.float32)
  x /= np.linalg.norm(x, axis=-1, keepdims=True)
  want = jcoord.pos_enc(jnp.asarray(x), 0, deg, append_identity=identity)
  got = coord.pos_enc(_t(x), 0, deg, append_identity=identity)
  assert got.dtype == torch.float32
  assert got.shape[-1] == (3 if identity else 0) + 6 * deg
  _close(got, _np(want), 1e-6, 'pos_enc')


def _layers(rng, fin, width, depth=DEPTH):
  """Flax-layout ([in, out]) trunk weights and biases."""
  skips = jfused.skip_input_layers(depth, SKIP)
  ks, bs = [], []
  for l in range(depth):
    ind = fin if l == 0 else width + (fin if l in skips else 0)
    ks.append((rng.normal(size=(ind, width)) / np.sqrt(ind)).astype(np.float32))
    bs.append((rng.normal(size=(width,)) * 0.1).astype(np.float32))
  return ks, bs


def _mat(rng, i, o):
  return (rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32)


def _vec(rng, o):
  return (rng.normal(size=(o,)) * 0.1).astype(np.float32)


# K11 (density gradient, the f32 and compute-dtype heads, compute dtype).
# mip-NeRF without view directions is the first: no heads, no density
# gradient. The plain versions follow JAX in every combination.
OUT_Y_CASES = {
    'y': (False, False, 'float32'),
    'y_heads': (False, True, 'float32'),
    'y_dgrad_heads': (True, True, 'float32'),
    'y_bf16': (False, False, 'bfloat16'),
    'y_dgrad_heads_bf16': (True, True, 'bfloat16'),
}
SCALES = tuple(float(2**d) for d in range(4))


@pytest.mark.parametrize('case', sorted(OUT_Y_CASES))
def test_encoded_trunk_out_y_matches_pallas(case):
  dgrad, heads, cdt = OUT_Y_CASES[case]
  rng = np.random.default_rng(sorted(OUT_Y_CASES).index(case))
  lead = (5, 9)  # 45 samples, ragged against the Pallas block of 16
  lm = (rng.normal(size=lead + (NB,)) * 2).astype(np.float32)
  lv = np.log1p(np.exp(rng.normal(size=lead + (NB,)))).astype(np.float32)
  ks, bs = _layers(rng, 2 * NB * len(SCALES), WIDTH)
  prm = dict(wd=_mat(rng, WIDTH, 1), bd=_vec(rng, 1), wh=_mat(rng, WIDTH, 4),
             bh=_vec(rng, 4), wc=_mat(rng, WIDTH, 8), bc=_vec(rng, 8))
  ybar = rng.normal(size=lead + (WIDTH,)).astype(np.float32)
  coefs = [rng.normal(size=lead + (k,)).astype(np.float32) for k in (4, 8)]

  def loss(xp, outs):
    f32 = (lambda a: a.astype(jnp.float32)) if xp is jnp else (
        lambda a: a.float())
    y, sig = outs[:2]
    t = xp.sum(f32(y) * xp.asarray(ybar)) + xp.sum(xp.tanh(sig))
    if heads:
      hf, hc = outs[2:4]
      t = t + xp.sum(xp.sin(hf) * xp.asarray(coefs[0])) + xp.sum(
          xp.cos(f32(hc)) * xp.asarray(coefs[1]))
    if dgrad:
      u = outs[-1]
      t = t + xp.sum(xp.sqrt(xp.sum(u * u, -1) + 1e-4))
    return t

  kw = dict(skip_period=SKIP, density_grad=dgrad, compute_dtype=cdt)

  def jfn(q):
    jks, jbs, wd, bd, wh, bh, wc, bc = q
    hkw = dict(head_f32=(wh, bh), head_cdt=(wc, bc)) if heads else {}
    outs = jfused.fused_encoded_trunk(
        jnp.asarray(lm), jnp.asarray(lv), SCALES, jks, jbs, wd, bd,
        out_y=True, block=16, **hkw, **kw)
    return loss(jnp, outs), outs

  q = ([jnp.asarray(k) for k in ks], [jnp.asarray(b) for b in bs],
       *(jnp.asarray(prm[k]) for k in ('wd', 'bd', 'wh', 'bh', 'wc', 'bc')))
  (_, jouts), jg = jax.value_and_grad(jfn, has_aux=True)(q)

  tws = [_t(k.T).requires_grad_(True) for k in ks]
  tbs = [_t(b).requires_grad_(True) for b in bs]
  tp = {k: _t(prm[k].T if k in ('wd', 'wh', 'wc') else prm[k])
        .requires_grad_(True) for k in prm}
  hkw = (dict(head_f32=(tp['wh'], tp['bh']), head_cdt=(tp['wc'], tp['bc']))
         if heads else {})
  outs = fused_mlp.fused_encoded_trunk(
      _t(lm), _t(lv), SCALES, tws, tbs, tp['wd'], tp['bd'], out_y=True,
      **hkw, **kw)
  names = ['y', 'sigma'] + (['h_f32', 'h_cdt'] if heads else []) + (
      ['u'] if dgrad else [])
  assert len(outs) == len(jouts) == len(names)
  assert outs[0].dtype == fused_mlp.DTYPES[cdt]
  assert tuple(outs[0].shape) == lead + (WIDTH,)
  tol = 1e-5 if cdt == 'float32' else 5e-2
  for name, a, b in zip(names, outs, jouts):
    _close(a, _np(b), tol, name)
  leaves = tws + tbs + [tp['wd'], tp['bd']] + (
      [tp[k] for k in ('wh', 'bh', 'wc', 'bc')] if heads else [])
  got = torch.autograd.grad(loss(torch, outs), leaves)
  jks, jbs, jwd, jbd, jwh, jbh, jwc, jbc = jg
  want = [k.T for k in jks] + list(jbs) + [jwd.T, jbd] + (
      [jwh.T, jbh, jwc.T, jbc] if heads else [])
  what = ([f'w{i}' for i in range(DEPTH)] + [f'b{i}' for i in range(DEPTH)]
          + ['wd', 'bd', 'wh', 'bh', 'wc', 'bc'])
  for a, b, w in zip(got, want, what):
    _close(a, _np(b), tol, w)


@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
def test_fused_trunk_width_128_matches_pallas(cdt):
  # mip-NeRF's directional trunk: width 128 on [bottleneck 128 | positional
  # encoding 33], the rgb head, the segments' cotangents (needs_dx).
  rng = np.random.default_rng(11)
  width = 128
  segs = [rng.normal(size=(7, 11, 128)).astype(np.float32),
          rng.uniform(-1, 1, (7, 11, 33)).astype(np.float32)]
  ks, bs = _layers(rng, 161, width)
  wh, bh = _mat(rng, width, 3), _vec(rng, 3)
  cot = rng.normal(size=(7, 11, 3)).astype(np.float32)

  def jloss(q):
    sg, jks, jbs, jwh, jbh = q
    out = jfused.fused_trunk(sg, jks, jbs, head_f32=(jwh, jbh), out_y=False,
                             skip_period=SKIP, needs_dx=True,
                             compute_dtype=cdt, block=32)
    return jnp.sum(jnp.sin(out) * cot), out

  q = ([jnp.asarray(s) for s in segs], [jnp.asarray(k) for k in ks],
       [jnp.asarray(b) for b in bs], jnp.asarray(wh), jnp.asarray(bh))
  (_, jout), (jdx, jks, jbs, jwh, jbh) = jax.value_and_grad(
      jloss, has_aux=True)(q)
  tsegs = [_t(s).requires_grad_(True) for s in segs]
  tws = [_t(k.T).requires_grad_(True) for k in ks]
  tbs = [_t(b).requires_grad_(True) for b in bs]
  twh, tbh = _t(wh.T).requires_grad_(True), _t(bh).requires_grad_(True)
  out = fused_mlp.fused_trunk(tsegs, tws, tbs, (twh, tbh), skip_period=SKIP,
                              compute_dtype=cdt)
  tol = 1e-5 if cdt == 'float32' else 5e-2
  _close(out, _np(jout), tol, 'rgb')
  got = torch.autograd.grad(torch.sum(torch.sin(out) * _t(cot)),
                            [*tsegs, *tws, *tbs, twh, tbh])
  want = list(jdx) + [k.T for k in jks] + list(jbs) + [jwh.T, jbh]
  for i, (a, b) in enumerate(zip(got, want)):
    _close(a, _np(b), tol, f'leaf {i}')


def _init_params(bindings, seed=0, noise=True):
  """JAX parameters, as numpy; with `noise`, random biases added."""
  config, gin = jconfigs.parse([GIN], bindings)
  model = jconstruct.construct_model(config, gin)
  p = jax.device_get(jconstruct.init_params(jax.random.PRNGKey(seed), model))
  rng = np.random.default_rng(seed)
  return jax.tree_util.tree_map_with_path(
      lambda path, x: np.asarray(x) + (
          rng.normal(size=x.shape).astype(np.float32) * 0.1
          if noise and path[-1].key == 'bias' else 0.0), p)


@pytest.mark.parametrize('viewdirs', [True, False])
def test_full_width_trees_load(viewdirs):
  # The gin at full width, as shipped and with use_viewdirs = False: the
  # port builds the JAX tree, leaf for leaf (load_jax_params checks the key
  # set and every shape). Init only.
  bindings = [] if viewdirs else NO_VIEWDIRS
  params = _init_params(bindings, noise=False)
  config, gin = configs.parse([GIN], bindings)
  model = construct.construct_model(config, gin, 'cpu')
  convert.load_jax_params(model, params)
  mlp = model.nerf_mlp
  assert model.prop_mlp is None and mlp.use_viewdirs == viewdirs
  assert tuple(mlp.spatial_5.weight.shape) == (256, 352)
  if viewdirs:
    assert tuple(mlp.viewdir_0.weight.shape) == (128, 161)
    assert tuple(mlp.viewdir_5.weight.shape) == (128, 289)
    assert tuple(mlp.rgb.weight.shape) == (3, 128)
  else:
    assert set(params['nerf_mlp']) == {f'spatial_{i}' for i in range(8)} | {
        'raw_density', 'rgb'}
    assert tuple(mlp.rgb.weight.shape) == (3, 256)


def test_k11_kernel_path_names_what_it_lacks():
  # K11 has a kernel on the spatial trunk at width 256 without the density
  # gradient, the compute-dtype head or a fused stage. The kernel wrappers
  # refuse the rest before they build or launch anything; the plain
  # versions take every combination (above).
  rng = np.random.default_rng(5)
  ks, bs = _layers(rng, 2 * NB * len(SCALES), WIDTH)
  ws, tbs = [_t(k.T) for k in ks], [_t(b) for b in bs]
  wd = _t(_mat(rng, WIDTH, 1).T)
  wc, bc = _t(_mat(rng, WIDTH, 8).T), _t(_vec(rng, 8))
  segs = [torch.zeros(10, 12), torch.zeros(10, 12)]
  fold = _t(fused_mlp.ipe_scale_fold(SCALES, NB))
  pack = fused_mlp.pack_trunk(ws, tbs, (12, 12), skip_period=SKIP, wd=wd,
                              head_cdt=(wc, bc))
  with pytest.raises(NotImplementedError, match=r'K11.*width 32.*head.*K3'):
    fused_mlp.trunk_kernel(segs, pack, fold, out_y=True)
  cots = (torch.zeros(10), None, None, None)
  with pytest.raises(NotImplementedError, match=r'K11.*K7'):
    fused_mlp.trunk_backward_kernel(
        segs, pack, cots, spa_modes=fused_mlp.SpaModes(SCALES),
        ybar=torch.zeros(10, WIDTH))


def test_width_128_kernel_path_names_what_it_lacks():
  # Width 128 has a kernel for the plain directional trunk alone (K2, K5,
  # as mip-NeRF runs it): with a density head, the density gradient or a
  # fused stage the kernel wrappers refuse before they build or launch
  # anything.
  rng = np.random.default_rng(6)
  ks, bs = _layers(rng, 24, 128)
  ws, tbs = [_t(k.T) for k in ks], [_t(b) for b in bs]
  wd = _t(_mat(rng, 128, 1).T)
  head = (_t(_mat(rng, 128, 3).T), _t(_vec(rng, 3)))
  segs = [torch.zeros(10, 12), torch.zeros(10, 12)]
  fold = _t(fused_mlp.ipe_scale_fold(SCALES, NB))
  pack = fused_mlp.pack_trunk(ws, tbs, (12, 12), skip_period=SKIP, wd=wd)
  with pytest.raises(NotImplementedError,
                     match=r'width-128.*density head.*density gradient'):
    fused_mlp.trunk_kernel(segs, pack, fold)
  cots = (torch.zeros(10), None, None, None)
  with pytest.raises(NotImplementedError, match=r'width-128.*density head'):
    fused_mlp.trunk_backward_kernel(segs, pack, cots)
  pack = fused_mlp.pack_trunk(ws, tbs, (12, 12), skip_period=SKIP,
                              head_f32=head)
  with pytest.raises(NotImplementedError, match=r'width-128.*K6.*K7'):
    fused_mlp.trunk_kernel(segs, pack,
                           spa_modes=fused_mlp.SpaModes(SCALES, 10))


# MLP level: a small cut of the gin (trunks of depth 3, widths 32 and 16,
# bottleneck 16, max_deg_point 8; deg_view 5, so the encoding is 33 wide),
# 8 samples a ray in Pallas blocks of 16.
MLP_SMALL = [
    'NerfMLP.net_depth = 3', 'NerfMLP.net_width = 32',
    'NerfMLP.net_depth_viewdirs = 3', 'NerfMLP.net_width_viewdirs = 16',
    'NerfMLP.bottleneck_width = 16', 'NerfMLP.max_deg_point = 8',
    "NerfMLP.fused_trunk = 'on'", 'NerfMLP.fused_block = 16',
]


def _gaussians(seed, n_rays=5, s=8):
  rng = np.random.default_rng(seed)
  d = rng.normal(size=(n_rays, 3)).astype(np.float32)
  o = (rng.normal(size=(n_rays, 3)) * 0.1).astype(np.float32)
  tdist = np.sort(rng.uniform(2, 6, (n_rays, s + 1)), axis=-1).astype(np.float32)
  radii = np.full((n_rays, 1), 0.005, np.float32)
  means, covs = jrender.cast_rays(jnp.asarray(tdist), jnp.asarray(o),
                                  jnp.asarray(d), jnp.asarray(radii), 'cone',
                                  diag=False)
  return _np(means), _np(covs), d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('viewdirs', [True, False])
def test_mlp_matches_jax(viewdirs, train):
  bindings = MLP_SMALL + ([] if viewdirs else NO_VIEWDIRS)
  seed = 2 * int(viewdirs) + int(train)
  params = _init_params(bindings, seed)
  _, jgin = jconfigs.parse([GIN], bindings)
  jmlp = JaxMLP(**jconfigs.mlp_kwargs(jgin, 'NerfMLP'))
  means, covs, vd = _gaussians(seed)
  jvd = jnp.asarray(vd) if viewdirs else None

  def japply(p):
    return jmlp.apply({'params': p}, (jnp.asarray(means), jnp.asarray(covs)),
                      jvd, None, train)

  def loss(xp, r):
    return xp.mean((r['rgb'] - 0.5)**2) + xp.mean(r['density'])

  ref = japply(params['nerf_mlp'])
  config, gin = configs.parse([GIN], bindings)
  model = construct.construct_model(config, gin, 'cpu')
  convert.load_jax_params(model, params)
  mlp = model.nerf_mlp
  with torch.set_grad_enabled(train):
    out = mlp((_t(means), _t(covs)), _t(vd) if viewdirs else None,
              train=train)
  assert set(out) == set(ref) == {'density', 'rgb'}
  for k in ref:
    _close(out[k], _np(ref[k]), 1e-5, k, floor=1e-6)
  if not train:
    return
  jg = jax.grad(lambda p: loss(jnp, japply(p)))(params['nerf_mlp'])
  layers = sorted(jg)
  got = torch.autograd.grad(
      loss(torch, out), [getattr(mlp, l).weight for l in layers] +
      [getattr(mlp, l).bias for l in layers])
  want = [jg[l]['kernel'].T for l in layers] + [jg[l]['bias'] for l in layers]
  what = [f'{l}.weight' for l in layers] + [f'{l}.bias' for l in layers]
  for a, b, w in zip(got, want, what):
    _close(a, _np(b), 1e-4, w, floor=1e-6)


# Slice level: the gin with trunks of depth 4 (skip at 3), widths 32 and
# 16, bottleneck 16, 2 levels x 16 samples in Pallas blocks of 16.
SLICE = [
    'NerfMLP.net_depth = 4', 'NerfMLP.net_width = 32',
    'NerfMLP.net_depth_viewdirs = 4', 'NerfMLP.net_width_viewdirs = 16',
    'NerfMLP.skip_layer = 2', 'NerfMLP.bottleneck_width = 16',
    'Model.num_prop_samples = 16', 'Model.num_nerf_samples = 16',
    'Config.sample_noise_size = 0', 'Config.batch_size = 12',
    "NerfMLP.fused_trunk = 'on'", 'NerfMLP.fused_block = 16',
]


def _batch_np(n, seed):
  """Rays and pixels as bench.py makes them."""
  rng = np.random.RandomState(seed)
  d = rng.randn(n, 3).astype(np.float32)
  return dict(origins=rng.randn(n, 3).astype(np.float32) * 0.1, directions=d,
              viewdirs=d / np.linalg.norm(d, axis=-1, keepdims=True),
              radii=np.full((n, 1), 0.001, np.float32),
              lossmult=np.ones((n, 1), np.float32),
              near=np.full((n, 1), 2.0, np.float32),
              far=np.full((n, 1), 6.0, np.float32),
              rgb=rng.uniform(0, 1, (n, 3)).astype(np.float32))


def _port_rays(b, n):
  rays = rays_lib.dummy_rays(n)
  for k, v in b.items():
    if k != 'rgb':
      setattr(rays, k, _t(v))
  return rays


def _jax_rays(b, n):
  return jrays.dummy_rays(n).replace(**{k: jnp.asarray(v) for k, v in
                                        b.items() if k != 'rgb'})


@pytest.mark.parametrize('viewdirs', [True, False])
def test_train_steps_match_jax(viewdirs):
  bindings = SLICE + ([] if viewdirs else NO_VIEWDIRS)
  params = _init_params(bindings, 0)
  jconfig, jgin = jconfigs.parse([GIN], bindings)
  jmodel = jconstruct.construct_model(jconfig, jgin)
  b = _batch_np(12, seed=0)
  jbatch = jrays.Batch(rays=_jax_rays(b, 12), rgb=jnp.asarray(b['rgb']))
  jstate = jstep.create_train_state(jconfig, jmodel, params)
  jtrain = jax.jit(jstep.make_train_step(jmodel, jconfig))

  config, gin = configs.parse([GIN], bindings)
  model = construct.construct_model(config, gin, 'cpu')
  convert.load_jax_params(model, params)
  batch = rays_lib.Batch(rays=_port_rays(b, 12), rgb=_t(b['rgb']))
  state = step_lib.create_train_state(config, model)
  train = step_lib.make_train_step(model, config)
  before = {k: v.detach().clone().numpy() for k, v in state.params().items()}
  for step in (1, 2):
    jstate, jstats = jtrain(jstate, jbatch)
    state, stats = train(state, batch)
    assert state.step == step
    assert set(stats['losses']) == set(jstats['losses']) == {'data'}
    np.testing.assert_allclose(float(stats['losses']['data']),
                               float(jstats['losses']['data']), rtol=1e-5)
    for k in ('loss', 'psnr'):
      np.testing.assert_allclose(float(stats[k]), float(jstats[k]), rtol=1e-5)
    jparams = {k: v.numpy() for k, v in convert.params_to_state_dict(
        jax.device_get(jstate.params)).items()}
    assert set(jparams) == set(state.params())
    for k, v in state.params().items():
      moved = max(1e-12, float(np.abs(jparams[k] - before[k]).max()))
      np.testing.assert_allclose(v.detach().numpy(), jparams[k], rtol=0,
                                 atol=2e-2 * moved, err_msg=k)


@pytest.mark.parametrize('viewdirs', [True, False])
def test_served_request_matches_jax(viewdirs):
  # One render_rays request of 10 rays in chunks of 8 (two chunks, padded)
  # against JAX Model.apply, float32.
  bindings = SLICE + ([] if viewdirs else NO_VIEWDIRS)
  params = _init_params(bindings, 1)
  jconfig, jgin = jconfigs.parse([GIN], bindings)
  jmodel = jconstruct.construct_model(jconfig, jgin)
  b = _batch_np(10, seed=1)
  renderings, _ = jax.jit(lambda p, r: jmodel.apply(
      {'params': p}, r, train_frac=1.0, compute_extras=False,
      train=False))(params, _jax_rays(b, 10))
  config, gin = configs.parse([GIN], bindings)
  model = construct.construct_model(config, gin, 'cpu')
  convert.load_jax_params(model, params)
  out = renderer.render_rays(model, _port_rays(b, 10), 8)
  for k in ('rgb', 'acc', 'distance'):
    np.testing.assert_allclose(out[k].numpy(), _np(renderings[-1][k]),
                               rtol=1e-4, atol=1e-4, err_msg=k)
  assert torch.isfinite(out['rgb']).all()


def test_view_directions_must_match_the_build():
  # An MLP built for view directions refuses a call without them and the
  # reverse, as the JAX tree would not fit (ValueError).
  model = construct.construct_model(*configs.parse([GIN], MLP_SMALL), 'cpu')
  means, covs, vd = _gaussians(3)
  with torch.no_grad(), pytest.raises(ValueError, match='use_viewdirs=True'):
    model.nerf_mlp((_t(means), _t(covs)), None)
  model = construct.construct_model(
      *configs.parse([GIN], MLP_SMALL + NO_VIEWDIRS), 'cpu')
  with torch.no_grad(), pytest.raises(ValueError, match='use_viewdirs=False'):
    model.nerf_mlp((_t(means), _t(covs)), _t(vd))
