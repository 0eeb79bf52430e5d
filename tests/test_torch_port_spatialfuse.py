"""The fused spatial stage against the JAX package, on the CPU.

`NerfMLP.fuse_ipe_trig`, `fuse_compositing` and `fuse_lift` move the IPE
(K7) and the compositing weights (K6) into the spatial trunk and feed it the
lifted Gaussians in closed form (`render.cast_rays_lifted`). Here the port's
plain versions of those modes are held against JAX, which runs its Pallas
kernels in interpret mode:

- function level: `fused_mlp.fused_encoded_trunk` with `in_kernel_trig`
  and with `delta`/`act_bias`, against JAX `fused_encoded_trunk`, outputs
  and the gradients of a loss through sigma, the heads, u (second order)
  and the weights, with respect to every parameter and the density bias;
  the range reduction at arguments near 2^15 x 10; the closed-form
  compositing backward against autograd; `cast_rays_lifted` for cone and
  cylinder, against JAX and against the lift of `cast_rays`;
- MLP level: a small cut of configs/blender_refnerf.gin with each flag and
  all three, eval and train, against the JAX MLP with `fused_trunk='on'`;
- slice level: two train steps against JAX `make_train_step` and a served
  `render_rays` against JAX `Model.apply`, with all six fuse flags; each
  gate's once-only log.

Tolerances. float32: values within 1e-5 of the largest reference entry
(the same f32 arithmetic, summed in another order), gradients within 1e-4 of
it (as tests/test_torch_port_dirfuse.py). bfloat16: 5e-2 (a bf16 rounding
flip, 2^-8 relative, of one trunk input or activation moves every later
layer's operands). In bf16 the K7 fold and tangent take the f32 trig
factors, where K3 takes the rounded segments: K7 is held against JAX's
`in_kernel_trig=True`, never against K3.
"""

import logging
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
from refnerf_tpu.ops import geopoly as jgeopoly
from refnerf_tpu.ops import mathx as jmathx
from refnerf_tpu.ops.pallas import fused_mlp as jfused
from refnerf_tpu.train import losses as jlosses
from refnerf_tpu.train import step as jstep
from refnerf_tpu_torch import configs
from refnerf_tpu_torch import convert
from refnerf_tpu_torch.cameras import rays as rays_lib
from refnerf_tpu_torch.models import construct
from refnerf_tpu_torch.models import mlp as mlp_lib
from refnerf_tpu_torch.models import render
from refnerf_tpu_torch.models import renderer
from refnerf_tpu_torch.ops import coord
from refnerf_tpu_torch.ops import fused_mlp
from refnerf_tpu_torch.train import step as step_lib

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIN = os.path.join(REPO, 'configs', 'blender_refnerf.gin')
SPATIAL = ['NerfMLP.fuse_ipe_trig = True', 'NerfMLP.fuse_compositing = True',
           'NerfMLP.fuse_lift = True']
DIRECTIONAL = ['NerfMLP.fuse_dir_enc = True', 'NerfMLP.fuse_dir_geo = True',
               'NerfMLP.fuse_dir_rgb = True']
DEPTH, WIDTH, SKIP, NB = 4, 32, 2, 3


def _t(a):
  return torch.tensor(np.ascontiguousarray(a))


def _np(x):
  return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_grads(port, ref, rtol, what):
  """Each value within rtol * max(|ref|) of the reference."""
  a, b = port.detach().float().numpy(), np.asarray(ref, np.float32)
  assert a.shape == b.shape, (what, a.shape, b.shape)
  scale = max(1e-6, float(np.abs(b).max()))
  np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale, err_msg=what)


def _trunk_params(rng, fin, hf=4, hc=8):
  """Flax-layout spatial trunk, density head and both head blocks."""
  skips = jfused.skip_input_layers(DEPTH, SKIP)
  ks, bs = [], []
  for l in range(DEPTH):
    ind = fin if l == 0 else WIDTH + (fin if l in skips else 0)
    ks.append((rng.normal(size=(ind, WIDTH)) / np.sqrt(ind)).astype(np.float32))
    bs.append((rng.normal(size=(WIDTH,)) * 0.1).astype(np.float32))
  mat = lambda i, o: (rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32)
  vec = lambda o: (rng.normal(size=(o,)) * 0.1).astype(np.float32)
  return dict(ks=ks, bs=bs, wd=mat(WIDTH, 1), bd=vec(1),
              wh=mat(WIDTH, hf), bh=vec(hf), wc=mat(WIDTH, hc), bc=vec(hc))


def _lifted(rng, lead, spread=3.0):
  lm = (rng.normal(size=lead + (NB,)) * spread).astype(np.float32)
  lv = np.log1p(np.exp(rng.normal(size=lead + (NB,)))).astype(np.float32)
  return lm, lv


# (in-kernel trig, compositing, density gradient, compute dtype).
FN_CASES = {
    'trig': (True, False, True, 'float32'),
    'trig_bf16': (True, False, True, 'bfloat16'),
    'trig_no_dgrad': (True, False, False, 'float32'),
    'weights': (False, True, False, 'float32'),
    'weights_dgrad': (False, True, True, 'float32'),
    'weights_trig_dgrad': (True, True, True, 'float32'),
    'weights_trig_dgrad_bf16': (True, True, True, 'bfloat16'),
}
SCALES = tuple(float(2**d) for d in range(4))
RAYS, S = 5, 8  # 40 samples: rays of 8 in Pallas blocks of 16


@pytest.mark.parametrize('case', sorted(FN_CASES))
def test_encoded_trunk_modes_match_pallas(case):
  trig, comp, dgrad, cdt = FN_CASES[case]
  rng = np.random.default_rng(sorted(FN_CASES).index(case))
  lead = (RAYS, S)
  lm, lv = _lifted(rng, lead)
  prm = _trunk_params(rng, 2 * NB * len(SCALES))
  delta = (rng.uniform(0.02, 0.3, lead)).astype(np.float32)
  act_bias = -0.7
  # A loss through every output: sigma, both head blocks, u (its gradient is
  # second order in the parameters) and the weights.
  coefs = [rng.normal(size=lead + (k,)).astype(np.float32) for k in (4, 8)]

  def loss(xp, outs):
    sig, hf, hc = outs[:3]
    hc = hc.astype(jnp.float32) if xp is jnp else hc.float()
    t = (xp.sum(xp.tanh(sig)) + xp.sum(xp.sin(hf) * xp.asarray(coefs[0]))
         + xp.sum(xp.cos(hc) * xp.asarray(coefs[1])))
    if dgrad:
      u = outs[3]
      t = t + xp.sum(xp.sqrt(xp.sum(u * u, -1) + 1e-4))
    if comp:
      t = t + xp.sum(xp.sin(outs[-1] * 3.0))
    return t

  kw = dict(skip_period=SKIP, density_grad=dgrad, compute_dtype=cdt)

  def jfn(q):
    ks, bs, wd, bd, wh, bh, wc, bc = q
    outs = jfused.fused_encoded_trunk(
        jnp.asarray(lm), jnp.asarray(lv), SCALES, ks, bs, wd, bd,
        head_f32=(wh, bh), head_cdt=(wc, bc), out_y=False, block=16,
        in_kernel_trig=trig, delta=jnp.asarray(delta) if comp else None,
        act_bias=act_bias, **kw)
    return loss(jnp, outs), outs

  q = ([jnp.asarray(k) for k in prm['ks']], [jnp.asarray(b) for b in prm['bs']],
       *(jnp.asarray(prm[k]) for k in ('wd', 'bd', 'wh', 'bh', 'wc', 'bc')))
  (_, jouts), jg = jax.value_and_grad(jfn, has_aux=True)(q)

  tws = [_t(k.T).requires_grad_(True) for k in prm['ks']]
  tbs = [_t(b).requires_grad_(True) for b in prm['bs']]
  tp = {k: _t(prm[k].T if k in ('wd', 'wh', 'wc') else prm[k])
        .requires_grad_(True) for k in ('wd', 'bd', 'wh', 'bh', 'wc', 'bc')}
  outs = fused_mlp.fused_encoded_trunk(
      _t(lm), _t(lv), SCALES, tws, tbs, tp['wd'], tp['bd'],
      head_f32=(tp['wh'], tp['bh']), head_cdt=(tp['wc'], tp['bc']),
      in_kernel_trig=trig, delta=_t(delta) if comp else None,
      act_bias=act_bias, **kw)
  vtol, gtol = (1e-5, 1e-4) if cdt == 'float32' else (5e-2, 5e-2)
  names = ['sigma', 'h_f32', 'h_cdt'] + (['u'] if dgrad else []) + (
      ['weights'] if comp else [])
  assert len(outs) == len(jouts) == len(names)
  for name, a, b in zip(names, outs, jouts):
    assert tuple(a.shape) == tuple(b.shape), name
    _assert_grads(a, _np(b), vtol, name)
  if comp:
    np.testing.assert_array_less(_np(jnp.sum(jouts[-1], -1)), 1.0 + 1e-6)
  leaves = tws + tbs + [tp[k] for k in ('wd', 'bd', 'wh', 'bh', 'wc', 'bc')]
  got = torch.autograd.grad(loss(torch, outs), leaves)
  jks, jbs, jwd, jbd, jwh, jbh, jwc, jbc = jg
  want = [k.T for k in jks] + list(jbs) + [jwd.T, jbd, jwh.T, jbh, jwc.T, jbc]
  what = ([f'spatial_{i}.weight' for i in range(DEPTH)]
          + [f'spatial_{i}.bias' for i in range(DEPTH)]
          + ['wd', 'bd (density bias)', 'wh', 'bh', 'wc', 'bc'])
  for a, b, w in zip(got, want, what):
    _assert_grads(a, _np(b), gtol, w)


def test_in_kernel_trig_range_reduction_near_2_15():
  # |lm 2^15| ~ 3e5 >> 100 pi (tests/test_fused_mlp.py:198-222): sin m and
  # cos m of `ipe_trig` against JAX's safe_sin / safe_cos of the same scaled
  # means, undamped (1e-6: one f32 ulp of sin after the same exact
  # floor-mod; a reduction that rounds otherwise is off by up to ~1e-2
  # here), the damped IPE likewise, and the trunk's sigma with
  # in_kernel_trig against JAX's with lv = 0, every degree undamped (1e-5
  # of its largest).
  rng = np.random.default_rng(30)
  scales = tuple(float(2**d) for d in range(16))
  lm = (rng.normal(size=(33, NB)) * 10.0).astype(np.float32)
  lv = (1e-4 * np.log1p(np.exp(rng.normal(size=(33, NB))))).astype(np.float32)
  sc = jnp.asarray(scales)
  m_s = jnp.reshape(jnp.asarray(lm)[:, None, :] * sc[:, None], (33, -1))
  v_s = jnp.reshape(jnp.asarray(lv)[:, None, :] * sc[:, None]**2, (33, -1))
  assert float(jnp.max(jnp.abs(m_s))) > 1e5
  e = jnp.exp(-0.5 * v_s)
  ee, sn, cs = fused_mlp.ipe_trig(_t(lm), _t(lv), scales)
  _assert_grads(sn, _np(jmathx.safe_sin(m_s)), 1e-6, 'sin m')
  _assert_grads(cs, _np(jmathx.safe_cos(m_s)), 1e-6, 'cos m')
  _assert_grads(ee * sn, _np(e * jmathx.safe_sin(m_s)), 1e-6, 'xs')
  _assert_grads(ee * cs, _np(e * jmathx.safe_cos(m_s)), 1e-6, 'xc')
  prm = _trunk_params(rng, 2 * NB * len(scales))
  lv0 = np.zeros_like(lv)
  jsig = jfused.fused_encoded_trunk(
      jnp.asarray(lm), jnp.asarray(lv0), scales, prm['ks'], prm['bs'],
      prm['wd'], prm['bd'], skip_period=SKIP, block=16, out_y=False,
      in_kernel_trig=True)
  sig, = fused_mlp.fused_encoded_trunk(
      _t(lm), _t(lv0), scales, [_t(k.T) for k in prm['ks']],
      [_t(b) for b in prm['bs']], _t(prm['wd'].T), _t(prm['bd']),
      skip_period=SKIP, in_kernel_trig=True)
  assert torch.isfinite(sig).all()
  _assert_grads(sig, _np(jsig), 1e-5, 'sigma')


def test_composite_weights_closed_form_matches_autograd_and_jax():
  # K6's plain forward against JAX render.compute_alpha_weights of
  # softplus(raw + bsig), and its closed-form backward against autograd of
  # the forward, float32, 1e-6 of the largest entry.
  rng = np.random.default_rng(7)
  raw = rng.normal(size=(6, 16)).astype(np.float32) * 2
  delta = rng.uniform(0.01, 0.5, (6, 16)).astype(np.float32)
  bsig = np.array([-0.3], np.float32)
  wbar = rng.normal(size=(6, 16)).astype(np.float32)
  tdist = np.concatenate([np.zeros((6, 1)), np.cumsum(delta, -1)], -1)
  want = jrender.compute_alpha_weights(
      jax.nn.softplus(jnp.asarray(raw + bsig)), jnp.asarray(tdist),
      jnp.asarray(np.tile([[1.0, 0.0, 0.0]], (6, 1))))[0]
  traw, tb = _t(raw).reshape(-1).requires_grad_(True), _t(bsig).requires_grad_(True)
  w = fused_mlp.composite_weights(traw, _t(delta).reshape(-1), tb, 16)
  _assert_grads(w.reshape(6, 16), _np(want), 1e-6, 'weights')
  g_raw, g_b = torch.autograd.grad(w, [traw, tb], _t(wbar).reshape(-1))
  ct, db = fused_mlp.composite_weights_backward(
      traw.detach(), _t(delta).reshape(-1), tb.detach(), 16,
      _t(wbar).reshape(-1))
  _assert_grads(ct, g_raw.numpy(), 1e-6, 'ct_raw')
  _assert_grads(db, g_b.numpy(), 1e-6, 'd bsig')


@pytest.mark.parametrize('ray_shape', ['cone', 'cylinder'])
def test_cast_rays_lifted_matches_jax_and_the_lift(ray_shape):
  # Against JAX cast_rays_lifted (float32, 1e-5 of the largest entry), and
  # against the port's own lift of cast_rays with the tolerances of
  # tests/test_fuse_lift.py:76-78 (the closed form rounds otherwise).
  rng = np.random.default_rng(3)
  n, s = 6, 9
  tdist = np.sort(rng.uniform(0.5, 4.0, (n, s + 1)), -1).astype(np.float32)
  origins = (rng.normal(size=(n, 3)) * 0.3).astype(np.float32)
  dirs = rng.normal(size=(n, 3)).astype(np.float32)
  radii = rng.uniform(1e-3, 1e-2, (n, 1)).astype(np.float32)
  mlp = mlp_lib.MLP(basis_shape='octahedron', basis_subdivisions=1,
                    use_directional_enc=True)
  basis = mlp.pos_basis_t
  want = jrender.cast_rays_lifted(jnp.asarray(tdist), jnp.asarray(origins),
                                  jnp.asarray(dirs), jnp.asarray(radii),
                                  ray_shape, jnp.asarray(basis.numpy()))
  got = render.cast_rays_lifted(_t(tdist), _t(origins), _t(dirs), _t(radii),
                                ray_shape, basis)
  for name, a, b in zip(('means', 'lm', 'lv'), got, want):
    assert tuple(a.shape) == tuple(b.shape), name
    _assert_grads(a, _np(b), 1e-5, name)
  means, covs = render.cast_rays(_t(tdist), _t(origins), _t(dirs), _t(radii),
                                 ray_shape)
  lm, lv = coord.lift_and_diagonalize(means, covs, basis)
  np.testing.assert_allclose(got[0].numpy(), means.numpy(), atol=1e-6,
                             rtol=1e-5)
  np.testing.assert_allclose(got[1].numpy(), lm.numpy(), atol=1e-5, rtol=1e-5)
  np.testing.assert_allclose(got[2].numpy(), lv.numpy(), atol=1e-7, rtol=1e-4)


# MLP level: a small cut of the flagship gin (trunks of depth 3 and width
# 32 without a skip layer, bottleneck 16, deg_view 3, max_deg_point 8), 8
# samples a ray in Pallas blocks of 16.
MLP_SMALL = [
    'NerfMLP.net_depth = 3', 'NerfMLP.net_width = 32',
    'NerfMLP.net_depth_viewdirs = 3', 'NerfMLP.net_width_viewdirs = 32',
    'NerfMLP.bottleneck_width = 16',
    'NerfMLP.deg_view = 3', 'NerfMLP.max_deg_point = 8',
    "NerfMLP.fused_trunk = 'on'", 'NerfMLP.fused_block = 16',
]
MLP_CASES = {
    'ipe_trig': ['NerfMLP.fuse_ipe_trig = True'],
    'compositing': ['NerfMLP.fuse_compositing = True'],
    'lift': ['NerfMLP.fuse_lift = True'],
    'all': SPATIAL,
}


def _init_params(bindings, seed):
  """JAX parameters, with random biases, as numpy."""
  config, gin = jconfigs.parse([GIN], bindings)
  model = jconstruct.construct_model(config, gin)
  p = jax.device_get(jconstruct.init_params(jax.random.PRNGKey(seed), model))
  rng = np.random.default_rng(seed)
  return jax.tree_util.tree_map_with_path(
      lambda path, x: np.asarray(x) + (
          rng.normal(size=x.shape).astype(np.float32) * 0.1
          if path[-1].key == 'bias' else 0.0), p)


def _samples(seed, n_rays=5, s=8):
  """Rays, fenceposts, and each sample's delta, as numpy."""
  rng = np.random.default_rng(seed)
  d = rng.normal(size=(n_rays, 3)).astype(np.float32)
  o = (rng.normal(size=(n_rays, 3)) * 0.1).astype(np.float32)
  tdist = np.sort(rng.uniform(2, 6, (n_rays, s + 1)), axis=-1).astype(np.float32)
  radii = np.full((n_rays, 1), 0.005, np.float32)
  delta = ((tdist[:, 1:] - tdist[:, :-1])
           * np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
  return d, o, tdist, radii, delta


def _mlp_loss(xp, r):
  """Colour, density, the normals' agreement (second order through the
  density normals), roughness and the weights."""
  t = xp.mean((r['rgb'] - 0.5)**2) + xp.mean(r['density'])
  if 'normals_pred' in r:
    t = t + xp.mean(xp.sum(r['normals'] * r['normals_pred'], -1))
  if 'roughness' in r:
    t = t + xp.mean(r['roughness'])
  if 'weights' in r:
    t = t + xp.mean(xp.sin(3 * r['weights']))
  return t


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('case', sorted(MLP_CASES))
def test_mlp_with_spatial_fusions_matches_jax(case, train):
  bindings = MLP_SMALL + MLP_CASES[case]
  seed = sorted(MLP_CASES).index(case)
  params = _init_params(bindings, seed)
  _, jgin = jconfigs.parse([GIN], bindings)
  jmlp = JaxMLP(**jconfigs.mlp_kwargs(jgin, 'NerfMLP'))
  d, o, tdist, radii, delta = _samples(seed)
  viewdirs = d / np.linalg.norm(d, axis=-1, keepdims=True)
  basis = jnp.asarray(np.array(jgeopoly.generate_basis('octahedron', 1)).T)
  lifted = 'lift' in case or case == 'all'
  if lifted:
    means, lm, lv = jrender.cast_rays_lifted(
        jnp.asarray(tdist), jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(radii), 'cone', basis)
    jin = ((means, None), jnp.asarray(viewdirs))
    jlift = (lm, lv)
  else:
    means, covs = jrender.cast_rays(jnp.asarray(tdist), jnp.asarray(o),
                                    jnp.asarray(d), jnp.asarray(radii),
                                    'cone', diag=False)
    jin = ((means, covs), jnp.asarray(viewdirs))
    jlift = None
  jdelta = jnp.asarray(delta)

  def japply(p):
    return jmlp.apply({'params': p}, *jin, None, train, None, jdelta, jlift)

  ref = japply(params['nerf_mlp'])
  config, gin = configs.parse([GIN], bindings)
  model = construct.construct_model(config, gin, 'cpu')
  convert.load_jax_params(model, params)
  mlp = model.nerf_mlp
  tin = ((_t(_np(jin[0][0])), None if lifted else _t(_np(jin[0][1]))),
         _t(viewdirs))
  tlift = (_t(_np(jlift[0])), _t(_np(jlift[1]))) if lifted else None
  with torch.set_grad_enabled(train):
    out = mlp(*tin, train=train, delta=_t(delta), lifted=tlift)
  assert set(out) == set(ref)
  assert ('weights' in out) == ('compositing' in case or case == 'all')
  for k, v in ref.items():
    if v is None or isinstance(v, float):
      assert out[k] is None or out[k] == v, k
      continue
    _assert_grads(out[k], _np(v), 1e-5, k)
  if not train:
    return
  jg = jax.grad(lambda p: _mlp_loss(jnp, japply(p)))(params['nerf_mlp'])
  loss = _mlp_loss(torch, out)
  layers = sorted(jg)
  got = torch.autograd.grad(
      loss, [getattr(mlp, l).weight for l in layers] +
      [getattr(mlp, l).bias for l in layers])
  want = [jg[l]['kernel'].T for l in layers] + [jg[l]['bias'] for l in layers]
  what = [f'{l}.weight' for l in layers] + [f'{l}.bias' for l in layers]
  for a, b, w in zip(got, want, what):
    _assert_grads(a, _np(b), 1e-4, w)


# Slice level: the small cut of tests/test_torch_port_dirfuse.py with all six
# flags; 16 samples a level in blocks of 16.
SLICE = [
    'NerfMLP.net_depth = 4', 'NerfMLP.net_width = 32',
    'NerfMLP.net_depth_viewdirs = 4', 'NerfMLP.net_width_viewdirs = 32',
    'NerfMLP.skip_layer = 2', 'NerfMLP.bottleneck_width = 16',
    'Model.num_prop_samples = 16', 'Model.num_nerf_samples = 16',
    'Config.sample_noise_size = 0', 'Config.batch_size = 12',
    "NerfMLP.fused_trunk = 'on'", 'NerfMLP.fused_block = 16',
] + SPATIAL + DIRECTIONAL


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


def test_train_steps_with_all_fusions_match_jax():
  # Two steps with the six flags, float32, as test_train_step_matches_jax:
  # the loss terms, loss and psnr 1e-5 relative; the parameters 2e-2 of the
  # largest move of each.
  params = _init_params(SLICE, 0)
  jconfig, jgin = jconfigs.parse([GIN], SLICE)
  jmodel = jconstruct.construct_model(jconfig, jgin)
  b = _batch_np(12, seed=0)
  jbatch = jrays.Batch(
      rays=jrays.dummy_rays(12).replace(**{k: jnp.asarray(v) for k, v in
                                           b.items() if k != 'rgb'}),
      rgb=jnp.asarray(b['rgb']))
  jstate = jstep.create_train_state(jconfig, jmodel, params)
  jtrain = jax.jit(jstep.make_train_step(jmodel, jconfig))

  config, gin = configs.parse([GIN], SLICE)
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
    assert set(stats['losses']) == set(jstats['losses'])
    for k in stats['losses']:
      np.testing.assert_allclose(float(stats['losses'][k]),
                                 float(jstats['losses'][k]), rtol=1e-5)
    for k in ('loss', 'psnr'):
      np.testing.assert_allclose(float(stats[k]), float(jstats[k]), rtol=1e-5)
    jparams = {k: v.numpy() for k, v in convert.params_to_state_dict(
        jax.device_get(jstate.params)).items()}
    for k, v in state.params().items():
      moved = max(1e-12, float(np.abs(jparams[k] - before[k]).max()))
      np.testing.assert_allclose(v.detach().numpy(), jparams[k], rtol=0,
                                 atol=2e-2 * moved, err_msg=k)


def test_f32_step_gradients_with_all_fusions_match_jax():
  # The shipped gin's own dtype (float32, no compute_dtype binding) with the
  # six flags: one step's loss and every parameter's gradient before the
  # clip, the port's plain versions against jax.grad of JAX's loss_fn
  # (make_train_step's terms; the Pallas trunks in interpret mode). The
  # loss 1e-5 relative, each gradient 2e-4 of its largest entry, as
  # tests/test_torch_port_train.py's test_train_step_matches_jax (the
  # level-1 samples follow the level-0 weights, summed in another order).
  params = _init_params(SLICE, 2)
  jconfig, jgin = jconfigs.parse([GIN], SLICE)
  assert jconfig.batch_size == 12
  jmodel = jconstruct.construct_model(jconfig, jgin)
  b = _batch_np(12, seed=2)
  jbatch = jrays.Batch(
      rays=jrays.dummy_rays(12).replace(**{k: jnp.asarray(v) for k, v in
                                           b.items() if k != 'rgb'}),
      rgb=jnp.asarray(b['rgb']))

  def jloss(p):
    renderings, hist = jmodel.apply({'params': p}, jbatch.rays,
                                    train_frac=0.0, compute_extras=False,
                                    train=True, rng=None)
    data, _ = jlosses.compute_data_loss(jbatch, renderings, jbatch.rays,
                                        jconfig)
    return (data + jlosses.orientation_loss(jbatch.rays, 2, hist, jconfig) +
            jlosses.predicted_normal_loss(2, hist, jconfig))
  jl, jg = jax.jit(jax.value_and_grad(jloss))(params)
  want = {k: v.numpy() for k, v in convert.params_to_state_dict(
      jax.device_get(jg)).items()}

  config, gin = configs.parse([GIN], SLICE)
  model = construct.construct_model(config, gin, 'cpu')
  for mlp in filter(None, (model.nerf_mlp, model.prop_mlp)):
    assert mlp.cfg.compute_dtype == 'float32'
    assert mlp.cfg.fuse_dir_enc and mlp.cfg.fuse_compositing
  convert.load_jax_params(model, params)
  batch = rays_lib.Batch(rays=_port_rays(b, 12), rgb=_t(b['rgb']))
  state = step_lib.create_train_state(config, model)
  loss, _, grads = step_lib.make_train_step(model, config).loss_and_grads(
      state, batch)
  np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
  assert set(grads) == set(want)
  for k, g in grads.items():
    _assert_grads(g, want[k], 2e-4, k)


def test_served_request_with_all_fusions_matches_jax():
  # One render_rays request (2 chunks) against JAX Model.apply, float32,
  # 1e-4 as for the unfused slice (test_slice_matches_jax_model), and the
  # final level's weights from the trunk against JAX's.
  params = _init_params(SLICE, 1)
  jconfig, jgin = jconfigs.parse([GIN], SLICE)
  jmodel = jconstruct.construct_model(jconfig, jgin)
  b = _batch_np(10, seed=1)
  jr = jrays.dummy_rays(10).replace(**{k: jnp.asarray(v) for k, v in
                                       b.items() if k != 'rgb'})
  renderings, jhistory = jax.jit(lambda p, r: jmodel.apply(
      {'params': p}, r, train_frac=1.0, compute_extras=False,
      train=False))(params, jr)
  config, gin = configs.parse([GIN], SLICE)
  model = construct.construct_model(config, gin, 'cpu')
  convert.load_jax_params(model, params)
  rays = _port_rays(b, 10)
  out = renderer.render_rays(model, rays, 8)
  for k in ('rgb', 'acc', 'distance'):
    np.testing.assert_allclose(out[k].numpy(), _np(renderings[-1][k]),
                               rtol=1e-4, atol=1e-4, err_msg=k)
  with torch.no_grad():
    _, history = model(rays)
  np.testing.assert_allclose(history[-1]['weights'].numpy(),
                             _np(jhistory[-1]['weights']), rtol=1e-4,
                             atol=1e-4)


def _small_model(extra):
  config, gin = configs.parse([GIN], MLP_SMALL + [
      'Model.num_prop_samples = 8', 'Model.num_nerf_samples = 8'] + extra)
  return construct.construct_model(config, gin, 'cpu')


@pytest.mark.parametrize('case', ['samples_not_dividing_block',
                                  'opaque_background'])
def test_inactive_compositing_is_logged_once(case, caplog):
  # fuse_compositing cannot act with 12 samples in blocks of 16, nor under
  # opaque_background: one warning over two requests, as JAX's
  # _warn_fused_fallback, and the weights still composite outside.
  mlp_lib._FALLBACK_WARNED.clear()
  extra = ['NerfMLP.fuse_compositing = True']
  if case == 'opaque_background':
    extra.append('Model.opaque_background = True')
  else:
    extra += ['Model.num_prop_samples = 12', 'Model.num_nerf_samples = 12']
  model = _small_model(extra)
  b = _batch_np(4, seed=2)
  with caplog.at_level(logging.WARNING), torch.no_grad():
    for _ in range(2):
      renderings, _ = model(_port_rays(b, 4))
  assert torch.isfinite(renderings[-1]['rgb']).all()
  hits = [r for r in caplog.records
          if 'fuse_compositing inactive' in r.getMessage()]
  assert len(hits) == 1
  assert ('opaque_background' in hits[0].getMessage()) == (
      case == 'opaque_background')


def test_lifted_without_the_fused_path_raises():
  # lifted inputs with a trunk the fused formulation does not run (a
  # softplus trunk) raise, as mlp.py:415-418 does.
  model = _small_model(["NerfMLP.net_activation = 'softplus'"])
  lm = torch.zeros(2, 8, NB)
  with torch.no_grad(), pytest.raises(ValueError, match='lifted'):
    model.nerf_mlp((torch.zeros(2, 8, 3), None), torch.ones(2, 3) / 3**0.5,
                   lifted=(lm, lm))
