"""The fused directional stage against the JAX package, on the CPU.

`NerfMLP.fuse_dir_enc`, `fuse_dir_geo` and `fuse_dir_rgb` move the IDE (K8),
the direction geometry (K9) and the colour epilogue (K10) into the
directional trunk. Here the port's plain versions of those modes are held
against JAX, which runs its Pallas kernels in interpret mode:

- function level: `fused_mlp.fused_trunk` with each mode, and all three,
  against JAX `fused_trunk`, outputs and the gradients of a random linear
  loss with respect to the parameters and every raw input but the
  viewdirs; with a case where the max of the colour epilogue ties across
  channels and sits on the gamut bound, and one with kappa_inv = 0;
- MLP level: a small cut of configs/blender_refnerf.gin with the flags on,
  eval and train, against the JAX MLP with `fused_trunk='on'` and the same
  flags (the cases of tests/test_fused_mlp_integration.py:287-504);
- slice level: two train steps against JAX `make_train_step`, and a served
  `render_rays` against JAX `Model.apply`, with the three flags.

Tolerances. float32: values within 1e-5 of the largest reference entry
(the same f32 arithmetic, summed in another order); gradients within 1e-4
of it (`_assert_grads`, as in tests/test_torch_port_train.py). bfloat16:
5e-2 (a bf16 rounding flip, 2^-8 relative, of one trunk input or activation
moves every later layer's operands).
"""

import logging
import os
import types

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
from refnerf_tpu.ops import ref_utils as jref_utils
from refnerf_tpu.ops.pallas import fused_mlp as jfused
from refnerf_tpu.train import step as jstep
from refnerf_tpu_torch import configs
from refnerf_tpu_torch import convert
from refnerf_tpu_torch.cameras import rays as rays_lib
from refnerf_tpu_torch.models import construct
from refnerf_tpu_torch.models import mlp as mlp_lib
from refnerf_tpu_torch.models import renderer
from refnerf_tpu_torch.ops import fused_mlp
from refnerf_tpu_torch.ops import ref_utils
from refnerf_tpu_torch.train import step as step_lib

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIN = os.path.join(REPO, 'configs', 'blender_refnerf.gin')
FUSE = ['NerfMLP.fuse_dir_enc = True', 'NerfMLP.fuse_dir_geo = True',
        'NerfMLP.fuse_dir_rgb = True']
DEPTH, WIDTH, SKIP = 4, 32, 2


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


def _unit(rng, shape):
  v = rng.normal(size=shape).astype(np.float32)
  return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_ide_tables_match_jax():
  for deg in (2, 3, 5):
    for a, b in zip(ref_utils.ide_tables(deg), jfused.ide_tables(deg)):
      np.testing.assert_array_equal(a, np.asarray(b))
  mat, sg, gm = ref_utils.ide_tables(5)
  assert mat.shape == gm.shape == (17, 36) and sg.shape == (1, 36)


# At deg_view 5 the IDE's l = 16 harmonics are polynomials of degree 16 in
# z whose terms reach ~3e5 and cancel to values below 1, so in float32 their
# value depends on the summation order by up to ~1e-2 (measured: torch's
# matmul, sequential sums and float64 each differ from XLA's dot by 8e-3 to
# 9e-3 of z-polynomials of up to 660, 6e-4 of an IDE entry of up to 0.56).
# With kappa_inv >= 0.05 the attenuation exp(-136 kappa_inv) leaves those
# harmonics below ~1e-3 of the encoding; with kappa_inv = 0 only a lower
# degree compares at 1e-5 (ROADMAP H9). So deg_view 5 runs with kappa_inv
# in [0.05, 0.5], and kappa_inv = 0 at deg_view 3.
IDE_CASES = {'deg5': (5, 0.05), 'deg3_kappa0': (3, 0.0)}


def _kappa_inv(rng, shape, low):
  return (rng.uniform(0.05, 0.5, shape) if low else
          np.zeros(shape)).astype(np.float32)


@pytest.mark.parametrize('case', sorted(IDE_CASES))
def test_ide_forward_and_backward_match_jax(case):
  # The plain fused IDE against JAX's own in-kernel functions (`_ide_fwd`,
  # `_ide_bwd`, run as plain jnp) and its forward against generate_ide_fn,
  # float32: values 1e-5 of the largest entry, gradients 1e-4.
  deg, low = IDE_CASES[case]
  rng = np.random.default_rng(0)
  d = _unit(rng, (40, 3))
  ki = _kappa_inv(rng, (40, 1), low)
  p = ref_utils.ide_constants(deg)[0].shape[1]
  cot = rng.normal(size=(40, 2 * p)).astype(np.float32)
  cfg = types.SimpleNamespace(ide=deg)
  tabs = dict(zip(('mat', 'sg', 'gm'),
                  (jnp.asarray(a) for a in jfused.ide_tables(deg))))
  jre, jim, aux = jfused._ide_fwd(cfg, tabs, jnp.asarray(d), jnp.asarray(ki))
  want = jfused._ide_bwd(cfg, tabs, aux, jnp.asarray(cot[:, :p]),
                         jnp.asarray(cot[:, p:]))
  enc = jref_utils.generate_ide_fn(deg)(jnp.asarray(d), jnp.asarray(ki))
  re, im = fused_mlp.ide_forward(_t(d), _t(ki), deg)
  _assert_grads(torch.cat([re, im], 1), _np(enc), 1e-5, 'ide')
  _assert_grads(re, _np(jre), 1e-5, 're')
  _assert_grads(im, _np(jim), 1e-5, 'im')
  got = fused_mlp.ide_backward(_t(d), _t(ki), deg, _t(cot[:, :p]),
                               _t(cot[:, p:]))
  _assert_grads(got[0], _np(want[0]), 1e-4, 'd refdirs')
  _assert_grads(got[1], _np(want[1]), 1e-4, 'd kappa_inv')


def _params(rng, fin, tie=False):
  """Flax-layout directional trunk and rgb head; with `tie` the head's
  three channels are equal, so the colour epilogue's max ties."""
  skips = jfused.skip_input_layers(DEPTH, SKIP)
  ks, bs = [], []
  for l in range(DEPTH):
    ind = fin if l == 0 else WIDTH + (fin if l in skips else 0)
    ks.append((rng.normal(size=(ind, WIDTH)) / np.sqrt(ind)).astype(np.float32))
    bs.append((rng.normal(size=(WIDTH,)) * 0.1).astype(np.float32))
  wh = (rng.normal(size=(WIDTH, 3)) / np.sqrt(WIDTH)).astype(np.float32)
  bh = (rng.normal(size=(3,)) * 0.1).astype(np.float32)
  if tie:
    wh[:] = wh[:, :1]
    bh[:] = 3.0
  return ks, bs, wh, bh


# (ide, geo, rgb, tie, compute dtype, IDE case): the modes one by one, all
# three, the epilogue's ties, kappa_inv = 0 (at deg_view 3, see IDE_CASES)
# and the bf16 trunk.
FN_CASES = {
    'ide': (True, False, False, False, 'float32', 'deg5'),
    'ide_geo': (True, True, False, False, 'float32', 'deg5'),
    'rgb': (False, False, True, False, 'float32', 'deg5'),
    'all': (True, True, True, False, 'float32', 'deg5'),
    'all_ties': (True, True, True, True, 'float32', 'deg5'),
    'all_kappa0': (True, True, True, False, 'float32', 'deg3_kappa0'),
    'all_bf16': (True, True, True, False, 'bfloat16', 'deg5'),
}


@pytest.mark.parametrize('case', sorted(FN_CASES))
def test_fused_trunk_modes_match_pallas(case):
  ide, geo, rgb, tie, cdt, ide_case = FN_CASES[case]
  deg, low = IDE_CASES[ide_case]
  bott = 16
  p = ref_utils.ide_constants(deg)[0].shape[1]
  lead = (5, 13)  # 65 samples: ragged against the Pallas block of 32
  rng = np.random.default_rng(sorted(FN_CASES).index(case))
  bottleneck = rng.normal(size=lead + (bott,)).astype(np.float32)
  grad = rng.normal(size=lead + (3,)).astype(np.float32)
  vdirs = _unit(rng, lead + (3,))
  refdirs = _unit(rng, lead + (3,))
  ki = _kappa_inv(rng, lead + (1,), low)
  nd = rng.uniform(-1, 1, lead + (1,)).astype(np.float32)
  enc = rng.uniform(-1, 1, lead + (2 * p + 1,)).astype(np.float32)
  rawd = rng.normal(size=lead + (3,)).astype(np.float32)
  rawt = rng.normal(size=lead + (3,)).astype(np.float32)
  if tie:
    rawd[:], rawt[:] = 3.0, 3.0
  ks, bs, wh, bh = _params(rng, bott + 2 * p + 1, tie)
  cot = rng.normal(size=lead + (3,)).astype(np.float32)
  cot_rgb = rng.normal(size=lead + (3,)).astype(np.float32)
  consts = (1.5, -0.1, 0.001)
  if not ide:
    names, inputs = ['bottleneck', 'enc'], [bottleneck, enc]
  elif geo:
    names, inputs = ['bottleneck', 'grad', 'viewdirs', 'kappa_inv'], [
        bottleneck, grad, vdirs, ki]
  else:
    names, inputs = ['bottleneck', 'refdirs', 'kappa_inv', 'n.v'], [
        bottleneck, refdirs, ki, nd]
  nr = (3 if geo else 2) if ide else 0

  def nest(xs):
    return [xs[0], tuple(xs[1:1 + nr])] + list(xs[1 + nr:]) if ide else xs

  fuse = dict(ide_deg=deg if ide else 0, ide_at=1, ide_geo=geo)

  def jloss(q):
    xs, jks, jbs, jwh, jbh, jrd, jrt = q
    outs = jfused.fused_trunk(
        nest(xs), jks, jbs, head_f32=(jwh, jbh), out_y=False,
        skip_period=SKIP, needs_dx=True, compute_dtype=cdt, block=32,
        rgb_epilogue=(jrd, jrt, *consts) if rgb else None, **fuse)
    outs = outs if rgb else (outs,)
    loss = jnp.sum(outs[0] * cot)
    if rgb:
      loss = loss + jnp.sum(outs[1] * cot_rgb)
    return loss, outs

  q = ([jnp.asarray(x) for x in inputs], [jnp.asarray(k) for k in ks],
       [jnp.asarray(b) for b in bs], jnp.asarray(wh), jnp.asarray(bh),
       jnp.asarray(rawd), jnp.asarray(rawt))
  (_, jouts), jg = jax.value_and_grad(jloss, has_aux=True)(q)

  xs = [_t(x).requires_grad_(True) for x in inputs]
  tws = [_t(k.T).requires_grad_(True) for k in ks]
  tbs = [_t(b).requires_grad_(True) for b in bs]
  twh, tbh = _t(wh.T).requires_grad_(True), _t(bh).requires_grad_(True)
  trd, trt = _t(rawd).requires_grad_(True), _t(rawt).requires_grad_(True)
  outs = fused_mlp.fused_trunk(
      nest(xs), tws, tbs, (twh, tbh), skip_period=SKIP, compute_dtype=cdt,
      rgb_epilogue=(trd, trt, *consts) if rgb else None, **fuse)
  outs = outs if rgb else (outs,)
  vtol, gtol = (1e-5, 1e-4) if cdt == 'float32' else (5e-2, 5e-2)
  for name, a, b in zip(('raw rgb', 'rgb'), outs, jouts):
    assert tuple(a.shape) == lead + (3,)
    _assert_grads(a, _np(b), vtol, name)
  if tie:
    assert float(jnp.max(jouts[1])) == pytest.approx(1.001, abs=1e-6)
  loss = torch.sum(outs[0] * _t(cot))
  if rgb:
    loss = loss + torch.sum(outs[1] * _t(cot_rgb))
  leaves = [x for x, nm in zip(xs, names) if nm != 'viewdirs']
  leaves += tws + tbs + [twh, tbh] + ([trd, trt] if rgb else [])
  got = torch.autograd.grad(loss, leaves)
  jxs, jks, jbs, jwh, jbh, jrd, jrt = jg
  want = [g for g, nm in zip(jxs, names) if nm != 'viewdirs']
  want += [k.T for k in jks] + list(jbs) + [jwh.T, jbh]
  want += [jrd, jrt] if rgb else []
  what = [nm for nm in names if nm != 'viewdirs'] + [
      f'leaf {i}' for i in range(len(want))]
  for a, b, w in zip(got, want, what):
    _assert_grads(a, _np(b), gtol, w)


# MLP level: a small cut of the flagship gin (trunks of depth 3 and width
# 32 without a skip layer, bottleneck 16, deg_view 3, 8 samples per ray).
MLP_SMALL = [
    'NerfMLP.net_depth = 3', 'NerfMLP.net_width = 32',
    'NerfMLP.net_depth_viewdirs = 3', 'NerfMLP.net_width_viewdirs = 32',
    'NerfMLP.bottleneck_width = 16',
    'NerfMLP.deg_view = 3', 'NerfMLP.max_deg_point = 8',
    "NerfMLP.fused_trunk = 'on'",
]
# The flag sets of tests/test_fused_mlp_integration.py:287-482.
MLP_CASES = {
    'enc': ['NerfMLP.fuse_dir_enc = True'],
    'enc_no_roughness': ['NerfMLP.fuse_dir_enc = True',
                         'NerfMLP.enable_pred_roughness = False'],
    'enc_no_reflections': [
        'NerfMLP.fuse_dir_enc = True', 'NerfMLP.use_reflections = False',
        'NerfMLP.enable_pred_normals = False',
        'NerfMLP.disable_density_normals = True',
        'NerfMLP.enable_pred_roughness = False',
        'NerfMLP.use_n_dot_v = False'],
    'rgb': ['NerfMLP.fuse_dir_rgb = True', 'NerfMLP.rgb_premultiplier = 1.5',
            'NerfMLP.rgb_bias = -0.1'],
    'enc_rgb': ['NerfMLP.fuse_dir_enc = True', 'NerfMLP.fuse_dir_rgb = True'],
    'geo': ['NerfMLP.fuse_dir_enc = True', 'NerfMLP.fuse_dir_geo = True'],
    'all': FUSE,
    'rgb_inactive': ['NerfMLP.fuse_dir_rgb = True',
                     'NerfMLP.srgb_mapping_normalization = False'],
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


def _gaussians(seed, n_rays=5, s=8):
  rng = np.random.default_rng(seed)
  d = rng.normal(size=(n_rays, 3)).astype(np.float32)
  tdist = np.sort(rng.uniform(2, 6, (n_rays, s + 1)), axis=-1).astype(np.float32)
  means, covs = jrender.cast_rays(
      jnp.asarray(tdist), jnp.asarray(rng.normal(size=(n_rays, 3)) * 0.1,
                                      jnp.float32),
      jnp.asarray(d), jnp.full((n_rays, 1), 0.005, jnp.float32), 'cone',
      diag=False)
  return (np.asarray(means), np.asarray(covs),
          d / np.linalg.norm(d, axis=-1, keepdims=True))


def _mlp_loss(xp, r):
  """The loss of the integration tests: colour, density, the normals'
  agreement (second order through the density normals) and roughness."""
  t = xp.mean((r['rgb'] - 0.5)**2) + xp.mean(r['density'])
  if 'normals_pred' in r:
    t = t + xp.mean(xp.sum(r['normals'] * r['normals_pred'], -1))
  if 'roughness' in r:
    t = t + xp.mean(r['roughness'])
  return t


@pytest.mark.parametrize('train', [False, True])
@pytest.mark.parametrize('case', sorted(MLP_CASES))
def test_mlp_with_dir_fusions_matches_jax(case, train):
  bindings = MLP_SMALL + MLP_CASES[case]
  seed = sorted(MLP_CASES).index(case)
  params = _init_params(bindings, seed)
  _, jgin = jconfigs.parse([GIN], bindings)
  jmlp = JaxMLP(**jconfigs.mlp_kwargs(jgin, 'NerfMLP'))
  means, covs, viewdirs = _gaussians(seed)
  jin = ((jnp.asarray(means), jnp.asarray(covs)), jnp.asarray(viewdirs))

  def japply(p):
    return jmlp.apply({'params': p}, *jin, None, train)

  ref = japply(params['nerf_mlp'])
  config, gin = configs.parse([GIN], bindings)
  model = construct.construct_model(config, gin, 'cpu')
  convert.load_jax_params(model, params)
  mlp = model.nerf_mlp
  tin = ((_t(means), _t(covs)), _t(viewdirs))
  with torch.set_grad_enabled(train):
    out = mlp(*tin, train=train)
  assert set(out) == set(ref)
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


def test_inactive_fusion_flag_is_logged_once(caplog):
  # fuse_dir_rgb without gamut normalisation cannot act: one warning over two
  # calls, as JAX's _warn_fused_fallback does.
  mlp_lib._FALLBACK_WARNED.clear()
  bindings = MLP_SMALL + MLP_CASES['rgb_inactive']
  config, gin = configs.parse([GIN], bindings)
  mlp = construct.construct_model(config, gin, 'cpu').nerf_mlp
  means, covs, viewdirs = _gaussians(0)
  with caplog.at_level(logging.WARNING), torch.no_grad():
    for _ in range(2):
      mlp((_t(means), _t(covs)), _t(viewdirs))
  hits = [r for r in caplog.records
          if 'fuse_dir_rgb inactive' in r.getMessage()]
  assert len(hits) == 1


SLICE = [
    'NerfMLP.net_depth = 4', 'NerfMLP.net_width = 32',
    'NerfMLP.net_depth_viewdirs = 4', 'NerfMLP.net_width_viewdirs = 32',
    'NerfMLP.skip_layer = 2', 'NerfMLP.bottleneck_width = 16',
    'Model.num_prop_samples = 16', 'Model.num_nerf_samples = 16',
    'Config.sample_noise_size = 0', 'Config.batch_size = 12',
    "NerfMLP.fused_trunk = 'on'",
] + FUSE


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


def test_train_steps_with_dir_fusions_match_jax():
  # Two steps of the small flagship cut with the three flags, float32, as
  # test_train_step_matches_jax: the loss terms, loss and psnr 1e-5
  # relative; the parameters 2e-2 of the largest move of each.
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
  rays = rays_lib.dummy_rays(12)
  for k, v in b.items():
    if k != 'rgb':
      setattr(rays, k, _t(v))
  batch = rays_lib.Batch(rays=rays, rgb=_t(b['rgb']))
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


def test_served_request_with_dir_fusions_matches_jax():
  # One render_rays request (2 chunks) against JAX Model.apply, float32,
  # 1e-4 as for the unfused slice (test_slice_matches_jax_model).
  bindings = SLICE
  params = _init_params(bindings, 1)
  jconfig, jgin = jconfigs.parse([GIN], bindings)
  jmodel = jconstruct.construct_model(jconfig, jgin)
  b = _batch_np(10, seed=1)
  jr = jrays.dummy_rays(10).replace(**{k: jnp.asarray(v) for k, v in
                                       b.items() if k != 'rgb'})
  renderings, _ = jax.jit(lambda p, r: jmodel.apply(
      {'params': p}, r, train_frac=1.0, compute_extras=False,
      train=False))(params, jr)
  config, gin = configs.parse([GIN], bindings)
  model = construct.construct_model(config, gin, 'cpu')
  convert.load_jax_params(model, params)
  rays = rays_lib.dummy_rays(10)
  for k, v in b.items():
    if k != 'rgb':
      setattr(rays, k, _t(v))
  out = renderer.render_rays(model, rays, 8)
  for k in ('rgb', 'acc', 'distance'):
    np.testing.assert_allclose(out[k].numpy(), _np(renderings[-1][k]),
                               rtol=1e-4, atol=1e-4, err_msg=k)


def test_construct_model_defaults_to_the_gpu():
  config, gin = configs.parse([GIN], SLICE)
  if torch.cuda.is_available():
    model = construct.construct_model(config, gin)
    assert next(model.parameters()).is_cuda
  else:
    with pytest.raises(RuntimeError, match="device='cpu'"):
      construct.construct_model(config, gin)
