"""The port's eval path against the JAX package, on the CPU.

- render.volumetric_rendering's extras (composited normals, roughness and
  tint, distance_mean, the distance percentiles) and the five sRGB
  mappings; stepfun.weighted_percentile.
- Model with compute_extras (every level's buffers and ray bundles, the
  proposal bundles' averaged colours), as the flagship gin's small cut runs
  it and with all six fuse flags (the MLP's normals, normals_pred,
  roughness, tint, diffuse and specular under the fused stages), and with
  each sRGB mapping of Config.srgb_mapping_type.
- render_image: against JAX renderer.render_image with compute_extras
  (padding, the ray-bundle merge, the vis_num_rays subsample), chunked
  against one chunk, and deferred (fetch=False) against eager.
- ops/image: ssim, color_correct (float64), downsample and the conversions;
  metrics.MetricHarness and VGGLPIPS on a random-weights npz the test writes;
  eval_metrics against the JAX eval loop's arithmetic.
- losses.compute_data_loss with the disparity and normal metrics.

Tolerances. Composited buffers of the same inputs: 1e-6 (f32 sums in
another order). The Model and render_image: 1e-4, as
tests/test_torch_port_model.py's slice (the level-1 samples follow the
level-0 weights, summed in another order); the distance percentiles read
the CDF of those weights, 1e-4 too. SSIM and PSNR in f32: 1e-5; the
colour-corrected image in f64: 1e-9; LPIPS 1e-5 relative.
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refnerf_tpu import configs as jconfigs
from refnerf_tpu import metrics as jmetrics
from refnerf_tpu.cameras import rays as jrays
from refnerf_tpu.models import construct as jconstruct
from refnerf_tpu.models import render as jrender
from refnerf_tpu.models import renderer as jrenderer
from refnerf_tpu.ops import image as jimage
from refnerf_tpu.ops import ref_utils as jref_utils
from refnerf_tpu.ops import stepfun as jstepfun
from refnerf_tpu.train import losses as jlosses
from refnerf_tpu_torch import configs
from refnerf_tpu_torch import convert
from refnerf_tpu_torch import metrics
from refnerf_tpu_torch.cameras import rays as rays_lib
from refnerf_tpu_torch.models import construct
from refnerf_tpu_torch.models import render
from refnerf_tpu_torch.models import renderer
from refnerf_tpu_torch.ops import image as image_ops
from refnerf_tpu_torch.ops import ref_utils
from refnerf_tpu_torch.ops import stepfun
from refnerf_tpu_torch.train import losses

torch.set_num_threads(1)

GIN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   'configs', 'blender_refnerf.gin')
SMALL = [
    'NerfMLP.net_depth = 4', 'NerfMLP.net_width = 32',
    'NerfMLP.net_depth_viewdirs = 4', 'NerfMLP.net_width_viewdirs = 32',
    'NerfMLP.skip_layer = 2', 'NerfMLP.bottleneck_width = 16',
    'Model.num_prop_samples = 16', 'Model.num_nerf_samples = 16',
    "NerfMLP.fused_trunk = 'on'", 'NerfMLP.fused_block = 16',
]
SIX = ['NerfMLP.fuse_dir_enc = True', 'NerfMLP.fuse_dir_geo = True',
       'NerfMLP.fuse_dir_rgb = True', 'NerfMLP.fuse_ipe_trig = True',
       'NerfMLP.fuse_compositing = True', 'NerfMLP.fuse_lift = True']
MODEL_TOL = 1e-4


def _t(x):
  return torch.tensor(np.ascontiguousarray(x))


def _close(a, b, tol, msg=''):
  np.testing.assert_allclose(np.asarray(a.detach().float()),
                             np.asarray(b, np.float32), rtol=tol, atol=tol,
                             err_msg=msg)


# ----------------------------------------------------------------- render


def _composite_inputs(seed=0, n=7, s=9):
  rng = np.random.default_rng(seed)
  w = rng.uniform(0, 1, (n, s)).astype(np.float32)
  w = (w / w.sum(-1, keepdims=True) * rng.uniform(0.2, 1.0, (n, 1))).astype(
      np.float32)
  tdist = np.sort(rng.uniform(2, 6, (n, s + 1)), -1).astype(np.float32)
  col = lambda: rng.uniform(-0.1, 1.4, (n, s, 3)).astype(np.float32)
  extras = {'normals': rng.normal(size=(n, s, 3)).astype(np.float32),
            'normals_pred': rng.normal(size=(n, s, 3)).astype(np.float32),
            'roughness': rng.uniform(0, 1, (n, s, 1)).astype(np.float32),
            'tint': rng.uniform(0, 1, (n, s, 3)).astype(np.float32),
            'normals_none': None}
  far = np.full((n, 1), 6.5, np.float32)
  return col(), col(), col(), w, tdist, far, extras


@pytest.mark.parametrize('mapping', ['none', 'linear', 'norm_linear', 'srgb',
                                     'norm_srgb'])
def test_volumetric_rendering_extras_match_jax(mapping):
  rgbs, diffuse, specular, w, tdist, far, extras = _composite_inputs()
  want = jrender.volumetric_rendering(
      rgbs, diffuse, specular, w, tdist, 1.0, far, True,
      extras={k: v for k, v in extras.items()}, srgb_mapping=mapping)
  got = render.volumetric_rendering(
      _t(rgbs), _t(diffuse), _t(specular), _t(w), _t(tdist), 1.0, _t(far),
      True, extras={k: None if v is None else _t(v)
                    for k, v in extras.items()}, srgb_mapping=mapping)
  assert set(got) == set(want)
  for k in got:
    _close(got[k], want[k], 1e-6, k)
  plain = render.volumetric_rendering(_t(rgbs), _t(diffuse), _t(specular),
                                      _t(w), _t(tdist), 1.0)
  assert set(plain) == {'rgb', 'diffuse', 'specular', 'distance', 'acc'}


def test_volumetric_rendering_rejects_an_unknown_mapping():
  rgbs, diffuse, specular, w, tdist, _, _ = _composite_inputs()
  with pytest.raises(ValueError, match='Mapping types'):
    render.volumetric_rendering(_t(rgbs), _t(diffuse), _t(specular), _t(w),
                                _t(tdist), 1.0, srgb_mapping='gamma')


def test_weighted_percentile_matches_jax():
  rng = np.random.default_rng(1)
  t = np.sort(rng.uniform(0, 5, (6, 11)), -1).astype(np.float32)
  w = rng.uniform(0, 1, (6, 10)).astype(np.float32)
  w[2, 3:7] = 0  # flat stretches of the CDF
  w = (w / w.sum(-1, keepdims=True)).astype(np.float32)
  ps = [5, 25, 50, 95]
  _close(stepfun.weighted_percentile(_t(t), _t(w), ps),
         jstepfun.weighted_percentile(t, w, ps), 1e-6)


# ----------------------------------------------------------------- the model


def _init_params(bindings, seed=0):
  config, gin = jconfigs.parse([GIN], bindings)
  model = jconstruct.construct_model(config, gin)
  p = jax.device_get(jconstruct.init_params(jax.random.PRNGKey(seed), model))
  rng = np.random.default_rng(seed)
  return model, jax.tree_util.tree_map_with_path(
      lambda path, x: np.asarray(x) + (
          rng.normal(size=x.shape).astype(np.float32) * 0.1
          if path[-1].key == 'bias' else 0.0), p)


def _rays_np(n, seed=0):
  rng = np.random.default_rng(seed)
  d = rng.normal(size=(n, 3)).astype(np.float32)
  return dict(
      origins=rng.normal(size=(n, 3)).astype(np.float32) * 0.1,
      directions=d,
      viewdirs=d / np.linalg.norm(d, axis=-1, keepdims=True),
      radii=rng.uniform(1e-3, 1e-2, (n, 1)).astype(np.float32),
      near=np.full((n, 1), 2.0, np.float32),
      far=np.full((n, 1), 6.0, np.float32))


def _port_rays(r):
  n = r['origins'].shape[0]
  return rays_lib.Rays(**{**vars(rays_lib.dummy_rays(n)),
                          **{k: torch.tensor(v) for k, v in r.items()}})


def _jax_rays(r):
  n = r['origins'].shape[0]
  return jrays.dummy_rays(n).replace(
      **{k: jnp.asarray(v) for k, v in r.items()})


def _port_model(bindings, params):
  config, gin = configs.parse([GIN], bindings)
  model = construct.construct_model(config, gin, 'cpu')
  convert.load_jax_params(model, params)
  return model, config


MODEL_CASES = {
    'flagship': [],
    'six_fuse_flags': SIX,
    'srgb_linear': ['Config.srgb_mapping_when_rendering = True',
                    "Config.srgb_mapping_type = 'linear'"],
    'srgb_norm_linear': ['Config.srgb_mapping_when_rendering = True',
                         "Config.srgb_mapping_type = 'norm_linear'"],
    'srgb_srgb': ['Config.srgb_mapping_when_rendering = True',
                  "Config.srgb_mapping_type = 'srgb'"],
    'srgb_norm_srgb': ['Config.srgb_mapping_when_rendering = True',
                       "Config.srgb_mapping_type = 'norm_srgb'"],
}


@pytest.mark.parametrize('case', sorted(MODEL_CASES))
def test_model_extras_match_jax(case):
  bindings = SMALL + MODEL_CASES[case] + ['Config.vis_num_rays = 5']
  jmodel, params = _init_params(bindings)
  r = _rays_np(8, seed=2)
  renderings, jhistory = jax.jit(lambda p, rays: jmodel.apply(
      {'params': p}, rays, train_frac=1.0, compute_extras=True,
      train=False))(params, _jax_rays(r))
  model, _ = _port_model(bindings, params)
  with torch.no_grad():
    port, history = model(_port_rays(r), compute_extras=True)
  for level in range(2):
    assert set(port[level]) == set(renderings[level]), level
    for k, v in port[level].items():
      assert v.shape == renderings[level][k].shape, k
      _close(v, renderings[level][k], MODEL_TOL, f'level {level}: {k}')
    # F6: the fused stages keep every per-sample output the extras read.
    keys = {'normals', 'normals_pred', 'roughness', 'tint', 'diffuse',
            'specular'}
    assert keys <= set(history[level]) and keys <= set(jhistory[level])
    for k in keys - {'normals'}:
      _close(history[level][k], jhistory[level][k], MODEL_TOL, k)
  assert port[-1]['ray_rgbs'].shape == (5, 16, 3)
  # The proposal level's bundle shows the final level's average colour.
  np.testing.assert_array_equal(port[0]['ray_rgbs'][:, 0].numpy(),
                                port[0]['ray_rgbs'][:, -1].numpy())


def test_render_image_matches_jax():
  bindings = SMALL + ['Config.vis_num_rays = 3',
                      'Config.render_chunk_size = 16']
  jmodel, params = _init_params(bindings)
  jconfig, _ = jconfigs.parse([GIN], bindings)
  r = _rays_np(30, seed=5)
  shape = (5, 6)
  jrays_hw = _jax_rays(r).reshape(*shape)
  want = jrenderer.render_image(
      jrenderer.make_render_fn(jmodel, params, compute_extras=True),
      jrays_hw, jconfig)
  model, config = _port_model(bindings, params)
  rays = _port_rays(r).reshape(*shape)
  got = renderer.render_image(model, rays, config.render_chunk_size,
                              compute_extras=True,
                              vis_num_rays=config.vis_num_rays)
  assert set(got) == set(want)
  for k, v in got.items():
    if k.startswith('ray_'):
      assert len(v) == len(want[k]) == 2
      for level, (a, b) in enumerate(zip(v, want[k])):
        assert a.shape == b.shape
        _close(a, b, MODEL_TOL, f'{k} {level}')
    else:
      assert v.shape == want[k].shape and v.device.type == 'cpu'
      _close(v, want[k], MODEL_TOL, k)


def test_render_image_chunked_and_deferred_match_one_chunk():
  bindings = SMALL
  _, params = _init_params(bindings, seed=3)
  model, _ = _port_model(bindings, params)
  rays = _port_rays(_rays_np(20, seed=6)).reshape(4, 5)
  whole = renderer.render_image(model, rays, 20, compute_extras=True)
  chunked = renderer.render_image(model, rays, 8, compute_extras=True)
  finish = renderer.render_image(model, rays, 8, compute_extras=True,
                                 fetch=False)
  assert callable(finish)
  deferred = finish()
  for k, v in whole.items():
    if k.startswith('ray_'):
      continue  # the bundles come from each chunk's first rays
    torch.testing.assert_close(chunked[k], v, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(deferred[k], chunked[k], rtol=0, atol=0)
  for k in ('ray_sdist', 'ray_weights', 'ray_rgbs'):
    for a, b in zip(deferred[k], chunked[k]):
      torch.testing.assert_close(a, b, rtol=0, atol=0)
  plain = renderer.render_image(model, rays, 8)
  assert not any(k.startswith(('ray_', 'distance_')) for k in plain)
  torch.testing.assert_close(plain['rgb'], chunked['rgb'], rtol=0, atol=0)


# ----------------------------------------------------------------- metrics


def _images(seed=0, shape=(24, 20, 3)):
  rng = np.random.default_rng(seed)
  gt = np.clip(rng.uniform(0, 1, shape) * 0.8 + 0.1, 0, 1)
  pred = np.clip(gt ** 1.3 * 0.9 + 0.05 + rng.normal(0, 0.03, shape), 0, 1)
  pred[:3, :4] = 1.0  # saturated pixels, which color_correct masks out
  return pred, gt


def test_image_ops_match_jax():
  pred, gt = _images()
  p32, g32 = pred.astype(np.float32), gt.astype(np.float32)
  np.testing.assert_allclose(float(image_ops.ssim(_t(p32), _t(g32))),
                             float(jimage.ssim(p32, g32)), rtol=1e-5)
  _close(image_ops.ssim(_t(p32), _t(g32), return_map=True),
         jimage.ssim(p32, g32, return_map=True), 1e-5)
  cc = image_ops.color_correct(_t(pred), _t(gt))
  assert cc.dtype == torch.float64
  np.testing.assert_allclose(cc.numpy(), jimage.color_correct(pred, gt),
                             rtol=1e-9, atol=1e-9)
  _close(image_ops.downsample(_t(p32), 4), jimage.downsample(p32, 4), 1e-6)
  with pytest.raises(ValueError, match='evenly divide'):
    image_ops.downsample(_t(p32), 7)
  psnr = np.array([12.5, 30.0], np.float32)
  _close(image_ops.psnr_to_mse(_t(psnr)), jimage.psnr_to_mse(psnr), 1e-6)
  assert image_ops.dssim_to_ssim(image_ops.ssim_to_dssim(0.25)) == 0.25
  assert image_ops.ssim_to_dssim(0.25) == jimage.ssim_to_dssim(0.25)


def test_color_correct_of_a_fully_saturated_image_matches_jax():
  # Every row masked: the normal equations are all zero and the solve
  # falls back to the minimum-norm solution, as JAX's lstsq does.
  pred = np.ones((6, 5, 3))
  gt = _images(1, (6, 5, 3))[1]
  np.testing.assert_allclose(
      image_ops.color_correct(_t(pred), _t(gt)).numpy(),
      jimage.color_correct(pred, gt), rtol=1e-9, atol=1e-9)


# VGG16's conv layers with LPIPS's taps; the widths are cut to a few
# channels (the harness reads them from the weights).
LPIPS_WIDTHS = {0: 4, 2: 4, 5: 6, 7: 6, 10: 8, 12: 8, 14: 8, 17: 8, 19: 8,
                21: 8, 24: 8, 26: 8, 28: 8}


def _lpips_weights(path):
  rng = np.random.default_rng(7)
  arrays, cin = {}, 3
  for cid, cout in LPIPS_WIDTHS.items():
    arrays[f'features_{cid}_weight'] = rng.normal(
        0, 0.3, (cout, cin, 3, 3)).astype(np.float32)
    arrays[f'features_{cid}_bias'] = rng.normal(0, 0.1, (cout,)).astype(
        np.float32)
    cin = cout
  for k, cid in enumerate((2, 7, 14, 21, 28)):
    arrays[f'lin{k}_weight'] = rng.uniform(
        0, 1, (1, LPIPS_WIDTHS[cid], 1, 1)).astype(np.float32)
  np.savez(path, **arrays)
  return path


def test_metric_harness_and_lpips_match_jax(tmp_path):
  pred, gt = _images(2, (32, 32, 3))
  weights = _lpips_weights(str(tmp_path / 'lpips.npz'))
  want = jmetrics.MetricHarness(compute_lpips=True, lpips_weights=weights)(
      pred, gt)
  got = metrics.MetricHarness(compute_lpips=True, lpips_weights=weights,
                              device='cpu')(torch.tensor(pred),
                                            torch.tensor(gt))
  assert set(got) == set(want) == {'psnr', 'ssim', 'lpips'}
  for k in got:
    np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
  with pytest.warns(UserWarning, match='LPIPS requested'):
    metrics._LPIPS_WARNED[0] = False
    assert 'lpips' not in metrics.MetricHarness(
        compute_lpips=True, lpips_weights=str(tmp_path / 'absent.npz'),
        device='cpu')(pred, gt)


@pytest.mark.parametrize('quantize,crop', [(True, 0), (False, 3)])
def test_eval_metrics_match_the_jax_eval_loop(quantize, crop):
  pred, gt = _images(3)
  config = dataclasses.replace(configs.Config(), eval_quantize_metrics=quantize,
                               eval_crop_borders=crop)
  got, got_cc, rgb_cc = metrics.eval_metrics(
      metrics.MetricHarness(device='cpu'), torch.tensor(pred), gt, config)
  # system.py:458-479, on the JAX package's functions.
  cc = jimage.color_correct(pred, gt)
  a, a_cc, g = pred, cc, gt
  if quantize:
    a, a_cc = np.round(a * 255) / 255, np.round(a_cc * 255) / 255
  if crop:
    a, a_cc, g = (x[crop:-crop, crop:-crop] for x in (a, a_cc, g))
  harness = jmetrics.MetricHarness()
  for m, want in ((got, harness(a, g)), (got_cc, harness(a_cc, g))):
    for k in ('psnr', 'ssim'):
      np.testing.assert_allclose(m[k], want[k], rtol=1e-5, err_msg=k)
  np.testing.assert_allclose(rgb_cc.numpy(), cc, rtol=1e-9, atol=1e-9)


# ----------------------------------------------------------------- losses


def test_data_loss_metrics_match_jax():
  rng = np.random.default_rng(8)
  n = 10
  unit = lambda v: v / np.linalg.norm(v, axis=-1, keepdims=True)
  levels = []
  for _ in range(2):
    levels.append({
        'rgb': rng.uniform(0, 1, (n, 3)).astype(np.float32),
        'distance_mean': rng.uniform(2, 6, (n,)).astype(np.float32),
        'normals': rng.normal(size=(n, 3)).astype(np.float32),
        'acc': rng.uniform(0, 1, (n,)).astype(np.float32)})
  levels[0]['normals'] = None  # a level without normals logs NaN
  batch = dict(rgb=rng.uniform(0, 1, (n, 3)).astype(np.float32),
               disps=rng.uniform(0, 1, (n,)).astype(np.float32),
               normals=unit(rng.normal(size=(n, 3))).astype(np.float32),
               alphas=rng.uniform(0, 1, (n,)).astype(np.float32))
  lossmult = rng.uniform(0.5, 1, (n, 1)).astype(np.float32)
  config = dataclasses.replace(configs.Config(), compute_disp_metrics=True,
                               compute_normal_metrics=True)
  jconfig = dataclasses.replace(jconfigs.Config(), compute_disp_metrics=True,
                                compute_normal_metrics=True)
  jbatch = jrays.Batch(rays=None, **{k: jnp.asarray(v)
                                     for k, v in batch.items()})
  jrays_ = jrays.dummy_rays(n).replace(lossmult=jnp.asarray(lossmult))
  jloss, jstats = jlosses.compute_data_loss(
      jbatch, [{k: None if v is None else jnp.asarray(v)
                for k, v in r.items()} for r in levels], jrays_, jconfig)
  pbatch = rays_lib.Batch(rays=None, **{k: _t(v) for k, v in batch.items()})
  prays = rays_lib.dummy_rays(n)
  prays.lossmult = _t(lossmult)
  loss, stats = losses.compute_data_loss(
      pbatch, [{k: None if v is None else _t(v) for k, v in r.items()}
               for r in levels], prays, config)
  np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
  assert set(stats) == set(jstats) == {'mses', 'disparity_mses',
                                       'normal_maes'}
  for k in stats:
    np.testing.assert_allclose(stats[k].numpy(), np.asarray(jstats[k]),
                               rtol=1e-5, err_msg=k)
  assert math.isnan(float(stats['normal_maes'][0]))
  w = _t(batch['alphas'])
  np.testing.assert_allclose(
      float(ref_utils.compute_weighted_mae(w, _t(batch['normals']),
                                           _t(batch['normals'][::-1]))),
      float(jref_utils.compute_weighted_mae(
          jnp.asarray(batch['alphas']), jnp.asarray(batch['normals']),
          jnp.asarray(batch['normals'][::-1]))), rtol=1e-5)


def test_color_correct_of_a_near_constant_render_is_stable():
  # A render whose colours vary little (an untrained model's) makes the
  # least squares ill-conditioned. The JAX package solves its normal
  # equations, whose smallest singular values are then rounding noise: the
  # pixels' order moves its cc-PSNR by dB. The port's QR solve moves it by
  # less than 1e-6 dB.
  rng = np.random.default_rng(9)
  gt = _images(4, (60, 60, 3))[1]
  base = np.array([0.45, 0.62, 0.38])
  pred = np.clip(base + rng.normal(0, 2.8e-4, gt.shape), 0, 1)
  perm = rng.permutation(60 * 60)
  psnr = lambda x: -10 * np.log10(np.mean((x - gt)**2))
  a = image_ops.color_correct(_t(pred), _t(gt)).numpy()
  b = image_ops.color_correct(_t(pred.reshape(-1, 3)[perm]),
                              _t(gt.reshape(-1, 3)[perm])).numpy()
  unpermuted = np.empty_like(b)
  unpermuted[perm] = b
  assert abs(psnr(a) - psnr(unpermuted.reshape(a.shape))) < 1e-6


@pytest.mark.parametrize('noise,atol', [(1e-3, 1e-3), (3e-3, 1e-5)])
def test_color_correct_near_the_cut_off_matches_jax(noise, atol):
  # Renders whose colours vary little enough that the smallest singular
  # value of the least squares lies within 100 times the port's cut-off
  # (JAX's lstsq cut-off on the normal equations, taken to the system):
  # both solvers keep it, and agree. JAX's own answer moves with the pixels'
  # order by 2.8e-4 at noise 1e-3 and 5e-6 at 3e-3. A cut-off 10 times
  # higher (at noise 1e-3; 100 times at 3e-3) drops a singular value that
  # JAX keeps, and moves the port's answer by ~0.4.
  gt = _images(4, (60, 60, 3))[1]
  rng = np.random.default_rng(9)
  pred = np.clip(np.array([0.45, 0.62, 0.38]) + rng.normal(0, noise, gt.shape),
                 0, 1)
  flat = pred.reshape(-1, 3)
  system = np.concatenate([flat[:, :1] * flat, flat[:, 1:2] * flat[:, 1:],
                           flat[:, 2:] ** 2, flat, np.ones_like(flat[:, :1])],
                          axis=-1)
  sv = np.linalg.svd(system, compute_uv=False)
  cut_off = np.sqrt(10 * np.finfo(np.float64).eps)  # lstsq's, on the system
  assert 1 < sv[-1] / sv[0] / cut_off < 100
  want = jimage.color_correct(pred, gt)
  got = image_ops.color_correct(_t(pred), _t(gt)).numpy()
  np.testing.assert_allclose(got, want, rtol=0, atol=atol)
  psnr = lambda x: -10 * np.log10(np.mean((x - gt)**2))
  assert abs(psnr(got) - psnr(want)) < 1e-6
