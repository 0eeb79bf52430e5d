"""The LLFF geometry gins' paths beyond the flat batch, on the CPU.

- One train step on [3, 2, 2] patch bundles (patch_size 2, depth
  smoothness) with the interlevel and distortion losses and a separate
  density-only PropMLP, against JAX make_train_step with JAX's noise angles.
- F8: a density-only MLP (`disable_rgb`) has JAX's parameters, no colour
  layers.
- The port's LLFF-layout sphere writer (`sphere_scene.make_llff_scene`)
  against tools/make_sphere_llff_scene.py, and its factor-4 capture loaded
  by the port's and JAX's loaders.
- H4 with the noise: configs/llff_refnerf_geometry_losses.gin trained
  through NeRFSystem from that capture, killed after step 2 and resumed to
  step 4, equals the uninterrupted run under torch.equal.
"""

import os

import jax
import numpy as np
import torch
from PIL import Image

from refnerf_tpu import configs as jconfigs
from refnerf_tpu.data import datasets as jdatasets
from refnerf_tpu.models import construct as jconstruct
from refnerf_tpu_torch import configs
from refnerf_tpu_torch import convert
from refnerf_tpu_torch import system
from refnerf_tpu_torch.data import datasets
from refnerf_tpu_torch.models import construct
from refnerf_tpu_torch.tools import sphere_scene
from refnerf_tpu_torch.train import step as step_lib
from tests.test_torch_port_losses import (GEO, PAST_WARMUP, SMALL, _Pair,
                                          _assert_grads, _check_terms, _flat)

torch.set_num_threads(1)

PROP = ['Model.single_mlp = False', 'PropMLP.net_depth = 2',
        'PropMLP.net_width = 16', 'PropMLP.disable_rgb = True',
        'PropMLP.enable_pred_normals = True']


def test_patch_step_with_interlevel_and_distortion_matches_jax():
  # One step of [3, 2, 2] patches (patch_size 2, depth smoothness on; the
  # noisy forward on sample_noise_size // 4 = 2 patches) with a separate
  # PropMLP, so that the interlevel loss is not 0, and the distortion loss.
  # JAX's plain trunks (its Pallas trunks are held in
  # tests/test_torch_port_losses.py). Tolerances as that file's two steps.
  bindings = SMALL + [
      "NerfMLP.fused_trunk = 'off'", 'Config.sample_noise_size = 8', 'Config.patch_size = 2',
      'Config.depth_smoothness_loss_mult = 0.1',
      'Config.depth_smoothness_coarse_loss_mult = 0.01',
      'Config.interlevel_loss_mult = 1.0', 'Config.distortion_loss_mult = 0.01',
      *PROP]
  pair = _Pair(bindings, (3, 2, 2), seed=1)
  jstate, state = pair.states(PAST_WARMUP)
  gap = pair.render_gap(PAST_WARMUP, jstate.params)
  train = step_lib.make_train_step(pair.model, pair.config,
                                   noise_angles=pair.angles)
  _, _, grads = train.loss_and_grads(state, pair.batch)
  jstate, jstats = pair.jtrain(jstate, pair.jbatch)
  state, stats = train(state, pair.batch)
  assert set(stats['losses']) == set(jstats['losses'])
  assert {'interlevel', 'distortion', 'smoothness'} <= set(stats['losses'])
  assert float(stats['losses']['interlevel']) > 0
  _check_terms(pair, stats, jstats, gap, PAST_WARMUP)
  want = _flat(jax.device_get(jstats['grads']))
  for k, g in grads.items():
    _assert_grads(g, want[k], 2e-4, k)


def test_density_only_mlp_has_the_jax_parameters():
  # F8: with disable_rgb the JAX MLP creates no colour layers (no
  # bottleneck, roughness, diffuse, tint, directional trunk or rgb head);
  # the port built them, so JAX's tree did not load and autograd.grad of the
  # step raised on the unused ones.
  jconfig, jgin = jconfigs.parse([GEO], SMALL + PROP)
  params = jconstruct.init_params(jax.random.PRNGKey(0),
                                  jconstruct.construct_model(jconfig, jgin))
  config, gin = configs.parse([GEO], SMALL + PROP)
  model = construct.construct_model(config, gin, 'cpu')
  assert set(model.state_dict()) == set(_flat(jax.device_get(params)))
  assert not any(k.startswith(('prop_mlp.viewdir', 'prop_mlp.rgb',
                               'prop_mlp.bottleneck'))
                 for k in model.state_dict())
  convert.load_jax_params(model, jax.device_get(params))


def test_llff_scene_matches_the_jax_writer(tmp_path):
  # The views bit for bit and the COLMAP model byte for byte against
  # tools/make_sphere_llff_scene.py (square, no factor); then a factor-4
  # capture of 1008 x 756's shape at a tenth of its size (images_4/ at
  # 100 x 76, the COLMAP camera at 400 x 304) loaded by both packages'
  # loaders: images bit for bit, poses and intrinsics 1e-6 (float64 pose
  # math in both).
  from tools import make_sphere_llff_scene as jwriter
  port = sphere_scene.make_llff_scene(str(tmp_path / 'p'), 12, 32)
  ref = jwriter.make_scene(str(tmp_path / 'j'), 12, 32, specular=True)
  names = sorted(os.listdir(os.path.join(ref, 'images')))
  assert names == sorted(os.listdir(os.path.join(port, 'images')))
  for name in names:
    np.testing.assert_array_equal(
        np.asarray(Image.open(os.path.join(port, 'images', name))),
        np.asarray(Image.open(os.path.join(ref, 'images', name))))
  for f in ('sparse/0/cameras.bin', 'sparse/0/images.bin'):
    with open(os.path.join(port, f), 'rb') as a, \
        open(os.path.join(ref, f), 'rb') as b:
      assert a.read() == b.read(), f
  np.testing.assert_array_equal(np.load(os.path.join(port, 'poses_bounds.npy')),
                                np.load(os.path.join(ref, 'poses_bounds.npy')))

  scene = sphere_scene.make_llff_scene(str(tmp_path / 'f4'), 9, 100, 76,
                                       factor=4)
  bindings = [f"Config.data_dir = '{scene}'"]
  config, _ = configs.parse([GEO], bindings)
  jconfig, _ = jconfigs.parse([GEO], bindings)
  assert config.factor == 4 and config.forward_facing
  for split in ('train', 'test'):
    ds = datasets.load_dataset(split, scene, config)
    jds = jdatasets.load_dataset(split, scene, jconfig)
    assert ds.images.shape[1:] == (76, 100, 3)
    np.testing.assert_array_equal(ds.images, jds.images)
    for k in ('camtoworlds', 'pixtocams', 'pixtocam_ndc'):
      np.testing.assert_allclose(getattr(ds, k), getattr(jds, k), rtol=0,
                                 atol=1e-6, err_msg=k)
  assert ds.pixtocams[0, 0] == np.float32(1 / 120.0)  # focal 1.2 x 100


def test_geometry_gin_resumes_bit_for_bit(tmp_path):
  # H4 with the noise: the angles come from (seed, step), so a run killed
  # after step 2 and resumed draws what the whole run drew at steps 2 and 3
  # (max_steps 4: the consistency ratio is 0, 0.417, 0.833, 1). Every
  # parameter and Adam moment equal under torch.equal.
  scene = sphere_scene.make_llff_scene(str(tmp_path / 'scene'), 9, 24, 16,
                                       factor=4)

  def trained(exp, more=()):
    config, gin = configs.parse([GEO], SMALL + [
        "NerfMLP.fused_trunk = 'auto'", f"Config.data_dir = '{scene}'",
        f"Config.checkpoint_dir = '{tmp_path / 'exp'}'",
        f"Config.exp_name = '{exp}'", 'Config.max_steps = 4',
        'Config.checkpoint_every = 2', 'Config.print_every = 2',
        'Config.val_sample_num = 1', 'Config.eval_dataset_limit = 1',
        'Config.render_chunk_size = 256', *more])
    psys = system.NeRFSystem(config, gin, device='cpu')
    psys.train()
    return psys

  whole = trained('geo_whole')
  assert whole.state.step == 4
  assert trained('geo_cut', ['Config.early_exit_steps = 2']).state.step == 2
  resumed = trained('geo_cut')
  assert resumed.state.step == 4 and resumed.state.opt.count == 4
  for k, v in whole.model.state_dict().items():
    assert torch.equal(resumed.model.state_dict()[k], v), k
  for which in ('mu', 'nu'):
    for k, v in getattr(whole.state.opt, which).items():
      assert torch.equal(getattr(resumed.state.opt, which)[k], v), (which, k)
  # The consistency losses took part: their ratio is nonzero from step 1.
  assert step_lib._consistency_enabled(whole.config)
  assert step_lib._consistency_ratio(whole.config, 2) > 0
