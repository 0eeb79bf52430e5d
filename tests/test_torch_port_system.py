"""The port's system layer against the JAX package, on the CPU.

- F7: render_image at a train_frac below 1 with Model.anneal_slope > 0,
  against JAX render_image with make_render_fn(..., train_frac=...).
- train/checkpoints.py: the round trip (bit for bit), top-k retention, the
  latest and best steps, a save without a score, an empty directory, the
  layout, and a save killed before its rename.
- NeRFSystem (device='cpu') against JAX NeRFSystem on the tiny gin of
  tests/test_system.py, from JAX's initial weights: 6 train steps with a
  checkpoint every 3 (parameters, val PSNRs, checkpoint steps), test()
  (metric files), render() (frames, the resume rule, job striding).
- Resume: 8 steps against 4 + kill + 4 in the port, equal under
  torch.equal; JAX's orbax checkpoint at step 3 continued in the port to 6,
  against JAX's uninterrupted 6 steps.

The JAX runs happen once, in a module fixture. Tolerances: parameters after
6 steps 1e-5 relative L2 (f32 sums in another order, and JAX shards the
batch over 8 CPU devices); val PSNR 1e-4 dB and the rgb metric files 1e-3
dB and 1e-5 SSIM (renders of the same weights, quantized to 1/255 before
the metrics, so a value on a rounding boundary may flip one pixel by
1/255); frames 1 in uint8 (the same boundary).
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from refnerf_tpu import configs as jconfigs
from refnerf_tpu import system as jsystem
from refnerf_tpu.data import datasets as jdatasets
from refnerf_tpu.models import renderer as jrenderer
from refnerf_tpu.train import checkpoints as jckpt
from refnerf_tpu_torch import configs
from refnerf_tpu_torch import convert
from refnerf_tpu_torch import system
from refnerf_tpu_torch.data import datasets
from refnerf_tpu_torch.models import construct
from refnerf_tpu_torch.models import renderer
from refnerf_tpu_torch.train import checkpoints as ckpt_lib
from refnerf_tpu_torch.train import step as step_lib
from tests.test_data import _make_blender_scene
from tests.test_system import _TINY
from tests.test_torch_port_eval import (GIN, SMALL, _init_params, _jax_rays,
                                        _port_model, _port_rays, _rays_np)

torch.set_num_threads(1)

# The port refuses the distortion loss (ROADMAP queue 1, item 6); the tiny
# gin leaves it at Config's default 0.01, so both packages run without it.
TINY = _TINY + '\nConfig.distortion_loss_mult = 0.\n'
PARAM_TOL = 1e-5


def _rel_l2(a, b):
  a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
  return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _bindings(scene, root, exp, extra=()):
  return [TINY, f"Config.data_dir = '{scene}'",
          f"Config.checkpoint_dir = '{root}'", f"Config.exp_name = '{exp}'",
          'Config.eval_dataset_limit = 2', *extra]


def _steps_on_disk(ckpt_dir):
  return {sub: sorted(int(n) for n in os.listdir(os.path.join(ckpt_dir, sub))
                      if n.isdigit())
          for sub in ('last', 'best')}


def _record_validations(sys_obj):
  psnrs = []
  validate = sys_obj.validate

  def wrapped(step):
    psnrs.append((step, validate(step)))
    return psnrs[-1][1]
  sys_obj.validate = wrapped
  return psnrs


def _render(sys_obj, config, load_dataset):
  """render() of the test split as the render CLI names its output."""
  base = ckpt_lib.checkpoint_dir(config)
  out_name = f'test_preds_step_{int(sys_obj.state.step)}'
  out_dir = os.path.join(base, out_name)
  sys_obj.render(load_dataset('test', config.data_dir, config), base, out_dir,
                 out_name)
  return out_dir


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
  """JAX and the port, from the same initial weights: train 6 steps
  (checkpoint every 3), test, render."""
  root = tmp_path_factory.mktemp('system')
  scene = str(root / 'scene')
  _make_blender_scene(scene, n_frames=3, res=16, split='train')
  _make_blender_scene(scene, n_frames=2, res=16, split='test')

  jconfig, jgin = jconfigs.parse(None, _bindings(scene, root / 'jax', 'tiny_a'))
  jsys = jsystem.NeRFSystem(jconfig, jgin)
  init = jax.device_get(jsys.state.params)
  jpsnrs = _record_validations(jsys)
  jsys.train()
  jmetrics = jsys.test(step=6)
  jframes = _render(jsys, jconfig, jdatasets.load_dataset)

  config, gin = configs.parse(None, _bindings(scene, root / 'port', 'tiny_a'))
  psys = system.NeRFSystem(config, gin, device='cpu')
  convert.load_jax_params(psys.model, init)
  ppsnrs = _record_validations(psys)
  psys.train()
  pmetrics = psys.test(step=6)
  pframes = _render(psys, config, datasets.load_dataset)
  return dict(scene=scene, root=root, jsys=jsys, jconfig=jconfig,
              jpsnrs=jpsnrs, jmetrics=jmetrics, jframes=jframes, psys=psys,
              config=config, gin=gin, ppsnrs=ppsnrs, pmetrics=pmetrics,
              pframes=pframes, init=init)


# ---------------------------------------------------------------------- F7


def test_render_image_at_a_train_frac_matches_jax():
  # F7: with Model.anneal_slope > 0 the resampling depends on train_frac,
  # which the port's render_image did not pass to the model (1.0 always).
  bindings = SMALL + ['Model.anneal_slope = 10.', 'Config.vis_num_rays = 3',
                      'Config.render_chunk_size = 16']
  jmodel, params = _init_params(bindings, seed=4)
  jconfig, _ = jconfigs.parse([GIN], bindings)
  r = _rays_np(30, seed=7)
  want = jrenderer.render_image(
      jrenderer.make_render_fn(jmodel, params, train_frac=0.3),
      _jax_rays(r).reshape(5, 6), jconfig)
  model, config = _port_model(bindings, params)
  rays = _port_rays(r).reshape(5, 6)
  got = renderer.render_image(model, rays, config.render_chunk_size,
                              train_frac=0.3)
  np.testing.assert_allclose(got['rgb'].numpy(), want['rgb'], rtol=0,
                             atol=1e-5)
  flat = renderer.render_rays(model, rays.reshape(30),
                              config.render_chunk_size, train_frac=0.3)
  np.testing.assert_allclose(flat['rgb'].numpy(),
                             want['rgb'].reshape(30, 3), rtol=0, atol=1e-5)
  # The fraction matters here: at 1.0 the render moves well past the bound.
  at_one = renderer.render_image(model, rays, config.render_chunk_size)
  assert (at_one['rgb'] - got['rgb']).abs().max() > 1e-3


# -------------------------------------------------------------- checkpoints


def _tiny_state(seed=0):
  config, gin = configs.parse(None, [TINY])
  model = construct.construct_model(config, gin, 'cpu')
  state = step_lib.create_train_state(config, model)
  g = torch.Generator().manual_seed(seed)
  with torch.no_grad():
    for name, p in model.named_parameters():
      p.copy_(torch.randn(p.shape, generator=g))
      state.opt.mu[name] = torch.randn(p.shape, generator=g)
      state.opt.nu[name] = torch.rand(p.shape, generator=g)
  state.step, state.opt.count = 11 + seed, 11 + seed
  return config, gin, state


def test_checkpoint_round_trip_is_bit_for_bit(tmp_path):
  _, _, state = _tiny_state(seed=1)
  mgr = ckpt_lib.CheckpointManager(str(tmp_path), save_top_k=2)
  mgr.save(state.step, state, val_psnr=20.0)
  _, _, other = _tiny_state(seed=2)
  restored = mgr.restore(other)
  assert restored.step == state.step == 12
  assert restored.opt.count == 12 and isinstance(restored.opt.count, int)
  for a, b in zip(state.model.state_dict().items(),
                  restored.model.state_dict().items()):
    assert a[0] == b[0] and a[1].dtype == b[1].dtype
    assert torch.equal(a[1], b[1]), a[0]
  for which in ('mu', 'nu'):
    want, got = getattr(state.opt, which), getattr(restored.opt, which)
    assert set(want) == set(got)
    for k in want:
      assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
  # The parameters were copied into the model's own tensors, which the
  # train step's moments are keyed to.
  assert set(restored.params()) == set(restored.opt.mu)


def test_checkpoint_top_k_latest_and_best(tmp_path):
  _, _, state = _tiny_state()
  mgr = ckpt_lib.CheckpointManager(str(tmp_path), save_top_k=2)
  for step, psnr in zip(range(1, 6), (3.0, 1.0, 4.0, 1.0, 2.0)):
    state.step = step
    mgr.save(step, state, val_psnr=psnr)
  assert _steps_on_disk(str(tmp_path)) == {'last': [5], 'best': [1, 3]}
  assert mgr.latest_step() == 5 and mgr.best_step() == 3
  # A save without a score goes to last/ only.
  state.step = 6
  mgr.save(6, state)
  assert _steps_on_disk(str(tmp_path)) == {'last': [6], 'best': [1, 3]}
  assert mgr.latest_step() == 6 and mgr.best_step() == 3
  # The latest is restored unless a step is named; best/ holds the others.
  assert mgr.restore(state).step == 6
  assert mgr.restore(state, step=1).step == 1
  # Equal scores: the newest stays.
  state.step = 7
  mgr.save(7, state, val_psnr=4.0)
  assert _steps_on_disk(str(tmp_path))['best'] == [3, 7]
  assert mgr.best_step() == 7


def test_checkpoint_empty_directory_raises(tmp_path):
  _, _, state = _tiny_state()
  mgr = ckpt_lib.CheckpointManager(str(tmp_path / 'none'))
  assert mgr.latest_step() is None and mgr.best_step() is None
  with pytest.raises(FileNotFoundError, match='No checkpoint found.'):
    mgr.restore(state)


def test_checkpoint_dir_matches_jax():
  bindings = ["Config.checkpoint_dir = '/x/y'", "Config.exp_name = 'ab_cd'"]
  config, _ = configs.parse(None, bindings)
  jconfig, _ = jconfigs.parse(None, bindings)
  assert ckpt_lib.checkpoint_dir(config) == jckpt.checkpoint_dir(jconfig)
  assert ckpt_lib.checkpoint_dir(config) == '/x/y/ckpt/ab/ab_cd'


def test_a_killed_save_leaves_the_last_checkpoint(tmp_path, monkeypatch):
  _, _, state = _tiny_state(seed=3)
  mgr = ckpt_lib.CheckpointManager(str(tmp_path), save_top_k=1)
  mgr.save(14, state, val_psnr=1.0)
  want = {k: v.clone() for k, v in state.model.state_dict().items()}

  def killed(*_):
    raise KeyboardInterrupt('killed before the rename')
  monkeypatch.setattr(ckpt_lib.os, 'replace', killed)
  state.step = 15
  with pytest.raises(KeyboardInterrupt):
    mgr.save(15, state, val_psnr=2.0)
  monkeypatch.undo()
  leftovers = [n for n in os.listdir(tmp_path / 'last') if not n.isdigit()]
  assert leftovers, 'the killed save left no temporary directory'
  # A temporary directory from a killed save is not a step.
  assert mgr.latest_step() == 14
  _, _, other = _tiny_state(seed=4)
  restored = ckpt_lib.CheckpointManager(str(tmp_path)).restore(other)
  assert restored.step == 14
  for k, v in restored.model.state_dict().items():
    assert torch.equal(v, want[k]), k


# -------------------------------------------------------- system against JAX


def test_train_matches_jax(runs):
  jstate = jax.device_get(runs['jsys'].state)
  assert int(jstate.step) == runs['psys'].state.step == 6
  want = convert.params_to_state_dict(jstate.params)
  got = runs['psys'].model.state_dict()
  assert set(got) == set(want)
  errs = {k: _rel_l2(got[k], want[k]) for k in want}
  assert max(errs.values()) <= PARAM_TOL, errs
  # The weights moved: the comparison is not of the initial ones.
  init = convert.params_to_state_dict(runs['init'])
  assert max(_rel_l2(got[k], init[k]) for k in init) > 1e-3
  assert [s for s, _ in runs['ppsnrs']] == [s for s, _ in runs['jpsnrs']] \
      == [3, 6]
  np.testing.assert_allclose([p for _, p in runs['ppsnrs']],
                             [p for _, p in runs['jpsnrs']], rtol=0,
                             atol=1e-4)
  jdir = jckpt.checkpoint_dir(runs['jconfig'])
  pdir = ckpt_lib.checkpoint_dir(runs['config'])
  assert _steps_on_disk(pdir) == _steps_on_disk(jdir) == {
      'last': [6], 'best': [3, 6]}


def _read(path):
  with open(path) as f:
    return np.array([float(v) for v in f.read().split()])


def test_test_metric_files_match_jax(runs):
  jdir = os.path.join(jckpt.checkpoint_dir(runs['jconfig']), 'test_preds')
  pdir = os.path.join(ckpt_lib.checkpoint_dir(runs['config']), 'test_preds')
  assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir))
  assert len(runs['pmetrics']) == len(runs['jmetrics']) == 2
  for name, tol in (('psnr', 1e-3), ('ssim', 1e-5)):
    got, want = _read(os.path.join(pdir, f'metric_{name}.txt')), _read(
        os.path.join(jdir, f'metric_{name}.txt'))
    assert got.shape == want.shape == (2,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=name)
  with open(os.path.join(pdir, 'avg_metrics.txt')) as f:
    lines = f.read().splitlines()
  assert [l.split(':')[0] for l in lines] == [
      'render_time', 'psnr', 'ssim', 'cc_psnr', 'cc_ssim', 'lpips']
  assert lines[-1].startswith('lpips: unavailable')


def _frame(path):
  return np.asarray(Image.open(path), np.int16)


def test_render_frames_match_jax(runs):
  names = sorted(n for n in os.listdir(runs['jframes'])
                 if n.endswith(('.png', '.tiff')))
  assert sorted(n for n in os.listdir(runs['pframes'])
                if n.endswith(('.png', '.tiff'))) == names
  for i in range(2):
    got = _frame(os.path.join(runs['pframes'], f'color_{i:03d}.png'))
    want = _frame(os.path.join(runs['jframes'], f'color_{i:03d}.png'))
    assert got.shape == want.shape == (16, 16, 3)
    assert np.abs(got - want).max() <= 1, i
  videos = [n for n in os.listdir(ckpt_lib.checkpoint_dir(runs['config']))
            if n.endswith(('.mp4', '.gif'))]
  assert any('_color.' in n for n in videos), videos


def test_render_resumes_and_strides_over_jobs(runs, capsys):
  psys, config = runs['psys'], runs['config']
  ds = datasets.load_dataset('test', runs['scene'], config)
  base = ckpt_lib.checkpoint_dir(config)
  # A frame is done when the next one exists: frame 0 is skipped, the last
  # frame (no successor) renders again.
  psys.render(ds, base, runs['pframes'], 'again')
  out = capsys.readouterr().out
  assert 'Image 0/2 already exists, skipping' in out
  assert 'Evaluating image 2/2' in out and 'Evaluating image 1/2' not in out
  # Two jobs: each renders its own stride; videos once every frame exists.
  out_dir = os.path.join(base, 'jobs')
  for job in (0, 1):
    cfg = dataclasses.replace(config, render_num_jobs=2, render_job_id=job)
    psys.config = cfg
    writers = psys.render(ds, base, out_dir, 'jobs')
    assert bool(writers) == (job == 1)
  psys.config = config
  out = capsys.readouterr().out
  assert 'Evaluating image 1/2' in out and 'Evaluating image 2/2' in out
  for i in range(2):
    np.testing.assert_array_equal(
        _frame(os.path.join(out_dir, f'color_{i:03d}.png')),
        _frame(os.path.join(runs['pframes'], f'color_{i:03d}.png')))


# ------------------------------------------------------------------- resume


def test_port_kill_and_resume_is_bit_for_bit(runs, tmp_path):
  extra = ('Config.max_steps = 8', 'Config.checkpoint_every = 4')

  def trained(exp, more=()):
    config, gin = configs.parse(
        None, _bindings(runs['scene'], tmp_path, exp, extra + more))
    psys = system.NeRFSystem(config, gin, device='cpu')
    psys.train()
    return psys

  whole = trained('whole')
  assert whole.state.step == 8
  assert trained('cut', ('Config.early_exit_steps = 4',)).state.step == 4
  resumed = trained('cut')
  assert resumed.state.step == 8
  assert resumed.state.opt.count == whole.state.opt.count == 8
  for k, v in whole.model.state_dict().items():
    assert torch.equal(resumed.model.state_dict()[k], v), k
  for which in ('mu', 'nu'):
    for k, v in getattr(whole.state.opt, which).items():
      assert torch.equal(getattr(resumed.state.opt, which)[k], v), (which, k)


def test_jax_checkpoint_continues_in_the_port(runs, tmp_path):
  # JAX's run kept its step-3 checkpoint in best/ (save_top_k = 2): the
  # state an early exit at step 3 saves. The port restores it and trains on
  # to step 6.
  jsys = runs['jsys']
  mgr = jckpt.CheckpointManager(jckpt.checkpoint_dir(runs['jconfig']),
                                save_top_k=2)
  at3 = jax.device_get(mgr.restore(jax.device_get(jsys.state), step=3))
  mgr.close()
  assert int(at3.step) == 3
  config, gin = configs.parse(
      None, _bindings(runs['scene'], tmp_path, 'from_jax'))
  psys = system.NeRFSystem(config, gin, device='cpu')
  convert.load_jax_train_state(psys.state, at3)
  assert psys.state.step == psys.state.opt.count == 3
  psys.train()
  assert psys.state.step == 6
  final = jax.device_get(jsys.state)
  want = convert.params_to_state_dict(final.params)
  got = psys.model.state_dict()
  errs = {k: _rel_l2(got[k], want[k]) for k in want}
  assert max(errs.values()) <= PARAM_TOL, errs
  adam = convert._adam_state(final.opt_state)
  for which in ('mu', 'nu'):
    want = convert.params_to_state_dict(getattr(adam, which))
    got = getattr(psys.state.opt, which)
    errs = {k: _rel_l2(got[k], want[k]) for k in want}
    assert max(errs.values()) <= PARAM_TOL, (which, errs)
