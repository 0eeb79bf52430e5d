"""The port's quality check and the tools a user runs on a trained scene,
on the CPU.

- The glossy sphere scene (`sphere_scene.make_shiny_scene`) and the
  Lambertian one against tools/make_shiny_scene.py and
  tools/make_sphere_scene.py: decoded pixels and transforms equal.
- `python -m refnerf_tpu_torch.tools.quality_check --device cpu` on both
  scene kinds at a tiny width, a few steps, in subprocesses that block jax,
  flax, optax, absl, orbax, matplotlib and refnerf_tpu: the QUALITY_CHECK
  line and the checkpoints; its bindings are those of
  tools/quality_check.py:58-71.
- `tools.eval_ckpt_step --step best` and `--step N` restore those
  checkpoints and evaluate them print-only; `tools.extract_mesh` writes
  mesh_step_N.ply from the latest (and exits 1 on an empty mesh);
  `tools.mesh_error` reads the mesh.
"""

import json
import os
import re

import numpy as np
import pytest
from PIL import Image

from refnerf_tpu_torch import configs
from refnerf_tpu_torch import geometry
from refnerf_tpu_torch.tools import mesh_error
from refnerf_tpu_torch.tools import quality_check
from refnerf_tpu_torch.tools import sphere_scene
from refnerf_tpu_torch.train import checkpoints as ckpt_lib
from tests.test_torch_port_cli import _python

TINY = ['Config.batch_size = 32', 'Config.render_chunk_size = 256',
        'Config.print_every = 2', 'Config.checkpoint_every = 2',
        'NerfMLP.net_depth = 2', 'NerfMLP.net_width = 16',
        'NerfMLP.net_depth_viewdirs = 2', 'NerfMLP.net_width_viewdirs = 16',
        'NerfMLP.bottleneck_width = 8', 'Model.num_prop_samples = 8',
        'Model.num_nerf_samples = 8']
STEPS = 4


@pytest.mark.parametrize('kind', ['sphere', 'shiny'])
def test_scene_matches_the_jax_writer(tmp_path, kind):
  if kind == 'shiny':
    from tools.make_shiny_scene import make_scene as jmake
    port = sphere_scene.make_shiny_scene(str(tmp_path / 'p'), 6, 2, 20)
  else:
    from tools.make_sphere_scene import make_scene as jmake
    port = sphere_scene.make_scene(str(tmp_path / 'p'), 6, 2, 20)
  ref = str(tmp_path / 'j')
  jmake(ref, 6, 2, 20)
  names = sorted(os.listdir(ref))
  assert names == sorted(os.listdir(port)) and len(names) == 10
  for name in names:
    a, b = os.path.join(port, name), os.path.join(ref, name)
    if name.endswith('.png'):
      np.testing.assert_array_equal(np.asarray(Image.open(a)),
                                    np.asarray(Image.open(b)))
    else:
      with open(a) as fa, open(b) as fb:
        assert json.load(fa) == json.load(fb), name


def test_bindings_are_the_jax_tools():
  args = quality_check.parse_args(['--scene', 'S', '--out', 'O'])
  assert args.steps == 3000 and args.res == 64 and args.fused == 'auto'
  assert args.device == 'cuda' and args.bf16 and not args.f32
  got = quality_check.bindings(args)
  assert got == [
      "Config.data_dir = 'S'", "Config.checkpoint_dir = 'O'",
      "Config.exp_name = 'sphere_quality'", 'Config.batch_size = 1024',
      'Config.render_chunk_size = 4096', 'Config.max_steps = 3000',
      'Config.checkpoint_every = 3000', 'Config.print_every = 500',
      'Config.val_sample_num = 4', 'Config.sample_noise_size = 0',
      'Config.lr_delay_steps = 512', "NerfMLP.compute_dtype = 'bfloat16'",
      "NerfMLP.fused_trunk = 'auto'"]
  f32 = quality_check.bindings(quality_check.parse_args(
      ['--f32', '--fused', 'off', '--bindings', 'Config.max_steps = 9']))
  assert f32[-2:] == ["NerfMLP.fused_trunk = 'off'", 'Config.max_steps = 9']
  assert not any('compute_dtype' in b for b in f32)


def _tool(name, *args):
  """`python -m refnerf_tpu_torch.tools.<name> ARGS` with the JAX stack
  blocked; returns (exit code, stdout)."""
  out = _python(f'''
      import runpy
      sys.argv = ['{name}'] + {list(args)!r}
      try:
        runpy.run_module('refnerf_tpu_torch.tools.{name}',
                         run_name='__main__', alter_sys=True)
        code = 0
      except SystemExit as e:
        code = e.code
      print('EXIT', code)
  ''')
  return int(re.findall(r'^EXIT (\d+)$', out, re.M)[-1]), out


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
  root = tmp_path_factory.mktemp('quality')
  out = {}
  for kind in ('sphere', 'shiny'):
    args = ['--device', 'cpu', '--steps', str(STEPS), '--res', '16',
            '--scene-kind', kind, '--scene', str(root / f'{kind}_scene'),
            '--out', str(root / kind), '--f32']
    for b in TINY:
      args += ['--bindings', b]
    code, log = _tool('quality_check', *args)
    assert code == 0, log
    # The tools read the config snapshot the check writes.
    snapshot = str(root / kind / 'logs' / 'sphere' / 'sphere_quality' /
                   'config.gin')
    out[kind] = {'log': log, 'root': root / kind,
                 'gin_args': ['--gin_configs', snapshot, '--device=cpu']}
  return out


def _config(run):
  return configs.parse([run['gin_args'][1]], [])[0]


@pytest.mark.parametrize('kind', ['sphere', 'shiny'])
def test_quality_check_trains_and_reports(runs, kind):
  log = runs[kind]['log']
  line = re.findall(r'^QUALITY_CHECK .*$', log, re.M)
  assert len(line) == 1, log
  fields = dict(kv.split('=') for kv in line[0].split()[1:])
  assert fields['steps'] == str(STEPS) and fields['train_time'].endswith('s')
  assert 0 < float(fields['heldout_psnr']) < 60
  assert 0 < float(fields['heldout_ssim']) <= 1
  assert float(fields['ms_per_step']) > 0
  assert f'step {STEPS}/{STEPS}' in log and 'Training with' in log
  ckpt = ckpt_lib.checkpoint_dir(_config(runs[kind]))
  assert ckpt.startswith(str(runs[kind]['root']))
  assert sorted(os.listdir(os.path.join(ckpt, 'best'))) == ['2', '4']
  assert sorted(os.listdir(os.path.join(ckpt, 'last'))) == ['4']


def test_eval_ckpt_step_restores_the_best_and_a_named_step(runs):
  run = runs['sphere']
  config = _config(run)
  best = ckpt_lib.CheckpointManager(ckpt_lib.checkpoint_dir(config)).best_step()
  code, log = _tool('eval_ckpt_step', '--step=best', *run['gin_args'])
  assert code == 0, log
  assert (f'Evaluating checkpoint at step {best} (policy: best val_psnr)'
          in log)
  assert log.count('eval ') == 4 and 'psnr=' in log
  code, log = _tool('eval_ckpt_step', '--step', '2', *run['gin_args'])
  assert code == 0 and 'at step 2 (policy: explicit)' in log, log
  # Print-only: nothing written under test_preds.
  assert not os.path.exists(os.path.join(ckpt_lib.checkpoint_dir(config),
                                         'test_preds'))


def test_extract_mesh_cli_writes_the_mesh(runs):
  run = runs['shiny']
  ckpt = ckpt_lib.checkpoint_dir(_config(run))
  code, log = _tool('extract_mesh', '--resolution', '12', '--iso', '-1',
                    *run['gin_args'])
  assert code == 0, log
  assert f'Extracting mesh from checkpoint at step {STEPS}' in log
  path = os.path.join(ckpt, f'mesh_step_{STEPS}.ply')
  mesh = geometry.read_ply(path)
  nv, nf = (int(n) for n in re.findall(
      r'^(\d+) vertices, (\d+) faces', log, re.M)[0])
  assert nv == len(mesh['verts']) > 0 and nf == len(mesh['faces']) > 0
  assert mesh['colors'].shape == (nv, 3)  # the diffuse head
  # The header names the lattice step, which mesh_error reads back.
  step = [float(v) for v in mesh['comments'][0].split()[1:]]
  assert mesh['comments'][0].startswith('lattice_step ')
  np.testing.assert_allclose(step, [3 / 11] * 3, rtol=1e-12)
  within, median, worst = mesh_error.main([path])
  assert (within, median, worst) == mesh_error.sphere_error(mesh['verts'],
                                                            3 / 11)
  assert 0 <= within <= 1 and 0 <= median <= worst
  # An isovalue no untrained density reaches: an empty mesh, exit 1.
  other = str(run['root'] / 'empty.ply')
  code, log = _tool('extract_mesh', '--resolution', '8', '--iso', '1e9',
                    '--lower=-1,-1,-1', '--upper=1,1,1', '--out', other,
                    *run['gin_args'])
  assert code == 1 and '0 vertices, 0 faces' in log, log
  assert len(geometry.read_ply(other)['verts']) == 0


def test_mesh_error_needs_the_lattice_step(tmp_path):
  # A PLY without extract_mesh's lattice_step comment is refused rather
  # than read against a guessed grid.
  verts = np.random.default_rng(5).normal(size=(40, 3)).astype(np.float32)
  faces = np.arange(39, dtype=np.int32).reshape(13, 3)
  bare = str(tmp_path / 'bare.ply')
  geometry.write_ply(bare, verts, faces)
  with pytest.raises(SystemExit, match='names no lattice step'):
    mesh_error.main([bare])
  named = str(tmp_path / 'named.ply')
  geometry.write_ply(named, verts, faces, comments=['lattice_step 0.1 0.1 0.1'])
  assert geometry.read_ply(named)['comments'] == ['lattice_step 0.1 0.1 0.1']
  assert mesh_error.main([named]) == mesh_error.sphere_error(verts, 0.1)
