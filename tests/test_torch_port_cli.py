"""The port's CLIs run as a user runs them, on the CPU, without the JAX stack.

`python -m refnerf_tpu_torch.cli.{train,eval,render} --device=cpu` in
subprocesses that block jax, flax, optax, absl, orbax, matplotlib and
refnerf_tpu (and tensorflow, google.cloud and boto3, which tensorboardX
would otherwise import at some seconds' cost), on the tiny gin of
tests/test_system.py and a blender scene:

- train writes the config.gin snapshot (equal to JAX's config_str() for the
  same files and bindings), TensorBoard events and checkpoints; a second
  train prints `Resumed from step N` and stops;
- eval writes the metric files; render writes the frames and the videos,
  and a second render skips the frames already done;
- error probes: a gin file that does not exist, a misspelt binding, eval on
  an empty checkpoint directory; and the modules (geometry, interop and
  the tools a user runs on a trained scene too) import without any of the
  blocked packages;
- utils/profiling: StepTracer's Chrome trace and Timer.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from refnerf_tpu import configs as jconfigs
from refnerf_tpu_torch.utils import profiling
from tests.test_data import _make_blender_scene
from tests.test_system import _TINY

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Nothing of these may be imported by the port.
FORBIDDEN = ('jax', 'flax', 'optax', 'absl', 'orbax', 'matplotlib',
             'refnerf_tpu')
BLOCKED = FORBIDDEN + ('tensorflow', 'google.cloud', 'boto3')
GIN = _TINY + '''
Config.distortion_loss_mult = 0.
Config.max_steps = 4
Config.checkpoint_every = 2
Config.eval_dataset_limit = 2
'''
BINDING = 'Config.print_every = 1'

_PRELUDE = '''
import sys
for name in {blocked!r}:
  sys.modules[name] = None
'''
_EPILOGUE = '''
bad = sorted(m for m in sys.modules if m.split('.')[0] in {forbidden!r}
             and sys.modules[m] is not None)
print('FORBIDDEN IMPORTS', json.dumps(bad))
'''


def _python(body, timeout=300):
  script = (_PRELUDE.format(blocked=BLOCKED) + 'import json\n' +
            textwrap.dedent(body) + _EPILOGUE.format(forbidden=FORBIDDEN))
  env = {**os.environ, 'PYTHONPATH': REPO}
  env.pop('REFNERF_TPU_PROFILE_DIR', None)
  proc = subprocess.run([sys.executable, '-c', script], cwd=REPO, env=env,
                        capture_output=True, text=True, timeout=timeout)
  assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
  assert 'FORBIDDEN IMPORTS []' in proc.stdout, proc.stdout[-2000:]
  return proc.stdout


def _cli(module, *args):
  """`python -m refnerf_tpu_torch.cli.<module> ARGS`, blocked imports."""
  return _python(f'''
      import runpy
      sys.argv = ['{module}'] + {list(args)!r}
      runpy.run_module('refnerf_tpu_torch.cli.{module}', run_name='__main__',
                       alter_sys=True)
  ''')


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
  root = tmp_path_factory.mktemp('cli')
  scene = str(root / 'scene')
  _make_blender_scene(scene, n_frames=3, res=12, split='train')
  _make_blender_scene(scene, n_frames=2, res=12, split='test')
  gin_file = str(root / 'tiny.gin')
  with open(gin_file, 'w') as f:
    f.write(GIN + f"Config.data_dir = '{scene}'\n"
            f"Config.checkpoint_dir = '{root / 'exp'}'\n"
            "Config.exp_name = 'cli_test'\n")
  # Both flag forms: --flag=value and --flag value.
  args = (f'--gin_configs={gin_file}', '--gin_bindings', BINDING,
          '--device=cpu')
  out = {'root': root, 'gin_file': gin_file,
         'ckpt': root / 'exp' / 'ckpt' / 'cli' / 'cli_test'}
  for name, module in (('train', 'train'), ('train_again', 'train'),
                       ('eval', 'eval'), ('render', 'render'),
                       ('render_again', 'render')):
    out[name] = _cli(module, *args)
  return out


def test_train_cli_trains_checkpoints_and_resumes(runs):
  assert 'step 4/4' in runs['train'] and 'Resumed' not in runs['train']
  assert runs['train'].count('validation @ step') == 2
  steps = {sub: sorted(p.name for p in (runs['ckpt'] / sub).iterdir()
                       if p.name.isdigit()) for sub in ('last', 'best')}
  assert steps == {'last': ['4'], 'best': ['2', '4']}
  logs = runs['root'] / 'exp' / 'logs' / 'cli' / 'cli_test'
  assert any(p.name.startswith('events.out.tfevents') for p in logs.iterdir())
  assert 'Resumed from step 4' in runs['train_again']
  assert 'step ' not in runs['train_again'].split('Resumed from step 4')[1]


def test_config_snapshot_matches_jax(runs):
  snap = runs['root'] / 'exp' / 'logs' / 'cli' / 'cli_test' / 'config.gin'
  _, jgin = jconfigs.parse([runs['gin_file']], [BINDING])
  assert snap.read_text() == jgin.config_str()


def test_eval_cli_writes_the_metric_files(runs):
  assert 'Evaluating checkpoint at step 4' in runs['eval']
  out_dir = runs['ckpt'] / 'test_preds'
  for name in ('psnr', 'ssim', 'cc_psnr', 'cc_ssim'):
    values = (out_dir / f'metric_{name}.txt').read_text().split()
    assert len(values) == 2 and all(float(v) == float(v) for v in values)
  avg = (out_dir / 'avg_metrics.txt').read_text()
  assert avg.startswith('render_time: ') and 'lpips: unavailable' in avg
  assert (out_dir / 'render_times.txt').exists()
  assert (out_dir / 'color_000.png').exists()


def test_render_cli_writes_frames_and_videos_and_resumes(runs):
  out_dir = runs['ckpt'] / 'test_preds_step_4'
  for i in range(2):
    for k in ('color', 'diffuse', 'specular', 'normals_pred', 'rho'):
      assert (out_dir / f'{k}_{i:03d}.png').exists(), (k, i)
    for k in ('distance_mean', 'distance_median', 'acc'):
      assert (out_dir / f'{k}_{i:03d}.tiff').exists(), (k, i)
  assert 'Video writers:' in runs['render']
  videos = [p.name for p in runs['ckpt'].iterdir()
            if p.suffix in ('.mp4', '.gif')]
  assert len(videos) == 7, videos
  assert 'Image 0/2 already exists, skipping' in runs['render_again']
  assert 'Evaluating image 1/2' not in runs['render_again']


def test_error_probes_and_import_hygiene(runs, tmp_path):
  gin_file = runs['gin_file']
  empty = str(tmp_path / 'empty')
  out = _python(f'''
      from refnerf_tpu_torch import convert, geometry, interop, system, vis
      from refnerf_tpu_torch.cli import eval as eval_cli, flags, render, train
      from refnerf_tpu_torch.tools import (eval_ckpt_step,
                                           export_torch_checkpoint,
                                           extract_mesh,
                                           import_torch_checkpoint,
                                           mesh_error, quality_check)
      from refnerf_tpu_torch.train import checkpoints
      from refnerf_tpu_torch.utils import profiling

      def probe(fn, argv):
        try:
          fn(argv)
        except Exception as e:
          print('PROBE', json.dumps([type(e).__name__, str(e)]))
        else:
          print('PROBE', json.dumps(None))

      probe(train.main, ['--gin_configs={tmp_path}/nowhere.gin',
                         '--device=cpu'])
      probe(train.main, ['--gin_configs={gin_file}',
                         '--gin_bindings=Config.batch_sizee = 3',
                         '--device=cpu'])
      probe(eval_cli.main, ['--gin_configs={gin_file}', '--gin_bindings',
                            "Config.checkpoint_dir = '{empty}'",
                            '--device=cpu'])
  ''')
  probes = [json.loads(l[len('PROBE '):]) for l in out.splitlines()
            if l.startswith('PROBE ')]
  assert probes[0][0] == 'FileNotFoundError' and 'nowhere.gin' in probes[0][1]
  assert probes[1][0] == 'ValueError' and 'batch_sizee' in probes[1][1]
  assert probes[2] == ['FileNotFoundError', 'No checkpoint found.']


def test_step_tracer_and_timer(tmp_path, monkeypatch, capsys):
  monkeypatch.setenv(profiling.PROFILE_DIR_ENV, str(tmp_path))
  tracer = profiling.StepTracer()
  import torch
  x = torch.ones(8)
  for step in range(profiling.TRACE_START_STEP + profiling.TRACE_NUM_STEPS
                    + 1):
    tracer.step(step)
    x = x * 2
  tracer.close()
  traces = list(tmp_path.glob('*.json'))
  assert len(traces) == 1, traces
  assert 'traceEvents' in json.loads(traces[0].read_text())
  with profiling.Timer('phase') as t:
    pass
  assert t.elapsed >= 0 and '[phase]' in capsys.readouterr().out
