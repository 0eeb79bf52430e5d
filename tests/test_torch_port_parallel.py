"""The port's data parallelism against its one-process step and against the
JAX package's sharded step, on the CPU.

The ranks are processes of torchrun (`torch.distributed.run`, gloo,
`--device cpu`) running refnerf_tpu_torch/testing/data_parallel.py with
jax, flax, optax, absl, orbax and refnerf_tpu blocked; this process runs
the one-process reference of each run and the JAX package's
make_sharded_train_step on a 2-device CPU mesh (conftest gives 8). One
launch of 2 ranks runs every case below, beside the JAX compiles, a
second the train CLI and a third the eval CLI; each has a timeout and a
free port of its own.

- The differentiable all-reduce's backward: the cotangents summed over the
  ranks (JAX's psum transposes to psum).
- At the small flagship cut of tests/test_torch_port_train.py (non-uniform
  lossmult, so the data loss is a weighted mean), the geometry-loss stack
  of tests/multiprocess_worker.py (the consistency family and the weights
  entropy: masked means, the noisy forward on the gathered prefix) and a
  `Config.randomized` step with density and bottleneck noise and random
  backgrounds: 2 ranks against 1 process, two steps. They differ in the
  order of f32 sums alone; what was measured here: the losses and every
  term within 1.8e-7 relative, each reduced gradient within 1.1e-6
  relative L2, the parameters within 7.5e-9 (3.8e-4 of the largest move).
  Bounds: 2e-6 relative (losses, terms, gradients) and 1e-3 of each
  parameter's largest move. Every rank's parameters are bit-identical
  after every step.
- The geometry cases' acc thresholds (the gin's 0.1 passes every ray of
  the untrained field, so a mean of per-rank ratios would equal the global
  ratio) sit where the ranks' masks hold different counts
  (testing/data_parallel.threshold_bindings). Three planted faults, a step
  each, read above the bounds: one rank skips the reduction (its gradients
  1.35 relative L2 off), both ranks take the same half (1.35; the loss
  0.28), the masked means reduced as a mean of per-rank ratios (the
  consistency terms 7.1e-3 to 0.35 relative, the weights entropy 2.9e-4).
- The flagship cut and the geometry gin's cut (configs/llff_refnerf
  _geometry_losses.gin at batch 16, 8 noise rays, past the consistency
  warmup, JAX's noise angles handed to the ranks, the acc thresholds set as
  above) on 2 ranks against JAX make_sharded_train_step on 2 devices: the
  losses 1e-5 relative (the consistency terms within
  testing/consistency.py's bound of the two packages' render gap), each
  reduced gradient before the clip 2e-4 of its largest entry, the
  parameters 2e-2 of their largest move (the tolerances of
  test_train_step_matches_jax).
- NeRFSystem on 2 ranks killed at step 2 and resumed to 4 equals the
  uninterrupted run (torch.equal), and equals the one-process run within
  the bound above; a test view with its chunks split across the ranks is
  the one-rank render bit for bit.
- JAX's refusals (batch not divisible, sample_noise_size not divisible or
  not in one shard) and the half-configured launches.
- The train CLI under torchrun: rank 0 alone logs and checkpoints; the
  eval CLI on 2 ranks writes the metric files of one process.
"""

import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refnerf_tpu import configs as jconfigs
from refnerf_tpu.cameras import rays as jrays
from refnerf_tpu.models import construct as jconstruct
from refnerf_tpu.parallel import mesh as jmesh
from refnerf_tpu.parallel import shard_step as jshard
from refnerf_tpu.train import step as jstep
from refnerf_tpu_torch import configs
from refnerf_tpu_torch import convert
from refnerf_tpu_torch.cameras import rays as rays_lib
from refnerf_tpu_torch.data import prefetch
from refnerf_tpu_torch.models import construct
from refnerf_tpu_torch.parallel import mesh
from refnerf_tpu_torch.testing import consistency
from refnerf_tpu_torch.testing import data_parallel as dp
from refnerf_tpu_torch.train import sampling
from refnerf_tpu_torch.train import step as step_lib
from tests import test_torch_port_losses as geo_tests
from tests import test_torch_port_train as train_tests

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIN = train_tests.GIN
SMALL = train_tests.SMALL + ["NerfMLP.fused_trunk = 'on'"]
# tests/multiprocess_worker.py's geometry-loss stack on the flagship cut.
GEOMETRY = [
    'Config.batch_size = 64', 'Config.sample_noise_size = 8',
    'Config.sample_noise_angles = 2', 'Config.sample_angle_range = 5',
    'Config.consistency_warmup_steps = 0.0',
    "Config.consistency_diffuse_loss_type = 'var'",
    'Config.consistency_diffuse_loss_mult = 3e-5',
    "Config.consistency_specular_loss_type = 'var'",
    'Config.consistency_specular_loss_mult = 3e-5',
    "Config.consistency_normal_loss_target = 'normals'",
    'Config.consistency_normal_loss_mult = 3e-5',
    'Config.consistency_distance_loss_mult = 3e-6',
    'Config.weights_entropy_loss_mult = 3e-5',
    'Config.accumulated_weights_loss_mult = 3e-4']
RANDOMIZED = ['Config.randomized = True', 'NerfMLP.density_noise = 1.0',
              'NerfMLP.bottleneck_noise = 0.1',
              'Model.bg_intensity_range = (0., 1.)']
# The geometry gin's small cut (tests/test_torch_port_losses.py) at 2 ranks.
GEO_SMALL = geo_tests.SMALL + ['Config.batch_size = 16',
                               'Config.sample_noise_size = 8']
GEO_START = geo_tests.PAST_WARMUP
TINY = [
    'Config.batch_size = 32', 'Config.render_chunk_size = 256',
    'Config.checkpoint_every = 2', 'Config.print_every = 1',
    'Config.val_sample_num = 1', 'Config.eval_dataset_limit = 2',
    'Model.num_prop_samples = 8', 'Model.num_nerf_samples = 8',
    'NerfMLP.net_depth = 2', 'NerfMLP.net_width = 16',
    'NerfMLP.net_depth_viewdirs = 1', 'NerfMLP.net_width_viewdirs = 16',
    'NerfMLP.bottleneck_width = 8', 'NerfMLP.max_deg_point = 4',
    'NerfMLP.deg_view = 2']
STEPS = 2
PORT_TOL = 2e-6     # N ranks against one process: losses, terms, gradients
PORT_MOVE = 1e-3    # ... and the parameters, of their largest move
JAX_TOL, JAX_GRAD, JAX_MOVE = 1e-5, 2e-4, 2e-2
BLOCKED = ('jax', 'jaxlib', 'flax', 'optax', 'absl', 'orbax', 'refnerf_tpu')
LAUNCH_TIMEOUT = 240

_LAUNCHER = '''
import json, runpy, sys
for name in {blocked!r}:
  sys.modules[name] = None
module = sys.argv[1]
sys.argv = [module] + sys.argv[2:]
try:
  runpy.run_module(module, run_name='__main__', alter_sys=True)
finally:
  bad = sorted(m for m in sys.modules if m.split('.')[0] in {blocked!r}
               and sys.modules[m] is not None)
  sys.stdout.write('FORBIDDEN IMPORTS ' + json.dumps(bad) + chr(10))
  sys.stdout.flush()
'''


def _free_port():
  with socket.socket() as s:
    s.bind(('127.0.0.1', 0))
    return s.getsockname()[1]


def _launch(tmp, module, *args, nproc=2):
  """torchrun of `module` on `nproc` CPU ranks, imports blocked: a Popen
  whose output goes to a file; `_finish` waits for it."""
  launcher = os.path.join(tmp, 'launcher.py')
  with open(launcher, 'w') as f:
    f.write(_LAUNCHER.format(blocked=BLOCKED))
  env = {k: v for k, v in os.environ.items()
         if k not in ('RANK', 'LOCAL_RANK', 'WORLD_SIZE', 'MASTER_ADDR',
                      'MASTER_PORT')}
  env.update(PYTHONPATH=REPO, OMP_NUM_THREADS='1')
  log = open(os.path.join(tmp, f'{os.path.basename(module)}.log'), 'w+')
  proc = subprocess.Popen(
      [sys.executable, '-m', 'torch.distributed.run',
       f'--nproc_per_node={nproc}', '--master_addr=127.0.0.1',
       f'--master_port={_free_port()}', launcher, module, *args],
      cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT, text=True)
  return proc, log


def _finish(launched):
  proc, log = launched
  try:
    proc.wait(timeout=LAUNCH_TIMEOUT)
  finally:
    if proc.poll() is None:
      proc.kill()
      proc.wait()
  log.seek(0)
  out = log.read()
  assert proc.returncode == 0, out[-6000:]
  assert out.count('FORBIDDEN IMPORTS []') == 2, out[-4000:]
  return out


def _rays(b, lossmult=None):
  rays = rays_lib.dummy_rays(len(b['rgb']))
  for k, v in b.items():
    if k != 'rgb':
      setattr(rays, k, train_tests._t(v))
  if lossmult is not None:
    rays.lossmult = train_tests._t(lossmult)
  return rays_lib.Batch(rays=rays, rgb=train_tests._t(b['rgb']))


def _jbatch(b, lossmult):
  fields = {k: jnp.asarray(v) for k, v in b.items() if k != 'rgb'}
  fields['lossmult'] = jnp.asarray(lossmult)
  return jrays.Batch(rays=jrays.dummy_rays(len(b['rgb'])).replace(**fields),
                     rgb=jnp.asarray(b['rgb']))


class _Capture(jstep.TrainState):
  """JAX's train state, keeping the gradients its step applied (the
  sharded step's, reduced and before the clip)."""
  grads: Any = None

  def apply_gradients(self, *, grads, **kwargs):
    return super().apply_gradients(grads=grads, **kwargs).replace(grads=grads)


def _jax_sharded(jmodel, jconfig, params, jbatch, steps, start=0):
  """`steps` steps of JAX make_sharded_train_step on a 2-device mesh: per
  step (stats, reduced gradients, parameters after it), as numpy."""
  mesh2 = jmesh.create_mesh(n_devices=2)
  js = jstep.create_train_state(jconfig, jmodel, params)
  js = _Capture(**{f.name: getattr(js, f.name)
                   for f in dataclasses.fields(js)}, grads=js.params)
  js = js.replace(step=jnp.asarray(start, jnp.int32))
  js = jmesh.replicate(js, mesh2)
  jb = jmesh.shard_batch(jbatch, mesh2)
  fn = jshard.make_sharded_train_step(jmodel, jconfig, mesh2)
  out = []
  for _ in range(steps):
    params_before = jax.device_get(js.params)
    js, stats = fn(js, jb)
    out.append((jax.device_get(stats), train_tests._flat(
        jax.device_get(js.grads)), train_tests._flat(jax.device_get(
            js.params)), params_before))
  return out


@pytest.fixture(scope='module')
def runs():
  """Every 2-rank run (one launch) and its one-process reference, and the
  JAX package's sharded steps; the train CLI launched beside them."""
  tmp = tempfile.mkdtemp(prefix='dp-')
  out = os.path.join(tmp, 'out')
  rng = np.random.default_rng(7)
  # The flagship cut from JAX's initial weights, at non-uniform lossmult.
  params = train_tests._init_params(SMALL)
  port_config, port_gin = configs.parse([GIN], SMALL)
  model = construct.construct_model(port_config, port_gin, 'cpu')
  convert.load_jax_params(model, params)
  flag_state = os.path.join(tmp, 'flagship_state.pt')
  dp.save_state(flag_state, step_lib.create_train_state(port_config, model))
  b12 = train_tests._batch_np(12, seed=0)
  lm12 = rng.uniform(0.5, 2.0, (12, 1)).astype(np.float32)
  b64 = train_tests._batch_np(64, seed=1)
  lm64 = rng.uniform(0.5, 2.0, (64, 1)).astype(np.float32)
  dp.save_batch(os.path.join(tmp, 'b12.pt'), _rays(b12, lm12))
  dp.save_batch(os.path.join(tmp, 'b64.pt'), _rays(b64, lm64))
  geometry = SMALL + GEOMETRY + _thresholds(model, _rays(b64, lm64), 8, 0)
  # The geometry gin's cut, past the warmup, JAX's angles handed over.
  pair = geo_tests._Pair(GEO_SMALL, (16,))
  convert.load_jax_params(pair.model, pair.params)
  geo_state = os.path.join(tmp, 'geo_state.pt')
  state = step_lib.create_train_state(pair.config, pair.model)
  state.step = GEO_START
  dp.save_state(geo_state, state)
  dp.save_batch(os.path.join(tmp, 'b16.pt'), pair.batch)
  geo_thresholds = _thresholds(pair.model, pair.batch, 8, GEO_START,
                               pair.config.max_steps)
  angles = [geo_tests._jax_angles(pair.jconfig, GEO_START + i).tolist()
            for i in range(STEPS)]
  from refnerf_tpu_torch.tools import sphere_scene
  scene = sphere_scene.make_scene(os.path.join(tmp, 'scene'), 4, 2, 16)
  tiny = TINY + [f"Config.data_dir = '{scene}'"]
  spec = lambda name, **kw: dict(name=name, out=out, **kw)
  steps = [
      spec('flagship', kind='steps', gin=GIN, bindings=SMALL,
           state=flag_state, batch=os.path.join(tmp, 'b12.pt'), steps=STEPS),
      spec('geometry', kind='steps', gin=GIN, bindings=geometry,
           state=flag_state, batch=os.path.join(tmp, 'b64.pt'), steps=STEPS),
      spec('randomized', kind='steps', gin=GIN, bindings=SMALL + RANDOMIZED,
           batch=os.path.join(tmp, 'b12.pt'), steps=STEPS),
      spec('geo_jax', kind='steps', gin=geo_tests.GEO,
           bindings=GEO_SMALL + geo_thresholds, state=geo_state,
           batch=os.path.join(tmp, 'b16.pt'), steps=STEPS,
           noise_angles=angles),
      spec('system', kind='system', gin=GIN, bindings=tiny,
           exp=os.path.join(tmp, 'exp2'), steps=4, kill_at=2)]
  # The planted faults, a step each on 2 ranks.
  faults = [
      spec('skip_reduce', kind='steps', gin=GIN, bindings=SMALL,
           state=flag_state, batch=os.path.join(tmp, 'b12.pt'), steps=1,
           fault='skip_reduce'),
      spec('same_half', kind='steps', gin=GIN, bindings=SMALL,
           state=flag_state, batch=os.path.join(tmp, 'b12.pt'), steps=1,
           fault='same_half'),
      spec('ratio_mean', kind='steps', gin=GIN, bindings=geometry,
           state=flag_state, batch=os.path.join(tmp, 'b64.pt'), steps=1,
           fault='ratio_mean')]
  others = faults + [
      spec('all_sum', kind='all_sum'),
      spec('errors', kind='errors', gin=GIN, cases=[
          dict(via='system', bindings=SMALL + ['Config.batch_size = 13']),
          dict(via='step', bindings=SMALL + GEOMETRY +
               ['Config.sample_noise_size = 7']),
          dict(via='step', bindings=SMALL + GEOMETRY +
               ['Config.sample_noise_size = 48'])])]
  spec_path = os.path.join(tmp, 'spec.json')
  with open(spec_path, 'w') as f:
    json.dump(dict(device='cpu', threads=1, runs=steps + others), f)
  launched = _launch(tmp, 'refnerf_tpu_torch.testing.data_parallel',
                     spec_path)
  cli_dir = os.path.join(tmp, 'cli')
  cli = _launch(tmp, 'refnerf_tpu_torch.cli.train', f'--gin_configs={GIN}',
                *[f'--gin_bindings={b}' for b in tiny + [
                    f"Config.checkpoint_dir = '{cli_dir}'",
                    "Config.exp_name = 'cli_dp'", 'Config.max_steps = 2']],
                '--device=cpu')
  try:
    one = {}
    for r in steps:
      r = dict(r, name=r['name'] + '_one', exp=os.path.join(tmp, 'exp1'))
      one[r['name'][:-4]] = dp.run(r, None, 'cpu')
    jcfg, jgin = jconfigs.parse([GIN], SMALL)
    jmodel = jconstruct.construct_model(jcfg, jgin)
    geo_jcfg, _ = jconfigs.parse([geo_tests.GEO], GEO_SMALL + geo_thresholds)
    jax_runs = {
        'flagship': _jax_sharded(jmodel, jcfg, params, _jbatch(b12, lm12),
                                 STEPS),
        'geo_jax': _jax_sharded(pair.jmodel, geo_jcfg, pair.params,
                                pair.jbatch, STEPS, start=GEO_START)}
  finally:
    log = _finish(launched)
    cli_log = _finish(cli)
  # The eval CLI on 2 ranks from the train CLI's checkpoint; then in this
  # process, into a copy of the experiment.
  eval_args = [f'--gin_configs={GIN}', *[f'--gin_bindings={b}' for b in tiny + [
      f"Config.checkpoint_dir = '{cli_dir}'", "Config.exp_name = 'cli_dp'",
      'Config.max_steps = 2']], '--device=cpu']
  eval_log = _finish(_launch(tmp, 'refnerf_tpu_torch.cli.eval', *eval_args))
  from refnerf_tpu_torch.cli import eval as cli_eval
  one_dir = os.path.join(tmp, 'cli_one')
  shutil.copytree(cli_dir, one_dir)
  cli_eval.main([a.replace(cli_dir, one_dir) for a in eval_args])
  load = lambda name, r: torch.load(os.path.join(out, f'{name}.rank{r}.pt'),
                                    weights_only=False)
  two = {r['name']: [load(r['name'], k) for k in (0, 1)]
         for r in steps + others}
  return dict(one=one, two=two, jax=jax_runs, pair=pair, log=log,
              cli_log=cli_log, cli_dir=cli_dir, eval_log=eval_log,
              one_dir=one_dir)


def _thresholds(model, batch, noise_rays, step, max_steps=1):
  """The geometry losses' acc thresholds from the last level's acc over
  `batch` (the step's deterministic forward at `step`), at which the two
  ranks' masks hold different counts (dp.threshold_bindings)."""
  train_frac = min(max((step - 1) / max(max_steps - 1, 1), 0), 1)
  with torch.no_grad():
    acc = model(batch.rays, train_frac=train_frac, train=True)[0][-1]['acc']
  return dp.threshold_bindings(acc, noise_rays, 2)


def _rel(a, b):
  return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def test_all_sum_backward_sums_the_cotangents_over_ranks(runs):
  # Rank r sums (r + 1) x; the loss is the sum times [1, 2, 3] on both
  # ranks, so d loss / dx on rank r is (r + 1) * 2 * [1, 2, 3].
  for r, rec in enumerate(runs['two']['all_sum']):
    assert torch.equal(rec['y'], torch.full((3,), 3.0))
    assert torch.equal(rec['grad'], (r + 1) * 2 * torch.arange(1., 4.))


@pytest.mark.parametrize('name', ['flagship', 'geometry', 'randomized'])
def test_two_ranks_match_one_process(runs, name):
  one, two = runs['one'][name], runs['two'][name][0]
  for s in range(STEPS):
    assert _rel(two['loss'][s], one['loss'][s]) <= PORT_TOL, s
    assert set(two['losses'][s]) == set(one['losses'][s])
    for k, v in one['losses'][s].items():
      assert _rel(two['losses'][s][k], v) <= PORT_TOL, (s, k)
    for k, g in one['grads'][s].items():
      err = float((two['grads'][s][k] - g).norm() / g.norm().clamp_min(1e-30))
      assert err <= PORT_TOL, (s, k, err)
    before = one['params'][s - 1] if s else one['start']
    for k, p in one['params'][s].items():
      moved = max(1e-12, float((p - before[k]).abs().max()))
      assert float((two['params'][s][k] - p).abs().max()) <= (
          PORT_MOVE * moved), (s, k)
  if name == 'geometry':
    assert all(float(one['losses'][-1][k]) != 0 for k in consistency.TERMS)


def _grads_rel(got, want):
  """The largest relative L2 error over the gradients."""
  return max(float((got[k] - g).norm() / g.norm().clamp_min(1e-30))
             for k, g in want.items())


@pytest.mark.parametrize('fault', ['skip_reduce', 'same_half', 'ratio_mean'])
def test_planted_fault_reads_above_the_bound(runs, fault):
  # Each fault of the data-parallel path, one step on 2 ranks, against the
  # one-process step: it must read above the bound that the right
  # reduction keeps (test_two_ranks_match_one_process).
  one, two = runs['one'], runs['two'][fault]
  if fault == 'skip_reduce':
    # Rank 1 keeps its own half's gradients; the ranks part.
    assert _grads_rel(two[1]['grads'][0], one['flagship']['grads'][0]) > (
        PORT_TOL)
    assert not all(torch.equal(p, two[1]['params'][0][k])
                   for k, p in two[0]['params'][0].items())
  elif fault == 'same_half':
    assert _grads_rel(two[0]['grads'][0], one['flagship']['grads'][0]) > (
        PORT_TOL)
    assert _rel(two[0]['loss'][0], one['flagship']['loss'][0]) > PORT_TOL
  else:
    # The masks at the thresholds hold different counts on the two ranks,
    # so every masked-mean term reads off the global ratio.
    for k in consistency.TERMS + ('weights_entropy',):
      err = _rel(two[0]['losses'][0][k], one['geometry']['losses'][0][k])
      assert err > PORT_TOL, (k, err)


@pytest.mark.parametrize('name', ['flagship', 'geometry', 'randomized',
                                  'geo_jax'])
def test_every_rank_holds_bit_identical_parameters(runs, name):
  r0, r1 = runs['two'][name]
  for s in range(STEPS):
    for k, p in r0['params'][s].items():
      assert torch.equal(p, r1['params'][s][k]), (s, k)
    for k, g in r0['grads'][s].items():
      assert torch.equal(g, r1['grads'][s][k]), (s, k)


def _check_against_jax(two, jax_runs):
  # JAX's sharded step returns the total loss and the data loss's stats;
  # its terms one by one are held against the one-process step by
  # tests/test_torch_port_train.py and tests/test_torch_port_losses.py.
  for s, (jstats, jgrads, jparams, jbefore) in enumerate(jax_runs):
    np.testing.assert_allclose(float(two['loss'][s]), float(jstats['loss']),
                               rtol=JAX_TOL)
    np.testing.assert_allclose(two['mses'][s].numpy(), jstats['mses'],
                               rtol=JAX_TOL)
    assert set(two['grads'][s]) == set(jgrads)
    for k, g in two['grads'][s].items():
      train_tests._assert_grads(g, jgrads[k], JAX_GRAD, f'{s} {k}')
    before = train_tests._flat(jbefore)
    for k, p in two['params'][s].items():
      moved = max(1e-12, float(np.abs(jparams[k] - before[k]).max()))
      np.testing.assert_allclose(p.numpy(), jparams[k], rtol=0,
                                 atol=JAX_MOVE * moved, err_msg=f'{s} {k}')


def test_two_ranks_match_jax_sharded_step_flagship(runs):
  _check_against_jax(runs['two']['flagship'][0], runs['jax']['flagship'])


def test_two_ranks_match_jax_sharded_step_geometry(runs):
  two = runs['two']['geo_jax'][0]
  assert step_lib._consistency_ratio(runs['pair'].config, GEO_START) == 1.0
  _check_against_jax(two, runs['jax']['geo_jax'])
  assert all(float(two['losses'][-1][k]) != 0 for k in consistency.TERMS)


def test_two_rank_kill_and_resume_is_bit_for_bit(runs):
  # NeRFSystem on 2 ranks: trained to 4; trained to 2 (early exit) and
  # resumed to 4; the two end states equal on every rank, and equal to the
  # one-process run within the bound of the module.
  one = runs['one']['system']
  for rec in runs['two']['system']:
    assert rec['killed_step'] == 2 and rec['step'] == 4
    assert rec['resumed_equal']
  r0, r1 = runs['two']['system']
  for k, p in r0['params'].items():
    assert torch.equal(p, r1['params'][k]), k
    assert float((p - one['params'][k]).abs().max()) <= 1e-5 * max(
        1.0, float(one['params'][k].abs().max())), k
  assert 'Resumed from step 2' in runs['log']


def test_split_eval_render_equals_one_rank(runs):
  for rec in runs['two']['system']:
    assert rec['render_equal'], rec['render_max_diff']
  r0, r1 = runs['two']['system']
  assert torch.equal(r0['rgb'], r1['rgb'])
  assert r0['rgb'].shape == (16, 16, 3)


@pytest.mark.parametrize('case,want', [
    (0, 'batch_size 13 must divide across 2 devices'),
    (1, 'sample_noise_size 7 must divide across 2 shards'),
    (2, 'sample_noise_size 48 must fit in one shard')])
def test_jax_refusals(runs, case, want):
  for rec in runs['two']['errors']:
    assert rec['messages'][case] is not None and want in rec['messages'][case]


@pytest.mark.parametrize('env,want', [
    ({'RANK': '0'}, 'RANK set but WORLD_SIZE is not'),
    ({'LOCAL_RANK': '1'}, 'LOCAL_RANK set but WORLD_SIZE is not'),
    ({'WORLD_SIZE': '2', 'RANK': '0', 'LOCAL_RANK': '0',
      'MASTER_PORT': '29500'}, 'MASTER_ADDR not set'),
    ({'WORLD_SIZE': '2', 'RANK': '1', 'LOCAL_RANK': '1',
      'MASTER_ADDR': '127.0.0.1'}, 'MASTER_PORT not set'),
    ({'WORLD_SIZE': '2', 'RANK': '0', 'LOCAL_RANK': '0',
      'MASTER_ADDR': '127.0.0.1', 'MASTER_PORT': '29500'},
     'the nccl backend needs a CUDA device')])
def test_half_configured_launch_raises(monkeypatch, env, want):
  for k in ('RANK', 'LOCAL_RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT'):
    monkeypatch.delenv(k, raising=False)
  for k, v in env.items():
    monkeypatch.setenv(k, v)
  with pytest.raises(ValueError, match=want):
    mesh.initialize_distributed('cpu', 'nccl' if 'nccl' in want else None)


def test_one_process_is_a_no_op(monkeypatch):
  for k in ('RANK', 'LOCAL_RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT'):
    monkeypatch.delenv(k, raising=False)
  assert mesh.initialize_distributed('cpu') == (None, torch.device('cpu'))
  monkeypatch.setenv('WORLD_SIZE', '1')
  assert mesh.initialize_distributed('cpu') == (None, torch.device('cpu'))
  # The card is asked for by default; without one the rank raises.
  for k, v in (('RANK', '0'), ('LOCAL_RANK', '0'),
               ('MASTER_ADDR', '127.0.0.1'), ('MASTER_PORT', '29500')):
    monkeypatch.setenv(k, v)
  with pytest.raises(RuntimeError, match='no CUDA device'):
    mesh.initialize_distributed('cuda', 'gloo')
  # One process: every helper is the identity.
  x = torch.arange(4.)
  assert mesh.all_sum(x, None) is x and mesh.from_first(x, None) is x
  assert mesh.size(None) == 1 and mesh.rank(None) == 0
  assert mesh.pad_batch_size(13, None) == 13


def test_row_split_of_batches_and_draws():
  # training_batches and sampling.Draws: rank r's rows of the global batch
  # and of its draws, [r n, (r + 1) n); the ranks' rows make the whole.
  batch = _rays(train_tests._batch_np(8, seed=3))
  parts = [next(prefetch.training_batches(iter([batch]), device='cpu',
                                          rank=r, world_size=2))
           for r in (0, 1)]
  for f in ('origins', 'lossmult', 'cam_idx'):
    whole = getattr(batch.rays, f)
    assert torch.equal(torch.cat([getattr(p.rays, f) for p in parts]), whole)
  assert torch.equal(parts[1].rgb, batch.rgb[4:])
  assert mesh.shard_batch(batch, None) is batch
  for stream in (sampling.FWD_STREAM, sampling.NOISY_FWD_STREAM):
    full = sampling.Draws(0, 5, stream)
    ranks = [sampling.Draws(0, 5, stream, rank=r, world_size=2)
             for r in (0, 1)]
    for take in (lambda d, n: d.jitter((n, 2), 4, False),
                 lambda d, n: d.mlp().normal((n, 3, 2)),
                 lambda d, n: d.background((n, 3), 0.0, 1.0)):
      want = take(full, 8)
      got = torch.cat([take(d, 4) for d in ranks])
      assert torch.equal(got, want)
  assert mesh.round_up_to_multiple(13, 4) == 16
  assert mesh.rows_of(8, 1, 2) == slice(4, 8)
  with pytest.raises(ValueError, match='must divide across 3 ranks'):
    mesh.rows_of(8, 0, 3)


def test_train_cli_under_torchrun(runs):
  # Two ranks of the train CLI: rank 0 alone prints, writes the merged
  # config and the checkpoint of step 2; the ranks import no jax.
  log, exp = runs['cli_log'], runs['cli_dir']
  assert log.count('Training with') == 1 and log.count('step 2/2') == 1
  ckpt = os.path.join(exp, 'ckpt', 'cli', 'cli_dp')
  assert os.listdir(os.path.join(ckpt, 'last')) == ['2']
  assert os.path.exists(os.path.join(exp, 'logs', 'cli', 'cli_dp',
                                     'config.gin'))
  assert not [n for n in os.listdir(os.path.join(ckpt, 'last'))
              if n.startswith('.tmp')]


def test_eval_cli_under_torchrun_writes_the_one_process_metrics(runs):
  # The eval CLI on 2 ranks splits each view's chunks across them; rank 0
  # alone writes the metric files, the same bytes as one process's (the
  # split render is bit for bit one rank's); render_times.txt aside.
  log = runs['eval_log']
  assert log.count('Evaluating checkpoint at step 2') == 1
  assert log.count('eval 2/2:') == 1
  preds = lambda d: os.path.join(d, 'ckpt', 'cli', 'cli_dp', 'test_preds')
  two, one = preds(runs['cli_dir']), preds(runs['one_dir'])
  names = sorted(n for n in os.listdir(one) if n.startswith('metric_'))
  assert names and sorted(n for n in os.listdir(two)
                          if n.startswith('metric_')) == names
  for n in names:
    with open(os.path.join(two, n)) as a, open(os.path.join(one, n)) as b:
      assert a.read() == b.read(), n


def test_rank_processes_import_no_jax(runs):
  assert runs['log'].count('FORBIDDEN IMPORTS []') == 2
  assert 'rank 0: 10 runs done' in runs['log']
  assert 'rank 1: 10 runs done' in runs['log']


def test_a_second_join_reuses_the_group(monkeypatch):
  # A process already in the group (a data_parallel.py rank running the
  # train CLI, chip_smoke.py phase 22) joins it again: initialize_distributed
  # reuses it, and only the last destroy leaves it.
  for k, v in dict(RANK='0', LOCAL_RANK='0', WORLD_SIZE='1',
                   MASTER_ADDR='127.0.0.1',
                   MASTER_PORT=str(_free_port())).items():
    monkeypatch.setenv(k, v)
  dist = torch.distributed
  group, dev = mesh.initialize_distributed('cpu', 'gloo')
  try:
    again, dev2 = mesh.initialize_distributed('cpu', 'gloo')
    assert again is group and dev2 == dev
    mesh.destroy(again)
    assert dist.is_initialized()
  finally:
    mesh.destroy(group)
  assert not dist.is_initialized()
