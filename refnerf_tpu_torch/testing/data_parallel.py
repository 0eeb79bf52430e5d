"""Runs of the data-parallel train path, in one process or as one rank of
many, for holding N ranks against one process.

`python -m torch.distributed.run --nproc_per_node N -m
refnerf_tpu_torch.testing.data_parallel SPEC.json` joins the process group
(parallel.mesh.initialize_distributed with the spec's device and backend)
and runs each of the spec's runs; `run(spec_run, group, device)` runs one
in this process (group None: the one-process reference). Each run writes
`<out>/<name>.rank<r>.pt`. Kinds of run:

  steps   the train step of parallel/shard_step.py from a state and a batch
          (files of `save_state` and `save_batch`, or the model of the gin
          from its seed and batches of `Config.data_dir`'s train split),
          `steps` times (the noisy forward's angles `noise_angles`, one
          [a, 3] list a step, where given): the parameters before the
          first step, and per step the reduced loss and terms, the reduced
          gradients before the clip, the parameters after the step, the
          seconds of the step and each trunk kernel's launches (on the
          card). A `fault` plants an error of the data-parallel path:
          'skip_reduce' (rank 1 keeps its own gradients and stats, the
          reduction's result unused),
          'same_half' (every rank takes rank 0's rows of the batch) or
          'ratio_mean' (each masked mean is this rank's ratio, averaged
          over the ranks).
  system  NeRFSystem of the gin from `Config.data_dir`: trained to
          `steps`; where `kill_at` is given, trained again to `kill_at`
          (early exit) and resumed to `steps`, and whether the two end
          states are equal (parameters and Adam moments, torch.equal);
          then test view 0 rendered with its chunks split across the ranks
          and by this rank alone.
  errors  the refusals of the data-parallel path: each of the spec's
          cases (bindings, and 'step' for make_sharded_train_step or
          'system' for NeRFSystem) records the message of the ValueError it
          raises, or None.
  all_sum the backward of parallel.mesh.all_sum: rank r sums (r + 1) x;
          records the gradient of x.
  cli     the train CLI (refnerf_tpu_torch.cli.train) in this rank's
          process with the spec run's `argv` (its --device and
          --dist_backend the spec's): it joins the spec's group again
          (parallel.mesh reuses it); "rank r: cli <name> begins" and "...
          ends" bracket its output. Records nothing.

Imports neither jax nor anything of refnerf_tpu.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time

import torch

from refnerf_tpu_torch import configs as configs_lib
from refnerf_tpu_torch.cameras import camera_utils
from refnerf_tpu_torch.cameras import rays as rays_lib
from refnerf_tpu_torch.parallel import mesh
from refnerf_tpu_torch.parallel import shard_step
from refnerf_tpu_torch.train import losses as losses_lib
from refnerf_tpu_torch.train import step as step_lib

FAULTS = ('skip_reduce', 'same_half', 'ratio_mean')


def save_batch(path, batch) -> None:
  """A rays.Batch of CPU tensors to `path`."""
  fields = lambda obj: {f.name: getattr(obj, f.name)
                        for f in dataclasses.fields(obj)}
  torch.save({'kind': type(batch.rays).__name__, 'rays': fields(batch.rays),
              **{k: v for k, v in fields(batch).items() if k != 'rays'}},
             path)


def load_batch(path, device='cpu'):
  d = torch.load(path, map_location=device, weights_only=True)
  kind = rays_lib.Pixels if d.pop('kind') == 'Pixels' else rays_lib.Rays
  return rays_lib.Batch(rays=kind(**d.pop('rays')), **d)


def save_state(path, state) -> None:
  """A train state (step.TrainState) to `path`."""
  torch.save({'step': state.step, 'count': state.opt.count,
              'model': state.model.state_dict(), 'mu': state.opt.mu,
              'nu': state.opt.nu}, path)


def load_state(path, state) -> None:
  d = torch.load(path, map_location=next(state.model.parameters()).device,
                 weights_only=True)
  state.model.load_state_dict(d['model'])
  state.step, state.opt.count = d['step'], d['count']
  state.opt.mu = {k: v.clone() for k, v in d['mu'].items()}
  state.opt.nu = {k: v.clone() for k, v in d['nu'].items()}


def _config(spec):
  return configs_lib.parse([spec['gin']], list(spec.get('bindings', [])))


def _sync(device):
  if torch.device(device).type == 'cuda':
    torch.cuda.synchronize(device)


def acc_threshold(acc, ranks=1) -> float:
  """An acc threshold that passes between a quarter and three quarters of
  the rays of `acc` and, where `ranks` > 1, different counts of the ranks'
  rows (their contiguous slices), none of them 0: the midpoint of the
  widest such gap between neighbours of the sorted values, so that no ray
  sits within summation-order noise of it. (The geometry gin's 0.1 passes
  every ray of an untrained field, and equal counts make a mean of
  per-rank ratios the global ratio: a fault of the masked means'
  reduction could not show.)"""
  acc = acc.detach().flatten().float().cpu()
  v = torch.sort(acc).values
  lo, hi = v.numel() // 4, max(v.numel() // 4 + 1, 3 * v.numel() // 4)
  for i in (lo + torch.argsort(v[lo + 1:hi + 1] - v[lo:hi],
                               descending=True)).tolist():
    t = float((v[i] + v[i + 1]) / 2)
    counts = [int((part > t).sum()) for part in acc.chunk(ranks)]
    if ranks == 1 or (len(set(counts)) > 1 and min(counts) > 0):
      return t
  raise ValueError(f'no acc threshold parts the {ranks} ranks\' counts')


def threshold_bindings(acc, noise_rays, ranks):
  """The geometry losses' acc thresholds at acc_threshold of the last
  level's `acc` over the global batch: the consistency mask's from the
  first `noise_rays` rays (those it reads), the weights entropy's from
  all of them."""
  return [
      'Config.acc_threshold_for_consistency_loss = '
      f'{acc_threshold(acc[:noise_rays], ranks)!r}',
      'Config.acc_threshold_for_weights_entropy_loss = '
      f'{acc_threshold(acc, ranks)!r}']


def _ratio_mean(group):
  """The 'ratio_mean' fault: each masked mean is this rank's ratio,
  averaged over the ranks."""
  def masked_mean(x, mask, group_=None):
    mask = torch.broadcast_to(mask, x.shape).to(x.dtype)
    local = (x * mask).sum() / torch.maximum(mask.sum(),
                                             mask.new_tensor(1e-10))
    return mesh.all_sum(local, group_) / mesh.size(group_)
  return masked_mean


def run_steps(spec, group, device):
  from refnerf_tpu_torch.models import construct
  from refnerf_tpu_torch.ops import fused_mlp
  config, gin = _config(spec)
  model = construct.construct_model(config, gin, device)
  state = step_lib.create_train_state(config, model)
  if spec.get('state'):
    load_state(spec['state'], state)
  if spec.get('start_step') is not None:
    state.step = state.opt.count = int(spec['start_step'])
  mesh.replicate(state, group)
  fault = spec.get('fault')
  if fault is not None and fault not in FAULTS:
    raise ValueError(f'unknown fault {fault!r}')
  cameras = raycast = dataset = None
  if spec.get('batch'):
    batches = [load_batch(spec['batch'])] * spec['steps']
  else:
    from refnerf_tpu_torch.data import datasets
    dataset = datasets.load_dataset('train', config.data_dir, config)
    dataset.seek(state.step)
    batches = [next(dataset) for _ in range(spec['steps'])]
    cameras = dataset.device_cameras(device)
    raycast = lambda cams, pix: camera_utils.cast_ray_batch(cams, pix,
                                                            dataset.camtype)
  noise_angles = None
  if spec.get('noise_angles') is not None:
    # Given angles, one [a, 3] list a step from the start.
    first, given = state.step, spec['noise_angles']
    noise_angles = lambda step, a, max_angle: torch.tensor(
        given[step - first], dtype=torch.float32)
  train_step = shard_step.make_sharded_train_step(
      model, config, group, raycast_fn=raycast, noise_angles=noise_angles)
  r = mesh.rank(group)
  if fault == 'skip_reduce' and r == 1:
    # Rank 1 takes part in the collectives but keeps its own numbers.
    reduce = train_step.shard.reduce
    train_step.shard.reduce = lambda grads, stats: (
        reduce(grads, stats) and (grads, stats))
  saved_mean = losses_lib._masked_mean
  if fault == 'ratio_mean':
    losses_lib._masked_mean = _ratio_mean(group)
  rows = mesh.rows_of(config.batch_size, 0 if fault == 'same_half' else r,
                      mesh.size(group))
  out = {k: [] for k in ('loss', 'losses', 'mses', 'grads', 'params', 'ms',
                         'launches')}
  out['start'] = {k: p.detach().cpu().clone()
                  for k, p in state.params().items()}
  try:
    for batch in batches:
      batch = batch.map(lambda x: x[rows].to(device))
      for k in fused_mlp.launches:
        fused_mlp.launches[k] = 0
      _sync(device)
      t0 = time.perf_counter()
      loss, stats, grads = train_step.loss_and_grads(state, batch, cameras)
      step_lib.apply_gradients(state, grads, config)
      state.step += 1
      _sync(device)
      out['ms'].append((time.perf_counter() - t0) * 1e3)
      out['launches'].append(dict(fused_mlp.launches))
      out['loss'].append(loss.detach().cpu())
      out['losses'].append({k: v.cpu() for k, v in stats['losses'].items()})
      out['mses'].append(stats['mses'].cpu())
      out['grads'].append({k: g.cpu() for k, g in grads.items()})
      out['params'].append({k: p.detach().cpu().clone()
                            for k, p in state.params().items()})
  finally:
    losses_lib._masked_mean = saved_mean
  return out


def run_system(spec, group, device):
  from refnerf_tpu_torch.models import renderer
  from refnerf_tpu_torch.system import NeRFSystem
  base = list(spec.get('bindings', []))
  exp = spec['exp']

  def system(name, extra=()):
    config, gin = configs_lib.parse([spec['gin']], base + [
        f"Config.checkpoint_dir = '{exp}'", f"Config.exp_name = '{name}'",
        f"Config.max_steps = {spec['steps']}", *extra])
    return NeRFSystem(config, gin, device=device, group=group)

  full = system('dp_full')
  full.train()
  a = b = full.state
  killed_step = equal = None
  if spec.get('kill_at') is not None:
    killed = system('dp_killed',
                    [f"Config.early_exit_steps = {spec['kill_at']}"])
    killed.train()
    killed_step = killed.state.step
    resumed = system('dp_killed')
    resumed.train()
    b = resumed.state
    equal = (a.step == b.step and a.opt.count == b.opt.count and all(
        torch.equal(p, q) for p, q in zip(a.model.state_dict().values(),
                                          b.model.state_dict().values())) and
             all(torch.equal(a.opt.mu[k], b.opt.mu[k]) and
                 torch.equal(a.opt.nu[k], b.opt.nu[k]) for k in a.opt.mu))
  full.setup_datasets()
  view = next(full.val_dataset)
  rays = view.rays.map(lambda x: x.to(full.device))
  chunk = full.config.render_chunk_size
  split = renderer.render_image(full.model, rays, chunk, compute_extras=True,
                                group=group)
  alone = renderer.render_image(full.model, rays, chunk, compute_extras=True)
  diff = {k: float((split[k] - alone[k]).abs().max()) for k in split
          if not k.startswith('ray_')}
  same = all(torch.equal(split[k], alone[k]) for k in split
             if not k.startswith('ray_')) and all(
                 torch.equal(x, y) for k in split if k.startswith('ray_')
                 for x, y in zip(split[k], alone[k]))
  return {'killed_step': killed_step, 'resumed_equal': equal,
          'step': b.step, 'params': {k: p.detach().cpu().clone()
                                     for k, p in b.params().items()},
          'render_equal': same, 'render_max_diff': diff,
          'rgb': split['rgb']}


def run_errors(spec, group, device):
  from refnerf_tpu_torch.models import construct
  from refnerf_tpu_torch.system import NeRFSystem
  messages = []
  for case in spec['cases']:
    config, gin = configs_lib.parse([spec['gin']], list(case['bindings']))
    try:
      if case['via'] == 'step':
        model = construct.construct_model(config, gin, device)
        shard_step.make_sharded_train_step(model, config, group)
      else:
        NeRFSystem(config, gin, device=device, group=group)
    except ValueError as e:
      messages.append(str(e))
    else:
      messages.append(None)
  return {'messages': messages}


def run_all_sum(spec, group, device):
  x = torch.ones(3, device=device, requires_grad=True)
  y = mesh.all_sum(x * (mesh.rank(group) + 1), group)
  grad, = torch.autograd.grad((y * torch.arange(1., 4., device=device)).sum(),
                              x)
  return {'y': y.detach().cpu(), 'grad': grad.cpu()}


def run_cli(spec, group, device):
  from refnerf_tpu_torch.cli import train as train_cli
  r = mesh.rank(group)
  print(f"rank {r}: cli {spec['name']} begins", flush=True)
  train_cli.main(spec['argv'])
  print(f"rank {r}: cli {spec['name']} ends", flush=True)
  return {}


RUNS = {'steps': run_steps, 'system': run_system, 'errors': run_errors,
        'all_sum': run_all_sum, 'cli': run_cli}


def run(spec_run, group, device):
  """One run of a spec in this process; writes and returns its record."""
  out = RUNS[spec_run['kind']](spec_run, group, device)
  if spec_run.get('out'):
    os.makedirs(spec_run['out'], exist_ok=True)
    torch.save(out, os.path.join(
        spec_run['out'], f"{spec_run['name']}.rank{mesh.rank(group)}.pt"))
  return out


def main(argv=None):
  argv = sys.argv[1:] if argv is None else argv
  with open(argv[0]) as f:
    spec = json.load(f)
  torch.set_num_threads(int(spec.get('threads', torch.get_num_threads())))
  group, device = mesh.initialize_distributed(spec.get('device', 'cuda'),
                                              spec.get('backend'))
  rank = mesh.rank(group)
  try:
    for spec_run in spec['runs']:
      run(spec_run, group, device)
      mesh.barrier(group)
  finally:
    mesh.destroy(group)
  print(f'rank {rank}: {len(spec["runs"])} runs done')


if __name__ == '__main__':
  main()
