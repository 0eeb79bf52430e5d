"""Profile the flagship train step with torch.profiler (counterpart of
tools/profile_step.py, which summarises with tools/read_trace.py).

bench.py's setup: configs/blender_refnerf.gin at batch 4096,
`Config.randomized = False`, `Config.sample_noise_size = 0`, the trunks in
bf16 (`--mode bf16`) or the gin's float32 (`--mode f32`), seeded synthetic
rays. After a warm-up of 3 steps it times `--steps` steps unprofiled, for
ms a step and rays/s, then traces as many more and prints the device time
a step by category (`utils/profiling.py` `device_split`): each trunk
kernel by its CUDA name, the weight-gradient and reduction kernels, other
kernels and copies. The idle share is 1 - busy / the unprofiled wall: the
profiler's own host cost (recording every launch) lengthens the traced
window's wall, which is printed beside it. Last, one JSON line of the same
numbers:

    python3 -m refnerf_tpu_torch.tools.profile_step [--steps 5] \
        [--mode bf16|f32] [--batch 4096] [--out trace.json] \
        [--device cuda] [--bindings '...']

`--out` also writes the window as a Chrome trace. On the CPU the profiler
sees no device time: the split is zeros and the idle share null.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

_GIN = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), 'configs', 'blender_refnerf.gin')


def setup(batch, mode, device, bindings=()):
  """bench.py's flagship step: (model, config, state, train_step, batch)."""
  from refnerf_tpu_torch import configs as configs_lib
  from refnerf_tpu_torch.cameras import rays as rays_lib
  from refnerf_tpu_torch.models import construct
  from refnerf_tpu_torch.train import step as step_lib

  config, gin = configs_lib.parse([_GIN], [
      f'Config.batch_size = {batch}', 'Config.randomized = False',
      'Config.sample_noise_size = 0'] +
      (["NerfMLP.compute_dtype = 'bfloat16'"] if mode == 'bf16' else []) +
      list(bindings))
  model = construct.construct_model(config, gin, device)
  rng = np.random.RandomState(0)
  d = rng.randn(batch, 3).astype(np.float32)
  t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
  full = lambda v: torch.full((batch, 1), float(v), device=device)
  rays = rays_lib.Rays(**{
      **vars(rays_lib.dummy_rays(batch, device)),
      'origins': t(rng.randn(batch, 3).astype(np.float32) * 0.1),
      'directions': t(d),
      'viewdirs': t(d / np.linalg.norm(d, axis=-1, keepdims=True)),
      'radii': full(0.001), 'lossmult': full(1.0),
      'near': full(config.near), 'far': full(config.far)})
  data = rays_lib.Batch(rays=rays, rgb=t(
      rng.uniform(0, 1, (batch, 3)).astype(np.float32)))
  state = step_lib.create_train_state(config, model)
  return model, config, state, step_lib.make_train_step(model, config), data


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument('--steps', type=int, default=5)
  p.add_argument('--mode', default='bf16', choices=('bf16', 'f32'))
  p.add_argument('--batch', type=int, default=4096)
  p.add_argument('--out', default='', help='Chrome trace to write.')
  p.add_argument('--device', default='cuda')
  p.add_argument('--bindings', action='append', default=[])
  args = p.parse_args(argv)

  from torch.profiler import ProfilerActivity, profile
  from refnerf_tpu_torch.utils import profiling

  _, _, state, train_step, batch = setup(args.batch, args.mode, args.device,
                                         args.bindings)
  cuda = torch.device(args.device).type == 'cuda'
  sync = torch.cuda.synchronize if cuda else (lambda: None)
  for _ in range(3):
    state, stats = train_step(state, batch)
  float(stats['loss'])
  activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
  def window():
    """`--steps` steps, the seconds they took and the last loss."""
    nonlocal state
    sync()
    t0 = time.perf_counter()
    for _ in range(args.steps):
      state, stats = train_step(state, batch)
    loss = float(stats['loss'])
    return time.perf_counter() - t0, loss

  elapsed, final = window()
  with profile(activities=activities) as prof:
    traced, _ = window()
  if args.out:
    prof.export_chrome_trace(args.out)
  ms = elapsed / args.steps * 1e3
  rays_s = args.batch * args.steps / elapsed
  traced_ms = traced / args.steps * 1e3
  print(f'{args.steps} steps in {elapsed:.3f} s = {ms:.1f} ms/step '
        f'({rays_s:.0f} rays/s), loss={final:.4f}; '
        f'{traced_ms:.1f} ms/step under the profiler')
  split = profiling.device_split(prof, elapsed, args.steps)
  idle = split['idle share']
  print(f"device busy {split['busy']:.2f} ms/step of {split['wall']:.2f} "
        f"unprofiled, idle {'n/a' if idle is None else f'{100 * idle:.1f}%'}"
        f", {split['launches']:.0f} launches/step")
  for k in profiling.TRUNK_KERNELS + (profiling.WGRAD, profiling.OTHER,
                                      profiling.COPIES):
    share = 100 * split[k] / split['busy'] if split['busy'] else 0.0
    print(f'{split[k]:9.3f} ms/step {share:5.1f}%  {k}')
  out = {'ms_per_step': ms, 'traced_ms_per_step': traced_ms,
         'rays_per_sec': rays_s, 'loss': final,
         'mode': args.mode, 'batch': args.batch, 'device_ms_per_step': split}
  print(json.dumps(out))
  return out


if __name__ == '__main__':
  main()
