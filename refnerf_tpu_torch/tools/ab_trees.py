"""Time kernel phases of chip_smoke.py (by default phase 5: K3, K4, K5
against their plain versions) from several checkouts, in turns on one card,
and compare the SASS that each checkout's build gives each kernel.

From the root of a checkout, on a machine with an H100 and the CUDA toolkit,
with the checkouts to compare unpacked (git archive) in ignored directories:

    python3 -m refnerf_tpu_torch.tools.ab_trees --arm p=_chip/p \\
        --arm c=_chip/c --order p,c,p,c,p,c --out chiprun_out/ab \\
        [--checks check_train_kernels,check_dir_kernels,check_spa_kernels,
                  serve_requests,train_steps,cascade_steps,
                  forward_kernels,backward_kernels,w1024_pair,m360_steps,
                  m360_dir_pair,chain_rows]
        [--dtype float32]

First every checkout builds its kernels into its own build/, all at once.
Then each run of --order (none without it) is a process of its own in its
checkout's root: it imports that checkout's chip_smoke.py and runs the
functions of --checks (phase 5's check_train_kernels by default; phase 7's
check_dir_kernels and phase 9's check_spa_kernels time K5 with K8-K10 and K4
with K6/K7). `serve_requests`, `train_steps`, `cascade_steps`,
`forward_kernels`, `backward_kernels`, `w1024_pair`, `m360_steps`,
`m360_dir_pair` and `chain_rows` are this tool's own, the same code in
every checkout (so are the chain they time, `w1024_chain`, and
`dir1_case`: this checkout's chip_smoke.py functions, sent to every run):
in
`serve_requests` phase 10's model (all six fuse flags) and phase 12's two
mip-NeRF models, their trunks in --dtype (bfloat16 by default; float32 is
the gins' own, phase 14's), each answer a 4096-ray request, timed on the
host clock under fused_trunk='auto' ("kernel") and 'off' ("plain"), with
one request's device-busy time from torch.profiler; in `train_steps` phase
10's model and mip-NeRF as shipped take train steps at batch 4096 the same
way, their trunks in --dtype (float32: phase 13's and phase 15's); in
`cascade_steps` phase 19's cascade, (b) in float32 and (c) in bf16 with
the six fuse flags, takes train steps and answers a 4096-ray request the
same way (under 'on' and 'off'; --dtype not read);
`w1024_pair` phase 24's width-1024 pair in both dtypes against its plain
versions, `m360_steps` MIPNERF360's train step at batch 16,384 and a
4096-ray request in --dtype under 'on' and 'off' (with the 'on' step's
peak memory); `m360_dir_pair` phase 24's directional pair (1 x 128 on
256 + 27 columns) in --dtype against its plain versions and its PyTorch
chain (the concatenation inside), forward and backward with dx;
`chain_rows` the PyTorch chain of every trunk row that it computes without
a fused stage or the density gradient (K1, K1 hf=0, K2, K2 W128, K11 and
K1 wide forward; K4 first-order, K5, K5 W128 and K4 wide backward) in
--dtype beside its kernel and plain version, the rows' library column;
`forward_kernels` holds every forward case
of phases 3, 5, 7, 9 and 11 (K2 at width 128 and K11 included) and phase
19's proposal trunk (K1 wide) in --dtype against its plain version
(chip_smoke.compare) without their backward cases, `backward_kernels`
every backward case of phases 5, 7, 9, 11 and 19 (K4 wide) in --dtype
without their forward cases. Each run's output goes to --out.
Printed: every case's kernel and plain times (and device busy and the
PyTorch chain's library time, where measured) per arm in run order and their medians; then, per
library, whether each kernel instance of the first arm has the same SASS
instructions in each other arm (an instance that gained trailing template
arguments at their defaults, false flags or the width 256, is the same
instance, and so is a kernel that became a template whose arguments are
all such defaults).
"""

import argparse
import difflib
import inspect
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys

# A run: CHECKS, then this tool's own checks' source (OWN) and this
# checkout's chip_smoke functions they call (SHARED), then this.
RUN = '''
import math, sys, torch
sys.path.insert(0, '.')
import chip_smoke
from refnerf_tpu_torch.ops import fused_mlp
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
for check in CHECKS:
  fn = globals()[check] if check in OWN else getattr(chip_smoke, check)
  fn(fused_mlp, torch.device('cuda'))
'''


def serve_requests(fused_mlp, dev, reps=15, reps_off=3):
  """Phase 10's and phase 12's models (trunks in the run's DTYPE), each
  answering one 4096-ray request `reps` times under fused_trunk='auto' and
  `reps_off` times under 'off' after a warm-up of each; prints the median
  wall ms of each and the device-busy ms of one 'auto' request, in
  chip_smoke's line format. Run in a checkout's root, with its chip_smoke
  imported: it uses only what every checkout's chip_smoke has (flagship,
  random_rays, set_mode and the binding lists; its bf16 binding is
  overridden by a later one)."""
  import statistics
  import time
  import torch
  from torch.profiler import ProfilerActivity, profile
  import chip_smoke
  from refnerf_tpu_torch.cameras import rays as rays_lib
  from refnerf_tpu_torch.models import renderer
  models = (('phase 10', 'all six', chip_smoke.FLAGSHIP,
             chip_smoke.FUSE + chip_smoke.SPATIAL),
            ('phase 12', 'mip-NeRF shipped', chip_smoke.MIPNERF, []),
            ('phase 12', 'mip-NeRF no viewdirs', chip_smoke.MIPNERF,
             chip_smoke.NO_VIEWDIRS))
  for phase, name, gin, bindings in models:
    model, config = chip_smoke.flagship(
        dev, bindings + [f"NerfMLP.compute_dtype = '{DTYPE}'"], gin)
    if model.nerf_mlp.cfg.compute_dtype != DTYPE:
      raise AssertionError(f'serve_requests: the model is not in {DTYPE}')
    rays = chip_smoke.random_rays(rays_lib, 4096, config, 1, dev)
    request = lambda: renderer.render_rays(model, rays,
                                           config.render_chunk_size)
    wall = {}
    with torch.no_grad():
      for mode, n in (('auto', reps), ('off', reps_off)):
        chip_smoke.set_mode(model, fused_trunk=mode)
        request()
        times = []
        for _ in range(n):
          torch.cuda.synchronize()
          t0 = time.perf_counter()
          request()
          torch.cuda.synchronize()
          times.append((time.perf_counter() - t0) * 1e3)
        wall[mode] = statistics.median(times)
      chip_smoke.set_mode(model, fused_trunk='auto')
      with profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
        request()
        torch.cuda.synchronize()
    busy = sum(getattr(e, 'self_device_time_total',
                       getattr(e, 'self_cuda_time_total', 0))
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(f'{phase}: request {name} {DTYPE} N=4096: kernel '
          f'{wall["auto"]:.3f} ms, plain {wall["off"]:.3f} ms, device busy '
          f'{busy:.3f} ms', flush=True)
    del model
    torch.cuda.empty_cache()


def train_steps(fused_mlp, dev, reps=10, reps_off=2):
  """Phase 10's model (all six fuse flags) and mip-NeRF as shipped (phase
  12's model; phase 15's in float32), their trunks in the run's DTYPE, at
  batch 4096 as chip_smoke.train_setup makes them: after 3 warm-up steps,
  the median wall ms of `reps` steps under fused_trunk='auto' and of
  `reps_off` under 'off', and the device-busy ms of one 'auto' step, in
  chip_smoke's line format. Uses only what every checkout's chip_smoke has
  (its bf16 binding is overridden by a later one)."""
  import statistics
  import time
  import torch
  from torch.profiler import ProfilerActivity, profile
  import chip_smoke
  models = (('phase 10', 'all six', chip_smoke.FLAGSHIP,
             chip_smoke.FUSE + chip_smoke.SPATIAL),
            ('phase 15' if DTYPE == 'float32' else 'phase 12',
             'mip-NeRF shipped', chip_smoke.MIPNERF, []))
  for phase, name, gin, bindings in models:
    model, _, state, train_step, batch = chip_smoke.train_setup(
        dev, bindings + [f"NerfMLP.compute_dtype = '{DTYPE}'"], gin)
    if model.nerf_mlp.cfg.compute_dtype != DTYPE:
      raise AssertionError(f'train_steps: the model is not in {DTYPE}')
    box = {'state': state}

    def step():
      box['state'], _ = train_step(box['state'], batch)

    wall = {}
    for mode, n in (('auto', reps), ('off', reps_off)):
      chip_smoke.set_mode(model, fused_trunk=mode)
      for _ in range(3 if mode == 'auto' else 1):
        step()
      times = []
      for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
      wall[mode] = statistics.median(times)
    chip_smoke.set_mode(model, fused_trunk='auto')
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      step()
      torch.cuda.synchronize()
    busy = sum(getattr(e, 'self_device_time_total',
                       getattr(e, 'self_cuda_time_total', 0))
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(f'{phase}: train step {name} {DTYPE} N=4096: kernel '
          f'{wall["auto"]:.3f} ms, plain {wall["off"]:.3f} ms, device busy '
          f'{busy:.3f} ms', flush=True)
    del model, state, train_step, batch, box
    torch.cuda.empty_cache()


def cascade_steps(fused_mlp, dev, reps=10, reps_off=2):
  """Phase 19's cascade (the flagship over mip-NeRF 360's proposal
  cascade, from chip_smoke.cascade_setup on a sphere scene as phase 19
  writes it): (b) float32 at the gin's batch of 1024 and (c) bf16 with the
  six fuse flags at batch 4096, each after 3 warm-up steps: the median wall
  ms of `reps` train steps under fused_trunk='on' and of `reps_off` under
  'off', the device-busy ms of one 'on' step; then a 4096-ray request
  likewise (`reps` under 'on', `reps_off` under 'off', one profiled), in
  chip_smoke's line format. Ignores the run's DTYPE. Uses only what every
  checkout's chip_smoke has since phase 19 came in."""
  import os
  import shutil
  import statistics
  import tempfile
  import time
  import torch
  from torch.profiler import ProfilerActivity, profile
  import chip_smoke
  from refnerf_tpu_torch.cameras import rays as rays_lib
  from refnerf_tpu_torch.data import prefetch
  from refnerf_tpu_torch.models import renderer
  from refnerf_tpu_torch.tools import sphere_scene

  def timed(fn, n):
    times = []
    for _ in range(n):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      fn()
      torch.cuda.synchronize()
      times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)

  def busy_ms(fn):
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      fn()
      torch.cuda.synchronize()
    return sum(getattr(e, 'self_device_time_total',
                       getattr(e, 'self_cuda_time_total', 0))
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3

  root = tempfile.mkdtemp(prefix='ab_cascade_')
  try:
    scene = sphere_scene.make_scene(
        os.path.join(root, 'scene'), chip_smoke.CASCADE_TRAIN,
        chip_smoke.CASCADE_TEST, chip_smoke.CASCADE_RES)
    for cdt, bindings in (
        ('float32', []),
        ('bfloat16', [*chip_smoke.FUSE, *chip_smoke.SPATIAL,
                      f'Config.batch_size = {chip_smoke.TRAIN_BATCH}'])):
      run = chip_smoke.cascade_setup(dev, scene, None if cdt == 'float32'
                                     else cdt, bindings)
      model, config = run['model'], run['config']
      batches = prefetch.training_batches(run['ds'], device=dev)
      batch = next(batches)
      batches.close()
      box = {'state': run['state']}

      def step():
        box['state'], _ = run['train_step'](box['state'], batch,
                                            run['cameras'])

      rays = chip_smoke.random_rays(rays_lib, 4096, config, 19, dev)
      request = lambda: renderer.render_rays(model, rays,
                                             config.render_chunk_size)
      for what, fn in (('train step', step), ('request', request)):
        wall = {}
        for mode, n in (('on', reps), ('off', reps_off)):
          chip_smoke.set_mode(model, fused_trunk=mode)
          for _ in range(3 if mode == 'on' else 1):
            fn()
          wall[mode] = timed(fn, n)
        chip_smoke.set_mode(model, fused_trunk='on')
        busy = busy_ms(fn)
        n = config.batch_size if fn is step else rays.shape[0]
        print(f'phase 19: cascade {what} {cdt} N={n}: kernel '
              f'{wall["on"]:.3f} ms, plain {wall["off"]:.3f} ms, device busy '
              f'{busy:.3f} ms', flush=True)
      del run, model, box, batch
      torch.cuda.empty_cache()
  finally:
    shutil.rmtree(root, ignore_errors=True)


def forward_kernels(fused_mlp, dev):
  """Every forward case of chip_smoke's phases 3 (K1, K2), 5 (K3), 7 (K8,
  K8+K9, K10, all three), 9 (K7, K7+K3, K6+K7, K6+K3, K6+K7+K3), 11 (K1
  hf=0, K2 W128, K11) and 19 (K1 wide: the proposal trunk of depth 4 on
  504 columns) in the run's DTYPE against its plain version at
  chip_smoke's N,
  through chip_smoke.compare (which prints each case's kernel and plain
  ms). Uses only what every checkout's chip_smoke has."""
  import torch
  import chip_smoke as cs
  cdt = DTYPE
  bf = fused_mlp.DTYPES[cdt]
  n = cs.N_SAMPLES
  gen = torch.Generator().manual_seed(cs.SEED)
  fold = torch.as_tensor(fused_mlp.ipe_scale_fold(cs.SCALES, 3), device=dev)
  for which, trunk, dg in (('K1', 'K1', False), ('K2', 'K2', False),
                           ('K3', 'K1', True), ('K1 hf=0', 'mip K1', False)):
    segs, ws, bs, kw = cs.trunk_case(trunk, gen, dev, ipe=trunk != 'K2')
    segs = [s.to(bf) for s in segs]
    pack = fused_mlp.pack_trunk(ws, bs, [s.shape[-1] for s in segs],
                                compute_dtype=cdt, **kw)
    f = fold if dg else None
    cs.compare(which, cdt, lambda: fused_mlp.trunk_kernel(segs, pack, f),
               lambda: fused_mlp.trunk_reference(
                   segs, ws, bs, compute_dtype=cdt, density_grad=dg, fold=f,
                   **kw),
               n_values=1 + (kw['head_f32'] is not None) +
               (kw['head_cdt'] is not None), phase=3,
               inputs=segs + cs.pack_tensors(pack),
               flops=cs.trunk_flops(ws, n, cs.n_heads(kw), density_grad=dg))
    del segs, ws, bs, kw, pack
  mat = fused_mlp.ref_utils.ide_tables(5)[0]
  for which, (ide, geo, rgb) in cs.DIR_CASES:
    segs, ws, bs, head, dm, rgbx = cs.dir_case(fused_mlp, gen, dev, ide, geo,
                                               rgb)
    raw = range(1, 1 + dm.n_raw())
    segs = [s if j in raw else s.to(bf) for j, s in enumerate(segs)]
    pack = fused_mlp.pack_trunk(ws, bs, fused_mlp.visible_dims(segs, dm),
                                head_f32=head, compute_dtype=cdt)
    kws = dict(dir_modes=dm, rgbx=rgbx)
    cs.compare(which, cdt, lambda: fused_mlp.trunk_kernel(segs, pack, **kws),
               lambda: fused_mlp.trunk_reference(
                   segs, ws, bs, head_f32=head, compute_dtype=cdt, **kws),
               n_values=2 if rgb else 1, phase=7,
               inputs=segs + cs.pack_tensors(pack) + list(rgbx or []),
               flops=cs.trunk_flops(ws, n, 3),
               f32_flops=cs.dir_flops(mat, ide, geo, rgb, backward=False))
    del segs, ws, bs, pack
  for which, (enc, comp, dg, backward, trunk) in cs.SPA_CASES:
    if backward or trunk != 'K1':
      continue
    segs, ws, bs, kw, sp, cp = cs.spa_case(fused_mlp, gen, dev, enc, comp,
                                           trunk)
    segs = segs if enc else [s.to(bf) for s in segs]
    pack = fused_mlp.pack_trunk(ws, bs, (48, 48), compute_dtype=cdt, **kw)
    f = fold if dg else None
    kws = dict(spa_modes=sp, comp=cp)
    cs.compare(which, cdt,
               lambda: fused_mlp.trunk_kernel(segs, pack, f, **kws),
               lambda: fused_mlp.trunk_reference(
                   segs, ws, bs, compute_dtype=cdt, density_grad=dg, fold=f,
                   **kws, **kw),
               n_values=3, phase=9,
               inputs=segs + cs.pack_tensors(pack) + [f] + list(cp or []),
               flops=cs.trunk_flops(ws, n, cs.n_heads(kw), density_grad=dg),
               f32_flops=cs.spa_flops(enc, comp, dg, False),
               weights=3 + int(dg) if comp else None)
    del segs, ws, bs, kw, pack
  for which, trunk in (('K2 W128', 'mip K2'), ('K11', 'mip K11')):
    y = which == 'K11'
    segs, ws, bs, kw = cs.trunk_case(trunk, gen, dev, ipe=y)
    segs = [s.to(bf) for s in segs]
    pack = fused_mlp.pack_trunk(ws, bs, [s.shape[-1] for s in segs],
                                compute_dtype=cdt, **kw)
    cs.compare(which, cdt,
               lambda: fused_mlp.trunk_kernel(segs, pack, out_y=y),
               lambda: fused_mlp.trunk_reference(segs, ws, bs,
                                                 compute_dtype=cdt, out_y=y,
                                                 **kw),
               n_values=3, phase=11, inputs=segs + cs.pack_tensors(pack),
               flops=cs.trunk_flops(ws, n, cs.n_heads(kw)),
               y=0 if y else None)
    del segs, ws, bs, kw, pack
  segs, ws, bs, kw = cs.prop_case(fused_mlp, gen, dev, 4, cdt)
  pack = fused_mlp.pack_trunk(ws, bs, (252, 252), compute_dtype=cdt, **kw)
  cs.compare('K1 wide', cdt, lambda: fused_mlp.trunk_kernel(segs, pack),
             lambda: fused_mlp.trunk_reference(segs, ws, bs,
                                               compute_dtype=cdt, **kw),
             n_values=1, phase=19, inputs=segs + cs.pack_tensors(pack),
             flops=cs.trunk_flops(ws, n, 1))
  del segs, ws, bs, kw, pack
  torch.cuda.empty_cache()


def backward_kernels(fused_mlp, dev):
  """Every backward case of chip_smoke's phases 5 (K4, K5), 7 (K8+K9+K10),
  9 (K6+K7+K4), 11 (K11, K4 first-order, K5 W128) and 19 (K4 wide: the
  proposal trunk of depth 4 on 504 columns) in the run's DTYPE against its
  plain version at chip_smoke's N, through chip_smoke.compare
  (which prints each case's kernel and plain ms). Uses only what every
  checkout's chip_smoke has."""
  import torch
  import chip_smoke as cs
  cdt = DTYPE
  tdt = fused_mlp.DTYPES[cdt]
  n = cs.N_SAMPLES
  gen = torch.Generator().manual_seed(cs.SEED + 5)
  rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
  fold = torch.as_tensor(fused_mlp.ipe_scale_fold(cs.SCALES, 3), device=dev)
  bwd = lambda ws, kw, **k: cs.trunk_flops(ws, n, cs.n_heads(kw),
                                           backward=True, **k)
  for which, trunk in (('K4', 'K1'), ('K5', 'K2'), ('K11 backward', 'mip K11'),
                       ('K4 first-order', 'mip K1'), ('K5 W128', 'mip K2')):
    spatial = trunk in ('K1', 'mip K1', 'mip K11')
    segs, ws, bs, kw = cs.trunk_case(trunk, gen, dev, ipe=spatial)
    segs = [s.to(tdt) for s in segs]
    pack = fused_mlp.pack_trunk(ws, bs, [s.shape[-1] for s in segs],
                                compute_dtype=cdt, **kw)
    f = fold if which == 'K4' else None
    hf = kw['head_f32'][0].shape[0] if kw['head_f32'] else 0
    cots = ((rand(n), rand(n, hf) if hf else None,
             rand(n, 128) if kw['head_cdt'] else None,
             rand(n, 3) if f is not None else None) if spatial
            else (None, rand(n, 3), None, None))
    yb = rand(n, 256).to(tdt) if trunk == 'mip K11' else None
    cs.compare(which, cdt,
               lambda: fused_mlp.trunk_backward_kernel(
                   segs, pack, cots, f, needs_dx=not spatial, ybar=yb),
               lambda: fused_mlp.trunk_backward_reference(
                   segs, ws, bs, cots, compute_dtype=cdt, fold=f,
                   needs_dx=not spatial, ybar=yb, **kw),
               n_values=0, iters=3, phase=5,
               inputs=segs + cs.pack_tensors(pack) + list(cots) + [f, yb],
               flops=bwd(ws, kw, density_grad=f is not None,
                         needs_dx=not spatial))
    del segs, ws, bs, kw, pack, cots, yb
  mat = fused_mlp.ref_utils.ide_tables(5)[0]
  segs, ws, bs, head, dm, rgbx = cs.dir_case(fused_mlp, gen, dev, True, True,
                                             True)
  raw = range(1, 1 + dm.n_raw())
  segs = [s if j in raw else s.to(tdt) for j, s in enumerate(segs)]
  pack = fused_mlp.pack_trunk(ws, bs, fused_mlp.visible_dims(segs, dm),
                              head_f32=head, compute_dtype=cdt)
  cots, rgb_bar = (None, rand(n, 3), None, None), rand(n, 3)
  kws = dict(dir_modes=dm, rgbx=rgbx, rgb_bar=rgb_bar)
  cs.compare('K8+K9+K10 backward', cdt,
             lambda: fused_mlp.trunk_backward_kernel(segs, pack, cots,
                                                     needs_dx=True, **kws),
             lambda: fused_mlp.trunk_backward_reference(
                 segs, ws, bs, cots, head_f32=head, compute_dtype=cdt,
                 needs_dx=True, **kws),
             n_values=0, iters=3, phase=7,
             inputs=segs + cs.pack_tensors(pack) + [cots[1], rgb_bar],
             flops=cs.trunk_flops(ws, n, 3, backward=True, needs_dx=True),
             f32_flops=cs.dir_flops(mat, True, True, True, backward=True))
  del segs, ws, bs, pack
  segs, ws, bs, kw, sp, cp = cs.spa_case(fused_mlp, gen, dev, True, True)
  pack = fused_mlp.pack_trunk(ws, bs, (48, 48), compute_dtype=cdt, **kw)
  cots = (rand(n), rand(n, 10), rand(n, 128), rand(n, 3), rand(n))
  with torch.no_grad():
    sk = fused_mlp.trunk_kernel(segs, pack, fold, spa_modes=sp, comp=cp)[0]
    sr = fused_mlp.trunk_reference(segs, ws, bs, compute_dtype=cdt,
                                   spa_modes=sp, comp=cp, **kw)[0]
  cs.compare('K6+K7+K4', cdt,
             lambda: fused_mlp.trunk_backward_kernel(
                 segs, pack, cots, fold, spa_modes=sp, comp=cp + (sk,)),
             lambda: fused_mlp.trunk_backward_reference(
                 segs, ws, bs, cots, compute_dtype=cdt, fold=fold,
                 spa_modes=sp, comp=cp + (sr,), **kw),
             n_values=0, iters=3, phase=9,
             inputs=segs + cs.pack_tensors(pack) + list(cots) + [fold, sk],
             flops=cs.trunk_flops(ws, n, cs.n_heads(kw), density_grad=True,
                                  backward=True),
             f32_flops=cs.spa_flops(True, True, True, True))
  del segs, ws, bs, pack, cots
  segs, ws, bs, kw = cs.prop_case(fused_mlp, gen, dev, 4, cdt)
  pack = fused_mlp.pack_trunk(ws, bs, (252, 252), compute_dtype=cdt, **kw)
  cots = (rand(n), None, None, None)
  cs.compare('K4 wide', cdt,
             lambda: fused_mlp.trunk_backward_kernel(segs, pack, cots),
             lambda: fused_mlp.trunk_backward_reference(
                 segs, ws, bs, cots, compute_dtype=cdt, **kw),
             n_values=0, iters=3, phase=19,
             inputs=segs + cs.pack_tensors(pack) + [cots[0]],
             flops=cs.trunk_flops(ws, n, 1, backward=True))
  torch.cuda.empty_cache()


def w1024_pair(fused_mlp, dev):
  """Phase 24's width-1024 pair (mip-NeRF 360's NeRF MLP trunk,
  chip_smoke.w1024_case) at chip_smoke's N in bfloat16 and float32 (the
  run's DTYPE not read): the forward (K1 W1024 hc256) and the first-order
  backward (K4 1st W1024) each against its plain version through
  chip_smoke.compare (which prints kernel, plain and library ms), with
  chip_smoke.w1024_chain, the PyTorch chain of the same function (its
  f32 products in full f32: TF32 off), timed between them, without phase
  24's reruns and planted faults. Uses only what every checkout's
  chip_smoke has since `w1024_chain` came in."""
  import torch
  import chip_smoke as cs
  n = cs.N_SAMPLES
  gen = torch.Generator().manual_seed(cs.SEED + 24)
  segs, ws, bs, kw, cots = cs.w1024_case(fused_mlp, gen, dev, n)
  for cdt in ('bfloat16', 'float32'):
    tdt = fused_mlp.DTYPES[cdt]
    xs = [s.to(tdt) for s in segs]
    cn = cots[:2] + (cots[2].to(tdt), None)
    pack = fused_mlp.pack_trunk(ws, bs, (252, 252), compute_dtype=cdt, **kw)
    cs.compare('K1 W1024 hc256', cdt,
               lambda: fused_mlp.trunk_kernel(xs, pack),
               lambda: fused_mlp.trunk_reference(xs, ws, bs,
                                                 compute_dtype=cdt, **kw),
               n_values=2, phase=24, iters=3,
               inputs=xs + cs.pack_tensors(pack), n=n,
               flops=cs.trunk_flops(ws, n, 257),
               library=cs.w1024_chain(fused_mlp, xs, ws, bs, kw, cdt))
    cs.compare('K4 1st W1024', cdt,
               lambda: fused_mlp.trunk_backward_kernel(xs, pack, cn),
               lambda: fused_mlp.trunk_backward_reference(
                   xs, ws, bs, cn, compute_dtype=cdt, **kw),
               n_values=0, iters=2, phase=24,
               inputs=xs + cs.pack_tensors(pack) + list(cn), n=n,
               flops=cs.trunk_flops(ws, n, 257, backward=True),
               library=cs.w1024_chain(fused_mlp, xs, ws, bs, kw, cdt, cn))
    del xs, cn, pack
    torch.cuda.empty_cache()


def m360_steps(fused_mlp, dev, reps=5, reps_off=1):
  """MIPNERF360 at full width (chip_smoke.m360_setup: its batch of 16,384
  random rays, both MLPs' trunks in the run's DTYPE): after 2 warm-up
  steps the median wall ms of `reps` train steps under fused_trunk='on'
  and of `reps_off` under 'off' (one warm-up), the device-busy ms of one
  'on' step and the peak memory allocated over the 'on' steps; then a
  4096-ray request (one chunk, as phase 24's) likewise, in chip_smoke's
  line format. Uses only what every checkout's chip_smoke has since phase
  24 came in."""
  import statistics
  import time
  import torch
  from torch.profiler import ProfilerActivity, profile
  import chip_smoke
  from refnerf_tpu_torch.cameras import rays as rays_lib
  from refnerf_tpu_torch.models import renderer
  run = chip_smoke.m360_setup(dev, DTYPE)
  model, batch = run['model'], run['batch']
  box = {'state': run['state']}

  def step():
    box['state'], _ = run['train_step'](box['state'], batch)

  rays = chip_smoke.random_rays(rays_lib, chip_smoke.M360_REQUEST,
                                run['config'], 24, dev)
  request = lambda: renderer.render_rays(model, rays, chip_smoke.M360_REQUEST)
  for what, fn, n in (('train step', step, run['config'].batch_size),
                      ('request', request, chip_smoke.M360_REQUEST)):
    wall, peak = {}, 0.0
    for mode, reps_mode in (('on', reps), ('off', reps_off)):
      chip_smoke.set_mode(model, fused_trunk=mode)
      for _ in range(2 if mode == 'on' else 1):
        fn()
      torch.cuda.synchronize()
      torch.cuda.reset_peak_memory_stats()
      times = []
      for _ in range(reps_mode):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
      wall[mode] = statistics.median(times)
      if mode == 'on':
        peak = torch.cuda.max_memory_allocated() / 2**30
    chip_smoke.set_mode(model, fused_trunk='on')
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
      fn()
      torch.cuda.synchronize()
    busy = sum(getattr(e, 'self_device_time_total',
                       getattr(e, 'self_cuda_time_total', 0))
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    print(f'phase 24: MIPNERF360 {what} {DTYPE} N={n}: kernel '
          f'{wall["on"]:.3f} ms, plain {wall["off"]:.3f} ms, device busy '
          f'{busy:.3f} ms, peak {peak:.3f} GiB', flush=True)
  del run, model, box, batch
  torch.cuda.empty_cache()


def m360_dir_pair(fused_mlp, dev):
  """Phase 24's directional pair (mip-NeRF 360's 1 x 128 trunk on [256 |
  27] with the rgb head, `dir1_case`) at chip_smoke's N in the run's DTYPE:
  the forward (K2 m360) and the backward with dx (K5 m360) each against its
  plain version through chip_smoke.compare, the PyTorch chain of the same
  function (`w1024_chain`, the concatenation inside) timed between; the
  routes printed (the parent's pair on trunk_fwd.cu / trunk_bwd.cu). Uses
  only what every checkout's chip_smoke has since phase 24 came in."""
  import torch
  import chip_smoke as cs
  cdt = DTYPE
  n = cs.N_SAMPLES
  gen = torch.Generator().manual_seed(cs.SEED + 24)
  segs, ws, bs, kw, cots = dir1_case(gen, dev, n)
  segs = [s.to(fused_mlp.DTYPES[cdt]) for s in segs]
  pack = fused_mlp.pack_trunk(ws, bs, (256, 27), compute_dtype=cdt, **kw)
  print(f'phase 24: directional pair {cdt}: routes '
        f'{fused_mlp.forward_library(pack)}, '
        f'{fused_mlp.backward_library(pack)}', flush=True)
  passes = 3 if cdt == 'float32' else 0
  cs.compare('K2 m360', cdt, lambda: fused_mlp.trunk_kernel(segs, pack),
             lambda: fused_mlp.trunk_reference(segs, ws, bs,
                                               compute_dtype=cdt, **kw),
             n_values=1, phase=24, inputs=segs + cs.pack_tensors(pack), n=n,
             flops=cs.trunk_flops(ws, n, 3), tf32_passes=passes,
             library=w1024_chain(fused_mlp, segs, ws, bs, kw, cdt))
  cs.compare('K5 m360', cdt,
             lambda: fused_mlp.trunk_backward_kernel(segs, pack, cots,
                                                     needs_dx=True),
             lambda: fused_mlp.trunk_backward_reference(
                 segs, ws, bs, cots, compute_dtype=cdt, needs_dx=True, **kw),
             n_values=0, iters=3, phase=24, n=n,
             inputs=segs + cs.pack_tensors(pack) + [cots[1]],
             flops=cs.trunk_flops(ws, n, 3, backward=True, needs_dx=True),
             tf32_passes=passes,
             library=w1024_chain(fused_mlp, segs, ws, bs, kw, cdt, cots,
                                 needs_dx=True))
  del segs, pack, cots
  torch.cuda.empty_cache()


def chain_rows(fused_mlp, dev):
  """The PyTorch chain (`w1024_chain`: torch.cat, linear + relu a layer,
  the heads; autograd for the backward) of every trunk row of PERF.md that
  it computes without a fused stage or the density gradient, timed between
  the kernel and its plain version through chip_smoke.compare at
  chip_smoke's N in the run's DTYPE: the forwards K1 (the flagship's
  spatial trunk, its f32 and bf16 heads), K1 hf=0 (mip-NeRF's spatial
  trunk), K2, K2 W128, K11 (mip-NeRF's spatial trunk with y out, the
  chain's y among its outputs) and K1 wide (the proposal trunk of depth 4
  on 504 columns); the backwards K4 first-order, K5, K5 W128 and K4 wide.
  Uses only what every checkout's chip_smoke has since phase 19 came in
  (K11's chain the `out_y` of this checkout's `w1024_chain`)."""
  import torch
  import chip_smoke as cs
  cdt = DTYPE
  tdt = fused_mlp.DTYPES[cdt]
  n = cs.N_SAMPLES
  gen = torch.Generator().manual_seed(cs.SEED + 25)
  rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
  for which, trunk, backward in (
      ('K1', 'K1', False), ('K1 hf=0', 'mip K1', False), ('K2', 'K2', False),
      ('K2 W128', 'mip K2', False), ('K11', 'mip K11', False),
      ('K1 wide', None, False), ('K4 first-order', 'mip K1', True),
      ('K5', 'K2', True), ('K5 W128', 'mip K2', True),
      ('K4 wide', None, True)):
    y = which == 'K11'
    if trunk is None:
      segs, ws, bs, kw = cs.prop_case(fused_mlp, gen, dev, 4, cdt)
    else:
      segs, ws, bs, kw = cs.trunk_case(trunk, gen, dev,
                                       ipe=trunk in ('mip K1', 'mip K11'))
    segs = [s.to(tdt) for s in segs]
    pack = fused_mlp.pack_trunk(ws, bs, [s.shape[-1] for s in segs],
                                compute_dtype=cdt, **kw)
    heads = cs.n_heads(kw)
    if not backward:
      cs.compare(which, cdt,
                 lambda: fused_mlp.trunk_kernel(segs, pack, out_y=y),
                 lambda: fused_mlp.trunk_reference(segs, ws, bs,
                                                   compute_dtype=cdt,
                                                   out_y=y, **kw),
                 n_values=y + 1 + (kw['head_f32'] is not None) +
                 (kw['head_cdt'] is not None), phase=3,
                 inputs=segs + cs.pack_tensors(pack),
                 flops=cs.trunk_flops(ws, n, heads), y=0 if y else None,
                 library=w1024_chain(fused_mlp, segs, ws, bs, kw, cdt,
                                     out_y=y))
    else:
      spatial = kw['wd'] is not None
      hc = kw['head_cdt'][0].shape[0] if kw['head_cdt'] else 0
      cots = ((rand(n), None, rand(n, hc).to(tdt) if hc else None, None)
              if spatial else (None, rand(n, 3), None, None))
      cs.compare(which, cdt,
                 lambda: fused_mlp.trunk_backward_kernel(
                     segs, pack, cots, needs_dx=not spatial),
                 lambda: fused_mlp.trunk_backward_reference(
                     segs, ws, bs, cots, compute_dtype=cdt,
                     needs_dx=not spatial, **kw),
                 n_values=0, iters=3, phase=5,
                 inputs=segs + cs.pack_tensors(pack) + list(cots),
                 flops=cs.trunk_flops(ws, n, heads, backward=True,
                                      needs_dx=not spatial),
                 library=w1024_chain(fused_mlp, segs, ws, bs, kw, cdt, cots,
                                     needs_dx=not spatial))
    del segs, ws, bs, kw, pack
    torch.cuda.empty_cache()


# Run in every checkout.
OWN = {f.__name__: f for f in (serve_requests, train_steps, cascade_steps,
                               forward_kernels, backward_kernels, w1024_pair,
                               m360_steps, m360_dir_pair, chain_rows)}
# This checkout's chip_smoke functions that OWN's checks call, sent with
# them so that every arm runs the same code.
SHARED = ('w1024_chain', 'dir1_case')
BUILD = 'from refnerf_tpu_torch.ops import cuda_build; cuda_build.build()'
# Trailing template arguments at their defaults, as cu++filt prints them: a
# false flag, or the trunk width 256.
DEFAULTS = ('false', '(bool)0', '(int)256')
TIMES = re.compile(r'^phase \d+: (.+?) (float32|bfloat16) N=\d+: .*?kernel '
                   r'([\d.]+) ms, plain ([\d.]+) ms', re.M)
LIBRARY = re.compile(r'^phase \d+: (.+?) (float32|bfloat16) N=\d+: .*?library '
                     r'([\d.]+) ms', re.M)
BUSY = re.compile(r'^phase \d+: (.+?) (float32|bfloat16) N=\d+: .*?device '
                  r'busy ([\d.]+) ms', re.M)
SASS = re.compile(r'/\*[0-9a-f]{4,}\*/\s+(.*?;)')
NAME = re.compile(r'(\w+)<(.*)>\(')
PLAIN = re.compile(r'(\w+)\(')  # a kernel that is no template


def cuda_tool(name):
  found = shutil.which(name) or f'/usr/local/cuda/bin/{name}'
  if not pathlib.Path(found).exists():
    raise RuntimeError(f'{name} not found (PATH, /usr/local/cuda/bin)')
  return found


def build(arms):
  """Every arm's kernels, built at once (one nvcc per source and arm)."""
  procs = {arm: subprocess.Popen([sys.executable, '-c', BUILD], cwd=root,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
           for arm, root in arms.items()}
  for arm, proc in procs.items():
    log = proc.communicate(timeout=1200)[0]
    if proc.returncode != 0:
      raise RuntimeError(f'{arm}: the build exited {proc.returncode}:\n'
                         f'{log[-3000:]}')


def run_arms(arms, order, out, checks, dtype='bfloat16'):
  """{(case, dtype): {arm: [(kernel ms, plain ms, device busy ms or None,
  library ms or None) per run]}}."""
  times = {}
  sys.path.insert(0, '.')
  import chip_smoke  # this checkout's
  shared = ''.join(inspect.getsource(getattr(chip_smoke, name)) + '\n'
                   for name in SHARED)
  run = (f'CHECKS = {checks!r}\nOWN = {sorted(OWN)!r}\nDTYPE = {dtype!r}\n' +
         'import math, torch\n' + shared +
         ''.join(inspect.getsource(f) + '\n' for f in OWN.values()) + RUN)
  for i, arm in enumerate(order):
    proc = subprocess.run([sys.executable, '-c', run],
                          cwd=arms[arm], capture_output=True, text=True,
                          timeout=1800)
    (out / f'run{i}_{arm}.log').write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
      raise RuntimeError(f'run {i} ({arm}) exited {proc.returncode}:\n'
                         f'{proc.stderr[-3000:]}')
    busy = {(case, cdt): float(b)
            for case, cdt, b in BUSY.findall(proc.stdout)}
    lib = {(case, cdt): float(b)
           for case, cdt, b in LIBRARY.findall(proc.stdout)}
    for case, cdt, k, p in TIMES.findall(proc.stdout):
      times.setdefault((case, cdt), {}).setdefault(arm, []).append(
          (float(k), float(p),
           busy.get((case, cdt)), lib.get((case, cdt))))
    print(f'run {i} ({arm}) done', flush=True)
  return times


def functions(lib):
  """{(kernel name, template arguments): SASS instructions} of a library."""
  text = subprocess.run([cuda_tool('cuobjdump'), '-sass', str(lib)],
                        capture_output=True, text=True, check=True).stdout
  blocks = re.split(r'\n\s*Function : (\S+)\n', text)
  names = blocks[1::2]
  plain = subprocess.run([cuda_tool('cu++filt')], input='\n'.join(names),
                         capture_output=True, text=True,
                         check=True).stdout.splitlines()
  found = {}
  for name, body in zip(plain, blocks[2::2]):
    m, p = NAME.search(name), PLAIN.search(name)
    key = ((m.group(1), tuple(m.group(2).split(', '))) if m else
           (p.group(1), ()) if p else (name, ()))
    found[key] = SASS.findall(body)
  return found


def same_instance(key, others):
  """The key in `others` that names the same instance as `key`."""
  name, args = key
  for other in others:
    if other[0] != name:
      continue
    a, b = (args, other[1]) if len(args) <= len(other[1]) else (other[1], args)
    if b[:len(a)] == a and all(x in DEFAULTS for x in b[len(a):]):
      return other
  return None


def compare_sass(arms, out):
  """Per library and kernel instance of the first arm: 'same' or the
  number of differing instruction lines against each other arm."""
  first, *rest = arms
  report = {}
  for lib in sorted((arms[first] / 'build' / 'refnerf_tpu_torch').glob('*.so')):
    stem = lib.name.rsplit('_', 1)[0]
    base = functions(lib)
    for arm in rest:
      libs = [l for l in (arms[arm] / 'build' / 'refnerf_tpu_torch').glob(
          stem + '_*.so') if l.name.rsplit('_', 1)[0] == stem]
      if len(libs) != 1:
        raise RuntimeError(f'{arm}: {len(libs)} builds of {stem}')
      other = functions(libs[0])
      for key, code in base.items():
        match = same_instance(key, other)
        label = f'{stem} {key[0]}<{", ".join(key[1])}>'
        if match is None:
          verdict = f'not in {arm}'
        elif other[match] == code:
          verdict = f'same SASS in {arm} ({len(code)} instructions)'
        else:
          diff = [l for l in difflib.unified_diff(code, other[match], n=0,
                                                  lineterm='')
                  if l[:1] in '+-' and l[:3] not in ('+++', '---')]
          name = re.sub(r'\W+', '_', label).strip('_')
          (out / f'sass_{arm}_{name}.diff').write_text('\n'.join(diff))
          verdict = (f'differs in {arm}: {len(code)} vs '
                     f'{len(other[match])} instructions, {len(diff)} lines')
        report.setdefault(label, []).append(verdict)
  return report


def main():
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument('--arm', action='append', required=True,
                  help='name=checkout directory; the first is the base')
  ap.add_argument('--order', default='',
                  help='arm names, comma-separated (none: only the SASS)')
  ap.add_argument('--out', default='chiprun_out/ab')
  ap.add_argument('--checks', default='check_train_kernels',
                  help='chip_smoke functions a run calls, comma-separated')
  ap.add_argument('--dtype', default='bfloat16',
                  choices=('bfloat16', 'float32'),
                  help="the trunks of serve_requests, train_steps, "
                  'forward_kernels and backward_kernels')
  a = ap.parse_args()
  arms = {k: pathlib.Path(v).resolve()
          for k, v in (s.split('=', 1) for s in a.arm)}
  order = a.order.split(',') if a.order else []
  if order and set(order) != set(arms):
    raise SystemExit('--order must name every arm')
  out = pathlib.Path(a.out)
  out.mkdir(parents=True, exist_ok=True)
  build(arms)
  times = run_arms(arms, order, out, a.checks.split(','), a.dtype)
  summary = {}
  for (case, cdt), by_arm in times.items():
    row = {}
    for arm, runs in by_arm.items():
      ks, ps = [r[0] for r in runs], [r[1] for r in runs]
      row[arm] = {'kernel_ms': ks, 'plain_ms': ps,
                  'kernel_median': statistics.median(ks),
                  'plain_median': statistics.median(ps)}
      text = ''
      for i, what in ((2, 'busy'), (3, 'library')):
        vs = [r[i] for r in runs if r[i] is not None]
        if vs:
          row[arm].update({f'{what}_ms': vs,
                           f'{what}_median': statistics.median(vs)})
          text += (f', {"device busy" if i == 2 else what} ' +
                   ' '.join(f'{v:.3f}' for v in vs) +
                   f' (median {statistics.median(vs):.3f}) ms')
      print(f'{case} {cdt} {arm}: kernel ' + ' '.join(f'{k:.3f}' for k in ks)
            + f' (median {row[arm]["kernel_median"]:.3f}) ms, plain '
            + ' '.join(f'{p:.3f}' for p in ps)
            + f' (median {row[arm]["plain_median"]:.3f}) ms' + text)
    summary[f'{case} {cdt}'] = row
  sass = compare_sass(arms, out)
  for label, verdicts in sass.items():
    print(f'{label}: {"; ".join(verdicts)}')
  (out / 'summary.json').write_text(json.dumps(
      {'order': order, 'times': summary, 'sass': sass},
      indent=1))
  return 0


if __name__ == '__main__':
  sys.exit(main())
