#!/usr/bin/env python3
"""Serve and train the flagship Ref-NeRF model through the PyTorch port on one GPU.

Run from the root of the repository, with no arguments, on a machine with an
NVIDIA H100 (sm_90a) and the CUDA toolkit:

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels of refnerf_tpu_torch/csrc with nvcc;
  3. hold each trunk kernel (K1 spatial, K2 directional) against its plain
     PyTorch version at the serving shape N = 4096 rays x 128 samples, in
     float32 and bfloat16, and time both;
  4. build the model of configs/blender_refnerf.gin at full width (bf16
     trunks, weights from a seeded torch.Generator) and answer three
     requests: 4096 rays, 5000 rays (two chunks) and a 64x64 pinhole image;
     check every output and that each kernel ran levels x chunks times;
     answer the first request again with fused_trunk='off' and compare;
  5. hold each training kernel against its plain PyTorch version at the same
     N, in float32 and bfloat16, and time both: K3 (the forward with the
     density gradient) on every output and u, K4 (the spatial backward) on
     every weight and bias gradient given random cotangents of sigma, the
     heads, the bottleneck and u, K5 (the directional backward) on every
     parameter gradient and both segment cotangents;
  6. train the flagship at batch 4096 with bf16 trunks as bench.py drives the
     JAX step (3 warm-up steps, then 10 timed ones); check every loss term is
     finite, the parameters moved, and K2-K5 each ran levels x steps times;
     take one more step's gradients with fused_trunk='off' from the same
     state and compare the loss and the global gradient norm.
The line before the last is a JSON list of the kernels; the last line is
{"ok": true, "device": {...}}. Any failure raises: the exit code is not 0 and
no result line is printed.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

N_SAMPLES = 4096 * 128  # one chunk of rays x samples per level
SEED = 0
# Kernel vs plain version, values of the trunk (sigma, the heads, the
# bottleneck, rgb): max |kernel - plain| <= bound * max(1, max|plain|).
# f32: the same f32 arithmetic summed in another order. bf16: both round
# every layer's f32 sum to bf16, and a sum on a rounding boundary flips one
# bf16 ulp (2^-8 relative) that later layers carry along.
KERNEL_BOUND = {'float32': 1e-4, 'bfloat16': 5e-2}
# Derivatives (u, every parameter gradient, dx): relative L2 error
# |kernel - plain|_2 / |plain|_2 <= bound, with the max error relative to
# max|plain| printed beside it. A derivative of a ReLU trunk jumps where a
# pre-activation crosses 0: relu' is 1 on one side and 0 on the other. At
# N = 524,288 samples (2,048 units each) some pre-activations lie within
# the summation-order noise of 0, in f32 too, so the two sides disagree on a
# few masks. Each flip moves that one sample's u or dx by ~1/sqrt(active
# units), about 10%, so the max error says only that a flip happened; the
# L2 error weighs the flips by how rare they are. bf16: both sides also
# round the cotangents (g, zeta, q, p) to bf16 at the same places.
GRAD_BOUND = {'float32': 5e-3, 'bfloat16': 5e-2}
SCALES = 2.0**np.arange(0, 16)  # the flagship's IPE degrees (max_deg_point 16)
# The train step (phase 6), as bench.py times it.
TRAIN_BATCH, TRAIN_WARMUP, TRAIN_STEPS = 4096, 3, 10
# One step's loss and global gradient norm through the kernels vs
# fused_trunk='off' from the same state, relative, bf16 trunks on both
# sides: they differ by the summation order of the products and the rare
# bf16 ulp (2^-8) it flips, which the served rgb showed at ~1e-5.
TRAIN_LOSS_BOUND, TRAIN_GNORM_BOUND = 1e-3, 1e-2
# Served rgb of the kernel path vs fused_trunk='off' (both bf16 trunks).
PATH_BOUND = 2e-2


def log(msg):
  print(msg, flush=True)


def cuda_ms(fn, iters=5):
  """Mean device time of fn() over iters launches, after one warm-up."""
  fn()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(iters):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / iters


def trunk_case(which, gen, dev, ipe=False):
  """Flagship-width trunk weights (He-scaled so activations stay O(1)) and
  segments of N_SAMPLES rows: K1 segments (48, 48), heads 10 f32 + 128
  bottleneck; K2 segments (128, 73), head 3 (rgb). With `ipe` the K1
  segments are the IPE encoding of random lifted means and variances."""
  seg_dims, hf, hc = ((48, 48), 10, 128) if which == 'K1' else ((128, 73), 3, 0)
  fin, width, depth = sum(seg_dims), 256, 8
  rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
  ws, bs = [], []
  for l in range(depth):
    k_in = fin if l == 0 else width + (fin if l == 5 else 0)
    ws.append(rand(width, k_in) * math.sqrt(2 / k_in))
    bs.append(rand(width) * 0.05)
  kw = dict(skip_period=4,
            wd=rand(1, width) / math.sqrt(width) if which == 'K1' else None,
            head_f32=(rand(hf, width) / math.sqrt(width), rand(hf) * 0.1),
            head_cdt=((rand(hc, width) / math.sqrt(width), rand(hc) * 0.1)
                      if hc else None))
  if ipe:
    from refnerf_tpu_torch.ops import fused_mlp
    lm = torch.rand(N_SAMPLES, 3, generator=gen).to(dev) * 3 - 1.5
    lv = 10.0**(torch.rand(N_SAMPLES, 3, generator=gen).to(dev) * 4 - 6)
    segs = list(fused_mlp.encode_ipe(lm, lv, SCALES))
  else:
    segs = [torch.rand(N_SAMPLES, d, generator=gen).to(dev) * 2 - 1
            for d in seg_dims]
  return segs, ws, bs, kw


def flatten(outs):
  """The tensors of a nested list/tuple of outputs, Nones dropped."""
  flat = []
  for o in outs:
    if isinstance(o, (list, tuple)):
      flat += flatten(o)
    elif o is not None:
      flat.append(o)
  return flat


def errors(got, want, cdt, n_values):
  """Per output: (max abs err, that relative to max(1, max|plain|), relative
  L2 err, share of its bound). The first n_values outputs are values, held
  by KERNEL_BOUND on the max error; the rest are derivatives, held by
  GRAD_BOUND on the L2 error."""
  if len(got) != len(want) or not all(
      a.dtype == b.dtype and a.shape == b.shape for a, b in zip(got, want)):
    raise AssertionError('outputs differ in number, dtype or shape')
  rows = []
  for i, (a, b) in enumerate(zip(got, want)):
    d, b = a.float() - b.float(), b.float()
    e = d.abs().max().item()
    rel = e / max(1.0, b.abs().max().item())
    l2 = d.norm().item() / max(b.norm().item(), 1e-30)
    share = (rel / KERNEL_BOUND[cdt] if i < n_values
             else l2 / GRAD_BOUND[cdt])
    rows.append((e, rel, l2, share))
  return rows


def compare(which, cdt, kernel, plain, n_values, iters=5):
  """Run kernel() and plain() once and compare every output (see errors());
  then time both in turns. Returns (max abs err, kernel ms, plain ms)."""
  phase = 5 if which in ('K3', 'K4', 'K5') else 3
  with torch.no_grad():
    got, want = flatten(kernel()), flatten(plain())
    torch.cuda.synchronize()
    rows = errors(got, want, cdt, n_values)
    del got, want
    p1, k1 = cuda_ms(plain, iters), cuda_ms(kernel, iters)
    k2, p2 = cuda_ms(kernel, iters), cuda_ms(plain, iters)
  ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
  err, worst = max(r[0] for r in rows), max(r[3] for r in rows)
  detail = '; '.join(f'{i}: {r[1]:.2e} max, {r[2]:.2e} l2'
                     for i, r in enumerate(rows))
  log(f'phase {phase}: {which} {cdt} N={N_SAMPLES}: max_abs_err {err:.3e} '
      f'({worst:.3f} of its bound), kernel {ms:.3f} ms, plain '
      f'{plain_ms:.3f} ms; per output (relative to max|plain|, relative L2, '
      f'derivatives from output {n_values}): {detail}')
  if not worst <= 1.0:
    raise AssertionError(f'{which} {cdt}: an output is {worst:.3f} times '
                         'its bound')
  return err, ms, plain_ms


def check_kernels(fused_mlp, dev):
  """Phase 3: each kernel against its plain version, f32 and bf16."""
  gen = torch.Generator().manual_seed(SEED)
  results = {}
  for which in ('K1', 'K2'):
    segs, ws, bs, kw = trunk_case(which, gen, dev)
    for cdt in ('float32', 'bfloat16'):
      pack = fused_mlp.pack_trunk(ws, bs, [s.shape[-1] for s in segs],
                                  compute_dtype=cdt, **kw)
      kernel = lambda: fused_mlp.trunk_kernel(segs, pack)
      plain = lambda: fused_mlp.trunk_reference(segs, ws, bs,
                                                compute_dtype=cdt, **kw)
      results[which, cdt] = compare(which, cdt, kernel, plain, n_values=3)
  return results


def random_rays(rays_lib, n, config, seed, dev):
  """Rays as bench.py makes them: numpy, seeded, origins near the center."""
  rng = np.random.RandomState(seed)
  d = rng.randn(n, 3).astype(np.float32)
  o = rng.randn(n, 3).astype(np.float32) * 0.1
  return rays_from(rays_lib, o, d, np.full((n, 1), 0.001, np.float32),
                   config, dev)


def pinhole_rays(rays_lib, height, width, config, dev):
  """A pinhole camera at (0, 0, 4) looking down -z, 40 degree field of view."""
  focal = width / (2 * math.tan(math.radians(20)))
  j, i = np.meshgrid(np.arange(width, dtype=np.float32),
                     np.arange(height, dtype=np.float32))
  d = np.stack([(j + 0.5 - width / 2) / focal,
                -(i + 0.5 - height / 2) / focal,
                -np.ones_like(i)], axis=-1).reshape(-1, 3)
  o = np.tile(np.array([[0.0, 0.0, 4.0]], np.float32), (d.shape[0], 1))
  radii = np.full((d.shape[0], 1), 2 / math.sqrt(12) / focal, np.float32)
  rays = rays_from(rays_lib, o, d.astype(np.float32), radii, config, dev)
  return rays.reshape(height, width)


def rays_from(rays_lib, origins, directions, radii, config, dev):
  n = origins.shape[0]
  t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
  rays = rays_lib.dummy_rays(n, dev)
  rays.origins, rays.directions, rays.radii = t(origins), t(directions), t(radii)
  rays.viewdirs = rays.directions / rays.directions.norm(dim=-1, keepdim=True)
  rays.near = torch.full((n, 1), float(config.near), device=dev)
  rays.far = torch.full((n, 1), float(config.far), device=dev)
  return rays


def check_rendering(out, shape, config, pad):
  """Finite, of the expected shapes, within the ranges compositing allows."""
  expect = {'rgb': shape + (3,), 'diffuse': shape + (3,),
            'specular': shape + (3,), 'distance': shape + (1,), 'acc': shape}
  for k, s in expect.items():
    if tuple(out[k].shape) != s:
      raise AssertionError(f'{k}: shape {tuple(out[k].shape)} != {s}')
    if not torch.isfinite(out[k]).all():
      raise AssertionError(f'{k}: non-finite values')
  rgb, acc, dist = out['rgb'], out['acc'], out['distance']
  if not (rgb.min() >= -pad - 1e-6 and rgb.max() <= 1 + pad + 1e-6):
    raise AssertionError(f'rgb outside [-{pad}, 1+{pad}]')
  if not (acc.min() >= -1e-6 and acc.max() <= 1 + 1e-6):
    raise AssertionError('acc outside [0, 1]')
  if not (dist.min() >= 0 and dist.max() <= config.far + 1e-4):
    raise AssertionError('distance outside [0, far]')
  return (f'rgb [{rgb.min().item():.4f}, {rgb.max().item():.4f}], '
          f'acc [{acc.min().item():.4f}, {acc.max().item():.4f}]')


def serve(fused_mlp, dev):
  """Phase 4: the flagship model answers three requests through the kernels."""
  from refnerf_tpu_torch import configs
  from refnerf_tpu_torch.cameras import rays as rays_lib
  from refnerf_tpu_torch.models import construct
  from refnerf_tpu_torch.models import renderer

  gin_file = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'configs', 'blender_refnerf.gin')
  config, gin = configs.parse(
      [gin_file], [f'Config.seed = {SEED}',
                   "NerfMLP.compute_dtype = 'bfloat16'"])
  model = construct.construct_model(config, gin, dev)
  levels, chunk = model.cfg.num_levels, config.render_chunk_size
  pad = model.nerf_mlp.cfg.rgb_padding
  n_params = sum(p.numel() for p in model.parameters())
  log(f'phase 4: model {os.path.basename(gin_file)} bf16 trunks, '
      f'{n_params} parameters, {levels} levels x '
      f'{model.cfg.num_nerf_samples} samples, chunk {chunk}')

  requests = [
      ('4096 rays', lambda: random_rays(rays_lib, 4096, config, 1, dev)),
      ('5000 rays', lambda: random_rays(rays_lib, 5000, config, 2, dev)),
      ('64x64 image', lambda: pinhole_rays(rays_lib, 64, 64, config, dev)),
  ]
  # Warm-up (packs the weights once per model): not a request.
  renderer.render_rays(model, random_rays(rays_lib, 4096, config, 3, dev),
                       chunk)
  torch.cuda.synchronize()

  counts = fused_mlp.launches
  for k in counts:
    counts[k] = 0
  first = None
  for name, make in requests:
    rays = make()
    n = math.prod(rays.shape)
    before = [counts['K1'], counts['K2']]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if len(rays.shape) == 2:
      out = renderer.render_image(model, rays, chunk)
    else:
      out = renderer.render_rays(model, rays, chunk)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    ranges = check_rendering(out, tuple(rays.shape), config, pad)
    want = levels * -(-n // chunk)
    got = [counts[k] - b for k, b in zip(('K1', 'K2'), before)]
    if got != [want, want]:
      raise AssertionError(f'{name}: launches {got}, expected {want} each')
    log(f'phase 4: request {name}: {dt * 1e3:.1f} ms, {n / dt:.0f} rays/s, '
        f'{ranges}, launches K1 {got[0]} K2 {got[1]} (= {levels} levels x '
        f'{want // levels} chunks)')
    if first is None:
      first = (rays, out)
  launches = dict(counts)
  if any(launches[k] for k in ('K3', 'K4', 'K5')):
    raise AssertionError(f'serving launched a training kernel: {launches}')

  # The same request through the plain versions on the card.
  for mlp in (model.nerf_mlp, model.prop_mlp):
    if mlp is not None:
      mlp.cfg.fused_trunk = 'off'
  plain = renderer.render_rays(model, first[0], chunk)
  torch.cuda.synchronize()
  if counts != launches:
    raise AssertionError("fused_trunk='off' launched a kernel")
  diff = (plain['rgb'] - first[1]['rgb']).abs().max().item()
  acc_diff = (plain['acc'] - first[1]['acc']).abs().max().item()
  log(f"phase 4: request 4096 rays, kernels vs fused_trunk='off': max |rgb| "
      f'diff {diff:.3e}, max |acc| diff {acc_diff:.3e} (bound {PATH_BOUND})')
  if not (diff <= PATH_BOUND and acc_diff <= PATH_BOUND):
    raise AssertionError('kernel path disagrees with the plain path')
  return launches


def check_train_kernels(fused_mlp, dev):
  """Phase 5: K3, K4 and K5 against their plain versions, f32 and bf16."""
  gen = torch.Generator().manual_seed(SEED + 1)
  fold = torch.as_tensor(fused_mlp.ipe_scale_fold(SCALES, 3), device=dev)
  rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
  results = {}
  for which in ('K3', 'K4', 'K5'):
    spatial = which != 'K5'
    segs, ws, bs, kw = trunk_case('K1' if spatial else 'K2', gen, dev,
                                  ipe=spatial)
    # Cotangents of (sigma, the f32 heads, the bottleneck, u).
    cots = ((rand(N_SAMPLES), rand(N_SAMPLES, 10), rand(N_SAMPLES, 128),
             rand(N_SAMPLES, 3)) if spatial
            else (None, rand(N_SAMPLES, 3), None, None))
    for cdt in ('float32', 'bfloat16'):
      cs = [s.to(fused_mlp.DTYPES[cdt]) for s in segs]
      pack = fused_mlp.pack_trunk(ws, bs, [s.shape[-1] for s in cs],
                                  compute_dtype=cdt, **kw)
      if which == 'K3':
        kernel = lambda: fused_mlp.trunk_kernel(cs, pack, fold)

        def plain():
          out = fused_mlp.trunk_reference(cs, ws, bs, compute_dtype=cdt,
                                          density_grad=True, **kw)
          return out[:-2] + [fused_mlp.fold_density_grad(out[-2:], *cs,
                                                         fold)]
        # sigma, the two heads, then u.
        results[which, cdt] = compare(which, cdt, kernel, plain, n_values=3)
      else:
        f = fold if spatial else None
        kernel = lambda: fused_mlp.trunk_backward_kernel(
            cs, pack, cots, f, needs_dx=not spatial)
        plain = lambda: fused_mlp.trunk_backward_reference(
            cs, ws, bs, cots, compute_dtype=cdt, fold=f,
            needs_dx=not spatial, **kw)
        results[which, cdt] = compare(which, cdt, kernel, plain, n_values=0,
                                      iters=3)
      del pack
    del segs, ws, bs, kw, cots
    torch.cuda.empty_cache()
  return results


def train(fused_mlp, dev):
  """Phase 6: train steps of the flagship through the kernels."""
  from refnerf_tpu_torch import configs
  from refnerf_tpu_torch.cameras import rays as rays_lib
  from refnerf_tpu_torch.models import construct
  from refnerf_tpu_torch.train import step as step_lib

  gin_file = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'configs', 'blender_refnerf.gin')
  config, gin = configs.parse(
      [gin_file], [f'Config.seed = {SEED}',
                   f'Config.batch_size = {TRAIN_BATCH}',
                   'Config.randomized = False', 'Config.sample_noise_size = 0',
                   "NerfMLP.compute_dtype = 'bfloat16'"])
  model = construct.construct_model(config, gin, dev)
  levels = model.cfg.num_levels
  # Rays and pixels as bench.py makes them.
  rng = np.random.RandomState(0)
  d = rng.randn(TRAIN_BATCH, 3).astype(np.float32)
  rays = rays_from(rays_lib, rng.randn(TRAIN_BATCH, 3).astype(np.float32) * 0.1,
                   d, np.full((TRAIN_BATCH, 1), 0.001, np.float32), config, dev)
  rays.lossmult = torch.ones(TRAIN_BATCH, 1, device=dev)
  rgb = torch.from_numpy(
      rng.uniform(0, 1, (TRAIN_BATCH, 3)).astype(np.float32)).to(dev)
  batch = rays_lib.Batch(rays=rays, rgb=rgb)
  state = step_lib.create_train_state(config, model)
  train_step = step_lib.make_train_step(model, config)
  start = {k: p.detach().clone() for k, p in model.named_parameters()}
  log(f'phase 6: model {os.path.basename(gin_file)} bf16 trunks, batch '
      f'{TRAIN_BATCH}, {levels} levels x {model.cfg.num_nerf_samples} '
      'samples')

  def check(stats, step):
    for k, v in [('loss', stats['loss']), *stats['losses'].items()]:
      if not torch.isfinite(v).all():
        raise AssertionError(f'step {step}: loss term {k} is not finite')

  for i in range(TRAIN_WARMUP):
    state, stats = train_step(state, batch)
    check(stats, i)
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  for k in fused_mlp.launches:
    fused_mlp.launches[k] = 0
  t0 = time.perf_counter()
  all_stats = []
  for _ in range(TRAIN_STEPS):
    state, stats = train_step(state, batch)
    all_stats.append(stats)
  torch.cuda.synchronize()
  dt = (time.perf_counter() - t0) / TRAIN_STEPS
  launches = dict(fused_mlp.launches)
  for i, stats in enumerate(all_stats):
    check(stats, TRAIN_WARMUP + i)
  want = {'K1': 0, 'K2': levels * TRAIN_STEPS, 'K3': levels * TRAIN_STEPS,
          'K4': levels * TRAIN_STEPS, 'K5': levels * TRAIN_STEPS}
  if launches != want:
    raise AssertionError(f'train launches {launches}, expected {want}')
  moved = max((p.detach() - start[k]).abs().max().item()
              for k, p in model.named_parameters())
  if not moved > 0:
    raise AssertionError('the parameters did not change')
  last = all_stats[-1]
  terms = ', '.join(f'{k} {v.item():.6g}' for k, v in last['losses'].items())
  log(f'phase 6: {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up: '
      f'{dt * 1e3:.2f} ms/step, {TRAIN_BATCH / dt:.0f} train rays/s, peak '
      f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; step '
      f'{state.step}: loss {last["loss"].item():.6g} ({terms}), psnr '
      f'{last["psnr"].item():.3f}; launches {launches}; max param move '
      f'{moved:.3e}')

  # One step's gradients from the same state, kernels vs plain versions.
  loss_k, _, grads_k = train_step.loss_and_grads(state, batch)
  norm_k = step_lib.global_norm(grads_k.values()).item()
  del grads_k
  model.nerf_mlp.cfg.fused_trunk = 'off'
  before = dict(fused_mlp.launches)
  loss_p, _, grads_p = train_step.loss_and_grads(state, batch)
  norm_p = step_lib.global_norm(grads_p.values()).item()
  if fused_mlp.launches != before:
    raise AssertionError("fused_trunk='off' launched a kernel")
  dl = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
  dn = abs(norm_k - norm_p) / norm_p
  log(f"phase 6: step {state.step} kernels vs fused_trunk='off': loss "
      f'{loss_k.item():.6g} vs {loss_p.item():.6g} (rel {dl:.2e}, bound '
      f'{TRAIN_LOSS_BOUND}), grad norm {norm_k:.6g} vs {norm_p:.6g} (rel '
      f'{dn:.2e}, bound {TRAIN_GNORM_BOUND})')
  if not (dl <= TRAIN_LOSS_BOUND and dn <= TRAIN_GNORM_BOUND):
    raise AssertionError('the kernel train step disagrees with the plain one')
  return launches, dt


def main():
  if not torch.cuda.is_available():
    print('chip_smoke: no CUDA device (torch.cuda.is_available() is false)',
          file=sys.stderr)
    return 2
  dev = torch.device('cuda')
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  smi = subprocess.run(
      ['nvidia-smi', '--query-gpu=name,power.limit',
       '--format=csv,noheader'], capture_output=True, text=True, check=True,
      timeout=60).stdout.strip().splitlines()[0]
  log(f'phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, '
      f'{torch.cuda.get_device_name(0)}')
  log(smi)

  from refnerf_tpu_torch.ops import cuda_build
  from refnerf_tpu_torch.ops import fused_mlp
  t0 = time.perf_counter()
  libs = cuda_build.build()
  for name in libs:
    cuda_build.library(name)
  log(f'phase 2: built {", ".join(p.name for p in libs.values())} in '
      f'{time.perf_counter() - t0:.1f} s (one nvcc per source, in parallel)')
  for path in libs.values():
    for line in path.with_suffix('.log').read_text().splitlines():
      if 'registers' in line or 'spill' in line or 'Compiling' in line:
        log(f'phase 2: ptxas {line.strip()}')

  kernels = check_kernels(fused_mlp, dev)
  launches = serve(fused_mlp, dev)
  kernels.update(check_train_kernels(fused_mlp, dev))
  train_launches, step_s = train(fused_mlp, dev)

  fwd_src = 'refnerf_tpu_torch/csrc/trunk_fwd.cu'
  bwd_src = 'refnerf_tpu_torch/csrc/trunk_bwd.cu'
  pallas = 'refnerf_tpu/ops/pallas/fused_mlp.py'
  names = {
      'K1': ('spatial trunk (fused_encoded_trunk)', fwd_src, 612, launches),
      'K2': ('directional trunk (fused_trunk)', fwd_src, 612, launches),
      'K3': ('spatial trunk with the density gradient', fwd_src, 589,
             train_launches),
      'K4': ('spatial trunk backward', bwd_src, 668, train_launches),
      'K5': ('directional trunk backward with dx', bwd_src, 668,
             train_launches)}
  line = []
  for which, (desc, src, at, counts) in names.items():
    err, ms, plain_ms = kernels[which, 'bfloat16']
    err32, ms32, plain32 = kernels[which, 'float32']
    entry = {
        'name': f'{which} {desc}', 'route': 'cuda', 'source': src,
        'replaces': f'{pallas}:{at}', 'launches': counts[which],
        'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
        'dtype': 'bfloat16', 'n_samples': N_SAMPLES,
        'f32_max_abs_err': err32, 'f32_ms': ms32, 'f32_plain_ms': plain32}
    if which == 'K2':
      entry['train_launches'] = train_launches['K2']
    line.append(entry)
  log(f'phase 6: train step {step_s * 1e3:.2f} ms, '
      f'{TRAIN_BATCH / step_s:.0f} train rays/s')
  print(json.dumps({'kernels': line}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
