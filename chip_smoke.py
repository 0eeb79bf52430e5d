#!/usr/bin/env python3
"""Serve the flagship Ref-NeRF model once through the PyTorch port on one GPU.

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
     answer the first request again with fused_trunk='off' and compare.
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
# Kernel vs plain version: max |kernel - plain| <= bound * max(1, max|plain|).
# f32: the same f32 arithmetic summed in another order. bf16: both round
# every layer's f32 sum to bf16, and a sum on a rounding boundary flips one
# bf16 ulp (2^-8 relative) that later layers carry along.
KERNEL_BOUND = {'float32': 1e-4, 'bfloat16': 5e-2}
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


def trunk_case(which, gen, dev):
  """Flagship-width trunk weights (He-scaled so activations stay O(1)) and
  segments of N_SAMPLES rows: K1 segments (48, 48), heads 10 f32 + 128
  bottleneck; K2 segments (128, 73), head 3 (rgb)."""
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
  segs = [torch.rand(N_SAMPLES, d, generator=gen).to(dev) * 2 - 1
          for d in seg_dims]
  return segs, ws, bs, kw


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
      with torch.no_grad():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got, want))
        scale = max(1.0, max(b.float().abs().max().item() for b in want))
        bound = KERNEL_BOUND[cdt] * scale
        p1, k1 = cuda_ms(plain), cuda_ms(kernel)
        k2, p2 = cuda_ms(kernel), cuda_ms(plain)
      ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
      log(f'phase 3: {which} {cdt} N={N_SAMPLES}: max_abs_err {err:.3e} '
          f'(bound {bound:.3e}), kernel {ms:.3f} ms, plain {plain_ms:.3f} ms')
      if not all(a.dtype == b.dtype and a.shape == b.shape
                 for a, b in zip(got, want)):
        raise AssertionError(f'{which} {cdt}: outputs differ in dtype/shape')
      if not err <= bound:
        raise AssertionError(f'{which} {cdt}: max_abs_err {err} > {bound}')
      results[which, cdt] = (err, ms, plain_ms)
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

  counters = (fused_mlp.fused_encoded_trunk, fused_mlp.fused_trunk)
  for c in counters:
    c.launches = 0
  first = None
  for name, make in requests:
    rays = make()
    n = math.prod(rays.shape)
    before = [c.launches for c in counters]
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
    got = [c.launches - b for c, b in zip(counters, before)]
    if got != [want, want]:
      raise AssertionError(f'{name}: launches {got}, expected {want} each')
    log(f'phase 4: request {name}: {dt * 1e3:.1f} ms, {n / dt:.0f} rays/s, '
        f'{ranges}, launches K1 {got[0]} K2 {got[1]} (= {levels} levels x '
        f'{want // levels} chunks)')
    if first is None:
      first = (rays, out)
  launches = {'K1': counters[0].launches, 'K2': counters[1].launches}

  # The same request through the plain versions on the card.
  for mlp in (model.nerf_mlp, model.prop_mlp):
    if mlp is not None:
      mlp.cfg.fused_trunk = 'off'
  plain = renderer.render_rays(model, first[0], chunk)
  torch.cuda.synchronize()
  if [c.launches for c in counters] != [launches['K1'], launches['K2']]:
    raise AssertionError("fused_trunk='off' launched a kernel")
  diff = (plain['rgb'] - first[1]['rgb']).abs().max().item()
  acc_diff = (plain['acc'] - first[1]['acc']).abs().max().item()
  log(f"phase 4: request 4096 rays, kernels vs fused_trunk='off': max |rgb| "
      f'diff {diff:.3e}, max |acc| diff {acc_diff:.3e} (bound {PATH_BOUND})')
  if not (diff <= PATH_BOUND and acc_diff <= PATH_BOUND):
    raise AssertionError('kernel path disagrees with the plain path')
  return launches


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
  lib_path = cuda_build.build()
  cuda_build.library()
  log(f'phase 2: built {lib_path.name} in {time.perf_counter() - t0:.1f} s')
  for line in lib_path.with_suffix('.log').read_text().splitlines():
    if 'registers' in line or 'spill' in line:
      log(f'phase 2: ptxas {line.strip()}')

  kernels = check_kernels(fused_mlp, dev)
  launches = serve(fused_mlp, dev)

  names = {'K1': 'spatial trunk (fused_encoded_trunk)',
           'K2': 'directional trunk (fused_trunk)'}
  line = []
  for which, desc in names.items():
    err, ms, plain_ms = kernels[which, 'bfloat16']
    err32, ms32, plain32 = kernels[which, 'float32']
    line.append({
        'name': f'{which} {desc}', 'route': 'cuda',
        'source': 'refnerf_tpu_torch/csrc/trunk_fwd.cu',
        'replaces': 'refnerf_tpu/ops/pallas/fused_mlp.py:612',
        'launches': launches[which], 'max_abs_err': err, 'ms': ms,
        'plain_ms': plain_ms, 'dtype': 'bfloat16', 'n_samples': N_SAMPLES,
        'f32_max_abs_err': err32, 'f32_ms': ms32, 'f32_plain_ms': plain32})
  print(json.dumps({'kernels': line}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
