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
     state and compare the loss and the global gradient norm;
  7. hold the fused directional stages against their plain versions at the
     same N, in float32 and bfloat16, forward and backward, and time both:
     K8 (the IDE in the directional trunk), K8+K9 (with the direction
     geometry), K10 (the colour epilogue) and all three;
  8. the flagship with NerfMLP.fuse_dir_enc, fuse_dir_geo and fuse_dir_rgb:
     three served requests and 10 train steps through the kernels (K8-K10
     each counted levels times per request, twice that per step), each
     against fused_trunk='off'; a 4096-ray request and a train step timed in
     turns against the same model unfused (phases 4 and 6), and one of each
     under torch.profiler (device busy share, device time by kernel);
  9. hold the fused spatial stages against their plain versions at the
     same N, in float32 and bfloat16, and time both: K7 (the IPE made in
     the kernel) on K1 and on K3, K6 (the compositing weights) on K3, and
     K6+K7 on K1 (the served launch), on K3 and on K4 (the backward, with
     d bsig); the weights within an absolute bound that two faults of the
     scan (inclusive, no density bias) would exceed;
 10. the flagship with all six fuse flags (phase 8's and
     NerfMLP.fuse_ipe_trig, fuse_compositing, fuse_lift): three served
     requests and 10 train steps through the kernels (K6 and K7 each
     counted levels x chunks per request, twice that per step), each
     against fused_trunk='off'; a 4096-ray request and a train step timed
     in turns against phase 8's model, and one of each profiled (phase 8
     profiles phase 8's model);
 11. hold mip-NeRF's kernels against their plain versions at the same N, in
     float32 and bfloat16, and time both: K11 (the spatial trunk with its
     features y out) forward and backward (the cotangent of y in), K2 and
     K5 at width 128 on segments (128, 33), K1 with the bottleneck head
     alone (hf = 0) and the first-order K4 (no cotangent of u); K11's y
     within a relative L2 bound that two faults of its store (the last
     bias dropped, y before the last ReLU) would exceed;
 12. configs/blender_mipnerf.gin at full width (bf16 trunks), as shipped and
     with Model.use_viewdirs = False: each answers three requests and takes
     10 train steps through the kernels (K1, K2 and K4, K5 at width 128; or
     K1 with K11 and K4 with K11), each against fused_trunk='off', and one
     request and one step of each profiled.
The line before the last is a JSON list of the kernels, each with its
launches on the main path (phases 4, 6, 8, 10 and 12), its time and its
plain version's at N, and its bound: the larger of the bytes it must move (each
input read once, each output written once) at 3.35 TB/s and its operations
at the card's peak for their type (989 TFLOP/s bf16 tensor, 67 TFLOP/s f32;
the fused stages' f32 work overlaps bf16 tensor work).
The last line is {"ok": true, "device": {...}}. Any failure raises: the exit
code is not 0 and no result line is printed.
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
# K6's compositing weights (f32 in either dtype, each below 1 and a ray's
# summing to at most 1): max |kernel - plain|, absolute. They move with the
# raw density, so by 1e-7 in f32 and, where a bf16 flip moves it, by a few
# 1e-4 in bf16. Phase 9 also reads two faults on the plain weights (an
# inclusive scan, a dropped density bias) and fails unless both lie above
# this bound.
WEIGHT_BOUND = {'float32': 1e-5, 'bfloat16': 5e-3}
# K11's trunk features y [N, 256] in the compute dtype: relative L2 error,
# as the derivatives. A rounding flip moves one of 134M values by a bf16
# ulp; a fault of the store moves all of them. Phase 11 also reads two
# faults on the plain y (the last bias dropped, y before the last ReLU) and
# fails unless both lie above this bound.
Y_BOUND = {'float32': 1e-5, 'bfloat16': 1e-2}
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
# The flags of the fused directional stage (K8-K10), phase 8, and of the
# fused spatial stage (K6, K7 and the closed-form lift), phase 10.
FUSE = ['NerfMLP.fuse_dir_enc = True', 'NerfMLP.fuse_dir_geo = True',
        'NerfMLP.fuse_dir_rgb = True']
SPATIAL = ['NerfMLP.fuse_ipe_trig = True', 'NerfMLP.fuse_compositing = True',
           'NerfMLP.fuse_lift = True']
SAMPLES = 128  # a ray's samples at every level of the flagship
# Peak rates of one H100 SXM (dense) and its memory rate, for the bounds.
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}
MEM_RATE = 3.35e12


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


# The trunks of the kernel cases, 8 layers with the skip at layer 5:
# (segment widths, width, f32 head outputs, compute-dtype head outputs,
# density head). 'K1' and 'K2' are the flagship's spatial and directional
# trunks; 'mip K1' is mip-NeRF's spatial trunk with its bottleneck and no
# f32 head (hf = 0), 'mip K11' the same without the bottleneck (y out), and
# 'mip K2' its directional trunk on [bottleneck 128 | positional encoding
# 33].
TRUNKS = {'K1': ((48, 48), 256, 10, 128, True),
          'K2': ((128, 73), 256, 3, 0, False),
          'mip K1': ((48, 48), 256, 0, 128, True),
          'mip K11': ((48, 48), 256, 0, 0, True),
          'mip K2': ((128, 33), 128, 3, 0, False)}


def trunk_case(which, gen, dev, ipe=False):
  """TRUNKS[which]'s weights (He-scaled so activations stay O(1)) and
  segments of N_SAMPLES rows in [-1, 1]. With `ipe` the (48, 48) segments
  are the IPE encoding of random lifted means and variances; a 33-wide
  segment is the positional encoding (deg_view 5) of random unit
  directions."""
  seg_dims, width, hf, hc, density = TRUNKS[which]
  fin = sum(seg_dims)
  rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
  ws, bs = [], []
  for l in range(8):
    k_in = fin if l == 0 else width + (fin if l == 5 else 0)
    ws.append(rand(width, k_in) * math.sqrt(2 / k_in))
    bs.append(rand(width) * 0.05)
  head = lambda k: (rand(k, width) / math.sqrt(width), rand(k) * 0.1)
  kw = dict(skip_period=4,
            wd=rand(1, width) / math.sqrt(width) if density else None,
            head_f32=head(hf) if hf else None,
            head_cdt=head(hc) if hc else None)
  uniform = lambda d: torch.rand(N_SAMPLES, d, generator=gen).to(dev) * 2 - 1
  if ipe:
    from refnerf_tpu_torch.ops import fused_mlp
    lm = torch.rand(N_SAMPLES, 3, generator=gen).to(dev) * 3 - 1.5
    lv = 10.0**(torch.rand(N_SAMPLES, 3, generator=gen).to(dev) * 4 - 6)
    segs = list(fused_mlp.encode_ipe(lm, lv, SCALES))
  elif seg_dims[-1] == 33:
    from refnerf_tpu_torch.ops import coord
    d = rand(N_SAMPLES, 3)
    segs = [uniform(seg_dims[0]),
            coord.pos_enc(d / d.norm(dim=-1, keepdim=True), 0, 5)]
  else:
    segs = [uniform(d) for d in seg_dims]
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


def errors(got, want, cdt, n_values, weights=None, y=None):
  """Per output: (max abs err, that relative to max(1, max|plain|), relative
  L2 err, share of its bound). The first n_values outputs are values, held
  by KERNEL_BOUND on the max error; the output at index `weights` is K6's
  weights, held by WEIGHT_BOUND on the max abs error; the one at index `y`
  is K11's y, held by Y_BOUND on the L2 error; the rest are derivatives,
  held by GRAD_BOUND on the L2 error."""
  if len(got) != len(want) or not all(
      a.dtype == b.dtype and a.shape == b.shape for a, b in zip(got, want)):
    raise AssertionError('outputs differ in number, dtype or shape')
  rows = []
  for i, (a, b) in enumerate(zip(got, want)):
    d, b = a.float() - b.float(), b.float()
    e = d.abs().max().item()
    rel = e / max(1.0, b.abs().max().item())
    l2 = d.norm().item() / max(b.norm().item(), 1e-30)
    share = (e / WEIGHT_BOUND[cdt] if i == weights
             else l2 / Y_BOUND[cdt] if i == y
             else rel / KERNEL_BOUND[cdt] if i < n_values
             else l2 / GRAD_BOUND[cdt])
    rows.append((e, rel, l2, share))
  return rows


def nbytes(tensors):
  """Bytes of the tensors (Nones and duplicates skipped), each counted once."""
  seen, total = set(), 0
  for t in flatten(tensors):
    if t.data_ptr() not in seen:
      seen.add(t.data_ptr())
      total += t.numel() * t.element_size()
  return total


def trunk_flops(ws, n, heads, density_grad=False, backward=False,
                needs_dx=False):
  """Operations (2 a multiply-add) of the trunk function over n rows, as it
  needs them: counted product by product, not as the 1, 2, 4 or 6 forward
  passes of `_make_op`'s estimate (fused_mlp.py:925, :1052). T: the
  trunk's weights; X: those that read the input segments (layer 0 and the
  skip layer's input columns); H: width x the heads' outputs.
  - forward: the trunk and heads, T + H; with the density gradient u also
    the reverse from the density head through every layer, T + width.
  - backward: the trunk's recompute, T (a head is linear: its output is
    not needed); the reverse zeta_l W_l from the heads through every layer,
    T + H, less X without dx (those columns give only dx); the weight
    gradients zeta_l^T [h | x], T + H. With u's cotangent (second order)
    also the reverse g of the forward's u, T - X (u itself is not needed),
    the tangent pushed forward from the input, T, and the second
    weight-gradient product delta_l^T t, T."""
  width = ws[0].shape[0]
  t = sum(w.numel() for w in ws)
  x = sum(w.shape[0] * (w.shape[1] - (width if l else 0))
          for l, w in enumerate(ws))
  h = width * heads
  if not backward:
    per = t + h + (t + width if density_grad else 0)
  else:
    per = 3 * t + 2 * h - (0 if needs_dx else x)
    if density_grad:
      per += 3 * t - x
  return 2 * n * per


def bound(cdt, flops, nbytes_moved, f32_flops=0):
  """(ms, 'bytes' or 'operations'): the least time the card could take.
  `flops` run in the compute dtype (bf16 on the tensor cores, f32 on the FMA
  pipes), `f32_flops` on the FMA pipes: in f32 the two share the pipes and
  add up; in bf16 they run on separate units that can overlap, so the
  longer of the two counts."""
  if cdt == 'float32':
    t_ops = (flops + f32_flops) / PEAK_FLOPS['float32']
  else:
    t_ops = max(flops / PEAK_FLOPS[cdt], f32_flops / PEAK_FLOPS['float32'])
  t_bytes = nbytes_moved / MEM_RATE
  return max(t_ops, t_bytes) * 1e3, 'operations' if t_ops >= t_bytes else 'bytes'


def compare(which, cdt, kernel, plain, n_values, iters=5, phase=3, inputs=(),
            flops=0, f32_flops=0, weights=None, y=None):
  """Run kernel() and plain() once and compare every output (see errors());
  then time both in turns. Returns a dict: max_abs_err, ms, plain_ms, and
  the bound from `flops` (in the compute dtype), `f32_flops` and the bytes
  of `inputs` and of the kernel's outputs."""
  with torch.no_grad():
    got, want = flatten(kernel()), flatten(plain())
    torch.cuda.synchronize()
    rows = errors(got, want, cdt, n_values, weights, y)
    moved = nbytes(list(inputs) + got)
    del got, want
    p1, k1 = cuda_ms(plain, iters), cuda_ms(kernel, iters)
    k2, p2 = cuda_ms(kernel, iters), cuda_ms(plain, iters)
  ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
  err, worst = max(r[0] for r in rows), max(r[3] for r in rows)
  bound_ms, bound_by = bound(cdt, flops, moved, f32_flops)
  detail = '; '.join(f'{i}: {r[1]:.2e} max, {r[2]:.2e} l2'
                     for i, r in enumerate(rows))
  kinds = f'derivatives from output {n_values}' + (
      f' but for the weights {weights}, absolute' if weights is not None
      else '') + (f', y {y} by L2' if y is not None else '')
  log(f'phase {phase}: {which} {cdt} N={N_SAMPLES}: max_abs_err {err:.3e} '
      f'({worst:.3f} of its bound), kernel {ms:.3f} ms, plain '
      f'{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}; '
      f'{moved / 1e6:.1f} MB); per output (relative to max|plain|, relative '
      f'L2, {kinds}): {detail}')
  if not worst <= 1.0:
    raise AssertionError(f'{which} {cdt}: an output is {worst:.3f} times '
                         'its bound')
  return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
              bound_by=bound_by)


def pack_tensors(pack):
  return [pack.w, pack.b, pack.wd, pack.wh, pack.bh, pack.wc, pack.bc]


def n_heads(kw):
  """Outputs of the heads on y: density, the f32 block, the cdt block."""
  return (sum(h[0].shape[0] for h in (kw.get('head_f32'), kw.get('head_cdt'))
              if h is not None) + int(kw.get('wd') is not None))


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
      results[which, cdt] = compare(
          which, cdt, kernel, plain, n_values=3,
          inputs=segs + pack_tensors(pack),
          flops=trunk_flops(ws, N_SAMPLES, n_heads(kw)))
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


FLAGSHIP, MIPNERF = 'blender_refnerf.gin', 'blender_mipnerf.gin'


def flagship(dev, bindings=(), gin_name=FLAGSHIP):
  """The model of configs/<gin_name> (the flagship by default) with bf16
  trunks and weights from Config.seed, and its Config."""
  from refnerf_tpu_torch import configs
  from refnerf_tpu_torch.models import construct
  gin_file = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          'configs', gin_name)
  config, gin = configs.parse(
      [gin_file], [f'Config.seed = {SEED}',
                   "NerfMLP.compute_dtype = 'bfloat16'", *bindings])
  return construct.construct_model(config, gin, dev), config


def set_mode(model, **fields):
  """Set MLPConfig fields (fused_trunk, fuse_dir_*) on every MLP."""
  for mlp in (model.nerf_mlp, model.prop_mlp):
    if mlp is not None:
      for k, v in fields.items():
        setattr(mlp.cfg, k, v)


def serve(fused_mlp, dev, bindings=(), phase=4, kernels=('K1', 'K2'),
          gin_name=FLAGSHIP, timings=None):
  """Phase 4 (8 with the fused directional stage, 12 with mip-NeRF): the
  model of `gin_name` answers three requests through the kernels; each
  kernel in `kernels` must run levels x chunks times a request, and no
  training kernel. Then the first request again with fused_trunk='off'.
  Returns the launches; `timings`, a dict, gets each request's ms."""
  from refnerf_tpu_torch.cameras import rays as rays_lib
  from refnerf_tpu_torch.models import renderer

  model, config = flagship(dev, bindings, gin_name)
  levels, chunk = model.cfg.num_levels, config.render_chunk_size
  pad = model.nerf_mlp.cfg.rgb_padding
  n_params = sum(p.numel() for p in model.parameters())
  log(f'phase {phase}: model {gin_name} {" ".join(bindings)} bf16 '
      f'trunks, {n_params} parameters, {levels} levels x '
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
    before = [counts[k] for k in kernels]
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
    got = [counts[k] - b for k, b in zip(kernels, before)]
    if got != [want] * len(kernels):
      raise AssertionError(f'{name}: launches {got} of {kernels}, expected '
                           f'{want} each')
    log(f'phase {phase}: request {name}: {dt * 1e3:.1f} ms, {n / dt:.0f} '
        f'rays/s, {ranges}, launches {dict(zip(kernels, got))} (= {levels} '
        f'levels x {want // levels} chunks each)')
    if timings is not None:
      timings[name] = dt * 1e3
    if first is None:
      first = (rays, out)
  launches = dict(counts)
  if any(launches[k] for k in ('K3', 'K4', 'K5')):
    raise AssertionError(f'serving launched a training kernel: {launches}')

  # The same request through the plain versions on the card.
  set_mode(model, fused_trunk='off')
  plain = renderer.render_rays(model, first[0], chunk)
  torch.cuda.synchronize()
  if counts != launches:
    raise AssertionError("fused_trunk='off' launched a kernel")
  diff = (plain['rgb'] - first[1]['rgb']).abs().max().item()
  acc_diff = (plain['acc'] - first[1]['acc']).abs().max().item()
  log(f"phase {phase}: request 4096 rays, kernels vs fused_trunk='off': max "
      f'|rgb| diff {diff:.3e}, max |acc| diff {acc_diff:.3e} (bound '
      f'{PATH_BOUND})')
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
        results[which, cdt] = compare(
            which, cdt, kernel, plain, n_values=3, phase=5,
            inputs=cs + pack_tensors(pack) + [fold],
            flops=trunk_flops(ws, N_SAMPLES, n_heads(kw),
                              density_grad=True))
      else:
        f = fold if spatial else None
        kernel = lambda: fused_mlp.trunk_backward_kernel(
            cs, pack, cots, f, needs_dx=not spatial)
        plain = lambda: fused_mlp.trunk_backward_reference(
            cs, ws, bs, cots, compute_dtype=cdt, fold=f,
            needs_dx=not spatial, **kw)
        results[which, cdt] = compare(
            which, cdt, kernel, plain, n_values=0, iters=3, phase=5,
            inputs=cs + pack_tensors(pack) + list(cots) + [f],
            flops=trunk_flops(ws, N_SAMPLES, n_heads(kw),
                              density_grad=spatial, backward=True,
                              needs_dx=not spatial))
      del pack
    del segs, ws, bs, kw, cots
    torch.cuda.empty_cache()
  return results


def train_setup(dev, bindings=(), gin_name=FLAGSHIP):
  """The model of `gin_name` at batch TRAIN_BATCH as bench.py trains it:
  model, its Config, train state, step and a batch of rays and pixels made
  as bench.py makes them."""
  from refnerf_tpu_torch.cameras import rays as rays_lib
  from refnerf_tpu_torch.train import step as step_lib
  model, config = flagship(dev, [
      f'Config.batch_size = {TRAIN_BATCH}', 'Config.randomized = False',
      'Config.sample_noise_size = 0', *bindings], gin_name)
  rng = np.random.RandomState(0)
  d = rng.randn(TRAIN_BATCH, 3).astype(np.float32)
  rays = rays_from(rays_lib, rng.randn(TRAIN_BATCH, 3).astype(np.float32) * 0.1,
                   d, np.full((TRAIN_BATCH, 1), 0.001, np.float32), config, dev)
  rays.lossmult = torch.ones(TRAIN_BATCH, 1, device=dev)
  rgb = torch.from_numpy(
      rng.uniform(0, 1, (TRAIN_BATCH, 3)).astype(np.float32)).to(dev)
  batch = rays_lib.Batch(rays=rays, rgb=rgb)
  state = step_lib.create_train_state(config, model)
  return model, config, state, step_lib.make_train_step(model, config), batch


def train(fused_mlp, dev, bindings=(), phase=6, per_step=None,
          gin_name=FLAGSHIP):
  """Phase 6 (8 with the fused directional stage, 12 with mip-NeRF): train
  steps of the model of `gin_name` through the kernels; `per_step` are the
  launches each kernel must make a level and step. Then one step's
  gradients against fused_trunk='off'. Returns (launches, seconds per step,
  train_setup's five)."""
  from refnerf_tpu_torch.train import step as step_lib
  model, config, state, train_step, batch = train_setup(dev, bindings,
                                                        gin_name)
  levels = model.cfg.num_levels
  start = {k: p.detach().clone() for k, p in model.named_parameters()}
  log(f'phase {phase}: model {gin_name} {" ".join(bindings)} bf16 '
      f'trunks, batch {TRAIN_BATCH}, {levels} levels x '
      f'{model.cfg.num_nerf_samples} samples')

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
  per_step = per_step or {'K2': 1, 'K3': 1, 'K4': 1, 'K5': 1}
  want = {k: levels * TRAIN_STEPS * per_step.get(k, 0) for k in launches}
  if launches != want:
    raise AssertionError(f'train launches {launches}, expected {want}')
  moved = max((p.detach() - start[k]).abs().max().item()
              for k, p in model.named_parameters())
  if not moved > 0:
    raise AssertionError('the parameters did not change')
  last = all_stats[-1]
  terms = ', '.join(f'{k} {v.item():.6g}' for k, v in last['losses'].items())
  log(f'phase {phase}: {TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up: '
      f'{dt * 1e3:.2f} ms/step, {TRAIN_BATCH / dt:.0f} train rays/s, peak '
      f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; step '
      f'{state.step}: loss {last["loss"].item():.6g} ({terms}), psnr '
      f'{last["psnr"].item():.3f}; launches {launches}; max param move '
      f'{moved:.3e}')

  # One step's gradients from the same state, kernels vs plain versions.
  loss_k, _, grads_k = train_step.loss_and_grads(state, batch)
  norm_k = step_lib.global_norm(grads_k.values()).item()
  del grads_k
  set_mode(model, fused_trunk='off')
  before = dict(fused_mlp.launches)
  loss_p, _, grads_p = train_step.loss_and_grads(state, batch)
  norm_p = step_lib.global_norm(grads_p.values()).item()
  del grads_p
  set_mode(model, fused_trunk='auto')
  if fused_mlp.launches != before:
    raise AssertionError("fused_trunk='off' launched a kernel")
  dl = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
  dn = abs(norm_k - norm_p) / norm_p
  log(f"phase {phase}: step {state.step} kernels vs fused_trunk='off': loss "
      f'{loss_k.item():.6g} vs {loss_p.item():.6g} (rel {dl:.2e}, bound '
      f'{TRAIN_LOSS_BOUND}), grad norm {norm_k:.6g} vs {norm_p:.6g} (rel '
      f'{dn:.2e}, bound {TRAIN_GNORM_BOUND})')
  if not (dl <= TRAIN_LOSS_BOUND and dn <= TRAIN_GNORM_BOUND):
    raise AssertionError('the kernel train step disagrees with the plain one')
  return launches, dt, (model, config, state, train_step, batch)


# Phase 7: (name, (IDE, geometry, colour epilogue)) of each fused mode; K9
# runs with K8, as it does in the model.
DIR_CASES = (('K8', (True, False, False)), ('K9', (True, True, False)),
             ('K10', (False, False, True)), ('K8+K9+K10', (True, True, True)))


def dir_flops(mat, ide, geo, rgb, backward):
  """f32 operations of the fused directional stages over N_SAMPLES, as the
  function needs them (not as the kernel happens to compute them; a
  transcendental counts as one). A sample's IDE forward: the powers z^k and
  (x + iy)^m up to l_max (1 and 6 a step), a multiply-add for each non-zero
  of `mat` (the z-polynomials; taking power m_i through `gather` is a pick,
  no arithmetic), and kappa_inv sigma, its exp and three products a
  harmonic. Its backward: the forward again (the trunk's recompute needs
  the encoding), a multiply-add for each non-zero of mat's rows k >= 1 (the
  derivative polynomials) and 19 a harmonic for the closed form. The
  geometry: 27 forward, 27 + 46 backward. The colour epilogue: 74 forward,
  150 backward."""
  lmax, p = mat.shape[0] - 1, mat.shape[1]
  n = 0
  if ide:
    n += 7 * (lmax - 1) + 2 * np.count_nonzero(mat) + 5 * p
    if backward:
      n += 2 * np.count_nonzero(mat[1:]) + 19 * p
  if geo:
    n += 27 + (46 if backward else 0)
  if rgb:
    n += 150 if backward else 74
  return int(n) * N_SAMPLES


def dir_case(fused_mlp, gen, dev, ide, geo, rgb):
  """The flagship directional trunk (trunk_case 'K2') on the raw inputs of a
  mode, N_SAMPLES rows: bottleneck 128 | refdirs, kappa_inv, n.v (K8), or
  grad_pred, viewdirs, kappa_inv (K8+K9), or the 73-wide encoding (K10
  alone); kappa_inv in [0.05, 0.5], as the model's roughness (below 0.05
  the f32 IDE at deg_view 5 depends on the summation order, ROADMAP H9)."""
  segs, ws, bs, kw = trunk_case('K2', gen, dev)
  n = N_SAMPLES
  rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
  unit = lambda v: v / v.norm(dim=-1, keepdim=True)
  ki = 0.05 + 0.45 * torch.rand(n, 1, generator=gen).to(dev)
  if ide and geo:
    segs = [segs[0], rand(n, 3), unit(rand(n, 3)), ki]
  elif ide:
    segs = [segs[0], unit(rand(n, 3)), ki, segs[1][:, :1].contiguous()]
  dm = fused_mlp.DirModes(5 if ide else 0, 1, geo,
                          (1.0, 0.0, 0.001) if rgb else None)
  rgbx = (rand(n, 3), rand(n, 3)) if rgb else None
  return segs, ws, bs, kw['head_f32'], dm, rgbx


def check_dir_kernels(fused_mlp, dev):
  """Phase 7: K8, K8+K9, K10 and all three against their plain versions,
  forward and backward, f32 and bf16."""
  gen = torch.Generator().manual_seed(SEED + 2)
  results = {}
  for which, (ide, geo, rgb) in DIR_CASES:
    segs, ws, bs, head, dm, rgbx = dir_case(fused_mlp, gen, dev, ide, geo,
                                            rgb)
    raw = range(1, 1 + dm.n_raw())
    rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
    cots = (None, rand(N_SAMPLES, 3), None, None)
    rgb_bar = rand(N_SAMPLES, 3) if rgb else None
    mat = fused_mlp.ref_utils.ide_tables(5)[0]
    kw = dict(dir_modes=dm, rgbx=rgbx)
    for cdt in ('float32', 'bfloat16'):
      cs = [s if j in raw else s.to(fused_mlp.DTYPES[cdt])
            for j, s in enumerate(segs)]
      pack = fused_mlp.pack_trunk(ws, bs, fused_mlp.visible_dims(cs, dm),
                                  head_f32=head, compute_dtype=cdt)
      inputs = cs + pack_tensors(pack) + list(rgbx or [])
      results[which, cdt] = compare(
          which, cdt, lambda: fused_mlp.trunk_kernel(cs, pack, **kw),
          lambda: fused_mlp.trunk_reference(cs, ws, bs, head_f32=head,
                                            compute_dtype=cdt, **kw),
          n_values=2 if rgb else 1, phase=7, inputs=inputs,
          flops=trunk_flops(ws, N_SAMPLES, 3),
          f32_flops=dir_flops(mat, ide, geo, rgb, backward=False))
      results[which + ' backward', cdt] = compare(
          which + ' backward', cdt,
          lambda: fused_mlp.trunk_backward_kernel(
              cs, pack, cots, needs_dx=True, rgb_bar=rgb_bar, **kw),
          lambda: fused_mlp.trunk_backward_reference(
              cs, ws, bs, cots, head_f32=head, compute_dtype=cdt,
              needs_dx=True, rgb_bar=rgb_bar, **kw),
          n_values=0, iters=3, phase=7,
          inputs=inputs + [cots[1], rgb_bar],
          flops=trunk_flops(ws, N_SAMPLES, 3, backward=True,
                            needs_dx=True),
          f32_flops=dir_flops(mat, ide, geo, rgb, backward=True))
      del pack
    del segs, ws, bs, cots, rgbx
    torch.cuda.empty_cache()
  return results


FUSE_FLAGS = ('fuse_dir_enc', 'fuse_dir_geo', 'fuse_dir_rgb')


def in_turns(run, arms, blocks=2, reps=5):
  """Seconds of run() per call under each arm (a dict of MLPConfig fields),
  timed in turns a, b, b, a, ... over `blocks` pairs of `reps` calls each.
  Returns {arm: [seconds, ...]}."""
  names = list(arms)
  order = []
  for i in range(blocks):
    order += names if i % 2 == 0 else names[::-1]
  times = {a: [] for a in names}
  for a in order:
    set_mode(arms[a][0], **arms[a][1])
    run()  # the first call after a switch packs the weights: not timed
    for _ in range(reps):
      torch.cuda.synchronize()
      t0 = time.perf_counter()
      run()
      torch.cuda.synchronize()
      times[a].append(time.perf_counter() - t0)
  return times


def profile(run, what, calls, phase=8):
  """One torch.profiler window over `calls` calls of run(): wall, device
  busy and idle share, kernels launched, device time by kernel name."""
  from torch.profiler import ProfilerActivity
  from torch.profiler import profile as torch_profile
  run()
  torch.cuda.synchronize()
  with torch_profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for _ in range(calls):
      run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
  kernels = [e for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
  dev_us = lambda e: getattr(e, 'self_device_time_total',
                             getattr(e, 'self_cuda_time_total', 0))
  busy = sum(dev_us(e) for e in kernels) / 1e6
  if busy <= 0:
    log(f'phase {phase}: profile {what}: the profiler saw no device time')
    return
  top = sorted(kernels, key=dev_us, reverse=True)[:8]
  # The trunk kernels' names with their template arguments (the instance).
  name = lambda e: e.key.replace('void ', '').replace(
      '(anonymous namespace)::', '')[:64]
  log(f'phase {phase}: profile {what} ({calls} calls): wall {wall * 1e3:.2f} ms, '
      f'device busy {busy * 1e3:.2f} ms, idle {100 * (1 - busy / wall):.1f}%, '
      f'{sum(e.count for e in kernels) / calls:.0f} kernel launches a call; '
      'device ms a call by kernel: ' + '; '.join(
          f'{name(e)} {dev_us(e) / 1e3 / calls:.3f}' for e in top))


def fused_stage(fused_mlp, dev):
  """Phase 8: the flagship with the fused directional stage, served and
  trained through the kernels, against fused_trunk='off' and timed in
  turns against the same model unfused."""
  from refnerf_tpu_torch.models import renderer
  from refnerf_tpu_torch.cameras import rays as rays_lib
  serve_launches = serve(fused_mlp, dev, FUSE, phase=8,
                         kernels=('K1', 'K2', 'K8', 'K9', 'K10'))
  per_step = {'K2': 1, 'K3': 1, 'K4': 1, 'K5': 1, 'K8': 2, 'K9': 2,
              'K10': 2}
  train_launches, step_s, (model, config, state, train_step, batch) = train(
      fused_mlp, dev, FUSE, phase=8, per_step=per_step)

  fused = {f: True for f in FUSE_FLAGS}
  unfused = {f: False for f in FUSE_FLAGS}
  box = {'state': state}

  def step():
    box['state'], _ = train_step(box['state'], batch)

  times = in_turns(step, {'fused': (model, fused),
                          'unfused': (model, unfused)})
  # A 4096-ray request (one chunk) on the same weights.
  rays = random_rays(rays_lib, 4096, config, 1, dev)
  request = lambda: renderer.render_rays(model, rays,
                                         config.render_chunk_size)
  with torch.no_grad():
    rtimes = in_turns(request, {
        'fused': (model, {**fused, 'fused_trunk': 'auto'}),
        'unfused': (model, {**unfused, 'fused_trunk': 'auto'}),
        'off': (model, {**fused, 'fused_trunk': 'off'})})
  med = lambda v: float(np.median(v)) * 1e3
  log('phase 8: train step in turns (fused, unfused, unfused, fused; 5 steps '
      'a block): ' + ', '.join(
          f'{a} {med(v):.2f} ms median [{min(v) * 1e3:.2f}, '
          f'{max(v) * 1e3:.2f}]' for a, v in times.items()))
  log('phase 8: 4096-ray request in turns (5 requests a block): ' + ', '.join(
      f'{a} {med(v):.2f} ms median [{min(v) * 1e3:.2f}, {max(v) * 1e3:.2f}]'
      for a, v in rtimes.items()))
  set_mode(model, fused_trunk='auto', **fused)
  with torch.no_grad():
    profile(request, 'fused 4096-ray request', 3)
  profile(step, 'fused train step', 2)
  return serve_launches, train_launches, step_s, {
      'step_fused_ms': med(times['fused']),
      'step_unfused_ms': med(times['unfused']),
      'request_fused_ms': med(rtimes['fused']),
      'request_unfused_ms': med(rtimes['unfused']),
      'request_off_ms': med(rtimes['off'])}


# Phase 9: (name, (IPE in the kernel, compositing, density gradient,
# backward)) of each fused spatial mode. 'K6+K7' on K1 is the served
# request's launch.
SPA_CASES = (('K7', (True, False, False, False)),
             ('K7+K3', (True, False, True, False)),
             ('K6+K7', (True, True, False, False)),
             ('K6+K3', (False, True, True, False)),
             ('K6+K7+K3', (True, True, True, False)),
             ('K6+K7+K4', (True, True, True, True)))


def spa_flops(enc, comp, dg, backward):
  """f32 operations of the fused spatial stages over N_SAMPLES, as the
  function needs them (a transcendental counts as one). A column of the
  IPE (48 a sample): m = lm s, v = lv s^2, -v/2, exp, sin, cos, e sin m,
  e cos m (8); with the density gradient the chain rule e (cos u - sin u)
  (4) and the factors again (8); its backward: the IPE for the recompute
  and the tangent (tp e) cos m, (tp e) sin m (3) with the factors again.
  The compositing weights: 10 a sample (softplus as exp, log1p and an add,
  the bias, times delta, the scan's add, two exps, 1 - and the product);
  backward 20 (the forward, the sigmoid, ct and the suffix)."""
  n = 0
  if enc:
    n += 48 * 8
    if dg and not backward:
      n += 48 * (4 + 8)
    if backward:
      n += 48 * (3 + 8)
  if comp:
    n += 20 if backward else 10
  return n * N_SAMPLES


def spa_case(fused_mlp, gen, dev, enc, comp):
  """The flagship spatial trunk (trunk_case 'K1') on N_SAMPLES rows of
  random lifted means and variances (lm in [-1.5, 1.5], lv in [1e-6,
  1e-2]), the segments (lm, lv) with K7, else their IPE; with K6 rays of
  SAMPLES rows, delta in [0.01, 0.09] (the flagship's t-intervals, 4 / 128,
  times |direction|) and bsig 0.5 (its density bias)."""
  _, ws, bs, kw = trunk_case('K1', gen, dev)
  rand = lambda *s: torch.rand(*s, generator=gen).to(dev)
  lm, lv = rand(N_SAMPLES, 3) * 3 - 1.5, 10.0**(rand(N_SAMPLES, 3) * 4 - 6)
  segs = [lm, lv] if enc else list(fused_mlp.encode_ipe(lm, lv, SCALES))
  cp = (rand(N_SAMPLES) * 0.08 + 0.01, torch.full((1,), 0.5, device=dev))
  sp = fused_mlp.SpaModes(tuple(float(s) for s in SCALES) if enc else (),
                          SAMPLES if comp else 0)
  return segs, ws, bs, kw, sp, cp if comp else None


def weight_faults(fused_mlp, which, cdt, raw, delta, bsig):
  """What two faults of K6 would read on the plain raw density: an
  inclusive scan (w e^-dd in place of w) and a dropped density bias (bsig
  0). Fails unless both read above WEIGHT_BOUND, so that the weights'
  check would see either."""
  w = fused_mlp.composite_weights(raw, delta, bsig, SAMPLES)
  dd = torch.nn.functional.softplus(raw.float() + bsig) * delta
  incl = (w * torch.exp(-dd) - w).abs().max().item()
  nobias = (fused_mlp.composite_weights(raw, delta, bsig * 0, SAMPLES)
            - w).abs().max().item()
  log(f'phase 9: {which} {cdt}: a fault in the weights would read '
      f'{incl:.3e} (inclusive scan), {nobias:.3e} (no density bias); '
      f'max weight {w.max().item():.3e}, bound {WEIGHT_BOUND[cdt]:.0e}')
  if not min(incl, nobias) > WEIGHT_BOUND[cdt]:
    raise AssertionError(f'{which} {cdt}: the weights\' bound does not see '
                         'a fault of K6')


def check_spa_kernels(fused_mlp, dev):
  """Phase 9: K7 on K1 and K3, K6 on K3, K6+K7 on K1, K3 and K4 against
  their plain versions, f32 and bf16."""
  gen = torch.Generator().manual_seed(SEED + 3)
  fold = torch.as_tensor(fused_mlp.ipe_scale_fold(SCALES, 3), device=dev)
  rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
  results = {}
  for which, (enc, comp, dg, backward) in SPA_CASES:
    segs, ws, bs, kw, sp, cp = spa_case(fused_mlp, gen, dev, enc, comp)
    f = fold if dg else None
    for cdt in ('float32', 'bfloat16'):
      cs = segs if enc else [s.to(fused_mlp.DTYPES[cdt]) for s in segs]
      pack = fused_mlp.pack_trunk(ws, bs, (48, 48), compute_dtype=cdt, **kw)
      inputs = cs + pack_tensors(pack) + [f] + list(cp or [])
      f32_flops = spa_flops(enc, comp, dg, backward)
      kws = dict(spa_modes=sp, comp=cp)
      if not backward:
        # sigma and the two heads are values, u a derivative, the weights
        # (after u) held by WEIGHT_BOUND.
        plain = lambda: fused_mlp.trunk_reference(
            cs, ws, bs, compute_dtype=cdt, density_grad=dg, fold=f, **kws,
            **kw)
        results[which, cdt] = compare(
            which, cdt, lambda: fused_mlp.trunk_kernel(cs, pack, f, **kws),
            plain, n_values=3, phase=9, inputs=inputs,
            flops=trunk_flops(ws, N_SAMPLES, n_heads(kw), density_grad=dg),
            f32_flops=f32_flops, weights=(4 if dg else 3) if comp else None)
        if comp:
          with torch.no_grad():
            weight_faults(fused_mlp, which, cdt, plain()[0], *cp)
        continue
      # Cotangents of (sigma, the f32 heads, the bottleneck, u, weights);
      # the forward's sigma from each side's own forward.
      cots = (rand(N_SAMPLES), rand(N_SAMPLES, 10), rand(N_SAMPLES, 128),
              rand(N_SAMPLES, 3), rand(N_SAMPLES))
      with torch.no_grad():
        sk = fused_mlp.trunk_kernel(cs, pack, f, **kws)[0]
        sr = fused_mlp.trunk_reference(cs, ws, bs, compute_dtype=cdt, **kws,
                                       **kw)[0]
      results[which, cdt] = compare(
          which, cdt,
          lambda: fused_mlp.trunk_backward_kernel(
              cs, pack, cots, f, spa_modes=sp, comp=cp + (sk,)),
          lambda: fused_mlp.trunk_backward_reference(
              cs, ws, bs, cots, compute_dtype=cdt, fold=f, spa_modes=sp,
              comp=cp + (sr,), **kw),
          n_values=0, iters=3, phase=9, inputs=inputs + list(cots) + [sk],
          flops=trunk_flops(ws, N_SAMPLES, n_heads(kw), density_grad=True,
                            backward=True),
          f32_flops=f32_flops)
      del pack, sk, sr
    del segs, ws, bs, kw, cp
    torch.cuda.empty_cache()
  return results


SPATIAL_FLAGS = ('fuse_ipe_trig', 'fuse_compositing', 'fuse_lift')


def spatial_stage(fused_mlp, dev):
  """Phase 10: the flagship with all six fuse flags, served and trained
  through the kernels, against fused_trunk='off' and timed in turns
  against phase 8's model (the fused directional stage alone)."""
  from refnerf_tpu_torch.models import renderer
  from refnerf_tpu_torch.cameras import rays as rays_lib
  flags = FUSE + SPATIAL
  serve_launches = serve(fused_mlp, dev, flags, phase=10,
                         kernels=('K1', 'K2', 'K6', 'K7', 'K8', 'K9', 'K10'))
  per_step = {'K2': 1, 'K3': 1, 'K4': 1, 'K5': 1, 'K6': 2, 'K7': 2, 'K8': 2,
              'K9': 2, 'K10': 2}
  train_launches, step_s, (model, config, state, train_step, batch) = train(
      fused_mlp, dev, flags, phase=10, per_step=per_step)

  six = {f: True for f in SPATIAL_FLAGS}
  dir_only = {f: False for f in SPATIAL_FLAGS}
  box = {'state': state}

  def step():
    box['state'], _ = train_step(box['state'], batch)

  times = in_turns(step, {'all six': (model, six),
                          'phase 8': (model, dir_only)})
  rays = random_rays(rays_lib, 4096, config, 1, dev)
  request = lambda: renderer.render_rays(model, rays,
                                         config.render_chunk_size)
  with torch.no_grad():
    rtimes = in_turns(request, {
        'all six': (model, {**six, 'fused_trunk': 'auto'}),
        'phase 8': (model, {**dir_only, 'fused_trunk': 'auto'}),
        'off': (model, {**six, 'fused_trunk': 'off'})})
  med = lambda v: float(np.median(v)) * 1e3
  log('phase 10: train step in turns (all six, phase 8, phase 8, all six; '
      '5 steps a block): ' + ', '.join(
          f'{a} {med(v):.2f} ms median [{min(v) * 1e3:.2f}, '
          f'{max(v) * 1e3:.2f}]' for a, v in times.items()))
  log('phase 10: 4096-ray request in turns (5 requests a block): ' +
      ', '.join(f'{a} {med(v):.2f} ms median [{min(v) * 1e3:.2f}, '
                f'{max(v) * 1e3:.2f}]' for a, v in rtimes.items()))
  set_mode(model, fused_trunk='auto', **six)
  with torch.no_grad():
    profile(request, 'all-six 4096-ray request', 3, phase=10)
  profile(step, 'all-six train step', 2, phase=10)
  return serve_launches, train_launches, step_s, {
      'step_six_ms': med(times['all six']),
      'step_phase8_ms': med(times['phase 8']),
      'request_six_ms': med(rtimes['all six']),
      'request_phase8_ms': med(rtimes['phase 8']),
      'request_off_ms': med(rtimes['off'])}


# Phase 11: (name, (trunk in TRUNKS, backward)) of each mip-NeRF case.
# 'K11' is the spatial trunk with y out; 'K1 hf=0' and 'K4 first-order'
# the shipped gin's spatial trunk with its bottleneck.
MIP_CASES = (('K11', ('mip K11', False)),
             ('K11 backward', ('mip K11', True)),
             ('K2 W128', ('mip K2', False)),
             ('K5 W128', ('mip K2', True)),
             ('K1 hf=0', ('mip K1', False)),
             ('K4 first-order', ('mip K1', True)))


def y_faults(fused_mlp, cdt, cs, ws, bs, kw, y):
  """What two faults of K11's y would read on the plain y, by relative L2:
  the last layer's bias dropped, and y stored before the last ReLU. Fails
  unless both read above Y_BOUND, so that y's check would see either."""
  ref = lambda w, b: fused_mlp.trunk_reference(cs, w, b, compute_dtype=cdt,
                                               out_y=True, **kw)[0]
  l2 = lambda f: ((f.float() - y.float()).norm() / y.float().norm()).item()
  nobias = l2(ref(ws, bs[:-1] + [bs[-1] * 0]))
  pre = l2(ref(ws[:-1], bs[:-1]).float() @ ws[-1].t() + bs[-1])
  log(f'phase 11: K11 {cdt}: a fault in y would read {nobias:.3e} (no last '
      f'bias), {pre:.3e} (before the last ReLU), relative L2; rms y '
      f'{y.float().square().mean().sqrt().item():.3e}, max |y| '
      f'{y.float().abs().max().item():.3e}, bound {Y_BOUND[cdt]:.0e}')
  if not min(nobias, pre) > Y_BOUND[cdt]:
    raise AssertionError(f'K11 {cdt}: y\'s bound does not see a fault of '
                         'its store')


def check_mip_kernels(fused_mlp, dev):
  """Phase 11: K11 forward and backward, K2 and K5 at width 128, K1 with
  hf = 0 and the first-order K4 against their plain versions, f32 and
  bf16. Forward values by KERNEL_BOUND, K11's y by Y_BOUND, derivatives by
  GRAD_BOUND."""
  gen = torch.Generator().manual_seed(SEED + 4)
  rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
  results = {}
  for which, (trunk, backward) in MIP_CASES:
    spatial = trunk != 'mip K2'
    segs, ws, bs, kw = trunk_case(trunk, gen, dev, ipe=spatial)
    out_y = trunk == 'mip K11'
    heads = n_heads(kw)
    # Cotangents of (sigma, the f32 head, the bottleneck, u) and of y.
    if spatial:
      cots = (rand(N_SAMPLES), None,
              rand(N_SAMPLES, 128) if kw['head_cdt'] else None, None)
    else:
      cots = (None, rand(N_SAMPLES, 3), None, None)
    ybar = rand(N_SAMPLES, 256) if out_y and backward else None
    for cdt in ('float32', 'bfloat16'):
      cs = [s.to(fused_mlp.DTYPES[cdt]) for s in segs]
      pack = fused_mlp.pack_trunk(ws, bs, [s.shape[-1] for s in cs],
                                  compute_dtype=cdt, **kw)
      inputs = cs + pack_tensors(pack)
      if not backward:
        plain = lambda: fused_mlp.trunk_reference(
            cs, ws, bs, compute_dtype=cdt, out_y=out_y, **kw)
        results[which, cdt] = compare(
            which, cdt, lambda: fused_mlp.trunk_kernel(cs, pack, out_y=out_y),
            plain, n_values=3, phase=11, inputs=inputs,
            flops=trunk_flops(ws, N_SAMPLES, heads),
            y=0 if out_y else None)
        if out_y:
          with torch.no_grad():
            y_faults(fused_mlp, cdt, cs, ws, bs, kw, plain()[0])
        continue
      yb = None if ybar is None else ybar.to(fused_mlp.DTYPES[cdt])
      results[which, cdt] = compare(
          which, cdt,
          lambda: fused_mlp.trunk_backward_kernel(
              cs, pack, cots, needs_dx=not spatial, ybar=yb),
          lambda: fused_mlp.trunk_backward_reference(
              cs, ws, bs, cots, compute_dtype=cdt, needs_dx=not spatial,
              ybar=yb, **kw),
          n_values=0, iters=3, phase=11,
          inputs=inputs + list(cots) + [yb],
          flops=trunk_flops(ws, N_SAMPLES, heads, backward=True,
                            needs_dx=not spatial))
      del pack
    del segs, ws, bs, kw, cots, ybar
    torch.cuda.empty_cache()
  return results


NO_VIEWDIRS = ['Model.use_viewdirs = False']


def mip_stage(fused_mlp, dev):
  """Phase 12: configs/blender_mipnerf.gin as shipped and with
  Model.use_viewdirs = False, each served (three requests) and trained
  (10 steps) through the kernels against fused_trunk='off', and one
  4096-ray request and one step of each profiled. Returns, per run,
  (request launches, step launches, seconds a step, request ms)."""
  from refnerf_tpu_torch.cameras import rays as rays_lib
  from refnerf_tpu_torch.models import renderer
  runs = {'shipped': ((), ('K1', 'K2'), {'K1': 1, 'K2': 1, 'K4': 1, 'K5': 1}),
          'no viewdirs': (NO_VIEWDIRS, ('K1', 'K11'),
                          {'K1': 1, 'K4': 1, 'K11': 2})}
  out = {}
  for run, (bindings, kernels, per_step) in runs.items():
    timings = {}
    serve_launches = serve(fused_mlp, dev, bindings, phase=12,
                           kernels=kernels, gin_name=MIPNERF, timings=timings)
    train_launches, step_s, (model, config, state, train_step, batch) = train(
        fused_mlp, dev, bindings, phase=12, per_step=per_step,
        gin_name=MIPNERF)
    box = {'state': state}

    def step():
      box['state'], _ = train_step(box['state'], batch)

    rays = random_rays(rays_lib, 4096, config, 1, dev)
    request = lambda: renderer.render_rays(model, rays,
                                           config.render_chunk_size)
    with torch.no_grad():
      profile(request, f'mip-NeRF {run} 4096-ray request', 3, phase=12)
    profile(step, f'mip-NeRF {run} train step', 2, phase=12)
    out[run] = (serve_launches, train_launches, step_s, timings)
    del model, state, train_step, batch, box
    torch.cuda.empty_cache()
  return out


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
  train_launches, step_s, _ = train(fused_mlp, dev)
  kernels.update(check_dir_kernels(fused_mlp, dev))
  dir_serve, dir_train, dir_step_s, ab = fused_stage(fused_mlp, dev)
  kernels.update(check_spa_kernels(fused_mlp, dev))
  spa_serve, spa_train, spa_step_s, ab6 = spatial_stage(fused_mlp, dev)
  kernels.update(check_mip_kernels(fused_mlp, dev))
  mip = mip_stage(fused_mlp, dev)
  (mip_serve, mip_train, _, _), (y_serve, y_train, _, _) = (
      mip['shipped'], mip['no viewdirs'])

  fwd_src = 'refnerf_tpu_torch/csrc/trunk_fwd.cu'
  bwd_src = 'refnerf_tpu_torch/csrc/trunk_bwd.cu'
  dir_src = 'refnerf_tpu_torch/csrc/trunk_common.cuh'
  pallas = 'refnerf_tpu/ops/pallas/fused_mlp.py'
  # name: (description, source, line of the TPU kernel, launches on the
  # main path: phase 4's requests, phase 6's steps, or both of phase 8 or
  # of phase 10), each with its phase-3/5/7/9 case.
  names = {
      'K1': ('spatial trunk (fused_encoded_trunk)', fwd_src, 612,
             launches['K1']),
      'K2': ('directional trunk (fused_trunk)', fwd_src, 612, launches['K2']),
      'K3': ('spatial trunk with the density gradient', fwd_src, 589,
             train_launches['K3']),
      'K4': ('spatial trunk backward', bwd_src, 668, train_launches['K4']),
      'K5': ('directional trunk backward with dx', bwd_src, 668,
             train_launches['K5']),
      'K6': ('in-kernel compositing weights (K3 fwd; K1, K4)', dir_src, 498,
             spa_serve['K6'] + spa_train['K6']),
      'K7': ('in-kernel IPE (K1 fwd; K3, K4)', dir_src, 550,
             spa_serve['K7'] + spa_train['K7']),
      'K8': ('in-kernel IDE in the directional trunk, fwd and bwd', dir_src,
             402, dir_serve['K8'] + dir_train['K8']),
      'K9': ('in-kernel direction geometry (with K8), fwd and bwd', dir_src,
             355, dir_serve['K9'] + dir_train['K9']),
      'K10': ('in-kernel colour epilogue, fwd and bwd', dir_src, 283,
              dir_serve['K10'] + dir_train['K10']),
      # Phase 12's: mip-NeRF as shipped, and without view directions (K11).
      'K11': ('trunk features y out (K1), their cotangent in (K4)', fwd_src,
              629, y_serve['K11'] + y_train['K11']),
      'K2 W128': ('directional trunk at width 128 (mip-NeRF)', fwd_src, 612,
                  mip_serve['K2'] + mip_train['K2']),
      'K5 W128': ('directional trunk backward at width 128, dx', bwd_src,
                  668, mip_train['K5']),
      'K1 hf=0': ('spatial trunk with the bottleneck head alone', fwd_src,
                  612, mip_serve['K1'] + mip_train['K1']),
      'K4 first-order': ('spatial trunk backward without the cotangent of '
                         'u', bwd_src, 668, mip_train['K4'])}
  line = []
  # K6 and K7 stand for their phase-9 cases; each entry also lists the
  # others it runs in.
  main_case = {'K6': 'K6+K3', 'K7': 'K7'}
  more_cases = {'K6': ('K6+K7', 'K6+K7+K3', 'K6+K7+K4'),
                'K7': ('K7+K3', 'K6+K7', 'K6+K7+K3', 'K6+K7+K4')}
  for which, (desc, src, at, count) in names.items():
    case = main_case.get(which, which)
    b16, f32 = kernels[case, 'bfloat16'], kernels[case, 'float32']
    entry = {
        'name': f'{which} {desc}', 'route': 'cuda', 'source': src,
        'replaces': f'{pallas}:{at}', 'launches': count,
        'max_abs_err': b16['max_abs_err'], 'ms': b16['ms'],
        'plain_ms': b16['plain_ms'], 'bound_ms': b16['bound_ms'],
        'bound_by': b16['bound_by'], 'library_ms': None,
        'dtype': 'bfloat16', 'n_samples': N_SAMPLES,
        'f32_max_abs_err': f32['max_abs_err'], 'f32_ms': f32['ms'],
        'f32_plain_ms': f32['plain_ms'], 'f32_bound_ms': f32['bound_ms']}
    if which in ('K8', 'K9', 'K10', 'K11'):
      entry['serve_launches'] = (y_serve if which == 'K11'
                                 else dir_serve)[which]
      entry['train_launches'] = (y_train if which == 'K11'
                                 else dir_train)[which]
      for cdt, pre in (('bfloat16', 'bwd_'), ('float32', 'f32_bwd_')):
        bw = kernels[which + ' backward', cdt]
        entry.update({pre + 'ms': bw['ms'], pre + 'plain_ms': bw['plain_ms'],
                      pre + 'bound_ms': bw['bound_ms'],
                      pre + 'max_abs_err': bw['max_abs_err']})
    if which == 'K2':
      entry['train_launches'] = train_launches['K2']
    if which in main_case:
      entry['case'] = case
      entry['serve_launches'] = spa_serve[which]
      entry['train_launches'] = spa_train[which]
      keys = ('ms', 'plain_ms', 'bound_ms', 'max_abs_err')
      entry['more'] = {c: {**{k: kernels[c, 'bfloat16'][k] for k in keys},
                           **{'f32_' + k: kernels[c, 'float32'][k]
                              for k in keys}}
                       for c in more_cases[which]}
    line.append(entry)
  log(f'phase 6: train step {step_s * 1e3:.2f} ms, '
      f'{TRAIN_BATCH / step_s:.0f} train rays/s; phase 8 (fused directional '
      f'stage): {dir_step_s * 1e3:.2f} ms, {TRAIN_BATCH / dir_step_s:.0f} '
      f'train rays/s; in turns {json.dumps(ab)}; phase 10 (all six): '
      f'{spa_step_s * 1e3:.2f} ms, {TRAIN_BATCH / spa_step_s:.0f} train '
      f'rays/s; in turns {json.dumps(ab6)}; phase 12 (mip-NeRF): ' + '; '.join(
          f'{run} {r[2] * 1e3:.2f} ms a step, {TRAIN_BATCH / r[2]:.0f} train '
          f'rays/s, requests ' + ', '.join(f'{k} {v:.1f} ms'
                                           for k, v in r[3].items())
          for run, r in mip.items()))
  print(json.dumps({'kernels': line}))
  print(json.dumps({'ok': True, 'device': {
      'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
      'count': torch.cuda.device_count()}}))
  return 0


if __name__ == '__main__':
  sys.exit(main())
