"""Break the trunk kernels' time down by phase, on one card.

From the root of a checkout, on a machine with an H100 and the CUDA toolkit:

    python3 -m refnerf_tpu_torch.tools.bwd_phases --out chiprun_out/phases \
        [--lib trunk_bwd_tma|trunk_bwd_f32|trunk_bwd|trunk_fwd_tma|
               trunk_fwd_f32|trunk_fwd|trunk_wide_tf32] [--dtype float32]
        [--cases 'K5 W128']

Builds a trunk library a second time with -DREFNERF_PHASES (its own file
in build/, never loaded on the main path): by default the bf16 width-256
backward of csrc/trunk_bwd_tma.cu; with --lib trunk_bwd_f32 the f32
width-256 backward of csrc/trunk_bwd_f32.cu (float32 by default); with
--lib trunk_bwd the mma.sync / FMA kernels of csrc/trunk_bwd.cu, which
then also run the width-256 flagship shapes (fused_mlp.backward_library
is patched to send every shape there): the design that trunk_bwd_tma.cu
(bf16) and trunk_bwd_f32.cu (--dtype float32) replaced. Likewise
for the forward: --lib trunk_fwd_tma the bf16 width-256 forward of
csrc/trunk_fwd_tma.cu, --lib trunk_fwd_f32 the f32 width-256 forward of
csrc/trunk_fwd_f32.cu (float32 by default), --lib trunk_fwd the mma.sync /
FMA forward of csrc/trunk_fwd.cu (fused_mlp.forward_library patched to send
every shape there: the design that trunk_fwd_tma.cu (bf16) and
trunk_fwd_f32.cu (--dtype float32) replaced); --lib trunk_wide_tf32 the f32
density-gradient forward of csrc/trunk_wide_tf32.cu (its case 'K3 wide
hc256', float32 by default).
Thread 0 of every CTA of the per-tile kernel adds the clock64() cycles of
each segment, closed by a barrier, to a (phase, kind) sum; kinds are the
products, the scalar passes and the stores (the backward's scratch, the
forward's outputs). Then, at N = 524,288 samples in --dtype and for each
case (backward: K4 with the cotangent of u, alone and with K6+K7; K5 with
dx, alone and with K8+K9+K10; first-order K4; K5 at width 128; K4 wide,
the proposal trunk on 504 columns; K4 wide hc256 ubar, the defaults' trunk
with the 256-wide bottleneck and u's cotangent; forward: K3 alone and with
K6+K7, K1 alone and with K6+K7, K2 alone and with K8+K9+K10, K2 at width
128, K11 with y out, K1 wide, K3 wide hc256; --cases picks some by name), it runs the kernel once through the phase build and reads the sums, and times the
per-tile (and for the backward the weight-gradient and reduction) kernels
under torch.profiler through the phase build and through the normal one.
Each
(phase, kind) gets its share of all CTAs' cycles and that share of the
per-tile kernel's time in the phase build (whose barriers add their own
cost: compare its time with the normal build's).
Prints one line per case and writes <out>/phases.json.
"""

import argparse
import ctypes
import json
import os
import pathlib
import subprocess
import sys
import time

import torch

PHASES = ('input and K6', 'recompute', 'heads', 'inner chain',
          'head backward', 'first-order reverse with dx', 'tangent')
FWD_PHASES = ('input (K7, K8)', 'layers', 'heads (K10, bottleneck)',
              'inner chain and fold (K3)', 'K6 scan')
KINDS = ('products', 'scalar passes', 'stores')
KERNELS = ('trunk_bwd', 'wgrad', 'reduce')
FWD_KERNELS = ('trunk_fwd',)


def build_phase_library(name):
  """csrc/<name>.cu with -DREFNERF_PHASES, its ctypes signatures set."""
  from refnerf_tpu_torch.ops import cuda_build
  lib = cuda_build.variant(name, 'REFNERF_PHASES')
  lib.refnerf_phase_cycles.argtypes = [ctypes.c_void_p, ctypes.c_int]
  lib.refnerf_phase_cycles.restype = ctypes.c_int
  return lib


def read_cycles(lib, reset=True):
  buf = (ctypes.c_ulonglong * (len(PHASES) * len(KINDS)))()
  err = lib.refnerf_phase_cycles(ctypes.addressof(buf), int(reset))
  if err:
    raise RuntimeError(f'refnerf_phase_cycles failed with cudaError {err}')
  return [list(buf[i * len(KINDS):(i + 1) * len(KINDS)])
          for i in range(len(PHASES))]


def device_ms(run, kernels=KERNELS, calls=2):
  """Device ms a call of each trunk kernel in `kernels` (by name) under
  torch.profiler, over `calls` calls after one warm-up."""
  from torch.profiler import ProfilerActivity, profile
  run()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    for _ in range(calls):
      run()
    torch.cuda.synchronize()
  out = {k: 0.0 for k in kernels}
  for e in p.key_averages():
    if e.device_type != torch.autograd.DeviceType.CUDA:
      continue
    us = getattr(e, 'self_device_time_total',
                 getattr(e, 'self_cuda_time_total', 0))
    for k in kernels:
      if any(f'{k}{v}_kernel' in e.key for v in ('', '_tma', '_f32', '_tf32')):
        out[k] += us / 1e3 / calls
  return out


def cases(chip_smoke, fused_mlp, dev, cdt):
  """(name, backward call) at chip_smoke's N in `cdt`: phase 5's K4 and K5,
  phase 9's K6+K7+K4, phase 7's K8+K9+K10 backward, phase 11's
  first-order K4 (mip-NeRF's spatial trunk, no cotangent of u) and K5 W128
  (mip-NeRF's width-128 directional trunk with dx), and phase 19's K4 wide
  (the proposal trunk of depth 4 on 504 columns, the wide-input
  instance)."""
  tdt = fused_mlp.DTYPES[cdt]
  gen = torch.Generator().manual_seed(chip_smoke.SEED + 1)
  n = chip_smoke.N_SAMPLES
  rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
  fold = torch.as_tensor(fused_mlp.ipe_scale_fold(chip_smoke.SCALES, 3),
                         device=dev)
  segs, ws, bs, kw = chip_smoke.trunk_case('K1', gen, dev, ipe=True)
  cs = [s.to(tdt) for s in segs]
  pack = fused_mlp.pack_trunk(ws, bs, (48, 48), compute_dtype=cdt, **kw)
  cots = (rand(n), rand(n, 10), rand(n, 128), rand(n, 3))
  yield 'K4', lambda: fused_mlp.trunk_backward_kernel(cs, pack, cots, fold)
  segs, ws, bs, kw, sp, cp = chip_smoke.spa_case(fused_mlp, gen, dev, True,
                                                  True)
  pack = fused_mlp.pack_trunk(ws, bs, (48, 48), compute_dtype=cdt, **kw)
  with torch.no_grad():
    sk = fused_mlp.trunk_kernel(segs, pack, fold, spa_modes=sp, comp=cp)[0]
  cots6 = cots + (rand(n),)
  yield 'K6+K7+K4', lambda: fused_mlp.trunk_backward_kernel(
      segs, pack, cots6, fold, spa_modes=sp, comp=cp + (sk,))
  segs, ws, bs, kw = chip_smoke.trunk_case('K2', gen, dev)
  cs = [s.to(tdt) for s in segs]
  pack = fused_mlp.pack_trunk(ws, bs, (128, 73), compute_dtype=cdt, **kw)
  cots5 = (None, rand(n, 3), None, None)
  yield 'K5', lambda: fused_mlp.trunk_backward_kernel(cs, pack, cots5,
                                                       needs_dx=True)
  segs, ws, bs, head, dm, rgbx = chip_smoke.dir_case(fused_mlp, gen, dev,
                                                     True, True, True)
  raw = range(1, 1 + dm.n_raw())
  cs = [s if j in raw else s.to(tdt) for j, s in enumerate(segs)]
  pack = fused_mlp.pack_trunk(ws, bs, fused_mlp.visible_dims(cs, dm),
                              head_f32=head, compute_dtype=cdt)
  rgb_bar = rand(n, 3)
  yield 'K8+K9+K10 backward', lambda: fused_mlp.trunk_backward_kernel(
      cs, pack, cots5, needs_dx=True, rgb_bar=rgb_bar, dir_modes=dm,
      rgbx=rgbx)
  segs, ws, bs, kw = chip_smoke.trunk_case('mip K1', gen, dev, ipe=True)
  cs = [s.to(tdt) for s in segs]
  pack = fused_mlp.pack_trunk(ws, bs, (48, 48), compute_dtype=cdt, **kw)
  cots1 = (rand(n), None, rand(n, 128), None)
  yield 'K4 first-order', lambda: fused_mlp.trunk_backward_kernel(cs, pack,
                                                                  cots1)
  segs, ws, bs, kw = chip_smoke.trunk_case('mip K2', gen, dev)
  cs = [s.to(tdt) for s in segs]
  pack = fused_mlp.pack_trunk(ws, bs, (128, 33), compute_dtype=cdt, **kw)
  yield 'K5 W128', lambda: fused_mlp.trunk_backward_kernel(cs, pack, cots5,
                                                           needs_dx=True)
  segs, ws, bs, kw = chip_smoke.prop_case(fused_mlp, gen, dev, 4, cdt)
  pack = fused_mlp.pack_trunk(ws, bs, (252, 252), compute_dtype=cdt, **kw)
  cotsw = (rand(n), None, None, None)
  yield 'K4 wide', lambda: fused_mlp.trunk_backward_kernel(segs, pack, cotsw)
  segs, ws, bs, kw, fold, (sbar, cbar, ubar) = chip_smoke.defaults_case(
      fused_mlp, gen, dev, n, 256)
  cs = [s.to(tdt) for s in segs]
  pack = fused_mlp.pack_trunk(ws, bs, (252, 252), compute_dtype=cdt, **kw)
  cotsd = (sbar, None, cbar.to(tdt), ubar)
  yield 'K4 wide hc256 ubar', lambda: fused_mlp.trunk_backward_kernel(
      cs, pack, cotsd, fold)


def fwd_cases(chip_smoke, fused_mlp, dev, cdt):
  """(name, forward call) at chip_smoke's N in `cdt`: phase 9's K6+K7+K3,
  phase 5's K3, the served K6+K7 on K1, phase 3's K1 and K2, phase 7's
  K8+K9+K10, phase 11's K2 W128 (mip-NeRF's width-128 directional trunk)
  and K11 (mip-NeRF's spatial trunk with its features y out), and phase
  19's K1 wide (the proposal trunk of depth 4 on 504 columns)."""
  tdt = fused_mlp.DTYPES[cdt]
  gen = torch.Generator().manual_seed(chip_smoke.SEED + 1)
  fold = torch.as_tensor(fused_mlp.ipe_scale_fold(chip_smoke.SCALES, 3),
                         device=dev)
  lmv, ws, bs, kw, sp, cp = chip_smoke.spa_case(fused_mlp, gen, dev, True,
                                                 True)
  pack7 = fused_mlp.pack_trunk(ws, bs, (48, 48), compute_dtype=cdt, **kw)
  yield 'K6+K7+K3', lambda: fused_mlp.trunk_kernel(lmv, pack7, fold,
                                                   spa_modes=sp, comp=cp)
  yield 'K6+K7 on K1', lambda: fused_mlp.trunk_kernel(lmv, pack7,
                                                      spa_modes=sp, comp=cp)
  segs, ws, bs, kw = chip_smoke.trunk_case('K1', gen, dev, ipe=True)
  cs = [s.to(tdt) for s in segs]
  pack1 = fused_mlp.pack_trunk(ws, bs, (48, 48), compute_dtype=cdt, **kw)
  yield 'K3', lambda: fused_mlp.trunk_kernel(cs, pack1, fold)
  yield 'K1', lambda: fused_mlp.trunk_kernel(cs, pack1)
  segs, ws, bs, kw = chip_smoke.trunk_case('K2', gen, dev)
  cs2 = [s.to(tdt) for s in segs]
  pack2 = fused_mlp.pack_trunk(ws, bs, (128, 73), compute_dtype=cdt, **kw)
  yield 'K2', lambda: fused_mlp.trunk_kernel(cs2, pack2)
  segs, ws, bs, head, dm, rgbx = chip_smoke.dir_case(fused_mlp, gen, dev,
                                                     True, True, True)
  raw = range(1, 1 + dm.n_raw())
  cs3 = [s if j in raw else s.to(tdt) for j, s in enumerate(segs)]
  pack3 = fused_mlp.pack_trunk(ws, bs, fused_mlp.visible_dims(cs3, dm),
                               head_f32=head, compute_dtype=cdt)
  yield 'K8+K9+K10', lambda: fused_mlp.trunk_kernel(cs3, pack3, dir_modes=dm,
                                                    rgbx=rgbx)
  segs, ws, bs, kw = chip_smoke.trunk_case('mip K2', gen, dev)
  cs4 = [s.to(tdt) for s in segs]
  pack4 = fused_mlp.pack_trunk(ws, bs, (128, 33), compute_dtype=cdt, **kw)
  yield 'K2 W128', lambda: fused_mlp.trunk_kernel(cs4, pack4)
  segs, ws, bs, kw = chip_smoke.trunk_case('mip K11', gen, dev, ipe=True)
  cs5 = [s.to(tdt) for s in segs]
  pack5 = fused_mlp.pack_trunk(ws, bs, (48, 48), compute_dtype=cdt, **kw)
  yield 'K11', lambda: fused_mlp.trunk_kernel(cs5, pack5, out_y=True)
  segs6, ws, bs, kw = chip_smoke.prop_case(fused_mlp, gen, dev, 4, cdt)
  pack6 = fused_mlp.pack_trunk(ws, bs, (252, 252), compute_dtype=cdt, **kw)
  yield 'K1 wide', lambda: fused_mlp.trunk_kernel(segs6, pack6)
  segs, ws, bs, kw, fold, _ = chip_smoke.defaults_case(
      fused_mlp, gen, dev, chip_smoke.N_SAMPLES, 256)
  cs7 = [s.to(tdt) for s in segs]
  pack7 = fused_mlp.pack_trunk(ws, bs, (252, 252), compute_dtype=cdt, **kw)
  yield 'K3 wide hc256', lambda: fused_mlp.trunk_kernel(cs7, pack7, fold)


def main():
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument('--out', default='chiprun_out/phases')
  ap.add_argument('--lib', default='trunk_bwd_tma',
                  choices=('trunk_bwd_tma', 'trunk_bwd_f32', 'trunk_bwd',
                           'trunk_fwd_tma', 'trunk_fwd_f32', 'trunk_fwd',
                           'trunk_wide_tf32'))
  ap.add_argument('--dtype', default=None, choices=('bfloat16', 'float32'),
                  help='float32 for the *_f32 libraries, else bfloat16 by '
                  'default')
  ap.add_argument('--cases', default='',
                  help='case names to run, comma-separated (default: all)')
  a = ap.parse_args()
  a.dtype = a.dtype or ('float32' if a.lib.endswith(('_f32', '_tf32'))
                        else 'bfloat16')
  if not torch.cuda.is_available():
    raise SystemExit('bwd_phases: no CUDA device')
  sys.path.insert(0, os.getcwd())
  import chip_smoke
  from refnerf_tpu_torch.ops import cuda_build
  from refnerf_tpu_torch.ops import fused_mlp
  dev = torch.device('cuda')
  torch.backends.cuda.matmul.allow_tf32 = False
  smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                        '--format=csv,noheader'], capture_output=True,
                       text=True, timeout=60).stdout.strip()
  print(smi, flush=True)
  t0 = time.perf_counter()
  cuda_build.build()
  normal = cuda_build.library
  phased = build_phase_library(a.lib)
  print(f'built in {time.perf_counter() - t0:.1f} s', flush=True)
  patched = lambda name: phased if name == a.lib else normal(name)
  if a.lib == 'trunk_bwd':
    fused_mlp.backward_library = lambda *a, **k: 'trunk_bwd'
  if a.lib == 'trunk_fwd':
    fused_mlp.forward_library = lambda pack, *modes, **kw: 'trunk_fwd'
  forward = a.lib.startswith('trunk_fwd') or a.lib == 'trunk_wide_tf32'
  phases = FWD_PHASES if forward else PHASES
  kernels = FWD_KERNELS if forward else KERNELS
  report = {'card': smi, 'n_samples': chip_smoke.N_SAMPLES, 'lib': a.lib,
            'dtype': a.dtype, 'cases': {}}
  only = set(filter(None, a.cases.split(',')))
  for name, run in (fwd_cases if forward else cases)(chip_smoke, fused_mlp,
                                                      dev, a.dtype):
    if only and name not in only:
      continue
    base = device_ms(run, kernels)
    cuda_build.library = patched
    try:
      stamped = device_ms(run, kernels)
      read_cycles(phased)
      run()
      torch.cuda.synchronize()
      cyc = read_cycles(phased)
    finally:
      cuda_build.library = normal
    total = sum(map(sum, cyc)) or 1
    rows = {f'{phases[i]} / {KINDS[j]}': {
        'share': cyc[i][j] / total,
        'ms': cyc[i][j] / total * stamped[kernels[0]]}
            for i in range(len(phases)) for j in range(len(KINDS))
            if cyc[i][j]}
    report['cases'][name] = {'normal_ms': base, 'phase_build_ms': stamped,
                             'phases': rows}
    print(f'{name}: normal build ms ' + ', '.join(
        f'{k} {v:.3f}' for k, v in base.items()) + '; phase build ms ' +
          ', '.join(f'{k} {v:.3f}' for k, v in stamped.items()), flush=True)
    for k, r in rows.items():
      print(f'  {name}: {k}: {100 * r["share"]:.1f}% = {r["ms"]:.3f} ms',
            flush=True)
  out = pathlib.Path(a.out)
  out.mkdir(parents=True, exist_ok=True)
  (out / 'phases.json').write_text(json.dumps(report, indent=1))
  return 0


if __name__ == '__main__':
  sys.exit(main())
