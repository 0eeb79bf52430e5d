"""Eval-rendering throughput: full-extras image rendering rays/s
(counterpart of tools/bench_render.py).

The reference's benchmark surface includes per-image render times
(render_times.txt / avg_metrics.txt). This measures the same pipeline
(`models/renderer.py` `render_image` with the extras, chunked) on synthetic
frames of the flagship (configs/blender_refnerf.gin) in bf16 and prints
one JSON line:

    python3 -m refnerf_tpu_torch.tools.bench_render [--res 128] \
        [--chunk 4096] [--frames 5] [--device cuda] [--bindings '...']

`--bindings` (repeatable) adds gin bindings after the bf16 one. A first
frame, untimed, builds the kernels' packs (and on a new checkout the
kernels). The frame ends on the host, so its time includes the copy back.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

_GIN = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), 'configs', 'blender_refnerf.gin')


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument('--res', type=int, default=128)
  p.add_argument('--chunk', type=int, default=4096)
  p.add_argument('--frames', type=int, default=5)
  p.add_argument('--device', default='cuda')
  p.add_argument('--bindings', action='append', default=[])
  args = p.parse_args(argv)

  from refnerf_tpu_torch import configs as configs_lib
  from refnerf_tpu_torch.cameras import camera_utils
  from refnerf_tpu_torch.models import construct, renderer

  config, gin = configs_lib.parse(
      [_GIN], [f'Config.render_chunk_size = {args.chunk}',
               "NerfMLP.compute_dtype = 'bfloat16'", *args.bindings])
  model = construct.construct_model(config, gin, args.device)
  c2w = np.eye(4)[:3].astype(np.float32)
  c2w[2, 3] = 4.0
  res = args.res
  rays = camera_utils.cast_pinhole_rays(c2w, res, res, res * 1.2,
                                        config.near, config.far, args.device)
  render = lambda: renderer.render_image(model, rays, config.render_chunk_size,
                                         compute_extras=True)
  render()  # warm-up: packs (and kernels) built
  t0 = time.perf_counter()
  for _ in range(args.frames):
    render()
  elapsed = time.perf_counter() - t0
  out = {
      'metric': 'render_rays_per_sec',
      'value': round(res * res * args.frames / elapsed, 1),
      'unit': 'rays/s',
      'seconds_per_frame': round(elapsed / args.frames, 4),
      'resolution': res,
      'device': str(args.device),
  }
  print(json.dumps(out))
  return out


if __name__ == '__main__':
  main()
