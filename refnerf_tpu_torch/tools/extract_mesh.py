"""Extract a triangle mesh (PLY) from a trained checkpoint's density field
(counterpart of tools/extract_mesh.py).

Evaluates the NerfMLP density on a grid through its spatial stage (on the
card, the spatial trunk kernel) and runs marching tetrahedra with
density-gradient normals (`refnerf_tpu_torch/geometry.py`):

    python3 -m refnerf_tpu_torch.tools.extract_mesh --gin_configs=... \
        [--resolution 256] [--iso 25] [--bound 1.5] [--out mesh.ply] \
        [--device cuda]

The eval CLI's flags plus the mesh flags. The bounds default to the
[-bound, bound]^3 cube around the origin, the Blender object box; for
LLFF-style scenes pass --lower and --upper. The mesh goes to
<checkpoint dir>/mesh_step_<step>.ply unless --out names a file; its
header comment `lattice_step X Y Z` is the grid's spacing, which
`tools/mesh_error.py` reads. Exits 1
on an empty mesh. The model runs on the card unless `--device cpu` is
given.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from refnerf_tpu_torch.cli import flags


def _floats(text):
  return [float(v) for v in text.split(',')]


def _arguments(parser):
  parser.add_argument('--resolution', type=int, default=256,
                      help='grid resolution per axis')
  parser.add_argument('--iso', type=float, default=25.0,
                      help='density isovalue; a negative value picks the '
                           'grid midpoint (min+max)/2')
  parser.add_argument('--bound', type=float, default=1.5,
                      help='half-extent of the sampling cube')
  parser.add_argument('--lower', type=_floats, default=None,
                      help='explicit lower corner x,y,z')
  parser.add_argument('--upper', type=_floats, default=None,
                      help='explicit upper corner x,y,z')
  parser.add_argument('--out', default=None,
                      help='output .ply (default <ckpt_dir>/mesh_step_N.ply)')


def main(argv=None):
  config, gin, args = flags.load_config(argv, __doc__, 'eval', False,
                                        _arguments)
  if (args.lower is None) != (args.upper is None):
    raise SystemExit('--lower and --upper must be given together')

  from refnerf_tpu_torch import geometry
  from refnerf_tpu_torch.system import NeRFSystem
  from refnerf_tpu_torch.train import checkpoints as ckpt_lib

  system = NeRFSystem(config, gin, device=args.device)
  step = system.restore_latest()
  print(f'Extracting mesh from checkpoint at step {step}')
  if args.lower is not None:
    lower, upper = args.lower, args.upper
  else:
    lower, upper = [-args.bound] * 3, [args.bound] * 3

  out = geometry.extract_mesh(system.model, resolution=args.resolution,
                              lower=lower, upper=upper,
                              iso=None if args.iso < 0 else args.iso)
  verts, faces = out['verts'], out['faces']
  print(f'{len(verts)} vertices, {len(faces)} faces '
        f'(density range {out["grid"].min():.2f}..{out["grid"].max():.2f}'
        f'{", diffuse vertex colors" if out["colors"] is not None else ""})')
  path = args.out or os.path.join(
      ckpt_lib.checkpoint_dir(config), f'mesh_step_{step}.ply')
  step_xyz = (np.asarray(upper, np.float64) - np.asarray(lower, np.float64)
              ) / (args.resolution - 1)
  geometry.write_ply(path, verts, faces, out['normals'], colors=out['colors'],
                     comments=['lattice_step ' + ' '.join(
                         repr(float(v)) for v in step_xyz)])
  print(f'Wrote {path}')
  return 0 if len(faces) else 1


if __name__ == '__main__':
  sys.exit(main())
