"""How far an extracted mesh lies from the analytic sphere of
`tools/sphere_scene.py` (radius SPHERE_RADIUS about the origin).

    python3 -m refnerf_tpu_torch.tools.mesh_error MESH.ply

MESH.ply is a mesh `tools/extract_mesh.py` wrote: its header comment
`lattice_step X Y Z` gives the spacing of the grid it sampled. Prints
`MESH_ERROR vertices=V faces=F lattice_step=L within_step=S median_abs=M
max_abs=X r_minus_1_p10=A p50=B p90=C`: the share of vertices within one
lattice step (L, the mean of the three) of the sphere, the median and
largest |r - SPHERE_RADIUS| of the vertices, and the 10th, 50th and 90th
percentiles of the signed r - SPHERE_RADIUS (positive outside the
sphere).
"""

from __future__ import annotations

import argparse

import numpy as np

from refnerf_tpu_torch import geometry
from refnerf_tpu_torch.tools import sphere_scene


def sphere_error(verts, lattice_step):
  """(share of vertices within `lattice_step` of the sphere, median and
  largest |r - SPHERE_RADIUS|)."""
  err = np.abs(np.linalg.norm(np.asarray(verts, np.float64), axis=-1)
               - sphere_scene.SPHERE_RADIUS)
  return (float(np.mean(err <= lattice_step)), float(np.median(err)),
          float(err.max()))


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
  p.add_argument('mesh')
  args = p.parse_args(argv)
  mesh = geometry.read_ply(args.mesh)
  if not len(mesh['verts']):
    raise SystemExit(f'{args.mesh} holds no vertex')
  steps = [c.split()[1:] for c in mesh.get('comments', ())
           if c.split()[0] == 'lattice_step']
  if not steps:
    raise SystemExit(f'{args.mesh} names no lattice step (a header comment '
                     'lattice_step X Y Z, as tools/extract_mesh.py writes)')
  step = float(np.mean([float(v) for v in steps[0]]))
  within, median, worst = sphere_error(mesh['verts'], step)
  signed = (np.linalg.norm(mesh['verts'].astype(np.float64), axis=-1)
            - sphere_scene.SPHERE_RADIUS)
  p10, p50, p90 = np.percentile(signed, [10, 50, 90])
  print(f'MESH_ERROR vertices={len(mesh["verts"])} '
        f'faces={len(mesh["faces"])} lattice_step={step:.6f} '
        f'within_step={within:.6f} median_abs={median:.6f} '
        f'max_abs={worst:.6f} r_minus_1_p10={p10:.6f} p50={p50:.6f} '
        f'p90={p90:.6f}')
  return within, median, worst


if __name__ == '__main__':
  main()
