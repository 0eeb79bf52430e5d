"""Write an analytic, 3D-consistent test scene: a shaded sphere.

A numpy copy of tools/make_sphere_scene.py's renderer (which imports
Pillow) that writes its PNGs with the port's own codec
(`refnerf_tpu_torch.utils.io`). It produces a Blender-format dataset
(transforms_{split}.json + RGBA PNGs) of a Lambertian sphere whose albedo
varies with the surface normal, rendered by exact ray-sphere intersection.

    python3 -m refnerf_tpu_torch.tools.sphere_scene DIR [N_TRAIN N_TEST RES]
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from refnerf_tpu_torch.utils import io as io_lib

SPHERE_RADIUS = 1.0
CAM_DIST = 4.0
FOV_X = 0.6911112070083618  # matches nerf_synthetic


def look_at_pose(theta, phi=0.35):
  """Camera on a sphere of radius CAM_DIST looking at the origin (OpenGL)."""
  pos = CAM_DIST * np.array([
      np.cos(theta) * np.cos(phi),
      np.sin(theta) * np.cos(phi),
      np.sin(phi)])
  z = pos / np.linalg.norm(pos)           # back vector (camera looks -z)
  up = np.array([0.0, 0.0, 1.0])
  x = np.cross(up, z)
  x /= np.linalg.norm(x)
  y = np.cross(z, x)
  c2w = np.eye(4)
  c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = x, y, z, pos
  return c2w


def render_view(c2w, res):
  """Exact render: ray-sphere intersection, normal-colored Lambertian."""
  focal = 0.5 * res / np.tan(0.5 * FOV_X)
  xs, ys = np.meshgrid(np.arange(res) + 0.5, np.arange(res) + 0.5,
                       indexing='xy')
  dirs_cam = np.stack([
      (xs - res / 2) / focal, -(ys - res / 2) / focal, -np.ones_like(xs)], -1)
  dirs = dirs_cam @ c2w[:3, :3].T
  dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
  origin = c2w[:3, 3]

  # |o + t d|^2 = r^2
  b = 2 * (dirs @ origin)
  c = origin @ origin - SPHERE_RADIUS ** 2
  disc = b ** 2 - 4 * c
  hit = disc > 0
  t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / 2, np.inf)

  pts = origin + t[..., None] * dirs
  normals = pts / SPHERE_RADIUS
  # Albedo from the normal direction (smooth, view-consistent).
  albedo = 0.5 + 0.5 * normals
  light = np.array([0.58, 0.58, 0.58])
  with np.errstate(invalid='ignore'):  # NaN miss rays, masked below
    lambert = np.clip(normals @ light, 0.1, 1.0)[..., None]
  rgb = np.where(hit[..., None], albedo * lambert, 1.0)  # white background
  alpha = hit.astype(np.float32)
  return np.clip(rgb, 0, 1), alpha


def make_scene(root, n_train=12, n_test=4, res=64):
  """Write the scene under `root`; returns `root`."""
  os.makedirs(root, exist_ok=True)
  for split, n, offset in [('train', n_train, 0.0),
                           ('test', n_test, 0.5 * np.pi / n_test)]:
    frames = []
    for i in range(n):
      theta = 2 * np.pi * i / n + offset
      c2w = look_at_pose(theta)
      rgb, alpha = render_view(c2w, res)
      rgba = np.concatenate([rgb, alpha[..., None]], -1)
      name = f'r_{split}_{i}'
      with open(os.path.join(root, name + '.png'), 'wb') as f:
        f.write(io_lib.encode_png((rgba * 255).astype(np.uint8)))
      frames.append({'file_path': name, 'transform_matrix': c2w.tolist()})
    meta = {'camera_angle_x': FOV_X, 'frames': frames}
    with open(os.path.join(root, f'transforms_{split}.json'), 'w') as f:
      json.dump(meta, f)
  return root


if __name__ == '__main__':
  if len(sys.argv) < 2:
    sys.exit(__doc__)
  sizes = [int(a) for a in sys.argv[2:5]]
  make_scene(sys.argv[1], *sizes)
  print(f'wrote analytic sphere scene to {sys.argv[1]}')
