"""Write analytic, 3D-consistent test scenes of a shaded sphere.

Numpy copies of tools/make_sphere_scene.py's and
tools/make_sphere_llff_scene.py's renderers (which import Pillow) that write
their PNGs with the port's own codec (`refnerf_tpu_torch.utils.io`):

- `make_scene`: a Blender-format dataset (transforms_{split}.json + RGBA
  PNGs) of a Lambertian sphere whose albedo varies with the surface normal,
  rendered by exact ray-sphere intersection.
- `make_llff_scene`: a forward-facing LLFF-layout capture (images_<factor>/,
  images/, sparse/0 as a binary COLMAP model, poses_bounds.npy) of the same
  sphere made specular with tools/make_shiny_scene.py's environment lobes,
  seen by a grid of cameras translating in front of it.

    python3 -m refnerf_tpu_torch.tools.sphere_scene DIR [N_TRAIN N_TEST RES]
    python3 -m refnerf_tpu_torch.tools.sphere_scene --llff DIR [N WIDTH HEIGHT FACTOR]
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from refnerf_tpu_torch.data import colmap
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


# tools/make_shiny_scene.py's environment: (direction, colour, exponent) of
# each lobe, and the diffuse and specular weights of the mix.
_LOBES = [
    (np.array([0.577, 0.577, 0.577]), np.array([0.9, 0.7, 0.2]), 96.0),
    (np.array([-0.707, 0.0, 0.707]), np.array([0.2, 0.5, 0.9]), 48.0),
    (np.array([0.0, -0.894, 0.447]), np.array([0.7, 0.2, 0.6]), 24.0),
]
_DIFFUSE_WEIGHT = 0.45
_SPECULAR_WEIGHT = 0.55


def env_radiance(dirs):
  """Smooth environment radiance of (unit) directions; NaN rows (misses)
  are masked by the caller."""
  out = np.full(dirs.shape[:-1] + (3,), 0.08)
  with np.errstate(invalid='ignore'):
    for d, c, p in _LOBES:
      out = out + np.maximum(0.0, dirs @ d)[..., None] ** p * c
  return out


def render_view_opencv(c2w, width, height, focal):
  """Exact render of the specular sphere for an OpenCV-convention (z
  forward) camera with its principal point at the image centre: the shaded
  albedo mixed with the mirror reflection of the environment."""
  xs, ys = np.meshgrid(np.arange(width) + 0.5, np.arange(height) + 0.5,
                       indexing='xy')
  dirs_cam = np.stack([(xs - width / 2) / focal, (ys - height / 2) / focal,
                       np.ones_like(xs)], -1)
  dirs = dirs_cam @ c2w[:3, :3].T
  dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
  origin = c2w[:3, 3]

  b = 2 * (dirs @ origin)
  c = origin @ origin - SPHERE_RADIUS ** 2
  disc = b ** 2 - 4 * c
  hit = disc > 0
  # Misses get t = 0 so their shading stays finite; it is masked below.
  t = np.where(hit, (-b - np.sqrt(np.maximum(disc, 0))) / 2, 0.0)
  pts = origin + t[..., None] * dirs
  normals = np.where(hit[..., None], pts / SPHERE_RADIUS, 1.0)
  albedo = 0.5 + 0.5 * normals
  light = np.array([0.58, 0.58, 0.58])
  shade = albedo * np.clip(normals @ light, 0.1, 1.0)[..., None]
  refl = dirs - 2.0 * (dirs * normals).sum(-1, keepdims=True) * normals
  shade = _DIFFUSE_WEIGHT * shade + _SPECULAR_WEIGHT * env_radiance(refl)
  return np.clip(np.where(hit[..., None], shade, 1.0), 0, 1)


def _quat_from_rotmat(r):
  w = np.sqrt(max(0, 1 + r[0, 0] + r[1, 1] + r[2, 2])) / 2
  return np.array([w, (r[2, 1] - r[1, 2]) / (4 * w),
                   (r[0, 2] - r[2, 0]) / (4 * w),
                   (r[1, 0] - r[0, 1]) / (4 * w)])


def make_llff_scene(root, n_images=12, width=64, height=None, factor=0):
  """Write a forward-facing capture of the sphere under `root`; returns
  `root`.

  The views are `width` x `height` (square by default) and go to
  `images_<factor>/`, the directory a loader with `Config.factor = factor`
  reads; the COLMAP camera is that of the full capture, `factor` times
  larger (factor 0 or 1: `images/` at the views' size). `images/` holds
  the COLMAP names; with a factor it holds copies of the small views (the
  loaders read only its file names). Cameras sit on a grid four wide at
  z = -4, looking at the sphere along +z (OpenCV); poses_bounds.npy carries
  the depth bounds [3, 5].
  """
  height = height or width
  scale = max(1, factor)
  focal = width * 1.2
  img_dirs = [os.path.join(root, 'images')]
  if scale > 1:
    img_dirs.append(os.path.join(root, f'images_{factor}'))
  for d in img_dirs:
    os.makedirs(d, exist_ok=True)

  cams = {1: colmap.Camera(
      1, 'SIMPLE_PINHOLE', width * scale, height * scale,
      np.array([focal * scale, width * scale / 2, height * scale / 2]))}
  images = {}
  rows = -(-n_images // 4)
  for i in range(n_images):
    c2w = np.eye(4)
    c2w[:3, 3] = [0.35 * (i % 4 - 1.5), 0.25 * (i // 4 - (rows - 1) / 2),
                  -4.0]
    rgb = render_view_opencv(c2w, width, height, focal)
    name = f'img_{i:03d}.png'
    png = io_lib.encode_png((rgb * 255).astype(np.uint8))
    for d in img_dirs:
      with open(os.path.join(d, name), 'wb') as f:
        f.write(png)
    w2c_r = c2w[:3, :3].T
    images[i + 1] = colmap.ImagePose(i + 1, _quat_from_rotmat(w2c_r),
                                     -w2c_r @ c2w[:3, 3], 1, name)

  colmap.write_test_model(os.path.join(root, 'sparse', '0'), cams, images)
  poses_bounds = np.concatenate(
      [np.zeros((n_images, 15)), np.tile([3.0, 5.0], (n_images, 1))], -1)
  np.save(os.path.join(root, 'poses_bounds.npy'), poses_bounds)
  return root


if __name__ == '__main__':
  if len(sys.argv) < 2:
    sys.exit(__doc__)
  if sys.argv[1] == '--llff':
    if len(sys.argv) < 3:
      sys.exit(__doc__)
    sizes = [int(a) for a in sys.argv[3:7]]
    make_llff_scene(sys.argv[2], *sizes)
    print(f'wrote analytic forward-facing sphere scene to {sys.argv[2]}')
  else:
    sizes = [int(a) for a in sys.argv[2:5]]
    make_scene(sys.argv[1], *sizes)
    print(f'wrote analytic sphere scene to {sys.argv[1]}')
