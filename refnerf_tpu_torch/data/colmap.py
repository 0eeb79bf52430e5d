"""Self-contained COLMAP sparse-reconstruction reader (counterpart of
refnerf_tpu/data/colmap.py, numpy on the port's camera_utils).

A direct parser for COLMAP's documented binary/text formats
(cameras/images). Only the fields the NeRF pipeline needs are materialized;
3D points are skipped.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict

import numpy as np

from refnerf_tpu_torch.cameras import camera_utils

# COLMAP camera model ids -> (name, number of params).
CAMERA_MODELS = {
    0: ('SIMPLE_PINHOLE', 3),
    1: ('PINHOLE', 4),
    2: ('SIMPLE_RADIAL', 4),
    3: ('RADIAL', 5),
    4: ('OPENCV', 8),
    5: ('OPENCV_FISHEYE', 8),
    6: ('FULL_OPENCV', 12),
    7: ('FOV', 5),
    8: ('SIMPLE_RADIAL_FISHEYE', 4),
    9: ('RADIAL_FISHEYE', 5),
    10: ('THIN_PRISM_FISHEYE', 12),
}
_MODEL_NAME_TO_ID = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class Camera:
  camera_id: int
  model: str
  width: int
  height: int
  params: np.ndarray  # model-specific

  def _named(self):
    p = self.params
    if self.model == 'SIMPLE_PINHOLE':
      return dict(fx=p[0], fy=p[0], cx=p[1], cy=p[2])
    if self.model == 'PINHOLE':
      return dict(fx=p[0], fy=p[1], cx=p[2], cy=p[3])
    if self.model == 'SIMPLE_RADIAL':
      return dict(fx=p[0], fy=p[0], cx=p[1], cy=p[2], k1=p[3])
    if self.model == 'RADIAL':
      return dict(fx=p[0], fy=p[0], cx=p[1], cy=p[2], k1=p[3], k2=p[4])
    if self.model == 'OPENCV':
      return dict(fx=p[0], fy=p[1], cx=p[2], cy=p[3],
                  k1=p[4], k2=p[5], p1=p[6], p2=p[7])
    if self.model == 'OPENCV_FISHEYE':
      return dict(fx=p[0], fy=p[1], cx=p[2], cy=p[3],
                  k1=p[4], k2=p[5], k3=p[6], k4=p[7])
    raise ValueError(f'Unsupported COLMAP camera model {self.model}')

  def __getattr__(self, name):
    if name in ('fx', 'fy', 'cx', 'cy', 'k1', 'k2', 'k3', 'k4', 'p1', 'p2'):
      return float(self._named().get(name, 0.0))
    raise AttributeError(name)


@dataclasses.dataclass
class ImagePose:
  image_id: int
  qvec: np.ndarray    # [w, x, y, z]
  tvec: np.ndarray    # [3]
  camera_id: int
  name: str

  def rotmat(self) -> np.ndarray:
    """World-to-camera rotation from the unit quaternion."""
    return qvec2rotmat(self.qvec)


def qvec2rotmat(q) -> np.ndarray:
  """Rotation matrix of a [w, x, y, z] quaternion (COLMAP convention)."""
  w, x, y, z = q
  return np.array([
      [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
  ])


def _read(fmt, f):
  size = struct.calcsize(fmt)
  return struct.unpack(fmt, f.read(size))


def read_cameras_bin(path) -> Dict[int, Camera]:
  cameras = {}
  with open(path, 'rb') as f:
    (num,) = _read('<Q', f)
    for _ in range(num):
      camera_id, model_id, width, height = _read('<iiQQ', f)
      name, num_params = CAMERA_MODELS[model_id]
      params = np.array(_read(f'<{num_params}d', f))
      cameras[camera_id] = Camera(camera_id, name, int(width), int(height),
                                  params)
  return cameras


def read_images_bin(path) -> Dict[int, ImagePose]:
  images = {}
  with open(path, 'rb') as f:
    (num,) = _read('<Q', f)
    for _ in range(num):
      image_id, qw, qx, qy, qz, tx, ty, tz, camera_id = _read('<idddddddi', f)
      name = b''
      while True:
        c = f.read(1)
        if c == b'\x00':
          break
        name += c
      (num_points,) = _read('<Q', f)
      f.seek(num_points * 24, os.SEEK_CUR)  # skip (x, y, point3D_id) triples
      images[image_id] = ImagePose(
          image_id, np.array([qw, qx, qy, qz]), np.array([tx, ty, tz]),
          camera_id, name.decode('utf-8'))
  return images


def read_cameras_txt(path) -> Dict[int, Camera]:
  cameras = {}
  with open(path) as f:
    for line in f:
      line = line.strip()
      if not line or line.startswith('#'):
        continue
      parts = line.split()
      camera_id, model = int(parts[0]), parts[1]
      width, height = int(parts[2]), int(parts[3])
      params = np.array([float(x) for x in parts[4:]])
      cameras[camera_id] = Camera(camera_id, model, width, height, params)
  return cameras


def read_images_txt(path) -> Dict[int, ImagePose]:
  images = {}
  with open(path) as f:
    # Each image uses two lines: pose, then its 2D points - which may be
    # EMPTY for an image with no registered points. Only comments are
    # filtered; dropping blank lines would misalign the two-line pairing
    # and silently skip (or mis-parse) images.
    lines = [l.strip() for l in f if not l.strip().startswith('#')]
  while lines and not lines[-1]:
    lines.pop()  # trailing newline(s) only
  for line in lines[::2]:
    parts = line.split()
    image_id = int(parts[0])
    qvec = np.array([float(x) for x in parts[1:5]])
    tvec = np.array([float(x) for x in parts[5:8]])
    camera_id = int(parts[8])
    name = parts[9]
    images[image_id] = ImagePose(image_id, qvec, tvec, camera_id, name)
  return images


class SceneReconstruction:
  """Cameras + image poses from a COLMAP sparse model directory."""

  def __init__(self, model_dir: str):
    self.model_dir = model_dir
    self.cameras: Dict[int, Camera] = {}
    self.images: Dict[int, ImagePose] = {}

  def load(self):
    d = self.model_dir
    if os.path.exists(os.path.join(d, 'cameras.bin')):
      self.cameras = read_cameras_bin(os.path.join(d, 'cameras.bin'))
      self.images = read_images_bin(os.path.join(d, 'images.bin'))
    elif os.path.exists(os.path.join(d, 'cameras.txt')):
      self.cameras = read_cameras_txt(os.path.join(d, 'cameras.txt'))
      self.images = read_images_txt(os.path.join(d, 'images.txt'))
    else:
      raise FileNotFoundError(f'No COLMAP model found in {d}')
    return self


def load_scene(model_dir: str):
  """Load a COLMAP model and postprocess into NeRF conventions.

  Returns (image_names, poses[N,3,4] camera-to-world in NeRF (right,up,back)
  axes, pixtocam[3,3], distortion dict or None, projection type string) -
  the same contract as the reference's NeRFSceneManager.process()
  (ref: datasets.py:57-152). Intrinsics are assumed shared across cameras.
  """
  scene = SceneReconstruction(model_dir).load()

  cam = scene.cameras[min(scene.cameras)]
  pixtocam = np.linalg.inv(np.asarray(
      camera_utils.intrinsic_matrix(cam.fx, cam.fy, cam.cx, cam.cy)))

  w2c_mats = []
  names = []
  bottom = np.array([[0, 0, 0, 1.0]])
  for k in sorted(scene.images):
    im = scene.images[k]
    w2c = np.concatenate(
        [np.concatenate([im.rotmat(), im.tvec.reshape(3, 1)], 1), bottom], 0)
    w2c_mats.append(w2c)
    names.append(im.name)
  w2c_mats = np.stack(w2c_mats, axis=0)
  poses = np.linalg.inv(w2c_mats)[:, :3, :4]

  # COLMAP (right, down, forward) -> NeRF (right, up, back).
  poses = poses @ np.diag([1, -1, -1, 1])

  model = cam.model
  if model in ('SIMPLE_PINHOLE', 'PINHOLE'):
    params = None
    camtype = 'perspective'
  elif model == 'SIMPLE_RADIAL':
    params = {'k1': cam.k1, 'k2': 0.0, 'k3': 0.0, 'p1': 0.0, 'p2': 0.0}
    camtype = 'perspective'
  elif model == 'RADIAL':
    params = {'k1': cam.k1, 'k2': cam.k2, 'k3': 0.0, 'p1': 0.0, 'p2': 0.0}
    camtype = 'perspective'
  elif model == 'OPENCV':
    params = {'k1': cam.k1, 'k2': cam.k2, 'k3': 0.0,
              'p1': cam.p1, 'p2': cam.p2}
    camtype = 'perspective'
  elif model == 'OPENCV_FISHEYE':
    params = {'k1': cam.k1, 'k2': cam.k2, 'k3': cam.k3, 'k4': cam.k4}
    camtype = 'fisheye'
  else:
    raise ValueError(f'Unsupported COLMAP camera model {model}')

  return names, poses, pixtocam, params, camtype


def write_test_model(model_dir: str, cameras: Dict[int, Camera],
                     images: Dict[int, ImagePose]):
  """Write a tiny binary COLMAP model (used by tests/fixtures)."""
  os.makedirs(model_dir, exist_ok=True)
  with open(os.path.join(model_dir, 'cameras.bin'), 'wb') as f:
    f.write(struct.pack('<Q', len(cameras)))
    for cam in cameras.values():
      mid = _MODEL_NAME_TO_ID[cam.model]
      f.write(struct.pack('<iiQQ', cam.camera_id, mid, cam.width, cam.height))
      f.write(struct.pack(f'<{len(cam.params)}d', *cam.params))
  with open(os.path.join(model_dir, 'images.bin'), 'wb') as f:
    f.write(struct.pack('<Q', len(images)))
    for im in images.values():
      f.write(struct.pack('<idddddddi', im.image_id, *im.qvec, *im.tvec,
                          im.camera_id))
      f.write(im.name.encode('utf-8') + b'\x00')
      f.write(struct.pack('<Q', 0))
