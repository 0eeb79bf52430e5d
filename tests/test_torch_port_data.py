"""The port's host data path against the JAX package, on the CPU.

- Image reading through Pillow (palette and 1-bit PNGs too), and the PNG
  codec of refnerf_tpu_torch.utils.io that reads without it, against
  Pillow: files that Pillow wrote (8-bit grey, grey with alpha, RGB and
  RGBA, 16-bit grey), rows filtered with each of the five filter types,
  16-bit colour, and the writer read back by Pillow; the other formats
  through Pillow, and the error when Pillow is absent; save_img_u8 and
  save_img_f32 against JAX's.
- COLMAP: binary and text models written here, read by both packages.
- Every loader (blender, llff, rffr, tat_nerfpp, tat_fvs, dtu) on scenes the
  tests write themselves: the images bit for bit, the cameras within 1e-6,
  and the train batches of the same seed and batch index bit-identical to
  JAX's (Pixels, and rgb), `seek` included; rays cast on the host (eval
  splits, or without cast_rays_in_train_step) within 1e-5.
- The pipeline: ThreadedSampler relays errors and exhaustion,
  training_batches yields the dataset's batches in order, sampled on the
  caller's thread (its default) or on a sampler thread.
- The slice: two train steps of a small cut of configs/blender_refnerf.gin
  from a scene on disk, with Pixels cast inside the step, against JAX
  make_train_step with its raycast_fn (tolerances as
  tests/test_torch_port_train.py's train-step test).
"""

import dataclasses
import io
import json
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from refnerf_tpu import configs as jconfigs
from refnerf_tpu.cameras import camera_utils as jcu
from refnerf_tpu.data import colmap as jcolmap
from refnerf_tpu.data import datasets as jdatasets
from refnerf_tpu.models import construct as jconstruct
from refnerf_tpu.train import step as jstep
from refnerf_tpu.utils import io as jio
from refnerf_tpu_torch import configs
from refnerf_tpu_torch import convert
from refnerf_tpu_torch.cameras import camera_utils as cu
from refnerf_tpu_torch.cameras import rays as rays_lib
from refnerf_tpu_torch.data import colmap
from refnerf_tpu_torch.data import datasets
from refnerf_tpu_torch.data import prefetch
from refnerf_tpu_torch.models import construct
from refnerf_tpu_torch.train import step as step_lib
from refnerf_tpu_torch.utils import io as io_lib

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIN = os.path.join(REPO, 'configs', 'blender_refnerf.gin')
RAY_TOL = 1e-5
POSE_TOL = 1e-6


# ----------------------------------------------------------------- PNG


def _structured(shape, dtype, seed):
  """Smooth gradients with noise: Pillow's adaptive filter picks several
  filter types for such rows."""
  rng = np.random.default_rng(seed)
  top = np.iinfo(dtype).max
  h, w = shape[:2]
  ramp = (np.arange(h)[:, None] * 3 + np.arange(w)[None, :] * 5)
  img = ramp.reshape(h, w, *([1] * (len(shape) - 2))) * (top // 97)
  img = img + rng.integers(0, top // 16, shape)
  return (img % (top + 1)).astype(dtype)


PILLOW_MODES = {'L': ((13, 17), np.uint8), 'LA': ((13, 17, 2), np.uint8),
                'RGB': ((13, 17, 3), np.uint8),
                'RGBA': ((13, 17, 4), np.uint8),
                'I;16': ((13, 17), np.uint16)}


@pytest.mark.parametrize('mode', sorted(PILLOW_MODES))
def test_png_reader_matches_pillow_on_files_pillow_wrote(tmp_path, mode):
  shape, dtype = PILLOW_MODES[mode]
  img = _structured(shape, dtype, 0)
  pth = str(tmp_path / 'a.png')
  Image.fromarray(img, mode).save(pth)
  want = np.array(Image.open(pth))
  with open(pth, 'rb') as f:
    got = io_lib.decode_png(f.read())
  assert got.dtype == want.dtype and got.shape == want.shape
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(io_lib.load_img(pth), jio.load_img(pth))


@pytest.mark.parametrize('mode', sorted(PILLOW_MODES) + ['P', '1'])
def test_images_read_through_pillow_and_the_codec_without_it(
    tmp_path, monkeypatch, mode):
  # With Pillow, read_image is Pillow's reading, as the JAX package's, also
  # for the palette and 1-bit PNGs that the codec does not read. Without
  # it, the codec reads the PNGs it knows and names Pillow for the others.
  shape, dtype = PILLOW_MODES.get(mode, ((13, 17), np.uint8))
  img = _structured(shape, dtype, 5)
  pth = str(tmp_path / 'a.png')
  if mode in ('P', '1'):
    Image.fromarray(img, 'L').convert(mode).save(pth)
  else:
    Image.fromarray(img, mode).save(pth)
  want = np.array(Image.open(pth))
  got = io_lib.read_image(pth)
  assert got.dtype == want.dtype and got.shape == want.shape
  np.testing.assert_array_equal(got, want)
  np.testing.assert_array_equal(io_lib.load_img(pth), jio.load_img(pth))
  monkeypatch.setitem(sys.modules, 'PIL', None)
  monkeypatch.setitem(sys.modules, 'PIL.Image', None)
  if mode in ('P', '1'):
    with pytest.raises(ValueError, match='Pillow reads it'):
      io_lib.read_image(pth)
  else:
    np.testing.assert_array_equal(io_lib.read_image(pth), want)


def _filter_row(kind, cur, prev, bpp):
  """PNG filter `kind` of one row of bytes (the encoder's side)."""
  out = bytearray(len(cur))
  for i in range(len(cur)):
    a = cur[i - bpp] if i >= bpp else 0
    b = prev[i]
    c = prev[i - bpp] if i >= bpp else 0
    if kind == 0:
      pred = 0
    elif kind == 1:
      pred = a
    elif kind == 2:
      pred = b
    elif kind == 3:
      pred = (a + b) // 2
    else:
      p = a + b - c
      pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
      pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
    out[i] = (cur[i] - pred) % 256
  return bytes(out)


@pytest.mark.parametrize('channels,depth', [(1, 8), (3, 8), (4, 8), (1, 16),
                                            (4, 16)])
def test_png_reader_undoes_every_filter_type(channels, depth):
  # Row y is filtered with type y % 5, so each type follows each other.
  import struct
  import zlib
  dtype = np.uint8 if depth == 8 else np.uint16
  img = _structured((11, 9, channels), dtype, 1)
  rows = img.astype(img.dtype.newbyteorder('>')).reshape(11, -1).view(np.uint8)
  bpp = channels * depth // 8
  prev, raw = bytes(rows.shape[1]), b''
  for y in range(11):
    cur = rows[y].tobytes()
    raw += bytes([y % 5]) + _filter_row(y % 5, cur, prev, bpp)
    prev = cur
  color = {1: 0, 3: 2, 4: 6}[channels]
  chunk = lambda k, d: (struct.pack('>I', len(d)) + k + d +
                        struct.pack('>I', zlib.crc32(k + d) & 0xFFFFFFFF))
  png = (b'\x89PNG\r\n\x1a\n' +
         chunk(b'IHDR', struct.pack('>IIBBBBB', 9, 11, depth, color, 0, 0, 0))
         + chunk(b'IDAT', zlib.compress(raw)) + chunk(b'IEND', b''))
  got = io_lib.decode_png(png)
  want = np.array(Image.open(io.BytesIO(png)))
  np.testing.assert_array_equal(got, want)
  if depth == 8 or channels == 1:
    np.testing.assert_array_equal(got.reshape(img.shape), img)
  else:  # 16-bit colour reads as its high bytes, as Pillow reads it.
    np.testing.assert_array_equal(got, (img >> 8).astype(np.uint8))


@pytest.mark.parametrize('mode', sorted(PILLOW_MODES))
def test_png_writer_is_read_back_by_pillow(tmp_path, mode):
  shape, dtype = PILLOW_MODES[mode]
  img = _structured(shape, dtype, 2)
  png = io_lib.encode_png(img)
  np.testing.assert_array_equal(np.array(Image.open(io.BytesIO(png))), img)
  np.testing.assert_array_equal(io_lib.decode_png(png), img)


def test_other_formats_go_through_pillow(tmp_path, monkeypatch):
  img = _structured((8, 8, 3), np.uint8, 3)
  pth = str(tmp_path / 'a.jpg')
  Image.fromarray(img).save(pth)
  np.testing.assert_array_equal(io_lib.load_img(pth), jio.load_img(pth))
  monkeypatch.setitem(sys.modules, 'PIL', None)
  with pytest.raises(ImportError, match='a.jpg'):
    io_lib.load_img(pth)
  png = str(tmp_path / 'a.png')
  io_lib.save_img_u8(img / 255.0, png)  # PNG needs no Pillow
  np.testing.assert_array_equal(io_lib.read_image(png), img)


def test_saved_images_match_jax(tmp_path):
  rng = np.random.default_rng(4)
  img = rng.uniform(-0.1, 1.1, (6, 7, 3)).astype(np.float32)
  mask = rng.uniform(0, 1, (6, 7)).astype(np.float32)
  for args in ((img,), (img[..., 0], mask), (img[..., 0],)):
    jio.save_img_u8(*args[:1], str(tmp_path / 'j.png'), *args[1:])
    io_lib.save_img_u8(*args[:1], str(tmp_path / 'p.png'), *args[1:])
    np.testing.assert_array_equal(io_lib.read_image(str(tmp_path / 'p.png')),
                                  np.array(Image.open(tmp_path / 'j.png')))
  jio.save_img_f32(mask, str(tmp_path / 'j.tiff'))
  io_lib.save_img_f32(mask, str(tmp_path / 'p.tiff'))
  np.testing.assert_array_equal(io_lib.load_img(str(tmp_path / 'p.tiff')),
                                jio.load_img(str(tmp_path / 'j.tiff')))


# ----------------------------------------------------------------- COLMAP


def _quat(r):
  w = np.sqrt(max(0, 1 + r[0, 0] + r[1, 1] + r[2, 2])) / 2
  return np.array([w, (r[2, 1] - r[1, 2]) / (4 * w),
                   (r[0, 2] - r[2, 0]) / (4 * w), (r[1, 0] - r[0, 1]) / (4 * w)])


MODEL_PARAMS = {
    'SIMPLE_PINHOLE': [20.0, 8.0, 6.0],
    'PINHOLE': [20.0, 21.0, 8.0, 6.0],
    'SIMPLE_RADIAL': [20.0, 8.0, 6.0, 0.01],
    'RADIAL': [20.0, 8.0, 6.0, 0.01, -0.002],
    'OPENCV': [20.0, 21.0, 8.0, 6.0, 0.01, -0.002, 0.001, 0.0005],
    'OPENCV_FISHEYE': [20.0, 21.0, 8.0, 6.0, 0.01, -0.002, 0.001, 0.0005],
}


def _colmap_model(lib, model, n=4, seed=0):
  rng = np.random.default_rng(seed)
  cams = {1: lib.Camera(1, model, 16, 12, np.array(MODEL_PARAMS[model]))}
  images = {}
  for i in range(n):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q if np.linalg.det(q) > 0 else -q
    images[i + 1] = lib.ImagePose(i + 1, _quat(q), rng.normal(size=3), 1,
                                  f'img_{i:02d}.png')
  return cams, images


def _same_scene(got, want):
  names, poses, pixtocam, params, camtype = got
  assert names == want[0] and camtype == want[4] and params == want[3]
  np.testing.assert_allclose(poses, want[1], rtol=POSE_TOL, atol=POSE_TOL)
  np.testing.assert_allclose(pixtocam, want[2], rtol=POSE_TOL, atol=POSE_TOL)


@pytest.mark.parametrize('model', sorted(MODEL_PARAMS))
def test_colmap_binary_round_trip_matches_jax(tmp_path, model):
  d = str(tmp_path / 'sparse')
  colmap.write_test_model(d, *_colmap_model(colmap, model))
  cams, images = _colmap_model(colmap, model)
  got = colmap.SceneReconstruction(d).load()
  want = jcolmap.SceneReconstruction(d).load()
  for k, im in images.items():
    np.testing.assert_array_equal(got.images[k].qvec, im.qvec)
    np.testing.assert_array_equal(got.images[k].tvec, im.tvec)
    assert got.images[k].name == want.images[k].name == im.name
  np.testing.assert_array_equal(got.cameras[1].params, cams[1].params)
  _same_scene(colmap.load_scene(d), jcolmap.load_scene(d))


def test_colmap_text_round_trip_matches_jax(tmp_path):
  cams, images = _colmap_model(colmap, 'OPENCV', seed=1)
  cam = cams[1]
  with open(tmp_path / 'cameras.txt', 'w') as f:
    f.write('# Camera list\n')
    f.write(f'1 {cam.model} {cam.width} {cam.height} '
            + ' '.join(repr(float(p)) for p in cam.params) + '\n')
  with open(tmp_path / 'images.txt', 'w') as f:
    f.write('# Image list with two lines of data per image\n')
    for k, im in images.items():
      f.write(f'{k} ' + ' '.join(repr(float(v)) for v in im.qvec) + ' '
              + ' '.join(repr(float(v)) for v in im.tvec) + f' 1 {im.name}\n')
      # The second image has no 2D points: an empty line.
      f.write('' if k == 2 else '1.0 2.0 -1 3.0 4.0 7\n')
      f.write('\n' if k == 2 else '')
  got = colmap.read_images_txt(str(tmp_path / 'images.txt'))
  assert set(got) == set(images)
  for k, im in images.items():
    np.testing.assert_array_equal(got[k].qvec, im.qvec)
    assert got[k].name == im.name
  np.testing.assert_array_equal(
      colmap.read_cameras_txt(str(tmp_path / 'cameras.txt'))[1].params,
      cam.params)
  _same_scene(colmap.load_scene(str(tmp_path)),
              jcolmap.load_scene(str(tmp_path)))


# ----------------------------------------------------------------- scenes


def _save(pth, img):
  Image.fromarray(img).save(pth)


def _blender_scene(root, res=16, n=(4, 3)):
  rng = np.random.RandomState(0)
  for split, count in zip(('train', 'test'), n):
    frames = []
    for i in range(count):
      theta = 2 * np.pi * i / count + (0.3 if split == 'test' else 0.0)
      pos = np.array([4 * np.cos(theta), 4 * np.sin(theta), 0.5])
      c2w = np.eye(4)
      c2w[:3, :4] = jcu.viewmatrix(pos, np.array([0.0, 0.0, 1.0]), pos)
      name = f'r_{split}_{i}'
      img = rng.uniform(0, 255, (res, res, 4)).astype(np.uint8)
      img[..., 3] = np.where(rng.uniform(size=(res, res)) > 0.3, 255, 0)
      _save(os.path.join(root, name + '.png'), img)
      frames.append({'file_path': name, 'transform_matrix': c2w.tolist()})
    with open(os.path.join(root, f'transforms_{split}.json'), 'w') as f:
      json.dump({'camera_angle_x': 0.6911, 'frames': frames}, f)
  return root


def _llff_scene(root, n=10, res=16, ring=False):
  """A COLMAP capture: cameras along x looking down +z (forward-facing), or
  on a ring looking at the origin (a 360 capture)."""
  rng = np.random.RandomState(0)
  img_dir = os.path.join(root, 'images')
  os.makedirs(img_dir)
  cams = {1: colmap.Camera(1, 'SIMPLE_RADIAL', res, res,
                           np.array([float(res), res / 2, res / 2, 0.001]))}
  images = {}
  for i in range(n):
    if ring:
      theta = 2 * np.pi * i / n
      pos = np.array([4 * np.cos(theta), 4 * np.sin(theta),
                      0.3 + 0.1 * rng.randn()])
      z = -pos / np.linalg.norm(pos)   # COLMAP: the camera looks down +z
      x = np.cross(z, [0.0, 0.0, 1.0])
      x /= np.linalg.norm(x)
      c2w_r = np.stack([x, np.cross(z, x), z], axis=1)
    else:
      pos, c2w_r = np.array([0.1 * i, 0.02 * rng.randn(), 4.0]), np.eye(3)
    images[i + 1] = colmap.ImagePose(i + 1, _quat(c2w_r.T),
                                     -c2w_r.T @ pos, 1, f'img_{i:02d}.png')
    _save(os.path.join(img_dir, f'img_{i:02d}.png'),
          rng.randint(0, 255, (res, res, 3)).astype(np.uint8))
  colmap.write_test_model(os.path.join(root, 'sparse', '0'), cams, images)
  np.save(os.path.join(root, 'poses_bounds.npy'), np.concatenate(
      [rng.randn(n, 15), np.tile([1.0, 10.0], (n, 1))], -1))
  return root


def _tat_nerfpp_scene(root, n=6, res=16):
  rng = np.random.RandomState(0)
  for split in ('train', 'test'):
    for sub in ('rgb', 'pose', 'intrinsics'):
      os.makedirs(os.path.join(root, split, sub))
    for i in range(n):
      _save(os.path.join(root, split, 'rgb', f'{i:04d}.png'),
            rng.randint(0, 255, (res, res, 3)).astype(np.uint8))
      pose = np.eye(4)
      pose[:3, 3] = [0.2 * i, 0.0, 4.0]
      np.savetxt(os.path.join(root, split, 'pose', f'{i:04d}.txt'),
                 pose.reshape(-1)[None])
      k = np.eye(4)
      k[0, 0] = k[1, 1] = float(res)
      k[0, 2] = k[1, 2] = res / 2
      np.savetxt(os.path.join(root, split, 'intrinsics', f'{i:04d}.txt'),
                 k.reshape(-1)[None])
  return root


def _tat_fvs_scene(root, n=6, res=16):
  rng = np.random.RandomState(1)
  base = os.path.join(root, 'dense', 'ibr3d_pw_0.25')
  os.makedirs(base)
  ks, rs, ts = [], [], []
  for i in range(n):
    _save(os.path.join(base, f'im_{i:08d}.png'),
          rng.randint(0, 255, (res, res, 3)).astype(np.uint8))
    k = np.eye(3) * res
    k[2, 2] = 1
    k[0, 2] = k[1, 2] = res / 2
    ks.append(k)
    q, _ = np.linalg.qr(rng.randn(3, 3))
    rs.append(q if np.linalg.det(q) > 0 else -q)
    ts.append(rng.randn(3) * 0.1 + [0, 0, 4.0])
  for name, v in (('Ks', ks), ('Rs', rs), ('ts', ts)):
    np.save(os.path.join(base, f'{name}.npy'), np.stack(v))
  return root


def _dtu_scene(root, n=4, res=16):
  rng = np.random.RandomState(2)
  scan_dir = os.path.join(root, 'mvs', 'scan1')
  cal_dir = os.path.join(root, 'cal18')
  os.makedirs(scan_dir)
  os.makedirs(cal_dir)
  for i in range(1, n + 1):
    _save(os.path.join(scan_dir, f'rect_{i:03d}_2_r5000.png'),
          rng.randint(0, 255, (res, res, 3)).astype(np.uint8))
    for j in range(7):  # 8 files per view (the loader counts files // 8)
      with open(os.path.join(scan_dir, f'rect_{i:03d}_aux{j}.txt'), 'w') as f:
        f.write('x')
    k = np.array([[res, 0, res / 2], [0, res, res / 2], [0, 0, 1.0]])
    q, _ = np.linalg.qr(rng.randn(3, 3))
    q = q if np.linalg.det(q) > 0 else -q
    c = rng.randn(3) * 0.2 + [0, 0, 4.0]
    np.savetxt(os.path.join(cal_dir, f'pos_{i:03d}.txt'),
               k @ np.concatenate([q, (-q @ c)[:, None]], 1))
  return scan_dir


SCENES = {'blender': _blender_scene, 'llff': _llff_scene,
          'llff_ring': lambda root: _llff_scene(root, ring=True),
          'tat_nerfpp': _tat_nerfpp_scene, 'tat_fvs': _tat_fvs_scene,
          'dtu': _dtu_scene}


@pytest.fixture(scope='module')
def scenes(tmp_path_factory):
  out = {}
  for name, make in SCENES.items():
    root = tmp_path_factory.mktemp(name)
    out[name] = make(str(root / 'scene') if name != 'blender' else str(root))
  return out


# (scene, Config fields) of each loader case.
LOADER_CASES = {
    'blender_all_images': ('blender', dict(batching='all_images')),
    'blender_single_image': ('blender', dict(batching='single_image')),
    'blender_patches': ('blender', dict(patch_size=3, batch_size=18)),
    'blender_debug': ('blender', dict(dataset_debug_mode=True,
                                      patch_size=2, batch_size=16)),
    'blender_host_rays': ('blender', dict(cast_rays_in_train_step=False,
                                          patch_size=2, batch_size=16)),
    'blender_factor_2': ('blender', dict(factor=2, n_input_views=3)),
    'llff_forward_facing': ('llff', dict(forward_facing=True, llffhold=4,
                                         near=0.0, far=1.0)),
    'llff_ndc_host_rays': ('llff', dict(forward_facing=True, llffhold=4,
                                        near=0.0, far=1.0, patch_size=2,
                                        batch_size=16,
                                        cast_rays_in_train_step=False)),
    'llff_360': ('llff_ring', dict(llffhold=4, n_input_views=4,
                                   render_path_frames=9)),
    'llff_all_images': ('llff_ring', dict(
        llff_use_all_images_for_training=True, batching='single_image',
        z_variation=0.5, z_phase=0.25)),
    'llff_render_path': ('llff_ring', dict(render_path=True,
                                           render_path_frames=6,
                                           cast_rays_in_train_step=False)),
    'rffr_factor_2': ('llff', dict(dataset_loader='rffr', factor=2,
                                   forward_facing=True, llffhold=4)),
    'tat_nerfpp': ('tat_nerfpp', dict()),
    'tat_fvs': ('tat_fvs', dict(llffhold=3)),
    'dtu': ('dtu', dict(dtuhold=2, cast_rays_in_train_step=False)),
}


def _configs(scene, fields):
  fields = {'dataset_loader': scene.split('_ring')[0],
            'batch_size': 24, 'factor': 0, **fields}
  j, p = jconfigs.Config(), configs.Config()
  for k, v in fields.items():
    setattr(j, k, v)
    setattr(p, k, v)
  return j, p


def _same_batch(got, want, exact_rays):
  assert type(got.rays).__name__ == type(want.rays).__name__
  for f in dataclasses.fields(got.rays):
    a = getattr(got.rays, f.name).numpy()
    b = np.asarray(getattr(want.rays, f.name))
    assert a.shape == b.shape and a.dtype == b.dtype, f.name
    if exact_rays or f.name in ('lossmult', 'near', 'far', 'cam_idx'):
      np.testing.assert_array_equal(a, b, err_msg=f.name)
    else:
      np.testing.assert_allclose(a, b, rtol=RAY_TOL, atol=RAY_TOL,
                                 err_msg=f.name)
  for k in ('rgb', 'disps', 'normals', 'alphas'):
    a, b = getattr(got, k), getattr(want, k)
    assert (a is None) == (b is None), k
    if a is not None:
      np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)


@pytest.mark.parametrize('case', sorted(LOADER_CASES))
def test_loader_matches_jax(scenes, case):
  scene, fields = LOADER_CASES[case]
  jconfig, config = _configs(scene, fields)
  for split in ('train', 'test'):
    want = jdatasets.load_dataset(split, scenes[scene], jconfig)
    got = datasets.load_dataset(split, scenes[scene], config)
    assert (got.size, got.height, got.width) == (want.size, want.height,
                                                 want.width)
    if want.images is None:
      assert got.images is None
    else:
      np.testing.assert_array_equal(got.images, want.images)
    for a, b in zip(got.cameras, want.cameras):
      if isinstance(b, np.ndarray):
        np.testing.assert_allclose(a, b, rtol=POSE_TOL, atol=POSE_TOL)
      else:
        assert a == b
    assert got.camtype.value == want.camtype.value
    if split == 'train':
      # Batch indices 0, 1, then 7 and 8 after seek(7).
      for i in range(4):
        if i == 2:
          got.seek(7)
          want.seek(7)
        _same_batch(next(got), next(want),
                    exact_rays=config.cast_rays_in_train_step)
    else:
      _same_batch(next(got), next(want), exact_rays=False)
      _same_batch(got.generate_ray_batch(want.size - 1),
                  want.generate_ray_batch(want.size - 1), exact_rays=False)


def test_loader_device_cameras_cast_the_host_rays(scenes):
  # The cameras the train step gets cast Pixels as the host casts them.
  _, config = _configs('llff', dict(forward_facing=True, llffhold=4,
                                    near=0.0, far=1.0))
  ds = datasets.load_dataset('train', scenes['llff'], config)
  batch = next(ds)
  cameras = ds.device_cameras('cpu')
  assert all(t.dtype == torch.float32 for t in cameras if torch.is_tensor(t))
  got = cu.cast_ray_batch(cameras, batch.rays, ds.camtype)
  want = cu.cast_ray_batch(ds.cameras, batch.rays, ds.camtype)
  for f in ('origins', 'directions', 'viewdirs', 'radii'):
    torch.testing.assert_close(getattr(got, f), getattr(want, f), rtol=0,
                               atol=0)


# ----------------------------------------------------------------- pipeline


def test_threaded_sampler_relays_errors_and_exhaustion():
  class Boom:
    def __init__(self):
      self.n = 0

    def __next__(self):
      self.n += 1
      if self.n > 2:
        raise RuntimeError('sampler exploded')
      return self.n

  s = prefetch.ThreadedSampler(Boom(), capacity=1)
  assert [next(s), next(s)] == [1, 2]
  with pytest.raises(RuntimeError, match='sampler exploded'):
    next(s)
  assert list(prefetch.ThreadedSampler(iter([10, 20]), capacity=4)) == [10,
                                                                        20]


@pytest.mark.parametrize('threaded', [False, True])
def test_training_batches_yield_the_datasets_batches(scenes, threaded):
  _, config = _configs('blender', dict(batching='all_images'))
  ds = datasets.load_dataset('train', scenes['blender'], config)
  ref = datasets.load_dataset('train', scenes['blender'], config)
  before = threading.active_count()
  batches = prefetch.training_batches(ds, device='cpu', threaded=threaded)
  for _ in range(5):
    _same_batch(next(batches), next(ref), exact_rays=True)
  batches.close()  # stops the sampler thread, if any
  deadline = time.time() + 10
  while threading.active_count() > before and time.time() < deadline:
    time.sleep(0.05)
  assert threading.active_count() <= before
  with pytest.raises(StopIteration):
    next(prefetch.device_prefetch(iter([]), device='cpu'))


# ----------------------------------------------------------------- the slice


SMALL = [
    'NerfMLP.net_depth = 4', 'NerfMLP.net_width = 32',
    'NerfMLP.net_depth_viewdirs = 4', 'NerfMLP.net_width_viewdirs = 32',
    'NerfMLP.skip_layer = 2', 'NerfMLP.bottleneck_width = 16',
    'Model.num_prop_samples = 16', 'Model.num_nerf_samples = 16',
    "NerfMLP.fused_trunk = 'on'", 'Config.batch_size = 12',
]


def test_train_step_from_a_scene_matches_jax(scenes):
  # Two steps of the small flagship cut from the blender scene, the rays
  # cast inside each step from Pixels (the gin's own batching
  # 'single_image' and cast_rays_in_train_step). Tolerances as
  # test_torch_port_train.py's test_train_step_matches_jax: the loss terms
  # and psnrs 1e-5 relative; the parameters 2e-2 of each one's largest move.
  bindings = SMALL + [f"Config.data_dir = '{scenes['blender']}'"]
  jconfig, jgin = jconfigs.parse([GIN], bindings)
  jmodel = jconstruct.construct_model(jconfig, jgin)
  params = jax.device_get(jconstruct.init_params(jax.random.PRNGKey(0),
                                                 jmodel))
  jds = jdatasets.load_dataset('train', jconfig.data_dir, jconfig)
  jcameras = tuple(None if a is None else
                   (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
                   for a in jds.cameras)
  jtrain = jax.jit(jstep.make_train_step(
      jmodel, jconfig,
      lambda cams, pix: jcu.cast_ray_batch(cams, pix, jds.camtype)))
  jstate = jstep.create_train_state(jconfig, jmodel, params)

  config, gin = configs.parse([GIN], bindings)
  model = construct.construct_model(config, gin, 'cpu')
  convert.load_jax_params(model, params)
  ds = datasets.load_dataset('train', config.data_dir, config)
  assert config.cast_rays_in_train_step and config.batching == 'single_image'
  cameras = ds.device_cameras('cpu')
  train = step_lib.make_train_step(
      model, config, lambda cams, pix: cu.cast_ray_batch(cams, pix,
                                                         ds.camtype))
  state = step_lib.create_train_state(config, model)
  before = {k: v.detach().clone().numpy() for k, v in state.params().items()}
  for step in (1, 2):
    jbatch, batch = next(jds), next(ds)
    assert isinstance(batch.rays, rays_lib.Pixels)
    jstate, jstats = jtrain(jstate, jbatch, jcameras)
    state, stats = train(state, batch, cameras)
    assert set(stats['losses']) == set(jstats['losses'])
    for k in stats['losses']:
      np.testing.assert_allclose(float(stats['losses'][k]),
                                 float(jstats['losses'][k]), rtol=1e-5)
    np.testing.assert_allclose(float(stats['psnr']), float(jstats['psnr']),
                               rtol=1e-5)
    jparams = {k: v.numpy() for k, v in convert.params_to_state_dict(
        jax.device_get(jstate.params)).items()}
    for k, p in state.params().items():
      moved = max(1e-12, float(np.abs(jparams[k] - before[k]).max()))
      np.testing.assert_allclose(p.detach().numpy(), jparams[k], rtol=0,
                                 atol=2e-2 * moved, err_msg=k)
  with pytest.raises(ValueError, match='raycast_fn'):
    step_lib.make_train_step(model, config)(state, next(ds), cameras)


def test_pixels_and_host_rays_give_the_same_step(scenes):
  # The same batch, cast in the step from Pixels or on the host, gives the
  # same loss and gradients (float32, 1e-6 relative).
  bindings = SMALL + [f"Config.data_dir = '{scenes['blender']}'"]
  config, gin = configs.parse([GIN], bindings)
  model = construct.construct_model(config, gin, 'cpu')
  ds = datasets.load_dataset('train', config.data_dir, config)
  host = datasets.load_dataset('train', config.data_dir, dataclasses.replace(
      config, cast_rays_in_train_step=False))
  train = step_lib.make_train_step(
      model, config, lambda cams, pix: cu.cast_ray_batch(cams, pix,
                                                         ds.camtype))
  state = step_lib.create_train_state(config, model)
  loss_p, _, grads_p = train.loss_and_grads(state, next(ds),
                                            ds.device_cameras('cpu'))
  loss_h, _, grads_h = train.loss_and_grads(state, next(host))
  np.testing.assert_allclose(float(loss_p), float(loss_h), rtol=1e-6)
  for k, g in grads_p.items():
    torch.testing.assert_close(g, grads_h[k], rtol=1e-6, atol=1e-9)


# The Config fields the data and eval paths now read.
DATA_FIELDS = '''
n_input_views dataset_loader dataset_debug_mode batching factor
load_alphabetical forward_facing render_path llffhold
llff_use_all_images_for_training dtuhold dtu_light_cond use_tiffs data_dir
cast_rays_in_train_step eval_quantize_metrics eval_crop_borders
render_path_frames z_variation z_phase render_path_file render_resolution
render_focal render_camtype render_spherical render_spline_keyframes
render_spline_n_interp render_spline_degree render_spline_smoothness
'''.split()


@pytest.mark.parametrize('bindings', [[], [
    "Config.dataset_loader = 'llff'", 'Config.factor = 4',
    'Config.forward_facing = True', "Config.batching = 'all_images'",
    'Config.render_resolution = (64, 48)', 'Config.z_variation = 0.5']])
def test_data_config_fields_match_jax(bindings):
  # Names and defaults as the JAX Config's, read (not left unread), and
  # parsed from the gin to the same values.
  jfields = {f.name: f for f in dataclasses.fields(jconfigs.Config)}
  fields = {f.name: f for f in dataclasses.fields(configs.Config)}
  for name in DATA_FIELDS:
    assert name in fields and name not in configs._UNREAD_FIELDS, name
    assert fields[name].default == jfields[name].default, name
  config, _ = configs.parse([GIN], bindings)
  jconfig, _ = jconfigs.parse([GIN], bindings)
  for name in DATA_FIELDS:
    assert getattr(config, name) == getattr(jconfig, name), name
  assert not set(config.unread) & set(DATA_FIELDS)
