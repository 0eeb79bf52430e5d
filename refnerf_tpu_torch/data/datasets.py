"""Scene dataset loaders and host-side batch sampling (counterpart of
refnerf_tpu/data/datasets.py).

The loaders of the JAX package (blender, llff, rffr, tat_nerfpp, tat_fvs,
dtu) on numpy, with images read by the port's own PNG codec
(`utils/io.py`). Datasets are plain iterators of `Batch`es of CPU tensors:

  - The train split samples integer pixel and camera ids on the host, from a
    numpy generator keyed by (seed, batch index), so its batches are the JAX
    package's bit for bit. Under `Config.cast_rays_in_train_step` it ships
    `Pixels`, and the train step casts the rays on the device from
    `device_cameras()`; otherwise, and for every other split, rays are cast
    here on the CPU.
  - COLMAP poses come from `data/colmap.py`.
  - `data/prefetch.py` overlaps host sampling and the host-to-device copy
    with device compute.
"""

from __future__ import annotations

import abc
import json
import os
from os import path
from typing import Optional

import numpy as np
import torch

from refnerf_tpu_torch.cameras import camera_utils
from refnerf_tpu_torch.cameras import rays as rays_lib
from refnerf_tpu_torch.data import colmap
from refnerf_tpu_torch.ops import image as image_ops
from refnerf_tpu_torch.utils import io as io_lib

DataSplit = rays_lib.DataSplit
BatchingMethod = rays_lib.BatchingMethod


def load_dataset(split, train_dir, config):
  """Load a split of the dataset named by config.dataset_loader."""
  dataset_dict = {
      'blender': Blender,
      'llff': LLFF,
      'tat_nerfpp': TanksAndTemplesNerfPP,
      'tat_fvs': TanksAndTemplesFVS,
      'dtu': DTU,
      'rffr': RFFR,
  }
  return dataset_dict[config.dataset_loader](split, train_dir, config)


load_img = io_lib.load_img


def parallel_map(fn, items, max_workers=None):
  """Ordered map for the per-image startup sweep; threaded on multicore.

  zlib's inflate releases the GIL, so a dataset of hundreds of 800x800
  frames decodes in parallel on a multicore host; results preserve `items`
  order. On a single-CPU host threads only add GIL churn, so the worker
  count follows cpu_count and degrades to the plain serial loop.
  """
  import concurrent.futures
  items = list(items)
  if max_workers is None:
    max_workers = min(16, os.cpu_count() or 1)
  if len(items) <= 1 or max_workers <= 1:
    return [fn(x) for x in items]
  with concurrent.futures.ThreadPoolExecutor(max_workers) as pool:
    return list(pool.map(fn, items))


def downsample_np(img: np.ndarray, factor: int) -> np.ndarray:
  """Host-side area downsample (numpy twin of ops.image.downsample)."""
  sh = img.shape
  if not (sh[0] % factor == 0 and sh[1] % factor == 0):
    raise ValueError(f'Downsampling factor {factor} does not '
                     f'evenly divide image shape {sh[:2]}')
  img = img.reshape((sh[0] // factor, factor, sh[1] // factor, factor)
                    + sh[2:])
  return img.mean((1, 3))


def load_blender_posedata(data_dir, split=None):
  """Poses/intrinsics from instant-NGP style `transforms*.json`
  (ref: datasets.py:155-189)."""
  suffix = '' if split is None else f'_{split}'
  pose_file = path.join(data_dir, f'transforms{suffix}.json')
  with open(pose_file, 'r') as fp:
    meta = json.load(fp)
  names = []
  poses = []
  for frame in meta['frames']:
    filepath = os.path.join(data_dir, frame['file_path'])
    if os.path.exists(filepath):
      names.append(frame['file_path'].split('/')[-1])
      poses.append(np.array(frame['transform_matrix'], dtype=np.float32))
  poses = np.stack(poses, axis=0)

  w = meta['w']
  h = meta['h']
  cx = meta.get('cx', w / 2.0)
  cy = meta.get('cy', h / 2.0)
  # NOTE: the fallback must stay lazy - a dict.get default would evaluate
  # meta['camera_angle_*'] even when fl_x/fl_y are present, crashing on
  # valid instant-NGP json that has focals but no angles.
  fx = (meta['fl_x'] if 'fl_x' in meta
        else 0.5 * w / np.tan(0.5 * float(meta['camera_angle_x'])))
  fy = (meta['fl_y'] if 'fl_y' in meta
        else 0.5 * h / np.tan(0.5 * float(meta['camera_angle_y'])))
  pixtocam = np.linalg.inv(camera_utils.intrinsic_matrix(fx, fy, cx, cy))
  coeffs = ['k1', 'k2', 'p1', 'p2']
  if not any(c in meta for c in coeffs):
    params = None
  else:
    params = {c: float(meta.get(c, 0.0)) for c in coeffs}
  camtype = camera_utils.ProjectionType.PERSPECTIVE
  return names, poses, pixtocam, params, camtype


class BaseDataset(metaclass=abc.ABCMeta):
  """Base scene dataset: loads renderings, samples ray batches.

  Subclasses implement `_load_renderings(config)` and must set: images,
  camtoworlds, pixtocams, height, width, focal (and optionally disp/normal
  images, distortion_params, pixtocam_ndc).
  """

  def __init__(self, split, data_dir, config):
    self.config = config
    self._patch_size = max(config.patch_size, 1)
    self._batch_size = config.batch_size
    if self._patch_size ** 2 > self._batch_size:
      raise ValueError(f'Patch size {self._patch_size}^2 too large for '
                       f'per-process batch size {self._batch_size}')
    self._batching = BatchingMethod(config.batching)
    self._use_tiffs = config.use_tiffs
    self._load_disps = config.compute_disp_metrics
    self._load_normals = config.compute_normal_metrics
    self._val_camera_idx = 0
    self._test_camera_idx = 0
    self._cast_rays_in_train_step = config.cast_rays_in_train_step
    # Config.render_spherical is honored directly (the reference defines
    # the field, configs.py:163, but only ever sets spherical through
    # render_camtype='pano' - a latent dead flag there).
    self._render_spherical = bool(config.render_spherical)
    self._debug_mode = config.dataset_debug_mode
    # Train batches are a pure function of (seed, batch index): each draw
    # derives a fresh generator keyed by the global batch counter, so a
    # resumed run reproduces the exact batch sequence of an uninterrupted
    # one (seek() aligns the counter to the restored step). The reference
    # gets approximate resume from Lightning with a free-running RNG; the
    # stateless stream makes train(N)+resume(M) == train(N+M) exactly.
    self._seed = config.seed
    self._batch_index = 0

    self.split = DataSplit(split)
    self.data_dir = data_dir
    self.near = config.near
    self.far = config.far
    self.render_path = config.render_path
    self.distortion_params = None
    self.disp_images = None
    self.normal_images = None
    self.alphas = None
    self.poses = None
    self.pixtocam_ndc = None
    self.camtype = camera_utils.ProjectionType.PERSPECTIVE

    self.images: Optional[np.ndarray] = None
    self.camtoworlds: Optional[np.ndarray] = None
    self.pixtocams: Optional[np.ndarray] = None
    self.height: Optional[int] = None
    self.width: Optional[int] = None

    self._load_renderings(config)

    if self.render_path:
      if config.render_path_file is not None:
        with open(config.render_path_file, 'rb') as fp:
          self.camtoworlds = np.load(fp)
      if config.render_resolution is not None:
        self.width, self.height = config.render_resolution
      if config.render_focal is not None:
        self.focal = config.render_focal
      if config.render_camtype is not None:
        if config.render_camtype == 'pano':
          self._render_spherical = True
        else:
          self.camtype = camera_utils.ProjectionType(config.render_camtype)
      self.distortion_params = None
      self.pixtocams = camera_utils.get_pixtocam(self.focal, self.width,
                                                 self.height)

    self._n_examples = self.camtoworlds.shape[0]

    self.cameras = (self.pixtocams.astype(np.float32),
                    self.camtoworlds.astype(np.float32),
                    self.distortion_params,
                    self.pixtocam_ndc)

    self._next_fn = {
        DataSplit.TRAIN: self._next_train,
        DataSplit.VAL: self._next_val,
        DataSplit.TEST: self._next_test,
    }[self.split]

  def __iter__(self):
    return self

  def __next__(self) -> rays_lib.Batch:
    return self._next_fn()

  @property
  def size(self):
    return self._n_examples

  # For API parity with epoch-style consumers: batches per epoch per host.
  def __len__(self):
    if self.split == DataSplit.TRAIN:
      return (len(self.images) * self.images[0].shape[0] *
              self.images[0].shape[1] // self._batch_size)
    return self._n_examples

  @abc.abstractmethod
  def _load_renderings(self, config):
    ...

  def _make_ray_batch(self, pix_x_int, pix_y_int, cam_idx, lossmult=None):
    """Pixel ids (+ metadata) -> Batch of Pixels (fast path) or cast Rays."""
    broadcast_scalar = lambda x: np.broadcast_to(x, pix_x_int.shape)[..., None]
    ray_kwargs = {
        'lossmult': broadcast_scalar(np.float32(1.0)) if lossmult is None
                    else lossmult,
        'near': broadcast_scalar(np.float32(self.near)),
        'far': broadcast_scalar(np.float32(self.far)),
        'cam_idx': broadcast_scalar(cam_idx).astype(np.int32),
    }

    # CPU tensors of their own (copies: the broadcasts are views).
    t = lambda a: torch.from_numpy(np.array(a))
    pixels = rays_lib.Pixels(t(pix_x_int.astype(np.int32)),
                             t(pix_y_int.astype(np.int32)),
                             **{k: t(v) for k, v in ray_kwargs.items()})
    if self._cast_rays_in_train_step and self.split == DataSplit.TRAIN:
      # Ship pixel ids; the train step casts the rays on the device.
      rays = pixels
    else:
      # Full-image / eval path: cast here, on the CPU.
      rays = camera_utils.cast_ray_batch(self.cameras, pixels, self.camtype)

    batch = {'rays': rays}
    if not self.render_path:
      batch['rgb'] = t(self.images[cam_idx, pix_y_int, pix_x_int])
    if self._load_disps:
      batch['disps'] = t(self.disp_images[cam_idx, pix_y_int, pix_x_int])
    if self._load_normals:
      batch['normals'] = t(self.normal_images[cam_idx, pix_y_int, pix_x_int])
      batch['alphas'] = t(self.alphas[cam_idx, pix_y_int, pix_x_int])
    return rays_lib.Batch(**batch)

  def device_cameras(self, device='cuda'):
    """`cameras` with its arrays as float32 tensors on `device`: the train
    step's cameras when batches carry `Pixels`."""
    pixtocams, camtoworlds, distortion_params, pixtocam_ndc = self.cameras
    put = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return (put(pixtocams), put(camtoworlds), distortion_params,
            None if pixtocam_ndc is None else put(pixtocam_ndc))

  def seek(self, batch_index: int):
    """Position the train stream so the next batch is `batch_index` (the
    global step when batches are consumed one per step). Used on resume."""
    self._batch_index = int(batch_index)

  def _next_train(self) -> rays_lib.Batch:
    """Random ray/patch batch (ref: datasets.py:449-485)."""
    num_patches = self._batch_size // self._patch_size ** 2
    lower_border = 0
    upper_border = self._patch_size - 1

    if self._debug_mode:
      # Deterministic: first pixels of camera 0. The reference forgets the
      # patch offsets here (datasets.py:458-464), so its debug batches have
      # the wrong shape whenever patch_size > 1; keep determinism but make
      # the batch shape identical to the normal path's.
      xs = range(lower_border, self.width - upper_border)
      ys = range(lower_border, self.height - upper_border)
      pixels = np.meshgrid(xs, ys)
      pix_x_int = pixels[0].ravel()[:num_patches].reshape(-1, 1, 1)
      pix_y_int = pixels[1].ravel()[:num_patches].reshape(-1, 1, 1)
      patch_dx_int, patch_dy_int = camera_utils.pixel_coordinates(
          self._patch_size, self._patch_size)
      pix_x_int = pix_x_int + patch_dx_int
      pix_y_int = pix_y_int + patch_dy_int
      cam_idx = np.repeat(0, num_patches).reshape(-1, 1, 1)
    else:
      rng = np.random.default_rng(
          np.random.SeedSequence((self._seed, self._batch_index)))
      self._batch_index += 1
      pix_x_int = rng.integers(
          lower_border, self.width - upper_border, (num_patches, 1, 1))
      pix_y_int = rng.integers(
          lower_border, self.height - upper_border, (num_patches, 1, 1))
      patch_dx_int, patch_dy_int = camera_utils.pixel_coordinates(
          self._patch_size, self._patch_size)
      pix_x_int = pix_x_int + patch_dx_int
      pix_y_int = pix_y_int + patch_dy_int
      if self._batching == BatchingMethod.ALL_IMAGES:
        cam_idx = rng.integers(0, self._n_examples, (num_patches, 1, 1))
      else:
        cam_idx = rng.integers(0, self._n_examples, (1,))

    return self._make_ray_batch(pix_x_int, pix_y_int, cam_idx, lossmult=None)

  def generate_ray_batch(self, cam_idx: int) -> rays_lib.Batch:
    """All rays of one camera (full-image render batch)."""
    if self._render_spherical:
      camtoworld = self.camtoworlds[cam_idx]
      rays = camera_utils.cast_spherical_rays(
          camtoworld, self.height, self.width, self.near, self.far, 'cpu')
      return rays_lib.Batch(rays=rays)
    pix_x_int, pix_y_int = camera_utils.pixel_coordinates(
        self.width, self.height)
    return self._make_ray_batch(pix_x_int, pix_y_int, cam_idx)

  def _next_val(self) -> rays_lib.Batch:
    if self._debug_mode:
      cam_idx = 0
      self._val_camera_idx = 0
    else:
      cam_idx = self._val_camera_idx
      self._val_camera_idx = (self._val_camera_idx + 1) % self._n_examples
    return self.generate_ray_batch(cam_idx)

  def _next_test(self) -> rays_lib.Batch:
    cam_idx = self._test_camera_idx
    self._test_camera_idx = (self._test_camera_idx + 1) % self._n_examples
    return self.generate_ray_batch(cam_idx)


class Blender(BaseDataset):
  """Blender synthetic scenes: transforms_{split}.json + PNG/TIFF images."""

  def _load_renderings(self, config):
    if config.render_path:
      raise ValueError('render_path cannot be used for the blender dataset.')
    pose_file = path.join(self.data_dir,
                          f'transforms_{self.split.value}.json')
    with open(pose_file, 'r') as fp:
      meta = json.load(fp)
    def load_frame(frame):
      fprefix = os.path.join(self.data_dir, frame['file_path'])

      def get_img(f):
        img = load_img(fprefix + f)
        if config.factor > 1:
          img = downsample_np(img, config.factor)
        return img

      if self._use_tiffs:
        channels = [get_img(f'_{ch}.tiff') for ch in ['R', 'G', 'B', 'A']]
        image = image_ops.linear_to_srgb(
            torch.from_numpy(np.stack(channels, axis=-1))).numpy()
      else:
        image = get_img('.png') / 255.0
      disp = get_img('_disp.tiff') if self._load_disps else None
      normal = (get_img('_normal.png')[..., :3] * 2.0 / 255.0 - 1.0
                if self._load_normals else None)
      cam = np.array(frame['transform_matrix'], dtype=np.float32)
      return image, disp, normal, cam

    frames = parallel_map(load_frame, meta['frames'])
    images = [f[0] for f in frames]
    disp_images = [f[1] for f in frames]
    normal_images = [f[2] for f in frames]
    cams = [f[3] for f in frames]

    self.images = np.stack(images, axis=0)
    if self._load_disps:
      self.disp_images = np.stack(disp_images, axis=0)
    if self._load_normals:
      self.normal_images = np.stack(normal_images, axis=0)
      self.alphas = self.images[..., -1]

    # Composite onto a white background.
    rgb, alpha = self.images[..., :3], self.images[..., -1:]
    self.images = (rgb * alpha + (1.0 - alpha)).astype(np.float32)
    self.camtoworlds = np.stack(cams, axis=0)

    if self.split == DataSplit.TRAIN and config.n_input_views > 0:
      self.images = self.images[:config.n_input_views]
      self.camtoworlds = self.camtoworlds[:config.n_input_views]

    self.height, self.width = self.images.shape[1:3]
    self.focal = 0.5 * self.width / np.tan(
        0.5 * float(meta['camera_angle_x']))
    self.pixtocams = camera_utils.get_pixtocam(self.focal, self.width,
                                               self.height)


class _LLFFLike(BaseDataset):
  """Shared COLMAP-based loading for LLFF and RFFR
  (ref: datasets.py:584-838; the two reference classes are near-clones)."""

  # RFFR stores full-res images and downsamples in memory; LLFF reads
  # pre-downsampled `images_{factor}` directories.
  _downsample_in_memory = False

  def _load_renderings(self, config):
    factor = config.factor if config.factor > 1 else 1
    image_dir_suffix = (f'_{config.factor}'
                        if (config.factor > 1
                            and not self._downsample_in_memory) else '')

    colmap_dir = os.path.join(self.data_dir, 'sparse/0/')
    if os.path.exists(colmap_dir):
      names, poses, pixtocam, distortion_params, camtype_str = (
          colmap.load_scene(colmap_dir))
      camtype = camera_utils.ProjectionType(camtype_str)
    else:
      names, poses, pixtocam, distortion_params, camtype = (
          load_blender_posedata(self.data_dir))
    image_names = names

    # Keep results comparable with prior NeRF work: sort by filename.
    if config.load_alphabetical:
      inds = np.argsort(image_names)
      image_names = [image_names[i] for i in inds]
      poses = poses[inds]

    pixtocam = pixtocam @ np.diag([factor, factor, 1.0])
    self.pixtocams = pixtocam.astype(np.float32)
    self.focal = 1.0 / self.pixtocams[0, 0]
    self.distortion_params = distortion_params
    self.camtype = camtype

    colmap_image_dir = os.path.join(self.data_dir, 'images')
    image_dir = os.path.join(self.data_dir, 'images' + image_dir_suffix)
    for d in [image_dir, colmap_image_dir]:
      if not os.path.exists(d):
        raise ValueError(f'Image folder {d} does not exist.')
    # Map COLMAP image names onto (possibly differently-named) files.
    colmap_files = sorted(os.listdir(colmap_image_dir))
    image_files = sorted(os.listdir(image_dir))
    colmap_to_image = dict(zip(colmap_files, image_files))
    image_paths = [os.path.join(image_dir, colmap_to_image[f])
                   for f in image_names]
    if self._downsample_in_memory:
      def load_one(fname):
        img = load_img(fname) / 255.0
        return downsample_np(img, factor) if factor > 1 else img
      images = np.array(parallel_map(load_one, image_paths),
                        dtype=np.float32)
    else:
      images = np.stack(parallel_map(load_img, image_paths), axis=0) / 255.0
      images = images.astype(np.float32)

    posefile = os.path.join(self.data_dir, 'poses_bounds.npy')
    if os.path.exists(posefile):
      with open(posefile, 'rb') as fp:
        poses_arr = np.load(fp)
      bounds = poses_arr[:, -2:]
    else:
      bounds = np.array([0.01, 1.0])
    self.colmap_to_world_transform = np.eye(4)

    if config.forward_facing:
      # NDC projection uses the first camera's intrinsics.
      self.pixtocam_ndc = self.pixtocams.reshape(-1, 3, 3)[0]
      scale = 1.0 / (bounds.min() * 0.75)
      poses[:, :3, 3] *= scale
      self.colmap_to_world_transform = np.diag([scale] * 3 + [1])
      bounds = bounds * scale
      poses, transform = camera_utils.recenter_poses(poses)
      self.colmap_to_world_transform = (
          transform @ self.colmap_to_world_transform)
      self.render_poses = camera_utils.generate_spiral_path(
          poses, bounds, n_frames=config.render_path_frames)
    else:
      poses, transform = camera_utils.transform_poses_pca(poses)
      self.colmap_to_world_transform = transform
      if config.render_spline_keyframes is not None:
        self.spline_indices, self.render_poses = (
            camera_utils.create_render_spline_path(config, image_names,
                                                   poses))
      else:
        self.render_poses = camera_utils.generate_ellipse_path(
            poses, n_frames=config.render_path_frames,
            z_variation=config.z_variation, z_phase=config.z_phase)

    self.poses = poses

    all_indices = np.arange(images.shape[0])
    if config.llff_use_all_images_for_training:
      train_indices = all_indices
    else:
      train_indices = all_indices[all_indices % config.llffhold != 0]
    split_indices = {
        DataSplit.VAL: all_indices[all_indices % config.llffhold == 0],
        DataSplit.TEST: all_indices[all_indices % config.llffhold == 0],
        DataSplit.TRAIN: train_indices,
    }
    indices = split_indices[self.split]
    images = images[indices]
    poses = poses[indices]

    if (self.split == DataSplit.TRAIN and
        0 < config.n_input_views < images.shape[0]):
      idx_sub = [round(i) for i in
                 np.linspace(0, images.shape[0] - 1, config.n_input_views)]
      images = images[idx_sub]
      poses = poses[idx_sub]

    self.images = images
    self.camtoworlds = self.render_poses if config.render_path else poses
    self.height, self.width = images.shape[1:3]


class LLFF(_LLFFLike):
  """LLFF forward-facing / 360 COLMAP captures."""
  _downsample_in_memory = False


class RFFR(_LLFFLike):
  """Real Forward-Facing with Reflections captures."""
  _downsample_in_memory = True


class TanksAndTemplesNerfPP(BaseDataset):
  """Tanks and Temples, NeRF++ preprocessing (txt poses/intrinsics)."""

  def _load_renderings(self, config):
    split_str = 'camera_path' if config.render_path else self.split.value
    basedir = os.path.join(self.data_dir, split_str)

    def load_files(dirname, load_fn, shape=None):
      files = [
          os.path.join(basedir, dirname, f)
          for f in sorted(os.listdir(os.path.join(basedir, dirname)))]

      mats = np.array(parallel_map(load_fn, files))
      if shape is not None:
        mats = mats.reshape(mats.shape[:1] + shape)
      return mats

    poses = load_files('pose', np.loadtxt, (4, 4))
    # Flip Y/Z axes into the OpenGL frame.
    poses = np.matmul(poses, np.diag(np.array([1, -1, -1, 1])))

    intrinsics = load_files('intrinsics', np.loadtxt, (4, 4))

    if not config.render_path:
      images = load_files('rgb', io_lib.read_image) / 255.0
      self.images = images.astype(np.float32)
      self.height, self.width = self.images.shape[1:3]
      if self.split == DataSplit.TRAIN and config.n_input_views > 0:
        self.images = self.images[:config.n_input_views]
        poses = poses[:config.n_input_views]
    else:
      # Grab image resolution from a test image.
      d = os.path.join(self.data_dir, 'test', 'rgb')
      f = os.path.join(d, sorted(os.listdir(d))[0])
      shape = load_img(f).shape
      self.height, self.width = shape[:2]
      self.images = None

    self.camtoworlds = poses
    self.focal = intrinsics[0, 0, 0]
    self.pixtocams = camera_utils.get_pixtocam(self.focal, self.width,
                                               self.height)


class TanksAndTemplesFVS(BaseDataset):
  """Tanks and Temples, Free View Synthesis preprocessing (npy poses)."""

  def _load_renderings(self, config):
    render_only = config.render_path and self.split == DataSplit.TEST

    basedir = os.path.join(self.data_dir, 'dense')
    sizes = [f for f in sorted(os.listdir(basedir)) if f.startswith('ibr3d')]
    sizes = sizes[::-1]
    if config.factor >= len(sizes):
      raise ValueError(f'Factor {config.factor} larger than {len(sizes)}')
    basedir = os.path.join(basedir, sizes[config.factor])
    join = lambda f: os.path.join(basedir, f)

    files = [f for f in sorted(os.listdir(basedir)) if f.startswith('im_')]
    if render_only:
      files = files[:1]
    images = np.array(parallel_map(
        lambda f: io_lib.read_image(join(f)), files)) / 255.0

    names = ['Ks', 'Rs', 'ts']
    intrinsics, rot, trans = (np.load(join(f'{n}.npy')) for n in names)

    # COLMAP world-to-cam -> our cam-to-world (OpenGL axes).
    w2c = np.concatenate([rot, trans[..., None]], axis=-1)
    c2w_colmap = np.linalg.inv(camera_utils.pad_poses(w2c))[:, :3, :4]
    c2w = c2w_colmap @ np.diag(np.array([1, -1, -1, 1]))

    poses, _ = camera_utils.transform_poses_pca(c2w)
    self.poses = poses
    self.images = images.astype(np.float32)
    self.height, self.width = self.images.shape[1:3]
    self.camtoworlds = poses
    self.focal = intrinsics[0, 0, 0]
    self.pixtocams = camera_utils.get_pixtocam(self.focal, self.width,
                                               self.height)

    if render_only:
      render_path = camera_utils.generate_ellipse_path(
          poses, config.render_path_frames,
          z_variation=config.z_variation, z_phase=config.z_phase)
      self.images = None
      self.camtoworlds = render_path
      self.render_poses = render_path
    else:
      all_indices = np.arange(images.shape[0])
      indices = {
          DataSplit.VAL: all_indices[all_indices % config.llffhold == 0],
          DataSplit.TEST: all_indices[all_indices % config.llffhold == 0],
          DataSplit.TRAIN: all_indices[all_indices % config.llffhold != 0],
      }[self.split]
      if self.split == DataSplit.TRAIN and config.n_input_views > 0:
        indices = indices[:config.n_input_views]
      self.images = self.images[indices]
      self.camtoworlds = self.camtoworlds[indices]


class DTU(BaseDataset):
  """DTU multi-view stereo scans."""

  def _load_renderings(self, config):
    if config.render_path:
      raise ValueError('render_path cannot be used for the DTU dataset.')

    # A scan has 49 or 65 images; 8 files per view.
    n_images = len(os.listdir(self.data_dir)) // 8

    def load_view(i):
      if config.dtu_light_cond < 7:
        light_str = (f'{config.dtu_light_cond}_r' +
                     ('5000' if i < 50 else '7000'))
      else:
        light_str = 'max'

      fname = os.path.join(self.data_dir, f'rect_{i:03d}_{light_str}.png')
      image = load_img(fname) / 255.0
      if config.factor > 1:
        image = downsample_np(image, config.factor)

      fname = path.join(self.data_dir, f'../../cal18/pos_{i:03d}.txt')
      with open(fname, 'rb') as f:
        projection = np.loadtxt(f, dtype=np.float32)

      camera_mat, rot_mat, t = _decompose_projection_matrix(projection)
      camera_mat = camera_mat / camera_mat[2, 2]
      pose = np.eye(4, dtype=np.float32)
      pose[:3, :3] = rot_mat.transpose()
      pose[:3, 3] = (t[:3] / t[3])[:, 0]
      pose = pose[:3]

      if config.factor > 0:
        camera_mat = np.diag(
            [1.0 / config.factor, 1.0 / config.factor, 1.0]).astype(
                np.float32) @ camera_mat
      return image, pose, np.linalg.inv(camera_mat)

    views = parallel_map(load_view, range(1, n_images + 1))
    images = [v[0] for v in views]
    camtoworlds = [v[1] for v in views]
    pixtocams = [v[2] for v in views]

    pixtocams = np.stack(pixtocams)
    camtoworlds = np.stack(camtoworlds)
    images = np.stack(images)

    def rescale_poses(poses):
      s = np.max(np.abs(poses[:, :3, -1]))
      out = np.copy(poses)
      out[:, :3, -1] /= s
      return out

    camtoworlds, _ = camera_utils.recenter_poses(camtoworlds)
    camtoworlds = rescale_poses(camtoworlds)
    # OpenCV -> OpenGL axes.
    camtoworlds = camtoworlds @ np.diag([1.0, -1.0, -1.0, 1.0]).astype(
        np.float32)

    all_indices = np.arange(images.shape[0])
    split_indices = {
        DataSplit.VAL: all_indices[all_indices % config.dtuhold == 0],
        DataSplit.TEST: all_indices[all_indices % config.dtuhold == 0],
        DataSplit.TRAIN: all_indices[all_indices % config.dtuhold != 0],
    }
    indices = split_indices[self.split]
    if self.split == DataSplit.TRAIN and config.n_input_views > 0:
      indices = indices[:config.n_input_views]

    self.images = images[indices].astype(np.float32)
    self.height, self.width = images.shape[1:3]
    self.camtoworlds = camtoworlds[indices]
    self.pixtocams = pixtocams[indices]


def _decompose_projection_matrix(p):
  """RQ-decompose a 3x4 projection into (K, R, t-homogeneous).

  Equivalent to cv2.decomposeProjectionMatrix (which the reference uses,
  datasets.py:1007) without the cv2 dependency: K upper-triangular with
  positive diagonal, R orthonormal, camera center as 4-vector.
  """
  m = p[:3, :3]
  # RQ decomposition via flipped QR.
  flip = np.flipud(np.eye(3))
  q, r = np.linalg.qr((flip @ m).T)
  k = flip @ r.T @ flip
  rot = flip @ q.T
  # Force positive diagonal on K.
  sign = np.diag(np.sign(np.diag(k)))
  k = k @ sign
  rot = sign @ rot
  if np.linalg.det(rot) < 0:
    k = -k
    rot = -rot
  # Camera center: null space of P (homogeneous 4-vector).
  _, _, vt = np.linalg.svd(p)
  c = vt[-1]
  return k.astype(np.float32), rot.astype(np.float32), c.reshape(4, 1)
