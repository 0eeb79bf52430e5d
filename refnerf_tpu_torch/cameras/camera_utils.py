"""Camera poses and ray generation (counterpart of
refnerf_tpu/cameras/camera_utils.py).

The pose math, the render paths and the intrinsics are the JAX package's
numpy, kept as numpy: they run once, when a dataset loads. Ray generation
(`pixels_to_rays`, `cast_ray_batch`, NDC, the undistortion, the pinhole and
spherical casts) runs on tensors, on the CPU or inside the train step on the
card, where the cameras live. Its 3x3 mat-vec products and its norms are
written as elementwise products and sums in a fixed order: no TF32 matmul
rounds them on the card, and the card and the CPU round alike. A ray's
radius is the norm of a difference of two neighbouring directions ~1/focal
apart, which any other order moves by ~1e-7 / 1e-3 relative.
"""

from __future__ import annotations

import enum
import math

import numpy as np
import scipy.interpolate
import torch

from refnerf_tpu_torch.cameras import rays as rays_lib
from refnerf_tpu_torch.ops import stepfun


class ProjectionType(enum.Enum):
  PERSPECTIVE = 'perspective'
  FISHEYE = 'fisheye'


# ---------------------------------------------------------------------------
# Host-side pose math (numpy; runs once per dataset).
# ---------------------------------------------------------------------------


def normalize(x):
  return x / np.linalg.norm(x)


def pad_poses(p):
  """Append the homogeneous [0,0,0,1] row to [..., 3, 4] poses."""
  bottom = np.broadcast_to([0, 0, 0, 1.0], p[..., :1, :4].shape)
  return np.concatenate([p[..., :3, :4], bottom], axis=-2)


def unpad_poses(p):
  return p[..., :3, :4]


def viewmatrix(lookdir, up, position):
  """Construct a camera-to-world lookat matrix [3, 4]."""
  vec2 = normalize(lookdir)
  vec0 = normalize(np.cross(up, vec2))
  vec1 = normalize(np.cross(vec2, vec0))
  return np.stack([vec0, vec1, vec2, position], axis=1)


def average_pose(poses):
  """Pose with mean position, viewing direction, and up vector."""
  position = poses[:, :3, 3].mean(0)
  z_axis = poses[:, :3, 2].mean(0)
  up = poses[:, :3, 1].mean(0)
  return viewmatrix(z_axis, up, position)


def recenter_poses(poses):
  """Recenter poses about the average pose; returns (poses, transform)."""
  cam2world = average_pose(poses)
  transform = np.linalg.inv(pad_poses(cam2world))
  poses = transform @ pad_poses(poses)
  return unpad_poses(poses), transform


def focus_point_fn(poses):
  """Point minimizing squared distance to all camera focal axes."""
  directions, origins = poses[:, :3, 2:3], poses[:, :3, 3:4]
  m = np.eye(3) - directions * np.transpose(directions, [0, 2, 1])
  mt_m = np.transpose(m, [0, 2, 1]) @ m
  return np.linalg.inv(mt_m.mean(0)) @ (mt_m @ origins).mean(0)[:, 0]


def transform_poses_pca(poses):
  """Rotate/scale poses so principal components align with XYZ in [-1,1]^3."""
  t = poses[:, :3, 3]
  t_mean = t.mean(axis=0)
  t = t - t_mean

  eigval, eigvec = np.linalg.eig(t.T @ t)
  inds = np.argsort(eigval)[::-1]
  eigvec = eigvec[:, inds]
  rot = eigvec.T
  if np.linalg.det(rot) < 0:
    rot = np.diag(np.array([1, 1, -1])) @ rot

  transform = np.concatenate([rot, rot @ -t_mean[:, None]], -1)
  poses_recentered = unpad_poses(transform @ pad_poses(poses))
  transform = np.concatenate([transform, np.eye(4)[3:]], axis=0)

  # Flip so the average up vector points up (+z of y-axis).
  if poses_recentered.mean(axis=0)[2, 1] < 0:
    poses_recentered = np.diag(np.array([1, -1, -1])) @ poses_recentered
    transform = np.diag(np.array([1, -1, -1, 1])) @ transform

  scale_factor = 1.0 / np.max(np.abs(poses_recentered[:, :3, 3]))
  poses_recentered[:, :3, 3] *= scale_factor
  transform = np.diag(np.array([scale_factor] * 3 + [1])) @ transform
  return poses_recentered, transform


# generate_spiral_path constants (forward-facing render paths).
NEAR_STRETCH = 0.9
FAR_STRETCH = 5.0
FOCUS_DISTANCE = 0.75


def generate_spiral_path(poses, bounds, n_frames=120, n_rots=2, zrate=0.5):
  """Forward-facing spiral render path (ref: camera_utils.py:158-188)."""
  near_bound = bounds.min() * NEAR_STRETCH
  far_bound = bounds.max() * FAR_STRETCH
  # Focus depth: weighted harmonic mean of the stretched near/far bounds.
  focal = 1 / ((1 - FOCUS_DISTANCE) / near_bound + FOCUS_DISTANCE / far_bound)

  positions = poses[:, :3, 3]
  radii = np.percentile(np.abs(positions), 90, 0)
  radii = np.concatenate([radii, [1.0]])

  render_poses = []
  cam2world = average_pose(poses)
  up = poses[:, :3, 1].mean(0)
  for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_frames,
                           endpoint=False):
    t = radii * [np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]
    position = cam2world @ t
    lookat = cam2world @ [0, 0, -focal, 1.0]
    z_axis = position - lookat
    render_poses.append(viewmatrix(z_axis, up, position))
  return np.stack(render_poses, axis=0)


def generate_ellipse_path(poses, n_frames=120, const_speed=True,
                          z_variation=0.0, z_phase=0.0):
  """Elliptical render path around the capture's focus point
  (ref: camera_utils.py:230-278). Constant-speed resampling reuses the
  framework's own inverse-CDF sampler."""
  center = focus_point_fn(poses)
  offset = np.array([center[0], center[1], 0])

  sc = np.percentile(np.abs(poses[:, :3, 3] - offset), 90, axis=0)
  low = -sc + offset
  high = sc + offset
  z_low = np.percentile(poses[:, :3, 3], 10, axis=0)
  z_high = np.percentile(poses[:, :3, 3], 90, axis=0)

  def get_positions(theta):
    return np.stack([
        low[0] + (high - low)[0] * (np.cos(theta) * 0.5 + 0.5),
        low[1] + (high - low)[1] * (np.sin(theta) * 0.5 + 0.5),
        z_variation * (z_low[2] + (z_high - z_low)[2] *
                       (np.cos(theta + 2 * np.pi * z_phase) * 0.5 + 0.5)),
    ], -1)

  theta = np.linspace(0, 2.0 * np.pi, n_frames + 1, endpoint=True)
  positions = get_positions(theta)

  if const_speed:
    # Resample thetas so arc-length speed is approximately constant.
    lengths = np.linalg.norm(positions[1:] - positions[:-1], axis=-1)
    # In float32, as the JAX package samples it (jnp without x64).
    theta = stepfun.sample(
        torch.tensor(theta, dtype=torch.float32),
        torch.log(torch.tensor(lengths, dtype=torch.float32)),
        n_frames + 1).numpy()
    positions = get_positions(theta)

  positions = positions[:-1]  # drop duplicated endpoint

  avg_up = poses[:, :3, 1].mean(0)
  avg_up = avg_up / np.linalg.norm(avg_up)
  ind_up = np.argmax(np.abs(avg_up))
  up = np.eye(3)[ind_up] * np.sign(avg_up[ind_up])

  return np.stack([viewmatrix(p - center, up, p) for p in positions])


def generate_interpolated_path(poses, n_interp, spline_degree=5,
                               smoothness=0.03, rot_weight=0.1):
  """B-spline interpolation through keyframe poses in
  (position, lookat, up) point form (ref: camera_utils.py:281-328)."""

  def poses_to_points(poses, dist):
    pos = poses[:, :3, -1]
    lookat = poses[:, :3, -1] - dist * poses[:, :3, 2]
    up = poses[:, :3, -1] + dist * poses[:, :3, 1]
    return np.stack([pos, lookat, up], 1)

  def points_to_poses(points):
    return np.array([viewmatrix(p - l, u - p, p) for p, l, u in points])

  def interp(points, n, k, s):
    sh = points.shape
    pts = np.reshape(points, (sh[0], -1))
    k = min(k, sh[0] - 1)
    tck, _ = scipy.interpolate.splprep(pts.T, k=k, s=s)
    u = np.linspace(0, 1, n, endpoint=False)
    new_points = np.array(scipy.interpolate.splev(u, tck))
    return np.reshape(new_points.T, (n, sh[1], sh[2]))

  points = poses_to_points(poses, dist=rot_weight)
  new_points = interp(points, n_interp * (points.shape[0] - 1),
                      k=spline_degree, s=smoothness)
  return points_to_poses(new_points)


def interpolate_1d(x, n_interp, spline_degree, smoothness):
  """Spline-upsample a 1D signal by a factor of n_interp."""
  t = np.linspace(0, 1, len(x), endpoint=True)
  tck = scipy.interpolate.splrep(t, x, s=smoothness, k=spline_degree)
  n = n_interp * (len(x) - 1)
  u = np.linspace(0, 1, n, endpoint=False)
  return scipy.interpolate.splev(u, tck)


def create_render_spline_path(config, image_names, poses):
  """Spline render path through keyframes named by file or directory
  (ref: camera_utils.py:343-377)."""
  import os
  if os.path.isdir(config.render_spline_keyframes):
    keyframe_names = sorted(os.listdir(config.render_spline_keyframes))
  else:
    with open(config.render_spline_keyframes, 'r') as fp:
      keyframe_names = fp.read().splitlines()
  spline_indices = np.array(
      [i for i, n in enumerate(image_names) if n in keyframe_names])
  keyframes = poses[spline_indices]
  render_poses = generate_interpolated_path(
      keyframes,
      n_interp=config.render_spline_n_interp,
      spline_degree=config.render_spline_degree,
      smoothness=config.render_spline_smoothness,
      rot_weight=0.1)
  return spline_indices, render_poses


def intrinsic_matrix(fx, fy, cx, cy):
  """OpenCV-convention pinhole intrinsics."""
  return np.array([
      [fx, 0, cx],
      [0, fy, cy],
      [0, 0, 1.0],
  ])


def get_pixtocam(focal, width, height):
  """Inverse intrinsics of a centered pinhole camera."""
  camtopix = intrinsic_matrix(focal, focal, width * 0.5, height * 0.5)
  return np.linalg.inv(camtopix).astype(np.float32)


def pixel_coordinates(width, height):
  """Integer (x, y) meshgrid over an image."""
  return np.meshgrid(np.arange(width), np.arange(height), indexing='xy')



# ---------------------------------------------------------------------------
# Ray generation on tensors (the CPU, or the card inside the train step).
# ---------------------------------------------------------------------------


def _mat_vec(a, b):
  """a [..., 3, k] times b [..., k], as products and sums over k in order."""
  out = a[..., 0] * b[..., None, 0]
  for j in range(1, a.shape[-1]):
    out = out + a[..., j] * b[..., None, j]
  return out


def _norm(v):
  """The Euclidean norm over the last axis, its squares summed in order."""
  sq = v[..., 0] * v[..., 0]
  for j in range(1, v.shape[-1]):
    sq = sq + v[..., j] * v[..., j]
  return torch.sqrt(sq)


def convert_to_ndc(origins, directions, pixtocam, near=1.0):
  """Map rays into the NDC cube of a forward-facing pinhole capture.

  Valid for any ray with dz < 0; after the map, near/far planes sit at 0/1
  along z (NeRF Appendix C).
  """
  # Slide origins onto the near plane (oz = -near) so the new near bound is 0.
  t = -(near + origins[..., 2]) / directions[..., 2]
  origins = origins + t[..., None] * directions

  dx, dy, dz = directions.unbind(-1)
  ox, oy, oz = origins.unbind(-1)

  xmult = 1.0 / pixtocam[0, 2]  # == -2 * focal / width
  ymult = 1.0 / pixtocam[1, 2]  # == -2 * focal / height

  # Projections of the t=0 points and the t=infinity points.
  origins_ndc = torch.stack(
      [xmult * ox / oz, ymult * oy / oz, -torch.ones_like(oz)], dim=-1)
  infinity_ndc = torch.stack(
      [xmult * dx / dz, ymult * dy / dz, torch.ones_like(oz)], dim=-1)

  directions_ndc = infinity_ndc - origins_ndc
  return origins_ndc, directions_ndc


def _distortion_residual_and_jacobian(x, y, xd, yd, k1, k2, k3, k4, p1, p2):
  """Residual + Jacobian of the radial/tangential distortion model at (x,y)."""
  r = x * x + y * y
  d = 1.0 + r * (k1 + r * (k2 + r * (k3 + r * k4)))

  fx = d * x + 2 * p1 * x * y + p2 * (r + 2 * x * x) - xd
  fy = d * y + 2 * p2 * x * y + p1 * (r + 2 * y * y) - yd

  d_r = k1 + r * (2.0 * k2 + r * (3.0 * k3 + r * 4.0 * k4))
  d_x = 2.0 * x * d_r
  d_y = 2.0 * y * d_r

  fx_x = d + d_x * x + 2.0 * p1 * y + 6.0 * p2 * x
  fx_y = d_y * x + 2.0 * p1 * x + 2.0 * p2 * y
  fy_x = d_x * y + 2.0 * p2 * y + 2.0 * p1 * x
  fy_y = d + d_y * y + 2.0 * p2 * x + 6.0 * p1 * y
  return fx, fy, fx_x, fx_y, fy_x, fy_y


def radial_and_tangential_undistort(xd, yd, k1=0.0, k2=0.0, k3=0.0, k4=0.0,
                                    p1=0.0, p2=0.0, eps=1e-9,
                                    max_iterations=10):
  """Invert the distortion model by `max_iterations` Newton steps.

  A step divides only where |denominator| > eps, by a denominator made safe
  with `torch.where` (1 elsewhere), so that no NaN reaches a gradient.
  """
  x, y = xd, yd
  for _ in range(max_iterations):
    fx, fy, fx_x, fx_y, fy_x, fy_y = _distortion_residual_and_jacobian(
        x, y, xd, yd, k1, k2, k3, k4, p1, p2)
    denominator = fy_x * fx_y - fx_x * fy_y
    x_numerator = fx * fy_y - fy * fx_y
    y_numerator = fy * fx_x - fx * fy_x
    safe = torch.abs(denominator) > eps
    denom_safe = torch.where(safe, denominator, torch.ones_like(denominator))
    zero = torch.zeros_like(denominator)
    x = x + torch.where(safe, x_numerator / denom_safe, zero)
    y = y + torch.where(safe, y_numerator / denom_safe, zero)
  return x, y


def pixels_to_rays(pix_x_int, pix_y_int, pixtocams, camtoworlds,
                   distortion_params=None, pixtocam_ndc=None,
                   camtype=ProjectionType.PERSPECTIVE):
  """Pixel centers -> world-space rays with mip radii.

  Shoots the center ray plus +1-pixel x/y neighbor rays to derive the cone
  radii (neighbor spacing * 2/sqrt(12)).

  Args:
    pix_x_int/pix_y_int: integer tensors, shape SH.
    pixtocams: [SH.., 3, 3] or [3, 3] inverse intrinsics.
    camtoworlds: [SH.., 3, 4] or [3, 4] extrinsics.
    distortion_params: optional dict of distortion floats.
    pixtocam_ndc: optional [3, 3] inverse intrinsics for the NDC warp.
    camtype: perspective or fisheye.

  Returns:
    (origins, directions, viewdirs, radii, imageplane).
  """
  def pix_to_dir(x, y):
    return torch.stack([x + 0.5, y + 0.5,
                        torch.ones_like(x, dtype=torch.float32)], dim=-1)

  # Center ray + x/y neighbors for ray differentials.
  camera_dirs_stacked = _mat_vec(pixtocams, torch.stack([
      pix_to_dir(pix_x_int, pix_y_int),
      pix_to_dir(pix_x_int + 1, pix_y_int),
      pix_to_dir(pix_x_int, pix_y_int + 1)
  ], dim=0).float())

  if distortion_params is not None:
    x, y = radial_and_tangential_undistort(
        camera_dirs_stacked[..., 0], camera_dirs_stacked[..., 1],
        **distortion_params)
    camera_dirs_stacked = torch.stack([x, y, torch.ones_like(x)], -1)

  if camtype == ProjectionType.FISHEYE:
    theta = _norm(camera_dirs_stacked[..., :2])
    theta = torch.minimum(theta.new_tensor(math.pi), theta)
    # sinc: the ray through the principal point has theta == 0 exactly; the
    # limit is 1, not 0/0.
    sin_theta_over_theta = torch.where(
        theta > 1e-8,
        torch.sin(theta) / torch.maximum(theta, theta.new_tensor(1e-8)),
        torch.ones_like(theta))
    camera_dirs_stacked = torch.stack([
        camera_dirs_stacked[..., 0] * sin_theta_over_theta,
        camera_dirs_stacked[..., 1] * sin_theta_over_theta,
        torch.cos(theta),
    ], dim=-1)

  # OpenCV -> OpenGL: negate y and z.
  camera_dirs_stacked = camera_dirs_stacked * camera_dirs_stacked.new_tensor(
      [1.0, -1.0, -1.0])

  imageplane = camera_dirs_stacked[0, ..., :2]

  directions, dx, dy = _mat_vec(camtoworlds[..., :3, :3],
                                camera_dirs_stacked).unbind(0)

  origins = torch.broadcast_to(camtoworlds[..., :3, -1], directions.shape)
  viewdirs = directions / _norm(directions)[..., None]

  if pixtocam_ndc is None:
    dx_norm = _norm(dx - directions)
    dy_norm = _norm(dy - directions)
  else:
    # In NDC, use origin offsets instead of direction offsets.
    origins_dx, _ = convert_to_ndc(origins, dx, pixtocam_ndc)
    origins_dy, _ = convert_to_ndc(origins, dy, pixtocam_ndc)
    origins, directions = convert_to_ndc(origins, directions, pixtocam_ndc)
    dx_norm = _norm(origins_dx - origins)
    dy_norm = _norm(origins_dy - origins)

  # Half the neighbor spacing, scaled to the stddev of a unit-box pixel.
  radii = (0.5 * (dx_norm + dy_norm))[..., None] * 2 / math.sqrt(12)

  return origins, directions, viewdirs, radii, imageplane


def cast_ray_batch(cameras, pixels, camtype=ProjectionType.PERSPECTIVE):
  """Pixels + camera bank -> Rays, on the pixels' device.

  cameras = (pixtocams [N,3,3], camtoworlds [N,3,4], distortion_params
  (dict or None), pixtocam_ndc ([3,3] or None)), as tensors on that device
  (arrays are copied there). Each pixel's camera is one gather over the
  bank.
  """
  pixtocams, camtoworlds, distortion_params, pixtocam_ndc = cameras
  device = pixels.pix_x_int.device
  bank = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)

  # Per-pixel camera index, broadcast (left-aligned) to the full pixel shape
  # so indexed camera matrices batch-match the stacked pixel directions.
  cam_idx = pixels.cam_idx[..., 0].long()
  extra = pixels.pix_x_int.ndim - cam_idx.ndim
  cam_idx = torch.broadcast_to(
      cam_idx.reshape(cam_idx.shape + (1,) * extra), pixels.pix_x_int.shape)
  batch_index = lambda arr: arr if arr.ndim == 2 else arr[cam_idx]

  origins, directions, viewdirs, radii, imageplane = pixels_to_rays(
      pixels.pix_x_int,
      pixels.pix_y_int,
      batch_index(bank(pixtocams)),
      batch_index(bank(camtoworlds)),
      distortion_params=distortion_params,
      pixtocam_ndc=None if pixtocam_ndc is None else bank(pixtocam_ndc),
      camtype=camtype)

  return rays_lib.Rays(
      origins=origins,
      directions=directions,
      viewdirs=viewdirs,
      radii=radii,
      imageplane=imageplane,
      lossmult=pixels.lossmult,
      near=pixels.near,
      far=pixels.far,
      cam_idx=pixels.cam_idx)


def _broadcast_scalar(x, shape, device, dtype=torch.float32):
  return torch.full(tuple(shape) + (1,), x, dtype=dtype, device=device)


def cast_pinhole_rays(camtoworld, height, width, focal, near, far,
                      device='cuda'):
  """Full-image pinhole ray batch (no distortion), for path rendering."""
  pix_x_int, pix_y_int = (torch.as_tensor(a, device=device)
                          for a in pixel_coordinates(width, height))
  pixtocam = torch.as_tensor(get_pixtocam(focal, width, height), device=device)
  ray_args = pixels_to_rays(
      pix_x_int, pix_y_int, pixtocam,
      torch.as_tensor(camtoworld, dtype=torch.float32, device=device))
  shape = pix_x_int.shape
  return rays_lib.Rays(
      *ray_args,
      lossmult=_broadcast_scalar(1.0, shape, device),
      near=_broadcast_scalar(near, shape, device),
      far=_broadcast_scalar(far, shape, device),
      cam_idx=_broadcast_scalar(0, shape, device, torch.int32))


def cast_spherical_rays(camtoworld, height, width, near, far, device='cuda'):
  """Full-pano equirectangular ray batch."""
  camtoworld = torch.as_tensor(camtoworld, dtype=torch.float32, device=device)
  theta_vals = torch.linspace(0, 2 * math.pi, width + 1, device=device)
  phi_vals = torch.linspace(0, math.pi, height + 1, device=device)
  phi, theta = torch.meshgrid(phi_vals, theta_vals, indexing='ij')

  directions = torch.stack([
      -torch.sin(phi) * torch.sin(theta),
      torch.cos(phi),
      torch.sin(phi) * torch.cos(theta),
  ], dim=-1)

  directions = _mat_vec(camtoworld[:3, :3], directions)

  dy = torch.diff(directions[:, :-1], dim=0)
  dx = torch.diff(directions[:-1, :], dim=1)
  directions = directions[:-1, :-1]
  viewdirs = directions

  origins = torch.broadcast_to(camtoworld[:3, -1], directions.shape)

  dx_norm = _norm(dx)
  dy_norm = _norm(dy)
  radii = (0.5 * (dx_norm + dy_norm))[..., None] * 2 / math.sqrt(12)

  imageplane = torch.zeros_like(directions[..., :2])

  shape = radii.shape[:-1]
  return rays_lib.Rays(
      origins, directions, viewdirs, radii, imageplane,
      lossmult=_broadcast_scalar(1.0, shape, device),
      near=_broadcast_scalar(near, shape, device),
      far=_broadcast_scalar(far, shape, device),
      cam_idx=_broadcast_scalar(0, shape, device, torch.int32))
