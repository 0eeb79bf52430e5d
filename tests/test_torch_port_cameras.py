"""The port's camera module against the JAX package's, on the CPU.

The same numpy inputs, made from a seed, go through
refnerf_tpu.cameras.camera_utils and refnerf_tpu_torch.cameras.camera_utils.

Tolerances. The pose math and the render paths are the same numpy code
(the ellipse path's constant-speed resample goes through each package's
stepfun.sample in float32): 1e-6. The ray casts run in float32 in both
packages, the port's 3x3 products as products and a sum where JAX calls
matmul, so they differ by the rounding of that order: 1e-5 (the NDC
origins, which divide by oz near the near plane, relative 1e-5).
"""

import numpy as np
import pytest
import torch

from refnerf_tpu.cameras import camera_utils as jcu
from refnerf_tpu.cameras import rays as jrays
from refnerf_tpu_torch.cameras import camera_utils as cu
from refnerf_tpu_torch.cameras import rays as rays_lib

torch.set_num_threads(1)

POSE_TOL = 1e-6
RAY_TOL = 1e-5
RAY_FIELDS = ('origins', 'directions', 'viewdirs', 'radii', 'imageplane')


def _poses(n=9, seed=0, forward=False):
  """n camera-to-world [3, 4] poses: on a ring looking at the origin, or
  (forward) along x looking down -z."""
  rng = np.random.default_rng(seed)
  out = []
  for i in range(n):
    if forward:
      pos = np.array([0.3 * i, 0.1 * rng.normal(), 4.0 + 0.1 * rng.normal()])
      look = np.array([0.0, 0.0, 1.0]) + 0.05 * rng.normal(size=3)
    else:
      theta = 2 * np.pi * i / n
      pos = np.array([4 * np.cos(theta), 4 * np.sin(theta),
                      0.5 + 0.2 * rng.normal()])
      look = pos
    out.append(jcu.viewmatrix(look, np.array([0.0, 0.0, 1.0]), pos))
  return np.stack(out)


POSE_CASES = {
    'normalize': lambda m, p: m.normalize(p[0, :, 3]),
    'pad_unpad': lambda m, p: m.unpad_poses(m.pad_poses(p)),
    'average_pose': lambda m, p: m.average_pose(p),
    'recenter_poses': lambda m, p: np.concatenate(
        [m.recenter_poses(p)[0].ravel(), m.recenter_poses(p)[1].ravel()]),
    'focus_point_fn': lambda m, p: m.focus_point_fn(p),
    'transform_poses_pca': lambda m, p: np.concatenate(
        [m.transform_poses_pca(p)[0].ravel(),
         m.transform_poses_pca(p)[1].ravel()]),
    'spiral_path': lambda m, p: m.generate_spiral_path(
        p, np.array([0.5, 5.0]), n_frames=12),
    'ellipse_path': lambda m, p: m.generate_ellipse_path(p, n_frames=12),
    'ellipse_path_z': lambda m, p: m.generate_ellipse_path(
        p, n_frames=10, z_variation=0.5, z_phase=0.25),
    'ellipse_path_uniform': lambda m, p: m.generate_ellipse_path(
        p, n_frames=10, const_speed=False),
    'interpolated_path': lambda m, p: m.generate_interpolated_path(
        p[:6], n_interp=4, spline_degree=3),
    'interpolate_1d': lambda m, p: m.interpolate_1d(
        p[:, 0, 3], 3, 3, 0.01),
    'intrinsics': lambda m, p: m.get_pixtocam(40.0, 32, 24),
    'pixel_coordinates': lambda m, p: np.stack(m.pixel_coordinates(5, 3)),
}


@pytest.mark.parametrize('case', sorted(POSE_CASES))
def test_pose_math_and_render_paths_match_jax(case):
  poses = _poses()
  want = POSE_CASES[case](jcu, poses)
  got = POSE_CASES[case](cu, poses)
  np.testing.assert_allclose(got, want, rtol=POSE_TOL, atol=POSE_TOL)


def test_render_spline_path_matches_jax(tmp_path):
  class Cfg:
    render_spline_keyframes = str(tmp_path / 'keys.txt')
    render_spline_n_interp = 3
    render_spline_degree = 3
    render_spline_smoothness = 0.03
  names = [f'img_{i}.png' for i in range(9)]
  (tmp_path / 'keys.txt').write_text('\n'.join(names[1:7]))
  poses = _poses()
  ji, jp = jcu.create_render_spline_path(Cfg, names, poses)
  i, p = cu.create_render_spline_path(Cfg, names, poses)
  np.testing.assert_array_equal(i, ji)
  np.testing.assert_allclose(p, jp, rtol=POSE_TOL, atol=POSE_TOL)


def _intrinsics(width=24, height=20, focal=30.0):
  return jcu.get_pixtocam(focal, width, height)


DISTORTION = {'k1': 0.05, 'k2': -0.02, 'k3': 0.01, 'p1': 0.003,
              'p2': -0.002}
FISHEYE = {'k1': 0.02, 'k2': 0.01, 'k3': -0.005, 'k4': 0.001}


def _close_rays(got, want, tol=RAY_TOL, rel=()):
  for k, a in zip(RAY_FIELDS, got):
    b = np.asarray(want[RAY_FIELDS.index(k)])
    a = a.numpy()
    if k in rel:
      np.testing.assert_allclose(a, b, rtol=tol, atol=0, err_msg=k)
    else:
      np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=k)


# (distortion, NDC, projection type) of each case of pixels_to_rays.
PIXEL_CASES = {
    'pinhole': (None, False, 'perspective'),
    'distorted': (DISTORTION, False, 'perspective'),
    'ndc': (None, True, 'perspective'),
    'distorted_ndc': (DISTORTION, True, 'perspective'),
    'fisheye': (FISHEYE, False, 'fisheye'),
    'fisheye_undistorted': (None, False, 'fisheye'),
}


@pytest.mark.parametrize('case', sorted(PIXEL_CASES))
@pytest.mark.parametrize('per_pixel', [False, True])
def test_pixels_to_rays_matches_jax(case, per_pixel):
  distortion, ndc, camtype = PIXEL_CASES[case]
  rng = np.random.default_rng(3)
  n = 40
  px = rng.integers(0, 24, (n,)).astype(np.int32)
  py = rng.integers(0, 20, (n,)).astype(np.int32)
  pixtocam = _intrinsics()
  poses = _poses(4, forward=ndc).astype(np.float32)
  if per_pixel:
    idx = rng.integers(0, 4, (n,))
    pixtocams = np.broadcast_to(pixtocam, (n, 3, 3)).astype(np.float32)
    camtoworlds = poses[idx]
  else:
    pixtocams, camtoworlds = pixtocam, poses[1]
  ndc_mat = pixtocam if ndc else None
  jtype = jcu.ProjectionType(camtype)
  want = jcu.pixels_to_rays(px, py, pixtocams, camtoworlds, distortion,
                            ndc_mat, jtype)
  got = cu.pixels_to_rays(
      torch.tensor(px), torch.tensor(py), torch.tensor(pixtocams),
      torch.tensor(camtoworlds), distortion,
      None if ndc_mat is None else torch.tensor(ndc_mat),
      cu.ProjectionType(camtype))
  _close_rays(got, want)


def _pixel_batch(n, patch, n_cams, width, height, seed, single_image):
  """Pixels as the datasets' train split makes them (patches of patch^2)."""
  rng = np.random.default_rng(seed)
  x = rng.integers(0, width - patch + 1, (n, 1, 1))
  y = rng.integers(0, height - patch + 1, (n, 1, 1))
  dx, dy = jcu.pixel_coordinates(patch, patch)
  x, y = (x + dx).astype(np.int32), (y + dy).astype(np.int32)
  cam = (rng.integers(0, n_cams, (1,)) if single_image
         else rng.integers(0, n_cams, (n, 1, 1)))
  scalar = lambda v: np.broadcast_to(v, x.shape)[..., None]
  fields = dict(pix_x_int=x, pix_y_int=y,
                lossmult=scalar(np.float32(1.0)).copy(),
                near=scalar(np.float32(0.5)).copy(),
                far=scalar(np.float32(6.0)).copy(),
                cam_idx=scalar(cam).astype(np.int32))
  return (jrays.Pixels(**fields),
          rays_lib.Pixels(**{k: torch.tensor(v) for k, v in fields.items()}))


@pytest.mark.parametrize('case', sorted(PIXEL_CASES))
@pytest.mark.parametrize('patch,single_image',
                         [(1, False), (3, False), (2, True)])
def test_cast_ray_batch_matches_jax(case, patch, single_image):
  distortion, ndc, camtype = PIXEL_CASES[case]
  n_cams = 5
  pixtocams = np.stack([_intrinsics(focal=28.0 + i) for i in range(n_cams)])
  poses = _poses(n_cams, forward=ndc).astype(np.float32)
  cameras = (pixtocams.astype(np.float32), poses, distortion,
             pixtocams[0] if ndc else None)
  jpix, pix = _pixel_batch(12, patch, n_cams, 24, 20, 4, single_image)
  want = jcu.cast_ray_batch(cameras, jpix, jcu.ProjectionType(camtype))
  got = cu.cast_ray_batch(cameras, pix, cu.ProjectionType(camtype))
  assert got.origins.shape == (12, patch, patch, 3)
  _close_rays([getattr(got, k) for k in RAY_FIELDS],
              [getattr(want, k) for k in RAY_FIELDS])
  for k in ('lossmult', 'near', 'far', 'cam_idx'):
    np.testing.assert_array_equal(getattr(got, k).numpy(),
                                  np.asarray(getattr(want, k)))


def test_pinhole_and_spherical_casts_match_jax():
  pose = _poses(3)[1]
  want = jcu.cast_pinhole_rays(pose, 6, 8, 7.5, 2.0, 6.0)
  got = cu.cast_pinhole_rays(pose, 6, 8, 7.5, 2.0, 6.0, device='cpu')
  _close_rays([getattr(got, k) for k in RAY_FIELDS],
              [getattr(want, k) for k in RAY_FIELDS])
  want = jcu.cast_spherical_rays(pose, 6, 8, 2.0, 6.0)
  got = cu.cast_spherical_rays(pose, 6, 8, 2.0, 6.0, device='cpu')
  _close_rays([getattr(got, k) for k in RAY_FIELDS],
              [getattr(want, k) for k in RAY_FIELDS])
  for k in ('lossmult', 'near', 'far', 'cam_idx'):
    np.testing.assert_array_equal(getattr(got, k).numpy(),
                                  np.asarray(getattr(want, k)))
    assert getattr(got, k).dtype == (torch.int32 if k == 'cam_idx'
                                     else torch.float32)


def test_ndc_and_undistortion_match_jax():
  rng = np.random.default_rng(5)
  o = (rng.normal(size=(30, 3)) * 0.2).astype(np.float32)
  d = rng.normal(size=(30, 3)).astype(np.float32)
  d[:, 2] = -np.abs(d[:, 2]) - 0.5
  pixtocam = _intrinsics()
  want = jcu.convert_to_ndc(o, d, pixtocam)
  got = cu.convert_to_ndc(torch.tensor(o), torch.tensor(d),
                          torch.tensor(pixtocam))
  for a, b in zip(got, want):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RAY_TOL,
                               atol=RAY_TOL)
  xd, yd = (rng.uniform(-0.6, 0.6, (50,)).astype(np.float32) for _ in '01')
  want = jcu.radial_and_tangential_undistort(xd, yd, **DISTORTION)
  got = cu.radial_and_tangential_undistort(torch.tensor(xd), torch.tensor(yd),
                                           **DISTORTION)
  for a, b in zip(got, want):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RAY_TOL,
                               atol=RAY_TOL)


def test_undistortion_gradient_is_finite_where_a_step_is_skipped():
  # k1 = -1 makes the Newton denominator vanish on the ring r = 1/3
  # (d = 1 - r, and the Jacobian's determinant (1 - 3r)(1 - r) at y = 0):
  # that step is skipped, and its gradient must stay finite.
  xd = torch.tensor([3**-0.5, 0.2, 0.9], dtype=torch.float64,
                    requires_grad=True)
  yd = torch.zeros(3, dtype=torch.float64, requires_grad=True)
  x, y = cu.radial_and_tangential_undistort(xd, yd, k1=-1.0,
                                            max_iterations=1)
  gx, gy = torch.autograd.grad((x + y).sum(), [xd, yd])
  assert torch.isfinite(gx).all() and torch.isfinite(gy).all()
  assert x[0].item() == xd[0].item()  # the step at the zero was skipped
