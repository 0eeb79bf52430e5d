"""The port's vis.py against matplotlib and the JAX package, on the CPU.

- `turbo` and `gray` against matplotlib's colormaps of those names on a grid
  of 0, 1, every bin edge and its neighbours, values out of range, inf and
  NaN, in float32 and float64: equal.
- `visualize_suite` against JAX's on the same rendering dict, with and
  without the sRGB mapping: every panel within 1e-6 but the two ray panels,
  within 1e-4. Both packages resample the ray bundles in float32 as the
  difference of an interpolated cumulative sum over bins 1/2048 wide: a
  one-ulp difference of that sum (~6e-8, XLA contracts the interpolation
  into an FMA, torch does not) becomes ~1e-4 of a bin's value (1.5e-5
  seen).
- `create_videos` from frames on disk, through the writer found here and
  through the GIF writer (no ffmpeg, no cv2), decoded back.
"""

import os
import shutil
import sys
import types

import numpy as np
import pytest
from matplotlib import colormaps as mpl_colormaps
from PIL import Image

from refnerf_tpu import vis as jvis
from refnerf_tpu_torch import vis
from refnerf_tpu_torch.utils import io as io_lib

RAY_TOL = 1e-4


def _grid(dtype):
  edges = np.arange(257) / 256
  near = np.concatenate([np.nextafter(edges.astype(dtype), dtype(-1)),
                         np.nextafter(edges.astype(dtype), dtype(2))])
  other = [-1.0, -1e-9, 1 + 1e-9, 2.0, np.inf, -np.inf, np.nan, 0.0, 1.0]
  return np.concatenate([np.linspace(0, 1, 1001), edges, near, other]).astype(
      dtype)


@pytest.mark.parametrize('name', ['turbo', 'gray'])
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_colormaps_match_matplotlib(name, dtype):
  x = _grid(dtype)
  want = mpl_colormaps[name](x)
  got = getattr(vis, name)(x)
  np.testing.assert_array_equal(got, want)
  # Images too: the lookup keeps the input's shape.
  img = x[:1200].reshape(30, 40)
  np.testing.assert_array_equal(getattr(vis, name)(img),
                                mpl_colormaps[name](img))


def _rendering(seed=0, h=6, w=5, levels=2, rays=4, samples=9):
  rng = np.random.default_rng(seed)
  u = lambda *s: rng.uniform(0, 1, s)
  dist = np.sort(rng.uniform(2, 5, (h, w)), axis=None).reshape(h, w)
  out = {
      'rgb': u(h, w, 3), 'acc': u(h, w), 'distance_mean': dist,
      'distance_median': dist * 1.01, 'distance_percentile_5': dist * 0.9,
      'distance_percentile_95': dist * 1.2, 'rgb_cc': u(h, w, 3),
      'normals': rng.normal(size=(h, w, 3)),
      'normals_pred': rng.normal(size=(h, w, 3)), 'roughness': u(h, w, 1),
      'diffuse': u(h, w, 3), 'specular': u(h, w, 3), 'tint': u(h, w, 3)}
  out['distance_mean'][0, 0] = np.nan  # acc is zeroed there
  out['ray_sdist'] = np.sort(u(levels, rays, samples + 1), axis=-1)
  out['ray_weights'] = u(levels, rays, samples) / samples
  out['ray_rgbs'] = rng.uniform(-0.1, 1.1, (levels, rays, samples, 3))
  rays_ns = types.SimpleNamespace(origins=rng.normal(size=(h, w, 3)),
                                  directions=rng.normal(size=(h, w, 3)))
  return out, rays_ns


@pytest.mark.parametrize('linear_to_srgb', [False, True])
def test_visualize_suite_matches_jax(linear_to_srgb):
  rendering, rays = _rendering()
  want = jvis.visualize_suite(rendering, rays, linear_to_srgb)
  got = vis.visualize_suite(rendering, rays, linear_to_srgb)
  assert set(got) == set(want)
  for k in want:
    w = np.asarray(want[k])
    assert got[k].shape == w.shape, k
    tol = RAY_TOL if k in ('ray_colors', 'ray_weights') else 1e-6
    np.testing.assert_allclose(got[k], w, rtol=0, atol=tol, err_msg=k)


def _frames_on_disk(out_dir, n=3, h=6, w=8):
  """The render loop's per-frame dumps: colours of a few flat colours (a
  GIF palette holds them exactly), distances and acc."""
  os.makedirs(out_dir, exist_ok=True)
  colors = []
  for i in range(n):
    img = np.zeros((h, w, 3))
    img[:, : w // 2] = (i / n, 0.5, 1.0)
    img[:, w // 2:] = (1.0, i / n, 0.0)
    colors.append(img)
    for k in ('color', 'diffuse', 'specular'):
      io_lib.save_img_u8(img, os.path.join(out_dir, f'{k}_{i:03d}.png'))
    dist = (np.linspace(2, 3, h * w).reshape(h, w) + i).astype(np.float32)
    io_lib.save_img_f32(dist, os.path.join(out_dir,
                                           f'distance_mean_{i:03d}.tiff'))
    io_lib.save_img_f32(dist, os.path.join(out_dir,
                                           f'distance_median_{i:03d}.tiff'))
    io_lib.save_img_f32(np.full((h, w), 0.5, np.float32),
                        os.path.join(out_dir, f'acc_{i:03d}.tiff'))
  return colors


def _config(root):
  return types.SimpleNamespace(
      checkpoint_dir=str(root / 'exp' / 'scene'), render_dist_percentile=0.5,
      render_dist_curve_fn=np.log, render_video_fps=10, render_video_crf=18)


def test_create_videos_from_frames_on_disk(tmp_path):
  out_dir = str(tmp_path / 'frames')
  _frames_on_disk(out_dir)
  writers = vis.create_videos(_config(tmp_path), str(tmp_path), out_dir,
                              'test', 3)
  assert set(writers) == {'color', 'diffuse', 'specular', 'acc',
                          'distance_mean', 'distance_median'}
  ext = {'gif': '.gif'}.get(writers['color'], '.mp4')
  for k in writers:
    path = tmp_path / f'scene_exp_test_{k}{ext}'
    assert path.exists() and path.stat().st_size > 0, path


def test_gif_writer_decodes_back(tmp_path, monkeypatch):
  monkeypatch.setattr(shutil, 'which', lambda _: None)
  monkeypatch.setitem(sys.modules, 'cv2', None)
  out_dir = str(tmp_path / 'frames')
  colors = _frames_on_disk(out_dir)
  writers = vis.create_videos(_config(tmp_path), str(tmp_path), out_dir,
                              'test', 3)
  assert set(writers.values()) == {'gif'}
  with Image.open(tmp_path / 'scene_exp_test_color.gif') as gif:
    assert gif.n_frames == 3
    for i, want in enumerate(colors):
      gif.seek(i)
      got = np.asarray(gif.convert('RGB'))
      want_u8 = (np.clip(want, 0, 1) * 255).astype(np.uint8)
      np.testing.assert_array_equal(got, want_u8)
