"""The port's downsample, render-benchmark and step-profile tools
(refnerf_tpu_torch/tools/downsample_images.py, bench_render.py,
profile_step.py) on the CPU.

- downsample_images writes images_N/ PNGs byte for byte equal to JAX's
  tools/downsample_images.py on the same scene (odd sizes, cropped to the
  factor; the pattern of tests/test_scene_tools.py), and they load through
  the port's reader at the expected sizes.
- bench_render and profile_step run at a tiny width with `--device cpu`
  and print their JSON line with its keys; the profile's split by category
  holds every category, with no device time on the CPU.
- profiling.kernel_category files the kernels' CUDA names.
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from refnerf_tpu_torch.tools import bench_render
from refnerf_tpu_torch.tools import downsample_images
from refnerf_tpu_torch.tools import profile_step
from refnerf_tpu_torch.utils import io as io_lib
from refnerf_tpu_torch.utils import profiling

TINY = ['NerfMLP.net_width = 16', 'NerfMLP.net_width_viewdirs = 16',
        'NerfMLP.bottleneck_width = 8', 'Model.num_prop_samples = 4',
        'Model.num_nerf_samples = 4']
BINDINGS = [a for b in TINY for a in ('--bindings', b)]


def test_downsample_images_matches_the_jax_tool(tmp_path):
  from tools.downsample_images import downsample_scene as jdownsample
  rng = np.random.RandomState(0)
  scenes = [tmp_path / 'jax', tmp_path / 'port']
  for scene in scenes:
    (scene / 'images').mkdir(parents=True)
  for i in range(3):
    img = rng.randint(0, 256, (17, 13, 3)).astype(np.uint8)  # odd dims
    for scene in scenes:
      Image.fromarray(img).save(str(scene / 'images' / f'im_{i}.png'))
  assert jdownsample(str(scenes[0]), [2, 4]) == 6
  assert downsample_images.main([str(scenes[1]), '--factors', '2,4']) == 6
  for factor in (2, 4):
    names = sorted(os.listdir(scenes[0] / f'images_{factor}'))
    assert names == sorted(os.listdir(scenes[1] / f'images_{factor}'))
    assert len(names) == 3
    for name in names:
      want, got = (open(s / f'images_{factor}' / name, 'rb').read()
                   for s in scenes)
      assert got == want, (factor, name)
    small = io_lib.load_img(str(scenes[1] / f'images_{factor}' / names[0]))
    assert small.shape == (17 // factor, 13 // factor, 3)


def test_downsample_images_needs_images(tmp_path):
  with pytest.raises(FileNotFoundError, match='images'):
    downsample_images.downsample_scene(str(tmp_path), [2])


def _last_json(out):
  return json.loads(out.strip().splitlines()[-1])


def test_bench_render_prints_its_line(capsys):
  out = bench_render.main(['--device', 'cpu', '--res', '4', '--frames', '1',
                           '--chunk', '8'] + BINDINGS)
  line = _last_json(capsys.readouterr().out)
  assert line == out
  assert line['metric'] == 'render_rays_per_sec' and line['value'] > 0
  assert line['resolution'] == 4 and line['seconds_per_frame'] > 0
  assert line['device'] == 'cpu'


def test_profile_step_prints_its_split(capsys):
  out = profile_step.main(['--device', 'cpu', '--steps', '1', '--batch', '8',
                           '--mode', 'f32'] + BINDINGS)
  text = capsys.readouterr().out
  line = _last_json(text)
  assert line['ms_per_step'] > 0 and line['rays_per_sec'] > 0
  assert line['traced_ms_per_step'] > 0
  assert line['mode'] == 'f32' and line['batch'] == 8
  split = line['device_ms_per_step']
  cats = profiling.TRUNK_KERNELS + (profiling.WGRAD, profiling.OTHER,
                                    profiling.COPIES)
  assert set(cats) < set(split) and split['busy'] == 0
  assert split['idle share'] is None and split['wall'] > 0
  assert 'ms/step' in text and np.isfinite(out['loss'])


@pytest.mark.parametrize('name,cat', [
    ('void (anonymous namespace)::trunk_fwd_tma_kernel<256, 128, true>'
     '(FwdParams, FwdMaps)', 'trunk_fwd_tma_kernel'),
    ('trunk_fwd_kernel<float, 256>(FwdParams)', 'trunk_fwd_kernel'),
    ('void trunk_bwd_f32_kernel<256, 0, false>(BwdParams, MapsF32)',
     'trunk_bwd_f32_kernel'),
    ('void wgrad_tma_kernel<1>(WgradTma, WgradMaps)', profiling.WGRAD),
    ('reduce_kernel(float const*, int, int, int, int, float*, int)',
     profiling.WGRAD),
    ('Memcpy HtoD (Pageable -> Device)', profiling.COPIES),
    ('void at::native::vectorized_elementwise_kernel<4>(int)',
     profiling.OTHER)])
def test_kernel_categories(name, cat):
  assert profiling.kernel_category(name) == cat
