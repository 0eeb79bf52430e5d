"""Generate the images_N directories LLFF-style loaders expect
(counterpart of tools/downsample_images.py).

The reference assumes pre-downsampled `images_{factor}` directories exist
next to `images/` (its README points at external LLFF scripts). This tool
creates them with the same area downsample the in-memory path uses
(`data/datasets.py` `downsample_np`), so images_N and factor-in-memory
loading agree exactly:

    python3 -m refnerf_tpu_torch.tools.downsample_images <scene_dir> \
        --factors 2,4,8

Each image is cropped to a multiple of the factor, area-averaged, rounded
to uint8 and written as PNG through Pillow, as JAX's tool writes it (the
same bytes).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from PIL import Image

from refnerf_tpu_torch.data.datasets import (downsample_np, load_img,
                                             parallel_map)


def downsample_scene(scene_dir: str, factors) -> int:
  """Write images_<factor>/ for each factor; returns the images written."""
  src = os.path.join(scene_dir, 'images')
  if not os.path.isdir(src):
    raise FileNotFoundError(f'{src} does not exist')
  names = sorted(os.listdir(src))
  total = 0
  for factor in factors:
    out_dir = os.path.join(scene_dir, f'images_{factor}')
    os.makedirs(out_dir, exist_ok=True)

    def one(name, factor=factor, out_dir=out_dir):
      img = load_img(os.path.join(src, name))
      h, w = img.shape[:2]
      # Crop to divisibility like standard LLFF preprocessing.
      img = img[:h - h % factor, :w - w % factor]
      small = downsample_np(img, factor)
      out = np.clip(np.round(small), 0, 255).astype(np.uint8)
      base = os.path.splitext(name)[0]
      Image.fromarray(out).save(os.path.join(out_dir, base + '.png'))
      return 1

    total += sum(parallel_map(one, names))
    print(f'images_{factor}: {len(names)} images')
  return total


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument('scene_dir')
  p.add_argument('--factors', default='2,4,8',
                 help='comma-separated downsample factors')
  args = p.parse_args(argv)
  factors = [int(f) for f in args.factors.split(',') if f.strip()]
  return downsample_scene(args.scene_dir, factors)


if __name__ == '__main__':
  main()
