"""Chunked rendering of ray requests and images (counterpart of
models/renderer.py:22-125 and serving.py:60-75).

A request of any number of rays is padded onto whole fixed-size chunks (the
padding repeats the last ray), each chunk runs the model once, and the final
level's buffers come back with the padding stripped. `render_image` also
keeps each level's ray bundles ('ray_' buffers, with `compute_extras`) and
merges them on the host.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from refnerf_tpu_torch.cameras import rays as rays_lib


def _render_chunks(model, rays: rays_lib.Rays, chunk_size: int,
                   compute_extras: bool = False):
  """The padded bundle through the model a chunk at a time. Returns each
  chunk's final-level buffers and, under 'ray_' keys, a list over levels of
  its ray bundles."""
  num_rays = rays.origins.shape[0]
  padded = -(-num_rays // chunk_size) * chunk_size
  rays, _ = rays_lib.pad_rays_to(rays, padded)
  chunks = []
  for i in range(0, padded, chunk_size):
    renderings, _ = model(rays[i:i + chunk_size],
                          compute_extras=compute_extras)
    chunk = {k: v for k, v in renderings[-1].items()
             if not k.startswith('ray_')}
    for k in renderings[0]:
      if k.startswith('ray_'):
        chunk[k] = [r[k] for r in renderings]
    chunks.append(chunk)
  return chunks


@torch.no_grad()
def render_rays(model, rays: rays_lib.Rays,
                chunk_size: int) -> Dict[str, torch.Tensor]:
  """Render a flat bundle of N rays; returns the final level's [N, ...]
  buffers (rgb, diffuse, specular, distance, acc) on the rays' device."""
  num_rays = rays.origins.shape[0]
  chunks = _render_chunks(model, rays, chunk_size)
  return {k: torch.cat([c[k] for c in chunks])[:num_rays] for k in chunks[0]}


@torch.no_grad()
def render_image(model, rays: rays_lib.Rays, chunk_size: int,
                 compute_extras: bool = False, vis_num_rays: int = 16,
                 fetch: bool = True):
  """Render an [H, W] bundle of rays in chunks of `chunk_size`.

  Returns the final level's buffers as [H, W, ...] CPU tensors; with
  `compute_extras`, also each 'ray_' bundle as a list over levels of
  `vis_num_rays` rays drawn from every chunk's bundles by
  `np.random.default_rng(0)` (the JAX renderer's draw without a key).
  With `fetch=False` it returns a zero-arg `finish()` instead: the device
  work is queued on return, and `finish()` copies the buffers to the host
  and merges them, so that a caller can queue the next image first.
  """
  height, width = rays.origins.shape[:2]
  num_rays = height * width
  chunks = _render_chunks(model, rays.reshape(num_rays), chunk_size,
                          compute_extras)

  def finish():
    rendering = {}
    for k, first in chunks[0].items():
      if isinstance(first, list):
        rendering[k] = [torch.cat([c[k][i] for c in chunks]).cpu()
                        for i in range(len(first))]
      else:
        z = torch.cat([c[k] for c in chunks])[:num_rays].cpu()
        rendering[k] = z.reshape(height, width, *z.shape[1:])
    # A deterministic subsample of the chunks' ray bundles.
    keys = [k for k in rendering if k.startswith('ray_')]
    if keys:
      num_bundle_rays = rendering[keys[0]][0].shape[0]
      ray_idx = torch.from_numpy(np.random.default_rng(0).permutation(
          num_bundle_rays)[:vis_num_rays])
      for k in keys:
        rendering[k] = [r[ray_idx] for r in rendering[k]]
    return rendering

  return finish() if fetch else finish
