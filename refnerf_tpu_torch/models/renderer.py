"""Chunked serving of ray requests (counterpart of models/renderer.py:22-111
and serving.py:60-75).

A request of any number of rays is padded onto whole fixed-size chunks (the
padding repeats the last ray), each chunk runs the model once, and the final
level's buffers come back with the padding stripped.
"""

from __future__ import annotations

from typing import Dict

import torch

from refnerf_tpu_torch.cameras import rays as rays_lib


@torch.no_grad()
def render_rays(model, rays: rays_lib.Rays,
                chunk_size: int) -> Dict[str, torch.Tensor]:
  """Render a flat bundle of N rays; returns the final level's [N, ...]
  buffers (rgb, diffuse, specular, distance, acc)."""
  num_rays = rays.origins.shape[0]
  padded = -(-num_rays // chunk_size) * chunk_size
  rays, _ = rays_lib.pad_rays_to(rays, padded)
  chunks = []
  for i in range(0, padded, chunk_size):
    renderings, _ = model(rays[i:i + chunk_size])
    chunks.append({k: v for k, v in renderings[-1].items()
                   if not k.startswith('ray_')})
  return {k: torch.cat([c[k] for c in chunks])[:num_rays] for k in chunks[0]}


def render_image(model, rays: rays_lib.Rays,
                 chunk_size: int) -> Dict[str, torch.Tensor]:
  """Render an [H, W] bundle of rays; returns [H, W, ...] buffers."""
  height, width = rays.origins.shape[:2]
  out = render_rays(model, rays.reshape(height * width), chunk_size)
  return {k: v.reshape(height, width, *v.shape[1:]) for k, v in out.items()}
