"""Chunked rendering of ray requests and images (counterpart of
models/renderer.py:22-125 and serving.py:60-75).

A request of any number of rays is padded onto whole fixed-size chunks (the
padding repeats the last ray), each chunk runs the model once, and the final
level's buffers come back with the padding stripped. `render_image` also
keeps each level's ray bundles ('ray_' buffers, with `compute_extras`) and
merges them on the host.

Under data parallelism (`group`) `render_image` splits every chunk across
the ranks: each renders its rows of the chunk (parallel.mesh.rows_of) and
an all-gather puts the chunk back together on every rank, as JAX shards a
chunk over the mesh (renderer.py:57-66). The caller splits only where the
chunk divides across the ranks (system.py:207-225).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from refnerf_tpu_torch.cameras import rays as rays_lib
from refnerf_tpu_torch.parallel import mesh


def _gather_chunk(chunk, group, vis_num_rays):
  """Every rank's part of a chunk, put back together in rank order through
  one all-gather of a flat f32 buffer: the buffers row by row, and each
  level's ray bundle cut to the first `vis_num_rays` rays, as one rank's
  render of the whole chunk holds them."""
  leaves = [(k, i, t) for k, v in chunk.items()
            for i, t in (enumerate(v) if isinstance(v, list) else [(None, v)])]
  flat = torch.cat([t.reshape(-1).float() for _, _, t in leaves])
  parts = [torch.empty_like(flat) for _ in range(mesh.size(group))]
  dist.all_gather(parts, flat, group=group)
  out = {k: [] if isinstance(v, list) else None for k, v in chunk.items()}
  off = 0
  for k, i, t in leaves:
    rows = torch.cat([p[off:off + t.numel()].reshape(t.shape)
                      for p in parts]).to(t.dtype)
    off += t.numel()
    if i is None:
      out[k] = rows
    else:
      out[k].append(rows[:vis_num_rays])
  return out


def _render_chunks(model, rays: rays_lib.Rays, chunk_size: int,
                   compute_extras: bool = False, train_frac: float = 1.0,
                   group=None):
  """The padded bundle through the model a chunk at a time, at `train_frac`
  (the resampling's annealing, where `Model.anneal_slope > 0`); with a
  group, each rank renders its rows of every chunk and the chunk is
  gathered. Returns each chunk's final-level buffers and, under 'ray_' keys,
  a list over levels of its ray bundles."""
  num_rays = rays.origins.shape[0]
  padded = -(-num_rays // chunk_size) * chunk_size
  rays, _ = rays_lib.pad_rays_to(rays, padded)
  rows = mesh.shard_rows(chunk_size, group)
  chunks = []
  for i in range(0, padded, chunk_size):
    renderings, _ = model(
        rays[i + rows.start:i + rows.stop], train_frac=train_frac,
        compute_extras=compute_extras)
    chunk = {k: v for k, v in renderings[-1].items()
             if not k.startswith('ray_')}
    for k in renderings[0]:
      if k.startswith('ray_'):
        chunk[k] = [r[k] for r in renderings]
    if group is not None:
      chunk = _gather_chunk(chunk, group, model.cfg.vis_num_rays)
    chunks.append(chunk)
  return chunks


@torch.no_grad()
def render_rays(model, rays: rays_lib.Rays, chunk_size: int,
                train_frac: float = 1.0) -> Dict[str, torch.Tensor]:
  """Render a flat bundle of N rays at `train_frac`; returns the final
  level's [N, ...] buffers (rgb, diffuse, specular, distance, acc) on the
  rays' device."""
  num_rays = rays.origins.shape[0]
  chunks = _render_chunks(model, rays, chunk_size, train_frac=train_frac)
  return {k: torch.cat([c[k] for c in chunks])[:num_rays] for k in chunks[0]}


@torch.no_grad()
def render_image(model, rays: rays_lib.Rays, chunk_size: int,
                 compute_extras: bool = False, vis_num_rays: int = 16,
                 fetch: bool = True, train_frac: float = 1.0, group=None):
  """Render an [H, W] bundle of rays in chunks of `chunk_size`, at
  `train_frac` (JAX `make_render_fn(..., train_frac=...)`).

  Returns the final level's buffers as [H, W, ...] CPU tensors; with
  `compute_extras`, also each 'ray_' bundle as a list over levels of
  `vis_num_rays` rays drawn from every chunk's bundles by
  `np.random.default_rng(0)` (the JAX renderer's draw without a key).
  With `fetch=False` it returns a zero-arg `finish()` instead: the device
  work is queued on return, and `finish()` copies the buffers to the host
  and merges them, so that a caller can queue the next image first. On the
  card `finish()` may run on another thread: it waits on an event recorded
  after the last chunk, and copies on the stream that rendered the chunks,
  whatever stream is current on its own thread. With a `group` every rank
  renders its rows of each chunk and gets the whole image; `chunk_size`
  must divide across the ranks.
  """
  height, width = rays.origins.shape[:2]
  num_rays = height * width
  chunks = _render_chunks(model, rays.reshape(num_rays), chunk_size,
                          compute_extras, train_frac, group)
  device = rays.origins.device
  stream = done = None
  if device.type == 'cuda':
    stream = torch.cuda.current_stream(device)
    done = torch.cuda.Event()
    done.record(stream)

  def finish():
    if stream is None:
      return merge()
    done.synchronize()
    with torch.cuda.stream(stream):
      return merge()

  def merge():
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
