"""Serving export: single-file, weight-embedded render programs (counterpart
of refnerf_tpu/serving.py).

`export_serving` turns a Model into one artifact that renders a fixed chunk
of rays: the render of the final level, traced by `torch.export` with the
trained weights embedded as constants, so the serving host needs no
checkpoint and no gin config. `ServingModel` renders exactly `chunk` rays a
call and `serve_image` pads a frame onto that chunk, as JAX's do.

How it departs from the JAX artifact:

- **It keeps the hand-written kernels.** JAX forces `fused_trunk='off'` at
  export, because Mosaic custom calls do not survive serialisation. Here the
  trunk forwards are a PyTorch operator of this package
  (`fused_mlp.trunk_forward`, `refnerf_tpu_torch::trunk_forward`), so the
  exported graph holds one node a trunk and a loaded CUDA artifact runs the
  same kernels as the in-process model, counted in `fused_mlp.launches`.
  The kernels' packed weights are built once from the real weights before
  the trace (`mlp.frozen_packs`) and enter the program as constants beside
  the parameters. An artifact exported under `fused_trunk='off'` holds the
  plain PyTorch operations alone.
- **Loading needs torch and this package**, not only torch: the operator is
  registered by importing `ops/fused_mlp.py`, which this module does, and a
  CUDA artifact builds the kernels' libraries (`ops/cuda_build.py`, nvcc)
  at load, before its first request.
- **One device a program**: the program is traced on one device (`cuda` or
  `cpu`), recorded as JAX's `platforms`. A CUDA artifact is never moved onto
  the CPU: loading it on a host without a CUDA device raises.

File format, as JAX's with a magic of its own: 8-byte magic b'RNSRVPT1' +
4-byte little-endian JSON-metadata length + metadata JSON + the
`torch.export.save` archive. Each package's loader refuses the other's
artifact.
"""

from __future__ import annotations

import dataclasses
import io
import json
import struct
import time
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from refnerf_tpu_torch.cameras import rays as rays_lib
from refnerf_tpu_torch.models import mlp as mlp_lib
from refnerf_tpu_torch.ops import fused_mlp  # registers the trunk operator

_MAGIC = b'RNSRVPT1'
_JAX_MAGIC = b'RNSRV001'  # refnerf_tpu/serving.py's artifacts
RAY_FIELDS = tuple(f.name for f in dataclasses.fields(rays_lib.Rays))


class _ChunkProgram(nn.Module):
  """The chunk program as a module of the Rays' fields, for torch.export."""

  def __init__(self, model, compute_extras: bool):
    super().__init__()
    self.model = model
    self.compute_extras = compute_extras

  def forward(self, *fields):
    return serving_render_fn(self.model, self.compute_extras)(
        rays_lib.Rays(**dict(zip(RAY_FIELDS, fields))))


def serving_render_fn(model, compute_extras: bool = False):
  """The chunk program: Rays -> dict of per-ray buffers (final level only).

  `ray_`-prefixed vis bundles are dropped (they subsample rows and mean
  nothing to a server); every other buffer of the final level's rendering
  (rgb, distance*, acc, normals, ...) passes through.
  """

  def fn(rays: rays_lib.Rays) -> Dict[str, torch.Tensor]:
    renderings, _ = model(rays, train_frac=1.0, compute_extras=compute_extras)
    return {k: v for k, v in sorted(renderings[-1].items())
            if not k.startswith('ray_')}

  return fn


def _example_rays(chunk: int, device) -> rays_lib.Rays:
  """`chunk` rays along +z from the origin over [near, far] = [0, 1]."""
  rays = rays_lib.dummy_rays(chunk, device)
  z = torch.zeros(chunk, 3, device=device)
  z[:, 2] = 1.0
  return dataclasses.replace(rays, directions=z, viewdirs=z.clone(),
                             radii=torch.full_like(rays.radii, 1e-3))


def export_serving(model, path: str, chunk: int = 8192, device='cuda',
                   compute_extras: bool = False, near: float = None,
                   far: float = None) -> Dict[str, Any]:
  """Export the render program with weights embedded; returns the metadata.

  Args:
    model: constructed Model (construct.construct_model); it is moved to
      `device` and put in eval mode. Its MLPs' `fused_trunk` decides what
      the program runs: the trunk kernels (as the `trunk_forward` operator)
      on a CUDA device unless 'off', the plain operations otherwise.
    path: output file.
    chunk: rays per call - the static chunk size of the program.
    device: where the program runs ('cuda' or 'cpu'), recorded as its
      `platforms`.
    compute_extras: include the full extras buffers (distance stats,
      normals, diffuse/specular) instead of just rgb/distance/acc.
    near/far: the scene's ray bounds (Config.near/far), recorded in the
      metadata so serving hosts can default them per artifact.

  The model runs once on `chunk` rays before the trace: that builds (and on
  the card launches) each trunk's kernel pack, which the trace then takes
  from the cache (`mlp.frozen_packs`).
  """
  device = torch.device(device)
  model = model.to(device).eval()
  program = _ChunkProgram(model, bool(compute_extras))
  example = _example_rays(chunk, device)
  args = tuple(getattr(example, f) for f in RAY_FIELDS)
  with torch.no_grad():
    program(*args)
    with mlp_lib.frozen_packs(model):
      exported = torch.export.export(program, args, strict=False)
  # Buffer names/shapes come from the export itself - no second trace.
  outputs = next(n for n in exported.graph.nodes if n.op == 'output')
  vals = [a.meta['val'] for a in outputs.args[0]]
  out_info = torch.utils._pytree.tree_unflatten(
      vals, exported.call_spec.out_spec)
  trunks = {}
  for _, which, _ in fused_mlp.trunk_op_nodes(exported.graph):
    trunks[which] = trunks.get(which, 0) + 1
  meta = {
      'chunk': chunk,
      'platforms': [device.type],
      'compute_extras': bool(compute_extras),
      'buffers': {k: [list(v.shape), str(v.dtype).replace('torch.', '')]
                  for k, v in sorted(out_info.items())},
      'trunk_ops': trunks,
  }
  if near is not None:
    meta['near'] = float(near)
  if far is not None:
    meta['far'] = float(far)
  blob = io.BytesIO()
  torch.export.save(exported, blob)
  header = json.dumps(meta).encode('utf-8')
  with open(path, 'wb') as f:
    f.write(_MAGIC)
    f.write(struct.pack('<I', len(header)))
    f.write(header)
    f.write(blob.getvalue())
  return meta


class ServingModel:
  """A loaded serving artifact: __call__ renders one fixed-size chunk."""

  def __init__(self, exported, meta: Dict[str, Any]):
    self.exported = exported
    self.meta = meta
    self.chunk = int(meta['chunk'])
    self.device = torch.device(meta['platforms'][0])
    self._module = exported.module()

  def __call__(self, rays: rays_lib.Rays) -> Dict[str, torch.Tensor]:
    if rays.origins.shape[0] != self.chunk:
      raise ValueError(
          f'this artifact renders exactly {self.chunk} rays per call, '
          f'got {rays.origins.shape[0]}; use serve_image for frames.')
    with torch.no_grad():
      return self._module(*(getattr(rays, f).to(self.device)
                            for f in RAY_FIELDS))

  def serve_image(self, rays: rays_lib.Rays) -> Dict[str, np.ndarray]:
    """Render a full [H, W] frame by padding onto the chunk program; the
    buffers come back as [H, W, ...] numpy arrays."""
    height, width = rays.origins.shape[:2]
    num_rays = height * width
    flat = rays.reshape(num_rays)
    padded_n = -(-num_rays // self.chunk) * self.chunk
    flat, _ = rays_lib.pad_rays_to(flat, padded_n)
    outs = [self(flat[i:i + self.chunk])
            for i in range(0, padded_n, self.chunk)]
    merged = {}
    for k in outs[0]:
      v = torch.cat([o[k] for o in outs])[:num_rays].cpu().numpy()
      merged[k] = v.reshape((height, width) + v.shape[1:])
    return merged


def _read(path: str):
  """(metadata, program bytes) of an artifact; ValueError if malformed."""
  with open(path, 'rb') as f:
    magic = f.read(len(_MAGIC))
    if magic != _MAGIC:
      what = (' (a refnerf_tpu JAX artifact: load it with '
              'refnerf_tpu.serving)' if magic == _JAX_MAGIC else '')
      raise ValueError(f'{path} is not a refnerf_tpu_torch serving artifact '
                       f'(bad magic {magic!r}){what}')
    raw_len = f.read(4)
    if len(raw_len) != 4:
      raise ValueError(f'{path} is truncated (no metadata length)')
    (hlen,) = struct.unpack('<I', raw_len)
    header = f.read(hlen)
    if len(header) != hlen:
      raise ValueError(
          f'{path} is truncated (metadata: {len(header)}/{hlen} bytes)')
    try:
      meta = json.loads(header.decode('utf-8'))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
      raise ValueError(f'{path} has corrupt metadata: {e}') from e
    blob = f.read()
  if not blob:
    raise ValueError(f'{path} is truncated (no program payload)')
  return meta, blob


def load_serving(path: str) -> ServingModel:
  """Load an artifact written by export_serving.

  Raises ValueError for anything malformed (bad magic, truncation, corrupt
  metadata) - one error contract for all broken artifacts - and
  RuntimeError for a CUDA artifact on a host without a CUDA device. A CUDA
  artifact whose program holds trunk operators builds their kernels'
  libraries here, before the first request.
  """
  meta, blob = _read(path)
  platforms = meta.get('platforms') or ['cpu']
  if platforms[0] == 'cuda' and not torch.cuda.is_available():
    raise RuntimeError(f'{path} was exported for cuda, and no CUDA device is '
                       'available on this host')
  t0 = time.perf_counter()
  try:
    exported = torch.export.load(io.BytesIO(blob))
  except Exception as e:  # the archive's own errors vary by torch version
    raise ValueError(f'{path} has a corrupt program payload: {e}') from e
  t1 = time.perf_counter()
  if platforms[0] == 'cuda':
    from refnerf_tpu_torch.ops import cuda_build  # nvcc at first use
    libs = {lib for _, _, lib in fused_mlp.trunk_op_nodes(exported.graph)}
    for lib in sorted(libs | {'trunk_fwd'} if libs else ()):
      cuda_build.library(lib)
  t2 = time.perf_counter()
  served = ServingModel(exported, meta)
  # Seconds of the load's parts: the program deserialised, the kernels'
  # libraries built or loaded, the module made from the program.
  served.load_seconds = {'program': t1 - t0, 'libraries': t2 - t1,
                         'module': time.perf_counter() - t2}
  return served
