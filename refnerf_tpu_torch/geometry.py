"""Mesh extraction from a trained density field (counterpart of
refnerf_tpu/geometry.py).

The NerfMLP's density is evaluated on a 3D lattice through its spatial
stage, and the isosurface is extracted as a triangle mesh with
density-gradient normals, written as PLY.

The spatial stage is the MLP's own, routed as in a request
(`MLP.spatial_stage`): on the card the spatial trunk kernel (K1,
`fused_mlp.fused_encoded_trunk`) runs the density grid with the density
head and the f32 heads but no bottleneck (a compute-dtype head of 0), and
the vertex colours with the heads a request runs, reading the f32 diffuse
head; on the CPU and under `fused_trunk='off'` its plain version does, and
a trunk without the fused formulation runs the plain layer stack (the
twin of JAX's `MLP.predict_density`). Each point is a Gaussian of diagonal
covariance `var` lifted onto the MLP's basis as JAX lifts it
(`coord.lift_and_diagonalize` of means [n, 1, 3] and covariances
[n, 1, 3]). Rows are independent, so the chunk size does not change the
grid and the last chunk is not padded.

Isosurfacing is marching tetrahedra: each grid cell splits into 6
tetrahedra around its main diagonal, and the 16 per-tet cases are derived
from the inside/outside bit pattern (one triangle for 1 or 3 inside
corners, a split quad for 2). The 6-tet decomposition is face-consistent
across neighbouring cells, so the surface is crack-free. Triangles are
oriented afterwards against the interpolated density gradient (outward =
decreasing density), which also gives per-vertex normals. It runs on the
host in numpy, as JAX's does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from refnerf_tpu_torch.ops import image as image_ops

# Cube corners in bit order (x, y, z).
_CORNERS = np.array([
    [0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
    [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.int64)

# Face-consistent 6-tetrahedron decomposition around the 0-6 main diagonal:
# every face diagonal it induces coincides with the neighbouring cell's.
_TETS = np.array([
    [0, 1, 2, 6], [0, 2, 3, 6], [0, 3, 7, 6],
    [0, 7, 4, 6], [0, 4, 5, 6], [0, 5, 1, 6]], np.int64)


def _tet_case_table():
  """tris[case] = list of triangles; each triangle = 3 (inside, outside)
  local-corner edge pairs whose iso-crossings form the triangle."""
  table = []
  for case in range(16):
    ins = [i for i in range(4) if case >> i & 1]
    outs = [i for i in range(4) if not case >> i & 1]
    if len(ins) == 1:
      e = [(ins[0], o) for o in outs]
      tris = [(e[0], e[1], e[2])]
    elif len(ins) == 3:
      e = [(i, outs[0]) for i in ins]
      tris = [(e[0], e[1], e[2])]
    elif len(ins) == 2:
      (i1, i2), (o1, o2) = ins, outs
      a, b, c, d = (i1, o1), (i1, o2), (i2, o1), (i2, o2)
      tris = [(a, b, c), (c, b, d)]
    else:
      tris = []
    table.append(tris)
  return table


_CASES = _tet_case_table()


def marching_tetrahedra(grid, iso, origin=(0., 0., 0.), spacing=1.0):
  """Extract the `grid > iso` isosurface as a vertex-deduplicated mesh.

  Args:
    grid: [nx, ny, nz] scalar field sampled on a regular lattice.
    iso: isovalue.
    origin: world position of grid[0, 0, 0].
    spacing: scalar or [3] lattice step.

  Returns:
    (verts [V, 3] float32 world positions, faces [F, 3] int32 indices,
     normals [V, 3] float32 outward unit normals). Faces wind
    counter-clockwise seen from outside (normal side).
  """
  grid = np.asarray(grid, np.float64)
  nx, ny, nz = grid.shape
  origin = np.asarray(origin, np.float64)
  spacing = np.broadcast_to(np.asarray(spacing, np.float64), (3,))

  # Global vertex ids and flat values.
  flat = grid.ravel()
  ix, iy, iz = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                           np.arange(nz - 1), indexing='ij')
  base = ((ix * ny + iy) * nz + iz).ravel()  # [Ncells] id of corner 0
  corner_gid = (base[:, None]
                + ((_CORNERS[:, 0] * ny + _CORNERS[:, 1]) * nz
                   + _CORNERS[:, 2])[None, :])  # [Ncells, 8]

  edge_keys, edge_tvals, tri_edge_keys = [], [], []
  for tet in _TETS:
    gid = corner_gid[:, tet]                       # [N, 4]
    val = flat[gid]                                # [N, 4]
    case = ((val > iso) @ np.array([1, 2, 4, 8])).astype(np.int64)
    for c in range(1, 15):
      sel = np.nonzero(case == c)[0]
      if sel.size == 0:
        continue
      for tri in _CASES[c]:
        tri_keys = []
        for (a, b) in tri:
          ga, gb = gid[sel, a], gid[sel, b]
          va, vb = val[sel, a], val[sel, b]
          t = (iso - va) / (vb - va)               # va>iso>=vb => finite
          key = (np.minimum(ga, gb).astype(np.int64) * (nx * ny * nz)
                 + np.maximum(ga, gb))
          # Canonical t (measured from the min-gid endpoint) so shared
          # edges dedup to one vertex position.
          edge_keys.append(key)
          edge_tvals.append(np.where(ga <= gb, t, 1.0 - t))
          tri_keys.append(key)
        tri_edge_keys.append(np.stack(tri_keys, axis=-1))  # [n, 3]

  if not tri_edge_keys:
    return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32),
            np.zeros((0, 3), np.float32))

  all_keys = np.concatenate(edge_keys)
  all_t = np.concatenate(edge_tvals)
  tri_keys = np.concatenate(tri_edge_keys, axis=0)   # [F, 3]

  uniq_keys, first = np.unique(all_keys, return_index=True)
  uniq_t = all_t[first]

  def gid_to_xyz(g):
    z = g % nz
    y = (g // nz) % ny
    x = g // (ny * nz)
    return np.stack([x, y, z], axis=-1).astype(np.float64)

  pa = gid_to_xyz(uniq_keys // (nx * ny * nz))
  pb = gid_to_xyz(uniq_keys % (nx * ny * nz))
  verts_lattice = pa + uniq_t[:, None] * (pb - pa)
  verts = (origin + verts_lattice * spacing).astype(np.float32)

  # A triangle's three (inside, outside) corner pairs are distinct lattice
  # edges, so its vertex indices are distinct; corners exactly on the
  # isovalue can still give zero-area slivers, which are kept.
  faces = np.searchsorted(uniq_keys, tri_keys).astype(np.int32)

  # Outward normals: -gradient (density decreases outward), trilinearly
  # interpolated at the vertices; then orient the faces to match.
  grads = np.stack(np.gradient(grid), axis=-1) / spacing  # [nx,ny,nz,3]
  normals = -_trilinear(grads, verts_lattice)
  norm = np.linalg.norm(normals, axis=-1, keepdims=True)
  normals = (normals / np.maximum(norm, 1e-12)).astype(np.float32)

  v0, v1, v2 = (verts[faces[:, i]].astype(np.float64) for i in range(3))
  face_n = np.cross(v1 - v0, v2 - v0)
  face_ref = normals[faces[:, 0]] + normals[faces[:, 1]] + normals[faces[:, 2]]
  flip = (face_n * face_ref).sum(-1) < 0
  faces[flip] = faces[flip][:, [0, 2, 1]]
  return verts, faces, normals


def _trilinear(field, pts):
  """field: [nx, ny, nz, C]; pts: [N, 3] in lattice coords -> [N, C]."""
  nx, ny, nz = field.shape[:3]
  p = np.clip(pts, 0, [nx - 1, ny - 1, nz - 1])
  p0 = np.clip(np.floor(p).astype(np.int64), 0, [nx - 2, ny - 2, nz - 2])
  f = p - p0
  out = 0.0
  for dx in (0, 1):
    for dy in (0, 1):
      for dz in (0, 1):
        w = ((f[:, 0] if dx else 1 - f[:, 0])
             * (f[:, 1] if dy else 1 - f[:, 1])
             * (f[:, 2] if dz else 1 - f[:, 2]))
        out = out + w[:, None] * field[p0[:, 0] + dx, p0[:, 1] + dy,
                                       p0[:, 2] + dz]
  return out


@torch.no_grad()
def spatial_heads(mlp, pts, var, rgb_heads):
  """The spatial stage of `mlp` (`MLP.spatial_stage`, routed as in a
  request) at points pts [n, 3] on its device, each a Gaussian of diagonal
  covariance `var`: (raw density [n] with the density layer's bias, {f32
  head name: [n, width]}). With `rgb_heads` the colour heads and the
  bottleneck run too, as in a request."""
  means = pts[:, None, :]
  _, raw, fh, _ = mlp.spatial_stage(means, torch.full_like(means, var),
                                    rgb_heads, False)
  return raw[:, 0], {k: v[:, 0] for k, v in fh.items()}


def _chunks(pts, device, chunk):
  for i in range(0, pts.shape[0], chunk):
    yield i, torch.from_numpy(pts[i:i + chunk]).to(device)


def density_grid(model, resolution, lower, upper, chunk=2 ** 16):
  """The NerfMLP density on a regular grid, chunk points a launch.

  Each point is a Gaussian whose diagonal covariance matches the lattice
  spacing (the IPE scale a ray sample at that footprint sees), so the field
  is the one training shaped. Returns [R, R, R] float32 densities (after
  the activation, with the density bias).
  """
  mlp = model.nerf_mlp
  device = next(mlp.parameters()).device
  lower = np.asarray(lower, np.float32)
  upper = np.asarray(upper, np.float32)
  spacing = (upper - lower) / (resolution - 1)
  var = float(np.float32((spacing.mean() / 2.0) ** 2))
  axes = [np.linspace(lower[i], upper[i], resolution, dtype=np.float32)
          for i in range(3)]
  pts = np.stack(np.meshgrid(*axes, indexing='ij'), axis=-1).reshape(-1, 3)
  out = np.empty((pts.shape[0],), np.float32)
  for i, block in _chunks(pts, device, chunk):
    raw, _ = spatial_heads(mlp, block, var, rgb_heads=False)
    sigma = mlp.density_activation(raw + mlp.cfg.density_bias)
    out[i:i + block.shape[0]] = sigma.cpu().numpy()
  return out.reshape(resolution, resolution, resolution)


def vertex_colors(model, verts, footprint, chunk=2 ** 16):
  """Per-vertex diffuse albedo from the spatial stage (view-independent).

  Ref-NeRF's diffuse head is the texture a mesh wants: sigmoid(raw - log 3)
  (with the model's sRGB mapping), no view direction involved. Returns
  [V, 3] float32 in [0, 1], or None when the model has no diffuse head.
  """
  mlp = model.nerf_mlp
  c = mlp.cfg
  if not (c.use_diffuse_color and not c.disable_rgb):
    return None
  device = next(mlp.parameters()).device
  var = float(np.float32((float(footprint) / 2.0) ** 2))
  verts = np.asarray(verts, np.float32)
  out = np.empty((verts.shape[0], 3), np.float32)
  for i, block in _chunks(verts, device, chunk):
    _, fh = spatial_heads(mlp, block, var, rgb_heads=True)
    d = torch.sigmoid(fh['diffuse'] - math.log(3.0))
    if c.srgb_mapping:
      d = image_ops.clip01(image_ops.linear_to_srgb(d))
    out[i:i + block.shape[0]] = d.cpu().numpy()
  return out


def extract_mesh(model, resolution=128, lower=(-1.5, -1.5, -1.5),
                 upper=(1.5, 1.5, 1.5), iso=25.0, chunk=2 ** 16,
                 colors=True):
  """density_grid + marching_tetrahedra (+ diffuse vertex colours) in world
  coordinates.

  iso = 25 is JAX's calibration (refnerf_tpu/geometry.py:282-290): the
  isovalue where a sample interval of ~0.03 scene units saturates
  (1 - exp(-25 * 0.03) ~ 0.53). iso=None picks the grid midpoint: a
  crossing for any untrained field, not a good surface.
  """
  grid = density_grid(model, resolution, lower, upper, chunk=chunk)
  if iso is None:
    iso = float(grid.min() + grid.max()) / 2
  lower = np.asarray(lower, np.float32)
  upper = np.asarray(upper, np.float32)
  spacing = (upper - lower) / (resolution - 1)
  verts, faces, normals = marching_tetrahedra(grid, iso, lower, spacing)
  out = {'verts': verts, 'faces': faces, 'normals': normals, 'grid': grid,
         'colors': None}
  if colors and len(verts):
    out['colors'] = vertex_colors(model, verts,
                                  footprint=float(spacing.mean()),
                                  chunk=chunk)
  return out


def write_ply(path, verts, faces, normals=None, colors=None, comments=()):
  """Binary little-endian PLY with optional per-vertex normals and colours
  (colours as uchar r/g/b, the convention DCC tools expect) and header
  comments (one line each)."""
  verts = np.asarray(verts, '<f4')
  faces = np.asarray(faces, np.int32)
  props = ['property float x', 'property float y', 'property float z']
  cols = [verts]
  if normals is not None:
    props += ['property float nx', 'property float ny', 'property float nz']
    cols.append(np.asarray(normals, '<f4'))
  float_bytes = 4 * len(cols) * 3
  vrow = np.concatenate(cols, axis=-1).astype('<f4').view(np.uint8).reshape(
      len(verts), float_bytes)
  if colors is not None:
    props += ['property uchar red', 'property uchar green',
              'property uchar blue']
    rgb8 = np.clip(np.round(np.asarray(colors) * 255), 0, 255).astype(np.uint8)
    vrow = np.concatenate([vrow, rgb8], axis=-1)
  header = '\n'.join(
      ['ply', 'format binary_little_endian 1.0'] +
      [f'comment {c}' for c in comments] +
      [f'element vertex {len(verts)}'] + props +
      [f'element face {len(faces)}',
       'property list uchar int vertex_indices', 'end_header', ''])
  fdata = np.empty(len(faces), dtype=[('n', 'u1'), ('idx', '<i4', (3,))])
  fdata['n'] = 3
  fdata['idx'] = faces
  with open(path, 'wb') as f:
    f.write(header.encode('ascii'))
    f.write(vrow.tobytes())
    f.write(fdata.tobytes())


def read_ply(path):
  """Read back a PLY written by write_ply (or by JAX's): verts, faces, and
  where the file has them normals, colours and the header comments."""
  with open(path, 'rb') as f:
    data = f.read()
  head_end = data.index(b'end_header\n') + len(b'end_header\n')
  head = data[:head_end].decode('ascii').splitlines()
  n_verts = int(next(l.split()[-1] for l in head
                     if l.startswith('element vertex')))
  n_faces = int(next(l.split()[-1] for l in head
                     if l.startswith('element face')))
  n_floats = sum(1 for l in head if l.startswith('property float'))
  n_uchar = sum(1 for l in head if l.startswith('property uchar')
                and 'list' not in l)
  row_bytes = 4 * n_floats + n_uchar
  vbytes = n_verts * row_bytes
  rows = np.frombuffer(data[head_end:head_end + vbytes],
                       np.uint8).reshape(n_verts, row_bytes)
  v = rows[:, :4 * n_floats].copy().view('<f4')
  fdt = np.dtype([('n', 'u1'), ('idx', '<i4', (3,))])
  fc = np.frombuffer(data[head_end + vbytes:], fdt, count=n_faces)
  out = {'verts': v[:, :3], 'faces': fc['idx'].copy()}
  comments = [l[len('comment '):] for l in head if l.startswith('comment ')]
  if comments:
    out['comments'] = comments
  if n_floats >= 6:
    out['normals'] = v[:, 3:6]
  if n_uchar >= 3:
    out['colors'] = rows[:, 4 * n_floats:4 * n_floats + 3].astype(
        np.float32) / 255.0
  return out
