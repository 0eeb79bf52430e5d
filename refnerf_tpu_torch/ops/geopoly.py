"""Geodesic-polyhedron bases for positional-encoding projections.

Host-side numpy, computed once at model construction; the basis matrix becomes
a trace-time constant folded into the MLP's first matmul.

Output contract (parity target: internal/geopoly.py:78 `generate_basis`):
a [n, 3] float32 matrix of unit vectors obtained by tesselating the faces of
an icosahedron or octahedron `angular_tesselation` times, optionally dropping
one vector of every antipodal pair, with the xyz axis order reversed.

The construction here is original: base faces are derived from the mutual
edge-adjacency graph of the polyhedron's vertices (rather than hardcoded face
index tables), subdivision is a single einsum over all faces at once, and
duplicate removal is a vectorized first-occurrence mask.
"""

from __future__ import annotations

import numpy as np


def compute_sq_dist(mat0, mat1=None):
  """Squared Euclidean distance between all pairs of columns of two matrices."""
  if mat1 is None:
    mat1 = mat0
  # ||a-b||^2 = ||a||^2 + ||b||^2 - 2 a.b, clamped against numerical error.
  d = (
      (mat0 * mat0).sum(axis=0)[:, None]
      + (mat1 * mat1).sum(axis=0)[None, :]
      - 2.0 * (mat0.T @ mat1)
  )
  return np.maximum(d, 0.0)


def compute_tesselation_weights(v):
  """Barycentric coordinates of the order-`v` triangular lattice, [T, 3]."""
  if v < 1:
    raise ValueError(f'v {v} must be >= 1')
  # All integer triples (i, j, k) with i + j + k == v, i, j, k >= 0.
  ii, jj = np.meshgrid(np.arange(v + 1), np.arange(v + 1), indexing='ij')
  keep = ii + jj <= v
  i, j = ii[keep], jj[keep]
  return np.stack([i, j, v - i - j], axis=-1) / v


def _dedup_rows(points, eps):
  """Keep the first occurrence of each cluster of points within sqrt(eps)."""
  sq = compute_sq_dist(points.T)
  # A row is a duplicate iff some STRICTLY EARLIER row lies within eps.
  dup = np.any(np.tril(sq <= eps, k=-1), axis=1)
  return points[~dup]


def _mutually_adjacent_triples(verts):
  """Faces of a convex regular polyhedron from its edge-adjacency graph.

  Two vertices are adjacent iff their distance equals the minimum pairwise
  distance (the edge length); every 3-clique of that graph is a face.
  """
  sq = compute_sq_dist(verts.T)
  np.fill_diagonal(sq, np.inf)
  adj = sq < sq.min() * (1 + 1e-6)
  clique3 = adj[:, :, None] & adj[:, None, :] & adj[None, :, :]
  i, j, k = np.nonzero(clique3)
  keep = (i < j) & (j < k)
  return np.stack([i[keep], j[keep], k[keep]], axis=-1)


def tesselate_geodesic(base_verts, base_faces, v, eps=1e-4):
  """Subdivide each face `v`-fold, project to the sphere, drop duplicates."""
  if not isinstance(v, int):
    raise ValueError(f'v {v} must an integer')
  bary = compute_tesselation_weights(v)  # [T, 3]
  corners = base_verts[base_faces]  # [F, 3, 3]
  pts = np.einsum('tc,fcd->ftd', bary, corners).reshape(-1, 3)
  pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
  # Lattice points on shared edges/vertices appear once per incident face.
  return _dedup_rows(pts, eps)


def generate_basis(base_shape, angular_tesselation, remove_symmetries=True,
                   eps=1e-4):
  """Generate a [n, 3] basis by tesselating a regular polyhedron.

  base_shape: 'icosahedron' or 'octahedron'. 'octahedron' with tesselation 1
  and remove_symmetries=True yields the identity basis (the setting used by
  all shipped Ref-NeRF configs). remove_symmetries drops one member of every
  antipodal (v, -v) pair.
  """
  if base_shape == 'icosahedron':
    # The 12 vertices are the cyclic coordinate permutations of
    # (+-1, 0, +-phi), phi the golden ratio; normalize to the unit sphere.
    phi = (1 + np.sqrt(5)) / 2
    flat = []
    for s1 in (-1.0, 1.0):
      for s2 in (-phi, phi):
        flat += [(s1, 0.0, s2), (0.0, s2, s1), (s2, s1, 0.0)]
    verts = np.array(flat) / np.sqrt(phi + 2)
  elif base_shape == 'octahedron':
    verts = np.concatenate([-np.eye(3), np.eye(3)], axis=0)
  else:
    raise ValueError(f'base_shape {base_shape} not supported')

  faces = _mutually_adjacent_triples(verts)
  verts = tesselate_geodesic(verts, faces, angular_tesselation, eps)

  if remove_symmetries:
    # Keep vertex i unless some vertex at an index < i is its antipode.
    antipodal = compute_sq_dist(verts.T, -verts.T) < eps
    shadowed = np.any(np.tril(antipodal, k=-1), axis=1)
    verts = verts[~shadowed]

  # Reverse the axis order (multinerf's zyx convention for this basis).
  return verts[:, ::-1].astype(np.float32)
