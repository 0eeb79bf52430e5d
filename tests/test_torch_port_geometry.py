"""The port's mesh extraction (refnerf_tpu_torch/geometry.py) against the
JAX package's (refnerf_tpu/geometry.py), on the CPU.

- marching_tetrahedra on seeded random fields (raw and smoothed) and on the
  analytic sphere field: vertices, faces and normals equal to JAX's
  (numpy on both sides, the same operations).
- density_grid and vertex_colors of a small cut of the flagship gin, the
  weights JAX initialised (seeded bias noise added) carried over by
  convert.load_jax_params, at resolution 16: within 1e-5 of JAX's in f32
  (the plain spatial stage: the same products summed in another order);
  the grid of one chunk equals the grid of many; extract_mesh's mesh from
  both packages (the same faces, vertices within 1e-4).
- The spatial trunk kernel's route on the CPU, with use_kernel stubbed as
  on a card and the forward op's CPU implementation (`trunk_plain`)
  stubbed (the stub answers with trunk_reference
  on the pack's own weights): the density grid (the density head and f32
  heads, no bottleneck) and the vertex colours (the heads of a request) at
  the flagship's width go through K1 on trunk_fwd_f32.cu (f32) and
  trunk_fwd_tma.cu (bf16), each with a pack of its own, and agree with the
  plain spatial stage: f32 within 1e-5, and in both dtypes the L2 error
  over the plain field's spread about its mean within the kernel bound of
  tests/test_torch_port_cuda.py (1e-4 f32, 5e-2 bf16).
- That spread check sees planted faults at the flagship's width, where the
  untrained field is nearly flat: the field's mean everywhere and the
  lifted means' x column zeroed read above ten times the bound in both
  dtypes (the second within the bound by the field's own relative L2 in
  bf16).
- The PLY writer and reader: a round trip, and each package reads the
  other's file.
"""

import os

import jax
import numpy as np
import pytest
import torch

from refnerf_tpu import configs as jconfigs
from refnerf_tpu import geometry as jgeometry
from refnerf_tpu.models import construct as jconstruct
from refnerf_tpu_torch import configs
from refnerf_tpu_torch import convert
from refnerf_tpu_torch import geometry
from refnerf_tpu_torch.models import construct
from refnerf_tpu_torch.ops import coord
from refnerf_tpu_torch.ops import fused_mlp

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIN = os.path.join(REPO, 'configs', 'blender_refnerf.gin')
SMALL = ['NerfMLP.net_depth = 4', 'NerfMLP.net_width = 32',
         'NerfMLP.net_depth_viewdirs = 2', 'NerfMLP.net_width_viewdirs = 32',
         'NerfMLP.skip_layer = 2', 'NerfMLP.bottleneck_width = 16']
TOL = 1e-5
KERNEL_BOUND = {'float32': 1e-4, 'bfloat16': 5e-2}  # tests/test_torch_port_cuda.py's
BOX = ((-1.5, -1.5, -1.5), (1.5, 1.5, 1.5))


def _sphere_grid(n=24, r=1.0, extent=1.6):
  ax = np.linspace(-extent, extent, n)
  x, y, z = np.meshgrid(ax, ax, ax, indexing='ij')
  grid = 100.0 / (1.0 + np.exp(-(r - np.sqrt(x * x + y * y + z * z)) / 0.05))
  return grid, (-extent,) * 3, 2 * extent / (n - 1)


def _random_field(seed, smooth):
  rng = np.random.default_rng(seed)
  raw = rng.normal(size=(7, 8, 9))
  if not smooth:
    return raw, 0.3
  fine = np.stack(np.meshgrid(*[np.linspace(0, s - 1, 3 * s) for s in
                                raw.shape], indexing='ij'), axis=-1)
  return (jgeometry._trilinear(raw[..., None], fine.reshape(-1, 3))[:, 0]
          .reshape(fine.shape[:3]), 0.0)


def _assert_same_mesh(got, want):
  for g, w, name in zip(got, want, ('verts', 'faces', 'normals')):
    assert g.dtype == w.dtype and g.shape == w.shape, name
    np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize('seed,smooth', [(0, False), (1, False), (2, True),
                                         (3, True)])
def test_marching_tetrahedra_on_random_fields_is_jax(seed, smooth):
  grid, iso = _random_field(seed, smooth)
  want = jgeometry.marching_tetrahedra(grid, iso, (0.1, -0.2, 0.3), 0.05)
  got = geometry.marching_tetrahedra(grid, iso, (0.1, -0.2, 0.3), 0.05)
  assert len(want[1]) > 100
  _assert_same_mesh(got, want)
  np.testing.assert_array_equal(
      geometry._trilinear(grid[..., None], got[0][:50].astype(np.float64)),
      jgeometry._trilinear(grid[..., None], got[0][:50].astype(np.float64)))


def test_marching_tetrahedra_on_the_sphere_is_jax():
  grid, origin, spacing = _sphere_grid()
  want = jgeometry.marching_tetrahedra(grid, 50.0, origin, spacing)
  got = geometry.marching_tetrahedra(grid, 50.0, origin, spacing)
  _assert_same_mesh(got, want)
  np.testing.assert_allclose(np.linalg.norm(got[0], axis=-1), 1.0,
                             atol=spacing)
  # Empty and full fields give no triangle.
  for field in (np.zeros((5, 5, 5)), np.ones((5, 5, 5))):
    v, f, n = geometry.marching_tetrahedra(field, 0.5)
    assert v.shape == (0, 3) and f.shape == (0, 3) and n.shape == (0, 3)


def _models(seed=0):
  """The small flagship cut in JAX (weights from its init, seeded bias
  noise) and the port's with the same weights."""
  jconfig, jgin = jconfigs.parse([GIN], SMALL)
  jmodel = jconstruct.construct_model(jconfig, jgin)
  params = jax.device_get(jconstruct.init_params(jax.random.PRNGKey(seed),
                                                 jmodel))
  rng = np.random.default_rng(seed)
  params = jax.tree_util.tree_map_with_path(
      lambda path, x: np.asarray(x) + (
          rng.normal(size=x.shape).astype(np.float32) * 0.3
          if path[-1].key == 'bias' else 0.0), params)
  config, gin = configs.parse([GIN], SMALL)
  model = construct.construct_model(config, gin, 'cpu')
  convert.load_jax_params(model, params)
  return jmodel, params, model


def test_density_grid_and_vertex_colors_match_jax():
  jmodel, params, model = _models()
  want = jgeometry.density_grid(jmodel, params, 16, *BOX, chunk=1024)
  got = geometry.density_grid(model, 16, *BOX, chunk=1024)
  assert got.shape == (16, 16, 16) and got.dtype == np.float32
  assert float(want.max() - want.min()) > 0.1  # a field with structure
  np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
  # Rows are independent: one chunk or many give the same grid.
  np.testing.assert_array_equal(
      geometry.density_grid(model, 16, *BOX, chunk=16 ** 3), got)

  verts = np.random.default_rng(1).uniform(-1, 1, (333, 3)).astype(
      np.float32)
  want_c = jgeometry.vertex_colors(jmodel, params, verts, 0.1, chunk=128)
  got_c = geometry.vertex_colors(model, verts, 0.1, chunk=128)
  assert got_c.shape == (333, 3) and (got_c >= 0).all() and (got_c <= 1).all()
  np.testing.assert_allclose(got_c, want_c, rtol=TOL, atol=TOL)


def test_extract_mesh_matches_jax():
  jmodel, params, model = _models(seed=3)
  want = jgeometry.extract_mesh(jmodel, params, resolution=16,
                                lower=BOX[0], upper=BOX[1], iso=None)
  got = geometry.extract_mesh(model, resolution=16, lower=BOX[0],
                              upper=BOX[1], iso=None)
  assert len(got['faces']) > 100
  np.testing.assert_array_equal(got['faces'], want['faces'])
  np.testing.assert_allclose(got['verts'], want['verts'], atol=1e-4)
  np.testing.assert_allclose(got['colors'], want['colors'], rtol=TOL,
                             atol=TOL)
  # JAX's calibrated isovalue, far above this untrained field: no mesh.
  empty = geometry.extract_mesh(model, resolution=8, lower=BOX[0],
                                upper=BOX[1])
  assert len(empty['faces']) == 0 and empty['colors'] is None


def _spread_l2(got, want):
  """|got - want|_2 over want's spread about its mean (per column): an
  untrained field is nearly flat, and its own relative L2 would pass a
  constant."""
  got, want = (np.asarray(a, np.float64).reshape(len(a), -1)
               for a in (got, want))
  return float(np.linalg.norm(got - want)
               / np.linalg.norm(want - want.mean(0)))


@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
def test_spread_check_sees_planted_mesh_faults(cdt):
  # The flagship at full width, random weights: its density and diffuse
  # head are nearly flat, so a constant or a dropped input column passes a
  # bound on the relative L2 but not on the L2 error over the field's
  # spread, the check of the mesh tools' kernel launches.
  config, gin = configs.parse([GIN], [f"NerfMLP.compute_dtype = '{cdt}'"])
  model = construct.construct_model(config, gin, 'cpu')
  mlp = model.nerf_mlp
  pts = torch.from_numpy(np.random.default_rng(6).uniform(
      -1.5, 1.5, (2048, 3)).astype(np.float32))
  var = (3 / 127 / 2) ** 2
  means = pts[:, None, :]
  lm, lv = coord.lift_and_diagonalize(means, torch.full_like(means, var),
                                      mlp.pos_basis_t)
  lv = lv.reshape(lm.shape)
  dropped = lm.clone()
  dropped[..., 0] = 0
  with torch.no_grad():
    want, fh = geometry.spatial_heads(mlp, pts, var, True)
    _, bad, bad_fh, _ = mlp.spatial_stage(means, None, True, False,
                                          lifted=(dropped, lv))
  sigma = lambda raw: mlp.density_activation(raw + mlp.cfg.density_bias)
  pairs = ((sigma(want), sigma(bad[:, 0])),
           (fh['diffuse'], bad_fh['diffuse'][:, 0]))
  for w, b in pairs:
    w, b = w.float().numpy(), b.float().numpy()
    for fault in (b, np.broadcast_to(w.mean(0), w.shape)):
      assert _spread_l2(fault, w) > 10 * KERNEL_BOUND[cdt]
  if cdt == 'bfloat16':  # what the density's relative L2 would have passed
    w, b = (p.float().numpy() for p in pairs[0])
    assert np.linalg.norm(b - w) / np.linalg.norm(w) < KERNEL_BOUND[cdt]


def _pack_weights(pack):
  """A TrunkPack's layers and biases as trunk_reference takes them (each
  layer without the zero columns that pad its segments to kin)."""
  fin, w = sum(pack.seg_dims), pack.width
  ws, off = [], 0
  for l, k in enumerate(pack.k_dims()):
    m = pack.w[off:off + w * k].reshape(w, k)
    off += w * k
    ws.append(m[:, :fin] if l == 0 else m[:, :w + fin] if l == pack.skip
              else m)
  return ws, list(pack.b)


@pytest.mark.parametrize('cdt,lib', [('float32', 'trunk_fwd_f32'),
                                     ('bfloat16', 'trunk_fwd_tma')])
def test_grid_and_colors_take_the_spatial_kernel(monkeypatch, cdt, lib):
  launches = []

  def kernel(segs, pack, fold=None, dir_modes=None, rgbx=None,
             spa_modes=None, comp=None, out_y=False):
    launches.append((segs[0].shape[0], pack.wc is not None,
                     fused_mlp.forward_library(pack, out_y, fold)))
    ws, bs = _pack_weights(pack)
    head = lambda w, b: None if w is None else (w, b)
    return fused_mlp.trunk_reference(
        segs, ws, bs, skip_period=pack.skip - 1, wd=pack.wd,
        head_f32=head(pack.wh, pack.bh), head_cdt=head(pack.wc, pack.bc),
        compute_dtype=pack.compute_dtype, density_grad=fold is not None,
        fold=fold, dir_modes=dir_modes, rgbx=rgbx, spa_modes=spa_modes,
        comp=comp, out_y=out_y)

  config, gin = configs.parse([GIN], [f"NerfMLP.compute_dtype = '{cdt}'",
                                      "NerfMLP.fused_trunk = 'on'"])
  model = construct.construct_model(config, gin, 'cpu')
  verts = np.random.default_rng(2).uniform(-1, 1, (70, 3)).astype(np.float32)
  plain = (geometry.density_grid(model, 5, *BOX),
           geometry.vertex_colors(model, verts, 0.2))
  assert not launches
  monkeypatch.setattr(fused_mlp, 'use_kernel',
                      lambda x, mode: fused_mlp.MODES.index(mode) < 2)
  monkeypatch.setattr(fused_mlp, 'trunk_plain', kernel)
  got = (geometry.density_grid(model, 5, *BOX, chunk=100),
         geometry.vertex_colors(model, verts, 0.2, chunk=64),
         geometry.density_grid(model, 5, *BOX, chunk=100))
  # Two chunks of the grid without the bottleneck, two of the colours with
  # it, then the grid again from its own cached pack.
  assert launches == [(100, False, lib), (25, False, lib), (64, True, lib),
                      (6, True, lib), (100, False, lib), (25, False, lib)]
  for g, p in zip(got, plain + plain[:1]):
    if cdt == 'float32':
      np.testing.assert_allclose(g, p, rtol=0, atol=TOL)
    assert _spread_l2(g, p) <= KERNEL_BOUND[cdt], _spread_l2(g, p)


def test_ply_round_trip_and_interchange(tmp_path):
  grid, origin, spacing = _sphere_grid(n=16)
  v, f, n = geometry.marching_tetrahedra(grid, 50.0, origin, spacing)
  c = np.random.default_rng(4).uniform(0, 1, (len(v), 3)).astype(np.float32)
  for writer, reader, name in ((geometry, geometry, 'port'),
                               (jgeometry, geometry, 'jax to port'),
                               (geometry, jgeometry, 'port to jax')):
    for colors in (None, c):
      path = str(tmp_path / f'{name}{colors is None}.ply')
      writer.write_ply(path, v, f, n, colors=colors)
      back = reader.read_ply(path)
      np.testing.assert_array_equal(back['verts'], v)
      np.testing.assert_array_equal(back['faces'], f)
      np.testing.assert_array_equal(back['normals'], n)
      if colors is None:
        assert 'colors' not in back
      else:
        np.testing.assert_allclose(back['colors'], c, atol=0.5 / 255 + 1e-7)
  with open(str(tmp_path / 'portFalse.ply'), 'rb') as a, \
      open(str(tmp_path / 'jax to portFalse.ply'), 'rb') as b:
    assert a.read() == b.read()
  geometry.write_ply(str(tmp_path / 'bare.ply'), v, f)
  bare = geometry.read_ply(str(tmp_path / 'bare.ply'))
  assert set(bare) == {'verts', 'faces'}
