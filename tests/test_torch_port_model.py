"""The port's MLP, Model and renderer against the JAX package.

A small cut of configs/blender_refnerf.gin (trunks of depth 4 and width 32,
skip_layer 2, bottleneck 16, 2 levels x 16 samples; the flagship encodings
max_deg_point 16 and deg_view 5) is built by both packages from one gin. The
JAX parameters, with random biases added, go through refnerf_tpu_torch.convert
into the port, and both run on the same numpy rays.

Tolerances. Against the JAX MLP with fused_trunk='on' (the Pallas kernels
in interpret mode, the formulation the port follows), float32 1e-5: sums run
in another order. The whole Model, float32 1e-4: the level-1 resampling
carries level-0 differences into the sample positions. In bfloat16 1e-2: a
bf16 rounding flip in a trunk (2^-8 relative) moves an output by a fraction
of that. Against fused_trunk='off' the JAX package builds the IPE cosine as
sin(m + pi/2), which at degree 15 (|m| near 2^15, f32 spacing 2^-8) is off by
up to ~4e-3 times that feature's attenuation exp(-v/2); 1e-3 there.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refnerf_tpu import configs as jconfigs
from refnerf_tpu.cameras import rays as jrays
from refnerf_tpu.models import construct as jconstruct
from refnerf_tpu.models import render as jrender
from refnerf_tpu.models.mlp import MLP as JaxMLP
from refnerf_tpu_torch import configs
from refnerf_tpu_torch import convert
from refnerf_tpu_torch.cameras import rays as rays_lib
from refnerf_tpu_torch.models import construct
from refnerf_tpu_torch.models import render
from refnerf_tpu_torch.models import renderer

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIN = os.path.join(REPO, 'configs', 'blender_refnerf.gin')
SMALL = [
    'NerfMLP.net_depth = 4', 'NerfMLP.net_width = 32',
    'NerfMLP.net_depth_viewdirs = 4', 'NerfMLP.net_width_viewdirs = 32',
    'NerfMLP.skip_layer = 2', 'NerfMLP.bottleneck_width = 16',
    'Model.num_prop_samples = 16', 'Model.num_nerf_samples = 16',
]


def _bindings(fused='on', cdt='float32'):
  return SMALL + [f"NerfMLP.fused_trunk = '{fused}'",
                  f"NerfMLP.compute_dtype = '{cdt}'"]


def _jax_model(bindings):
  config, gin = jconfigs.parse([GIN], bindings)
  return config, gin, jconstruct.construct_model(config, gin)


def _port_model(bindings):
  config, gin = configs.parse([GIN], bindings)
  return construct.construct_model(config, gin, 'cpu')


def _init_params(bindings, seed=0):
  """JAX parameters of a small model, with random biases, as numpy."""
  _, _, model = _jax_model(bindings)
  p = jax.device_get(jconstruct.init_params(jax.random.PRNGKey(seed), model))
  rng = np.random.default_rng(seed)
  return jax.tree_util.tree_map_with_path(
      lambda path, x: np.asarray(x) + (
          rng.normal(size=x.shape).astype(np.float32) * 0.1
          if path[-1].key == 'bias' else 0.0), p)


@pytest.fixture(scope='module')
def params():
  return _init_params(_bindings())


def _rays_np(n, seed=0):
  rng = np.random.default_rng(seed)
  d = rng.normal(size=(n, 3)).astype(np.float32)
  return dict(
      origins=rng.normal(size=(n, 3)).astype(np.float32) * 0.1,
      directions=d,
      viewdirs=d / np.linalg.norm(d, axis=-1, keepdims=True),
      radii=rng.uniform(1e-3, 1e-2, (n, 1)).astype(np.float32),
      near=np.full((n, 1), 2.0, np.float32),
      far=np.full((n, 1), 6.0, np.float32))


def _port_rays(r):
  n = r['origins'].shape[0]
  return rays_lib.Rays(**{**vars(rays_lib.dummy_rays(n)),
                          **{k: torch.tensor(v) for k, v in r.items()}})


def _jax_rays(r):
  n = r['origins'].shape[0]
  return jrays.dummy_rays(n).replace(**{k: jnp.asarray(v) for k, v in r.items()})


def _close(a, b, tol):
  np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                             rtol=tol, atol=tol)


def test_convert_maps_every_leaf(params):
  model = _port_model(_bindings())
  sd = convert.params_to_state_dict(params)
  n_leaves = len(jax.tree_util.tree_leaves(params))
  assert len(sd) == n_leaves == len(model.state_dict())
  convert.load_jax_params(model, params)
  for layer, leaves in params['nerf_mlp'].items():
    got = getattr(model.nerf_mlp, layer)
    np.testing.assert_array_equal(got.weight.detach().numpy(),
                                  leaves['kernel'].T)
    np.testing.assert_array_equal(got.bias.detach().numpy(), leaves['bias'])
  assert tuple(model.nerf_mlp.spatial_3.weight.shape) == (32, 128)


def test_convert_raises_on_left_over_or_missing_leaves(params):
  model = _port_model(_bindings())
  extra = {'nerf_mlp': {**params['nerf_mlp'],
                        'spatial_9': params['nerf_mlp']['spatial_1']}}
  with pytest.raises(ValueError, match='spatial_9'):
    convert.load_jax_params(model, extra)
  missing = {'nerf_mlp': {k: v for k, v in params['nerf_mlp'].items()
                          if k != 'raw_tint'}}
  with pytest.raises(ValueError, match='raw_tint'):
    convert.load_jax_params(model, missing)
  with pytest.raises(ValueError, match='weights'):
    convert.params_to_state_dict({'nerf_mlp': {'rgb': {'weights': 0}}})


def _gaussians(n_rays=6, s=16, seed=1):
  r = _rays_np(n_rays, seed)
  rng = np.random.default_rng(seed)
  tdist = np.sort(rng.uniform(2, 6, (n_rays, s + 1)), axis=-1).astype(np.float32)
  means, covs = jrender.cast_rays(jnp.asarray(tdist), jnp.asarray(r['origins']),
                                  jnp.asarray(r['directions']),
                                  jnp.asarray(r['radii']), 'cone', diag=False)
  return np.asarray(means), np.asarray(covs), r['viewdirs']


@pytest.mark.parametrize('fused,tol', [('on', 1e-5), ('off', 1e-3)])
def test_mlp_eval_forward_matches_jax(params, fused, tol):
  config, gin, _ = _jax_model(_bindings(fused))
  jmlp = JaxMLP(**jconfigs.mlp_kwargs(gin, 'NerfMLP'))
  means, covs, viewdirs = _gaussians()
  ref = jmlp.apply({'params': params['nerf_mlp']},
                   (jnp.asarray(means), jnp.asarray(covs)),
                   jnp.asarray(viewdirs), None, False)
  model = _port_model(_bindings())
  convert.load_jax_params(model, params)
  with torch.no_grad():
    out = model.nerf_mlp((torch.tensor(means), torch.tensor(covs)),
                         torch.tensor(viewdirs))
  assert set(out) == set(ref)
  assert out['normals'] is None and ref['normals'] is None
  for k in ('density', 'rgb', 'normals_pred', 'grad_pred', 'tint', 'diffuse',
            'specular', 'roughness'):
    _close(out[k], ref[k], tol)


@pytest.mark.parametrize('cdt,tol', [('float32', 1e-4), ('bfloat16', 1e-2)])
def test_slice_matches_jax_model(params, cdt, tol):
  bindings = _bindings('on', cdt)
  _, _, jmodel = _jax_model(bindings)
  r = _rays_np(8, seed=2)
  renderings, _ = jax.jit(lambda p, rays: jmodel.apply(
      {'params': p}, rays, train_frac=1.0, compute_extras=False,
      train=False))(params, _jax_rays(r))
  model = _port_model(bindings)
  convert.load_jax_params(model, params)
  with torch.no_grad():
    port, history = model(_port_rays(r))
  assert len(port) == len(renderings) == 2
  for k in ('rgb', 'acc', 'distance'):
    _close(port[-1][k], renderings[-1][k], tol)
  rgb = port[-1]['rgb']
  assert torch.isfinite(rgb).all() and history[-1]['sdist'].shape == (8, 17)


# Eval-path fields that the flagship gin leaves at one value, each turned in
# a variant of the small gin. The port mirrors these JAX fields, so each
# variant is held against Model.apply like the flagship.
VARIANTS = {
    'view_ide_no_ndotv': ['NerfMLP.use_reflections = False',
                          'NerfMLP.use_n_dot_v = False'],
    'no_tint_linear_rgb': ['NerfMLP.use_specular_tint = False',
                           'NerfMLP.srgb_mapping = False'],
    'specular_density_unnormalized': [
        'NerfMLP.enable_pred_specular_density = True',
        'Config.render_with_specular_density = True',
        'NerfMLP.srgb_mapping_normalization = False'],
    'cylinder_opaque_bg_range': ["Model.ray_shape = 'cylinder'",
                                 'Model.opaque_background = True',
                                 'Model.bg_intensity_range = (0.0, 1.0)'],
    'annealed_no_bottleneck': ['Model.anneal_slope = 10.0',
                               'NerfMLP.bottleneck_width = 0'],
    'no_integration': ['Model.disable_integration = True'],
}


@pytest.mark.parametrize('variant', sorted(VARIANTS))
def test_slice_variants_match_jax_model(variant):
  # float32, 1e-4 as for the flagship slice; train_frac 0.5 so that a
  # nonzero anneal_slope changes the resampling. Without integration the
  # degree-15 features of the final level are undamped: its samples sit
  # ~6e-5 apart in the two packages (the level-0 weights were summed in
  # another order), which moves sin(2^15 m) by up to ~3e-3; level 0 and the
  # MLP on equal inputs agree to 1e-4, so the final level gets 1e-2.
  final_tol = 1e-2 if variant == 'no_integration' else 1e-4
  bindings = _bindings() + VARIANTS[variant]
  params = _init_params(bindings, seed=1)
  _, _, jmodel = _jax_model(bindings)
  r = _rays_np(8, seed=4)
  renderings, jhistory = jax.jit(lambda p, rays: jmodel.apply(
      {'params': p}, rays, train_frac=0.5, compute_extras=False,
      train=False))(params, _jax_rays(r))
  model = _port_model(bindings)
  convert.load_jax_params(model, params)
  with torch.no_grad():
    port, history = model(_port_rays(r), train_frac=0.5)
  for level, tol in enumerate((1e-4, final_tol)):
    assert set(port[level]) == set(renderings[level])
    for k, v in port[level].items():
      _close(v, renderings[level][k], tol)
    extra = set(history[level]) & {'weights', 'specular_weights'}
    assert extra == set(jhistory[level]) & {'weights', 'specular_weights'}
    for k in extra:
      _close(history[level][k], jhistory[level][k], tol)


def test_render_rays_pads_onto_the_chunk(params):
  model = _port_model(_bindings())
  convert.load_jax_params(model, params)
  rays = _port_rays(_rays_np(37, seed=3))
  out = renderer.render_rays(model, rays, 16)  # 3 chunks, 11 rays of padding
  with torch.no_grad():
    whole = model(rays)[0][-1]
  assert set(out) == {'rgb', 'diffuse', 'specular', 'distance', 'acc'}
  for k, v in out.items():
    assert v.shape == whole[k].shape
    np.testing.assert_allclose(v.numpy(), whole[k].numpy(), rtol=1e-6,
                               atol=1e-6)
  image = renderer.render_image(model, rays[:36].reshape(6, 6), 16)
  assert image['rgb'].shape == (6, 6, 3) and image['acc'].shape == (6, 6)
  np.testing.assert_allclose(image['rgb'].reshape(36, 3).numpy(),
                             out['rgb'][:36].numpy(), rtol=1e-6, atol=1e-6)


def test_unported_paths_are_refused():
  with pytest.raises(NotImplementedError, match='raydist_fn'):
    _port_model(_bindings() + ['Model.raydist_fn = @jnp.reciprocal'])
  with pytest.raises(NotImplementedError):
    _port_model(_bindings() + ['Model.dilation_bias = 0.0025'])
  # As the JAX MLP (mlp.py:469-475): no diffuse colour without view
  # directions.
  with pytest.raises(ValueError, match='use_diffuse_color'):
    _port_model(_bindings() + ['Model.use_viewdirs = False'])
  with pytest.raises(ValueError, match='batch_sizee'):
    configs.parse([GIN], ['Config.batch_sizee = 2'])
  config, _ = configs.parse([GIN], [])
  assert (config.near, config.far, config.render_chunk_size) == (2, 6, 4096)
  assert config.batch_size == 1024 and not config.randomized


def test_port_imports_no_jax_and_renders_on_cpu():
  script = textwrap.dedent(f'''
      import sys
      for name in ('jax', 'flax', 'optax', 'absl', 'refnerf_tpu'):
        sys.modules[name] = None
      import numpy as np, torch
      from refnerf_tpu_torch import configs
      from refnerf_tpu_torch.cameras import rays as rays_lib
      from refnerf_tpu_torch.models import construct, renderer
      config, gin = configs.parse([{GIN!r}], {SMALL!r})
      model = construct.construct_model(config, gin, 'cpu')
      rng = np.random.default_rng(0)
      d = torch.tensor(rng.normal(size=(5, 3)).astype(np.float32))
      rays = rays_lib.dummy_rays(5)
      rays.directions, rays.viewdirs = d, d / d.norm(dim=-1, keepdim=True)
      rays.near, rays.far = rays.near + 2, rays.far + 5
      out = renderer.render_rays(model, rays, 4)
      assert torch.isfinite(out['rgb']).all() and out['rgb'].shape == (5, 3)
      bad = [m for m in sys.modules if m.split('.')[0] in
             ('jax', 'flax', 'optax', 'absl', 'refnerf_tpu')
             and sys.modules[m] is not None]
      assert not bad, bad
      print('rendered', tuple(out['rgb'].shape))
  ''')
  env = {**os.environ, 'PYTHONPATH': REPO}
  proc = subprocess.run([sys.executable, '-c', script], cwd=REPO, env=env,
                        capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stderr
  assert 'rendered (5, 3)' in proc.stdout
