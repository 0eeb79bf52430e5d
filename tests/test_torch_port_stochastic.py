"""The port's stochastic training paths, statistically and against JAX where
no draw is involved (modelled on tests/test_stochastic_paths.py).

The port draws from torch generators seeded from (Config.seed, step,
stream) (train/sampling.py), JAX from its fold_in keys: the streams differ
(ROADMAP H3), so the draws themselves are held to their distributions
here; tests/test_torch_port_cascade.py holds the model against JAX with
JAX's draws handed in.

- The jitter stays in its bin, and `single_jitter` shares one offset a ray.
- The noise's moments and the background's range.
- The draws depend on (seed, step, stream) alone; the main and the noisy
  forward differ; eval takes none.
- A kill and resume with `Config.randomized = True` through NeRFSystem is
  the uninterrupted run, bit for bit.
- Each weight init's variance against its formula.
- The directional trunk of depth 0 against JAX.
- `MLP.warp_fn` is inert in both packages.
- F9: the random background is one colour a ray on patch-shaped batches.

Statistical bounds are stated at each test: at least 5 standard errors of
the estimate, so a correct draw fails about once in 10^6 runs.
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refnerf_tpu import configs as jconfigs
from refnerf_tpu.models import construct as jconstruct
from refnerf_tpu_torch import configs
from refnerf_tpu_torch import convert
from refnerf_tpu_torch import system
from refnerf_tpu_torch.models import construct
from refnerf_tpu_torch.models import mlp as mlp_lib
from refnerf_tpu_torch.models import renderer
from refnerf_tpu_torch.ops import stepfun
from refnerf_tpu_torch.tools import sphere_scene
from refnerf_tpu_torch.train import sampling
from tests.test_torch_port_cascade import (CASCADE, GIN, SMALL, _Pair,
                                           _close, _params, _rays_np)

torch.set_num_threads(1)


def _draws(seed=0, step=0, stream=sampling.FWD_STREAM):
  return sampling.Draws(seed, step, stream)


@pytest.mark.parametrize('single_jitter', [True, False])
def test_jitter_stays_in_its_bin(single_jitter):
  # Uniform weights over [0, 1]: the CDF is the identity, so the samples
  # are the jittered u. Sample i lies in [i / n, (i + 1) / n) (its bin of
  # width u_max plus max_jitter), and with `single_jitter` every gap
  # between neighbours is exactly the grid's (one offset a ray, 1e-6); the
  # offsets spread over the whole of [0, max_jitter) (their mean within 5
  # standard errors of max_jitter / 2).
  n, rays = 16, 4000
  t = torch.linspace(0, 1, 9).expand(rays, 9)
  logits = torch.zeros(rays, 8)
  jit = _draws().jitter((rays,), n, single_jitter)
  assert jit.shape == (rays, 1 if single_jitter else n)
  m = stepfun.max_jitter(n)
  assert float(jit.min()) >= 0 and float(jit.max()) < m
  mean = float(jit.mean())
  assert abs(mean - m / 2) < 5 * m / math.sqrt(12 * jit.numel())
  s = stepfun.sample(t, logits, n, jitter=jit)
  i = torch.arange(n)
  assert bool((s >= i / n - 1e-6).all() and (s < (i + 1) / n + 1e-6).all())
  gaps = torch.diff(s, dim=-1)
  if single_jitter:
    np.testing.assert_allclose(gaps.numpy(), gaps[:, :1].expand_as(gaps),
                               atol=1e-6)
  else:
    assert float((gaps - gaps[:, :1]).abs().max()) > 1e-3
  # The intervals' fenceposts keep the domain.
  sd = stepfun.sample_intervals(t, logits, n, domain=(0.0, 1.0), jitter=jit)
  assert float(sd.min()) >= 0 and float(sd.max()) <= 1
  assert bool((torch.diff(sd, dim=-1) >= 0).all())


def test_noise_and_background_moments():
  # Standard normal noise: mean within 5 standard errors of 0, variance
  # within 5 of 1 (the variance of a sample variance of a normal is 2 / n).
  # The background uniform on [lo, hi): within it, mean within 5 standard
  # errors of the midpoint.
  n = 200000
  z = _draws(1).normal((n,))
  assert abs(float(z.mean())) < 5 / math.sqrt(n)
  assert abs(float(z.var()) - 1) < 5 * math.sqrt(2 / n)
  bg = _draws(2).background((n // 3, 3), 0.2, 0.7)
  assert bg.shape == (n // 3, 3)
  assert float(bg.min()) >= 0.2 and float(bg.max()) < 0.7
  assert abs(float(bg.mean()) - 0.45) < 5 * 0.5 / math.sqrt(12 * bg.numel())


def test_draws_depend_on_seed_step_and_stream_alone():
  # The same (seed, step, stream) draws the same tensors, in the model's
  # order; another step, seed or stream draws others; the main and the
  # noisy forward take different streams, and the noise angles a third.
  def seq(*key):
    d = sampling.Draws(*key)
    return [d.jitter((5,), 8, True), d.mlp().normal((5, 3)),
            d.background((5, 3), 0.0, 1.0)]
  a, b = seq(0, 7, sampling.FWD_STREAM), seq(0, 7, sampling.FWD_STREAM)
  assert all(torch.equal(x, y) for x, y in zip(a, b))
  for other in (seq(0, 8, sampling.FWD_STREAM), seq(1, 7, sampling.FWD_STREAM),
                seq(0, 7, sampling.NOISY_FWD_STREAM)):
    assert not any(torch.equal(x, y) for x, y in zip(a, other))
  assert len({sampling._NOISE_STREAM, sampling.FWD_STREAM,
              sampling.NOISY_FWD_STREAM}) == 3


@pytest.fixture(scope='module')
def noisy_model():
  config, gin = configs.parse([GIN], CASCADE + SMALL + [
      'NerfMLP.density_noise = 1.0', 'NerfMLP.bottleneck_noise = 0.1',
      'NerfMLP.enable_pred_specular_density = True',
      'Model.bg_intensity_range = (0., 1.)'])
  return config, construct.construct_model(config, gin, 'cpu')


def _port_rays(n, seed):
  from refnerf_tpu_torch.cameras import rays as rays_lib
  return rays_lib.Rays(**{k: torch.tensor(v)
                          for k, v in _rays_np(n, seed).items()})


def test_training_draws_vary_and_eval_takes_none(noisy_model):
  # With the noise and a random background, two training forwards of other
  # draws differ, of the same draws agree; eval (no draws: the renderer)
  # is deterministic, and an MLP in eval ignores the noise even when given
  # draws.
  config, model = noisy_model
  rays = _port_rays(8, 3)
  with torch.no_grad():
    run = lambda key: model(rays, train_frac=0.5, train=True,
                            draws=sampling.Draws(*key))[0][-1]['rgb']
    a, b = run((0, 1, 2)), run((0, 2, 2))
    assert not torch.allclose(a, b)
    assert torch.equal(a, run((0, 1, 2)))
    assert torch.isfinite(a).all()
    e1 = renderer.render_rays(model, rays, 8)['rgb']
    e2 = renderer.render_rays(model, rays, 8)['rgb']
    assert torch.equal(e1, e2)
    # The noise only in training: the NeRF level with draws but train=False
    # is the level without them.
    mlp = model.nerf_mlp
    means = torch.randn(8, 4, 3, generator=torch.Generator().manual_seed(0))
    covs = torch.eye(3).expand(8, 4, 3, 3) * 1e-4
    vd = rays.viewdirs
    x = mlp((means, covs), vd, train=False, draws=_draws(5))
    y = mlp((means, covs), vd, train=False)
    assert torch.equal(x['density'], y['density'])
    assert torch.equal(x['rgb'], y['rgb'])


def test_density_noise_keeps_the_compositing_weights_off(monkeypatch, caplog):
  # JAX's gate (mlp.py:394-408): under density noise K6 does not act, with
  # or without training, logged once as JAX logs it.
  import logging
  config, gin = configs.parse([GIN], CASCADE + SMALL + [
      'NerfMLP.density_noise = 1.0', 'NerfMLP.fuse_compositing = True'])
  model = construct.construct_model(config, gin, 'cpu')
  monkeypatch.setattr(mlp_lib, '_FALLBACK_WARNED', set())
  rays = _port_rays(4, 4)
  with torch.no_grad(), caplog.at_level(logging.WARNING):
    model(rays)
    model(rays, train=True, draws=_draws())
  hits = [m.getMessage() for m in caplog.records
          if 'fuse_compositing inactive' in m.getMessage()]
  assert len(hits) == 1 and 'density_noise == 0' in hits[0]


def test_randomized_kill_and_resume_is_bit_for_bit(tmp_path):
  # H19 for every draw: the draws come from (seed, step, stream), so a run
  # killed after step 2 and resumed to 4 draws what the whole run drew at
  # steps 2 and 3; every parameter and Adam moment equal under torch.equal.
  scene = sphere_scene.make_scene(str(tmp_path / 'scene'), 4, 1, 16)

  def trained(exp, more=()):
    config, gin = configs.parse([GIN], CASCADE + SMALL + [
        'NerfMLP.density_noise = 0.5', 'NerfMLP.bottleneck_noise = 0.1',
        'Model.bg_intensity_range = (0., 1.)',
        f"Config.data_dir = '{scene}'",
        f"Config.checkpoint_dir = '{tmp_path / 'exp'}'",
        f"Config.exp_name = '{exp}'", 'Config.max_steps = 4',
        'Config.checkpoint_every = 2', 'Config.print_every = 2',
        'Config.val_sample_num = 1', 'Config.eval_dataset_limit = 1',
        'Config.render_chunk_size = 64', *more])
    assert config.randomized
    psys = system.NeRFSystem(config, gin, device='cpu')
    psys.train()
    return psys

  whole = trained('whole')
  assert whole.state.step == 4
  assert trained('cut', ['Config.early_exit_steps = 2']).state.step == 2
  resumed = trained('cut')
  assert resumed.state.step == 4 and resumed.state.opt.count == 4
  for k, v in whole.model.state_dict().items():
    assert torch.equal(resumed.model.state_dict()[k], v), k
  for which in ('mu', 'nu'):
    for k, v in getattr(whole.state.opt, which).items():
      assert torch.equal(getattr(resumed.state.opt, which)[k], v), (which, k)
  # F10: the test views' ray bundles of 16 + 1, 16 + 1 and 8 + 1 edges a
  # level go to the showcase as a list of levels (JAX's np.asarray refuses
  # them); the metric files are written.
  from refnerf_tpu_torch.train import checkpoints as ckpt_lib
  resumed.test()
  metrics = os.path.join(ckpt_lib.checkpoint_dir(resumed.config),
                         'test_preds')
  assert 'avg_metrics.txt' in os.listdir(metrics)


@pytest.mark.parametrize('init', sorted(mlp_lib.WEIGHT_INITS))
def test_weight_init_variances(init):
  # JAX's variance_scaling: variance scale / fan (fan_in, or the mean of
  # fan_in and fan_out), uniform on +-sqrt(3 variance) or a normal
  # truncated at 2 standard deviations. The 256 x 504 first layer of a
  # PropMLP: its variance within 5 standard errors of the formula, its
  # extent within the bound, the biases zero. A different generator seed
  # gives different weights.
  config, gin = configs.parse([GIN], CASCADE + [
      f'PropMLP.weight_init = {init!r}', 'NerfMLP.net_depth = 2',
      'NerfMLP.net_depth_viewdirs = 1'])
  model = construct.construct_model(config, gin, 'cpu')
  w = model.prop_mlp.spatial_0.weight.detach().double()
  kind, scale, fan = mlp_lib.WEIGHT_INITS[init]
  n = 504 if fan == 'fan_in' else (504 + 256) / 2
  var = scale / n
  if kind == 'uniform':
    assert float(w.abs().max()) <= math.sqrt(3 * var)
    fourth = 9 * var**2 / 5  # E[w^4] of the uniform
  else:
    assert float(w.abs().max()) <= 2 * math.sqrt(var) / mlp_lib._TRUNC_STD
    fourth = float((w**4).mean())
  se = math.sqrt((fourth - var**2) / w.numel())
  assert abs(float((w**2).mean()) - var) < 5 * se, (float((w**2).mean()), var)
  assert abs(float(w.mean())) < 5 * math.sqrt(var / w.numel())
  assert all(float(l.bias.abs().max()) == 0 for l in model.prop_mlp.children()
             if isinstance(l, torch.nn.Linear))
  other = dataclasses.replace(config, seed=1)
  model2 = construct.construct_model(other, gin, 'cpu')
  assert not torch.equal(model2.prop_mlp.spatial_0.weight, w.float())


def test_depth_zero_directional_trunk_matches_jax():
  # NerfMLP.net_depth_viewdirs = 0: the rgb head reads the concatenated
  # [bottleneck | IDE | n.v] (mlp.py:498-499, :641-650); its parameter tree
  # is JAX's (no viewdir layers, the rgb head on the inputs' width), and the
  # served renders and a train step's losses match JAX's, float32 1e-5.
  from refnerf_tpu.train import step as jstep
  from refnerf_tpu_torch.train import step as step_lib
  from tests.test_torch_port_losses import _jax_step_with_grads
  pair = _Pair(CASCADE + SMALL + ['NerfMLP.net_depth_viewdirs = 0',
                                  'Config.randomized = False'], seed=4)
  sd = pair.model.state_dict()
  assert not any('viewdir' in k for k in sd)
  assert sd['nerf_mlp.rgb.weight'].shape == (3, 16 + 72 + 1)
  jr, _ = pair.jmodel.apply({'params': pair.params}, pair.jbatch.rays,
                            train_frac=0.5, compute_extras=False)
  with torch.no_grad():
    pr, _ = pair.model(pair.batch.rays, train_frac=0.5)
  for k in ('rgb', 'distance', 'acc'):
    _close(pr[-1][k], jr[-1][k], what=k)
  jstate = jstep.create_train_state(pair.jconfig, pair.jmodel, pair.params)
  jstate = jstate.replace(step=jnp.asarray(100000, jnp.int32))
  _, jstats = _jax_step_with_grads(pair.jmodel, pair.jconfig)(jstate,
                                                              pair.jbatch)
  state = step_lib.create_train_state(pair.config, pair.model)
  state.step = 100000
  _, stats = step_lib.make_train_step(pair.model, pair.config)(state,
                                                               pair.batch)
  for k in jstats['losses']:
    np.testing.assert_allclose(float(stats['losses'][k]),
                               float(jstats['losses'][k]), rtol=1e-5,
                               err_msg=k)


def test_warp_fn_is_inert():
  # MLP.warp_fn is declared and never read in JAX (mlp.py:143): binding it
  # changes neither package's parameters nor renders.
  bindings = CASCADE + SMALL + ['Config.randomized = False']
  warped = bindings + ['NerfMLP.warp_fn = @jnp.reciprocal',
                       'PropMLP.warp_fn = @jnp.reciprocal']
  jconfig, jgin = jconfigs.parse([GIN], bindings)
  jmodel = jconstruct.construct_model(jconfig, jgin)
  params = _params(jmodel, 5)
  jconfig_w, jgin_w = jconfigs.parse([GIN], warped)
  jmodel_w = jconstruct.construct_model(jconfig_w, jgin_w)
  assert jmodel_w.nerf_mlp.warp_fn is not None
  p_w = jax.device_get(jconstruct.init_params(jax.random.PRNGKey(5), jmodel_w))
  assert (jax.tree_util.tree_structure(p_w) ==
          jax.tree_util.tree_structure(params))
  from refnerf_tpu.cameras import rays as jrays
  r = _rays_np(6, 6)
  jray = jrays.Rays(**{k: jnp.asarray(v) for k, v in r.items()})
  a = jmodel.apply({'params': params}, jray, 0.5, False)[0][-1]['rgb']
  b = jmodel_w.apply({'params': params}, jray, 0.5, False)[0][-1]['rgb']
  np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
  outs = []
  for bind in (bindings, warped):
    config, gin = configs.parse([GIN], bind)
    model = construct.construct_model(config, gin, 'cpu')
    convert.load_jax_params(model, params)
    with torch.no_grad():
      outs.append(model(_port_rays(6, 6), train_frac=0.5)[0][-1]['rgb'])
  assert model.nerf_mlp.cfg.warp_fn is not None
  assert torch.equal(outs[0], outs[1])
  _close(outs[0], a)


def test_random_background_is_one_colour_a_ray():
  # F9: JAX draws the training background as (weights.shape[0], 3)
  # (model.py:207-214), one colour a ray only for a flat batch; the
  # loaders' patch-shaped batches [n, p, p] (p = 1 for single rays) then
  # broadcast every ray's render against the first axis' n colours:
  # [n, p, n, 3], and the data loss averages n times too many pixels. The
  # port draws weights.shape[:-1] + (3,), multinerf's shape: [n, p, p, 3].
  # On a flat batch both draw the same tensor
  # (test_cascade_steps_match_jax_with_jax_draws).
  from refnerf_tpu.cameras import rays as jrays
  from tests.test_torch_port_cascade import JaxDraws, NOISE
  pair = _Pair(CASCADE + SMALL + NOISE[-1:], n=8, seed=7)
  r = {k: v.reshape((4, 2, 1) + v.shape[1:]) for k, v in
       _rays_np(8, 7).items()}
  key = jax.random.PRNGKey(3)
  jr, _ = pair.jmodel.apply(
      {'params': pair.params}, jrays.Rays(**{k: jnp.asarray(v)
                                             for k, v in r.items()}),
      train_frac=0.5, compute_extras=False, train=True, rng=key)
  from refnerf_tpu_torch.cameras import rays as rays_lib
  with torch.no_grad():
    pr, _ = pair.model(rays_lib.Rays(**{k: torch.tensor(v)
                                        for k, v in r.items()}),
                       train_frac=0.5, train=True, draws=JaxDraws(key))
  assert jr[-1]['rgb'].shape == (4, 2, 4, 3)
  assert pr[-1]['rgb'].shape == (4, 2, 1, 3)
  assert torch.isfinite(pr[-1]['rgb']).all()
