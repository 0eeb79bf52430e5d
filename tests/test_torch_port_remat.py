"""`Model.remat` in the port, on the CPU.

JAX wraps each MLP in nn.remat (construct.py:36-44); the port runs each
level's MLP call under torch.utils.checkpoint (non-reentrant), so its
activations are recomputed in the backward instead of kept
(models/model.py).

- A step with `Model.remat = True` is the step without it, bit for bit: the
  flagship cut of tests/test_torch_port_train.py, the same on the plain
  layer stack (depth 5, skip 4), and the proposal cascade
  with a PropMLP, randomized with density and bottleneck noise and random
  backgrounds (the MLP's noise is drawn once and given again to each
  recompute).
- The same step against JAX's with `Model.remat = True` bound (JAX's
  trunks in interpret mode), at the tolerances of
  test_train_step_matches_jax: losses and psnr 1e-5 relative, each
  gradient before clipping 2e-4 of its largest entry, the parameters 2e-2
  of their largest move.
- The parameter tree is unchanged (JAX's and the port's).
- How often each level's MLP runs: once without remat or without a graph;
  with remat twice a step where the MLP takes no inner gradient (the
  PropMLP, and every trunk of the fused formulation), three times where the
  plain layer stack (a trunk that ends in a skip concat, F4) takes the
  density gradient inside it (ROADMAP H22).
- The kernel route, with the trunk kernels stubbed by the plain versions
  (as tests/test_torch_port_cascade.py stubs them): every forward launch
  twice a step under remat, the backward launches once, the step bit for
  bit.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refnerf_tpu import configs as jconfigs
from refnerf_tpu.cameras import rays as jrays
from refnerf_tpu.models import construct as jconstruct
from refnerf_tpu.train import step as jstep
from refnerf_tpu_torch import configs
from refnerf_tpu_torch import convert
from refnerf_tpu_torch.cameras import rays as rays_lib
from refnerf_tpu_torch.models import construct
from refnerf_tpu_torch.models import mlp as mlp_lib
from refnerf_tpu_torch.ops import fused_mlp
from refnerf_tpu_torch.train import step as step_lib
from tests import test_torch_port_cascade as cascade_tests
from tests import test_torch_port_train as train_tests

GIN = train_tests.GIN
SMALL = train_tests.SMALL + ["NerfMLP.fused_trunk = 'on'"]
# Trunks that end in a skip concat run the plain layer stack (F4), which
# takes the density gradient with an inner autograd.grad.
PLAIN_STACK = ['NerfMLP.net_depth = 5', 'NerfMLP.net_depth_viewdirs = 5',
               'NerfMLP.skip_layer = 4']
CASCADE = (cascade_tests.CASCADE + cascade_tests.SMALL + cascade_tests.NOISE)
REMAT = ['Model.remat = True']


def _batch(n, seed):
  b = train_tests._batch_np(n, seed)
  rays = rays_lib.dummy_rays(n)
  for k, v in b.items():
    if k != 'rgb':
      setattr(rays, k, train_tests._t(v))
  return b, rays_lib.Batch(rays=rays, rgb=train_tests._t(b['rgb']))


def _steps(bindings, n_steps=2, params=None):
  """`n_steps` port steps from the model's seed (or JAX's `params`): the
  stats and the parameters after each."""
  config, gin = configs.parse([GIN], bindings)
  model = construct.construct_model(config, gin, 'cpu')
  if params is not None:
    convert.load_jax_params(model, params)
  _, batch = _batch(12, seed=0)
  state = step_lib.create_train_state(config, model)
  train = step_lib.make_train_step(model, config)
  out = []
  for _ in range(n_steps):
    state, stats = train(state, batch)
    out.append((stats, {k: p.detach().clone()
                        for k, p in state.params().items()}))
  return model, out


@pytest.mark.parametrize('bindings', [SMALL, SMALL + PLAIN_STACK, CASCADE],
                         ids=['flagship', 'plain_stack', 'cascade'])
def test_remat_step_is_the_step_bit_for_bit(bindings):
  model, plain = _steps(bindings)
  remat_model, remat = _steps(bindings + REMAT)
  assert remat_model.remat and not model.remat
  for (s0, p0), (s1, p1) in zip(plain, remat):
    assert torch.equal(s0['loss'], s1['loss'])
    for k, v in s0['losses'].items():
      assert torch.equal(v, s1['losses'][k]), k
    for k in ('grad_norms', 'grad_maxes'):
      for name, v in s0[k].items():
        assert torch.equal(v, s1[k][name]), (k, name)
    for k, v in p0.items():
      assert torch.equal(v, p1[k]), k


def test_remat_step_matches_jax():
  bindings = SMALL + REMAT
  params = train_tests._init_params(bindings)
  jconfig, jgin = jconfigs.parse([GIN], bindings)
  jmodel = jconstruct.construct_model(jconfig, jgin)
  b, batch = _batch(12, seed=0)
  jbatch = jrays.Batch(
      rays=jrays.dummy_rays(12).replace(**{k: jnp.asarray(v) for k, v in
                                           b.items() if k != 'rgb'}),
      rgb=jnp.asarray(b['rgb']))
  jstate = jstep.create_train_state(jconfig, jmodel, params)
  jtrain = jax.jit(jstep.make_train_step(jmodel, jconfig))
  jgrads = jax.jit(jax.grad(train_tests._jax_loss_fn(
      jmodel, jconfig, jbatch, 0.0)))(jstate.params)

  config, gin = configs.parse([GIN], bindings)
  model = construct.construct_model(config, gin, 'cpu')
  assert model.remat
  convert.load_jax_params(model, params)
  state = step_lib.create_train_state(config, model)
  train = step_lib.make_train_step(model, config)
  _, _, grads = train.loss_and_grads(state, batch)
  want = train_tests._flat(jgrads)
  assert set(grads) == set(want)
  for k, g in grads.items():
    train_tests._assert_grads(g, want[k], 2e-4, k)
  before = {k: v.detach().clone().numpy() for k, v in state.params().items()}
  for step in (1, 2):
    jstate, jstats = jtrain(jstate, jbatch)
    state, stats = train(state, batch)
    for k in stats['losses']:
      np.testing.assert_allclose(float(stats['losses'][k]),
                                 float(jstats['losses'][k]), rtol=1e-5)
    for k in ('loss', 'psnr'):
      np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                 rtol=1e-5)
    jp = train_tests._flat(jax.device_get(jstate.params))
    for k, p in state.params().items():
      moved = max(1e-12, float(np.abs(jp[k] - before[k]).max()))
      np.testing.assert_allclose(p.detach().numpy(), jp[k], rtol=0,
                                 atol=2e-2 * moved, err_msg=k)


def test_remat_keeps_the_parameter_tree():
  for bindings in (SMALL, CASCADE):
    trees = []
    for extra in ([], REMAT):
      jconfig, jgin = jconfigs.parse([GIN], bindings + extra)
      p = jconstruct.init_params(jax.random.PRNGKey(0),
                                 jconstruct.construct_model(jconfig, jgin))
      trees.append({k: v.shape for k, v in train_tests._flat(
          jax.device_get(p)).items()})
      config, gin = configs.parse([GIN], bindings + extra)
      model = construct.construct_model(config, gin, 'cpu')
      assert {k: v.shape for k, v in model.state_dict().items()} == trees[-1]
      convert.load_jax_params(model, jax.device_get(p))
    assert trees[0] == trees[1]


def _count_mlp_calls(monkeypatch):
  calls = collections.Counter()
  forward = mlp_lib.MLP.forward

  def counted(self, *args, **kwargs):
    calls['prop' if self.cfg.disable_rgb else 'nerf'] += 1
    return forward(self, *args, **kwargs)
  monkeypatch.setattr(mlp_lib.MLP, 'forward', counted)
  return calls


@pytest.mark.parametrize('bindings,once,remat', [
    (CASCADE, {'prop': 2, 'nerf': 1}, {'prop': 4, 'nerf': 2}),
    (SMALL + PLAIN_STACK, {'nerf': 2}, {'nerf': 6})],
                         ids=['fused', 'plain_stack'])
def test_remat_reruns_each_level_mlp(monkeypatch, bindings, once, remat):
  # The cascade: 2 proposal levels on the PropMLP (no density gradient) and
  # the NeRF level; the trunk Functions give the density gradient (K3's
  # formulation, in plain PyTorch here): each MLP runs twice under remat.
  # The flagship cut on the plain layer stack (2 levels on one MLP) takes
  # it with an inner autograd.grad, which unpacks the checkpointed
  # activations during the forward already: one recompute more a level
  # (ROADMAP H22).
  calls = _count_mlp_calls(monkeypatch)
  for extra, want in (([], once), (REMAT, remat)):
    calls.clear()
    model, _ = _steps(bindings + extra, n_steps=1)
    assert dict(calls) == want, (extra, dict(calls))
    calls.clear()
    _, batch = _batch(4, seed=1)
    with torch.no_grad():
      model(batch.rays, train=False)
    assert dict(calls) == once


@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
def test_remat_kernel_route_runs_each_forward_twice(monkeypatch, cdt):
  # The trunk kernels stubbed by the plain versions on the pack's own
  # weights (as on a card): under remat every forward launch (the
  # PropMLP's wide-input trunk, K3, K2) runs twice a step and every
  # backward launch once, and the step is the step without remat.
  routes, fwd = cascade_tests._stubbed_kernels(monkeypatch)
  bindings = cascade_tests.CASCADE + [
      'NerfMLP.net_depth = 2', 'NerfMLP.net_depth_viewdirs = 2',
      'NerfMLP.bottleneck_width = 128', 'Model.num_prop_samples = 8',
      'Model.num_nerf_samples = 8', 'Config.batch_size = 4',
      f"NerfMLP.compute_dtype = '{cdt}'", f"PropMLP.compute_dtype = '{cdt}'",
      "NerfMLP.fused_trunk = 'on'", "PropMLP.fused_trunk = 'on'"]
  r = cascade_tests._rays_np(4, 3)
  batch = rays_lib.Batch(
      rays=rays_lib.Rays(**{k: cascade_tests._t(v) for k, v in r.items()}),
      rgb=cascade_tests._t(np.full((4, 3), 0.5, np.float32)))
  runs = {}
  for extra in ((), tuple(REMAT)):
    config, gin = configs.parse([GIN], bindings + list(extra))
    model = construct.construct_model(config, gin, 'cpu')
    state = step_lib.create_train_state(config, model)
    before = dict(fused_mlp.launches)
    fwd.clear()
    state, stats = step_lib.make_train_step(model, config)(state, batch)
    bwd = {k: v - before[k] for k, v in fused_mlp.launches.items() if v != before[k]}
    runs[extra] = (stats, dict(fwd), bwd, model.state_dict())
  (s0, f0, b0, p0), (s1, f1, b1, p1) = runs[()], runs[tuple(REMAT)]
  assert f0 and f1 == {k: 2 * v for k, v in f0.items()}, (f0, f1)
  assert b0 and b1 == b0
  assert f0['K1 wide'] == 2 and f0['K3'] == 1 and f0['K2'] == 1
  assert torch.equal(s0['loss'], s1['loss'])
  for k, v in p0.items():
    assert torch.equal(v, p1[k]), k
