"""Every shipped gin takes one train step in the port, as in JAX.

The port's counterpart of tests/test_shipped_configs.py's
test_shipped_config_takes_a_train_step: the same tiny cut (`_TINY` there),
the same rays and pixels, JAX's initial parameters loaded into the port,
and for the gins with the noisy forward, JAX's noise angles handed to the
port's step. Each loss term by name within 1e-5 relative of JAX's (at step
0 the consistency ratio of the geometry gins is 0, so their consistency
terms are exactly 0 in both), the loss and PSNR likewise, and every
parameter after the step within 2e-2 of its largest move (the first Adam
update is ~lr * g / (|g| + eps) with clipped gradients near eps, as in
tests/test_torch_port_train.py).
"""

import glob
import os

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
from refnerf_tpu_torch.train import step as step_lib
from tests.test_shipped_configs import _TINY
from tests.test_torch_port_losses import _flat, _jax_angles

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GINS = sorted(glob.glob(os.path.join(REPO, 'configs', '*.gin')))


def _rays_np(config):
  """tests/test_shipped_configs.py's rays and pixels."""
  b = config.batch_size
  rng = np.random.RandomState(0)
  d = rng.randn(b, 3).astype(np.float32)
  f = lambda v: np.full((b, 1), v, np.float32)
  rays = dict(origins=rng.randn(b, 3).astype(np.float32) * 0.1, directions=d,
              viewdirs=d / np.linalg.norm(d, axis=-1, keepdims=True),
              radii=f(0.01), lossmult=f(1.0), near=f(float(config.near)),
              far=f(float(config.far)))
  return rays, rng.uniform(0, 1, (b, 3)).astype(np.float32)


@pytest.mark.parametrize('gin_file', GINS,
                         ids=[os.path.basename(p) for p in GINS])
def test_shipped_config_takes_a_train_step_in_the_port(gin_file):
  jconfig, jgin = jconfigs.parse([gin_file], [_TINY])
  jmodel = jconstruct.construct_model(jconfig, jgin)
  params = jax.device_get(jconstruct.init_params(jax.random.PRNGKey(0),
                                                 jmodel))
  r, rgb = _rays_np(jconfig)
  jbatch = jrays.Batch(
      rays=jrays.dummy_rays(len(rgb)).replace(
          **{k: jnp.asarray(v) for k, v in r.items()}),
      rgb=jnp.asarray(rgb))
  jstate, jstats = jax.jit(jstep.make_train_step(jmodel, jconfig))(
      jstep.create_train_state(jconfig, jmodel, params), jbatch)

  config, gin = configs.parse([gin_file], [_TINY])
  model = construct.construct_model(config, gin, 'cpu')
  convert.load_jax_params(model, params)
  rays = rays_lib.dummy_rays(len(rgb))
  for k, v in r.items():
    setattr(rays, k, torch.tensor(v))
  batch = rays_lib.Batch(rays=rays, rgb=torch.tensor(rgb))
  state = step_lib.create_train_state(config, model)
  before = _flat(params)
  train = step_lib.make_train_step(
      model, config, noise_angles=lambda step, a, max_angle: torch.tensor(
          _jax_angles(jconfig, step)))
  state, stats = train(state, batch)

  assert state.step == int(jstate.step) == 1
  assert set(stats['losses']) == set(jstats['losses'])
  for k, v in stats['losses'].items():
    np.testing.assert_allclose(float(v), float(jstats['losses'][k]),
                               rtol=1e-5, err_msg=k)
  for k in ('loss', 'psnr'):
    np.testing.assert_allclose(float(stats[k]), float(jstats[k]), rtol=1e-5)
  jparams = _flat(jax.device_get(jstate.params))
  for k, p in state.params().items():
    moved = max(1e-12, float(np.abs(jparams[k] - before[k]).max()))
    np.testing.assert_allclose(p.detach().numpy(), jparams[k], rtol=0,
                               atol=2e-2 * moved, err_msg=k)
