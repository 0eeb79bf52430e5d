"""The rest of the loss suite and the geometry gin's train step against the
JAX package, on the CPU.

- Each loss on the same numpy renderings: interlevel, distortion, depth
  smoothness (patch-shaped), the noisy-view consistency losses (each type,
  each normals target), distance consistency, acc and weights entropy; the
  values and their gradients.
- Two train steps of a small cut of configs/llff_refnerf_geometry_losses.gin
  (the SMALL widths of tests/test_torch_port_train.py, JAX's trunks in
  interpret mode) from step 0 and from a step past the warmup, with JAX's
  noise angles handed to the port's step: every loss term by name, every
  gradient before clipping, every parameter after each step.
- The consistency terms' bounds and three planted faults above them.

The diffuse, specular, distance and normals consistency terms are means of
nearly cancelling quantities (a variance across five nearly equal renders;
squared distances between nearly equal points; 1 - cos of nearly parallel
normals), so each is held to a bound from the arithmetic of its own
cancellation (`testing.consistency.bound`), given the largest difference E
between the two packages' renders of the same rays. The other terms are held to
1e-5 relative, as tests/test_torch_port_train.py holds the flagship's.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refnerf_tpu import configs as jconfigs
from refnerf_tpu.cameras import rays as jrays
from refnerf_tpu.models import construct as jconstruct
from refnerf_tpu.train import losses as jlosses
from refnerf_tpu.train import step as jstep
from refnerf_tpu_torch import configs
from refnerf_tpu_torch import convert
from refnerf_tpu_torch.cameras import rays as rays_lib
from refnerf_tpu_torch.models import construct
from refnerf_tpu_torch.testing import consistency
from refnerf_tpu_torch.train import losses
from refnerf_tpu_torch.train import sampling
from refnerf_tpu_torch.train import step as step_lib

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEO = os.path.join(REPO, 'configs', 'llff_refnerf_geometry_losses.gin')
# SMALL widths; the gin's own sample_noise_size (128) clamps to the batch.
SMALL = [
    'NerfMLP.net_depth = 4', 'NerfMLP.net_width = 32',
    'NerfMLP.net_depth_viewdirs = 4', 'NerfMLP.net_width_viewdirs = 32',
    'NerfMLP.skip_layer = 2', 'NerfMLP.bottleneck_width = 16',
    'Model.num_prop_samples = 16', 'Model.num_nerf_samples = 16',
    'Config.batch_size = 12', "NerfMLP.fused_trunk = 'on'",
]
PAST_WARMUP = 150000  # 0.6 x 250,000: the ratio is 1
TOL = 1e-5
CANCELLING = consistency.TERMS


def _t(a):
  return torch.tensor(np.ascontiguousarray(a))


def _np(x):
  return np.asarray(jnp.asarray(x, jnp.float32))


def _close(port, ref, what=''):
  np.testing.assert_allclose(np.asarray(port.detach()), _np(ref), rtol=TOL,
                             atol=1e-7, err_msg=what)


def _assert_grads(port, ref, rtol, what):
  """Each gradient within rtol * max(|ref|) of the reference."""
  a, b = port.detach().float().numpy(), np.asarray(ref, np.float32)
  assert a.shape == b.shape, (what, a.shape, b.shape)
  scale = max(1e-6, float(np.abs(b).max()))
  np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale, err_msg=what)


# ------------------------------------------------------------- the losses


def _renderings_np(rng, n, a, s):
  """Two levels of renderings of n rays and of n * a rotated copies, and
  their ray histories (s samples)."""
  def level(k):
    return dict(acc=rng.uniform(0, 1, k).astype(np.float32),
                rgb=rng.uniform(size=(k, 3)).astype(np.float32),
                diffuse=rng.uniform(size=(k, 3)).astype(np.float32),
                specular=rng.uniform(size=(k, 3)).astype(np.float32),
                normals=rng.normal(size=(k, 3)).astype(np.float32),
                normals_pred=rng.normal(size=(k, 3)).astype(np.float32),
                distance=rng.uniform(1, 3, (k, 1)).astype(np.float32))
  hist = [dict(weights=rng.dirichlet(np.ones(s), n).astype(np.float32),
               sdist=np.sort(rng.uniform(0, 1, (n, s + 1)),
                             axis=-1).astype(np.float32))
          for _ in range(2)]
  return [level(n) for _ in range(2)], [level(n * a) for _ in range(2)], hist


def _both(tree):
  """(the port's tensors that need grad, JAX arrays) of a numpy tree."""
  port = jax.tree.map(lambda x: _t(x).requires_grad_(True), tree)
  return port, jax.tree.map(jnp.asarray, tree)


def _port_config(bindings):
  config, _ = configs.parse([GEO], bindings)
  jconfig, _ = jconfigs.parse([GEO], bindings)
  return config, jconfig


@pytest.mark.parametrize('kind', ['mse', 'avg_mse', 'var'])
@pytest.mark.parametrize('target', ['normals', 'normals_pred'])
def test_noisy_consistency_loss_matches_jax(kind, target):
  # float32: values 1e-5 relative; the gradients with respect to every
  # rendering 1e-5 of their largest entry. Acc straddles the threshold.
  config, jconfig = _port_config([
      f"Config.consistency_diffuse_loss_type = '{kind}'",
      f"Config.consistency_specular_loss_type = '{kind}'",
      f"Config.consistency_normal_loss_target = '{target}'"])
  rng = np.random.default_rng(0)
  rend, noise, _ = _renderings_np(rng, 6, 4, 5)
  (prend, pnoise), (jrend, jnoise) = _both((rend, noise))
  got = losses.noisy_consistency_loss(2, prend, pnoise, config, 0.7)
  want_fn = lambda r, q: jlosses.noisy_consistency_loss(2, r, q, jconfig,
                                                        jnp.float32(0.7))
  want = want_fn(jrend, jnoise)
  for g, w in zip(got, want):
    _close(g, w)
  leaves = jax.tree.leaves((prend, pnoise))
  grads = torch.autograd.grad(sum(got), leaves, allow_unused=True)
  jgrads = jax.tree.leaves(jax.grad(lambda r, q: sum(want_fn(r, q)),
                                    argnums=(0, 1))(jrend, jnoise))
  for g, x, w in zip(grads, leaves, jgrads):
    _assert_grads(torch.zeros_like(x) if g is None else g, w, TOL, 'grad')


def test_unknown_consistency_types_raise():
  rng = np.random.default_rng(1)
  rend, noise, _ = _renderings_np(rng, 3, 2, 4)
  prend, pnoise = jax.tree.map(_t, (rend, noise))
  for binding in ("Config.consistency_diffuse_loss_type = 'l1'",
                  "Config.consistency_specular_loss_type = 'l1'",
                  "Config.consistency_normal_loss_target = 'rgb'"):
    config, _ = configs.parse([GEO],
                              [binding, 'Config.sample_noise_angles = 2'])
    with pytest.raises(ValueError):
      losses.noisy_consistency_loss(2, prend, pnoise, config)


@pytest.mark.parametrize('kind', ['mse', 'avg_mse', 'var'])
def test_consistency_bound_holds_at_its_worst_case(kind):
  # consistency.bound against the diffuse and specular terms' own movement,
  # in float64. Every rotated copy of a ray differs from the ray's render
  # by d in each channel; moving the ray's render up by e and its copies
  # down by e is the worst case of the squares (mse, avg_mse), where the
  # bound is met with equality (1e-9 relative); moves drawn within e (every
  # type, d drawn per ray) stay within it.
  config, _ = _port_config([
      f"Config.consistency_diffuse_loss_type = '{kind}'",
      f"Config.consistency_specular_loss_type = '{kind}'"])
  n, a, e = 8, config.sample_noise_angles, 1e-3
  rng = np.random.default_rng(0)
  normals = _t(rng.normal(size=(n, 3)))
  gap = dict.fromkeys(consistency.GAP_KEYS, e)
  names = ('diffuse_consistency', 'specular_consistency')

  def terms(ref, noise):
    rend = dict(acc=torch.ones(n, dtype=torch.float64), diffuse=_t(ref),
                specular=_t(ref), normals=normals, normals_pred=normals)
    rnoise = dict(diffuse=_t(noise), specular=_t(noise),
                  normals=normals.repeat_interleave(a, 0),
                  normals_pred=normals.repeat_interleave(a, 0))
    got = losses.noisy_consistency_loss(2, [rend] * 2, [rnoise] * 2, config)
    return dict(zip(names, (float(t) for t in got[:2])))

  ref = rng.uniform(0.2, 0.8, (n, 3))
  for d in (np.full((n, 1), 0.05), rng.uniform(0, 0.1, (n, 1))):
    noise = np.repeat(ref - d, a, axis=0)
    base = terms(ref, noise)
    bound = {k: consistency.bound(k, base[k], config, 1.0, gap)
             for k in names}
    assert all(b > 0 for b in bound.values())
    moved = [terms(ref + e, noise - e)]
    moved += [terms(ref + rng.uniform(-e, e, ref.shape),
                    noise + rng.uniform(-e, e, noise.shape))
              for _ in range(20)]
    for m in moved:
      for k in names:
        assert abs(m[k] - base[k]) <= bound[k] * (1 + 1e-9), (k, m, bound)
    if kind != 'var' and d.min() == d.max():
      for k in names:
        assert abs(moved[0][k] - base[k]) >= bound[k] * (1 - 1e-9), k


def test_distance_consistency_matches_jax():
  # float32, 1e-5: values and the gradients of both levels' distances.
  config, jconfig = _port_config([])
  rng = np.random.default_rng(2)
  rend, noise, _ = _renderings_np(rng, 6, 4, 5)
  r = {k: rng.normal(size=(6, 3)).astype(np.float32)
       for k in ('origins', 'directions')}
  q = {k: rng.normal(size=(24, 3)).astype(np.float32)
       for k in ('origins', 'directions')}
  (prend, pnoise), (jrend, jnoise) = _both((rend, noise))
  prays = rays_lib.dummy_rays(6)
  prays.origins, prays.directions = _t(r['origins']), _t(r['directions'])
  pnoisy = rays_lib.dummy_rays(24)
  pnoisy.origins, pnoisy.directions = _t(q['origins']), _t(q['directions'])
  jr = jrays.dummy_rays(6).replace(**{k: jnp.asarray(v) for k, v in r.items()})
  jq = jrays.dummy_rays(24).replace(**{k: jnp.asarray(v)
                                       for k, v in q.items()})
  got = losses.noisy_distance_consistency_loss(2, prays, pnoisy, prend,
                                               pnoise, config, 0.5)
  want_fn = lambda a, b: jlosses.noisy_distance_consistency_loss(
      2, jr, jq, a, b, jconfig, jnp.float32(0.5))
  _close(got, want_fn(jrend, jnoise))
  gd = torch.autograd.grad(got, [prend[1]['distance'], pnoise[0]['distance']])
  jg = jax.grad(want_fn, argnums=(0, 1))(jrend, jnoise)
  _assert_grads(gd[0], jg[0][1]['distance'], TOL, 'distance')
  _assert_grads(gd[1], jg[1][0]['distance'], TOL, 'noisy distance')


def test_histogram_losses_match_jax():
  # Interlevel (its gradient stops at the final level), distortion, acc and
  # weights entropy: float32, values and gradients 1e-5.
  config, jconfig = _port_config(['Config.interlevel_loss_mult = 1.0',
                                  'Config.distortion_loss_mult = 0.01'])
  rng = np.random.default_rng(3)
  rend, _, hist = _renderings_np(rng, 7, 1, 9)
  hist[1]['sdist'] = np.sort(rng.uniform(0, 1, (7, 13)), -1).astype(np.float32)
  hist[1]['weights'] = rng.dirichlet(np.ones(12), 7).astype(np.float32)
  (prend, phist), (jrend, jhist) = _both((rend, hist))
  cases = {
      'interlevel': (lambda r, h: losses.interlevel_loss(h, config),
                     lambda r, h: jlosses.interlevel_loss(h, jconfig)),
      'distortion': (lambda r, h: losses.distortion_loss(h, config),
                     lambda r, h: jlosses.distortion_loss(h, jconfig)),
      'acc': (lambda r, h: losses.accumulated_weights_loss(r, config),
              lambda r, h: jlosses.accumulated_weights_loss(r, jconfig)),
      'weights_entropy': (
          lambda r, h: losses.weights_entropy_loss(2, r, h, config, 0.3),
          lambda r, h: jlosses.weights_entropy_loss(2, r, h, jconfig,
                                                    jnp.float32(0.3)))}
  leaves = jax.tree.leaves((prend, phist))
  for name, (port_fn, jax_fn) in cases.items():
    got = port_fn(prend, phist)
    _close(got, jax_fn(jrend, jhist), name)
    grads = torch.autograd.grad(got, leaves, allow_unused=True)
    jgrads = jax.tree.leaves(jax.grad(jax_fn, argnums=(0, 1))(jrend, jhist))
    for g, x, w in zip(grads, leaves, jgrads):
      _assert_grads(torch.zeros_like(x) if g is None else g, w, TOL, name)
  assert float(cases['interlevel'][0](prend, phist).detach()) > 0


def test_depth_smoothness_matches_jax():
  # Patch-shaped [n, 3, 3] renderings: float32, value and the distances'
  # gradient 1e-5.
  config, jconfig = _port_config(['Config.patch_size = 3',
                                  'Config.depth_smoothness_loss_mult = 0.1',
                                  'Config.depth_smoothness_coarse_loss_mult = '
                                  '0.01'])
  rng = np.random.default_rng(4)
  rend = [dict(distance=rng.uniform(1, 3, (4, 3, 3, 1)).astype(np.float32),
               acc=rng.uniform(size=(4, 3, 3)).astype(np.float32),
               rgb=rng.uniform(size=(4, 3, 3, 3)).astype(np.float32))
          for _ in range(2)]
  prend, jrend = _both(rend)
  got = losses.compute_depth_smoothness_loss(prend, config)
  want_fn = lambda r: jlosses.compute_depth_smoothness_loss(r, jconfig)
  _close(got, want_fn(jrend))
  g = torch.autograd.grad(got, [prend[0]['distance'], prend[1]['distance']])
  jg = jax.grad(want_fn)(jrend)
  for level in range(2):
    _assert_grads(g[level], jg[level]['distance'], TOL, f'level {level}')


def test_masked_mean_and_variance_match_jax():
  # The 1e-10 floor of an empty mask (0, not NaN), and the unbiased variance
  # written as JAX writes it: float32 1e-6 relative.
  rng = np.random.default_rng(5)
  x = rng.normal(size=(5, 4, 3)).astype(np.float32) * 1e-3 + 0.5
  mask = rng.uniform(size=(5, 4, 1)) > 0.5
  _close(losses._masked_mean(_t(x), _t(mask)),
         jlosses._masked_mean(jnp.asarray(x), jnp.asarray(mask)))
  assert float(losses._masked_mean(_t(x), _t(mask & False))) == 0.0
  np.testing.assert_allclose(
      losses._var_unbiased(_t(x), 1).numpy(),
      _np(jlosses._var_unbiased(jnp.asarray(x), 1)), rtol=1e-6)


# ------------------------------------------------------------ the train step


def _batch_np(shape, seed):
  """Forward-facing (NDC-like: near 0, far 1) rays and pixels."""
  rng = np.random.RandomState(seed)
  d = rng.randn(*shape, 3).astype(np.float32)
  d[..., 2] = -np.abs(d[..., 2]) - 1
  f = lambda v, k=1: np.full(shape + (k,), v, np.float32)
  return dict(origins=rng.randn(*shape, 3).astype(np.float32) * 0.1,
              directions=d,
              viewdirs=d / np.linalg.norm(d, axis=-1, keepdims=True),
              radii=f(0.001), lossmult=f(1.0), near=f(0.0), far=f(1.0),
              imageplane=f(0.0, 2), rgb=rng.uniform(0, 1, shape + (3,)).astype(
                  np.float32))


def _jax_step_with_grads(jmodel, jconfig):
  """JAX's jitted make_train_step, its stats carrying the gradients before
  clipping (the step takes them with jax.value_and_grad, step.py:245)."""
  step = jstep.make_train_step(jmodel, jconfig)
  orig = jax.value_and_grad

  def value_and_grad(fn, has_aux=False, **kw):
    inner = orig(fn, has_aux=has_aux, **kw)

    def run(params):
      (value, aux), grads = inner(params)
      return (value, dict(aux, grads=grads)), grads
    return run

  def traced(state, batch):
    jax.value_and_grad = value_and_grad
    try:
      return step(state, batch)
    finally:
      jax.value_and_grad = orig
  return jax.jit(traced)


def _jax_angles(config, step):
  """JAX's draw: the second key of split(fold_in(PRNGKey(seed), step), 3),
  uniform on [0, range / 180 * pi * ratio)."""
  key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(config.seed),
                                            step), 3)[1]
  ratio = jstep._consistency_ratio(config, jnp.float32(step))
  return np.asarray(jax.random.uniform(
      key, (config.sample_noise_angles, 3), minval=0.0,
      maxval=config.sample_angle_range / 180.0 * jnp.pi * ratio))


def _flat(tree):
  return {k: v.numpy() for k, v in convert.params_to_state_dict(tree).items()}


class _Pair:
  """The geometry gin's small cut in both packages, on one batch."""

  def __init__(self, bindings, shape, seed=0):
    jconfig, jgin = jconfigs.parse([GEO], bindings)
    self.jconfig = jconfig
    self.jmodel = jconstruct.construct_model(jconfig, jgin)
    p = jax.device_get(jconstruct.init_params(jax.random.PRNGKey(seed),
                                              self.jmodel))
    rng = np.random.default_rng(seed)
    self.params = jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) + (
            rng.normal(size=x.shape).astype(np.float32) * 0.1
            if path[-1].key == 'bias' else 0.0), p)
    b = _batch_np(shape, seed)
    cam = np.zeros(shape + (1,), np.int32)
    self.jbatch = jrays.Batch(
        rays=jrays.Rays(cam_idx=jnp.asarray(cam), **{
            k: jnp.asarray(v) for k, v in b.items() if k != 'rgb'}),
        rgb=jnp.asarray(b['rgb']))
    self.jtrain = _jax_step_with_grads(self.jmodel, jconfig)
    self.jstate0 = jstep.create_train_state(jconfig, self.jmodel, self.params)
    self.config, gin = configs.parse([GEO], bindings)
    self.model = construct.construct_model(self.config, gin, 'cpu')
    rays = rays_lib.Rays(cam_idx=_t(cam), **{k: _t(v) for k, v in b.items()
                                             if k != 'rgb'})
    self.batch = rays_lib.Batch(rays=rays, rgb=_t(b['rgb']))
    self.angles = lambda step, a, max_angle: _t(_jax_angles(jconfig, step))
    self.japply = jax.jit(lambda p, r, train_frac: self.jmodel.apply(
        p, r, train_frac=train_frac, compute_extras=True, train=True,
        rng=None)[0])

  def states(self, step):
    # One template: a new optax chain in the state's static fields would
    # make the jitted step trace again.
    jstate = self.jstate0.replace(step=jnp.asarray(step, jnp.int32))
    convert.load_jax_params(self.model, self.params)
    state = step_lib.create_train_state(self.config, self.model)
    state.step = step
    return jstate, state

  def render_gap(self, step, jparams):
    """The largest |difference| between the two packages' renders, each at
    its own current parameters (`jparams` JAX's), of each quantity the
    consistency terms read, over both levels of the batch's forward and of
    the noisy forward from JAX's angles; and the longest rotated direction:
    consistency.bound's `gap`."""
    train_frac = float(np.clip((step - 1) / (self.config.max_steps - 1), 0, 1))
    with torch.no_grad():
      port, noisy_rays = consistency.step_renders(
          self.model, self.batch.rays, self.config, step,
          _t(_jax_angles(self.jconfig, step)))
    jp = {'params': jparams}
    to_j = lambda r: jrays.Rays(**{k: jnp.asarray(getattr(r, k).numpy())
                                   for k in vars(r)})
    ref = [{k: _np(jlevel[k]) for k in consistency.GAP_KEYS}
           for rays in (self.batch.rays, noisy_rays)
           for jlevel in self.japply(jp, to_j(rays), jnp.float32(train_frac))]
    return consistency.render_gap(port, ref, noisy_rays)


@pytest.fixture(scope='module')
def geometry():
  return _Pair(SMALL, (12,))


def _check_terms(pair, stats, jstats, gap, step):
  ratio = float(jstep._consistency_ratio(pair.jconfig, jnp.float32(step)))
  assert ratio == step_lib._consistency_ratio(pair.config, step)
  for k in jstats['losses']:
    got, want = float(stats['losses'][k]), float(jstats['losses'][k])
    if k in CANCELLING:
      bound = consistency.bound(k, want, pair.config, ratio, gap)
      assert abs(got - want) <= bound, (k, got, want, bound)
      if ratio == 0:
        assert got == 0.0, (k, got)
    else:
      np.testing.assert_allclose(got, want, rtol=TOL, err_msg=k)


@pytest.mark.parametrize('start', [0, PAST_WARMUP // 2, PAST_WARMUP],
                         ids=['step0', 'mid_warmup', 'past_warmup'])
def test_geometry_gin_steps_match_jax(geometry, start):
  # Two steps from `start` (the consistency ratio 0, 0.5 or 1), float32.
  # Loss terms: 1e-5 relative, but the consistency terms: their bound from
  # the renders' gap (at step 0 the ratio is 0 and they are exactly 0).
  # Gradients before clipping: 2e-4 of each one's largest entry (as
  # tests/test_torch_port_train.py). The parameters after each step: 2e-2
  # of that parameter's largest move.
  pair = geometry
  jstate, state = pair.states(start)
  train = step_lib.make_train_step(pair.model, pair.config,
                                   noise_angles=pair.angles)
  before = {k: v.detach().clone().numpy() for k, v in state.params().items()}
  for i in (1, 2):
    gap = pair.render_gap(state.step, jstate.params)
    _, _, grads = train.loss_and_grads(state, pair.batch)
    jstate, jstats = pair.jtrain(jstate, pair.jbatch)
    state, stats = train(state, pair.batch)
    assert state.step == int(jstate.step) == start + i
    assert set(stats['losses']) == set(jstats['losses']) == {
        'data', 'orientation', 'predicted_normals', 'diffuse_consistency',
        'specular_consistency', 'normals_consistency', 'acc',
        'distance_consistency', 'weights_entropy'}
    _check_terms(pair, stats, jstats, gap, start + i - 1)
    if start:
      assert all(float(stats['losses'][k]) != 0 for k in CANCELLING)
    for k in ('loss', 'psnr', 'learning_rate'):
      np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                 rtol=TOL, err_msg=k)
    want = _flat(jax.device_get(jstats['grads']))
    assert set(grads) == set(want)
    for k, g in grads.items():
      _assert_grads(g, want[k], 2e-4, k)
    jparams = _flat(jax.device_get(jstate.params))
    for k, p in state.params().items():
      moved = max(1e-12, float(np.abs(jparams[k] - before[k]).max()))
      np.testing.assert_allclose(p.detach().numpy(), jparams[k], rtol=0,
                                 atol=2e-2 * moved, err_msg=k)


def test_consistency_faults_exceed_their_bounds(geometry, monkeypatch):
  # The bounds above let no real fault through. Three planted faults, each
  # against JAX's terms: the rotated copies grouped angle-major instead of
  # sample-major (the reference's layout), the specular term's negation
  # dropped, and a ratio of 1 at step 0 (the warmup ignored).
  pair = geometry
  jstate, state = pair.states(PAST_WARMUP)
  gap = pair.render_gap(PAST_WARMUP, jstate.params)
  _, jstats = pair.jtrain(jstate, pair.jbatch)
  want = {k: float(v) for k, v in jstats['losses'].items()}
  bound = {k: consistency.bound(k, want[k], pair.config, 1.0, gap)
           for k in CANCELLING}
  train = step_lib.make_train_step(pair.model, pair.config,
                                   noise_angles=pair.angles)
  _, stats, _ = train.loss_and_grads(state, pair.batch)
  for k in CANCELLING:
    assert abs(float(stats['losses'][k]) - want[k]) <= bound[k], k

  # Negation dropped.
  k = 'specular_consistency'
  assert abs(-float(stats['losses'][k]) - want[k]) > bound[k]

  # Angle-major grouping.
  sample = sampling.sample_noisy_rays

  def angle_major(*args, **kw):
    out = sample(*args, **kw)
    a = pair.config.sample_noise_angles
    return out.map(lambda x: x.reshape(-1, a, *x.shape[1:]).transpose(
        0, 1).reshape(x.shape))
  monkeypatch.setattr(sampling, 'sample_noisy_rays', angle_major)
  _, faulty, _ = train.loss_and_grads(state, pair.batch)
  for k in ('diffuse_consistency', 'specular_consistency',
            'distance_consistency', 'normals_consistency'):
    assert abs(float(faulty['losses'][k]) - want[k]) > bound[k], k
  monkeypatch.setattr(sampling, 'sample_noisy_rays', sample)

  # A ratio of 1 at step 0: JAX's terms are 0 there, and so is the bound.
  jstate, state = pair.states(0)
  _, jstats = pair.jtrain(jstate, pair.jbatch)
  monkeypatch.setattr(step_lib, '_consistency_ratio', lambda c, s: 1.0)
  _, faulty, _ = step_lib.make_train_step(
      pair.model, pair.config, noise_angles=lambda s, a, m: _t(
          _jax_angles(pair.jconfig, PAST_WARMUP))).loss_and_grads(
              state, pair.batch)
  for k in CANCELLING:
    zero_bound = consistency.bound(k, float(jstats['losses'][k]),
                                          pair.config, 0.0, gap)
    assert float(jstats['losses'][k]) == 0.0 == zero_bound
    assert abs(float(faulty['losses'][k])) > zero_bound, k
