"""mip-NeRF 360's proposal cascade in the port against the JAX package, on
the CPU.

The configuration is configs/blender_refnerf.gin with the cascade bound
back to JAX's (multinerf's) defaults: 3 levels, a separate density-only
PropMLP on the MLP's default encoding (the icosahedron basis at 2
subdivisions, degrees 0-12: 504 IPE columns), weight dilation between the
levels, Schlick annealing, single-jitter stratified sampling, and the
interlevel and distortion losses; cut here to narrow trunks and few
samples, the PropMLP at its real 504 columns.

- `coord.construct_ray_warps`: every warp, by name and by callable;
- `stepfun.max_dilate` / `max_dilate_weights`, and the jittered `sample`
  and `sample_intervals` given JAX's own offsets;
- the plain spatial trunk at 504 columns, density only (depth 4, and 8
  with the skip at layer 5), against JAX `fused_encoded_trunk` in interpret
  mode: values and `jax.grad`, f32 and bf16; and in bf16 at 672 columns;
- the 3-level model served (with and without a ray warp), and two train
  steps of the configuration, against JAX, deterministic
  (`Config.randomized = False`) and stochastic with JAX's draws handed to
  the port (density, specular-density and bottleneck noise and a random
  background included);
- the wide-input kernel instances' routing and launch counts (f32 and
  bf16), with the kernels stubbed by the plain versions, and the bf16
  instances' ctypes argument lists against `cuda_build.EXPORTS`.

Tolerances: 1e-5 in float32 where JAX's own pins use it (the warps, the
stepfun ops, the served renders, the loss terms), the trunk's gradients 1e-4
of their largest entry (sums in another order), bfloat16 5e-2; gradients of
the steps 2e-4 of their largest entry and the parameters after a step 2e-2
of their largest move, as tests/test_torch_port_losses.py.
"""

import collections
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refnerf_tpu import configs as jconfigs
from refnerf_tpu.cameras import rays as jrays
from refnerf_tpu.models import construct as jconstruct
from refnerf_tpu.ops import coord as jcoord
from refnerf_tpu.ops import stepfun as jstepfun
from refnerf_tpu.ops.pallas import fused_mlp as jfused
from refnerf_tpu.train import step as jstep
from refnerf_tpu_torch import configs
from refnerf_tpu_torch import convert
from refnerf_tpu_torch.cameras import rays as rays_lib
from refnerf_tpu_torch.models import construct
from refnerf_tpu_torch.ops import coord
from refnerf_tpu_torch.ops import fused_mlp
from refnerf_tpu_torch.ops import stepfun
from refnerf_tpu_torch.train import sampling
from refnerf_tpu_torch.train import step as step_lib
from tests.test_torch_port_losses import (_assert_grads, _flat,
                                          _jax_step_with_grads)
from tests.test_torch_port_plainstack import _pack_weights

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIN = os.path.join(REPO, 'configs', 'blender_refnerf.gin')
# The cascade at JAX's defaults, mip-NeRF 360's proposal MLP (4 x 256,
# density only) and its losses.
CASCADE = [
    'Model.num_levels = 3', 'Model.single_mlp = False',
    'Model.num_prop_samples = 64', 'Model.num_nerf_samples = 32',
    'Model.anneal_slope = 10.', 'Model.dilation_bias = 0.0025',
    'Model.dilation_multiplier = 0.5', 'Model.single_jitter = True',
    'Model.resample_padding = 0.', 'Config.randomized = True',
    'Config.interlevel_loss_mult = 1.0', 'Config.distortion_loss_mult = 0.01',
    'PropMLP.net_depth = 4', 'PropMLP.net_width = 256',
    'PropMLP.disable_rgb = True', 'PropMLP.disable_density_normals = True',
    # The normal losses at JAX's defaults (0): JAX's losses read every
    # level's normals and raise where one has none (losses.py:130-137,
    # :152-158), and the published proposal MLP has none.
    'Config.orientation_loss_mult = 0.',
    'Config.orientation_coarse_loss_mult = 0.',
    'Config.predicted_normal_loss_mult = 0.',
    'Config.predicted_normal_coarse_loss_mult = 0.',
]
# Cut to size: narrow trunks, few samples; the PropMLP keeps its 504
# columns. Both packages run their fused formulation (JAX's Pallas trunks
# in interpret mode, the port's plain versions of its kernels).
SMALL = [
    'NerfMLP.net_depth = 4', 'NerfMLP.net_width = 32',
    'NerfMLP.net_depth_viewdirs = 4', 'NerfMLP.net_width_viewdirs = 32',
    'NerfMLP.skip_layer = 2', 'NerfMLP.bottleneck_width = 16',
    'PropMLP.net_width = 16', 'Model.num_prop_samples = 16',
    'Model.num_nerf_samples = 8', 'Config.batch_size = 12',
    "NerfMLP.fused_trunk = 'on'", "PropMLP.fused_trunk = 'on'",
]
NOISE = ['NerfMLP.density_noise = 1.0', 'NerfMLP.bottleneck_noise = 0.1',
         'NerfMLP.enable_pred_specular_density = True',
         'Model.bg_intensity_range = (0., 1.)']
TOL = 1e-5


def _t(a):
  return torch.tensor(np.ascontiguousarray(a))


def _np(x):
  return np.asarray(jnp.asarray(x, jnp.float32))


def _close(port, ref, tol=TOL, what='', atol=None):
  np.testing.assert_allclose(np.asarray(port.detach()), _np(ref), rtol=tol,
                             atol=tol * 1e-2 if atol is None else atol,
                             err_msg=what)


# --------------------------------------------------------------- the warps


@pytest.mark.parametrize('fn', [None, 'piecewise', 'reciprocal', 'log', 'exp',
                                'sqrt', 'square', 'callable'])
def test_ray_warps_match_jax(fn):
  # Both directions, float32 1e-5 relative; near > 0 for the log, and at 0
  # for the piecewise warp, made for t_near = 0.
  rng = np.random.default_rng(5)
  near = rng.uniform(0.5, 2, (7, 1)).astype(np.float32)
  if fn == 'piecewise':
    near[:3] = 0
  far = near + rng.uniform(1, 4, (7, 1)).astype(np.float32)
  s = rng.uniform(0, 1, (7, 5)).astype(np.float32)
  pfn, jfn = ((torch.reciprocal, jnp.reciprocal) if fn == 'callable'
              else (fn, fn))
  t_to_s, s_to_t = coord.construct_ray_warps(pfn, _t(near), _t(far))
  jt_to_s, js_to_t = jcoord.construct_ray_warps(jfn, jnp.asarray(near),
                                                jnp.asarray(far))
  _close(s_to_t(_t(s)), js_to_t(jnp.asarray(s)))
  tt = np.asarray(js_to_t(jnp.asarray(s)))
  _close(t_to_s(_t(tt)), jt_to_s(jnp.asarray(tt)))
  with pytest.raises(ValueError, match='Unknown raydist_fn'):
    coord.construct_ray_warps('cube', _t(near), _t(far))


# ---------------------------------------------------------- stepfun ops


def _histogram(rng, n, bins):
  t = np.sort(rng.uniform(0, 1, (n, bins + 1)), axis=-1).astype(np.float32)
  t[:, 0], t[:, -1] = 0, 1
  t[0, 3] = t[0, 2]  # a zero-width bin
  w = rng.dirichlet(np.ones(bins), n).astype(np.float32)
  w[1, :] = 0  # a ray with no weight: the renormalisation's eps floor
  return t, w


@pytest.mark.parametrize('dilation', [0.0025 + 0.5 / 16, 0.0025 + 0.5 / 256])
def test_max_dilate_weights_matches_jax(dilation):
  # The cascade's two dilations (levels 1 and 2 after 16 samples), in the
  # domain [0, 1] with renormalisation; and max_dilate unclipped. float32:
  # the sort-then-compare order is JAX's, so the weights are equal to
  # rounding (1e-6 relative) and the endpoints exact.
  rng = np.random.default_rng(1)
  t, w = _histogram(rng, 6, 16)
  p = stepfun.weight_to_pdf(_t(t), _t(w))
  _close(p, jstepfun.weight_to_pdf(jnp.asarray(t), jnp.asarray(w)), 1e-6)
  _close(stepfun.pdf_to_weight(_t(t), p),
         jstepfun.pdf_to_weight(jnp.asarray(t), jnp.asarray(_np(p))), 1e-6)
  for domain, renorm in (((0.0, 1.0), True), ((-np.inf, np.inf), False)):
    got = stepfun.max_dilate_weights(_t(t), _t(w), dilation, domain=domain,
                                     renormalize=renorm)
    want = jstepfun.max_dilate_weights(jnp.asarray(t), jnp.asarray(w),
                                       dilation, domain=domain,
                                       renormalize=renorm)
    np.testing.assert_array_equal(got[0].numpy(), _np(want[0]))
    _close(got[1], want[1], 1e-6)
    assert got[1].shape == (6, 3 * 16)
  got = stepfun.max_dilate(_t(t), _t(w), dilation, domain=(0.0, 1.0))
  want = jstepfun.max_dilate(jnp.asarray(t), jnp.asarray(w), dilation,
                             domain=(0.0, 1.0))
  np.testing.assert_array_equal(got[0].numpy(), _np(want[0]))
  np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))


@pytest.mark.parametrize('single_jitter', [True, False])
def test_jittered_sampling_matches_jax(single_jitter):
  # JAX draws the offsets inside `sample` from its key; the port takes them
  # as a tensor. With JAX's offsets both give the same samples and
  # intervals (float32 1e-5), at 16 and at 1 + 1 samples.
  rng = np.random.default_rng(2)
  t, w = _histogram(rng, 5, 12)
  logits = np.log(w + 0.01).astype(np.float32)
  key = jax.random.PRNGKey(3)
  for num in (16, 2):
    d = 1 if single_jitter else num
    jit = np.asarray(jax.random.uniform(key, (5, d),
                                        maxval=stepfun.max_jitter(num)))
    want = jstepfun.sample(key, jnp.asarray(t), jnp.asarray(logits), num,
                           single_jitter=single_jitter)
    _close(stepfun.sample(_t(t), _t(logits), num, jitter=_t(jit)), want)
    want = jstepfun.sample_intervals(key, jnp.asarray(t), jnp.asarray(logits),
                                     num, single_jitter=single_jitter,
                                     domain=(0.0, 1.0))
    _close(stepfun.sample_intervals(_t(t), _t(logits), num, domain=(0., 1.),
                                    jitter=_t(jit)), want)


# ------------------------------------------------ the 504-column trunk


def _prop_trunk_params(rng, depth, width=16, fin=504):
  skips = jfused.skip_input_layers(depth, 4)
  ks, bs = [], []
  for l in range(depth):
    ind = fin if l == 0 else width + (fin if l in skips else 0)
    ks.append((rng.normal(size=(ind, width)) / np.sqrt(ind)).astype(np.float32))
    bs.append((rng.normal(size=(width,)) * 0.1).astype(np.float32))
  return (ks, bs,
          (rng.normal(size=(width, 1)) / np.sqrt(width)).astype(np.float32),
          (rng.normal(size=(1,)) * 0.1).astype(np.float32))


@pytest.mark.parametrize('depth', [4, 8])
@pytest.mark.parametrize('cdt,tol', [('float32', 1e-4), ('bfloat16', 5e-2)])
def test_density_only_trunk_at_504_columns_matches_pallas(depth, cdt, tol):
  # The PropMLP's trunk: the IPE of 21 basis vectors x 12 degrees (two
  # segments of 252), density head only, no density gradient; depth 4 (no
  # skip) and 8 (the input again at layer 5). sigma within tol of its
  # largest value, and every gradient of a loss of sigma within tol of its
  # largest entry, against JAX in interpret mode.
  _density_only_trunk_matches_pallas(depth, cdt, tol, 12)


@pytest.mark.parametrize('depth', [4, 8])
def test_density_only_trunk_at_672_columns_matches_pallas(depth):
  # The same trunk at a second wide width, in bf16: 21 basis vectors x 16
  # degrees, two segments of 336 (kin 672, six 128-column chunks of the
  # bf16 wide-input forward, the last one half full), against JAX.
  _density_only_trunk_matches_pallas(depth, 'bfloat16', 5e-2, 16)


def _density_only_trunk_matches_pallas(depth, cdt, tol, degrees):
  rng = np.random.default_rng(depth)
  lead = (5, 13)
  lm = rng.uniform(-1.5, 1.5, lead + (21,)).astype(np.float32)
  lv = (10.0**rng.uniform(-6, -2, lead + (21,))).astype(np.float32)
  scales = 2.0**np.arange(0, degrees)
  ks, bs, wd, bd = _prop_trunk_params(rng, depth, fin=42 * degrees)

  def jloss(q):
    sig = jfused.fused_encoded_trunk(
        jnp.asarray(lm), jnp.asarray(lv), scales, q[0], q[1], q[2], q[3],
        compute_dtype=cdt, block=32)
    return jnp.sum(jnp.tanh(sig)), sig

  (_, jsig), jg = jax.value_and_grad(jloss, has_aux=True)(
      ([jnp.asarray(k) for k in ks], [jnp.asarray(b) for b in bs],
       jnp.asarray(wd), jnp.asarray(bd)))
  ws = [_t(k.T).requires_grad_(True) for k in ks]
  bsp = [_t(b).requires_grad_(True) for b in bs]
  wdp, bdp = _t(wd.T).requires_grad_(True), _t(bd).requires_grad_(True)
  sig, = fused_mlp.fused_encoded_trunk(
      _t(lm), _t(lv), scales, ws, bsp, wdp, bdp, compute_dtype=cdt,
      mode='on')
  assert sig.shape == lead
  scale = max(1.0, float(np.abs(_np(jsig)).max()))
  np.testing.assert_allclose(sig.detach().numpy(), _np(jsig), rtol=0,
                             atol=tol * scale)
  grads = torch.autograd.grad(torch.tanh(sig).sum(), ws + bsp + [wdp, bdp])
  want = ([k.T for k in jg[0]] + list(jg[1]) + [jg[2].T, jg[3]])
  for i, (g, w) in enumerate(zip(grads, want)):
    _assert_grads(g, _np(w), tol, f'gradient {i}')


# ------------------------------------------------ the model and the step


def _rays_np(n, seed):
  rng = np.random.default_rng(seed)
  d = rng.normal(size=(n, 3)).astype(np.float32)
  f = lambda v, k=1: np.full((n, k), v, np.float32)
  return dict(origins=rng.normal(size=(n, 3)).astype(np.float32) * 0.1,
              directions=d,
              viewdirs=d / np.linalg.norm(d, axis=-1, keepdims=True),
              radii=f(0.001), lossmult=f(1.0), near=f(2.0), far=f(6.0),
              imageplane=f(0.0, 2), cam_idx=np.zeros((n, 1), np.int32))


def _params(jmodel, seed):
  """JAX parameters with random biases, as numpy."""
  p = jax.device_get(jconstruct.init_params(jax.random.PRNGKey(seed), jmodel))
  rng = np.random.default_rng(seed)
  return jax.tree_util.tree_map_with_path(
      lambda path, x: np.asarray(x) + (
          rng.normal(size=x.shape).astype(np.float32) * 0.1
          if path[-1].key == 'bias' else 0.0), p)


class JaxDraws:
  """The port's draws protocol (train/sampling.py `Draws`) replaying JAX's
  key splits from `rng` (model.py:115-118, :151-154, :207-214; mlp.py
  :436-445, :516-520), so that the port's model draws what JAX's does."""

  def __init__(self, rng):
    self.rng = rng

  def _key(self):
    self.rng, key = jax.random.split(self.rng)
    return key

  def jitter(self, batch_shape, num_samples, single_jitter):
    d = 1 if single_jitter else num_samples
    return _t(np.asarray(jax.random.uniform(
        self._key(), tuple(batch_shape) + (d,),
        maxval=stepfun.max_jitter(num_samples))))

  def mlp(self):
    return JaxDraws(self._key())

  def normal(self, shape):
    return _t(np.asarray(jax.random.normal(self._key(), tuple(shape))))

  def background(self, shape, lo, hi):
    return _t(np.asarray(jax.random.uniform(self._key(), tuple(shape),
                                            minval=lo, maxval=hi)))


def jax_draws(seed):
  """make_train_step's `draws`: JAX's rng_fwd and rng_noisy_fwd of
  split(fold_in(PRNGKey(seed), step), 3) (step.py:159-161)."""
  def draws(step, stream):
    keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed),
                                               step), 3)
    return JaxDraws(keys[0 if stream == sampling.FWD_STREAM else 2])
  return draws


class _Pair:
  """The configuration's small cut in both packages, on one batch."""

  def __init__(self, bindings, n=12, seed=0):
    jconfig, jgin = jconfigs.parse([GIN], bindings)
    self.jconfig = jconfig
    self.jmodel = jconstruct.construct_model(jconfig, jgin)
    self.params = _params(self.jmodel, seed)
    self.config, gin = configs.parse([GIN], bindings)
    self.model = construct.construct_model(self.config, gin, 'cpu')
    convert.load_jax_params(self.model, self.params)
    r = _rays_np(n, seed)
    rgb = np.random.default_rng(seed + 1).uniform(size=(n, 3)).astype(
        np.float32)
    self.jbatch = jrays.Batch(
        rays=jrays.Rays(**{k: jnp.asarray(v) for k, v in r.items()}),
        rgb=jnp.asarray(rgb))
    self.batch = rays_lib.Batch(
        rays=rays_lib.Rays(**{k: _t(v) for k, v in r.items()}), rgb=_t(rgb))


@pytest.fixture(scope='module')
def served():
  return _Pair(CASCADE + SMALL)


@pytest.mark.parametrize('warp', [None, '@jnp.reciprocal'])
def test_cascade_served_matches_jax(served, warp):
  # Eval: the deterministic linspace (JAX's rng=None), the dilation between
  # the levels, annealing at train_frac 0.3. Every level's rgb, distance
  # and acc float32 1e-5, and the sample intervals (positions in [0, 1])
  # within 1e-6, a few float32 spacings of 1; with the gin reference
  # @jnp.reciprocal as Model.raydist_fn too (the port reads its last part).
  pair = served
  jmodel, model = pair.jmodel, pair.model
  if warp:
    jmodel = jmodel.clone(raydist_fn='reciprocal')
    config, gin = configs.parse([GIN], CASCADE + SMALL +
                                [f'Model.raydist_fn = {warp}'])
    model = construct.construct_model(config, gin, 'cpu')
    convert.load_jax_params(model, pair.params)
    assert model.cfg.raydist_fn == 'reciprocal'
  jr, hist = jmodel.apply({'params': pair.params}, pair.jbatch.rays,
                          train_frac=0.3, compute_extras=False)
  with torch.no_grad():
    pr, phist = model(pair.batch.rays, train_frac=0.3)
  assert len(pr) == 3
  for level in range(3):
    for k in ('rgb', 'distance', 'acc'):
      _close(pr[level][k], jr[level][k], what=f'{level} {k}')
    _close(phist[level]['sdist'], hist[level]['sdist'], what=f'{level} sdist',
           atol=1e-6)
  assert phist[0]['sdist'].shape[-1] == 17 and phist[2]['sdist'].shape[-1] == 9


def _steps(pair, draws, start=0):
  jtrain = _jax_step_with_grads(pair.jmodel, pair.jconfig)
  jstate = jstep.create_train_state(pair.jconfig, pair.jmodel, pair.params)
  jstate = jstate.replace(step=jnp.asarray(start, jnp.int32))
  state = step_lib.create_train_state(pair.config, pair.model)
  state.step = start
  train = step_lib.make_train_step(pair.model, pair.config, draws=draws)
  before = {k: v.detach().clone().numpy() for k, v in state.params().items()}
  for i in (1, 2):
    _, _, grads = train.loss_and_grads(state, pair.batch)
    jstate, jstats = jtrain(jstate, pair.jbatch)
    state, stats = train(state, pair.batch)
    assert state.step == int(jstate.step) == start + i
    assert set(stats['losses']) == set(jstats['losses']) >= {
        'data', 'interlevel', 'distortion'}
    for k in jstats['losses']:
      np.testing.assert_allclose(float(stats['losses'][k]),
                                 float(jstats['losses'][k]), rtol=TOL,
                                 err_msg=k)
    assert float(stats['losses']['interlevel']) > 0
    want = _flat(jax.device_get(jstats['grads']))
    assert set(grads) == set(want)
    for k, g in grads.items():
      _assert_grads(g, want[k], 2e-4, k)
    jparams = _flat(jax.device_get(jstate.params))
    for k, p in state.params().items():
      moved = max(1e-12, float(np.abs(jparams[k] - before[k]).max()))
      np.testing.assert_allclose(p.detach().numpy(), jparams[k], rtol=0,
                                 atol=2e-2 * moved, err_msg=k)
  return stats


def test_cascade_steps_match_jax_deterministic():
  # Config.randomized = False: no draw anywhere, as the shipped gins train;
  # from step 100,000 (annealing at train_frac 1/3; at steps 0 and 1 see
  # the next test).
  pair = _Pair(CASCADE + SMALL + ['Config.randomized = False'], seed=1)
  _steps(pair, None, start=100000)


def test_uniform_resampling_ties_at_the_first_steps():
  # Hazard H20. At train_frac 0 (steps 0 and 1) the annealing exponent is
  # 0, so deterministic resampling spreads every level evenly over the last
  # level's bins and the levels' edges fall on a common grid: JAX's edges
  # at 0.5 coincide exactly across levels, the port's lie an ulp apart (its
  # float32 linspace rounds otherwise). Every edge within 1e-6 of JAX's, but
  # the interlevel loss's lookup of a fine edge in the coarse histogram then
  # takes the neighbouring bin for that sample. The port's loss is JAX's
  # loss of the port's own histograms (1e-5); the size of the tie against
  # JAX's term is printed, not bounded.
  from refnerf_tpu.train import losses as jlosses
  from refnerf_tpu_torch.train import losses
  pair = _Pair(CASCADE + SMALL + ['Config.randomized = False'], seed=1)
  _, jhist = pair.jmodel.apply({'params': pair.params}, pair.jbatch.rays,
                               train_frac=0.0, compute_extras=False,
                               train=True)
  with torch.no_grad():
    _, hist = pair.model(pair.batch.rays, train_frac=0.0, train=True)
  for level in range(3):
    _close(hist[level]['sdist'], jhist[level]['sdist'], atol=1e-6)
    _close(hist[level]['weights'], jhist[level]['weights'], atol=1e-6)
  got = float(losses.interlevel_loss(hist, pair.config))
  as_jax = float(jlosses.interlevel_loss(
      [{k: jnp.asarray(h[k].numpy()) for k in ('sdist', 'weights')}
       for h in hist], pair.jconfig))
  np.testing.assert_allclose(got, as_jax, rtol=TOL)
  want = float(jlosses.interlevel_loss(jhist, pair.jconfig))
  print(f'H20: interlevel at train_frac 0: port {got:.7g}, JAX {want:.7g} '
        f'({abs(got - want) / want:.2%} apart)')


def test_cascade_steps_match_jax_with_jax_draws():
  # Config.randomized = True with the noise and a random background: the
  # port's step takes JAX's own draws (its key splits replayed), so every
  # jitter, noise and background value is JAX's.
  pair = _Pair(CASCADE + SMALL + NOISE, seed=2)
  stats = _steps(pair, jax_draws(pair.config.seed))
  assert all(np.isfinite(float(v)) for v in stats['losses'].values())


# --------------------------------------------------- the kernel routing


def _stubbed_kernels(monkeypatch):
  """use_kernel as on a card; the forward and backward kernels answer with
  the plain versions on the pack's own weights and record their routes.
  The forward op's CPU implementation stands in for its kernel, and counts
  nothing: the stub records its launches in `fwd_launches`, under the keys
  that the op's CUDA implementation adds to."""
  routes, fwd_launches = [], collections.Counter()

  def unpack(pack):
    ws, bs = _pack_weights(pack)
    head = lambda w, b: None if w is None else (w, b)
    return ws, bs, dict(
        skip_period=pack.skip - 1 if pack.skip > 0 else 99, wd=pack.wd,
        head_f32=head(pack.wh, pack.bh), head_cdt=head(pack.wc, pack.bc),
        compute_dtype=pack.compute_dtype)

  def kernel(segs, pack, fold=None, dir_modes=None, rgbx=None,
             spa_modes=None, comp=None, out_y=False):
    fused_mlp._instance_guard(pack, 0 if pack.wc is None else
                              int(pack.wc.shape[0]), fold,
                              dir_modes or fused_mlp.DirModes(),
                              spa_modes or fused_mlp.SpaModes(), out_y)
    routes.append(('fwd', pack.kin, fused_mlp.forward_library(
        pack, out_y, fold, spa_modes or fused_mlp.SpaModes())))
    fwd_launches.update(fused_mlp.launch_keys(
        fused_mlp.forward_kind(pack, fold), pack, out_y, fold,
        dir_modes or fused_mlp.DirModes(),
        spa_modes or fused_mlp.SpaModes()))
    ws, bs, kw = unpack(pack)
    return fused_mlp.trunk_reference(
        segs, ws, bs, density_grad=fold is not None, fold=fold,
        dir_modes=dir_modes, rgbx=rgbx, spa_modes=spa_modes, comp=comp,
        out_y=out_y, **kw)

  def backward(segs, pack, cots, fold=None, needs_dx=False, slab=None,
               dir_modes=None, rgbx=None, rgb_bar=None, spa_modes=None,
               comp=None, ybar=None):
    routes.append(('bwd', pack.kin, fused_mlp.backward_library(
        pack, ybar is not None, fold)))
    ws, bs, kw = unpack(pack)
    return fused_mlp.trunk_backward_reference(
        segs, ws, bs, cots, fold=fold, needs_dx=needs_dx,
        dir_modes=dir_modes, rgbx=rgbx, rgb_bar=rgb_bar,
        spa_modes=spa_modes, comp=comp, ybar=ybar, **kw)

  monkeypatch.setattr(fused_mlp, 'use_kernel',
                      lambda x, mode: fused_mlp.MODES.index(mode) < 2)
  monkeypatch.setattr(fused_mlp, 'trunk_plain', kernel)
  monkeypatch.setattr(fused_mlp, 'trunk_backward_kernel', backward)
  return routes, fwd_launches


@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
def test_wide_instance_routes_and_counts(monkeypatch, cdt):
  # The PropMLP at 256 wide, in f32 (the configuration's) and in bf16: with
  # the kernels stubbed by the plain versions on the pack's own weights,
  # its forward goes to trunk_wide_tf32.cu's head-0 instance (f32) or the
  # wide-input instance of trunk_fwd_tma.cu (bf16) and its backward to
  # trunk_wide_bwd_tf32.cu's or trunk_bwd_tma.cu's (both counted under 'K1
  # wide' / 'K4 wide': 2 a step, one a proposal level), the NerfMLP's to
  # the width-256 instances of trunk_fwd_f32.cu and trunk_bwd_f32.cu (f32)
  # or trunk_fwd_tma.cu and trunk_bwd_tma.cu (bf16); a step under 'on'
  # equals 'off' to the bit; and no shape of the step is without an
  # instance.
  routes, fwd_launches = _stubbed_kernels(monkeypatch)
  fwd, bwd = fused_mlp.FWD_LIBRARY[cdt], fused_mlp.BWD_LIBRARY[cdt]
  wide_fwd, wide_bwd = ((fused_mlp.WIDE_TF32_LIBRARY,
                         fused_mlp.WIDE_TF32_BWD_LIBRARY)
                        if cdt == 'float32' else (fwd, bwd))
  bindings = CASCADE + [
      'NerfMLP.net_depth = 2', 'NerfMLP.net_depth_viewdirs = 2',
      'NerfMLP.bottleneck_width = 128', 'Model.num_prop_samples = 8',
      'Model.num_nerf_samples = 8', 'Config.batch_size = 4',
      'Config.randomized = False', f"NerfMLP.compute_dtype = '{cdt}'",
      f"PropMLP.compute_dtype = '{cdt}'"]
  runs = {}
  for mode in ('on', 'off'):
    config, gin = configs.parse([GIN], bindings + [
        f"NerfMLP.fused_trunk = '{mode}'", f"PropMLP.fused_trunk = '{mode}'"])
    model = construct.construct_model(config, gin, 'cpu')
    pack = fused_mlp.pack_trunk(*model.prop_mlp._stack('spatial', 4),
                                (252, 252), wd=model.prop_mlp.raw_density.weight,
                                compute_dtype=cdt)
    assert pack.kin == 512 and fused_mlp.wide_input(pack)
    assert fused_mlp.missing_instance(pack, 0) is None
    r = _rays_np(4, 3)
    batch = rays_lib.Batch(rays=rays_lib.Rays(**{k: _t(v) for k, v in
                                                 r.items()}),
                           rgb=_t(np.full((4, 3), 0.5, np.float32)))
    before = dict(fused_mlp.launches)
    fwd_launches.clear()
    state = step_lib.create_train_state(config, model)
    state, stats = step_lib.make_train_step(model, config)(state, batch)
    runs[mode] = (stats, {k: v - before[k] + fwd_launches[k] for k, v in
                          fused_mlp.launches.items()}, model.state_dict())
  (on, n_on, p_on), (off, n_off, p_off) = runs['on'], runs['off']
  assert n_off == {k: 0 for k in n_off}
  assert n_on['K1 wide'] == n_on['K4 wide'] == 2 == n_on['K1']
  assert n_on['K3'] == n_on['K2'] == n_on['K5'] == 1 and n_on['K4'] == 3
  assert ('fwd', 512, wide_fwd) in routes and ('bwd', 512, wide_bwd) in routes
  assert {lib for _, kin, lib in routes if kin != 512} == {fwd, bwd}
  assert {lib for _, _, lib in routes} == {fwd, bwd, wide_fwd, wide_bwd}
  assert torch.equal(on['loss'], off['loss'])
  for k, v in p_on.items():
    assert torch.equal(v, p_off[k]), k


@pytest.mark.parametrize('case,lib,past', [
    ('f32 depth 4', 'trunk_wide_tf32', None),
    ('f32 depth 8', 'trunk_wide_tf32', None),
    ('f32 density gradient', 'trunk_fwd_f32', None),
    ('f32 bottleneck head', 'trunk_fwd_f32', None),
    ('f32 past the widest', 'trunk_fwd', 'trunk_fwd'),
    ('bf16 depth 4', 'trunk_fwd_tma', None),
    ('bf16 depth 8', 'trunk_fwd_tma', None),
    ('bf16 past the widest', 'trunk_fwd', None),
    ('bf16 density gradient', 'trunk_fwd_tma', None)])
def test_wide_input_routes_by_shape(case, lib, past):
  # The spatial trunk on 504 columns takes the wide-input instances, in f32
  # at the density head alone the TF32 libraries' head-0 instances
  # (trunk_wide_tf32.cu and trunk_wide_bwd_tf32.cu; kernel_smem within the
  # H100's 232,448 B: 214,560 B for the forward, 220,200 B for the backward
  # at depth 4 and 228,392 at depth 8), with the density gradient or the
  # 128-wide head of the FMA/TMA libraries (224,392 B for the forward with
  # the head, 230,792 for its backward; with the density gradient 229,384
  # and 224,568), in bf16 of
  # the wgmma/TMA ones (231,480 B for the forward, its 3-stage ring and the
  # density head's weights; 210,248 and 218,440 B for the backward at depth
  # 4 and 8; with the density gradient 214,456 and 204,008), the 128-wide
  # bottleneck head and the density gradient too; what they do not run stays
  # named by missing_instance, past shared memory on trunk_fwd.cu (more than
  # 1024 columns in f32), or runs trunk_fwd.cu / trunk_bwd.cu (bf16 past
  # 1024 columns).
  depth = 8 if 'depth 8' in case else 4
  fin = 1056 if 'widest' in case else 504
  skips = fused_mlp.skip_input_layers(depth, 4)
  ws = [torch.zeros(256, fin if l == 0 else 256 + (fin if l in skips else 0))
        for l in range(depth)]
  bs = [torch.zeros(256) for _ in range(depth)]
  head = ((torch.zeros(128, 256), torch.zeros(128))
          if 'bottleneck' in case else None)
  pack = fused_mlp.pack_trunk(ws, bs, (fin // 2, fin // 2), wd=torch.zeros(
      1, 256), head_cdt=head, compute_dtype='bfloat16' if 'bf16' in case
      else 'float32')
  fold = torch.zeros(fin // 2, 21) if 'gradient' in case else None
  assert fused_mlp.forward_library(pack, fold=fold) == lib
  why = fused_mlp.missing_instance(pack, 0 if head is None else 128, fold)
  if past is None:
    assert why is None
    want = {'f32 depth 4': (214560, 220200),
            'f32 depth 8': (214560, 228392),
            'f32 density gradient': (229384, 224568),
            'f32 bottleneck head': (224392, 230792),
            'bf16 depth 4': (231480, 210248),
            'bf16 depth 8': (231480, 218440),
            'bf16 density gradient': (214456, 204008)}.get(case)
    if want:
      bwd = (fused_mlp.WIDE_TF32_BWD_LIBRARY if lib == 'trunk_wide_tf32'
             else lib.replace('fwd', 'bwd'))
      hc = 0 if head is None else 128
      assert fused_mlp.wide_input(pack, fold=fold)
      assert fused_mlp.backward_library(pack, fold=fold) == bwd
      assert (fused_mlp.kernel_smem(lib, pack, hc, fold),
              fused_mlp.kernel_smem(bwd, pack, hc, fold)) == want
    else:
      assert not fused_mlp.wide_input(pack)
      assert fused_mlp.backward_library(pack) == 'trunk_bwd'
  else:
    assert why.startswith(f'{past}.cu needs '), why


class _ArgCheck:
  """A stand-in for a kernel library (ctypes): each entry point checks its
  arguments against cuda_build.EXPORTS (their number, and that each
  converts to its ctypes type: an int for a c_int, an int or None for a
  pointer), records the call and returns 0."""

  def __init__(self, calls):
    self.calls = calls

  def __getattr__(self, fn):
    from refnerf_tpu_torch.ops import cuda_build
    lib = next(lib for lib, fns in cuda_build.EXPORTS.items() if fn in fns)
    types = cuda_build.EXPORTS[lib][fn]

    def call(*args):
      assert len(args) == len(types), (fn, len(args), len(types))
      for i, (a, t) in enumerate(zip(args, types)):
        assert not isinstance(a, torch.Tensor), (fn, i)
        t.from_param(a)  # raises TypeError on a wrong type
      self.calls.append((fn, args))
      return 1 if fn == 'refnerf_trunk_supports' else 0
    return call


@pytest.mark.parametrize('depth', [4, 8])
def test_wide_bf16_launch_arguments_match_exports(monkeypatch, depth):
  # The bf16 PropMLP trunk's launches through trunk_kernel and
  # trunk_backward_kernel, on CPU tensors with the libraries replaced by
  # _ArgCheck: the forward calls refnerf_trunk_fwd_tma and the backward
  # refnerf_trunk_bwd_tma, refnerf_wgrad_tma (layer 0's 512-column and the
  # skip layer's 768-column gradients) and refnerf_reduce, each with the
  # argument list cuda_build.EXPORTS declares, the compute dtype 1 and 512
  # input columns.
  from refnerf_tpu_torch.ops import cuda_build
  import contextlib
  calls = []
  fake = _ArgCheck(calls)
  monkeypatch.setattr(cuda_build, 'library', lambda name: fake)
  monkeypatch.setattr(torch.cuda, 'device', lambda dev: contextlib.nullcontext())
  monkeypatch.setattr(torch.cuda, 'current_stream',
                      lambda dev=None: type('S', (), {'cuda_stream': 0})())
  rng = np.random.default_rng(7)
  ks, bs, wd, _ = _prop_trunk_params(rng, depth, width=256)
  n = 100
  segs = [_t(rng.normal(size=(n, 252)).astype(np.float32)).bfloat16()
          for _ in range(2)]
  pack = fused_mlp.pack_trunk([_t(k.T) for k in ks], [_t(b) for b in bs],
                              (252, 252), wd=_t(wd.T),
                              compute_dtype='bfloat16')
  assert fused_mlp.wide_input(pack)
  fused_mlp.trunk_kernel(segs, pack)
  fused_mlp.trunk_backward_kernel(segs, pack, (torch.ones(n), None, None,
                                               None))
  names = [fn for fn, _ in calls if fn != 'refnerf_trunk_supports']
  assert names[0] == 'refnerf_trunk_fwd_tma'
  assert names[1] == 'refnerf_trunk_bwd_tma'
  assert names.count('refnerf_wgrad_tma') == depth
  assert set(names[2:]) == {'refnerf_wgrad_tma', 'refnerf_reduce'}
  for fn, args in calls:
    if fn.startswith('refnerf_trunk_') and fn != 'refnerf_trunk_supports':
      assert args[:3] == (1, 256, 0) and args[8] == 512, (fn, args[:9])
  wgrad_n = [args[2] for fn, args in calls if fn == 'refnerf_wgrad_tma']
  assert wgrad_n[0] == 512 and (depth == 4 or wgrad_n[5] == 768)
