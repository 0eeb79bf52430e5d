"""The train step's step-function ops, noisy-view rays and consistency ratio
against the JAX package, on the CPU.

- `stepfun.searchsorted` (ties with an entry, repeated entries, queries below
  and above the range), `query`, `inner_outer`, `lossfun_outer`,
  `lossfun_distortion` and `interval_distortion`: float32, the values and
  (where differentiable) their gradients.
- `sampling.euler_angles_to_matrix` and `sampling.sample_noisy_rays` with
  JAX's own draw (the key JAX's step splits), on flat and on [n, 2, 2]
  patch bundles, and with the noise rays clamped to a small batch.
- The port's own draw (`draw_noise_angles`, seeded from (seed, step)):
  repeatable, in range and uniform (H3: JAX's stream differs).
- `step._consistency_ratio` with warmup, with decay, and with the windows
  off, against JAX's traced arithmetic.

Tolerances are stated at each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from refnerf_tpu import configs as jconfigs
from refnerf_tpu.cameras import rays as jrays
from refnerf_tpu.ops import stepfun as jstepfun
from refnerf_tpu.train import sampling as jsampling
from refnerf_tpu.train import step as jstep
from refnerf_tpu_torch import configs
from refnerf_tpu_torch.cameras import rays as rays_lib
from refnerf_tpu_torch.ops import stepfun
from refnerf_tpu_torch.train import sampling
from refnerf_tpu_torch.train import step as step_lib

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
GEO_GIN = 'configs/llff_refnerf_geometry_losses.gin'


def _t(a, dtype=np.float32):
  return torch.tensor(np.asarray(a, dtype))


def _close(port, ref, **tol):
  np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                             **(tol or TOL))


def _bins(rng, shape, n):
  """Sorted endpoints [..., n] with repeated entries (zero-width bins)."""
  t = np.sort(rng.uniform(0, 1, shape + (n,)), axis=-1)
  t[..., 3] = t[..., 2]
  t[..., -2] = t[..., -1]
  return t.astype(np.float32)


def test_searchsorted_ties_and_out_of_range_match_jax():
  # Exact (integer indices): queries on every entry (ties), on a repeated
  # entry, between entries, below the first and above the last.
  rng = np.random.default_rng(0)
  a = _bins(rng, (4,), 9)
  v = np.concatenate([a, a[:, [2]], (a[:, :-1] + a[:, 1:]) / 2,
                      a[:, :1] - 1, a[:, -1:] + 1,
                      rng.uniform(-0.2, 1.2, (4, 12))], -1).astype(np.float32)
  lo, hi = stepfun.searchsorted(_t(a), _t(v))
  jlo, jhi = jstepfun.searchsorted(jnp.asarray(a), jnp.asarray(v))
  np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
  np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
  # Out of range clamps both ends; a tie counts as at or above the entry.
  assert (lo[:, 9 + 1 + 8] == 0).all() and (hi[:, 9 + 1 + 8] == 0).all()
  assert (lo[:, 9 + 1 + 8 + 1] == 8).all() and (hi[:, 9 + 1 + 8 + 1] == 8).all()
  assert (lo[:, 9] == 3).all() and (hi[:, 9] == 4).all()  # a[2] == a[3]


def test_searchsorted_broadcasts_as_jax():
  # One sorted array against a batch of queries: exact.
  rng = np.random.default_rng(1)
  a = _bins(rng, (), 7)
  v = rng.uniform(-0.1, 1.1, (3, 5, 6)).astype(np.float32)
  lo, hi = stepfun.searchsorted(_t(a), _t(v))
  jlo, jhi = jstepfun.searchsorted(jnp.asarray(a), jnp.asarray(v))
  np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
  np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))


@pytest.mark.parametrize('outside', [0.0, -2.5])
def test_query_matches_jax(outside):
  # Exact: a lookup, with queries outside the support and on its ends.
  rng = np.random.default_rng(2)
  t = _bins(rng, (5,), 8)
  y = rng.normal(size=(5, 7)).astype(np.float32)
  tq = np.concatenate([t, rng.uniform(-0.3, 1.3, (5, 9))], -1)
  got = stepfun.query(_t(tq), _t(t), _t(y), outside)
  want = jstepfun.query(jnp.asarray(tq, jnp.float32), jnp.asarray(t),
                        jnp.asarray(y), outside)
  np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_inner_outer_matches_jax():
  # float32 cumulative sums: 1e-5 relative, 1e-6 absolute.
  rng = np.random.default_rng(3)
  t0 = _bins(rng, (6,), 11)
  t1 = _bins(rng, (6,), 9)
  y1 = rng.uniform(size=(6, 8)).astype(np.float32)
  inner, outer = stepfun.inner_outer(_t(t0), _t(t1), _t(y1))
  jinner, jouter = jstepfun.inner_outer(jnp.asarray(t0), jnp.asarray(t1),
                                        jnp.asarray(y1))
  _close(inner, jinner)
  _close(outer, jouter)


def test_lossfun_outer_and_distortion_match_jax():
  # Values and gradients (with respect to every input) in float32: 1e-5
  # relative, 1e-6 absolute. Some bins of w exceed their envelope, some sit
  # below it, and one sits exactly on it (the maximum's tie, H1).
  rng = np.random.default_rng(4)
  t = _bins(rng, (5,), 10)
  t_env = _bins(rng, (5,), 13)
  w_env = rng.dirichlet(np.ones(12), 5).astype(np.float32)
  w = rng.dirichlet(np.ones(9), 5).astype(np.float32)
  _, w_outer = jstepfun.inner_outer(jnp.asarray(t), jnp.asarray(t_env),
                                    jnp.asarray(w_env))
  w[0, 4] = np.asarray(w_outer)[0, 4]
  args = [t, w, t_env, w_env]

  def jloss(*a):
    return jnp.sum(jstepfun.lossfun_outer(*a) * jnp.arange(1, 6)[:, None])

  targs = [_t(x).requires_grad_(True) for x in args]
  loss = stepfun.lossfun_outer(*targs)
  _close(loss, jstepfun.lossfun_outer(*map(jnp.asarray, args)))
  got = torch.autograd.grad(
      torch.sum(loss * torch.arange(1, 6)[:, None]), targs, allow_unused=True)
  want = jax.grad(jloss, argnums=(0, 1, 2, 3))(*map(jnp.asarray, args))
  for g, x, wg in zip(got, targs, want):
    # The endpoints reach the loss through indices alone: no gradient.
    _close(torch.zeros_like(x) if g is None else g, wg)

  tw = [_t(t).requires_grad_(True), _t(w).requires_grad_(True)]
  dist = stepfun.lossfun_distortion(*tw)
  _close(dist, jstepfun.lossfun_distortion(jnp.asarray(t), jnp.asarray(w)))
  got = torch.autograd.grad(dist.sum(), tw)
  want = jax.grad(lambda a, b: jstepfun.lossfun_distortion(a, b).sum(),
                  argnums=(0, 1))(jnp.asarray(t), jnp.asarray(w))
  for g, wg in zip(got, want):
    _close(g, wg)


def test_interval_distortion_matches_jax():
  # Disjoint, overlapping and nested intervals: float32, 1e-5 relative.
  rng = np.random.default_rng(5)
  ends = np.sort(rng.uniform(0, 1, (4, 64)), axis=0).astype(np.float32)
  perm = [(0, 1, 2, 3), (0, 2, 1, 3), (0, 3, 1, 2), (2, 3, 0, 1)]
  for p in perm:
    args = [ends[i] for i in p]
    _close(stepfun.interval_distortion(*map(_t, args)),
           jstepfun.interval_distortion(*map(jnp.asarray, args)))


def test_euler_angles_to_matrix_matches_jax():
  # float32 products of sines and cosines: 1e-6 absolute.
  rng = np.random.default_rng(6)
  angles = rng.uniform(-np.pi, np.pi, (2, 4, 3)).astype(np.float32)
  got = sampling.euler_angles_to_matrix(_t(angles))
  _close(got, jsampling.euler_angles_to_matrix(jnp.asarray(angles)),
         rtol=0, atol=1e-6)
  eye = got @ got.transpose(-1, -2)
  _close(eye, np.broadcast_to(np.eye(3), eye.shape), rtol=0, atol=1e-6)
  with pytest.raises(ValueError):
    sampling.euler_angles_to_matrix(_t(np.zeros((3, 2))))


def _rays_np(rng, shape):
  d = rng.normal(size=shape + (3,)).astype(np.float32)
  f = lambda k: rng.uniform(0.5, 1, shape + (k,)).astype(np.float32)
  return dict(origins=rng.normal(size=shape + (3,)).astype(np.float32),
              directions=d,
              viewdirs=d / np.linalg.norm(d, axis=-1, keepdims=True),
              radii=f(1), imageplane=f(2), lossmult=f(1), near=f(1) * 0,
              far=f(1) + 1,
              cam_idx=rng.integers(0, 5, shape + (1,)).astype(np.int32))


def _jax_angles(seed, step, n_angles, max_range, ratio):
  """The angles JAX's step draws: the second key of split(fold_in(
  PRNGKey(seed), step), 3) (step.py:159-183, sampling.py:58-60)."""
  key = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), step),
                         3)[1]
  return np.asarray(jax.random.uniform(
      key, (n_angles, 3), minval=0.0,
      maxval=max_range / 180.0 * jnp.pi * jnp.float32(ratio)))


@pytest.mark.parametrize('shape,noise_size', [
    ((12,), 5), ((12,), 128), ((6, 2, 2), 4), ((3, 2, 2), 128)],
    ids=['flat', 'flat_clamped', 'patch', 'patch_clamped'])
def test_sample_noisy_rays_matches_jax(shape, noise_size):
  # JAX's own draw (4 angles, 5 degrees, ratio 0.7) through both maps.
  # float32: the rotated directions and view directions 1e-6 absolute,
  # the origins (o + d t - d' t, t ~ 3) 1e-5; every tiled field exact.
  rng = np.random.default_rng(7)
  r = _rays_np(rng, shape)
  distance = rng.uniform(1, 5, shape + (1,)).astype(np.float32)
  angles = _jax_angles(20230227, 11, 4, 5, 0.7)
  want = jsampling.sample_noisy_rays(
      jax.random.split(jax.random.fold_in(jax.random.PRNGKey(20230227), 11),
                       3)[1], jrays.Rays(**{k: jnp.asarray(v)
                                            for k, v in r.items()}),
      {'distance': jnp.asarray(distance)}, 5, noise_size, 4,
      jnp.float32(0.7))
  got = sampling.sample_noisy_rays(
      rays_lib.Rays(**{k: torch.tensor(v) for k, v in r.items()}),
      {'distance': _t(distance).requires_grad_(True)}, _t(angles),
      noise_size)
  n = min(noise_size, shape[0])
  assert got.origins.shape == (n * 4,) + shape[1:] + (3,)
  assert not got.origins.requires_grad
  for k in ('directions', 'viewdirs'):
    _close(getattr(got, k), getattr(want, k), rtol=0, atol=1e-6)
  _close(got.origins, want.origins, rtol=0, atol=1e-5)
  for k in ('radii', 'imageplane', 'lossmult', 'near', 'far', 'cam_idx'):
    np.testing.assert_array_equal(getattr(got, k).numpy(),
                                  np.asarray(getattr(want, k)))
  # Sample-major: ray 1's four copies follow ray 0's.
  np.testing.assert_array_equal(got.near[4:8].numpy(),
                                np.repeat(r['near'][1:2], 4, 0))


def test_sample_noisy_rays_keeps_the_surface_point():
  # Each rotated ray reaches the same expected surface point: float32,
  # 1e-5 absolute.
  rng = np.random.default_rng(8)
  r = _rays_np(rng, (9,))
  dist = rng.uniform(1, 3, (9, 1)).astype(np.float32)
  got = sampling.sample_noisy_rays(
      rays_lib.Rays(**{k: torch.tensor(v) for k, v in r.items()}),
      {'distance': _t(dist)}, _t(rng.uniform(0, 0.1, (3, 3))), 9)
  point = torch.repeat_interleave(_t(r['origins'] + r['directions'] * dist),
                                  3, 0)
  _close(got.origins + got.directions * torch.repeat_interleave(
      _t(dist), 3, 0), point.numpy(), rtol=0, atol=1e-5)


def test_noise_angles_are_seeded_from_seed_and_step():
  # H4: the same (seed, step) draws the same angles, whatever was drawn
  # before; another step or seed draws others. H3: the stream is the port's
  # own, so it is tested statistically: 4,000 draws of [4, 3] angles lie in
  # [0, max_angle) and are uniform there (Kolmogorov-Smirnov p > 1e-3, and
  # the mean within 5 standard errors of max/2).
  max_angle = sampling.max_noise_angle(5, 1.0)
  a = sampling.draw_noise_angles(7, 150000, 4, max_angle)
  sampling.draw_noise_angles(7, 3, 4, max_angle)
  assert torch.equal(a, sampling.draw_noise_angles(7, 150000, 4, max_angle))
  assert not torch.equal(a, sampling.draw_noise_angles(7, 150001, 4,
                                                       max_angle))
  assert not torch.equal(a, sampling.draw_noise_angles(8, 150000, 4,
                                                       max_angle))
  draws = torch.cat([sampling.draw_noise_angles(7, s, 4, max_angle).flatten()
                     for s in range(4000)]).numpy()
  assert draws.dtype == np.float32
  assert draws.min() >= 0 and draws.max() < max_angle
  assert scipy.stats.kstest(draws / max_angle, 'uniform').pvalue > 1e-3
  se = max_angle / np.sqrt(12 * draws.size)
  assert abs(draws.mean() - max_angle / 2) < 5 * se
  # At ratio 0 (step 0 under warmup) every angle is exactly 0.
  assert sampling.max_noise_angle(5, 0.0) == 0.0
  assert not sampling.draw_noise_angles(7, 0, 4, 0.0).any()
  # The bound as JAX computes it in float32.
  assert max_angle == float(jnp.float32(5 / 180.0 * jnp.pi) *
                            jnp.float32(1.0))


@pytest.mark.parametrize('bindings', [
    [],
    ['Config.consistency_warmup_steps = 0.6'],
    ['Config.consistency_decay_steps = 0.6'],
    ['Config.consistency_warmup_steps = 0.2',
     'Config.consistency_decay_steps = 0.7', 'Config.max_steps = 1001'],
    ['Config.consistency_warmup_steps = 0.0',
     'Config.consistency_decay_steps = 1.5']],
    ids=['gin', 'warmup', 'decay', 'both', 'off'])
def test_consistency_ratio_matches_jax(bindings):
  # Exact (float32 on the host against JAX's traced float32), at the ends of
  # each window, inside them and past them.
  config, _ = configs.parse([GEO_GIN], bindings)
  jconfig, _ = jconfigs.parse([GEO_GIN], bindings)
  m = config.max_steps
  for step in sorted({0, 1, 2, 20, m // 7, m // 5, m // 5 + 1, 3 * m // 5 - 1,
                      3 * m // 5, 3 * m // 5 + 1, int(0.7 * m), m - 1, m,
                      m + 10}):
    got = step_lib._consistency_ratio(config, step)
    want = float(jstep._consistency_ratio(jconfig, jnp.float32(step)))
    assert got == want, (step, got, want)
  assert isinstance(step_lib._consistency_ratio(config, 5), float)
