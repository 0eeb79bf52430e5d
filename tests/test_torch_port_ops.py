"""The port's ops against their JAX counterparts on the same numpy inputs.

Every function of refnerf_tpu_torch/ops (mathx, stepfun, coord, ref_utils,
image) and models/render.py is run on arrays made with
np.random.default_rng and compared with the JAX function in float32.
Tolerance 1e-5 (absolute and relative): the two libraries' elementwise
kernels and summation orders differ only in the last bits of f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from refnerf_tpu.models import render as jrender
from refnerf_tpu.ops import coord as jcoord
from refnerf_tpu.ops import image as jimage
from refnerf_tpu.ops import mathx as jmathx
from refnerf_tpu.ops import ref_utils as jref_utils
from refnerf_tpu.ops import stepfun as jstepfun
from refnerf_tpu_torch.models import render
from refnerf_tpu_torch.ops import coord
from refnerf_tpu_torch.ops import image
from refnerf_tpu_torch.ops import mathx
from refnerf_tpu_torch.ops import ref_utils
from refnerf_tpu_torch.ops import stepfun

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
  return torch.tensor(np.asarray(a, np.float32))


def _close(port, ref, **tol):
  np.testing.assert_allclose(port.numpy(), np.asarray(ref), **(tol or TOL))


def _sorted_bins(rng, shape, n, zero_width=True):
  """Sorted endpoints [..., n] with some repeated (zero-width) bins."""
  t = np.sort(rng.uniform(0, 1, shape + (n,)), axis=-1)
  if zero_width:
    t[..., 3] = t[..., 2]
    t[..., -2] = t[..., -1]
  return t.astype(np.float32)


@pytest.mark.parametrize('fn', ['safe_sin', 'safe_cos'])
def test_safe_trig_large_and_negative_args(fn):
  # Around +-2^15, the largest IPE arguments at max_deg_point = 16: the
  # reduction must be jnp's floor-mod (torch.remainder), not fmod.
  rng = np.random.default_rng(0)
  x = np.concatenate([
      rng.uniform(-2**15 - 50, -2**15 + 50, 200),
      rng.uniform(2**15 - 50, 2**15 + 50, 200),
      rng.uniform(-400, 400, 200), [-100 * np.pi, 100 * np.pi, 0.0]])
  x = x.astype(np.float32)
  _close(getattr(mathx, fn)(_t(x)), getattr(jmathx, fn)(jnp.asarray(x)))


def test_safe_trig_arg_is_floor_mod():
  x = _t([-32767.5, -1000.0, 32767.5, 1.0])
  r = mathx.safe_trig_arg(x).numpy()
  assert (r[:3] >= 0).all() and r[3] == 1.0


def test_sorted_interp_with_zero_width_bins():
  rng = np.random.default_rng(1)
  xp = _sorted_bins(rng, (5,), 12)
  fp = np.sort(rng.uniform(-2, 3, (5, 12)), axis=-1).astype(np.float32)
  x = rng.uniform(-0.1, 1.1, (5, 20)).astype(np.float32)
  x[:, 0] = xp[:, 3]  # exactly on a zero-width bin
  _close(mathx.sorted_interp(_t(x), _t(xp), _t(fp)),
         jmathx.sorted_interp(jnp.asarray(x), jnp.asarray(xp),
                              jnp.asarray(fp)))


def test_integrate_weights_and_invert_cdf():
  rng = np.random.default_rng(2)
  t = _sorted_bins(rng, (4,), 17)
  logits = rng.normal(size=(4, 16)).astype(np.float32)
  logits[:, 5] = -np.inf
  w = np.asarray(jnp.exp(logits) / jnp.exp(logits).sum(-1, keepdims=True))
  _close(stepfun.integrate_weights(_t(w)),
         jstepfun.integrate_weights(jnp.asarray(w)))
  u = np.sort(rng.uniform(0, 1, (4, 9)), axis=-1).astype(np.float32)
  _close(stepfun.invert_cdf(_t(u), _t(t), _t(logits)),
         jstepfun.invert_cdf(jnp.asarray(u), jnp.asarray(t),
                             jnp.asarray(logits)))


@pytest.mark.parametrize('center', [False, True])
def test_sample_deterministic(center):
  rng = np.random.default_rng(3)
  t = _sorted_bins(rng, (3, 2), 9)
  logits = rng.normal(size=(3, 2, 8)).astype(np.float32)
  _close(stepfun.sample(_t(t), _t(logits), 16, deterministic_center=center),
         jstepfun.sample(None, jnp.asarray(t), jnp.asarray(logits), 16,
                         deterministic_center=center))


@pytest.mark.parametrize('domain', [(-np.inf, np.inf), (0.0, 1.0)])
def test_sample_intervals(domain):
  rng = np.random.default_rng(4)
  t = _sorted_bins(rng, (6,), 11, zero_width=False)
  logits = rng.normal(size=(6, 10)).astype(np.float32)
  _close(stepfun.sample_intervals(_t(t), _t(logits), 16, domain=domain),
         jstepfun.sample_intervals(None, jnp.asarray(t), jnp.asarray(logits),
                                   16, domain=domain))


def test_ray_warps_identity():
  rng = np.random.default_rng(5)
  near = rng.uniform(0.5, 2, (7, 1)).astype(np.float32)
  far = near + rng.uniform(1, 4, (7, 1)).astype(np.float32)
  s = rng.uniform(0, 1, (7, 5)).astype(np.float32)
  t_to_s, s_to_t = coord.construct_ray_warps(None, _t(near), _t(far))
  jt_to_s, js_to_t = jcoord.construct_ray_warps(None, jnp.asarray(near),
                                                jnp.asarray(far))
  _close(s_to_t(_t(s)), js_to_t(jnp.asarray(s)))
  tt = np.asarray(js_to_t(jnp.asarray(s)))
  _close(t_to_s(_t(tt)), jt_to_s(jnp.asarray(tt)))
  with pytest.raises(NotImplementedError):
    coord.construct_ray_warps('reciprocal', _t(near), _t(far))


def test_lift_and_diagonalize():
  rng = np.random.default_rng(6)
  mean = rng.normal(size=(4, 5, 3)).astype(np.float32)
  a = rng.normal(size=(4, 5, 3, 3)).astype(np.float32)
  cov = a @ np.swapaxes(a, -1, -2)
  basis = rng.normal(size=(3, 7)).astype(np.float32)
  for port, ref in zip(
      coord.lift_and_diagonalize(_t(mean), _t(cov), _t(basis)),
      jcoord.lift_and_diagonalize(jnp.asarray(mean), jnp.asarray(cov),
                                  jnp.asarray(basis))):
    _close(port, ref)


def test_reflect_and_l2_normalize():
  rng = np.random.default_rng(7)
  v = rng.normal(size=(9, 3)).astype(np.float32)
  n = rng.normal(size=(9, 3)).astype(np.float32)
  n[0] = 0.0  # the eps clamp
  _close(ref_utils.l2_normalize(_t(n)), jref_utils.l2_normalize(jnp.asarray(n)))
  nn_ = np.asarray(jref_utils.l2_normalize(jnp.asarray(n)))
  _close(ref_utils.reflect(_t(v), _t(nn_)),
         jref_utils.reflect(jnp.asarray(v), jnp.asarray(nn_)))


@pytest.mark.parametrize('deg_view', [2, 5])
def test_ide_matches(deg_view):
  for port, ref in zip(ref_utils.ide_constants(deg_view),
                       jref_utils._ide_constants(deg_view)):
    np.testing.assert_array_equal(port, ref)
  rng = np.random.default_rng(8)
  xyz = rng.normal(size=(6, 4, 3)).astype(np.float32)
  xyz /= np.linalg.norm(xyz, axis=-1, keepdims=True)
  kappa_inv = rng.uniform(0, 2, (6, 4, 1)).astype(np.float32)
  _close(ref_utils.generate_ide_fn(deg_view)(_t(xyz), _t(kappa_inv)),
         jref_utils.generate_ide_fn(deg_view)(jnp.asarray(xyz),
                                              jnp.asarray(kappa_inv)))


def test_linear_to_srgb():
  x = np.linspace(-0.1, 1.2, 301).astype(np.float32)
  _close(image.linear_to_srgb(_t(x)), jimage.linear_to_srgb(jnp.asarray(x)))


def _rays(rng, n, s):
  origins = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
  dirs = rng.normal(size=(n, 3)).astype(np.float32)
  radii = rng.uniform(1e-3, 1e-2, (n, 1)).astype(np.float32)
  tdist = np.sort(rng.uniform(2, 6, (n, s + 1)), axis=-1).astype(np.float32)
  return origins, dirs, radii, tdist


@pytest.mark.parametrize('ray_shape', ['cone', 'cylinder'])
def test_cast_rays(ray_shape):
  o, d, r, tdist = _rays(np.random.default_rng(9), 5, 8)
  port = render.cast_rays(_t(tdist), _t(o), _t(d), _t(r), ray_shape)
  ref = jrender.cast_rays(jnp.asarray(tdist), jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(r), ray_shape, diag=False)
  for a, b in zip(port, ref):
    _close(a, b)


@pytest.mark.parametrize('opaque', [False, True])
def test_compute_alpha_weights(opaque):
  rng = np.random.default_rng(10)
  _, d, _, tdist = _rays(rng, 5, 8)
  density = rng.uniform(0, 3, (5, 8)).astype(np.float32)
  for a, b in zip(
      render.compute_alpha_weights(_t(density), _t(tdist), _t(d), opaque),
      jrender.compute_alpha_weights(jnp.asarray(density), jnp.asarray(tdist),
                                    jnp.asarray(d), opaque)):
    _close(a, b)


def test_volumetric_rendering():
  rng = np.random.default_rng(11)
  _, _, _, tdist = _rays(rng, 5, 8)
  c = [rng.uniform(0, 1, (5, 8, 3)).astype(np.float32) for _ in range(3)]
  w = rng.uniform(0, 0.12, (5, 8)).astype(np.float32)
  far = np.full((5, 1), 6.0, np.float32)
  port = render.volumetric_rendering(*map(_t, c), _t(w), _t(tdist), 1.0)
  ref = jrender.volumetric_rendering(
      *map(jnp.asarray, c), jnp.asarray(w), jnp.asarray(tdist), 1.0,
      jnp.asarray(far), compute_extras=False)
  assert set(port) == set(ref)
  for k in port:
    _close(port[k], ref[k])
