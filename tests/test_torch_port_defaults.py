"""The JAX package's default Model in the port against the JAX package, on
the CPU, and the contract of its spatial trunk's kernel instances.

The configuration is `refnerf_tpu_torch/testing/mlp_defaults.py`'s
DEFAULTS (none: `Config()`, the Model's and the MLP's defaults; 3 levels of
64, 64 and 32 samples on two MLPs of 8 x 256 with the 256-wide bottleneck,
504 IPE columns, density normals on) and DEFAULTS_NORMALS (the orientation
loss on the density normals, which sends a nonzero cotangent of u into the
trunk's backward).

- the bindings in both packages (the defaults' shapes; the orientation
  loss read by both losses);
- the model cut to size (both MLPs 2 x 32 with a 16-wide bottleneck and a
  1 x 16 directional trunk, 8 + 8 + 8 samples, batch 8; still 504 IPE
  columns and density normals): a render, and two train steps with JAX's
  draws handed in (H3), under DEFAULTS and DEFAULTS_NORMALS, in float32 and
  bfloat16, against JAX with fused_trunk='on' (its Pallas trunks in
  interpret mode);
- a CPU model of the wide-input instances' chunked contract
  (`mlp_defaults.chunked_density_grad`: paired sin / cos chunks, a partial
  last chunk, the skip layer's input columns) against `_inner_chain` with
  `fold_density_grad`, against JAX `reference_encoded_trunk` with
  `density_grad=True` (u, and the gradients through `jax.vjp` with a
  nonzero cotangent of u) on 504 columns at 40 rows, and its planted faults
  above chip_smoke.py's bounds;
- the routing of the defaults' spatial trunk (8 x 256 on 504 columns, the
  density head, a 128- or 256-wide bottleneck, with and without the density
  gradient) to the wide-input instances in both dtypes (the f32 density
  gradient with the 256-wide head to csrc/trunk_wide_tf32.cu), within an
  H100's shared memory, and the launch counts of a defaults step and
  request under 'on' at full width with the kernels stubbed by their plain
  versions;
- csrc/trunk_wide_tf32.cu's arithmetic on the CPU: its weight panels
  (`fused_mlp.tf32_panels`) run in the kernel's order in exact f32 against
  `trunk_reference` (1e-6 of the largest entry), and as three TF32 passes
  with 32-deep f32 slice sums (tests/test_torch_port_mipnerf360.py
  `_truncated_product`) against JAX `reference_encoded_trunk` within
  chip_smoke.py's KERNEL_BOUND, one pass (hi.hi) above it;
- the bf16 backward's tangent read back at the skip layer (the chunked
  model's `skip_tangent='scratch'`) bit for bit the tangent made again
  there, its fault still above the bound.

Tolerances. Against JAX 'on', float32 1e-5 (renders, loss terms), the
gradients 2e-4 of their largest entry and the parameters after a step 2e-2
of their largest move, as tests/test_torch_port_mipnerf360.py; bfloat16
1e-2 (renders, loss terms, the resampled distances: a bf16 rounding flip,
2^-8 relative, in a trunk moves an output by a fraction of that,
tests/test_torch_port_model.py) and the gradients 5e-2 of their largest
entry (tests/test_torch_port_train.py). Under DEFAULTS_NORMALS in float32
the orientation term 1e-3, the gradients 2e-3 and the parameters 2e-1 of
their largest move (ten times the others'): the density normals are
u, whose degree-11 terms carry sin and cos of m = 2^11 lm; the two packages
lift the means in another order, an ulp of lm is an ulp of m (2.4e-4 near
|m| = 3000), and the normals move by up to 1e-3 (measured 1.0e-3 on this
cut; the trunks' own u agree to 1.5e-7, and the terms that do not read the
normals stay within 1e-5).
The chunked model against the plain chain: float32 1e-6 of the largest
entry (the same products summed in another order), bfloat16 likewise on u
(an f32 sum of the same bf16 operands) and 5e-3 on the gradients (the
tangent pushed through bf16 layers in another order flips rounding); against
JAX (a trunk 64 wide) 1e-5 and 2e-4 in float32. The faults must read above
chip_smoke.py's GRAD_BOUND (relative L2).
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
from refnerf_tpu.ops.pallas import fused_mlp as jfused
from refnerf_tpu_torch import configs
from refnerf_tpu_torch import convert
from refnerf_tpu_torch.cameras import rays as rays_lib
from refnerf_tpu_torch.models import construct
from refnerf_tpu_torch.models import renderer
from refnerf_tpu_torch.ops import fused_mlp
from refnerf_tpu_torch.testing import mlp_defaults
from refnerf_tpu_torch.testing.mlp_defaults import DEFAULTS, DEFAULTS_NORMALS
from refnerf_tpu_torch.train import step as step_lib
from tests.test_torch_port_cascade import (_ArgCheck, _params,
                                           _stubbed_kernels, jax_draws)
from tests.test_torch_port_losses import (_assert_grads, _flat as _flat_tree,
                                          _jax_step_with_grads)
from tests.test_torch_port_mipnerf360 import (KERNEL_BOUND, _tf32_product,
                                              _truncated_product)

torch.set_num_threads(1)

# Cut to size (widths, depths, samples, batch); the encoding, the heads and
# the density normals as the defaults have them.
SMALL = ['NerfMLP.net_depth = 2', 'NerfMLP.net_width = 32',
         'NerfMLP.bottleneck_width = 16', 'NerfMLP.net_width_viewdirs = 16',
         'PropMLP.net_depth = 2', 'PropMLP.net_width = 32',
         'PropMLP.bottleneck_width = 16', 'PropMLP.net_width_viewdirs = 16',
         'Model.num_prop_samples = 8', 'Model.num_nerf_samples = 8',
         'Config.batch_size = 8']
ON = ["NerfMLP.fused_trunk = 'on'", "PropMLP.fused_trunk = 'on'"]
CONFIGS = {'defaults': DEFAULTS, 'normals': DEFAULTS_NORMALS}
TOL = {'float32': 1e-5, 'bfloat16': 1e-2}
GRAD_TOL = {'float32': 2e-4, 'bfloat16': 5e-2}
# DEFAULTS_NORMALS in float32: the orientation term and the gradients, which
# read the density normals (the module docstring).
NORMALS_TOL, NORMALS_GRAD_TOL = 1e-3, 2e-3
# chip_smoke.py's bound on derivatives (relative L2), which the planted
# faults must read above.
GRAD_BOUND = {'float32': 5e-3, 'bfloat16': 5e-2}
SCALES = tuple(float(2**d) for d in range(12))  # max_deg_point 12
NB = 21  # the icosahedron basis at 2 subdivisions


def _t(a):
  return torch.tensor(np.ascontiguousarray(a))


def _np(x):
  return np.asarray(jnp.asarray(x, jnp.float32))


def _cdt(cdt):
  return [f"NerfMLP.compute_dtype = '{cdt}'",
          f"PropMLP.compute_dtype = '{cdt}'"]


# --------------------------------------------------------- the bindings


def test_defaults_are_the_mlps_own():
  # No binding: the Model and the MLP at their defaults in both packages,
  # the spatial trunk of 8 x 256 on 504 IPE columns with the skip at layer
  # 5, the 256-wide bottleneck and density normals, at both levels' MLPs;
  # DEFAULTS_NORMALS turns the orientation loss on the density normals on.
  assert DEFAULTS == []
  for bindings, mult in ((DEFAULTS, 0.0), (DEFAULTS_NORMALS, 0.1)):
    jconfig, _ = jconfigs.parse([], bindings)
    config, gin = configs.parse([], bindings)
    for c in (jconfig, config):
      assert c.orientation_loss_mult == mult and c.batch_size == 16384
    assert config.orientation_loss_target == jconfig.orientation_loss_target
    model = construct.construct_model(config, gin, 'cpu')
    assert (model.cfg.num_levels, model.cfg.num_prop_samples,
            model.cfg.num_nerf_samples) == (3, 64, 32)
    for mlp in (model.prop_mlp, model.nerf_mlp):
      assert mlp.cfg.net_depth == 8 and mlp.cfg.net_width == 256
      assert mlp.spatial_0.in_features == 504
      assert mlp.spatial_5.in_features == 256 + 504
      assert mlp.bottleneck.out_features == 256
      assert not mlp.cfg.disable_density_normals
      assert mlp.viewdir_0.in_features == 256 + 27
  assert DEFAULTS_NORMALS[-1] == "Config.orientation_loss_target = 'normals'"


# --------------------------------------------------- the model, cut to size


def _rays_np(n, config, seed):
  rng = np.random.default_rng(seed)
  d = rng.normal(size=(n, 3)).astype(np.float32)
  f = lambda v, k=1: np.full((n, k), v, np.float32)
  return dict(origins=rng.normal(size=(n, 3)).astype(np.float32) * 0.1,
              directions=d,
              viewdirs=d / np.linalg.norm(d, axis=-1, keepdims=True),
              radii=f(0.001), lossmult=f(1.0), near=f(config.near),
              far=f(config.far), imageplane=f(0.0, 2),
              cam_idx=np.zeros((n, 1), np.int32))


class _Pair:
  """The defaults + `bindings` in both packages (JAX's parameters with
  random biases carried into the port), on one batch."""

  def __init__(self, bindings, n=8, seed=0):
    jconfig, jgin = jconfigs.parse([], bindings)
    self.jconfig = jconfig
    self.jmodel = jconstruct.construct_model(jconfig, jgin)
    self.params = _params(self.jmodel, seed)
    self.config, gin = configs.parse([], bindings)
    self.model = construct.construct_model(self.config, gin, 'cpu')
    convert.load_jax_params(self.model, self.params)
    r = _rays_np(n, self.config, seed)
    rgb = np.random.default_rng(seed + 1).uniform(size=(n, 3)).astype(
        np.float32)
    self.jbatch = jrays.Batch(
        rays=jrays.Rays(**{k: jnp.asarray(v) for k, v in r.items()}),
        rgb=jnp.asarray(rgb))
    self.batch = rays_lib.Batch(
        rays=rays_lib.Rays(**{k: _t(v) for k, v in r.items()}), rgb=_t(rgb))


@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
def test_served_matches_jax(cdt):
  # Eval (no draws) at train_frac 0.3: every level's rgb, acc and distance
  # against JAX under fused_trunk='on'.
  pair = _Pair(DEFAULTS + SMALL + ON + _cdt(cdt))
  jr, jh = pair.jmodel.apply({'params': pair.params}, pair.jbatch.rays,
                             train_frac=0.3, compute_extras=False)
  with torch.no_grad():
    pr, ph = pair.model(pair.batch.rays, train_frac=0.3)
  assert len(pr) == 3 and pair.model.nerf_mlp.spatial_0.in_features == 504
  tol = TOL[cdt]
  for level in range(3):
    for k in ('rgb', 'acc', 'distance'):
      np.testing.assert_allclose(np.asarray(pr[level][k]), _np(jr[level][k]),
                                 rtol=tol, atol=tol * 1e-1,
                                 err_msg=f'{level} {k}')
    np.testing.assert_allclose(ph[level]['sdist'].numpy(),
                               _np(jh[level]['sdist']), rtol=0,
                               atol=1e-6 if cdt == 'float32' else tol * 1e-1)


@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
@pytest.mark.parametrize('which', ['defaults', 'normals'])
def test_two_train_steps_match_jax_with_jax_draws(which, cdt):
  # Config.randomized: every jitter is JAX's own (its key splits replayed
  # into the port's step). After each of two steps every loss term within
  # TOL, the gradients within GRAD_TOL of their largest entry and, in
  # float32, the parameters within 2e-2 of their largest move. Under
  # DEFAULTS_NORMALS the orientation loss is a term of both.
  from refnerf_tpu.train import step as jstep
  pair = _Pair(CONFIGS[which] + SMALL + ON + _cdt(cdt), seed=3)
  jtrain = _jax_step_with_grads(pair.jmodel, pair.jconfig)
  jstate = jstep.create_train_state(pair.jconfig, pair.jmodel, pair.params)
  state = step_lib.create_train_state(pair.config, pair.model)
  train = step_lib.make_train_step(pair.model, pair.config,
                                   draws=jax_draws(pair.config.seed))
  before = {k: v.detach().clone().numpy() for k, v in state.params().items()}
  terms = {'data', 'interlevel'} | ({'orientation'} if which == 'normals'
                                    else set())
  normals = which == 'normals' and cdt == 'float32'
  grad_tol = NORMALS_GRAD_TOL if normals else GRAD_TOL[cdt]
  for i in (1, 2):
    _, _, grads = train.loss_and_grads(state, pair.batch)
    jstate, jstats = jtrain(jstate, pair.jbatch)
    state, stats = train(state, pair.batch)
    assert state.step == int(jstate.step) == i
    assert set(stats['losses']) == set(jstats['losses'])
    assert terms <= set(stats['losses']), stats['losses']
    for k in jstats['losses']:
      tol = NORMALS_TOL if normals and k == 'orientation' else TOL[cdt]
      np.testing.assert_allclose(float(stats['losses'][k]),
                                 float(jstats['losses'][k]), rtol=tol,
                                 atol=1e-9, err_msg=k)
    want = _flat_tree(jax.device_get(jstats['grads']))
    assert set(grads) == set(want)
    for k, g in grads.items():
      _assert_grads(g, want[k], grad_tol, k)
    if cdt == 'bfloat16':
      continue
    jparams = _flat_tree(jax.device_get(jstate.params))
    for k, p in state.params().items():
      moved = max(1e-12, float(np.abs(jparams[k] - before[k]).max()))
      np.testing.assert_allclose(p.detach().numpy(), jparams[k], rtol=0,
                                 atol=(2e-1 if normals else 2e-2) * moved,
                                 err_msg=k)


# ------------------------------------------- the chunked contract, a model


def _trunk_case(seed, n=40, width=256, depth=8):
  """The defaults' spatial trunk (depth 8, the skip at layer 5) on the IPE
  of random lifted means and variances: numpy weights [in, out] (JAX's
  layout), biases, wd [width, 1]; lm, lv [n, 21]; ubar [n, 21]."""
  rng = np.random.default_rng(seed)
  fin = 2 * NB * len(SCALES)
  skips = fused_mlp.skip_input_layers(depth, 4)
  ks = [(rng.normal(size=(fin if l == 0 else width + (fin if l in skips else
                                                      0), width)) *
         np.sqrt(2.0 / (fin if l == 0 else width))).astype(np.float32)
        for l in range(depth)]
  bs = [(rng.normal(size=width) * 0.05).astype(np.float32)
        for _ in range(depth)]
  wd = (rng.normal(size=(width, 1)) / np.sqrt(width)).astype(np.float32)
  lm = rng.uniform(-1.5, 1.5, (n, NB)).astype(np.float32)
  lv = (10.0**rng.uniform(-6, -2, (n, NB))).astype(np.float32)
  ubar = rng.normal(size=(n, NB)).astype(np.float32)
  sbar = rng.normal(size=n).astype(np.float32)
  return ks, bs, wd, lm, lv, ubar, sbar


def _port_case(case, cdt):
  ks, bs, wd, lm, lv, ubar, sbar = case
  segs = list(fused_mlp.encode_ipe(_t(lm), _t(lv), SCALES, cdt))
  fold = torch.as_tensor(fused_mlp.ipe_scale_fold(SCALES, NB))
  return (segs, [_t(k.T) for k in ks], [_t(b) for b in bs], _t(wd.T), fold,
          _t(ubar), _t(sbar))


def _rel(a, b):
  return float((a.float() - b.float()).abs().max()) / max(
      1e-30, float(b.float().abs().max()))


@pytest.mark.parametrize('chunk', [128, 256])
@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
def test_chunked_u_matches_the_inner_chain(cdt, chunk):
  # u chunk by chunk (128 input columns as the f32 forward takes them, 256
  # as the bf16 forward's u_x products; the last chunk of 504 columns
  # partial), each chunk folded at once with its partner segment's values,
  # against the whole-tile chain and fold (`_inner_chain`,
  # `fold_density_grad`): 1e-6 of the largest entry.
  segs, ws, bs, wd, fold, _, _ = _port_case(_trunk_case(0), cdt)
  t = fused_mlp._trunk(ws, bs, (252, 252), 4, fused_mlp.DTYPES[cdt])
  acts = fused_mlp._forward_acts(t, segs)
  us = fused_mlp._inner_chain(t, acts, wd, 2)[0]
  want = fused_mlp.fold_density_grad(us, segs[0], segs[1], fold)
  got, _ = mlp_defaults.chunked_density_grad(segs, ws, bs, wd, fold,
                                             compute_dtype=cdt, chunk=chunk)
  assert got.shape == (40, NB)
  assert _rel(got, want) < 1e-6


@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
def test_chunked_second_order_matches_the_plain_backward(cdt):
  # The second-order share of the gradients, the tangent made 128 input
  # columns at a time (and made again at the skip layer), added to the
  # first-order backward: the plain backward with u's cotangent (Pallas
  # order, the whole tile), 1e-6 (float32) and 5e-3 (bfloat16) of each
  # gradient's largest entry.
  segs, ws, bs, wd, fold, ubar, sbar = _port_case(_trunk_case(1), cdt)
  kw = dict(wd=wd, compute_dtype=cdt, fold=fold)
  first = fused_mlp.trunk_backward_reference(
      segs, ws, bs, (sbar, None, None, None), **kw)
  full = fused_mlp.trunk_backward_reference(
      segs, ws, bs, (sbar, None, None, ubar), **kw)
  _, (dws, dwd) = mlp_defaults.chunked_density_grad(
      segs, ws, bs, wd, fold, ubar, compute_dtype=cdt)
  tol = 1e-6 if cdt == 'float32' else 5e-3
  for l in range(8):
    assert _rel(first[0][l] + dws[l], full[0][l]) < tol, l
  assert _rel(first[2] + dwd, full[2]) < tol


def test_chunked_contract_matches_jax_reference():
  # The chunked model against JAX reference_encoded_trunk with
  # density_grad=True on 504 columns at 40 rows, float32, a trunk 8 x 64
  # (the skip at layer 5): u within 1e-5 of its largest entry; the
  # gradients of <sbar, sigma> + <ubar, u> through jax.vjp (the second
  # order included) against the first-order plain backward plus the model's
  # second-order share, within 2e-4 of each gradient's largest entry.
  case = _trunk_case(2, width=64)
  ks, bs, wd, lm, lv, ubar, sbar = case
  segs, ws, tbs, twd, fold, tubar, tsbar = _port_case(case, 'float32')

  def ref(ks_, bs_, wd_):
    sig, u = jfused.reference_encoded_trunk(
        jnp.asarray(lm), jnp.asarray(lv), SCALES, ks_, bs_, wd_,
        skip_period=4, density_grad=True)
    return sig, u

  (jsig, ju), vjp = jax.vjp(ref, [jnp.asarray(k) for k in ks],
                            [jnp.asarray(b) for b in bs], jnp.asarray(wd))
  jks, jbs, jwd = vjp((jnp.asarray(sbar), jnp.asarray(ubar)))
  u, (dws, dwd) = mlp_defaults.chunked_density_grad(segs, ws, tbs, twd, fold,
                                                    tubar)
  np.testing.assert_allclose(u.numpy(), _np(ju), rtol=0,
                             atol=1e-5 * float(np.abs(_np(ju)).max()))
  first = fused_mlp.trunk_backward_reference(
      segs, ws, tbs, (tsbar, None, None, None), wd=twd, fold=fold)
  for l in range(8):
    _assert_grads(first[0][l] + dws[l], _np(jks[l]).T, 2e-4, f'w{l}')
    _assert_grads(first[1][l], _np(jbs[l]), 2e-4, f'b{l}')
  _assert_grads(first[2] + dwd, _np(jwd).T, 2e-4, 'wd')


@pytest.mark.parametrize('fault', mlp_defaults.FAULTS)
@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
def test_chunked_faults_read_above_the_bounds(cdt, fault):
  # Each planted fault of the chunked contract (the skip layer's columns
  # left out of u's fold, the tangent's skip term dropped, the sin / cos
  # pairing swapped) reads above chip_smoke.py's GRAD_BOUND (relative L2)
  # on u or on a gradient, as phase 25 requires of the kernels' bounds.
  segs, ws, bs, wd, fold, ubar, sbar = _port_case(_trunk_case(3), cdt)
  kw = dict(compute_dtype=cdt)
  u, (dws, dwd) = mlp_defaults.chunked_density_grad(segs, ws, bs, wd, fold,
                                                    ubar, **kw)
  bu, (bws, bwd) = mlp_defaults.chunked_density_grad(
      segs, ws, bs, wd, fold, ubar, faults=[fault], **kw)
  first = fused_mlp.trunk_backward_reference(
      segs, ws, bs, (sbar, None, None, None), wd=wd, fold=fold, **kw)
  l2 = lambda a, b: float((a - b).norm() / b.norm())
  reads = [l2(bu, u)] + [l2(first[0][l] + b, first[0][l] + a)
                         for l, (a, b) in enumerate(zip(dws, bws))]
  reads.append(l2(first[2] + bwd, first[2] + dwd))
  assert max(reads) > GRAD_BOUND[cdt], (fault, reads)


@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
def test_skip_tangent_read_back_equals_the_rebuilt_one(cdt):
  # The bf16 backward stores layer 0's tangent chunks to the ts scratch and
  # reads them back at the skip layer: the chunked model with the tangent
  # read back (`skip_tangent='scratch'`) gives u and every second-order
  # gradient bit for bit as with the tangent made again there ('rebuilt',
  # the design it replaced), and the skip term's fault still reads above
  # GRAD_BOUND.
  segs, ws, bs, wd, fold, ubar, sbar = _port_case(_trunk_case(5), cdt)
  run = lambda **k: mlp_defaults.chunked_density_grad(
      segs, ws, bs, wd, fold, ubar, compute_dtype=cdt, **k)
  u, (dws, dwd) = run()
  u2, (dws2, dwd2) = run(skip_tangent='rebuilt')
  assert torch.equal(u, u2) and torch.equal(dwd, dwd2)
  assert all(torch.equal(a, b) for a, b in zip(dws, dws2))
  _, (bws, bwd) = run(faults=['no skip tangent'])
  first = fused_mlp.trunk_backward_reference(
      segs, ws, bs, (sbar, None, None, None), wd=wd, fold=fold,
      compute_dtype=cdt)
  l2 = lambda a, b: float((a - b).norm() / b.norm())
  reads = [l2(first[0][l] + b, first[0][l] + a)
           for l, (a, b) in enumerate(zip(dws, bws))]
  assert max(reads + [l2(first[2] + bwd, first[2] + dwd)]) > GRAD_BOUND[cdt]


# ------------------------------- the f32 K3 on the tensor cores, a model


def _tf32_case(seed, n=64):
  """The defaults' spatial trunk at full width (csrc/trunk_wide_tf32.cu's
  panels are 256 x 256) with the 256-wide head, on n rows: (JAX's case of
  `_trunk_case`, its head (wc [in, out], bc), the port's segments, pack and
  fold)."""
  case = _trunk_case(seed, n=n)
  rng = np.random.default_rng(seed + 100)
  wc = (rng.normal(size=(256, 256)) / 16).astype(np.float32)
  bc = (rng.normal(size=256) * 0.1).astype(np.float32)
  segs, ws, bs, wd, fold, _, _ = _port_case(case, 'float32')
  pack = fused_mlp.pack_trunk(ws, bs, (252, 252), wd=wd,
                              head_cdt=(_t(wc.T), _t(bc)))
  return case, (wc, bc), segs, pack, fold


def _k3_tf32_model(pack, segs, fold, product):
  """sigma, the bottleneck and u as csrc/trunk_wide_tf32.cu computes them
  for `pack` (`fused_mlp.wide_tf32`): each product A B^T over its weight
  panels (`fused_mlp.tf32_panels`, 256 x 256 in the tile's order), A's
  columns permuted within every 8 as the panels' K is and a product's
  panels one K (the kernel adds every 32-deep slice into one accumulator
  set); `product(a, b)` computes a @ b. h_l = relu(acc + b_l), sigma = y
  wd, the bottleneck acc + bc; the chain s_{L-1} = relu'(h) wd, s_{l-1} =
  relu'(h_{l-1}) (s_l W_l^T); at the skip layer and layer 0 u_x one product
  a segment, scaled by the partner segment (xc for a sin column, -xs for a
  cos one) and folded at once by one more product, each warpgroup's 128
  columns against its rows of the fold panel (`fused_mlp.tf32_fold_panel`,
  K permuted alike)."""
  width, d = 256, int(segs[0].shape[1])
  panels = iter(fused_mlp.tf32_panels(pack).reshape(-1, width, width))
  s = np.arange(width)
  perm = torch.from_numpy((s // 8) * 8 + 2 * (s % 4) + (s % 8) // 4)
  x0, x1 = (torch.nn.functional.pad(x.float(), (0, width - d)) for x in segs)

  def run(a_list):
    a = torch.cat([t[:, perm] for t in a_list], 1).contiguous()
    b = torch.cat([next(panels).t() for _ in a_list], 0).contiguous()
    return product(a, b)

  fp = fused_mlp.tf32_fold_panel(fold).reshape(2, 32, 128)
  perm128 = perm[:128]

  def fold_product(um):  # each warpgroup's 128 columns against its rows
    um = torch.nn.functional.pad(um, (0, width - d))
    return sum(product(um[:, 128 * cw:128 * cw + 128][:, perm128].contiguous(),
                       fp[cw].t().contiguous()) for cw in (0, 1))

  masks, act = [], None
  for l in range(pack.depth):
    act = torch.relu(run([x0, x1] if l == 0 else [act, x0, x1]
                         if l == pack.skip else [act]) + pack.b[l])
    masks.append(act > 0)
  sig, cout = act @ pack.wd, run([act]) + pack.bc
  s_, u = masks[-1] * pack.wd, 0
  for l in range(pack.depth - 1, -1, -1):
    if l == 0 or l == pack.skip:
      for xp, sgn in ((segs[1], 1.0), (segs[0], -1.0)):
        u = u + fold_product(sgn * xp.float() * run([s_])[:, :d])
    if l > 0:
      s_ = masks[l - 1] * run([s_])
  return sig, cout, u[:, :fold.shape[1]]


def test_tf32_panels_hold_every_product_of_the_trunk():
  # csrc/trunk_wide_tf32.cu's weight panels (`fused_mlp.tf32_panel_index`:
  # 23 of 256 x 256 at depth 8 with the skip at layer 5 on 2 x 252 columns,
  # each segment padded to 256, K permuted within every 8), run in the
  # kernel's order in exact f32: sigma, the bottleneck and u within 1e-6 of
  # the largest entry of trunk_reference's (the same products summed in
  # another order). The f32 defaults' K3 routes there, 228,896 B of shared
  # memory a CTA.
  _, _, segs, pack, fold = _tf32_case(6)
  assert fused_mlp.wide_tf32(pack, fold=fold)
  assert fused_mlp.forward_library(pack, fold=fold) == (
      fused_mlp.WIDE_TF32_LIBRARY)
  assert fused_mlp.kernel_smem(fused_mlp.WIDE_TF32_LIBRARY, pack, 256,
                               fold) == 228896
  idx = fused_mlp.tf32_panel_index(8, 5, 512, 252)
  assert idx.shape == (23 * 256, 256) and idx.max() < pack.w.numel() + 65536
  got = _k3_tf32_model(pack, segs, fold, lambda a, b: a @ b)
  ws, bs, kw = fused_mlp.unpack_trunk(pack)
  want = fused_mlp.trunk_reference(segs, ws, bs, density_grad=True,
                                   fold=fold, **kw)
  for g, w in zip(got, want):
    assert _rel(g, w) < 1e-6


def test_wide_tf32_launch_arguments_match_exports(monkeypatch):
  # The f32 defaults' K3 through trunk_kernel on CPU tensors with the
  # libraries replaced by _ArgCheck (test_torch_port_cascade.py): the
  # weight panels' and the fold panel's splits, then one forward,
  # refnerf_wide_tf32_split twice and refnerf_wide_tf32_k3 with the argument
  # lists cuda_build.EXPORTS declares: 23 panels of 65,536 entries, a fold
  # panel of 64 x 128, 252 columns a segment, depth 8, the skip at layer 5,
  # 21 basis vectors.
  from refnerf_tpu_torch.ops import cuda_build
  import contextlib
  calls = []
  fake = _ArgCheck(calls)
  monkeypatch.setattr(cuda_build, 'library', lambda name: fake)
  monkeypatch.setattr(torch.cuda, 'device',
                      lambda dev: contextlib.nullcontext())
  monkeypatch.setattr(torch.cuda, 'current_stream',
                      lambda dev=None: type('S', (), {'cuda_stream': 0})())
  _, _, segs, pack, fold = _tf32_case(8, n=100)
  sig, cout, u = fused_mlp.trunk_kernel(segs, pack, fold)
  assert (sig.shape, cout.shape, u.shape) == ((100,), (100, 256), (100, NB))
  assert [fn for fn, _ in calls] == ['refnerf_wide_tf32_split'] * 2 + [
      'refnerf_wide_tf32_k3']
  split, fsplit, k3 = (args for _, args in calls)
  assert split[0] == 23 * 65536 and split[3] == pack.w.numel()
  assert fsplit[0] == 64 * 128 and fsplit[3] == 252 * NB
  assert k3[:5] == (100, 252, 8, 5, NB) and k3[9] == 23


@pytest.mark.parametrize('passes', [3, 1])
def test_k3_tf32_passes_against_the_f32_bound(passes):
  # The same model with csrc/trunk_wide_tf32.cu's arithmetic: each product
  # three TF32 passes (hi = tf32(v), lo = tf32(v - hi); lo.hi + hi.lo +
  # hi.hi) whose truncating accumulation sums each 32-deep slice into a
  # fresh set added into the tile in f32 (H26;
  # tests/test_torch_port_mipnerf360.py `_truncated_product`), against JAX
  # reference_encoded_trunk with density_grad=True and the 256-wide head at
  # 64 rows: sigma, the bottleneck and u within chip_smoke.py's
  # KERNEL_BOUND['float32'] of max(1, their largest entry). One pass (hi.hi
  # alone, `_tf32_product`) reads above it, so the bound sees that
  # shortcut.
  case, (wc, bc), segs, pack, fold = _tf32_case(7)
  ks, bs, wd, lm, lv, _, _ = case
  if passes == 3:
    product = lambda a, b: torch.from_numpy(
        _truncated_product(a, b, 32)).float()
  else:
    product = lambda a, b: _tf32_product(a, b, passes=1)
  got = _k3_tf32_model(pack, segs, fold, product)
  want = jfused.reference_encoded_trunk(
      jnp.asarray(lm), jnp.asarray(lv), SCALES, [jnp.asarray(k) for k in ks],
      [jnp.asarray(b) for b in bs], jnp.asarray(wd), skip_period=4,
      density_grad=True, head_cdt=(jnp.asarray(wc), jnp.asarray(bc)))
  reads = [float((g - _t(_np(w)).reshape(g.shape)).abs().max()) /
           max(1.0, float(np.abs(_np(w)).max())) / KERNEL_BOUND['float32']
           for g, w in zip(got, want)]
  if passes == 3:
    assert max(reads) < 1, reads
  else:
    assert max(reads) > 1, reads


# ----------------------- the f32 K1 on the tensor cores, a model


def _k1_tf32_model(pack, segs, product):
  """sigma and the bottleneck as csrc/trunk_wide_tf32.cu's K1 instance
  computes them (`_k3_tf32_model` without the chain and the folds), over
  K1's panels (`fused_mlp.tf32_panels(pack, dg=False)`: the layers' and the
  bottleneck's, 12 at depth 8)."""
  width, d = 256, int(segs[0].shape[1])
  panels = iter(fused_mlp.tf32_panels(pack, dg=False).reshape(-1, width,
                                                               width))
  s = np.arange(width)
  perm = torch.from_numpy((s // 8) * 8 + 2 * (s % 4) + (s % 8) // 4)
  x0, x1 = (torch.nn.functional.pad(x.float(), (0, width - d)) for x in segs)

  def run(a_list):
    a = torch.cat([t[:, perm] for t in a_list], 1).contiguous()
    b = torch.cat([next(panels).t() for _ in a_list], 0).contiguous()
    return product(a, b)

  act = None
  for l in range(pack.depth):
    act = torch.relu(run([x0, x1] if l == 0 else [act, x0, x1]
                         if l == pack.skip else [act]) + pack.b[l])
  out = act @ pack.wd, run([act]) + pack.bc
  assert next(panels, None) is None  # every panel read, none left
  return out


def test_tf32_k1_panels_hold_every_product_of_the_trunk():
  # K1 on csrc/trunk_wide_tf32.cu (the f32 defaults served): its panels
  # (`fused_mlp.tf32_panel_index(..., dg=False)`: 12 of 256 x 256 at depth
  # 8 with the skip at layer 5, the first 12 of K3's 23) run in the
  # kernel's order in exact f32 give sigma and the bottleneck within 1e-6
  # of the largest entry of trunk_reference's. The f32 defaults' K1 routes
  # there, 214,560 B of shared memory a CTA (no relu' bits).
  _, _, segs, pack, _ = _tf32_case(9)
  assert fused_mlp.wide_tf32(pack)
  assert fused_mlp.forward_library(pack) == fused_mlp.WIDE_TF32_LIBRARY
  assert fused_mlp.kernel_smem(fused_mlp.WIDE_TF32_LIBRARY, pack, 256) == (
      214560)
  idx = fused_mlp.tf32_panel_index(8, 5, 512, 252, dg=False)
  assert idx.shape == (12 * 256, 256)
  np.testing.assert_array_equal(idx, fused_mlp.tf32_panel_index(
      8, 5, 512, 252)[:12 * 256])
  got = _k1_tf32_model(pack, segs, lambda a, b: a @ b)
  ws, bs, kw = fused_mlp.unpack_trunk(pack)
  want = fused_mlp.trunk_reference(segs, ws, bs, **kw)
  for g, w in zip(got, want):
    assert _rel(g, w) < 1e-6


@pytest.mark.parametrize('passes', [3, 1])
def test_k1_tf32_passes_against_the_f32_bound(passes):
  # The K1 model with the kernel's arithmetic (three TF32 passes, 32-deep
  # f32 slice sums: `_truncated_product`) against JAX
  # reference_encoded_trunk with the 256-wide head at 64 rows: sigma and
  # the bottleneck within chip_smoke.py's KERNEL_BOUND['float32'] of
  # max(1, their largest entry); one pass (hi.hi alone) reads above it.
  case, (wc, bc), segs, pack, _ = _tf32_case(10)
  ks, bs, wd, lm, lv, _, _ = case
  if passes == 3:
    product = lambda a, b: torch.from_numpy(
        _truncated_product(a, b, 32)).float()
  else:
    product = lambda a, b: _tf32_product(a, b, passes=1)
  got = _k1_tf32_model(pack, segs, product)
  want = jfused.reference_encoded_trunk(
      jnp.asarray(lm), jnp.asarray(lv), SCALES, [jnp.asarray(k) for k in ks],
      [jnp.asarray(b) for b in bs], jnp.asarray(wd), skip_period=4,
      head_cdt=(jnp.asarray(wc), jnp.asarray(bc)))
  reads = [float((g - _t(_np(w)).reshape(g.shape)).abs().max()) /
           max(1.0, float(np.abs(_np(w)).max())) / KERNEL_BOUND['float32']
           for g, w in zip(got, want)]
  if passes == 3:
    assert max(reads) < 1, reads
  else:
    assert max(reads) > 1, reads


def test_wide_tf32_k1_launch_arguments_match_exports(monkeypatch):
  # The f32 defaults' K1 through trunk_kernel on CPU tensors with the
  # libraries replaced by _ArgCheck: the panels' split (12 of 65,536
  # entries), then refnerf_wide_tf32_k1 (100 rows, 252 columns a segment,
  # depth 8, the skip at layer 5, 12 panels) with the argument lists
  # cuda_build.EXPORTS declares; sigma and the bottleneck out, no u.
  from refnerf_tpu_torch.ops import cuda_build
  import contextlib
  calls = []
  fake = _ArgCheck(calls)
  monkeypatch.setattr(cuda_build, 'library', lambda name: fake)
  monkeypatch.setattr(torch.cuda, 'device',
                      lambda dev: contextlib.nullcontext())
  monkeypatch.setattr(torch.cuda, 'current_stream',
                      lambda dev=None: type('S', (), {'cuda_stream': 0})())
  _, _, segs, pack, _ = _tf32_case(11, n=100)
  sig, cout = fused_mlp.trunk_kernel(segs, pack)
  assert (sig.shape, cout.shape) == ((100,), (100, 256))
  assert [fn for fn, _ in calls] == ['refnerf_wide_tf32_split',
                                     'refnerf_wide_tf32_k1']
  split, k1 = (args for _, args in calls)
  assert split[0] == 12 * 65536 and split[3] == pack.w.numel()
  assert k1[:4] == (100, 252, 8, 5) and k1[8] == 12


# ------------------------------- the bf16 K3 on the tensor cores, a model


def _bf16_case(seed, n=64):
  """`_tf32_case`'s trunk in bf16: (JAX's case, its head, the port's bf16
  segments, bf16 pack and fold)."""
  case = _trunk_case(seed, n=n)
  rng = np.random.default_rng(seed + 100)
  wc = (rng.normal(size=(256, 256)) / 16).astype(np.float32)
  bc = (rng.normal(size=256) * 0.1).astype(np.float32)
  segs, ws, bs, wd, fold, _, _ = _port_case(case, 'bfloat16')
  pack = fused_mlp.pack_trunk(ws, bs, (252, 252), wd=wd,
                              head_cdt=(_t(wc.T), _t(bc)),
                              compute_dtype='bfloat16')
  return case, (wc, bc), segs, pack, fold


# The fold's A fragment (TF32 m64n32k8, step j of a chunk): register e of a
# thread (lane % 4 = q) is the accumulator 4 j + 2 (e % 2) + e // 2, column
# 8 j + 2 q + e // 2, in K slot q + 4 (e // 2).
_FOLD_SLOT = {(q, e): (q + 4 * (e // 2), 2 * q + e // 2)
              for q in range(4) for e in range(4)}


def _k3_bf16_model(pack, segs, fold, fold_product, faults=()):
  """sigma, the bottleneck and u as csrc/trunk_wide_bf16.cu computes them
  for `pack` (`fused_mlp.wide_bf16`), in its order: each product one bf16
  pass over the pack's own weights, its exact products summed in f32 (the
  input [x0 | x1] as 512 packed columns, the skip layer's [h | x]);
  h_l = relu(cdt(cdt(acc) + b_l)), relu' = h_l > 0, sigma = f32(y) wd, the
  bottleneck cdt(cdt(acc) + bc); the chain s_{L-1} = relu'(h) cdt(wd),
  s_{l-1} = relu'(h_{l-1}) cdt(s_l W_l^T); u_x 128 input columns at a time
  (chunks 0-3 at the skip layer and at layer 0), each scaled by its
  partner values ([xc | -xs], the segments' columns swapped) and
  folded at once by `fold_product(a, b)` (a @ b) against its rows of the
  fold panel (`fused_mlp.bf16_fold_panel`), A's columns permuted within
  every 8 as the panel's K is. `faults`: mlp_defaults.FAULTS' 'no skip
  fold' (the skip layer's chunks left out of u) and 'pairing swapped' (xs
  read as a sin column's partner, -xc as a cos one's)."""
  bf, width, d = torch.bfloat16, 256, int(segs[0].shape[1])
  r = lambda t: t.to(bf).float()
  ws, wts, off = [], [], 0
  for k in pack.k_dims():
    ws.append(pack.w[off:off + width * k].reshape(width, k).float())
    wts.append(pack.wt[off:off + width * k].reshape(k, width).float())
    off += width * k
  n = int(segs[0].shape[0])
  x = torch.zeros(n, pack.kin)
  x[:, :d], x[:, d:2 * d] = segs[0].float(), segs[1].float()
  part = torch.zeros(n, 512)
  a, b = (segs[0], segs[1]) if 'pairing swapped' in faults else (segs[1],
                                                                  segs[0])
  part[:, :d], part[:, d:2 * d] = a.float(), -b.float()
  s = np.arange(128)
  perm = torch.from_numpy((s // 8) * 8 + 2 * (s % 4) + (s % 8) // 4)
  fp = fused_mlp.bf16_fold_panel(fold).reshape(4, 32, 128)
  masks, h = [], None
  for l in range(pack.depth):
    a_l = x if l == 0 else torch.cat([h, x], 1) if l == pack.skip else h
    h = torch.relu(r(r(a_l @ ws[l].t()) + pack.b[l].float()))
    masks.append(h > 0)
  sig = h @ pack.wd
  cout = r(r(h @ pack.wc.float().t()) + pack.bc.float())
  s_ = torch.where(masks[-1], r(pack.wd), torch.zeros(()))
  u = torch.zeros(n, 32)
  for l in range(pack.depth - 1, -1, -1):
    if l == 0 or l == pack.skip:
      for ch in range(4):
        c0 = (0 if l == 0 else width) + 128 * ch
        um = part[:, 128 * ch:128 * ch + 128] * (s_ @ wts[l][c0:c0 + 128].t())
        if not (l > 0 and 'no skip fold' in faults):
          u = u + fold_product(um[:, perm].contiguous(), fp[ch].t().contiguous())
    if l > 0:
      s_ = torch.where(masks[l - 1], r(s_ @ wts[l][:width].t()),
                       torch.zeros(()))
  return sig, cout, u[:, :fold.shape[1]]


def test_bf16_k3_layouts_hold_every_product():
  # csrc/trunk_wide_bf16.cu's two layouts on the CPU. A bf16 product's
  # m64nNk16 accumulators (d[4 j + 2 h + e]: row lane / 4 + 8 h, column 8 j
  # + 2 (lane % 4) + e) packed in pairs are the next product's A fragments
  # of k16 step kk (a[i]: row lane / 4 + 8 (i % 2), columns 16 kk + 2 (lane
  # % 4) + 8 (i / 2) and the next) with no K permutation; the fold's TF32
  # A fragments of the accumulators (`_FOLD_SLOT`) hold column 8 j + 2 q +
  # e // 2 in slot q + 4 (e // 2), which is where the fold panel
  # (`fused_mlp.bf16_fold_index`: [4 x 32][128], S's row of the input
  # column, a cos column's the column less d) puts it. The model run with
  # exact products (a @ b) against trunk_reference in bfloat16 (the same
  # roundings, each product summed in another order): sigma and the
  # bottleneck within 1e-2 of their largest entry (a bf16 rounding flip of
  # an activation moves them by a fraction of 2^-8), u within 1e-5.
  for lane in range(32):
    q = lane % 4
    for kk in range(8):
      for i in range(4):
        j, h = 2 * kk + i // 2, i % 2  # the packed pair P[2 j + h]
        for e in range(2):
          acc = (lane // 4 + 8 * h, 8 * j + 2 * q + e)
          frag = (lane // 4 + 8 * (i % 2), 16 * kk + 2 * q + 8 * (i // 2) + e)
          assert acc == frag
  perm = [(s // 8) * 8 + 2 * (s % 4) + (s % 8) // 4 for s in range(128)]
  for (q, e), (slot, col) in _FOLD_SLOT.items():
    assert perm[slot] == col
  d, nb = 252, NB
  idx = fused_mlp.bf16_fold_index(d, nb)
  assert idx.shape == (128, 128)
  for ch in range(4):
    for k in range(128):
      c = 128 * ch + perm[k]
      want = -1 if c >= 2 * d else (c if c < d else c - d)
      for j in (0, nb - 1, nb, 31):
        got = idx[32 * ch + j, k]
        assert got == (-1 if want < 0 or j >= nb else want * nb + j)
  _, _, segs, pack, fold = _bf16_case(12)
  assert fused_mlp.wide_bf16(pack, fold=fold)
  assert fused_mlp.forward_library(pack, fold=fold) == (
      fused_mlp.WIDE_BF16_LIBRARY)
  assert fused_mlp.kernel_smem(fused_mlp.WIDE_BF16_LIBRARY, pack, 256,
                               fold) == 226368
  got = _k3_bf16_model(pack, segs, fold, lambda a, b: a @ b)
  ws, bs, kw = fused_mlp.unpack_trunk(pack)
  want = fused_mlp.trunk_reference(segs, ws, bs, density_grad=True,
                                   fold=fold, **kw)
  for g, w, tol in zip(got, want, (1e-2, 1e-2, 1e-5)):
    assert _rel(g, w) < tol


def _bf16_reads(got, want):
  """chip_smoke.py's reads of a K3 against its bound: sigma and the
  bottleneck by the max error over max(1, the largest entry), against
  KERNEL_BOUND['bfloat16']; u by relative L2, against GRAD_BOUND."""
  want = [_t(_np(w)).reshape(g.shape) for g, w in zip(got, want)]
  vals = [float((g.float() - w).abs().max()) / max(1.0, float(w.abs().max()))
          / KERNEL_BOUND['bfloat16'] for g, w in zip(got[:2], want[:2])]
  u = float((got[2] - want[2]).norm() / want[2].norm()) / GRAD_BOUND[
      'bfloat16']
  return vals + [u]


def _jax_bf16_k3(case, head):
  ks, bs, wd, lm, lv, _, _ = case
  wc, bc = head
  return jfused.reference_encoded_trunk(
      jnp.asarray(lm), jnp.asarray(lv), SCALES, [jnp.asarray(k) for k in ks],
      [jnp.asarray(b) for b in bs], jnp.asarray(wd), skip_period=4,
      density_grad=True, head_cdt=(jnp.asarray(wc), jnp.asarray(bc)),
      compute_dtype='bfloat16')


def test_k3_bf16_model_against_jax():
  # The model with the kernel's arithmetic (bf16 products, the fold three
  # TF32 passes on the u_x accumulators, a chunk's 128-deep sum added into
  # u in f32, `_truncated_product`; the partners' values) against JAX
  # reference_encoded_trunk in bfloat16 with density_grad=True and the
  # 256-wide head at 64 rows: sigma and the bottleneck within chip_smoke.py's
  # KERNEL_BOUND['bfloat16'], u within GRAD_BOUND['bfloat16'].
  case, head, segs, pack, fold = _bf16_case(13)
  got = _k3_bf16_model(pack, segs, fold, lambda a, b: torch.from_numpy(
      _truncated_product(a, b)).float())
  reads = _bf16_reads(got, _jax_bf16_k3(case, head))
  assert max(reads) < 1, reads


@pytest.mark.parametrize('fault', ['no skip fold', 'pairing swapped'])
def test_k3_bf16_faults_read_above_the_bounds(fault):
  # mlp_defaults.FAULTS' two faults of u planted in the bf16 model (the
  # skip layer's chunks left out of u's fold; the partners read with the
  # segments' pairing swapped) read above GRAD_BOUND['bfloat16'] against
  # JAX, as phase 25 requires of the kernel's bounds.
  assert fault in mlp_defaults.FAULTS
  case, head, segs, pack, fold = _bf16_case(14)
  got = _k3_bf16_model(pack, segs, fold, lambda a, b: a @ b, faults=[fault])
  reads = _bf16_reads(got, _jax_bf16_k3(case, head))
  assert reads[2] > 1, (fault, reads)


def test_wide_bf16_k3_launch_arguments_match_exports(monkeypatch):
  # The bf16 defaults' K3 through trunk_kernel on CPU tensors with the
  # libraries replaced by _ArgCheck: the fold panel's split (4 x 32 x 128
  # entries of the 252 x 21 fold), then refnerf_wide_bf16_k3 (100 rows, 252
  # columns a segment, depth 8, the skip at layer 5, 21 basis vectors, 512
  # packed input columns, the pack's w, wt and wc) with the argument lists
  # cuda_build.EXPORTS declares; sigma f32, the bottleneck bf16, u f32.
  from refnerf_tpu_torch.ops import cuda_build
  import contextlib
  calls = []
  fake = _ArgCheck(calls)
  monkeypatch.setattr(cuda_build, 'library', lambda name: fake)
  monkeypatch.setattr(torch.cuda, 'device',
                      lambda dev: contextlib.nullcontext())
  monkeypatch.setattr(torch.cuda, 'current_stream',
                      lambda dev=None: type('S', (), {'cuda_stream': 0})())
  _, _, segs, pack, fold = _bf16_case(15, n=100)
  sig, cout, u = fused_mlp.trunk_kernel(segs, pack, fold)
  assert (sig.shape, cout.shape, u.shape) == ((100,), (100, 256), (100, NB))
  assert (sig.dtype, cout.dtype, u.dtype) == (torch.float32, torch.bfloat16,
                                              torch.float32)
  assert [fn for fn, _ in calls] == ['refnerf_wide_bf16_fold',
                                     'refnerf_wide_bf16_k3']
  fsplit, k3 = (args for _, args in calls)
  assert fsplit[0] == 4 * 32 * 128
  assert k3[:6] == (100, 252, 8, 5, NB, 512)
  assert k3[8:11] == (pack.w.data_ptr(), pack.wt.data_ptr(),
                      pack.wc.data_ptr())


# ----------------------- the f32 K4 on the tensor cores, a model


def _bwd_case(seed, dg, n=64):
  """`_tf32_case`'s trunk with the cotangents of sigma, the head and (dg) u:
  (JAX's case, its head, the port's segments, pack, fold and (sbar, cbar,
  ubar or None))."""
  case, head, segs, pack, fold = _tf32_case(seed, n=n)
  rng = np.random.default_rng(seed + 200)
  sbar = _t(rng.normal(size=n).astype(np.float32))
  cbar = _t((rng.normal(size=(n, 256)) * 0.1).astype(np.float32))
  ubar = _t(case[5]) if dg else None
  return case, head, segs, pack, fold, (sbar, cbar, ubar)


def _k4_tf32_model(pack, segs, fold, cots, product, faults=()):
  """The backward as csrc/trunk_wide_bwd_tf32.cu and its wrapper
  (`fused_mlp._wide_tf32_backward`) compute it for `pack`
  (`fused_mlp.wide_tf32_bwd`): each product of the tile A B^T over its
  weight panels (`fused_mlp.tf32_bwd_panels`, in the tile's order), A's
  columns permuted within every 8 as the panels' K is; `product(a, b)`
  computes a @ b. With u's cotangent first tp = ubar S^T against tp's panel
  (`fused_mlp.tf32_tp_panel`) and ts = (tp xc, -(tp xs)) into a [n, 512]
  scratch beside x's (the segments side by side); the recompute h_l =
  relu(acc + b_l); the inner chain s_l; the head's zeta_{L-1} = relu'(h)
  (cbar wc + sbar wd); the reverse zeta_l; the tangent chain p_l from ts's
  two panels. The weight gradients as trunk_w1024.cu's tn product forms
  them, product(z^T, x) over the rows: dW_l = zeta_l^T [h_{l-1} | x] +
  s_l^T [p_{l-1} | ts] (two launches summed), db_l and dbc the column sums
  of zeta_l and cbar, dwc = cbar^T y, dwd = sum sbar y + sum p_{L-1}.
  Planted `faults`: 'db s-sums' (db_l from the stacked [zeta_l; s_l]), 'ts
  own segment' (each column of ts scaled by its own segment's value).
  Returns (y, dws, dbs, dwd, dwc, dbc)."""
  width, d, L = 256, int(segs[0].shape[1]), pack.depth
  sbar, cbar, ubar = cots
  dg = ubar is not None
  n = int(segs[0].shape[0])
  panels = iter(fused_mlp.tf32_bwd_panels(pack, dg).reshape(-1, width,
                                                             width))
  s = np.arange(width)
  perm = torch.from_numpy((s // 8) * 8 + 2 * (s % 4) + (s % 8) // 4)
  pad = lambda x, k: torch.nn.functional.pad(x.float(), (0, k - x.shape[1]))
  x0, x1 = (pad(x, width) for x in segs)

  def run(a_list):
    a = torch.cat([t[:, perm] for t in a_list], 1).contiguous()
    b = torch.cat([next(panels).t() for _ in a_list], 0).contiguous()
    return product(a, b)

  def side_by_side(a, b):  # the scratch's [n, 512]: a | b | zeros
    return pad(torch.cat([a, b], 1), 2 * width)

  xcat = side_by_side(segs[0].float(), segs[1].float())
  if dg:
    tp = product(pad(ubar, 32)[:, perm[:32]].contiguous(),
                 fused_mlp.tf32_tp_panel(fold).t().contiguous())[:, :d]
    xs, xc = (segs[1], segs[0]) if 'ts own segment' in faults else segs
    ts = side_by_side(tp * xc.float(), -(tp * xs.float()))
  hs, masks, act = [], [], None
  for l in range(L):
    act = torch.relu(run([x0, x1] if l == 0 else [act, x0, x1]
                         if l == pack.skip else [act]) + pack.b[l])
    hs.append(act)
    masks.append(act > 0)
  ss = [None] * L
  if dg:
    ss[-1] = masks[-1] * pack.wd
    for l in range(L - 1, 0, -1):
      ss[l - 1] = masks[l - 1] * run([ss[l]])
  zs = [None] * L
  zs[-1] = masks[-1] * (run([cbar.float()]) + sbar[:, None] * pack.wd)
  for l in range(L - 1, 0, -1):
    zs[l - 1] = masks[l - 1] * run([zs[l]])
  ps = [None] * L
  if dg:
    for l in range(L):
      a = ([ts[:, :width], ts[:, width:]] if l == 0 else
           [ps[l - 1], ts[:, :width], ts[:, width:]] if l == pack.skip
           else [ps[l - 1]])
      ps[l] = masks[l] * run(a)
  wg = lambda z, x: product(z.t().contiguous(), x.contiguous())
  fin, kin = 2 * d, pack.kin
  dws, dbs = [], []
  for l in range(L):
    for z, a, x in ((zs, hs, xcat), (ss, ps, ts if dg else None)):
      if z[l] is None:
        continue
      xl = (x[:, :kin] if l == 0 else torch.cat([a[l - 1], x[:, :kin]], 1)
            if l == pack.skip else a[l - 1])
      dw = wg(z[l], xl) if z is zs else dw + wg(z[l], xl)
    dws.append(dw[:, :(fin if l == 0 else width + (fin if l == pack.skip
                                                   else 0))])
    db = zs[l].sum(0)
    dbs.append(db + ss[l].sum(0) if 'db s-sums' in faults else db)
  dwd = (sbar[:, None] * hs[-1]).sum(0) + (ps[-1].sum(0) if dg else 0)
  return (hs[-1], dws, dbs, dwd[None], wg(cbar.float(), hs[-1]),
          cbar.float().sum(0))


def _k4_reads(got, jax_case, head, cots, bound=GRAD_BOUND['float32']):
  """How far the model's outputs (`_k4_tf32_model`) are from JAX
  reference_encoded_trunk with density_grad=True and the 256-wide head,
  each as a share of its bound: sigma and the bottleneck from the
  recomputed y (exact f32 on top of it) within KERNEL_BOUND['float32'] of
  max(1, their largest entry); the gradients of <sbar, sigma> + <cbar,
  head> + <ubar, u> (ubar 0 without u's cotangent) through jax.vjp within
  `bound` by relative L2 (H8)."""
  ks, bs, wd, lm, lv, _, _ = jax_case
  wc, bc = head
  sbar, cbar, ubar = cots

  def ref(ks_, bs_, wd_, wc_, bc_):
    return jfused.reference_encoded_trunk(
        jnp.asarray(lm), jnp.asarray(lv), SCALES, ks_, bs_, wd_,
        skip_period=4, density_grad=True, head_cdt=(wc_, bc_))

  (jsig, jc, ju), vjp = jax.vjp(
      ref, [jnp.asarray(k) for k in ks], [jnp.asarray(b) for b in bs],
      jnp.asarray(wd), jnp.asarray(wc), jnp.asarray(bc))
  u_cot = np.zeros(ju.shape, np.float32) if ubar is None else ubar.numpy()
  jks, jbs, jwd, jwc, jbc = vjp((jnp.asarray(sbar.numpy()).reshape(jsig.shape),
                                 jnp.asarray(cbar.numpy()),
                                 jnp.asarray(u_cot)))
  y, dws, dbs, dwd, dwc, dbc = got
  wc_t, bc_t = _t(wc), _t(bc)
  values = [(y @ _t(wd)).reshape(-1), y @ wc_t + bc_t]
  reads = [float((v - _t(_np(w)).reshape(v.shape)).abs().max()) /
           max(1.0, float(np.abs(_np(w)).max())) / KERNEL_BOUND['float32']
           for v, w in zip(values, (jsig, jc))]
  l2 = lambda a, b: float((a.float() - b).norm() / b.norm()) / bound
  reads += [l2(dws[l], _t(_np(jks[l]).T)) for l in range(len(dws))]
  reads += [l2(dbs[l], _t(_np(jbs[l]))) for l in range(len(dbs))]
  reads += [l2(dwd, _t(_np(jwd).T)), l2(dwc, _t(_np(jwc).T)),
            l2(dbc, _t(_np(jbc)))]
  return reads


def test_tf32_bwd_panels_hold_every_product_of_the_backward():
  # csrc/trunk_wide_bwd_tf32.cu's weight panels
  # (`fused_mlp.tf32_bwd_panel_index`: 37 of 256 x 256 with u's cotangent,
  # 19 first order, at depth 8 with the skip at layer 5 on 2 x 252 columns:
  # the recompute, the inner chain, the head backward, the reverse and the
  # tangent, K permuted within every 8) and tp's (`tf32_tp_index`, 256 x
  # 32), run in the kernel's order in exact f32 (`_k4_tf32_model`): every
  # gradient within 1e-6 of the largest entry of the port's plain f32
  # backward (trunk_backward_reference), with and without u's cotangent.
  # The f32 defaults' K4 routes there, 228,392 B of shared memory a CTA.
  for dg, count in ((True, 37), (False, 19)):
    _, _, segs, pack, fold, cots = _bwd_case(9, dg)
    f = fold if dg else None
    assert fused_mlp.wide_tf32_bwd(pack, fold=f)
    assert fused_mlp.backward_library(pack, fold=f) == (
        fused_mlp.WIDE_TF32_BWD_LIBRARY)
    assert fused_mlp.kernel_smem(fused_mlp.WIDE_TF32_BWD_LIBRARY, pack, 256,
                                 f) == 228392
    idx = fused_mlp.tf32_bwd_panel_index(8, 5, 512, 252, dg)
    assert idx.shape == (count * 256, 256)
    assert idx.max() < pack.w.numel() + 65536
    tp = fused_mlp.tf32_tp_index(252, NB)
    assert tp.shape == (256, 32) and (tp >= 0).sum() == 252 * NB
    _, dws, dbs, dwd, dwc, dbc = _k4_tf32_model(pack, segs, fold, cots,
                                                lambda a, b: a @ b)
    ws, bs, kw = fused_mlp.unpack_trunk(pack)
    sbar, cbar, ubar = cots
    want = fused_mlp.trunk_backward_reference(
        segs, ws, bs, (sbar, None, cbar, ubar), fold=fold, **kw)
    for g, w in zip(dws + dbs + [dwd, dwc, dbc],
                    want[0] + want[1] + [want[2], want[5], want[6]]):
      assert _rel(g, w) < 1e-6


@pytest.mark.parametrize('dg', [True, False])
@pytest.mark.parametrize('passes', [3, 1])
def test_k4_tf32_passes_against_the_f32_bounds(passes, dg):
  # The model with the kernel's arithmetic: every product of the tile and
  # of the weight gradients three TF32 passes, each 32-deep slice (of K, or
  # of the rows) summed into a fresh set added in f32 (H26,
  # `_truncated_product`), with and without u's cotangent, against JAX
  # reference_encoded_trunk with density_grad=True and the 256-wide head at
  # 64 rows (`_k4_reads`): the recomputed y's sigma and bottleneck within
  # KERNEL_BOUND, every gradient within GRAD_BOUND by relative L2, and
  # within it of the port's plain f32 backward too. One pass (hi.hi alone)
  # reads above a bound.
  case, head, segs, pack, fold, cots = _bwd_case(10, dg)
  if passes == 3:
    product = lambda a, b: torch.from_numpy(
        _truncated_product(a, b, 32)).float()
  else:
    product = lambda a, b: _tf32_product(a, b, passes=1)
  got = _k4_tf32_model(pack, segs, fold, cots, product)
  reads = _k4_reads(got, case, head, cots)
  if passes == 3:
    assert max(reads) < 1, reads
    ws, bs, kw = fused_mlp.unpack_trunk(pack)
    sbar, cbar, ubar = cots
    want = fused_mlp.trunk_backward_reference(
        segs, ws, bs, (sbar, None, cbar, ubar), fold=fold, **kw)
    _, dws, dbs, dwd, dwc, dbc = got
    for g, w in zip(dws + dbs + [dwd, dwc, dbc],
                    want[0] + want[1] + [want[2], want[5], want[6]]):
      assert float((g - w).norm() / w.norm()) < GRAD_BOUND['float32']
  else:
    assert max(reads) > 1, reads


@pytest.mark.parametrize('fault', ['db s-sums', 'ts own segment'])
def test_k4_tf32_faults_read_above_the_bound(fault):
  # Two planted faults of the backward's design read above chip_smoke.py's
  # GRAD_BOUND against JAX (`_k4_reads`), with three TF32 passes: the bias
  # gradients from the product stacked over [zeta_l; s_l] (the tangent adds
  # nothing to the biases), and ts made from each column's own segment
  # instead of its partner's.
  case, head, segs, pack, fold, cots = _bwd_case(11, True)
  got = _k4_tf32_model(pack, segs, fold, cots, lambda a, b: torch.from_numpy(
      _truncated_product(a, b, 32)).float(), faults=[fault])
  assert max(_k4_reads(got, case, head, cots)) > 1


# --------------------------------------------------------- the routing


def _defaults_pack(cdt, hc):
  skips = fused_mlp.skip_input_layers(8, 4)
  ws = [torch.zeros(256, 504 if l == 0 else 256 + (504 if l in skips else 0))
        for l in range(8)]
  bs = [torch.zeros(256) for _ in range(8)]
  return fused_mlp.pack_trunk(ws, bs, (252, 252), wd=torch.zeros(1, 256),
                              head_cdt=(torch.zeros(hc, 256),
                                        torch.zeros(hc)),
                              compute_dtype=cdt)


@pytest.mark.parametrize('hc', [256, 128])
@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
def test_defaults_shape_routes_to_the_wide_instances(cdt, hc):
  # 8 x 256 on 504 columns (512 packed), the density head and a 256- or
  # 128-wide bottleneck, with and without the density gradient: the
  # wide-input pair of the dtype's libraries (the f32 forward with the
  # 256-wide head, with and without the density gradient, on
  # csrc/trunk_wide_tf32.cu: 228,896 B with it, 214,560 B without the relu'
  # bits; the bf16 density gradient with the 256-wide head on
  # csrc/trunk_wide_bf16.cu, 226,368 B; the f32 backward with the 256-wide
  # head, with and without it, on csrc/trunk_wide_bwd_tf32.cu: 228,392 B),
  # each launch within an
  # H100's shared memory (the C sums kernel_smem mirrors: bf16 forward
  # 231,480 B at two tiles and a 3-stage ring, 222,648 B with the density
  # gradient and the 128-wide head at one tile, the fold staged and a
  # 3-stage ring; bf16 backward
  # 218,440 / 212,200 B, a 3-stage ring and the fold with it (215,240 B
  # with the 256-wide head: the fold's rows padded to 24, two mbarriers for
  # the tangent read back); f32 forward with the 128-wide head 224,392 /
  # 221,192 B, backward 222,600 / 216,376 B, the fold staged with it),
  # counted under 'K1 wide', 'K3 wide' and 'K4 wide'. Every other shape
  # keeps its route: bf16 K1 and the 128-wide head on trunk_fwd_tma.cu,
  # the f32 128-wide head on trunk_fwd_f32.cu.
  pack = _defaults_pack(cdt, hc)
  fold = torch.as_tensor(fused_mlp.ipe_scale_fold(SCALES, NB))
  tf32 = cdt == 'float32' and hc == 256
  bf = cdt == 'bfloat16' and hc == 256
  smem = {'bfloat16': ((231480, 218440),
                       (226368 if bf else 222648,
                        215240 if hc == 256 else 212200)),
          'float32': ((214560 if tf32 else 224392,
                       228392 if tf32 else 222600),
                      (228896 if tf32 else 221192,
                       228392 if tf32 else 216376))}[cdt]
  modes = (False, fused_mlp.DirModes(), fused_mlp.SpaModes())
  for f, sums in zip((None, fold), smem):
    assert pack.kin == 512 and fused_mlp.wide_input(pack, fold=f)
    assert fused_mlp.missing_instance(pack, hc, f) is None
    libs = (fused_mlp.forward_library(pack, fold=f),
            fused_mlp.backward_library(pack, fold=f))
    assert libs == (fused_mlp.WIDE_TF32_LIBRARY if tf32 else
                    fused_mlp.WIDE_BF16_LIBRARY if bf and f is not None
                    else fused_mlp.FWD_LIBRARY[cdt],
                    fused_mlp.WIDE_TF32_BWD_LIBRARY if tf32
                    else fused_mlp.BWD_LIBRARY[cdt])
    assert fused_mlp.wide_tf32(pack, fold=f) == tf32
    assert fused_mlp.wide_bf16(pack, fold=f) == (bf and f is not None)
    assert fused_mlp.wide_tf32_bwd(pack, fold=f) == tf32
    assert tuple(fused_mlp.kernel_smem(lib, pack, hc, f)
                 for lib in libs) == sums
    assert max(sums) <= fused_mlp.SMEM_LIMIT
    kind = fused_mlp.forward_kind(pack, f)
    assert kind == ('K1' if f is None else 'K3')
    assert fused_mlp.launch_keys(kind, pack, modes[0], f, *modes[1:]) == [
        kind, kind + ' wide']
    assert fused_mlp.launch_keys('K4', pack, modes[0], f, *modes[1:]) == [
        'K4', 'K4 wide']


def test_the_density_gradient_past_the_wide_basis_is_named():
  # The wide-input instances keep u on at most _WIDE_NB basis vectors: a
  # fold of 33 is named by missing_instance, and 'on' raises.
  pack = _defaults_pack('bfloat16', 256)
  fold = torch.zeros(252, 33)
  assert not fused_mlp.wide_input(pack, fold=fold)
  assert fused_mlp.missing_instance(pack, 256, fold) is not None
  with pytest.raises(NotImplementedError):
    fused_mlp._kernel_for(pack, 256, 'on', fold=fold)


def test_f32_backward_route_leaves_the_other_shapes_alone():
  # Only the f32 trunk of `wide_tf32_bwd` (the 256-wide head, no f32 head)
  # takes csrc/trunk_wide_bwd_tf32.cu, with or without the fold; its f32
  # forward without the density gradient takes trunk_wide_tf32.cu's K1. The
  # 128-wide head, an f32 head beside the 256-wide one and bf16 keep their
  # wide-input routes (the forward with the f32 head too), and the shapes
  # still without an instance stay named
  # (tests/test_torch_port_mipnerf360.py pins the 11).
  fold = torch.as_tensor(fused_mlp.ipe_scale_fold(SCALES, NB))
  f32 = _defaults_pack('float32', 256)
  assert fused_mlp.forward_library(f32) == fused_mlp.WIDE_TF32_LIBRARY
  for f in (None, fold):
    assert fused_mlp.backward_library(f32, fold=f) == (
        fused_mlp.WIDE_TF32_BWD_LIBRARY)
    assert fused_mlp.backward_library(f32, y=True, fold=f) != (
        fused_mlp.WIDE_TF32_BWD_LIBRARY)
    for pack in (_defaults_pack('float32', 128), _defaults_pack('bfloat16',
                                                                 256)):
      assert not fused_mlp.wide_tf32_bwd(pack, fold=f)
      assert fused_mlp.backward_library(pack, fold=f) == (
          fused_mlp.BWD_LIBRARY[pack.compute_dtype])
    head = f32._replace(wh=torch.zeros(3, 256), bh=torch.zeros(3))
    assert not fused_mlp.wide_tf32_bwd(head, fold=f)
    assert fused_mlp.backward_library(head, fold=f) == 'trunk_bwd_f32'
    assert fused_mlp.forward_library(head, fold=f) == 'trunk_fwd_f32'


def test_wide_tf32_bwd_launch_arguments_match_exports(monkeypatch):
  # The f32 defaults' K4 through trunk_backward_kernel on CPU tensors with
  # the libraries replaced by _ArgCheck (test_torch_port_cascade.py), with
  # and without u's cotangent: the panels' split (37 or 19 of 65,536
  # entries) and tp's (256 x 32, with u's cotangent), then per slab the
  # per-tile kernel refnerf_wide_tf32_k4 (100 rows in a 128-row scratch,
  # 252 columns a segment, depth 8, the skip at layer 5, 21 basis vectors
  # or 0), the head's tn product (dwc, dbc) and reductions, dwd's column
  # sums, and each layer's tn products (zeta's with the bias partials, then
  # s's without), each with the argument list cuda_build.EXPORTS declares;
  # the products' splits fill the SMs.
  from refnerf_tpu_torch.ops import cuda_build
  import contextlib
  calls = []
  fake = _ArgCheck(calls)
  monkeypatch.setattr(cuda_build, 'library', lambda name: fake)
  monkeypatch.setattr(torch.cuda, 'device',
                      lambda dev: contextlib.nullcontext())
  monkeypatch.setattr(torch.cuda, 'current_stream',
                      lambda dev=None: type('S', (), {'cuda_stream': 0})())
  monkeypatch.setattr(torch.cuda, 'get_device_properties',
                      lambda dev: type('P', (), {
                          'multi_processor_count': 132})())
  for dg, np_ in ((True, 37), (False, 19)):
    del calls[:]
    _, _, segs, pack, fold, cots = _bwd_case(12, dg, n=100)
    sbar, cbar, ubar = cots
    out = fused_mlp.trunk_backward_kernel(segs, pack, (sbar, None, cbar, ubar),
                                          fold if dg else None)
    assert [tuple(t.shape) for t in out[0]] == [
        (256, 504)] + [(256, 256)] * 4 + [(256, 760)] + [(256, 256)] * 2
    names = [fn for fn, _ in calls]
    assert names[:2 if dg else 1] == ['refnerf_wide_tf32_split'] * (
        2 if dg else 1)
    k4 = [args for fn, args in calls if fn == 'refnerf_wide_tf32_k4']
    assert len(k4) == 1
    assert k4[0][:6] == (100, 128, 252, 8, 5, NB if dg else 0)
    assert k4[0][10] == np_
    assert (k4[0][11] is None) == (not dg) and (k4[0][17] is None) == (not dg)
    assert calls[0][1][0] == np_ * 65536
    if dg:
      assert calls[1][1][0] == 256 * 32 and calls[1][1][3] == 252 * NB
    tn = [args for fn, args in calls if fn == 'refnerf_w1024_tn']
    # the head, then per layer zeta's (and s's): (Mo, No, rows, n0)
    assert len(tn) == 1 + 8 * (2 if dg else 1)
    assert all(a[0] == 0 and a[3] == 100 for a in tn)
    assert (tn[0][1], tn[0][2], tn[0][9]) == (256, 256, 256)
    layers = tn[1:]
    per = 2 if dg else 1
    assert [a[2] for a in layers[::per]] == [512] + [256] * 4 + [768] + [
        256] * 2
    assert all(a[13] is not None for a in layers[::per])
    if dg:
      assert all(a[13] is None for a in layers[1::2])
    assert names.count('refnerf_w1024_colsum') == (2 if dg else 1)
  # The partials fill the 132 SMs once (`wide_tf32_splits`): 33, 16 and 11
  # splits of the 256 x 256, 256 x 512 and 256 x 768 gradients.
  assert [fused_mlp.wide_tf32_splits(256, k, 132) for k in (256, 512, 768)
          ] == [33, 16, 11]


# The full-width defaults in a step and a request, the kernels stubbed.
FULL_CUT = ['Model.num_prop_samples = 8', 'Model.num_nerf_samples = 8',
            'Config.batch_size = 2']


@pytest.mark.parametrize('which', ['defaults', 'normals'])
@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
def test_defaults_step_routes_every_trunk_to_an_instance(monkeypatch, cdt,
                                                         which):
  # The defaults at full width (8 x 256, 504 columns, the 256-wide
  # bottleneck; samples and batch cut) in a train step and a request under
  # 'on', the kernels stubbed by their plain versions on the packs' own
  # weights (test_torch_port_cascade.py `_stubbed_kernels`): every spatial
  # trunk launch at every level goes to the wide-input pair (K3 and K4 with
  # u's cotangent in the step, K1 in the request; 'K3 wide' / 'K4 wide' /
  # 'K1 wide' 3 each; f32 K3 and K1 on trunk_wide_tf32.cu, f32 K4 on
  # trunk_wide_bwd_tf32.cu, bf16 K3 on trunk_wide_bf16.cu), every
  # directional one
  # to trunk_dir1.cu, none to a plain version; the step under 'on' equals
  # 'off' to the bit.
  routes, fwd_launches = _stubbed_kernels(monkeypatch)
  fwd, bwd = fused_mlp.FWD_LIBRARY[cdt], fused_mlp.BWD_LIBRARY[cdt]
  k3 = (fused_mlp.WIDE_TF32_LIBRARY if cdt == 'float32' else
        fused_mlp.WIDE_BF16_LIBRARY)
  k1 = fused_mlp.WIDE_TF32_LIBRARY if cdt == 'float32' else fwd
  k4 = fused_mlp.WIDE_TF32_BWD_LIBRARY if cdt == 'float32' else bwd
  runs = {}
  for mode in ('on', 'off'):
    config, gin = configs.parse([], CONFIGS[which] + FULL_CUT + _cdt(cdt) + [
        f"NerfMLP.fused_trunk = '{mode}'", f"PropMLP.fused_trunk = '{mode}'"])
    model = construct.construct_model(config, gin, 'cpu')
    r = _rays_np(2, config, 4)
    batch = rays_lib.Batch(rays=rays_lib.Rays(**{k: _t(v) for k, v in
                                                 r.items()}),
                           rgb=_t(np.full((2, 3), 0.5, np.float32)))
    before = dict(fused_mlp.launches)
    fwd_launches.clear()
    del routes[:]
    state = step_lib.create_train_state(config, model)
    state, stats = step_lib.make_train_step(model, config)(state, batch)
    step = ({k: v - before[k] + fwd_launches[k] for k, v in
             fused_mlp.launches.items()}, list(routes))
    fwd_launches.clear()
    del routes[:]
    with torch.no_grad():
      renderer.render_rays(model, batch.rays, 2)
    request = (collections.Counter(fwd_launches), list(routes))
    runs[mode] = (stats, step, request, model.state_dict())
  (on, (n_on, r_on), (q_on, rq_on), p_on) = runs['on']
  (off, (n_off, r_off), (q_off, rq_off), p_off) = runs['off']
  assert n_off == {k: 0 for k in n_off} and not r_off and not rq_off
  assert {k: v for k, v in n_on.items() if v} == {
      'K3': 3, 'K3 wide': 3, 'K4': 3, 'K4 wide': 3, 'K2': 3, 'K5': 3}
  assert {k: v for k, v in q_on.items() if v} == {
      'K1': 3, 'K1 wide': 3, 'K2': 3}
  dir1 = fused_mlp.DIR1_LIBRARY
  assert sorted(set(r_on)) == sorted({('fwd', 512, k3), ('bwd', 512, k4),
                                      ('fwd', 288, dir1), ('bwd', 288, dir1)})
  assert sorted(set(rq_on)) == sorted({('fwd', 512, k1), ('fwd', 288, dir1)})
  assert torch.equal(on['loss'], off['loss'])
  if which == 'normals':
    assert 'orientation' in on['losses']
  for k, v in p_on.items():
    assert torch.equal(v, p_off[k]), k
