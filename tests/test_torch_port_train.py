"""The port's train path against the JAX package, on the CPU.

- The trunk Functions: forward with the density gradient (K3) and the
  spatial backward (K4), the directional backward with segment cotangents
  (K5). The port's plain versions are held against `jax.grad` of the Pallas
  ops in interpret mode (as tests/test_fused_mlp.py runs them) and against
  torch autograd (double backward for u) of the plain forward.
- The losses, the learning-rate schedule, the global-norm clip and Adam
  against the JAX functions and the optax chain.
- The slice: the port's train_step against JAX make_train_step on the same
  gin (a small cut of configs/blender_refnerf.gin, as in
  tests/test_torch_port_model.py), parameters and batch, for two steps; JAX
  runs its Pallas trunks (`fused_trunk='on'`) in interpret mode.
- F1: the tie subgradients of the colour epilogue and of the compositing's
  background weight.
- The Config's fields and defaults against JAX's; the refusals of ROADMAP
  queue 1, item 7; one train step in a process where jax cannot be
  imported.

Tolerances are stated at each test. float32 throughout, with one bfloat16
trunk case.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from refnerf_tpu import configs as jconfigs
from refnerf_tpu.cameras import rays as jrays
from refnerf_tpu.models import construct as jconstruct
from refnerf_tpu.models.mlp import MLP as JaxMLP
from refnerf_tpu.ops import mathx as jmathx
from refnerf_tpu.ops.pallas import fused_mlp as jfused
from refnerf_tpu.train import losses as jlosses
from refnerf_tpu.train import step as jstep
from refnerf_tpu_torch import configs
from refnerf_tpu_torch import convert
from refnerf_tpu_torch.cameras import rays as rays_lib
from refnerf_tpu_torch.models import construct
from refnerf_tpu_torch.ops import fused_mlp
from refnerf_tpu_torch.ops import mathx
from refnerf_tpu_torch.train import losses
from refnerf_tpu_torch.train import step as step_lib

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIN = os.path.join(REPO, 'configs', 'blender_refnerf.gin')
SMALL = [
    'NerfMLP.net_depth = 4', 'NerfMLP.net_width = 32',
    'NerfMLP.net_depth_viewdirs = 4', 'NerfMLP.net_width_viewdirs = 32',
    'NerfMLP.skip_layer = 2', 'NerfMLP.bottleneck_width = 16',
    'Model.num_prop_samples = 16', 'Model.num_nerf_samples = 16',
    'Config.sample_noise_size = 0', 'Config.batch_size = 12',
]
DEPTH, WIDTH, SKIP = 4, 32, 2
SCALES = 2.0**np.arange(0, 16)  # the flagship's max_deg_point = 16


def _t(a):
  return torch.tensor(np.ascontiguousarray(a))


def _np(x):
  return np.asarray(jnp.asarray(x, jnp.float32))


def _trunk_params(rng, fin, hf, hc):
  """Flax-layout ([in, out]) trunk, density and head parameters."""
  skips = jfused.skip_input_layers(DEPTH, SKIP)
  ks, bs = [], []
  for l in range(DEPTH):
    ind = fin if l == 0 else WIDTH + (fin if l in skips else 0)
    ks.append((rng.normal(size=(ind, WIDTH)) / np.sqrt(ind)).astype(np.float32))
    bs.append((rng.normal(size=(WIDTH,)) * 0.1).astype(np.float32))
  p = dict(ks=ks, bs=bs,
           wd=(rng.normal(size=(WIDTH, 1)) / np.sqrt(WIDTH)).astype(np.float32),
           bd=(rng.normal(size=(1,)) * 0.1).astype(np.float32),
           wh=(rng.normal(size=(WIDTH, hf)) / np.sqrt(WIDTH)).astype(np.float32),
           bh=(rng.normal(size=(hf,)) * 0.1).astype(np.float32))
  if hc:
    p['wc'] = (rng.normal(size=(WIDTH, hc)) / np.sqrt(WIDTH)).astype(np.float32)
    p['bc'] = (rng.normal(size=(hc,)) * 0.1).astype(np.float32)
  return p


def _port_leaves(p):
  """The same parameters in nn.Linear layout, as leaves that need grad."""
  out = dict(ws=[_t(k.T) for k in p['ks']], bs=[_t(b) for b in p['bs']],
             wd=_t(p['wd'].T), bd=_t(p['bd']), wh=_t(p['wh'].T),
             bh=_t(p['bh']))
  if 'wc' in p:
    out.update(wc=_t(p['wc'].T), bc=_t(p['bc']))
  for v in out.values():
    for t in (v if isinstance(v, list) else [v]):
      t.requires_grad_(True)
  return out


def _assert_grads(port, ref, rtol, what):
  """Each gradient within rtol * max(|ref|) of the reference."""
  a, b = port.detach().float().numpy(), np.asarray(ref, np.float32)
  assert a.shape == b.shape, (what, a.shape, b.shape)
  scale = max(1e-6, float(np.abs(b).max()))
  np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale, err_msg=what)


def _spatial_loss(xp, sig, h, c, u):
  return (xp.sum(xp.tanh(sig)) + xp.sum(xp.sin(h)) + xp.sum(xp.cos(c)) +
          xp.sum(xp.sqrt(xp.sum(u * u, -1) + 1e-4)))


# K3 + K4 against Pallas interpret: float32 1e-4 of each gradient's largest
# entry (sums over 65 samples and 32-wide layers in another order, through a
# second-order chain); bfloat16 5e-2 (a bf16 rounding flip, 2^-8 relative,
# of one activation moves every later layer's operands, and the cotangents
# are rounded to bf16 at each layer in both).
@pytest.mark.parametrize('cdt,tol', [('float32', 1e-4), ('bfloat16', 5e-2)])
def test_spatial_trunk_k3_k4_match_pallas(cdt, tol):
  rng = np.random.default_rng(0)
  lead = (5, 13)  # 65 samples: not a multiple of the Pallas block of 32
  lm = rng.uniform(-1.5, 1.5, lead + (3,)).astype(np.float32)
  lv = (10.0**rng.uniform(-6, -2, lead + (3,))).astype(np.float32)
  p = _trunk_params(rng, fin=2 * 3 * len(SCALES), hf=10, hc=16)

  def jloss(q):
    ks, bs, wd, bd, wh, bh, wc, bc = q
    sig, h, c, u = jfused.fused_encoded_trunk(
        jnp.asarray(lm), jnp.asarray(lv), SCALES, ks, bs, wd, bd,
        skip_period=SKIP, density_grad=True, head_f32=(wh, bh),
        head_cdt=(wc, bc), compute_dtype=cdt, block=32)
    return _spatial_loss(jnp, sig, h, c, u), (sig, h, c, u)

  q = ([jnp.asarray(k) for k in p['ks']], [jnp.asarray(b) for b in p['bs']],
       *[jnp.asarray(p[k]) for k in ('wd', 'bd', 'wh', 'bh', 'wc', 'bc')])
  (_, jouts), jg = jax.value_and_grad(jloss, has_aux=True)(q)

  tp = _port_leaves(p)
  outs = fused_mlp.fused_encoded_trunk(
      _t(lm), _t(lv), SCALES, tp['ws'], tp['bs'], tp['wd'], tp['bd'],
      skip_period=SKIP, density_grad=True, head_f32=(tp['wh'], tp['bh']),
      head_cdt=(tp['wc'], tp['bc']), compute_dtype=cdt)
  assert [tuple(o.shape) for o in outs] == [(5, 13), (5, 13, 10),
                                            (5, 13, 16), (5, 13, 3)]
  for name, a, b in zip(('sigma', 'h_f32', 'h_cdt', 'u'), outs, jouts):
    _assert_grads(a, _np(b), tol, name)
  loss = _spatial_loss(torch, outs[0], outs[1], outs[2].float(), outs[3])
  leaves = [*tp['ws'], *tp['bs'], tp['wd'], tp['bd'], tp['wh'], tp['bh'],
            tp['wc'], tp['bc']]
  got = torch.autograd.grad(loss, leaves)
  ks, bs, *heads = jg
  want = [k.T for k in ks] + list(bs) + [heads[0].T, heads[1], heads[2].T,
                                         heads[3], heads[4].T, heads[5]]
  for i, (a, b) in enumerate(zip(got, want)):
    _assert_grads(a, _np(b), tol, f'leaf {i}')


def test_spatial_backward_matches_autograd_double_backward():
  # The plain backward (Pallas order, written out) against torch autograd
  # through the plain forward, whose u is itself a reverse chain: float32,
  # 1e-5 of each gradient's largest entry (same operations, other order).
  rng = np.random.default_rng(1)
  nb = 3
  lm = _t(rng.uniform(-1, 1, (40, nb)).astype(np.float32))
  lv = _t((10.0**rng.uniform(-6, -2, (40, nb))).astype(np.float32))
  p = _trunk_params(rng, fin=2 * nb * 4, hf=10, hc=16)
  scales = 2.0**np.arange(4)
  xs, xc = fused_mlp.encode_ipe(lm, lv, scales)
  fold = _t(fused_mlp.ipe_scale_fold(scales, nb))

  def run(fn_outs, tp):
    sig, h, c, u = fn_outs
    loss = _spatial_loss(torch, sig, h, c, u)
    leaves = [*tp['ws'], *tp['bs'], tp['wd'], tp['wh'], tp['bh'], tp['wc'],
              tp['bc']]
    return torch.autograd.grad(loss, leaves)

  tp = _port_leaves(p)
  outs = fused_mlp.trunk_reference(
      [xs, xc], tp['ws'], tp['bs'], skip_period=SKIP, wd=tp['wd'],
      head_f32=(tp['wh'], tp['bh']), head_cdt=(tp['wc'], tp['bc']),
      density_grad=True)
  u = fused_mlp.fold_density_grad(outs[3:], xs, xc, fold)
  want = run(outs[:3] + [u], tp)
  tp2 = _port_leaves(p)
  got = run(fused_mlp.fused_encoded_trunk(
      lm, lv, scales, tp2['ws'], tp2['bs'], tp2['wd'], skip_period=SKIP,
      density_grad=True, head_f32=(tp2['wh'], tp2['bh']),
      head_cdt=(tp2['wc'], tp2['bc'])), tp2)
  for i, (a, b) in enumerate(zip(got, want)):
    _assert_grads(a, b.numpy(), 1e-5, f'leaf {i}')


# K2 + K5 against Pallas interpret, float32: 1e-4 of each gradient's largest
# entry (as for K4).
def test_directional_trunk_k5_matches_pallas():
  rng = np.random.default_rng(2)
  # Segments as in the flagship: [bottleneck | 2x36 IDE + n.v], here 16 + 73;
  # 77 samples, ragged against the Pallas block of 32.
  segs = [rng.normal(size=(7, 11, 16)).astype(np.float32),
          rng.uniform(-1, 1, (7, 11, 73)).astype(np.float32)]
  p = _trunk_params(rng, fin=16 + 73, hf=3, hc=0)
  cot = rng.normal(size=(7, 11, 3)).astype(np.float32)

  def jloss(q):
    sg, ks, bs, wh, bh = q
    out = jfused.fused_trunk(sg, ks, bs, head_f32=(wh, bh), out_y=False,
                             skip_period=SKIP, needs_dx=True, block=32)
    return jnp.sum(jnp.sin(out) * cot), out

  q = ([jnp.asarray(s) for s in segs], [jnp.asarray(k) for k in p['ks']],
       [jnp.asarray(b) for b in p['bs']], jnp.asarray(p['wh']),
       jnp.asarray(p['bh']))
  (_, jout), (jdx, jks, jbs, jwh, jbh) = jax.value_and_grad(
      jloss, has_aux=True)(q)
  tp = _port_leaves(p)
  tsegs = [_t(s).requires_grad_(True) for s in segs]
  out = fused_mlp.fused_trunk(tsegs, tp['ws'], tp['bs'], (tp['wh'], tp['bh']),
                              skip_period=SKIP)
  _assert_grads(out, _np(jout), 1e-5, 'rgb')
  loss = torch.sum(torch.sin(out) * _t(cot))
  got = torch.autograd.grad(loss, [*tsegs, *tp['ws'], *tp['bs'], tp['wh'],
                                   tp['bh']])
  want = list(jdx) + [k.T for k in jks] + list(jbs) + [jwh.T, jbh]
  for i, (a, b) in enumerate(zip(got, want)):
    _assert_grads(a, _np(b), 1e-4, f'leaf {i}')


def test_losses_match_jax():
  # float32, 1e-6 relative: the same elementwise ops and means.
  rng = np.random.default_rng(3)
  n, s = 6, 5
  rgb = [rng.uniform(size=(n, 3)).astype(np.float32) for _ in range(2)]
  gt = rng.uniform(size=(n, 3)).astype(np.float32)
  lossmult = rng.uniform(0.5, 1, (n, 1)).astype(np.float32)
  viewdirs = rng.normal(size=(n, 3)).astype(np.float32)
  hist = [dict(weights=rng.uniform(size=(n, s)).astype(np.float32),
               normals=rng.normal(size=(n, s, 3)).astype(np.float32),
               normals_pred=rng.normal(size=(n, s, 3)).astype(np.float32))
          for _ in range(2)]
  for loss_type in ('mse', 'charb'):
    config, _ = configs.parse([GIN], [f"Config.data_loss_type = '{loss_type}'"])
    jconfig, _ = jconfigs.parse([GIN], [f"Config.data_loss_type = '{loss_type}'"])
    jr = jrays.dummy_rays(n).replace(lossmult=jnp.asarray(lossmult),
                                     viewdirs=jnp.asarray(viewdirs))
    pr = rays_lib.dummy_rays(n)
    pr.lossmult, pr.viewdirs = _t(lossmult), _t(viewdirs)
    want, wstats = jlosses.compute_data_loss(
        jrays.Batch(rays=jr, rgb=jnp.asarray(gt)),
        [{'rgb': jnp.asarray(r)} for r in rgb], jr, jconfig)
    got, stats = losses.compute_data_loss(
        rays_lib.Batch(rays=pr, rgb=_t(gt)), [{'rgb': _t(r)} for r in rgb],
        pr, config)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(stats['mses'].numpy(), _np(wstats['mses']),
                               rtol=1e-6)
  jhist = [{k: jnp.asarray(v) for k, v in h.items()} for h in hist]
  phist = [{k: _t(v) for k, v in h.items()} for h in hist]
  np.testing.assert_allclose(
      float(losses.orientation_loss(pr, 2, phist, config)),
      float(jlosses.orientation_loss(jr, 2, jhist, jconfig)), rtol=1e-6)
  np.testing.assert_allclose(
      float(losses.predicted_normal_loss(2, phist, config)),
      float(jlosses.predicted_normal_loss(2, jhist, jconfig)), rtol=1e-6)


def test_learning_rate_and_optimizer_match_optax():
  # The schedule: float32 1e-6 relative. Params after two Adam steps of the
  # optax chain, with gradients above the clip norm (step 1) and below it
  # (step 2, max_norm raised past the norm): 1e-6 of the update size.
  config, _ = configs.parse([GIN], [])
  jconfig, _ = jconfigs.parse([GIN], [])
  for step in (0, 1, 100, 511, 512, 4000, 300000, 400000):
    want = float(jstep.create_lr_schedule(jconfig)(step))
    got = float(step_lib.create_lr_schedule(config)(step))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(
        float(mathx.learning_rate_decay(float(step), 2e-3, 2e-5, 1000, 0)),
        float(jmathx.learning_rate_decay(float(step), 2e-3, 2e-5, 1000, 0)),
        rtol=1e-6)

  rng = np.random.default_rng(4)
  shapes = {'a': (5, 3), 'b': (7,)}
  params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
  grads = [{k: rng.normal(size=s).astype(np.float32) * m
            for k, s in shapes.items()} for m in (1.0, 1e-5)]
  g_norms = [np.sqrt(sum(np.sum(g[k]**2) for g in [gs] for k in gs))
             for gs in grads]
  assert g_norms[0] > config.grad_max_norm > g_norms[1]

  module = torch.nn.Module()
  for k, v in params.items():
    module.register_parameter(k, torch.nn.Parameter(_t(v)))
  state = step_lib.create_train_state(config, module)
  tx = jstep.create_optimizer(jconfig)
  jp = {k: jnp.asarray(v) for k, v in params.items()}
  opt = tx.init(jp)
  for gs in grads:
    updates, opt = tx.update({k: jnp.asarray(v) for k, v in gs.items()}, opt,
                             jp)
    jp = optax.apply_updates(jp, updates)
    step_lib.apply_gradients(state, {k: _t(v) for k, v in gs.items()},
                             config)
    for k in shapes:
      moved = np.abs(_np(jp[k]) - params[k]).max()
      np.testing.assert_allclose(getattr(module, k).detach().numpy(),
                                 _np(jp[k]), rtol=0, atol=1e-6 * moved)
  assert state.opt.count == 2


def test_global_norm_clip_is_optax():
  # At and above max_norm optax scales by max_norm / norm (exactly max_norm
  # after); below it the gradients pass unchanged. torch's clip_grad_norm_
  # would scale by max_norm / (norm + 1e-6) (H6).
  g = {'a': torch.tensor([3e-4, -4e-4])}  # norm 5e-4
  out = step_lib.clip_by_global_norm(g, 1e-4)
  want = optax.clip_by_global_norm(1e-4).update(
      {'a': jnp.asarray(g['a'].numpy())}, None)[0]['a']
  np.testing.assert_allclose(out['a'].numpy(), _np(want), rtol=1e-7)
  np.testing.assert_allclose(float(step_lib.global_norm(out.values())), 1e-4,
                             rtol=1e-6)
  at = step_lib.clip_by_global_norm(g, float(step_lib.global_norm(g.values())))
  np.testing.assert_allclose(at['a'].numpy(), g['a'].numpy(), rtol=1e-6)
  assert step_lib.clip_by_global_norm(g, 1e-3)['a'] is g['a']


def _init_params(bindings, seed=0):
  """JAX parameters of the small model, with random biases, as numpy."""
  config, gin = jconfigs.parse([GIN], bindings)
  model = jconstruct.construct_model(config, gin)
  p = jax.device_get(jconstruct.init_params(jax.random.PRNGKey(seed), model))
  rng = np.random.default_rng(seed)
  return jax.tree_util.tree_map_with_path(
      lambda path, x: np.asarray(x) + (
          rng.normal(size=x.shape).astype(np.float32) * 0.1
          if path[-1].key == 'bias' else 0.0), p)


def _batch_np(n, seed):
  """Rays and pixels as bench.py makes them (bench.py:105-119)."""
  rng = np.random.RandomState(seed)
  d = rng.randn(n, 3).astype(np.float32)
  return dict(origins=rng.randn(n, 3).astype(np.float32) * 0.1, directions=d,
              viewdirs=d / np.linalg.norm(d, axis=-1, keepdims=True),
              radii=np.full((n, 1), 0.001, np.float32),
              lossmult=np.ones((n, 1), np.float32),
              near=np.full((n, 1), 2.0, np.float32),
              far=np.full((n, 1), 6.0, np.float32),
              rgb=rng.uniform(0, 1, (n, 3)).astype(np.float32))


def _jax_loss_fn(model, config, batch, step):
  """The loss_fn of JAX make_train_step (step.py:168-243) for the flagship's
  terms, to read the gradients the JAX step does not return."""
  train_frac = jnp.clip((step - 1) / (config.max_steps - 1), 0, 1)

  def loss_fn(params):
    renderings, hist = model.apply({'params': params}, batch.rays,
                                   train_frac=train_frac,
                                   compute_extras=False, train=True, rng=None)
    data, _ = jlosses.compute_data_loss(batch, renderings, batch.rays, config)
    return (data + jlosses.orientation_loss(batch.rays, 2, hist, config) +
            jlosses.predicted_normal_loss(2, hist, config))
  return loss_fn


def _flat(tree):
  return {k: v.numpy() for k, v in convert.params_to_state_dict(tree).items()}


def test_train_step_matches_jax():
  # Two steps of the small flagship cut, float32. JAX runs its Pallas trunks
  # in interpret mode (fused_trunk='on', the formulation the port follows).
  # Tolerances: the loss terms and psnrs 1e-5 relative; each gradient
  # before clipping 2e-4 of its largest entry (the level-1 samples follow
  # the level-0 weights, summed in another order; the normals' second-order
  # chain amplifies it); the parameters after each step 2e-2 of the largest
  # move of that parameter (at this learning rate the first Adam updates are
  # ~lr * g / (|g| + eps), and the clipped gradients sit near eps = 1e-6).
  bindings = SMALL + ["NerfMLP.fused_trunk = 'on'"]
  params = _init_params(bindings)
  jconfig, jgin = jconfigs.parse([GIN], bindings)
  jmodel = jconstruct.construct_model(jconfig, jgin)
  b = _batch_np(12, seed=0)
  jbatch = jrays.Batch(
      rays=jrays.dummy_rays(12).replace(**{k: jnp.asarray(v) for k, v in
                                           b.items() if k != 'rgb'}),
      rgb=jnp.asarray(b['rgb']))
  jstate = jstep.create_train_state(jconfig, jmodel, params)
  jtrain = jax.jit(jstep.make_train_step(jmodel, jconfig))
  jgrads = jax.jit(jax.grad(_jax_loss_fn(jmodel, jconfig, jbatch, 0.0)))(
      jstate.params)

  config, gin = configs.parse([GIN], bindings)
  model = construct.construct_model(config, gin, 'cpu')
  convert.load_jax_params(model, params)
  rays = rays_lib.dummy_rays(12)
  for k, v in b.items():
    if k != 'rgb':
      setattr(rays, k, _t(v))
  batch = rays_lib.Batch(rays=rays, rgb=_t(b['rgb']))
  state = step_lib.create_train_state(config, model)
  train = step_lib.make_train_step(model, config)

  _, _, grads = train.loss_and_grads(state, batch)
  want = _flat(jgrads)
  assert set(grads) == set(want)
  for k, g in grads.items():
    _assert_grads(g, want[k], 2e-4, k)

  before = {k: v.detach().clone().numpy() for k, v in state.params().items()}
  for step in (1, 2):
    jstate, jstats = jtrain(jstate, jbatch)
    state, stats = train(state, batch)
    assert state.step == step and int(jstate.step) == step
    assert set(stats['losses']) == set(jstats['losses']) == {
        'data', 'orientation', 'predicted_normals'}
    for k in stats['losses']:
      np.testing.assert_allclose(float(stats['losses'][k]),
                                 float(jstats['losses'][k]), rtol=1e-5)
    for k in ('loss', 'psnr', 'learning_rate'):
      np.testing.assert_allclose(float(stats[k]), float(jstats[k]),
                                 rtol=1e-5)
    np.testing.assert_allclose(stats['psnrs'].numpy(), _np(jstats['psnrs']),
                               rtol=1e-5)
    jparams = _flat(jax.device_get(jstate.params))
    for k, p in state.params().items():
      moved = max(1e-12, float(np.abs(jparams[k] - before[k]).max()))
      np.testing.assert_allclose(p.detach().numpy(), jparams[k], rtol=0,
                                 atol=2e-2 * moved, err_msg=k)
    assert len(stats['grad_norms']) == len(jax.tree.leaves(params))


def test_colour_epilogue_tie_gradients_match_jax():
  # F1, the colour epilogue. With spec + diffuse above 1 every sample is
  # gamut-normalised: its largest channel is exactly 1, linear_to_srgb(1) is
  # exactly 1, and the clip to [0, 1] sits on a tie, where JAX passes half
  # the gradient. The gradients of the three colour heads' biases (sums of
  # the per-sample gradients with respect to the epilogue's raw inputs)
  # against jax.grad of the JAX MLP, float32, 1e-5 of the largest entry.
  # The tie's own share cancels here (the largest channel is x / x, whose
  # numerator and normaliser paths sum to zero), so torch.clip passes this
  # test too; the tie that moves a gradient is the background weight's
  # (test_compositing_tie_gradient_matches_jax).
  bindings = SMALL + ["NerfMLP.fused_trunk = 'on'"]
  params = _init_params(bindings, seed=5)
  mlp_p = dict(params['nerf_mlp'])
  for layer in ('rgb', 'raw_rgb_diffuse', 'raw_tint'):
    mlp_p[layer] = dict(mlp_p[layer], bias=np.full(3, 3.0, np.float32))
  _, jgin = jconfigs.parse([GIN], bindings)
  jmlp = JaxMLP(**jconfigs.mlp_kwargs(jgin, 'NerfMLP'))
  rng = np.random.default_rng(5)
  b = _batch_np(6, seed=5)
  s = 8
  tdist = np.sort(rng.uniform(2, 6, (6, s + 1)), axis=-1).astype(np.float32)
  from refnerf_tpu.models import render as jrender
  means, covs = jrender.cast_rays(jnp.asarray(tdist), jnp.asarray(b['origins']),
                                  jnp.asarray(b['directions']),
                                  jnp.asarray(b['radii']), 'cone', diag=False)
  cot = rng.normal(size=(6, s, 3)).astype(np.float32)

  def jloss(p):
    out = jmlp.apply({'params': p}, (means, covs), jnp.asarray(b['viewdirs']),
                     None, False)
    return jnp.sum(out['rgb'] * cot), out['rgb']

  (_, jrgb), jg = jax.value_and_grad(jloss, has_aux=True)(mlp_p)
  assert float(jnp.max(jrgb)) == pytest.approx(1.001, abs=1e-6)

  config, gin = configs.parse([GIN], bindings)
  model = construct.construct_model(config, gin, 'cpu')
  convert.load_jax_params(model, {'nerf_mlp': mlp_p})
  out = model.nerf_mlp((_t(np.asarray(means)), _t(np.asarray(covs))),
                       _t(b['viewdirs']))
  loss = torch.sum(out['rgb'] * _t(cot))
  for layer in ('rgb', 'raw_rgb_diffuse', 'raw_tint'):
    got, = torch.autograd.grad(loss, getattr(model.nerf_mlp, layer).bias,
                               retain_graph=True)
    _assert_grads(got, _np(jg[layer]['bias']), 1e-5, layer)


def test_compositing_tie_gradient_matches_jax():
  # F1. A ray whose weights sum to exactly 1 (opaque) puts the background
  # weight max(0, 1 - acc) on a tie; JAX passes half the gradient there,
  # torch.clamp all of it. float32, 1e-6 of the largest entry.
  from refnerf_tpu.models import render as jrender
  from refnerf_tpu_torch.models import render
  rng = np.random.default_rng(6)
  weights = np.array([[0.25, 0.75, 0.0], [0.5, 0.25, 0.25],
                      [0.1, 0.2, 0.3]], np.float32)  # acc 1, 1, 0.6
  rgbs = rng.uniform(size=(3, 3, 3)).astype(np.float32)
  tdist = np.sort(rng.uniform(2, 6, (3, 4)), axis=-1).astype(np.float32)
  cot = rng.normal(size=(3, 3)).astype(np.float32)

  def jloss(w, c):
    r = jrender.volumetric_rendering(c, c, jnp.zeros_like(c), w,
                                     jnp.asarray(tdist), 1.0, 6.0, False)
    return jnp.sum(r['rgb'] * cot)

  jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(weights), jnp.asarray(rgbs))
  w, c = _t(weights).requires_grad_(True), _t(rgbs).requires_grad_(True)
  r = render.volumetric_rendering(c, c, torch.zeros_like(c), w, _t(tdist), 1.0)
  got = torch.autograd.grad(torch.sum(r['rgb'] * _t(cot)), [w, c])
  for a, b, name in zip(got, jg, ('weights', 'rgbs')):
    _assert_grads(a, _np(b), 1e-6, name)


def test_config_fields_match_jax():
  # Every field the port reads, training fields included, has the JAX
  # Config's name and default; every other JAX field is listed as unread.
  jfields = {f.name: f for f in dataclasses.fields(jconfigs.Config)}
  default = lambda f: (f.default_factory() if f.default is dataclasses.MISSING
                       else f.default)
  read = [f for f in dataclasses.fields(configs.Config) if f.name != 'unread']
  for f in read:
    assert f.name in jfields, f.name
    assert default(f) == default(jfields[f.name]), f.name
  assert set(jfields) == {f.name for f in read} | configs._UNREAD_FIELDS


def test_unported_training_options_are_refused():
  # What JAX refuses, the port refuses: density or bottleneck noise without
  # draws (Config.randomized = False: JAX's MLP gets no rng key and raises,
  # mlp.py:437-438, :517-518). With Config.randomized = True both train, and
  # are held against JAX with JAX's draws in tests/test_torch_port_cascade.py
  # (test_cascade_steps_match_jax_with_jax_draws) and statistically in
  # tests/test_torch_port_stochastic.py.
  rng = np.random.default_rng(0)
  d = rng.normal(size=(4, 3)).astype(np.float32)
  rays = rays_lib.dummy_rays(4)
  rays.directions = _t(d)
  rays.viewdirs = _t(d / np.linalg.norm(d, axis=-1, keepdims=True))
  rays.near, rays.far = rays.near + 2, rays.far + 5
  rays.lossmult = torch.ones_like(rays.lossmult)
  batch = rays_lib.Batch(rays=rays, rgb=torch.full((4, 3), 0.5))
  for name in ('density_noise', 'bottleneck_noise'):
    config, gin = configs.parse([GIN], SMALL + [f'NerfMLP.{name} = 1.0'])
    model = construct.construct_model(config, gin, 'cpu')
    train = step_lib.make_train_step(model, config)
    with pytest.raises(ValueError, match=f'{name} > 0 requires draws'):
      train(step_lib.create_train_state(config, model), batch)
    config, gin = configs.parse([GIN], SMALL + [f'NerfMLP.{name} = 1.0',
                                                'Config.randomized = True'])
    model = construct.construct_model(config, gin, 'cpu')
    _, stats = step_lib.make_train_step(model, config)(
        step_lib.create_train_state(config, model), batch)
    assert torch.isfinite(stats['loss'])


def test_port_takes_a_train_step_without_jax():
  script = textwrap.dedent(f'''
      import sys, tempfile
      for name in ('jax', 'flax', 'optax', 'absl', 'refnerf_tpu', 'PIL'):
        sys.modules[name] = None
      import numpy as np, torch
      from refnerf_tpu_torch import configs
      from refnerf_tpu_torch.cameras import camera_utils
      from refnerf_tpu_torch.cameras import rays as rays_lib
      from refnerf_tpu_torch.data import datasets, prefetch
      from refnerf_tpu_torch.models import construct
      from refnerf_tpu_torch.tools import sphere_scene
      from refnerf_tpu_torch.train import step as step_lib
      config, gin = configs.parse([{GIN!r}], {SMALL!r})
      model = construct.construct_model(config, gin, 'cpu')
      rng = np.random.default_rng(0)
      d = torch.tensor(rng.normal(size=(5, 3)).astype(np.float32))
      rays = rays_lib.dummy_rays(5)
      rays.directions, rays.viewdirs = d, d / d.norm(dim=-1, keepdim=True)
      rays.near, rays.far = rays.near + 2, rays.far + 5
      rays.lossmult = rays.lossmult + 1
      batch = rays_lib.Batch(rays, torch.rand(5, 3))
      state = step_lib.create_train_state(config, model)
      before = model.nerf_mlp.spatial_0.weight.detach().clone()
      state, stats = step_lib.make_train_step(model, config)(state, batch)
      assert torch.isfinite(stats['loss']) and state.step == 1
      assert not torch.equal(before, model.nerf_mlp.spatial_0.weight)
      # A step from a scene on disk, its PNGs read without Pillow, the rays
      # cast in the step from Pixels.
      with tempfile.TemporaryDirectory() as scene:
        ds = datasets.load_dataset(
            'train', sphere_scene.make_scene(scene, 2, 1, 8), config)
      cast = lambda cams, pix: camera_utils.cast_ray_batch(cams, pix,
                                                           ds.camtype)
      batch = next(prefetch.training_batches(ds, device='cpu'))
      assert isinstance(batch.rays, rays_lib.Pixels)
      state, stats = step_lib.make_train_step(model, config, cast)(
          state, batch, ds.device_cameras('cpu'))
      assert torch.isfinite(stats['loss']) and state.step == 2
      bad = [m for m in sys.modules if m.split('.')[0] in
             ('jax', 'flax', 'optax', 'absl', 'refnerf_tpu', 'PIL')
             and sys.modules[m] is not None]
      assert not bad, bad
      print('trained', sorted(stats['losses']))
  ''')
  env = {**os.environ, 'PYTHONPATH': REPO}
  proc = subprocess.run([sys.executable, '-c', script], cwd=REPO, env=env,
                        capture_output=True, text=True, timeout=300)
  assert proc.returncode == 0, proc.stderr
  assert "trained ['data', 'orientation', 'predicted_normals']" in proc.stdout
