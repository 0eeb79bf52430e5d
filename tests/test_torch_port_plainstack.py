"""The plain layer stack and the shape dispatch of the port's MLP, against JAX.

JAX's MLP runs its plain flax layer stack, not the fused trunk, for a
non-ReLU activation and for a trunk that ends in a skip concat (`_fused`,
refnerf_tpu/models/mlp.py:221-241), and its kernels take any width. The
port does the same: those two cases run the plain stack under torch
autograd (logged once where the kernels would have run), and under
fused_trunk='auto' a trunk shape without a kernel instance runs the plain
versions (logged once; 'on' raises). Held here, on the CPU:
- an ELU trunk on the verify skill's tiny gin, served (Model.apply, eval)
  and trained (the loss and every gradient, density normals included:
  second order), against JAX;
- a depth-5, skip-4 trunk (both trunks end in a skip concat; the heads read
  the widened output), served and trained, against JAX;
- the tiny gin under a stubbed `fused_mlp.use_kernel` (as on a card): plain
  and logged once under 'auto', raising under 'on'; the ELU trunk logged.

Tolerances, float32, as tests/test_torch_port_model.py and
test_torch_port_train.py: served outputs 1e-4 (the level-1 samples follow
the level-0 weights, summed in another order); the loss 1e-5 relative; each
gradient 2e-4 of its largest entry (the normals' second-order chain
amplifies the summation order). JAX builds the IPE cosine as sin(m + pi/2)
and so does the port's plain stack (coord.integrated_pos_enc).
"""

import logging
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
from refnerf_tpu_torch import configs
from refnerf_tpu_torch import convert
from refnerf_tpu_torch.cameras import rays as rays_lib
from refnerf_tpu_torch.models import construct
from refnerf_tpu_torch.models import mlp as mlp_lib
from refnerf_tpu_torch.ops import fused_mlp
from refnerf_tpu_torch.train import step as step_lib

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIN = os.path.join(REPO, 'configs', 'blender_refnerf.gin')
# The verify skill's tiny gin (.claude/skills/verify/SKILL.md).
TINY = ['NerfMLP.net_depth = 2', 'NerfMLP.net_width = 16',
        'NerfMLP.net_depth_viewdirs = 1', 'NerfMLP.net_width_viewdirs = 16',
        'NerfMLP.bottleneck_width = 8', 'NerfMLP.max_deg_point = 4',
        'NerfMLP.deg_view = 2', 'Model.num_prop_samples = 8',
        'Model.num_nerf_samples = 8']
# Both trunks of depth 5 with skip_layer 4: each ends in a skip concat.
SKIP5 = ['NerfMLP.net_depth = 5', 'NerfMLP.net_width = 32',
         'NerfMLP.net_depth_viewdirs = 5', 'NerfMLP.net_width_viewdirs = 32',
         'NerfMLP.skip_layer = 4', 'NerfMLP.bottleneck_width = 16',
         'Model.num_prop_samples = 16', 'Model.num_nerf_samples = 16']
CASES = {'elu': TINY, 'trailing_concat': SKIP5}


def _jax_model(bindings, elu):
  config, gin = jconfigs.parse([GIN], bindings)
  model = jconstruct.construct_model(config, gin)
  if elu:  # JAX's gin keeps the activation a callable: set it on the module
    model = model.clone(nerf_mlp=model.nerf_mlp.clone(
        net_activation=jax.nn.elu))
  return config, model


def _port_model(bindings, elu):
  config, gin = configs.parse(
      [GIN], bindings + (["NerfMLP.net_activation = 'elu'"] if elu else []))
  return config, construct.construct_model(config, gin, 'cpu')


def _init_params(model, seed=0):
  """JAX parameters with random biases, as numpy."""
  p = jax.device_get(jconstruct.init_params(jax.random.PRNGKey(seed), model))
  rng = np.random.default_rng(seed)
  return jax.tree_util.tree_map_with_path(
      lambda path, x: np.asarray(x) + (
          rng.normal(size=x.shape).astype(np.float32) * 0.1
          if path[-1].key == 'bias' else 0.0), p)


def _rays_np(n, seed):
  rng = np.random.RandomState(seed)
  d = rng.randn(n, 3).astype(np.float32)
  return dict(origins=rng.randn(n, 3).astype(np.float32) * 0.1, directions=d,
              viewdirs=d / np.linalg.norm(d, axis=-1, keepdims=True),
              radii=np.full((n, 1), 0.001, np.float32),
              lossmult=np.ones((n, 1), np.float32),
              near=np.full((n, 1), 2.0, np.float32),
              far=np.full((n, 1), 6.0, np.float32))


def _port_rays(r):
  rays = rays_lib.dummy_rays(r['origins'].shape[0])
  for k, v in r.items():
    setattr(rays, k, torch.tensor(v))
  return rays


def _jax_rays(r):
  n = r['origins'].shape[0]
  return jrays.dummy_rays(n).replace(**{k: jnp.asarray(v) for k, v in r.items()})


def _close(a, b, tol):
  np.testing.assert_allclose(a.detach().float().numpy(),
                             np.asarray(b, np.float32), rtol=tol, atol=tol)


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_stack_serves_like_jax(case):
  elu = case == 'elu'
  _, jmodel = _jax_model(CASES[case], elu)
  params = _init_params(jmodel)
  r = _rays_np(8, seed=2)
  renderings, _ = jax.jit(lambda p, rays: jmodel.apply(
      {'params': p}, rays, train_frac=1.0, compute_extras=False,
      train=False))(params, _jax_rays(r))
  _, model = _port_model(CASES[case], elu)
  convert.load_jax_params(model, params)
  with torch.no_grad():
    port, _ = model(_port_rays(r))
  for level in range(2):
    assert set(port[level]) == set(renderings[level])
    for k, v in port[level].items():
      _close(v, renderings[level][k], 1e-4)
  assert torch.isfinite(port[-1]['rgb']).all()


def _jax_loss_fn(model, config, batch):
  """The loss of JAX make_train_step at step 0 (train_frac 0) for the
  flagship's terms: data, orientation, predicted normals."""
  def loss_fn(params):
    renderings, hist = model.apply({'params': params}, batch.rays,
                                   train_frac=0.0, compute_extras=False,
                                   train=True, rng=None)
    data, _ = jlosses.compute_data_loss(batch, renderings, batch.rays, config)
    return (data + jlosses.orientation_loss(batch.rays, 2, hist, config) +
            jlosses.predicted_normal_loss(2, hist, config))
  return loss_fn


@pytest.mark.parametrize('case', sorted(CASES))
def test_plain_stack_trains_like_jax(case):
  elu = case == 'elu'
  bindings = CASES[case] + ['Config.batch_size = 12']
  jconfig, jmodel = _jax_model(bindings, elu)
  params = _init_params(jmodel, seed=1)
  r = _rays_np(12, seed=0)
  rgb = np.random.RandomState(1).uniform(0, 1, (12, 3)).astype(np.float32)
  jbatch = jrays.Batch(rays=_jax_rays(r), rgb=jnp.asarray(rgb))
  loss_fn = _jax_loss_fn(jmodel, jconfig, jbatch)
  jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)

  config, model = _port_model(bindings, elu)
  convert.load_jax_params(model, params)
  batch = rays_lib.Batch(rays=_port_rays(r), rgb=torch.tensor(rgb))
  state = step_lib.create_train_state(config, model)
  loss, _, grads = step_lib.make_train_step(model, config).loss_and_grads(
      state, batch)
  np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
  want = {k: v.numpy() for k, v in
          convert.params_to_state_dict(jax.device_get(jgrads)).items()}
  assert set(grads) == set(want)
  for k, g in grads.items():
    scale = max(float(np.abs(want[k]).max()), 1e-12)
    np.testing.assert_allclose(g.detach().numpy(), want[k], rtol=0,
                               atol=2e-4 * scale, err_msg=k)
  # The heads read the trunk's widened output after a trailing concat.
  if case == 'trailing_concat':
    fin = model.nerf_mlp.spatial_0.in_features
    assert model.nerf_mlp.raw_density.in_features == 32 + fin


@pytest.mark.parametrize('deg', [4, 16])
def test_plain_ipe_matches_jax(deg):
  # The plain stack's IPE against JAX's coord.integrated_pos_enc at the tiny
  # gin's degree and the flagship's (max_deg_point 16). At 16 the fused
  # trunks' encode_ipe (cos(m) for sin(m + pi/2)) would miss JAX by far more
  # than the served 1e-4, which is why the plain stack has its own form.
  from refnerf_tpu.ops import coord as jcoord
  from refnerf_tpu_torch.ops import coord
  rng = np.random.default_rng(deg)
  lm = rng.uniform(-1.5, 1.5, (4096, 21)).astype(np.float32)
  lv = rng.uniform(0, 1e-6, (4096, 21)).astype(np.float32)
  want = np.asarray(jcoord.integrated_pos_enc(jnp.asarray(lm),
                                              jnp.asarray(lv), 0, deg))
  got = coord.integrated_pos_enc(torch.tensor(lm), torch.tensor(lv), 0, deg)
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
  if deg == 16:
    fused = torch.cat(fused_mlp.encode_ipe(
        torch.tensor(lm), torch.tensor(lv), 2.0**np.arange(deg)), -1)
    assert np.abs(fused.numpy() - want).max() > 1e-4


def _pack(depth, kin, width=256, cdt='bfloat16', hf=0):
  ws = [torch.zeros(width, kin if l == 0 else width) for l in range(depth)]
  bs = [torch.zeros(width) for _ in range(depth)]
  head = (torch.zeros(hf, width), torch.zeros(hf)) if hf else None
  return fused_mlp.pack_trunk(ws, bs, (kin,), skip_period=depth + 1,
                              head_f32=head, compute_dtype=cdt)


@pytest.mark.parametrize('depth,kin,cdt,tma', [
    (8, 96, 'bfloat16', True), (8, 224, 'bfloat16', True),
    (8, 256, 'bfloat16', True), (9, 96, 'bfloat16', False),
    (16, 96, 'bfloat16', False), (8, 288, 'bfloat16', False),
    (8, 96, 'float32', False)])
def test_backward_route_by_shape(depth, kin, cdt, tma):
  # The bf16 width-256 backward runs trunk_bwd_tma.cu's kernels within their
  # tensor maps (8 layers) and input tile (256 columns), trunk_bwd.cu's
  # instances past either; every one of these shapes has an instance.
  pack = _pack(depth, kin, cdt=cdt)
  assert fused_mlp.tma_backward(pack) == tma
  assert fused_mlp.missing_instance(pack, 0) is None
  assert fused_mlp.missing_instance(pack, 128) is None


def _library_case(depth, kin, cdt, width, lib, hf=0, dg=False, past=None,
                  id=None):
  return pytest.param(depth, kin, cdt, width, lib, hf, dg, past,
                      id=id or f'{depth}-{kin}-{cdt}-{width}-{lib}')


@pytest.mark.parametrize('depth,kin,cdt,width,lib,hf,dg,past', [
    _library_case(8, 96, 'float32', 256, 'trunk_bwd_f32'),
    _library_case(8, 224, 'float32', 256, 'trunk_bwd_f32'),
    _library_case(8, 256, 'float32', 256, 'trunk_bwd_f32'),
    _library_case(9, 96, 'float32', 256, 'trunk_bwd'),
    _library_case(8, 288, 'float32', 256, 'trunk_bwd'),
    # Width 128 within 8 layers and 256 input columns takes the two-tile
    # instances (their ids name the route they had before).
    _library_case(8, 192, 'float32', 128, 'trunk_bwd_f32',
                  id='8-192-float32-128-trunk_bwd'),
    _library_case(8, 96, 'bfloat16', 256, 'trunk_bwd_tma'),
    _library_case(9, 96, 'bfloat16', 256, 'trunk_bwd'),
    _library_case(8, 192, 'bfloat16', 128, 'trunk_bwd_tma',
                  id='8-192-bfloat16-128-trunk_bwd'),
    # Width 128 past those shapes, in f32 past trunk_bwd_f32.cu's shared
    # memory (224 and 256 input columns), and in bf16 below 128 input
    # columns (trunk_bwd_tma.cu keeps the skip layer's zeta in the input
    # tile), stays on trunk_bwd.cu.
    _library_case(9, 192, 'float32', 128, 'trunk_bwd'),
    _library_case(8, 288, 'float32', 128, 'trunk_bwd'),
    _library_case(8, 224, 'float32', 128, 'trunk_bwd'),
    _library_case(8, 256, 'float32', 128, 'trunk_bwd'),
    _library_case(9, 192, 'bfloat16', 128, 'trunk_bwd'),
    _library_case(8, 288, 'bfloat16', 128, 'trunk_bwd'),
    _library_case(8, 256, 'bfloat16', 128, 'trunk_bwd_tma'),
    _library_case(8, 96, 'bfloat16', 128, 'trunk_bwd'),
    _library_case(8, 96, 'float32', 128, 'trunk_bwd_f32'),
    # F5 and its forward twin: trunk_bwd.cu's f32 K5 at 288 input columns
    # needs exactly the 232,448 B of an H100, at 320 more; the f32 K3
    # forward on 224 or 256 input columns fits neither trunk_fwd_f32.cu nor
    # trunk_fwd.cu. bf16 at 320 columns fits trunk_bwd.cu.
    _library_case(8, 288, 'float32', 256, 'trunk_bwd', hf=3,
                  id='F5-f32-K5-288-at-the-limit'),
    _library_case(8, 320, 'float32', 256, 'trunk_bwd', past='trunk_bwd',
                  id='F5-f32-320-past-the-limit'),
    _library_case(8, 320, 'bfloat16', 256, 'trunk_bwd', id='bf16-320'),
    _library_case(8, 224, 'float32', 256, 'trunk_bwd_f32', dg=True,
                  past='trunk_fwd', id='F5-f32-K3-224-forward-past'),
    _library_case(8, 256, 'float32', 256, 'trunk_bwd_f32', dg=True,
                  past='trunk_fwd', id='F5-f32-K3-256-forward-past'),
    _library_case(8, 192, 'float32', 256, 'trunk_bwd_f32', dg=True,
                  id='f32-K3-192')])
def test_backward_library_by_dtype_and_shape(depth, kin, cdt, width, lib, hf,
                                             dg, past):
  # One function picks the backward's library from the dtype and shape
  # alone, with no card: at width 256 or 128 within 8 layers and 256 input
  # columns the wgmma/TMA kernels in bf16 and the FMA/TMA kernels in f32
  # (trunk_bwd_f32.cu; at width 128 up to 192 input columns, where its
  # shared memory holds the trunk); trunks past those shapes trunk_bwd.cu.
  # An instance whose shared memory (fused_mlp.kernel_smem, the C launch's
  # sum) passes the H100's 232,448 B is named by missing_instance, so the
  # trunk runs the plain versions; every other shape has an instance.
  pack = _pack(depth, kin, width, cdt, hf)
  fold = torch.zeros(kin // 2, 3) if dg else None
  assert fused_mlp.backward_library(pack) == lib
  assert fused_mlp.tma_backward(pack) == (lib == 'trunk_bwd_tma')
  why = fused_mlp.missing_instance(pack, 0, fold)
  if past is None:
    assert why is None
  else:
    assert why and why.startswith(f'{past}.cu needs ')
    assert fused_mlp.kernel_smem(past, pack, 0, fold) > fused_mlp.SMEM_LIMIT
  if hf == 3:
    assert fused_mlp.kernel_smem(lib, pack, 0) == fused_mlp.SMEM_LIMIT


def _mip_dir_pack(cdt, kin=161, depth=8):
  """mip-NeRF's directional trunk (configs/blender_mipnerf.gin): width 128,
  `depth` layers with the skip at layer 5, rgb head hf = 3, on `kin` input
  columns ((128, 33) padded to 192 at kin 161)."""
  ws = [torch.zeros(128, kin if l == 0 else 128 + (kin if l == 5 else 0))
        for l in range(depth)]
  bs = [torch.zeros(128) for _ in range(depth)]
  return fused_mlp.pack_trunk(ws, bs, (kin,), skip_period=4,
                              head_f32=(torch.zeros(3, 128), torch.zeros(3)),
                              compute_dtype=cdt)


@pytest.mark.parametrize('kin,cdt,lib,smem', [
    (161, 'float32', 'trunk_bwd_f32', 231560),
    (192, 'float32', 'trunk_bwd_f32', 231560),
    (224, 'float32', 'trunk_bwd', 240264),
    (256, 'float32', 'trunk_bwd', 257160),
    (161, 'bfloat16', 'trunk_bwd_tma', None),
    (256, 'bfloat16', 'trunk_bwd_tma', None)])
def test_width_128_backward_shared_memory(kin, cdt, lib, smem):
  # trunk_bwd_f32.cu's width-128 instance holds two 64-sample tiles a CTA:
  # fused_mlp.kernel_smem mirrors its launch's sum (at mip-NeRF's shape five
  # [16][128] ring stages beside 190,600 B, within SMEM_LIMIT). Past 192
  # input columns no four-stage ring fits beside the tiles, so the f32 trunk
  # stays on trunk_bwd.cu (missing_instance names nothing: that instance
  # runs it); the bf16 instance fits up to 256 columns.
  pack = _mip_dir_pack(cdt, kin)
  assert fused_mlp.backward_library(pack) == lib
  assert fused_mlp.missing_instance(pack, 0) is None
  if smem is not None:
    assert fused_mlp.kernel_smem('trunk_bwd_f32', pack, 0) == smem
    assert (smem <= fused_mlp.SMEM_LIMIT) == (lib == 'trunk_bwd_f32')


@pytest.mark.parametrize('kin,smem', [(161, 231560), (192, 231560),
                                      (224, 232072), (256, 224392)])
def test_width_128_forward_shared_memory(kin, smem):
  # trunk_fwd_f32.cu's width-128 forward holds two 64-sample tiles a CTA as
  # one k-major tile of 128 rows: fused_mlp.kernel_smem mirrors its
  # launch's sum (at mip-NeRF's shape seven [16][128] ring stages beside
  # 174,216 B; at 256 input columns two), within SMEM_LIMIT at every input
  # width the kernel takes, so the f32 width-128 forward never runs plain.
  # The bf16 one fits too (kernel_smem has no sum to check for it).
  pack = _mip_dir_pack('float32', kin)
  assert fused_mlp.forward_library(pack) == 'trunk_fwd_f32'
  assert fused_mlp.kernel_smem('trunk_fwd_f32', pack, 0) == smem
  assert smem <= fused_mlp.SMEM_LIMIT
  assert fused_mlp.missing_instance(pack, 0) is None
  assert fused_mlp.forward_library(_mip_dir_pack('bfloat16', kin)) == \
      'trunk_fwd_tma'


@pytest.mark.parametrize('route,width,rows,cta,rp', [
    ('trunk_bwd_f32', 128, 1000, 128, 1024),
    ('trunk_bwd_f32', 128, 232, 128, 256),
    ('trunk_bwd_tma', 128, 65536, 128, 65536),
    ('trunk_bwd_tma', 128, 64, 128, 128),
    ('trunk_bwd', 128, 1000, 64, 1024),
    ('trunk_bwd', 128, 232, 64, 256),
    ('trunk_bwd_f32', 256, 232, 64, 256),
    ('trunk_bwd_tma', 256, 200, 64, 256),
    ('trunk_bwd_tma', 256, 130, 64, 192)])
def test_backward_scratch_rows_round_to_the_cta(route, width, rows, cta, rp):
  # A slab's scratch rows (and its rows of per-CTA vector partials) round
  # up to whole CTAs: 128 samples on the two-tile width-128 instances, 64
  # elsewhere; the rows past the slab are zero-padded in the kernels.
  assert fused_mlp.bwd_cta_rows(route, width) == cta
  assert fused_mlp.bwd_scratch_rows(route, width, rows) == rp


@pytest.mark.parametrize('width,rows', [(256, 65536), (128, 262144),
                                        (1024, 131072)])
def test_backward_slab_rows(width, rows):
  # A backward slab's default rows: BWD_SLAB at width 256, four times that
  # at 128 (N = 524,288 samples in two slabs, not eight), twice that at
  # 1024 (four slabs); a whole number of 128-row CTAs either way.
  assert fused_mlp.bwd_slab_rows(width) == rows
  assert rows % 128 == 0 and rows >= fused_mlp.BWD_SLAB


@pytest.mark.parametrize('route', ['trunk_bwd_f32', 'trunk_bwd_tma'])
@pytest.mark.parametrize('n', [128, 192, 320])
def test_width_128_weight_gradient_splits(n, route):
  # The width-128 gradients (m = 128 rows against K_l = 128, 192, 320) in
  # either dtype: one to three 128 x 128 tiles, as many splits as fill 132
  # SMs once, each a whole number of TMA stages (64 samples for the bf16
  # product) covering the rows. The width-256 bf16 gradients keep their
  # fixed split.
  tiles = -(-n // 128)
  for rp in (128, 1024, 65536):
    ks = fused_mlp._wgrad_split(route, rp, 128, n, 132)
    nsplit = -(-rp // ks)
    assert ks % 64 == 0 and nsplit * ks >= rp and nsplit * tiles <= 132
    if rp == 65536:
      assert nsplit * tiles > 66
  assert fused_mlp._wgrad_split('trunk_bwd_tma', 65536, 256, n, 132) == \
      fused_mlp._KSPLIT_TMA
  # The width-256 bf16 trunk's 128-row gradient (K4's compute-dtype head)
  # keeps the fixed split: its caller gives no SM count.
  assert fused_mlp._wgrad_split('trunk_bwd_tma', 65536, 128, n, 0) == \
      fused_mlp._KSPLIT_TMA


@pytest.mark.parametrize('sms', [132, 114, 1])
def test_f32_weight_gradient_splits_fill_the_card(sms):
  # trunk_bwd_f32.cu's weight-gradient product: the 128 x 128 output tiles
  # times the splits of the samples never outnumber the SMs (one CTA an
  # SM) and fill them once when there are samples enough; each split is a
  # whole number of TMA stages (32 samples) and covers the rows.
  for rp in (64, 1024, 8448, 65536):
    for m, n in ((256, 96), (256, 256), (256, 352), (128, 256)):
      ks = fused_mlp._wgrad_split('trunk_bwd_f32', rp, m, n, sms)
      tiles = -(-m // 128) * -(-n // 128)
      nsplit = -(-rp // ks)
      assert ks % 64 == 0 and nsplit * ks >= rp and nsplit <= max(1, sms)
      assert nsplit * tiles <= max(sms, tiles)
      if rp == 65536 and tiles <= sms:
        assert nsplit * tiles > sms // 2
  assert fused_mlp._wgrad_split('trunk_bwd_tma', 65536, 256, 256, sms) == \
      fused_mlp._KSPLIT_TMA
  assert fused_mlp._wgrad_split('trunk_bwd', 65536, 256, 256, sms) == \
      fused_mlp._KSPLIT


@pytest.mark.parametrize('depth,kin,cdt,width,tma', [
    (8, 96, 'bfloat16', 256, True), (8, 224, 'bfloat16', 256, True),
    (8, 256, 'bfloat16', 256, True), (9, 96, 'bfloat16', 256, False),
    (16, 96, 'bfloat16', 256, False), (8, 288, 'bfloat16', 256, False),
    (8, 96, 'float32', 256, False), (8, 192, 'bfloat16', 128, True),
    (8, 192, 'float32', 128, False), (9, 192, 'bfloat16', 128, False),
    (8, 288, 'bfloat16', 128, False)])
def test_forward_route_by_shape(depth, kin, cdt, width, tma):
  # The bf16 forward at width 256 or 128 runs trunk_fwd_tma.cu's kernel
  # within its tensor maps (8 layers) and input tile (256 columns),
  # trunk_fwd.cu's instances past either and in f32; every one of these
  # shapes has an instance, so none runs the plain versions. K11 (y out)
  # takes trunk_fwd_tma.cu at width 256 within those shapes.
  pack = _pack(depth, kin, width, cdt)
  assert fused_mlp.tma_forward(pack) == tma
  assert fused_mlp.tma_forward(pack, out_y=True) == (tma and width == 256)
  assert fused_mlp.missing_instance(pack, 0) is None
  if width == 256:
    assert fused_mlp.missing_instance(pack, 128) is None


@pytest.mark.parametrize('depth,kin,cdt,width,out_y,dg,lib', [
    (8, 96, 'float32', 256, False, False, 'trunk_fwd_f32'),
    (8, 201, 'float32', 256, False, False, 'trunk_fwd_f32'),
    (8, 256, 'float32', 256, False, False, 'trunk_fwd_f32'),
    (8, 288, 'float32', 256, False, False, 'trunk_fwd'),
    (9, 96, 'float32', 256, False, False, 'trunk_fwd'),
    (8, 96, 'float32', 256, True, False, 'trunk_fwd'),
    (8, 201, 'float32', 128, False, False, 'trunk_fwd_f32'),
    (8, 256, 'float32', 128, False, False, 'trunk_fwd_f32'),
    (9, 201, 'float32', 128, False, False, 'trunk_fwd'),
    (8, 288, 'float32', 128, False, False, 'trunk_fwd'),
    (8, 96, 'float32', 256, False, True, 'trunk_fwd_f32'),
    (8, 192, 'float32', 256, False, True, 'trunk_fwd_f32'),
    (8, 256, 'float32', 256, False, True, 'trunk_fwd'),
    (8, 96, 'bfloat16', 256, False, False, 'trunk_fwd_tma'),
    (8, 201, 'bfloat16', 256, False, False, 'trunk_fwd_tma'),
    (8, 256, 'bfloat16', 256, False, True, 'trunk_fwd_tma'),
    (8, 288, 'bfloat16', 256, False, False, 'trunk_fwd'),
    (9, 96, 'bfloat16', 256, False, False, 'trunk_fwd'),
    (8, 96, 'bfloat16', 256, True, False, 'trunk_fwd_tma'),
    (9, 96, 'bfloat16', 256, True, False, 'trunk_fwd'),
    (8, 288, 'bfloat16', 256, True, False, 'trunk_fwd'),
    (8, 201, 'bfloat16', 128, False, False, 'trunk_fwd_tma'),
    (9, 201, 'bfloat16', 128, False, False, 'trunk_fwd'),
    (8, 288, 'bfloat16', 128, False, False, 'trunk_fwd')])
def test_forward_library_by_dtype_and_shape(depth, kin, cdt, width, out_y, dg,
                                            lib):
  # One function picks the forward's library from the dtype, shape and
  # modes alone, with no card: at width 256 or 128 within 8 layers and 256
  # input columns, the wgmma/TMA kernel in bf16 (K11's y too, at width 256)
  # and, without K11's y, the FMA/TMA kernel in f32 (trunk_fwd_f32.cu)
  # where its shared memory holds the trunk (K3: at most 192 input
  # columns); the rest trunk_fwd.cu. tma_forward agrees with it.
  pack = _pack(depth, kin, width, cdt)
  fold = torch.zeros(kin // 2, 3) if dg else None
  assert fused_mlp.forward_library(pack, out_y, fold) == lib
  assert fused_mlp.tma_forward(pack, out_y) == (lib == 'trunk_fwd_tma')
  if lib == 'trunk_fwd_f32':
    assert (fused_mlp.kernel_smem(lib, pack, 0, fold) <=
            fused_mlp.SMEM_LIMIT)


def _pack_weights(pack):
  """A TrunkPack's layers and biases as trunk_reference takes them (each
  layer without the zero columns that pad its segments to kin)."""
  fin, W = sum(pack.seg_dims), pack.width
  ws, off = [], 0
  for l, k in enumerate(pack.k_dims()):
    w = pack.w[off:off + W * k].reshape(W, k)
    off += W * k
    ws.append(w[:, :fin] if l == 0 else w[:, :W + fin] if l == pack.skip
              else w)
  return ws, list(pack.b)


@pytest.mark.parametrize('flags', ['none', 'all six'])
def test_served_flagship_trunks_take_the_tma_forward(monkeypatch, flags):
  # The flagship in bf16, served with use_kernel stubbed as on a card: every
  # trunk launch (the proposal and NeRF spatial trunks, the directional
  # trunk; with all six fuse flags K6-K10 in them) goes to trunk_fwd_tma.cu.
  # The stubbed kernel records the route and answers with trunk_reference
  # on the pack's own weights.
  routes = []

  def kernel(segs, pack, fold=None, dir_modes=None, rgbx=None,
             spa_modes=None, comp=None, out_y=False):
    routes.append((pack.seg_dims, fused_mlp.tma_forward(pack, out_y)))
    ws, bs = _pack_weights(pack)
    head = lambda w, b: None if w is None else (w, b)
    return fused_mlp.trunk_reference(
        segs, ws, bs, skip_period=pack.skip - 1 if pack.skip > 0 else 99,
        wd=pack.wd, head_f32=head(pack.wh, pack.bh),
        head_cdt=head(pack.wc, pack.bc), compute_dtype=pack.compute_dtype,
        density_grad=fold is not None, fold=fold, dir_modes=dir_modes,
        rgbx=rgbx, spa_modes=spa_modes, comp=comp, out_y=out_y)

  monkeypatch.setattr(fused_mlp, 'use_kernel',
                      lambda x, mode: fused_mlp.MODES.index(mode) < 2)
  monkeypatch.setattr(fused_mlp, 'trunk_plain', kernel)
  six = [f'NerfMLP.{f} = True' for f in (
      'fuse_dir_enc', 'fuse_dir_geo', 'fuse_dir_rgb', 'fuse_ipe_trig',
      'fuse_compositing', 'fuse_lift')] if flags == 'all six' else []
  config, model = _port_model(["NerfMLP.compute_dtype = 'bfloat16'"] + six,
                              False)
  with torch.no_grad():
    out, _ = model(_port_rays(_rays_np(2, seed=7)))
  assert torch.isfinite(out[-1]['rgb']).all()
  kinds = {dims for dims, _ in routes}
  assert (48, 48) in kinds and len(kinds) >= 2, kinds
  assert routes and all(tma for _, tma in routes), routes


@pytest.mark.parametrize('case', ['served none', 'served all six',
                                  'trained all six'])
def test_f32_flagship_trunks_take_the_f32_forward(monkeypatch, case):
  # The flagship in its own float32, served and (train=True: the density
  # gradient, K3) trained with use_kernel stubbed as on a card: every trunk
  # launch (the spatial trunks, the directional trunk; with all six fuse
  # flags K6-K10 in them) goes to trunk_fwd_f32.cu. The stubbed kernel
  # records the route and answers with trunk_reference on the pack's own
  # weights.
  routes = []

  def kernel(segs, pack, fold=None, dir_modes=None, rgbx=None,
             spa_modes=None, comp=None, out_y=False):
    routes.append((pack.seg_dims, fold is not None, fused_mlp.forward_library(
        pack, out_y, fold, spa_modes or fused_mlp.SpaModes())))
    ws, bs = _pack_weights(pack)
    head = lambda w, b: None if w is None else (w, b)
    return fused_mlp.trunk_reference(
        segs, ws, bs, skip_period=pack.skip - 1 if pack.skip > 0 else 99,
        wd=pack.wd, head_f32=head(pack.wh, pack.bh),
        head_cdt=head(pack.wc, pack.bc), compute_dtype=pack.compute_dtype,
        density_grad=fold is not None, fold=fold, dir_modes=dir_modes,
        rgbx=rgbx, spa_modes=spa_modes, comp=comp, out_y=out_y)

  monkeypatch.setattr(fused_mlp, 'use_kernel',
                      lambda x, mode: fused_mlp.MODES.index(mode) < 2)
  monkeypatch.setattr(fused_mlp, 'trunk_plain', kernel)
  six = [f'NerfMLP.{f} = True' for f in (
      'fuse_dir_enc', 'fuse_dir_geo', 'fuse_dir_rgb', 'fuse_ipe_trig',
      'fuse_compositing', 'fuse_lift')] if 'six' in case else []
  config, model = _port_model(six, False)
  assert model.nerf_mlp.cfg.compute_dtype == 'float32'
  train = case.startswith('trained')
  with torch.set_grad_enabled(train):
    out, _ = model(_port_rays(_rays_np(2, seed=7)), train=train)
  assert torch.isfinite(out[-1]['rgb']).all()
  kinds = {dims for dims, _, _ in routes}
  assert (48, 48) in kinds and len(kinds) >= 2, kinds
  assert any(dg for _, dg, _ in routes) == train, routes
  assert routes and all(lib == 'trunk_fwd_f32' for _, _, lib in routes), routes


MIP_GIN = os.path.join(REPO, 'configs', 'blender_mipnerf.gin')


@pytest.mark.parametrize('case,libs', [
    ('float32 served', {'trunk_fwd_f32'}),
    ('float32 trained', {'trunk_fwd_f32'}),
    ('bfloat16 served', {'trunk_fwd_tma'}),
    ('bfloat16 trained', {'trunk_fwd_tma'}),
    ('bfloat16 served no viewdirs', {'trunk_fwd_tma'}),
    ('float32 served no viewdirs', {'trunk_fwd'})])
def test_mipnerf_trunks_take_the_new_forwards(monkeypatch, case, libs):
  # configs/blender_mipnerf.gin at full width, served and trained with
  # use_kernel stubbed as on a card: as shipped every trunk launch (the
  # spatial trunk with its bottleneck, the 128-wide directional trunk) goes
  # to trunk_fwd_f32.cu in its own float32 and to trunk_fwd_tma.cu in
  # bf16; without view directions the spatial trunk's launch with y out
  # (K11) goes to trunk_fwd_tma.cu in bf16 and stays on trunk_fwd.cu in
  # f32. The stubbed kernel records the route and answers with
  # trunk_reference on the pack's own weights.
  routes = []

  def kernel(segs, pack, fold=None, dir_modes=None, rgbx=None,
             spa_modes=None, comp=None, out_y=False):
    routes.append((pack.width, out_y, fused_mlp.forward_library(
        pack, out_y, fold, spa_modes or fused_mlp.SpaModes())))
    ws, bs = _pack_weights(pack)
    head = lambda w, b: None if w is None else (w, b)
    return fused_mlp.trunk_reference(
        segs, ws, bs, skip_period=pack.skip - 1 if pack.skip > 0 else 99,
        wd=pack.wd, head_f32=head(pack.wh, pack.bh),
        head_cdt=head(pack.wc, pack.bc), compute_dtype=pack.compute_dtype,
        density_grad=fold is not None, fold=fold, dir_modes=dir_modes,
        rgbx=rgbx, spa_modes=spa_modes, comp=comp, out_y=out_y)

  monkeypatch.setattr(fused_mlp, 'use_kernel',
                      lambda x, mode: fused_mlp.MODES.index(mode) < 2)
  monkeypatch.setattr(fused_mlp, 'trunk_plain', kernel)
  cdt, run, *rest = case.split()
  viewdirs = not rest
  config, gin = configs.parse(
      [MIP_GIN], [f"NerfMLP.compute_dtype = '{cdt}'"] +
      ([] if viewdirs else ['Model.use_viewdirs = False']))
  model = construct.construct_model(config, gin, 'cpu')
  assert model.nerf_mlp.cfg.compute_dtype == cdt
  train = run == 'trained'
  with torch.set_grad_enabled(train):
    out, _ = model(_port_rays(_rays_np(2, seed=7)), train=train)
  assert torch.isfinite(out[-1]['rgb']).all()
  assert {(w, y) for w, y, _ in routes} == (
      {(256, False), (128, False)} if viewdirs else {(256, True)}), routes
  assert {lib for _, _, lib in routes} == libs, routes


def _stub_kernels(monkeypatch):
  """use_kernel as on a card: every mode but 'off' asks for the kernels."""
  monkeypatch.setattr(fused_mlp, 'use_kernel',
                      lambda x, mode: fused_mlp.MODES.index(mode) < 2)
  monkeypatch.setattr(mlp_lib, '_FALLBACK_WARNED', set())
  monkeypatch.setattr(fused_mlp, '_NO_INSTANCE_LOGGED', set())


def _tiny(mode, extra=()):
  return _port_model(TINY + [f"NerfMLP.fused_trunk = '{mode}'", *extra],
                     False)[1]


def test_shape_without_instance_runs_plain_under_auto(monkeypatch, caplog):
  _stub_kernels(monkeypatch)
  r = _rays_np(6, seed=3)
  off = _tiny('off')
  auto = _tiny('auto')
  auto.load_state_dict(off.state_dict())
  with torch.no_grad():
    want, _ = off(_port_rays(r))
    with caplog.at_level(logging.WARNING):
      got, _ = auto(_port_rays(r))
      got2, _ = auto(_port_rays(r))
  for k in ('rgb', 'acc', 'distance'):
    assert torch.equal(got[-1][k], want[-1][k])
    assert torch.equal(got2[-1][k], want[-1][k])
  hits = [m.getMessage() for m in caplog.records
          if 'no kernel instance' in m.getMessage()]
  # One line per trunk shape (spatial, directional), each logged once.
  assert len(hits) == len(set(hits)) == 2
  assert all('width 16' in h for h in hits)


def test_shape_without_instance_raises_under_on(monkeypatch):
  _stub_kernels(monkeypatch)
  model = _tiny('on')
  with torch.no_grad(), pytest.raises(NotImplementedError, match='width 16'):
    model(_port_rays(_rays_np(4, seed=4)))


def test_plain_stack_logged_once_where_kernels_would_run(monkeypatch, caplog):
  _stub_kernels(monkeypatch)
  model = _tiny('on', ["NerfMLP.net_activation = 'elu'"])
  with torch.no_grad(), caplog.at_level(logging.WARNING):
    model(_port_rays(_rays_np(4, seed=5)))
    model(_port_rays(_rays_np(4, seed=6)))
  hits = [m.getMessage() for m in caplog.records
          if 'non-relu net_activation' in m.getMessage()]
  assert len(hits) == 1 and 'elu' in hits[0]
  # Not on the plain path ('off'): the kernels would not have run there.
  monkeypatch.setattr(mlp_lib, '_FALLBACK_WARNED', set())
  caplog.clear()
  model = _tiny('off', ["NerfMLP.net_activation = 'elu'"])
  with torch.no_grad(), caplog.at_level(logging.WARNING):
    model(_port_rays(_rays_np(4, seed=5)))
  assert not [m for m in caplog.records
              if 'non-relu' in m.getMessage()]


def _past_smem_trunk(case):
  """A width-256 f32 trunk past its libraries' shared memory, on 64 rows:
  'bwd kin 320' the directional trunk on 320 input columns (trunk_bwd.cu,
  F5), 'fwd K3 kin 256' the spatial trunk on 256 with the density gradient
  (trunk_fwd.cu). Returns run(mode) -> the outputs and, for the
  directional trunk, the gradients of its weights."""
  gen = torch.Generator().manual_seed(31)
  rand = lambda *s: torch.randn(*s, generator=gen)
  fin = 320 if case.startswith('bwd') else 256
  ws = [rand(256, fin if l == 0 else 256 + (fin if l == 5 else 0)) * 0.05
        for l in range(8)]
  bs = [rand(256) * 0.05 for _ in range(8)]
  if case.startswith('bwd'):
    segs = [rand(64, 128), rand(64, 192)]
    head = (rand(3, 256) * 0.05, rand(3))

    def run(mode):
      w = [t.clone().requires_grad_() for t in ws]
      out = fused_mlp.fused_trunk(segs, w, bs, head, compute_dtype='float32',
                                  mode=mode)
      out.sum().backward()
      return [out.detach()] + [t.grad for t in w]
    return run
  lm, lv = torch.rand(64, 4, generator=gen), torch.rand(64, 4, generator=gen)
  scales = 2.0**(np.arange(32) % 16)
  wd, head = rand(1, 256) * 0.05, (rand(128, 256) * 0.05, rand(128))
  return lambda mode: fused_mlp.fused_encoded_trunk(
      lm, lv, scales, ws, bs, wd, density_grad=True, head_cdt=head,
      compute_dtype='float32', mode=mode)


@pytest.mark.parametrize('case', ['bwd kin 320', 'fwd K3 kin 256'])
def test_trunk_past_shared_memory_runs_plain_under_auto(monkeypatch, caplog,
                                                        case):
  # F5 and its forward twin, with use_kernel stubbed as on a card: under
  # fused_trunk='auto' the trunk runs the plain versions (no kernel is
  # called) and matches 'off', logged once with the library and the bytes
  # it needs; under 'on' it raises NotImplementedError before any launch.
  _stub_kernels(monkeypatch)

  def no_launch(*a, **k):
    raise AssertionError('a kernel was launched')

  monkeypatch.setattr(fused_mlp, 'trunk_kernel', no_launch)
  monkeypatch.setattr(fused_mlp, 'trunk_plain', no_launch)
  monkeypatch.setattr(fused_mlp, 'trunk_backward_kernel', no_launch)
  run = _past_smem_trunk(case)
  want = run('off')
  with caplog.at_level(logging.WARNING):
    got, got2 = run('auto'), run('auto')
  for a, b, c in zip(got, got2, want):
    assert torch.equal(a, c) and torch.equal(b, c)
  hits = [m.getMessage() for m in caplog.records
          if 'no kernel instance' in m.getMessage()]
  lib = 'trunk_bwd.cu' if case.startswith('bwd') else 'trunk_fwd.cu'
  assert len(hits) == 1 and f'{lib} needs' in hits[0], hits
  assert 'past the 232448 B' in hits[0]
  with pytest.raises(NotImplementedError, match=lib):
    run('on')
