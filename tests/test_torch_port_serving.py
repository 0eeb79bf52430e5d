"""The port's serving artifact (refnerf_tpu_torch/serving.py) against the JAX
package's (refnerf_tpu/serving.py), and the trunk forward as an operator.

- Parity: JAX's `_TINY` model of tests/test_serving.py, its seeded
  parameters carried into the port by `convert.load_jax_params`, is
  exported by both packages on the CPU (JAX's `platforms=('cpu',)`); the
  loaded artifacts serve the same rays, and every buffer agrees within
  1e-5 (float32: the same arithmetic in another summation order; JAX builds
  the IPE cosine as sin(m + pi/2), which at `_TINY`'s three degrees stays
  within that). Their metadata name the same buffers and shapes.
- JAX's six cases for the port's artifact: the round trip, `serve_image`'s
  padding, the wrong chunk, a bad magic, the extras' buffers, near/far and
  the truncation errors; and each package's loader refuses the other's
  artifact, and a CUDA artifact on a host without a card.
- The `trunk_forward` operator (`fused_mlp.launch_trunk`), in every forward
  mode (K1, K2, K3, K6-K11) at a tiny width in bf16: its CPU
  implementation equals `trunk_reference` bit for bit and counts no
  launch, its CUDA implementation (trunk_kernel stubbed) counts one launch
  under the kernel's key and the mode's, its fake kernel gives the same
  shapes and dtypes, and `torch.library.opcheck` passes.
- The flagship at its widths (few samples) with the six fuse flags,
  exported with `fused_mlp.use_kernel` stubbed as on a card: the graph
  holds the operator twice for each trunk (K1, K2) on trunk_fwd_f32.cu's
  route, a request of the loaded artifact runs the operator as K1, K2 and
  K6-K10 twice each (recorded by a stub of its CPU implementation, which
  stands in for the kernel), and it equals the model's `fused_trunk='off'` render bit for bit
  (which the round trip holds the plain artifact to).
- The export tool from a checkpoint (tools/export_serving.py).
"""

import collections
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import _pytree as pytree

from refnerf_tpu import serving as jserving
from refnerf_tpu_torch import configs
from refnerf_tpu_torch import convert
from refnerf_tpu_torch import serving
from refnerf_tpu_torch.cameras import rays as rays_lib
from refnerf_tpu_torch.models import construct
from refnerf_tpu_torch.ops import fused_mlp
from tests import test_serving as jtests

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GIN = os.path.join(REPO, 'configs', 'blender_refnerf.gin')
CHUNK = jtests.CHUNK
TOL = 1e-5


@pytest.fixture(scope='module')
def jax_pair():
  """JAX's tiny model and parameters, and the port's on the same weights."""
  jmodel, params = jtests._model_and_params()
  config, gin = configs.parse(None, [jtests._TINY])
  model = construct.construct_model(config, gin, 'cpu')
  convert.load_jax_params(model, jax.device_get(params))
  return jmodel, params, model


@pytest.fixture(scope='module')
def artifact(jax_pair, tmp_path_factory):
  """The port's artifact of the pair (near/far recorded), and JAX's."""
  root = tmp_path_factory.mktemp('srv')
  path, jpath = str(root / 'scene.rnsrv'), str(root / 'jax.rnsrv')
  meta = serving.export_serving(jax_pair[2], path, chunk=CHUNK, device='cpu',
                                near=2.0, far=6.0)
  jmeta = jserving.export_serving(jax_pair[0], jax_pair[1], jpath,
                                  chunk=CHUNK, platforms=('cpu',))
  return path, meta, jpath, jmeta


@pytest.fixture(scope='module')
def served(artifact):
  return serving.load_serving(artifact[0])


def _port_rays(jrays):
  """The port's Rays of a JAX bundle (numpy in between)."""
  return rays_lib.Rays(**{
      f.name: torch.from_numpy(np.array(getattr(jrays, f.name)))
      for f in dataclasses.fields(rays_lib.Rays)})


def test_port_artifact_serves_what_the_jax_artifact_serves(artifact, served):
  path, meta, jpath, jmeta = artifact
  assert meta['buffers'] == jmeta['buffers']
  assert meta['platforms'] == ['cpu'] and meta['trunk_ops'] == {}
  rays = jtests._rays(CHUNK, seed=5)
  want = jserving.load_serving(jpath)(rays)
  got = served(_port_rays(rays))
  assert set(got) == set(want)
  for k in want:
    np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                               rtol=TOL, atol=TOL, err_msg=k)


def test_roundtrip_matches_model(jax_pair, artifact, served):
  model = jax_pair[2]
  meta = artifact[1]
  assert meta['chunk'] == CHUNK and 'rgb' in meta['buffers']
  assert served.meta == meta
  rays = _port_rays(jtests._rays(CHUNK))
  got = served(rays)
  with torch.no_grad():
    want = serving.serving_render_fn(model)(rays)
  assert set(got) == set(want)
  for k in want:
    assert torch.equal(got[k], want[k]), k


def test_serve_image_pads_and_reshapes(jax_pair, served):
  h, w = 3, 5  # 15 rays: not a multiple of the chunk -> padding path
  flat = _port_rays(jtests._rays(h * w, seed=4))
  out = served.serve_image(flat.reshape(h, w))
  assert out['rgb'].shape == (h, w, 3) and isinstance(out['rgb'], np.ndarray)
  with torch.no_grad():
    want = serving.serving_render_fn(jax_pair[2])(
        rays_lib.pad_rays_to(flat, 2 * CHUNK)[0])
  np.testing.assert_array_equal(out['rgb'].reshape(-1, 3),
                                want['rgb'][:h * w].numpy())


def test_wrong_chunk_size_is_loud(served):
  with pytest.raises(ValueError, match='exactly'):
    served(_port_rays(jtests._rays(CHUNK + 1)))


@pytest.mark.parametrize('writer', ['garbage', 'jax', 'port'])
def test_bad_magic_and_the_other_packages_artifact_are_loud(
    artifact, tmp_path, writer):
  path = tmp_path / 'other.rnsrv'
  if writer == 'garbage':
    path.write_bytes(b'GARBAGE!' + b'\x00' * 16)
    loader, match = serving.load_serving, 'bad magic'
  elif writer == 'jax':
    path.write_bytes(open(artifact[2], 'rb').read())
    loader, match = serving.load_serving, 'JAX artifact'
  else:
    path.write_bytes(open(artifact[0], 'rb').read())
    loader, match = jserving.load_serving, 'bad magic'
  with pytest.raises(ValueError, match=match) as e:
    loader(str(path))
  assert str(path) in str(e.value)


def test_extras_export_carries_buffers(jax_pair, tmp_path):
  path = str(tmp_path / 'scene.rnsrv')
  meta = serving.export_serving(jax_pair[2], path, chunk=CHUNK, device='cpu',
                                compute_extras=True)
  assert 'distance_mean' in meta['buffers']
  got = serving.load_serving(path)(_port_rays(jtests._rays(CHUNK)))
  assert set(got) == set(meta['buffers'])
  for k, (shape, dtype) in meta['buffers'].items():
    assert list(got[k].shape) == shape and str(got[k].dtype) == f'torch.{dtype}'


def test_metadata_near_far_and_truncation_errors(artifact, tmp_path):
  """near/far land in the artifact metadata, and every malformed artifact
  is a ValueError; a CUDA artifact on a host without a card raises."""
  path, meta = artifact[:2]
  assert meta['near'] == 2.0 and meta['far'] == 6.0

  data = open(path, 'rb').read()
  hlen = int.from_bytes(data[8:12], 'little')
  cases = {
      'no metadata length': data[:10],
      'metadata:': data[:12 + hlen // 2],
      'corrupt metadata': data[:8] + data[8:12] + b'x' * hlen + data[
          12 + hlen:],
      'no program payload': data[:12 + hlen],
      'corrupt program payload': data[:12 + hlen] + b'not a zip archive',
  }
  for msg, blob in cases.items():
    p = tmp_path / 'bad.rnsrv'
    p.write_bytes(blob)
    with pytest.raises(ValueError, match=msg.split(':')[0]):
      serving.load_serving(str(p))

  header = json.dumps({**meta, 'platforms': ['cuda']}).encode()
  p = tmp_path / 'cuda.rnsrv'
  p.write_bytes(data[:8] + len(header).to_bytes(4, 'little') + header +
                data[12 + hlen:])
  if not torch.cuda.is_available():
    with pytest.raises(RuntimeError, match='exported for cuda'):
      serving.load_serving(str(p))


# ---------------------------------------------------- the trunk operator

W, NB, SCALES, N, S = 32, 3, (1.0, 2.0), 16, 4


def _layers(gen, dims, depth=4, skip_period=2, hf=None, hc=None, wd=False):
  fin = sum(dims)
  skips = fused_mlp.skip_input_layers(depth, skip_period)
  r = lambda *s: torch.randn(*s, generator=gen) * 0.3
  ws = [r(W, fin if l == 0 else W + (fin if l in skips else 0))
        for l in range(depth)]
  bs = [r(W) for _ in range(depth)]
  return ws, bs, dict(
      skip_period=skip_period, wd=r(1, W) if wd else None,
      head_f32=(r(hf, W), r(hf)) if hf else None,
      head_cdt=(r(hc, W), r(hc)) if hc else None)


def _op_case(mode):
  """(segs, weights, biases, trunk_reference keywords) of a forward mode."""
  gen = torch.Generator().manual_seed(OP_MODES.index(mode))
  f32 = lambda *s: torch.randn(*s, generator=gen)
  lm, lv = f32(N, NB), f32(N, NB).abs() * 0.1
  f = NB * len(SCALES)
  spatial = mode in ('K1', 'K3', 'K6', 'K7', 'K11')
  if spatial:
    ws, bs, kw = _layers(gen, (f, f), hf=4, hc=None if mode == 'K11' else 8,
                         wd=True)
    segs = (list(fused_mlp.encode_ipe(lm, lv, SCALES, 'bfloat16'))
            if mode != 'K7' else [lm, lv])
    if mode == 'K3':
      kw['fold'] = torch.as_tensor(fused_mlp.ipe_scale_fold(SCALES, NB))
      kw['density_grad'] = True
    if mode == 'K6':
      kw['spa_modes'] = fused_mlp.SpaModes((), S)
      kw['comp'] = (f32(N).abs(), f32(1))
    if mode == 'K7':
      kw['spa_modes'] = fused_mlp.SpaModes(SCALES, 0)
    if mode == 'K11':
      kw['out_y'] = True
    return segs, ws, bs, kw, (f, f)
  b = f32(N, 8).to(torch.bfloat16)
  dm = fused_mlp.DirModes()
  segs = [b, f32(N, 10)]
  if mode in ('K8', 'K9'):
    dm = fused_mlp.DirModes(2, 1, mode == 'K9')
    segs = [b, f32(N, 3)] + ([f32(N, 3)] if mode == 'K9' else []) + [
        f32(N, 1).abs()]
  if mode == 'K10':
    dm = dm._replace(rgbe=(1.0, 0.0, 0.001))
  dims = fused_mlp.visible_dims(segs, dm)
  ws, bs, kw = _layers(gen, dims, hf=3)
  kw['dir_modes'] = dm
  if mode == 'K10':
    kw['rgbx'] = (f32(N, 3), f32(N, 3))
  return segs, ws, bs, kw, dims


def _launch_args(mode):
  segs, ws, bs, kw, dims = _op_case(mode)
  pack = fused_mlp.pack_trunk(
      ws, bs, dims, skip_period=kw['skip_period'], wd=kw['wd'],
      head_f32=kw['head_f32'], head_cdt=kw['head_cdt'],
      compute_dtype='bfloat16')
  op_kw = {k: kw.get(k) for k in ('fold', 'dir_modes', 'rgbx', 'spa_modes',
                                  'comp')}
  op_kw['out_y'] = kw.get('out_y', False)
  return segs, ws, bs, kw, pack, op_kw


OP_MODES = ['K1', 'K2', 'K3', 'K6', 'K7', 'K8', 'K9', 'K10', 'K11']


@pytest.mark.parametrize('mode', OP_MODES)
def test_trunk_operator_matches_reference_and_its_fake_kernel(monkeypatch,
                                                             mode):
  segs, ws, bs, kw, pack, op_kw = _launch_args(mode)
  want = fused_mlp.trunk_reference(segs, ws, bs, compute_dtype='bfloat16',
                                   **kw)
  counted = lambda before: {k: v - before[k] for k, v in
                            fused_mlp.launches.items() if v != before[k]}
  before = dict(fused_mlp.launches)
  got = fused_mlp.launch_trunk(segs, pack, **op_kw)
  assert counted(before) == {}  # the CPU implementation launches nothing
  assert len(got) == len(want)
  for g, w in zip(got, want):
    assert torch.equal(g, w)
  args = fused_mlp._op_args(segs, pack, op_kw['fold'], op_kw['dir_modes'],
                            op_kw['rgbx'], op_kw['spa_modes'], op_kw['comp'],
                            op_kw['out_y'])
  # The CUDA implementation counts where trunk_kernel returns.
  monkeypatch.setattr(fused_mlp, 'trunk_kernel', fused_mlp.trunk_plain)
  before = dict(fused_mlp.launches)
  fused_mlp._trunk_forward_cuda(*args)
  which = {'K2': 'K2', 'K8': 'K2', 'K9': 'K2', 'K10': 'K2', 'K3': 'K3'}.get(
      mode, 'K1')
  got = counted(before)
  assert got.get(which) == 1 and got.get(mode) == 1, got
  with FakeTensorMode() as fake_mode:
    fake = fused_mlp.trunk_forward(*pytree.tree_map_only(
        torch.Tensor, fake_mode.from_tensor, args))
  assert [(tuple(t.shape), t.dtype) for t in fake] == [
      (tuple(t.shape), t.dtype) for t in want]
  torch.library.opcheck(fused_mlp.trunk_forward, args)


def test_unpack_trunk_inverts_the_pack():
  segs, ws, bs, kw, pack, _ = _launch_args('K9')
  got_ws, got_bs, got_kw = fused_mlp.unpack_trunk(pack)
  assert got_kw['skip_period'] == kw['skip_period']
  for g, w in zip(got_ws + got_bs, ws + bs):
    assert torch.equal(g, w.to(torch.bfloat16))


# ---------------------------------------- the flagship through the operator

SMALL = ['NerfMLP.net_depth = 4', 'NerfMLP.net_width = 32',
         'NerfMLP.net_depth_viewdirs = 4', 'NerfMLP.net_width_viewdirs = 32',
         'NerfMLP.skip_layer = 2', 'NerfMLP.bottleneck_width = 16',
         'Model.num_prop_samples = 16', 'Model.num_nerf_samples = 16']
SIX = [f'NerfMLP.{f} = True' for f in (
    'fuse_dir_enc', 'fuse_dir_geo', 'fuse_dir_rgb', 'fuse_ipe_trig',
    'fuse_compositing', 'fuse_lift')]


def test_export_through_the_operator_equals_the_plain_export(monkeypatch,
                                                             tmp_path):
  # The flagship's widths (its trunks have kernel instances), few samples.
  monkeypatch.setattr(fused_mlp, 'use_kernel',
                      lambda x, mode: fused_mlp.MODES.index(mode) < 2)
  ran = collections.Counter()

  def kernel(segs, pack, fold=None, dir_modes=None, rgbx=None,
             spa_modes=None, comp=None, out_y=False):
    ran.update(fused_mlp.launch_keys(fused_mlp.forward_kind(pack, fold),
                                     pack, out_y, fold, dir_modes, spa_modes))
    return plain(segs, pack, fold, dir_modes, rgbx, spa_modes, comp, out_y)

  plain = fused_mlp.trunk_plain
  monkeypatch.setattr(fused_mlp, 'trunk_plain', kernel)
  config, gin = configs.parse([GIN], SMALL[-2:] + SIX)
  model = construct.construct_model(config, gin, 'cpu')
  path = str(tmp_path / 'on.rnsrv')
  meta = serving.export_serving(model, path, chunk=CHUNK, device='cpu')
  assert meta['trunk_ops'] == {'K1': 2, 'K2': 2}
  on = serving.load_serving(path)
  routes = [(w, lib) for _, w, lib in
            fused_mlp.trunk_op_nodes(on.exported.graph)]
  assert sorted(routes) == [('K1', 'trunk_fwd_f32')] * 2 + [
      ('K2', 'trunk_fwd_f32')] * 2, routes
  rays = _port_rays(jtests._rays(CHUNK, seed=6))
  rays.near, rays.far = rays.near + 1.5, rays.far + 3
  ran.clear()
  got = on(rays)
  assert dict(ran) == {
      k: 2 for k in ('K1', 'K2', 'K6', 'K7', 'K8', 'K9', 'K10')}
  model.nerf_mlp.cfg.fused_trunk = 'off'
  with torch.no_grad():
    want = serving.serving_render_fn(model)(rays)
  assert not any(v > 2 for v in ran.values())
  for k in want:
    assert torch.equal(got[k], want[k]), k
  assert torch.isfinite(got['rgb']).all()


def test_export_tool_from_a_checkpoint(tmp_path):
  from refnerf_tpu_torch.tools import export_serving
  from refnerf_tpu_torch.train import checkpoints as ckpt_lib
  from refnerf_tpu_torch.train import step as step_lib
  bindings = [l for l in jtests._TINY.strip().splitlines()] + [
      f"Config.checkpoint_dir = '{tmp_path}'", "Config.exp_name = 'srv_x'"]
  config, gin = configs.parse(None, bindings)
  model = construct.construct_model(config, gin, 'cpu')
  state = step_lib.create_train_state(config, model)
  with torch.no_grad():
    model.nerf_mlp.rgb.bias.add_(0.5)  # not the initial weights
  state.step = 7
  ckpt_lib.CheckpointManager(ckpt_lib.checkpoint_dir(config)).save(7, state)
  out = str(tmp_path / 'tool.rnsrv')
  argv = ['--device=cpu', f'--out={out}', f'--chunk={CHUNK}'] + [
      f'--gin_bindings={b}' for b in bindings]
  meta = export_serving.main(argv)
  assert meta['near'] == config.near and meta['far'] == config.far
  rays = _port_rays(jtests._rays(CHUNK, seed=8))
  with torch.no_grad():
    want = serving.serving_render_fn(model)(rays)
  got = serving.load_serving(out)(rays)
  for k in want:
    assert torch.equal(got[k], want[k]), k
