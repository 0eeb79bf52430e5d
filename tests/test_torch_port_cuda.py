"""The CUDA trunk kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips elsewhere. This
file imports no jax, so it also runs where jax is not installed; there, skip
tests/conftest.py (it imports jax):

    python -m pytest --noconftest tests/test_torch_port_cuda.py

Tolerances, as in chip_smoke.py: max |kernel - plain| <= bound *
max(1, max|plain|), with bound 1e-4 in float32 (one arithmetic, another
summation order) and 5e-2 in bfloat16 (a per-layer bf16 rounding flip of
2^-8, carried by later layers). TF32 is off for the plain versions.
"""

import math
import os

import numpy as np
import pytest
import torch

from refnerf_tpu_torch import configs
from refnerf_tpu_torch.cameras import rays as rays_lib
from refnerf_tpu_torch.models import construct
from refnerf_tpu_torch.models import renderer
from refnerf_tpu_torch.ops import fused_mlp

BOUND = {'float32': 1e-4, 'bfloat16': 5e-2}
GIN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   'configs', 'blender_refnerf.gin')


@pytest.fixture
def dev():
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA card: the trunk kernel has no CPU mode')
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  return torch.device('cuda')


def _case(which, dev, n=1000, seed=0, width=256):
  """Flagship widths: K1 segments (48, 48), heads 10 + 128; K2 (128, 73), 3.
  n = 1000 rows is not a multiple of the kernel's 64-row tile."""
  gen = torch.Generator().manual_seed(seed)
  rand = lambda *s: torch.randn(*s, generator=gen).to(dev)
  seg_dims, hf, hc = ((48, 48), 10, 128) if which == 'K1' else ((128, 73), 3, 0)
  fin = sum(seg_dims)
  skips = fused_mlp.skip_input_layers(8, 4)
  ws = [rand(width, fin if l == 0 else width + (fin if l in skips else 0))
        for l in range(8)]
  ws = [w * math.sqrt(2 / w.shape[1]) for w in ws]
  bs = [rand(width) * 0.05 for _ in range(8)]
  kw = dict(skip_period=4,
            wd=rand(1, width) / math.sqrt(width) if which == 'K1' else None,
            head_f32=(rand(hf, width) / math.sqrt(width), rand(hf) * 0.1),
            head_cdt=((rand(hc, width) / math.sqrt(width), rand(hc) * 0.1)
                      if hc else None))
  segs = [torch.rand(n, d, generator=gen).to(dev) * 2 - 1 for d in seg_dims]
  return segs, ws, bs, kw


def _assert_close(got, want, cdt):
  assert len(got) == len(want)
  for a, b in zip(got, want):
    assert a.dtype == b.dtype and a.shape == b.shape
    scale = max(1.0, b.float().abs().max().item())
    err = (a.float() - b.float()).abs().max().item()
    assert err <= BOUND[cdt] * scale, (err, BOUND[cdt] * scale)


@pytest.mark.cuda
@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
@pytest.mark.parametrize('which', ['K1', 'K2'])
def test_kernel_matches_plain(dev, which, cdt):
  segs, ws, bs, kw = _case(which, dev)
  pack = fused_mlp.pack_trunk(ws, bs, [s.shape[-1] for s in segs],
                              compute_dtype=cdt, **kw)
  with torch.no_grad():
    got = fused_mlp.trunk_kernel(segs, pack)
    want = fused_mlp.trunk_reference(segs, ws, bs, compute_dtype=cdt, **kw)
  torch.cuda.synchronize()
  _assert_close(got, want, cdt)


@pytest.mark.cuda
def test_wrappers_count_launches_and_honour_off(dev):
  segs, ws, bs, kw = _case('K2', dev, n=77)
  kw.pop('wd'), kw.pop('head_cdt')
  before = fused_mlp.fused_trunk.launches
  with torch.no_grad():
    on = fused_mlp.fused_trunk(segs, ws, bs, **kw)
    off = fused_mlp.fused_trunk(segs, ws, bs, mode='off', **kw)
  assert fused_mlp.fused_trunk.launches == before + 1
  _assert_close([on], [off], 'float32')


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_model(dev):
  segs, ws, bs, kw = _case('K2', dev, n=8)
  kw.pop('wd'), kw.pop('head_cdt')
  w0 = ws[0].clone().requires_grad_(True)
  with pytest.raises(NotImplementedError, match='forward-only'):
    fused_mlp.fused_trunk(segs, [w0] + ws[1:], bs, **kw)
  with torch.no_grad(), pytest.raises(NotImplementedError, match='ReLU'):
    fused_mlp.fused_trunk(segs, ws, bs, activation=torch.tanh, **kw)
  segs, ws, bs, kw = _case('K2', dev, n=8, width=64)
  kw.pop('wd'), kw.pop('head_cdt')
  with torch.no_grad(), pytest.raises(NotImplementedError, match='width 64'):
    fused_mlp.fused_trunk(segs, ws, bs, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
def test_model_kernels_match_plain_path(dev, cdt):
  config, gin = configs.parse(
      [GIN],
      ['Model.num_prop_samples = 16', 'Model.num_nerf_samples = 16',
       f"NerfMLP.compute_dtype = '{cdt}'"])
  model = construct.construct_model(config, gin, dev)
  rng = np.random.default_rng(0)
  d = torch.tensor(rng.normal(size=(100, 3)).astype(np.float32), device=dev)
  rays = rays_lib.dummy_rays(100, dev)
  rays.directions, rays.viewdirs = d, d / d.norm(dim=-1, keepdim=True)
  rays.radii = rays.radii + 1e-3
  rays.near, rays.far = rays.near + 2, rays.far + 5
  before = fused_mlp.fused_encoded_trunk.launches
  out = renderer.render_rays(model, rays, 64)
  assert fused_mlp.fused_encoded_trunk.launches == before + 2 * 2
  model.nerf_mlp.cfg.fused_trunk = 'off'
  plain = renderer.render_rays(model, rays, 64)
  for k in out:
    assert torch.isfinite(out[k]).all()
    err = (out[k] - plain[k]).abs().max().item()
    assert err <= BOUND[cdt], (k, err)
