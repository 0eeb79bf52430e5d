"""The port's fused trunks (K1 spatial, K2 directional) against the JAX ones.

On the CPU the port's wrappers take their plain versions; these are held
against the Pallas kernels run in interpret mode (as tests/test_fused_mlp.py
runs them) and against the pure-jnp oracles `reference_encoded_trunk` /
`reference_trunk`, on the same numpy inputs. The kernel's weight layout
(`pack_trunk`) is checked by an emulation of what the kernel reads. The
kernel itself runs only on a CUDA card: tests/test_torch_port_cuda.py.
The directional trunk also at mip-NeRF 360's shape (1 x 128 on 256 + 27
columns, csrc/trunk_dir1.cu's), forward and backward with the segments'
cotangents against jax.grad.

Tolerances: float32 1e-5 (sums over at most a few hundred terms in another
order). bfloat16 5e-2: both sides round each layer's f32 sum to bf16, and a
sum that lands on the other side of a rounding boundary flips one bf16 ulp
(2^-8 relative), which later layers carry along.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from refnerf_tpu.ops.pallas import fused_mlp as jfused
from refnerf_tpu_torch.ops import fused_mlp

torch.set_num_threads(1)

DEPTH, WIDTH, SKIP = 4, 32, 2
SCALES = 2.0**np.arange(0, 16)  # the flagship's max_deg_point = 16
TOL = {'float32': 1e-5, 'bfloat16': 5e-2}


def _trunk_params(rng, fin, width=WIDTH, depth=DEPTH, hf=10, hc=16):
  """Flax-layout ([in, out]) trunk, density and head parameters."""
  skips = jfused.skip_input_layers(depth, SKIP)
  ks, bs = [], []
  for l in range(depth):
    ind = fin if l == 0 else width + (fin if l in skips else 0)
    ks.append((rng.normal(size=(ind, width)) / np.sqrt(ind)).astype(np.float32))
    bs.append((rng.normal(size=(width,)) * 0.05).astype(np.float32))
  p = dict(ks=ks, bs=bs,
           wd=(rng.normal(size=(width, 1)) / np.sqrt(width)).astype(np.float32),
           bd=(rng.normal(size=(1,)) * 0.1).astype(np.float32),
           wh=(rng.normal(size=(width, hf)) / np.sqrt(width)).astype(np.float32),
           bh=(rng.normal(size=(hf,)) * 0.1).astype(np.float32))
  if hc:
    p['wc'] = (rng.normal(size=(width, hc)) / np.sqrt(width)).astype(np.float32)
    p['bc'] = (rng.normal(size=(hc,)) * 0.1).astype(np.float32)
  return p


def _torch_params(p):
  """The same parameters in nn.Linear layout ([out, in])."""
  t = lambda a: torch.tensor(np.ascontiguousarray(a))
  out = dict(ws=[t(k.T) for k in p['ks']], bs=[t(b) for b in p['bs']],
             wd=t(p['wd'].T), bd=t(p['bd']), head_f32=(t(p['wh'].T), t(p['bh'])))
  out['head_cdt'] = (t(p['wc'].T), t(p['bc'])) if 'wc' in p else None
  return out


def _lifted(rng, lead=(5, 13)):
  """Lifted means/vars [..., 3]; 65 rows, not a multiple of the block."""
  lm = rng.uniform(-1.5, 1.5, lead + (3,)).astype(np.float32)
  lv = (10.0**rng.uniform(-10, -2, lead + (3,))).astype(np.float32)
  return lm, lv


def _close(port, ref, cdt):
  ref = np.asarray(jnp.asarray(ref, jnp.float32))
  np.testing.assert_allclose(port.float().numpy(), ref, rtol=TOL[cdt],
                             atol=TOL[cdt])


def _run_k1(lm, lv, tp, cdt, mode='auto'):
  return fused_mlp.fused_encoded_trunk(
      torch.tensor(lm), torch.tensor(lv), SCALES, tp['ws'], tp['bs'],
      tp['wd'], tp['bd'], skip_period=SKIP, head_f32=tp['head_f32'],
      head_cdt=tp['head_cdt'], compute_dtype=cdt, mode=mode)


@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
def test_encoded_trunk_matches_pallas_and_reference(cdt):
  rng = np.random.default_rng(0)
  lm, lv = _lifted(rng)
  p = _trunk_params(rng, fin=2 * 3 * len(SCALES))
  args = (jnp.asarray(lm), jnp.asarray(lv), SCALES,
          [jnp.asarray(k) for k in p['ks']], [jnp.asarray(b) for b in p['bs']],
          jnp.asarray(p['wd']), jnp.asarray(p['bd']))
  heads = dict(head_f32=(jnp.asarray(p['wh']), jnp.asarray(p['bh'])),
               head_cdt=(jnp.asarray(p['wc']), jnp.asarray(p['bc'])))
  pallas = jfused.fused_encoded_trunk(*args, skip_period=SKIP,
                                      compute_dtype=cdt, block=32, **heads)
  oracle = jfused.reference_encoded_trunk(*args, skip_period=SKIP,
                                          compute_dtype=cdt, **heads)
  launches = fused_mlp.launches["K1"]
  port = _run_k1(lm, lv, _torch_params(p), cdt)
  assert fused_mlp.launches["K1"] == launches  # CPU: plain
  assert [tuple(o.shape) for o in port] == [(5, 13), (5, 13, 10), (5, 13, 16)]
  assert port[2].dtype == fused_mlp.DTYPES[cdt]
  for name, a, b, c in zip(('sigma', 'h_f32', 'h_cdt'), port, pallas, oracle):
    _close(a, b, cdt)
    _close(a, c, cdt)


# The directional trunks: the flagship's cut to size ([bottleneck |
# 2x36 IDE + n.v], here 16 + 73 on 7 x 11 rows, 4 layers of 32 with the
# skip) and mip-NeRF 360's at its own widths (1 x 128 on [bottleneck 256 |
# positional encoding of degree 4, 27], also any Model at the MLP's
# defaults: the shape of csrc/trunk_dir1.cu) on 65 rows; (segment widths,
# lead shape, width, depth).
DIR_SHAPES = {'flagship cut': ((16, 73), (7, 11), WIDTH, DEPTH),
              'mip-NeRF 360': ((256, 27), (5, 13), 128, 1)}


def _dir_case(shape, seed):
  rng = np.random.default_rng(seed)
  dims, lead, width, depth = DIR_SHAPES[shape]
  segs = [rng.normal(size=lead + (dims[0],)).astype(np.float32),
          rng.uniform(-1, 1, lead + (dims[1],)).astype(np.float32)]
  p = _trunk_params(rng, fin=sum(dims), width=width, depth=depth, hf=3, hc=0)
  return segs, p, rng.normal(size=lead + (3,)).astype(np.float32)


@pytest.mark.parametrize('cdt,shape', [
    pytest.param(cdt, shape, id=cdt if shape == 'flagship cut' else
                 f'{cdt}-{shape}')
    for shape in sorted(DIR_SHAPES) for cdt in ('float32', 'bfloat16')])
def test_directional_trunk_matches_pallas_and_reference(cdt, shape):
  segs, p, _ = _dir_case(shape, 1)
  ks = [jnp.asarray(k) for k in p['ks']]
  bs = [jnp.asarray(b) for b in p['bs']]
  head = (jnp.asarray(p['wh']), jnp.asarray(p['bh']))
  jsegs = [jnp.asarray(s) for s in segs]
  pallas = jfused.fused_trunk(jsegs, ks, bs, head_f32=head, out_y=False,
                              skip_period=SKIP, needs_dx=True,
                              compute_dtype=cdt, block=32)
  oracle = jfused.reference_trunk(jsegs, ks, bs, head_f32=head,
                                  skip_period=SKIP, compute_dtype=cdt)[1]
  tp = _torch_params(p)
  port = fused_mlp.fused_trunk([torch.tensor(s) for s in segs], tp['ws'],
                               tp['bs'], head_f32=tp['head_f32'],
                               skip_period=SKIP, compute_dtype=cdt)
  assert tuple(port.shape) == segs[0].shape[:-1] + (3,)
  _close(port, pallas, cdt)
  _close(port, oracle, cdt)


@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
def test_directional_trunk_backward_matches_pallas_and_reference(cdt):
  # K5 with the segments' cotangents (needs_dx) on mip-NeRF 360's shape, 65
  # rows: the port's plain backward (trunk_backward_reference, through
  # fused_trunk's autograd Function) against jax.grad of the Pallas kernel
  # in interpret mode and of reference_trunk, for every parameter and both
  # segments. float32: within 1e-5 of each gradient's largest entry. bf16:
  # relative L2 within 5e-2 (chip_smoke.py's GRAD_BOUND): both round zeta
  # to bf16, and a pre-activation within a bf16 rounding of 0 flips relu'
  # and moves its row's derivatives by ~10% (H8).
  segs, p, cot = _dir_case('mip-NeRF 360', 2)

  def jloss(q, fn):
    sg, ks, bs, wh, bh = q
    out = fn(sg, ks, bs, (wh, bh))
    return jnp.sum(out.astype(jnp.float32) * cot)

  pallas = lambda sg, ks, bs, head: jfused.fused_trunk(
      sg, ks, bs, head_f32=head, out_y=False, skip_period=SKIP,
      needs_dx=True, compute_dtype=cdt, block=32)
  oracle = lambda sg, ks, bs, head: jfused.reference_trunk(
      sg, ks, bs, head_f32=head, skip_period=SKIP, compute_dtype=cdt)[1]
  q = ([jnp.asarray(s) for s in segs], [jnp.asarray(k) for k in p['ks']],
       [jnp.asarray(b) for b in p['bs']], jnp.asarray(p['wh']),
       jnp.asarray(p['bh']))
  tp = _torch_params(p)
  tsegs = [torch.tensor(s).requires_grad_(True) for s in segs]
  for t in tp['ws'] + tp['bs'] + list(tp['head_f32']):
    t.requires_grad_(True)
  out = fused_mlp.fused_trunk(tsegs, tp['ws'], tp['bs'], tp['head_f32'],
                              skip_period=SKIP, compute_dtype=cdt)
  got = torch.autograd.grad(torch.sum(out.float() * torch.tensor(cot)),
                            [*tsegs, *tp['ws'], *tp['bs'], *tp['head_f32']])
  assert [tuple(g.shape) for g in got[:2]] == [s.shape for s in segs]
  for fn in (pallas, oracle):
    jdx, jks, jbs, jwh, jbh = jax.grad(jloss)(q, fn)
    want = list(jdx) + [k.T for k in jks] + list(jbs) + [jwh.T, jbh]
    for i, (a, b) in enumerate(zip(got, want)):
      a, b = a.float().numpy(), np.asarray(jnp.asarray(b, jnp.float32))
      assert a.shape == b.shape, i
      if cdt == 'float32':
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * np.abs(b).max(), err_msg=i)
      else:
        assert np.linalg.norm(a - b) <= 5e-2 * np.linalg.norm(b), i


def _emulate_kernel(segs, pack):
  """What csrc/trunk_fwd.cu computes, read from the packed weights."""
  cdt = fused_mlp.DTYPES[pack.compute_dtype]
  width, kin = pack.width, pack.kin
  x = torch.cat([s.to(cdt).float() for s in segs], dim=-1)
  x = F.pad(x, (0, kin - x.shape[-1]))
  off, h = 0, None
  for l in range(pack.depth):
    k = kin if l == 0 else width + (kin if l == pack.skip else 0)
    w = pack.w[off:off + width * k].reshape(width, k).float()
    off += width * k
    a = x if l == 0 else (torch.cat([h, x], -1) if l == pack.skip else h)
    h = torch.relu((a @ w.t()).to(cdt) + pack.b[l]).float()
  assert off == pack.w.numel() and k % 32 == 0
  outs = [] if pack.wd is None else [h @ pack.wd]
  if pack.wh is not None:
    outs.append(h @ pack.wh.t() + pack.bh)
  if pack.wc is not None:
    outs.append((h @ pack.wc.float().t()).to(cdt) + pack.bc)
  return outs


@pytest.mark.parametrize('cdt', ['float32', 'bfloat16'])
@pytest.mark.parametrize('seg_dims', [(48, 48), (16, 73)])
def test_pack_layout_reproduces_the_trunk(cdt, seg_dims):
  rng = np.random.default_rng(2)
  tp = _torch_params(_trunk_params(rng, fin=sum(seg_dims)))
  segs = [torch.tensor(rng.normal(size=(19, d)).astype(np.float32))
          for d in seg_dims]
  kw = dict(skip_period=SKIP, wd=tp['wd'], head_f32=tp['head_f32'],
            head_cdt=tp['head_cdt'], compute_dtype=cdt)
  pack = fused_mlp.pack_trunk(tp['ws'], tp['bs'], seg_dims, **kw)
  assert pack.skip == 3 and pack.kin % 32 == 0
  for a, b in zip(_emulate_kernel(segs, pack),
                  fused_mlp.trunk_reference(segs, tp['ws'], tp['bs'], **kw)):
    np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                               rtol=TOL[cdt], atol=TOL[cdt])


def test_encoding_is_exactly_scaled_and_range_reduced():
  # H-ipe: m = lm * 2^d exactly, range-reduced by a floor-mod, then
  # xs = e sin(m), xc = e cos(m): the JAX fused formulation (:1412-1434).
  rng = np.random.default_rng(7)
  lm, lv = _lifted(rng, (40,))
  lm[:4] = [[-1.4999, 1.4999, -0.7]] * 4  # |m| near 2^15 at degree 15
  m = lm[:, None, :].astype(np.float64) * SCALES[:, None]
  assert np.array_equal(m.astype(np.float32), m)  # exact in f32
  xs, xc = fused_mlp.encode_ipe(torch.tensor(lm), torch.tensor(lv), SCALES)
  ms = jfused._safe_trig_arg(jnp.asarray(m, jnp.float32).reshape(40, -1))
  e = jnp.exp(-0.5 * (jnp.asarray(lv)[:, None, :] *
                      jnp.asarray(SCALES**2, jnp.float32)[:, None]
                      ).reshape(40, -1))
  _close(xs, e * jnp.sin(ms), 'float32')
  _close(xc, e * jnp.cos(ms), 'float32')


def test_mode_off_and_cpu_take_the_plain_version():
  rng = np.random.default_rng(3)
  lm, lv = _lifted(rng, (4,))
  tp = _torch_params(_trunk_params(rng, fin=96))
  before = fused_mlp.launches["K1"]
  on, off = _run_k1(lm, lv, tp, 'float32', 'on'), _run_k1(lm, lv, tp,
                                                          'float32', 'off')
  assert fused_mlp.launches["K1"] == before
  for a, b in zip(on, off):
    assert torch.equal(a, b)
  with pytest.raises(ValueError):
    _run_k1(lm, lv, tp, 'float32', 'bogus')


def test_trailing_skip_concat_is_refused():
  rng = np.random.default_rng(4)
  p = _trunk_params(rng, fin=8, depth=3)
  tp = _torch_params(p)
  with pytest.raises(NotImplementedError):
    fused_mlp.fused_trunk([torch.zeros(2, 8)], tp['ws'], tp['bs'],
                          head_f32=tp['head_f32'], skip_period=SKIP)
